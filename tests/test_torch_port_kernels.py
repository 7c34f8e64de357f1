"""The hand-written CUDA kernels (K1 softmin, sinkhorn_solve, K2 hist3, K3
lut_apply3) against their plain PyTorch versions.

The ``gpu`` tests build the kernels with nvcc and run them on the card;
without a card they skip (the decision is made inside each test). This
file imports no JAX, so on a machine with an H100 and no JAX it runs as
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_port_kernels.py``. K2 and K3 must be exact; K1 and
sinkhorn_solve agree within rtol 1e-5 / atol 1e-6 (f32 FMA dot products
and sums of exponentials taken in another order than cuBLAS and torch's
reductions). The CPU tests check the wrappers' own contract.
"""

import pytest
import torch

from aadg_tpu_torch.ops import lut
from aadg_tpu_torch.ops import sinkhorn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _images(gen, n, h, w, device):
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=gen).float()
    imgs[0] = 200.0                       # one bin takes every pixel
    imgs[1, :, :, 1] = torch.randint(100, 104, (h, w), generator=gen).float()
    return imgs.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(144, 256, 256), (5, 33, 17)])
def test_hist3_kernel_exact(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    imgs = _images(gen, *shape, cuda)
    out = lut.hist3(imgs)
    torch.cuda.synchronize()
    assert torch.equal(out, lut.hist3_plain(imgs))
    assert float(out[0].sum()) == 3 * shape[1] * shape[2]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(144, 256, 256), (5, 33, 17)])
def test_lut_apply3_kernel_exact(cuda, shape):
    gen = torch.Generator().manual_seed(1)
    imgs = _images(gen, *shape, cuda)
    luts = torch.randint(0, 256, (shape[0], 3, 256), generator=gen).float()
    luts = luts.to(cuda)
    out = lut.lut_apply3(imgs, luts)
    torch.cuda.synchronize()
    assert torch.equal(out, lut.lut_apply3_plain(imgs, luts))


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m,d", [(54, 8, 8, 128), (3, 37, 70, 50),
                                     (1, 4096, 4096, 128)])
def test_softmin_kernel_matches_plain(cuda, p, n, m, d):
    gen = torch.Generator().manual_seed(2)
    xn = sinkhorn.normalize_rows(torch.randn(p, n, d, generator=gen))
    yn = sinkhorn.normalize_rows(torch.randn(p, m, d, generator=gen))
    zb = torch.log(torch.full((p, m), 1.0 / m)) + 0.3 * torch.randn(
        p, m, generator=gen)
    zb[:, -3:] = -1e30                    # padded columns
    args = [t.to(cuda).contiguous() for t in (xn, yn, zb)]
    for eps in (2.0, 0.05):
        out = sinkhorn.softmin(eps, *args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, sinkhorn.softmin_plain(eps, *args),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    imgs = torch.zeros(2, 8, 8, 3, device=cuda)
    before = (lut.hist3.launches, lut.lut_apply3.launches,
              sinkhorn.softmin.launches)
    lut.lut_apply3(imgs, lut.hist3(imgs))
    x = torch.zeros(1, 4, 8, device=cuda)
    sinkhorn.softmin(0.1, x, x, torch.zeros(1, 4, device=cuda))
    after = (lut.hist3.launches, lut.lut_apply3.launches,
             sinkhorn.softmin.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def _clouds(gen, p, n, m, d, weighted, device):
    x = torch.randn(p, n, d, generator=gen)
    y = torch.randn(p, m, d, generator=gen) + 0.3
    w = [torch.rand(p, k, generator=gen) + 0.5 if weighted else None
         for k in (n, m)]
    move = lambda t: None if t is None else t.to(device).contiguous()
    return move(x), move(y), move(w[0]), move(w[1])


SOLVE_SHAPES = [(18, 8, 8, 128, False), (4, 5, 9, 128, True),
                (2, sinkhorn.SOLVE_MAX_POINTS, sinkhorn.SOLVE_MAX_POINTS,
                 sinkhorn.SOLVE_MAX_DIM, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("debias", [True, False])
@pytest.mark.parametrize("p,n,m,d,weighted", SOLVE_SHAPES)
def test_sinkhorn_solve_kernel_matches_plain(cuda, p, n, m, d, weighted,
                                             debias):
    """The search step's 18 divergences of 8 vs 8 points, a ragged weighted
    case and the size limit."""
    gen = torch.Generator().manual_seed(3)
    x, y, wx, wy = _clouds(gen, p, n, m, d, weighted, cuda)
    eps = sinkhorn._eps_schedule(2.0, 0.05, 0.5, 5)
    out = sinkhorn.sinkhorn_solve(x, y, eps, wx, wy, debias)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, sinkhorn.sinkhorn_solve_plain(x, y, eps, wx, wy, debias),
        rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_sinkhorn_solve_self_divergence_zero(cuda):
    gen = torch.Generator().manual_seed(4)
    x, _, wx, _ = _clouds(gen, 6, 8, 8, 128, True, cuda)
    eps = sinkhorn._eps_schedule(2.0, 0.05, 0.5, 5)
    out = sinkhorn.sinkhorn_solve(x, x, eps, wx, wx)
    torch.cuda.synchronize()
    assert float(out.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_pairwise_domain_ot_is_one_launch(cuda):
    """The rewards' call at the flagship shape (M=6, D=3, B=8, F=128):
    one sinkhorn_solve launch, no K1 launch."""
    feats = torch.randn(6, 3, 8, 128, generator=torch.Generator().manual_seed(5))
    before = (sinkhorn.sinkhorn_solve.launches, sinkhorn.softmin.launches)
    out = sinkhorn.pairwise_domain_ot(feats.to(cuda))
    after = (sinkhorn.sinkhorn_solve.launches, sinkhorn.softmin.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 0]
    torch.testing.assert_close(out.cpu(), sinkhorn.pairwise_domain_ot(feats),
                               rtol=1e-5, atol=1e-5)


def test_cpu_sinkhorn_solve_takes_the_plain_version():
    gen = torch.Generator().manual_seed(6)
    x, y, wx, wy = _clouds(gen, 2, 5, 9, 16, True, "cpu")
    eps = sinkhorn._eps_schedule(2.0, 0.05, 0.5, 5)
    before = sinkhorn.sinkhorn_solve.launches
    assert torch.equal(sinkhorn.sinkhorn_solve(x, y, eps, wx, wy),
                       sinkhorn.sinkhorn_solve_plain(x, y, eps, wx, wy))
    assert sinkhorn.sinkhorn_solve.launches == before


def test_cpu_tensors_take_the_plain_version():
    """No launch is counted for a CPU tensor, and the result is the plain
    version's."""
    before = (lut.hist3.launches, lut.lut_apply3.launches,
              sinkhorn.softmin.launches)
    imgs = torch.randint(0, 256, (2, 8, 8, 3)).float()
    luts = torch.randint(0, 256, (2, 3, 256)).float()
    assert torch.equal(lut.hist3(imgs), lut.hist3_plain(imgs))
    assert torch.equal(lut.lut_apply3(imgs, luts),
                       lut.lut_apply3_plain(imgs, luts))
    x = torch.randn(1, 4, 8)
    assert torch.equal(sinkhorn.softmin(0.1, x, x, torch.zeros(1, 4)),
                       sinkhorn.softmin_plain(0.1, x, x, torch.zeros(1, 4)))
    assert (lut.hist3.launches, lut.lut_apply3.launches,
            sinkhorn.softmin.launches) == before


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        lut.hist3(torch.zeros(2, 8, 8, 4))
    with pytest.raises(ValueError):
        lut.hist3(torch.zeros(2, 8, 8, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        lut.lut_apply3(torch.zeros(2, 8, 8, 3), torch.zeros(2, 3, 255))


def test_hist3_plain_counts():
    imgs = torch.tensor([[[[0.0, 255.0, 7.0], [0.0, 3.0, 7.0]]]])
    h = lut.hist3_plain(imgs)
    assert h.shape == (1, 3, 256)
    assert float(h[0, 0, 0]) == 2 and float(h[0, 1, 255]) == 1
    assert float(h[0, 2, 7]) == 2 and float(h.sum()) == 6

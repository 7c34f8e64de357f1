"""``TPU.REMAT`` in the port: activation checkpointing per block changes
when activations are computed, not what is computed.

- SegFormer (MiT-b0, stochastic depth 0.5, the head's dropout): with and
  without remat, a train-mode forward and backward from the same weights
  and masks gives equal logits, features, gradients and head BatchNorm
  statistics (within 1e-6), every checkpointed block runs its forward
  twice (once more in the backward pass), and the recomputation applies
  the masks the forward drew;
- DeepLabV3+ (the optic config cut to crop 64, f32): two pretrain steps
  with and without remat give equal losses, gradients, weights and
  running statistics (within 1e-6), so the recomputed inverted residuals
  do not update their BatchNorm statistics a second time.

This file imports no JAX; the ``gpu`` test (SegFormer's gradients with
and without remat on the card, within rtol 1e-5 / atol 1e-6 of the
largest gradient: cuDNN may pick other algorithms for the recomputed
convolutions) runs on a machine with a card as ``python -m pytest
--noconftest -p no:cacheprovider -m gpu tests/test_torch_port_remat.py``.
"""

import numpy as np
import pytest
import torch

from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.data.datasets import SyntheticDataset
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.models import segformer
from aadg_tpu_torch.models.segformer import SegFormer

TIGHT = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _segformer_pass(remat: bool, device="cpu"):
    """One train-mode forward and backward of MiT-b0 from seed 0 on fixed
    inputs and masks; returns (logits, feature, grads, state_dict,
    forward calls of one block, masks applied)."""
    torch.manual_seed(0)
    model = SegFormer(2, "mit_b0", drop_path_rate=0.5, remat=remat)
    model.to(device).train()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 32, 32, 3, generator=gen).to(device)
    draws = segformer.draw_dropout("mit_b0", 0.5, 32, 32, 3, gen)
    draws = type(draws)(*(t.to(device) for t in draws))
    calls = []
    model.backbone.block2_1.register_forward_pre_hook(
        lambda m, args: calls.append(args[3].clone()))
    logits, feat = model(x, draws)
    (torch.mean(torch.sigmoid(logits)) + torch.mean(feat ** 2)).backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return (logits.detach().cpu(), feat.detach().cpu(), grads, state, calls,
            draws.paths[3, 0].cpu())


def test_segformer_remat_matches_no_remat():
    off = _segformer_pass(False)
    on = _segformer_pass(True)
    for a, b in zip(off[:2], on[:2]):
        torch.testing.assert_close(b, a, **TIGHT)
    for name in ("grads", "state"):
        i = 2 if name == "grads" else 3
        assert sorted(on[i]) == sorted(off[i])
        for k in off[i]:
            torch.testing.assert_close(on[i][k], off[i][k], **TIGHT,
                                       msg=f"{name} {k}")
    # block2_1 is the 4th block: the pre-forward hook saw its dp1 mask once
    # without remat and twice with it, the recomputation's being the
    # forward's
    assert len(off[4]) == 1 and len(on[4]) == 2
    assert not off[5].all()
    for mask in on[4]:
        assert torch.equal(mask, off[5])


def _deeplab_two_steps(remat: bool):
    cfg = load_config("experiments/optic_sinkhorn/diversity.yaml", [
        "DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "1", "TPU.COMPUTE_DTYPE", "float32",
        "TPU.REMAT", str(remat)])
    ent = tstate.build_entities(cfg, "search", steps_per_epoch=1,
                                device="cpu")
    sd, _ = tstate.init_state(ent, 0)
    assert sd.model.encoder.remat is remat
    ds = SyntheticDataset("optic", n_per_domain=1, size=64)
    batch = (torch.from_numpy(np.stack([d.images[0] for d in ds.domains])
                              [None].astype(np.float32)),
             torch.from_numpy(np.stack([d.labels[0] for d in ds.domains])
                              [None].astype(np.float32)),
             torch.arange(3)[None])
    gen = torch.Generator().manual_seed(3)
    step = tsteps.make_pretrain_step(ent)
    metrics = [step(sd, batch, tsteps.draw_pretrain(ent, 3, gen))
               for _ in range(2)]
    grads = {k: p.grad.clone() for k, p in sd.model.named_parameters()}
    return metrics, grads, sd.model.state_dict()


def test_deeplab_remat_matches_no_remat():
    m_off, g_off, s_off = _deeplab_two_steps(False)
    m_on, g_on, s_on = _deeplab_two_steps(True)
    for a, b in zip(m_off, m_on):
        for k in a:
            torch.testing.assert_close(b[k], a[k], **TIGHT, msg=k)
    for k in g_off:
        torch.testing.assert_close(g_on[k], g_off[k], **TIGHT, msg=k)
    stats = [k for k in s_off if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 62
    for k in s_off:
        torch.testing.assert_close(s_on[k], s_off[k], **TIGHT, msg=k)
    # the statistics moved: two updates, not zero
    assert not torch.equal(s_on[stats[1]], torch.ones_like(s_on[stats[1]]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_segformer_remat_on_the_card(cuda):
    off = _segformer_pass(False, cuda)
    on = _segformer_pass(True, cuda)
    top = max(float(g.abs().max()) for g in off[2].values())
    for k in off[2]:
        torch.testing.assert_close(on[2][k], off[2][k], rtol=1e-5,
                                   atol=1e-6 * top, msg=k)
    assert len(on[4]) == 2

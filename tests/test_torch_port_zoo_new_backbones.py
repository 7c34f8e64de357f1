"""The port's ResNeSt, Fast-SCNN and CGNet backbones
(``aadg_tpu_torch/models/zoo/backbones.py``) against the JAX package's,
f32 on the CPU, weights drawn with numpy from a seed over the flax tree's
shapes (``test_torch_port_zoo.numpy_variables``) and carried over by
``weights.from_flax``; the JAX side jitted.

- Forward: ResNeSt-50, Fast-SCNN and CGNet (cut to ``num_blocks=(3, 5)``,
  as ``tests/test_zoo_backbones.py`` runs it) on 2 images of 64 x 64, and
  ``SplitAttentionConv`` at groups 1 and radix 2 alone, in train mode
  (outputs and updated running statistics) and eval mode, within rtol
  1e-4 and atol 1e-4 of the largest value. Train mode runs in float64 on
  both sides: split attention's BatchNorm over (2 images, 32+ channels)
  normalises two nearly equal pooled vectors, which turns f32 rounding
  into differences of O(1) (ResNeSt-50's last stage: JAX's f32 output
  0.75 of its largest value away from float64, the port's 0.08; the two
  in float64 within 7e-8). ResNeSt-50's eval runs in float64 too: with
  the drawn running statistics its last stage reaches 2.4e4, where the
  radix softmax of such logits leaves f32 outputs 2.4e-4 (the port) and
  5.6e-4 (JAX) of the largest value from float64. At 64 x 64 Fast-SCNN's
  pyramid pools a 2 x 2 map to 3 and 6, larger outputs than inputs.
- Gradients of ``SplitAttentionConv`` (train-mode BatchNorms) and
  ``ChannelPReLU``: float64 on both sides, the output and the input's
  gradient within 1e-9 of each tensor's largest value, the parameters'
  within 1e-6 (``from_flax`` carries JAX's gradients over in f32), or 1e-9
  of the largest gradient where one vanishes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.models.zoo import backbones as jbb
from aadg_tpu_torch.models.zoo import backbones as tbb
from aadg_tpu_torch.weights import from_flax
from test_torch_port_zoo import (check_stats, close, japply, nchw, nhwc,
                                 numpy_variables, port)
from torch_port_helpers import few_torch_threads  # noqa: F401

# CGNet cut to 3 and 5 blocks, as tests/test_zoo_backbones.py runs it
CG_CUT = dict(num_blocks=(3, 5))

BACKBONES = {
    "resnest50": (lambda: jbb.ResNeSt(50), lambda: tbb.ResNeSt(50)),
    "fast_scnn": (lambda: jbb.FastSCNN(), lambda: tbb.FastSCNN()),
    "cgnet": (lambda: jbb.CGNet(**CG_CUT), lambda: tbb.CGNet(**CG_CUT)),
    "split_attention": (lambda: jbb.SplitAttentionConv(16, radix=2),
                        lambda: tbb.SplitAttentionConv(8, 16, 2)),
}


def _input(name):
    shape = (2, 16, 16, 8) if name == "split_attention" else (2, 64, 64, 3)
    return np.random.default_rng(4).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def backbone_weights():
    cache = {}

    def get(name):
        if name not in cache:
            jmod, x = BACKBONES[name][0](), _input(name)
            cache[name] = (jmod, numpy_variables(jmod, x, train=False), x)
        return cache[name]
    return get


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_new_backbone_matches_jax(backbone_weights, name, train):
    jmod, variables, x = backbone_weights(name)
    tmod = port(BACKBONES[name][1](), variables).train(train)
    if train or name == "resnest50":
        with jax.enable_x64(True):
            want = japply(jmod, _f64(variables), x.astype(np.float64),
                          train=train)
        with torch.no_grad():
            got = tmod.double()(nchw(x).double())
    else:
        want = japply(jmod, variables, x, train=False)
        with torch.no_grad():
            got = tmod(nchw(x))
    if train:
        want, upd = want
    if name == "split_attention":
        got, want = [got], [want]
    else:
        assert tmod.out_channels == [w.shape[-1] for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(nhwc(g), w)
    if train:
        check_stats(tmod, upd)


def _grads64(jmod, tmod, variables, x, out_ch, train):
    """Float64 output and gradients (parameters and input) of
    ``sum(out * cot)`` on both sides; BatchNorm in train mode."""
    cot = np.random.default_rng(9).normal(size=(*x.shape[:-1], out_ch))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)

        def loss(params, x):
            out = jmod.apply({**v64, "params": params}, x, **train,
                             **({"mutable": ["batch_stats"]}
                                if "train" in train else {}))
            out = out[0] if "train" in train else out
            return jnp.sum(out * cot), out
        (_, jout), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
            v64["params"], jnp.asarray(x, jnp.float64))
        jout, gp, gx = (np.asarray(jout), jax.tree_util.tree_map(
            np.asarray, gp), np.asarray(gx))
    tmod = port(tmod, variables).double()
    tx = nchw(x).double().requires_grad_()
    out = tmod(tx)
    (out * torch.from_numpy(cot.transpose(0, 3, 1, 2))).sum().backward()
    close64 = lambda g, w: np.testing.assert_allclose(
        g, w, rtol=0, atol=1e-9 * max(np.abs(w).max(), 1e-12))
    close64(nhwc(out), jout)
    close64(nhwc(tx.grad), gx)
    # from_flax hands the reference over in f32: 6e-8 of rounding
    # (or within 1e-9 of the largest where a gradient vanishes: fc1's bias
    # shifts a train-mode BatchNorm's input)
    ref = from_flax({"params": gp})
    assert sorted(ref) == sorted(k for k, _ in tmod.named_parameters())
    top = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for k, p in tmod.named_parameters():
        w = ref[k].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0, err_msg=k,
            atol=max(1e-6 * np.abs(w).max(), 1e-9 * top))


def test_split_attention_gradients_match_jax():
    jmod = jbb.SplitAttentionConv(16, radix=2)
    x = _input("split_attention")
    variables = numpy_variables(jmod, x, train=False)
    _grads64(jmod, tbb.SplitAttentionConv(8, 16, 2).train(), variables, x,
             16, {"train": True})


def test_channel_prelu_gradients_match_jax():
    jmod = jbb.ChannelPReLU()
    x = _input("split_attention")
    variables = {"params": {"alpha": np.random.default_rng(3).uniform(
        0.05, 0.5, 8).astype(np.float32)}}
    _grads64(jmod, tbb.ChannelPReLU(8), variables, x, 8, {})

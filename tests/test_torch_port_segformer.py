"""The port's SegFormer against the JAX package's (MiT-b0, f32 on the CPU).

From the same flax weights (loaded through ``weights.from_flax``, with
perturbed head BatchNorm parameters and statistics):

- the eval forward's logits and pooled feature at 2 x 64 x 64 and at
  2 x 40 x 40 (flax's SAME padding in the spatial reductions) within
  rtol/atol 1e-5 (measured 2e-6: LayerNorm variance by E[x^2] - E[x]^2
  in flax, by a centred sum in torch);
- a train-mode forward with stochastic depth 0.5 and the head's dropout
  0.1, the port applying JAX's masks (``torch_port_helpers.
  dropout_draws``): logits, feature and the head's updated BatchNorm
  statistics within rtol 1e-4 / atol 1e-5, and the gradients of a loss on
  both outputs within 1e-3 of each tensor's largest magnitude, or within
  1e-7 of the model's largest gradient where a tensor's gradient vanishes
  (the ``linear_c*`` biases: a per-channel shift before the train-mode
  BatchNorm has gradient 0, and both frameworks give rounding noise of
  1.3e-8 of the largest gradient);
- ``from_flax`` and ``to_flax`` invert each other over the whole tree.

The factory: every MiT variant's feature width, ``channel_parser`` for
mit_b0-b3 equal to JAX's, the config's variant, stochastic depth and
``TPU.REMAT`` reaching the model, and ``draw_dropout``'s shapes and rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu import models as jmodels
from aadg_tpu.models.segformer import VARIANTS as JVARIANTS
from aadg_tpu.models.segformer import SegFormer as JSegFormer
from aadg_tpu_torch import models as tmodels
from aadg_tpu_torch.config import load_config
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.models import segformer
from aadg_tpu_torch.models.segformer import SegFormer
from aadg_tpu_torch.weights import from_flax
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (SEG_CFG, SEG_OPTS, _np, check_grads_floored,
                                dropout_draws, to_flax, torch_dropout)

SHAPE = (2, 64, 64, 3)


@pytest.fixture(scope="module")
def pair():
    jmodel = JSegFormer(num_classes=2, variant="mit_b0", drop_path_rate=0.5)
    variables = _np(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    bn = variables["params"]["head"]["BatchNorm_0"]
    bn["scale"] = rng.uniform(0.8, 1.2, bn["scale"].shape).astype(np.float32)
    bn["bias"] = rng.normal(0, 0.05, bn["bias"].shape).astype(np.float32)
    st = variables["batch_stats"]["head"]["BatchNorm_0"]
    st["mean"] = rng.normal(0, 0.05, st["mean"].shape).astype(np.float32)
    st["var"] = rng.uniform(0.8, 1.2, st["var"].shape).astype(np.float32)
    x = rng.normal(size=SHAPE).astype(np.float32)
    return jmodel, variables, x


def _port(variables, **kw):
    model = SegFormer(2, "mit_b0", **kw)
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def test_structure_and_round_trip(pair):
    _, variables, _ = pair
    model = _port(variables)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(a.size for a in jax.tree_util.tree_leaves(
        variables["params"]))
    back = to_flax(model.state_dict(), variables)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)
    assert model.feature_dim == 256


@pytest.mark.parametrize("side", [64, 40])
def test_eval_forward_matches_jax(pair, side):
    """At 40 x 40 the stages are 10, 5, 3 and 2 tokens wide, so every
    spatial reduction pads as flax's SAME does."""
    jmodel, variables, x = pair
    x = x[:, :side, :side]
    jl, jf = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x)
    model = _port(variables).eval()
    with torch.no_grad():
        tl, tf = model(torch.from_numpy(np.ascontiguousarray(x)))
    assert tl.shape == (2, side, side, 2) and tf.shape == (2, 256)
    assert tl.dtype == tf.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)


def test_train_forward_and_grads_match_jax(pair):
    jmodel, variables, x = pair
    key = jax.random.PRNGKey(7)
    draws = dropout_draws(jmodel, variables, SHAPE, key)
    # stochastic depth 0.5 drops branches of these two samples
    assert not draws.paths.all() and not draws.head.all()
    w = np.random.default_rng(1).normal(size=(2, 256)).astype(np.float32)

    def loss(params, stats, x):
        (logits, feat), upd = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": key})
        return (jnp.mean(jax.nn.sigmoid(logits)) + jnp.sum(feat * w) / 100,
                (logits, feat, upd["batch_stats"]))
    grads, (jl, jf, jstats) = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"], x)

    model = _port(variables, drop_path_rate=0.5).train()
    tl, tf = model(torch.from_numpy(x), torch_dropout(draws))
    (torch.mean(torch.sigmoid(tl)) + torch.sum(tf * torch.from_numpy(w))
     / 100).backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tf.detach().numpy(), np.asarray(jf),
                               rtol=1e-4, atol=1e-5)
    sd = model.state_dict()
    for k, v in from_flax({"batch_stats": _np(jstats)}).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    check_grads_floored(model, grads)


def test_train_forward_needs_masks(pair):
    _, variables, x = pair
    with pytest.raises(ValueError, match="draw_dropout"):
        _port(variables).train()(torch.from_numpy(x))


@pytest.mark.parametrize("variant", sorted(JVARIANTS))
def test_every_variant_through_the_factory(variant):
    assert segformer.VARIANTS[variant] == JVARIANTS[variant]
    cfg = load_config(SEG_CFG, SEG_OPTS + ["MODEL.BACKBONE", variant])
    assert tmodels.feature_dim(cfg) == JVARIANTS[variant][0][-1]
    if variant in ("mit_b0", "mit_b1", "mit_b2", "mit_b3"):
        assert tmodels.channel_parser(variant) == jmodels.channel_parser(
            variant)
        assert tmodels.channel_parser(variant) == tmodels.feature_dim(cfg)


@pytest.mark.parametrize("remat", [False, True])
def test_entities_build_the_configured_segformer(remat):
    cfg = load_config(SEG_CFG, SEG_OPTS + ["TPU.REMAT", str(remat)])
    ent = tstate.build_entities(cfg, "search", device="cpu")
    assert (ent.num_classes, ent.feature_dim) == (2, 256)
    sd, _ = tstate.init_state(ent, 0)
    model = sd.model
    assert type(model) is SegFormer and model.variant == "mit_b0"
    assert model.backbone.remat is remat
    rates = [b.drop_path for name, b in model.backbone.named_children()
             if name.startswith("block")]
    assert rates == pytest.approx(list(np.linspace(0.0, 0.5, 8)))
    assert sd.disc.online.dis.in_features == 256
    draws = ent.draw_dropout(5, torch.Generator().manual_seed(0))
    assert draws.paths.shape == (8, 2, 5) and draws.paths.dtype == torch.bool
    assert draws.paths[0].all()          # the first block's rate is 0
    assert draws.head.shape == (5, 16, 16, 256)
    with torch.no_grad():
        logits, f = model.train()(torch.zeros(5, 64, 64, 3), draws)
    assert logits.shape == (5, 64, 64, 2) and f.shape == (5, 256)


def test_draw_dropout_rates():
    gen = torch.Generator().manual_seed(0)
    d = segformer.draw_dropout("mit_b4", 0.1, 8, 8, 4000, gen)
    assert d.paths.shape == (41, 2, 4000)
    assert d.head.shape == (4000, 2, 2, 256)
    rates = segformer.drop_path_rates("mit_b4", 0.1)
    dropped = 1.0 - d.paths.float().mean(dim=(1, 2))
    np.testing.assert_allclose(dropped.numpy(), rates, atol=0.02)
    assert abs(1.0 - float(d.head.float().mean()) - 0.1) < 0.002

"""The port's search loop (``engine/search.py::run_search``) against the JAX
loop over whole epochs, on the learning testbed (``prove_learning.
testbed_config``: ``synthetic_optic_tint``, the fixture's UNet, the 4-op
space) cut to B=1 per domain, M=3 policies, 1 step per epoch, one warmup
and three search epochs, f32 on the CPU, with ``TRAIN.LR 0``: the
segmentation model and the discriminator keep their weights, so the test
holds the loop's reinforcement learning (rewards summed and normalized
per epoch, PPO updates, the op-probability trajectory) to JAX's. With a
learning rate, Adam's first steps (an update of about ``lr * sign(g)``)
turn the f32 rounding noise of the train-mode BatchNorm gradients into
weight differences of up to ``lr``, and after one warmup epoch of 2 steps
the normalized rewards already differ by 0.07 (measured), so whole runs
cannot be compared draw for draw.

The JAX side runs the epoch programs of ``aadg_tpu/engine/search.py``
(``_make_epoch_runners``), its controller sampling and PPO update and the
momentum updates, keyed as its ``run_search`` keys them. The port runs its
own ``run_search`` from the same weights (numpy draws over the flax trees,
carried by ``from_flax``; the controller by ``controller_from_jax``), with
every draw replayed from the JAX key tree: the batch indices, the
pretrain and search draws, and the controller's tokens (forced). What
the learning proof reads must then track JAX's: each search epoch's
normalized rewards within atol 1e-3, the op-probability trajectory within
atol 1e-5, and the final controller within rtol 1e-4 / atol 3e-5: three
times the atol of a single PPO update (``test_torch_port_rl.py``), since
each of the three updates' Adam steps on a weight whose gradient is near
Adam's eps has a size set by the gradient's last bits (measured 2.4e-5 on
3 of 40,000 LSTM weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu.data.datasets import build_dataset as jbuild_dataset
from aadg_tpu.data.datasets import load_train_arrays as jload
from aadg_tpu.data.stores import make_train_store as jstore_of
from aadg_tpu.engine import rl as jrl
from aadg_tpu.engine import search as jsearch
from aadg_tpu.engine import state as jstate
from aadg_tpu.models import controller as jctrl
from aadg_tpu.models import discriminator as jdisc
from tools import prove_learning as jpl
from aadg_tpu_torch import prove_learning as pl
from aadg_tpu_torch.engine import search as tsearch
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.engine import steps as tsteps
from aadg_tpu_torch.models.controller import Controller
from aadg_tpu_torch.ops.augment import PolicyDraw
from aadg_tpu_torch.utils.checkpoint import load_checkpoint
from aadg_tpu_torch.weights import controller_from_jax
from test_torch_port_zoo import numpy_variables
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import (crop_draw, policy_draws, port_state,
                                soft_label_draws)

B, M, STEPS, WARMUP, END = 1, 3, 1, 1, 4
N0 = 3 * B


def _jax_loop(jcfg, jent, sd, cs, store):
    """JAX's run_search epochs; returns the per-step keys of every epoch,
    the sampled tokens and normalized rewards of each search epoch, the
    op probabilities and the final controller parameters."""
    pretrain_epoch, search_epoch = jsearch._make_epoch_runners(
        jent, B, STEPS, M, jcfg)
    ctrl_update = jax.jit(jrl.make_controller_update(
        jent, jcfg.CONTROLLER.LOSS, jcfg.CONTROLLER.PENALTY))
    key = jax.random.PRNGKey(jcfg.SEED)
    out = {"step_keys": [], "tokens": [], "rewards": [], "op_probs": []}
    for epoch in range(END):
        ekey = jax.random.fold_in(key, epoch + 1)
        if epoch < WARMUP:
            out["step_keys"].append(("pretrain",
                                     jax.random.split(ekey, STEPS)))
            sd, _ = pretrain_epoch(sd, store, ekey)
            continue
        if epoch == WARMUP:
            sd = sd._replace(
                dis_params=jdisc.synchronize_parameters(sd.dis_params))
        k_s, k_e = jax.random.split(ekey)
        policies, op_probs, _, log_probs, entropies = jctrl.sample(
            cs.params, jent.ctrl_spec, k_s, M)
        out["step_keys"].append(("search", jax.random.split(k_e, STEPS)))
        ptens = jctrl.policies_to_tensor(policies, jent.ctrl_spec)
        sd, _, rewards = search_epoch(sd, store, ptens, k_e)
        sd = sd._replace(dis_params=jdisc.momentum_update(sd.dis_params))
        cs, _ = ctrl_update(cs, policies, log_probs, entropies, rewards)
        out["tokens"].append(np.array(policies, np.int64))
        out["rewards"].append(np.asarray(rewards))
        out["op_probs"].append(np.asarray(op_probs))
    out["params"] = jax.tree_util.tree_map(np.asarray, cs.params)
    return out


def _replay(step_keys, store):
    """The port's draws for JAX's per-step keys, in the order the port's
    loop asks for them: (batch indices, step draws) per step."""
    idx, draws = [], []
    for kind, keys in step_keys:
        for k in keys:
            kb, ks = jax.random.split(k)
            idx.append(torch.from_numpy(np.array(jax.random.randint(
                kb, (B, 3), 0, jnp.broadcast_to(store.counts[None, :],
                                                (B, 3))), np.int64)))
            if kind == "pretrain":
                k_t, k_d, _ = jax.random.split(ks, 3)
                draws.append(tsteps.PretrainDraws(
                    crop_draw(jax.random.split(k_t, N0)),
                    torch.from_numpy(soft_label_draws(
                        jax.random.split(k_d, N0), 3))))
                continue
            k_aug, k_t, k_d, _ = jax.random.split(ks, 4)
            q, centre = policy_draws(jax.random.split(k_aug, N0), M, 5, 2,
                                     64, 64)
            draws.append(tsteps.SearchDraws(
                PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
                crop_draw(jax.random.split(k_t, N0 * M)),
                torch.from_numpy(soft_label_draws(jax.random.split(k_d, N0),
                                                  3))))
    return idx, draws


def test_search_loop_tracks_jax(tmp_path, monkeypatch):
    kw = dict(end_epoch=END, warmup=WARMUP, steps=STEPS, batch=B, M=M,
              out_dir=str(tmp_path))
    cfg, jcfg = pl.testbed_config(**kw), jpl.testbed_config(**kw)
    cfg._set_frozen(False)
    jcfg.defrost()
    cfg.TRAIN.LR = jcfg.TRAIN.LR = 0.0
    cfg._set_frozen(True)
    jcfg.freeze()
    jent = jstate.build_entities(jcfg, "search", steps_per_epoch=STEPS)
    variables = numpy_variables(jent.model, np.zeros((1, 64, 64, 3),
                                                     np.float32),
                                train=False, seed=3)
    dis = jent.disc.init(jax.random.PRNGKey(3),
                         jnp.zeros((1, jent.feature_dim)))["params"]
    sd = jstate.SegDisState(
        seg_params=variables["params"], seg_stats=variables["batch_stats"],
        seg_opt=jent.model_tx.init(variables["params"]), dis_params=dis,
        dis_stats={}, dis_opt=jent.dis_tx.init(dis))
    ctrl = jax.tree_util.tree_map(np.asarray, jctrl.init_params(
        jax.random.PRNGKey(4), jent.ctrl_spec))
    cs = jstate.CtrlState(ctrl, jent.ctrl_tx.init(ctrl))
    store = jstore_of(*jload(jbuild_dataset(jcfg, "train")))
    want = _jax_loop(jcfg, jent, sd, cs, store)

    idx, draws = _replay(want["step_keys"], store)
    tokens = [torch.from_numpy(t) for t in want["tokens"]]

    def init_state(ent, seed, pretrained="", logger=None):
        tsd = port_state(ent, sd)
        _, tcs = tstate.init_state(ent, seed)
        tcs.controller.load_state_dict(controller_from_jax(ctrl))
        return tsd, tcs
    sample = Controller.sample
    monkeypatch.setattr(tsearch, "init_state", init_state)
    monkeypatch.setattr(tsearch, "draw_batch_indices",
                        lambda store, b, gen: idx.pop(0))
    monkeypatch.setattr(tsearch, "draw_pretrain",
                        lambda ent, n0, gen: draws.pop(0))
    monkeypatch.setattr(tsearch, "draw_search",
                        lambda ent, n0, m, h, w, gen: draws.pop(0))
    monkeypatch.setattr(Controller, "sample", lambda self, m, gen: sample(
        self, m, forced_actions=tokens.pop(0)))
    got = tsearch.run_search(cfg, "prove_learning.py", device="cpu")
    assert not idx and not draws and not tokens   # every draw replayed

    search = [e for e in got["epochs"] if e["kind"] == "search"]
    assert len(search) == END - WARMUP
    for e, w in zip(search, want["rewards"]):
        np.testing.assert_allclose(e["rewards"], w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        np.load(f"{got['out_dir']}/op_probs_trajectory.npy"),
        np.stack(want["op_probs"]), rtol=0, atol=1e-5)
    final = load_checkpoint(f"{got['out_dir']}/final_controller_state.pt")
    for k, v in controller_from_jax(want["params"]).items():
        np.testing.assert_allclose(final["controller"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=3e-5, err_msg=k)

"""The port's optimizer, controller updates, losses and train metric against
the JAX package.

Adam on identical gradients: rtol 1e-6, atol 5e-7. optax forms the bias
corrections in f32 (1 - 0.999 = 9.9999e-4, 1.3e-5 off), torch in double,
so each step of size lr=1e-2 may differ by ~6.5e-8.

Controller after one PPO update (5 inner Adam steps) or one REINFORCE
step: rtol 1e-4, atol 1e-5. The atol is 3% of one Adam step at lr 3.5e-4:
a weight whose gradient is near Adam's eps (1e-8) takes a step whose size
depends on the gradient's last bits. Losses, reward normalization and
samplewise F1: rtol 1e-6.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aadg_tpu import losses as jloss
from aadg_tpu import metrics as jmetrics
from aadg_tpu.engine import rl as jrl
from aadg_tpu.engine import state as jstate
from aadg_tpu.models import controller as jctrl
from aadg_tpu_torch import losses as tloss
from aadg_tpu_torch import metrics as tmetrics
from aadg_tpu_torch.engine import rl as trl
from aadg_tpu_torch.engine import state as tstate
from aadg_tpu_torch.models import controller as tctrl
from aadg_tpu_torch.weights import controller_from_jax
from torch_port_helpers import few_torch_threads  # noqa: F401


def test_adam_schedule_and_weight_decay():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    tx = jstate.torch_adam(jstate.multistep_schedule(1e-2, 2, 0.1), 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tstate.torch_adam(tp.values(), tstate.multistep_schedule(1e-2, 2,
                                                                   0.1), 1e-3)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=5e-7)
    assert opt.count == 4 and opt.opt.param_groups[0]["lr"] == pytest.approx(
        1e-3)


@pytest.mark.parametrize("loss_name", ["ppo", "reinforce"])
def test_controller_update_matches_jax(loss_name):
    spec = jctrl.ControllerSpec(num_ops=10)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        jctrl.init_params(jax.random.PRNGKey(0), spec))
    M = 6
    policies, _, _, log_probs, entropies = jax.jit(
        jctrl.sample, static_argnums=(1, 3))(
            params, spec, jax.random.PRNGKey(1), M)
    rewards = np.random.default_rng(2).normal(size=M).astype(np.float32)
    ent = SimpleNamespace(ctrl_spec=spec, ctrl_tx=jstate.torch_adam(0.00035))
    cs = jstate.CtrlState(params, ent.ctrl_tx.init(params))
    new_cs, jstats = jax.jit(jrl.make_controller_update(ent, loss_name, 1e-5))(
        cs, policies, log_probs, entropies, jnp.asarray(rewards))

    model = tctrl.Controller(tctrl.ControllerSpec(num_ops=10))
    model.load_state_dict(controller_from_jax(params))
    tcs = tstate.CtrlState(model, tstate.torch_adam(model.parameters(),
                                                    0.00035))
    tstats = trl.make_controller_update(loss_name, 1e-5)(
        tcs, torch.from_numpy(np.array(policies, np.int64)),
        torch.from_numpy(np.array(log_probs)),
        torch.from_numpy(np.array(entropies)), torch.from_numpy(rewards))
    for k, v in controller_from_jax(
            jax.tree_util.tree_map(np.asarray, new_cs.params)).items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_losses_and_reward_normalization():
    rng = np.random.default_rng(3)
    probs = rng.uniform(0, 1, (4, 8, 8, 2)).astype(np.float32)
    probs[0, 0, 0] = [0.0, 1.0]
    target = (rng.uniform(size=probs.shape) > 0.5).astype(np.float32)
    logits = rng.normal(size=(6, 3)).astype(np.float32)
    soft = rng.dirichlet(np.ones(3), 6).astype(np.float32)
    lp, prev, r = (rng.normal(size=5).astype(np.float32) for _ in range(3))
    ent = rng.uniform(1, 2, 5).astype(np.float32)
    T = torch.from_numpy
    pairs = [
        (tloss.bce_loss(T(probs), T(target)), jloss.bce_loss(probs, target)),
        (tloss.soft_cross_entropy(T(logits), T(soft)),
         jloss.soft_cross_entropy(logits, soft)),
        (tloss.soft_cross_entropy(T(logits), T(soft), "none"),
         jloss.soft_cross_entropy(logits, soft, "none")),
        (tloss.ppo_surrogate_loss(T(lp), T(prev), T(r)),
         jloss.ppo_surrogate_loss(lp, prev, r)),
        (torch.stack(tloss.reinforce_loss(T(lp), T(ent), T(r), 1e-3)),
         jnp.stack(jloss.reinforce_loss(lp, ent, r, 1e-3))),
        (tloss.normalize_rewards(T(r)), jloss.normalize_rewards(r)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def test_samplewise_f1():
    rng = np.random.default_rng(4)
    pred = (rng.uniform(size=(5, 16, 16)) > 0.6).astype(np.float32)
    target = (rng.uniform(size=(5, 16, 16)) > 0.5).astype(np.float32)
    pred[1] = 0.0
    target[1] = 0.0  # empty sample: F1 0 by convention
    w = np.array([1, 1, 0, 1, 1], np.float32)
    for weight in (None, w):
        t = tmetrics.samplewise_f1(torch.from_numpy(pred),
                                   torch.from_numpy(target),
                                   None if weight is None
                                   else torch.from_numpy(weight))
        j = jmetrics.samplewise_f1(pred, target, weight)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

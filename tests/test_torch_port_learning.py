"""The port's learning proof (``aadg_tpu_torch/prove_learning.py``) against
``tools/prove_learning.py``, and the proof itself on the card.

On the CPU (the JAX package as the reference, imported inside the tests so
that this file also runs where JAX is not installed):

- ``testbed_config`` (4-op and full breadth), ``TESTBED_SPACE``,
  ``EXCLUDED``, ``constant_policies`` and ``analyze_trajectory`` (on a
  fabricated run directory) equal the JAX harness's exactly;
- the frozen-state probe rewards (``frozen_rewards``, what ``_raw_rewards``
  computes) within rtol 1e-3 / atol 1e-6 of JAX's ``_raw_rewards`` on the
  same weights (numpy draws over the flax tree, carried by ``from_flax``),
  batches and draws replayed from its key tree: the testbed's UNet at B=1
  per domain, three constant policies, two batches;
- the whole harness (search, trajectory, final landscape, learned against
  random) runs on a 3-epoch testbed and gives finite numbers, and its
  probes leave the state they measure as it was;
- ``thresholds`` and ``met`` (what ``seed_spread`` and ``chip_smoke.py``
  print) read a proof's result as tests/test_learning.py's asserts do.

``gpu`` tests (skip without a card): the 4-op proof and the full-breadth
proof at the JAX tests' recipes (``tests/test_learning.py``: 150 epochs,
30 of warmup, 2 steps of B=4 per domain, M=8, seed 1023), held to every
threshold of those tests, the converged op equal to the final landscape's
argmax included. Each prints its numbers on a ``learning proof`` line
before asserting. On the card::

    python -m pytest --noconftest -p no:cacheprovider -m gpu -s \\
        tests/test_torch_port_learning.py
"""

import json
import math

import numpy as np
import pytest
import torch

from aadg_tpu_torch import prove_learning as pl
from aadg_tpu_torch.ops.augment import augment_list


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("full_space", [False, True])
def test_testbed_config_equals_jax(tmp_path, full_space):
    from tools import prove_learning as jpl
    kw = dict(end_epoch=150, warmup=30, steps=2, batch=4, M=8,
              out_dir=str(tmp_path), full_space=full_space)
    assert _flat(pl.testbed_config(**kw)) == _flat(jpl.testbed_config(**kw))
    assert pl.TESTBED_SPACE == jpl.TESTBED_SPACE
    assert pl.EXCLUDED == jpl.EXCLUDED


def test_constant_policies_equal_jax():
    from tools import prove_learning as jpl
    from aadg_tpu.models import controller as jctrl
    from aadg_tpu_torch.models import controller as tctrl
    cfg = pl.testbed_config()
    op_mags = [(o, m) for o in range(4) for m in (0, 4, 9)]
    want = jpl.constant_policies(jctrl.spec_from_config(cfg, 4), op_mags)
    got = pl.constant_policies(tctrl.spec_from_config(cfg, 4), op_mags)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_analyze_trajectory_equals_jax(tmp_path):
    from tools import prove_learning as jpl
    rng = np.random.default_rng(0)
    traj = rng.dirichlet(np.ones(4), size=12).astype(np.float32)
    np.save(tmp_path / "op_probs_trajectory.npy", traj)
    lines = ["2026-10-17 05:00:00 Train Epoch 0 time:1.0 Speed 5.0 "
             "samples/s seg_loss:0.7000 dis_loss:1.1000"]
    for e in range(1, 13):
        lines.append(f"2026-10-17 05:00:0{e % 10} Train Epoch {e} time:1.0 "
                     f"Speed 5.0 samples/s seg_loss:0.6 dis_loss:1.0 "
                     f"diversity_ot:{rng.normal():.4f} cup_dsc:0.1")
        lines.append(f"Test Epoch {e} dsc@cup:0.1000")
    (tmp_path / "train.log").write_text("\n".join(lines) + "\n")
    got = pl.analyze_trajectory(str(tmp_path), pl.TESTBED_SPACE, tail=5)
    want = jpl.analyze_trajectory(str(tmp_path), jpl.TESTBED_SPACE, tail=5)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got.pop("traj"), want.pop("traj"))
    assert got == want
    assert len(got["reward_series"]) == 12


def test_probe_rewards_match_jax():
    import jax
    import jax.numpy as jnp
    from tools import prove_learning as jpl
    from aadg_tpu.data.datasets import build_dataset as jbuild_dataset
    from aadg_tpu.data.datasets import load_train_arrays as jload
    from aadg_tpu.data.stores import make_train_store as jstore_of
    from aadg_tpu.data.stores import sample_train_batch
    from aadg_tpu.engine import state as jstate
    from aadg_tpu_torch.engine import state as tstate
    from aadg_tpu_torch.engine import steps as tsteps
    from aadg_tpu_torch.ops.augment import PolicyDraw
    from test_torch_port_zoo import numpy_variables
    from torch_port_helpers import (crop_draw, policy_draws, port_state,
                                    soft_label_draws, torch_batch)

    cfg, jcfg = (mod.testbed_config(batch=1, M=2) for mod in (pl, jpl))
    jent = jstate.build_entities(jcfg, "search", steps_per_epoch=4)
    variables = numpy_variables(jent.model, np.zeros((1, 64, 64, 3),
                                                     np.float32),
                                train=False, seed=2)
    dis = jent.disc.init(jax.random.PRNGKey(2),
                         jnp.zeros((1, jent.feature_dim)))["params"]
    sd = jstate.SegDisState(
        seg_params=variables["params"], seg_stats=variables["batch_stats"],
        seg_opt=jent.model_tx.init(variables["params"]), dis_params=dis,
        dis_stats={}, dis_opt=jent.dis_tx.init(dis))
    store = jstore_of(*jload(jbuild_dataset(jcfg, "train")))
    op_mags = [(3, 9), (3, 0), (1, 5)]
    ptens = jpl.constant_policies(jent.ctrl_spec, op_mags)
    key = jax.random.PRNGKey(cfg.SEED + 7)
    want = jpl._raw_rewards(jcfg, jent, sd, store, ptens, key, n_batches=2)

    m, n0 = len(op_mags), 3
    probes = []
    for i in range(2):
        kb, ks = jax.random.split(jax.random.fold_in(key, i))
        batch = tuple(np.asarray(a) for a in sample_train_batch(store, kb, 1))
        k_aug, k_t, k_d, _ = jax.random.split(ks, 4)
        q, centre = policy_draws(jax.random.split(k_aug, n0), m, 5, 2, 64,
                                 64)
        probes.append((torch_batch(batch), tsteps.SearchDraws(
            PolicyDraw(torch.from_numpy(q), torch.from_numpy(centre)),
            crop_draw(jax.random.split(k_t, n0 * m)),
            torch.from_numpy(soft_label_draws(jax.random.split(k_d, n0),
                                              3)))))
    tent = tstate.build_entities(cfg, "search", steps_per_epoch=4,
                                 device="cpu")
    tsd = port_state(tent, sd)
    before = {k: v.clone() for k, v in tsd.model.state_dict().items()}
    got = pl.frozen_rewards(cfg, tent, tsd,
                            pl.constant_policies(tent.ctrl_spec, op_mags),
                            probes)
    assert np.abs(np.asarray(want)).min() > 1e-3   # not vacuous
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-6)
    for k, v in tsd.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_harness_runs_on_a_short_testbed(tmp_path):
    cfg = pl.testbed_config(end_epoch=3, warmup=1, steps=1, batch=1, M=2,
                            out_dir=str(tmp_path))
    res = pl.run_proof(cfg, pl.TESTBED_SPACE, tail=2, device="cpu")
    assert len(res["reward_series"]) == 2
    assert res["landscape_ops"] == pl.TESTBED_SPACE
    assert np.shape(res["landscape"]) == (4, 2)
    assert res["converged_op"] in pl.TESTBED_SPACE
    vals = (res["reward_series"] + res["first"] + res["tail_mean"]
            + [v for row in res["landscape"] for v in row]
            + [res["learned"], res["random"]])
    assert all(math.isfinite(v) for v in vals)
    assert len(res["rounds"]["learned"]) == 3



@pytest.mark.parametrize("scale", [0.9, 1.1])
def test_thresholds_read_a_proof_as_the_jax_test(scale):
    rng = np.random.default_rng(3)
    series = list(rng.uniform(0.5, 1.5, 120))
    first = list(rng.dirichlet(np.ones(4)) * scale * 0.6)
    tail = list(rng.dirichlet(np.ones(4)) * scale * 0.9)
    res = {"reward_series": series, "first": first, "tail_mean": tail,
           "learned": 1.2 * scale, "random": 1.0}
    third = len(series) // 3
    early, late = np.mean(series[:third]), np.mean(series[-third:])
    got = pl.thresholds(res)
    np.testing.assert_allclose(
        [got[k] for k, _, _ in pl.THRESHOLDS],
        [late / early, max(first), max(tail), 1.2 * scale], rtol=1e-12)
    assert pl.met(got) == {
        "late_early": late > 1.15 * early, "first_max": max(first) < 0.30,
        "tail_max": max(tail) > 0.45,
        "learned_random": res["learned"] > 1.2 * res["random"]}

# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aadg_tpu_torch.engine.search import set_precision_flags
    set_precision_flags()
    return torch.device("cuda")


def _report(tag, res):
    print(f"learning proof {tag}: " + json.dumps(
        {k: v for k, v in res.items() if k != "out_dir"}), flush=True)


@pytest.mark.gpu
def test_four_op_proof_on_card(cuda, tmp_path):
    cfg = pl.testbed_config(end_epoch=150, warmup=30, steps=2, batch=4, M=8,
                            out_dir=str(tmp_path))
    res = pl.run_proof(cfg, pl.TESTBED_SPACE, tail=10, device=cuda)
    _report("4-op", res)
    series = res["reward_series"]
    assert len(series) == 150 - 30
    third = len(series) // 3
    early, late = np.mean(series[:third]), np.mean(series[-third:])
    assert late > 1.15 * early, (early, late)
    assert max(res["first"]) < 0.30, res["first"]
    assert max(res["tail_mean"]) > 0.45, res["tail_mean"]
    assert res["converged_op"] == res["landscape_op"], res
    assert res["learned"] > 1.2 * res["random"], res


@pytest.mark.gpu
def test_full_breadth_proof_on_card(cuda, tmp_path):
    cfg = pl.testbed_config(end_epoch=150, warmup=30, steps=2, batch=4, M=8,
                            out_dir=str(tmp_path), full_space=True)
    names = augment_list()
    res = pl.run_proof(cfg, names, tail=10, device=cuda)
    _report("full breadth", res)
    assert max(res["first"]) < 0.15, res["first"]
    assert res["landscape_ops"] == names
    tail = np.asarray(res["tail_mean"])
    order = np.argsort(-np.asarray(res["landscape"]).max(axis=1))
    assert tail[order[:6]].sum() > 0.60, res
    assert tail[order[-3:]].sum() < 0.15, res
    assert res["learned"] > 1.2 * res["random"], res

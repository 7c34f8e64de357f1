"""Learning proof of the policy search (port of ``tools/prove_learning.py``):
does the search optimize its objective?

The testbed (``synthetic_optic_tint``, 64 x 64) has domains that differ only
by a chroma tint under pure-luma noise, so the diversity-maximizing op is
known by construction. In the 4-op space {AutoContrast, Invert, Equalize,
Color}, Color at a high magnitude amplifies the tint's signal to noise,
Color at a low magnitude desaturates it away, AutoContrast and Equalize
erase it and Invert preserves distances. The measurements run on the
production machinery (``engine.steps.make_search_step``,
``engine.search.run_search``):

1. ``measure_op_mag_rewards``: raw per-policy Sinkhorn rewards of constant
   single-op policies across magnitudes on a warmed-up state;
2. ``run_search`` and ``analyze_trajectory``: the per-epoch raw reward
   (``diversity_ot`` in ``train.log``) and the controller's op
   probabilities (``op_probs_trajectory.npy``);
3. ``measure_final_landscape``: the constant-op landscape on the run's
   final state (the objective is non-stationary: the segmentation model
   and the discriminator co-train on the augmented stream);
4. ``learned_vs_random``: policies sampled from the learned controller
   against the epoch-0 controller's, on the same frozen final state,
   batches and draws.

Random draws come from ``torch.Generator``s seeded from ``cfg.SEED``: the
warmup from ``SEED`` as the search loop draws, the probes from
``SEED + 7`` and the learned-vs-random rounds from ``SEED + 31``, where the
JAX harness folds its keys. Run it on the card, or with ``--device cpu``::

    python -m aadg_tpu_torch.prove_learning [--epochs N] [--full-space] \\
        [--out DIR] [--device cuda|cpu]

``seed_spread`` runs the 4-op test recipe at several seeds and once with
bf16 convolutions, on the card::

    python -c "from aadg_tpu_torch.prove_learning import seed_spread; \\
        seed_spread()"
"""

from __future__ import annotations

import contextlib
import json
import os
import re

import numpy as np
import torch

from .config import load_config
from .data.datasets import build_dataset, load_train_arrays
from .data.stores import draw_batch_indices, gather_batch, make_train_store
from .engine.search import run_search, set_precision_flags
from .engine.state import build_entities, init_state
from .engine.steps import (draw_pretrain, draw_search, make_pretrain_step,
                           make_search_step)
from .models.controller import policies_to_tensor
from .models.discriminator import synchronize_parameters
from .ops.augment import augment_list
from .utils.checkpoint import (find_resume_checkpoint, load_checkpoint,
                               to_host)

TESTBED_SPACE = ["AutoContrast", "Invert", "Equalize", "Color"]
EXCLUDED = [n for n in augment_list() if n not in TESTBED_SPACE]
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "tests", "fixtures", "synthetic_optic.yaml")


def testbed_config(end_epoch: int = 24, warmup: int = 4, steps: int = 4,
                   batch: int = 4, M: int = 8, size: int = 64,
                   out_dir: str = "output/prove_learning", seed: int = 1023,
                   full_space: bool = False):
    """The fixture search config on the tint testbed, narrowed to the 4-op
    space, or at the production 10-op breadth with ``full_space``."""
    cfg = load_config(FIXTURE, [
        "DATASET.NAME", "synthetic_optic_tint",
        "CONTROLLER.M", str(M),
        "TRAIN.BATCH_SIZE", str(batch),
        "TRAIN.WARMUP_EPOCH", str(warmup),
        "TRAIN.END_EPOCH", str(end_epoch),
        "TPU.STEPS_PER_EPOCH", str(steps),
        "TPU.CROP_SIZE", str(size),
        "TPU.SYNTHETIC_SIZE", str(size),
        "TPU.DATA_PARALLEL", "1",
        # checkpoints at the first and the last search epoch only:
        # learned_vs_random needs the final state, nothing else
        "TPU.CHECKPOINT_FREQ", str(max(1, end_epoch - warmup - 1)),
    ])
    cfg.CONTROLLER.EXCLUDE_OPS = [] if full_space else EXCLUDED
    cfg.TPU.AUTO_RESUME = False
    cfg.OUTPUT_DIR = out_dir
    cfg.SEED = seed
    cfg.freeze()
    return cfg


def _build(cfg, device):
    steps = int(cfg.TPU.STEPS_PER_EPOCH)
    ent = build_entities(cfg, "search", steps_per_epoch=steps, device=device)
    sd, cs = init_state(ent, int(cfg.SEED))
    store = make_train_store(*load_train_arrays(build_dataset(cfg, "train")),
                             ent.device)
    return ent, sd, cs, store


def _warmed_state(cfg, ent, sd, store, warmup_epochs: int):
    """``warmup_epochs`` pretrain epochs drawn as the search loop draws
    them, then the momentum discriminator synchronized: the state the
    search computes its first rewards on."""
    step = make_pretrain_step(ent)
    gen = torch.Generator(ent.device).manual_seed(int(cfg.SEED))
    b = int(cfg.TRAIN.BATCH_SIZE)
    for _ in range(warmup_epochs * int(cfg.TPU.STEPS_PER_EPOCH)):
        batch = gather_batch(store, draw_batch_indices(store, b, gen))
        step(sd, batch, draw_pretrain(ent, b * store.n_domains, gen))
    synchronize_parameters(sd.disc)
    return sd


def constant_policies(spec, op_mags) -> torch.Tensor:
    """(len(op_mags), Q, L, 2) policies: policy i applies op_mags[i] =
    (op index, magnitude index) in every sub-policy slot."""
    toks = torch.zeros((len(op_mags), spec.Q, spec.L, 2), dtype=torch.int64)
    for i, (op_idx, mag_idx) in enumerate(op_mags):
        toks[i, :, :, 0] = op_idx
        toks[i, :, :, 1] = mag_idx
    return toks


def frozen_rewards(cfg, ent, sd, ptens, probes) -> np.ndarray:
    """Mean raw per-policy Sinkhorn rewards of the policies ``ptens`` over
    the (batch, draws) pairs ``probes`` through the production search
    step, on a frozen state: every probe step's update of the modules and
    optimizers is undone."""
    m = int(ptens.shape[0])
    step = make_search_step(ent, m, float(cfg.TPU.SINKHORN.BLUR),
                            float(cfg.TPU.SINKHORN.SCALING))
    frozen = to_host(sd.state_dict())
    ptens = ptens.to(ent.device)
    total = torch.zeros(m, dtype=torch.float64, device=ent.device)
    n = 0
    for batch, draws in probes:
        total += step(sd, batch, ptens, draws)[1].double()
        # a fresh copy each time: an optimizer keeps the tensors it loads
        sd.load_state_dict(to_host(frozen))
        n += 1
    return (total / n).cpu().numpy()


def _raw_rewards(cfg, ent, sd, store, ptens, seed: int,
                 n_batches: int = 4) -> np.ndarray:
    """``frozen_rewards`` over ``n_batches`` batches and their draws, from a
    generator seeded ``seed``."""
    gen = torch.Generator(ent.device).manual_seed(seed)
    b, m = int(cfg.TRAIN.BATCH_SIZE), int(ptens.shape[0])
    n0 = b * store.n_domains
    h, w = store.images.shape[2], store.images.shape[3]

    def probes():
        for _ in range(n_batches):
            batch = gather_batch(store, draw_batch_indices(store, b, gen))
            yield batch, draw_search(ent, n0, m, h, w, gen)
    return frozen_rewards(cfg, ent, sd, ptens, probes())


def measure_op_mag_rewards(cfg=None, mag_indices=(0, 4, 9),
                           n_batches: int = 4, device="cuda"):
    """Calibration: the raw reward per (op, magnitude) on the warmed
    testbed. Returns (op_names, mag_indices, rewards[n_ops, n_mags])."""
    cfg = cfg or testbed_config()
    ent, sd, _, store = _build(cfg, device)
    sd = _warmed_state(cfg, ent, sd, store, int(cfg.TRAIN.WARMUP_EPOCH))
    op_mags = [(o, m) for o in range(len(ent.op_names))
               for m in mag_indices]
    r = _raw_rewards(cfg, ent, sd, store,
                     constant_policies(ent.ctrl_spec, op_mags),
                     int(cfg.SEED) + 7, n_batches)
    return ent.op_names, list(mag_indices), r.reshape(
        len(ent.op_names), len(mag_indices))


def analyze_trajectory(out_dir: str, op_names, tail: int = 3) -> dict:
    """The first-epoch and tail-mean op probabilities and the per-epoch raw
    reward series (the epoch's ``diversity_ot``, the sum of the M raw
    per-policy rewards before normalization, from ``train.log``)."""
    traj = np.load(os.path.join(out_dir, "op_probs_trajectory.npy"))
    series = []
    with open(os.path.join(out_dir, "train.log")) as fh:
        for line in fh:
            m = re.search(r"Train Epoch \d+ .*diversity_ot:([-\d.]+)", line)
            if m:
                series.append(float(m.group(1)))
    return {"op_names": list(op_names), "first": traj[0].tolist(),
            "tail_mean": traj[-tail:].mean(axis=0).tolist(), "traj": traj,
            "reward_series": series}


def _restore_final(cfg, out_dir: str, device):
    """Entities and the run's final (state, controller state)."""
    ent, sd, cs, store = _build(cfg, device)
    ckpt = find_resume_checkpoint(out_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint under {out_dir}")
    restored = load_checkpoint(ckpt)
    sd.load_state_dict(restored["sd"])
    cs.load_state_dict(restored["cs"])
    return ent, sd, cs, store


def measure_final_landscape(cfg, out_dir: str, mag_indices=(0, 9),
                            n_batches: int = 3, device="cuda"):
    """The constant-op reward landscape on the run's final state. Returns
    (op_names, rewards[n_ops, n_mags])."""
    ent, sd, _, store = _restore_final(cfg, out_dir, device)
    op_mags = [(o, m) for o in range(len(ent.op_names))
               for m in mag_indices]
    r = _raw_rewards(cfg, ent, sd, store,
                     constant_policies(ent.ctrl_spec, op_mags),
                     int(cfg.SEED) + 7, n_batches)
    return ent.op_names, r.reshape(len(ent.op_names), len(mag_indices))


def _fold(seed: int, i: int) -> int:
    """A seed derived from ``seed`` and ``i``, distinct for each pair."""
    return seed * 1_000_003 + i


def learned_vs_random(cfg, out_dir: str, n_rounds: int = 3,
                      n_batches: int = 3, device="cuda"):
    """Mean raw reward of policies sampled from the learned controller and
    from the epoch-0 controller (rebuilt from the run's seed), each round
    with the same sampling draws for both and the same batches and
    augmentation draws, on the frozen final state. Returns ({"learned",
    "random"} means, per-round means)."""
    ent, sd, cs_learned, store = _restore_final(cfg, out_dir, device)
    _, cs_fresh = init_state(ent, int(cfg.SEED))
    M = int(cfg.CONTROLLER.M)
    means = {"learned": [], "random": []}
    for r in range(n_rounds):
        k = _fold(int(cfg.SEED) + 31, r)
        for name, cs in (("learned", cs_learned), ("random", cs_fresh)):
            gen = torch.Generator(ent.device).manual_seed(_fold(k, 0))
            with torch.no_grad():
                ptens = policies_to_tensor(cs.controller.sample(M, gen)[0],
                                           ent.ctrl_spec)
            rr = _raw_rewards(cfg, ent, sd, store, ptens, _fold(k, 1),
                              n_batches)
            means[name].append(float(rr.mean()))
    return {k: float(np.mean(v)) for k, v in means.items()}, means


def run_proof(cfg, space, tail: int = 10, device="cuda") -> dict:
    """The search of ``cfg`` and every number the proof reads from it: the
    raw reward series, the first and tail-mean op probabilities, the
    final-state landscape, the op the controller converged on (largest
    rise in probability) beside the landscape's best op, and the learned
    and random controllers' mean rewards."""
    out_dir = run_search(cfg, "prove_learning.py", device=device)["out_dir"]
    ana = analyze_trajectory(out_dir, space, tail=tail)
    lnames, rf = measure_final_landscape(cfg, out_dir, device=device)
    ab, rounds = learned_vs_random(cfg, out_dir, device=device)
    first, tail_mean = np.asarray(ana["first"]), np.asarray(ana["tail_mean"])
    return {"out_dir": out_dir, "op_names": ana["op_names"],
            "first": ana["first"], "tail_mean": ana["tail_mean"],
            "reward_series": ana["reward_series"],
            "landscape_ops": list(lnames), "landscape": rf.tolist(),
            "converged_op": ana["op_names"][int(np.argmax(tail_mean
                                                          - first))],
            "landscape_op": lnames[int(np.argmax(rf.max(axis=1)))],
            "learned": ab["learned"], "random": ab["random"],
            "rounds": rounds}


# the four thresholds of tests/test_learning.py's 4-op proof
THRESHOLDS = (("late_early", ">", 1.15), ("first_max", "<", 0.30),
              ("tail_max", ">", 0.45), ("learned_random", ">", 1.2))


def thresholds(res: dict) -> dict:
    """The four numbers of ``run_proof``'s result that the thresholds hold:
    late-third over early-third raw reward, the first epoch's largest op
    probability, the tail's largest, learned over random reward."""
    series = res["reward_series"]
    third = len(series) // 3
    early, late = sum(series[:third]) / third, sum(series[-third:]) / third
    return {"late_early": late / early, "first_max": max(res["first"]),
            "tail_max": max(res["tail_mean"]),
            "learned_random": res["learned"] / res["random"]}


def met(values: dict) -> dict:
    return {k: values[k] > v if op == ">" else values[k] < v
            for k, op, v in THRESHOLDS}


@contextlib.contextmanager
def bf16_convolutions():
    """Every ``nn.Conv2d`` forward under bf16 autocast, its output cast back
    to f32, while the block runs; BatchNorm, the losses and the rest stay
    f32: the precision XLA's default gives f32 convolutions on a TPU."""
    orig = torch.nn.Conv2d.forward

    def forward(self, x):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return orig(self, x).float()
    torch.nn.Conv2d.forward = forward
    try:
        yield
    finally:
        torch.nn.Conv2d.forward = orig


def seed_spread() -> list:
    """The 4-op proof at tests/test_learning.py's recipe (150 epochs, 30
    warmup, 2 steps, B=4, M=8) at seeds 1023, 1, 2, 3 and 4 in f32, then at
    seed 1023 with ``bf16_convolutions``, on the card. Prints one line per
    run with its four thresholds met or missed and writes every number to
    ``output/seed_spread/seed_spread.json``."""
    out = "output/seed_spread"
    set_precision_flags()
    runs = []
    for seed, bf16 in ((1023, False), (1, False), (2, False), (3, False),
                       (4, False), (1023, True)):
        precision = "bf16" if bf16 else "f32"
        cfg = testbed_config(end_epoch=150, warmup=30, steps=2, batch=4, M=8,
                             seed=seed, out_dir=f"{out}/{precision}_{seed}")
        with bf16_convolutions() if bf16 else contextlib.nullcontext():
            res = run_proof(cfg, TESTBED_SPACE, tail=10, device="cuda")
        values = thresholds(res)
        ok = met(values)
        runs.append({"seed": seed, "convolutions": precision, **values,
                     "met": ok, **{k: res[k] for k in (
                         "converged_op", "landscape_op", "first", "tail_mean",
                         "learned", "random", "reward_series")}})
        print(f"[seed spread] seed {seed}, convolutions {precision}: "
              + ", ".join(f"{k} {values[k]:.4f} "
                          f"({'met' if ok[k] else 'missed'}: {op} {v})"
                          for k, op, v in THRESHOLDS)
              + f"; converged {res['converged_op']}, landscape argmax "
              f"{res['landscape_op']}", flush=True)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "seed_spread.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return runs

def main(argv=None):
    import argparse

    from .run import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--out", type=str, default="output/prove_learning")
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--full-space", action="store_true",
                    help="run at the production 10-op search breadth "
                         "instead of the 4-op testbed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision_flags()

    cfg = testbed_config(end_epoch=args.epochs, warmup=args.warmup,
                         steps=args.steps, batch=args.batch, M=args.M,
                         size=args.size, out_dir=args.out,
                         full_space=args.full_space)
    if not args.skip_calibration:
        names, mags, r = measure_op_mag_rewards(cfg, device=device)
        print("\n== calibration: raw reward per (op, mag) ==")
        for i, n in enumerate(names):
            print(f"  {n:<14} " + "  ".join(
                f"mag{m}:{r[i, j]:8.4f}" for j, m in enumerate(mags)))

    out_dir = run_search(cfg, "prove_learning.py", device=device)["out_dir"]
    print("search out_dir:", out_dir)
    space = augment_list() if args.full_space else TESTBED_SPACE
    ana = analyze_trajectory(out_dir, space)
    print("\n== trajectory ==")
    print("op_names   :", ana["op_names"])
    print("first epoch:", np.round(ana["first"], 4))
    print("tail mean  :", np.round(ana["tail_mean"], 4))
    rs = ana["reward_series"]
    h = max(1, len(rs) // 4)
    print(f"raw reward: first-{h} mean {np.mean(rs[:h]):.4f} -> "
          f"last-{h} mean {np.mean(rs[-h:]):.4f}")

    names, rf = measure_final_landscape(cfg, out_dir, device=device)
    print("\n== final-state landscape (mag 0 / mag 9) ==")
    for i, n in enumerate(names):
        print(f"  {n:<14} {rf[i, 0]:8.4f}  {rf[i, 1]:8.4f}")

    ab, rounds = learned_vs_random(cfg, out_dir, device=device)
    print("\n== learned vs random controller (mean raw reward) ==")
    print(ab, rounds)


if __name__ == "__main__":
    main()

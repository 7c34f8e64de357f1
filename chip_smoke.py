"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each on stdout; any failure ends the run with a nonzero
exit code:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: nvcc on aadg_tpu_torch/csrc/*.cu (all sources at once, sm_90a),
   with the build time and the -Xptxas -v summary;
3. kernels: K1 (softmin), sinkhorn_solve, K2 (hist3) and K3 (lut_apply3)
   held to their plain PyTorch versions at the main path's shapes (K2/K3
   exactly, K1 and sinkhorn_solve within rtol 1e-5 / atol 1e-6; K1 also on
   one 4096 x 4096 x 128 cloud, sinkhorn_solve also on a ragged weighted
   case and at its size limit), then timed with CUDA events beside the
   plain version, one library call where one exists, and the least time
   the card could take (bound); sinkhorn_solve also beside the 26-launch
   K1 route it replaced on the main path, with the device time per call of
   both from torch.profiler. K1 is driven through its own route (a
   sinkhorn_divergence above SOLVE_MAX_POINTS), and the rewards' call
   pairwise_domain_ot runs under torch.cuda.set_sync_debug_mode("error");
4. reference: one search step on the card (kernels) and on the CPU (plain
   versions) from the same weights, batch and draws at crop 64 in f32;
   losses within rtol 1e-4 and rewards within rtol 1e-3;
5. main path: run_search on the flagship config
   (experiments/optic_sinkhorn/diversity.yaml: DeepLabV3+/MobileNetV2,
   B=8 x 3 domains x M=6 policies, crop 256) on synthetic_optic at 256^2,
   one warmup and two search epochs of two steps, with every launch
   counter set to 0 just before; sinkhorn_solve must have been launched
   once per search step, K1 never, K2 and K3 at least once, and every loss
   and reward must be finite;
6. profile: three more flagship search steps under torch.profiler, with
   the device time per kernel category, the device's idle share, the host
   and device time of each stage, and the stream synchronizations and
   host-to-device copies per step.

Then a line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when no
CUDA card is visible.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from aadg_tpu_torch import _build
    t0 = time.perf_counter()
    results = _build.build_all(force=True)
    log(f"[build] {len(results)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (sec, out) in sorted(results.items()):
        summary = [ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {sec:.1f} s; " + " | ".join(summary))


def phase_kernels(dev):
    from aadg_tpu_torch.ops import lut, sinkhorn
    gen = torch.Generator(dev).manual_seed(0)
    rows = []

    # K2 / K3 at the slot shape of the main path: 144 images of 256^2
    n, h, w = 144, 256, 256
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=gen,
                         device=dev).float()
    hist = lut.hist3(imgs)
    torch.cuda.synchronize()
    ref = lut.hist3_plain(imgs)
    if not torch.equal(hist, ref):
        raise AssertionError("hist3 kernel disagrees with its plain version")
    luts = torch.randint(0, 256, (n, 3, 256), generator=gen,
                         device=dev).float()
    out = lut.lut_apply3(imgs, luts)
    torch.cuda.synchronize()
    if not torch.equal(out, lut.lut_apply3_plain(imgs, luts)):
        raise AssertionError("lut_apply3 kernel disagrees with its plain "
                             "version")
    vals = imgs.long().reshape(n, -1)
    chan = torch.arange(vals.shape[1], device=dev) % 3
    codes_hist = (torch.arange(n, device=dev)[:, None] * 768 + chan * 256
                  + vals).reshape(-1)
    codes_lut = (chan * 256 + vals).contiguous()
    lut_flat = luts.reshape(n, 768)
    px = n * h * w * 3
    for name, kern, plain, lib, nbytes, nops, src, tpu in (
            ("hist3", lambda: lut.hist3(imgs), lambda: lut.hist3_plain(imgs),
             lambda: torch.bincount(codes_hist, minlength=n * 768),
             4 * px + 4 * n * 768, px,
             "aadg_tpu_torch/csrc/hist3.cu",
             "aadg_tpu/ops/lut_pallas.py:79"),
            ("lut_apply3", lambda: lut.lut_apply3(imgs, luts),
             lambda: lut.lut_apply3_plain(imgs, luts),
             lambda: torch.gather(lut_flat, 1, codes_lut),
             8 * px + 4 * n * 768, px,
             "aadg_tpu_torch/csrc/lut_apply3.cu",
             "aadg_tpu/ops/lut_pallas.py:95")):
        b, by = bound_ms(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": 0, "max_abs_err": 0.0,
                     "ms": time_ms(kern), "plain_ms": time_ms(plain),
                     "bound_ms": b, "bound_by": by,
                     "library_ms": time_ms(lib),
                     "shape": [n, h, w, 3]})
        log(f"[kernels] {name} exact at {n}x{h}x{w}x3: "
            f"{rows[-1]['ms']:.4f} ms (plain {rows[-1]['plain_ms']:.4f}, "
            f"library {rows[-1]['library_ms']:.4f}, bound {b:.4f} by {by})")

    def softmin_case(p, nn, m, d):
        xn = sinkhorn.normalize_rows(torch.randn(p, nn, d, generator=gen,
                                                 device=dev)).contiguous()
        yn = sinkhorn.normalize_rows(torch.randn(p, m, d, generator=gen,
                                                 device=dev)).contiguous()
        zb = (math.log(1.0 / m) + 0.3 * torch.randn(p, m, generator=gen,
                                                    device=dev)).contiguous()
        errs = []
        for eps in (2.0, 0.05):
            got = sinkhorn.softmin(eps, xn, yn, zb)
            torch.cuda.synchronize()
            want = sinkhorn.softmin_plain(eps, xn, yn, zb)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            errs.append(float((got - want).abs().max()))
        eps = 0.05
        b, by = bound_ms(4 * (p * nn * d + p * m * d + p * m + p * nn),
                         2 * p * nn * m * d)
        return {"ms": time_ms(lambda: sinkhorn.softmin(eps, xn, yn, zb)),
                "plain_ms": time_ms(
                    lambda: sinkhorn.softmin_plain(eps, xn, yn, zb)),
                "bound_ms": b, "bound_by": by, "max_abs_err": max(errs),
                "shape": [p, nn, m, d]}

    # the 26-launch route's shape: 6 policies x 3 domain pairs x {xy, xx, yy}
    flag = softmin_case(54, 8, 8, 128)
    large = softmin_case(1, 4096, 4096, 128)
    route = softmin_route(dev, gen)
    rows.append({"name": "softmin", "route": "cuda",
                 "source": "aadg_tpu_torch/csrc/softmin.cu",
                 "replaces": "aadg_tpu/ops/sinkhorn_pallas.py:35",
                 "launches": 0, "library_ms": None, **flag,
                 "large_cloud": large, "own_route": route})
    for tag, r in (("54x8x8x128", flag), ("1x4096x4096x128", large)):
        log(f"[kernels] softmin within rtol 1e-5 at {tag} "
            f"(max abs err {r['max_abs_err']:.3g}): {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    rows.append(solve_row(dev, gen))
    check_rewards_never_sync(dev, gen)
    return rows


def profiled_device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' device
    time under torch.profiler over ``iters`` calls, divided by ``iters``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def softmin_route(dev, gen):
    """K1 on its own route: a divergence of clouds above SOLVE_MAX_POINTS
    goes through one softmin launch per half-step, held to the plain
    version within rtol 1e-5 / atol 1e-6."""
    from aadg_tpu_torch.ops import sinkhorn
    p, n, d = 2, 512, 128
    if sinkhorn.divergence_route("cuda", n, n, d) != "softmin":
        raise AssertionError(f"{n} points should take the K1 route")
    x = torch.randn(p, n, d, generator=gen, device=dev)
    y = torch.randn(p, n, d, generator=gen, device=dev) + 0.3
    before = (sinkhorn.softmin.launches, sinkhorn.sinkhorn_solve.launches)
    got = sinkhorn.sinkhorn_divergence(x, y)
    launched = (sinkhorn.softmin.launches - before[0],
                sinkhorn.sinkhorn_solve.launches - before[1])
    torch.cuda.synchronize()
    if launched[0] <= 0 or launched[1] != 0:
        raise AssertionError(f"K1 route launched (softmin, sinkhorn_solve) "
                             f"{launched}")
    want = sinkhorn.sinkhorn_solve_plain(
        x, y, sinkhorn._eps_schedule(2.0, 0.05, 0.5, 5))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    err = float((got - want).abs().max())
    log(f"[kernels] softmin route: sinkhorn_divergence at {p}x{n}x{n}x{d} "
        f"took {launched[0]} K1 launches, within rtol 1e-5 of the plain "
        f"version (max abs err {err:.3g}, divergences {got.tolist()})")
    return {"shape": [p, n, n, d], "softmin_launches": launched[0],
            "max_abs_err": err}


def solve_row(dev, gen):
    """sinkhorn_solve against its plain version at the main path's 18
    divergences of 8 vs 8 points x 128, a ragged weighted case (5 vs 9) and
    the size limit, within rtol 1e-5 / atol 1e-6; timed at the main path's
    shape beside the plain version and the 26-launch K1 route."""
    from aadg_tpu_torch.ops import sinkhorn
    eps = sinkhorn._eps_schedule(2.0, 0.05, 0.5, 5)
    lim, dim = sinkhorn.SOLVE_MAX_POINTS, sinkhorn.SOLVE_MAX_DIM
    cases = {}
    for tag, p, n, m, d, weighted in (
            ("main", 18, 8, 8, 128, False), ("ragged", 4, 5, 9, 128, True),
            ("limit", 2, lim, lim, dim, True)):
        x = torch.randn(p, n, d, generator=gen, device=dev)
        y = torch.randn(p, m, d, generator=gen, device=dev) + 0.3
        wx, wy = ((torch.rand(p, n, generator=gen, device=dev) + 0.5,
                   torch.rand(p, m, generator=gen, device=dev) + 0.5)
                  if weighted else (None, None))
        got = sinkhorn.sinkhorn_solve(x, y, eps, wx, wy)
        torch.cuda.synchronize()
        want = sinkhorn.sinkhorn_solve_plain(x, y, eps, wx, wy)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        cases[tag] = {"shape": [p, n, m, d], "weighted": weighted,
                      "max_abs_err": float((got - want).abs().max()),
                      "args": (x, y, wx, wy)}
    x, y, _, _ = cases["main"]["args"]
    solve = lambda: sinkhorn.sinkhorn_solve(x, y, eps)
    plain = lambda: sinkhorn.sinkhorn_solve_plain(x, y, eps)
    earlier = lambda: sinkhorn.sinkhorn_loop(sinkhorn.softmin, x, y, eps)
    torch.testing.assert_close(earlier(), plain(), rtol=1e-5, atol=1e-6)
    p, n, m, d = cases["main"]["shape"]
    entries = n * m + n * n + m * m
    # f32 operations: 2 D per cost entry, 8 per entry and half-step
    b, by = bound_ms(4 * (p * n * d + p * m * d + p),
                     p * entries * (2 * d + 8 * 2 * (len(eps) + 1)))
    row = {"name": "sinkhorn_solve", "route": "cuda",
           "source": "aadg_tpu_torch/csrc/sinkhorn_solve.cu",
           "replaces": "aadg_tpu/ops/sinkhorn_pallas.py:35",
           "launches": 0, "max_abs_err": max(
               c["max_abs_err"] for c in cases.values()),
           "ms": time_ms(solve), "plain_ms": time_ms(plain),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "earlier_ms": time_ms(earlier),
           "device_ms": profiled_device_ms(solve),
           "earlier_device_ms": profiled_device_ms(earlier),
           "shape": [p, n, m, d],
           "cases": {k: {kk: vv for kk, vv in c.items() if kk != "args"}
                     for k, c in cases.items()}}
    row["limit_ms"] = time_ms(lambda: sinkhorn.sinkhorn_solve(
        *cases["limit"]["args"][:2], eps, *cases["limit"]["args"][2:]))
    log(f"[kernels] sinkhorn_solve within rtol 1e-5 at "
        + ", ".join(f"{k} {'x'.join(map(str, c['shape']))} (max abs err "
                    f"{c['max_abs_err']:.3g})" for k, c in cases.items())
        + f": {row['ms']:.4f} ms at main (device {row['device_ms']:.4f}; "
        f"plain {row['plain_ms']:.4f}; 26-launch K1 route "
        f"{row['earlier_ms']:.4f}, device {row['earlier_device_ms']:.4f}; "
        f"bound {b:.6f} by {by}); {row['limit_ms']:.4f} ms at the limit")
    return row


def check_rewards_never_sync(dev, gen):
    """The rewards' call at the flagship shape (M=6, 3 domains, B=8,
    F=128) makes no synchronizing call and equals the CPU's result."""
    from aadg_tpu_torch.ops import sinkhorn
    feats = torch.randn(6, 3, 8, 128, generator=gen, device=dev)
    torch.cuda.synchronize()
    before = sinkhorn.sinkhorn_solve.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sinkhorn.pairwise_domain_ot(feats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = sinkhorn.sinkhorn_solve.launches - before
    want = sinkhorn.pairwise_domain_ot(feats.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    if launched != 1:
        raise AssertionError(f"pairwise_domain_ot launched sinkhorn_solve "
                             f"{launched} times")
    log("[kernels] pairwise_domain_ot at 6x3x8x128: one sinkhorn_solve "
        "launch, no synchronizing call under set_sync_debug_mode('error'), "
        "equal to the CPU within rtol 1e-5")


def phase_reference(dev):
    """One search step on the card and on the CPU from the same state."""
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.data.datasets import SyntheticDataset
    from aadg_tpu_torch.engine import state, steps
    cfg = load_config("experiments/optic_sinkhorn/diversity.yaml", [
        "DATASET.NAME", "synthetic_optic", "TPU.CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "1", "CONTROLLER.M", "2",
        "TPU.COMPUTE_DTYPE", "float32"])
    ds = SyntheticDataset("optic", n_per_domain=1, size=64)
    imgs = torch.stack([torch.from_numpy(d.images[0]) for d in ds.domains])
    masks = torch.stack([torch.from_numpy(d.labels[0]) for d in ds.domains])
    batch = (imgs[None].float(), masks[None].float(),
             torch.arange(3)[None])
    pol = torch.randint(0, 10, (2, 5, 2, 2),
                        generator=torch.Generator().manual_seed(1))
    ent_cpu = state.build_entities(cfg, "search", 1, "cpu")
    draws = steps.draw_search(ent_cpu, 3, 2, 64, 64,
                              torch.Generator().manual_seed(2))
    results = {}
    for device in ("cpu", dev):
        ent = state.build_entities(cfg, "search", 1, device)
        sd, _ = state.init_state(ent, 0)
        move = lambda t: t.to(device)
        d = steps.SearchDraws(
            type(draws.policy)(*map(move, draws.policy)),
            type(draws.crop)(*map(move, draws.crop)), move(draws.soft))
        ms, r = steps.make_search_step(ent, 2)(
            sd, tuple(map(move, batch)), move(pol), d)
        results[str(device)] = ({k: float(v) for k, v in ms.items()},
                                r.cpu())
    (m_cpu, r_cpu), (m_gpu, r_gpu) = results["cpu"], results[str(dev)]
    for k in ("seg_loss", "dis_loss"):
        if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4):
            raise AssertionError(f"{k}: card {m_gpu[k]} vs cpu {m_cpu[k]}")
    torch.testing.assert_close(r_gpu, r_cpu, rtol=1e-3, atol=1e-6)
    log(f"[reference] search step at crop 64: card == cpu "
        f"(seg_loss {m_gpu['seg_loss']:.6f} vs {m_cpu['seg_loss']:.6f}, "
        f"rewards {r_gpu.tolist()} vs {r_cpu.tolist()})")


def phase_main_path(dev):
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.engine.search import run_search
    from aadg_tpu_torch.ops import lut, sinkhorn
    cfg_path = "experiments/optic_sinkhorn/diversity.yaml"
    cfg = load_config(cfg_path, [
        "DATASET.NAME", "synthetic_optic", "TPU.SYNTHETIC_SIZE", "256",
        "TRAIN.WARMUP_EPOCH", "1", "TRAIN.END_EPOCH", "3",
        "TPU.STEPS_PER_EPOCH", "2", "OUTPUT_DIR", "output/chip_smoke"])
    cfg.freeze()
    torch.cuda.reset_peak_memory_stats(dev)
    wrappers = {"hist3": lut.hist3, "lut_apply3": lut.lut_apply3,
                "softmin": sinkhorn.softmin,
                "sinkhorn_solve": sinkhorn.sinkhorn_solve}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    summary = run_search(cfg, cfg_path, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    n_steps = len(summary["search_step_seconds"])
    expect = {"sinkhorn_solve": lambda v: v == n_steps,
              "softmin": lambda v: v == 0,
              "hist3": lambda v: v > 0, "lut_apply3": lambda v: v > 0}
    for k, v in launches.items():
        if not expect[k](v):
            raise AssertionError(f"kernel {k} launched {v} times over the "
                                 f"main path's {n_steps} search steps")
    for e in summary["epochs"]:
        vals = list(e["metrics"].values()) + e.get("rewards", []) + [
            x for r in e.get("raw_rewards", []) for x in r] + list(
                e.get("controller", {}).values())
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite values in epoch {e}")
    steps = summary["search_step_seconds"]
    imgs = summary["images_per_search_step"]
    med = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"[main path] run_search: {len(summary['epochs'])} epochs in "
        f"{wall:.1f} s; search step median {med * 1e3:.1f} ms over "
        f"{len(steps)} steps ({imgs} images, {imgs / med:.1f} img/s; "
        f"steps {[round(s * 1e3, 1) for s in steps]} ms); peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    return launches


_CATEGORIES = (  # first match wins; kernel names lower-cased
    ("sinkhorn_solve", ("sinkhorn_solve_kernel",)),
    ("K1 softmin", ("softmin_kernel",)),
    ("K2 hist3", ("hist3_kernel",)),
    ("K3 lut_apply3", ("lut_apply3_kernel",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("convolution", ("conv", "xmma", "implicit", "wgrad", "dgrad", "cudnn",
                     "nhwc", "nchw", "depthwise")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_")),
    ("layout transform", ("tensortransform", "transpose", "nchwtonhwc",
                          "nhwctonchw")),
    ("copy/memset", ("memcpy", "memset", "copy")),
    ("reduction", ("reduce",)),
    ("index/gather", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def phase_profile(dev, steps: int = 3):
    """Device time of one flagship search step by kernel category, from
    torch.profiler over ``steps`` steps after two warm-up steps, the
    device's idle share (1 - kernel time / wall time), and the stream
    synchronizations and host-to-device copies per step, in all and inside
    the rewards stage."""
    from torch.profiler import ProfilerActivity, profile
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.data.datasets import build_dataset, load_train_arrays
    from aadg_tpu_torch.data.stores import (draw_batch_indices, gather_batch,
                                            make_train_store)
    from aadg_tpu_torch.engine import state, steps as steps_mod
    from aadg_tpu_torch.models.controller import policies_to_tensor
    cfg = load_config("experiments/optic_sinkhorn/diversity.yaml", [
        "DATASET.NAME", "synthetic_optic", "TPU.SYNTHETIC_SIZE", "256"])
    store = make_train_store(*load_train_arrays(build_dataset(cfg, "train")),
                             dev)
    ent = state.build_entities(cfg, "search", 2, dev)
    sd, cs = state.init_state(ent, 0)
    gen = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        pol = policies_to_tensor(cs.controller.sample(6, gen)[0],
                                 ent.ctrl_spec)
    step = steps_mod.make_search_step(ent, 6)

    def one():
        raw = gather_batch(store, draw_batch_indices(store, 8, gen))
        step(sd, raw, pol, steps_mod.draw_search(ent, 24, 6, 256, 256, gen))

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_cat, per_kernel, stages = {}, {}, {}
    for evt in prof.key_averages():
        if evt.key.startswith("search/"):
            # the step's stage ranges: host time on the CPU row, the span of
            # the stage's kernels on the device row
            on_device = evt.device_type == torch.autograd.DeviceType.CUDA
            us = (max(getattr(evt, "self_device_time_total", 0.0),
                      getattr(evt, "device_time_total", 0.0)) if on_device
                  else evt.cpu_time_total)
            stages.setdefault(evt.key[len("search/"):], {})[
                "device_ms" if on_device else "host_ms"] = us / 1e3 / steps
            continue
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue  # ranges such as Optimizer.step overlap their kernels
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        ms = us / 1e3 / steps
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + ms
        cat = _category(evt.key)
        per_cat[cat] = per_cat.get(cat, 0.0) + ms
    busy = sum(per_cat.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    syncs = sync_counts(prof, steps)
    cats = sorted(per_cat.items(), key=lambda kv: -kv[1])
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] search step: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}; by category "
        "(ms/step): " + ", ".join(f"{k} {v:.2f}" for k, v in cats))
    log("[profile] top kernels (ms/step): " + "; ".join(
        f"{k[:70]} {v:.2f}" for k, v in top))
    log("[profile] stages (host ms / device-span ms per step): " + ", ".join(
        f"{k} {v.get('host_ms', 0.0):.2f}/{v.get('device_ms', 0.0):.2f}"
        for k, v in stages.items()))
    log("[profile] per step: " + ", ".join(
        f"{k} {v:g}" for k, v in syncs.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy, "categories": dict(cats),
            "stages": stages, "syncs": syncs}


def sync_counts(prof, steps: int) -> dict:
    """cudaStreamSynchronize calls and host-to-device copies per step, and
    the synchronizing or copying runtime calls issued inside the host
    ranges of search/rewards."""
    events = prof.events()
    rewards = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == "search/rewards"
               and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"cudaStreamSynchronize": 0, "Memcpy HtoD": 0,
           "in rewards: cudaStreamSynchronize": 0,
           "in rewards: cudaMemcpyAsync": 0}
    for e in events:
        if e.name == "cudaStreamSynchronize":
            out["cudaStreamSynchronize"] += 1
        elif e.name.startswith("Memcpy HtoD"):
            out["Memcpy HtoD"] += 1
        if e.name in ("cudaStreamSynchronize", "cudaMemcpyAsync") and any(
                lo <= e.time_range.start <= hi for lo, hi in rewards):
            out["in rewards: " + e.name] += 1
    return {k: v / steps for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    from aadg_tpu_torch.engine.search import set_precision_flags
    set_precision_flags()
    log(f"[device] tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    phase_build()
    rows = phase_kernels(dev)
    phase_reference(dev)
    launches = phase_main_path(dev)
    phase_profile(dev)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

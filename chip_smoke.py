"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each on stdout; any failure ends the run with a nonzero
exit code:

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: nvcc on aadg_tpu_torch/csrc/*.cu (all sources at once, sm_90a),
   with the build time and the -Xptxas -v summary;
3. kernels: K1 (softmin), sinkhorn_solve, K2 (hist3) and K3 (lut_apply3)
   held to their plain PyTorch versions at the main paths' shapes (K2/K3
   exactly, at 144x256^2x3 (optic) and 144x512^2x3 (rvs); K1 and
   sinkhorn_solve within rtol 1e-5 / atol 1e-6; K1 also on one 4096 x 4096
   x 128 cloud, sinkhorn_solve also on a ragged weighted case and at its
   size limit), then timed with CUDA events beside the plain version, one
   library call where one exists, and the least time the card could take
   (bound); sinkhorn_solve also beside the 26-launch K1 route it replaced
   on the main path, with the device time per call of both from
   torch.profiler. K1 is driven through its own route (a
   sinkhorn_divergence above SOLVE_MAX_POINTS), and the rewards' call
   pairwise_domain_ot runs under torch.cuda.set_sync_debug_mode("error").
   K2 and K3 are also timed at 144x512^2x3 on the images an rvs search
   step hands them (slot 1: the pool images, slot 2: the images after the
   first op);

then zoo costs: for each zoo cell, counted on the meta device
(``zoo_costs``): parameters, f32 operations per 256^2 image forward, the
bytes autograd keeps per image, and what the config's search step would
keep, beside the batch the run uses;

then, for each task (optic: experiments/optic_sinkhorn/diversity.yaml on
synthetic_optic at 256^2; rvs: experiments/rvs_sinkhorn/diversity_ex.yaml
on synthetic_rvs at 512^2; both DeepLabV3+/MobileNetV2; segformer:
experiments/zoo/segformer_b4_optic.yaml, SegFormer with MiT-b4 at its
full depth, stochastic depth 0.1 and TPU.REMAT on, on synthetic_optic at
256^2; the zoo: pspnet (experiments/zoo/pspnet_r50_optic.yaml,
PSPNet/ResNet-50) and lraspp (lraspp_mnv3_optic.yaml, LR-ASPP/
MobileNetV3-large) on synthetic_optic at 256^2, ocrnet (ocrnet_hr18_rvs.yaml,
OCRNet/HRNet-W18) and fcn_unet (fcn_unet_rvs.yaml, FCN/UNet-S5-D16) on
synthetic_rvs at 512^2, their heads' classifier dropout drawn in the
draw phase; deeplabv3plus and pointrend (pspnet_r50_optic.yaml with
MODEL.NAME deeplabv3plus, mmseg's DeepLabV3+/R50-D8, and MODEL.NAME
pointrend: FPN, FPNHead and PointHead, whose subdivision refine runs in
the validation and the seg test), resnest (the same file with MODEL.NAME
deeplabv3plus MODEL.BACKBONE resnest101, mmseg's DeepLabV3+/S101-D8, its
search and train paths starting from a seeded mmcv-named ResNeSt-101
checkpoint converted by ``python -m aadg_tpu_torch.convert_weights``) and
fast_scnn (MODEL.NAME fast_scnn over MODEL.BACKBONE fast_scnn) on
synthetic_optic at 256^2; all B=8 x 3 domains x M=6 policies, crop 256,
except fcn_unet's search at B=1 (at B=2 its search step fits in memory
but cuDNN runs the head's data gradients 30x slower) and resnest's at B=5
(the largest its counted memory lets fit)):

4. reference: one search step on the card (kernels) and on the CPU (plain
   versions) from the same weights, batch and draws at crop 64 in f32
   (optic pools 64^2, rvs pools 128^2, so rvs draws scales below 1);
   losses within rtol 1e-4 and rewards within rtol 1e-3;
5. search path: ``python -m aadg_tpu_torch.run --mode search`` at full
   width, one warmup and two search epochs of two steps (one search epoch
   for pspnet, lraspp, ocrnet and fcn_unet, for the time the zoo sweep
   takes), validating after
   every epoch and checkpointing every search epoch; sinkhorn_solve must
   have been launched once per search step, K1 never, K2 and K3 L=2 times
   per search step, every loss, reward and validation number must be
   finite (the synthetic rvs ROIs hold both classes, so AUROC is defined),
   final_result.json must hold its task's keys in range, and
   final_controller_state.pt must load; with TPU.PRETRAINED (resnest) the
   module the file is grafted into must hold the file's weights exactly
   at step 0 (``starts_from``), in this path and the next;
6. train path: ``--mode train TPU.AUTOAUGMENT True TEST.MODEL_DIR <search
   run>`` at the same width, two epochs of three steps; K2 and K3 exactly
   L=2 launches per train step, sinkhorn_solve and K1 none, finite losses
   and final_result.json;
7. train reference: one autoaugment train step on the card and on the CPU
   from the same weights, batch and draws at crop 64 in f32, once for each
   outcome of its coin; losses within rtol 1e-4;
8. test path: ``--mode test --output_type seg`` from the train run (4
   PNG maps and the CSV table) and ``--output_type image`` from the search
   run (32 augmented images); K2 and K3 exactly L=2 launches (the image
   call), the others none;
9. profile: three more full-width search steps and three train steps
   under torch.profiler, each after two warm-up steps and one step run
   under torch.cuda.set_sync_debug_mode("error") (any synchronizing call
   fails the run), with the device time per kernel category, the device's
   idle share, the peak memory allocated, the host and device time of
   each stage, and the stream synchronizations and host-to-device copies
   per step; for segformer the
   categories show LayerNorm, GELU and the softmax (the attention's, and
   the soft cross-entropy's);

and for segformer also:

10. attention: ``models/segformer.py::attention`` (matmul, softmax,
    matmul) forward and backward at each MiT-b4 stage's shapes of one
    search step, timed with CUDA events beside
    ``F.scaled_dot_product_attention`` on the same inputs and the bound,
    summed over the blocks into ms per search step (with the forward
    that remat repeats) and its share of the profiled step's device time;
11. remat: one full-width search step with TPU.REMAT true and with false,
    each with its median over 3 steps after a warm-up step and its peak
    memory allocated; a torch.cuda.OutOfMemoryError of the run without
    remat is caught and printed as the finding, any other error fails;
    the parameter count, f32 operations per image and the bytes autograd
    keeps per image with and without remat (``segformer_costs``).

then:

12. pretrained optic search: the optic search path (one warmup and one
    search epoch) with TPU.PRETRAINED naming a seeded torchvision
    MobileNetV2 checkpoint converted by the port's CLI; the encoder at
    step 0 must equal the file;
13. zoo sweep: every other architecture of the zoo over ResNetV1c-50
    (deeplabv3, upernet, sem_fpn, the attention heads, fast_scnn) and the
    FCN over ResNetV1c-101, ResNeXt-50/101, HRNet-W32/48, ResNeSt-50 and
    CGNet, each on
    pspnet_r50_optic.yaml at full width on the optic pools: its counted
    costs, a warm-up and two timed search steps at B=8 or the largest B
    that fits (a torch.cuda.OutOfMemoryError of the step lowers B by one,
    printed), the peak memory, finite losses, rewards and an eval forward
    of 24 images, and launches of one sinkhorn_solve and L K2 and K3 per
    step;

and last:

14. learning: the learning proof (``aadg_tpu_torch.prove_learning``) at the
    recipes of tests/test_learning.py on synthetic_optic_tint: the
    calibration landscape, asserted (Color@1.9 tops it, above 2x
    Color@0.1 and 2x every other op's best), and the 4-op search of 150
    epochs, its numbers asserted finite and its four thresholds (late-third
    raw reward above 1.15x the early third's, first op-probability maximum
    below 0.30, tail maximum above 0.45, learned policies above 1.2x
    random ones) printed met or missed: at this recipe and seed the port
    misses three of them, an open fault (ROADMAP queue 3, fault 1); the
    converged op is printed beside the final landscape's argmax.

Every path runs with each kernel's launch counter set to 0 just before it
and read just after; the kernels line gives the counts per path (optic
``search``/``train``/``test``, rvs ``rvs_search``/``rvs_train``/
``rvs_test``, segformer ``segformer_search``/..., ``pspnet_search``, ...
``fast_scnn_test``, ``pretrained_search``, ``sweep_<arch>_<backbone>``).
The per-epoch lines give each checkpoint's time in the loop and on its
writer thread; ``[time]`` lines give each phase's seconds, and a line the
script's total time.

Then a line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when no
CUDA card is visible.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

OUT_DIR = Path("output/chip_smoke")
L = 2  # ops per sub-policy: one switcher call, one K2 and one K3 each


class Task(NamedTuple):
    name: str        # "optic", "rvs", "segformer" or a zoo config's name
    cfg: str         # the experiment file
    data: list       # overrides selecting the synthetic pools
    ref_size: int    # pool side of the crop-64 card == CPU references
    prefix: str      # of the launch-count paths and the log tags
    dataset: str     # "optic" or "rvs"
    # overrides of the search path and the profiled search step only: a
    # batch cut where the config's search step does not fit the card
    search_opts: tuple = ()
    # overrides naming the model, in every config the task loads
    model: tuple = ()
    # search epochs of the search path (after its one warmup epoch)
    search_epochs: int = 2
    # converter arch of the seeded source checkpoint the search and train
    # paths start from (TPU.PRETRAINED); "" for random weights
    pretrained: str = ""


# the flagship configs on the synthetic pools at each task's native
# resolution (the Fundus and RVS data are not in the repo)
OPTIC = Task("optic", "experiments/optic_sinkhorn/diversity.yaml",
             ["DATASET.NAME", "synthetic_optic", "TPU.SYNTHETIC_SIZE", "256"],
             64, "", "optic")
RVS = Task("rvs", "experiments/rvs_sinkhorn/diversity_ex.yaml",
           ["DATASET.NAME", "synthetic_rvs", "TPU.SYNTHETIC_SIZE", "512"],
           128, "rvs_", "rvs")
# the SegFormer (MiT-b4) config on the optic pools; its card == CPU
# references run the full depth at crop 64
SEGFORMER = Task("segformer", "experiments/zoo/segformer_b4_optic.yaml",
                 ["DATASET.NAME", "synthetic_optic", "TPU.SYNTHETIC_SIZE",
                  "256"], 64, "segformer_", "optic")
# the zoo's four other configs, each on its task's pools (rvs references
# from 128^2 pools, so scales below 1 run). FCN/UNet-S5-D16 applies its
# 512-channel FCN head at the full 256^2 crop: counted at 1.5 GiB kept per
# image for the backward pass (zoo_costs), its 144-image search step
# needs ~214 GiB. At TRAIN.BATCH_SIZE 2 (36 images, ~53 GiB counted, 63.1
# GiB peak) the step fit but took 47.9 s, 45.2 s of it in cuDNN's
# dgrad2d_grouped_direct_kernel (PERF.md), so its search runs at 1 (18
# images); its train step (24 images) runs at the config's own batch
# (their search paths at one search epoch, for the time the zoo's
# deeplabv3plus and pointrend cells and the sweep take)
PSPNET = Task("pspnet", "experiments/zoo/pspnet_r50_optic.yaml", OPTIC.data,
              64, "pspnet_", "optic", search_epochs=1)
LRASPP = Task("lraspp", "experiments/zoo/lraspp_mnv3_optic.yaml", OPTIC.data,
              64, "lraspp_", "optic", search_epochs=1)
OCRNET = Task("ocrnet", "experiments/zoo/ocrnet_hr18_rvs.yaml", RVS.data,
              128, "ocrnet_", "rvs", search_epochs=1)
FCN_UNET = Task("fcn_unet", "experiments/zoo/fcn_unet_rvs.yaml", RVS.data,
                128, "fcn_unet_", "rvs", ("TRAIN.BATCH_SIZE", "1"),
                search_epochs=1)
# the zoo's other architectures as cells on the PSPNet/ResNet-50 config:
# mmseg's DeepLabV3+/R50-D8 and PointRend (FPN, FPNHead, PointHead; its
# validation and test maps run the subdivision refine)
DEEPLABV3PLUS = Task("deeplabv3plus", PSPNET.cfg, OPTIC.data, 64,
                     "deeplabv3plus_", "optic",
                     model=("MODEL.NAME", "deeplabv3plus"))
POINTREND = Task("pointrend", PSPNET.cfg, OPTIC.data, 64, "pointrend_",
                 "optic", model=("MODEL.NAME", "pointrend"))
# mmseg's DeepLabV3+/S101-D8 (ResNeSt-101, split attention) starting from
# a seeded mmcv-named ResNeSt-101 checkpoint converted by the port's CLI.
# Counted at 743.2 MiB kept per image (zoo_costs), its 144-image search
# step would keep 104.5 GiB; the zoo cells peaked at 1.05-1.13x their
# count, so its search runs at the largest B that fits that way, 5 (90
# images, 65.3 GiB counted); its train step (24 images) at the config's 8
RESNEST = Task("resnest", PSPNET.cfg, OPTIC.data, 64, "resnest_", "optic",
               ("TRAIN.BATCH_SIZE", "5"),
               model=("MODEL.NAME", "deeplabv3plus", "MODEL.BACKBONE",
                      "resnest101"), pretrained="resnest101")
# the zoo's own Fast-SCNN architecture over its own backbone
FAST_SCNN = Task("fast_scnn", PSPNET.cfg, OPTIC.data, 64, "fast_scnn_",
                 "optic", model=("MODEL.NAME", "fast_scnn", "MODEL.BACKBONE",
                                 "fast_scnn"))
ZOO = (PSPNET, LRASPP, OCRNET, FCN_UNET, DEEPLABV3PLUS, POINTREND, RESNEST,
       FAST_SCNN)
# the zoo sweep: every architecture not driven as a cell over ResNetV1c-50,
# and the FCN over ResNetV1c-101, ResNeXt-50/101, HRNet-W32/48, ResNeSt-50
# and CGNet
SWEEP = tuple((a, "resnet50_v1c") for a in (
    "deeplabv3", "upernet", "sem_fpn", "nonlocal_net", "gcnet", "dnlnet",
    "ccnet", "annnet", "apcnet", "dmnet", "emanet", "danet", "psanet",
    "encnet", "fast_scnn")) + tuple(("fcn", b) for b in (
        "resnet101_v1c", "resnext50", "resnext101", "hrnet_w32", "hrnet_w48",
        "resnest50", "cgnet"))


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


def lut_timings(imgs: torch.Tensor, luts: torch.Tensor) -> dict:
    """K2 and K3 on (N, H, W, 3) images and (N, 3, 256) LUTs: each held
    exactly to its plain version, then timed beside it, one library call
    that computes the same function, and its byte bound."""
    from aadg_tpu_torch.ops import lut
    n, h, w, _ = imgs.shape
    dev = imgs.device
    hist = lut.hist3(imgs)
    torch.cuda.synchronize()
    if not torch.equal(hist, lut.hist3_plain(imgs)):
        raise AssertionError(f"hist3 kernel disagrees with its plain version "
                             f"at {n}x{h}x{w}x3")
    out = lut.lut_apply3(imgs, luts)
    torch.cuda.synchronize()
    if not torch.equal(out, lut.lut_apply3_plain(imgs, luts)):
        raise AssertionError(f"lut_apply3 kernel disagrees with its plain "
                             f"version at {n}x{h}x{w}x3")
    del hist, out
    vals = imgs.long().reshape(n, -1)
    chan = torch.arange(vals.shape[1], device=dev) % 3
    codes_hist = (torch.arange(n, device=dev)[:, None] * 768 + chan * 256
                  + vals).reshape(-1)
    codes_lut = (chan * 256 + vals).contiguous()
    del vals
    lut_flat = luts.reshape(n, 768)
    px = n * h * w * 3
    res = {}
    for name, kern, plain, lib, nbytes in (
            ("hist3", lambda: lut.hist3(imgs), lambda: lut.hist3_plain(imgs),
             lambda: torch.bincount(codes_hist, minlength=n * 768),
             4 * px + 4 * n * 768),
            ("lut_apply3", lambda: lut.lut_apply3(imgs, luts),
             lambda: lut.lut_apply3_plain(imgs, luts),
             lambda: torch.gather(lut_flat, 1, codes_lut),
             8 * px + 4 * n * 768)):
        b, by = bound_ms(nbytes, px)
        res[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                     "bound_ms": b, "bound_by": by,
                     "library_ms": time_ms(lib), "max_abs_err": 0.0,
                     "shape": [n, h, w, 3]}
    return res


def log_lut(tag: str, res: dict) -> None:
    for name, r in res.items():
        log(f"[kernels] {name} exact at {'x'.join(map(str, r['shape']))} "
            f"({tag}): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")


def rvs_slot_inputs(dev) -> list:
    """The (images, LUTs) that one full-width rvs search step hands K3 in
    each of its L slots (K2 gets the same images)."""
    from types import SimpleNamespace
    from aadg_tpu_torch.ops import augment, lut
    one = flagship_step(dev, "search", RVS)
    seen = []

    def recording(img, luts):
        seen.append((img, luts))
        return lut.lut_apply3(img, luts)
    # the switcher reaches the kernels through its module handle
    augment._lut = SimpleNamespace(hist3=lut.hist3, lut_apply3=recording)
    try:
        one()
    finally:
        augment._lut = lut
    torch.cuda.synchronize()
    if len(seen) != L:
        raise AssertionError(f"an rvs search step made {len(seen)} K3 calls")
    return seen


def phase_kernels(dev):
    from aadg_tpu_torch.ops import sinkhorn
    gen = torch.Generator(dev).manual_seed(0)
    rows = []

    # K2 / K3 at the slot shapes of the main paths: 144 images of 256^2
    # (optic) and 512^2 (rvs), uniform random values, and the rvs search
    # step's own images
    def uniform(side):
        return (torch.randint(0, 256, (144, side, side, 3), generator=gen,
                              device=dev).float(),
                torch.randint(0, 256, (144, 3, 256), generator=gen,
                              device=dev).float())
    optic = lut_timings(*uniform(256))
    log_lut("optic shape, uniform values", optic)
    rvs = {"uniform": lut_timings(*uniform(512))}
    log_lut("rvs shape, uniform values", rvs["uniform"])
    for i, (img, luts) in enumerate(rvs_slot_inputs(dev)):
        rvs[f"path_slot{i + 1}"] = lut_timings(img, luts)
        log_lut(f"rvs search step, slot {i + 1} inputs",
                rvs[f"path_slot{i + 1}"])
    for name, src, tpu in (
            ("hist3", "aadg_tpu_torch/csrc/hist3.cu",
             "aadg_tpu/ops/lut_pallas.py:79"),
            ("lut_apply3", "aadg_tpu_torch/csrc/lut_apply3.cu",
             "aadg_tpu/ops/lut_pallas.py:95")):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": 0, **optic[name],
                     "rvs_512": {k: v[name] for k, v in rvs.items()}})

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


def solve_operations(p: int, n: int, m: int, d: int, n_eps: int) -> int:
    """f32 operations of ``csrc/sinkhorn_solve.cu`` on ``p`` debiased
    divergences of n vs m points of d features with an epsilon schedule of
    ``n_eps`` values (each exp or log one operation, a multiply-add two):
    the rows' normalization (a sum of squares and a divide per feature);
    the xy, xx and yy costs (1 - a d-long dot product per entry); then
    ``n_eps`` Jacobi rounds and the two final half-steps, each round
    updating both potentials of the three problems: per cost entry a
    multiply, an add, a max, a subtract, an exp and a sum, and per row a
    log, an add, a multiply and the next offset's multiply and add."""
    entries = n * m + n * n + m * m
    rows = 2 * (n + m)                  # per round: both sides of 3 problems
    per_round = 2 * entries * 6 + rows * 5
    return p * ((n + m) * 3 * d + entries * (2 * d + 1)
                + (n_eps + 1) * per_round)


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
    ops = solve_operations(p, n, m, d, len(eps))
    n_bytes = 4 * (p * n * d + p * m * d + p)
    b, by = bound_ms(n_bytes, ops)
    row = {"name": "sinkhorn_solve", "route": "cuda",
           "source": "aadg_tpu_torch/csrc/sinkhorn_solve.cu",
           "replaces": "aadg_tpu/ops/sinkhorn_pallas.py:35",
           "launches": 0, "max_abs_err": max(
               c["max_abs_err"] for c in cases.values()),
           "ms": time_ms(solve), "plain_ms": time_ms(plain),
           "bound_ms": b, "bound_by": by, "library_ms": None,
           "bytes_bound_ms": bound_ms(n_bytes, 0)[0],
           "ops_bound_ms": ops / PEAK_F32_FLOP_PER_S * 1e3, "ops": ops,
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
        f"bound {b:.6f} by {by}: bytes {row['bytes_bound_ms']:.7f}, "
        f"operations {row['ops_bound_ms']:.7f} for {ops} f32 operations); "
        f"{row['limit_ms']:.4f} ms at the limit")
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


def _seeded_conv(sd: dict, key: str, weight, gen) -> None:
    sd[key] = torch.randn(tuple(weight.shape), generator=gen) * math.sqrt(
        2.0 / weight[0].numel())


def _seeded_bn(sd: dict, prefix: str, bn, gen) -> None:
    c = bn.weight.shape[0]
    sd[f"{prefix}.weight"] = torch.rand(c, generator=gen) + 0.5
    sd[f"{prefix}.bias"] = 0.1 * torch.randn(c, generator=gen)
    sd[f"{prefix}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
    sd[f"{prefix}.running_var"] = torch.rand(c, generator=gen) + 0.5
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def mmcv_resnest_state_dict(depth: int, seed: int) -> dict:
    """A seeded ResNeSt-``depth`` checkpoint in mmcv's naming (stem convs
    ``stem.{0,3,6}`` and BatchNorms ``stem.{1,4,7}``; ``layerS.B`` blocks
    of ``conv1``/``bn1``, the split attention ``conv2.{conv,bn0,fc1,bn1,
    fc2}`` with its fcs as 1x1 convs, ``conv3``/``bn3`` and the avg-down
    shortcut ``downsample.{1,2}``), at the port's ResNeSt shapes."""
    from aadg_tpu_torch.models.zoo.backbones import ResNeSt
    with torch.device("meta"):
        bb = ResNeSt(depth)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for i, ci in enumerate((0, 3, 6)):
        _seeded_conv(sd, f"stem.{ci}.weight", getattr(bb, f"stem{i}").weight,
                     gen)
        _seeded_bn(sd, f"stem.{ci + 1}", getattr(bb, f"stem_bn{i}"), gen)
    for s, n in enumerate(bb.stage_blocks):
        for b in range(n):
            blk, p = getattr(bb, f"layer{s + 1}_{b}"), f"layer{s + 1}.{b}"
            sac = blk.conv2
            _seeded_conv(sd, p + ".conv1.weight", blk.conv1.weight, gen)
            _seeded_bn(sd, p + ".bn1", blk.bn1, gen)
            _seeded_conv(sd, p + ".conv2.conv.weight", sac.conv.weight, gen)
            _seeded_bn(sd, p + ".conv2.bn0", sac.bn0, gen)
            for name, fc, bn in (("fc1", sac.fc1, sac.bn1),
                                 ("fc2", sac.fc2, None)):
                out, inp = fc.weight.shape
                sd[f"{p}.conv2.{name}.weight"] = torch.randn(
                    out, inp, 1, 1, generator=gen) / math.sqrt(inp)
                sd[f"{p}.conv2.{name}.bias"] = 0.1 * torch.randn(
                    out, generator=gen)
                if bn is not None:
                    _seeded_bn(sd, p + ".conv2.bn1", bn, gen)
            _seeded_conv(sd, p + ".conv3.weight", blk.conv3.weight, gen)
            _seeded_bn(sd, p + ".bn3", blk.bn3, gen)
            if blk.down:
                _seeded_conv(sd, p + ".downsample.1.weight",
                             blk.down_conv.weight, gen)
                _seeded_bn(sd, p + ".downsample.2", blk.down_bn, gen)
    return sd


def torchvision_mobilenet_v2_state_dict(seed: int) -> dict:
    """A seeded MobileNetV2 checkpoint in torchvision's naming
    (``features.0`` and ``features.18`` ConvBNReLUs, ``features.N.conv``
    inverted residuals, the classifier the converter skips), at the port
    encoder's shapes."""
    from aadg_tpu_torch.models.mobilenetv2 import MobileNetV2Encoder
    with torch.device("meta"):
        enc = MobileNetV2Encoder()
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv_bn(prefix, m):
        _seeded_conv(sd, f"{prefix}.0.weight", m.Conv_0.weight, gen)
        _seeded_bn(sd, f"{prefix}.1", m.BatchNorm_0, gen)
    conv_bn("features.0", enc.ConvBNReLU6_0)
    for i, name in enumerate(enc.blocks):
        blk, p = getattr(enc, name), f"features.{i + 1}.conv"
        j = 0
        if blk.expand:
            conv_bn(f"{p}.0", blk.ConvBNReLU6_0)
            j = 1
        conv_bn(f"{p}.{j}", getattr(blk, blk.dw_name))
        _seeded_conv(sd, f"{p}.{j + 1}.weight", blk.Conv_0.weight, gen)
        _seeded_bn(sd, f"{p}.{j + 2}", blk.BatchNorm_0, gen)
    conv_bn(f"features.{len(enc.blocks) + 1}", enc.ConvBNReLU6_1)
    sd["classifier.1.weight"] = 0.01 * torch.randn(1000, 1280, generator=gen)
    sd["classifier.1.bias"] = torch.zeros(1000)
    return sd


SOURCES = {"resnest101": lambda: {
               "state_dict": {f"backbone.{k}": v for k, v in
                              mmcv_resnest_state_dict(101, 11).items()},
               "meta": {"seed": 11}},
           "mobilenet_v2": lambda: torchvision_mobilenet_v2_state_dict(12)}


def pretrained_file(arch: str, tmp: Path) -> str:
    """Write the seeded source checkpoint ``SOURCES[arch]`` to ``tmp`` and
    convert it with ``python -m aadg_tpu_torch.convert_weights``; the
    converted file's path."""
    src, dst = tmp / f"{arch}.pth", tmp / f"{arch}.pt"
    torch.save(SOURCES[arch](), src)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "aadg_tpu_torch.convert_weights", "--arch",
         arch, str(src), str(dst)], capture_output=True, text=True,
        timeout=600, check=True)
    n = len(torch.load(dst, map_location="cpu", weights_only=True))
    log(f"[pretrained] {arch}: seeded source checkpoint of "
        f"{src.stat().st_size / 2**20:.1f} MiB converted in "
        f"{time.perf_counter() - t0:.1f} s to {n} tensors "
        f"({out.stdout.strip()})")
    return str(dst)


@contextlib.contextmanager
def starts_from(path: str, tag: str):
    """With ``path`` (``TPU.PRETRAINED``), the run in the block must start
    from it: the weights of the module it is grafted into, as ``init_state``
    leaves them, must equal the file's."""
    if not path:
        yield
        return
    from aadg_tpu_torch.engine import search, state, train
    from aadg_tpu_torch.utils.pretrained import find_graft_point
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    seen = []

    def spy(ent, seed, pretrained="", logger=None):
        sd, cs = state.init_state(ent, seed, pretrained, logger)
        at = find_graft_point(sd.model, loaded)
        module = sd.model.get_submodule(".".join(at))
        seen.append((at, {k: v.detach().to("cpu", copy=True)
                          for k, v in module.state_dict().items()}))
        return sd, cs
    saved = search.init_state, train.init_state
    search.init_state = train.init_state = spy
    try:
        yield
    finally:
        search.init_state, train.init_state = saved
    if len(seen) != 1:
        raise AssertionError(f"{tag}: init_state ran {len(seen)} times")
    at, got = seen[0]
    differ = [k for k, v in loaded.items() if not torch.equal(got[k], v)]
    if differ:
        raise AssertionError(f"{tag}: {len(differ)} tensors at step 0 differ "
                             f"from {path}, e.g. {differ[:3]}")
    log(f"{tag} TPU.PRETRAINED: the model's {'/'.join(at)} at step 0 equals "
        f"the converted file ({len(loaded)} tensors)")


def reference_batch(task: Task):
    """One image per domain of the task's synthetic pools at
    ``task.ref_size``^2, as a (1, 3, S, S, 3) batch."""
    from aadg_tpu_torch.data.datasets import SyntheticDataset
    ds = SyntheticDataset(task.dataset, n_per_domain=1,
                          size=task.ref_size)
    imgs = torch.stack([torch.from_numpy(d.images[0]) for d in ds.domains])
    masks = torch.stack([torch.from_numpy(d.labels[0]) for d in ds.domains])
    return (imgs[None].float(), masks[None].float(), torch.arange(3)[None])


def to_device(draws, device):
    """A step's draws or batch (tuples and NamedTuples of tensors, nested,
    None where a model draws nothing) on ``device``."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    moved = [to_device(d, device) for d in draws]
    return type(draws)(*moved) if hasattr(draws, "_fields") else tuple(moved)


def reference_cfg(task: Task, extra=()):
    from aadg_tpu_torch.config import load_config
    return load_config(task.cfg, [
        "DATASET.NAME", task.data[1], *task.model, "TPU.CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "1", "TPU.COMPUTE_DTYPE", "float32", *extra])


def phase_reference(dev, task: Task):
    """One search step on the card and on the CPU from the same state."""
    from aadg_tpu_torch.engine import state, steps
    cfg = reference_cfg(task, ["CONTROLLER.M", "2"])
    batch = reference_batch(task)
    s = task.ref_size
    pol = torch.randint(0, 10, (2, 5, 2, 2),
                        generator=torch.Generator().manual_seed(1))
    ent_cpu = state.build_entities(cfg, "search", 1, "cpu")
    draws = steps.draw_search(ent_cpu, 3, 2, s, s,
                              torch.Generator().manual_seed(2))
    results = {}
    for device in ("cpu", dev):
        ent = state.build_entities(cfg, "search", 1, device)
        sd, _ = state.init_state(ent, 0)
        ms, r = steps.make_search_step(ent, 2)(
            sd, to_device(batch, device), pol.to(device),
            to_device(draws, device))
        results[str(device)] = ({k: float(v) for k, v in ms.items()},
                                r.cpu())
    (m_cpu, r_cpu), (m_gpu, r_gpu) = results["cpu"], results[str(dev)]
    for k in ("seg_loss", "dis_loss"):
        if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4):
            raise AssertionError(f"{task.name} {k}: card {m_gpu[k]} vs cpu "
                                 f"{m_cpu[k]}")
    torch.testing.assert_close(r_gpu, r_cpu, rtol=1e-3, atol=1e-6)
    scales = torch.cat([draws.crop.sw, draws.crop.sh])
    log(f"[{task.prefix}reference] search step at crop 64 from {s}^2 pools "
        f"(scales {scales.min():.3f}-{scales.max():.3f}): card == cpu "
        f"(seg_loss {m_gpu['seg_loss']:.6f} vs {m_cpu['seg_loss']:.6f}, "
        f"rewards {r_gpu.tolist()} vs {r_cpu.tolist()})")


def launch_counters() -> dict:
    from aadg_tpu_torch.ops import lut, sinkhorn
    return {"hist3": lut.hist3, "lut_apply3": lut.lut_apply3,
            "softmin": sinkhorn.softmin,
            "sinkhorn_solve": sinkhorn.sinkhorn_solve}


def drive(task: Task, flags, opts=(), weights: str = "", tag: str = ""):
    """``python -m aadg_tpu_torch.run <flags> KEY VALUE ...`` in process,
    on the card, at full width, with every launch counter set to 0 just
    before; with ``weights``, as ``TPU.PRETRAINED``, checked to be the
    model's start (``starts_from``). Returns (its result, the launches it
    made)."""
    from aadg_tpu_torch import run
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with starts_from(weights, tag):
        out = run.main(["--cfg", task.cfg, "--output_dir", str(OUT_DIR),
                        *flags, *task.data, *task.model, "LOG_DIR",
                        str(OUT_DIR / "log"), *opts,
                        *(("TPU.PRETRAINED", weights) if weights else ())])
    return out, {k: fn.launches for k, fn in counters.items()}


def check_launches(path: str, launches: dict, expect: dict) -> None:
    """``expect``: the exact launch count of every kernel on ``path``."""
    for k, v in launches.items():
        if v != expect[k]:
            raise AssertionError(f"kernel {k} launched {v} times on the "
                                 f"{path} path, expected {expect[k]}")


def check_epochs(summary) -> None:
    for e in summary["epochs"]:
        vals = (list(e["metrics"].values()) + list(e["valid"].values())
                + e.get("rewards", [])
                + [x for r in e.get("raw_rewards", []) for x in r]
                + list(e.get("controller", {}).values()))
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite values in epoch {e}")


def check_final_result(run_dir: str, task: Task, with_hd: bool) -> dict:
    """The task's keys of final_result.json in range: scores in [0, 1],
    hd95 in [0, the pool images' diagonal] (100 is only the penalty for an
    empty mask; a mask far from its target measures more)."""
    res = json.loads((Path(run_dir) / "final_result.json").read_text())
    if task.dataset == "optic":
        keys = ["avg_dsc", "cup_dsc", "disc_dsc"] + (
            ["avg_hd", "cup_hd", "disc_hd"] if with_hd else [])
    else:
        keys = ["dsc", "acc", "aucroc", "sp", "se"]
    side = int(task.data[task.data.index("TPU.SYNTHETIC_SIZE") + 1])
    for k in keys:
        top = math.sqrt(2.0) * side if k.endswith("hd") else 1.0
        if not (math.isfinite(res[k]) and 0.0 <= res[k] <= top):
            raise AssertionError(f"final_result.json {k} = {res[k]}")
    return res


def epoch_costs(summary) -> str:
    """Validation and checkpoint ms per epoch: the checkpoint's time in the
    loop (the host copy) and its writer thread's own time."""
    ck = [e for e in summary["epochs"] if "checkpoint_seconds" in e]
    return ("validation ms " + str([round(e["valid_seconds"] * 1e3, 1)
                                    for e in summary["epochs"]])
            + ", checkpoint ms in the loop " + str([
                round(e["checkpoint_seconds"] * 1e3, 1) for e in ck])
            + ", on the writer thread " + str([
                round(e["checkpoint_write_seconds"] * 1e3, 1) for e in ck]))


def phase_search_path(dev, task: Task, weights: str = "",
                      path: str = ""):
    """``--mode search`` of ``task`` (from ``weights`` if given); its
    launches are those of path ``path`` (default: the task's search)."""
    from aadg_tpu_torch.utils.checkpoint import load_checkpoint
    path = path or task.prefix + "search"
    tag = f"[{path} path]"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    summary, launches = drive(
        task, ["--mode", "search"], ["TRAIN.WARMUP_EPOCH", "1",
                                     "TRAIN.END_EPOCH",
                                     str(1 + task.search_epochs),
                                     "TPU.STEPS_PER_EPOCH", "2",
                                     *task.search_opts], weights, tag)
    wall = time.perf_counter() - t0
    n_steps = len(summary["search_step_seconds"])
    check_launches(path, launches, {
        "sinkhorn_solve": n_steps, "softmin": 0, "hist3": L * n_steps,
        "lut_apply3": L * n_steps})
    check_epochs(summary)
    res = check_final_result(summary["out_dir"], task, with_hd=True)
    ctrl = load_checkpoint(str(Path(summary["out_dir"])
                               / "final_controller_state.pt"))["controller"]
    if not all(torch.isfinite(v).all() for v in ctrl.values()):
        raise AssertionError("final_controller_state.pt is not finite")
    steps = summary["search_step_seconds"]
    imgs = summary["images_per_search_step"]
    med = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    cut = (f" [cut: {' '.join(task.search_opts)}]"
           if task.search_opts else "")
    log(f"{tag} run_search ({task.name}{cut}): {len(summary['epochs'])} "
        f"epochs "
        f"in {wall:.1f} s; search step median {med * 1e3:.1f} ms over "
        f"{len(steps)} steps ({imgs} images, {imgs / med:.1f} img/s; "
        f"steps {[round(s * 1e3, 1) for s in steps]} ms); peak memory "
        f"{peak:.2f} GiB; launches {launches}")
    log(f"{tag} validation every epoch ({epoch_costs(summary)}); "
        f"last {summary['epochs'][-1]['valid']}; final_result.json {res}; "
        f"final_controller_state.pt loads ({len(ctrl)} tensors)")
    return launches, summary["out_dir"]


def phase_train_path(dev, task: Task, search_dir: str, weights: str = ""):
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    summary, launches = drive(
        task, ["--mode", "train"], ["TPU.AUTOAUGMENT", "True",
                                    "TEST.MODEL_DIR", search_dir,
                                    "TRAIN.END_EPOCH", "2",
                                    "TPU.STEPS_PER_EPOCH", "3"], weights,
        f"[{task.prefix}train path]")
    wall = time.perf_counter() - t0
    steps = summary["train_step_seconds"]
    check_launches(task.prefix + "train", launches, {
        "sinkhorn_solve": 0, "softmin": 0, "hist3": L * len(steps),
        "lut_apply3": L * len(steps)})
    check_epochs(summary)
    res = check_final_result(summary["out_dir"], task, with_hd=False)
    text = (Path(summary["out_dir"]) / "train.log").read_text()
    if "autoaugment: loaded controller" not in text:
        raise AssertionError("the train run did not load the searched "
                             "controller")
    imgs = summary["images_per_train_step"]
    med = statistics.median(steps)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"[{task.prefix}train path] run_train ({task.name}, autoaugment): "
        f"{len(summary['epochs'])} epochs in {wall:.1f} s; train step "
        f"median {med * 1e3:.1f} ms over {len(steps)} steps ({imgs} images, "
        f"{imgs / med:.1f} img/s; steps {[round(s * 1e3, 1) for s in steps]}"
        f" ms); peak memory {peak:.2f} GiB; launches {launches}; "
        f"{epoch_costs(summary)}; final_result.json {res}")
    return launches, summary["out_dir"]


def phase_train_reference(dev, task: Task):
    """One autoaugment train step on the card and on the CPU from the same
    state, batch, policy and draws, for each outcome of the coin."""
    from aadg_tpu_torch.engine import state, steps
    cfg = reference_cfg(task)
    batch = reference_batch(task)
    s = task.ref_size
    pol = torch.randint(0, 10, (1, 5, 2, 2),
                        generator=torch.Generator().manual_seed(1))
    pol[0, :, 0, 0] = torch.tensor([0, 2, 0, 2, 0])  # AutoContrast, Equalize
    ent_cpu = state.build_entities(cfg, "train", 1, "cpu")
    draws = steps.draw_train(ent_cpu, 3, s, s,
                             torch.Generator().manual_seed(2))
    for coin in (0.75, 0.25):
        results = {}
        for device in ("cpu", dev):
            ent = state.build_entities(cfg, "train", 1, device)
            sd, _ = state.init_state(ent, 0)
            d = to_device(draws._replace(coin=torch.tensor(coin)), device)
            ms = steps.make_autoaug_train_step(ent)(
                sd, to_device(batch, device), pol.to(device), d)
            results[str(device)] = {k: float(v) for k, v in ms.items()}
        m_cpu, m_gpu = results["cpu"], results[str(dev)]
        if not math.isclose(m_gpu["seg_loss"], m_cpu["seg_loss"],
                            rel_tol=1e-4):
            raise AssertionError(f"{task.name} coin {coin}: seg_loss card "
                                 f"{m_gpu['seg_loss']} vs cpu "
                                 f"{m_cpu['seg_loss']}")
        dice = lambda m: "/".join(f"{v:.4f}" for k, v in m.items()
                                  if k.endswith("dsc"))
        log(f"[{task.prefix}train reference] autoaugment train step at crop "
            f"64 from {s}^2 pools, coin {coin} "
            f"({'augmented' if coin > 0.5 else 'raw'} batch): card == cpu "
            f"within rtol 1e-4 (seg_loss {m_gpu['seg_loss']:.6f} vs "
            f"{m_cpu['seg_loss']:.6f}; dice card {dice(m_gpu)}, cpu "
            f"{dice(m_cpu)})")


def phase_test_path(task: Task, train_dir: str, search_dir: str):
    seg_dir = OUT_DIR / f"{task.name}_vis_seg"
    img_dir = OUT_DIR / f"{task.name}_vis_image"
    for d in (seg_dir, img_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    table, seg_launches = drive(
        task, ["--mode", "test", "--output_type", "seg", "--vis_dir",
               str(seg_dir)], ["TEST.MODEL_DIR", train_dir])
    t_seg = time.perf_counter() - t0
    res, img_launches = drive(
        task, ["--mode", "test", "--output_type", "image", "--vis_dir",
               str(img_dir)], ["TEST.MODEL_DIR", search_dir])
    wall = time.perf_counter() - t0
    launches = {k: seg_launches[k] + img_launches[k] for k in seg_launches}
    check_launches(task.prefix + "test", launches, {
        "sinkhorn_solve": 0, "softmin": 0, "hist3": L, "lut_apply3": L})
    maps = sorted(p.name for p in seg_dir.glob("*.png"))
    if maps != sorted(table["name"]) or len(maps) != 4 or not (
            seg_dir / "test_result.csv").exists():
        raise AssertionError(f"test seg wrote {sorted(seg_dir.iterdir())}")
    f1 = [v for k, vs in table.items() if k != "name" for v in vs]
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in f1):
        raise AssertionError(f"test seg F1 {table}")
    n_img = len(list(img_dir.glob("sample*.png")))
    if res != {"n_images": 32} or n_img != 32:
        raise AssertionError(f"test image wrote {n_img} images ({res})")
    log(f"[{task.prefix}test path] seg ({task.name}): 4 PNG maps + "
        f"test_result.csv with {list(table)} in {t_seg:.1f} s (F1 "
        f"{[round(v, 4) for v in table[list(table)[1]]]}); image: 32 "
        f"augmented PNGs; {wall:.1f} s in all; launches {launches}")
    return launches


_CATEGORIES = (  # first match wins; kernel names lower-cased
    ("sinkhorn_solve", ("sinkhorn_solve_kernel",)),
    ("K1 softmin", ("softmin_kernel",)),
    ("K2 hist3", ("hist3_kernel",)),
    ("K3 lut_apply3", ("lut_apply3_kernel",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("layer norm", ("layer_norm", "layernorm", "gammabeta")),
    ("softmax", ("softmax",)),
    ("gelu", ("gelu",)),
    # cuDNN's implicit-GEMM convolutions before cuBLAS's sm80_xmma_gemm
    ("convolution", ("conv", "implicit", "fprop", "wgrad", "dgrad", "cudnn",
                     "nhwc", "nchw", "depthwise")),
    ("matmul", ("gemm", "cutlass", "cublas", "sm90_", "xmma")),
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


def flagship_step(dev, kind: str, task: Task, opts=(), store=None):
    """A closure running one full-width step of ``kind`` ("search": M=6
    policies, rewards; "train": the autoaugment train step) of ``task``
    (with the config overrides ``opts``) with its batch and draws, as the
    run loops run it, and returning the step's result; its ``sd`` is the
    state it steps. ``store``: the train store to draw from, else built
    from the config."""
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.data.datasets import build_dataset, load_train_arrays
    from aadg_tpu_torch.data.stores import (draw_batch_indices, gather_batch,
                                            make_train_store)
    from aadg_tpu_torch.engine import state, steps as steps_mod
    from aadg_tpu_torch.models.controller import policies_to_tensor
    cfg = load_config(task.cfg, [*task.data, *task.model, *opts])
    if store is None:
        store = make_train_store(
            *load_train_arrays(build_dataset(cfg, "train")), dev)
    ent = state.build_entities(cfg, kind, 2, dev)
    sd, cs = state.init_state(ent, 0)
    gen = torch.Generator(dev).manual_seed(0)
    b = int(cfg.TRAIN.BATCH_SIZE)
    n0, (h, w) = b * store.n_domains, store.images.shape[2:4]
    m = int(cfg.CONTROLLER.M) if kind == "search" else 1
    with torch.no_grad():
        pol = policies_to_tensor(cs.controller.sample(m, gen)[0],
                                 ent.ctrl_spec)
    if kind == "search":
        step = steps_mod.make_search_step(ent, m)
        draw = lambda: steps_mod.draw_search(ent, n0, m, h, w, gen)
    else:
        step = steps_mod.make_autoaug_train_step(ent)
        draw = lambda: steps_mod.draw_train(ent, n0, h, w, gen)

    def one():
        raw = gather_batch(store, draw_batch_indices(store, b, gen))
        return step(sd, raw, pol, draw())
    one.sd = sd
    return one


def phase_profile(dev, kind: str, task: Task, steps: int = 3):
    """For one flagship step of ``kind``: two warm-up steps, then one step
    under torch.cuda.set_sync_debug_mode("error") (a synchronizing call
    raises), then ``steps`` steps under torch.profiler: the device time by
    kernel category, the device's idle share (1 - kernel time / wall
    time), the host and device time of each stage, and the stream
    synchronizations and host-to-device copies per step."""
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    one = flagship_step(dev, kind, task,
                        task.search_opts if kind == "search" else ())
    tag = f"[{task.prefix}profile] {kind} step"
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{tag}: a warmed step made no synchronizing call under "
        "set_sync_debug_mode('error')")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prefix = kind + "/"
    per_cat, per_kernel, stages = {}, {}, {}
    for evt in prof.key_averages():
        if evt.key.startswith(prefix):
            # the step's stage ranges: host time on the CPU row, the span of
            # the stage's kernels on the device row
            on_device = evt.device_type == torch.autograd.DeviceType.CUDA
            us = (max(getattr(evt, "self_device_time_total", 0.0),
                      getattr(evt, "device_time_total", 0.0)) if on_device
                  else evt.cpu_time_total)
            stages.setdefault(evt.key[len(prefix):], {})[
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
    syncs = sync_counts(prof, steps, prefix + "rewards")
    cats = sorted(per_cat.items(), key=lambda kv: -kv[1])
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"{tag}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}, peak memory "
        f"{peak:.2f} GiB; by category (ms/step): "
        + ", ".join(f"{k} {v:.2f}" for k, v in cats))
    log(f"{tag} top kernels (ms/step): " + "; ".join(
        f"{k[:70]} {v:.2f}" for k, v in top))
    log(f"{tag} stages (host ms / device-span ms per step): "
        + ", ".join(f"{k} {v.get('host_ms', 0.0):.2f}/"
                    f"{v.get('device_ms', 0.0):.2f}"
                    for k, v in stages.items()))
    log(f"{tag} per step: " + ", ".join(
        f"{k} {v:g}" for k, v in syncs.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy, "categories": dict(cats),
            "stages": stages, "syncs": syncs, "peak_gib": peak}


def sync_counts(prof, steps: int, rewards_range: str) -> dict:
    """cudaStreamSynchronize calls and host-to-device copies per step, and
    the synchronizing or copying runtime calls issued inside the host
    ranges named ``rewards_range`` (the search step's rewards stage)."""
    events = prof.events()
    rewards = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == rewards_range
               and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"cudaStreamSynchronize": 0, "Memcpy HtoD": 0}
    if rewards:
        out.update({"in rewards: cudaStreamSynchronize": 0,
                    "in rewards: cudaMemcpyAsync": 0})
    for e in events:
        if e.name == "cudaStreamSynchronize":
            out["cudaStreamSynchronize"] += 1
        elif e.name.startswith("Memcpy HtoD"):
            out["Memcpy HtoD"] += 1
        if e.name in ("cudaStreamSynchronize", "cudaMemcpyAsync") and any(
                lo <= e.time_range.start <= hi for lo, hi in rewards):
            out["in rewards: " + e.name] += 1
    return {k: v / steps for k, v in out.items()}


def segformer_costs(device, variant: str = "mit_b4", crop: int = 256,
                    rate: float = 0.1) -> dict:
    """Counts of one train-mode forward of SegFormer ``variant`` (2
    classes) on one crop^2 image, run on ``device``: the parameters; the
    f32 operations of its matmuls and convolutions (torch's
    FlopCounterMode, 2 per multiply-add; normalisations, activations and
    softmax not counted), in all and inside the MiT blocks; and the bytes
    autograd keeps for the backward pass (each saved storage once,
    parameters excluded), without remat every saved tensor, with remat
    those saved outside the blocks plus each block's input. A step's
    forward + backward is taken as 3 forwards (the backward of a matmul or
    convolution is two of its forward; the counter prices a grouped
    convolution's backward as a dense one), and remat adds the blocks'
    forward once more."""
    import re
    from torch.utils.flop_counter import FlopCounterMode
    from aadg_tpu_torch.models import segformer as sf
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = sf.SegFormer(2, variant, rate, remat).to(device).train()
        params = {p.untyped_storage().data_ptr() for p in model.parameters()}
        gen = torch.Generator(device).manual_seed(0)
        x = torch.randn(1, crop, crop, 3, generator=gen, device=device)
        drop = sf.draw_dropout(variant, rate, crop, crop, 1, gen)
        saved, inputs = {}, []

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in params:
                saved[ptr] = t.untyped_storage().nbytes()
            return t
        hooks = [m.register_forward_pre_hook(
            lambda m, args: inputs.append(args[0].nbytes))
            for m in model.modules() if isinstance(m, sf.Block)]
        with FlopCounterMode(display=False) as counter:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                model(x, drop)
        for h in hooks:
            h.remove()
        tag = "remat" if remat else "no_remat"
        out[f"saved_bytes_{tag}"] = sum(saved.values()) + (
            sum(inputs) if remat else 0)
    out["params"] = sum(p.numel() for p in model.parameters())
    out["fwd_flop"] = counter.get_total_flops()
    out["blocks_fwd_flop"] = sum(
        sum(v.values()) for k, v in counter.get_flop_counts().items()
        if re.fullmatch(r".*\.backbone\.block\d+_\d+", k))
    out["step_flop_no_remat"] = 3 * out["fwd_flop"]
    out["step_flop_remat"] = 3 * out["fwd_flop"] + out["blocks_fwd_flop"]
    return out


def zoo_costs(task: Task, crop: int = 256, opts=()) -> dict:
    """Counts of one train-mode forward of ``task``'s zoo segmentor on a
    crop^2 image, on the meta device (shapes only, nothing computed): the
    parameters; the f32 operations of its matmuls and convolutions (torch's
    FlopCounterMode, 2 per multiply-add); the bytes autograd keeps for the
    backward pass (each saved storage once, parameters excluded; the
    dropout masks included). Counted over 2 images, since a train-mode
    BatchNorm needs more than one value per channel (PSP's 1x1 pool), and
    halved. A step's forward + backward is taken as 3 forwards. ``opts``:
    config overrides after the task's."""
    from torch.utils.flop_counter import FlopCounterMode
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.models import build_model, class_parser
    from aadg_tpu_torch.models.zoo import builder
    cfg = load_config(task.cfg, [*task.data, *task.model, *opts])
    with torch.device("meta"):
        model = build_model(cfg, class_parser(task.dataset))
    model.train()
    params = {p.untyped_storage()._cdata for p in model.parameters()}
    masks = tuple(torch.ones((2, *shape), dtype=torch.bool, device="meta")
                  for shape, _ in builder.dropout_shapes(
                      cfg.MODEL.NAME, cfg.MODEL.BACKBONE, crop))
    saved = {}

    def pack(t):
        key = t.untyped_storage()._cdata
        if key not in params:
            saved[key] = t.untyped_storage().nbytes()
        return t
    with FlopCounterMode(display=False) as counter:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(torch.zeros(2, crop, crop, 3, device="meta"), masks)
    return {"params": sum(p.numel() for p in model.parameters()),
            "fwd_flop": counter.get_total_flops() / 2,
            "saved_bytes": sum(saved.values()) / 2,
            "batch": int(cfg.TRAIN.BATCH_SIZE), "M": int(cfg.CONTROLLER.M)}


def phase_zoo_costs() -> dict:
    """``zoo_costs`` of each zoo task, and what a search step of the
    config's batch (B x 3 domains x M images) would keep for its backward
    pass, beside the batch the run uses."""
    out = {}
    for task in ZOO:
        c = zoo_costs(task)
        n = c["batch"] * 3 * c["M"]
        run_b = (int(task.search_opts[task.search_opts.index(
            "TRAIN.BATCH_SIZE") + 1]) if task.search_opts else c["batch"])
        out[task.name] = c
        log(f"[zoo costs] {task.name} ({task.cfg}) per 256^2 image: "
            f"{c['params']} parameters, forward {c['fwd_flop'] / 1e9:.3f} "
            f"GFLOP, saved for the backward {c['saved_bytes'] / 2**20:.1f} "
            f"MiB; search step of {n} images: "
            f"{3 * n * c['fwd_flop'] / 1e12:.2f} TFLOP, {n * c['saved_bytes'] / 2**30:.1f} GiB kept; run at "
            f"TRAIN.BATCH_SIZE {run_b} ({run_b * 3 * c['M']} images, "
            f"{run_b * 3 * c['M'] * c['saved_bytes'] / 2**30:.1f} GiB)")
    return out


def phase_zoo_sweep(dev) -> dict:
    """Each (arch, backbone) of ``SWEEP`` on the PSPNet/ResNet-50 config
    at full width on the optic pools: its counted costs (``zoo_costs``), a
    warm-up and two timed search steps at B=8 per domain or the largest B
    that fits (one less after each torch.cuda.OutOfMemoryError of the
    step, which only this phase catches), the peak memory, whether the losses, the rewards and an
    eval forward of 24 images are finite, and the kernels' launches,
    which must be those of the cells' search steps (one sinkhorn_solve,
    L K2 and L K3 per step; the eval forward none). One line per entry."""
    from aadg_tpu_torch.config import load_config
    from aadg_tpu_torch.data.datasets import build_dataset, load_train_arrays
    from aadg_tpu_torch.data.stores import make_train_store
    cfg = load_config(PSPNET.cfg, PSPNET.data)
    store = make_train_store(*load_train_arrays(build_dataset(cfg, "train")),
                             dev)
    x_eval = torch.randn(24, 256, 256, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(5))
    counters = launch_counters()
    out = {}
    for arch, bb in SWEEP:
        t_entry = time.perf_counter()
        model_opts = ("MODEL.NAME", arch, "MODEL.BACKBONE", bb)
        costs = zoo_costs(PSPNET, opts=model_opts)
        b, tried = 8, []
        while True:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            for fn in counters.values():
                fn.launches = 0
            one = None
            try:
                one = flagship_step(dev, "search", PSPNET,
                                    (*model_opts, "TRAIN.BATCH_SIZE", str(b)),
                                    store)
                results = [one()]
                times = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    results.append(one())
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                break
            except torch.cuda.OutOfMemoryError:
                tried.append(b)
                one = None
                if b == 1:
                    raise
                b -= 1
        model = one.sd.model.eval()
        with torch.no_grad():
            logits, feat = model(x_eval)
        launches = {k: fn.launches for k, fn in counters.items()}
        check_launches(f"sweep {arch}/{bb}", launches, {
            "sinkhorn_solve": 3, "softmin": 0, "hist3": 3 * L,
            "lut_apply3": 3 * L})
        losses = [float(v) for m, _ in results for v in m.values()]
        rewards = torch.cat([r for _, r in results]).tolist()
        finite = {"losses": all(math.isfinite(v) for v in losses),
                  "rewards": all(math.isfinite(v) for v in rewards),
                  "eval": bool(torch.isfinite(logits).all()
                               and torch.isfinite(feat).all())}
        if not all(finite.values()) or tuple(logits.shape) != (
                24, 256, 256, 2):
            raise AssertionError(f"sweep {arch}/{bb}: finite {finite}, "
                                 f"eval logits {tuple(logits.shape)}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        n = b * 3 * costs["M"]
        med = statistics.median(times)
        out[f"sweep_{arch}_{bb}"] = {
            "batch": b, "oom_at": tried, "steps_ms": times,
            "median_ms": med, "peak_gib": peak, "launches": launches,
            "counted_gib": n * costs["saved_bytes"] / 2 ** 30,
            "tflop": 3 * n * costs["fwd_flop"] / 1e12, **finite}
        log(f"[zoo sweep] {arch} / {bb}: B={b}"
            + (f" (out of memory at B={tried})" if tried else "")
            + f", {n} images; search steps {[round(t, 1) for t in times]} ms"
            f" ({n / med * 1e3:.1f} img/s, {3 * n * costs['fwd_flop'] / 1e12:.2f}"
            f" TFLOP counted, {3 * n * costs['fwd_flop'] / med / 1e9:.1f} "
            f"TFLOP/s); peak memory {peak:.2f} GiB (counted "
            f"{n * costs['saved_bytes'] / 2 ** 30:.1f} GiB kept); finite "
            f"losses {finite['losses']}, rewards {finite['rewards']}, eval "
            f"forward of 24 images {finite['eval']}; launches {launches}; "
            f"{time.perf_counter() - t_entry:.1f} s")
        del one, model, logits, feat, results
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_learning(dev) -> dict:
    """The learning proof on the card (``aadg_tpu_torch.prove_learning``, the
    recipes of tests/test_learning.py): the calibration landscape on the
    warmed testbed, held to its three inequalities; then the 4-op search
    of 150 epochs, whose numbers must be finite and complete. Its four
    thresholds (reward rise, the two convergence bounds, learned > 1.2 x
    random) are printed met or missed beside the open fault that records
    their miss at this recipe and seed (ROADMAP queue 3), and the
    converged op beside the final landscape's argmax; the gpu tests of
    tests/test_torch_port_learning.py assert them."""
    from aadg_tpu_torch import prove_learning as pl
    t0 = time.perf_counter()
    cfg = pl.testbed_config(warmup=3, steps=3, batch=4, M=4,
                            out_dir=str(OUT_DIR / "learning_calibration"))
    names, _, r = pl.measure_op_mag_rewards(cfg, mag_indices=(0, 9),
                                            n_batches=3, device=dev)
    idx = {n: i for i, n in enumerate(names)}
    color_lo, color_hi = r[idx["Color"]]
    log(f"[learning] calibration (warmup 3 x 3 steps, B=4, M=4, mag 0 / 9, "
        f"3 batches, {time.perf_counter() - t0:.1f} s): " + ", ".join(
            f"{n} {r[i, 0]:.4f}/{r[i, 1]:.4f}" for i, n in enumerate(names)))
    others = max(r[idx[n]].max() for n in names if n != "Color")
    if not (math.isfinite(float(r.sum())) and color_hi == r.max()
            and color_hi > 2 * color_lo and color_hi > 2 * others):
        raise AssertionError(f"calibration: Color@1.9 {color_hi} must top the "
                             f"landscape, beat 2x Color@0.1 {color_lo} and "
                             f"2x every other op's best {others}")
    t1 = time.perf_counter()
    cfg = pl.testbed_config(end_epoch=150, warmup=30, steps=2, batch=4, M=8,
                            out_dir=str(OUT_DIR / "learning"))
    res = pl.run_proof(cfg, pl.TESTBED_SPACE, tail=10, device=dev)
    series = res["reward_series"]
    values = pl.thresholds(res)
    met = pl.met(values)
    third = len(series) // 3
    early, late = sum(series[:third]) / third, sum(series[-third:]) / third
    log(f"[learning] 4-op proof (150 epochs, 30 warmup, 2 steps, B=4, M=8, "
        f"{time.perf_counter() - t1:.1f} s): raw reward early third "
        f"{early:.4f} -> late third {late:.4f} ({late / early:.3f}x, over "
        f"{len(series)} epochs); op probabilities first "
        f"{[round(v, 4) for v in res['first']]}, tail "
        f"{[round(v, 4) for v in res['tail_mean']]} ({res['op_names']}); "
        f"learned {res['learned']:.4f} vs random {res['random']:.4f} "
        f"({res['learned'] / res['random']:.3f}x)")
    log(f"[learning] converged op {res['converged_op']}, final landscape's "
        f"argmax {res['landscape_op']}; final landscape (mag 0 / 9): "
        + ", ".join(f"{n} {a:.4f}/{b:.4f}" for n, (a, b)
                    in zip(res["landscape_ops"], res["landscape"])))
    log("[learning] series " + json.dumps([round(v, 4) for v in series]))
    numbers = (series + res["first"] + res["tail_mean"]
               + [v for row in res["landscape"] for v in row]
               + [res["learned"], res["random"]])
    if len(series) != 120 or not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"4-op proof: incomplete or non-finite {res}")
    for k, op, v in pl.THRESHOLDS:
        log(f"[learning] threshold {k} {values[k]:.4f} {op} {v}: "
            + ("met" if met[k] else "missed (ROADMAP queue 3, fault 1)"))
    log(f"[learning] {time.perf_counter() - t0:.1f} s in all")
    return {"calibration": r.tolist(), **res}


def phase_attention(dev, n: int = 144, crop: int = 256,
                    variant: str = "mit_b4") -> dict:
    """``segformer.attention`` forward and backward at each stage's shapes
    of one search step (``n`` crops), timed with CUDA events beside
    ``F.scaled_dot_product_attention`` on the same inputs (the largest
    difference of its output is printed) and beside its bound: the f32
    operations of the two batched matmuls forward and backward, or the
    bytes of q, k, v and the output gradient read once and of the output
    and the three gradients written once. Per step: each stage's time
    times its blocks, plus one more forward per block under remat."""
    import torch.nn.functional as F
    from aadg_tpu_torch.models import segformer as sf
    dims, depths, heads, srs, _ = sf.VARIANTS[variant]
    gen = torch.Generator(dev).manual_seed(0)
    side = (crop - 1) // 4 + 1          # patch_embed1's output
    stages, per_step = [], {"ms": 0.0, "fwd_ms": 0.0, "library_ms": 0.0,
                            "bound_ms": 0.0}
    for i in range(4):
        hd, nh = dims[i] // heads[i], heads[i]
        t, m = side * side, (-(-side // srs[i])) ** 2   # tokens, keys
        q = torch.randn(n, nh, t, hd, generator=gen, device=dev)
        k = torch.randn(n, nh, m, hd, generator=gen, device=dev)
        v = torch.randn(n, nh, m, hd, generator=gen, device=dev)
        g = torch.randn(n, nh, t, hd, generator=gen, device=dev)
        for a in (q, k, v):
            a.requires_grad_()

        def run(fn, backward=True):
            for a in (q, k, v):
                a.grad = None
            o = fn(q, k, v)
            if backward:
                o.backward(g)
            return o
        with torch.no_grad():
            diff = float((sf.attention(q, k, v)
                          - F.scaled_dot_product_attention(q, k, v))
                         .abs().max())
        b, by = bound_ms(4 * n * nh * hd * (4 * t + 4 * m),
                         3 * 4 * n * nh * t * m * hd)
        row = {"stage": i + 1, "blocks": depths[i],
               "shape": [n, nh, t, m, hd],
               "ms": time_ms(lambda: run(sf.attention), iters=10),
               "fwd_ms": time_ms(lambda: run(sf.attention, False), iters=10),
               "library_ms": time_ms(
                   lambda: run(F.scaled_dot_product_attention), iters=10),
               "bound_ms": b, "bound_by": by, "library_max_abs_diff": diff}
        stages.append(row)
        for key in per_step:
            per_step[key] += depths[i] * row[key]
        log(f"[segformer attention] stage {i + 1} "
            f"{'x'.join(map(str, row['shape']))} (n, heads, tokens, keys, "
            f"dim): forward+backward {row['ms']:.4f} ms, forward "
            f"{row['fwd_ms']:.4f} ms (scaled_dot_product_attention "
            f"{row['library_ms']:.4f}, output within {diff:.3g}; bound "
            f"{b:.4f} by {by}) x {depths[i]} blocks")
        del q, k, v, g
        side = (side - 1) // 2 + 1      # the next stage's 3x3 stride 2
    per_step["remat_ms"] = per_step["ms"] + per_step["fwd_ms"]
    log(f"[segformer attention] per search step: {per_step['ms']:.2f} ms "
        f"forward+backward, {per_step['remat_ms']:.2f} ms with remat's "
        f"second forward (scaled_dot_product_attention "
        f"{per_step['library_ms']:.2f}, bound {per_step['bound_ms']:.2f})")
    return {"stages": stages, "per_step": per_step}


def phase_remat(dev, task: Task, steps: int = 3) -> dict:
    """One full-width search step with TPU.REMAT true, then false: the
    median of ``steps`` timed steps after a warm-up step, and the peak
    memory allocated from building the state to the last step. Without
    remat the step may not fit in the card's memory; only that run's
    torch.cuda.OutOfMemoryError is caught, and printed as the finding."""
    res = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            one = flagship_step(dev, "search", task,
                                ["TPU.REMAT", str(remat)])
            times = []
            for i in range(steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            res[remat] = {"median_ms": statistics.median(times),
                          "steps_ms": times}
        except torch.cuda.OutOfMemoryError as e:
            if remat:
                raise
            res[remat] = {"oom": str(e).splitlines()[0]}
        one = None
        res[remat]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        r = res[remat]
        log(f"[{task.prefix}remat] search step with TPU.REMAT {remat}: "
            + (f"median {r['median_ms']:.1f} ms over {steps} steps "
               f"({[round(t, 1) for t in r['steps_ms']]})" if "oom" not in r
               else f"does not fit: {r['oom']}")
            + f"; peak memory allocated {r['peak_gib']:.2f} GiB of "
            f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}")
    costs = segformer_costs(dev)
    log(f"[{task.prefix}remat] MiT-b4 + head per 256^2 image: "
        f"{costs['params']} parameters, forward {costs['fwd_flop'] / 1e9:.3f}"
        f" GFLOP ({costs['blocks_fwd_flop'] / 1e9:.3f} in the blocks), "
        f"forward+backward {costs['step_flop_no_remat'] / 1e9:.3f} GFLOP "
        f"({costs['step_flop_remat'] / 1e9:.3f} with remat); saved for the "
        f"backward {costs['saved_bytes_no_remat'] / 2**20:.1f} MiB "
        f"({costs['saved_bytes_remat'] / 2**20:.1f} MiB with remat)")
    return {"remat": res[True], "no_remat": res[False], "costs": costs}


@contextlib.contextmanager
def timed(what: str):
    """Log the seconds the block took."""
    t0 = time.perf_counter()
    yield
    log(f"[time] {what}: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
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
    with timed("build"):
        phase_build()
    with timed("kernels"):
        rows = phase_kernels(dev)
    with timed("zoo costs"):
        phase_zoo_costs()
    by_path, profiles = {}, {}
    # the seeded source checkpoints and their conversions
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        for task in (OPTIC, RVS, SEGFORMER, *ZOO):
            p = task.prefix
            with timed(f"{task.name} cell"):
                # the earlier cells' cached blocks go back to the card first:
                # resnest's search peaks at 69.5 GiB of the card's 79.2
                gc.collect()
                torch.cuda.empty_cache()
                weights = (pretrained_file(task.pretrained, tmp)
                           if task.pretrained else "")
                phase_reference(dev, task)
                by_path[p + "search"], search_dir = phase_search_path(
                    dev, task, weights)
                by_path[p + "train"], train_dir = phase_train_path(
                    dev, task, search_dir, weights)
                phase_train_reference(dev, task)
                by_path[p + "test"] = phase_test_path(task, train_dir,
                                                      search_dir)
                for kind in ("search", "train"):
                    profiles[p + kind] = phase_profile(dev, kind, task)
        with timed("pretrained optic search"):
            by_path["pretrained_search"], _ = phase_search_path(
                dev, OPTIC._replace(search_epochs=1),
                pretrained_file("mobilenet_v2", tmp), "pretrained_search")
    with timed("segformer attention and remat"):
        attn = phase_attention(dev)["per_step"]
        busy = profiles["segformer_search"]["busy_ms"]
        log(f"[segformer attention] share of the profiled search step's "
            f"device time ({busy:.1f} ms): {attn['remat_ms'] / busy:.3f}")
        phase_remat(dev, SEGFORMER)
    with timed("zoo sweep"):
        sweep = phase_zoo_sweep(dev)
    by_path.update({k: v["launches"] for k, v in sweep.items()})
    with timed("learning"):
        phase_learning(dev)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    for r in rows:
        r["launches"] = by_path["search"][r["name"]]
        r["launches_by_path"] = {p: v[r["name"]] for p, v in by_path.items()}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

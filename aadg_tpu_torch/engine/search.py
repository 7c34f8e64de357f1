"""Search-mode loop (port of ``aadg_tpu/engine/search.py::run_search``).

Per epoch: warmup epochs run the pretrain step; at warmup end the momentum
discriminator copies the online one; search epochs sample M policies from
the LSTM controller, run the search steps, sum and normalize the rewards,
EMA-update the momentum branch and update the controller. Each epoch logs
a line like the JAX loop's, and the op/magnitude probability trajectories
are saved as .npy in the run directory.

Not ported yet (ROADMAP queue 1): validation and best-model tracking,
checkpoints and auto-resume, data parallelism, profiling.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import build_dataset, load_train_arrays
from ..data.stores import draw_batch_indices, gather_batch, make_train_store
from ..losses import normalize_rewards
from ..models.controller import policies_to_tensor
from ..models.discriminator import momentum_update, synchronize_parameters
from .rl import make_controller_update
from .state import build_entities, init_state
from .steps import (draw_pretrain, draw_search, make_pretrain_step,
                    make_search_step)


def set_precision_flags() -> None:
    """Full f32 for f32 matmuls and convolutions on the card (no TF32):
    the scale-crop resample and any f32 model run as the JAX reference
    does on the CPU; the model's bf16 autocast is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def create_logger(cfg, cfg_path: str):
    """Run directory ``<OUTPUT_DIR>/<dataset>/<cfg>_<time>/`` with a
    ``train.log`` file logger that also prints."""
    name = f"{Path(cfg_path).stem}_{time.strftime('%Y-%m-%d-%H-%M-%S')}"
    out_dir = Path(cfg.OUTPUT_DIR) / cfg.DATASET.NAME / name
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"aadg_tpu_torch.{name}.{os.getpid()}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fh = logging.FileHandler(out_dir / "train.log")
        fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger, str(out_dir)


def describe_policies(policies: np.ndarray, op_names, spec) -> list:
    """[[(op_name, mag/(num_mags-1)) x L] x Q] x M."""
    out = []
    for m in range(policies.shape[0]):
        toks = policies[m].reshape(spec.Q, spec.L, 2)
        out.append([[(op_names[int(toks[q, l, 0])],
                      float(toks[q, l, 1]) / (spec.num_mags - 1))
                     for l in range(spec.L)] for q in range(spec.Q)])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_search(cfg, cfg_path: str, device="cuda"):
    """Run the search on ``device``. Returns a summary dict: the run
    directory, per-epoch records (kind, seconds, metrics, rewards) and the
    wall time of every search step."""
    device = torch.device(device)
    set_precision_flags()
    logger, out_dir = create_logger(cfg, cfg_path)
    try:
        return _search(cfg, device, logger, out_dir)
    finally:
        for handler in list(logger.handlers):
            handler.close()
            logger.removeHandler(handler)


def _search(cfg, device, logger, out_dir):
    logger.info(str(cfg))

    store = make_train_store(*load_train_arrays(build_dataset(cfg, "train")),
                             device)
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    steps = int(cfg.TPU.STEPS_PER_EPOCH) or store.steps_per_epoch(batch_size)
    logger.info(f"steps/epoch: {steps}, domains: {store.n_domains}, "
                f"pool sizes: {store.counts.tolist()}, device: {device}")

    ent = build_entities(cfg, "search", steps_per_epoch=steps, device=device,
                         logger=logger)
    sd, cs = init_state(ent, int(cfg.SEED))
    gen = torch.Generator(device).manual_seed(int(cfg.SEED))
    M = int(cfg.CONTROLLER.M)
    h, w = store.images.shape[2], store.images.shape[3]
    pre_step = make_pretrain_step(ent)
    srch_step = make_search_step(ent, M, float(cfg.TPU.SINKHORN.BLUR),
                                 float(cfg.TPU.SINKHORN.SCALING))
    ctrl_update = make_controller_update(cfg.CONTROLLER.LOSS,
                                         float(cfg.CONTROLLER.PENALTY))

    n0 = batch_size * store.n_domains
    warmup = int(cfg.TRAIN.WARMUP_EPOCH)
    mag_traj, op_traj, records, step_seconds = [], [], [], []
    for epoch in range(int(cfg.TRAIN.BEGIN_EPOCH), int(cfg.TRAIN.END_EPOCH)):
        t0 = time.perf_counter()
        ms_list, rs = [], []
        if epoch < warmup:
            for _ in range(steps):
                batch = gather_batch(store, draw_batch_indices(
                    store, batch_size, gen))
                ms_list.append(pre_step(sd, batch,
                                        draw_pretrain(ent, n0, gen)))
            samples = steps * n0
        else:
            if epoch == warmup:
                synchronize_parameters(sd.disc)
            with torch.no_grad():
                policies, op_probs, mag_probs, log_probs, entropies = \
                    cs.controller.sample(M, gen)
            ptens = policies_to_tensor(policies, ent.ctrl_spec)
            for _ in range(steps):
                _sync(device)
                ts = time.perf_counter()
                batch = gather_batch(store, draw_batch_indices(
                    store, batch_size, gen))
                ms, r = srch_step(sd, batch, ptens,
                                  draw_search(ent, n0, M, h, w, gen))
                _sync(device)
                step_seconds.append(time.perf_counter() - ts)
                ms_list.append(ms)
                rs.append(r)
            rewards = normalize_rewards(torch.sum(torch.stack(rs), dim=0))
            momentum_update(sd.disc)
            ctrl_stats = ctrl_update(cs, policies, log_probs, entropies,
                                     rewards)
            samples = steps * n0 * M
        ms = {k: float(torch.mean(torch.stack([m[k] for m in ms_list])))
              for k in ms_list[0]}
        dt = time.perf_counter() - t0
        logger.info("Train Epoch {} time:{:.4f} Speed {:.1f} samples/s "
                    .format(epoch, dt, samples / dt)
                    + " ".join(f"{k}:{v:.4f}" for k, v in ms.items()))
        record = {"epoch": epoch, "kind": "warmup" if epoch < warmup
                  else "search", "seconds": dt, "metrics": ms}
        if epoch >= warmup:
            pol = policies.cpu().numpy()
            logger.info("policies: " + str(describe_policies(
                pol, ent.op_names, ent.ctrl_spec)))
            cstats = {k: float(v) for k, v in ctrl_stats.items()}
            logger.info(
                "Train Epoch {}: controller loss:{:.4f} score loss:{:.4f} "
                "entropy penalty:{:.4f}".format(
                    epoch, cstats["controller_loss"], cstats["score_loss"],
                    cstats["entropy_penalty"]))
            mag_traj.append(mag_probs.cpu().numpy())
            op_traj.append(op_probs.cpu().numpy())
            record.update(rewards=rewards.cpu().tolist(),
                          raw_rewards=torch.stack(rs).cpu().tolist(),
                          controller=cstats)
        records.append(record)

    np.save(os.path.join(out_dir, "mag_probs_trajectory.npy"),
            np.array(mag_traj))
    np.save(os.path.join(out_dir, "op_probs_trajectory.npy"),
            np.array(op_traj))
    return {"out_dir": out_dir, "epochs": records,
            "search_step_seconds": step_seconds, "steps_per_epoch": steps,
            "images_per_search_step": n0 * M}

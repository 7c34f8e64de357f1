"""Search-mode loop (port of ``aadg_tpu/engine/search.py::run_search``).

Per epoch: warmup epochs run the pretrain step; at warmup end the momentum
discriminator copies the online one; search epochs sample M policies from
the LSTM controller, run the search steps, sum and normalize the rewards,
EMA-update the momentum branch and update the controller. After every
epoch the model is validated on the held-out domain and the best average
dice is tracked; every ``TPU.CHECKPOINT_FREQ`` search epochs a checkpoint
is written on a background thread. ``TPU.AUTO_RESUME`` continues the
newest unfinished run of the same config. ``TPU.PROFILE`` traces the
first epoch of the run with ``torch.profiler`` into ``<run dir>/profile``.
The run ends with ``final_model_state.pt``, ``final_controller_state.pt``,
the op/magnitude probability trajectories and ``final_result.json``.

Not ported yet (ROADMAP queue 1): data parallelism.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.datasets import build_dataset, load_test_arrays, load_train_arrays
from ..data.stores import (draw_batch_indices, gather_batch, make_test_store,
                           make_train_store)
from ..losses import normalize_rewards
from ..models.controller import policies_to_tensor
from ..models.discriminator import momentum_update, synchronize_parameters
from ..utils.checkpoint import (find_resume_checkpoint, load_checkpoint,
                                save_array, save_checkpoint, save_json,
                                wait_pending_checkpoints)
from ..utils.logging import run_logging
from .evaluate import validate
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


def describe_policies(policies: np.ndarray, op_names, spec) -> list:
    """[[(op_name, mag/(num_mags-1)) x L] x Q] x M."""
    out = []
    for m in range(policies.shape[0]):
        toks = policies[m].reshape(spec.Q, spec.L, 2)
        out.append([[(op_names[int(toks[q, l, 0])],
                      float(toks[q, l, 1]) / (spec.num_mags - 1))
                     for l in range(spec.L)] for q in range(spec.Q)])
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(device: torch.device):
    """A running ``torch.profiler`` trace of the host, and of the card when
    ``device`` is one."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def end_trace(prof, device: torch.device, out_dir: str, logger) -> None:
    """Wait for the device, stop ``prof`` and write its trace to
    ``<out_dir>/profile/trace.json``."""
    sync(device)
    prof.__exit__(None, None, None)
    trace_dir = os.path.join(out_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    logger.info(f"profiler trace written to {trace_dir}")


def load_stores(cfg, device):
    """(train store, test store, steps per epoch)."""
    store = make_train_store(*load_train_arrays(build_dataset(cfg, "train")),
                             device)
    test_store = make_test_store(
        *load_test_arrays(build_dataset(cfg, "test")),
        batch_size=int(cfg.TEST.BATCH_SIZE), device=device)
    # the raw name, as the JAX package compares it: synthetic_rvs gets 1
    length_mult = 3 if cfg.DATASET.NAME == "rvs" else 1
    steps = (int(cfg.TPU.STEPS_PER_EPOCH)
             or store.steps_per_epoch(int(cfg.TRAIN.BATCH_SIZE), length_mult))
    return store, test_store, steps


def write_timer(record: dict):
    """``on_joined`` of a background checkpoint: the writer thread's own
    seconds go to ``record["checkpoint_write_seconds"]`` (the time in the
    loop is ``checkpoint_seconds``)."""
    def joined(seconds: float) -> None:
        record["checkpoint_write_seconds"] = seconds
    return joined


def try_resume(cfg, out_dir, logger):
    """The checkpoint dict to resume from under ``TPU.AUTO_RESUME``, or
    None; a completed run (its epoch >= END_EPOCH) starts fresh."""
    if not cfg.TPU.AUTO_RESUME:
        return None
    ckpt = find_resume_checkpoint(out_dir)
    if not ckpt:
        return None
    state = load_checkpoint(ckpt)
    if int(state["epoch"]) >= int(cfg.TRAIN.END_EPOCH):
        logger.warning(
            f"auto-resume: {ckpt} is a COMPLETED run (epoch "
            f"{int(state['epoch'])} >= END_EPOCH {cfg.TRAIN.END_EPOCH}); "
            "starting fresh instead")
        return None
    logger.info(f"resumed from {ckpt} at epoch {int(state['epoch'])}")
    return state


def initial_best(ent, with_hd: bool) -> dict:
    """The best-metric record before the first validation: optic dice (and
    hd95 in search mode) or the rvs metrics."""
    if ent.dataset_name != "optic":
        return {"epoch": 0, "dsc": 0, "acc": 0, "aucroc": 0, "sp": 0,
                "se": 0}
    keys = ["avg_dsc", "cup_dsc", "disc_dsc"] + (
        ["avg_hd", "cup_hd", "disc_hd"] if with_hd else [])
    return {"epoch": 0, **{k: 0 for k in keys}}


def validate_and_track(ent, sd, test_store, cfg, epoch, best, logger,
                       writer, with_hd: bool):
    """Validate after ``epoch``, log it, and update ``best`` (a dict with
    ``dsc`` and ``metric``) in place; ``with_hd`` (search mode) logs and
    keeps the optic hd95. Returns (validation dict, is_best)."""
    vm = validate(ent, sd.model, test_store, int(cfg.TEST.BATCH_SIZE))
    if ent.dataset_name != "optic":
        dsc = vm["dsc"]
        current = {"epoch": epoch + 1, **vm}
    else:
        dsc = (vm["cup_dsc"] + vm["disc_dsc"]) / 2
        current = {"epoch": epoch + 1, "avg_dsc": dsc,
                   "cup_dsc": vm["cup_dsc"], "disc_dsc": vm["disc_dsc"]}
    if with_hd and ent.dataset_name == "optic":
        logger.info(
            "Test Epoch {} dsc@cup:{cup_dsc:.4f} dsc@disc:{disc_dsc:.4f}"
            " HD@cup:{cup_hd:.4f} HD@disc:{disc_hd:.4f}".format(epoch, **vm))
        current.update(avg_hd=(vm["cup_hd"] + vm["disc_hd"]) / 2,
                       cup_hd=vm["cup_hd"], disc_hd=vm["disc_hd"])
    else:
        logger.info("Test Epoch {} ".format(epoch)
                    + " ".join(f"{k}:{v:.4f}" for k, v in vm.items()))
    for k, v in vm.items():
        writer.add_scalar(f"valid_{k}", v, epoch)
    is_best = dsc > best["dsc"]
    if is_best:
        best["dsc"] = dsc
        best["metric"] = current
    return vm, is_best


def run_search(cfg, cfg_path: str, device="cuda"):
    """Run the search on ``device``. Returns a summary dict: the run
    directory, per-epoch records (kind, seconds, metrics, validation,
    rewards), the wall time of every search step and the best metric."""
    device = torch.device(device)
    set_precision_flags()
    with run_logging(cfg, cfg_path, "train") as (logger, out_dir, writer):
        return _search(cfg, device, logger, out_dir, writer)


def _search(cfg, device, logger, out_dir, writer):
    logger.info(str(cfg))
    store, test_store, steps = load_stores(cfg, device)
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    logger.info(f"steps/epoch: {steps}, domains: {store.n_domains}, "
                f"pool sizes: {store.counts.tolist()}, device: {device}")

    ent = build_entities(cfg, "search", steps_per_epoch=steps, device=device,
                         logger=logger)
    sd, cs = init_state(ent, int(cfg.SEED), str(cfg.TPU.PRETRAINED),
                        logger)
    gen = torch.Generator(device).manual_seed(int(cfg.SEED))
    M = int(cfg.CONTROLLER.M)
    h, w = store.images.shape[2], store.images.shape[3]
    pre_step = make_pretrain_step(ent)
    srch_step = make_search_step(ent, M, float(cfg.TPU.SINKHORN.BLUR),
                                 float(cfg.TPU.SINKHORN.SCALING))
    ctrl_update = make_controller_update(cfg.CONTROLLER.LOSS,
                                         float(cfg.CONTROLLER.PENALTY))

    begin = int(cfg.TRAIN.BEGIN_EPOCH)
    best = {"dsc": 0.0, "metric": initial_best(ent, with_hd=True)}
    resumed = try_resume(cfg, out_dir, logger)
    if resumed is not None:
        sd.load_state_dict(resumed["sd"])
        cs.load_state_dict(resumed["cs"])
        gen.set_state(resumed["generator"])
        begin = int(resumed["epoch"])
        best = {"dsc": float(resumed["best_dsc"]),
                "metric": resumed["best_metric"]}

    n0 = batch_size * store.n_domains
    warmup = int(cfg.TRAIN.WARMUP_EPOCH)
    mag_traj, op_traj, records, step_seconds = [], [], [], []
    for epoch in range(begin, int(cfg.TRAIN.END_EPOCH)):
        prof = (start_trace(device) if cfg.TPU.PROFILE and epoch == begin
                else None)
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
                sync(device)
                ts = time.perf_counter()
                batch = gather_batch(store, draw_batch_indices(
                    store, batch_size, gen))
                ms, r = srch_step(sd, batch, ptens,
                                  draw_search(ent, n0, M, h, w, gen))
                sync(device)
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
            logger.info("policies: " + str(describe_policies(
                policies.cpu().numpy(), ent.op_names, ent.ctrl_spec)))
            for k, v in ms.items():
                writer.add_scalar(f"train_{k}", v, epoch)
        if prof is not None:
            end_trace(prof, device, out_dir, logger)

        t0 = time.perf_counter()
        vm, is_best = validate_and_track(ent, sd, test_store, cfg, epoch,
                                         best, logger, writer, with_hd=True)
        record.update(valid=vm, valid_seconds=time.perf_counter() - t0)
        logger.info(f"=> best: {is_best}")

        if epoch >= warmup:
            cstats = {k: float(v) for k, v in ctrl_stats.items()}
            logger.info(
                "Train Epoch {}: controller loss:{:.4f} score loss:{:.4f} "
                "entropy penalty:{:.4f}".format(
                    epoch, cstats["controller_loss"], cstats["score_loss"],
                    cstats["entropy_penalty"]))
            for k, v in cstats.items():
                writer.add_scalar(k, v, epoch)
            mag_traj.append(mag_probs.cpu().numpy())
            op_traj.append(op_probs.cpu().numpy())
            record.update(rewards=rewards.cpu().tolist(),
                          raw_rewards=torch.stack(rs).cpu().tolist(),
                          controller=cstats)
            if (epoch - warmup) % max(1, int(cfg.TPU.CHECKPOINT_FREQ)) == 0:
                t0 = time.perf_counter()
                save_checkpoint(
                    {"sd": sd.state_dict(), "cs": cs.state_dict(),
                     "epoch": epoch + 1, "best_dsc": best["dsc"],
                     "best_metric": dict(best["metric"]),
                     "generator": gen.get_state()},
                    is_best, out_dir, f"checkpoint_{epoch}.pt",
                    background=True, on_joined=write_timer(record))
                record["checkpoint_seconds"] = time.perf_counter() - t0
        records.append(record)

    wait_pending_checkpoints()
    save_checkpoint({"model": sd.model.state_dict()}, False, out_dir,
                    "final_model_state.pt", update_latest=False)
    save_checkpoint({"controller": cs.controller.state_dict()}, False,
                    out_dir, "final_controller_state.pt",
                    update_latest=False)
    save_array(np.array(mag_traj),
               os.path.join(out_dir, "mag_probs_trajectory.npy"))
    save_array(np.array(op_traj),
               os.path.join(out_dir, "op_probs_trajectory.npy"))
    logger.info("Best: " + str(best["metric"]))
    save_json(best["metric"], os.path.join(out_dir, "final_result.json"))
    return {"out_dir": out_dir, "epochs": records,
            "search_step_seconds": step_seconds, "steps_per_epoch": steps,
            "images_per_search_step": n0 * M, "best_metric": best["metric"]}

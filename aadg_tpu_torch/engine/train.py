"""Train-mode loop (port of ``aadg_tpu/engine/train.py::run_train``, one
device).

Per epoch: the segmentation model trains on domain-balanced batches with
a cosine learning rate over ``END_EPOCH`` epochs; the discriminator is
neither run nor stepped. With ``TPU.AUTOAUGMENT`` each epoch samples one
policy (1, Q, L, 2) from the controller, loaded from
``TEST.MODEL_DIR/final_controller_state.pt`` when a search left one there,
and every step uses the policy-augmented batch on a coin of 0.5. After
every epoch the model is validated, the best average dice is tracked and a
checkpoint is written on a background thread; ``TPU.AUTO_RESUME``
continues the newest unfinished run of the same config. The run ends with
``final_state.pt`` and ``final_result.json``.
"""

from __future__ import annotations

import os
import time

import torch

from ..models.controller import policies_to_tensor
from ..data.stores import draw_batch_indices, gather_batch
from ..utils.checkpoint import (load_checkpoint, save_checkpoint, save_json,
                                wait_pending_checkpoints)
from ..utils.logging import run_logging
from .search import (initial_best, load_stores, set_precision_flags, sync,
                     try_resume, validate_and_track, write_timer)
from .state import build_entities, init_state
from .steps import (draw_pretrain, draw_train, make_autoaug_train_step,
                    make_pretrain_step)


def run_train(cfg, cfg_path: str, device="cuda"):
    """Train on ``device``. Returns a summary dict: the run directory,
    per-epoch records (seconds, metrics, validation), the wall time of
    every train step and the best metric."""
    device = torch.device(device)
    set_precision_flags()
    with run_logging(cfg, cfg_path, "train") as (logger, out_dir, writer):
        return _train(cfg, device, logger, out_dir, writer)


def _train(cfg, device, logger, out_dir, writer):
    logger.info(str(cfg))
    store, test_store, steps = load_stores(cfg, device)
    batch_size = int(cfg.TRAIN.BATCH_SIZE)
    ent = build_entities(cfg, "train", steps_per_epoch=steps, device=device,
                         logger=logger)
    sd, cs = init_state(ent, int(cfg.SEED), str(cfg.TPU.PRETRAINED),
                        logger)
    gen = torch.Generator(device).manual_seed(int(cfg.SEED))
    h, w = store.images.shape[2], store.images.shape[3]
    n0 = batch_size * store.n_domains

    autoaug = bool(cfg.TPU.AUTOAUGMENT)
    if autoaug:
        ctrl_path = os.path.join(cfg.TEST.MODEL_DIR or "",
                                 "final_controller_state.pt")
        if cfg.TEST.MODEL_DIR and os.path.exists(ctrl_path):
            cs.controller.load_state_dict(
                load_checkpoint(ctrl_path)["controller"])
            logger.info(f"autoaugment: loaded controller {ctrl_path}")
        step_fn = make_autoaug_train_step(ent)
    else:
        step_fn = make_pretrain_step(ent, step_disc=False)

    begin = int(cfg.TRAIN.BEGIN_EPOCH)
    best = {"dsc": 0.0, "metric": initial_best(ent, with_hd=False)}
    resumed = try_resume(cfg, out_dir, logger)
    if resumed is not None:
        sd.load_state_dict(resumed["sd"])
        gen.set_state(resumed["generator"])
        begin = int(resumed["epoch"])
        best = {"dsc": float(resumed["best_dsc"]),
                "metric": resumed["best_metric"]}

    records, step_seconds = [], []
    for epoch in range(begin, int(cfg.TRAIN.END_EPOCH)):
        t0 = time.perf_counter()
        if autoaug:
            with torch.no_grad():
                ptens = policies_to_tensor(cs.controller.sample(1, gen)[0],
                                           ent.ctrl_spec)
        ms_list = []
        for _ in range(steps):
            sync(device)
            ts = time.perf_counter()
            batch = gather_batch(store, draw_batch_indices(
                store, batch_size, gen))
            if autoaug:
                ms = step_fn(sd, batch, ptens, draw_train(ent, n0, h, w, gen))
            else:
                ms = step_fn(sd, batch, draw_pretrain(ent, n0, gen))
            sync(device)
            step_seconds.append(time.perf_counter() - ts)
            ms_list.append(ms)
        ms = {k: float(torch.mean(torch.stack([m[k] for m in ms_list])))
              for k in ms_list[0]}
        dt = time.perf_counter() - t0
        logger.info("Train Epoch {} time:{:.4f} Speed {:.1f} samples/s "
                    .format(epoch, dt, steps * n0 / dt)
                    + " ".join(f"{k}:{v:.4f}" for k, v in ms.items()))
        for k, v in ms.items():
            writer.add_scalar(f"train_{k}", v, epoch)
        record = {"epoch": epoch, "seconds": dt, "metrics": ms}

        t0 = time.perf_counter()
        vm, is_best = validate_and_track(ent, sd, test_store, cfg, epoch,
                                         best, logger, writer, with_hd=False)
        record.update(valid=vm, valid_seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        save_checkpoint({"sd": sd.state_dict(), "epoch": epoch + 1,
                         "best_dsc": best["dsc"],
                         "best_metric": dict(best["metric"]),
                         "generator": gen.get_state()},
                        is_best, out_dir, f"checkpoint_{epoch}.pt",
                        background=True, on_joined=write_timer(record))
        record["checkpoint_seconds"] = time.perf_counter() - t0
        records.append(record)

    wait_pending_checkpoints()
    save_checkpoint({"model": sd.model.state_dict()}, False, out_dir,
                    "final_state.pt", update_latest=False)
    logger.info("Best: " + str(best["metric"]))
    save_json(best["metric"], os.path.join(out_dir, "final_result.json"))
    return {"out_dir": out_dir, "epochs": records,
            "train_step_seconds": step_seconds, "steps_per_epoch": steps,
            "images_per_train_step": n0, "best_metric": best["metric"]}

"""Entities, training state and optimizers (port of
``aadg_tpu/engine/state.py``).

Where the JAX package keeps parameters in pytrees that flow through pure
steps, here the modules own their parameters and the optimizers update
them in place. ``Entities`` holds what a run builds once from the config;
``init_state`` makes the seeded modules and their optimizers. Each state
has ``state_dict``/``load_state_dict`` for checkpoints.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import CfgNode
from ..data.transforms import make_train_transform
from ..models import (build_model, class_parser, domain_parser,
                      dropout_drawer, feature_dim)
from ..models.controller import Controller, ControllerSpec, spec_from_config
from ..models.discriminator import (MomentumFeatureDiscriminator,
                                    build_discriminator)
from ..ops import augment as aug_mod
from ..utils.pretrained import load_pretrained


class ScheduledAdam:
    """torch.optim.Adam (L2 weight decay folded into the gradient before
    the moments, as optax ``add_decayed_weights`` + ``scale_by_adam``) whose
    learning rate is ``schedule(count)`` at update ``count`` = 0, 1, ...

    optax updates every parameter at every step, a parameter the loss does
    not reach with a zero gradient (then only its decay and its moments
    move it). torch's Adam skips a parameter whose ``.grad`` is None, so
    ``step`` gives each such parameter a zero gradient first."""

    def __init__(self, params, schedule: Callable[[int], float],
                 wd: float = 0.0):
        self.schedule = schedule
        self.count = 0
        self.params = list(params)
        self.opt = torch.optim.Adam(self.params, lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=wd)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def torch_adam(params, lr, wd: float = 0.0) -> ScheduledAdam:
    """Adam with torch semantics; ``lr`` is a float or a schedule."""
    schedule = lr if callable(lr) else (lambda step, lr=float(lr): lr)
    return ScheduledAdam(params, schedule, wd)


def multistep_schedule(base_lr: float, milestone_step: int,
                       gamma: float = 0.1) -> Callable[[int], float]:
    """MultiStepLR([milestone], gamma) counted in steps."""
    return lambda step: base_lr * (gamma if step >= milestone_step else 1.0)


def cosine_schedule(base_lr: float,
                    total_steps: int) -> Callable[[int], float]:
    """CosineAnnealingLR(T_max=total_steps), eta_min 0, counted in steps;
    held at 0 past the end."""
    def schedule(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t))
    return schedule


def resolve_search_space(cfg: CfgNode, logger=None) -> List[str]:
    """Search-space op names after EXCLUDE_OPS (by name) or
    EXCLUDE_OPS_NUM (random removals, seeded by cfg.SEED)."""
    names = aug_mod.augment_list()
    if len(cfg.CONTROLLER.EXCLUDE_OPS) > 0:
        names = [n for n in names if n not in cfg.CONTROLLER.EXCLUDE_OPS]
        if logger:
            logger.info(str(list(cfg.CONTROLLER.EXCLUDE_OPS)))
    elif cfg.CONTROLLER.EXCLUDE_OPS_NUM > 0:
        rng = np.random.default_rng(cfg.SEED if cfg.SEED else None)
        for _ in range(cfg.CONTROLLER.EXCLUDE_OPS_NUM):
            removed = names.pop(int(rng.integers(len(names))))
            if logger:
                logger.info(removed)
    return names


class Entities(NamedTuple):
    make_model: Callable      # () -> the segmentation model, freshly initialized
    ctrl_spec: ControllerSpec
    transform: Callable       # (imgs, masks, ScaleCropDraw) -> (x, y)
    scale_range: tuple
    multi_policy: Callable    # batched DGMultiPolicy applier
    op_names: list
    n_domains: int
    num_classes: int
    dis_name: str
    dataset_name: str         # "optic" or "rvs"
    feature_dim: int
    lr: float
    wd: float
    model_schedule: Callable  # step -> the model's learning rate
    device: torch.device
    compute_dtype: torch.dtype
    # (n, generator) -> the model's dropout masks for n training crops;
    # None for a model without dropout
    draw_dropout: Optional[Callable]

    def autocast(self):
        """Autocast context for the segmentation model's forward."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)


class SegDisState(NamedTuple):
    model: torch.nn.Module
    disc: MomentumFeatureDiscriminator
    seg_opt: ScheduledAdam
    dis_opt: ScheduledAdam

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "disc": self.disc.state_dict(),
                "seg_opt": self.seg_opt.state_dict(),
                "dis_opt": self.dis_opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.disc.load_state_dict(state["disc"])
        self.seg_opt.load_state_dict(state["seg_opt"])
        self.dis_opt.load_state_dict(state["dis_opt"])


class CtrlState(NamedTuple):
    controller: Controller
    opt: ScheduledAdam

    def state_dict(self) -> dict:
        return {"controller": self.controller.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.controller.load_state_dict(state["controller"])
        self.opt.load_state_dict(state["opt"])


def build_entities(cfg: CfgNode, mode: str = "search",
                   steps_per_epoch: int = 1, device="cuda",
                   logger=None) -> Entities:
    """What a run builds once from the config. The model, its number of
    classes, its dropout draws and the discriminator's input width come
    from the model factory. The model's schedule is MultiStepLR (x0.1 at
    the end of warmup) in search mode and cosine over ``END_EPOCH *
    steps_per_epoch`` steps otherwise."""
    width = feature_dim(cfg)
    if int(cfg.TPU.DATA_PARALLEL) not in (-1, 1):
        raise NotImplementedError(
            "data parallelism is not ported yet (ROADMAP queue 1, item 6)")
    base = "optic" if "optic" in cfg.DATASET.NAME else "rvs"
    num_classes = class_parser(base)
    crop = int(cfg.TPU.CROP_SIZE)
    transform, scale_range = make_train_transform(base, crop)
    op_names = resolve_search_space(cfg, logger)
    spec = spec_from_config(cfg, num_ops=len(op_names))
    multi_policy = aug_mod.make_multi_policy_applier(
        op_names, spec.Q, spec.L, spec.num_mags)
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[cfg.TPU.COMPUTE_DTYPE]
    lr = float(cfg.TRAIN.LR)
    if mode == "search":
        schedule = multistep_schedule(
            lr, int(cfg.TRAIN.WARMUP_EPOCH) * steps_per_epoch, 0.1)
    else:
        schedule = cosine_schedule(
            lr, int(cfg.TRAIN.END_EPOCH) * steps_per_epoch)
    return Entities(
        make_model=functools.partial(build_model, cfg, num_classes),
        ctrl_spec=spec, transform=transform, scale_range=scale_range,
        multi_policy=multi_policy, op_names=op_names,
        n_domains=domain_parser(base), num_classes=num_classes,
        dis_name=cfg.DISCRIMINATOR.NAME, dataset_name=base,
        feature_dim=width, lr=lr,
        wd=float(cfg.TRAIN.WD), model_schedule=schedule,
        device=torch.device(device), compute_dtype=dtype,
        draw_dropout=dropout_drawer(cfg, crop))


def init_state(ent: Entities, seed: int, pretrained: str = "",
               logger=None):
    """Seeded modules on ``ent.device`` and their optimizers. Returns
    (SegDisState, CtrlState). The global RNG is left as it was.
    ``pretrained`` (``TPU.PRETRAINED``): converted weights
    (``python -m aadg_tpu_torch.convert_weights``) copied into the seeded
    model before it moves to the device, as the JAX ``init_state`` grafts
    them into its initialized parameters; the seeded draws are the same
    with and without them."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ent.make_model()
        disc = build_discriminator(ent.dis_name, ent.n_domains,
                                   ent.feature_dim)
        controller = Controller(ent.ctrl_spec)
    if pretrained:
        load_pretrained(model, pretrained, logger)
    model.to(ent.device)
    if ent.device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    disc.to(ent.device)
    controller.to(ent.device)
    sd = SegDisState(
        model=model, disc=disc,
        seg_opt=torch_adam(model.parameters(), ent.model_schedule, ent.wd),
        dis_opt=torch_adam(disc.online.parameters(), ent.lr))
    cs = CtrlState(controller, torch_adam(controller.parameters(), 0.00035))
    return sd, cs

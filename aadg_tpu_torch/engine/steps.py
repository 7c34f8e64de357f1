"""Warmup, train and search steps (port of ``aadg_tpu/engine/steps.py``:
``make_pretrain_step`` :106-174, ``make_autoaug_train_step`` :177-205 and
``make_search_step`` :208-319).

A step takes the state, a raw batch and its draws, updates the modules in
place and returns its metrics as device tensors (no host sync). Gradients
stay in ``.grad`` after the step. The order of operations is the JAX
step's: the augmented copies take their labels from the original masks,
copy (b, d, m) is row (b*D + d)*M + m, the reward features are arranged
(M, D, B, F), and the momentum branch reads the discriminator before its
update. A model with dropout (SegFormer) takes its masks from the draws
(``ent.draw_dropout``), so activation checkpointing replays them; the
others draw nothing. The steps' stages are named profiler ranges
(``search/augment`` ... ``search/optimizer``, ``train/augment`` ...
``train/optimizer``), which cost nothing unless ``torch.profiler`` is
recording.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from ..data.transforms import (ScaleCropDraw, draw_scale_crop,
                               draw_soft_domain_label, soft_domain_label)
from ..losses import bce_loss, soft_cross_entropy
from ..metrics import samplewise_f1
from ..ops.augment import PolicyDraw, draw_policy
from ..ops.sinkhorn import pairwise_domain_ot
from .state import Entities, SegDisState


class PretrainDraws(NamedTuple):
    crop: ScaleCropDraw    # per sample (B*D)
    soft: torch.Tensor     # (B*D, n_domains) soft-label uniforms
    dropout: Any = None    # the model's masks for B*D crops, or None


class SearchDraws(NamedTuple):
    policy: PolicyDraw     # (B*D, M)
    crop: ScaleCropDraw    # per augmented copy (B*D*M)
    soft: torch.Tensor     # (B*D, n_domains)
    dropout: Any = None    # the model's masks for B*D*M crops, or None


class TrainDraws(NamedTuple):
    coin: torch.Tensor     # () uniform: the augmented batch is used if > 0.5
    policy: PolicyDraw     # (B*D, 1)
    crop: ScaleCropDraw    # per sample (B*D)
    dropout: Any = None    # the model's masks for B*D crops, or None


def _draw_dropout(ent: Entities, n: int, generator: torch.Generator):
    return (None if ent.draw_dropout is None
            else ent.draw_dropout(n, generator))


def draw_pretrain(ent: Entities, n0: int,
                  generator: torch.Generator) -> PretrainDraws:
    return PretrainDraws(
        draw_scale_crop(n0, ent.scale_range, generator),
        draw_soft_domain_label(n0, ent.n_domains, generator),
        _draw_dropout(ent, n0, generator))


def draw_search(ent: Entities, n0: int, M: int, h: int, w: int,
                generator: torch.Generator) -> SearchDraws:
    return SearchDraws(
        draw_policy(n0, M, ent.ctrl_spec.Q, ent.ctrl_spec.L, h, w,
                    generator),
        draw_scale_crop(n0 * M, ent.scale_range, generator),
        draw_soft_domain_label(n0, ent.n_domains, generator),
        _draw_dropout(ent, n0 * M, generator))


def _flatten(batch):
    imgs, masks, dcs = batch
    n0 = imgs.shape[0] * imgs.shape[1]
    return (imgs.reshape(n0, *imgs.shape[2:]),
            masks.reshape(n0, *masks.shape[2:]), dcs.reshape(n0))


def _seg_metrics(ent: Entities, seg_soft, y):
    """Thresholded samplewise F1, class-1 entry, per channel: cup and disc
    for two classes, ``dsc`` for one."""
    hard = (seg_soft > 0.5).float()
    if ent.num_classes == 2:
        return {"cup_dsc": samplewise_f1(hard[..., 0], y[..., 0])[1],
                "disc_dsc": samplewise_f1(hard[..., 1], y[..., 1])[1]}
    return {"dsc": samplewise_f1(hard[..., 0], y[..., 0])[1]}


def _forward_seg(ent: Entities, sd: SegDisState, x, y, dropout):
    with ent.autocast():
        logits, feat = (sd.model(x) if dropout is None
                        else sd.model(x, dropout))
    seg_soft = torch.sigmoid(logits)
    return seg_soft, bce_loss(seg_soft, y), feat


def draw_train(ent: Entities, n0: int, h: int, w: int,
               generator: torch.Generator) -> TrainDraws:
    return TrainDraws(
        torch.rand((), generator=generator, device=generator.device),
        draw_policy(n0, 1, ent.ctrl_spec.Q, ent.ctrl_spec.L, h, w,
                    generator),
        draw_scale_crop(n0, ent.scale_range, generator),
        _draw_dropout(ent, n0, generator))


def make_pretrain_step(ent: Entities, step_disc: bool = True):
    """Warmup step: the un-augmented batch; the segmentation model trains
    with BCE, the online discriminator with soft CE on soft domain labels.

    ``step_disc=False`` is the plain train mode's step: the discriminator
    is neither run nor stepped (its parameters, gradients and optimizer
    stay untouched), the draws need only ``crop`` (and ``dropout``), and
    the metrics have no ``dis_loss``."""

    stage = "pretrain" if step_disc else "train"

    def step(sd: SegDisState, batch, draws):
        imgs, masks, dcs = _flatten(batch)
        with record_function(f"{stage}/forward_backward"):
            x, y = ent.transform(imgs, masks, draws.crop)
            sd.model.train()
            sd.seg_opt.zero_grad()
            seg_soft, seg_loss, feat = _forward_seg(ent, sd, x, y,
                                                    draws.dropout)
            metrics = {"seg_loss": seg_loss.detach()}
            if step_disc:
                sd.dis_opt.zero_grad()
                dc_soft = soft_domain_label(dcs, ent.n_domains, draws.soft)
                dis_loss = soft_cross_entropy(sd.disc(feat.detach()),
                                              dc_soft)
                (seg_loss + dis_loss).backward()
                metrics["dis_loss"] = dis_loss.detach()
            else:
                seg_loss.backward()
        with record_function(f"{stage}/optimizer"):
            sd.seg_opt.step()
            if step_disc:
                sd.dis_opt.step()
        return {**metrics, **_seg_metrics(ent, seg_soft.detach(), y)}

    return step


def make_autoaug_train_step(ent: Entities):
    """Train-mode step with the reference's ``autoaugment`` behaviour
    (``aadg_tpu/engine/steps.py:177-205``): every sample gets sub-policy
    ``draws.policy.q`` of the one policy (1, Q, L, 2), then the whole batch
    is the augmented copy where ``draws.coin > 0.5`` and the raw batch
    otherwise. The augmented copy is always computed and the choice is a
    ``torch.where`` on the device, so the step never waits on the host.
    The rest is ``make_pretrain_step(ent, step_disc=False)``."""
    base = make_pretrain_step(ent, step_disc=False)

    def step(sd: SegDisState, batch, policies: torch.Tensor,
             draws: TrainDraws):
        imgs, masks, dcs = batch
        n0 = imgs.shape[0] * imgs.shape[1]
        with record_function("train/augment"):
            aug_i, aug_m = ent.multi_policy(
                imgs.reshape(n0, *imgs.shape[2:]),
                masks.reshape(n0, *masks.shape[2:]), policies, draws.policy)
            use_aug = draws.coin > 0.5
            imgs = torch.where(use_aug, aug_i.reshape(imgs.shape), imgs)
            masks = torch.where(use_aug, aug_m.reshape(masks.shape), masks)
        return base(sd, (imgs, masks, dcs), draws)

    return step


def make_search_step(ent: Entities, M: int, sinkhorn_blur: float = 0.05,
                     sinkhorn_scaling: float = 0.5):
    """The search step: M policies applied to every sample, BCE + online
    discriminator update, and the per-policy Sinkhorn diversity rewards
    (M,) from the momentum branch's 128-d domain features."""
    if ent.dis_name != "momentum_feature":
        raise NotImplementedError("search mode needs the momentum_feature "
                                  "discriminator in this port")

    def step(sd: SegDisState, batch, policies: torch.Tensor,
             draws: SearchDraws):
        imgs, masks, dcs = _flatten(batch)
        b, d = batch[0].shape[0], batch[0].shape[1]
        n0 = b * d
        n = n0 * M
        with record_function("search/augment"):
            aug_i, _ = ent.multi_policy(imgs, masks, policies, draws.policy)
        with record_function("search/transform"):
            flat_i = aug_i.reshape(n, *aug_i.shape[2:])
            flat_m = masks[:, None].expand(n0, M, *masks.shape[1:]).reshape(
                n, *masks.shape[1:])
            x, y = ent.transform(flat_i, flat_m, draws.crop)
            dc_soft = torch.repeat_interleave(
                soft_domain_label(dcs, ent.n_domains, draws.soft), M, dim=0)

        with record_function("search/forward_backward"):
            sd.model.train()
            sd.seg_opt.zero_grad()
            sd.dis_opt.zero_grad()
            seg_soft, seg_loss, feat = _forward_seg(ent, sd, x, y,
                                                    draws.dropout)
            feat = feat.detach()
            dis_loss_bp = soft_cross_entropy(sd.disc(feat), dc_soft)
            (seg_loss + dis_loss_bp).backward()

        with record_function("search/rewards"):
            dis_out_mom, dom_feat = sd.disc(feat, momentum=True,
                                            return_feature=True)
            dis_loss_mon = soft_cross_entropy(dis_out_mom, dc_soft)
            feats = dom_feat.reshape(b, d, M, -1).permute(2, 1, 0, 3)
            rewards = pairwise_domain_ot(feats, blur=sinkhorn_blur,
                                         scaling=sinkhorn_scaling)

        with record_function("search/optimizer"):
            sd.seg_opt.step()
            sd.dis_opt.step()
        metrics = {"seg_loss": seg_loss.detach(),
                   "dis_loss": dis_loss_mon,
                   "diversity_ot": torch.sum(rewards),
                   **_seg_metrics(ent, seg_soft.detach(), y)}
        return metrics, rewards

    return step

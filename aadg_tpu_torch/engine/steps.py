"""Warmup and search steps (port of ``aadg_tpu/engine/steps.py``:
``make_pretrain_step`` :106-174 and ``make_search_step`` :208-319).

A step takes the state, a raw batch and its draws, updates the modules in
place and returns its metrics as device tensors (no host sync). Gradients
stay in ``.grad`` after the step. The order of operations is the JAX
step's: the augmented copies take their labels from the original masks,
copy (b, d, m) is row (b*D + d)*M + m, the reward features are arranged
(M, D, B, F), and the momentum branch reads the discriminator before its
update. The search step's stages are named profiler ranges
(``search/augment`` ... ``search/optimizer``), which cost nothing unless
``torch.profiler`` is recording.
"""

from __future__ import annotations

from typing import NamedTuple

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


class SearchDraws(NamedTuple):
    policy: PolicyDraw     # (B*D, M)
    crop: ScaleCropDraw    # per augmented copy (B*D*M)
    soft: torch.Tensor     # (B*D, n_domains)


def draw_pretrain(ent: Entities, n0: int,
                  generator: torch.Generator) -> PretrainDraws:
    return PretrainDraws(
        draw_scale_crop(n0, ent.scale_range, generator),
        draw_soft_domain_label(n0, ent.n_domains, generator))


def draw_search(ent: Entities, n0: int, M: int, h: int, w: int,
                generator: torch.Generator) -> SearchDraws:
    return SearchDraws(
        draw_policy(n0, M, ent.ctrl_spec.Q, ent.ctrl_spec.L, h, w,
                    generator),
        draw_scale_crop(n0 * M, ent.scale_range, generator),
        draw_soft_domain_label(n0, ent.n_domains, generator))


def _flatten(batch):
    imgs, masks, dcs = batch
    n0 = imgs.shape[0] * imgs.shape[1]
    return (imgs.reshape(n0, *imgs.shape[2:]),
            masks.reshape(n0, *masks.shape[2:]), dcs.reshape(n0))


def _seg_metrics(seg_soft, y):
    """Thresholded samplewise F1, class-1 entry, per channel."""
    hard = (seg_soft > 0.5).float()
    return {"cup_dsc": samplewise_f1(hard[..., 0], y[..., 0])[1],
            "disc_dsc": samplewise_f1(hard[..., 1], y[..., 1])[1]}


def _forward_seg(ent: Entities, sd: SegDisState, x, y):
    with ent.autocast():
        logits, feat = sd.model(x)
    seg_soft = torch.sigmoid(logits)
    return seg_soft, bce_loss(seg_soft, y), feat


def make_pretrain_step(ent: Entities):
    """Warmup step: the un-augmented batch; the segmentation model trains
    with BCE, the online discriminator with soft CE on soft domain labels."""

    def step(sd: SegDisState, batch, draws: PretrainDraws):
        imgs, masks, dcs = _flatten(batch)
        x, y = ent.transform(imgs, masks, draws.crop)
        dc_soft = soft_domain_label(dcs, ent.n_domains, draws.soft)
        sd.model.train()
        sd.seg_opt.zero_grad()
        sd.dis_opt.zero_grad()
        seg_soft, seg_loss, feat = _forward_seg(ent, sd, x, y)
        dis_loss = soft_cross_entropy(sd.disc(feat.detach()), dc_soft)
        (seg_loss + dis_loss).backward()
        sd.seg_opt.step()
        sd.dis_opt.step()
        return {"seg_loss": seg_loss.detach(), "dis_loss": dis_loss.detach(),
                **_seg_metrics(seg_soft.detach(), y)}

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
            seg_soft, seg_loss, feat = _forward_seg(ent, sd, x, y)
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
                   **_seg_metrics(seg_soft.detach(), y)}
        return metrics, rewards

    return step

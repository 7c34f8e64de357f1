"""Losses of the search path (port of ``aadg_tpu/losses.py``: task BCE,
soft cross-entropy, REINFORCE, PPO's clipped surrogate, reward
normalization). The remaining losses wait for a later slice."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_loss(probs: torch.Tensor, targets: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities, mean reduction."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(p)
                       + (1.0 - targets) * torch.log1p(-p))


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                       reduction: str = "mean") -> torch.Tensor:
    """Cross entropy against soft (distribution) targets over dim 1."""
    summed = torch.sum(-soft_targets * F.log_softmax(logits, dim=1), dim=1)
    if reduction in ("avg", "mean"):
        return torch.mean(summed)
    if reduction == "sum":
        return torch.sum(summed)
    return summed


def reinforce_loss(log_probs: torch.Tensor, entropies: torch.Tensor,
                   reward: torch.Tensor, penalty: float):
    """REINFORCE with an entropy bonus; returns (loss, score_loss,
    entropy_penalty)."""
    score_loss = torch.mean(-log_probs * reward)
    entropy_penalty = torch.mean(entropies)
    return score_loss - penalty * entropy_penalty, score_loss, entropy_penalty


def ppo_surrogate_loss(curr_log_probs: torch.Tensor,
                       prev_log_probs: torch.Tensor, reward: torch.Tensor,
                       clip: float = 0.2) -> torch.Tensor:
    """One PPO clipped-surrogate evaluation."""
    ratios = torch.exp(curr_log_probs - prev_log_probs.detach())
    surr1 = ratios * reward
    surr2 = torch.clamp(ratios, 1.0 - clip, 1.0 + clip) * reward
    return torch.mean(-torch.minimum(surr1, surr2))


def normalize_rewards(rewards: torch.Tensor, eps: float = 1e-5
                      ) -> torch.Tensor:
    """(r - mean) / (population std + eps)."""
    return (rewards - torch.mean(rewards)) / (
        torch.std(rewards, correction=0) + eps)

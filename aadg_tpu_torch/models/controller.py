"""LSTM augmentation-policy controller (port of
``aadg_tpu/models/controller.py``).

A shared LSTMCell(32 -> 100) emits, for each of Q sub-policies (state reset
between them), L alternating (operation, magnitude) tokens; logits are
squashed ``C * tanh(logits) / T``. ``sample`` draws tokens (the categorical
draw takes a ``torch.Generator``, or ``forced_actions``), ``evaluate``
re-scores stored tokens for the PPO ratios. Every parameter starts
uniform(-0.1, 0.1), the output-head biases at zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
import torch.nn.functional as F


class ControllerSpec(NamedTuple):
    num_ops: int
    num_mags: int = 10
    Q: int = 5
    L: int = 2
    T: float = 2.0
    C: float = 2.5
    embedding_dim: int = 32
    hidden_dim: int = 100

    @property
    def tokens_per_policy(self) -> int:
        return self.Q * self.L * 2


def spec_from_config(cfg, num_ops: int) -> ControllerSpec:
    return ControllerSpec(num_ops=num_ops,
                          num_mags=cfg.CONTROLLER.NUM_MAGS,
                          L=cfg.CONTROLLER.L,
                          T=float(cfg.CONTROLLER.T),
                          C=float(cfg.CONTROLLER.C))


class Controller(nn.Module):
    def __init__(self, spec: ControllerSpec):
        super().__init__()
        self.spec = spec
        e, h = spec.embedding_dim, spec.hidden_dim
        self.embedding = nn.Parameter(
            torch.empty(spec.num_ops + spec.num_mags, e))
        self.lstm = nn.LSTMCell(e, h)
        self.outop = nn.Linear(h, spec.num_ops)
        self.outmag = nn.Linear(h, spec.num_mags)
        for p in self.parameters():
            nn.init.uniform_(p, -0.1, 0.1)
        nn.init.zeros_(self.outop.bias)
        nn.init.zeros_(self.outmag.bias)

    def _run(self, batch: int, generator: Optional[torch.Generator],
             forced: Optional[torch.Tensor]):
        spec = self.spec
        dev = self.embedding.device
        policies, log_probs, entropies = [], [], []
        op_probs, mag_probs = [], []
        step = 0
        for _ in range(spec.Q):
            inp = torch.zeros((batch, spec.embedding_dim), device=dev)
            h = torch.zeros((batch, spec.hidden_dim), device=dev)
            c = torch.zeros((batch, spec.hidden_dim), device=dev)
            for _ in range(spec.L):
                for head, probs_acc, offset in (
                        (self.outop, op_probs, 0),
                        (self.outmag, mag_probs, spec.num_ops)):
                    h, c = self.lstm(inp, (h, c))
                    z = spec.C * torch.tanh(head(h)) / spec.T
                    logp = F.log_softmax(z, dim=-1)
                    p = torch.exp(logp)
                    if forced is not None:
                        action = forced[:, step]
                    else:
                        action = torch.multinomial(
                            p.detach(), 1, generator=generator)[:, 0]
                    log_probs.append(
                        torch.gather(logp, 1, action[:, None])[:, 0])
                    entropies.append(-torch.sum(logp * p, dim=-1))
                    probs_acc.append(p)
                    policies.append(action)
                    inp = self.embedding[action + offset]
                    step += 1
        return policies, log_probs, entropies, op_probs, mag_probs

    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               forced_actions: Optional[torch.Tensor] = None):
        """Draw ``batch`` policies. Returns (policies (B, Q*L*2) int64,
        op_probs (num_ops,), mag_probs (num_mags,), log_probs (B,),
        entropies (B,)), probabilities averaged over batch and steps."""
        pol, lps, ents, ops, mags = self._run(batch, generator,
                                              forced_actions)
        return (torch.stack(pol, dim=-1),
                torch.mean(torch.stack(ops, dim=0), dim=(0, 1)),
                torch.mean(torch.stack(mags, dim=0), dim=(0, 1)),
                torch.sum(torch.stack(lps, dim=-1), dim=-1),
                torch.sum(torch.stack(ents, dim=-1), dim=-1))

    def evaluate(self, policies: torch.Tensor) -> torch.Tensor:
        """Teacher-forced summed log-probs (B,) of stored policies."""
        _, lps, _, _, _ = self._run(policies.shape[0], None, policies)
        return torch.sum(torch.stack(lps, dim=-1), dim=-1)


def policies_to_tensor(policies: torch.Tensor,
                       spec: ControllerSpec) -> torch.Tensor:
    """(B, Q*L*2) tokens -> (B, Q, L, 2) (op_idx, mag_idx)."""
    return policies.reshape(policies.shape[0], spec.Q, spec.L, 2)

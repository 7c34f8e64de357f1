"""Controller updates (port of ``aadg_tpu/engine/rl.py``): PPO with 5
clipped-surrogate steps against the sample-time log-probs, or one
REINFORCE step with an entropy bonus."""

from __future__ import annotations

import torch

from ..losses import ppo_surrogate_loss, reinforce_loss
from .state import CtrlState


def make_controller_update(loss_name: str, penalty: float, clip: float = 0.2,
                           n_inner: int = 5):
    def reinforce_update(cs: CtrlState, policies, log_probs, entropies,
                         rewards):
        cs.opt.zero_grad()
        lp = cs.controller.evaluate(policies)
        loss, score, ent_pen = reinforce_loss(lp, entropies.detach(),
                                              rewards, penalty)
        loss.backward()
        cs.opt.step()
        return {"controller_loss": loss.detach(), "score_loss": score.detach(),
                "entropy_penalty": ent_pen.detach()}

    def ppo_update(cs: CtrlState, policies, log_probs, entropies, rewards):
        prev_lp = log_probs.detach()
        losses = []
        for _ in range(n_inner):
            cs.opt.zero_grad()
            loss = ppo_surrogate_loss(cs.controller.evaluate(policies),
                                      prev_lp, rewards, clip)
            loss.backward()
            cs.opt.step()
            losses.append(loss.detach())
        mean_loss = torch.mean(torch.stack(losses))
        return {"controller_loss": mean_loss, "score_loss": mean_loss,
                "entropy_penalty": torch.mean(entropies.detach())}

    if loss_name == "reinforce":
        return reinforce_update
    if loss_name == "ppo":
        return ppo_update
    raise NotImplementedError(f"{loss_name} is unavailable")

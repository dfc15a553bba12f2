"""Training targets of a self-play segment, as the configuration defines them.

For a segment of T moves of B games (rewards r, root search values ν, the
stored length L of each game's segment, whether it ended inside it):

- policy target: the root visit distribution w over the legal actions as
  softmax(log(w + 1e-8)) over all actions;
- TD(λ) return: G_t = r_t + γ[(1−λ) ν_{t+1} + λ G_{t+1}] back from the end,
  G = r at the last move of a finished game, G_{L−1} = ν_{L−1} at the last
  move of a segment cut off mid-game, 0 past L;
- value target: ν (``value_target_mode`` "search") or the TD(λ) return;
- priority: |h(ν_t) − h(G_t)| with the configuration's λ, at least 1e-3
  inside the segment, 0 outside;
- cross-segment backfill: once the next segment of a cut-off game is
  played, its last target becomes r_{L−1} + γ[(1−λ) ν_0' + λ z_0'] (ν_0',
  z_0' the next segment's first search value and target), every target
  moves by (γλ)^{L−1−t} times that change, and each priority is raised to
  at least the h-space move of its target.

The stored copies are rounded (policies float16; rewards, values and
priorities bfloat16), and backfill reads the stored values and rewards.
"""

from __future__ import annotations

import torch

STORED = {"policies": torch.float16, "values": torch.bfloat16, "rewards": torch.bfloat16,
          "priorities": torch.bfloat16}  # fmt: skip


def h(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1) - 1) + eps * x


def policy_targets(visits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """(..., A) policy targets of root visit counts over the legal actions."""
    w = visits.float() / torch.clamp_min(visits.float().sum(-1, keepdim=True), 1.0)
    logits = torch.log(torch.where(legal, w, torch.zeros_like(w)) + 1e-8)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def td_returns(rewards, values, lengths, terminated, gamma: float, lam: float) -> torch.Tensor:
    """(B, T) TD(λ) returns of rewards and search values."""
    b, t_max = rewards.shape
    out = torch.zeros_like(rewards)
    g = torch.zeros(b, dtype=rewards.dtype, device=rewards.device)
    for t in reversed(range(t_max)):
        v_next = values[:, t + 1] if t + 1 < t_max else torch.zeros_like(g)
        v_next = torch.where(t + 1 < lengths, v_next, torch.zeros_like(v_next))
        g = rewards[:, t] + gamma * ((1 - lam) * v_next + lam * g)
        g = torch.where((t + 1 == lengths) & ~terminated, values[:, t], g)
        g = torch.where(t < lengths, g, torch.zeros_like(g))
        out[:, t] = g
    return out


def segment_targets(config: dict, rewards, values, lengths, terminated) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 (value targets, priorities) of a segment as collected (before any backfill)."""
    gamma, lam, eps = config["discount"], config["td_lambda"], config["value_epsilon"]
    in_ep = torch.arange(rewards.shape[1], device=rewards.device)[None, :] < lengths[:, None]
    returns = td_returns(rewards, values, lengths, terminated, gamma, lam)
    priorities = torch.abs(h(values, eps) - h(returns, eps))
    priorities = torch.where(in_ep, torch.clamp_min(priorities, 1e-3), torch.zeros_like(priorities))
    targets = returns if config["value_target_mode"] == "td_lambda" else values
    return targets, priorities


def backfill(config: dict, stored_values, stored_rewards, stored_priorities, lengths, cut_off, nu0_next, z0_next):
    """(values, priorities) of a stored segment after its successor's backfill.
    The inputs are as stored (rounded) and come back float32."""
    gamma, lam, eps = config["discount"], config["td_lambda"], config["value_epsilon"]
    t_max = stored_values.shape[1]
    old = stored_values.float()
    last = torch.clamp_min(lengths - 1, 0).long()
    z_last = old.gather(-1, last[:, None])[:, 0]
    r_last = stored_rewards.float().gather(-1, last[:, None])[:, 0]
    boundary = r_last + gamma * ((1.0 - lam) * nu0_next + lam * z0_next)
    delta = torch.where(cut_off, boundary - z_last, torch.zeros_like(z_last))
    steps = torch.arange(t_max, device=old.device)[None, :]
    in_ep = steps < lengths[:, None]
    base = torch.full((), gamma * lam, dtype=torch.float32, device=old.device)
    factor = torch.where(in_ep, torch.pow(base, (last[:, None] - steps).float()), torch.zeros_like(old))
    new = old + factor * delta[:, None]
    shift = torch.abs(h(new, eps) - h(old, eps))
    prios = stored_priorities.float()
    return new, torch.where(in_ep, torch.maximum(prios, shift), prios)

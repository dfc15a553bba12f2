"""The six Stochastic MuZero networks, in PyTorch.

Port of the JAX package's ``models/muzero.py`` (scalar heads only):

- ``Representation``       h:  observation → hidden state
- ``Prediction``           f:  hidden → (policy logits, value)
- ``AfterstateDynamics``   φ:  (hidden, action one-hot) → afterstate
- ``AfterstatePrediction`` ψ:  afterstate → (Q value, chance logits)
- ``Dynamics``             g:  (afterstate, chance one-hot) → (hidden, reward)
- ``Encoder``              e:  observation → one-hot chance code

Trunks run in ``compute_dtype``; heads run and return float32. Categorical
heads (``value_bins``/``reward_bins`` > 1) are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from simulate_2048_tpu_torch.models.blocks import Dense, TowerWithHead

ONEHOT_DEPTH = 16  # exponents 0..15 cover tiles up to 32768


def _scalar_heads_only(value_bins: int) -> None:
    if value_bins != 1:
        raise NotImplementedError("categorical value/reward heads (bins > 1) are not ported yet")


def expand_observation(observation: torch.Tensor, onehot: bool) -> torch.Tensor:
    """Optionally lift the exponent/16 observation to per-cell 16-way one-hots."""
    if not onehot:
        return observation
    exps = torch.round(observation * 16.0).to(torch.int64)
    oh = torch.nn.functional.one_hot(exps, ONEHOT_DEPTH).to(observation.dtype)
    return oh.flatten(-2)


class Representation(nn.Module):
    """h: observation → hidden state."""

    def __init__(self, observation_dim: int, hidden_size: int, num_blocks: int, compute_dtype, onehot_input=False):
        super().__init__()
        self.onehot_input = onehot_input
        in_features = observation_dim * (ONEHOT_DEPTH if onehot_input else 1)
        self.trunk = TowerWithHead(in_features, hidden_size, num_blocks, compute_dtype)
        self.hidden_state = Dense(hidden_size, hidden_size)

    def forward(self, observation: torch.Tensor) -> torch.Tensor:
        return self.hidden_state(self.trunk(expand_observation(observation, self.onehot_input)))


class Prediction(nn.Module):
    """f: hidden → (policy logits, value)."""

    def __init__(self, action_size: int, hidden_size: int, num_blocks: int, compute_dtype, value_bins: int = 1):
        super().__init__()
        _scalar_heads_only(value_bins)
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.policy_logits = Dense(hidden_size, action_size)
        self.value = Dense(hidden_size, 1)

    def forward(self, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(state)
        return self.policy_logits(x), self.value(x).squeeze(-1)


class AfterstateDynamics(nn.Module):
    """φ: (hidden, action one-hot) → afterstate; inputs fuse by projected addition."""

    def __init__(self, hidden_size: int, action_size: int, num_blocks: int, compute_dtype):
        super().__init__()
        self.state_proj = Dense(hidden_size, hidden_size, compute_dtype)
        self.action_proj = Dense(action_size, hidden_size, compute_dtype)
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.afterstate = Dense(hidden_size, hidden_size)

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        fused = self.state_proj(state) + self.action_proj(action)
        return self.afterstate(self.trunk(fused))


class AfterstatePrediction(nn.Module):
    """ψ: afterstate → (Q value, chance logits)."""

    def __init__(self, codebook_size: int, hidden_size: int, num_blocks: int, compute_dtype, value_bins: int = 1):
        super().__init__()
        _scalar_heads_only(value_bins)
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.chance_logits = Dense(hidden_size, codebook_size)
        self.q_value = Dense(hidden_size, 1)

    def forward(self, afterstate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(afterstate)
        return self.q_value(x).squeeze(-1), self.chance_logits(x)


class Dynamics(nn.Module):
    """g: (afterstate, chance one-hot) → (next hidden, reward)."""

    def __init__(self, hidden_size: int, codebook_size: int, num_blocks: int, compute_dtype, reward_bins: int = 1):
        super().__init__()
        _scalar_heads_only(reward_bins)
        self.state_proj = Dense(hidden_size, hidden_size, compute_dtype)
        self.chance_proj = Dense(codebook_size, hidden_size, compute_dtype)
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.next_state = Dense(hidden_size, hidden_size)
        self.reward = Dense(hidden_size, 1)

    def forward(self, afterstate: torch.Tensor, chance_code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        fused = self.state_proj(afterstate) + self.chance_proj(chance_code)
        x = self.trunk(fused)
        return self.next_state(x), self.reward(x).squeeze(-1)


class Encoder(nn.Module):
    """e: observation → one-hot chance code (straight-through argmax when deterministic)."""

    def __init__(self, observation_dim: int, codebook_size: int, hidden_size: int, num_blocks: int, compute_dtype,
                 onehot_input=False):
        super().__init__()
        self.onehot_input = onehot_input
        in_features = observation_dim * (ONEHOT_DEPTH if onehot_input else 1)
        self.trunk = TowerWithHead(in_features, hidden_size, num_blocks, compute_dtype)
        self.chance_logits = Dense(hidden_size, codebook_size)

    def forward(self, observation: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = self.trunk(expand_observation(observation, self.onehot_input))
        logits = self.chance_logits(x)
        if deterministic:
            one_hot = torch.nn.functional.one_hot(logits.argmax(-1), logits.shape[-1]).to(logits.dtype)
            return logits - logits.detach() + one_hot
        return torch.softmax(logits, dim=-1)

"""The six Stochastic MuZero networks, in PyTorch.

Port of the JAX package's ``models/muzero.py``:

- ``Representation``       h:  observation → hidden state
- ``Prediction``           f:  hidden → (policy logits, value)
- ``AfterstateDynamics``   φ:  (hidden, action one-hot) → afterstate
- ``AfterstatePrediction`` ψ:  afterstate → (Q value, chance logits)
- ``Dynamics``             g:  (afterstate, chance one-hot) → (hidden, reward)
- ``Encoder``              e:  observation → one-hot chance code

Trunks run in ``compute_dtype``; heads run and return float32. With
``value_bins``/``reward_bins`` > 1 the value, Q and reward heads are
categorical over an h-space support (``ops/distributional.py``): ``forward``
then returns the support expectation, so search, evaluation and priorities
see an h-space scalar whatever the head is, and ``logits`` returns the raw
bin logits that the cross-entropy losses take. With scalar heads ``logits``
is ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from simulate_2048_tpu_torch.models.blocks import Dense, TowerWithHead
from simulate_2048_tpu_torch.ops.distributional import expectation

ONEHOT_DEPTH = 16  # exponents 0..15 cover tiles up to 32768


class CategoricalHead(Dense):
    """Final layer of a categorical value/reward head. Fresh weights are zero
    and the bias is 0 on atom 0 and -14 elsewhere, so the initial expectation
    is about 0 like a scalar head's, not the midpoint of the support."""

    @torch.no_grad()
    def init_weights(self, key: torch.Tensor | None = None) -> None:
        self.weight.zero_()
        self.bias.fill_(-14.0)
        self.bias[0] = 0.0


def _value_head(hidden_size: int, bins: int) -> Dense:
    return Dense(hidden_size, 1) if bins == 1 else CategoricalHead(hidden_size, bins)


def _head_output(head: Dense, x: torch.Tensor, bins: int) -> torch.Tensor:
    """Scalar head → (...,) h-space scalar; categorical head → (..., bins) logits."""
    return head(x).squeeze(-1) if bins == 1 else head(x)


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

    def __init__(self, action_size: int, hidden_size: int, num_blocks: int, compute_dtype, value_bins: int = 1,
                 value_support_max: float = 320.0):
        super().__init__()
        self.value_bins, self.value_support_max = value_bins, value_support_max
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.policy_logits = Dense(hidden_size, action_size)
        self.value = _value_head(hidden_size, value_bins)

    def logits(self, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(state)
        return self.policy_logits(x), _head_output(self.value, x, self.value_bins)

    def forward(self, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        policy_logits, value = self.logits(state)
        if self.value_bins > 1:
            value = expectation(value, self.value_support_max)
        return policy_logits, value


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

    def __init__(self, codebook_size: int, hidden_size: int, num_blocks: int, compute_dtype, value_bins: int = 1,
                 value_support_max: float = 320.0):
        super().__init__()
        self.value_bins, self.value_support_max = value_bins, value_support_max
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.chance_logits = Dense(hidden_size, codebook_size)
        self.q_value = _value_head(hidden_size, value_bins)

    def logits(self, afterstate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(afterstate)
        return _head_output(self.q_value, x, self.value_bins), self.chance_logits(x)

    def forward(self, afterstate: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        q_value, chance_logits = self.logits(afterstate)
        if self.value_bins > 1:
            q_value = expectation(q_value, self.value_support_max)
        return q_value, chance_logits


class Dynamics(nn.Module):
    """g: (afterstate, chance one-hot) → (next hidden, reward)."""

    def __init__(self, hidden_size: int, codebook_size: int, num_blocks: int, compute_dtype, reward_bins: int = 1,
                 reward_support_max: float = 100.0):
        super().__init__()
        self.reward_bins, self.reward_support_max = reward_bins, reward_support_max
        self.state_proj = Dense(hidden_size, hidden_size, compute_dtype)
        self.chance_proj = Dense(codebook_size, hidden_size, compute_dtype)
        self.trunk = TowerWithHead(hidden_size, hidden_size, num_blocks, compute_dtype)
        self.next_state = Dense(hidden_size, hidden_size)
        self.reward = _value_head(hidden_size, reward_bins)

    def logits(self, afterstate: torch.Tensor, chance_code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        fused = self.state_proj(afterstate) + self.chance_proj(chance_code)
        x = self.trunk(fused)
        return self.next_state(x), _head_output(self.reward, x, self.reward_bins)

    def forward(self, afterstate: torch.Tensor, chance_code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        next_state, reward = self.logits(afterstate, chance_code)
        if self.reward_bins > 1:
            reward = expectation(reward, self.reward_support_max)
        return next_state, reward


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

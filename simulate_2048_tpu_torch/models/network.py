"""Network bundle: the six networks of one agent as one ``nn.Module``.

Port of the JAX package's ``models/network.py`` (``create_network``) and of
``training/learner.py``'s ``network_from_config``. Where the JAX package
pairs parameter trees with apply functions, the port's modules carry their
own parameters and are called directly.
"""

from __future__ import annotations

import torch
from torch import nn

from simulate_2048_tpu_torch.models.blocks import Dense
from simulate_2048_tpu_torch.models.muzero import (
    AfterstateDynamics,
    AfterstatePrediction,
    Dynamics,
    Encoder,
    Prediction,
    Representation,
)
from simulate_2048_tpu_torch.training.config import TrainConfig


class MuZeroNetwork(nn.Module):
    """h, f, φ, ψ, g and e, plus the architecture they were built with."""

    def __init__(
        self,
        observation_dim: int = 16,
        action_size: int = 4,
        codebook_size: int = 32,
        hidden_size: int = 256,
        num_blocks: int = 10,
        compute_dtype: torch.dtype = torch.float32,
        observation_onehot: bool = False,
        value_bins: int = 1,
        reward_bins: int = 1,
        value_support_max: float = 320.0,
        reward_support_max: float = 100.0,
    ):
        super().__init__()
        self.observation_dim = observation_dim
        self.action_size = action_size
        self.codebook_size = codebook_size
        self.hidden_size = hidden_size
        self.num_blocks = num_blocks
        self.compute_dtype = compute_dtype
        self.value_bins = value_bins
        self.reward_bins = reward_bins
        self.value_support_max = value_support_max
        self.reward_support_max = reward_support_max
        h, nb, cd = hidden_size, num_blocks, compute_dtype
        self.representation = Representation(observation_dim, h, nb, cd, observation_onehot)
        self.prediction = Prediction(action_size, h, nb, cd, value_bins, value_support_max)
        self.afterstate_dynamics = AfterstateDynamics(h, action_size, nb, cd)
        self.afterstate_prediction = AfterstatePrediction(codebook_size, h, nb, cd, value_bins, value_support_max)
        self.dynamics = Dynamics(h, codebook_size, nb, cd, reward_bins, reward_support_max)
        self.encoder = Encoder(observation_dim, codebook_size, h, nb, cd, observation_onehot)

    def init_weights(self, generator: torch.Generator) -> "MuZeroNetwork":
        """Fresh weights drawn from ``generator`` with Flax's default init."""
        for module in self.modules():
            if isinstance(module, Dense):
                module.reset_parameters(generator)
        return self


def architecture_from_config(config: TrainConfig) -> MuZeroNetwork:
    """The network a ``TrainConfig`` describes, on the CPU, weights unset."""
    return MuZeroNetwork(
        observation_dim=config.observation_dim,
        action_size=config.action_size,
        codebook_size=config.codebook_size,
        hidden_size=config.hidden_size,
        num_blocks=config.num_residual_blocks,
        compute_dtype=torch.bfloat16 if config.use_bfloat16 else torch.float32,
        observation_onehot=config.observation_onehot,
        value_bins=config.value_bins,
        reward_bins=config.reward_bins,
        value_support_max=config.value_support_max,
        reward_support_max=config.reward_support_max,
    )


def network_from_config(
    config: TrainConfig, generator: torch.Generator | None = None, device: torch.device | str = "cpu"
) -> MuZeroNetwork:
    """Build the network a ``TrainConfig`` describes, with weights from
    ``generator`` (a fresh ``torch.Generator`` seeded with ``config.seed``
    when None), on ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    return architecture_from_config(config).init_weights(generator).to(device)

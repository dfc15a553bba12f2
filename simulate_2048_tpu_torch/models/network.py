"""Network bundle: the six networks of one agent as one ``nn.Module``.

Port of the JAX package's ``models/network.py`` (``create_network``) and of
``training/learner.py``'s ``network_from_config``. Where the JAX package
pairs parameter trees with apply functions, the port's modules carry their
own parameters and are called directly.

``flax_layout`` names the Flax module behind each of the port's layers; it
is the one map between the two, read by ``init_weights`` (each layer drawn
from the key Flax hands it, so a key gives the JAX package's network) and by
``convert.params_from_flax``.
"""

from __future__ import annotations

from collections.abc import Iterator

import torch
from torch import nn

from simulate_2048_tpu_torch.models.blocks import Dense, LayerNorm, TowerWithHead
from simulate_2048_tpu_torch.models.muzero import (
    AfterstateDynamics,
    AfterstatePrediction,
    Dynamics,
    Encoder,
    Prediction,
    Representation,
)
from simulate_2048_tpu_torch.ops import rng
from simulate_2048_tpu_torch.training.config import TrainConfig

# The six networks, in the order of JAX's ``NetworkParams`` and of its init keys.
NETWORK_NAMES = (
    "representation",
    "prediction",
    "afterstate_dynamics",
    "afterstate_prediction",
    "dynamics",
    "encoder",
)


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

    def init_weights(self, key: torch.Tensor) -> "MuZeroNetwork":
        """The weights JAX's ``create_network(key, ...)`` draws: network i
        from ``split(key, 6)[i]``, each layer from Flax's key for its module
        path (``rng.fold_in_path(..., 1)``, its first draw). Drawn on the CPU."""
        keys = rng.split(key.cpu(), len(NETWORK_NAMES))
        for net, path, module in flax_layout(self):
            module.init_weights(rng.fold_in_path(keys[net], path, 1))
        return self


def _tower_layout(tower: TowerWithHead) -> Iterator[tuple[tuple[str, ...], nn.Module]]:
    yield ("TowerWithHead_0", "Dense_0"), tower.proj
    for i, block in enumerate(tower.tower.blocks):
        prefix = ("TowerWithHead_0", "ResidualTower_0", f"DenseResidualBlock_{i}")
        yield prefix + ("LayerNorm_0",), block.norm1
        yield prefix + ("Dense_0",), block.fc1
        yield prefix + ("LayerNorm_1",), block.norm2
        yield prefix + ("Dense_1",), block.fc2
    yield ("TowerWithHead_0", "LayerNorm_0"), tower.norm


def flax_layout(net: MuZeroNetwork) -> Iterator[tuple[int, tuple[str, ...], Dense | LayerNorm]]:
    """``(network index, Flax module path, port layer)`` for every layer of
    ``net``: the index into ``NETWORK_NAMES``, and the path below that
    network's root module (``models/muzero.py`` and ``models/blocks.py`` of
    the JAX package name them)."""
    rep, pred, phi = net.representation, net.prediction, net.afterstate_dynamics
    psi, g, enc = net.afterstate_prediction, net.dynamics, net.encoder
    heads = (
        {"hidden_state": rep.hidden_state},
        {"policy_logits": pred.policy_logits, "value": pred.value},
        {"Dense_0": phi.state_proj, "Dense_1": phi.action_proj, "afterstate": phi.afterstate},
        {"chance_logits": psi.chance_logits, "q_value": psi.q_value},
        {"Dense_0": g.state_proj, "Dense_1": g.chance_proj, "next_state": g.next_state, "reward": g.reward},
        {"chance_logits": enc.chance_logits},
    )
    for i, (name, named_heads) in enumerate(zip(NETWORK_NAMES, heads)):
        for path, layer in _tower_layout(getattr(net, name).trunk):
            yield i, path, layer
        for head, layer in named_heads.items():
            yield i, (head,), layer


def architecture_from_config(config: TrainConfig) -> MuZeroNetwork:
    """The network a ``TrainConfig`` describes, on the CPU, weights unset (zeros, LayerNorm scales one)."""
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


def network_from_config(config: TrainConfig, key: torch.Tensor, device: torch.device | str = "cpu") -> MuZeroNetwork:
    """The network a ``TrainConfig`` describes, with the weights that JAX's
    ``network_from_config(key, config)`` draws, on ``device``."""
    return architecture_from_config(config).init_weights(key).to(device)

"""Shared building blocks: pre-activation dense residual tower, in PyTorch.

Port of the JAX package's ``models/blocks.py`` with Flax's numerics:

- :class:`Dense` is Flax ``Dense(dtype=compute_dtype)``: input, weight and
  bias are cast to the compute dtype and the output stays in it. Weights are
  stored ``(out, in)`` as ``nn.Linear`` does (Flax kernels are ``(in, out)``;
  ``convert.py`` transposes).
- :class:`LayerNorm` is Flax ``LayerNorm(dtype=float32)``: statistics in
  float32 with ``epsilon=1e-6`` and Flax's fast variance
  ``max(0, E[x²] − E[x]²)``, scale folded into the reciprocal std.

Parameters are allocated as zeros and drawn by nothing at construction:
``init_weights(key)`` sets each layer as Flax initialises it, from the key
that Flax hands the layer (``MuZeroNetwork.init_weights``).
"""

from __future__ import annotations

import torch
from torch import nn

from simulate_2048_tpu_torch.ops import rng


class Dense(nn.Module):
    """A float32 ``(out, in)`` weight and bias, computed in ``compute_dtype`` (Flax ``Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    @torch.no_grad()
    def init_weights(self, key: torch.Tensor) -> None:
        """Flax's default init from the layer's ``key``: the ``(in, out)``
        kernel LeCun-normal, truncated at ±2 standard normals
        (``variance_scaling(1, "fan_in", "truncated_normal")``), zero bias."""
        std = torch.sqrt(torch.tensor(1.0 / self.in_features, dtype=torch.float32))
        std = std / torch.tensor(0.87962566103423978, dtype=torch.float32)
        kernel = rng.truncated_normal(key, -2.0, 2.0, (self.in_features, self.out_features)) * std
        self.weight.copy_(kernel.t())
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """Flax ``LayerNorm`` over the last axis, computed and returned in float32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_weights(self, key: torch.Tensor | None = None) -> None:
        """Flax's LayerNorm init: scale one, bias zero (no draw)."""
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class DenseResidualBlock(nn.Module):
    """LayerNorm → ReLU → Dense → LayerNorm → ReLU → Dense → + residual."""

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(features)
        self.fc1 = Dense(features, features, compute_dtype)
        self.norm2 = LayerNorm(features)
        self.fc2 = Dense(features, features, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.fc1(torch.relu(self.norm1(x)))
        x = self.fc2(torch.relu(self.norm2(x)))
        return x + residual


class ResidualTower(nn.Module):
    """Stack of :class:`DenseResidualBlock`."""

    def __init__(self, num_blocks: int, features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(DenseResidualBlock(features, compute_dtype) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class TowerWithHead(nn.Module):
    """Project → residual tower → LayerNorm → ReLU trunk shared by every network."""

    def __init__(
        self, in_features: int, hidden_size: int, num_blocks: int, compute_dtype: torch.dtype = torch.float32
    ):
        super().__init__()
        self.proj = Dense(in_features, hidden_size, compute_dtype)
        self.tower = ResidualTower(num_blocks, hidden_size, compute_dtype)
        self.norm = LayerNorm(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.norm(self.tower(self.proj(x))))

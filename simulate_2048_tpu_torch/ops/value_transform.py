"""MuZero value scaling h / h⁻¹, in PyTorch.

h(x) = sign(x)(√(|x|+1) − 1) + εx. Networks predict in h-space; the search
passes their value and reward outputs through h⁻¹ before its linear
r + γ·v backups.
"""

from __future__ import annotations

import torch


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a correctly rounded float division on every device.

    PyTorch's CUDA kernel turns a division by a Python scalar into a
    multiplication by its reciprocal (one ulp off); dividing by a 0-d tensor
    on ``x``'s device keeps the true division that the CPU, the JAX package
    and the CUDA kernels compute.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def scale_value(value: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    """h(x) = sign(x)(√(|x|+1) − 1) + εx."""
    return torch.sign(value) * (torch.sqrt(torch.abs(value) + 1) - 1) + epsilon * value


def inverse_scale_value(scaled: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    """h⁻¹, in the same operation order as the JAX package."""
    inside = 1 + 4 * epsilon * (torch.abs(scaled) + 1 + epsilon)
    return torch.sign(scaled) * (torch.square(div_scalar(torch.sqrt(inside) - 1, 2 * epsilon)) - 1)

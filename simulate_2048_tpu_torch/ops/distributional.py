"""Categorical (two-hot) value/reward representation over an h-space support,
in PyTorch (port of the JAX package's ``ops/distributional.py``).

A categorical head emits logits over ``num_bins`` evenly spaced atoms on
``[0, support_max]`` (h-space, see ``ops/value_transform.py``) and trains with
cross-entropy toward a two-hot target: the target scalar's mass split between
its two neighbouring atoms so that the expectation is exact. Targets beyond
``support_max`` clip to the last atom. The scalar-facing network API returns
:func:`expectation` of the logits, so search, evaluation and priorities see
an h-space scalar whatever the head is.
"""

from __future__ import annotations

import torch


def support_atoms(num_bins: int, support_max: float, device=None) -> torch.Tensor:
    """The ``num_bins`` evenly spaced h-space atoms on [0, support_max]:
    ``i · step`` in float32 with ``step = support_max / (num_bins − 1)``, as
    the search kernel computes them."""
    step = torch.full((), support_max / (num_bins - 1), dtype=torch.float32, device=device)
    return torch.arange(num_bins, dtype=torch.float32, device=device) * step


def two_hot(scalar_h: torch.Tensor, num_bins: int, support_max: float) -> torch.Tensor:
    """Two-hot encode h-space scalars onto the support; the encoding's
    expectation equals the clipped scalar. Shape ``scalar_h.shape + (num_bins,)``."""
    step = support_max / (num_bins - 1)
    x = torch.clamp(scalar_h, 0.0, support_max) / step
    low = torch.floor(x)
    frac = x - low
    low_idx = low.to(torch.int64)
    high_idx = torch.clamp_max(low_idx + 1, num_bins - 1)
    one_hot = torch.nn.functional.one_hot
    lo = one_hot(low_idx, num_bins).to(torch.float32) * (1.0 - frac)[..., None]
    hi = one_hot(high_idx, num_bins).to(torch.float32) * frac[..., None]
    return lo + hi


def expectation(logits: torch.Tensor, support_max: float) -> torch.Tensor:
    """softmax(logits) · atoms: the h-space scalar a categorical head represents."""
    probs = torch.softmax(logits, dim=-1)
    return probs @ support_atoms(logits.shape[-1], support_max, logits.device)


def categorical_loss(logits: torch.Tensor, target_h: torch.Tensor, support_max: float) -> torch.Tensor:
    """Cross-entropy between the head's logits and ``two_hot(target_h)``."""
    target = two_hot(target_h, logits.shape[-1], support_max)
    return -(target * torch.log_softmax(logits, dim=-1)).sum(-1)

"""The benchmark's weights: drawn on the run's device from a seed (the
configuration's ``weights_seed``).

One ``torch.Generator`` on the device, one normal draw for every parameter
at once, then each layer scaled in place: a dense weight (out, in) by
1/√in (LeCun normal), a bias by 0.1, a LayerNorm scale as 1 + 0.1·N and its
bias by 0.1. Biases and LayerNorms are not left at their usual init (zero,
one) so that the comparison sees them. The same dict goes to the program
(``load_state_dict``) and to the reference.
"""

from __future__ import annotations

import torch

# Streams drawn from one seed, so that weights, games and samples never share draws.
WEIGHTS, GAMES, SAMPLE = 0, 1, 2


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A generator seed for ``stream`` (and ``index`` within it) of run ``seed``, below 2**63."""
    return (int(seed) * 1_000_003 + stream * 7_919 + index) % (1 << 63)


@torch.no_grad()
def draw(shapes: dict[str, torch.Size], seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """float32 weights of ``shapes`` (parameter name → shape), from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    total = sum(s.numel() for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        x = flat[at : at + shape.numel()].view(shape)
        at += shape.numel()
        if len(shape) == 2:
            x.mul_(1.0 / shape[1] ** 0.5)
        elif ".norm" in name and name.endswith(".weight"):
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(0.1)
        out[name] = x
    return out

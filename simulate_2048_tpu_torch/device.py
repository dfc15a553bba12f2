"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` when ``device`` is None.

    Raises instead of carrying on on the CPU when CUDA is asked for (or
    defaulted to) and no GPU is present; pass ``device="cpu"`` to run on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; this entry point runs on the GPU by default "
            "(pass --device cpu / device='cpu' to run on the CPU)"
        )
    return device

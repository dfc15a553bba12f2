"""Load the JAX package's Flax parameters into the port's networks.

``params_from_flax`` takes the JAX package's ``NetworkParams`` as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; a plain mapping
of the six network names works too) and returns a :class:`MuZeroNetwork`
that computes the same functions. Flax stores Dense kernels ``(in, out)``
and LayerNorm ``scale``; the port stores weights ``(out, in)``, as
``nn.Linear`` does, and ``weight``; a categorical head's ``(H, bins)``
kernel crosses the same way. Which Flax module feeds which layer is
``models/network.py``'s ``flax_layout``, the map the port's init reads too.
Every parameter of the port is written exactly once, and a shape mismatch
raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from simulate_2048_tpu_torch.models.blocks import LayerNorm
from simulate_2048_tpu_torch.models.network import NETWORK_NAMES, architecture_from_config, flax_layout
from simulate_2048_tpu_torch.training.config import TrainConfig


def _copy(dst: torch.Tensor, src: Any, written: set[int]) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: port {tuple(dst.shape)} vs Flax {tuple(src.shape)}")
    dst.copy_(src)
    written.add(id(dst))


def _unwrap(tree: Any, name: str) -> Mapping:
    p = tree[name] if isinstance(tree, Mapping) else getattr(tree, name)
    return p["params"] if "params" in p else p


def params_from_flax(tree: Any, config: TrainConfig):
    """Flax ``NetworkParams`` (numpy leaves) → a CPU :class:`MuZeroNetwork` for ``config``."""
    net = architecture_from_config(config)
    trees = [_unwrap(tree, name) for name in NETWORK_NAMES]
    w: set[int] = set()
    with torch.no_grad():
        for i, path, layer in flax_layout(net):
            p = trees[i]
            for name in path:
                p = p[name]
            if isinstance(layer, LayerNorm):
                _copy(layer.weight, p["scale"], w)
            else:
                _copy(layer.weight, np.asarray(p["kernel"]).T, w)
            _copy(layer.bias, p["bias"], w)
    missing = [name for name, t in net.named_parameters() if id(t) not in w]
    if missing:
        raise ValueError(f"parameters not covered by the Flax tree: {missing}")
    return net

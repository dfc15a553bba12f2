"""Load the JAX package's Flax parameters into the port's networks.

``params_from_flax`` takes the JAX package's ``NetworkParams`` as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``; a plain mapping
of the six network names works too) and returns a :class:`MuZeroNetwork`
that computes the same functions. Flax stores Dense kernels ``(in, out)``
and LayerNorm ``scale``; the port stores ``nn.Linear`` weights ``(out, in)``
and ``weight``; a categorical head's ``(H, bins)`` kernel crosses the same
way. Every parameter of the port is written exactly once, and a
shape mismatch raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from simulate_2048_tpu_torch.models.blocks import LayerNorm, TowerWithHead
from simulate_2048_tpu_torch.models.network import architecture_from_config
from simulate_2048_tpu_torch.training.config import TrainConfig

NETWORK_NAMES = (
    "representation",
    "prediction",
    "afterstate_dynamics",
    "afterstate_prediction",
    "dynamics",
    "encoder",
)


def _copy(dst: torch.Tensor, src: Any, written: set[int]) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: port {tuple(dst.shape)} vs Flax {tuple(src.shape)}")
    dst.copy_(src)
    written.add(id(dst))


def _dense(lin: torch.nn.Linear, p: Mapping, written: set[int]) -> None:
    _copy(lin.weight, np.asarray(p["kernel"]).T, written)
    _copy(lin.bias, p["bias"], written)


def _norm(ln: LayerNorm, p: Mapping, written: set[int]) -> None:
    _copy(ln.weight, p["scale"], written)
    _copy(ln.bias, p["bias"], written)


def _tower(tw: TowerWithHead, p: Mapping, written: set[int]) -> None:
    _dense(tw.proj, p["Dense_0"], written)
    for i, block in enumerate(tw.tower.blocks):
        bp = p["ResidualTower_0"][f"DenseResidualBlock_{i}"]
        _norm(block.norm1, bp["LayerNorm_0"], written)
        _dense(block.fc1, bp["Dense_0"], written)
        _norm(block.norm2, bp["LayerNorm_1"], written)
        _dense(block.fc2, bp["Dense_1"], written)
    _norm(tw.norm, p["LayerNorm_0"], written)


def _unwrap(tree: Any, name: str) -> Mapping:
    p = tree[name] if isinstance(tree, Mapping) else getattr(tree, name)
    return p["params"] if "params" in p else p


def params_from_flax(tree: Any, config: TrainConfig):
    """Flax ``NetworkParams`` (numpy leaves) → a CPU :class:`MuZeroNetwork` for ``config``."""
    net = architecture_from_config(config)
    p = {name: _unwrap(tree, name) for name in NETWORK_NAMES}
    w: set[int] = set()
    with torch.no_grad():
        rep = net.representation
        _tower(rep.trunk, p["representation"]["TowerWithHead_0"], w)
        _dense(rep.hidden_state, p["representation"]["hidden_state"], w)

        pred = net.prediction
        _tower(pred.trunk, p["prediction"]["TowerWithHead_0"], w)
        _dense(pred.policy_logits, p["prediction"]["policy_logits"], w)
        _dense(pred.value, p["prediction"]["value"], w)

        phi = net.afterstate_dynamics
        _dense(phi.state_proj, p["afterstate_dynamics"]["Dense_0"], w)
        _dense(phi.action_proj, p["afterstate_dynamics"]["Dense_1"], w)
        _tower(phi.trunk, p["afterstate_dynamics"]["TowerWithHead_0"], w)
        _dense(phi.afterstate, p["afterstate_dynamics"]["afterstate"], w)

        psi = net.afterstate_prediction
        _tower(psi.trunk, p["afterstate_prediction"]["TowerWithHead_0"], w)
        _dense(psi.chance_logits, p["afterstate_prediction"]["chance_logits"], w)
        _dense(psi.q_value, p["afterstate_prediction"]["q_value"], w)

        g = net.dynamics
        _dense(g.state_proj, p["dynamics"]["Dense_0"], w)
        _dense(g.chance_proj, p["dynamics"]["Dense_1"], w)
        _tower(g.trunk, p["dynamics"]["TowerWithHead_0"], w)
        _dense(g.next_state, p["dynamics"]["next_state"], w)
        _dense(g.reward, p["dynamics"]["reward"], w)

        enc = net.encoder
        _tower(enc.trunk, p["encoder"]["TowerWithHead_0"], w)
        _dense(enc.chance_logits, p["encoder"]["chance_logits"], w)

    missing = [name for name, t in net.named_parameters() if id(t) not in w]
    if missing:
        raise ValueError(f"parameters not covered by the Flax tree: {missing}")
    return net

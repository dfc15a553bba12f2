"""Scalar NumPy 2048 engine (the port's copy of the JAX package's ``engine/``).

Host-side NumPy code that no device path calls. Serves two roles:
1. A drop-in equivalent of the reference's ``twentyfortyeight`` package
   (same public functions and env class, value-based boards) for manual play,
   afterstate enumeration, and host-side tooling.
2. The **parity oracle** for the port's batched engine (``ops/board.py``,
   ``ops/rng.py``) and the CUDA rollout kernel: when driven through the
   counter-based spawn spec (``engine.rng`` == ``ops.rng`` bit-for-bit), it
   reproduces batched device rollouts exactly, seed by seed.
"""

from simulate_2048_tpu_torch.engine.board import (
    TILE_SPAWN_PROBS,
    after_state,
    after_state_lazy,
    fill_cells,
    fill_cells_counter,
    generate_outcome,
    is_done,
    latent_state,
    merge_column,
    next_state,
    next_state_counter,
    slide_and_merge,
)
from simulate_2048_tpu_torch.engine.env import ACTIONS, TwentyFortyEight
from simulate_2048_tpu_torch.engine.moves import (
    can_move,
    illegal_actions,
    legal_actions,
    legal_actions_mask,
)
from simulate_2048_tpu_torch.engine.rng import spawn_bits_np, threefry2x32_np

__all__ = [
    "ACTIONS",
    "TILE_SPAWN_PROBS",
    "TwentyFortyEight",
    "after_state",
    "after_state_lazy",
    "can_move",
    "fill_cells",
    "fill_cells_counter",
    "generate_outcome",
    "illegal_actions",
    "is_done",
    "latent_state",
    "legal_actions",
    "legal_actions_mask",
    "merge_column",
    "next_state",
    "next_state_counter",
    "slide_and_merge",
    "spawn_bits_np",
    "threefry2x32_np",
]

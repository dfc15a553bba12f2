"""Pure-NumPy Threefry-2x32 — the host half of the spawn-RNG spec.

Bit-for-bit identical to ``simulate_2048_tpu_torch.ops.rng`` and to the JAX
package's ``engine/rng.py`` (tested in ``tests/test_torch_engine.py``), so
scalar oracle games replay device games exactly.
"""

from __future__ import annotations

import numpy as np

SPAWN_STREAM = np.uint32(0x2048_0001)
GAME_SEED_STREAM = np.uint32(0x2048_0002)
FOUR_THRESHOLD = np.uint32(429_496_730)

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    x = x.astype(np.uint32)
    return ((x << np.uint32(d)) | (x >> np.uint32(32 - d))).astype(np.uint32)


def threefry2x32_np(key: tuple, counter: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 scalars or arrays."""
    old = np.seterr(over="ignore")
    try:
        k0 = np.asarray(key[0], dtype=np.uint32)
        k1 = np.asarray(key[1], dtype=np.uint32)
        k2 = _PARITY ^ k0 ^ k1
        ks = (k0, k1, k2)

        x0 = np.asarray(counter[0], dtype=np.uint32) + k0
        x1 = np.asarray(counter[1], dtype=np.uint32) + k1

        for r in range(20):
            x0 = (x0 + x1).astype(np.uint32)
            x1 = _rotl(x1, _ROTATIONS[r % 8])
            x1 = x1 ^ x0
            if (r + 1) % 4 == 0:
                j = (r + 1) // 4
                x0 = (x0 + ks[j % 3]).astype(np.uint32)
                x1 = (x1 + ks[(j + 1) % 3] + np.uint32(j)).astype(np.uint32)
        return x0, x1
    finally:
        np.seterr(**old)


def spawn_bits_np(game_seed, spawn_index) -> tuple[np.ndarray, np.ndarray]:
    """Host mirror of ``ops.rng.spawn_bits``."""
    game_seed = np.asarray(game_seed, dtype=np.uint32)
    spawn_index = np.asarray(spawn_index, dtype=np.uint32)
    zeros = np.zeros(np.broadcast(game_seed, spawn_index).shape, dtype=np.uint32)
    return threefry2x32_np(
        (np.broadcast_to(SPAWN_STREAM, zeros.shape), game_seed),
        (spawn_index, zeros),
    )


def derive_game_seeds_np(run_seed, board_index, episode_index) -> np.ndarray:
    """Host mirror of ``ops.rng.derive_game_seeds``."""
    board_index = np.asarray(board_index, dtype=np.uint32)
    b0, _ = threefry2x32_np(
        (
            np.broadcast_to(GAME_SEED_STREAM, board_index.shape),
            np.broadcast_to(np.uint32(run_seed), board_index.shape),
        ),
        (board_index, np.asarray(episode_index, dtype=np.uint32)),
    )
    return b0

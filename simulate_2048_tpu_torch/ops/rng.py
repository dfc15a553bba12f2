"""Counter-based PRNG spec for tile spawns, in PyTorch.

Bit-exact port of the spawn-RNG spec (Threefry-2x32, 20 rounds; spawn stream
``threefry2x32((SPAWN_STREAM, game_seed), (spawn_index, 0))``; per-game seeds
from ``derive_game_seeds``). See the JAX package's ``ops/rng.py`` for the
spec itself.

PyTorch on the CPU has no ``uint32`` add, shift or compare, so every value
here is an ``int64`` tensor holding a uint32 in its low 32 bits: each add and
shift is followed by ``& 0xFFFFFFFF``. The same code runs on both devices.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

SPAWN_STREAM = 0x2048_0001
GAME_SEED_STREAM = 0x2048_0002

# P(spawn a 4) = 0.1 exactly as a uint32 threshold: round(0.1 * 2**32).
FOUR_THRESHOLD = 429_496_730

# Threefry-2x32 rotation distances (Salmon et al., SC'11).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(
    key: tuple[torch.Tensor, torch.Tensor], counter: tuple[torch.Tensor, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values.

    Broadcasts elementwise over the shapes of ``key`` and ``counter``.
    """
    k0 = _u32(key[0])
    k1 = _u32(key[1])
    k2 = _PARITY ^ k0 ^ k1
    ks = (k0, k1, k2)

    x0 = (_u32(counter[0]) + k0) & MASK32
    x1 = (_u32(counter[1]) + k1) & MASK32

    for r in range(20):
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            x0 = (x0 + ks[j % 3]) & MASK32
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK32

    return x0, x1


def spawn_bits(game_seed: torch.Tensor, spawn_index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Random bits ``(bits0, bits1)`` for the ``spawn_index``-th spawn of a game."""
    game_seed, spawn_index = torch.broadcast_tensors(_u32(game_seed), _u32(spawn_index))
    zeros = torch.zeros_like(game_seed)
    return threefry2x32((torch.full_like(zeros, SPAWN_STREAM), game_seed), (spawn_index, zeros))


def derive_game_seeds(run_seed: int | torch.Tensor, board_index: torch.Tensor, episode_index: torch.Tensor) -> torch.Tensor:
    """Per-(board, episode) game seed from a scalar run seed."""
    board_index = _u32(board_index)
    run = torch.as_tensor(run_seed, dtype=torch.int64, device=board_index.device)
    b0, _ = threefry2x32(
        (torch.full_like(board_index, GAME_SEED_STREAM), _u32(run).expand_as(board_index)),
        (board_index, _u32(episode_index).expand_as(board_index)),
    )
    return b0

"""Counter-based PRNG spec for tile spawns, and JAX's key functions, in PyTorch.

Bit-exact port of the spawn-RNG spec (Threefry-2x32, 20 rounds; spawn stream
``threefry2x32((SPAWN_STREAM, game_seed), (spawn_index, 0))``; per-game seeds
from ``derive_game_seeds``). See the JAX package's ``ops/rng.py`` for the
spec itself.

The same Threefry also gives the ``jax.random`` functions that draw the
networks' initial weights (``prng_key`` … ``truncated_normal``) and Flax's
per-module key (``fold_in_path``), so that a seed starts the port from the
network the JAX package starts from. They follow JAX's partitionable
Threefry (``jax_threefry_partitionable``, the default since JAX 0.5) and
Flax without the rng separator (``flax_fix_rng_separator`` off). A key is an
``int64`` tensor of shape ``(2,)``, JAX's raw ``uint32[2]`` key.

PyTorch on the CPU has no ``uint32`` add, shift or compare, so every value
here is an ``int64`` tensor holding a uint32 in its low 32 bits: each add and
shift is followed by ``& 0xFFFFFFFF``. The same code runs on both devices.
"""

from __future__ import annotations

import hashlib
import math

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


# ---------------------------------------------------------------------------
# jax.random's keys and draws (partitionable Threefry), on the CPU.


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (JAX's default,
    ``jax_enable_x64`` off): the words ``(0, seed & 0xFFFFFFFF)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _hash(key: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Threefry of counters ``(hi, lo)`` under ``key``, as ``(..., 2)`` words."""
    x0, x1 = threefry2x32((key[0], key[1]), (hi, lo))
    return torch.stack([x0, x1], -1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: row i is Threefry of the counter ``(0, i)``, shape ``(n, 2)``."""
    i = torch.arange(n, dtype=torch.int64)
    return _hash(key, torch.zeros_like(i), i)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: Threefry of ``(0, data)``."""
    d = torch.tensor(int(data) & MASK32, dtype=torch.int64)
    return _hash(key, torch.zeros_like(d), d)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: at flat index i the two words of
    Threefry of the 64-bit counter ``(i >> 32, i & 0xFFFFFFFF)``, xor-ed."""
    i = torch.arange(math.prod(shape), dtype=torch.int64)
    x0, x1 = threefry2x32((key[0], key[1]), (i >> 32, i & MASK32))
    return (x0 ^ x1).reshape(shape)


def uniform(key: torch.Tensor, shape: tuple[int, ...], lo=0.0, hi=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``: the top 23 bits of
    ``random_bits`` as a mantissa of [1, 2), less 1, scaled into [lo, hi).

    XLA computes ``floats * (hi - lo) + lo`` as one multiply-add rounded once
    to float32; in float64 the product is exact, and so is the sum, whose
    bits span less than 53 places for any float32 ``lo``, ``hi`` of like size."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    mantissa = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's float32 erf-inverse (Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w = -log1p(-x²) - 2.5 below w = 5, in sqrt(w) - 3 above.
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` in float32 torch ops, for |x| < 1. Only
    ``log1p`` differs from XLA's: 95% of the values equal JAX's, the rest
    are one ulp off."""
    w = -torch.log1p(x * -x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for c, t in zip(_ERFINV_CENTRAL, _ERFINV_TAIL):
        coeff = torch.where(central, torch.tensor(c, dtype=torch.float32), torch.tensor(t, dtype=torch.float32))
        p = coeff if p is None else coeff + p * w
    return p * x


def truncated_normal(key: torch.Tensor, lower: float, upper: float, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32:
    a uniform between ``erf(lower/√2)`` and ``erf(upper/√2)`` through
    ``√2·erfinv``, clipped inside ``(lower, upper)``. Equal to JAX's in
    about 95% of the values and within a float32 ulp in the rest
    (``erfinv32``'s ``log1p``)."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)
    lower_t = torch.tensor(lower, dtype=torch.float32)
    upper_t = torch.tensor(upper, dtype=torch.float32)
    u = uniform(key, shape, torch.erf(lower_t / sqrt2), torch.erf(upper_t / sqrt2))
    out = sqrt2 * erfinv32(u)
    inf = torch.tensor(math.inf, dtype=torch.float32)
    return torch.clamp(out, torch.nextafter(lower_t, inf), torch.nextafter(upper_t, -inf))


def fold_in_path(key: torch.Tensor, names: tuple[str, ...], counter: int) -> torch.Tensor:
    """Flax's key for the ``counter``-th draw in the module at ``names`` below
    the root: ``fold_in`` of the first 4 bytes (big-endian) of the SHA-1 of
    the UTF-8 names and the counter's minimal big-endian bytes, with no
    separator (``flax/core/scope.py`` ``_fold_in_static``)."""
    digest = hashlib.sha1()
    for name in names:
        digest.update(name.encode("utf-8"))
    digest.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))

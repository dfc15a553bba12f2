"""The random-rollout kernel: ``num_steps`` uniform-random auto-reset
environment steps per board in one launch, boards never leaving the chip.

Counterpart of the JAX package's ``ops/pallas_rollout.py``
(``_rollout_kernel`` / ``pallas_random_rollout``). Three things live here:

- :func:`random_rollout_reference`, the plain PyTorch version on the port's
  environment (``env.step_auto_reset``) and counter RNG;
- :func:`rollout_kernel`, the wrapper: the CUDA kernel
  (``csrc/random_rollout.cu``) for CUDA tensors, the plain version for CPU
  tensors, nothing else;
- ``LAUNCHES``, the count of kernel launches.

Both return, per board: the final board, the episodes finished, the reward
sum (float32, added in step order) and the largest tile seen. The largest
tile is taken over the boards as they are after each step and *before* a
finished game is replaced, as the TPU kernel takes it; ``ops.rollout.
random_rollout`` looks after the reset, so a tile that a game's last move
makes is seen here and not there.
"""

from __future__ import annotations

import ctypes

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.ops.rollout import random_actions

# Launches of the CUDA kernel by the wrapper (and nowhere else).
LAUNCHES = {"random_rollout": 0}

RolloutOutputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def random_rollout_reference_counted(seeds: torch.Tensor, num_steps: int) -> tuple[RolloutOutputs, int]:
    """:func:`random_rollout_reference` and the number of (board, step) pairs
    in which the move changed the board: with the episodes finished, what
    this rollout's data asks of the kernel's two branches (spawn and reset)."""
    state = envlib.reset(seeds)
    episodes = torch.zeros(seeds.shape, dtype=torch.int32, device=seeds.device)
    reward_sum = torch.zeros(seeds.shape, dtype=torch.float32, device=seeds.device)
    max_tile = torch.zeros(seeds.shape, dtype=torch.int32, device=seeds.device)
    moved = torch.zeros((), dtype=torch.int64, device=seeds.device)
    for t in range(num_steps):
        state, reward, done, info = envlib.step_auto_reset(state, random_actions(state, t))
        episodes = episodes + done.to(torch.int32)
        reward_sum = reward_sum + reward
        max_tile = torch.maximum(max_tile, info["max_tile"])  # of the board before the reset
        moved += info["moved"].sum()
    return (state.board, episodes, reward_sum, max_tile), int(moved)


def random_rollout_reference(seeds: torch.Tensor, num_steps: int) -> RolloutOutputs:
    """Plain PyTorch version of the kernel. ``seeds`` (B,) are per-board game
    seeds (uint32 values in an int64 tensor; the low 32 bits count). Returns ``(boards (B, 4, 4)
    int32 exponents, episodes finished (B,) int32, reward sum (B,) float32,
    max tile (B,) int32)``."""
    return random_rollout_reference_counted(seeds, num_steps)[0]


def rollout_kernel(seeds: torch.Tensor, num_steps: int) -> RolloutOutputs:
    """``num_steps`` random auto-reset steps of the boards seeded by ``seeds``
    (B,): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. Same arguments and results as :func:`random_rollout_reference`;
    any batch size."""
    if seeds.device.type == "cpu":
        return random_rollout_reference(seeds, num_steps)
    if seeds.device.type != "cuda":
        raise ValueError(f"rollout_kernel runs on CUDA or CPU tensors, not {seeds.device}")
    if seeds.dim() != 1 or seeds.dtype != torch.int64 or not seeds.is_contiguous():
        raise ValueError("rollout_kernel takes a contiguous (B,) int64 tensor of uint32 seeds")
    if num_steps < 0:
        raise ValueError(f"num_steps must not be negative (got {num_steps})")
    lib = _load()
    b, dev = seeds.shape[0], seeds.device
    boards = torch.empty(b, 4, 4, dtype=torch.int32, device=dev)
    episodes = torch.empty(b, dtype=torch.int32, device=dev)
    reward_sum = torch.empty(b, dtype=torch.float32, device=dev)
    max_tile = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return boards, episodes, reward_sum, max_tile
    with torch.cuda.device(dev):
        err = lib.random_rollout_launch(
            *(t.data_ptr() for t in (seeds, boards, episodes, reward_sum, max_tile)),
            b, num_steps, torch.cuda.current_stream(dev).cuda_stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"random_rollout kernel launch failed: {lib.random_rollout_error_string(err).decode()}")
    LAUNCHES["random_rollout"] += 1
    return boards, episodes, reward_sum, max_tile


def _load() -> ctypes.CDLL:
    lib = _build.load("random_rollout")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.random_rollout_error_string.argtypes = [i32]
        lib.random_rollout_error_string.restype = ctypes.c_char_p
        lib.random_rollout_launch.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
        lib.random_rollout_launch.restype = i32
        lib._argtypes_set = True
    return lib

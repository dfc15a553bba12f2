"""The random-rollout kernel: ``num_steps`` uniform-random auto-reset
environment steps per board in one launch, boards never leaving the chip.

Counterpart of the JAX package's ``ops/pallas_rollout.py``
(``_rollout_kernel`` / ``pallas_random_rollout``). What lives here:

- :func:`random_rollout_reference`, the plain PyTorch version on the port's
  environment (``env.step_auto_reset``) and counter RNG;
- :func:`rollout_kernel` and :func:`rollout_kernel_from_run_seed`, the
  wrappers: the CUDA kernel (``csrc/random_rollout.cu``) for CUDA tensors,
  the plain version for CPU tensors, nothing else. The second derives the
  boards' seeds from a run seed inside the launch;
- :func:`slide_table`, the table of slid rows the kernel moves its boards
  with, built by the port's own ``ops/board.py`` ``slide_rows_left``, and
  :func:`board_ops_kernel`, the kernel's own move, spawn and end test on
  given boards, for checks;
- ``LAUNCHES`` and ``CHECK_LAUNCHES``, the counts of kernel launches.

Both return, per board: the final board, the episodes finished, the reward
sum (float32, added in step order) and the largest tile seen. The largest
tile is taken over the boards as they are after each step and *before* a
finished game is replaced, as the TPU kernel takes it; ``ops.rollout.
random_rollout`` looks after the reset, so a tile that a game's last move
makes is seen here and not there.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.ops import board as board_ops
from simulate_2048_tpu_torch.ops import rng as tfrng
from simulate_2048_tpu_torch.ops.rollout import random_actions

# Launches of the CUDA kernel by the wrappers (and nowhere else).
LAUNCHES = {"random_rollout": 0}
# Launches of the check entry that applies the kernel's board ops to given boards.
CHECK_LAUNCHES = {"random_rollout_board_ops": 0}

# The table of slid rows: a row of four 4-bit cells (cell c at bits 4c) is an
# index; its entry holds the slid row in bits 0-15, a quarter of the slide's
# score in bits 16-30 and in bit 31 the flag EXACT: the slid row holds a cell
# of 15 or more, which a 4-bit cell cannot slide on. Rows that hold a 15 have
# EXACT and nothing else: a board with such a row is never slid by the table.
TABLE_ROWS = 1 << 16
EXACT = 1 << 31
_SHIFTS = torch.arange(0, 16, 4, dtype=torch.int64)

RolloutOutputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def random_rollout_reference_counted(seeds: torch.Tensor, num_steps: int) -> tuple[RolloutOutputs, dict[str, int]]:
    """:func:`random_rollout_reference` and what this rollout's data asks of
    the kernel's branches beside the episodes finished: ``moved``, the
    (board, step) pairs in which the move changed the board (a spawn), and
    ``full``, those of them whose spawn filled the last empty cell (the
    neighbour test)."""
    state = envlib.reset(seeds)
    episodes = torch.zeros(seeds.shape, dtype=torch.int32, device=seeds.device)
    reward_sum = torch.zeros(seeds.shape, dtype=torch.float32, device=seeds.device)
    max_tile = torch.zeros(seeds.shape, dtype=torch.int32, device=seeds.device)
    moved = torch.zeros((), dtype=torch.int64, device=seeds.device)
    full = torch.zeros((), dtype=torch.int64, device=seeds.device)
    for t in range(num_steps):
        state, reward, done, info = envlib.step_auto_reset(state, random_actions(state, t))
        episodes = episodes + done.to(torch.int32)
        reward_sum = reward_sum + reward
        max_tile = torch.maximum(max_tile, info["max_tile"])  # of the board before the reset
        moved += info["moved"].sum()
        full += (info["moved"] & (info["num_empty"] == 0)).sum()
    return (state.board, episodes, reward_sum, max_tile), {"moved": int(moved), "full": int(full)}


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
    _require_cuda("rollout_kernel", seeds.device)
    if seeds.dim() != 1 or seeds.dtype != torch.int64 or not seeds.is_contiguous():
        raise ValueError("rollout_kernel takes a contiguous (B,) int64 tensor of uint32 seeds")
    return _launch_rollout(seeds, 0, seeds.shape[0], num_steps, seeds.device)


def rollout_kernel_from_run_seed(
    run_seed: int, num_envs: int, num_steps: int, device: torch.device | str
) -> RolloutOutputs:
    """:func:`rollout_kernel` on the seeds ``derive_game_seeds(run_seed,
    arange(num_envs), 0)`` (``ops/rng.py``), which the kernel derives inside
    its launch on a CUDA device; on the CPU the plain version on those seeds."""
    device = torch.device(device)
    if device.type == "cpu":
        index = torch.arange(num_envs, dtype=torch.int64)
        return random_rollout_reference(tfrng.derive_game_seeds(run_seed, index, torch.zeros_like(index)), num_steps)
    _require_cuda("rollout_kernel_from_run_seed", device)
    if num_envs < 0:
        raise ValueError(f"num_envs must not be negative (got {num_envs})")
    return _launch_rollout(None, int(run_seed) & tfrng.MASK32, num_envs, num_steps, device)


def _require_cuda(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {device}")


def _launch_rollout(
    seeds: torch.Tensor | None, run_seed: int, b: int, num_steps: int, dev: torch.device
) -> RolloutOutputs:
    if num_steps < 0:
        raise ValueError(f"num_steps must not be negative (got {num_steps})")
    lib = _load()
    table = device_table(dev)
    boards = torch.empty(b, 4, 4, dtype=torch.int32, device=dev)
    episodes = torch.empty(b, dtype=torch.int32, device=dev)
    reward_sum = torch.empty(b, dtype=torch.float32, device=dev)
    max_tile = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return boards, episodes, reward_sum, max_tile
    with torch.cuda.device(dev):
        err = lib.random_rollout_launch(
            None if seeds is None else seeds.data_ptr(), run_seed, table.data_ptr(),
            *(t.data_ptr() for t in (boards, episodes, reward_sum, max_tile)),
            b, num_steps, torch.cuda.current_stream(dev).cuda_stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"random_rollout kernel launch failed: {lib.random_rollout_error_string(err).decode()}")
    LAUNCHES["random_rollout"] += 1
    return boards, episodes, reward_sum, max_tile


def slide_table() -> torch.Tensor:
    """The kernel's table of slid rows, ``(2, TABLE_ROWS)`` int32 holding
    uint32 entries (layout at ``TABLE_ROWS``): row ``r``'s entry for a slide
    left, then for a slide right, by ``ops/board.py`` ``slide_rows_left``."""
    rows = torch.arange(TABLE_ROWS, dtype=torch.int64)
    cells = ((rows[:, None] >> _SHIFTS) & 0xF).to(torch.int32)
    holds_15 = (cells >= 15).any(-1)
    left = board_ops.slide_rows_left(cells)
    right_flipped, right_score = board_ops.slide_rows_left(cells.flip(-1))
    entries = []
    for slid, score in (left, (right_flipped.flip(-1), right_score)):
        exact = (slid >= 15).any(-1)
        packed = (slid.to(torch.int64).clamp_max(15) << _SHIFTS).sum(-1) | (score.to(torch.int64) >> 2) << 16
        entries.append(torch.where(holds_15, EXACT, packed | exact.to(torch.int64) << 31))
    table = torch.stack(entries)
    return (table - (table >> 31 << 32)).to(torch.int32)  # the same 32 bits, as int32


def decode_table(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(slid rows (..., 4) int32, scores int32, EXACT flags bool)`` of entries."""
    entries = table.to(torch.int64) & tfrng.MASK32
    slid = ((entries[..., None] >> _SHIFTS) & 0xF).to(torch.int32)
    return slid, ((entries >> 16 & 0x7FFF) << 2).to(torch.int32), entries >> 31 == 1


@cache
def device_table(device: torch.device) -> torch.Tensor:
    """:func:`slide_table` on ``device``, built and copied there once."""
    return slide_table().to(device).contiguous()


BoardOpsOutputs = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def board_ops_reference(
    boards: torch.Tensor, actions: torch.Tensor, bits0: torch.Tensor, bits1: torch.Tensor
) -> BoardOpsOutputs:
    """Plain version of :func:`board_ops_kernel`, on ``ops/board.py``."""
    slid, score = board_ops.apply_action(boards, actions)
    spawned = board_ops.spawn_tile(slid, bits0, bits1)
    exact = spawned.flatten(-2).amax(-1) >= 15
    return slid, score, spawned, board_ops.is_done(spawned), exact


def board_ops_kernel(
    boards: torch.Tensor, actions: torch.Tensor, bits0: torch.Tensor, bits1: torch.Tensor
) -> BoardOpsOutputs:
    """The rollout kernel's own move, spawn and end test, as one of its steps
    applies them, on ``boards`` (N, 4, 4) int32 exponents (below 128) with
    ``actions`` (N,) and spawn bits ``bits0``, ``bits1`` (N,) int64 holding
    uint32 values. Returns ``(slid boards, scores int32, boards after the
    spawn, finished (bool), exact (bool): the rollout carries the board on
    its exact path from there)``: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. For checks: the rollout spawns only after a
    move, and its exact path is taken by boards random play rarely makes."""
    if boards.device.type == "cpu":
        return board_ops_reference(boards, actions, bits0, bits1)
    _require_cuda("board_ops_kernel", boards.device)
    n, dev = boards.shape[0], boards.device
    if boards.shape != (n, 4, 4) or boards.dtype != torch.int32 or not boards.is_contiguous():
        raise ValueError("board_ops_kernel takes a contiguous (N, 4, 4) int32 tensor of exponents")
    actions = actions.to(device=dev, dtype=torch.int32).contiguous()
    bits0, bits1 = (b.to(device=dev, dtype=torch.int64).contiguous() for b in (bits0, bits1))
    if not actions.shape == bits0.shape == bits1.shape == (n,):
        raise ValueError("board_ops_kernel takes (N,) actions and spawn bits")
    lib = _load()
    table = device_table(dev)
    slid, spawned = torch.empty_like(boards), torch.empty_like(boards)
    score, done, exact = (torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
    if n == 0:
        return slid, score, spawned, done.bool(), exact.bool()
    with torch.cuda.device(dev):
        err = lib.random_rollout_board_ops_launch(
            *(t.data_ptr() for t in (boards, actions, bits0, bits1, table, slid, score, spawned, done, exact)),
            n, torch.cuda.current_stream(dev).cuda_stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"random_rollout board ops launch failed: {lib.random_rollout_error_string(err).decode()}")
    CHECK_LAUNCHES["random_rollout_board_ops"] += 1
    return slid, score, spawned, done.bool(), exact.bool()


def _load() -> ctypes.CDLL:
    lib = _build.load("random_rollout")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.random_rollout_error_string.argtypes = [i32]
        lib.random_rollout_error_string.restype = ctypes.c_char_p
        lib.random_rollout_launch.argtypes = [ptr, ctypes.c_uint32] + [ptr] * 5 + [i32] * 2 + [ptr]
        lib.random_rollout_launch.restype = i32
        lib.random_rollout_board_ops_launch.argtypes = [ptr] * 10 + [i32, ptr]
        lib.random_rollout_board_ops_launch.restype = i32
        lib._argtypes_set = True
    return lib

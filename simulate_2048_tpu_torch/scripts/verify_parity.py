"""Seed-exact rollout parity at scale: ``python -m simulate_2048_tpu_torch.scripts.verify_parity``.

Port of the repository's ``scripts/verify_parity.py`` (``BASELINE.json``
config 2): B boards x T steps of lockstep random play on the device with the
port's board ops (``ops/board.py``) and counter-based RNG (``ops/rng.py``),
then a replay of the first ``--check`` boards on the port's own NumPy engine
(``engine/board.py``, ``engine/rng.py``), comparing the final boards exactly
and the reward sums within 1e-3. Same flags, defaults and printed lines
(``PARITY OK`` and exit code 0, or exit code 1 on any mismatch), plus
``--device`` (default ``cuda``; raises when no GPU is present unless given
``--device cpu``).

Both sides draw each (board, step) action from the same Threefry-2x32 counter
hash, ``threefry2x32((0x20480099, game_seed), (step, 0)) & 3``, each spawn
from the game's spawn stream at its spawn count, and stop a board once its
game is over. The port's Threefry runs on int64 tensors with 32-bit masks on
both devices, so the card computes the same bits as the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from simulate_2048_tpu_torch.engine.board import create_initial_board_counter, next_state_counter
from simulate_2048_tpu_torch.engine.board import is_done as np_is_done
from simulate_2048_tpu_torch.engine.rng import derive_game_seeds_np, threefry2x32_np
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops import rng as tfrng

ACTION_STREAM = 0x2048_0099  # the action stream of both sides' counter hash


@torch.no_grad()
def device_rollout(game_seeds: np.ndarray, steps: int, device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``steps`` lockstep moves of one board per seed on ``device``: a board
    whose game is over stays as it is. Returns (final boards (B, 4, 4)
    exponents, reward sums (B,) float32, spawn counts (B,)) on the host."""
    seeds = torch.from_numpy(game_seeds.astype(np.int64)).to(device)
    b = seeds.shape[0]
    zeros = torch.zeros_like(seeds)
    stream = torch.full_like(seeds, ACTION_STREAM)
    boards = ops.create_initial_board(seeds)
    counts = torch.full_like(seeds, 2)
    done = ops.is_done(boards)
    reward_sum = torch.zeros(b, dtype=torch.float32, device=device)
    for t in range(steps):
        a_bits, _ = tfrng.threefry2x32((stream, seeds), (torch.full_like(seeds, t), zeros))
        b0, b1 = tfrng.spawn_bits(seeds, counts)
        nxt, reward, moved = ops.next_state(boards, a_bits & 3, b0, b1)
        active = ~done
        boards = torch.where(active[:, None, None], nxt, boards)
        counts = counts + (moved & active).to(counts.dtype)
        reward_sum = reward_sum + torch.where(active, reward, torch.zeros_like(reward))
        done = done | ops.is_done(boards)
    return boards.cpu().numpy(), reward_sum.cpu().numpy(), counts.cpu().numpy()


def oracle_replay(seed: int, steps: int) -> tuple[np.ndarray, float]:
    """The same game on the NumPy engine: (final board as tile values, reward sum)."""
    board = create_initial_board_counter(seed)
    spawn_count, reward_sum = 2, 0.0
    for t in range(steps):
        if np_is_done(board):
            continue
        a_bits, _ = threefry2x32_np((np.uint32(ACTION_STREAM), np.uint32(seed)), (np.uint32(t), np.uint32(0)))
        board, reward, moved = next_state_counter(board, int(a_bits) & 3, seed, spawn_count)
        spawn_count += moved
        reward_sum += reward
    return board, reward_sum


def verify(boards: int = 4096, steps: int = 128, check: int = 256, seed: int = 1234, device="cuda") -> int:
    """Run both sides, print the JAX script's lines; returns the mismatches."""
    from simulate_2048_tpu_torch.device import resolve_device

    device = resolve_device(device)
    game_seeds = derive_game_seeds_np(seed, np.arange(boards), np.zeros(boards))
    t0 = time.perf_counter()
    dev_boards, dev_rewards, _ = device_rollout(game_seeds, steps, device)
    print(f"device: {boards} boards x {steps} steps in {time.perf_counter() - t0:.3f}s (incl. first calls), {device}")

    t0 = time.perf_counter()
    n_check = min(check, boards)
    mismatches = 0
    for i in range(n_check):
        board, reward_sum = oracle_replay(int(game_seeds[i]), steps)
        dev_vals = np.where(dev_boards[i] > 0, 2 ** dev_boards[i].astype(np.int64), 0)
        if not (np.array_equal(dev_vals, board) and abs(reward_sum - dev_rewards[i]) < 1e-3):
            mismatches += 1
            if mismatches <= 3:
                print(f"MISMATCH board {i}: oracle\n{board}\ndevice\n{dev_vals}")
    print(f"oracle replay: {n_check} boards in {time.perf_counter() - t0:.3f}s — {mismatches} mismatches")
    if not mismatches:
        print(f"PARITY OK: {n_check}/{boards} boards bitwise-identical over {steps} steps")
    return mismatches


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Seed-exact rollout parity against the NumPy engine (PyTorch port)")
    parser.add_argument("--boards", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=128)
    parser.add_argument("--check", type=int, default=256, help="boards to replay on the oracle")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    if verify(args.boards, args.steps, args.check, args.seed, args.device):
        sys.exit(1)


if __name__ == "__main__":
    main()

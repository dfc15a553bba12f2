"""Functional batched 2048 environment on the PyTorch board ops.

Port of the JAX package's ``env/env.py``: stochasticity lives in the state
as a (game_seed, spawn_count) counter-RNG cursor, so ``step`` is a pure
function of (state, action) and any game replays bit for bit from its seed.
uint32 fields are int64 tensors holding uint32 values (see ``ops/rng.py``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops import rng as tfrng


class GameState(NamedTuple):
    """Complete, replayable state of a batch of 2048 games."""

    board: torch.Tensor  # (..., 4, 4) int32 exponents
    step_count: torch.Tensor  # int32 — moves taken this episode
    done: torch.Tensor  # bool
    total_reward: torch.Tensor  # float32 — cumulative raw score
    game_seed: torch.Tensor  # int64 (uint32 value) — this episode's spawn stream
    spawn_count: torch.Tensor  # int64 (uint32 value) — spawns consumed (2 after reset)
    episode_index: torch.Tensor  # int64 (uint32 value) — bumps on reset_done


def reset(game_seed: torch.Tensor) -> GameState:
    """Fresh episodes from uint32 seeds (any shape) on the seeds' device."""
    game_seed = game_seed.to(torch.int64) & tfrng.MASK32
    shape, device = game_seed.shape, game_seed.device
    return GameState(
        board=ops.create_initial_board(game_seed),
        step_count=torch.zeros(shape, dtype=torch.int32, device=device),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        total_reward=torch.zeros(shape, dtype=torch.float32, device=device),
        game_seed=game_seed,
        spawn_count=torch.full(shape, 2, dtype=torch.int64, device=device),
        episode_index=torch.zeros(shape, dtype=torch.int64, device=device),
    )


def reset_batch(run_seed: int, num_envs: int, device: torch.device | str) -> GameState:
    """Batch of independent episodes derived from one run seed."""
    idx = torch.arange(num_envs, dtype=torch.int64, device=device)
    return reset(tfrng.derive_game_seeds(run_seed, idx, torch.zeros_like(idx)))


def step(state: GameState, action: torch.Tensor) -> tuple[GameState, torch.Tensor, torch.Tensor, dict[str, Any]]:
    """One transition. Returns (new_state, reward, done, info).

    Once done, a game freezes and earns 0; invalid moves leave the board
    unchanged with reward 0 and consume no spawn.
    """
    b0, b1 = tfrng.spawn_bits(state.game_seed, state.spawn_count)
    next_board, reward, moved = ops.next_state(state.board, action, b0, b1)

    active = ~state.done
    board = torch.where(active[..., None, None], next_board, state.board)
    reward = torch.where(active, reward, torch.zeros_like(reward))
    moved = moved & active
    done = state.done | ops.is_done(board)

    new_state = GameState(
        board=board,
        step_count=state.step_count + active.to(torch.int32),
        done=done,
        total_reward=state.total_reward + reward,
        game_seed=state.game_seed,
        spawn_count=(state.spawn_count + moved.to(torch.int64)) & tfrng.MASK32,
        episode_index=state.episode_index,
    )
    info = {
        "max_tile": ops.max_tile(board),
        "num_empty": ops.count_empty(board),
        "moved": moved,
        "step_count": new_state.step_count,
    }
    return new_state, reward, done, info


def step_auto_reset(
    state: GameState, action: torch.Tensor
) -> tuple[GameState, torch.Tensor, torch.Tensor, dict[str, Any]]:
    """:func:`step`, then every game that ended is replaced by a fresh one
    (:func:`reset_done`), so that no lane of a lockstep batch idles. ``done``
    is the flag before the reset (it marks the trajectory boundary), and
    ``info`` describes the board before the reset."""
    new_state, reward, done, info = step(state, action)
    return reset_done(new_state), reward, done, info


def reset_done(state: GameState) -> GameState:
    """Replace finished games with fresh episodes; active games untouched.

    The new episode's stream is ``derive_game_seeds(0, game_seed, episode_index + 1)``.
    """
    next_ep = (state.episode_index + 1) & tfrng.MASK32
    fresh = reset(tfrng.derive_game_seeds(0, state.game_seed, next_ep))._replace(episode_index=next_ep)
    done = state.done

    def pick(f: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return torch.where(done.reshape(done.shape + (1,) * (f.dim() - done.dim())), f, s)

    return GameState(*(pick(f, s) for f, s in zip(fresh, state)))


def get_observation(state: GameState) -> torch.Tensor:
    """Flattened float observation in [0, 1]."""
    return ops.encode_observation(state.board)


def get_legal_actions(state: GameState) -> torch.Tensor:
    """Boolean ``(..., 4)`` legal-action mask."""
    return ops.legal_actions_mask(state.board)

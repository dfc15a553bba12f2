"""Rollout loops on the batched environment, in PyTorch (port of the JAX
package's ``ops/rollout.py``).

Where the JAX package scans under ``jit``, the port loops in Python: one
iteration is one step of every board. :func:`random_rollout` is the plain
multi-kernel form of the uniform-random auto-reset rollout; the same work in
one CUDA kernel, with the boards kept on chip, is ``ops/rollout_kernel.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops import rng as tfrng

# Stream of the uniform-random actions: threefry2x32((ACTION_STREAM, game_seed), (step, spawn_count)).
ACTION_STREAM = 0x2048_0003


class RolloutStats(NamedTuple):
    """Aggregates of an auto-reset rollout (0-dim tensors on the rollout's device)."""

    episodes_finished: torch.Tensor  # int32: episodes completed across the batch
    total_reward: torch.Tensor  # float32: sum of rewards over all steps and boards
    max_tile: torch.Tensor  # int32: best tile seen on any board
    steps: torch.Tensor  # int32: env-steps executed (batch * length)


def random_actions(state: envlib.GameState, step: int) -> torch.Tensor:
    """The uniform-random action of every board at rollout step ``step``, from
    the counter RNG: illegal moves are not excluded (the environment treats
    them as no-ops), so the whole rollout replays from its seeds."""
    key0 = torch.full_like(state.game_seed, ACTION_STREAM)
    bits0, _ = tfrng.threefry2x32((key0, state.game_seed), (torch.full_like(key0, step), state.spawn_count))
    return bits0 % 4


@torch.no_grad()
def random_rollout(run_seed: int, num_envs: int, num_steps: int, device: torch.device | str = "cpu") -> RolloutStats:
    """``num_steps`` uniform-random auto-reset steps of ``num_envs`` boards in lockstep."""
    state = envlib.reset_batch(run_seed, num_envs, device)
    episodes = torch.zeros((), dtype=torch.int32, device=device)
    total_reward = torch.zeros((), dtype=torch.float32, device=device)
    max_tile = torch.zeros((), dtype=torch.int32, device=device)
    for t in range(num_steps):
        state, reward, done, _ = envlib.step_auto_reset(state, random_actions(state, t))
        episodes = episodes + done.sum(dtype=torch.int32)
        total_reward = total_reward + reward.sum()
        max_tile = torch.maximum(max_tile, ops.max_tile(state.board).amax())
    steps = torch.tensor(num_envs * num_steps, dtype=torch.int32, device=device)
    return RolloutStats(episodes, total_reward, max_tile, steps)


PolicyFn = Callable[[torch.Tensor, torch.Tensor, "torch.Generator | None"], torch.Tensor]


@torch.no_grad()
def policy_rollout(
    state: envlib.GameState,
    policy_fn: PolicyFn,
    num_steps: int,
    temperature: float,
    generator: torch.Generator | None = None,
    uniform: torch.Tensor | None = None,
):
    """Roll a batched policy for ``num_steps`` with done-masking (no reset).

    ``policy_fn(obs, legal_mask, generator) -> policy_probs`` is called once
    per step. Actions are drawn from ``generator``, or by inverting the
    cumulative distribution at ``uniform`` (num_steps, B) when that is given.
    Returns (final state, per-step (obs, action, reward, done, policy)
    stacked along time).
    """
    steps = []
    for t in range(num_steps):
        obs = envlib.get_observation(state)
        legal = envlib.get_legal_actions(state)
        probs = policy_fn(obs, legal, generator)
        actions = ops.sample_action(generator, temperature, probs, legal, None if uniform is None else uniform[t])
        state, reward, done, _ = envlib.step(state, actions)
        steps.append((obs, actions, reward, done, probs))
    return state, tuple(torch.stack(field) for field in zip(*steps))

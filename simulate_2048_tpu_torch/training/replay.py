"""Device-resident prioritized trajectory replay, in PyTorch (port of the JAX
package's ``training/replay.py``).

The buffer is a tuple of tensors on one device and every operation
(circular insert, priority sampling, K+1-window gather, importance weights,
priority update, cross-segment backfill) runs there. Where the JAX package
returns a new buffer, the port updates the tensors in place and returns the
same :class:`BufferState`.

Storage is compressed as in the JAX package, so stored targets round the
same way: boards int8 exponents, policies float16, values / rewards /
priorities bfloat16. Everything is cast back to float32 at gather time.

Priorities are per position (p_t = |ν_t − z_t|). Sampling draws (episode,
start) through the exact two-level factorisation of the flat categorical:
the episode by its mass Σ p^α, then the start within the episode.
:func:`sample_batch` is that draw (:func:`sample_indices`) followed by a
pure function of the indices (:func:`gather_batch`), so a test can feed the
indices another implementation drew.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from simulate_2048_tpu_torch.ops.value_transform import scale_value
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.losses import TrainingTargets

# Storage dtypes (cast to float32 at gather).
POLICY_DTYPE = torch.float16  # probabilities in [0, 1]
VALUE_DTYPE = torch.bfloat16  # returns exceed the float16 range
REWARD_DTYPE = torch.bfloat16
PRIORITY_DTYPE = torch.bfloat16


class Trajectory(NamedTuple):
    """A batch of fixed-capacity episode segments. Slot t of actions / rewards /
    policies / values describes the transition out of ``boards[t]``;
    ``length`` is the number of real steps, storage beyond it is padding."""

    boards: torch.Tensor  # (B, T+1, 16) int8 exponents
    actions: torch.Tensor  # (B, T) int8
    rewards: torch.Tensor  # (B, T) f32
    policies: torch.Tensor  # (B, T, A) f32
    values: torch.Tensor  # (B, T) f32 search values (or TD(λ) returns)
    priorities: torch.Tensor  # (B, T) f32 per-position |ν_t − z_t|
    length: torch.Tensor  # (B,) i32
    terminated: torch.Tensor  # (B,) bool: the game ended inside this segment
    total_reward: torch.Tensor  # (B,) f32 reward earned within this segment
    max_tile: torch.Tensor  # (B,) i32


class BufferState(NamedTuple):
    """Circular trajectory store + per-position priorities, all on one device."""

    boards: torch.Tensor  # (cap, T+1, 16) int8
    actions: torch.Tensor  # (cap, T) int8
    rewards: torch.Tensor  # (cap, T) bf16
    policies: torch.Tensor  # (cap, T, A) f16
    values: torch.Tensor  # (cap, T) bf16
    length: torch.Tensor  # (cap,) i32
    terminated: torch.Tensor  # (cap,) bool
    total_reward: torch.Tensor  # (cap,) f32
    max_tile: torch.Tensor  # (cap,) i32
    step_priorities: torch.Tensor  # (cap, T) bf16 (0: unsampleable position)
    write_pos: torch.Tensor  # () i32
    size: torch.Tensor  # () i32
    episodes_added: torch.Tensor  # () i32
    steps_added: torch.Tensor  # () i32


def init_buffer(config: TrainConfig, device: torch.device | str = "cpu") -> BufferState:
    """Allocate an empty buffer for ``config.replay_buffer_size`` episodes on ``device``."""
    cap, t, a = config.replay_buffer_size, config.max_trajectory_length, config.action_size

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BufferState(
        boards=z((cap, t + 1, 16), torch.int8),
        actions=z((cap, t), torch.int8),
        rewards=z((cap, t), REWARD_DTYPE),
        policies=z((cap, t, a), POLICY_DTYPE),
        values=z((cap, t), VALUE_DTYPE),
        length=z((cap,), torch.int32),
        terminated=z((cap,), torch.bool),
        total_reward=z((cap,), torch.float32),
        max_tile=z((cap,), torch.int32),
        step_priorities=z((cap, t), PRIORITY_DTYPE),
        write_pos=z((), torch.int32),
        size=z((), torch.int32),
        episodes_added=z((), torch.int32),
        steps_added=z((), torch.int32),
    )


def trajectory_priority(traj: Trajectory) -> torch.Tensor:
    """Episode-level priority heuristic: max(1, variance of the search values
    over the real steps + 0.1). The live path uses ``traj.priorities``."""
    t = traj.values.shape[-1]
    mask = torch.arange(t, device=traj.values.device)[None, :] < traj.length[:, None]
    n = torch.clamp_min(traj.length, 1).to(torch.float32)
    mean = (traj.values * mask).sum(-1) / n
    var = (torch.square(traj.values - mean[:, None]) * mask).sum(-1) / n
    return torch.clamp_min(var + 0.1, 1.0)


@torch.no_grad()
def add_trajectories(state: BufferState, traj: Trajectory) -> BufferState:
    """Circular insert of a batch of episodes, in place.

    Per-position priorities are floored at 1e-3 inside the episode (every
    real position stays sampleable) and zeroed outside it.
    """
    batch = traj.length.shape[0]
    cap = state.length.shape[0]
    t = state.actions.shape[1]
    expect = {
        "boards": (batch, t + 1, 16),
        "actions": (batch, t),
        "policies": (batch, t, state.policies.shape[-1]),
        "priorities": (batch, t),
    }
    for name, shape in expect.items():
        got = tuple(getattr(traj, name).shape)
        if got != shape:
            raise ValueError(f"trajectory {name} has shape {got}, the buffer takes {shape}")
    if traj.boards.dtype != torch.int8:
        raise ValueError("trajectory boards must be int8 exponents")
    dev = state.length.device
    idx = ((state.write_pos + torch.arange(batch, device=dev)) % cap).to(torch.int64)
    in_ep = torch.arange(t, device=dev)[None, :] < traj.length[:, None]
    prios = torch.where(in_ep, torch.clamp_min(traj.priorities, 1e-3), torch.zeros_like(traj.priorities))
    state.boards[idx] = traj.boards
    state.actions[idx] = traj.actions
    state.rewards[idx] = traj.rewards.to(REWARD_DTYPE)
    state.policies[idx] = traj.policies.to(POLICY_DTYPE)
    state.values[idx] = traj.values.to(VALUE_DTYPE)
    state.length[idx] = traj.length
    state.terminated[idx] = traj.terminated
    state.total_reward[idx] = traj.total_reward
    state.max_tile[idx] = traj.max_tile
    state.step_priorities[idx] = prios.to(PRIORITY_DTYPE)
    state.write_pos.copy_((state.write_pos + batch) % cap)
    state.size.copy_(torch.clamp_max(state.size + batch, cap))
    state.episodes_added.add_(batch)
    state.steps_added.add_(traj.length.sum(dtype=torch.int32))
    return state


def _sampling_weights(state: BufferState, config: TrainConfig) -> torch.Tensor:
    """(cap, T) sampling weights w = p^α over valid window starts, 0 elsewhere.

    Terminated episodes may start anywhere in the episode (windows cross the
    end under absorbing-state masking); truncated segments must fit the
    whole K-window before the boundary.
    """
    k = config.num_unroll_steps
    t = state.actions.shape[1]
    w = state.step_priorities.to(torch.float32)
    if config.priority_alpha != 1.0:
        w = torch.pow(w, config.priority_alpha)
    max_start = torch.where(state.terminated, state.length, torch.clamp_min(state.length - k, 1))
    steps = torch.arange(t, device=w.device)[None, :]
    valid = (steps < max_start[:, None]) & (steps < state.length[:, None])
    return torch.where(valid, w, torch.zeros_like(w))


@torch.no_grad()
def sample_indices(
    state: BufferState, generator: torch.Generator | None, batch_size: int, config: TrainConfig
) -> torch.Tensor:
    """Draw ``(batch_size, 2)`` int64 (episode, start) pairs ∝ p^α: the
    episode by its weight mass, then the start within the episode."""
    w = _sampling_weights(state, config)
    episodes = torch.multinomial(w.sum(-1), batch_size, replacement=True, generator=generator)
    starts = torch.multinomial(w[episodes], 1, generator=generator)[:, 0]
    return torch.stack([episodes, starts], dim=1)


@torch.no_grad()
def gather_batch(
    state: BufferState, indices: torch.Tensor, config: TrainConfig
) -> tuple[TrainingTargets, torch.Tensor]:
    """Training windows and importance weights of the sampled ``indices``
    (B, 2), a pure function of the buffer and the indices.

    IS weights are (N·P)^{-β}, max-normalised, with N the number of
    sampleable positions. Positions beyond the episode's end get value 0, a
    uniform policy and reward 0 (absorbing state).
    """
    k = config.num_unroll_steps
    idx, start = indices[:, 0].to(torch.int64), indices[:, 1].to(torch.int64)

    w = _sampling_weights(state, config)
    total_mass = torch.clamp_min(w.sum(-1).sum(), 1e-12)
    p_sel = w[idx, start] / total_mass
    n = torch.clamp_min((w > 0).to(torch.float32).sum(), 1.0)
    weights = torch.pow(n * torch.clamp_min(p_sel, 1e-12), -config.priority_beta)
    weights = weights / torch.clamp_min(weights.max(), 1e-12)

    lengths = state.length[idx].to(torch.int64)
    t_idx = start[:, None] + torch.arange(k + 1, device=start.device)[None, :]  # (B, K+1) unclamped
    in_range = t_idx < lengths[:, None]
    t_clamped = torch.minimum(t_idx, torch.clamp_min(lengths[:, None] - 1, 0))
    ep = idx[:, None]

    observations = state.boards[ep, torch.clamp_max(t_idx, state.boards.shape[1] - 1)].to(torch.float32) / 16.0
    actions = state.actions[ep, t_clamped[:, :k]]
    rewards = state.rewards[ep, t_clamped[:, :k]].to(torch.float32)
    policies = state.policies[ep, t_clamped].to(torch.float32)
    values = state.values[ep, t_clamped].to(torch.float32)

    policies = torch.where(in_range[..., None], policies, torch.full_like(policies, 1.0 / config.action_size))
    values = torch.where(in_range, values, torch.zeros_like(values))
    rewards = torch.where(in_range[:, :k], rewards, torch.zeros_like(rewards))

    targets = TrainingTargets(
        observations=observations,
        actions=actions.to(torch.int64),
        target_policies=policies,
        target_values=values,
        target_rewards=rewards,
    )
    return targets, weights


def sample_batch(
    state: BufferState, generator: torch.Generator | None, batch_size: int, config: TrainConfig
) -> tuple[TrainingTargets, torch.Tensor, torch.Tensor]:
    """Prioritised sample of K+1 training windows at per-position granularity.
    Returns ``(targets, indices (B, 2) of (episode, start), IS weights)``."""
    indices = sample_indices(state, generator, batch_size, config)
    targets, weights = gather_batch(state, indices, config)
    return targets, indices, weights


@torch.no_grad()
def backfill_returns(
    state: BufferState,
    slots: torch.Tensor,
    cont: torch.Tensor,
    seq: torch.Tensor,
    nu0_next: torch.Tensor,
    z0_next: torch.Tensor,
    config: TrainConfig,
) -> BufferState:
    """Ground a truncated segment's value targets with its successor segment, in place.

    At collection time a truncated segment's boundary target is forced to
    its own search value ν_last. Once the next segment of the same game has
    been played, the boundary target becomes

        G'_{L-1} = r_{L-1} + γ·[(1−λ)·ν_0^{next} + λ·z_0^{next}]

    and, since a boundary change re-enters earlier positions only through
    the λ-branch of the TD(λ) recursion, every stored target shifts in
    closed form: z_t += (γλ)^{L-1-t} · (G'_{L-1} − z_{L-1}).

    ``slots`` (B,) are the buffer rows of each lane's previous segment,
    ``cont`` (B,) whether that segment was truncated, ``seq`` (B,) the
    insertion numbers of those rows (a row is patched only if the circular
    buffer has not overwritten it), ``nu0_next`` / ``z0_next`` (B,) the
    search values and stored targets at the new segment's first position.
    Priorities of patched positions are raised to at least the h-space
    target shift.
    """
    gamma, lam = config.discount, config.td_lambda
    cap = state.length.shape[0]
    t = state.actions.shape[1]
    slots = slots.to(torch.int64)

    valid = cont & (state.episodes_added - seq <= cap)
    lengths = state.length[slots]
    last = torch.clamp_min(lengths - 1, 0).to(torch.int64)
    old_values = state.values[slots].to(torch.float32)
    z_last = old_values.gather(-1, last[:, None])[:, 0]
    r_last = state.rewards[slots].to(torch.float32).gather(-1, last[:, None])[:, 0]
    boundary = r_last + gamma * ((1.0 - lam) * nu0_next + lam * z0_next)
    delta = torch.where(valid, boundary - z_last, torch.zeros_like(z_last))

    steps = torch.arange(t, device=slots.device)[None, :]
    in_ep = steps < lengths[:, None]
    base = torch.full((), gamma * lam, dtype=torch.float32, device=slots.device)
    exponent = (last[:, None] - steps).to(torch.float32)
    factor = torch.where(in_ep, torch.pow(base, exponent), torch.zeros_like(old_values))
    new_values = old_values + factor * delta[:, None]

    old_prios = state.step_priorities[slots].to(torch.float32)
    shift = torch.abs(scale_value(new_values, config.value_epsilon) - scale_value(old_values, config.value_epsilon))
    new_prios = torch.where(in_ep, torch.maximum(old_prios, shift), old_prios)

    state.values[slots] = new_values.to(VALUE_DTYPE)
    state.step_priorities[slots] = new_prios.to(PRIORITY_DTYPE)
    return state


@torch.no_grad()
def update_priorities(state: BufferState, indices: torch.Tensor, new_priorities: torch.Tensor) -> BufferState:
    """Write back priorities for sampled (episode, start) positions, in place."""
    ep, t = indices[:, 0].to(torch.int64), indices[:, 1].to(torch.int64)
    state.step_priorities[ep, t] = torch.clamp_min(new_priorities, 1e-6).to(PRIORITY_DTYPE)
    return state


def is_ready(state: BufferState, min_size: int) -> bool:
    """Whether training may start."""
    return int(state.size) >= min_size


def buffer_nbytes(state: BufferState) -> int:
    """Exact memory footprint of the buffer's tensors in bytes."""
    return sum(t.numel() * t.element_size() for t in state)


def get_statistics(state: BufferState) -> dict:
    """Host-side summary."""
    size = int(state.size)
    sl = slice(0, max(size, 1))
    prios = state.step_priorities[sl].to(torch.float32)
    n_pos = torch.clamp_min((prios > 0).to(torch.float32).sum(), 1.0)
    return {
        "size": size,
        "capacity": int(state.length.shape[0]),
        "episodes_added": int(state.episodes_added),
        "steps_added": int(state.steps_added),
        "mean_episode_reward": float(state.total_reward[sl].mean()) if size else 0.0,
        "mean_episode_length": float(state.length[sl].to(torch.float32).mean()) if size else 0.0,
        "max_tile": int(state.max_tile[sl].max()) if size else 0,
        "mean_priority": float(prios.sum() / n_pos) if size else 0.0,
        "nbytes": buffer_nbytes(state),
    }

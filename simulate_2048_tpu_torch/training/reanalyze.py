"""Reanalyze: refresh stored replay targets with the current network, in
PyTorch (port of the JAX package's ``training/reanalyze.py``).

MuZero Reanalyse (Schrittwieser et al. 2020, App. H) re-runs the latest
model over buffered experience so that value and policy targets follow the
improving network instead of staying as they were at collection. The buffer
lives on the device (``training/replay.py``): a pass gathers a chunk of
episodes, runs the current network over every stored board, recomputes the
TD(λ) targets with fresh bootstraps and writes values, policies and
priorities back into the buffer's tensors, in place.

Two modes (``TrainConfig.reanalyze_mode``):

- ``"value"``: fresh f-values at every position re-bootstrap the TD(λ)
  recursion; a truncated boundary re-grounds on r_last + γ·v̂(closing
  board). One forward pass per position.
- ``"search"``: a full search per stored position also rewrites the policy
  targets, and the fresh root values replace the f-values as bootstraps. The
  searches go through the dispatcher self-play uses
  (``self_play._make_search``: the whole-search kernel on CUDA under
  ``search_backend`` "auto" / "pallas", the plain search under "xla"), with
  the weights packed once per pass.
"""

from __future__ import annotations

import torch

from simulate_2048_tpu_torch.models.network import MuZeroNetwork
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops.value_transform import inverse_scale_value, scale_value
from simulate_2048_tpu_torch.search.mcts import draw_root_noise, uses_root_noise
from simulate_2048_tpu_torch.search.policy import get_policy_target
from simulate_2048_tpu_torch.training import replay as replay_lib
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.replay import POLICY_DTYPE, PRIORITY_DTYPE, VALUE_DTYPE
from simulate_2048_tpu_torch.training.self_play import _make_search, compute_n_step_returns, search_config_from

# Roots per search call in "search" mode. The searches of a pass are
# independent, so they go through the search in slices of this many: the
# whole-search kernel keeps every search's tree tables in device memory
# (about 157 KB per search at 100 simulations, so 161 MB per slice, where all
# 64 x 200 positions of the training recipe's pass at once would take 2 GB),
# and 1,024 searches are 512 thread blocks, a few for each of an H100's 132
# multiprocessors.
SEARCH_BATCH = 1024


def search_batches(num_roots: int) -> int:
    """Search calls (kernel launches on CUDA) that ``num_roots`` positions take."""
    return -(-num_roots // SEARCH_BATCH)


def _fresh_values(network: MuZeroNetwork, obs: torch.Tensor, config: TrainConfig) -> torch.Tensor:
    """v̂(obs) from the current network, in the space the target pipeline uses
    (raw returns when ``search_untransform_values``, h-space otherwise, as
    search values enter the targets at collection)."""
    _, value = network.prediction(network.representation(obs))
    if config.search_untransform_values:
        value = inverse_scale_value(value, config.value_epsilon)
    return value.to(torch.float32)


@torch.no_grad()
def reanalyze_slots(
    buffer: replay_lib.BufferState,
    network: MuZeroNetwork,
    slots: torch.Tensor,
    config: TrainConfig,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    chance_noise: torch.Tensor | None = None,
) -> replay_lib.BufferState:
    """Refresh the targets of the episodes at buffer rows ``slots``, in place.

    Rewrites:
    - ``values``: TD(λ) returns re-bootstrapped on the current network
      (``value_target_mode == "td_lambda"``) or the fresh root values
      themselves (``"search"`` target mode, as collection would have stored);
    - ``policies`` (``reanalyze_mode == "search"`` only): fresh search
      policies (visit distributions, or the improved policy under the
      Gumbel root) at temperature 1.0, as at collection;
    - ``step_priorities``: |h(ν_fresh) − h(z_new)| per position, floored at
      1e-3 inside the episode and 0 outside it.

    Rows at or beyond ``buffer.size`` (never written) are left untouched.
    In "search" mode the root noise of the n·T searches (Dirichlet under the
    PUCT root, standard Gumbel under the Gumbel root) is ``noise`` (n·T, A)
    when given, else drawn from ``generator``; a search with root noise
    needs one of the two. The chance draws of sampled chance selection are
    ``chance_noise`` (n·T, S, S + 1, K) when given, else drawn from
    ``generator`` during the searches.
    """
    n = slots.shape[0]
    t = buffer.actions.shape[1]
    device = buffer.length.device
    slots = slots.to(torch.int64)

    boards_i8 = buffer.boards[slots]  # (n, T+1, 16) int8 exponents
    obs = boards_i8.to(torch.float32) / float(ops.MAX_EXPONENT)  # the encode_observation convention
    rewards = buffer.rewards[slots].to(torch.float32)  # (n, T)
    lengths = buffer.length[slots]
    terminated = buffer.terminated[slots]
    occupied = slots < buffer.size

    new_policies = None
    if config.reanalyze_mode == "search":
        cfg = search_config_from(config)
        if config.reanalyze_num_simulations is not None:
            cfg = cfg._replace(num_simulations=config.reanalyze_num_simulations)
        if config.reanalyze_prior_temperature is not None:
            cfg = cfg._replace(prior_temperature=config.reanalyze_prior_temperature)
        if config.reanalyze_pb_c_init is not None:
            cfg = cfg._replace(pb_c_init=config.reanalyze_pb_c_init)
        roots = obs[:, :t].reshape(n * t, 16)
        legal = ops.legal_actions_mask(boards_i8[:, :t].reshape(n * t, 4, 4).to(torch.int32))  # (n·T, 4)
        if uses_root_noise(cfg) and noise is None:
            if generator is None:
                raise ValueError("search-mode reanalyze with root noise needs `noise` or a `generator`")
            noise = draw_root_noise(cfg, n * t, generator, device)
        if cfg.chance_selection == "sample" and chance_noise is None and generator is None:
            raise ValueError(
                "search-mode reanalyze with sampled chance selection needs `chance_noise` or a `generator`"
            )
        search = _make_search(network, config, cfg, device)
        policies, values = [], []
        for start in range(0, n * t, SEARCH_BATCH):
            part = slice(start, start + SEARCH_BATCH)
            out = search(
                roots[part], ~legal[part], None if noise is None else noise[part],
                None if chance_noise is None else chance_noise[part], generator,
            )  # fmt: skip
            # The policy target at temperature 1.0, exactly as at collection (``play_segment``).
            policies.append(get_policy_target(out, legal[part], 1.0))
            values.append(out.search_value)
        new_policies = torch.cat(policies).reshape(n, t, config.action_size)
        nu = torch.cat(values).reshape(n, t)
    else:
        nu = _fresh_values(network, obs[:, :t].reshape(n * t, 16), config).reshape(n, t)

    # Value estimate of the segment's closing board (index ``lengths`` on the
    # T+1 tape): grounds the truncated boundary one real reward deeper than
    # the ν_last convention of collection.
    closing = torch.clamp_max(lengths, t).to(torch.int64)
    tail_obs = obs[torch.arange(n, device=device), closing]
    tail_value = _fresh_values(network, tail_obs, config)

    in_ep = torch.arange(t, device=device)[None, :] < lengths[:, None]
    nu = torch.where(in_ep, nu, torch.zeros_like(nu))

    if config.value_target_mode == "td_lambda":
        new_values = compute_n_step_returns(rewards, nu, lengths, config, terminated, tail_value)
    else:
        new_values = nu  # "search" target mode stores raw root values: the fresh ones replace them

    new_prios = torch.abs(scale_value(nu, config.value_epsilon) - scale_value(new_values, config.value_epsilon))
    new_prios = torch.where(in_ep, torch.clamp_min(new_prios, 1e-3), torch.zeros_like(new_prios))

    # Unoccupied rows keep what they hold (idempotent on an under-filled buffer).
    keep = occupied[:, None]
    buffer.values[slots] = torch.where(keep, new_values.to(VALUE_DTYPE), buffer.values[slots])
    buffer.step_priorities[slots] = torch.where(keep, new_prios.to(PRIORITY_DTYPE), buffer.step_priorities[slots])
    if new_policies is not None:
        new_policies = torch.where(in_ep[..., None], new_policies, torch.zeros_like(new_policies))
        buffer.policies[slots] = torch.where(keep[..., None], new_policies.to(POLICY_DTYPE), buffer.policies[slots])
    return buffer


def reanalyze_pass(
    buffer: replay_lib.BufferState,
    network: MuZeroNetwork,
    cursor: int,
    config: TrainConfig,
    generator: torch.Generator | None = None,
) -> tuple[replay_lib.BufferState, int]:
    """One round-robin reanalyze pass: refresh ``reanalyze_episodes`` rows
    starting at ``cursor``, wrapping over the occupied region.

    Round-robin order bounds every episode's target staleness at
    ``size / reanalyze_episodes`` passes. Returns the buffer and the advanced
    cursor.
    """
    size = int(buffer.size)
    if size == 0:
        return buffer, cursor
    n = min(config.reanalyze_episodes, size)
    slots = (cursor + torch.arange(n, dtype=torch.int64, device=buffer.length.device)) % size
    buffer = reanalyze_slots(buffer, network, slots, config, generator)
    return buffer, (cursor + n) % size

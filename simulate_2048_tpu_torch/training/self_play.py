"""Self-play and greedy evaluation games, in PyTorch (port of the JAX
package's ``training/self_play.py``).

One loop iteration is one move of every game: observation and legal mask,
one batched search, the action (sampled from the visit weights at the
scheduled temperature, or their argmax), and the environment step.
:func:`play_segment` records a trajectory segment of ``max_trajectory_length``
moves from wherever the games are; games carry over between calls and
finished lanes restart at the segment boundary. :func:`_evaluate_rollout`
plays greedy games to their end (or ``eval_max_moves``) and keeps summary
statistics only. The search runs on the whole-search kernel
(``ops/search_kernel.py``) or on the plain search (``search/mcts.py``),
dispatched as in the JAX package (see ``TrainConfig.search_backend``); the
weights are packed once per call, outside the move loop.

Every draw (root noise, Dirichlet or Gumbel; the chance draws of sampled
chance selection; action sampling; run seeds) comes from the
``torch.Generator`` passed in, which lives on the device the games run on;
evaluation takes only its run seed from the generator passed in (on any
device) and its chance draws from a generator on the games' device seeded
with that run seed. The streams are not ``jax.random``'s: the same seed gives other games than
the JAX package. ``play_segment`` also takes the root noise, the chance
draws and the sampling uniforms as tensors, so both packages can be fed the
same numbers.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops import search_kernel
from simulate_2048_tpu_torch.ops.value_transform import scale_value
from simulate_2048_tpu_torch.search.mcts import (
    PolicyOutput,
    SearchConfig,
    batched_run_mcts,
    draw_root_noise,
    uses_root_noise,
)
from simulate_2048_tpu_torch.search.policy import get_policy_target, sample_from_visits
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.replay import Trajectory
from simulate_2048_tpu_torch.utils import tracing


class GenStats(NamedTuple):
    """Collection diagnostics of one self-play segment, as sums and counts on
    the device (finish with :func:`finish_gen_stats`)."""

    completed: torch.Tensor  # games finished inside this segment
    completed_score_sum: torch.Tensor  # their full-game scores
    completed_length_sum: torch.Tensor  # their full-game lengths (moves)
    active_positions: torch.Tensor  # stored (non-padding) positions in the segment
    policy_entropy_sum: torch.Tensor  # entropy of stored policy targets
    search_value_sum: torch.Tensor  # raw-space root values ν
    # Per-lane ν at the segment's first position: the (1−λ) bootstrap piece
    # when the previous truncated segment's targets are backfilled
    # (``replay.backfill_returns``).
    first_search_value: torch.Tensor  # (B,)


def search_config_from(config: TrainConfig, eval_mode: bool = False) -> SearchConfig:
    """Lift the MCTS block of a TrainConfig into a SearchConfig; with
    ``eval_mode`` the eval-only calibration overrides apply and the root
    selection is PUCT."""
    prior_temperature = config.prior_temperature
    pb_c_init = config.pb_c_init
    root_selection = config.root_selection
    if eval_mode:
        if config.eval_prior_temperature is not None:
            prior_temperature = config.eval_prior_temperature
        if config.eval_pb_c_init is not None:
            pb_c_init = config.eval_pb_c_init
        root_selection = "puct"
    return SearchConfig(
        num_simulations=config.num_simulations,
        num_actions=config.action_size,
        codebook_size=config.codebook_size,
        discount=config.discount,
        dirichlet_alpha=config.dirichlet_alpha,
        dirichlet_fraction=config.dirichlet_fraction,
        pb_c_init=pb_c_init,
        pb_c_base=config.pb_c_base,
        max_depth=config.search_max_depth,
        root_selection=root_selection,
        gumbel_c_visit=config.gumbel_c_visit,
        gumbel_c_scale=config.gumbel_c_scale,
        chance_selection=config.chance_selection,
        pw_c=config.pw_c,
        pw_alpha=config.pw_alpha,
        prior_temperature=prior_temperature,
        value_transform_epsilon=(config.value_epsilon if config.search_untransform_values else None),
        value_bins=config.value_bins,
        reward_bins=config.reward_bins,
        value_support_max=config.value_support_max,
        reward_support_max=config.reward_support_max,
    )


def _search_weight_dtype(config: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if config.search_weight_dtype == "bfloat16" else torch.float32


def _use_kernel(config: TrainConfig, cfg: SearchConfig, device: torch.device) -> bool:
    """The JAX package's backend dispatch (its ``training/self_play.py:150-171``),
    read for the port, decided by the kernel's own limits
    (``search_kernel.kernel_limits``: its scope, PUCT root selection, argmax
    chance selection and no progressive widening, judged on the search config
    ``cfg``, as evaluation searches use the PUCT root; and the widths, bins
    and weight types it takes). "pallas" takes the kernel wrapper (the kernel
    on CUDA, its plain version on the CPU) and raises where the kernel
    refuses the config: on CUDA for any limit, on the CPU, whose plain
    version takes any shape, outside the scope. "auto" takes the kernel on
    CUDA where the limits hold and the plain search otherwise, as JAX's
    takes its kernel only where ``pallas_search_plan`` returns a plan."""
    if config.search_backend == "xla":
        return False
    refused = search_kernel.kernel_limits(cfg, config.hidden_size, _search_weight_dtype(config))
    if config.search_backend == "pallas":
        if refused is not None and (device.type == "cuda" or not search_kernel.in_scope(cfg)):
            raise ValueError(f"search_backend='pallas' but {refused}")
        return True
    return refused is None and device.type == "cuda"


SearchFn = Callable[..., PolicyOutput]


def _make_search(network, config: TrainConfig, cfg: SearchConfig, device: torch.device) -> SearchFn:
    """``search(observations, invalid_actions, noise, chance_noise,
    generator)`` for one weight version: the whole-search kernel with the
    weights packed here, once, in the layout :func:`search_kernel.search_plan`
    picks (resident or streamed, in ``config.search_weight_dtype``), or the
    plain search, which alone takes the chance draws of sampled chance
    selection (tensor or generator)."""
    if not _use_kernel(config, cfg, device):
        return lambda obs, invalid, noise=None, chance_noise=None, generator=None: batched_run_mcts(
            network, obs, cfg, invalid, noise, chance_noise, generator
        )
    weight_dtype = _search_weight_dtype(config)
    # The kernel's layout; on the CPU the plain version also runs shapes the kernel refuses, resident.
    fits = search_kernel.kernel_limits(cfg, config.hidden_size, weight_dtype) is None
    chunk = search_kernel.search_plan(cfg, config.hidden_size, weight_dtype) if fits else 0
    packed = search_kernel.pack_search_params(
        network,
        config.num_residual_blocks,
        max(config.action_size, config.codebook_size),
        weight_dtype,
        chunk or None,
        value_bins=config.value_bins,
        reward_bins=config.reward_bins,
    )
    workspace = search_kernel.SearchWorkspace(packed)
    return lambda obs, invalid, noise=None, chance_noise=None, generator=None: search_kernel.run_search_kernel(
        network, obs, cfg, invalid, noise, packed=packed, workspace=workspace
    )


def _draw_seed(generator: torch.Generator) -> int:
    """A run seed in [0, 2^30) from ``generator`` (on whichever device it lives)."""
    return int(torch.randint(0, 1 << 30, (), generator=generator, device=generator.device))


@torch.no_grad()
def play_segment(
    network,
    env_state: envlib.GameState,
    generator: torch.Generator | None,
    temperature: float,
    config: TrainConfig,
    num_games: int,
    greedy: bool = False,
    num_steps: int | None = None,
    noise: torch.Tensor | None = None,
    uniform: torch.Tensor | None = None,
    chance_noise: torch.Tensor | None = None,
) -> tuple[envlib.GameState, Trajectory, GenStats]:
    """Play one trajectory segment from wherever the games currently are.

    Games carry over between calls through ``env_state``; a game that ends
    inside the segment is flagged ``terminated`` and its lane restarts
    (deterministically reseeded) at the segment boundary, while unfinished
    games continue in the next segment.

    - Policy targets are stored at temperature 1.0 while actions are sampled
      at the scheduled ``temperature`` (argmax past
      ``config.temperature_move_cutoff`` moves of a game).
    - ``greedy=True`` takes the evaluation search settings, disables the
      root noise and plays argmax actions: nothing is drawn.
    - ``noise`` (T, B, A) replaces the root noise drawn from ``generator``
      (Dirichlet under the PUCT root, standard Gumbel under the Gumbel
      root), ``uniform`` (T, B) the action-sampling uniforms and
      ``chance_noise`` (T, B, S, S + 1, K) the chance draws of sampled
      chance selection (:func:`search.mcts.search_tree`).

    Returns ``(next_env_state, trajectory, gen_stats)``; the trajectory's
    ``total_reward`` is the reward earned within this segment.
    """
    with tracing.span("segment", unit=True):
        t_max = num_steps or config.max_trajectory_length
        cfg = search_config_from(config, eval_mode=greedy)
        if greedy:
            cfg = cfg._replace(dirichlet_fraction=0.0)
        device = env_state.board.device
        search = _make_search(network, config, cfg, device)
        a = config.action_size

        state = env_state
        initial_total = state.total_reward
        boards = torch.zeros(num_games, t_max + 1, 16, dtype=torch.int8, device=device)
        actions_bt = torch.zeros(num_games, t_max, dtype=torch.int8, device=device)
        rewards_bt = torch.zeros(num_games, t_max, dtype=torch.float32, device=device)
        policies_bt = torch.zeros(num_games, t_max, a, dtype=torch.float32, device=device)
        values_bt = torch.zeros(num_games, t_max, dtype=torch.float32, device=device)
        active_bt = torch.zeros(num_games, t_max, dtype=torch.bool, device=device)

        for t in range(t_max):
            with tracing.span("move.observe"):
                obs = envlib.get_observation(state)
                legal = envlib.get_legal_actions(state)
                active = ~state.done

            # Root legality masking: simulations never visit illegal root actions.
            step_noise = None
            if uses_root_noise(cfg):
                with tracing.span("move.noise"):
                    step_noise = noise[t] if noise is not None else draw_root_noise(cfg, num_games, generator, device)
            out = search(obs, ~legal, step_noise, None if chance_noise is None else chance_noise[t], generator)

            with tracing.span("move.act"):
                policy_target = get_policy_target(out, legal, 1.0)
                if greedy:
                    actions = torch.where(legal, out.action_weights, torch.zeros_like(out.action_weights)).argmax(-1)
                else:
                    temps = torch.full((num_games,), float(temperature), dtype=torch.float32, device=device)
                    if config.temperature_move_cutoff is not None:
                        temps = torch.where(
                            state.step_count < config.temperature_move_cutoff, temps, torch.zeros_like(temps)
                        )
                    actions = sample_from_visits(out, legal, temps, generator, None if uniform is None else uniform[t])

            with tracing.span("env.step"):
                new_state, reward, _, _ = envlib.step(state, actions)
            with tracing.span("move.record"):
                boards[:, t] = state.board.flatten(-2).to(torch.int8)
                actions_bt[:, t] = actions.to(torch.int8) * active.to(torch.int8)
                rewards_bt[:, t] = reward * active
                policies_bt[:, t] = policy_target * active[:, None]
                values_bt[:, t] = out.search_value * active
                active_bt[:, t] = active
            state = new_state

        with tracing.span("segment.finish"):
            final_state = state
            boards[:, t_max] = final_state.board.flatten(-2).to(torch.int8)
            lengths = active_bt.sum(-1, dtype=torch.int32)
            priorities = collection_priorities(rewards_bt, values_bt, lengths, config, final_state.done)

            traj = Trajectory(
                boards=boards,
                actions=actions_bt,
                rewards=rewards_bt,
                policies=policies_bt,
                values=values_bt,
                priorities=priorities,
                length=lengths,
                terminated=final_state.done,
                total_reward=final_state.total_reward - initial_total,
                max_tile=ops.max_tile(boards[:, -1].reshape(num_games, 4, 4).to(torch.int32)),
            )

            # Collection diagnostics, before dead lanes are reseeded (every lane is
            # active at segment entry, so done-at-end means the game finished here).
            entropy = -(policies_bt * torch.log(torch.clamp_min(policies_bt, 1e-12))).sum(-1)
            done = final_state.done
            zero = torch.zeros((), dtype=torch.float32, device=device)
            stats = GenStats(
                completed=done.sum(dtype=torch.int32),
                completed_score_sum=torch.where(done, final_state.total_reward, zero).sum(),
                completed_length_sum=torch.where(
                    done, final_state.step_count, torch.zeros_like(final_state.step_count)
                ).sum(),
                active_positions=lengths.sum(),
                policy_entropy_sum=(entropy * active_bt).sum(),
                search_value_sum=values_bt.sum(),
                first_search_value=values_bt[:, 0],
            )
            tracing.count("selfplay.lanes_searched", num_games * t_max)
            tracing.count("selfplay.lanes_active", stats.active_positions)
            return envlib.reset_done(final_state), traj, stats


def play_games(
    network,
    generator: torch.Generator,
    temperature: float,
    config: TrainConfig,
    num_games: int,
    greedy: bool = False,
    num_steps: int | None = None,
) -> Trajectory:
    """Play ``num_games`` fresh episodes in lockstep (one segment from reset),
    on the network's device; the run seed comes from ``generator``."""
    device = next(network.parameters()).device
    state = envlib.reset_batch(_draw_seed(generator), num_games, device)
    _, traj, _ = play_segment(network, state, generator, temperature, config, num_games, greedy, num_steps)
    return traj


def generate_games(
    network,
    generator: torch.Generator,
    config: TrainConfig,
    training_step: int,
    num_games: int | None = None,
    env_state: envlib.GameState | None = None,
):
    """Self-play generation entry point.

    With ``env_state`` given, plays one segment continuing those games and
    returns ``(next_env_state, trajectory, gen_stats)``; without it, plays
    fresh episodes and returns just the trajectory. With
    ``config.value_target_mode == "td_lambda"`` the stored value targets are
    TD(λ) n-step returns instead of raw search values
    (:func:`compute_n_step_returns`).
    """
    temperature = float(config.get_temperature(training_step))
    n = num_games or config.num_parallel_games
    if env_state is not None:
        next_state, traj, stats = play_segment(network, env_state, generator, temperature, config, n, False)
    else:
        traj = play_games(network, generator, temperature, config, n, False)
    if config.value_target_mode == "td_lambda":
        with tracing.span("segment.returns"):
            returns = compute_n_step_returns(traj.rewards, traj.values, traj.length, config, traj.terminated)
            traj = traj._replace(values=returns)
    return (next_state, traj, stats) if env_state is not None else traj


def finish_gen_stats(stats: GenStats, traj: Trajectory) -> dict[str, float]:
    """Collection diagnostics → loggable means (one small host transfer).
    ``traj`` is the trajectory :func:`generate_games` returned alongside
    ``stats``: its ``values`` hold the final stored targets. The target and
    priority sums are taken by NumPy on the host, as the JAX package takes
    them, so that both log the same numbers for the same segment."""
    n_pos = max(int(stats.active_positions), 1)
    n_done = max(int(stats.completed), 1)
    targets = traj.values.to(torch.float32).cpu().numpy()
    priorities = traj.priorities.to(torch.float32).cpu().numpy()
    return {
        "gen/completed_games": int(stats.completed),
        "gen/completed_score": float(stats.completed_score_sum) / n_done,
        "gen/completed_length": float(stats.completed_length_sum) / n_done,
        "gen/positions": int(stats.active_positions),
        "gen/policy_entropy": float(stats.policy_entropy_sum) / n_pos,
        "gen/search_value": float(stats.search_value_sum) / n_pos,
        "gen/value_target": float(targets.sum()) / n_pos,
        "gen/priority": float(priorities.sum()) / n_pos,
    }


def collection_priorities(
    rewards: torch.Tensor, values: torch.Tensor, lengths: torch.Tensor, config: TrainConfig, terminated: torch.Tensor
) -> torch.Tensor:
    """Per-position priorities at collection time: p_t = |h(ν_t) − h(z_t)|
    between the stored search value and the TD(λ) return, in h-scaled space
    like the learner's refresh rule (``learner.train_step``)."""
    returns = compute_n_step_returns(rewards, values, lengths, config, terminated)
    return torch.abs(scale_value(values, config.value_epsilon) - scale_value(returns, config.value_epsilon))


def compute_n_step_returns(
    rewards: torch.Tensor,
    values: torch.Tensor,
    lengths: torch.Tensor,
    config: TrainConfig,
    terminated: torch.Tensor | None = None,
    tail_value: torch.Tensor | None = None,
) -> torch.Tensor:
    """TD(λ) value targets over a trajectory batch ``(B, T)``: the backward
    recursion G_t = r_t + γ[(1−λ) v_{t+1} + λ G_{t+1}], truncated at the
    episode's end.

    ``terminated`` (per episode) selects the boundary: True, the game ended,
    so the last step's target is r_last; False, the segment ended mid-game,
    so the target at the last stored position is forced to its own search
    value ν_last and the recursion proceeds backward from there. With
    ``tail_value`` (B,), a value estimate of the board after the last stored
    position, the truncated boundary target is r_last + γ·tail_value instead.
    """
    gamma, lam = config.discount, config.td_lambda
    t_max = rewards.shape[-1]
    steps = torch.arange(t_max, device=rewards.device)
    in_ep = steps[None, :] < lengths[:, None]
    term = terminated if terminated is not None else torch.ones_like(lengths, dtype=torch.bool)
    last = torch.clamp_min(lengths - 1, 0).to(torch.int64)
    last_value = values.gather(-1, last[:, None])[:, 0]
    if tail_value is not None:
        last_value = rewards.gather(-1, last[:, None])[:, 0] + gamma * tail_value
    force = (steps[None, :] + 1 == lengths[:, None]) & ~term[:, None]

    v_next = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=-1)
    v_next = torch.where(steps[None, :] + 1 < lengths[:, None], v_next, torch.zeros_like(v_next))

    out = torch.zeros_like(rewards)
    g = torch.zeros_like(rewards[:, 0])
    zero = torch.zeros_like(g)
    for t in reversed(range(t_max)):
        g = rewards[:, t] + gamma * ((1 - lam) * v_next[:, t] + lam * g)
        g = torch.where(force[:, t], last_value, g)
        g = torch.where(in_ep[:, t], g, zero)
        out[:, t] = g
    return out


@torch.no_grad()
def _evaluate_rollout(
    network,
    run_seed: int,
    config: TrainConfig,
    num_games: int,
    device: torch.device | str,
):
    """Greedy full-game rollouts with streaming stats. The chance draws of
    sampled chance selection, which evaluation keeps (only the root turns to
    PUCT), come from a generator on ``device`` seeded with ``run_seed``: the
    games and their searches are a function of the run seed alone, whatever
    generator drew it.

    Returns ``(state, entropy_sum, search_value_sum, n_active, codes_used)``
    as the JAX package does: sums over active games of root visit entropy
    and search value, the count of active (game, move) pairs, and which
    encoder codes were used.
    """
    with tracing.span("eval.rollout", unit=True):
        device = torch.device(device)
        cfg = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
        state = envlib.reset_batch(run_seed, num_games, device)
        search = _make_search(network, config, cfg, device)
        generator = torch.Generator(device=device).manual_seed(run_seed)

        ent_sum = torch.zeros((), dtype=torch.float32, device=device)
        val_sum = torch.zeros((), dtype=torch.float32, device=device)
        n_active = torch.zeros((), dtype=torch.int32, device=device)
        codes_used = torch.zeros(config.codebook_size, dtype=torch.bool, device=device)
        for _ in range(config.eval_max_moves):
            with tracing.span("eval.done_read"):
                if bool(state.done.all()):
                    break
            with tracing.span("move.observe"):
                obs = envlib.get_observation(state)
                legal = envlib.get_legal_actions(state)
                active = ~state.done

            out = search(obs, ~legal, None, None, generator)
            zeros = torch.zeros_like(out.action_weights)
            actions = torch.where(legal, out.action_weights, zeros).argmax(-1)

            with tracing.span("eval.stats"):
                probs = get_policy_target(out, legal, 1.0)
                entropy = -(probs * torch.log(torch.clamp_min(probs, 1e-12))).sum(-1)
                ent_sum = ent_sum + torch.where(active, entropy, torch.zeros_like(entropy)).sum()
                val_sum = val_sum + torch.where(active, out.search_value, torch.zeros_like(out.search_value)).sum()
                n_active = n_active + active.sum(dtype=torch.int32)
                code = network.encoder(obs).argmax(-1)
                hit = torch.nn.functional.one_hot(code, config.codebook_size).bool() & active[:, None]
                codes_used = codes_used | hit.any(0)

            with tracing.span("env.step"):
                state, _, _, _ = envlib.step(state, actions)
        return state, ent_sum, val_sum, n_active, codes_used


def evaluate_games(
    network,
    generator: torch.Generator,
    config: TrainConfig,
    num_games: int | None = None,
    include_per_game: bool = False,
) -> dict[str, Any]:
    """Greedy evaluation with summary stats, on the network's device.

    The run seed of the games is drawn from ``generator``, on any device
    (the JAX package draws it with ``jax.random.randint``, so the same seed
    number gives other games there); everything else follows from it.
    """
    n = num_games or config.eval_games
    device = next(network.parameters()).device
    run_seed = _draw_seed(generator)
    state, ent_sum, val_sum, n_active, codes_used = _evaluate_rollout(network, run_seed, config, n, device)

    with tracing.span("eval.summary"):
        rewards = state.total_reward.cpu().numpy()
        tiles = ops.max_tile(state.board).cpu().numpy()
        n_act = max(int(n_active), 1)
        stats: dict[str, Any] = {
            "mean_reward": float(rewards.mean()),
            "std_reward": float(rewards.std()),
            "sem_reward": float(rewards.std() / max(np.sqrt(rewards.size), 1.0)),
            "max_reward": float(rewards.max()),
            "min_reward": float(rewards.min()),
            "mean_max_tile": float(tiles.mean()),
            "max_tile": int(tiles.max()),
            "mean_length": float(state.step_count.float().mean()),
            "encoder_codes_used": int(codes_used.sum()),
            "mean_search_entropy": float(ent_sum) / n_act,
            "mean_search_value": float(val_sum) / n_act,
        }
        for tile in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
            stats[f"reached_{tile}"] = int((tiles >= tile).sum())
        if include_per_game:
            stats["per_game_rewards"] = rewards.tolist()
            stats["per_game_tiles"] = tiles.tolist()
            stats["per_game_lengths"] = state.step_count.cpu().tolist()
        return stats

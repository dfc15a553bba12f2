"""Greedy evaluation games, in PyTorch (the evaluation subset of the JAX
package's ``training/self_play.py``: ``search_config_from``,
``_evaluate_rollout`` and ``evaluate_games``).

One loop iteration is one greedy move of every game: observation and legal
mask, one batched search, the argmax action over visit weights, encoder code
usage, and the environment step. The loop ends when every game is done or
after ``eval_max_moves`` moves. The search runs on the whole-search kernel
(``ops/search_kernel.py``) or on the plain search (``search/mcts.py``),
dispatched as in the JAX package (see ``TrainConfig.search_backend``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops import search_kernel
from simulate_2048_tpu_torch.search.mcts import SearchConfig, batched_run_mcts
from simulate_2048_tpu_torch.search.policy import get_policy_target
from simulate_2048_tpu_torch.training.config import TrainConfig


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


def _use_kernel(config: TrainConfig, device: torch.device) -> bool:
    """The JAX package's backend dispatch, read for the port: "pallas" takes
    the kernel wrapper (the kernel on CUDA, its plain version on the CPU),
    "auto" the kernel on CUDA only. Both searches raise for the variants
    that are not ported yet (``search.mcts.check_supported``)."""
    if config.search_backend == "xla":
        return False
    return config.search_backend == "pallas" or device.type == "cuda"


@torch.no_grad()
def _evaluate_rollout(network, run_seed: int, config: TrainConfig, num_games: int, device: torch.device | str):
    """Greedy full-game rollouts with streaming stats.

    Returns ``(state, entropy_sum, search_value_sum, n_active, codes_used)``
    as the JAX package does: sums over active games of root visit entropy
    and search value, the count of active (game, move) pairs, and which
    encoder codes were used.
    """
    device = torch.device(device)
    cfg = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
    state = envlib.reset_batch(run_seed, num_games, device)

    packed = workspace = None
    if _use_kernel(config, device):
        # Packed once per call (one weight version), outside the move loop.
        packed = search_kernel.pack_search_params(
            network,
            config.num_residual_blocks,
            max(config.action_size, config.codebook_size),
            torch.bfloat16 if config.search_weight_dtype == "bfloat16" else torch.float32,
            value_bins=config.value_bins,
            reward_bins=config.reward_bins,
        )
        workspace = search_kernel.SearchWorkspace(packed)

    ent_sum = torch.zeros((), dtype=torch.float32, device=device)
    val_sum = torch.zeros((), dtype=torch.float32, device=device)
    n_active = torch.zeros((), dtype=torch.int32, device=device)
    codes_used = torch.zeros(config.codebook_size, dtype=torch.bool, device=device)
    for _ in range(config.eval_max_moves):
        if bool(state.done.all()):
            break
        obs = envlib.get_observation(state)
        legal = envlib.get_legal_actions(state)
        active = ~state.done

        if packed is not None:
            out = search_kernel.run_search_kernel(network, obs, cfg, ~legal, packed=packed, workspace=workspace)
        else:
            out = batched_run_mcts(network, obs, cfg, ~legal)
        zeros = torch.zeros_like(out.action_weights)
        actions = torch.where(legal, out.action_weights, zeros).argmax(-1)

        probs = get_policy_target(out, legal, 1.0)
        entropy = -(probs * torch.log(torch.clamp_min(probs, 1e-12))).sum(-1)
        ent_sum = ent_sum + torch.where(active, entropy, torch.zeros_like(entropy)).sum()
        val_sum = val_sum + torch.where(active, out.search_value, torch.zeros_like(out.search_value)).sum()
        n_active = n_active + active.sum(dtype=torch.int32)
        code = network.encoder(obs).argmax(-1)
        hit = torch.nn.functional.one_hot(code, config.codebook_size).bool() & active[:, None]
        codes_used = codes_used | hit.any(0)

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

    The run seed of the games is drawn from ``generator`` (the JAX package
    draws it with ``jax.random.randint``, so the same seed number gives
    other games there).
    """
    n = num_games or config.eval_games
    device = next(network.parameters()).device
    run_seed = int(torch.randint(0, 1 << 30, (), generator=generator))
    state, ent_sum, val_sum, n_active, codes_used = _evaluate_rollout(network, run_seed, config, n, device)

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

"""Evaluation CLI: ``python -m simulate_2048_tpu_torch.evaluate --mode full --games 256``.

Port of ``simulate_2048_tpu.evaluate``: greedy full-length games
(``eval_max_moves``) under the calibrated eval search, printing what the JAX
CLI prints. Runs on the GPU unless ``--device cpu`` is given, and raises when
no GPU is present. With ``--checkpoint-dir`` the weights and the config come
from a checkpoint written by ``simulate_2048_tpu_torch.train``; without it
the weights are fresh, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import collections


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate a Stochastic MuZero agent on 2048 (PyTorch port)")
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="small", help="config preset")
    parser.add_argument("--games", type=int, default=10)
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="evaluate the latest checkpoint in this directory with its recorded config "
        "(--mode is then ignored; --set still applies); fresh weights when not given",
    )
    parser.add_argument("--step", type=int, default=None, help="checkpoint step (default: the latest)")
    parser.add_argument(
        "--seed",
        type=int,
        default=0,
        help="seeds the weights (JAX's PRNGKey(seed): the JAX CLI's weights for the same number) and the "
        "games' run seed (torch.Generator(seed + 1); the JAX CLI maps the same number to other games)",
    )
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="override any TrainConfig field after preset resolution; repeatable",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    import os

    import torch

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.models.network import network_from_config
    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.training.config import apply_overrides, default_config, small_config, tiny_config
    from simulate_2048_tpu_torch.training.self_play import evaluate_games

    device = resolve_device(args.device)
    config = {"tiny": tiny_config, "small": small_config, "full": default_config}[args.mode]()
    manager = None
    if args.checkpoint_dir:
        from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager, load_train_config

        if not os.path.isdir(args.checkpoint_dir):
            parser.error(f"--checkpoint-dir {args.checkpoint_dir}: no such directory")
        manager = CheckpointManager(args.checkpoint_dir)
        step = manager.latest_step() if args.step is None else args.step
        if step not in manager.all_steps():
            parser.error(f"--checkpoint-dir {args.checkpoint_dir}: no checkpoint (steps found: {manager.all_steps()})")
        recorded = load_train_config(args.checkpoint_dir)
        if recorded is not None:
            config = recorded
    if args.overrides:
        try:
            config = apply_overrides(config, args.overrides)
        except ValueError as e:
            parser.error(str(e))
        print(f"config overrides: {args.overrides}")

    network = network_from_config(config, prng_key(args.seed), device)
    if manager is not None:
        from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer

        state = TrainState(network, create_optimizer(config).init(list(network.parameters())))
        manager.restore(state, step)
        print(f"loaded checkpoint step {state.step} from {manager.directory}")
    stats = evaluate_games(
        network, torch.Generator().manual_seed(args.seed + 1), config, num_games=args.games, include_per_game=True
    )

    print(f"games: {args.games}")
    print(
        f"mean reward: {stats['mean_reward']:.1f} ± {stats['std_reward']:.1f}"
        f" (sem {stats['sem_reward']:.1f}, max {stats['max_reward']:.0f})"
    )
    print(f"mean length: {stats['mean_length']:.1f}")
    print(f"mean search value: {stats['mean_search_value']:.1f}")
    histogram = collections.Counter(stats["per_game_tiles"])
    print("max-tile histogram:")
    for tile in sorted(histogram):
        print(f"  {tile}: {histogram[tile]}")
    for tile in (512, 1024, 2048):
        print(f"reached {tile}: {stats[f'reached_{tile}']}/{args.games}")


if __name__ == "__main__":
    main()

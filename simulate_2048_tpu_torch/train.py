"""Training CLI: ``python -m simulate_2048_tpu_torch.train --mode tiny|small|full``.

Port of ``simulate_2048_tpu.train``: initialise (resuming from
``--checkpoint-dir`` when it holds a checkpoint), fill the replay buffer by
self-play, train, and evaluate. Runs on the GPU unless ``--device cpu`` is
given, and raises when no GPU is present.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description="Train Stochastic MuZero on 2048 (PyTorch port)")
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="small")
    parser.add_argument("--steps", type=int, default=None, help="override training steps")
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--no-eval", action="store_true")
    parser.add_argument("--data-parallel", action="store_true", help="not yet ported")
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="override any TrainConfig field, e.g. --set value_bins=256 (repeatable; values parsed "
        "as Python literals, falling back to str)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError("--data-parallel is not yet ported")

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.training.config import apply_overrides, default_config, small_config, tiny_config
    from simulate_2048_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    config = {"tiny": tiny_config, "small": small_config, "full": default_config}[args.mode]()
    if args.overrides:
        try:
            config = apply_overrides(config, args.overrides)
        except ValueError as e:
            parser.error(str(e))
        print(f"config overrides: {args.overrides}")
    print(f"mode={args.mode} device={device}")

    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir, seed=args.seed, device=device)
    trainer.initialize()
    trainer.fill_buffer()
    trainer.train(args.steps)

    if not args.no_eval:
        stats = trainer.evaluate()
        print("final evaluation:")
        for key, value in stats.items():
            print(f"  {key}: {value}")
    trainer.metrics.close()
    return trainer


if __name__ == "__main__":
    main()

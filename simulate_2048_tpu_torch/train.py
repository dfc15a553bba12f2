"""Training CLI: ``python -m simulate_2048_tpu_torch.train --mode tiny|small|full``.

Port of ``simulate_2048_tpu.train``: initialise (resuming from
``--checkpoint-dir`` when it holds a checkpoint), fill the replay buffer by
self-play, train, and evaluate. Runs on the GPU unless ``--device cpu`` is
given, and raises when no GPU is present. ``--data-parallel`` runs the
learner data-parallel over every visible CUDA device when there is more than
one (``parallel/``), and on the one device otherwise.
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
    parser.add_argument("--data-parallel", action="store_true", help="shard the learner over all visible GPUs")
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

    import torch

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

    mesh = None
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        from simulate_2048_tpu_torch.parallel import make_mesh

        mesh = make_mesh()
        device = None  # the trainer runs on the mesh's first device
        print(f"data-parallel over {mesh.size} devices")

    trainer = Trainer(
        config, checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir, seed=args.seed, mesh=mesh, device=device
    )
    trainer.initialize()
    try:
        trainer.fill_buffer()
        trainer.train(args.steps)

        if not args.no_eval:
            stats = trainer.evaluate()
            print("final evaluation:")
            for key, value in stats.items():
                print(f"  {key}: {value}")
    finally:
        trainer.metrics.close()
        if torch.cuda.is_initialized():
            print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    return trainer


if __name__ == "__main__":
    main()

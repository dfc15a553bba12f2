"""Trace a window of a trained run: ``python -m simulate_2048_tpu_torch.scripts.trace_training``.

``--checkpoint-dir DIR [--moves N] [--steps M] [--log-dir profiles] [--top K]``
resumes the port's trainer from DIR (its latest checkpoint and the
``train_config.json`` beside it), fills the replay buffer by self-play with
the restored weights, then traces ``N`` self-play moves (default: one
segment, ``max_trajectory_length``) and ``M`` learner steps (default 20)
under ``utils.profiling.trace`` and prints ``trace_summary`` of the trace:
where the device time of that training goes. Runs on the GPU unless given
``--device cpu``; no checkpoint is written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from simulate_2048_tpu_torch.training.self_play import play_segment
from simulate_2048_tpu_torch.utils.profiling import trace


def trace_window(trainer, moves: int, steps: int, log_dir: str | Path) -> Path:
    """Trace ``moves`` self-play moves of the trainer's games (one segment,
    not stored) and then ``steps`` learner steps; returns the trace's path."""
    config = trainer.config
    temperature = float(config.get_temperature(trainer.state.step))
    log_dir = Path(log_dir)
    before = set(log_dir.glob("trace-*.json"))
    with trace(str(log_dir)):
        play_segment(
            trainer.network,
            trainer.gen_state,
            trainer._generator,
            temperature,
            config,
            config.num_parallel_games,
            num_steps=moves,
        )
        for _ in range(steps):
            trainer.optimize_step()
    (path,) = set(log_dir.glob("trace-*.json")) - before
    return path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Trace self-play moves and learner steps of a trained run")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--moves", type=int, default=None, help="self-play moves traced (default: one segment)")
    parser.add_argument("--steps", type=int, default=20, help="learner steps traced")
    parser.add_argument("--log-dir", default="profiles")
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.scripts.trace_summary import summarize
    from simulate_2048_tpu_torch.training.checkpoint import load_train_config
    from simulate_2048_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    config = load_train_config(args.checkpoint_dir)
    if config is None:
        parser.error(f"{args.checkpoint_dir} holds no train_config.json")
    trainer = Trainer(config, checkpoint_dir=args.checkpoint_dir, device=device)
    trainer.initialize()
    if trainer.state.step == 0:
        parser.error(f"{args.checkpoint_dir} holds no checkpoint of a trained run")
    print(f"restored step {trainer.state.step} from {args.checkpoint_dir}", flush=True)
    trainer.fill_buffer(verbose=False)
    moves = args.moves or config.max_trajectory_length
    path = trace_window(trainer, moves, args.steps, args.log_dir)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"traced {moves} self-play moves of {config.num_parallel_games} games and {args.steps} learner steps: {path}")
    summarize(path, args.top)


if __name__ == "__main__":
    main()

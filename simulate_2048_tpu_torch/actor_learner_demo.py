"""Asynchronous actor/learner split, one role a process:
``python -m simulate_2048_tpu_torch.actor_learner_demo --role learner|actor``.

Port of the JAX package's ``scripts/actor_learner_demo.py``: the paper's one
learner and N actors. Start the learner, then any number of actors (give
each its own ``--actor-seed``, and the learner's ``--host`` / ``--port``):

  python -m simulate_2048_tpu_torch.actor_learner_demo --role learner --steps 200 &
  python -m simulate_2048_tpu_torch.actor_learner_demo --role actor --actor-seed 1 &
  python -m simulate_2048_tpu_torch.actor_learner_demo --role actor --actor-seed 2 &

The learner never generates games: it fills its replay buffer from the
actors' streams, trains, publishes parameters that the actors pull between
generations (``parallel/actor_learner.py``), evaluates, and keeps serving
until its actors have hung up (at most ``--fill-timeout`` seconds). Both
roles run on the GPU unless ``--device cpu`` is given, and raise when no GPU
is present. Each role prints, on the line before its done line, one JSON
object of its counts: kernel launches (``ops/search_kernel.LAUNCHES``); for
the learner its steps, trajectory batches received, parameters served, each
logged step's rate, the steps at which a host hook (reanalyze, evaluation)
ran, and the wall-clock window of its work (its training loop and its
evaluation); for the actor its generations, moves played, the learner step
each generation saw and each generation's wall-clock window; and the
process's peak device memory.
"""

from __future__ import annotations

import argparse
import json
import time


def hook_steps(history: list[dict]) -> list[int]:
    """Steps of a trainer's metrics history at which a host hook ran: a
    reanalyze pass or an evaluation."""
    return sorted({r["step"] for r in history if any(k.startswith(("reanalyze/", "eval/", "deep_eval/")) for k in r)})


def peak_memory_mb(device) -> dict[str, float | None]:
    """The caching allocator's peaks on ``device`` in MiB (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return {"peak_allocated_mb": None, "peak_reserved_mb": None}
    return {
        "peak_allocated_mb": torch.cuda.max_memory_allocated(device) / 2**20,
        "peak_reserved_mb": torch.cuda.max_memory_reserved(device) / 2**20,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="One role of the asynchronous actor/learner split (PyTorch port)")
    parser.add_argument("--role", choices=["learner", "actor"], required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=29517)
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="tiny")
    parser.add_argument("--steps", type=int, default=100, help="learner optimization steps")
    parser.add_argument("--generations", type=int, default=20, help="actor self-play rounds")
    parser.add_argument("--actor-seed", type=int, default=0)
    parser.add_argument("--fill-timeout", type=float, default=300.0)
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="override any TrainConfig field (repeatable)",
    )
    parser.add_argument("--device", default=None, help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)

    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops import search_kernel
    from simulate_2048_tpu_torch.parallel.actor_learner import ActorClient, LearnerServer
    from simulate_2048_tpu_torch.training.config import apply_overrides, default_config, small_config, tiny_config
    from simulate_2048_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    config = {"tiny": tiny_config, "small": small_config, "full": default_config}[args.mode]()
    if args.overrides:
        try:
            config = apply_overrides(config, args.overrides)
        except ValueError as e:
            parser.error(str(e))

    if args.role == "learner":
        trainer = Trainer(config, device=device)
        trainer.initialize()
        server = LearnerServer(trainer, host=args.host, port=args.port).start()
        print(f"learner listening on {server.address[0]}:{server.address[1]} ({device})", flush=True)
        try:
            server.fill_buffer(timeout_s=args.fill_timeout)
            work_window = [time.time()]
            final = server.run(args.steps)
            stats = trainer.evaluate()
            work_window.append(time.time())
            if not server.wait_for_actors(args.fill_timeout):
                print(f"learner: actors still connected after {args.fill_timeout:.0f}s; closing", flush=True)
            history = trainer.metrics.history
            counts = {
                "role": "learner",
                "launches": dict(search_kernel.LAUNCHES),
                "steps": int(trainer.state.step),
                "trajectories_received": server.trajectories_received,
                "trajectories_dropped": server.trajectories_dropped,
                "params_served": server.params_served,
                "step_rates": [[r["step"], r["steps_per_s"]] for r in history if "trajectories_received" in r],
                "hook_steps": hook_steps(history),
                "work_window": work_window,
                "final_loss": final.get("total_loss"),
                "eval_mean_reward": stats["mean_reward"],
                **peak_memory_mb(device),
            }
            print(json.dumps(counts), flush=True)
            print(
                f"learner done: step {final.get('step')} loss {final.get('total_loss'):.4f} "
                f"traj_batches {server.trajectories_received} params_served {server.params_served} "
                f"eval_reward {stats['mean_reward']:.1f}",
                flush=True,
            )
        finally:
            server.close()
    else:
        actor = ActorClient(config, (args.host, args.port), seed=args.actor_seed, device=device)
        windows, steps_seen = [], []
        start = time.time()

        def on_generation(gen: int, step: int) -> None:
            windows.append([windows[-1][1] if windows else start, time.time()])
            steps_seen.append(step)
            print(f"actor {args.actor_seed}: generation {gen} (learner step {step})", flush=True)

        try:
            actor.run(args.generations, on_generation=on_generation)
        finally:
            actor.close()
        counts = {
            "role": "actor",
            "launches": dict(search_kernel.LAUNCHES),
            "generations": actor.generations,
            "moves": actor.moves_played,
            "learner_steps": steps_seen,
            "generation_windows": windows,
            **peak_memory_mb(device),
        }
        print(json.dumps(counts), flush=True)
        print(f"actor {args.actor_seed} done: {actor.generations} generations", flush=True)


if __name__ == "__main__":
    main()

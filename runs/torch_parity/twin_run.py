"""Both trainers end to end from the same initial weights: the scalar
recipe's options (``scripts/run_scalar60k_arm.sh``) at reduced widths.

The JAX package's ``Trainer`` draws its initial weights from its seed; the
same weights, converted by ``convert.params_from_flax``, are saved as a port
checkpoint at step 0, from which the port's ``Trainer`` resumes. Each package
then fills its buffer and trains with its own draws, and writes its
``metrics.jsonl``. From the repository root:

    # one run on the CPU (JAX, or the port from JAX's converted init)
    JAX_PLATFORMS=cpu PYTHONPATH=. python runs/torch_parity/twin_run.py \\
        --package jax|torch --seed 0 --steps 2000 --out runs/torch_parity/twin_cpu
    # the converted inits alone, for a machine without JAX
    JAX_PLATFORMS=cpu PYTHONPATH=. python runs/torch_parity/twin_run.py --save-init runs/torch_parity/init --seed 0
    # the port from a saved init, on the GPU (imports no JAX); --set takes TrainConfig overrides
    python runs/torch_parity/twin_run.py --package torch --init runs/torch_parity/init --device cuda \\
        --seed 0 --set search_backend=auto --tag cuda_auto --out runs/torch_parity/twin_cuda
    # the same with one stage or source of draws on the CPU (card_variants.py's variants)
    python runs/torch_parity/twin_run.py ... --device cuda --variant learner_cpu --tag cuda_learner_cpu
    # the port drawing its initial weights itself from --seed (since they are JAX's for the seed,
    # this equals the converted init; before, a torch generator seeded with --seed drew them)
    JAX_PLATFORMS=cpu PYTHONPATH=. python runs/torch_parity/twin_run.py --package torch --own-init --tag torch_owninit ...
    # the comparison of every run under a directory
    python runs/torch_parity/twin_run.py --summary runs/torch_parity/twin_cpu runs/torch_parity/twin_cuda

A run writes ``<out>/<tag>_seed<seed>/metrics.jsonl`` (tag: the package).
``--full-width`` keeps the recipe's own widths (``small_config()``: H=128,
5 blocks, 50 simulations, 64 games, batch 256, a generation every 800 steps).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

# The scalar recipe's overrides, and the cuts to a size the CPU trains in minutes.
RECIPE = dict(
    value_target_mode="td_lambda",
    td_lambda=1.0,
    cross_segment_backfill=True,
    afterstate_value_loss_weight=0.25,
    lr_decay_steps=60000,
)
REDUCED = dict(
    hidden_size=32,
    num_residual_blocks=2,
    num_simulations=16,
    num_parallel_games=32,
    batch_size=64,
    generation_interval=200,
    min_buffer_size=128,
)
HOOKS = dict(log_interval=10, eval_interval=10**9, checkpoint_interval=10**9)  # no evaluation, one checkpoint
FULL_WIDTH = False  # --full-width: the recipe's own widths (small_config(): H=128, 5 blocks, 50 simulations, ...)


def cuts() -> dict:
    return HOOKS if FULL_WIDTH else {**REDUCED, **HOOKS}


def jax_config():
    import dataclasses

    from simulate_2048_tpu.training import config as jconfig

    return dataclasses.replace(jconfig.small_config(), **RECIPE, **cuts())


def torch_config(overrides: list[str]):
    import dataclasses

    from simulate_2048_tpu_torch.training import config as tconfig

    cfg = dataclasses.replace(tconfig.small_config(), **RECIPE, **cuts())
    return tconfig.apply_overrides(cfg, overrides)


def jax_trainer(seed: int, log_dir: str | None):
    from simulate_2048_tpu.training.trainer import Trainer

    trainer = Trainer(jax_config(), log_dir=log_dir, seed=seed)
    trainer.initialize()
    return trainer


def save_port_init(seed: int, ckpt_dir: str) -> None:
    """JAX's initial weights at ``seed`` as a port checkpoint at step 0 in ``ckpt_dir``."""
    import jax

    from simulate_2048_tpu_torch.convert import params_from_flax
    from simulate_2048_tpu_torch.training import learner as tlearner
    from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager

    cfg = torch_config([])
    net = params_from_flax(jax.tree.map(np.asarray, jax_trainer(seed, None).state.params), cfg)
    state = tlearner.TrainState(net, tlearner.create_optimizer(cfg).init(list(net.parameters())))
    CheckpointManager(ckpt_dir).save(state, step=0)


def run_jax(args, out: str) -> None:
    trainer = jax_trainer(args.seed, out)
    trainer.fill_buffer(verbose=False)
    trainer.train(args.steps, verbose=False)
    trainer.metrics.close()


def run_torch(args, out: str) -> None:
    import torch

    from simulate_2048_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(args.threads)
    if args.variant != "base":
        from card_variants import patch

        patch(args.variant, args.seed)
    ckpt = args.ckpt_dir or os.path.join(out, "ckpt")
    if args.init:
        os.makedirs(ckpt, exist_ok=True)
        shutil.copy(os.path.join(args.init, f"seed{args.seed}", "step_0.pt"), ckpt)
    elif not args.own_init:
        save_port_init(args.seed, ckpt)
    trainer = Trainer(torch_config(args.overrides), checkpoint_dir=ckpt, log_dir=out, seed=args.seed,
                      device=args.device)
    trainer.initialize()
    if trainer.state.step != 0:
        raise SystemExit(f"{ckpt} resumed at step {trainer.state.step}, not from the initial weights")
    trainer.fill_buffer(verbose=False)
    trainer.train(args.steps, verbose=False)
    trainer.metrics.close()


def window_mean(rows, key: str, lo: int, hi: int) -> float:
    vals = [r[key] for r in rows if key in r and lo <= r["step"] <= hi]
    return float(np.mean(vals)) if vals else float("nan")


def summarize(dirs: list[str]) -> None:
    """One line per run: the mean of gen/completed_score over steps 800 to
    the end, policy_loss at 1,000 and 2,000 and its mean over the last 500
    steps; then each tag's mean and sem over its seeds."""
    by_tag: dict[str, list[tuple[float, float]]] = {}
    for base in dirs:
        for name in sorted(os.listdir(base)):
            path = os.path.join(base, name, "metrics.jsonl")
            if not os.path.exists(path):
                continue
            rows = [json.loads(line) for line in open(path)]
            last = max(r["step"] for r in rows)
            score = window_mean(rows, "gen/completed_score", 800, last)
            tail = window_mean(rows, "policy_loss", last - 500, last)
            at = {s: round(window_mean(rows, "policy_loss", s, s), 4) for s in (1000, 2000)}
            print(json.dumps({"run": f"{os.path.basename(base)}/{name}", "last_step": last,
                              "completed_score_800_end": round(score, 1), "policy_loss_at": at,
                              "policy_loss_last500": round(tail, 4)}))
            by_tag.setdefault(f"{os.path.basename(base)}/{name.split('_seed')[0]}", []).append((score, tail))
    for tag, vals in by_tag.items():
        s, p = np.array(vals).T
        sem = lambda x: round(float(x.std(ddof=1) / np.sqrt(len(x))), 4) if len(x) > 1 else None  # noqa: E731
        print(json.dumps({"tag": tag, "seeds": len(vals), "completed_score_mean": round(float(s.mean()), 1),
                          "completed_score_sem": sem(s), "policy_loss_last500_mean": round(float(p.mean()), 4),
                          "policy_loss_last500_sem": sem(p)}))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=["jax", "torch"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--out", default="runs/torch_parity/twin_cpu")
    parser.add_argument("--tag", default=None, help="run directory prefix (default: the package)")
    parser.add_argument("--init", default=None, help="directory of saved inits (<init>/seed<n>/step_0.pt)")
    parser.add_argument("--save-init", default=None, metavar="DIR", help="only save the converted init of --seed")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--ckpt-dir", default=None, help="the port's checkpoint directory (default <run>/ckpt)")
    parser.add_argument("--set", dest="overrides", action="append", default=[], metavar="FIELD=VALUE")
    parser.add_argument("--threads", type=int, default=1)
    parser.add_argument("--full-width", action="store_true", help="the recipe's widths, not the reduced ones")
    parser.add_argument("--variant", default="base", help="a card_variants.py variant (the port on the GPU)")
    parser.add_argument("--own-init", action="store_true", help="the port draws its initial weights from --seed itself")
    parser.add_argument("--summary", nargs="+", metavar="DIR")
    args = parser.parse_args()
    global FULL_WIDTH
    FULL_WIDTH = args.full_width
    if args.summary:
        summarize(args.summary)
        return
    if args.save_init:
        save_port_init(args.seed, os.path.join(args.save_init, f"seed{args.seed}"))
        return
    out = os.path.join(args.out, f"{args.tag or args.package}_seed{args.seed}")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    (run_jax if args.package == "jax" else run_torch)(args, out)
    print(f"{out}: {args.steps} steps in {time.perf_counter() - t0:.0f} s", file=sys.stderr)


if __name__ == "__main__":
    main()

"""Training curves of a metrics log as a PNG: ``python -m simulate_2048_tpu_torch.scripts.plot_metrics``.

Port of the repository's ``scripts/plot_metrics.py`` on the port's
``metrics.jsonl`` (``utils/metrics.py``, the same record format): one
image of six panels (total and component losses, learner steps/s, codebook
entropy, evaluation reward with its 95% band and the deep evaluations,
evaluation max tile and episode length, codes used and search entropy).
Same arguments (the log, ``-o/--out``, default beside the log) and output
(the PNG's path). ``matplotlib`` is imported by :func:`render` only, so the
module imports where it is not installed; the script runs no torch, so it
takes no ``--device``.

  python -m simulate_2048_tpu_torch.scripts.plot_metrics runs/torch_cat60k/metrics.jsonl -o run.png
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(path: Path) -> tuple[list[dict], list[dict]]:
    """(training rows, evaluation rows) of a metrics log; a row is an
    evaluation if any key starts with ``eval/`` or ``deep_eval/``."""
    train_rows, eval_rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            is_eval = any(k.startswith(("eval/", "deep_eval/")) for k in d)
            (eval_rows if is_eval else train_rows).append(d)
    return train_rows, eval_rows


def series(rows: list[dict], key: str) -> tuple[list, list]:
    """(steps, values) of ``key`` over the rows that have it and a step."""
    pts = [(r["step"], r[key]) for r in rows if key in r and r.get("step") is not None]
    return [p[0] for p in pts], [p[1] for p in pts]


def render(path: Path, out: str | None = None) -> str:
    """Draw the dashboard of the log at ``path`` into ``out`` (default: the
    log's path with ``.png``); returns the image's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    train_rows, eval_rows = load(path)
    if not train_rows and not eval_rows:
        raise SystemExit(f"no metrics in {path}")

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    fig.suptitle(f"{path} — {len(train_rows)} train rows, {len(eval_rows)} evals")

    ax = axes[0, 0]
    for key in ("total_loss", "policy_loss", "value_loss", "reward_loss", "chance_loss"):
        xs, ys = series(train_rows, key)
        if xs:
            ax.plot(xs, ys, label=key.replace("_loss", ""))
    ax.set_title("losses")
    ax.set_yscale("log")
    ax.legend(fontsize=7)

    ax = axes[0, 1]
    xs, ys = series(train_rows, "steps_per_s")
    ax.plot(xs, ys)
    ax.set_title("learner steps/s")

    ax = axes[0, 2]
    xs, ys = series(train_rows, "codebook_entropy")
    if xs:
        ax.plot(xs, ys)
    ax.set_title("codebook entropy (train batches)")

    ax = axes[1, 0]
    xs, ys = series(eval_rows, "eval/mean_reward")
    ax.plot(xs, ys, marker="o", ms=3)
    sx, sem = series(eval_rows, "eval/sem_reward")
    if sx and len(sx) == len(xs):
        lo = [y - 1.96 * s for y, s in zip(ys, sem)]
        hi = [y + 1.96 * s for y, s in zip(ys, sem)]
        ax.fill_between(xs, lo, hi, alpha=0.2, label="95% CI")
    xs2, ys2 = series(eval_rows, "eval/max_reward")
    if xs2:
        ax.plot(xs2, ys2, alpha=0.4, label="max")
    # Deep evaluations (n=128): the series champion selection runs on, drawn over the noisier inline curve.
    dx, dy = series(eval_rows, "deep_eval/mean_reward")
    if dx:
        _, dsem = series(eval_rows, "deep_eval/sem_reward")
        ax.errorbar(
            dx, dy, yerr=[1.96 * s for s in dsem], color="tab:red", marker="s",
            ms=4, lw=1.5, capsize=3, label="deep eval (n=128)",
        )  # fmt: skip
    ax.legend(fontsize=7)
    ax.set_title("eval reward (greedy)")

    ax = axes[1, 1]
    xs, ys = series(eval_rows, "eval/max_tile")
    ax.plot(xs, ys, marker="o", ms=3, label="max tile")
    xs, ys = series(eval_rows, "eval/mean_length")
    if xs:
        ax2 = ax.twinx()
        ax2.plot(xs, ys, color="tab:orange", alpha=0.6)
        ax2.set_ylabel("mean length", color="tab:orange")
    ax.set_title("eval max tile / episode length")

    ax = axes[1, 2]
    xs, ys = series(eval_rows, "eval/encoder_codes_used")
    if xs:
        ax.plot(xs, ys, marker="o", ms=3, label="codes used")
    xs, ys = series(eval_rows, "eval/mean_search_entropy")
    if xs:
        ax2 = ax.twinx()
        ax2.plot(xs, ys, color="tab:green", alpha=0.6)
        ax2.set_ylabel("search entropy", color="tab:green")
    ax.set_title("codes used / search entropy")
    ax.legend(fontsize=7)

    for ax in axes.flat:
        ax.grid(alpha=0.3)
        ax.set_xlabel("step")

    out = out or str(path.with_suffix(".png"))
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def main(argv: list[str] | None = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log", help="metrics.jsonl path")
    parser.add_argument("-o", "--out", default=None, help="output PNG (default: alongside log)")
    args = parser.parse_args(argv)
    out = render(Path(args.log), args.out)
    print(out)
    return out


if __name__ == "__main__":
    main()

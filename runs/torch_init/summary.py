"""The recipe runs on the GPU from the JAX package's initial weights, against
JAX's reference runs and the earlier runs of the port. From the repository
root (numpy and scipy; no JAX, no torch):

    python runs/torch_init/summary.py

Reads the scalar recipe's runs to 5,000 steps (``card/call_a/seed*``: the
port's ``--seed s``, whose init is JAX's of seed s), the earlier full-width
runs (``runs/torch_parity/card/full_width/``: JAX's converted inits, and the
port's torch-generator inits; ``runs/torch_scalar60k*``: the latter too),
the categorical twin (``card/call_b/cat_seed42``, ``runs/torch_cat60k``),
and JAX's runs (``runs/r4_scalar60k``, ``runs/r5_cat60k``). Prints one JSON
line a run: ``eval/mean_reward`` and its sem at 5,000 (and 10,000), the gap
to JAX's in combined sems and the line of 2.5 combined sems; then the ranks,
Mann–Whitney tests between the kinds of init, and the seed-42 run's step-0
row beside the run that restored JAX's converted init of seed 42.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy.stats import mannwhitneyu

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = os.path.dirname(HERE)
FULL = os.path.join(RUNS, "torch_parity", "card", "full_width")

# (label, kind of init, trainer seed, metrics file)
SCALAR = [
    ("call_a/seed42", "jax_own", 42, os.path.join(HERE, "card", "call_a", "seed42")),
    ("call_a/seed43", "jax_own", 43, os.path.join(HERE, "card", "call_a", "seed43")),
    ("call_a/seed45", "jax_own", 45, os.path.join(HERE, "card", "call_a", "seed45")),
    ("call_a/seed46", "jax_own", 46, os.path.join(HERE, "card", "call_a", "seed46")),
    ("jaxinit42_seed42", "jax_converted", 42, os.path.join(FULL, "jaxinit42_seed42")),
    ("jaxinit42_seed43", "jax_converted", 43, os.path.join(FULL, "jaxinit42_seed43")),
    ("jaxinit0_seed0", "jax_converted", 0, os.path.join(FULL, "jaxinit0_seed0")),
    ("jaxinit44_seed44", "jax_converted", 44, os.path.join(FULL, "jaxinit44_seed44")),
    ("torch_scalar60k", "torch_generator", 42, os.path.join(RUNS, "torch_scalar60k")),
    ("torch_scalar60k_seed43", "torch_generator", 43, os.path.join(RUNS, "torch_scalar60k_seed43")),
    ("owninit_seed44", "torch_generator", 44, os.path.join(FULL, "owninit_seed44")),
    ("owninit_seed45", "torch_generator", 45, os.path.join(FULL, "owninit_seed45")),
]
CATEGORICAL = [
    ("call_b/cat_seed42", "jax_own", 42, os.path.join(HERE, "card", "call_b", "cat_seed42")),
    ("torch_cat60k", "torch_generator", 42, os.path.join(RUNS, "torch_cat60k")),
    ("cat_seed43", "torch_generator", 43, os.path.join(FULL, "cat_seed43")),
]


def rows(path: str) -> list[dict]:
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def at(rs: list[dict], step: int, key: str):
    vals = [r[key] for r in rs if r["step"] == step and key in r]
    return vals[-1] if vals else None


def compare(label: str, kind: str, seed: int, path: str, jax_rows: list[dict], steps) -> dict | None:
    if not os.path.exists(os.path.join(path, "metrics.jsonl")):
        return None
    rs = rows(path)
    out = {"run": label, "init": kind, "trainer_seed": seed}
    for step in steps:
        mean, sem = at(rs, step, "eval/mean_reward"), at(rs, step, "eval/sem_reward")
        if mean is None:
            continue
        jmean, jsem = at(jax_rows, step, "eval/mean_reward"), at(jax_rows, step, "eval/sem_reward")
        combined = float(np.hypot(sem, jsem))
        out[str(step)] = {"mean": mean, "sem": round(sem, 2), "jax": jmean, "jax_sem": round(jsem, 2),
                          "sigma": round((mean - jmean) / combined, 2), "line": round(jmean - 2.5 * combined, 1),
                          "above_line": mean >= jmean - 2.5 * combined,
                          "policy_loss": at(rs, step, "policy_loss")}
    return out


def main() -> None:
    scalar_jax = rows(os.path.join(RUNS, "r4_scalar60k"))
    results = [r for r in (compare(*run, scalar_jax, (5000,)) for run in SCALAR) if r]
    for r in results:
        print(json.dumps(r))
    ranked = sorted((r for r in results if "5000" in r), key=lambda r: -r["5000"]["mean"])
    print(json.dumps({"rank_at_5000": [(r["run"], r["5000"]["mean"]) for r in ranked]}))
    by_kind = {}
    for r in ranked:
        by_kind.setdefault(r["init"], []).append(r["5000"]["mean"])
    gen = by_kind.get("torch_generator", [])
    for a, b in (("jax_own", "torch_generator"), ("jax_own", "jax_converted")):
        if by_kind.get(a) and by_kind.get(b):
            test = mannwhitneyu(by_kind[a], by_kind[b], alternative="two-sided", method="exact")
            print(json.dumps({"mann_whitney": f"{a} vs {b}", "n": [len(by_kind[a]), len(by_kind[b])],
                              "U": float(test.statistic), "p": round(float(test.pvalue), 4)}))
    jax_inits = by_kind.get("jax_own", []) + by_kind.get("jax_converted", [])
    if jax_inits and gen:
        test = mannwhitneyu(jax_inits, gen, alternative="two-sided", method="exact")
        print(json.dumps({"mann_whitney": "every JAX init (own and converted) vs torch_generator",
                          "n": [len(jax_inits), len(gen)], "U": float(test.statistic),
                          "p": round(float(test.pvalue), 4),
                          "means": [round(float(np.mean(jax_inits)), 1), round(float(np.mean(gen)), 1)]}))

    new42 = os.path.join(HERE, "card", "call_a", "seed42")
    if os.path.exists(os.path.join(new42, "metrics.jsonl")):
        first = [r for r in rows(new42) if r["step"] == 0 and "gen/completed_score" in r][0]
        old = [r for r in rows(os.path.join(FULL, "jaxinit42_seed42")) if r["step"] == 0
               and "gen/completed_score" in r][0]  # fmt: skip
        keys = [k for k in first if k.startswith("gen/") and k != "gen/seconds"]
        print(json.dumps({"step0_row": {k: [first[k], old[k]] for k in keys},
                          "equal": [k for k in keys if first[k] == old[k]]}))

    cat_jax = rows(os.path.join(RUNS, "r5_cat60k"))
    for run in CATEGORICAL:
        r = compare(*run, cat_jax, (5000, 10000))
        if r:
            print(json.dumps(r))


if __name__ == "__main__":
    main()

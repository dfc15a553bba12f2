"""Where a cell's traced unit spends its time, span by span, and what recording the spans costs.

    python3 perfbench/span_report.py --workload <name> --seeds <n> ... [--out <file.jsonl>]

For each seed, two runs of the cell as ``run.py --trace 1 --seconds 0`` makes
them (``run.run_cell``: set-up, one unit under ``torch.profiler``, the check),
in one process: one with the program's spans recording, one with them
suppressed (the tracer's "on" check patched to false), the order alternating
from seed to seed. Both runs of a seed play the same games with the same
draws. One JSON line a seed: both traced units' host seconds and checks, and
from the run with spans its per-span table (``harness/spans.py`` ``table``)
and the cell's per-layer metrics. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as run_mod  # noqa: E402
from perfbench.harness import spans, spec  # noqa: E402


def traced_run(cell, seed: int, device, spans_on: bool):
    """One ``run_cell`` with no window, spans recording or suppressed; returns its result line and its Run."""
    from simulate_2048_tpu_torch.utils import tracing

    kept = []

    class KeptRun(run_mod.Run):
        def __init__(self, *args):
            super().__init__(*args)
            kept.append(self)

    check, run_class = tracing.is_recording, run_mod.Run
    tracing.reset()
    run_mod.Run = KeptRun
    if not spans_on:
        tracing.is_recording = lambda: False
    try:
        result = run_mod.run_cell(cell, seed, 0.0, True, device, time.perf_counter())
    finally:
        tracing.is_recording, run_mod.Run = check, run_class
    return result, kept[0]


def pair(cell, seed: int, device, on_first: bool) -> dict:
    """The two runs of one seed, spans on and off, as one JSON-ready line."""
    import torch

    line: dict = {"workload": cell.name, "seed": seed, "order": "on,off" if on_first else "off,on"}
    for key in line["order"].split(","):
        result, run = traced_run(cell, seed, device, key == "on")
        line[key] = {"unit_s": run.units[0].seconds, "correct": result["correct"]}
        if key == "on":
            line["table"] = spans.table(run)
            line["metrics"] = {name: m["value"] for name, m in result["metrics"].items()}
        del result, run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    line["cost_share"] = line["on"]["unit_s"] / line["off"]["unit_s"] - 1
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("span_report needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        line = json.dumps(pair(cell, seed, torch.device("cuda", 0), i % 2 == 0))
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

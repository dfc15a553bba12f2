"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernel libraries, weights from the seed, the cell's state
and a warm-up of its shapes) is timed as ``setup_s``; then units of the
cell's traffic run until ``--seconds`` have passed (the last unit runs to
its end). With ``--trace 1`` one unit runs under ``torch.profiler``
before the window, and the cell's per-layer metrics are reported instead of
its end-to-end ones. After the window the run is checked against the reference
(``harness/check.py``). The last line of standard output is the result, in
JSON; the numbers compared, each with its limit, end standard error.

It needs a CUDA device (exit 2 without one, or with fewer than the cell
asks for), and fails if the program has loaded JAX, Flax or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "simulate_2048_tpu")


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: object  # harness.spec.Cell
    setup_s: float
    window_s: float
    units: list  # harness.players.Unit, in order
    trace: object | None  # harness.trace.DeviceTrace of the first unit, with --trace 1

    @property
    def player(self) -> str:
        return self.cell.traffic["player"]

    @property
    def moves(self) -> int:
        return sum(u.moves for u in self.units)

    def untraced(self) -> list:
        """The units the profiler did not run over (all of them when there were no others)."""
        return self.units[1:] if self.trace is not None and len(self.units) > 1 else self.units

    def median_span(self, name: str) -> float | None:
        times = [t1 - t0 for u in self.untraced() for n, t0, t1, _ in u.spans if n == name]
        return statistics.median(times) if times else None


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)  # fmt: skip
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object."""
    import torch

    from perfbench.harness import check, players, spec
    from perfbench.harness import trace as trace_lib
    from perfbench.harness.record import SearchRecorder

    for module in players.PROGRAM_MODULES:
        importlib.import_module(module)
    if device.type == "cuda":
        torch.cuda.init()
    imports_s = time.perf_counter() - t_start
    player = players.PLAYERS[cell.traffic["player"]](cell, seed, device)
    player.setup()
    setup_s = time.perf_counter() - t_start
    parts = {"imports_and_device_s": imports_s, "state_s": setup_s - imports_s - player.warmup_s,
             "warmup_s": player.warmup_s}  # fmt: skip

    recorder = SearchRecorder()
    traced = None
    with recorder:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            # Device activity only; a CPU run (the tests) traces the host, and its metrics read nothing.
            activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
            with profile(activities=[activity]) as prof:
                unit = player.unit(recorder)
            traced = trace_lib.DeviceTrace(
                trace_lib.device_events(prof),
                unit.seconds,
                [(n, ns0, ns0 + int((t1 - t) * 1e9)) for n, t, t1, ns0 in unit.spans],
            )
        # The window (with --trace 1 after the traced unit and the reading of its trace).
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            player.unit(recorder)
        window_s = time.perf_counter() - t0
    found = forbidden_modules()
    if found:
        print(f"the run has loaded {', '.join(found)}: the program must not import JAX", file=sys.stderr)
        raise SystemExit(3)
    on_card = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    t_check = time.perf_counter()
    numbers, compared = check.judge(player, recorder)
    compared["check_s"] = time.perf_counter() - t_check

    run = Run(cell, setup_s, window_s, player.units, traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": memory_peak,
        "power_limit": power_limit() if on_card else None,
    }
    result = {
        "correct": all(n.ok for n in numbers),
        "attempted": run.moves,
        "failed": 0,
        "metrics": metrics,
        "device": dev,
    }
    if traced is not None:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(10), "idle_gaps": traced.idle_gaps(10)}
    result["setup_parts"] = parts
    result["units"] = [[u.moves, u.calls[1] - u.calls[0], u.seconds] for u in run.units]
    result["compared"] = compared
    result["checks"] = {n.name: {"value": n.value, "limit": n.limit} for n in numbers}
    for n in numbers:
        print(f"check {n.name}: {n.value!r} (limit {n.limit!r}){'' if n.ok else '  FAILED'}", file=sys.stderr)
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)  # fmt: skip
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

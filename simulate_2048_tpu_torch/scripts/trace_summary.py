"""Summarize a ``torch.profiler`` Chrome trace: top device ops by total time.

``python -m simulate_2048_tpu_torch.scripts.trace_summary <dir-or-file> [--top N]``

Port of the repository's ``scripts/trace_summary.py``, with its arguments and
printed lines: the trace's process names, the total device-op time, then the
top N ops by total time with their counts. It reads the traces that the
port's ``utils.profiling.trace`` writes (``trace-<pid>-<ns>.json``, also
gzipped): in a directory it takes the newest ``trace-*.json*``. Device ops are
the complete (``"ph": "X"``) events that ran on the GPU, those of categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` (the JAX script takes the
events of the processes named "TPU").

  1. capture:   ``with utils.profiling.trace("profiles"): workload()``
                (or ``python -m simulate_2048_tpu_torch.scripts.trace_training``)
  2. summarize: ``python -m simulate_2048_tpu_torch.scripts.trace_summary profiles``
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import sys
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(trace_path: Path) -> list[dict]:
    opener = gzip.open if trace_path.suffix == ".gz" else open
    with opener(trace_path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def summarize(trace_path: Path, top: int = 30) -> None:
    events = load_events(trace_path)
    pid_names = {
        e["pid"]: e["args"]["name"]
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dur = collections.Counter()
    cnt = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and e.get("dur"):
            dur[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
            total += e["dur"]
    print(f"devices: {pid_names}")
    print(f"total device-op time: {total / 1e3:.1f} ms over {sum(cnt.values())} events")
    for name, d in dur.most_common(top):
        print(f"{d / 1e3:9.2f} ms  x{cnt[name]:<6} {name[:110]}")


def newest_trace(directory: Path) -> Path:
    """The most recently written ``trace-*.json`` / ``trace-*.json.gz`` under ``directory``."""
    candidates = [p for p in directory.glob("**/trace-*.json*") if p.name.endswith((".json", ".json.gz"))]
    if not candidates:
        sys.exit(f"no trace-*.json under {directory}")
    return max(candidates, key=lambda p: p.stat().st_mtime_ns)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("trace", help="trace dir (the newest trace-*.json* found inside) or the .json / .json.gz itself")
    parser.add_argument("--top", type=int, default=30)
    args = parser.parse_args(argv)

    path = Path(args.trace)
    if path.is_dir():
        path = newest_trace(path)
    summarize(path, args.top)


if __name__ == "__main__":
    main()

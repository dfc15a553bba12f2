"""What a run reads: ``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is a file of its own under ``perfbench/``, found by name:

- ``configs/<config>.json``: the configuration as it is run (every field of
  the program's ``TrainConfig``), its source, what it assumes and the
  precision of its search products;
- ``traffic/<traffic>.json``: the mix, read by the player it names
  (``harness/players.py``);
- ``cells/<workload>.json``: the cell's check (``harness/check.py``): how
  many moves it compares and the limit of each number;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric, end-to-end or per-layer.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file (TrainConfig fields and its notes)
    traffic: dict
    check: dict  # the cell file's "check"
    end_to_end: tuple[dict, ...]  # BENCHMARK.json entries this cell reports
    per_layer: tuple[dict, ...]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = read_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        chips=entry["chips"],
        config=read_json(root / configs[entry["config"]]["file"]),
        traffic=read_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json"),
        check=read_json(root / "perfbench" / "cells" / f"{name}.json")["check"],
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

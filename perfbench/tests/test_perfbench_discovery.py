"""A new cell, configuration, traffic mix or metric is found by name: added
files and a BENCHMARK.json entry, no other file touched."""

import json
import shutil

from perfbench.harness import spec


def test_new_cell_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    ignore = shutil.ignore_patterns("__pycache__", "tests")
    shutil.copytree(spec.ROOT / "perfbench", root / "perfbench", ignore=ignore)
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}

    # Added: a configuration, a traffic mix, a cell and a per-layer metric, each a file of its own.
    config = json.loads((root / "perfbench/configs/appendix_c.json").read_text())
    config.update(num_parallel_games=64, hidden_size=128, num_residual_blocks=5, num_simulations=50)
    (root / "perfbench/configs/cat60k.json").write_text(json.dumps(config))
    traffic = {"player": "selfplay", "training_step": 0}
    (root / "perfbench/traffic/selfplay_short.json").write_text(json.dumps(traffic))
    check = {"check": {"sample_calls": 2, "limits": {"env_mismatches": 0}}}
    (root / "perfbench/cells/cat60k.selfplay_short.json").write_text(json.dumps(check))
    (root / "perfbench/metrics/segments.count.py").write_text("def read(run):\n    return float(len(run.units))\n")
    cell = "cat60k.selfplay_short"
    bench["configs"].append(
        {"name": "cat60k", "source": "x", "file": "perfbench/configs/cat60k.json", "reduced": [], "why": "x"}
    )
    bench["workloads"].append({"name": cell, "config": "cat60k", "traffic": "selfplay_short", "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "selfplay_moves_per_s")["workloads"].append(cell)
    bench["per_layer"].append(
        {"name": "segments.count", "unit": "segments", "better": "higher", "source": "program_counter",
         "layer": "self-play loop", "moves": "selfplay_moves_per_s", "workloads": [cell]}
    )
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(cell, root)
    assert cell.config["hidden_size"] == 128 and cell.traffic["player"] == "selfplay"
    assert cell.check["sample_calls"] == 2
    assert [m["name"] for m in cell.per_layer] == ["segments.count"]
    assert {m["name"] for m in cell.end_to_end} == {"selfplay_moves_per_s", "setup_s"}

    class FakeRun:
        units = [1, 2, 3]

    assert spec.reader("segments.count", root)(FakeRun()) == 3.0
    # No file the benchmark had was touched.
    after = {p.relative_to(root): p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[p] == data for p, data in before.items())


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert set(cell.check["limits"]) >= {"env_mismatches", "search_visits_differ", "search_value_gap"}

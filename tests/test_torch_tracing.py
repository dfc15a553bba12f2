"""The port's tracer (``utils/tracing.py``), the spans and counters of its
loops, their Chrome-trace export, and the benchmark's readers of them
(``perfbench/metrics``), on the CPU at a tiny size.

Spans record only while ``torch.profiler`` records; on the CPU they have no
stream time, so the benchmark's ``ms`` readers read nothing here.
"""

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import run as run_mod
from perfbench.harness import players, spans, spec
from perfbench.tests.conftest import tiny_cell
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import search_kernel
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.training import replay
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training.config import tiny_config
from simulate_2048_tpu_torch.training.trainer import ingest_segment
from simulate_2048_tpu_torch.utils import profiling, tracing

torch.set_num_threads(1)

NEW_METRICS = {
    "selfplay.finished_lane_share": ("appendix_c.selfplay", "capacity_probe.selfplay"),
    "selfplay.env_ms_per_move": ("appendix_c.selfplay", "capacity_probe.selfplay"),
    "selfplay.root_ms_per_move": ("appendix_c.selfplay", "capacity_probe.selfplay"),
    "eval.stats_ms_per_move": ("capacity_probe.deep_eval",),
    "eval.sync_idle_ms_per_move": ("capacity_probe.deep_eval",),
}
SELFPLAY_MOVE = ["move.observe", "move.noise", "search.root", "search.kernel", "move.act", "env.step", "move.record"]
EVAL_MOVE = ["eval.done_read", "move.observe", "search.root", "search.kernel", "eval.stats", "env.step"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class CountedSearch:
    """``with CountedSearch() as c:`` counts the calls into ``run_search_kernel``."""

    def __enter__(self):
        self.inner, self.calls = search_kernel.run_search_kernel, 0

        def counted(*args, **kwargs):
            self.calls += 1
            return self.inner(*args, **kwargs)

        search_kernel.run_search_kernel = counted
        return self

    def __exit__(self, *exc):
        search_kernel.run_search_kernel = self.inner


def tiny_game_config(**overrides):
    base = dict(hidden_size=16, num_residual_blocks=1, num_simulations=3, search_max_depth=4, num_parallel_games=8,
                search_backend="pallas", use_bfloat16=False)  # fmt: skip
    return dataclasses.replace(tiny_config(), **{**base, **overrides})


def names(snap, unit=None):
    return [s["name"] for s in snap["spans"] if unit is None or s["unit"] == unit]


# ---- the tracer


def test_spans_record_only_while_the_profiler_records():
    tracing.reset()
    with tracing.span("outside"):
        pass
    assert tracing.span("a") is tracing.span("b")  # off: one shared no-op context, nothing allocated
    assert tracing.snapshot()["spans"] == []
    with cpu_profile():
        with tracing.span("inside"):
            pass
    with tracing.span("after"):
        pass
    snap = tracing.snapshot()
    assert names(snap) == ["inside"]
    assert snap["spans"][0]["stream_ns"] is None  # no CUDA here


def test_parents_units_and_self_times_of_nested_spans():
    tracing.reset()
    with cpu_profile():
        with tracing.span("segment", unit=True):
            with tracing.span("move"):
                with tracing.span("inner"):
                    time.sleep(0.004)
                time.sleep(0.002)
            with tracing.span("move"):
                time.sleep(0.003)
        with tracing.span("ingest"):
            time.sleep(0.001)
        with tracing.span("segment", unit=True):
            pass
    got = tracing.snapshot()["spans"]
    assert [(s["name"], s["parent"], s["unit"]) for s in got] == [
        ("segment", None, 1), ("move", 0, 1), ("inner", 1, 1), ("move", 0, 1), ("ingest", None, 1),
        ("segment", None, 2),
    ]  # fmt: skip
    host = [s["end_ns"] - s["start_ns"] for s in got]
    selfs = tracing.self_times(got)
    assert selfs[0] == host[0] - host[1] - host[3]
    assert selfs[1] == host[1] - host[2] and selfs[2] == host[2] and selfs[4] == host[4]
    assert selfs[1] >= 2_000_000 and selfs[2] >= 4_000_000
    assert all(s["start_ns"] <= s["end_ns"] for s in got)
    assert tracing.self_times(got, "stream") == [None] * len(got)


def test_counts_by_unit_with_device_scalars_and_a_bounded_history():
    tracing.reset()
    tracing.span("segment", unit=True)
    tracing.count("lanes", 5)
    tracing.count("lanes", torch.tensor(7, dtype=torch.int32))
    tracing.span("segment", unit=True)
    tracing.count("lanes", 1)
    assert tracing.snapshot()["counts"] == {1: {"lanes": 12}, 2: {"lanes": 1}}
    for _ in range(tracing.KEEP_UNITS + 3):
        tracing.span("segment", unit=True)
        tracing.count("lanes", 1)
    counts = tracing.snapshot()["counts"]
    assert len(counts) == tracing.KEEP_UNITS and 1 not in counts and all(c == {"lanes": 1} for c in counts.values())


def test_the_exported_chrome_trace_holds_the_spans_on_their_own_track(tmp_path):
    tracing.reset()
    with tracing.span("before"):
        pass
    with profiling.trace(str(tmp_path)):
        with tracing.span("segment", unit=True):
            with tracing.span("env.step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.iterdir()
    data = json.loads(path.read_text())
    base = data.get("baseTimeNanoseconds", 0)
    track = [e for e in data["traceEvents"] if e.get("tid") == profiling.SPAN_TRACK]
    assert track[0]["ph"] == "M" and track[0]["args"]["name"] == "program spans"
    got = [(e["name"], e["args"]["parent"], e["cat"]) for e in track[1:]]
    assert got == [("segment", None, "program_span"), ("env.step", "segment", "program_span")]
    # The same clock as the profiler's own events: the product runs inside the env.step span.
    step = track[2]
    matmul = next(e for e in data["traceEvents"] if e.get("name") == "aten::matmul")
    assert step["ts"] <= matmul["ts"] and matmul["ts"] + matmul["dur"] <= step["ts"] + step["dur"]
    assert abs(step["ts"] * 1e3 + base - tracing.snapshot()["spans"][-1]["start_ns"]) < 1e3


# ---- the program's spans and counters


def test_self_play_segment_spans_and_its_finished_lane_share():
    config = tiny_game_config(max_trajectory_length=200, value_target_mode="td_lambda")
    network = network_from_config(config, prng_key(3))
    generator = torch.Generator().manual_seed(5)
    state = envlib.reset_batch(11, 8, torch.device("cpu"))
    buffer = replay.init_buffer(config, torch.device("cpu"))
    tracing.reset()
    with CountedSearch() as searched, cpu_profile():
        state, traj, stats = tsp.generate_games(network, generator, config, 0, env_state=state)
        ingest_segment(buffer, None, traj, stats.first_search_value, config)
    snap = tracing.snapshot()
    (unit,) = snap["counts"]
    counts = snap["counts"][unit]
    assert searched.calls == 200
    assert counts["selfplay.lanes_searched"] == 8 * searched.calls
    assert counts["selfplay.lanes_active"] == int(traj.length.sum())
    share = 1 - counts["selfplay.lanes_active"] / counts["selfplay.lanes_searched"]
    assert share == 1 - int(traj.length.sum()) / (8 * searched.calls) and share > 0  # games ended inside
    got = names(snap, unit)
    assert got[0] == "segment" and got[1:1 + 7 * 200] == SELFPLAY_MOVE * 200
    assert got[1 + 7 * 200:] == ["segment.finish", "segment.returns", "replay.ingest", "replay.add"]
    parent = {s["name"]: snap["spans"][s["parent"]]["name"] if s["parent"] is not None else None
              for s in snap["spans"]}  # fmt: skip
    assert parent["search.kernel"] == parent["move.act"] == parent["segment.finish"] == "segment"
    assert parent["replay.add"] == "replay.ingest" and parent["segment"] is None


def test_every_counter_the_program_records_is_read_by_a_metric():
    config = tiny_game_config(max_trajectory_length=6, eval_max_moves=40)
    network = network_from_config(config, prng_key(3))
    state = envlib.reset_batch(2, 8, torch.device("cpu"))
    tracing.reset()
    with cpu_profile():
        _, traj, stats = tsp.generate_games(network, torch.Generator().manual_seed(1), config, 0, env_state=state)
        ingest_segment(replay.init_buffer(config, torch.device("cpu")), None, traj, stats.first_search_value, config)
        tsp.finish_gen_stats(stats, traj)
        tsp.evaluate_games(network, torch.Generator().manual_seed(9), config, 8, include_per_game=True)
    recorded = {name for named in tracing.snapshot()["counts"].values() for name in named}
    readers = "\n".join(path.read_text() for path in (spec.ROOT / "perfbench" / "metrics").glob("*.py"))
    assert recorded == {"selfplay.lanes_searched", "selfplay.lanes_active"}
    assert all(f'"{name}"' in readers for name in recorded)


def test_the_evaluation_spans_one_read_of_done_a_move():
    config = tiny_game_config(eval_max_moves=300)
    network = network_from_config(config, prng_key(4))
    tracing.reset()
    with CountedSearch() as searched, cpu_profile():
        stats = tsp.evaluate_games(network, torch.Generator().manual_seed(9), config, 8, include_per_game=True)
    snap = tracing.snapshot()
    assert max(stats["per_game_lengths"]) == searched.calls < 300  # every game ended
    (unit,) = {s["unit"] for s in snap["spans"]}
    # A read before each move, and the read that finds every game over.
    assert names(snap, unit) == ["eval.rollout"] + EVAL_MOVE * searched.calls + ["eval.done_read", "eval.summary"]
    parent = {s["name"]: snap["spans"][s["parent"]]["name"] if s["parent"] is not None else None
              for s in snap["spans"]}  # fmt: skip
    assert parent["eval.done_read"] == parent["search.root"] == "eval.rollout" and parent["eval.summary"] is None
    assert snap["counts"] == {unit: {}}  # the evaluation counts nothing


# ---- the benchmark's readers


def test_the_five_readers_are_found_and_declared_for_their_cells():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name, cells in NEW_METRICS.items():
        assert callable(spec.reader(name))
        assert tuple(declared[name]["workloads"]) == cells
        assert declared[name]["source"] == ("program_counter" if name.endswith("share") else "program_span")
        for cell in cells:
            assert name in [m["name"] for m in spec.load_cell(cell).per_layer]


def test_the_readers_read_nothing_without_the_programs_tracer():
    class Run:
        _program_snapshot = None  # what a program without utils/tracing.py gives
        trace = None
        units = []

    for name, cells in NEW_METRICS.items():
        for player in ("selfplay", "deep_eval"):
            Run.player = player
            assert spec.reader(name)(Run()) is None


# A traced run of a tiny cell as ``perfbench/run.py --trace 1`` makes it, in a process of its own: this one has
# loaded JAX, which a run refuses.
TRACED_RUN = """
import json, sys, torch
torch.set_num_threads(1)
from perfbench.tests.conftest import run_tiny, tiny_cell
print(json.dumps(run_tiny(tiny_cell(sys.argv[1], eval_max_moves=12), trace=True)))
"""


@pytest.mark.parametrize("cell", ["appendix_c.selfplay", "capacity_probe.deep_eval"])
def test_traced_cpu_runs_report_the_counter_and_no_stream_times(cell):
    out = subprocess.run([sys.executable, "-c", TRACED_RUN, cell], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)  # fmt: skip
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    metrics = result["metrics"]
    assert result["correct"]
    if cell.endswith("selfplay"):
        moves, calls, _ = result["units"][0]
        assert metrics["selfplay.finished_lane_share"] == {"value": 100.0 * (1 - moves / (8 * calls)), "unit": "%"}
        assert not {"selfplay.env_ms_per_move", "selfplay.root_ms_per_move"} & set(metrics)
    else:
        assert not set(NEW_METRICS) & set(metrics)


# ---- the idle attribution


def test_idle_goes_to_the_innermost_open_span_and_sums_to_the_window():
    recorded = [
        {"name": "segment", "parent": None, "start_ns": 100, "end_ns": 900},
        {"name": "move.observe", "parent": 0, "start_ns": 150, "end_ns": 300},
        {"name": "search.kernel", "parent": 0, "start_ns": 300, "end_ns": 320},
        {"name": "env.step", "parent": 0, "start_ns": 600, "end_ns": 700},
    ]
    events = [("k", 0, 120), ("k", 200, 250), ("k", 320, 650), ("k", 640, 660), ("k", 880, 1000)]
    idle = spans.idle_by_span(recorded, events, (0, 1000))
    # Idle: 120-200 (segment to 150, then move.observe), 250-320 (observe to 300, kernel span to 320),
    # 660-880 (env.step to 700, segment to 880).
    assert idle == {0: 30 + 180, 1: 50 + 50, 2: 20, 3: 40}
    assert sum(idle.values()) == 1000 - trace_union(events, 1000)
    assert spans.idle_by_span(recorded, events, (0, 1100))[None] == 100  # after every span
    busy = [(0, 120), (200, 250), (320, 660), (880, 1000)]
    assert spans.idle_after(busy, [120, 130, 250, 300, 700, 990, 1000]) == [80, 70, 70, 20, 180, 0, 0]


def trace_union(events, end):
    from perfbench.harness import trace

    return trace.union_ns([(s, min(e, end)) for _, s, e in events])


@pytest.mark.parametrize("cell", ["appendix_c.selfplay", "capacity_probe.deep_eval"])
def test_a_traced_tiny_unit_keeps_its_spans_inside_the_benchmarks_window(cell):
    from perfbench.harness import trace as trace_lib
    from perfbench.harness.record import SearchRecorder

    tiny = tiny_cell(cell, eval_max_moves=8, max_trajectory_length=6)
    player = players.PLAYERS[tiny.traffic["player"]](tiny, 2**33 + 7, torch.device("cpu"))
    player.setup()
    with SearchRecorder() as recorder, cpu_profile():
        unit = player.unit(recorder)
    harness = [(n, ns0, ns0 + int((t1 - t) * 1e9)) for n, t, t1, ns0 in unit.spans]
    run = run_mod.Run(tiny, 0.0, 0.0, [unit], trace_lib.DeviceTrace([], unit.seconds, harness))
    got = spans.traced_spans(run)
    assert sum(s["name"] == "search.kernel" for s in got) == unit.calls[1] - unit.calls[0]
    assert len({s["unit"] for s in got}) == 1
    win = spans.window(run)
    idle = spans.idle_by_span(got, [], win)
    assert sum(idle.values()) == win[1] - win[0]
    assert idle.get(None, 0) < 0.05 * (win[1] - win[0])  # the program's spans cover the unit

    # The per-span table, with a search kernel 1 µs after each search.kernel span ends and a copy 2 µs after
    # each read of done.
    kernel = "whole_search_mma_kernel" if cell.startswith("capacity") else "whole_search_kernel"
    events = [(kernel, s["end_ns"] + 1000, s["end_ns"] + 1500) for s in got if s["name"] == "search.kernel"]
    events += [("Memcpy DtoH", s["end_ns"] + 2000, s["end_ns"] + 2100) for s in got if s["name"] == "eval.done_read"]
    run.trace = trace_lib.DeviceTrace(sorted(events, key=lambda e: e[1]), unit.seconds, harness)
    table = spans.table(run)
    calls = unit.calls[1] - unit.calls[0]
    assert table["moves"] == calls and table["search_kernels"] == table["search_kernel_spans"] == calls
    assert table["kernel_lead_nonnegative_share"] == 1.0 and table["span_names_in_device_ops"] == []
    assert abs(table["idle_total_ms"] - table["trace_idle_ms"]) < 0.01  # two clocks read at the unit's ends
    assert sum(row["kernels"] for row in table["spans"].values()) == 1.0  # a move's one search kernel
    assert set(table["spans"]) >= {"move.observe", "search.root", "search.kernel", "env.step"}
    if cell.endswith("deep_eval"):
        assert table["done_read_next_activity_after_end_share"] == 1.0
        assert table["done_read_next_activity_ms"][0] > 0


# Both runs of a seed as ``perfbench/span_report.py`` makes them, on a tiny cell in a process of its own.
SPAN_REPORT = """
import json, torch
torch.set_num_threads(1)
from perfbench import span_report
from perfbench.tests.conftest import SEED, tiny_cell
print(json.dumps(span_report.pair(tiny_cell("appendix_c.selfplay"), SEED, torch.device("cpu"), False)))
"""


def test_span_report_pairs_a_unit_with_spans_on_and_off():
    out = subprocess.run([sys.executable, "-c", SPAN_REPORT], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)  # fmt: skip
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["order"] == "off,on" and line["on"]["correct"] and line["off"]["correct"]
    assert line["cost_share"] == line["on"]["unit_s"] / line["off"]["unit_s"] - 1
    assert line["table"] is None  # no device events on the CPU
    assert "selfplay.finished_lane_share" in line["metrics"]

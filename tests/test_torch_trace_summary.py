"""The port's ``trace_summary`` (``simulate_2048_tpu_torch/scripts/``) against
the repository's ``scripts/trace_summary.py``: one set of device events
written as a JAX perfetto trace (a process named "TPU") and as a
``torch.profiler`` Chrome trace (``kernel``, ``gpu_memcpy``, ``gpu_memset``
events) gives the same total and op lines; the newest trace of a directory
is the one read; a CPU trace of ``utils.profiling.trace`` has no device
events; ``trace_training`` traces a window of a trained run on the CPU.
"""

import gzip
import importlib.util
import json
import os
from pathlib import Path

import torch

from simulate_2048_tpu_torch.scripts import trace_summary, trace_training
from simulate_2048_tpu_torch.utils.profiling import trace

REPO = Path(__file__).resolve().parents[1]

# (name, duration in µs) of the device ops, in the order they ran; host ops are mixed in below.
DEVICE_OPS = [("whole_search_kernel", 5012.5), ("gemm", 31.25), ("whole_search_kernel", 4987.0), ("add", 2.5),
              ("Memcpy HtoD", 7.0), ("gemm", 29.75), ("Memset", 1.5), ("add", 2.25), ("softmax", 4.0)]  # fmt: skip
HOST_OPS = [("aten::mm", 40.0), ("cudaLaunchKernel", 6.0), ("whole_search_kernel", 900.0)]


def jax_summary_module():
    spec = importlib.util.spec_from_file_location("jax_trace_summary", REPO / "scripts" / "trace_summary.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_trace(path: Path) -> Path:
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/host:CPU"}},
    ]
    events += [{"ph": "X", "pid": 1, "tid": 1, "name": n, "ts": i, "dur": d} for i, (n, d) in enumerate(DEVICE_OPS)]
    events += [{"ph": "X", "pid": 2, "tid": 1, "name": n, "ts": i, "dur": d} for i, (n, d) in enumerate(HOST_OPS)]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def torch_trace(path: Path) -> Path:
    category = {"Memcpy HtoD": "gpu_memcpy", "Memset": "gpu_memset"}
    events = [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "python 7"}},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    events += [{"ph": "X", "cat": category.get(n, "kernel"), "pid": 0, "tid": 7, "name": n, "ts": i, "dur": d}
               for i, (n, d) in enumerate(DEVICE_OPS)]  # fmt: skip
    events += [{"ph": "X", "cat": "cpu_op" if n.startswith("aten") else "cuda_runtime", "pid": 7, "tid": 7,
                "name": n, "ts": i, "dur": d} for i, (n, d) in enumerate(HOST_OPS)]  # fmt: skip
    events.append({"ph": "f", "cat": "ac2g", "pid": 0, "tid": 7, "name": "flow", "ts": 0})
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def printed(fn, capsys) -> list[str]:
    fn()
    return capsys.readouterr().out.splitlines()


def test_port_summary_prints_jax_summary_lines(tmp_path, capsys):
    jax_lines = printed(lambda: jax_summary_module().summarize(jax_trace(tmp_path / "a.trace.json.gz"), 4), capsys)
    for name in ("trace-1-1.json", "trace-1-2.json.gz"):
        lines = printed(lambda: trace_summary.summarize(torch_trace(tmp_path / name), 4), capsys)
        assert lines[1:] == jax_lines[1:]
        assert lines[0] == "devices: {7: 'python 7', 0: 'GPU 0'}"
    assert jax_lines[1] == f"total device-op time: {sum(d for _, d in DEVICE_OPS) / 1e3:.1f} ms over 9 events"
    assert jax_lines[2].split() == ["10.00", "ms", "x2", "whole_search_kernel"]
    assert len(jax_lines) == 2 + 4


def test_directory_reads_the_newest_trace(tmp_path, capsys):
    (tmp_path / "sub").mkdir()
    old = torch_trace(tmp_path / "sub" / "trace-9-9.json")
    new = tmp_path / "trace-1-1.json"
    new.write_text(json.dumps({"traceEvents": [{"ph": "X", "cat": "kernel", "pid": 0, "name": "k", "dur": 3.0}]}))
    (tmp_path / "unrelated.json").write_text("not a trace")
    os.utime(old, ns=(1, 1))
    os.utime(new, ns=(2 * 10**9, 2 * 10**9))
    assert trace_summary.newest_trace(tmp_path) == new
    lines = printed(lambda: trace_summary.main([str(tmp_path), "--top", "3"]), capsys)
    assert lines[1:] == ["total device-op time: 0.0 ms over 1 events", "     0.00 ms  x1      k"]
    os.utime(old, ns=(3 * 10**9, 3 * 10**9))
    assert trace_summary.newest_trace(tmp_path) == old


def test_cpu_trace_has_no_device_events(tmp_path, capsys):
    with trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    lines = printed(lambda: trace_summary.main([str(tmp_path)]), capsys)
    assert lines[1] == "total device-op time: 0.0 ms over 0 events"
    assert len(lines) == 2


def test_trace_training_on_the_cpu(tmp_path, capsys):
    """A tiny trained checkpoint, then ``trace_training`` on it: the window's
    trace is written and summarised (no device events on the CPU)."""
    from simulate_2048_tpu_torch import train

    train.main(["--mode", "tiny", "--steps", "2", "--device", "cpu", "--no-eval", "--checkpoint-dir",
                str(tmp_path / "ckpt")])  # fmt: skip
    capsys.readouterr()
    trace_training.main(["--checkpoint-dir", str(tmp_path / "ckpt"), "--moves", "2", "--steps", "1", "--log-dir",
                         str(tmp_path / "traces"), "--device", "cpu"])  # fmt: skip
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == f"restored step 2 from {tmp_path / 'ckpt'}"
    (path,) = (tmp_path / "traces").glob("trace-*.json")
    assert lines[-3] == f"traced 2 self-play moves of 2 games and 1 learner steps: {path}"
    assert lines[-1] == "total device-op time: 0.0 ms over 0 events"

"""The host tools of ``simulate_2048_tpu_torch/scripts/`` against the repository's
JAX scripts, on the CPU: ``multihost_demo`` as two gloo processes against
JAX's data-parallel step on the same global batch and weights (losses within
rtol 1e-5), ``measure_overlap`` at 3 steps (the JAX script's keys, positive
rates), ``warm_compile``'s arms, ``bench_engine_ops``' boards and results and
``plot_metrics``' reading and drawing of a log. Run as a script, this file is
one ``multihost_demo`` worker.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DEMO_STEPS = 3


def worker(rank: int, port: int, weights: str) -> None:
    import torch

    from simulate_2048_tpu_torch.models.network import architecture_from_config
    from simulate_2048_tpu_torch.scripts import multihost_demo

    torch.set_num_threads(1)
    network = architecture_from_config(multihost_demo.demo_config(2))
    network.load_state_dict(torch.load(weights, weights_only=True))
    losses = multihost_demo.run(f"localhost:{port}", 2, rank, DEMO_STEPS, "cpu", network=network)
    print("losses " + " ".join(x.hex() for x in losses), flush=True)


def jax_script(name: str) -> types.ModuleType:
    """The repository's ``scripts/<name>.py``, imported as a module."""
    if f"jax_script_{name}" not in sys.modules:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[f"jax_script_{name}"] = module
    return sys.modules[f"jax_script_{name}"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_multihost_demo_two_gloo_processes_match_jax_dp_step(tmp_path):
    import jax
    import numpy as np
    import torch

    from simulate_2048_tpu import parallel as jparallel
    from simulate_2048_tpu.training import config as jconfig
    from simulate_2048_tpu.training import learner as jlearner
    from simulate_2048_tpu.training.losses import TrainingTargets
    from simulate_2048_tpu_torch.convert import params_from_flax
    from simulate_2048_tpu_torch.scripts import multihost_demo

    # The JAX demo's config and weights (PRNGKey(0)), converted for both workers.
    jcfg = dataclasses.replace(jconfig.tiny_config(), hidden_size=32, num_residual_blocks=1, batch_size=16)
    tcfg = multihost_demo.demo_config(2)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jstate, jnet = jlearner.create_train_state(jax.random.PRNGKey(0), jcfg)
    weights = tmp_path / "weights.pt"
    torch.save(params_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg).state_dict(), weights)

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
    port = free_port()
    procs = [
        subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--port", str(port), "--weights", str(weights)],
                         env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]  # fmt: skip

    # JAX's data-parallel step on the global batch: both processes' shards, in rank order.
    shards = []
    for pid in range(2):
        rs = np.random.RandomState(100 + pid)
        k = jcfg.num_unroll_steps
        shards.append(TrainingTargets(
            observations=rs.rand(8, k + 1, 16).astype(np.float32),
            actions=rs.randint(0, 4, (8, k)),
            target_policies=np.full((8, k + 1, 4), 0.25, np.float32),
            target_values=rs.rand(8, k + 1).astype(np.float32),
            target_rewards=rs.rand(8, k).astype(np.float32),
        ))  # fmt: skip
    batch = TrainingTargets(*(np.concatenate(parts) for parts in zip(*shards)))
    mesh = jparallel.make_mesh(jax.devices()[:2])
    optimizer = jlearner.create_optimizer(jcfg)
    want = []
    with mesh:
        step = jparallel.make_dp_train_step(jnet.apply_fns, jcfg, optimizer, mesh)
        for _ in range(DEMO_STEPS):
            jstate, loss, _ = step(jstate, jparallel.shard_pytree_batch(batch, mesh),
                                   jparallel.shard_pytree_batch(np.ones(16, np.float32), mesh))  # fmt: skip
            want.append(float(loss.total_loss))

    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
        outputs.append(out)
    losses = []
    for rank, out in enumerate(outputs):
        assert f"process {rank}/2: 1 local / 2 global devices" in out, out
        for i in range(DEMO_STEPS):
            assert re.search(rf"process {rank} step {i}: loss [\d.]+\n", out), out
        losses.append([float.fromhex(x) for x in re.search(r"losses (.*)", out).group(1).split()])
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)


def jax_result_keys(name: str) -> list[str]:
    """The keys of the ``result = {...}`` dict in the JAX script ``scripts/<name>.py``."""
    source = (REPO / "scripts" / f"{name}.py").read_text()
    block = source[source.index("result = {") : source.index("}", source.index("result = {"))]
    return re.findall(r'^\s+"(\w+)":', block, re.M)


@pytest.mark.timeout(300)
def test_measure_overlap_on_the_cpu(capsys):
    from simulate_2048_tpu_torch.scripts import measure_overlap

    result = measure_overlap.main([
        "--steps", "3", "--device", "cpu",
        *("--set hidden_size=32 --set num_residual_blocks=1 --set num_simulations=4 --set max_trajectory_length=8 "
          "--set min_buffer_size=4 --set batch_size=8 --set generation_interval=2").split(),
    ])  # fmt: skip
    assert json.loads(capsys.readouterr().out) == result
    assert list(result) == jax_result_keys("measure_overlap")
    assert result["platform"] == "cpu-shared-cores" and result["mode"] == "tiny" and result["steps"] == 3
    for key in ("serial_steps_per_s", "solo_steps_per_s", "overlapped_steps_per_s", "overlap_efficiency_vs_solo",
                "speedup_vs_serial"):  # fmt: skip
        assert result[key] > 0, key
    assert result["trajectory_batches_streamed"] > 0


def test_warm_compile_arms_equal_jax(monkeypatch, capsys):
    from simulate_2048_tpu_torch.scripts import warm_compile

    jax_arms = jax_script("warm_compile").ARMS
    presets = {"small": "small_config", "full": "default_config"}
    assert list(warm_compile.ARMS) == list(jax_arms)
    for name, (preset, overrides) in warm_compile.ARMS.items():
        assert presets[preset] == jax_arms[name][0].__name__ and overrides == jax_arms[name][1], name
    # An arm outside the kernel's limits launches nothing; one inside runs the kernel's plain version here.
    micro = ["hidden_size=32", "num_residual_blocks=1", "num_simulations=4", "num_parallel_games=4"]
    monkeypatch.setitem(warm_compile.ARMS, "micro", ("small", micro))
    lines = warm_compile.main(["gumbel", "micro", "--device", "cpu"])
    assert [(line["arm"], line["route"], line["launches"]) for line in lines] == [
        ("gumbel", "plain", {}), ("micro", "whole_search's plain version", {})
    ]
    out = capsys.readouterr().out
    assert "[gumbel] plain:" in out and "[micro] whole_search's plain version:" in out


def test_bench_engine_ops_matches_the_jax_engine():
    import numpy as np

    from simulate_2048_tpu.engine.board import slide_and_merge as jax_slide_and_merge
    from simulate_2048_tpu.engine.moves import illegal_actions as jax_illegal_actions
    from simulate_2048_tpu.engine.moves import legal_actions_mask as jax_legal_actions_mask
    from simulate_2048_tpu_torch.engine.board import slide_and_merge
    from simulate_2048_tpu_torch.engine.moves import illegal_actions, legal_actions_mask
    from simulate_2048_tpu_torch.scripts import bench_engine_ops

    script = jax_script("bench_engine_ops")
    rs_port, rs_jax = np.random.RandomState(0), np.random.RandomState(0)
    for size in (4, 6, 8):
        board = bench_engine_ops.random_board(size, rs_port)
        np.testing.assert_array_equal(board, script.random_board(size, rs_jax))
        got, want = slide_and_merge(board), jax_slide_and_merge(board)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert illegal_actions(board) == jax_illegal_actions(board)
        assert legal_actions_mask(board) == jax_legal_actions_mask(board)
    results = bench_engine_ops.bench(number=5)
    assert [r["board_size"] for r in results] == [4, 6, 8]
    assert all(list(r) == ["board_size", "slide_and_merge_us", "illegal_actions_us", "legal_actions_mask_us"]
               and all(v > 0 for v in r.values()) for r in results)  # fmt: skip


def test_plot_metrics_reads_and_draws_the_ports_log(tmp_path, capsys):
    from simulate_2048_tpu_torch.scripts import plot_metrics

    log = REPO / "runs" / "torch_cat60k" / "metrics.jsonl"
    train_rows, eval_rows = plot_metrics.load(log)
    assert (train_rows, eval_rows) == jax_script("plot_metrics").load(log)
    assert train_rows and eval_rows
    out = tmp_path / "run.png"
    assert plot_metrics.main([str(log), "-o", str(out)]) == str(out)
    assert capsys.readouterr().out.strip() == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--weights", required=True)
    args = parser.parse_args()
    worker(args.rank, args.port, args.weights)

"""End-to-end greedy evaluation: the PyTorch port vs the JAX package.

Same weights (Flax → ``convert.params_from_flax``), same config, same run
seed. Final boards, step counts, total rewards and encoder codes used must
agree exactly; the streamed entropy and search-value sums within rtol 1e-4.
Also: the port's config is the JAX package's field for field, the port
imports no JAX, and the GPU entry points raise instead of falling back to
the CPU when no GPU is present.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training.learner import network_from_config as jax_network_from_config
from simulate_2048_tpu.training.self_play import _evaluate_rollout as jax_evaluate_rollout
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training.self_play import _evaluate_rollout

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("preset", ["tiny_config", "small_config", "default_config", "TrainConfig"])
def test_config_matches_jax_field_for_field(preset):
    j, t = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    items = ["use_bfloat16=false", "pw_c=None", "temperature_schedule=[[0, 1.0]]", "num_simulations=7.0"]
    assert dataclasses.asdict(tconfig.apply_overrides(t, items)) == dataclasses.asdict(jconfig.apply_overrides(j, items))
    with pytest.raises(ValueError):
        tconfig.apply_overrides(t, ["no_such_field=1"])


def run_both(backend: str, num_games: int, max_moves: int, run_seed: int = 77):
    jcfg = dataclasses.replace(
        jconfig.tiny_config(),
        hidden_size=16,
        num_residual_blocks=1,
        num_simulations=4,
        search_max_depth=4,
        eval_max_moves=max_moves,
        search_backend=backend,
    )
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    jnet = jax_network_from_config(jax.random.PRNGKey(0), jcfg)
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params), tcfg)
    jstate, jent, jval, jn, jcodes = jax_evaluate_rollout(
        jnet.params, jnet.apply_fns, jax.random.PRNGKey(1), jnp.uint32(run_seed), jcfg, num_games
    )
    tstate, tent, tval, tn, tcodes = _evaluate_rollout(tnet, run_seed, tcfg, num_games, "cpu")
    np.testing.assert_array_equal(tstate.board.numpy(), np.asarray(jstate.board))
    np.testing.assert_array_equal(tstate.step_count.numpy(), np.asarray(jstate.step_count))
    np.testing.assert_array_equal(tstate.total_reward.numpy(), np.asarray(jstate.total_reward))
    np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tent), float(jent), rtol=1e-4)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-4)
    assert int(tstate.step_count.max()) <= max_moves


def test_evaluate_rollout_matches_jax_xla_backend():
    run_both("xla", num_games=4, max_moves=24)


def test_evaluate_rollout_matches_jax_pallas_backend():
    # The JAX package engages its Pallas kernel (here in interpret mode) only
    # for batches that are a multiple of 128 games; smaller ones fall back to
    # its XLA search. On the CPU the port's "pallas" backend runs the
    # kernel's plain version through the kernel wrapper.
    from simulate_2048_tpu.ops.pallas_search import BLOCK_G

    run_both("pallas", num_games=BLOCK_G, max_moves=6)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with JAX made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'chex', 'simulate_2048_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import simulate_2048_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')}\n"
        "assert {pkg.__name__ + '.' + n for n in ('train', 'training.trainer', 'training.losses', 'training.replay',"
        " 'training.learner', 'training.checkpoint', 'ops.distributional', 'utils.metrics', 'ops.rollout',"
        " 'ops.rollout_kernel', 'bench', 'training.reanalyze', 'parallel', 'parallel.ring', 'parallel.mesh',"
        " 'parallel.dp', 'parallel.actor_learner', 'scripts.benchmark_mcts', 'scripts.benchmark_training',"
        " 'scripts.verify_parity', 'scripts.benchmark_scaling', 'utils.card', 'scripts.trace_summary',"
        " 'scripts.trace_training', 'scripts.recipes', 'scripts.diagnosis', 'scripts.autopsy_eval',"
        " 'scripts.prior_sweep', 'scripts.model_probe', 'scripts.compare_scalar60k', 'scripts.measure_overlap',"
        " 'scripts.multihost_demo', 'scripts.warm_compile', 'scripts.bench_engine_ops', 'scripts.plot_metrics')}"
        " <= names, names\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in [REPO / "chip_smoke.py", *sorted((REPO / "simulate_2048_tpu_torch").rglob("*.py"))]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                banned = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "simulate_2048_tpu")
                assert root not in banned, f"{path}: {line}"


def test_gpu_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU behaviour is checked on CPU-only machines")
    from simulate_2048_tpu_torch import evaluate
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops import search_kernel as sk
    from simulate_2048_tpu_torch.search.mcts import SearchConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--mode", "tiny", "--games", "1"])
    meta = torch.empty(1, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sk.whole_search(meta, meta, meta, None, SearchConfig(num_simulations=2))
    from simulate_2048_tpu_torch.scripts import (
        autopsy_eval,
        benchmark_mcts,
        benchmark_scaling,
        benchmark_training,
        compare_scalar60k,
        measure_overlap,
        model_probe,
        multihost_demo,
        prior_sweep,
        trace_training,
        verify_parity,
        warm_compile,
    )

    nowhere = str(REPO / "no-such-run")
    for script, argv in (
        (benchmark_mcts, ["--mode", "tiny", "--boards", "2", "--sims", "2"]),
        (trace_training, ["--checkpoint-dir", nowhere]),
        (benchmark_training, ["--mode", "tiny", "--steps", "1"]),
        (verify_parity, ["--boards", "2", "--steps", "2", "--check", "2"]),
        (benchmark_scaling, ["--virtual", "2", "--envs-per-device", "2", "--steps", "2"]),
        (autopsy_eval, ["--ckpt-dir", nowhere, "--steps", "1"]),
        (prior_sweep, ["--ckpt-dir", nowhere]),
        (model_probe, ["--ckpt-dir", nowhere]),
        (compare_scalar60k, [nowhere]),
        (measure_overlap, ["--steps", "1"]),
        (multihost_demo, ["--num-processes", "1", "--process-id", "0"]),
        (warm_compile, ["scalar60k"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(argv)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_evaluate_cli_on_cpu(capsys):
    from simulate_2048_tpu_torch import evaluate

    evaluate.main(
        ["--mode", "tiny", "--games", "2", "--device", "cpu", "--set", "num_simulations=3", "--set", "eval_max_moves=5"]
    )
    out = capsys.readouterr().out
    assert "games: 2" in out and "mean reward:" in out and "reached 2048: 0/2" in out
    with pytest.raises(SystemExit):
        evaluate.main(["--checkpoint-dir", "somewhere", "--device", "cpu"])


def test_evaluate_cli_loads_the_champion_checkpoint(tmp_path, capsys):
    """``--checkpoint-dir <dir>/best``: the checkpoint a deep evaluation selected, with its config sidecar."""
    from simulate_2048_tpu_torch import evaluate
    from simulate_2048_tpu_torch.training.trainer import Trainer

    config = dataclasses.replace(
        tconfig.tiny_config(), hidden_size=16, num_residual_blocks=1, num_simulations=3, eval_max_moves=5,
        deep_eval_games=2, num_parallel_games=2, value_bins=16, reward_bins=8,
    )  # fmt: skip
    trainer = Trainer(config, checkpoint_dir=str(tmp_path), seed=5, device="cpu")
    trainer.initialize()
    stats = trainer.deep_evaluate(7, verbose=False)
    capsys.readouterr()
    evaluate.main(["--checkpoint-dir", str(tmp_path / "best"), "--device", "cpu", "--games", "2"])
    out = capsys.readouterr().out
    assert f"loaded checkpoint step 7 from {tmp_path / 'best'}" in out and "games: 2" in out
    assert stats["mean_reward"] >= 0 and (tmp_path / "deep_eval_best.json").exists()

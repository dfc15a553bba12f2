"""The checkpoint diagnoses of ``simulate_2048_tpu_torch/scripts/`` against the
repository's JAX scripts, on the CPU.

- The prior ablations are weight transforms (``autopsy_eval.flat_prior``,
  ``prior_sweep.soften_prior``): their logits equal the literal wrapper of
  ``prediction`` that the JAX scripts use bit for bit, for scalar and
  categorical heads and float32 and bfloat16 towers.
- ``autopsy_eval`` and ``prior_sweep``: a variant's evaluation equals the
  JAX package's ``evaluate_games`` with the JAX script's own
  ``flat_prior_fns`` / ``soften_prior`` on the same converted weights and run
  seed (two variants of each script, as each JAX variant compiles a
  program): per-game rewards and tiles exact, the entropy and value means
  within rtol 1e-5 (atol 1e-6, for a mean near 0). The kernel wrapper's
  plain version on the transformed pack plays the wrapped plain search's
  games.
- ``model_probe``: every key of the JAX script's output on one fixed
  trajectory, within rtol 1e-5 (atol 1e-4 for keys near 0, ``PROBE_ATOL``).
- ``compare_scalar60k``: each line against ``evaluate_games`` on the weights
  of a checkpoint the port's ``CheckpointManager`` wrote with its sidecar.

All fixtures are tiny: H=32, one block, 4 games, at most 20 moves and 8
simulations, fresh Flax weights converted by ``convert.py`` (categorical
heads perturbed, ``test_torch_self_play.perturb_heads``).
"""

import copy
import dataclasses
import importlib.util
import json
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_self_play import perturb_heads

from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training.learner import create_train_state as jax_create_train_state
from simulate_2048_tpu.training.self_play import evaluate_games as jax_evaluate_games
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.scripts import autopsy_eval, compare_scalar60k, model_probe, prior_sweep
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager
from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GAMES = 4
# model_probe's statistics near 0 (a correlation of fresh weights, a mean value or reward error near 0) lose digits
# to cancellation: h^-1 in float32 subtracts 1 from sqrt(1 + 0.004 (|x| + 1)), and XLA's and PyTorch's sqrt differ
# by an ulp there (2.6e-4 on a raw value of 6.6 from the same input). Away from 0 the keys agree to rtol 1e-5.
PROBE_ATOL = 1e-4
# The same cancellation in the search's values: a fresh categorical network's mean root value sits near 0.
MEAN_ATOL = 1e-6
OVERRIDES = ["hidden_size=32", "num_residual_blocks=1", "num_simulations=6", "eval_max_moves=20"]


def jax_script(name: str) -> types.ModuleType:
    """The repository's ``scripts/<name>.py``, imported as a module."""
    if f"jax_script_{name}" not in sys.modules:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[f"jax_script_{name}"] = module
    return sys.modules[f"jax_script_{name}"]


def configs(*extra: str):
    """(JAX config, port config): ``small_config()`` with ``OVERRIDES`` and ``extra``, as the scripts build it."""
    jcfg = jconfig.apply_overrides(jconfig.small_config(), OVERRIDES + list(extra))
    return jcfg, tconfig.TrainConfig(**dataclasses.asdict(jcfg))


def converted(jcfg, tcfg, seed: int = 0):
    """(JAX params, port network) of the same fresh weights, categorical heads perturbed."""
    state, _ = jax_create_train_state(jax.random.PRNGKey(seed), jcfg)
    params = perturb_heads(state.params)
    return params, params_from_flax(jax.tree.map(np.asarray, params), tcfg)


def jax_fns(jcfg):
    _, network = jax_create_train_state(jax.random.PRNGKey(0), jcfg)
    return network.apply_fns


def jax_run_seed(seed: int) -> int:
    """The run seed that the JAX package's ``evaluate_games`` draws from ``PRNGKey(seed)``."""
    _, seed_key = jax.random.split(jax.random.PRNGKey(seed))
    return int(jax.random.randint(seed_key, (), 0, 1 << 30, dtype=jnp.int32))


def write_checkpoint(directory: Path, tcfg, network, step: int) -> None:
    state = TrainState(network, create_optimizer(tcfg).init(list(network.parameters())), step)
    manager = CheckpointManager(str(directory))
    manager.save_config(tcfg)
    manager.save(state, step)


def assert_stats_match(port: dict, ref: dict, label: str) -> None:
    """Per-game rewards and tiles and every count exact; the entropy and value means within rtol 1e-5
    (atol ``MEAN_ATOL``)."""
    for key, want in ref.items():
        if key in ("mean_search_entropy", "mean_search_value"):
            np.testing.assert_allclose(port[key], want, rtol=1e-5, atol=MEAN_ATOL, err_msg=f"{label}: {key}")
        else:
            assert port[key] == want, f"{label}: {key} {port[key]} != {want}"
    if "per_game_lengths" in port:
        assert np.mean(port["per_game_lengths"]) == ref["mean_length"], label


class Wrapped(torch.nn.Module):
    """The JAX scripts' wrapper of the prediction head, literally: the real head, then ``fn`` on its logits."""

    def __init__(self, real, fn):
        super().__init__()
        self.real, self.fn = real, fn

    def forward(self, hidden):
        logits, value = self.real(hidden)
        return self.fn(logits), value


ABLATIONS = {
    "flat_prior": (autopsy_eval.flat_prior, torch.zeros_like),
    "T2": (lambda net: prior_sweep.soften_prior(net, 2.0), lambda logits: logits / 2.0),
    "T4": (lambda net: prior_sweep.soften_prior(net, 4.0), lambda logits: logits / 4.0),
}


@pytest.mark.parametrize("bins", [1, 16], ids=["scalar", "categorical"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prior_transforms_equal_the_literal_wrapper(bins, bf16):
    jcfg, tcfg = configs(f"value_bins={bins}", f"reward_bins={max(bins // 2, 1)}", f"use_bfloat16={bf16}")
    _, network = converted(jcfg, tcfg)
    hidden = network.representation(torch.from_numpy(np.random.RandomState(5).randint(0, 12, (64, 16)) / 16.0).float())
    for name, (transform, fn) in ABLATIONS.items():
        got_logits, got_value = transform(network).prediction(hidden)
        want_logits, want_value = Wrapped(network.prediction, fn)(hidden)
        assert got_logits.dtype == want_logits.dtype, name
        assert torch.equal(got_logits, want_logits) and torch.equal(got_value, want_value), name
        assert not torch.equal(got_logits, network.prediction(hidden)[0]), name
    # The copies leave the network alone.
    assert torch.equal(network.prediction(hidden)[0], Wrapped(network.prediction, lambda x: x)(hidden)[0])


def test_soften_prior_refuses_inexact_temperatures():
    jcfg, tcfg = configs()
    _, network = converted(jcfg, tcfg)
    for temp in (3.0, 0.3, 0.0, -2.0, float("inf")):
        with pytest.raises(ValueError, match="power-of-two"):
            prior_sweep.soften_prior(network, temp)
    soft = prior_sweep.soften_prior(network, 0.5)
    assert torch.equal(soft.prediction.policy_logits.weight, network.prediction.policy_logits.weight * 2)


def test_autopsy_eval_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    jcfg, tcfg = configs()
    params, network = converted(jcfg, tcfg)
    write_checkpoint(tmp_path, tcfg, network, 30)
    seed, sims = 1234, 8
    monkeypatch.setattr(tsp, "_draw_seed", lambda generator: jax_run_seed(seed))
    results = autopsy_eval.autopsy(str(tmp_path), [30], GAMES, sims, seed, OVERRIDES, "cpu", include_per_game=True)

    script = jax_script("autopsy_eval")
    fns = jax_fns(jcfg)
    flat = script.flat_prior_fns(fns)
    jcfg_sims = dataclasses.replace(jcfg, num_simulations=sims)
    # Two of the four variants through JAX (each compiles its own program): the flat prior with the raised
    # budget covers both of the script's changes; the other two are these with one change left out.
    want = {"base": (fns, jcfg), "flat_sims8": (flat, jcfg_sims)}
    assert [name for name, _ in results["step30"]] == ["base", "flat_prior", "sims8", "flat_sims8"]
    assert list(results) == ["random_init", "step30"]
    for name, stats in results["step30"]:
        if name in want:
            f, c = want[name]
            ref = jax_evaluate_games(params, f, jax.random.PRNGKey(seed), c, GAMES, include_per_game=True)
            assert_stats_match(stats, ref, f"autopsy_eval {name}")

    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    jax_keys = json.loads((REPO / "runs" / "autopsy_v3c.log").read_text().splitlines()[2])
    assert len(lines) == 8 and all(list(line) == list(jax_keys) for line in lines)
    assert [line["variant"] for line in lines[4:]] == ["base", "flat_prior", "sims8", "flat_sims8"]
    assert err.count("search plain, launches {}") == 8


def test_prior_sweep_matches_the_jax_script(monkeypatch, capsys):
    jcfg, tcfg = configs()
    params, network = converted(jcfg, tcfg, seed=1)
    seed = 77
    monkeypatch.setattr(tsp, "_draw_seed", lambda generator: jax_run_seed(seed))
    wanted = {"prior_T2", "T4_pb_c_0.5"}  # both temperatures, one with a changed pb_c_init
    results = prior_sweep.sweep(network, tcfg, GAMES, seed, wanted, include_per_game=True)

    script = jax_script("prior_sweep")
    source = (REPO / "scripts" / "prior_sweep.py").read_text()
    jax_grid = re.findall(r'\("([\w.]+)", ([\d.]+), (cfg\.pb_c_init|[\d.]+), cfg\.num_simulations\)', source)
    grid = [(n, t, pb, s) for n, t, pb, s in prior_sweep.grid(tcfg)]
    assert len(jax_grid) == 10 and [(n, float(t)) for n, t, _ in jax_grid] == [(n, t) for n, t, _, _ in grid]
    assert [tcfg.pb_c_init if pb == "cfg.pb_c_init" else float(pb) for _, _, pb in jax_grid] == [g[2] for g in grid]
    assert all(s == tcfg.num_simulations for *_, s in grid)

    fns = jax_fns(jcfg)
    assert [name for name, _ in results] == ["prior_T2", "T4_pb_c_0.5"]
    for name, stats in results:
        _, temp, pb, sims = next(g for g in grid if g[0] == name)
        c = dataclasses.replace(jcfg, pb_c_init=pb, num_simulations=sims)
        ref = jax_evaluate_games(params, script.soften_prior(fns, temp), jax.random.PRNGKey(seed), c, GAMES,
                                 include_per_game=True)  # fmt: skip
        assert_stats_match(stats, ref, f"prior_sweep {name}")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    jax_keys = json.loads((REPO / "runs" / "prior_sweep_tpu.log").read_text().splitlines()[2])
    assert [list(line) for line in lines] == [list(jax_keys)] * 2


@pytest.mark.parametrize("ablation", list(ABLATIONS))
def test_kernel_plain_version_carries_the_ablation(ablation):
    """The kernel wrapper's plain version (CPU tensors) searches the transformed
    network's pack; the plain search runs the untouched network with its
    ``prediction`` wrapped: the same games."""
    jcfg, tcfg = configs("eval_prior_temperature=4.0", "eval_pb_c_init=0.5")
    _, network = converted(jcfg, tcfg, seed=2)
    transform, fn = ABLATIONS[ablation]
    wrapped = copy.deepcopy(network)
    wrapped.prediction = Wrapped(wrapped.prediction, fn)
    kernel_cfg = dataclasses.replace(tcfg, search_backend="pallas")
    got = tsp.evaluate_games(transform(network), torch.Generator().manual_seed(9), kernel_cfg, GAMES, True)
    want = tsp.evaluate_games(wrapped, torch.Generator().manual_seed(9), tcfg, GAMES, True)
    assert_stats_match(got, want, ablation)
    assert got["per_game_lengths"] == want["per_game_lengths"]


@pytest.mark.parametrize("bins", [1, 16], ids=["scalar", "categorical"])
def test_model_probe_matches_the_jax_script(bins, monkeypatch, capsys):
    jcfg, tcfg = configs(f"value_bins={bins}", f"reward_bins={max(bins // 2, 1)}", "max_trajectory_length=20")
    params, network = converted(jcfg, tcfg, seed=3)
    traj = tsp.play_games(network, torch.Generator().manual_seed(4), 1.0, tcfg, GAMES)
    boards, actions, rewards, lengths = (x.numpy() for x in (traj.boards, traj.actions, traj.rewards, traj.length))
    got = model_probe.statistics(network, tcfg, boards, actions, rewards, lengths)

    import simulate_2048_tpu.training.checkpoint as jckpt
    import simulate_2048_tpu.training.config as jconfig_module
    import simulate_2048_tpu.training.self_play as jsp

    class Restored:  # the checkpoint the JAX script restores: the same weights, at step 7
        def __init__(self, directory):
            pass

        def restore(self, state, step=None):
            return types.SimpleNamespace(params=params, step=7)

    fixed = types.SimpleNamespace(boards=jnp.asarray(boards), actions=jnp.asarray(actions),
                                  rewards=jnp.asarray(rewards), length=jnp.asarray(lengths))  # fmt: skip
    monkeypatch.setattr(jckpt, "CheckpointManager", Restored)
    monkeypatch.setattr(jconfig_module, "small_config", lambda: jcfg)
    monkeypatch.setattr(jsp, "play_games", lambda *args, **kwargs: fixed)
    monkeypatch.setattr(sys, "argv", ["model_probe.py", "--ckpt-dir", "fixed", "--games", str(GAMES)])
    jax_script("model_probe").main()
    want = json.loads(capsys.readouterr().out)
    assert want.pop("ckpt") == "fixed" and want.pop("step") == 7
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, int):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=PROBE_ATOL, err_msg=key)


def test_compare_scalar60k_matches_jax(tmp_path, monkeypatch, capsys):
    script = jax_script("compare_scalar60k")
    assert compare_scalar60k.R3_OVERRIDES == script.R3_OVERRIDES
    seed = 123
    monkeypatch.setattr(tsp, "_draw_seed", lambda generator: jax_run_seed(seed))
    pairs = {}
    for name, bins in (("cat", 16), ("scalar", 1)):
        jcfg, tcfg = configs(f"value_bins={bins}", f"reward_bins={max(bins // 2, 1)}",
                             "eval_prior_temperature=4.0", "eval_pb_c_init=0.5")  # fmt: skip
        params, network = converted(jcfg, tcfg, seed=bins)
        write_checkpoint(tmp_path / name, tcfg, network, 40 + bins)
        pairs[str(tmp_path / name)] = (jcfg, params, 40 + bins)
    lines = compare_scalar60k.main([*pairs, "--games", str(GAMES), "--key", str(seed), "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines and [line["ckpt"] for line in lines] == list(pairs)
    for line, (ckpt, (jcfg, params, step)) in zip(lines, pairs.items()):
        ref = jax_evaluate_games(params, jax_fns(jcfg), jax.random.PRNGKey(seed), jcfg, GAMES)
        assert line.pop("ckpt") == ckpt and line.pop("step") == step
        assert list(line) == list(ref)
        assert_stats_match(line, ref, ckpt)

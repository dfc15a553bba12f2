"""The port's training recipes (``simulate_2048_tpu_torch/scripts/run_*.sh``)
against the JAX package's (``scripts/run_cat60k_twin.sh``,
``scripts/run_scalar60k_arm.sh``): the same config field for field, the same
search backend dispatch, the plain search under the recipe's evaluation
calibration (prior temperature 4, ``pb_c_init`` 0.5) against JAX's XLA
search on converted weights, and the same metric keys from the train CLI.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu.search.mcts import batched_run_mcts as jax_batched_run_mcts
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.scripts import recipes
from simulate_2048_tpu_torch.search.mcts import batched_run_mcts
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training.checkpoint import load_train_config
from simulate_2048_tpu_torch.training.self_play import _use_kernel, search_config_from

REPO = Path(__file__).resolve().parents[1]
RECIPES = ["run_cat60k_twin.sh", "run_scalar60k_arm.sh"]
CUDA = torch.device("cuda")


def jax_recipe_config(name: str, extra: tuple[str, ...] = ()) -> jconfig.TrainConfig:
    """JAX's config for ``scripts/<name>``: its preset with its ``--set`` flags."""
    argv = recipes.script_argv(REPO / "scripts" / name)
    preset = {"tiny": jconfig.tiny_config, "small": jconfig.small_config, "full": jconfig.default_config}
    return jconfig.apply_overrides(preset[argv[argv.index("--mode") + 1]](), recipes.set_overrides(argv) + list(extra))


@pytest.mark.parametrize("name", RECIPES)
def test_port_recipe_flags_are_jax_recipe_flags(name):
    port = recipes.script_argv(recipes.RECIPE_DIR / name)
    jax_argv = recipes.script_argv(REPO / "scripts" / name)
    # The port's script adds --device cuda and forwards its further arguments; its logs go to runs/torch_*.
    assert port[-3:] == ["--device", "cuda", "${@:2}"]
    assert recipes.set_overrides(port) == recipes.set_overrides(jax_argv)
    for flag in ("--mode", "--steps"):
        assert port[port.index(flag) + 1] == jax_argv[jax_argv.index(flag) + 1]
    assert port[port.index("--log-dir") + 1].startswith("runs/torch_")


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_config_matches_jax_field_for_field(name):
    port = recipes.recipe_config(name)
    ref = jax_recipe_config(name)
    jfields = {f.name for f in dataclasses.fields(ref)}
    shared = [f.name for f in dataclasses.fields(port) if f.name in jfields]
    assert len(shared) == len(jfields)
    for field in shared:
        assert getattr(port, field) == getattr(ref, field), field
    assert port.hidden_size == 128 and port.num_residual_blocks == 5 and port.num_simulations == 50
    assert (port.eval_prior_temperature, port.eval_pb_c_init) == (4.0, 0.5)
    assert (port.value_bins, port.reward_bins) == ((256, 128) if "cat" in name else (1, 1))


@pytest.mark.parametrize("name", RECIPES)
@pytest.mark.parametrize("eval_mode", [False, True], ids=["self-play", "evaluation"])
def test_recipe_search_backend_side_by_side(name, eval_mode):
    """The literal recipe ("xla") runs the plain search in both packages.
    With ``--set search_backend=auto`` the port takes its CUDA kernel on a
    CUDA device, for the self-play and the evaluation search alike, and the
    plain search on the CPU; JAX's plan refuses the recipe's 64 games (its
    kernel runs BLOCK_G = 128 searches a lane block and needs a multiple of
    it), so JAX's "auto" runs the XLA search here as its "xla" does, and takes
    its kernel only from 128 games. The CUDA kernel has no batch condition."""
    literal = recipes.recipe_config(name)
    auto = recipes.recipe_config(name, ["search_backend=auto"])
    jauto = jax_recipe_config(name, ("search_backend=auto",))
    assert literal.search_backend == jax_recipe_config(name).search_backend == "xla"
    cfg = search_config_from(auto, eval_mode)
    jcfg = jsp.search_config_from(jauto, eval_mode)
    assert (cfg.prior_temperature, cfg.pb_c_init) == (jcfg.prior_temperature, jcfg.pb_c_init)
    assert (cfg.prior_temperature, cfg.pb_c_init) == ((4.0, 0.5) if eval_mode else (1.0, 1.25))
    plan = functools.partial(jps.pallas_search_plan, jcfg, jauto.hidden_size, jauto.num_residual_blocks)
    assert jauto.num_parallel_games == 64 and plan(64) is None and plan(jps.BLOCK_G) == 0  # 0: resident weights
    assert _use_kernel(auto, cfg, CUDA)
    assert not _use_kernel(auto, cfg, torch.device("cpu"))
    assert not _use_kernel(literal, search_config_from(literal, eval_mode), CUDA)


HIDDEN, BLOCKS, BATCH, SIMS = 32, 2, 8, 16


def eval_nets():
    """Flax networks with the cat60k recipe's heads (256/128 bins), their
    zero-initialised categorical head kernels perturbed by 0.05 * normal
    (numpy-seeded) so that nodes differ, and the port's converted copy."""
    jnet = create_network(jax.random.PRNGKey(5), hidden_size=HIDDEN, num_blocks=BLOCKS, value_bins=256, reward_bins=128)
    params = jax.tree.map(np.array, jax.device_get(jnet.params))
    rs = np.random.RandomState(16)
    for tree, name in ((params.prediction, "value"), (params.afterstate_prediction, "q_value"),
                       (params.dynamics, "reward")):  # fmt: skip
        kernel = tree["params"][name]["kernel"]
        tree["params"][name]["kernel"] = kernel + 0.05 * rs.standard_normal(kernel.shape).astype(np.float32)
    cfg = dataclasses.replace(tconfig.TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS,
                              value_bins=256, reward_bins=128)  # fmt: skip
    return jnet._replace(params=params), params_from_flax(params, cfg)


def test_plain_search_under_the_recipe_evaluation_calibration_matches_jax():
    """The recipe's evaluation search (``search_config_from(eval_mode=True)``
    without root noise, as greedy evaluation plays): visit counts identical to
    JAX's XLA search, Q and root value within 1e-4 (``test_torch_search.py``)."""
    shape = ["hidden_size=32", "num_residual_blocks=2", f"num_simulations={SIMS}"]
    cfg = search_config_from(recipes.recipe_config("run_cat60k_twin.sh", shape), eval_mode=True)
    jcfg = jsp.search_config_from(jax_recipe_config("run_cat60k_twin.sh", tuple(shape)), eval_mode=True)
    cfg, jcfg = cfg._replace(dirichlet_fraction=0.0), jcfg._replace(dirichlet_fraction=0.0)
    assert cfg._asdict() == jcfg._asdict()
    assert (cfg.prior_temperature, cfg.pb_c_init, cfg.value_bins, cfg.reward_bins) == (4.0, 0.5, 256, 128)
    jnet, tnet = eval_nets()
    rs = np.random.RandomState(4)
    obs = (rs.randint(0, 11, size=(BATCH, 16)) / 16.0).astype(np.float32)
    invalid = rs.rand(BATCH, 4) < 0.3
    invalid[invalid.all(-1)] = False
    keys = jax.random.split(jax.random.PRNGKey(4), BATCH)
    ref = jax_batched_run_mcts(jnet.params, jnet.apply_fns, jnp.asarray(obs), keys, jcfg, jnp.asarray(invalid))
    out = batched_run_mcts(tnet, torch.from_numpy(obs), cfg, torch.from_numpy(invalid))
    np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
    np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=0, atol=1e-4)
    assert (out.visit_counts.sum(-1) == SIMS).all() and (out.visit_counts.numpy()[invalid] == 0).all()
    # The calibration matters here: the training search's PUCT on the same roots visits otherwise.
    train_cfg = cfg._replace(prior_temperature=1.0, pb_c_init=1.25)
    assert not torch.equal(batched_run_mcts(tnet, torch.from_numpy(obs), train_cfg, torch.from_numpy(invalid)).visit_counts,
                           out.visit_counts)  # fmt: skip


# Wall-clock seconds the port logs beside JAX's records (its segments, deep evaluations and reanalyze passes).
PORT_TIMING_KEYS = {"gen/seconds", "deep_eval/seconds", "reanalyze/seconds"}


def test_train_cli_logs_jax_metric_keys(tmp_path, capsys):
    """The port's train CLI at ``--mode tiny`` with the cat60k recipe's
    overrides, cut to 4 steps with an evaluation and a deep evaluation at step
    4: the keys of its ``metrics.jsonl`` are those of JAX's run of the recipe
    (``runs/r5_cat60k/metrics.jsonl``), apart from the port's timing keys."""
    from simulate_2048_tpu_torch import train

    argv = recipes.script_argv(recipes.RECIPE_DIR / "run_cat60k_twin.sh")
    cut = ["log_interval=2", "eval_interval=4", "eval_games=2", "eval_max_moves=8", "deep_eval_interval=4",
           "deep_eval_games=2", "checkpoint_interval=4"]  # fmt: skip
    overrides = [w for o in recipes.set_overrides(argv) + cut for w in ("--set", o)]
    train.main(["--mode", "tiny", "--steps", "4", "--device", "cpu", "--no-eval", "--checkpoint-dir",
                str(tmp_path / "ckpt"), "--log-dir", str(tmp_path), *overrides])  # fmt: skip
    port_keys = set().union(*(json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()))
    jax_keys = set().union(*(json.loads(line) for line in (REPO / "runs/r5_cat60k/metrics.jsonl").open()))
    assert port_keys - PORT_TIMING_KEYS == jax_keys
    assert {"gen/seconds", "deep_eval/seconds"} <= port_keys
    recorded = load_train_config(str(tmp_path / "ckpt"))
    assert recorded == tconfig.apply_overrides(tconfig.tiny_config(), recipes.set_overrides(argv) + cut)


# The other recipes (their steps come first, except the round-4 champion's, which JAX's script fixes), and what
# the port's copy forwards to train: every argument, or those after STEPS (and the source directory).
MORE_RECIPES = {
    "run_champion_r4.sh": '"$@"',
    "run_temp_early_arm.sh": '"${@:2}"',
    "run_full_capacity_probe.sh": '"${@:2}"',
    "run_champion_r5.sh": '"${@:2}"',
    "run_gumbel_resumed_ab.sh": '"${@:3}"',
}


@pytest.mark.parametrize("name", list(MORE_RECIPES))
def test_more_recipes_take_jax_flags_and_configs(name):
    """Each remaining recipe: JAX's preset, steps and ``--set`` flags, then
    ``--device cuda`` and the forwarded arguments; the config it trains equals
    JAX's field for field; logs and checkpoints under the port's ``runs/torch_*``,
    and a resuming recipe copies the port's own checkpoints."""
    port = recipes.script_argv(recipes.RECIPE_DIR / name)
    jax_argv = recipes.script_argv(REPO / "scripts" / name)
    assert recipes.set_overrides(port) == recipes.set_overrides(jax_argv)
    for flag in ("--mode", "--steps"):
        assert port[port.index(flag) + 1] == jax_argv[jax_argv.index(flag) + 1], flag
    device = port.index("--device")
    assert port[device + 1] == "cuda" and port[device + 2] == MORE_RECIPES[name].strip('"')
    text = (recipes.RECIPE_DIR / name).read_text()
    assert "runs/torch_" in port[port.index("--checkpoint-dir") + 1] or "$dir" in port[port.index("--log-dir") + 1]
    assert MORE_RECIPES[name] in text and "runs/r5_" not in text and "runs/champion_r" not in text
    # The A/B's deep evaluation runs at its last step, "$STEPS" (default 6000) in both scripts.
    port_sets, jax_sets = ([o.replace("$STEPS", "6000") for o in recipes.set_overrides(a)] for a in (port, jax_argv))
    mode = port[port.index("--mode") + 1]
    port_cfg = tconfig.apply_overrides(recipes.PRESETS[mode](), port_sets)
    ref = jconfig.apply_overrides({"small": jconfig.small_config, "full": jconfig.default_config}[mode](), jax_sets)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref)
    if "$STEPS" not in " ".join(port):
        assert port_cfg == recipes.recipe_config(name)
    if name == "run_champion_r5.sh":
        assert "cp -r runs/torch_champion_r4/ckpt runs/torch_champion_r5/ckpt" in text
    if name == "run_gumbel_resumed_ab.sh":
        assert 'SRC="${1:-runs/torch_cat60k/ckpt}"' in text and 'dir="runs/torch_gres_${arm}"' in text
        assert "gumbel)   extra=(--set root_selection=gumbel) ;;" in text


@pytest.mark.parametrize("name", ["measure_categorical_kernel.sh", "measure_search_kernels.sh"])
def test_measure_scripts_run_the_ports_benchmark_mcts_with_jax_flags(name):
    def runs(path, command):
        return [line.split(command, 1)[1].split() for line in path.read_text().splitlines() if command in line]

    port = runs(recipes.RECIPE_DIR / name, "python -m simulate_2048_tpu_torch.scripts.benchmark_mcts")
    assert port and port == runs(REPO / "scripts" / name, "python scripts/benchmark_mcts.py")

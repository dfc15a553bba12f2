"""The port's ``benchmark_mcts`` and ``benchmark_training`` entry points
(``simulate_2048_tpu_torch/scripts/``) against the JAX package, on the CPU.

- ``benchmark_mcts``: the script's roots equal the JAX script's; on a tiny
  network (H=32, 2 blocks; Flax weights converted by ``convert.py``) at 8
  boards x 8 simulations, with the root's Dirichlet noise drawn by JAX from
  the JAX script's keys and fed to the port, the script's search gives JAX's
  ``batched_run_mcts`` root visits exactly and its root values within rtol
  1e-4 / atol 1e-3 (float32 sums in another order), plain and ``--pallas``
  (the kernel's plain version on CPU tensors). The CLI prints the JAX
  script's result keys, and exits 2 outside the kernel's limits.
- ``benchmark_training``: the script's fixture equals the JAX script's
  arrays bit for bit, and the buffers both packages make of it are equal;
  at ``--mode tiny`` its ``flops_per_step`` (PyTorch's ``FlopCounterMode``)
  equals an analytic count of one step's dense products, written below from
  the config; the CLI prints the JAX script's keys and the card keys.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.search.mcts import SearchConfig as JaxSearchConfig
from simulate_2048_tpu.search.mcts import batched_run_mcts as jax_batched_run_mcts
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.scripts import benchmark_mcts, benchmark_training
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)
CPU = torch.device("cpu")

MCTS_KEYS = {"boards", "hidden", "blocks", "num_simulations", "search_ms_per_batch", "compile_ms", "searches_per_s",
             "simulations_per_s"}  # fmt: skip
TRAINING_KEYS = {"mode", "batch_size", "sample_ms", "peak_tflops_assumed", "fp32", "bf16", "bf16_speedup"}
STEP_KEYS = {"train_step_ms", "train_compile_ms", "learner_steps_per_s", "samples_per_s", "flops_per_step",
             "mfu_vs_bf16_peak"}  # fmt: skip
CARD_KEYS = {"device", "card", "tf32_matmul"}


def run_cli(main, argv: list[str]):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue())


# ---- benchmark_mcts

HIDDEN, BLOCKS, BOARDS, SIMS = 32, 2, 8, 8


@pytest.fixture(scope="module")
def mcts_pair():
    """The JAX script's network, roots, keys and search, and the port script's setup on the same weights."""
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=BLOCKS, codebook_size=32)
    setup = benchmark_mcts.setup(BOARDS, SIMS, "tiny", None, HIDDEN, BLOCKS, 1, 1, CPU)
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params), setup.config)
    jobs = jenv.get_observation(jenv.reset_batch(0, BOARDS))
    keys = jax.random.split(jax.random.PRNGKey(1), BOARDS)
    jcfg = JaxSearchConfig(num_simulations=SIMS, codebook_size=32, discount=setup.config.discount, max_depth=None)
    ref = jax_batched_run_mcts(jnet.params, jnet.apply_fns, jobs, keys, jcfg)
    # The root noise JAX's search draws from each board's key (tests/test_torch_search.py feeds it the same way).
    noise = jax.vmap(lambda k: jax.random.dirichlet(k, jnp.full((4,), jcfg.dirichlet_alpha)))(keys)
    return setup, tnet, np.asarray(jobs), ref, torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
def test_benchmark_mcts_search_matches_jax(mcts_pair, pallas):
    setup, tnet, jobs, ref, noise = mcts_pair
    np.testing.assert_array_equal(setup.observations.numpy(), jobs)
    assert setup.search_config.dirichlet_fraction == 0.1 and setup.search_config.max_depth is None
    out = benchmark_mcts.search_fn(tnet, setup.observations, setup.search_config, pallas, noise=noise)()
    np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
    np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=1e-4, atol=1e-3)
    assert (out.visit_counts.sum(-1) == SIMS).all()


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
def test_benchmark_mcts_cli_prints_the_jax_keys(pallas):
    argv = ["--device", "cpu", "--mode", "tiny", "--boards", "4", "--sims", "4"] + ["--pallas"] * pallas
    result = run_cli(benchmark_mcts.main, argv)
    assert MCTS_KEYS <= set(result), set(result)
    assert (result["boards"], result["hidden"], result["blocks"], result["num_simulations"]) == (4, 64, 2, 4)
    assert result["backend"] == ("whole_search" if pallas else "plain") and result["launches"] == {}
    np.testing.assert_allclose(result["searches_per_s"], 4 / (result["search_ms_per_batch"] / 1e3))
    np.testing.assert_allclose(result["simulations_per_s"], 4 * result["searches_per_s"])


@pytest.mark.parametrize("flags", [["--hidden", "48"], ["--value-bins", "513"]], ids=["hidden_48", "bins_513"])
def test_benchmark_mcts_exits_2_outside_the_kernel_limits(flags, capsys):
    with pytest.raises(SystemExit) as exit_info:
        benchmark_mcts.main(["--device", "cpu", "--mode", "tiny", "--boards", "4", "--sims", "2", "--pallas", *flags])
    assert exit_info.value.code == 2
    assert "config unsupported (the kernel takes" in capsys.readouterr().err


@pytest.mark.parametrize(
    "weight_dtype,hidden,bins,want",
    [("float32", 256, 1, "whole_search"), ("float32", 256, 16, "whole_search_categorical"),
     ("bfloat16", 256, 1, "whole_search_bf16"), ("bfloat16", 512, 16, "whole_search_bf16_streamed")],
)  # fmt: skip
def test_benchmark_mcts_flags_pick_the_four_libraries(weight_dtype, hidden, bins, want):
    cfg = benchmark_mcts.SearchConfig(num_simulations=4, value_bins=bins, reward_bins=bins)
    assert benchmark_mcts.library(cfg, hidden, benchmark_mcts.WEIGHT_DTYPES[weight_dtype]) == want


# ---- benchmark_training


def jax_fixture(config):
    """The JAX script's dummy trajectories (``scripts/benchmark_training.py:68-84``), as it writes them."""
    rs = np.random.RandomState(0)
    n_traj, t = max(config.min_buffer_size, 64), config.max_trajectory_length
    return jreplay.Trajectory(
        boards=jnp.asarray(rs.randint(0, 8, (n_traj, t + 1, 16)).astype(np.int8)),
        actions=jnp.asarray(rs.randint(0, 4, (n_traj, t)).astype(np.int8)),
        rewards=jnp.asarray((rs.rand(n_traj, t) * 4).astype(np.float32)),
        policies=jnp.asarray(np.full((n_traj, t, 4), 0.25, np.float32)),
        values=jnp.asarray((rs.rand(n_traj, t) * 10).astype(np.float32)),
        priorities=jnp.asarray((rs.rand(n_traj, t)).astype(np.float32)),
        length=jnp.full((n_traj,), t, jnp.int32),
        terminated=jnp.ones(n_traj, bool),
        total_reward=jnp.asarray((rs.rand(n_traj) * 100).astype(np.float32)),
        max_tile=jnp.full((n_traj,), 256, jnp.int32),
    )


def test_benchmark_training_fixture_matches_jax():
    tcfg = benchmark_training.PRESETS["tiny"]()
    jcfg = jconfig.tiny_config()
    want = jax_fixture(jcfg)
    got = benchmark_training.dummy_trajectories(tcfg)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    jbuf = jreplay.add_trajectories(jreplay.init_buffer(jcfg), want)
    tbuf = treplay.add_trajectories(treplay.init_buffer(tcfg), got)
    for name in jbuf._fields:
        w, g = np.asarray(getattr(jbuf, name)).astype(np.float64), getattr(tbuf, name).to(torch.float64).numpy()
        assert np.array_equal(g, w), name


def analytic_step_flops(cfg: TrainConfig) -> int:
    """FLOP of the dense products of one ``train_step`` with scalar heads, oracle
    chance targets and no consistency loss: 2 per multiply-add, forward, then
    backward (the weight gradient of every layer; the input gradient of every
    layer whose input needs one: not the first layers fed the observations,
    the action one-hots or the oracle's chance codes), then the fresh
    priorities' h and f passes (forward only)."""
    assert (cfg.value_bins, cfg.reward_bins, cfg.chance_target_mode, cfg.consistency_loss_weight) == (1, 1, "oracle",
                                                                                                        0.0)
    b, k, h, nb = cfg.batch_size, cfg.num_unroll_steps, cfg.hidden_size, cfg.num_residual_blocks
    a, c, d = cfg.action_size, cfg.codebook_size, cfg.observation_dim

    def dense(rows, n_in, n_out, input_grad=True):  # forward + weight gradient (+ input gradient)
        return 2 * rows * n_in * n_out * (3 if input_grad else 2)

    def trunk(rows, n_in, input_grad=True):  # projection, then 2 layers a residual block
        return dense(rows, n_in, h, input_grad) + 2 * nb * dense(rows, h, h)

    f_rows, t_rows = (k + 1) * b, k * b
    total = trunk(b, d, False) + dense(b, h, h)  # h on the first observations
    total += trunk(f_rows, h) + dense(f_rows, h, a) + dense(f_rows, h, 1)  # f, K + 1 times
    total += dense(t_rows, h, h) + dense(t_rows, a, h, False) + trunk(t_rows, h) + dense(t_rows, h, h)  # φ
    total += trunk(t_rows, h) + dense(t_rows, h, c) + dense(t_rows, h, 1)  # ψ
    total += dense(t_rows, h, h) + dense(t_rows, c, h, False) + trunk(t_rows, h) + dense(t_rows, h, h)  # g
    total += dense(t_rows, h, 1)  # g's reward head
    forward = 2 * b * (d * h + 2 * nb * h * h + h * h + h * h + 2 * nb * h * h + h * a + h)  # fresh priorities: h, f
    return total + forward


def xla_step_flops(config) -> float:
    """XLA's cost model for the JAX script's jitted train step on this CPU (``cost_analysis()['flops']``)."""
    state, network = jlearner.create_train_state(jax.random.PRNGKey(0), config)
    optimizer = jlearner.create_optimizer(config)
    buffer = jreplay.add_trajectories(jreplay.init_buffer(config), jax_fixture(config))
    batch, _, weights = jreplay.sample_batch(buffer, jax.random.PRNGKey(1), config.batch_size, config)
    step = jax.jit(lambda s, b, w: jlearner.train_step(s, network.apply_fns, b, w, config, optimizer))
    cost = step.lower(state, batch, weights).compile().cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


@pytest.fixture(scope="module")
def training_cli():
    return run_cli(
        benchmark_training.main, ["--device", "cpu", "--mode", "tiny", "--steps", "1", "--peak-tflops", "2.5"]
    )


def test_benchmark_training_flops_equal_the_analytic_count(training_cli):
    want = analytic_step_flops(benchmark_training.PRESETS["tiny"]())
    xla = xla_step_flops(jconfig.tiny_config())
    print(f"tiny train step: analytic dense products {want:,}; XLA's cost model on the CPU {xla:,.0f} (fp32)")
    for dtype in ("fp32", "bf16"):
        got = training_cli[dtype]["flops_per_step"]
        assert got == want, (
            f"{dtype}: FlopCounterMode {got:,} != analytic {want:,} "
            f"(XLA's cost_analysis of the JAX step, another definition: {xla:,.0f})"
        )


def test_benchmark_training_cli_prints_the_jax_and_card_keys(training_cli):
    result = training_cli
    assert TRAINING_KEYS | CARD_KEYS <= set(result), set(result)
    assert (result["mode"], result["batch_size"], result["peak_tflops_assumed"]) == ("tiny", 32, 2.5)
    assert (result["device"], result["card"], result["tf32_matmul"]) == ("cpu", None, False)
    for dtype in ("fp32", "bf16"):
        step = result[dtype]
        assert STEP_KEYS <= set(step), set(step)
        np.testing.assert_allclose(step["learner_steps_per_s"], 1e3 / step["train_step_ms"])
        np.testing.assert_allclose(step["samples_per_s"], 32 * step["learner_steps_per_s"])
        np.testing.assert_allclose(
            step["mfu_vs_bf16_peak"], step["flops_per_step"] / (step["train_step_ms"] / 1e3) / 2.5e12
        )
    fp32_ms, bf16_ms = result["fp32"]["train_step_ms"], result["bf16"]["train_step_ms"]
    np.testing.assert_allclose(result["bf16_speedup"], fp32_ms / bf16_ms)


def test_benchmark_training_has_no_mfu_on_the_cpu_without_a_peak():
    result = benchmark_training.benchmark("tiny", steps=1, dtype="fp32", device="cpu")
    assert result["peak_tflops_assumed"] is None and result["fp32"]["mfu_vs_bf16_peak"] is None
    assert set(result) == TRAINING_KEYS - {"bf16", "bf16_speedup"} | CARD_KEYS | {"fp32"}

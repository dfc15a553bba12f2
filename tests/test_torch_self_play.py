"""Self-play of the PyTorch port vs the JAX package, on the CPU.

Same Flax weights (converted by ``convert.params_from_flax``), same config,
same run seed. A greedy ``play_segment`` draws nothing, so both packages play
the same games: boards, actions, rewards, lengths and ``terminated`` must be
bit-identical; policies, search values and priorities agree within
rtol 1e-4 / atol 1e-5 (float32 sums in another order inside the search).
``compute_n_step_returns`` and ``collection_priorities`` are held to
rtol 1e-5 on numpy-seeded inputs. The helpers here (``make_pair``,
``perturb_heads``) also serve the other ``test_torch_*`` files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu.training.learner import network_from_config as jax_network_from_config
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.search.mcts import PolicyOutput
from simulate_2048_tpu_torch.search.policy import sample_from_visits, select_action
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import self_play as tsp

torch.set_num_threads(1)


def perturb_heads(params, seed: int = 99):
    """0.05 * normal (numpy, seeded) on the categorical heads' kernels, which
    are zero when fresh: with zero kernels every node has the same
    expectation and the search's argmax compares float noise."""
    params = jax.tree.map(np.array, jax.device_get(params))
    rs = np.random.RandomState(seed)
    for tree, name in ((params.prediction, "value"), (params.afterstate_prediction, "q_value"),
                       (params.dynamics, "reward")):
        head = tree["params"][name]
        if head["kernel"].shape[-1] > 1:
            head["kernel"] = head["kernel"] + 0.05 * rs.standard_normal(head["kernel"].shape).astype(np.float32)
    return params


def make_pair(seed: int = 0, **overrides):
    """(JAX config, port config, JAX network, port network) with the same weights."""
    base = dict(hidden_size=16, num_residual_blocks=1, num_simulations=4, search_max_depth=4,
                max_trajectory_length=10, batch_size=8, replay_buffer_size=16)
    jcfg = dataclasses.replace(jconfig.tiny_config(), **{**base, **overrides})
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    jnet = jax_network_from_config(jax.random.PRNGKey(seed), jcfg)
    jnet = jnet._replace(params=perturb_heads(jnet.params))
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params), tcfg)
    return jcfg, tcfg, jnet, tnet


# One empty cell and no merge, before or after the one move left: the game ends after it.
NEARLY_DEAD = np.array([[3, 4, 5, 6], [7, 8, 9, 10], [3, 4, 5, 6], [7, 8, 9, 0]], dtype=np.int32)


def play_both(jcfg, tcfg, jnet, tnet, num_games: int, run_seed: int = 77, num_steps: int | None = None,
              dying_lanes: int = 0):
    """One greedy segment from a fresh batch in both packages; the first
    ``dying_lanes`` games start from a board with one empty cell and no merge."""
    jstate = jenv.reset_batch(jnp.uint32(run_seed), num_games)
    tstate = tenv.reset_batch(run_seed, num_games, "cpu")
    if dying_lanes:
        jstate = jstate._replace(board=jstate.board.at[:dying_lanes].set(jnp.asarray(NEARLY_DEAD)))
        tstate.board[:dying_lanes] = torch.from_numpy(NEARLY_DEAD)
    jnext, jtraj, jstats = jsp.play_segment(
        jnet.params, jnet.apply_fns, jstate, jax.random.PRNGKey(1), jnp.float32(0.0), jcfg, num_games, True, num_steps
    )
    tnext, ttraj, tstats = tsp.play_segment(tnet, tstate, None, 0.0, tcfg, num_games, True, num_steps)
    return (jnext, jtraj, jstats), (tnext, ttraj, tstats)


def assert_segments_match(jax_out, torch_out, atol: float = 1e-5):
    (jnext, jtraj, jstats), (tnext, ttraj, tstats) = jax_out, torch_out
    for name in ("boards", "actions", "rewards", "length", "terminated", "total_reward", "max_tile"):
        got, ref = getattr(ttraj, name), np.asarray(getattr(jtraj, name))
        assert got.numpy().dtype == ref.dtype, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    for name in ("policies", "values", "priorities"):
        np.testing.assert_allclose(
            getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name)), rtol=1e-4, atol=atol, err_msg=name
        )
    for name in ("completed", "completed_length_sum", "active_positions", "completed_score_sum"):
        assert float(getattr(tstats, name)) == float(getattr(jstats, name)), name
    for name in ("policy_entropy_sum", "search_value_sum", "first_search_value"):
        np.testing.assert_allclose(
            getattr(tstats, name).numpy(), np.asarray(getattr(jstats, name)), rtol=1e-4, atol=atol, err_msg=name
        )
    for name, t, j in zip(tnext._fields, tnext, jnext):  # reseeded lanes included
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype), err_msg=name)


@pytest.mark.parametrize("bins", [(1, 1), (16, 8)], ids=["scalar", "categorical"])
def test_greedy_play_segment_matches_jax(bins):
    pair = make_pair(value_bins=bins[0], reward_bins=bins[1])
    assert_segments_match(*play_both(*pair, num_games=4))


def test_greedy_play_segment_games_end_and_reseed():
    """Games that end inside the segment: ``terminated`` lanes, masked padding and reseeded lanes match."""
    pair = make_pair()
    jax_out, torch_out = play_both(*pair, num_games=6, dying_lanes=3)
    terminated = torch_out[1].terminated
    assert bool(terminated.any()) and not bool(terminated.all())
    assert_segments_match(jax_out, torch_out)


def test_greedy_play_segment_matches_jax_kernel_backend():
    """search_backend="pallas": the JAX package runs its Pallas kernel in
    interpret mode (batches of 128 games), the port the kernel's plain version.
    Fresh categorical heads give search values near 0.004, so the float
    tolerance is absolute here: 1e-4, as in ``test_torch_search_kernel.py``."""
    from simulate_2048_tpu.ops.pallas_search import BLOCK_G

    pair = make_pair(value_bins=16, reward_bins=8, search_backend="pallas", hidden_size=32)
    assert_segments_match(*play_both(*pair, num_games=BLOCK_G, num_steps=3), atol=1e-4)


def random_trajectory_arrays(seed: int, b: int = 6, t: int = 12):
    rs = np.random.RandomState(seed)
    rewards = (rs.rand(b, t) * 40).astype(np.float32)
    values = (rs.rand(b, t) * 300).astype(np.float32)
    lengths = np.array([t, t, 1, 5, 0, t - 1][:b], dtype=np.int32)
    mask = np.arange(t)[None] < lengths[:, None]
    terminated = np.array([True, False, True, False, True, False][:b])
    return rewards * mask, values * mask, lengths, terminated


@pytest.mark.parametrize("lam", [0.5, 1.0, 0.0])
@pytest.mark.parametrize("tail", [False, True])
def test_compute_n_step_returns_matches_jax(lam, tail):
    rewards, values, lengths, terminated = random_trajectory_arrays(3)
    jcfg = dataclasses.replace(jconfig.tiny_config(), td_lambda=lam)
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    tail_value = np.random.RandomState(4).rand(len(lengths)).astype(np.float32) * 100 if tail else None
    ref = jsp.compute_n_step_returns(
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(lengths), jcfg, jnp.asarray(terminated),
        None if tail_value is None else jnp.asarray(tail_value),
    )
    t = torch.from_numpy
    got = tsp.compute_n_step_returns(
        t(rewards), t(values), t(lengths), tcfg, t(terminated), None if tail_value is None else t(tail_value)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    no_flag = tsp.compute_n_step_returns(t(rewards), t(values), t(lengths), tcfg)
    ref_no_flag = jsp.compute_n_step_returns(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(lengths), jcfg)
    np.testing.assert_allclose(no_flag.numpy(), np.asarray(ref_no_flag), rtol=1e-5, atol=1e-5)


def test_collection_priorities_match_jax():
    rewards, values, lengths, terminated = random_trajectory_arrays(5)
    jcfg = jconfig.tiny_config()
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    ref = jsp.collection_priorities(
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(lengths), jcfg, jnp.asarray(terminated)
    )
    t = torch.from_numpy
    got = tsp.collection_priorities(t(rewards), t(values), t(lengths), tcfg, t(terminated))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _policy_output(weights: np.ndarray) -> PolicyOutput:
    w = torch.from_numpy(weights.astype(np.float32))
    return PolicyOutput(w, torch.zeros(len(w)), (w * 100).to(torch.int32), torch.zeros_like(w))


def test_sample_from_visits_semantics():
    """Argmax below temperature 0.01; else the categorical over
    log(w + 1e-8) / T, drawn by inverting the cumulative distribution at the
    uniforms given (so a test can feed the draws)."""
    weights = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1], [0.25, 0.25, 0.5, 0.0]])
    legal = torch.tensor([[True] * 4, [False, True, True, True], [True] * 4])
    out = _policy_output(weights)
    greedy = sample_from_visits(out, legal, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), [3, 1, 2])
    temps = torch.tensor([1.0, 0.001, 0.5])
    uniform = torch.tensor([0.35, 0.99, 0.2])
    got = sample_from_visits(out, legal, temps, uniform=uniform)
    # row 0: cdf .1 .3 .6 1 -> u=.35 -> 2; row 1: greedy over legal -> 1;
    # row 2: T=.5 squares the weights: .0625 .0625 .25 -> cdf 1/6 1/3 1 -> u=.2 -> 1
    np.testing.assert_array_equal(got.numpy(), [2, 1, 1])
    ref = jax.vmap(
        lambda w, m: jnp.argmax(jnp.where(m, w, 0.0))
    )(jnp.asarray(weights), jnp.asarray(legal.numpy()))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref))


def test_sample_from_visits_distribution():
    weights = np.tile(np.array([[0.1, 0.2, 0.3, 0.4]]), (20000, 1))
    legal = torch.ones(20000, 4, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    got = sample_from_visits(_policy_output(weights), legal, 1.0, gen)
    freq = np.bincount(got.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.015)
    illegal = legal.clone()
    illegal[:, 3] = False
    got = select_action(_policy_output(weights), illegal, 1.0, gen)
    assert int(got.max()) == 2  # an illegal action is never drawn
    assert (sample_from_visits(_policy_output(weights), illegal, 1.0, gen) < 3).all()


def test_play_segment_sampling_paths():
    """Non-greedy play: with no root noise and a move cutoff of 0 the sampled
    path plays the greedy games; at temperature 1 with fed uniforms and noise
    the segment is valid and reproducible."""
    _, tcfg, _, tnet = make_pair()
    quiet = dataclasses.replace(tcfg, dirichlet_fraction=0.0, temperature_move_cutoff=0)
    state = tenv.reset_batch(5, 3, "cpu")
    _, greedy, _ = tsp.play_segment(tnet, state, None, 0.0, quiet, 3, True)
    _, sampled, _ = tsp.play_segment(tnet, state, torch.Generator().manual_seed(0), 1.0, quiet, 3, False)
    np.testing.assert_array_equal(sampled.boards.numpy(), greedy.boards.numpy())
    np.testing.assert_array_equal(sampled.actions.numpy(), greedy.actions.numpy())

    t = tcfg.max_trajectory_length
    rs = np.random.RandomState(0)
    noise = torch.from_numpy(rs.dirichlet([0.25] * 4, size=(t, 3)).astype(np.float32))
    uniform = torch.from_numpy(rs.rand(t, 3).astype(np.float32))
    a = tsp.play_segment(tnet, state, None, 1.0, tcfg, 3, False, noise=noise, uniform=uniform)[1]
    b = tsp.play_segment(tnet, state, None, 1.0, tcfg, 3, False, noise=noise, uniform=uniform)[1]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    active = torch.arange(t)[None] < a.length[:, None]
    np.testing.assert_allclose(a.policies.sum(-1).numpy(), active.float().numpy(), atol=1e-5)
    drawn = tsp.play_segment(tnet, state, torch.Generator().manual_seed(3), 1.0, tcfg, 3, False)[1]
    assert drawn.boards.shape == (3, t + 1, 16) and drawn.boards.dtype == torch.int8


def test_generate_games_td_lambda_targets():
    """With value_target_mode="td_lambda" the stored values are the TD(λ)
    returns of the search values; the fresh-episode form returns a trajectory only."""
    _, tcfg, _, tnet = make_pair()
    cfg = dataclasses.replace(tcfg, value_target_mode="td_lambda", td_lambda=1.0, dirichlet_fraction=0.0,
                              temperature_move_cutoff=0, num_parallel_games=3)
    state = tenv.reset_batch(5, 3, "cpu")
    gen = torch.Generator().manual_seed(0)
    next_state, traj, stats = tsp.generate_games(tnet, gen, cfg, training_step=0, env_state=state)
    _, raw, _ = tsp.play_segment(tnet, state, None, 0.0, dataclasses.replace(cfg, value_target_mode="search"), 3, True)
    expect = tsp.compute_n_step_returns(raw.rewards, raw.values, raw.length, cfg, raw.terminated)
    np.testing.assert_allclose(traj.values.numpy(), expect.numpy(), rtol=1e-6)
    np.testing.assert_allclose(stats.first_search_value.numpy(), raw.values[:, 0].numpy(), rtol=1e-6)
    record = tsp.finish_gen_stats(stats, traj)
    assert record["gen/positions"] == int(traj.length.sum()) and np.isfinite(list(record.values())).all()
    fresh = tsp.generate_games(tnet, gen, cfg, training_step=0, num_games=2)
    assert fresh.boards.shape[0] == 2 and next_state.board.shape == (3, 4, 4)

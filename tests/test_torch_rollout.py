"""The rollout path of the PyTorch port vs the JAX package, on the CPU.

The same seeds go through both. ``step_auto_reset`` must agree field for
field on a batch that holds finished games. The plain version of the rollout
kernel (``random_rollout_reference``) is held against the JAX package's
Pallas kernel in interpret mode, as ``tests/test_pallas.py`` runs it: boards,
episodes finished, reward sums and max tiles must be equal (everything is
integer arithmetic; the float32 reward sums add small integers in step
order), at that test's own size and at a size where games end, so that the
reset branch is compared too. ``random_rollout`` is held against the JAX
``random_rollout``: integer statistics equal, ``total_reward`` (a float32 sum
over the batch, whose order differs) to rtol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_self_play import NEARLY_DEAD

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.ops import rng as jrng
from simulate_2048_tpu.ops import rollout as jrollout
from simulate_2048_tpu.ops.pallas_rollout import ACTION_STREAM, pallas_random_rollout
from simulate_2048_tpu_torch import bench
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.ops import rng as trng
from simulate_2048_tpu_torch.ops import rollout as trollout
from simulate_2048_tpu_torch.ops import rollout_kernel as rk

torch.set_num_threads(1)


def both_seeds(run_seed: int, b: int):
    jseeds = jrng.derive_game_seeds(jnp.uint32(run_seed), jnp.arange(b, dtype=jnp.uint32), jnp.zeros(b, jnp.uint32))
    index = torch.arange(b, dtype=torch.int64)
    tseeds = trng.derive_game_seeds(run_seed, index, torch.zeros_like(index))
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds).astype(np.int64))
    return jseeds, tseeds


def assert_states_equal(tstate, jstate):
    for name, t, j in zip(tstate._fields, tstate, jstate):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype), err_msg=name)


def test_step_auto_reset_matches_jax_with_finished_games():
    """Lanes 0-2 start one move from the end and end on the move right; a second
    step then plays their fresh games, with their episode index at 1."""
    b = 6
    jstate, tstate = jenv.reset_batch(jnp.uint32(11), b), tenv.reset_batch(11, b, "cpu")
    jstate = jstate._replace(board=jstate.board.at[:3].set(jnp.asarray(NEARLY_DEAD)))
    tstate.board[:3] = torch.from_numpy(NEARLY_DEAD)
    for actions in ([2, 2, 2, 1, 2, 3], [1, 2, 3, 0, 0, 1]):
        jstate, jreward, jdone, jinfo = jenv.step_auto_reset(jstate, jnp.asarray(actions, jnp.int32))
        tstate, treward, tdone, tinfo = tenv.step_auto_reset(tstate, torch.tensor(actions))
        assert_states_equal(tstate, jstate)
        np.testing.assert_array_equal(treward.numpy(), np.asarray(jreward))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for key in ("max_tile", "num_empty", "moved", "step_count"):
            np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]), err_msg=key)
        if actions[0] == 2:
            assert tdone.tolist() == [True] * 3 + [False] * 3  # the flag before the reset
            assert not bool(tstate.done.any()) and tstate.episode_index.tolist() == [1] * 3 + [0] * 3
            assert tstate.spawn_count[:3].tolist() == [2, 2, 2] and tstate.step_count[:3].tolist() == [0, 0, 0]
            assert int(tinfo["max_tile"][0]) == 1024  # of the board that ended, not of the fresh one


@pytest.mark.parametrize("steps,games_end", [(24, False), (320, True)], ids=["jax_test_size", "games_end"])
def test_rollout_reference_matches_pallas_kernel_in_interpret_mode(steps, games_end):
    b = 128
    jseeds, tseeds = both_seeds(7, b)
    kb, ke, kr, km = pallas_random_rollout(jseeds, steps, block_b=128, interpret=True)
    boards, episodes, reward_sum, max_tile = rk.random_rollout_reference(tseeds, steps)
    assert (int(episodes.sum()) > 0) == games_end
    assert boards.dtype == torch.int32 and boards.shape == (b, 4, 4) and reward_sum.dtype == torch.float32
    np.testing.assert_array_equal(boards.numpy(), np.asarray(kb))
    np.testing.assert_array_equal(episodes.numpy(), np.asarray(ke))
    np.testing.assert_array_equal(reward_sum.numpy(), np.asarray(kr))
    np.testing.assert_array_equal(max_tile.numpy(), np.asarray(km))
    if games_end:
        # A finding about the reference, not about the port: the JAX package's
        # own stepwise replica of the kernel (tests/test_pallas.py) takes the
        # largest tile after the reset, the kernel before it. They agree on
        # boards, episodes and rewards, and part on the largest tile where a
        # game's last move made it (board 25 of these seeds, at step 171).
        from test_pallas import xla_reference_rollout

        xb, xe, xr, xm = xla_reference_rollout(jseeds, steps)
        np.testing.assert_array_equal(np.asarray(xb), np.asarray(kb))
        np.testing.assert_array_equal(np.asarray(xe), np.asarray(ke))
        after_reset = np.where(np.asarray(xm) > 0, 2 ** np.asarray(xm), 0)
        differ = np.flatnonzero(after_reset != np.asarray(km))
        assert 25 in differ and (after_reset[differ] < np.asarray(km)[differ]).all(), differ


def test_rollout_reference_of_no_steps():
    _, tseeds = both_seeds(3, 5)
    boards, episodes, reward_sum, max_tile = rk.random_rollout_reference(tseeds, 0)
    np.testing.assert_array_equal(boards.numpy(), tenv.reset(tseeds).board.numpy())
    assert not episodes.any() and not reward_sum.any() and not max_tile.any()  # 0 for an empty history


@pytest.mark.parametrize("num_envs,num_steps", [(32, 16), (48, 300)], ids=["short", "games_end"])
def test_random_rollout_matches_jax(num_envs, num_steps):
    ref = jrollout.random_rollout(jnp.uint32(42), num_envs, num_steps)
    got = trollout.random_rollout(42, num_envs, num_steps, "cpu")
    assert (int(got.episodes_finished) > 0) == (num_steps == 300)
    for name in ("episodes_finished", "max_tile", "steps"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    np.testing.assert_allclose(float(got.total_reward), float(ref.total_reward), rtol=1e-6)
    assert got.total_reward.dtype == torch.float32 and got.steps.dtype == torch.int32
    assert trollout.ACTION_STREAM == int(ACTION_STREAM)


def test_policy_rollout_with_fed_draws():
    """A fixed policy and fed uniforms: shapes, frozen finished games, legal actions, reproducible."""
    b, steps = 5, 6
    state = tenv.reset_batch(9, b, "cpu")
    state.board[:2] = torch.from_numpy(NEARLY_DEAD)  # right and down are their only moves; either ends them
    fixed = torch.tensor([0.4, 0.3, 0.2, 0.1])
    calls = []

    def policy_fn(obs, legal, generator):
        calls.append(obs.shape)
        return fixed.expand(obs.shape[0], 4)

    uniform = torch.from_numpy(np.random.RandomState(0).rand(steps, b).astype(np.float32))
    final, (obs, actions, rewards, dones, probs) = trollout.policy_rollout(state, policy_fn, steps, 1.0, None, uniform)
    assert len(calls) == steps and obs.shape == (steps, b, 16) and probs.shape == (steps, b, 4)
    assert actions.shape == rewards.shape == dones.shape == (steps, b)
    assert set(actions[0, :2].tolist()) <= {2, 3} and dones[:, :2].all() and bool(final.done[:2].all())
    assert not rewards[1:, :2].any() and int(final.step_count[0]) == 1  # done-masking: no reset, no reward
    replayed = tenv.reset_batch(9, b, "cpu")
    replayed.board[:2] = torch.from_numpy(NEARLY_DEAD)
    for t in range(steps):
        legal = tenv.get_legal_actions(replayed)
        chosen = legal.gather(-1, actions[t][:, None])[:, 0]
        assert bool((chosen | ~legal.any(-1)).all()), "an illegal action was drawn"
        replayed, _, _, _ = tenv.step(replayed, actions[t])
    np.testing.assert_array_equal(replayed.board.numpy(), final.board.numpy())
    again = trollout.policy_rollout(state, policy_fn, steps, 1.0, None, uniform)[1][1]
    np.testing.assert_array_equal(again.numpy(), actions.numpy())
    greedy = trollout.policy_rollout(state, policy_fn, 2, 0.0, torch.Generator().manual_seed(0))[1][1]
    assert greedy.shape == (2, b)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    _, tseeds = both_seeds(5, 8)
    before = dict(rk.LAUNCHES)
    for got, ref in zip(rk.rollout_kernel(tseeds, 12), rk.random_rollout_reference(tseeds, 12)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert rk.LAUNCHES == before == {"random_rollout": 0}  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rk.rollout_kernel(torch.empty(8, dtype=torch.int64, device="meta"), 12)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU behaviour is checked on CPU-only machines")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_bench_on_cpu_prints_one_json_line(capsys):
    result = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == {"metric", "value", "unit", "backend", "device", "power_limit_w", "num_envs", "num_steps",
                           "reps", "times_s", "kernel_ms", "torch", "cuda"}  # fmt: skip
    assert "vs_baseline" not in result and result["kernel_ms"] is None  # no kernel runs on the CPU
    assert result["metric"] == "env_steps_per_s_per_chip" and result["backend"] == "torch_loop"
    assert (result["num_envs"], result["num_steps"], result["reps"]) == (4096, 32, 5) and len(result["times_s"]) == 5
    assert result["value"] == pytest.approx(4096 * 32 / min(result["times_s"]), rel=1e-3)

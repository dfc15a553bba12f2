"""PyTorch port vs the JAX package: spawn RNG, board ops and environment,
bit-exact on identical inputs made from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.ops import board as jb
from simulate_2048_tpu.ops import rng as jrng
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.ops import board as tb
from simulate_2048_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def u32(x):
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64))


def same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype))


def random_boards(rs, n, fill=0.6, max_exp=11):
    cells = rs.randint(1, max_exp, size=(n, 4, 4)) * (rs.rand(n, 4, 4) < fill)
    return cells.astype(np.int32)


class TestRng:
    def test_threefry2x32(self):
        rs = np.random.RandomState(123)
        k0, k1, c0, c1 = (rs.randint(0, 2**32, size=256, dtype=np.uint32) for _ in range(4))
        t0, t1 = trng.threefry2x32((u32(k0), u32(k1)), (u32(c0), u32(c1)))
        j0, j1 = jrng.threefry2x32((jnp.asarray(k0), jnp.asarray(k1)), (jnp.asarray(c0), jnp.asarray(c1)))
        same(t0, j0)
        same(t1, j1)

    def test_spawn_bits(self):
        rs = np.random.RandomState(5)
        seeds = rs.randint(0, 2**32, size=100, dtype=np.uint32)
        idx = rs.randint(0, 5000, size=100).astype(np.uint32)
        t0, t1 = trng.spawn_bits(u32(seeds), u32(idx))
        j0, j1 = jrng.spawn_bits(jnp.asarray(seeds), jnp.asarray(idx))
        same(t0, j0)
        same(t1, j1)

    def test_derive_game_seeds(self):
        board_idx = np.arange(64, dtype=np.uint32)
        ep = np.random.RandomState(2).randint(0, 9, size=64).astype(np.uint32)
        t = trng.derive_game_seeds(42, u32(board_idx), u32(ep))
        j = jrng.derive_game_seeds(jnp.uint32(42), jnp.asarray(board_idx), jnp.asarray(ep))
        same(t, j)


class TestBoardOps:
    @pytest.fixture
    def boards(self):
        return random_boards(np.random.RandomState(0), 512)

    def test_slide_and_merge(self, boards):
        tn, ts = tb.slide_and_merge(torch.from_numpy(boards))
        jn, js = jb.slide_and_merge(jnp.asarray(boards))
        same(tn, jn)
        same(ts, js)

    def test_apply_action(self, boards):
        actions = np.random.RandomState(1).randint(0, 4, size=len(boards))
        tn, ts = tb.apply_action(torch.from_numpy(boards), torch.from_numpy(actions))
        jn, js = jb.apply_action(jnp.asarray(boards), jnp.asarray(actions))
        same(tn, jn)
        same(ts, js)

    def test_legal_done_empty_max(self, boards):
        full = random_boards(np.random.RandomState(3), 256, fill=1.1, max_exp=4)
        for b in (boards, full):
            t, j = torch.from_numpy(b), jnp.asarray(b)
            same(tb.legal_actions_mask(t), jb.legal_actions_mask(j))
            same(tb.is_done(t), jb.is_done(j))
            same(tb.count_empty(t), jb.count_empty(j))
            same(tb.max_tile(t), jb.max_tile(j))
            same(tb.encode_observation(t), jb.encode_observation(j))

    def test_spawn_rank_and_tile(self, boards):
        rs = np.random.RandomState(4)
        bits0 = rs.randint(0, 2**32, size=len(boards), dtype=np.uint32)
        bits1 = rs.randint(0, 2**32, size=len(boards), dtype=np.uint32)
        n = rs.randint(0, 17, size=len(boards)).astype(np.int32)
        same(tb.spawn_rank(u32(bits0), torch.from_numpy(n)), jb.spawn_rank(jnp.asarray(bits0), jnp.asarray(n)))
        t = tb.spawn_tile(torch.from_numpy(boards), u32(bits0), u32(bits1))
        same(t, jb.spawn_tile(jnp.asarray(boards), jnp.asarray(bits0), jnp.asarray(bits1)))

    def test_next_state_and_initial_board(self, boards):
        rs = np.random.RandomState(6)
        actions = rs.randint(0, 4, size=len(boards))
        bits0 = rs.randint(0, 2**32, size=len(boards), dtype=np.uint32)
        bits1 = rs.randint(0, 2**32, size=len(boards), dtype=np.uint32)
        t = tb.next_state(torch.from_numpy(boards), torch.from_numpy(actions), u32(bits0), u32(bits1))
        j = jb.next_state(jnp.asarray(boards), jnp.asarray(actions), jnp.asarray(bits0), jnp.asarray(bits1))
        for a, b in zip(t, j):
            same(a, b)
        seeds = rs.randint(0, 2**32, size=64, dtype=np.uint32)
        same(tb.create_initial_board(u32(seeds)), jb.create_initial_board(jnp.asarray(seeds)))


class TestEnv:
    def test_lockstep_rollout(self):
        """64 env steps of 32 games with random (often illegal) actions,
        including reset_done between halves, state field for field."""
        n, steps, run_seed = 32, 64, 1234
        actions = np.random.RandomState(run_seed).randint(0, 4, size=(steps, n))
        ts = tenv.reset_batch(run_seed, n, "cpu")
        js = jenv.reset_batch(run_seed, n)
        for t in range(steps):
            if t == steps // 2:
                ts, js = tenv.reset_done(ts), jenv.reset_done(js)
            ts, tr, td, tinfo = tenv.step(ts, torch.from_numpy(actions[t]))
            js, jr, jd, jinfo = jenv.step(js, jnp.asarray(actions[t]))
            same(tr, jr)
            same(td, jd)
            same(tinfo["moved"], jinfo["moved"])
            same(tenv.get_legal_actions(ts), jenv.get_legal_actions(js))
        for field in tenv.GameState._fields:
            same(getattr(ts, field), getattr(js, field))
        same(tenv.get_observation(ts), jenv.get_observation(js))
        assert bool(ts.done.any()), "the rollout should finish some games"


def test_afterstate_helpers_match_jax():
    """``latent_state`` (the afterstate), ``afterstate_outcomes`` (every spawn
    with its probability, slot 2·cell + is_four) and greedy ``sample_action``: exact."""
    rs = np.random.RandomState(8)
    boards = rs.randint(0, 4, size=(12, 4, 4)).astype(np.int32) * (rs.rand(12, 4, 4) < 0.6)
    boards[0] = np.arange(1, 17).reshape(4, 4)  # a full board: the input at slot 0 with probability 1
    actions = rs.randint(0, 4, size=12).astype(np.int32)
    t = torch.from_numpy
    ref_after = jb.latent_state(jnp.asarray(boards), jnp.asarray(actions))
    for got, ref in zip(tb.latent_state(t(boards), t(actions)), ref_after):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got_boards, got_probs = tb.afterstate_outcomes(t(boards))
    ref_boards, ref_probs = jb.afterstate_outcomes(jnp.asarray(boards))
    np.testing.assert_array_equal(got_boards.numpy(), np.asarray(ref_boards))
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(ref_probs), rtol=1e-6)
    policy = rs.dirichlet([1.0] * 4, size=12).astype(np.float32)
    policy[3] = 0.0  # nothing left after masking: uniform over the legal moves
    legal = rs.rand(12, 4) < 0.7
    legal[legal.sum(-1) == 0, 0] = True
    ref = jb.sample_action(jax.random.PRNGKey(0), 0.0, jnp.asarray(policy), jnp.asarray(legal))
    np.testing.assert_array_equal(tb.sample_action(None, 0.0, t(policy), t(legal)).numpy(), np.asarray(ref))
    drawn = tb.sample_action(torch.Generator().manual_seed(0), 1.0, t(policy), t(legal))
    assert legal[np.arange(12), drawn.numpy()].all(), "only legal actions are drawn"

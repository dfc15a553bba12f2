"""The port's host modules against the JAX package's, on the CPU: the scalar
NumPy engine (``engine/``, ``utils/encoding.py``) on the cases of
``tests/test_engine.py`` and ``tests/test_rng.py``, its Threefry bit for bit
the port's ``ops/rng.py`` and JAX's ``engine/rng.py``, a seed-exact lockstep
rollout of the port's engine against the port's batched ``ops/board.py``
(``tests/test_board_ops.py::TestSeedExactRollout``), the GUI headless (as
``tests/test_gui.py``), ``play``'s terminal REPL on fed input, and
``utils/profiling``.
"""

import builtins

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from simulate_2048_tpu import engine as jengine  # noqa: E402
from simulate_2048_tpu.engine import rng as jnprng  # noqa: E402
from simulate_2048_tpu.utils import encoding as jencoding  # noqa: E402
from simulate_2048_tpu_torch import engine  # noqa: E402
from simulate_2048_tpu_torch.engine import board as nb  # noqa: E402
from simulate_2048_tpu_torch.engine import rng as nprng  # noqa: E402
from simulate_2048_tpu_torch.ops import board as tb  # noqa: E402
from simulate_2048_tpu_torch.ops import rng as trng  # noqa: E402
from simulate_2048_tpu_torch.utils import encoding, profiling  # noqa: E402

BOARDS = [
    np.array([[2, 2, 0, 0], [4, 0, 4, 0], [2, 4, 2, 4], [0, 0, 0, 2]]),
    np.array([[2, 2, 0, 0], [0, 0, 0, 0], [0, 4, 4, 0], [2, 0, 0, 2]]),
    np.array([[2, 4, 2, 4], [4, 2, 4, 2], [2, 4, 2, 4], [2, 2, 4, 8]]),
    np.array([[2, 4, 2, 4], [4, 2, 4, 2], [2, 4, 2, 4], [4, 2, 4, 2]]),
    np.array([[2, 0, 4, 0], [0, 2, 0, 0], [8, 0, 0, 2], [0, 0, 2, 0]]),
    np.array([[16, 16, 16, 0], [2, 2, 2, 2], [0, 0, 0, 0], [4, 4, 8, 8]]),
    np.array([[2, 2, 2], [0, 0, 0], [0, 0, 0]]),
]


def test_public_names_match_jax():
    assert engine.__all__ == jengine.__all__


@pytest.mark.parametrize("column", [[2, 2, 0, 0], [2, 2, 2, 2], [2, 2, 2, 0], [2, 0, 0, 2], [2, 4, 8, 16], [0] * 4])
def test_merge_column_matches_jax(column):
    score, merged = engine.merge_column(np.array(column))
    ref_score, ref_merged = jengine.merge_column(np.array(column))
    assert score == ref_score and merged.tolist() == ref_merged.tolist()


@pytest.mark.parametrize("index", range(len(BOARDS)))
def test_board_functions_match_jax(index):
    board = BOARDS[index]
    for fn in ("slide_and_merge", "legal_actions_mask", "legal_actions", "illegal_actions", "is_done", "can_move"):
        got, ref = getattr(engine, fn)(board.copy()), getattr(jengine, fn)(board.copy())
        if fn == "slide_and_merge":
            assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
        else:
            assert got == ref, fn
    for action in range(4):
        (out, r), (ref_out, ref_r) = engine.latent_state(board, action), jengine.latent_state(board, action)
        assert r == ref_r and np.array_equal(out, ref_out)
        got, ref = engine.next_state(board.copy(), action, seed=7), jengine.next_state(board.copy(), action, seed=7)
        assert got[1] == ref[1] and np.array_equal(got[0], ref[0])
        if board.shape == (4, 4):
            seed, index = 12345 + action, 3
            got = nb.next_state_counter(board.copy(), action, seed, index)
            ref = jengine.board.next_state_counter(board.copy(), action, seed, index)
            assert got[1:] == ref[1:] and np.array_equal(got[0], ref[0])
    outcomes, ref_outcomes = engine.after_state(board), jengine.after_state(board)
    assert len(outcomes) == len(ref_outcomes)
    for (s, p), (rs, rp) in zip(outcomes, ref_outcomes):
        assert p == rp and np.array_equal(s, rs)
    base, cells, n = engine.after_state_lazy(board)
    assert (cells, n) == jengine.after_state_lazy(board)[1:]
    if n:
        assert engine.generate_outcome(base, cells[0], 4, n)[1] == jengine.generate_outcome(base, cells[0], 4, n)[1]
    with pytest.raises(ValueError):
        engine.generate_outcome(board, (0, 0), 2, 0)


def test_fill_cells_and_spawn_statistics():
    """The seeded convenience path draws what JAX's engine draws; the 90/10 split holds."""
    twos = 0
    for i in range(1000):
        board, ref = np.zeros((4, 4), np.int64), np.zeros((4, 4), np.int64)
        engine.fill_cells(board, 1, seed=i)
        jengine.fill_cells(ref, 1, seed=i)
        assert np.array_equal(board, ref)
        twos += board.max() == 2
    assert 0.85 <= twos / 1000 <= 0.95
    runs = []
    for _ in range(2):
        rng, board = np.random.default_rng(123), np.zeros((4, 4), np.int64)
        for _ in range(5):
            engine.fill_cells(board, 1, seed=999, rng=rng)
        runs.append(board.copy())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_env_class_matches_jax():
    """Seeded resets give JAX's boards; along a game of the port's env, the
    observation (raw, encoded), the reward (raw, normalised) and the end flag
    are JAX's on the same state, and each step's reward is the slide's."""
    for kwargs in (dict(), dict(encoded=True), dict(normalize=True), dict(size=6)):
        env, ref = engine.TwentyFortyEight(**kwargs), jengine.TwentyFortyEight(**kwargs)
        np.testing.assert_array_equal(env.reset(seed=5), ref.reset(seed=5))
        rng = np.random.default_rng(0)
        for _ in range(300):
            action = int(rng.integers(4))
            before = env._current_state.copy()
            obs, reward, done = env.step(action)
            ref._current_state, ref._current_reward = env._current_state.copy(), env._current_reward
            np.testing.assert_array_equal(obs, ref.observation)
            assert reward == ref.reward and done == ref.is_finished
            if not np.array_equal(before, env._current_state):
                assert env._current_reward == jengine.latent_state(before, action)[1]
            if done:
                break
    env = engine.TwentyFortyEight()
    env.reset(seed=5)
    rng = np.random.default_rng(0)
    for _ in range(5000):
        if env.step(int(rng.integers(4)))[2]:
            break
    assert env.is_finished and engine.ACTIONS == jengine.ACTIONS


def test_encoding_matches_jax():
    board = np.array([[0, 2, 4, 8], [16, 32, 64, 128], [256, 512, 1024, 2048], [4096, 1, 0, 2]])
    np.testing.assert_array_equal(encoding.encode(board.ravel(), 31), jencoding.encode(board.ravel(), 31))
    np.testing.assert_array_equal(encoding.encode_flatten(board, 31), jencoding.encode_flatten(board, 31))
    for reward in (0, 4, 2048, 131072):
        assert encoding.normalize_reward(reward) == jencoding.normalize_reward(reward)


def test_threefry_matches_ops_rng_and_jax_engine():
    rs = np.random.RandomState(123)
    k0, k1, c0, c1 = (rs.randint(0, 2**32, size=256, dtype=np.uint32) for _ in range(4))
    n0, n1 = nprng.threefry2x32_np((k0, k1), (c0, c1))
    j0, j1 = jnprng.threefry2x32_np((k0, k1), (c0, c1))
    t0, t1 = trng.threefry2x32(*((torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64)))
                                 for x, y in ((k0, k1), (c0, c1))))  # fmt: skip
    for got, ref, dev in ((n0, j0, t0), (n1, j1, t1)):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got.astype(np.int64), dev.numpy())
    seeds, idx = np.arange(100, dtype=np.uint32), np.full(100, 3, dtype=np.uint32)
    n0, n1 = nprng.spawn_bits_np(seeds, idx)
    t0, t1 = trng.spawn_bits(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(n0.astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(n1.astype(np.int64), t1.numpy())
    assert all(np.array_equal(a, b) for a, b in zip(jnprng.spawn_bits_np(seeds, idx), (n0, n1)))
    assert len(np.unique(n0)) == 100 and abs(int(nprng.FOUR_THRESHOLD) / 2**32 - 0.1) < 1e-9
    boards, ep = np.arange(64, dtype=np.uint32), np.zeros(64, dtype=np.uint32)
    n = nprng.derive_game_seeds_np(42, boards, ep)
    np.testing.assert_array_equal(n, jnprng.derive_game_seeds_np(42, boards, ep))
    t = trng.derive_game_seeds(42, torch.from_numpy(boards.astype(np.int64)), torch.from_numpy(ep.astype(np.int64)))
    np.testing.assert_array_equal(n.astype(np.int64), t.numpy())


def test_lockstep_rollout_engine_vs_ops_board():
    """Random-action games on the scalar engine (counter spawns) and on the
    port's batched ``ops/board.py`` fed by ``ops/rng.spawn_bits``: the same
    boards and rewards at every step, spawn counters advancing only on moves."""
    n_boards, n_steps, run_seed = 16, 400, 1234
    game_seeds = nprng.derive_game_seeds_np(run_seed, np.arange(n_boards), np.zeros(n_boards))
    oracle = [nb.create_initial_board_counter(int(s)) for s in game_seeds]
    spawn_counts = [2] * n_boards
    actions = np.random.RandomState(run_seed).randint(0, 4, size=(n_steps, n_boards))
    oracle_rewards = np.zeros((n_steps, n_boards))

    seeds = torch.from_numpy(game_seeds.astype(np.int64))
    boards = tb.create_initial_board(seeds)
    counts = torch.full((n_boards,), 2, dtype=torch.int64)
    done = tb.is_done(boards)
    rewards = torch.zeros(n_steps, n_boards)
    for t in range(n_steps):
        for i in range(n_boards):
            if nb.is_done(oracle[i]):
                continue
            oracle[i], oracle_rewards[t, i], moved = nb.next_state_counter(
                oracle[i], int(actions[t, i]), int(game_seeds[i]), spawn_counts[i]
            )
            spawn_counts[i] += moved
        b0, b1 = trng.spawn_bits(seeds, counts)
        nxt, reward, moved = tb.next_state(boards, torch.from_numpy(actions[t]), b0, b1)
        active = ~done
        boards = torch.where(active[:, None, None], nxt, boards)
        rewards[t] = torch.where(active, reward, torch.zeros_like(reward))
        counts = counts + (moved & active).to(torch.int64)
        done = done | tb.is_done(boards)
    np.testing.assert_allclose(rewards.numpy(), oracle_rewards)
    for i in range(n_boards):
        np.testing.assert_array_equal(tb.exponents_to_values(boards[i]).numpy(), oracle[i])
    assert bool(done.any())  # games ended, so the done lanes were held still


def test_window_board_renders_and_handles_keys():
    from simulate_2048_tpu.gui import TILE_COLORS as JAX_TILE_COLORS
    from simulate_2048_tpu_torch.gui import TILE_COLORS, WindowBoard

    window = WindowBoard(title="test", size=4)
    board = np.array([[0, 2, 4, 8], [16, 32, 64, 128], [256, 512, 1024, 2048], [4096, 0, 0, 2]])
    window.show_image(board)  # includes a >2048 tile (fallback color)
    assert not window.closed and len(window.ax.texts) == 13
    window.register_key_handler(lambda e: None)
    window.close()
    assert window.closed and TILE_COLORS == JAX_TILE_COLORS


def test_play_terminal_repl(monkeypatch, capsys):
    """The terminal REPL on fed input: moves, an unknown key, a reset, quit."""
    from simulate_2048_tpu_torch import play

    commands = iter(["a", "w", "nonsense", "d", "r", "s", "q"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(commands))
    play.play_terminal()
    out = capsys.readouterr().out
    assert out.count("reward=") == 4 and out.startswith("moves:")
    assert play.KEY_TO_ACTION == {"left": 0, "up": 1, "right": 2, "down": 3, "a": 0, "w": 1, "d": 2, "s": 3}
    monkeypatch.setattr(builtins, "input", lambda prompt="": (_ for _ in ()).throw(EOFError))
    play.play_terminal()  # end of input ends the game
    monkeypatch.setattr("sys.argv", ["play", "--terminal"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": "quit")
    play.main()


def test_profiling_time_fn_and_trace(tmp_path):
    calls = []
    stats = profiling.time_fn(lambda: calls.append(torch.ones(64).sum()), warmup=2, reps=3)
    assert set(stats) == {"compile_plus_first_ms", "best_ms", "median_ms", "mean_ms"}
    assert len(calls) == 5 and stats["best_ms"] <= stats["median_ms"] and all(v >= 0 for v in stats.values())
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(128, 128) @ torch.ones(128, 128)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json" and files[0].stat().st_size > 0

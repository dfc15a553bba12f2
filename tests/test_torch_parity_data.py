"""Stage 2 of the training path's parity bisection: the data path over
several generations, the port against the JAX package, on the CPU.

The JAX package plays four consecutive segments of the same eight games
(sampled at temperature 1 with root noise, TD(λ=1) targets): three lanes
start one move from their end, so they end in the first segment and
restart, and the rest cross every segment boundary. Both packages ingest
the same segments (``ingest_segment``, with cross-segment backfill) into a
buffer that wraps. After every ingest the buffers agree: the stored values
and priorities within one bfloat16 unit (2^-8 relative; ``backfill_returns``
takes (γλ)^n through another ``pow`` in each package, as
``test_torch_replay.py`` holds it), everything else bit for bit, and so does
the bookkeeping of the previous segment. ``sample_batch``'s windows, drawn
by the JAX package and gathered by the port, agree field for field (values
within one bfloat16 unit), importance weights within rtol 1e-4, windows that
run past a game's end included (value 0 and a uniform policy there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_parity_learner import SCALAR_RECIPE, to_torch
from test_torch_replay import as_f32
from test_torch_self_play import NEARLY_DEAD, make_pair

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu.training import trainer as jtrainer
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)


def jax_segments(n: int, games: int = 8, dying: int = 3, **overrides):
    """``n`` consecutive sampled segments of the same JAX games (root noise
    on, temperature 1, TD(λ) targets): the first ``dying`` lanes start one
    move from their end, so they end in the first segment and restart."""
    jcfg, tcfg, jnet, _ = make_pair(
        hidden_size=16, max_trajectory_length=12, num_parallel_games=games, replay_buffer_size=24,
        num_unroll_steps=3, batch_size=64, **SCALAR_RECIPE, **overrides,
    )
    state = jenv.reset_batch(jnp.uint32(11), games)
    state = state._replace(board=state.board.at[:dying].set(jnp.asarray(NEARLY_DEAD)))
    out = []
    for i in range(n):
        state, traj, stats = jsp.generate_games(
            jnet.params, jnet.apply_fns, jax.random.PRNGKey(100 + i), jcfg, 0, env_state=state
        )
        out.append((traj, stats.first_search_value))
    return jcfg, tcfg, out


def test_ingest_consecutive_segments_matches_jax():
    jcfg, tcfg, segments = jax_segments(4)
    jbuf, tbuf = jreplay.init_buffer(jcfg), treplay.init_buffer(tcfg)
    jprev = tprev = None
    crossed = ended = 0
    for traj, nu0 in segments:
        ended += int(np.asarray(traj.terminated).sum())
        crossed += int((~np.asarray(traj.terminated)).sum())
        jbuf, jprev = jtrainer.ingest_segment(jbuf, jprev, traj, nu0, jcfg)
        tbuf, tprev = ttrainer.ingest_segment(tbuf, tprev, to_torch(traj._asdict()), torch.from_numpy(np.array(nu0)), tcfg)
        for name in treplay.BufferState._fields:
            got, want = as_f32(getattr(tbuf, name)), as_f32(getattr(jbuf, name))
            if name in ("values", "step_priorities"):
                np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
        for a, b in zip(tprev, jprev):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ended >= 3 and crossed >= 8, "games end inside a segment and cross its boundary"
    assert int(tbuf.size) == 24 and int(tbuf.episodes_added) == 32, "the circular buffer wrapped"


def test_sample_batch_windows_match_jax_past_game_end():
    jcfg, tcfg, segments = jax_segments(2)
    jbuf, tbuf = jreplay.init_buffer(jcfg), treplay.init_buffer(tcfg)
    jprev = tprev = None
    for traj, nu0 in segments:
        jbuf, jprev = jtrainer.ingest_segment(jbuf, jprev, traj, nu0, jcfg)
        tbuf, tprev = ttrainer.ingest_segment(tbuf, tprev, to_torch(traj._asdict()), torch.from_numpy(np.array(nu0)), tcfg)
    past_end = 0
    for seed in range(4):
        jbatch, jidx, jw = jreplay.sample_batch(jbuf, jax.random.PRNGKey(seed), jcfg.batch_size, jcfg)
        tbatch, tw = treplay.gather_batch(tbuf, torch.from_numpy(np.array(jidx)), tcfg)
        for name in tbatch._fields:
            got, want = getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name))
            if name == "target_values":
                np.testing.assert_allclose(got, want, rtol=2.0**-8, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4)
        idx = np.asarray(jidx)
        lengths = np.asarray(jbuf.length)[idx[:, 0]]
        past_end += int((idx[:, 1] + jcfg.num_unroll_steps >= lengths).sum())
        beyond = np.arange(jcfg.num_unroll_steps + 1)[None] + idx[:, 1:2] >= lengths[:, None]
        assert (tbatch.target_values.numpy()[beyond] == 0).all()
        np.testing.assert_array_equal(tbatch.target_policies.numpy()[beyond], 0.25)
    assert past_end > 0, "some windows run past a game's end"

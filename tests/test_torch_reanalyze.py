"""Reanalyze of the PyTorch port vs the JAX package, on the CPU.

Both buffers are filled with the same numpy-seeded trajectories and both
networks hold the same weights (Flax params converted by ``convert.py``,
categorical heads perturbed so that the search does not compare float noise).
After ``reanalyze_slots`` on both sides:

- ``values`` and ``step_priorities`` (bfloat16 in the buffer) agree within
  one bfloat16 unit in the last place (2^-7 relative at worst): the float32
  network outputs and sums behind them differ in their last bits, and the
  storage rounding can turn that into one step. Most entries are equal.
- ``policies`` (float16 in the buffer) are equal in search mode with the root
  noise off: the visit counts are identical, and the targets are their
  normalised logarithms.
- Rows at or beyond ``buffer.size`` and, in value mode, ``policies`` are
  exactly what they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_replay import as_f32
from test_torch_self_play import make_pair

from simulate_2048_tpu.training import reanalyze as jreanalyze
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu_torch.training import reanalyze as treanalyze
from simulate_2048_tpu_torch.training import replay as treplay

torch.set_num_threads(1)

T = 10
BF16_ULP = 2.0**-7
BASE = dict(max_trajectory_length=T, replay_buffer_size=16, value_target_mode="td_lambda", reanalyze_episodes=4)


def both_buffers(jcfg, tcfg, batch: int = 6, seed: int = 0):
    """The same episodes in both buffers: full boards of small tiles (every
    position has a legal move), lengths T, T, 6, T, 3, T and alternating
    terminated / truncated ends."""
    rs = np.random.RandomState(seed)
    lengths = np.array([T, T, 6, T, 3, T, T, 5][:batch], dtype=np.int32)
    mask = np.arange(T)[None] < lengths[:, None]
    arrays = dict(
        boards=rs.randint(1, 6, (batch, T + 1, 16)).astype(np.int8),
        actions=(rs.randint(0, 4, (batch, T)) * mask).astype(np.int8),
        rewards=(rs.rand(batch, T) * 4 * mask).astype(np.float32),
        policies=np.full((batch, T, 4), 0.25, np.float32) * mask[..., None],
        values=(rs.rand(batch, T) * 10 * mask).astype(np.float32),
        priorities=np.ones((batch, T), np.float32) * mask,
        length=lengths,
        terminated=np.arange(batch) % 2 == 0,
        total_reward=rs.rand(batch).astype(np.float32),
        max_tile=np.full(batch, 64, np.int32),
    )
    ttraj = treplay.Trajectory(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jbuf = None  # a port-only test passes no JAX config
    if jcfg is not None:
        jtraj = jreplay.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jbuf = jreplay.add_trajectories(jreplay.init_buffer(jcfg), jtraj)
    tbuf = treplay.add_trajectories(treplay.init_buffer(tcfg), ttraj)
    return jbuf, tbuf, lengths


def snapshot(tbuf) -> dict[str, np.ndarray]:
    return {name: as_f32(getattr(tbuf, name)).copy() for name in tbuf._fields}


def assert_targets_close(jbuf, tbuf):
    for name in ("values", "step_priorities"):
        got, ref = as_f32(getattr(tbuf, name)), as_f32(getattr(jbuf, name))
        np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-5, err_msg=name)
        assert (got == ref).mean() >= 0.9, f"{name}: fewer than 9 in 10 stored targets are bit-equal"


@pytest.mark.parametrize("lam", [1.0, 0.5])
def test_value_mode_matches_jax(lam):
    jcfg, tcfg, jnet, tnet = make_pair(td_lambda=lam, **BASE)
    jbuf, tbuf, lengths = both_buffers(jcfg, tcfg)
    before = snapshot(tbuf)
    slots = [0, 1, 2, 3, 4, 5, 9, 12]  # 9 and 12 were never written
    jout = jreanalyze.reanalyze_slots(jbuf, jnet.params, jnet.apply_fns, jnp.asarray(slots, jnp.int32), jcfg)
    tout = treanalyze.reanalyze_slots(tbuf, tnet, torch.tensor(slots), tcfg)
    assert tout is tbuf  # in place
    assert_targets_close(jout, tout)
    after = snapshot(tout)
    for name in after:
        if name not in ("values", "step_priorities"):
            np.testing.assert_array_equal(after[name], before[name], err_msg=name)  # policies untouched too
        if after[name].ndim:
            np.testing.assert_array_equal(after[name][6:], before[name][6:], err_msg=name)  # unoccupied rows
    assert not np.array_equal(after["values"][:6], before["values"][:6])
    in_ep = np.arange(T)[None] < lengths[:6, None]
    assert (after["step_priorities"][:6][in_ep] >= 1e-3).all() and not after["step_priorities"][:6][~in_ep].any()
    assert not after["values"][:6][~in_ep].any()
    assert tout.values.dtype == treplay.VALUE_DTYPE and tout.step_priorities.dtype == treplay.PRIORITY_DTYPE


def test_value_mode_search_targets_store_fresh_values():
    """value_target_mode="search": the fresh values themselves are stored, so
    every priority inside an episode is the floor."""
    jcfg, tcfg, jnet, tnet = make_pair(**{**BASE, "value_target_mode": "search"})
    jbuf, tbuf, lengths = both_buffers(jcfg, tcfg)
    slots = list(range(6))
    jout = jreanalyze.reanalyze_slots(jbuf, jnet.params, jnet.apply_fns, jnp.asarray(slots, jnp.int32), jcfg)
    tout = treanalyze.reanalyze_slots(tbuf, tnet, torch.tensor(slots), tcfg)
    assert_targets_close(jout, tout)
    in_ep = np.arange(T)[None] < lengths[:, None]
    np.testing.assert_array_equal(as_f32(tout.step_priorities)[:6][in_ep], as_f32(torch.tensor(1e-3).bfloat16()))


SEARCH = dict(reanalyze_mode="search", dirichlet_fraction=0.0, td_lambda=1.0, **BASE)
CALIBRATED = dict(reanalyze_num_simulations=6, reanalyze_prior_temperature=4.0, reanalyze_pb_c_init=0.5)


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(value_bins=16, reward_bins=8), CALIBRATED],
    ids=["scalar", "categorical", "calibrated"],
)
def test_search_mode_matches_jax(overrides):
    jcfg, tcfg, jnet, tnet = make_pair(**SEARCH, **overrides)
    jbuf, tbuf, lengths = both_buffers(jcfg, tcfg)
    before = snapshot(tbuf)
    slots = [0, 1, 2, 4, 11]  # 11 was never written
    jout = jreanalyze.reanalyze_slots(
        jbuf, jnet.params, jnet.apply_fns, jnp.asarray(slots, jnp.int32), jcfg, jax.random.PRNGKey(3)
    )
    tout = treanalyze.reanalyze_slots(tbuf, tnet, torch.tensor(slots), tcfg)
    got, ref = as_f32(tout.policies), as_f32(jout.policies)
    np.testing.assert_array_equal(got, ref)
    assert tout.policies.dtype == treplay.POLICY_DTYPE
    assert_targets_close(jout, tout)
    in_ep = np.arange(T)[None] < lengths[:, None]
    rows = [0, 1, 2, 4]
    np.testing.assert_allclose(got[rows].sum(-1), in_ep[rows].astype(np.float32), atol=2e-3)  # float16 thirds
    assert not np.allclose(got[rows][in_ep[rows]], 0.25, atol=1e-3)
    for name, was in before.items():  # rows not asked for, and the unoccupied one
        now = as_f32(getattr(tout, name))
        np.testing.assert_array_equal(now[[3, 5, 11]] if was.ndim else now, was[[3, 5, 11]] if was.ndim else was, name)
    if overrides is CALIBRATED:
        # The three overrides reach the search: the same rows under the training search get other targets.
        plain_cfg = dataclasses.replace(tcfg, reanalyze_num_simulations=None, reanalyze_prior_temperature=None,
                                        reanalyze_pb_c_init=None)  # fmt: skip
        _, tbuf2, _ = both_buffers(jcfg, tcfg)
        plain = treanalyze.reanalyze_slots(tbuf2, tnet, torch.tensor(slots), plain_cfg)
        assert not np.allclose(as_f32(plain.policies)[rows], got[rows])


def test_search_mode_noise_and_batches(monkeypatch):
    """Root noise is an input or comes from the generator; the searches of a
    pass may be cut into batches of any size without changing a target."""
    _, tcfg, _, tnet = make_pair(**{**SEARCH, "dirichlet_fraction": 0.25})
    slots = torch.arange(4)
    noise = torch.from_numpy(np.random.RandomState(1).dirichlet([0.25] * 4, size=4 * T).astype(np.float32))

    def run(**kwargs):
        _, tbuf, _ = both_buffers(None, tcfg)
        return snapshot(treanalyze.reanalyze_slots(tbuf, tnet, slots, tcfg, **kwargs))

    fed = run(noise=noise)
    monkeypatch.setattr(treanalyze, "SEARCH_BATCH", 7)
    assert treanalyze.search_batches(4 * T) == 6 and treanalyze.search_batches(7) == 1
    sliced = run(noise=noise)
    for name in fed:
        np.testing.assert_array_equal(sliced[name], fed[name], err_msg=name)
    quiet = run(noise=torch.full_like(noise, 0.25))
    assert not np.array_equal(quiet["policies"], fed["policies"])
    drawn = run(generator=torch.Generator().manual_seed(5))
    again = run(generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(drawn["policies"], again["policies"])
    assert not np.array_equal(drawn["policies"], fed["policies"])
    with pytest.raises(ValueError, match="`noise` or a `generator`"):
        run()  # root noise asked for and no source of it: no hidden fixed seed


def test_reanalyze_pass_cursor_wraps_over_the_occupied_region():
    jcfg, tcfg, jnet, tnet = make_pair(td_lambda=0.5, **BASE)
    jbuf, tbuf, _ = both_buffers(jcfg, tcfg)
    jcur = tcur = 0
    for expect in (4, 2, 0):  # (0 + 4) % 6, (4 + 4) % 6, (2 + 4) % 6
        jbuf, jcur = jreanalyze.reanalyze_pass(jbuf, jnet.params, jnet.apply_fns, jcur, jcfg)
        tbuf, tcur = treanalyze.reanalyze_pass(tbuf, tnet, tcur, tcfg)
        assert tcur == jcur == expect
    assert_targets_close(jbuf, tbuf)
    few = dataclasses.replace(tcfg, reanalyze_episodes=64)  # more than the buffer holds: one round, cursor home
    tbuf, tcur = treanalyze.reanalyze_pass(tbuf, tnet, 3, few)
    assert tcur == 3
    empty = treplay.init_buffer(tcfg)
    out, cur = treanalyze.reanalyze_pass(empty, tnet, 0, tcfg)
    assert cur == 0 and out is empty and not out.values.any()

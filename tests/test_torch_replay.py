"""Replay buffer of the PyTorch port vs the JAX package, on the CPU.

Both buffers are fed the same numpy-seeded trajectories. Stored fields must
be bit-identical, the compressed ones included (policies float16, values /
rewards / priorities bfloat16, compared through float32): the storage
rounding is part of the result. The port's ``sample_batch`` is a draw of
(episode, start) followed by ``gather_batch``, a pure function of the
indices; the test feeds it the indices the JAX ``sample_batch`` drew.
Gathered targets must be identical, importance weights within rtol 1e-5.
``backfill_returns`` computes (γλ)^n in float32 on both sides but through
different ``pow`` implementations, so its outputs are held to one bfloat16
unit in the last place (2^-8 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import replay as treplay

torch.set_num_threads(1)

CAP, T, BATCH = 10, 12, 4


def configs(**overrides):
    jcfg = dataclasses.replace(
        jconfig.tiny_config(), replay_buffer_size=CAP, max_trajectory_length=T, num_unroll_steps=3, **overrides
    )
    return jcfg, tconfig.TrainConfig(**dataclasses.asdict(jcfg))


def random_trajectory(seed: int, b: int = BATCH) -> dict[str, np.ndarray]:
    rs = np.random.RandomState(seed)
    length = rs.randint(1, T + 1, size=b).astype(np.int32)
    length[0] = T
    mask = np.arange(T)[None] < length[:, None]
    policies = rs.dirichlet([0.5] * 4, size=(b, T)).astype(np.float32) * mask[..., None]
    return dict(
        boards=rs.randint(0, 12, size=(b, T + 1, 16)).astype(np.int8),
        actions=(rs.randint(0, 4, size=(b, T)) * mask).astype(np.int8),
        rewards=(rs.rand(b, T) * 500 * mask).astype(np.float32),
        policies=policies,
        values=(rs.rand(b, T) * 30000 * mask).astype(np.float32),
        priorities=(rs.rand(b, T) * 3 * mask).astype(np.float32),
        length=length,
        terminated=rs.rand(b) < 0.5,
        total_reward=(rs.rand(b) * 1000).astype(np.float32),
        max_tile=(2 ** rs.randint(1, 11, size=b)).astype(np.int32),
    )


def both_trajectories(seed: int):
    arrays = random_trajectory(seed)
    jtraj = jreplay.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ttraj = treplay.Trajectory(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jtraj, ttraj


def filled(n_batches: int, jcfg, tcfg):
    jbuf, tbuf = jreplay.init_buffer(jcfg), treplay.init_buffer(tcfg)
    for i in range(n_batches):
        jtraj, ttraj = both_trajectories(100 + i)
        jbuf = jreplay.add_trajectories(jbuf, jtraj)
        tbuf = treplay.add_trajectories(tbuf, ttraj)
    return jbuf, tbuf


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype in (torch.bfloat16, torch.float16) else x.numpy()
    x = np.asarray(x.astype(jnp.float32) if x.dtype in (jnp.bfloat16, jnp.float16) else x)
    return x


def assert_buffers_equal(jbuf, tbuf):
    for name in treplay.BufferState._fields:
        j, t = getattr(jbuf, name), getattr(tbuf, name)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), name
        np.testing.assert_array_equal(as_f32(t), as_f32(j), err_msg=name)


@pytest.mark.parametrize("n_batches", [1, 2, 3], ids=["partial", "nearly_full", "wrapped"])
def test_add_trajectories_matches_jax(n_batches):
    """Circular insert with its storage rounding; 3 batches of 4 wrap a capacity of 10."""
    jbuf, tbuf = filled(n_batches, *configs())
    assert_buffers_equal(jbuf, tbuf)
    assert treplay.is_ready(tbuf, 4) and not treplay.is_ready(tbuf, CAP + 1)
    jstats, tstats = jreplay.get_statistics(jbuf), treplay.get_statistics(tbuf)
    assert tstats.keys() == jstats.keys()
    for key in jstats:
        np.testing.assert_allclose(tstats[key], jstats[key], rtol=1e-6, err_msg=key)


def test_add_trajectories_checks_shapes():
    _, tcfg = configs()
    _, ttraj = both_trajectories(0)
    with pytest.raises(ValueError, match="boards"):
        treplay.add_trajectories(treplay.init_buffer(tcfg), ttraj._replace(boards=ttraj.boards[:, :-1]))
    with pytest.raises(ValueError, match="int8"):
        treplay.add_trajectories(treplay.init_buffer(tcfg), ttraj._replace(boards=ttraj.boards.to(torch.int32)))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_sampling_weights_match_jax(alpha):
    jcfg, tcfg = configs(priority_alpha=alpha)
    jbuf, tbuf = filled(2, jcfg, tcfg)
    ref = np.asarray(jreplay._sampling_weights(jbuf, jcfg))
    got = treplay._sampling_weights(tbuf, tcfg).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.6, 0.4)])
def test_gather_batch_matches_jax_sample(alpha, beta):
    """The JAX package draws the indices; the port gathers the same windows and weights."""
    jcfg, tcfg = configs(priority_alpha=alpha, priority_beta=beta)
    jbuf, tbuf = filled(3, jcfg, tcfg)
    jtargets, jidx, jweights = jreplay.sample_batch(jbuf, jax.random.PRNGKey(5), 64, jcfg)
    ttargets, tweights = treplay.gather_batch(tbuf, torch.from_numpy(np.array(jidx)), tcfg)
    for name in ttargets._fields:
        got, ref = getattr(ttargets, name).numpy(), np.asarray(getattr(jtargets, name))
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    np.testing.assert_allclose(tweights.numpy(), np.asarray(jweights), rtol=1e-5)


def test_sample_batch_draws_valid_prioritised_starts():
    """The port's own draw: only sampleable positions, frequencies ∝ weights."""
    _, tcfg = configs()
    _, tbuf = filled(2, *configs())
    gen = torch.Generator().manual_seed(0)
    targets, indices, weights = treplay.sample_batch(tbuf, gen, 30000, tcfg)
    w = treplay._sampling_weights(tbuf, tcfg)
    assert (w[indices[:, 0], indices[:, 1]] > 0).all()
    assert targets.observations.shape == (30000, 4, 16) and weights.shape == (30000,)
    assert float(weights.max()) == 1.0
    counts = torch.zeros_like(w).index_put_((indices[:, 0], indices[:, 1]), torch.ones(30000), accumulate=True)
    np.testing.assert_allclose((counts / 30000).numpy(), (w / w.sum()).numpy(), atol=0.01)
    again = treplay.sample_indices(tbuf, torch.Generator().manual_seed(0), 30000, tcfg)
    np.testing.assert_array_equal(again.numpy(), indices.numpy())


@pytest.mark.parametrize("lam", [1.0, 0.5])
def test_backfill_returns_matches_jax(lam):
    jcfg, tcfg = configs(td_lambda=lam)
    jbuf, tbuf = filled(2, jcfg, tcfg)
    rs = np.random.RandomState(9)
    slots = np.array([4, 5, 6, 7], dtype=np.int32)
    cont = np.array([True, False, True, True])
    seq = np.array([4, 5, 6, -20], dtype=np.int32)  # the last row was overwritten long ago: not patched
    nu0 = (rs.rand(4) * 20000).astype(np.float32)
    z0 = (rs.rand(4) * 20000).astype(np.float32)
    jnew = jreplay.backfill_returns(
        jbuf, jnp.asarray(slots), jnp.asarray(cont), jnp.asarray(seq), jnp.asarray(nu0), jnp.asarray(z0), jcfg
    )
    before = tbuf.values.to(torch.float32).clone()
    t = torch.from_numpy
    tnew = treplay.backfill_returns(tbuf, t(slots), t(cont), t(seq), t(nu0), t(z0), tcfg)
    for name in ("values", "step_priorities"):
        got, ref = as_f32(getattr(tnew, name)), as_f32(getattr(jnew, name))
        np.testing.assert_allclose(got, ref, rtol=2.0**-8, err_msg=name)
    after = tnew.values.to(torch.float32)
    assert not torch.equal(after[4], before[4]), "a truncated segment still in the buffer is patched"
    assert torch.equal(after[5], before[5]) and torch.equal(after[7], before[7])
    for name in set(treplay.BufferState._fields) - {"values", "step_priorities"}:
        np.testing.assert_array_equal(as_f32(getattr(tnew, name)), as_f32(getattr(jnew, name)), err_msg=name)


def test_update_priorities_matches_jax():
    jcfg, tcfg = configs()
    jbuf, tbuf = filled(2, jcfg, tcfg)
    idx = np.array([[0, 0], [3, 5], [7, 11], [2, 1]], dtype=np.int32)
    prios = np.array([0.5, 1e-9, 123.456, 0.0317], dtype=np.float32)
    jnew = jreplay.update_priorities(jbuf, jnp.asarray(idx), jnp.asarray(prios))
    tnew = treplay.update_priorities(tbuf, torch.from_numpy(idx), torch.from_numpy(prios))
    assert_buffers_equal(jnew, tnew)


def test_trajectory_priority_matches_jax():
    jtraj, ttraj = both_trajectories(3)
    np.testing.assert_allclose(
        treplay.trajectory_priority(ttraj).numpy(), np.asarray(jreplay.trajectory_priority(jtraj)), rtol=1e-5
    )

"""Data parallelism of the PyTorch port vs the JAX package and vs one device, on the CPU.

The port's mesh here is eight entries of the CPU device, the counterpart of
the JAX package's 8-virtual-device CPU mesh: eight replicas, each with its
own networks and optimizer state, the batch split over them, the gradients
summed by the ring (its plain version on CPU shards). Data-parallel training
is meant to be invisible, so the data-parallel step is held to the
single-device step of the port and to JAX's ``make_dp_train_step`` on the
same Flax weights (converted by ``convert.params_from_flax``), within the
tolerances of ``tests/test_parallel.py``: loss rtol 1e-5, priorities rtol
1e-4, parameters rtol 1e-4 / atol 1e-6 (the sums over the shards and the
ring's rotation order round differently from one batch-wide sum); the fused
superstep against the single-device superstep on the same sampled batches
within that file's superstep tolerances. Every replica must hold the same
parameters, bit for bit, after every step. Inputs come from numpy seeds.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_learner import assert_params_match
from test_torch_losses import game_windows
from test_torch_self_play import make_pair

from simulate_2048_tpu import parallel as jparallel
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import losses as jlosses
from simulate_2048_tpu_torch import parallel
from simulate_2048_tpu_torch import train
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.parallel import ring
from simulate_2048_tpu_torch.training import learner as tlearner
from simulate_2048_tpu_torch.training import losses as tlosses
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training.config import tiny_config
from simulate_2048_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

N = 8
CPU = torch.device("cpu")
BASE = dict(hidden_size=32, num_residual_blocks=1, batch_size=16, replay_buffer_size=64, warmup_steps=1,
            learning_rate=1e-3)  # fmt: skip


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh([CPU] * N)


def both_batches(seed: int, batch: int = 16):
    arrays = game_windows(seed, batch=batch)
    jbatch = jlosses.TrainingTargets(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tbatch = tlosses.TrainingTargets(
        **{k: torch.from_numpy(v.astype(np.int64) if k == "actions" else v) for k, v in arrays.items()}
    )
    weights = np.random.RandomState(seed + 50).rand(batch).astype(np.float32) + 0.1
    return jbatch, tbatch, weights


def fresh_state(tnet, tcfg):
    optimizer = tlearner.create_optimizer(tcfg)
    return tlearner.TrainState(tnet, optimizer.init(list(tnet.parameters()))), optimizer


def assert_replicas_identical(step):
    first = step.replicas[0]
    for replica in step.replicas[1:]:
        assert replica.step == first.step and replica.opt_state["count"] == first.opt_state["count"]
        for a, b in zip(first.params, replica.params):
            assert torch.equal(a, b)
        for key in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(first.opt_state[key], replica.opt_state[key]))


def test_mesh_and_placement_helpers(mesh):
    assert mesh.size == N and mesh.shape == {"data": N} and mesh.axis_name == parallel.mesh.DATA_AXIS
    x = torch.arange(16.0).reshape(8, 2)
    parts = parallel.batch_sharding(parallel.make_mesh([CPU] * 4))(x)
    assert [p.shape for p in parts] == [(2, 2)] * 4 and torch.equal(torch.cat(parts), x)
    copies = parallel.replicated_sharding(parallel.make_mesh([CPU] * 3))(x)
    assert all(torch.equal(c, x) and c.data_ptr() != x.data_ptr() for c in copies)
    assert len({c.data_ptr() for c in copies}) == 3, "every replica owns its copy"
    state = tenv.reset_batch(5, 8, CPU)
    shards = parallel.shard_pytree_batch(state, parallel.make_mesh([CPU] * 4))
    assert len(shards) == 4 and all(isinstance(s, tenv.GameState) for s in shards)
    assert torch.equal(torch.cat([s.game_seed for s in shards]), state.game_seed)
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_pytree_batch(state, parallel.make_mesh([CPU] * 3))
    with pytest.raises(ValueError, match="at least one device"):
        parallel.make_mesh([])


def test_sharded_rollout_matches_one_device_and_jax(mesh):
    n_envs, n_steps = 64, 16
    got = parallel.make_sharded_rollout(mesh, n_envs, n_steps)(5)
    one = parallel.make_sharded_rollout(parallel.make_mesh([CPU]), n_envs, n_steps)(5)
    jmesh = jparallel.make_mesh(jax.devices()[:N])
    want = jax.device_get(jparallel.make_sharded_rollout(jmesh, n_envs, n_steps)(jnp.uint32(5)))
    assert int(got[0]) == int(one[0]) == int(want[0]) == n_envs * n_steps
    assert float(got[1]) == float(one[1]) == float(want[1]), "integer rewards: every order of summation is exact"
    assert int(got[2]) == int(one[2]) == int(want[2])


@pytest.mark.parametrize(
    "overrides",
    [dict(), dict(value_bins=16, reward_bins=8, afterstate_value_loss_weight=0.25, max_grad_norm=0.05)],
    ids=["scalar", "categorical_clipped"],
)
def test_dp_train_step_matches_single_device_and_jax(mesh, overrides):
    jcfg, tcfg, jnet, tnet = make_pair(**{**BASE, **overrides})
    single, optimizer = fresh_state(copy.deepcopy(tnet), tcfg)
    dp_state, _ = fresh_state(tnet, tcfg)
    dp_step = parallel.make_dp_train_step(tnet, tcfg, optimizer, mesh)

    jmesh = jparallel.make_mesh(jax.devices()[:N])
    jopt = jlearner.create_optimizer(jcfg)
    jstate = jlearner.TrainState(jnet.params, jopt.init(jnet.params), jnp.int32(0))
    with jmesh:
        jdp = jparallel.make_dp_train_step(jnet.apply_fns, jcfg, jopt, jmesh)

    for step in range(3):  # the first has learning rate 0 (warm-up)
        jbatch, tbatch, weights = both_batches(step)
        single, loss_a, prio_a = tlearner.train_step(single, tbatch, torch.from_numpy(weights), tcfg, optimizer)
        dp_state, loss_b, prio_b = dp_step(dp_state, tbatch, torch.from_numpy(weights))
        with jmesh:
            jstate, jloss, jprio = jdp(
                jstate, jparallel.shard_pytree_batch(jbatch, jmesh), jparallel.shard_pytree_batch(jnp.asarray(weights),
                                                                                                   jmesh))  # fmt: skip
        for want_loss, want_prio in ((loss_a, prio_a.numpy()), (jax.device_get(jloss), np.asarray(jprio))):
            np.testing.assert_allclose(float(loss_b.total_loss), float(want_loss.total_loss), rtol=1e-5)
            for name in loss_b._fields:
                np.testing.assert_allclose(float(getattr(loss_b, name)), float(getattr(want_loss, name)), rtol=1e-5,
                                           atol=1e-6, err_msg=name)  # fmt: skip
            np.testing.assert_allclose(prio_b.numpy(), want_prio, rtol=1e-4)
        assert_replicas_identical(dp_step)
    assert dp_state.step == single.step == int(jstate.step) == 3
    for a, b in zip(single.params, dp_state.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert_params_match(jstate.params, dp_state, tcfg, rtol=1e-4, atol=1e-6)


def test_dp_step_encoder_noise_and_entropy_bonus_match_single_device(mesh):
    """The terms that do not split by sample: the encoder's Gumbel noise is
    drawn for the global batch, the codebook entropy is the global batch's."""
    overrides = dict(chance_target_mode="encoder", encoder_noise_scale=1.0, codebook_entropy_weight=0.1,
                     commitment_loss_weight=0.5)  # fmt: skip
    _, tcfg, _, tnet = make_pair(**{**BASE, **overrides})
    single, optimizer = fresh_state(copy.deepcopy(tnet), tcfg)
    dp_state, _ = fresh_state(tnet, tcfg)
    dp_step = parallel.make_dp_train_step(tnet, tcfg, optimizer, mesh)
    for step in range(3):
        _, tbatch, weights = both_batches(step)
        single, loss_a, prio_a = tlearner.train_step(single, tbatch, torch.from_numpy(weights), tcfg, optimizer)
        dp_state, loss_b, prio_b = dp_step(dp_state, tbatch, torch.from_numpy(weights))
        for name in loss_b._fields:
            np.testing.assert_allclose(float(getattr(loss_b, name)), float(getattr(loss_a, name)), rtol=1e-5,
                                       atol=1e-6, err_msg=name)  # fmt: skip
        np.testing.assert_allclose(prio_b.numpy(), prio_a.numpy(), rtol=1e-4)
    assert float(loss_b.codebook_entropy) > 0
    for a, b in zip(single.params, dp_state.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-4, atol=1e-6)
    assert_replicas_identical(dp_step)


def filled_buffer(tnet, tcfg):
    buffer = treplay.init_buffer(tcfg)
    for seed in (3, 4):
        _, traj, _ = tsp.play_segment(tnet, tenv.reset_batch(seed, 16, CPU), None, 0.0, tcfg, 16, True)
        buffer = treplay.add_trajectories(buffer, traj)
    return buffer


def test_dp_train_superstep_matches_single_device(mesh):
    _, tcfg, _, tnet = make_pair(**{**BASE, "max_trajectory_length": 12})
    buffer = filled_buffer(tnet, tcfg)
    chunk = 3
    single, optimizer = fresh_state(copy.deepcopy(tnet), tcfg)
    dp_state, _ = fresh_state(tnet, tcfg)
    # The superstep writes priorities into the buffer in place: each run gets its own copy.
    single, buf_a, loss_a = tlearner.train_superstep(
        single, copy.deepcopy(buffer), torch.Generator().manual_seed(7), tcfg, optimizer, chunk
    )
    launches = ring.LAUNCHES["ring_all_reduce"]
    superstep = parallel.make_dp_train_superstep(tnet, tcfg, optimizer, mesh, chunk)
    dp_state, buf_b, loss_b = superstep(dp_state, buffer, torch.Generator().manual_seed(7))
    assert ring.LAUNCHES["ring_all_reduce"] == launches, "CPU shards take the plain ring"
    assert dp_state.step == single.step == chunk
    np.testing.assert_allclose(float(loss_b.total_loss), float(loss_a.total_loss), rtol=1e-4)
    for a, b in zip(single.params, dp_state.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(buf_b.step_priorities.float().numpy(), buf_a.step_priorities.float().numpy(),
                               rtol=2e-2, atol=1e-3)  # fmt: skip


def test_dp_step_rebuilds_replicas_for_a_state_that_moved_on(mesh):
    _, tcfg, _, tnet = make_pair(**BASE)
    state, optimizer = fresh_state(tnet, tcfg)
    dp_step = parallel.make_dp_train_step(tnet, tcfg, optimizer, parallel.make_mesh([CPU] * 2))
    _, tbatch, weights = both_batches(0)
    w = torch.from_numpy(weights)
    dp_step(state, tbatch, w)
    tlearner.train_step(state, tbatch, w, tcfg, optimizer)  # one step outside the data-parallel step
    dp_step(state, tbatch, w)
    assert state.step == 3
    assert_replicas_identical(dp_step)
    with pytest.raises(ValueError, match="the step's network"):
        dp_step(fresh_state(copy.deepcopy(tnet), tcfg)[0], tbatch, w)


def tiny_mesh_config(**overrides):
    return dataclasses.replace(
        tiny_config(), hidden_size=32, num_residual_blocks=1, num_simulations=3, num_parallel_games=4,
        max_trajectory_length=6, min_buffer_size=4, batch_size=8, replay_buffer_size=16, generation_interval=4,
        log_interval=4, eval_interval=8, eval_games=2, eval_max_moves=4, checkpoint_interval=1 << 20,
        reanalyze_interval=4, reanalyze_episodes=2, reanalyze_mode="search", value_bins=16, reward_bins=8,
        **overrides,
    )  # fmt: skip


def test_trainer_over_a_mesh_reaches_the_fused_dp_superstep():
    """The counterpart of the JAX package's multi-device dry run: self-play, a
    reanalyze pass and the fused data-parallel superstep over a 4-replica
    mesh, then the per-step data-parallel path on the same replicas."""
    mesh = parallel.make_mesh([CPU] * 4)
    assert int(parallel.make_sharded_rollout(mesh, 16, 4)(7)[0]) == 16 * 4
    trainer = Trainer(tiny_mesh_config(), seed=0, mesh=mesh)
    assert trainer.device == CPU
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    trainer.train(num_steps=8, verbose=False)
    assert trainer.state.step == 8
    assert trainer._dp_superstep is not None, "fused DP superstep did not engage"
    assert trainer._prev is not None, "backfill bookkeeping did not engage"
    assert trainer._reanalyze_cursor > 0
    assert_replicas_identical(trainer._dp_step)
    loss = trainer.optimize_step()
    assert trainer.state.step == 9 and np.isfinite(float(loss.total_loss))
    assert all(r.step == 9 for r in trainer._dp_step.replicas)
    assert_replicas_identical(trainer._dp_step)


def test_trainer_mesh_arguments_are_checked():
    with pytest.raises(TypeError, match="parallel.Mesh"):
        Trainer(tiny_config(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="first device"):
        Trainer(tiny_config(), mesh=parallel.make_mesh([CPU] * 2), device="meta")


def test_train_cli_data_parallel_on_one_device_runs_without_a_mesh(tmp_path, capsys):
    trainer = train.main(["--mode", "tiny", "--data-parallel", "--device", "cpu", "--steps", "2", "--no-eval",
                          "--checkpoint-dir", str(tmp_path), "--set", "hidden_size=32", "--set", "num_simulations=2",
                          "--set", "max_trajectory_length=8", "--set", "batch_size=4"])  # fmt: skip
    assert trainer.mesh is None and trainer.state.step == 2
    assert "data-parallel over" not in capsys.readouterr().out

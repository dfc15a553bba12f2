"""The port's ``verify_parity`` and ``benchmark_scaling`` entry points
(``simulate_2048_tpu_torch/scripts/``) against the JAX package, on the CPU.

- ``verify_parity``: the script's device rollout, run on the CPU at 256
  boards x 64 steps, equals a replay on the JAX package's NumPy engine
  (``simulate_2048_tpu.engine``) on every board, bit for bit: final boards,
  reward sums and spawn counts. The CLI prints ``PARITY OK``, and exits 1
  when a board differs.
- ``benchmark_scaling``: at ``--virtual 2 --device cpu`` the script's sharded
  rollout totals equal JAX's ``make_sharded_rollout`` on two virtual CPU
  devices at the same run seed and sizes, bit for bit; its data-parallel
  step's losses equal JAX's ``make_dp_train_step`` within
  ``tests/test_parallel.py``'s rtol 1e-5 on the same Flax weights (converted
  by ``convert.py``) and the batch JAX samples from the same fixture; the
  script's copy of the fixture equals ``tests/test_training.py``'s
  ``make_trajectories`` arrays bit for bit.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_training import make_trajectories as jax_make_trajectories

from simulate_2048_tpu import parallel as jparallel
from simulate_2048_tpu.engine import board as jboard
from simulate_2048_tpu.engine import rng as jrng
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu_torch import parallel
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.scripts import benchmark_scaling, verify_parity
from simulate_2048_tpu_torch.training import losses as tlosses

torch.set_num_threads(1)
CPU = torch.device("cpu")


# ---- verify_parity


def jax_oracle(seed: int, steps: int):
    """The JAX script's replay on the JAX package's NumPy engine: (board values, reward sum, spawn count)."""
    board = jboard.create_initial_board_counter(seed)
    spawn_count, reward_sum = 2, 0.0
    for t in range(steps):
        if jboard.is_done(board):
            continue
        a_bits, _ = jrng.threefry2x32_np((np.uint32(0x2048_0099), np.uint32(seed)), (np.uint32(t), np.uint32(0)))
        board, reward, moved = jboard.next_state_counter(board, int(a_bits) & 3, seed, spawn_count)
        spawn_count += moved
        reward_sum += reward
    return board, reward_sum, spawn_count


def test_verify_parity_rollout_matches_the_jax_oracle():
    boards, steps = 256, 64
    seeds = jrng.derive_game_seeds_np(1234, np.arange(boards), np.zeros(boards))
    dev_boards, dev_rewards, dev_counts = verify_parity.device_rollout(seeds, steps, CPU)
    ended = 0
    for i in range(boards):
        board, reward_sum, count = jax_oracle(int(seeds[i]), steps)
        values = np.where(dev_boards[i] > 0, 2 ** dev_boards[i].astype(np.int64), 0)
        assert np.array_equal(values, board), i
        assert dev_rewards[i] == np.float32(reward_sum) and dev_counts[i] == count, i
        ended += jboard.is_done(board)
    assert ended > 0 and dev_counts.min() > 2, "some games end inside the 64 moves (the done mask runs)"


def test_verify_parity_cli_prints_parity_ok(capsys):
    verify_parity.main(["--device", "cpu", "--boards", "64", "--steps", "48", "--check", "64"])
    out = capsys.readouterr().out
    assert "PARITY OK: 64/64 boards bitwise-identical over 48 steps" in out and "0 mismatches" in out


def test_verify_parity_cli_exits_1_on_a_mismatch(monkeypatch, capsys):
    rollout = verify_parity.device_rollout

    def one_board_off(seeds, steps, device):
        boards, rewards, counts = rollout(seeds, steps, device)
        boards[1, 0, 0] += 1
        return boards, rewards, counts

    monkeypatch.setattr(verify_parity, "device_rollout", one_board_off)
    with pytest.raises(SystemExit) as exit_info:
        verify_parity.main(["--device", "cpu", "--boards", "8", "--steps", "16", "--check", "8"])
    out = capsys.readouterr().out
    assert exit_info.value.code == 1 and "MISMATCH board 1" in out and "1 mismatches" in out and "PARITY OK" not in out


# ---- benchmark_scaling


def test_benchmark_scaling_rollout_totals_match_jax():
    n, envs_per_device, steps = 2, 32, 16
    got = parallel.make_sharded_rollout(
        parallel.make_mesh(benchmark_scaling.mesh_devices(CPU, n)), envs_per_device * n, steps
    )(benchmark_scaling.ROLLOUT_SEED)
    jmesh = jparallel.make_mesh(jax.devices()[:n])
    want = jax.device_get(
        jparallel.make_sharded_rollout(jmesh, envs_per_device * n, steps)(jnp.uint32(benchmark_scaling.ROLLOUT_SEED))
    )
    assert [int(got[0]), float(got[1]), int(got[2])] == [int(want[0]), float(want[1]), int(want[2])]
    assert int(got[0]) == envs_per_device * n * steps


def test_benchmark_scaling_fixture_matches_the_test_suite():
    cfg = benchmark_scaling.learner_config(2, 8)
    want = jax_make_trajectories(64, 30, jconfig.TrainConfig(**dataclasses.asdict(cfg)))
    got = benchmark_scaling.make_trajectories(64, 30, cfg)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_benchmark_scaling_dp_loss_matches_jax():
    n = 2
    tcfg = benchmark_scaling.learner_config(n, 8)
    jcfg = jconfig.TrainConfig(**dataclasses.asdict(tcfg))
    jstate, jnet = jlearner.create_train_state(jax.random.PRNGKey(0), jcfg)
    jopt = jlearner.create_optimizer(jcfg)
    buffer = jreplay.add_trajectories(jreplay.init_buffer(jcfg), jax_make_trajectories(64, 30, jcfg))
    jbatch, _, jweights = jreplay.sample_batch(buffer, jax.random.PRNGKey(1), jcfg.batch_size, jcfg)
    jmesh = jparallel.make_mesh(jax.devices()[:n])
    with jmesh:
        jdp = jparallel.make_dp_train_step(jnet.apply_fns, jcfg, jopt, jmesh)
        _, jloss, _ = jdp(jstate, jparallel.shard_pytree_batch(jbatch, jmesh),
                          jparallel.shard_pytree_batch(jweights, jmesh))  # fmt: skip

    tnet = params_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg)
    arrays = jax.tree.map(np.array, jbatch)._asdict()
    tbatch = tlosses.TrainingTargets(
        **{k: torch.from_numpy(v.astype(np.int64) if k == "actions" else v) for k, v in arrays.items()}
    )
    mesh = parallel.make_mesh(benchmark_scaling.mesh_devices(CPU, n))
    step = benchmark_scaling.learner_step(mesh, tcfg, tnet, tbatch, torch.from_numpy(np.array(jweights)))
    loss = step()
    jloss = jax.device_get(jloss)
    for name in loss._fields:
        np.testing.assert_allclose(float(getattr(loss, name)), float(getattr(jloss, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)  # fmt: skip


def test_benchmark_scaling_cli_on_two_cpu_replicas():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = benchmark_scaling.main(
            ["--virtual", "2", "--device", "cpu", "--envs-per-device", "16", "--steps", "4", "--batch-per-device", "4"]
        )
    assert [r["devices"] for r in results] == [1, 2] and '"rollout_efficiency"' in out.getvalue()
    for r in results:
        assert {"devices", "env_steps_per_s", "learner_samples_per_s", "rollout_efficiency",
                "learner_efficiency"} <= set(r)  # fmt: skip
        assert r["replicas_of_one_card"] is False and r["ring_launches_per_step"] == 0  # the ring's plain version
    assert results[0]["rollout_efficiency"] == results[0]["learner_efficiency"] == 1.0

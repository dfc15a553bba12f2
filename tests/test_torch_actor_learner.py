"""Asynchronous actor/learner runtime of the PyTorch port, on the CPU: the
behaviours ``tests/test_actor_learner.py`` checks in the JAX package. Actors
stream trajectories over the TCP channel, the learner trains from them
(never generating games itself) and publishes parameters back; backfill
runs through the trainer's own ingestion with the chain checked; a full
queue drops its oldest batch; dying actors, corrupt frames and lost
channels leave the server serving; the learner loop runs the trainer's
fused supersteps and host hooks."""

import dataclasses
import json
import os
import queue as queue_mod
import socket as socket_mod
import struct as struct_mod
import threading

import numpy as np
import pytest
import torch

from simulate_2048_tpu_torch.parallel import ActorClient, LearnerServer, make_mesh
from simulate_2048_tpu_torch.parallel.actor_learner import _to_numpy
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager
from simulate_2048_tpu_torch.training.config import tiny_config
from simulate_2048_tpu_torch.training.self_play import generate_games
from simulate_2048_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
CPU = "cpu"


def micro_config(**overrides):
    base = dict(hidden_size=32, num_residual_blocks=1, num_simulations=4, max_trajectory_length=12, min_buffer_size=4,
                batch_size=8, num_parallel_games=2, generation_interval=5, log_interval=5, eval_interval=1_000_000,
                checkpoint_interval=1_000_000)  # fmt: skip
    return dataclasses.replace(tiny_config(), **{**base, **overrides})


def started(config, mesh=None, **kwargs):
    trainer = Trainer(config, seed=0, device=None if mesh else CPU, mesh=mesh, **kwargs)
    trainer.initialize()
    return trainer, LearnerServer(trainer, port=0).start()


@pytest.mark.timeout(600)
@pytest.mark.parametrize("replicas", [None, 2], ids=["one_device", "data_parallel"])
def test_actors_feed_learner_and_pull_params(replicas):
    config = micro_config()
    trainer, server = started(config, mesh=make_mesh([CPU] * replicas) if replicas else None)
    actor_steps: list[list[int]] = [[], []]

    def run_actor(idx: int, generations: int):
        actor = ActorClient(config, server.address, seed=idx + 1, device=CPU)
        actor.run(generations, on_generation=lambda g, s: actor_steps[idx].append(s))
        actor.close()

    threads = [threading.Thread(target=run_actor, args=(i, 4), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        # The learner never generates: every episode in the buffer arrived over the wire.
        server.fill_buffer(timeout_s=300.0, verbose=False)
        assert int(trainer.buffer.size) >= config.min_buffer_size
        assert server.trajectories_received >= 2
        final = server.run(num_steps=10, verbose=False)
        assert final["step"] == 10 and trainer.state.step == 10
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        # A fresh pull after training sees the final published snapshot.
        late = ActorClient(config, server.address, seed=99, device=CPU)
        params = late.fetch_params()
        assert late.learner_step == 10
        for got, want in zip(params, trainer.state.params):
            np.testing.assert_array_equal(got, want.detach().numpy())
        late.close()
    finally:
        server.close()
    assert [len(s) for s in actor_steps] == [4, 4]
    for steps in actor_steps:
        assert steps == sorted(steps), "the learner step must be monotone in actor pulls"
    assert server.params_served >= 9
    if replicas:
        assert trainer._dp_superstep is not None


def backfill_config():
    return micro_config(value_target_mode="td_lambda", td_lambda=1.0, cross_segment_backfill=True)


@pytest.mark.timeout(600)
def test_truncated_targets_shift_when_successor_arrives_over_tcp():
    config = backfill_config()
    trainer, server = started(config)
    try:
        actor = ActorClient(config, server.address, seed=3, device=CPU)
        # Segment 1: 12-move segments of fresh games never finish, so both lanes are truncated.
        actor.run(1)
        assert server.drain_queue(block_for_first=True, timeout_s=60.0) == 1
        first_rows = trainer.buffer.values[:2].float().numpy().copy()
        lengths = trainer.buffer.length[:2].numpy()
        terminated = trainer.buffer.terminated[:2].numpy()
        assert (~terminated).any(), "expected truncated segments"
        # Segment 2 (the same games continuing): its openings re-ground segment 1's targets.
        actor.run(1)
        assert server.drain_queue(block_for_first=True, timeout_s=60.0) == 1
        patched_rows = trainer.buffer.values[:2].float().numpy()
        shifted = any(
            not np.allclose(first_rows[lane, : lengths[lane]], patched_rows[lane, : lengths[lane]])
            for lane in range(2)
            if not terminated[lane]
        )
        assert shifted, "the successor's arrival must shift the truncated segment's targets"
        # The segment statistics crossed the wire into the learner's metrics.
        gen_rows = [r for r in trainer.metrics.history if "gen/completed_games" in r]
        assert len(gen_rows) == 2 and gen_rows[0]["actor_id"] == 3
        actor.close()
    finally:
        server.close()


def test_continuity_guard_skips_backfill_after_a_drop():
    """A dropped batch breaks the segment chain: the next arrival is inserted
    without re-grounding (its predecessor in the buffer is not its
    predecessor in the game)."""
    config = backfill_config()
    trainer = Trainer(config, seed=0, device=CPU)
    trainer.initialize()
    server = LearnerServer(trainer, port=0)  # not started: direct ingestion
    try:
        state, msgs = trainer.gen_state, []
        for gen in range(3):
            state, traj, stats = generate_games(
                trainer.network, torch.Generator().manual_seed(100 + gen), config, 0, env_state=state
            )
            msgs.append({"kind": "trajectories", "payload": _to_numpy(traj), "gen_stats": _to_numpy(stats),
                         "actor_id": 7, "generation": gen})  # fmt: skip
        server._ingest_message(msgs[0])
        rows_after_first = trainer.buffer.values[:2].float().numpy().copy()
        server._ingest_message(msgs[2])  # generation 1 was dropped by the queue
        assert np.array_equal(rows_after_first, trainer.buffer.values[:2].float().numpy())
        assert int(trainer.buffer.size) == 4, "the batch itself was still inserted"
    finally:
        server.close()


@pytest.fixture()
def server():
    _, server = started(micro_config())
    yield server
    server.close()


def test_close_terminates_accept_thread(server):
    assert server._accept_thread.is_alive()
    server.close()
    server._accept_thread.join(timeout=5.0)
    assert not server._accept_thread.is_alive()


def test_full_queue_drops_oldest_never_blocks(server):
    server._traj_queue = queue_mod.Queue(maxsize=2)
    for payload in ("a", "b", "c", "d"):
        server._enqueue(payload)  # returns at once even when full
    assert server.trajectories_dropped == 2
    assert [server._traj_queue.get_nowait() for _ in range(2)] == ["c", "d"], "the two newest batches survive"


def test_actor_death_mid_message_leaves_server_alive(server):
    sock = socket_mod.create_connection(server.address)
    sock.sendall(b"\x00\x00\x00")  # half a length header
    sock.close()
    sock = socket_mod.create_connection(server.address)
    sock.sendall(struct_mod.pack("!Q", 1000) + b"partial")  # a body shorter than its header says
    sock.close()
    actor = ActorClient(micro_config(), server.address, seed=5, device=CPU)
    actor.fetch_params()
    assert actor.learner_step == 0
    actor.close()


def test_corrupt_frame_drops_connection_not_server(server):
    sock = socket_mod.create_connection(server.address)
    garbage = b"\x93NOT-PICKLE\xff\xfe"
    sock.sendall(struct_mod.pack("!Q", len(garbage)) + garbage)
    sock.settimeout(5.0)
    assert sock.recv(1) == b"", "the server closes this connection without a reply"
    sock.close()
    actor = ActorClient(micro_config(), server.address, seed=6, device=CPU)
    actor.fetch_params()
    actor.close()


def test_actor_reconnects_after_channel_loss(server):
    actor = ActorClient(micro_config(), server.address, seed=7, device=CPU)
    actor.fetch_params()
    actor._sock.close()  # a broken channel: the next call redials
    actor.fetch_params()
    assert actor.reconnects == 1 and actor.learner_step == 0
    actor.close()


def test_pulled_parameters_are_the_published_snapshot(server):
    """A pull returns the parameters as they were published, not as later
    in-place optimizer steps left them (on the CPU, ``numpy()`` of a tensor
    shares its storage: the snapshot must be a copy)."""
    published = [p.detach().clone() for p in server.trainer.state.params]
    with torch.no_grad():
        for p in server.trainer.state.params:
            p.add_(1.0)  # what an optimizer step does between two publications
    actor = ActorClient(micro_config(), server.address, seed=10, device=CPU)
    for got, want in zip(actor.fetch_params(), published, strict=True):
        np.testing.assert_array_equal(got, want.numpy())
    actor.close()


def test_wait_for_actors_returns_once_they_hang_up(server):
    actor = ActorClient(micro_config(), server.address, seed=11, device=CPU)
    actor.fetch_params()
    assert not server.wait_for_actors(0.2), "a connected actor keeps the learner serving"
    actor.fetch_params()  # still served while the learner waits
    actor.close()
    assert server.wait_for_actors(10.0)


def test_exhausted_retries_raise():
    _, server = started(micro_config())
    actor = ActorClient(micro_config(), server.address, seed=8, connect_timeout_s=1.0, device=CPU)
    server.close()
    actor._sock.close()  # the learner is gone for good: every redial fails
    with pytest.raises((OSError, ConnectionError)):
        actor.fetch_params()
    actor.close()


@pytest.mark.timeout(600)
def test_fused_superstep_and_host_hooks_engage(tmp_path):
    config = micro_config(eval_interval=10, checkpoint_interval=10, deep_eval_interval=10, deep_eval_games=2,
                          eval_max_moves=8, eval_games=2)  # fmt: skip
    ckdir = str(tmp_path / "ck")
    trainer, server = started(config, checkpoint_dir=ckdir)
    try:
        actor = ActorClient(config, server.address, seed=1, device=CPU)
        actor.run(3)
        actor.close()
        server.drain_queue(block_for_first=True)
        final = server.run(num_steps=10, verbose=False)
    finally:
        server.close()
    assert server.last_run_fused, "the intervals land on log_interval=5"
    assert final["step"] == 10 and trainer.state.step == 10
    assert CheckpointManager(ckdir).latest_step() == 10
    assert any("eval/mean_reward" in r for r in trainer.metrics.history)
    assert any("deep_eval/mean_reward" in r for r in trainer.metrics.history)
    with open(os.path.join(ckdir, "deep_eval_best.json")) as f:
        assert json.load(f)["games"] == 2


@pytest.mark.timeout(600)
def test_misaligned_intervals_fall_back_to_per_step():
    config = micro_config(eval_interval=7)
    trainer, server = started(config)
    try:
        actor = ActorClient(config, server.address, seed=1, device=CPU)
        actor.run(3)
        actor.close()
        server.drain_queue(block_for_first=True)
        final = server.run(num_steps=7, verbose=False)
    finally:
        server.close()
    assert not server.last_run_fused
    assert final["step"] == 5, "the last log boundary (log_interval=5)"
    assert trainer.state.step == 7

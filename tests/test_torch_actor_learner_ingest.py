"""The learner's ingestion of actor messages in the PyTorch port against the
JAX package's ``LearnerServer._ingest_message``, on the CPU.

The same numpy messages, made from a seed, go into both learners: three
generations from each of two actors, with the second actor's middle
generation dropped (as a full queue drops it), so that its last generation
arrives without its predecessor and the continuity guard must skip the
backfill. Tiny configs with TD(λ) targets and ``cross_segment_backfill``;
a capacity of 12 episodes that the fifth batch of 3 wraps.

Tolerance: after every message the two buffers are equal field for field,
the compressed fields compared through float32 (integer and boolean fields
exact; the backfilled targets are stored in bfloat16, and JAX's and the
port's float32 backfill, held elsewhere to one bfloat16 step, round to the
same stored values here, so they are held exactly too); the per-actor
backfill bookkeeping (slots, continuation flags, sequence numbers,
generation) is equal; the logged ``gen/*`` statistics are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_replay import assert_buffers_equal

from simulate_2048_tpu.parallel.actor_learner import LearnerServer as JaxLearnerServer
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu.training import self_play as jself_play
from simulate_2048_tpu.training import trainer as jtrainer
from simulate_2048_tpu_torch.parallel.actor_learner import LearnerServer
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training import self_play as tself_play
from simulate_2048_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)

B, T, CAP = 3, 6, 12
# (actor_id, generation) in arrival order; actor 2's generation 1 was dropped.
ARRIVALS = [(1, 0), (2, 0), (1, 1), (1, 2), (2, 2)]


def configs(td_lambda: float):
    jcfg = dataclasses.replace(
        jconfig.tiny_config(), hidden_size=32, num_residual_blocks=1, max_trajectory_length=T, replay_buffer_size=CAP,
        num_parallel_games=B, value_target_mode="td_lambda", td_lambda=td_lambda, cross_segment_backfill=True,
    )  # fmt: skip
    return jcfg, tconfig.TrainConfig(**dataclasses.asdict(jcfg))


def message_arrays(seed: int) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """One actor segment batch of B lanes: trajectory fields and GenStats."""
    rs = np.random.RandomState(seed)
    terminated = rs.rand(B) < 0.35
    length = np.where(terminated, rs.randint(1, T + 1, size=B), T).astype(np.int32)
    mask = np.arange(T)[None] < length[:, None]
    values = (rs.rand(B, T) * 2000 * mask).astype(np.float32)
    traj = dict(
        boards=rs.randint(0, 11, size=(B, T + 1, 16)).astype(np.int8),
        actions=(rs.randint(0, 4, size=(B, T)) * mask).astype(np.int8),
        rewards=(rs.randint(0, 64, size=(B, T)) * 4 * mask).astype(np.float32),
        policies=(rs.dirichlet([0.7] * 4, size=(B, T)) * mask[..., None]).astype(np.float32),
        values=values,
        priorities=(rs.rand(B, T) * 5 * mask).astype(np.float32),
        length=length,
        terminated=terminated,
        total_reward=(rs.rand(B) * 3000).astype(np.float32),
        max_tile=(2 ** rs.randint(3, 10, size=B)).astype(np.int32),
    )
    stats = dict(
        completed=np.int32(terminated.sum()),
        completed_score_sum=np.float32(traj["total_reward"][terminated].sum()),
        completed_length_sum=np.int32(rs.randint(50, 400, size=B)[terminated].sum()),
        active_positions=np.int32(mask.sum()),
        policy_entropy_sum=np.float32(rs.rand() * 20),
        search_value_sum=np.float32(values.sum()),
        first_search_value=(rs.rand(B) * 2000).astype(np.float32),
    )
    return traj, stats


def messages(jax_side: bool) -> list[dict]:
    traj_cls = jreplay.Trajectory if jax_side else treplay.Trajectory
    stats_cls = jself_play.GenStats if jax_side else tself_play.GenStats
    out = []
    for actor, gen in ARRIVALS:
        traj, stats = message_arrays(1000 * actor + gen)
        out.append({"kind": "trajectories", "payload": traj_cls(**traj), "gen_stats": stats_cls(**stats),
                    "actor_id": actor, "generation": gen})  # fmt: skip
    return out


def gen_rows(history: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k.startswith("gen/") or k in ("step", "actor_id")} for r in history]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("td_lambda", [0.9, 1.0])
def test_ingestion_matches_jax_learner(td_lambda):
    jcfg, tcfg = configs(td_lambda)
    jax_trainer = jtrainer.Trainer(jcfg, seed=0)
    jax_trainer.initialize()
    port_trainer = ttrainer.Trainer(tcfg, seed=0, device="cpu")
    port_trainer.initialize()
    jax_server, port_server = JaxLearnerServer(jax_trainer, port=0), LearnerServer(port_trainer, port=0)
    try:
        patched = 0
        for jmsg, tmsg in zip(messages(True), messages(False), strict=True):
            before = port_trainer.buffer.values.clone()
            # The continuity guard: a batch whose predecessor was dropped is a plain insert.
            traj = treplay.Trajectory(*(torch.from_numpy(np.asarray(x)) for x in tmsg["payload"]))
            copy = treplay.BufferState(*(x.clone() for x in port_trainer.buffer))  # insertion writes in place
            plain, _ = ttrainer.ingest_segment(copy, None, traj, None, tcfg)
            jax_server._ingest_message(jmsg)
            port_server._ingest_message(tmsg)
            assert_buffers_equal(jax_trainer.buffer, port_trainer.buffer)
            # Rows that the batch itself did not write changed only by backfill.
            written = (torch.arange(B) + int(port_trainer.buffer.write_pos) - B) % CAP
            others = torch.ones(CAP, dtype=torch.bool)
            others[written] = False
            patched += int((before[others] != port_trainer.buffer.values[others]).any(-1).sum())
            if (tmsg["actor_id"], tmsg["generation"]) == (2, 2):
                for name, a, b in zip(treplay.BufferState._fields, plain, port_trainer.buffer):
                    assert torch.equal(a, b), name
            assert jax_server._prev_by_actor.keys() == port_server._prev_by_actor.keys()
            for actor, (jprev, jgen) in jax_server._prev_by_actor.items():
                tprev, tgen = port_server._prev_by_actor[actor]
                assert tgen == jgen
                for t, j in zip(tprev, jprev, strict=True):
                    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert patched > 0, "consecutive generations must re-ground their predecessors' truncated lanes"
        assert int(port_trainer.buffer.episodes_added) == B * len(ARRIVALS) > CAP, "the buffer wrapped"
        jrows, trows = gen_rows(jax_trainer.metrics.history), gen_rows(port_trainer.metrics.history)
        assert len(trows) == len(ARRIVALS) and [r["actor_id"] for r in trows] == [a for a, _ in ARRIVALS]
        assert trows == jrows
    finally:
        jax_server.close()
        port_server.close()

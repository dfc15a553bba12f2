"""The training slice of the PyTorch port as a whole vs the JAX package, and
the port's trainer, checkpoints and CLI, on the CPU.

Slice parity: one greedy ``play_segment`` in each package (bit-identical
games), each inserts its own trajectory into its own buffer (bit-identical
storage), the JAX ``sample_batch`` draws the indices and the port gathers
them, then ``compute_loss`` and three ``train_step``s with a short warm-up.
Every ``LossOutput`` field, the priorities and the updated parameters are
compared (rtol 1e-4; atol 1e-6 for losses and priorities, 3e-6 for
parameters at the test's learning rate of 1e-3, see
``test_torch_learner.py``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_learner import assert_params_match
from test_torch_replay import assert_buffers_equal
from test_torch_self_play import make_pair, play_both

from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu.training import trainer as jtrainer
from simulate_2048_tpu_torch import evaluate, train
from simulate_2048_tpu_torch.parallel import make_mesh
from simulate_2048_tpu_torch.training import learner as tlearner
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training import trainer as ttrainer
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager, load_train_config
from simulate_2048_tpu_torch.training.config import tiny_config

torch.set_num_threads(1)


@pytest.mark.parametrize("bins", [(1, 1), (16, 8)], ids=["scalar", "categorical"])
def test_training_slice_matches_jax(bins):
    jcfg, tcfg, jnet, tnet = make_pair(
        hidden_size=32, num_residual_blocks=2, value_bins=bins[0], reward_bins=bins[1], max_trajectory_length=12,
        num_unroll_steps=3, batch_size=16, warmup_steps=1, learning_rate=1e-3, value_target_mode="td_lambda",
        td_lambda=1.0, afterstate_value_loss_weight=0.25, cross_segment_backfill=True,
    )
    games = 6
    (jstate, jtraj, jstats), (tstate, ttraj, tstats) = play_both(jcfg, tcfg, jnet, tnet, games)
    np.testing.assert_array_equal(ttraj.boards.numpy(), np.asarray(jtraj.boards))

    jbuf, jprev = jtrainer.ingest_segment(jreplay.init_buffer(jcfg), None, jtraj, jstats.first_search_value, jcfg)
    tbuf, tprev = ttrainer.ingest_segment(treplay.init_buffer(tcfg), None, ttraj, tstats.first_search_value, tcfg)
    # The stored values come from searches that differ in float rounding:
    # copy JAX's float fields across so that everything after compares exactly.
    same_bits = treplay.Trajectory(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tbuf2, _ = ttrainer.ingest_segment(treplay.init_buffer(tcfg), None, same_bits, tstats.first_search_value, tcfg)
    assert_buffers_equal(jbuf, tbuf2)
    for a, b in zip(tprev, jprev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        tbuf.values.float().numpy(), np.asarray(jbuf.values.astype(jnp.float32)), rtol=2.0**-7, atol=1e-4
    )

    jopt, topt = jlearner.create_optimizer(jcfg), tlearner.create_optimizer(tcfg)
    jts = jlearner.TrainState(jnet.params, jopt.init(jnet.params), jnp.int32(0))
    tts = tlearner.TrainState(tnet, topt.init(list(tnet.parameters())))
    for step in range(3):
        jbatch, jidx, jw = jreplay.sample_batch(jbuf, jax.random.PRNGKey(step), jcfg.batch_size, jcfg)
        tidx = torch.from_numpy(np.array(jidx))
        tbatch, tw = treplay.gather_batch(tbuf2, tidx, tcfg)
        np.testing.assert_array_equal(tbatch.observations.numpy(), np.asarray(jbatch.observations))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
        jts, jloss, jprio = jlearner.train_step(jts, jnet.apply_fns, jbatch, jw, jcfg, jopt)
        tts, tloss, tprio = tlearner.train_step(tts, tbatch, tw, tcfg, topt)
        for name in tloss._fields:
            np.testing.assert_allclose(
                float(getattr(tloss, name)), float(getattr(jloss, name)), rtol=1e-4, atol=1e-6, err_msg=name
            )
        np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), rtol=1e-4, atol=1e-6)
        jbuf = jreplay.update_priorities(jbuf, jidx, jprio)
        tbuf2 = treplay.update_priorities(tbuf2, tidx, torch.from_numpy(np.array(jprio)))
    assert_params_match(jts.params, tts, tcfg)
    assert_buffers_equal(jbuf, tbuf2)


def test_ingest_segment_backfills_like_jax():
    """Two consecutive segments of the same lanes: the second re-grounds the first."""
    jcfg, tcfg, jnet, tnet = make_pair(
        max_trajectory_length=6, cross_segment_backfill=True, value_target_mode="td_lambda", td_lambda=1.0
    )

    def segment(seed):
        b, t = 4, 6
        rs = np.random.RandomState(seed)
        arrays = dict(
            boards=rs.randint(0, 9, size=(b, t + 1, 16)).astype(np.int8),
            actions=rs.randint(0, 4, size=(b, t)).astype(np.int8),
            rewards=(rs.rand(b, t) * 64).astype(np.float32),
            policies=rs.dirichlet([1.0] * 4, size=(b, t)).astype(np.float32),
            values=(rs.rand(b, t) * 900).astype(np.float32),
            priorities=rs.rand(b, t).astype(np.float32),
            length=np.full(b, t, dtype=np.int32),
            terminated=np.array([False, True, False, False]),
            total_reward=(rs.rand(b) * 100).astype(np.float32),
            max_tile=np.full(b, 64, dtype=np.int32),
        )
        return (jreplay.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                treplay.Trajectory(**{k: torch.from_numpy(v) for k, v in arrays.items()}))

    nu0 = (np.random.RandomState(0).rand(4) * 900).astype(np.float32)
    jbuf, tbuf = jreplay.init_buffer(jcfg), treplay.init_buffer(tcfg)
    jprev = tprev = None
    for seed in (1, 2):
        jtraj, ttraj = segment(seed)
        jbuf, jprev = jtrainer.ingest_segment(jbuf, jprev, jtraj, jnp.asarray(nu0), jcfg)
        tbuf, tprev = ttrainer.ingest_segment(tbuf, tprev, ttraj, torch.from_numpy(nu0), tcfg)
    first = np.asarray(jbuf.values[:4].astype(jnp.float32))
    assert not np.array_equal(first[0], np.asarray(segment(1)[0].values[0])), "the truncated lane was patched"
    np.testing.assert_allclose(tbuf.values.float().numpy(), np.asarray(jbuf.values.astype(jnp.float32)), rtol=2.0**-8)
    np.testing.assert_allclose(
        tbuf.step_priorities.float().numpy(), np.asarray(jbuf.step_priorities.astype(jnp.float32)), rtol=2.0**-8
    )
    for a, b in zip(tprev, jprev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


SMALL = [
    "--set", "num_simulations=4", "--set", "eval_games=2", "--set", "eval_max_moves=10", "--set", "min_buffer_size=8",
    "--set", "num_parallel_games=8", "--set", "max_trajectory_length=12", "--set", "replay_buffer_size=64",
    "--set", "batch_size=8", "--set", "value_bins=16", "--set", "reward_bins=8", "--set", "eval_interval=10",
    "--set", "checkpoint_interval=10", "--set", "generation_interval=5", "--set", "log_interval=5",
    "--set", "hidden_size=32", "--set", "checkpoint_buffer=True", "--set", "cross_segment_backfill=True",
]  # fmt: skip


def test_train_cli_runs_resumes_and_evaluate_loads(tmp_path, capsys):
    """``train --mode tiny --steps 20`` to its final evaluation, a resumed run
    from its checkpoint, and ``evaluate --checkpoint-dir`` on the result."""
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    args = ["--mode", "tiny", "--steps", "20", "--device", "cpu", "--checkpoint-dir", ckpt, "--log-dir", logs, *SMALL]
    trainer = train.main(args)
    out = capsys.readouterr().out
    assert "final evaluation:" in out and "step 20:" in out and "eval @ 20" in out
    assert trainer.state.step == 20 and CheckpointManager(ckpt).all_steps() == [10, 20]
    config = load_train_config(ckpt)
    assert config == trainer.config and config.value_bins == 16 and config.temperature_schedule[0] == (0, 1.0)
    records = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert any("gen/positions" in r for r in records) and any("eval/mean_reward" in r for r in records)
    losses = [r for r in records if "total_loss" in r]
    assert len(losses) == 4 and all(np.isfinite(r["total_loss"]) for r in losses)
    trained = [p.detach().clone() for p in trainer.state.params]
    buffer_size = int(trainer.buffer.size)

    resumed = train.main([*args[:3], "3", *args[4:], "--no-eval"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 20" in out and f"resumed replay buffer with {buffer_size} episodes" in out
    assert "final evaluation:" not in out
    assert resumed.state.step == 23 and resumed.state.opt_state["count"] == 23
    assert any(not torch.equal(a, b) for a, b in zip(trained, resumed.state.params))

    evaluate.main(["--checkpoint-dir", ckpt, "--device", "cpu", "--games", "2", "--step", "20"])
    out = capsys.readouterr().out
    assert "loaded checkpoint step 20" in out and "games: 2" in out
    with pytest.raises(SystemExit):
        evaluate.main(["--checkpoint-dir", ckpt, "--device", "cpu", "--step", "7"])


def test_fill_buffer_logs_no_gen_rows_like_jax(tmp_path):
    """The warm-up segments of ``fill_buffer`` log nothing, in both packages:
    after it and one loop step the log holds one ``gen/`` row, at step 0,
    the loop's first segment."""
    overrides = dict(hidden_size=16, num_residual_blocks=1, num_simulations=2, search_max_depth=2, num_parallel_games=2,
                     max_trajectory_length=4, min_buffer_size=6, batch_size=4, replay_buffer_size=16,
                     generation_interval=4, log_interval=1, checkpoint_interval=100, eval_interval=100)  # fmt: skip
    trainer = ttrainer.Trainer(dataclasses.replace(tiny_config(), **overrides), log_dir=str(tmp_path / "torch"),
                               device="cpu")  # fmt: skip
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    assert int(trainer.buffer.size) == 6 and not trainer.get_metrics_history()
    trainer.train(1, verbose=False)
    trainer.metrics.close()

    from simulate_2048_tpu.training import config as jconfig

    jtrainer_ = jtrainer.Trainer(dataclasses.replace(jconfig.tiny_config(), **overrides), log_dir=str(tmp_path / "jax"))
    jtrainer_.initialize()
    jtrainer_.fill_buffer(verbose=False)
    jtrainer_.train(1, verbose=False)
    jtrainer_.metrics.close()
    for package in ("torch", "jax"):
        rows = [json.loads(line) for line in open(tmp_path / package / "metrics.jsonl")]
        gen = [r for r in rows if any(k.startswith("gen/") for k in r)]
        assert [r["step"] for r in gen] == [0], package
        assert int(gen[0]["gen/completed_games"]) >= 0 and [r["step"] for r in rows if "total_loss" in r] == [1]


def test_checkpoint_round_trip_is_exact(tmp_path):
    config = dataclasses.replace(tiny_config(), hidden_size=32, value_bins=16, reward_bins=8, num_parallel_games=4,
                                 max_trajectory_length=8, min_buffer_size=4, batch_size=4, replay_buffer_size=16,
                                 num_simulations=3, checkpoint_buffer=True, warmup_steps=1)
    trainer = ttrainer.Trainer(config, checkpoint_dir=str(tmp_path), seed=3, device="cpu")
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    for _ in range(2):
        trainer.optimize_step()
    trainer._save_checkpoint()
    manager = CheckpointManager(str(tmp_path))
    assert manager.latest_step() == 2

    other = ttrainer.Trainer(config, checkpoint_dir=str(tmp_path), seed=99, device="cpu")
    other.initialize()
    assert other.state.step == 2 and other.state.opt_state["count"] == 2
    for a, b in zip(other.state.params, trainer.state.params):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        for a, b in zip(other.state.opt_state[name], trainer.state.opt_state[name]):
            assert torch.equal(a, b)
    for a, b in zip(other.buffer, trainer.buffer):
        assert torch.equal(a, b)
    for a, b in zip(other.gen_state, trainer.gen_state):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(other._prev, trainer._prev))
    # the same draws follow: the generator's state is part of the checkpoint
    assert torch.equal(treplay.sample_indices(other.buffer, other._generator, 8, config),
                       treplay.sample_indices(trainer.buffer, trainer._generator, 8, config))
    for keep in range(3, 9):
        manager.save(trainer.state, step=keep)
    assert manager.all_steps() == [4, 5, 6, 7, 8]
    assert CheckpointManager(str(tmp_path / "empty")).restore(trainer.state) is None


@pytest.mark.parametrize(
    "overrides",
    [
        # Ported since the search variants and bfloat16 search packs were: each case now checks that it runs.
        dict(root_selection="gumbel"),
        dict(chance_selection="sample"),
        dict(pw_c=1.0),
        dict(search_weight_dtype="bfloat16", search_backend="pallas"),
    ],
    # The ids these cases had while reanalyze_interval and deep_eval_interval were cases 0 and 1 of this list.
    ids=["overrides2-Gumbel", "overrides3-sampled chance", "overrides4-widening", "overrides5-bfloat16"],
)
def test_unported_options_raise(overrides):
    config = dataclasses.replace(tiny_config(), hidden_size=32, num_parallel_games=2, num_simulations=2,
                                 max_trajectory_length=4, **overrides)
    trainer = ttrainer.Trainer(config, device="cpu")
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    assert int(trainer.buffer.size) >= config.min_buffer_size


RECIPE = dict(hidden_size=32, value_bins=16, reward_bins=8, num_parallel_games=4, max_trajectory_length=8,
              min_buffer_size=8, batch_size=4, replay_buffer_size=16, num_simulations=3, checkpoint_buffer=True,
              warmup_steps=1, value_target_mode="td_lambda", td_lambda=1.0, cross_segment_backfill=True,
              generation_interval=4, log_interval=2, checkpoint_interval=4, eval_interval=100, eval_games=2,
              eval_max_moves=6, reanalyze_interval=2, reanalyze_episodes=3, reanalyze_mode="search",
              deep_eval_interval=4, deep_eval_games=3)  # fmt: skip


def recipe_trainer(tmp_path=None, seed=3, **overrides):
    config = dataclasses.replace(tiny_config(), **{**RECIPE, **overrides})
    directory = None if tmp_path is None else str(tmp_path)
    trainer = ttrainer.Trainer(config, checkpoint_dir=directory, seed=seed, device="cpu")
    trainer.initialize()
    return trainer


@pytest.mark.parametrize("mode", ["search", "value"])
def test_reanalyze_and_deep_eval_run_at_their_due_steps(tmp_path, mode):
    """Eight steps of the recipe's loop: a reanalyze pass before steps 2, 4 and
    6 (never before step 0), a deep evaluation after steps 4 and 8, the
    champion in best/, and a resume that restores the cursor and the best mean."""
    trainer = recipe_trainer(tmp_path, reanalyze_mode=mode)
    assert trainer.fused_chunk(trainer.config.generation_interval) == 2
    trainer.fill_buffer(verbose=False)
    trainer.train(8, verbose=False)
    history = trainer.get_metrics_history()
    assert [r["step"] for r in history if "reanalyze/seconds" in r] == [2, 4, 6]
    deep = [r for r in history if "deep_eval/mean_reward" in r]
    assert [r["step"] for r in deep] == [4, 8] and all(r["deep_eval/seconds"] > 0 for r in deep)
    assert trainer._reanalyze_cursor == (3 * 3) % int(trainer.buffer.size)  # three passes of three rows, wrapped
    in_ep = torch.arange(8)[None] < trainer.buffer.length[:, None]
    sums = trainer.buffer.policies.float().sum(-1)
    np.testing.assert_allclose(sums.numpy(), in_ep.float().numpy(), atol=2e-3)

    best_mean, best_step = trainer._best_deep_eval
    assert best_mean == max(r["deep_eval/mean_reward"] for r in deep)
    best = CheckpointManager(str(tmp_path / "best"))
    assert best.all_steps() == [best_step] and load_train_config(str(tmp_path / "best")) == trainer.config
    record = json.load(open(tmp_path / "deep_eval_best.json"))
    assert set(record) == {"step", "mean_reward", "sem_reward", "games", "max_tile"}
    assert record["step"] == best_step and record["mean_reward"] == best_mean and record["games"] == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 8]  # best/ is no step of the run's own

    resumed = recipe_trainer(tmp_path, seed=99, reanalyze_mode=mode)
    assert resumed.state.step == 8 and resumed._reanalyze_cursor == trainer._reanalyze_cursor
    assert resumed._best_deep_eval == (best_mean, best_step)
    resumed._best_deep_eval = (1e9, 1)  # a champion no evaluation beats: best/ stays as it is
    resumed.deep_evaluate(9, verbose=False)
    assert CheckpointManager(str(tmp_path / "best")).all_steps() == [best_step]
    assert json.load(open(tmp_path / "deep_eval_best.json")) == record


def test_deep_evaluations_play_the_same_games_and_draw_nothing(tmp_path):
    """Equal weights, equal games: two deep evaluations agree in every
    statistic, whatever the trainer drew in between, and a run with deep
    evaluation generates the self-play a run without it generates."""
    trainer = recipe_trainer(tmp_path, reanalyze_interval=None)
    state = trainer._generator.get_state()
    first = trainer.deep_evaluate(0, verbose=False)
    assert torch.equal(trainer._generator.get_state(), state)
    inline = trainer.evaluate(3)  # draws its run seed from the trainer's generator
    assert not torch.equal(trainer._generator.get_state(), state)
    second = trainer.deep_evaluate(0, verbose=False)
    assert first == second
    assert inline["mean_length"] > 0
    other_seed = recipe_trainer(seed=4, reanalyze_interval=None).deep_evaluate(0, verbose=False)
    assert other_seed != first  # the games follow the run's seed

    runs = []
    for interval in (4, None):
        run = recipe_trainer(reanalyze_interval=None, deep_eval_interval=interval)
        run.fill_buffer(verbose=False)
        run.train(8, verbose=False)
        runs.append(run)
    with_deep, without = runs
    assert any("deep_eval/mean_reward" in r for r in with_deep.get_metrics_history())
    assert not any("deep_eval/mean_reward" in r for r in without.get_metrics_history())
    assert with_deep._best_deep_eval is None  # no checkpoint directory: nothing to select into
    for name, a, b in zip(with_deep.buffer._fields, with_deep.buffer, without.buffer):
        assert torch.equal(a, b), name
    for a, b in zip(with_deep.state.params, without.state.params):
        assert torch.equal(a, b)


def test_host_intervals_off_the_log_interval_go_step_by_step():
    trainer = recipe_trainer(reanalyze_interval=3)
    assert trainer.fused_chunk(trainer.config.generation_interval) is None
    trainer = recipe_trainer(deep_eval_interval=5)
    assert trainer.fused_chunk(trainer.config.generation_interval) is None
    trainer = recipe_trainer(reanalyze_interval=None, deep_eval_interval=None)
    assert trainer.fused_chunk(trainer.config.generation_interval) == 2
    trainer.reanalyze_if_due(4)  # no interval, no pass
    assert trainer._reanalyze_cursor == 0


def test_training_entry_points_need_a_gpu_or_ask_for_cpu():
    # Data parallelism is ported: a mesh must be a parallel.Mesh, and a trainer over one runs on its first device.
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ttrainer.Trainer(tiny_config(), mesh=object(), device="cpu")
    assert ttrainer.Trainer(tiny_config(), mesh=make_mesh(["cpu"] * 2)).device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the no-GPU behaviour is checked on CPU-only machines")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", "tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", "tiny", "--data-parallel", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.train_muzero(tiny_config(), num_steps=1)

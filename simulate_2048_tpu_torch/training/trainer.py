"""Trainer: buffer fill → (generate / sample / train / log / checkpoint /
eval) orchestration, in PyTorch (port of the JAX package's
``training/trainer.py``).

Replay lives on the device; self-play generation plays one segment per call
through the whole-search kernel; priorities are refreshed after every step
from the learner's TD errors; the periodic reanalyze pass
(``reanalyze_interval``) refreshes stored targets and deep evaluation
(``deep_eval_interval``) selects the champion checkpoint in
``<checkpoint_dir>/best``. With a ``mesh`` (``parallel.make_mesh``) the
learner runs data-parallel over it (``parallel/dp.py``: a replica per mesh
device, one ring all-reduce launch per step); self-play, reanalyze and
evaluation stay on the mesh's first device.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from simulate_2048_tpu_torch.device import resolve_device
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import MuZeroNetwork
from simulate_2048_tpu_torch.ops import rng
from simulate_2048_tpu_torch.parallel.dp import DataParallelTrainStep, make_dp_train_step, make_dp_train_superstep
from simulate_2048_tpu_torch.parallel.mesh import Mesh
from simulate_2048_tpu_torch.training import replay as replay_lib
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager, load_train_config
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.learner import (
    TrainState,
    create_optimizer,
    create_train_state,
    train_step,
    train_superstep,
)
from simulate_2048_tpu_torch.training.losses import LossOutput
from simulate_2048_tpu_torch.training.reanalyze import reanalyze_pass
from simulate_2048_tpu_torch.training.self_play import _draw_seed, evaluate_games, finish_gen_stats, generate_games
from simulate_2048_tpu_torch.utils.metrics import MetricsLogger


def ingest_segment(buffer, prev, traj, first_search_value, config):
    """Insert one generated segment batch into ``buffer``.

    With ``config.cross_segment_backfill``, the previous segments of
    continuing games are first re-grounded with this batch's openings
    (``replay.backfill_returns``).

    ``prev`` is the ``(slots, cont, seq)`` bookkeeping returned by the
    previous call for the same set of game lanes (None on the first segment,
    or when continuity was broken). ``first_search_value`` (B,) are the raw
    search values ν at this segment's first positions
    (``GenStats.first_search_value``).

    Returns ``(buffer, (slots, cont, seq))``: thread the second element back
    in as ``prev`` with the next consecutive segment batch.
    """
    b = traj.length.shape[0]
    if config.cross_segment_backfill and prev is not None:
        prev_slots, prev_cont, prev_seq = prev
        buffer = replay_lib.backfill_returns(
            buffer, prev_slots, prev_cont, prev_seq, first_search_value, traj.values[:, 0], config
        )
    lanes = torch.arange(b, device=buffer.length.device)
    slots = (buffer.write_pos + lanes) % buffer.length.shape[0]
    seq = buffer.episodes_added + lanes
    buffer = replay_lib.add_trajectories(buffer, traj)
    return buffer, (slots, ~traj.terminated, seq)


# Salt of the deep-evaluation games' seed: they depend on the run's seed alone.
DEEP_EVAL_SALT = 0xD2EE


@dataclass
class Trainer:
    """Actor-learner loop on one device (``device``: CUDA unless the caller
    asks for the CPU), the learner data-parallel over ``mesh`` when one is
    given (the trainer then runs on the mesh's first device)."""

    config: TrainConfig
    checkpoint_dir: str | None = None
    log_dir: str | None = None
    seed: int | None = None
    mesh: Mesh | None = None
    device: torch.device | str | None = None

    state: TrainState = field(init=False, default=None)
    network: MuZeroNetwork = field(init=False, default=None)
    buffer: replay_lib.BufferState = field(init=False, default=None)
    metrics: MetricsLogger = field(init=False, default=None)
    # Persistent self-play games: generation plays segments that continue across calls.
    gen_state: envlib.GameState = field(init=False, default=None)

    def __post_init__(self):
        if self.mesh is not None:
            if not isinstance(self.mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, not {type(self.mesh).__name__}")
            first = self.mesh.devices[0]
            if self.device is not None and resolve_device(self.device) != first:
                raise ValueError(f"a trainer over a mesh runs on the mesh's first device, {first}")
            self.device = first
        self.device = resolve_device(self.device)
        # Every draw but the initial weights' (run seeds, root noise, action
        # and replay sampling) comes from the device's generator.
        self._generator = torch.Generator(device=self.device).manual_seed(self._seed() + 1)
        self._optimizer = create_optimizer(self.config)
        self._ckpt = CheckpointManager(self.checkpoint_dir) if self.checkpoint_dir else None
        self.metrics = MetricsLogger(self.log_dir)
        # Previous generation's buffer rows (cross_segment_backfill bookkeeping).
        self._prev: tuple | None = None
        # Round-robin position of the reanalyze pass over the buffer (training/reanalyze.py).
        self._reanalyze_cursor = 0
        # Best deep evaluation so far, (mean_reward, step): champion
        # checkpoints are selected by deep evaluation, not by the inline curve.
        self._best_deep_eval: tuple[float, int] | None = None
        self._best_ckpt: CheckpointManager | None = None
        # The data-parallel learner (built at its first use): one step, shared by the superstep.
        self._dp_step: DataParallelTrainStep | None = None
        self._dp_superstep = None

    def _seed(self) -> int:
        return self.seed if self.seed is not None else self.config.seed

    def initialize(self) -> None:
        """Create state + buffer; resume from the latest checkpoint if there is one."""
        # JAX's initial weights for the seed: its first ``_next_key()``, ``split(PRNGKey(seed))[1]``.
        init_key = rng.split(rng.prng_key(self._seed()))[1]
        self.state, self.network = create_train_state(self.config, init_key, self.device)
        self.buffer = replay_lib.init_buffer(self.config, self.device)
        self.gen_state = envlib.reset_batch(_draw_seed(self._generator), self.config.num_parallel_games, self.device)
        if self._ckpt is None:
            return
        # The sidecar lets the eval CLI rebuild this exact config from the
        # checkpoint directory. Never clobber a differing recorded sidecar:
        # earlier checkpoints in this directory were trained under it.
        recorded = load_train_config(self._ckpt.directory)
        if recorded is not None and recorded != self.config:
            print(
                f"warning: {self._ckpt.directory}/train_config.json records a different config than "
                "this run; keeping the recorded sidecar (earlier checkpoints were trained with it)"
            )
        else:
            self._ckpt.save_config(self.config)
        if self._ckpt.restore(self.state) is None:
            return
        print(f"resumed from checkpoint at step {self.state.step}")
        buffer_restored = False
        if self.config.checkpoint_buffer:
            buf = self._ckpt.restore_buffer(self.buffer)
            if buf is not None:
                self.buffer = buf
                buffer_restored = True
                print(f"resumed replay buffer with {int(buf.size)} episodes")
        runtime = self._ckpt.restore_runtime(self.device)
        if runtime is not None:
            self.gen_state = envlib.GameState(**runtime["gen_state"])
            self._generator.set_state(runtime["generator_state"].cpu())
            # Backfill rows index into the buffer: only valid when the
            # experience they point at was restored alongside them.
            if buffer_restored and runtime["prev"] is not None:
                self._prev = tuple(runtime["prev"])
            # The cursor indexes into the buffer too. Checkpoints written
            # before these keys existed lack them.
            if buffer_restored:
                self._reanalyze_cursor = int(runtime.get("reanalyze_cursor", 0))
            # Champion selection: without it a resume would forget the best
            # deep evaluation, and the first one after it would overwrite
            # best/ even with a lower score.
            if runtime.get("has_best_deep_eval", False):
                self._best_deep_eval = (float(runtime["best_deep_eval_mean"]), int(runtime["best_deep_eval_step"]))

    def _require_initialized(self) -> None:
        if self.state is None:
            raise RuntimeError("call initialize() first")

    def _runtime_payload(self) -> dict:
        """Small trainer-loop state persisted with each checkpoint: the
        carried self-play games, the pending cross-segment-backfill rows, the
        generator's state, the reanalyze cursor and the best deep evaluation.
        Without it a resume would restart all games in flight, drop the
        pending re-grounding and forget the champion."""
        best = self._best_deep_eval
        return {
            "gen_state": self.gen_state._asdict(),
            "prev": self._prev,
            "generator_state": self._generator.get_state(),
            "reanalyze_cursor": self._reanalyze_cursor,
            "has_best_deep_eval": best is not None,
            "best_deep_eval_mean": best[0] if best else 0.0,
            "best_deep_eval_step": best[1] if best else 0,
        }

    def _save_checkpoint(self) -> None:
        self._ckpt.save(
            self.state,
            buffer=self.buffer if self.config.checkpoint_buffer else None,
            runtime=self._runtime_payload(),
        )

    def _generate(self, step: int, log: bool = True) -> float:
        """Play one segment of every game and ingest it; with ``log``, log its
        diagnostics under ``gen/``. Returns the segment's seconds."""
        t0 = time.perf_counter()
        self.gen_state, traj, gen_stats = generate_games(
            self.network, self._generator, self.config, step, env_state=self.gen_state
        )
        self.buffer, self._prev = ingest_segment(
            self.buffer, self._prev, traj, gen_stats.first_search_value, self.config
        )
        record = finish_gen_stats(gen_stats, traj)  # reads from the device: the segment is complete
        seconds = time.perf_counter() - t0
        if log:
            self.metrics.log({"step": step, **record, "gen/seconds": seconds})
        return seconds

    def fill_buffer(self, verbose: bool = True) -> None:
        """Self-play until the buffer holds ``min_buffer_size`` episodes. As
        in the JAX package, these segments log no ``gen/`` row: the first is
        the training loop's, at its first step. ``verbose`` prints each
        segment's seconds."""
        self._require_initialized()
        while int(self.buffer.size) < self.config.min_buffer_size:
            seconds = self._generate(self.state.step, log=False)
            if verbose:
                print(f"buffer: {int(self.buffer.size)}/{self.config.min_buffer_size} ({seconds:.2f} s)")

    def train(self, num_steps: int | None = None, verbose: bool = True) -> dict[str, Any]:
        """Main loop; always persists the latest state on the way out."""
        self._require_initialized()
        start_step = self.state.step
        end_step = start_step + (num_steps if num_steps is not None else self.config.training_steps)
        try:
            return self._train_loop(start_step, end_step, verbose)
        finally:
            if self._ckpt is not None:
                self._save_checkpoint()

    def fused_chunk(self, *extra_intervals: int) -> int | None:
        """Chunk size (one log interval) when every host-hook interval is a
        multiple of it, else None: generation, checkpoint, evaluation,
        reanalyze and deep evaluation must land on chunk boundaries, otherwise
        the loop goes step by step."""
        cfg = self.config
        chunk = max(cfg.log_interval, 1)
        host_intervals = [cfg.checkpoint_interval, cfg.eval_interval, *extra_intervals]
        host_intervals += [i for i in (cfg.reanalyze_interval, cfg.deep_eval_interval) if i is not None]
        return chunk if all(i % chunk == 0 for i in host_intervals) else None

    def _train_fn(self, batch, weights):
        """One optimization step: data-parallel over the mesh when one is set."""
        if self.mesh is None:
            return train_step(self.state, batch, weights, self.config, self._optimizer)
        return self._data_parallel_step()(self.state, batch, weights)

    def _data_parallel_step(self) -> DataParallelTrainStep:
        if self._dp_step is None:
            self._dp_step = make_dp_train_step(self.network, self.config, self._optimizer, self.mesh)
        return self._dp_step

    def optimize_chunk(self, chunk: int) -> LossOutput:
        """``chunk`` optimizer steps (sample, step, priority update); returns
        their mean losses. Data-parallel over the mesh when one is set."""
        if self.mesh is None:
            self.state, self.buffer, loss_output = train_superstep(
                self.state, self.buffer, self._generator, self.config, self._optimizer, chunk
            )
            return loss_output
        if self._dp_superstep is None:
            self._dp_superstep = make_dp_train_superstep(
                self.network, self.config, self._optimizer, self.mesh, chunk, train_step=self._data_parallel_step()
            )
        self.state, self.buffer, loss_output = self._dp_superstep(self.state, self.buffer, self._generator)
        return loss_output

    def optimize_step(self) -> LossOutput:
        """One sample → train → priority-update step."""
        cfg = self.config
        batch, indices, weights = replay_lib.sample_batch(self.buffer, self._generator, cfg.batch_size, cfg)
        self.state, loss_output, priorities = self._train_fn(batch, weights)
        self.buffer = replay_lib.update_priorities(self.buffer, indices, priorities)
        return loss_output

    def reanalyze_if_due(self, step: int) -> None:
        """Run the periodic reanalyze pass when ``step`` lands on it."""
        cfg = self.config
        if cfg.reanalyze_interval is None or step % cfg.reanalyze_interval != 0 or step == 0:
            return
        t0 = time.perf_counter()
        self.buffer, self._reanalyze_cursor = reanalyze_pass(
            self.buffer, self.network, self._reanalyze_cursor, cfg, self._generator
        )
        # The pass is still queued on the device when reanalyze_pass returns: wait, so that the seconds are its own.
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.log({"step": step, "reanalyze/seconds": time.perf_counter() - t0})

    def run_host_hooks(self, step: int, verbose: bool = True) -> None:
        """Periodic inline evaluation, deep evaluation and checkpoint. The
        checkpoint comes last, so that one written at a deep evaluation's
        step carries that evaluation's champion in its runtime payload."""
        cfg = self.config
        if step % cfg.eval_interval == 0:
            stats = self.evaluate()
            self.metrics.log({"step": step, **{f"eval/{k}": v for k, v in stats.items()}})
            if verbose:
                print(f"eval @ {step}: reward {stats['mean_reward']:.1f} max tile {stats['max_tile']}")
        if cfg.deep_eval_interval is not None and step % cfg.deep_eval_interval == 0:
            self.deep_evaluate(step, verbose=verbose)
        if self._ckpt is not None and step % cfg.checkpoint_interval == 0:
            self._save_checkpoint()

    def _train_loop(self, start_step: int, end_step: int, verbose: bool) -> dict[str, Any]:
        cfg = self.config
        final_loss: dict[str, Any] = {}
        step = start_step
        last_log_time, last_log_step = time.perf_counter(), start_step
        chunk_or_none = self.fused_chunk(cfg.generation_interval)
        fused = chunk_or_none is not None
        chunk = chunk_or_none if fused else max(cfg.log_interval, 1)
        while step < end_step:
            # freeze_data_after: stop generating new self-play data past this step.
            frozen = cfg.freeze_data_after is not None and step >= cfg.freeze_data_after
            if step % cfg.generation_interval == 0 and not frozen:
                self._generate(step)

            self.reanalyze_if_due(step)

            if fused and end_step - step >= chunk:
                loss_output = self.optimize_chunk(chunk)
                step += chunk
            else:
                loss_output = self.optimize_step()
                step += 1

            if step % cfg.log_interval == 0:
                losses = {name: float(value) for name, value in loss_output._asdict().items()}  # waits for the device
                now = time.perf_counter()
                sps = (step - last_log_step) / max(now - last_log_time, 1e-9)
                last_log_time, last_log_step = now, step
                final_loss = {"step": step, **losses, "steps_per_s": sps, "buffer_size": int(self.buffer.size)}
                self.metrics.log(final_loss)
                if verbose:
                    print(
                        f"step {step}: loss {losses['total_loss']:.4f} "
                        f"(p {losses['policy_loss']:.3f} v {losses['value_loss']:.3f} "
                        f"r {losses['reward_loss']:.3f} c {losses['chance_loss']:.3f}) {sps:.1f} steps/s"
                    )

            self.run_host_hooks(step, verbose=verbose)
        return final_loss

    def evaluate(self, num_games: int | None = None) -> dict[str, Any]:
        """Greedy evaluation games with the current weights."""
        return evaluate_games(self.network, self._generator, self.config, num_games)

    def deep_evaluate(self, step: int, verbose: bool = True) -> dict[str, Any]:
        """``deep_eval_games`` greedy games at a decision point, logged under
        ``deep_eval/``. When the mean beats the best so far, the state is
        saved into ``<checkpoint_dir>/best`` and recorded in
        ``deep_eval_best.json``.

        The games are the same at every call: their run seed comes from a
        generator seeded from (the run's seed, a fixed salt) anew each time,
        not from the trainer's generator. So the deep evaluations of a run
        and of its resumes compare weights, not draws of games, and running
        them changes nothing in the self-play that follows. The inline
        :meth:`evaluate` keeps fresh seeds.
        """
        cfg = self.config
        t0 = time.perf_counter()
        games = torch.Generator().manual_seed((self._seed() << 16) ^ DEEP_EVAL_SALT)
        stats = evaluate_games(self.network, games, cfg, cfg.deep_eval_games)
        seconds = time.perf_counter() - t0
        record = {f"deep_eval/{k}": v for k, v in stats.items()}
        self.metrics.log({"step": step, **record, "deep_eval/seconds": seconds})
        if verbose:
            print(
                f"deep eval @ {step} (n={cfg.deep_eval_games}): reward {stats['mean_reward']:.1f} "
                f"± sem {stats['sem_reward']:.1f}, max tile {stats['max_tile']}",
                flush=True,
            )
        if self._ckpt is not None and (self._best_deep_eval is None or stats["mean_reward"] > self._best_deep_eval[0]):
            self._best_deep_eval = (stats["mean_reward"], step)
            if self._best_ckpt is None:
                self._best_ckpt = CheckpointManager(os.path.join(self._ckpt.directory, "best"), max_to_keep=1)
                self._best_ckpt.save_config(cfg)
            self._best_ckpt.save(self.state, step=step)
            best = {
                "step": step,
                "mean_reward": stats["mean_reward"],
                "sem_reward": stats["sem_reward"],
                "games": cfg.deep_eval_games,
                "max_tile": stats["max_tile"],
            }
            with open(os.path.join(self._ckpt.directory, "deep_eval_best.json"), "w") as f:
                json.dump(best, f, indent=1)
        return stats

    def get_metrics_history(self) -> list[dict[str, Any]]:
        return self.metrics.history

    def get_buffer_stats(self) -> dict[str, Any]:
        return replay_lib.get_statistics(self.buffer)


def train_muzero(
    config: TrainConfig | None = None,
    checkpoint_dir: str | None = None,
    num_steps: int | None = None,
    seed: int | None = None,
    device: torch.device | str | None = None,
    log_dir: str | None = None,
) -> Trainer:
    """Convenience entry point: initialise, fill the buffer, train."""
    trainer = Trainer(
        config or TrainConfig(), checkpoint_dir=checkpoint_dir, log_dir=log_dir, seed=seed, device=device
    )
    trainer.initialize()
    trainer.fill_buffer()
    trainer.train(num_steps)
    return trainer

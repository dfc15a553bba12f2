"""Asynchronous actor/learner runtime: separate processes, overlapped work
(port of the JAX package's ``parallel/actor_learner.py``).

- **Actor processes** own their device, run self-play
  (``training/self_play.generate_games``) and stream finished trajectory
  batches to the learner.
- **The learner process** inserts arriving trajectories into its replay
  buffer on the device, optimizes continuously (it never generates games),
  and publishes refreshed parameters that actors pull between generations.

Transport is a length-prefixed pickle channel over TCP carrying numpy trees
(tensors leave the device before they are sent and are placed on the
receiver's device on arrival): the host-side counterpart of the synchronous
data-parallel path (``parallel/dp.py``). The channel is for co-scheduled
processes of one job; do not expose the port beyond the cluster.
"""

from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.training import replay as replay_lib
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.self_play import GenStats, finish_gen_stats, generate_games
from simulate_2048_tpu_torch.training.trainer import Trainer, ingest_segment

__all__ = ["LearnerServer", "ActorClient", "connect_with_retry"]

_LEN = struct.Struct("!Q")


# ---------------------------------------------------------------------------
# framing


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Any | None:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    body = _recv_exact(sock, _LEN.unpack(header)[0])
    if body is None:
        return None
    return pickle.loads(body)


def _to_numpy(tree: Any) -> Any:
    """Tensors of a list or named tuple as numpy arrays (on the host), always
    copies: a CPU tensor's ``numpy()`` shares its storage, and a parameter
    snapshot that shared it would change under the optimizer's in-place steps."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(x) for x in tree)
    return tree


def _to_torch(cls, arrays, device: torch.device):
    """A named tuple ``cls`` of tensors on ``device`` from its numpy fields."""
    return cls(*(torch.from_numpy(np.asarray(x)).to(device) for x in arrays))


def connect_with_retry(address: tuple[str, int], timeout_s: float = 30.0) -> socket.socket:
    """Dial the learner, retrying while it boots."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return socket.create_connection(address)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


# ---------------------------------------------------------------------------
# learner side


class LearnerServer:
    """Wraps a :class:`Trainer` whose self-play is outsourced to actors.

    The server thread accepts actor connections; each connection thread
    enqueues arriving trajectory batches and answers parameter pulls with
    the most recently published snapshot. The training loop (:meth:`run`)
    drains the queue into the replay buffer between optimization steps: the
    learner itself never generates games.
    """

    def __init__(
        self,
        trainer: Trainer,
        host: str = "127.0.0.1",
        port: int = 0,
        param_sync_interval: int | None = None,
    ):
        if trainer.state is None:
            raise RuntimeError("call trainer.initialize() first")
        self.trainer = trainer
        self.param_sync_interval = param_sync_interval or trainer.config.generation_interval
        self._traj_queue: queue.Queue = queue.Queue(maxsize=256)
        # Per-actor cross-segment-backfill bookkeeping: actor_id -> (the
        # ``prev`` of ingest_segment for that actor's previous batch, its generation).
        self._prev_by_actor: dict[Any, tuple] = {}
        self._params_lock = threading.Lock()
        self._latest_params: tuple[int, Any] | None = None
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self.trajectories_received = 0
        self.trajectories_dropped = 0
        self.params_served = 0
        self.last_run_fused = False
        self._connections = 0  # live actor connections, under the condition below
        self._connections_changed = threading.Condition()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.publish_params()

    # -- networking --------------------------------------------------------

    def start(self) -> "LearnerServer":
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_connection, args=(conn,), daemon=True).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        with self._connections_changed:
            self._connections += 1
        try:
            self._serve(conn)
        finally:
            with self._connections_changed:
                self._connections -= 1
                self._connections_changed.notify_all()

    def _serve(self, conn: socket.socket) -> None:
        # A misbehaving or dying actor never takes the server down: a
        # transport or decoding failure drops this connection only. A clean
        # disconnect in the middle of a message reads as None.
        try:
            with conn:
                while not self._stop.is_set():
                    msg = _recv_msg(conn)
                    if msg is None:
                        return
                    kind = msg.get("kind") if isinstance(msg, dict) else None
                    if kind == "trajectories":
                        self._enqueue(msg)
                        _send_msg(conn, {"kind": "ack"})
                    elif kind == "get_params":
                        with self._params_lock:
                            step, params = self._latest_params
                            self.params_served += 1
                        _send_msg(conn, {"kind": "params", "step": step, "payload": params})
                    else:
                        _send_msg(conn, {"kind": "error", "message": f"unknown kind {kind!r}"})
        except (OSError, EOFError, pickle.UnpicklingError, struct.error, ValueError):
            return  # connection-local failure; the accept loop keeps serving

    def _enqueue(self, payload: Any) -> None:
        """Queue a trajectory batch without ever blocking the serving thread:
        on a full queue the oldest batch is dropped (the freshest data wins;
        drops are counted in ``trajectories_dropped``)."""
        while True:
            try:
                self._traj_queue.put_nowait(payload)
                return
            except queue.Full:
                try:
                    self._traj_queue.get_nowait()
                    self.trajectories_dropped += 1
                except queue.Empty:
                    pass  # a drain raced us; retry the put

    # -- training ----------------------------------------------------------

    def publish_params(self) -> None:
        """Snapshot the current parameters for actor pulls (host numpy
        copies, so that serving threads never touch live device tensors)."""
        snapshot = _to_numpy(self.trainer.state.params)
        with self._params_lock:
            self._latest_params = (int(self.trainer.state.step), snapshot)

    def drain_queue(self, block_for_first: bool, timeout_s: float = 5.0) -> int:
        """Move queued trajectory batches into the replay buffer."""
        drained = 0
        while True:
            try:
                msg = self._traj_queue.get(block=block_for_first and drained == 0, timeout=timeout_s)
            except queue.Empty:
                break
            self._ingest_message(msg)
            self.trajectories_received += 1
            drained += 1
        return drained

    def _ingest_message(self, msg: Any) -> None:
        """One queued trajectory message into the replay buffer, through the
        trainer's own ingestion (``trainer.ingest_segment``), so that
        ``cross_segment_backfill`` behaves as in the synchronous trainer, and
        the segment's collection diagnostics are logged. Backfill runs only
        when the batch is the direct successor of the actor's previous one: a
        dropped batch or a restarted actor breaks the chain."""
        trainer = self.trainer
        device = trainer.device
        if not isinstance(msg, dict) or "gen_stats" not in msg:
            # A bare trajectory batch: plain insert, nothing to backfill with or log.
            arrays = msg["payload"] if isinstance(msg, dict) else msg
            traj = _to_torch(replay_lib.Trajectory, arrays, device)
            trainer.buffer = replay_lib.add_trajectories(trainer.buffer, traj)
            return
        traj = _to_torch(replay_lib.Trajectory, msg["payload"], device)
        stats = _to_torch(GenStats, msg["gen_stats"], device)
        actor, gen = msg.get("actor_id", 0), msg.get("generation")
        prev = None
        entry = self._prev_by_actor.get(actor)
        if entry is not None:
            prev_state, prev_gen = entry
            if gen is not None and prev_gen is not None and gen == prev_gen + 1:
                prev = prev_state
        trainer.buffer, new_prev = ingest_segment(trainer.buffer, prev, traj, stats.first_search_value, trainer.config)
        self._prev_by_actor[actor] = (new_prev, gen)
        trainer.metrics.log({"step": int(trainer.state.step), "actor_id": actor, **finish_gen_stats(stats, traj)})

    def fill_buffer(self, timeout_s: float = 300.0, verbose: bool = True) -> None:
        """Wait for the actors to deliver ``min_buffer_size`` episodes."""
        cfg = self.trainer.config
        deadline = time.monotonic() + timeout_s
        while int(self.trainer.buffer.size) < cfg.min_buffer_size:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replay buffer still at {int(self.trainer.buffer.size)}/{cfg.min_buffer_size} episodes after "
                    f"{timeout_s:.0f}s: are actors running?"
                )
            if self.drain_queue(block_for_first=True, timeout_s=1.0) and verbose:
                print(f"buffer: {int(self.trainer.buffer.size)}/{cfg.min_buffer_size}", flush=True)

    def run(self, num_steps: int, verbose: bool = True) -> dict[str, float]:
        """Optimize for ``num_steps``: the trainer's loop with self-play
        replaced by actor ingestion, otherwise the same machinery: fused
        supersteps (``trainer.optimize_chunk``, data-parallel over the
        trainer's mesh when it has one) whenever the host-hook intervals land
        on the log interval, the periodic reanalyze pass, checkpoint, inline
        and deep evaluation (``trainer.run_host_hooks``), and a final
        checkpoint. Queue drains and parameter publication happen at chunk
        boundaries."""
        trainer, cfg = self.trainer, self.trainer.config
        start = int(trainer.state.step)
        end = start + num_steps
        final: dict[str, float] = {}
        last_t, last_s = time.perf_counter(), start
        chunk_or_none = trainer.fused_chunk(self.param_sync_interval)
        self.last_run_fused = fused = chunk_or_none is not None
        chunk = chunk_or_none if fused else max(cfg.log_interval, 1)
        step = start
        try:
            while step < end:
                self.drain_queue(block_for_first=False)
                trainer.reanalyze_if_due(step)

                if fused and end - step >= chunk:
                    loss_output = trainer.optimize_chunk(chunk)
                    step += chunk
                else:
                    loss_output = trainer.optimize_step()
                    step += 1

                if step % self.param_sync_interval == 0:
                    self.publish_params()

                if step % cfg.log_interval == 0:
                    now = time.perf_counter()
                    final = {
                        "step": step,
                        "total_loss": float(loss_output.total_loss),
                        "steps_per_s": (step - last_s) / max(now - last_t, 1e-9),
                        "buffer_size": int(trainer.buffer.size),
                        "trajectories_received": self.trajectories_received,
                    }
                    last_t, last_s = now, step
                    trainer.metrics.log(final)
                    if verbose:
                        print(
                            f"learner step {step}: loss {final['total_loss']:.4f} {final['steps_per_s']:.1f} steps/s "
                            f"({self.trajectories_received} trajectory batches in)",
                            flush=True,
                        )

                trainer.run_host_hooks(step, verbose=verbose)
        finally:
            if trainer._ckpt is not None:
                trainer._save_checkpoint()
        self.publish_params()
        return final

    def wait_for_actors(self, timeout_s: float) -> bool:
        """Keep serving until every connected actor has hung up, for at most
        ``timeout_s``; True if they all did. A learner that closes under a
        running actor fails that actor's next request after its redials."""
        with self._connections_changed:
            return self._connections_changed.wait_for(lambda: self._connections == 0, timeout_s)

    def close(self) -> None:
        self._stop.set()
        # close() alone does not wake a thread blocked in accept() on Linux;
        # shutdown() makes the call return, so that the accept thread exits.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # not listening / already closed
        self._listener.close()
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# actor side


class ActorClient:
    """Self-play worker: pull parameters, play a segment of every game on
    ``device`` (CUDA unless the caller asks for the CPU), push the
    trajectories; repeat."""

    def __init__(
        self,
        config: TrainConfig,
        learner_address: tuple[str, int],
        seed: int = 0,
        num_games: int | None = None,
        connect_timeout_s: float = 30.0,
        actor_id: int | None = None,
        device: torch.device | str | None = None,
    ):
        from simulate_2048_tpu_torch.device import resolve_device

        self.config = config
        self.device = resolve_device(device)
        # Identifies this actor's segment chain to the learner's backfill
        # bookkeeping; defaults to the seed (each actor of a job has its own).
        self.actor_id = seed if actor_id is None else actor_id
        self.num_games = num_games or config.num_parallel_games
        self.learner_address = learner_address
        self.connect_timeout_s = connect_timeout_s
        self.reconnects = 0
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # The architecture only: the parameters always come from the learner.
        self._network = network_from_config(config, prng_key(0), self.device)
        self._sock = connect_with_retry(learner_address, connect_timeout_s)
        self.generations = 0
        self.moves_played = 0  # moves of every game, summed over the generations
        self.learner_step = -1
        # Games persist across generations (segments), as the trainer's do.
        self._env_state = envlib.reset_batch(seed * 2654435761 % (1 << 31), self.num_games, self.device)

    def _rpc(self, msg: dict, retries: int = 3) -> Any:
        """Send one request and read its reply, redialing the learner on a
        broken or closed channel (a learner restart, a network failure); the
        same message is sent again on the new connection."""
        for attempt in range(retries + 1):
            try:
                _send_msg(self._sock, msg)
                reply = _recv_msg(self._sock)
                if reply is not None:
                    return reply
                raise ConnectionError("learner closed the channel")
            except (OSError, ConnectionError):
                if attempt == retries:
                    raise
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = connect_with_retry(self.learner_address, self.connect_timeout_s)
                self.reconnects += 1

    def fetch_params(self) -> list[np.ndarray]:
        reply = self._rpc({"kind": "get_params"})
        if reply.get("kind") != "params":
            raise RuntimeError(f"unexpected reply to a parameter pull: {reply}")
        self.learner_step = reply["step"]
        return reply["payload"]

    @torch.no_grad()
    def _load_params(self, params: list[np.ndarray]) -> None:
        for p, x in zip(self._network.parameters(), params, strict=True):
            p.copy_(torch.from_numpy(x))

    def run(self, num_generations: int, on_generation: Callable[[int, int], None] | None = None) -> None:
        """``num_generations`` rounds of pull parameters, play, push."""
        for gen in range(num_generations):
            self._load_params(self.fetch_params())
            self._env_state, traj, stats = generate_games(
                self._network,
                self._generator,
                self.config,
                max(self.learner_step, 0),
                num_games=self.num_games,
                env_state=self._env_state,
            )
            # The segment's statistics and (actor_id, generation) ride along, so
            # that the learner can backfill with the chain checked and log them.
            ack = self._rpc(
                {
                    "kind": "trajectories",
                    "payload": _to_numpy(traj),
                    "gen_stats": _to_numpy(stats),
                    "actor_id": self.actor_id,
                    "generation": self.generations,
                }
            )
            if ack.get("kind") != "ack":
                raise RuntimeError(f"unexpected reply to a trajectory push: {ack}")
            self.generations += 1
            self.moves_played += traj.actions.shape[1]
            if on_generation is not None:
                on_generation(gen, self.learner_step)

    def close(self) -> None:
        self._sock.close()

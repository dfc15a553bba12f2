"""The two traffic players: self-play with replay ingest, and deep evaluation.

A traffic file names its player and gives its parameters; a player builds
the program's objects for a cell from the seed (:meth:`setup`, with a
warm-up of the cell's own shapes), then plays one unit of work a call
(:meth:`unit`): a self-play segment and its ingest, or one deep evaluation.
Every unit ends in a synchronise, so its host time covers its device work.

The network is the configuration's: its weights come from the
configuration's ``weights_seed``, the same in every run, since how long its
games last (so how many of a batch's lanes still play) depends on the
network more than on anything else a seed draws.

- ``selfplay``: the Trainer's collection step. ``generate_games`` plays one
  segment of ``max_trajectory_length`` moves of ``num_parallel_games``
  games continuing across segments (a finished lane restarts at the segment
  boundary), at the temperature of ``training_step``; ``ingest_segment``
  writes it into the replay buffer at its full capacity, on the device
  (with ``cross_segment_backfill``, re-grounding the previous segment).
  The games, root noise and action draws come from the run's seed. Moves:
  the positions stored (moves of unfinished games).
- ``deep_eval``: ``evaluate_games`` over ``deep_eval_games`` greedy games
  played to their end (at most ``eval_max_moves``), with the evaluation
  calibration; unit i's games come from the traffic's ``games_seed`` and i,
  the same in every run (a 128-game batch lasts as long as its longest
  game, so fresh games would change the work from seed to seed). Moves: the
  sum of the games' lengths.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import weights as weights_lib


@dataclass
class Unit:
    """One unit of work of the window."""

    moves: int  # game-moves of unfinished games
    calls: tuple[int, int]  # [first, end) indices of its search calls in the recorder
    lanes: int  # games a search call searches
    seconds: float
    # (name, t0, t1) by perf_counter, and t0 by time_ns (the trace's clock)
    spans: list[tuple[str, float, float, int]] = field(default_factory=list)
    info: dict = field(default_factory=dict)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(fields: dict):
    """The program's ``TrainConfig`` of a configuration file's fields."""
    from simulate_2048_tpu_torch.training.config import TrainConfig

    names = {f.name for f in dataclasses.fields(TrainConfig)}
    values = {k: v for k, v in fields.items() if k in names}
    values["temperature_schedule"] = tuple(tuple(x) for x in values["temperature_schedule"])
    return TrainConfig(**values)


# The program's modules the players call, imported before set-up's other parts so that their time shows apart.
PROGRAM_MODULES = (
    "simulate_2048_tpu_torch.env.env",
    "simulate_2048_tpu_torch.models.network",
    "simulate_2048_tpu_torch.training.replay",
    "simulate_2048_tpu_torch.training.self_play",
    "simulate_2048_tpu_torch.training.trainer",
)


class _Player:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.units: list[Unit] = []
        self.warmup_s = 0.0

    def _network(self):
        from simulate_2048_tpu_torch.models.network import architecture_from_config

        self.config = train_config(self.cell.config)
        network = architecture_from_config(self.config).to(self.device)
        shapes = {k: v.shape for k, v in network.state_dict().items()}
        self.weights = weights_lib.draw(shapes, self.cell.config["weights_seed"], self.device)
        network.load_state_dict(self.weights)
        network.eval()
        self.network = network

    def _generator(self, index: int) -> torch.Generator:
        seed = weights_lib.stream_seed(self.seed, weights_lib.GAMES, index)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _span(self, spans, name, t0, ns0):
        sync(self.device)
        spans.append((name, t0, time.perf_counter(), ns0))


class SelfPlay(_Player):
    def setup(self) -> None:
        from simulate_2048_tpu_torch.env import env as envlib
        from simulate_2048_tpu_torch.training import replay
        from simulate_2048_tpu_torch.training.self_play import generate_games
        from simulate_2048_tpu_torch.training.trainer import ingest_segment

        self._network()
        cfg = self.config
        self.games = cfg.num_parallel_games
        self.buffer = replay.init_buffer(cfg, self.device)
        self.run_seed = weights_lib.stream_seed(self.seed, weights_lib.GAMES) % (1 << 30)
        self.state = envlib.reset_batch(self.run_seed, self.games, self.device)
        self.generator = self._generator(1)
        self.prev = None
        self.training_step = int(self.cell.traffic["training_step"])
        # Warm-up: two segments of two moves from the window's first state, from a generator of
        # their own, each ingested into a buffer of their own (the second re-grounds the first).
        t0 = time.perf_counter()
        warm, warm_cfg = self._generator(2), dataclasses.replace(cfg, max_trajectory_length=2)
        warm_cfg = dataclasses.replace(warm_cfg, replay_buffer_size=2 * self.games)
        state, buffer, prev = self.state, replay.init_buffer(warm_cfg, self.device), None
        for _ in range(2):
            state, traj, stats = generate_games(self.network, warm, warm_cfg, self.training_step, env_state=state)
            buffer, prev = ingest_segment(buffer, prev, traj, stats.first_search_value, warm_cfg)
        sync(self.device)
        self.warmup_s = time.perf_counter() - t0

    def unit(self, recorder) -> Unit:
        from simulate_2048_tpu_torch.training.self_play import generate_games
        from simulate_2048_tpu_torch.training.trainer import ingest_segment

        first = len(recorder.calls)
        spans = []
        t0, ns0 = time.perf_counter(), time.time_ns()
        self.state, traj, stats = generate_games(
            self.network, self.generator, self.config, self.training_step, env_state=self.state
        )
        self._span(spans, "selfplay.generate", t0, ns0)
        t1, ns1 = time.perf_counter(), time.time_ns()
        self.buffer, self.prev = ingest_segment(self.buffer, self.prev, traj, stats.first_search_value, self.config)
        self._span(spans, "replay.ingest", t1, ns1)
        unit = Unit(
            moves=int(traj.length.sum()),
            calls=(first, len(recorder.calls)),
            lanes=self.games,
            seconds=spans[-1][2] - t0,
            spans=spans,
        )
        self.units.append(unit)
        return unit


class DeepEval(_Player):
    def setup(self) -> None:
        from simulate_2048_tpu_torch.training.self_play import evaluate_games

        self._network()
        self.games = self.config.deep_eval_games
        # Warm-up: two moves of the cell's games.
        t0 = time.perf_counter()
        warm = self._generator(2)
        evaluate_games(self.network, warm, dataclasses.replace(self.config, eval_max_moves=2), self.games)
        sync(self.device)
        self.warmup_s = time.perf_counter() - t0

    def generator_seed(self, index: int) -> int:
        """The seed of the generator unit ``index`` hands ``evaluate_games``: the traffic's, not the run's."""
        return weights_lib.stream_seed(self.cell.traffic["games_seed"], weights_lib.GAMES, 16 + index)

    def unit(self, recorder) -> Unit:
        from simulate_2048_tpu_torch.training.self_play import evaluate_games

        first = len(recorder.calls)
        spans = []
        t0, ns0 = time.perf_counter(), time.time_ns()
        gen = torch.Generator(device=self.device).manual_seed(self.generator_seed(len(self.units)))
        stats = evaluate_games(self.network, gen, self.config, num_games=self.games, include_per_game=True)
        self._span(spans, "eval.batch", t0, ns0)
        unit = Unit(
            moves=int(sum(stats["per_game_lengths"])),
            calls=(first, len(recorder.calls)),
            lanes=self.games,
            seconds=spans[-1][2] - t0,
            spans=spans,
            info={"stats": stats},
        )
        self.units.append(unit)
        return unit


PLAYERS = {"selfplay": SelfPlay, "deep_eval": DeepEval}

"""Whether what the window produced is correct, judged against the reference.

Run after the window has closed and the memory peak has been read. The
reference (``perfbench/reference``) replays every game of the window from
the run's seeds and the actions the program took, and re-runs a sample of
the program's searches. Each comparison gives one number, held to the
limit the cell file gives it (``cells/<cell>.json``); a number above its
limit, or one that cannot be read, makes the run not correct.

Numbers of both players:

- ``env_mismatches``: positions where the program's state differs from
  the reference's replay: the board a search was given (and its legal
  actions), and at the end of a unit each game's moves, score, end and
  tile (self-play: every stored board, reward, length and end). Limit 0.
- ``search_visits_differ``: share of the sampled searches (games still
  playing) whose root visit counts differ from the reference's.
- ``search_value_gap``: median over the same searches of |ν − ν_ref| /
  max(1, |ν_ref|), ν the root search value.

Self-play adds ``action_mismatches`` (a stored action that is illegal or
that the search never visited), ``noise_mismatches`` (root noise rows off
the simplex) and ``target_mismatches`` (stored policy targets, value
targets and priorities, after backfill, off the reference's by more than
one unit of their storage type's precision). Limits 0.

The reference's own search runs with its products in the configuration's
precision; ``CONTROL`` is the next precision below, which the control
(``perfbench/control.py``) puts in the program's place.
"""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import numpy as np
import torch

from perfbench.harness import weights as weights_lib
from perfbench.reference import game, targets
from perfbench.reference import search as ref_search

CONTROL = {"float32": "bfloat16", "bfloat16": "float8"}


class Number(NamedTuple):
    name: str
    value: float | None
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and not math.isnan(self.value) and self.value <= self.limit


class Sample(NamedTuple):
    """The sampled searches: per sampled call, its index, the lanes still
    playing and the reference's legal mask of every lane."""

    calls: list[int]
    lanes: list[np.ndarray]
    legal: list[np.ndarray]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sample_calls(n_calls: int, count: int, seed: int) -> list[int]:
    gen = torch.Generator().manual_seed(weights_lib.stream_seed(seed, weights_lib.SAMPLE))
    return sorted(torch.randperm(n_calls, generator=gen)[:count].tolist())


def _observed(call, games: game.Games) -> tuple[int, np.ndarray]:
    """Lanes whose searched board or legal mask differs from the replay, and the replay's legal mask."""
    legal = games.legal()
    boards = np.rint(_np(call.observations) * 16).astype(np.int64)
    bad = (boards != games.boards).any(-1) | (_np(call.invalid) != ~legal).any(-1)
    return int(bad.sum()), legal


class Replay(NamedTuple):
    env_mismatches: int
    extra: dict  # player-specific numbers
    legal: dict[int, np.ndarray]  # call index -> the replay's legal mask
    active: dict[int, np.ndarray]  # call index -> lanes still playing


def replay_selfplay(player, calls) -> Replay:
    cfg = player.cell.config
    b, t_max = player.games, cfg["max_trajectory_length"]
    buf = player.buffer
    cap = buf.length.shape[0]
    dev = player.device
    games = game.Games(player.run_seed, b)
    env_bad = action_bad = noise_bad = 0
    legal_of, active_of, segments = {}, {}, []
    if len(player.units) * b > cap:
        raise ValueError("the window wrote more segments than the buffer holds")
    for k, unit in enumerate(player.units):
        c0, c1 = unit.calls
        if c1 - c0 != t_max:
            return Replay(b * t_max, {}, {}, {})
        rows = torch.arange(k * b, (k + 1) * b, device=dev) % cap
        stored_actions = _np(buf.actions[rows]).astype(np.int64)
        boards = np.zeros((b, t_max + 1, 16), dtype=np.int64)
        rewards = np.zeros((b, t_max), dtype=np.int64)
        active = np.zeros((b, t_max), dtype=bool)
        legal = np.zeros((b, t_max, cfg["action_size"]), dtype=bool)
        for t in range(t_max):
            call = calls[c0 + t]
            bad, legal[:, t] = _observed(call, games)
            env_bad += bad
            legal_of[c0 + t], active_of[c0 + t] = legal[:, t], ~games.done
            boards[:, t], active[:, t] = games.boards, ~games.done
            a = stored_actions[:, t]
            visits = _np(call.visits)
            lane = np.arange(b)
            ok = legal[lane, t, a] & (visits[lane, a] > 0)
            action_bad += int((active[:, t] & ~ok).sum())
            if call.noise is not None:
                noise = _np(call.noise).astype(np.float64)
                noise_bad += int(((noise < 0).any(-1) | (np.abs(noise.sum(-1) - 1) > 1e-5)).sum())
            rewards[:, t] = games.step(np.where(active[:, t], a, 0))
        boards[:, t_max] = games.boards
        lengths, ended = active.sum(-1), games.done.copy()
        env_bad += int((_np(buf.boards[rows]).astype(np.int64) != boards).any(-1).sum())
        env_bad += int((_np(buf.length[rows]) != lengths).sum() + (_np(buf.terminated[rows]) != ended).sum())
        stored_rewards = _np(buf.rewards[rows].float())
        want = torch.tensor(rewards, dtype=torch.float32).to(targets.STORED["rewards"]).float().numpy()
        env_bad += int((stored_rewards != want).sum())
        nu = torch.stack([calls[c0 + t].value for t in range(t_max)], 1).float()
        visits = torch.stack([calls[c0 + t].visits for t in range(t_max)], 1)
        segments.append(
            dict(rows=rows, rewards=torch.tensor(rewards, dtype=torch.float32, device=dev),
                 active=torch.tensor(active, device=dev), legal=torch.tensor(legal, device=dev),
                 lengths=torch.tensor(lengths, device=dev), ended=torch.tensor(ended, device=dev),
                 nu=nu, visits=visits)  # fmt: skip
        )
        games.restart_finished()
    extra = {"action_mismatches": action_bad, "target_mismatches": _targets(cfg, buf, segments)}
    if calls and calls[0].noise is not None:
        extra["noise_mismatches"] = noise_bad
    return Replay(env_bad, extra, legal_of, active_of)


def _targets(cfg: dict, buf, segments: list[dict]) -> int:
    """Stored policy targets, value targets and priorities off the reference's."""
    collected = []
    for seg in segments:
        act = seg["active"]
        nu = seg["nu"] * act
        values, prios = targets.segment_targets(cfg, seg["rewards"] * act, nu, seg["lengths"], seg["ended"])
        collected.append((nu, values, prios))
    bad = 0
    stored = targets.STORED
    for k, seg in enumerate(segments):
        nu, values, prios = collected[k]
        values = values.to(stored["values"]).float()
        prios = prios.to(stored["priorities"]).float()
        if cfg["cross_segment_backfill"] and k + 1 < len(segments):
            nu_next, z_next, _ = collected[k + 1]
            values, prios = targets.backfill(
                cfg, values, seg["rewards"].to(stored["rewards"]), prios, seg["lengths"], ~seg["ended"],
                nu_next[:, 0], z_next[:, 0],
            )  # fmt: skip
        rows = seg["rows"]
        policies = targets.policy_targets(seg["visits"], seg["legal"]) * seg["active"][..., None]
        bad += int(((buf.policies[rows].float() - policies).abs() > 1e-3).any(-1).sum())
        for want, got in ((values, buf.values[rows]), (prios, buf.step_priorities[rows])):
            want = want.to(got.dtype).float()
            got = got.float()
            bad += int(((got - want).abs() > 2.0**-7 * torch.maximum(got.abs(), want.abs()) + 1e-6).sum())
    return bad


def replay_deep_eval(player, calls) -> Replay:
    b = player.games
    cap = player.config.eval_max_moves
    env_bad = 0
    legal_of, active_of = {}, {}
    for k, unit in enumerate(player.units):
        c0, c1 = unit.calls
        gen = torch.Generator(device=player.device).manual_seed(player.generator_seed(k))
        run_seed = int(torch.randint(0, 1 << 30, (), generator=gen, device=player.device))
        games = game.Games(run_seed, b)
        for c in range(c0, c1):
            if games.done.all():  # a batch whose games had all ended was searched again
                env_bad += b
                break
            bad, legal = _observed(calls[c], games)
            env_bad += bad
            legal_of[c], active_of[c] = legal, ~games.done
            visits = np.where(legal, _np(calls[c].visits), -1)
            games.step(visits.argmax(-1))
        if not games.done.all() and c1 - c0 < cap:  # the batch stopped before its games ended
            env_bad += int((~games.done).sum())
        stats = unit.info["stats"]
        tiles = np.where(games.boards.max(-1) > 0, 1 << games.boards.max(-1), 0)
        env_bad += int((np.asarray(stats["per_game_lengths"]) != games.moves).sum())
        env_bad += int((np.asarray(stats["per_game_rewards"]) != games.score).sum())
        env_bad += int((np.asarray(stats["per_game_tiles"]) != tiles).sum())
    return Replay(env_bad, {}, legal_of, active_of)


REPLAYS = {"selfplay": replay_selfplay, "deep_eval": replay_deep_eval}


def sample(player, calls, rep: Replay) -> Sample:
    chosen = _sample_calls(len(calls), int(player.cell.check["sample_calls"]), player.seed)
    chosen = [c for c in chosen if c in rep.legal]
    return Sample(chosen, [np.flatnonzero(rep.active[c] & rep.legal[c].any(-1)) for c in chosen],
                  [rep.legal[c] for c in chosen])  # fmt: skip


@torch.no_grad()
def reference_searches(player, calls, smp: Sample, products: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's root visits and values at the sampled searches: the
    root per call at the call's own batch, then one tree search over all of
    them, products in ``products``, float32 products without TF32."""
    cfg = player.cell.config
    if not smp.calls:
        return torch.zeros(0, cfg["action_size"]), torch.zeros(0)
    evaluation = player.cell.traffic["player"] == "deep_eval"
    scfg = ref_search.search_of(cfg, evaluation)
    heads = ref_search.model.heads_of(cfg)
    blocks = cfg["num_residual_blocks"]
    dev = player.device
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        hidden, priors, values = [], [], []
        for c, lanes, legal in zip(smp.calls, smp.lanes, smp.legal):
            call = calls[c]
            hid, logits, value = ref_search.model.root(player.weights, call.observations, blocks,
                                                       cfg["use_bfloat16"], heads)  # fmt: skip
            legal_t = torch.tensor(legal, device=dev)
            pri = ref_search.root_priors(logits, scfg, legal_t, call.noise)
            idx = torch.tensor(lanes, dtype=torch.long, device=dev)
            hidden.append(hid[idx])
            priors.append(pri[idx])
            values.append(ref_search.h_inverse(value, scfg.value_epsilon)[idx])
        expand = ref_search.model.transitions(player.weights, blocks, heads, scfg.num_actions, scfg.codebook,
                                              products)  # fmt: skip
        visits, _, value = ref_search.run(torch.cat(hidden), torch.cat(priors), torch.cat(values), scfg, expand)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return visits, value


def program_searches(calls, smp: Sample) -> tuple[torch.Tensor, torch.Tensor]:
    if not smp.calls:
        return torch.zeros(0, 1), torch.zeros(0)
    idx = [torch.tensor(lanes, dtype=torch.long, device=calls[c].visits.device) for c, lanes in
           zip(smp.calls, smp.lanes)]  # fmt: skip
    visits = torch.cat([calls[c].visits[i].float() for c, i in zip(smp.calls, idx)])
    value = torch.cat([calls[c].value[i].float() for c, i in zip(smp.calls, idx)])
    return visits, value


def search_numbers(got, want) -> dict[str, float]:
    (gv, gval), (wv, wval) = got, want
    if gv.shape[0] == 0:
        return {"search_visits_differ": float("nan"), "search_value_gap": float("nan")}
    differ = (gv != wv).any(-1).float().mean().item()
    gap = ((gval - wval).abs() / torch.clamp_min(wval.abs(), 1.0)).cpu().tolist()
    return {"search_visits_differ": differ, "search_value_gap": statistics.median(gap)}


def judge(player, recorder, control: str | None = None) -> tuple[list[Number], dict]:
    """The run's numbers against the cell's limits, and what was compared.
    With ``control`` (a products precision) the searches judged are the
    reference's at that precision instead of the program's."""
    calls = recorder.calls
    rep = REPLAYS[player.cell.traffic["player"]](player, calls)
    smp = sample(player, calls, rep)
    precision = player.cell.config["search_weight_dtype"]
    want = reference_searches(player, calls, smp, precision)
    got = program_searches(calls, smp) if control is None else reference_searches(player, calls, smp, control)
    values = {"env_mismatches": rep.env_mismatches, **rep.extra, **search_numbers(got, want)}
    if not calls:
        values["env_mismatches"] = float("nan")
    limits = player.cell.check["limits"]
    numbers = [Number(name, float(values.get(name, float("nan"))), float(limit)) for name, limit in limits.items()]
    compared = {"searches_compared": int(got[0].shape[0]), "search_calls": len(calls)}
    return numbers, compared

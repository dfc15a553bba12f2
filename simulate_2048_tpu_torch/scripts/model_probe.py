"""Model-accuracy probe: ``python -m simulate_2048_tpu_torch.scripts.model_probe``.

Port of the repository's ``scripts/model_probe.py``: decomposes a
checkpoint's model quality on fresh on-policy data (``--games`` games,
temperature 1.0, one segment each), separating the candidate bottlenecks
that the evaluation curve cannot tell apart:

1. reward-model error: r̂ = g(φ(h(o), a), oracle code) against the true
   reward, grouped by reward magnitude (h-space and raw);
2. value calibration: v(h(o_t)) against the realized within-segment
   discounted return-to-go (correlation and bias);
3. prior quality: top-1 agreement between f's policy prior and the action
   the search chose;
4. unroll drift: relative L2 distance between the unrolled hidden state
   after one step and the re-encoded h(o_{t+1}).

Same flags (``--ckpt-dir`` required, ``--step --games --mode --seed``),
defaults and JSON keys (printed with indent 2), plus ``--device`` (default
``cuda``; raises when no GPU is present unless given ``--device cpu``).
Departures: ``--set FIELD=VALUE`` (``prior_sweep``'s flag and parsing)
applies to the ``--mode`` preset before the restore, so that a categorical
checkpoint can be probed and ``--set search_backend=auto`` plays the games
on the whole-search kernel (the games go through the self-play search,
``training/self_play.py`` ``_make_search``); the games are drawn from a
``torch.Generator`` on the device seeded with ``--seed``. A line on standard
error names the search the games took, its kernel launches and its seconds.

Usage (on the GPU):
    python -m simulate_2048_tpu_torch.scripts.model_probe --ckpt-dir runs/torch_scalar60k/ckpt \\
        --mode small --set search_backend=auto
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from simulate_2048_tpu_torch.ops.value_transform import inverse_scale_value, scale_value
from simulate_2048_tpu_torch.scripts import diagnosis
from simulate_2048_tpu_torch.training.config import TrainConfig, default_config, small_config, tiny_config
from simulate_2048_tpu_torch.training.losses import oracle_chance_targets

PRESETS = {"tiny": tiny_config, "small": small_config, "full": default_config}


@torch.no_grad()
def probe(network, config: TrainConfig, observations: torch.Tensor, actions: torch.Tensor):
    """The JAX script's jitted ``probe``, batched over (game, position):
    observations (B, T+1, 16) in the exponent/16 encoding, actions (B, T).
    Returns (policy logits (B, T, A), raw value (B, T), raw one-step reward
    with the oracle's chance code (B, T), spawned (B, T), one-step hidden
    drift (B, T)) on the host as numpy arrays."""
    b, t = actions.shape
    eps = config.value_epsilon
    hidden = network.representation(observations[:, :-1].reshape(-1, 16))
    logits, value = network.prediction(hidden)
    v_raw = inverse_scale_value(value, eps)
    codes, _, spawned = oracle_chance_targets(observations, actions, config.codebook_size)
    a_onehot = torch.nn.functional.one_hot(actions.reshape(-1).long(), config.action_size).to(torch.float32)
    after = network.afterstate_dynamics(hidden, a_onehot)
    nxt, r_hat = network.dynamics(after, codes.reshape(-1, config.codebook_size))
    r_hat_raw = inverse_scale_value(r_hat, eps)
    h1_true = network.representation(observations[:, 1:].reshape(-1, 16))
    drift1 = torch.linalg.vector_norm(nxt - h1_true, dim=-1) / (torch.linalg.vector_norm(h1_true, dim=-1) + 1e-9)
    outs = (logits.reshape(b, t, -1), v_raw.reshape(b, t), r_hat_raw.reshape(b, t), spawned, drift1.reshape(b, t))
    return tuple(x.float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy() for x in outs)


def _h(x: np.ndarray, eps: float) -> np.ndarray:
    return scale_value(torch.from_numpy(np.asarray(x, np.float32)), eps).numpy()


def statistics(network, config: TrainConfig, boards: np.ndarray, actions: np.ndarray, rewards: np.ndarray,
               lengths: np.ndarray) -> dict[str, float | int]:  # fmt: skip
    """The four blocks of statistics of one trajectory batch (boards (B, T+1,
    16) int8, actions (B, T), rewards (B, T) float32, lengths (B,)): every key
    of the JAX script's output after ``ckpt`` and ``step``."""
    device = next(network.parameters()).device
    eps = config.value_epsilon
    b, t = rewards.shape
    obs_all = torch.from_numpy(np.asarray(boards, np.float32)).to(device) / 16.0
    mask = np.arange(t)[None, :] < lengths[:, None]
    acts = torch.from_numpy(actions).to(device).long()
    logits, v_raw, r_hat, spawned, drift1 = probe(network, config, obs_all, acts)

    # 1. reward model
    valid = mask & spawned.astype(bool)
    r_true = rewards
    h_err = np.abs(_h(r_hat, eps) - _h(r_true, eps))
    out: dict[str, float | int] = {"positions": int(valid.sum())}
    out["reward_mae_raw"] = float(np.abs(r_hat - r_true)[valid].mean())
    out["reward_mae_h"] = float(h_err[valid].mean())
    for lo, hi, tag in [(0, 1, "r0"), (1, 9, "r4_8"), (9, 33, "r16_32"), (33, 1e9, "r_big")]:
        sel = valid & (r_true >= lo) & (r_true < hi)
        if sel.sum():
            out[f"reward_mae_raw/{tag}"] = float(np.abs(r_hat - r_true)[sel].mean())
            out[f"count/{tag}"] = int(sel.sum())

    # 2. value calibration against the realized discounted return-to-go (within the segment)
    gamma = config.discount
    g_ret = np.zeros_like(rewards)
    acc = np.zeros(b)
    for i in range(t - 1, -1, -1):
        acc = np.where(mask[:, i], rewards[:, i] + gamma * acc, acc)
        g_ret[:, i] = acc
    vv, gg = v_raw[mask], g_ret[mask]
    out["value_corr"] = float(np.corrcoef(vv, gg)[0, 1])
    out["value_mean"] = float(vv.mean())
    out["return_mean"] = float(gg.mean())
    out["value_bias"] = float((vv - gg).mean())
    out["value_mae_h"] = float(np.abs(_h(vv, eps) - _h(gg, eps)).mean())

    # 3. prior top-1 agreement with the executed (search-chosen) action
    out["prior_top1_agreement"] = float((logits.argmax(-1) == actions)[mask].mean())

    # 4. one-step hidden drift
    out["hidden_drift_1step"] = float(drift1[mask].mean())
    return out


def model_probe(ckpt_dir: str, step: int | None, games: int, mode: str, seed: int, overrides: list[str],
                device="cuda") -> dict:  # fmt: skip
    """The JAX script's run: restore, play ``games`` fresh games at temperature 1.0, probe."""
    from simulate_2048_tpu_torch.device import resolve_device
    from simulate_2048_tpu_torch.ops import search_kernel as sk
    from simulate_2048_tpu_torch.training.self_play import play_games

    device = resolve_device(device)
    config = diagnosis.parse_set(PRESETS[mode](), overrides)
    state, network = diagnosis.template(config, device)
    restored = diagnosis.restore(state, ckpt_dir, step)
    before = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    traj = play_games(network, torch.Generator(device=device).manual_seed(seed), 1.0, config, games)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(
        f"model_probe play_games: search {diagnosis.search_route(config, device, eval_mode=False)}, "
        f"launches {diagnosis.launches_since(before)}, {time.perf_counter() - t0:.2f} s",
        file=sys.stderr,
        flush=True,
    )
    arrays = (traj.boards, traj.actions, traj.rewards, traj.length)
    boards, actions, rewards, lengths = (x.cpu().numpy() for x in arrays)
    out = {"ckpt": ckpt_dir, "step": int(restored.step)}
    out.update(statistics(network, config, boards, actions, rewards, lengths))
    return out


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt-dir", required=True)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--games", type=int, default=64)
    parser.add_argument("--mode", choices=["tiny", "small", "full"], default="small")
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        help="TrainConfig overrides matching the checkpoint's training config (e.g. --set value_bins=256 "
        "--set reward_bins=128 for a categorical checkpoint, --set search_backend=auto for the kernel)",
    )
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    out = model_probe(args.ckpt_dir, args.step, args.games, args.mode, args.seed, args.overrides, args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

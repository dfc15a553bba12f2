"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python chip_smoke.py``.

Drives the port (``simulate_2048_tpu_torch``) on the card and fails (exit
code != 0, no final ``ok`` line) if any phase fails:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, started together) and prints the build seconds;
3. holds each kernel against its plain PyTorch version at the shapes the
   main path gives it: the whole-search kernel at the full preset (H=256,
   10 residual blocks, 100 simulations, depth cap 32) on B=256 searches
   with seeded random weights. Visit counts must be identical in at least
   99% of the searches (each differing search is printed with its root
   visits and the Q gap of its two most visited actions) and total S in
   every search; root Q and value agree within
   rtol 1e-4 / atol 1e-3 on the matching searches (float32 sums taken in
   another order);
4. times each kernel (CUDA events after warm-up, median of 5) beside its
   plain version and its bound;
5. checks greedy evaluation on a small config on the card: the kernel
   backend against the plain search backend, game for game;
6. drives the main path, ``evaluate_games`` at ``default_config()`` on 256
   games with ``eval_max_moves`` capped, with the launch counts set to 0
   just before; every kernel must have launched, once per move played;
7. prints one JSON line with every kernel's numbers, then
   ``{"ok": true, "device": {...}}`` as the last line.

``--profile`` also prints the device time by kernel, the device kernels
launched per move and the device's idle share over a few main-path moves.
Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import root_inputs
from simulate_2048_tpu_torch.training.config import default_config, tiny_config
from simulate_2048_tpu_torch.training.self_play import _evaluate_rollout, evaluate_games, search_config_from

SEED = 2048
BATCH = 256
MAIN_PATH_MAX_MOVES = 200
# FP32 (non-tensor-core) peak by SKU, NVIDIA data sheets (dense, at the full power limit).
FP32_TFLOPS = {"H100 SXM": 67.0, "H100 NVL": 60.0, "H100 PCIe": 51.0, "H200": 67.0}
HBM_TBPS = {"H100 SXM": 3.35, "H100 NVL": 3.9, "H100 PCIe": 2.0, "H200": 4.8}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def sku(name: str) -> str:
    for key in ("H100 NVL", "H100 PCIe", "H200"):
        if all(word in name for word in key.split()):
            return key
    return "H100 SXM"


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def full_width_inputs(device):
    """Seeded full-preset network (heads scaled so values spread) and B=256 roots."""
    config = default_config()
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, gen, device)
    with torch.no_grad():
        for head in (network.prediction.value, network.afterstate_prediction.q_value, network.dynamics.reward):
            head.weight.mul_(20.0)
            head.bias.add_(torch.randn(head.bias.shape, generator=gen).to(device))
    # Roots: mid-game boards from seeded random play.
    state = envlib.reset_batch(SEED, BATCH, device)
    moves = torch.randint(0, 4, (40, BATCH), generator=gen).to(device)
    for t in range(moves.shape[0]):
        state, _, _, _ = envlib.step(state, moves[t])
    obs = envlib.get_observation(state)
    invalid = ~envlib.get_legal_actions(state)
    invalid[invalid.all(-1)] = False
    cfg = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
    with torch.no_grad():
        hidden, probs, value = root_inputs(network, obs, cfg, invalid)
    packed = sk.pack_search_params(network, config.num_residual_blocks, max(config.action_size, config.codebook_size))
    return config, cfg, network, packed, (hidden.contiguous(), probs.contiguous(), value.contiguous())


def root_gap(visits_a, visits_b, q_a, q_b) -> str:
    """Root visits of both sides and the Q gap between the two most visited actions."""
    a, b = visits_a.tolist(), visits_b.tolist()
    top = sorted(range(len(a)), key=lambda i: -(a[i] + b[i]))[:2]
    gaps = [abs(float(q[top[0]] - q[top[1]])) for q in (q_a, q_b)]
    return f"kernel {a} plain {b}; top-two root Q gap kernel {gaps[0]:.3g} plain {gaps[1]:.3g}"


def search_flops(h: int, nb: int, a: int, k: int, searches: int, sims: int) -> float:
    """FLOP the searches need: each simulation expands through one transition,
    a fuse layer, a tower, a head layer and a second tower (2 (1 + 2 nb) + 2
    dense h x h layers), plus that transition's heads. The cheaper heads are
    counted (reward, value and action logits after g -> f: h (a + 2) against
    q and chance logits after phi -> psi: h (k + 1)), so this is a lower bound
    whichever mix of parents the run expands."""
    layers = 2 * (1 + 2 * nb) + 2
    per_sim = 2.0 * (layers * h * h + h * min(a + 2, k + 1))
    return per_sim * searches * sims


def check_whole_search(device) -> dict:
    config, cfg, network, packed, roots = full_width_inputs(device)
    h, nb, s = config.hidden_size, config.num_residual_blocks, cfg.num_simulations
    visits, qvals, value = sk.whole_search(*roots, packed, cfg)
    torch.cuda.synchronize()
    ref_visits, ref_q, ref_value = sk.whole_search_reference(*roots, packed, cfg)
    torch.cuda.synchronize()

    if not (visits.sum(-1) == s).all():
        fail(f"whole_search: visit totals {visits.sum(-1).unique().tolist()} != {s}")
    if not (torch.isfinite(qvals).all() and torch.isfinite(value).all()):
        fail("whole_search: non-finite Q or value")
    differ = (visits != ref_visits).any(-1)
    n_diff = int(differ.sum())
    for i in differ.nonzero().flatten().tolist():
        print(f"  search {i} differs: {root_gap(visits[i].int(), ref_visits[i].int(), qvals[i], ref_q[i])}")
    print(f"whole_search: {BATCH - n_diff}/{BATCH} searches with identical visit counts")
    if n_diff > BATCH // 100:
        fail(f"whole_search: {n_diff} searches differ from the plain version (limit {BATCH // 100})")
    same = ~differ
    q_ok = torch.allclose(qvals[same], ref_q[same], rtol=1e-4, atol=1e-3)
    v_ok = torch.allclose(value[same], ref_value[same], rtol=1e-4, atol=1e-3)
    max_err = max(float((qvals[same] - ref_q[same]).abs().max()), float((value[same] - ref_value[same]).abs().max()))
    print(f"whole_search: max |kernel - plain| over Q and root value = {max_err:.3g}")
    if not (q_ok and v_ok):
        fail("whole_search: Q / root value outside rtol 1e-4, atol 1e-3")

    ms = cuda_ms(lambda: sk.whole_search(*roots, packed, cfg), reps=5)
    plain_ms = cuda_ms(lambda: sk.whole_search_reference(*roots, packed, cfg), reps=3, warmup=0)
    flops = search_flops(h, nb, cfg.num_actions, max(cfg.num_actions, cfg.codebook_size), BATCH, s)
    weight_bytes = sum(t.numel() * t.element_size() for t in packed[:7])
    io_bytes = sum(t.numel() * 4 for t in roots) + 3 * visits.numel() * 4
    card = sku(torch.cuda.get_device_name(0))
    op_ms = flops / (FP32_TFLOPS[card] * 1e12) * 1e3
    byte_ms = (weight_bytes + io_bytes) / (HBM_TBPS[card] * 1e12) * 1e3
    print(
        f"whole_search: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(op_ms, byte_ms):.3f} ms "
        f"({flops:.3g} FLOP at {FP32_TFLOPS[card]} TFLOP/s FP32 ({card}); {weight_bytes + io_bytes} B), "
        f"B={BATCH} S={s} H={h} NB={nb}"
    )
    return {
        "name": "whole_search",
        "route": "cuda",
        "source": "simulate_2048_tpu_torch/csrc/whole_search.cu",
        "replaces": "simulate_2048_tpu/ops/pallas_search.py:249",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }


def check_small_evaluation(device) -> None:
    """Greedy games on a small config: kernel backend vs plain search backend."""
    config = dataclasses.replace(tiny_config(), num_simulations=16, eval_max_moves=40)
    network = network_from_config(config, torch.Generator().manual_seed(SEED), device)
    kernel_state, *_ = _evaluate_rollout(network, SEED, dataclasses.replace(config, search_backend="pallas"), 32, device)
    plain_state, *_ = _evaluate_rollout(network, SEED, dataclasses.replace(config, search_backend="xla"), 32, device)
    same = (kernel_state.board == plain_state.board).flatten(1).all(-1) & (
        kernel_state.total_reward == plain_state.total_reward
    )
    print(f"small evaluation (H=64, NB=2, S=16, 32 games, 40 moves): {int(same.sum())}/32 games identical")
    if int(same.sum()) < 31:
        fail("small evaluation: kernel and plain search backends disagree on more than one game")


def profile_moves(device, moves: int = 5) -> None:
    """torch.profiler over a few main-path moves: device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    config = dataclasses.replace(default_config(), eval_max_moves=moves)
    network = network_from_config(config, torch.Generator().manual_seed(SEED), device)
    _evaluate_rollout(network, SEED, config, BATCH, device)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        _evaluate_rollout(network, SEED, config, BATCH, device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [
        e
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0
    ]  # device kernels only: CPU-side ops also report the time of the kernels they launch
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)
    print(f"profile: {moves} moves, wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"(summed kernel time), idle share {max(0.0, 1 - busy_us / wall_us):.3f}, "
          f"{calls / moves:.1f} device kernels per move")
    for e in events[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3 / moves:9.3f} ms/move  {e.count // moves:5d} calls/move  {e.key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true", help="also profile a few main-path moves")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    seconds = _build.build_all(verbose=True)
    print(json.dumps({"kernels_built": list(seconds), "build_s": round(time.perf_counter() - t0, 3)}))

    kernels = {"whole_search": check_whole_search(device)}
    check_small_evaluation(device)

    # ---- main path: greedy evaluation at the full preset on the card
    config = dataclasses.replace(default_config(), eval_max_moves=MAIN_PATH_MAX_MOVES)
    network = network_from_config(config, torch.Generator().manual_seed(SEED), device)
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_games(
        network, torch.Generator().manual_seed(SEED + 1), config, num_games=BATCH, include_per_game=True
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    lengths = stats["per_game_lengths"]
    moves_played = max(lengths)
    total_moves = sum(lengths)
    print(
        f"main path: {BATCH} games, mean reward {stats['mean_reward']:.1f}, mean length {stats['mean_length']:.1f}, "
        f"{moves_played} moves in {wall:.2f} s: {total_moves / wall:.1f} game-moves/s, "
        f"{1e3 * wall / max(moves_played, 1):.2f} ms per move "
        f"(the kernel alone at B={BATCH}: {kernels['whole_search']['ms']:.2f} ms, timed above)"
    )
    for name, count in launches.items():
        kernels[name]["launches"] = count
        if count == 0:
            fail(f"main path never launched {name}")
    if launches["whole_search"] != moves_played:
        fail(f"whole_search launched {launches['whole_search']} times for {moves_played} moves")
    rewards = torch.tensor(stats["per_game_rewards"])
    if not torch.isfinite(rewards).all() or max(lengths) > MAIN_PATH_MAX_MOVES or len(lengths) != BATCH:
        fail("main path: non-finite rewards or game lengths beyond the cap")

    if args.profile:
        profile_moves(device)

    print(json.dumps({"kernels": list(kernels.values())}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))


if __name__ == "__main__":
    main()

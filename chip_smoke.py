"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python chip_smoke.py``.

Drives the port (``simulate_2048_tpu_torch``) on the card and fails (exit
code != 0, no final ``ok`` line) if any phase fails:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, started together) and prints the build seconds;
3. holds each kernel against its plain PyTorch version at the shapes the
   main paths give it: the whole-search kernel at the full preset (H=256,
   10 residual blocks, 100 simulations, depth cap 32) on B=256 searches
   with seeded random weights, once with scalar heads (the evaluation path)
   and once with categorical heads of 256 value and 128 reward bins (the
   training path). Visit counts must be identical in at least
   99% of the searches (each differing search is printed with its root
   visits and the Q gap of its two most visited actions) and total S in
   every search; root Q and value agree within
   rtol 1e-4 / atol 1e-3 on the matching searches (float32 sums taken in
   another order);
4. times each kernel (CUDA events after warm-up, median of 5) beside its
   plain version and its bound;
5. checks greedy evaluation and a greedy self-play segment with categorical
   heads on a small config on the card: the kernel backend against the
   plain search backend, game for game;
6. drives the evaluation path, ``evaluate_games`` at ``default_config()`` on
   256 games with ``eval_max_moves`` capped, with the launch counts set to 0
   just before; the kernel must have launched once per move played;
7. drives the training path, ``train_muzero`` at ``default_config()`` with
   the categorical heads and learning settings of the repo's training
   recipe (depth cut: short segments, a small buffer, a dozen learner
   steps, one checkpoint written and read back, one inline evaluation),
   again with the launch counts set to 0 just before: one kernel launch per
   self-play move and evaluation move, finite loss terms, changed
   parameters, and a checkpoint equal to the saved state;
8. prints one JSON line with every kernel's numbers, then
   ``{"ok": true, "device": {...}}`` as the last line.

``--profile`` also prints the device time by kernel, the device kernels
launched and the device's idle share over a few evaluation moves, self-play
moves and learner steps at full width.
Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import root_inputs
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager
from simulate_2048_tpu_torch.training.config import default_config, tiny_config
from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer
from simulate_2048_tpu_torch.training.self_play import (
    _evaluate_rollout,
    evaluate_games,
    play_segment,
    search_config_from,
)
from simulate_2048_tpu_torch.training.trainer import train_muzero

SEED = 2048
BATCH = 256
MAIN_PATH_MAX_MOVES = 100  # evaluation path: moves per game
# Training path, depth cut (widths, games, batch and unroll are the preset's):
TRAIN_SEGMENT_MOVES = 24  # max_trajectory_length
TRAIN_STEPS = 12  # the first has learning rate 0 (warm-up starts there)
TRAIN_EVAL_MOVES = 8
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


def full_width_inputs(device, value_bins: int = 1, reward_bins: int = 1):
    """Seeded full-preset network and B=256 roots. Scalar heads are scaled so
    that values spread; categorical heads (zero weights when fresh, so every
    node would get the same expectation and the search would compare float
    noise) get 0.05 * normal weights."""
    config = dataclasses.replace(default_config(), value_bins=value_bins, reward_bins=reward_bins)
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, gen, device)
    with torch.no_grad():
        for head in (network.prediction.value, network.afterstate_prediction.q_value, network.dynamics.reward):
            if head.out_features > 1:
                head.weight.add_(0.05 * torch.randn(head.weight.shape, generator=gen).to(device))
            else:
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
    packed = sk.pack_search_params(
        network,
        config.num_residual_blocks,
        max(config.action_size, config.codebook_size),
        value_bins=value_bins,
        reward_bins=reward_bins,
    )
    return config, cfg, network, packed, (hidden.contiguous(), probs.contiguous(), value.contiguous())


def root_gap(visits_a, visits_b, q_a, q_b) -> str:
    """Root visits of both sides and the Q gap between the two most visited actions."""
    a, b = visits_a.tolist(), visits_b.tolist()
    top = sorted(range(len(a)), key=lambda i: -(a[i] + b[i]))[:2]
    gaps = [abs(float(q[top[0]] - q[top[1]])) for q in (q_a, q_b)]
    return f"kernel {a} plain {b}; top-two root Q gap kernel {gaps[0]:.3g} plain {gaps[1]:.3g}"


def search_flops(h: int, nb: int, a: int, k: int, searches: int, sims: int, vb: int = 1, rb: int = 1) -> float:
    """FLOP the searches need: each simulation expands through one transition,
    a fuse layer, a tower, a head layer and a second tower (2 (1 + 2 nb) + 2
    dense h x h layers), plus that transition's heads. The cheaper heads are
    counted (reward, value and action logits after g -> f: h (a + vb + rb)
    against q and chance logits after phi -> psi: h (k + vb); vb, rb are the
    value and reward bins, 1 for a scalar head), so this is a lower bound
    whichever mix of parents the run expands."""
    layers = 2 * (1 + 2 * nb) + 2
    per_sim = 2.0 * (layers * h * h + h * min(a + vb + rb, k + vb))
    return per_sim * searches * sims


def check_whole_search(device, name: str = "whole_search", value_bins: int = 1, reward_bins: int = 1) -> dict:
    """Kernel vs plain version at the full preset, then their times and the bound."""
    config, cfg, network, packed, roots = full_width_inputs(device, value_bins, reward_bins)
    h, nb, s = config.hidden_size, config.num_residual_blocks, cfg.num_simulations
    visits, qvals, value = sk.whole_search(*roots, packed, cfg)
    torch.cuda.synchronize()
    ref_visits, ref_q, ref_value = sk.whole_search_reference(*roots, packed, cfg)
    torch.cuda.synchronize()

    if not (visits.sum(-1) == s).all():
        fail(f"{name}: visit totals {visits.sum(-1).unique().tolist()} != {s}")
    if not (torch.isfinite(qvals).all() and torch.isfinite(value).all()):
        fail(f"{name}: non-finite Q or value")
    differ = (visits != ref_visits).any(-1)
    n_diff = int(differ.sum())
    for i in differ.nonzero().flatten().tolist():
        print(f"  search {i} differs: {root_gap(visits[i].int(), ref_visits[i].int(), qvals[i], ref_q[i])}")
    print(f"{name}: {BATCH - n_diff}/{BATCH} searches with identical visit counts")
    if n_diff > BATCH // 100:
        fail(f"{name}: {n_diff} searches differ from the plain version (limit {BATCH // 100})")
    same = ~differ
    q_ok = torch.allclose(qvals[same], ref_q[same], rtol=1e-4, atol=1e-3)
    v_ok = torch.allclose(value[same], ref_value[same], rtol=1e-4, atol=1e-3)
    max_err = max(float((qvals[same] - ref_q[same]).abs().max()), float((value[same] - ref_value[same]).abs().max()))
    print(f"{name}: max |kernel - plain| over Q and root value = {max_err:.3g}")
    if not (q_ok and v_ok):
        fail(f"{name}: Q / root value outside rtol 1e-4, atol 1e-3")

    ms = cuda_ms(lambda: sk.whole_search(*roots, packed, cfg), reps=5)
    plain_ms = cuda_ms(lambda: sk.whole_search_reference(*roots, packed, cfg), reps=3, warmup=0)
    flops = search_flops(
        h, nb, cfg.num_actions, max(cfg.num_actions, cfg.codebook_size), BATCH, s, value_bins, reward_bins
    )
    read_once = packed if value_bins > 1 or reward_bins > 1 else packed[:7]  # the cat pack only when a head uses it
    weight_bytes = sum(t.numel() * t.element_size() for t in read_once)
    io_bytes = sum(t.numel() * 4 for t in roots) + 3 * visits.numel() * 4
    card = sku(torch.cuda.get_device_name(0))
    op_ms = flops / (FP32_TFLOPS[card] * 1e12) * 1e3
    byte_ms = (weight_bytes + io_bytes) / (HBM_TBPS[card] * 1e12) * 1e3
    print(
        f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {max(op_ms, byte_ms):.3f} ms "
        f"({flops:.3g} FLOP at {FP32_TFLOPS[card]} TFLOP/s FP32 ({card}); {weight_bytes + io_bytes} B), "
        f"B={BATCH} S={s} H={h} NB={nb} value_bins={value_bins} reward_bins={reward_bins}"
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "simulate_2048_tpu_torch/csrc/whole_search.cu",
        # the TPU kernel's body; its categorical-head reduction (cat_expect) for the categorical variant
        "replaces": "simulate_2048_tpu/ops/pallas_search.py:" + ("249" if value_bins == reward_bins == 1 else "414"),
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
    kernel_config = dataclasses.replace(config, search_backend="pallas")
    kernel_state, *_ = _evaluate_rollout(network, SEED, kernel_config, 32, device)
    plain_state, *_ = _evaluate_rollout(network, SEED, dataclasses.replace(config, search_backend="xla"), 32, device)
    same = (kernel_state.board == plain_state.board).flatten(1).all(-1) & (
        kernel_state.total_reward == plain_state.total_reward
    )
    print(f"small evaluation (H=64, NB=2, S=16, 32 games, 40 moves): {int(same.sum())}/32 games identical")
    if int(same.sum()) < 31:
        fail("small evaluation: kernel and plain search backends disagree on more than one game")


def perturb_categorical_heads(network, generator: torch.Generator) -> None:
    """0.05 * normal on the weights of the categorical heads, which are zero when fresh."""
    device = next(network.parameters()).device
    with torch.no_grad():
        for head in (network.prediction.value, network.afterstate_prediction.q_value, network.dynamics.reward):
            if head.out_features > 1:
                head.weight.add_(0.05 * torch.randn(head.weight.shape, generator=generator).to(device))


def check_small_training(device) -> None:
    """A greedy self-play segment with categorical heads on a small config:
    kernel backend vs plain search backend, game for game."""
    games, moves = 32, 30
    config = dataclasses.replace(tiny_config(), num_simulations=16, value_bins=16, reward_bins=8)
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, gen, device)
    perturb_categorical_heads(network, gen)
    out = {}
    for backend in ("pallas", "xla"):
        state = envlib.reset_batch(SEED, games, device)
        cfg = dataclasses.replace(config, search_backend=backend)
        _, out[backend], _ = play_segment(network, state, None, 0.0, cfg, games, greedy=True, num_steps=moves)
    k, p = out["pallas"], out["xla"]
    same = (
        (k.boards == p.boards).flatten(1).all(-1)
        & (k.actions == p.actions).all(-1)
        & (k.rewards == p.rewards).all(-1)
        & (k.length == p.length)
        & (k.terminated == p.terminated)
    )
    value_err = float((k.values[same] - p.values[same]).abs().max())
    print(
        f"small training segment (H=64, NB=2, S=16, bins 16/8, {games} games, {moves} greedy moves): "
        f"{int(same.sum())}/{games} trajectories identical, max |value difference| {value_err:.3g}"
    )
    if int(same.sum()) < games - 1:
        fail("small training segment: kernel and plain search backends disagree on more than one game")
    if not torch.allclose(k.values[same], p.values[same], rtol=1e-4, atol=1e-3):
        fail("small training segment: stored search values outside rtol 1e-4, atol 1e-3")


def training_config():
    """The paper preset's widths with the categorical heads and learning
    settings of the repo's training recipe; depth cut to a smoke test."""
    return dataclasses.replace(
        default_config(),
        value_bins=256,
        reward_bins=128,
        value_target_mode="td_lambda",
        td_lambda=1.0,
        cross_segment_backfill=True,
        afterstate_value_loss_weight=0.25,
        max_trajectory_length=TRAIN_SEGMENT_MOVES,
        min_buffer_size=2 * BATCH,  # two segments of every game before the first step: backfill runs
        replay_buffer_size=8 * BATCH,
        generation_interval=TRAIN_STEPS // 2,
        warmup_steps=4,
        log_interval=1,
        checkpoint_interval=TRAIN_STEPS,
        eval_interval=TRAIN_STEPS,
        eval_games=BATCH,
        eval_max_moves=TRAIN_EVAL_MOVES,
    )


def drive_training(device) -> dict[str, int]:
    """The training path at full width through ``train_muzero``. Returns the kernel launch counts of the run."""
    config = training_config()
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_muzero(config, checkpoint_dir=ckpt_dir, num_steps=TRAIN_STEPS, seed=SEED, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)

        # The checkpoint written at the last step, read back into a fresh state, equals the trained one.
        fresh = network_from_config(config, torch.Generator().manual_seed(SEED + 7), device)
        restored = TrainState(fresh, create_optimizer(config).init(list(fresh.parameters())))
        if CheckpointManager(ckpt_dir).restore(restored) is None:
            fail("training path: no checkpoint was written")
    trained = trainer.state
    same = all(torch.equal(a, b) for a, b in zip(restored.params, trained.params))
    for name in ("mu", "nu"):
        same &= all(torch.equal(a, b) for a, b in zip(restored.opt_state[name], trained.opt_state[name]))
    if not (same and restored.step == trained.step == TRAIN_STEPS and restored.opt_state["count"] == TRAIN_STEPS):
        fail("training path: the restored checkpoint differs from the saved state")

    history = trainer.get_metrics_history()
    gens = [r for r in history if "gen/positions" in r]
    steps = [r for r in history if "total_loss" in r]
    evals = [r for r in history if "eval/mean_reward" in r]
    if len(gens) < 2 or len(steps) != TRAIN_STEPS or len(evals) != 1:
        fail(f"training path: {len(gens)} segments, {len(steps)} logged steps, {len(evals)} evaluations")
    loss_terms = [k for k in steps[0] if k.endswith("_loss") or k == "codebook_entropy"]
    if not all(torch.isfinite(torch.tensor([r[k] for k in loss_terms])).all() for r in steps):
        fail("training path: a loss term is not finite")
    initial = network_from_config(config, torch.Generator().manual_seed(SEED), device)
    changed = sum(not torch.equal(a, b) for a, b in zip(initial.parameters(), trained.params))
    if changed < len(trained.params) // 2:
        fail(f"training path: only {changed} of {len(trained.params)} parameter tensors changed")

    self_play_moves = len(gens) * TRAIN_SEGMENT_MOVES
    if launches["whole_search_categorical"] != self_play_moves + TRAIN_EVAL_MOVES or launches["whole_search"] != 0:
        fail(
            f"training path: launches {launches} for {self_play_moves} self-play moves "
            f"and {TRAIN_EVAL_MOVES} evaluation moves"
        )
    gen_s = sum(r["gen/seconds"] for r in gens)
    positions = sum(r["gen/positions"] for r in gens)
    # Steps that share their log interval with a generated segment are left out of the learner's rate.
    gen_steps = {r["step"] + 1 for r in gens}
    pure = [r["steps_per_s"] for r in steps if r["step"] not in gen_steps]
    step_ms = statistics.median(1e3 / x for x in pure)
    print(
        f"training path: {len(gens)} segments of {TRAIN_SEGMENT_MOVES} moves x {BATCH} games in {gen_s:.2f} s: "
        f"{positions / gen_s:.1f} game-moves/s, {1e3 * gen_s / self_play_moves:.2f} ms per move "
        f"(the kernel alone at B={BATCH}: timed above)"
    )
    print(
        f"training path: {len(steps)} learner steps (batch {config.batch_size}, unroll {config.num_unroll_steps}): "
        f"median {step_ms:.2f} ms per step, {1e3 / step_ms:.2f} steps/s; whole run {wall:.1f} s; "
        f"{changed}/{len(trained.params)} parameter tensors changed; checkpoint round trip exact"
    )
    print("training path: total loss by step: " + " ".join(f"{r['total_loss']:.4f}" for r in steps))
    print(
        "training path: last step "
        + " ".join(f"{k}={steps[-1][k]:.4f}" for k in loss_terms)
        + f"; evaluation mean reward {evals[0]['eval/mean_reward']:.1f} over {TRAIN_EVAL_MOVES} moves"
    )
    return launches


def profile_device(label: str, fn, units: int, unit: str) -> None:
    """torch.profiler over ``fn()`` (which does ``units`` ``unit``s of work):
    device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"profile {label}: {units} {unit}s, wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"(summed kernel time), idle share {max(0.0, 1 - busy_us / wall_us):.3f}, "
          f"{calls / units:.1f} device kernels per {unit}")
    for e in events[:12]:
        print(f"profile {label}:   {e.self_device_time_total / 1e3 / units:9.3f} ms/{unit}  "
              f"{e.count // units:5d} calls/{unit}  {e.key[:90]}")


def profile_paths(device, moves: int = 5, steps: int = 3) -> None:
    """Profiles of a few evaluation moves, self-play moves and learner steps at full width."""
    config = dataclasses.replace(default_config(), eval_max_moves=moves)
    network = network_from_config(config, torch.Generator().manual_seed(SEED), device)
    profile_device("evaluation", lambda: _evaluate_rollout(network, SEED, config, BATCH, device), moves, "move")

    from simulate_2048_tpu_torch.training.trainer import Trainer

    train_config = dataclasses.replace(training_config(), min_buffer_size=BATCH)
    trainer = Trainer(train_config, seed=SEED, device=device)
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    profile_device(
        "self-play",
        lambda: play_segment(trainer.network, trainer.gen_state, gen, 1.0, train_config, BATCH, num_steps=moves),
        moves,
        "move",
    )
    profile_device("learner", lambda: [trainer.optimize_step() for _ in range(steps)], steps, "step")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true", help="also profile a few moves and learner steps")
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

    kernels = {
        "whole_search": check_whole_search(device),
        "whole_search_categorical": check_whole_search(device, "whole_search_categorical", 256, 128),
    }
    check_small_evaluation(device)
    check_small_training(device)

    # ---- evaluation path: greedy evaluation at the full preset on the card
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
        f"evaluation path: {BATCH} games, mean reward {stats['mean_reward']:.1f}, "
        f"mean length {stats['mean_length']:.1f}, "
        f"{moves_played} moves in {wall:.2f} s: {total_moves / wall:.1f} game-moves/s, "
        f"{1e3 * wall / max(moves_played, 1):.2f} ms per move "
        f"(the kernel alone at B={BATCH}: {kernels['whole_search']['ms']:.2f} ms, timed above)"
    )
    kernels["whole_search"]["launches"] = launches["whole_search"]
    if launches["whole_search"] != moves_played or launches["whole_search_categorical"] != 0:
        fail(f"whole_search launched {launches['whole_search']} times for {moves_played} moves")
    rewards = torch.tensor(stats["per_game_rewards"])
    if not torch.isfinite(rewards).all() or max(lengths) > MAIN_PATH_MAX_MOVES or len(lengths) != BATCH:
        fail("evaluation path: non-finite rewards or game lengths beyond the cap")

    # ---- training path: self-play, replay, learner, checkpoint, evaluation at full width
    kernels["whole_search_categorical"]["launches"] = drive_training(device)["whole_search_categorical"]

    if args.profile:
        profile_paths(device)

    print(json.dumps({"kernels": list(kernels.values())}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))


if __name__ == "__main__":
    main()

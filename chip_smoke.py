"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python chip_smoke.py``.

Drives the port (``simulate_2048_tpu_torch``) on the card and fails (exit
code != 0, no final ``ok`` line) if any phase fails:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel from the sources in the checkout (one ``nvcc``
   per library, started together: the whole-search source builds one library
   per weight variant) and prints the build seconds;
3. holds each kernel against its plain PyTorch version at the shapes the
   main paths give it: the random-rollout kernel at 65,536 boards x 128
   steps, with the seeds given and with the seeds derived in the launch (all
   four outputs equal, and games must have ended so that the reset branch
   ran), and its own move, spawn and end test (``rk.board_ops_kernel``)
   against ``ops/board.py`` on every 16-bit row of 4-bit cells in every
   direction and on boards of exponents 13-17, which take its exact path;
   and the whole-search kernel at the full preset (H=256,
   10 residual blocks, 100 simulations, depth cap 32) with seeded random
   weights: with scalar heads on B=256 searches a launch (the evaluation
   path), and with categorical heads of 256 value and 128 reward bins at
   every launch size of the training path: 256 (self-play and the inline
   evaluation), 128 (deep evaluation), 1,024 and 512 (the batches of a
   search-mode reanalyze pass). At each size visit counts must be identical
   in at least 99% of the searches (each differing search is printed with
   its root visits and the Q gap of its two most visited actions) and total
   S in every search; root Q and value agree within rtol 1e-4 / atol 1e-3 on
   the matching searches (float32 sums taken in another order). Then the
   streamed float32 kernel at hidden 512 at 256: at least 99% of the
   searches agree. The two bfloat16 libraries, both on the tensor cores:
   the resident one (c) at the paper preset with 256/128 bins at 256 and
   1,024 searches a launch and at hidden 96 (no power of two, which the
   plan keeps resident) at 256, the streamed one (d, chunk 8) at hidden 512
   at every launch size of the wide path (256, 512 and 128): exact
   invariants (S visits, none on a zero prior, finite values) and the
   order-noise rule (``check_order_noise``: no more searches disagree with
   the tree plain version than twice those in which the tree and k-step
   plain versions disagree, or 1%; JAX's aggregate bfloat16 rule); (c) and
   (d) on one network bit for bit in visits, Q and root value at H=256
   (256 and 1,024 searches) and at H=96; each library's dense layers alone
   (``sk.dense_probe``) on every layer of its packs (H=256 and 96; H=512
   and 96), each output within 2^-16 sum |w x| of the exact sum; HMMA
   instructions in each one's machine code, no stack frame and no spill.
   The streamed float32 kernel against the resident one at H=256, chunks 2
   and 8: bit for bit; both layouts timed in turns at 256 and 1,024
   searches in both types;
   and the ring all-reduce kernel (one pass; ptxas must report no stack
   frame and no spills in any of its 45 instantiations, float32 / bf16 /
   fp16 x N = 2..16) at N = 2, 4 and 8 virtual ranks on the card, in
   float32, bf16 and fp16, at the full model's flattened gradient length
   (35.0 MB in float32) and at an odd length (also on unaligned views),
   twice: bit for bit its plain version (the rotation order), float32 also
   within rtol 1e-5 of PyTorch's own sum; float64 CUDA shards must raise;
4. times each kernel (CUDA events after warm-up, median of 5; 3 for the
   new variants) beside its plain version and its bound: the FP32 operations
   a search needs (at the bf16 tensor-core rate for a bfloat16 pack; beside
   it each library's launch shape: blocks, weight stages and rows T of a
   tile, the blocks the card keeps resident at once; the
   bytes the kernel reads from L2 per call; and ptxas's registers, stack
   frame and spills, printed after the build, where a stack frame or a
   spill in the float32 resident or a tensor-core library fails the
   run), the integer
   operations a rollout's definition forces (beside it, what the rollout
   kernel's source spends, as its share of the INT32 instruction rate; the
   rollout kernel timed over 10 launches enqueued behind a sleep), and the
   bytes an all-reduce must move (which the one-pass kernel moves and no
   more; float32 at N = 2, 4, 8 and bf16 at N = 4, the kernel and the
   PyTorch call that computes the same sum timed over 20 calls enqueued
   behind a sleep), with the share of the bound and the achieved TB/s;
5. checks greedy evaluation, a greedy self-play segment with categorical
   heads and a search-mode reanalyze of that segment on a small config on
   the card: the kernel backend against the plain search backend, game for
   game and position for position; then the draws that sampled self-play
   and replay take on the card (``check_self_play_draws``, 2^20 of each,
   each statistic within 6 standard errors): the root's Dirichlet noise at
   the scalar recipe's alpha 0.25 over 4 actions, drawn a move at a time
   as self-play draws it (each component's mean 0.25 and variance 0.09375;
   the largest share beside numpy's draws), the action uniforms (mean 1/2,
   variance 1/12) and their correlation with the noise drawn before them
   from the same generator, ``sample_from_visits``'s action shares from
   fixed visit weights, and the replay's (episode, start) draws (a
   chi-square over the episodes, the mean start);
6. drives the rollout path, ``simulate_2048_tpu_torch.bench`` on the card
   (65,536 boards x 128 steps, a warm-up and five repetitions: six kernel
   launches, each deriving its seeds), and prints its JSON line;
7. drives the evaluation path, ``evaluate_games`` at ``default_config()`` on
   256 games with ``eval_max_moves`` capped, with the launch counts set to 0
   just before; the kernel must have launched once per move played;
8. drives the training path, ``train_muzero`` at ``default_config()`` with
   the categorical heads, learning settings, search-mode reanalyze and deep
   evaluation of the repo's training recipe (depth cut: short segments, a
   small buffer, a dozen learner steps, one reanalyze pass of 64 episodes,
   one checkpoint written and read back, one inline evaluation and one deep
   evaluation of 128 games), again with the launch counts set to 0 just
   before: one kernel launch per self-play, evaluation and deep-evaluation
   move and per batch of reanalyze searches, finite loss terms, changed
   parameters, a checkpoint equal to the saved state, the champion in
   ``best/``, and reanalysed policy targets that sum to 1;
9. drives the recipe path (``drive_recipe_path``): the champion recipe
   ``simulate_2048_tpu_torch/scripts/run_cat60k_twin.sh`` at its own widths
   (``small_config()`` with the script's overrides, read from the script:
   H=128, 5 blocks, 64 games, 50 simulations, batch 256, 256/128 bins):
   the categorical kernel against its plain version at 64 searches under
   the self-play search and under the evaluation search (prior temperature
   4, pb_c_init 0.5), the float32 rule above, timed; a self-play move of
   the 64 games under the literal recipe's ``search_backend="xla"`` (the
   plain search) and under "auto" (the kernel), in turns; then a cut run
   through ``Trainer`` with the launch counts set to 0 just before (2
   segments of 24 moves, 40 learner steps, one evaluation of 32 games
   capped at 100 moves, a checkpoint read back): only
   ``whole_search_categorical`` launched, once per self-play and
   evaluation move, finite losses, the learner's ms per step and the peak
   device memory printed; then 3 moves and 5 learner steps under
   ``utils.profiling.trace`` and ``trace_summary`` on the trace as a
   process, which must list ``whole_search_kernel`` 3 times;
10. drives the diagnosis path (``drive_diagnosis_path``) on the recipe
   path's cut-run checkpoint (categorical, H=128, step 40): the diagnoses'
   prior ablations (``autopsy_eval.flat_prior``, ``prior_sweep.soften_prior``
   at T=2 and T=4, weight transforms) on the kernel against the plain search
   on the untouched network with its ``prediction`` wrapped as the JAX
   scripts wrap it, under the recipe's evaluation search (64 searches x 50
   simulations) from mid-game roots, the policy logits scaled by the first
   of 1, 4, 16, 64, 256 at which every ablation moves some search off the
   untouched network's: visit counts identical in 64 of 64 searches, Q and
   root value within rtol 1e-4 / atol 1e-3; then ``autopsy_eval``,
   ``prior_sweep``, ``model_probe`` and ``compare_scalar60k`` as processes
   started together on that checkpoint (8 games, 50-move
   evaluations, the recipe's bins and ``search_backend=auto``): every JSON
   line with the JAX script's keys and finite numbers, and every variant's
   line on standard error naming ``whole_search_categorical`` with its
   launches; then the kernel against its plain version and timed at the
   diagnoses' own shapes (8 searches x 50 simulations, and x 100 for
   ``autopsy_eval``'s raised budget), one kernels-line entry for each
   simulation count with the launches the diagnoses made at it;
11. drives the actor/learner path at the training path's widths and cut,
   parameters published every 4 steps (``drive_actor_learner``): in this
   process, a ``LearnerServer`` and an ``ActorClient`` (in a thread) on the
   card, bit for bit: the actor's parameters are the published snapshot, its
   three generations equal direct ``generate_games`` calls (the third after
   4 learner steps, on their parameters), the learner's buffer equals
   ``ingest_segment`` applied directly; the learner's steps/s serial and
   solo; then the two roles as processes,
   ``python -m simulate_2048_tpu_torch.actor_learner_demo --role learner``
   and ``--role actor``, each under a timeout (either failing stops the
   other and fails the run): the learner's 12 steps with a finite loss, at
   least 2 batches received and a pull served per actor generation, the
   actor's ``whole_search_categorical`` launches equal to its moves, the
   learner's launches only its evaluations' and reanalyze's, a learner step
   above 0 seen by the actor, no kernel library rebuilt; printed with the
   card's name and power limit: the learner's steps/s solo, overlapped and
   serial, ``overlap_efficiency``, the actor's ms per move alone and while
   the learner trains, and each process's peak device memory;
12. drives the probe's evaluation path, ``evaluate_games`` at the
   full-capacity probe's recipe (bfloat16 search packs, 256/128 bins, its
   evaluation calibration) at its own width, H=256, whose weights the kernel
   keeps resident: 256 games of 8 moves, with the launch counts set to 0
   just before: one resident bfloat16 launch per move; printed beside the
   kernel's time, bound, launch shape and registers;
13. drives the wide path, ``train_muzero`` at the same recipe with hidden
   512, which the kernel runs with streamed weights: two 8-move segments,
   three learner steps, one reanalyze pass, one evaluation and one deep
   evaluation of 8 moves, with the launch counts set to 0 just before: one
   streamed bfloat16 launch per move and per batch of reanalyze searches,
   finite loss terms;
14. drives the data-parallel path, ``Trainer(mesh=...)`` over a virtual
   mesh of 4 replicas of the card at the training recipe's widths (batch
   1,024 = 4 x 256): one self-play segment, one fused data-parallel
   superstep of 4 steps and one per-step step, with the launch counts set
   to 0 just before: one ring launch per step, replicas bit-identical,
   finite losses, changed parameters; then one data-parallel step from a
   copy of the state against the single-device step on the same batch
   (loss rtol 1e-5, priorities rtol 1e-4, the applied gradient within 2^-8
   relative L2, each parameter within two Adam steps);
15. runs the measurement entry points (``simulate_2048_tpu_torch.scripts``)
   as processes on the card, each under a timeout (``drive_entry_points``):
   ``benchmark_mcts --pallas`` at the full preset (256 boards, 100
   simulations, depth cap 32) once per search library, each reaching its
   library (six launches, no other) and taking between the kernel's own
   time at 256 searches and twice it a batch; the plain search at 16
   simulations; ``benchmark_training --mode full --steps 5 --dtype both``,
   its ``flops_per_step`` equal to ``learner_step_flops`` (the dense
   products of one step) in both dtypes;
   ``verify_parity`` at its defaults (``PARITY OK``); ``benchmark_scaling
   --virtual 4 --steps 16``, one ring launch per data-parallel step on 2
   and 4 replicas of the card; ``measure_overlap --mode tiny --steps 10``
   with self-play on the kernel (rates positive, trajectory batches
   streamed); ``multihost_demo`` as one NCCL rank (three finite losses);
   ``warm_compile scalar60k cat60k`` (one launch of each arm's library); no
   library rebuilt; each script's numbers printed beside the card's name
   and power limit;
16. runs the plain search's variants on the card: at the paper preset
   (256/128 bins, 256 searches) PUCT, the Gumbel root, sampled chance
   selection and argmax chance selection under progressive widening
   (pw_c=1.0), each timed (CUDA events, median of 3 calls, the first of
   them the one checked) beside the kernel's PUCT time, S visits, none on a
   zero prior, finite values; at H=64, 2 blocks, 16 simulations, 256
   searches, each variant (and all three at once) on CUDA and on the CPU from the same roots and fed draws: visit
   counts identical in >= 99% of the searches, the CUDA call timed by
   ``utils.profiling.time_fn``;
17. drives the variant path, ``train_muzero`` at the training recipe's widths
   with the Gumbel root, sampled chance selection and widening, backend
   "auto": two 4-move segments of 256 games, two learner steps, one
   search-mode reanalyze pass of 1,024 searches, one 4-move evaluation and
   one 4-move deep evaluation of 128 games (its games seeded by a generator
   on the CPU, as the ``evaluate`` CLI seeds them), with the launch counts
   set to 0 just before: no kernel launch (the evaluation searches keep
   sampled chance selection and widening, as in the JAX package, so they
   are the plain search's too), finite losses, changed parameters, stored
   policy targets (the improved policy) that sum to 1 and are positive on
   every legal action, the ms per self-play move; then the network's evaluation under the Gumbel root alone: one
   ``whole_search_categorical`` launch per move;
18. prints one JSON line with every kernel's numbers, then
   ``{"ok": true, "device": {...}}`` as the last line.

``--profile`` also prints the device time by kernel, the device kernels
launched and the device's idle share over 20 ``bench`` repetitions, a few
evaluation moves, self-play moves and learner steps, one reanalyze pass and
one call of the plain search under the Gumbel root at full width (and its
idle share without the profiler: the profiled device time against the
call's CUDA-event time), and the whole-search kernel's rate at 256 to
2,048 searches a launch.
Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench.harness.flops import search_flops
from perfbench.harness.trace import union_ns
from simulate_2048_tpu_torch import bench
from simulate_2048_tpu_torch.actor_learner_demo import hook_steps
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.ops import board as board_ops
from simulate_2048_tpu_torch.ops import rng as tfrng
from simulate_2048_tpu_torch.ops import rollout_kernel as rk
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.ops.value_transform import inverse_scale_value
from simulate_2048_tpu_torch.parallel import make_dp_train_step, make_mesh
from simulate_2048_tpu_torch.parallel import ring
from simulate_2048_tpu_torch.parallel.actor_learner import ActorClient, LearnerServer, _to_numpy
from simulate_2048_tpu_torch.scripts import autopsy_eval, prior_sweep, recipes, trace_training
from simulate_2048_tpu_torch.search import mcts
from simulate_2048_tpu_torch.search.mcts import root_inputs
from simulate_2048_tpu_torch.search.policy import sample_from_visits
from simulate_2048_tpu_torch.training import config as config_lib
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager, load_train_config
from simulate_2048_tpu_torch.training.config import default_config, tiny_config
from simulate_2048_tpu_torch.training import reanalyze
from simulate_2048_tpu_torch.training import replay as replay_lib
from simulate_2048_tpu_torch.training.learner import TrainState, create_optimizer, learning_rate, train_step
from simulate_2048_tpu_torch.training.self_play import (
    _evaluate_rollout,
    _use_kernel,
    evaluate_games,
    generate_games,
    play_segment,
    search_config_from,
)
from simulate_2048_tpu_torch.training.trainer import Trainer, ingest_segment, train_muzero
from simulate_2048_tpu_torch.utils.card import BF16_TFLOPS, FP32_TFLOPS, HBM_TBPS, card_line, sku
from simulate_2048_tpu_torch.utils.profiling import time_fn

SEED = 2048
BATCH = 256
MAIN_PATH_MAX_MOVES = 100  # evaluation path: moves per game
# Rollout path: the benchmark's own size.
ROLLOUT_BOARDS, ROLLOUT_STEPS = 65_536, 128
ROLLOUT_CALLS = 10  # launches per CUDA-event timing of the rollout kernel, enqueued behind a sleep
# Training path, depth cut (widths, games, batch and unroll are the preset's):
TRAIN_SEGMENT_MOVES = 24  # max_trajectory_length
TRAIN_STEPS = 12  # the first has learning rate 0 (warm-up starts there)
TRAIN_EVAL_MOVES = 8  # eval_max_moves, of the inline and of the deep evaluation
REANALYZE_EPISODES = 64  # the training recipe's; one pass, before step TRAIN_STEPS // 2 (the recipe: every 500)
DEEP_EVAL_GAMES = 128  # the training recipe's; one deep evaluation, after the last step (the recipe: every 25,000)
# Wide path: the full-capacity probe's recipe at hidden 512 (bfloat16 search packs, streamed), depth cut further.
# Actor/learner path: the training path's cut, its parameters published every AL_SYNC steps.
AL_SYNC = 4  # generation_interval, the learner's param_sync_interval
AL_ACTOR_SEED = 1
AL_GENERATIONS = 10  # the actor's: two fill the buffer, the rest play while the learner takes TRAIN_STEPS steps
AL_RATE_STEPS = 8  # steps of each serial and solo learner rate (two self-play segments in the serial one)
AL_TIMEOUT = 300  # seconds each role process may take
AL_LOG_LINES = 4  # lines of each role's output printed (40 of one that failed)

WIDE_HIDDEN = 512
WIDE_SEGMENT_MOVES = 8  # two segments: one fills the buffer, the loop's step 0 plays the other
WIDE_STEPS = 3  # one reanalyze pass before step WIDE_STEPS - 1; evaluation and deep evaluation after the last
# Launch sizes of the categorical whole-search kernel on the training path.
TRAIN_SEARCH_BATCHES = (reanalyze.SEARCH_BATCH, REANALYZE_EPISODES * TRAIN_SEGMENT_MOVES % reanalyze.SEARCH_BATCH,
                        BATCH, DEEP_EVAL_GAMES)  # fmt: skip
# Launch sizes of the streamed bfloat16 kernel on the wide path: self-play and evaluation, the reanalyze pass (one
# launch), the deep evaluation.
WIDE_SEARCH_BATCHES = (BATCH, REANALYZE_EPISODES * WIDE_SEGMENT_MOVES, DEEP_EVAL_GAMES)
# The bound of the rollout: the least 32-bit integer work that the rollout's
# definition forces on any implementation. Only the Threefry calls are fixed
# by it; the move, spawn and end test are counted for the leanest scheme known
# (a board of 4-bit cells in two words, a table of slid rows), a table read as
# one operation. A Threefry-2x32 of 20 rounds on a key held in registers with
# its injection constants: 2 adds to key the counter, 20 x (add, rotate, xor),
# 5 injections of 2 adds = 72; 69 where only word 0 is used (the last round's
# rotate and xor and one add fall away).
# Every step: the action's Threefry 69 and its mask 1; the move 16 (4 rows x
# extract, look up, insert, and add the row's score); moved 2; loop 1.
# A step that moved the board: the spawn's Threefry 72; empty cells 8 (2 words
# x zero-cell mask 3 + population count 1); rank 1 (multiply-high); 2-or-4
# choice 2; placing on the rank-th empty cell 3; end-of-game test 2 (only a
# move can end a game); spawn counter 1. The reward is a float add, not counted.
# A reset: the reseed's Threefry 69, two spawns of 72 + 8 + 1 + 2 + 3, episode
# and spawn counters 2. The largest tile can wait for a reset or the end.
ROLLOUT_MIN_OPS = {"step": 89, "moved": 89, "reset": 243}
# A launch that derives its boards' seeds: one more Threefry of which only word 0 is used, a board.
ROLLOUT_SEED_MIN_OPS = 69
# What csrc/random_rollout.cu spends, one per C operator of its source: not a
# bound, but the work whose rate says how well the kernel issues. A Threefry-2x32
# is 79 (2 for the third key word, 2 to add the key, 20 rounds of add / rotate /
# xor, 5 key injections of 3 adds); a table read 3 (index, address, load); a
# transpose of the 4-bit board 14 (2 byte permutes, 2 nibble swaps of 6).
# Every step 123: the action's Threefry and its mask 80; the loop 2; the path
# test 1; the move 35 (transpose 14, bit test 2, 2 selects, the table's offset
# 3, four table reads 12, 2 byte permutes to join the rows); moved 4; the reset
# test 1.
# A step that moved the board 154: the spawn's Threefry 79; settling the move
# 30 (transpose back 14, bit test 2, 2 selects, 2 byte permutes for the scores,
# the 15 flag 3, the score 7); the spawn 39 (empty-cell masks 12, prefix
# counts 2, counts 3, rank 1, word 2, want 2, its zero-nibble test 7, the tile
# 6, placing it 4); reward and counter 3; the empty-cell test 1; the exact
# path's test 2.
# A step whose spawn filled the last empty cell 34: the neighbour test.
# A reset 333: the largest cell 16, counters 2, the reseed's Threefry 79, two
# spawns of 79 + 39.
ROLLOUT_SOURCE_OPS = {"step": 123, "moved": 154, "full": 34, "reset": 333}
ROLLOUT_SEED_OPS = 79  # a launch that derives its seeds: the derivation's Threefry, a board
INT32_LANES_PER_SM = 64  # Hopper: 4 partitions of 16 INT32 lanes
# Data-parallel path: a virtual mesh of DP_REPLICAS replicas on one card, one self-play segment, then one fused
# superstep of DP_SUPERSTEP steps and one per-step step.
DP_REPLICAS = 4
DP_SUPERSTEP = 4
# Ring all-reduce check: ranks, and an odd shard length beside the full model's flattened gradient.
RING_RANKS = (2, 4, 8)
RING_ODD_LENGTH = 1_000_003
RING_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
RING_CALLS = 20  # launches per CUDA-event timing of the ring (a launch takes ~0.1 ms, its host work about as much)
SLEEP_CYCLES = 1 << 25  # the device's sleep (~17 ms) behind which RING_CALLS calls are enqueued
# ptxas's mangling of the ring kernel's element types.
RING_PTXAS_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "6__half": "float16"}
# check_whole_search's times by check name and searches a launch: (kernel ms, bound ms).
KERNEL_TIMES: dict[str, dict[int, tuple[float, float]]] = {}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def timed_once(fn):
    """``fn()``'s result and its CUDA-event time in ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int, warmup: int = 1, calls: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup`` calls.
    With ``calls`` > 1 each timing spans that many calls in a row, enqueued
    while the stream is held busy by a sleep of SLEEP_CYCLES clocks, so that
    it is the device's time alone: for a kernel of ~0.1 ms the host's launch
    overhead is as long as the kernel. Only for functions of a few launches:
    a stream takes only so many ahead of the device."""
    for _ in range(warmup):
        fn()
    if calls == 1:
        return statistics.median(timed_once(fn)[1] for _ in range(reps))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if start.query():
            print(f"note: the device finished its sleep before {calls} calls were enqueued; the time holds host gaps")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


DRAWS = 1 << 20  # draws of each distribution in check_self_play_draws
DRAW_SIGMAS = 6.0  # its bound: this many standard errors of the statistic


def within(label: str, got: float, want: float, se: float) -> str:
    """``got`` against ``want`` within DRAW_SIGMAS standard errors ``se``: a report, or fail."""
    bound = DRAW_SIGMAS * se
    if not abs(got - want) <= bound:
        fail(f"self-play draws: {label} {got:.6g}, expected {want:.6g} within {bound:.3g}")
    return f"{label} {got:.6f} (expected {want:.6f}, bound {bound:.2g})"


def check_self_play_draws(device) -> None:
    """The draws self-play and replay take on the card, against their
    distributions and numpy's: the root's Dirichlet noise
    (``mcts.draw_root_noise``, ``torch._sample_dirichlet`` at the recipe's
    alpha over 4 actions: mean alpha / (4 alpha), variance (1/4)(3/4) /
    (4 alpha + 1)), drawn as self-play draws it (one call of the recipe's 64
    games a move, from a CUDA generator); the uniforms of
    ``sample_from_visits`` (mean 1/2, variance 1/12) and the actions it
    draws from fixed visit weights; the noise's correlation with the
    uniforms drawn after it from the same generator; and the replay's
    (episode, start) draws (``replay.sample_indices``) against the
    weights' shares (a chi-square over the episodes and over the starts of
    the heaviest episode). Each statistic over DRAWS draws, held to
    DRAW_SIGMAS standard errors; numpy's Dirichlet draws beside the card's."""
    config = recipes.recipe_config("run_scalar60k_arm.sh")
    cfg = search_config_from(config)
    games, alpha, a = config.num_parallel_games, cfg.dirichlet_alpha, cfg.num_actions
    gen = torch.Generator(device=device).manual_seed(SEED)
    calls = DRAWS // games
    noise, uniforms = [], []
    for _ in range(calls):  # the self-play loop's order: the move's noise, then its action uniforms
        noise.append(mcts.draw_root_noise(cfg, games, gen, device))
        uniforms.append(torch.rand(games, generator=gen, device=device))
    noise = torch.cat(noise).double().cpu().numpy()
    uniforms = torch.cat(uniforms).double().cpu().numpy()
    ref = np.random.default_rng(SEED).dirichlet([alpha] * a, size=len(noise))
    n = len(noise)
    mean, var = 1.0 / a, (1.0 / a) * (1 - 1.0 / a) / (a * alpha + 1)
    fourth = float(np.mean((ref - mean) ** 4))  # the fourth central moment, from numpy's draws
    lines = []
    for j in range(a):
        lines.append(within(f"noise[{j}] mean", float(noise[:, j].mean()), mean, math.sqrt(var / n)))
        lines.append(within(f"noise[{j}] variance", float(noise[:, j].var()), var, math.sqrt((fourth - var**2) / n)))
    if not np.allclose(noise.sum(-1), 1.0, atol=1e-5) or (noise < 0).any():
        fail("self-play draws: Dirichlet noise rows off the simplex")
    top, ref_top = np.sort(noise, -1)[:, -1], np.sort(ref, -1)[:, -1]
    se_top = math.sqrt(top.var() / n + ref_top.var() / n)
    lines.append(within("noise largest share (numpy's draws beside)", float(top.mean()), float(ref_top.mean()), se_top))
    lines.append(within("uniform mean", float(uniforms.mean()), 0.5, math.sqrt(1 / 12 / n)))
    lines.append(within("uniform variance", float(uniforms.var()), 1 / 12, math.sqrt((1 / 80 - 1 / 144) / n)))
    corr = float(np.corrcoef(noise[:, 0], uniforms)[0, 1])
    lines.append(within("corr(noise[0], the move's uniform)", corr, 0.0, 1 / math.sqrt(n)))
    weights = torch.tensor([[0.1, 0.2, 0.3, 0.4]], device=device).expand(DRAWS, a)
    out = mcts.PolicyOutput(weights, torch.zeros(DRAWS, device=device), torch.zeros_like(weights), weights)
    actions = sample_from_visits(out, torch.ones_like(weights, dtype=torch.bool), 1.0, gen)
    freq = torch.bincount(actions, minlength=a).double().cpu().numpy() / DRAWS
    for j, p in enumerate((0.1, 0.2, 0.3, 0.4)):
        lines.append(within(f"sample_from_visits action {j} share", float(freq[j]), p, math.sqrt(p * (1 - p) / DRAWS)))

    # The replay's draws: a buffer of the recipe's segment length whose priorities numpy makes.
    rs = np.random.RandomState(SEED)
    rcfg = dataclasses.replace(config, replay_buffer_size=1000, batch_size=DRAWS // 16)
    buffer = replay_lib.init_buffer(rcfg, device)
    b, t = 576, rcfg.max_trajectory_length
    length = rs.randint(20, t + 1, size=b)
    terminated = rs.rand(b) < 0.5
    live = np.arange(t)[None] < length[:, None]
    traj = replay_lib.Trajectory(
        boards=torch.zeros(b, t + 1, 16, dtype=torch.int8),
        actions=torch.zeros(b, t, dtype=torch.int8),
        rewards=torch.zeros(b, t),
        policies=torch.full((b, t, a), 0.25),
        values=torch.zeros(b, t),
        priorities=torch.from_numpy((rs.gamma(0.5, 20.0, size=(b, t)) * live).astype(np.float32)),
        length=torch.from_numpy(length.astype(np.int32)),
        terminated=torch.from_numpy(terminated),
        total_reward=torch.zeros(b),
        max_tile=torch.zeros(b, dtype=torch.int32),
    )
    buffer = replay_lib.add_trajectories(buffer, replay_lib.Trajectory(*(x.to(device) for x in traj)))
    w = replay_lib._sampling_weights(buffer, rcfg).double().cpu().numpy()
    idx = torch.cat([replay_lib.sample_indices(buffer, gen, rcfg.batch_size, rcfg) for _ in range(16)]).cpu().numpy()
    p_ep = w.sum(-1)[:b] / w.sum()
    counts = np.bincount(idx[:, 0], minlength=len(w))
    chi2 = float(((counts[:b] - DRAWS * p_ep) ** 2 / (DRAWS * p_ep)).sum())
    df = b - 1
    if counts[b:].any():
        fail("replay draws: an empty buffer row was drawn")
    lines.append(within("replay episodes chi-square / dof", chi2 / df, 1.0, math.sqrt(2.0 / df)))
    steps = np.arange(t)[None, :]
    start_mean = float((w * steps).sum() / w.sum())
    start_var = float((w * steps**2).sum() / w.sum()) - start_mean**2
    if (w[idx[:, 0], idx[:, 1]] == 0).any():
        fail("replay draws: a start of zero weight was drawn")
    lines.append(within("replay start mean", float(idx[:, 1].mean()), start_mean, math.sqrt(start_var / DRAWS)))
    print(f"self-play draws on the card ({calls} moves of {games} games, alpha {alpha}; {DRAWS} draws each, "
          f"bounds {DRAW_SIGMAS:g} standard errors):")  # fmt: skip
    for line in lines:
        print(f"  {line}")


def full_width_inputs(
    device,
    value_bins: int = 1,
    reward_bins: int = 1,
    batch: int = BATCH,
    hidden: int | None = None,
    base=None,
    eval_mode: bool = True,
):
    """Seeded full-preset network (``hidden`` wide, default the preset's) and
    ``batch`` roots. Scalar heads are scaled so that values spread;
    categorical heads (zero weights when fresh, so every node would get the
    same expectation and the search would compare float noise) get
    0.05 * normal weights. ``base`` replaces the preset (``default_config()``);
    the search config is the evaluation search's without root noise, or with
    ``eval_mode`` False the self-play search's, its root priors mixed with
    seeded Dirichlet noise as self-play mixes them. Returns the network's
    float32 resident pack."""
    config = dataclasses.replace(base or default_config(), value_bins=value_bins, reward_bins=reward_bins)
    if hidden is not None:
        config = dataclasses.replace(config, hidden_size=hidden)
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
    with torch.no_grad():
        for head in (network.prediction.value, network.afterstate_prediction.q_value, network.dynamics.reward):
            if head.out_features > 1:
                head.weight.add_(0.05 * torch.randn(head.weight.shape, generator=gen).to(device))
            else:
                head.weight.mul_(20.0)
                head.bias.add_(torch.randn(head.bias.shape, generator=gen).to(device))
    obs, invalid = midgame_roots(device, batch, gen)
    cfg = search_config_from(config, eval_mode=eval_mode)
    noise = None
    if eval_mode:
        cfg = cfg._replace(dirichlet_fraction=0.0)
    else:
        noise = torch._sample_dirichlet(torch.full((batch, cfg.num_actions), cfg.dirichlet_alpha), gen).to(device)
    with torch.no_grad():
        hidden_state, probs, value = root_inputs(network, obs, cfg, invalid, noise)
    packed = sk.pack_for(network, cfg)
    return config, cfg, network, packed, (hidden_state.contiguous(), probs.contiguous(), value.contiguous())


def midgame_roots(device, batch: int, gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``batch`` mid-game boards from seeded random play (40 moves drawn from
    ``gen``): their observations and invalid-action masks (a board with no
    legal move gets none masked)."""
    state = envlib.reset_batch(SEED, batch, device)
    moves = torch.randint(0, 4, (40, batch), generator=gen).to(device)
    for t in range(moves.shape[0]):
        state, _, _, _ = envlib.step(state, moves[t])
    invalid = ~envlib.get_legal_actions(state)
    invalid[invalid.all(-1)] = False
    return envlib.get_observation(state), invalid


def root_gap(visits_a, visits_b, q_a, q_b) -> str:
    """Root visits of both sides and the Q gap between the two most visited actions."""
    a, b = visits_a.tolist(), visits_b.tolist()
    top = sorted(range(len(a)), key=lambda i: -(a[i] + b[i]))[:2]
    gaps = [abs(float(q[top[0]] - q[top[1]])) for q in (q_a, q_b)]
    return f"kernel {a} plain {b}; top-two root Q gap kernel {gaps[0]:.3g} plain {gaps[1]:.3g}"


NEAR_TIE_TRIALS, NEAR_TIE_ULPS = 64, 2


def near_tie(root, packed, cfg, got, rtol: float, atol: float) -> int | None:
    """For a float32 search whose root visits equal the plain version's but
    whose root Q or value does not: the first of ``NEAR_TIE_TRIALS`` plain
    runs of that one root (``root``: its three inputs, a batch of one) on
    the pack with every weight moved by at most ``NEAR_TIE_ULPS`` ulp (a
    seeded draw) that gives the kernel's visits, Q and value (``got``)
    within the tolerance, or None. Such a run shows a near tie deeper in the
    tree, which float noise of the plain version's own size breaks either way."""
    gen = torch.Generator().manual_seed(SEED)
    for trial in range(NEAR_TIE_TRIALS):
        moved = {}
        for field in ("hh", "vecs", "win", "wide", "wide_b", "scal", "scal_b", "cat", "cat_b"):
            t = getattr(packed, field)
            ulps = torch.randint(-NEAR_TIE_ULPS, NEAR_TIE_ULPS + 1, t.shape, generator=gen).to(t.device)
            moved[field] = t * (1 + ulps.float() * 2.0**-23)
        visits, q, value = sk.whole_search_reference(*root, packed._replace(**moved), cfg)
        if (torch.equal(visits[0], got[0]) and torch.allclose(q[0], got[1], rtol=rtol, atol=atol)
                and torch.allclose(value[0], got[2], rtol=rtol, atol=atol)):  # fmt: skip
            return trial
    return None


def bf16_differ(got, want) -> torch.Tensor:
    """Per search: visits differ, or root Q or value outside rtol 1e-3 / atol
    1e-2 (the bfloat16 agreement of ``tests/test_torch_search_variants.py``)."""
    differ = (got[0] != want[0]).any(-1)
    close = torch.isclose(got[1], want[1], rtol=1e-3, atol=1e-2).all(-1)
    return differ | ~(close & torch.isclose(got[2], want[2], rtol=1e-3, atol=1e-2))


def check_exact_invariants(name: str, out, root_p: torch.Tensor, sims: int, b: int) -> None:
    """What every launch must give exactly: S visits a search, none where
    the root prior is zero (masked actions), finite Q and root value."""
    visits, qvals, value = out
    if not (visits.sum(-1) == sims).all():
        fail(f"{name}: visit totals {visits.sum(-1).unique().tolist()} != {sims} at {b} searches a launch")
    if (visits[root_p[:, : visits.shape[1]] == 0] != 0).any():
        fail(f"{name}: visits on an action whose root prior is zero at {b} searches a launch")
    if not (torch.isfinite(qvals).all() and torch.isfinite(value).all()):
        fail(f"{name}: non-finite Q or value at {b} searches a launch")


def check_order_noise(name: str, out, tree, ksteps) -> None:
    """The tensor-core kernel's rule (its products sum in an order and with
    roundings no plain version repeats): it may disagree with the tree plain
    version (``bf16_differ``) in at most max(2 n_order, ceil(B / 100))
    searches, n_order being the searches in which the tree and the k-step
    plain versions disagree with each other, the noise of another order of
    sums (the k-step one sums the products by k-steps and takes the kernel's
    layer norms, ``sk.epilogue_layer_norm``); and it meets the JAX package's
    aggregate bfloat16 rule (``tests/test_pallas_search.py``
    TestBf16Weights): most-visited actions agree in > 70% of the searches,
    mean |root value difference| < 0.15."""
    b = out[0].shape[0]
    n_order = int(bf16_differ(ksteps, tree).sum())
    n_kernel = int(bf16_differ(out, tree).sum())
    n_ksteps = int(bf16_differ(out, ksteps).sum())
    limit = max(2 * n_order, -(-b // 100))
    agree = float((out[0].argmax(-1) == tree[0].argmax(-1)).float().mean())
    dv = float((out[2] - tree[2]).abs().mean())
    print(
        f"{name}: {b} searches a launch: n_order {n_order} (tree vs k-step plain versions), n_kernel {n_kernel} "
        f"against the tree plain version (limit max(2 n_order, ceil(B/100)) = {limit}), {n_ksteps} against the "
        f"k-step one; most-visited action agrees in {agree:.4f} (> 0.7), mean |value difference| {dv:.4g} (< 0.15)"
    )
    if n_kernel > limit or not agree > 0.7 or not dv < 0.15:
        fail(f"{name}: the searches at {b} a launch break the order-noise rule")


def check_whole_search(
    device,
    name: str = "whole_search",
    value_bins: int = 1,
    reward_bins: int = 1,
    batches: tuple[int, ...] = (BATCH,),
    hidden: int | None = None,
    weight_dtype: torch.dtype = torch.float32,
    stream_chunk: int | None = None,
    base=None,
    eval_mode: bool = True,
    timed: int | None = None,
) -> dict:
    """Kernel vs plain version at the full preset (``hidden`` wide, default
    the preset's; ``base`` and ``eval_mode`` as in ``full_width_inputs``;
    the pack in ``weight_dtype``, resident or streamed), at
    every launch size in ``batches`` (searches are independent: the plain
    version runs once, on the most roots, and a launch of b searches takes the
    first b); then the times and the bound: float32 packs at ``BATCH``
    searches, the size most launches have, a new variant at the largest size
    compared, whose plain run the comparison times. Every launch:
    ``check_exact_invariants``. Float32: visit counts identical in >= 99% of
    the searches and every such search's root Q and value within rtol 1e-4 /
    atol 1e-3, but for a search whose tree broke a near tie below the root
    the other way: its Q or value is outside that tolerance, and the plain
    version on the pack moved by a few ulp (64 tries) gives the kernel's
    result within it (``near_tie``); it counts among the 1% of searches that
    may differ. Bfloat16, resident or streamed, the tensor-core libraries:
    ``check_order_noise``, and the searches that agree (identical visits, Q
    and value within rtol 1e-3 / atol 1e-2) within that tolerance."""
    config, cfg, network, packed, roots = full_width_inputs(
        device, value_bins, reward_bins, max(batches), hidden, base, eval_mode
    )
    bf16 = weight_dtype == torch.bfloat16
    mma = bf16  # both bfloat16 libraries run on the tensor cores
    if bf16 or stream_chunk:
        packed = sk.pack_for(network, cfg, weight_dtype, stream_chunk)
    rtol, atol = (1e-3, 1e-2) if bf16 else (1e-4, 1e-3)
    h, nb, s = config.hidden_size, config.num_residual_blocks, cfg.num_simulations
    reference, reference_ms = timed_once(lambda: sk.whole_search_reference(*roots, packed, cfg))
    ksteps = sk.whole_search_reference(*roots, packed, cfg, "ksteps") if mma else None
    timed = timed or (max(batches) if bf16 or stream_chunk else BATCH)  # searches a launch in the times
    card = sku(torch.cuda.get_device_name(0))
    # bfloat16 products with float32 sums are what the tensor cores compute: their rate bounds a bfloat16 pack.
    rate, unit = (BF16_TFLOPS[card], "bf16 tensor") if bf16 else (FP32_TFLOPS[card], "FP32")
    pack_parts = dict(zip(sk.PackedSearchParams._fields, packed.tensors))
    if value_bins == reward_bins == 1:
        del pack_parts["cat"], pack_parts["cat_b"]  # the cat pack only when a head uses it
    weight_bytes = sum(t.numel() * t.element_size() for t in pack_parts.values())

    def bound(b: int) -> tuple[float, float, float, float, int]:
        """The bound at b searches a launch: (ms, operations' ms, bytes' ms, operations, bytes)."""
        flops = search_flops(h, nb, cfg.num_actions, max(cfg.num_actions, cfg.codebook_size), b, s, value_bins,
                             reward_bins)  # fmt: skip
        nbytes = weight_bytes + sum(r[0].numel() * 4 * b for r in roots) + (2 * cfg.num_actions + 1) * b * 4
        op_ms = flops / (rate * 1e12) * 1e3
        byte_ms = nbytes / (HBM_TBPS[card] * 1e12) * 1e3
        return max(op_ms, byte_ms), op_ms, byte_ms, flops, nbytes

    times = KERNEL_TIMES.setdefault(name, {})
    max_err = 0.0
    for b in batches:
        part = tuple(r[:b].contiguous() for r in roots)
        visits, qvals, value = sk.whole_search(*part, packed, cfg)
        torch.cuda.synchronize()
        ref_visits, ref_q, ref_value = (r[:b] for r in reference)
        check_exact_invariants(name, (visits, qvals, value), part[1], s, b)
        if mma:
            check_order_noise(name, (visits, qvals, value), (ref_visits, ref_q, ref_value),
                              tuple(r[:b] for r in ksteps))  # fmt: skip
        differ = (visits != ref_visits).any(-1)
        if bf16:
            differ = bf16_differ((visits, qvals, value), (ref_visits, ref_q, ref_value))
        for i in differ.nonzero().flatten().tolist()[:8 if mma else b]:
            print(f"  search {i} differs: {root_gap(visits[i].int(), ref_visits[i].int(), qvals[i], ref_q[i])}")
        if not bf16:
            close = torch.isclose(qvals, ref_q, rtol=rtol, atol=atol).all(-1)
            close &= torch.isclose(value, ref_value, rtol=rtol, atol=atol)
            for i in (~differ & ~close).nonzero().flatten().tolist():
                got = (visits[i], qvals[i], value[i])
                trial = near_tie(tuple(r[i : i + 1] for r in part), packed, cfg, got, rtol, atol)
                print(f"  search {i}: identical root visits, root Q {qvals[i].tolist()} and value {float(value[i]):.6g} "
                      f"against the plain version's {ref_q[i].tolist()} and {float(ref_value[i]):.6g}; "
                      + ("no plain run reproduces it" if trial is None else
                         f"reproduced by the plain version on the pack moved by <= {NEAR_TIE_ULPS} ulp "
                         f"(trial {trial}): a near tie deeper in the tree; counted as differing"))  # fmt: skip
                if trial is not None:
                    differ[i] = True
        n_diff = int(differ.sum())
        same = ~differ
        err = max(float((qvals[same] - ref_q[same]).abs().max()), float((value[same] - ref_value[same]).abs().max()))
        max_err = max(max_err, err)
        print(
            f"{name}: {b} searches a launch: {b - n_diff}/{b} {'agree' if bf16 else 'with identical visit counts'}, "
            f"max |kernel - plain| over Q and root value = {err:.3g}"
        )
        if n_diff > b // 100 and not mma:
            fail(f"{name}: {n_diff} of {b} searches differ from the plain version (limit {b // 100})")
        q_ok = torch.allclose(qvals[same], ref_q[same], rtol=rtol, atol=atol)
        v_ok = torch.allclose(value[same], ref_value[same], rtol=rtol, atol=atol)
        if not (q_ok and v_ok):
            fail(f"{name}: Q / root value outside rtol {rtol}, atol {atol} at {b} searches a launch")
        if b != timed:
            ms = cuda_ms(lambda: sk.whole_search(*part, packed, cfg), reps=3)
            times[b] = (ms, bound(b)[0])
            print(f"{name}: {b} searches a launch: kernel {ms:.3f} ms, {b / ms * 1e3:.0f} searches/s, bound "
                  f"{times[b][1]:.3f} ms")  # fmt: skip

    roots = tuple(r[:timed].contiguous() for r in roots)
    ms = cuda_ms(lambda: sk.whole_search(*roots, packed, cfg), reps=5 if timed == BATCH else 3)
    if timed == max(batches):
        plain_ms = reference_ms
    else:
        plain_ms = timed_once(lambda: sk.whole_search_reference(*roots, packed, cfg))[1]
    bound_ms, op_ms, byte_ms, flops, nbytes = bound(timed)
    times[timed] = (ms, bound_ms)
    layout = f"streamed, chunk {stream_chunk}" if stream_chunk else "resident"
    print(
        f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({flops:.3g} FLOP at {rate} TFLOP/s {unit} ({card}); {nbytes} B), "
        f"B={timed} S={s} H={h} NB={nb} value_bins={value_bins} reward_bins={reward_bins} "
        f"weights {str(weight_dtype).removeprefix('torch.')} {layout}"
    )
    library = sk.library_name(weight_dtype, bool(stream_chunk))
    shape = sk.launch_shape(library, timed, h, max(cfg.num_actions, cfg.codebook_size), value_bins, reward_bins)
    g = sk.SEARCHES_PER_BLOCK[library]
    if shape.searches_per_block != g or shape.blocks != sk.kernel_blocks(timed, library):
        fail(f"{name}: the library's launch shape {shape} disagrees with search_kernel's G and kernel_blocks")
    # A tile holds T rows of each input half (the tensor-core library: T input rows of every output).
    tile_kb = (1 if mma else 2) * shape.tile_rows * h * packed.hh.element_size() / 1024
    print(
        f"{name}: {timed} searches a launch: {shape.blocks} blocks of {shape.threads} threads "
        f"(G={shape.searches_per_block}); {shape.stages} weight stages of "
        f"T={shape.tile_rows} rows {'of every output' if mma else 'of each input half'} ({tile_kb:.0f} KB); "
        f"{shape.smem_bytes} B of shared memory "
        "a block; "
        f"{shape.resident} blocks resident at once (the occupancy query): {-(-shape.blocks // shape.resident)} wave(s)"
    )
    hh_bytes = len(sk.call_order(nb)) * h * h * packed.hh.element_size()  # a streamed pack's padding is never read
    other_bytes = weight_bytes - packed.hh.numel() * packed.hh.element_size()
    l2 = shape.blocks * s * (hh_bytes + other_bytes)
    print(
        f"{name}: L2 bytes a call: the hh layers once per block and simulation, "
        f"{shape.blocks} x {s} x {hh_bytes / 1e6:.2f} MB, and heads and vectors once per block and simulation, "
        f"{shape.blocks} x {s} x {other_bytes / 1e6:.3f} MB: {l2 / 1e9:.1f} GB a call"
    )
    replaces = "249" if value_bins == reward_bins == 1 else "414"
    replaces = "350" if stream_chunk else ("337" if bf16 else replaces)
    return {
        "name": name,
        "route": "cuda",
        "source": "simulate_2048_tpu_torch/csrc/whole_search.cu",
        # the TPU kernel's body; its categorical-head reduction (cat_expect) for the categorical variant; its
        # bf16 dense (weights and cast activations) for bf16 packs; its double-buffered chunk DMAs when streamed
        "replaces": "simulate_2048_tpu/ops/pallas_search.py:" + replaces,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }


def check_bit_identical(label: str, streamed, resident, root_p: torch.Tensor, sims: int, b: int) -> None:
    """The streamed library's searches equal the resident one's bit for bit in visits, Q and root value."""
    for name, out in (("streamed", streamed), ("resident", resident)):
        check_exact_invariants(f"{label} ({name})", out, root_p, sims, b)
    for what, got, want in zip(("visits", "Q", "root value"), streamed, resident):
        if not torch.equal(got, want):
            fail(f"{label}: {what} differ in {int((got != want).sum())} entries at {b} searches a launch")
    print(f"{label}, {b} searches a launch: visits, Q and root value bit-identical")


def check_streamed_equals_resident(device) -> None:
    """At the paper preset (H=256, 256/128 bins) the streamed kernel must give
    the resident one's searches bit for bit, in both weight types. Float32,
    chunks 2 and 8: every thread sums the same products in the same order.
    Bfloat16, the two tensor-core libraries ((c) resident, (d) streamed), at
    256 and 1,024 searches a launch, and at H=96 (no power of two) at 256:
    every output sums its k-steps, and each layer norm its m-tiles'
    statistics, in one order whichever warp owns the m-tile, and each
    categorical head splits its sums alike. Then both layouts are timed at
    256 and 1,024 searches a launch (self-play's size and a reanalyze
    batch's), their calls in turns, median of 5: the resident kernel is the
    one the plan picks up to H=256."""
    config, cfg, network, _, roots = full_width_inputs(device, 256, 128, reanalyze.SEARCH_BATCH)
    h, s = config.hidden_size, cfg.num_simulations
    for dtype in (torch.float32, torch.bfloat16):
        resident_pack = sk.pack_for(network, cfg, dtype)
        streamed_pack = sk.pack_for(network, cfg, dtype, sk.STREAM_CHUNK)
        if dtype == torch.float32:
            resident = sk.whole_search(*roots, resident_pack, cfg)
            for chunk in (2, 8):
                streamed = sk.whole_search(*roots, sk.pack_for(network, cfg, dtype, chunk), cfg)
                torch.cuda.synchronize()
                for label, got, want in zip(("visits", "Q", "root value"), streamed, resident):
                    if not torch.equal(got, want):
                        n = int((got != want).sum())
                        fail(f"streamed (chunk {chunk}) vs resident, {dtype}: {label} differ in {n} entries")
            print(f"streamed vs resident kernel, H={h}, {dtype}, chunks 2 and 8: visits, Q and root value bit-identical")
        else:
            for b in (BATCH, reanalyze.SEARCH_BATCH):
                part = tuple(r[:b].contiguous() for r in roots)
                resident = sk.whole_search(*part, resident_pack, cfg)
                streamed = sk.whole_search(*part, streamed_pack, cfg)
                torch.cuda.synchronize()
                check_bit_identical(f"whole_search_bf16_streamed vs whole_search_bf16, H={h}", streamed, resident,
                                    part[1], s, b)  # fmt: skip
        for b in (BATCH, reanalyze.SEARCH_BATCH):
            part = tuple(r[:b].contiguous() for r in roots)
            times = {"resident": [], "streamed": []}
            for _ in range(5):
                for label, packed in (("resident", resident_pack), ("streamed", streamed_pack)):
                    times[label].append(timed_once(lambda: sk.whole_search(*part, packed, cfg))[1])
            ms = {label: statistics.median(t) for label, t in times.items()}
            print(
                f"streamed vs resident kernel, H={h}, {dtype}, {b} searches a launch: resident {ms['resident']:.3f} "
                f"ms, streamed {ms['streamed']:.3f} ms (median of 5, in turns): streamed/resident "
                f"{ms['streamed'] / ms['resident']:.3f}"
            )
    config, cfg, network, _, roots = full_width_inputs(device, 256, 128, BATCH, 96)
    resident = sk.whole_search(*roots, sk.pack_for(network, cfg, torch.bfloat16), cfg)
    streamed = sk.whole_search(*roots, sk.pack_for(network, cfg, torch.bfloat16, sk.STREAM_CHUNK), cfg)
    torch.cuda.synchronize()
    check_bit_identical("whole_search_bf16_streamed vs whole_search_bf16, H=96", streamed, resident, roots[1],
                        cfg.num_simulations, BATCH)  # fmt: skip


# Each tensor-core library's probe widths: its path's, and one that is a multiple of 32 but no power of two.
PROBE_WIDTHS = {"whole_search_bf16": (256, 96), "whole_search_bf16_streamed": (WIDE_HIDDEN, 96)}


def check_dense_probe(device, library: str) -> float:
    """A tensor-core library's dense layers alone (``sk.dense_probe``: the
    kernel's own ring, ``mma.sync`` products and epilogue), on every layer of
    a bfloat16 pack of the wide recipe's towers (88 layers at 10 blocks; in
    the library's layout, so its fragment copy) at each of its
    PROBE_WIDTHS, on seeded activations (relu of normals, G columns) and
    biases: every output within 2^-16 sum_i |w_i x_i| of the plain value
    (the exact sum of the bfloat16 products, in float64, rounded to float32,
    plus the bias in float32). Returns the largest ratio of error to that
    bound."""
    g = sk.SEARCHES_PER_BLOCK[library]
    gen = torch.Generator(device=device).manual_seed(SEED)
    streamed = library.endswith("_streamed")
    worst = 0.0
    for h in PROBE_WIDTHS[library]:
        config = dataclasses.replace(wide_config(), hidden_size=h)
        network = network_from_config(config, tfrng.prng_key(SEED), device)
        packed = sk.pack_for(network, search_config_from(config), torch.bfloat16, sk.STREAM_CHUNK if streamed else 0)
        fragments = sk.SearchWorkspace(packed).fragments
        n_layers = fragments.shape[0]
        x = torch.relu(torch.randn(g, h, generator=gen, device=device))
        bias = 0.1 * torch.randn(n_layers, h, generator=gen, device=device)
        got = sk.dense_probe(library, fragments, bias, x)
        torch.cuda.synchronize()
        order = sk.call_order(config.num_residual_blocks)
        w = (packed.hh[:n_layers] if streamed else packed.hh[order]).double()  # (L, in, out) in call order
        xb = x.to(torch.bfloat16).double()
        exact = torch.einsum("gi,lio->lgo", xb, w)
        magnitude = torch.einsum("gi,lio->lgo", xb.abs(), w.abs())
        want = exact.float() + bias[:, None, :]
        ratio = float(((got - want).abs().double() / (2.0**-16 * magnitude).clamp_min(1e-30)).max())
        print(f"dense probe, {library}, H={h}, G={g}: {n_layers} layers of the wide recipe's bfloat16 pack, largest "
              f"|kernel - plain| / (2^-16 sum |w x|) = {ratio:.4g} (limit 1)")  # fmt: skip
        if not ratio <= 1.0:
            fail(f"dense probe, {library} at H={h}: an output is further than 2^-16 sum |w x| from the plain value")
        worst = max(worst, ratio)
    return worst


def max_sm_clock_hz() -> float:
    """The card's highest SM clock as ``nvidia-smi`` reports it (``clocks.max.sm``)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"], capture_output=True, text=True
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi could not read clocks.max.sm: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def rollout_seeds(device) -> torch.Tensor:
    index = torch.arange(ROLLOUT_BOARDS, dtype=torch.int64, device=device)
    return tfrng.derive_game_seeds(SEED, index, torch.zeros_like(index))


def check_random_rollout(device) -> dict:
    """The rollout kernel in both launch modes (given seeds, seeds derived in
    the launch) vs its plain version at the benchmark's size, then their times
    and the bound."""
    seeds = rollout_seeds(device)
    outs = {
        "given seeds": rk.rollout_kernel(seeds, ROLLOUT_STEPS),
        "derived seeds": rk.rollout_kernel_from_run_seed(SEED, ROLLOUT_BOARDS, ROLLOUT_STEPS, device),
    }
    torch.cuda.synchronize()
    ref, counts = rk.random_rollout_reference_counted(seeds, ROLLOUT_STEPS)
    torch.cuda.synchronize()
    max_err = 0.0
    for mode, out in outs.items():
        for name, got, want in zip(("boards", "episodes", "reward_sum", "max_tile"), out, ref):
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"random_rollout ({mode}): {name} is {got.dtype} {tuple(got.shape)}, not {want.dtype} "
                     f"{tuple(want.shape)}")  # fmt: skip
            max_err = max(max_err, float((got.double() - want.double()).abs().max()))
            if not torch.equal(got, want):
                n_diff = int((got != want).sum())
                fail(f"random_rollout ({mode}): {name} differs from the plain version on {n_diff} of {got.numel()} "
                     "entries")  # fmt: skip
    out = outs["derived seeds"]
    episodes = int(out[1].sum())
    print(
        f"random_rollout: boards, episodes, reward sums and max tiles equal to the plain version on {ROLLOUT_BOARDS} "
        f"boards x {ROLLOUT_STEPS} steps, with seeds given and with seeds derived in the launch; {episodes} games "
        f"ended, mean reward sum {float(out[2].mean()):.1f}, largest tile {int(out[3].max())}"
    )
    if episodes == 0:
        fail("random_rollout: no game ended, so the reset branch was not compared")

    # Device time alone: the wrapper's host work (~0.02 ms) is as long as a tenth of the kernel.
    given_ms = cuda_ms(lambda: rk.rollout_kernel(seeds, ROLLOUT_STEPS), reps=5, calls=ROLLOUT_CALLS)
    ms = cuda_ms(
        lambda: rk.rollout_kernel_from_run_seed(SEED, ROLLOUT_BOARDS, ROLLOUT_STEPS, device), reps=5, calls=ROLLOUT_CALLS
    )
    plain_ms = cuda_ms(lambda: rk.random_rollout_reference(seeds, ROLLOUT_STEPS), reps=3, warmup=0)
    steps = ROLLOUT_BOARDS * ROLLOUT_STEPS
    work = {"step": steps, "moved": counts["moved"], "full": counts["full"], "reset": episodes}  # this run's data
    sms, clock = torch.cuda.get_device_properties(0).multi_processor_count, max_sm_clock_hz()
    int_rate = sms * INT32_LANES_PER_SM * clock
    out_bytes = sum(t.numel() * t.element_size() for t in out)
    hbm = HBM_TBPS[sku(torch.cuda.get_device_name(0))] * 1e12
    bounds = {}
    for mode, derived in (("given seeds", False), ("derived seeds", True)):
        ops = sum(ROLLOUT_MIN_OPS[k] * work[k] for k in ROLLOUT_MIN_OPS) + derived * ROLLOUT_SEED_MIN_OPS * ROLLOUT_BOARDS
        source_ops = sum(ROLLOUT_SOURCE_OPS[k] * n for k, n in work.items()) + derived * ROLLOUT_SEED_OPS * ROLLOUT_BOARDS
        io_bytes = out_bytes + (0 if derived else seeds.numel() * seeds.element_size())
        op_ms, byte_ms = ops / int_rate * 1e3, io_bytes / hbm * 1e3
        bounds[mode] = (max(op_ms, byte_ms), op_ms >= byte_ms)
        kernel_ms = ms if derived else given_ms
        print(
            f"random_rollout ({mode}): kernel {kernel_ms:.4f} ms ({steps / kernel_ms * 1e3:.4g} env-steps/s), bound "
            f"{bounds[mode][0]:.4f} ms (the kernel takes {kernel_ms / bounds[mode][0]:.2f}x that): {ops / steps:.1f} "
            f"integer operations per step that the rollout's definition forces over {sms} SMs x {INT32_LANES_PER_SM} "
            f"INT32 lanes x {clock / 1e6:.0f} MHz (nvidia-smi clocks.max.sm) = {int_rate:.4g} op/s; {io_bytes} B take "
            f"{byte_ms:.5f} ms"
        )
        source_ms = source_ops / int_rate * 1e3
        print(
            f"random_rollout ({mode}): its source spends {source_ops / steps:.1f} operations per step, "
            f"{source_ms:.4f} ms at that rate: the kernel issues them at {source_ms / kernel_ms:.2f} of the INT32 rate "
            f"(no bound: three-input instructions do some pairs in one)"
        )
    print(
        f"random_rollout: the data asked {counts['moved'] / steps:.3f} of the steps to spawn, "
        f"{counts['full'] / steps:.4f} to test neighbours and {episodes / steps:.5f} to reset; plain version "
        f"{plain_ms:.1f} ms"
    )
    return {
        "name": "random_rollout",
        "route": "cuda",
        "source": "simulate_2048_tpu_torch/csrc/random_rollout.cu",
        "replaces": "simulate_2048_tpu/ops/pallas_rollout.py:188",
        "max_abs_err": max_err,
        "ms": ms,  # the launch mode of the rollout path (bench): seeds derived in the launch
        "plain_ms": plain_ms,
        "bound_ms": bounds["derived seeds"][0],
        "bound_by": "operations" if bounds["derived seeds"][1] else "bytes",
        "library_ms": None,  # no PyTorch call plays 2048
    }


def board_ops_boards(gen: torch.Generator) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Boards for ``check_rollout_board_ops`` (CPU): every 16-bit row of 4-bit
    cells as each row of a board whose other rows have cells below 15 (for
    left and right) and as each column (for up and down), and boards of
    exponents 13-17 beside empty cells and small tiles. Returns the boards by
    set and the action of each."""
    rows = torch.arange(1 << 16, dtype=torch.int64)
    cells = ((rows[:, None] >> torch.arange(0, 16, 4)) & 0xF).to(torch.int32)  # (65536, 4)
    sets, actions = {}, []
    for action in range(4):
        boards = []
        for pos in range(4):
            board = torch.randint(0, 15, (rows.numel(), 4, 4), generator=gen, dtype=torch.int32)
            board *= torch.rand(board.shape, generator=gen) < torch.rand(rows.numel(), 1, 1, generator=gen) * 1.3
            board[:, pos] = cells
            boards.append(board.transpose(1, 2) if action % 2 else board)  # up and down slide columns
        sets[f"every row, action {action}"] = torch.cat(boards)
        actions.append(torch.full((4 * rows.numel(),), action, dtype=torch.int32))
    n = 1 << 16
    values = torch.tensor([0, 1, 2, 13, 14, 15, 16, 17], dtype=torch.int32)
    high = values[torch.multinomial(torch.tensor([3.0, 1, 1, 2, 2, 2, 2, 2]), n * 16, True, generator=gen)]
    sets["exponents 13-17"] = high.reshape(n, 4, 4)
    sets["exponents 13-14"] = torch.randint(13, 15, (n, 4, 4), generator=gen, dtype=torch.int32) * (
        torch.rand(n, 4, 4, generator=gen) < 0.8
    )  # below 15 (the table's path): their merges make 15s
    actions += [torch.randint(0, 4, (n,), generator=gen, dtype=torch.int32) for _ in range(2)]
    return sets, torch.cat(actions)


def check_rollout_board_ops(device) -> None:
    """The rollout kernel's own move, spawn and end test (``rk.board_ops_kernel``,
    the kernel's device functions in a launch of their own) against
    ``ops/board.py`` ``apply_action`` / ``spawn_tile`` / ``is_done`` and the
    exact path's rule (a board with a cell of 15 or more), on every 16-bit row
    in every direction and on boards that reach exponents 15-17."""
    gen = torch.Generator().manual_seed(SEED)
    sets, actions = board_ops_boards(gen)
    boards = torch.cat(list(sets.values())).to(device)
    actions = actions.to(device)
    bits = torch.randint(0, 1 << 32, (2, boards.shape[0]), generator=gen, dtype=torch.int64).to(device)
    got = rk.board_ops_kernel(boards, actions, bits[0], bits[1])
    want = rk.board_ops_reference(boards, actions, bits[0], bits[1])
    torch.cuda.synchronize()
    for name, g, w in zip(("slid boards", "scores", "spawned boards", "finished", "exact"), got, want):
        if not torch.equal(g.to(w.dtype), w):
            fail(f"random_rollout board ops: {name} differ from ops/board.py on {int((g.to(w.dtype) != w).sum())} "
                 f"of {w.numel()} entries")  # fmt: skip
    start = 0
    for name, b in sets.items():
        part = slice(start, start + b.shape[0])
        start += b.shape[0]
        on_table = int((b.flatten(1).amax(1) < 15).sum())
        print(
            f"random_rollout board ops ({name}): {b.shape[0]} boards equal to ops/board.py (slid board, score, "
            f"spawned board, finished, exact path); {on_table} slid by the table, {int(got[4][part].sum())} left on "
            f"the exact path, {int(got[3][part].sum())} finished, largest exponent after the spawn "
            f"{int(got[2][part].max())}"
        )
    high = slice(start - 2 * (1 << 16), start)
    if int(got[2][high].max()) < 17 or not bool(got[4][start - (1 << 16):].any()):
        fail("random_rollout board ops: the exact path or a 15 made by the table was not reached")


def drive_rollout_path() -> int:
    """The rollout path through its entry point, ``bench.main``, on the card. Returns the run's kernel launches."""
    rk.LAUNCHES["random_rollout"] = 0
    result = bench.main([])
    launches = rk.LAUNCHES["random_rollout"]
    if launches != 1 + result["reps"] or "vs_baseline" in result:
        fail(f"rollout path: {launches} kernel launches for a warm-up and {result['reps']} repetitions")
    size = (result["num_envs"], result["num_steps"])
    if result["backend"] != "cuda_rollout" or size != (ROLLOUT_BOARDS, ROLLOUT_STEPS):
        fail(f"rollout path: bench ran {result['backend']} at {result['num_envs']} x {result['num_steps']}")
    if not (0 < result["value"] < float("inf") and 0 < result["kernel_ms"] < 1e3 * min(result["times_s"])):
        fail(f"rollout path: env-steps/s is {result['value']}, the kernel's ms {result['kernel_ms']}")
    print(
        f"rollout path: {result['value']:.4g} env-steps/s, best of {result['reps']} repetitions "
        f"({1e3 * min(result['times_s']):.3f} ms: one kernel launch deriving its seeds, the episode sum and its fetch; "
        f"the kernel alone {result['kernel_ms']:.4f} ms)"
    )
    return launches


def check_small_evaluation(device) -> None:
    """Greedy games on a small config: kernel backend vs plain search backend."""
    config = dataclasses.replace(tiny_config(), num_simulations=16, eval_max_moves=40)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
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
    """A greedy self-play segment with categorical heads on a small config,
    then a search-mode reanalyze of it: kernel backend vs plain search
    backend, game for game and position for position."""
    games, moves = 32, 30
    config = dataclasses.replace(
        tiny_config(), num_simulations=16, value_bins=16, reward_bins=8, max_trajectory_length=moves,
        replay_buffer_size=games, reanalyze_mode="search", value_target_mode="td_lambda", td_lambda=1.0,
    )  # fmt: skip
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
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

    # Reanalyze the kernel backend's segment under both backends, with the same root noise.
    alpha = torch.full((games * moves, config.action_size), config.dirichlet_alpha)
    noise = torch._sample_dirichlet(alpha, gen).to(device)
    slots = torch.arange(games, device=device)
    buffers = {}
    for backend in ("pallas", "xla"):
        cfg = dataclasses.replace(config, search_backend=backend)
        buffer = replay_lib.add_trajectories(replay_lib.init_buffer(cfg, device), k)
        buffers[backend] = reanalyze.reanalyze_slots(buffer, network, slots, cfg, noise=noise)
    kb, pb = buffers["pallas"], buffers["xla"]
    in_ep = torch.arange(moves, device=device)[None] < kb.length[:, None]
    same = (kb.policies == pb.policies).all(-1) & in_ep
    n_pos = int(in_ep.sum())
    print(
        f"small reanalyze (the segment above, search mode, {n_pos} positions): {int(same.sum())}/{n_pos} policy "
        f"targets identical; max |value target difference| "
        f"{float((kb.values.float() - pb.values.float()).abs().max()):.3g} (bfloat16 in the buffer)"
    )
    if int(same.sum()) < n_pos - n_pos // 100:
        fail("small reanalyze: kernel and plain search backends disagree on more than 1% of the policy targets")
    if not torch.equal(kb.policies[~in_ep], pb.policies[~in_ep]) or kb.policies[~in_ep].any():
        fail("small reanalyze: policy targets outside the episodes are not zero")
    # One differing search moves its game's earlier returns too: compare the games whose searches all agree.
    whole = (same | ~in_ep).all(-1)
    if not torch.allclose(kb.values[whole].float(), pb.values[whole].float(), rtol=2.0**-7, atol=1e-3):
        fail("small reanalyze: value targets differ by more than one bfloat16 step")


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
        reanalyze_mode="search",
        reanalyze_episodes=REANALYZE_EPISODES,
        reanalyze_interval=TRAIN_STEPS // 2,
        deep_eval_interval=TRAIN_STEPS,
        deep_eval_games=DEEP_EVAL_GAMES,
    )


def wide_config():
    """``scripts/run_full_capacity_probe.sh``'s recipe (the training recipe
    above, bfloat16 search packs, its evaluation calibration) at hidden 512,
    which the search kernel runs with streamed weights; depth cut to a smoke
    test: two 8-move segments, three learner steps."""
    return dataclasses.replace(
        training_config(),
        hidden_size=WIDE_HIDDEN,
        search_weight_dtype="bfloat16",
        eval_prior_temperature=4.0,
        eval_pb_c_init=0.5,
        lr_decay_steps=300_000,
        max_trajectory_length=WIDE_SEGMENT_MOVES,
        min_buffer_size=BATCH,
        replay_buffer_size=4 * BATCH,
        generation_interval=WIDE_STEPS,
        checkpoint_interval=WIDE_STEPS,
        eval_interval=WIDE_STEPS,
        reanalyze_interval=WIDE_STEPS - 1,
        deep_eval_interval=WIDE_STEPS,
    )


def fill_segments(config) -> int:
    """The segments ``Trainer.fill_buffer`` plays into an empty buffer; it logs none of them."""
    return -(-config.min_buffer_size // config.num_parallel_games)


def drive_probe_evaluation(device, ptxas: str) -> int:
    """The full-capacity probe's evaluation at its own width (H=256, 10
    blocks, 256/128 bins, bfloat16 search packs, which the kernel keeps
    resident): ``evaluate_games`` on ``BATCH`` games of ``TRAIN_EVAL_MOVES``
    moves; printed beside the resident bfloat16 kernel's time and bound at
    ``BATCH`` searches (``check_whole_search``'s), its launch shape and
    ptxas's report (``ptxas``). Returns that kernel's launches in the run."""
    config = dataclasses.replace(wide_config(), hidden_size=default_config().hidden_size)
    if sk.search_plan(search_config_from(config, eval_mode=True), config.hidden_size, torch.bfloat16) != 0:
        fail("probe evaluation: the search plan streams hidden-256 weights")
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
    perturb_categorical_heads(network, gen)
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_games(network, torch.Generator().manual_seed(SEED + 2), config, BATCH, include_per_game=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    lengths = stats["per_game_lengths"]
    moves_played = max(lengths)
    if launches["whole_search_bf16"] != moves_played or sum(launches.values()) != moves_played:
        fail(f"probe evaluation: launches {launches} for {moves_played} moves")
    rewards = torch.tensor(stats["per_game_rewards"])
    if not torch.isfinite(rewards).all() or moves_played > TRAIN_EVAL_MOVES or len(lengths) != BATCH:
        fail("probe evaluation: non-finite rewards or game lengths beyond the cap")
    kernel_ms, bound_ms = KERNEL_TIMES["whole_search_bf16"][BATCH]
    k = max(config.action_size, config.codebook_size)
    shape = sk.launch_shape("whole_search_bf16", BATCH, config.hidden_size, k, config.value_bins, config.reward_bins)
    print(
        f"probe evaluation path (H={config.hidden_size}, NB={config.num_residual_blocks}, bins 256/128, bf16 search "
        f"packs resident): {BATCH} games, {moves_played} moves in {wall:.2f} s: {sum(lengths) / wall:.1f} "
        f"game-moves/s, {1e3 * wall / moves_played:.2f} ms per move, {launches['whole_search_bf16']} launches; "
        f"the kernel alone at B={BATCH} {kernel_ms:.3f} ms (bound {bound_ms:.3f} ms, timed above); {shape.blocks} "
        f"blocks of {shape.threads} threads, G={shape.searches_per_block}, {shape.stages} stages, "
        f"{shape.smem_bytes} B of shared memory, {shape.resident} blocks resident; {ptxas}"
    )
    return launches["whole_search_bf16"]


def drive_wide_training(device) -> dict[str, int]:
    """The wide path through ``train_muzero``: every search on the streamed
    bfloat16 kernel. Returns the kernel launch counts of the run."""
    config = wide_config()
    if sk.search_plan(search_config_from(config), WIDE_HIDDEN, torch.bfloat16) == 0:
        fail("wide path: the search plan keeps hidden-512 weights resident")
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = train_muzero(config, checkpoint_dir=ckpt_dir, num_steps=WIDE_STEPS, seed=SEED, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        best_steps = CheckpointManager(os.path.join(ckpt_dir, "best")).all_steps()

    history = trainer.get_metrics_history()
    gens = [r for r in history if "gen/positions" in r]
    steps = [r for r in history if "total_loss" in r]
    evals = [r for r in history if "eval/mean_reward" in r]
    passes = [r for r in history if "reanalyze/seconds" in r]
    deeps = [r for r in history if "deep_eval/mean_reward" in r]
    if len(gens) + fill_segments(config) != 2 or len(steps) != WIDE_STEPS or len(evals) != 1:
        fail(f"wide path: {len(gens)} logged segments, {len(steps)} logged steps, {len(evals)} evaluations")
    if [r["step"] for r in passes] != [WIDE_STEPS - 1] or [r["step"] for r in deeps] != [WIDE_STEPS]:
        fail(f"wide path: reanalyze passes {passes}, deep evaluations {deeps}")
    if best_steps != [WIDE_STEPS]:
        fail(f"wide path: best/ holds steps {best_steps}")
    loss_terms = [k for k in steps[0] if k.endswith("_loss") or k == "codebook_entropy"]
    if not all(torch.isfinite(torch.tensor([r[k] for k in loss_terms])).all() for r in steps):
        fail("wide path: a loss term is not finite")
    if not all(torch.isfinite(torch.tensor(r["gen/search_value"])) for r in gens):
        fail("wide path: a self-play search value is not finite")

    self_play_moves = (fill_segments(config) + len(gens)) * WIDE_SEGMENT_MOVES
    searches = REANALYZE_EPISODES * WIDE_SEGMENT_MOVES
    reanalyze_launches = reanalyze.search_batches(searches)
    expected = self_play_moves + 2 * TRAIN_EVAL_MOVES + reanalyze_launches
    if launches["whole_search_bf16_streamed"] != expected or sum(launches.values()) != expected:
        fail(
            f"wide path: launches {launches} for {self_play_moves} self-play moves, {TRAIN_EVAL_MOVES} evaluation "
            f"moves, {TRAIN_EVAL_MOVES} deep-evaluation moves and {reanalyze_launches} batches of reanalyze searches"
        )
    gen_s = sum(r["gen/seconds"] for r in gens)
    positions = sum(r["gen/positions"] for r in gens)
    gen_steps = {r["step"] + 1 for r in gens}
    pure = [r["steps_per_s"] for r in steps if r["step"] not in gen_steps] or [r["steps_per_s"] for r in steps]
    step_ms = statistics.median(1e3 / x for x in pure)
    print(
        f"wide path (H={WIDE_HIDDEN}, NB={config.num_residual_blocks}, bf16 search packs streamed): {len(gens)} "
        f"logged segments of {WIDE_SEGMENT_MOVES} moves x {BATCH} games in {gen_s:.2f} s: {positions / gen_s:.1f} "
        f"game-moves/s, {1e3 * gen_s / (len(gens) * WIDE_SEGMENT_MOVES):.2f} ms per move; {len(steps)} learner steps, median "
        f"{step_ms:.2f} ms per step; whole run {wall:.1f} s"
    )
    print(
        f"wide path: one search-mode reanalyze pass of {REANALYZE_EPISODES} episodes x {WIDE_SEGMENT_MOVES} moves = "
        f"{searches} searches in {reanalyze_launches} launch(es): {passes[0]['reanalyze/seconds']:.3f} s; one "
        f"evaluation of {BATCH} games and one deep evaluation of {DEEP_EVAL_GAMES} games x {TRAIN_EVAL_MOVES} moves: "
        f"{deeps[0]['deep_eval/seconds']:.3f} s for the deep one; launches {launches} = {self_play_moves} self-play "
        f"+ {2 * TRAIN_EVAL_MOVES} evaluation moves + {reanalyze_launches} reanalyze batch(es)"
    )
    print("wide path: last step " + " ".join(f"{k}={steps[-1][k]:.4f}" for k in loss_terms))
    return launches


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
        fresh = network_from_config(config, tfrng.prng_key(SEED + 7), device)
        restored = TrainState(fresh, create_optimizer(config).init(list(fresh.parameters())))
        if CheckpointManager(ckpt_dir).restore(restored) is None:
            fail("training path: no checkpoint was written")
        best_steps = CheckpointManager(os.path.join(ckpt_dir, "best")).all_steps()
        with open(os.path.join(ckpt_dir, "deep_eval_best.json")) as f:
            champion = json.load(f)
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
    initial = network_from_config(config, tfrng.prng_key(SEED), device)
    changed = sum(not torch.equal(a, b) for a, b in zip(initial.parameters(), trained.params))
    if changed < len(trained.params) // 2:
        fail(f"training path: only {changed} of {len(trained.params)} parameter tensors changed")

    passes = [r for r in history if "reanalyze/seconds" in r]
    deeps = [r for r in history if "deep_eval/mean_reward" in r]
    pass_steps, deep_steps = [r["step"] for r in passes], [r["step"] for r in deeps]
    if pass_steps != [TRAIN_STEPS // 2] or deep_steps != [TRAIN_STEPS]:
        fail(f"training path: reanalyze passes at steps {pass_steps}, deep evaluations at steps {deep_steps}")
    if best_steps != [TRAIN_STEPS] or set(champion) != {"step", "mean_reward", "sem_reward", "games", "max_tile"}:
        fail(f"training path: best/ holds steps {best_steps}, deep_eval_best.json {champion}")
    if champion["games"] != DEEP_EVAL_GAMES or champion["mean_reward"] != deeps[0]["deep_eval/mean_reward"]:
        fail(f"training path: deep_eval_best.json {champion} is not the deep evaluation's result")

    # The reanalysed rows: the pass started at row 0 of a buffer that has not wrapped.
    buffer = trainer.buffer
    added = int(buffer.episodes_added)
    if trainer._reanalyze_cursor != REANALYZE_EPISODES or added > buffer.length.shape[0]:
        fail(f"training path: reanalyze cursor at {trainer._reanalyze_cursor}, {added} episodes added")
    rows = slice(0, REANALYZE_EPISODES)
    in_ep = torch.arange(TRAIN_SEGMENT_MOVES, device=device)[None] < buffer.length[rows, None]
    policy_sums = buffer.policies[rows].float().sum(-1)
    if not (torch.isfinite(buffer.values[rows].float()).all() and torch.isfinite(policy_sums).all()):
        fail("training path: a reanalysed value or policy target is not finite")
    if not torch.allclose(policy_sums, in_ep.float(), atol=2e-3):  # float16 probabilities
        fail("training path: reanalysed policy targets do not sum to 1 inside the episodes and 0 outside")

    self_play_moves = (fill_segments(config) + len(gens)) * TRAIN_SEGMENT_MOVES
    reanalyze_launches = len(passes) * reanalyze.search_batches(REANALYZE_EPISODES * TRAIN_SEGMENT_MOVES)
    expected = self_play_moves + 2 * TRAIN_EVAL_MOVES + reanalyze_launches
    if launches["whole_search_categorical"] != expected or launches["whole_search"] != 0:
        fail(
            f"training path: launches {launches} for {self_play_moves} self-play moves, {TRAIN_EVAL_MOVES} evaluation "
            f"moves, {TRAIN_EVAL_MOVES} deep-evaluation moves and {reanalyze_launches} batches of reanalyze searches"
        )
    gen_s = sum(r["gen/seconds"] for r in gens)
    positions = sum(r["gen/positions"] for r in gens)
    # Steps that share their log interval with a generated segment are left out of the learner's rate.
    gen_steps = {r["step"] + 1 for r in gens}
    pure = [r["steps_per_s"] for r in steps if r["step"] not in gen_steps]
    step_ms = statistics.median(1e3 / x for x in pure)
    print(
        f"training path: {len(gens)} logged segments of {TRAIN_SEGMENT_MOVES} moves x {BATCH} games in {gen_s:.2f} s: "
        f"{positions / gen_s:.1f} game-moves/s, {1e3 * gen_s / (len(gens) * TRAIN_SEGMENT_MOVES):.2f} ms per move "
        f"(the kernel alone at B={BATCH}: timed above)"
    )
    print(
        f"training path: {len(steps)} learner steps (batch {config.batch_size}, unroll {config.num_unroll_steps}): "
        f"median {step_ms:.2f} ms per step, {1e3 / step_ms:.2f} steps/s; whole run {wall:.1f} s; "
        f"{changed}/{len(trained.params)} parameter tensors changed; checkpoint round trip exact"
    )
    searches = REANALYZE_EPISODES * TRAIN_SEGMENT_MOVES
    print(
        f"training path: one search-mode reanalyze pass of {REANALYZE_EPISODES} episodes x {TRAIN_SEGMENT_MOVES} "
        f"moves = {searches} searches in {reanalyze_launches} launches: {passes[0]['reanalyze/seconds']:.3f} s "
        f"({searches / passes[0]['reanalyze/seconds']:.0f} searches/s); one deep evaluation of {DEEP_EVAL_GAMES} "
        f"games x {TRAIN_EVAL_MOVES} moves: {deeps[0]['deep_eval/seconds']:.3f} s, mean reward "
        f"{deeps[0]['deep_eval/mean_reward']:.1f}, champion saved in best/ at step {best_steps[0]}"
    )
    print("training path: total loss by step: " + " ".join(f"{r['total_loss']:.4f}" for r in steps))
    print(
        "training path: last step "
        + " ".join(f"{k}={steps[-1][k]:.4f}" for k in loss_terms)
        + f"; evaluation mean reward {evals[0]['eval/mean_reward']:.1f} over {TRAIN_EVAL_MOVES} moves"
    )
    return launches


RECIPE = "run_cat60k_twin.sh"  # simulate_2048_tpu_torch/scripts/: its preset and overrides, read from the script
RECIPE_LIBRARY = "whole_search_categorical"
RECIPE_TIMED_MOVES = 5  # self-play moves of each timing, "xla" and "auto" in turns
RECIPE_SEGMENT_MOVES = 24  # max_trajectory_length: one segment fills the buffer, the loop's step 0 plays the other
RECIPE_STEPS = 40  # learner steps: 4 logged chunks of log_interval 10
RECIPE_EVAL_MOVES = 100  # eval_max_moves of the one evaluation (the recipe: full games, 1,200)
RECIPE_TRACE_MOVES, RECIPE_TRACE_STEPS = 3, 5  # the traced window after the run


def time_recipe_moves(device, config) -> None:
    """ms per self-play move of the recipe's 64 games under the literal
    recipe's backend ("xla": the plain search) and under "auto" (the kernel),
    on the same seeded weights from the same games, in turns (xla, auto, auto,
    xla) after a one-move warm-up of each; each timing plays
    RECIPE_TIMED_MOVES moves (``play_segment``; host clock, synchronised)."""
    gen = torch.Generator().manual_seed(SEED)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
    perturb_categorical_heads(network, gen)
    start = envlib.reset_batch(SEED, config.num_parallel_games, device)
    backends = {name: dataclasses.replace(config, search_backend=name) for name in ("xla", "auto")}

    def play(name: str, moves: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        play_segment(network, start, torch.Generator(device=device).manual_seed(SEED), 1.0, backends[name],
                     config.num_parallel_games, num_steps=moves)  # fmt: skip
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / moves

    for name in backends:
        play(name, 1)
    times = {name: [] for name in backends}
    for name in ("xla", "auto", "auto", "xla"):
        times[name].append(play(name, RECIPE_TIMED_MOVES))
    plain, kernel = (statistics.mean(times[name]) for name in ("xla", "auto"))
    print(
        f"recipe path ({card_line()}): a self-play move of {config.num_parallel_games} games x "
        f"{config.num_simulations} simulations (H={config.hidden_size}, NB={config.num_residual_blocks}): "
        f"literal recipe (search_backend=xla, the plain search) {plain:.2f} ms "
        f"({' / '.join(f'{t:.2f}' for t in times['xla'])}), auto (the kernel) {kernel:.2f} ms "
        f"({' / '.join(f'{t:.2f}' for t in times['auto'])}): {plain / kernel:.1f}x, "
        f"{RECIPE_TIMED_MOVES} moves a timing, in turns"
    )


def trace_device_ops(trace_dir: str) -> tuple[str, int]:
    """``trace_summary`` on the newest trace in ``trace_dir``, run as a
    process; returns its output and the count of ``whole_search_kernel``."""
    out = run_entry_point("trace_summary", [trace_dir, "--top", "12"])
    ops = (re.match(r"\s*[\d.]+ ms\s+x(\d+)\s+(.*)", line) for line in out.splitlines())
    return out, sum(int(m.group(1)) for m in ops if m and "whole_search_kernel" in m.group(2))


def check_trainer_init(config, seed: int, initial: list[torch.Tensor]) -> None:
    """The initial network of a ``Trainer`` of ``seed`` on the card
    (``initial``, its parameters copied back) against ``network_from_config``
    on the CPU, with the key JAX's ``Trainer`` takes
    (``split(PRNGKey(seed))[1]``): bit for bit, since both are drawn on the
    CPU. Then prints the first kernel's sum of the recipe's init at seed 42,
    the seed of JAX's recipe runs, as ``tests/test_torch_init.py`` holds it
    against Flax's."""
    want = network_from_config(config, tfrng.split(tfrng.prng_key(seed))[1], "cpu")
    names = [name for name, _ in want.named_parameters()]
    differ = [n for n, a, b in zip(names, initial, want.parameters()) if not torch.equal(a, b.detach())]
    if len(initial) != len(names) or differ:
        fail(f"recipe path: the Trainer's initial network differs from network_from_config on the CPU: {differ}")
    seed42 = network_from_config(config, tfrng.split(tfrng.prng_key(42))[1], "cpu")
    kernel = seed42.representation.trunk.proj.weight
    print(f"recipe path: the Trainer's initial network on the card equals network_from_config on the CPU "
          f"(seed {seed}, {len(names)} tensors, bit for bit); seed 42's init: representation/TowerWithHead_0/"
          f"Dense_0 kernel {tuple(kernel.t().shape)} sum {float(kernel.double().sum()):.9g}")  # fmt: skip


def drive_recipe_path(device) -> tuple[dict, str]:
    """The champion recipe (``simulate_2048_tpu_torch/scripts/run_cat60k_twin.sh``)
    at its own widths: (a) the categorical kernel against its plain version
    at 64 searches x 50 simulations under both of the recipe's search
    configs (self-play, and evaluation at prior temperature 4 and pb_c_init
    0.5), ``check_whole_search``'s float32 rule; (b) the literal recipe's
    move ("xla") against the kernel's ("auto"); (c) a cut run through
    ``Trainer`` with the launch counts set to 0 just before (its initial
    network held to the CPU's, ``check_trainer_init``): 2 segments of 24
    moves, 40 learner steps at batch 256, one evaluation of 32 games capped
    at 100 moves, a checkpoint round trip; only ``whole_search_categorical``
    launched, once per self-play and evaluation move; (d) 3 moves and 5
    learner steps of the trained run under ``utils.profiling.trace``, and
    ``trace_summary`` on the trace as a process: ``whole_search_kernel``
    listed 3 times. Returns the kernel's entry of the kernels line and a
    directory holding a copy of the cut run's checkpoint and its config
    sidecar (the caller removes it)."""
    t_phase = time.perf_counter()
    config = recipes.recipe_config(RECIPE, ["search_backend=auto"])
    vb, rb = config.value_bins, config.reward_bins
    games = config.num_parallel_games
    checks = {}
    for mode, eval_mode in (("self-play", False), ("evaluation", True)):
        checks[mode] = check_whole_search(
            device, f"{RECIPE_LIBRARY} (recipe {mode})", vb, rb, (games,), config.hidden_size, base=config,
            eval_mode=eval_mode, timed=games,
        )  # fmt: skip
    cfg = search_config_from(config, eval_mode=True)
    print(
        f"recipe path: the evaluation search at prior temperature {cfg.prior_temperature}, pb_c_init "
        f"{cfg.pb_c_init}; kernel {checks['evaluation']['ms']:.3f} ms, self-play search "
        f"{checks['self-play']['ms']:.3f} ms at {games} searches x {config.num_simulations} simulations"
    )
    for mode in checks:
        if not _use_kernel(config, search_config_from(config, eval_mode=mode == "evaluation"), device):
            fail(f"recipe path: search_backend=auto does not route the {mode} search to the kernel")
    time_recipe_moves(device, config)

    run = dataclasses.replace(
        config, max_trajectory_length=RECIPE_SEGMENT_MOVES, min_buffer_size=games, eval_interval=RECIPE_STEPS,
        checkpoint_interval=RECIPE_STEPS, eval_max_moves=RECIPE_EVAL_MOVES,
    )  # fmt: skip
    with tempfile.TemporaryDirectory() as work:
        ckpt_dir, trace_dir = os.path.join(work, "ckpt"), os.path.join(work, "trace")
        trainer = Trainer(run, checkpoint_dir=ckpt_dir, seed=SEED, device=device)
        eval_lengths = []

        def evaluate(num_games=None):
            stats = evaluate_games(trainer.network, trainer._generator, run, num_games, include_per_game=True)
            eval_lengths.append(stats.pop("per_game_lengths"))
            return {k: v for k, v in stats.items() if not k.startswith("per_game")}

        trainer.evaluate = evaluate
        for name in sk.LAUNCHES:
            sk.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.initialize()
        initial = [p.detach().cpu() for p in trainer.network.parameters()]
        trainer.fill_buffer(verbose=False)
        trainer.train(RECIPE_STEPS, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        check_trainer_init(run, SEED, initial)

        fresh = network_from_config(run, tfrng.prng_key(SEED + 7), device)
        restored = TrainState(fresh, create_optimizer(run).init(list(fresh.parameters())))
        if CheckpointManager(ckpt_dir).restore(restored) is None:
            fail("recipe path: no checkpoint was written")
        trained = trainer.state
        same = all(torch.equal(a, b) for a, b in zip(restored.params, trained.params))
        for name in ("mu", "nu"):
            same &= all(torch.equal(a, b) for a, b in zip(restored.opt_state[name], trained.opt_state[name]))
        if not (same and restored.step == trained.step == RECIPE_STEPS):
            fail("recipe path: the restored checkpoint differs from the saved state")

        history = trainer.get_metrics_history()
        gens = [r for r in history if "gen/positions" in r]
        steps = [r for r in history if "total_loss" in r]
        evals = [r for r in history if "eval/mean_reward" in r]
        if len(gens) + fill_segments(run) != 2 or [r["step"] for r in steps] != [10, 20, 30, 40] or len(evals) != 1:
            fail(f"recipe path: {len(gens)} segments, logged steps {[r['step'] for r in steps]}, {len(evals)} evals")
        loss_terms = [k for k in steps[0] if k.endswith("_loss") or k == "codebook_entropy"]
        if not all(math.isfinite(r[k]) for r in steps for k in loss_terms):
            fail("recipe path: a loss term is not finite")
        self_play_moves = (fill_segments(run) + len(gens)) * RECIPE_SEGMENT_MOVES
        eval_moves = max(eval_lengths[0])
        others = {k: v for k, v in launches.items() if k != RECIPE_LIBRARY and v}
        if launches[RECIPE_LIBRARY] != self_play_moves + eval_moves or others:
            fail(f"recipe path: launches {launches} for {self_play_moves} self-play and {eval_moves} evaluation moves")
        # The first logged chunk holds the loop's step-0 segment; the others are learner steps alone.
        chunk_ms = [1e3 / r["steps_per_s"] for r in steps]
        step_ms = statistics.median(chunk_ms[1:])
        gen_s = sum(r["gen/seconds"] for r in gens)
        print(
            f"recipe path ({card_line()}): {len(gens)} logged segments of {RECIPE_SEGMENT_MOVES} moves x {games} games, "
            f"{1e3 * gen_s / (len(gens) * RECIPE_SEGMENT_MOVES):.2f} ms per self-play move; {RECIPE_STEPS} learner steps (batch "
            f"{run.batch_size}, unroll {run.num_unroll_steps}): median {step_ms:.2f} ms per step over chunks of "
            f"{run.log_interval} ({' / '.join(f'{ms:.2f}' for ms in chunk_ms)}); one evaluation of "
            f"{run.eval_games} games, {eval_moves} moves (cap {RECIPE_EVAL_MOVES}), mean reward "
            f"{evals[0]['eval/mean_reward']:.1f}; whole run {wall:.1f} s; peak device memory {peak_mib:.1f} MiB; "
            f"launches {launches}; checkpoint round trip exact"
        )
        print("recipe path: total loss by logged step: " + " ".join(f"{r['total_loss']:.4f}" for r in steps))

        for name in sk.LAUNCHES:
            sk.LAUNCHES[name] = 0
        trace_training.trace_window(trainer, RECIPE_TRACE_MOVES, RECIPE_TRACE_STEPS, trace_dir)
        if sk.LAUNCHES[RECIPE_LIBRARY] != RECIPE_TRACE_MOVES:
            fail(f"recipe path: {sk.LAUNCHES} launches in the traced window of {RECIPE_TRACE_MOVES} moves")
        summary, traced = trace_device_ops(trace_dir)
        kept = shutil.copytree(ckpt_dir, os.path.join(tempfile.mkdtemp(prefix="recipe-ckpt-"), "ckpt"))
    print("\n".join(f"recipe path trace_summary: {line}" for line in summary.strip().splitlines()))
    if traced != RECIPE_TRACE_MOVES:
        fail(f"recipe path: trace_summary lists whole_search_kernel {traced} times for {RECIPE_TRACE_MOVES} moves")
    print(f"recipe path: {RECIPE_TRACE_MOVES} moves and {RECIPE_TRACE_STEPS} learner steps traced, "
          f"whole_search_kernel x{traced} in trace_summary; the phase took {time.perf_counter() - t_phase:.1f} s")  # fmt: skip
    entry = dict(checks["self-play"], name=f"{RECIPE_LIBRARY} (recipe)", launches=launches[RECIPE_LIBRARY])
    entry["max_abs_err"] = max(c["max_abs_err"] for c in checks.values())
    return entry, kept


class WrappedPrediction(torch.nn.Module):
    """The prediction head wrapped as the JAX diagnosis scripts wrap its
    apply function: the real head, then ``fn`` on its policy logits. Only the
    plain search sees it; the kernel packs its weights from the network."""

    def __init__(self, real, fn):
        super().__init__()
        self.real, self.fn = real, fn

    def forward(self, hidden):
        logits, value = self.real(hidden)
        return self.fn(logits), value


# The diagnoses' prior ablations: the port's weight transform, and the JAX scripts' wrapper of the logits.
ABLATIONS = {
    "flat_prior": (autopsy_eval.flat_prior, torch.zeros_like),
    "soften_prior(T=2)": (lambda net: prior_sweep.soften_prior(net, 2.0), lambda logits: logits / 2.0),
    "soften_prior(T=4)": (lambda net: prior_sweep.soften_prior(net, 4.0), lambda logits: logits / 4.0),
}
PRIOR_SCALES = (1.0, 4.0, 16.0, 64.0, 256.0)  # scales of the cut network's policy logits tried by check_ablations
DIAGNOSIS_GAMES = 8
DIAGNOSIS_MOVES = 50  # eval_max_moves of the diagnoses' evaluations
DIAGNOSIS_SIMS = 100  # autopsy_eval's raised simulation budget
# The JAX scripts' JSON keys (runs/autopsy_v3c.log, runs/prior_sweep_tpu.log, runs/champion_probe.json,
# runs/r5_scalar_vs_cat_eval.log); model_probe's reward buckets appear only where the data has such rewards.
AUTOPSY_KEYS = ["ckpt", "variant", "mean_reward", "sem", "max_tile", "reached_512", "mean_length", "search_value",
                "search_entropy"]  # fmt: skip
SWEEP_KEYS = ["variant", "mean_reward", "sem", "max_tile", "reached_512", "search_entropy"]
PROBE_KEYS = ["ckpt", "step", "positions", "reward_mae_raw", "reward_mae_h", "value_corr", "value_mean", "return_mean",
              "value_bias", "value_mae_h", "prior_top1_agreement", "hidden_drift_1step"]  # fmt: skip
PROBE_BUCKETS = {f"{kind}/{tag}" for kind in ("reward_mae_raw", "count") for tag in ("r0", "r4_8", "r16_32", "r_big")}
COMPARE_KEYS = ["ckpt", "step", "mean_reward", "std_reward", "sem_reward", "max_reward", "min_reward", "mean_max_tile",
                "max_tile", "mean_length", "encoder_codes_used", "mean_search_entropy", "mean_search_value",
                *(f"reached_{t}" for t in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768))]  # fmt: skip


def check_ablations(device, network, config) -> float:
    """The diagnoses' ablations on the kernel: for each of ``ABLATIONS``, the
    kernel on the transformed network against the plain search on
    ``network`` with its ``prediction`` wrapped (the JAX scripts' way), under
    the recipe's evaluation search (64 searches x 50 simulations, prior
    temperature 4, pb_c_init 0.5, no root noise) from mid-game roots:
    visit counts identical in every search, root Q and value within rtol
    1e-4 / atol 1e-3 (``check_whole_search``'s float32 rule). Each ablation
    must also move some searches off the untouched network's kernel search,
    or the check could not tell a kernel that carries it from one that drops
    it; the cut run's prior is nearly flat under the evaluation search's
    temperature 4, where softening it moves no search, so the policy logits
    of a copy of the network are scaled by the first of PRIOR_SCALES at
    which every ablation moves a search. Returns the largest |kernel - plain|
    over Q and root value."""
    cfg = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
    obs, invalid = midgame_roots(device, config.num_parallel_games, torch.Generator().manual_seed(SEED + 17))
    b = obs.shape[0]

    def kernel_search(net):
        return sk.run_search_kernel(net, obs, cfg, invalid, packed=sk.pack_for(net, cfg))

    for scale in PRIOR_SCALES:
        scaled = copy.deepcopy(network)
        with torch.no_grad():
            scaled.prediction.policy_logits.weight.mul_(scale)
            scaled.prediction.policy_logits.bias.mul_(scale)
        base = kernel_search(scaled)
        kernels = {name: kernel_search(transform(scaled)) for name, (transform, _) in ABLATIONS.items()}
        moved = {name: int((k.visit_counts != base.visit_counts).any(-1).sum()) for name, k in kernels.items()}
        print(f"diagnosis path: policy logits x {scale:g}: searches each ablation moves on the kernel: {moved}")
        if min(moved.values()) > 0:
            break
    else:
        fail(f"diagnosis path: at no scale of {PRIOR_SCALES} does every ablation move a search: the check shows nothing")
    network = scaled
    max_err = 0.0
    for name, (transform, fn) in ABLATIONS.items():
        kernel = kernels[name]
        real = network.prediction
        network.prediction = WrappedPrediction(real, fn)
        try:
            plain = mcts.batched_run_mcts(network, obs, cfg, invalid)
        finally:
            network.prediction = real
        torch.cuda.synchronize()
        same = (kernel.visit_counts == plain.visit_counts).all(-1)
        err = max(float((kernel.qvalues - plain.qvalues).abs().max()),
                  float((kernel.search_value - plain.search_value).abs().max()))  # fmt: skip
        max_err = max(max_err, err)
        print(
            f"diagnosis path: {name}: the kernel on the transformed network against the plain search with "
            f"prediction wrapped: {int(same.sum())}/{b} searches with identical visit counts, max |kernel - plain| "
            f"over Q and root value {err:.3g}; {moved[name]}/{b} searches differ from the untouched network's"
        )
        for i in (~same).nonzero().flatten().tolist():
            gap = root_gap(kernel.visit_counts[i], plain.visit_counts[i], kernel.qvalues[i], plain.qvalues[i])
            print(f"  search {i} differs: {gap}")
        if not bool(same.all()):
            fail(f"diagnosis path: {name}: {b - int(same.sum())} of {b} searches differ from the wrapped plain search")
        q_ok = torch.allclose(kernel.qvalues, plain.qvalues, rtol=1e-4, atol=1e-3)
        v_ok = torch.allclose(kernel.search_value, plain.search_value, rtol=1e-4, atol=1e-3)
        if not (q_ok and v_ok):
            fail(f"diagnosis path: {name}: Q / root value outside rtol 1e-4, atol 1e-3 of the wrapped plain search")
    return max_err


def finite_numbers(obj) -> bool:
    """Every int or float in a parsed JSON value is finite."""
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def diagnosis_searches(name: str, err: str, expected: int, sims: int) -> dict[int, int]:
    """The lines a diagnosis prints to standard error, one a variant: each
    must name the recipe's CUDA library and count launches of it alone.
    Returns the launches by simulations a search: ``autopsy_eval``'s
    ``sims<DIAGNOSIS_SIMS>`` variants at DIAGNOSIS_SIMS, every other at
    ``sims``."""
    lines = re.findall(r"^(.*): search (.+?), launches (\{.*\}), ([\d.]+) s$", err, re.M)
    if len(lines) != expected:
        print(err[-3000:])
        fail(f"diagnosis path: {name} printed {len(lines)} search lines, not {expected}")
    by_sims = {}
    for label, route, launches, _ in lines:
        launches = ast.literal_eval(launches)
        if route != RECIPE_LIBRARY or set(launches) != {RECIPE_LIBRARY} or launches[RECIPE_LIBRARY] <= 0:
            fail(f"diagnosis path: {label}: search {route}, launches {launches}: not the kernel under auto")
        s = DIAGNOSIS_SIMS if label.endswith(f"sims{DIAGNOSIS_SIMS}") else sims
        by_sims[s] = by_sims.get(s, 0) + launches[RECIPE_LIBRARY]
    return by_sims


def constant_value(network, config, device) -> float | None:
    """The raw value (h⁻¹ of the prediction head's) that ``network`` gives
    every one of 256 mid-game boards, when it gives them all the same one;
    None when it does not."""
    obs, _ = midgame_roots(device, 256, torch.Generator().manual_seed(SEED + 19))
    with torch.no_grad():
        _, value = network.prediction(network.representation(obs))
    raw = inverse_scale_value(value, config.value_epsilon)
    return float(raw[0]) if bool((raw == raw[0]).all()) else None


def drive_diagnoses(ckpt_dir: str, config, constant: float | None = None) -> dict[str, dict[int, int]]:
    """The four checkpoint diagnoses as processes on the cut run's
    checkpoint, at small settings (DIAGNOSIS_GAMES games, evaluations capped
    at DIAGNOSIS_MOVES moves, the recipe's bins and ``search_backend=auto``
    through ``--set``; ``compare_scalar60k`` reads the checkpoint's sidecar):
    every JSON line parses with the JAX script's keys and holds only finite
    numbers, and every variant's line on standard error names the recipe's
    CUDA library. One exception: ``model_probe``'s ``value_corr`` is NaN,
    as ``np.corrcoef`` gives it in the JAX script too, when the network's
    value is one number on every board (``constant``, from
    ``constant_value``) and the probe's ``value_mean`` is that number. The
    four processes run together (``run_entry_points``). Returns the
    launches of each diagnosis by simulations a search."""
    sets = [f"value_bins={config.value_bins}", f"reward_bins={config.reward_bins}", "search_backend=auto",
            f"eval_max_moves={DIAGNOSIS_MOVES}"]  # fmt: skip
    sets = [w for item in sets for w in ("--set", item)]
    games = ["--games", str(DIAGNOSIS_GAMES)]
    runs = {  # name: (arguments, variants)
        "autopsy_eval": (["--ckpt-dir", ckpt_dir, "--steps", str(RECIPE_STEPS), "--sims", str(DIAGNOSIS_SIMS), *games,
                          *sets], 8),
        "prior_sweep": (["--ckpt-dir", ckpt_dir, *games, *sets], 10),
        "model_probe": (["--ckpt-dir", ckpt_dir, "--mode", "small", *games, *sets], 1),
        "compare_scalar60k": ([ckpt_dir, *games], 1),
    }  # fmt: skip
    card = card_line()
    t0 = time.perf_counter()
    outputs = run_entry_points({name: args for name, (args, _) in runs.items()})
    seconds = time.perf_counter() - t0
    print(f"diagnosis path: the four diagnoses as processes started together: {seconds:.1f} s; {card}")
    launches = {}
    for name, (args, variants) in runs.items():
        out, err = outputs[name]
        seconds = sum(float(x) for x in re.findall(r", ([\d.]+) s$", err, re.M))
        launches[name] = diagnosis_searches(name, err, variants, config.num_simulations)
        checked = None
        if name == "model_probe":
            lines = [json.loads(out)]
            ok = [k for k in lines[0] if k not in PROBE_BUCKETS] == PROBE_KEYS
            probe = lines[0]
            if (ok and constant is not None and math.isnan(probe["value_corr"])
                    and math.isclose(probe["value_mean"], constant, rel_tol=1e-5, abs_tol=1e-6)):  # fmt: skip
                checked = [{k: v for k, v in probe.items() if k != "value_corr"}]
                print(f"diagnosis path: model_probe: value_corr NaN, the correlation of a constant: the network's "
                      f"value is {constant:.6g} on every board, and value_mean {probe['value_mean']:.6g}")  # fmt: skip
        else:
            lines = [json.loads(line) for line in out.strip().splitlines()]
            keys = {"autopsy_eval": AUTOPSY_KEYS, "prior_sweep": SWEEP_KEYS, "compare_scalar60k": COMPARE_KEYS}[name]
            ok = len(lines) == variants and all(list(line) == keys for line in lines)
        if not ok or not finite_numbers(checked or lines):
            print(out[-3000:])
            fail(f"diagnosis path: {name}: its JSON lines do not have the JAX script's keys and finite numbers")
        print(f"diagnosis path: {name} {' '.join(args)}: {len(lines)} JSON line(s), {variants} variant(s), "
              f"{RECIPE_LIBRARY} launches by simulations a search {launches[name]}, {seconds:.2f} s in its "
              "variants")  # fmt: skip
        for line in lines:
            print(f"diagnosis path: {name}: {json.dumps(line)}")
    return launches


def drive_diagnosis_path(device, ckpt_dir: str) -> dict[str, dict]:
    """The checkpoint diagnoses on the recipe path's cut run (categorical,
    H=128, step RECIPE_STEPS): ``check_ablations`` on its network, then
    ``drive_diagnoses`` on its checkpoint, with the launch counts of each
    diagnosis process read from its lines. Removes ``ckpt_dir``'s parent.
    Returns the kernels line's entries of the diagnoses, one for each
    simulation count they search with: ``check_whole_search`` at their own
    shapes (DIAGNOSIS_GAMES searches, the recipe's widths and bins), with
    the launches the diagnoses made at that count."""
    t_phase = time.perf_counter()
    config = load_train_config(ckpt_dir)
    network = network_from_config(config, tfrng.prng_key(SEED + 9), device)
    state = TrainState(network, create_optimizer(config).init(list(network.parameters())))
    if CheckpointManager(ckpt_dir).restore(state) is None or state.step != RECIPE_STEPS:
        fail(f"diagnosis path: no checkpoint at step {RECIPE_STEPS} in the recipe path's copy")
    max_err = check_ablations(device, network, config)
    launches = drive_diagnoses(ckpt_dir, config, constant_value(network, config, device))
    shutil.rmtree(os.path.dirname(ckpt_dir))
    by_sims = {}
    for counts in launches.values():
        for s, n in counts.items():
            by_sims[s] = by_sims.get(s, 0) + n
    print(f"diagnosis path: launches by diagnosis {launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    entries = {}
    for s, n in sorted(by_sims.items()):
        name = f"{RECIPE_LIBRARY} (diagnoses, {s} simulations)"
        entry = check_whole_search(
            device, name, config.value_bins, config.reward_bins, (DIAGNOSIS_GAMES,), config.hidden_size,
            base=dataclasses.replace(config, num_simulations=s), timed=DIAGNOSIS_GAMES,
        )  # fmt: skip
        entry["launches"] = n
        entry["max_abs_err"] = max(entry["max_abs_err"], max_err)
        entries[name] = entry
    return entries


def actor_learner_config():
    """The training path's cut (``training_config()``) with the learner's
    parameters published every ``AL_SYNC`` steps (``generation_interval``,
    which ``LearnerServer`` takes as its ``param_sync_interval``)."""
    return dataclasses.replace(training_config(), generation_interval=AL_SYNC)


def clone_buffer(buffer):
    return replay_lib.BufferState(*(x.clone() for x in buffer))


def in_thread(fn):
    """``fn()`` in a thread of its own (the actor's side of a split run in one
    process), waited for; its failure is raised here."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller's thread
            out["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(AL_TIMEOUT)
    if thread.is_alive():
        fail(f"actor/learner parity: the actor's thread ran past {AL_TIMEOUT} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def learner_rate(step_rates, hooks: set[int], first_step: int) -> tuple[float, int]:
    """Learner steps/s over the logged ``(step, steps/s)`` pairs from
    ``first_step`` on (``log_interval`` 1) whose interval ran no host hook
    (every mode pays those alike): those steps over their summed seconds.
    Returns the rate and the steps counted."""
    kept = [sps for step, sps in step_rates if step >= first_step and step - 1 not in hooks]
    if not kept:
        fail("actor/learner rates: no learner step to time")
    return len(kept) / sum(1 / x for x in kept), len(kept)


def check_actor_learner(device) -> dict[str, float]:
    """(a) The split in this process on the card, the actor in a thread: the
    parameters the actor loads are the learner's published snapshot, its
    generations equal direct ``generate_games`` calls on the same weights with
    a generator of the same seed from the same games (trajectory fields and
    ``GenStats``, bit for bit), and the learner's buffer after each message
    equals ``ingest_segment`` applied directly (the second message re-grounds
    the first's truncated games). Two generations fill the buffer; the
    learner takes ``AL_SYNC`` steps and republishes; the third generation
    pulls that step's parameters, which differ from step 0's, and still
    equals the direct call, while the same call on step 0's weights stores
    other value targets: nothing derived from the weights (the kernel's
    pack) outlives a pull. Then the learner's steps/s serial (its own
    self-play every ``AL_SYNC`` steps) and solo (no self-play), each over
    ``AL_RATE_STEPS`` steps with the host hooks off, as
    ``scripts/measure_overlap.py`` measures them. Returns both rates."""
    config = actor_learner_config()
    trainer = Trainer(config, seed=SEED, device=device)
    trainer.initialize()
    server = LearnerServer(trainer, port=0).start()
    if server.param_sync_interval != AL_SYNC:
        fail(f"actor/learner parity: the learner publishes every {server.param_sync_interval} steps")
    direct_net = network_from_config(config, tfrng.prng_key(0), device)
    direct_gen = torch.Generator(device=device).manual_seed(AL_ACTOR_SEED)
    direct_state = envlib.reset_batch(AL_ACTOR_SEED * 2654435761 % (1 << 31), BATCH, device)
    prev, step0, gen_s = None, None, []
    try:
        actor = in_thread(lambda: ActorClient(config, server.address, seed=AL_ACTOR_SEED, device=device))
        for gen in range(3):
            if gen == 2:
                server.run(AL_SYNC, verbose=False)  # steps and republishes
            in_thread(lambda: actor.run(1))
            step, snapshot = server._latest_params
            loaded = [torch.from_numpy(x).to(device) for x in snapshot]
            if not all(torch.equal(p, x) for p, x in zip(actor._network.parameters(), loaded, strict=True)):
                fail(f"actor/learner parity: generation {gen}'s parameters are not the published snapshot")
            if gen == 0:
                step0 = loaded
            elif gen == 2:
                changed = sum(not torch.equal(a, b) for a, b in zip(step0, loaded))
                if actor.learner_step != AL_SYNC or step != AL_SYNC or changed == 0:
                    fail(f"actor/learner parity: the pull after {AL_SYNC} steps saw step {actor.learner_step}, "
                         f"{changed} parameter tensors changed")  # fmt: skip
            msg = server._traj_queue.get(timeout=AL_TIMEOUT)
            if gen == 2:
                # The same generation on step 0's weights differs: a pack left from them would show.
                stale_gen = torch.Generator(device=device)
                stale_gen.set_state(direct_gen.get_state())
                _, stale, _ = generate_games(direct_net, stale_gen, config, step, BATCH, direct_state)
            with torch.no_grad():
                for p, x in zip(direct_net.parameters(), loaded):
                    p.copy_(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            direct_state, traj, stats = generate_games(direct_net, direct_gen, config, step, BATCH, direct_state)
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            for kind, got, want in (("trajectory", msg["payload"], traj), ("GenStats", msg["gen_stats"], stats)):
                for name, a, b in zip(want._fields, got, _to_numpy(want), strict=True):
                    if not np.array_equal(a, b):
                        fail(f"actor/learner parity: generation {gen}'s {kind} field {name} differs from the direct call")
            if gen == 2 and np.array_equal(stale.values.cpu().numpy(), msg["payload"].values):
                fail("actor/learner parity: the generation on step 0's weights equals the one on step 4's")
            if (msg["actor_id"], msg["generation"]) != (AL_ACTOR_SEED, gen):
                fail(f"actor/learner parity: message {msg['actor_id']}/{msg['generation']} for generation {gen}")
            expected, prev = ingest_segment(clone_buffer(trainer.buffer), prev, traj, stats.first_search_value, config)
            server._ingest_message(msg)
            for name, a, b in zip(replay_lib.BufferState._fields, expected, trainer.buffer):
                if not torch.equal(a, b):
                    fail(f"actor/learner parity: buffer field {name} after generation {gen} differs from ingest_segment")
        actor.close()
    finally:
        server.close()
    print(
        f"actor/learner parity (in one process, the actor in a thread): 3 generations of {BATCH} games x "
        f"{TRAIN_SEGMENT_MOVES} moves, parameters = the published snapshot (steps 0, 0, {AL_SYNC}), trajectories and "
        f"GenStats = direct generate_games bit for bit, buffers = ingest_segment bit for bit; the direct calls "
        f"{1e3 * statistics.median(gen_s) / TRAIN_SEGMENT_MOVES:.2f} ms per move"
    )

    # Serial and solo learner rates on this trainer (its buffer holds three generations), host hooks off.
    quiet = dict(eval_interval=1 << 30, checkpoint_interval=1 << 30, reanalyze_interval=None, deep_eval_interval=None)
    rates = {}
    for mode, interval in (("serial", AL_SYNC), ("solo", 1 << 30)):
        trainer.config = dataclasses.replace(config, generation_interval=interval, **quiet)
        first = int(trainer.state.step) + 1
        trainer.train(AL_RATE_STEPS, verbose=False)
        history = trainer.metrics.history
        step_rates = [(r["step"], r["steps_per_s"]) for r in history if "steps_per_s" in r]
        rates[mode], n = learner_rate(step_rates, set(hook_steps(history)), first)
        gens = sum(1 for r in history if "gen/seconds" in r and r["step"] >= first - 1)
        print(f"actor/learner rates: {mode} learner {rates[mode]:.4f} steps/s over {n} steps ({gens} self-play "
              f"segments among them)")  # fmt: skip
    return rates


def config_overrides(config) -> list[str]:
    """``--set`` arguments that make ``--mode full`` (``default_config()``) into ``config``."""
    base = config_lib.default_config()
    args = []
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        if value != getattr(base, field.name):
            args += ["--set", f"{field.name}={value!r}"]
    return args


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_roles(config) -> tuple[dict, dict, float]:
    """The learner and one actor as two processes through the entry point,
    both on the card, each under ``AL_TIMEOUT``: if either exits non-zero or
    runs out of time, the other is killed and the run fails. Returns both
    roles' counts lines and the wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    command = [sys.executable, "-m", "simulate_2048_tpu_torch.actor_learner_demo", "--mode", "full",
               "--port", str(free_port()), "--fill-timeout", str(AL_TIMEOUT), *config_overrides(config)]  # fmt: skip
    roles = {
        "learner": ["--role", "learner", "--steps", str(TRAIN_STEPS)],
        "actor": ["--role", "actor", "--generations", str(AL_GENERATIONS), "--actor-seed", str(AL_ACTOR_SEED)],
    }
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    outs = {}
    with tempfile.TemporaryDirectory() as logs:
        files = {role: open(os.path.join(logs, role), "w+") for role in roles}
        t0 = time.perf_counter()
        procs = {role: subprocess.Popen(command + args, cwd=root, env=env, stdout=files[role],
                                        stderr=subprocess.STDOUT) for role, args in roles.items()}  # fmt: skip
        try:
            while any(p.poll() is None for p in procs.values()):
                if any(p.poll() not in (None, 0) for p in procs.values()) or time.perf_counter() - t0 > AL_TIMEOUT:
                    break
                time.sleep(0.2)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for role, f in files.items():
            f.seek(0)
            outs[role] = f.read()
            f.close()
    codes = {role: p.returncode for role, p in procs.items()}
    for role, code in codes.items():
        lines = outs[role].strip().splitlines()[-(AL_LOG_LINES if code == 0 else 40):]
        print("\n".join(f"actor/learner {role}: {line}" for line in lines if not line.startswith("{")))
    if any(codes.values()):
        fail(f"actor/learner processes: exit codes {codes} after {wall:.1f} s (a role that fails or runs out of "
             f"time is stopped with the other: -9)")  # fmt: skip
    counts = {}
    for role in roles:
        lines = outs[role].strip().splitlines()
        counts[role] = json.loads(lines[-2])
        if counts[role]["role"] != role:
            fail(f"actor/learner processes: no counts line from the {role}")
    return counts["learner"], counts["actor"], wall


def drive_actor_learner(device) -> int:
    """The actor/learner path on the card: (a) ``check_actor_learner``; (b)
    the two roles as processes through
    ``python -m simulate_2048_tpu_torch.actor_learner_demo``; (c) the
    learner's steps/s solo, overlapped and serial, ``overlap_efficiency``
    (overlapped / solo), the actor's ms per move alone and while the learner
    trains, and each process's peak device memory.

    Widths, heads, games, batch and unroll are the training path's (H=256, 10
    blocks, 100 simulations, 256/128 bins, batch 1,024, unroll 5, backend
    "auto"). Depth cut as the training path's: one actor of 256 games,
    24-move segments (not 200), ``min_buffer_size`` of two generations, 12
    learner steps, parameters published every 4 steps, one reanalyze pass
    (at step 6), an inline and a deep evaluation at step 12 and one at the
    end, each of 8 moves; ``AL_GENERATIONS`` actor generations; the serial
    and solo rates over ``AL_RATE_STEPS`` steps. Returns the actor's
    ``whole_search_categorical`` launches."""
    t_phase = time.perf_counter()
    rates = check_actor_learner(device)
    gc.collect()
    torch.cuda.empty_cache()

    config = actor_learner_config()
    built = sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir())
    learner, actor, wall = run_roles(config)
    if sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir()) != built:
        fail("actor/learner processes: a role built a kernel library instead of loading the cached one")

    # The learner: its steps with a finite loss, batches from the actor, a pull per actor generation.
    if learner["steps"] != TRAIN_STEPS or not math.isfinite(learner["final_loss"]):
        fail(f"actor/learner processes: the learner reached step {learner['steps']}, loss {learner['final_loss']}")
    if learner["trajectories_received"] < 2 or learner["params_served"] < actor["generations"]:
        fail(f"actor/learner processes: {learner['trajectories_received']} batches received, "
             f"{learner['params_served']} parameter pulls served for {actor['generations']} generations")  # fmt: skip
    # The actor searched on the kernel, one launch a move; the learner on its evaluations and reanalyze only.
    moves = actor["moves"]
    if actor["generations"] != AL_GENERATIONS or moves != AL_GENERATIONS * TRAIN_SEGMENT_MOVES:
        fail(f"actor/learner processes: the actor played {actor['generations']} generations, {moves} moves")
    if actor["launches"]["whole_search_categorical"] != moves or sum(actor["launches"].values()) != moves:
        fail(f"actor/learner processes: the actor launched {actor['launches']} for {moves} moves")
    evaluations = 3  # the inline and the deep evaluation at the last step, and the role's own at the end
    expected = evaluations * TRAIN_EVAL_MOVES + reanalyze.search_batches(REANALYZE_EPISODES * TRAIN_SEGMENT_MOVES)
    if learner["launches"]["whole_search_categorical"] != expected or sum(learner["launches"].values()) != expected:
        fail(f"actor/learner processes: the learner launched {learner['launches']}, not its {evaluations} "
             f"evaluations' and one reanalyze pass's {expected} (a self-play search would add more)")  # fmt: skip
    if max(actor["learner_steps"]) <= 0:
        fail(f"actor/learner processes: the actor saw learner steps {actor['learner_steps']} only")

    # (c) Overlapped: the learner's steps (after the first) that ended while the actor played.
    start, end = learner["work_window"]
    actor_end = actor["generation_windows"][-1][1]
    played, t = [], start
    for step, sps in learner["step_rates"]:
        t += 1 / sps
        if t <= actor_end:
            played.append((step, sps))
    overlapped, n_over = learner_rate(played, set(learner["hook_steps"]), 2)

    def ms_per_move(windows):
        return statistics.median(1e3 * (e - s) / TRAIN_SEGMENT_MOVES for s, e in windows) if windows else math.nan

    def overlap(s, e):
        return max(0.0, min(e, end) - max(s, start)) / (e - s)

    windows = actor["generation_windows"]
    alone = [w for w in windows[1:] if overlap(*w) < 0.1]
    during = [w for w in windows if overlap(*w) > 0.9]
    smi = card_line()
    print(
        f"actor/learner processes ({smi}): learner {learner['steps']} steps, {learner['trajectories_received']} "
        f"batches received ({learner['trajectories_dropped']} dropped), {learner['params_served']} pulls served, "
        f"final loss {learner['final_loss']:.4f}, evaluation mean reward {learner['eval_mean_reward']:.1f}, launches "
        f"{learner['launches']['whole_search_categorical']} (evaluations and reanalyze); actor {actor['generations']} "
        f"generations, {moves} moves, {actor['launches']['whole_search_categorical']} whole_search_categorical "
        f"launches, learner steps seen {actor['learner_steps']}; both processes {wall:.1f} s; no kernel rebuilt"
    )
    print(
        f"actor/learner numbers ({smi}): learner steps/s solo {rates['solo']:.4f}, overlapped {overlapped:.4f} "
        f"(over {n_over} steps), serial {rates['serial']:.4f}; overlap_efficiency {overlapped / rates['solo']:.4f}; "
        f"actor ms per move alone {ms_per_move(alone):.2f} ({len(alone)} generations), while the learner trains "
        f"{ms_per_move(during):.2f} ({len(during)} generations); peak device memory (allocated / reserved MiB): "
        f"learner {learner['peak_allocated_mb']:.1f} / {learner['peak_reserved_mb']:.1f}, actor "
        f"{actor['peak_allocated_mb']:.1f} / {actor['peak_reserved_mb']:.1f}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s"
    )
    return actor["launches"]["whole_search_categorical"]


def gradient_length(config) -> int:
    """Elements of ``config``'s flattened gradient: every parameter of its networks."""
    return sum(p.numel() for p in network_from_config(config, tfrng.prng_key(SEED), "cpu").parameters())


# Libraries whose search kernel must neither spill nor keep a stack frame: their ring loops slow down when they do.
NO_SPILL_LIBRARIES = ("whole_search", "whole_search_bf16", "whole_search_bf16_streamed")
TENSOR_CORE_LIBRARIES = ("whole_search_bf16", "whole_search_bf16_streamed")


def whole_search_ptxas(library: str, log: str) -> str:
    """ptxas's registers, stack frame and spills of ``library``'s whole-search
    kernel (the tensor-core libraries': ``whole_search_mma_kernel``), from its
    build's report; fails on a stack frame or a spill in NO_SPILL_LIBRARIES.
    The float32 streamed library's report is only printed."""
    kernel = "whole_search_mma_kernel" if library.startswith("whole_search_bf16") else "whole_search_kernel"
    chunks = [c for c in log.split("Compiling entry function '")[1:] if kernel in c.split("'", 1)[0]]
    chunk = chunks[-1] if chunks else ""
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
    used = re.search(r"Used (\d+) registers", chunk)
    if frame is None or used is None:
        fail(f"{library}: no ptxas report of the whole-search kernel's frame or registers")
    if library in NO_SPILL_LIBRARIES and any(int(x) for x in frame.groups()):
        fail(f"{library}: ptxas reports {frame[0]}; its ring kernel must neither spill nor keep a stack frame")
    return f"{library} ptxas: {used[1]} registers a thread, {frame[0]}"


def count_hmma(library: str) -> int:
    """Tensor-core instructions (HMMA) in ``library``'s machine code, by ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(library))], capture_output=True, text=True)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed on {library}: {sass.stderr.strip()}")
    return len(re.findall(r"\bHMMA\.", sass.stdout))


def check_ring_ptxas(log: str) -> None:
    """ptxas's report on every instantiation of the ring kernel (element type
    x N), kept with its build: fails on a stack frame or a spill, or when an
    instantiation is missing from the report; prints the registers per thread
    by dtype and N."""
    registers: dict[str, dict[int, int]] = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        found = re.search(r"all_reduce_kernelI(f|13__nv_bfloat16|6__half)Li(\d+)E", chunk.split("'", 1)[0])
        if found is None:
            continue
        dtype, n = RING_PTXAS_TYPES[found[1]], int(found[2])
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        used = re.search(r"Used (\d+) registers", chunk)
        if frame is None or used is None:
            fail(f"ring_all_reduce {dtype} N={n}: no ptxas report of its frame or registers")
        if any(int(x) for x in frame.groups()):
            fail(f"ring_all_reduce {dtype} N={n}: {frame[0]}")
        registers.setdefault(dtype, {})[n] = int(used[1])
    if sorted(registers) != sorted(RING_PTXAS_TYPES.values()) or any(len(r) != 15 for r in registers.values()):
        fail(f"ring_all_reduce: ptxas reported {sum(len(r) for r in registers.values())} of 45 instantiations")
    for dtype, by_n in registers.items():
        print(f"ring_all_reduce {dtype}: 0 bytes stack frame and no spills at N = 2..16; registers per thread "
              + ", ".join(f"N={n}: {r}" for n, r in sorted(by_n.items())))  # fmt: skip


def ring_shards(n: int, m: int, dtype: torch.dtype, gen: torch.Generator, device) -> dict[str, list[torch.Tensor]]:
    """``n`` seeded shards of ``m`` elements: aligned, and at an odd ``m`` also unaligned views of one buffer."""
    cases = {"aligned": [torch.randn(m, generator=gen, device=device).to(dtype) for _ in range(n)]}
    if m % 2:
        base = torch.randn(n * m + 1, generator=gen, device=device).to(dtype)
        cases["unaligned"] = [base[1 + i * m : 1 + (i + 1) * m] for i in range(n)]
    return cases


def ring_bound(n: int, m: int, dtype: torch.dtype, card: str) -> tuple[float, str, int]:
    """The all-reduce's bound in ms, what bounds it, and its bytes: each shard
    read once and each sum written once at the HBM rate, against the N (N - 1)
    adds per element (every rank its own order) at the FP32 rate."""
    nbytes = 2 * n * m * dtype.itemsize
    bytes_ms = nbytes / (HBM_TBPS[card] * 1e12) * 1e3
    op_ms = n * (n - 1) * m / (FP32_TFLOPS[card] * 1e12) * 1e3
    return max(bytes_ms, op_ms), "bytes" if bytes_ms >= op_ms else "operations", nbytes


def check_ring_all_reduce(device) -> dict:
    """The ring all-reduce kernel against its plain version (the rotation
    order, bit for bit), in float32, bfloat16 and float16, at N = 2, 4 and 8
    virtual ranks on the card, at the full model's flattened gradient length
    and at an odd length, each launched twice; at the odd length also on
    unaligned views (the kernel's scalar loop). float32 is also held within
    rtol 1e-5 / atol 1e-5 of PyTorch's own sum, and float64 CUDA shards must
    raise. Then times (CUDA events, median of 5) float32 at the gradient
    length for each N and bfloat16 at N = 4: the kernel and the one PyTorch
    call (the (N, m) stack summed over N and written to N outputs), each over
    RING_CALLS calls enqueued behind a sleep, and the plain version (N^2
    launches a call) one call at a time, beside the bound. Returns the entry of the
    data-parallel path's shape, N = DP_REPLICAS in float32."""
    grad_length = gradient_length(training_config())
    gen = torch.Generator(device=device).manual_seed(SEED)
    card = sku(torch.cuda.get_device_name(0))
    try:
        ring.ring_all_reduce_shard([torch.zeros(8, dtype=torch.float64, device=device)] * 2)
        fail("ring_all_reduce: float64 CUDA shards did not raise")
    except ValueError as err:
        if "float32, bfloat16 or float16" not in str(err):
            fail(f"ring_all_reduce: the error for float64 CUDA shards does not name the kernel's dtypes: {err}")
    entry = None
    for n in RING_RANKS:
        for dtype in RING_DTYPES:
            for m in (grad_length, RING_ODD_LENGTH):
                cases = ring_shards(n, m, dtype, gen, device)
                for label, xs in cases.items():
                    want = ring.ring_all_reduce_reference(xs)
                    total = torch.stack(xs).float().sum(0)
                    for launch in (1, 2):
                        got = ring.ring_all_reduce_shard(xs)
                        torch.cuda.synchronize()
                        for rank, (a, b) in enumerate(zip(got, want)):
                            if not torch.equal(a, b):
                                fail(f"ring_all_reduce: {dtype} N={n}, m={m} {label}, launch {launch}: rank {rank} "
                                     f"differs from the plain version at {int((a != b).sum())} of {m}")  # fmt: skip
                            if dtype == torch.float32 and not torch.allclose(a, total, rtol=1e-5, atol=1e-5):
                                fail(f"ring_all_reduce: N={n}, m={m} {label}: rank {rank} is not the sum (rtol 1e-5)")
                    spread = max(float((g.float() - total).abs().max()) for g in got)
                    grid = ring.LAST_GRID
                    print(f"ring_all_reduce: {str(dtype)[6:]} N={n}, m={m:,} ({label}), {grid['blocks']} blocks, "
                          f"{grid['vectors_per_thread']} vectors a thread (0: the scalar loop): two launches equal "
                          f"the plain version bit for bit; max |rank sum - f32 sum| {spread:.3g}")  # fmt: skip
            if not (dtype == torch.float32 or (dtype == torch.bfloat16 and n == DP_REPLICAS)):
                continue
            shards = ring_shards(n, grad_length, dtype, gen, device)["aligned"]
            stacked = torch.stack(shards)
            ms = cuda_ms(lambda: ring.ring_all_reduce_shard(shards), reps=5, calls=RING_CALLS)
            plain_ms = cuda_ms(lambda: ring.ring_all_reduce_reference(shards), reps=5)
            library_ms = cuda_ms(
                lambda: stacked.sum(0).expand(n, grad_length).contiguous(), reps=5, calls=RING_CALLS
            )
            bound_ms, bound_by, nbytes = ring_bound(n, grad_length, dtype, card)
            print(
                f"ring_all_reduce: {str(dtype)[6:]} N={n}, m={grad_length:,} "
                f"({grad_length * dtype.itemsize / 1e6:.1f} MB a shard): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, torch (N, m).sum(0) to N outputs {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({nbytes / 1e6:.1f} MB at {HBM_TBPS[card]} TB/s, {card}; the kernel moves these bytes and no "
                f"more): {bound_ms / ms:.3f} of the bound, {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved; "
                f"{library_ms / ms:.2f}x the torch call's speed"
            )
            if n == DP_REPLICAS and dtype == torch.float32:
                entry = {
                    "name": "ring_all_reduce",
                    "route": "cuda",
                    "source": "simulate_2048_tpu_torch/csrc/ring_all_reduce.cu",
                    "replaces": "simulate_2048_tpu/parallel/ring.py:52",
                    "max_abs_err": 0.0,  # bit for bit, checked above
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                }
    return entry


def dp_config():
    """The training recipe's widths on the data-parallel path; depth cut:
    one 24-move self-play segment of 256 games fills the buffer, and no more
    is generated (``freeze_data_after=0``); no reanalyze, evaluation or deep
    evaluation (they run on one device, as on the training path)."""
    return dataclasses.replace(
        training_config(),
        min_buffer_size=BATCH,
        replay_buffer_size=2 * BATCH,
        freeze_data_after=0,
        generation_interval=DP_SUPERSTEP,
        log_interval=DP_SUPERSTEP,
        checkpoint_interval=1 << 20,
        eval_interval=1 << 20,
        reanalyze_interval=None,
        deep_eval_interval=None,
    )


def replicas_identical(step) -> bool:
    first = step.replicas[0]
    return all(
        r.step == first.step
        and all(torch.equal(a, b) for a, b in zip(first.params, r.params))
        and all(torch.equal(a, b) for k in ("mu", "nu") for a, b in zip(first.opt_state[k], r.opt_state[k]))
        for r in step.replicas[1:]
    )


def drive_dp_training(device, ring_ms: float) -> int:
    """The data-parallel path at full width on a virtual mesh of DP_REPLICAS
    replicas of the card: ``Trainer(mesh=...)`` fills its buffer with one
    self-play segment, runs one fused data-parallel superstep of
    DP_SUPERSTEP steps (``train``) and one per-step data-parallel step, with
    the launch counts set to 0 just before: one ring launch per step, one
    search launch per self-play move. Then one data-parallel step from a
    copy of the trained state against the single-device ``train_step`` on
    the same batch. Returns the ring's launches in the run."""
    config = dp_config()
    mesh = make_mesh([device] * DP_REPLICAS)
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    ring.LAUNCHES["ring_all_reduce"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(config, seed=SEED, mesh=mesh)
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.train(DP_SUPERSTEP, verbose=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    superstep_ok = replicas_identical(trainer._dp_step)
    loss = trainer.optimize_step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ring.LAUNCHES["ring_all_reduce"]
    search_launches = dict(sk.LAUNCHES)

    steps = DP_SUPERSTEP + 1
    if launches != steps or trainer.state.step != steps or trainer._dp_superstep is None:
        fail(f"data-parallel path: {launches} ring launches and step {trainer.state.step} for {steps} steps")
    segment_launches = search_launches["whole_search_categorical"]
    if segment_launches != TRAIN_SEGMENT_MOVES or sum(search_launches.values()) != TRAIN_SEGMENT_MOVES:
        fail(f"data-parallel path: search launches {search_launches} for one {TRAIN_SEGMENT_MOVES}-move segment")
    if not (superstep_ok and replicas_identical(trainer._dp_step)):
        fail("data-parallel path: the replicas' parameters or optimizer states differ after a step")
    if sum(p.numel() for p in trainer.state.params) != gradient_length(training_config()):
        fail("data-parallel path: the flattened gradient is not the length the ring was checked at")
    history = [r for r in trainer.get_metrics_history() if "total_loss" in r]
    loss_terms = [k for k in history[0] if k.endswith("_loss") or k == "codebook_entropy"]
    values = [r[k] for r in history for k in loss_terms] + [float(x) for x in loss]
    if len(history) != 1 or not torch.isfinite(torch.tensor(values)).all():
        fail(f"data-parallel path: {len(history)} logged supersteps, or a loss term is not finite")
    initial = network_from_config(config, tfrng.prng_key(SEED), device)
    changed = sum(not torch.equal(a, b) for a, b in zip(initial.parameters(), trainer.state.params))
    if changed < len(trainer.state.params) // 2:
        fail(f"data-parallel path: only {changed} of {len(trainer.state.params)} parameter tensors changed")
    fused_ms = 1e3 * (t2 - t1) / DP_SUPERSTEP
    step_ms = 1e3 * (t3 - t2)
    print(
        f"data-parallel path ({DP_REPLICAS} replicas of {torch.cuda.get_device_name(0)}, batch {config.batch_size} = "
        f"{DP_REPLICAS} x {config.batch_size // DP_REPLICAS}, unroll {config.num_unroll_steps}, "
        f"H={config.hidden_size}, NB={config.num_residual_blocks}, bins 256/128): one {TRAIN_SEGMENT_MOVES}-move "
        f"segment of {BATCH} games {t1 - t0:.2f} s with set-up; fused superstep of {DP_SUPERSTEP} steps "
        f"{fused_ms:.2f} ms per step, the per-step path {step_ms:.2f} ms; the ring kernel ({ring_ms:.4f} ms alone "
        f"at this shape) is {ring_ms / fused_ms:.3g} of a fused step; {launches} ring launches for {steps} steps; "
        f"replicas bit-identical; {changed}/{len(trainer.state.params)} parameter tensors changed"
    )
    print("data-parallel path: last step " + " ".join(f"{k}={float(getattr(loss, k)):.4f}" for k in loss._fields))

    # One data-parallel step from a copy of the state against one single-device step on the same batch.
    batch, _, weights = replay_lib.sample_batch(trainer.buffer, torch.Generator(device=device).manual_seed(SEED),
                                                config.batch_size, config)  # fmt: skip
    optimizer = create_optimizer(config)
    copies = []
    for _ in range(2):
        net = copy.deepcopy(trainer.state.network)
        opt_state = {"count": trainer.state.opt_state["count"],
                     **{k: [t.clone() for t in trainer.state.opt_state[k]] for k in ("mu", "nu")}}  # fmt: skip
        copies.append(TrainState(net, opt_state, trainer.state.step))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    single, loss_a, prio_a = train_step(copies[0], batch, weights, config, optimizer)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    dp_step = make_dp_train_step(copies[1].network, config, optimizer, mesh)
    dp_state, loss_b, prio_b = dp_step(copies[1], batch, weights)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    loss_err = abs(float(loss_b.total_loss) - float(loss_a.total_loss)) / abs(float(loss_a.total_loss))
    prio_err = float(((prio_b - prio_a).abs() / prio_a.abs()).max())
    with torch.no_grad():
        # The clipped gradients each step applied, read back from Adam's first moment: mu' = b1 mu + (1 - b1) g.
        b1 = optimizer.b1
        mu0 = trainer.state.opt_state["mu"]
        g_single = torch.cat([(m - b1 * m0).flatten() for m, m0 in zip(single.opt_state["mu"], mu0)])
        g_dp = torch.cat([(m - b1 * m0).flatten() for m, m0 in zip(dp_state.opt_state["mu"], mu0)])
        grad_err = float((g_dp - g_single).norm() / g_single.norm())
        pairs = list(zip(single.params, dp_state.params))
        within = sum(int(((b - a).abs() <= 1e-6 + 1e-4 * a.abs()).sum()) for a, b in pairs)
        total = sum(a.numel() for a, _ in pairs)
        # Adam moves an element by at most lr (1 - b1) / sqrt(1 - b2) in a step (Kingma & Ba, section 2.1).
        lr = learning_rate(config, trainer.state.opt_state["count"])
        adam_max = lr * (1 - b1) / (1 - optimizer.b2) ** 0.5
        param_diff = max(float((b - a).abs().max()) for a, b in pairs)
    print(
        f"data-parallel step vs single-device train_step on one batch: total loss {float(loss_b.total_loss):.6f} vs "
        f"{float(loss_a.total_loss):.6f} (relative {loss_err:.3g}), priorities max relative {prio_err:.3g}, applied "
        f"gradient relative L2 difference {grad_err:.4g} (limit 2^-8 = {2.0**-8:.4g}); parameters: {within}/{total} "
        f"({within / total:.4f}) within rtol 1e-4 / atol 1e-6, max |dp - single| {param_diff:.4g} (limit "
        f"{2 * adam_max:.4g}: twice Adam's largest step at learning rate {lr:.4g}); single-device step "
        f"{1e3 * (t5 - t4):.2f} ms, data-parallel step {1e3 * (t6 - t5):.2f} ms (replicas built at its first step)"
    )
    if loss_err > 1e-5 or prio_err > 1e-4 or grad_err > 2.0**-8 or param_diff > 2 * adam_max:
        fail("data-parallel step: outside loss rtol 1e-5, priorities rtol 1e-4, gradient 2^-8 or two Adam steps")
    if not replicas_identical(dp_step):
        fail("data-parallel step: the replicas differ")
    return launches


ENTRY_TIMEOUT = 240  # seconds each measurement entry point may take
# benchmark_mcts --pallas at the full preset, one run per library: the flags that reach it.
CAT_BINS = ["--value-bins", "256", "--reward-bins", "128"]
MCTS_RUNS = {
    "whole_search": [],
    "whole_search_categorical": CAT_BINS,
    "whole_search_bf16": ["--weight-dtype", "bfloat16", *CAT_BINS],
    "whole_search_bf16_streamed": ["--weight-dtype", "bfloat16", "--hidden", str(WIDE_HIDDEN), *CAT_BINS],
}
MCTS_FLAGS = ["--mode", "full", "--boards", str(BATCH), "--max-depth", "32"]
MCTS_CALLS = 6  # time_fn's warm-up and five timed calls
# A batch is the kernel's search plus the root's h/f, ~620 small PyTorch ops of host work before the launch: 6-14 ms
# on the card's host, 1.08-1.43x the kernel at 256 x 100. A fallback to the plain search would be 60x or more.
MCTS_MAX_RATIO = 2.0
PLAIN_SIMS = 16  # the plain search's simulations in its benchmark (the kernel's runs take the preset's 100)
SCALING_REPLICAS = 4
SCALING_STEPS = 16  # the sharded rollout's steps (the script's default, 64, takes ~27 s of launches over 3 meshes)
OVERLAP_STEPS = 10
WARM_ARMS = {"scalar60k": "whole_search", "cat60k": "whole_search_categorical"}  # arm: the library it must load


def learner_step_flops(config) -> int:
    """FLOP of the dense products of one ``train_step`` (scalar heads, oracle
    chance targets, no consistency loss), 2 per multiply-add: forward and
    backward through h, K + 1 f, K φ, ψ and g (every layer's weight gradient;
    no input gradient for the layers fed the observations, the action
    one-hots or the oracle's chance codes), and the fresh priorities' forward
    h and f."""
    if (config.value_bins, config.reward_bins, config.chance_target_mode) != (1, 1, "oracle") or (
        config.consistency_loss_weight
    ):
        raise ValueError("learner_step_flops counts scalar heads, oracle chance targets and no consistency loss")
    b, k, h, nb = config.batch_size, config.num_unroll_steps, config.hidden_size, config.num_residual_blocks
    a, c, d = config.action_size, config.codebook_size, config.observation_dim
    tower = 2 * nb * h * h  # multiply-adds a row of a residual tower
    f_macs = h * h + tower + h * a + h  # f: projection, tower, policy and value heads
    trained = b * (d * h * 2 + (tower + h * h) * 3)  # h: its first layer forms no input gradient
    trained += (k + 1) * b * f_macs * 3
    trained += k * b * ((3 * h * h + tower) * 3 + a * h * 2)  # φ: state fuse, tower's projection and tower, head
    trained += k * b * ((h * h + tower + h * c + h) * 3)  # ψ
    trained += k * b * ((3 * h * h + tower + h) * 3 + c * h * 2)  # g
    priorities = b * (d * h + tower + h * h + f_macs)  # h and f, forward
    return 2 * (trained + priorities)


def run_entry_points(runs: dict[str, list[str]]) -> dict[str, tuple[str, str]]:
    """``python -m simulate_2048_tpu_torch.scripts.<name> <args>`` for each
    (name, args) of ``runs``, as processes on the card started together, each
    under ENTRY_TIMEOUT (all killed past it); fails the run on a non-zero
    exit. Returns each one's standard output and standard error."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    procs = {
        name: subprocess.Popen([sys.executable, "-m", f"simulate_2048_tpu_torch.scripts.{name}", *args], cwd=root,
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in runs.items()
    }  # fmt: skip
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        waits = {name: pool.submit(proc.communicate, timeout=ENTRY_TIMEOUT) for name, proc in procs.items()}
        outputs, late = {}, []
        for name, wait in waits.items():
            try:
                outputs[name] = wait.result()
            except subprocess.TimeoutExpired:
                late.append(name)
                for proc in procs.values():
                    proc.kill()
    if late:
        fail(f"{' and '.join(f'{n} {chr(32).join(runs[n])}' for n in late)}: no exit within {ENTRY_TIMEOUT} s")
    for name, proc in procs.items():
        if proc.returncode != 0:
            print("\n".join(outputs[name][1].strip().splitlines()[-30:]))
            fail(f"{name} {' '.join(runs[name])}: exit code {proc.returncode}")
    return outputs


def run_entry_point(name: str, args: list[str]) -> str:
    """One entry point through ``run_entry_points``: its standard output."""
    return run_entry_points({name: args})[name][0]


def drive_entry_points() -> dict[str, float]:
    """The measurement entry points (``simulate_2048_tpu_torch.scripts``),
    each as a process on the card, through the flags a user gives them:

    - ``benchmark_mcts --pallas`` at the full preset (256 boards, 100
      simulations, depth cap 32) once per library (``MCTS_RUNS``): the line
      must name the library and count its six launches and no other (no
      fallback), and its ``search_ms_per_batch`` lie between the kernel's own
      time at 256 searches from the check phase and ``MCTS_MAX_RATIO`` times
      it; then the plain search at ``PLAIN_SIMS`` simulations, no launch;
    - ``benchmark_training --mode full --steps 5 --dtype both``:
      ``flops_per_step`` equal to ``learner_step_flops`` at the preset in
      both dtypes;
    - ``verify_parity`` at its defaults: ``PARITY OK``;
    - ``benchmark_scaling --virtual 4 --steps 16``: one ring launch per
      data-parallel step on 2 and 4 replicas of the card, none on 1.
    - ``measure_overlap``, ``multihost_demo`` and ``warm_compile``
      (``drive_host_entry_points``).

    No library is rebuilt (the ``build/kernels`` listing is unchanged).
    Prints each script's numbers beside the card's name and power limit.
    Returns the searches/s by library (and ``plain``)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the scripts' own
    built = sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir())
    card = card_line()
    rates = {}
    for library, flags in MCTS_RUNS.items():
        r = json.loads(run_entry_point("benchmark_mcts", [*MCTS_FLAGS, "--sims", "100", "--pallas", *flags]))
        kernel_ms = KERNEL_TIMES[library][BATCH][0]
        print(
            f"entry points: benchmark_mcts --pallas {' '.join(flags)}: {r['backend']}, {r['launches']} launches, "
            f"{r['search_ms_per_batch']:.3f} ms a batch of {r['boards']} (the kernel alone {kernel_ms:.3f} ms, "
            f"ratio {r['search_ms_per_batch'] / kernel_ms:.3f}), {r['searches_per_s']:.1f} searches/s, "
            f"{r['simulations_per_s']:.0f} simulations/s, first call {r['compile_ms']:.1f} ms; {card}"
        )
        if r["backend"] != library or r["launches"] != {library: MCTS_CALLS}:
            fail(f"benchmark_mcts {' '.join(flags)}: ran {r['backend']} with launches {r['launches']}, not "
                 f"{MCTS_CALLS} of {library}")  # fmt: skip
        if not kernel_ms <= r["search_ms_per_batch"] <= MCTS_MAX_RATIO * kernel_ms:
            fail(f"benchmark_mcts {' '.join(flags)}: {r['search_ms_per_batch']:.3f} ms a batch, outside "
                 f"[{kernel_ms:.3f}, {MCTS_MAX_RATIO} x {kernel_ms:.3f}] ms (the kernel alone)")  # fmt: skip
        rates[library] = r["searches_per_s"]
    r = json.loads(run_entry_point("benchmark_mcts", [*MCTS_FLAGS, "--sims", str(PLAIN_SIMS)]))
    print(
        f"entry points: benchmark_mcts (plain search, {PLAIN_SIMS} simulations): {r['search_ms_per_batch']:.3f} ms a "
        f"batch of {r['boards']}, {r['searches_per_s']:.2f} searches/s, {r['simulations_per_s']:.1f} simulations/s; "
        f"{card}"
    )
    if r["backend"] != "plain" or r["launches"]:
        fail(f"benchmark_mcts (plain): ran {r['backend']} with kernel launches {r['launches']}")
    rates["plain"] = r["searches_per_s"]

    r = json.loads(run_entry_point("benchmark_training", ["--mode", "full", "--steps", "5", "--dtype", "both"]))
    want = learner_step_flops(default_config())
    for dtype in ("fp32", "bf16"):
        step = r[dtype]
        print(
            f"entry points: benchmark_training {dtype}: {step['train_step_ms']:.2f} ms a step (first "
            f"{step['train_compile_ms']:.1f}), {step['learner_steps_per_s']:.4f} steps/s, {step['samples_per_s']:.1f} "
            f"samples/s, flops_per_step {step['flops_per_step']:,} (dense products; analytic {want:,}); {r['card']}"
        )
        if step["flops_per_step"] != want:
            fail(f"benchmark_training {dtype}: flops_per_step {step['flops_per_step']:,} != the analytic {want:,}")
    print(f"entry points: benchmark_training: sample_ms {r['sample_ms']:.3f}, bf16_speedup {r['bf16_speedup']:.4f}, "
          f"tf32_matmul {r['tf32_matmul']}")  # fmt: skip

    t0 = time.perf_counter()
    out = run_entry_point("verify_parity", [])
    print("\n".join(f"entry points: verify_parity: {line}" for line in out.strip().splitlines()[-3:]))
    print(f"entry points: verify_parity: {time.perf_counter() - t0:.2f} s with start-up; {card}")
    if "PARITY OK: 256/4096 boards bitwise-identical over 128 steps" not in out:
        fail("verify_parity: no PARITY OK line")

    scaling = ["--virtual", str(SCALING_REPLICAS), "--steps", str(SCALING_STEPS)]
    results = json.loads(run_entry_point("benchmark_scaling", scaling))
    for r in results:
        print(
            f"entry points: benchmark_scaling N={r['devices']}: {r['env_steps_per_s']:.4g} env-steps/s "
            f"(efficiency {r['rollout_efficiency']:.4f}), {r['learner_samples_per_s']:.1f} samples/s (efficiency "
            f"{r['learner_efficiency']:.4f}), {r['ring_launches_per_step']} ring launches a step, replicas of one "
            f"card: {r['replicas_of_one_card']}; {card}"
        )
        if r["ring_launches_per_step"] != (r["devices"] > 1) or not r["replicas_of_one_card"]:
            fail(f"benchmark_scaling N={r['devices']}: {r['ring_launches_per_step']} ring launches a step")
    if [r["devices"] for r in results] != [1, 2, 4]:
        fail(f"benchmark_scaling {' '.join(scaling)}: mesh sizes {[r['devices'] for r in results]}")

    drive_host_entry_points(card)
    if sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir()) != built:
        fail("entry points: a kernel library was rebuilt")
    print(f"entry points: phase {time.perf_counter() - t_phase:.1f} s, no kernel rebuilt")
    return rates


def drive_host_entry_points(card: str) -> None:
    """The entry points around the learner, each as a process on the card:
    ``measure_overlap --mode tiny --steps OVERLAP_STEPS`` with self-play on
    the kernel (all three rates positive, trajectory batches streamed, the
    ``device`` platform); ``multihost_demo`` as one NCCL rank (three finite
    losses); ``warm_compile`` of ``WARM_ARMS`` (each arm one launch of its
    library)."""
    t0 = time.perf_counter()
    r = json.loads(run_entry_point("measure_overlap", ["--mode", "tiny", "--steps", str(OVERLAP_STEPS), "--set",
                                                       "search_backend=auto"]))  # fmt: skip
    rates = {k: r[k] for k in ("serial_steps_per_s", "solo_steps_per_s", "overlapped_steps_per_s")}
    print(
        f"entry points: measure_overlap --mode tiny --steps {OVERLAP_STEPS}: learner steps/s "
        + ", ".join(f"{k.removesuffix('_steps_per_s')} {v:.4f}" for k, v in rates.items())
        + f", overlap_efficiency_vs_solo {r['overlap_efficiency_vs_solo']:.4f}, speedup_vs_serial "
        f"{r['speedup_vs_serial']:.4f}, {r['trajectory_batches_streamed']} trajectory batches streamed, platform "
        f"{r['platform']}; {time.perf_counter() - t0:.1f} s with start-up; {card}"
    )
    if min(rates.values()) <= 0 or r["trajectory_batches_streamed"] <= 0 or r["platform"] != "device":
        fail(f"measure_overlap: {r}")

    t0 = time.perf_counter()
    demo = ["--num-processes", "1", "--process-id", "0", "--coordinator", f"localhost:{free_port()}"]
    out = run_entry_point("multihost_demo", demo)
    losses = [float(x) for x in re.findall(r"^process 0 step \d+: loss (\S+)$", out, re.M)]
    print(f"entry points: multihost_demo {' '.join(demo)} (NCCL, one rank on the card): losses "
          f"{' '.join(f'{x:.6f}' for x in losses)}; {time.perf_counter() - t0:.1f} s with start-up")  # fmt: skip
    if "process 0/1: 1 local / 1 global devices" not in out or len(losses) != 3:
        fail(f"multihost_demo: {out}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"multihost_demo: losses {losses}")

    t0 = time.perf_counter()
    out = run_entry_point("warm_compile", list(WARM_ARMS))
    print("\n".join(f"entry points: warm_compile: {line}" for line in out.strip().splitlines()))
    print(f"entry points: warm_compile {' '.join(WARM_ARMS)}: {time.perf_counter() - t0:.1f} s with start-up; {card}")
    for arm, library in WARM_ARMS.items():
        if not re.search(rf"^\[{arm}\] {library}: .* launches \{{'{library}': 1\}}$", out, re.M):
            fail(f"warm_compile: arm {arm} did not launch {library} once")


VARIANT_SEARCHES = {  # the plain search's variants: SearchConfig overrides
    "PUCT (xla)": {},
    "Gumbel root": dict(root_selection="gumbel"),
    "sampled chance": dict(chance_selection="sample"),
    "argmax + widening": dict(pw_c=1.0),
}
VARIANT_SEGMENT_MOVES = 4
VARIANT_STEPS = 2
VARIANT_REANALYZE_EPISODES = reanalyze.SEARCH_BATCH // VARIANT_SEGMENT_MOVES  # one batch of 1,024 searches


def check_variant_searches(device, kernel_ms: float) -> dict[str, float]:
    """The plain search's variants on the card. At the paper preset (H=256,
    10 blocks, 100 simulations, depth cap 32, 256/128 bins, 256 searches):
    each variant's ms per call (CUDA events, median of 3 calls, the first of
    them the one checked) beside the kernel's PUCT time ``kernel_ms``, and
    the exact invariants. At H=64, 2 blocks, 16 simulations, 256 searches:
    each variant on CUDA and on the CPU from the same roots and the same
    draws (root Gumbel (B, A), chance Gumbel (B, S, S + 1, K)): visit counts
    identical in >= 99% of the searches (each differing one printed), the
    invariants on both, the CUDA run timed by ``utils.profiling.time_fn``.
    Returns the full-width ms."""
    _, cfg, network, _, roots = full_width_inputs(device, 256, 128)
    s, b = cfg.num_simulations, roots[0].shape[0]
    times = {}
    for name, overrides in VARIANT_SEARCHES.items():
        vcfg = cfg._replace(**overrides)
        transitions = mcts.network_transitions(network, vcfg)
        gen = torch.Generator(device=device).manual_seed(SEED)
        gumbel = mcts.draw_root_noise(vcfg, b, gen, device)  # None under the PUCT root (no Dirichlet noise here)
        with torch.no_grad():
            calls = [timed_once(lambda: mcts.search_tree(*roots, vcfg, transitions, gumbel, generator=gen))
                     for _ in range(3)]  # fmt: skip
            check_exact_invariants(f"plain search, {name}", calls[0][0], roots[1], s, b)
            times[name] = statistics.median(ms for _, ms in calls)
        print(f"plain search, {name}: {times[name]:.2f} ms per call of {b} searches x {s} simulations at "
              f"H={network.hidden_size}, NB={network.num_blocks}, bins 256/128, depth cap "
              f"{cfg.max_depth} (the kernel, PUCT: {kernel_ms:.2f} ms)")  # fmt: skip

    config = dataclasses.replace(tiny_config(), num_simulations=16)
    cpu_net = network_from_config(config, tfrng.prng_key(SEED), "cpu")
    gpu_net = copy.deepcopy(cpu_net).to(device)
    gen = torch.Generator().manual_seed(SEED)
    state = envlib.reset_batch(SEED, BATCH, "cpu")
    for t in range(30):
        state, _, _, _ = envlib.step(state, torch.randint(0, 4, (BATCH,), generator=gen))
    obs, invalid = envlib.get_observation(state), ~envlib.get_legal_actions(state)
    invalid[invalid.all(-1)] = False
    base = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
    k = max(base.num_actions, base.codebook_size)
    gumbel = mcts.gumbel_draws((BATCH, base.num_actions), gen, "cpu")
    chance = mcts.gumbel_draws((BATCH, base.num_simulations, base.num_simulations + 1, k), gen, "cpu")
    variants = {**{n: o for n, o in VARIANT_SEARCHES.items() if o}, "all three": dict(
        root_selection="gumbel", chance_selection="sample", pw_c=1.0)}  # fmt: skip
    prior = torch.nn.functional.pad((~invalid).float(), (0, k - base.num_actions))  # zero where the root masks
    for name, overrides in variants.items():
        vcfg = base._replace(**overrides)
        cpu = mcts.batched_run_mcts(cpu_net, obs, vcfg, invalid, gumbel, chance)
        gpu_args = (gpu_net, obs.to(device), vcfg, invalid.to(device), gumbel.to(device), chance.to(device))
        gpu = type(cpu)(*(x.cpu() for x in mcts.batched_run_mcts(*gpu_args)))
        stats = time_fn(lambda: mcts.batched_run_mcts(*gpu_args), warmup=1, reps=3)
        for label, o in (("CPU", cpu), ("CUDA", gpu)):
            check_exact_invariants(f"H=64 {name} ({label})", (o.visit_counts, o.qvalues, o.search_value), prior,
                                   vcfg.num_simulations, BATCH)  # fmt: skip
        differ = (cpu.visit_counts != gpu.visit_counts).any(-1)
        for i in differ.nonzero().flatten().tolist():
            print(f"  search {i} differs: CUDA {gpu.visit_counts[i].tolist()} CPU {cpu.visit_counts[i].tolist()}; "
                  f"root Q CUDA {gpu.qvalues[i].tolist()} CPU {cpu.qvalues[i].tolist()}")  # fmt: skip
        n_same = BATCH - int(differ.sum())
        same = ~differ
        err = float((gpu.search_value[same] - cpu.search_value[same]).abs().max())
        print(f"plain search, {name} at H=64, NB=2, S=16, {BATCH} searches, fed draws: CUDA vs CPU {n_same}/{BATCH} "
              f"with identical visit counts, max |root value difference| {err:.3g}; CUDA {stats['median_ms']:.2f} ms "
              f"per call (time_fn median of 3)")  # fmt: skip
        if n_same < BATCH - BATCH // 100:
            fail(f"plain search, {name}: CUDA and CPU disagree in {BATCH - n_same} of {BATCH} searches")
    return times


def variant_config():
    """The training recipe's widths (``training_config()``) with the three
    search variants, backend "auto"; depth cut: two 4-move segments of 256
    games, two learner steps, one search-mode reanalyze pass of 1,024
    searches, one 4-move evaluation and one 4-move deep evaluation of 128
    games."""
    return dataclasses.replace(
        training_config(),
        root_selection="gumbel",
        chance_selection="sample",
        pw_c=1.0,
        search_backend="auto",
        max_trajectory_length=VARIANT_SEGMENT_MOVES,
        min_buffer_size=BATCH,
        replay_buffer_size=4 * BATCH,
        generation_interval=VARIANT_STEPS,
        checkpoint_interval=VARIANT_STEPS,
        eval_interval=VARIANT_STEPS,
        eval_max_moves=VARIANT_SEGMENT_MOVES,
        reanalyze_interval=VARIANT_STEPS - 1,
        reanalyze_episodes=VARIANT_REANALYZE_EPISODES,
        deep_eval_interval=VARIANT_STEPS,
        deep_eval_games=DEEP_EVAL_GAMES,
    )


def drive_variant_path(device) -> int:
    """The variant path through ``train_muzero``: every collection and
    reanalyze search, and the evaluation's and deep evaluation's too (their
    root turns to PUCT, their sampled chance selection and widening stay, as
    in the JAX package), run the plain search, so no kernel launches. The
    deep evaluation seeds its games from a generator on the CPU, as the
    ``evaluate`` CLI does, while the games run on the card. Then the same
    network's evaluation under the Gumbel root alone, whose PUCT evaluation
    search the kernel takes: one ``whole_search_categorical`` launch per
    move. Returns that evaluation's launches."""
    config = variant_config()
    eval_cfg = search_config_from(config, eval_mode=True)._replace(dirichlet_fraction=0.0)
    if _use_kernel(config, search_config_from(config), device) or _use_kernel(config, eval_cfg, device):
        fail("variant path: the dispatch sends a variant search to the kernel")
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train_muzero(config, num_steps=VARIANT_STEPS, seed=SEED, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    if sum(launches.values()):
        fail(f"variant path: kernel launches {launches} where every search is the plain search's")

    history = trainer.get_metrics_history()
    gens = [r for r in history if "gen/positions" in r]
    steps = [r for r in history if "total_loss" in r]
    evals = [r for r in history if "eval/mean_reward" in r]
    passes = [r for r in history if "reanalyze/seconds" in r]
    deeps = [r for r in history if "deep_eval/mean_reward" in r]
    if len(gens) + fill_segments(config) != 2 or len(steps) != VARIANT_STEPS or len(evals) != 1 or len(passes) != 1 \
            or len(deeps) != 1:
        fail(f"variant path: {len(gens)} segments, {len(steps)} steps, {len(evals)} evaluations, {len(passes)} "
             f"passes, {len(deeps)} deep evaluations")  # fmt: skip
    if not (deeps[0]["deep_eval/mean_length"] > 0 and math.isfinite(deeps[0]["deep_eval/mean_search_value"])):
        fail(f"variant path: the deep evaluation played no move or its search values are not finite: {deeps[0]}")
    loss_terms = [k for k in steps[0] if k.endswith("_loss") or k == "codebook_entropy"]
    if not all(torch.isfinite(torch.tensor([r[k] for k in loss_terms])).all() for r in steps):
        fail("variant path: a loss term is not finite")
    initial = network_from_config(config, tfrng.prng_key(SEED), device)
    changed = sum(not torch.equal(a, b) for a, b in zip(initial.parameters(), trainer.state.params))
    if changed < len(trainer.state.params) // 2:
        fail(f"variant path: only {changed} of {len(trainer.state.params)} parameter tensors changed")

    # Stored policy targets (the improved policy, reanalysed or as collected): sum 1, positive on every legal action.
    buffer = trainer.buffer
    rows = slice(0, int(buffer.size))
    t = VARIANT_SEGMENT_MOVES
    in_ep = torch.arange(t, device=device)[None] < buffer.length[rows, None]
    policies = buffer.policies[rows].float()
    legal = board_ops.legal_actions_mask(buffer.boards[rows, :t].reshape(-1, t, 4, 4).to(torch.int32))
    if not torch.allclose(policies.sum(-1), in_ep.float(), atol=2e-3):  # float16 probabilities
        fail("variant path: stored policy targets do not sum to 1 inside the episodes and 0 outside")
    if not (policies[legal & in_ep[..., None]] > 0).all():
        fail("variant path: a stored policy target is zero on a legal action")

    moves = len(gens) * t
    gen_s = sum(r["gen/seconds"] for r in gens)
    searches = min(VARIANT_REANALYZE_EPISODES, int(buffer.size)) * t
    print(
        f"variant path (Gumbel root, sampled chance, widening pw_c=1.0; H={config.hidden_size}, "
        f"NB={config.num_residual_blocks}, S={config.num_simulations}, bins 256/128, backend auto): {len(gens)} "
        f"logged segments of {t} moves x {BATCH} games in {gen_s:.2f} s: {1e3 * gen_s / moves:.1f} ms per self-play move "
        f"(plain search); one search-mode reanalyze pass of {searches} searches in "
        f"{passes[0]['reanalyze/seconds']:.3f} s; one deep evaluation of {DEEP_EVAL_GAMES} games x {t} moves "
        f"(games seeded on the CPU) in {deeps[0]['deep_eval/seconds']:.3f} s; {len(steps)} learner steps; whole run "
        f"{wall:.1f} s; launches "
        f"{launches}; {changed}/{len(trainer.state.params)} parameter tensors changed"
    )
    print("variant path: last step " + " ".join(f"{k}={steps[-1][k]:.4f}" for k in loss_terms))

    gumbel_only = dataclasses.replace(config, chance_selection="argmax", pw_c=None)
    for name in sk.LAUNCHES:
        sk.LAUNCHES[name] = 0
    stats = evaluate_games(trainer.network, torch.Generator().manual_seed(SEED + 3), gumbel_only, BATCH,
                           include_per_game=True)  # fmt: skip
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    moves_played = max(stats["per_game_lengths"])
    if launches["whole_search_categorical"] != moves_played or sum(launches.values()) != moves_played:
        fail(f"variant path: the Gumbel-root config's evaluation launched {launches} for {moves_played} moves")
    print(f"variant path: evaluation under the Gumbel root alone (PUCT evaluation search): {moves_played} moves, "
          f"{launches['whole_search_categorical']} whole_search_categorical launches")  # fmt: skip
    return launches["whole_search_categorical"]


def profile_device(label: str, fn, units: int, unit: str) -> float:
    """torch.profiler over ``fn()`` (which does ``units`` ``unit``s of work):
    device time by kernel and the device's idle share. Returns the device's
    busy time in ms: the union of the intervals of its activity, so that
    overlapping kernels count once."""
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
    busy_us = union_ns([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA]) / 1e3  # fmt: skip
    calls = sum(e.count for e in events)
    plural = unit + ("es" if unit.endswith("s") else "s")
    print(f"profile {label}: {units} {plural}, wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"(union of device intervals), idle share {max(0.0, 1 - busy_us / wall_us):.3f}, "
          f"{calls / units:.1f} device kernels per {unit}")
    for e in events[:12]:
        print(f"profile {label}:   {e.self_device_time_total / 1e3 / units:9.3f} ms/{unit}  "
              f"{e.count // units:5d} calls/{unit}  {e.key[:90]}")
    return busy_us / 1e3


def profile_paths(device, moves: int = 5, steps: int = 3) -> None:
    """Profiles of 20 ``bench`` repetitions, a few evaluation moves, self-play moves and learner steps at full width."""
    reps = 20
    profile_device(
        "rollout",
        lambda: [bench.gpu_repetition(SEED, ROLLOUT_BOARDS, ROLLOUT_STEPS, device) for _ in range(reps)],
        reps,
        "repetition",
    )
    config = dataclasses.replace(default_config(), eval_max_moves=moves)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
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

    def one_pass():
        reanalyze.reanalyze_pass(trainer.buffer, trainer.network, 0, train_config, gen)

    profile_device("reanalyze", one_pass, 1, "pass")

    # The whole-search kernel's rate against the searches in one launch (reanalyze.SEARCH_BATCH is one of them).
    _, cfg, network, packed, roots = full_width_inputs(device, 256, 128)

    # The plain search under the Gumbel root, as a variant config's collection runs it: kernels and idle share,
    # over 25 simulations (the profiler keeps every one of the ~10^5 launches).
    gumbel_cfg = cfg._replace(root_selection="gumbel", num_simulations=25)
    transitions = mcts.network_transitions(network, gumbel_cfg)
    gumbel = mcts.draw_root_noise(gumbel_cfg, roots[0].shape[0], torch.Generator(device=device).manual_seed(SEED),
                                  device)  # fmt: skip
    with torch.no_grad():
        busy_ms = profile_device("plain search (Gumbel root)",
                                 lambda: mcts.search_tree(*roots, gumbel_cfg, transitions, gumbel),
                                 gumbel_cfg.num_simulations, "simulation")  # fmt: skip
        wall_ms = cuda_ms(lambda: mcts.search_tree(*roots, gumbel_cfg, transitions, gumbel), reps=3, warmup=0)
    print(f"profile plain search (Gumbel root) without the profiler: {wall_ms:.2f} ms a call (CUDA events, median "
          f"of 3), {wall_ms / gumbel_cfg.num_simulations:.2f} ms a simulation; idle share against the profiled "
          f"device time {max(0.0, 1 - busy_ms / wall_ms):.3f}")  # fmt: skip
    for copies in (1, 2, 4, 8):
        many = tuple(r.repeat(copies, *[1] * (r.dim() - 1)).contiguous() for r in roots)
        ms = cuda_ms(lambda: sk.whole_search(*many, packed, cfg), reps=3)
        n = copies * BATCH
        print(f"profile search batch: {n} searches per launch {ms:.2f} ms, {n / ms * 1e3:.0f} searches/s")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true", help="also profile a few moves and learner steps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    seconds = _build.build_all()
    ptxas = {}
    for name in seconds:
        if name != "ring_all_reduce":
            print(_build.build_log(name))
        if name.startswith("whole_search"):
            ptxas[name] = whole_search_ptxas(name, _build.build_log(name))
            print(ptxas[name])
    for name in TENSOR_CORE_LIBRARIES:
        hmma = count_hmma(name)
        print(f"{name}: {hmma} HMMA instructions in its machine code (cuobjdump -sass)")
        if hmma == 0:
            fail(f"{name}: no tensor-core instruction in its machine code")
    check_ring_ptxas(_build.build_log("ring_all_reduce"))
    print(json.dumps({"kernels_built": list(seconds), "build_s": round(time.perf_counter() - t0, 3)}))

    kernels = {
        "whole_search": check_whole_search(device),
        "whole_search_categorical": check_whole_search(
            device, "whole_search_categorical", 256, 128, TRAIN_SEARCH_BATCHES
        ),
        "random_rollout": check_random_rollout(device),
        "whole_search_bf16": check_whole_search(
            device, "whole_search_bf16", 256, 128, (BATCH, reanalyze.SEARCH_BATCH), weight_dtype=torch.bfloat16
        ),
        "whole_search_bf16_streamed": check_whole_search(
            device, "whole_search_bf16_streamed", 256, 128, WIDE_SEARCH_BATCHES, WIDE_HIDDEN, torch.bfloat16,
            sk.STREAM_CHUNK,
        ),  # fmt: skip
    }
    kernels["ring_all_reduce"] = check_ring_all_reduce(device)
    check_rollout_board_ops(device)
    check_whole_search(device, "whole_search_streamed", 256, 128, hidden=WIDE_HIDDEN, stream_chunk=sk.STREAM_CHUNK)
    for library in TENSOR_CORE_LIBRARIES:
        check_dense_probe(device, library)
    # A bfloat16 width that is no power of two: the plan keeps it resident, on the tensor cores.
    if sk.search_plan(search_config_from(default_config()), 96, torch.bfloat16) != 0:
        fail("the search plan does not keep a bfloat16 pack of H=96 resident")
    check_whole_search(device, "whole_search_bf16 (H=96)", 256, 128, (BATCH,), 96, torch.bfloat16)
    check_streamed_equals_resident(device)
    check_small_evaluation(device)
    check_small_training(device)
    check_self_play_draws(device)

    # ---- rollout path: the benchmark's entry point on the card
    kernels["random_rollout"]["launches"] = drive_rollout_path()

    # ---- evaluation path: greedy evaluation at the full preset on the card
    config = dataclasses.replace(default_config(), eval_max_moves=MAIN_PATH_MAX_MOVES)
    network = network_from_config(config, tfrng.prng_key(SEED), device)
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

    # ---- training path: self-play, replay, learner, reanalyze, checkpoint, evaluation, deep evaluation at full width
    kernels["whole_search_categorical"]["launches"] = drive_training(device)["whole_search_categorical"]

    # ---- recipe path: the champion recipe at its own widths, its move under both backends, a cut run, a trace
    kernels["whole_search_categorical (recipe)"], recipe_ckpt = drive_recipe_path(device)

    # ---- diagnosis path: the prior ablations on the kernel, then the four diagnoses on the cut run's checkpoint
    kernels.update(drive_diagnosis_path(device, recipe_ckpt))

    # ---- actor/learner path: the learner and an actor as two processes on the card, through the entry point
    drive_actor_learner(device)

    # ---- probe evaluation path: the full-capacity probe's recipe at H=256, bfloat16 search packs resident
    kernels["whole_search_bf16"]["launches"] = drive_probe_evaluation(device, ptxas["whole_search_bf16"])

    # ---- wide path: the same recipe at hidden 512, bfloat16 search packs streamed
    kernels["whole_search_bf16_streamed"]["launches"] = drive_wide_training(device)["whole_search_bf16_streamed"]

    # ---- data-parallel path: the learner over a virtual mesh of the card, its gradients summed by the ring kernel
    kernels["ring_all_reduce"]["launches"] = drive_dp_training(device, kernels["ring_all_reduce"]["ms"])

    # ---- measurement entry points: the four scripts as processes on the card
    drive_entry_points()

    # ---- the search variants: the plain search at full width, CUDA against the CPU at H=64
    check_variant_searches(device, kernels["whole_search_categorical"]["ms"])

    # ---- variant path: the three variants through the trainer
    drive_variant_path(device)

    if args.profile:
        profile_paths(device)

    print(json.dumps({"kernels": list(kernels.values())}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))


if __name__ == "__main__":
    main()

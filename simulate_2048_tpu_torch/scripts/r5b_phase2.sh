#!/bin/bash
# Phase 2 of the round-5b queue (scripts/r5b_phase2.sh) for the port: once
# the main queue's process (r5b_queue.sh) has exited, run in order
#   0. the port's bench once,
#   1. the early-anneal 60k arm (run_temp_early_arm.sh) to step 60,000,
#      relaunched while it exits early,
#   2. the Gumbel resumed A/B (run_gumbel_resumed_ab.sh, 3 x 6,000 steps off
#      the port's cat60k checkpoint).
# Usage: r5b_phase2.sh <main_queue_pid>
# Departures: the newest step is read from the port's step_<n>.pt files
# (latest_step.sh); the bench is python -m simulate_2048_tpu_torch.bench;
# the runs and logs are the port's runs/torch_*.
cd "$(dirname "$0")/../.." || exit 1
source simulate_2048_tpu_torch/scripts/latest_step.sh
S=simulate_2048_tpu_torch/scripts
PID="$1"
mkdir -p runs
while kill -0 "$PID" 2>/dev/null; do sleep 30; done
echo "$(date +%T) phase 2: bench" >> runs/torch_r5b_queue.log
python -m simulate_2048_tpu_torch.bench > runs/torch_r5b_bench_probe.json 2> runs/torch_r5b_bench_probe.log
echo "$(date +%T) phase 2: early-anneal arm" >> runs/torch_r5b_queue.log
while true; do
  step=$(latest_step runs/torch_temp_early/ckpt)
  if [ "$step" -ge 60000 ]; then break; fi
  bash $S/run_temp_early_arm.sh $(( 60010 - step )) >> runs/torch_temp_early_launch.log 2>&1
done
echo "$(date +%T) phase 2: gumbel resumed A/B" >> runs/torch_r5b_queue.log
bash $S/run_gumbel_resumed_ab.sh runs/torch_cat60k/ckpt 6000 > runs/torch_gres_launch.log 2>&1
echo "$(date +%T) phase 2 done" >> runs/torch_r5b_queue.log

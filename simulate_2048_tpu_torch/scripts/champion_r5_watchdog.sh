#!/bin/bash
# The round-5 scheduler of scripts/champion_r5_watchdog.sh for the port:
# babysit the port's champion_r5 run (run_champion_r5.sh, checkpoints in
# runs/torch_champion_r5/ckpt) to its target step, resuming on a premature
# exit with the remaining steps (the port's train adds --steps to the step
# it resumes from), then run the scalar-vs-categorical 60k arm
# (run_scalar60k_arm.sh) with no idle time between them.
# Usage: champion_r5_watchdog.sh <champion_pid> [target_step]
# Departures: the newest step is read from the port's step_<n>.pt files
# (latest_step.sh); logs go to runs/torch_champion_r5_watchdog.log,
# runs/torch_champion_r5_launch.log and runs/torch_scalar60k_launch.log.
cd "$(dirname "$0")/../.." || exit 1
source simulate_2048_tpu_torch/scripts/latest_step.sh
S=simulate_2048_tpu_torch/scripts
PID="$1"
TARGET="${2:-600000}"
mkdir -p runs
while true; do
  while kill -0 "$PID" 2>/dev/null; do sleep 60; done
  step=$(latest_step runs/torch_champion_r5/ckpt)
  echo "$(date +%T) champion process $PID exited at checkpoint step $step" >> runs/torch_champion_r5_watchdog.log
  if [ "$step" -ge "$TARGET" ]; then break; fi
  remaining=$(( TARGET + 10 - step ))
  echo "$(date +%T) resuming for $remaining more steps" >> runs/torch_champion_r5_watchdog.log
  bash $S/run_champion_r5.sh "$remaining" >> runs/torch_champion_r5_launch.log 2>&1 &
  PID=$!
done
echo "$(date +%T) champion done; starting scalar60k arm" >> runs/torch_champion_r5_watchdog.log
bash $S/run_scalar60k_arm.sh > runs/torch_scalar60k_launch.log 2>&1
echo "$(date +%T) scalar60k arm finished" >> runs/torch_champion_r5_watchdog.log

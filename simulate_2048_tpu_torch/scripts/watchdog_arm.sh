#!/bin/bash
# The arm babysitter of scripts/watchdog_arm.sh for the port's recipes: wait
# on a training PID; on a premature exit, resume through the arm's launch
# script (one of simulate_2048_tpu_torch/scripts/run_*.sh) with the remaining
# steps (the port's train adds --steps to the step it resumes from, and a
# relaunch into the same --checkpoint-dir resumes from its newest checkpoint).
# Usage: watchdog_arm.sh <pid> <ckpt_dir> <target_step> <launch_script> <log>
# Departures: the newest step is read from the port's step_<n>.pt files
# (latest_step.sh); the log is runs/torch_watchdog_arm.log.
cd "$(dirname "$0")/../.." || exit 1
source simulate_2048_tpu_torch/scripts/latest_step.sh
PID="$1"; CKPT="$2"; TARGET="$3"; SCRIPT="$4"; LOG="$5"
mkdir -p runs
while true; do
  while kill -0 "$PID" 2>/dev/null; do sleep 30; done
  step=$(latest_step "$CKPT")
  echo "$(date +%T) $SCRIPT pid $PID exited at checkpoint step $step" >> runs/torch_watchdog_arm.log
  if [ "$step" -ge "$TARGET" ]; then break; fi
  remaining=$(( TARGET + 10 - step ))
  echo "$(date +%T) resuming $SCRIPT for $remaining more steps" >> runs/torch_watchdog_arm.log
  bash "$SCRIPT" "$remaining" >> "$LOG" 2>&1 &
  PID=$!
done

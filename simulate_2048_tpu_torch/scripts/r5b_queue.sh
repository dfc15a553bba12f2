#!/bin/bash
# The round-5b queue of scripts/r5b_queue.sh for the port: run each arm to
# its target step (relaunching a run that exits early: the port's train adds
# --steps to the step it resumes from), then the decision evaluation
# (compare_scalar60k) and the categorical kernel measurements
# (measure_categorical_kernel.sh), one after another.
# Usage: r5b_queue.sh [first_arm_target]
# Departures: the newest step is read from the port's step_<n>.pt files
# (latest_step.sh); the arms are the port's recipes with their checkpoints in
# runs/torch_scalar60k/ckpt and runs/torch_cat60k/ckpt; logs go to
# runs/torch_*.log. Sourced, it only defines run_to_target.
S=simulate_2048_tpu_torch/scripts

run_to_target() { # <launch_script> <ckpt_dir> <target_step> <log>
  local script="$1" ckpt="$2" target="$3" log="$4" step remaining
  while true; do
    step=$(latest_step "$ckpt")
    if [ "$step" -ge "$target" ]; then break; fi
    remaining=$(( target + 10 - step ))
    echo "$(date +%T) $script -> $remaining more steps (at $step/$target)" >> runs/torch_r5b_queue.log
    bash "$script" "$remaining" >> "$log" 2>&1
  done
  echo "$(date +%T) $script reached $target" >> runs/torch_r5b_queue.log
}

source "$(dirname "${BASH_SOURCE[0]}")/latest_step.sh"

if [[ "${BASH_SOURCE[0]}" == "$0" ]]; then
  cd "$(dirname "$0")/../.." || exit 1
  mkdir -p runs
  Q=runs/torch_r5b_queue.log
  run_to_target $S/run_scalar60k_arm.sh runs/torch_scalar60k/ckpt "${1:-60000}" runs/torch_scalar60k_launch.log
  run_to_target $S/run_cat60k_twin.sh runs/torch_cat60k/ckpt 60000 runs/torch_cat60k_launch.log
  echo "$(date +%T) decision eval" >> $Q
  python -m simulate_2048_tpu_torch.scripts.compare_scalar60k > runs/torch_scalar_vs_cat_eval.log 2>&1
  echo "$(date +%T) decision eval done; kernel measurements" >> $Q
  bash $S/measure_categorical_kernel.sh > runs/torch_cat_kernel_measurements.log 2>&1
  echo "$(date +%T) kernel measurements done" >> $Q
fi

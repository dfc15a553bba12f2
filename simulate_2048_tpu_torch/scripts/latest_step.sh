#!/bin/bash
# The newest step a port checkpoint directory holds: the largest <n> of its
# step_<n>.pt files (training/checkpoint.py), 0 when it holds none or does not
# exist. The JAX shells read orbax step directories (ls | grep -E '^[0-9]+$');
# the port writes files. Source it for latest_step, or run it:
#   latest_step.sh <checkpoint_dir>
latest_step() {  # <checkpoint_dir>
  local step
  step=$(ls "$1" 2>/dev/null | sed -nE 's/^step_([0-9]+)\.pt$/\1/p' | sort -n | tail -1)
  echo "${step:-0}"
}

if [[ "${BASH_SOURCE[0]}" == "$0" ]]; then
  latest_step "$1"
fi

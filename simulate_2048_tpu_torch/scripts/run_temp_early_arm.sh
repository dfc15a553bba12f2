#!/bin/bash
# The early-annealing arm of scripts/run_temp_early_arm.sh on the GPU through
# the port's train CLI: the categorical 60k twin (run_cat60k_twin.sh) with
# collection temperature 1.0 -> 0.5 at 20,000 steps and -> 0.1 at 40,000;
# the same flags and --set overrides, plus --device cuda. Usage:
# run_temp_early_arm.sh [STEPS] [train flags...] (STEPS defaults to 60000;
# further arguments go to train). Logs and checkpoints go to
# runs/torch_temp_early/.
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/torch_temp_early
exec python -m simulate_2048_tpu_torch.train --mode small --steps "${1:-60000}" \
  --checkpoint-dir runs/torch_temp_early/ckpt --log-dir runs/torch_temp_early \
  --set value_target_mode=td_lambda --set td_lambda=1.0 \
  --set cross_segment_backfill=True \
  --set afterstate_value_loss_weight=0.25 \
  --set value_bins=256 --set reward_bins=128 \
  --set lr_decay_steps=60000 \
  --set "temperature_schedule=[[0,1.0],[20000,0.5],[40000,0.1]]" \
  --set eval_interval=5000 --set checkpoint_interval=10000 \
  --set deep_eval_interval=30000 --set deep_eval_games=128 \
  --set eval_prior_temperature=4.0 --set eval_pb_c_init=0.5 \
  --device cuda "${@:2}"

#!/bin/bash
# The full-capacity probe of scripts/run_full_capacity_probe.sh on the GPU
# through the port's train CLI: the paper-full preset (256 x 10, 100
# simulations, bf16 towers) on the annealed champion recipe with bf16
# search packs; the same flags and --set overrides, plus --device cuda.
# Usage: run_full_capacity_probe.sh [STEPS] [train flags...] (STEPS defaults
# to 100000; further arguments go to train). Logs and checkpoints go to
# runs/torch_full_probe/.
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/torch_full_probe
exec python -m simulate_2048_tpu_torch.train --mode full --steps "${1:-100000}" \
  --checkpoint-dir runs/torch_full_probe/ckpt --log-dir runs/torch_full_probe \
  --set value_target_mode=td_lambda --set td_lambda=1.0 \
  --set cross_segment_backfill=True \
  --set afterstate_value_loss_weight=0.25 \
  --set value_bins=256 --set reward_bins=128 \
  --set search_weight_dtype=bfloat16 \
  --set lr_decay_steps=300000 \
  --set eval_interval=5000 --set checkpoint_interval=10000 \
  --set deep_eval_interval=25000 --set deep_eval_games=128 \
  --set eval_prior_temperature=4.0 --set eval_pb_c_init=0.5 \
  --set reanalyze_interval=500 --set reanalyze_episodes=64 \
  --set reanalyze_mode=search \
  --device cuda "${@:2}"

#!/bin/bash
# The round-5 champion recipe of scripts/run_champion_r5.sh on the GPU
# through the port's train CLI: resume the port's round-4 champion
# (runs/torch_champion_r4/ckpt, written by run_champion_r4.sh; the JAX
# package's orbax checkpoints do not load in the port) in a copy,
# runs/torch_champion_r5, without its in-run best, and train through the
# fully greedy phase with the same flags and --set overrides, plus --device
# cuda. Usage: run_champion_r5.sh [STEPS] [train flags...] (STEPS defaults to
# 326000; further arguments go to train).
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/torch_champion_r5
if [ ! -d runs/torch_champion_r5/ckpt ]; then
  cp -r runs/torch_champion_r4/ckpt runs/torch_champion_r5/ckpt
  # The in-run best is re-established under the seed-matched protocol.
  rm -rf runs/torch_champion_r5/ckpt/best runs/torch_champion_r5/ckpt/deep_eval_best.json
fi
exec python -m simulate_2048_tpu_torch.train --mode small --steps "${1:-326000}" \
  --checkpoint-dir runs/torch_champion_r5/ckpt --log-dir runs/torch_champion_r5 \
  --set value_target_mode=td_lambda --set td_lambda=1.0 \
  --set cross_segment_backfill=True \
  --set afterstate_value_loss_weight=0.25 \
  --set value_bins=256 --set reward_bins=128 \
  --set lr_decay_steps=300000 \
  --set eval_interval=5000 --set checkpoint_interval=10000 \
  --set deep_eval_interval=25000 --set deep_eval_games=128 \
  --set eval_prior_temperature=4.0 --set eval_pb_c_init=0.5 \
  --set reanalyze_interval=500 --set reanalyze_episodes=64 \
  --set reanalyze_mode=search \
  --device cuda "${@:2}"

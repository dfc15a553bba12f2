#!/bin/bash
# The round-4 champion recipe of scripts/run_champion_r4.sh on the GPU through
# the port's train CLI: the same flags and --set overrides (300,000 steps,
# rotating 10k-segment buffer, search-mode reanalyze every 500 steps, cosine
# LR over the run, 128-game deep evaluations every 25,000 steps), plus
# --device cuda. Usage: run_champion_r4.sh [train flags...] (forwarded to
# train; later flags win, e.g. --steps 5000 or --set search_backend=auto).
# Logs and checkpoints go to runs/torch_champion_r4/.
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/torch_champion_r4
exec python -m simulate_2048_tpu_torch.train --mode small --steps 300000 \
  --checkpoint-dir runs/torch_champion_r4/ckpt --log-dir runs/torch_champion_r4 \
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
  --device cuda "$@"

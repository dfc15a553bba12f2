#!/bin/bash
# The resumed Gumbel A/B of scripts/run_gumbel_resumed_ab.sh on the GPU
# through the port's train CLI: three arms resumed from the same checkpoint
# directory of the port ($1, default runs/torch_cat60k/ckpt), each in a copy
# without its in-run best, for $2 steps (default 6000): puct (the recipe as
# it is), gumbel (root_selection=gumbel) and gumbel03 (gumbel_c_scale=0.03);
# reanalyze off in all three. The same flags and --set overrides, plus
# --device cuda; further arguments ($3 on) go to every train call. Logs and
# checkpoints go to runs/torch_gres_<arm>/.
cd "$(dirname "$0")/../.." || exit 1
SRC="${1:-runs/torch_cat60k/ckpt}"
STEPS="${2:-6000}"
for arm in puct gumbel gumbel03; do
  dir="runs/torch_gres_${arm}"
  mkdir -p "$dir"
  if [ ! -d "$dir/ckpt" ]; then
    cp -r "$SRC" "$dir/ckpt"
    rm -rf "$dir/ckpt/best" "$dir/ckpt/deep_eval_best.json"
  fi
  extra=()
  case "$arm" in
    gumbel)   extra=(--set root_selection=gumbel) ;;
    gumbel03) extra=(--set root_selection=gumbel --set gumbel_c_scale=0.03) ;;
  esac
  python -m simulate_2048_tpu_torch.train --mode small --steps "$STEPS" \
    --checkpoint-dir "$dir/ckpt" --log-dir "$dir" \
    --set value_target_mode=td_lambda --set td_lambda=1.0 \
    --set cross_segment_backfill=True \
    --set afterstate_value_loss_weight=0.25 \
    --set value_bins=256 --set reward_bins=128 \
    --set lr_decay_steps=60000 \
    --set eval_interval=2000 --set checkpoint_interval=10000 \
    --set deep_eval_interval="$STEPS" --set deep_eval_games=128 \
    --set eval_prior_temperature=4.0 --set eval_pb_c_init=0.5 \
    "${extra[@]}" --device cuda "${@:3}" || exit 1
done

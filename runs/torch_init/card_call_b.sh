#!/bin/bash
# The categorical twin (run_cat60k_twin.sh) to 10,000 steps on one GPU at the default seed 42, whose initial
# weights are now the JAX package's of seed 42 (the init of runs/r5_cat60k), alone on the card. Usage, from
# the repository root on a machine with one GPU: copy this script into chip_stage/ (runs/ is in
# .chiprunignore) and run `bash chip_stage/card_call_b.sh OUT [STEPS] [LIMIT_S]`. The checkpoints go to
# chip_stage/ckpt_b/, outside OUT. The run gets SIGINT after LIMIT_S seconds (default 3300), so that train
# saves a checkpoint; if it stopped short, the checkpoint directory is copied to OUT/resume_ckpt. To go on,
# copy that directory to chip_stage/ckpt_b/cat_seed42 and call again with the steps left: train adds STEPS
# to the step it resumes from.
cd "$(dirname "$0")/.." || exit 1
O="${1:?usage: card_call_b.sh OUT [STEPS] [LIMIT_S]}"
C=chip_stage/ckpt_b/cat_seed42
mkdir -p "$O/cat_seed42" "$C"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
export PYTHONPATH=.
s=$(date +%s)
timeout -s INT "${3:-3300}" bash simulate_2048_tpu_torch/scripts/run_cat60k_twin.sh "${2:-10000}" \
  --set search_backend=auto --checkpoint-dir "$C" --log-dir "$O/cat_seed42" > "$O/cat_seed42.out" 2> "$O/cat_seed42.err"
rc=$?
echo "cat_seed42 rc=$rc s=$(( $(date +%s) - s ))" | tee -a "$O/times.txt"
cp "$C/train_config.json" "$O/cat_seed42/"
[ "$rc" -ne 0 ] && cp -r "$C" "$O/resume_ckpt"
grep -H "resumed\|eval @\|final evaluation\|peak device memory" "$O/cat_seed42.out"
du -sh "$O"

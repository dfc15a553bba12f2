#!/bin/bash
# The scalar recipe to 5,000 steps on one GPU from the port's own initial weights, which are the JAX
# package's for the trainer's seed: the default seed 42 (the init of runs/r4_scalar60k) and --seed 43, 45
# and 46, four runs at once, after `python3 chip_smoke.py`. Usage, from the repository root on a machine with
# one GPU: copy this script into chip_stage/ (runs/ is in .chiprunignore) and run
# `bash chip_stage/card_call_a.sh OUT`; the cd below lands at chip_stage/.., the repository root.
# Checkpoints go to chip_stage/ckpt_a/, outside OUT.
cd "$(dirname "$0")/.." || exit 1
O="${1:?usage: card_call_a.sh OUT}"
C=chip_stage/ckpt_a
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$O/card.txt"
s=$(date +%s)
python3 chip_smoke.py > "$O/chip_smoke.out" 2>&1
echo "chip_smoke rc=$? s=$(( $(date +%s) - s ))" | tee -a "$O/times.txt"
export PYTHONPATH=.
run() {  # name, train flags
  local s=$(date +%s)
  mkdir -p "$C/$1" "$O/$1"
  bash simulate_2048_tpu_torch/scripts/run_scalar60k_arm.sh 5000 --set search_backend=auto \
    --checkpoint-dir "$C/$1" --log-dir "$O/$1" "${@:2}" > "$O/$1.out" 2> "$O/$1.err"
  echo "$1 rc=$? s=$(( $(date +%s) - s ))" >> "$O/times.txt"
  cp "$C/$1/train_config.json" "$O/$1/"
}
run seed42 &
run seed43 --seed 43 &
run seed45 --seed 45 &
run seed46 --seed 46 &
wait
cat "$O/times.txt"
tail -n 3 "$O/chip_smoke.out"
grep -H "eval @\|final evaluation\|peak device memory" "$O"/seed*.out
du -sh "$O"

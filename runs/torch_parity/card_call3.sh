#!/bin/bash
# Usage, from the repository root on a machine with one GPU: copy runs/torch_parity/*.py, this script and the
# saved inits (twin_run.py --save-init: init/, init_full/) into chip_stage/, then
# run `bash chip_stage/card_call3.sh OUT`; the cd below lands at chip_stage/.., the repository root.
# Written after the call from the script it ran, chip_stage/run3.sh, which was not kept: that one took no
# argument and wrote to a fixed output directory, where OUT is now. This form has not been run on the card.
# Diagnostic call 3: the scalar recipe on the card from the JAX package's own initial weights (converted),
# the init of runs/r4_scalar60k (JAX seed 42) under two trainer seeds, and JAX seed 0's init; the categorical
# twin at --seed 43 to 5,000.
cd "$(dirname "$0")/.." || exit 1
O="${1:?usage: card_call3.sh OUT}"
C=chip_stage/ckpt3
mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=.
python -c "from simulate_2048_tpu_torch.ops import _build; _build.build_all()" > $O/build.out 2>&1
run() {  # name, init seed, trainer seed
  local s=$(date +%s)
  mkdir -p $C/$1 $O/$1
  cp chip_stage/init_full/seed$2/step_0.pt $C/$1/
  bash simulate_2048_tpu_torch/scripts/run_scalar60k_arm.sh 5000 --set search_backend=auto \
    --checkpoint-dir $C/$1 --log-dir $O/$1 --seed $3 > $O/$1.out 2> $O/$1.err
  echo "$1 rc=$? s=$(( $(date +%s) - s ))" >> $O/times.txt
}
run jaxinit42_seed42 42 42 &
run jaxinit42_seed43 42 43 &
run jaxinit0_seed0 0 0 &
( s=$(date +%s); mkdir -p $O/cat_seed43
  bash simulate_2048_tpu_torch/scripts/run_cat60k_twin.sh 5000 --set search_backend=auto --seed 43 \
    --checkpoint-dir $C/cat_seed43 --log-dir $O/cat_seed43 > $O/cat_seed43.out 2> $O/cat_seed43.err
  echo "cat_seed43 rc=$? s=$(( $(date +%s) - s ))" >> $O/times.txt ) &
wait
cat $O/times.txt
grep -h "resumed\|eval @\|final evaluation\|mean_reward\|sem_reward" $O/*.out
du -sh $O

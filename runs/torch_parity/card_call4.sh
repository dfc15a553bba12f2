#!/bin/bash
# Usage, from the repository root on a machine with one GPU: copy runs/torch_parity/*.py, this script and the
# saved inits (twin_run.py --save-init: init/, init_full/) into chip_stage/, then
# run `bash chip_stage/card_call4.sh OUT`; the cd below lands at chip_stage/.., the repository root.
# Written after the call from the script it ran, chip_stage/run4.sh, which was not kept: that one took no
# argument and wrote to a fixed output directory, where OUT is now. This form has not been run on the card.
# Diagnostic call 4: the scalar recipe to 5,000 on the card from the port's own inits (--seed 44, 45) and from
# JAX's init of seed 44 (trainer seed 44).
cd "$(dirname "$0")/.." || exit 1
O="${1:?usage: card_call4.sh OUT}"
C=chip_stage/ckpt4
mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=.
python -c "from simulate_2048_tpu_torch.ops import _build; _build.build_all()" > $O/build.out 2>&1
run() {  # name, trainer seed, [init seed]
  local s=$(date +%s)
  mkdir -p $C/$1 $O/$1
  [ -n "$3" ] && cp chip_stage/init_full/seed$3/step_0.pt $C/$1/
  bash simulate_2048_tpu_torch/scripts/run_scalar60k_arm.sh 5000 --set search_backend=auto \
    --checkpoint-dir $C/$1 --log-dir $O/$1 --seed $2 > $O/$1.out 2> $O/$1.err
  echo "$1 rc=$? s=$(( $(date +%s) - s ))" >> $O/times.txt
}
run owninit_seed44 44 &
run owninit_seed45 45 &
run jaxinit44_seed44 44 44 &
wait
cat $O/times.txt
grep -H "resumed\|eval @" $O/*.out
du -sh $O

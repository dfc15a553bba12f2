#!/bin/bash
# Usage, from the repository root on a machine with one GPU: copy runs/torch_parity/*.py, this script and the
# saved inits (twin_run.py --save-init: init/, init_full/) into chip_stage/, then
# run `bash chip_stage/card_call2.sh OUT`; the cd below lands at chip_stage/.., the repository root.
# Written after the call from the script it ran, chip_stage/run2.sh, which was not kept: that one took no
# argument and wrote to a fixed output directory, where OUT is now. This form has not been run on the card.
# Diagnostic call 2: draws on the card; the reduced twin on the card (base, self-play on the CPU, learner on the CPU);
# the recipe at full width with its draws on the CPU; one trained network's self-play under three backends.
cd "$(dirname "$0")/.." || exit 1
O="${1:?usage: card_call2.sh OUT}"
C=chip_stage/ckpt
mkdir -p $O $C
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=.:chip_stage
python -c "from simulate_2048_tpu_torch.ops import _build; _build.build_all()" > $O/build.out 2>&1
python -c "import torch, chip_smoke as c; c.check_self_play_draws(torch.device('cuda'))" 2>&1 | tee $O/draws.out
t0=$(date +%s)
run() {  # name, command...
  local name=$1; shift; local s=$(date +%s)
  "$@" > $O/$name.out 2> $O/$name.err
  echo "$name rc=$? s=$(( $(date +%s) - s ))" >> $O/times.txt
}
run draws_cpu python chip_stage/card_variants.py draws_cpu --steps 2000 --out $O/variants --ckpt-root $C &
for s in 0 1 2 3; do
  run twin_$s python chip_stage/twin_run.py --package torch --init chip_stage/init --device cuda --seed $s \
    --set search_backend=auto --tag cuda_auto --out $O/twin_cuda --ckpt-dir $C/twin_$s &
done
for s in 0 1; do
  for v in selfplay_cpu learner_cpu; do
    run twin_${v}_$s python chip_stage/twin_run.py --package torch --init chip_stage/init --device cuda --seed $s \
      --set search_backend=auto --variant $v --tag cuda_$v --out $O/twin_cuda_variants --ckpt-dir $C/twin_${v}_$s &
  done
done
while [ ! -f $C/draws_cpu/ckpt/step_2000.pt ]; do sleep 20; [ $(( $(date +%s) - t0 )) -gt 1500 ] && break; done
for b in cuda_auto cuda_xla cpu_xla; do
  run sp_$b python chip_stage/selfplay_devices.py $b --segments $([ $b = cpu_xla ] && echo 1 || echo 2) --ckpt $C/draws_cpu/ckpt &
done
wait
cat $O/times.txt
python chip_stage/twin_run.py --summary $O/twin_cuda $O/twin_cuda_variants $O/variants
tail -n 3 $O/sp_*.out
du -sh $O

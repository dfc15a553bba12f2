#!/bin/bash
# The card runs behind runs/torch_scalar60k/, runs/torch_cat5k/, runs/torch_scalar60k_seed43/ and this
# directory, from the repository root on one GPU. Usage: card_runs.sh train|diagnose|seed43 [OUT]
#   train:    the scalar arm and the categorical twin to 5,000 steps, together on the card, checkpoints every 2,500;
#   diagnose: warm_compile (which builds the libraries), the four diagnoses on those checkpoints under
#             search_backend=auto, then kernel_vs_plain.py on both trained networks;
#   seed43:   the scalar arm to 5,000 steps again with --seed 43.
# Each command's output and wall time (ms) go to OUT (default runs/torch_diagnosis/out).
cd "$(dirname "$0")/../.." || exit 1
OUT="${2:-runs/torch_diagnosis/out}"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
timed() {  # name, command...
  local name=$1; shift
  local s=$(date +%s%N)
  "$@" > "$OUT/$name.out" 2> "$OUT/$name.err"
  echo "$name rc=$? ms=$(( ($(date +%s%N) - s) / 1000000 ))" | tee -a "$OUT/times.txt"
}
M="python -m simulate_2048_tpu_torch.scripts"
S=simulate_2048_tpu_torch/scripts
case "$1" in
  train)
    mkdir -p runs/torch_cat5k
    timed scalar bash $S/run_scalar60k_arm.sh 5000 --set search_backend=auto --set checkpoint_interval=2500 &
    timed cat bash $S/run_cat60k_twin.sh 5000 --set search_backend=auto --set checkpoint_interval=2500 \
      --checkpoint-dir runs/torch_cat5k/ckpt --log-dir runs/torch_cat5k &
    wait ;;
  diagnose)
    timed warm_compile $M.warm_compile scalar60k cat60k
    timed autopsy_eval $M.autopsy_eval --ckpt-dir runs/torch_scalar60k/ckpt --steps 2500 5000 --set search_backend=auto
    timed prior_sweep $M.prior_sweep --ckpt-dir runs/torch_scalar60k/ckpt --set search_backend=auto
    timed model_probe $M.model_probe --ckpt-dir runs/torch_scalar60k/ckpt --mode small --set search_backend=auto
    timed compare_scalar60k $M.compare_scalar60k runs/torch_cat5k/ckpt runs/torch_scalar60k/ckpt
    timed kernel_vs_plain env PYTHONPATH=. python runs/torch_diagnosis/kernel_vs_plain.py ;;
  seed43)
    mkdir -p runs/torch_scalar60k_seed43
    timed scalar_seed43 bash $S/run_scalar60k_arm.sh 5000 --set search_backend=auto --set checkpoint_interval=5000 \
      --seed 43 --checkpoint-dir runs/torch_scalar60k_seed43/ckpt --log-dir runs/torch_scalar60k_seed43 ;;
  *) echo "usage: $0 train|diagnose|seed43 [OUT]"; exit 2 ;;
esac

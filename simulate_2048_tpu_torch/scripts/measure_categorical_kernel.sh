#!/bin/bash
# The measurements of scripts/measure_categorical_kernel.sh through the
# port's benchmark_mcts on the GPU, with the same flags: the whole-search
# kernel with categorical heads (256/128 bins) at (a) the champion recipe's
# search (small preset: H=128, 5 blocks, 50 simulations, depth cap 32) and
# (b) the paper-full preset (H=256, 10 blocks, 100 simulations), 256 boards,
# bf16 and float32 packs (--pallas), then the plain search at both. Each
# command prints one JSON object.
cd "$(dirname "$0")/../.." || exit 1
set -x
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode small --boards 256 --sims 50 --max-depth 32 --value-bins 256 --reward-bins 128 --pallas --weight-dtype bfloat16
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode small --boards 256 --sims 50 --max-depth 32 --value-bins 256 --reward-bins 128 --pallas
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 256 --sims 100 --max-depth 32 --value-bins 256 --reward-bins 128 --pallas --weight-dtype bfloat16
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode small --boards 256 --sims 50 --max-depth 32 --value-bins 256 --reward-bins 128
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 256 --sims 100 --max-depth 32 --value-bins 256 --reward-bins 128

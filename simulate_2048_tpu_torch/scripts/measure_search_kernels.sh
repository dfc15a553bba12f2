#!/bin/bash
# The measurements of scripts/measure_search_kernels.sh through the port's
# benchmark_mcts on the GPU, with the same flags: the whole-search kernel
# with bf16 packs (--pallas) at (a) the paper-full preset's 256-game batch
# and (b) hidden 512 at 1,024 boards (the streamed library), then the plain
# search at both. Each command prints one JSON object.
cd "$(dirname "$0")/../.." || exit 1
set -x
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 256 --sims 100 --max-depth 32 --pallas --weight-dtype bfloat16
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 1024 --sims 100 --max-depth 32 --hidden 512 --pallas --weight-dtype bfloat16
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 256 --sims 100 --max-depth 32
python -m simulate_2048_tpu_torch.scripts.benchmark_mcts --mode full --boards 1024 --sims 100 --max-depth 32 --hidden 512

"""simulate_2048_tpu_torch — the PyTorch/CUDA port of ``simulate_2048_tpu``.

A second package beside the JAX one, for an NVIDIA H100. It imports
``torch`` and never JAX or the JAX package, and keeps its own copies of what
it needs from there. Ported so far: training
(``python -m simulate_2048_tpu_torch.train``), greedy evaluation
(``python -m simulate_2048_tpu_torch.evaluate``) and every layer under them:

- ``ops``      — spawn RNG, board ops, value transform, categorical value
                 support, and the whole-search CUDA kernel
                 (``csrc/whole_search.cu``) with its plain version.
- ``env``      — functional batched environment.
- ``models``   — the six Stochastic MuZero networks (scalar or categorical heads).
- ``search``   — batched stochastic MCTS in plain PyTorch, action selection.
- ``training`` — ``TrainConfig``, self-play, replay, losses, learner,
                 checkpoints, trainer.
- ``utils``    — metrics logging.
- ``convert``  — Flax parameters → the port's networks (for parity tests).

Entry points run on CUDA unless the caller asks for the CPU.
"""

"""simulate_2048_tpu_torch — the PyTorch/CUDA port of ``simulate_2048_tpu``.

A second package beside the JAX one, for an NVIDIA H100. It imports
``torch`` and never JAX or the JAX package, and keeps its own copies of what
it needs from there. Every module of the JAX package has its counterpart:
training (``python -m simulate_2048_tpu_torch.train``), greedy evaluation
(``python -m simulate_2048_tpu_torch.evaluate``), manual play
(``python -m simulate_2048_tpu_torch.play``) and every layer under them:

- ``ops``      — spawn RNG, board ops, value transform, categorical value
                 support, and the whole-search CUDA kernel
                 (``csrc/whole_search.cu``) with its plain version.
- ``env``      — functional batched environment.
- ``models``   — the six Stochastic MuZero networks (scalar or categorical heads).
- ``search``   — batched stochastic MCTS in plain PyTorch (PUCT or Gumbel
                 root, argmax or sampled chance selection, progressive
                 widening), action selection.
- ``training`` — ``TrainConfig``, self-play, replay, losses, learner,
                 checkpoints, trainer.
- ``engine``   — the scalar NumPy engine (host side: manual play, oracle).
- ``gui``      — the matplotlib board window.
- ``utils``    — metrics logging, encoders, profiling.
- ``convert``  — Flax parameters → the port's networks (for parity tests).

Entry points run on CUDA unless the caller asks for the CPU.
"""

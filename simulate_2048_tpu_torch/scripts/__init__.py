"""The measurement entry points, one module per script of the repository's
``scripts/`` (``python -m simulate_2048_tpu_torch.scripts.<name>``), each
with that script's flags, defaults and JSON keys, plus ``--device`` (default
``cuda``; they raise when no GPU is present unless given ``--device cpu``):

- ``benchmark_mcts``: batched search over a batch of boards, searches/s and
  simulations/s, the plain search or (``--pallas``) the whole-search kernel;
- ``benchmark_training``: replay sampling and learner-step timings in fp32
  and bf16, the step's FLOP count and its share of the card's bf16 peak;
- ``verify_parity``: lockstep random rollouts on the device, seed-exact
  against the NumPy engine;
- ``benchmark_scaling``: sharded rollouts and the data-parallel learner step
  over meshes of 1, 2, 4, ... devices, and their scaling efficiencies;
- ``trace_summary``: the device ops of a ``torch.profiler`` trace, ranked by
  total time; ``trace_training`` traces self-play moves and learner steps
  of a trained run for it.

The training recipes ``run_cat60k_twin.sh`` and ``run_scalar60k_arm.sh``
run the repository's recipes of those names through the port's ``train``
CLI on the GPU; ``recipes`` reads a recipe script back as its config.

Each script's work is a function that tests can call; ``main(argv)`` parses
and prints.
"""

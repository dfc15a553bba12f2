"""The entry points of the repository's ``scripts/``, one module per script
(``python -m simulate_2048_tpu_torch.scripts.<name>``), each with that
script's flags, defaults and JSON keys, plus ``--device`` (default ``cuda``;
they raise when no GPU is present unless given ``--device cpu``):

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

- the checkpoint diagnoses, on checkpoints of the port's trainer:
  ``autopsy_eval`` (a checkpoint re-evaluated with the prior flattened and
  the simulations raised), ``prior_sweep`` (prior temperature x
  ``pb_c_init``), ``model_probe`` (reward, value, prior and drift errors on
  fresh games) and ``compare_scalar60k`` (checkpoints on one game set);
  ``diagnosis`` holds what they share. Their prior ablations are weight
  transforms (``autopsy_eval.flat_prior``, ``prior_sweep.soften_prior``), so
  the whole-search kernel searches with them as the plain search does;
- ``measure_overlap``: learner steps/s serial, solo and with an actor
  process streaming trajectories;
- ``multihost_demo``: the data-parallel step over ``torch.distributed``
  processes (gloo on the CPU, NCCL on CUDA);
- ``warm_compile``: every CUDA library built, and each queued arm's search
  pack launched once;
- ``bench_engine_ops`` and ``plot_metrics``: the NumPy engine's ops timed,
  and a metrics log drawn as a PNG (neither runs torch; no ``--device``).

The training recipes ``run_cat60k_twin.sh``, ``run_scalar60k_arm.sh``,
``run_champion_r4.sh``, ``run_temp_early_arm.sh`` and
``run_full_capacity_probe.sh`` (from scratch), ``run_champion_r5.sh`` and
``run_gumbel_resumed_ab.sh`` (resuming the port's own checkpoints) run the
repository's recipes of those names through the port's ``train`` CLI on the
GPU; ``recipes`` reads a recipe script back as its config.
``measure_categorical_kernel.sh`` and ``measure_search_kernels.sh`` run
``benchmark_mcts`` with the repository's scripts' flags.

Each script's work is a function that tests can call; ``main(argv)`` parses
and prints.
"""

"""Warm the whole-search libraries for queued experiments: ``python -m simulate_2048_tpu_torch.scripts.warm_compile``.

Port of the repository's ``scripts/warm_compile.py``. The JAX script
compiles each queued arm's self-play and evaluation programs ahead of time
into XLA's persistent cache. The port compiles no programs; what a first
run pays for is ``nvcc`` and a library's first load. So this script builds
every CUDA library once (``ops/_build.py`` ``build_all``: one ``nvcc`` a
library, all started together, cached under ``build/kernels/``), then for
each arm builds its config, network and search pack in the kernel's plan
(``training/self_play.py`` ``_make_search``: resident or streamed, in the
arm's search weight type) and launches one self-play search at the arm's
shapes (``num_parallel_games`` roots, ``num_simulations``), which loads
the library and sizes its workspace. An arm outside the kernel's limits (a
Gumbel root) prints ``plain`` and launches nothing: its searches run the
plain search, which has nothing to build.

Same arguments (arm names, default: all in queue order) and the same
``ARMS`` (the JAX script's five, in its order), plus ``--device`` (default
``cuda``; raises when no GPU is present unless given ``--device cpu``, where
nothing is built and the kernel's plain version runs). Prints the seconds of
the build and of each arm.

Usage: ``python -m simulate_2048_tpu_torch.scripts.warm_compile [scalar60k cat60k gumbel gumbel03 full]``
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

CHAMPION = [
    "value_target_mode=td_lambda", "td_lambda=1.0", "cross_segment_backfill=True",
    "afterstate_value_loss_weight=0.25", "value_bins=256", "reward_bins=128",
    "lr_decay_steps=300000", "eval_interval=5000", "checkpoint_interval=10000",
    "deep_eval_interval=25000", "deep_eval_games=128",
    "eval_prior_temperature=4.0", "eval_pb_c_init=0.5",
    "reanalyze_interval=500", "reanalyze_episodes=64", "reanalyze_mode=search",
]  # fmt: skip

# name -> (preset, overrides): the JAX script's queue, each arm's recipe script named beside it.
ARMS = {
    # scripts/run_scalar60k_arm.sh
    "scalar60k": ("small", [
        "value_target_mode=td_lambda", "td_lambda=1.0", "cross_segment_backfill=True",
        "afterstate_value_loss_weight=0.25", "lr_decay_steps=60000",
        "eval_interval=5000", "checkpoint_interval=10000",
        "deep_eval_interval=30000", "deep_eval_games=128",
        "eval_prior_temperature=4.0", "eval_pb_c_init=0.5",
    ]),
    # scripts/run_cat60k_twin.sh
    "cat60k": ("small", [
        "value_target_mode=td_lambda", "td_lambda=1.0", "cross_segment_backfill=True",
        "afterstate_value_loss_weight=0.25", "value_bins=256", "reward_bins=128",
        "lr_decay_steps=60000", "eval_interval=5000", "checkpoint_interval=10000",
        "deep_eval_interval=30000", "deep_eval_games=128",
        "eval_prior_temperature=4.0", "eval_pb_c_init=0.5",
    ]),
    # scripts/run_gumbel_resumed_ab.sh
    "gumbel": ("small", CHAMPION + ["root_selection=gumbel"]),
    "gumbel03": ("small", CHAMPION + ["root_selection=gumbel", "gumbel_c_scale=0.03"]),
    # scripts/run_full_capacity_probe.sh
    "full": ("full", CHAMPION + ["search_weight_dtype=bfloat16"]),
}  # fmt: skip


def arm_config(name: str):
    """The config of arm ``name``: its preset with its overrides."""
    from simulate_2048_tpu_torch.training.config import apply_overrides, default_config, small_config

    preset, overrides = ARMS[name]
    return apply_overrides({"small": small_config, "full": default_config}[preset](), overrides)


def warm(name: str, device) -> dict:
    """Pack arm ``name``'s network in the kernel's plan and launch one
    self-play search at its shapes; prints and returns the arm's line."""
    from simulate_2048_tpu_torch.env import env as envlib
    from simulate_2048_tpu_torch.models.network import network_from_config
    from simulate_2048_tpu_torch.ops import search_kernel as sk
    from simulate_2048_tpu_torch.ops.rng import prng_key
    from simulate_2048_tpu_torch.scripts.diagnosis import launches_since, search_route
    from simulate_2048_tpu_torch.search.mcts import draw_root_noise, uses_root_noise
    from simulate_2048_tpu_torch.training.self_play import _make_search, _search_weight_dtype, search_config_from

    config = arm_config(name)
    games, sims = config.num_parallel_games, config.num_simulations
    cfg = search_config_from(config)
    refused = sk.kernel_limits(cfg, config.hidden_size, _search_weight_dtype(config))
    if refused is not None:
        print(f"[{name}] plain: its self-play search is outside the kernel's limits ({refused}); nothing launched",
              flush=True)  # fmt: skip
        return {"arm": name, "route": "plain", "seconds": 0.0, "launches": {}}
    # The kernel, whatever backend the arm's recipe names (on the CPU: its plain version).
    kernel = dataclasses.replace(config, search_backend="auto" if device.type == "cuda" else "pallas")
    route = search_route(kernel, device, eval_mode=False)
    t0 = time.perf_counter()
    network = network_from_config(config, prng_key(0), device)
    search = _make_search(network, kernel, cfg, device)
    state = envlib.reset_batch(1, games, device)
    generator = torch.Generator(device=device).manual_seed(2)
    noise = draw_root_noise(cfg, games, generator, device) if uses_root_noise(cfg) else None
    before = dict(sk.LAUNCHES)
    search(envlib.get_observation(state), ~envlib.get_legal_actions(state), noise)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = launches_since(before)
    print(f"[{name}] {route}: packed and one self-play search of {games} x {sims} simulations (H="
          f"{config.hidden_size}, {config.search_weight_dtype} pack) in {seconds:.1f}s, launches {launches}",
          flush=True)  # fmt: skip
    return {"arm": name, "route": route, "seconds": seconds, "launches": launches}


def warm_all(names: list[str], device="cuda") -> list[dict]:
    """Build every library (on CUDA), then warm each arm of ``names`` in order."""
    from simulate_2048_tpu_torch.device import resolve_device

    device = resolve_device(device)
    unknown = [n for n in names if n not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown}; the arms are {list(ARMS)}")
    if device.type == "cuda":
        from simulate_2048_tpu_torch.ops import _build

        t0 = time.perf_counter()
        built = _build.build_all()
        fresh = [k for k, s in built.items() if s > 0]
        print(f"libraries built in {time.perf_counter() - t0:.0f}s: {fresh or 'all cached'}", flush=True)
    return [warm(name, device) for name in names]


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("arms", nargs="*", help=f"arms to warm, in order (default: all, {' '.join(ARMS)})")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' to run on the CPU)")
    args = parser.parse_args(argv)
    return warm_all(args.arms or list(ARMS), args.device)


if __name__ == "__main__":
    main()

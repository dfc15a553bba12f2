"""The scalar recipe (``simulate_2048_tpu_torch/scripts/run_scalar60k_arm.sh``)
through the port's train CLI on the GPU, with one source of draws or one
stage moved to the CPU, to find which part of the card's run learns slower
than the JAX package's. From the repository root, on a machine with a GPU:

    python runs/torch_parity/card_variants.py VARIANT --steps 2000 --out DIR [--ckpt-root DIR] [train flags...]

Variants (the search backend is ``auto``, the whole-search kernel, unless named):

- ``base``: the recipe as it runs;
- ``noise_cpu``: the root's Dirichlet noise drawn on the CPU (a CPU generator seeded like the trainer's);
- ``uniform_cpu``: the uniforms of the action draws on the CPU;
- ``replay_cpu``: the replay's (episode, start) draws on the CPU;
- ``draws_cpu``: all three;
- ``selfplay_cpu``: every self-play segment played on the CPU (a copy of the
  network, the plain search, a CPU generator), the rest on the GPU;
- ``learner_cpu``: every chunk of learner steps (sample, step, priority
  update) on the CPU, on copies of the state and the buffer written back;
- ``xla``: the plain search on the GPU (``search_backend=xla``), every draw on the GPU.

Logs go to ``DIR/<variant>/metrics.jsonl``, checkpoints to
``<ckpt-root>/<variant>/ckpt`` (default DIR); further flags go to the train CLI.
"""

from __future__ import annotations

import copy
import sys

import torch

from simulate_2048_tpu_torch.scripts.recipes import RECIPE_DIR, script_argv
from simulate_2048_tpu_torch.search import mcts
from simulate_2048_tpu_torch.search import policy
from simulate_2048_tpu_torch.training import replay, self_play

VARIANTS = ("base", "noise_cpu", "uniform_cpu", "replay_cpu", "draws_cpu", "selfplay_cpu", "learner_cpu", "xla")


def patch(variant: str, seed: int) -> None:
    """Move what ``variant`` names to the CPU (draws from a CPU generator seeded ``seed + 1``)."""
    cpu = torch.Generator().manual_seed(seed + 1)
    if variant in ("noise_cpu", "draws_cpu"):
        def draw_root_noise(cfg, batch, generator, device):
            noise = mcts.draw_root_noise(cfg, batch, cpu, "cpu")
            return None if noise is None else noise.to(device)

        self_play.draw_root_noise = draw_root_noise
    if variant in ("uniform_cpu", "draws_cpu"):
        def sample_from_visits(out, legal, temperature, generator=None, uniform=None):
            if uniform is None:
                uniform = torch.rand(legal.shape[0], generator=cpu).to(legal.device)
            return policy.sample_from_visits(out, legal, temperature, generator, uniform)

        self_play.sample_from_visits = sample_from_visits
    if variant in ("replay_cpu", "draws_cpu"):
        def sample_indices(state, generator, batch_size, config):
            w = replay._sampling_weights(state, config).cpu()
            episodes = torch.multinomial(w.sum(-1), batch_size, replacement=True, generator=cpu)
            starts = torch.multinomial(w[episodes], 1, generator=cpu)[:, 0]
            return torch.stack([episodes, starts], dim=1).to(state.length.device)

        replay.sample_indices = sample_indices
    from simulate_2048_tpu_torch.training import trainer

    if variant == "selfplay_cpu":
        generate_on_device = trainer.generate_games

        def generate_games(network, generator, config, step, num_games=None, env_state=None):
            device = env_state.board.device
            state = type(env_state)(*(x.cpu() for x in env_state))
            out = generate_on_device(copy.deepcopy(network).cpu(), cpu, config, step, num_games, state)
            return tuple(type(x)(*(t.to(device) for t in x)) for x in out)

        trainer.generate_games = generate_games
    if variant == "learner_cpu":
        superstep_on_device = trainer.train_superstep

        def train_superstep(state, buffer, generator, config, optimizer, num_steps, step_fn=None):
            opt = state.opt_state
            host = trainer.TrainState(copy.deepcopy(state.network).cpu(), {
                "count": opt["count"], "mu": [m.cpu() for m in opt["mu"]], "nu": [v.cpu() for v in opt["nu"]]})
            host.step = state.step
            host_buffer = type(buffer)(*(x.cpu() for x in buffer))
            host, host_buffer, losses = superstep_on_device(host, host_buffer, cpu, config, optimizer, num_steps)
            with torch.no_grad():
                for dst, src in zip(state.params + opt["mu"] + opt["nu"], host.params + host.opt_state["mu"] +
                                    host.opt_state["nu"]):  # fmt: skip
                    dst.copy_(src)
                buffer.step_priorities.copy_(host_buffer.step_priorities)
            opt["count"], state.step = host.opt_state["count"], host.step
            return state, buffer, type(losses)(*(x.to(buffer.length.device) for x in losses))

        trainer.train_superstep = train_superstep


def main() -> None:
    variant, rest = sys.argv[1], sys.argv[2:]
    if variant not in VARIANTS:
        raise SystemExit(f"variant must be one of {VARIANTS}")
    steps = rest[rest.index("--steps") + 1] if "--steps" in rest else "2000"
    out = rest[rest.index("--out") + 1] if "--out" in rest else "runs/torch_parity/card_variants"
    ckpt_root = rest[rest.index("--ckpt-root") + 1] if "--ckpt-root" in rest else out
    ours = ("--steps", "--out", "--ckpt-root")
    extra = [w for i, w in enumerate(rest) if w not in ours and (i == 0 or rest[i - 1] not in ours)]
    argv = script_argv(RECIPE_DIR / "run_scalar60k_arm.sh")
    argv = [w for w in argv if w != '"${@:2}"' and w != "${@:2}"]
    argv[argv.index("--steps") + 1] = steps
    argv[argv.index("--checkpoint-dir") + 1] = f"{ckpt_root}/{variant}/ckpt"
    argv[argv.index("--log-dir") + 1] = f"{out}/{variant}"
    argv += ["--set", f"search_backend={'xla' if variant == 'xla' else 'auto'}", "--no-eval"] + extra
    seed = int(extra[extra.index("--seed") + 1]) if "--seed" in extra else 42
    patch(variant, seed)
    from simulate_2048_tpu_torch import train
    from simulate_2048_tpu_torch.ops import search_kernel

    print(f"{variant}: train {' '.join(argv)}", flush=True)
    train.main(argv)
    print(f"{variant}: search kernel launches {dict(search_kernel.LAUNCHES)}", flush=True)


if __name__ == "__main__":
    main()

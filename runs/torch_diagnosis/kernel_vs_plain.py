"""The whole-search kernel against the plain search on the trained networks of
``runs/torch_scalar60k/ckpt`` and ``runs/torch_cat5k/ckpt`` (step 5,000), on the GPU.

For each network, 64 mid-game roots (``chip_smoke.midgame_roots``), under the
recipe's evaluation search (prior temperature 4, ``pb_c_init`` 0.5, no root
noise) and its self-play search (Dirichlet root noise, the same tensor for
both): identical visit counts out of 64, and the largest Q and root value
gaps. Run from the repository root: ``PYTHONPATH=. python
runs/torch_diagnosis/kernel_vs_plain.py``.
"""

import torch

import chip_smoke as cs
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search import mcts
from simulate_2048_tpu_torch.training.checkpoint import CheckpointManager, load_train_config
from simulate_2048_tpu_torch.training.learner import create_train_state
from simulate_2048_tpu_torch.training.self_play import search_config_from

torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda")
for ckpt, step in (("runs/torch_scalar60k/ckpt", 5000), ("runs/torch_cat5k/ckpt", 5000)):
    cfg = load_train_config(ckpt)
    state, net = create_train_state(cfg, torch.Generator().manual_seed(0), device)
    CheckpointManager(ckpt).restore(state, step)
    obs, invalid = cs.midgame_roots(device, cfg.num_parallel_games, torch.Generator().manual_seed(5))
    for eval_mode in (True, False):
        scfg = search_config_from(cfg, eval_mode)
        noise = None
        if eval_mode:
            scfg = scfg._replace(dirichlet_fraction=0.0)
        else:
            noise = mcts.draw_root_noise(scfg, obs.shape[0], torch.Generator(device=device).manual_seed(6), device)
        k = sk.run_search_kernel(net, obs, scfg, invalid, noise, packed=cs.pack(net, cfg))
        p = mcts.batched_run_mcts(net, obs, scfg, invalid, noise)
        torch.cuda.synchronize()
        same = int((k.visit_counts == p.visit_counts).all(-1).sum())
        dq = float((k.qvalues - p.qvalues).abs().max())
        dv = float((k.search_value - p.search_value).abs().max())
        print(f"{ckpt} step {step} {'evaluation' if eval_mode else 'self-play'} search (T={scfg.prior_temperature}, "
              f"pb_c_init={scfg.pb_c_init}): {same}/{obs.shape[0]} identical visits, max |dQ| {dq:.3g}, max |dv| "
              f"{dv:.3g}, mean root value {float(p.search_value.mean()):.2f}", flush=True)

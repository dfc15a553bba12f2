"""The float32 whole-search kernel against its plain version at chip_smoke.py's
preset check (H=256, 10 blocks, 256 searches x 100 simulations, scalar heads
scaled by 20), from JAX's init of chip_smoke.SEED and from the torch-generator
draw the port used before (rebuilt here), and at H=64; the searches outside
rtol 1e-4 / atol 1e-3 with their root visits, Q and value; the plain version
on the GPU against the CPU; then the kernel at the scalar recipe's widths from
JAX's inits of seeds 42, 43, 45, 46 under both search configs. From the
repository root on a machine with a GPU (``cpu`` as the argument runs the
plain version in place of the kernel):

    PYTHONPATH=. python runs/torch_init/near_tie_check.py [cpu]
"""

import math
import sys

import torch

import chip_smoke as cs
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.models.blocks import Dense
from simulate_2048_tpu_torch.models.muzero import CategoricalHead
import simulate_2048_tpu_torch.models.network as nw

dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
if dev.type == "cuda":
    cs._build.build_all()
else:
    torch.cuda.synchronize = lambda: None


def old_init(self, key):
    """The port's former draw: torch.nn.init.trunc_normal_ from a generator seeded with chip_smoke.SEED."""
    g = torch.Generator().manual_seed(cs.SEED)
    for m in self.modules():
        if isinstance(m, CategoricalHead):
            m.init_weights()
        elif isinstance(m, Dense):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            with torch.no_grad():
                torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=g)
                m.bias.zero_()
    return self


def report(tag, hidden=None):
    config, cfg, network, packed, roots = cs.full_width_inputs(dev, batch=256, hidden=hidden)
    ref = sk.whole_search_reference(*roots, packed, cfg)
    cpu = sk.whole_search_reference(*(r.cpu() for r in roots), sk.PackedSearchParams(*(t.cpu() if torch.is_tensor(t) else t for t in packed)), cfg)
    out = sk.whole_search(*roots, packed, cfg); torch.cuda.synchronize()
    out2 = sk.whole_search(*roots, packed, cfg); torch.cuda.synchronize()
    names = ("visits", "q", "value")
    print(f"== {tag}: kernel deterministic: {all(torch.equal(a, b) for a, b in zip(out, out2))}")
    for other, oname in ((ref, "plain cuda"), (tuple(c.to(dev) for c in cpu), "plain cpu")):
        same = ~(out[0] != other[0]).any(-1)
        dq = (out[1] - other[1]).abs(); dv = (out[2] - other[2]).abs()
        tolq = 1e-3 + 1e-4 * other[1].abs(); tolv = 1e-3 + 1e-4 * other[2].abs()
        badq = ((dq > tolq) & same[:, None]).any(-1); badv = (dv > tolv) & same
        print(f"kernel vs {oname}: identical visits {int(same.sum())}/256; max dq {float(dq[same].max()):.4g} max dv {float(dv[same].max()):.4g}; searches out of tol: q {int(badq.sum())} v {int(badv.sum())}")
        for i in (badq | badv).nonzero().flatten().tolist()[:6]:
            print(f"  search {i}: visits {out[0][i].tolist()}\n    kernel q {out[1][i].tolist()} v {float(out[2][i])}\n    {oname} q {other[1][i].tolist()} v {float(other[2][i])}\n    root_v in {float(roots[2][i])} priors {roots[1][i].tolist()}")
    same = ~(ref[0] != cpu[0].to(dev)).any(-1)
    print(f"plain cuda vs plain cpu: identical {int(same.sum())}/256, max dq {float((ref[1]-cpu[1].to(dev)).abs()[same].max()):.4g}")
    print(f"value range {float(ref[2].min()):.1f}..{float(ref[2].max()):.1f}, q range {float(ref[1].min()):.1f}..{float(ref[1].max()):.1f}")

report("JAX init (prng_key(SEED))")
orig = nw.MuZeroNetwork.init_weights
nw.MuZeroNetwork.init_weights = old_init
report("torch-generator init (the former draw)")
nw.MuZeroNetwork.init_weights = orig
report("JAX init, H=64", hidden=64)

from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import rng
from simulate_2048_tpu_torch.scripts import recipes
from simulate_2048_tpu_torch.search.mcts import root_inputs
from simulate_2048_tpu_torch.training.self_play import search_config_from


def recipe_check(seed, eval_mode):
    config = recipes.recipe_config("run_scalar60k_arm.sh")
    network = network_from_config(config, rng.split(rng.prng_key(seed))[1], dev)
    gen = torch.Generator().manual_seed(seed)
    obs, invalid = cs.midgame_roots(dev, 256, gen)
    cfg = search_config_from(config, eval_mode=eval_mode)
    noise = None
    if eval_mode:
        cfg = cfg._replace(dirichlet_fraction=0.0)
    else:
        noise = torch._sample_dirichlet(torch.full((256, cfg.num_actions), cfg.dirichlet_alpha), gen).to(dev)
    with torch.no_grad():
        roots = root_inputs(network, obs, cfg, invalid, noise)
    roots = tuple(r.contiguous() for r in roots)
    packed = cs.pack(network, config)
    ref = sk.whole_search_reference(*roots, packed, cfg)
    out = sk.whole_search(*roots, packed, cfg); torch.cuda.synchronize()
    same = ~(out[0] != ref[0]).any(-1)
    dq = (out[1] - ref[1]).abs(); dv = (out[2] - ref[2]).abs()
    print(f"recipe init of seed {seed} ({'eval' if eval_mode else 'self-play'} search): identical visits "
          f"{int(same.sum())}/256, max dq {float(dq[same].max()):.4g}, max dv {float(dv[same].max()):.4g}, "
          f"values {float(ref[2].min()):.1f}..{float(ref[2].max()):.1f}")


for s in (42, 43, 45, 46):
    for e in (False, True):
        recipe_check(s, e)

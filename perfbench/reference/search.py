"""Stochastic MuZero search as the benchmark's reference runs it: plain
PyTorch, B searches in lockstep, one simulation at a time.

The search the configurations run (the paper's, with this repository's
choices): PUCT with min-max normalised Q at decision nodes (an unvisited
child counts at its parent's value), argmax p(c) / (1 + N(c)) at chance
nodes, ties to the first slot, zero-prior slots never taken; a depth cap
(a simulation that reaches it on an expanded edge backs up that child's
value); values and rewards leave the networks in h-space and enter the tree
through h⁻¹; priors are softmax(logits / T). Each simulation expands one
node and evaluates both transition types at the chosen edge, keeping the
one the parent's type asks for. The root's priors mix in the Dirichlet
noise as (1 − ρ)·π + ρ·noise, then illegal actions are zeroed and the rest
renormalised.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference import model

NEG_INF = -1e9
UNVISITED = -1


class Search(NamedTuple):
    simulations: int
    num_actions: int
    codebook: int
    discount: float
    pb_c_init: float
    pb_c_base: float
    max_depth: int | None
    prior_temperature: float
    dirichlet_fraction: float
    value_epsilon: float | None  # None: values stay in h-space


def search_of(config: dict, evaluation: bool) -> Search:
    """The search a configuration's self-play (or, with ``evaluation``, its
    greedy evaluation: the eval calibration, no root noise) runs."""
    temperature, pb_c_init, fraction = config["prior_temperature"], config["pb_c_init"], config["dirichlet_fraction"]
    if evaluation:
        temperature = config["eval_prior_temperature"] or temperature
        pb_c_init = config["eval_pb_c_init"] or pb_c_init
        fraction = 0.0
    return Search(
        simulations=config["num_simulations"],
        num_actions=config["action_size"],
        codebook=config["codebook_size"],
        discount=config["discount"],
        pb_c_init=pb_c_init,
        pb_c_base=config["pb_c_base"],
        max_depth=config["search_max_depth"],
        prior_temperature=temperature,
        dirichlet_fraction=fraction,
        value_epsilon=config["value_epsilon"] if config["search_untransform_values"] else None,
    )


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def h_inverse(x: torch.Tensor, eps: float | None) -> torch.Tensor:
    if eps is None:
        return x
    inside = 1 + 4 * eps * (torch.abs(x) + 1 + eps)
    return torch.sign(x) * (torch.square(_div(torch.sqrt(inside) - 1, 2 * eps)) - 1)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def root_priors(logits, cfg: Search, legal: torch.Tensor, noise: torch.Tensor | None) -> torch.Tensor:
    """(B, K) root priors: tempered softmax, noise mixed in, illegal actions zeroed, renormalised, padded."""
    probs = softmax(_div(logits, cfg.prior_temperature))
    if cfg.dirichlet_fraction > 0.0:
        probs = (1.0 - cfg.dirichlet_fraction) * probs + cfg.dirichlet_fraction * noise
    probs = torch.where(legal, probs, torch.zeros_like(probs))
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-12)
    width = max(cfg.num_actions, cfg.codebook)
    return torch.nn.functional.pad(probs, (0, width - probs.shape[-1]))


@torch.no_grad()
def run(root_hidden, root_prior, root_value, cfg: Search, expand) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All simulations of B searches. ``root_value`` is raw (h⁻¹ applied).
    Returns root visits (B, A), root Q (B, A) and the root's value (B,)."""
    bsz, h = root_hidden.shape
    s, a = cfg.simulations, cfg.num_actions
    k = max(a, cfg.codebook)
    n = s + 1
    depth_cap = min(cfg.max_depth if cfg.max_depth is not None else s + 1, s + 1)
    dev = root_hidden.device
    kw = dict(dtype=torch.float32, device=dev)
    b = torch.arange(bsz, device=dev)

    embedding = torch.zeros(bsz, n, h, **kw)
    embedding[:, 0] = root_hidden
    is_decision = torch.zeros(bsz, n, dtype=torch.bool, device=dev)
    is_decision[:, 0] = True
    node_value = torch.zeros(bsz, n, **kw)
    node_value[:, 0] = root_value
    node_visit = torch.zeros(bsz, n, **kw)
    node_visit[:, 0] = 1.0
    prior = torch.zeros(bsz, n, k, **kw)
    prior[:, 0] = root_prior
    child = torch.full((bsz, n, k), UNVISITED, dtype=torch.int64, device=dev)
    child_visits = torch.zeros(bsz, n, k, **kw)
    child_values = torch.zeros(bsz, n, k, **kw)
    node_reward = torch.zeros(bsz, n, **kw)
    node_discount = torch.ones(bsz, n, **kw)

    def select(node):
        p = prior[b, node]
        visits = child_visits[b, node]
        parent_visits = node_visit[b, node][:, None]
        parent_value = node_value[b, node][:, None]
        completed = torch.where(visits > 0, child_values[b, node], parent_value)
        lo = torch.minimum(completed.amin(-1, keepdim=True), parent_value)
        hi = torch.maximum(completed.amax(-1, keepdim=True), parent_value)
        q = (completed - lo) / torch.clamp_min(hi - lo, 1e-8)
        c = cfg.pb_c_init + torch.log(_div(parent_visits + cfg.pb_c_base + 1.0, cfg.pb_c_base))
        puct = q + c * p * torch.sqrt(torch.clamp_min(parent_visits, 1.0)) / (1.0 + visits)
        score = torch.where(is_decision[b, node][:, None], puct, p / (1.0 + visits))
        return torch.where(p > 0, score, torch.full_like(score, NEG_INF)).argmax(-1)

    for sim in range(s):
        new = sim + 1
        parent = torch.zeros(bsz, dtype=torch.int64, device=dev)
        edge = select(parent)
        path_nodes = torch.zeros(bsz, depth_cap, dtype=torch.int64, device=dev)
        path_edges = torch.zeros(bsz, depth_cap, dtype=torch.int64, device=dev)
        path_edges[:, 0] = edge
        nxt = child[b, parent, edge]
        depth = torch.ones(bsz, dtype=torch.int64, device=dev)
        for t in range(1, depth_cap):
            live = nxt != UNVISITED
            if not bool(live.any()):
                break
            node = torch.where(live, nxt, parent)
            e = select(node)
            parent = node
            edge = torch.where(live, e, edge)
            nxt = torch.where(live, child[b, node, e], nxt)
            path_nodes[:, t] = torch.where(live, node, 0)
            path_edges[:, t] = torch.where(live, e, 0)
            depth = depth + live.to(torch.int64)

        parent_decision = is_decision[b, parent]
        out = expand(embedding[b, parent], edge)
        q_value = h_inverse(out.q_value, cfg.value_epsilon)
        reward = h_inverse(out.reward, cfg.value_epsilon)
        value = h_inverse(out.value, cfg.value_epsilon)
        pad = lambda x: torch.nn.functional.pad(x, (0, k - x.shape[-1]))  # noqa: E731
        chance_prior = pad(softmax(_div(out.chance_logits, cfg.prior_temperature)))
        action_prior = pad(softmax(_div(out.action_logits, cfg.prior_temperature)))
        dec = parent_decision[:, None]
        embedding[:, new] = torch.where(dec, out.afterstate, out.hidden)
        prior[:, new] = torch.where(dec, chance_prior, action_prior)
        is_decision[:, new] = ~parent_decision
        node_reward[:, new] = torch.where(parent_decision, torch.zeros_like(reward), reward)
        node_discount[:, new] = torch.where(parent_decision, torch.ones_like(reward),
                                            torch.full_like(reward, cfg.discount))  # fmt: skip
        expand_here = nxt == UNVISITED
        leaf = torch.where(expand_here, torch.full_like(nxt, new), nxt)
        child[b, parent, edge] = leaf
        leaf_value = torch.where(expand_here, torch.where(parent_decision, q_value, value),
                                 node_value[b, nxt.clamp(min=0)])  # fmt: skip

        # Backup: v_j = r_{j+1} + γ_{j+1} v_{j+1} up the path from the leaf.
        pos = torch.arange(depth_cap + 1, device=dev)
        ext = torch.cat([path_nodes, torch.zeros_like(path_nodes[:, :1])], 1)
        nodes = torch.where(pos < depth[:, None], ext, torch.where(pos == depth[:, None], leaf[:, None], n))
        safe = nodes.clamp(max=n - 1)
        rew, disc = node_reward.gather(1, safe), node_discount.gather(1, safe)
        values = torch.zeros(bsz, depth_cap + 1, **kw)
        values[b, depth] = leaf_value
        for j in reversed(range(int(depth.max()))):
            values[:, j] = torch.where(j < depth, rew[:, j + 1] + disc[:, j + 1] * values[:, j + 1], values[:, j])
        bi, ji = (pos[None, :] <= depth[:, None]).nonzero(as_tuple=True)
        nd = nodes[bi, ji]
        old_visit, old_value = node_visit[bi, nd], node_value[bi, nd]
        node_value[bi, nd] = (old_value * old_visit + values[bi, ji]) / (old_visit + 1.0)
        node_visit[bi, nd] = old_visit + 1.0
        bi, ji = (pos[None, :depth_cap] < depth[:, None]).nonzero(as_tuple=True)
        nd, ed, cn = path_nodes[bi, ji], path_edges[bi, ji], nodes[bi, ji + 1]
        child_visits[bi, nd, ed] += 1.0
        child_values[bi, nd, ed] = node_reward[bi, cn] + node_discount[bi, cn] * node_value[bi, cn]
    return child_visits[:, 0, :a], child_values[:, 0, :a], node_value[:, 0]


@torch.no_grad()
def search(w, config: dict, observations: torch.Tensor, legal: torch.Tensor, noise: torch.Tensor | None,
           evaluation: bool, products: str):  # fmt: skip
    """The searches a configuration runs from ``observations`` (B, 16) (exponent / 16):
    root h/f in the configuration's numerics, the tree's products in ``products``.
    Returns (visits (B, A), root Q (B, A), root value (B,))."""
    cfg = search_of(config, evaluation)
    heads = model.heads_of(config)
    blocks = config["num_residual_blocks"]
    hidden, logits, value = model.root(w, observations, blocks, config["use_bfloat16"], heads)
    priors = root_priors(logits, cfg, legal, noise)
    expand = model.transitions(w, blocks, heads, cfg.num_actions, cfg.codebook, products)
    return run(hidden, priors, h_inverse(value, cfg.value_epsilon), cfg, expand)

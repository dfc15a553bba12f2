"""Batched stochastic MuZero search, in plain PyTorch.

Port of the JAX package's ``search/mcts.py`` for the configuration the
evaluation path runs: PUCT at the root and at every decision node,
deterministic argmax p(c)/(1+N(c)) at chance nodes, no progressive widening.
It covers the depth cap, min-max normalised Q, the raw-space value
untransform and the edge/node backup, and uses real indexing (gathers and
scatters) where the JAX package uses one-hot contractions.

Every simulation evaluates both transition types at the selected edge —
φ then ψ (decision parent → chance child) and g then f (chance parent →
decision child) — and keeps the one the parent's type asks for, as the JAX
search and the whole-search kernel do. :func:`search_tree` takes the
transition function as an argument, so the same tree code serves the
network modules here and the packed weights of ``ops/search_kernel.py``'s
plain version.

Root Dirichlet noise enters as an explicit ``noise`` tensor ``(B, A)``.
Gumbel root selection, sampled chance selection and progressive widening
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from simulate_2048_tpu_torch.ops.value_transform import div_scalar, inverse_scale_value
from simulate_2048_tpu_torch.search.tree import NEG_INF, ROOT, UNVISITED, Tree, init_tree


class SearchConfig(NamedTuple):
    """Static search hyperparameters; fields and defaults as in the JAX package."""

    num_simulations: int = 100
    num_actions: int = 4
    codebook_size: int = 32
    discount: float = 0.999
    dirichlet_alpha: float = 0.25
    dirichlet_fraction: float = 0.1
    pb_c_init: float = 1.25
    pb_c_base: float = 19652.0
    max_depth: int | None = None
    chance_selection: str = "argmax"
    pw_c: float | None = None
    pw_alpha: float = 0.5
    prior_temperature: float = 1.0
    root_selection: str = "puct"
    gumbel_scale: float = 1.0
    gumbel_c_visit: float = 50.0
    gumbel_c_scale: float = 0.1
    value_transform_epsilon: float | None = None
    value_bins: int = 1
    reward_bins: int = 1
    value_support_max: float = 320.0
    reward_support_max: float = 100.0


class PolicyOutput(NamedTuple):
    """Search result, batch first."""

    action_weights: torch.Tensor  # (B, A) visit distribution over root actions
    search_value: torch.Tensor  # (B,) backed-up root value
    visit_counts: torch.Tensor  # (B, A) int32 root visit counts
    qvalues: torch.Tensor  # (B, A) root Q values


class Transitions(NamedTuple):
    """Both transition types evaluated at a batch of (parent, edge) pairs."""

    afterstate: torch.Tensor  # (B, H) φ output
    q_value: torch.Tensor  # (B,) ψ value head (network space)
    chance_logits: torch.Tensor  # (B, C)
    hidden: torch.Tensor  # (B, H) g output
    reward: torch.Tensor  # (B,) g reward head (network space)
    value: torch.Tensor  # (B,) f value head (network space)
    action_logits: torch.Tensor  # (B, A)


TransitionFn = Callable[[torch.Tensor, torch.Tensor], Transitions]


def check_supported(cfg: SearchConfig) -> None:
    """Raise for the search variants this port does not have yet."""
    if cfg.root_selection != "puct":
        raise NotImplementedError("Gumbel root selection is not ported yet")
    if cfg.chance_selection != "argmax":
        raise NotImplementedError("sampled chance selection is not ported yet")
    if cfg.pw_c is not None:
        raise NotImplementedError("progressive widening is not ported yet")


def untransform(cfg: SearchConfig, x: torch.Tensor) -> torch.Tensor:
    """h⁻¹ on network value/reward outputs, or identity."""
    eps = cfg.value_transform_epsilon
    return x if eps is None else inverse_scale_value(x, eps)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """exp(x − max) / Σ, in the JAX package's operation order."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def select_child(tree: Tree, node: torch.Tensor, cfg: SearchConfig) -> torch.Tensor:
    """Edge to follow from ``node`` (B,) in each search: PUCT with min-max Q
    at decision nodes, argmax p/(1+N) at chance nodes, zero-prior slots
    excluded; ties go to the first index."""
    b = torch.arange(node.shape[0], device=node.device)
    prior = tree.prior_probs[b, node]
    child_visits = tree.children_visits[b, node]
    q = tree.children_values[b, node]
    parent_visits = tree.node_visit[b, node][:, None]
    parent_value = tree.node_value[b, node][:, None]
    is_dec = tree.is_decision[b, node][:, None]

    completed = torch.where(child_visits > 0, q, parent_value)
    lo = torch.minimum(completed.amin(-1, keepdim=True), parent_value)
    hi = torch.maximum(completed.amax(-1, keepdim=True), parent_value)
    qt = (completed - lo) / torch.clamp_min(hi - lo, 1e-8)
    pb_c = cfg.pb_c_init + torch.log(div_scalar(parent_visits + cfg.pb_c_base + 1.0, cfg.pb_c_base))
    puct = qt + pb_c * prior * torch.sqrt(torch.clamp_min(parent_visits, 1.0)) / (1.0 + child_visits)
    chance = prior / (1.0 + child_visits)
    score = torch.where(is_dec, puct, chance)
    score = torch.where(prior > 0, score, torch.full_like(score, NEG_INF))
    return score.argmax(-1)


def _traverse(tree: Tree, cfg: SearchConfig, max_depth: int):
    """Walk every search from the root to an unexpanded edge or the depth cap.

    Returns ``(parent, edge, existing, depth, path_nodes, path_edges)``:
    positions ``j < depth`` of the path arrays hold the traversed (node,
    edge) pairs, ``(parent, edge)`` is the last of them and ``existing`` the
    child index stored at it (UNVISITED unless the depth cap stopped the walk).
    """
    bsz = tree.node_value.shape[0]
    dev = tree.node_value.device
    b = torch.arange(bsz, device=dev)
    parent = torch.full((bsz,), ROOT, dtype=torch.int64, device=dev)
    edge = select_child(tree, parent, cfg)
    path_nodes = torch.zeros(bsz, max_depth, dtype=torch.int64, device=dev)
    path_edges = torch.zeros(bsz, max_depth, dtype=torch.int64, device=dev)
    path_edges[:, 0] = edge
    nxt = tree.children_index[b, parent, edge]
    depth = torch.ones(bsz, dtype=torch.int64, device=dev)
    for t in range(1, max_depth):
        live = nxt != UNVISITED
        if not bool(live.any()):
            break
        node = torch.where(live, nxt, parent)
        e = select_child(tree, node, cfg)
        parent = node
        edge = torch.where(live, e, edge)
        nxt = torch.where(live, tree.children_index[b, node, e], nxt)
        path_nodes[:, t] = torch.where(live, node, 0)
        path_edges[:, t] = torch.where(live, e, 0)
        depth = depth + live.to(torch.int64)
    return parent, edge, nxt, depth, path_nodes, path_edges


def _backup(tree: Tree, path_nodes, path_edges, depth, leaf, leaf_value) -> None:
    """Back ``leaf_value`` up the recorded paths, in place.

    Position ``j < depth`` is the pair (path_nodes[j], path_edges[j]);
    position ``depth`` is the leaf. Values v_j = r_{j+1} + γ_{j+1}·v_{j+1}
    (r, γ of the edge into the node at position j+1), v_depth = leaf_value;
    every node on the path takes v_j into its running mean and one visit;
    every edge takes one visit and Q = r + γ·V(child) with the child's new V.
    """
    bsz, p = path_nodes.shape
    n = tree.node_value.shape[1]
    dev = path_nodes.device
    b = torch.arange(bsz, device=dev)
    pos = torch.arange(p + 1, device=dev)
    ext = torch.cat([path_nodes, torch.zeros_like(path_nodes[:, :1])], dim=1)
    nodes = torch.where(pos < depth[:, None], ext, torch.where(pos == depth[:, None], leaf[:, None], n))
    safe = nodes.clamp(max=n - 1)
    rew = tree.node_reward.gather(1, safe)
    disc = tree.node_discount.gather(1, safe)

    values = torch.zeros(bsz, p + 1, dtype=torch.float32, device=dev)
    values[b, depth] = leaf_value
    for j in reversed(range(int(depth.max()))):
        values[:, j] = torch.where(j < depth, rew[:, j + 1] + disc[:, j + 1] * values[:, j + 1], values[:, j])

    bi, ji = (pos[None, :] <= depth[:, None]).nonzero(as_tuple=True)
    nd = nodes[bi, ji]
    old_visit = tree.node_visit[bi, nd]
    old_value = tree.node_value[bi, nd]
    tree.node_value[bi, nd] = (old_value * old_visit + values[bi, ji]) / (old_visit + 1.0)
    tree.node_visit[bi, nd] = old_visit + 1.0

    bi, ji = (pos[None, :p] < depth[:, None]).nonzero(as_tuple=True)
    nd, ed, cn = path_nodes[bi, ji], path_edges[bi, ji], nodes[bi, ji + 1]
    tree.children_visits[bi, nd, ed] += 1.0
    tree.children_values[bi, nd, ed] = tree.node_reward[bi, cn] + tree.node_discount[bi, cn] * tree.node_value[bi, cn]


def search_tree(
    root_embedding: torch.Tensor,
    root_prior: torch.Tensor,
    root_value: torch.Tensor,
    cfg: SearchConfig,
    transitions: TransitionFn,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run all simulations of B searches from their roots.

    ``root_embedding`` (B, H), ``root_prior`` (B, K) (noised, masked,
    zero-padded probabilities), ``root_value`` (B,) in raw space.
    ``transitions(parent_embedding (B, H), edge (B,))`` evaluates both
    transition types. Returns root visit counts (B, A) as float32, root Q
    (B, A) and the root value (B,).
    """
    check_supported(cfg)
    s = cfg.num_simulations
    a, k = cfg.num_actions, max(cfg.num_actions, cfg.codebook_size)
    max_depth = cfg.max_depth if cfg.max_depth is not None else s + 1
    max_depth = min(max_depth, s + 1)
    tree = init_tree(s + 1, k, root_embedding.to(torch.float32), root_prior, root_value)
    bsz = root_embedding.shape[0]
    b = torch.arange(bsz, device=root_embedding.device)

    def pad(probs: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(probs, (0, k - probs.shape[-1]))

    for sim in range(s):
        new_index = sim + 1
        parent, edge, existing, depth, path_nodes, path_edges = _traverse(tree, cfg, max_depth)
        is_dec = tree.is_decision[b, parent]
        out = transitions(tree.embedding[b, parent], edge)
        q_value = untransform(cfg, out.q_value)
        reward = untransform(cfg, out.reward)
        value = untransform(cfg, out.value)
        chance_prior = pad(softmax(div_scalar(out.chance_logits, cfg.prior_temperature)))
        action_prior = pad(softmax(div_scalar(out.action_logits, cfg.prior_temperature)))

        dec = is_dec[:, None]
        tree.embedding[:, new_index] = torch.where(dec, out.afterstate.to(torch.float32), out.hidden.to(torch.float32))
        tree.prior_probs[:, new_index] = torch.where(dec, chance_prior, action_prior)
        tree.is_decision[:, new_index] = ~is_dec
        tree.node_reward[:, new_index] = torch.where(is_dec, torch.zeros_like(reward), reward)
        tree.node_discount[:, new_index] = torch.where(
            is_dec, torch.ones_like(reward), torch.full_like(reward, cfg.discount)
        )
        model_value = torch.where(is_dec, q_value, value)

        # False only when the depth cap stopped traversal on an expanded edge:
        # that simulation backs up the existing child's current value, and the
        # row written at new_index above stays unreachable.
        needs_expand = existing == UNVISITED
        leaf = torch.where(needs_expand, torch.full_like(existing, new_index), existing)
        tree.children_index[b, parent, edge] = leaf
        leaf_value = torch.where(needs_expand, model_value, tree.node_value[b, existing.clamp(min=0)])
        _backup(tree, path_nodes, path_edges, depth, leaf, leaf_value)

    return tree.children_visits[:, ROOT, :a], tree.children_values[:, ROOT, :a], tree.node_value[:, ROOT]


def network_transitions(network, cfg: SearchConfig) -> TransitionFn:
    """Transition function from the network modules (φ, ψ, g, f)."""

    def transitions(parent_embedding: torch.Tensor, edge: torch.Tensor) -> Transitions:
        a, c = cfg.num_actions, cfg.codebook_size
        a_onehot = torch.nn.functional.one_hot(edge.clamp(max=a - 1), a).to(torch.float32)
        afterstate = network.afterstate_dynamics(parent_embedding, a_onehot)
        q_value, chance_logits = network.afterstate_prediction(afterstate)
        c_onehot = torch.nn.functional.one_hot(edge.clamp(max=c - 1), c).to(torch.float32)
        hidden, reward = network.dynamics(parent_embedding, c_onehot)
        action_logits, value = network.prediction(hidden)
        return Transitions(afterstate, q_value, chance_logits, hidden, reward, value, action_logits)

    return transitions


def root_inputs(
    network,
    observations: torch.Tensor,
    cfg: SearchConfig,
    invalid_actions: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Root h/f: ``(hidden (B, H) f32, priors (B, K) padded, value (B,) raw)``.

    Priors are softmax(logits / T), mixed with ``noise`` (B, A) as
    (1 − ρ)·π + ρ·noise when ``cfg.dirichlet_fraction > 0``, then zeroed on
    ``invalid_actions`` and renormalised.
    """
    hidden = network.representation(observations)
    root_logits, root_value = network.prediction(hidden)
    root_value = untransform(cfg, root_value)
    probs = softmax(div_scalar(root_logits, cfg.prior_temperature))
    if cfg.dirichlet_fraction > 0.0:
        if noise is None:
            raise ValueError("dirichlet_fraction > 0 needs the root noise tensor (B, A)")
        probs = (1.0 - cfg.dirichlet_fraction) * probs + cfg.dirichlet_fraction * noise
    if invalid_actions is not None:
        probs = torch.where(invalid_actions, torch.zeros_like(probs), probs)
        probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-12)
    k = max(cfg.num_actions, cfg.codebook_size)
    probs = torch.nn.functional.pad(probs, (0, k - probs.shape[-1]))
    return hidden.to(torch.float32), probs, root_value.to(torch.float32)


def policy_output(visits: torch.Tensor, qvalues: torch.Tensor, root_value: torch.Tensor) -> PolicyOutput:
    """Root statistics → :class:`PolicyOutput`."""
    total = visits.sum(-1, keepdim=True)
    return PolicyOutput(
        action_weights=visits / torch.clamp_min(total, 1.0),
        search_value=root_value,
        visit_counts=visits.to(torch.int32),
        qvalues=qvalues,
    )


@torch.no_grad()
def batched_run_mcts(
    network,
    observations: torch.Tensor,
    config: SearchConfig = SearchConfig(),
    invalid_actions: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> PolicyOutput:
    """B independent searches from ``observations`` (B, obs_dim), plain PyTorch."""
    check_supported(config)
    hidden, probs, root_value = root_inputs(network, observations, config, invalid_actions, noise)
    visits, qvalues, value = search_tree(hidden, probs, root_value, config, network_transitions(network, config))
    return policy_output(visits, qvalues, value)

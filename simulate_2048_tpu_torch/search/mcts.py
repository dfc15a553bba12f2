"""Batched stochastic MuZero search, in plain PyTorch.

Port of the JAX package's ``search/mcts.py``: PUCT at decision nodes; at
the root PUCT or Gumbel sequential halving (``root_selection``); at chance
nodes argmax p(c)/(1+N(c)) or a draw c ~ σ (``chance_selection``), either
under progressive widening (``pw_c``). It covers the depth cap, min-max
normalised Q, the raw-space value untransform and the edge/node backup, and
uses real indexing (gathers and scatters) where the JAX package uses one-hot
contractions. All B searches run in lockstep, one simulation at a time.

Every simulation evaluates both transition types at the selected edge —
φ then ψ (decision parent → chance child) and g then f (chance parent →
decision child) — and keeps the one the parent's type asks for, as the JAX
search and the whole-search kernel do. :func:`search_tree` takes the
transition function as an argument, so the same tree code serves the
network modules here and the packed weights of ``ops/search_kernel.py``'s
plain version.

Draws enter as tensors, so that a test can feed the JAX package's: the root
noise ``(B, A)`` (Dirichlet under the PUCT root, standard Gumbel under the
Gumbel root) and, for sampled chance selection, standard Gumbel draws per
(simulation, node), a table ``(B, S, S + 1, K)``. A draw c ~ σ is
argmax(g + log σ) over the allowed codes, as ``jax.random.categorical``
computes it. :func:`batched_run_mcts` draws what is not given from the
``torch.Generator`` passed in, the chance draws one ``(B, K)`` set per
traversal step.
"""

from __future__ import annotations

import math
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


def considered_visits_table(max_considered: int, num_simulations: int) -> tuple:
    """Sequential-halving visit schedule (Gumbel MuZero, Danihelka et al.
    ICLR 2022, §4), as in the JAX package.

    Row ``m`` is the per-simulation target visit count when ``m`` actions are
    under consideration: the simulation at index ``s`` visits an action whose
    current visit count equals ``row[s]``. The m considered actions are
    cycled round-robin and the set is halved every
    ``num_simulations / (log2(m) · m_phase)`` sweeps. Rows 0 and 1 are
    0, 1, 2, … (a single candidate is revisited every simulation).
    """

    def sequence(m: int) -> tuple:
        if m <= 1:
            return tuple(range(num_simulations))
        log2m = max(1, math.ceil(math.log2(m)))
        visits = [0] * m
        seq: list[int] = []
        considered = m
        while len(seq) < num_simulations:
            extra = max(1, num_simulations // (log2m * considered))
            for _ in range(extra):
                seq.extend(visits[:considered])
                for i in range(considered):
                    visits[i] += 1
            considered = max(2, considered // 2)
        return tuple(seq[:num_simulations])

    return tuple(sequence(m) for m in range(max_considered + 1))


def gumbel_draws(shape: tuple[int, ...], generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws −log(E), E ~ Exp(1), from ``generator``."""
    e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


def uses_root_noise(cfg: SearchConfig) -> bool:
    """Whether the root takes a noise tensor: Gumbel draws under the Gumbel
    root at a scale > 0, Dirichlet noise under PUCT at a fraction > 0."""
    if cfg.root_selection == "gumbel":
        return cfg.gumbel_scale > 0.0
    return cfg.dirichlet_fraction > 0.0


def draw_root_noise(cfg: SearchConfig, batch: int, generator: torch.Generator | None, device) -> torch.Tensor | None:
    """The root noise ``(batch, A)`` of ``cfg`` from ``generator`` (standard
    Gumbel or Dirichlet(α)), or None when the config takes none."""
    if not uses_root_noise(cfg):
        return None
    if cfg.root_selection == "gumbel":
        return gumbel_draws((batch, cfg.num_actions), generator, device)
    alpha = torch.full((batch, cfg.num_actions), cfg.dirichlet_alpha, dtype=torch.float32, device=device)
    return torch._sample_dirichlet(alpha, generator)


def untransform(cfg: SearchConfig, x: torch.Tensor) -> torch.Tensor:
    """h⁻¹ on network value/reward outputs, or identity."""
    eps = cfg.value_transform_epsilon
    return x if eps is None else inverse_scale_value(x, eps)


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """exp(x − max) / Σ, in the JAX package's operation order."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def select_child(
    tree: Tree, node: torch.Tensor, cfg: SearchConfig, draws: torch.Tensor | None = None
) -> torch.Tensor:
    """Edge to follow from ``node`` (B,) in each search: PUCT with min-max Q
    at decision nodes; at chance nodes argmax p/(1+N) or, with
    ``chance_selection="sample"``, argmax(``draws`` + log p) over the allowed
    codes (``draws`` (B, K) standard Gumbel), either under progressive
    widening when ``cfg.pw_c`` is set. Zero-prior slots are excluded; ties go
    to the first index."""
    b = torch.arange(node.shape[0], device=node.device)
    prior = tree.prior_probs[b, node]
    child_visits = tree.children_visits[b, node]
    q = tree.children_values[b, node]
    parent_visits = tree.node_visit[b, node][:, None]
    parent_value = tree.node_value[b, node][:, None]
    is_dec = tree.is_decision[b, node][:, None]
    legal = prior > 0
    neg_inf = torch.full_like(prior, NEG_INF)

    completed = torch.where(child_visits > 0, q, parent_value)
    lo = torch.minimum(completed.amin(-1, keepdim=True), parent_value)
    hi = torch.maximum(completed.amax(-1, keepdim=True), parent_value)
    qt = (completed - lo) / torch.clamp_min(hi - lo, 1e-8)
    pb_c = cfg.pb_c_init + torch.log(div_scalar(parent_visits + cfg.pb_c_base + 1.0, cfg.pb_c_base))
    puct = qt + pb_c * prior * torch.sqrt(torch.clamp_min(parent_visits, 1.0)) / (1.0 + child_visits)

    # Progressive widening: expanded children always; a new one only while
    # the node has fewer than ceil(pw_c · (N+1)^pw_alpha) (float32) of them.
    if cfg.pw_c is not None:
        expanded = tree.children_index[b, node] != UNVISITED
        n_expanded = expanded.sum(-1, keepdim=True)
        cap = torch.ceil(cfg.pw_c * torch.pow(parent_visits + 1.0, cfg.pw_alpha)).to(torch.int64)
        allow_new = n_expanded < torch.clamp_min(cap, 1)

    if cfg.chance_selection == "sample":
        if draws is None:
            raise ValueError("chance_selection='sample' needs the chance draws")
        allowed = legal
        if cfg.pw_c is not None:
            allowed = legal & (expanded | allow_new)
            allowed = torch.where(allowed.any(-1, keepdim=True), allowed, legal)  # degenerate guard
        logits = torch.where(allowed, torch.log(torch.clamp_min(prior, 1e-30)), neg_inf)
        chance_pick = (draws + logits).argmax(-1)
        decision_pick = torch.where(legal, puct, neg_inf).argmax(-1)
        return torch.where(is_dec[:, 0], decision_pick, chance_pick)

    chance = prior / (1.0 + child_visits)
    if cfg.pw_c is not None:
        # Unexpanded codes compete only through the best-prior one, while allowed.
        best_unexpanded = torch.where(expanded, neg_inf, prior).argmax(-1, keepdim=True)
        slots = torch.arange(prior.shape[-1], device=prior.device)
        candidate = expanded | (allow_new & (slots == best_unexpanded))
        candidate = candidate | ~candidate.any(-1, keepdim=True)  # degenerate guard
        chance = torch.where(candidate, chance, neg_inf)
    score = torch.where(is_dec, puct, chance)
    score = torch.where(legal, score, neg_inf)
    return score.argmax(-1)


def _gumbel_sigma(prior, visits, q, parent_value, cfg: SearchConfig):
    """Legality, log π and σ(q̂) = (c_visit + max N)·c_scale·q̂ at the root,
    q̂ the min-max normalised completed Q (the root's current value where an
    action has no visit)."""
    legal = prior > 0
    completed = torch.where(visits > 0, q, parent_value)
    lo = torch.minimum(completed.amin(-1, keepdim=True), parent_value)
    hi = torch.maximum(completed.amax(-1, keepdim=True), parent_value)
    qn = (completed - lo) / torch.clamp_min(hi - lo, 1e-8)
    sigma = (cfg.gumbel_c_visit + visits.amax(-1, keepdim=True)) * cfg.gumbel_c_scale * qn
    return legal, torch.log(torch.clamp_min(prior, 1e-30)), sigma


def gumbel_root_action(
    tree: Tree, cfg: SearchConfig, gumbel: torch.Tensor, sim: int, table: torch.Tensor
) -> torch.Tensor:
    """Root action (B,) of simulation ``sim`` under sequential halving: among
    the legal actions whose current visit count equals the scheduled
    ``table[min(num_legal, A), sim]``, the one maximising g + log π + σ(q̂);
    with no such action, the best legal score (then slot 0)."""
    a = cfg.num_actions
    visits = tree.children_visits[:, ROOT, :a]
    legal, log_prior, sigma = _gumbel_sigma(
        tree.prior_probs[:, ROOT, :a], visits, tree.children_values[:, ROOT, :a], tree.node_value[:, ROOT, None], cfg
    )
    score = gumbel + log_prior + sigma
    target = table[legal.sum(-1).clamp_max(table.shape[0] - 1), sim]
    cand = legal & (visits == target[:, None])
    neg_inf = torch.full_like(score, NEG_INF)
    picked = torch.where(cand, score, neg_inf).argmax(-1)
    fallback = torch.where(legal, score, neg_inf).argmax(-1)
    return torch.where(cand.any(-1), picked, fallback)


def gumbel_improved_policy(
    prior: torch.Tensor, visits: torch.Tensor, qvalues: torch.Tensor, root_value: torch.Tensor, cfg: SearchConfig
) -> torch.Tensor:
    """π′ = softmax(log π + σ(q̂)) over the legal root actions (B, A): the
    Gumbel root's ``action_weights``, from the root's prior, visits, Q and
    value at the end of the search."""
    legal, log_prior, sigma = _gumbel_sigma(prior, visits, qvalues, root_value[:, None], cfg)
    return softmax(torch.where(legal, log_prior + sigma, torch.full_like(sigma, NEG_INF)))


def _traverse(tree: Tree, cfg: SearchConfig, max_depth: int, root_action=None, draws=None):
    """Walk every search from the root to an unexpanded edge or the depth cap.

    ``root_action`` (B,), when given, replaces the first pick (the Gumbel
    root); ``draws(node)`` gives the chance draws (B, K) at the nodes of one
    step (sampled chance selection). Returns ``(parent, edge, existing,
    depth, path_nodes, path_edges)``: positions ``j < depth`` of the path
    arrays hold the traversed (node, edge) pairs, ``(parent, edge)`` is the
    last of them and ``existing`` the child index stored at it (UNVISITED
    unless the depth cap stopped the walk).
    """
    bsz = tree.node_value.shape[0]
    dev = tree.node_value.device

    def pick(node):
        return select_child(tree, node, cfg, None if draws is None else draws(node))

    b = torch.arange(bsz, device=dev)
    parent = torch.full((bsz,), ROOT, dtype=torch.int64, device=dev)
    edge = pick(parent) if root_action is None else root_action
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
        e = pick(node)
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


def run_simulations(
    root_embedding: torch.Tensor,
    root_prior: torch.Tensor,
    root_value: torch.Tensor,
    cfg: SearchConfig,
    transitions: TransitionFn,
    gumbel: torch.Tensor | None = None,
    chance_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tree:
    """Run all simulations of B searches from their roots; returns the trees.

    ``root_embedding`` (B, H), ``root_prior`` (B, K) (noised, masked,
    zero-padded probabilities), ``root_value`` (B,) in raw space.
    ``transitions(parent_embedding (B, H), edge (B,))`` evaluates both
    transition types. Under the Gumbel root, ``gumbel`` (B, A) holds
    standard Gumbel draws, scaled here by ``cfg.gumbel_scale`` (scale 0: no
    noise, none needed). Sampled chance selection reads ``chance_noise``
    (B, S, S + 1, K) at (simulation, node), or draws from ``generator``.
    """
    s = cfg.num_simulations
    a, k = cfg.num_actions, max(cfg.num_actions, cfg.codebook_size)
    max_depth = cfg.max_depth if cfg.max_depth is not None else s + 1
    max_depth = min(max_depth, s + 1)
    tree = init_tree(s + 1, k, root_embedding.to(torch.float32), root_prior, root_value)
    bsz = root_embedding.shape[0]
    dev = root_embedding.device
    b = torch.arange(bsz, device=dev)

    def pad(probs: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(probs, (0, k - probs.shape[-1]))

    gumbel_root = cfg.root_selection == "gumbel"
    if gumbel_root:
        # One draw per search, fixed across its simulations: the halving bracket is one tournament.
        if cfg.gumbel_scale <= 0.0:
            gumbel = torch.zeros(bsz, a, dtype=torch.float32, device=dev)
        elif gumbel is None:
            raise ValueError("the Gumbel root needs its draws (B, A)")
        else:
            gumbel = cfg.gumbel_scale * gumbel.to(torch.float32)
        table = torch.tensor(considered_visits_table(a, s), dtype=torch.int64, device=dev)
    if cfg.chance_selection == "sample" and chance_noise is None and generator is None:
        raise ValueError("chance_selection='sample' needs the chance draws (B, S, S + 1, K) or a generator")

    for sim in range(s):
        new_index = sim + 1
        root_action = gumbel_root_action(tree, cfg, gumbel, sim, table) if gumbel_root else None
        draws = None
        if cfg.chance_selection == "sample":
            if chance_noise is not None:
                draws = lambda node, sim=sim: chance_noise[b, sim, node]  # noqa: E731
            else:
                draws = lambda node: gumbel_draws((bsz, k), generator, dev)  # noqa: E731
        parent, edge, existing, depth, path_nodes, path_edges = _traverse(tree, cfg, max_depth, root_action, draws)
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
    return tree


def search_tree(
    root_embedding: torch.Tensor,
    root_prior: torch.Tensor,
    root_value: torch.Tensor,
    cfg: SearchConfig,
    transitions: TransitionFn,
    gumbel: torch.Tensor | None = None,
    chance_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`run_simulations`' root statistics: visit counts (B, A) as
    float32, root Q (B, A) and the root value (B,)."""
    tree = run_simulations(root_embedding, root_prior, root_value, cfg, transitions, gumbel, chance_noise, generator)
    a = cfg.num_actions
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

    Priors are softmax(logits / T), mixed with the Dirichlet ``noise`` (B, A)
    as (1 − ρ)·π + ρ·noise when ``cfg.dirichlet_fraction > 0`` under the
    PUCT root (the Gumbel root takes Gumbel noise in the search instead),
    then zeroed on ``invalid_actions`` and renormalised.
    """
    hidden = network.representation(observations)
    root_logits, root_value = network.prediction(hidden)
    root_value = untransform(cfg, root_value)
    probs = softmax(div_scalar(root_logits, cfg.prior_temperature))
    if cfg.dirichlet_fraction > 0.0 and cfg.root_selection != "gumbel":
        if noise is None:
            raise ValueError("dirichlet_fraction > 0 needs the root noise tensor (B, A)")
        probs = (1.0 - cfg.dirichlet_fraction) * probs + cfg.dirichlet_fraction * noise
    if invalid_actions is not None:
        probs = torch.where(invalid_actions, torch.zeros_like(probs), probs)
        probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-12)
    k = max(cfg.num_actions, cfg.codebook_size)
    probs = torch.nn.functional.pad(probs, (0, k - probs.shape[-1]))
    return hidden.to(torch.float32), probs, root_value.to(torch.float32)


def policy_output(
    visits: torch.Tensor,
    qvalues: torch.Tensor,
    root_value: torch.Tensor,
    cfg: SearchConfig | None = None,
    root_prior: torch.Tensor | None = None,
) -> PolicyOutput:
    """Root statistics → :class:`PolicyOutput`. The action weights are the
    visit distribution, or under the Gumbel root (``cfg``) the improved
    policy over ``root_prior`` (B, ≥ A), since halving concentrates the visits
    on the bracket's winner."""
    if cfg is not None and cfg.root_selection == "gumbel":
        weights = gumbel_improved_policy(root_prior[:, : visits.shape[-1]], visits, qvalues, root_value, cfg)
    else:
        weights = visits / torch.clamp_min(visits.sum(-1, keepdim=True), 1.0)
    return PolicyOutput(
        action_weights=weights,
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
    chance_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PolicyOutput:
    """B independent searches from ``observations`` (B, obs_dim), plain
    PyTorch. ``noise`` (B, A) is the root noise: Dirichlet under the PUCT
    root, standard Gumbel under the Gumbel root; drawn from ``generator``
    when not given. ``chance_noise``: see :func:`search_tree`."""
    gumbel_root = config.root_selection == "gumbel"
    if noise is None and generator is not None:
        noise = draw_root_noise(config, observations.shape[0], generator, observations.device)
    hidden, probs, root_value = root_inputs(network, observations, config, invalid_actions, noise)
    visits, qvalues, value = search_tree(
        hidden, probs, root_value, config, network_transitions(network, config),
        noise if gumbel_root else None, chance_noise, generator,
    )  # fmt: skip
    return policy_output(visits, qvalues, value, config, probs)

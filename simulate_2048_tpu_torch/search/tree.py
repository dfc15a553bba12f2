"""Batched fixed-size array tree for stochastic MCTS, in PyTorch.

Port of the JAX package's ``search/tree.py`` with the batch dimension written
out: one struct of ``(B, ...)`` tensors holds B independent searches, with
interleaved decision and chance nodes.

- capacity ``N = num_simulations + 1`` — each simulation expands one node;
- ``K = max(action_size, codebook_size)`` child slots for both node types
  (decision nodes use [0, A), chance nodes [0, C); padded slots have prior 0);
- edge statistics (visits, Q) are stored densely per parent slot and
  refreshed in backup; the reward and discount of the edge INTO a node are
  stored per node.

Visit counts are kept as float32, as the whole-search kernel keeps them; they
stay exact integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

UNVISITED = -1
ROOT = 0
NEG_INF = -1e9


class Tree(NamedTuple):
    """Struct-of-arrays trees of B searches (updated in place by the search)."""

    embedding: torch.Tensor  # (B, N, H) hidden state (decision) or afterstate (chance)
    is_decision: torch.Tensor  # (B, N) bool
    node_value: torch.Tensor  # (B, N) running mean of backed-up values
    node_visit: torch.Tensor  # (B, N)
    prior_probs: torch.Tensor  # (B, N, K) probabilities, 0 on padded slots
    children_index: torch.Tensor  # (B, N, K) int64, UNVISITED where unexpanded
    children_visits: torch.Tensor  # (B, N, K)
    children_values: torch.Tensor  # (B, N, K) Q(edge) = r + γ·V(child)
    node_reward: torch.Tensor  # (B, N) reward on the edge INTO this node
    node_discount: torch.Tensor  # (B, N) discount on the edge INTO this node


def init_tree(
    num_nodes: int, width: int, root_embedding: torch.Tensor, root_prior_probs: torch.Tensor, root_value: torch.Tensor
) -> Tree:
    """Allocate B trees and install each root as node 0 (a decision node)."""
    b, h = root_embedding.shape
    n, k = num_nodes, width
    kw = dict(dtype=torch.float32, device=root_embedding.device)
    embedding = torch.zeros(b, n, h, **kw)
    embedding[:, ROOT] = root_embedding
    is_decision = torch.zeros(b, n, dtype=torch.bool, device=root_embedding.device)
    is_decision[:, ROOT] = True
    node_value = torch.zeros(b, n, **kw)
    node_value[:, ROOT] = root_value
    node_visit = torch.zeros(b, n, **kw)
    node_visit[:, ROOT] = 1.0
    prior = torch.zeros(b, n, k, **kw)
    prior[:, ROOT, : root_prior_probs.shape[-1]] = root_prior_probs
    return Tree(
        embedding=embedding,
        is_decision=is_decision,
        node_value=node_value,
        node_visit=node_visit,
        prior_probs=prior,
        children_index=torch.full((b, n, k), UNVISITED, dtype=torch.int64, device=root_embedding.device),
        children_visits=torch.zeros(b, n, k, **kw),
        children_values=torch.zeros(b, n, k, **kw),
        node_reward=torch.zeros(b, n, **kw),
        node_discount=torch.ones(b, n, **kw),
    )

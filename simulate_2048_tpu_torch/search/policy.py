"""Policy extraction from search results, in PyTorch (the evaluation subset
of the JAX package's ``search/policy.py``)."""

from __future__ import annotations

import torch

from simulate_2048_tpu_torch.search.mcts import PolicyOutput


def get_policy_target(policy_output: PolicyOutput, legal_mask: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Visit distribution → policy target over legal actions.

    Log-space temperature softmax; greedy one-hot when ``temperature < 0.01``.
    """
    weights = torch.where(legal_mask, policy_output.action_weights, torch.zeros_like(policy_output.action_weights))
    if temperature < 0.01:
        return torch.nn.functional.one_hot(weights.argmax(-1), weights.shape[-1]).to(weights.dtype)
    logits = torch.log(weights + 1e-8) / max(temperature, 0.01)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)

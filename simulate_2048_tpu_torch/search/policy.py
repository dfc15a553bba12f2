"""Policy extraction and action selection from search results, in PyTorch
(port of the JAX package's ``search/policy.py``). Every function is batched:
``PolicyOutput`` fields carry a leading batch dimension. Draws come from the
``torch.Generator`` passed in, or from an explicit ``uniform`` tensor so that
a test can feed both packages the same numbers."""

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


def sample_from_visits(
    policy_output: PolicyOutput,
    legal_mask: torch.Tensor,
    temperature: torch.Tensor | float,
    generator: torch.Generator | None = None,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """Action per game from root visit weights: argmax where the game's
    temperature is below 0.01, else a categorical draw over
    ``log(w + 1e-8) / max(T, 0.01)``. ``temperature`` is a scalar or (B,).
    The draw inverts the cumulative distribution at ``uniform`` (B,) in
    [0, 1), drawn from ``generator`` when not given."""
    weights = torch.where(legal_mask, policy_output.action_weights, torch.zeros_like(policy_output.action_weights))
    greedy = weights.argmax(-1)
    if isinstance(temperature, (int, float)) and temperature < 0.01:
        return greedy
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=weights.device).expand(greedy.shape)
    logits = torch.log(weights + 1e-8) / torch.clamp_min(temperature, 0.01)[:, None]
    probs = torch.softmax(logits, dim=-1)
    if uniform is None:
        uniform = torch.rand(greedy.shape, generator=generator, device=weights.device)
    cdf = probs.cumsum(-1)
    sampled = (uniform[:, None] * cdf[:, -1:] >= cdf).sum(-1).clamp_max(weights.shape[-1] - 1)
    return torch.where(temperature < 0.01, greedy, sampled)


def select_action(
    policy_output: PolicyOutput,
    legal_mask: torch.Tensor,
    temperature: float = 1.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Sample an action from the policy target at ``temperature`` (argmax below 0.01)."""
    policy = get_policy_target(policy_output, legal_mask, temperature)
    if temperature < 0.01:
        return policy.argmax(-1)
    return torch.multinomial(policy, 1, generator=generator).squeeze(-1)


def get_search_value(policy_output: PolicyOutput) -> torch.Tensor:
    """Backed-up root value."""
    return policy_output.search_value


def get_visit_counts(policy_output: PolicyOutput) -> torch.Tensor:
    """Raw root visit counts."""
    return policy_output.visit_counts


def get_q_values(policy_output: PolicyOutput) -> torch.Tensor:
    """Root Q values."""
    return policy_output.qvalues


# The port's functions are batched already; the JAX package's vmapped names stay as aliases.
batched_select_action = select_action
batched_get_policy_target = get_policy_target
batched_get_search_value = get_search_value


def temperature_schedule(step: int, schedule) -> float:
    """Piecewise-constant schedule lookup."""
    temperature = schedule[0][1]
    for threshold, temp in schedule:
        if step >= threshold:
            temperature = temp
    return temperature

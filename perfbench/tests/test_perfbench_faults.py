"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program at a tiny size on the CPU, and the rest
of the run (the harness without its look for a chip) is driven as it is:
a move that returns the state unchanged, half of the batch left out of the
search (its results copied from the other half), and a search's answer
altered where it is produced. The exchange between chips is no fault a
one-chip cell can have.
"""

import pytest
import torch

from perfbench.tests.conftest import run_tiny, tiny_cell
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.ops import search_kernel

CELLS = ["appendix_c.selfplay", "capacity_probe.selfplay", "capacity_probe.deep_eval"]


def _unchanged_step(state, action):
    zero = torch.zeros_like(state.total_reward)
    return state, zero, state.done, {}


def _half_batch(inner):
    def search(root_h, root_p, root_v, packed, cfg, workspace=None):
        half = (root_h.shape[0] + 1) // 2
        visits, q, value = inner(root_h[:half], root_p[:half], root_v[:half], packed, cfg, workspace)
        fill = lambda x: torch.cat([x, x[: root_h.shape[0] - half]])  # noqa: E731
        return fill(visits), fill(q), fill(value)

    return search


def _altered(inner):
    def search(root_h, root_p, root_v, packed, cfg, workspace=None):
        visits, q, value = inner(root_h, root_p, root_v, packed, cfg, workspace)
        return visits.roll(1, -1), q, value

    return search


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_answer"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    assert run_tiny(cell)["correct"] is True
    if fault == "unchanged_step":
        monkeypatch.setattr(envlib, "step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(search_kernel, "whole_search", _half_batch(search_kernel.whole_search))
    else:
        monkeypatch.setattr(search_kernel, "whole_search", _altered(search_kernel.whole_search))
    result = run_tiny(cell)
    assert result["correct"] is False
    failed = [k for k, v in result["checks"].items() if v["value"] != v["value"] or v["value"] > v["limit"]]
    assert failed



def test_searches_outside_the_recorded_call_are_not_correct(monkeypatch):
    """A self-play loop whose searches stop going through the call the check
    records leaves it nothing to compare: not correct, and no crash."""
    from simulate_2048_tpu_torch.search.mcts import batched_run_mcts
    from simulate_2048_tpu_torch.training import self_play

    inner = self_play._make_search

    def make_search(network, config, cfg, device):
        kernel, moves = inner(network, config, cfg, device), []

        def search(obs, invalid, noise=None, chance_noise=None, generator=None):
            moves.append(1)
            if len(moves) % 2:
                return kernel(obs, invalid, noise, chance_noise, generator)
            return batched_run_mcts(network, obs, cfg, invalid, noise, chance_noise, generator)

        return search

    monkeypatch.setattr(self_play, "_make_search", make_search)
    result = run_tiny(tiny_cell("appendix_c.selfplay"))
    assert result["correct"] is False

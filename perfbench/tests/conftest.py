"""Fixtures of the benchmark's tests: tiny cells on the CPU, and the card marker.

Tests marked ``card`` need a CUDA device; the ``card`` fixture skips them
when there is none, decided when the test runs, never at import.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from perfbench import run as run_mod
from perfbench.harness import spec

# The cells' shapes cut to what a test on the CPU holds: the search and the
# kernel's plain version instead of the CUDA kernel ("pallas" on the CPU).
TINY = dict(hidden_size=32, num_residual_blocks=1, num_simulations=8, num_parallel_games=8,
            max_trajectory_length=12, replay_buffer_size=64, deep_eval_games=8, eval_max_moves=60,
            search_backend="pallas")  # fmt: skip
SEED = 2**31 + 11


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip: python -m pytest perfbench/tests)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny_cell(name: str, **overrides):
    cell = spec.load_cell(name)
    return dataclasses.replace(cell, config={**cell.config, **TINY, **overrides})


def run_tiny(cell, trace: bool = False, seed: int = SEED, seconds: float = 0.5) -> dict:
    return run_mod.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())

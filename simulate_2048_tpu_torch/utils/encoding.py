"""Observation encoders and reward normalization (host side).

API parity with the reference's ``twentyfortyeight/utils/binary.py`` and
``utils/normalize.py``: per-cell one-hot of log2(value) and logarithmic
reward compression.
"""

from __future__ import annotations

import numpy as np


def encode(state: np.ndarray, encodage_size: int) -> np.ndarray:
    """One-hot encode log2 of each cell (``binary.py:11-49``).

    Empty cells (0) and 1-tiles both land on index 0, matching the reference's
    ``log2(…, where=obs != 0)`` behavior. Output shape: state.shape + (encodage_size,)
    collapsed to (state.size, encodage_size) for 1D input.
    """
    obs = state.astype(np.float64)
    obs = np.log2(obs, where=obs != 0, out=obs)
    idx = obs.astype(np.int64, copy=False)
    return np.eye(encodage_size, dtype=np.int64)[idx]


def encode_flatten(state: np.ndarray, encodage_size: int) -> np.ndarray:
    """Flatten then one-hot encode; 1D output (``binary.py:52-86``)."""
    return encode(state.ravel().astype(np.float64), encodage_size).ravel()


def normalize_reward(reward: float, max_tile: int = 2 ** (4**2)) -> float:
    """log2(reward)/log2(max_tile), 0 maps to 0 (``normalize.py:6-33``)."""
    if reward == 0:
        return 0.0
    return float(np.log2(reward) / np.log2(max_tile))

"""Stateful scalar 2048 environment (host side).

API parity with the reference's ``twentyfortyeight/envs/twentyfortyeight.py``:
reset spawns two tiles, step returns (observation, reward, done), optional
binary-encoded observations and log-normalized rewards.
"""

from __future__ import annotations

import numpy as np

from simulate_2048_tpu_torch.engine.board import fill_cells, is_done, next_state
from simulate_2048_tpu_torch.utils.encoding import encode_flatten, normalize_reward

# Action names → indices (``twentyfortyeight.py:19``).
ACTIONS = {"left": 0, "up": 1, "right": 2, "down": 3}


class TwentyFortyEight:
    """Stateful 2048 game: reset / step / render (``twentyfortyeight.py:10-141``)."""

    ACTIONS = ACTIONS

    def __init__(self, size: int = 4, encoded: bool = False, normalize: bool = False):
        self.size = size
        self._encoded = encoded
        self._normalize = normalize
        self._current_state: np.ndarray = np.zeros((size, size), dtype=np.int64)
        self._current_reward: float = 0.0
        self.reset()

    @property
    def is_finished(self) -> bool:
        """True when no move changes the board."""
        return is_done(self._current_state)

    @property
    def observation(self) -> np.ndarray:
        """Raw board, or its 31-wide per-cell one-hot when ``encoded=True``."""
        if self._encoded:
            return encode_flatten(self._current_state, encodage_size=31)
        return self._current_state

    @property
    def reward(self) -> float:
        """Last step's reward, log-normalized when ``normalize=True``."""
        if self._normalize:
            return normalize_reward(self._current_reward)
        return self._current_reward

    def reset(self, seed: int | None = None) -> np.ndarray:
        """Empty board + two spawned tiles; returns the observation."""
        self._current_state = np.zeros((self.size, self.size), dtype=np.int64)
        self._current_state = fill_cells(self._current_state, number_tile=2, seed=seed)
        self._current_reward = 0.0
        return self.observation

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        """Apply an action; returns (observation, reward, done)."""
        self._current_state, self._current_reward = next_state(self._current_state, action)
        return self.observation, self.reward, self.is_finished

    def render(self) -> None:
        """Print the board to stdout."""
        for row in self._current_state.tolist():
            print(" \t".join(map(str, row)))

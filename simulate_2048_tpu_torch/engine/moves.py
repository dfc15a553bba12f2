"""Legal/illegal move detection on scalar NumPy boards (value representation).

API parity with the reference's ``twentyfortyeight/core/gamemove.py``:
an action is legal iff it would change the board, detected by a single
adjacency pass (no rotations, no slides).
"""

from __future__ import annotations

import numpy as np


def legal_actions_mask(state: np.ndarray) -> tuple[bool, bool, bool, bool]:
    """(left, up, right, down) legality via one adjacency pass.

    Mirrors ``gamemove.py:45-83``: a direction is legal when some tile can
    slide into an empty neighbor or merge with an equal neighbor.
    """
    left_cols, right_cols = state[:, :-1], state[:, 1:]
    top_rows, bottom_rows = state[:-1, :], state[1:, :]

    h_merge = (left_cols != 0) & (left_cols == right_cols)
    v_merge = (top_rows != 0) & (top_rows == bottom_rows)

    left = bool(((left_cols == 0) & (right_cols != 0)).any() or h_merge.any())
    right = bool(((right_cols == 0) & (left_cols != 0)).any() or h_merge.any())
    up = bool(((top_rows == 0) & (bottom_rows != 0)).any() or v_merge.any())
    down = bool(((bottom_rows == 0) & (top_rows != 0)).any() or v_merge.any())
    return (left, up, right, down)


def legal_actions(state: np.ndarray) -> list[int]:
    """Indices of actions that change the board (``gamemove.py:109``)."""
    mask = legal_actions_mask(state)
    return [i for i in range(4) if mask[i]]


def illegal_actions(state: np.ndarray) -> list[int]:
    """Indices of actions that leave the board unchanged (``gamemove.py:86``)."""
    mask = legal_actions_mask(state)
    return [i for i in range(4) if not mask[i]]


def can_move(board: np.ndarray) -> bool:
    """Whether a LEFT slide changes the board (``gamemove.py:132-164``).

    Used by :func:`engine.board.next_state` on the pre-rotated board.
    """
    left_cols, right_cols = board[:, :-1], board[:, 1:]
    if ((left_cols == 0) & (right_cols != 0)).any():
        return True
    return bool(((left_cols != 0) & (left_cols == right_cols)).any())

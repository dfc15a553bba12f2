"""Scalar NumPy board logic (value representation: 0, 2, 4, 8, …).

Public surface mirrors the reference's ``twentyfortyeight/core/gameboard.py``
(functions and semantics cited inline), with one addition: the
``*_counter`` variants drive spawns through the counter-based Threefry spec
(``engine.rng``), making this engine a bitwise oracle for the port's batched
engine (``ops/board.py``, ``ops/rng.py``).
"""

from __future__ import annotations

import numpy as np

from simulate_2048_tpu_torch.engine.moves import can_move
from simulate_2048_tpu_torch.engine.rng import FOUR_THRESHOLD, spawn_bits_np

# 90% chance of a 2, 10% chance of a 4 (``gameboard.py:13``).
TILE_SPAWN_PROBS: dict[int, float] = {2: 0.9, 4: 0.1}
_TILE_VALUES = np.array([2, 4])
_TILE_PROBS = np.array([0.9, 0.1])

# Module-level generator for the seedless convenience path (``gameboard.py:20``).
# Deliberately OUTSIDE the spawn-RNG spec (``ops/rng.py``): it backs only
# interactive play (`fill_cells(seed=None)`); every parity path routes through
# the ``*_counter`` variants. Pass ``rng=`` to make the stream explicit.
_GENERATOR = np.random.default_rng(np.random.PCG64DXSM())


def merge_column(column: np.ndarray) -> tuple[int, np.ndarray]:
    """Merge one line toward its start; returns (score, merged line).

    Reference semantics (``gameboard.py:23-69``): zeros dropped first, each
    tile merges at most once, scanning start→end, score = sum of tiles created.
    The merged line is returned WITHOUT zero padding (caller pads), exactly
    like the reference.
    """
    non_zero = column[column != 0]
    if len(non_zero) <= 1:
        return 0, non_zero

    out: list[int] = []
    score = 0
    i = 0
    while i < len(non_zero) - 1:
        if non_zero[i] == non_zero[i + 1]:
            merged = int(non_zero[i]) * 2
            out.append(merged)
            score += merged
            i += 2
        else:
            out.append(int(non_zero[i]))
            i += 1
    if i == len(non_zero) - 1:
        out.append(int(non_zero[-1]))
    return score, np.array(out, dtype=column.dtype)


def slide_and_merge(board: np.ndarray) -> tuple[float, np.ndarray]:
    """Slide the whole board left; returns (score, new board) (``gameboard.py:72-102``)."""
    result = np.zeros_like(board)
    score = 0.0
    for i, row in enumerate(board):
        row_score, merged = merge_column(row)
        score += row_score
        result[i, : len(merged)] = merged
    return score, result


def latent_state(state: np.ndarray, action: int) -> tuple[np.ndarray, float]:
    """Afterstate: apply ``action`` without spawning (``gameboard.py:105-129``).

    Actions: 0=left, 1=up, 2=right, 3=down, via rot90(k=action) → slide left.
    """
    rotated = np.rot90(state, k=action)
    reward, updated = slide_and_merge(rotated)
    return np.rot90(updated, k=-action), reward


def after_state(state: np.ndarray) -> list[tuple[np.ndarray, float]]:
    """All (successor, probability) pairs over spawn outcomes (``gameboard.py:132-171``).

    P(state with value v at empty cell c) = P(v) / num_empty; a full board
    yields [(state, 1.0)].
    """
    empty_cells = np.argwhere(state == 0)
    n = len(empty_cells)
    if n == 0:
        return [(state, 1.0)]
    outcomes = []
    for cell in empty_cells:
        for value in (2, 4):
            nxt = state.copy()
            nxt[tuple(cell)] = value
            outcomes.append((nxt, TILE_SPAWN_PROBS[value] / n))
    return outcomes


def after_state_lazy(state: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]], int]:
    """Zero-copy afterstate enumeration setup (``gameboard.py:174-202``).

    Returns (base state, empty-cell coordinates, count) for on-demand outcome
    generation via :func:`generate_outcome` — the progressive-widening path.
    """
    empty_cells = np.argwhere(state == 0)
    return state, [(int(c[0]), int(c[1])) for c in empty_cells], len(empty_cells)


def generate_outcome(
    state: np.ndarray, cell: tuple[int, int], value: int, num_empty: int
) -> tuple[np.ndarray, float]:
    """One spawn outcome on demand (``gameboard.py:205-244``). Raises on num_empty<=0."""
    if num_empty <= 0:
        raise ValueError(f"num_empty must be > 0, got {num_empty}")
    nxt = state.copy()
    nxt[cell] = value
    return nxt, TILE_SPAWN_PROBS[value] / num_empty


def fill_cells(
    state: np.ndarray,
    number_tile: int,
    seed: int | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Spawn ``number_tile`` tiles in-place with NumPy RNG (``gameboard.py:247-288``).

    Convenience path for interactive play; NOT the parity path (see
    :func:`fill_cells_counter`). Stream resolution: an explicit ``rng`` wins,
    then a fresh ``default_rng(seed)``, then the module-level generator.
    """
    if rng is None:
        rng = np.random.default_rng(seed) if seed is not None else _GENERATOR
    available = np.argwhere(state == 0)
    n = len(available)
    if n == 0:
        return state
    number_tile = min(number_tile, n)
    values = rng.choice(_TILE_VALUES, size=number_tile, p=_TILE_PROBS)
    chosen = rng.choice(n, size=number_tile, replace=False)
    state[tuple(available[chosen].T)] = values
    return state


def fill_cells_counter(state: np.ndarray, game_seed: int, spawn_index: int) -> np.ndarray:
    """Spawn ONE tile via the counter-based spec — bitwise equal to the device
    path ``ops.board.spawn_tile`` fed by ``ops.rng.spawn_bits``.

    Cell = the ``mulhi32(bits0, num_empty)``-th empty cell in row-major order
    (floor(bits0·n/2³²), the spec's uniform pick — see ``ops.board.spawn_rank``);
    value = 4 iff bits1 < FOUR_THRESHOLD else 2. Mutates and returns ``state``.
    """
    empties = np.argwhere(state == 0)  # argwhere is row-major ordered
    n = len(empties)
    if n == 0:
        return state
    b0, b1 = spawn_bits_np(np.uint32(game_seed), np.uint32(spawn_index))
    rank = (int(b0) * n) >> 32
    cell = empties[rank]
    state[tuple(cell)] = 4 if int(b1) < int(FOUR_THRESHOLD) else 2
    return state


def next_state(
    state: np.ndarray,
    action: int,
    seed: int | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, float]:
    """Full transition with NumPy RNG spawn (``gameboard.py:291-325``).

    Invalid action ⇒ unchanged board, reward 0, no spawn. ``seed``/``rng``
    resolve as in :func:`fill_cells`.
    """
    rotated = np.rot90(state, k=action)
    if can_move(rotated):
        reward, updated = slide_and_merge(rotated)
        state = np.rot90(updated, k=-action)
        state = fill_cells(state, number_tile=1, seed=seed, rng=rng)
        return state, reward
    return state, 0


def next_state_counter(
    state: np.ndarray, action: int, game_seed: int, spawn_index: int
) -> tuple[np.ndarray, float, bool]:
    """Full transition through the counter-based spec (the parity path).

    Returns (new state, reward, moved); a spawn index is consumed only when
    ``moved`` is True, mirroring ``ops.board.next_state``.
    """
    rotated = np.rot90(state, k=action)
    if can_move(rotated):
        reward, updated = slide_and_merge(rotated)
        out = np.rot90(updated, k=-action).copy()
        out = fill_cells_counter(out, game_seed, spawn_index)
        return out, float(reward), True
    return state, 0.0, False


def create_initial_board_counter(game_seed: int) -> np.ndarray:
    """Fresh board with spawns 0 and 1 — mirror of ``ops.board.create_initial_board``."""
    board = np.zeros((4, 4), dtype=np.int64)
    fill_cells_counter(board, game_seed, 0)
    fill_cells_counter(board, game_seed, 1)
    return board


def is_done(state: np.ndarray) -> bool:
    """Game over: board full and no equal adjacent pair (``gameboard.py:328-348``)."""
    return bool(
        np.all(state != 0)
        and not np.any(state[:-1] == state[1:])
        and not np.any(state[:, :-1] == state[:, 1:])
    )

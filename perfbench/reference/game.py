"""2048 as the benchmark's reference plays it: NumPy on the host.

Written from the game's definition, not from the program: a board is 16
cell exponents in row-major order (0 empty, e the tile 2**e); action 0
slides left, 1 up, 2 right, 3 down; a move that changes the board spawns
one tile on an empty cell. Spawns come from a counter-based stream:
Threefry-2x32 (20 rounds) keyed by (SPAWN_STREAM, game seed) at the
counter (spawn index, 0). The first word picks the cell, the
``mulhi32(bits0, empty cells)``-th empty cell in row-major order; the
second the tile, a 4 when it is below round(0.1 * 2**32), else a 2. A new
game takes spawns 0 and 1; its seed is Threefry keyed by
(GAME_SEED_STREAM, run seed) at (lane, episode), first word. A finished
game restarts with the seed of (run seed 0, the old seed) at episode + 1.
"""

from __future__ import annotations

import itertools
from functools import cache

import numpy as np

SPAWN_STREAM = 0x2048_0001
GAME_SEED_STREAM = 0x2048_0002
FOUR_THRESHOLD = 429_496_730
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _u32(x) -> np.ndarray:
    return np.asarray(np.asarray(x, dtype=np.int64) & 0xFFFFFFFF, dtype=np.uint32)


def threefry2x32(k0, k1, c0, c1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, elementwise over broadcast uint32 arrays."""
    k0, k1, c0, c1 = np.broadcast_arrays(_u32(k0), _u32(k1), _u32(c0), _u32(c1))
    ks = (k0, k1, np.uint32(_PARITY) ^ k0 ^ k1)
    with np.errstate(over="ignore"):
        x0, x1 = c0 + k0, c1 + k1
        for r in range(20):
            d = _ROTATIONS[r % 8]
            x0 = x0 + x1
            x1 = (x1 << np.uint32(d)) | (x1 >> np.uint32(32 - d))
            x1 = x1 ^ x0
            if (r + 1) % 4 == 0:
                j = (r + 1) // 4
                x0 = x0 + ks[j % 3]
                x1 = x1 + ks[(j + 1) % 3] + np.uint32(j)
    return x0, x1


def game_seeds(run_seed, lane, episode) -> np.ndarray:
    return threefry2x32(GAME_SEED_STREAM, run_seed, lane, episode)[0]


def spawn(boards: np.ndarray, seeds: np.ndarray, index: np.ndarray, where: np.ndarray) -> np.ndarray:
    """``boards`` (B, 16) with one tile spawned from spawn ``index`` of each
    game in the rows ``where`` selects (other rows, and full boards, unchanged)."""
    bits0, bits1 = threefry2x32(SPAWN_STREAM, seeds, index, 0)
    empty = boards == 0
    n_empty = empty.sum(-1).astype(np.uint64)
    rank = (bits0.astype(np.uint64) * n_empty) >> np.uint64(32)
    target = empty & (np.cumsum(empty, -1) == (rank[:, None].astype(np.int64) + 1)) & where[:, None]
    tile = np.where(bits1 < FOUR_THRESHOLD, 2, 1).astype(boards.dtype)
    return np.where(target, tile[:, None], boards)


def new_games(seeds: np.ndarray) -> np.ndarray:
    boards = np.zeros((len(seeds), 16), dtype=np.int64)
    everywhere = np.ones(len(seeds), dtype=bool)
    for i in (0, 1):
        boards = spawn(boards, seeds, np.full(len(seeds), i), everywhere)
    return boards


def _slide_row(row: tuple[int, ...]) -> tuple[list[int], int]:
    """One row slid left with merging (each tile merges once), and its score."""
    tiles = [v for v in row if v]
    merged, score, j = [], 0, 0
    while j < len(tiles):
        if j + 1 < len(tiles) and tiles[j] == tiles[j + 1]:
            merged.append(tiles[j] + 1)
            score += 1 << (tiles[j] + 1)
            j += 2
        else:
            merged.append(tiles[j])
            j += 1
    return merged + [0] * (4 - len(merged)), score


@cache
def _row_table() -> tuple[np.ndarray, np.ndarray]:
    """Every row of exponents below 16, slid left: (65,536, 4) rows and scores."""
    rows = np.array(list(itertools.product(range(16), repeat=4)), dtype=np.int64)
    slid = [_slide_row(tuple(r)) for r in rows.tolist()]
    return np.array([r for r, _ in slid], dtype=np.int64), np.array([s for _, s in slid], dtype=np.int64)


def _slide_left(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rows (N, 4) slid left with merging, and their scores."""
    if rows.size and rows.max() >= 16:
        slid = [_slide_row(tuple(r)) for r in rows.tolist()]
        return np.array([r for r, _ in slid], dtype=np.int64).reshape(rows.shape), np.array([s for _, s in slid])
    table, scores = _row_table()
    index = ((rows[:, 0] * 16 + rows[:, 1]) * 16 + rows[:, 2]) * 16 + rows[:, 3]
    return table[index], scores[index]


def _oriented(boards: np.ndarray, action: int) -> np.ndarray:
    grid = boards.reshape(-1, 4, 4)
    return [grid, grid.transpose(0, 2, 1), grid[:, :, ::-1], grid.transpose(0, 2, 1)[:, :, ::-1]][action]


def _restored(grid: np.ndarray, action: int) -> np.ndarray:
    back = [grid, grid.transpose(0, 2, 1), grid[:, :, ::-1], grid[:, :, ::-1].transpose(0, 2, 1)][action]
    return np.ascontiguousarray(back).reshape(-1, 16)


def slide(boards: np.ndarray, actions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Afterstates (B, 16) of ``actions`` (B,) and their merge scores."""
    after = boards.copy()
    score = np.zeros(len(boards), dtype=np.int64)
    for a in range(4):
        sel = actions == a
        if sel.any():
            rows, s = _slide_left(_oriented(boards[sel], a).reshape(-1, 4))
            after[sel] = _restored(rows.reshape(-1, 4, 4), a)
            score[sel] = s.reshape(-1, 4).sum(-1)
    return after, score


def legal(boards: np.ndarray) -> np.ndarray:
    """(B, 4) moves that change the board, in action order."""
    return np.stack([(slide(boards, np.full(len(boards), a))[0] != boards).any(-1) for a in range(4)], -1)


class Games:
    """A lockstep batch of games, stepped as the environment defines a move:
    a finished game is frozen (no move, no spawn, no reward); a move that
    changes nothing earns 0 and spawns nothing, but counts as a move."""

    def __init__(self, run_seed: int, lanes: int):
        self.seeds = game_seeds(run_seed, np.arange(lanes), 0)
        self.episode = np.zeros(lanes, dtype=np.int64)
        self.boards = np.zeros((lanes, 16), dtype=np.int64)
        self.spawns = np.zeros(lanes, dtype=np.int64)
        self.moves = np.zeros(lanes, dtype=np.int64)
        self.score = np.zeros(lanes, dtype=np.int64)
        self.done = np.zeros(lanes, dtype=bool)
        self._fresh(np.ones(lanes, dtype=bool))

    def _fresh(self, which: np.ndarray) -> None:
        self.boards[which] = new_games(self.seeds)[which]
        self.spawns[which] = 2
        self.moves[which] = 0
        self.score[which] = 0
        self.done[which] = False

    def legal(self) -> np.ndarray:
        return legal(self.boards)

    def step(self, actions: np.ndarray) -> np.ndarray:
        """Play ``actions`` (B,) in every unfinished game; returns the rewards."""
        active = ~self.done
        after, score = slide(self.boards, actions)
        moved = (after != self.boards).any(-1) & active
        after = spawn(after, self.seeds, self.spawns, moved)
        self.boards = np.where(moved[:, None], after, self.boards)
        reward = np.where(moved, score, 0)
        self.spawns += moved
        self.moves += active
        self.score += reward
        self.done |= ~self.legal().any(-1)
        return reward

    def restart_finished(self) -> None:
        """Replace each finished game by the next episode of its lane."""
        done = self.done.copy()
        self.episode = np.where(done, self.episode + 1, self.episode)
        self.seeds = np.where(done, game_seeds(0, self.seeds, self.episode), self.seeds).astype(np.uint32)
        self._fresh(done)

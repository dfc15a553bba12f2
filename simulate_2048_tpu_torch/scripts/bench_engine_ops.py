"""Micro-benchmarks of the NumPy engine's ops: ``python -m simulate_2048_tpu_torch.scripts.bench_engine_ops``.

Port of the repository's ``scripts/bench_engine_ops.py`` on the port's own
NumPy engine (``engine/board.py``, ``engine/moves.py``): ``timeit`` of
``slide_and_merge``, ``illegal_actions`` and ``legal_actions_mask`` on one
random board of each size 4, 6 and 8 (``np.random.RandomState(0)``), 2,000
calls each. Same output (one JSON list, indent 2) and keys. It runs no
torch, so it takes no ``--device``.
"""

from __future__ import annotations

import json
import timeit

import numpy as np

from simulate_2048_tpu_torch.engine.board import slide_and_merge
from simulate_2048_tpu_torch.engine.moves import illegal_actions, legal_actions_mask


def random_board(size: int, rs: np.random.RandomState) -> np.ndarray:
    exp = rs.randint(0, 11, size=(size, size))
    exp[rs.rand(size, size) < 0.4] = 0
    return (2 ** exp.astype(np.int64)) * (exp > 0)


def bench(number: int = 2000) -> list[dict]:
    """Microseconds per call of each op at board sizes 4, 6 and 8."""
    rs = np.random.RandomState(0)
    results = []
    for size in (4, 6, 8):
        board = random_board(size, rs)
        t_slide = timeit.timeit(lambda: slide_and_merge(board), number=number) / number
        t_illegal = timeit.timeit(lambda: illegal_actions(board), number=number) / number
        t_mask = timeit.timeit(lambda: legal_actions_mask(board), number=number) / number
        results.append(
            {
                "board_size": size,
                "slide_and_merge_us": t_slide * 1e6,
                "illegal_actions_us": t_illegal * 1e6,
                "legal_actions_mask_us": t_mask * 1e6,
            }
        )
    return results


def main() -> list[dict]:
    results = bench()
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()

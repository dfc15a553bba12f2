"""Batched 2048 board ops on exponent boards, in PyTorch.

Port of the subset of the JAX package's ``ops/board.py`` that the
environment, self-play and the losses use. Boards are int32 ``(..., 4, 4)`` exponents (0 = empty, ``e`` = tile
``2**e``); every op is branchless elementwise tensor code over the batch.
Spawn bits are int64 tensors holding uint32 values (see ``ops/rng.py``).
Results are bit-identical to the JAX package (``tests/test_torch_rng_board_env.py``).
"""

from __future__ import annotations

import torch

from simulate_2048_tpu_torch.ops import rng as tfrng

BOARD_SIZE = 4
NUM_ACTIONS = 4
MAX_EXPONENT = 16


def _compact_rows_left(e: list[torch.Tensor]) -> list[torch.Tensor]:
    """Push nonzero cells of each length-4 row left, keeping their order."""
    e0, e1, e2, e3 = e
    zero = torch.zeros_like(e0)
    for _ in range(3):
        m = e0 == 0
        e0, e1 = torch.where(m, e1, e0), torch.where(m, zero, e1)
        m = e1 == 0
        e1, e2 = torch.where(m, e2, e1), torch.where(m, zero, e2)
        m = e2 == 0
        e2, e3 = torch.where(m, e3, e2), torch.where(m, zero, e3)
    return [e0, e1, e2, e3]


def _merge_rows_left(e: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Merge a compacted row left to right, each tile at most once."""
    e = list(e)
    zero = torch.zeros_like(e[0])
    score = torch.zeros_like(e[0])
    for i in range(3):
        m = (e[i] == e[i + 1]) & (e[i] != 0)
        score = score + torch.where(m, torch.bitwise_left_shift(torch.full_like(e[i], 2), e[i]), zero)
        e[i], e[i + 1] = torch.where(m, e[i] + 1, e[i]), torch.where(m, zero, e[i + 1])
    return e, score


def slide_rows_left(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slide int32 ``(..., 4)`` rows left with merging; returns (rows, score)."""
    cells = _compact_rows_left(list(rows.unbind(-1)))
    merged, score = _merge_rows_left(cells)
    return torch.stack(_compact_rows_left(merged), dim=-1), score


def slide_and_merge(board_exp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slide a whole ``(..., 4, 4)`` board left. Returns (new_board, total score)."""
    new_board, row_scores = slide_rows_left(board_exp)
    return new_board, row_scores.sum(-1, dtype=torch.int32)


def _oriented(board_exp: torch.Tensor, action: int) -> torch.Tensor:
    if action == 0:  # left
        return board_exp
    if action == 1:  # up
        return board_exp.transpose(-1, -2)
    if action == 2:  # right
        return board_exp.flip(-1)
    return board_exp.transpose(-1, -2).flip(-1)  # down


def _unoriented(board_exp: torch.Tensor, action: int) -> torch.Tensor:
    if action == 0:
        return board_exp
    if action == 1:
        return board_exp.transpose(-1, -2)
    if action == 2:
        return board_exp.flip(-1)
    return board_exp.flip(-1).transpose(-1, -2)


def apply_action(board_exp: torch.Tensor, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Afterstate: slide in ``action``'s direction (0 left, 1 up, 2 right, 3 down), no spawn.

    Returns (afterstate board, merge score as int32).
    """
    action = torch.as_tensor(action, device=board_exp.device)
    new_board = board_exp
    score = torch.zeros(board_exp.shape[:-2], dtype=torch.int32, device=board_exp.device)
    for a in range(NUM_ACTIONS):
        slid, row_scores = slide_rows_left(_oriented(board_exp, a))
        sel = action == a
        new_board = torch.where(sel[..., None, None], _unoriented(slid, a), new_board)
        score = torch.where(sel, row_scores.sum(-1, dtype=torch.int32), score)
    return new_board, score


def latent_state(board_exp: torch.Tensor, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Alias of :func:`apply_action` (the afterstate of ``action``)."""
    return apply_action(board_exp, action)


def legal_actions_mask(board_exp: torch.Tensor) -> torch.Tensor:
    """Boolean ``(..., 4)`` mask [left, up, right, down] of moves that change the board."""
    left_cols, right_cols = board_exp[..., :, :-1], board_exp[..., :, 1:]
    top_rows, bottom_rows = board_exp[..., :-1, :], board_exp[..., 1:, :]

    h_merge = (left_cols != 0) & (left_cols == right_cols)
    v_merge = (top_rows != 0) & (top_rows == bottom_rows)

    def _any(x: torch.Tensor) -> torch.Tensor:
        return x.flatten(-2).any(-1)

    left = _any((left_cols == 0) & (right_cols != 0)) | _any(h_merge)
    right = _any((right_cols == 0) & (left_cols != 0)) | _any(h_merge)
    up = _any((top_rows == 0) & (bottom_rows != 0)) | _any(v_merge)
    down = _any((bottom_rows == 0) & (top_rows != 0)) | _any(v_merge)
    return torch.stack([left, up, right, down], dim=-1)


def is_done(board_exp: torch.Tensor) -> torch.Tensor:
    """True when no direction changes the board."""
    full = (board_exp != 0).flatten(-2).all(-1)
    h_eq = (board_exp[..., :, :-1] == board_exp[..., :, 1:]).flatten(-2).any(-1)
    v_eq = (board_exp[..., :-1, :] == board_exp[..., 1:, :]).flatten(-2).any(-1)
    return full & ~h_eq & ~v_eq


def count_empty(board_exp: torch.Tensor) -> torch.Tensor:
    """Number of empty cells."""
    return (board_exp == 0).flatten(-2).sum(-1, dtype=torch.int32)


def exponents_to_values(board_exp: torch.Tensor) -> torch.Tensor:
    """Exponent board → raw tile values (int32)."""
    ones = torch.ones_like(board_exp)
    return torch.where(board_exp > 0, torch.bitwise_left_shift(ones, board_exp), torch.zeros_like(board_exp))


def max_tile(board_exp: torch.Tensor) -> torch.Tensor:
    """Maximum tile value on the board."""
    return exponents_to_values(board_exp).flatten(-2).amax(-1)


def spawn_rank(bits0: torch.Tensor, num_empty: torch.Tensor) -> torch.Tensor:
    """Uniform cell rank in [0, num_empty): ``mulhi32(bits0, num_empty)`` via 16-bit limbs."""
    hi = bits0 >> 16
    lo = bits0 & 0xFFFF
    n = num_empty.to(torch.int64)
    return (hi * n + ((lo * n) >> 16)) >> 16


def spawn_tile(board_exp: torch.Tensor, bits0: torch.Tensor, bits1: torch.Tensor) -> torch.Tensor:
    """Place one tile (4 iff ``bits1 < FOUR_THRESHOLD``, else 2) on the
    ``spawn_rank(bits0, num_empty)``-th empty cell in row-major order; a full
    board is returned unchanged."""
    flat = board_exp.flatten(-2)
    empty = (flat == 0).to(torch.int64)
    num_empty = empty.sum(-1)

    rank = spawn_rank(bits0, num_empty)
    csum = empty.cumsum(-1)
    target = (empty == 1) & (csum == rank[..., None] + 1) & (num_empty > 0)[..., None]

    new_exp = torch.where(bits1 < tfrng.FOUR_THRESHOLD, 2, 1).to(flat.dtype)
    filled = torch.where(target, new_exp[..., None], flat)
    return filled.reshape(board_exp.shape)


def next_state(
    board_exp: torch.Tensor, action: torch.Tensor, bits0: torch.Tensor, bits1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slide, then spawn iff the move changed the board.

    Returns (new_board, reward float32, moved bool); an invalid action leaves
    the board untouched with reward 0.
    """
    after, score = apply_action(board_exp, action)
    moved = (after != board_exp).flatten(-2).any(-1)
    spawned = spawn_tile(after, bits0, bits1)
    new_board = torch.where(moved[..., None, None], spawned, board_exp)
    reward = torch.where(moved, score.to(torch.float32), torch.zeros_like(score, dtype=torch.float32))
    return new_board, reward, moved


def create_initial_board(game_seed: torch.Tensor) -> torch.Tensor:
    """Fresh board with two spawned tiles (spawn indices 0 and 1)."""
    board = torch.zeros(game_seed.shape + (BOARD_SIZE, BOARD_SIZE), dtype=torch.int32, device=game_seed.device)
    for i in (0, 1):
        b0, b1 = tfrng.spawn_bits(game_seed, torch.full_like(game_seed, i))
        board = spawn_tile(board, b0, b1)
    return board


def encode_observation(board_exp: torch.Tensor) -> torch.Tensor:
    """Flattened float observation in [0, 1]: exponent / 16."""
    return (board_exp.to(torch.float32) / float(MAX_EXPONENT)).flatten(-2)


def afterstate_outcomes(board_exp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every spawn outcome of an afterstate with its probability.

    Returns (boards ``(..., 32, 4, 4)``, probs ``(..., 32)``); slot
    ``2·cell + is_four`` holds the board with that tile placed and probability
    0.9/n (a 2) or 0.1/n (a 4) over the n empty cells, 0 for occupied cells
    (whose slot carries the unchanged board). A full board yields the input
    with probability 1 at slot 0.
    """
    lead = board_exp.shape[:-2]
    flat = board_exp.flatten(-2)
    empty = flat == 0
    num_empty = empty.sum(-1, dtype=torch.int32)

    eye = torch.eye(16, dtype=board_exp.dtype, device=board_exp.device) * empty[..., None, :].to(board_exp.dtype)
    boards = torch.stack([flat[..., None, :] + eye, flat[..., None, :] + eye * 2], dim=-2)  # (..., 16, 2, 16)
    boards = boards.reshape(*lead, 32, 4, 4)

    p_cell = empty.to(torch.float32) / torch.clamp_min(num_empty, 1)[..., None].to(torch.float32)
    probs = torch.stack([p_cell * 0.9, p_cell * 0.1], dim=-1).reshape(*lead, 32)

    full = (num_empty == 0)[..., None]
    slot0 = torch.zeros_like(probs)
    slot0[..., 0] = 1.0
    probs = torch.where(full, slot0, probs)
    boards = torch.where(full[..., None, None], board_exp[..., None, :, :], boards)
    return boards, probs


def sample_action(
    generator: torch.Generator | None,
    temperature: float,
    policy: torch.Tensor,
    legal_mask: torch.Tensor,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample an action from ``policy`` restricted to legal moves: mask,
    renormalise (uniform over legal moves when nothing is left), temperature
    softmax in log space; argmax when ``temperature < 0.01``. The draw comes
    from ``generator`` (made on the policy's device), or inverts the
    cumulative distribution at ``uniform`` (one number in [0, 1) per board)
    when that is given."""
    legal = legal_mask.to(torch.float32)
    masked = torch.where(legal_mask, policy, torch.zeros_like(policy))
    total = masked.sum(-1, keepdim=True)
    any_legal = legal / torch.clamp_min(legal.sum(-1, keepdim=True), 1.0)
    masked = torch.where(total < 1e-8, any_legal, masked / torch.clamp_min(total, 1e-30))
    if temperature < 0.01:
        return masked.argmax(-1)
    probs = torch.softmax(torch.log(masked + 1e-8) / temperature, dim=-1)
    if uniform is not None:
        cdf = probs.cumsum(-1)
        return (uniform[..., None] * cdf[..., -1:] >= cdf).sum(-1).clamp_max(probs.shape[-1] - 1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator).reshape(probs.shape[:-1])

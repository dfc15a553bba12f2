"""The rollout kernel's table of slid rows and its derived-seed launch, against
the JAX package, on the CPU.

The table (``ops/rollout_kernel.py`` ``slide_table``, which the CUDA kernel
reads) must hold, for every one of the 65,536 rows of four 4-bit cells, the
JAX package's slide of that row left and right: the slid row and the score
exactly. A 4-bit cell cannot hold what two 15s merge into, so the rows that
hold a 15 carry only the flag that sends a board to the kernel's exact path,
and the flag marks exactly the rows whose slide holds a cell of 15 or more.
The wrapper that derives the seeds in the launch is held, through its plain
version, against JAX's ``derive_game_seeds`` followed by the Pallas kernel in
interpret mode, with games that end. The plain version of the board-ops check
entry is held against JAX's board ops, on boards that reach exponents 15-17.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.ops import board as jb
from simulate_2048_tpu.ops import rng as jrng
from simulate_2048_tpu.ops.pallas_rollout import pallas_random_rollout
from simulate_2048_tpu_torch.ops import rng as trng
from simulate_2048_tpu_torch.ops import rollout_kernel as rk

torch.set_num_threads(1)

ROWS = np.arange(rk.TABLE_ROWS)
CELLS = ((ROWS[:, None] >> np.arange(0, 16, 4)) & 0xF).astype(np.int32)  # (65536, 4): cell c at bits 4c
HOLDS_15 = (CELLS >= 15).any(-1)


@pytest.fixture(scope="module")
def table() -> torch.Tensor:
    return rk.slide_table()


def jax_slide(action: int) -> tuple[np.ndarray, np.ndarray]:
    """JAX's slide of every row, as row 0 of a board whose other rows are empty."""
    boards = np.zeros((rk.TABLE_ROWS, 4, 4), np.int32)
    boards[:, 0] = CELLS
    slid, score = jb.apply_action(jnp.asarray(boards), jnp.full(rk.TABLE_ROWS, action, jnp.int32))
    return np.asarray(slid)[:, 0], np.asarray(score)


@pytest.mark.parametrize("direction,action", [(0, 0), (1, 2)], ids=["left", "right"])
def test_table_equals_jax_slide_on_every_row(table, direction, action):
    assert table.shape == (2, rk.TABLE_ROWS) and table.dtype == torch.int32
    slid, score, exact = (t.numpy() for t in rk.decode_table(table[direction]))
    want_slid, want_score = jax_slide(action)
    np.testing.assert_array_equal(slid[~HOLDS_15], want_slid[~HOLDS_15])
    np.testing.assert_array_equal(score[~HOLDS_15], want_score[~HOLDS_15])
    # A row that holds a 15 is never slid by the table: its entry is the flag alone.
    assert (table[direction].numpy()[HOLDS_15] == np.int32(-(2**31))).all() and exact[HOLDS_15].all()
    assert HOLDS_15.sum() == 2**16 - 15**4  # every row with a cell of 15


@pytest.mark.parametrize("direction,action", [(0, 0), (1, 2)], ids=["left", "right"])
def test_exact_flag_marks_exactly_the_rows_with_a_cell_of_15(table, direction, action):
    """A board is on the exact path exactly while it holds a cell of 15 or
    more: the move that makes a 15 flags it, and a row that holds one is
    flagged whatever its slide."""
    _, _, exact = (t.numpy() for t in rk.decode_table(table[direction]))
    want_slid, _ = jax_slide(action)
    makes_15 = (want_slid >= 15).any(-1)
    np.testing.assert_array_equal(exact, makes_15 | HOLDS_15)
    assert not (HOLDS_15 & ~makes_15).any()  # a 15 survives its row's slide
    assert (makes_15 & ~HOLDS_15).sum() > 0  # the table's own moves make 15s: two 14s merge
    # The rows the table slides hold a slid row below 16 and a quarter score below 2^15.
    assert want_slid[~HOLDS_15].max() == 15 and jax_slide(action)[1][~HOLDS_15].max() < 4 * 2**15


def test_derived_seed_wrapper_matches_jax_derived_seeds_and_pallas_kernel():
    """B = 128, 320 steps, games ending (as test_torch_rollout.py's ``games_end``)."""
    b, steps, run_seed = 128, 320, 7
    jseeds = jrng.derive_game_seeds(jnp.uint32(run_seed), jnp.arange(b, dtype=jnp.uint32), jnp.zeros(b, jnp.uint32))
    want = pallas_random_rollout(jseeds, steps, block_b=128, interpret=True)
    before = dict(rk.LAUNCHES)
    got = rk.rollout_kernel_from_run_seed(run_seed, b, steps, "cpu")
    assert int(got[1].sum()) > 0, "no game ended"
    for name, g, w in zip(("boards", "episodes", "reward_sum", "max_tile"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    index = torch.arange(b, dtype=torch.int64)
    seeds = trng.derive_game_seeds(run_seed, index, torch.zeros_like(index))
    for g, w in zip(got, rk.rollout_kernel(seeds, steps)):
        assert torch.equal(g, w)
    assert rk.LAUNCHES == before


def test_derived_seed_wrapper_launches_nothing_on_cpu_and_refuses_other_devices():
    before, check_before = dict(rk.LAUNCHES), dict(rk.CHECK_LAUNCHES)
    boards, episodes, reward_sum, max_tile = rk.rollout_kernel_from_run_seed(3, 5, 0, torch.device("cpu"))
    assert boards.shape == (5, 4, 4) and not episodes.any() and not reward_sum.any() and not max_tile.any()
    assert rk.LAUNCHES == before == {"random_rollout": 0}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rk.rollout_kernel_from_run_seed(3, 8, 12, "meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rk.board_ops_kernel(*(torch.zeros(s, dtype=torch.int32, device="meta") for s in ((8, 4, 4), 8, 8, 8)))
    assert rk.CHECK_LAUNCHES == check_before == {"random_rollout_board_ops": 0}


def test_device_table_is_built_once_per_device(table):
    cpu = torch.device("cpu")
    assert rk.device_table(cpu) is rk.device_table(cpu)
    assert torch.equal(rk.device_table(cpu), table)


@pytest.mark.parametrize("exponents", [(0, 14), (13, 18)], ids=["below_15", "exponents_13_17"])
def test_board_ops_reference_matches_jax(exponents):
    """The plain version of the kernel's board-ops check entry against JAX's
    ``apply_action`` / ``spawn_tile`` / ``is_done``, in every direction."""
    rs = np.random.RandomState(12)
    n = 4096
    boards = rs.randint(*exponents, size=(n, 4, 4)).astype(np.int32) * (rs.rand(n, 4, 4) < rs.rand(n, 1, 1) * 1.3)
    actions = rs.randint(0, 4, n).astype(np.int32)
    bits = rs.randint(0, 2**32, size=(2, n), dtype=np.uint64).astype(np.uint32)
    got = rk.board_ops_kernel(
        torch.from_numpy(boards), torch.from_numpy(actions), *(torch.from_numpy(b.astype(np.int64)) for b in bits)
    )
    jslid, jscore = jb.apply_action(jnp.asarray(boards), jnp.asarray(actions))
    jspawned = jb.spawn_tile(jslid, jnp.asarray(bits[0]), jnp.asarray(bits[1]))
    want = (jslid, jscore, jspawned, jb.is_done(jspawned), np.asarray(jspawned).max((-1, -2)) >= 15)
    for name, g, w in zip(("slid", "score", "spawned", "done", "exact"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[3].any() and (got[4].any() == (exponents[1] > 14))

"""The control (the reference one precision below the configuration's, in
the program's place) comes out not correct under each cell's limits, at a
size a test on the CPU holds. On the chip, at the cells' own sizes:
``python3 perfbench/control.py``."""

import pytest
import torch

from perfbench.harness import check, players
from perfbench.harness.record import SearchRecorder
from perfbench.tests.conftest import SEED, tiny_cell

CELLS = ["appendix_c.selfplay", "capacity_probe.selfplay", "capacity_probe.deep_eval"]
SMALL = dict(hidden_size=64, num_residual_blocks=2, num_simulations=24, num_parallel_games=16, deep_eval_games=16)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name, **SMALL)
    player = players.PLAYERS[cell.traffic["player"]](cell, SEED, torch.device("cpu"))
    player.setup()
    recorder = SearchRecorder()
    with recorder:
        player.unit(recorder)
    program, _ = check.judge(player, recorder)
    assert all(n.ok for n in program), program
    control, compared = check.judge(player, recorder, control=check.CONTROL[cell.config["search_weight_dtype"]])
    assert compared["searches_compared"] >= 50
    assert not all(n.ok for n in control), control

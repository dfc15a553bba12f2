"""The reference against the program's plain path at a tiny size, on the CPU.

The reference imports nothing of the program; these tests may.
"""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import weights
from perfbench.reference import game, model
from perfbench.reference import search as ref_search
from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import architecture_from_config
from simulate_2048_tpu_torch.training import self_play
from simulate_2048_tpu_torch.training.config import TrainConfig


def test_games_replay_the_environment():
    lanes, rs = 32, np.random.RandomState(3)
    state = envlib.reset_batch(2**30 - 5, lanes, "cpu")
    games = game.Games(2**30 - 5, lanes)
    for _ in range(2):
        for _ in range(250):
            assert (games.legal() == envlib.get_legal_actions(state).numpy()).all()
            actions = rs.randint(0, 4, lanes)
            state, reward, _, _ = envlib.step(state, torch.tensor(actions))
            assert (games.step(actions) == reward.numpy()).all()
            assert (games.boards == state.board.reshape(lanes, 16).numpy()).all()
            assert (games.done == state.done.numpy()).all() and (games.moves == state.step_count.numpy()).all()
        assert games.done.any()
        state, _ = envlib.reset_done(state), games.restart_finished()
        assert (games.boards == state.board.reshape(lanes, 16).numpy()).all()


def _searches(config, evaluation, products="float32", lanes=16):
    network = architecture_from_config(config)
    w = weights.draw({k: v.shape for k, v in network.state_dict().items()}, 99, torch.device("cpu"))
    network.load_state_dict(w)
    state = envlib.reset_batch(5, lanes, "cpu")
    for _ in range(6):
        state, _, _, _ = envlib.step(state, torch.randint(0, 4, (lanes,), generator=torch.Generator().manual_seed(1)))
    obs, legal = envlib.get_observation(state), envlib.get_legal_actions(state)
    cfg = self_play.search_config_from(config, eval_mode=evaluation)
    if evaluation:
        cfg = cfg._replace(dirichlet_fraction=0.0)
    alpha = torch.full((lanes, 4), 0.25)
    noise = None if evaluation else torch._sample_dirichlet(alpha, torch.Generator().manual_seed(2))
    out = self_play._make_search(network, config, cfg, torch.device("cpu"))(obs, ~legal, noise)
    ref = ref_search.search(w, dataclasses.asdict(config), obs, legal, noise, evaluation, products)
    return out, ref


@pytest.mark.parametrize("bins", [(1, 1), (17, 9)])
@pytest.mark.parametrize("evaluation", [False, True])
def test_search_equals_the_kernels_plain_version(bins, evaluation):
    config = TrainConfig(hidden_size=32, num_residual_blocks=2, num_simulations=12, value_bins=bins[0],
                         reward_bins=bins[1], use_bfloat16=True, search_backend="pallas",
                         eval_prior_temperature=4.0, eval_pb_c_init=0.5)  # fmt: skip
    out, (visits, q, value) = _searches(config, evaluation)
    assert torch.equal(out.visit_counts.float(), visits)
    assert torch.equal(out.search_value, value)
    assert torch.equal(out.qvalues, q)


def test_bf16_products_follow_the_bf16_pack_within_order_noise():
    config = TrainConfig(hidden_size=32, num_residual_blocks=2, num_simulations=12, use_bfloat16=True,
                         search_backend="pallas", search_weight_dtype="bfloat16")  # fmt: skip
    out, (visits, _, value) = _searches(config, False, "bfloat16", lanes=32)
    assert (out.visit_counts.float() == visits).all(-1).float().mean() >= 0.9
    assert ((out.search_value - value).abs() / value.abs().clamp_min(1)).median() < 1e-3


def test_float8_rounding_keeps_scale():
    x = torch.randn(8, 64)
    y = model.round_to(x, "float8", per_row=True)
    assert ((y - x).abs() <= 0.07 * x.abs().amax(-1, keepdim=True)).all()
    assert not torch.equal(y, model.round_to(x, "bfloat16", per_row=True))

"""Behaviour of the port's search variants on hand-checkable mock models,
and the port's search against the independent scalar oracle
(``tests/oracle_mcts.py``).

The cases of the JAX package's ``tests/test_search.py``
(``TestChanceSelectionModes``, ``TestGumbelRoot``) run here on the port's
search with a PyTorch mock network of the same semantics
(``MockNetwork``), and the oracle differential of
``tests/test_oracle_differential.py`` (PUCT and Gumbel sequential halving, a
mock model and a real network converted from Flax) holds the port's search
to the oracle: visit counts exact, Q and the root value within rtol 1e-4
(1e-3 on the real network), action weights within rtol 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle_mcts import oracle_search
from test_search import A, C, H, MOCK_PARAMS, mock_apply_fns

from simulate_2048_tpu.models import create_network
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.search import mcts
from simulate_2048_tpu_torch.search.mcts import SearchConfig, batched_run_mcts
from simulate_2048_tpu_torch.training.config import TrainConfig, tiny_config
from simulate_2048_tpu_torch.training.self_play import search_config_from

torch.set_num_threads(1)

CFG = SearchConfig(num_simulations=16, num_actions=A, codebook_size=C, dirichlet_fraction=0.0)


class MockNetwork:
    """The JAX tests' ``mock_apply_fns`` in PyTorch: h → zeros, f → (uniform
    logits, ``leaf_value``), φ embeds the action one-hot, ψ → (Σ afterstate[:A]
    · q_per_action, fixed chance logits), g → (zeros, ``reward_per_outcome``)."""

    def __init__(self, q_per_action=(0.0,) * A, chance_logits=(0.0,) * C, reward_per_outcome=0.0, leaf_value=0.0):
        self.q = torch.tensor(q_per_action, dtype=torch.float32)
        self.chance_logits = torch.tensor(chance_logits, dtype=torch.float32)
        self.reward, self.leaf_value = reward_per_outcome, leaf_value

    def representation(self, obs):
        return torch.zeros(obs.shape[:-1] + (H,))

    def prediction(self, hidden):
        return torch.zeros(hidden.shape[:-1] + (A,)), torch.full(hidden.shape[:-1], float(self.leaf_value))

    def afterstate_dynamics(self, state, action):
        return torch.cat([action, torch.zeros(action.shape[:-1] + (H - A,))], -1)

    def afterstate_prediction(self, afterstate):
        return (afterstate[..., :A] * self.q).sum(-1), self.chance_logits.expand(afterstate.shape[:-1] + (C,))

    def dynamics(self, afterstate, code):
        return torch.zeros(afterstate.shape[:-1] + (H,)), torch.full(afterstate.shape[:-1], float(self.reward))


def run(network, cfg, invalid=None, seed=0, batch=1):
    invalid = None if invalid is None else torch.tensor(invalid).expand(batch, A)
    generator = torch.Generator().manual_seed(seed)
    return batched_run_mcts(network, torch.zeros(batch, 16), cfg, invalid, generator=generator)


def final_tree(cfg, clog, seed=0):
    """The tree of one search on the mock model (chance draws from a seeded generator)."""
    network = MockNetwork(chance_logits=clog)
    hidden, probs, value = mcts.root_inputs(network, torch.zeros(1, 16), cfg)
    tree = mcts.run_simulations(hidden, probs, value, cfg, mcts.network_transitions(network, cfg),
                                generator=torch.Generator().manual_seed(seed))  # fmt: skip
    return type(tree)(*(x[0].numpy() for x in tree))


def busiest_chance_shares(tree):
    """Children-visit shares at the most-visited chance node."""
    is_chance = ~tree.is_decision & (tree.node_visit > 0)
    node = np.argmax(np.where(is_chance, tree.node_visit, -1))
    visits = tree.children_visits[node].astype(float)
    return visits / max(visits.sum(), 1), visits.sum()


PEAKED = [0.0, 2.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("mode", ["sample", "argmax"])
def test_chance_visits_approximate_the_prior(mode):
    """Sampling c ~ σ and its derandomisation p/(1+N) both give the busiest
    chance node visit shares near σ, the mode first; argmax is deterministic."""
    sigma = torch.softmax(torch.tensor(PEAKED), 0).numpy()
    cfg = CFG._replace(num_simulations=256, chance_selection=mode, max_depth=None)
    shares, n = busiest_chance_shares(final_tree(cfg, PEAKED))
    assert n >= 30
    assert abs(shares[1] - sigma[1]) < 0.2 and shares[1] == shares.max()
    if mode == "argmax":
        np.testing.assert_array_equal(shares, busiest_chance_shares(final_tree(cfg, PEAKED, seed=1))[0])


def test_modes_agree_on_peaked_prior():
    clog = [0.0] * C
    clog[3] = 10.0  # σ ≈ one-hot
    for mode in ("argmax", "sample"):
        shares, _ = busiest_chance_shares(final_tree(CFG._replace(num_simulations=32, chance_selection=mode), clog))
        assert shares[3] > 0.99


@pytest.mark.parametrize("mode", ["argmax", "sample"])
def test_progressive_widening_caps_chance_children(mode):
    """At most ceil(pw_c · (N+1)^pw_alpha) children at every chance node, and the cap binds."""
    cfg = CFG._replace(num_simulations=48, pw_c=1.0, pw_alpha=0.5, max_depth=None, chance_selection=mode)
    tree = final_tree(cfg, [0.0] * C)
    checked = 0
    for node in range(tree.node_value.shape[0]):
        if tree.is_decision[node] or tree.node_visit[node] == 0:
            continue
        n_children = int((tree.children_index[node] >= 0).sum())
        assert n_children <= int(np.ceil((tree.node_visit[node] + 1) ** 0.5)), node
        checked += 1
    assert checked > 0
    chance = ~tree.is_decision & (tree.node_visit > 0)
    busiest = np.argmax(np.where(chance, tree.node_visit, -1))
    assert (tree.children_index[busiest] >= 0).sum() < C


def test_no_widening_matches_unbounded_cap():
    out_none, out_big = run(MockNetwork(), CFG), run(MockNetwork(), CFG._replace(pw_c=1e6))
    for got, want in zip(out_big, out_none):
        assert torch.equal(got, want)


def test_full_search_runs_in_sample_mode():
    config = dataclasses.replace(tiny_config(), hidden_size=16, num_residual_blocks=1, codebook_size=C,
                                 chance_target_mode="encoder")  # fmt: skip
    network = network_from_config(config, prng_key(0), "cpu")
    cfg = SearchConfig(num_simulations=12, codebook_size=C, chance_selection="sample", pw_c=1.0)
    out = run(network, cfg, seed=1, batch=3)
    assert (out.visit_counts.sum(-1) == 12).all() and torch.isfinite(out.search_value).all()


GCFG = CFG._replace(root_selection="gumbel", num_simulations=16)


def test_considered_visits_schedule_m4_n16():
    table = mcts.considered_visits_table(4, 16)
    assert table[4] == (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5)
    assert table[1] == table[0] == tuple(range(16))
    assert all(len(row) == 16 for row in table)


def test_all_legal_actions_probed_then_halved():
    counts = run(MockNetwork(), GCFG).visit_counts[0].numpy()
    assert counts.sum() == 16 and counts.min() >= 2


def test_halving_concentrates_on_best_action():
    out = run(MockNetwork(q_per_action=(0.0, 1.0, 0.0, 0.0)), GCFG._replace(gumbel_scale=0.0))
    counts = out.visit_counts[0].numpy()
    assert counts[1] == counts.max() and (counts == counts.max()).sum() == 2 and counts.min() < counts.max()
    assert int(out.action_weights[0].argmax()) == 1  # the winner is the improved policy's, not the visits'


def test_improved_policy_is_the_action_weights():
    w = run(MockNetwork(), GCFG, seed=3).action_weights[0].numpy()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    assert w.std() < 0.05  # uniform logits, equal Q: near-uniform although the visits are concentrated


def test_illegal_actions_excluded_everywhere():
    out = run(MockNetwork(), GCFG, invalid=[False, True, False, True])
    counts, weights = out.visit_counts[0].numpy(), out.action_weights[0].numpy()
    assert counts[1] == counts[3] == 0 and weights[1] == weights[3] == 0.0
    np.testing.assert_allclose(weights.sum(), 1.0, rtol=1e-5)


def test_gumbel_noise_varies_and_scale_zero_is_deterministic():
    """16 searches of one root, each its own Gumbel draws: not all alike; at scale 0 all alike, whatever the seed."""
    network = MockNetwork(q_per_action=(0.3, 0.0, 0.2, 0.1))
    noisy = run(network, GCFG, batch=16).visit_counts
    assert not (noisy == noisy[:1]).all()
    det = torch.cat([run(network, GCFG._replace(gumbel_scale=0.0), seed=k, batch=4).visit_counts for k in range(3)])
    assert (det == det[:1]).all()


def test_eval_mode_forces_puct_and_the_kernel_refuses_gumbel():
    cfg = TrainConfig(root_selection="gumbel")
    assert search_config_from(cfg).root_selection == "gumbel"
    assert search_config_from(cfg, eval_mode=True).root_selection == "puct"
    with pytest.raises(ValueError, match="PUCT root selection"):
        TrainConfig(root_selection="gumbel", search_backend="pallas")


# ---- the scalar oracle (tests/oracle_mcts.py), as tests/test_oracle_differential.py runs it

BASE = SearchConfig(num_simulations=24, num_actions=A, codebook_size=C, dirichlet_fraction=0.0)


def assert_matches_oracle(tnet, jparams, jfns, obs, cfg, invalid=None, value_rtol=1e-4):
    out = batched_run_mcts(tnet, torch.from_numpy(obs)[None], cfg,
                           None if invalid is None else torch.from_numpy(invalid)[None])  # fmt: skip
    o_visits, o_q, o_value, o_weights = oracle_search(jparams, jfns, obs, cfg, invalid)
    np.testing.assert_array_equal(out.visit_counts[0].numpy(), o_visits)
    np.testing.assert_allclose(out.qvalues[0].numpy(), o_q, rtol=value_rtol, atol=1e-5)
    np.testing.assert_allclose(float(out.search_value[0]), o_value, rtol=value_rtol)
    np.testing.assert_allclose(out.action_weights[0].numpy(), o_weights, rtol=2e-3, atol=1e-6)


MOCK_CASES = {
    "bandit": (dict(q_per_action=(0.1, 0.9, 0.3, 0.5)), dict(num_simulations=32), None),
    "gumbel_sequential_halving": (
        dict(q_per_action=(0.1, 0.9, 0.3, 0.5)), dict(root_selection="gumbel", gumbel_scale=0.0, num_simulations=16),
        None,
    ),
    "gumbel_masked_rewards": (
        dict(q_per_action=(0.2, 0.8, 0.1, 0.6), reward_per_outcome=1.5, leaf_value=0.7),
        dict(root_selection="gumbel", gumbel_scale=0.0, num_simulations=20, discount=0.997),
        np.array([False, True, False, False]),
    ),
}


@pytest.mark.parametrize("case", sorted(MOCK_CASES))
def test_mock_model_matches_oracle(case):
    model, overrides, invalid = MOCK_CASES[case]
    assert_matches_oracle(MockNetwork(**model), MOCK_PARAMS, mock_apply_fns(**model), np.zeros(16, np.float32),
                          BASE._replace(**overrides), invalid)  # fmt: skip


@pytest.fixture(scope="module")
def real_net():
    jnet = create_network(jax.random.PRNGKey(3), codebook_size=C, hidden_size=16, num_blocks=1)
    config = dataclasses.replace(TrainConfig(), codebook_size=C, hidden_size=16, num_residual_blocks=1,
                                 chance_target_mode="encoder")  # fmt: skip
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), config)


def board_obs():
    board = np.zeros(16, np.float32)
    board[0], board[1], board[5] = 1 / 16, 2 / 16, 3 / 16
    return board


@pytest.mark.parametrize("invalid", [None, np.array([True, False, False, False])], ids=["all-legal", "masked"])
def test_real_network_gumbel_matches_oracle(real_net, invalid):
    jnet, tnet = real_net
    cfg = BASE._replace(num_simulations=16, root_selection="gumbel", gumbel_scale=0.0, value_transform_epsilon=0.001)
    assert_matches_oracle(tnet, jnet.params, jnet.apply_fns, board_obs(), cfg, invalid, value_rtol=1e-3)


def test_real_network_puct_matches_oracle(real_net):
    jnet, tnet = real_net
    cfg = BASE._replace(num_simulations=20, value_transform_epsilon=0.001)
    assert_matches_oracle(tnet, jnet.params, jnet.apply_fns, board_obs(), cfg, value_rtol=1e-3)


def test_oracle_mock_is_the_port_mock():
    """The two mock models give the same transitions (so the oracle cases above compare searches, not mocks)."""
    model = dict(q_per_action=(0.2, 0.8, 0.1, 0.6), chance_logits=PEAKED, reward_per_outcome=1.5, leaf_value=0.7)
    tnet, jfns = MockNetwork(**model), mock_apply_fns(**model)
    a = torch.nn.functional.one_hot(torch.tensor([2]), A).float()
    t_as = tnet.afterstate_dynamics(torch.zeros(1, H), a)
    j_as = jfns.afterstate_dynamics({}, jnp.zeros((1, H)), a.numpy())
    np.testing.assert_array_equal(t_as.numpy(), np.asarray(j_as))
    for t, j in zip(tnet.afterstate_prediction(t_as), jfns.afterstate_prediction({}, j_as)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(tnet.dynamics(t_as, torch.zeros(1, C)), jfns.dynamics({}, j_as, jnp.zeros((1, C)))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

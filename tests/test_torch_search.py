"""PyTorch port's plain batched search vs the JAX package's
``batched_run_mcts`` on converted weights and identical inputs.

Root visit counts must agree exactly (argmax-mode search has no in-loop
randomness; both sides get the same root Dirichlet noise, drawn by JAX and
fed to the port as ``noise``); Q and the root value within 1e-4 (float
reduction order only).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.search.mcts import SearchConfig as JaxSearchConfig
from simulate_2048_tpu.search.mcts import batched_run_mcts as jax_batched_run_mcts
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.search.mcts import SearchConfig, batched_run_mcts
from simulate_2048_tpu_torch.search.policy import get_policy_target
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HIDDEN, BLOCKS, BATCH = 32, 2, 8
BASE = dict(num_simulations=12, max_depth=8, value_transform_epsilon=0.001)


@pytest.fixture(scope="module")
def nets():
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=BLOCKS)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS)
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


def make_inputs(seed, masked):
    rs = np.random.RandomState(seed)
    obs = (rs.randint(0, 11, size=(BATCH, 16)) / 16.0).astype(np.float32)
    invalid = rs.rand(BATCH, 4) < 0.3
    invalid[invalid.all(-1)] = False  # keep ≥ 1 legal action
    keys = jax.random.split(jax.random.PRNGKey(seed), BATCH)
    return obs, (invalid if masked else None), keys


CASES = {  # name: (SearchConfig overrides, legality mask, input seed)
    "plain": (dict(), False, 1),
    "legality_mask": (dict(), True, 7),
    "depth_cap": (dict(num_simulations=12, max_depth=3), True, 5),
    "temperature_and_noise": (dict(prior_temperature=4.0, pb_c_init=0.5, dirichlet_fraction=0.25), True, 13),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_search_matches_jax(nets, case):
    jnet, tnet = nets
    overrides, masked, seed = CASES[case]
    kw = {**BASE, "dirichlet_fraction": 0.0, **overrides}
    obs, invalid, keys = make_inputs(seed, masked)
    ref = jax_batched_run_mcts(
        jnet.params, jnet.apply_fns, jnp.asarray(obs), keys, JaxSearchConfig(**kw),
        None if invalid is None else jnp.asarray(invalid),
    )
    noise = None
    if kw["dirichlet_fraction"] > 0:
        noise = jax.vmap(lambda k: jax.random.dirichlet(k, jnp.full((4,), 0.25)))(keys)
        noise = torch.from_numpy(np.array(noise))
    out = batched_run_mcts(
        tnet, torch.from_numpy(obs), SearchConfig(**kw), None if invalid is None else torch.from_numpy(invalid), noise
    )
    np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
    np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.action_weights.numpy(), np.asarray(ref.action_weights), rtol=0, atol=1e-6)
    assert (out.visit_counts.sum(-1) == kw["num_simulations"]).all()
    if invalid is not None:
        assert (out.visit_counts.numpy()[invalid] == 0).all()


def test_policy_target_matches_jax(nets):
    from simulate_2048_tpu.search.policy import get_policy_target as jax_get_policy_target

    jnet, tnet = nets
    obs, invalid, keys = make_inputs(3, True)
    cfg = {**BASE, "dirichlet_fraction": 0.0}
    out = batched_run_mcts(tnet, torch.from_numpy(obs), SearchConfig(**cfg), torch.from_numpy(invalid))
    legal = ~invalid
    for temperature in (1.0, 0.5, 0.0):
        ref = jax.vmap(lambda po, m: jax_get_policy_target(po, m, temperature))(
            jax.tree.map(lambda x: jnp.asarray(x.numpy()), out), jnp.asarray(legal)
        )
        got = get_policy_target(out, torch.from_numpy(legal), temperature)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "field,value", [("root_selection", "gumbel"), ("chance_selection", "sample"), ("pw_c", 1.0)]
)
def test_unported_variants_raise(nets, field, value):
    # The three variants are ported now: each case checks that its variant runs, S visits in every search
    # (their parity with JAX: test_torch_search_modes.py).
    _, tnet = nets
    obs, _, _ = make_inputs(0, False)
    cfg = SearchConfig(**{**BASE, "dirichlet_fraction": 0.0, field: value})
    out = batched_run_mcts(tnet, torch.from_numpy(obs), cfg, generator=torch.Generator().manual_seed(0))
    assert (out.visit_counts.sum(-1) == cfg.num_simulations).all()
    assert torch.isfinite(out.qvalues).all() and torch.isfinite(out.search_value).all()

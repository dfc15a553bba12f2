"""The port's plain search under the Gumbel root, sampled chance selection
and progressive widening vs the JAX package's ``batched_run_mcts``, on
converted weights and identical inputs.

JAX draws its noise inside the search from each search's key; the port
takes the same numbers as tensors (``jax_draws``): the root Gumbel draws
``gumbel(fold_in(key_b, 0x6B1E), (A,))`` and, per simulation s and node n,
the chance draws ``gumbel(fold_in(fold_in(fold_in(key_b, 0x5EED), s), n),
(K,))``, which ``jax.random.categorical`` adds to the logits before its
argmax. Root visit counts must agree exactly; Q and the root value within
atol 1e-4; the action weights (the improved policy under the Gumbel root)
within rtol 1e-5 / atol 1e-6.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.search import mcts as jmcts
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.search import mcts
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HIDDEN, BLOCKS, BATCH = 32, 2, 8


@pytest.fixture(scope="module")
def nets():
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=BLOCKS)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS)
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


def jax_draws(keys, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """The draws JAX's ``_search_single`` makes from each search's key:
    root Gumbel (B, A) and chance Gumbel (B, S, S + 1, K)."""
    a, s = cfg.num_actions, cfg.num_simulations
    k = max(cfg.num_actions, cfg.codebook_size)
    gumbel = jax.vmap(lambda key: jax.random.gumbel(jax.random.fold_in(key, 0x6B1E), (a,)))(keys)

    def per_search(key):
        sim_key = jax.random.fold_in(key, 0x5EED)

        def per_sim(i):
            step_key = jax.random.fold_in(sim_key, i)
            return jax.vmap(lambda n: jax.random.gumbel(jax.random.fold_in(step_key, n), (k,)))(jnp.arange(s + 1))

        return jax.vmap(per_sim)(jnp.arange(s))

    chance = jax.vmap(per_search)(keys)
    return torch.from_numpy(np.array(gumbel)), torch.from_numpy(np.array(chance))


def make_inputs(seed, masked):
    rs = np.random.RandomState(seed)
    obs = (rs.randint(0, 11, size=(BATCH, 16)) / 16.0).astype(np.float32)
    invalid = rs.rand(BATCH, 4) < 0.3
    invalid[invalid.all(-1)] = False  # keep ≥ 1 legal action
    keys = jax.random.split(jax.random.PRNGKey(seed), BATCH)
    return obs, (invalid if masked else None), keys


def run_both(nets, kw, seed, masked):
    jnet, tnet = nets
    obs, invalid, keys = make_inputs(seed, masked)
    ref = jmcts.batched_run_mcts(
        jnet.params, jnet.apply_fns, jnp.asarray(obs), keys, jmcts.SearchConfig(**kw),
        None if invalid is None else jnp.asarray(invalid),
    )  # fmt: skip
    cfg = mcts.SearchConfig(**kw)
    gumbel, chance = jax_draws(keys, cfg)
    out = mcts.batched_run_mcts(
        tnet, torch.from_numpy(obs), cfg, None if invalid is None else torch.from_numpy(invalid),
        gumbel if cfg.root_selection == "gumbel" else None, chance if cfg.chance_selection == "sample" else None,
    )  # fmt: skip
    return ref, out, invalid


BASE = dict(num_simulations=16, dirichlet_fraction=0.0)
CASES = {  # name: (SearchConfig overrides, legality mask, input seed)
    "gumbel": (dict(root_selection="gumbel"), False, 1),
    "gumbel_scale_0": (dict(root_selection="gumbel", gumbel_scale=0.0), False, 2),
    "gumbel_masked": (dict(root_selection="gumbel"), True, 7),
    "gumbel_scale_0_masked": (dict(root_selection="gumbel", gumbel_scale=0.0), True, 8),
    "gumbel_depth_cap": (dict(root_selection="gumbel", max_depth=3), True, 5),
    "gumbel_untransform": (dict(root_selection="gumbel", value_transform_epsilon=0.001), True, 11),
    "gumbel_dirichlet_fraction_ignored": (dict(root_selection="gumbel", dirichlet_fraction=0.25), True, 12),
    "sample": (dict(chance_selection="sample", num_simulations=12), True, 3),
    "sample_widening": (dict(chance_selection="sample", pw_c=1.0, num_simulations=14), True, 4),
    "widening_1_0.5": (dict(pw_c=1.0, pw_alpha=0.5), True, 6),
    "widening_2_0.75": (dict(pw_c=2.0, pw_alpha=0.75, num_simulations=14), False, 9),
    "all_three": (dict(root_selection="gumbel", chance_selection="sample", pw_c=1.0, max_depth=8), True, 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_matches_jax(nets, case):
    overrides, masked, seed = CASES[case]
    kw = {**BASE, **overrides}
    ref, out, invalid = run_both(nets, kw, seed, masked)
    np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
    np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.action_weights.numpy(), np.asarray(ref.action_weights), rtol=1e-5, atol=1e-6)
    assert (out.visit_counts.sum(-1) == kw["num_simulations"]).all()
    if invalid is not None:
        assert (out.visit_counts.numpy()[invalid] == 0).all()
        assert (out.action_weights.numpy()[invalid] == 0).all()


def test_widening_that_never_binds_is_no_widening(nets):
    """pw_c = 1e6 never binds: bit for bit the search without widening, in both chance modes."""
    _, tnet = nets
    obs, invalid, keys = make_inputs(13, True)
    for mode in ("argmax", "sample"):
        cfg = mcts.SearchConfig(**BASE, chance_selection=mode)
        _, chance = jax_draws(keys, cfg)
        chance = chance if mode == "sample" else None
        args = (tnet, torch.from_numpy(obs))
        plain = mcts.batched_run_mcts(*args, cfg, torch.from_numpy(invalid), None, chance)
        wide = mcts.batched_run_mcts(*args, cfg._replace(pw_c=1e6), torch.from_numpy(invalid), None, chance)
        for got, want in zip(wide, plain):
            assert torch.equal(got, want)


@pytest.mark.parametrize("sims", [16, 50, 100])
def test_considered_visits_table_matches_jax(sims):
    for m in range(5):
        assert mcts.considered_visits_table(m, sims)[m] == jmcts.considered_visits_table(m, sims)[m]
    assert mcts.considered_visits_table(4, sims) == jmcts.considered_visits_table(4, sims)


def test_widening_cap_at_perfect_squares():
    """ceil(pw_c · (N+1)^pw_alpha) in float32 at N + 1 = 4, 9, 16, …: the
    port's cap equals JAX's and the exact integer (no ulp above it)."""
    n_plus_1 = np.array([k * k for k in range(1, 12)] + [8, 27, 64], np.float32)
    for pw_c, alpha in ((1.0, 0.5), (2.0, 0.75), (1.0, 1.0 / 3.0)):
        ref = np.asarray(jnp.ceil(pw_c * jnp.power(jnp.asarray(n_plus_1), alpha)).astype(jnp.int32))
        got = torch.ceil(pw_c * torch.pow(torch.from_numpy(n_plus_1), alpha)).to(torch.int64).numpy()
        np.testing.assert_array_equal(got, ref)
    exact = torch.ceil(torch.pow(torch.from_numpy(n_plus_1[:11]), 0.5)).numpy()
    np.testing.assert_array_equal(exact, np.arange(1, 12))


def test_draws_from_a_generator():
    """Without fed draws the search takes them from the generator: the same
    seed gives the same searches; a config that needs draws and has neither
    raises."""
    jnet = create_network(jax.random.PRNGKey(1), hidden_size=HIDDEN, num_blocks=1)
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params),
                            replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=1))  # fmt: skip
    obs = torch.from_numpy(make_inputs(0, False)[0])
    cfg = mcts.SearchConfig(**BASE, root_selection="gumbel", chance_selection="sample")
    runs = [mcts.batched_run_mcts(tnet, obs, cfg, generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    for got, want in zip(runs[0], runs[1]):
        assert torch.equal(got, want)
    assert any(not torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
    assert (runs[0].visit_counts.sum(-1) == BASE["num_simulations"]).all()
    with pytest.raises(ValueError, match="Gumbel root"):
        mcts.batched_run_mcts(tnet, obs, cfg)
    with pytest.raises(ValueError, match="chance_selection='sample'"):
        mcts.batched_run_mcts(tnet, obs, cfg._replace(root_selection="puct"))
    noise = mcts.draw_root_noise(cfg, 3, torch.Generator().manual_seed(0), "cpu")
    assert noise.shape == (3, 4) and mcts.draw_root_noise(cfg._replace(gumbel_scale=0.0), 3, None, "cpu") is None

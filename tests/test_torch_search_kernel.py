"""Whole-search kernel module of the PyTorch port vs the JAX package.

On the CPU the wrapper runs the kernel's plain version
(``whole_search_reference``), so these tests hold that version, the packing
and the wrapper's surroundings against:

- JAX ``pack_search_params``: element by element, exactly;
- JAX ``run_mcts_pallas`` in interpret mode (as ``tests/test_pallas_search.py``
  runs it; the Pallas kernel takes batches of 128): visit counts exactly,
  Q and root value within 1e-4;
- the port's own plain search (``batched_run_mcts``): the same.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu.search.mcts import SearchConfig as JaxSearchConfig
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import SearchConfig, batched_run_mcts
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HIDDEN, BLOCKS = 32, 2
CFG = dict(num_simulations=12, max_depth=8, value_transform_epsilon=0.001, dirichlet_fraction=0.0)


@pytest.fixture(scope="module")
def nets():
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=BLOCKS)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS)
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


def make_inputs(b, seed):
    rs = np.random.RandomState(seed)
    obs = (rs.randint(0, 11, size=(b, 16)) / 16.0).astype(np.float32)
    invalid = rs.rand(b, 4) < 0.3
    invalid[invalid.all(-1)] = False
    return obs, invalid


def test_pack_matches_jax_elementwise(nets):
    jnet, tnet = nets
    ref = jps.pack_search_params(jnet.params, BLOCKS, 32)
    got = sk.pack_search_params(tnet, BLOCKS, 32)
    assert len(ref) == len(got)
    for name, r, g in zip(sk.PackedSearchParams._fields, ref, got):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("kwargs", [dict(weight_dtype=torch.bfloat16), dict(stream_chunk=4), dict(value_bins=21)])
def test_pack_unported_variants_raise(nets, kwargs):
    with pytest.raises(NotImplementedError):
        sk.pack_search_params(nets[1], BLOCKS, 32, **kwargs)


@pytest.mark.parametrize("overrides", [dict(), dict(num_simulations=10, max_depth=3, prior_temperature=4.0)])
def test_reference_matches_pallas_interpret(nets, overrides):
    jnet, tnet = nets
    cfg = {**CFG, **overrides}
    obs, invalid = make_inputs(jps.BLOCK_G, seed=17)
    keys = jax.random.split(jax.random.PRNGKey(2), jps.BLOCK_G)
    ref = jps.run_mcts_pallas(
        jnet.params, jnet.apply_fns, jnp.asarray(obs), keys, JaxSearchConfig(**cfg), jnp.asarray(invalid),
        num_blocks=BLOCKS, interpret=True,
    )
    before = sk.LAUNCHES["whole_search"]
    out = sk.run_search_kernel(tnet, torch.from_numpy(obs), SearchConfig(**cfg), torch.from_numpy(invalid))
    assert sk.LAUNCHES["whole_search"] == before, "CPU tensors take the plain version, not the kernel"
    np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
    np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=0, atol=1e-4)


@pytest.mark.parametrize("overrides", [dict(), dict(num_simulations=12, max_depth=3)])
def test_reference_matches_plain_search(nets, overrides):
    _, tnet = nets
    cfg = SearchConfig(**{**CFG, **overrides})
    obs, invalid = make_inputs(8, seed=23)
    obs_t, inv_t = torch.from_numpy(obs), torch.from_numpy(invalid)
    plain = batched_run_mcts(tnet, obs_t, cfg, inv_t)
    packed = sk.pack_search_params(tnet, BLOCKS, 32)
    out = sk.run_search_kernel(tnet, obs_t, cfg, inv_t, packed=packed)
    np.testing.assert_array_equal(out.visit_counts.numpy(), plain.visit_counts.numpy())
    np.testing.assert_allclose(out.qvalues.numpy(), plain.qvalues.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.search_value.numpy(), plain.search_value.numpy(), rtol=0, atol=1e-4)


def test_wrapper_checks_scope(nets):
    _, tnet = nets
    obs, _ = make_inputs(4, seed=0)
    with pytest.raises(NotImplementedError, match="widening"):
        sk.run_search_kernel(tnet, torch.from_numpy(obs), SearchConfig(**{**CFG, "pw_c": 1.0}))

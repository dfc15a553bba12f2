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
from simulate_2048_tpu.search.mcts import batched_run_mcts as jax_batched_run_mcts
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.models.network import MuZeroNetwork
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
    assert len(ref) == len(got.tensors)
    assert (got.num_blocks, got.stream_chunk) == (BLOCKS, 0)
    for name, r, g in zip(sk.PackedSearchParams._fields, ref, got):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("kwargs", [dict(weight_dtype=torch.float16), dict(weight_dtype=torch.float64)])
def test_pack_unported_variants_raise(nets, kwargs):
    """Only float32 and bfloat16 packs exist (JAX's ``weight_dtype`` takes those two)."""
    with pytest.raises(NotImplementedError):
        sk.pack_search_params(nets[1], BLOCKS, 32, **kwargs)


def test_pack_checks_head_shapes(nets):
    """The bins passed must be the network's own (they decide which pack a head goes to)."""
    with pytest.raises(ValueError, match="do not match"):
        sk.pack_search_params(nets[1], BLOCKS, 32, value_bins=21)


# ---- categorical heads (variant (b) of the kernel): value, Q and reward heads
# as (H, bins) matrices reduced to h-space expectations inside the search.

CAT_BINS = [(16, 8), (16, 1)]  # both categorical; value categorical with a scalar reward head


def cat_nets(value_bins: int, reward_bins: int):
    """Networks with categorical heads, their zero-initialised head kernels
    perturbed (0.05 * normal, numpy-seeded): with zero kernels every node
    gets the same expectation, min-max Q divides float noise by its 1e-8
    floor and the argmax compares rounding, not search semantics."""
    jnet = create_network(jax.random.PRNGKey(2), hidden_size=HIDDEN, num_blocks=BLOCKS, value_bins=value_bins,
                          reward_bins=reward_bins)
    params = jax.tree.map(np.array, jax.device_get(jnet.params))
    rs = np.random.RandomState(99)
    for tree, name in ((params.prediction, "value"), (params.afterstate_prediction, "q_value"),
                       (params.dynamics, "reward")):
        kernel = tree["params"][name]["kernel"]
        if kernel.shape[-1] > 1:
            tree["params"][name]["kernel"] = kernel + 0.05 * rs.standard_normal(kernel.shape).astype(np.float32)
    jnet = jnet._replace(params=params)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS, value_bins=value_bins,
                  reward_bins=reward_bins)
    return jnet, params_from_flax(params, cfg)


@pytest.mark.parametrize("bins", CAT_BINS, ids=["categorical", "mixed"])
def test_categorical_pack_matches_jax_elementwise(bins):
    jnet, tnet = cat_nets(*bins)
    ref = jps.pack_search_params(jnet.params, BLOCKS, 32, value_bins=bins[0], reward_bins=bins[1])
    got = sk.pack_search_params(tnet, BLOCKS, 32, value_bins=bins[0], reward_bins=bins[1])
    assert sk.cat_layout(*bins) == jps._cat_layout(*bins)
    for name, r, g in zip(sk.PackedSearchParams._fields, ref, got):
        assert tuple(g.shape) == tuple(r.shape), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert float(got.cat.abs().max()) > 0
    scalar_columns = [c for c, b in enumerate((bins[0], bins[0], bins[1])) if b > 1]
    assert float(got.scal[:, scalar_columns].abs().max()) == 0, "a categorical head leaves its scal column zero"


@pytest.mark.parametrize("bins", CAT_BINS, ids=["categorical", "mixed"])
def test_categorical_search_matches_jax(bins):
    """Visit counts identical to the JAX kernel (interpret mode) and to the JAX
    plain search, from the port's plain kernel version and the port's plain
    search; root Q and value within rtol 1e-3 / atol 2e-4. The absolute
    tolerance is one step of h⁻¹ in float32 near 0: with ε = 0.001,
    (√(1 + 4ε(|x| + 1 + ε)) − 1) / 2ε resolves 2⁻²³ / 2ε ≈ 6e-5 and is then
    squared, so raw values near 0.004 (which these fresh heads give) move in
    steps of 1.19e-4 and one rounding inside a head shows as one such step."""
    jnet, tnet = cat_nets(*bins)
    cfg = {**CFG, "value_bins": bins[0], "reward_bins": bins[1]}
    obs, _ = make_inputs(jps.BLOCK_G, seed=12)
    keys = jax.random.split(jax.random.PRNGKey(2), jps.BLOCK_G)
    jcfg, jobs = JaxSearchConfig(**cfg), jnp.asarray(obs)
    refs = [
        jps.run_mcts_pallas(jnet.params, jnet.apply_fns, jobs, keys, jcfg, num_blocks=BLOCKS, interpret=True),
        jax_batched_run_mcts(jnet.params, jnet.apply_fns, jobs, keys, jcfg),
    ]
    outs = [
        sk.run_search_kernel(tnet, torch.from_numpy(obs), SearchConfig(**cfg)),
        batched_run_mcts(tnet, torch.from_numpy(obs), SearchConfig(**cfg)),
    ]
    for ref in refs:
        for out in outs:
            np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
            np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=1e-3, atol=2e-4)
            np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=1e-3, atol=2e-4)


def test_wrapper_checks_bins(nets):
    """The CUDA path's input check states the supported bins and rejects a pack of another layout."""
    jnet, tnet = cat_nets(16, 8)
    packed = sk.pack_search_params(tnet, BLOCKS, 32, value_bins=16, reward_bins=8)
    roots = (torch.zeros(4, HIDDEN), torch.zeros(4, 32), torch.zeros(4))
    ok = SearchConfig(**{**CFG, "value_bins": 16, "reward_bins": 8})
    sk._check_inputs(*roots, packed, ok)
    with pytest.raises(ValueError, match="bins"):
        sk._check_inputs(*roots, packed, ok._replace(value_bins=sk.MAX_BINS + 1))
    with pytest.raises(ValueError, match="categorical pack"):
        sk._check_inputs(*roots, packed, ok._replace(reward_bins=1))


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


# ---- the pack rule and the launch key that every caller of the kernel shares


def random_network(hidden: int, codebook: int = 32, value_bins: int = 1, reward_bins: int = 1) -> MuZeroNetwork:
    """A one-block network of normal weights (seeded), so that every packed tensor is distinct."""
    net = MuZeroNetwork(codebook_size=codebook, hidden_size=hidden, num_blocks=1, value_bins=value_bins,
                        reward_bins=reward_bins)  # fmt: skip
    gen = torch.Generator().manual_seed(hidden)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return net


@pytest.mark.parametrize(
    "hidden, dtype, chunk",
    [(32, torch.float32, 0), (32, torch.bfloat16, 0), (256, torch.bfloat16, 0), (288, torch.float32, sk.STREAM_CHUNK),
     (288, torch.bfloat16, sk.STREAM_CHUNK)],
)  # fmt: skip
def test_pack_for_takes_search_plans_layout(hidden, dtype, chunk):
    """Resident up to H=256 and streamed in chunks of STREAM_CHUNK layers above, in either weight type, with the
    search config's heads: the pack pack_search_params makes for search_plan's chunk."""
    cfg = SearchConfig(num_simulations=4, value_bins=16, reward_bins=8)
    net = random_network(hidden, value_bins=16, reward_bins=8)
    assert sk.search_plan(cfg, hidden, dtype) == chunk
    got = sk.pack_for(net, cfg, dtype)
    want = sk.pack_search_params(net, 1, 32, dtype, chunk or None, value_bins=16, reward_bins=8)
    assert (got.num_blocks, got.stream_chunk, got.hh.dtype, got.cat.shape[1]) == (1, chunk, dtype, 2 * 16 + 8)
    assert got.hh.shape[0] == len(sk.call_order(1)) + (-len(sk.call_order(1)) % chunk if chunk else 0)
    for name, g, w in zip(sk.PackedSearchParams._fields, got.tensors, want.tensors):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("chunk", [0, 3])
def test_pack_for_takes_a_given_layout(chunk):
    """A given chunk replaces the plan's, where the kernel refuses the shape too (K = 64 child slots, which the
    plain version on the CPU takes): 0 packs resident, 3 streams in chunks of 3 layers."""
    cfg = SearchConfig(num_simulations=4, codebook_size=64)
    net = random_network(32, codebook=64)
    with pytest.raises(ValueError, match="K <= 32"):
        sk.pack_for(net, cfg)
    got = sk.pack_for(net, cfg, stream_chunk=chunk)
    want = sk.pack_search_params(net, 1, 64, stream_chunk=chunk or None)
    assert got.stream_chunk == chunk and got.hh.shape[0] == (16 if chunk == 0 else 18)
    for name, g, w in zip(sk.PackedSearchParams._fields, got.tensors, want.tensors):
        assert torch.equal(g, w), name


@pytest.mark.parametrize(
    "library, bins, key",
    [("whole_search", (1, 1), "whole_search"), ("whole_search", (16, 8), "whole_search_categorical"),
     ("whole_search", (16, 1), "whole_search_categorical"), ("whole_search", (1, 8), "whole_search_categorical"),
     ("whole_search_bf16", (16, 8), "whole_search_bf16"), ("whole_search_streamed", (16, 8), "whole_search_streamed"),
     ("whole_search_bf16_streamed", (1, 1), "whole_search_bf16_streamed")],
)  # fmt: skip
def test_launch_key(library, bins, key):
    """The float32 resident library's launches count by heads (at least one categorical head: its own key), every
    other library's under its name."""
    cfg = SearchConfig(num_simulations=4, value_bins=bins[0], reward_bins=bins[1])
    assert sk.launch_key(library, cfg) == key
    assert key in sk.LAUNCHES

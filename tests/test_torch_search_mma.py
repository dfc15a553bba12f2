"""The tensor-core bfloat16 libraries of the whole-search kernel: what of them runs on the CPU.

Both bfloat16 libraries, resident and streamed (``csrc/whole_search.cu``,
``whole_search_mma_kernel``), multiply on the tensor cores (``mma.sync``
m16n8k16) over a copy of the pack's layers in call order and fragment
order, sum each output by 16-row k-steps, and take any H that is a multiple
of 32 (resident up to 256, streamed up to 512). These tests hold the Python
side of that against the PTX ISA's fragment layout and the JAX package:

- (a) ``mma_fragments`` places ``hh[layer][k][m]`` where the PTX ISA's
  m16n8k16 A fragment (row-major bfloat16, A = W^T) puts it, and the inverse
  map rebuilds ``hh`` exactly;
- (b) the plain version summed by k-steps (``order="ksteps"``) against JAX's
  bfloat16 Pallas kernel in interpret mode, by ``bf16_rule``, with scalar and
  categorical heads;
- (c) at H=96, no power of two, the plain version's zero-padded trees
  against JAX's bfloat16 kernel by ``bf16_rule`` (its tight count's
  allowance grown with H, as ``meets_bf16_rule`` says why); at a
  power-of-two H the padded sum is the unpadded tree bit for bit;
- (d) ``search_plan`` keeps a bfloat16 pack resident up to H=256 at any
  multiple of 32, as a float32 one, and streams it above; a resident pack's
  fragment copy is the streamed pack's, element for element; and
  ``kernel_blocks`` counts blocks of each library's G, a last partial block
  included;
- (e) the layer norm the kernel takes in a dense layer's epilogue
  (``epilogue_layer_norm``: m-tile statistics combined in one order)
  against the two-pass layer norm, on a row of zero variance, on a row of
  large mean and small spread, and whatever number of warps owns the m-tiles.

The kernel itself, its dense probe and the parity rule for its searches run
on the card in ``chip_smoke.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_search_kernel import BLOCKS, CFG, make_inputs
from test_torch_search_variants import HEADS, bf16_rule, head_nets, jax_search, meets_bf16_rule, port_search

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import SearchConfig, policy_output, root_inputs
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)


def ptx_a_fragment(lane: int, e: int) -> tuple[int, int]:
    """(row, col) of value a_e of lane ``lane`` in an m16n8k16 A fragment of
    16-bit types, as the PTX ISA's table gives them (groupID = lane >> 2,
    threadID_in_group = lane % 4)."""
    group, thread = lane >> 2, lane % 4
    row = group if e < 2 or 4 <= e < 6 else group + 8
    col = thread * 2 + (e & 1) + (8 if e >= 4 else 0)
    return row, col


@pytest.mark.parametrize("h", [32, 96])
def test_fragment_order_places_each_weight_where_the_ptx_layout_reads_it(h):
    """Element [layer, k-step, m-tile, lane, e] is the A operand's (row, col)
    of a_e: output 16 mt + row, input 16 ks + col of that layer."""
    rs = np.random.RandomState(h)
    hh = torch.from_numpy(rs.standard_normal((3, h, h)).astype(np.float32)).to(torch.bfloat16)
    frags = sk.mma_fragments(hh)
    n = h // 16
    assert frags.shape == (3, n, n, 32, 8) and frags.dtype == torch.bfloat16 and frags.is_contiguous()
    for lane in range(32):
        for e in range(8):
            row, col = ptx_a_fragment(lane, e)
            want = hh[:, col::16, row::16]  # [layer, ks, mt] = hh[layer][16 ks + col][16 mt + row]
            assert torch.equal(frags[:, :, :, lane, e], want), (lane, e)
    # The inverse map rebuilds hh exactly.
    rebuilt = torch.empty_like(hh)
    for lane in range(32):
        for e in range(8):
            row, col = ptx_a_fragment(lane, e)
            rebuilt[:, col::16, row::16] = frags[:, :, :, lane, e]
    assert torch.equal(rebuilt, hh)


@pytest.mark.parametrize("h", [32, 64, 96])
def test_resident_and_streamed_packs_give_the_same_fragments(h):
    """A resident bfloat16 pack's copy takes its layers in call order (φ fuse
    first, the f tower last), so the resident library's ring reads what the
    streamed one reads: the two copies are equal element for element."""
    jnet = create_network(jax.random.PRNGKey(h), hidden_size=h, num_blocks=BLOCKS)
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params),
                            replace(TrainConfig(), hidden_size=h, num_residual_blocks=BLOCKS))  # fmt: skip
    resident = sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16)
    streamed = sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16, sk.STREAM_CHUNK)
    frags = sk.SearchWorkspace(resident).fragments
    assert torch.equal(frags, sk.SearchWorkspace(streamed).fragments)
    assert frags.shape == (len(sk.call_order(BLOCKS)), h // 16, h // 16, 32, 8) and frags.is_contiguous()
    # Its first layer is the φ fuse layer, pack layer tower_hh of the resident pack.
    assert torch.equal(frags[0], sk.mma_fragments(resident.hh[1 + 2 * BLOCKS][None])[0])


def test_workspace_fragments_hold_the_streamed_packs_real_layers():
    """A bfloat16 streamed pack's copy: its real layers in call order, the padding left out;
    a k-step of a layer is one contiguous run of (H/16) x 512 bytes."""
    _, tnet = head_nets("categorical")
    packed = sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16, 16, value_bins=16, reward_bins=8)
    n_real = len(sk.call_order(BLOCKS))
    assert packed.hh.shape[0] > n_real  # chunk 16 pads
    frags = sk.SearchWorkspace(packed).fragments
    h = packed.hh.shape[1]
    assert torch.equal(frags, sk.mma_fragments(packed.hh[:n_real]))
    assert frags.stride()[:2] == ((h // 16) ** 2 * 256, (h // 16) * 256)  # elements: 512 bytes a (k-step, m-tile)


def ordered_search(tnet, obs, invalid, cfg, order: str, hidden: int = 32):
    """The plain version on a bfloat16 pack (streamed when ``search_plan``
    streams ``hidden``) with its dense layers summed in ``order``."""
    vb, rb = cfg.get("value_bins", 1), cfg.get("reward_bins", 1)
    chunk = sk.search_plan(SearchConfig(**cfg), hidden, torch.bfloat16) or None
    packed = sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16, chunk, value_bins=vb, reward_bins=rb)
    scfg = SearchConfig(**cfg)
    root_h, probs, value = root_inputs(tnet, torch.from_numpy(obs), scfg, torch.from_numpy(invalid))
    return policy_output(*sk.whole_search_reference(root_h, probs, value, packed, scfg, order))


@pytest.mark.parametrize("heads", ["scalar", "categorical"])
def test_ksteps_reference_matches_jax_interpret(heads):
    """Summed by 16-row k-steps, as the tensor cores sum, the bfloat16 plain
    version is as near JAX's bfloat16 kernel as the tree order is: by
    ``bf16_rule``, on 128 searches."""
    jnet, tnet = head_nets(heads)
    vb, rb = HEADS[heads]
    cfg = {**CFG, "value_bins": vb, "reward_bins": rb}
    obs, invalid = make_inputs(jps.BLOCK_G, seed=17)
    ref = jax_search(jnet, obs, invalid, cfg, jnp.bfloat16)
    out = ordered_search(tnet, obs, invalid, cfg, "ksteps")
    assert (out.visit_counts.sum(-1) == cfg["num_simulations"]).all()
    counts = bf16_rule(out, ref)
    assert meets_bf16_rule(counts), f"{counts} of {jps.BLOCK_G} searches agree / lie close"


def test_unknown_order_raises():
    with pytest.raises(ValueError, match="ksteps"):
        sk.bf16_dense_sum(torch.zeros(2, 32), torch.zeros(32, 32), "rows")


@pytest.mark.parametrize("h", [32, 64, 512])
def test_padded_tree_is_the_unpadded_tree_at_a_power_of_two(h):
    """At a power-of-two H no zero product is added: the sum is the
    balanced tree over each input half, as before the padding, bit for bit."""
    rs = np.random.RandomState(h)
    x = torch.from_numpy(rs.standard_normal((3, h)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((h, h)).astype(np.float32)).to(torch.bfloat16).float()
    terms = x.to(torch.bfloat16).float()[:, :, None] * w[None]
    terms = terms.view(3, 2, h // 2, h)
    while terms.shape[2] > 1:
        terms = terms[:, :, 0::2] + terms[:, :, 1::2]
    assert torch.equal(sk.bf16_dense_sum(x, w), terms[:, 0, 0] + terms[:, 1, 0])
    # k-steps: each 16-row step's sum, the steps added in ascending order
    steps = [terms_k.sum(1) for terms_k in (x.to(torch.bfloat16).float()[:, :, None] * w[None]).split(16, 1)]
    want = steps[0]
    for s in steps[1:]:
        want = want + s
    assert torch.equal(sk.bf16_dense_sum(x, w, "ksteps"), want)


def test_bf16_reference_at_h96_matches_jax_interpret():
    """H=96 (a multiple of 32, no power of two): JAX's bfloat16 kernel takes
    it, and so does the port now, each input half's tree padded with zero
    products to 64 rows and each LayerNorm lane's values to 4. By
    ``bf16_rule`` at H=96 on 128 searches, through the resident pack the plan
    picks; at a power-of-two width (128) the unpadded trees meet JAX's kernel
    no closer (17 searches outside the tight tolerance, as here)."""
    h = 96
    jnet = create_network(jax.random.PRNGKey(5), hidden_size=h, num_blocks=BLOCKS)
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params),
                            replace(TrainConfig(), hidden_size=h, num_residual_blocks=BLOCKS))  # fmt: skip
    chunk = sk.search_plan(SearchConfig(**CFG), h, torch.bfloat16)
    assert chunk == 0
    obs, invalid = make_inputs(jps.BLOCK_G, seed=23)
    ref = jax_search(jnet, obs, invalid, CFG, jnp.bfloat16)
    out = port_search(tnet, obs, invalid, CFG, torch.bfloat16, chunk or None)
    assert (out.visit_counts.sum(-1) == CFG["num_simulations"]).all()
    counts = bf16_rule(out, ref)
    assert meets_bf16_rule(counts, h), f"{counts} of {jps.BLOCK_G} searches agree / lie close"
    # The padded trees are as near the k-step order, which pads nothing, as JAX's kernel is.
    ksteps = ordered_search(tnet, obs, invalid, CFG, "ksteps", h)
    assert meets_bf16_rule(bf16_rule(ksteps, out), h)


@pytest.mark.parametrize("h", [96, 160, 288, 480])
def test_search_plan_streams_bf16_widths_that_are_no_power_of_two(h):
    """No power of two: resident up to H=256 and streamed above, bfloat16 as float32."""
    cfg = SearchConfig(num_simulations=100, max_depth=32)
    want = 0 if h <= sk.RESIDENT_MAX_H else sk.STREAM_CHUNK
    assert sk.search_plan(cfg, h, torch.bfloat16) == want == sk.search_plan(cfg, h, torch.float32)
    assert sk.search_plan(cfg, 128, torch.bfloat16) == 0  # a power of two stays resident up to 256


def test_check_inputs_takes_a_streamed_bf16_pack_of_any_multiple_of_32():
    """The CUDA path's input check: a bfloat16 pack at H=96 passes, streamed
    and now resident too (the resident library runs on the tensor cores)."""
    h = 96
    cfg = SearchConfig(**CFG)
    roots = (torch.zeros(4, h), torch.zeros(4, 32), torch.zeros(4))
    tnet = params_from_flax(
        jax.tree.map(np.asarray, create_network(jax.random.PRNGKey(5), hidden_size=h, num_blocks=BLOCKS).params),
        replace(TrainConfig(), hidden_size=h, num_residual_blocks=BLOCKS),
    )
    sk._check_inputs(*roots, sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16, sk.STREAM_CHUNK), cfg)
    sk._check_inputs(*roots, sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16), cfg)


@pytest.mark.parametrize("library", list(sk.SEARCHES_PER_BLOCK))
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 128, 255, 256, 512, 1001])
def test_kernel_blocks_by_library(library, batch):
    g = sk.SEARCHES_PER_BLOCK[library]
    blocks = sk.kernel_blocks(batch, library)
    assert blocks * g >= batch and (blocks - 1) * g < batch  # the last block's searches past B are dummies
    assert blocks == -(-batch // g)
    assert sk.library_name(torch.bfloat16, True) == "whole_search_bf16_streamed"


def test_tensor_core_library_runs_more_searches_a_block():
    """G of both tensor-core libraries fills the m16n8k16 product's 8
    columns; the float32 (CUDA-core) libraries keep 2."""
    assert sk.SEARCHES_PER_BLOCK["whole_search_bf16_streamed"] == sk.SEARCHES_PER_BLOCK["whole_search_bf16"] == 8
    assert {sk.SEARCHES_PER_BLOCK[k] for k in ("whole_search", "whole_search_streamed")} == {2}
    assert sk.kernel_blocks(512, "whole_search_bf16_streamed") == 64
    assert sk.kernel_blocks(100, "whole_search_bf16_streamed") == 13
    assert sk.kernel_blocks(1024, "whole_search_bf16") == 128  # one wave of the card's 132 SMs


# ---- (e) the layer norm in the dense layer's epilogue

EPS = 2.0**-24  # float32's unit roundoff


def two_pass_layer_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    d = x - mean
    return d * torch.rsqrt((d * d).mean(-1, keepdim=True) + 1e-6)


@pytest.mark.parametrize("h", [96, 256, 512])
def test_epilogue_layer_norm_meets_the_two_pass_layer_norm(h):
    """Rows of several means and spreads. The two layer norms differ only in
    the order of the float32 sums that make the mean and the variance: the
    epilogue's adds 16 values an m-tile in 4 levels, then H/64 m-tiles a lane
    in turn and 4 lanes in 2 levels; PyTorch's is no deeper. Each sum then
    carries fewer than 8 + H/16 roundings of EPS of terms up to max|x|, and an
    error of the mean moves a normalised value by its size over the row's
    spread σ (the variance's error moves it less), so each row's values agree
    within 4 (8 + H/16) EPS max|x| / σ, twice the sum of the two bounds (2e-5
    at H=256 for unit rows)."""
    rs = np.random.RandomState(h)
    scale = torch.tensor([1.0, 3.0, 0.1, 10.0]).repeat_interleave(64)[:, None]
    shift = torch.tensor([0.0, 1.0, 5.0, -20.0]).repeat_interleave(64)[:, None]
    x = (torch.from_numpy(rs.standard_normal((256, h)).astype(np.float32)) * scale + shift).float()
    gamma = torch.from_numpy(rs.standard_normal(h).astype(np.float32))
    beta = torch.from_numpy(rs.standard_normal(h).astype(np.float32))
    got = sk.epilogue_layer_norm(x, torch.ones(h), torch.zeros(h))
    want = two_pass_layer_norm(x)
    tol = 4 * (8 + h // 16) * EPS * x.abs().amax(-1, keepdim=True) / x.double().std(-1, keepdim=True).float()
    assert ((got - want).abs() <= tol).all(), float(((got - want).abs() / tol).max())
    # The affine part is the plain version's: y * gamma + beta, each rounded.
    assert torch.equal(sk.epilogue_layer_norm(x, gamma, beta), got * gamma + beta)


@pytest.mark.parametrize("h", [96, 256, 512])
def test_epilogue_layer_norm_of_a_row_of_zero_variance(h):
    """A constant row: where its m-tile sums add exactly (these constants), the
    mean is the constant, the variance 0 and the output beta, bit for bit;
    for any constant the variance is never negative (E[x²] − mean² can be)
    and the mean within H/16 roundings of it."""
    beta = torch.linspace(-1, 1, h)
    for c in (0.75, -2.5, 1024.0, 0.0):
        x = torch.full((2, h), c)
        mean, var = sk.epilogue_moments(x)
        assert torch.equal(mean, x[:, 0]) and torch.equal(var, torch.zeros(2))
        assert torch.equal(sk.epilogue_layer_norm(x, torch.ones(h), beta), beta.expand(2, h))
    for c in (3.3, -0.123456789, 7777.77):
        x = torch.full((2, h), c)
        mean, var = sk.epilogue_moments(x)
        assert (var >= 0).all() and torch.isfinite(sk.epilogue_layer_norm(x, torch.ones(h), beta)).all()
        assert ((mean - c).abs() <= (h // 16) * EPS * 2 * abs(c)).all()


@pytest.mark.parametrize("h", [96, 256, 512])
def test_epilogue_variance_of_a_large_mean_and_small_spread(h):
    """Rows of mean 1,000 and spread 0.01: E[x²] − mean² in float32 loses the
    variance (it reads 0 or a multiple of ulp(10⁶) = 0.0625, against 10⁻⁴);
    the m-tiles' squared deviations, combined by Chan's rule, keep it within
    1% of the float64 variance of the same float32 values, as the two-pass
    variance does."""
    rs = np.random.RandomState(h)
    x = torch.from_numpy((1000 + rs.standard_normal((64, h)) * 1e-2).astype(np.float32))
    want = x.double().var(-1, unbiased=False)
    _, var = sk.epilogue_moments(x)
    assert ((var.double() - want).abs() <= 0.01 * want).all()
    mean = x.mean(-1, keepdim=True)
    assert ((((x - mean) ** 2).mean(-1).double() - want).abs() <= 0.01 * want).all()
    naive = (x * x).mean(-1) - x.mean(-1) ** 2
    assert ((naive.double() - want).abs() > 0.5 * want).all()


@pytest.mark.parametrize("h", [96, 256, 512])
def test_epilogue_layer_norm_is_the_same_whoever_owns_the_mtiles(h):
    """The resident library's 8 warps and the streamed one's 12 (and any other
    count) own the m-tiles differently; each m-tile is summed alone and the
    combine takes them in one order, so the bits are the same."""
    rs = np.random.RandomState(h + 1)
    x = torch.from_numpy((rs.standard_normal((16, h)) * 2 + 0.5).astype(np.float32))
    gamma = torch.from_numpy(rs.standard_normal(h).astype(np.float32))
    beta = torch.from_numpy(rs.standard_normal(h).astype(np.float32))
    want = sk.epilogue_layer_norm(x, gamma, beta, warps=8)
    for warps in (1, 5, 12, 32):
        assert torch.equal(sk.epilogue_layer_norm(x, gamma, beta, warps=warps), want)
        assert all(torch.equal(a, b) for a, b in zip(sk.epilogue_moments(x, warps), sk.epilogue_moments(x)))

"""Variants (c) bfloat16 packs and (d) streamed weights of the whole-search
kernel module, against the JAX package on the CPU.

- Packs equal JAX ``pack_search_params``'s element by element (bfloat16 values
  exactly) for scalar, categorical and mixed heads, resident and streamed at
  chunks 1, 2, 8 and 16 (16 exercises the zero padding: two blocks make
  4 (1 + 2·2) + 4 = 24 layers, a multiple of 1, 2 and 8, padded to 32).
- The plain version on a bfloat16 pack against JAX ``run_mcts_pallas`` with
  ``weight_dtype=bfloat16`` in interpret mode, 128 searches.
- Streamed packs give bit-identical searches to resident ones in the plain
  version, and agree with JAX's streamed interpret kernel.
- ``search_plan`` makes JAX ``pallas_search_plan``'s resident / streamed
  decisions (``tests/test_pallas_search.py``'s configs and the hidden-512
  ones; bfloat16 resident at every multiple of 32 up to 256), and it and the
  wrapper's input check refuse exactly what ``kernel_limits`` refuses.
- A greedy segment through ``self_play._make_search`` with
  ``search_weight_dtype="bfloat16"`` runs the bfloat16 plain version.

The CUDA kernels themselves are held against the plain version on the card
by ``chip_smoke.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_search_kernel import BLOCKS, CFG, HIDDEN, cat_nets, make_inputs
from test_torch_self_play import make_pair, play_both

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu.search.mcts import SearchConfig as JaxSearchConfig
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import SearchConfig
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HEADS = {"scalar": (1, 1), "categorical": (16, 8), "mixed": (16, 1)}


def head_nets(heads: str):
    """(JAX network, port network) with the same weights; categorical heads perturbed."""
    bins = HEADS[heads]
    if bins != (1, 1):
        return cat_nets(*bins)
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=BLOCKS)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS)
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


def pack_pair(heads: str, dtype: str, chunk: int | None):
    """The JAX pack and the port's pack of the same network."""
    jnet, tnet = head_nets(heads)
    vb, rb = HEADS[heads]
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jps.pack_search_params(jnet.params, BLOCKS, 32, jdtype, chunk, value_bins=vb, reward_bins=rb)
    got = sk.pack_search_params(tnet, BLOCKS, 32, tdtype, chunk, value_bins=vb, reward_bins=rb)
    return ref, got


@pytest.mark.parametrize("chunk", [None, 1, 2, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", list(HEADS))
def test_variant_packs_match_jax_elementwise(heads, dtype, chunk):
    ref, got = pack_pair(heads, dtype, chunk)
    assert len(ref) == len(got.tensors)
    assert (got.num_blocks, got.stream_chunk) == (BLOCKS, chunk or 0)
    wide_types = ("hh", "win", "wide", "cat")  # the weight dtype; the rest stays float32
    for name, r, g in zip(sk.PackedSearchParams._fields, ref, got.tensors):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        assert g.dtype == (torch.bfloat16 if dtype == "bfloat16" and name in wide_types else torch.float32), name
        assert str(r.dtype) == str(g.dtype).removeprefix("torch."), name
        np.testing.assert_array_equal(g.float().numpy(), r.astype(np.float32), err_msg=name)
    n_real = 4 * (1 + 2 * BLOCKS) + 4
    assert got.hh.shape[0] == n_real + (-n_real % chunk if chunk else 0)


def test_pack_rejects_a_chunk_below_one():
    with pytest.raises(ValueError, match="stream_chunk"):
        sk.pack_search_params(head_nets("scalar")[1], BLOCKS, 32, stream_chunk=0)


def jax_search(jnet, obs, invalid, cfg, dtype=jnp.float32, chunk=None):
    keys = jax.random.split(jax.random.PRNGKey(2), jps.BLOCK_G)
    return jps.run_mcts_pallas(
        jnet.params, jnet.apply_fns, jnp.asarray(obs), keys, JaxSearchConfig(**cfg), jnp.asarray(invalid),
        num_blocks=BLOCKS, interpret=True, weight_dtype=dtype, stream_chunk=chunk,
    )  # fmt: skip


def port_search(tnet, obs, invalid, cfg, dtype=torch.float32, chunk=None):
    vb, rb = cfg.get("value_bins", 1), cfg.get("reward_bins", 1)
    packed = sk.pack_search_params(tnet, BLOCKS, 32, dtype, chunk, value_bins=vb, reward_bins=rb)
    obs_t, invalid_t = torch.from_numpy(obs), torch.from_numpy(invalid)
    return sk.run_search_kernel(tnet, obs_t, SearchConfig(**cfg), invalid_t, packed=packed)


def agreeing_searches(out, ref, rtol: float, atol: float) -> np.ndarray:
    """Per search: identical root visits, and root Q and value within the tolerance."""
    same = (out.visit_counts.numpy() == np.asarray(ref.visit_counts)).all(-1)
    q_ok = np.isclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=rtol, atol=atol).all(-1)
    v_ok = np.isclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=rtol, atol=atol)
    return same & q_ok & v_ok


def bf16_rule(out, ref) -> tuple[int, int]:
    """The bfloat16 parity rule's two counts: searches that agree (identical
    visits, root Q and value within rtol 1e-3 / atol 1e-2; at least 127 of
    128 must) and searches whose root Q and value lie within 1e-4 (1 + |x|)
    of the reference (at least 120 of 128 must)."""
    close = np.isclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=1e-4, atol=1e-4).all(-1)
    close &= np.isclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=1e-4, atol=1e-4)
    return int(agreeing_searches(out, ref, rtol=1e-3, atol=1e-2).sum()), int(close.sum())


def meets_bf16_rule(counts: tuple[int, int], hidden: int = 32) -> bool:
    """At least 127 of 128 searches agree, and all but 1 in 16 lie close at
    H=32 (``HIDDEN``). A search leaves the tight tolerance when one of the
    activations it rounds to bfloat16 meets a re-rounding, and it rounds H of
    them a layer: at a wider ``hidden`` the tight count's allowance grows with
    H (measured with JAX's kernel on these inputs, the plain version's tree:
    3 searches outside at H=32, 4 at 64, 17 at 96 and 128)."""
    allowance = jps.BLOCK_G // 16 * max(hidden, 32) // 32
    return counts[0] >= jps.BLOCK_G - 1 and counts[1] >= jps.BLOCK_G - allowance


@pytest.mark.parametrize("heads", list(HEADS))
def test_bf16_reference_matches_jax_interpret(heads):
    """The plain version on a bfloat16 pack against JAX's bfloat16 Pallas
    kernel (interpret mode) on 128 searches, by :func:`bf16_rule`: at least
    127 agree, with identical root visits and root Q and value within rtol
    1e-3 / atol 1e-2, and at least 120 lie within 1e-4 (1 + |x|).

    Both round each product's inputs to bfloat16 and sum in float32, but in
    another order. Where two float32 sums of one activation straddle a
    bfloat16 rounding midpoint, the next layer reads values 2⁻⁸ apart, and
    that difference travels through the towers and h⁻¹. A search that meets
    no such re-rounding agrees to float32 noise; one that meets it moves by
    up to a bfloat16 step of its values (2⁻⁸ ≈ 4e-3 relative, times h⁻¹'s
    slope 2(|y| + 1)), which is either a changed visit or a value outside
    the loose tolerance: one search in 128 may do either, and one in 16 may
    leave the tight one. The perturbed categorical heads give small Q and
    values, so the loose tolerance alone would pass the float32 pack's
    search: the tight count is what tells the bfloat16 rounding apart, and
    the float32 pack must fail the rule."""
    jnet, tnet = head_nets(heads)
    vb, rb = HEADS[heads]
    cfg = {**CFG, "value_bins": vb, "reward_bins": rb}
    obs, invalid = make_inputs(jps.BLOCK_G, seed=17)
    ref = jax_search(jnet, obs, invalid, cfg, jnp.bfloat16)
    out = port_search(tnet, obs, invalid, cfg, torch.bfloat16)
    assert (out.visit_counts.sum(-1) == cfg["num_simulations"]).all()
    counts = bf16_rule(out, ref)
    assert meets_bf16_rule(counts), f"{counts} of {jps.BLOCK_G} searches agree / lie close"
    # A port that skipped the bfloat16 rounding (the float32 pack's search) fails the rule.
    f32_counts = bf16_rule(port_search(tnet, obs, invalid, cfg), ref)
    assert not meets_bf16_rule(f32_counts), f"the float32 pack's search passes: {f32_counts}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_equals_resident_bit_for_bit(dtype):
    """Only where ``hh`` is kept changes; every product is the same."""
    jnet, tnet = head_nets("categorical")
    cfg = {**CFG, "value_bins": 16, "reward_bins": 8}
    obs, invalid = make_inputs(16, seed=29)
    tdtype = getattr(torch, dtype)
    resident = port_search(tnet, obs, invalid, cfg, tdtype)
    for chunk in (1, 2, 8, 16):
        streamed = port_search(tnet, obs, invalid, cfg, tdtype, chunk)
        for name in ("visit_counts", "qvalues", "search_value", "action_weights"):
            assert torch.equal(getattr(streamed, name), getattr(resident, name)), (chunk, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_reference_matches_jax_streamed_interpret(dtype):
    """The port's streamed plain version against JAX's streamed kernel
    (``stream_chunk=16``, padded; interpret mode) on the resident parity
    test's inputs (``test_categorical_search_matches_jax``): float32 as there
    (identical visits, atol 2e-4: one float32 step of h⁻¹ near 0), bfloat16
    by :func:`bf16_rule`."""
    jnet, tnet = head_nets("categorical")
    cfg = {**CFG, "value_bins": 16, "reward_bins": 8}
    obs, invalid = make_inputs(jps.BLOCK_G, seed=12)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    ref = jax_search(jnet, obs, invalid, cfg, jdtype, 16)
    out = port_search(tnet, obs, invalid, cfg, tdtype, 16)
    if dtype == "float32":
        np.testing.assert_array_equal(out.visit_counts.numpy(), np.asarray(ref.visit_counts))
        np.testing.assert_allclose(out.qvalues.numpy(), np.asarray(ref.qvalues), rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(out.search_value.numpy(), np.asarray(ref.search_value), rtol=1e-3, atol=2e-4)
    else:
        assert meets_bf16_rule(bf16_rule(out, ref))


# (search config, hidden, num_blocks, weight dtype): tests/test_pallas_search.py's
# TestVmemEnvelope configs, and the hidden-512 towers with both head kinds.
SMALL = dict(num_simulations=50, max_depth=32)
FULL = dict(num_simulations=100, max_depth=32)
FULL_CAT = dict(FULL, value_bins=256, reward_bins=128)
PLAN_CASES = [
    (SMALL, 128, 5, "float32"),
    (FULL, 256, 10, "bfloat16"),
    (FULL, 256, 10, "float32"),
    (FULL_CAT, 256, 10, "bfloat16"),
    (FULL_CAT, 256, 10, "float32"),
    (FULL, 512, 10, "float32"),
    (FULL, 512, 10, "bfloat16"),
    (FULL_CAT, 512, 10, "float32"),
    (FULL_CAT, 512, 10, "bfloat16"),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"{c[1]}x{c[2]}-{c[3]}-bins{c[0].get('value_bins', 1)}")
def test_search_plan_makes_jax_decisions(case):
    """Resident where JAX keeps the weights in VMEM, streamed where it streams
    them. The chunk may differ: JAX picks the largest whose two VMEM slots fit
    its budget (4 for float32 with 256/128-bin heads), the port pads to
    ``STREAM_CHUNK`` layers, since its kernel stages tiles of rows, not chunks."""
    overrides, hidden, nb, dtype = case
    jax_plan = jps.pallas_search_plan(JaxSearchConfig(**overrides), hidden, nb, 256, getattr(jnp, dtype))
    plan = sk.search_plan(SearchConfig(**overrides), hidden, getattr(torch, dtype))
    assert jax_plan is not None
    assert (plan == 0) == (jax_plan == 0)
    assert plan == (0 if hidden <= sk.RESIDENT_MAX_H else sk.STREAM_CHUNK)


def test_search_plan_limits():
    cfg = SearchConfig(**FULL)
    with pytest.raises(ValueError, match="H <= 512"):
        sk.search_plan(cfg, 1024)
    # The kernel's own limits (kernel_limits), which the wrapper's input check reads too; the plain version
    # behind the self-play dispatch on the CPU takes any H.
    with pytest.raises(ValueError, match="H % 32 == 0"):
        sk.search_plan(cfg, 16)
    with pytest.raises(NotImplementedError):
        sk.search_plan(cfg, 256, torch.float16)
    assert sk.search_plan(cfg, 288) == sk.STREAM_CHUNK  # float32 packs take any H % 32 == 0
    # bfloat16 packs stay resident where float32 ones do, at any multiple of 32 up to 256, and stream above
    assert sk.search_plan(cfg, 288, torch.bfloat16) == sk.STREAM_CHUNK
    assert sk.search_plan(cfg, 96, torch.bfloat16) == 0
    with pytest.raises(NotImplementedError, match="widening"):
        sk.search_plan(cfg._replace(pw_c=1.0), 256)


def blank_pack(h: int, k: int, dtype: torch.dtype, chunk: int | None, value_bins: int, reward_bins: int):
    """A pack of zeros of the shapes ``pack_search_params`` gives (no residual blocks)."""
    n_hh = 8 + (-8 % chunk if chunk else 0)
    cb = sk.cat_layout(value_bins, reward_bins)[3]

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt)

    return sk.PackedSearchParams(
        hh=zeros(n_hh, h, h, dt=dtype), vecs=zeros(h, 4 * 3 + 4), win=zeros(2, k, h, dt=dtype),
        wide=zeros(2, h, k, dt=dtype), wide_b=zeros(k, 2), scal=zeros(h, 8), scal_b=zeros(1, 8),
        cat=zeros(h, cb, dt=dtype), cat_b=zeros(cb, 1), num_blocks=0, stream_chunk=chunk or 0,
    )  # fmt: skip


LIMIT_CASES = [
    *[(dict(), h, dtype) for h in (16, 48, 96, 256, 288, 512, 544, 1024) for dtype in ("float32", "bfloat16")],
    (dict(codebook_size=48), 64, "bfloat16"),
    (dict(value_bins=sk.MAX_BINS + 1), 64, "float32"),
    (dict(reward_bins=sk.MAX_BINS + 1), 64, "bfloat16"),
    (dict(value_bins=sk.MAX_BINS, reward_bins=sk.MAX_BINS), 64, "bfloat16"),
    (dict(pw_c=1.0), 64, "float32"),
    (dict(), 64, "float16"),
]


@pytest.mark.parametrize("case", LIMIT_CASES, ids=lambda c: f"{c[0]}-H{c[1]}-{c[2]}")
def test_plan_and_input_check_refuse_what_kernel_limits_refuses(case):
    """``search_plan`` and the wrapper's input check (on a pack of the plan's
    layout, streamed above H=256) refuse exactly the configs and widths that
    ``kernel_limits`` refuses."""
    overrides, h, dtype = case
    cfg = SearchConfig(**{**FULL, **overrides})
    wdtype = getattr(torch, dtype)
    refused = sk.kernel_limits(cfg, h, wdtype)

    def refuses(fn) -> bool:
        try:
            fn()
        except (ValueError, NotImplementedError):
            return True
        return False

    k = max(cfg.num_actions, cfg.codebook_size)
    packed = blank_pack(h, k, wdtype, sk.STREAM_CHUNK if h > sk.RESIDENT_MAX_H else None, cfg.value_bins,
                        cfg.reward_bins)  # fmt: skip
    roots = (torch.zeros(4, h), torch.zeros(4, k), torch.zeros(4))
    assert refuses(lambda: sk.search_plan(cfg, h, wdtype)) == (refused is not None)
    assert refuses(lambda: sk._check_inputs(*roots, packed, cfg)) == (refused is not None)
    assert (refused is None) == (h % 32 == 0 and 32 <= h <= 512 and not overrides.get("pw_c") and dtype != "float16"
                                 and k <= 32 and max(cfg.value_bins, cfg.reward_bins) <= sk.MAX_BINS)  # fmt: skip


@pytest.mark.parametrize("hidden", range(32, 257, 32))
def test_search_plan_keeps_bf16_resident_where_jax_does(hidden):
    """Every multiple of 32 up to 256: JAX's plan keeps a bfloat16 pack in
    VMEM (0) at the paper preset's depth and both head kinds, and so does
    the port's, on the tensor cores."""
    for overrides in (FULL, FULL_CAT):
        jax_plan = jps.pallas_search_plan(JaxSearchConfig(**overrides), hidden, 10, 256, jnp.bfloat16)
        assert jax_plan == 0 == sk.search_plan(SearchConfig(**overrides), hidden, torch.bfloat16)


def test_wrapper_checks_variant_packs():
    """The CUDA path's input check takes bfloat16 and streamed packs and
    rejects mixed dtypes, a layer count that is not the pack's, and H beyond
    the layout's kernel."""
    _, tnet = head_nets("categorical")
    cfg = SearchConfig(**{**CFG, "value_bins": 16, "reward_bins": 8})
    roots = (torch.zeros(4, HIDDEN), torch.zeros(4, 32), torch.zeros(4))
    for dtype in (torch.float32, torch.bfloat16):
        for chunk in (None, 8):
            sk._check_inputs(*roots, sk.pack_search_params(tnet, BLOCKS, 32, dtype, chunk, 16, 8), cfg)
    packed = sk.pack_search_params(tnet, BLOCKS, 32, torch.bfloat16, 16, 16, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        sk._check_inputs(*roots, packed._replace(cat=packed.cat.float()), cfg)
    with pytest.raises(ValueError, match="layers"):
        sk._check_inputs(*roots, packed._replace(stream_chunk=0), cfg)
    with pytest.raises(ValueError, match="layers"):
        sk._check_inputs(*roots, packed._replace(num_blocks=BLOCKS + 2), cfg)
    wide = (torch.zeros(4, 512), *roots[1:])
    resident = packed._replace(stream_chunk=0, hh=torch.zeros(20, 512, 512, dtype=torch.bfloat16),
                               win=torch.zeros(2, 32, 512, dtype=torch.bfloat16))  # fmt: skip
    with pytest.raises(ValueError, match="resident kernel takes 32 <= H <= 256"):
        sk._check_inputs(*wide, resident, cfg)


def test_bf16_greedy_segment_through_make_search(monkeypatch):
    """search_backend="pallas" with search_weight_dtype="bfloat16": the port's
    self-play packs bfloat16 weights through ``_make_search`` and runs the
    plain version on them; the JAX package runs its bfloat16 Pallas kernel in
    interpret mode. 128 games × 3 moves: every search of a game agrees (the
    1-in-128 rule above, per move) in all but 3 games."""
    packs = []
    reference = sk.whole_search_reference

    def spy(root_h, root_p, root_v, packed, cfg):
        packs.append((packed.hh.dtype, packed.cat.dtype, packed.stream_chunk))
        return reference(root_h, root_p, root_v, packed, cfg)

    monkeypatch.setattr(sk, "whole_search_reference", spy)
    pair = make_pair(value_bins=16, reward_bins=8, search_backend="pallas", hidden_size=32,
                     search_weight_dtype="bfloat16")  # fmt: skip
    (_, jtraj, _), (_, ttraj, _) = play_both(*pair, num_games=jps.BLOCK_G, num_steps=3)
    assert packs == [(torch.bfloat16, torch.bfloat16, 0)] * 3
    same = np.ones(jps.BLOCK_G, dtype=bool)
    for name in ("boards", "actions", "rewards", "length", "terminated"):
        got, ref = getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name))
        same &= (got == ref).reshape(jps.BLOCK_G, -1).all(-1)
    close = np.isclose(ttraj.values.numpy(), np.asarray(jtraj.values), rtol=1e-3, atol=1e-2).all(-1)
    assert (same & close).sum() >= jps.BLOCK_G - 3


WIDE_SETS = ["hidden_size=512", "num_residual_blocks=1", "search_weight_dtype=bfloat16", "search_backend=pallas",
             "num_simulations=3", "value_bins=16", "reward_bins=8"]  # fmt: skip


def spy_packs(monkeypatch) -> list:
    """Record (hh dtype, stream_chunk) of every pack the plain version searches with."""
    packs = []
    reference = sk.whole_search_reference

    def spy(root_h, root_p, root_v, packed, cfg):
        packs.append((packed.hh.dtype, packed.stream_chunk))
        return reference(root_h, root_p, root_v, packed, cfg)

    monkeypatch.setattr(sk, "whole_search_reference", spy)
    return packs


def test_cli_entry_points_run_the_streamed_bf16_path_on_cpu(monkeypatch, tmp_path, capsys):
    """``evaluate`` and ``train`` with ``--set hidden_size=512 --set
    search_weight_dtype=bfloat16`` (above the resident kernel's 256): every
    search takes a streamed bfloat16 pack (on the CPU, the plain version),
    self-play, reanalyze, evaluation and deep evaluation alike."""
    from simulate_2048_tpu_torch import evaluate, train

    packs = spy_packs(monkeypatch)
    evaluate.main(["--mode", "tiny", "--games", "2", "--device", "cpu", "--set", "eval_max_moves=3",
                   *[a for s in WIDE_SETS for a in ("--set", s)]])  # fmt: skip
    assert "games: 2" in capsys.readouterr().out
    assert packs and set(packs) == {(torch.bfloat16, sk.STREAM_CHUNK)}
    packs.clear()
    sets = WIDE_SETS + ["max_trajectory_length=3", "num_parallel_games=2", "min_buffer_size=2", "batch_size=4",
                        "eval_max_moves=2", "eval_interval=2", "reanalyze_interval=1", "reanalyze_episodes=2",
                        "reanalyze_mode='search'", "deep_eval_interval=2", "deep_eval_games=2",
                        "checkpoint_interval=2"]  # fmt: skip
    trainer = train.main(["--mode", "tiny", "--steps", "2", "--device", "cpu", "--no-eval",
                          "--checkpoint-dir", str(tmp_path), *[a for s in sets for a in ("--set", s)]])  # fmt: skip
    records = trainer.get_metrics_history()
    assert [r["step"] for r in records if "reanalyze/seconds" in r] == [1]
    assert [r["step"] for r in records if "deep_eval/mean_reward" in r] == [2]
    assert all(np.isfinite(r["total_loss"]) for r in records if "total_loss" in r)
    # self-play 3 moves per segment, reanalyze 2 x 3 positions in one batch, 2 + 2 evaluation moves
    assert set(packs) == {(torch.bfloat16, sk.STREAM_CHUNK)} and len(packs) >= 3 + 1 + 2 + 2

"""Whole-search MCTS kernel (CUDA) with its packing, plain version and wrapper.

Counterpart of the JAX package's ``ops/pallas_search.py`` (the Pallas TPU
kernel ``_make_kernel`` / ``_run_packed``, ``pallas_search_plan`` and
``run_mcts_pallas``), all four variants: (a) scalar and (b) categorical
value/Q/reward heads, (c) float32 or bfloat16 weight packs, and (d) weights
resident or streamed through shared memory (a resident float32 pack, too,
reaches the dense layers through a ring of shared-memory tiles, copied in
:func:`call_order`). The kernel itself is ``csrc/whole_search.cu``; its
header comment says what bounds it on an H100 and how the design answers
that. Both bfloat16 libraries, resident and streamed, run their dense layers
on the tensor cores (``mma.sync``) over a copy of the pack's layers in call
order and fragment order (:func:`mma_fragments`), which a
:class:`SearchWorkspace` makes once per pack.

- :func:`pack_search_params` stacks the f/φ/ψ/g weights in exactly the JAX
  package's layout, so the two packs compare element by element: bfloat16
  ``hh`` / ``win`` / ``wide`` / ``cat`` with ``weight_dtype=torch.bfloat16``,
  and ``hh`` in call order, zero-padded to a multiple of ``stream_chunk``,
  for the streamed kernel. :func:`pack_for` packs a network for a search
  config in :func:`search_plan`'s layout.
- :func:`kernel_limits` says why the CUDA kernel refuses a search config
  and width, or nothing when it takes them; :func:`search_plan` picks the
  layout (resident up to H=256, streamed above), the wrapper's input check
  and the self-play backend dispatch read the same limits.
- :func:`whole_search_reference` is the kernel's plain PyTorch version: the
  same search (``search.mcts.search_tree``) with transitions computed from
  the packed tensors as the kernel computes them (two-pass LayerNorm; a
  categorical head as max, exponentials, two sums and one division; with a
  bfloat16 pack, every product's input rounded to bfloat16, and the dense
  layers and LayerNorms summed as balanced trees, or with
  ``order="ksteps"`` as the tensor-core kernel sums them: the products in
  k-steps, the LayerNorms by m-tiles, :func:`epilogue_layer_norm`).
- :func:`whole_search` is the wrapper: on CPU tensors it runs the plain
  version, on CUDA tensors it launches the kernel or raises. It counts its
  launches in ``LAUNCHES``, each launch once, under its :func:`launch_key`:
  the library that ran it (``"whole_search_bf16"``, ``"whole_search_streamed"``,
  ``"whole_search_bf16_streamed"``); the float32 resident library's
  launches count by head variant (``"whole_search"`` scalar heads,
  ``"whole_search_categorical"`` at least one categorical head). A
  :class:`SearchWorkspace` keeps its set-up across the calls of one
  evaluation. While spans record (``utils.tracing.is_recording``) it
  launches the kernel's clocked instantiation, which counts each computing
  warp's cycles by phase into the unit's ``CLOCK_COUNTERS``; otherwise the
  unclocked one, which has no clock reads.
- :func:`run_search_kernel` is the drop-in for ``batched_run_mcts``: root
  h/f, priors, noise and legality masking in PyTorch, then one
  :func:`whole_search`.
- :class:`RootGraph` replays that root h/f (``search.mcts.root_inputs``, ≈
  850 small kernels at H=256 with 10 blocks) as one CUDA graph, captured at
  its first call; :class:`RootGraphs` fetches the graphs of one network and
  search config by batch shape from a small process-wide cache.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.search.mcts import (
    PolicyOutput,
    SearchConfig,
    Transitions,
    policy_output,
    root_inputs,
    search_tree,
)
from simulate_2048_tpu_torch.utils import tracing

# Kernel launches by library (``_build.LIBRARIES``), the float32 resident
# one's by head variant (scalar heads, or at least one categorical head).
LAUNCHES = {
    "whole_search": 0,
    "whole_search_categorical": 0,
    "whole_search_bf16": 0,
    "whole_search_streamed": 0,
    "whole_search_bf16_streamed": 0,
}

RESIDENT_MAX_H = 256  # resident: float32 2H threads and a producer warp (at most 544); bfloat16 16 m-tiles
STREAMED_MAX_H = 512  # the streamed kernels: 2H threads under __launch_bounds__(1024); the tensor-core one, 32 m-tiles
MAX_WIDTH = 32  # K, the child slots of a node: one warp lane each
STREAM_CHUNK = 8  # layers per unit of zero padding in a streamed pack (JAX's largest chunk)
ROW_PAD = 4  # the tensor-core kernel's float activations are (columns, H + ROW_PAD): kRowPad in csrc/whole_search.cu
# The clocked kernel's counters, in csrc/whole_search.cu's Counter order: the computing warps' cycles in each phase
# (waiting for a weight stage; the products; norms, epilogues and heads; barriers; the tree's walk, gather, install
# and backup) and in all, the dense layers computed, the producer warp's cycles and stalls for a free stage, and the
# layer norms taken in a dense layer's epilogue (the tensor-core kernel's towers: 4 (1 + 2 NB) a simulation).
CLOCK_COUNTERS = tuple(f"search.kernel.cycles.{p}" for p in ("feed", "products", "norm", "barrier", "tree")) + (
    "search.kernel.cycles", "search.kernel.layers", "search.kernel.producer_cycles",
    "search.kernel.producer_stall_cycles", "search.kernel.epilogue_norms",
)  # fmt: skip
# G, the searches one thread block runs, by library (kSearchesPerBlock in csrc/whole_search.cu).
SEARCHES_PER_BLOCK = {
    "whole_search": 2,
    "whole_search_bf16": 8,
    "whole_search_streamed": 2,
    "whole_search_bf16_streamed": 8,
}


class PackedSearchParams(NamedTuple):
    """The JAX package's packed layout (``pack_search_params``) and the two
    facts the layout does not show: the tower depth and the streaming chunk."""

    hh: torch.Tensor  # (n_hh, H, H) [layer][in][out], float32 or bfloat16
    vecs: torch.Tensor  # (H, n_vec) bias / LayerNorm columns, float32
    win: torch.Tensor  # (2, K, H) action / chance input rows, as hh
    wide: torch.Tensor  # (2, H, K) policy / chance logit heads, as hh
    wide_b: torch.Tensor  # (K, 2) float32
    scal: torch.Tensor  # (H, 8) scalar heads [f value, ψ q, g reward], float32
    scal_b: torch.Tensor  # (1, 8) float32
    cat: torch.Tensor  # (H, CB) categorical heads at :func:`cat_layout` offsets (zeros: scalar heads only), as hh
    cat_b: torch.Tensor  # (CB, 1) float32
    num_blocks: int  # residual blocks per tower (NB)
    stream_chunk: int = 0  # 0: hh in pack order; c > 0: in call order, zero-padded to a multiple of c

    @property
    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(self[:9])


MAX_BINS = 512  # categorical heads the kernel takes: 2 <= bins <= MAX_BINS (1 = scalar head)
# Position p holds lane int(f"{p:05b}"[::-1], 2): a butterfly over xor 16, 8,
# 4, 2, 1 sums the lanes as halving sums them in this order.
LANES_BIT_REVERSED = torch.tensor([int(f"{p:05b}"[::-1], 2) for p in range(32)])


def cat_layout(value_bins: int, reward_bins: int) -> tuple[int, int, int, int]:
    """``(v_off, q_off, r_off, cb)``: column offsets of the f-value, ψ-q and
    g-reward segments in the ``(H, CB)`` categorical pack, and its width CB
    (a multiple of 8, at least 8). A head with ``bins == 1`` has no segment."""
    v_off, q_off = 0, value_bins if value_bins > 1 else 0
    r_off = 2 * value_bins if value_bins > 1 else 0
    cols = r_off + (reward_bins if reward_bins > 1 else 0)
    return v_off, q_off, r_off, max(8, -(-cols // 8) * 8)


def call_order(num_blocks: int) -> list[int]:
    """The pack-order ``hh`` layers in the order one expansion calls them: φ
    fuse, the φ tower, φ head, the ψ tower, g fuse, the g tower, g head, then
    the f tower, which the pack holds first. A streamed pack stores its layers
    in this order, and the float32 resident kernel's ring copies a resident
    pack's layers in it (``(j + tower_hh) % n_real`` in ``csrc/whole_search.cu``)."""
    tower_hh = 1 + 2 * num_blocks
    n_real = 4 * tower_hh + 4
    return [(j + tower_hh) % n_real for j in range(n_real)]


def library_name(weight_dtype: torch.dtype, streamed: bool) -> str:
    """The library (``_build.LIBRARIES``) whose kernel runs a pack of these weights and layout."""
    return f"whole_search{'_bf16' * (weight_dtype == torch.bfloat16)}{'_streamed' * streamed}"


def kernel_blocks(batch: int, library: str = "whole_search") -> int:
    """Thread blocks of a launch of ``batch`` searches in ``library``: one per
    ``SEARCHES_PER_BLOCK[library]`` searches (the last block's searches past
    ``batch`` are dummies that run the whole pipeline)."""
    return -(-batch // SEARCHES_PER_BLOCK[library])


def fragment_index(h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The m16n8k16 A fragment's layout (PTX ISA, ``mma.sync`` with bfloat16
    A, row-major): for lane l and value e = 0..7 of its four 32-bit registers
    (register e // 2, low half first), the row (output within the 16-output
    m-tile) and the column (input within the 16-input k-step) it holds. With
    group l // 4 and thread t = l % 4: rows group + 8 (r % 2), columns
    2 t + e % 2 + 8 (r // 2) for register r. Returns (row, col), each (32, 8)."""
    if h % 16:
        raise ValueError(f"fragments take H % 16 == 0 (got H={h})")
    lane, e = torch.arange(32)[:, None], torch.arange(8)[None]
    reg = e // 2
    return lane // 4 + 8 * (reg % 2), 2 * (lane % 4) + e % 2 + 8 * (reg // 2)


def mma_fragments(hh: torch.Tensor) -> torch.Tensor:
    """``hh`` (L, H, H) [layer][in][out] in ``mma.sync`` fragment order:
    (L, H/16 k-steps, H/16 m-tiles, 32 lanes, 8), element [l, ks, mt, lane, e]
    = ``hh[l][16 ks + col][16 mt + row]`` at :func:`fragment_index`'s (row,
    col) of (lane, e), since A = W^T (outputs are the rows). Each lane's 8
    values are its 16 bytes, each (k-step, m-tile) a warp's 512 contiguous
    bytes, each k-step of a layer one run of H/16 x 512 bytes."""
    n_layers, h, _ = hh.shape
    row, col = fragment_index(h)
    tiles = hh.reshape(n_layers, h // 16, 16, h // 16, 16).permute(0, 1, 3, 2, 4)  # [l, ks, mt, k, m]
    return tiles[:, :, :, col.to(hh.device), row.to(hh.device)].contiguous()


def pack_layer(packed_hh: torch.Tensor, ihh: int, num_blocks: int, streamed: bool) -> torch.Tensor:
    """Pack-order layer ``ihh`` of ``packed_hh``, wherever the layout keeps it:
    at ``ihh`` in a resident pack, at its place in :func:`call_order` in a
    streamed one."""
    return packed_hh[call_order(num_blocks).index(ihh) if streamed else ihh]


def _tower_arrays(tw, num_blocks: int) -> tuple[list, list]:
    """TowerWithHead → ([H×H (in, out) matrices], [H-vectors]) in kernel order."""
    hh = [tw.proj.weight.t()]
    vecs = [tw.proj.bias]
    for blk in tw.tower.blocks[:num_blocks]:
        vecs += [blk.norm1.weight, blk.norm1.bias]
        hh.append(blk.fc1.weight.t())
        vecs.append(blk.fc1.bias)
        vecs += [blk.norm2.weight, blk.norm2.bias]
        hh.append(blk.fc2.weight.t())
        vecs.append(blk.fc2.bias)
    vecs += [tw.norm.weight, tw.norm.bias]
    return hh, vecs


@torch.no_grad()
def pack_search_params(
    network,
    num_blocks: int,
    codebook_size: int,
    weight_dtype: torch.dtype = torch.float32,
    stream_chunk: int | None = None,
    value_bins: int = 1,
    reward_bins: int = 1,
) -> PackedSearchParams:
    """Stack the f/φ/ψ/g weights of ``network`` for the kernel, in the JAX
    package's layout and order. ``value_bins``/``reward_bins`` are the head
    shapes of ``network``: a head with ``bins == 1`` packs its weight column
    into ``scal``, a categorical head its ``(H, bins)`` matrix into ``cat``
    (and its ``scal`` column stays zero). ``weight_dtype`` (float32 or
    bfloat16; others raise ``NotImplementedError``) is the type of ``hh``,
    ``win``, ``wide`` and ``cat``; the rest stays float32. With
    ``stream_chunk`` the ``hh`` layers come in the order the search calls
    them (φ fuse … g head, then the f tower) and are zero-padded to a
    multiple of ``stream_chunk``, as the streamed kernel reads them."""
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{weight_dtype} weight packs are not ported (float32 and bfloat16 are)")
    if stream_chunk is not None and stream_chunk < 1:
        raise ValueError(f"stream_chunk must be None or >= 1, not {stream_chunk}")
    if (network.value_bins, network.reward_bins) != (value_bins, reward_bins):
        raise ValueError(
            f"value_bins/reward_bins {value_bins}/{reward_bins} do not match the network's "
            f"{network.value_bins}/{network.reward_bins}"
        )
    f, phi = network.prediction, network.afterstate_dynamics
    psi, g = network.afterstate_prediction, network.dynamics

    hh, vecs = [], []
    t_hh, t_v = _tower_arrays(f.trunk, num_blocks)  # f tower
    hh += t_hh
    vecs += t_v
    hh.append(phi.state_proj.weight.t())  # φ fuse (state side)
    vecs.append(phi.state_proj.bias + phi.action_proj.bias)
    t_hh, t_v = _tower_arrays(phi.trunk, num_blocks)
    hh += t_hh
    vecs += t_v
    hh.append(phi.afterstate.weight.t())
    vecs.append(phi.afterstate.bias)
    t_hh, t_v = _tower_arrays(psi.trunk, num_blocks)  # ψ tower
    hh += t_hh
    vecs += t_v
    hh.append(g.state_proj.weight.t())  # g fuse (afterstate side)
    vecs.append(g.state_proj.bias + g.chance_proj.bias)
    t_hh, t_v = _tower_arrays(g.trunk, num_blocks)
    hh += t_hh
    vecs += t_v
    hh.append(g.next_state.weight.t())
    vecs.append(g.next_state.bias)

    h, k = hh[0].shape[0], codebook_size
    a = f.policy_logits.weight.shape[0]
    kw = dict(dtype=torch.float32, device=hh[0].device)

    win = torch.zeros(2, k, h, **kw)
    win[0, :a] = phi.action_proj.weight.t()  # (A, H)
    win[1] = g.chance_proj.weight.t()  # (K, H)
    wide = torch.zeros(2, h, k, **kw)
    wide[0, :, :a] = f.policy_logits.weight.t()
    wide[1] = psi.chance_logits.weight.t()
    wide_b = torch.zeros(2, k, **kw)
    wide_b[0, :a] = f.policy_logits.bias
    wide_b[1] = psi.chance_logits.bias

    scal = torch.zeros(h, 8, **kw)
    scal_b = torch.zeros(1, 8, **kw)
    heads = ((f.value, value_bins), (psi.q_value, value_bins), (g.reward, reward_bins))
    offsets = cat_layout(value_bins, reward_bins)
    cat = torch.zeros(h, offsets[3], **kw)
    cat_b = torch.zeros(offsets[3], 1, **kw)
    for col, ((head, bins), off) in enumerate(zip(heads, offsets)):
        if bins == 1:
            scal[:, col] = head.weight[0]
            scal_b[0, col] = head.bias[0]
        else:
            cat[:, off : off + bins] = head.weight.t()
            cat_b[off : off + bins, 0] = head.bias

    if stream_chunk is not None:
        hh = [hh[i] for i in call_order(num_blocks)]
        hh += [torch.zeros_like(hh[0])] * (-len(hh) % stream_chunk)

    return PackedSearchParams(
        hh=torch.stack([x.to(weight_dtype) for x in hh]).contiguous(),
        vecs=torch.stack([x.to(torch.float32) for x in vecs]).t().contiguous(),
        win=win.to(weight_dtype),
        wide=wide.to(weight_dtype),
        wide_b=wide_b.t().contiguous(),
        scal=scal,
        scal_b=scal_b,
        cat=cat.to(weight_dtype),
        cat_b=cat_b,
        num_blocks=num_blocks,
        stream_chunk=stream_chunk or 0,
    )


def in_scope(cfg: SearchConfig) -> bool:
    """The search variants the kernel runs (JAX's ``pallas_search._in_scope``
    without its batch condition, the TPU kernel's lane width): PUCT root
    selection, argmax chance selection and no progressive widening."""
    return cfg.root_selection == "puct" and cfg.chance_selection == "argmax" and cfg.pw_c is None


def check_scope(cfg: SearchConfig) -> None:
    """Raise ``NotImplementedError`` for a search variant outside the kernel's
    scope, as the JAX package's ``run_mcts_pallas`` does: the Gumbel root,
    sampled chance selection and progressive widening run in the plain
    search (``search/mcts.py``) only."""
    if not in_scope(cfg):
        raise NotImplementedError(
            "the whole-search kernel runs PUCT root selection, argmax chance selection and no progressive widening "
            f"(got root_selection={cfg.root_selection!r}, chance_selection={cfg.chance_selection!r}, "
            f"pw_c={cfg.pw_c!r}); the plain search runs the others"
        )


def kernel_limits(cfg: SearchConfig, hidden: int, weight_dtype: torch.dtype = torch.float32) -> str | None:
    """Why the CUDA kernel refuses searches of ``cfg`` on a network of hidden
    size ``hidden`` with ``weight_dtype`` packs, or None when it takes them
    (resident up to H=256, streamed up to 512: :func:`search_plan`). The one
    home of the kernel's limits: :func:`search_plan`, the wrapper's input
    check and the self-play backend dispatch read them here. The plain
    version takes any shape in the scope."""
    k = max(cfg.num_actions, cfg.codebook_size)
    if not in_scope(cfg):
        return (
            "the config is outside the kernel's scope (needs PUCT root selection, argmax chance selection and "
            "pw_c=None)"
        )
    if weight_dtype not in (torch.float32, torch.bfloat16):
        return f"the kernel takes float32 or bfloat16 weight packs (got {weight_dtype})"
    if hidden % 32 or not 32 <= hidden <= STREAMED_MAX_H:
        return f"the kernel takes 32 <= H <= {STREAMED_MAX_H} with H % 32 == 0 (got H={hidden})"
    if k > MAX_WIDTH:
        return f"the kernel takes K <= {MAX_WIDTH} child slots (got K={k})"
    if not (1 <= cfg.value_bins <= MAX_BINS and 1 <= cfg.reward_bins <= MAX_BINS):
        return (
            f"the kernel takes scalar heads (bins = 1) or 2 <= bins <= {MAX_BINS} "
            f"(got value_bins={cfg.value_bins}, reward_bins={cfg.reward_bins})"
        )
    return None


def search_plan(cfg: SearchConfig, hidden: int, weight_dtype: torch.dtype = torch.float32) -> int:
    """The pack layout the CUDA kernel takes for this network and search: 0
    (resident weights) or a ``stream_chunk`` > 0 (streamed weights). The
    counterpart of the JAX package's ``pallas_search_plan``, decided by the
    CUDA kernel's own limits (:func:`kernel_limits`, raised as a
    ``ValueError``; a search variant outside the kernel's scope raises
    ``NotImplementedError`` first, :func:`check_scope`): the resident float32
    kernel runs 2H threads and a producer warp (at most 544), the streamed one 2H threads under 1,024 and stages 64 KB
    tiles of rows through shared memory, and the bfloat16 libraries take
    their tensor-core fragments by 16-row k-steps in m-tiles of 16 outputs,
    at most 2 a warp (resident: 8 warps, H <= 256) or 3 (streamed: 12
    warps, H <= 512). So a
    bfloat16 pack stays resident exactly where a float32 one does, as in
    JAX's plan. Shared memory never binds below those limits (at H=512 with
    512 bins, float32 tiles: 169 KB of 227 KB), nor do the batch (any size
    runs) or the tower depth (the tree tables and the pack live in device
    memory), which JAX's plan also takes. The chunk only sets the pack's
    zero padding: the kernel streams the real layers tile by tile."""
    check_scope(cfg)
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{weight_dtype} weight packs are not ported (float32 and bfloat16 are)")
    refused = kernel_limits(cfg, hidden, weight_dtype)
    if refused is not None:
        raise ValueError(refused)
    return 0 if hidden <= RESIDENT_MAX_H else STREAM_CHUNK


def pack_for(
    network, cfg: SearchConfig, weight_dtype: torch.dtype = torch.float32, stream_chunk: int | None = None
) -> PackedSearchParams:
    """``network``'s weights packed for searches of ``cfg`` in
    ``weight_dtype``: in :func:`search_plan`'s layout (which raises outside
    the kernel's limits), or, given ``stream_chunk``, in that layout
    instead (0: resident, > 0: streamed in chunks of that many layers)."""
    chunk = search_plan(cfg, network.hidden_size, weight_dtype) if stream_chunk is None else stream_chunk
    return pack_search_params(
        network,
        network.num_blocks,
        max(cfg.num_actions, cfg.codebook_size),
        weight_dtype,
        chunk or None,
        value_bins=cfg.value_bins,
        reward_bins=cfg.reward_bins,
    )


def launch_key(library: str, cfg: SearchConfig) -> str:
    """The ``LAUNCHES`` key of a launch of ``library`` for searches of
    ``cfg``: the library, but the float32 resident one's launches with at
    least one categorical head count as ``"whole_search_categorical"``."""
    if library == "whole_search" and (cfg.value_bins > 1 or cfg.reward_bins > 1):
        return "whole_search_categorical"
    return library


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def bf16_dense_sum(x: torch.Tensor, w: torch.Tensor, order: str = "tree") -> torch.Tensor:
    """``x`` (B, H) rounded to bfloat16 times ``w`` (H, H) [in][out], products
    exact in float32 (bfloat16 times bfloat16), summed in ``order``: "tree",
    a balanced tree over consecutive pairs of each input half (a half padded
    with zero products to a power of two, which leaves a power-of-two H's
    sums as they were: x + 0 = x), then the two halves added, the order the
    plain version is held to JAX's bfloat16 kernel in; "ksteps", the tensor
    cores' order as near as a plain version comes: each 16-row k-step
    summed, then the k-steps added in ascending order."""
    if order not in ("tree", "ksteps"):
        raise ValueError(f"order is 'tree' or 'ksteps', not {order!r}")
    b, h = x.shape
    terms = x.to(torch.bfloat16).float()[:, :, None] * w.float()[None]  # (B, in, out), exact
    if order == "ksteps":
        if h % 16:
            raise ValueError(f"k-steps take H % 16 == 0 (got H={h})")
        steps = terms.view(b, h // 16, 16, h).sum(2)
        total = steps[:, 0]
        for j in range(1, h // 16):
            total = total + steps[:, j]
        return total
    half = (h + 1) // 2
    width = _next_pow2(half)
    halves = []
    for part in (terms[:, :half], terms[:, half:]):
        if part.shape[1] < width:
            part = torch.cat([part, part.new_zeros(b, width - part.shape[1], h)], 1)
        while part.shape[1] > 1:  # consecutive pairs: 8-row blocks first, then blocks pairwise
            part = part[:, 0::2] + part[:, 1::2]
        halves.append(part[:, 0])
    return halves[0] + halves[1]


def _pair_tree(v: torch.Tensor) -> torch.Tensor:
    """(..., 2^k) → (...): a balanced tree over consecutive pairs, as the kernel's trees and butterflies sum."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def epilogue_moments(x: torch.Tensor, warps: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The mean and variance (B,) of each row of ``x`` (B, H) float32 as the
    tensor-core kernel's dense layer forms them in its epilogue
    (``csrc/whole_search.cu`` ``dense_mma``), operation for operation. Warp w
    of ``warps`` owns the 16-output m-tiles w, w + warps, ...; of an m-tile a
    lane sums 8 consecutive outputs as a balanced tree (:func:`_pair_tree`)
    and adds the other 8's, then the squares of the deviations about sum / 16
    alike. After the barrier Chan's rule for groups combines the m-tiles in
    one order, whichever warp owns them: lane g of 4 adds m-tiles g, g + 4,
    ... in turn (absent ones as 0), and a butterfly adds the 4 lanes as a
    balanced tree; first the sums, for the mean, then each m-tile's squared
    deviations plus 16 times its mean's squared distance from the mean, for
    the variance. That stays as stable as the two-pass variance (no E[x²] −
    mean²), and the owners change no bit."""
    b, h = x.shape
    if h % 16:
        raise ValueError(f"m-tiles take H % 16 == 0 (got H={h})")
    n = h // 16
    turns = -(-n // 4)
    sums, squares = x.new_zeros(b, 4 * turns), x.new_zeros(b, 4 * turns)  # the absent m-tiles' as 0
    tiles = x.view(b, n, 2, 8)  # [row][m-tile][outputs 0-7 or 8-15][output]
    for w in range(warps):
        own = list(range(w, n, warps))
        if not own:
            continue
        v = tiles[:, own]
        s = _pair_tree(v)
        s = s[:, :, 0] + s[:, :, 1]
        d = v - (s * 0.0625)[:, :, None, None]
        q = _pair_tree(d * d)
        sums[:, own] = s
        squares[:, own] = q[:, :, 0] + q[:, :, 1]
    inv_h = x.new_ones(()) / x.new_full((), float(h))
    total, m2 = x.new_zeros(b, 4), x.new_zeros(b, 4)  # [row][lane g]
    for k in range(turns):
        total = total + sums[:, 4 * k : 4 * k + 4]
    mean = _pair_tree(total) * inv_h
    d = sums * 0.0625 - mean[:, None]
    terms = torch.where(torch.arange(4 * turns, device=x.device) < n, squares + (d * d) * 16.0, x.new_zeros(()))
    for k in range(turns):
        m2 = m2 + terms[:, 4 * k : 4 * k + 4]
    return mean, _pair_tree(m2) * inv_h


def epilogue_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, warps: int = 8) -> torch.Tensor:
    """LayerNorm(x) * gamma + beta (eps 1e-6, 1 / sqrt correctly rounded) of
    ``x`` (B, H) float32 from :func:`epilogue_moments`, as the tensor-core
    kernel normalises in a dense layer's epilogue. The kernel's plain version
    takes it with ``order="ksteps"``; the search path does not."""
    mean, var = epilogue_moments(x, warps)
    r = torch.reciprocal(torch.sqrt(var + 1e-6))
    return ((x - mean[:, None]) * r[:, None]) * gamma + beta


def packed_transitions(packed: PackedSearchParams, cfg: SearchConfig, order: str = "tree"):
    """Both transitions from the packed tensors, as the kernel computes them.

    With a bfloat16 pack, every value that a product rounds is computed in
    a fixed order of float32 sums: a dense layer sums its exact products
    (bfloat16 times bfloat16 fits float32) in :func:`bf16_dense_sum`'s
    ``order`` ("tree": a balanced tree over each input half; "ksteps": the
    tensor cores' 16-row k-steps, whose sums inside a step no plain version
    repeats), and LayerNorm takes, in the "tree" order, JAX's bfloat16
    kernel's lane-strided sums, butterfly and correctly rounded 1 / sqrt, and
    in the "ksteps" order the tensor-core kernel's
    (:func:`epilogue_layer_norm`). With a float32 pack, dense
    layers are plain matrix products and LayerNorm takes PyTorch's
    reductions: their sums round in another order than the kernel's, within
    float32 noise."""
    vecs, num_blocks = packed.vecs, packed.num_blocks
    a, k = cfg.num_actions, max(cfg.num_actions, cfg.codebook_size)
    h = vecs.shape[0]
    tower_hh, tower_vec = 1 + 2 * num_blocks, 3 + 6 * num_blocks
    bf16 = packed.hh.dtype == torch.bfloat16
    if order not in ("tree", "ksteps"):
        raise ValueError(f"order is 'tree' or 'ksteps', not {order!r}")
    hh = packed.hh.float()
    one = torch.ones((), dtype=torch.float32, device=vecs.device)
    inv_h = one / torch.full((), float(h), dtype=torch.float32, device=vecs.device)
    lanes = LANES_BIT_REVERSED.to(vecs.device)

    def layer(ihh):
        return pack_layer(hh, ihh, num_blocks, packed.stream_chunk > 0)

    def product(x, w):
        """x @ w with x rounded to the weights' type (bfloat16 packs), sums in float32."""
        return (x.to(torch.bfloat16).float() if bf16 else x) @ w.float()
    phi_fuse_hh, phi_fuse_v = tower_hh, tower_vec
    phi_hh, phi_v = phi_fuse_hh + 1, phi_fuse_v + 1
    phi_head_hh, phi_head_v = phi_hh + tower_hh, phi_v + tower_vec
    psi_hh, psi_v = phi_head_hh + 1, phi_head_v + 1
    g_fuse_hh, g_fuse_v = psi_hh + tower_hh, psi_v + tower_vec
    g_hh, g_v = g_fuse_hh + 1, g_fuse_v + 1
    g_head_hh, g_head_v = g_hh + tower_hh, g_v + tower_vec

    def dense(x, ihh, iv):
        if not bf16:
            return x @ layer(ihh) + vecs[:, iv]
        return bf16_dense_sum(x, layer(ihh), order) + vecs[:, iv]

    per_lane = _next_pow2(-(-h // 32))  # a lane's values, zero-padded to a power of two

    def warp_sum(v):
        """(B, H) → (B, 1) as the kernel's LayerNorm sums: a balanced tree over
        each lane's every 32nd value (zeros past H), then the xor butterfly
        over the 32 lanes (a balanced tree over them in bit-reversed order)."""
        if h < 32 * per_lane:
            v = torch.cat([v, v.new_zeros(v.shape[0], 32 * per_lane - h)], 1)
        total = v.view(v.shape[0], per_lane, 32)
        while total.shape[1] > 1:
            total = total[:, 0::2] + total[:, 1::2]
        total = total[:, 0, lanes]
        while total.shape[1] > 1:
            total = total[:, 0::2] + total[:, 1::2]
        return total

    def layer_norm(x, iv):
        if not bf16:
            mean = x.mean(-1, keepdim=True)
            y = (x - mean) * torch.rsqrt(torch.square(x - mean).mean(-1, keepdim=True) + 1e-6)
            return y * vecs[:, iv] + vecs[:, iv + 1]
        if order == "ksteps":
            return epilogue_layer_norm(x, vecs[:, iv], vecs[:, iv + 1])
        d = x - warp_sum(x) * inv_h
        r = torch.reciprocal(torch.sqrt(warp_sum(d * d) * inv_h + 1e-6))
        return (d * r) * vecs[:, iv] + vecs[:, iv + 1]

    def tower(x, ihh, iv):
        x = dense(x, ihh, iv)
        ihh, iv = ihh + 1, iv + 1
        for _ in range(num_blocks):
            r = x
            t = dense(torch.relu(layer_norm(x, iv)), ihh, iv + 2)
            t = dense(torch.relu(layer_norm(t, iv + 3)), ihh + 1, iv + 5)
            x = t + r
            ihh, iv = ihh + 2, iv + 6
        return torch.relu(layer_norm(x, iv))

    offsets = cat_layout(cfg.value_bins, cfg.reward_bins)

    def value_head(x, col):
        """Head ``col`` (0 f value, 1 ψ q, 2 g reward) as an h-space scalar."""
        bins, support_max = (
            (cfg.reward_bins, cfg.reward_support_max) if col == 2 else (cfg.value_bins, cfg.value_support_max)
        )
        if bins == 1:
            return x @ packed.scal[:, col] + packed.scal_b[0, col]
        off = offsets[col]
        logits = product(x, packed.cat[:, off : off + bins]) + packed.cat_b[off : off + bins, 0]
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        step = torch.full((), support_max / (bins - 1), dtype=torch.float32, device=x.device)
        atoms = torch.arange(bins, dtype=torch.float32, device=x.device) * step
        return (e * atoms).sum(-1) / e.sum(-1)

    def transitions(parent_embedding: torch.Tensor, edge: torch.Tensor) -> Transitions:
        fuse_a = dense(parent_embedding, phi_fuse_hh, phi_fuse_v) + packed.win[0].float()[edge.clamp(max=a - 1)]
        afterstate = dense(tower(fuse_a, phi_hh, phi_v), phi_head_hh, phi_head_v)
        y = tower(afterstate, psi_hh, psi_v)
        chance_logits = product(y, packed.wide[1]) + packed.wide_b[:, 1]

        fuse_c = dense(parent_embedding, g_fuse_hh, g_fuse_v) + packed.win[1].float()[edge.clamp(max=k - 1)]
        x = tower(fuse_c, g_hh, g_v)
        hidden = dense(x, g_head_hh, g_head_v)
        z = tower(hidden, 0, 0)
        action_logits = product(z, packed.wide[0][:, :a]) + packed.wide_b[:a, 0]
        return Transitions(
            afterstate=afterstate,
            q_value=value_head(y, 1),
            chance_logits=chance_logits,
            hidden=hidden,
            reward=value_head(x, 2),
            value=value_head(z, 0),
            action_logits=action_logits,
        )

    return transitions


@torch.no_grad()
def whole_search_reference(
    root_h: torch.Tensor,
    root_p: torch.Tensor,
    root_v: torch.Tensor,
    packed: PackedSearchParams,
    cfg: SearchConfig,
    order: str = "tree",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``root_h`` (B, H), ``root_p``
    (B, K), ``root_v`` (B,) → root visits (B, A), root Q (B, A), root value
    (B,); a bfloat16 pack's dense layers summed in ``order``
    (:func:`packed_transitions`)."""
    return search_tree(root_h, root_p, root_v, cfg, packed_transitions(packed, cfg, order))


def _check_inputs(root_h, root_p, root_v, packed: PackedSearchParams, cfg: SearchConfig) -> None:
    b, h = root_h.shape
    k = max(cfg.num_actions, cfg.codebook_size)
    if root_p.shape != (b, k) or root_v.shape != (b,):
        raise ValueError(f"root shapes {tuple(root_p.shape)}, {tuple(root_v.shape)} do not match B={b}, K={k}")
    if packed.hh.shape[1:] != (h, h) or packed.win.shape != (2, k, h):
        raise ValueError("packed weights do not match the root hidden size / child width")
    for t in (root_h, root_p, root_v, *packed.tensors):
        if t.device != root_h.device or not t.is_contiguous():
            raise ValueError("whole_search takes contiguous tensors on one device")
    wdtype = packed.hh.dtype
    f32_parts = (root_h, root_p, root_v, packed.vecs, packed.wide_b, packed.scal, packed.scal_b, packed.cat_b)
    if (
        wdtype not in (torch.float32, torch.bfloat16)
        or any(t.dtype != wdtype for t in (packed.win, packed.wide, packed.cat))
        or any(t.dtype != torch.float32 for t in f32_parts)
    ):
        raise ValueError(
            "whole_search takes float32 roots, vectors and scalar heads, and hh / win / wide / cat all "
            "float32 or all bfloat16"
        )
    refused = kernel_limits(cfg, h, wdtype)
    if refused is not None:
        raise ValueError(refused)
    if not packed.stream_chunk and h > RESIDENT_MAX_H:
        raise ValueError(f"the resident kernel takes 32 <= H <= {RESIDENT_MAX_H} (got H={h}): stream the pack")
    n_hh = 4 * (1 + 2 * packed.num_blocks) + 4
    if packed.stream_chunk:
        n_hh += -n_hh % packed.stream_chunk
    if packed.hh.shape[0] != n_hh:
        raise ValueError(
            f"hh holds {packed.hh.shape[0]} layers, not the {n_hh} of num_blocks={packed.num_blocks}, "
            f"stream_chunk={packed.stream_chunk}"
        )
    cb = cat_layout(cfg.value_bins, cfg.reward_bins)[3]
    if packed.cat.shape != (h, cb) or packed.cat_b.shape != (cb, 1):
        raise ValueError("the categorical pack does not match the search config's value_bins / reward_bins")


class SearchWorkspace:
    """What the kernel reuses across the calls made with one pack (one
    evaluation): the bias / LayerNorm vectors in its (n_vec, H) layout, the
    device buffer of tree tables, grown on demand, and for a bfloat16 pack
    the copy of its real ``hh`` layers in call order and fragment order that
    the tensor-core kernels read (made at the first call, on the pack's
    device: 11.5 MB at H=256, 46.1 MB at H=512). Calls that share a
    workspace must run on one stream."""

    def __init__(self, packed: PackedSearchParams):
        self.vecs = packed.vecs.t().contiguous()  # coalesced reads in the kernel
        self.tables: torch.Tensor | None = None
        self._packed = packed
        self._fragments: torch.Tensor | None = None

    @property
    def fragments(self) -> torch.Tensor:
        """:func:`mma_fragments` of the pack's real ``hh`` layers in
        :func:`call_order`, φ fuse first: a streamed pack's first layers (its
        padding is never read), a resident pack's layers reordered."""
        if self._fragments is None:
            order = call_order(self._packed.num_blocks)
            hh = self._packed.hh
            self._fragments = mma_fragments(hh[: len(order)] if self._packed.stream_chunk else hh[order])
        return self._fragments

    def table_buffer(self, nbytes: int, device: torch.device) -> torch.Tensor:
        if self.tables is None or self.tables.numel() < nbytes or self.tables.device != device:
            self.tables = torch.empty(nbytes, dtype=torch.uint8, device=device)
        return self.tables


def whole_search(
    root_h: torch.Tensor,
    root_p: torch.Tensor,
    root_v: torch.Tensor,
    packed: PackedSearchParams,
    cfg: SearchConfig,
    workspace: SearchWorkspace | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All simulations of B searches: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. Same arguments and results as
    :func:`whole_search_reference`; ``workspace`` (made from ``packed``)
    saves its set-up when the same pack serves many calls."""
    check_scope(cfg)
    if root_h.device.type == "cpu":
        return whole_search_reference(root_h, root_p, root_v, packed, cfg)
    if root_h.device.type != "cuda":
        raise ValueError(f"whole_search runs on CUDA or CPU tensors, not {root_h.device}")
    _check_inputs(root_h, root_p, root_v, packed, cfg)
    bf16, streamed = packed.hh.dtype == torch.bfloat16, packed.stream_chunk > 0
    library = library_name(packed.hh.dtype, streamed)  # each library holds one kernel
    lib = _load(library)
    b, h = root_h.shape
    s = cfg.num_simulations
    k = max(cfg.num_actions, cfg.codebook_size)
    max_depth = cfg.max_depth if cfg.max_depth is not None else s + 1
    p = min(max_depth, s + 1)
    dev = root_h.device
    workspace = workspace or SearchWorkspace(packed)
    with torch.cuda.device(dev):
        tables = workspace.table_buffer(lib.whole_search_workspace_bytes(b, h, k, s, p), dev)
        visits = torch.empty(b, cfg.num_actions, dtype=torch.float32, device=dev)
        qvals = torch.empty_like(visits)
        rootv = torch.empty(b, dtype=torch.float32, device=dev)
        eps = cfg.value_transform_epsilon
        f32 = lambda x: float(np.float32(x))  # noqa: E731 — the float32 value the JAX package's constants take
        hh = workspace.fragments if bf16 else packed.hh  # the tensor-core kernels' fragments
        weights = (hh, workspace.vecs, *packed.tensors[2:])
        vb, rb = cfg.value_bins, cfg.reward_bins
        clocks = tracing.device_counts(CLOCK_COUNTERS, dev) if tracing.is_recording() else None
        err = lib.whole_search_launch(
            *(t.data_ptr() for t in (root_h, root_p, root_v, *weights, visits, qvals, rootv, tables)),
            b, h, packed.num_blocks, s, k, cfg.num_actions, p, packed.cat.shape[1], vb, rb,
            int(bf16), int(streamed),
            f32(cfg.pb_c_init), f32(cfg.pb_c_base), f32(cfg.discount), f32(cfg.prior_temperature),
            f32(cfg.value_support_max / max(vb - 1, 1)), f32(cfg.reward_support_max / max(rb - 1, 1)),
            int(eps is not None), f32(eps or 0.0), f32(4 * (eps or 0.0)), f32(2 * (eps or 0.0)),
            None if clocks is None else clocks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"whole_search kernel launch failed: {lib.whole_search_error_string(err).decode()}")
    if clocks is not None:
        tracing.count("search.kernel.clocked_launches", 1)
    LAUNCHES[launch_key(library, cfg)] += 1
    return visits, qvals, rootv


class LaunchShape(NamedTuple):
    """How the CUDA kernel of one library runs a launch (``whole_search_launch_shape``)."""

    blocks: int  # thread blocks: kernel_blocks(batch, library)
    threads: int  # threads a block: 2H (float32 resident: and a producer warp; tensor cores: warps and a producer)
    searches_per_block: int
    stages: int  # weight tiles in shared memory
    tile_rows: int  # rows of each input half in a tile (tensor cores: input rows of every output)
    resident: int  # blocks the card keeps resident at once
    smem_bytes: int  # dynamic shared memory per block


def launch_shape(library: str, batch: int, hidden: int, width: int, value_bins: int, reward_bins: int) -> LaunchShape:
    """The kernel's launch of ``batch`` searches at these widths in ``library``
    (``width``: K, the child slots), as the built library computes it."""
    lib = _load(library)
    out = (ctypes.c_int * len(LaunchShape._fields))()
    err = lib.whole_search_launch_shape(batch, hidden, width, value_bins, reward_bins, out)
    if err != 0:
        raise RuntimeError(f"whole_search_launch_shape failed: {lib.whole_search_error_string(err).decode()}")
    return LaunchShape(*out)


def dense_probe(library: str, fragments: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The dense layers alone of a tensor-core ``library`` (a bfloat16 one;
    ``whole_search_dense_probe``): each layer of ``fragments`` (L, H/16,
    H/16, 32, 8, :func:`mma_fragments`) applied to ``x`` (G, H) float32,
    rounded to bfloat16, plus its row of ``bias`` (L, H), by the search
    kernel's own ring, ``mma.sync`` products and epilogue, with G the
    library's searches a block. Returns (L, G, H) float32. For checking the
    kernel (``chip_smoke.py``); no path calls it."""
    n_layers, h = bias.shape
    g = SEARCHES_PER_BLOCK[library]
    if not library.startswith("whole_search_bf16"):
        raise ValueError(f"dense_probe: {library} has no tensor-core dense layers")
    if fragments.shape != (n_layers, h // 16, h // 16, 32, 8) or x.shape != (g, h):
        raise ValueError(f"dense_probe: fragments {tuple(fragments.shape)}, bias {tuple(bias.shape)}, x {tuple(x.shape)}")
    for t, dtype in ((fragments, torch.bfloat16), (bias, torch.float32), (x, torch.float32)):
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("dense_probe takes contiguous CUDA tensors: bfloat16 fragments, float32 bias and x")
    lib = _load(library)
    out = torch.empty(n_layers, g, h + ROW_PAD, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.whole_search_dense_probe(fragments.data_ptr(), bias.data_ptr(), x.data_ptr(), out.data_ptr(), h,
                                           n_layers, torch.cuda.current_stream(x.device).cuda_stream)  # fmt: skip
    if err != 0:
        raise RuntimeError(f"whole_search_dense_probe failed: {lib.whole_search_error_string(err).decode()}")
    return out[:, :, :h]


def _load(library: str) -> ctypes.CDLL:
    """The loaded ``library``, with its functions' argument types set."""
    lib = _build.load(library)
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.whole_search_workspace_bytes.argtypes = [i32] * 5
        lib.whole_search_workspace_bytes.restype = ctypes.c_size_t
        lib.whole_search_error_string.argtypes = [i32]
        lib.whole_search_error_string.restype = ctypes.c_char_p
        lib.whole_search_launch.argtypes = [ptr] * 16 + [i32] * 12 + [f32] * 6 + [i32] + [f32] * 3 + [ptr] * 2
        lib.whole_search_launch.restype = i32
        lib.whole_search_launch_shape.argtypes = [i32] * 5 + [ptr]
        lib.whole_search_launch_shape.restype = i32
        if hasattr(lib, "whole_search_dense_probe"):
            lib.whole_search_dense_probe.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
            lib.whole_search_dense_probe.restype = i32
        lib._argtypes_set = True
    return lib


# The SearchConfig fields root_inputs reads (the network's parameters and the batch shape complete a graph's key).
ROOT_FIELDS = ("prior_temperature", "dirichlet_fraction", "root_selection", "value_transform_epsilon", "num_actions",
               "codebook_size")  # fmt: skip
ROOT_GRAPH_CACHE = 8  # graphs kept in the process, across weight sets and batch shapes; the oldest used goes first
_root_graphs: OrderedDict[tuple, RootGraph] = OrderedDict()


def root_weights(network) -> tuple[torch.Tensor, ...]:
    """The parameters the root's h/f reads: the representation's and the prediction's."""
    return (*network.representation.parameters(), *network.prediction.parameters())


class RootGraph:
    """``root_inputs(network, observations, config, invalid, noise)`` for one
    batch shape, as a CUDA graph. It owns the static inputs (observations
    (B, 16) float32, the illegal-action mask (B, A) bool and the root noise
    (B, A) float32, each where the shape has it) and the graph's outputs,
    ``hidden``, ``probs`` and ``root_value``, contiguous. A call copies its
    tensors into the inputs, replays on the current stream and returns the
    outputs, which the next replay overwrites: a caller reads them in stream
    order before its next call. The first call captures (after one eager run
    on the capture stream, so that the libraries set up their state there
    and not inside the capture). The graph reads the parameters where they
    are stored: weights updated in place are read live, and the graph keeps
    them, so that no other tensor takes their storage while it lives."""

    def __init__(self, network, config: SearchConfig, batch: int, masked: bool, noised: bool, device):
        self.device = torch.device(device)
        self._config = config
        self.weights = root_weights(network)  # kept alive: no other tensor takes their storage
        self._network = network  # until the capture
        a = config.num_actions
        self.observations = torch.zeros(batch, network.observation_dim, dtype=torch.float32, device=self.device)
        self.invalid = torch.zeros(batch, a, dtype=torch.bool, device=self.device) if masked else None
        self.noise = torch.zeros(batch, a, dtype=torch.float32, device=self.device) if noised else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None

    def _root(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        outputs = root_inputs(self._network, self.observations, self._config, self.invalid, self.noise)
        return tuple(t.contiguous() for t in outputs)

    @torch.no_grad()
    def capture(self) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self._root()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self.outputs = self._root()
        self.graph, self._network = graph, None
        tracing.count("search.root_graph_captures", 1)

    def __call__(
        self, observations: torch.Tensor, invalid_actions: torch.Tensor | None, noise: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if (invalid_actions is None) != (self.invalid is None) or (noise is None) != (self.noise is None):
            raise ValueError("the root graph was captured for another mask / noise presence")
        self.observations.copy_(observations)
        if self.invalid is not None:
            self.invalid.copy_(invalid_actions)
        if self.noise is not None:
            self.noise.copy_(noise)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        tracing.count("search.root_graph_replays", 1)
        return self.outputs


class RootGraphs:
    """The :class:`RootGraph` of one network and search config on one device,
    by batch shape, from the process-wide cache (``ROOT_GRAPH_CACHE``
    entries). Its key is made only of what the root reads: the device, the
    config's ``ROOT_FIELDS``, the storage of :func:`root_weights`, then the
    batch size and whether the mask and the noise are given. The first part
    is computed here, once; a parameter given new storage makes a new key
    and so a new capture."""

    def __init__(self, network, config: SearchConfig, device):
        self._network, self._config, self._device = network, config, torch.device(device)
        self.key = (
            self._device,
            tuple(getattr(config, name) for name in ROOT_FIELDS),
            tuple((w.data_ptr(), w.dtype, tuple(w.shape)) for w in root_weights(network)),
        )
        self._mine: dict[tuple, RootGraph] = {}

    def get(self, batch: int, masked: bool, noised: bool) -> RootGraph:
        shape = (batch, masked, noised)
        graph = self._mine.get(shape)
        if graph is None:
            key = self.key + shape
            graph = _root_graphs.pop(key, None) or RootGraph(self._network, self._config, *shape, self._device)
            _root_graphs[key] = graph
            while len(_root_graphs) > ROOT_GRAPH_CACHE:
                _root_graphs.popitem(last=False)
            self._mine[shape] = graph
        return graph


@torch.no_grad()
def run_search_kernel(
    network,
    observations: torch.Tensor,
    config: SearchConfig,
    invalid_actions: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    packed: PackedSearchParams | None = None,
    workspace: SearchWorkspace | None = None,
    root_graph: RootGraph | None = None,
) -> PolicyOutput:
    """Batched search through :func:`whole_search` (drop-in for
    ``batched_run_mcts``). ``packed`` can be built once per weight version
    with :func:`pack_for`, and ``workspace`` once per pack; without it the
    float32 weights are packed in :func:`search_plan`'s layout.
    ``root_graph`` (of this network, config and batch shape) replays the
    root's h/f; without it the root runs eagerly."""
    if packed is None:
        packed = pack_for(network, config)
    tracing.count("search.root_calls", 1)
    with tracing.span("search.root"):
        if root_graph is not None:
            hidden, probs, root_value = root_graph(observations, invalid_actions, noise)
        else:
            hidden, probs, root_value = root_inputs(network, observations, config, invalid_actions, noise)
    with tracing.span("search.kernel"):
        visits, qvalues, value = whole_search(
            hidden.contiguous(), probs.contiguous(), root_value.contiguous(), packed, config, workspace
        )
    return policy_output(visits, qvalues, value)

"""Whole-search MCTS kernel (CUDA) with its packing, plain version and wrapper.

Counterpart of the JAX package's ``ops/pallas_search.py`` (the Pallas TPU
kernel ``_make_kernel`` / ``_run_packed`` and ``run_mcts_pallas``), variants
(a) and (b): float32 weights, all weights resident, scalar or categorical
value/Q/reward heads. The kernel itself is ``csrc/whole_search.cu``; its header comment says what bounds it on an
H100 and how the design answers that.

- :func:`pack_search_params` stacks the f/φ/ψ/g weights in exactly the JAX
  package's layout, so the two packs compare element by element.
- :func:`whole_search_reference` is the kernel's plain PyTorch version: the
  same search (``search.mcts.search_tree``) with transitions computed from
  the packed tensors as the kernel computes them (two-pass LayerNorm; a
  categorical head as max, exponentials, two sums and one division).
- :func:`whole_search` is the wrapper: on CPU tensors it runs the plain
  version, on CUDA tensors it launches the kernel or raises. It counts its
  launches in ``LAUNCHES`` (``"whole_search"`` with scalar heads,
  ``"whole_search_categorical"`` with a categorical head). A :class:`SearchWorkspace`
  keeps its set-up across the calls of one evaluation.
- :func:`run_search_kernel` is the drop-in for ``batched_run_mcts``: root
  h/f, priors, noise and legality masking in PyTorch, then one
  :func:`whole_search`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.search.mcts import (
    PolicyOutput,
    SearchConfig,
    Transitions,
    check_supported,
    policy_output,
    root_inputs,
    search_tree,
)

# Kernel launches by head variant: scalar heads, or at least one categorical head.
LAUNCHES = {"whole_search": 0, "whole_search_categorical": 0}


class PackedSearchParams(NamedTuple):
    """The JAX package's packed layout (``pack_search_params``), float32."""

    hh: torch.Tensor  # (n_hh, H, H) [layer][in][out]
    vecs: torch.Tensor  # (H, n_vec) bias / LayerNorm columns
    win: torch.Tensor  # (2, K, H) action / chance input rows
    wide: torch.Tensor  # (2, H, K) policy / chance logit heads
    wide_b: torch.Tensor  # (K, 2)
    scal: torch.Tensor  # (H, 8) scalar heads [f value, ψ q, g reward]
    scal_b: torch.Tensor  # (1, 8)
    cat: torch.Tensor  # (H, CB) categorical heads at :func:`cat_layout` offsets (zeros: scalar heads only)
    cat_b: torch.Tensor  # (CB, 1)


MAX_BINS = 512  # categorical heads the kernel takes: 2 <= bins <= MAX_BINS (1 = scalar head)


def cat_layout(value_bins: int, reward_bins: int) -> tuple[int, int, int, int]:
    """``(v_off, q_off, r_off, cb)``: column offsets of the f-value, ψ-q and
    g-reward segments in the ``(H, CB)`` categorical pack, and its width CB
    (a multiple of 8, at least 8). A head with ``bins == 1`` has no segment."""
    v_off, q_off = 0, value_bins if value_bins > 1 else 0
    r_off = 2 * value_bins if value_bins > 1 else 0
    cols = r_off + (reward_bins if reward_bins > 1 else 0)
    return v_off, q_off, r_off, max(8, -(-cols // 8) * 8)


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
    (and its ``scal`` column stays zero). Only float32 resident packs are
    ported; the rest raises ``NotImplementedError``."""
    if weight_dtype != torch.float32:
        raise NotImplementedError("bfloat16 weight packs are not ported yet")
    if stream_chunk is not None:
        raise NotImplementedError("weight streaming (stream_chunk) is not ported yet")
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

    return PackedSearchParams(
        hh=torch.stack([x.to(torch.float32) for x in hh]).contiguous(),
        vecs=torch.stack([x.to(torch.float32) for x in vecs]).t().contiguous(),
        win=win,
        wide=wide,
        wide_b=wide_b.t().contiguous(),
        scal=scal,
        scal_b=scal_b,
        cat=cat,
        cat_b=cat_b,
    )


def packed_transitions(packed: PackedSearchParams, cfg: SearchConfig, num_blocks: int):
    """Both transitions from the packed tensors, as the kernel computes them."""
    hh, vecs = packed.hh, packed.vecs
    a, k = cfg.num_actions, max(cfg.num_actions, cfg.codebook_size)
    tower_hh, tower_vec = 1 + 2 * num_blocks, 3 + 6 * num_blocks
    phi_fuse_hh, phi_fuse_v = tower_hh, tower_vec
    phi_hh, phi_v = phi_fuse_hh + 1, phi_fuse_v + 1
    phi_head_hh, phi_head_v = phi_hh + tower_hh, phi_v + tower_vec
    psi_hh, psi_v = phi_head_hh + 1, phi_head_v + 1
    g_fuse_hh, g_fuse_v = psi_hh + tower_hh, psi_v + tower_vec
    g_hh, g_v = g_fuse_hh + 1, g_fuse_v + 1
    g_head_hh, g_head_v = g_hh + tower_hh, g_v + tower_vec

    def dense(x, ihh, iv):
        return x @ hh[ihh] + vecs[:, iv]

    def layer_norm(x, iv):
        mean = x.mean(-1, keepdim=True)
        var = torch.square(x - mean).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-6)
        return y * vecs[:, iv] + vecs[:, iv + 1]

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
        logits = x @ packed.cat[:, off : off + bins] + packed.cat_b[off : off + bins, 0]
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        step = torch.full((), support_max / (bins - 1), dtype=torch.float32, device=x.device)
        atoms = torch.arange(bins, dtype=torch.float32, device=x.device) * step
        return (e * atoms).sum(-1) / e.sum(-1)

    def transitions(parent_embedding: torch.Tensor, edge: torch.Tensor) -> Transitions:
        fuse_a = dense(parent_embedding, phi_fuse_hh, phi_fuse_v) + packed.win[0][edge.clamp(max=a - 1)]
        afterstate = dense(tower(fuse_a, phi_hh, phi_v), phi_head_hh, phi_head_v)
        y = tower(afterstate, psi_hh, psi_v)
        chance_logits = y @ packed.wide[1] + packed.wide_b[:, 1]

        fuse_c = dense(parent_embedding, g_fuse_hh, g_fuse_v) + packed.win[1][edge.clamp(max=k - 1)]
        x = tower(fuse_c, g_hh, g_v)
        hidden = dense(x, g_head_hh, g_head_v)
        z = tower(hidden, 0, 0)
        action_logits = z @ packed.wide[0][:, :a] + packed.wide_b[:a, 0]
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


def _num_blocks(packed: PackedSearchParams) -> int:
    return (packed.hh.shape[0] - 8) // 8  # n_hh = 4·(1 + 2·NB) + 4


@torch.no_grad()
def whole_search_reference(
    root_h: torch.Tensor, root_p: torch.Tensor, root_v: torch.Tensor, packed: PackedSearchParams, cfg: SearchConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``root_h`` (B, H), ``root_p``
    (B, K), ``root_v`` (B,) → root visits (B, A), root Q (B, A), root value (B,)."""
    return search_tree(root_h, root_p, root_v, cfg, packed_transitions(packed, cfg, _num_blocks(packed)))


def _check_inputs(root_h, root_p, root_v, packed: PackedSearchParams, cfg: SearchConfig) -> None:
    b, h = root_h.shape
    k = max(cfg.num_actions, cfg.codebook_size)
    if root_p.shape != (b, k) or root_v.shape != (b,):
        raise ValueError(f"root shapes {tuple(root_p.shape)}, {tuple(root_v.shape)} do not match B={b}, K={k}")
    if packed.hh.shape[1:] != (h, h) or packed.win.shape != (2, k, h):
        raise ValueError("packed weights do not match the root hidden size / child width")
    for t in (root_h, root_p, root_v, *packed):
        if t.device != root_h.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("whole_search takes contiguous float32 tensors on one device")
    if h % 32 or not 32 <= h <= 256 or k > 32:
        raise ValueError(f"the kernel takes 32 <= H <= 256 with H % 32 == 0 and K <= 32 (got H={h}, K={k})")
    if not (1 <= cfg.value_bins <= MAX_BINS and 1 <= cfg.reward_bins <= MAX_BINS):
        raise ValueError(
            f"the kernel takes scalar heads (bins = 1) or 2 <= bins <= {MAX_BINS} "
            f"(got value_bins={cfg.value_bins}, reward_bins={cfg.reward_bins})"
        )
    cb = cat_layout(cfg.value_bins, cfg.reward_bins)[3]
    if packed.cat.shape != (h, cb) or packed.cat_b.shape != (cb, 1):
        raise ValueError("the categorical pack does not match the search config's value_bins / reward_bins")


class SearchWorkspace:
    """What the kernel reuses across the calls made with one pack (one
    evaluation): the bias / LayerNorm vectors in its (n_vec, H) layout and
    the device buffer of tree tables, grown on demand. Calls that share a
    workspace must run on one stream."""

    def __init__(self, packed: PackedSearchParams):
        self.vecs = packed.vecs.t().contiguous()  # coalesced reads in the kernel
        self.tables: torch.Tensor | None = None

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
    check_supported(cfg)
    if root_h.device.type == "cpu":
        return whole_search_reference(root_h, root_p, root_v, packed, cfg)
    if root_h.device.type != "cuda":
        raise ValueError(f"whole_search runs on CUDA or CPU tensors, not {root_h.device}")
    _check_inputs(root_h, root_p, root_v, packed, cfg)
    lib = _load()
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
        weights = (packed.hh, workspace.vecs, *packed[2:])
        vb, rb = cfg.value_bins, cfg.reward_bins
        err = lib.whole_search_launch(
            *(t.data_ptr() for t in (root_h, root_p, root_v, *weights, visits, qvals, rootv, tables)),
            b, h, _num_blocks(packed), s, k, cfg.num_actions, p, packed.cat.shape[1], vb, rb,
            f32(cfg.pb_c_init), f32(cfg.pb_c_base), f32(cfg.discount), f32(cfg.prior_temperature),
            f32(cfg.value_support_max / max(vb - 1, 1)), f32(cfg.reward_support_max / max(rb - 1, 1)),
            int(eps is not None), f32(eps or 0.0), f32(4 * (eps or 0.0)), f32(2 * (eps or 0.0)),
            torch.cuda.current_stream(dev).cuda_stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"whole_search kernel launch failed: {lib.whole_search_error_string(err).decode()}")
    LAUNCHES["whole_search_categorical" if vb > 1 or rb > 1 else "whole_search"] += 1
    return visits, qvals, rootv


def _load() -> ctypes.CDLL:
    lib = _build.load("whole_search")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.whole_search_workspace_bytes.argtypes = [i32] * 5
        lib.whole_search_workspace_bytes.restype = ctypes.c_size_t
        lib.whole_search_error_string.argtypes = [i32]
        lib.whole_search_error_string.restype = ctypes.c_char_p
        lib.whole_search_launch.argtypes = [ptr] * 16 + [i32] * 10 + [f32] * 6 + [i32] + [f32] * 3 + [ptr]
        lib.whole_search_launch.restype = i32
        lib._argtypes_set = True
    return lib


@torch.no_grad()
def run_search_kernel(
    network,
    observations: torch.Tensor,
    config: SearchConfig,
    invalid_actions: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    packed: PackedSearchParams | None = None,
    workspace: SearchWorkspace | None = None,
) -> PolicyOutput:
    """Batched search through :func:`whole_search` (drop-in for
    ``batched_run_mcts``). ``packed`` can be built once per weight version
    with :func:`pack_search_params`, and ``workspace`` once per pack."""
    if packed is None:
        packed = pack_search_params(
            network,
            network.num_blocks,
            max(config.num_actions, config.codebook_size),
            value_bins=config.value_bins,
            reward_bins=config.reward_bins,
        )
    hidden, probs, root_value = root_inputs(network, observations, config, invalid_actions, noise)
    visits, qvalues, value = whole_search(
        hidden.contiguous(), probs.contiguous(), root_value.contiguous(), packed, config, workspace
    )
    return policy_output(visits, qvalues, value)

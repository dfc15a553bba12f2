"""Ring all-reduce-sum over the ranks of a mesh, in one CUDA kernel launch
(port of the JAX package's ``parallel/ring.py``).

The TPU kernel runs a ring (N ranks, each holding a same-shaped shard ``x``):

    acc <- x;  slot[0] <- x
    for step in 0 .. N-2:
        send slot[step % 2] to the RIGHT neighbour's slot[(step+1) % 2]
        (the LEFT neighbour's chunk lands in our slot[(step+1) % 2])
        acc += slot[(step+1) % 2]

At step s rank i receives the shard that rank i-1-s started with, so rank i
ends with ``((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1}``: every rank holds the
sum, each added in an order of its own (for N >= 3 the ranks' sums may differ
in the last bits). The CUDA kernel (``csrc/ring_all_reduce.cu``) computes the
same sums in one pass over the ranks of one card: each thread reads the N
shards' values at its elements once, forms every rank's sum in that rank's
order in registers, and writes the N sums once. Nothing passes between
blocks, so there are no slots, counters or waits.

Three things live here, beside the mesh-level functions:

- :func:`ring_all_reduce_reference`, the plain PyTorch version, adding in
  the rotation order;
- :func:`ring_all_reduce_shard`, the wrapper: the CUDA kernel for float32,
  bfloat16 or float16 shards on one card (the ranks of a virtual mesh), the
  plain version for CPU shards, nothing else;
- ``LAUNCHES``, the count of kernel launches, and ``LAST_GRID``, the grid of
  the last one.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.parallel.mesh import Mesh, batch_sharding

# Launches of the CUDA kernel by the wrapper (and nowhere else).
LAUNCHES = {"ring_all_reduce": 0}
# The grid of the last launch, for the record: blocks, and the 16-byte vectors
# per rank each thread handled (0 when unaligned views took the scalar loop).
LAST_GRID = {"blocks": 0, "vectors_per_thread": 0}
# The kernel's element types, by the code its launcher takes.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def ring_all_reduce_reference(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Plain PyTorch version: rank ``i`` gets ``x_i + x_{i-1} + ... + x_{i+1}``,
    added left to right in that order (the kernel's order), on its own device."""
    n = len(shards)
    out = []
    for i in range(n):
        acc = shards[i].clone()
        for step in range(n - 1):
            acc += shards[(i - 1 - step) % n].to(acc.device)
        out.append(acc)
    return out


def ring_all_reduce_shard(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce-sum of one shard per rank: returns N tensors, rank ``i``'s
    sum in the rotation order. One kernel launch for CUDA shards (float32,
    bfloat16 or float16, contiguous, all on one card); the plain version for
    CPU shards, of any dtype. With one rank the input comes back, as in the
    JAX package."""
    shards = list(shards)
    n = len(shards)
    if n == 0:
        raise ValueError("ring_all_reduce_shard needs at least one shard")
    shape, dtype = shards[0].shape, shards[0].dtype
    if any(s.shape != shape or s.dtype != dtype for s in shards):
        raise ValueError("ring_all_reduce_shard takes shards of one shape and dtype")
    if n == 1:
        return shards
    types = {s.device.type for s in shards}
    if types == {"cpu"}:
        return ring_all_reduce_reference(shards)
    if types != {"cuda"}:
        raise ValueError(f"ring_all_reduce_shard runs on CUDA or CPU tensors, not {sorted(types)}")
    device = shards[0].device
    if any(s.device != device for s in shards):
        raise NotImplementedError(
            "ring_all_reduce_shard takes the ranks of one card (a virtual mesh); ranks on separate cards need "
            "peer pointers and barriers across the cards"
        )
    if dtype not in DTYPES or not all(s.is_contiguous() for s in shards):
        raise ValueError(
            f"ring_all_reduce_shard's kernel takes contiguous float32, bfloat16 or float16 shards, not {dtype}"
        )
    lib = _load()
    if n > lib.ring_all_reduce_max_ranks():
        raise ValueError(f"ring_all_reduce_shard's kernel takes at most {lib.ring_all_reduce_max_ranks()} ranks")
    outputs = [torch.empty_like(s) for s in shards]
    if shards[0].numel() == 0:
        return outputs
    inputs = (ctypes.c_void_p * n)(*(s.data_ptr() for s in shards))
    outs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outputs))
    blocks, vectors = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = lib.ring_all_reduce_launch(
            inputs, outs, n, DTYPES[dtype], 0, shards[0].numel(),
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(blocks), ctypes.byref(vectors),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ring_all_reduce kernel launch failed: {lib.ring_all_reduce_error_string(err).decode()}")
    LAST_GRID.update(blocks=blocks.value, vectors_per_thread=vectors.value)
    LAUNCHES["ring_all_reduce"] += 1
    return outputs


def ring_all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce ``x`` over the mesh: ``x`` is sharded on its first
    dimension, one block per mesh device, and every block of the result (on
    ``x``'s device, ``x``'s shape) holds the sum of all blocks."""
    shards = [s.contiguous() for s in batch_sharding(mesh)(x)]
    return torch.cat([o.to(x.device) for o in ring_all_reduce_shard(shards)])


def psum_reference(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The same under PyTorch's own sum over the blocks (for tests)."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"a leading dimension of {x.shape[0]} does not split over {n} mesh devices")
    total = x.reshape(n, x.shape[0] // n, *x.shape[1:]).sum(0)
    return total.repeat(n, *[1] * (x.dim() - 1))


def _load() -> ctypes.CDLL:
    lib = _build.load("ring_all_reduce")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_all_reduce_error_string.argtypes = [i32]
        lib.ring_all_reduce_error_string.restype = ctypes.c_char_p
        lib.ring_all_reduce_max_ranks.argtypes = []
        lib.ring_all_reduce_max_ranks.restype = i32
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_all_reduce_launch.argtypes = [ptrs, ptrs, i32, i32, i64, i64, ptr, ctypes.POINTER(i32),
                                               ctypes.POINTER(i64)]  # fmt: skip
        lib.ring_all_reduce_launch.restype = i32
        lib._argtypes_set = True
    return lib

"""Ring all-reduce-sum over the ranks of a mesh, in one CUDA kernel launch
(port of the JAX package's ``parallel/ring.py``).

Algorithm (N ranks, each holding a same-shaped shard ``x``), as the TPU
kernel runs it:

    acc <- x;  slot[0] <- x
    for step in 0 .. N-2:
        send slot[step % 2] to the RIGHT neighbour's slot[(step+1) % 2]
        (the LEFT neighbour's chunk lands in our slot[(step+1) % 2])
        acc += slot[(step+1) % 2]

At step s rank i receives the shard that rank i-1-s started with, so rank i
ends with ``((x_i + x_{i-1}) + x_{i-2}) + ... + x_{i+1}``: every rank holds the
sum, each added in an order of its own (for N >= 3 the ranks' sums may differ
in the last bits). The flow control (a start barrier, an ack from the right
neighbour before a slot is reused) is the kernel's; see
``csrc/ring_all_reduce.cu``.

Three things live here, beside the mesh-level functions:

- :func:`ring_all_reduce_reference`, the plain PyTorch version, adding in
  the kernel's rotation order;
- :func:`ring_all_reduce_shard`, the wrapper: the CUDA kernel for shards on
  one card (the ranks of a virtual mesh), the plain version for CPU shards,
  nothing else;
- ``LAUNCHES``, the count of kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from simulate_2048_tpu_torch.ops import _build
from simulate_2048_tpu_torch.parallel.mesh import Mesh, batch_sharding

# Launches of the CUDA kernel by the wrapper (and nowhere else).
LAUNCHES = {"ring_all_reduce": 0}
# Channels (blocks per rank) of the last launch, for the record.
LAST_CHANNELS = {"ring_all_reduce": 0}


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


class _Workspace:
    """The slots (2 per rank, padded to whole 16-byte vectors) and the
    counters of one (device, ranks, shard length). The launcher zeroes the
    counters before every launch."""

    def __init__(self, lib: ctypes.CDLL, device: torch.device, ranks: int, numel: int):
        self.stride = -(-numel // 4) * 4
        self.slots = torch.empty(ranks, 2, max(self.stride, 4), dtype=torch.float32, device=device)
        counter_words = lib.ring_all_reduce_counter_bytes(ranks) // 4
        self.counters = torch.empty(counter_words, dtype=torch.int32, device=device)


_WORKSPACES: dict[tuple[torch.device, int, int], _Workspace] = {}


def ring_all_reduce_shard(shards: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """All-reduce-sum of one shard per rank: returns N tensors, rank ``i``'s
    sum in the kernel's rotation order. One kernel launch for CUDA shards
    (float32, contiguous, all on one card); the plain version for CPU
    shards. With one rank the input comes back, as in the JAX package."""
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
            "peer pointers in the kernel's table"
        )
    if dtype != torch.float32 or not all(s.is_contiguous() for s in shards):
        raise ValueError("ring_all_reduce_shard's kernel takes contiguous float32 shards")
    lib = _load()
    if n > lib.ring_all_reduce_max_ranks():
        raise ValueError(f"ring_all_reduce_shard's kernel takes at most {lib.ring_all_reduce_max_ranks()} ranks")
    numel = shards[0].numel()
    outputs = [torch.empty_like(s) for s in shards]
    key = (device, n, numel)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = _Workspace(lib, device, n, numel)
    ws = _WORKSPACES[key]
    inputs = (ctypes.c_void_p * n)(*(s.data_ptr() for s in shards))
    outs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outputs))
    channels = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ring_all_reduce_launch(
            inputs, outs, ws.slots.data_ptr(), ws.stride, ws.counters.data_ptr(), n, numel,
            torch.cuda.current_stream(device).cuda_stream, ctypes.byref(channels),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"ring_all_reduce kernel launch failed: {lib.ring_all_reduce_error_string(err).decode()}")
    LAUNCHES["ring_all_reduce"] += 1
    LAST_CHANNELS["ring_all_reduce"] = channels.value
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
        lib.ring_all_reduce_counter_bytes.argtypes = [i32]
        lib.ring_all_reduce_counter_bytes.restype = i64
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_all_reduce_launch.argtypes = [ptrs, ptrs, ptr, i64, ptr, i32, i64, ptr, ctypes.POINTER(i32)]
        lib.ring_all_reduce_launch.restype = i32
        lib._argtypes_set = True
    return lib

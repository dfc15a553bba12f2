"""Mesh and placement helpers, in PyTorch (port of the JAX package's
``parallel/mesh.py``).

A :class:`Mesh` is one named data axis over a tuple of devices. The tuple may
repeat one device: four entries of ``cuda:0`` make a virtual mesh of four
replicas on one card, the counterpart of the JAX package's virtual CPU mesh.
Placing a batch splits its leading dimension into one chunk per mesh device;
replicating a tensor gives every mesh device its own copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

DATA_AXIS = "data"


def _normalize(device: torch.device | str) -> torch.device:
    """``device`` with its index made explicit for CUDA, so that mesh entries
    compare equal to the devices of the tensors placed on them."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices[i]`` holds replica (and batch shard) ``i``."""

    devices: tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_normalize(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.size}


def make_mesh(devices: list | tuple | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over every visible CUDA device, or over ``devices`` (which may repeat one device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices), axis_name)


def _chunks(x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    if x.shape[0] % n:
        raise ValueError(f"a leading dimension of {x.shape[0]} does not split over {n} mesh devices")
    return torch.chunk(x, n)


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], list[torch.Tensor]]:
    """Placement that splits the leading (batch) dimension evenly over the
    mesh: chunk ``i`` goes to ``mesh.devices[i]`` (a view, where it is
    already there)."""
    return lambda x: [c.to(d) for c, d in zip(_chunks(x, mesh.size), mesh.devices)]


def replicated_sharding(mesh: Mesh) -> Callable[[torch.Tensor], list[torch.Tensor]]:
    """Placement that gives every mesh device its own copy of a tensor
    (parameters, optimizer state), also where devices repeat."""
    return lambda x: [x.to(d, copy=True) for d in mesh.devices]


def _map_tree(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a tree of tuples, named tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return tree


def shard_pytree_batch(tree: Any, mesh: Mesh) -> list[Any]:
    """One tree per mesh device: every tensor's leading dimension split over
    the mesh, chunk ``i`` placed on ``mesh.devices[i]``."""
    return [
        _map_tree(lambda x, i=i: _chunks(x, mesh.size)[i].to(device), tree) for i, device in enumerate(mesh.devices)
    ]


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> None:
    """Join this process to a multi-process job (``torch.distributed``).

    ``coordinator`` is ``host:port`` of process 0 (``tcp://`` rendezvous);
    without it the rendezvous is read from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is NCCL when
    ``device`` is CUDA (the default when a GPU is present) and gloo on the CPU.
    """
    import torch.distributed as dist

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id
        )

"""Device-mesh parallelism: the mesh and its placement helpers, the
data-parallel learner step and superstep with the ring all-reduce kernel,
sharded rollouts, the multi-process runtime, the asynchronous actor/learner
split (``ActorClient`` and ``LearnerServer`` load on first use: they import
the trainer, which imports this package).
"""

from simulate_2048_tpu_torch.parallel.dp import (
    make_dp_train_step,
    make_dp_train_superstep,
    make_sharded_rollout,
)
from simulate_2048_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated_sharding,
    shard_pytree_batch,
)

__all__ = [
    "ActorClient",
    "LearnerServer",
    "batch_sharding",
    "initialize_distributed",
    "make_dp_train_step",
    "make_dp_train_superstep",
    "make_mesh",
    "make_sharded_rollout",
    "replicated_sharding",
    "shard_pytree_batch",
]


def __getattr__(name: str):
    if name in ("ActorClient", "LearnerServer"):
        from simulate_2048_tpu_torch.parallel import actor_learner

        return getattr(actor_learner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

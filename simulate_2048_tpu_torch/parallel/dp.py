"""Data-parallel training and sharded rollouts over a device mesh, in
PyTorch (port of the JAX package's ``parallel/dp.py``).

The JAX package replicates the parameters, shards the batch and lets XLA
insert the gradient all-reduce. PyTorch runs eagerly, so here the step is
written out: one replica of the networks and the optimizer state per mesh
device (replica 0 is the caller's state itself), each computing its batch
shard's share of the global batch's loss and gradient, then one ring
all-reduce launch over the replicas' flattened gradients
(``parallel/ring.py``), then the same optimizer update on every replica.

A shard's share is exact, so that the sum over the shards is the global
batch's loss: importance weights are normalised by the global batch's sum,
per-sample terms are summed over the shard and divided by the global batch
size, the encoder's Gumbel noise is drawn for the global batch and then
split, and the codebook-entropy bonus, a function of the global batch's
mean code, enters each shard's loss as its linearisation at that mean (the
mean comes from an encoder pass before the step, only when the bonus has a
weight). The clip acts on the reduced gradient, inside each replica's update.

The all-reduce gives each rank the sum in that rank's own rotation order
(the ring's order, which the one-pass kernel keeps), so for three or more
replicas the ranks' sums may differ in the last bits: every replica applies
rank 0's sum, and the replicas stay bit-identical.

When ``torch.distributed`` is initialised with more than one process, each
process holds its part of the global batch (parts in rank order), and a
``dist.all_reduce`` of the reduced gradient, the loss terms and the weight
and code sums across the processes follows the ring: the counterpart of the
multi-host psum.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from simulate_2048_tpu_torch.env import env as envlib
from simulate_2048_tpu_torch.models.network import MuZeroNetwork
from simulate_2048_tpu_torch.ops import board as ops
from simulate_2048_tpu_torch.ops.rollout import random_actions
from simulate_2048_tpu_torch.parallel.mesh import Mesh, batch_sharding, shard_pytree_batch
from simulate_2048_tpu_torch.parallel.ring import ring_all_reduce_shard
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.learner import (
    Optimizer,
    TrainState,
    encoder_noise,
    fresh_priorities,
    parameter_gradients,
    train_superstep,
)
from simulate_2048_tpu_torch.training.losses import (
    LossOutput,
    TrainingTargets,
    codebook_entropy,
    combine_loss,
    unroll_terms,
    weighted_means,
)


def _process_group() -> tuple[int, int]:
    """(world size, rank) of the initialised ``torch.distributed`` job, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(x)
    return x


class DataParallelTrainStep:
    """``step(state, batch, is_weights) -> (state, loss breakdown, priorities)``
    over ``mesh``; see the module docstring. ``batch`` and ``is_weights`` are
    this process's whole batch (on the state's device); the priorities come
    back in batch order. ``state`` must hold ``network`` on the mesh's first
    device: it is replica 0 and is updated in place. The other replicas are
    copied from it at the first step, and again whenever another state or a
    state whose step count moved on outside this object arrives.
    """

    def __init__(self, network: MuZeroNetwork, config: TrainConfig, optimizer: Optimizer, mesh: Mesh):
        self.network, self.config, self.optimizer, self.mesh = network, config, optimizer, mesh
        self.replicas: list[TrainState] = []

    def _replicate(self, state: TrainState) -> None:
        if state.network is not self.network:
            raise ValueError("the state passed to a data-parallel step must hold the step's network")
        first = self.mesh.devices[0]
        if any(p.device != first for p in state.params):
            raise ValueError(f"the state must live on the mesh's first device, {first}")
        replicas = [state]
        for device in self.mesh.devices[1:]:
            opt_state = {
                "count": state.opt_state["count"],
                **{k: [t.to(device, copy=True) for t in state.opt_state[k]] for k in ("mu", "nu")},
            }
            replicas.append(TrainState(copy.deepcopy(state.network).to(device), opt_state, state.step))
        self.replicas = replicas

    def _code_usage_sum(self, shards: list[TrainingTargets]) -> torch.Tensor:
        """Sum over this process's windows of each window's mean soft code."""
        with torch.no_grad():
            parts = [
                r.network.encoder(s.observations[:, 1:], deterministic=False).mean(1).sum(0)
                for r, s in zip(self.replicas, shards)
            ]
        return _fold([p.to(self.mesh.devices[0]) for p in parts])

    def __call__(
        self, state: TrainState, batch: TrainingTargets, is_weights: torch.Tensor | None
    ) -> tuple[TrainState, LossOutput, torch.Tensor]:
        if not self.replicas or self.replicas[0] is not state or any(r.step != state.step for r in self.replicas):
            self._replicate(state)
        cfg, mesh = self.config, self.mesh
        first = mesh.devices[0]
        world, rank = _process_group()
        local = batch.actions.shape[0]
        total = local * world  # windows in the global batch
        shards = shard_pytree_batch(batch, mesh)
        place = batch_sharding(mesh)
        weights = [None] * mesh.size if is_weights is None else place(is_weights)
        weight_total = None
        if is_weights is not None:
            weight_total = is_weights.sum()
            if world > 1:
                weight_total = _all_reduce(weight_total)
        gumbel = encoder_noise(cfg, state.step, (total, cfg.num_unroll_steps), batch.observations.device)
        gumbel = [None] * mesh.size if gumbel is None else place(gumbel[rank * local : (rank + 1) * local])

        encoder = cfg.chance_target_mode == "encoder"
        entropy_slope = None
        usage_sum = None
        if encoder and cfg.codebook_entropy_weight != 0.0:
            usage_sum = self._code_usage_sum(shards)
            if world > 1:
                usage_sum = _all_reduce(usage_sum)
            u = (usage_sum / total).requires_grad_()
            (entropy_slope,) = torch.autograd.grad(codebook_entropy(u), u)

        flats, shares, usages = [], [], []
        for replica, shard, w, g in zip(self.replicas, shards, weights, gumbel):
            device = replica.params[0].device
            per_sample, code_usage = unroll_terms(replica.network, shard, cfg, g)
            means = weighted_means(per_sample, w, total, None if weight_total is None else weight_total.to(device))
            bonus = torch.zeros((), device=device)
            if entropy_slope is not None:
                bonus = (entropy_slope.to(device) * code_usage.sum(0)).sum() / total
            loss, _ = combine_loss(cfg, means, bonus)
            grads = parameter_gradients(loss, replica.params)
            flats.append(torch.cat([x.reshape(-1) for x in grads]).to(first))
            shares.append(torch.stack(means).detach().to(first))
            if encoder and usage_sum is None:
                usages.append(code_usage.detach().sum(0).to(first))

        reduced = ring_all_reduce_shard(flats)[0]  # one launch; rank 0's sum, applied on every replica
        means = _fold(shares)
        if encoder and usage_sum is None:
            usage_sum = _fold(usages)
            if world > 1:
                usage_sum = _all_reduce(usage_sum)
        if world > 1:
            reduced, means = _all_reduce(reduced), _all_reduce(means)
        usage = torch.zeros(cfg.codebook_size, device=first) if usage_sum is None else usage_sum / total
        _, loss_output = combine_loss(cfg, list(means), codebook_entropy(usage))

        for replica in self.replicas:
            grads = _unflatten(reduced.to(replica.params[0].device), replica.params)
            self.optimizer.update(replica.params, grads, replica.opt_state)
            replica.step += 1
        priorities = torch.cat(
            [fresh_priorities(r.network, s, cfg).to(batch.observations.device) for r, s in zip(self.replicas, shards)]
        )
        return state, LossOutput(*(x.detach() for x in loss_output)), priorities


def _fold(parts: list[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ..., in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _unflatten(flat: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    return [g.view(p.shape) for g, p in zip(torch.split(flat, [p.numel() for p in params]), params)]


def make_dp_train_step(
    network: MuZeroNetwork, config: TrainConfig, optimizer: Optimizer, mesh: Mesh
) -> DataParallelTrainStep:
    """Data-parallel train step: state (replicated), batch and weights
    (split over the mesh) in; state, loss breakdown (of the global batch) and
    priorities (in batch order) out."""
    return DataParallelTrainStep(network, config, optimizer, mesh)


def make_dp_train_superstep(
    network: MuZeroNetwork,
    config: TrainConfig,
    optimizer: Optimizer,
    mesh: Mesh,
    num_steps: int,
    train_step: DataParallelTrainStep | None = None,
) -> Callable:
    """``superstep(state, buffer, generator) -> (state, buffer, mean losses)``:
    ``num_steps`` iterations of sample, data-parallel step and priority
    update (``learner.train_superstep`` with the data-parallel step inside).
    Pass ``train_step`` to share the replicas of a per-step data-parallel
    step that trains the same state."""
    step = train_step or make_dp_train_step(network, config, optimizer, mesh)

    def superstep(state: TrainState, buffer, generator: torch.Generator | None):
        return train_superstep(state, buffer, generator, config, optimizer, num_steps, step_fn=step)

    return superstep


def make_sharded_rollout(mesh: Mesh, num_envs: int, num_steps: int) -> Callable:
    """``rollout(run_seed) -> (env-steps, reward sum, max tile)``: uniform-random
    auto-reset rollouts with the environment batch split over the mesh
    (``num_envs / mesh size`` boards on each device), no traffic between the
    devices until the three totals are gathered on the first device."""

    @torch.no_grad()
    def rollout(run_seed: int):
        first = mesh.devices[0]
        shards = shard_pytree_batch(envlib.reset_batch(run_seed, num_envs, first), mesh)
        rewards = [torch.zeros((), dtype=torch.float32, device=s.board.device) for s in shards]
        for t in range(num_steps):
            for i, state in enumerate(shards):
                shards[i], reward, _, _ = envlib.step_auto_reset(state, random_actions(state, t))
                rewards[i] = rewards[i] + reward.sum()
        reward_sum = _fold([r.to(first) for r in rewards])
        max_tile = torch.stack([ops.max_tile(s.board).amax().to(first) for s in shards]).amax()
        steps = torch.tensor(num_envs * num_steps, dtype=torch.int32, device=first)
        return steps, reward_sum, max_tile

    return rollout

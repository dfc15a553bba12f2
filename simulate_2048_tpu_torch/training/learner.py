"""Learner: optimizer, train state and train step, in PyTorch (port of the
JAX package's ``training/learner.py``).

The optimizer is written out by hand to match the JAX package's optax chain
number for number: linear warm-up from 0 (so the very first step changes
nothing) joined to a constant or cosine schedule that counts from the end of
warm-up, a global-norm clip that scales by ``max_norm / max(norm, max_norm)``
(no epsilon), and Adam / AdamW with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, decoupled weight decay), computed with
``torch._foreach_*`` over the whole parameter list. Gradients come
from ``torch`` autograd: the JAX package has no hand-written backward pass.

A :class:`TrainState` holds the network, whose parameters a step updates in
place, the Adam moments and the step count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from simulate_2048_tpu_torch.models.network import NETWORK_NAMES, MuZeroNetwork, network_from_config
from simulate_2048_tpu_torch.ops.value_transform import scale_value
from simulate_2048_tpu_torch.training.config import TrainConfig
from simulate_2048_tpu_torch.training.losses import LossOutput, TrainingTargets, compute_loss

def learning_rate(config: TrainConfig, count: int) -> float:
    """The schedule's value at optimizer step ``count`` (0 for the first
    update): linear 0 → LR over ``warmup_steps``, then constant, or cosine
    decay to ``lr_final_fraction``·LR over
    ``max(lr_decay_steps − warmup_steps, 1)`` further steps."""
    lr, warm = config.learning_rate, config.warmup_steps
    if count < warm:
        return lr * min(max(count / warm, 0.0), 1.0)
    if config.lr_decay_steps is None:
        return lr
    decay_steps = max(config.lr_decay_steps - warm, 1)
    frac = min(count - warm, decay_steps) / decay_steps
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return lr * ((1.0 - config.lr_final_fraction) * cosine + config.lr_final_fraction)


def _bias_correction(decay: float, count: int) -> float:
    """Adam's 1 − decay^count, evaluated in float32 as optax evaluates it
    (for b2 = 0.999 the subtraction cancels, so float64 would differ from
    the JAX package by 5e-5 relative in the first steps)."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


@dataclass
class Optimizer:
    """Global-norm clip → Adam(W) on the schedule of :func:`learning_rate`."""

    config: TrainConfig
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: list[torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor], opt_state: dict) -> None:
        """One optimizer step on ``params`` and ``opt_state``, in place."""
        cfg = self.config
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        max_norm = torch.full_like(norm, cfg.max_grad_norm)
        grads = torch._foreach_mul(grads, max_norm / torch.maximum(norm, max_norm))
        count = opt_state["count"]
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, _bias_correction(self.b2, count + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, _bias_correction(self.b1, count + 1))
        torch._foreach_div_(step, denom)
        if cfg.weight_decay > 0:
            torch._foreach_add_(step, params, alpha=cfg.weight_decay)
        torch._foreach_add_(params, step, alpha=-learning_rate(cfg, count))
        opt_state["count"] = count + 1


def create_optimizer(config: TrainConfig) -> Optimizer:
    """Warm-up → constant or cosine learning rate, global-norm clip, Adam
    (AdamW with ``config.weight_decay > 0``)."""
    return Optimizer(config)


@dataclass
class TrainState:
    """Learner state: the network (its parameters are updated in place), the
    optimizer state and the number of steps taken."""

    network: MuZeroNetwork
    opt_state: dict
    step: int = 0
    params: list[torch.Tensor] = field(init=False, repr=False)

    def __post_init__(self):
        self.params = list(self.network.parameters())


def create_train_state(
    config: TrainConfig, key: torch.Tensor, device: torch.device | str = "cpu"
) -> tuple[TrainState, MuZeroNetwork]:
    """Initialise the networks (JAX's weights for ``key``) and the optimizer state on ``device``."""
    network = network_from_config(config, key, device)
    state = TrainState(network, create_optimizer(config).init(list(network.parameters())))
    return state, network


def encoder_noise(config: TrainConfig, step: int, batch_shape: tuple[int, ...], device) -> torch.Tensor | None:
    """The Gumbel noise of the encoder's code choice at learner step ``step``
    for a batch of (B, K) windows, from a generator seeded with
    ``(config.seed, step)``; None when the config draws none."""
    if config.encoder_noise_scale <= 0.0 or config.chance_target_mode != "encoder":
        return None
    gen = torch.Generator(device=device).manual_seed((config.seed << 32) + step)
    u = torch.rand((*batch_shape, config.codebook_size), generator=gen, device=device).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def parameter_gradients(total: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """d total / d params, zeros for a parameter that ``total`` does not reach."""
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


@torch.no_grad()
def fresh_priorities(network: MuZeroNetwork, batch: TrainingTargets, config: TrainConfig) -> torch.Tensor:
    """|v̂₀ − h(z₀)| of every window under the network's current parameters, floored at 1e-3."""
    hidden = network.representation(batch.observations[:, 0])
    _, v0 = network.prediction(hidden)
    priorities = torch.abs(v0 - scale_value(batch.target_values[:, 0], config.value_epsilon))
    return torch.clamp_min(priorities, 1e-3)


def train_step(
    state: TrainState,
    batch: TrainingTargets,
    is_weights: torch.Tensor | None,
    config: TrainConfig,
    optimizer: Optimizer,
    gumbel: torch.Tensor | None = None,
) -> tuple[TrainState, LossOutput, torch.Tensor]:
    """One optimisation step, in place on ``state``.

    Returns ``(state, loss breakdown, fresh per-sample priorities)``: the
    priorities are |v̂₀ − h(z₀)| under the updated parameters, floored at
    1e-3. With ``config.encoder_noise_scale > 0`` and no ``gumbel`` noise
    given, the noise is :func:`encoder_noise` of this step.
    """
    if gumbel is None:
        gumbel = encoder_noise(config, state.step, batch.actions.shape, batch.observations.device)
    total, loss_output = compute_loss(state.network, batch, config, is_weights, gumbel)
    optimizer.update(state.params, parameter_gradients(total, state.params), state.opt_state)
    priorities = fresh_priorities(state.network, batch, config)
    state.step += 1
    return state, LossOutput(*(x.detach() for x in loss_output)), priorities


def train_superstep(
    state: TrainState,
    buffer_state,
    generator: torch.Generator | None,
    config: TrainConfig,
    optimizer: Optimizer,
    num_steps: int,
    step_fn: Callable | None = None,
):
    """``num_steps`` learner iterations (sample, step, priority update) as a
    plain loop, each step :func:`train_step` or ``step_fn(state, batch,
    weights)`` (the data-parallel step). Returns ``(state, buffer, mean losses)``."""
    from simulate_2048_tpu_torch.training import replay as replay_lib

    if step_fn is None:
        step_fn = lambda s, batch, weights: train_step(s, batch, weights, config, optimizer)  # noqa: E731
    acc = None
    for _ in range(num_steps):
        batch, indices, weights = replay_lib.sample_batch(buffer_state, generator, config.batch_size, config)
        state, loss_output, priorities = step_fn(state, batch, weights)
        buffer_state = replay_lib.update_priorities(buffer_state, indices, priorities)
        acc = loss_output if acc is None else LossOutput(*(a + x for a, x in zip(acc, loss_output)))
    return state, buffer_state, LossOutput(*(x / num_steps for x in acc))


def compute_gradient_stats(network: MuZeroNetwork, grads: list[torch.Tensor]) -> dict[str, float]:
    """Per-network gradient norms, for diagnostics; ``grads`` in the order of ``network.parameters()``."""
    by_param = {id(p): g for p, g in zip(network.parameters(), grads)}
    out = {}
    for name in NETWORK_NAMES:
        sq = sum(float(torch.sum(torch.square(by_param[id(p)]))) for p in getattr(network, name).parameters())
        out[f"grad_norm/{name}"] = math.sqrt(sq)
    return out

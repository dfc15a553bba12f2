"""Stochastic MuZero losses: K-step unrolled policy / value / reward / chance /
commitment objectives, in PyTorch (port of the JAX package's
``training/losses.py``).

``config.chance_target_mode`` selects where the chance codes come from:

- ``"oracle"`` (default): 2048's chance event is fully observed, so the code
  is ground truth, ``2·cell + is_four``, recovered from consecutive stored
  boards. ψ's chance logits get a cross-entropy toward it and g is
  teacher-forced with it; no encoder in the loop.
- ``"oracle_dist"``: like "oracle", but ψ's target is the exact spawn
  distribution given the afterstate (0.9/n per empty cell for a 2, 0.1/n for
  a 4).
- ``"encoder"``: the encoder codes obs_{t+1} into a chance one-hot that is
  the (detached) cross-entropy target for ψ, teacher-forces the dynamics
  input through a straight-through estimator, and receives a commitment loss.
- ``"placeholder"``: a constant one-hot at index 0 as target, and the
  model's own argmax as the dynamics input.

The JAX package maps a per-sample scan over the K steps across the batch;
here every step is computed for the whole batch at once. Gradients come from
``torch`` autograd over the network modules.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from simulate_2048_tpu_torch.ops import board as board_ops
from simulate_2048_tpu_torch.ops import distributional
from simulate_2048_tpu_torch.ops.value_transform import scale_value
from simulate_2048_tpu_torch.training.config import TrainConfig


class LossOutput(NamedTuple):
    """Loss breakdown (batch means, importance-weighted)."""

    total_loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    reward_loss: torch.Tensor
    chance_loss: torch.Tensor
    commitment_loss: torch.Tensor
    codebook_entropy: torch.Tensor
    consistency_loss: torch.Tensor
    afterstate_value_loss: torch.Tensor


class TrainingTargets(NamedTuple):
    """A batch of training windows: K+1 observations / policies / values, K actions / rewards."""

    observations: torch.Tensor  # (B, K+1, obs_dim)
    actions: torch.Tensor  # (B, K) int64
    target_policies: torch.Tensor  # (B, K+1, action_size)
    target_values: torch.Tensor  # (B, K+1) raw space
    target_rewards: torch.Tensor  # (B, K) raw space


def policy_loss(predicted_logits: torch.Tensor, target_policy: torch.Tensor) -> torch.Tensor:
    """Cross-entropy vs a soft target."""
    return -(target_policy * torch.log_softmax(predicted_logits, dim=-1)).sum(-1)


def value_loss(predicted_value: torch.Tensor, target_value: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    """Squared error in h-scaled space."""
    return torch.square(predicted_value - scale_value(target_value, epsilon))


def reward_loss(predicted_reward: torch.Tensor, target_reward: torch.Tensor, epsilon: float = 0.001) -> torch.Tensor:
    """Squared error in h-scaled space."""
    return torch.square(predicted_reward - scale_value(target_reward, epsilon))


def chance_loss(predicted_logits: torch.Tensor, target_code: torch.Tensor) -> torch.Tensor:
    """Cross-entropy vs the chance code (or distribution)."""
    return -(target_code * torch.log_softmax(predicted_logits, dim=-1)).sum(-1)


def commitment_loss(encoder_probs: torch.Tensor, target_code: torch.Tensor) -> torch.Tensor:
    """VQ-VAE commitment: ‖e(o) − c‖²."""
    return torch.square(encoder_probs - target_code).sum(-1)


def _encode_chance(network, observations: torch.Tensor, noise_scale: float = 0.0, gumbel: torch.Tensor | None = None):
    """Encode observations to (straight-through code, hard one-hot, commitment, probs).

    One encoder pass in soft mode yields everything: probabilities for the
    gradient and the commitment loss, the argmax one-hot as cross-entropy
    target, and the straight-through code that teacher-forces the dynamics
    input. With ``noise_scale > 0`` and ``gumbel`` noise (shaped like the
    probabilities), the noise perturbs the choice of code.
    """
    probs = network.encoder(observations, deterministic=False)
    select_logits = torch.log(probs + 1e-12)
    if noise_scale > 0.0 and gumbel is not None:
        select_logits = select_logits + noise_scale * gumbel
    one_hot = torch.nn.functional.one_hot(select_logits.argmax(-1), probs.shape[-1]).to(probs.dtype).detach()
    code_st = probs + (one_hot - probs).detach()
    return code_st, one_hot, commitment_loss(probs, one_hot), probs


def oracle_chance_targets(
    observations: torch.Tensor, actions: torch.Tensor, codebook_size: int, exact_dist: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ground-truth chance codes from consecutive observations.

    Given boards b_t, b_{t+1} and action a_t, the spawn is
    ``b_{t+1} − afterstate(b_t, a_t)``: one cell gaining exponent 1 (a 2) or
    2 (a 4). The code is ``2·cell + is_four``, the slot order of
    ``ops.board.afterstate_outcomes``.

    ``observations`` (..., K+1, 16) in the exponent/16 encoding, ``actions``
    (..., K). Returns (code one-hot (..., K, codebook_size), chance target
    (..., K, codebook_size), spawned (..., K) bool). ``spawned`` is False
    where no tile appeared (an invalid move, or padding past the episode's
    end where stored boards repeat): mask the chance loss there. With
    ``exact_dist`` the chance target is the exact spawn distribution given
    the afterstate instead of the one-hot.
    """
    lead = actions.shape
    boards = torch.round(observations * board_ops.MAX_EXPONENT).to(torch.int32)
    boards = boards.reshape(*lead[:-1], lead[-1] + 1, 4, 4)
    after, _ = board_ops.apply_action(boards[..., :-1, :, :], actions)
    diff = (boards[..., 1:, :, :] - after).flatten(-2)
    spawned = (diff != 0).any(-1)
    cell = diff.abs().argmax(-1)
    spawn_exp = diff.gather(-1, cell[..., None])[..., 0]
    code = 2 * cell + (spawn_exp == 2).to(torch.int64)
    code_onehot = torch.nn.functional.one_hot(code, codebook_size).to(torch.float32)
    if not exact_dist:
        return code_onehot, code_onehot, spawned
    empty = (after.flatten(-2) == 0).to(torch.float32)
    p_cell = empty / torch.clamp_min(empty.sum(-1, keepdim=True), 1.0)
    dist = torch.stack([0.9 * p_cell, 0.1 * p_cell], dim=-1).flatten(-2)
    dist = torch.nn.functional.pad(dist, (0, codebook_size - 32))
    return code_onehot, dist, spawned


def unroll_terms(
    network, batch: TrainingTargets, config: TrainConfig, gumbel: torch.Tensor | None = None
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor | None]:
    """The K-step unroll of a batch, per sample.

    Returns the seven per-sample terms (B,) in the order of
    :class:`LossOutput`'s policy, value, reward, chance, commitment,
    consistency and afterstate-value fields, and, when the chance codes come
    from the encoder, each sample's mean soft code (B, codebook_size), whose
    batch mean the codebook entropy is taken of (None otherwise).
    ``gumbel`` (B, K, codebook_size) is the encoder's selection noise for
    ``config.encoder_noise_scale > 0``.
    """
    use_encoder = config.chance_target_mode == "encoder"
    use_oracle = config.chance_target_mode in ("oracle", "oracle_dist")
    k_steps = config.num_unroll_steps
    bsz = batch.actions.shape[0]
    dev = batch.observations.device

    # Categorical heads train on cross-entropy toward a two-hot h-space
    # target through the raw-logit forwards; scalar heads on squared error.
    def head_loss(bins: int, support_max: float):
        if bins > 1:
            return lambda pred, target_raw: distributional.categorical_loss(
                pred, scale_value(target_raw, config.value_epsilon), support_max
            )
        return lambda pred, target_raw: value_loss(pred, target_raw, config.value_epsilon)

    v_loss = head_loss(config.value_bins, config.value_support_max)
    r_loss = head_loss(config.reward_bins, config.reward_support_max)

    hidden = network.representation(batch.observations[:, 0])
    logits0, value0 = network.prediction.logits(hidden)
    tot_p = policy_loss(logits0, batch.target_policies[:, 0])
    tot_v = v_loss(value0, batch.target_values[:, 0])

    zeros_k = torch.zeros(bsz, k_steps, dtype=torch.float32, device=dev)
    code_usage = None
    if use_encoder:
        # Chance codes of obs_1..obs_K (the observed outcomes of steps 0..K-1).
        code_st, chance_target, commit_all, probs = _encode_chance(
            network, batch.observations[:, 1:], config.encoder_noise_scale, gumbel
        )
        chance_mask = torch.ones_like(zeros_k)
        code_usage = probs.mean(1)  # each sample's mean soft code, for the entropy bonus
    elif use_oracle:
        code_st, chance_target, spawned = oracle_chance_targets(
            batch.observations, batch.actions, config.codebook_size, config.chance_target_mode == "oracle_dist"
        )
        chance_mask = spawned.to(torch.float32)
        commit_all = zeros_k
    else:
        chance_target = torch.zeros(bsz, k_steps, config.codebook_size, dtype=torch.float32, device=dev)
        chance_target[..., 0] = 1.0
        code_st = chance_target
        chance_mask = torch.ones_like(zeros_k)
        commit_all = zeros_k

    # Self-supervised consistency targets: the re-encoded true next states, detached.
    h_true = None
    if config.consistency_loss_weight > 0.0:
        h_true = network.representation(batch.observations[:, 1:]).detach()

    zero = torch.zeros(bsz, dtype=torch.float32, device=dev)
    tot_r, tot_c, tot_cons, tot_q = zero, zero, zero, zero
    state = hidden
    one_hot = torch.nn.functional.one_hot
    for step in range(k_steps):
        action_onehot = one_hot(batch.actions[:, step], config.action_size).to(torch.float32)

        # Scale the gradient entering each dynamics step, so that the total
        # gradient through a K-step unroll does not grow with depth.
        s = config.dynamics_gradient_scale
        if s < 1.0:
            state = state * s + (state * (1.0 - s)).detach()

        afterstate = network.afterstate_dynamics(state, action_onehot)
        q_pred, chance_logits = network.afterstate_prediction.logits(afterstate)

        # Afterstate value loss: Q(as_t) has the same target z_t as the position's value.
        tot_q = tot_q + v_loss(q_pred, batch.target_values[:, step])
        tot_c = tot_c + chance_loss(chance_logits, chance_target[:, step]) * chance_mask[:, step]
        if use_encoder or use_oracle:
            chance_input = code_st[:, step]
        else:
            chance_input = one_hot(chance_logits.argmax(-1), config.codebook_size).to(torch.float32)

        next_state, pred_reward = network.dynamics.logits(afterstate, chance_input)
        next_logits, next_value = network.prediction.logits(next_state)

        tot_p = tot_p + policy_loss(next_logits, batch.target_policies[:, step + 1])
        tot_v = tot_v + v_loss(next_value, batch.target_values[:, step + 1])
        tot_r = tot_r + r_loss(pred_reward, batch.target_rewards[:, step])

        if h_true is not None:
            # Cosine distance to the re-encoded true next state, masked like the chance loss.
            ht = h_true[:, step]
            ns = next_state.to(torch.float32)
            norms = torch.linalg.vector_norm(ns, dim=-1) * torch.linalg.vector_norm(ht, dim=-1)
            cos = (ns * ht).sum(-1) / (norms + 1e-8)
            tot_cons = tot_cons + (1.0 - cos) * chance_mask[:, step]
        state = next_state

    n_chance = torch.clamp_min(chance_mask.sum(-1), 1.0)
    per_sample = (
        tot_p / (k_steps + 1),
        tot_v / (k_steps + 1),
        tot_r / k_steps,
        tot_c / n_chance,
        commit_all.sum(-1) / k_steps,
        tot_cons / n_chance,
        tot_q / k_steps,
    )
    return per_sample, code_usage


def codebook_entropy(usage: torch.Tensor) -> torch.Tensor:
    """H(mean soft code distribution) of a batch."""
    return -(usage * torch.log(usage + 1e-12)).sum()


def weighted_means(
    per_sample: tuple[torch.Tensor, ...], weights: torch.Tensor | None, count: int, weight_total: torch.Tensor | None
) -> list[torch.Tensor]:
    """Each term's importance-weighted mean over a batch of ``count`` samples
    whose weights sum to ``weight_total`` (weights normalised to mean 1), as
    far as these samples contribute to it: over the whole batch this is the
    mean, over a shard of it the shard's share of the mean. Without weights,
    the plain sum over ``count``."""
    if weights is None:
        return [x.sum() / count for x in per_sample]
    w = weights / weight_total * count
    return [(w * x).sum() / count for x in per_sample]


def combine_loss(config: TrainConfig, means, entropy: torch.Tensor) -> tuple[torch.Tensor, LossOutput]:
    """The weighted total of the seven means and the codebook entropy, and the breakdown."""
    mean_p, mean_v, mean_r, mean_c, mean_commit, mean_cons, mean_q = means
    total = (
        config.policy_loss_weight * mean_p
        + config.value_loss_weight * mean_v
        + config.reward_loss_weight * mean_r
        + config.chance_loss_weight * mean_c
        + config.commitment_loss_weight * mean_commit
        + config.consistency_loss_weight * mean_cons
        + config.afterstate_value_loss_weight * mean_q
        - config.codebook_entropy_weight * entropy
    )
    return total, LossOutput(total, mean_p, mean_v, mean_r, mean_c, mean_commit, entropy, mean_cons, mean_q)


def compute_loss(
    network,
    batch: TrainingTargets,
    config: TrainConfig,
    weights: torch.Tensor | None = None,
    gumbel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, LossOutput]:
    """Batched K-step unrolled loss.

    ``batch`` fields carry a leading batch dimension; ``weights`` are
    optional importance-sampling corrections, normalised to mean 1;
    ``gumbel`` (B, K, codebook_size) is the encoder's selection noise for
    ``config.encoder_noise_scale > 0``.
    """
    per_sample, code_usage = unroll_terms(network, batch, config, gumbel)
    if code_usage is None:
        usage = torch.zeros(config.codebook_size, dtype=torch.float32, device=batch.observations.device)
    else:
        usage = code_usage.mean(0)
    if weights is not None:
        means = weighted_means(per_sample, weights, weights.shape[0], weights.sum())
    else:
        means = [torch.mean(x) for x in per_sample]
    return combine_loss(config, means, codebook_entropy(usage))

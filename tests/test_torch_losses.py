"""Losses of the PyTorch port vs the JAX package, on the CPU.

Same Flax weights, same numpy-seeded batch of training windows (real game
boards, so the oracle chance codes are meaningful). ``oracle_chance_targets``
is integer logic and must be bit-identical. Every ``LossOutput`` field of
``compute_loss`` agrees within rtol 1e-5 / atol 1e-6 (float32 sums in another
order: the JAX package maps a per-sample scan over the batch, the port
computes each unroll step for the whole batch); gradients within rtol 1e-4 /
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_self_play import make_pair

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import losses as jlosses
from simulate_2048_tpu_torch.ops.value_transform import inverse_scale_value, scale_value
from simulate_2048_tpu_torch.training import losses as tlosses

torch.set_num_threads(1)

K, BATCH = 5, 8
DEAD_BOARD = np.array([[3, 4, 5, 6], [7, 8, 9, 10], [3, 4, 5, 6], [7, 8, 9, 1]], dtype=np.int32)  # no move changes it


def game_windows(seed: int, batch: int = BATCH, k: int = K) -> dict[str, np.ndarray]:
    """Training windows cut from seeded random play (with invalid moves and a
    padded tail where the boards repeat), numpy arrays."""
    rs = np.random.RandomState(seed)
    state = jenv.reset_batch(jnp.uint32(seed), batch)
    for _ in range(6):  # a few moves in, so merges happen inside the window
        state, _, _, _ = jenv.step(state, jnp.asarray(rs.randint(0, 4, size=batch)))
    boards, actions, rewards = [np.asarray(state.board)], [], []
    for step in range(k):
        a = rs.randint(0, 4, size=batch)
        frozen = (np.arange(batch) == 1) & (step >= 2)  # window 1 runs past its episode's end
        new_state, r, _, _ = jenv.step(state, jnp.asarray(a))
        board = np.where(frozen[:, None, None], DEAD_BOARD, np.asarray(new_state.board))
        state = new_state._replace(board=jnp.asarray(board))
        boards.append(board)
        actions.append(a)
        rewards.append(np.where(frozen, 0.0, np.asarray(r)))
    policies = rs.dirichlet([0.7] * 4, size=(batch, k + 1)).astype(np.float32)
    return dict(
        observations=(np.stack(boards, 1).reshape(batch, k + 1, 16) / 16.0).astype(np.float32),
        actions=np.stack(actions, 1).astype(np.int32),
        target_policies=policies,
        target_values=(rs.rand(batch, k + 1) * 3000).astype(np.float32),
        target_rewards=np.stack(rewards, 1).astype(np.float32),
    )


def both_batches(seed: int = 1):
    arrays = game_windows(seed)
    jbatch = jlosses.TrainingTargets(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tbatch = tlosses.TrainingTargets(
        **{k: torch.from_numpy(v.astype(np.int64) if k == "actions" else v) for k, v in arrays.items()}
    )
    return jbatch, tbatch


@pytest.mark.parametrize("exact_dist", [False, True], ids=["oracle", "oracle_dist"])
def test_oracle_chance_targets_match_jax(exact_dist):
    jbatch, tbatch = both_batches()
    ref = jax.vmap(lambda o, a: jlosses.oracle_chance_targets(o, a, 32, exact_dist))(
        jbatch.observations, jbatch.actions
    )
    got = tlosses.oracle_chance_targets(tbatch.observations, tbatch.actions, 32, exact_dist)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if exact_dist:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    spawned = got[2].numpy()
    assert spawned.any() and not spawned.all(), "the batch holds real spawns, invalid moves and padding"
    single = tlosses.oracle_chance_targets(tbatch.observations[0], tbatch.actions[0], 40, exact_dist)
    assert single[0].shape == (K, 40) and single[1].shape == (K, 40) and single[2].shape == (K,)


def test_small_losses_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(6, 32).astype(np.float32)
    target = rs.dirichlet([1.0] * 32, size=6).astype(np.float32)
    pred, raw = rs.randn(6).astype(np.float32) * 10, (rs.rand(6) * 5000).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    for name, args in (
        ("policy_loss", (logits, target)),
        ("chance_loss", (logits, target)),
        ("commitment_loss", (target, np.eye(32, dtype=np.float32)[:6])),
        ("value_loss", (pred, raw)),
        ("reward_loss", (pred, raw)),
    ):
        got = getattr(tlosses, name)(*map(t, args)).numpy()
        ref = np.asarray(getattr(jlosses, name)(*map(j, args)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        inverse_scale_value(scale_value(t(raw))).numpy(), raw, rtol=1e-3
    )


CASES = {
    "scalar_oracle": dict(),
    "scalar_oracle_dist_weighted": dict(chance_target_mode="oracle_dist", _weights=True),
    "scalar_encoder": dict(chance_target_mode="encoder", codebook_entropy_weight=0.1),
    "scalar_placeholder": dict(chance_target_mode="placeholder"),
    "categorical_oracle": dict(value_bins=16, reward_bins=8, afterstate_value_loss_weight=0.25),
    "categorical_encoder_weighted": dict(value_bins=16, reward_bins=8, chance_target_mode="encoder", _weights=True),
    "mixed_heads_oracle_dist": dict(value_bins=16, reward_bins=1, chance_target_mode="oracle_dist"),
    "recipe_options": dict(value_bins=16, reward_bins=8, afterstate_value_loss_weight=0.25,
                           consistency_loss_weight=0.5, dynamics_gradient_scale=0.5, _weights=True),
}


def run_case(case: str, grads: bool = False):
    overrides = dict(CASES[case])
    weighted = overrides.pop("_weights", False)
    jcfg, tcfg, jnet, tnet = make_pair(hidden_size=32, num_residual_blocks=2, num_unroll_steps=K, **overrides)
    jbatch, tbatch = both_batches()
    weights = np.random.RandomState(3).rand(BATCH).astype(np.float32) + 0.1 if weighted else None
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.from_numpy(weights)

    def loss_fn(params):
        return jlosses.compute_loss(params, jnet.apply_fns, jbatch, jcfg, jw)

    if grads:
        (_, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jnet.params)
    else:
        (_, jout), jgrads = loss_fn(jnet.params), None
    total, tout = tlosses.compute_loss(tnet, tbatch, tcfg, tw)
    return jout, tout, total, jgrads, (jcfg, tcfg, jnet, tnet)


@pytest.mark.parametrize("case", list(CASES))
def test_compute_loss_matches_jax(case):
    jout, tout, total, _, _ = run_case(case)
    assert tout._fields == jout._fields
    for name in tout._fields:
        np.testing.assert_allclose(
            float(getattr(tout, name).detach()), float(getattr(jout, name)), rtol=1e-5, atol=1e-6, err_msg=name
        )
    assert float(total.detach()) == float(tout.total_loss.detach())


@pytest.mark.parametrize("case", ["scalar_encoder", "recipe_options"])
def test_gradients_match_jax(case):
    """torch autograd through the port's modules vs jax.grad through Flax: the
    straight-through encoder, the detached consistency target and the
    dynamics gradient scale all shape the gradient, not the loss."""
    from simulate_2048_tpu_torch.convert import params_from_flax

    jout, tout, total, jgrads, (jcfg, tcfg, jnet, tnet) = run_case(case, grads=True)
    params = list(tnet.parameters())
    tgrads = torch.autograd.grad(total, params, allow_unused=True)
    # The Flax gradient tree has the parameters' layout: convert it the same way.
    gnet = params_from_flax(jax.tree.map(np.asarray, jgrads), tcfg)
    nonzero = 0
    for (name, _), got, ref in zip(tnet.named_parameters(), tgrads, gnet.parameters()):
        got = torch.zeros_like(ref) if got is None else got
        np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
        nonzero += bool(ref.abs().max() > 0)
    assert nonzero > len(params) // 2


def test_encoder_noise_perturbs_code_choice():
    """Gumbel selection noise (fed as a tensor) changes which codes are
    picked; without it the choice is the encoder's argmax."""
    _, tcfg, _, tnet = make_pair(hidden_size=32, chance_target_mode="encoder", encoder_noise_scale=5.0)
    _, tbatch = both_batches()
    obs = tbatch.observations[:, 1:]
    _, plain, commit, probs = tlosses._encode_chance(tnet, obs, 0.0, None)
    np.testing.assert_array_equal(plain.argmax(-1).numpy(), probs.argmax(-1).numpy())
    u = torch.rand(probs.shape, generator=torch.Generator().manual_seed(0)).clamp_min(1e-20)
    code_st, noisy, _, _ = tlosses._encode_chance(tnet, obs, 5.0, -torch.log(-torch.log(u)))
    assert (noisy.argmax(-1) != plain.argmax(-1)).any()
    np.testing.assert_allclose(code_st.detach().numpy(), noisy.numpy(), atol=1e-6)  # forward value = the one-hot
    assert commit.shape == obs.shape[:2]

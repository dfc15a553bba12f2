"""Learner of the PyTorch port vs the JAX package (optax), on the CPU.

The port writes its optimizer by hand to match the optax chain, so the tests
name the traps: the warm-up schedule gives learning rate 0 at step 0 (the
first step changes nothing, so parameters are compared after several steps);
``optax.clip_by_global_norm`` scales by ``max_norm / max(norm, max_norm)``
with no epsilon; the cosine schedule counts from the end of warm-up with
``decay_steps = max(lr_decay_steps - warmup_steps, 1)``. Learning rates agree
within rtol 2e-5 (optax evaluates the schedule in float32, the port in
float64); losses and priorities within rtol 1e-4 (atol 1e-6); parameters
after three steps within rtol 1e-4 and atol 3e-6, which is 0.1% of the
furthest Adam can move a weight in three steps at the test's learning rate
of 1e-3 (Adam's step does not shrink with the gradient, so float noise in a
near-zero gradient shows at that scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_losses import both_batches
from test_torch_self_play import make_pair

from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import learner as tlearner

torch.set_num_threads(1)

SCHEDULES = {
    "constant": dict(warmup_steps=5),
    "cosine": dict(warmup_steps=5, lr_decay_steps=25, lr_final_fraction=0.1),
    "cosine_shorter_than_warmup": dict(warmup_steps=8, lr_decay_steps=4, lr_final_fraction=0.3),
    "preset": dict(),
}


def optax_learning_rate(jcfg, count: int) -> float:
    """The schedule of ``jlearner.create_optimizer``, rebuilt from the same optax calls."""
    if jcfg.lr_decay_steps is not None:
        post = optax.cosine_decay_schedule(
            jcfg.learning_rate,
            decay_steps=max(jcfg.lr_decay_steps - jcfg.warmup_steps, 1),
            alpha=jcfg.lr_final_fraction,
        )
    else:
        post = optax.constant_schedule(jcfg.learning_rate)
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, jcfg.learning_rate, jcfg.warmup_steps), post], boundaries=[jcfg.warmup_steps]
    )
    return float(schedule(count))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_learning_rate_matches_optax(name):
    jcfg = dataclasses.replace(jconfig.tiny_config(), **SCHEDULES[name])
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    counts = [0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 20, 24, 25, 26, 40, 999, 1000, 1001, 5000]
    got = [tlearner.learning_rate(tcfg, c) for c in counts]
    ref = [optax_learning_rate(jcfg, c) for c in counts]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-12)
    assert got[0] == 0.0, "warm-up starts at learning rate 0"


def run_steps(n_steps: int, **overrides):
    """``n_steps`` train steps on the same batch in both packages."""
    jcfg, tcfg, jnet, tnet = make_pair(hidden_size=32, num_residual_blocks=2, **overrides)
    jbatch, tbatch = both_batches()
    weights = np.random.RandomState(4).rand(jbatch.actions.shape[0]).astype(np.float32) + 0.1
    joptimizer = jlearner.create_optimizer(jcfg)
    jstate = jlearner.TrainState(jnet.params, joptimizer.init(jnet.params), jnp.int32(0))
    toptimizer = tlearner.create_optimizer(tcfg)
    tstate = tlearner.TrainState(tnet, toptimizer.init(list(tnet.parameters())))
    history = []
    for _ in range(n_steps):
        # train_step donates its state: keep a copy of what is compared.
        jw = jnp.asarray(weights)
        jstate, jloss, jprio = jlearner.train_step(jstate, jnet.apply_fns, jbatch, jw, jcfg, joptimizer)
        tstate, tloss, tprio = tlearner.train_step(tstate, tbatch, torch.from_numpy(weights), tcfg, toptimizer)
        history.append((jax.tree.map(np.asarray, jloss), np.asarray(jprio), tloss, tprio))
    return jstate, tstate, history, tcfg


def assert_params_match(jparams, tstate, tcfg, rtol=1e-4, atol=3e-6):
    ref = params_from_flax(jax.tree.map(np.asarray, jparams), tcfg)
    for (name, got), want in zip(tstate.network.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(warmup_steps=2),
        dict(warmup_steps=1, value_bins=16, reward_bins=8, afterstate_value_loss_weight=0.25, max_grad_norm=0.05),
        dict(warmup_steps=1, weight_decay=0.01, lr_decay_steps=3, chance_target_mode="encoder"),
    ],
    ids=["scalar_adam", "categorical_clipped", "adamw_cosine_encoder"],
)
def test_three_train_steps_match_jax(overrides):
    jstate, tstate, history, tcfg = run_steps(3, learning_rate=1e-3, **overrides)
    for jloss, jprio, tloss, tprio in history:
        for name in tloss._fields:
            np.testing.assert_allclose(
                float(getattr(tloss, name)), float(getattr(jloss, name)), rtol=1e-4, atol=1e-6, err_msg=name
            )
        np.testing.assert_allclose(tprio.numpy(), jprio, rtol=1e-4, atol=1e-6)
        assert float(tprio.min()) >= 1e-3
    assert tstate.step == int(jstate.step) == 3 and tstate.opt_state["count"] == 3
    assert_params_match(jstate.params, tstate, tcfg)
    assert not any(t.requires_grad for t in history[-1][2]), "the loss breakdown is detached"


def test_first_step_changes_nothing():
    """Learning rate 0 at step 0: the first update leaves every parameter as
    it was, in both packages, while the Adam moments do move."""
    _, tcfg, _, tnet = make_pair(hidden_size=32, warmup_steps=3)
    before = [p.detach().clone() for p in tnet.parameters()]
    _, tbatch = both_batches()
    optimizer = tlearner.create_optimizer(tcfg)
    state = tlearner.TrainState(tnet, optimizer.init(list(tnet.parameters())))
    state, _, _ = tlearner.train_step(state, tbatch, None, tcfg, optimizer)
    assert all(torch.equal(a, b) for a, b in zip(before, state.params))
    assert any(float(m.abs().max()) > 0 for m in state.opt_state["mu"])
    state, _, _ = tlearner.train_step(state, tbatch, None, tcfg, optimizer)
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params))


@pytest.mark.parametrize("max_norm", [1e-3, 1e6], ids=["clipping", "not_clipping"])
def test_global_norm_clip_matches_optax(max_norm):
    """One update from the same gradients: ``max_norm / max(norm, max_norm)``,
    not ``max_norm / (norm + 1e-6)``."""
    rs = np.random.RandomState(0)
    shapes = [(4, 3), (3,), (2, 5)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [rs.randn(*s).astype(np.float32) * 3 for s in shapes]
    jcfg = dataclasses.replace(jconfig.tiny_config(), max_grad_norm=max_norm, warmup_steps=0, learning_rate=0.1)
    tcfg = tconfig.TrainConfig(**dataclasses.asdict(jcfg))
    clipped, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    joptimizer = jlearner.create_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in params]
    jopt = joptimizer.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    toptimizer = tlearner.create_optimizer(tcfg)
    topt = toptimizer.init(tparams)
    for _ in range(2):
        updates, jopt = joptimizer.update([jnp.asarray(g) for g in grads], jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        toptimizer.update(tparams, [torch.from_numpy(g) for g in grads], topt)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # the moments hold the clipped gradients: (1 - b1) * g * scale after one step, then once more
    norm = np.sqrt(sum((g**2).sum() for g in grads))
    scale = max_norm / max(norm, max_norm)
    np.testing.assert_allclose(np.asarray(clipped[0]), grads[0] * scale, rtol=1e-5)
    np.testing.assert_allclose(topt["mu"][0].numpy(), grads[0] * scale * (1 - 0.9**2), rtol=1e-5)


def test_gradient_stats_and_superstep():
    from simulate_2048_tpu_torch.training import replay as treplay
    from simulate_2048_tpu_torch.env import env as tenv
    from simulate_2048_tpu_torch.training import self_play as tsp

    jcfg, tcfg, jnet, tnet = make_pair(hidden_size=32)
    jbatch, tbatch = both_batches()
    optimizer = tlearner.create_optimizer(tcfg)
    state = tlearner.TrainState(tnet, optimizer.init(list(tnet.parameters())))
    from simulate_2048_tpu_torch.training.losses import compute_loss as torch_compute_loss

    grads = torch.autograd.grad(torch_compute_loss(tnet, tbatch, tcfg)[0], state.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads)]
    got = tlearner.compute_gradient_stats(tnet, grads)

    from simulate_2048_tpu.training.losses import compute_loss

    jgrads = jax.grad(lambda p: compute_loss(p, jnet.apply_fns, jbatch, jcfg)[0])(jnet.params)
    ref = jlearner.compute_gradient_stats(jgrads)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-7, err_msg=key)

    # train_superstep: a plain loop of sample -> step -> priority update with the mean losses.
    buffer = treplay.init_buffer(tcfg)
    _, traj, _ = tsp.play_segment(tnet, tenv.reset_batch(3, 4, "cpu"), None, 0.0, tcfg, 4, True)
    buffer = treplay.add_trajectories(buffer, traj)
    before = buffer.step_priorities.clone()
    gen = torch.Generator().manual_seed(0)
    state, buffer, mean_losses = tlearner.train_superstep(state, buffer, gen, tcfg, optimizer, 2)
    assert state.step == 2 and np.isfinite(float(mean_losses.total_loss))
    assert not torch.equal(buffer.step_priorities, before)

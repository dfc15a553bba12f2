"""Stage 1 of the training path's parity bisection: the port's learner
against the JAX package's over 200 steps on fed batches, on the CPU.

The options are the scalar recipe's (``scripts/run_scalar60k_arm.sh``):
scalar heads, TD(λ=1) targets, afterstate-value loss 0.25, global-norm clip
5 (it binds at every step checked here: the scalar losses are in the
hundreds to thousands), learning rate 3e-4 with the warm-up cut to 20 steps
and a cosine decay, α = β = 1 priorities refreshed after every step; a
categorical twin (16 / 8 bins) runs the same loop. The buffer holds three
segments of seeded random play (some games end inside them, the rest cross
their boundary). At every step the JAX ``sample_batch`` draws the indices
from its buffer with a numpy-seeded key, the port gathers the same indices
from its own buffer, and each package refreshes its own priorities.

Training is chaotic: float noise of one unit in the last place grows step
after step (Adam turns a gradient of float noise into a step of the
learning rate's size). So the port is held to the JAX package as closely as
the JAX package holds to itself: a control run of the JAX learner from its
initial weights times (1 + 1e-7 ε), ε standard normal, on the same batches.
At every step each logged loss of the port is within twice the control's
largest relative gap so far, plus 1e-5; after 200 steps the median and the
largest relative L2 gap of the port's parameter tensors are within twice
the control's, plus 1e-6. Measured (the port against the control): scalar
losses 4.3e-5 against 1.1e-3, parameters 6.6e-3 against 9.5e-2 at most;
categorical losses at most 0.9999 of the control's. The importance weights
agree within rtol 1e-4 / atol 1e-6 at every step, the buffers' priorities
within one bfloat16 unit (2^-7 relative) after the first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_replay import as_f32
from test_torch_self_play import make_pair

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import replay as jreplay
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.training import learner as tlearner
from simulate_2048_tpu_torch.training import replay as treplay
from simulate_2048_tpu_torch.training.losses import compute_loss

torch.set_num_threads(1)

SCALAR_RECIPE = dict(
    value_target_mode="td_lambda", td_lambda=1.0, cross_segment_backfill=True, afterstate_value_loss_weight=0.25,
)
STEPS = 200


def random_play_segment(seed: int, games: int, t: int) -> dict[str, np.ndarray]:
    """A segment of seeded random legal play (JAX env), recorded after 80
    moves of auto-resetting play, so that some games end inside it and the
    rest cross its boundary, with recipe-sized value targets: each
    position's reward-to-go plus a tail of 500-3,000 where the game goes on,
    jittered by 20%."""
    rs = np.random.RandomState(seed)
    state = jenv.reset_batch(jnp.uint32(seed), games)
    step = jax.jit(jenv.step)
    warm = jax.jit(jenv.step_auto_reset)
    for _ in range(80):
        state, _, _, _ = warm(state, jnp.asarray(rs.randint(0, 4, size=games)))
    boards, actions, rewards, active = [], [], [], []
    for _ in range(t):
        legal = np.asarray(jenv.get_legal_actions(state))
        a = np.array([rs.choice(np.flatnonzero(row)) if row.any() else 0 for row in legal])
        live = ~np.asarray(state.done)
        boards.append(np.asarray(state.board).reshape(games, 16))
        actions.append(a * live)
        active.append(live)
        state, r, _, _ = step(state, jnp.asarray(a))
        rewards.append(np.asarray(r) * live)
    boards.append(np.asarray(state.board).reshape(games, 16))
    rewards, active, done = np.stack(rewards, 1).astype(np.float32), np.stack(active, 1), np.asarray(state.done)
    tail = np.where(done, 0.0, rs.rand(games) * 2500 + 500)
    to_go = np.flip(np.cumsum(np.flip(rewards, 1), 1), 1) + tail[:, None]
    return dict(
        boards=np.stack(boards, 1).astype(np.int8),
        actions=np.stack(actions, 1).astype(np.int8),
        rewards=rewards,
        policies=rs.dirichlet([0.5] * 4, size=(games, t)).astype(np.float32) * active[..., None],
        values=(to_go * (1 + 0.2 * rs.randn(games, t)) * active).astype(np.float32),
        priorities=(rs.rand(games, t) * 20 * active).astype(np.float32),
        length=active.sum(1).astype(np.int32),
        terminated=done,
        total_reward=rewards.sum(1),
        max_tile=np.full(games, 64, np.int32),
    )


def to_jax(arrays: dict) -> jreplay.Trajectory:
    return jreplay.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()})


def to_torch(arrays: dict) -> treplay.Trajectory:
    return treplay.Trajectory(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def global_grad_norm(network, batch, weights, config) -> float:
    total, _ = compute_loss(network, batch, config, weights)
    grads = tlearner.parameter_gradients(total, list(network.parameters()))
    return float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))


def relative_gap(got, want) -> float:
    """The largest relative gap between two loss breakdowns, over the terms that are not 0."""
    gaps = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, want) if float(b) != 0.0]
    return max(gaps)


def parameter_gaps(got, want) -> np.ndarray:
    """Relative L2 gap of each parameter tensor of two port networks."""
    return np.array([
        float(torch.linalg.vector_norm(g.detach() - w.detach()) / torch.linalg.vector_norm(w.detach()).clamp_min(1e-12))
        for g, w in zip(got.parameters(), want.parameters())
    ])  # fmt: skip


@pytest.mark.parametrize("bins", [(1, 1), (16, 8)], ids=["scalar_recipe", "categorical_recipe"])
def test_learner_200_steps_on_fed_batches_matches_jax(bins):
    jcfg, tcfg, jnet, tnet = make_pair(
        hidden_size=32, num_residual_blocks=2, batch_size=16, replay_buffer_size=64, max_trajectory_length=40,
        num_unroll_steps=5, max_grad_norm=5.0, learning_rate=3e-4, warmup_steps=20, lr_decay_steps=600,
        priority_alpha=1.0, priority_beta=1.0, value_bins=bins[0], reward_bins=bins[1], **SCALAR_RECIPE,
    )
    jbuf, tbuf = jreplay.init_buffer(jcfg), treplay.init_buffer(tcfg)
    for seed in range(3):
        arrays = random_play_segment(seed, games=16, t=40)
        jbuf = jreplay.add_trajectories(jbuf, to_jax(arrays))
        tbuf = treplay.add_trajectories(tbuf, to_torch(arrays))
    assert bool(tbuf.terminated.any()) and not bool(tbuf.terminated[: int(tbuf.size)].all())

    rs = np.random.RandomState(3)
    jittered = jax.tree.map(
        lambda x: jnp.asarray((np.asarray(x) * (1 + 1e-7 * rs.standard_normal(np.shape(x)))).astype(np.float32)),
        jnet.params,
    )
    jopt, topt = jlearner.create_optimizer(jcfg), tlearner.create_optimizer(tcfg)
    jstate = jlearner.TrainState(jnet.params, jopt.init(jnet.params), jnp.int32(0))
    control = jlearner.TrainState(jittered, jopt.init(jittered), jnp.int32(0))
    tstate = tlearner.TrainState(tnet, topt.init(list(tnet.parameters())))
    keys = np.random.RandomState(7)
    norms, envelope = [], 0.0
    for step in range(STEPS):
        jbatch, jidx, jw = jreplay.sample_batch(jbuf, jax.random.PRNGKey(keys.randint(1 << 30)), jcfg.batch_size, jcfg)
        tidx = torch.from_numpy(np.array(jidx))
        tbatch, tw = treplay.gather_batch(tbuf, tidx, tcfg)
        np.testing.assert_array_equal(tbatch.observations.numpy(), np.asarray(jbatch.observations))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-6, err_msg=f"IS weights, step {step}")
        if bins == (1, 1) and step in (0, STEPS // 2, STEPS - 1):
            norms.append(global_grad_norm(tstate.network, tbatch, tw, tcfg))
        jstate, jloss, jprio = jlearner.train_step(jstate, jnet.apply_fns, jbatch, jw, jcfg, jopt)
        control, closs, _ = jlearner.train_step(control, jnet.apply_fns, jbatch, jw, jcfg, jopt)
        tstate, tloss, tprio = tlearner.train_step(tstate, tbatch, tw, tcfg, topt)
        envelope = max(envelope, relative_gap(closs, jloss))
        gap = relative_gap(tloss, jloss)
        assert gap <= 2 * envelope + 1e-5, f"step {step}: loss gap {gap:.3g}, the control's so far {envelope:.3g}"
        jbuf = jreplay.update_priorities(jbuf, jidx, jprio)
        tbuf = treplay.update_priorities(tbuf, tidx, tprio)
        if step == 0:
            np.testing.assert_allclose(as_f32(tbuf.step_priorities), as_f32(jbuf.step_priorities), rtol=2.0**-7)
    if bins == (1, 1):
        assert min(norms) > tcfg.max_grad_norm, f"the clip binds at every step checked: {norms}"
    assert tstate.step == STEPS and tstate.opt_state["count"] == STEPS
    ref = params_from_flax(jax.tree.map(np.asarray, jstate.params), tcfg)
    port = parameter_gaps(tstate.network, ref)
    ctrl = parameter_gaps(params_from_flax(jax.tree.map(np.asarray, control.params), tcfg), ref)
    assert np.median(port) <= 2 * np.median(ctrl) + 1e-6, (np.median(port), np.median(ctrl))
    assert port.max() <= 2 * ctrl.max() + 1e-6, (port.max(), ctrl.max())

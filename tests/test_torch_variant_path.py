"""The search variants (Gumbel root, sampled chance selection, progressive
widening) through the port's self-play, reanalyze and trainer, against the
JAX package on the CPU.

JAX draws every search's noise from keys split inside ``play_segment``
(``split(split(key, T)[t], B + 1)[:B]``) and ``reanalyze_slots``
(``split(key, n·T)``); the port is fed the same numbers, rebuilt from those
keys by ``jax_draws``. With ``temperature_move_cutoff=0`` the actions are the
argmax of the improved policy, so both packages play the same games: boards,
actions, rewards and lengths must be equal; search values within atol 1e-4;
policy targets within rtol 1e-5 / atol 1e-6 when the search runs in the
network's h-space, and within atol 1e-4 when it untransforms to raw returns:
the improved policy softmax(log π + σ(q̂)) takes the float noise of Q (which
h⁻¹ grows with the value) times (c_visit + max N)·c_scale / (max Q − min Q).
Reanalysed targets are compared as stored: policies (float16) within one
float16 step, values and priorities (bfloat16) within one bfloat16 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reanalyze import assert_targets_close, both_buffers
from test_torch_replay import as_f32
from test_torch_search_modes import jax_draws
from test_torch_self_play import make_pair

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import reanalyze as jreanalyze
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.models.network import network_from_config
from simulate_2048_tpu_torch.ops import board as tops
from simulate_2048_tpu_torch.ops.rng import prng_key
from simulate_2048_tpu_torch.training import reanalyze as treanalyze
from simulate_2048_tpu_torch.training import self_play as tsp
from simulate_2048_tpu_torch.training import trainer as ttrainer
from simulate_2048_tpu_torch.training.config import tiny_config

torch.set_num_threads(1)

VARIANTS = dict(root_selection="gumbel", chance_selection="sample", pw_c=1.0)
F16_STEP = 2.0**-10


def segment_draws(key, cfg, t_max: int, num_games: int):
    """The root and chance draws of JAX's ``play_segment`` searches, (T, B, …)."""
    gumbel, chance = [], []
    for step_key in jax.random.split(key, t_max):
        g, c = jax_draws(jax.random.split(step_key, num_games + 1)[:num_games], cfg)
        gumbel.append(g)
        chance.append(c)
    return torch.stack(gumbel), torch.stack(chance)


@pytest.mark.parametrize(
    "overrides,policy_tol",
    [(VARIANTS, dict(rtol=0, atol=1e-4)),
     (dict(root_selection="gumbel", search_untransform_values=False), dict(rtol=1e-5, atol=1e-6))],
    ids=["gumbel-sample-widening", "gumbel-h-space"],
)  # fmt: skip
def test_variant_play_segment_matches_jax(overrides, policy_tol):
    games, t_max = 4, 8
    jcfg, tcfg, jnet, tnet = make_pair(num_simulations=8, max_trajectory_length=t_max, temperature_move_cutoff=0,
                                       search_backend="xla", **overrides)  # fmt: skip
    key = jax.random.PRNGKey(21)
    jstate = jenv.reset_batch(jnp.uint32(77), games)
    _, jtraj, jstats = jsp.play_segment(jnet.params, jnet.apply_fns, jstate, key, jnp.float32(1.0), jcfg, games)
    noise, chance = segment_draws(key, tsp.search_config_from(tcfg), t_max, games)
    tstate = tenv.reset_batch(77, games, "cpu")
    _, ttraj, tstats = tsp.play_segment(tnet, tstate, torch.Generator().manual_seed(0), 1.0, tcfg, games,
                                        noise=noise, chance_noise=chance)  # fmt: skip
    for name in ("boards", "actions", "rewards", "length", "terminated", "total_reward"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(), np.asarray(getattr(jtraj, name)), err_msg=name)
    np.testing.assert_allclose(ttraj.policies.numpy(), np.asarray(jtraj.policies), **policy_tol)
    np.testing.assert_allclose(ttraj.values.numpy(), np.asarray(jtraj.values), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tstats.policy_entropy_sum.numpy(), np.asarray(jstats.policy_entropy_sum), rtol=1e-4)
    # The improved policy is positive on every legal action, visited or not.
    active = ttraj.length[:, None] > torch.arange(t_max)[None]
    legal = tops.legal_actions_mask(ttraj.boards[:, :t_max].reshape(games, t_max, 4, 4).to(torch.int32))
    assert (ttraj.policies[legal & active[..., None]] > 1e-6).all()
    np.testing.assert_allclose(ttraj.policies.sum(-1).numpy(), active.float().numpy(), atol=1e-5)


@pytest.mark.parametrize("overrides", [dict(root_selection="gumbel"), VARIANTS], ids=["gumbel", "all-three"])
def test_search_mode_reanalyze_matches_jax(overrides):
    t = 10
    jcfg, tcfg, jnet, tnet = make_pair(max_trajectory_length=t, replay_buffer_size=16, value_target_mode="td_lambda",
                                       td_lambda=1.0, reanalyze_mode="search", search_backend="xla",
                                       **overrides)  # fmt: skip
    jbuf, tbuf, lengths = both_buffers(jcfg, tcfg)
    slots = [0, 1, 2, 4, 11]  # 11 was never written
    key = jax.random.PRNGKey(5)
    jout = jreanalyze.reanalyze_slots(jbuf, jnet.params, jnet.apply_fns, jnp.asarray(slots, jnp.int32), jcfg, key)
    noise, chance = jax_draws(jax.random.split(key, len(slots) * t), tsp.search_config_from(tcfg))
    tout = treanalyze.reanalyze_slots(tbuf, tnet, torch.tensor(slots), tcfg, noise=noise, chance_noise=chance)
    got, ref = as_f32(tout.policies), as_f32(jout.policies)
    np.testing.assert_allclose(got, ref, rtol=F16_STEP, atol=1e-6)
    assert_targets_close(jout, tout)
    rows = [0, 1, 2, 4]
    in_ep = np.arange(t)[None] < lengths[rows, None]
    np.testing.assert_allclose(got[rows].sum(-1), in_ep.astype(np.float32), atol=2e-3)  # float16 probabilities


def test_trainer_runs_the_variants_with_search_reanalyze(tmp_path):
    """Four learner steps of a Trainer with all three variants: self-play,
    a search-mode reanalyze pass and an evaluation run; stored policy
    targets sum to 1 inside the episodes."""
    config = dataclasses.replace(
        tiny_config(), hidden_size=32, num_parallel_games=4, max_trajectory_length=6, min_buffer_size=4,
        batch_size=4, replay_buffer_size=16, num_simulations=6, reanalyze_interval=2, reanalyze_episodes=3,
        reanalyze_mode="search", generation_interval=2, eval_interval=4, eval_games=2, eval_max_moves=4,
        checkpoint_interval=4, **VARIANTS,
    )  # fmt: skip
    trainer = ttrainer.Trainer(config, checkpoint_dir=str(tmp_path), seed=3, device="cpu")
    trainer.initialize()
    trainer.fill_buffer(verbose=False)
    trainer.train(4, verbose=False)
    history = trainer.get_metrics_history()
    assert [r["step"] for r in history if "reanalyze/seconds" in r] == [2]
    assert [r["step"] for r in history if "eval/mean_reward" in r] == [4]
    assert all(np.isfinite(r["total_loss"]) for r in history if "total_loss" in r)
    buffer = trainer.buffer
    size = int(buffer.size)
    in_ep = torch.arange(config.max_trajectory_length)[None] < buffer.length[:size, None]
    sums = buffer.policies[:size].float().sum(-1)
    np.testing.assert_allclose(sums.numpy(), in_ep.float().numpy(), atol=2e-3)


def test_variant_evaluation_follows_the_run_seed():
    """Evaluation keeps sampled chance selection; its chance draws come from
    a generator seeded with the run seed on the games' device, not from the
    caller's generator (deep evaluation and the evaluate CLI pass one on the
    CPU while the games may run on CUDA). So the games follow from the run
    seed alone: two rollouts of one run seed, and two evaluations from
    generators of one seed, are equal."""
    config = dataclasses.replace(tiny_config(), hidden_size=32, num_simulations=6, eval_max_moves=6, **VARIANTS)
    network = network_from_config(config, prng_key(0), "cpu")
    first, second = (tsp._evaluate_rollout(network, 11, config, 4, "cpu") for _ in range(2))
    for a, b in zip(first[0], second[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(first[1:], second[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    stats = [tsp.evaluate_games(network, torch.Generator().manual_seed(3), config, 4, True) for _ in range(2)]
    assert stats[0] == stats[1]
    assert stats[0]["mean_length"] > 0


def test_train_cli_takes_the_variants(tmp_path, capsys):
    from simulate_2048_tpu_torch import train

    sets = ["root_selection='gumbel'", "chance_selection='sample'", "pw_c=1.0", "hidden_size=32",
            "num_parallel_games=2", "max_trajectory_length=4", "num_simulations=3", "batch_size=4"]  # fmt: skip
    args = ["--mode", "tiny", "--steps", "1", "--device", "cpu", "--checkpoint-dir", str(tmp_path), "--no-eval"]
    trainer = train.main(args + [arg for s in sets for arg in ("--set", s)])
    assert trainer.config.root_selection == "gumbel" and trainer.config.pw_c == 1.0
    assert trainer.state.step == 1

"""Stage 3 of the training path's parity bisection: sampled self-play in
distribution, the port against the JAX package, on the CPU.

Both ``play_segment``s run at temperature 1 with the recipe's Dirichlet root
noise (fraction 0.1, α 0.25) from the same converted weights and the same
starting games, each with its own draws, for three runs of 48 games and 180
moves, so that most games end inside the segment. The greedy parity tests
never draw; this one holds what the draws make: the means over runs of the
completed games' length and score, the policy targets' entropy and the
search value agree within four combined standard errors of the per-run
means, and the share of moves that take the most visited action within
0.03.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_self_play import make_pair

from simulate_2048_tpu.env import env as jenv
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu_torch.env import env as tenv
from simulate_2048_tpu_torch.training import self_play as tsp

torch.set_num_threads(1)


def segment_stats(traj, stats, search_values) -> dict[str, float]:
    """Per-run means: completed-game length and score, policy entropy and search value per position."""
    n_pos = max(float(stats.active_positions), 1.0)
    done = max(float(stats.completed), 1.0)
    return {
        "length": float(stats.completed_length_sum) / done,
        "score": float(stats.completed_score_sum) / done,
        "entropy": float(stats.policy_entropy_sum) / n_pos,
        "search_value": float(np.asarray(search_values).sum()) / n_pos,
        "completed": float(stats.completed),
    }


def test_sampled_self_play_matches_jax_in_distribution():
    games, t, runs = 48, 180, 3
    jcfg, tcfg, jnet, tnet = make_pair(
        hidden_size=32, num_simulations=8, search_max_depth=8, max_trajectory_length=t, num_parallel_games=games,
    )
    jax_runs, torch_runs, follows = [], [], {"jax": [], "torch": []}
    for run in range(runs):
        jstate = jenv.reset_batch(jnp.uint32(500 + run), games)
        tstate = tenv.reset_batch(500 + run, games, "cpu")
        _, jtraj, jstats = jsp.play_segment(
            jnet.params, jnet.apply_fns, jstate, jax.random.PRNGKey(run), jnp.float32(1.0), jcfg, games, False
        )
        _, ttraj, tstats = tsp.play_segment(tnet, tstate, torch.Generator().manual_seed(run), 1.0, tcfg, games, False)
        jax_runs.append(segment_stats(jtraj, jstats, jtraj.values))
        torch_runs.append(segment_stats(ttraj, tstats, ttraj.values))
        for name, traj in (("jax", jtraj), ("torch", ttraj)):
            pol = np.asarray(traj.policies)
            live = np.arange(t)[None] < np.asarray(traj.length)[:, None]
            follows[name].append(float((pol.argmax(-1) == np.asarray(traj.actions))[live].mean()))
    for key in ("length", "score", "entropy", "search_value"):
        j = np.array([r[key] for r in jax_runs])
        p = np.array([r[key] for r in torch_runs])
        sem = np.sqrt(j.var(ddof=1) / runs + p.var(ddof=1) / runs)
        assert abs(j.mean() - p.mean()) <= 4 * sem + 1e-6, f"{key}: JAX {j} port {p}"
    assert min(r["completed"] for r in jax_runs + torch_runs) >= games // 2, "most games end inside the segment"
    assert abs(np.mean(follows["jax"]) - np.mean(follows["torch"])) < 0.03, follows

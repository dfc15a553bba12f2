"""Categorical value representation of the PyTorch port vs the JAX package
(``ops/distributional.py``), on identical numpy inputs.

The two-hot bin indices must be identical; the atoms agree to one float32
unit in the last place (rtol 2e-7: ``jnp.linspace`` and ``i · step`` round
differently); two-hot masses, expectations and cross-entropies agree within
rtol 1e-5 (atol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.ops import distributional as jdist
from simulate_2048_tpu_torch.ops import distributional as tdist

SUPPORTS = [(16, 320.0), (8, 100.0), (256, 320.0), (128, 100.0)]


def scalars(support_max: float) -> np.ndarray:
    rs = np.random.RandomState(0)
    edge = np.array([0.0, -3.0, support_max, support_max * 1.5, support_max / 2], dtype=np.float32)
    return np.concatenate([edge, (rs.rand(59) * support_max * 1.1).astype(np.float32)])


@pytest.mark.parametrize("bins,support_max", SUPPORTS)
def test_support_atoms_match_jax(bins, support_max):
    got = tdist.support_atoms(bins, support_max).numpy()
    np.testing.assert_allclose(got, np.asarray(jdist.support_atoms(bins, support_max)), rtol=2e-7)
    assert got.dtype == np.float32 and got[0] == 0.0 and abs(got[-1] - support_max) <= 2e-7 * support_max


@pytest.mark.parametrize("bins,support_max", SUPPORTS)
def test_two_hot_matches_jax(bins, support_max):
    x = scalars(support_max)
    ref = np.asarray(jdist.two_hot(jnp.asarray(x), bins, support_max))
    got = tdist.two_hot(torch.from_numpy(x), bins, support_max).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)  # the same two bins
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    atoms = tdist.support_atoms(bins, support_max).numpy()
    np.testing.assert_allclose(got @ atoms, np.clip(x, 0.0, support_max), rtol=1e-4, atol=1e-3)
    batched = tdist.two_hot(torch.from_numpy(x).reshape(8, 8), bins, support_max)
    assert batched.shape == (8, 8, bins)


@pytest.mark.parametrize("bins,support_max", SUPPORTS)
def test_expectation_and_loss_match_jax(bins, support_max):
    rs = np.random.RandomState(1)
    logits = (rs.randn(64, bins) * 3).astype(np.float32)
    x = scalars(support_max)
    np.testing.assert_allclose(
        tdist.expectation(torch.from_numpy(logits), support_max).numpy(),
        np.asarray(jdist.expectation(jnp.asarray(logits), support_max)),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        tdist.categorical_loss(torch.from_numpy(logits), torch.from_numpy(x), support_max).numpy(),
        np.asarray(jdist.categorical_loss(jnp.asarray(logits), jnp.asarray(x), support_max)),
        rtol=1e-5,
        atol=1e-6,
    )

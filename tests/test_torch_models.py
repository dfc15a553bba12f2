"""PyTorch port vs the JAX package: the six networks on Flax weights
converted by ``convert.params_from_flax``, on identical numpy inputs.

Tolerances: float32 towers rtol/atol 1e-5 (matmul summation order only);
bfloat16 towers rtol 2e-2 with atol 2e-2 of the output scale (bf16 rounds at
other places in the two frameworks).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HIDDEN, BLOCKS, BATCH = 32, 2, 8


def build(use_bf16: bool, onehot: bool = False):
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS, use_bfloat16=use_bf16,
                  observation_onehot=onehot)
    jnet = create_network(
        jax.random.PRNGKey(0),
        hidden_size=HIDDEN,
        num_blocks=BLOCKS,
        compute_dtype=jnp.bfloat16 if use_bf16 else jnp.float32,
        observation_onehot=onehot,
    )
    tnet = params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)
    return jnet, tnet


def inputs():
    rs = np.random.RandomState(11)
    obs = (rs.randint(0, 12, size=(BATCH, 16)) / 16.0).astype(np.float32)
    hidden = rs.randn(BATCH, HIDDEN).astype(np.float32)
    action = np.eye(4, dtype=np.float32)[rs.randint(0, 4, size=BATCH)]
    chance = np.eye(32, dtype=np.float32)[rs.randint(0, 32, size=BATCH)]
    return obs, hidden, action, chance


def outputs(jnet, tnet):
    obs, hidden, action, chance = inputs()
    p, f = jnet.params, jnet.apply_fns
    jax_out = {
        "representation": f.representation(p.representation, obs),
        "prediction": f.prediction(p.prediction, hidden),
        "afterstate_dynamics": f.afterstate_dynamics(p.afterstate_dynamics, hidden, action),
        "afterstate_prediction": f.afterstate_prediction(p.afterstate_prediction, hidden),
        "dynamics": f.dynamics(p.dynamics, hidden, chance),
        "encoder": f.encoder(p.encoder, obs),
    }
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    with torch.no_grad():
        torch_out = {
            "representation": tnet.representation(t(obs)),
            "prediction": tnet.prediction(t(hidden)),
            "afterstate_dynamics": tnet.afterstate_dynamics(t(hidden), t(action)),
            "afterstate_prediction": tnet.afterstate_prediction(t(hidden)),
            "dynamics": tnet.dynamics(t(hidden), t(chance)),
            "encoder": tnet.encoder(t(obs)),
        }
    return jax_out, torch_out


def flat(x):
    return [x] if not isinstance(x, tuple) else list(x)


@pytest.mark.parametrize("onehot", [False, True])
def test_float32_networks_match_flax(onehot):
    jax_out, torch_out = outputs(*build(False, onehot))
    for name, j in jax_out.items():
        for jj, tt in zip(flat(j), flat(torch_out[name])):
            np.testing.assert_allclose(tt.float().numpy(), np.asarray(jj, np.float32), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_bfloat16_towers_match_flax():
    jax_out, torch_out = outputs(*build(True))
    for name, j in jax_out.items():
        for jj, tt in zip(flat(j), flat(torch_out[name])):
            ref = np.asarray(jj, np.float32)
            if name == "encoder":  # one-hot of an argmax: exact unless two logits tie within bf16 noise
                assert (tt.float().numpy().argmax(-1) == ref.argmax(-1)).mean() >= 0.75
                continue
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(tt.float().numpy(), ref, rtol=2e-2, atol=2e-2 * scale, err_msg=name)


def test_convert_rejects_shape_mismatch():
    jnet, _ = build(False)
    cfg = replace(TrainConfig(), hidden_size=2 * HIDDEN, num_residual_blocks=BLOCKS)
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


def test_categorical_heads_not_ported():
    """Categorical heads are ported (the name dates from when they raised):
    a fresh network has zero head weights and a bias of 0 on atom 0 and -14
    elsewhere, as the JAX package initialises them, so its expectation is
    about 0; scalar heads keep a LeCun-normal weight."""
    from simulate_2048_tpu_torch.models.network import network_from_config
    from simulate_2048_tpu_torch.ops.rng import prng_key

    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=1, value_bins=21, reward_bins=1)
    tnet = network_from_config(cfg, prng_key(0))
    jnet = create_network(jax.random.PRNGKey(0), hidden_size=HIDDEN, num_blocks=1, value_bins=21)
    for head, jtree in ((tnet.prediction.value, jnet.params.prediction), (tnet.afterstate_prediction.q_value,
                                                                            jnet.params.afterstate_prediction)):
        name = "value" if head is tnet.prediction.value else "q_value"
        np.testing.assert_array_equal(head.weight.detach().numpy().T, np.asarray(jtree["params"][name]["kernel"]))
        np.testing.assert_array_equal(head.bias.detach().numpy(), np.asarray(jtree["params"][name]["bias"]))
    assert tnet.dynamics.reward.weight.shape == (1, HIDDEN)
    assert float(tnet.dynamics.reward.weight.detach().abs().max()) > 0
    hidden = np.random.RandomState(1).randn(4, HIDDEN).astype(np.float32)
    with torch.no_grad():
        _, value = tnet.prediction(torch.from_numpy(hidden))
    _, jvalue = jnet.apply_fns.prediction(jnet.params.prediction, hidden)
    assert value.shape == (4,) and float(value.abs().max()) < 1e-2  # 20 atoms at e^-14 of the mass each
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=1e-5)


def perturbed_categorical(value_bins: int, reward_bins: int):
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=BLOCKS, value_bins=value_bins,
                  reward_bins=reward_bins, value_support_max=300.0, reward_support_max=90.0)
    jnet = create_network(jax.random.PRNGKey(3), hidden_size=HIDDEN, num_blocks=BLOCKS, value_bins=value_bins,
                          reward_bins=reward_bins, value_support_max=300.0, reward_support_max=90.0)
    params = jax.tree.map(np.array, jax.device_get(jnet.params))
    rs = np.random.RandomState(5)
    for tree, name in ((params.prediction, "value"), (params.afterstate_prediction, "q_value"),
                       (params.dynamics, "reward")):
        kernel = tree["params"][name]["kernel"]
        tree["params"][name]["kernel"] = kernel + 0.3 * rs.standard_normal(kernel.shape).astype(np.float32)
    jnet = jnet._replace(params=params)
    return jnet, params_from_flax(params, cfg)


@pytest.mark.parametrize("bins", [(16, 8), (16, 1), (1, 8)], ids=["categorical", "value_only", "reward_only"])
def test_categorical_networks_match_flax(bins):
    """Scalar-facing forwards (the support expectation) and the raw-logit
    forwards the losses use, rtol/atol 1e-5 (expectations: rtol 1e-5 of a
    value up to the support's maximum)."""
    jnet, tnet = perturbed_categorical(*bins)
    jax_out, torch_out = outputs(jnet, tnet)
    for name, j in jax_out.items():
        for jj, tt in zip(flat(j), flat(torch_out[name])):
            assert tuple(tt.shape) == tuple(jj.shape), name
            np.testing.assert_allclose(tt.float().numpy(), np.asarray(jj, np.float32), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    _, hidden, _, chance = inputs()
    p, f = jnet.params, jnet.apply_fns
    t = torch.from_numpy
    pairs = []
    with torch.no_grad():
        if bins[0] > 1:
            pairs.append((f.prediction_logits(p.prediction, hidden), tnet.prediction.logits(t(hidden))))
            pairs.append((f.afterstate_prediction_logits(p.afterstate_prediction, hidden),
                          tnet.afterstate_prediction.logits(t(hidden))))
        else:
            assert f.prediction_logits is None
            assert torch.equal(tnet.prediction.logits(t(hidden))[1], tnet.prediction(t(hidden))[1])
        if bins[1] > 1:
            pairs.append((f.dynamics_logits(p.dynamics, hidden, chance), tnet.dynamics.logits(t(hidden), t(chance))))
    for j, tt in pairs:
        for jj, ttt in zip(j, tt):
            assert tuple(ttt.shape) == tuple(jj.shape)
            np.testing.assert_allclose(ttt.numpy(), np.asarray(jj), rtol=1e-5, atol=1e-5)

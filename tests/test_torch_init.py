"""The port's initial weights are the JAX package's: ``jax.random``'s key
functions in ``ops/rng.py`` against JAX's (bit for bit; the truncated normal
within 2e-6), Flax's per-module key (``fold_in_path``) against the keys Flax
hands to an initializer, ``network_from_config`` against Flax's network of
the same key (every kernel within 2e-6 of its layer's std; zeros, ones and
the categorical heads' biases exact), both packages' ``Trainer`` inits, and
every site that builds a fresh network against its JAX counterpart's key.

The draw reproduces JAX's partitionable Threefry (``jax_threefry_partitionable``)
and Flax without the rng separator (``flax_fix_rng_separator``), as set here.
"""

import dataclasses
import socket

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import learner as jlearner
from simulate_2048_tpu.training import trainer as jtrainer
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.models.blocks import Dense
from simulate_2048_tpu_torch.models.muzero import CategoricalHead
from simulate_2048_tpu_torch.models.network import MuZeroNetwork, network_from_config
from simulate_2048_tpu_torch.ops import rng
from simulate_2048_tpu_torch.scripts import recipes
from simulate_2048_tpu_torch.training import config as tconfig
from simulate_2048_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)

KERNEL_RTOL = 2e-6  # of the layer's std, per element
NORMAL_ATOL = 2e-6  # truncated_normal against JAX's, per element
SEEDS = (0, 42, 44)


def jax_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_the_settings_the_draw_reproduces():
    assert jax.config.jax_threefry_partitionable
    assert not flax.config.flax_fix_rng_separator


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 3, 2**32 + 7])
def test_prng_key(seed):
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(), jax_words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [2, 6])
@pytest.mark.parametrize("seed", [0, 42])
def test_split(seed, n):
    got = rng.split(rng.prng_key(seed), n).numpy()
    np.testing.assert_array_equal(got, jax_words(jax.random.split(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("data", [0, 1, 0x6B1E, 0xDEADBEEF, 0xFFFFFFFF])
def test_fold_in(data):
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    got = rng.fold_in(torch.from_numpy(jax_words(key)), data).numpy()
    np.testing.assert_array_equal(got, jax_words(jax.random.fold_in(key, jnp.uint32(data))))


@pytest.mark.parametrize("shape", [(1,), (3, 5, 7), (257, 300), (70001,)])
def test_random_bits(shape):
    got = rng.random_bits(rng.prng_key(42), shape).numpy()
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(42), shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 1.7), (-0.9544997, 0.9544997)])
def test_uniform(lo, hi):
    got = rng.uniform(rng.prng_key(3), (129, 77), lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (129, 77), jnp.float32, lo, hi))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(5,), (16, 128), (256, 256), (70001,)])
@pytest.mark.parametrize("seed", [0, 42])
def test_truncated_normal(seed, shape):
    got = rng.truncated_normal(rng.prng_key(seed), -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2, shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    assert got.min() > -2.0 and got.max() < 2.0


class _Recorder:
    """A Flax initializer that stores the key it is handed, then returns zeros."""

    def __init__(self):
        self.keys = []

    def __call__(self, key, shape, dtype=jnp.float32):
        self.keys.append(jax_words(key))
        return jnp.zeros(shape, dtype)


@pytest.mark.parametrize("depth", [1, 2])
def test_fold_in_path_is_flax_key(depth):
    kernels, biases = _Recorder(), _Recorder()

    class Inner(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Dense(3, kernel_init=kernels, bias_init=biases)(x)
            return fnn.Dense(2, kernel_init=kernels, bias_init=biases, name="head")(x)

    class Outer(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return Inner()(fnn.Dense(4, kernel_init=kernels, bias_init=biases)(x))

    key = jax.random.split(jax.random.PRNGKey(11), 6)[4]
    (Inner() if depth == 1 else Outer()).init(key, jnp.zeros((1, 5)))
    prefix = () if depth == 1 else ("Inner_0",)
    paths = [prefix + ("Dense_0",), prefix + ("head",)]
    if depth == 2:
        paths.insert(0, ("Dense_0",))
    tkey = torch.from_numpy(jax_words(key))
    for path, kernel_key, bias_key in zip(paths, kernels.keys, biases.keys, strict=True):
        np.testing.assert_array_equal(rng.fold_in_path(tkey, path, 1).numpy(), kernel_key)
        np.testing.assert_array_equal(rng.fold_in_path(tkey, path, 2).numpy(), bias_key)


def assert_same_init(port: MuZeroNetwork, want: MuZeroNetwork) -> None:
    """Every drawn kernel within KERNEL_RTOL of its layer's std; biases,
    LayerNorm scales and the categorical heads exactly."""
    layers = dict(port.named_modules())
    for (name, got), (want_name, ref) in zip(port.named_parameters(), want.named_parameters(), strict=True):
        assert name == want_name
        layer = layers[name.rsplit(".", 1)[0]]
        got, ref = got.detach().cpu(), ref.detach().cpu()
        assert got.dtype == torch.float32 and got.shape == ref.shape, name
        if name.endswith(".weight") and isinstance(layer, Dense) and not isinstance(layer, CategoricalHead):
            std = np.sqrt(1.0 / layer.in_features) / 0.87962566103423978
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=KERNEL_RTOL * std, err_msg=name)
            assert float(got.abs().max()) > 0, name
        else:
            np.testing.assert_array_equal(got.numpy(), ref.numpy(), err_msg=name)


def flax_network(config: tconfig.TrainConfig, key) -> MuZeroNetwork:
    jcfg = jconfig.TrainConfig(**dataclasses.asdict(config))
    state, _ = jlearner.create_train_state(key, jcfg)
    return params_from_flax(jax.tree.map(np.asarray, state.params), config)


CONFIGS = {
    "scalar_recipe": lambda: recipes.recipe_config("run_scalar60k_arm.sh"),
    "categorical_recipe": lambda: recipes.recipe_config("run_cat60k_twin.sh"),
    "default_bf16": tconfig.default_config,
    "onehot": lambda: dataclasses.replace(tconfig.tiny_config(), observation_onehot=True),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_network_from_config_is_flax_init(name, seed):
    config = CONFIGS[name]()
    if name == "default_bf16":
        assert config.use_bfloat16 and config.hidden_size == 256 and config.num_residual_blocks == 10
    if name == "categorical_recipe":
        assert (config.value_bins, config.reward_bins) == (256, 128)
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    port = network_from_config(config, rng.split(rng.prng_key(seed))[1])
    if name == "onehot":
        assert port.representation.trunk.proj.in_features == 256
    assert_same_init(port, flax_network(config, key))


def test_building_a_network_draws_nothing_from_torch():
    """Construction allocates without drawing; the init reads its key alone."""
    before = torch.get_rng_state()
    network_from_config(tconfig.tiny_config(), rng.prng_key(1))
    assert torch.equal(torch.get_rng_state(), before)
    fresh = MuZeroNetwork(hidden_size=16, num_blocks=1, value_bins=8, reward_bins=4)
    assert torch.equal(torch.get_rng_state(), before)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, torch.ones_like(p) if name.endswith(("norm1.weight", "norm2.weight", "norm.weight"))
                           else torch.zeros_like(p)), name  # fmt: skip


@pytest.mark.parametrize("seed", [0, 42])
def test_trainer_init_is_jax_trainer_init(seed):
    config = dataclasses.replace(tconfig.tiny_config(), hidden_size=32, num_residual_blocks=2, value_bins=16,
                                 reward_bins=8)  # fmt: skip
    jax_trainer = jtrainer.Trainer(jconfig.TrainConfig(**dataclasses.asdict(config)), seed=seed)
    jax_trainer.initialize()
    port_trainer = ttrainer.Trainer(config, seed=seed, device="cpu")
    port_trainer.initialize()
    assert_same_init(port_trainer.network, params_from_flax(jax.tree.map(np.asarray, jax_trainer.state.params), config))
    chip_smoke.check_trainer_init(config, seed, [p.detach().clone() for p in port_trainer.network.parameters()])


# The float32 kernel's search 141 of chip_smoke.py's check at the preset
# (H=256, 10 blocks, 100 simulations), JAX's init of chip_smoke.SEED, on an
# NVIDIA H100: root visits equal to the plain version's, root Q of action 3
# and the root value 0.465 and 0.456 away.
KERNEL_SEARCH_141 = ([1.0, 0.0, 0.0, 99.0], [19.834877014160156, 0.0, 0.0, 321.3943786621094], 317.0799255371094)


def test_chip_smoke_near_tie_reproduces_the_kernels_search(monkeypatch):
    """The plain version itself gives the kernel's search 141 on the pack
    moved by at most 2 ulp (a near tie below the root), and no such run
    gives an answer 5 away in one Q."""
    config, cfg, network, packed, roots = chip_smoke.full_width_inputs(torch.device("cpu"), batch=256)
    root = tuple(r[141:142].contiguous() for r in roots)
    visits, q, value = (torch.tensor(x) for x in KERNEL_SEARCH_141)
    plain = chip_smoke.sk.whole_search_reference(*root, packed, cfg)
    assert torch.equal(plain[0][0], visits) and float((plain[1][0] - q).abs().max()) > 0.4
    assert chip_smoke.near_tie(root, packed, cfg, (visits, q, value), 1e-4, 1e-3) is not None
    monkeypatch.setattr(chip_smoke, "NEAR_TIE_TRIALS", 3)
    wrong = (visits, q + torch.tensor([0.0, 0.0, 0.0, 5.0]), value)
    assert chip_smoke.near_tie(root, packed, cfg, wrong, 1e-4, 1e-3) is None


def test_chip_smoke_constant_value():
    """A fresh categorical value head (zero weights) gives one value on every
    board, the case in which model_probe's value_corr is NaN; a drawn head
    does not."""
    config = recipes.recipe_config(chip_smoke.RECIPE)
    network = network_from_config(config, rng.split(rng.prng_key(chip_smoke.SEED))[1])
    constant = chip_smoke.constant_value(network, config, torch.device("cpu"))
    assert constant is not None and 0 < constant < 1
    with torch.no_grad():
        network.prediction.value.weight.normal_(generator=torch.Generator().manual_seed(0))
    assert chip_smoke.constant_value(network, config, torch.device("cpu")) is None


class _Built(Exception):
    """Raised by the recording init once a call site has built its network."""


@pytest.fixture
def built(monkeypatch):
    """Each fresh network's (network, key), the call aborted right after its init."""
    record = []
    init = MuZeroNetwork.init_weights

    def recording(self, key):
        record.append((init(self, key), key.clone()))
        raise _Built

    monkeypatch.setattr(MuZeroNetwork, "init_weights", recording)
    return record


def tiny_port_config(**fields) -> tconfig.TrainConfig:
    return dataclasses.replace(tconfig.tiny_config(), hidden_size=16, num_residual_blocks=1, **fields)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _evaluate():
    from simulate_2048_tpu_torch import evaluate

    evaluate.main(["--mode", "tiny", "--games", "1", "--seed", "5", "--device", "cpu"])


def _actor():
    from simulate_2048_tpu_torch.parallel.actor_learner import ActorClient

    ActorClient(tiny_port_config(), ("localhost", free_port()), seed=3, device="cpu")


def _benchmark_training():
    from simulate_2048_tpu_torch.scripts import benchmark_training

    benchmark_training.benchmark("tiny", steps=1, device="cpu")


def _benchmark_mcts():
    from simulate_2048_tpu_torch.scripts import benchmark_mcts

    benchmark_mcts.setup(4, 2, "tiny", None, 16, 1, 1, 1, torch.device("cpu"))


def _benchmark_scaling():
    from simulate_2048_tpu_torch.scripts import benchmark_scaling

    benchmark_scaling.benchmark(virtual=1, envs_per_device=4, steps=2, batch_per_device=4, device="cpu")


def _diagnosis():
    from simulate_2048_tpu_torch.scripts import diagnosis

    diagnosis.template(tiny_port_config(value_bins=16, reward_bins=8), torch.device("cpu"))


def _multihost_demo():
    import torch.distributed as dist

    from simulate_2048_tpu_torch.scripts import multihost_demo

    try:
        multihost_demo.run(f"localhost:{free_port()}", 1, 0, steps=1, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _warm_compile():
    from simulate_2048_tpu_torch.scripts import warm_compile

    warm_compile.warm("scalar60k", torch.device("cpu"))


# Each site that builds a fresh network, and the seed of its JAX counterpart's
# PRNGKey: evaluate.py:75 (--seed), actor_learner.py:388 and scripts/*.py (0).
CALL_SITES = {
    "evaluate": (_evaluate, 5),
    "actor_learner": (_actor, 0),
    "benchmark_training": (_benchmark_training, 0),
    "benchmark_mcts": (_benchmark_mcts, 0),
    "benchmark_scaling": (_benchmark_scaling, 0),
    "diagnosis": (_diagnosis, 0),
    "multihost_demo": (_multihost_demo, 0),
    "warm_compile": (_warm_compile, 0),
}


@pytest.mark.parametrize("site", list(CALL_SITES))
def test_call_site_draws_jax_counterparts_weights(site, built):
    call, seed = CALL_SITES[site]
    with pytest.raises(_Built):
        call()
    (network, key), = built
    np.testing.assert_array_equal(key.numpy(), jax_words(jax.random.PRNGKey(seed)))
    config = dataclasses.replace(
        tconfig.TrainConfig(), observation_dim=network.observation_dim, action_size=network.action_size,
        codebook_size=network.codebook_size, hidden_size=network.hidden_size, num_residual_blocks=network.num_blocks,
        observation_onehot=network.representation.onehot_input, value_bins=network.value_bins,
        reward_bins=network.reward_bins,
    )  # fmt: skip
    assert_same_init(network, flax_network(config, jax.random.PRNGKey(seed)))

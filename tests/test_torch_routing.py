"""Which search a self-play segment, an evaluation or a reanalyze pass runs
(``self_play._use_kernel``), against the JAX package's dispatch
(``simulate_2048_tpu/training/self_play.py:150-171``): the kernel's scope is
``pallas_search._in_scope`` (PUCT root, argmax chance, no widening; its
batch condition is the TPU kernel's lane width, which the CUDA kernel does
not have). "auto" takes the kernel on CUDA inside the scope and the plain
search outside it; "pallas" raises outside it. The same holds for the
CUDA kernel's own limits (``search_kernel.kernel_limits``: widths, child
slots, bins): JAX's "auto" takes its kernel where ``pallas_search_plan``
returns a plan, the port's where ``kernel_limits`` takes the config, and
the two differ where the TPU's limits and the H100's do; on the CPU
"pallas" runs the plain version at any shape. A ``torch.device("cuda")``
object needs no GPU.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import self_play as jsp
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.training.config import tiny_config
from simulate_2048_tpu_torch.training.self_play import _use_kernel, search_config_from

CUDA = torch.device("cuda")
SETTINGS = {
    "in scope": {},
    "Gumbel root": dict(root_selection="gumbel"),
    "sampled chance": dict(chance_selection="sample"),
    "widening": dict(pw_c=1.0),
}


def jax_in_scope(overrides: dict, eval_mode: bool = False) -> bool:
    config = dataclasses.replace(jconfig.tiny_config(), **overrides)
    return jps._in_scope(jsp.search_config_from(config, eval_mode), jps.BLOCK_G)


@pytest.mark.parametrize("setting", SETTINGS)
def test_auto_takes_the_kernel_on_cuda_only_in_scope(setting):
    config = dataclasses.replace(tiny_config(), search_backend="auto", **SETTINGS[setting])
    cfg = search_config_from(config)
    assert _use_kernel(config, cfg, CUDA) == jax_in_scope(SETTINGS[setting]) == (setting == "in scope")
    assert not _use_kernel(config, cfg, torch.device("cpu"))


@pytest.mark.parametrize("setting", SETTINGS)
def test_pallas_raises_out_of_scope(setting):
    # The search config carries the setting; TrainConfig itself refuses "pallas" with the Gumbel root.
    config = dataclasses.replace(tiny_config(), search_backend="pallas")
    cfg = search_config_from(dataclasses.replace(tiny_config(), **SETTINGS[setting]))
    if setting == "in scope":
        assert _use_kernel(config, cfg, CUDA) and _use_kernel(config, cfg, torch.device("cpu"))
        return
    with pytest.raises(ValueError, match="outside the kernel's scope"):
        _use_kernel(config, cfg, CUDA)


def test_evaluation_of_a_gumbel_config_takes_the_kernel():
    # Evaluation searches use the PUCT root, so they are in the kernel's scope in both packages.
    config = dataclasses.replace(tiny_config(), search_backend="auto", root_selection="gumbel")
    assert _use_kernel(config, search_config_from(config, eval_mode=True), CUDA)
    assert jax_in_scope(dict(search_backend="auto", root_selection="gumbel"), eval_mode=True)


def test_xla_never_takes_the_kernel():
    config = dataclasses.replace(tiny_config(), search_backend="xla")
    assert not _use_kernel(config, search_config_from(config), CUDA)


# Shapes inside the scope that the CUDA kernel refuses (kernel_limits), with JAX's plan for each on the TPU (its
# tiny config: H=64, 2 blocks, 128 searches): the TPU kernel takes them all, resident (0) or streamed (a chunk).
LIMITS = {
    "H=48": (dict(hidden_size=48), 0),
    "H=1024 float32": (dict(hidden_size=1024), 4),
    "H=1024 bfloat16": (dict(hidden_size=1024, search_weight_dtype="bfloat16"), 8),
    "bins > MAX_BINS": (dict(value_bins=sk.MAX_BINS + 89), 0),
    "K > 32": (dict(codebook_size=48), 0),
}


def jax_plan(overrides: dict):
    config = dataclasses.replace(jconfig.tiny_config(), **overrides)
    wdtype = jnp.bfloat16 if config.search_weight_dtype == "bfloat16" else jnp.float32
    cfg = jsp.search_config_from(config)
    return jps.pallas_search_plan(cfg, config.hidden_size, config.num_residual_blocks, jps.BLOCK_G, wdtype)


@pytest.mark.parametrize("case", LIMITS)
def test_auto_takes_the_plain_search_outside_the_kernels_limits(case):
    overrides, jax_decision = LIMITS[case]
    config = dataclasses.replace(tiny_config(), search_backend="auto", **overrides)
    cfg = search_config_from(config)
    dtype = torch.bfloat16 if config.search_weight_dtype == "bfloat16" else torch.float32
    assert sk.kernel_limits(cfg, config.hidden_size, dtype) is not None
    assert not _use_kernel(config, cfg, CUDA)
    assert not _use_kernel(config, cfg, torch.device("cpu"))
    # JAX's "auto" on a TPU takes its kernel here: its plan is resident (0) or streamed (> 0), not None.
    assert jax_plan(overrides) == jax_decision


@pytest.mark.parametrize("case", LIMITS)
def test_pallas_raises_on_cuda_outside_the_kernels_limits(case):
    overrides, jax_decision = LIMITS[case]
    config = dataclasses.replace(tiny_config(), search_backend="pallas", **overrides)
    cfg = search_config_from(config)
    with pytest.raises(ValueError, match="search_backend='pallas' but the kernel takes"):
        _use_kernel(config, cfg, CUDA)
    # On the CPU the wrapper runs its plain version, which takes any shape.
    assert _use_kernel(config, cfg, torch.device("cpu"))
    assert jax_plan(overrides) is not None


@pytest.mark.parametrize("hidden", [32, 64, 96, 256, 288, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_takes_the_kernel_within_its_limits(hidden, dtype):
    config = dataclasses.replace(tiny_config(), search_backend="auto", hidden_size=hidden, search_weight_dtype=dtype)
    cfg = search_config_from(config)
    assert _use_kernel(config, cfg, CUDA) and not _use_kernel(config, cfg, torch.device("cpu"))
    assert jax_plan(dict(hidden_size=hidden, search_weight_dtype=dtype)) is not None

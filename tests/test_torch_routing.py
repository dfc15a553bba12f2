"""Which search a self-play segment, an evaluation or a reanalyze pass runs
(``self_play._use_kernel``), against the JAX package's dispatch
(``simulate_2048_tpu/training/self_play.py:150-171``): the kernel's scope is
``pallas_search._in_scope`` (PUCT root, argmax chance, no widening; its
batch condition is the TPU kernel's lane width, which the CUDA kernel does
not have). "auto" takes the kernel on CUDA inside the scope and the plain
search outside it; "pallas" raises outside it. A ``torch.device("cuda")``
object needs no GPU.
"""

import dataclasses

import pytest
import torch

from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu.training import config as jconfig
from simulate_2048_tpu.training import self_play as jsp
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

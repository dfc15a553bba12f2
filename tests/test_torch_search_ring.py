"""The float32 resident kernel's ring of weight tiles: what of it runs on the CPU.

The kernel (``csrc/whole_search.cu``, ``Ring``) copies a resident pack's
``hh`` layers into shared memory in the order one expansion calls them,
``call_order(NB)``, and launches one block per two searches. These
tests hold the Python side of both against the plain version and the JAX
package:

- ``call_order(NB)`` is the order in which the plain version
  (``packed_transitions``) reads the pack's layers;
- a streamed pack, the port's and the JAX package's, holds
  ``resident.hh[call_order(NB)]`` element for element, then zero padding;
- ``kernel_blocks`` gives every search a block, and no block only dummies.

The kernel itself is held against the plain version, and bit for bit against
the streamed float32 kernel, on the card by ``chip_smoke.py``.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from simulate_2048_tpu.models.network import create_network
from simulate_2048_tpu.ops import pallas_search as jps
from simulate_2048_tpu_torch.convert import params_from_flax
from simulate_2048_tpu_torch.ops import search_kernel as sk
from simulate_2048_tpu_torch.search.mcts import SearchConfig
from simulate_2048_tpu_torch.training.config import TrainConfig

torch.set_num_threads(1)

HIDDEN, WIDTH = 32, 32


def nets(num_blocks: int):
    """(JAX network, port network) with the same weights, ``num_blocks`` blocks a tower."""
    jnet = create_network(jax.random.PRNGKey(num_blocks), hidden_size=HIDDEN, num_blocks=num_blocks)
    cfg = replace(TrainConfig(), hidden_size=HIDDEN, num_residual_blocks=num_blocks)
    return jnet, params_from_flax(jax.tree.map(np.asarray, jnet.params), cfg)


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_call_order_is_the_plain_versions_order(num_blocks, monkeypatch):
    _, tnet = nets(num_blocks)
    packed = sk.pack_search_params(tnet, num_blocks, WIDTH)
    read = []
    pack_layer = sk.pack_layer

    def recording(packed_hh, ihh, nb, streamed):
        read.append(ihh)
        return pack_layer(packed_hh, ihh, nb, streamed)

    monkeypatch.setattr(sk, "pack_layer", recording)
    transitions = sk.packed_transitions(packed, SearchConfig(num_simulations=4))
    rs = np.random.RandomState(num_blocks)
    parent = torch.from_numpy(rs.randn(3, HIDDEN).astype(np.float32))
    transitions(parent, torch.tensor([0, 5, 31]))
    order = sk.call_order(num_blocks)
    assert read == order
    assert sorted(order) == list(range(4 * (1 + 2 * num_blocks) + 4))


@pytest.mark.parametrize("num_blocks", [1, 2, 10])
def test_streamed_pack_is_resident_pack_in_call_order(num_blocks):
    jnet, tnet = nets(num_blocks)
    resident = sk.pack_search_params(tnet, num_blocks, WIDTH)
    chunk = sk.STREAM_CHUNK
    streamed = sk.pack_search_params(tnet, num_blocks, WIDTH, stream_chunk=chunk)
    jax_streamed = np.asarray(jps.pack_search_params(jnet.params, num_blocks, WIDTH, stream_chunk=chunk)[0])
    order = sk.call_order(num_blocks)
    n_real = len(order)
    assert streamed.hh.shape[0] == n_real + (-n_real % chunk)
    assert torch.equal(streamed.hh[:n_real], resident.hh[order])
    assert not streamed.hh[n_real:].any()
    np.testing.assert_array_equal(streamed.hh.numpy(), jax_streamed)
    for ihh in range(n_real):  # the plain version finds each pack-order layer in either layout
        assert torch.equal(sk.pack_layer(streamed.hh, ihh, num_blocks, True), resident.hh[ihh])


@pytest.mark.parametrize("batch", [1, 127, 128, 256, 1023])
def test_kernel_blocks_gives_every_search_a_block(batch):
    g = sk.SEARCHES_PER_BLOCK["whole_search"]
    blocks = sk.kernel_blocks(batch)
    assert blocks * g >= batch  # every search has a block
    assert (blocks - 1) * g < batch  # and no block holds only dummy searches
    assert blocks == {1: 1, 127: 64, 128: 64, 256: 128, 1023: 512}[batch]

"""Ring all-reduce of the PyTorch port vs the JAX package, on the CPU.

The JAX ring runs its Pallas kernel in TPU interpret mode on the
8-virtual-device CPU mesh (as ``tests/test_ring.py`` runs it); the port's
wrapper runs its plain version for CPU shards, which adds in the kernel's
rotation order: rank i gets ``((x_i + x_{i-1}) + x_{i-2}) + ...``. Both add
the same float32 numbers in the same order, so they agree bit for bit.
Against the sums in PyTorch's and XLA's own order (``psum_reference``) the
ring agrees within rtol 1e-5 / atol 1e-5, the tolerance of
``tests/test_ring.py``. Inputs are made with numpy from a seed.
"""

import jax
import numpy as np
import pytest
import torch

from simulate_2048_tpu.parallel import ring as jring
from simulate_2048_tpu_torch.parallel import ring
from simulate_2048_tpu_torch.parallel.mesh import make_mesh

N = 8


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= N, "conftest should provide 8 virtual CPU devices"
    return jax.make_mesh((N,), ("data",))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh([torch.device("cpu")] * N)


def random_shards(seed: int, rows: int = 8, cols: int = 128) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((N * rows, cols)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_ring_equals_jax_ring_bit_for_bit(jax_mesh, mesh, seed):
    x = random_shards(seed)
    want = np.asarray(jring.ring_all_reduce(jax.numpy.asarray(x), jax_mesh, interpret=True))
    got = ring.ring_all_reduce(torch.from_numpy(x), mesh).numpy()
    np.testing.assert_array_equal(got, want)
    # Rank 0 adds in another order than rank 1: the blocks need not be equal to each other.
    np.testing.assert_array_equal(got[:8], (((((((x[:8] + x[56:]) + x[48:56]) + x[40:48]) + x[32:40]) + x[24:32]) +
                                             x[16:24]) + x[8:16]))  # fmt: skip


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_plain_ring_equals_jax_ring_bit_for_bit_in_half_types(jax_mesh, mesh, dtype):
    # JAX's ring works in the shard's dtype, rounding after every add; so do the port's plain version and kernel.
    x = random_shards(3)
    want = jring.ring_all_reduce(jax.numpy.asarray(x, dtype=getattr(jax.numpy, dtype)), jax_mesh, interpret=True)
    got = ring.ring_all_reduce(torch.from_numpy(x).to(getattr(torch, dtype)), mesh)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jax.numpy.float32)))


def test_ring_matches_psum(jax_mesh, mesh):
    x = random_shards(2)
    got = ring.ring_all_reduce(torch.from_numpy(x), mesh)
    np.testing.assert_allclose(got.numpy(), ring.psum_reference(torch.from_numpy(x), mesh).numpy(), rtol=1e-5,
                               atol=1e-5)  # fmt: skip
    jax_psum = np.asarray(jring.psum_reference(jax.numpy.asarray(x), jax_mesh))
    np.testing.assert_allclose(got.numpy(), jax_psum, rtol=1e-5, atol=1e-5)


def test_gradient_shaped_shards(mesh):
    # tests/test_ring.py:40-47: a (padded) gradient-like shard per device, the sum replicated everywhere.
    x = torch.arange(N * 8 * 256, dtype=torch.float32).reshape(N * 8, 256) / 1e3
    got = ring.ring_all_reduce(x, mesh).numpy()
    want = x.numpy().reshape(N, 8, 256).sum(0)
    for d in range(N):
        np.testing.assert_allclose(got[d * 8 : (d + 1) * 8], want, rtol=1e-6)


@pytest.mark.parametrize("ranks", [2, 3, 5])
def test_shard_wrapper_on_cpu_is_the_rotation_order(ranks):
    rs = np.random.RandomState(ranks)
    shards = [torch.from_numpy(rs.standard_normal(1001).astype(np.float32)) for _ in range(ranks)]
    launches = ring.LAUNCHES["ring_all_reduce"]
    got = ring.ring_all_reduce_shard(shards)
    for i, out in enumerate(got):
        want = shards[i].clone()
        for step in range(ranks - 1):
            want = want + shards[(i - 1 - step) % ranks]
        assert torch.equal(out, want)
    assert ring.LAUNCHES["ring_all_reduce"] == launches, "the plain version counts no launch"


def test_shard_wrapper_on_cpu_takes_any_dtype():
    # Only the CUDA kernel is limited to float32, bfloat16 and float16; the CPU path sums float64 in rotation order.
    rs = np.random.RandomState(4)
    shards = [torch.from_numpy(rs.standard_normal(257)) for _ in range(3)]
    got = ring.ring_all_reduce_shard(shards)
    for i, out in enumerate(got):
        assert out.dtype == torch.float64
        assert torch.equal(out, (shards[i] + shards[(i - 1) % 3]) + shards[(i - 2) % 3])


def test_one_rank_returns_its_input():
    x = torch.randn(17, generator=torch.Generator().manual_seed(0))
    (out,) = ring.ring_all_reduce_shard([x])
    assert out is x
    one = make_mesh([torch.device("cpu")])
    assert torch.equal(ring.ring_all_reduce(x[:16].reshape(4, 4), one), x[:16].reshape(4, 4))


def test_wrapper_checks_its_inputs():
    meta = [torch.empty(8, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ring.ring_all_reduce_shard(meta)
    with pytest.raises(ValueError, match="one shape"):
        ring.ring_all_reduce_shard([torch.zeros(3), torch.zeros(4)])
    with pytest.raises(ValueError, match="does not split"):
        ring.ring_all_reduce(torch.zeros(7, 2), make_mesh([torch.device("cpu")] * 2))

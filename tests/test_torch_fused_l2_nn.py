"""Parity of the port's fused L2 nearest neighbour (raft_tpu_torch) with
the JAX package's (the Pallas ``_nn_kernel`` in interpret mode).

Inputs are made with numpy from a seed and fed to both packages; the
port runs its plain version (CPU tensors). Tolerance: ids identical,
distances within rtol 1e-5 / atol 1e-5 (both fp32, different summation
order); integer-valued tie cases must agree exactly.
"""

import numpy as np
import pytest
import torch

from raft_tpu.distance import fused_l2_nn as jax_fused_l2_nn
from raft_tpu_torch.distance import fused_l2_nn
from raft_tpu_torch.ops import fused_l2_nn as op


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _both(x, y, sqrt):
    kj = jax_fused_l2_nn(x, y, sqrt=sqrt)
    kt = fused_l2_nn(torch.from_numpy(x), torch.from_numpy(y), sqrt=sqrt)
    return (np.asarray(kj.key), np.asarray(kj.value), kt.key.numpy(),
            kt.value.numpy())


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("m,n,d", [(64, 16, 32), (37, 23, 8), (5, 130, 3)])
def test_matches_jax(sqrt, m, n, d):
    rng = np.random.default_rng(1000 * m + n + d)
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    ij, dj, it, dt = _both(x, y, sqrt)
    assert it.dtype == np.int32 and dt.dtype == np.float32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sqrt", [False, True])
def test_ties_go_to_lowest_index_exactly(sqrt):
    # integer-valued data: every distance is exact in fp32, and y holds
    # duplicated rows, so most rows of x see tied minima
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(6, 4)).astype(np.float32)
    y = np.concatenate([base, base[::-1], base]).astype(np.float32)
    x = rng.integers(-3, 4, size=(41, 4)).astype(np.float32)
    ij, dj, it, dt = _both(x, y, sqrt)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    full = ((x[:, None, :] - y[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(it, np.argmin(full, axis=1))


def test_ragged_shapes_not_tile_multiples():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(129, 17)).astype(np.float32)
    y = rng.normal(size=(65, 17)).astype(np.float32)
    ij, dj, it, dt = _both(x, y, False)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    before = op.launches
    idx, dist = op.fused_l2_nn(x, x)
    assert op.launches == before
    np.testing.assert_array_equal(idx.numpy(), np.arange(8))
    np.testing.assert_allclose(dist.numpy(), 0.0, atol=1e-5)


def test_cuda_entry_refuses_cpu_tensors():
    x = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        op.fused_l2_nn_cuda(x, x)

"""Parity of the port's fused L2 nearest neighbour (raft_tpu_torch) with
the JAX package's (the Pallas ``_nn_kernel`` in interpret mode).

Inputs are made with numpy from a seed and fed to both packages; the
port runs its plain version (CPU tensors). Tolerance: ids identical,
distances within rtol 1e-5 / atol 1e-5 (both fp32, different summation
order); integer-valued tie cases must agree exactly. The card's bf16x3
and bf16 tiers are held to the reference's own arithmetic run in JAX on
the CPU (the interpret-mode kernel computes every tier at ``HIGHEST``):
ids identical, distances within 1e-6 of |x|^2 + |y|^2 (the same exact
partial products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance import fused_l2_nn as jax_fused_l2_nn
from raft_tpu.ops._util import dot_nt_f32
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


def _reference_tier(x, y, sqrt, tier):
    """``_nn_kernel``'s arithmetic at a card tier, in JAX: d = max((|y|^2
    + |x|^2) - 2 dot, 0) with ``dot_nt_f32(y, x, "bf16x3")`` or, for
    bf16, one ``dot_general`` of bf16-cast operands accumulated in f32;
    the first minimum over y (the lowest index)."""
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    if tier == "bf16x3":
        dot = dot_nt_f32(yj, xj, "bf16x3")
    else:
        dot = jax.lax.dot_general(
            yj.astype(jnp.bfloat16), xj.astype(jnp.bfloat16),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    xx = jnp.sum(xj * xj, axis=1)[None, :]
    yy = jnp.sum(yj * yj, axis=1)[:, None]
    d = jnp.maximum(yy + xx - 2.0 * dot, 0.0)             # (n, m)
    idx = jnp.argmin(d, axis=0).astype(jnp.int32)
    best = jnp.min(d, axis=0)
    if sqrt:
        best = jnp.sqrt(best)
    return np.asarray(idx), np.asarray(best)


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("tier", ["bf16x3", "bf16"])
@pytest.mark.parametrize("m,n,d", [(64, 16, 32), (37, 23, 8), (129, 65, 17)])
def test_card_tiers_match_jax_arithmetic(sqrt, tier, m, n, d):
    rng = np.random.default_rng(100 * m + n + d)
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    ij, dj = _reference_tier(x, y, sqrt, tier)
    it, dt = op.fused_l2_nn_plain(torch.from_numpy(x), torch.from_numpy(y),
                                  sqrt, tier)
    np.testing.assert_array_equal(it.numpy(), ij)
    scale = (x * x).sum(1) + (y * y).sum(1)[ij]
    if sqrt:
        scale = np.sqrt(scale)
    assert (np.abs(dt.numpy() - dj) <= 1e-6 * scale).all()


def test_none_on_cpu_is_f32():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(50, 12)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(9, 12)).astype(np.float32))
    i0, d0 = op.fused_l2_nn(x, y, kernel_precision=None)
    i1, d1 = op.fused_l2_nn_plain(x, y, False, "f32")
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    _, d2 = op.fused_l2_nn(x, y, kernel_precision="bf16")
    assert not torch.equal(d0, d2)          # the tiers really differ
    with pytest.raises(ValueError, match="kernel precision"):
        op.fused_l2_nn(x, y, kernel_precision="tf32")

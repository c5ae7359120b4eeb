"""Parity of the port's select_k (raft_tpu_torch) with the JAX package's
Pallas ``select_k_pallas`` (interpret mode) and ``selection.select_k``.

Tolerance: selection does no arithmetic, so values and ids must be
identical; duplicates and +inf entries included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.neighbors.selection import select_k as jax_select_k
from raft_tpu.ops.pallas_select_k import select_k_pallas
from raft_tpu_torch.neighbors.selection import select_k
from raft_tpu_torch.ops import select_k as op


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _pallas(v, k):
    d, i = select_k_pallas(jnp.asarray(v), k)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("k", [1, 7, 96, 256])
def test_matches_pallas_kernel(k):
    rng = np.random.default_rng(k)
    v = rng.normal(size=(12, 600)).astype(np.float32)
    dj, ij = _pallas(v, k)
    dt, it = select_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert it.dtype == torch.int32


@pytest.mark.parametrize("k", [5, 40])
def test_duplicates_exact_ids(k):
    rng = np.random.default_rng(11)
    v = rng.integers(0, 6, size=(9, 100)).astype(np.float32)
    dj, ij = _pallas(v, k)
    dt, it = select_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), ij)


def test_inf_entries_return_minus_one():
    rng = np.random.default_rng(5)
    v = np.full((6, 64), np.inf, np.float32)
    for r in range(6):
        cols = rng.choice(64, size=r, replace=False)
        v[r, cols] = rng.normal(size=r)
    dj, ij = _pallas(v, 8)
    dt, it = select_k(torch.from_numpy(v), 8)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert (it.numpy()[np.isinf(dt.numpy())] == -1).all()
    assert (it.numpy()[5, :5] >= 0).all() and (it.numpy()[0] == -1).all()


def test_narrow_rows_use_kernel_op_like_coarse_probes():
    # n < 2k: selection.select_k routes to topk, but the coarse phase
    # calls the kernel directly (as the JAX package calls select_k_pallas)
    rng = np.random.default_rng(6)
    v = rng.normal(size=(10, 16)).astype(np.float32)
    dj, ij = _pallas(v, 12)
    dt, it = op.select_k(torch.from_numpy(v), 12)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), ij)


def test_k_above_256_goes_to_topk(monkeypatch):
    rng = np.random.default_rng(8)
    v = rng.normal(size=(4, 700)).astype(np.float32)
    calls = []
    orig = op.select_k
    monkeypatch.setattr(op, "select_k",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    dt, it = select_k(torch.from_numpy(v), 300)
    assert not calls
    dj, ij = jax_select_k(jnp.asarray(v), 300)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # and k <= 256 with n >= 2k does take the kernel op
    select_k(torch.from_numpy(v), 256)
    assert calls == [1]


def test_select_max_and_input_indices_match_jax():
    rng = np.random.default_rng(9)
    v = rng.normal(size=(5, 50)).astype(np.float32)
    ids = rng.permutation(1000)[:50].astype(np.int32)
    dj, ij = jax_select_k(jnp.asarray(v), 6, select_min=False,
                          input_indices=jnp.asarray(ids))
    dt, it = select_k(torch.from_numpy(v), 6, select_min=False,
                      input_indices=torch.from_numpy(ids))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_cpu_tensor_takes_plain_version_without_launch():
    before = op.launches
    op.select_k(torch.arange(20, dtype=torch.float32)[None], 3)
    assert op.launches == before

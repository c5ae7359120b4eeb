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
    # the route off the kernel (a stable sort since F16)
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


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("shape,k,dtype", [
    ((4, 600), 300, np.float32),    # k > 256
    ((3, 30), 20, np.float32),      # n < 2k
    ((5, 50), 10, np.float64)])     # float64
def test_tied_values_off_the_kernel_route_match_jax(shape, k, dtype,
                                                    select_min):
    # F16: off the kernel route (k > 256, fewer than 2k columns, float64)
    # a stable sort puts the lower index first among equal values, as
    # lax.top_k does; few integer levels put ties everywhere
    rng = np.random.default_rng(k + len(shape))
    v = rng.integers(0, 5, size=shape).astype(dtype)
    dj, ij = jax_select_k(jnp.asarray(v), k, select_min=select_min)
    dt, it = select_k(torch.from_numpy(v), k, select_min=select_min)
    assert it.dtype == torch.int32 and dt.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


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


@pytest.mark.parametrize("k", [3, 17])
def test_signed_zeros_and_levels_tie_by_column(k):
    # -0.0 and +0.0 compare equal, so only the column orders them (the
    # card's radix keys map -0.0 onto +0.0 for this); few distinct levels
    # put ties at the k-th value; an all-equal row keeps the first k
    rng = np.random.default_rng(21)
    v = np.stack([rng.choice([-0.0, 0.0, 1.0, -1.0], size=80),
                  rng.integers(0, 3, size=80) * 0.25,
                  np.full(80, 0.5),
                  rng.choice([-0.0, 0.0], size=80)]).astype(np.float32)
    dj, ij = _pallas(v, k)
    dt, it = select_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_array_equal(it.numpy()[2], np.arange(k))


# (lists, bins) of each row width: the fused scans' candidate rows are
# the bins of each query's probed lists in ascending list id
_PAYLOAD_LAYOUT = {5: (1, 5), 300: (3, 100), 16384: (128, 128),
                   20000: (160, 125)}


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("n", sorted(_PAYLOAD_LAYOUT))
def test_payload_select_matches_list_state_merge(n, k, sqrt):
    # pass B of the fused scans ranks each query's candidate row by
    # (value, column); the TPU kernels merge list after list into a
    # resident state that wins ties (merge_lists_into_state +
    # finish_state). The two agree because the columns are in (list id,
    # bin) order: tie-heavy integer scores, +inf pads with id -1, NaN
    # (read as +inf) and n < k
    from raft_tpu_torch.ops.ivf_scan import (finish_state,
                                             merge_lists_into_state)
    rng = np.random.default_rng(n + k)
    n_lists, bins = _PAYLOAD_LAYOUT[n]
    nq = 3
    v = rng.integers(0, 20, size=(nq, n)).astype(np.float32)
    ids = rng.permutation(10 * n)[:nq * n].reshape(nq, n).astype(np.int32)
    pad = rng.random((nq, n)) < np.array([[0.1], [0.95], [0.3]])
    v[pad] = np.inf
    ids[pad] = -1
    v[2, rng.random(n) < 0.2] = np.nan
    vt, it = torch.from_numpy(v), torch.from_numpy(ids)
    dt, idt = op.select_k_payload(vt, it, k, sqrt)
    assert dt.shape == (nq, k) and idt.dtype == torch.int32
    # the state walk over lists in ascending id, a few lists at a time
    cd = vt.reshape(nq, n_lists, bins).permute(1, 0, 2)  # (lists, nq, bins)
    ci = it.reshape(nq, n_lists, bins).permute(1, 0, 2)
    qm = torch.arange(nq, dtype=torch.int32).expand(n_lists, nq)
    best_d = torch.full((nq, k), float("inf"))
    best_i = torch.full((nq, k), -1, dtype=torch.int32)
    for l0 in range(0, n_lists, 7):
        best_d, best_i = merge_lists_into_state(
            best_d, best_i, cd[l0:l0 + 7], ci[l0:l0 + 7], qm[l0:l0 + 7])
    dm, im = finish_state(best_d, best_i, sqrt)
    assert torch.equal(idt, im)
    assert torch.equal(dt, dm)
    assert bool((idt[torch.isinf(dt)] == -1).all())


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("shape,k", [((16, 512), 32), ((8, 300), 200),
                                     ((6, 1000), 400)])
def test_approx_mode_matches_jax(shape, k, select_min):
    # the JAX package's lax.approx_{min,max}_k is exact on the CPU; the
    # port's approx mode is the exact route (the kernel's plain version
    # at k <= 256 and 2k columns, a stable sort otherwise): the same values and
    # ids, recall 1.0 whatever the target
    rng = np.random.default_rng(k)
    v = rng.normal(size=shape).astype(np.float32)
    dj, ij = jax_select_k(v, k, select_min=select_min, mode="approx",
                          recall_target=0.9)
    dt, it = select_k(torch.from_numpy(v), k, select_min=select_min,
                      mode="approx", recall_target=0.9)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    de, ie = select_k(torch.from_numpy(v), k, select_min=select_min)
    assert torch.equal(it, ie) and torch.equal(dt, de)


def test_approx_mode_maps_input_indices_like_exact():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    ids = torch.arange(64, dtype=torch.int32) * 10 + 7
    a = select_k(v, 6, input_indices=ids, mode="approx")
    e = select_k(v, 6, input_indices=ids)
    assert torch.equal(a[1], e[1]) and torch.equal(a[0], e[0])

"""Parity of the port's sparse stack (raft_tpu_torch.sparse) with the JAX
package's, on the CPU, from the same numpy inputs.

Tolerances: containers, conversions and structural ops exact (duplicate
sums add in the same order); linear algebra within rtol 1e-6 (segment
sums in another order); sparse pairwise distances within rtol 1e-5 (and
1e-5 of the expanded metrics' norm scale) at every metric of both tiers;
sparse k-NN, kNN graph and ``connect_components`` with identical ids;
the MST the same edge set; Lanczos eigenvalues within 1e-4 of the JAX
package's and of ``numpy.linalg.eigvalsh``, eigenvectors within 1e-3 up
to sign (the two packages start from other random vectors). The
ball-cover and type-dispatching serializers round-trip both ways with
the JAX package's files.
"""

import importlib

import numpy as np
import pytest
import torch

import raft_tpu.sparse as jsp
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.sparse.solver import lanczos as jlz
import raft_tpu_torch.sparse as tsp
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import distance as dense_distance
from raft_tpu_torch.sparse.solver import lanczos as tlz

# the packages export the function ``mst`` under the module's name
jmst = importlib.import_module("raft_tpu.sparse.solver.mst")
tmst = importlib.import_module("raft_tpu_torch.sparse.solver.mst")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _random_sparse(rng, m, n, density=0.2):
    x = rng.random((m, n)).astype(np.float32)
    x[rng.random((m, n)) > density] = 0.0
    return x


def _t(a):
    return torch.from_numpy(np.array(a))


def _csr_pair(j):
    """The JAX CSR and the port's, from the JAX one's arrays."""
    return j, tsp.CSR.from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                                 np.asarray(j.data), j.shape, device="cpu")


def _coo_pair(j):
    return j, tsp.COO.from_numpy(np.asarray(j.rows), np.asarray(j.cols),
                                 np.asarray(j.vals), j.shape, device="cpu")


def _eq_csr(t, j):
    assert t.shape == j.shape
    for a, b in ((t.indptr, j.indptr), (t.indices, j.indices),
                 (t.data, j.data)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _eq_coo(t, j):
    assert t.shape == j.shape
    for a, b in ((t.rows, j.rows), (t.cols, j.cols), (t.vals, j.vals)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------
# containers, conversions, structural ops

def test_containers_and_conversions_exact(rng):
    x = _random_sparse(rng, 17, 23)
    jcsr, tcsr = _csr_pair(jsp.dense_to_csr(x))
    _eq_csr(tsp.dense_to_csr(_t(x)), jcsr)
    np.testing.assert_array_equal(tcsr.todense().numpy(), x)
    np.testing.assert_array_equal(tcsr.row_ids().numpy(),
                                  np.asarray(jcsr.row_ids()))
    np.testing.assert_array_equal(tcsr.row_lengths().numpy(),
                                  np.asarray(jcsr.row_lengths()))
    jcoo = jsp.csr_to_coo(jcsr)
    _eq_coo(tsp.csr_to_coo(tcsr), jcoo)
    _eq_coo(tsp.dense_to_coo(_t(x)), jsp.dense_to_coo(x))
    np.testing.assert_array_equal(tsp.coo_to_dense(_coo_pair(jcoo)[1])
                                  .numpy(), x)
    np.testing.assert_array_equal(tsp.csr_to_dense(tcsr).numpy(), x)
    # an unsorted COO with duplicates: sorted by (row, col), equal pairs
    # in input order
    perm = rng.permutation(jcoo.nnz)
    rows = np.concatenate([np.asarray(jcoo.rows)[perm], [3, 3]])
    cols = np.concatenate([np.asarray(jcoo.cols)[perm], [5, 5]])
    vals = np.concatenate([np.asarray(jcoo.vals)[perm],
                           [0.25, 0.5]]).astype(np.float32)
    jc, tc = _coo_pair(jsp.COO(rows.astype(np.int32), cols.astype(np.int32),
                               vals, x.shape))
    _eq_csr(tsp.coo_to_csr(tc), jsp.coo_to_csr(jc))
    adj = rng.random((9, 9)) > 0.6
    _eq_csr(tsp.adj_to_csr(_t(adj)), jsp.adj_to_csr(adj))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_coo_reduce_exact(rng, op, dtype):
    n = 200
    rows = rng.integers(0, 6, n).astype(np.int32)
    cols = rng.integers(0, 5, n).astype(np.int32)
    vals = (rng.normal(size=n) * 100).astype(dtype)
    jc, tc = _coo_pair(jsp.COO(rows, cols, vals, (6, 5)))
    _eq_coo(tsp.coo_reduce(tc, op), jsp.coo_reduce(jc, op))


def test_structural_ops_exact(rng):
    x = _random_sparse(rng, 20, 11, density=0.3)
    x[4] = 0.0
    jcsr, tcsr = _csr_pair(jsp.dense_to_csr(x))
    jcoo, tcoo = _coo_pair(jsp.csr_to_coo(jcsr))
    perm = rng.permutation(jcoo.nnz)
    jshuf, tshuf = _coo_pair(jsp.COO(np.asarray(jcoo.rows)[perm],
                                     np.asarray(jcoo.cols)[perm],
                                     np.asarray(jcoo.vals)[perm], x.shape))
    _eq_coo(tsp.coo_sort(tshuf), jsp.coo_sort(jshuf))
    _eq_coo(tsp.coo_remove_zeros(tcoo, 0.5), jsp.coo_remove_zeros(jcoo, 0.5))
    for a, b in ((0, 20), (3, 9), (4, 5), (7, 7)):
        _eq_csr(tsp.csr_slice_rows(tcsr, a, b), jsp.csr_slice_rows(jcsr, a, b))
    _eq_csr(tsp.csr_row_op(tcsr, lambda r, d: d * (r + 1).float()),
            jsp.csr_row_op(jcsr, lambda r, d: d * (r + 1)))


# ---------------------------------------------------------------------
# linear algebra

def test_linalg_matches_jax(rng):
    a = _random_sparse(rng, 15, 12, density=0.3)
    b = _random_sparse(rng, 15, 12, density=0.3)
    a[3] = 0.0
    ja, ta = _csr_pair(jsp.dense_to_csr(a))
    jb, tb = _csr_pair(jsp.dense_to_csr(b))
    v = rng.normal(size=12).astype(np.float32)
    m = rng.normal(size=(12, 4)).astype(np.float32)
    np.testing.assert_allclose(tsp.spmv(ta, _t(v)).numpy(),
                               np.asarray(jsp.spmv(ja, v)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tsp.spmm(ta, _t(m)).numpy(),
                               np.asarray(jsp.spmm(ja, m)), rtol=1e-6,
                               atol=1e-6)
    _eq_csr(tsp.csr_add(ta, tb), jsp.csr_add(ja, jb))
    _eq_csr(tsp.csr_transpose(ta), jsp.csr_transpose(ja))
    jcoo, tcoo = _coo_pair(jsp.csr_to_coo(ja))
    np.testing.assert_array_equal(tsp.degree(tcoo).numpy(),
                                  np.asarray(jsp.degree(jcoo)))
    for norm in ("l1", "l2", "linf"):
        got, want = tsp.row_normalize(ta, norm), jsp.row_normalize(ja, norm)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   rtol=1e-6)
    sq = _random_sparse(rng, 10, 10, density=0.3)
    jsq, tsq = _csr_pair(jsp.dense_to_csr(sq))
    jsqc, tsqc = _coo_pair(jsp.csr_to_coo(jsq))
    for op in ("max", "sum"):
        _eq_coo(tsp.symmetrize(tsqc, op), jsp.symmetrize(jsqc, op))
    for normalized in (False, True):
        got = tsp.laplacian(tsq, normalized)
        want = jsp.laplacian(jsq, normalized)
        np.testing.assert_array_equal(got.indptr.numpy(),
                                      np.asarray(want.indptr))
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------
# pairwise distances, both tiers

MATMUL = ["L2Expanded", "L2SqrtExpanded", "CosineExpanded",
          "CorrelationExpanded", "InnerProduct", "HellingerExpanded",
          "RusselRaoExpanded", "JaccardExpanded", "DiceExpanded"]
ELEMENTWISE = ["L1", "L2Unexpanded", "L2SqrtUnexpanded", "Linf", "Canberra",
               "LpUnexpanded", "HammingUnexpanded", "JensenShannon",
               "KLDivergence", "BrayCurtis"]
_DISTRIBUTIONS = ("HellingerExpanded", "JensenShannon", "KLDivergence")


def _pair_data(rng, metric, m, n, k, density):
    x = _random_sparse(rng, m, k, density)
    y = _random_sparse(rng, n, k, density)
    if metric in _DISTRIBUTIONS:
        x = x / np.maximum(x.sum(1, keepdims=True), 1e-6)
        y = y / np.maximum(y.sum(1, keepdims=True), 1e-6)
    return x, y


def _close(got, want, x, y):
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] + 1.0
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want) + 1e-5 * scale).all(), err.max()


@pytest.mark.parametrize("metric", MATMUL + ELEMENTWISE)
def test_wide_tier_matches_jax(metric):
    # both metric sets of the column-tiled tier, forced by col_tile over
    # a ragged last tile
    rng = np.random.default_rng(len(metric))
    x, y = _pair_data(rng, metric, 19, 13, 257, 0.1)
    jx, tx = _csr_pair(jsp.dense_to_csr(x))
    jy, ty = _csr_pair(jsp.dense_to_csr(y))
    got = tsp.pairwise_distance(tx, ty, DistanceType[metric], 3.0,
                                col_tile=64).numpy()
    want = np.asarray(jsp.pairwise_distance(jx, jy, JDT[metric], 3.0,
                                            col_tile=64))
    _close(got, want, x, y)


# the narrow tier against the JAX package at one metric of each kind of
# the dense distance (every metric is held to the dense function below)
NARROW_JAX = ("L2Expanded", "L1", "JensenShannon")


@pytest.mark.parametrize("metric", MATMUL + ELEMENTWISE)
def test_narrow_tier_is_the_dense_distance(metric):
    rng = np.random.default_rng(len(metric))
    x, y = _pair_data(rng, metric, 19, 13, 40, 0.3)
    tx, ty = tsp.dense_to_csr(_t(x)), tsp.dense_to_csr(_t(y))
    got = tsp.pairwise_distance(tx, ty, DistanceType[metric], 3.0).numpy()
    # the densified rows through the port's dense distance, bit for bit
    dense = dense_distance(_t(x), _t(y), DistanceType[metric], 3.0,
                           device="cpu").numpy()
    np.testing.assert_array_equal(got, dense)
    if metric in NARROW_JAX:
        jx, jy = jsp.dense_to_csr(x), jsp.dense_to_csr(y)
        _close(got, np.asarray(jsp.pairwise_distance(jx, jy, JDT[metric],
                                                     3.0)), x, y)


def test_narrow_row_tiles_and_wide_row_chunks(monkeypatch):
    # small scratch budgets: the narrow tier in row tiles of x (the same
    # bits as one tile), the wide elementwise tier in row chunks
    from raft_tpu_torch.sparse import distance as sd
    rng = np.random.default_rng(5)
    x, y = _pair_data(rng, "L1", 37, 23, 300, 0.05)
    tx, ty = tsp.dense_to_csr(_t(x)), tsp.dense_to_csr(_t(y))
    whole = {c: tsp.pairwise_distance(tx, ty, DistanceType.L1,
                                      col_tile=c).numpy() for c in (None, 64)}
    monkeypatch.setattr(sd, "_TILE_BUDGET_ELEMS", 1 << 12)
    np.testing.assert_array_equal(
        tsp.pairwise_distance(tx, ty, DistanceType.L1).numpy(), whole[None])
    np.testing.assert_allclose(
        tsp.pairwise_distance(tx, ty, DistanceType.L1, col_tile=64).numpy(),
        whole[64], rtol=1e-6)
    np.testing.assert_allclose(whole[64], whole[None], rtol=1e-5, atol=1e-5)


def test_wide_tier_auto_at_100k_features():
    # (m + n) * k over the scratch budget and k over the wide tile: the
    # column-tiled path without col_tile
    rng = np.random.default_rng(6)
    k, nnz = 100_000, 16

    def rows(m):
        ptr = np.arange(0, (m + 1) * nnz, nnz)
        idx = np.sort(np.stack([rng.choice(k, nnz, replace=False)
                                for _ in range(m)]), 1).reshape(-1)
        return jsp.CSR(ptr.astype(np.int32), idx.astype(np.int32),
                       rng.random(m * nnz).astype(np.float32), (m, k))
    jx, tx = _csr_pair(rows(50))
    jy, ty = _csr_pair(rows(40))
    for metric in ("L2SqrtExpanded", "L1"):
        got = tsp.pairwise_distance(tx, ty, DistanceType[metric]).numpy()
        want = np.asarray(jsp.pairwise_distance(jx, jy, JDT[metric]))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# neighbours

@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct", "L1"])
def test_sparse_knn_matches_jax(metric):
    rng = np.random.default_rng(7)
    x = _random_sparse(rng, 120, 30, density=0.3)
    q = _random_sparse(rng, 25, 30, density=0.3)
    jx, tx = _csr_pair(jsp.dense_to_csr(x))
    jq, tq = _csr_pair(jsp.dense_to_csr(q))
    dt, it = tsp.brute_force_knn(tx, tq, 7, DistanceType[metric],
                                 batch_size=10)
    dj, ij = jsp.brute_force_knn(jx, jq, 7, JDT[metric], batch_size=10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def test_knn_graph_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.random((60, 5)).astype(np.float32)
    gt = tsp.knn_graph(_t(x), 4)
    gj = jsp.knn_graph(x, 4)
    np.testing.assert_array_equal(gt.rows.numpy(), np.asarray(gj.rows))
    np.testing.assert_array_equal(gt.cols.numpy(), np.asarray(gj.cols))
    np.testing.assert_allclose(gt.vals.numpy(), np.asarray(gj.vals),
                               rtol=1e-4, atol=1e-4)


def test_connect_components_matches_jax():
    rng = np.random.default_rng(9)
    blobs = [rng.normal(c, 0.2, (12, 3)) for c in (0.0, 3.0, 6.0, 9.0)]
    x = np.vstack(blobs).astype(np.float32)
    labels = np.repeat(np.arange(4), 12).astype(np.int32)
    perm = rng.permutation(len(x))
    x, labels = x[perm], labels[perm]
    dt, it, _ = tsp.cross_component_nn(_t(x), _t(labels))
    dj, ij, _ = jsp.cross_component_nn(x, labels)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4)
    ct = tsp.connect_components(_t(x), _t(labels))
    cj = jsp.connect_components(x, labels)
    np.testing.assert_array_equal(ct.rows.numpy(), np.asarray(cj.rows))
    np.testing.assert_array_equal(ct.cols.numpy(), np.asarray(cj.cols))
    np.testing.assert_allclose(ct.vals.numpy(), np.asarray(cj.vals),
                               rtol=1e-4)
    one = tsp.connect_components(_t(x), torch.zeros(len(x), dtype=torch.int32))
    assert one.nnz == 0


# ---------------------------------------------------------------------
# solvers

@pytest.mark.parametrize("n,n_edges,ties", [(50, 200, False), (300, 900, False),
                                            (80, 150, True)])
def test_mst_matches_jax(n, n_edges, ties, monkeypatch):
    rng = np.random.default_rng(n)
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n, n_edges)
    w = rng.random(n_edges)
    if ties:
        w = np.round(w * 4) / 4  # many equal weights; a disconnected graph
    got = tmst.boruvka_mst_edges(n, src, dst, w)

    def edge_set(s, d, wt):
        return sorted((min(a, b), max(a, b), float(c))
                      for a, b, c in zip(s, d, wt))
    want = jmst.boruvka_mst_edges(n, src, dst, w)   # the native route
    assert edge_set(*got[:3]) == edge_set(*want[:3])
    from raft_tpu.core import native
    monkeypatch.setattr(native, "available", lambda: False)
    want = jmst.boruvka_mst_edges(n, src, dst, w)   # its numpy route
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    s, d, wt = tmst.mst(n, src, dst, w)
    np.testing.assert_array_equal(s, got[0])


def _spectrum_matrix(n, seed):
    # well-separated extremes: Lanczos converges to f32 precision
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([[0.1, 0.5, 1.0], np.linspace(4.0, 5.0, n - 5),
                          [8.0, 9.5]])
    return ((q * lam) @ q.T).astype(np.float32), lam


@pytest.mark.parametrize("largest", [False, True])
def test_lanczos_matches_jax(largest):
    a, lam = _spectrum_matrix(40, 10)
    ja, ta = _csr_pair(jsp.dense_to_csr(a))
    k = 2 if largest else 3
    fn_t = tlz.lanczos_largest if largest else tlz.lanczos_smallest
    fn_j = jlz.lanczos_largest if largest else jlz.lanczos_smallest
    wt, vt = fn_t(ta, k, seed=1)
    wj, vj = fn_j(ja, k, seed=1)
    w_ref, v_ref = np.linalg.eigh(a.astype(np.float64))
    sel = np.arange(len(w_ref) - 1, len(w_ref) - k - 1, -1) if largest \
        else np.arange(k)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), w_ref[sel], atol=1e-4)
    for j in range(k):
        ref = v_ref[:, sel[j]]
        for v in (vt.numpy()[:, j], np.asarray(vj)[:, j]):
            sign = np.sign(np.dot(v, ref))
            np.testing.assert_allclose(sign * v, ref, atol=1e-3)


def test_lanczos_breakdown_and_determinism():
    eye = tsp.dense_to_csr(torch.eye(12))
    w, _ = tlz.lanczos_smallest(eye, 3)
    np.testing.assert_allclose(w.numpy(), np.ones(3), atol=1e-4)
    a, _ = _spectrum_matrix(30, 11)
    ta = tsp.dense_to_csr(_t(a))
    one, two = tlz.lanczos_smallest(ta, 2, seed=4), \
        tlz.lanczos_smallest(ta, 2, seed=4)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    d = torch.arange(1, 26, dtype=torch.float32)
    w, _ = tlz.lanczos_smallest(ta, 2, matvec=lambda v: d * v, n=25)
    np.testing.assert_allclose(w.numpy(), [1.0, 2.0], atol=1e-3)

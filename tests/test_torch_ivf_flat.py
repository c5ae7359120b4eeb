"""Parity of the port's IVF-Flat (raft_tpu_torch) with the JAX package's.

A JAX-built index is saved with ``raft_tpu.neighbors.serialize`` and
loaded by the port (bf16 and int8 indexes are carried across by
``index_from_numpy``), so search parity is free of k-means noise. The
JAX side runs its Pallas kernels in interpret mode; the port runs its
plain versions (CPU tensors). Tolerance: ids identical, distances within
rtol 1e-5 / atol 1e-5 (narrow storage: within 1e-5 of the expanded-L2
scale |q|^2 + |x|^2; exact products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.neighbors import _ivf_scan as j_scan
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import serialize as jser
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan as t_scan
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.ops import ivf_scan as scan_op

METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.InnerProduct, DistanceType.CosineExpanded]
N, D, NQ, N_LISTS, K = 2000, 16, 64, 16, 10


def _data(seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(24, D)).astype(np.float32)
    x = c[rng.integers(0, 24, N)] + rng.normal(size=(N, D))
    q = c[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def indexes(data, tmp_path_factory):
    """metric -> (JAX index, port index loaded from the JAX file)."""
    x, _ = data
    out = {}
    for m in METRICS:
        jidx = jflat.build(x, jflat.IndexParams(n_lists=N_LISTS,
                                                metric=JDT(int(m)),
                                                kmeans_n_iters=4))
        path = str(tmp_path_factory.mktemp("idx") / f"flat_{int(m)}.npz")
        jser.save_ivf_flat(jidx, path)
        out[m] = (jidx, tser.load_ivf_flat(path, device="cpu"))
    return out


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _search_both(jidx, tidx, q, k, **sp):
    dj, ij = jflat.search(jidx, q, k, jflat.SearchParams(**sp))
    dt, it = tflat.search(tidx, q, k, tflat.SearchParams(**sp))
    return np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
@pytest.mark.parametrize("order,bins", [("list", 0), ("list", -1),
                                        ("probe", 0)])
def test_search_matches_jax(indexes, data, metric, order, bins):
    jidx, tidx = indexes[metric]
    _, q = data
    before = scan_op.launches
    dj, ij, dt, it = _search_both(jidx, tidx, q, K, n_probes=4,
                                  scan_order=order, scan_bins=bins)
    assert scan_op.launches == before       # CPU tensors: plain version
    assert it.dtype == np.int32 and dt.shape == (NQ, K)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


def test_auto_order_routes_like_jax(indexes, data):
    # nq=64, 4 probes, 16 lists: reuse 16 >= 4 -> list-major on both
    jidx, tidx = indexes[DistanceType.L2Expanded]
    _, q = data
    dj, ij, dt, it = _search_both(jidx, tidx, q, K, n_probes=4)
    np.testing.assert_array_equal(it, ij)
    assert tflat.use_list_order(tflat.SearchParams(n_probes=4), NQ, 4,
                                N_LISTS)
    assert not tflat.use_list_order(tflat.SearchParams(n_probes=4), 32, 4,
                                    N_LISTS)


def test_pinned_cap_overflow_drop_rule(indexes, data):
    jidx, tidx = indexes[DistanceType.L2Expanded]
    _, q = data
    n_probes, cap = 8, 8
    dj, ij, dt, it = _search_both(jidx, tidx, q, K, n_probes=n_probes,
                                  scan_order="list", scan_bins=-1,
                                  probe_cap=cap)
    # which pair of a tied (list, probe-rank) class yields its slot is
    # the sort's choice (the JAX package's sort is unstable): compare
    # every query whose kept probes are the same in both packages
    pj = j_scan.coarse_probes(jnp.asarray(q), jidx.centers, n_probes,
                              use_pallas=True)
    _, invj = j_scan._invert_probes(pj, N_LISTS, cap)
    pt = t_scan.coarse_probes(torch.from_numpy(q), tidx.centers, n_probes)
    _, invt = t_scan._invert_probes(pt, N_LISTS, cap)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    keep_j = np.asarray(invj) < cap
    keep_t = invt.numpy() < cap
    assert not keep_t.all(), "the pinned cap must overflow"
    np.testing.assert_array_equal(keep_t.sum(0), keep_j.sum(0))
    same = (keep_j == keep_t).all(axis=1)
    assert same.sum() >= NQ // 2
    np.testing.assert_array_equal(it[same], ij[same])
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-5)
    # the dropped pairs matter: an uncapped search differs somewhere
    _, _, _, it_full = _search_both(jidx, tidx, q, K, n_probes=n_probes,
                                    scan_order="list", scan_bins=-1,
                                    probe_cap=-1)
    assert (it_full != it).any()


def test_invert_probes_parity():
    # every (list, rank) class holds one query: the slot order is forced
    nq, n_lists, n_probes = 6, 8, 4
    probes = np.array([[(q + p) % n_lists for p in range(n_probes)]
                       for q in range(nq)], np.int32)
    for cap in (8, 4, 2):
        qj, ij = j_scan._invert_probes(jnp.asarray(probes), n_lists, cap)
        qt, it = t_scan._invert_probes(torch.from_numpy(probes), n_lists,
                                       cap)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_invert_probes_same_slots_per_rank_class():
    rng = np.random.default_rng(0)
    nq, n_lists, n_probes, cap = 64, 16, 6, 64
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    qj, ij = j_scan._invert_probes(jnp.asarray(probes), n_lists, cap)
    qt, it = t_scan._invert_probes(torch.from_numpy(probes), n_lists, cap)
    qj, ij, qt, it = np.asarray(qj), np.asarray(ij), qt.numpy(), it.numpy()
    rank = {(q, l): p for q in range(nq) for p, l in
            enumerate(probes[q])}
    for l in range(n_lists):
        rj = [rank[(q, l)] for q in qj[l] if q >= 0]
        rt = [rank[(q, l)] for q in qt[l] if q >= 0]
        assert rt == rj == sorted(rt)
        assert set(qt[l][qt[l] >= 0]) == set(qj[l][qj[l] >= 0])
    for q in range(nq):
        for p in range(n_probes):
            assert qt[probes[q, p], it[q, p]] == q


def test_save_roundtrip_both_directions(indexes, data, tmp_path):
    jidx, tidx = indexes[DistanceType.InnerProduct]
    _, q = data
    path = str(tmp_path / "from_port")            # no .npz suffix
    tser.save_ivf_flat(tidx, path)
    back = jser.load_ivf_flat(path)
    for f in ("centers", "lists_data", "lists_indices", "lists_norms",
              "list_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jidx, f)))
    assert back.metric == jidx.metric and back.size == jidx.size
    sp = dict(n_probes=4, scan_order="probe")
    dj, ij = jflat.search(back, q, K, jflat.SearchParams(**sp))
    dt, it = tflat.search(tidx, q, K, tflat.SearchParams(**sp))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    again = tser.load_ivf_flat(path, device="cpu")
    assert torch.equal(again.lists_data, tidx.lists_data)


def test_port_build_matches_jax_build():
    # n > 65536 and trainset fraction 1.0: both packages draw the same
    # initial rows, so on separated blobs the lists must be identical
    rng = np.random.default_rng(1)
    c = rng.normal(size=(8, 8)).astype(np.float32) * 20
    x = (c[rng.integers(0, 8, 70000)]
         + rng.normal(size=(70000, 8))).astype(np.float32)
    kw = dict(n_lists=8, kmeans_n_iters=3, kmeans_trainset_fraction=1.0)
    jidx = jflat.build(x, jflat.IndexParams(**kw))
    tidx = tflat.build(x, tflat.IndexParams(**kw), device="cpu")
    np.testing.assert_array_equal(tidx.list_sizes.numpy(),
                                  np.asarray(jidx.list_sizes))
    np.testing.assert_array_equal(tidx.lists_indices.numpy(),
                                  np.asarray(jidx.lists_indices))
    np.testing.assert_allclose(tidx.centers.numpy(), np.asarray(jidx.centers),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tidx.lists_norms.numpy(),
                               np.asarray(jidx.lists_norms), rtol=1e-5)


def test_batched_search_pins_route(indexes, data, monkeypatch):
    _, tidx = indexes[DistanceType.L2Expanded]
    _, q = data
    sp = tflat.SearchParams(n_probes=4)
    d_full, i_full = tflat.search(tidx, q, K, sp)
    monkeypatch.setattr(tflat, "MAX_QUERY_BATCH", 24)
    d_b, i_b = tflat.search(tidx, q, K, sp)
    assert torch.equal(i_b, i_full)
    torch.testing.assert_close(d_b, d_full)


def test_unported_features_raise(indexes, data):
    x, q = data
    _, tidx = indexes[DistanceType.L2Expanded]
    with pytest.raises(LogicError, match="internal_distance_dtype"):
        tflat.search(tidx, q, K, tflat.SearchParams(
            internal_distance_dtype=torch.float16))


# --- k > 256: the unfused list scan (kernel 4) and the candidate merge ----

def _bf16_ulp_tol(dj):
    """One bf16 rounding step of each value (2^-8 relative): the unit in
    which bf16 candidate scores can differ when the two packages' f32
    scores straddle a rounding boundary."""
    return 2.0 ** -8 * np.maximum(np.abs(dj), 1.0)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("order", ["list", "auto"])
@pytest.mark.parametrize("internal", ["float32", "bfloat16"])
@pytest.mark.parametrize("bins", [0, 32])
def test_wide_k_matches_jax(indexes, data, metric, order, internal, bins):
    # nq=64 x 16 probes over 16 lists: "auto" goes list-major too; k=300
    # takes the unfused scan (auto bins = every row, or 32 strided bins)
    jidx, tidx = indexes[metric]
    _, q = data
    before = scan_op.launches_list
    dj, ij = jflat.search(jidx, q, 300, jflat.SearchParams(
        n_probes=16, scan_order=order, scan_bins=bins,
        internal_distance_dtype=getattr(jnp, internal)))
    dt, it = tflat.search(tidx, q, 300, tflat.SearchParams(
        n_probes=16, scan_order=order, scan_bins=bins,
        internal_distance_dtype=getattr(torch, internal)))
    assert scan_op.launches_list == before  # CPU tensors: plain version
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    assert it.shape == (NQ, 300) and it.dtype == np.int32
    if internal == "float32":
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
        return
    # bf16 scores: equal where both packages round to the same bf16
    # value; a slot may differ by one rounding step, and the ids of
    # such slots are near-ties at that step
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    tol = _bf16_ulp_tol(dj)
    assert (np.abs(dt - dj)[fin] <= tol[fin]).all()
    for r, c in np.argwhere(it != ij):
        pos = np.flatnonzero(ij[r] == it[r, c])
        other = dj[r, pos[0]] if pos.size else dt[r, c]
        assert abs(other - dj[r, c]) <= tol[r, c], (r, c)
    assert (it == ij).mean() >= 0.99


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bins", [0, -1, 24])
def test_list_scan_plain_matches_pallas(metric, bins):
    # the unfused tier alone on random lists (an empty list, a short one,
    # a bins count that does not divide max_list), merged at k=300
    from raft_tpu.ops.pallas_ivf_scan import ivf_list_scan_pallas
    rng = np.random.default_rng(bins + 7)
    n_lists, max_list, d, nq, n_probes, k, cap = 12, 70, 13, 40, 6, 300, 32
    data_ = rng.normal(size=(n_lists, max_list, d)).astype(np.float32)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    data_[ids < 0] = 0.0
    norms = (data_ ** 2).sum(-1).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    dj, ij = ivf_list_scan_pallas(
        jnp.asarray(q), jnp.asarray(data_), jnp.asarray(norms),
        jnp.asarray(ids), jnp.asarray(probes), k, cap, bins=bins,
        metric=metric, fused=False)
    tq, tp = torch.from_numpy(q), torch.from_numpy(probes)
    qmap, inv_pos = t_scan._invert_probes(tp, n_lists, cap)
    rb, _ = scan_op.resolve_bins(bins, k, max_list)
    cd, ci = scan_op.list_scan(tq, torch.from_numpy(data_),
                               torch.from_numpy(norms),
                               torch.from_numpy(ids), qmap, rb, metric)
    assert cd.shape == (n_lists, cap, rb)
    assert bool((ci[qmap < 0] == -1).all())
    dt, it = t_scan.merge_candidates(cd, ci, tp, inv_pos, k, False, cap)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


def _scan_lists(rng, d, n_lists=16, max_list=40):
    """Random lists: list 0 full, list 1 empty, list 2 five rows."""
    data_ = rng.normal(size=(n_lists, max_list, d)).astype(np.float32)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    data_[ids < 0] = 0.0
    norms = (data_ ** 2).sum(-1).astype(np.float32)
    return data_, norms, ids


def _blocks_by_query(cd, ci, probes, inv_pos, cap, k, sqrt):
    """Kernel 3's decomposition in plain PyTorch: kernel 4's blocks laid
    out per query in (list id, bin) order, then ranked by (value, column)
    as pass B ranks them."""
    from raft_tpu_torch.ops.select_k import select_k_payload_plain
    rows_d, rows_i = scan_op.candidate_rows(cd, ci, probes, inv_pos, cap)
    return select_k_payload_plain(rows_d, rows_i, k, sqrt)


# every value of each axis at least once: d 13/16, k 1/10/200, bins
# 0/-1/7/64/600, cap 8 (overflows) and 200 (> 128: two query tiles a list
# on the card, 256 queries)
_DECOMP = [("l2", 13, 10, 0, 8), ("ip", 16, 1, -1, 8), ("l2", 16, 200, 7, 8),
           ("ip", 13, 10, 64, 200), ("l2", 13, 200, 600, 200),
           ("l2", 16, 1, 64, 8), ("ip", 13, 200, 0, 200),
           ("l2", 16, 10, -1, 200)]


@pytest.mark.parametrize("metric,d,k,bins,cap", _DECOMP)
def test_list_blocks_merged_equal_fused_scan(metric, d, k, bins, cap):
    """Kernel 4's blocks merged per query in (list id, bin) order equal
    the fused scan's plain version exactly, and the JAX package's fused
    Pallas kernel (interpret mode): ids identical, distances within 1e-5
    relative, on every query whose kept probes are the same in both (an
    overflowing cap may drop a different query of a tied class). Slots
    no candidate reaches are (+inf, -1) in the port; the JAX kernel
    repeats an id there (at +inf)."""
    from raft_tpu.ops.pallas_ivf_scan import ivf_list_scan_pallas
    rng = np.random.default_rng(d * 100 + k + bins % 97 + cap)
    nq, n_probes, n_lists = (256 if cap > 128 else 32), 6, 16
    data_, norms, ids = _scan_lists(rng, d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    # skewed towards the low lists: some list draws more than 128 queries
    w = 1.0 / np.arange(1, n_lists + 1)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False,
                                  p=w / w.sum())
                       for _ in range(nq)]).astype(np.int32)
    tq, tp = torch.from_numpy(q), torch.from_numpy(probes)
    td, tn, ti = (torch.from_numpy(a) for a in (data_, norms, ids))
    qmap, inv_pos = t_scan._invert_probes(tp, n_lists, cap)
    if cap == 8:
        assert not bool((inv_pos < cap).all()), "the cap must overflow"
    else:
        assert bool((qmap[:, 128:] >= 0).any()), "two query tiles"
    sqrt = metric == "l2"
    rb, _ = scan_op.resolve_bins(bins, k, ids.shape[1])
    cd, ci = scan_op.list_scan(tq, td, tn, ti, qmap, rb, metric)
    dm, im = _blocks_by_query(cd, ci, tp, inv_pos, cap, k, sqrt)
    df, i_f = scan_op.fused_list_scan(tq, td, tn, ti, tp, inv_pos, qmap,
                                      cap, k, bins, sqrt, metric)
    np.testing.assert_array_equal(im.numpy(), i_f.numpy())
    np.testing.assert_array_equal(dm.numpy(), df.numpy())
    dj, ij = ivf_list_scan_pallas(
        jnp.asarray(q), jnp.asarray(data_), jnp.asarray(norms),
        jnp.asarray(ids), jnp.asarray(probes), k, cap, bins=bins, sqrt=sqrt,
        metric=metric, fused=True)
    _, invj = j_scan._invert_probes(jnp.asarray(probes), n_lists, cap)
    same = ((np.asarray(invj) < cap) == (inv_pos.numpy() < cap)).all(1)
    assert same.sum() >= nq // 2
    dj, ij = np.asarray(dj)[same], np.asarray(ij)[same]
    dt, it = df.numpy()[same], i_f.numpy()[same]
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_array_equal(it[fin], ij[fin])
    assert (it[~fin] == -1).all()
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [13, 16, 200])
def test_bf16x3_scores_match_jax(metric, d):
    """The plain versions' bf16x3 scoring (the card kernels' arithmetic)
    against the JAX package's ``dot_nt_f32(..., "bf16x3")``, within 1e-6
    of |q|^2 + |x|^2."""
    from raft_tpu.ops._util import dot_nt_f32
    rng = np.random.default_rng(d)
    data_, norms, ids = _scan_lists(rng, d)
    q = rng.normal(size=(20, d)).astype(np.float32)
    qmap = np.stack([rng.choice(20, 8, replace=False) for _ in range(16)])
    qmap[3, 5:] = -1
    sc = scan_op._list_scores(torch.from_numpy(q), torch.from_numpy(data_),
                              torch.from_numpy(norms),
                              torch.from_numpy(qmap.astype(np.int32)), 0,
                              metric, "bf16x3").numpy()
    for l in range(16):
        qs = q[np.maximum(qmap[l], 0)]
        ip = np.asarray(dot_nt_f32(jnp.asarray(qs), jnp.asarray(data_[l]),
                                   "bf16x3"))
        want = -ip if metric == "ip" else np.maximum(
            (norms[l][None, :] + (qs * qs).sum(1)[:, None]) - 2.0 * ip, 0.0)
        scale = (qs * qs).sum(1)[:, None] + norms[l][None, :]
        assert (np.abs(sc[l] - want) <= 1e-6 * scale).all()


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    x, _ = _data()
    with pytest.raises(LogicError, match="device='cpu'"):
        tflat.build(x, tflat.IndexParams(n_lists=4))
    with pytest.raises(LogicError, match="device='cpu'"):
        tflat.index_from_numpy({}, DistanceType.L2Expanded, 0)


# --- bf16 and int8 list storage (kernels 3 and 4's narrow branches) -------

STORAGES = ["bfloat16", "int8"]


@pytest.fixture(scope="module")
def narrow_indexes(data):
    """(storage, metric) -> (JAX index, the port's index from its arrays)."""
    x, _ = data
    out = {}
    for st in STORAGES:
        for m in METRICS:
            jidx = jflat.build(x, jflat.IndexParams(
                n_lists=N_LISTS, metric=JDT(int(m)), kmeans_n_iters=4,
                storage_dtype=st))
            out[st, m] = (jidx, _port_index(jidx))
    return out


def _port_index(jidx):
    arrays = {f: np.asarray(getattr(jidx, f)) for f in
              ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")}
    return tflat.index_from_numpy(arrays, jidx.metric, jidx.size,
                                  jidx.scale, device="cpu")


def _assert_narrow_match(dt, dj, it, ij, q, tidx, metric):
    """Distances within ``tol`` = 1e-5 of |q|^2 + the stored norm of the
    row found (IP and cosine alike: the same ip feeds every metric); ids
    identical but where two rows tie within ``tol`` and the packages'
    summation orders rank them the other way round (ids agree on >= 99%
    of the slots)."""
    norm = torch.zeros(int(tidx.lists_indices.max()) + 1)
    ids = tidx.lists_indices.reshape(-1)
    norm[ids[ids >= 0].long()] = tidx.lists_norms.reshape(-1)[ids >= 0]
    qn = q if metric != DistanceType.CosineExpanded else \
        q / np.linalg.norm(q, axis=1, keepdims=True)
    tol = 1e-5 * ((qn * qn).sum(1)[:, None]
                  + norm.numpy()[np.maximum(it, 0)])
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    assert (np.abs(dt[fin] - dj[fin]) <= tol[fin]).all()
    for r, c in np.argwhere(it != ij):
        pos = np.flatnonzero(ij[r] == it[r, c])
        other = dj[r, pos[0]] if pos.size else dt[r, c]
        assert abs(other - dj[r, c]) <= tol[r, c], (r, c)
    assert (it == ij).mean() >= 0.99


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
@pytest.mark.parametrize("order", ["probe", "list"])
@pytest.mark.parametrize("k", [32, 300])
def test_narrow_search_matches_jax(narrow_indexes, data, storage, metric,
                                   order, k):
    """k = 32 list-major is kernel 3's plain version, k = 300 kernel 4's
    and the merge; probe-major is plain torch on both sides (int8: the
    f32 queries unrounded there, rounded to bf16 in the kernels)."""
    jidx, tidx = narrow_indexes[storage, metric]
    assert tidx.lists_data.dtype == getattr(torch, storage)
    _, q = data
    before = (scan_op.launches, scan_op.launches_list)
    dj, ij, dt, it = _search_both(jidx, tidx, q, k, n_probes=4,
                                  scan_order=order)
    assert (scan_op.launches, scan_op.launches_list) == before
    assert it.shape == (NQ, k) and it.dtype == np.int32
    _assert_narrow_match(dt, dj, it, ij, q, tidx, metric)


def _narrow_lists(rng, storage, d, n_lists=12, max_list=70):
    """Random lists (an empty one, a short one, a full one) stored as
    ``storage`` by the JAX package's ``_quantize_lists``: (data, norms,
    ids, scale) as numpy / JAX arrays."""
    data_ = rng.normal(size=(n_lists, max_list, d)).astype(np.float32)
    sizes = rng.integers(0, max_list + 1, size=n_lists)
    sizes[0], sizes[1], sizes[2] = max_list, 0, 5
    ids = np.full((n_lists, max_list), -1, np.int32)
    nxt = 0
    for l, s in enumerate(sizes):
        ids[l, :s] = np.arange(nxt, nxt + s)
        nxt += s
    data_[ids < 0] = 0.0
    norms = (data_ ** 2).sum(-1).astype(np.float32)
    qd, qn, scale = jflat._quantize_lists(jnp.asarray(data_),
                                          jnp.asarray(norms), storage)
    return qd, qn, ids, scale


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("fused", [True, False])
def test_narrow_list_scans_plain_match_pallas(storage, metric, fused):
    """``fused_list_scan_plain`` (k = 10) and ``list_scan_plain`` (k =
    300, merged) on bf16 / int8 lists against the JAX Pallas kernels in
    interpret mode: ids identical, distances within 1e-5 of |q|^2 plus
    the largest norm."""
    from raft_tpu.ops.pallas_ivf_scan import ivf_list_scan_pallas
    rng = np.random.default_rng(len(storage) + 3 * fused)
    d, nq, n_probes, cap = 13, 40, 6, 32
    k = 10 if fused else 300
    qd, qn, ids, scale = _narrow_lists(rng, storage, d)
    n_lists = ids.shape[0]
    q = rng.normal(size=(nq, d)).astype(np.float32)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    dj, ij = ivf_list_scan_pallas(
        jnp.asarray(q), qd, qn, jnp.asarray(ids), jnp.asarray(probes), k,
        cap, scale=scale, bins=0, metric=metric, fused=fused)
    tq, tp = torch.from_numpy(q), torch.from_numpy(probes)
    td = tflat._list_rows(np.asarray(qd))
    tn, ti = torch.from_numpy(np.array(qn)), torch.from_numpy(ids)
    assert td.dtype == getattr(torch, storage)
    qmap, inv_pos = t_scan._invert_probes(tp, n_lists, cap)
    if fused:
        dt, it = scan_op.fused_list_scan(tq, td, tn, ti, tp, inv_pos, qmap,
                                         cap, k, 0, False, metric, scale)
    else:
        rb, _ = scan_op.resolve_bins(0, k, ids.shape[1])
        cd, ci = scan_op.list_scan(tq, td, tn, ti, qmap, rb, metric,
                                   scale=scale)
        dt, it = t_scan.merge_candidates(cd, ci, tp, inv_pos, k, False, cap)
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_array_equal(it[fin], ij[fin])
    tol = 1e-5 * ((q * q).sum(1).max() + float(np.asarray(qn).max()))
    assert (np.abs(dt[fin] - dj[fin]) <= tol).all()


@pytest.mark.parametrize("storage", STORAGES)
def test_quantize_lists_matches_jax(storage):
    """The same bucketed rows narrowed by both packages: codes (bf16 bit
    patterns, int8 values) and scale equal, norms within rtol 1e-6 (the
    same f32 squares summed in another order)."""
    rng = np.random.default_rng(21)
    data_ = (rng.normal(size=(9, 40, 24)) * 3).astype(np.float32)
    data_[2, 30:] = 0.0
    norms = (data_ ** 2).sum(-1).astype(np.float32)
    jd, jn, js = jflat._quantize_lists(jnp.asarray(data_),
                                       jnp.asarray(norms), storage)
    td, tn, ts = tflat._quantize_lists(torch.from_numpy(data_),
                                       torch.from_numpy(norms), storage)
    assert ts == js
    assert td.dtype == getattr(torch, storage)
    np.testing.assert_array_equal(td.view(torch.int16 if storage ==
                                          "bfloat16" else torch.int8)
                                  .numpy(),
                                  np.asarray(jd).view(np.int16 if storage
                                                      == "bfloat16"
                                                      else np.int8))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    # the narrowed norms are those of the stored rows
    deq = td.float() * (ts if storage == "int8" else 1.0)
    torch.testing.assert_close(tn, (deq * deq).sum(-1))


@pytest.mark.parametrize("storage", ["float32"] + STORAGES)
@pytest.mark.parametrize("metric,custom_ids", [
    (DistanceType.L2Expanded, False), (DistanceType.L2Expanded, True),
    (DistanceType.CosineExpanded, False)], ids=["l2", "l2-ids", "cosine"])
def test_extend_matches_jax(indexes, narrow_indexes, data, storage, metric,
                            custom_ids):
    """``extend`` of the same index by both packages: the same lists,
    ids and rows (int8: the scale recomputed over every row), norms
    within rtol 1e-6, and the same search results afterwards."""
    x, q = data
    if storage == "float32":
        jidx, tidx = indexes[metric]
    else:
        jidx, tidx = narrow_indexes[storage, metric]
    rng = np.random.default_rng(31)
    new = (rng.normal(size=(150, D)) * 2).astype(np.float32)
    new_ids = (np.arange(150, dtype=np.int32) * 7 + 50_000
               if custom_ids else None)
    je = jflat.extend(jidx, new, new_ids)
    te = tflat.extend(tidx, new, None if new_ids is None
                      else torch.from_numpy(new_ids))
    assert te.size == je.size == N + 150
    assert te.lists_data.dtype == tidx.lists_data.dtype
    assert te.scale == je.scale
    if storage == "int8" and metric == DistanceType.L2Expanded:
        assert te.scale != tidx.scale   # the larger new rows widen it
    np.testing.assert_array_equal(te.list_sizes.numpy(),
                                  np.asarray(je.list_sizes))
    np.testing.assert_array_equal(te.lists_indices.numpy(),
                                  np.asarray(je.lists_indices))
    got = _port_index(je).lists_data
    if metric == DistanceType.L2Expanded:
        assert torch.equal(te.lists_data, got)
    else:
        # the new rows are normalized by each package's own norm (an ulp
        # apart at most): the stored rows within one step of the storage
        a, b = te.lists_data.float(), got.float()
        step = {"float32": 1e-6 * b.abs() + 1e-7,
                "bfloat16": 2.0 ** -8 * b.abs(),
                "int8": torch.ones_like(b)}[storage]
        assert bool(((a - b).abs() <= step).all())
    np.testing.assert_allclose(te.lists_norms.numpy(),
                               np.asarray(je.lists_norms), rtol=1e-6,
                               atol=1e-6)
    if custom_ids:
        assert set(new_ids) <= set(te.lists_indices.reshape(-1).tolist())
    dj, ij, dt, it = _search_both(je, te, q, K, n_probes=4,
                                  scan_order="list")
    _assert_narrow_match(dt, dj, it, ij, q, te, metric)


@pytest.mark.parametrize("storage", STORAGES)
def test_narrow_save_roundtrip_both_directions(narrow_indexes, tmp_path,
                                               storage):
    """bf16 rows travel as uint16 bit patterns named in ``bf16_fields``,
    int8 rows as int8 with the scale in the meta, both ways."""
    jidx, tidx = narrow_indexes[storage, DistanceType.L2Expanded]
    fields = ("centers", "lists_data", "lists_indices", "lists_norms",
              "list_sizes")
    jpath = str(tmp_path / "from_jax.npz")
    jser.save_ivf_flat(jidx, jpath)
    loaded = tser.load_ivf_flat(jpath, device="cpu")
    tpath = str(tmp_path / "from_port")
    tser.save_ivf_flat(tidx, tpath)
    back = jser.load_ivf_flat(tpath)
    for f in fields:
        assert torch.equal(getattr(loaded, f), getattr(tidx, f)), f
        want = np.asarray(getattr(jidx, f))
        got = np.asarray(getattr(back, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert loaded.scale == back.scale == jidx.scale
    with np.load(tpath) as z:
        import json
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["bf16_fields"] == (["lists_data"]
                                       if storage == "bfloat16" else [])
        assert z["lists_data"].dtype == (np.uint16 if storage == "bfloat16"
                                         else np.int8)

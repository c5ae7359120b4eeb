"""Parity of the port's IVF-Flat (raft_tpu_torch) with the JAX package's.

A JAX-built index is saved with ``raft_tpu.neighbors.serialize`` and
loaded by the port, so search parity is free of k-means noise. The JAX
side runs its Pallas kernels in interpret mode; the port runs its plain
versions (CPU tensors). Tolerance: ids identical, distances within rtol
1e-5 / atol 1e-5.
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
                                N_LISTS, K)
    assert not tflat.use_list_order(tflat.SearchParams(n_probes=4), 32, 4,
                                    N_LISTS, K)


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
    with pytest.raises(NotImplementedError, match="storage_dtype"):
        tflat.build(x, tflat.IndexParams(n_lists=4,
                                         storage_dtype="bfloat16"),
                    device="cpu")
    _, tidx = indexes[DistanceType.L2Expanded]
    with pytest.raises(NotImplementedError, match="k=300"):
        tflat.search(tidx, q, 300, tflat.SearchParams(scan_order="list"))
    # "auto" keeps k > 256 on the probe-major route
    d, i = tflat.search(tidx, q, 300, tflat.SearchParams(n_probes=16))
    assert i.shape == (NQ, 300)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    x, _ = _data()
    with pytest.raises(LogicError, match="device='cpu'"):
        tflat.build(x, tflat.IndexParams(n_lists=4))
    with pytest.raises(LogicError, match="device='cpu'"):
        tflat.index_from_numpy({}, DistanceType.L2Expanded, 0)

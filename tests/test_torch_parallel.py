"""The port's algorithms over a mesh (``raft_tpu_torch.parallel``,
``cluster.kmeans_balanced.balanced_kmeans_sharded``) against the JAX
package, on its 8-device CPU mesh and the port's eight logical CPU ranks.

* ``distributed_knn`` (ring and allgather): ids equal to the JAX
  package's and to the exact scan's, distances within 1e-4;
* ``distributed_kmeans_fit`` from the same initial rows: centres within
  1e-4 of the JAX package's, the same iteration count;
* ``balanced_kmeans_sharded``: centres within 1e-4 of the JAX package's
  single-device trainer (its sharded trainer fails on this jax version)
  and of the port's own single-device trainer, from the same initial
  rows, on blobs where balancing rarely fires; bit-identical across two
  runs; its re-seed pool equal to the single-device trainer's choice on
  a stray group;
* the three sharded builds: each list's id set equal to the port's
  single-device bucketing of the rows by the built centres, every row
  in exactly one list;
* ``distributed_ivf_{flat,pq}_search`` at the f32 and int8 merges over
  the JAX package's own sharding of the same index (built by the port,
  handed over as numpy): ids equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu import parallel as jpar
from raft_tpu.cluster import kmeans_balanced as jkm
from raft_tpu.cluster.kmeans_types import KMeansParams as JKMeansParams
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.util.host_sample import sample_rows as jax_sample_rows
from raft_tpu_torch import parallel as tpar
from raft_tpu_torch.cluster import kmeans_balanced as tkm
from raft_tpu_torch.cluster.kmeans_types import KMeansParams
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import ivf_bq as tbq
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.brute_force import brute_force_knn

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(axis_names=("data",))


@pytest.fixture(scope="module")
def tm():
    m = tpar.make_mesh(devices=[CPU] * 8)
    yield m
    m.close()


def _blobs(n_blobs, per_blob, d, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n_blobs, d)).astype(np.float32) * spread
    lab = np.repeat(np.arange(n_blobs), per_blob)
    rng.shuffle(lab)
    return (c[lab] + rng.normal(size=(lab.size, d))).astype(np.float32)


@pytest.mark.parametrize("n,merge", [(2000, "ring"), (2000, "allgather"),
                                     (1003, "ring"), (1003, "allgather")])
def test_distributed_knn_ids_equal(jmesh, tm, n, merge):
    """Unit-scale rows: the expanded distances of the two packages agree
    to ~1e-6, below every gap between neighbours (on rows of norm ~50
    the expanded form's cancellation leaves ~1e-4, and the packages
    order such near-ties apart). On clustered rows of large norm the
    port is held to its own exact scan: the same distances, ids equal
    wherever a row's distances have no tie in f32 (the ring merges ties
    in ring order, the scan in id order)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    dj, ij = jpar.distributed_knn(x, q, 10, jmesh, merge=merge)
    dt, it = tpar.distributed_knn(x, q, 10, tm, merge=merge)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-4)
    xb = _blobs(10, n // 10 + 1, 16, 0)[:n]
    qb = xb[:50] + 0.01
    dt, it = tpar.distributed_knn(xb, qb, 10, tm, merge=merge)
    de, ie = brute_force_knn(torch.from_numpy(xb), torch.from_numpy(qb), 10,
                             DistanceType.L2SqrtExpanded, device="cpu")
    np.testing.assert_allclose(dt.numpy(), de.numpy(), rtol=1e-5)
    untied = np.array([len(set(r.tolist())) == r.size for r in dt.numpy()])
    np.testing.assert_array_equal(it.numpy()[untied], ie.numpy()[untied])


def test_distributed_kmeans_fit_matches_jax(jmesh, tm, monkeypatch):
    """From the same initial rows (both packages' ``sample_centroids``
    patched to them): centres within 1e-4, the same iteration count."""
    from raft_tpu.parallel import kmeans as jpk
    from raft_tpu_torch.cluster import kmeans as tkmeans
    x = _blobs(5, 800, 8, 3, spread=4.0)
    init = np.asarray(x[[3, 900, 1700, 2500, 3300]])
    monkeypatch.setattr(jpk, "sample_centroids",
                        lambda *a, **k: jnp.asarray(init))
    monkeypatch.setattr(tkmeans, "sample_centroids",
                        lambda *a, **k: torch.from_numpy(init))
    from raft_tpu.cluster.kmeans_types import InitMethod as JInit
    from raft_tpu_torch.cluster.kmeans_types import InitMethod
    cj, inj, itj = jpar.distributed_kmeans_fit(
        x, JKMeansParams(n_clusters=5, max_iter=50, seed=0,
                         init=JInit.Random), jmesh)
    ct, int_, itt = tpar.distributed_kmeans_fit(
        x, KMeansParams(n_clusters=5, max_iter=50, seed=0,
                        init=InitMethod.Random), tm)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-4)
    assert itt == itj
    np.testing.assert_allclose(float(int_), float(inj), rtol=1e-4)


def _sharded_init(monkeypatch, seed):
    """The port's sharded trainer's initial rows made the JAX package's
    draw (small ``n`` draws ``jax.random`` there)."""
    monkeypatch.setattr(
        tkm, "sample_rows",
        lambda n, m, s, device=None: torch.from_numpy(
            np.asarray(jax_sample_rows(n, m, s)).astype(np.int64)))


@pytest.mark.parametrize("seed,n_iters", [(0, 3), (1, 6)])
def test_balanced_kmeans_sharded_matches_single_device(tm, monkeypatch,
                                                       seed, n_iters):
    x = _blobs(8, 61, 16, seed)             # 488 rows: 61 a rank
    _sharded_init(monkeypatch, seed)
    cj = np.asarray(jkm.balanced_kmeans(x, 8, n_iters=n_iters, seed=seed))
    xt = torch.from_numpy(x)
    ct = tkm.balanced_kmeans_sharded(xt, 8, n_iters=n_iters, seed=seed,
                                     mesh=tm)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4)
    init = np.array(jax_sample_rows(x.shape[0], 8, seed))
    cs = tkm._train_from(xt, 8, n_iters=n_iters, seed=seed,
                         init_idx=torch.from_numpy(init))
    np.testing.assert_allclose(ct.numpy(), cs.numpy(), rtol=1e-4,
                               atol=1e-4)
    again = tkm.balanced_kmeans_sharded(xt, 8, n_iters=n_iters, seed=seed,
                                        mesh=tm)
    assert torch.equal(ct, again)


def test_balanced_kmeans_sharded_reseeds_like_single_device(tm):
    """A stray group of two rows (split over ranks, the pool's pad rows
    included) empties a cluster: the sharded re-seed picks the
    single-device trainer's row."""
    x = _blobs(4, 50, 8, 3)
    x = np.concatenate([x, x[:2] + 40.0, x[:1]]).astype(np.float32)
    xt = torch.from_numpy(x)
    init = torch.tensor([0, 1, 2, x.shape[0] - 2])
    single = tkm._train_from(xt, 4, n_iters=4, seed=0, init_idx=init)
    orig = tkm.sample_rows
    try:
        tkm.sample_rows = lambda n, m, s, device=None: init
        sharded = tkm.balanced_kmeans_sharded(xt, 4, n_iters=4, mesh=tm)
    finally:
        tkm.sample_rows = orig
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_balanced_kmeans_sharded_cached_plan_follows_n(tm, monkeypatch):
    """488 and then 485 rows give the same 61 rows a rank: the second
    call's centres equal a run of it alone with the plan cache cleared
    (the pad rows of the last rank stay out of its sums)."""
    x = torch.from_numpy(_blobs(8, 61, 16, 4))
    tkm._SHARDED_EM_PLANS.clear()
    tkm.balanced_kmeans_sharded(x, 8, n_iters=4, seed=2, mesh=tm)
    after = tkm.balanced_kmeans_sharded(x[:485], 8, n_iters=4, seed=2,
                                        mesh=tm)
    monkeypatch.setattr(tkm, "_SHARDED_EM_PLANS", {})
    alone = tkm.balanced_kmeans_sharded(x[:485], 8, n_iters=4, seed=2,
                                        mesh=tm)
    assert torch.equal(after, alone)
    init = tkm.sample_rows(485, 8, 2, CPU)
    single = tkm._train_from(x[:485], 8, n_iters=4, seed=2, init_idx=init)
    np.testing.assert_allclose(alone.numpy(), single.numpy(), rtol=1e-4,
                               atol=1e-4)


def _list_sets(index):
    ids = np.asarray(index.lists_indices)
    return [set(r[r >= 0].tolist()) for r in ids]


def _single_device_sets(x, centers, n_lists):
    lab = tkm.predict(torch.from_numpy(x), centers).numpy()
    return [set(np.nonzero(lab == li)[0].tolist()) for li in range(n_lists)]


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_sharded_build_lists_equal_single_device(tm, family):
    x = _blobs(16, 63, 16, 7, spread=3.0)   # 1008 rows: 126 a rank
    n = x.shape[0]
    if family == "flat":
        idx = tpar.sharded_ivf_flat_build(x, tflat.IndexParams(
            n_lists=16, kmeans_n_iters=4), mesh=tm)
    elif family == "pq":
        idx = tpar.sharded_ivf_pq_build(x, tpq.IndexParams(
            n_lists=16, kmeans_n_iters=4, pq_dim=8), mesh=tm)
    else:
        idx = tpar.sharded_ivf_bq_build(x, tbq.IndexParams(
            n_lists=16, kmeans_n_iters=4), mesh=tm)
    centers = idx.centers.gather("cpu")
    got, want = _list_sets(idx), _single_device_sets(x, centers, 16)
    assert got == want
    assert int(np.asarray(idx.list_sizes).sum()) == n
    assert sorted(i for s in got for i in s) == list(range(n))
    assert np.asarray(idx.list_sizes).tolist() == [len(s) for s in want]
    if family == "flat":
        # the stored rows are each id's own row, norms theirs
        data = np.asarray(idx.lists_data)
        ids = np.asarray(idx.lists_indices)
        ok = ids >= 0
        np.testing.assert_array_equal(data[ok], x[ids[ok]])
        np.testing.assert_allclose(np.asarray(idx.lists_norms)[ok],
                                   (x[ids[ok]] ** 2).sum(1), rtol=1e-5)
    if family == "pq":
        # each row's codes are the single-device encoder's
        ids = np.asarray(idx.lists_indices)
        ok = ids >= 0
        xt = torch.from_numpy(x)
        lab = tkm.predict(xt, centers).long()
        resid = (xt - centers[lab]) @ idx.rotation_matrix.T
        codes = tpq._encode(resid, idx.pq_centers).numpy()
        np.testing.assert_array_equal(np.asarray(idx.codes)[ok],
                                      codes[ids[ok]])


def _jax_flat(t):
    return jflat.Index(
        centers=jnp.asarray(t.centers.numpy()),
        lists_data=jnp.asarray(t.lists_data.numpy()),
        lists_indices=jnp.asarray(t.lists_indices.numpy()),
        lists_norms=jnp.asarray(t.lists_norms.numpy()),
        list_sizes=jnp.asarray(t.list_sizes.numpy()), metric=t.metric,
        size=t.size, scale=t.scale)


def _jax_pq(t):
    return jpq.Index(
        centers=jnp.asarray(t.centers.numpy()),
        centers_rot=jnp.asarray(t.centers_rot.numpy()),
        rotation_matrix=jnp.asarray(t.rotation_matrix.numpy()),
        pq_centers=jnp.asarray(t.pq_centers.numpy()),
        codes=jnp.asarray(t.codes.numpy()),
        lists_indices=jnp.asarray(t.lists_indices.numpy()),
        list_sizes=jnp.asarray(t.list_sizes.numpy()), metric=t.metric,
        pq_bits=t.pq_bits, size=t.size,
        codebook_kind=jpq.CodebookGen(int(t.codebook_kind)),
        code_norms=jnp.asarray(t.code_norms.numpy()))


@pytest.fixture(scope="module")
def data():
    x = _blobs(24, 84, 16, 11, spread=2.0)   # 2016 rows
    rng = np.random.default_rng(5)
    q = (x[rng.integers(0, x.shape[0], 48)]
         + rng.normal(size=(48, 16)).astype(np.float32) * 0.3)
    return x, q.astype(np.float32)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct])
@pytest.mark.parametrize("merge", ["f32", "int8"])
def test_distributed_ivf_flat_search_ids_equal_jax(jmesh, tm, data, metric,
                                                   merge):
    x, q = data
    t = tflat.build(x, tflat.IndexParams(n_lists=32, kmeans_n_iters=4,
                                         metric=metric), device="cpu")
    sp = tflat.SearchParams(n_probes=2)
    dt, it = tpar.distributed_ivf_flat_search(
        tpar.shard_ivf_flat(t, tm), q, 10, sp, mesh=tm, merge=merge)
    dj, ij = jpar.distributed_ivf_flat_search(
        jpar.shard_ivf_flat(_jax_flat(t), jmesh), q, 10,
        jflat.SearchParams(n_probes=2), mesh=jmesh, merge=merge)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("merge", ["f32", "int8"])
def test_distributed_ivf_pq_search_ids_equal_jax(jmesh, tm, data, merge):
    x, q = data
    t = tpq.build(x, tpq.IndexParams(n_lists=32, kmeans_n_iters=4,
                                     pq_dim=8), device="cpu")
    dt, it = tpar.distributed_ivf_pq_search(
        tpar.shard_ivf_pq(t, tm), q, 10, tpq.SearchParams(n_probes=2),
        mesh=tm, merge=merge)
    dj, ij = jpar.distributed_ivf_pq_search(
        jpar.shard_ivf_pq(_jax_pq(t), jmesh), q, 10,
        jpq.SearchParams(n_probes=2), mesh=jmesh, merge=merge)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-3)


def test_full_probe_equals_exact_and_gather(tm, data):
    """Probing every local list is an exhaustive search; a gathered
    sharded build is an ordinary index."""
    x, q = data
    idx = tpar.sharded_ivf_flat_build(x, tflat.IndexParams(
        n_lists=16, kmeans_n_iters=3), mesh=tm)
    d, i = tpar.distributed_ivf_flat_search(idx, q, 8, tflat.SearchParams(
        n_probes=2), mesh=tm)
    de, ie = brute_force_knn(torch.from_numpy(x), torch.from_numpy(q), 8,
                             DistanceType.L2Expanded, device="cpu")
    np.testing.assert_array_equal(i.numpy(), ie.numpy())
    g = tpar.gather_index(idx)
    d1, i1 = tflat.search(g, q, 8, tflat.SearchParams(n_probes=16,
                                                      scan_order="probe"))
    np.testing.assert_array_equal(i1.numpy(), ie.numpy())


def test_shard_requires_divisibility(tm):
    from raft_tpu_torch.core.error import LogicError
    idx = tflat.build(_blobs(4, 75, 8, 6), tflat.IndexParams(
        n_lists=12, kmeans_n_iters=2), device="cpu")
    with pytest.raises(LogicError):
        tpar.shard_ivf_flat(idx, tm)


def test_plan_cache_counters(tm, data):
    """A second search of one shape is a ``raft.parallel.plan.hits``
    hit and no miss (the JAX package's plan-cache counters)."""
    from raft_tpu_torch import obs
    x, q = data
    t = tflat.build(x, tflat.IndexParams(n_lists=16, kmeans_n_iters=2),
                    device="cpu")
    s = tpar.shard_ivf_flat(t, tm)
    tpar.distributed_ivf_flat_search(s, q, 5, mesh=tm)
    c0 = obs.snapshot()["counters"]
    tpar.distributed_ivf_flat_search(s, q, 5, mesh=tm)
    c1 = obs.snapshot()["counters"]
    assert c1.get("raft.parallel.plan.misses", 0) == \
        c0.get("raft.parallel.plan.misses", 0)
    assert c1["raft.parallel.plan.hits"] == \
        c0.get("raft.parallel.plan.hits", 0) + 1

"""Parity of the port's Lloyd k-means, clustering metrics and
single-linkage (raft_tpu_torch) with the JAX package's, on the CPU, from
the same numpy inputs.

Tolerances: k-means labels identical and centres within rtol/atol 1e-4
from the same initial rows (per-cluster sums reduce in another order:
the JAX ``segment_sum`` against the port's stable-sorted segment
reduction); inertias within rtol 1e-5. Clustering metrics within 1e-5
(silhouette at a matmul and an elementwise metric). Single-linkage
children and labels identical on both routes (the JAX package's MST runs
its native route where it is built; the port's numpy route gives the
same edges). k-means++ draws from another generator than the JAX
package's, so it is held to its properties: distinct rows of x, the same
rows at one seed, a cost no higher than a random init's on
well-separated blobs.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raft_tpu.cluster import kmeans as jkm
from raft_tpu.stats import clustering_metrics as jcm
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.stats import clustering_metrics as tcm
from raft_tpu_torch.util.host_sample import sample_rows_np

# the packages export the function under the module's name
jsl = importlib.import_module("raft_tpu.cluster.single_linkage")
tsl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _blobs(n_blobs, per_blob, d, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n_blobs, d)).astype(np.float32) * spread
    lab = np.repeat(np.arange(n_blobs), per_blob)
    rng.shuffle(lab)
    x = c[lab] + rng.normal(size=(lab.size, d)).astype(np.float32)
    return x.astype(np.float32), lab


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_fit(out_t, out_j, x):
    ct, it, nt = out_t
    cj, ij, nj = out_j
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(it), float(ij), rtol=1e-5)
    assert nt == int(nj)
    np.testing.assert_array_equal(
        tkm.predict(_t(x), ct).numpy(), np.asarray(jkm.predict(x, cj)))


# ---------------------------------------------------------------------
# Lloyd k-means

@pytest.mark.parametrize("seed,weighted,max_iter", [(0, False, 5),
                                                    (1, True, 20),
                                                    (2, False, 300)])
def test_fit_from_array_matches_jax(seed, weighted, max_iter):
    x, _ = _blobs(6, 50, 12, seed)
    c0 = x[sample_rows_np(x.shape[0], 6, seed)]
    w = (np.random.default_rng(seed).random(x.shape[0]).astype(np.float32)
         + 0.5) if weighted else None
    params = KMeansParams(n_clusters=6, init=InitMethod.Array,
                          max_iter=max_iter)
    jparams = jkm.KMeansParams(n_clusters=6, init=jkm.InitMethod.Array,
                               max_iter=max_iter)
    _check_fit(tkm.fit(_t(x), params, None if w is None else _t(w), _t(c0)),
               jkm.fit(x, jparams, w, c0), x)


def test_fit_random_at_jax_draw_matches_jax():
    # the JAX package draws its Random init from jax.random below 65536
    # rows: the port starts from those rows
    x, _ = _blobs(5, 60, 8, 3)
    jparams = jkm.KMeansParams(n_clusters=5, init=jkm.InitMethod.Random,
                               seed=4, max_iter=30)
    c0 = np.asarray(jkm.sample_centroids(x, 5, 4))
    _check_fit(tkm.fit(_t(x), KMeansParams(n_clusters=5, seed=4,
                                           max_iter=30), None, _t(c0)),
               jkm.fit(x, jparams), x)


def test_empty_cluster_reseeds_like_jax():
    # two identical initial centres: the second loses every tie and is
    # empty after the first assignment; both packages re-seed it from the
    # same highest-cost row
    x, _ = _blobs(4, 40, 6, 5)
    c0 = x[[0, 0, 1, 2]]
    params = KMeansParams(n_clusters=4, init=InitMethod.Array, max_iter=8)
    jparams = jkm.KMeansParams(n_clusters=4, init=jkm.InitMethod.Array,
                               max_iter=8)
    labels, _ = tkm._assign(_t(x), _t(c0))
    assert int((labels == 1).sum()) == 0
    _check_fit(tkm.fit(_t(x), params, None, _t(c0)),
               jkm.fit(x, jparams, None, c0), x)


def test_n_init_restarts_match_jax(monkeypatch):
    # both packages' Random draws from the numpy stream (the JAX one's
    # below 65536 rows from jax.random): n_init restarts at seed + trial
    # keep the same best trial
    x, _ = _blobs(4, 50, 6, 6, spread=3.0)

    def numpy_draw(x, n_clusters, seed=0, res=None):
        return jnp.asarray(np.asarray(x)[sample_rows_np(x.shape[0],
                                                        n_clusters, seed)])
    monkeypatch.setattr(jkm, "sample_centroids", numpy_draw)
    out_j = jkm.fit(x, jkm.KMeansParams(n_clusters=4, init=jkm.InitMethod
                                        .Random, n_init=4, seed=9,
                                        max_iter=3))
    out_t = tkm.fit(_t(x), KMeansParams(n_clusters=4, init=InitMethod.Random,
                                        n_init=4, seed=9, max_iter=3))
    _check_fit(out_t, out_j, x)
    trials = [float(tkm.fit(_t(x), KMeansParams(
        n_clusters=4, init=InitMethod.Random, seed=9 + t, max_iter=3))[1])
        for t in range(4)]
    assert float(out_t[1]) == min(trials)


def test_plus_plus_properties():
    x, _ = _blobs(8, 40, 10, 7, spread=20.0)
    xt = _t(x)
    a = tkm.init_plus_plus(xt, 8, seed=3)
    b = tkm.init_plus_plus(xt, 8, seed=3)
    assert torch.equal(a, b)
    rows = [int(np.flatnonzero((x == r).all(1))[0]) for r in a.numpy()]
    assert len(set(rows)) == 8
    pp = min(float(tkm.cluster_cost(xt, tkm.init_plus_plus(xt, 8, seed=s)))
             for s in range(3))
    rnd = min(float(tkm.cluster_cost(xt, tkm.sample_centroids(xt, 8, s)))
              for s in range(3))
    assert pp <= rnd
    c, inertia, n_iter = tkm.fit(xt, KMeansParams(n_clusters=8, seed=3))
    assert 1 <= n_iter <= 300 and torch.isfinite(inertia)
    assert torch.equal(tkm.fit(xt, KMeansParams(n_clusters=8, seed=3))[0], c)


def test_building_blocks_match_jax():
    x, _ = _blobs(5, 30, 8, 8)
    c = x[::31][:5]
    w = np.linspace(0.5, 2.0, x.shape[0]).astype(np.float32)
    xt, ct = _t(x), _t(c)
    np.testing.assert_array_equal(
        tkm.count_samples_in_cluster(xt, ct).numpy(),
        np.asarray(jkm.count_samples_in_cluster(x, c)))
    # expanded L2: the error scale is |x|^2 + |c|^2, not the distance
    lab = np.asarray(jkm.predict(x, c))
    scale = (x * x).sum(1) + (c * c).sum(1)[lab]
    diff = np.abs(tkm.min_cluster_distance(xt, ct).numpy()
                  - np.asarray(jkm.min_cluster_distance(x, c)))
    assert (diff <= 1e-5 * scale).all()
    for weights in (None, w):
        np.testing.assert_allclose(
            float(tkm.cluster_cost(xt, ct, None if weights is None
                                   else _t(weights))),
            float(jkm.cluster_cost(x, c, weights)), rtol=1e-5)
    full = (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
    t2 = tkm.transform(xt, ct).numpy().astype(np.float64) ** 2
    j2 = np.asarray(jkm.transform(x, c)).astype(np.float64) ** 2
    assert (np.abs(t2 - j2) <= 1e-5 * full).all()
    lt, ct2, it, nt = tkm.fit_predict(xt, KMeansParams(
        n_clusters=5, init=InitMethod.Random, seed=2))
    np.testing.assert_array_equal(lt.numpy(), tkm.predict(xt, ct2).numpy())
    assert tkm.sample_centroids(xt, 5, 2).shape == (5, 8)


# ---------------------------------------------------------------------
# clustering metrics

def _labelings(seed, n=300, k_true=5, k_pred=7):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, k_true, n).astype(np.int32)
    p = np.where(rng.random(n) < 0.7, t, rng.integers(0, k_pred, n))
    return t, p.astype(np.int32)


LABEL_METRICS = ("adjusted_rand_index", "rand_index", "mutual_info_score",
                 "homogeneity_score", "completeness_score", "v_measure")


@pytest.mark.parametrize("name", LABEL_METRICS)
@pytest.mark.parametrize("seed", [0, 1])
def test_label_metric_matches_jax(name, seed):
    t, p = _labelings(seed)
    got = float(getattr(tcm, name)(_t(t), _t(p)))
    want = float(getattr(jcm, name)(t, p))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_contingency_entropy_kl_ic_match_jax():
    t, p = _labelings(2)
    np.testing.assert_array_equal(
        tcm.contingency_matrix(_t(t), _t(p)).numpy(),
        np.asarray(jcm.contingency_matrix(t, p)))
    np.testing.assert_array_equal(
        tcm.contingency_matrix(_t(t), _t(p), 6, 9).numpy(),
        np.asarray(jcm.contingency_matrix(t, p, 6, 9)))
    np.testing.assert_allclose(float(tcm.entropy(_t(t))),
                               float(jcm.entropy(t)), rtol=1e-5)
    np.testing.assert_allclose(float(tcm.entropy(_t(t), 8)),
                               float(jcm.entropy(t, 8)), rtol=1e-5)
    np.testing.assert_allclose(float(tcm.v_measure(_t(t), _t(p), 0.5)),
                               float(jcm.v_measure(t, p, 0.5)), rtol=1e-5)
    rng = np.random.default_rng(3)
    a, b = rng.random(20).astype(np.float32), rng.random(20).astype(np.float32)
    a[::4] = 0.0
    np.testing.assert_allclose(float(tcm.kl_divergence(_t(a / a.sum()),
                                                       _t(b / b.sum()))),
                               float(jcm.kl_divergence(a / a.sum(),
                                                       b / b.sum())),
                               rtol=1e-5)
    ll = rng.normal(size=6).astype(np.float32) * 50
    for ic in tcm.InformationCriterion:
        np.testing.assert_allclose(
            tcm.information_criterion(_t(ll), ic, 7, 200).numpy(),
            np.asarray(jcm.information_criterion(
                ll, jcm.InformationCriterion(int(ic)), 7, 200)), rtol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cityblock"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_silhouette_matches_jax(metric, chunk):
    x, lab = _blobs(4, 45, 6, 11, spread=2.0)
    lab = lab.astype(np.int32)
    lab[:3] = 4  # a cluster of 3 beside the four blobs
    got = float(tcm.silhouette_score(_t(x), _t(lab), metric=metric,
                                     chunk=chunk))
    want = float(jcm.silhouette_score(x, lab, metric=metric, chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cityblock"])
def test_trustworthiness_matches_jax(metric):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(80, 10)).astype(np.float32)
    e = (x[:, :2] + 0.3 * rng.normal(size=(80, 2))).astype(np.float32)
    got = float(tcm.trustworthiness_score(_t(x), _t(e), 5, metric))
    want = float(jcm.trustworthiness_score(x, e, 5, metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# single-linkage

def _linkage_data(seed):
    # separate blobs near the origin: the kNN graph at small c falls into
    # components, so the cross-component fix-up runs; norms near the
    # distances keep the expanded L2's rounding far below the gaps
    # between merge heights
    x, _ = _blobs(5, 40, 6, seed, spread=3.0)
    c = x.mean(0)
    return ((x - c) * 0.3 + c * 0.3).astype(np.float32)


def _jax_numpy_route(monkeypatch):
    """The JAX package's numpy MST, dendrogram and cut (the route the
    port ports) in place of its native C++ one."""
    from raft_tpu.core import native
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_dendrogram", lambda *a: None)
    monkeypatch.setattr(native, "extract_flattened", lambda *a: None)


@pytest.mark.parametrize("route", ["PAIRWISE", "KNN_GRAPH"])
@pytest.mark.parametrize("seed,n_clusters,c", [(0, 5, 1), (1, 3, 15),
                                               (2, 12, 2)])
def test_single_linkage_matches_jax(route, seed, n_clusters, c, monkeypatch):
    x = _linkage_data(seed)
    lt, ct = tsl.single_linkage(_t(x), n_clusters,
                                tsl.LinkageDistance[route], c)
    # the JAX native route merges the same pairs, each pair maybe in the
    # other order
    _, cn = jsl.single_linkage(x, n_clusters, jsl.LinkageDistance[route], c)
    np.testing.assert_array_equal(np.sort(ct.numpy(), 1),
                                  np.sort(np.asarray(cn), 1))
    _jax_numpy_route(monkeypatch)
    lj, cj = jsl.single_linkage(x, n_clusters, jsl.LinkageDistance[route], c)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert len(np.unique(lt.numpy())) == n_clusters


def test_knn_graph_fix_up_matches_jax_rounds(monkeypatch):
    # the fix-up edges themselves: one per component, the same edge as
    # the JAX package's per-component numpy product
    _jax_numpy_route(monkeypatch)
    x = _linkage_data(3)
    k = 3
    s_t, d_t, w_t = tsl._mst_from_knn(_t(x), k)
    s_j, d_j, w_j = jsl._mst_from_knn(x, k)
    assert tsl.last_run["connect"], "the graph was connected"

    # the same edges in the same order; weights are square roots of
    # expanded L2, whose rounding is relative to the rows' norms
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-3)


def test_dendrogram_and_cut_match_jax(monkeypatch):
    _jax_numpy_route(monkeypatch)
    x = _linkage_data(4)
    s, d, w = tsl._mst_from_knn(_t(x), 20)
    got = tsl.build_dendrogram_host(s, d, w)
    want = jsl.build_dendrogram_host(s, d, w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    for n_clusters in (1, 4, 200):
        np.testing.assert_array_equal(
            tsl._extract_flattened(got[0], 200, n_clusters),
            np.asarray(jsl._extract_flattened(got[0], 200, n_clusters)))

"""The port's tiered device/host serving and host-memory IVF-Flat
(``raft_tpu_torch.neighbors.tiered``, ``.host_memory``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_tiered.py`` (all but the ``/healthz`` section and
``TestDoctorTransferBound``, which wait for the port's ``obs`` endpoint
family) and ``tests/test_neighbors.py::TestHostResidentIvf``. The same
numpy inputs go through both packages: the JAX package's IVF-Flat index
(4000 x 32 blobs, 32 lists) is built once and handed to the port through
``index_from_numpy``; each package tiers its copy.

* tiering never changes an answer: at ``hot_frac`` 1.0, 0.5, 0.25 and 0.0
  and after a demotion, the tiered ids equal the resident probe-order
  search's and the JAX package's tiered ids;
* the deterministic ``raft.tiered.*``, ``raft.plan.*`` and
  ``raft.ivf_scan.probes.*`` counter deltas (and the placement gauges)
  are equal across the packages (fetch and overlap seconds are wall
  times, and the CPU runs nothing asynchronously: overlap 0 here);
* the host-memory search, its fetch sizes and its builds against the
  JAX package's, the ``host_ivf_flat`` format both ways, the
  host-streaming rebuild fold, and the CPU's refusal of a default
  ``TieredConfig`` (no device memory stats to derive a budget from).

Tolerances: the port's tiered and host-memory ids identical to its
resident search's, distances within rtol/atol 1e-5; across the packages
distances within 2e-6 of ``|q|^2 + max |x|^2`` (the expanded-L2 form's
fp32 rounding, ~2e-4 at these norms) and ids identical but where two
rows are that near a tie (their exact distances to the query within the
same bound: the packages' sums round differently, and the resident
searches of the two packages already order such a pair differently).
Builds against the JAX package: list membership of >= 0.999 of the rows
(the packages' kernel 1 may split a near-tie). Counters are read from
``snapshot()``.
"""

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.mutate import compact as jcompact
from raft_tpu.neighbors import host_memory as jhm
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import serialize as jser
from raft_tpu.neighbors import tiered as jtiered
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.mutate import compact as tcompact
from raft_tpu_torch.neighbors import _ivf_scan as tscan
from raft_tpu_torch.neighbors import host_memory as thm
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.neighbors import tiered as ttiered

K = 10
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
# counters whose deltas do not depend on timing
DETERMINISTIC = ("raft.tiered.refresh.total", "raft.tiered.promotions.total",
                 "raft.tiered.demotions.total", "raft.tiered.search.total",
                 "raft.tiered.probes.hot", "raft.tiered.probes.cold",
                 "raft.tiered.fetch.bytes", "raft.plan.cache.misses",
                 "raft.plan.cache.hits", "raft.plan.build.total",
                 "raft.plan.search.total", "raft.plan.search.queries",
                 "raft.ivf_scan.probes.batches", "raft.ivf_scan.probes.mass")
GAUGES = ("raft.tiered.budget.bytes", "raft.tiered.hot.lists",
          "raft.tiered.hot.bytes", "raft.tiered.hit_rate")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _blobs(n, d, centers, std, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)).astype(np.float32) * 10.0
    return (c[rng.integers(0, centers, n)]
            + std * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def dataset():
    x = _blobs(4000, 32, 20, 2.0, 0)
    q = _blobs(64, 32, 20, 2.0, 0)[:64] + np.random.default_rng(1).normal(
        size=(64, 32)).astype(np.float32)
    return x, q


def _port(jidx):
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


@pytest.fixture(scope="module")
def built(dataset):
    """(the JAX index, the port's copy, params, the port's resident
    probe-order (dists, ids), the JAX package's)."""
    x, q = dataset
    jidx = jflat.build(x, jflat.IndexParams(n_lists=32, kmeans_n_iters=8))
    tidx = _port(jidx)
    jsp = jflat.SearchParams(n_probes=8, scan_order="probe")
    tsp = tflat.SearchParams(n_probes=8, scan_order="probe")
    d0, i0 = tflat.search(tidx, q, K, tsp)
    jd, ji = jflat.search(jidx, q, K, jsp)
    return jidx, tidx, (jsp, tsp), (d0.numpy(), i0.numpy()), \
        (np.asarray(jd), np.asarray(ji))


def _pair(built, **cfg):
    """``{pkg: TieredIndex}`` of one config over the same index."""
    jidx, tidx = built[:2]
    return {"jax": jtiered.from_index(jidx, jtiered.TieredConfig(**cfg)),
            "torch": ttiered.from_index(tidx, ttiered.TieredConfig(**cfg))}


def _plans(tis, built, q):
    jsp, tsp = built[2]
    return {"jax": jtiered.build_plan(tis["jax"], q, K, jsp),
            "torch": ttiered.build_plan(tis["torch"], q, K, tsp)}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scale(q, x):
    return (q * q).sum(1)[:, None] + float((x * x).sum(1).max())


def _close_across(d_a, d_b, q, x):
    assert (np.abs(_np(d_a) - _np(d_b)) <= 2e-6 * _scale(q, x)).all()


def _same_ids_across(i_a, i_b, q, x):
    """Ids equal, but where the two rows at a slot are a near-tie: their
    exact (float64) distances to the query within 2e-6 of the scale."""
    i_a, i_b = _np(i_a), _np(i_b)
    rows, cols = np.nonzero(i_a != i_b)
    assert len(rows) <= 0.01 * i_a.size
    tol = 2e-6 * _scale(q, x)[rows, 0]
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    da = ((x64[i_a[rows, cols]] - q64[rows]) ** 2).sum(1)
    db = ((x64[i_b[rows, cols]] - q64[rows]) ** 2).sum(1)
    assert (np.abs(da - db) <= tol).all()


def _csum(diff, name):
    return sum(v for k, v in diff.get("counters", {}).items()
               if k == name or k.startswith(name + "{"))


def _deltas(obs_mod, before):
    diff = obs_mod.snapshot_diff(before, obs_mod.snapshot())
    return {n: _csum(diff, n) for n in DETERMINISTIC}


def _gauges(obs_mod):
    g = obs_mod.snapshot()["gauges"]
    return {n: g.get(n) for n in GAUGES}


# ---------------------------------------------------------------------------
# parity: tiering never changes an answer (test_tiered.py::TestParity)
# ---------------------------------------------------------------------------


class TestParity:
    @pytest.mark.parametrize("hot_frac", [1.0, 0.5, 0.25, 0.0])
    def test_matches_resident_and_jax(self, dataset, built, hot_frac):
        x, q = dataset
        d0, i0 = built[3]
        tis = _pair(built, hot_frac=hot_frac)
        assert tis["torch"].hot_lists == tis["jax"].hot_lists
        out = {p: pl.search(q, block=True)
               for p, pl in _plans(tis, built, q).items()}
        np.testing.assert_array_equal(_np(out["torch"][1]), i0)
        np.testing.assert_allclose(_np(out["torch"][0]), d0, rtol=1e-5,
                                   atol=1e-5)
        _same_ids_across(out["torch"][1], out["jax"][1], q, x)
        _same_ids_across(built[4][1], i0, q, x)
        _close_across(out["torch"][0], out["jax"][0], q, x)

    def test_parity_survives_demotion(self, dataset, built):
        x, q = dataset
        d0, i0 = built[3]
        tis = _pair(built, hot_frac=0.5)
        plans = _plans(tis, built, q)
        for pl in plans.values():
            pl.search(q, block=True)
        reps = {p: ti.refresh(budget_bytes=4 * ti.bytes_per_list)
                for p, ti in tis.items()}
        assert reps["torch"]["demoted"] > 0
        assert reps["torch"] == reps["jax"]
        assert list(tis["torch"]._hot_ids) == list(tis["jax"]._hot_ids)
        d1, i1 = plans["torch"].search(q, block=True)
        np.testing.assert_array_equal(_np(i1), i0)
        np.testing.assert_allclose(_np(d1), d0, rtol=1e-5, atol=1e-5)
        _same_ids_across(i1, plans["jax"].search(q, block=True)[1], q, x)

    def test_batched_matches_plan_shape(self, dataset, built):
        x, q = dataset
        i0 = built[3][1]
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=0.5))
        plan = ttiered.build_plan(ti, q[:16], K, built[2][1])
        d1, i1 = plan.search_batched(q, block=True)
        np.testing.assert_array_equal(_np(i1), i0)
        d2, i2 = plan.search_batched(q[:40], block=True)
        np.testing.assert_array_equal(_np(i2), i0[:40])

    def test_cosine_and_inner_product(self, dataset):
        """The ip core (inner product, and cosine on normalized rows)
        through the tiers equals the resident probe-order search."""
        x, q = dataset
        for metric in ("InnerProduct", "CosineExpanded"):
            idx = tflat.build(x, tflat.IndexParams(
                n_lists=16, kmeans_n_iters=4,
                metric=tflat.DistanceType[metric]), device="cpu")
            sp = tflat.SearchParams(n_probes=6, scan_order="probe")
            d0, i0 = tflat.search(idx, q, K, sp)
            ti = ttiered.from_index(idx, ttiered.TieredConfig(hot_frac=0.5))
            d1, i1 = ttiered.build_plan(ti, q, K, sp).search(q, block=True)
            assert torch.equal(i1, i0), metric
            torch.testing.assert_close(d1, d0, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# serving contracts (test_tiered.py::TestServingContracts)
# ---------------------------------------------------------------------------


class TestServingContracts:
    def test_zero_steady_state_plan_builds(self, dataset, built):
        x, q = dataset
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=0.5))
        plan = ttiered.build_plan(ti, q, K, built[2][1])
        plan.search(q, block=True)
        before = tobs.snapshot()
        for _ in range(3):
            plan.search(q, block=True)
        ti.refresh()        # a refresh boundary is steady state too
        plan.search(q, block=True)
        d = _deltas(tobs, before)
        assert d["raft.plan.cache.misses"] == 0
        assert d["raft.plan.build.total"] == 0
        assert d["raft.plan.search.total"] == 4

    def test_plan_cache_hit(self, dataset, built):
        x, q = dataset
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=0.5))
        p1 = ttiered.build_plan(ti, q, K, built[2][1])
        before = tobs.snapshot()
        p2 = ttiered.build_plan(ti, q, K, built[2][1])
        d = _deltas(tobs, before)
        assert p1 is p2
        assert d["raft.plan.cache.hits"] == 1
        assert d["raft.plan.build.total"] == 0

    def test_budget_drop_demotes_and_gauges(self, built):
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=1.0))
        assert ti.hot_lists == ti.n_lists
        before = tobs.snapshot()
        rep = ti.refresh(budget_bytes=0)
        assert rep["hot_lists"] == 0 and rep["demoted"] == 32
        assert _deltas(tobs, before)["raft.tiered.demotions.total"] == 32
        g = _gauges(tobs)
        assert g["raft.tiered.budget.bytes"] == 0.0
        assert g["raft.tiered.hot.lists"] == 0.0

    def test_budget_raise_clamps_at_build_rung(self, built):
        ti = ttiered.from_index(built[1],
                                ttiered.TieredConfig(hot_frac=0.25))
        warm_lists = ti.hot_lists
        rep = ti.refresh(budget_bytes=ti.n_lists * ti.bytes_per_list)
        assert rep["hot_lists"] == warm_lists

    def test_fetch_and_overlap_counters(self, dataset, built):
        x, q = dataset
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=0.5))
        plan = ttiered.build_plan(ti, q, K, built[2][1])
        before = tobs.snapshot()
        plan.search(q, block=True)
        diff = tobs.snapshot_diff(before, tobs.snapshot())
        assert _csum(diff, "raft.tiered.probes.cold") > 0
        assert _csum(diff, "raft.tiered.fetch.bytes") > 0
        assert _csum(diff, "raft.tiered.fetch.seconds") > 0
        # nothing is asynchronous on the CPU: no fetch is hidden
        assert _csum(diff, "raft.tiered.overlap.seconds") == 0.0
        g = tobs.snapshot()["gauges"]
        assert 0.0 <= g["raft.tiered.hit_rate"] < 1.0
        assert g["raft.tiered.overlap.frac"] == 0.0

    def test_all_hot_does_not_fetch(self, dataset, built):
        x, q = dataset
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=1.0))
        plan = ttiered.build_plan(ti, q, K, built[2][1])
        before = tobs.snapshot()
        plan.search(q, block=True)
        d = _deltas(tobs, before)
        assert d["raft.tiered.probes.cold"] == 0
        assert d["raft.tiered.fetch.bytes"] == 0

    def test_ema_promotes_probed_lists(self, dataset, built):
        x, q = dataset
        tis = _pair(built, hot_frac=0.25)
        plans = _plans(tis, built, q)
        for pl in plans.values():
            pl.search(q, block=True)
        before = set(int(i) for i in tis["torch"]._hot_ids)
        for ti in tis.values():
            ti.refresh()
        after = set(int(i) for i in tis["torch"]._hot_ids)
        assert len(after) == len(before) == tis["torch"].hot_lists
        assert after == set(int(i) for i in tis["jax"]._hot_ids)

    def test_stage_chunks_and_pool(self, dataset, built):
        """Cold lists above ``max_stage_lists`` stage in several chunks
        (each merged on kernel 2's payload select), and the staging
        buffers of a rung are pooled across searches."""
        x, q = dataset
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(
            hot_frac=0.25, max_stage_lists=8))
        assert ti.stage_capacities == (8,)
        plan = ttiered.build_plan(ti, q, K, built[2][1])
        d1, i1 = plan.search(q, block=True)
        np.testing.assert_array_equal(_np(i1), built[3][1])
        pooled = ti._stage[8]["bufs"]
        plan.search(q, block=True)
        assert ti._stage[8]["bufs"] is pooled

    def test_default_config_needs_a_budget_on_the_cpu(self, built):
        with pytest.raises(LogicError, match="budget_bytes.*hot_frac"):
            ttiered.from_index(built[1])
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(
            budget_bytes=3 * ttiered.from_index(
                built[1], ttiered.TieredConfig(hot_frac=0.0)).bytes_per_list))
        assert ti.hot_lists == 0            # below the 8-list rung


class TestCountersAcrossPackages:
    def test_counter_deltas_and_gauges_equal(self, dataset, built):
        """One sequence through both packages: tier, plan (a miss and a
        hit), two searches, a refresh, a demotion, a search."""
        x, q = dataset
        out = {}
        for pkg, obs_mod, tmod, sp in (
                ("jax", jobs, jtiered, built[2][0]),
                ("torch", tobs, ttiered, built[2][1])):
            idx = built[0] if pkg == "jax" else built[1]
            before = obs_mod.snapshot()
            ti = tmod.from_index(idx, tmod.TieredConfig(
                hot_frac=0.5, max_stage_lists=16))
            plan = tmod.build_plan(ti, q, K, sp)
            assert tmod.build_plan(ti, q, K, sp) is plan
            plan.search(q, block=True)
            plan.search(q[::-1].copy(), block=True)
            ti.refresh()
            ti.refresh(budget_bytes=8 * ti.bytes_per_list)
            plan.search(q, block=True)
            out[pkg] = (_deltas(obs_mod, before), _gauges(obs_mod))
        assert out["torch"][0] == out["jax"][0]
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][0]["raft.tiered.fetch.bytes"] > 0


# ---------------------------------------------------------------------------
# probe stats (test_tiered.py::TestProbeStats)
# ---------------------------------------------------------------------------


class TestProbeStats:
    def test_histogram_orders_by_mass(self):
        st = tscan.ProbeStats()
        st.note(np.array([[0, 1], [1, 2], [1, 3]], np.int32))
        hist = st.histogram(4)
        assert hist[0] == (1, 3)
        assert dict(hist)[0] == 1
        st.reset()
        assert st.histogram(4) == []

    def test_bounded_like_jax(self):
        from raft_tpu.neighbors._ivf_scan import ProbeStats as JStats
        rng = np.random.default_rng(4)
        sts = (tscan.ProbeStats(bound=5), JStats(bound=5))
        for _ in range(20):
            p = rng.integers(0, 40, size=(6, 3))
            for st in sts:
                st.note(p)
        assert sts[0].histogram(50) == sts[1].histogram(50)
        assert len(sts[0].histogram(50)) <= 10

    def test_note_probes_counters_and_global(self):
        before = tobs.snapshot()
        tscan.note_probes(np.array([[4, 5, 5]], np.int32))
        d = _deltas(tobs, before)
        assert d["raft.ivf_scan.probes.batches"] == 1
        assert d["raft.ivf_scan.probes.mass"] == 3
        assert dict(tscan.probe_histogram(4096)).get(5, 0) >= 2

    def test_host_memory_exports_probe_mass(self, dataset, built):
        x, q = dataset
        h = thm.to_host(built[1])
        before = tobs.snapshot()
        thm.search(h, q, K, built[2][1])
        d = _deltas(tobs, before)
        assert d["raft.ivf_scan.probes.batches"] >= 1
        assert d["raft.ivf_scan.probes.mass"] == q.shape[0] * 8


# ---------------------------------------------------------------------------
# serving (test_tiered.py::TestServeIntegration)
# ---------------------------------------------------------------------------


class TestServeIntegration:
    def test_search_server_from_tiered(self, dataset, built):
        x, q = dataset
        i0 = built[3][1]
        ti = ttiered.from_index(built[1], ttiered.TieredConfig(hot_frac=0.5))
        srv = tserve.SearchServer.from_index(
            ti, q[:16], K, params=built[2][1],
            config=tserve.ServeConfig(batch_sizes=(1, 8, 32)))
        try:
            assert srv._quality_meta.get("family") == "tiered_ivf_flat"
            assert srv._quality_meta.get("device") == ti.device
            d1, i1 = srv.search(q[:8])
            np.testing.assert_array_equal(i1, i0[:8])
            futs = [srv.submit(q[r:r + 1]) for r in range(20)]
            got = np.concatenate([f.result(timeout=60)[1] for f in futs])
            np.testing.assert_array_equal(got, i0[:20])
        finally:
            srv.close()

    def test_served_like_jax(self, dataset, built):
        """Both packages' servers over a tiered index: the same ids, and
        the ladder's plans built up front (no plan built by serving)."""
        x, q = dataset
        tis = _pair(built, hot_frac=0.5)
        got = {}
        for pkg, serve_mod, obs_mod, sp in (
                ("jax", jserve, jobs, built[2][0]),
                ("torch", tserve, tobs, built[2][1])):
            srv = serve_mod.SearchServer.from_index(
                tis[pkg], q[:16], K, params=sp,
                config=serve_mod.ServeConfig(batch_sizes=(1, 8)))
            try:
                before = obs_mod.snapshot()
                got[pkg] = np.asarray(srv.search(q[:8])[1])
                d = _deltas(obs_mod, before)
                assert d["raft.plan.build.total"] == 0, pkg
            finally:
                srv.close()
        _same_ids_across(got["torch"], got["jax"], q[:8], x)


# ---------------------------------------------------------------------------
# host-memory IVF-Flat (test_neighbors.py::TestHostResidentIvf)
# ---------------------------------------------------------------------------


class TestHostResidentIvf:
    def test_matches_resident_and_jax(self, dataset, built):
        x, q = dataset
        d0, i0 = built[3]
        h = thm.to_host(built[1])
        assert isinstance(h.lists_data, np.ndarray)
        d1, i1 = thm.search(h, q, K, built[2][1])
        np.testing.assert_array_equal(_np(i1), i0)
        np.testing.assert_allclose(_np(d1), d0, rtol=1e-5, atol=1e-5)
        jd, ji = jhm.search(jhm.to_host(built[0]), q, K, built[2][0])
        _same_ids_across(i1, ji, q, x)
        _close_across(d1, jd, q, x)

    def test_fetch_sizes_like_jax(self, dataset, built, monkeypatch):
        x, q = dataset
        fetched = {"jax": [], "torch": []}
        orig = {"jax": jhm._fetch, "torch": thm._fetch}

        def spy(pkg):
            def f(a, *rest):
                if getattr(a, "ndim", 0) == 3:
                    fetched[pkg].append(a.shape[0])
                return orig[pkg](a, *rest)
            return f

        monkeypatch.setattr(jhm, "_fetch", spy("jax"))
        monkeypatch.setattr(thm, "_fetch", spy("torch"))
        hj, ht = jhm.to_host(built[0]), thm.to_host(built[1])
        for nq, n_probes in ((4, 4), (1, 3), (64, 8)):
            jhm.search(hj, q[:nq], 5, jflat.SearchParams(n_probes=n_probes))
            d, i = thm.search(ht, q[:nq], 5,
                              tflat.SearchParams(n_probes=n_probes))
            assert (_np(i) >= 0).all()
        assert fetched["torch"] == fetched["jax"]
        assert max(fetched["torch"][:1]) <= 16     # pow2(<= 4q x 4p) < 32

    def test_full_probe_exact(self, dataset, built):
        x, q = dataset
        d, i = thm.search(thm.to_host(built[1]), q, K,
                          tflat.SearchParams(n_probes=32))
        exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1,
                           kind="stable")[:, :K]
        assert np.mean([len(set(a) & set(b)) for a, b in
                        zip(_np(i), exact)]) / K > 0.999

    def test_batched_host_search(self, dataset, built, monkeypatch):
        import raft_tpu_torch.neighbors.ann_types as at
        x, q = dataset
        h = thm.to_host(built[1])
        sp = tflat.SearchParams(n_probes=16)
        d0, i0 = thm.search(h, q, 5, sp)
        monkeypatch.setattr(at, "MAX_QUERY_BATCH", 33)
        d1, i1 = thm.search(h, q, 5, sp)
        assert torch.equal(i0, i1)

    @pytest.mark.parametrize("storage", ["int8", "bfloat16"])
    def test_narrow_storage_host(self, storage):
        """int8 (dequantized by the scale) and bfloat16 rows (held on the
        host as their bit patterns) search like the resident index."""
        x = np.random.default_rng(42).random((600, 16)).astype(np.float32)
        idx = tflat.build(x, tflat.IndexParams(
            n_lists=8, kmeans_n_iters=4, storage_dtype=storage),
            device="cpu")
        h = thm.to_host(idx)
        assert isinstance(h.lists_data, np.ndarray)
        sp = tflat.SearchParams(n_probes=8, scan_order="probe")
        d, i = thm.search(h, x[:8], 1, sp)
        np.testing.assert_array_equal(_np(i)[:, 0], np.arange(8))
        d0, i0 = tflat.search(idx, x[:32], 4, sp)
        d1, i1 = thm.search(h, x[:32], 4, sp)
        assert torch.equal(i0, i1) and torch.equal(d0, d1)
        ti = ttiered.from_host(h, ttiered.TieredConfig(hot_frac=0.5))
        d2, i2 = ttiered.build_plan(ti, x[:32], 4, sp).search(x[:32],
                                                             block=True)
        assert torch.equal(i0, i2) and torch.equal(d0, d2)

    def test_streaming_build_matches_resident_membership(self, dataset):
        """With ``train_rows >= n`` the streaming build's trainer sees the
        resident build's trainset (fraction 1.0): the same lists, row for
        row, and chunking is invisible."""
        x, q = dataset
        params = tflat.IndexParams(n_lists=16, kmeans_n_iters=6,
                                   kmeans_trainset_fraction=1.0)
        res = tflat.build(x, params, device="cpu")
        s1 = thm.build_streaming([x[:700], x[700:2900], x[2900:]], params,
                                 device="cpu")
        s2 = thm.build_streaming([x], params, device="cpu")
        b1 = thm.build(x, params, chunk_rows=700, device="cpu")
        for h in (s1, s2, b1):
            assert h.size == len(x)
            np.testing.assert_array_equal(h.lists_indices,
                                          res.lists_indices.numpy())
            np.testing.assert_array_equal(h.lists_data,
                                          res.lists_data.numpy())
            np.testing.assert_allclose(h.lists_norms,
                                       res.lists_norms.numpy(), rtol=1e-5)
        sp = tflat.SearchParams(n_probes=16)
        assert torch.equal(thm.search(s1, q, K, sp)[1],
                           thm.search(b1, q, K, sp)[1])

    def test_builds_like_jax(self):
        """Above 65536 rows both packages draw their trainer's rows from
        one numpy stream: centres equal within 1e-4 of their scale, list
        membership on >= 0.999 of the rows (the streaming build's and
        the chunked build's)."""
        x = _blobs(70_000, 4, 8, 1.0, 2)
        chunks = [x[s:s + 30_000] for s in range(0, len(x), 30_000)]
        for jh, th in (
                (jhm.build(x, jflat.IndexParams(n_lists=8, kmeans_n_iters=2),
                           chunk_rows=20_000, train_rows=1 << 17),
                 thm.build(x, tflat.IndexParams(n_lists=8, kmeans_n_iters=2),
                           chunk_rows=20_000, train_rows=1 << 17,
                           device="cpu")),
                (jhm.build_streaming(chunks, jflat.IndexParams(
                    n_lists=8, kmeans_n_iters=2), train_rows=1 << 17),
                 thm.build_streaming(chunks, tflat.IndexParams(
                     n_lists=8, kmeans_n_iters=2), train_rows=1 << 17,
                     device="cpu"))):
            cj = np.asarray(jh.centers)
            np.testing.assert_allclose(th.centers.numpy(), cj, rtol=0,
                                       atol=1e-4 * np.abs(cj).max())
            lab_j = np.empty(len(x), np.int64)
            lab_t = np.empty(len(x), np.int64)
            for lab, h in ((lab_j, jh), (lab_t, th)):
                ids = np.asarray(h.lists_indices)
                lst = np.broadcast_to(np.arange(8)[:, None], ids.shape)
                lab[ids[ids >= 0]] = lst[ids >= 0]
            assert np.mean(lab_j == lab_t) >= 0.999
            assert th.size == jh.size == len(x)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_host_format_both_ways(self, dataset, built, tmp_path, writer):
        x, q = dataset
        p = str(tmp_path / "host.rtpu")
        h = {"jax": jhm.to_host(built[0]), "torch": thm.to_host(built[1])}
        (jser if writer == "jax" else tser).save(h[writer], p)
        back_t = tser.load(p, device="cpu")
        back_j = jser.load(p)
        assert isinstance(back_t, thm.HostIvfFlat)
        assert isinstance(back_t.lists_data, np.ndarray)
        for f in ("lists_data", "lists_norms", "lists_indices"):
            np.testing.assert_array_equal(getattr(back_t, f),
                                          np.asarray(getattr(back_j, f)))
        sp = tflat.SearchParams(n_probes=8)
        assert torch.equal(thm.search(back_t, q, 5, sp)[1],
                           thm.search(h["torch"], q, 5, sp)[1])

    def test_bf16_host_format_both_ways(self, tmp_path):
        x = np.random.default_rng(3).normal(size=(400, 8)).astype(np.float32)
        j = jhm.to_host(jflat.build(x, jflat.IndexParams(
            n_lists=4, kmeans_n_iters=2, storage_dtype="bfloat16")))
        p, p2 = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
        jser.save(j, p)
        t = tser.load(p, device="cpu")
        assert t.lists_data.dtype == np.uint16
        np.testing.assert_array_equal(
            t.lists_data, np.asarray(j.lists_data).view(np.uint16))
        tser.save(t, p2)
        back = jser.load(p2)
        np.testing.assert_array_equal(np.asarray(back.lists_data),
                                      np.asarray(j.lists_data))


# ---------------------------------------------------------------------------
# the host-streaming rebuild fold
# ---------------------------------------------------------------------------


def test_streaming_rebuild_fold_like_jax(dataset, built):
    """``fold(mode="rebuild", stream_chunk>0)``: both packages' folds
    hold every live row once (the tombstoned rows gone, the delta rows
    under their ids), and the port's recall@10 at 8 probes against the
    exact top-10 of the live corpus is within 0.01 of the JAX package's
    (their k-means draw other seeds below 65536 rows)."""
    x, q = dataset
    rng = np.random.default_rng(9)
    delta = rng.normal(size=(40, 32)).astype(np.float32) * 10.0
    delta_ids = np.arange(4000, 4040, dtype=np.int32)
    tombs = list(range(0, 400, 7))
    live = np.setdiff1d(np.arange(4000), tombs)
    corpus = np.concatenate([x[live], delta])
    corpus_ids = np.concatenate([live, delta_ids])
    exact = corpus_ids[np.argsort(((q[:, None] - corpus[None]) ** 2).sum(-1),
                                  axis=1, kind="stable")[:, :K]]
    recall = {}
    for pkg, cmod, fmod, idx in (("jax", jcompact, jflat, built[0]),
                                 ("torch", tcompact, tflat, built[1])):
        new = cmod.fold(idx, delta, delta_ids, tombs, mode="rebuild",
                        stream_chunk=512)
        ids = np.asarray(new.lists_indices)
        assert sorted(ids[ids >= 0].tolist()) == sorted(corpus_ids.tolist())
        assert new.size == len(corpus_ids)
        got = np.asarray(fmod.search(new, q, K, fmod.SearchParams(
            n_probes=8))[1])
        recall[pkg] = np.mean([len(set(a) & set(b))
                               for a, b in zip(got, exact)]) / K
    assert isinstance(new, tflat.Index) and new.device.type == "cpu"
    assert abs(recall["torch"] - recall["jax"]) <= 0.01


def test_refresh_racing_searches_keeps_answers(dataset, built):
    """A thread swaps the hot table (refreshes at alternating budgets)
    while 8 threads search through one plan, with a short switch
    interval: every result is the resident search's, and every thread
    finishes."""
    import sys
    import threading
    x, q = dataset
    i0 = built[3][1]
    ti = ttiered.from_index(built[1], ttiered.TieredConfig(
        hot_frac=0.5, max_stage_lists=8))
    plan = ttiered.build_plan(ti, q, K, built[2][1])
    stop, errors, bad = threading.Event(), [], []

    def refresher():
        j = 0
        try:
            while not stop.is_set():
                ti.refresh(budget_bytes=(8 + 8 * (j % 2)) * ti.bytes_per_list)
                j += 1
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    def searcher():
        try:
            for _ in range(4):
                if not np.array_equal(_np(plan.search(q, block=True)[1]),
                                      i0):
                    bad.append(1)
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ref = threading.Thread(target=refresher)
        workers = [threading.Thread(target=searcher) for _ in range(8)]
        ref.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        stop.set()
        ref.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not ref.is_alive() and not any(w.is_alive() for w in workers)
    assert not errors and not bad

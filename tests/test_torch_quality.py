"""The port's shadow-exact quality sampling (``raft_tpu_torch.obs.quality``,
``SearchServer.enable_quality``) and the registry's series cap against the
JAX package's (``tests/test_quality.py``), on the CPU.

* ``ExactScorer``: the same numpy corpus and queries through both
  packages' scorers; ids must be identical to each other and to a numpy
  brute force (random data: no near-ties at these sizes).
* ``QualityMonitor``: both packages' monitors take one fake scorer and
  the same offers; ``stats()``, every ``raft.obs.quality.*`` gauge of the
  test's family and every ``raft.obs.quality.*`` counter delta but the
  count of shadow batches (which depends on thread timing) must be equal
  (the port's registry quotes label values, so they are compared
  unquoted). Both draw from ``random.Random(seed)``, so the reservoir and
  the thinning keep the same samples.
* Serving: a CPU IVF-Flat index behind the port's ``SearchServer``.

Counters and gauges are read from ``snapshot()``, never registered here
under a literal name (graftlint GL010/GL011 scan ``tests/``).
"""

import importlib

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.obs import quality as jquality
from raft_tpu.obs import registry as jregistry
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.distance.distance_types import DistanceType as TDT
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import quality as tquality
from raft_tpu_torch.obs import registry as tregistry

# the module, not the logger singleton that raft_tpu_torch.core exports
tlogger = importlib.import_module("raft_tpu_torch.core.logger")
QUALITY = "raft.obs.quality."


# ---------------------------------------------------------------------------
# ExactScorer
# ---------------------------------------------------------------------------


def _scorers(corpus, metric="L2Expanded", **kw):
    """The JAX package's scorer and the port's (on the CPU) over one
    corpus."""
    return (jquality.ExactScorer(corpus, metric=JDT[metric], **kw),
            tquality.ExactScorer(corpus, metric=TDT[metric], device="cpu",
                                 **kw))


def _numpy_topk(corpus, q, k, kind):
    if kind == "l2":
        d = ((q[:, None, :].astype(np.float64)
              - corpus[None, :, :].astype(np.float64)) ** 2).sum(-1)
    else:
        if kind == "cos":
            corpus = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = -(q.astype(np.float64) @ corpus.T.astype(np.float64))
    return np.argsort(d, axis=1, kind="stable")[:, :k]


class TestExactScorer:
    def test_ids_equal_jax_and_numpy_across_chunks(self):
        """300 rows in chunks of 64 (a ragged last chunk of pad rows) and
        13 queries in batches of 8: the tiling is invisible."""
        rng = np.random.default_rng(0)
        corpus = rng.normal(size=(300, 24)).astype(np.float32)
        q = rng.normal(size=(13, 24)).astype(np.float32)
        js, ts = _scorers(corpus, kmax=10, chunk=64, batch=8)
        got = ts.topk(q, 7)
        assert got.dtype == np.int64 and got.shape == (13, 7)
        np.testing.assert_array_equal(got, js.topk(q, 7))
        np.testing.assert_array_equal(got, _numpy_topk(corpus, q, 7, "l2"))
        assert not ts.sampled and ts.rows == 300

    def test_inner_product_order(self):
        rng = np.random.default_rng(1)
        corpus = rng.normal(size=(200, 16)).astype(np.float32)
        q = rng.normal(size=(9, 16)).astype(np.float32)
        js, ts = _scorers(corpus, "InnerProduct", kmax=12, chunk=64,
                          batch=4)
        got = ts.topk(q, 12)
        np.testing.assert_array_equal(got, js.topk(q, 12))
        np.testing.assert_array_equal(got, _numpy_topk(corpus, q, 12, "ip"))
        # the reference's planted case: the largest dot product first
        small = np.asarray([[1.0, 0.0], [0.0, 1.0], [3.0, 3.0],
                            [-5.0, -5.0]], np.float32)
        js, ts = _scorers(small, "InnerProduct", kmax=4, chunk=4, batch=2)
        one = np.asarray([[1.0, 1.0]], np.float32)
        np.testing.assert_array_equal(ts.topk(one, 2), js.topk(one, 2))
        assert ts.topk(one, 2)[0, 0] == 2 and 3 not in ts.topk(one, 2)[0]

    def test_cosine_normalises(self):
        rng = np.random.default_rng(2)
        corpus = (rng.normal(size=(150, 8))
                  * rng.uniform(0.1, 10.0, size=(150, 1))).astype(np.float32)
        q = rng.normal(size=(6, 8)).astype(np.float32) * 7.0
        js, ts = _scorers(corpus, "CosineExpanded", kmax=5, chunk=32,
                          batch=4)
        got = ts.topk(q, 5)
        np.testing.assert_array_equal(got, js.topk(q, 5))
        np.testing.assert_array_equal(got, _numpy_topk(corpus, q, 5, "cos"))
        small = np.asarray([[10.0, 0.0], [0.0, 1.0], [0.7, 0.7]], np.float32)
        js, ts = _scorers(small, "CosineExpanded", kmax=3, chunk=4, batch=2)
        one = np.asarray([[0.1, 0.1]], np.float32)
        assert ts.topk(one, 1)[0, 0] == js.topk(one, 1)[0, 0] == 2

    def test_custom_ids_ride_through(self):
        rng = np.random.default_rng(3)
        corpus = rng.normal(size=(100, 8)).astype(np.float32)
        ids = rng.permutation(100) * 7 + 1000
        js, ts = _scorers(corpus, kmax=6, chunk=32, batch=4, ids=ids)
        q = corpus[[5, 50, 99]] + 1e-3
        got = ts.topk(q, 6)
        np.testing.assert_array_equal(got, js.topk(q, 6))
        np.testing.assert_array_equal(got[:, 0], ids[[5, 50, 99]])

    def test_bounded_sample_scores_the_same_rows(self):
        """Past max_rows both packages score the same seeded sample: the
        same ids, each one a row of the sample."""
        rng = np.random.default_rng(4)
        corpus = rng.normal(size=(600, 8)).astype(np.float32)
        js, ts = _scorers(corpus, kmax=4, max_rows=128, chunk=64, batch=4,
                          seed=3)
        assert ts.sampled and js.sampled and ts.rows == js.rows == 128
        q = rng.normal(size=(10, 8)).astype(np.float32)
        got = ts.topk(q, 4)
        np.testing.assert_array_equal(got, js.topk(q, 4))
        sel = np.sort(np.random.default_rng(3).choice(600, 128,
                                                      replace=False))
        assert set(got.ravel()) <= set(sel)
        np.testing.assert_array_equal(
            got, sel[_numpy_topk(corpus[sel], q, 4, "l2")])


# ---------------------------------------------------------------------------
# QualityMonitor: both packages on one fake scorer and the same offers
# ---------------------------------------------------------------------------


class _FakeScorer:
    """Exact ids are always 0..k-1."""

    def topk(self, queries, k):
        return np.tile(np.arange(k, dtype=np.int64),
                       (np.asarray(queries).shape[0], 1))


def _served(k, hits):
    """One served id row with exactly ``hits`` of the exact top-k."""
    row = np.arange(k, dtype=np.int64)
    row[hits:] = 10_000 + np.arange(k - hits)
    return row[None, :]


_Q = np.zeros((1, 4), np.float32)
PKGS = {"jax": (jquality, jobs), "torch": (tquality, tobs)}


def _unquoted(series):
    return series.replace('"', "")


def _gauges(snap, family):
    return {_unquoted(k): v for k, v in snap["gauges"].items()
            if k.startswith(QUALITY) and f"family={family}" in _unquoted(k)}


def _counter_deltas(before, after):
    out = {}
    for snap, sign in ((after, 1), (before, -1)):
        for series, v in snap["counters"].items():
            if series.startswith(QUALITY):
                key = _unquoted(series)
                out[key] = out.get(key, 0.0) + sign * v
    return {k: v for k, v in out.items() if v}


class _Both:
    """One monitor of each package over one fake scorer; each call goes
    to both, each read asserts they agree."""

    def __init__(self, family, rate=1.0, estimator=None, start=True, **cfg):
        kw = dict(window=64, min_window=4, drift_budget=0.1, poll_ms=5.0)
        kw.update(cfg)
        self.family = family
        self.before = {p: o.snapshot() for p, (_, o) in PKGS.items()}
        self.mons = {p: q.QualityMonitor(
            _FakeScorer(), sample_rate=rate, family=family,
            estimator=estimator, start=start,
            config=q.QualityConfig(**kw)) for p, (q, _) in PKGS.items()}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for m in self.mons.values():
            m.close()

    def offer(self, *args, **kw):
        for m in self.mons.values():
            m.offer(*args, **kw)

    def note_epoch(self, epoch):
        for m in self.mons.values():
            m.note_epoch(epoch)

    def drain(self):
        for m in self.mons.values():
            assert m.drain(30.0)

    def stats(self):
        s = {p: m.stats() for p, m in self.mons.items()}
        assert s["torch"] == s["jax"]
        return s["torch"]

    def gauges(self):
        g = {p: _gauges(o.snapshot(), self.family)
             for p, (_, o) in PKGS.items()}
        assert g["torch"] == g["jax"]
        return g["torch"]

    def counters(self):
        """The counter deltas, equal but for ``shadow.total``: it counts
        shadow batches, and how the offers split into batches depends on
        when each shadow thread wakes."""
        c = {p: _counter_deltas(self.before[p], o.snapshot())
             for p, (_, o) in PKGS.items()}
        batches = f"{QUALITY}shadow.total{{family={self.family}}}"
        n = {p: c[p].pop(batches, 0) for p in c}
        assert c["torch"] == c["jax"]
        samples = c["torch"].get(f"{QUALITY}samples.total", 0)
        assert all(0 < v <= samples for v in n.values()) or not samples
        return c["torch"]


class TestQualityMonitor:
    def test_planted_recall_value(self):
        """2 samples at 7/10 and 9/10 overlap → windowed recall 0.8."""
        with _Both("t_planted") as b:
            b.offer(_Q, _served(10, 7), 10)
            b.offer(_Q, _served(10, 9), 10)
            b.drain()
            assert b.stats()["recall"] == pytest.approx(0.8)
            g = b.gauges()
            assert g["raft.obs.quality.recall{epoch=0,family=t_planted}"] \
                == pytest.approx(0.8)
            c = b.counters()
            assert c["raft.obs.quality.samples.total"] == 2
            assert c["raft.obs.quality.sampled.total"] == 2

    def test_window_roll_over(self):
        """window=4: 4 full-recall then 4 half-recall samples → only the
        last 4 count."""
        with _Both("t_window", window=4) as b:
            for _ in range(4):
                b.offer(_Q, _served(10, 10), 10)
            for _ in range(4):
                b.offer(_Q, _served(10, 5), 10)
            b.drain()
            st = b.stats()
            assert st["recall"] == pytest.approx(0.5) and st["window"] == 4
            b.gauges()
            b.counters()

    def test_coverage_attribution(self):
        """Partial-coverage samples land in their own series, the excluded
        shards named, and never touch the full-coverage window."""
        with _Both("t_cov") as b:
            b.offer(_Q, _served(10, 10), 10)
            b.offer(_Q, _served(10, 2), 10, coverage=0.75, excluded="1,3")
            b.drain()
            assert b.stats()["recall"] == pytest.approx(1.0)
            g = b.gauges()
            assert g["raft.obs.quality.recall{coverage=partial,epoch=0,"
                     "excluded=1,3,family=t_cov}"] == pytest.approx(0.2)

    def test_calibration_gap(self):
        """An estimator returning 6/10 of the exact set while serving
        returns 10/10 → calibration gap 0.4."""
        def est(q, k):
            return np.tile(np.concatenate([np.arange(6),
                                           10_000 + np.arange(k - 6)]),
                           (np.asarray(q).shape[0], 1))
        with _Both("t_cal", estimator=est, window=16, min_window=2) as b:
            for _ in range(3):
                b.offer(_Q, _served(10, 10), 10)
            b.drain()
            st = b.stats()
            assert st["estimator_recall"] == pytest.approx(0.6)
            assert st["calibration_gap"] == pytest.approx(0.4)
            assert b.gauges()["raft.obs.quality.calibration.gap"
                              "{family=t_cal}"] == pytest.approx(0.4)

    def test_drift_fires_exactly_past_budget(self):
        """Budget 0.1 over an epoch-0 baseline of 1.0: an epoch-1 window
        at 0.9 (drift equal to the budget) does not fire; at 0.85 it
        fires once, however many samples follow."""
        with _Both("t_drift", min_window=4, drift_budget=0.1) as b:
            for _ in range(4):
                b.offer(_Q, _served(10, 10), 10, epoch=0)
            b.drain()
            b.note_epoch(1)
            for _ in range(4):
                b.offer(_Q, _served(10, 9), 10, epoch=1)
            b.drain()
            st = b.stats()
            assert st["drift"] == pytest.approx(0.1)
            assert st["drift_alarm"] is False
            assert "raft.obs.quality.drift.total{family=t_drift}" \
                not in b.counters()
            for _ in range(4):
                b.offer(_Q, _served(10, 8), 10, epoch=1)
            b.drain()
            st = b.stats()
            assert st["drift"] == pytest.approx(0.15)
            assert st["drift_alarm"] is True
            assert b.gauges()["raft.obs.quality.drift.alarm"
                              "{family=t_drift}"] == 1.0
            b.offer(_Q, _served(10, 8), 10, epoch=1)
            b.drain()
            assert b.counters()[
                "raft.obs.quality.drift.total{family=t_drift}"] == 1.0

    def test_epoch_rolls_implicitly_from_samples(self):
        """A sample tagged with a newer epoch rolls the baseline without a
        note_epoch call."""
        with _Both("t_roll", min_window=2) as b:
            for _ in range(2):
                b.offer(_Q, _served(10, 10), 10, epoch=0)
            b.drain()
            b.offer(_Q, _served(10, 5), 10, epoch=3)
            b.offer(_Q, _served(10, 5), 10, epoch=3)
            b.drain()
            st = b.stats()
            assert st["epoch"] == 3 and st["drift"] == pytest.approx(0.5)
            g = b.gauges()
            assert g["raft.obs.quality.recall{epoch=3,family=t_roll}"] == 0.5
            assert g["raft.obs.quality.recall{epoch=0,family=t_roll}"] == 1.0

    def test_reservoir_bounds_pending(self):
        """max_pending=8 of 50 offers: both reservoirs keep the same 8
        samples (one seeded stream) and count 42 evictions."""
        q = np.arange(50 * 4, dtype=np.float32).reshape(50, 4)
        ids = np.tile(np.arange(10, dtype=np.int64), (50, 1))
        with _Both("t_rsv", start=False, max_pending=8) as b:
            b.offer(q, ids, 10)
            kept = {p: [r[0][0] for r in m._pending]
                    for p, m in b.mons.items()}
            assert len(kept["torch"]) == 8 and kept["torch"] == kept["jax"]
            assert b.counters()["raft.obs.quality.evicted.total"] == 42

    def test_sample_rate_thins(self):
        """Rate 0.2 at seed 7 over 1000 offers: the same queries sampled,
        about a fifth of them."""
        q = np.arange(1000 * 4, dtype=np.float32).reshape(1000, 4)
        ids = np.tile(np.arange(10, dtype=np.int64), (1000, 1))
        with _Both("t_thin", rate=0.2, start=False, max_pending=4096,
                   seed=7) as b:
            b.offer(q, ids, 10)
            kept = {p: [r[0][0] for r in m._pending]
                    for p, m in b.mons.items()}
            assert kept["torch"] == kept["jax"]
            assert 120 <= len(kept["torch"]) <= 300
            assert b.counters()["raft.obs.quality.sampled.total"] == \
                len(kept["torch"])


# ---------------------------------------------------------------------------
# Serving: a CPU IVF-Flat index behind the port's SearchServer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_setup():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(12, 16)).astype(np.float32) * 4
    x = (c[rng.integers(0, 12, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 12, 64)]
         + rng.normal(size=(64, 16))).astype(np.float32)
    index = tflat.build(x, tflat.IndexParams(n_lists=8, kmeans_n_iters=3),
                        device="cpu")
    return x, q, index


def _server(index, q, rate, n_probes):
    return tserve.SearchServer.from_index(
        index, q[:16], 8, params=tflat.SearchParams(n_probes=n_probes),
        config=tserve.ServeConfig(batch_sizes=(1, 4, 16),
                                  quality_sample_rate=rate))


class TestServingIntegration:
    def test_rate_zero_attaches_nothing(self, served_setup):
        x, q, index = served_setup
        srv = _server(index, q, 0.0, 8)
        try:
            before = tobs.snapshot()
            assert srv.enable_quality(x) is None
            assert srv.quality is None
            srv.search(q[:1])
            assert not _counter_deltas(before, tobs.snapshot())
        finally:
            srv.close()

    @pytest.mark.parametrize("n_probes", [8, 2])
    def test_monitor_recall_is_served_recall(self, served_setup, n_probes):
        """Rate 1.0: every served query is sampled; the monitor's recall
        is the recall of the served ids against the scorer's exact ids
        (1.0 at every probe, below it at 2 of 8)."""
        x, q, index = served_setup
        srv = _server(index, q, 1.0, n_probes)
        try:
            mon = srv.enable_quality(x, qconfig=tquality.QualityConfig(
                window=256, shadow_batch=8, poll_ms=5.0))
            assert mon is srv.quality and mon.family == "ivf_flat"
            assert mon.scorer.device.type == "cpu"
            assert mon.scorer.metric == index.metric
            before = tobs.snapshot()
            served = np.concatenate([srv.search(q[s:s + 1])[1]
                                     for s in range(32)])
            assert mon.drain(30.0)
            exact = mon.scorer.topk(q[:32], 8)
            want = np.mean([len(set(served[r]) & set(exact[r])) / 8
                            for r in range(32)])
            st = mon.stats()
            assert st["samples"] == 32
            assert st["recall"] == round(float(want), 4)
            if n_probes == 8:
                assert st["recall"] == 1.0
            deltas = _counter_deltas(before, tobs.snapshot())
            assert deltas["raft.obs.quality.samples.total"] == 32
            assert "raft.obs.quality.errors.total" not in deltas
        finally:
            srv.close()
        assert not mon._thread

    def test_serve_config_validates_rate(self):
        for ns in (jserve, tserve):
            with pytest.raises(ValueError):
                ns.ServeConfig(quality_sample_rate=1.5)
            with pytest.raises(ValueError):
                ns.ServeConfig(quality_sample_rate=-0.1)
            assert ns.ServeConfig(quality_sample_rate=0.5) \
                .quality_sample_rate == 0.5

    def test_corpus_from_index_reads_the_lists(self, served_setup):
        """The IVF-Flat lists give back every row under its id, as the JAX
        package reads a JAX index."""
        x, _, index = served_setup
        rows, ids = tquality.corpus_from_index(index)
        assert rows.dtype == np.float32 and ids.dtype == np.int64
        assert sorted(ids.tolist()) == list(range(len(x)))
        np.testing.assert_array_equal(rows, x[ids])


# ---------------------------------------------------------------------------
# The registry's series cap
# ---------------------------------------------------------------------------


class TestSeriesCap:
    def test_cardinality_error_past_the_cap(self, monkeypatch):
        monkeypatch.setenv("RAFT_TPU_METRICS_MAX_SERIES", "3")
        assert tregistry._env_max_series() == 3
        monkeypatch.setattr(tregistry, "max_series",
                            tregistry._env_max_series())
        for i in range(3):
            tregistry.gauge("raft.test.cap", label=str(i)).set(i)
        with pytest.raises(tobs.CardinalityError):
            tregistry.gauge("raft.test.cap", label="3")
        tregistry.gauge("raft.test.cap", label="0").set(5.0)  # existing
        assert tobs.snapshot()["gauges"]["raft.test.cap{label=0}"] == 5.0
        assert issubclass(tobs.CardinalityError, RuntimeError)

    def test_monitor_swallows_the_cap_once_with_a_warning(self,
                                                         monkeypatch):
        """Room for one more recall series: epoch 0's lands, epochs 1 and
        2 hit the cap; both packages keep scoring, warn once and publish
        the same gauges."""
        name = "raft.obs.quality.recall"
        # one more series than the family holds now, in each registry
        tfam = tregistry.REGISTRY._families.get(name)
        monkeypatch.setattr(tregistry, "max_series",
                            (len(tfam.children) if tfam else 0) + 1)
        fam = jregistry.REGISTRY._families.get(name)
        monkeypatch.setattr(jregistry.REGISTRY, "max_series",
                            (len(fam.children) if fam else 0) + 1)
        records = []
        tlogger.set_callback(lambda lvl, msg: records.append((lvl, msg)))
        try:
            with _Both("t_cap", min_window=1) as b:
                for epoch in range(3):
                    b.offer(_Q, _served(10, 10), 10, epoch=epoch)
                    b.drain()
                assert b.stats()["epoch"] == 2
                g = b.gauges()
                assert g["raft.obs.quality.recall{epoch=0,family=t_cap}"] \
                    == 1.0
                assert not any(k.startswith(name) and "epoch=1" in k
                               for k in g)
                assert "raft.obs.quality.errors.total" not in b.counters()
                assert all(m._card_warned for m in b.mons.values())
        finally:
            tlogger.set_callback(None)
        warned = [m for lvl, m in records
                  if lvl == tlogger.WARN and "cardinality cap hit" in m]
        assert len(warned) == 1

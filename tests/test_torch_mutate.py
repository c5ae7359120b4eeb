"""The port's mutable indexes (``raft_tpu_torch.mutate``) against the JAX
package's (``tests/test_mutate.py``), on the CPU.

The same numpy inputs go through both packages: the JAX package's index
(its Pallas kernels in interpret mode) is built once and handed to the
port through ``index_from_numpy``, then both ``MutableIndex`` wrappers
take the same upserts, deletes and re-upserts. Tolerances:

* search results: ids identical, distances within rtol 1e-5 / atol 1e-5
  (for L2SqrtExpanded their squares: the expanded form's fp32 rounding,
  ~1e-6 of |q|^2 + |x|^2, grows past 1e-5 under the square root of a
  distance near 0, as of an upserted row queried by its own vector);
* ``stats()``, every ``raft.mutate.*`` gauge and every ``raft.mutate.*``
  counter delta: equal;
* after a fold: ids equal on >= 0.999 of the entries for IVF-Flat and
  >= 0.99 for IVF-PQ (both packages re-label the delta rows with their
  own kernel 1 and encode them with their own arithmetic, so a near-tie
  may land in another list);
* rebuild mode: recall against the exact truth of the live corpus within
  0.01 of the JAX package's (the packages' k-means draw other seeds).

Three traps of the port are held here too: a purged index's plan cache
(a plan built on it must not serve the old epoch's lists), a tombstone
at bit 31 of its word (the bitmap is int32 on the device), and a purged
list with holes (a list's live rows are not its first ``list_sizes``).

Counters and gauges are read from ``snapshot()``, never registered here
under a literal name (graftlint GL010/GL011 scan ``tests/``).
"""

import dataclasses
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import mutate as jmutate
from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.distance.distance_types import DistanceType as JDT
from raft_tpu.mutate import compact as jcompact
from raft_tpu.mutate import program as jprogram
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import serialize as jser
from raft_tpu.obs import quality as jquality
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.mutate import compact as tcompact
from raft_tpu_torch.mutate import program as tprogram
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import plan as tplan
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.obs import quality as tquality
from raft_tpu_torch.testing import faults as tfaults

K = 5
N, DIM = 2000, 16
CAPS = (64, 256)
MUTATE = "raft.mutate."
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
PQ_FIELDS = ("centers", "centers_rot", "rotation_matrix", "pq_centers",
             "codes", "lists_indices", "list_sizes")
PKGS = {
    "jax": types.SimpleNamespace(mutate=jmutate, obs=jobs, serve=jserve,
                                 faults=jfaults, flat=jflat, pq=jpq,
                                 ser=jser, compact=jcompact,
                                 quality=jquality),
    "torch": types.SimpleNamespace(mutate=tmutate, obs=tobs, serve=tserve,
                                   faults=tfaults, flat=tflat, pq=tpq,
                                   ser=tser, compact=tcompact,
                                   quality=tquality),
}


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((16, DIM)).astype(np.float32)
    new = rng.standard_normal((40, DIM)).astype(np.float32)
    return x, q, new


_JAX_FLAT = {}


def _jax_flat(x, metric="L2Expanded"):
    """The JAX package's IVF-Flat index over ``x`` (16 lists), one per
    metric for the module."""
    if metric not in _JAX_FLAT:
        _JAX_FLAT[metric] = jflat.build(x, jflat.IndexParams(
            n_lists=16, kmeans_n_iters=4, metric=JDT[metric]))
    return _JAX_FLAT[metric]


def _port_flat(jidx):
    """The port's copy of a JAX IVF-Flat index, on the CPU (fresh
    caches every call)."""
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


def _pair(jidx, tidx=None, caps=CAPS, n_probes=16, k=K):
    """``{pkg: MutableIndex}`` over one index."""
    tidx = _port_flat(jidx) if tidx is None else tidx
    idx = {"jax": jidx, "torch": tidx}
    out = {}
    for p, ns in PKGS.items():
        params = ns.flat if isinstance(idx[p], (jflat.Index, tflat.Index)) \
            else ns.pq
        out[p] = ns.mutate.MutableIndex(
            idx[p], k=k, params=params.SearchParams(n_probes=n_probes),
            config=ns.mutate.MutateConfig(delta_capacities=caps))
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _search(ms, q):
    """``{pkg: (dists, ids)}`` as numpy."""
    out = {}
    for p, m in ms.items():
        d, i = m.search(q, block=True)
        out[p] = (_host(d), _host(i))
    return out


def _assert_same(res):
    (jd, ji), (td, ti) = res["jax"], res["torch"]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def _exact(db, ids, q, k, kind="l2"):
    """Exact top-k ids over an id-labelled corpus (float64)."""
    db, q = db.astype(np.float64), q.astype(np.float64)
    if kind == "l2":
        s = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    else:
        s = -(q @ db.T)
    return np.asarray(ids)[np.argsort(s, axis=1, kind="stable")[:, :k]]


def _mutate_state(snap):
    return {k: v for k, v in snap["gauges"].items() if k.startswith(MUTATE)}


def _deltas(before, after, prefix=MUTATE):
    out = {}
    for snap, sign in ((after, 1), (before, -1)):
        for series, v in snap["counters"].items():
            if series.startswith(prefix):
                key = series.replace('"', "")
                out[key] = out.get(key, 0.0) + sign * v
    return {k: v for k, v in out.items() if v}


def _same_config(ns):
    """The params and config :func:`_pair` wraps with, for a load."""
    return dict(params=ns.flat.SearchParams(n_probes=16),
                config=ns.mutate.MutateConfig(delta_capacities=CAPS))


def _misses(before, after):
    d = _deltas(before, after, "raft.plan.")
    return (d.get("raft.plan.cache.misses", 0.0)
            + d.get("raft.plan.build.total", 0.0))


def _sequence_step(m, q, new, victims, step):
    """Step ``step`` of the parity tests' mutation sequence → what the
    call returned: upserts, deletes of main and delta rows, re-upserts
    of a main id and a delta id, a delete of an id that never
    existed."""
    if step == 0:
        return m.upsert(new[:12])
    if step == 1:
        return m.upsert(q[:4] + 0.001)
    if step == 2:
        return m.delete(list(victims) + [N + 3])
    if step == 3:
        return m.upsert(new[12:14], ids=[7, N + 5])
    return m.delete([10 ** 6])


# ---------------------------------------------------------------------------
# semantics against the JAX package
# ---------------------------------------------------------------------------


class TestParity:
    def test_wrap_without_mutations(self, data):
        """A fresh wrap serves the main index: both packages alike, and at
        every probe the exact top-k."""
        x, q, _ = data
        jidx = _jax_flat(x)
        for n_probes in (16, 4):
            ms = _pair(jidx, n_probes=n_probes)
            res = _search(ms, q)
            _assert_same(res)
            if n_probes == 16:
                np.testing.assert_array_equal(
                    res["torch"][1], _exact(x, np.arange(N), q, K))
            assert ms["torch"].stats() == ms["jax"].stats()

    @pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                        "InnerProduct", "CosineExpanded"])
    def test_mutation_sequence(self, data, metric):
        """Upserts, deletes and re-upserts: after each step the same ids,
        distances within 1e-5, the same stats; then every raft.mutate.*
        gauge and counter delta equal."""
        x, q, new = data
        jidx = _jax_flat(x, metric)
        before = {p: ns.obs.snapshot() for p, ns in PKGS.items()}
        ms = _pair(jidx, n_probes=8)
        victims = _search(ms, q[5:7])["jax"][1][:, 0]
        outs = {}
        for p, m in ms.items():
            steps = []
            rets = []
            for step in range(5):
                rets.append(_host(_sequence_step(m, q, new, victims, step)))
                d, i = m.search(q, block=True)
                steps.append((_host(d), _host(i), m.stats()))
            outs[p] = (rets, steps, _mutate_state(PKGS[p].obs.snapshot()),
                       _deltas(before[p], PKGS[p].obs.snapshot()))
        jr, js, jg, jc = outs["jax"]
        tr, ts, tg, tc = outs["torch"]
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a, b)
        power = 2 if metric == "L2SqrtExpanded" else 1
        for (td, ti, tst), (jd, ji, jst) in zip(ts, js):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(td ** power, jd ** power, rtol=1e-5,
                                       atol=1e-5)
            assert tst == jst
        assert tg == jg
        assert tc == jc
        # the upserts near the first queries are their nearest rows
        # (InnerProduct aside: a longer row can outscore them)
        if metric != "InnerProduct":
            assert list(ts[-1][1][:4, 0]) == [N + 12, N + 13, N + 14,
                                              N + 15]
        live = ts[-1][1]
        assert not np.isin(live, list(victims) + [N + 3]).any()

    def test_delta_full_is_explicit(self, data):
        """The top rung full: DeltaFullError in both, nothing applied, the
        overflow counter and the stalled gauge alike."""
        x, q, new = data
        before = {p: ns.obs.snapshot() for p, ns in PKGS.items()}
        ms = _pair(_jax_flat(x), caps=(8, 16))
        for p, m in ms.items():
            m.upsert(new[:16])
            with pytest.raises(PKGS[p].mutate.DeltaFullError):
                m.upsert(q[:1])
        assert ms["torch"].stats() == ms["jax"].stats()
        assert ms["torch"].stats()["delta_used"] == 16
        _assert_same(_search(ms, q))
        state = {p: (_mutate_state(ns.obs.snapshot()),
                     _deltas(before[p], ns.obs.snapshot()))
                 for p, ns in PKGS.items()}
        assert state["torch"] == state["jax"]
        assert state["torch"][0]["raft.mutate.delta.stalled"] == 1.0
        assert state["torch"][1]["raft.mutate.delta.overflow.total"] == 1.0


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _agreement(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


class TestCompaction:
    @pytest.mark.parametrize("n_probes,floor", [(16, 1.0), (4, 0.999)])
    def test_fold_flat(self, data, n_probes, floor):
        """A fold after the mutation sequence: the epoch, the stats and
        the gauges alike; ids equal to the JAX package's on >= 0.999 of
        the entries (all of them with every list probed), and no deleted
        id left in the new lists."""
        x, q, new = data
        jidx = _jax_flat(x)
        ms = _pair(jidx, n_probes=n_probes)
        victims = _search(ms, q[5:7])["jax"][1][:, 0]
        for m in ms.values():
            for step in range(5):
                _sequence_step(m, q, new, victims, step)
            live = m.size
            assert m.compact()
            assert m.epoch == 1 and int(m.index.size) == live
        assert ms["torch"].stats() == ms["jax"].stats()
        res = _search(ms, q)
        assert _agreement(res["torch"][1], res["jax"][1]) >= floor
        for m in ms.values():
            lists = _host(m.index.lists_indices)
            lists = lists[lists >= 0]
            assert not np.isin(lists, list(victims) + [N + 3]).any()
            assert (lists == 7).sum() == 1 and (lists == N + 5).sum() == 1
        # the delta rows sit in the same lists in both packages
        jl, tl = (_host(ms[p].index.lists_indices) for p in ("jax", "torch"))
        same = np.mean([set(jl[r][jl[r] >= 0]) == set(tl[r][tl[r] >= 0])
                        for r in range(jl.shape[0])])
        assert same >= 0.9

    def test_fold_pq(self, data):
        """IVF-PQ: the port's copy of the JAX package's index folds the
        same delta rows; ids equal on >= 0.99 of the entries."""
        x, q, new = data
        jidx = jpq.build(x, jpq.IndexParams(n_lists=8, pq_dim=8,
                                            kmeans_n_iters=2))
        tidx = tpq.index_from_numpy(
            {f: np.asarray(getattr(jidx, f)) for f in PQ_FIELDS},
            int(jidx.metric), jidx.size, jidx.pq_bits,
            int(jidx.codebook_kind), device="cpu")
        ms = _pair(jidx, tidx, caps=(64,), n_probes=8)
        res0 = _search(ms, q)
        assert _agreement(res0["torch"][1], res0["jax"][1]) >= 0.99
        victim = int(res0["jax"][1][4][0])
        for m in ms.values():
            ids = m.upsert(q[:2])
            m.delete([victim])
            assert m.compact()
            assert int(ids[0]) == N
        res = _search(ms, q)
        assert _agreement(res["torch"][1], res["jax"][1]) >= 0.99
        for p in ms:
            got = res[p][1]
            assert got[0][0] == N and victim not in got[4]

    def test_rebuild_mode(self, data):
        """Rebuild: both re-train on the live corpus; each package's
        recall against its exact truth within 0.01 of the other's."""
        x, q, new = data
        ms = _pair(_jax_flat(x), n_probes=4)
        for m in ms.values():
            m.upsert(new[:20])
            m.delete(list(range(0, 200, 3)))
            assert m.compact(mode="rebuild")
            assert m.stats()["tombstones"] == 0
        live = np.ones(N, bool)
        live[0:200:3] = False
        db = np.concatenate([x[live], new[:20]])
        lid = np.concatenate([np.arange(N)[live], np.arange(N, N + 20)])
        truth = _exact(db, lid, q, K)
        res = _search(ms, q)
        rec = {p: np.mean([len(set(res[p][1][r]) & set(truth[r])) / K
                           for r in range(len(q))]) for p in ms}
        assert rec["torch"] >= rec["jax"] - 0.01, rec
        assert not np.isin(res["torch"][1], np.arange(0, 200, 3)).any()

    def test_mutations_during_fold_survive(self, data, monkeypatch):
        """Mutations that land while the fold runs (after its snapshot,
        before the swap) survive it, alike in both packages."""
        x, q, _ = data
        ms = _pair(_jax_flat(x))
        landed = {}
        for p, ns in PKGS.items():
            real = ns.compact.fold
            m = ms[p]

            def fold(*a, _real=real, _m=m, _p=p, **kw):
                out = _real(*a, **kw)
                landed[_p] = (_host(_m.upsert(q[2:4] + 0.001)),
                              _m.delete([N]))
                return out

            monkeypatch.setattr(ns.compact, "fold", fold)
        for p, m in ms.items():
            ids0 = m.upsert(q[:2] + 0.001)
            assert m.compact()
            assert list(_host(ids0)) == [N, N + 1]
        assert landed["torch"][1] == landed["jax"][1] == 1
        res = _search(ms, q)
        _assert_same(res)
        got = res["torch"][1]
        assert N not in got[0]
        assert got[1][0] == N + 1
        assert list(got[2:4, 0]) == list(landed["torch"][0])
        assert ms["torch"].stats() == ms["jax"].stats()


# ---------------------------------------------------------------------------
# serving, quality and faults
# ---------------------------------------------------------------------------


def _served(ns, m, q, **cfg):
    return ns.serve.SearchServer.from_index(
        m, q[:8], k=K, config=ns.serve.ServeConfig(
            batch_sizes=(1, 8), max_wait_ms=0.5, **cfg))


class TestServing:
    def test_through_a_compaction(self, data):
        """Searches keep succeeding while a background compaction runs;
        a mixed window without one prepares no program."""
        x, q, _ = data
        m = _pair(_jax_flat(x))["torch"]
        srv = _served(PKGS["torch"], m, q)
        comp = tmutate.Compactor(m, poll_ms=5.0)
        fails, done = [0], [0]
        stop = threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                try:
                    srv.search(q[i % 16:i % 16 + 1], timeout=30)
                    done[0] += 1
                except Exception:
                    fails[0] += 1
                i += 1

        threads = [threading.Thread(target=client) for _ in range(3)]
        try:
            for t in threads:
                t.start()
            before = tobs.snapshot()
            rng = np.random.default_rng(4)
            for _ in range(6):
                ids = m.upsert(rng.standard_normal((4, DIM)).astype(
                    np.float32))
                m.delete(ids[:1])
                time.sleep(0.02)
            after = tobs.snapshot()
            assert _misses(before, after) == 0
            assert "raft.mutate.compact.total" not in _deltas(before, after)
            epoch0 = m.epoch
            comp.trigger()
            deadline = time.time() + 60
            while m.epoch == epoch0 and time.time() < deadline:
                time.sleep(0.01)
            assert m.epoch == epoch0 + 1
            time.sleep(0.05)
            # after the swap: the warmed epoch prepares nothing either
            before = tobs.snapshot()
            time.sleep(0.05)
            assert _misses(before, tobs.snapshot()) == 0
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
            comp.close()
            srv.close()
        assert not any(t.is_alive() for t in threads)
        assert fails[0] == 0 and done[0] > 0

    def test_batcher_matches_direct_and_jax(self, data):
        """The server's results equal a direct search, and the JAX
        package's server's."""
        x, q, _ = data
        ms = _pair(_jax_flat(x))
        res = {}
        for p, m in ms.items():
            m.upsert(q[:2] + 0.001)
            m.delete([3])
            srv = _served(PKGS[p], m, q)
            try:
                d_s, i_s = srv.search(q[:4])
                d_d, i_d = m.search(q[:4], block=True)
                np.testing.assert_array_equal(_host(i_s), _host(i_d))
                np.testing.assert_allclose(_host(d_s), _host(d_d),
                                           rtol=1e-5)
                res[p] = (_host(d_s), _host(i_s))
            finally:
                srv.close()
        _assert_same(res)

    def test_from_index_checks(self, data):
        x, q, _ = data
        m = _pair(_jax_flat(x))["torch"]
        with pytest.raises(Exception, match="MutableIndex k"):
            tserve.SearchServer.from_index(m, q[:8], k=3)
        with pytest.raises(Exception, match="search params"):
            tserve.SearchServer.from_index(
                m, q[:8], k=K, params=tflat.SearchParams())

    def test_quality_epoch_rolls_on_compaction(self, data):
        """With quality sampling on, a compaction rolls the monitor's
        epoch through the listener in both packages, and samples served
        afterwards are tagged with the new epoch."""
        x, q, _ = data
        ms = _pair(_jax_flat(x))
        stats = {}
        for p, m in ms.items():
            srv = _served(PKGS[p], m, q, quality_sample_rate=1.0)
            try:
                qcfg = PKGS[p].quality.QualityConfig(
                    window=64, shadow_batch=4, poll_ms=5.0)
                mon = srv.enable_quality(x, qconfig=qcfg)
                srv.search(q[:1])
                assert mon.drain(30.0)
                assert mon.stats()["epoch"] == 0
                m.upsert(q[:2] + 0.001)
                assert m.compact()
                assert mon.stats()["epoch"] == 1
                for r in range(3):
                    srv.search(q[r:r + 1])
                assert mon.drain(30.0)
                stats[p] = mon.stats()
            finally:
                srv.close()
        assert stats["torch"] == stats["jax"]
        assert stats["torch"]["window"] == 3

    def test_kill_compactor_then_recover(self, data):
        """Two injected compaction failures, then success: the same
        counter deltas in both packages, the epoch rolled once."""
        x, _, new = data
        ms = _pair(_jax_flat(x), caps=(8, 16))
        deltas = {}
        for p, ns in PKGS.items():
            m = ms[p]
            m.upsert(new[:8])
            assert m.should_compact()
            before = ns.obs.snapshot()
            with ns.faults.kill_compactor(times=2):
                comp = ns.mutate.Compactor(m, poll_ms=2.0,
                                           fail_threshold=2,
                                           backoff_mult=1.0,
                                           max_backoff_s=0.01)
                try:
                    deadline = time.time() + 60
                    while m.epoch == 0 and time.time() < deadline:
                        time.sleep(0.01)
                finally:
                    comp.close()
            after = ns.obs.snapshot()
            assert m.epoch == 1
            deltas[p] = (_deltas(before, after),
                         _deltas(before, after, "raft.testing."),
                         after["gauges"]["raft.mutate.compactor.failing"])
        assert deltas["torch"] == deltas["jax"]
        assert deltas["torch"][0]["raft.mutate.compactor.errors"] == 2.0
        assert deltas["torch"][2] == 0.0

    def test_fail_transfer_keeps_the_previous_snapshot(self, data):
        """A failed host-to-device refresh: the caller sees the fault,
        search keeps the previous snapshot, the next mutation repairs
        the view; alike in both packages."""
        x, q, _ = data
        ms = _pair(_jax_flat(x))
        seen = {}
        for p, ns in PKGS.items():
            m = ms[p]
            before = ns.obs.snapshot()
            with ns.faults.fail_transfer(1):
                with pytest.raises(ns.faults.FaultError):
                    m.upsert(q[:1] + 0.001)
            stale = _host(m.search(q[:1], block=True)[1])
            m.delete([10 ** 6])
            fresh = _host(m.search(q[:1], block=True)[1])
            seen[p] = (stale, fresh, _deltas(before, ns.obs.snapshot()))
        for a, b in zip(seen["torch"], seen["jax"]):
            if isinstance(a, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
        assert N not in seen["torch"][0] and seen["torch"][1][0][0] == N
        assert seen["torch"][2]["raft.mutate.transfer.errors"] == 1.0


# ---------------------------------------------------------------------------
# the port's traps
# ---------------------------------------------------------------------------


class TestTraps:
    def test_purged_index_gets_a_fresh_plan_cache(self, data):
        """A plan built on a purged index must score the purged lists: a
        plan cache shared with the old epoch would hand back the old
        plan, whose closure holds the old lists (deleted rows
        included)."""
        x, q, _ = data
        idx = _port_flat(_jax_flat(x))
        params = tflat.SearchParams(n_probes=16)
        p0 = tplan.build_plan(idx, q[:8], K, params)
        victims = _host(p0.search(q[:8], block=True)[1])[:, 0]
        purged, n = tcompact.purge(idx, victims)
        assert n == len(set(victims.tolist()))
        p1 = tplan.build_plan(purged, q[:8], K, params)
        assert p1 is not p0
        got = _host(p1.search(q[:8], block=True)[1])
        assert not np.isin(got, victims).any()
        live = np.setdiff1d(np.arange(N), victims)
        np.testing.assert_array_equal(got, _exact(x[live], live, q[:8], K))
        # the old index's plan still serves the old lists
        assert (_host(p0.search(q[:8], block=True)[1])[:, 0]
                == victims).all()

    def test_tombstone_at_bit_31(self, data):
        """The device bitmap is int32 holding the uint32 bits: every bit
        of a word, bit 31 among them, in a word with other bits set,
        reads as the JAX package's; end to end, deleted ids at bit 31 of
        their words never come back."""
        dead_ids = [0, 1, 31, 32, 62, 63, 95, 66]
        words = np.zeros(3, np.uint32)
        for i in dead_ids:
            words[i >> 5] |= np.uint32(1 << (i & 31))
        ids = np.arange(-1, 96, dtype=np.int32)
        want = (ids < 0) | np.isin(ids, dead_ids)
        got = tprogram._tombstone_dead(torch.from_numpy(ids),
                                       torch.from_numpy(words.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jprogram._tombstone_dead(
            jnp.asarray(ids), jnp.asarray(words))), want)
        x, _, _ = data
        ms = _pair(_jax_flat(x))
        for m in ms.values():
            assert m.delete([31, 63, 1023]) == 3
        # each deleted row queried as itself: found before, gone now
        res = _search(ms, x[[31, 63, 1023]])
        _assert_same(res)
        assert not np.isin(res["torch"][1], [31, 63, 1023]).any()
        dev = ms["torch"]._dev.tomb.numpy().view(np.uint32)
        np.testing.assert_array_equal(dev, ms["jax"]._tomb)

    @pytest.mark.parametrize("order", ["list", "probe"])
    def test_purged_list_with_holes(self, data, order):
        """Purged slots leave -1 ids in the middle of a list: a live row
        after a hole is still found, the hole never is, and both routes
        return the exact top-k of the live rows; the purge equals the
        JAX package's."""
        x, _, _ = data
        jidx = _jax_flat(x)
        idx = _port_flat(jidx)
        li = _host(idx.lists_indices)
        lst = int(np.argmax((li >= 0).sum(axis=1)))
        victim, after = int(li[lst, 0]), int(li[lst, 1])
        purged, n = tcompact.purge(idx, [victim])
        jpurged, jn = jcompact.purge(jidx, [victim])
        assert n == jn == 1
        pl = _host(purged.lists_indices)
        np.testing.assert_array_equal(pl, np.asarray(jpurged.lists_indices))
        np.testing.assert_array_equal(_host(purged.list_sizes),
                                      np.asarray(jpurged.list_sizes))
        assert pl[lst, 0] == -1 and pl[lst, 1] == after
        assert int(purged.list_sizes[lst]) == int(idx.list_sizes[lst]) - 1
        params = tflat.SearchParams(n_probes=16, scan_order=order,
                                    scan_bins=-1, probe_cap=64)
        qq = x[[victim, after, 5, 6]]
        _, got = tflat.search(purged, qq, K, params)
        live = np.setdiff1d(np.arange(N), [victim])
        np.testing.assert_array_equal(_host(got), _exact(x[live], live, qq,
                                                         K))
        assert _host(got)[1][0] == after


# ---------------------------------------------------------------------------
# the serializer's mutable format
# ---------------------------------------------------------------------------


class TestSerialize:
    def test_roundtrip_with_pending_mutations(self, tmp_path, data):
        x, q, _ = data
        m = _pair(_jax_flat(x))["torch"]
        ids = m.upsert(q[:3] + 0.001)
        m.delete([7, int(ids[1])])
        d0, i0 = m.search(q, block=True)
        path = str(tmp_path / "mut.npz")
        tser.save(m, path)
        assert isinstance(tser.load(path, device="cpu"),
                          tmutate.MutableIndex)
        m2 = tser.load_mutable(path, device="cpu",
                               **_same_config(PKGS["torch"]))
        assert m2.stats() == m.stats()
        d1, i1 = m2.search(q, block=True)
        assert torch.equal(i0, i1)
        torch.testing.assert_close(d0, d1, rtol=1e-5, atol=1e-5)
        assert int(m2.upsert(q[4:5])[0]) == m.stats()["next_id"]

    def test_roundtrip_after_compaction(self, tmp_path, data):
        x, q, _ = data
        m = _pair(_jax_flat(x))["torch"]
        ids = m.upsert(q[:2] + 0.001)
        m.compact()
        m.upsert(q[2:3] + 0.001)
        path = str(tmp_path / "mut2.npz")
        tser.save_mutable(m, path)
        m2 = tser.load_mutable(path, device="cpu",
                               **_same_config(PKGS["torch"]))
        assert m2.epoch == 1 and m2.stats() == m.stats()
        got = _host(m2.search(q, block=True)[1])
        assert got[0][0] == int(ids[0]) and got[2][0] == N + 2

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_cross_package(self, tmp_path, data, writer):
        """A file either package writes loads in the other and serves the
        same ids."""
        x, q, _ = data
        ms = _pair(_jax_flat(x))
        for m in ms.values():
            m.upsert(q[:3] + 0.001)
            m.delete([5, N + 1])
        path = str(tmp_path / "x.npz")
        PKGS[writer].ser.save_mutable(ms[writer], path)
        assert isinstance(jser.load(path), jmutate.MutableIndex)
        assert isinstance(tser.load(path, device="cpu"),
                          tmutate.MutableIndex)
        back = {"jax": jser.load_mutable(path, **_same_config(PKGS["jax"])),
                "torch": tser.load_mutable(path, device="cpu",
                                           **_same_config(PKGS["torch"]))}
        assert back["torch"].stats() == ms["jax"].stats()
        _assert_same(_search(back, q))
        _assert_same({"jax": _search(ms, q)["jax"],
                      "torch": _search(back, q)["torch"]})


def test_dataclass_config_checks():
    for bad in (dict(delta_capacities=(16, 8)),
                dict(delta_capacities=(4,)),
                dict(compact_trigger_frac=0.0),
                dict(compact_mode="merge"),
                dict(tombstone_slack=-1)):
        with pytest.raises(ValueError):
            tmutate.MutateConfig(**bad)
        with pytest.raises(ValueError):
            jmutate.MutateConfig(**bad)
    cfg = tmutate.MutateConfig(delta_capacities=[8, 32])
    assert cfg.delta_capacities == (8, 32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jmutate.MutateConfig(delta_capacities=[8, 32]))

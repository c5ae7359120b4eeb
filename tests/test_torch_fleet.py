"""The port's replica fleet (``raft_tpu_torch.fleet``, in process) against
the JAX package's ``raft_tpu.fleet``, on the CPU.

* The batcher's fleet surface: ``load()`` after the same queued work
  equal in both packages; ``drain`` sheds with ``draining`` and flushes
  the queue, ``resume`` reopens; the context manager, ``closed`` and
  ``config``.
* The replica lifecycle: one script of transitions through both
  packages' ``Replica``, the states, refusals, load signals, the state
  gauge and the transition counters equal.
* The router's picks: fake replicas with the same fixed loads under one
  ``seed`` give the same sequence of replica names in both packages;
  then the router's behaviour in each (retry on another replica,
  suspect expiry, the deadline budget, per-replica admission,
  ``FleetUnavailableError``, the ``raft.fleet.route`` span).
* Replication: both packages' followers bootstrapped from one WAL (the
  JAX package's or the port's primary, with and without a checkpointed
  fold) answer with the primary's ids; followers of both packages
  tailing one primary through a fold stay equal to it.
* F13, the fold window: a follower bootstrapped between the checkpoint's
  promotion and the log's rewrite (inside the primary's own
  ``rewrite`` call), locally and over HTTP, holds the primary's counters
  and ids, and stays equal to it after the rewrite.
* A rolling restart of three real CPU servers under traffic with no
  failed request; ``obs.serve(fleet=router)``'s ``/healthz`` fold and
  ``/debug/fleet``.

Data: 1500 x 16 rows around 8 centres from a numpy seed, the JAX
package's IVF-Flat build (8 lists) handed to the port by
``index_from_numpy``; searches probe every list, so ids are exact and
compared exactly; distances within rtol 1e-6 in one package, across the
packages within 2e-6 of ``|q|^2 + max |x|^2`` (the expanded-L2 form's
fp32 rounding). Counters are read from ``snapshot()``, never registered
here under a literal name.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

from raft_tpu import fleet as jfleet
from raft_tpu import mutate as jmutate
from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.mutate import wal as jwal
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu_torch import fleet as tfleet
from raft_tpu_torch import mutate as tmutate
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.mutate import wal as twal
from raft_tpu_torch.neighbors import ivf_flat as tflat

PKGS = {
    "jax": types.SimpleNamespace(fleet=jfleet, mutate=jmutate, obs=jobs,
                                 serve=jserve, wal=jwal, flat=jflat),
    "torch": types.SimpleNamespace(fleet=tfleet, mutate=tmutate, obs=tobs,
                                   serve=tserve, wal=twal, flat=tflat),
}
BOTH = sorted(PKGS)
K = 4
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")
_STATS = ("delta_used", "delta_live", "tombstones", "next_id", "id_base",
          "epoch")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


def _csum(snap, name):
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


def _cdiff(ns, before, name):
    return _csum(ns.obs.snapshot(), name) - _csum(before, name)


@pytest.fixture(scope="module")
def small_flat():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 8, 1500)]
         + rng.normal(size=(1500, 16)).astype(np.float32))
    return x, jflat.build(x, jflat.IndexParams(n_lists=8, kmeans_n_iters=3))


def _port(jidx):
    return tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")


def _index(pkg, jidx):
    return jidx if pkg == "jax" else _port(jidx)


def _ids(m, q):
    d, i = m.search(q, block=True)
    return np.asarray(d), np.asarray(i)


def _stats(m):
    return {k: m.stats()[k] for k in _STATS}


def _close_across(d_a, d_b, q, x):
    """Distances of the two packages within 2e-6 of ``|q|^2 + max
    |x|^2`` (the expanded-L2 form's fp32 rounding)."""
    scale = (q * q).sum(1)[:, None] + float((x * x).sum(1).max())
    assert (np.abs(np.asarray(d_a) - np.asarray(d_b)) <= 2e-6 * scale).all()


# ---------------------------------------------------------------------------
# fake plans and servers, one per package
# ---------------------------------------------------------------------------


class _FakePlan:
    """Optional service time and scripted failures; each row's marker
    (its first feature) as every id."""

    def __init__(self, ns, nq, delay_s=0.0, fail_box=None):
        self.ns = ns
        self.nq = nq
        self.n_probes = 8
        self.delay_s = delay_s
        self.fail_box = fail_box     # {"n": remaining failures}

    def search(self, q, block=True):
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail_box and self.fail_box.get("n", 0) > 0:
            self.fail_box["n"] -= 1
            raise self.ns.serve.DispatchError("scripted dispatch failure")
        m = np.asarray(q)[:, :1]
        return (np.repeat(m.astype(np.float32), K, axis=1),
                np.repeat(m.astype(np.int64), K, axis=1))


def _fake_server(pkg, delay_s=0.0, fail_box=None, max_queue=64,
                 shapes=(1, 4, 16), max_wait_ms=0.5, start=True):
    ns = PKGS[pkg]
    plans = {(s, 0): _FakePlan(ns, s, delay_s, fail_box) for s in shapes}
    ladder = ns.serve.PlanLadder(shapes=shapes, rungs=(8,), plans=plans,
                                 dim=4, k=K)
    return ns.serve.SearchServer(
        ladder, ns.serve.ServeConfig(batch_sizes=shapes,
                                     max_queue=max_queue,
                                     max_wait_ms=max_wait_ms),
        start=start)


def _rows(n, base=0):
    out = np.zeros((n, 4), np.float32)
    out[:, 0] = np.arange(base, base + n, dtype=np.float32)
    return out


# ---------------------------------------------------------------------------
# the batcher's fleet surface
# ---------------------------------------------------------------------------


def test_load_snapshot_equal_across_packages():
    """The same queued work (three requests of 1, 2 and 4 rows, a fourth
    shed on a full queue) gives the same snapshot in both packages."""
    got = {}
    for pkg in BOTH:
        srv = _fake_server(pkg, max_queue=3, start=False)
        try:
            assert srv.load() == {"queue_depth": 0, "queued_rows": 0,
                                  "inflight_rows": 0, "shed_rate": 0.0,
                                  "draining": False, "closed": False}
            futs = [srv.submit(_rows(n, base=10 * n)) for n in (1, 2, 4)]
            shed = srv.submit(_rows(1))
            with pytest.raises(PKGS[pkg].serve.RejectedError):
                shed.result(timeout=5)
            got[pkg] = srv.load()
            srv.start()
            for f in futs:
                f.result(timeout=30)
        finally:
            srv.close()
        assert srv.closed and srv.load()["closed"] is True
    assert got["torch"] == got["jax"]
    assert got["torch"]["queue_depth"] == 3
    assert got["torch"]["queued_rows"] == 7
    assert got["torch"]["shed_rate"] == pytest.approx(0.1)


@pytest.mark.parametrize("pkg", BOTH)
def test_load_reflects_inflight_rows(pkg):
    srv = _fake_server(pkg, delay_s=0.15, max_wait_ms=0.0)
    try:
        futs = [srv.submit(_rows(1, base=i)) for i in range(6)]
        time.sleep(0.05)
        snap = srv.load()
        assert snap["inflight_rows"] >= 1
        assert snap["queue_depth"] + snap["inflight_rows"] >= 2
        for f in futs:
            f.result(timeout=30)
        assert srv.load()["queued_rows"] == 0
        assert srv.load()["inflight_rows"] == 0
    finally:
        srv.close()


def test_drain_sheds_flushes_and_resumes_alike():
    """Drain flushes every queued request, sheds new work with reason
    ``draining`` (the same counters move in both packages) and resume
    reopens admission."""
    moved = {}
    for pkg in BOTH:
        ns = PKGS[pkg]
        srv = _fake_server(pkg, delay_s=0.05, max_wait_ms=0.0)
        try:
            futs = [srv.submit(_rows(1, base=i)) for i in range(4)]
            before = ns.obs.snapshot()
            assert srv.drain(timeout_s=30.0)
            for i, f in enumerate(futs):
                _, ids = f.result(timeout=1.0)
                assert ids[0, 0] == i
            assert srv.load()["draining"] is True
            with pytest.raises(ns.serve.RejectedError,
                               match="draining"):
                srv.search(_rows(1))
            moved[pkg] = (
                _cdiff(ns, before, "raft.serve.shed.total{reason=draining}"),
                _cdiff(ns, before, "raft.serve.shed.total"))
            srv.resume()
            _, ids = srv.search(_rows(1, base=42), timeout=30)
            assert ids[0, 0] == 42
        finally:
            srv.close()
    assert moved["torch"] == moved["jax"] == (1, 1)


@pytest.mark.parametrize("pkg", BOTH)
def test_drain_timeout_reports_false(pkg):
    srv = _fake_server(pkg, delay_s=0.3, max_wait_ms=0.0)
    try:
        futs = [srv.submit(_rows(1, base=i)) for i in range(5)]
        assert srv.drain(timeout_s=0.05) is False
        for f in futs:
            f.result(timeout=30)
        assert srv.drain(timeout_s=10.0) is True
    finally:
        srv.close()


@pytest.mark.parametrize("pkg", BOTH)
def test_context_manager_closed_and_config(pkg):
    with _fake_server(pkg, max_queue=7) as srv:
        assert srv.config.max_queue == 7 and not srv.closed
        _, ids = srv.search(_rows(1, base=3), timeout=30)
        assert ids[0, 0] == 3
    assert srv.closed
    with pytest.raises(PKGS[pkg].serve.RejectedError):
        srv.search(_rows(1), timeout=5)


# ---------------------------------------------------------------------------
# the replica lifecycle
# ---------------------------------------------------------------------------


def _lifecycle(pkg, name):
    """One script of transitions, refusals and load probes → what was
    seen, and the counter deltas and final gauge."""
    ns = PKGS[pkg]
    srv = _fake_server(pkg, delay_s=0.2, max_wait_ms=0.0)
    seen = []
    before = ns.obs.snapshot()
    rep = ns.fleet.Replica(name, srv)
    seen.append((rep.state.value, rep.state.code, rep.routable(),
                 rep.load()))
    futs = [srv.submit(_rows(1, base=i)) for i in range(4)]
    time.sleep(0.05)
    seen.append(rep.load() >= 1.0)
    for step in ("begin_drain", "mark_serving", "begin_drain",
                 "mark_down", "mark_serving", "begin_drain",
                 "begin_bootstrap", "mark_serving"):
        try:
            getattr(rep, step)()
            seen.append((step, rep.state.value, rep.routable(),
                         rep.load()))
        except Exception as e:
            seen.append((step, "refused", type(e).__name__))
    for f in futs:
        f.result(timeout=30)
    assert rep.stop(drain_timeout_s=30.0)
    seen.append((rep.state.value, rep.server is None,
                 rep.describe()["state"]))
    after = ns.obs.snapshot()
    trans = {k.split("to=")[1].rstrip("}"): v - before["counters"].get(k, 0)
             for k, v in after["counters"].items()
             if k.startswith("raft.fleet.replica.transitions.total{")
             and f"replica={name}" in k}
    gauge = after["gauges"][f"raft.fleet.replica.state{{replica={name}}}"]
    return seen, trans, gauge


def test_lifecycle_and_metrics_equal_across_packages():
    got = {pkg: _lifecycle(pkg, f"life_{pkg}") for pkg in BOTH}
    assert got["torch"] == got["jax"]
    seen, trans, gauge = got["torch"]
    assert ("mark_serving", "refused", "LogicError") in seen
    assert trans == {"draining": 3, "serving": 2, "down": 2,
                     "bootstrapping": 1}
    assert gauge == tfleet.ReplicaState.DOWN.code == 3


@pytest.mark.parametrize("pkg", BOTH)
def test_kill_fails_queued_work_typed(pkg):
    ns = PKGS[pkg]
    srv = _fake_server(pkg, start=False)    # the queue holds every request
    rep = ns.fleet.Replica("killed", srv)
    futs = [srv.submit(_rows(1, base=i)) for i in range(6)]
    rep.kill()
    assert rep.state is ns.fleet.ReplicaState.DOWN
    for f in futs:
        with pytest.raises(ns.serve.RejectedError):
            f.result(timeout=30)
    assert rep.load() == float("inf") and rep.server is None


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class _FixedServer:
    """A server whose load never changes and which answers at once."""

    def __init__(self, name, rows, shed=0.0):
        self.name, self.rows, self.shed = name, rows, shed

    def load(self):
        return {"queue_depth": 0, "queued_rows": self.rows,
                "inflight_rows": 0, "shed_rate": self.shed,
                "draining": False, "closed": False}

    def submit(self, q, k=None, deadline_ms=None):
        f = Future()
        f.set_result((np.zeros((1, K), np.float32),
                      np.full((1, K), ord(self.name[-1]), np.int64)))
        return f

    def drain(self, timeout_s=30.0):
        return True

    def close(self):
        pass


def _pick_sequence(pkg, seed, n=300):
    ns = PKGS[pkg]
    loads = {"pa": 3, "pb": 0, "pc": 5, "pd": 1, "pe": 2}
    reps = [ns.fleet.Replica(name, _FixedServer(name, rows))
            for name, rows in loads.items()]
    router = ns.fleet.FleetRouter(reps, ns.fleet.FleetConfig(seed=seed))
    reps[3].begin_drain()       # out of the set: its draws fall back
    picks = []
    for i in range(n):
        _, ids = router.search(_rows(1, base=i), timeout=5)
        picks.append(chr(int(ids[0, 0])))
    return picks


@pytest.mark.parametrize("seed", [0, 11])
def test_router_picks_equal_across_packages(seed):
    """Two draws from ``random.Random(seed)`` a request, the lighter one
    taken: the same names in the same order in both packages."""
    jp, tp = _pick_sequence("jax", seed), _pick_sequence("torch", seed)
    assert tp == jp
    assert "d" not in tp                # draining: never picked
    assert set(tp) == {"a", "b", "c", "e"}
    assert tp.count("b") > tp.count("c")


class _ProbeFails(_FixedServer):
    """A server whose load probe fails (``Replica.load()`` reads +inf)
    and which would still answer."""

    def load(self):
        raise OSError("load probe refused")


def test_two_unroutable_by_load_leave_the_third_the_route():
    """When both drawn replicas read +inf (their probes failed), the
    request goes to the lightest of the rest that takes traffic, not to
    one of the two: every route to the third replica. (The JAX
    package's router takes the first of the two.)"""
    reps = [tfleet.Replica("pa", _ProbeFails("pa", 0)),
            tfleet.Replica("pb", _ProbeFails("pb", 0)),
            tfleet.Replica("pc", _FixedServer("pc", 50))]
    router = tfleet.FleetRouter(reps, tfleet.FleetConfig(seed=4))
    try:
        picks = [chr(int(router.search(_rows(1, base=i),
                                       timeout=5)[1][0, 0]))
                 for i in range(40)]
    finally:
        router.close()
    assert set(picks) == {"c"}


@pytest.mark.parametrize("pkg", BOTH)
def test_retry_on_other_replica_and_suspect_exclusion(pkg):
    ns = PKGS[pkg]
    bad = _fake_server(pkg, fail_box={"n": 1000})
    good = _fake_server(pkg)
    router = ns.fleet.FleetRouter(
        [ns.fleet.Replica("bad", bad), ns.fleet.Replica("good", good)],
        ns.fleet.FleetConfig(max_retries=1, suspect_ms=60_000.0, seed=3))
    try:
        before = ns.obs.snapshot()
        for i in range(20):
            _, ids = router.search(_rows(1, base=i), timeout=30)
            assert ids[0, 0] == i
        assert _cdiff(ns, before,
                      "raft.fleet.suspect.total{replica=bad}") >= 1
        assert _cdiff(ns, before, "raft.fleet.retry.total") >= 1
        assert _cdiff(ns, before, "raft.fleet.retry.success.total") >= 1
        assert "bad" in router.suspects()
    finally:
        router.close()


@pytest.mark.parametrize("pkg", BOTH)
def test_suspect_expires_and_replica_recovers(pkg):
    ns = PKGS[pkg]
    flaky = _fake_server(pkg, fail_box={"n": 1})
    other = _fake_server(pkg)
    router = ns.fleet.FleetRouter(
        [ns.fleet.Replica("flaky", flaky),
         ns.fleet.Replica("other", other)],
        ns.fleet.FleetConfig(max_retries=1, suspect_ms=50.0, seed=1))
    try:
        for i in range(5):
            router.search(_rows(1, base=i), timeout=30)
        time.sleep(0.1)
        before = ns.obs.snapshot()
        for i in range(40):
            router.search(_rows(1, base=i), timeout=30)
        assert _cdiff(ns, before,
                      "raft.fleet.route.total{replica=flaky}") > 0
    finally:
        router.close()


@pytest.mark.parametrize("pkg", BOTH)
def test_deadline_budget_stops_the_retries(pkg):
    """Every replica fails and the budget is gone after the first
    failure: ``DeadlineExceeded`` without the retry budget spent (the
    router's check after the 50 ms failure, or the replica's queue if its
    dispatcher is slower than the 10 ms budget on a loaded machine);
    without a deadline the whole retry budget is spent before the typed
    error."""
    ns = PKGS[pkg]
    bad1 = _fake_server(pkg, delay_s=0.05, fail_box={"n": 1000})
    bad2 = _fake_server(pkg, delay_s=0.05, fail_box={"n": 1000})
    router = ns.fleet.FleetRouter(
        [ns.fleet.Replica("bad1", bad1), ns.fleet.Replica("bad2", bad2)],
        ns.fleet.FleetConfig(max_retries=3, suspect_ms=0.0, seed=5))
    try:
        before = ns.obs.snapshot()
        t0 = time.perf_counter()
        with pytest.raises(ns.serve.DeadlineExceeded):
            router.search(_rows(1), deadline_ms=10.0, timeout=30)
        assert time.perf_counter() - t0 < 5.0
        assert _cdiff(ns, before, "raft.fleet.deadline.total") + \
            _cdiff(ns, before, "raft.serve.deadline.total") == 1
        assert _cdiff(ns, before, "raft.fleet.retry.total") <= 1
        mid = ns.obs.snapshot()
        with pytest.raises(ns.serve.DispatchError):
            router.search(_rows(1), timeout=30)
        assert _cdiff(ns, mid, "raft.fleet.retry.exhausted.total") == 1
        assert _cdiff(ns, mid, "raft.fleet.retry.total") == 3
    finally:
        router.close()


@pytest.mark.parametrize("pkg", BOTH)
def test_one_replica_sheds_the_fleet_absorbs(pkg):
    ns = PKGS[pkg]
    tiny = _fake_server(pkg, delay_s=0.1, max_queue=1, max_wait_ms=0.0)
    big = _fake_server(pkg, max_queue=256, max_wait_ms=0.0)
    router = ns.fleet.FleetRouter(
        [ns.fleet.Replica("tiny", tiny), ns.fleet.Replica("big", big)],
        ns.fleet.FleetConfig(max_retries=1, suspect_ms=0.0, seed=2))
    try:
        futs = [router.submit(_rows(1, base=i)) for i in range(50)]
        for f in futs:
            f.result(timeout=60)
        assert "tiny" not in router.suspects()
    finally:
        router.close()


@pytest.mark.parametrize("pkg", BOTH)
def test_all_down_is_typed_unavailability_and_routes_span(pkg):
    ns = PKGS[pkg]
    router = ns.fleet.FleetRouter([ns.fleet.Replica("solo",
                                                    _fake_server(pkg))])
    try:
        ns.obs.RECORDER.clear()
        router.search(_rows(1), timeout=10)
        names = {t["name"] for t in ns.obs.RECORDER.requests(5)}
        assert "raft.fleet.route" in names
        router.replica("solo").kill()
        before = ns.obs.snapshot()
        with pytest.raises(ns.fleet.FleetUnavailableError):
            router.search(_rows(1), timeout=10)
        assert _cdiff(ns, before, "raft.fleet.unroutable.total") == 1
        assert issubclass(ns.fleet.FleetUnavailableError,
                          ns.serve.RejectedError)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# replication
# ---------------------------------------------------------------------------


def _primary(pkg, idx, tmp_path, ckpt):
    ns = PKGS[pkg]
    wal_p = str(tmp_path / "m.wal")
    ckpt_p = str(tmp_path / "m.ckpt") if ckpt else None
    m = ns.mutate.MutableIndex(idx, k=K)
    m.attach_wal(ns.wal.MutationWAL(wal_p, sync=False),
                 checkpoint_path=ckpt_p)
    return m, wal_p, ckpt_p


def _writes(m, x, base):
    ids = m.upsert(x[base:base + 12] + 0.01)
    m.delete(np.asarray(ids[:3]))
    m.delete([base + 2, base + 5])
    m.upsert(x[base + 20:base + 22] + 0.02, ids=np.asarray(ids[3:5]))
    return ids


def _follow(pkg, jidx, wal_p, ckpt_p, name):
    ns = PKGS[pkg]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return ns.fleet.bootstrap_replica(
        wal_p, K, checkpoint_path=ckpt_p, base_index=_index(pkg, jidx),
        name=name, **kw)


@pytest.mark.parametrize("writer", BOTH)
@pytest.mark.parametrize("ckpt", [False, True])
def test_followers_of_both_packages_answer_alike(small_flat, tmp_path,
                                                 writer, ckpt):
    """One primary's WAL (and, with ``ckpt``, its checkpoint after a
    fold and more writes): both packages' followers hold the primary's
    counters and answer with its ids."""
    x, jidx = small_flat
    prim, wal_p, ckpt_p = _primary(writer, _index(writer, jidx), tmp_path,
                                   ckpt)
    _writes(prim, x, 0)
    if ckpt:
        assert prim.compact()
        _writes(prim, x, 100)
    q = x[:32]
    live = _ids(prim, q)
    for pkg in BOTH:
        m, reader, applier = _follow(pkg, jidx, wal_p, ckpt_p, f"fw_{pkg}")
        assert _stats(m) == _stats(prim), pkg
        d, i = _ids(m, q)
        np.testing.assert_array_equal(i, live[1])
        if pkg == writer:
            np.testing.assert_allclose(d, live[0], rtol=1e-6)
        else:
            _close_across(d, live[0], q, x)
        assert applier.applied_seq == reader.position


def test_followers_tail_a_fold_alike(small_flat, tmp_path):
    """Both packages' followers tail the port primary's log through a
    checkpointed fold: the same epoch, counters and ids as the primary,
    the rewrite's snapshot records applied once."""
    x, jidx = small_flat
    prim, wal_p, ckpt_p = _primary("torch", _port(jidx), tmp_path, True)
    repls = {}
    try:
        for pkg in BOTH:
            m, reader, applier = _follow(pkg, jidx, wal_p, None,
                                         f"ft_{pkg}")
            repls[pkg] = (m, PKGS[pkg].fleet.Replicator(
                m, wal_p, name=f"ft_{pkg}", poll_ms=5.0, reader=reader,
                applier=applier))
        _writes(prim, x, 0)
        for _, r in repls.values():
            assert r.drain(20.0)
        assert prim.compact()
        _writes(prim, x, 200)
        q = x[:32]
        live = _ids(prim, q)
        for pkg, (m, r) in repls.items():
            assert r.drain(20.0) and not r.gap
            assert m.epoch == prim.epoch == 1
            assert _stats(m) == _stats(prim), pkg
            np.testing.assert_array_equal(_ids(m, q)[1], live[1])
        gauges = tobs.snapshot()["gauges"]
        assert gauges["raft.fleet.replication.lag_records{replica=ft_torch}"] \
            == 0
    finally:
        for _, r in repls.values():
            r.close()


def test_behind_follower_parks_on_gap(small_flat, tmp_path):
    x, jidx = small_flat
    idx = _port(jidx)
    prim, wal_p, _ = _primary("torch", idx, tmp_path, True)
    prim.upsert(x[:8] + 0.01)
    follower = tmutate.MutableIndex(idx, k=K)
    prim.upsert(x[8:16] + 0.02)
    assert prim.compact()
    reader = twal.WalReader(wal_p)
    reader.last_seq = 1                 # stopped at seq 1, before the fold
    repl = tfleet.Replicator(follower, wal_p, name="gap_t", poll_ms=5.0,
                             reader=reader,
                             applier=tfleet.WalApplier(follower))
    try:
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and not repl.gap:
            time.sleep(0.02)
        assert repl.gap and not repl.drain(0.1)
        assert tobs.snapshot()["gauges"][
            "raft.fleet.replication.gap{replica=gap_t}"] == 1
    finally:
        repl.close()


# ---------------------------------------------------------------------------
# F13: a bootstrap inside the fold window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["local", "http"])
def test_bootstrap_in_the_fold_window(small_flat, tmp_path, monkeypatch,
                                      route):
    """The follower bootstraps while the primary's fold sits between the
    checkpoint's promotion and the log's rewrite (inside the log's own
    ``rewrite`` call): the folded checkpoint beside the old log. It must
    take the sidecar's counters and skip the folded records: the
    primary's counters and ids once the fold returns, and again after it
    tails the rewritten log and more writes."""
    x, jidx = small_flat
    prim, wal_p, ckpt_p = _primary("torch", _port(jidx), tmp_path, True)
    _writes(prim, x, 0)
    prim.upsert(x[300:340] + 0.03)
    srv = (tfleet.serve_replica(wal_path=wal_p, checkpoint_path=ckpt_p)
           if route == "http" else None)
    got = {}
    real_rewrite = prim._wal.rewrite

    def rewrite_after_a_bootstrap(**kw):
        old = twal.MutationWAL(wal_p, sync=False).replay()
        assert old[-1].op != twal.OP_META      # the old log is still there
        if srv is None:
            got["f"] = tfleet.bootstrap_replica(
                wal_p, K, checkpoint_path=ckpt_p, name="f13",
                device="cpu")
        else:
            got["f"] = tfleet.bootstrap_from_url(
                srv.url, K, str(tmp_path / "cache"), name="f13",
                device="cpu")
        return real_rewrite(**kw)

    monkeypatch.setattr(prim._wal, "rewrite", rewrite_after_a_bootstrap)
    try:
        assert prim.compact()
        m, reader, applier = got["f"]
        q = np.concatenate([x[:32], x[300:340]])
        live = _ids(prim, q)
        assert _stats(m) == _stats(prim)
        np.testing.assert_array_equal(_ids(m, q)[1], live[1])
        for row in _ids(m, q)[1]:
            assert len(set(row.tolist())) == row.shape[0]
        repl = tfleet.Replicator(m, wal_p if srv is None else srv.url,
                                 name="f13", poll_ms=5.0, reader=reader,
                                 applier=applier)
        try:
            _writes(prim, x, 400)
            assert repl.drain(20.0) and not repl.gap
            live = _ids(prim, q)
            assert _stats(m) == _stats(prim)
            np.testing.assert_array_equal(_ids(m, q)[1], live[1])
        finally:
            repl.close()
    finally:
        if srv is not None:
            srv.close()


@pytest.mark.parametrize("head_epoch,want", [
    ("no sidecar", None), (None, 7), (1, 7), (2, None), (3, None)])
def test_fold_window_rule(head_epoch, want):
    """The one rule ``recover`` and the followers' bootstrap share: the
    checkpoint's sidecar (epoch 2, folded up to seq 7) is applied, and
    the log skipped up to its seq, unless the log's head is a meta record
    of epoch 2 or later (the log was rewritten after the fold)."""
    from raft_tpu_torch.mutate.mutable import _fold_window_skip
    ckpt = {"epoch": 2, "id_base": 10, "next_id": 12, "folded_upto_seq": 7}
    if head_epoch == "no sidecar":
        assert _fold_window_skip(None, {"epoch": 1}) is want
        return
    head = None if head_epoch is None else {"epoch": head_epoch}
    assert _fold_window_skip(ckpt, head) == want


@pytest.mark.parametrize("swap_before", ["sidecar", "load"])
def test_bootstrap_takes_checkpoint_and_sidecar_from_one_file(
        small_flat, tmp_path, monkeypatch, swap_before):
    """A fold promotes the next checkpoint (its sidecar, then the file)
    while a follower bootstraps from the current one: before the
    follower reads the sidecar, or after it and before it loads the
    index. The follower holds the file it opened first, with that file's
    counters (epoch 1) or, when the sidecar on disk is already the next
    file's, none: never one file's index with the other's counters."""
    from raft_tpu_torch.mutate import mutable as tmutable
    from raft_tpu_torch.neighbors import serialize as tser
    x, jidx = small_flat
    ckpt = str(tmp_path / "m.ckpt")

    def stage(idx, epoch, tag):
        tmp = str(tmp_path / f"{tag}.tmp")
        tser.save(idx, tmp)
        return tmp, {"epoch": epoch, "id_base": 1600 * epoch,
                     "next_id": 1600 * epoch, "folded_upto_seq": 0}

    def promote(tmp, meta):
        tmutable._write_checkpoint_meta(tmp, ckpt, meta)
        os.replace(tmp, ckpt)

    promote(*stage(_port(jidx), 1, "now"))
    small = tflat.build(x[:700], tflat.IndexParams(n_lists=8,
                                                   kmeans_n_iters=3),
                        device="cpu")
    nxt = stage(small, 2, "next")
    box = {"fold": lambda: promote(*nxt)}

    def folding(real):
        def call(*a, **kw):
            fold = box.pop("fold", None)
            if fold is not None:
                fold()
            return real(*a, **kw)
        return call

    if swap_before == "sidecar":
        monkeypatch.setattr(tmutable, "_read_checkpoint_meta",
                            folding(tmutable._read_checkpoint_meta))
    else:
        monkeypatch.setattr(tser, "load", folding(tser.load))
    wal_p = str(tmp_path / "m.wal")
    twal.MutationWAL(wal_p, sync=False).close()
    m, _, applier = tfleet.bootstrap_replica(
        wal_p, K, checkpoint_path=ckpt, name="race", device="cpu")
    assert "fold" not in box                  # the fold ran in between
    assert m.index.size == 1500               # the file opened first
    assert m.epoch == (0 if swap_before == "sidecar" else 1)
    assert applier.applied_seq == 0


# ---------------------------------------------------------------------------
# rolling restart and the debug surfaces
# ---------------------------------------------------------------------------


def test_rolling_restart_under_load_fails_nothing(small_flat):
    """Three servers over the port's CPU index under four traffic
    threads; every replica drained, restarted and rejoined with no
    failed request and no plan built on the serving path."""
    x, jidx = small_flat
    idx = _port(jidx)
    cfg = tserve.ServeConfig(batch_sizes=(1, 8), max_queue=256,
                             max_wait_ms=1.0, default_deadline_ms=10_000.0)
    sp = tflat.SearchParams(n_probes=8)

    def server():
        return tserve.SearchServer.from_index(idx, x[:8], K, params=sp,
                                              config=cfg)

    reps = [tfleet.Replica(f"rr{i}", server()) for i in range(3)]
    router = tfleet.FleetRouter(reps, tfleet.FleetConfig(max_retries=1,
                                                         seed=4))
    # a direct one-row search each: the server's 1-row plan's answer
    want = np.concatenate([tflat.search(idx, x[i:i + 1], K, sp)[1].numpy()
                           for i in range(64)])
    stop = threading.Event()
    failures, done = [], [0]
    lock = threading.Lock()

    def traffic(t):
        i = t
        while not stop.is_set():
            try:
                _, ids = router.search(x[i % 64:i % 64 + 1], timeout=60)
                assert (ids[0] == want[i % 64]).all()
                with lock:
                    done[0] += 1
            except Exception as e:
                with lock:
                    failures.append(repr(e))
            i += 4

    threads = [threading.Thread(target=traffic, args=(t,), daemon=True)
               for t in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        report = tfleet.rolling_restart(
            router, lambda rep: rep.set_server(server()),
            drain_timeout_s=30.0)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        router.close()
    assert report["ok"], report
    assert [e["ok"] and e["drained"] for e in report["replicas"]] == \
        [True] * 3
    assert failures == []
    assert done[0] > 20
    assert all(r.state is tfleet.ReplicaState.DOWN for r in reps)


def test_failed_restart_halts_and_capacity_is_required():
    reps = [tfleet.Replica(f"h{i}", _fake_server("torch"))
            for i in range(3)]
    router = tfleet.FleetRouter(reps)
    try:
        calls = []

        def restart(rep):
            calls.append(rep.name)
            if len(calls) == 2:
                raise RuntimeError("bad build")
            rep.set_server(_fake_server("torch"))

        report = tfleet.rolling_restart(router, restart)
        assert not report["ok"] and len(calls) == 2
        assert reps[1].state is tfleet.ReplicaState.DOWN
        assert reps[2].state is tfleet.ReplicaState.SERVING
        router.search(_rows(1), timeout=10)
    finally:
        router.close()
    solo = tfleet.FleetRouter([tfleet.Replica("solo2",
                                              _fake_server("torch"))])
    try:
        with pytest.raises(Exception, match="rolling restart needs"):
            tfleet.rolling_restart(solo, lambda r: None)
    finally:
        solo.close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_fleet_fold_and_debug_fleet():
    router = tfleet.FleetRouter([tfleet.Replica("ha", _fake_server("torch")),
                                 tfleet.Replica("hb", _fake_server("torch"))])
    router.search(_rows(1), timeout=10)
    ep = tobs.serve(port=0, fleet=router)
    try:
        code, body = _get(ep.url + "/debug/fleet")
        assert code == 200 and body["serving"] == 2
        assert {r["name"] for r in body["replicas"]} == {"ha", "hb"}
        assert body["config"] == {"max_retries": 1, "suspect_ms": 2000.0}
        _, hb = _get(ep.url + "/healthz")
        assert hb["fleet"]["replicas"] == 2 and hb["fleet"]["serving"] == 2
        router.replica("hb").begin_drain()
        time.sleep(tfleet.FleetRouter._GAUGE_REFRESH_S + 0.05)
        router.search(_rows(1), timeout=10)
        code, hb = _get(ep.url + "/healthz")
        assert code == 503 and hb["status"] == "degraded"
        assert hb["fleet"]["serving"] == 1
    finally:
        ep.close()
        router.close()


def test_replicas_tag_their_servers_apart(monkeypatch):
    """Three servers in one process tag their dispatches with their
    replica's name; a server outside the fleet keeps ``"server"``."""
    from raft_tpu_torch.obs import profiler
    tags = []
    monkeypatch.setattr(profiler, "tag_dispatch", tags.append)
    reps = [tfleet.Replica(f"tag{i}", _fake_server("torch"))
            for i in range(3)]
    lone = _fake_server("torch")
    try:
        for i, rep in enumerate(reps):
            rep.server.search(_rows(1, base=i), timeout=10)
        lone.search(_rows(1), timeout=10)
        assert set(tags) == {"tag0", "tag1", "tag2", "server"}
    finally:
        lone.close()
        for rep in reps:
            rep.kill()

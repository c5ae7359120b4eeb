"""The port's debug endpoint (``raft_tpu_torch.obs.endpoint``: ``obs.serve``,
``DebugServer``, ``/healthz``'s verdict, ``POST /search``) against the
JAX package's ``raft_tpu.obs.endpoint``, on the CPU.

* ``_health_body`` of both packages on the same gauge snapshot, one case
  per plane: equal dicts, and the verdict each case expects.
* Both packages' endpoints over private registries and recorders fed the
  same calls: equal status and body on every GET route (the 404s and the
  fleet aggregator's routes with no federator among them), the
  Prometheus text equal.
* ``POST /search`` over one CPU IVF-Flat index (the JAX package's build,
  handed to the port by ``index_from_numpy``): ids equal, distances
  within 1e-5 relative; the error codes (400, 429, 504, 500) through
  fake plans as ``tests/test_torch_faults.py`` builds them; a
  ``traceparent`` round trip and the ``all=1`` fragment wire format.
* The thread bound: at ``max_threads=1`` with one handler stalled, a
  second connection is dropped by both packages.

Metric names are fed to the registries from tables, never as literal
instrument calls (the repo's taxonomy lint scans ``tests/``).
"""

import http.client
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.obs import endpoint as jend
from raft_tpu.obs import recorder as jrec
from raft_tpu.obs import registry as jreg
from raft_tpu.obs import spans as jspans
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.obs import endpoint as tend
from raft_tpu_torch.obs import recorder as trec
from raft_tpu_torch.obs import registry as treg
from raft_tpu_torch.obs import spans as tspans

PKGS = {
    "jax": types.SimpleNamespace(ob=jobs, end=jend, rec=jrec, reg=jreg,
                                 sp=jspans, serve=jserve, flat=jflat),
    "torch": types.SimpleNamespace(ob=tobs, end=tend, rec=trec, reg=treg,
                                   sp=tspans, serve=tserve, flat=tflat),
}
BOTH = sorted(PKGS)
FLAT_FIELDS = ("centers", "lists_data", "lists_indices", "lists_norms",
               "list_sizes")


@pytest.fixture(autouse=True)
def _tracing_on(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")
    for p in PKGS.values():
        p.sp.set_trace_enabled(True)
        p.sp.set_trace_sample_rate(1.0)
    yield
    for p in PKGS.values():
        p.rec.RECORDER.clear()


def _get(url, path, headers=None):
    """GET → (status, parsed JSON or text)."""
    req = urllib.request.Request(url + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    text = raw.decode("utf-8")
    return code, (json.loads(text) if ctype == "application/json"
                  else text)


def _post(url, path, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# /healthz's verdict, plane by plane
# ---------------------------------------------------------------------------

# case -> (gauges, the verdict)
PLANES = {
    "quiet": ({}, "ok"),
    "comms_suspects": ({
        "raft.comms.health.suspects{session=s0}": 2.0,
        "raft.comms.health.suspects{session=s1}": 0.0,
        "raft.comms.health.max_staleness_seconds{session=s0}": 3.5},
        "degraded"),
    "comms_quiet": ({
        "raft.comms.health.suspects{session=s0}": 0.0,
        "raft.comms.health.max_staleness_seconds{session=s0}": 0.2},
        "ok"),
    "serve_overload": ({
        "raft.serve.overloaded": 1.0, "raft.serve.queue.depth": 64.0,
        "raft.serve.queue.max": 64.0, "raft.serve.shed.rate": 2.5,
        "raft.serve.degrade.level": 1.0}, "degraded"),
    "serve_full_queue": ({
        "raft.serve.queue.depth": 64.0, "raft.serve.queue.max": 64.0},
        "degraded"),
    "serve_calm": ({
        "raft.serve.queue.depth": 3.0, "raft.serve.queue.max": 64.0,
        "raft.serve.overloaded": 0.0}, "ok"),
    "failover": ({
        "raft.serve.failover.engaged": 1.0,
        "raft.serve.failover.coverage": 0.75,
        "raft.serve.queue.max": 64.0}, "degraded"),
    "mutate_stalled": ({
        "raft.mutate.epoch": 3.0, "raft.mutate.delta.fill_frac": 0.97,
        "raft.mutate.delta.rung": 2.0, "raft.mutate.delta.rows": 16000.0,
        "raft.mutate.tombstone.frac": 0.01,
        "raft.mutate.compact.inflight": 0.0,
        "raft.mutate.delta.stalled": 1.0}, "degraded"),
    "compactor_failing": ({
        "raft.mutate.epoch": 1.0, "raft.mutate.compactor.failing": 1.0},
        "degraded"),
    "slo_breach": ({
        "raft.slo.objectives": 2.0,
        "raft.slo.breach{objective=p99}": 1.0,
        "raft.slo.breach{objective=avail}": 0.0,
        "raft.slo.burn_rate{objective=p99,window=60s}": 12.0},
        "degraded"),
    "slo_held": ({
        "raft.slo.objectives": 1.0,
        "raft.slo.breach{objective=avail}": 0.0}, "ok"),
    "quality": ({
        "raft.obs.quality.recall{epoch=0,family=ivf_flat,k=10}": 0.93,
        "raft.obs.quality.drift{family=ivf_flat}": 0.01,
        "raft.obs.quality.drift.alarm{family=ivf_flat}": 0.0,
        "raft.obs.quality.samples{family=ivf_flat}": 5.0}, "ok"),
    "tiered": ({
        "raft.tiered.budget.bytes": 1e9, "raft.tiered.hot.lists": 64.0,
        "raft.tiered.hot.bytes": 9e8, "raft.tiered.hit_rate": 0.8,
        "raft.tiered.overlap.frac": 0.4}, "ok"),
    "profile_low_headroom": ({
        "raft.obs.profile.hbm.low_headroom": 1.0,
        "raft.obs.profile.hbm.headroom_frac{device=cuda:0}": 0.03,
        "raft.obs.profile.duty_cycle{device=cuda:0}": 0.6}, "degraded"),
    "profile_duty_only": ({
        "raft.obs.profile.duty_cycle{device=cuda:0,tag=a}": 0.25},
        "ok"),
    "history_anomaly": ({
        "raft.obs.history.anomaly{signal=shed_rate}": 1.0,
        "raft.obs.history.anomaly{signal=recall}": 0.0}, "ok"),
    "fleet": ({
        "raft.fleet.replicas.total": 3.0,
        "raft.fleet.replicas.serving": 2.0, "raft.fleet.suspects": 1.0,
        "raft.fleet.replication.lag_records": 40.0}, "degraded"),
    "fleet_whole": ({
        "raft.fleet.replicas.total": 2.0,
        "raft.fleet.replicas.serving": 2.0, "raft.fleet.suspects": 0.0},
        "ok"),
    "dist_shards": ({
        "raft.serve.dist.shards": 4.0, "raft.serve.dist.merge.ratio": 0.25,
        "raft.comms.health.suspect_rank{rank=2,session=s}": 1.0,
        "raft.comms.health.suspect_rank{rank=10,session=s}": 1.0,
        "raft.comms.health.suspect_rank{rank=3,session=s}": 0.0,
        "raft.comms.health.suspects{session=s}": 2.0}, "degraded"),
}


@pytest.mark.parametrize("case", sorted(PLANES))
def test_health_body_per_plane(case):
    gauges, verdict = PLANES[case]
    snap = {"counters": {}, "gauges": dict(gauges), "histograms": {}}
    got = tend._health_body(snap)
    assert got == jend._health_body(snap)
    assert got["status"] == verdict


def test_dist_parser_matches_jax():
    from raft_tpu.comms.health import suspects_from_gauges as jparse
    from raft_tpu_torch.comms.health import suspects_from_gauges as tparse
    for gauges in (PLANES["dist_shards"][0], {},
                   {"raft.comms.health.suspect_rank{rank=a,session=s}": 1.0,
                    "raft.comms.health.suspect_rank{rank=b,session=s}": 2.0}):
        assert tparse(gauges) == jparse(gauges)
    assert tparse(PLANES["dist_shards"][0]) == [2, 10]


# ---------------------------------------------------------------------------
# every GET route over the same registry calls
# ---------------------------------------------------------------------------

FEED_GAUGES = {**PLANES["serve_overload"][0], **PLANES["tiered"][0],
               "raft.fleet.replicas.total": 2.0,
               "raft.fleet.replicas.serving": 2.0,
               "raft.slo.breach{objective=p99}": 0.0,
               "raft.obs.profile.duty_cycle{device=cuda:0}": 0.5}


def _feed(reg, gauges):
    """The same calls into either package's registry: gauges from a table,
    a labelled counter, a histogram."""
    for series, v in gauges.items():
        name, _, lbl = series.partition("{")
        labels = dict(kv.split("=") for kv in lbl.rstrip("}").split(",")
                      if kv)
        reg.gauge(name, **labels).set(v)
    c = reg.counter("raft.torchtest.endpoint.hits", route="a")
    c.inc(3)
    h = reg.histogram("raft.torchtest.endpoint.lat",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)


def _trace(i, dur, name="raft.torchtest.search"):
    return {"trace_id": f"t{i}", "name": name, "start_unix": 100.0 + i,
            "duration_ms": dur, "ts_unix": 200.0 + i,
            "spans": [{"name": name, "span_id": f"{i:08x}",
                       "parent_id": None, "t_start_ms": 0.0,
                       "duration_ms": dur, "tid": 7,
                       "attrs": {"k": 3}},
                      {"name": "raft.torchtest.child",
                       "span_id": f"{i + 100:08x}",
                       "parent_id": f"{i:08x}", "t_start_ms": 0.5,
                       "duration_ms": dur / 2, "tid": 7}]}


GET_ROUTES = [
    "/metrics", "/healthz", "/healthz/", "/debug/requests",
    "/debug/requests?n=2", "/debug/requests?n=x", "/debug/requests?slow=1",
    "/debug/requests?slow=1&n=1", "/debug/requests?trace=t1",
    "/debug/requests?trace=t1&format=chrome",
    "/debug/requests?format=chrome", "/debug/requests?trace=nope",
    "/debug/requests?trace=t3&all=1", "/debug/requests?trace=zz&all=1",
    "/debug/slo", "/debug/fleet", "/debug/profile", "/debug/history",
    "/debug/history?name=raft.serve", "/nope", "/", "/fleet/metrics",
    "/fleet/healthz", "/fleet/trace?trace=t1", "/fleet/trace",
]


def _route_bodies(ns, gauges):
    reg = ns.reg.MetricsRegistry(True)
    rec = ns.rec.FlightRecorder(capacity=4, slow_ms=5.0, slow_capacity=2,
                                registry=ns.reg.MetricsRegistry(True))
    _feed(reg, gauges)
    for i, dur in enumerate((1.0, 6.0, 2.0, 9.0, 3.0)):
        rec.record(_trace(i, dur))
    out = {}
    with ns.ob.serve(port=0, registry=reg, recorder=rec) as srv:
        for path in GET_ROUTES:
            code, body = _get(srv.url, path)
            if isinstance(body, dict):
                body.pop("now_unix", None)
                for ev in body.get("traceEvents", ()):
                    if ev["name"] == "process_name":
                        # "<package> <trace id>": the package's own name
                        ev["args"]["name"] = ev["args"]["name"].split()[-1]
            out[path] = (code, body)
        out["POST /search"] = _post(srv.url, "/search",
                                    {"queries": [[0.0]]})
        out["POST /other"] = _post(srv.url, "/other", {})
    return out


@pytest.mark.parametrize("gauges", ["fed", "empty"])
def test_every_route_answers_like_jax(gauges):
    g = FEED_GAUGES if gauges == "fed" else {}
    got = {p: _route_bodies(PKGS[p], g) for p in BOTH}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["/healthz"][0] == (503 if g else 200)
    assert t["/nope"][0] == t["/fleet/metrics"][0] == 404
    assert t["/fleet/trace?trace=t1"][0] == t["/fleet/healthz"][0] == 404
    assert t["/debug/history"][0] == 404
    assert t["/debug/requests?n=x"][0] == 400
    assert t["/debug/requests?trace=t3&all=1"][1]["trace_id"] == "t3"
    assert set(t["/debug/requests?trace=zz&all=1"][1]) == {"trace_id",
                                                           "fragments"}
    assert t["/debug/fleet"][0] == (200 if g else 404)
    assert t["POST /search"][0] == t["POST /other"][0] == 404
    assert "raft_torchtest_endpoint_hits_total" in t["/metrics"][1]


# ---------------------------------------------------------------------------
# POST /search
# ---------------------------------------------------------------------------

K = 8


@pytest.fixture(scope="module")
def flat_pair():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(24, 16)).astype(np.float32)
    x = (c[rng.integers(0, 24, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 24, 32)]
         + rng.normal(size=(32, 16))).astype(np.float32)
    jidx = jflat.build(x, jflat.IndexParams(n_lists=16, kmeans_n_iters=4))
    tidx = tflat.index_from_numpy(
        {f: np.asarray(getattr(jidx, f)) for f in FLAT_FIELDS},
        int(jidx.metric), jidx.size, float(jidx.scale), device="cpu")
    return {"jax": jidx, "torch": tidx}, q


def _searcher(name, index, q):
    p = PKGS[name]
    return p.serve.SearchServer.from_index(
        index, q[:8], K, params=p.flat.SearchParams(n_probes=16),
        config=p.serve.ServeConfig(batch_sizes=(1, 8), max_wait_ms=0.0))


def test_post_search_matches_jax(flat_pair):
    idx, q = flat_pair
    out = {}
    for name in BOTH:
        srv = _searcher(name, idx[name], q)
        try:
            with PKGS[name].ob.serve(port=0, searcher=srv) as ep:
                r8 = _post(ep.url, "/search", {"queries": q[:8].tolist()})
                r1 = _post(ep.url, "/search",
                           {"queries": q[8].tolist(), "k": 3})
                direct = srv.search(q[:8])
        finally:
            srv.close()
        assert r8[0] == r1[0] == 200
        assert r8[1]["nq"] == 8 and r8[1]["k"] == K
        assert r1[1]["nq"] == 1 and r1[1]["k"] == 3
        np.testing.assert_array_equal(r8[1]["ids"], np.asarray(direct[1]))
        np.testing.assert_array_equal(
            np.asarray(r8[1]["distances"], np.float32),
            np.asarray(direct[0]))
        assert r8[1]["trace_id"]
        out[name] = (r8[1], r1[1])
    for a, b in zip(out["torch"], out["jax"]):
        assert a["ids"] == b["ids"]
        np.testing.assert_allclose(a["distances"], b["distances"],
                                   rtol=1e-5, atol=1e-5)


class _FakePlan:
    """Serves row i's first value as its ids, after ``delay`` s, or
    raises ``exc`` on every dispatch."""

    def __init__(self, nq, exc=None, delay=0.0):
        self.nq, self.n_probes, self.k = nq, 8, 4
        self.exc, self.delay = exc, delay

    def search(self, q, block=True):
        if self.delay:
            time.sleep(self.delay)
        if self.exc is not None:
            raise self.exc("injected")
        marker = np.asarray(q)[:, :1]
        return (np.repeat(marker.astype(np.float32), self.k, axis=1),
                np.repeat(marker.astype(np.int64), self.k, axis=1))


def _fake_server(ns, exc=None, **cfg):
    exc = getattr(ns.serve, exc, None) or RuntimeError if exc else None
    ladder = ns.serve.PlanLadder(
        shapes=(1, 4), rungs=(8,), dim=4, k=4,
        plans={(s, 0): _FakePlan(s, exc=exc) for s in (1, 4)})
    cfg.setdefault("max_wait_ms", 0.0)
    return ns.serve.SearchServer(
        ladder, ns.serve.ServeConfig(batch_sizes=(1, 4), **cfg))


# case -> (server config, request body, closed before the request)
ERROR_CASES = {
    "ok": ({}, {"queries": [[5.0, 0, 0, 0]]}, False),
    "not_json": ({}, b"{nope", False),
    "no_queries": ({}, {"k": 2}, False),
    "k_not_a_number": ({}, {"queries": [[1.0, 0, 0, 0]], "k": "x"}, False),
    "rejected": ({}, {"queries": [[1.0, 0, 0, 0]]}, True),
    "deadline": (dict(exc="ShardFailedError", max_retries=2,
                      retry_backoff_ms=400.0, retry_backoff_mult=1.0),
                 {"queries": [[1.0, 0, 0, 0]], "deadline_ms": 100.0}, False),
    "error": (dict(exc="RuntimeError"), {"queries": [[1.0, 0, 0, 0]]},
              False),
    "bad_shape": ({}, {"queries": [[1.0, 2.0]]}, False),
}
ERROR_CODES = {"ok": 200, "not_json": 400, "no_queries": 400,
               "k_not_a_number": 500, "rejected": 429, "deadline": 504,
               "error": 500, "bad_shape": 500}


def _error_case(ns, case):
    cfg, body, closed = ERROR_CASES[case]
    cfg = dict(cfg)
    srv = _fake_server(ns, exc=cfg.pop("exc", None), **cfg)
    try:
        if closed:
            srv.close()
        with ns.ob.serve(port=0, searcher=srv) as ep:
            code, got = _post(ep.url, "/search", body)
    finally:
        srv.close()
    return code, got


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_post_search_error_codes_like_jax(case):
    got = {p: _error_case(PKGS[p], case) for p in BOTH}
    assert got["torch"][0] == got["jax"][0] == ERROR_CODES[case]
    t, j = got["torch"][1], got["jax"][1]
    assert set(t) == set(j)
    if case == "ok":
        assert t["ids"] == j["ids"] == [[5] * 4]
    else:
        assert t["error"] == j["error"]
        assert (t.get("trace_id") is None) == (j.get("trace_id") is None)


def test_traceparent_round_trip_and_fragments(flat_pair):
    idx, q = flat_pair
    tid, sid = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    out = {}
    for name in BOTH:
        ns = PKGS[name]
        srv = _searcher(name, idx[name], q)
        try:
            with ns.ob.serve(port=0, searcher=srv) as ep:
                code, body = _post(
                    ep.url, "/search", {"queries": q[:2].tolist()},
                    headers={"traceparent": f"00-{tid}-{sid}-01"})
                assert code == 200 and body["trace_id"] == tid
                # the dispatcher records the request's trace just after
                # it sets the result: poll for its fragment
                for _ in range(200):
                    _, frag = _get(ep.url,
                                   f"/debug/requests?trace={tid}&all=1")
                    if len(frag["fragments"]) == 2:
                        break
                    time.sleep(0.01)
                code_c, chrome = _get(
                    ep.url, f"/debug/requests?trace={tid}&format=chrome")
        finally:
            srv.close()
        assert set(frag) == {"trace_id", "fragments", "now_unix"}
        assert frag["trace_id"] == tid and frag["fragments"]
        # the newest fragment is the handler's: its raft.serve.http span
        # under the caller's span; stitched with the served request's
        # fragment, it parents raft.serve.request
        assert code_c == 200
        http_ev = [e for e in chrome["traceEvents"]
                   if e["name"] == "raft.serve.http"]
        assert len(http_ev) == 1
        assert http_ev[0]["args"].get("parent_id") == sid
        stitched = ns.rec.stitch_chrome_trace(frag["fragments"])
        evs = [e for e in stitched["traceEvents"] if e.get("ph") == "X"]
        by_id = {e["args"]["span_id"]: e for e in evs}
        req = [e for e in evs if e["name"] == "raft.serve.request"]
        assert req and all(
            by_id[e["args"]["parent_id"]]["name"] == "raft.serve.http"
            for e in req)
        out[name] = sorted(
            (f["name"], f.get("remote_parent") == sid,
             sorted(sp["name"] for sp in f["spans"]))
            for f in frag["fragments"])
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the thread bound
# ---------------------------------------------------------------------------


class _Stalled:
    """A searcher whose ``search`` waits on ``release``."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def search(self, queries, k=None, deadline_ms=None):
        self.entered.set()
        self.release.wait(30)
        return np.zeros((1, 1), np.float32), np.zeros((1, 1), np.int64)


def _second_connection_dropped(ns):
    stall = _Stalled()
    srv = ns.end.DebugServer(("127.0.0.1", 0), searcher=stall,
                             registry=ns.reg.MetricsRegistry(True),
                             max_threads=1).start()
    first = {}

    def hold():
        first["r"] = _post(srv.url, "/search", {"queries": [[0.0]]})

    th = threading.Thread(target=hold, daemon=True)
    try:
        th.start()
        assert stall.entered.wait(30)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        try:
            conn.request("GET", "/healthz")
            conn.getresponse().read()
            dropped = False
        except (http.client.RemoteDisconnected, ConnectionResetError,
                BrokenPipeError, socket.timeout):
            dropped = True
        finally:
            conn.close()
        stall.release.set()
        th.join(30)
        assert not th.is_alive()
        # the slot is free again: the next connection is served
        code, _ = _get(srv.url, "/healthz")
    finally:
        stall.release.set()
        srv.close()
    return dropped, first["r"][0], code


def test_saturated_bound_drops_the_connection_alike():
    got = {p: _second_connection_dropped(PKGS[p]) for p in BOTH}
    assert got["torch"] == got["jax"] == (True, 200, 200)


def test_default_bound_reads_the_environment(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_ENDPOINT_THREADS", "3")
    for ns in PKGS.values():
        srv = ns.end.DebugServer(("127.0.0.1", 0))
        try:
            assert srv._slots._initial_value == 3
            assert srv.url == f"http://127.0.0.1:{srv.port}"
        finally:
            srv.server_close()

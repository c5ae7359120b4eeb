"""The port's observability core (``raft_tpu_torch.obs``: the registry
and its exporters, ``timed``, spans and ``traceparent``, the flight
recorder and Chrome trace, the resource profiler) and its hooks in the
served path, held against the JAX package's ``raft_tpu.obs``.

Each case makes the same calls into both packages and compares what
they record: snapshots, ``snapshot_diff`` and Prometheus text equal;
span traces equal in names, parent links, attributes and the
recorder's rings (ids and times left out, and the attributes that hold
a wall time or a package-specific plan key); the profiler's report
equal under one fake clock. No case compares a wall-clock ratio.

The metric names the cases make sit in the ``raft.torchtest.*`` family,
which no JAX-side file registers, and the modules are bound to other
names (``tobs``, ``jspans``) so that no literal instrument call appears
here for the repo's taxonomy lint.
"""

import glob
import http.server
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import serve as jserve
from raft_tpu.core import memory as jmemory
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import plan as jplan
from raft_tpu.neighbors import serialize as jser
from raft_tpu.obs import profiler as jprof
from raft_tpu.obs import recorder as jrec
from raft_tpu.obs import registry as jreg
from raft_tpu.obs import spans as jspans
from raft_tpu.obs import timing as jtiming
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.core import memory as tmemory
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import plan as tplan
from raft_tpu_torch.neighbors import serialize as tser
from raft_tpu_torch.obs import profiler as tprof
from raft_tpu_torch.obs import recorder as trec
from raft_tpu_torch.obs import registry as treg
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.obs import timing as ttiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(ob=jobs, reg=jreg, sp=jspans,
                                 rec=jrec, prof=jprof, timing=jtiming,
                                 memory=jmemory, serve=jserve),
    "torch": types.SimpleNamespace(ob=tobs, reg=treg, sp=tspans,
                                   rec=trec, prof=tprof, timing=ttiming,
                                   memory=tmemory, serve=tserve),
}
# span attributes that hold a wall time, or a plan key whose bits are
# each package's own
UNCOMPARED = {"latency_ms", "waited_ms", "host_ms", "device_ms",
              "backoff_ms", "plan_key"}
PROFILER_THREAD = "raft-obs-profiler"


def _profiler_threads():
    return [t for t in threading.enumerate()
            if t.name == PROFILER_THREAD and t.is_alive()]


@pytest.fixture(autouse=True)
def _restore():
    """Each case starts and ends with tracing on at rate 1, empty
    recorders and no profiler (its sampler thread joined)."""
    def reset():
        for p in PKGS.values():
            p.sp.set_trace_enabled(True)
            p.sp.set_trace_sample_rate(1.0)
            p.prof.disable_profiling()
            p.rec.RECORDER.clear()
    reset()
    yield
    reset()
    assert not _profiler_threads()


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PALLAS", "always")


class Clock:
    """A fake ``time`` module: every clock reads ``t``, which the test
    moves."""

    def __init__(self, t=1000.0, step=0.0):
        self.t = t
        self.step = step

    def now(self):
        self.t += self.step
        return self.t

    def module(self):
        return types.SimpleNamespace(perf_counter=self.now,
                                     monotonic=self.now, time=self.now,
                                     sleep=time.sleep)


# ---------------------------------------------------------------------------
# The registry and its exporters (F8: the JAX package's series keys)
# ---------------------------------------------------------------------------


def _calls_labels(r):
    r.counter("raft.torchtest.req", route="search", code=200).inc()
    r.counter("raft.torchtest.req", code=200, route="search").inc(2)
    r.counter("raft.torchtest.req", route="b").inc(0.5)
    r.gauge("raft.torchtest.depth", shard="0").set(3)
    r.gauge("raft.torchtest.depth", shard="0").inc(2)
    r.gauge("raft.torchtest.depth", shard="1").dec(1.5)
    r.counter("raft.torchtest.plain").inc()


def _calls_histograms(r):
    h = r.histogram("raft.torchtest.lat", family="f",
                    buckets=(0.1, 1.0, 10.0, float("inf")))
    for v in (0.1, 0.05, 1.0, 1.5, 100.0, 10.0):
        h.observe(v)
    s = r.histogram("raft.torchtest.size", buckets=jreg.SIZE_BUCKETS)
    for v in (1, 4, 5, 1 << 20, (1 << 20) + 1):
        s.observe(v)
    r.histogram("raft.torchtest.default").observe(0.0005)


def _calls_escapes(r):
    r.counter("raft.torchtest.esc", path='a"b\\c\nd').inc()
    r.gauge("raft.torchtest.inf", le="x").set(float("inf"))
    r.gauge("raft.torchtest.nan").set(float("nan"))
    r.gauge("raft.torchtest.neg").set(-2.25)
    r.counter("raft.torchtest.help", "what it counts").inc(3)


REGISTRY_CASES = {"labels": _calls_labels, "histograms": _calls_histograms,
                  "escapes": _calls_escapes}


def _nan_safe(snap):
    """NaN != NaN: compare a snapshot with NaN spelled out."""
    return json.loads(json.dumps(snap, default=str).replace("NaN", '"nan"'))


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_calls_agree(case):
    out = {}
    for name, p in PKGS.items():
        r = p.reg.MetricsRegistry(enabled=True)
        before = r.snapshot()
        REGISTRY_CASES[case](r)
        after = r.snapshot()
        out[name] = (_nan_safe(after),
                     _nan_safe(p.reg.snapshot_diff(before, after)),
                     r.to_prometheus_text())
    assert out["torch"] == out["jax"]


def test_process_registry_series_keys_agree():
    """F8: the same labelled calls through both packages' process
    registries give equal series keys and Prometheus lines."""
    out = {}
    for name, p in PKGS.items():
        p.ob.counter("raft.torchtest.f8.calls", rank=5,
                     session="chaos").inc()
        p.ob.gauge("raft.torchtest.f8.depth", path="two_level").set(2)
        p.ob.histogram("raft.torchtest.f8.seconds",
                       result="ok").observe(0.01)
        snap = p.ob.snapshot()
        out[name] = (
            {kind: {k: v for k, v in series.items()
                    if k.startswith("raft.torchtest.f8.")}
             for kind, series in snap.items()},
            [ln for ln in p.ob.to_prometheus_text().splitlines()
             if "raft_torchtest_f8_" in ln])
    assert out["torch"] == out["jax"]
    assert "raft.torchtest.f8.calls{rank=5,session=chaos}" in \
        out["torch"][0]["counters"]
    assert 'raft_torchtest_f8_calls_total{rank="5",session="chaos"} ' \
        in "\n".join(out["torch"][1])


def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return "ok"


@pytest.mark.parametrize("case", ["bad_name", "kind_conflict",
                                  "unsorted_bounds", "negative_inc",
                                  "cardinality", "disabled"])
def test_registry_refusals_agree(case):
    out = {}
    for name, p in PKGS.items():
        r = p.reg.MetricsRegistry(enabled=case != "disabled",
                                  max_series=2)
        fn = {
            "bad_name": lambda: r.counter("cuml.torchtest.x"),
            "kind_conflict": lambda: (r.counter("raft.torchtest.k"),
                                      r.gauge("raft.torchtest.k")),
            "unsorted_bounds": lambda: r.histogram(
                "raft.torchtest.h", buckets=(1.0, 0.5)),
            "negative_inc": lambda: r.counter("raft.torchtest.c").inc(-1),
            "cardinality": lambda: [r.gauge("raft.torchtest.g", i=i)
                                    for i in range(3)],
            "disabled": lambda: (r.counter("raft.torchtest.c").inc(),
                                 r.histogram("raft.torchtest.h")
                                 .observe(1.0)),
        }[case]
        out[name] = (_outcome(fn), r.snapshot(), r.to_prometheus_text())
    assert out["torch"] == out["jax"]
    if case == "cardinality":
        assert out["torch"][0] == "CardinalityError"


def test_registry_reset_and_toggle(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_METRICS", "0")
    for p in PKGS.values():
        assert p.reg.MetricsRegistry().enabled() is False
        r = p.reg.MetricsRegistry(enabled=True)
        r.counter("raft.torchtest.c").inc()
        r.set_enabled(False)
        r.counter("raft.torchtest.d").inc()
        assert list(r.snapshot()["counters"]) == ["raft.torchtest.c"]
        r.reset()
        assert r.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
    assert treg.DEFAULT_BUCKETS == jreg.DEFAULT_BUCKETS
    assert treg.SIZE_BUCKETS == jreg.SIZE_BUCKETS
    assert treg.NAME_RE.pattern == jreg.NAME_RE.pattern


# ---------------------------------------------------------------------------
# timed
# ---------------------------------------------------------------------------


def _timed_program(p, r, case):
    if case == "context":
        with p.timing.timed("raft.torchtest.scope", registry=r, mode="a"):
            pass
    elif case == "decorator":
        @p.timing.timed("raft.torchtest.rec", registry=r)
        def rec(n):
            return 0 if n == 0 else rec(n - 1) + 1
        assert rec(3) == 3
    elif case == "raises":
        with pytest.raises(KeyError):
            with p.timing.timed("raft.torchtest.fail", registry=r):
                raise KeyError("x")
    elif case == "metrics_off":
        r.set_enabled(False)
        with p.timing.timed("raft.torchtest.off", registry=r):
            pass


@pytest.mark.parametrize("case", ["context", "decorator", "raises",
                                  "metrics_off"])
def test_timed_agrees(case, monkeypatch):
    """``<name>.seconds`` under one fake clock, the trace range opened
    (also with metrics off), the observation made when the body
    raises."""
    from raft_tpu.core import trace as jtrace
    from raft_tpu_torch.core import trace as ttrace
    out = {}
    for (name, p), trace_mod in zip(PKGS.items(), (jtrace, ttrace)):
        ranges = []

        class _Range:
            def __init__(self, n):
                ranges.append(n)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        monkeypatch.setattr(trace_mod, "range", _Range)
        monkeypatch.setattr(p.timing, "time", Clock(step=0.25).module())
        r = p.reg.MetricsRegistry(enabled=True)
        _timed_program(p, r, case)
        out[name] = (r.snapshot(), r.to_prometheus_text(), ranges)
    assert out["torch"] == out["jax"]
    assert out["torch"][2], "no trace range was opened"


# ---------------------------------------------------------------------------
# Spans, traceparent, the recorder
# ---------------------------------------------------------------------------


# a serving plan's stage spans: the JAX package's are attributed shares
# of its compiled program, the port's time the host's issue of each stage
# (checked on their own in the served case)
PLAN_STAGE = "raft.plan.stage."


def _norm_trace(trace):
    """A trace without ids and times: names, parent links (as indices of
    the span list), attributes; the plan stage spans left out."""
    kept = [s for s in trace["spans"] if not s["name"].startswith(PLAN_STAGE)]
    ids = {s["span_id"]: i for i, s in enumerate(kept)}

    def attrs(a):
        return {k: v for k, v in (a or {}).items() if k not in UNCOMPARED}

    return (trace["name"], attrs(trace.get("attrs")),
            "remote_parent" in trace,
            [(s["name"], ids.get(s["parent_id"], s["parent_id"] is not None),
              attrs(s.get("attrs"))) for s in kept])


def _recorded(p, prefix="raft.torchtest."):
    return [_norm_trace(t) for t in reversed(p.rec.RECORDER.requests())
            if t["name"].startswith(prefix)]


def _span_program(S, case):
    if case == "nested":
        with S.span("raft.torchtest.root", user="a") as root:
            root.set_attr("stage", 1)
            with S.span("raft.torchtest.child", i=0):
                S.add_child_span("raft.torchtest.timed",
                                 time.perf_counter(), 0.001, note="x")
            with S.span("raft.torchtest.child", i=1) as c:
                c.set_attrs(extra=True)
                S.add_stage_spans((("raft.torchtest.stage.a", 1.0),
                                   ("raft.torchtest.stage.b", 3.0)),
                                  0.004, tag="t")
            assert S.current_span() is root
            tid = S.current_trace_id()
            parsed = S.parse_traceparent(S.current_traceparent())
            assert parsed == (tid, root.span_id)
    elif case == "exception":
        with pytest.raises(ValueError):
            with S.span("raft.torchtest.root"):
                with S.span("raft.torchtest.inner"):
                    raise ValueError("x")
    elif case == "spanned":
        def fn(n):
            S.current_span().set_attrs(depth=n)
            return 0 if n == 0 else rec(n - 1) + 1
        rec = S.spanned("raft.torchtest.rec", kind="r")(fn)
        assert rec(2) == 2
    elif case == "disabled":
        S.set_trace_enabled(False)
        with S.span("raft.torchtest.root") as sp:
            sp.set_attr("a", 1)
            S.add_child_span("raft.torchtest.c", 0.0, 0.0)
            assert S.current_traceparent() is None
        S.set_trace_enabled(True)
    elif case == "mid_disable":
        with S.span("raft.torchtest.root"):
            S.set_trace_enabled(False)
            with S.span("raft.torchtest.lost"):
                S.add_stage_spans((("raft.torchtest.s", 1.0),), 0.001)
            S.set_trace_enabled(True)
            with S.span("raft.torchtest.kept"):
                pass
    elif case == "sampled":
        S.set_trace_sample_rate(0.5, seed=3)
        for i in range(24):
            with S.span("raft.torchtest.req", i=i):
                with S.span("raft.torchtest.child", i=i):
                    pass
        S.set_trace_sample_rate(1.0)
    elif case == "no_trace":
        S.add_child_span("raft.torchtest.orphan", 0.0, 0.1)
        S.add_stage_spans((("raft.torchtest.s", 1.0),), 0.1)
        assert S.current_trace_id() is None
        assert S.current_traceparent() is None


SPAN_CASES = ("nested", "exception", "spanned", "disabled",
              "mid_disable", "sampled", "no_trace")


@pytest.mark.parametrize("case", SPAN_CASES)
def test_span_programs_record_alike(case):
    out = {name: (_span_program(p.sp, case), _recorded(p))[1]
           for name, p in PKGS.items()}
    assert out["torch"] == out["jax"]
    if case == "sampled":
        assert 0 < len(out["torch"]) < 24


def test_span_name_taxonomy_enforced():
    for p in PKGS.values():
        with pytest.raises(ValueError):
            with p.sp.span("bad name"):
                pass
        with pytest.raises(ValueError):
            with p.sp.span("raft.torchtest.root"):
                p.sp.add_child_span("Bad", 0.0, 0.0)


def test_span_sync_waits_and_records_device_ms():
    value = {"jax": (jnp.ones(4), [jnp.zeros(2)]),
             "torch": (torch.ones(4), [torch.zeros(2)])}
    for name, p in PKGS.items():
        with p.sp.span("raft.torchtest.sync") as sp:
            assert sp.sync(value[name]) >= 0.0
            assert sp.attrs["device_ms"] >= 0.0
    assert _recorded(PKGS["torch"]) == _recorded(PKGS["jax"])


@pytest.mark.parametrize("maker,reader", [("torch", "jax"),
                                          ("jax", "torch")])
def test_traceparent_crosses_packages(maker, reader):
    """A header made by either package parses in the other, and roots a
    remote-parented trace fragment there."""
    mk, rd = PKGS[maker].sp, PKGS[reader].sp
    with mk.span("raft.torchtest.route") as sp:
        hdr = mk.current_traceparent()
        tid, sid = sp.trace_id, sp.span_id
    assert hdr == f"00-{tid}-{sid}-01"
    assert rd.parse_traceparent(hdr) == (tid, sid)
    rd.set_trace_sample_rate(0.0)       # remote parents bypass sampling
    with rd.span("raft.torchtest.replica", remote_parent=hdr) as rsp:
        assert rsp.trace_id == tid and rsp.parent_id == sid
    frag = PKGS[reader].rec.RECORDER.fragments(tid)
    assert len(frag) == 1 and frag[0]["remote_parent"] == sid


@pytest.mark.parametrize("header", [
    None, "", "garbage", "01-abc-def-01", "00-abc-def-1", "00-abc-def-zz",
    "00--def-01", "00-abc--01", " 00-12a-00000003-01 ",
    "00-1f2e-0000000a-00000002-01", "00-a-b-c-d-ff"])
def test_traceparent_parsing_is_lenient_alike(header):
    assert tspans.parse_traceparent(header) == \
        jspans.parse_traceparent(header)


def _trace(i, dur, name="raft.torchtest.search", **extra):
    return {"trace_id": f"t{i}", "name": name, "start_unix": 100.0 + i,
            "duration_ms": dur, "ts_unix": 200.0 + i,
            "spans": [{"name": name, "span_id": f"{i:08x}",
                       "parent_id": None, "t_start_ms": 0.0,
                       "duration_ms": dur, "tid": 7 + (1 << 40),
                       "attrs": {"rank": i % 2, "k": 3}},
                      {"name": "raft.torchtest.child",
                       "span_id": f"{i + 100:08x}",
                       "parent_id": f"{i:08x}", "t_start_ms": 0.5,
                       "duration_ms": dur / 2, "tid": 7}],
            **extra}


def test_recorder_rings_agree():
    """Ring capacity, the slow ring and log (request traces only),
    ``get``, ``fragments``, ``to_json``."""
    out = {}
    for name, p in PKGS.items():
        r = p.rec.FlightRecorder(capacity=3, slow_ms=5.0,
                                 slow_capacity=2,
                                 registry=p.reg.MetricsRegistry(True))
        for i, dur in enumerate((1.0, 6.0, 2.0, 9.0, 3.0)):
            r.record(_trace(i, dur))
        r.record(_trace(5, 50.0, name="raft.torchtest.build"))
        r.record(_trace(6, 50.0, name="raft.torchtest.x",
                        attrs={"request": True}))
        r.record(_trace(3, 1.0, remote_parent="abc"))
        js = r.to_json(2)
        js.pop("now_unix")
        out[name] = (
            [t["trace_id"] for t in r.requests()],
            [t["trace_id"] for t in r.slow_requests()],
            r.get("t1") is not None, r.get("t0"),
            [t.get("remote_parent") for t in r.fragments("t3")],
            len(r), r.recorded_total, js,
            r._registry.snapshot()["counters"])
        r.clear()
        assert len(r) == 0 and r.requests() == []
    assert out["torch"] == out["jax"]


def test_recorder_deferred_entries_agree():
    """Traces kept as their parts (``_Deferred``, a served batch's
    request traces) and recorded under one lock give the rings, the
    slow ring, ``get``, ``fragments`` and ``to_json`` of the JAX
    recorder fed the same traces one by one; each is built once."""
    durs = (1.0, 6.0, 2.0, 9.0, 3.0)
    builds = []

    def build(i, dur):
        builds.append(i)
        return _trace(i, dur)

    out = {}
    for name, p in PKGS.items():
        r = p.rec.FlightRecorder(capacity=3, slow_ms=5.0,
                                 slow_capacity=2,
                                 registry=p.reg.MetricsRegistry(True))
        if name == "torch":
            r._record_many([trec._Deferred(build, (i, dur), dur)
                            for i, dur in enumerate(durs)])
            # the slow ones were built to be checked; the rest wait
            assert sorted(builds) == [1, 3]
        else:
            for i, dur in enumerate(durs):
                r.record(_trace(i, dur))
        r.record(_trace(3, 1.0, remote_parent="abc"))
        js = r.to_json()
        js.pop("now_unix")
        out[name] = (
            [t["trace_id"] for t in r.requests()],
            [t["trace_id"] for t in r.slow_requests()],
            r.get("t2"), [t.get("remote_parent") for t in r.fragments("t3")],
            r.recorded_total, js, r._registry.snapshot()["counters"])
    assert out["torch"] == out["jax"]
    # read many times, built once; t0 and t2 fell out of the ring unbuilt
    assert sorted(builds) == [1, 3, 4]


def test_chrome_trace_and_stitch_agree():
    t = _trace(1, 4.0)
    out = {}
    for name, p in PKGS.items():
        chrome = p.rec.to_chrome_trace(t)
        meta = chrome["traceEvents"][0]
        assert meta["ph"] == "M" and meta["args"]["name"].endswith(" t1")
        meta["args"]["name"] = meta["args"]["name"].split(" ", 1)[1]
        stitched = p.rec.stitch_chrome_trace(
            [_trace(2, 3.0, remote_parent="x"), _trace(2, 8.0)],
            instances=["r1", ""], skews_s=[0.5, 0.0])
        out[name] = (chrome, stitched)
        json.dumps(out[name])
    assert out["torch"] == out["jax"]
    events = out["torch"][0]["traceEvents"][1:]
    assert [e["name"] for e in events] == ["raft.torchtest.search",
                                           "raft.torchtest.child"]
    assert all(e["tid"] < (1 << 31) for e in events)


class _FragmentHandler(http.server.BaseHTTPRequestHandler):
    body = b"{}"

    def do_GET(self):  # noqa: N802 (the stdlib's name)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *args):
        pass


def _closed_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fetch_and_stitch_from_endpoints_agree():
    """A local peer serving ``/debug/requests`` and one that is down:
    both packages fetch the same fragments and stitch the same lanes,
    the down peer listed as unreachable."""
    _FragmentHandler.body = json.dumps(
        {"now_unix": time.time(),
         "fragments": [_trace(4, 2.0, remote_parent="a")]}).encode()
    srv = http.server.HTTPServer(("127.0.0.1", 0), _FragmentHandler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    out = {}
    try:
        for name, p in PKGS.items():
            p.sp.set_trace_enabled(False)    # keep local rings empty
            frags, skew = p.rec.fetch_fragments(url, "t4", timeout_s=5.0)
            assert abs(skew) < 5.0
            st = p.rec.stitch_from_endpoints(
                "t4", {"up": url,
                       "down": f"http://127.0.0.1:{_closed_port()}"},
                recorder=p.rec.FlightRecorder(), timeout_s=5.0)
            out[name] = (frags, st["otherData"]["unreachable"],
                         st["otherData"]["fragments"],
                         [(e["name"], e["pid"], e["args"].get("instance"))
                          for e in st["traceEvents"]])
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not th.is_alive()
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == ["down"] and out["torch"][2] == 1


# ---------------------------------------------------------------------------
# The resource profiler
# ---------------------------------------------------------------------------


def _profile_series(snap):
    return {kind: {k: v for k, v in series.items()
                   if k.startswith("raft.obs.profile.")}
            for kind, series in snap.items()}


def test_profiler_rate_zero_attaches_nothing():
    out = {}
    for name, p in PKGS.items():
        before = _profile_series(p.ob.snapshot())
        assert p.prof.enable_profiling(0.0) is None
        assert p.prof.state() is None and p.prof.sampled() is False
        p.prof.tag_dispatch("x")
        p.prof.note_compile("plan", 1.0)
        p.prof.record_sample(program="plan", host_s=1.0, device_s=1.0)
        p.prof.record_dispatch(0.0, 0.0, None, program="plan")
        assert p.prof.duty_cycle() is None
        assert p.prof.profile_sample_rate() == 0.0
        assert _profile_series(p.ob.snapshot()) == before
        out[name] = p.prof.report()
        # attach, then detach by rate 0
        assert p.prof.enable_profiling(0.5, start=False) is not None
        p.prof.set_profile_sample_rate(0.0)
        assert p.prof.state() is None
    assert out["torch"] == out["jax"] == {"enabled": False, "rate": 0.0}
    assert not _profiler_threads()


def test_profiler_config_refusals_agree():
    for p in PKGS.values():
        with pytest.raises(ValueError):
            p.prof.ProfilerConfig(window_s=0.0)
        with pytest.raises(ValueError):
            p.prof.ProfilerConfig(hbm_headroom_frac=1.5)
    assert tprof.SYNC_SPAN == jprof.SYNC_SPAN


def test_sampling_thins_with_the_same_draws():
    draws = {}
    for name, p in PKGS.items():
        p.prof.enable_profiling(0.25, p.prof.ProfilerConfig(hbm_poll_ms=0),
                                seed=7)
        draws[name] = [p.prof.sampled() for _ in range(2000)]
        assert p.prof.profile_sample_rate() == 0.25
    assert draws["torch"] == draws["jax"]
    assert 350 < sum(draws["torch"]) < 650


def _profile_program(p, clock):
    """Sampled dispatches under two tags, the compile ledger, a
    dispatch recorded with its own split, then the window pruned."""
    reports = []
    p.prof.tag_dispatch("a")
    p.prof.record_sample(program="plan", family="ivf_flat", rung=4,
                         host_s=0.002, device_s=0.010)
    clock.t += 1.0
    p.prof.tag_dispatch("b")
    p.prof.record_sample(program="plan", family="ivf_flat", rung=2,
                         host_s=0.004, device_s=0.030)
    p.prof.note_compile("plan", 0.5)
    p.prof.note_compile("plan", 0.25)
    clock.t += 2.0
    with p.sp.span("raft.torchtest.request"):
        t0 = clock.t
        clock.t += 0.001
        t_enq = clock.t
        clock.t += 0.003
        p.prof.record_dispatch(t0, t_enq, None, program="plan",
                               family="f", rung=8)
    reports.append(p.prof.report())
    reports.append((p.prof.duty_cycle(), p.prof.duty_cycle(tag="a"),
                    p.prof.duty_cycle(tag="zz")))
    clock.t += 100.0            # everything falls out of the window
    reports.append(p.prof.report())
    return reports


def test_profiler_report_agrees_under_one_clock(monkeypatch):
    out = {}
    for name, p in PKGS.items():
        clock = Clock()
        monkeypatch.setattr(p.prof, "time", clock.module())
        before = p.ob.snapshot()
        p.prof.enable_profiling(
            0.5, p.prof.ProfilerConfig(hbm_poll_ms=0, window_s=60.0),
            seed=0)
        reports = _profile_program(p, clock)
        for rep in (reports[0], reports[2]):
            rep.pop("hbm")
        diff = p.ob.snapshot_diff(before, p.ob.snapshot())
        out[name] = (reports, _profile_series(diff), _recorded(p),
                     p.prof.endpoint_body(p.ob.snapshot())["samples"])
    assert out["torch"] == out["jax"]
    first = out["torch"][0][0]
    assert first["samples"] == 3 and set(first["tags"]) == {"a", "b"}
    assert first["compile_seconds"] == {"plan": 0.75}
    # extrapolated by the rate: 0.043 s of device time sampled at 0.5
    # over the 3.004 s the profiler has lived
    assert first["duty_cycle"] == pytest.approx(0.043 / 0.5 / 3.004,
                                                abs=1e-6)
    assert out["torch"][2][0][3][0][0] == tprof.SYNC_SPAN


@pytest.mark.parametrize("gauges", ["profile", "none"])
def test_endpoint_body_from_gauges_agrees(gauges):
    snap = {"gauges": {}}
    if gauges == "profile":
        snap["gauges"] = {
            "raft.obs.profile.duty_cycle{device=cpu:0}": 0.25,
            "raft.obs.profile.hbm.bytes_in_use{device=cpu:0}": 10.0,
            "raft.obs.profile.hbm.limit_bytes{device=cpu:0}": 100.0,
            "raft.obs.profile.hbm.low_headroom": 0.0,
            "raft.torchtest.other": 1.0}
    assert tprof.endpoint_body(snap) == jprof.endpoint_body(snap)


def _fake_hbm(dev):
    """The same allocator stats for a JAX device (``id``) and a torch
    device (``index``): device 1 is nearly full."""
    idx = dev.id if hasattr(dev, "id") else dev.index
    limit = 1000 * (idx + 1)
    in_use = limit - 50 if idx == 1 else 100 * idx
    return {"bytes_in_use": in_use, "peak_bytes_in_use": in_use + 7,
            "bytes_limit": limit, "source": "fake"}


def test_hbm_gauges_and_low_headroom_agree(monkeypatch):
    """The memory sampler over eight devices (the test process's JAX
    CPU mesh, and eight devices handed to the port's sampler) with
    ``hbm_stats`` patched alike in both packages."""
    import jax
    n_dev = len(jax.local_devices())
    monkeypatch.setattr(tprof, "_hbm_devices", lambda: [
        torch.device("cpu", i) for i in range(n_dev)])
    out = {}
    for name, p in PKGS.items():
        monkeypatch.setattr(p.memory, "hbm_stats", _fake_hbm)
        st = p.prof.enable_profiling(
            1.0, p.prof.ProfilerConfig(hbm_poll_ms=0,
                                       hbm_headroom_frac=0.1), seed=0)
        st._sample_hbm(p.memory)
        hbm = {k: v for k, v in p.ob.snapshot()["gauges"].items()
               if k.startswith("raft.obs.profile.hbm.")}
        out[name] = (hbm, p.prof.report()["hbm"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["raft.obs.profile.hbm.low_headroom"] == 1.0
    assert out["torch"][1]["cpu:1"]["peak_bytes"] == 1957


def test_hbm_sampler_sets_nothing_on_the_cpu():
    """Without a card the port's sampler polls no device: the CPU's
    answer is no memory gauge, and the sampler thread still runs and
    joins."""
    assert tmemory.hbm_stats("cpu") == {}
    before = {k for k in tobs.snapshot()["gauges"]
              if k.startswith("raft.obs.profile.hbm.")}
    st = tprof.enable_profiling(1.0, tprof.ProfilerConfig(hbm_poll_ms=1.0),
                                seed=0, start=False)
    assert not _profiler_threads()          # deferred to the first draw
    assert tprof.sampled()
    assert _profiler_threads()
    st._sample_hbm(tmemory)
    tprof.disable_profiling()
    assert not _profiler_threads()
    after = {k for k in tobs.snapshot()["gauges"]
             if k.startswith("raft.obs.profile.hbm.")}
    assert after == before


def test_env_knobs_in_a_fresh_process():
    """``RAFT_TPU_PROFILE_*``, ``RAFT_TPU_TRACE*`` and
    ``RAFT_TPU_METRICS`` read at import, as the JAX package reads them;
    the env attach starts no thread."""
    code = (
        "import threading, json\n"
        "from raft_tpu_torch import obs\n"
        "from raft_tpu_torch.obs import profiler, spans\n"
        "st = profiler.state()\n"
        "print(json.dumps([st.rate, st.cfg.window_s, st.cfg.hbm_poll_ms,"
        " st.cfg.hbm_headroom_frac, spans.trace_enabled(),"
        " spans.trace_sample_rate(), obs.RECORDER.capacity,"
        " obs.RECORDER.slow_ms, obs.enabled(),"
        " [t.name for t in threading.enumerate()]]))\n")
    env = dict(os.environ, RAFT_TPU_PROFILE_SAMPLE="0.5",
               RAFT_TPU_PROFILE_WINDOW="12", RAFT_TPU_PROFILE_HBM_MS="7",
               RAFT_TPU_PROFILE_HBM_HEADROOM="0.2", RAFT_TPU_TRACE="0",
               RAFT_TPU_TRACE_SAMPLE="0.25", RAFT_TPU_TRACE_RING="7",
               RAFT_TPU_TRACE_SLOW_MS="12.5", RAFT_TPU_METRICS="0",
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    vals = json.loads(out.stdout.strip().splitlines()[-1])
    assert vals[:9] == [0.5, 12.0, 7.0, 0.2, False, 0.25, 7, 12.5, False]
    assert PROFILER_THREAD not in vals[9]


# ---------------------------------------------------------------------------
# The served path: SearchServer and plans in both packages
# ---------------------------------------------------------------------------

K = 10
EXACT = dict(n_probes=4, scan_bins=-1, probe_cap=64)
SIZES = (3, 1, 8, 5, 2)


@pytest.fixture(scope="module")
def index_pair(tmp_path_factory):
    rng = np.random.default_rng(0)
    c = rng.normal(size=(24, 16)).astype(np.float32)
    x = (c[rng.integers(0, 24, 2000)]
         + rng.normal(size=(2000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 24, 64)]
         + rng.normal(size=(64, 16))).astype(np.float32)
    jidx = jflat.build(x, jflat.IndexParams(n_lists=16, kmeans_n_iters=4))
    path = str(tmp_path_factory.mktemp("obs") / "flat.npz")
    jser.save_ivf_flat(jidx, path)
    return {"jax": jidx, "torch": tser.load_ivf_flat(path, device="cpu")}, q


def _server(name, index, q):
    flat = jflat if name == "jax" else tflat
    p = PKGS[name]
    return p.serve.SearchServer.from_index(
        index, q[:8], K, params=flat.SearchParams(**EXACT),
        config=p.serve.ServeConfig(batch_sizes=(1, 8), max_wait_ms=0.0))


def _serve_serially(srv, q):
    out, s = [], 0
    for n in SIZES:
        out.append(srv.search(q[s:s + n], timeout=120)[1])
        s += n
    return out


def _serve_histograms(diff):
    return {k: v for k, v in diff["histograms"].items()
            if k.startswith("raft.serve.")}


def test_served_traces_histograms_and_samples_agree(index_pair):
    """Serial requests (one request a batch, so batches are the same in
    both packages) with tracing at 1 and the profiler at 1: the span
    trees of every request and batch, the count of every shared
    ``raft.serve.*`` histogram and the sums of the size-shaped ones, and
    one profiler sample per blocking dispatch."""
    indexes, q = index_pair
    out = {}
    for name, p in PKGS.items():
        srv = _server(name, indexes[name], q)
        try:
            p.rec.RECORDER.clear()
            p.prof.enable_profiling(1.0, p.prof.ProfilerConfig(
                hbm_poll_ms=0), seed=0)
            before = p.ob.snapshot()
            ids = _serve_serially(srv, q)
            diff = p.ob.snapshot_diff(before, p.ob.snapshot())
        finally:
            srv.close()
        hist = _serve_histograms(diff)
        counters = diff["counters"]
        batches = sum(v for k, v in counters.items()
                      if k.split("{")[0] == "raft.serve.batch.total")
        samples = counters.get(
            "raft.obs.profile.samples.total{program=plan}", 0)
        out[name] = (
            [np.asarray(i).tolist() for i in ids],
            _recorded(p, "raft.serve."),
            {k: (h["count"], h["buckets"] if "seconds" not in k else None,
                 round(h["sum"], 9) if "seconds" not in k else None)
             for k, h in hist.items()},
            batches, samples)
    assert out["torch"] == out["jax"]
    traces = out["torch"][1]
    assert len(traces) == 2 * len(SIZES)
    batch = traces[0][3]
    names = [s[0] for s in batch]
    assert names.count("raft.serve.queue_wait") == 1
    # execute -> plan.search -> profile.sync, with the stage children
    execute = names.index("raft.serve.execute")
    search = names.index("raft.plan.search")
    sync = names.index(tprof.SYNC_SPAN)
    assert batch[search][1] == execute and batch[sync][1] == search
    assert batch[search][2]["blocked"] is True
    # the port's stage spans: the scan, then the output conventions, each
    # measured inside its plan.search span
    for tr in trec.RECORDER.requests():
        if tr["name"] != "raft.serve.batch":
            continue
        by_id = {s["span_id"]: s for s in tr["spans"]}
        stages = [s for s in tr["spans"] if s["name"].startswith(PLAN_STAGE)]
        assert [s["name"] for s in stages] == [
            "raft.plan.stage.scan", "raft.plan.stage.postprocess"]
        for st in stages:
            parent = by_id[st["parent_id"]]
            assert parent["name"] == "raft.plan.search"
            assert "attributed" not in st.get("attrs", {})
            assert parent["t_start_ms"] <= st["t_start_ms"]
            assert st["t_start_ms"] + st["duration_ms"] <= \
                parent["t_start_ms"] + parent["duration_ms"] + 1e-3
    assert out["torch"][3] == len(SIZES) == out["torch"][4]
    assert set(out["torch"][2]) == {
        "raft.serve.batch.size", "raft.serve.batch.occupancy",
        "raft.serve.queue.delay.seconds", "raft.serve.request.seconds"}
    assert all(v[0] == len(SIZES) for v in out["torch"][2].values())


def test_sampled_request_traces_agree(index_pair):
    """At a trace sample rate below 1 both packages admit the same batch
    and request traces at one seed: one draw a root, in the same
    order."""
    indexes, q = index_pair
    out = {}
    for name, p in PKGS.items():
        p.sp.set_trace_sample_rate(0.5, seed=3)
        srv = _server(name, indexes[name], q)
        try:
            p.rec.RECORDER.clear()
            _serve_serially(srv, q)
        finally:
            srv.close()
        out[name] = _recorded(p, "raft.serve.")
    assert out["torch"] == out["jax"]
    kinds = [t[0] for t in out["torch"]]
    assert 0 < len(kinds) < 2 * len(SIZES) and "raft.serve.request" in kinds


def test_request_trace_spans_the_request(index_pair):
    """A served request's root span runs from its submit to its
    results, its queue wait and execution inside it, all on the
    dispatcher's thread, though the trace is built when it is read."""
    indexes, q = index_pair
    srv = _server("torch", indexes["torch"], q)
    try:
        t0 = time.perf_counter()
        srv.search(q[:3], timeout=120)
        wall_ms = (time.perf_counter() - t0) * 1e3
        traces = [t for t in trec.RECORDER.requests()
                  if t["name"] == "raft.serve.request"]
    finally:
        srv.close()
    assert len(traces) == 1
    tr = traces[0]
    spans_ = {s["name"]: s for s in tr["spans"]}
    root, wait, exe = (spans_["raft.serve.request"],
                       spans_["raft.serve.queue_wait"],
                       spans_["raft.serve.execute"])
    assert root["t_start_ms"] == 0.0 == wait["t_start_ms"]
    assert 0 < root["duration_ms"] == tr["duration_ms"] <= wall_ms
    assert root["duration_ms"] == tr["attrs"]["latency_ms"]
    end = exe["t_start_ms"] + exe["duration_ms"]
    assert wait["duration_ms"] <= exe["t_start_ms"] + 1e-3
    assert end <= root["duration_ms"] + 1e-3
    assert {s["tid"] for s in tr["spans"]} == {
        s["tid"] for s in trec.RECORDER.requests()[1]["spans"]}
    assert root["tid"] != threading.get_ident()


def test_server_with_tracing_off_and_rate_zero_records_nothing(index_pair):
    indexes, q = index_pair
    tspans.set_trace_enabled(False)
    srv = _server("torch", indexes["torch"], q)
    try:
        before = tobs.snapshot()
        _serve_serially(srv, q)
        diff = tobs.snapshot_diff(before, tobs.snapshot())
    finally:
        srv.close()
    assert len(trec.RECORDER) == 0
    assert tprof.state() is None and not _profiler_threads()
    assert not _profile_series(diff)["counters"]
    assert diff["histograms"]["raft.serve.request.seconds"]["count"] == \
        len(SIZES)


def test_trace_context_parents_the_request_root(index_pair):
    indexes, q = index_pair
    srv = _server("torch", indexes["torch"], q)
    try:
        with tspans.span("raft.torchtest.route") as route:
            srv.search(q[:2], timeout=120)
        srv.submit(q[:1], trace_context="00-cafe-0000beef-01").result(120)
    finally:
        srv.close()
    frags = trec.RECORDER.fragments(route.trace_id)
    roots = {f["name"]: f for f in frags}
    assert roots["raft.serve.request"]["remote_parent"] == route.span_id
    assert trec.RECORDER.fragments("cafe")[0]["remote_parent"] == \
        "0000beef"


def test_shed_and_deadline_requests_are_spanned_alike(index_pair):
    """A closed server's refusal and a request whose deadline passed in
    the queue each leave a ``raft.serve.request`` trace with their
    outcome, and move the shed-rate gauge, in both packages."""
    indexes, q = index_pair
    out = {}
    for name, p in PKGS.items():
        srv = _server(name, indexes[name], q)
        srv.close()
        with pytest.raises(Exception) as e:
            srv.search(q[:1], timeout=60)
        assert type(e.value).__name__ == "RejectedError"
        rate = p.ob.snapshot()["gauges"]["raft.serve.shed.rate"]
        stalled = p.serve.SearchServer(srv.ladder, p.serve.ServeConfig(
            batch_sizes=(1, 8)), start=False)
        fut = stalled.submit(q[:1], deadline_ms=1.0)
        time.sleep(0.01)
        stalled.start()
        with pytest.raises(Exception) as e:
            fut.result(60)
        assert type(e.value).__name__ == "DeadlineExceeded"
        stalled.close()
        out[name] = (_recorded(p, "raft.serve."), rate > 0)
    assert out["torch"] == out["jax"]
    outcomes = [t[1]["outcome"] for t in out["torch"][0]]
    assert outcomes == ["shed", "deadline"]


def test_search_batched_spans_agree(index_pair):
    indexes, q = index_pair
    out = {}
    for name, p in PKGS.items():
        mod = jplan if name == "jax" else tplan
        flat = jflat if name == "jax" else tflat
        pl = mod.warmup(indexes[name], q[:8], K, flat.SearchParams(**EXACT))
        p.rec.RECORDER.clear()
        _, i = pl.search_batched(q[:21])
        out[name] = (np.asarray(i).tolist(),
                     _recorded(p, "raft.plan.search_batched"),
                     pl.sync_free)
    assert out["torch"] == out["jax"]
    spans_ = out["torch"][1][0][3]
    assert [s[0] for s in spans_] == ["raft.ann.sub_batch"] * 3 + [
        "raft.plan.search_batched"]
    assert spans_[2][2]["padded"] == 3 and spans_[2][1] == 3


# ---------------------------------------------------------------------------
# F10: one metric name, one kind, across both packages
# ---------------------------------------------------------------------------


def test_metric_kinds_agree_across_packages():
    """graftlint's taxonomy scan over every ``raft_tpu`` file, then every
    ``raft_tpu_torch`` file, with shared state: a name the port
    registers under another kind than the JAX package (GL011), or off
    the taxonomy (GL010), is a finding. Call sites that pass a variable
    name are not seen."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools.graftlint.rules.metrics import check_events
    seen, span_seen, literals = {}, {}, {}
    findings = []
    for pkg in ("raft_tpu", "raft_tpu_torch"):
        for path in sorted(glob.glob(os.path.join(REPO, pkg, "**", "*.py"),
                                     recursive=True)):
            rel = os.path.relpath(path, REPO)
            with open(path) as f:
                text = f.read()
            findings += [(rel, line, code, msg) for line, code, msg in
                         check_events(rel, text, seen, span_seen, literals)]
    assert findings == []
    assert seen["raft.kmeans.fit.iterations"][0] == "histogram"

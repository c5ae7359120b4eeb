"""The port's declarative SLOs (``raft_tpu_torch.obs.slo``) against the JAX
package's ``raft_tpu.obs.slo``, on the CPU.

Both packages' trackers read private registries fed the same counter,
histogram and gauge sequence and tick under one injected clock: every
``tick`` report, the ``raft.slo.*`` gauges and counters each writes into
its registry, and ``endpoint_body`` (from a running tracker and from
the gauges alone) must be equal. The latency objective's threshold sits
between two bucket edges of ``serve.SERVE_LATENCY_BUCKETS``, so both
round it down alike.

Metric names come from tables, never literal instrument calls (the
repo's taxonomy lint scans ``tests/``).
"""

import time
import types

import pytest

from raft_tpu import serve as jserve
from raft_tpu.core.error import LogicError as JLogicError
from raft_tpu.obs import registry as jreg
from raft_tpu.obs import slo as jslo
from raft_tpu_torch import serve as tserve
from raft_tpu_torch.core.error import LogicError as TLogicError
from raft_tpu_torch.obs import registry as treg
from raft_tpu_torch.obs import slo as tslo

PKGS = {
    "jax": types.SimpleNamespace(reg=jreg, slo=jslo, serve=jserve,
                                 err=JLogicError),
    "torch": types.SimpleNamespace(reg=treg, slo=tslo, serve=tserve,
                                   err=TLogicError),
}
BOTH = sorted(PKGS)

REQUESTS = "raft.serve.requests.total"
FAILS = ("raft.serve.shed.total", "raft.serve.deadline.total",
         "raft.serve.errors.total")
LATENCY = "raft.serve.request.seconds"
RECALL = "raft.obs.quality.recall"


def _objectives(ns):
    o = ns.slo.Objective
    return [o("p99_latency", "latency", target=0.9, threshold_ms=12.0,
              windows=(10.0, 30.0)),
            o("availability", "availability", target=0.99,
              windows=(10.0, 30.0), burn_threshold=2.0),
            o("recall_floor", "recall", target=0.9, tolerance=0.05,
              windows=(10.0,))]


# each step: (seconds of latency of each request, failures by counter,
# recall of the full-coverage series, recall of a partial one)
STEPS = (
    [((0.004,) * 20, (0, 0, 0), 0.95, None)] * 4
    + [((0.004,) * 10 + (0.011,) * 10, (3, 1, 0), 0.95, 0.5)] * 4
    + [((0.05,) * 20, (0, 0, 2), 0.80, 0.5)] * 4
    + [((), (0, 0, 0), 0.80, None)] * 2
    + [((0.004,) * 20, (0, 0, 0), 0.97, None)] * 6
)


def _feed(ns, reg, step):
    lats, fails, recall, partial = step
    reg.counter(REQUESTS).inc(len(lats) + sum(fails))
    for name, n in zip(FAILS, fails):
        if n:
            reg.counter(name).inc(n)
    h = reg.histogram(LATENCY, buckets=ns.serve.SERVE_LATENCY_BUCKETS)
    for v in lats:
        h.observe(v)
    reg.gauge(RECALL, family="ivf_flat", k="10").set(recall)
    if partial is not None:
        reg.gauge(RECALL, family="ivf_flat", k="10",
                  coverage="partial").set(partial)


def _slo_series(snap):
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith("raft.slo.")}
            for kind in ("counters", "gauges")}


def _run(name):
    ns = PKGS[name]
    reg = ns.reg.MetricsRegistry(True)
    clock = {"t": 1000.0}
    tracker = ns.slo.SLOTracker(_objectives(ns), registry=reg, poll_s=5.0,
                                clock=lambda: clock["t"], start=False)
    try:
        assert ns.slo.active() is tracker
        reports = []
        for step in STEPS:
            _feed(ns, reg, step)
            reports.append(tracker.tick())
            clock["t"] += 5.0
        snap = reg.snapshot()
        live = ns.slo.endpoint_body(snap)
        assert tracker.report() == reports[-1]
    finally:
        tracker.close()
    assert ns.slo.active() is None
    return reports, _slo_series(snap), live, ns.slo.endpoint_body(snap)


def test_tick_reports_gauges_and_bodies_like_jax():
    got = {p: _run(p) for p in BOTH}
    assert got["torch"] == got["jax"]
    reports, series, live, from_gauges = got["torch"]
    # cold windows report None, then each objective breaches and heals
    assert reports[0]["p99_latency"]["burn"] == {"10s": None, "30s": None}
    assert any(r["p99_latency"]["breach"] for r in reports)
    assert any(r["availability"]["breach"] for r in reports)
    assert any(r["recall_floor"]["breach"] for r in reports)
    assert not any(r[o]["breach"] for r in reports[-1:] for o in r)
    assert live["source"] == "tracker"
    assert from_gauges["source"] == "gauges"
    assert series["gauges"]["raft.slo.objectives"] == 3
    assert series["counters"][
        "raft.slo.breach.total{objective=p99_latency}"] == 1


def test_threshold_rounds_down_to_a_bucket_edge():
    """12 ms lies between the 10 ms and 25 ms edges: an 11 ms request
    counts as slow in both packages."""
    out = {}
    for name in BOTH:
        ns = PKGS[name]
        reg = ns.reg.MetricsRegistry(True)
        _feed(ns, reg, ((0.011,) * 4 + (0.009,) * 4, (0, 0, 0), 1.0, None))
        out[name] = ns.slo._latency_counts(reg.snapshot(), 0.012)
    assert out["torch"] == out["jax"] == (8.0, 4.0)
    assert tserve.SERVE_LATENCY_BUCKETS == jserve.SERVE_LATENCY_BUCKETS


def test_no_tracker_and_no_gauges():
    for name in BOTH:
        assert PKGS[name].slo.active() is None
    empty = {"counters": {}, "gauges": {}, "histograms": {}}
    assert tslo.endpoint_body(empty) == jslo.endpoint_body(empty) == {
        "source": "none", "gauges": {}}


BAD = {
    "name": dict(name="P99", kind="latency", target=0.9, threshold_ms=1.0),
    "kind": dict(name="x", kind="speed", target=0.9),
    "target": dict(name="x", kind="availability", target=1.0),
    "threshold": dict(name="x", kind="latency", target=0.9),
    "windows": dict(name="x", kind="availability", target=0.9,
                    windows=(30.0, 10.0)),
    "tolerance": dict(name="x", kind="recall", target=0.9, tolerance=0.0),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_objective_validation_like_jax(case):
    for name in BOTH:
        ns = PKGS[name]
        with pytest.raises(ns.err):
            ns.slo.Objective(**BAD[case])
    assert tslo.Objective("x", "recall", target=1.0).windows == \
        jslo.Objective("x", "recall", target=1.0).windows


def test_polling_thread_ticks_and_close_joins():
    for name in BOTH:
        ns = PKGS[name]
        reg = ns.reg.MetricsRegistry(True)
        tracker = ns.slo.SLOTracker(
            [ns.slo.Objective("availability", "availability", target=0.9,
                              windows=(0.1,))],
            registry=reg, poll_s=0.02)
        try:
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and reg.snapshot()[
                    "counters"].get("raft.slo.evaluations.total", 0) < 3:
                time.sleep(0.02)
        finally:
            tracker.close()
        assert reg.snapshot()["counters"]["raft.slo.evaluations.total"] >= 3
        assert tracker._thread is None

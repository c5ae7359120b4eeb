"""The port's metric federation (``raft_tpu_torch.obs.federation``) and the
fleet aggregator's endpoint routes against the JAX package's
``raft_tpu.obs.federation``, on the CPU.

* The Prometheus round trip: the same registry calls into private
  registries of both packages give the same exporter text, and both
  packages' ``render_prometheus_text(parse_prometheus_text(text))`` give
  it back byte for byte (counters, gauges, histograms with a +Inf
  observation, escaped labels, NaN and infinities, the port's live
  registry).
* ``merge_families`` of both packages on the same per-instance families
  (values from a numpy seed): equal merged text, counters and histograms
  rolled up, gauges only per instance.
* Federators of both packages over the same registries: staleness (an
  instance failing ``fed.scrape`` ages out of the merged text), the
  scrape-error counters, ``healthz`` worst-of and ``report`` (times left
  out) equal.
* The aggregator: ``obs.serve(federator=...)`` over two CPU
  ``DebugServer``s with private registries and recorders: ``/metrics``
  and ``/fleet/metrics`` the merged text (the JAX package's federator
  over the same two endpoints merges to the same text), the rollup the
  sum, ``/fleet/healthz`` 200 then 503 naming a closed instance,
  ``/debug/fleet``'s federation section, ``/fleet/trace`` stitched from
  the two recorders.

Metric names reach the registries through tables and method calls on
private registries, never as literal module-level instrument calls (the
repo's taxonomy lint scans ``tests/``).
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu.obs import federation as jfed
from raft_tpu.obs import registry as jreg
from raft_tpu.testing import faults as jfaults
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.obs import endpoint as tend
from raft_tpu_torch.obs import federation as tfed
from raft_tpu_torch.obs import recorder as trec
from raft_tpu_torch.obs import registry as treg
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.testing import faults as tfaults

PKGS = {
    "jax": types.SimpleNamespace(fed=jfed, reg=jreg, faults=jfaults),
    "torch": types.SimpleNamespace(fed=tfed, reg=treg, faults=tfaults),
}
BOTH = sorted(PKGS)
NASTY = 'quote:" backslash:\\ newline:\n mixed:\\n'


def _feed(reg, case: str) -> None:
    """One round-trip case's calls into a registry."""
    if case == "basic":
        reg.counter("raft.t.requests.total", help="requests").inc(5)
        reg.counter("raft.t.shed.total", reason="queue_full").inc(2)
        reg.gauge("raft.t.depth").set(3)
        reg.gauge("raft.t.frac").set(0.25)
        h = reg.histogram("raft.t.lat.seconds", buckets=(0.01, 0.1, 1.0))
        h.observe(0.05)
        h.observe(50.0)       # the +Inf bucket only
    elif case == "escaping":
        reg.gauge("raft.t.weird", note=NASTY).set(1)
    elif case == "nonfinite":
        reg.gauge("raft.t.nan").set(float("nan"))
        reg.gauge("raft.t.pinf").set(float("inf"))
        reg.gauge("raft.t.ninf").set(float("-inf"))
    elif case == "seeded":
        rng = np.random.default_rng(7)
        for i in range(6):
            reg.counter("raft.t.ops.total", part=f"p{i}").inc(
                float(rng.integers(1, 1000)))
            reg.gauge("raft.t.level", part=f"p{i}").set(
                float(rng.normal()))
        h = reg.histogram("raft.t.wait.seconds", buckets=(0.001, 0.1, 10.0))
        for v in rng.exponential(0.5, size=64):
            h.observe(float(v))


@pytest.mark.parametrize("case", ["basic", "escaping", "nonfinite",
                                  "seeded", "live"])
def test_round_trip_byte_stable_across(case):
    if case == "live":
        text = tobs.to_prometheus_text()
    else:
        regs = {p: PKGS[p].reg.MetricsRegistry(enabled=True) for p in BOTH}
        for reg in regs.values():
            _feed(reg, case)
        text = regs["torch"].to_prometheus_text()
        assert text == regs["jax"].to_prometheus_text()
    for p in BOTH:
        fed = PKGS[p].fed
        assert fed.render_prometheus_text(
            fed.parse_prometheus_text(text)) == text
    if case == "escaping":
        (fam,) = tfed.parse_prometheus_text(text)
        assert dict(fam.samples[0].labels)["note"] == NASTY


def _instances(seed: int) -> dict:
    """Per-instance exporter text: counters, gauges and a histogram, with
    values from a numpy seed, and one target that already carries an
    ``instance`` label."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("a", "b", "c"):
        reg = treg.MetricsRegistry(enabled=True)
        reg.counter("raft.t.reqs.total").inc(float(rng.integers(1, 99)))
        reg.counter("raft.t.shed.total", reason="full").inc(
            float(rng.integers(0, 9)))
        reg.counter("raft.t.fed.scrapes.total", instance="inner").inc(3)
        reg.gauge("raft.t.depth").set(float(rng.integers(0, 50)))
        h = reg.histogram("raft.t.lat.seconds", buckets=(0.1, 1.0))
        for v in rng.uniform(0.0, 2.0, size=5):
            h.observe(float(v))
        out[name] = reg.to_prometheus_text()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_families_equal_across(seed):
    texts = _instances(seed)
    merged = {}
    for p in BOTH:
        fed = PKGS[p].fed
        merged[p] = fed.render_prometheus_text(fed.merge_families(
            {n: fed.parse_prometheus_text(t) for n, t in texts.items()}))
    assert merged["torch"] == merged["jax"]
    text = merged["torch"]
    totals = [float(t.split("\nraft_t_reqs_total_total ")[1].split("\n")[0])
              for t in texts.values()]
    assert f"\nraft_t_reqs_total_total {tfed._fmt(sum(totals))}\n" in text
    assert 'raft_t_depth{instance="a"}' in text
    assert "\nraft_t_depth " not in text
    assert ('raft_t_fed_scrapes_total_total{exported_instance="inner",'
            'instance="a"} 3' in text)
    assert tfed.render_prometheus_text(
        tfed.parse_prometheus_text(text)) == text


def _two_regs(p):
    reg = PKGS[p].reg
    a, b = reg.MetricsRegistry(enabled=True), reg.MetricsRegistry(
        enabled=True)
    a.counter("raft.t.reqs.total").inc(1)
    b.counter("raft.t.reqs.total").inc(2)
    a.gauge("raft.t.depth").set(1)
    b.gauge("raft.t.depth").set(5)
    return a, b


def _report_shape(rep: dict) -> dict:
    """A federator report with its times left out."""
    rows = {n: {k: v for k, v in row.items()
                if k not in ("last_scrape_s", "age_s")}
            for n, row in rep["instances"].items()}
    return {"interval_s": rep["interval_s"],
            "stale_after_s": rep["stale_after_s"], "instances": rows,
            "gauge_rollups": rep["gauge_rollups"]}


def test_federators_equal_across_through_staleness():
    """Both packages' federators over the same two registries: equal
    merged text, report and health while both are live; ``b`` failing
    ``fed.scrape`` ages out of the merged text (absent, not frozen) and
    degrades ``healthz`` alike; one scrape error counted each time."""
    got = {}
    for p in BOTH:
        pk = PKGS[p]
        a, b = _two_regs(p)
        fed = pk.fed.MetricsFederator({"a": a, "b": b}, interval_s=60.0,
                                      stale_after_s=0.05)
        assert fed.scrape_once() == {"scraped": 2, "errors": 0}
        live = (fed.merged_text(), _report_shape(fed.report()),
                fed.healthz())
        key = "raft.obs.fed.scrape.errors{instance=b}"
        before = pk.reg.snapshot()["counters"].get(key, 0.0)
        with pk.faults.inject_fault("fed.scrape", error=RuntimeError,
                                    match={"instance": "b"}):
            time.sleep(0.08)
            out = fed.scrape_once()
        errors = pk.reg.snapshot()["counters"].get(key, 0.0) - before
        got[p] = dict(live=live, out=out, errors=errors,
                      text=fed.merged_text(), stale=fed.stale_instances(),
                      health=fed.healthz(),
                      report=_report_shape(fed.report()))
        fed.close()
    assert got["torch"] == got["jax"]
    g = got["torch"]
    assert "\nraft_t_reqs_total_total 3" in g["live"][0]
    assert g["live"][1]["gauge_rollups"]["raft_t_depth"] == {
        "sum": 6, "min": 1, "max": 5}
    assert g["live"][2]["status"] == "ok"
    assert g["out"] == {"scraped": 2, "errors": 1}
    assert g["errors"] == 1
    assert 'instance="b"' not in g["text"]
    assert g["stale"] == ["b"]
    assert g["health"]["status"] == "degraded"
    assert g["health"]["instances"]["b"] == {"status": "stale"}
    assert g["report"]["instances"]["b"]["state"] == "stale"


def test_federator_blackbox_path_and_membership():
    reg = treg.MetricsRegistry(enabled=True)
    fed = tfed.MetricsFederator({"r0": reg}, interval_s=60.0)
    fed.set_blackbox_path("r0", "/boxes/r0")
    assert fed.report()["instances"]["r0"]["blackbox"] == "/boxes/r0"
    fed.scrape_once()
    row = fed.report()["instances"]["r0"]
    assert row["state"] == "live" and row["blackbox"] == "/boxes/r0"
    fed.set_blackbox_path("r0", None)
    assert "blackbox" not in fed.report()["instances"]["r0"]
    fed.add_instance("r1", "http://127.0.0.1:9")
    assert fed.instance_names() == ["r0", "r1"]
    assert fed.url_instances() == {"r1": "http://127.0.0.1:9"}
    fed.remove_instance("r1")
    assert fed.instance_names() == ["r0"]


def test_scraper_thread_runs_on_cadence():
    reg = treg.MetricsRegistry(enabled=True)
    reg.gauge("raft.t.depth").set(1)
    with tfed.MetricsFederator({"a": reg}, interval_s=0.05) as fed:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and fed.report()[
                "instances"].get("a", {}).get("scrapes", 0) < 2:
            time.sleep(0.02)
        assert fed.report()["instances"]["a"]["scrapes"] >= 2
        assert fed.report()["scrape_overhead"]["frac"] >= 0.0
    assert fed._thread is None


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture
def tracing():
    prev = tspans.trace_enabled()
    tspans.set_trace_enabled(True)
    yield
    tspans.set_trace_enabled(prev)


def test_aggregator_routes_over_two_debug_servers(tracing):
    regs, recs, peers = {}, {}, {}
    for i, name in enumerate(("r0", "r1")):
        regs[name] = treg.MetricsRegistry(enabled=True)
        regs[name].counter("raft.serve.completed.total").inc(3 + 4 * i)
        regs[name].gauge("raft.t.depth").set(i)
        recs[name] = trec.FlightRecorder()
        peers[name] = tend.serve(registry=regs[name], recorder=recs[name])
    urls = {n: s.url for n, s in peers.items()}
    local = trec.FlightRecorder()
    fed = tfed.MetricsFederator(urls, interval_s=60.0, stale_after_s=0.5,
                                timeout_s=2.0)
    jf = jfed.MetricsFederator(urls, interval_s=60.0)
    agg = tend.serve(recorder=local, federator=fed)
    try:
        assert fed.scrape_once() == {"scraped": 2, "errors": 0}
        jf.scrape_once()
        code, text = _get(f"{agg.url}/metrics")
        assert code == 200 and text == fed.merged_text()
        assert text == jf.merged_text()
        assert _get(f"{agg.url}/fleet/metrics") == (200, text)
        assert "\nraft_serve_completed_total_total 10\n" in text
        assert 'raft_serve_completed_total_total{instance="r1"} 7' in text
        code, body = _get(f"{agg.url}/fleet/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body = _get(f"{agg.url}/debug/fleet")
        sec = json.loads(body)["federation"]
        assert code == 200 and sec["instances"]["r0"]["state"] == "live"
        # one request's trace split over the aggregator's recorder and
        # r1's, as a router and a replica would leave it
        box = {}
        with tspans.span("raft.fleet.route", replica="r1") as rt:
            box["hdr"] = tspans.current_traceparent()
            tid, route_sid = rt.trace_id, rt.span_id

        def replica_side():
            with tspans.span("raft.serve.request",
                             remote_parent=box["hdr"], nq=1):
                pass

        th = threading.Thread(target=replica_side)
        th.start()
        th.join()
        for f in tobs.RECORDER.fragments(tid):
            (recs["r1"] if f.get("remote_parent") else local).record(f)
        code, body = _get(f"{agg.url}/fleet/trace?trace={tid}")
        assert code == 200
        evs = {e["name"]: e for e in json.loads(body)["traceEvents"]
               if e["ph"] == "X"}
        assert set(evs) == {"raft.fleet.route", "raft.serve.request"}
        assert evs["raft.fleet.route"]["pid"] != \
            evs["raft.serve.request"]["pid"]
        assert evs["raft.serve.request"]["args"]["parent_id"] == route_sid
        assert _get(f"{agg.url}/fleet/trace?trace=nope")[0] == 404
        assert _get(f"{agg.url}/fleet/trace")[0] == 400
        # r1 goes away: unreachable at once, then stale and absent
        peers.pop("r1").close()
        code, body = _get(f"{agg.url}/fleet/healthz")
        hz = json.loads(body)
        assert code == 503 and hz["status"] == "degraded"
        assert hz["instances"]["r1"]["status"] in ("unreachable", "stale")
        time.sleep(0.6)
        assert fed.scrape_once()["errors"] == 1
        code, body = _get(f"{agg.url}/fleet/healthz")
        assert code == 503 and "r1" in json.loads(body)["stale"]
        assert 'instance="r1"' not in _get(f"{agg.url}/metrics")[1]
    finally:
        agg.close()
        jf.close()
        fed.close()
        for s in peers.values():
            s.close()


def test_unreachable_instance_times_out_without_a_hang():
    fed = tfed.MetricsFederator({"gone": "http://127.0.0.1:9"},
                                interval_s=60.0, timeout_s=0.5)
    t0 = time.monotonic()
    assert fed.scrape_once()["errors"] == 1
    assert time.monotonic() - t0 < 5.0
    assert fed.merged_text() == ""
    assert fed.healthz()["instances"]["gone"] == {"status": "stale"}

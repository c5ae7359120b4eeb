"""The port's metrics history (``raft_tpu_torch.obs.history``) against the
JAX package's ``raft_tpu.obs.history``, on the CPU.

Both packages' ``MetricsHistory`` sample private registries fed the same
counter, gauge and histogram sequence under one fake clock (each
module's ``time`` patched to its own copy of the same clock): after the
ring has evicted frames, ``frames_since``, ``series``, ``delta``,
``rate``, the detectors' table and ``report`` must be equal. The
windowed mean-shift detector must fire once per shift in both (its
gauge and counter read from each package's process registry), and
``endpoint_body`` must give equal codes and bodies, with history on and
off. The ``RAFT_TPU_HISTORY_*`` knobs are read in a fresh process.

Metric names come from tables, never literal instrument calls (the
repo's taxonomy lint scans ``tests/``).
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from raft_tpu import obs as jobs
from raft_tpu.obs import history as jhist
from raft_tpu.obs import registry as jreg
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.obs import history as thist
from raft_tpu_torch.obs import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(ob=jobs, hist=jhist, reg=jreg),
    "torch": types.SimpleNamespace(ob=tobs, hist=thist, reg=treg),
}
BOTH = sorted(PKGS)

REQS = "raft.torchtest.hist.requests"
DEPTH = "raft.torchtest.hist.depth"
LAT = "raft.torchtest.hist.lat"
SHIFT = "raft.torchtest.hist.shift"
SIGNAL = "torchtest_shift"


class Clock:
    """A fake ``time`` module: ``monotonic`` steps by 0.5 s a call, and
    ``time`` by the same from a fixed wall start."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 0.5
        return self.t

    def time(self):
        return 1.7e9 + self.t


@pytest.fixture(autouse=True)
def _one_clock(monkeypatch):
    monkeypatch.setattr(jhist, "time", Clock())
    monkeypatch.setattr(thist, "time", Clock())
    yield
    for ns in PKGS.values():
        ns.hist.disable_history()


def _shift_signal(ns):
    def fn(gauges):
        vals = [v for k, v in gauges.items() if k.split("{")[0] == SHIFT]
        return vals[0] if vals else None
    return (ns.hist.Signal(SIGNAL, fn, min_delta=1.0),)


def _feed(reg, i):
    """Tick ``i``'s registry calls: a counter with a labelled series, a
    gauge that changes every third tick, a histogram, and the watched
    gauge, which steps from 0 to 5 at tick 8 and back at tick 20."""
    reg.counter(REQS, route="a").inc(i % 4)
    if i % 2:
        reg.counter(REQS, route="b").inc(1)
    reg.gauge(DEPTH).set(float(i // 3))
    reg.histogram(LAT, buckets=(0.1, 1.0)).observe(0.05 * i)
    reg.gauge(SHIFT).set(5.0 if 8 <= i < 20 else 0.0)


def _anomaly_state(ob):
    snap = ob.snapshot()
    return (snap["gauges"].get(f"raft.obs.history.anomaly{{signal={SIGNAL}}}"),
            snap["counters"].get(
                f"raft.obs.history.anomaly.total{{signal={SIGNAL}}}", 0.0))


def _run(name, ticks=30):
    ns = PKGS[name]
    reg = ns.reg.MetricsRegistry(True)
    h = ns.hist.MetricsHistory(registry=reg, interval_s=0.5, capacity=6,
                               anomaly_window=3, signals=_shift_signal(ns))
    fired0 = _anomaly_state(ns.ob)[1]
    trail = []
    for i in range(ticks):
        _feed(reg, i)
        h.tick()
        g, c = _anomaly_state(ns.ob)
        trail.append((g, c - fired0))
    q = {}
    for fam in (REQS, DEPTH, LAT, "raft.torchtest.hist", SHIFT):
        for w in (None, 1.2, 100.0):
            q[(fam, w)] = (h.series(fam, w), h.delta(fam, w), h.rate(fam, w))
    return (h.frames_since(0), h.frames_since(27), q, h.anomalies(),
            h.report(), h.report(2.0), h.kind(REQS + "{route=a}"),
            h.kind(DEPTH), h.kind(LAT + ".count"), h.last_seq(), trail)


def test_frames_queries_and_anomalies_like_jax():
    got = {p: _run(p) for p in BOTH}
    assert got["torch"] == got["jax"]
    frames, tail, q, anomalies, report, _, k_c, k_g, k_h, seq, trail = \
        got["torch"]
    # the ring keeps 6 of 30 frames; evicted ones folded into the base
    assert [f["seq"] for f in frames] == list(range(25, 31))
    assert [f["seq"] for f in tail] == [28, 29, 30]
    series = q[(REQS, None)][0]
    assert series[REQS + "{route=a}"][-1][1] == sum(i % 4 for i in range(30))
    assert q[(REQS, None)][1][REQS + "{route=b}"] == 3.0
    assert (k_c, k_g, k_h, seq) == ("counter", "gauge", "counter", 30)
    # the shift up fires once, is held inside the window, the shift back
    # clears it and fires a second time
    fired = [c for _, c in trail]
    assert fired[-1] == 2 and fired.index(1) < fired.index(2)
    assert anomalies[SIGNAL]["fired_total"] == 2
    assert report["frames"] == 6 and report["capacity"] == 6


def test_default_signals_like_jax():
    def table(ns):
        return [(s.name, s.min_delta, s.rel_frac)
                for s in ns.hist.DEFAULT_SIGNALS]
    assert table(PKGS["torch"]) == table(PKGS["jax"])
    gauges = {"raft.serve.shed.rate{server=a}": 1.0,
              "raft.serve.shed.rate{server=b}": 2.0,
              "raft.obs.profile.duty_cycle{device=0}": 0.2,
              "raft.obs.profile.duty_cycle{device=1}": 0.4,
              "raft.obs.profile.hbm.headroom_frac{device=0}": 0.3,
              "raft.obs.quality.recall{k=10}": 0.9,
              "raft.fleet.replication.lag_records{replica=r1}": 12.0}
    for g in (gauges, {}):
        assert [s.fn(g) for s in thist.DEFAULT_SIGNALS] == \
            [s.fn(g) for s in jhist.DEFAULT_SIGNALS]


QUERIES = [
    {},
    {"name": [REQS]},
    {"name": [REQS], "window": ["1.2"], "points": ["1"]},
    {"name": ["raft.torchtest.hist"], "points": ["true"]},
    {"name": ["raft.nothing"]},
    {"window": ["x"]},
]


def test_endpoint_body_on_and_off_like_jax():
    out = {}
    for name in BOTH:
        ns = PKGS[name]
        bodies = [ns.hist.endpoint_body(q) for q in QUERIES]
        reg = ns.reg.MetricsRegistry(True)
        h = ns.hist.enable_history(registry=reg, interval_s=0.5,
                                   capacity=5, start=False,
                                   signals=_shift_signal(ns))
        assert ns.hist.history() is h and h._thread is None
        for i in range(8):
            _feed(reg, i)
            h.tick()
        bodies += [ns.hist.endpoint_body(q) for q in QUERIES]
        ns.hist.disable_history()
        assert ns.hist.history() is None
        bodies.append(ns.hist.endpoint_body({}))
        out[name] = json.loads(json.dumps(bodies))
    assert out["torch"] == out["jax"]
    codes = [c for c, _ in out["torch"]]
    assert codes == [404] * 6 + [200] * 5 + [400, 404]


def test_sampler_thread_and_reattach(monkeypatch):
    for name in BOTH:
        ns = PKGS[name]
        monkeypatch.setattr(ns.hist, "time", time)   # a real thread's clock
        reg = ns.reg.MetricsRegistry(True)
        first = ns.hist.enable_history(registry=reg, interval_s=0.05)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and first.last_seq() < 3:
            time.sleep(0.02)
        assert first.last_seq() >= 3
        second = ns.hist.enable_history(registry=reg, interval_s=0.05)
        assert first._thread is None and second._thread.is_alive()
        ns.hist.disable_history()
        assert second._thread is None


def test_env_knobs_in_a_fresh_process():
    code = (
        "import json\n"
        "from raft_tpu.obs import history as j\n"
        "from raft_tpu_torch.obs import history as t\n"
        "out = []\n"
        "for m in (j, t):\n"
        "    h = m.MetricsHistory()\n"
        "    out.append([h.interval_s, h.capacity])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, RAFT_TPU_HISTORY_INTERVAL="0.01",
               RAFT_TPU_HISTORY_RING="2", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    bad = dict(env, RAFT_TPU_HISTORY_INTERVAL="soon",
               RAFT_TPU_HISTORY_RING="many")
    got = []
    for e in (env, bad):
        r = subprocess.run([sys.executable, "-c", code], env=e, cwd=REPO,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr
        got.append(json.loads(r.stdout.strip().splitlines()[-1]))
    # clamped to 0.05 s and 4 frames; unreadable values take the defaults
    assert got == [[[0.05, 4]] * 2, [[1.0, 512]] * 2]

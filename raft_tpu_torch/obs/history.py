"""Metrics history: the registry over time (counterpart of
``raft_tpu.obs.history``).

The registry answers "what is the value now"; trend questions ("did the
shed rate jump when the compactor started", "has the card's memory
headroom been sinking for a minute") need it sampled on a cadence and
kept. :class:`MetricsHistory` snapshots a
:class:`~raft_tpu_torch.obs.registry.MetricsRegistry` every
``interval_s`` (a daemon sampler thread, or explicit
:meth:`~MetricsHistory.tick` calls in tests) into **delta-compressed
frames**: a frame stores only the counter deltas and the changed gauge
values since the previous frame (histograms fold in as
``<family>.count`` / ``<family>.sum`` counter series), so a quiet
registry costs bytes a frame. Evicted frames fold into a base state, so
absolute series reconstruct exactly over the whole retained window:

* :meth:`~MetricsHistory.series`: absolute ``(t_unix, value)`` points
  per matched series;
* :meth:`~MetricsHistory.rate` / :meth:`~MetricsHistory.delta`:
  ``(last - first) / span`` and ``last - first`` over a window,
  computed server-side (the ``GET /debug/history?name=&window=`` body,
  :func:`endpoint_body`);
* :meth:`~MetricsHistory.frames_since`: JSON-ready frames, the feed a
  black box spills to disk.

Change-point detection rides the same cadence: each watched
:class:`Signal` (shed rate, duty cycle, memory headroom, live recall,
replication lag by default) keeps a ``2 * window`` ring of values and
flags a **windowed mean shift**, ``|mean(recent w) - mean(prior w)|``
above the signal's threshold. Detection is edge-triggered: the gauge
``raft.obs.history.anomaly{signal}`` holds 1 while the shift is inside
the detector window, and ``raft.obs.history.anomaly.total`` rises ONCE
per shift. ``/healthz`` shows active anomalies in an informational
``history`` section; the planes underneath own their degrade verdicts.

Module state follows the profiler's attach pattern:
:func:`enable_history` installs the module singleton (``_STATE is None``
is the off state), :func:`disable_history` tears it down.
``RAFT_TPU_BLACKBOX=<dir>`` attaches the history at import, together
with the black box (:mod:`raft_tpu_torch.obs.blackbox`), which spills
its frames to disk.

Knobs: ``RAFT_TPU_HISTORY_INTERVAL`` (seconds a frame, default 1.0) and
``RAFT_TPU_HISTORY_RING`` (retained frames, default 512: about 8.5
minutes at the default cadence).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.obs import registry as _registry

__all__ = [
    "DEFAULT_SIGNALS",
    "MetricsHistory",
    "Signal",
    "disable_history",
    "enable_history",
    "endpoint_body",
    "history",
]

_ENV_INTERVAL = "RAFT_TPU_HISTORY_INTERVAL"
_ENV_RING = "RAFT_TPU_HISTORY_RING"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# -- watched signals -------------------------------------------------------

def _fam(series: str) -> str:
    return series.split("{", 1)[0]


def _gvals(gauges: Dict[str, float], family: str) -> List[float]:
    return [v for k, v in gauges.items() if _fam(k) == family]


def _sig_shed_rate(gauges: Dict[str, float]) -> Optional[float]:
    vals = _gvals(gauges, "raft.serve.shed.rate")
    return sum(vals) if vals else None


def _sig_duty_cycle(gauges: Dict[str, float]) -> Optional[float]:
    vals = _gvals(gauges, "raft.obs.profile.duty_cycle")
    return sum(vals) / len(vals) if vals else None


def _sig_hbm_headroom(gauges: Dict[str, float]) -> Optional[float]:
    vals = _gvals(gauges, "raft.obs.profile.hbm.headroom_frac")
    return min(vals) if vals else None


def _sig_recall(gauges: Dict[str, float]) -> Optional[float]:
    vals = _gvals(gauges, "raft.obs.quality.recall")
    return sum(vals) / len(vals) if vals else None


def _sig_replication_lag(gauges: Dict[str, float]) -> Optional[float]:
    vals = _gvals(gauges, "raft.fleet.replication.lag_records")
    return sum(vals) if vals else None


class Signal:
    """One watched scalar for mean-shift detection: a name, an extractor
    over the gauge snapshot (``None``: the signal is absent this tick and
    the detector skips it), and the shift thresholds: a shift fires when
    ``|mean2 - mean1| > max(min_delta, rel_frac * |mean1|)``."""

    __slots__ = ("name", "fn", "min_delta", "rel_frac")

    def __init__(self, name: str,
                 fn: Callable[[Dict[str, float]], Optional[float]],
                 min_delta: float, rel_frac: float = 0.5):
        self.name = name
        self.fn = fn
        self.min_delta = float(min_delta)
        self.rel_frac = float(rel_frac)


# the five trend signals; the thresholds are per signal because their
# units differ (requests a second, fractions, record counts)
DEFAULT_SIGNALS: Tuple[Signal, ...] = (
    Signal("shed_rate", _sig_shed_rate, min_delta=1.0),
    Signal("duty_cycle", _sig_duty_cycle, min_delta=0.15),
    Signal("hbm_headroom", _sig_hbm_headroom, min_delta=0.1),
    Signal("recall", _sig_recall, min_delta=0.05),
    Signal("replication_lag", _sig_replication_lag, min_delta=50.0),
)


class _Detector:
    """Per-signal mean-shift state, mutated only by
    :meth:`MetricsHistory.tick` under the history's lock."""

    __slots__ = ("signal", "window", "values", "shifted", "fired_total",
                 "last", "means")

    def __init__(self, signal: Signal, window: int):
        self.signal = signal
        self.window = max(2, int(window))
        self.values: List[float] = []
        self.shifted = False
        self.fired_total = 0
        self.last: Optional[float] = None
        self.means: Optional[Tuple[float, float]] = None

    def update(self, gauges: Dict[str, float]) -> Optional[str]:
        """Feed one tick → ``"fired"`` on the no-shift to shift edge,
        ``"cleared"`` on the reverse edge, else ``None``."""
        v = self.signal.fn(gauges)
        self.last = v
        if v is None:
            return None
        w = self.window
        self.values.append(float(v))
        if len(self.values) > 2 * w:
            del self.values[: len(self.values) - 2 * w]
        if len(self.values) < 2 * w:
            return None
        m1 = sum(self.values[:w]) / w
        m2 = sum(self.values[w:]) / w
        self.means = (m1, m2)
        thresh = max(self.signal.min_delta,
                     self.signal.rel_frac * abs(m1))
        shifted = abs(m2 - m1) > thresh
        if shifted and not self.shifted:
            self.shifted = True
            self.fired_total += 1
            return "fired"
        if not shifted and self.shifted:
            self.shifted = False
            return "cleared"
        return None


class _Frame:
    """One delta-compressed sample: counter deltas and changed gauges
    since the previous frame."""

    __slots__ = ("seq", "t_unix", "t_mono", "counters", "gauges")

    def __init__(self, seq: int, t_unix: float, t_mono: float,
                 counters: Dict[str, float], gauges: Dict[str, float]):
        self.seq = seq
        self.t_unix = t_unix
        self.t_mono = t_mono
        self.counters = counters
        self.gauges = gauges

    def to_json(self) -> dict:
        return {"seq": self.seq, "t_unix": self.t_unix,
                "t_mono": self.t_mono,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges)}


class MetricsHistory:
    """A bounded ring of delta-compressed registry frames and the
    mean-shift detectors (module docstring)."""

    # the sampler thread and the endpoint's handler threads meet on
    # these fields: touch them only under `with self._lock` (graftlint
    # GL003)
    GUARDED_BY = ("_frames", "_base_counters", "_base_gauges",
                  "_last_counters", "_last_gauges", "_kinds", "_seq",
                  "_detectors")

    def __init__(self, registry: Optional[object] = None,
                 interval_s: Optional[float] = None,
                 capacity: Optional[int] = None,
                 anomaly_window: int = 8,
                 signals: Optional[Tuple[Signal, ...]] = None):
        self._registry = (registry if registry is not None
                          else _registry.REGISTRY)
        self.interval_s = max(0.05, float(
            interval_s if interval_s is not None
            else _env_float(_ENV_INTERVAL, 1.0)))
        self.capacity = max(4, int(
            capacity if capacity is not None
            else _env_int(_ENV_RING, 512)))
        self._lock = threading.Lock()
        self._frames: List[_Frame] = []
        # the state just before the oldest retained frame: evicted frames
        # fold in here, so reconstruction stays exact over the ring
        self._base_counters: Dict[str, float] = {}
        self._base_gauges: Dict[str, float] = {}
        self._last_counters: Dict[str, float] = {}
        self._last_gauges: Dict[str, float] = {}
        self._kinds: Dict[str, str] = {}
        self._seq = 0
        self._detectors: Dict[str, _Detector] = {
            s.name: _Detector(s, anomaly_window)
            for s in (signals if signals is not None
                      else DEFAULT_SIGNALS)}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ----------------------------------------------------------
    def tick(self, t: Optional[float] = None) -> int:
        """Take one frame → its seq. ``t`` overrides the monotonic stamp
        (tests drive the clock for exact rate() arithmetic)."""
        snap = self._registry.snapshot()
        flat_c = {k: float(v)
                  for k, v in snap.get("counters", {}).items()}
        flat_g = {k: float(v)
                  for k, v in snap.get("gauges", {}).items()}
        for series, h in snap.get("histograms", {}).items():
            fam, _, lbl = series.partition("{")
            suffix = ("{" + lbl) if lbl else ""
            flat_c[fam + ".count" + suffix] = float(h["count"])
            flat_c[fam + ".sum" + suffix] = float(h["sum"])
        t_mono = time.monotonic() if t is None else float(t)
        # frames line up with other processes' records by wall clock
        t_unix = time.time()  # graftlint: disable=GL005
        with self._lock:
            cd = {}
            for k, v in flat_c.items():
                d = v - self._last_counters.get(k, 0.0)
                if d:
                    cd[k] = d
            gd = {k: v for k, v in flat_g.items()
                  if self._last_gauges.get(k) != v}
            self._last_counters = flat_c
            self._last_gauges = flat_g
            for k in flat_c:
                self._kinds.setdefault(k, "counter")
            for k in flat_g:
                self._kinds.setdefault(k, "gauge")
            self._seq += 1
            seq = self._seq
            self._frames.append(_Frame(seq, t_unix, t_mono, cd, gd))
            while len(self._frames) > self.capacity:
                old = self._frames.pop(0)
                for k, v in old.counters.items():
                    self._base_counters[k] = (
                        self._base_counters.get(k, 0.0) + v)
                self._base_gauges.update(old.gauges)
            events = []
            for det in self._detectors.values():
                ev = det.update(flat_g)
                if ev is not None:
                    events.append((det.signal.name, ev))
        # registry writes after our lock is released (the history lock
        # never encloses the registry's). They go to the process
        # registry even when a private one is sampled: this plane's own
        # accounting, as every other plane's
        obs.counter("raft.obs.history.frames.total").inc()
        for name, ev in events:
            g = obs.gauge("raft.obs.history.anomaly", signal=name)
            if ev == "fired":
                g.set(1.0)
                obs.counter("raft.obs.history.anomaly.total",
                            signal=name).inc()
            else:
                g.set(0.0)
        return seq

    # -- sampler thread ----------------------------------------------------
    def start(self) -> "MetricsHistory":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="raft-obs-history")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # the sampler outlives a transient snapshot error; the
                # miss shows as a gap in the frames' times
                from raft_tpu_torch.core.logger import get_logger
                get_logger("obs").warning(
                    "history: tick failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- frame export --------------------------------------------------------
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def frames_since(self, seq: int) -> List[dict]:
        """JSON-ready frames with ``seq > seq`` (the dedupe key)."""
        with self._lock:
            return [f.to_json() for f in self._frames if f.seq > seq]

    # -- queries -----------------------------------------------------------
    def _walk(self, name: str, window_s: Optional[float]):
        """Absolute values of every series matching ``name`` (the series,
        its family, or a family prefix at a dot) → ``(points, kinds)``,
        points per series ``[(t_unix, t_mono, value), ...]`` inside the
        window."""
        with self._lock:
            frames = list(self._frames)
            base_c = dict(self._base_counters)
            base_g = dict(self._base_gauges)
            kinds = dict(self._kinds)
        if not frames:
            return {}, kinds

        def match(series: str) -> bool:
            fam = _fam(series)
            return (series == name or fam == name
                    or fam.startswith(name + "."))

        cutoff = (frames[-1].t_mono - float(window_s)
                  if window_s else None)
        run_c = {k: v for k, v in base_c.items() if match(k)}
        run_g = {k: v for k, v in base_g.items() if match(k)}
        out: Dict[str, List[Tuple[float, float, float]]] = {}
        for f in frames:
            for k, d in f.counters.items():
                if match(k):
                    run_c[k] = run_c.get(k, 0.0) + d
            for k, v in f.gauges.items():
                if match(k):
                    run_g[k] = v
            if cutoff is not None and f.t_mono < cutoff:
                continue
            for k, v in run_c.items():
                out.setdefault(k, []).append((f.t_unix, f.t_mono, v))
            for k, v in run_g.items():
                out.setdefault(k, []).append((f.t_unix, f.t_mono, v))
        return out, kinds

    def series(self, name: str, window_s: Optional[float] = None
               ) -> Dict[str, List[Tuple[float, float]]]:
        """Absolute ``(t_unix, value)`` points per matched series."""
        pts, _ = self._walk(name, window_s)
        return {k: [(t, v) for t, _tm, v in p]
                for k, p in pts.items()}

    def delta(self, name: str, window_s: Optional[float] = None
              ) -> Dict[str, float]:
        """``last - first`` per matched series over the window."""
        pts, _ = self._walk(name, window_s)
        return {k: p[-1][2] - p[0][2] for k, p in pts.items() if p}

    def rate(self, name: str, window_s: Optional[float] = None
             ) -> Dict[str, float]:
        """``(last - first) / (t_last - t_first)`` per matched series
        (per second, on the monotonic clock); 0.0 over a zero span."""
        pts, _ = self._walk(name, window_s)
        out = {}
        for k, p in pts.items():
            if not p:
                continue
            span = p[-1][1] - p[0][1]
            out[k] = (p[-1][2] - p[0][2]) / span if span > 0 else 0.0
        return out

    def kind(self, series: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(series)

    def anomalies(self) -> Dict[str, dict]:
        """The detectors' state per watched signal."""
        with self._lock:
            out = {}
            for name, det in self._detectors.items():
                row = {"shifted": det.shifted,
                       "fired_total": det.fired_total,
                       "last": det.last,
                       "window": det.window,
                       "min_delta": det.signal.min_delta}
                if det.means is not None:
                    row["mean_prior"] = round(det.means[0], 6)
                    row["mean_recent"] = round(det.means[1], 6)
                out[name] = row
            return out

    def report(self, window_s: Optional[float] = None) -> dict:
        with self._lock:
            n = len(self._frames)
            first = self._frames[0] if n else None
            last = self._frames[-1] if n else None
            seq = self._seq
        body = {
            "enabled": True,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "frames": n,
            "last_seq": seq,
            "window_s": window_s,
        }
        if first is not None and last is not None:
            body["span_s"] = round(last.t_mono - first.t_mono, 3)
            body["t_first_unix"] = first.t_unix
            body["t_last_unix"] = last.t_unix
        body["anomalies"] = self.anomalies()
        return body


# -- module state (None is the off state) -----------------------------------

_STATE: Optional[MetricsHistory] = None


def enable_history(interval_s: Optional[float] = None,
                   capacity: Optional[int] = None,
                   registry: Optional[object] = None,
                   start: bool = True,
                   anomaly_window: int = 8,
                   signals: Optional[Tuple[Signal, ...]] = None
                   ) -> MetricsHistory:
    """Install (and by default start sampling into) the module's history;
    a previous one is closed first."""
    global _STATE
    prev, _STATE = _STATE, None
    if prev is not None:
        prev.close()
    st = MetricsHistory(registry=registry, interval_s=interval_s,
                        capacity=capacity,
                        anomaly_window=anomaly_window, signals=signals)
    if start:
        st.start()
    _STATE = st
    return st


def disable_history() -> None:
    global _STATE
    prev, _STATE = _STATE, None
    if prev is not None:
        prev.close()


def history() -> Optional[MetricsHistory]:
    """The attached history, or None (off)."""
    return _STATE


def endpoint_body(q: dict) -> Tuple[int, dict]:
    """The ``GET /debug/history?name=&window=[&points=1]`` body →
    ``(http_status, json_body)``: rate and delta per matched series,
    computed here; ``points=1`` inlines the ``(t_unix, value)`` points."""
    st = _STATE
    if st is None:
        return 404, {"error": "no history attached "
                              "(obs.history.enable_history() or "
                              "RAFT_TPU_BLACKBOX=<dir>)"}
    name = (q.get("name") or [None])[0]
    try:
        window_s = float((q.get("window") or ["0"])[0]) or None
    except ValueError:
        return 400, {"error": "window must be seconds (a float)"}
    want_points = (q.get("points") or ["0"])[0] not in ("0", "",
                                                        "false")
    body = st.report(window_s=window_s)
    if name:
        pts = st.series(name, window_s=window_s)
        rates = st.rate(name, window_s=window_s)
        deltas = st.delta(name, window_s=window_s)
        series = {}
        for s in sorted(pts):
            p = pts[s]
            if not p:
                continue
            row = {"kind": st.kind(s),
                   "first": p[0][1], "last": p[-1][1],
                   "delta": deltas.get(s),
                   "rate_per_s": rates.get(s),
                   "points": len(p)}
            if want_points:
                row["values"] = [(round(t, 3), v) for t, v in p]
            series[s] = row
        body["name"] = name
        body["series"] = series
    return 200, body

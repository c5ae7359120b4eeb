"""Declarative SLOs: multi-window burn rates over the metrics registry
(counterpart of ``raft_tpu.obs.slo``).

The serving metrics say what happened; an SLO says whether it was
acceptable, declared once. An :class:`Objective` declares one contract:

* ``kind="latency"``: the fraction of requests completing within
  ``threshold_ms`` must be >= ``target`` (p99 under 200 ms is
  ``threshold_ms=200, target=0.99``), read from the
  ``raft.serve.request.seconds`` histogram's buckets
  (``serve.SERVE_LATENCY_BUCKETS``). A threshold between two edges
  rounds DOWN to the lower edge: a borderline request counts as slow.
* ``kind="availability"``: the fraction of offered requests answered
  must be >= ``target``; shed, deadline and error are the failures, from
  the ``raft.serve.{requests,shed,deadline,errors}.total`` counters.
* ``kind="recall"``: the live shadow-exact recall
  (``raft.obs.quality.recall``, the worst full-coverage series) must
  stay >= ``target``; burn = shortfall / ``tolerance``.

Each objective is evaluated as burn rates over several windows: burn =
error rate / error budget (``1 - target``), so 1.0 consumes the budget
exactly and 10 burns it ten times too fast. A **breach** needs EVERY
window of the objective to burn >= ``burn_threshold``: the short window
shows it is happening now, the long one that it is not a blip.

The tracker writes ``raft.slo.burn_rate{objective,window}``,
``raft.slo.breach{objective}`` and ``raft.slo.objectives`` into the
registry it reads, so ``/healthz`` folds breaches into its verdict and
``/debug/slo`` serves the report (:mod:`raft_tpu_torch.obs.endpoint`).

Use::

    from raft_tpu_torch.obs import slo
    tracker = slo.SLOTracker([
        slo.Objective("p99_latency", "latency", target=0.99,
                      threshold_ms=200.0),
        slo.Objective("availability", "availability", target=0.999),
        slo.Objective("recall_floor", "recall", target=0.85),
    ])                      # a polling daemon; tracker.close() stops it
    tracker.report()        # {objective: {burn, breach, ...}, ...}

Tests drive :meth:`SLOTracker.tick` with an injected clock instead of
the polling thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.obs import registry as _registry

__all__ = ["Objective", "SLOTracker", "active", "endpoint_body"]

_KINDS = ("latency", "availability", "recall")
_FAIL_COUNTERS = ("raft.serve.shed.total", "raft.serve.deadline.total",
                  "raft.serve.errors.total")


@dataclass(frozen=True)
class Objective:
    """One declared service objective (the module docstring lists the
    kinds).

    ``windows`` are seconds, ascending; ``burn_threshold`` is the burn
    rate EVERY window must reach before the objective breaches.
    ``tolerance`` applies to ``recall`` only: the shortfall that counts
    as burn 1.0."""

    name: str
    kind: str
    target: float
    threshold_ms: float = 0.0
    tolerance: float = 0.02
    windows: Tuple[float, ...] = (60.0, 300.0)
    burn_threshold: float = 1.0
    description: str = ""

    def __post_init__(self):
        expects(bool(self.name) and all(
            c.isascii() and (c.islower() or c.isdigit() or c == "_")
            for c in self.name),
            "Objective: name %r must be a [a-z0-9_]+ token (it rides "
            "as a metric label)", self.name)
        expects(self.kind in _KINDS,
                "Objective %r: kind must be one of %s", self.name,
                _KINDS)
        expects(0.0 < self.target < 1.0 if self.kind != "recall"
                else 0.0 < self.target <= 1.0,
                "Objective %r: target must be in (0, 1)", self.name)
        expects(self.kind != "latency" or self.threshold_ms > 0,
                "Objective %r: latency objectives need threshold_ms",
                self.name)
        expects(len(self.windows) >= 1
                and list(self.windows) == sorted(set(self.windows))
                and min(self.windows) > 0,
                "Objective %r: windows must be ascending positive "
                "seconds", self.name)
        expects(self.tolerance > 0,
                "Objective %r: tolerance must be > 0", self.name)


def _sum_series(table: dict, name: str) -> float:
    return sum(v for k, v in table.items()
               if k == name or k.startswith(name + "{"))


def _latency_counts(snapshot: dict, threshold_s: float
                    ) -> Tuple[float, float]:
    """(total, over-threshold) request counts across every
    ``raft.serve.request.seconds`` series. Bucket edges are inclusive
    upper bounds; a threshold between edges rounds down."""
    total = over = 0.0
    for series, h in snapshot.get("histograms", {}).items():
        if series.split("{")[0] != "raft.serve.request.seconds":
            continue
        total += h["count"]
        good = 0.0
        for edge, c in h["buckets"].items():
            if edge != "+Inf" and float(edge) <= threshold_s + 1e-12:
                good += c
        over += h["count"] - good
    return total, over


def _recall_floor_value(snapshot: dict) -> Optional[float]:
    """The worst full-coverage live recall across families and epochs
    (partial-coverage series measure availability, not quality)."""
    vals = [v for k, v in snapshot.get("gauges", {}).items()
            if k.split("{")[0] == "raft.obs.quality.recall"
            and "coverage=partial" not in k]
    return min(vals) if vals else None


class SLOTracker:
    """Evaluates :class:`Objective` s against periodic registry snapshots
    and publishes the ``raft.slo.*`` gauges. Runs a polling daemon by
    default; tests call :meth:`tick` with an injected ``clock``. Reads
    and writes ``registry`` (default: the process registry), so one
    snapshot carries the signal and the verdict."""

    # the polling daemon (tick) and report() readers share the ring and
    # the last report under self._lock (graftlint GL003)
    GUARDED_BY = ("_ring", "_report", "_breached")

    def __init__(self, objectives: Sequence[Objective],
                 registry=None, poll_s: float = 1.0, clock=None,
                 start: bool = True, install: bool = True):
        objectives = tuple(objectives)
        expects(len(objectives) > 0, "SLOTracker: need >= 1 objective")
        expects(len({o.name for o in objectives}) == len(objectives),
                "SLOTracker: objective names must be unique")
        self.objectives = objectives
        self._reg = registry if registry is not None \
            else _registry.REGISTRY
        self._poll_s = float(poll_s)
        self._clock = clock if clock is not None else time.monotonic
        horizon = max(max(o.windows) for o in objectives)
        # one extra slot so a full window always has a sample at or
        # behind its start
        slots = int(horizon / max(self._poll_s, 1e-3)) + 2
        self._ring: deque = deque(maxlen=min(slots, 100_000))
        self._lock = threading.Lock()
        self._report: Dict[str, dict] = {}
        self._breached: set = set()
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # named like the module facade so the instrument calls read (and
        # lint) like every other instrumented module's
        obs = self._reg
        obs.gauge("raft.slo.objectives").set(len(objectives))
        if install:
            _install(self)
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SLOTracker":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="raft-slo-tracker")
            self._thread.start()
        return self

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        _uninstall(self)

    def __enter__(self) -> "SLOTracker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._closed.wait(self._poll_s):
            try:
                self.tick()
            except Exception:
                self._reg.counter("raft.slo.errors.total").inc()

    # -- evaluation --------------------------------------------------------
    def _signals(self) -> dict:
        snap = self._reg.snapshot()
        counters = snap.get("counters", {})
        sig = {
            "requests": _sum_series(counters,
                                    "raft.serve.requests.total"),
            "failed": sum(_sum_series(counters, n)
                          for n in _FAIL_COUNTERS),
        }
        for o in self.objectives:
            if o.kind == "latency":
                total, over = _latency_counts(snap,
                                              o.threshold_ms / 1e3)
                sig[f"lat_total:{o.name}"] = total
                sig[f"lat_over:{o.name}"] = over
            elif o.kind == "recall":
                sig[f"recall:{o.name}"] = _recall_floor_value(snap)
        return sig

    def _window_start_locked(self, now: float,
                             w: float) -> Optional[dict]:
        """The newest ring sample at or before ``now - w``; None until
        the ring covers the window (a cold tracker never breaches on a
        half-filled window). The caller holds ``self._lock``."""
        best = None
        for t, sig in self._ring:
            if t <= now - w + 1e-9:
                best = sig
            else:
                break
        return best

    def tick(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Sample the signals, evaluate every (objective, window) burn
        rate, publish the gauges → the report dict."""
        now = self._clock() if now is None else float(now)
        sig = self._signals()
        obs = self._reg
        with self._lock:
            self._ring.append((now, sig))
            report: Dict[str, dict] = {}
            for o in self.objectives:
                burns: Dict[str, Optional[float]] = {}
                for w in o.windows:
                    base = self._window_start_locked(now, w)
                    burns[f"{int(w)}s"] = self._burn_locked(
                        o, w, now, sig, base)
                breach = (all(b is not None and b >= o.burn_threshold
                              for b in burns.values())
                          and len(burns) > 0)
                for wl, b in burns.items():
                    # -1: no data yet (a cold window or no traffic),
                    # told apart from a true burn of 0
                    obs.gauge("raft.slo.burn_rate", objective=o.name,
                              window=wl).set(
                        -1.0 if b is None else round(b, 6))
                obs.gauge("raft.slo.breach", objective=o.name).set(
                    1.0 if breach else 0.0)
                if breach and o.name not in self._breached:
                    obs.counter("raft.slo.breach.total",
                                objective=o.name).inc()
                (self._breached.add(o.name) if breach
                 else self._breached.discard(o.name))
                report[o.name] = {
                    "kind": o.kind,
                    "target": o.target,
                    "burn_threshold": o.burn_threshold,
                    "burn": {wl: (None if b is None else round(b, 4))
                             for wl, b in burns.items()},
                    "breach": breach,
                }
                if o.kind == "latency":
                    report[o.name]["threshold_ms"] = o.threshold_ms
                if o.kind == "recall":
                    report[o.name]["live_recall"] = sig.get(
                        f"recall:{o.name}")
            obs.counter("raft.slo.evaluations.total").inc()
            self._report = report
            return report

    def _burn_locked(self, o: Objective, w: float, now: float,
                     now_sig: dict, base_sig: Optional[dict]
                     ) -> Optional[float]:
        """The burn rate of one objective over one window; None while
        the window has no data. The caller holds ``self._lock``."""
        if o.kind == "recall":
            # the gauges are windowed by the quality monitor already;
            # the SLO window takes the worst value sampled inside it
            vals = [v for t, sig in self._ring
                    if t >= now - w - 1e-9
                    for v in [sig.get(f"recall:{o.name}")]
                    if v is not None]
            if not vals:
                return None
            return max(0.0, o.target - min(vals)) / o.tolerance
        if base_sig is None:
            return None
        if o.kind == "latency":
            total = (now_sig[f"lat_total:{o.name}"]
                     - base_sig.get(f"lat_total:{o.name}", 0.0))
            bad = (now_sig[f"lat_over:{o.name}"]
                   - base_sig.get(f"lat_over:{o.name}", 0.0))
        else:  # availability
            total = now_sig["requests"] - base_sig.get("requests", 0.0)
            bad = now_sig["failed"] - base_sig.get("failed", 0.0)
        if total <= 0:
            return None
        return (bad / total) / max(1e-9, 1.0 - o.target)

    def report(self) -> Dict[str, dict]:
        """The last :meth:`tick`'s result (evaluates once if none ran)."""
        with self._lock:
            rep = dict(self._report)
        return rep if rep else self.tick()


# -- the endpoint's view (one active tracker per process) -------------------
_active_lock = threading.Lock()
_active: Optional[SLOTracker] = None


def _install(tracker: SLOTracker) -> None:
    global _active
    with _active_lock:
        _active = tracker


def _uninstall(tracker: SLOTracker) -> None:
    global _active
    with _active_lock:
        if _active is tracker:
            _active = None


def active() -> Optional[SLOTracker]:
    """The most recently made tracker still open: what ``/debug/slo``
    serves."""
    with _active_lock:
        return _active


def endpoint_body(snapshot: dict) -> dict:
    """The ``/debug/slo`` body: the active tracker's full report when
    one runs in this process, else the ``raft.slo.*`` gauges of
    ``snapshot`` (a box whose tracker lives elsewhere)."""
    tracker = active()
    if tracker is not None:
        return {"source": "tracker", "objectives": tracker.report()}
    gauges = {k: v for k, v in snapshot.get("gauges", {}).items()
              if k.split("{")[0].startswith("raft.slo.")}
    return {"source": "gauges" if gauges else "none",
            "gauges": gauges}

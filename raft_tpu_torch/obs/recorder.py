"""Flight recorder: the last N request traces, always on (counterpart
of ``raft_tpu.obs.recorder``).

A bounded ring of finished span traces (:mod:`raft_tpu_torch.obs.spans`
hands every finished root trace here): the per-request story behind the
aggregate metrics, cheap enough to leave on (a deque append under a
lock per request, or per served batch; nothing when no span opens,
nothing at all under ``RAFT_TPU_TRACE=0``).

Knobs, read at construction:

* ``RAFT_TPU_TRACE_RING``: ring capacity in traces (default 128).
* ``RAFT_TPU_TRACE_SLOW_MS``: the slow-request threshold (default 250
  ms; :meth:`FlightRecorder.set_slow_threshold_ms` at run time); a
  request trace at or above it is also kept in a separate slow ring (so
  a burst of fast requests cannot evict it) and logged through
  ``core.logger`` at WARN.

Exports: :meth:`FlightRecorder.to_json` (the ``/debug/requests`` body of
the JAX package's endpoint) and :func:`to_chrome_trace`, any recorded
trace as Chrome trace-event JSON for Perfetto or ``chrome://tracing``.

Stitching: one routed request leaves trace fragments in several
recorders (a router's root in its process, each replica's
``raft.serve.request`` root, remote-parented with the same trace id, in
its own). :meth:`FlightRecorder.fragments` finds the local fragments of
a trace id, :func:`fetch_fragments` pulls a peer endpoint's over
``/debug/requests?trace=<id>&all=1`` (estimating its clock skew from
the round trip), and :func:`stitch_chrome_trace` merges them into one
Chrome trace, one ``pid`` lane per fragment, each lane's skew stamped
on its events as ``clock_skew_ms``. :func:`stitch_from_endpoints` is
the one-call form.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import registry as _registry

__all__ = ["FlightRecorder", "RECORDER", "to_chrome_trace",
           "fetch_fragments", "stitch_chrome_trace",
           "stitch_from_endpoints"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _Deferred:
    """A finished trace kept as its parts and built into its dict at the
    first read of the ring (``build(*args)``), so the thread that
    records it pays one small object; the ring keeps the last
    ``capacity`` traces and most are evicted unread."""

    __slots__ = ("_build", "_args", "_trace", "duration_ms", "ts_unix")

    def __init__(self, build, args: tuple, duration_ms: float):
        self._build = build
        self._args = args
        self._trace = None
        self.duration_ms = duration_ms
        self.ts_unix = None

    def resolve(self) -> dict:
        if self._trace is None:
            trace = self._build(*self._args)
            if self.ts_unix is not None:
                trace.setdefault("ts_unix", self.ts_unix)
            self._trace, self._args = trace, None
        return self._trace


class FlightRecorder:
    """Bounded ring of completed request traces + slow-query log."""

    def __init__(self, capacity: Optional[int] = None,
                 slow_ms: Optional[float] = None,
                 slow_capacity: int = 32,
                 registry: Optional[object] = None):
        if capacity is None:
            capacity = int(os.environ.get("RAFT_TPU_TRACE_RING", "128"))
        if slow_ms is None:
            slow_ms = _env_float("RAFT_TPU_TRACE_SLOW_MS", 250.0)
        self.capacity = max(1, capacity)
        self.slow_ms = slow_ms
        self._ring = collections.deque(maxlen=self.capacity)
        self._slow = collections.deque(maxlen=max(1, slow_capacity))
        self._lock = threading.Lock()
        self._registry = registry if registry is not None \
            else _registry.REGISTRY
        self.recorded_total = 0

    # -- ingest ------------------------------------------------------------
    @staticmethod
    def _is_request(trace: dict) -> bool:
        """Slow-query handling applies to REQUEST traces — search-path
        roots (or anything tagged ``request=True``). A build or a
        kmeans fit is expected to take seconds; warning on every one
        would bury the signal the slow-query log exists for."""
        name = trace.get("name", "")
        return (name.endswith(".search") or ".search" in name
                or bool(trace.get("attrs", {}).get("request")))

    def record(self, trace: dict) -> None:
        self._record_many((trace,))

    def _record_many(self, traces) -> None:
        """Record finished traces (dicts or :class:`_Deferred`) under one
        lock and one counter update: a served batch's request traces."""
        if not traces:
            return
        # wall clock by design: traces from several processes are put
        # side by side, so every trace entering the rings carries an
        # absolute arrival stamp (spans carry relative times only)
        now = time.time()
        slow = []
        for trace in traces:
            if isinstance(trace, _Deferred):
                trace.ts_unix = now
                if trace.duration_ms < self.slow_ms:
                    continue
                trace = trace.resolve()
            else:
                trace.setdefault("ts_unix", now)
            if trace.get("duration_ms", 0.0) >= self.slow_ms and \
                    self._is_request(trace):
                slow.append(trace)
        with self._lock:
            self._ring.extend(traces)
            self._slow.extend(slow)
            self.recorded_total += len(traces)
        self._registry.counter("raft.obs.recorder.traces").inc(len(traces))
        if slow:
            self._registry.counter("raft.obs.recorder.slow_traces").inc(
                len(slow))
            # the slow-query log line: enough to find the full trace in
            # the ring (or the endpoint) without grepping spans
            from raft_tpu_torch.core.logger import get_logger
            log = get_logger("obs")
            for trace in slow:
                attrs = trace.get("attrs", {})
                log.warn(
                    "slow request %s (%s): %.1f ms >= %.1f ms threshold "
                    "(%d spans%s)", trace.get("trace_id"),
                    trace.get("name"), trace.get("duration_ms", 0.0),
                    self.slow_ms, len(trace.get("spans", ())),
                    f", attrs={attrs}" if attrs else "")

    def _entries_locked(self, ring) -> List[dict]:
        return [t.resolve() if isinstance(t, _Deferred) else t
                for t in ring]

    # -- knobs -------------------------------------------------------------
    def set_slow_threshold_ms(self, ms: float) -> None:
        self.slow_ms = float(ms)

    # -- query -------------------------------------------------------------
    def requests(self, n: Optional[int] = None) -> List[dict]:
        """Most-recent-first recorded traces (up to ``n``)."""
        with self._lock:
            out = self._entries_locked(self._ring)
        out.reverse()
        return out[:n] if n is not None else out

    def slow_requests(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = self._entries_locked(self._slow)
        out.reverse()
        return out[:n] if n is not None else out

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            for t in reversed(self._entries_locked(self._ring)):
                if t.get("trace_id") == trace_id:
                    return t
            for t in reversed(self._entries_locked(self._slow)):
                if t.get("trace_id") == trace_id:
                    return t
        return None

    def fragments(self, trace_id: str) -> List[dict]:
        """EVERY recorded fragment of ``trace_id``, oldest first. A
        remote-parented trace shares its id with the upstream root, so
        one routed request can leave several fragments even in one
        recorder (router root + N in-process replica roots). Dedupes
        ring/slow by object identity."""
        with self._lock:
            seen_ids, out = set(), []
            for t in self._entries_locked(list(self._ring)
                                          + list(self._slow)):
                if t.get("trace_id") == trace_id and id(t) not in seen_ids:
                    seen_ids.add(id(t))
                    out.append(t)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- export ------------------------------------------------------------
    def to_json(self, n: Optional[int] = None) -> dict:
        """The structured ``/debug/requests`` dump: recorder config +
        most-recent-first traces (+ the slow ring's trace ids, so a
        reader can tell which survived because they were slow)."""
        with self._lock:
            traces = self._entries_locked(self._ring)
            slow_ids = [t.get("trace_id")
                        for t in self._entries_locked(self._slow)]
        traces.reverse()
        if n is not None:
            traces = traces[:n]
        return {
            "capacity": self.capacity,
            "slow_threshold_ms": self.slow_ms,
            "recorded_total": self.recorded_total,
            "slow_trace_ids": slow_ids,
            # wall clock at export: the remote stitcher estimates this
            # process's clock skew from it (see fetch_fragments)
            "now_unix": time.time(),
            "traces": traces,
        }


def to_chrome_trace(trace: dict) -> dict:
    """One recorded trace as Chrome trace-event JSON (the object form:
    ``{"traceEvents": [...]}`` — loads in Perfetto and
    ``chrome://tracing``). Spans become complete (``ph="X"``) events
    with microsecond ``ts``/``dur``; a span's ``rank`` attribute (a
    sharded search's per-rank spans) maps to the event ``pid`` so
    per-rank rows group visually, everything else rides in ``args``."""
    base_us = float(trace.get("start_unix", 0.0)) * 1e6
    events = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": f"raft_tpu_torch {trace.get('trace_id', '')}"},
    }]
    for sp in trace.get("spans", ()):
        attrs = sp.get("attrs", {})
        try:
            pid = int(attrs.get("rank", 0))
        except (TypeError, ValueError):
            pid = 0
        args = {"trace_id": trace.get("trace_id"),
                "span_id": sp.get("span_id")}
        if sp.get("parent_id"):
            args["parent_id"] = sp["parent_id"]
        args.update(attrs)
        events.append({
            "name": sp.get("name", ""),
            "cat": "raft",
            "ph": "X",
            "ts": base_us + sp.get("t_start_ms", 0.0) * 1e3,
            "dur": max(0.0, sp.get("duration_ms", 0.0) * 1e3),
            "pid": pid,
            # fold the 64-bit thread ident into the int32 range chrome
            # tooling expects
            "tid": int(sp.get("tid", 0)) % (1 << 31),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace.get("trace_id"),
                          "name": trace.get("name"),
                          "duration_ms": trace.get("duration_ms")}}


def stitch_chrome_trace(fragments: Sequence[dict],
                        instances: Optional[Sequence[str]] = None,
                        skews_s: Optional[Sequence[float]] = None
                        ) -> dict:
    """Merge the fragments of ONE distributed trace into a single
    Chrome trace. Each fragment gets its own ``pid`` lane (named after
    ``instances[i]`` when given — the replica/router endpoint it came
    from — reusing the rank→pid lane convention of
    :func:`to_chrome_trace`). ``skews_s[i]`` is the estimated clock
    skew of fragment *i*'s process (remote − local, seconds): it is
    APPLIED to that lane's timestamps so the lanes line up, and
    stamped on each of its events as ``clock_skew_ms`` so a reader
    can tell corrected time from measured time. Fragment order is by
    ``start_unix`` (skew-corrected), so the upstream root lane comes
    first."""
    frags = list(fragments)
    n = len(frags)
    insts = list(instances) if instances is not None else [""] * n
    skews = list(skews_s) if skews_s is not None else [0.0] * n
    order = sorted(
        range(n),
        key=lambda i: float(frags[i].get("start_unix", 0.0)) - skews[i])
    trace_id = frags[order[0]].get("trace_id", "") if n else ""
    events: List[dict] = []
    total_spans = 0
    for lane, i in enumerate(order):
        frag, inst, skew = frags[i], insts[i], skews[i]
        pid = lane
        label = inst or frag.get("name", "") or f"fragment-{lane}"
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{label} {frag.get('trace_id', '')}"},
        })
        base_us = (float(frag.get("start_unix", 0.0)) - skew) * 1e6
        skew_ms = round(skew * 1e3, 3)
        for sp in frag.get("spans", ()):
            args = {"trace_id": frag.get("trace_id"),
                    "span_id": sp.get("span_id")}
            if sp.get("parent_id"):
                args["parent_id"] = sp["parent_id"]
            if inst:
                args["instance"] = inst
            if skew_ms:
                args["clock_skew_ms"] = skew_ms
            args.update(sp.get("attrs", {}))
            events.append({
                "name": sp.get("name", ""),
                "cat": "raft",
                "ph": "X",
                "ts": base_us + sp.get("t_start_ms", 0.0) * 1e3,
                "dur": max(0.0, sp.get("duration_ms", 0.0) * 1e3),
                "pid": pid,
                "tid": int(sp.get("tid", 0)) % (1 << 31),
                "args": args,
            })
            total_spans += 1
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id,
                          "fragments": n,
                          "spans": total_spans,
                          "stitched": True}}


def fetch_fragments(base_url: str, trace_id: str,
                    timeout_s: float = 2.0
                    ) -> Tuple[List[dict], float]:
    """Pull one peer endpoint's fragments of ``trace_id`` over
    ``GET /debug/requests?trace=<id>&all=1`` → ``(fragments,
    skew_s)``. The skew estimate is the peer's export-time wall clock
    minus the midpoint of our request round trip (the standard
    NTP-style offset under a symmetric-delay assumption) — good to
    ~half the round trip, which is plenty to line up millisecond
    span lanes. Network errors raise (the caller decides whether a
    missing peer is fatal)."""
    url = (f"{base_url.rstrip('/')}/debug/requests"
           f"?trace={trace_id}&all=1")
    # wall-clock midpoint wants the same clock the peer exports
    t0 = time.time()
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        body = json.loads(resp.read().decode("utf-8"))
    t1 = time.time()
    remote_now = float(body.get("now_unix", (t0 + t1) / 2.0))
    skew_s = remote_now - (t0 + t1) / 2.0
    return list(body.get("fragments", ())), skew_s


def stitch_from_endpoints(trace_id: str,
                          peers: Dict[str, str],
                          recorder: Optional[FlightRecorder] = None,
                          timeout_s: float = 2.0) -> dict:
    """One-call stitch: local fragments (from ``recorder``, default
    the process recorder) + every peer endpoint's fragments, merged
    by :func:`stitch_chrome_trace`. ``peers`` maps instance name →
    base URL. Unreachable peers contribute nothing (their absence is
    recorded in ``otherData["unreachable"]``) — a stitch must degrade,
    not fail, when a replica is down."""
    # lazy import: spans depends on recorder (one-way), so the stitch
    # span is opened via the module registry rather than a top import
    from raft_tpu_torch.obs import spans as _spans
    with _spans.span("raft.obs.fed.stitch", peers=len(peers)) as sp:
        frags: List[dict] = []
        insts: List[str] = []
        skews: List[float] = []
        rec = recorder if recorder is not None else RECORDER
        for f in rec.fragments(trace_id):
            frags.append(f)
            insts.append("local")
            skews.append(0.0)
        unreachable = []
        for name, url in sorted(peers.items()):
            try:
                peer_frags, skew = fetch_fragments(
                    url, trace_id, timeout_s=timeout_s)
            except Exception:
                unreachable.append(name)
                continue
            for f in peer_frags:
                frags.append(f)
                insts.append(name)
                skews.append(skew)
        out = stitch_chrome_trace(frags, instances=insts,
                                  skews_s=skews)
        out["otherData"]["unreachable"] = unreachable
        sp.set_attrs(fragments=len(frags),
                     unreachable=len(unreachable))
    return out


# the process-wide recorder every completed root span lands in; tests
# can build private instances
RECORDER = FlightRecorder()

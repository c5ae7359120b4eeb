"""Request-scoped spans (counterpart of ``raft_tpu.obs.spans``).

Metrics say how often and how slow on average; a span says which
request, plan, cap decision or sub-batch. Every serving entry point
opens a **root span**, nested scopes attach as **children** sharing one
``trace_id``, and the finished trace (names, parent links, wall
durations, attributes) lands in the flight recorder
(:mod:`raft_tpu_torch.obs.recorder`), exportable as Chrome-trace JSON.

Span names use the metrics' ``raft.<module>.<op>`` taxonomy, and every
span also opens a ``core.trace.range`` of its name (a
``torch.profiler.record_function`` range) while a ``torch.profiler``
session records, so one name finds the histogram, the profiler range
and the recorded request.

Quick use::

    from raft_tpu_torch.obs import spans
    with spans.span("raft.myapp.handle", route="search") as sp:
        with spans.span("raft.myapp.stage"):
            ...
        sp.set_attr("cache", "hit")

Semantics and caveats:

* **wall clock**: a span measures host time in its scope; CUDA launches
  return before the device finishes, so that is enqueue time unless the
  scope synchronises. ``sp.sync(value)`` waits for the tensors in
  ``value`` on their device's current stream (by event, never the whole
  device) and records the elapsed time as ``attrs["device_ms"]``.
* **attributed stages**: :func:`add_stage_spans` records a stage
  structure as child spans whose durations split a measured wall by
  static weights, marked ``attributed=True``: the shape of the request,
  not a measurement. The port's serving plans time each stage's issue
  as a span of its own instead.
* **toggle**: ``RAFT_TPU_TRACE=0`` makes ``span()`` return one shared
  null object (nothing allocated or recorded); at run time
  :func:`set_trace_enabled`.
* **sampling**: ``RAFT_TPU_TRACE_SAMPLE`` (0.0-1.0, default 1.0) admits
  that fraction of requests, decided once at the would-be root span by
  a seeded ``random.Random`` (:func:`set_trace_sample_rate`); a
  rejected request's nested ``span()`` calls share the null span too (a
  thread-local veto depth), so a child never starts an orphan trace.
* **threads**: the active trace is thread-local.
* **propagation**: :func:`current_traceparent` renders the innermost
  open span as a W3C-style ``traceparent`` value
  (``00-<trace_id>-<span_id>-01``), and ``span(name, remote_parent=
  hdr)`` roots a new trace that adopts the remote trace id and records
  the remote span as its parent, bypassing sampling (the upstream root
  already admitted the request). The header format is the JAX
  package's, so a header made by either parses in the other.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from torch.autograd import _profiler_enabled

from raft_tpu_torch.obs.registry import NAME_RE

__all__ = [
    "Span",
    "span",
    "spanned",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "parse_traceparent",
    "add_stage_spans",
    "add_child_span",
    "set_trace_enabled",
    "trace_enabled",
    "set_trace_sample_rate",
    "trace_sample_rate",
]


def _env_enabled() -> bool:
    return os.environ.get("RAFT_TPU_TRACE", "1").lower() not in (
        "0", "false", "off", "no")


def _env_sample_rate() -> float:
    try:
        v = float(os.environ.get("RAFT_TPU_TRACE_SAMPLE", "1.0"))
    except ValueError:
        return 1.0
    return min(max(v, 0.0), 1.0)


_enabled = _env_enabled()
_sample_rate = _env_sample_rate()
_sample_rng = random.Random()
_tls = threading.local()
# itertools.count is atomic in CPython; ids only need process-local
# uniqueness (the pid prefixes exported traces where it matters)
_ids = itertools.count(1)


def set_trace_enabled(on: bool = True) -> None:
    """Runtime toggle (initial state from ``RAFT_TPU_TRACE``)."""
    global _enabled
    _enabled = bool(on)


def trace_enabled() -> bool:
    return _enabled


def set_trace_sample_rate(rate: float, seed: Optional[int] = None
                          ) -> None:
    """Runtime per-request sampling rate (initial state from
    ``RAFT_TPU_TRACE_SAMPLE``). ``seed`` re-seeds the admission RNG —
    deterministic tests only."""
    global _sample_rate
    _sample_rate = min(max(float(rate), 0.0), 1.0)
    if seed is not None:
        _sample_rng.seed(seed)


def trace_sample_rate() -> float:
    return _sample_rate


def _new_id() -> str:
    return f"{next(_ids):08x}"


class _TraceState:
    """Per-thread in-flight trace: the stack of open spans plus the
    records of finished ones."""

    __slots__ = ("trace_id", "spans", "stack", "t0", "t0_unix",
                 "remote_parent")

    def __init__(self, trace_id: Optional[str] = None,
                 remote_parent: Optional[str] = None):
        self.trace_id = (trace_id if trace_id is not None
                         else f"{os.getpid():x}-{_new_id()}")
        # span id of the remote parent this trace fragment hangs under
        # (cross-process propagation); None for a local root
        self.remote_parent = remote_parent
        self.spans: List[dict] = []
        self.stack: List["Span"] = []
        self.t0 = time.perf_counter()
        # wall clock on purpose: exported trace timestamps must be
        # comparable across processes
        self.t0_unix = time.time()


class Span:
    """One open scope. Use via :func:`span`; context-manager only."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "trace_id",
                 "_t0", "_trace", "_range", "_tid", "_root", "_remote")

    def __init__(self, name: str, attrs: Dict[str, object],
                 remote: Optional[Tuple[str, str]] = None):
        if not NAME_RE.match(name):
            raise ValueError(
                f"span name {name!r} violates the raft.<module>.<op> "
                f"taxonomy (want {NAME_RE.pattern})")
        self.name = name
        self.attrs = attrs
        self.span_id = ""
        self.parent_id = None
        self.trace_id = ""
        self._t0 = 0.0
        self._trace = None
        self._range = None
        self._tid = 0
        self._root = False
        # parsed (trace_id, span_id) of a remote parent — consumed only
        # when this span roots a new trace
        self._remote = remote

    # -- attributes --------------------------------------------------------
    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def set_attrs(self, **kv) -> None:
        self.attrs.update(kv)

    def sync(self, value) -> float:
        """Wait for the tensors in ``value`` (nested lists, tuples and
        dicts) on their device's current stream and record the
        device-inclusive elapsed time since the span started as
        ``attrs["device_ms"]``. Returns the elapsed seconds."""
        from raft_tpu_torch.core.interruptible import wait_ready
        wait_ready(value)
        dt = time.perf_counter() - self._t0
        self.attrs["device_ms"] = round(dt * 1e3, 3)
        return dt

    # -- scope -------------------------------------------------------------
    def __enter__(self) -> "Span":
        tr = getattr(_tls, "trace", None)
        if tr is None:
            if self._remote is not None:
                # adopt the remote trace id so every fragment of one
                # routed request shares it; the remote span id becomes
                # this root's parent link
                tr = _TraceState(trace_id=self._remote[0],
                                 remote_parent=self._remote[1])
            else:
                tr = _TraceState()
            _tls.trace = tr
            self._root = True
        self._trace = tr
        self.trace_id = tr.trace_id
        self.span_id = _new_id()
        if tr.stack:
            self.parent_id = tr.stack[-1].span_id
        elif tr.remote_parent is not None:
            self.parent_id = tr.remote_parent
        tr.stack.append(self)
        self._tid = threading.get_ident()
        # the span is also the profiler range of its name (one
        # taxonomy), opened while a torch.profiler session records: it
        # shows in no other trace, and a record_function range costs
        # about as much host time as the rest of the span
        if _profiler_enabled():
            from raft_tpu_torch.core import trace
            self._range = trace.range(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(exc_type, exc, tb)
        tr = self._trace
        self._trace = None
        if tr is None:
            return False
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        try:
            tr.stack.remove(self)
        except ValueError:
            pass
        rec = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start_ms": round((self._t0 - tr.t0) * 1e3, 3),
            "duration_ms": round(dur * 1e3, 3),
            "tid": self._tid,
        }
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        tr.spans.append(rec)
        if self._root:
            _tls.trace = None
            _finalize(tr, self, dur)
        return False


class _NullSpan:
    """Shared no-op span for the disabled layer: accepts every Span
    method, allocates nothing, records nothing."""

    __slots__ = ()
    name = ""
    span_id = ""
    trace_id = ""
    parent_id = None
    attrs: Dict[str, object] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key: str, value) -> None: ...

    def set_attrs(self, **kv) -> None: ...

    def sync(self, value) -> float:
        return 0.0


_NULL_SPAN = _NullSpan()


class _VetoSpan(_NullSpan):
    """The shared null span of a SAMPLED-OUT request: state-free (all
    bookkeeping lives in a thread-local depth counter), so one shared
    instance serves every suppressed scope. The veto depth keeps every
    nested ``span()`` of the rejected request on this same object —
    without it, a child opened inside a sampled-out root would roll
    its own admission and could record an orphan fragment trace."""

    __slots__ = ()

    def __enter__(self):
        _tls.veto = getattr(_tls, "veto", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.veto = max(0, getattr(_tls, "veto", 1) - 1)
        return False


_VETO_SPAN = _VetoSpan()


def span(name: str, remote_parent: Optional[str] = None,
         **attrs) -> Span:
    """Open a span named under the ``raft.<module>.<op>`` taxonomy.
    Returns the shared null object when tracing is disabled, or when
    this would start a new trace and per-request sampling
    (``RAFT_TPU_TRACE_SAMPLE``) rejects it.

    ``remote_parent`` (a :func:`current_traceparent` value, usually
    carried in an HTTP header or a ``submit(trace_context=...)``
    field) parents the span across a process/thread boundary: when
    this span roots a new trace, the trace adopts the remote trace id
    and the span records the remote span as its parent — and sampling
    is bypassed (the upstream root already admitted the request).
    Ignored when a trace is already open on this thread (a nested span
    has a real local parent) or when the value is malformed
    (propagation must never fail a request)."""
    if not _enabled:
        return _NULL_SPAN
    remote = (parse_traceparent(remote_parent)
              if remote_parent is not None else None)
    if getattr(_tls, "trace", None) is None and remote is None \
            and not _admit_root():
        return _VETO_SPAN
    return Span(name, attrs, remote=remote)


def _admit_root() -> bool:
    """Root-span admission: one Bernoulli draw per request; the veto
    depth extends a rejection to the whole request."""
    if getattr(_tls, "veto", 0):
        return False
    return _sample_rate >= 1.0 or _sample_rng.random() < _sample_rate


def spanned(name: str, **attrs):
    """Decorator form: run every call of the wrapped function inside
    ``span(name, **attrs)`` (fresh span per call — re-entrant). The
    body can enrich it via ``current_span().set_attrs(...)``."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def current_span():
    """The innermost open span on this thread (the null span when
    tracing is off or no span is open) — lets deep call sites attach
    attributes (resolved cap, cache hit/miss) to the request that is
    already in flight without opening a scope of their own."""
    if not _enabled:
        return _NULL_SPAN
    tr = getattr(_tls, "trace", None)
    if tr is not None and tr.stack:
        return tr.stack[-1]
    return _NULL_SPAN


def current_trace_id() -> Optional[str]:
    tr = getattr(_tls, "trace", None)
    return tr.trace_id if tr is not None else None


def current_traceparent() -> Optional[str]:
    """Render the innermost open span as a W3C-style ``traceparent``
    value (``00-<trace_id>-<span_id>-01``) for cross-process
    propagation, or None when no span is open (or tracing is off).
    The flags byte is always ``01`` (sampled): an open span means the
    admission decision already said yes."""
    if not _enabled:
        return None
    tr = getattr(_tls, "trace", None)
    if tr is None or not tr.stack:
        return None
    return f"00-{tr.trace_id}-{tr.stack[-1].span_id}-01"


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """Parse a ``traceparent`` value into ``(trace_id, span_id)``, or
    None when missing/malformed — propagation must never fail a
    request. Lenient on the trace-id charset because our ids embed a
    dash (``{pid:x}-{counter:08x}``): split the version off the front,
    then the span id + flags off the back, and the middle is the trace
    id verbatim."""
    if not header:
        return None
    try:
        version, rest = header.strip().split("-", 1)
        trace_id, span_id, _flags = rest.rsplit("-", 2)
    except ValueError:
        return None
    if version != "00" or not trace_id or not span_id:
        return None
    if len(_flags) != 2 or not all(c in "0123456789abcdefABCDEF"
                                   for c in _flags):
        return None
    return trace_id, span_id


def add_stage_spans(stages: Sequence[Tuple[str, float]], total_s: float,
                    **attrs) -> None:
    """Record attributed child spans under the current span: ``stages``
    is a sequence of ``(name, weight)``; each stage's duration splits
    ``total_s`` proportionally, laid end-to-end over the interval that
    just elapsed (``[now - total_s, now]``), for stages that cannot be
    host-timed one by one (the JAX package's compiled plan); the spans
    carry ``attributed=True`` so readers can tell estimation from
    measurement."""
    if not _enabled:
        return
    tr = getattr(_tls, "trace", None)
    if tr is None or not tr.stack:
        return
    parent = tr.stack[-1]
    total_w = sum(w for _, w in stages)
    if total_w <= 0 or total_s < 0:
        return
    tid = threading.get_ident()
    cursor = time.perf_counter() - total_s
    for name, w in stages:
        if not NAME_RE.match(name):
            raise ValueError(
                f"stage span name {name!r} violates the taxonomy")
        dur = total_s * (w / total_w)
        tr.spans.append({
            "name": name,
            "span_id": _new_id(),
            "parent_id": parent.span_id,
            "t_start_ms": round((cursor - tr.t0) * 1e3, 3),
            "duration_ms": round(dur * 1e3, 3),
            "tid": tid,
            "attrs": {"attributed": True, **attrs},
        })
        cursor += dur


def add_child_span(name: str, start_s: float, duration_s: float,
                   **attrs) -> None:
    """Record one already-timed child span under the current span
    (``start_s`` on the ``time.perf_counter`` clock): a queue wait, a
    shared batch execution, or a measured device wait recorded after
    the fact into the trace that is open on this thread."""
    if not _enabled:
        return
    tr = getattr(_tls, "trace", None)
    if tr is None or not tr.stack:
        return
    if not NAME_RE.match(name):
        raise ValueError(f"span name {name!r} violates the taxonomy")
    tr.spans.append({
        "name": name,
        "span_id": _new_id(),
        "parent_id": tr.stack[-1].span_id,
        "t_start_ms": round((start_s - tr.t0) * 1e3, 3),
        "duration_ms": round(duration_s * 1e3, 3),
        "tid": threading.get_ident(),
        "attrs": attrs,
    })


class _ChildGroup:
    """Already-timed children of one name and parent, kept in their
    trace as ``(start_s, duration_s, attrs)`` and turned into span
    records when the finished trace is first read (:func:`_finalize`
    hands such a trace to the recorder deferred)."""

    __slots__ = ("name", "parent_id", "tid", "t0", "items")

    def __init__(self, name, parent_id, tid, t0, items):
        self.name, self.parent_id, self.tid = name, parent_id, tid
        self.t0, self.items = t0, items

    def records(self) -> List[dict]:
        return [{"name": self.name, "span_id": _new_id(),
                 "parent_id": self.parent_id,
                 "t_start_ms": round((start - self.t0) * 1e3, 3),
                 "duration_ms": round(dur * 1e3, 3),
                 "tid": self.tid, "attrs": attrs}
                for start, dur, attrs in self.items]


def _add_child_spans(name: str, children) -> None:
    """:func:`add_child_span` for many children of one name, each
    ``(start_s, duration_s, attrs)``, under the current span: the name
    checked and the parent read once, the records made when the trace
    is read (a served batch's queue waits, one a request)."""
    if not _enabled:
        return
    tr = getattr(_tls, "trace", None)
    if tr is None or not tr.stack:
        return
    if not NAME_RE.match(name):
        raise ValueError(f"span name {name!r} violates the taxonomy")
    tr.spans.append(_ChildGroup(name, tr.stack[-1].span_id,
                                threading.get_ident(), tr.t0,
                                list(children)))


def _expand_groups(trace: dict) -> dict:
    """A finished trace with its child groups made span records, in
    place."""
    out = []
    for rec in trace["spans"]:
        if type(rec) is _ChildGroup:
            out.extend(rec.records())
        else:
            out.append(rec)
    trace["spans"] = out
    return trace


def _build_root_trace(name: str, start_s: float, duration_s: float,
                      children: Sequence[Tuple[str, float, float, dict]],
                      remote: Optional[Tuple[str, str]], wall_offset_s: float,
                      tid: int, attrs: Dict[str, object]) -> dict:
    """The trace that ``with span(name, **attrs)`` around one
    :func:`add_child_span` per ``(name, start_s, duration_s, attrs)`` of
    ``children`` records, for a root already timed and admitted (the
    caller ran :func:`_admit_root` unless ``remote``, a parsed
    ``traceparent``, parents it), laid over ``[start_s, start_s +
    duration_s]`` on the ``perf_counter`` clock; ``wall_offset_s`` is
    ``time.time() - time.perf_counter()`` and ``tid`` the thread's
    ident when it was timed. The batcher defers its request traces to
    this until the recorder is read."""
    for n in (name, *(c[0] for c in children)):
        if not NAME_RE.match(n):
            raise ValueError(f"span name {n!r} violates the taxonomy")
    trace_id = (remote[0] if remote is not None
                else f"{os.getpid():x}-{_new_id()}")
    root_id = _new_id()
    recs = [{"name": cname,
             "span_id": _new_id(),
             "parent_id": root_id,
             "t_start_ms": round((cs - start_s) * 1e3, 3),
             "duration_ms": round(cd * 1e3, 3),
             "tid": tid,
             "attrs": cattrs} for cname, cs, cd, cattrs in children]
    dur_ms = round(duration_s * 1e3, 3)
    root = {"name": name, "span_id": root_id,
            "parent_id": remote[1] if remote is not None else None,
            "t_start_ms": 0.0, "duration_ms": dur_ms, "tid": tid}
    if attrs:
        root["attrs"] = dict(attrs)
    recs.append(root)
    trace = {"trace_id": trace_id, "name": name,
             "start_unix": wall_offset_s + start_s,
             "duration_ms": dur_ms, "spans": recs}
    if attrs:
        trace["attrs"] = dict(attrs)
    if remote is not None:
        trace["remote_parent"] = remote[1]
    return trace


def _finalize(tr: _TraceState, root: Span, dur_s: float) -> None:
    trace = {
        "trace_id": tr.trace_id,
        "name": root.name,
        "start_unix": tr.t0_unix,
        "duration_ms": round(dur_s * 1e3, 3),
        "spans": tr.spans,
    }
    if root.attrs:
        trace["attrs"] = dict(root.attrs)
    if tr.remote_parent is not None:
        # marks this trace as a child FRAGMENT of a remote trace; the
        # stitcher uses it to tell router-side roots from replica-side
        trace["remote_parent"] = tr.remote_parent
    # lazy import: recorder depends on registry/logger only, so the
    # dependency between the two obs submodules stays one-way
    from raft_tpu_torch.obs import recorder as _recorder
    if any(type(rec) is _ChildGroup for rec in tr.spans):
        _recorder.RECORDER._record_many((_recorder._Deferred(
            _expand_groups, (trace,), trace["duration_ms"]),))
    else:
        _recorder.RECORDER.record(trace)

"""Thread-safe metrics registry (counterpart of ``raft_tpu.obs.registry``).

Counters, gauges and fixed-boundary histograms, grouped into labelled
families keyed by frozen label tuples (the Prometheus data model), on
the standard library only:

* **taxonomy**: every name is ``raft.<module>.<op>[...]`` (lowercase,
  dot-separated, :data:`NAME_RE`), checked at registration; the same
  names as the JAX package, and the same ``obs.timed`` trace ranges.
* **one snapshot shape**: ``snapshot()`` gives ``{"counters": {series:
  value}, "gauges": {...}, "histograms": {series: {"count", "sum",
  "buckets"}}}``, a series named ``name{k=v,...}`` with sorted labels,
  exactly as the JAX package names it, so the serving tests and
  dashboards read both alike. Label values are quoted only in the
  Prometheus text (:func:`to_prometheus_text`).
* **no-op toggle**: ``RAFT_TPU_METRICS=0`` (or ``set_enabled(False)``)
  makes every instrument one shared null object.
* **bounded cardinality**: a family refuses to make more than
  ``max_series`` series and raises :class:`CardinalityError`, so an
  unbounded label value fails loudly instead of leaking memory. The
  process registry's cap is the module's :data:`max_series`, read from
  ``RAFT_TPU_METRICS_MAX_SERIES`` (default 512) at import.
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "CardinalityError",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "SIZE_BUCKETS",
    "NAME_RE",
    "counter",
    "counter_sum",
    "gauge",
    "histogram",
    "snapshot",
    "snapshot_diff",
    "to_prometheus_text",
    "reset",
    "set_enabled",
    "enabled",
]

# raft.<module>.<op>...: lowercase [a-z0-9_] segments, dot-separated
NAME_RE = re.compile(r"^raft\.[a-z0-9_]+(\.[a-z0-9_]+)*$")

# latency-shaped boundaries (seconds), the upper edge of each bucket;
# +Inf is implicit and a value on a boundary counts in that bucket
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

# count-shaped boundaries (batch sizes, probe counts, iterations):
# powers of four up to 1M
SIZE_BUCKETS: Tuple[float, ...] = tuple(
    float(1 << i) for i in range(0, 21, 2))


class CardinalityError(RuntimeError):
    """A labelled family exceeded its configured series cap."""


def _env_enabled() -> bool:
    return os.environ.get("RAFT_TPU_METRICS", "1").lower() not in (
        "0", "false", "off", "no")


def _env_max_series() -> int:
    return int(os.environ.get("RAFT_TPU_METRICS_MAX_SERIES", "512"))


# the series cap of every registry built without its own
max_series = _env_max_series()


def _labels_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    """Frozen, order-independent label identity."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class Counter:
    """Monotonic counter; ``inc`` takes non-negative amounts only."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter.inc: negative amount")
        with self._lock:
            self.value += amount


class Gauge:
    """Settable point-in-time value."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram:
    """Fixed-boundary histogram (Prometheus ``le`` semantics: each bound
    is a bucket's inclusive upper edge, plus one implicit +Inf
    bucket)."""

    __slots__ = ("_lock", "bounds", "bucket_counts", "sum", "count")

    def __init__(self, lock: threading.RLock,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        # an explicit +Inf bound is dropped: it is always implicit
        bounds = tuple(float(b) for b in bounds if not math.isinf(b))
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("Histogram: bucket bounds must be strictly "
                             "increasing")
        self._lock = lock
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        # bisect_left: a value equal to bounds[i] lands in bucket i
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric: its kind and its series by frozen labels."""

    __slots__ = ("name", "kind", "help", "bounds", "children")

    def __init__(self, name: str, kind: str, help: str = "",
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.kind = kind
        self.help = help
        self.bounds = tuple(bounds)
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


class _Null:
    """The shared instrument of a disabled registry: every method does
    nothing."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None: ...
    def dec(self, amount: float = 1.0) -> None: ...
    def set(self, value: float) -> None: ...
    def observe(self, value: float) -> None: ...


_NULL = _Null()


class MetricsRegistry:
    """Thread-safe registry of labelled metric families. One ``RLock``
    guards registration and every value, so ``snapshot()`` is
    consistent; every instrumented site is a per-dispatch host path.
    ``max_series`` None follows the module's :data:`max_series`."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_series: Optional[int] = None):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._enabled = _env_enabled() if enabled is None else enabled
        self._max_series = max_series

    @property
    def max_series(self) -> int:
        return (self._max_series if self._max_series is not None
                else max_series)

    @max_series.setter
    def max_series(self, value: int) -> None:
        self._max_series = value

    # -- enable toggle -----------------------------------------------------
    def set_enabled(self, on: bool = True) -> None:
        self._enabled = bool(on)

    def enabled(self) -> bool:
        return self._enabled

    # -- registration ------------------------------------------------------
    def _get(self, name: str, kind: str, help: str,
             bounds: Sequence[float], labels: Dict[str, object]):
        if not self._enabled:
            return _NULL
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the raft.<module>.<op> "
                f"taxonomy (want {NAME_RE.pattern})")
        key = _labels_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help,
                                                     bounds)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            child = fam.children.get(key)
            if child is None:
                cap = self.max_series
                if len(fam.children) >= cap:
                    raise CardinalityError(
                        f"metric family {name!r} exceeded max_series="
                        f"{cap}: an unbounded label value (id, pointer, "
                        f"timestamp) is leaking series")
                if kind == "histogram":
                    child = Histogram(self._lock, fam.bounds)
                else:
                    child = _KINDS[kind](self._lock)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, (), labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, (), labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, buckets, labels)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time JSON-ready dict: ``{"counters": {series:
        value}, "gauges": {...}, "histograms": {series: {"count", "sum",
        "buckets"}}}``, series ``name`` or ``name{k=v,...}`` with sorted
        labels."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for fam in self._families.values():
                for key, child in fam.children.items():
                    series = _series_name(fam.name, key)
                    if fam.kind == "counter":
                        out["counters"][series] = child.value
                    elif fam.kind == "gauge":
                        out["gauges"][series] = child.value
                    else:
                        buckets = {repr(b): c for b, c in
                                   zip(child.bounds, child.bucket_counts)}
                        buckets["+Inf"] = child.bucket_counts[-1]
                        out["histograms"][series] = {
                            "count": child.count,
                            "sum": child.sum,
                            "buckets": buckets,
                        }
        return out

    def to_prometheus_text(self) -> str:
        """The Prometheus text exposition format: dots become
        underscores, counters gain ``_total``, histograms give
        cumulative ``_bucket{le=...}`` lines and ``_sum``/``_count``;
        label values are quoted and escaped."""
        lines = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                pname = name.replace(".", "_")
                if fam.kind == "counter":
                    pname += "_total"
                if fam.help:
                    lines.append(f"# HELP {pname} {fam.help}")
                lines.append(f"# TYPE {pname} {fam.kind}")
                for key in sorted(fam.children):
                    child = fam.children[key]
                    lbl = _prom_labels(key)
                    if fam.kind in ("counter", "gauge"):
                        lines.append(f"{pname}{lbl} {_fmt(child.value)}")
                        continue
                    cum = 0
                    for b, c in zip(child.bounds, child.bucket_counts):
                        cum += c
                        lines.append(
                            f"{pname}_bucket{_prom_labels(key, le=_fmt(b))}"
                            f" {cum}")
                    cum += child.bucket_counts[-1]
                    lines.append(
                        f"{pname}_bucket{_prom_labels(key, le='+Inf')}"
                        f" {cum}")
                    lines.append(f"{pname}_sum{lbl} {_fmt(child.sum)}")
                    lines.append(f"{pname}_count{lbl} {child.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every registered family."""
        with self._lock:
            self._families.clear()


def _prom_labels(key: Tuple[Tuple[str, str], ...], **extra) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    # the exposition format's escapes, backslash first: \\ , \" , \n
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\")
                         .replace('"', r'\"').replace("\n", r"\n"))
        for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    """A sample value as the exposition format spells it, the inverse of
    ``float()``: ±Inf and NaN by name, integral values without
    ``.0``, everything else by ``repr``."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


# the process registry every instrumented module writes to
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_BUCKETS,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def to_prometheus_text() -> str:
    return REGISTRY.to_prometheus_text()


def reset() -> None:
    REGISTRY.reset()


def set_enabled(on: bool = True) -> None:
    REGISTRY.set_enabled(on)


def enabled() -> bool:
    return REGISTRY.enabled()


def counter_sum(snap: dict, name: str) -> float:
    """Sum a counter family over all its labelled series."""
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


def snapshot_diff(before: dict, after: dict) -> dict:
    """What a bounded piece of work did between two :func:`snapshot`
    dicts: counters and histogram counts subtract, gauges give their
    ``after`` value where it changed, unchanged series are dropped."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    b_c = before.get("counters", {})
    for k, v in after.get("counters", {}).items():
        d = v - b_c.get(k, 0.0)
        if d:
            out["counters"][k] = d
    b_g = before.get("gauges", {})
    for k, v in after.get("gauges", {}).items():
        if k not in b_g or b_g[k] != v:
            out["gauges"][k] = v
    b_h = before.get("histograms", {})
    for k, h in after.get("histograms", {}).items():
        hb = b_h.get(k, {"count": 0, "sum": 0.0, "buckets": {}})
        dc = h["count"] - hb["count"]
        if not dc:
            continue
        bkts = {edge: c - hb["buckets"].get(edge, 0)
                for edge, c in h["buckets"].items()
                if c - hb["buckets"].get(edge, 0)}
        out["histograms"][k] = {"count": dc,
                                "sum": h["sum"] - hb["sum"],
                                "buckets": bkts}
    return out

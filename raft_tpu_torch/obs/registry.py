"""Counters and gauges (a minimal counterpart of ``raft_tpu.obs.registry``).

Same names as the JAX package (``raft.<module>.<op>...``) and the same
snapshot shape, so the serving tests and dashboards read both alike:
``snapshot() -> {"counters": {series: value}, "gauges": {...}}`` with a
series named ``name{label="value",...}`` when labelled. Histograms,
spans and the exporters are not ported yet.

Bounded cardinality, as in the JAX package: a family (one metric name)
refuses to make more than :data:`max_series` series and raises
:class:`CardinalityError`, so an unbounded label value fails loudly
instead of leaking memory. The cap is read from
``RAFT_TPU_METRICS_MAX_SERIES`` (default 512) when the module is
imported.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Tuple


class CardinalityError(RuntimeError):
    """A labelled family exceeded its configured series cap."""


def _env_max_series() -> int:
    return int(os.environ.get("RAFT_TPU_METRICS_MAX_SERIES", "512"))


max_series = _env_max_series()

_lock = threading.RLock()
_counters: Dict[str, "Counter"] = {}
_gauges: Dict[str, "Gauge"] = {}
_family_sizes: Dict[str, int] = {}


def _series(name: str, labels: dict) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{body}}}"


class Counter:
    """Monotonic counter; ``help`` is its description."""

    def __init__(self, help: str = ""):
        self.value = 0.0
        self.help = help

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter.inc: negative amount")
        with _lock:
            self.value += amount


class Gauge:
    """Value that can go up and down; ``help`` is its description."""

    def __init__(self, help: str = ""):
        self.value = 0.0
        self.help = help

    def set(self, value: float) -> None:
        with _lock:
            self.value = float(value)


def _get(table: dict, other: dict, cls, name: str, help: str,
         labels: dict):
    key = _series(name, labels)
    with _lock:
        inst = table.get(key)
        if inst is None:
            if any(k == name or k.startswith(name + "{") for k in other):
                raise ValueError(f"metric {name!r} already registered "
                                 "as another kind")
            size = _family_sizes.get(name, 0)
            if size >= max_series:
                raise CardinalityError(
                    f"metric family {name!r} exceeded max_series="
                    f"{max_series}: an unbounded label value (id, "
                    f"pointer, timestamp) is leaking series")
            inst = table[key] = cls(help)
            _family_sizes[name] = size + 1
        return inst


def counter(name: str, help: str = "", **labels) -> Counter:
    return _get(_counters, _gauges, Counter, name, help, labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _get(_gauges, _counters, Gauge, name, help, labels)


def snapshot() -> dict:
    with _lock:
        return {"counters": {k: c.value for k, c in _counters.items()},
                "gauges": {k: g.value for k, g in _gauges.items()}}


def counter_sum(snap: dict, name: str) -> float:
    """Sum a counter family over all its labelled series."""
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


__all__: Tuple[str, ...] = ("CardinalityError", "Counter", "Gauge",
                            "counter", "counter_sum", "gauge", "snapshot")

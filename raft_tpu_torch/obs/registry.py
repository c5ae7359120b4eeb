"""Counters and gauges (a minimal counterpart of ``raft_tpu.obs.registry``).

Same names as the JAX package (``raft.<module>.<op>...``) and the same
snapshot shape, so the serving tests and dashboards read both alike:
``snapshot() -> {"counters": {series: value}, "gauges": {...}}`` with a
series named ``name{label="value",...}`` when labelled. Histograms,
spans and the exporters are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

_lock = threading.RLock()
_counters: Dict[str, "Counter"] = {}
_gauges: Dict[str, "Gauge"] = {}


def _series(name: str, labels: dict) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{body}}}"


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter.inc: negative amount")
        with _lock:
            self.value += amount


class Gauge:
    """Value that can go up and down."""

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        with _lock:
            self.value = float(value)


def _get(table: dict, other: dict, cls, name: str, labels: dict):
    key = _series(name, labels)
    with _lock:
        inst = table.get(key)
        if inst is None:
            if any(k == name or k.startswith(name + "{") for k in other):
                raise ValueError(f"metric {name!r} already registered "
                                 "as another kind")
            inst = table[key] = cls()
        return inst


def counter(name: str, **labels) -> Counter:
    return _get(_counters, _gauges, Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    return _get(_gauges, _counters, Gauge, name, labels)


def snapshot() -> dict:
    with _lock:
        return {"counters": {k: c.value for k, c in _counters.items()},
                "gauges": {k: g.value for k, g in _gauges.items()}}


def counter_sum(snap: dict, name: str) -> float:
    """Sum a counter family over all its labelled series."""
    return sum(v for k, v in snap["counters"].items()
               if k == name or k.startswith(name + "{"))


__all__: Tuple[str, ...] = ("Counter", "Gauge", "counter", "counter_sum",
                            "gauge", "snapshot")

"""Deterministic fault injection for the serving stack (counterpart of
``raft_tpu.testing.faults``; stdlib only).

Production code carries named **injection points** (:func:`inject`
calls with labels); a test or a chaos run activates **fault rules**
against them inside a scope: extra latency in plan execution, an error
raised where a dispatch would fail.

* **fault-free by default** — with no active rule, :func:`inject` is a
  single module-flag check; nothing is allocated, matched or locked.
  Rules exist only inside a scoped context manager, so no test leaks a
  fault into the next one (``reset()`` is the teardown belt and
  braces).
* **deterministic** — rules fire on exact label matches; probabilistic
  rules draw from a rule-local ``random.Random(seed)``, never the
  global RNG, so a chaos run replays identically.
* **observable** — every fired rule counts under
  ``raft.testing.fault.injected{site,action}``.

Injection sites (labels in parentheses):

=========================  ==================================================
``serve.execute``          the batcher's dispatch, inside the watchdog's
                           scope (``shape``): a delay here trips
                           ``dispatch_timeout_ms``; wired now
``serve.dist.dispatch``    one mesh-wide dispatch (``ranks``, ``family``):
                           a full-mesh or partial-mesh plan's search;
                           wired in ``serve/dist.py``
``mutate.compact``         ``MutableIndex.compact`` entry, before any state
                           is frozen (no labels); wired in
                           ``mutate/mutable.py``
``mutate.transfer``        the delta/tombstone host-to-device refresh
                           (``epoch``), ``MutableIndex._push_dev_locked``;
                           wired in ``mutate/mutable.py``
``fed.scrape``             one federator scrape (``instance``), before its
                           fetch; wired in ``obs/federation.py``
``obs.blackbox.append``    a black-box record's write (``kind``, ``box``),
                           between its header and its payload; wired in
                           ``obs/blackbox.py``
=========================  ==================================================

Convenience scopes: :func:`stall_shard`, :func:`kill_compactor`,
:func:`fail_transfer`, :func:`delay_execute`. ``stall_shard`` also
raises the per-rank ``raft.comms.health.suspect_rank`` gauge on its
first hit (and clears it on exit), standing in for a health monitor's
stale-heartbeat verdict.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

__all__ = [
    "FaultError",
    "FaultRule",
    "active",
    "delay_execute",
    "fail_transfer",
    "inject",
    "inject_fault",
    "kill_compactor",
    "reset",
    "stall_shard",
]


class FaultError(RuntimeError):
    """The default exception an ``action="error"`` rule raises — typed
    so tests can distinguish an injected failure from a real bug."""


_MISSING = object()

_lock = threading.Lock()
_rules: List["FaultRule"] = []
# fast path: flipped only while at least one rule is registered, read
# without the lock (a stale read costs one extra lock acquisition or
# skips a fault that was concurrently removed — both benign)
_enabled = False


class FaultRule:
    """One active fault: where it applies (``site`` + label ``match``),
    what it does (``action``: ``"delay"`` sleeps ``seconds``,
    ``"error"`` raises), and how often (``probability`` drawn from a
    rule-local seeded RNG; ``max_hits`` 0 = unlimited)."""

    def __init__(self, site: str, action: str = "error",
                 seconds: float = 0.0,
                 error: Optional[Callable[[], BaseException]] = None,
                 match: Optional[Dict[str, object]] = None,
                 probability: float = 1.0, max_hits: int = 0,
                 seed: int = 0,
                 on_hit: Optional[Callable[[dict], None]] = None):
        if action not in ("delay", "error"):
            raise ValueError(f"FaultRule: unknown action {action!r}")
        self.site = site
        self.action = action
        self.seconds = float(seconds)
        self.error = error
        self.match = dict(match or {})
        self.probability = float(probability)
        self.max_hits = int(max_hits)
        self.on_hit = on_hit
        self.hits = 0
        self._rng = random.Random(seed)

    def matches(self, labels: dict) -> bool:
        """Exact label match; a collection-valued label matches when
        the rule value is contained in it (so ``match={"ranks": 3}``
        trips any dispatch whose participating ``ranks`` include 3)."""
        for key, want in self.match.items():
            have = labels.get(key, _MISSING)
            if isinstance(have, (tuple, list, set, frozenset)):
                if want not in have:
                    return False
            elif have != want:
                return False
        return True

    def _make_error(self) -> BaseException:
        if self.error is None:
            return FaultError(f"injected fault at {self.site!r} "
                              f"(hit {self.hits})")
        err = self.error
        return err() if callable(err) else err


def active() -> bool:
    """True while any fault rule is registered (tier-1 must see
    False)."""
    return _enabled


def inject(site: str, **labels) -> None:
    """A named injection point. No-op (one flag read) unless a harness
    scope is active; otherwise fires every matching rule in
    registration order — delays first sleep, error rules raise."""
    if not _enabled:
        return
    fire: List[FaultRule] = []
    with _lock:
        for r in _rules:
            if r.site != site or not r.matches(labels):
                continue
            if r.max_hits > 0 and r.hits >= r.max_hits:
                continue
            if r.probability < 1.0 and r._rng.random() >= r.probability:
                continue
            r.hits += 1
            fire.append(r)
    if not fire:
        return
    from raft_tpu_torch import obs
    for r in fire:
        obs.counter("raft.testing.fault.injected", site=site,
                    action=r.action).inc()
        if r.on_hit is not None:
            r.on_hit(labels)
        if r.action == "delay":
            time.sleep(r.seconds)
        else:
            raise r._make_error()


def reset() -> None:
    """Deactivate every fault (test teardown belt-and-braces)."""
    global _enabled
    with _lock:
        _rules.clear()
        _enabled = False


@contextmanager
def inject_fault(site: str, action: str = "error", seconds: float = 0.0,
                 error: Optional[Callable[[], BaseException]] = None,
                 match: Optional[Dict[str, object]] = None,
                 probability: float = 1.0, max_hits: int = 0,
                 seed: int = 0,
                 on_hit: Optional[Callable[[dict], None]] = None):
    """Scoped activation of one :class:`FaultRule`; yields the rule so
    the caller can read ``rule.hits``. The rule dies with the scope —
    faults cannot outlive the test/chaos window that asked for them."""
    global _enabled
    rule = FaultRule(site, action=action, seconds=seconds, error=error,
                     match=match, probability=probability,
                     max_hits=max_hits, seed=seed, on_hit=on_hit)
    with _lock:
        _rules.append(rule)
        _enabled = True
    try:
        yield rule
    finally:
        with _lock:
            if rule in _rules:
                _rules.remove(rule)
            _enabled = bool(_rules)


@contextmanager
def stall_shard(rank: int, seconds: float = 30.0,
                session: str = "default",
                site: str = "serve.dist.dispatch"):
    """Simulate shard ``rank`` stalling: every dispatch whose
    participating ``ranks`` include it hangs for ``seconds`` (long
    enough to trip ``dispatch_timeout_ms``). On the first hit the
    per-rank suspect gauge is raised — the harness standing in for a
    health monitor's stale-heartbeat detection — and cleared on exit so
    a failover recovery probe sees the shard healthy again."""
    from raft_tpu_torch import obs
    rank = int(rank)
    gauge = obs.gauge("raft.comms.health.suspect_rank",
                      session=session, rank=rank)
    seen = threading.Event()

    def on_hit(_labels):
        if not seen.is_set():
            seen.set()
            gauge.set(1)

    with inject_fault(site, action="delay", seconds=seconds,
                      match={"ranks": rank}, on_hit=on_hit) as rule:
        try:
            yield rule
        finally:
            gauge.set(0)


@contextmanager
def kill_compactor(times: int = 0):
    """Every ``MutableIndex.compact`` attempt raises (``times`` > 0
    bounds how many; 0 = for the whole scope) — the crash-looping
    compactor a compactor's guard must survive."""
    with inject_fault("mutate.compact", action="error",
                      max_hits=times) as rule:
        yield rule


@contextmanager
def fail_transfer(times: int = 1):
    """The next ``times`` delta/tombstone device refreshes raise —
    a failed host→device transfer mid-mutation."""
    with inject_fault("mutate.transfer", action="error",
                      max_hits=times) as rule:
        yield rule


@contextmanager
def delay_execute(ms: float, max_hits: int = 0):
    """Add ``ms`` of latency to every batcher dispatch (inside the
    watchdog scope, so big enough values exercise the timeout path)."""
    with inject_fault("serve.execute", action="delay", seconds=ms / 1e3,
                      max_hits=max_hits) as rule:
        yield rule

"""FleetRouter: one front door over N replicas (counterpart of
``raft_tpu.fleet.router``).

Routing is **power-of-two-choices**: per request the router samples two
routable replicas from ``random.Random(seed)``, compares their
:meth:`~raft_tpu_torch.fleet.replica.Replica.load` and dispatches to the
lighter; when both loads are +inf (neither takes traffic), to the
lightest of the other routable replicas, if one takes any. Replicas outside the routing set (``DRAINING``, ``DOWN``,
``BOOTSTRAPPING``, or *suspect* for ``suspect_ms`` after a
dispatch-class failure) are excluded before the duel, so a sick replica
stops receiving traffic the moment it first fails.

A dispatch that fails at the replica (its own watchdog and retries have
already run underneath) is **retried on a different replica**,
deadline-aware: a request whose budget is spent fails with
:class:`~raft_tpu_torch.serve.DeadlineExceeded` instead of taking another
replica's slot. Backpressure is **per replica**: a shed
(:class:`~raft_tpu_torch.serve.RejectedError`) reroutes without marking
the replica suspect (load is not sickness), and only when every routable
replica refuses does the caller see :class:`FleetUnavailableError`.

Every decision lands in ``raft.fleet.*`` metrics and the
``raft.fleet.route`` span.

Threading model: callers submit from any thread; completion callbacks
run on each replica's dispatcher thread and may re-submit (a retry).
They take the router's lock only to pick candidates, never across a
server call.
"""

from __future__ import annotations

import math
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.fleet.replica import Replica, ReplicaState
from raft_tpu_torch.obs import spans
from raft_tpu_torch.serve.types import (DeadlineExceeded, DispatchError,
                                        RejectedError)
from raft_tpu_torch.util.host import host_array

__all__ = ["FleetConfig", "FleetRouter", "FleetUnavailableError"]


class FleetUnavailableError(RejectedError):
    """No routable replica could take the request: every member is down,
    draining or suspect, or refused admission. A :class:`RejectedError`
    subclass, so callers and the HTTP route treat it as a shed (429)."""


@dataclass(frozen=True)
class FleetConfig:
    """Operating contract of a :class:`FleetRouter`.

    * ``max_retries`` — how many times a failed dispatch is retried on a
      *different* replica; tried replicas are excluded from the re-pick.
    * ``suspect_ms`` — how long a replica that failed a dispatch stays
      out of the routing set. Sheds do NOT mark suspect.
    * ``default_deadline_ms`` — the deadline when ``submit`` passes none
      (0 = none). A retry subtracts the time already spent.
    * ``seed`` — the two-choice sampler's seed.
    """

    max_retries: int = 1
    suspect_ms: float = 2000.0
    default_deadline_ms: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0 or self.suspect_ms < 0:
            raise ValueError("FleetConfig: max_retries and suspect_ms "
                             "must be >= 0")
        if self.default_deadline_ms < 0:
            raise ValueError("FleetConfig: default_deadline_ms must "
                             "be >= 0")


class FleetRouter:
    """The fleet's front door: ``submit() -> Future`` and a blocking
    ``search()``, the call shape of one
    :class:`~raft_tpu_torch.serve.SearchServer`."""

    # static race contract (tools/graftlint GL003): caller threads and
    # every replica's dispatcher thread (completion callbacks) meet on
    # these fields — touch them only under `with self._lock`
    GUARDED_BY = ("_replicas", "_suspect_until", "_rng", "_gauge_t")

    # the fleet-shape gauges refresh at most this often on the routing
    # path: a replica's state changes outside the router (a kill, an
    # operator's drain), and /healthz reads the gauges
    _GAUGE_REFRESH_S = 0.1

    def __init__(self, replicas=(), config: Optional[FleetConfig] = None):
        self._cfg = config if config is not None else FleetConfig()
        self._lock = threading.Lock()
        self._replicas: List[Replica] = list(replicas)
        self._suspect_until: Dict[str, float] = {}
        self._rng = random.Random(self._cfg.seed)
        self._gauge_t = 0.0
        names = [r.name for r in self._replicas]
        expects(len(set(names)) == len(names),
                "FleetRouter: replica names must be unique, got %s",
                names)
        self._refresh_gauges()

    # -- membership --------------------------------------------------------
    @property
    def config(self) -> FleetConfig:
        return self._cfg

    @property
    def replicas(self) -> Tuple[Replica, ...]:
        with self._lock:
            return tuple(self._replicas)

    def replica(self, name: str) -> Replica:
        with self._lock:
            for r in self._replicas:
                if r.name == name:
                    return r
        raise KeyError(f"fleet: no replica named {name!r}")

    def add_replica(self, replica: Replica) -> "FleetRouter":
        with self._lock:
            expects(all(r.name != replica.name for r in self._replicas),
                    "fleet: replica name %r already registered",
                    replica.name)
            self._replicas.append(replica)
        self._refresh_gauges()
        return self

    def remove_replica(self, name: str) -> Replica:
        with self._lock:
            for i, r in enumerate(self._replicas):
                if r.name == name:
                    del self._replicas[i]
                    self._suspect_until.pop(name, None)
                    break
            else:
                raise KeyError(f"fleet: no replica named {name!r}")
        self._refresh_gauges()
        return r

    def _refresh_gauges(self) -> None:
        reps = self.replicas
        now = time.monotonic()
        with self._lock:
            self._gauge_t = now
            suspects = sum(1 for n, t in self._suspect_until.items()
                           if t > now)
        serving = sum(1 for r in reps
                      if r.state is ReplicaState.SERVING)
        obs.gauge("raft.fleet.replicas.total").set(len(reps))
        obs.gauge("raft.fleet.replicas.serving").set(serving)
        obs.gauge("raft.fleet.suspects").set(suspects)

    # -- suspect set -------------------------------------------------------
    def _mark_suspect(self, replica: Replica) -> None:
        until = time.monotonic() + self._cfg.suspect_ms / 1e3
        with self._lock:
            self._suspect_until[replica.name] = until
        obs.counter("raft.fleet.suspect.total",
                    replica=replica.name).inc()
        self._refresh_gauges()

    def suspects(self) -> Tuple[str, ...]:
        now = time.monotonic()
        with self._lock:
            return tuple(sorted(n for n, t in self._suspect_until.items()
                                if t > now))

    # -- routing -----------------------------------------------------------
    def _pick(self, exclude: frozenset) -> Optional[Replica]:
        """Power-of-two-choices over the routable, non-suspect,
        non-excluded set. The candidates are drawn under the lock; the
        load duel runs outside it (``load()`` takes each server's own
        lock)."""
        now = time.monotonic()
        with self._lock:
            stale = now - self._gauge_t > self._GAUGE_REFRESH_S
            cands = [r for r in self._replicas
                     if r.name not in exclude
                     and self._suspect_until.get(r.name, 0.0) <= now]
            if len(cands) >= 2:
                duel = self._rng.sample(cands, 2)
            else:
                duel = list(cands)
        if stale:
            self._refresh_gauges()
        duel = [r for r in duel if r.routable()]
        if not duel:
            # the drawn pair went stale (a state raced) or the set is
            # empty: scan every routable candidate before giving up
            full = [r for r in cands if r.routable()]
            if not full:
                return None
            duel = full[:2]
        if len(duel) == 1:
            return duel[0]
        la, lb = duel[0].load(), duel[1].load()
        if math.isinf(la) and math.isinf(lb):
            # both drawn replicas refuse traffic by load (a failed probe,
            # a closed or draining server): the lightest of the rest
            # that takes any
            rest = [(r.load(), r) for r in cands
                    if r not in duel and r.routable()]
            rest = [(ld, r) for ld, r in rest if not math.isinf(ld)]
            if rest:
                return min(rest, key=lambda t: t[0])[1]
        return duel[0] if la <= lb else duel[1]

    def submit(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               trace_context: Optional[str] = None) -> Future:
        """Route one request → ``Future`` (the result contract of
        :meth:`SearchServer.submit`): the chosen replica's answer after
        up to ``max_retries`` re-routes of dispatch-class failures, or
        the typed error when the fleet cannot serve it.

        ``trace_context`` is an upstream ``traceparent``: the
        ``raft.fleet.route`` span adopts it, and the replica's
        ``raft.serve.request`` root parents under the route span. By
        default the caller thread's open span, if any."""
        q = host_array(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        t_deadline = (time.perf_counter() + deadline_ms / 1e3
                      if deadline_ms and deadline_ms > 0 else None)
        if trace_context is None:
            trace_context = spans.current_traceparent()
        outer: Future = Future()
        self._dispatch(outer, q, k, t_deadline, attempt=0,
                       tried=frozenset(), trace_ctx=trace_context)
        return outer

    def search(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(queries, k, deadline_ms).result(timeout)

    def _remaining_ms(self, t_deadline: Optional[float]
                      ) -> Optional[float]:
        if t_deadline is None:
            return None
        return (t_deadline - time.perf_counter()) * 1e3

    def _dispatch(self, outer: Future, q, k,
                  t_deadline: Optional[float], attempt: int,
                  tried: frozenset,
                  trace_ctx: Optional[str] = None) -> None:
        remaining = self._remaining_ms(t_deadline)
        if remaining is not None and remaining <= 0:
            obs.counter("raft.fleet.deadline.total").inc()
            outer.set_exception(DeadlineExceeded(
                f"fleet: deadline expired after {attempt} attempt(s)"))
            return
        rep = self._pick(tried)
        if rep is None and tried:
            # every untried replica is out: as a last resort readmit the
            # tried ones (a shed on a busy replica beats a certain
            # FleetUnavailableError)
            rep = self._pick(frozenset())
        if rep is None:
            obs.counter("raft.fleet.unroutable.total").inc()
            self._refresh_gauges()
            outer.set_exception(FleetUnavailableError(
                "fleet: no routable replica "
                f"(total={len(self.replicas)}, "
                f"suspects={list(self.suspects())})"))
            return
        obs.counter("raft.fleet.route.total", replica=rep.name).inc()
        # the route span stays open across srv.submit, so the replica's
        # server takes it as the request's trace context
        with spans.span("raft.fleet.route", remote_parent=trace_ctx,
                        replica=rep.name,
                        nq=int(q.shape[0]), attempt=attempt):
            srv = rep.server
            try:
                if srv is None:
                    # killed under our feet: a retryable dispatch
                    # failure, as a crashed process is
                    raise DispatchError(
                        f"fleet: replica {rep.name} lost its server "
                        f"mid-route")
                inner = srv.submit(q, k=k, deadline_ms=remaining)
            except Exception as e:
                self._on_failure(outer, q, k, t_deadline, attempt,
                                 tried, rep, e, trace_ctx)
                return
        inner.add_done_callback(
            lambda f: self._complete(f, outer, q, k, t_deadline,
                                     attempt, tried, rep, trace_ctx))

    def _complete(self, inner: Future, outer: Future, q, k,
                  t_deadline: Optional[float], attempt: int,
                  tried: frozenset, rep: Replica,
                  trace_ctx: Optional[str] = None) -> None:
        exc = inner.exception()
        if exc is None:
            if attempt:
                obs.counter("raft.fleet.retry.success.total").inc()
            obs.counter("raft.fleet.completed.total").inc()
            outer.set_result(inner.result())
            return
        self._on_failure(outer, q, k, t_deadline, attempt, tried, rep,
                         exc, trace_ctx)

    def _on_failure(self, outer: Future, q, k,
                    t_deadline: Optional[float], attempt: int,
                    tried: frozenset, rep: Replica, exc,
                    trace_ctx: Optional[str] = None) -> None:
        # a dispatch-class failure implicates the replica (suspect for
        # suspect_ms); a shed reroutes without suspecting; a deadline is
        # the caller's budget, final
        retryable = isinstance(exc, (DispatchError, RejectedError)) \
            and not isinstance(exc, FleetUnavailableError)
        if isinstance(exc, DispatchError):
            self._mark_suspect(rep)
        if isinstance(exc, DeadlineExceeded) or not retryable \
                or attempt >= self._cfg.max_retries:
            if retryable and attempt >= self._cfg.max_retries:
                obs.counter("raft.fleet.retry.exhausted.total").inc()
            obs.counter("raft.fleet.errors.total",
                        error=type(exc).__name__).inc()
            outer.set_exception(exc)
            return
        obs.counter("raft.fleet.retry.total").inc()
        self._dispatch(outer, q, k, t_deadline, attempt + 1,
                       tried | {rep.name}, trace_ctx=trace_ctx)

    # -- surfaces ----------------------------------------------------------
    def report(self) -> dict:
        """The fleet's snapshot for ``/debug/fleet``: each replica's
        state, load and share of the routes, and, while the resource
        profiler is on, its sampled duty cycle beside the load routing
        used; the suspect set and the config."""
        from raft_tpu_torch.obs import profiler
        reps = self.replicas
        snap = obs.snapshot()["counters"]
        routes = {}
        for key, v in snap.items():
            if key.startswith("raft.fleet.route.total{"):
                name = key.split("replica=")[1].rstrip("}").split(",")[0]
                routes[name] = routes.get(name, 0) + int(v)
        total = max(1, sum(routes.values()))
        profiling = profiler.state() is not None
        replicas = []
        for r in reps:
            row = dict(r.describe(), routed=routes.get(r.name, 0),
                       route_share=round(
                           routes.get(r.name, 0) / total, 4))
            if profiling:
                dc = profiler.duty_cycle(tag=r.name)
                row["duty_cycle"] = (round(dc, 6)
                                     if dc is not None else None)
            replicas.append(row)
        body = {
            "replicas": replicas,
            "serving": sum(1 for r in reps
                           if r.state is ReplicaState.SERVING),
            "suspects": list(self.suspects()),
            "config": {"max_retries": self._cfg.max_retries,
                       "suspect_ms": self._cfg.suspect_ms},
        }
        if profiling:
            body["utilization"] = {
                "duty_cycle": round(profiler.duty_cycle() or 0.0, 6),
                "sample_rate": profiler.profile_sample_rate(),
            }
        return body

    def close(self, drain_timeout_s: float = 10.0) -> None:
        """Stop the whole fleet: drain, then close, every replica."""
        for r in self.replicas:
            if r.state is not ReplicaState.DOWN:
                r.stop(drain_timeout_s)
        self._refresh_gauges()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

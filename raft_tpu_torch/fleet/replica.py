"""Replica: one serving process in a fleet, with an explicit lifecycle
(counterpart of ``raft_tpu.fleet.replica``).

A :class:`Replica` wraps one :class:`~raft_tpu_torch.serve.SearchServer`
(or anything with its ``submit``/``search``/``load``/``drain``/``close``
surface, such as :class:`~raft_tpu_torch.fleet.remote.RemoteSearchClient`)
and gives the fleet the three things routing needs that a bare server
does not expose:

* **lifecycle states** — ``BOOTSTRAPPING → SERVING → DRAINING → DOWN``
  (and ``DOWN → BOOTSTRAPPING`` for a rolling restart's rebirth). The
  transitions are validated, and each lands in ``raft.fleet.replica.*``
  metrics, so the fleet's shape can be read from the registry alone.
* **load** — one scalar from the server's :meth:`~raft_tpu_torch.serve.
  SearchServer.load` snapshot (queued + in-flight rows, plus a shed-rate
  penalty): the power-of-two-choices input of
  :class:`~raft_tpu_torch.fleet.router.FleetRouter`, and the same
  snapshot ``/debug/fleet`` shows.
* **drain-before-stop** — :meth:`drain` takes the replica out of the
  routing set and flushes its queue (every outstanding future resolves)
  before :meth:`stop` closes anything.

Threading model: router threads, an operator and a replicator meet on
the state machine, all of it under ``self._lock`` (the GL003 contract
below); the wrapped server's own lock is never taken while holding it.
"""

from __future__ import annotations

import enum
import os
import threading
from typing import Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger

__all__ = ["Replica", "ReplicaState"]


class ReplicaState(enum.Enum):
    """Lifecycle of one replica. The gauge code (the value exported under
    ``raft.fleet.replica.state{replica=...}``) is ``.code``."""

    BOOTSTRAPPING = "bootstrapping"
    SERVING = "serving"
    DRAINING = "draining"
    DOWN = "down"

    @property
    def code(self) -> int:
        return _STATE_CODE[self]


_STATE_CODE = {ReplicaState.BOOTSTRAPPING: 0, ReplicaState.SERVING: 1,
               ReplicaState.DRAINING: 2, ReplicaState.DOWN: 3}

# the legal edges: a bootstrap ends SERVING or DOWN; a serving replica
# drains before it stops, or is declared DOWN when found dead (a kill is
# not a drain); a drain ends DOWN or aborts back to SERVING; only a DOWN
# replica bootstraps again
_ALLOWED = {
    ReplicaState.BOOTSTRAPPING: {ReplicaState.SERVING, ReplicaState.DOWN},
    ReplicaState.SERVING: {ReplicaState.DRAINING, ReplicaState.DOWN},
    ReplicaState.DRAINING: {ReplicaState.SERVING, ReplicaState.DOWN},
    ReplicaState.DOWN: {ReplicaState.BOOTSTRAPPING},
}

# the load of a replica that must not take traffic: above any real queue,
# so a candidate that slipped through loses every duel
_UNROUTABLE_LOAD = float("inf")


class Replica:
    """One fleet member: a named server, its lifecycle and load signal.

    Built around a running server, it starts ``SERVING``; built empty, it
    starts ``BOOTSTRAPPING`` and :meth:`set_server` installs the server
    once replication has caught up."""

    # static race contract (tools/graftlint GL003): router threads, the
    # rolling-restart operator and the replication thread meet on these
    # fields — touch them only under `with self._lock`
    GUARDED_BY = ("_state", "_server", "_replicator", "_blackbox")

    def __init__(self, name: str, server=None,
                 state: Optional[ReplicaState] = None, replicator=None):
        expects(bool(name), "Replica: name must be non-empty")
        self.name = str(name)
        self._lock = threading.Lock()
        self._server = server
        self._replicator = replicator
        self._blackbox = None
        self._state = (state if state is not None else
                       (ReplicaState.SERVING if server is not None
                        else ReplicaState.BOOTSTRAPPING))
        self._tag_server(server)
        obs.gauge("raft.fleet.replica.state",
                  replica=self.name).set(self._state.code)

    def _tag_server(self, server) -> None:
        """Name the wrapped server's sampled dispatches after this
        replica in the resource profiler, so ``router.report()`` gives
        each replica's utilization. Duck-typed: a fake without the
        batcher's API is left alone."""
        tag = getattr(server, "set_profile_tag", None)
        if tag is not None:
            tag(self.name)

    # -- introspection -----------------------------------------------------
    @property
    def state(self) -> ReplicaState:
        with self._lock:
            return self._state

    @property
    def server(self):
        with self._lock:
            return self._server

    @property
    def replicator(self):
        with self._lock:
            return self._replicator

    def set_blackbox(self, box) -> "Replica":
        """Attach a per-replica black box: any object with
        ``flush(reason)`` and a ``dir``, or a directory, for which a
        :class:`raft_tpu_torch.obs.blackbox.BlackBox` named after this
        replica is built (its first flush is at construction; it runs no
        cadence thread until its ``start()``). :meth:`kill` and
        :meth:`stop` flush it, so even a death without a drain leaves its
        last state on disk, and :meth:`describe` carries its ``dir`` into
        ``router.report()``."""
        if isinstance(box, (str, bytes, os.PathLike)):
            from raft_tpu_torch.obs.blackbox import BlackBox
            box = BlackBox(os.fsdecode(box), box=self.name)
        with self._lock:
            self._blackbox = box
        return self

    def _flush_blackbox(self, reason: str) -> None:
        with self._lock:
            box = self._blackbox
        if box is None:
            return
        try:
            box.flush(reason)
        except Exception:
            # forensics are best-effort on the death path: a broken flush
            # must never turn kill() or stop() into a raise
            get_logger("fleet").warning(
                "replica %s: blackbox flush (%s) failed",
                self.name, reason)

    def set_server(self, server, replicator=None) -> "Replica":
        """Install a (new) server: the bootstrap and rolling-restart
        hand-off. The old server is NOT closed here (its owner drains,
        closes, then swaps). ``set_server(None)`` detaches the server and
        the replicator."""
        with self._lock:
            self._server = server
            if replicator is not None or server is None:
                self._replicator = replicator
        self._tag_server(server)
        return self

    # -- lifecycle ---------------------------------------------------------
    def to(self, new_state: ReplicaState) -> "Replica":
        """Move the lifecycle along a legal edge; exported as the state
        gauge and a transition counter."""
        with self._lock:
            expects(new_state in _ALLOWED[self._state],
                    "replica %s: illegal transition %s -> %s",
                    self.name, self._state.value, new_state.value)
            self._state = new_state
        obs.gauge("raft.fleet.replica.state",
                  replica=self.name).set(new_state.code)
        obs.counter("raft.fleet.replica.transitions.total",
                    replica=self.name, to=new_state.value).inc()
        return self

    def mark_serving(self) -> "Replica":
        return self.to(ReplicaState.SERVING)

    def begin_drain(self) -> "Replica":
        return self.to(ReplicaState.DRAINING)

    def mark_down(self) -> "Replica":
        return self.to(ReplicaState.DOWN)

    def begin_bootstrap(self) -> "Replica":
        return self.to(ReplicaState.BOOTSTRAPPING)

    # -- routing signals ---------------------------------------------------
    def routable(self) -> bool:
        """May the router send traffic here? SERVING with a server;
        every other state is out of the set before any load duel."""
        with self._lock:
            return (self._state is ReplicaState.SERVING
                    and self._server is not None)

    def load(self) -> float:
        """The power-of-two-choices scalar: queued + in-flight rows from
        the server's ``load()`` snapshot, plus 100 x its shed rate (a
        replica bouncing work is worse than its queue says). A replica
        that must not take traffic, or whose probe fails, is +inf."""
        with self._lock:
            srv = self._server
            state = self._state
        if state is not ReplicaState.SERVING or srv is None:
            return _UNROUTABLE_LOAD
        try:
            snap = srv.load()
        except Exception:
            get_logger("fleet").warning(
                "replica %s: load() probe failed — treating as "
                "unroutable", self.name)
            obs.counter("raft.fleet.replica.load_errors.total",
                        replica=self.name).inc()
            return _UNROUTABLE_LOAD
        if snap.get("closed") or snap.get("draining"):
            return _UNROUTABLE_LOAD
        return (float(snap["queued_rows"]) + float(snap["inflight_rows"])
                + 100.0 * float(snap.get("shed_rate", 0.0)))

    # -- drain-before-stop -------------------------------------------------
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Leave the routing set (``DRAINING``) and flush the server's
        queue: every accepted request completes, new ones shed with
        reason ``draining``. The server's verdict (False: timed out with
        work left)."""
        self.to(ReplicaState.DRAINING)
        with self._lock:
            srv = self._server
        return srv.drain(timeout_s) if srv is not None else True

    def stop(self, drain_timeout_s: float = 30.0) -> bool:
        """Drain, then close the server (and the replicator, when one is
        attached), then ``DOWN``: nothing closes before the queue is
        flushed, which is what a rolling restart's zero failed requests
        rests on."""
        drained = True
        with self._lock:
            state = self._state
        if state is ReplicaState.SERVING:
            drained = self.drain(drain_timeout_s)
        with self._lock:
            srv, repl = self._server, self._replicator
            self._server = None
            self._replicator = None
        if repl is not None:
            repl.close()
        if srv is not None:
            srv.close()
        with self._lock:
            state = self._state
        if state is not ReplicaState.DOWN:
            self.to(ReplicaState.DOWN)
        self._flush_blackbox("stop")
        return drained

    def kill(self) -> None:
        """Immediate death (the chaos path): no drain; the server closes
        under the fleet's feet and its queued work fails with typed
        errors, as a crashed process looks to the router."""
        with self._lock:
            srv, repl = self._server, self._replicator
            self._server = None
            self._replicator = None
            state = self._state
        if state is not ReplicaState.DOWN:
            self.to(ReplicaState.DOWN)
        if repl is not None:
            repl.close()
        if srv is not None:
            srv.close()
        # the box is spilled after the DOWN transition, so its last frame
        # shows the death
        self._flush_blackbox("kill")

    def describe(self) -> dict:
        """A structured snapshot for ``/debug/fleet``."""
        with self._lock:
            srv = self._server
            state = self._state
            box = self._blackbox
        body = {"name": self.name, "state": state.value}
        if box is not None:
            body["blackbox"] = getattr(box, "dir", None)
        if srv is not None and state is not ReplicaState.DOWN:
            try:
                body["load"] = srv.load()
            except Exception:   # graftlint: disable=GL006
                # a debug snapshot must not fail because a server is being
                # torn down (justified swallow: the state field says it)
                body["load"] = None
        return body

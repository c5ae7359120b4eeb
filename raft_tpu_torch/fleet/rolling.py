"""Rolling restart: the fleet's zero-downtime upgrade (counterpart of
``raft_tpu.fleet.rolling``).

One replica at a time: leave the routing set (``DRAINING``: the router
stops picking it before its queue is touched), flush the queue, restart
it through the caller's ``restart_fn`` (typically
:func:`~raft_tpu_torch.fleet.replication.bootstrap_replica` from the
snapshot and the log's tail, the path a new replica takes), rejoin
(``SERVING``), then the next. The fleet never loses more than one
replica of capacity, and a restart that fails halts the rollout with the
other replicas untouched.

``restart_fn(replica)`` is called with the replica ``BOOTSTRAPPING`` and
its old (drained, closed) server detached; it installs the new server
with :meth:`~raft_tpu_torch.fleet.replica.Replica.set_server` (and may
attach a fresh :class:`~raft_tpu_torch.fleet.replication.Replicator`).
An exception leaves the replica ``DOWN`` and stops the rollout.
"""

from __future__ import annotations

import time
from typing import Callable

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.fleet.replica import Replica, ReplicaState
from raft_tpu_torch.fleet.router import FleetRouter
from raft_tpu_torch.obs import spans

__all__ = ["rolling_restart"]


def rolling_restart(router: FleetRouter,
                    restart_fn: Callable[[Replica], None],
                    drain_timeout_s: float = 30.0,
                    require_capacity: bool = True) -> dict:
    """Restart every serving replica of ``router``, one at a time, with
    no failed request (traffic flows through the others; the draining
    replica flushes before anything closes) → the rollout's report
    (seconds and verdict a replica). ``require_capacity`` refuses to
    start unless two replicas serve: a one-replica "rolling" restart is
    an outage, which the caller acknowledges by passing False."""
    serving = [r for r in router.replicas
               if r.state is ReplicaState.SERVING]
    if require_capacity:
        expects(len(serving) >= 2,
                "rolling_restart: only %d serving replica(s) — a "
                "rolling restart needs >= 2 to stay available "
                "(require_capacity=False acknowledges the outage)",
                len(serving))
    log = get_logger("fleet")
    report = {"replicas": [], "ok": True}
    with obs.timed("raft.fleet.rolling"), \
            spans.span("raft.fleet.rolling", count=len(serving)) as sp:
        for rep in serving:
            t0 = time.perf_counter()
            entry = {"name": rep.name, "drained": False, "ok": False}
            report["replicas"].append(entry)
            # 1. out of the routing set, flush the queue
            entry["drained"] = rep.drain(drain_timeout_s)
            # 2. detach and close the old server (a drain that timed out
            #    still closes: its stragglers fail typed, and the report
            #    says so)
            old_srv = rep.server
            old_repl = rep.replicator
            rep.set_server(None)
            rep.to(ReplicaState.DOWN)
            if old_repl is not None:
                old_repl.close()
            if old_srv is not None:
                old_srv.close()
            # 3. rebirth from the durable state
            rep.begin_bootstrap()
            try:
                restart_fn(rep)
                expects(rep.server is not None,
                        "rolling_restart: restart_fn left replica %s "
                        "without a server (set_server is its job)",
                        rep.name)
            except Exception as e:
                rep.to(ReplicaState.DOWN)
                obs.counter("raft.fleet.rolling.failures.total").inc()
                log.error(
                    "rolling restart: %s failed to come back (%r) — "
                    "HALTING the rollout with %d replica(s) not yet "
                    "restarted", rep.name, e,
                    len(serving) - len(report["replicas"]))
                entry["error"] = repr(e)[:200]
                entry["seconds"] = round(time.perf_counter() - t0, 3)
                report["ok"] = False
                sp.set_attr("halted_at", rep.name)
                break
            # 4. rejoin
            rep.mark_serving()
            entry["ok"] = True
            entry["seconds"] = round(time.perf_counter() - t0, 3)
            log.info("rolling restart: %s back in %.3fs", rep.name,
                     entry["seconds"])
        sp.set_attr("ok", report["ok"])
    obs.counter("raft.fleet.rolling.total").inc()
    return report

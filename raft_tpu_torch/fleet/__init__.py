"""raft_tpu_torch.fleet — replica fleet serving (counterpart of
``raft_tpu.fleet``): N replicas of an index behind one front door.

* :class:`~raft_tpu_torch.fleet.replica.Replica` — one server with an
  explicit lifecycle (``BOOTSTRAPPING → SERVING → DRAINING → DOWN``), a
  load signal from its batcher, and drain-before-stop.
* :mod:`~raft_tpu_torch.fleet.replication` — a new replica bootstraps
  from the primary's fold checkpoint and converges by tailing the
  mutation WAL; a :class:`~raft_tpu_torch.fleet.replication.Replicator`
  thread keeps it fresh and exports its lag.
* :class:`~raft_tpu_torch.fleet.router.FleetRouter` — power-of-two-
  choices over the replicas' queue depth, suspect exclusion,
  deadline-aware retry on another replica, per-replica admission.
* :func:`~raft_tpu_torch.fleet.rolling.rolling_restart` — drain one,
  restart it from the snapshot and the log, rejoin, next.
* **processes** — :class:`~raft_tpu_torch.fleet.proc.ProcessFleet`
  spawns replicas as OS processes (``python -m
  raft_tpu_torch.fleet.fleetd``, on the card by default, every daemon on
  card 0 of a one-card machine) behind the HTTP transport
  (:mod:`~raft_tpu_torch.fleet.transport`, the JAX package's wire); a
  :class:`~raft_tpu_torch.fleet.remote.RemoteReplica` fronts each, and
  WAL records cross the wire verbatim.

Quick use::

    from raft_tpu_torch import fleet, serve

    reps = [fleet.Replica(f"r{i}", serve.SearchServer.from_index(
                index, rep_q, k=10)) for i in range(3)]
    router = fleet.FleetRouter(reps, fleet.FleetConfig(max_retries=1))
    dists, ids = router.search(queries)       # one front door
    fleet.rolling_restart(router, my_restart_fn)
    router.close()

Everything lands in the ``raft.fleet.*`` metrics and spans, folded into
``/healthz`` and ``/debug/fleet`` (``obs.serve(fleet=router)``).
"""

from raft_tpu_torch.fleet.proc import FleetProcess, ProcessFleet, device_env
from raft_tpu_torch.fleet.remote import (RemoteReplica, RemoteSearchClient,
                                         bootstrap_from_url)
from raft_tpu_torch.fleet.replica import Replica, ReplicaState
from raft_tpu_torch.fleet.replication import (Replicator, WalApplier,
                                              bootstrap_replica)
from raft_tpu_torch.fleet.rolling import rolling_restart
from raft_tpu_torch.fleet.router import (FleetConfig, FleetRouter,
                                         FleetUnavailableError)
from raft_tpu_torch.fleet.transport import (RemoteWalReader,
                                            ReplicaTransport,
                                            TransportClient, serve_replica)

__all__ = [
    "FleetConfig",
    "FleetProcess",
    "FleetRouter",
    "FleetUnavailableError",
    "ProcessFleet",
    "RemoteReplica",
    "RemoteSearchClient",
    "RemoteWalReader",
    "Replica",
    "ReplicaState",
    "ReplicaTransport",
    "Replicator",
    "TransportClient",
    "WalApplier",
    "bootstrap_from_url",
    "bootstrap_replica",
    "device_env",
    "rolling_restart",
    "serve_replica",
]

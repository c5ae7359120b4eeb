"""Session bootstrap (counterpart of ``raft_tpu.comms.bootstrap``).

The JAX package joins its coordination service and builds one mesh over
every process's devices. The port joins ``torch.distributed`` through a
``TCPStore`` at the coordinator's address (the store plays the
coordination service: ``host_p2p`` and ``health`` use it as their KV
channel), one rank a process: ``make_mesh()`` then builds the **process
mesh**, on which ``Comms`` collectives go through ``torch.distributed``
(NCCL on the card, gloo on the CPU). :class:`Session` owns a mesh, its
communicator and a :class:`~raft_tpu_torch.core.resources.Resources`
with them injected, and registers itself for :func:`local_handle`.
"""

from __future__ import annotations

import datetime
import threading
import uuid
from typing import Dict, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.comms import Comms, build_comms, inject_comms
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.parallel import mesh as mesh_mod

__all__ = ["Session", "initialize_distributed", "local_handle"]

_sessions: Dict[str, "Session"] = {}
_lock = threading.Lock()

# the bound world's store and its client facade
_STORE = None
_CLIENT = None
# how long joining (and each store wait) may take
JOIN_TIMEOUT_S = 120.0


class _StoreClient:
    """The coordination-client shape (``key_value_set`` /
    ``blocking_key_value_get`` / ``key_value_try_get`` /
    ``key_value_delete``) over a ``torch.distributed`` store."""

    def __init__(self, store):
        self._st = store

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = True) -> None:
        del allow_overwrite  # a store set always overwrites
        self._st.set(key, value.encode("latin-1"))

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        try:
            self._st.wait([key], datetime.timedelta(
                milliseconds=max(1, int(timeout_ms))))
        except Exception as e:
            if "timeout" not in str(e).lower():
                raise
            raise TimeoutError(f"DEADLINE_EXCEEDED: store get({key!r}, "
                               f"{timeout_ms}ms)") from None
        return self._st.get(key).decode("latin-1")

    def key_value_try_get(self, key: str) -> Optional[str]:
        if not self._st.check([key]):
            return None
        return self._st.get(key).decode("latin-1")

    def key_value_delete(self, key: str) -> None:
        self._st.delete_key(key)


def _store_client():
    return _CLIENT


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process world (the NCCL-unique-id exchange's role):
    process ``process_id`` of ``num_processes`` meets the others at
    ``coordinator_address`` (``host:port``; process 0 hosts the store).
    ``backend``: ``"nccl"`` (one card a process, the default when a card
    is visible) or ``"gloo"`` (the CPU; asked for explicitly). A no-op
    without an address; joining twice is an error."""
    global _STORE, _CLIENT
    if coordinator_address is None:
        return
    import torch.distributed as dist
    expects(not dist.is_initialized(),
            "initialize_distributed: a process group is already bound")
    expects(num_processes is not None and process_id is not None,
            "initialize_distributed: num_processes and process_id are "
            "required")
    if backend is None:
        expects(torch.cuda.is_available(),
                "initialize_distributed: no CUDA device; pass "
                "backend='gloo' to join on the CPU")
        backend = "nccl"
    expects(backend in ("nccl", "gloo"),
            "initialize_distributed: backend %r (want nccl|gloo)", backend)
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    store = torch.distributed.TCPStore(
        host, int(port), world_size=int(num_processes),
        is_master=int(process_id) == 0, timeout=timeout)
    if backend == "nccl":
        dev = torch.device("cuda",
                           int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, store=store,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _STORE = store
    _CLIENT = _StoreClient(store)
    mesh_mod._set_process_world((int(num_processes), int(process_id), dev))


def shutdown_distributed() -> None:
    """Leave the process world bound by :func:`initialize_distributed`."""
    global _STORE, _CLIENT
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = _CLIENT = None
    mesh_mod._set_process_world(None)


def _process_index() -> Tuple[int, int]:
    w = mesh_mod.process_world()
    return (w[1], w[0]) if w is not None else (0, 1)


class Session:
    """A comms session over a mesh (reference raft_dask ``Comms``).

    ``init()`` builds the mesh (over ``devices``, else as
    :func:`~raft_tpu_torch.parallel.mesh.make_mesh` does), creates the
    communicator, named subcomms per remaining axis and a Resources with
    them injected.
    """

    def __init__(self, axis_names: Tuple[str, ...] = ("data",),
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 devices: Optional[Sequence] = None,
                 name: str = "default"):
        # ``name`` must agree across processes (it scopes the host p2p
        # keys); session_id is process-local, for local_handle
        self.name = name
        self.session_id = uuid.uuid4().hex[:16]
        self._axis_names = axis_names
        self._mesh_shape = mesh_shape
        self._devices = devices
        self.mesh: Optional[mesh_mod.Mesh] = None
        self.resources: Optional[Resources] = None
        self.comms: Optional[Comms] = None

    def init(self) -> "Session":
        self.mesh = mesh_mod.make_mesh(self._mesh_shape, self._axis_names,
                                       self._devices)
        dev = (self.mesh.devices_flat[self.mesh.process_rank]
               if self.mesh.is_process_mesh else self.mesh.devices_flat[0])
        self.resources = Resources(dev, mesh=self.mesh)
        self.comms = build_comms(self.mesh, self._axis_names[0])
        inject_comms(self.resources, self.comms)
        for ax in self._axis_names[1:]:
            self.resources.set_subcomm(ax, build_comms(self.mesh, ax))
        with _lock:
            _sessions[self.session_id] = self
        return self

    def host_p2p(self):
        """The session's tagged host p2p channel among its processes
        (one per Session: sequence numbers must not restart)."""
        from raft_tpu_torch.comms.host_p2p import HostP2P
        expects(self.mesh is not None, "Session not initialized")
        if getattr(self, "_host_p2p", None) is None:
            rank, size = _process_index()
            self._host_p2p = HostP2P(rank, size, session=self.name)
        return self._host_p2p

    def health(self, interval_s: float = 1.0, stale_after_s: float = 10.0):
        """The process-level heartbeat monitor of this session's clique
        (started on first call; one per Session)."""
        from raft_tpu_torch.comms.health import HealthMonitor
        expects(self.mesh is not None, "Session not initialized")
        if getattr(self, "_health", None) is None:
            rank, size = _process_index()
            self._health = HealthMonitor(
                rank, size, session=self.name, interval_s=interval_s,
                stale_after_s=stale_after_s).start()
        return self._health

    def destroy(self) -> None:
        with _lock:
            _sessions.pop(self.session_id, None)
        if getattr(self, "_health", None) is not None:
            self._health.stop()
            self._health = None
        self._host_p2p = None
        if self.mesh is not None:
            self.mesh.close()
        self.mesh = None
        self.resources = None
        self.comms = None

    def __enter__(self):
        return self.init()

    def __exit__(self, *exc):
        self.destroy()


def local_handle(session_id: str) -> Resources:
    """Resources bound to a session (reference raft_dask
    ``local_handle(sessionId)``)."""
    with _lock:
        expects(session_id in _sessions, "unknown session %s", session_id)
        return _sessions[session_id].resources

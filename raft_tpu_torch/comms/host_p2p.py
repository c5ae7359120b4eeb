"""Tagged host-side point-to-point messaging (counterpart of
``raft_tpu.comms.host_p2p``; the UCX role of the reference's
``std_comms.hpp:209-305``).

Tagged messages become key-value entries ``p2p/<src>-><dst>/<tag>/<seq>``
of a store every process reaches: the ``torch.distributed`` TCP store
that ``initialize_distributed`` joins (the JAX package's coordination
service), or any client shaped like it (``key_value_set`` /
``blocking_key_value_get``; e.g. :class:`~raft_tpu_torch.comms.
native_p2p.NativeKVClient`). ``irecv`` waits on its key with a timeout:
``Status.ABORT`` instead of a hang. In one process an in-memory registry
serves the same API.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from raft_tpu_torch.comms.comms import Status
from raft_tpu_torch.core.error import expects

__all__ = ["HostP2P", "Request"]


def _coordination_client():
    """The bound process world's store client
    (``bootstrap.initialize_distributed``), or None."""
    from raft_tpu_torch.comms import bootstrap
    return bootstrap._store_client()


class _InProcessRegistry:
    """Shared mailbox for ranks living in one process."""

    GUARDED_BY = ("_boxes",)        # tools/graftlint GL003

    def __init__(self):
        self._boxes: Dict[Tuple[str, int, int, int, int], queue.Queue] = {}
        self._lock = threading.Lock()

    def box(self, session: str, src: int, dst: int, tag: int,
            seq: int) -> queue.Queue:
        key = (session, src, dst, tag, seq)
        with self._lock:
            if key not in self._boxes:
                self._boxes[key] = queue.Queue()
            return self._boxes[key]


# ranks of a single-process clique share this registry by default
_default_registry = _InProcessRegistry()


@dataclass
class Request:
    """A pending send/recv (reference ``request_t``)."""

    _wait: object                      # callable(timeout_s) -> bytes|None
    done: bool = False
    payload: Optional[bytes] = None

    def wait(self, timeout_s: Optional[float] = None) -> Status:
        if self.done:
            return Status.SUCCESS
        out = self._wait(timeout_s)
        if out is None:
            return Status.ABORT
        self.payload = out
        self.done = True
        return Status.SUCCESS


class HostP2P:
    """Tagged host p2p between the ranks of a comms clique.

    ``session`` scopes keys so concurrent cliques don't collide. Messages
    with the same (src, dst, tag) are ordered by an internal sequence
    number.
    """

    def __init__(self, rank: int, size: int, session: str = "default",
                 registry: Optional[_InProcessRegistry] = None,
                 client=None):
        """``client`` overrides the transport: anything shaped like the
        store client (``key_value_set`` / ``blocking_key_value_get``)."""
        expects(0 <= rank < size, "HostP2P: bad rank")
        self.rank = rank
        self.size = size
        self.session = session
        if client is not None:
            self._client = client
            registry = None
        else:
            self._client = (None if registry is not None
                            else _coordination_client())
        self._registry = registry
        if self._client is None and self._registry is None:
            self._registry = _default_registry
        self._send_seq: Dict[Tuple[int, int], int] = {}
        self._recv_seq: Dict[Tuple[int, int], int] = {}

    def _key(self, src: int, dst: int, tag: int, seq: int) -> str:
        return f"raft_tpu/p2p/{self.session}/{src}->{dst}/{tag}/{seq}"

    def _next_seq(self, table, src: int, dst: int, tag: int) -> int:
        k = (src * self.size + dst, tag)
        s = table.get(k, 0)
        table[k] = s + 1
        return s

    def isend(self, payload: bytes, dest: int, tag: int = 0) -> Request:
        """Post a tagged send; completes eagerly (buffered semantics)."""
        expects(0 <= dest < self.size, "isend: bad dest rank")
        seq = self._next_seq(self._send_seq, self.rank, dest, tag)
        if self._client is not None:
            self._client.key_value_set(
                self._key(self.rank, dest, tag, seq),
                payload.decode("latin-1"))
        else:
            self._registry.box(self.session, self.rank, dest, tag,
                               seq).put(payload)
        return Request(_wait=lambda t: payload, done=True, payload=payload)

    def irecv(self, source: int, tag: int = 0) -> Request:
        """Post a tagged receive; ``wait()`` blocks with timeout."""
        expects(0 <= source < self.size, "irecv: bad source rank")
        seq = self._next_seq(self._recv_seq, source, self.rank, tag)
        if self._client is not None:
            key = self._key(source, self.rank, tag, seq)
            client = self._client

            def waiter(timeout_s):
                try:
                    ms = int((timeout_s if timeout_s is not None else 600.0)
                             * 1000)
                    return client.blocking_key_value_get(
                        key, ms).encode("latin-1")
                except Exception as e:  # a timeout is ABORT; a transport
                    # failure must surface, not pass for a peer timeout
                    msg = str(e).upper()
                    if "DEADLINE" in msg or "TIMEOUT" in msg:
                        return None
                    raise
        else:
            box = self._registry.box(self.session, source, self.rank,
                                     tag, seq)

            def waiter(timeout_s):
                try:
                    return box.get(timeout=timeout_s)
                except queue.Empty:
                    return None
        return Request(_wait=waiter)

    def waitall(self, requests, timeout_s: Optional[float] = 10.0) -> Status:
        """Progress all requests; any timing out → ABORT."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        for r in requests:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if r.wait(remaining) != Status.SUCCESS:
                return Status.ABORT
        return Status.SUCCESS

"""A native TCP key-value transport for tagged host p2p and heartbeats
(counterpart of ``raft_tpu.comms.native_p2p``).

The JAX package wraps its own C++ broker; the port uses the C++ TCP
store that ships with ``torch.distributed`` (``TCPStore``). Rank 0 hosts
it; every rank's :class:`~raft_tpu_torch.comms.host_p2p.HostP2P` or
:class:`~raft_tpu_torch.comms.health.HealthMonitor` talks to it through
:class:`NativeKVClient`, shaped like the store client
(``key_value_set`` / ``blocking_key_value_get`` / ``key_value_try_get``)::

    server = NativeKVServer().start()          # on rank 0
    ch = HostP2P(rank, size, client=NativeKVClient("host0", server.port))

A timed-out get raises an error naming DEADLINE, as the coordination
client's does, so HostP2P's ABORT semantics hold on either transport.
"""

from __future__ import annotations

import datetime
import threading
from typing import Optional

from raft_tpu_torch.core.error import expects

__all__ = ["NativeKVClient", "NativeKVServer"]

# the process-global broker: (store, port), one per process
_BROKER = None
_BROKER_LOCK = threading.Lock()
_CONNECT_TIMEOUT_S = 30.0


def _store(host: str, port: int, is_master: bool):
    from torch.distributed import TCPStore
    return TCPStore(host, int(port), is_master=is_master,
                    wait_for_workers=False,
                    timeout=datetime.timedelta(seconds=_CONNECT_TIMEOUT_S))


class NativeKVServer:
    """Process-global TCP broker (one per process; rank 0 hosts).

    If a broker already runs in this process, :meth:`start` adopts it
    (same port) without taking ownership: only the instance that created
    it stops it.
    """

    def __init__(self, port: int = 0):
        self._want_port = port
        self.port: Optional[int] = None
        self.owner = False

    def start(self) -> "NativeKVServer":
        global _BROKER
        with _BROKER_LOCK:
            if _BROKER is None:
                st = _store("127.0.0.1", self._want_port, True)
                expects(st.port > 0, "native kv broker failed to bind")
                _BROKER = (st, int(st.port))
                self.owner = True
            else:
                self.owner = False
            self.port = _BROKER[1]
        return self

    def stop(self) -> None:
        global _BROKER
        with _BROKER_LOCK:
            if self.owner:
                _BROKER = None
        self.port = None
        self.owner = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class NativeKVClient:
    """Store-client-shaped facade over the broker.

    ``max_len`` caps message size on both sides (a get consumes the
    value, so an oversized receive would destroy the message): oversized
    sends are rejected at the sender.
    """

    def __init__(self, host: str, port: int, max_len: int = 1 << 22):
        self.host = host
        self.port = int(port)
        self.max_len = int(max_len)
        self._st = None
        self._lock = threading.Lock()

    def _conn(self):
        with self._lock:
            if self._st is None:
                self._st = _store(self.host, self.port, False)
            return self._st

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = True) -> None:
        del allow_overwrite  # a put always overwrites
        payload = value.encode("latin-1")
        if len(payload) > self.max_len:
            raise ValueError(
                f"native kv put: payload {len(payload)} B exceeds the "
                f"transport cap {self.max_len} B (raise max_len on both "
                "ends to send larger messages)")
        try:
            self._conn().set(key, payload)
        except Exception as e:
            raise OSError(f"native kv put to {self.host}:{self.port} "
                          f"failed: {e}") from e

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        """The value of ``key`` once it is set, consumed (deleted);
        DEADLINE_EXCEEDED after ``timeout_ms``."""
        st = self._conn()
        try:
            st.wait([key], datetime.timedelta(milliseconds=max(1,
                                                               timeout_ms)))
        except Exception as e:
            if "timeout" not in str(e).lower():
                raise
            raise TimeoutError(f"DEADLINE_EXCEEDED: native kv get({key!r}, "
                               f"{timeout_ms}ms)") from None
        out = st.get(key)
        st.delete_key(key)
        if len(out) > self.max_len:
            raise ValueError(f"native kv get: {len(out)} B exceeds the cap "
                             f"{self.max_len} B")
        return out.decode("latin-1")

    def key_value_try_get(self, key: str) -> Optional[str]:
        """The value of ``key`` if set (not consumed), else None."""
        st = self._conn()
        if not st.check([key]):
            return None
        return st.get(key).decode("latin-1")

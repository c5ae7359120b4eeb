"""RemoteReplica: a fleet member in another OS process (counterpart of
``raft_tpu.fleet.remote``).

:class:`~raft_tpu_torch.fleet.replica.Replica` duck-types its server's
``submit``, ``search``, ``load``, ``drain`` and ``close``. This module
supplies that surface over the wire
(:class:`~raft_tpu_torch.fleet.transport.TransportClient`), so the
router and ``rolling_restart`` front a process unchanged:

* :class:`RemoteSearchClient` — the ``SearchServer`` twin. ``submit``
  returns a ``Future`` (a small pool runs the RPC); typed errors come
  back as the same ``RejectedError``/``DeadlineExceeded``/
  ``DispatchError`` classes. ``load()`` snapshots ride every RPC answer
  and decay with age; an idle client asks ``GET /rpc/load`` only when
  its snapshot is stale.
* :class:`RemoteReplica` — a :class:`Replica` around one: the whole
  lifecycle (gauges, transitions, the black-box pointer of
  ``set_blackbox``, ``describe()``) is inherited, the URL added.
* :func:`bootstrap_from_url` — the remote twin of
  :func:`~raft_tpu_torch.fleet.replication.bootstrap_replica`: the
  primary's checkpoint over ``GET /rpc/checkpoint`` (with its sidecar)
  onto ``device``, then the log over ``GET /rpc/wal/tail``.

Decay: a snapshot ``age`` seconds old has its queue terms scaled by
``0.5 ** (age / halflife)`` (the queue it described has most likely
drained); ``closed`` and ``draining`` never decay.

Local rows: the snapshot says what the peer held when it last
answered; the rows this client has handed to it and not had back are
known here for certain. Rows waiting for a pool worker add to
``queued_rows``, and rows on the wire are a floor under
``inflight_rows``, so a peer that stops answering (SIGKILLed, or busy
with a promotion's fold) grows heavier with every request routed to it
instead of looking idle while its snapshot decays.

Load probes are coalesced: while one ``GET /rpc/load`` is on the wire,
other callers take the stale snapshot, or, with none, wait for that
probe's answer, so a router's many threads never hold more than one of
the peer's handler threads with probes.

Timeouts: a search RPC waits no longer than its deadline (plus
``_DEADLINE_SLACK_S``) or the client's ``timeout_s``, whichever is
shorter. A peer that let a search RPC time out is taken for down for
one ``refresh_s``: ``load()`` and ``search()`` raise at once, so the
router routes around it and the calls queued behind the one that timed
out retry elsewhere instead of each waiting out a timeout of its own (a
SIGKILLed process on the card keeps its sockets open until its device
context is torn down). A peer that let a load probe time out, or closed
a connection on a request without answering it (killed under the
request, or saturated: the daemon's server drops a connection it has no
handler thread for), is taken for down for routing only: ``load()``
raises at once for one ``refresh_s``, while the searches already queued
for it still go to the wire. A refused connection marks nothing. Each
of these drops the load snapshot: the next ``load()`` asks the peer
instead of reporting the queue of its last answer (a dead peer's looks
idle).

Arrays cross the wire as JSON lists and come back as host numpy arrays.
"""

from __future__ import annotations

import http.client
import threading
import time
import urllib.error
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.fleet.replica import Replica, ReplicaState
from raft_tpu_torch.fleet.replication import WalApplier, _replay
from raft_tpu_torch.fleet.transport import RemoteWalReader, TransportClient
from raft_tpu_torch.obs import spans

__all__ = ["RemoteSearchClient", "RemoteReplica", "bootstrap_from_url"]

# seconds a search RPC may run past its deadline: the daemon's own
# deadline check, its JSON answer and the wire
_DEADLINE_SLACK_S = 1.0


def _timed_out(exc: BaseException) -> bool:
    """Whether ``exc`` (or an exception it was raised from) is a socket
    timeout: urllib raises a read timeout as it is and wraps a connect
    timeout in ``URLError``."""
    while exc is not None:
        if isinstance(exc, TimeoutError) or (
                isinstance(exc, urllib.error.URLError)
                and isinstance(exc.reason, TimeoutError)):
            return True
        exc = exc.__cause__
    return False


def _connection_failure(exc: BaseException) -> Optional[str]:
    """``"refused"`` when nothing took the connection, ``"cut"`` when the
    peer closed it on a request without answering (reset, closed before
    the status line, cut mid-body), else None; ``exc`` or an exception it
    was raised from."""
    while exc is not None:
        if isinstance(exc, urllib.error.URLError) and \
                isinstance(exc.reason, BaseException):
            exc = exc.reason
            continue
        if isinstance(exc, ConnectionRefusedError):
            return "refused"
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            http.client.IncompleteRead)):
            return "cut"
        exc = exc.__cause__
    return None


def _n_rows(queries) -> int:
    """Query rows in one request (a 1-d query is one row)."""
    shape = getattr(queries, "shape", None)
    if shape is None:
        shape = np.shape(queries)
    return int(shape[0]) if len(shape) >= 2 else 1


class RemoteSearchClient:
    """A ``SearchServer`` duck-type over one replica daemon's port.

    submit and search run on router threads and the small internal pool;
    the cached load snapshot is the only shared mutable state (the GL003
    contract below). The :class:`TransportClient` is stateless."""

    # static race contract (tools/graftlint GL003): pool threads and the
    # router's load probes meet on the snapshot cache
    GUARDED_BY = ("_snap", "_snap_ts", "_closed", "_draining",
                  "_down_until", "_cut_until", "_cut_why", "_probe",
                  "_waiting_rows", "_wire_rows")

    def __init__(self, url: str, name: str = "remote",
                 timeout_s: float = 30.0, refresh_s: float = 3.0,
                 load_halflife_s: float = 5.0, pool_workers: int = 4,
                 stop_remote_on_close: bool = False,
                 client: Optional[TransportClient] = None):
        self.name = str(name)
        self.client = client if client is not None \
            else TransportClient(url, timeout_s=timeout_s)
        self.url = self.client.url
        self._refresh_s = float(refresh_s)
        self._halflife_s = max(1e-3, float(load_halflife_s))
        self._stop_remote_on_close = bool(stop_remote_on_close)
        self._lock = threading.Lock()
        self._snap: Optional[dict] = None
        self._snap_ts = 0.0          # monotonic stamp of _snap
        self._closed = False
        self._draining = False
        self._down_until = 0.0       # monotonic end of the down mark
        self._cut_until = 0.0        # ... of the routing-only mark
        self._cut_why = "was cut off"
        self._probe: Optional[Future] = None   # the load probe in flight
        self._waiting_rows = 0       # handed to the pool, not yet sent
        self._wire_rows = 0          # in a search RPC on the wire
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(pool_workers)),
            thread_name_prefix=f"raft-fleet-rpc-{self.name}")

    # -- the piggyback ------------------------------------------------------
    def _note_load(self, body: dict) -> None:
        """Keep the load snapshot an RPC answer carries."""
        snap = body.get("load") if isinstance(body, dict) else None
        if isinstance(snap, dict) and "queued_rows" in snap:
            with self._lock:
                self._snap = snap
                self._snap_ts = time.monotonic()

    def _check_up(self, route: str, cut_off_too: bool = False) -> None:
        """Raise ``DispatchError`` while the peer counts as down: an RPC
        to it timed out within the last ``refresh_s`` or, with
        ``cut_off_too``, one was cut off."""
        with self._lock:
            now = time.monotonic()
            why = ("timed out" if now < self._down_until else
                   self._cut_why if cut_off_too and now < self._cut_until
                   else None)
        if why is not None:
            from raft_tpu_torch.serve.types import DispatchError
            raise DispatchError(
                f"remote {self.name}: {route} skipped, an rpc to "
                f"{self.url} {why} within {self._refresh_s:g}s")

    def _note_failure(self, exc: BaseException,
                      probe: bool = False) -> None:
        """A failed RPC: a search that timed out marks the peer down, a
        load ``probe`` that timed out or a cut-off connection marks it
        down for routing; any of these, or a refused connection, drops
        the load snapshot."""
        until = time.monotonic() + self._refresh_s
        timed_out, lost = _timed_out(exc), _connection_failure(exc)
        if not timed_out and lost is None:
            return
        with self._lock:
            self._snap = None
            if timed_out and not probe:
                self._down_until = until
            elif timed_out or lost == "cut":
                self._cut_until = until
                self._cut_why = ("let a load probe time out" if timed_out
                                 else "was cut off")

    # -- SearchServer surface ----------------------------------------------
    def submit(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Async search → ``Future`` of ``(distances, ids)`` or the
        wire's typed error. The caller's traceparent is taken here, on
        the submitting thread (inside the router's route span), so the
        daemon's spans join the caller's trace."""
        trace_ctx = obs.current_traceparent()
        rows = _n_rows(queries)
        with self._lock:
            if self._closed:
                from raft_tpu_torch.serve.types import DispatchError
                raise DispatchError(
                    f"remote {self.name}: client closed")
            pool = self._pool
            self._waiting_rows += rows
        try:
            return pool.submit(self._pooled_search, rows, queries, k,
                               deadline_ms, trace_ctx)
        except BaseException:
            with self._lock:
                self._waiting_rows -= rows
            raise

    def _pooled_search(self, rows: int, queries, k, deadline_ms,
                       trace_context):
        """A pool worker's search: its rows leave the local queue."""
        with self._lock:
            self._waiting_rows -= rows
        return self.search(queries, k=k, deadline_ms=deadline_ms,
                           trace_context=trace_context)

    def search(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               trace_context: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One blocking search RPC → host ``(distances, ids)``; a non-200
        raises the typed error a local ``SearchServer`` would have."""
        if trace_context is None:
            trace_context = obs.current_traceparent()
        self._check_up("search")
        timeout = self.client.timeout_s
        if deadline_ms is not None and deadline_ms > 0:
            timeout = min(timeout, deadline_ms / 1e3 + _DEADLINE_SLACK_S)
        rows = _n_rows(queries)
        with self._lock:
            self._wire_rows += rows
        try:
            status, body = self.client.search_raw(
                queries, k=k, deadline_ms=deadline_ms,
                trace_context=trace_context, timeout=timeout)
        except Exception as e:
            self._note_failure(e)
            raise
        finally:
            with self._lock:
                self._wire_rows -= rows
        self._note_load(body)
        if status != 200:
            raise self.client._typed(status, body, "search")
        return (np.asarray(body["distances"], np.float32),
                np.asarray(body["ids"], np.int32))

    def load(self) -> dict:
        """The batcher-shaped load snapshot: the cached one while fresh,
        decayed as it ages, fetched over the wire when stale. Raises on
        an unreachable idle replica (``Replica.load()`` turns that into
        +inf)."""
        with self._lock:
            if self._closed:
                return {"queued_rows": 0, "inflight_rows": 0,
                        "shed_rate": 0.0, "closed": True,
                        "draining": False}
            snap, ts = self._snap, self._snap_ts
            draining = self._draining
        age = (time.monotonic() - ts) if snap is not None else None
        if snap is None or age > self._refresh_s:
            self._check_up("load probe", cut_off_too=True)
            fresh = self._probe_load(snap is None)
            if fresh is not None:
                snap, age = fresh, 0.0
        with self._lock:
            waiting, wire = self._waiting_rows, self._wire_rows
        decay = 0.5 ** (age / self._halflife_s)
        out = dict(snap)
        out["queued_rows"] = \
            float(snap.get("queued_rows", 0)) * decay + waiting
        out["inflight_rows"] = max(
            float(snap.get("inflight_rows", 0)) * decay, float(wire))
        out["shed_rate"] = float(snap.get("shed_rate", 0.0)) * decay
        out["remote"] = True
        out["load_age_s"] = round(age, 3)
        if draining:
            out["draining"] = True
        return out

    def _probe_load(self, need: bool) -> Optional[dict]:
        """``GET /rpc/load``, one at a time → the peer's snapshot. A
        caller that finds a probe in flight returns None (keep the stale
        snapshot), or, when it has none (``need``), waits for that
        probe's answer or error. Raises when the probe fails."""
        with self._lock:
            probe = self._probe
            mine = probe is None
            if mine:
                probe = self._probe = Future()
        if not mine:
            return probe.result() if need else None
        try:
            snap = self.client.load(timeout=5.0)   # raises when dead
        except Exception as e:
            self._note_failure(e, probe=True)
            probe.set_exception(e)
            raise
        finally:
            with self._lock:
                self._probe = None
        self._note_load({"load": snap})
        probe.set_result(snap)
        return snap

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Drain the REMOTE batcher. False when the daemon is unreachable
        or counts as down (a dead process holds no queue; the caller's
        stop() goes on)."""
        with self._lock:
            self._draining = True
        try:
            self._check_up("drain")
            return self.client.drain(timeout_s=timeout_s)
        except Exception:
            get_logger("fleet").warning(
                "remote %s: drain rpc failed — treating as drained "
                "(process gone takes its queue with it)", self.name)
            return False

    def close(self) -> None:
        """Release the pool; with ``stop_remote_on_close`` also ask the
        daemon to exit. Idempotent, never raises (it runs on the
        kill()/stop() paths)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._stop_remote_on_close:
            try:
                self.client.stop(timeout=5.0)
            except Exception:   # graftlint: disable=GL006
                # the process may be gone already, which is what close
                # wants (justified swallow)
                pass
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "RemoteSearchClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RemoteReplica(Replica):
    """A :class:`Replica` whose server lives in another process; the
    lifecycle and routing surface is inherited, the URL added."""

    def __init__(self, name: str, url: str,
                 state: Optional[ReplicaState] = None,
                 server: Optional[RemoteSearchClient] = None, **kw):
        expects(bool(url), "RemoteReplica: url must be non-empty")
        srv = server if server is not None \
            else RemoteSearchClient(url, name=name, **kw)
        self.url = srv.url
        super().__init__(name, server=srv, state=state)

    @property
    def rpc(self) -> TransportClient:
        """The raw transport client of the current server (the control
        verbs: promote, retarget, upsert, delete)."""
        srv = self.server
        expects(srv is not None,
                "RemoteReplica %s: no server attached", self.name)
        return srv.client

    def describe(self) -> dict:
        body = super().describe()
        body["url"] = self.url
        return body


def bootstrap_from_url(url: str, k: int, cache_dir: str,
                       base_index=None, params=None, config=None,
                       name: str = "follower",
                       client: Optional[TransportClient] = None,
                       device="cuda"
                       ) -> Tuple[object, RemoteWalReader, WalApplier]:
    """Bootstrap a follower ``MutableIndex`` from a REMOTE primary:
    ``GET /rpc/checkpoint`` → a cached file → ``serialize.load`` onto
    ``device`` (default ``cuda``; ``base_index`` when the primary never
    folded), then ``GET /rpc/wal/tail`` to the tip. Returns ``(mindex,
    reader, applier)`` as :func:`~raft_tpu_torch.fleet.replication.
    bootstrap_replica` does, with the same ``raft.fleet.bootstrap.*``
    accounting and the same handling of the fold window (the sidecar
    arrives with the checkpoint)."""
    import os

    from raft_tpu_torch.mutate import MutableIndex
    from raft_tpu_torch.mutate.mutable import _load_checkpoint
    cli = client if client is not None else TransportClient(url)
    os.makedirs(cache_dir, exist_ok=True)
    ckpt_cache = os.path.join(cache_dir, f"{name}.ckpt.npz")
    with obs.timed("raft.fleet.bootstrap"), \
            spans.span("raft.fleet.bootstrap", replica=name,
                       url=cli.url) as sp:
        ckpt_meta = None
        if cli.fetch_checkpoint(ckpt_cache):
            inner, ckpt_meta = _load_checkpoint(ckpt_cache, device)
            sp.set_attr("source", "checkpoint")
        else:
            inner = base_index
            sp.set_attr("source", "base_index")
        expects(inner is not None,
                "fleet.bootstrap_from_url: primary %r has no "
                "checkpoint and no base_index was given — a replica "
                "needs the index the WAL was started against", cli.url)
        m = MutableIndex(inner, k=int(k), params=params, config=config)
        reader = RemoteWalReader(cli)
        applier = WalApplier(m)

        def batches():
            # to the tip (an empty batch): the primary may be appending;
            # the Replicator keeps the follower fresh after this returns
            while True:
                recs = reader.tail()
                if not recs:
                    return
                yield recs

        _replay(applier, batches(), ckpt_meta)
        sp.set_attr("replayed", applier.applied_records)
        sp.set_attr("seq", applier.applied_seq)
    obs.counter("raft.fleet.bootstrap.total").inc()
    obs.gauge("raft.fleet.replication.lag_records", replica=name).set(0)
    return m, reader, applier

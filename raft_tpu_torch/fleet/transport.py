"""The fleet's wire: one replica process behind stdlib HTTP and JSON
(counterpart of ``raft_tpu.fleet.transport``; the same routes, bodies,
status codes and headers, so either package's client talks to either
package's daemon).

The server here IS a :class:`~raft_tpu_torch.obs.endpoint.DebugServer`
subclass, so every daemon also serves ``/metrics``, ``/healthz`` and the
``/debug/*`` routes on the same port. Three rules:

* **typed errors survive the wire** — ``POST /rpc/search`` maps
  admission, deadline and dispatch failures to 429, 504 and 503, and
  :class:`TransportClient` maps them back to
  :class:`~raft_tpu_torch.serve.RejectedError`,
  :class:`~raft_tpu_torch.serve.DeadlineExceeded` and
  :class:`~raft_tpu_torch.serve.DispatchError`, so the router's suspect,
  retry and shed rules hold for a remote replica. The deadline travels
  in the request body: the remote batcher enforces it.
* **the log is the wire format** — ``GET /rpc/wal/tail?from_seq=``
  streams the WAL's records in their on-disk framing
  (:func:`raft_tpu_torch.mutate.wal.read_raw`; CRCs travel as written).
  A follower behind a checkpoint rewrite gets 410 with the
  :class:`~raft_tpu_torch.mutate.wal.WalGapError` fields.
* **bootstrap without a pause** — ``GET /rpc/checkpoint`` serves the
  fold checkpoint's bytes. Where the checkpoint's sidecar (its fold's
  counters, ``<checkpoint>.meta``) belongs to the file sent, its JSON
  rides the ``X-Raft-Checkpoint-Meta`` response header, and
  :meth:`TransportClient.fetch_checkpoint` writes it beside the
  download, so a follower that bootstraps between the checkpoint's
  promotion and the log's rewrite skips the folded records. The body is
  the file's bytes either way.

Every JSON answer carries the replica's ``load()`` snapshot (the
``load`` key), which :class:`raft_tpu_torch.fleet.remote.
RemoteSearchClient` keeps as its routing signal.

Routes::

    POST /rpc/search      {queries, k?, deadline_ms?} -> {distances,
                          ids, partial, load, trace_id}   429/504/503
    GET  /rpc/wal/tail    ?from_seq=N&max_records=M -> WAL bytes
                          (application/octet-stream)  410 = gap
    GET  /rpc/checkpoint  -> checkpoint bytes             404 = none yet
    GET  /rpc/state       -> {name, role, state, wal_next_seq, ...}
    GET  /rpc/load        -> {load}
    POST /rpc/drain       {timeout_s?} -> {drained}
    POST /rpc/stop        -> {stopping}
    POST /rpc/promote     -> {primary, next_seq, epoch}
    POST /rpc/retarget    {primary_url} -> {retargeted}
    POST /rpc/upsert      {rows, ids?} -> {ids}
    POST /rpc/delete      {ids} -> {deleted}

The control verbs go to a duck-typed ``control`` object the daemon
installs (:mod:`raft_tpu_torch.fleet.fleetd`); without one only the
data routes answer. Binds loopback by default.
"""

from __future__ import annotations

import http.client
import json
import os
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.mutate.wal import (WalGapError, WalRecord,
                                       decode_stream, read_raw)
from raft_tpu_torch.obs.endpoint import DebugServer, _Handler
from raft_tpu_torch.util.host import host_array

__all__ = ["ReplicaTransport", "TransportClient", "RemoteWalReader",
           "serve_replica"]

# the checkpoint's sidecar (its fold's counters) beside its bytes
_CKPT_META_HEADER = "X-Raft-Checkpoint-Meta"


def _typed_search_errors():
    # lazy: raft_tpu_torch.serve imports raft_tpu_torch.obs, and the
    # handler runs on server threads, as obs.endpoint's does
    from raft_tpu_torch.serve.types import (DeadlineExceeded,
                                            DispatchError, RejectedError)
    return RejectedError, DeadlineExceeded, DispatchError


class _RpcHandler(_Handler):
    """The debug endpoint's handler plus the ``/rpc/*`` routes."""

    server: "ReplicaTransport"

    # -- shared helpers ----------------------------------------------------
    def _load_snapshot(self) -> Optional[dict]:
        srv = getattr(self.server, "searcher", None)
        if srv is None:
            return None
        try:
            return srv.load()
        except Exception:   # graftlint: disable=GL006
            # the piggyback is opportunistic: a server being torn down
            # must not turn a valid answer into a 500 (justified swallow:
            # the caller reads a missing load key as "no refresh")
            return None

    def _rpc_json(self, code: int, obj: dict) -> None:
        """A JSON answer with the load piggyback: every answer, success
        or typed error, refreshes the caller's routing signal."""
        snap = self._load_snapshot()
        if snap is not None and "load" not in obj:
            obj = dict(obj, load=snap)
        self._send_json(code, obj)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b""
        return json.loads(raw or b"{}")

    # -- routing -----------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        url = urlparse(self.path)
        path = url.path.rstrip("/") or "/"
        if not path.startswith("/rpc/"):
            super().do_GET()
            return
        q = parse_qs(url.query)
        obs.counter("raft.fleet.rpc.requests.total",
                    route=path).inc()
        try:
            if path == "/rpc/state":
                self._rpc_state()
            elif path == "/rpc/load":
                self._rpc_json(200, {})
            elif path == "/rpc/wal/tail":
                self._rpc_wal_tail(q)
            elif path == "/rpc/checkpoint":
                self._rpc_checkpoint()
            else:
                self._send_json(404, {"error": f"no route {path!r}"})
        except BrokenPipeError:   # graftlint: disable=GL006
            # the caller hung up: nobody is left to answer (justified)
            pass

    def do_POST(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        path = urlparse(self.path).path.rstrip("/") or "/"
        if not path.startswith("/rpc/"):
            super().do_POST()
            return
        obs.counter("raft.fleet.rpc.requests.total",
                    route=path).inc()
        try:
            if path == "/rpc/search":
                self._rpc_search()
            elif path in ("/rpc/drain", "/rpc/stop", "/rpc/promote",
                          "/rpc/retarget", "/rpc/upsert", "/rpc/delete"):
                self._rpc_control(path[len("/rpc/"):])
            else:
                self._send_json(404, {"error": f"no POST route "
                                               f"{path!r}"})
        except BrokenPipeError:   # graftlint: disable=GL006
            # the caller hung up: nobody is left to answer (justified)
            pass

    # -- data plane --------------------------------------------------------
    def _rpc_search(self) -> None:
        """``POST /rpc/search``: the remote twin of
        ``SearchServer.search``. The deadline rides the body, typed
        errors the status code, the load snapshot every answer."""
        RejectedError, DeadlineExceeded, _ = _typed_search_errors()
        srv = getattr(self.server, "searcher", None)
        if srv is None:
            self._err("/rpc/search", "no_searcher")
            self._send_json(404, {"error": "dispatch",
                                  "detail": "no searcher attached"})
            return
        try:
            body = self._read_body()
            queries = np.asarray(body["queries"], np.float32)
            k = body.get("k")
            deadline_ms = body.get("deadline_ms")
        except (ValueError, KeyError, TypeError) as e:
            self._err("/rpc/search", "bad_request")
            self._send_json(400, {"error": "bad_request",
                                  "detail": repr(e)})
            return
        from raft_tpu_torch.obs import spans as _spans
        incoming = self.headers.get("traceparent")
        trace_id = None
        try:
            # propagation in: the router's route span parents this
            # daemon's whole request
            with _spans.span("raft.fleet.rpc", remote_parent=incoming,
                             route="/rpc/search") as sp:
                trace_id = sp.trace_id or None
                d, i = srv.search(queries, k=k,
                                  deadline_ms=deadline_ms)
        except RejectedError as e:
            self._err("/rpc/search", "rejected")
            self._rpc_json(429, {"error": "rejected",
                                 "detail": str(e),
                                 "trace_id": trace_id})
            return
        except DeadlineExceeded as e:
            self._err("/rpc/search", "deadline")
            self._rpc_json(504, {"error": "deadline", "detail": str(e),
                                 "trace_id": trace_id})
            return
        except Exception as e:
            # any other failure is dispatch-class: the caller's router
            # marks this replica suspect and retries elsewhere
            self._err("/rpc/search", type(e).__name__)
            self._rpc_json(503, {"error": "dispatch",
                                 "detail": f"{type(e).__name__}: "
                                           f"{str(e)[:500]}",
                                 "trace_id": trace_id})
            return
        self._rpc_json(200, {
            "distances": host_array(d, np.float32).tolist(),
            "ids": host_array(i, np.int64).tolist(),
            "partial": bool(getattr(d, "partial", False)
                            or getattr(i, "partial", False)),
            "trace_id": trace_id})

    def _rpc_wal_tail(self, q: dict) -> None:
        """``GET /rpc/wal/tail?from_seq=N``: the raw log slice in its
        on-disk framing; 410 carries the typed gap."""
        wal_path = getattr(self.server, "wal_path", None)
        if not wal_path:
            self._err("/rpc/wal/tail", "no_wal")
            self._send_json(404, {"error": "no_wal",
                                  "detail": "this replica serves no "
                                            "mutation log"})
            return
        try:
            from_seq = int(q.get("from_seq", ["0"])[0])
            max_records = int(q.get("max_records", ["0"])[0])
        except ValueError:
            self._send_json(400, {"error": "bad_request",
                                  "detail": "from_seq/max_records must "
                                            "be integers"})
            return
        try:
            buf, n, last = read_raw(wal_path, from_seq=from_seq,
                                    max_records=max_records)
        except WalGapError as e:
            self._err("/rpc/wal/tail", "gap")
            self._send_json(410, {"error": "gap",
                                  "last_seq": e.last_seq,
                                  "first_seq": e.first_seq})
            return
        except OSError as e:
            self._err("/rpc/wal/tail", "io")
            self._send_json(503, {"error": "dispatch",
                                  "detail": repr(e)})
            return
        obs.counter("raft.fleet.rpc.wal.records.total").inc(n)
        obs.counter("raft.fleet.rpc.wal.bytes.total").inc(len(buf))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(buf)))
        self.send_header("X-Raft-Wal-Records", str(n))
        self.send_header("X-Raft-Wal-Last-Seq", str(last))
        self.end_headers()
        self.wfile.write(buf)

    def _rpc_checkpoint(self) -> None:
        """``GET /rpc/checkpoint``: the fold checkpoint's bytes, with its
        sidecar in :data:`_CKPT_META_HEADER` when the sidecar belongs to
        the file read (the identity of the open file, so a fold promoting
        the next checkpoint meanwhile cannot pair the two wrongly)."""
        from raft_tpu_torch.mutate.mutable import _read_checkpoint_meta
        ckpt = getattr(self.server, "checkpoint_path", None)
        if not ckpt or not os.path.exists(ckpt):
            self._err("/rpc/checkpoint", "no_checkpoint")
            self._send_json(404, {"error": "no_checkpoint",
                                  "detail": "no compaction checkpoint "
                                            "on disk yet"})
            return
        try:
            with open(ckpt, "rb") as f:
                st = os.fstat(f.fileno())
                body = f.read()
            meta = _read_checkpoint_meta(
                ckpt, [int(st.st_size), int(st.st_mtime_ns)])
        except (OSError, ValueError) as e:
            self._err("/rpc/checkpoint", "io")
            self._send_json(503, {"error": "dispatch",
                                  "detail": repr(e)})
            return
        obs.counter("raft.fleet.rpc.checkpoint.bytes.total"
                    ).inc(len(body))
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        if meta is not None:
            self.send_header(_CKPT_META_HEADER, json.dumps(
                meta, sort_keys=True, separators=(",", ":")))
        self.end_headers()
        self.wfile.write(body)

    # -- control plane -----------------------------------------------------
    def _rpc_state(self) -> None:
        ctl = getattr(self.server, "control", None)
        if ctl is not None:
            try:
                self._rpc_json(200, dict(ctl.state()))
                return
            except Exception as e:
                self._err("/rpc/state", type(e).__name__)
                self._send_json(503, {"error": "dispatch",
                                      "detail": repr(e)})
                return
        srv = getattr(self.server, "searcher", None)
        self._rpc_json(200, {
            "state": "serving" if srv is not None else "down"})

    def _rpc_control(self, verb: str) -> None:
        """A control verb on the daemon's control object: 404 without
        one, 409 when the daemon refuses the transition (promoting a
        primary, a write to a follower)."""
        ctl = getattr(self.server, "control", None)
        fn = getattr(ctl, verb, None)
        if fn is None:
            self._err(f"/rpc/{verb}", "no_control")
            self._send_json(404, {"error": "no_control",
                                  "detail": f"this replica exposes no "
                                            f"{verb!r} control"})
            return
        try:
            body = self._read_body()
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": "bad_request",
                                  "detail": repr(e)})
            return
        try:
            out = fn(**body) if body else fn()
        except (ValueError, TypeError) as e:
            self._err(f"/rpc/{verb}", "refused")
            self._send_json(409, {"error": "refused",
                                  "detail": str(e)[:500]})
            return
        except Exception as e:
            self._err(f"/rpc/{verb}", type(e).__name__)
            self._send_json(503, {"error": "dispatch",
                                  "detail": f"{type(e).__name__}: "
                                            f"{str(e)[:500]}"})
            return
        self._rpc_json(200, dict(out or {}))

    def _err(self, route: str, kind: str) -> None:
        obs.counter("raft.fleet.rpc.errors.total", route=route,
                    error=kind).inc()


# handler threads of a replica daemon's server, unless the caller sets
# max_threads. Each router holds at most its pool's searches on one
# daemon, and load probes (one per router), replication tails, control
# verbs, scrapes and /rpc/state reads come on top. A connection past the
# bound is dropped, which a router sees as a failed search, so the bound
# sits well above that traffic (the debug endpoint's default of 8 is for
# a process that only operators read).
RPC_HANDLER_THREADS = 64


class ReplicaTransport(DebugServer):
    """One replica daemon's HTTP server: the whole debug endpoint
    (``/metrics``, ``/healthz``, ``/debug/*``, inherited) plus the
    ``/rpc/*`` routes. Made by :func:`serve_replica`."""

    def __init__(self, addr, searcher=None, wal_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None, control=None,
                 **kw):
        if kw.get("max_threads") is None:
            kw["max_threads"] = RPC_HANDLER_THREADS
        super().__init__(addr, searcher=searcher, **kw)
        # the parent pins _Handler: swap in the rpc-aware one
        self.RequestHandlerClass = _RpcHandler
        # the handler threads only read these (a promotion sets wal_path
        # once, before the daemon reports itself primary)
        self.wal_path = wal_path
        self.checkpoint_path = checkpoint_path
        self.control = control


def serve_replica(host: str = "127.0.0.1", port: int = 0, searcher=None,
                  wal_path: Optional[str] = None,
                  checkpoint_path: Optional[str] = None, control=None,
                  **kw) -> ReplicaTransport:
    """Start a replica transport in a daemon thread → the running
    :class:`ReplicaTransport` (``.url``, ``.port``, ``.close()``).
    ``port=0`` binds an ephemeral port (a daemon writes it to its port
    file for the spawner)."""
    return ReplicaTransport((host, port), searcher=searcher,
                            wal_path=wal_path,
                            checkpoint_path=checkpoint_path,
                            control=control, **kw).start()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


class TransportClient:
    """A typed HTTP client of one replica daemon. Stateless (every
    method builds its own request), so the dispatch pool, a replicator
    thread and an operator may share one.

    The errors back off the wire: 429 → ``RejectedError``, 504 →
    ``DeadlineExceeded``, 410 → :class:`~raft_tpu_torch.mutate.wal.
    WalGapError`; anything else (a refused connection among them: a
    SIGKILLed process) → ``DispatchError`` on the data and control
    routes, ``OSError`` on the replication routes (a replicator keeps
    polling through those)."""

    def __init__(self, url: str, timeout_s: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)

    # -- low-level ---------------------------------------------------------
    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 headers: Optional[dict] = None,
                 timeout: Optional[float] = None
                 ) -> Tuple[int, dict, bytes, dict]:
        """→ (status, the JSON body or {}, raw bytes, response headers).
        Network failures raise ``OSError`` (urllib's URLError is one, and
        an answer cut off by a dying peer is turned into one); HTTP error
        statuses are returned, for the caller to map."""
        data = None
        hdrs = dict(headers or {})
        if body is not None:
            data = json.dumps(body).encode("utf-8")
            hdrs["Content-Type"] = "application/json"
        req = urllib.request.Request(self.url + path, data=data,
                                     headers=hdrs, method=method)
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout if timeout is not None
                    else self.timeout_s) as resp:
                raw = resp.read()
                rh = dict(resp.headers.items())
                status = resp.status
        except urllib.error.HTTPError as e:
            raw = e.read()
            rh = dict(e.headers.items()) if e.headers else {}
            status = e.code
        except http.client.HTTPException as e:
            # a peer that died mid-answer (a cut body, a bad status line)
            # is a network failure like a refused connection
            raise OSError(f"{method} {path}: {e!r}") from e
        ctype = rh.get("Content-Type", "")
        parsed = {}
        if "json" in ctype:
            try:
                parsed = json.loads(raw or b"{}")
            except ValueError:
                parsed = {}
        return status, parsed, raw, rh

    def _typed(self, status: int, body: dict, route: str):
        """The wire's status → the typed error (search and control)."""
        RejectedError, DeadlineExceeded, DispatchError = \
            _typed_search_errors()
        detail = body.get("detail", "") or body.get("error", "")
        if status == 429:
            return RejectedError(f"rpc {route}: {detail}")
        if status == 504:
            return DeadlineExceeded(f"rpc {route}: {detail}")
        if status == 410:
            return WalGapError(int(body.get("last_seq", 0)),
                               int(body.get("first_seq", 0)))
        return DispatchError(f"rpc {route}: HTTP {status}: {detail}")

    # -- data plane --------------------------------------------------------
    def search_raw(self, queries, k=None, deadline_ms=None,
                   trace_context: Optional[str] = None,
                   timeout: Optional[float] = None
                   ) -> Tuple[int, dict]:
        """One search RPC → ``(status, JSON body)``; a network failure
        raises ``DispatchError`` (a dead process must look to the router
        like a crashed dispatch)."""
        _, _, DispatchError = _typed_search_errors()
        body = {"queries": host_array(queries, np.float32).tolist()}
        if k is not None:
            body["k"] = int(k)
        if deadline_ms is not None:
            body["deadline_ms"] = float(deadline_ms)
        hdrs = {}
        if trace_context:
            hdrs["traceparent"] = trace_context
        try:
            status, parsed, _raw, _rh = self._request(
                "POST", "/rpc/search", body=body, headers=hdrs,
                timeout=timeout)
        except OSError as e:
            raise DispatchError(
                f"rpc search: {self.url} unreachable: {e!r}") from e
        return status, parsed

    def wal_tail(self, from_seq: int, max_records: int = 0,
                 timeout: Optional[float] = None
                 ) -> List[WalRecord]:
        """Tail the remote log → decoded records. 410 raises the typed
        :class:`WalGapError`; any other failure raises ``OSError``
        (transient, to a replicator)."""
        status, parsed, raw, _rh = self._request(
            "GET", f"/rpc/wal/tail?from_seq={int(from_seq)}"
                   f"&max_records={int(max_records)}",
            timeout=timeout)
        if status == 410:
            raise WalGapError(int(parsed.get("last_seq", 0)),
                              int(parsed.get("first_seq", 0)))
        if status != 200:
            raise OSError(f"rpc wal/tail: HTTP {status}: "
                          f"{parsed.get('detail', '')}")
        return decode_stream(raw)

    def fetch_checkpoint(self, dest_path: str,
                         timeout: Optional[float] = None) -> bool:
        """Download the primary's fold checkpoint to ``dest_path`` →
        True; False when there is none yet (a bootstrap then starts from
        the base index). The sidecar the primary sends with it is written
        to ``dest_path + ".meta"``, naming the downloaded file, before the
        download is promoted; without one any old sidecar is removed. A
        network failure raises ``OSError``."""
        from raft_tpu_torch.mutate.mutable import _write_checkpoint_meta
        status, parsed, raw, rh = self._request(
            "GET", "/rpc/checkpoint", timeout=timeout)
        if status == 404:
            return False
        if status != 200:
            raise OSError(f"rpc checkpoint: HTTP {status}: "
                          f"{parsed.get('detail', '')}")
        tmp = dest_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        meta = rh.get(_CKPT_META_HEADER)
        if meta:
            _write_checkpoint_meta(tmp, dest_path, json.loads(meta))
        else:
            try:
                os.remove(dest_path + ".meta")
            except FileNotFoundError:   # graftlint: disable=GL006
                # no old sidecar: what the removal wants (justified)
                pass
        os.replace(tmp, dest_path)
        return True

    # -- control plane -----------------------------------------------------
    def _control(self, verb: str, body: Optional[dict] = None,
                 timeout: Optional[float] = None) -> dict:
        _, _, DispatchError = _typed_search_errors()
        try:
            status, parsed, _raw, _rh = self._request(
                "POST", f"/rpc/{verb}", body=body or {},
                timeout=timeout)
        except OSError as e:
            raise DispatchError(
                f"rpc {verb}: {self.url} unreachable: {e!r}") from e
        if status != 200:
            raise self._typed(status, parsed, verb)
        return parsed

    def state(self, timeout: Optional[float] = None) -> dict:
        _, _, DispatchError = _typed_search_errors()
        try:
            status, parsed, _raw, _rh = self._request(
                "GET", "/rpc/state", timeout=timeout)
        except OSError as e:
            raise DispatchError(
                f"rpc state: {self.url} unreachable: {e!r}") from e
        if status != 200:
            raise self._typed(status, parsed, "state")
        return parsed

    def load(self, timeout: Optional[float] = None) -> dict:
        _, _, DispatchError = _typed_search_errors()
        try:
            status, parsed, _raw, _rh = self._request(
                "GET", "/rpc/load", timeout=timeout)
        except OSError as e:
            raise DispatchError(
                f"rpc load: {self.url} unreachable: {e!r}") from e
        if status != 200 or "load" not in parsed:
            raise DispatchError(f"rpc load: HTTP {status} "
                                f"(no load snapshot)")
        return parsed["load"]

    def drain(self, timeout_s: float = 30.0) -> bool:
        out = self._control("drain", {"timeout_s": float(timeout_s)},
                            timeout=timeout_s + 10.0)
        return bool(out.get("drained"))

    def stop(self, timeout: Optional[float] = None) -> dict:
        return self._control("stop", timeout=timeout)

    def promote(self, timeout: Optional[float] = None) -> dict:
        return self._control("promote", timeout=timeout)

    def retarget(self, primary_url: str,
                 timeout: Optional[float] = None) -> dict:
        return self._control("retarget",
                             {"primary_url": str(primary_url)},
                             timeout=timeout)

    def upsert(self, rows, ids=None,
               timeout: Optional[float] = None) -> List[int]:
        body = {"rows": host_array(rows, np.float32).tolist()}
        if ids is not None:
            body["ids"] = host_array(ids, np.int64).tolist()
        out = self._control("upsert", body, timeout=timeout)
        return [int(v) for v in out.get("ids", [])]

    def delete(self, ids, timeout: Optional[float] = None) -> int:
        out = self._control(
            "delete", {"ids": host_array(ids, np.int64).tolist()},
            timeout=timeout)
        return int(out.get("deleted", 0))


class RemoteWalReader:
    """A :class:`~raft_tpu_torch.mutate.wal.WalReader` over ``GET
    /rpc/wal/tail``: the follower's end of replication over the wire.
    The same ``tail(from_seq, max_records)`` and ``position`` surface,
    the same typed :class:`WalGapError`, ``OSError`` for a transient
    network failure."""

    def __init__(self, client: TransportClient, from_seq: int = 0,
                 batch_records: int = 1024):
        self.client = client
        self.last_seq = int(from_seq)
        self.batch_records = int(batch_records)

    def tail(self, from_seq: Optional[int] = None,
             max_records: int = 0) -> List[WalRecord]:
        if from_seq is not None:
            self.last_seq = int(from_seq)
        recs = self.client.wal_tail(
            self.last_seq,
            max_records=max_records or self.batch_records)
        if recs:
            self.last_seq = int(recs[-1].seq)
        return recs

    def probe_caught_up(self, floor: int) -> bool:
        """A read-only tip probe (the position does not move): the
        replicator's ``caught_up()`` for a remote log."""
        try:
            return not self.client.wal_tail(int(floor), max_records=1,
                                            timeout=5.0)
        except (WalGapError, OSError):
            return False

    @property
    def position(self) -> int:
        return self.last_seq


def wait_healthy(client: TransportClient, timeout_s: float = 120.0,
                 poll_s: float = 0.25,
                 want_states: Tuple[str, ...] = ("serving",)
                 ) -> dict:
    """Poll ``/rpc/state`` until the daemon reports one of
    ``want_states`` → its state body; ``TimeoutError`` with the last
    failure after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    last: object = None
    while time.monotonic() < deadline:
        try:
            st = client.state(timeout=5.0)
            last = st
            if st.get("state") in want_states:
                return st
        except Exception as e:
            last = repr(e)
        time.sleep(poll_s)
    raise TimeoutError(
        f"replica at {client.url} not healthy after {timeout_s:.0f}s "
        f"(last: {last!r})")

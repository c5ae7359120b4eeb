"""The serving debug endpoint: a stdlib HTTP server over the
observability state (counterpart of ``raft_tpu.obs.endpoint``).

``obs.serve()`` starts a daemon-threaded HTTP server (``http.server``,
nothing else) with the routes an operator needs on a serving box:

* ``GET /metrics``: the Prometheus exposition text of the registry.
* ``GET /healthz``: one verdict folded from every plane's gauges: 200
  ``{"status": "ok", ...}``, or 503 ``{"status": "degraded", ...}`` while
  a comms session reports suspect ranks, the server is overloaded or
  serves partial results, a mutable index's delta is stalled or its
  compactor failing, a declared SLO breaches, the card's memory headroom
  is low, or a replica fleet is short of replicas. The quality, tiered,
  profile, history and dist sections ride along as context.
* ``POST /search``: JSON search over an attached
  :class:`raft_tpu_torch.serve.SearchServer` (``obs.serve(searcher=
  srv)``): ``{"queries": [[...], ...], "k": 10, "deadline_ms": 50}`` →
  ``{"distances", "ids", "nq", "k", "trace_id"}``; a malformed body is
  400, a backpressure rejection 429, an expired deadline 504, any other
  failure 500.
* ``GET /debug/requests``: the flight recorder
  (:mod:`raft_tpu_torch.obs.recorder`): the last request traces as JSON.
  ``n=<count>`` limits, ``slow=1`` reads the slow ring, ``trace=<id>``
  selects one trace, ``format=chrome`` renders it (or the most recent)
  as a Chrome trace for Perfetto, and ``trace=<id>&all=1`` returns every
  local fragment of a trace (``{"trace_id", "fragments", "now_unix"}``,
  always 200), the wire format ``recorder.fetch_fragments`` reads.
* ``GET /debug/slo``: the SLO verdict (:mod:`raft_tpu_torch.obs.slo`),
  from the in-process tracker or the exported ``raft.slo.*`` gauges.
* ``GET /debug/fleet``: the replica fleet's report from an attached
  router (``obs.serve(fleet=router)``), else the exported
  ``raft.fleet.*`` gauges, else 404.
* ``GET /debug/profile``: the resource profiler
  (:func:`raft_tpu_torch.obs.profiler.endpoint_body`).
* ``GET /debug/history``: the metrics history
  (:func:`raft_tpu_torch.obs.history.endpoint_body`; 404 while it is
  off).

Trace propagation rides ``POST /search``: an incoming ``traceparent``
header parents the handler's ``raft.serve.http`` span, and through it
the request the server serves; the response carries the request's
``trace_id``.

The fleet aggregator's routes (``/fleet/metrics``, ``/fleet/healthz``,
``/fleet/trace``, and ``/metrics`` and ``/debug/fleet`` merged across the
fleet) read a metrics federator: ``obs.serve(federator=fed)`` stores one,
and with none attached those routes answer 404 as the JAX package's do
(:class:`raft_tpu_torch.obs.federation.MetricsFederator`). A fleet router
(:class:`raft_tpu_torch.fleet.FleetRouter`) behind ``/debug/fleet`` comes
through ``obs.serve(fleet=router)``; each fleet daemon's
:class:`raft_tpu_torch.fleet.ReplicaTransport` is a :class:`DebugServer`
with the ``/rpc/*`` routes added.

Request handling is thread-per-connection (``ThreadingHTTPServer``)
under a bound (``RAFT_TPU_ENDPOINT_THREADS``, default 8): while every
slot is busy a new connection waits 0.5 s for one, then is dropped, so
slow debug fetches never grow the thread count without limit.

Use::

    from raft_tpu_torch import obs
    srv = obs.serve(port=9100, searcher=server)   # port=0: ephemeral
    print(srv.url)                                # http://127.0.0.1:9100
    ...
    srv.close()

The server binds loopback by default: it exposes internals (query
shapes, timings), so front it with real infrastructure before exposing
it beyond the host.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from raft_tpu_torch.obs import recorder as _recorder
from raft_tpu_torch.obs import registry as _registry

__all__ = ["DebugServer", "serve"]

_ROUTES = ["/metrics", "/healthz", "/fleet/metrics", "/fleet/healthz",
           "/fleet/trace", "/debug/requests", "/debug/slo", "/debug/fleet",
           "/debug/profile", "/debug/history"]
_NO_FEDERATOR = {"error": "no federator attached "
                          "(obs.serve(federator=...))"}


def _health_body(snapshot: dict) -> dict:
    """The ``/healthz`` body from a registry snapshot's gauges: the
    verdict and one section per plane that has gauges (module
    docstring)."""
    gauges = snapshot.get("gauges", {})
    suspects = {}
    staleness = {}
    for series, value in gauges.items():
        if series.startswith("raft.comms.health.suspects"):
            suspects[series] = value
        elif series.startswith("raft.comms.health.max_staleness_seconds"):
            staleness[series] = value
    comms_degraded = any(v > 0 for v in suspects.values())

    def _gsum(prefix: str) -> float:
        return sum(v for k, v in gauges.items()
                   if k == prefix or k.startswith(prefix + "{"))

    overloaded = _gsum("raft.serve.overloaded")
    depth = _gsum("raft.serve.queue.depth")
    qmax = _gsum("raft.serve.queue.max")
    shed_rate = _gsum("raft.serve.shed.rate")
    serve_degraded = (overloaded > 0 or shed_rate > 0
                      or (qmax > 0 and depth >= qmax))
    # partial results over a degraded mesh are availability, not health:
    # degraded until recovery clears the exclusion
    failover_engaged = _gsum("raft.serve.failover.engaged")
    serve_degraded = serve_degraded or failover_engaged > 0
    # a delta at its top rung with no fold in flight (or a compactor
    # failing fold after fold) will hit DeltaFullError: degraded before
    # writes start bouncing
    mutate_stalled = _gsum("raft.mutate.delta.stalled")
    compactor_failing = _gsum("raft.mutate.compactor.failing")
    mutate_degraded = mutate_stalled > 0 or compactor_failing > 0
    # a breached declared objective degrades the box by definition
    slo_breaches = {k: v for k, v in gauges.items()
                    if k.split("{")[0] == "raft.slo.breach" and v > 0}
    slo_degraded = bool(slo_breaches)
    body = {
        "status": ("degraded" if (comms_degraded or serve_degraded
                                  or mutate_degraded or slo_degraded)
                   else "ok"),
        "suspects": suspects,
        "max_staleness_seconds": staleness,
    }
    if any(k.split("{")[0].startswith("raft.slo.") for k in gauges):
        body["slo"] = {
            "objectives": _gsum("raft.slo.objectives"),
            "breaches": sorted(slo_breaches),
        }
    # live recall is context; its floor's verdict rides the SLO plane
    quality = {k: v for k, v in gauges.items()
               if k.split("{")[0] == "raft.obs.quality.recall"}
    if quality:
        body["quality"] = {
            "recall": quality,
            "drift": {k: v for k, v in gauges.items()
                      if k.split("{")[0] in ("raft.obs.quality.drift",
                                             "raft.obs.quality.drift"
                                             ".alarm")},
        }
    if any(k.split("{")[0].startswith("raft.mutate.") for k in gauges):
        body["mutate"] = {
            "epoch": _gsum("raft.mutate.epoch"),
            "delta_fill_frac": _gsum("raft.mutate.delta.fill_frac"),
            "delta_rung": _gsum("raft.mutate.delta.rung"),
            "delta_rows": _gsum("raft.mutate.delta.rows"),
            "tombstone_frac": _gsum("raft.mutate.tombstone.frac"),
            "compact_inflight": _gsum("raft.mutate.compact.inflight"),
            "delta_stalled": mutate_stalled,
            "compactor_failing": compactor_failing,
        }
    if any(k.startswith("raft.serve.") for k in gauges):
        body["serve"] = {
            "overloaded": overloaded,
            "queue_depth": depth,
            "queue_max": qmax,
            "shed_rate_per_s": shed_rate,
            "degrade_level": _gsum("raft.serve.degrade.level"),
        }
        if failover_engaged:
            body["serve"]["failover"] = {
                "engaged": failover_engaged,
                "coverage": _gsum("raft.serve.failover.coverage"),
            }
    # device memory below the profiler's headroom fraction: the next
    # allocation (a fold, a cold-list fetch, a bigger batch) may fail
    hbm_low = _gsum("raft.obs.profile.hbm.low_headroom")
    if hbm_low > 0:
        body["status"] = "degraded"
    # the tiered placement is context: its budget follows the same
    # low-headroom signal (a refresh under a smaller budget demotes)
    tiered_gauges = {k.split("{")[0]: v for k, v in gauges.items()
                     if k.startswith("raft.tiered.")}
    if tiered_gauges:
        body["tiered"] = {
            "budget_bytes": tiered_gauges.get(
                "raft.tiered.budget.bytes", 0.0),
            "hot_lists": tiered_gauges.get("raft.tiered.hot.lists",
                                           0.0),
            "hot_bytes": tiered_gauges.get("raft.tiered.hot.bytes",
                                           0.0),
            "hit_rate": tiered_gauges.get("raft.tiered.hit_rate", 0.0),
            "overlap_frac": tiered_gauges.get(
                "raft.tiered.overlap.frac", 0.0),
        }
    duty = {k: v for k, v in gauges.items()
            if k.split("{")[0] == "raft.obs.profile.duty_cycle"}
    if duty or hbm_low:
        # a low duty cycle is context (/debug/profile); only the memory
        # guardrail is a verdict
        body["profile"] = {
            "duty_cycle": duty,
            "hbm_low_headroom": hbm_low,
            "hbm_headroom_frac": {
                k: v for k, v in gauges.items()
                if k.split("{")[0]
                == "raft.obs.profile.hbm.headroom_frac"},
        }
    # an active mean shift says where to look (/debug/history); the
    # plane underneath owns the verdict
    anomalies = sorted(
        k for k, v in gauges.items()
        if k.split("{")[0] == "raft.obs.history.anomaly" and v > 0)
    if anomalies:
        body["history"] = {"anomalies": anomalies}
    # a replica fleet at partial capacity, or with nothing serving, is
    # degraded
    fleet_total = _gsum("raft.fleet.replicas.total")
    if fleet_total:
        fleet_serving = _gsum("raft.fleet.replicas.serving")
        fleet_suspects = _gsum("raft.fleet.suspects")
        fleet_degraded = (fleet_serving < fleet_total
                          or fleet_serving == 0 or fleet_suspects > 0)
        body["fleet"] = {
            "replicas": fleet_total,
            "serving": fleet_serving,
            "suspects": fleet_suspects,
            "replication_lag_records": _gsum(
                "raft.fleet.replication.lag_records"),
        }
        if fleet_degraded:
            body["status"] = "degraded"
    # a mesh-wide server (the shards gauge set) names its mesh, its
    # merge compression and exactly which ranks look failed
    dist_shards = _gsum("raft.serve.dist.shards")
    if dist_shards:
        from raft_tpu_torch.comms.health import suspects_from_gauges
        body.setdefault("serve", {})["dist"] = {
            "shards": dist_shards,
            "merge_ratio": _gsum("raft.serve.dist.merge.ratio"),
            "suspect_ranks": suspects_from_gauges(gauges),
        }
    return body


class _Handler(BaseHTTPRequestHandler):
    # the server object carries the recorder, registry and attachments
    server: "DebugServer"

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=1).encode("utf-8"),
                   "application/json")

    def do_GET(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        path = url.path.rstrip("/") or "/"
        try:
            if path == "/metrics":
                fed = self.server.federator
                text = (fed.merged_text() if fed is not None
                        else self.server.registry.to_prometheus_text())
                self._send(200, text.encode("utf-8"),
                           "text/plain; version=0.0.4")
            elif path == "/fleet/metrics":
                self._fleet_metrics()
            elif path == "/fleet/healthz":
                self._fleet_healthz()
            elif path == "/fleet/trace":
                self._fleet_trace(q)
            elif path == "/healthz":
                body = _health_body(self.server.registry.snapshot())
                self._send_json(200 if body["status"] == "ok" else 503,
                                body)
            elif path == "/debug/requests":
                self._debug_requests(q)
            elif path == "/debug/slo":
                from raft_tpu_torch.obs import slo as _slo
                self._send_json(200, _slo.endpoint_body(
                    self.server.registry.snapshot()))
            elif path == "/debug/fleet":
                self._debug_fleet()
            elif path == "/debug/profile":
                from raft_tpu_torch.obs import profiler as _profiler
                self._send_json(200, _profiler.endpoint_body(
                    self.server.registry.snapshot()))
            elif path == "/debug/history":
                from raft_tpu_torch.obs import history as _history
                code, body = _history.endpoint_body(q)
                self._send_json(code, body)
            else:
                self._send_json(404, {"error": f"no route {path!r}",
                                      "routes": _ROUTES})
        except BrokenPipeError:
            pass

    def do_POST(self) -> None:  # noqa: N802 (BaseHTTPRequestHandler API)
        path = urlparse(self.path).path.rstrip("/") or "/"
        try:
            if path == "/search":
                self._search()
            else:
                self._send_json(404, {"error": f"no POST route {path!r}",
                                      "routes": ["/search"]})
        except BrokenPipeError:
            pass

    def _search(self) -> None:
        """``POST /search`` over the attached searcher. Body:
        ``{"queries": [[...], ...], "k": int?, "deadline_ms": float?}``."""
        # lazy: raft_tpu_torch.serve imports raft_tpu_torch.obs, whose
        # package imports this module
        from raft_tpu_torch.obs import spans as _spans
        from raft_tpu_torch.serve.types import DeadlineExceeded, RejectedError
        srv = self.server.searcher
        if srv is None:
            self._send_json(404, {"error": "no searcher attached "
                                           "(obs.serve(searcher=...))"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            queries = body["queries"]
            k = body.get("k")
            deadline_ms = body.get("deadline_ms")
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"bad request body: {e!r}"})
            return
        # an upstream traceparent parents this handler's span, and
        # through it the request the searcher serves
        incoming = self.headers.get("traceparent")
        trace_id = None
        try:
            with _spans.span("raft.serve.http", remote_parent=incoming,
                             route="/search") as sp:
                trace_id = sp.trace_id or None
                d, i = srv.search(queries, k=k, deadline_ms=deadline_ms)
        except RejectedError as e:
            self._send_json(429, {"error": "rejected", "detail": str(e),
                                  "trace_id": trace_id})
            return
        except DeadlineExceeded as e:
            self._send_json(504, {"error": "deadline", "detail": str(e),
                                  "trace_id": trace_id})
            return
        except Exception as e:
            self._send_json(500, {"error": type(e).__name__,
                                  "detail": str(e)[:500],
                                  "trace_id": trace_id})
            return
        self._send_json(200, {"distances": d.tolist(), "ids": i.tolist(),
                              "nq": len(i), "k": len(i[0]) if len(i)
                              else 0, "trace_id": trace_id})

    def _fleet_metrics(self) -> None:
        fed = self.server.federator
        if fed is None:
            self._send_json(404, _NO_FEDERATOR)
            return
        self._send(200, fed.merged_text().encode("utf-8"),
                   "text/plain; version=0.0.4")

    def _fleet_healthz(self) -> None:
        fed = self.server.federator
        if fed is None:
            self._send_json(404, _NO_FEDERATOR)
            return
        body = fed.healthz()
        self._send_json(200 if body["status"] == "ok" else 503, body)

    def _fleet_trace(self, q: dict) -> None:
        """``GET /fleet/trace?trace=<id>``: the stitched Chrome trace of
        one routed request, the local fragments and every peer's."""
        fed = self.server.federator
        if fed is None:
            self._send_json(404, _NO_FEDERATOR)
            return
        trace_id = q.get("trace", [None])[0]
        if not trace_id:
            self._send_json(400, {"error": "trace=<id> is required"})
            return
        body = _recorder.stitch_from_endpoints(
            trace_id, fed.url_instances(), recorder=self.server.recorder,
            timeout_s=fed.timeout_s)
        if not any(e.get("ph") == "X" for e in body["traceEvents"]):
            self._send_json(404, {"error": f"trace {trace_id!r} not "
                                           f"found on any instance"})
            return
        self._send_json(200, body)

    def _debug_fleet(self) -> None:
        """``GET /debug/fleet``: the attached router's report, else the
        exported ``raft.fleet.*`` gauges."""
        router = self.server.fleet
        fed = self.server.federator
        if router is not None:
            body = router.report()
            if fed is not None:
                body["federation"] = fed.report()
            self._send_json(200, body)
            return
        if fed is not None:
            self._send_json(200, {"federation": fed.report()})
            return
        gauges = self.server.registry.snapshot().get("gauges", {})
        fleet_g = {k: v for k, v in gauges.items()
                   if k.split("{")[0].startswith("raft.fleet.")}
        if not fleet_g:
            self._send_json(404, {"error": "no fleet attached and no "
                                           "raft.fleet.* gauges "
                                           "exported"})
            return
        self._send_json(200, {"source": "gauges", "gauges": fleet_g})

    def _debug_requests(self, q: dict) -> None:
        rec = self.server.recorder
        trace_id = q.get("trace", [None])[0]
        fmt = q.get("format", ["json"])[0]
        n = None
        if "n" in q:
            try:
                n = max(0, int(q["n"][0]))
            except ValueError:
                self._send_json(400, {"error": "n must be an integer"})
                return
        if trace_id is not None and \
                q.get("all", ["0"])[0] not in ("0", "", "false"):
            # the stitch wire format: every local fragment and this
            # host's wall clock (a peer estimates the skew from it)
            import time as _time
            self._send_json(200, {
                "trace_id": trace_id,
                "fragments": rec.fragments(trace_id),
                "now_unix": _time.time(),  # graftlint: disable=GL005
            })
            return
        if trace_id is not None:
            trace = rec.get(trace_id)
            if trace is None:
                self._send_json(404, {"error": f"trace {trace_id!r} not "
                                               f"in the recorder ring"})
                return
            if fmt == "chrome":
                self._send_json(200, _recorder.to_chrome_trace(trace))
            else:
                self._send_json(200, trace)
            return
        if fmt == "chrome":
            latest = rec.requests(1)
            if not latest:
                self._send_json(404, {"error": "recorder is empty"})
                return
            self._send_json(200, _recorder.to_chrome_trace(latest[0]))
            return
        if q.get("slow", ["0"])[0] not in ("0", "", "false"):
            body = rec.to_json(0)
            body["traces"] = rec.slow_requests(n)
            self._send_json(200, body)
            return
        self._send_json(200, rec.to_json(n))

    def log_message(self, fmt: str, *args) -> None:
        # access logs at DEBUG: a scraper every 15 s must not fill stderr
        from raft_tpu_torch.core.logger import get_logger
        get_logger("obs").debug("endpoint: " + fmt % args)


class DebugServer(ThreadingHTTPServer):
    """The debug endpoint's server; made by :func:`serve`."""

    daemon_threads = True

    def __init__(self, addr, recorder=None, registry=None,
                 searcher=None, fleet=None, federator=None,
                 max_threads: Optional[int] = None):
        super().__init__(addr, _Handler)
        self.recorder = recorder if recorder is not None \
            else _recorder.RECORDER
        self.registry = registry if registry is not None \
            else _registry.REGISTRY
        # a SearchServer (or anything with its search(queries, k=,
        # deadline_ms=)) behind POST /search
        self.searcher = searcher
        # a fleet router (raft_tpu_torch.fleet) behind GET /debug/fleet
        self.fleet = fleet
        # a metrics federator behind /fleet/* and the merged /metrics
        self.federator = federator
        if max_threads is None:
            try:
                max_threads = int(os.environ.get(
                    "RAFT_TPU_ENDPOINT_THREADS", "8"))
            except ValueError:
                max_threads = 8
        # thread-per-connection under a hard bound
        self._slots = threading.BoundedSemaphore(max(1, max_threads))
        self._thread: Optional[threading.Thread] = None

    def process_request_thread(self, request, client_address):
        if not self._slots.acquire(timeout=0.5):
            # saturated: drop the connection (the client sees a reset,
            # not a queue behind a stuck handler)
            self.shutdown_request(request)
            return
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._slots.release()

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        host = self.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "DebugServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.serve_forever, kwargs={"poll_interval": 0.25},
                daemon=True, name=f"raft-obs-endpoint-{self.port}")
            self._thread.start()
        return self

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "DebugServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def serve(host: str = "127.0.0.1", port: int = 0, recorder=None,
          registry=None, searcher=None, fleet=None,
          federator=None) -> DebugServer:
    """Start the debug endpoint in a daemon thread → the running
    :class:`DebugServer` (``.url``, ``.port``, ``.close()``). ``port=0``
    binds an ephemeral port. ``searcher`` (a
    :class:`raft_tpu_torch.serve.SearchServer`) enables ``POST
    /search``; ``fleet`` (a fleet router) the full ``GET /debug/fleet``
    report; ``federator`` (a metrics federator) the fleet aggregator's
    routes."""
    return DebugServer((host, port), recorder=recorder,
                       registry=registry, searcher=searcher,
                       fleet=fleet, federator=federator).start()

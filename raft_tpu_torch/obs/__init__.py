"""Observability (counterpart of ``raft_tpu.obs``): metrics, request
tracing and runtime telemetry under one ``raft.<module>.<op>`` naming
taxonomy.

* **metrics** (:mod:`raft_tpu_torch.obs.registry`): thread-safe
  counters, gauges and fixed-boundary histograms, with the JAX
  package's series names and Prometheus text; ``RAFT_TPU_METRICS=0``
  no-ops them. :func:`timed` puts a scope's wall seconds into
  ``<name>.seconds`` and a profiler range of ``name``.
* **spans** (:mod:`raft_tpu_torch.obs.spans`): per-request traces
  through the serving path, landing in the always-on flight recorder
  (:mod:`raft_tpu_torch.obs.recorder`): the last N request stories, a
  slow-query log, Chrome-trace export. ``RAFT_TPU_TRACE=0`` no-ops
  them.

* **endpoint** (:mod:`raft_tpu_torch.obs.endpoint`): ``obs.serve()``, a
  stdlib HTTP server with ``/metrics`` (Prometheus text), ``/healthz``
  (one verdict folded from every plane's gauges), ``/debug/requests``
  (the recorder), ``/debug/slo``, ``/debug/profile``,
  ``/debug/history``, ``/debug/fleet`` and ``POST /search`` over an
  attached ``SearchServer``.

Four planes load on use: :mod:`raft_tpu_torch.obs.quality`
(shadow-exact recall), :mod:`raft_tpu_torch.obs.profiler` (sampled
device-time attribution, duty cycle, device memory;
``RAFT_TPU_PROFILE_SAMPLE``), :mod:`raft_tpu_torch.obs.slo` (declared
objectives as multi-window burn rates) and
:mod:`raft_tpu_torch.obs.history` (the registry sampled over time, with
mean-shift anomaly detection).

The replica fleet (:mod:`raft_tpu_torch.fleet`) serves on this
endpoint: ``obs.serve(fleet=router)`` folds the router into
``/debug/fleet``, and each fleet daemon's transport is a
:class:`~raft_tpu_torch.obs.endpoint.DebugServer`.

Still to port (ROADMAP.md queue 1 item 7d): the metrics federator behind
the endpoint's ``/fleet/*`` routes, the black box and the
``RAFT_TPU_BLACKBOX`` knob that attaches it and the history at import.
"""

from raft_tpu_torch.obs.registry import (
    REGISTRY,
    DEFAULT_BUCKETS,
    SIZE_BUCKETS,
    NAME_RE,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    counter_sum,
    gauge,
    histogram,
    snapshot,
    snapshot_diff,
    to_prometheus_text,
    reset,
    set_enabled,
    enabled,
)
from raft_tpu_torch.obs.timing import timed
from raft_tpu_torch.obs.spans import (
    Span,
    span,
    current_span,
    current_trace_id,
    current_traceparent,
    parse_traceparent,
    add_stage_spans,
    set_trace_enabled,
    trace_enabled,
    set_trace_sample_rate,
    trace_sample_rate,
)
from raft_tpu_torch.obs.recorder import (FlightRecorder, RECORDER,
                                         to_chrome_trace)
from raft_tpu_torch.obs.endpoint import DebugServer, serve

__all__ = [
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "SIZE_BUCKETS",
    "NAME_RE",
    "CardinalityError",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "counter_sum",
    "gauge",
    "histogram",
    "snapshot",
    "snapshot_diff",
    "to_prometheus_text",
    "reset",
    "set_enabled",
    "enabled",
    "timed",
    "Span",
    "span",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "parse_traceparent",
    "add_stage_spans",
    "set_trace_enabled",
    "trace_enabled",
    "set_trace_sample_rate",
    "trace_sample_rate",
    "FlightRecorder",
    "RECORDER",
    "to_chrome_trace",
    "DebugServer",
    "serve",
]

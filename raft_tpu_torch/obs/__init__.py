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

Further planes load on use: :mod:`raft_tpu_torch.obs.quality`
(shadow-exact recall), :mod:`raft_tpu_torch.obs.profiler` (sampled
device-time attribution, duty cycle, device memory;
``RAFT_TPU_PROFILE_SAMPLE``), :mod:`raft_tpu_torch.obs.slo` (declared
objectives as multi-window burn rates),
:mod:`raft_tpu_torch.obs.federation` (cross-process metric federation
and the fleet rollup: ``obs.serve(federator=...)`` turns the endpoint
into the fleet aggregator, with ``/fleet/metrics``, ``/fleet/healthz``
and ``/fleet/trace``), and the post-mortem pair
:mod:`raft_tpu_torch.obs.history` (the registry sampled over time, with
mean-shift anomaly detection) + :mod:`raft_tpu_torch.obs.blackbox` (the
crash-durable black box). ``RAFT_TPU_BLACKBOX=<dir>`` attaches both at
import; ``python -m raft_tpu_torch.tools.doctor <dir>`` reads the dump.

The replica fleet (:mod:`raft_tpu_torch.fleet`) serves on this
endpoint: ``obs.serve(fleet=router)`` folds the router into
``/debug/fleet``, and each fleet daemon's transport is a
:class:`~raft_tpu_torch.obs.endpoint.DebugServer`.
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

# -- black-box ambient attach ---------------------------------------------
# RAFT_TPU_BLACKBOX=<dir> attaches the metrics-history sampler and the
# crash-durable black box at import, like the profiler's
# RAFT_TPU_PROFILE_SAMPLE knob. Unset, 0, off, false or no leaves BOTH
# modules unimported: the off state is one env read here and
# `_STATE is None` in each module, nothing else. The attach lives HERE,
# not at the black box's import, so the doctor can import the modules to
# READ a dump without ever starting a recorder into it.
import os as _os

_bb_dir = _os.environ.get("RAFT_TPU_BLACKBOX", "")
if _bb_dir and _bb_dir.lower() not in ("0", "false", "off", "no"):
    from raft_tpu_torch.obs import blackbox as _blackbox
    from raft_tpu_torch.obs import history as _history

    _history.enable_history()
    _blackbox.enable_blackbox(_bb_dir)
del _os, _bb_dir

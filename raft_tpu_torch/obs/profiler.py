"""Sampled resource profiler: device time, duty cycle, device memory
(counterpart of ``raft_tpu.obs.profiler``).

Every other signal the serving stack exports is host wall clock: a p99
histogram bucket, a queue-delay span. None of them tells "the card was
busy" from "the host was queueing, building or copying". This module
measures that, in three parts under one cheap admission gate:

* **device-time attribution**: at ``RAFT_TPU_PROFILE_SAMPLE`` rate
  (default 0.01 when the variable is set; the root admission of
  ``RAFT_TPU_TRACE_SAMPLE``) a blocking serving dispatch is timed in two
  halves: the host's work to issue it
  (``raft.obs.profile.host.seconds{program,family,rung}``) and the
  card's (``raft.obs.profile.device.seconds{...}``): in
  ``SearchPlan.search`` the time between two CUDA events recorded on
  the plan's stream before and after its work, read after the wait the
  call pays anyway. Sampled device seconds,
  extrapolated by the rate over a rolling window, give the duty-cycle
  gauge ``raft.obs.profile.duty_cycle{device}``. An unsampled dispatch
  reads one ``None``; a sampled one adds no synchronisation (only
  dispatches that wait anyway are sampled).
* **device memory**: a background thread polls
  :func:`raft_tpu_torch.core.memory.hbm_stats` for each CUDA device into
  ``raft.obs.profile.hbm.{bytes_in_use,peak_bytes,limit_bytes,
  headroom_frac}{device}``; when the worst device's free fraction falls
  below ``hbm_headroom_frac``, ``raft.obs.profile.hbm.low_headroom``
  trips. On the CPU ``hbm_stats`` is ``{}`` and no memory gauge is set:
  that is the CPU's answer. A compile ledger
  (``raft.obs.profile.compile.seconds{program}``) adds up plan builds.
* **surfaces**: :func:`report` and :func:`endpoint_body` (per-program
  device/host split, duty cycles, the memory table, the top
  device-time programs); a sampled request gains one measured
  ``raft.obs.profile.sync`` child span; per-tag windows (a server's
  :func:`tag_dispatch` name) give one duty cycle per server.

Zero-overhead contract: at rate 0 nothing attaches (no state object, no
thread, no gauge); every hook reads one module-level ``None``. The
sampler thread is a daemon, starts at the first sampled dispatch of an
attach made with ``start=False`` (the env attach at import), and
:func:`disable_profiling` stops and joins it.

Caveats: eager PyTorch launches a dispatch's kernels one by one while
the card already runs the first, so the two halves overlap and do not
add up to the call's wall. The device half runs from the stream
reaching the dispatch's first operation to its last one finishing: it
holds every kernel of the dispatch, and also the gaps where the card
waited for the host to launch the next one, so under a host-bound
dispatch it bounds the kernels' busy time from above (a trace's busy
share bounds it from below). On the CPU, and in
:func:`record_dispatch`, the device half is the wait after the enqueue
(the JAX package's split). The duty cycle extrapolates sampled device
seconds by ``1/rate`` over the window and is clamped to 1, so at low
rates and low traffic it is noisy; widen ``RAFT_TPU_PROFILE_WINDOW`` or
raise the rate.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.obs import spans

__all__ = [
    "ProfilerConfig",
    "SYNC_SPAN",
    "enable_profiling",
    "disable_profiling",
    "set_profile_sample_rate",
    "profile_sample_rate",
    "sampled",
    "record_dispatch",
    "record_sample",
    "note_compile",
    "tag_dispatch",
    "report",
    "endpoint_body",
    "duty_cycle",
]

_ENV_RATE = "RAFT_TPU_PROFILE_SAMPLE"
_ENV_WINDOW = "RAFT_TPU_PROFILE_WINDOW"
_ENV_HBM_MS = "RAFT_TPU_PROFILE_HBM_MS"
_ENV_HEADROOM = "RAFT_TPU_PROFILE_HBM_HEADROOM"

# the sampled-sync child span: unlike the raft.plan.stage.* children
# this one is measured, not attributed
SYNC_SPAN = _SYNC_SPAN = "raft.obs.profile.sync"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_rate() -> float:
    return min(max(_env_float(_ENV_RATE, 0.01), 0.0), 1.0)


class ProfilerConfig:
    """Knobs of the attached profiler state (env defaults; every field
    overridable through :func:`enable_profiling`).

    * ``window_s`` — the duty-cycle window: sampled device-seconds are
      summed over the trailing window and extrapolated by ``1/rate``.
    * ``hbm_poll_ms`` — memory sampler cadence (0 disables the thread —
      dispatch attribution only).
    * ``hbm_headroom_frac`` — the health guardrail: worst-device
      ``(limit − in_use) / limit`` below this trips
      ``raft.obs.profile.hbm.low_headroom``.
    * ``top_n`` — how many programs the report's top table
      carries.
    """

    __slots__ = ("window_s", "hbm_poll_ms", "hbm_headroom_frac",
                 "top_n")

    def __init__(self, window_s: Optional[float] = None,
                 hbm_poll_ms: Optional[float] = None,
                 hbm_headroom_frac: Optional[float] = None,
                 top_n: int = 10):
        self.window_s = float(window_s if window_s is not None
                              else _env_float(_ENV_WINDOW, 30.0))
        self.hbm_poll_ms = float(hbm_poll_ms if hbm_poll_ms is not None
                                 else _env_float(_ENV_HBM_MS, 500.0))
        self.hbm_headroom_frac = float(
            hbm_headroom_frac if hbm_headroom_frac is not None
            else _env_float(_ENV_HEADROOM, 0.1))
        self.top_n = int(top_n)
        if self.window_s <= 0:
            raise ValueError("ProfilerConfig: window_s must be > 0")
        if not 0.0 <= self.hbm_headroom_frac < 1.0:
            raise ValueError("ProfilerConfig: hbm_headroom_frac must "
                             "be in [0, 1)")


class _ProfilerState:
    """The attached profiler: per-(program, family, rung) and per-tag
    rolling windows of sampled dispatch splits, the HBM sampler
    thread, and the compile ledger. One instance lives in the module
    ``_STATE`` slot while profiling is on; ``None`` IS the off switch
    every hook site reads."""

    # dispatcher threads (record/note_compile), the sampler thread
    # (_hbm_loop / _refresh_duty_locked) and report() readers meet on
    # these fields: touch them only under `with self._lock` or in a
    # `_locked`-suffix method
    GUARDED_BY = ("_prog", "_tags", "_compile", "_hbm_peak",
                  "_started", "_closed", "_samples")

    def __init__(self, rate: float, config: ProfilerConfig,
                 seed: Optional[int] = None):
        self.rate = float(rate)
        self.cfg = config
        self._lock = threading.Lock()
        # admission RNG: intentionally outside GUARDED_BY — same as the
        # spans sampler, a racy draw only perturbs WHICH dispatch is
        # sampled, never correctness (CPython method call is atomic
        # enough for a Bernoulli gate)
        self._rng = random.Random(seed)
        self._t0 = time.monotonic()
        # (program, family, rung) -> deque[(t_mono, device_s, host_s)]
        self._prog: Dict[tuple, deque] = {}
        # dispatch tag (a server's name) -> deque[(t_mono, device_s)]
        self._tags: Dict[str, deque] = {}
        self._compile: Dict[str, float] = {}
        self._hbm_peak: Dict[str, int] = {}
        self._samples = 0
        self._started = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the HBM sampler thread (idempotent; no-op when
        ``hbm_poll_ms`` is 0)."""
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
        if self.cfg.hbm_poll_ms > 0:
            self._thread = threading.Thread(
                target=self._hbm_loop, daemon=True,
                name="raft-obs-profiler")
            self._thread.start()

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- ledger (dispatcher threads) ---------------------------------------
    def record(self, program: str, family: str, rung: str,
               host_s: float, device_s: float, tag: str) -> None:
        obs.counter("raft.obs.profile.samples.total",
                    program=program).inc()
        obs.counter("raft.obs.profile.device.seconds", program=program,
                    family=family, rung=rung).inc(device_s)
        obs.counter("raft.obs.profile.host.seconds", program=program,
                    family=family, rung=rung).inc(host_s)
        now = time.monotonic()
        with self._lock:
            key = (program, family, rung)
            win = self._prog.get(key)
            if win is None:
                win = self._prog[key] = deque()
            win.append((now, device_s, host_s))
            if tag:
                tw = self._tags.get(tag)
                if tw is None:
                    tw = self._tags[tag] = deque()
                tw.append((now, device_s))
            self._samples += 1
            self._refresh_duty_locked(now)

    def note_compile(self, program: str, seconds: float) -> None:
        obs.counter("raft.obs.profile.compile.seconds",
                    program=program).inc(seconds)
        with self._lock:
            self._compile[program] = (self._compile.get(program, 0.0)
                                      + seconds)

    # -- duty cycle --------------------------------------------------------
    def _window_span_locked(self, now: float) -> float:
        """The effective window: the configured span, shortened while
        the profiler is younger than it (a fresh attach must not read
        as near-zero duty cycle for window_s seconds)."""
        return max(min(self.cfg.window_s, now - self._t0), 1e-3)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.cfg.window_s
        for table in (self._prog, self._tags):
            for win in table.values():
                while win and win[0][0] < horizon:
                    win.popleft()

    def _refresh_duty_locked(self, now: float) -> None:
        self._prune_locked(now)
        span_s = self._window_span_locked(now)
        dev_total = sum(rec[1] for win in self._prog.values()
                        for rec in win)
        duty = min(dev_total / self.rate / span_s, 1.0)
        obs.gauge("raft.obs.profile.duty_cycle",
                  device=_device_label()).set(round(duty, 6))

    def duty_cycle(self, tag: Optional[str] = None) -> float:
        """Extrapolated duty cycle over the trailing window — global,
        or restricted to one dispatch tag (a server's name)."""
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            span_s = self._window_span_locked(now)
            if tag is None:
                dev = sum(rec[1] for win in self._prog.values()
                          for rec in win)
            else:
                dev = sum(d for _, d in self._tags.get(tag, ()))
            return min(dev / self.rate / span_s, 1.0)

    # -- HBM sampler thread ------------------------------------------------
    def _hbm_loop(self) -> None:
        from raft_tpu_torch.core import memory as _memory
        log = get_logger("obs")
        poll_s = self.cfg.hbm_poll_ms / 1e3
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                self._sample_hbm(_memory)
            except Exception as e:
                obs.counter("raft.obs.profile.errors.total").inc()
                log.warning("profiler: HBM sample failed: %r", e)
            now = time.monotonic()
            with self._lock:
                if self._closed:
                    return
                self._refresh_duty_locked(now)
            self._wake.wait(timeout=poll_s)

    def _sample_hbm(self, _memory) -> None:
        worst_headroom = None
        for dev in _hbm_devices():
            stats = _memory.hbm_stats(dev)
            if not stats:
                continue
            label = f"{dev.type}:{dev.index}"
            in_use = int(stats.get("bytes_in_use", 0))
            limit = int(stats.get("bytes_limit", 0))
            with self._lock:
                peak = max(self._hbm_peak.get(label, 0), in_use,
                           int(stats.get("peak_bytes_in_use", 0)))
                self._hbm_peak[label] = peak
            obs.gauge("raft.obs.profile.hbm.bytes_in_use",
                      device=label).set(in_use)
            obs.gauge("raft.obs.profile.hbm.peak_bytes",
                      device=label).set(peak)
            obs.gauge("raft.obs.profile.hbm.limit_bytes",
                      device=label).set(limit)
            if limit > 0:
                headroom = max(0.0, (limit - in_use) / limit)
                obs.gauge("raft.obs.profile.hbm.headroom_frac",
                          device=label).set(round(headroom, 6))
                if worst_headroom is None or headroom < worst_headroom:
                    worst_headroom = headroom
        if worst_headroom is not None:
            low = worst_headroom < self.cfg.hbm_headroom_frac
            obs.gauge("raft.obs.profile.hbm.low_headroom").set(
                1.0 if low else 0.0)

    # -- report ------------------------------------------------------------
    def report(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            span_s = self._window_span_locked(now)
            programs: List[dict] = []
            for (program, family, rung), win in self._prog.items():
                if not win:
                    continue
                dev = sum(r[1] for r in win)
                host = sum(r[2] for r in win)
                programs.append({
                    "program": program,
                    "family": family,
                    "rung": rung,
                    "samples": len(win),
                    "device_s": round(dev, 6),
                    "host_s": round(host, 6),
                    "device_frac": round(dev / max(dev + host, 1e-12),
                                         4),
                    "duty_cycle": round(
                        min(dev / self.rate / span_s, 1.0), 6),
                })
            tags = {}
            for tag, win in self._tags.items():
                if not win:
                    continue
                dev = sum(d for _, d in win)
                tags[tag] = {
                    "samples": len(win),
                    "device_s": round(dev, 6),
                    "duty_cycle": round(
                        min(dev / self.rate / span_s, 1.0), 6),
                }
            compile_s = dict(self._compile)
            samples = self._samples
            hbm_peak = dict(self._hbm_peak)
        programs.sort(key=lambda p: p["device_s"], reverse=True)
        dev_total = sum(p["device_s"] for p in programs)
        host_total = sum(p["host_s"] for p in programs)
        gauges = obs.snapshot().get("gauges", {})
        hbm = _hbm_table(gauges)
        for label, peak in hbm_peak.items():
            hbm.setdefault(label, {})["peak_bytes"] = peak
        return {
            "enabled": True,
            "rate": self.rate,
            "window_s": round(span_s, 3),
            "samples": samples,
            "duty_cycle": round(
                min(dev_total / self.rate / span_s, 1.0), 6),
            "device_s": round(dev_total, 6),
            "host_s": round(host_total, 6),
            "programs": programs,
            "top": programs[:self.cfg.top_n],
            "tags": tags,
            "compile_seconds": {k: round(v, 4)
                                for k, v in compile_s.items()},
            "hbm": hbm,
        }


# module-level attach point: None IS the off state (one read per hook)
_STATE: Optional[_ProfilerState] = None
_TLS = threading.local()
_device_label_cache: Optional[str] = None


def _device_label() -> str:
    """``cuda:<index>`` of the current CUDA device, ``cpu:0`` without
    one (the JAX package's label on the CPU)."""
    global _device_label_cache
    if _device_label_cache is None:
        import torch
        _device_label_cache = (f"cuda:{torch.cuda.current_device()}"
                               if torch.cuda.is_available() else "cpu:0")
    return _device_label_cache


def _hbm_devices() -> list:
    """The devices the memory sampler polls: every CUDA device."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _hbm_table(gauges: dict) -> dict:
    """The per-device memory table out of exported gauges (shared by
    the live report and the gauges-only endpoint body)."""
    table: Dict[str, dict] = {}
    for series, value in gauges.items():
        name, _, labels = series.partition("{")
        if not name.startswith("raft.obs.profile.hbm.") \
                or name.endswith("low_headroom"):
            continue
        dev = "all"
        for part in labels.rstrip("}").split(","):
            if part.startswith("device="):
                dev = part[len("device="):]
        table.setdefault(dev, {})[name.rsplit(".", 1)[1]] = value
    return table


# ---------------------------------------------------------------------------
# public API — hook-site functions (hot path) and lifecycle
# ---------------------------------------------------------------------------


def enable_profiling(rate: Optional[float] = None,
                     config: Optional[ProfilerConfig] = None,
                     seed: Optional[int] = None,
                     start: bool = True) -> Optional[_ProfilerState]:
    """Attach (or re-attach) the profiler at ``rate`` (default: the
    ``RAFT_TPU_PROFILE_SAMPLE`` env, 0.01) and start the memory sampler
    (``start=False`` defers the thread to the first sampled dispatch —
    the import-time env attach uses this so merely importing never
    spawns a thread). Rate 0 detaches instead — after it every hook
    site is back to one ``None`` read. Returns the attached state
    (None at rate 0)."""
    global _STATE
    rate = _env_rate() if rate is None else min(max(float(rate), 0.0),
                                                1.0)
    prev, _STATE = _STATE, None
    if prev is not None:
        prev.close()
    if rate <= 0:
        return None
    st = _ProfilerState(rate, config if config is not None
                        else ProfilerConfig(), seed=seed)
    if start:
        st.start()
    _STATE = st
    return st


def disable_profiling() -> None:
    """Detach: stop the sampler thread, drop the ledger. Hook sites
    are back to one ``None`` read."""
    enable_profiling(0.0)


def set_profile_sample_rate(rate: float, seed: Optional[int] = None
                            ) -> None:
    """Runtime rate setter (the :func:`spans.set_trace_sample_rate`
    shape): > 0 attaches/re-attaches, 0 detaches."""
    enable_profiling(rate, seed=seed)


def profile_sample_rate() -> float:
    st = _STATE
    return st.rate if st is not None else 0.0


def state() -> Optional[_ProfilerState]:
    """The attached profiler state, or None while profiling is off."""
    return _STATE


def sampled() -> bool:
    """Root admission for one dispatch: False when profiling is off
    (one module-level ``None`` read — the whole cost of an unsampled
    or unprofiled dispatch) or when this dispatch loses the Bernoulli
    draw."""
    st = _STATE
    if st is None:
        return False
    if st.rate < 1.0 and st._rng.random() >= st.rate:
        return False
    # deferred thread start (the import-time env attach): idempotent,
    # one brief lock on the sampled (≤ rate) path only
    st.start()
    return True


def tag_dispatch(tag: str) -> None:
    """Tag this thread's subsequent sampled dispatches (the batcher
    calls this with its server's tag on the thread that runs the plan,
    so each server's duty cycle has its own window). One ``None`` read
    when profiling is off."""
    if _STATE is None:
        return
    _TLS.tag = tag


def record_dispatch(t_start: float, t_enq: float, result=None, *,
                    program: str, family: str = "",
                    rung="") -> None:
    """Record one sampled dispatch: ``t_start``/``t_enq`` are
    ``perf_counter`` stamps at dispatch start and enqueue-complete;
    ``result`` (tensors, in nested lists, tuples and dicts) is waited
    for HERE on its device's current stream (by event, never the whole
    device); pass None when the caller already waited.
    The split lands in the ledger, the counters, and one measured
    ``raft.obs.profile.sync`` child span under the current request."""
    if result is not None:
        from raft_tpu_torch.core.interruptible import wait_ready
        wait_ready(result)
    t_done = time.perf_counter()
    st = _STATE
    if st is None:        # raced a detach: the sync already happened
        return
    host_s = max(t_enq - t_start, 0.0)
    device_s = max(t_done - t_enq, 0.0)
    tag = getattr(_TLS, "tag", "")
    st.record(program, family, str(rung), host_s, device_s, tag)
    spans.add_child_span(
        _SYNC_SPAN, t_enq, device_s, program=program,
        host_ms=round(host_s * 1e3, 3),
        device_ms=round(device_s * 1e3, 3))


def record_sample(*, program: str, family: str = "", rung="",
                  host_s: float, device_s: float) -> None:
    """Lower-level ledger entry for a site that measured its own
    split — ``SearchPlan.search`` uses it so the host half covers the
    WHOLE call (query conversion before the enqueue and span/trace
    work after the sync included), not just the enqueue window. The
    site records its own ``raft.obs.profile.sync`` child span at the
    sync point, where the request trace is still open."""
    st = _STATE
    if st is None:
        return
    st.record(program, family, str(rung), max(host_s, 0.0),
              max(device_s, 0.0), getattr(_TLS, "tag", ""))


def note_compile(program: str, seconds: float) -> None:
    """Accumulate one AOT build into the compile ledger (called from
    the ``raft.plan.build.total`` sites). One ``None`` read when
    profiling is off."""
    st = _STATE
    if st is None:
        return
    st.note_compile(program, float(seconds))


def duty_cycle(tag: Optional[str] = None) -> Optional[float]:
    """The extrapolated duty cycle over the trailing window (None when
    profiling is off). ``tag`` restricts to one dispatch tag (a
    server's name)."""
    st = _STATE
    if st is None:
        return None
    return st.duty_cycle(tag)


def report() -> dict:
    """The full profiler report: duty cycles, per-program device/host
    splits, the top device-time table, per-tag (server) utilization,
    the compile ledger, the device-memory table."""
    st = _STATE
    if st is None:
        return {"enabled": False, "rate": 0.0}
    return st.report()


def endpoint_body(snapshot: dict) -> dict:
    """The ``/debug/profile`` body (the HTTP route comes with the debug
    endpoint): the in-process profiler's full report when one is
    attached, else rebuilt from the exported ``raft.obs.profile.*``
    gauges of ``snapshot`` (another process's scrape)."""
    st = _STATE
    if st is not None:
        return st.report()
    gauges = snapshot.get("gauges", {})
    prof = {k: v for k, v in gauges.items()
            if k.split("{")[0].startswith("raft.obs.profile.")}
    if not prof:
        return {"enabled": False, "rate": 0.0,
                "error": "no profiler attached and no "
                         "raft.obs.profile.* gauges exported"}
    return {"enabled": False, "source": "gauges",
            "duty_cycle": {k: v for k, v in prof.items()
                           if k.split("{")[0]
                           == "raft.obs.profile.duty_cycle"},
            "hbm": _hbm_table(gauges)}


# ambient opt-in (the RAFT_TPU_TRACE_SAMPLE pattern): an explicitly
# set env rate attaches at import — the sampler thread waits for the
# first sampled dispatch, so importing alone never spawns a thread
if os.environ.get(_ENV_RATE):
    _env_v = _env_rate()
    if _env_v > 0:
        enable_profiling(_env_v, start=False)
    del _env_v

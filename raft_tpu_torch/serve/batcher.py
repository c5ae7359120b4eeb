"""Dynamic micro-batcher: independent requests → full plan shapes
(counterpart of ``raft_tpu.serve.batcher``).

A bounded queue and one dispatcher thread. The dispatcher coalesces
whatever is waiting into the smallest admissible shape of the prepared
:class:`~raft_tpu_torch.serve.ladder.PlanLadder`, pads the ragged tail
with duplicated real rows of the same batch (their results are dropped,
so a pad row's neighbours never reach another caller), runs the plan
and scatters per-request slices back to the callers' futures.

Kept from the JAX package: admission with :class:`RejectedError` over
``max_queue``; deadlines that fail with :class:`DeadlineExceeded`
without taking a batch slot; the ``n_probes`` degradation ladder driven
by the :class:`LoadController`; a crash guard that fails one broken
batch with :class:`DispatchError`, logs it and keeps serving; and the
failure path:

* the dispatch **watchdog** (``ServeConfig.dispatch_timeout_ms``) runs
  each dispatch on a helper thread and abandons one that overruns,
  turning the hang into a typed :class:`ShardFailedError`; a plan that
  returns a comms status (``ABORT``/``ERROR``) instead of results is
  turned into the same error;
* **retries** of a :class:`ShardFailedError` with exponential backoff
  under ``max_retries``, deadline-aware: a request whose deadline falls
  inside the backoff fails at once with :class:`DeadlineExceeded`. Any
  other exception (a kernel's or CUDA's error among them) fails the
  batch as it is, with no retry;
* the ``serve.execute`` fault-injection site
  (:mod:`raft_tpu_torch.testing.faults`), inside the watchdog's scope.

* **quality sampling**: with ``ServeConfig.quality_sample_rate`` > 0,
  :meth:`SearchServer.enable_quality` attaches a
  :class:`~raft_tpu_torch.obs.quality.QualityMonitor`, and each served
  request is offered to it after its future is set (a Bernoulli draw
  and a bounded copy on the dispatcher thread; the exact replay runs on
  the monitor's own thread). At rate 0 nothing is attached and the
  result loop reads one flag.
* **observability**: the histograms ``raft.serve.request.seconds`` and
  ``raft.serve.queue.delay.seconds`` (:data:`SERVE_LATENCY_BUCKETS`),
  ``raft.serve.batch.size`` and ``raft.serve.batch.occupancy``
  (:data:`OCCUPANCY_BUCKETS`), the ``raft.serve.shed.rate`` gauge; a
  ``raft.serve.batch`` trace per batch (``raft.serve.queue_wait``,
  ``raft.serve.execute`` and ``raft.serve.retry`` children; the plan's
  ``raft.plan.search`` inside the execute span) and a
  ``raft.serve.request`` trace per request over its life (submit to
  results), parented by the caller's ``traceparent``
  (``submit(trace_context=...)``, default the caller thread's open
  span), a batch's built in one pass after its futures are set and
  recorded under one lock; the resource profiler's dispatch tag on the
  thread that runs the plan (``"server"``, or the name a fleet replica
  gives it through :meth:`SearchServer.set_profile_tag`).
* **the fleet's surface**: :meth:`SearchServer.load` (queued and
  in-flight rows, the shed rate, the admission state: the router's
  power-of-two-choices input), :meth:`SearchServer.drain` (admission
  stops, new work sheds with reason ``draining``, the queue flushes) and
  :meth:`SearchServer.resume`.

A :class:`~raft_tpu_torch.mutate.MutableIndex` is served through
stable ladder handles that resolve its live epoch per call; with quality
sampling on, its compactions roll the monitor's epoch. A
:class:`~raft_tpu_torch.neighbors.tiered.TieredIndex` is served through
its own plan grid (``tiered.build_ladder``), family ``tiered_ivf_flat``.

Threading model: the dispatcher thread owns the batching; caller
threads only touch numpy and futures. With the watchdog on, each
dispatch runs on one helper thread that the dispatcher waits on, under
``torch.cuda.device(plan.device)`` (the current device is per thread),
on the device's default stream, and ``plan.search(block=True)``
synchronises inside the call, so the timeout covers the kernels' time.
An abandoned helper finishes its call and exits without touching the
server; its results are dropped. Its late ``plan.search`` may overlap
the retry on the same stream: the kernel wrappers keep no workspace
across calls (each call allocates its own), so the two never share
scratch memory; only the launch counters of ``raft_tpu_torch.ops`` see
both.
"""

from __future__ import annotations

import contextlib
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.obs import profiler, recorder, spans
from raft_tpu_torch.serve.controller import LoadController
from raft_tpu_torch.serve.ladder import PlanLadder
from raft_tpu_torch.serve.types import (DeadlineExceeded, DispatchError,
                                        RejectedError, SearchResult,
                                        ServeConfig, ShardFailedError,
                                        _Request)
from raft_tpu_torch.testing import faults
from raft_tpu_torch.util.host import host_array

__all__ = ["SearchServer", "SERVE_LATENCY_BUCKETS", "OCCUPANCY_BUCKETS"]

# serving latency needs finer edges than the registry's default around
# the tens-of-ms watermark region
SERVE_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2,
    0.25, 0.3, 0.5, 1.0, 2.5, 5.0, 10.0)
OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75,
                     0.875, 1.0)

_SHED_RATE_WINDOW_S = 10.0


class _DispatchWorker:
    """The watchdog's helper thread: runs dispatches so the dispatcher
    can time one out and walk away. A timed-out worker is *abandoned*:
    it finishes (or hangs on) its call, sees the flag and exits without
    touching the server; the server starts a new one for the next
    dispatch."""

    def __init__(self, name: str):
        self._q: queue_mod.Queue = queue_mod.Queue()
        self.abandoned = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, fn) -> dict:
        box = {"done": threading.Event(), "out": None, "err": None}
        self._q.put((fn, box))
        return box

    def stop(self) -> None:
        self._q.put(None)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box = item
            try:
                box["out"] = fn()
            except BaseException as e:  # delivered to the dispatcher
                box["err"] = e
            box["done"].set()
            if self.abandoned.is_set():
                return


def _on_device(plan):
    """The plan's CUDA device as the calling thread's current device (a
    no-op for CPU and fake plans)."""
    dev = getattr(plan, "device", None)
    if getattr(dev, "type", None) == "cuda":
        import torch
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class SearchServer:
    """The serving runtime over one index: ``submit() -> Future`` and a
    blocking ``search()``. Construct with :meth:`from_index`, or from a
    :class:`PlanLadder` directly (tests inject fakes)."""

    # static race contract (tools/graftlint GL003): these fields sit on
    # the caller-thread/dispatcher-thread boundary and are touched only
    # under ``self._cond`` or in a ``_locked``-suffix method
    GUARDED_BY = ("_q", "_rows_queued", "_closed", "_shed_times",
                  "_draining", "_inflight_rows")

    def __init__(self, ladder: PlanLadder,
                 config: Optional[ServeConfig] = None, start: bool = True):
        self._ladder = ladder
        self._cfg = config if config is not None else ServeConfig()
        self._controller = LoadController(len(ladder.rungs), self._cfg)
        self._q: deque = deque()
        self._rows_queued = 0
        self._cond = threading.Condition()
        self._closed = False
        self._draining = False
        self._inflight_rows = 0
        self._thread: Optional[threading.Thread] = None
        self._shed_times: deque = deque()
        # the watchdog's helper: dispatcher-thread state only, no lock
        self._worker: Optional[_DispatchWorker] = None
        # quality sampling: None until enable_quality attaches a monitor,
        # so with sampling off the result loop reads this one flag;
        # _quality_meta carries the metric, family and device from_index
        # learned; _quality_src is the mutable index whose epoch tags the
        # samples (None for an immutable one)
        self._quality = None
        self._quality_src = None
        self._quality_meta: dict = {}
        # the resource profiler's tag of this server's sampled dispatches
        # (a fleet replica sets its name): read on the dispatcher thread,
        # written once at attach, no lock
        self._profile_tag = "server"
        obs.gauge("raft.serve.queue.max").set(self._cfg.max_queue)
        obs.gauge("raft.serve.queue.depth").set(0)
        obs.gauge("raft.serve.shed.rate").set(0.0)
        if start:
            self.start()

    @classmethod
    def from_index(cls, index, rep_queries, k: int, params=None,
                   config: Optional[ServeConfig] = None,
                   start: bool = True) -> "SearchServer":
        """Prepare and warm the (shape x rung) plan ladder for an
        IVF-Flat, IVF-PQ or IVF-BQ ``index`` and start serving;
        ``params`` defaults to the family's ``SearchParams``.
        ``rep_queries`` is the representative cap-measurement sample (as
        for ``plan.build_plan``). A tiered index (``neighbors.tiered``)
        serves through its own plans. A
        :class:`raft_tpu_torch.mutate.MutableIndex` is accepted too: its
        (shape x rung x delta-rung) grid is warmed instead, and the
        server keeps serving through every background compaction (the
        ladder's handles resolve the live epoch per call)."""
        from raft_tpu_torch.mutate import MutableIndex, build_serve_ladder
        from raft_tpu_torch.neighbors import plan as plan_mod
        from raft_tpu_torch.neighbors.tiered import TieredIndex
        config = config if config is not None else ServeConfig()
        if isinstance(index, MutableIndex):
            family = index.family
            expects(k == index.k,
                    "serve.from_index: k=%d != MutableIndex k=%d "
                    "(fixed at its construction)", k, index.k)
            expects(params is None,
                    "serve.from_index: a MutableIndex carries its own "
                    "search params (set them at its construction)")
            ladder = build_serve_ladder(
                index, rep_queries, shapes=config.batch_sizes,
                probes_ladder=config.probes_ladder,
                prewarm=config.prewarm)
        else:
            # the same resolver PlanLadder.build uses: an unsupported
            # index fails alike either way
            if isinstance(index, TieredIndex):
                family = "tiered_ivf_flat"
            else:
                family, _ = plan_mod._resolve_builder(index)
            ladder = PlanLadder.build(index, rep_queries, k, params,
                                      shapes=config.batch_sizes,
                                      probes_ladder=config.probes_ladder,
                                      prewarm=config.prewarm)
        srv = cls(ladder, config, start=start)
        srv._quality_meta = {"metric": getattr(index, "metric", None),
                             "family": family, "device": index.device}
        if isinstance(index, MutableIndex):
            srv._quality_src = index
        return srv

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SearchServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="raft-serve-batcher")
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop admitting, fail everything still queued with
        :class:`RejectedError`, and join the dispatcher."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._worker is not None:
            self._worker.stop()
            self._worker = None
        if self._quality is not None:
            self._quality.close()
        self._drain_closed()

    def __enter__(self) -> "SearchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        # benign racy read: a bool snapshot for status endpoints; the
        # admission decision re-checks under the lock in submit()
        return self._closed  # graftlint: disable=GL003

    @property
    def ladder(self) -> PlanLadder:
        return self._ladder

    @property
    def config(self) -> ServeConfig:
        return self._cfg

    # -- quality sampling --------------------------------------------------
    @property
    def quality(self):
        """The attached :class:`~raft_tpu_torch.obs.quality.QualityMonitor`
        (None while sampling is off)."""
        return self._quality

    def enable_quality(self, corpus, ids=None, metric=None,
                       estimator=None, qconfig=None, family=None):
        """Attach shadow-exact recall estimation: served queries are
        reservoir-sampled at ``ServeConfig.quality_sample_rate`` and
        replayed off the serving path through an exact scorer over
        ``corpus`` (the index's rows, or a bounded sample of them; see
        :mod:`raft_tpu_torch.obs.quality`), built on the index's device
        and warmed here. Returns the monitor, or None when the rate is 0
        (nothing is built and the hot path stays at one flag read)."""
        rate = self._cfg.quality_sample_rate
        if rate <= 0:
            get_logger("serve").info(
                "enable_quality: quality_sample_rate=0 — no monitor "
                "attached (set it on ServeConfig to sample)")
            return None
        from raft_tpu_torch.obs import quality as _quality
        metric = metric if metric is not None \
            else self._quality_meta.get("metric")
        kwargs = {} if metric is None else {"metric": metric}
        qcfg = qconfig if qconfig is not None \
            else _quality.QualityConfig()
        scorer = _quality.ExactScorer(
            corpus, ids=ids, kmax=self._ladder.k,
            max_rows=qcfg.max_rows, chunk=qcfg.chunk,
            batch=qcfg.shadow_batch, seed=qcfg.seed,
            device=self._quality_meta.get("device", "cuda"), **kwargs)
        monitor = _quality.QualityMonitor(
            scorer, sample_rate=rate, config=qcfg,
            family=(family if family is not None
                    else self._quality_meta.get("family", "index")),
            estimator=estimator)
        return self.attach_quality(monitor)

    def attach_quality(self, monitor):
        """Attach an already-built monitor (tests inject fakes). Wires
        the compaction epoch listener when the server fronts a
        :class:`~raft_tpu_torch.mutate.MutableIndex`, so recall is
        tracked per epoch."""
        src = self._quality_src
        if src is not None:
            src.add_epoch_listener(monitor.note_epoch)
        self._quality = monitor
        return monitor

    def set_profile_tag(self, tag: str) -> None:
        """Name this server's sampled dispatches in the resource
        profiler's per-tag ledger (:mod:`raft_tpu_torch.obs.profiler`):
        a :class:`~raft_tpu_torch.fleet.Replica` passes its name, so the
        fleet's utilization is told apart replica by replica."""
        self._profile_tag = str(tag)

    def _quality_epoch(self) -> int:
        src = self._quality_src
        return int(src.epoch) if src is not None else 0

    def _quality_detail(self) -> str:
        """Shard attribution of coverage-flagged samples (a distributed
        tier names its excluded shards here)."""
        return ""

    # -- admission ---------------------------------------------------------
    def submit(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               trace_context: Optional[str] = None):
        """Enqueue one request → ``Future`` of ``(dists, ids)``, each
        ``(nq, k)`` numpy. A full queue or a closed server fails the
        future at once with :class:`RejectedError`.

        ``trace_context`` is a ``traceparent`` value that parents the
        request's ``raft.serve.request`` root span; by default the
        caller thread's innermost open span."""
        q = host_array(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        expects(q.ndim == 2 and q.shape[1] == self._ladder.dim,
                "serve.submit: queries must be (nq, dim=%d), got %s",
                self._ladder.dim, q.shape)
        nq = int(q.shape[0])
        expects(0 < nq <= self._ladder.max_shape,
                "serve.submit: nq=%d exceeds the largest ladder shape %d",
                nq, self._ladder.max_shape)
        k = self._ladder.k if k is None else int(k)
        expects(0 < k <= self._ladder.k,
                "serve.submit: k=%d exceeds the plan k=%d", k,
                self._ladder.k)
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        now = time.perf_counter()
        if trace_context is None:
            trace_context = spans.current_traceparent()
        req = _Request(queries=q, nq=nq, k=k, t_enq=now,
                       deadline=(now + deadline_ms / 1e3
                                 if deadline_ms and deadline_ms > 0
                                 else None),
                       trace_ctx=trace_context)
        obs.counter("raft.serve.requests.total").inc()
        obs.counter("raft.serve.queries.total").inc(nq)
        with self._cond:
            if self._closed:
                self._shed_locked(req, "closed")
                return req.future
            if self._draining:
                # drain() stopped admission (a rolling restart): the queue
                # flushes, new work goes to another replica
                self._shed_locked(req, "draining")
                return req.future
            if len(self._q) >= self._cfg.max_queue:
                self._shed_locked(req, "queue_full")
                return req.future
            self._q.append(req)
            self._rows_queued += nq
            obs.gauge("raft.serve.queue.depth").set(len(self._q))
            self._cond.notify()
        return req.future

    def search(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(queries, k, deadline_ms).result(timeout)

    # -- load and drain: the fleet's view of one replica --------------------
    def load(self) -> dict:
        """A cheap load snapshot for routing (the fleet router's
        power-of-two-choices input) and status surfaces: queued requests
        and rows, the rows of the batch executing now, the recent shed
        rate and the admission state. One lock, no device work."""
        with self._cond:
            self._update_shed_rate_locked()
            return {
                "queue_depth": len(self._q),
                "queued_rows": self._rows_queued,
                "inflight_rows": self._inflight_rows,
                "shed_rate": (len(self._shed_times)
                              / _SHED_RATE_WINDOW_S),
                "draining": self._draining,
                "closed": self._closed,
            }

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admission and flush: new submissions fail at once with
        :class:`RejectedError` (reason ``draining``) while every queued
        request still runs and every outstanding future resolves. True
        once the queue is empty and no batch is in flight, False on
        timeout with work left. The dispatcher stays alive:
        :meth:`resume` reopens admission, and :meth:`close` afterwards
        has nothing left to fail."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._q or self._inflight_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.25))
            return True

    def resume(self) -> None:
        """Reopen admission after :meth:`drain` (a rolling restart's
        rejoin)."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()

    # -- internals ---------------------------------------------------------
    def _shed_locked(self, req: _Request, reason: str) -> None:
        """Refuse admission (under the queue lock): counted and recorded
        as a span."""
        obs.counter("raft.serve.shed.total", reason=reason).inc()
        self._shed_times.append(time.monotonic())
        self._update_shed_rate_locked()
        with spans.span("raft.serve.request",
                        remote_parent=req.trace_ctx,
                        nq=req.nq, k=req.k,
                        outcome="shed", reason=reason):
            pass
        req.future.set_exception(RejectedError(
            f"request rejected ({reason}): queue depth "
            f"{len(self._q)}/{self._cfg.max_queue}"))

    def _update_shed_rate_locked(self) -> None:
        now = time.monotonic()
        while self._shed_times and now - self._shed_times[0] > \
                _SHED_RATE_WINDOW_S:
            self._shed_times.popleft()
        obs.gauge("raft.serve.shed.rate").set(
            len(self._shed_times) / _SHED_RATE_WINDOW_S)

    def _drain_closed(self) -> None:
        with self._cond:
            pending = list(self._q)
            self._q.clear()
            self._rows_queued = 0
            obs.gauge("raft.serve.queue.depth").set(0)
        for r in pending:
            if not r.future.done():
                obs.counter("raft.serve.shed.total", reason="closed").inc()
                r.future.set_exception(
                    RejectedError("server closed while queued"))

    def _fail_deadline(self, req: _Request, now: float) -> None:
        waited_ms = round((now - req.t_enq) * 1e3, 3)
        obs.counter("raft.serve.deadline.total").inc()
        with spans.span("raft.serve.request",
                        remote_parent=req.trace_ctx,
                        nq=req.nq, k=req.k,
                        outcome="deadline", waited_ms=waited_ms):
            spans.add_child_span("raft.serve.queue_wait", req.t_enq,
                                 now - req.t_enq)
        req.future.set_exception(DeadlineExceeded(
            f"deadline expired after {waited_ms} ms in queue"))

    def _take_batch_locked(self):
        """Pop whole requests up to the largest shape; expired requests
        are dropped without taking a slot."""
        now = time.perf_counter()
        max_shape = self._ladder.max_shape
        batch, rows, expired = [], 0, []
        while self._q:
            r = self._q[0]
            if r.deadline is not None and now >= r.deadline:
                self._q.popleft()
                self._rows_queued -= r.nq
                expired.append(r)
                continue
            if batch and rows + r.nq > max_shape:
                break
            self._q.popleft()
            self._rows_queued -= r.nq
            batch.append(r)
            rows += r.nq
        depth = len(self._q)
        obs.gauge("raft.serve.queue.depth").set(depth)
        return batch, rows, expired, depth, now

    def _loop(self) -> None:
        cfg = self._cfg
        idle_s = max(cfg.degrade_cooldown_ms / 1e3, 0.02)
        wait_s = cfg.max_wait_ms / 1e3
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    if not self._cond.wait(timeout=idle_s):
                        # idle tick: the ladder steps back toward full
                        # quality, the shed-rate window decays
                        self._controller.observe(0.0, 0)
                        self._update_shed_rate_locked()
                if self._closed:
                    break
                # batching window: the head-of-line request waits up to
                # max_wait_ms for a fuller batch
                head_t = self._q[0].t_enq
                while (self._rows_queued < self._ladder.max_shape
                       and not self._closed and self._q):
                    remaining = wait_s - (time.perf_counter() - head_t)
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                if self._closed:
                    break
                batch, rows, expired, depth, now = \
                    self._take_batch_locked()
                self._inflight_rows = rows
            for r in expired:
                self._fail_deadline(r, now)
            if batch:
                # crash guard: a broken batch fails ITS futures with a
                # typed error; the dispatcher keeps serving
                try:
                    self._execute(batch, rows, depth)
                except Exception as e:
                    obs.counter("raft.serve.dispatcher.errors").inc()
                    get_logger("serve").error(
                        "dispatcher: batch failed outside the dispatch "
                        "path (crash guard): %r", e)
                    err = (e if isinstance(e, DispatchError) else
                           DispatchError(f"dispatcher error: {e!r}"))
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(err)
            with self._cond:
                # the batch is done (or there was none): a drain() waiter
                # watches this reach zero with an empty queue
                self._inflight_rows = 0
                self._cond.notify_all()
        self._drain_closed()

    # -- dispatch hooks (a distributed tier overrides them) ---------------
    def _plan_for_batch(self, rows: int, level: int):
        """(shape, plan) for a coalesced batch."""
        return self._ladder.plan_for(rows, level)

    def _plan_after_failure(self, shape: int, level: int, err):
        """A replacement plan for the attempt after a
        :class:`ShardFailedError`; None retries the same plan (always,
        on one device)."""
        return None

    def _watchdog_call(self, fn, timeout_s: float):
        if self._worker is None:
            self._worker = _DispatchWorker("raft-serve-watchdog")
        box = self._worker.submit(fn)
        if not box["done"].wait(timeout_s):
            # a running dispatch cannot be cancelled: orphan the helper
            # (it exits once its call returns) and fail typed, retryable
            self._worker.abandoned.set()
            self._worker = None
            obs.counter("raft.serve.dispatch.timeouts.total").inc()
            raise ShardFailedError(
                f"dispatch exceeded dispatch_timeout_ms="
                f"{self._cfg.dispatch_timeout_ms:g}")
        if box["err"] is not None:
            raise box["err"]
        return box["out"]

    def _dispatch(self, plan, qb):
        """One plan execution with the failure conversions applied: a
        watchdog timeout and a comms ``ABORT``/``ERROR`` status both
        become :class:`ShardFailedError`."""
        tag = self._profile_tag

        def call():
            # the thread that runs the plan (the watchdog's helper when
            # it is on) carries the profiler tag
            profiler.tag_dispatch(tag)
            faults.inject("serve.execute", shape=plan.nq)
            with _on_device(plan):
                return plan.search(qb, block=True)

        timeout_s = self._cfg.dispatch_timeout_ms / 1e3
        out = (self._watchdog_call(call, timeout_s) if timeout_s > 0
               else call())
        if not (isinstance(out, tuple) and len(out) == 2):
            # a comms-aware plan may return its stream's status instead
            # of results (duck-typed: no comms import here)
            status = getattr(out, "name", None) or repr(out)
            raise ShardFailedError(
                f"dispatch reported comms status {status}",
                ranks=getattr(out, "ranks", ()))
        return out

    def _execute(self, batch, rows: int, depth: int) -> None:
        cfg = self._cfg
        # profiler attribution: tag the dispatcher thread (one None read
        # when profiling is off)
        profiler.tag_dispatch(self._profile_tag)
        t_start = time.perf_counter()
        head_wait = t_start - min(r.t_enq for r in batch)
        level = self._controller.observe(head_wait, depth)
        shape, plan = self._plan_for_batch(rows, level)
        qb = (batch[0].queries if len(batch) == 1
              else np.concatenate([r.queries for r in batch], axis=0))
        pad = shape - rows
        if pad:
            # duplicated REAL rows stay in-distribution for the measured
            # probe cap; their result rows are sliced off below
            obs.counter("raft.serve.batch.padded_rows").inc(pad)
            reps = -(-pad // rows)
            qb = np.concatenate([qb, np.tile(qb, (reps, 1))[:pad]], axis=0)
        err = None
        dead: set = set()       # ids of requests failed during backoff
        attempt = 0
        with spans.span("raft.serve.batch", shape=shape, rows=rows,
                        requests=len(batch),
                        occupancy=round(rows / shape, 4),
                        n_probes=plan.n_probes, level=level) as bsp:
            spans._add_child_spans(
                "raft.serve.queue_wait",
                ((r.t_enq, t_start - r.t_enq, {"request": idx, "rows": r.nq})
                 for idx, r in enumerate(batch)))
            while True:
                with spans.span("raft.serve.execute", shape=shape,
                                n_probes=plan.n_probes, attempt=attempt):
                    try:
                        d, i = self._dispatch(plan, qb)
                        d, i = _to_numpy(d), _to_numpy(i)
                        err = None
                    except ShardFailedError as e:   # retryable
                        err = e
                    except Exception as e:  # scatter as-is, keep serving
                        err = e
                        bsp.set_attr("error", type(e).__name__)
                        break
                if err is None:
                    if attempt:
                        obs.counter("raft.serve.retry.success.total").inc()
                    break
                bsp.set_attr("error", type(err).__name__)
                nxt = self._plan_after_failure(shape, level, err)
                if nxt is not None:
                    plan = nxt
                if attempt >= cfg.max_retries:
                    obs.counter("raft.serve.retry.exhausted.total").inc()
                    break
                attempt += 1
                backoff = (cfg.retry_backoff_ms / 1e3
                           * cfg.retry_backoff_mult ** (attempt - 1))
                # deadline-aware: a request whose deadline falls inside
                # the backoff fails now, never after its caller stopped
                # waiting
                now = time.perf_counter()
                for r in batch:
                    if (id(r) not in dead and r.deadline is not None
                            and r.deadline <= now + backoff):
                        dead.add(id(r))
                        self._fail_deadline(r, now)
                if len(dead) == len(batch):
                    break       # nobody left waiting for the retry
                obs.counter("raft.serve.retry.total").inc()
                with spans.span("raft.serve.retry", attempt=attempt,
                                backoff_ms=round(backoff * 1e3, 3),
                                error=type(err).__name__):
                    if backoff > 0:
                        time.sleep(backoff)
            if attempt:
                bsp.set_attr("retries", attempt)
        t_done = time.perf_counter()
        exec_dur = t_done - t_start
        obs.counter("raft.serve.batch.total", level=level).inc()
        obs.counter("raft.serve.batch.rows").inc(rows)
        obs.counter("raft.serve.batch.slots").inc(shape)
        obs.histogram("raft.serve.batch.size",
                      buckets=obs.SIZE_BUCKETS).observe(rows)
        obs.histogram("raft.serve.batch.occupancy",
                      buckets=OCCUPANCY_BUCKETS).observe(rows / shape)
        partial = bool(getattr(plan, "partial", False))
        coverage = float(getattr(plan, "coverage", 1.0))
        # quality sampling: one flag read a batch; None means sampling is
        # off and nothing below allocates or runs
        qm = self._quality
        if qm is not None and err is None:
            q_epoch = self._quality_epoch()
            q_excl = self._quality_detail() if partial else ""
        off = 0
        served = []
        # the instruments once a batch, not once a request
        delay_h = obs.histogram("raft.serve.queue.delay.seconds",
                                buckets=SERVE_LATENCY_BUCKETS)
        if err is None:
            latency_h = obs.histogram("raft.serve.request.seconds",
                                      buckets=SERVE_LATENCY_BUCKETS)
            completed = obs.counter("raft.serve.completed.total")
        for r in batch:
            if id(r) in dead:   # already failed with DeadlineExceeded
                off += r.nq
                continue
            wait_s = t_start - r.t_enq
            delay_h.observe(wait_s)
            if err is not None:
                obs.counter("raft.serve.errors.total").inc()
                r.future.set_exception(err)
                continue
            d_r = d[off:off + r.nq, :r.k].copy()
            i_r = i[off:off + r.nq, :r.k].copy()
            off += r.nq
            lat = t_done - r.t_enq
            latency_h.observe(lat)
            completed.inc()
            if partial:
                obs.counter("raft.serve.failover.partial.total").inc()
            r.future.set_result(
                SearchResult(d_r, i_r, partial=True, coverage=coverage)
                if partial else (d_r, i_r))
            served.append((r, wait_s, lat))
            if qm is not None:
                # a Bernoulli draw and a bounded copy on this thread; the
                # exact replay runs on the monitor's thread
                qm.offer(r.queries, i_r, r.k, epoch=q_epoch,
                         coverage=coverage, excluded=q_excl)
        if served and spans.trace_enabled():
            self._record_request_traces(served, t_start, exec_dur, shape,
                                        level, partial, len(batch) > 1)

    @staticmethod
    def _record_request_traces(served, t_start: float, exec_dur: float,
                               shape: int, level: int, partial: bool,
                               shared: bool) -> None:
        """Each served request's root trace: one ``raft.serve.request``
        span over its life (submit to results), its queue wait and the
        shared execution as children. Recorded once every future of the
        batch is set, under one recorder lock a batch, and built only
        when the recorder is read: the dispatcher pays the admission and
        one small object a request."""
        batch = (t_start, exec_dur, shape, level,
                 "partial" if partial else "ok", shared,
                 time.time() - time.perf_counter(), threading.get_ident())
        entries = []
        for r, wait_s, lat in served:
            remote = (spans.parse_traceparent(r.trace_ctx)
                      if r.trace_ctx is not None else None)
            if remote is None and not spans._admit_root():
                continue
            entries.append(recorder._Deferred(
                _request_trace, (r.nq, r.k, r.t_enq, wait_s, lat, remote,
                                 batch), round(lat * 1e3, 3)))
        recorder.RECORDER._record_many(entries)


def _request_trace(nq: int, k: int, t_enq: float, wait_s: float,
                   lat: float, remote, batch) -> dict:
    """One served request's trace out of what the dispatcher kept."""
    t_start, exec_dur, shape, level, outcome, shared, wall0, tid = batch
    return spans._build_root_trace(
        "raft.serve.request", t_enq, lat,
        (("raft.serve.queue_wait", t_enq, wait_s, {}),
         ("raft.serve.execute", t_start, exec_dur,
          {"shape": shape, "shared": shared})),
        remote, wall0, tid,
        {"nq": nq, "k": k, "outcome": outcome, "level": level,
         "batch_shape": shape, "latency_ms": round(lat * 1e3, 3)})


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)

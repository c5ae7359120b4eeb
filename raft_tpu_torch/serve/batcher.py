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
batch with :class:`DispatchError` and keeps serving. Not ported yet:
mutable and tiered indexes, quality sampling, the profiler, fault
injection, the dispatch watchdog and retries, spans.

Threading model: the dispatcher thread owns all device work; caller
threads only touch numpy and futures.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.serve.controller import LoadController
from raft_tpu_torch.serve.ladder import PlanLadder
from raft_tpu_torch.serve.types import (DeadlineExceeded, DispatchError,
                                        RejectedError, ServeConfig,
                                        _Request)

__all__ = ["SearchServer"]


class SearchServer:
    """The serving runtime over one index: ``submit() -> Future`` and a
    blocking ``search()``. Construct with :meth:`from_index`, or from a
    :class:`PlanLadder` directly (tests inject fakes)."""

    # _q, _rows_queued and _closed are shared by caller threads and the
    # dispatcher: touched only under ``self._cond`` or in a
    # ``_locked``-suffix method

    def __init__(self, ladder: PlanLadder,
                 config: Optional[ServeConfig] = None, start: bool = True):
        self._ladder = ladder
        self._cfg = config if config is not None else ServeConfig()
        self._controller = LoadController(len(ladder.rungs), self._cfg)
        self._q: deque = deque()
        self._rows_queued = 0
        self._cond = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        obs.gauge("raft.serve.queue.max").set(self._cfg.max_queue)
        obs.gauge("raft.serve.queue.depth").set(0)
        if start:
            self.start()

    @classmethod
    def from_index(cls, index, rep_queries, k: int, params=None,
                   config: Optional[ServeConfig] = None,
                   start: bool = True) -> "SearchServer":
        """Prepare and warm the (shape x rung) plan ladder for an
        IVF-Flat or IVF-PQ ``index`` and start serving; ``params``
        defaults to the family's ``SearchParams``. ``rep_queries`` is the
        representative cap-measurement sample (as for
        ``plan.build_plan``)."""
        config = config if config is not None else ServeConfig()
        ladder = PlanLadder.build(index, rep_queries, k, params,
                                  shapes=config.batch_sizes,
                                  probes_ladder=config.probes_ladder,
                                  prewarm=config.prewarm)
        return cls(ladder, config, start=start)

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
        self._drain_closed()

    # -- admission ---------------------------------------------------------
    def submit(self, queries, k: Optional[int] = None,
               deadline_ms: Optional[float] = None):
        """Enqueue one request → ``Future`` of ``(dists, ids)``, each
        ``(nq, k)`` numpy. A full queue or a closed server fails the
        future at once with :class:`RejectedError`."""
        q = np.asarray(queries, np.float32)
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
        req = _Request(queries=q, nq=nq, k=k, t_enq=now,
                       deadline=(now + deadline_ms / 1e3
                                 if deadline_ms and deadline_ms > 0
                                 else None))
        obs.counter("raft.serve.requests.total").inc()
        obs.counter("raft.serve.queries.total").inc(nq)
        with self._cond:
            if self._closed:
                self._shed_locked(req, "closed")
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

    # -- internals ---------------------------------------------------------
    def _shed_locked(self, req: _Request, reason: str) -> None:
        obs.counter("raft.serve.shed.total", reason=reason).inc()
        req.future.set_exception(RejectedError(
            f"request rejected ({reason}): queue depth "
            f"{len(self._q)}/{self._cfg.max_queue}"))

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
                        # quality
                        self._controller.observe(0.0, 0)
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
            for r in expired:
                self._fail_deadline(r, now)
            if batch:
                # crash guard: a broken batch fails ITS futures with a
                # typed error; the dispatcher keeps serving
                try:
                    self._execute(batch, rows, depth)
                except Exception as e:
                    obs.counter("raft.serve.dispatcher.errors").inc()
                    err = (e if isinstance(e, DispatchError) else
                           DispatchError(f"dispatcher error: {e!r}"))
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(err)
        self._drain_closed()

    def _execute(self, batch, rows: int, depth: int) -> None:
        t_start = time.perf_counter()
        head_wait = t_start - min(r.t_enq for r in batch)
        level = self._controller.observe(head_wait, depth)
        shape, plan = self._ladder.plan_for(rows, level)
        qb = (batch[0].queries if len(batch) == 1
              else np.concatenate([r.queries for r in batch], axis=0))
        pad = shape - rows
        if pad:
            # duplicated REAL rows stay in-distribution for the measured
            # probe cap; their result rows are sliced off below
            obs.counter("raft.serve.batch.padded_rows").inc(pad)
            reps = -(-pad // rows)
            qb = np.concatenate([qb, np.tile(qb, (reps, 1))[:pad]], axis=0)
        try:
            d, i = plan.search(qb, block=True)
            d, i = _to_numpy(d), _to_numpy(i)
            err = None
        except Exception as e:  # scatter as-is, keep serving
            err = e
        obs.counter("raft.serve.batch.total", level=level).inc()
        obs.counter("raft.serve.batch.rows").inc(rows)
        obs.counter("raft.serve.batch.slots").inc(shape)
        off = 0
        for r in batch:
            if err is not None:
                obs.counter("raft.serve.errors.total").inc()
                r.future.set_exception(err)
                continue
            d_r = d[off:off + r.nq, :r.k].copy()
            i_r = i[off:off + r.nq, :r.k].copy()
            off += r.nq
            obs.counter("raft.serve.completed.total").inc()
            r.future.set_result((d_r, i_r))


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)

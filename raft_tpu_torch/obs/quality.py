"""Online quality observability: shadow-exact recall estimation
(counterpart of ``raft_tpu.obs.quality``).

The serving stack counts speed and availability (``raft.serve.*``);
this module measures what recall live traffic gets:

* the batcher **reservoir-samples** served queries at
  ``ServeConfig.quality_sample_rate`` (``SearchServer.enable_quality``
  attaches a :class:`QualityMonitor`);
* a **background shadow thread** (``raft-obs-quality``) replays the
  sampled queries, off the serving path and never in a batch slot,
  through an :class:`ExactScorer` (brute force over the corpus in fixed
  chunks, or over a bounded seeded sample of it past ``max_rows``) and
  compares the served ids with the exact ids;
* windowed per-query recall lands in
  ``raft.obs.quality.recall{family,epoch}`` gauges; answers of a
  partial plan are attributed separately (``coverage=partial,
  excluded=<ranks>``);
* an optional cheap **estimator** runs on the same samples and
  ``raft.obs.quality.calibration.gap`` = shadow recall − estimator
  recall;
* recall is tracked **per epoch**: when the epoch rolls
  (:meth:`QualityMonitor.note_epoch`, or a sample tagged with a newer
  epoch), the previous epoch's windowed mean becomes the baseline, and
  ``raft.obs.quality.drift`` fires (gauge + ``.drift.total``) the moment
  the new epoch's recall falls strictly more than ``drift_budget``
  below it.

The same samples give the same numbers as the JAX package: the
Bernoulli draws and the algorithm-R reservoir take one
``random.Random(seed)`` stream, and the scorer's bounded sample is the
same ``np.random.default_rng(seed).choice``.

Hot-path contract: with sampling off the batcher reads one flag
(``SearchServer._quality is None``); with sampling on, the dispatcher
thread only draws and copies. On the card the scorer's tiles are full
fp32 ``torch.matmul`` products (no TF32) and their selects run kernel 2
(``neighbors/selection.select_k``, ``csrc/radix_select.cuh``), whose ties
go to the lower column as ``lax.top_k``'s do; :meth:`ExactScorer.warm`
runs one tile at construction, so kernel 2's library is loaded before
serving and the shadow thread never builds a kernel (the port's form of
the JAX package's "zero steady-state compiles"). The shadow thread runs
the scorer under ``torch.cuda.device(scorer.device)`` (the current
device is per thread) on a stream of its own, so its tiles do not queue
behind the served batches on the default stream; each tile's results
reach the host through a blocking copy on that stream.

Each shadow batch is a ``raft.obs.quality.shadow`` span (``family``,
``queries``, ``kmax``) on the shadow thread. A server over a
:class:`~raft_tpu_torch.mutate.MutableIndex` subscribes
:meth:`QualityMonitor.note_epoch` to its compactions' epoch swaps
(``SearchServer.attach_quality``), so each fold rolls the epoch.

Caveats, as in the JAX package: past ``max_rows`` the "exact" ids are
exact over the sample, so the recall gauge is an estimator; the
``epoch`` label is bounded by the registry's series cap
(``RAFT_TPU_METRICS_MAX_SERIES``), past which new epoch series are
dropped with one warning.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import selection
from raft_tpu_torch.obs import spans
from raft_tpu_torch.obs.registry import CardinalityError
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.util.host import host_array

__all__ = ["ExactScorer", "QualityConfig", "QualityMonitor",
           "corpus_from_index"]

# metrics whose ranking the scorer reproduces exactly
_L2_KINDS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded)


def _score_chunk(q: torch.Tensor, rows: torch.Tensor, norms: torch.Tensor,
                 kind: str, kmax: int):
    """One (batch, chunk) exact scoring tile → (top-kmax dists, chunk-local
    columns). Full-fp32 dot products; L2 in the expanded form with the
    query norm dropped (rank-invariant per query); similarities negated
    so that ascending is best for every kind. Pad rows carry +inf norms,
    so they can never be chosen over a real row. The select is
    ``select_k`` (kernel 2 on the card); a chunk narrower than
    ``2 * kmax``, which ``select_k`` would hand to ``torch.topk`` (no tie
    order), takes a stable sort instead, so that ties go to the lower
    column as ``lax.top_k``'s do."""
    full_fp32_matmul()
    dots = torch.matmul(q, rows.T)
    if kind == "l2":
        d = norms[None, :] - 2.0 * dots
    else:  # ip / cosine (corpus normalised beforehand for cosine)
        d = torch.where(torch.isinf(norms)[None, :],
                        torch.full_like(dots, float("inf")), -dots)
    if selection._use_kernel(d, kmax):
        return selection.select_k(d, kmax, select_min=True)
    return stable_topk_min(d, kmax)


class ExactScorer:
    """Fixed-shape exact brute-force scorer: the shadow ground truth.
    Every (batch x chunk) tile has one shape, so one kernel
    configuration scores any corpus size by tiling.

    ``corpus`` is host rows ``(n, dim)``; ``ids`` maps row → global id
    (default ``arange``). Past ``max_rows`` a seeded sample is scored
    instead (``self.sampled`` says so). The chunks live on ``device``
    (default ``cuda``)."""

    def __init__(self, corpus, ids=None,
                 metric: DistanceType = DistanceType.L2Expanded,
                 kmax: int = 64, max_rows: int = 1 << 18,
                 chunk: int = 1 << 16, batch: int = 32, seed: int = 0,
                 warm: bool = True, device="cuda"):
        x = np.ascontiguousarray(host_array(corpus, np.float32))
        expects(x.ndim == 2 and x.shape[0] > 0,
                "ExactScorer: corpus must be a non-empty (n, dim) "
                "array, got %s", x.shape)
        n, dim = x.shape
        row_ids = (np.arange(n, dtype=np.int64) if ids is None
                   else host_array(ids, np.int64))
        expects(row_ids.shape == (n,),
                "ExactScorer: ids must be (n=%d,), got %s", n,
                row_ids.shape)
        self.device = Resources(device).device
        self.sampled = n > max_rows
        if self.sampled:
            sel = np.sort(np.random.default_rng(seed).choice(
                n, size=max_rows, replace=False))
            x, row_ids, n = x[sel], row_ids[sel], max_rows
        if metric == DistanceType.CosineExpanded:
            self._kind = "cos"
            nrm = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(nrm, 1e-30)
        elif metric == DistanceType.InnerProduct:
            self._kind = "ip"
        else:
            expects(metric in _L2_KINDS,
                    "ExactScorer: unsupported metric %s (l2 family, ip "
                    "or cosine)", metric)
            self._kind = "l2"
        self.metric = metric
        self.dim = dim
        self.rows = n
        self.batch = int(batch)
        self.kmax = int(min(kmax, n))
        chunk = int(min(chunk, 1 << 20))
        n_chunks = -(-n // chunk)
        chunk = min(chunk, n) if n_chunks == 1 else chunk
        self._k_tile = int(min(self.kmax, chunk))
        pad = n_chunks * chunk - n
        if pad:
            x = np.concatenate([x, np.zeros((pad, dim), np.float32)])
            row_ids = np.concatenate(
                [row_ids, np.full((pad,), -1, np.int64)])
        # per-row scoring norms: ||row||^2 for l2 (the query norm is
        # dropped), 0 for similarities; +inf marks the pad rows
        norms = (np.einsum("cd,cd->c", x, x) if self._kind == "l2"
                 else np.zeros((n_chunks * chunk,), np.float32))
        norms = norms.astype(np.float32)
        norms[n:] = np.inf
        self._ids = row_ids.reshape(n_chunks, chunk)
        self._chunks = [
            torch.from_numpy(x[c * chunk:(c + 1) * chunk]).to(self.device)
            for c in range(n_chunks)]
        self._norms = [
            torch.from_numpy(norms[c * chunk:(c + 1) * chunk]).to(
                self.device) for c in range(n_chunks)]
        if warm:
            self.warm()

    def warm(self) -> "ExactScorer":
        """Run one (batch x chunk) tile now: on the card this loads kernel
        2's library before serving, so the shadow thread never builds a
        kernel (every chunk shares the shape)."""
        z = np.zeros((self.batch, self.dim), np.float32)
        self.topk(z, min(2, self.kmax))
        return self

    def topk(self, queries, k: int) -> np.ndarray:
        """Exact top-``k`` global ids for ``queries`` → ``(nq, k)`` int64.
        Tiles queries to the fixed ``batch`` shape and the corpus to
        fixed chunks; merges the chunk winners on the host."""
        q = host_array(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        expects(q.shape[1] == self.dim,
                "ExactScorer.topk: queries must be (nq, dim=%d), got "
                "%s", self.dim, q.shape)
        k = int(min(k, self.kmax))
        expects(k > 0, "ExactScorer.topk: k must be >= 1")
        if self._kind == "cos":
            q = q / np.maximum(
                np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        nq = q.shape[0]
        out = np.empty((nq, k), np.int64)
        n_chunks = len(self._chunks)
        for s in range(0, nq, self.batch):
            qb = q[s:s + self.batch]
            pad = self.batch - qb.shape[0]
            if pad:
                qb = np.concatenate([qb, np.tile(qb[:1], (pad, 1))])
            qt = torch.from_numpy(np.ascontiguousarray(qb)).to(self.device)
            ds, cs = [], []
            for rows, norms in zip(self._chunks, self._norms):
                d, i = _score_chunk(qt, rows, norms, self._kind,
                                    self._k_tile)
                ds.append(d)
                cs.append(i)
            # one copy to the host a tile: the chunk winners (a blocking
            # copy on the current stream, so the results are complete)
            d_all = torch.cat(ds, dim=1).cpu().numpy()
            c_all = torch.cat(cs, dim=1).cpu().numpy().reshape(
                self.batch, n_chunks, self._k_tile)
            # chunk-local columns → global ids; an empty slot (-1, +inf)
            # maps to id -1, as a pad row's does
            g_all = np.where(
                c_all >= 0,
                self._ids[np.arange(n_chunks)[None, :, None],
                          np.maximum(c_all, 0)], -1).reshape(self.batch, -1)
            order = np.argsort(d_all, axis=1, kind="stable")[:, :k]
            ids_b = np.take_along_axis(g_all, order, axis=1)
            out[s:s + self.batch - pad] = ids_b[:self.batch - pad]
        return out


def corpus_from_index(index) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows, ids)`` of an IVF-Flat index's lists, on the host (the
    usual ``enable_quality`` source when the caller no longer holds the
    build-time corpus): bf16 rows widened to f32, int8 rows times the
    index's ``scale``. Raw-vector lists only; PQ/BQ callers pass the
    original rows."""
    valid = index.lists_indices >= 0
    data = index.lists_data[valid]
    if data.dtype == torch.bfloat16:
        data = data.float()
    rows = data.cpu().numpy().astype(np.float32, copy=False)
    if getattr(index, "scale", None) is not None:
        rows = rows * np.float32(index.scale)
    ids = index.lists_indices[valid].cpu().numpy()
    return rows, ids.astype(np.int64)


@dataclass(frozen=True)
class QualityConfig:
    """Shadow-path knobs of a :class:`QualityMonitor` (the JAX package's
    names and defaults).

    * ``window`` — per-(epoch, coverage) rolling window of per-query
      recalls behind each gauge; ``min_window`` samples must accumulate
      before the drift comparison speaks.
    * ``max_pending`` — the reservoir bound between shadow drains;
      further samples reservoir-replace uniformly
      (``raft.obs.quality.evicted.total`` counts them).
    * ``shadow_batch`` / ``chunk`` / ``max_rows`` — the
      :class:`ExactScorer` tile shapes.
    * ``drift_budget`` — an epoch whose windowed recall falls MORE than
      this below the previous epoch's baseline fires
      ``raft.obs.quality.drift``.
    * ``poll_ms`` — the shadow thread's wake cadence when idle.
    """

    window: int = 256
    min_window: int = 16
    max_pending: int = 256
    shadow_batch: int = 32
    chunk: int = 1 << 16
    max_rows: int = 1 << 18
    drift_budget: float = 0.05
    poll_ms: float = 50.0
    seed: int = 0

    def __post_init__(self):
        if self.window < 1 or self.min_window < 1 \
                or self.max_pending < 1:
            raise ValueError("QualityConfig: window, min_window and "
                             "max_pending must be >= 1")
        if not 0.0 < self.drift_budget < 1.0:
            raise ValueError("QualityConfig: drift_budget must be in "
                             "(0, 1)")


class QualityMonitor:
    """Reservoir-sampled live queries, shadow-scored exactly on a
    background thread, folded into windowed ``raft.obs.quality.*``
    gauges. Construct with any scorer exposing ``.topk(queries, k) ->
    (nq, k) ids`` (tests plant fakes); attach to a server with
    :meth:`raft_tpu_torch.serve.SearchServer.enable_quality`.

    ``estimator`` (optional, ``fn(queries, k) -> ids``) is a cheap recall
    estimator to calibrate; it runs on the shadow thread over the same
    samples and ``raft.obs.quality.calibration.gap`` publishes shadow −
    estimator recall."""

    # the dispatcher thread (offer), the shadow thread (_loop/_process)
    # and note_epoch's caller meet on these fields: touch them only
    # under ``with self._cond`` or in a ``_locked``-suffix method
    GUARDED_BY = ("_pending", "_streamed", "_inflight", "_closed",
                  "_windows", "_est_windows", "_epoch", "_baseline",
                  "_alarmed", "_samples_total")

    def __init__(self, scorer, sample_rate: float,
                 config: Optional[QualityConfig] = None,
                 family: str = "index",
                 estimator: Optional[Callable] = None,
                 start: bool = True):
        expects(0.0 < sample_rate <= 1.0,
                "QualityMonitor: sample_rate must be in (0, 1], got "
                "%s (rate 0 means: do not construct a monitor)",
                sample_rate)
        self.cfg = config if config is not None else QualityConfig()
        self.scorer = scorer
        self.rate = float(sample_rate)
        self.family = str(family)
        self._estimator = estimator
        self._rng = random.Random(self.cfg.seed)
        self._cond = threading.Condition()
        self._pending: List[tuple] = []
        self._streamed = 0          # reservoir stream length since drain
        self._inflight = False
        self._closed = False
        self._windows: Dict[tuple, deque] = {}
        self._est_windows: Dict[tuple, deque] = {}
        self._epoch = 0
        self._baseline: Optional[Tuple[int, float]] = None
        self._alarmed: set = set()
        self._card_warned = False
        self._samples_total = 0
        # the shadow thread's CUDA stream (made on first use, for a scorer
        # on the card): its tiles never queue behind served batches
        self._stream = None
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "QualityMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="raft-obs-quality")
            self._thread.start()
        return self

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self) -> "QualityMonitor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- sampling (dispatcher thread) --------------------------------------
    def offer(self, queries, ids, k: int, epoch: int = 0,
              coverage: float = 1.0, excluded: str = "") -> None:
        """Sample served queries into the reservoir (called by the batcher
        on its dispatcher thread: a Bernoulli draw per query, then a
        bounded copy; never any device work). ``coverage`` < 1 flags a
        partial plan's answer: those samples land in coverage-attributed
        series and never touch the full-coverage drift baseline."""
        # a racy read on purpose: a sample racing close() is dropped
        # either way
        if self._closed:
            return
        rng, rate = self._rng, self.rate
        q = np.asarray(queries)
        take = [j for j in range(q.shape[0]) if rng.random() < rate]
        if not take:
            return
        served = np.asarray(ids)
        k = int(k)
        obs.counter("raft.obs.quality.sampled.total").inc(len(take))
        cap = self.cfg.max_pending
        with self._cond:
            for j in take:
                rec = (q[j].astype(np.float32, copy=True),
                       served[j, :k].astype(np.int64, copy=True),
                       k, int(epoch), float(coverage), str(excluded))
                self._streamed += 1
                if len(self._pending) < cap:
                    self._pending.append(rec)
                else:
                    # algorithm R: uniform over the stream since the last
                    # shadow drain, so a burst can neither grow memory nor
                    # bias the reservoir toward its tail
                    j = rng.randrange(self._streamed)
                    if j < cap:
                        self._pending[j] = rec
                    obs.counter("raft.obs.quality.evicted.total").inc()
            self._cond.notify()

    def note_epoch(self, epoch: int) -> None:
        """Roll the drift baseline at an epoch boundary (samples tagged
        with a newer epoch roll it too)."""
        with self._cond:
            self._roll_epoch_locked(int(epoch))

    # -- results -----------------------------------------------------------
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every pending sample has been shadow-scored → False
        on timeout."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._pending or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    def stats(self) -> dict:
        """The current window's summary."""
        with self._cond:
            cur = self._windows.get((self._epoch, "full", ""))
            est = self._est_windows.get((self._epoch, "full", ""))
            out = {
                "epoch": self._epoch,
                "samples": self._samples_total,
                "window": len(cur) if cur else 0,
                "recall": (round(float(np.mean(cur)), 4)
                           if cur else None),
            }
            if est:
                out["estimator_recall"] = round(float(np.mean(est)), 4)
                if cur:
                    out["calibration_gap"] = round(
                        float(np.mean(cur)) - float(np.mean(est)), 4)
            if self._baseline is not None and cur \
                    and len(cur) >= self.cfg.min_window:
                out["drift"] = round(
                    self._baseline[1] - float(np.mean(cur)), 4)
                out["drift_alarm"] = self._epoch in self._alarmed
            return out

    # -- shadow thread -----------------------------------------------------
    def _loop(self) -> None:
        poll = self.cfg.poll_ms / 1e3
        log = get_logger("obs")
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait(timeout=poll)
                if self._closed and not self._pending:
                    return
                batch = self._pending
                self._pending = []
                self._streamed = 0
                self._inflight = True
            try:
                self._process(batch)
            except Exception as e:
                obs.counter("raft.obs.quality.errors.total").inc()
                log.warning("quality: shadow batch failed (%d samples "
                            "dropped): %r", len(batch), e)
            finally:
                with self._cond:
                    self._inflight = False
                    self._cond.notify_all()

    def _on_scorer_device(self) -> contextlib.ExitStack:
        """For a scorer on the card: its device as this thread's current
        device (the current device is per thread) and the shadow stream
        as the current stream. A no-op for CPU and fake scorers."""
        ctx = contextlib.ExitStack()
        dev = getattr(self.scorer, "device", None)
        if getattr(dev, "type", None) == "cuda":
            ctx.enter_context(torch.cuda.device(dev))
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _process(self, batch: List[tuple]) -> None:
        rows = np.stack([s[0] for s in batch])
        kmax = max(s[2] for s in batch)
        with self._on_scorer_device(), \
                spans.span("raft.obs.quality.shadow", family=self.family,
                           queries=len(batch), kmax=kmax):
            exact = np.asarray(self.scorer.topk(rows, kmax))
            est = (np.asarray(self._estimator(rows, kmax))
                   if self._estimator is not None else None)
        obs.counter("raft.obs.quality.shadow.total",
                    family=self.family).inc()
        obs.counter("raft.obs.quality.samples.total").inc(len(batch))
        with self._cond:
            for i, (_q, served, k, epoch, coverage, excl) in \
                    enumerate(batch):
                if epoch > self._epoch:
                    self._roll_epoch_locked(epoch)
                ex = set(int(v) for v in exact[i, :k] if v >= 0)
                r = (len(ex.intersection(int(v) for v in served))
                     / max(1, len(ex) if len(ex) < k else k))
                cov = "full" if coverage >= 1.0 else "partial"
                key = (epoch, cov, excl if cov == "partial" else "")
                self._win(self._windows, key).append(r)
                if est is not None:
                    e_ids = set(int(v) for v in est[i, :k] if v >= 0)
                    self._win(self._est_windows, key).append(
                        len(ex & e_ids)
                        / max(1, len(ex) if len(ex) < k else k))
            self._samples_total += len(batch)
            self._update_gauges_locked()

    def _win(self, table: Dict[tuple, deque], key: tuple) -> deque:
        w = table.get(key)
        if w is None:
            w = table[key] = deque(maxlen=self.cfg.window)
        return w

    def _roll_epoch_locked(self, epoch: int) -> None:
        if epoch <= self._epoch:
            return
        prev = self._windows.get((self._epoch, "full", ""))
        if prev is not None and len(prev) >= self.cfg.min_window:
            # the outgoing epoch's settled window becomes the baseline; a
            # short-lived epoch keeps the older one
            self._baseline = (self._epoch, float(np.mean(prev)))
        self._epoch = epoch
        obs.gauge("raft.obs.quality.drift.alarm",
                  family=self.family).set(0.0)

    def _update_gauges_locked(self) -> None:
        try:
            self._publish_locked()
        except CardinalityError:
            # the epoch label is the only unbounded one: past the
            # registry's cap new epoch series are dropped, loudly once
            if not self._card_warned:
                self._card_warned = True
                get_logger("obs").warning(
                    "quality: raft.obs.quality.* label cardinality "
                    "cap hit — raise RAFT_TPU_METRICS_MAX_SERIES or "
                    "restart the monitor; further epoch series are "
                    "dropped")

    def _publish_locked(self) -> None:
        for (epoch, cov, excl), win in self._windows.items():
            if not win:
                continue
            labels = {"family": self.family, "epoch": str(epoch)}
            if cov == "partial":
                labels["coverage"] = "partial"
                if excl:
                    labels["excluded"] = excl
            obs.gauge("raft.obs.quality.recall", **labels).set(
                float(np.mean(win)))
        cur = self._windows.get((self._epoch, "full", ""))
        est = self._est_windows.get((self._epoch, "full", ""))
        if est:
            obs.gauge("raft.obs.quality.estimator.recall",
                      family=self.family,
                      epoch=str(self._epoch)).set(float(np.mean(est)))
            if cur:
                obs.gauge("raft.obs.quality.calibration.gap",
                          family=self.family).set(
                    float(np.mean(cur)) - float(np.mean(est)))
        obs.gauge("raft.obs.quality.window.samples",
                  family=self.family).set(len(cur) if cur else 0)
        if self._baseline is None or not cur \
                or len(cur) < self.cfg.min_window:
            return
        drift = self._baseline[1] - float(np.mean(cur))
        obs.gauge("raft.obs.quality.drift", family=self.family).set(
            drift)
        if drift > self.cfg.drift_budget:
            if self._epoch not in self._alarmed:
                self._alarmed.add(self._epoch)
                obs.counter("raft.obs.quality.drift.total",
                            family=self.family).inc()
                get_logger("obs").warning(
                    "quality: epoch %d recall drifted %.4f below the "
                    "epoch-%d baseline (budget %.4f)", self._epoch, drift,
                    self._baseline[0], self.cfg.drift_budget)
            obs.gauge("raft.obs.quality.drift.alarm",
                      family=self.family).set(1.0)
        elif self._epoch not in self._alarmed:
            obs.gauge("raft.obs.quality.drift.alarm",
                      family=self.family).set(0.0)

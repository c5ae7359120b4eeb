"""Serving-runtime types: config, request record, typed errors and the
result tuple (counterpart of ``raft_tpu.serve.types``; stdlib only).

Not ported yet: the distributed failover (``failover``, ROADMAP.md
queue 1 item 6) and quality sampling (``quality_sample_rate``, item
4b). ``ServeConfig`` takes their fields with the JAX package's defaults
and raises ``NotImplementedError`` on any other value.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["DeadlineExceeded", "DispatchError", "RejectedError",
           "SearchResult", "ServeConfig", "ShardFailedError"]


class RejectedError(RuntimeError):
    """The request was refused admission (queue full, or the server is
    closed): nothing was enqueued and nothing will run."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired: while it waited in the queue (it
    was dropped without occupying a batch slot), or while a failed
    dispatch backed off before its retry (a retry never runs past the
    deadline)."""


class DispatchError(RuntimeError):
    """A batch could not be completed; every request in it resolves
    with this error and the dispatcher keeps serving."""


class ShardFailedError(DispatchError):
    """A dispatch failed in a way that implicates a participant: the
    watchdog timed it out (``dispatch_timeout_ms``), or the plan
    reported a comms status (``ABORT``/``ERROR``) instead of results.
    Retryable, within ``max_retries`` and the request's deadline.
    ``ranks`` names the suspect participants when known (else ``()``).
    """

    def __init__(self, message: str, ranks=()):
        super().__init__(message)
        self.ranks = tuple(ranks)


class SearchResult(tuple):
    """``(dists, ids)`` with failure-handling metadata: a 2-tuple, so
    ``d, i = result`` keeps working; a degraded partial-mesh answer
    carries ``partial=True`` and ``coverage``, the share of the corpus
    (by rows) its healthy shards searched."""

    def __new__(cls, dists, ids, partial: bool = False,
                coverage: float = 1.0):
        self = super().__new__(cls, (dists, ids))
        self.partial = bool(partial)
        self.coverage = float(coverage)
        return self

    @property
    def dists(self):
        return self[0]

    @property
    def ids(self):
        return self[1]


@dataclass(frozen=True)
class ServeConfig:
    """Operating contract of a :class:`~raft_tpu_torch.serve.SearchServer`.

    * ``batch_sizes`` — the plan-shape ladder (ascending nq); a ragged
      batch is padded with duplicated real rows (results discarded).
    * ``max_queue`` — bounded queue depth (requests); over it,
      submissions fail at once with :class:`RejectedError`.
    * ``max_wait_ms`` — how long the head-of-line request may wait for
      a fuller batch.
    * ``default_deadline_ms`` — deadline for requests that pass none;
      0 = none. Expired requests complete with :class:`DeadlineExceeded`.
    * ``probes_ladder`` — degradation rungs, descending ``n_probes``
      (rung 0 = full quality); empty = the params' ``n_probes`` only.
    * ``degrade_watermark_ms`` / ``degrade_trigger_frac`` /
      ``upgrade_watermark_ms`` / ``degrade_cooldown_ms`` — the load
      controller steps down the ladder when head-of-line delay passes
      ``trigger_frac`` of the watermark, back up below the upgrade
      watermark, at most once per cooldown.
    * ``prewarm`` — prepare and run every (shape x rung) plan at
      construction.
    * ``dispatch_timeout_ms`` — the dispatch watchdog: a dispatch that
      runs longer is abandoned and fails with :class:`ShardFailedError`;
      0 runs the dispatch inline on the dispatcher thread.
    * ``max_retries`` / ``retry_backoff_ms`` / ``retry_backoff_mult`` —
      the retry budget of a batch that failed with
      :class:`ShardFailedError`, with exponential backoff; a request
      whose deadline falls inside the backoff fails at once with
      :class:`DeadlineExceeded`.
    * ``failover``, ``failover_probe_ms``, ``quality_sample_rate`` —
      the JAX package's partial-mesh failover and quality sampling:
      only their defaults (off) are ported.
    """

    batch_sizes: Tuple[int, ...] = (1, 8, 32, 128)
    max_queue: int = 256
    max_wait_ms: float = 2.0
    default_deadline_ms: float = 0.0
    probes_ladder: Tuple[int, ...] = ()
    degrade_watermark_ms: float = 200.0
    degrade_trigger_frac: float = 0.5
    upgrade_watermark_ms: float = 20.0
    degrade_cooldown_ms: float = 50.0
    prewarm: bool = True
    dispatch_timeout_ms: float = 0.0
    max_retries: int = 0
    retry_backoff_ms: float = 10.0
    retry_backoff_mult: float = 2.0
    failover: bool = False
    failover_probe_ms: float = 1000.0
    quality_sample_rate: float = 0.0

    def __post_init__(self):
        if not self.batch_sizes or list(self.batch_sizes) != sorted(
                set(int(s) for s in self.batch_sizes)):
            raise ValueError("ServeConfig.batch_sizes must be distinct "
                             "ascending positive ints")
        if min(self.batch_sizes) < 1:
            raise ValueError("ServeConfig.batch_sizes entries must be >= 1")
        if self.max_queue < 1:
            raise ValueError("ServeConfig.max_queue must be >= 1")
        if self.probes_ladder and list(self.probes_ladder) != sorted(
                set(self.probes_ladder), reverse=True):
            raise ValueError("ServeConfig.probes_ladder must be strictly "
                             "descending n_probes values (rung 0 first)")
        if not 0.0 < self.degrade_trigger_frac <= 1.0:
            raise ValueError("ServeConfig.degrade_trigger_frac must be "
                             "in (0, 1]")
        if self.dispatch_timeout_ms < 0 or self.max_retries < 0:
            raise ValueError("ServeConfig: dispatch_timeout_ms and "
                             "max_retries must be >= 0")
        if self.retry_backoff_ms < 0 or self.retry_backoff_mult < 1.0:
            raise ValueError("ServeConfig: retry_backoff_ms must be >= 0 "
                             "and retry_backoff_mult >= 1.0")
        if not 0.0 <= self.quality_sample_rate <= 1.0:
            raise ValueError("ServeConfig: quality_sample_rate must be "
                             "in [0, 1]")
        if self.failover:
            raise NotImplementedError(
                "ServeConfig: the partial-mesh failover is not ported yet "
                "(ROADMAP.md queue 1 item 6)")
        if self.quality_sample_rate > 0:
            raise NotImplementedError(
                "ServeConfig: quality sampling is not ported yet "
                "(ROADMAP.md queue 1 item 4b)")


@dataclass
class _Request:
    """One queued search request (internal)."""

    queries: object                     # np.ndarray (nq, dim) float32
    nq: int
    k: int
    future: Future = field(default_factory=Future)
    t_enq: float = 0.0                  # perf_counter at admission
    deadline: Optional[float] = None    # absolute perf_counter, or None

"""Serving-runtime types: config, request record, typed errors
(counterpart of ``raft_tpu.serve.types``; stdlib only).

Not ported yet: the dispatch watchdog and retries
(``dispatch_timeout_ms``, ``max_retries``, ``ShardFailedError``), the
distributed failover (``failover``) and quality sampling
(``quality_sample_rate``).
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["DeadlineExceeded", "DispatchError", "RejectedError",
           "ServeConfig"]


class RejectedError(RuntimeError):
    """The request was refused admission (queue full, or the server is
    closed): nothing was enqueued and nothing will run."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired while it waited in the queue; it
    was dropped without occupying a batch slot."""


class DispatchError(RuntimeError):
    """A batch could not be completed; every request in it resolves
    with this error and the dispatcher keeps serving."""


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


@dataclass
class _Request:
    """One queued search request (internal)."""

    queries: object                     # np.ndarray (nq, dim) float32
    nq: int
    k: int
    future: Future = field(default_factory=Future)
    t_enq: float = 0.0                  # perf_counter at admission
    deadline: Optional[float] = None    # absolute perf_counter, or None

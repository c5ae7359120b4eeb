"""Background compactor: folds the delta into the main lists while the
index keeps serving (counterpart of ``raft_tpu.mutate.compactor``).

One daemon thread polls :meth:`MutableIndex.should_compact` (delta slots
past ``compact_trigger_frac`` of the top rung) and runs
:meth:`MutableIndex.compact` when it trips: the fold, the next epoch's
warm-up and the swap all happen on THIS thread, under
``torch.cuda.device`` of the index (the current device is per thread);
the serving dispatcher only ever swaps a reference. ``trigger()`` forces
a fold on the next wakeup whatever the fill.

Crash-loop guard: the WHOLE iteration body, the ``should_compact`` poll
included, is guarded. A failed attempt is counted
(``raft.mutate.compactor.errors``), the poll interval backs off
exponentially (a poisoned fold must not busy-loop the machine), and after
``fail_threshold`` consecutive failures the
``raft.mutate.compactor.failing`` gauge says so: a compactor that cannot
fold means the delta WILL hit its
:class:`~raft_tpu_torch.mutate.DeltaFullError` wall. The serving state is
untouched by a failed attempt (the swap is compact()'s last step), and
the first success clears the gauge and resets the backoff.
"""

from __future__ import annotations

import threading
from typing import Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.mutate.mutable import _on_device

__all__ = ["Compactor"]


class Compactor:
    """Owns the compaction thread of one
    :class:`~raft_tpu_torch.mutate.MutableIndex`. Context-manager
    friendly; ``close()`` joins the thread (an in-flight fold finishes
    first: the swap is what frees the delta)."""

    # static race contract: the trigger flag and the shutdown flag sit on
    # the caller/compactor thread boundary
    GUARDED_BY = ("_closed", "_force")

    def __init__(self, mindex, mode: Optional[str] = None, mesh=None,
                 axis: str = "data", poll_ms: Optional[float] = None,
                 fail_threshold: int = 3, backoff_mult: float = 2.0,
                 max_backoff_s: float = 5.0, start: bool = True):
        self._m = mindex
        self._mode = mode
        self._mesh = mesh
        self._axis = axis
        self._poll_s = (poll_ms if poll_ms is not None
                        else mindex.cfg.compact_poll_ms) / 1e3
        self._fail_threshold = max(1, int(fail_threshold))
        self._backoff_mult = max(1.0, float(backoff_mult))
        self._max_backoff_s = float(max_backoff_s)
        self._cond = threading.Condition()
        self._closed = False
        self._force = False
        self._thread: Optional[threading.Thread] = None
        obs.gauge("raft.mutate.compactor.failing").set(0)
        if start:
            self.start()

    def start(self) -> "Compactor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="raft-mutate-compactor")
            self._thread.start()
        return self

    def trigger(self) -> None:
        """Force a fold on the next wakeup (without waiting for the fill
        trigger)."""
        with self._cond:
            self._force = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            self._thread = None

    def __enter__(self) -> "Compactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _wait_s(self, consecutive_failures: int) -> float:
        """Poll interval with exponential backoff while failing."""
        if consecutive_failures <= 0:
            return self._poll_s
        return min(self._poll_s
                   * self._backoff_mult ** consecutive_failures,
                   self._max_backoff_s)

    def _loop(self) -> None:
        log = get_logger("mutate")
        consec = 0
        while True:
            with self._cond:
                if self._closed:
                    break
                self._cond.wait(timeout=self._wait_s(consec))
                if self._closed:
                    break
                force, self._force = self._force, False
            # crash-loop guard: everything the iteration does is inside
            # the try, so one exception cannot stall the delta at its top
            # rung forever
            try:
                if not (force or self._m.should_compact()):
                    continue
                with _on_device(self._m.device):
                    self._m.compact(mode=self._mode, mesh=self._mesh,
                                    axis=self._axis)
                if consec:
                    log.warn("compactor recovered after %d failed "
                             "attempt(s)", consec)
                consec = 0
                obs.gauge("raft.mutate.compactor.failing").set(0)
            except Exception as e:
                consec += 1
                obs.counter("raft.mutate.compactor.errors").inc()
                if consec >= self._fail_threshold:
                    obs.gauge("raft.mutate.compactor.failing").set(1)
                log.warn(
                    "compaction failed (attempt %d, next retry in "
                    "%.3gs): %r", consec, self._wait_s(consec), e)

"""Load controller: graceful degradation + the overload verdict
(counterpart of ``raft_tpu.serve.controller``).

Above a queue-delay watermark the server is past its saturation point;
queuing theory says the backlog (and p99) then grows without bound
unless either admission drops (shed) or service time shrinks. The
controller shrinks service time first: it steps ``n_probes`` down a
configured ladder (recall degrades slightly, batches finish faster),
and steps back up when the queue drains — so p99 of *accepted*
requests stays under the watermark while overload lasts, at the price
of a measured recall step instead of unbounded latency.

Every decision is counted (``raft.serve.degrade.steps`` by direction)
and exported as gauges (``raft.serve.overloaded``,
``raft.serve.degrade.level``).
"""

from __future__ import annotations

import time

from raft_tpu_torch import obs
from raft_tpu_torch.serve.types import ServeConfig

__all__ = ["LoadController"]


class LoadController:
    """Steps the degradation ladder from observed head-of-line queue
    delay. Single-writer (the dispatcher thread); readers go through
    the exported gauges."""

    # GL003 contract: no lock because there is no sharing — `level` /
    # `_last_step` are written ONLY by the dispatcher thread
    # (SearchServer._loop/_execute call observe()); every other thread
    # reads through the exported gauges. Adding a field that another
    # thread writes means adding a lock AND declaring it here.
    GUARDED_BY = ()

    def __init__(self, n_rungs: int, config: ServeConfig):
        self.n_rungs = max(1, int(n_rungs))
        self.cfg = config
        self.level = 0
        self._last_step = -float("inf")
        # the trigger sits at a fraction of the watermark so the ladder
        # acts with headroom and p99 lands UNDER the watermark, not at it
        self._down_s = (config.degrade_watermark_ms
                        * config.degrade_trigger_frac) / 1e3
        self._up_s = config.upgrade_watermark_ms / 1e3
        self._cooldown_s = config.degrade_cooldown_ms / 1e3
        obs.gauge("raft.serve.degrade.level").set(0)
        obs.gauge("raft.serve.overloaded").set(0)

    def observe(self, queue_delay_s: float, depth: int) -> int:
        """Feed one observation (head-of-line queue delay + post-batch
        queue depth) → the rung to serve the next batch at."""
        now = time.monotonic()
        cooled = (now - self._last_step) >= self._cooldown_s
        if (queue_delay_s > self._down_s and cooled
                and self.level < self.n_rungs - 1):
            self.level += 1
            self._last_step = now
            obs.counter("raft.serve.degrade.steps", direction="down").inc()
        elif (queue_delay_s < self._up_s and cooled and self.level > 0):
            self.level -= 1
            self._last_step = now
            obs.counter("raft.serve.degrade.steps", direction="up").inc()
        obs.gauge("raft.serve.degrade.level").set(self.level)
        overloaded = (self.level > 0
                      or depth >= self.cfg.max_queue
                      or queue_delay_s > self._down_s)
        obs.gauge("raft.serve.overloaded").set(1 if overloaded else 0)
        return self.level

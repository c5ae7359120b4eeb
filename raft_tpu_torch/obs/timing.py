"""``timed``: one name on two planes (counterpart of
``raft_tpu.obs.timing``).

``timed("raft.ivf_pq.search", mode="codes")`` opens a
``core.trace.range`` named ``raft.ivf_pq.search`` (a
``torch.profiler.record_function`` range, so the scope shows in a
profiler trace where the time went) and observes the elapsed wall
seconds into the histogram ``raft.ivf_pq.search.seconds`` with the given
labels, also when the body raises. Usable as a context manager or a
decorator::

    with obs.timed("raft.kmeans.fit"):
        ...

    @obs.timed("raft.ivf_pq.build")
    def build(...): ...

Wall-clock caveat: CUDA launches return before the device finishes, so
the scope measures host time unless it synchronises. The instrumented
call sites sit where the port waits anyway (a build's host syncs, a
search whose caller blocks), so the histograms track service time.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

from raft_tpu_torch.obs import registry as _registry


class timed:
    """Context manager / decorator timing a scope into
    ``<name>.seconds`` and a trace range named ``name``."""

    __slots__ = ("name", "labels", "registry", "_t0", "_range")

    def __init__(self, name: str,
                 registry: Optional[_registry.MetricsRegistry] = None,
                 **labels):
        self.name = name
        self.labels = labels
        self.registry = registry if registry is not None \
            else _registry.REGISTRY
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "timed":
        # the trace range stays on when metrics are off: it costs
        # nothing without a profiler session, and trace.enable_tracing
        # gates it on its own
        from raft_tpu_torch.core import trace
        self._range = trace.range(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        rng, self._range = self._range, None
        try:
            self.registry.histogram(self.name + ".seconds",
                                    **self.labels).observe(dt)
        finally:
            if rng is not None:
                rng.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # a fresh instance per call keeps the decorator reentrant
            # (recursion, threads)
            with timed(self.name, self.registry, **self.labels):
                return fn(*args, **kwargs)
        return wrapper

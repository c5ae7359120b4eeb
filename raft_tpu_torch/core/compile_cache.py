"""Where the kernel libraries are built and kept (counterpart of
``raft_tpu.core.compile_cache``, the JAX package's persistent XLA
compilation cache).

The port's kernels are already cached across processes: ``ops/_build.py``
names each library by a hash of its sources and flags and keeps it in
``raft_tpu_torch/_build/``, so a later process loads it without
``nvcc``. :func:`enable` moves that directory, with the JAX package's
rules: a second call is a no-op, and a different path then warns and is
ignored; ``RAFT_TPU_COMPILE_CACHE=0`` leaves the default and returns
False; ``RAFT_TPU_COMPILE_CACHE=<dir>`` is used verbatim when no path
is given. Once a kernel library has been loaded the directory can no
longer change (the loaded code came from the old one): that warns and
returns True, like a second path. Each call counts
``raft.compile_cache.enable{result=...}``.

The JAX package mirrors jax's compilation-cache events into the
registry; here the events are the kernel libraries':
``raft.compile_cache.event{event=cache_hits|cache_misses}`` counts a
library found built or built now, and the histogram
``raft.compile_cache.duration_seconds{event=...}`` takes the seconds of
loading a built one (``cache_retrieval_time_sec``) or of building one
with ``nvcc`` (``compile_time_sec``).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

from raft_tpu_torch import obs

_enabled = False
_active_path = None


def _note_event(hit: bool, seconds: float) -> None:
    """Count one kernel library found built (``hit``: ``seconds`` to load
    it) or built now (``seconds`` of its ``nvcc`` run)."""
    obs.counter("raft.compile_cache.event",
                event="cache_hits" if hit else "cache_misses").inc()
    obs.histogram("raft.compile_cache.duration_seconds",
                  event=("cache_retrieval_time_sec" if hit
                         else "compile_time_sec")).observe(seconds)


def enable(path: str | None = None) -> bool:
    """Idempotently set the kernel build directory. Returns True if the
    cache is active after the call."""
    global _enabled, _active_path
    from raft_tpu_torch.ops import _build
    if _enabled:
        if path is not None and _active_path is not None and \
                os.path.realpath(path) != os.path.realpath(_active_path):
            warnings.warn(
                f"raft_tpu_torch compile cache already enabled at "
                f"{_active_path!r}; ignoring new path {path!r} (one build "
                f"directory per process)")
        return True
    env = os.environ.get("RAFT_TPU_COMPILE_CACHE", "")
    if env == "0":
        obs.counter("raft.compile_cache.enable", result="disabled").inc()
        return False
    if path is None:
        path = env or str(_build.BUILD_DIR)
    if _build.loaded() and os.path.realpath(path) != \
            os.path.realpath(_build.BUILD_DIR):
        warnings.warn(
            f"raft_tpu_torch kernel libraries are already loaded from "
            f"{str(_build.BUILD_DIR)!r}; ignoring new path {path!r}")
        return True
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        # visible, once: without it every kernel is rebuilt by nvcc
        warnings.warn(f"raft_tpu_torch compile cache disabled ({e!r}); "
                      f"kernels build into {str(_build.BUILD_DIR)!r}")
        obs.counter("raft.compile_cache.enable", result="error").inc()
        obs.gauge("raft.compile_cache.active").set(0)
        return False
    _build.BUILD_DIR = Path(path)
    _enabled = True
    _active_path = path
    obs.counter("raft.compile_cache.enable", result="ok").inc()
    obs.gauge("raft.compile_cache.active").set(1)
    return True

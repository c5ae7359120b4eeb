"""Profiler trace annotations (counterpart of ``raft_tpu.core.trace``;
the original's NVTX ranges, ``cpp/include/raft/core/nvtx.hpp:69-110``).

A range is a ``torch.profiler.record_function`` annotation: it shows
in the traces ``torch.profiler`` writes (on the CPU and on the card
alike), as the JAX package's show in xprof. ``enable_tracing`` turns
them off; ``push_range``/``pop_range`` keep the JAX package's
toggle-balance contract.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List

from torch.profiler import record_function

_enabled = True
_tls = threading.local()


def _stack() -> List[object]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def enable_tracing(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def range(fmt: str, *args):
    """RAII-style trace range (the original's ``common::nvtx::range``)."""
    if not _enabled:
        yield
        return
    name = fmt % args if args else fmt
    with record_function(name):
        yield


def push_range(fmt: str, *args) -> None:
    """The enable state at PUSH time decides what the matching pop does:
    a range pushed while tracing was off pushes a placeholder that its
    pop drops silently; a range pushed while on is always exited (see
    :func:`pop_range`). Either way the per-thread stack stays
    balanced."""
    if not _enabled:
        _stack().append(None)
        return
    name = fmt % args if args else fmt
    ann = record_function(name)
    ann.__enter__()
    _stack().append(ann)


def pop_range() -> None:
    """Pops whatever the current enable state: an annotation entered
    while tracing was on is always exited."""
    stack = _stack()
    if not stack:
        return
    ann = stack.pop()
    if ann is not None:
        ann.__exit__(None, None, None)

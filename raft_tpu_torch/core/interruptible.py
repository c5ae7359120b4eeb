"""Cooperative cancellation of blocking sync points (counterpart of
``raft_tpu.core.interruptible``; the original's ``raft::interruptible``,
``cpp/include/raft/core/interruptible.hpp:66-163``).

A thread-local token registry: :func:`synchronize` polls for completion
and calls :func:`yield_` between polls, which raises
:class:`InterruptedException` once another thread has flagged this one
with :func:`cancel`. The original polls ``cudaStreamQuery``; here each
CUDA tensor's readiness is a ``torch.cuda.Event`` recorded on its
device's current stream, polled with ``query()``. CPU tensors are ready
at once. The registry is the JAX package's pure-Python one (its native
host runtime hook, ``core.native``, is not ported).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch


class InterruptedException(RuntimeError):
    """Raised inside a thread whose sync point was cancelled."""


class _Token:
    __slots__ = ("flag",)

    def __init__(self):
        self.flag = threading.Event()


_registry: Dict[int, _Token] = {}
_registry_lock = threading.Lock()


def _get_token(thread_id: int | None = None) -> _Token:
    """Per-thread token (the original's ``interruptible::get_token``)."""
    tid = threading.get_ident() if thread_id is None else thread_id
    with _registry_lock:
        tok = _registry.get(tid)
        if tok is None:
            tok = _Token()
            _registry[tid] = tok
        return tok


def yield_() -> None:
    """Check the current thread's cancellation flag; raise if set."""
    if yield_no_throw():
        raise InterruptedException("interruptible::yield: cancelled")


def yield_no_throw() -> bool:
    """Non-throwing check-and-clear; True if cancelled."""
    tok = _get_token()
    if tok.flag.is_set():
        tok.flag.clear()
        return True
    return False


def cancel(thread_id: int) -> None:
    """Flag the given thread's next yield to raise."""
    _get_token(thread_id).flag.set()


def _tensors(x):
    """The tensors in ``x``, looking into lists, tuples and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _ready_events(x) -> list:
    """One event recorded on the current stream of each CUDA device that
    holds a tensor of ``x``."""
    events = []
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


def wait_ready(x) -> None:
    """Block until the work queued so far on the current stream of each
    CUDA tensor's device in ``x`` (nested lists, tuples and dicts
    searched) has finished: the stream that produced the tensors, never
    the whole device, so work on other streams (a shadow scorer's) is not
    waited for. CPU tensors are ready at once."""
    for ev in _ready_events(x):
        ev.synchronize()


def synchronize(*arrays, poll_interval: float = 0.001) -> None:
    """Interruptible blocking wait until the work that produces each CUDA
    tensor in ``arrays`` (nested lists, tuples and dicts searched) has
    finished on its device's current stream."""
    events = _ready_events(arrays)
    while True:
        if all(ev.query() for ev in events):
            return
        yield_()
        time.sleep(poll_interval)


@contextlib.contextmanager
def interruptible():
    """A scope whose sync points may be cancelled from another thread with
    :func:`cancel` (pylibraft's ``cuda_interruptible``)."""
    _get_token()  # ensure registration
    try:
        yield
    finally:
        # drop an unconsumed cancellation so it cannot leak into later
        # scopes
        _get_token().flag.clear()

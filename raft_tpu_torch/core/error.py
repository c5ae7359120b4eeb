"""Error types and check helpers (counterpart of ``raft_tpu.core.error``).

``RaftError`` captures the instantiation backtrace like
``raft::exception``; ``expects`` is ``RAFT_EXPECTS``, ``fail``
``RAFT_FAIL``.
"""

from __future__ import annotations

import traceback


class RaftError(RuntimeError):
    """Base exception; keeps the backtrace of its construction."""

    def __init__(self, message: str):
        self.trace = "".join(traceback.format_stack()[:-1])
        super().__init__(message)


class LogicError(RaftError):
    """Invalid (logic) argument or state."""


def expects(cond: bool, fmt: str, *args) -> None:
    """Raise :class:`LogicError` with ``fmt % args`` unless ``cond``."""
    if not cond:
        raise LogicError(fmt % args if args else fmt)


def fail(fmt: str, *args) -> None:
    """Raise :class:`LogicError` with ``fmt % args`` (``RAFT_FAIL``)."""
    raise LogicError(fmt % args if args else fmt)

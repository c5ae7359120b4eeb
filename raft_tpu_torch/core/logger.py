"""Logger with a settable level, pattern and callback sink (counterpart
of ``raft_tpu.core.logger``; stdlib only).

A singleton ``logger`` on the stdlib logger ``raft_tpu_torch`` (its own
name, so a process holding both packages keeps their levels and sinks
apart), levels on the RAFT scale (``OFF`` 0 to ``TRACE`` 6), and
subsystem loggers (:func:`get_logger`) that inherit the singleton's
level, pattern and sink. A callback sink (:func:`set_callback`) lets a
host tool capture the framework's logs.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

# Level values on the RAFT scale (spdlog ordering), as the JAX package's.
OFF = 0
CRITICAL = 1
ERROR = 2
WARN = 3
INFO = 4
DEBUG = 5
TRACE = 6

_LEVEL_TO_PY = {
    OFF: logging.CRITICAL + 10,
    CRITICAL: logging.CRITICAL,
    ERROR: logging.ERROR,
    WARN: logging.WARNING,
    INFO: logging.INFO,
    DEBUG: logging.DEBUG,
    TRACE: logging.DEBUG - 5,
}


def _py_to_raft_level(py_level: int) -> int:
    """Map a Python logging level back onto the raft 0-6 scale so user
    callbacks see the same level numbers the public constants use."""
    for raft_level in (CRITICAL, ERROR, WARN, INFO, DEBUG, TRACE):
        if py_level >= _LEVEL_TO_PY[raft_level]:
            return raft_level
    return TRACE


class _CallbackHandler(logging.Handler):
    """Routes records to a user callback (the callback sink).
    Callback receives (raft_level, formatted_message)."""

    def __init__(self, callback: Callable[[int, str], None],
                 flush: Optional[Callable[[], None]] = None):
        super().__init__()
        self._callback = callback
        self._flush = flush

    def emit(self, record: logging.LogRecord) -> None:
        self._callback(_py_to_raft_level(record.levelno), self.format(record))

    def flush(self) -> None:
        if self._flush is not None:
            self._flush()


class Logger:
    """Singleton-style logger: one per process, ``logger`` below."""

    def __init__(self, name: str = "raft_tpu_torch"):
        self._logger = logging.getLogger(name)
        self._level = INFO
        self._pattern = "[%(asctime)s] [%(levelname)s] %(message)s"
        self._default_handler = logging.StreamHandler(sys.stderr)
        self._callback_handler: Optional[_CallbackHandler] = None
        self._logger.addHandler(self._default_handler)
        self._logger.propagate = False
        self.set_level(INFO)
        self.set_pattern(self._pattern)

    def set_level(self, level: int) -> None:
        self._level = level
        self._logger.setLevel(_LEVEL_TO_PY[level])

    def get_level(self) -> int:
        return self._level

    def should_log_for(self, level: int) -> bool:
        return level <= self._level

    def set_pattern(self, pattern: str) -> None:
        self._pattern = pattern
        fmt = logging.Formatter(pattern)
        self._default_handler.setFormatter(fmt)
        if self._callback_handler is not None:
            self._callback_handler.setFormatter(fmt)

    def get_pattern(self) -> str:
        return self._pattern

    def set_callback(self, callback: Optional[Callable[[int, str], None]],
                     flush: Optional[Callable[[], None]] = None) -> None:
        """Install a callback sink; pass None to restore stderr output
        (the log-capture path of host tools)."""
        if self._callback_handler is not None:
            self._logger.removeHandler(self._callback_handler)
            self._callback_handler = None
        if callback is not None:
            self._logger.removeHandler(self._default_handler)
            self._callback_handler = _CallbackHandler(callback, flush)
            self._callback_handler.setFormatter(logging.Formatter(self._pattern))
            self._logger.addHandler(self._callback_handler)
        elif self._default_handler not in self._logger.handlers:
            self._logger.addHandler(self._default_handler)

    def flush(self) -> None:
        for h in self._logger.handlers:
            h.flush()

    # RAFT_LOG_* macro equivalents
    def trace(self, msg, *a): self._log(TRACE, msg, *a)
    def debug(self, msg, *a): self._log(DEBUG, msg, *a)
    def info(self, msg, *a): self._log(INFO, msg, *a)
    def warn(self, msg, *a): self._log(WARN, msg, *a)
    # stdlib-logging spelling: a failure handler that writes
    # log.warning must not die on a missing alias
    def warning(self, msg, *a): self._log(WARN, msg, *a)
    def error(self, msg, *a): self._log(ERROR, msg, *a)
    def critical(self, msg, *a): self._log(CRITICAL, msg, *a)

    def _log(self, level: int, msg: str, *a) -> None:
        if self.should_log_for(level):
            self._logger.log(_LEVEL_TO_PY[level], msg % a if a else msg)


logger = Logger()


class ChildLogger:
    """Subsystem logger (``raft_tpu_torch.serve``, ...)
    that inherits level/pattern/callback sink from the singleton
    ``logger`` via stdlib propagation: it owns NO handlers and logs at
    NOTSET, so records bubble to the ``raft_tpu_torch`` parent where the
    default/callback handlers and the singleton's level live. The
    reference's spdlog registry has the same parent/child shape
    (``spdlog::get(name)`` sharing sinks)."""

    def __init__(self, name: str):
        full = name if name == "raft_tpu_torch" or name.startswith(
            "raft_tpu_torch.") else f"raft_tpu_torch.{name}"
        self.name = full
        self._logger = logging.getLogger(full)
        self._logger.setLevel(logging.NOTSET)  # inherit parent's level
        self._logger.propagate = True

    def should_log_for(self, level: int) -> bool:
        return logger.should_log_for(level)

    def trace(self, msg, *a): self._log(TRACE, msg, *a)
    def debug(self, msg, *a): self._log(DEBUG, msg, *a)
    def info(self, msg, *a): self._log(INFO, msg, *a)
    def warn(self, msg, *a): self._log(WARN, msg, *a)
    # stdlib-logging spelling (see Logger.warning)
    def warning(self, msg, *a): self._log(WARN, msg, *a)
    def error(self, msg, *a): self._log(ERROR, msg, *a)
    def critical(self, msg, *a): self._log(CRITICAL, msg, *a)

    def _log(self, level: int, msg: str, *a) -> None:
        if self.should_log_for(level):
            self._logger.log(_LEVEL_TO_PY[level], msg % a if a else msg)


_children: dict = {}


def get_logger(name: str) -> ChildLogger:
    """Child logger for a subsystem: ``get_logger("comms")`` logs as
    ``raft_tpu_torch.comms`` while level, pattern and any ``set_callback``
    sink installed on the singleton keep applying (propagation)."""
    child = _children.get(name)
    if child is None:
        child = _children[name] = ChildLogger(name)
    return child


def set_level(level: int) -> None:
    logger.set_level(level)


def set_callback(callback, flush=None) -> None:
    logger.set_callback(callback, flush)

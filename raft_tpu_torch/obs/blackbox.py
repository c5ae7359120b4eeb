"""Crash-durable black box: observability that survives the process
(counterpart of ``raft_tpu.obs.blackbox``; the same on-disk format, so
either package reads the other's dumps).

Everything the observability planes know (history frames,
:mod:`raft_tpu_torch.obs.history`; the flight recorder's trace and slow
rings; the profiler's duty cycle and memory; fleet replica transitions;
the ``/healthz`` verdict) lives in process memory and dies with the
process. A ``kill_replica`` chaos kill, an out-of-memory death or a hung
dispatch leaves no evidence. The black box spills those sections to disk
as **CRC'd, length-prefixed, atomically rotated segments**, so the
doctor (``python -m raft_tpu_torch.tools.doctor``) can diagnose a
corpse.

On-disk format (binary framing, JSON payloads, no pickling: a torn
tail must be recognizable, never executable; the framing of the
mutation WAL, :mod:`raft_tpu_torch.mutate.wal`)::

    segment  bb-%06d.open (active) / bb-%06d.seg (sealed)
    header   8 bytes   b"RTPUBBX1"
    record   u32 payload_length | u32 crc32(payload) | payload
    payload  compact JSON: {"kind", "t_unix", "reason", "box", "data"}

Record kinds: ``meta`` (pid, box, flush reason), ``snapshot`` (the full
registry snapshot), ``healthz`` (the endpoint verdict for that
snapshot), ``frames`` (history frames new since the last flush, deduped
by seq), ``traces`` (the recorder's recent and slow rings), ``profile``
(the profiler report, when one is attached), ``fleet`` (a router's or
federator's report, when wired).

Durability contract:

* a flush appends every section, then ``flush`` + ``os.fsync``: when
  :meth:`BlackBox.flush` returns, the dump survives kill -9;
* rotation seals the active ``.open`` segment through ``os.replace`` to
  ``.seg`` (a sealed name only ever appears complete) and prunes the
  oldest sealed segments beyond the retention cap;
* reopening a directory with a leftover ``.open`` (a crash) truncates
  its torn tail (CRC and length scan, counted under
  ``raft.obs.blackbox.torn.total``) and seals the intact prefix, the
  WAL's rule of never wedging on its own crash artifact. The
  ``faults.inject("obs.blackbox.append")`` site between the header and
  the payload writes lets tests make the torn tail a kill -9 mid-write
  leaves.

Flush triggers: cadence (``RAFT_TPU_BLACKBOX_INTERVAL``, default 5 s),
the healthz ok→degraded edge (polled at 0.5 s, so the dump records the
moment things went wrong, not the cadence after), SIGTERM, atexit,
:meth:`Replica.kill` and ``stop`` for per-replica boxes, and explicit
:func:`flush` calls.

Off means off: with ``RAFT_TPU_BLACKBOX`` unset or 0 nothing attaches;
``_STATE`` stays ``None`` and every hook is one module-flag read. The
ambient attach lives in ``raft_tpu_torch/obs/__init__.py``, not here, so
the doctor can import this module to READ dumps without ever starting a
recorder.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.obs import registry as _registry
from raft_tpu_torch.testing import faults as _faults

__all__ = ["BlackBox", "disable_blackbox", "enable_blackbox",
           "enabled", "flush", "read_dump", "read_segment", "state"]

_log = get_logger("obs")

_MAGIC = b"RTPUBBX1"
_HDR = struct.Struct("<II")     # payload length, crc32(payload)
_MAX_RECORD = 1 << 28

_ENV_INTERVAL = "RAFT_TPU_BLACKBOX_INTERVAL"
_ENV_SEG_BYTES = "RAFT_TPU_BLACKBOX_SEGMENT_BYTES"
_ENV_SEGMENTS = "RAFT_TPU_BLACKBOX_SEGMENTS"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# -- segment reading (classless: the doctor reads dumps with no box) ------

def _iter_segment(path: str) -> Iterator[Tuple[dict, int]]:
    """Yield ``(record, end_offset)`` for every intact record; return
    (StopIteration value) the torn byte count, 0 = clean EOF — the
    WAL's ``_iter_file_records`` contract."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            return len(magic)
        off = len(_MAGIC)
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return len(hdr)
            length, crc = _HDR.unpack(hdr)
            if length > _MAX_RECORD or length < 2:
                return _HDR.size
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return _HDR.size + len(payload)
            try:
                rec = json.loads(payload.decode("utf-8"))
            except Exception:   # graftlint: disable=GL006
                # checksummed-but-undecodable = version skew /
                # corruption boundary — treat as the crash boundary,
                # return the intact prefix (readers must never raise
                # on a dump)
                return _HDR.size + length
            off += _HDR.size + length
            yield rec, off


def read_segment(path: str) -> List[dict]:
    """Intact records of one segment (torn tail silently ends it)."""
    out: List[dict] = []
    it = _iter_segment(path)
    while True:
        try:
            rec, _ = next(it)
        except StopIteration:
            break
        out.append(rec)
    return out


def _segment_files(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    segs = sorted(n for n in names
                  if n.startswith("bb-") and n.endswith(".seg"))
    opens = sorted(n for n in names
                   if n.startswith("bb-") and n.endswith(".open"))
    return [os.path.join(path, n) for n in segs + opens]


def read_dump(path: str) -> List[dict]:
    """Every intact record of a black-box directory, in write order
    (sealed segments by sequence, then any still-open one). Tolerates
    the torn tail a kill -9 mid-write leaves — the doctor's loader."""
    out: List[dict] = []
    for p in _segment_files(path):
        out.extend(read_segment(p))
    return out


class BlackBox:
    """One crash-durable recorder writing rotating segments under
    ``dir`` (module docstring has the format + triggers)."""

    # static race contract (tools/graftlint GL003): the flush thread,
    # signal/atexit handlers, Replica.kill() and the owning caller all
    # meet on the segment state — touch only under `with self._lock`
    GUARDED_BY = ("_f", "_open_path", "_seg_seq", "_seg_bytes",
                  "_last_frame_seq", "_closed")

    def __init__(self, path: str, box: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 max_segment_bytes: Optional[int] = None,
                 max_segments: Optional[int] = None,
                 history: Optional[object] = None,
                 fleet: Optional[object] = None,
                 registry: Optional[object] = None):
        self.dir = os.path.abspath(path)
        self.box = box if box is not None else os.path.basename(
            self.dir.rstrip(os.sep)) or "default"
        self.interval_s = max(0.1, float(
            interval_s if interval_s is not None
            else _env_float(_ENV_INTERVAL, 5.0)))
        self.max_segment_bytes = max(4096, int(
            max_segment_bytes if max_segment_bytes is not None
            else _env_int(_ENV_SEG_BYTES, 4 << 20)))
        self.max_segments = max(2, int(
            max_segments if max_segments is not None
            else _env_int(_ENV_SEGMENTS, 8)))
        self._history = history
        self._fleet = fleet
        self._registry = (registry if registry is not None
                          else _registry.REGISTRY)
        self._lock = threading.Lock()
        self._f = None
        self._open_path: Optional[str] = None
        self._seg_seq = 0
        self._seg_bytes = 0
        self._last_frame_seq = 0
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._atexit_cb = None
        self._prev_sigterm = None
        os.makedirs(self.dir, exist_ok=True)
        torn = self._recover_dir()
        with self._lock:
            self._open_next_locked()
        if torn:
            obs.counter("raft.obs.blackbox.torn.total").inc(torn)
        # the baseline flush: even a box that dies before its first
        # cadence leaves a snapshot to diff the death frame against
        self.flush("start")

    # -- segment plumbing --------------------------------------------------
    def _recover_dir(self) -> int:
        """Seal any ``.open`` segment a crash left behind, truncating
        its torn tail first (CRC/length scan) → count of torn
        segments. The sealed intact prefix stays readable — the
        kill-9-mid-write recovery contract."""
        torn = 0
        for name in sorted(os.listdir(self.dir)):
            if not (name.startswith("bb-") and name.endswith(".open")):
                continue
            p = os.path.join(self.dir, name)
            good = len(_MAGIC)
            it = _iter_segment(p)
            torn_bytes = 0
            while True:
                try:
                    _, end = next(it)
                except StopIteration as stop:
                    torn_bytes = stop.value or 0
                    break
                good = end
            if torn_bytes:
                with open(p, "rb+") as f:
                    f.truncate(good)
                torn += 1
            os.replace(p, p[: -len(".open")] + ".seg")
        return torn

    def _seal_locked(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._open_path is not None:
            os.replace(self._open_path,
                       self._open_path[: -len(".open")] + ".seg")
            self._open_path = None

    def _open_next_locked(self) -> None:
        existing = [-1]
        for name in os.listdir(self.dir):
            if name.startswith("bb-") and (name.endswith(".seg")
                                           or name.endswith(".open")):
                try:
                    existing.append(int(name[3:9]))
                except ValueError:
                    pass
        self._seg_seq = max(existing) + 1
        self._open_path = os.path.join(self.dir,
                                       "bb-%06d.open" % self._seg_seq)
        # unbuffered: a kill -9 mid-flush must lose at most the
        # in-flight record (the torn tail recovery truncates), never a
        # whole flush sitting in a userspace buffer
        self._f = open(self._open_path, "wb", buffering=0)
        self._f.write(_MAGIC)
        self._seg_bytes = len(_MAGIC)

    def _prune_locked(self) -> None:
        sealed = sorted(n for n in os.listdir(self.dir)
                        if n.startswith("bb-") and n.endswith(".seg"))
        # the open segment counts toward retention
        while len(sealed) + 1 > self.max_segments:
            victim = sealed.pop(0)
            try:
                os.remove(os.path.join(self.dir, victim))
            except OSError:
                _log.warning("blackbox: prune failed for %s", victim)

    def _append_locked(self, kind: str, reason: str, data,
                       t_unix: float) -> int:
        payload = json.dumps(
            {"kind": kind, "t_unix": t_unix, "reason": reason,
             "box": self.box, "data": data},
            separators=(",", ":"), default=str).encode("utf-8")
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        # the kill-9-mid-write window: header on disk, payload not —
        # tests inject here to manufacture the torn tail recovery
        # must truncate
        _faults.inject("obs.blackbox.append", kind=kind,
                       box=self.box)
        self._f.write(payload)
        self._seg_bytes += _HDR.size + len(payload)
        return _HDR.size + len(payload)

    # -- section gathering (NO lock held — sections call into other
    # planes' locks; gathering inside ours would build lock-order
    # edges GL007 forbids) -------------------------------------------------
    def _gather(self, reason: str) -> List[Tuple[str, object]]:
        sections: List[Tuple[str, object]] = []
        sections.append(("meta", {
            "pid": os.getpid(), "box": self.box, "dir": self.dir,
            "reason": reason, "interval_s": self.interval_s}))
        snap = None
        try:
            snap = self._registry.snapshot()
            sections.append(("snapshot", snap))
        except Exception:
            _log.warning("blackbox: snapshot failed", exc_info=True)
        if snap is not None:
            try:
                from raft_tpu_torch.obs import endpoint as _endpoint
                sections.append(("healthz",
                                 _endpoint._health_body(snap)))
            except Exception:
                _log.warning("blackbox: healthz failed",
                             exc_info=True)
        hist = self._history
        if hist is not None:
            try:
                with self._lock:
                    since = self._last_frame_seq
                frames = hist.frames_since(since)
                if frames:
                    sections.append(("frames", frames))
            except Exception:
                _log.warning("blackbox: frames failed", exc_info=True)
        try:
            from raft_tpu_torch.obs import recorder as _recorder
            rec = _recorder.RECORDER
            sections.append(("traces", {
                "recent": rec.requests(16),
                "slow": rec.slow_requests(8),
                "recorded_total": rec.recorded_total}))
        except Exception:
            _log.warning("blackbox: traces failed", exc_info=True)
        try:
            from raft_tpu_torch.obs import profiler as _profiler
            if _profiler.state() is not None:
                sections.append(("profile", _profiler.report()))
        except Exception:
            _log.warning("blackbox: profile failed", exc_info=True)
        fleet = self._fleet
        if fleet is not None:
            try:
                rep = fleet.report()     # router OR federator, duck-typed
                sections.append(("fleet", rep))
            except Exception:
                _log.warning("blackbox: fleet failed", exc_info=True)
        return sections

    # -- the durability point ----------------------------------------------
    def flush(self, reason: str = "cadence") -> int:
        """Append every section, fsync, maybe rotate → bytes written.
        When this returns the dump survives kill -9."""
        # wall clock by design (GL005): dump records are correlated
        # across processes (doctor vs replica vs loadgen) — the stamp
        # must be comparable to OTHER processes' clocks
        t_unix = time.time()  # graftlint: disable=GL005
        sections = self._gather(reason)
        wrote = 0
        with self._lock:
            if self._closed or self._f is None:
                return 0
            for kind, data in sections:
                try:
                    wrote += self._append_locked(kind, reason, data,
                                                 t_unix)
                except (TypeError, ValueError):
                    # an unserializable section must not sink the
                    # whole flush (the other sections are the
                    # forensics) — default=str makes this rare
                    _log.warning("blackbox: %s section not "
                                 "serializable; skipped", kind)
                if kind == "frames":
                    self._last_frame_seq = max(
                        [f.get("seq", 0) for f in data]
                        + [self._last_frame_seq])
            self._f.flush()
            # fsync IS the durability contract of this module; writers
            # are genuinely concurrent (flush thread / SIGTERM /
            # atexit / Replica.kill) so it must stay under the lock —
            # a blocked flush delays only other flushes, never serving
            os.fsync(self._f.fileno())  # graftlint: disable=GL008
            if self._seg_bytes >= self.max_segment_bytes:
                self._seal_locked()
                self._open_next_locked()
                self._prune_locked()
        # registry effects after the lock (keep the lock graph acyclic)
        obs.counter("raft.obs.blackbox.flushes.total",
                    reason=reason).inc()
        obs.counter("raft.obs.blackbox.bytes.total").inc(wrote)
        obs.gauge("raft.obs.blackbox.segments.total").set(
            float(self._count_segments()))
        return wrote

    def _count_segments(self) -> int:
        return len(_segment_files(self.dir))

    # -- triggers ----------------------------------------------------------
    def start(self) -> "BlackBox":
        """Start the cadence/degrade-edge flush thread."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="raft-obs-blackbox")
            self._thread.start()
        return self

    def _loop(self) -> None:
        # poll fast (0.5 s) for the healthz ok→degraded EDGE, flush on
        # cadence otherwise — the degrade flush is the record of the
        # moment things went wrong, not the cadence after
        poll = min(0.5, self.interval_s)
        last_flush = time.monotonic()
        was_degraded = False    # loop-local: only this thread edges
        while not self._stop.wait(poll):
            try:
                degraded = self._health_degraded()
                edge = degraded and not was_degraded
                was_degraded = degraded
                now = time.monotonic()
                if edge:
                    self.flush("degrade")
                    last_flush = now
                elif now - last_flush >= self.interval_s:
                    self.flush("cadence")
                    last_flush = now
            except Exception:
                # the flusher must outlive any single bad flush — a
                # dead thread IS the failure mode this module exists
                # to prevent
                _log.warning("blackbox: flush failed", exc_info=True)

    def _health_degraded(self) -> bool:
        try:
            from raft_tpu_torch.obs import endpoint as _endpoint
            body = _endpoint._health_body(self._registry.snapshot())
            return body.get("status") != "ok"
        except Exception:   # graftlint: disable=GL006
            # healthz evaluation must never kill the flush loop; an
            # unevaluable health body is "not an edge", nothing more
            return False

    def install_exit_hooks(self, sigterm: bool = True) -> None:
        """Flush on atexit and (main thread only) SIGTERM; SIGTERM
        chains to the previous handler after flushing."""
        if self._atexit_cb is None:
            def _on_exit():
                try:
                    self.flush("atexit")
                except Exception:   # graftlint: disable=GL006
                    # interpreter teardown: logging may be gone; a
                    # failed last-gasp flush must not mask the exit
                    pass
            self._atexit_cb = _on_exit
            atexit.register(_on_exit)
        if sigterm and self._prev_sigterm is None:
            def _on_term(signum, frame):
                try:
                    self.flush("sigterm")
                except Exception:   # graftlint: disable=GL006
                    pass    # dying anyway; the flush was best-effort
                prev = self._prev_sigterm
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, _on_term)
            except ValueError:
                # signal.signal only works on the main thread; the
                # atexit + cadence paths still cover this box
                self._prev_sigterm = None

    def set_history(self, history) -> None:
        self._history = history

    def set_fleet(self, fleet) -> None:
        self._fleet = fleet

    def close(self, flush: bool = True) -> None:
        """Final flush, seal the open segment, detach hooks."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if flush:
            try:
                self.flush("close")
            except Exception:
                _log.warning("blackbox: close flush failed",
                             exc_info=True)
        with self._lock:
            self._closed = True
            self._seal_locked()
        if self._atexit_cb is not None:
            try:
                atexit.unregister(self._atexit_cb)
            except Exception:   # graftlint: disable=GL006
                pass    # already unregistered / interpreter teardown
            self._atexit_cb = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass    # non-main thread: leave the handler in place
            self._prev_sigterm = None

    def report(self) -> dict:
        with self._lock:
            return {"enabled": True, "box": self.box, "dir": self.dir,
                    "interval_s": self.interval_s,
                    "segment": self._seg_seq,
                    "segment_bytes": self._seg_bytes,
                    "max_segment_bytes": self.max_segment_bytes,
                    "max_segments": self.max_segments,
                    "last_frame_seq": self._last_frame_seq}


# -- module state (None IS the off state; one flag read per hook) ---------

_STATE: Optional[BlackBox] = None


def enable_blackbox(path: str, box: Optional[str] = None,
                    interval_s: Optional[float] = None,
                    max_segment_bytes: Optional[int] = None,
                    max_segments: Optional[int] = None,
                    fleet: Optional[object] = None,
                    registry: Optional[object] = None,
                    start: bool = True,
                    exit_hooks: bool = True) -> BlackBox:
    """Install the ambient black box writing under ``path`` (a
    previous one is closed first). Auto-wires the attached metrics
    history when one exists."""
    global _STATE
    prev, _STATE = _STATE, None
    if prev is not None:
        prev.close()
    from raft_tpu_torch.obs import history as _history
    bb = BlackBox(path, box=box, interval_s=interval_s,
                  max_segment_bytes=max_segment_bytes,
                  max_segments=max_segments,
                  history=_history.history(), fleet=fleet,
                  registry=registry)
    if exit_hooks:
        bb.install_exit_hooks()
    if start:
        bb.start()
    _STATE = bb
    return bb


def disable_blackbox(flush: bool = True) -> None:
    global _STATE
    prev, _STATE = _STATE, None
    if prev is not None:
        prev.close(flush=flush)


def state() -> Optional[BlackBox]:
    """The ambient box, or None (None IS the off state)."""
    return _STATE


def enabled() -> bool:
    return _STATE is not None


def flush(reason: str = "manual") -> int:
    """Flush the ambient box now (0 when none attached) — the hook
    other planes call on their own degrade edges."""
    st = _STATE
    if st is None:
        return 0
    return st.flush(reason)

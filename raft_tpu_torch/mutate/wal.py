"""Crash-safe mutation write-ahead log (counterpart of
``raft_tpu.mutate.wal``; the same byte format, so each package replays
the other's log).

Every acknowledged ``MutableIndex`` mutation since the last saved
checkpoint lives in this log: a mutation call appends (and fsyncs) its
record *before* the in-memory state changes, so after process death
:meth:`raft_tpu_torch.mutate.MutableIndex.recover` replays 100% of the
acknowledged mutations. A record appended but not yet applied when the
process died replays harmlessly: upserts and deletes are keyed by
explicit ids, and the log keeps the total mutation order (appends happen
under the index lock), so at-least-once replay reproduces the same
logical state.

The log is also the replication stream a fleet follower reads: every
record carries a monotonically increasing **sequence number** and the
wall-clock write time (both inside the CRC'd payload), and
:class:`WalReader` gives a read-only follower a positioned
``tail(from_seq)`` view that survives the checkpoint-time
:meth:`MutationWAL.rewrite`.

Format (binary, versioned, no pickling — a torn tail must be
recognizable, never executable; little-endian throughout)::

    header   8 bytes   b"RTPUWAL2"
    record   u32 payload_length | u32 crc32(payload) | payload
    payload  u64 seq, f64 wall_ts, u8 op, then
             op=1 upsert: u32 n, u32 dim, n×i64 ids, n×dim×f32 rows
             op=2 delete: u32 n, n×i64 ids
             op=3 meta:   u32 json_len, json bytes
                          (epoch/id_base/next_id — written as the first
                          record of a post-compaction rewrite)

Ids and rows may be numpy arrays or torch tensors (on any device); they
become little-endian int64 and float32 numpy arrays before they are
encoded. This module has no device code.

Sequence contract: ``seq`` starts at 1 and increases by exactly 1 per
appended record — the log is *contiguous*. :meth:`rewrite` CONSUMES
sequence numbers for the snapshot records it writes (it never reuses or
resets them), so the space stays monotone across truncation: a reader
caught up to the pre-rewrite tip resumes at the meta record with no
gap, while a reader that was still behind sees a hole (its missing
records were folded into the checkpoint) and gets a typed
:class:`WalGapError` — re-bootstrap from the checkpoint is the only
correct continuation. The rewrite's meta record carries
``snapshot_upto_seq`` (the seq of the last snapshot record) so a
caught-up follower can skip the snapshot records it already holds.

Durability contract: ``append_*`` returns only after ``flush`` +
``os.fsync`` (one fsync per mutation *batch* — the unit callers
acknowledge). ``sync=False`` drops the fsync for tests and bulk loads
that accept the OS page-cache window.

Truncation: at a compaction epoch swap the folded prefix becomes
redundant *provided the folded index is durably checkpointed* —
:meth:`rewrite` atomically replaces the log (tmp + fsync +
``os.replace``) with a meta record plus the still-pending tail. Without
a checkpoint path the log keeps growing and recovery replays it in full
onto the original base index.

A torn final record (crash mid-append) is detected by length/CRC,
counted under ``raft.mutate.wal.torn.total``, and truncated away when
the log is reopened for appending — the log never wedges on its own
crash artifact.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.util.host import host_array

__all__ = ["MutationWAL", "WalReader", "WalRecord", "WalGapError",
           "read_raw", "decode_stream"]

_MAGIC = b"RTPUWAL2"
_HDR = struct.Struct("<II")     # payload length, crc32
_SEQ = struct.Struct("<Qd")     # sequence number, wall-clock write time
OP_UPSERT = 1
OP_DELETE = 2
OP_META = 3
# sanity bound: one record is one mutation batch; anything bigger than
# this is a corrupt length field, not a real batch
_MAX_RECORD = 1 << 30


class WalGapError(RuntimeError):
    """The reader's position predates the oldest record the log still
    holds — the records in between were folded into a checkpoint by
    :meth:`MutationWAL.rewrite`. Tailing cannot continue; re-bootstrap
    from the checkpoint (the JAX package's
    ``fleet.replication.bootstrap_replica``)."""

    def __init__(self, last_seq: int, first_seq: int):
        super().__init__(
            f"wal: reader at seq {last_seq} but the log now starts at "
            f"seq {first_seq} — the gap was folded into a checkpoint; "
            f"re-bootstrap from the snapshot")
        self.last_seq = int(last_seq)
        self.first_seq = int(first_seq)


class WalRecord:
    """One decoded log record: ``op`` plus the op-specific fields,
    the replication ``seq`` and the wall-clock write time ``ts``."""

    __slots__ = ("op", "ids", "rows", "meta", "seq", "ts")

    def __init__(self, op: int, ids=None, rows=None, meta=None,
                 seq: int = 0, ts: float = 0.0):
        self.op = op
        self.ids = ids
        self.rows = rows
        self.meta = meta
        self.seq = seq
        self.ts = ts


def _host(a, dtype) -> np.ndarray:
    """``a`` (numpy, a sequence or a tensor on any device) as a
    contiguous little-endian numpy array of ``dtype``."""
    return np.ascontiguousarray(host_array(a, dtype),
                                np.dtype(dtype).newbyteorder("<"))


def _encode_upsert(ids: np.ndarray, rows: np.ndarray) -> bytes:
    n, dim = rows.shape
    return b"".join((
        struct.pack("<BII", OP_UPSERT, n, dim),
        _host(ids, np.int64).tobytes(),
        _host(rows, np.float32).tobytes()))


def _encode_delete(ids: np.ndarray) -> bytes:
    return (struct.pack("<BI", OP_DELETE, ids.shape[0])
            + _host(ids, np.int64).tobytes())


def _encode_meta(meta: dict) -> bytes:
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    return struct.pack("<BI", OP_META, len(blob)) + blob


def _decode(payload: bytes) -> WalRecord:
    seq, ts = _SEQ.unpack_from(payload, 0)
    base = _SEQ.size
    op = payload[base]
    if op == OP_UPSERT:
        _, n, dim = struct.unpack_from("<BII", payload, base)
        off = base + struct.calcsize("<BII")
        ids = np.frombuffer(payload, np.int64, n, off)
        rows = np.frombuffer(payload, np.float32, n * dim,
                             off + n * 8).reshape(n, dim)
        return WalRecord(OP_UPSERT, ids=ids, rows=rows, seq=seq, ts=ts)
    if op == OP_DELETE:
        _, n = struct.unpack_from("<BI", payload, base)
        ids = np.frombuffer(payload, np.int64, n,
                            base + struct.calcsize("<BI"))
        return WalRecord(OP_DELETE, ids=ids, seq=seq, ts=ts)
    if op == OP_META:
        _, ln = struct.unpack_from("<BI", payload, base)
        off = base + struct.calcsize("<BI")
        return WalRecord(OP_META, meta=json.loads(payload[off:off + ln]),
                         seq=seq, ts=ts)
    raise ValueError(f"wal: unknown record op {op}")


def _iter_file_records(path: str) -> Iterator[Tuple[WalRecord, int]]:
    """Yield (record, end_offset) for every intact record; stop at the
    first torn/corrupt one. Shared by the appending WAL and the
    read-only :class:`WalReader`. Raises StopIteration value via
    generator return of the torn byte count (0 = clean EOF)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        expects(magic == _MAGIC,
                "wal: %s is not a mutation WAL (bad magic)", path)
        off = len(_MAGIC)
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return len(hdr)
            length, crc = _HDR.unpack(hdr)
            if length > _MAX_RECORD or length < _SEQ.size + 1:
                return _HDR.size
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return _HDR.size + len(payload)
            try:
                rec = _decode(payload)
            except Exception:   # graftlint: disable=GL006
                # an undecodable-but-checksummed record is a version
                # skew / corruption boundary, handled exactly like a
                # torn tail: stop replay here (justified swallow —
                # replay MUST return the intact prefix, not raise)
                return _HDR.size + length
            off += _HDR.size + length
            yield rec, off


class MutationWAL:
    """Append-only mutation log for one :class:`MutableIndex`.

    Not thread-safe on its own — the owning index serializes appends
    under its lock (mutations are already totally ordered there, and
    the log must preserve that order)."""

    def __init__(self, path: str, sync: bool = True,
                 start_seq: int = 1):
        self.path = path
        self.sync = bool(sync)
        self.torn_bytes = 0
        # next sequence number to assign (contiguous from 1; restored
        # by scanning at reopen so the space never restarts).
        # ``start_seq`` > 1 seeds a FRESH log deeper into the sequence
        # space — the promoted-follower hand-off (fleet tier): the new
        # primary's own log continues exactly where the applied stream
        # ended, so a caught-up peer resumes contiguously and a behind
        # peer gets the typed gap instead of silent divergence.
        expects(start_seq >= 1,
                "wal: start_seq must be >= 1, got %d", start_seq)
        self.next_seq = int(start_seq)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        if fresh:
            self._f = open(path, "wb")
            self._f.write(_MAGIC)
            self._flush()
        else:
            # reopen for append: verify the header and truncate any
            # torn tail a crash mid-append left behind
            good = self._scan_good_length()
            with open(path, "rb+") as f:
                f.truncate(good)
            self._f = open(path, "ab")

    # -- internals ---------------------------------------------------------
    def _flush(self) -> None:
        self._f.flush()
        if self.sync:
            os.fsync(self._f.fileno())
            obs.counter("raft.mutate.wal.fsyncs.total").inc()

    def _stamp(self, body: bytes) -> bytes:
        """Prefix the op body with the next (seq, wall-ts) pair —
        inside the CRC'd region, so a corrupted seq can never be
        mistaken for a real position."""
        # wall clock by design (GL005): the ts feeds the cross-process
        # replication-lag gauge — a follower compares it against ITS
        # wall clock, which monotonic time cannot do
        payload = _SEQ.pack(self.next_seq, time.time()) + body  # graftlint: disable=GL005
        self.next_seq += 1
        return payload

    def _append(self, body: bytes) -> None:
        payload = self._stamp(body)
        rec = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        self._f.write(rec)
        self._flush()
        obs.counter("raft.mutate.wal.appends.total").inc()
        obs.counter("raft.mutate.wal.bytes.total").inc(len(rec))

    def _scan_good_length(self) -> int:
        """Byte offset of the last intact record's end (validates the
        whole file; called once at reopen). Also restores
        ``next_seq`` past the highest surviving record."""
        good = len(_MAGIC)
        it = _iter_file_records(self.path)
        torn = 0
        while True:
            try:
                rec, end = next(it)
            except StopIteration as stop:
                torn = stop.value or 0
                break
            good = end
            self.next_seq = max(self.next_seq, rec.seq + 1)
        if torn:
            self.torn_bytes = torn
            obs.counter("raft.mutate.wal.torn.total").inc()
        return good

    # -- public API --------------------------------------------------------
    def append_upsert(self, ids, rows) -> None:
        ids = _host(ids, np.int64).reshape(-1)
        rows = _host(rows, np.float32)
        expects(rows.ndim == 2 and rows.shape[0] == ids.shape[0],
                "wal.append_upsert: rows must be (n=%d, dim), got %s",
                ids.shape[0], rows.shape)
        self._append(_encode_upsert(ids, rows))

    def append_delete(self, ids) -> None:
        ids = _host(ids, np.int64).reshape(-1)
        self._append(_encode_delete(ids))

    def append_meta(self, meta: dict) -> None:
        """Append a meta record mid-log (epoch/id-space counters).
        The promotion path writes one as the FIRST record of the new
        primary's own log so a replica bootstrapping from it without
        the checkpoint still restores the inherited counters."""
        self._append(_encode_meta(dict(meta)))

    def replay(self) -> List[WalRecord]:
        """Every intact record in append order (stops at the first
        torn/corrupt one — the crash boundary)."""
        out = []
        it = _iter_file_records(self.path)
        while True:
            try:
                rec, _end = next(it)
            except StopIteration as stop:
                if stop.value:
                    self.torn_bytes = stop.value
                    obs.counter("raft.mutate.wal.torn.total").inc()
                break
            out.append(rec)
        obs.counter("raft.mutate.wal.replayed.total").inc(len(out))
        return out

    def rewrite(self, meta: Optional[dict] = None,
                tomb_ids=None, upsert_ids=None,
                upsert_rows=None) -> None:
        """Atomically replace the log with a compaction-epoch prefix:
        a meta record (epoch/id-space counters) + the still-pending
        deletes and delta-tail upserts. tmp + fsync + ``os.replace`` —
        a crash at any point leaves either the old complete log or the
        new complete log, never a hybrid.

        The snapshot records CONSUME fresh sequence numbers (the space
        is monotone, never reset): a reader caught up to the
        pre-rewrite tip resumes here contiguously, and the meta record
        carries ``snapshot_upto_seq`` so it can recognize — and skip —
        snapshot records whose state it already holds."""
        chunks = []
        if tomb_ids is not None and len(tomb_ids):
            chunks.append(_encode_delete(
                _host(tomb_ids, np.int64).reshape(-1)))
        if upsert_ids is not None and len(upsert_ids):
            chunks.append(_encode_upsert(
                _host(upsert_ids, np.int64).reshape(-1),
                _host(upsert_rows, np.float32)))
        if meta is not None:
            meta = dict(meta,
                        snapshot_upto_seq=self.next_seq + len(chunks))
            chunks.insert(0, _encode_meta(meta))
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            for body in chunks:
                payload = self._stamp(body)
                f.write(_HDR.pack(len(payload), zlib.crc32(payload))
                        + payload)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        obs.counter("raft.mutate.wal.truncations.total").inc()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MutationWAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class WalReader:
    """Read-only positioned view over a (possibly live) mutation WAL —
    the replication follower's end of the log.

    ``tail()`` returns every record newer than the reader's position
    and advances it. The reader NEVER writes (no truncation, no
    repair): a torn tail simply ends the batch — the appending side
    repairs it at its next reopen, and the torn record re-delivers
    once rewritten intact (at-least-once, the same contract replay
    has).

    Surviving ``rewrite``: the writer atomically replaces the file, so
    the reader watches the inode. When the file was replaced (or
    shrank under its offset) it rescans from the header, skipping
    records at or below its position. Because the sequence space is
    monotone and contiguous, a caught-up reader resumes exactly at the
    rewrite's snapshot records; a reader that was still behind finds
    the log's first record more than one seq ahead — those records
    were folded into the checkpoint — and gets :class:`WalGapError`
    (re-bootstrap is the only correct continuation)."""

    def __init__(self, path: str, from_seq: int = 0):
        self.path = path
        self.last_seq = int(from_seq)
        self._off = len(_MAGIC)
        self._ino = self._stat_ino()

    def _stat_ino(self):
        try:
            st = os.stat(self.path)
            return (st.st_dev, st.st_ino, st.st_size)
        except OSError:
            return None

    def tail(self, from_seq: Optional[int] = None,
             max_records: int = 0) -> List[WalRecord]:
        """Records with ``seq > from_seq`` (default: the reader's
        position) in order, advancing the position past everything
        returned. ``max_records`` > 0 bounds one call (the rest stays
        for the next). Empty list = caught up (or the file does not
        exist yet)."""
        if from_seq is not None:
            self.last_seq = int(from_seq)
            self._off = len(_MAGIC)
        st = self._stat_ino()
        if st is None:
            return []
        if self._ino is None or st[:2] != self._ino[:2] \
                or st[2] < self._off:
            # the writer replaced (rewrite) or restarted the file:
            # rescan from the header, filtering on seq
            self._off = len(_MAGIC)
        self._ino = st
        out: List[WalRecord] = []
        first_seen: Optional[int] = None
        it = _iter_file_records(self.path)
        off = len(_MAGIC)
        while True:
            try:
                rec, end = next(it)
            except StopIteration:
                break       # clean EOF or torn tail — stop either way
            off = end
            if off <= self._off:
                continue    # already consumed (byte-position resume)
            if rec.seq <= self.last_seq:
                self._off = off     # pre-position records after rescan
                continue
            if first_seen is None:
                first_seen = rec.seq
                if rec.seq > self.last_seq + 1 and self.last_seq > 0:
                    obs.counter("raft.mutate.wal.reader.gaps.total").inc()
                    raise WalGapError(self.last_seq, rec.seq)
            out.append(rec)
            self._off = off
            self.last_seq = rec.seq
            if max_records and len(out) >= max_records:
                break
        obs.counter("raft.mutate.wal.reader.records.total").inc(len(out))
        return out

    @property
    def position(self) -> int:
        """Seq of the last record returned (0 = nothing yet)."""
        return self.last_seq


# -- the log as the wire format (the fleet transport) -------------------------

def read_raw(path: str, from_seq: int = 0, max_records: int = 0
             ) -> Tuple[bytes, int, int]:
    """Raw wire slice of a WAL: the on-disk bytes of every intact
    record with ``seq > from_seq``, prefixed with the format magic —
    the returned buffer is itself a valid WAL fragment in the exact
    framing :func:`decode_stream` (and a future ``MutationWAL`` reopen)
    parses. The fleet transport streams THIS over
    ``GET /rpc/wal/tail`` — the log IS the wire format, no re-encode,
    CRCs travel verbatim. Returns ``(buf, n_records, last_seq)``;
    raises :class:`WalGapError` when ``from_seq`` predates the oldest
    surviving record (folded into a checkpoint — re-bootstrap).
    Single pass over one open file handle, so a concurrent
    :meth:`MutationWAL.rewrite` can never interleave two file
    generations into one response."""
    from_seq = int(from_seq)
    out = [_MAGIC]
    n = 0
    last = from_seq
    first_seen: Optional[int] = None
    try:
        f = open(path, "rb")
    except OSError:
        return b"".join(out), 0, last     # no log yet = empty tail
    with f:
        magic = f.read(len(_MAGIC))
        expects(magic == _MAGIC,
                "wal: %s is not a mutation WAL (bad magic)", path)
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            length, crc = _HDR.unpack(hdr)
            if length > _MAX_RECORD or length < _SEQ.size + 1:
                break
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break           # torn tail — ends the batch, like tail()
            seq, _ts = _SEQ.unpack_from(payload, 0)
            if seq <= from_seq:
                continue
            if first_seen is None:
                first_seen = seq
                if seq > from_seq + 1 and from_seq > 0:
                    obs.counter("raft.mutate.wal.reader.gaps.total").inc()
                    raise WalGapError(from_seq, seq)
            out.append(hdr)
            out.append(payload)
            last = seq
            n += 1
            if max_records and n >= max_records:
                break
    return b"".join(out), n, last


def decode_stream(buf: bytes) -> List[WalRecord]:
    """Decode a :func:`read_raw` buffer (magic + framed records) back
    into :class:`WalRecord` objects — the follower's end of the wire.
    A torn/corrupt suffix ends the batch (same contract as ``tail()``
    over a live file: the intact prefix is the answer, re-delivery is
    the sender's job)."""
    expects(buf[:len(_MAGIC)] == _MAGIC,
            "wal: wire stream has bad magic")
    out: List[WalRecord] = []
    off = len(_MAGIC)
    while off + _HDR.size <= len(buf):
        length, crc = _HDR.unpack_from(buf, off)
        start = off + _HDR.size
        payload = buf[start:start + length]
        if length > _MAX_RECORD or length < _SEQ.size + 1 \
                or len(payload) < length or zlib.crc32(payload) != crc:
            break
        try:
            out.append(_decode(payload))
        except Exception:   # graftlint: disable=GL006
            # undecodable-but-checksummed = version skew boundary,
            # handled like a torn tail (justified swallow — the intact
            # prefix must be returned, not raised away)
            break
        off = start + length
    return out

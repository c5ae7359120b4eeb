"""WAL-tailing replication: new replicas from a checkpoint and the log's
tail (counterpart of ``raft_tpu.fleet.replication``).

Replication is recovery pointed at another process's state: the
compactor's checkpointed epoch snapshot plus an ordered, at-least-once
replay of the mutation WAL reproduce the primary's logical state.

* **bootstrap** (:func:`bootstrap_replica`) — load the primary's
  checkpoint onto ``device`` (``serialize.load``; else the base index the
  WAL was started against), wrap it in a fresh
  :class:`~raft_tpu_torch.mutate.MutableIndex` and replay the log
  through a read-only :class:`~raft_tpu_torch.mutate.wal.WalReader`. The
  primary does nothing for it: the WAL is the transfer format.
* **freshness** (:class:`Replicator`) — a daemon thread keeps tailing
  ``WalReader.tail()`` and applying records through a
  :class:`WalApplier`, the lag exported as
  ``raft.fleet.replication.lag_records`` and ``lag_seconds``.
* **the primary folds** — its log is rewritten to a meta record plus the
  still-pending tail. A caught-up follower resumes contiguously (the
  sequence space is monotone), folds its own state at the meta record
  and skips the snapshot records it already holds
  (``snapshot_upto_seq``). A follower that was behind the rewrite lost
  records to the checkpoint: its reader raises
  :class:`~raft_tpu_torch.mutate.wal.WalGapError`, the replicator parks
  with ``raft.fleet.replication.gap`` set, and the replica must
  bootstrap again.
* **the fold window** — a fold promotes the checkpoint's counters (a
  ``<checkpoint>.meta`` sidecar), then the checkpoint, then rewrites the
  log. A bootstrap between the promotion and the rewrite finds the folded
  checkpoint beside the old log. As :meth:`MutableIndex.recover` does,
  it then takes the counters from the sidecar and skips the records the
  checkpoint folded (``folded_upto_seq``), when the log's head meta is
  missing or of an older epoch; otherwise it replays those records a
  second time over the folded rows.

Followers never write the primary's WAL and keep no WAL of their own
here; a promoted replica starts its own log from its converged state.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.mutate.types import DeltaFullError
from raft_tpu_torch.mutate.wal import (OP_DELETE, OP_META, OP_UPSERT,
                                       WalGapError, WalReader, WalRecord)
from raft_tpu_torch.obs import spans

__all__ = ["WalApplier", "Replicator", "bootstrap_replica"]


class WalApplier:
    """Applies a WAL record stream (in seq order) onto a follower
    :class:`~raft_tpu_torch.mutate.MutableIndex`. One consumer: a
    bootstrap call or one :class:`Replicator` thread; the index's own
    lock serialises the apply.

    At-least-once, as recovery: records at or below the applied position
    are skipped, upserts and deletes are keyed by explicit ids, and an
    upsert stream that overflows the follower's delta folds inline and
    goes on."""

    def __init__(self, mindex):
        self.m = mindex
        self.applied_seq = 0     # highest record seq processed
        self.applied_records = 0
        self._skip_upto = 0      # a rewrite's snapshot records, held

    def apply(self, rec: WalRecord) -> str:
        """Process one record → ``applied``, ``skipped``, ``meta`` or
        ``compacted``."""
        if rec.seq and rec.seq <= max(self.applied_seq,
                                      self._skip_upto):
            self.applied_seq = max(self.applied_seq, rec.seq)
            return "skipped"
        out = "applied"
        if rec.op == OP_META:
            out = self._apply_meta(rec)
        elif rec.op == OP_DELETE:
            self.m.delete(rec.ids)
        elif rec.op == OP_UPSERT:
            self._apply_upsert(rec)
        self.applied_seq = max(self.applied_seq, rec.seq)
        self.applied_records += 1
        return out

    def _apply_meta(self, rec: WalRecord) -> str:
        meta = rec.meta or {}
        if self.applied_seq == 0:
            # the head of a post-fold log at bootstrap: restore the
            # counters the checkpoint was folded under, then APPLY the
            # snapshot records after it (pending state the checkpoint
            # does not hold)
            self.m.apply_meta(meta)
            return "meta"
        # mid-stream: the primary folded. We hold every record up to
        # rec.seq - 1 (the reader guarantees contiguity), the primary's
        # state before the swap, so folding our own delta reproduces its
        # state after it, and the rewrite's snapshot records are ours
        # already
        if int(meta.get("epoch", 0)) > self.m.epoch:
            self.m.compact()
        self._skip_upto = int(meta.get("snapshot_upto_seq", rec.seq))
        return "compacted"

    def _apply_upsert(self, rec: WalRecord) -> None:
        ids32 = np.asarray(rec.ids, np.int32)
        top = self.m.cfg.delta_capacities[-1]
        # chunks of the top rung: the log may have been written under a
        # larger delta budget than this follower's
        for s in range(0, ids32.shape[0], top):
            try:
                self.m.upsert(rec.rows[s:s + top], ids=ids32[s:s + top])
            except DeltaFullError:
                self.m.compact()
                self.m.upsert(rec.rows[s:s + top], ids=ids32[s:s + top])


def _seat_checkpoint(applier: WalApplier, ckpt_meta: dict,
                     head: Optional[WalRecord]) -> None:
    """The fold window (``mutable._fold_window_skip``, the rule
    ``MutableIndex.recover`` applies): when the log was not rewritten
    after the checkpoint's promotion, restore the sidecar's counters and
    skip every record the checkpoint folded."""
    from raft_tpu_torch.mutate.mutable import _fold_window_skip
    head_meta = (head.meta or {}) if head is not None and \
        head.op == OP_META else None
    upto = _fold_window_skip(ckpt_meta, head_meta)
    if upto is None:
        return
    applier.m.apply_meta(ckpt_meta)
    applier.applied_seq = max(applier.applied_seq, upto)
    applier._skip_upto = max(applier._skip_upto, upto)


def _replay(applier: WalApplier, batches: Iterable[List[WalRecord]],
            ckpt_meta: Optional[dict]) -> None:
    """Apply record batches in order; with a checkpoint sidecar, seat it
    against the log's first record before anything is applied."""
    seated = ckpt_meta is None
    for recs in batches:
        for rec in recs:
            if not seated:
                _seat_checkpoint(applier, ckpt_meta, rec)
                seated = True
            applier.apply(rec)
    if not seated:
        _seat_checkpoint(applier, ckpt_meta, None)


def bootstrap_replica(wal_path: str, k: int,
                      checkpoint_path: Optional[str] = None,
                      base_index=None, params=None, config=None,
                      name: str = "replica", device="cuda"
                      ) -> Tuple[object, WalReader, WalApplier]:
    """Build a follower :class:`~raft_tpu_torch.mutate.MutableIndex` from
    the primary's durable state: the fold checkpoint when one exists,
    loaded onto ``device`` (default ``cuda``), else ``base_index``, plus
    a read-only replay of the whole log. Returns ``(mindex, reader,
    applier)`` at the log's tip, for a :class:`Replicator`. Counted under
    ``raft.fleet.bootstrap.total`` and timed as
    ``raft.fleet.bootstrap.seconds``."""
    from raft_tpu_torch.mutate import MutableIndex
    from raft_tpu_torch.mutate.mutable import _load_checkpoint
    with obs.timed("raft.fleet.bootstrap"), \
            spans.span("raft.fleet.bootstrap", replica=name) as sp:
        ckpt_meta = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            inner, ckpt_meta = _load_checkpoint(checkpoint_path, device)
            sp.set_attr("source", "checkpoint")
        else:
            inner = base_index
            sp.set_attr("source", "base_index")
        expects(inner is not None,
                "fleet.bootstrap: no checkpoint at %r and no "
                "base_index — a replica needs the index the WAL was "
                "started against", checkpoint_path)
        m = MutableIndex(inner, k=int(k), params=params, config=config)
        reader = WalReader(wal_path)
        applier = WalApplier(m)
        _replay(applier, [reader.tail()], ckpt_meta)
        sp.set_attr("replayed", applier.applied_records)
        sp.set_attr("seq", applier.applied_seq)
    obs.counter("raft.fleet.bootstrap.total").inc()
    obs.gauge("raft.fleet.replication.lag_records", replica=name).set(0)
    return m, reader, applier


class Replicator:
    """A daemon thread keeping one follower fresh: poll
    ``WalReader.tail()``, apply through the :class:`WalApplier`, export
    the lag. On a :class:`~raft_tpu_torch.mutate.wal.WalGapError` (the
    follower fell behind a rewrite) the thread PARKS: ``gap`` turns
    True, ``raft.fleet.replication.gap{replica}`` is raised, and the
    owner must bootstrap again; tailing a log with a hole would serve
    wrong answers, not stale ones."""

    # static race contract (tools/graftlint GL003): the owner thread and
    # the tailer thread meet on these flags
    GUARDED_BY = ("_closed", "_gap")

    def __init__(self, mindex, wal_path: str, name: str = "replica",
                 poll_ms: float = 25.0, reader: Optional[WalReader] = None,
                 applier: Optional[WalApplier] = None,
                 start: bool = True):
        self.name = str(name)
        self.wal_path = wal_path
        self._reader = reader if reader is not None \
            else WalReader(wal_path)
        self._applier = applier if applier is not None \
            else WalApplier(mindex)
        self._poll_s = max(1e-3, poll_ms / 1e3)
        self._cond = threading.Condition()
        self._closed = False
        self._gap = False
        self._thread: Optional[threading.Thread] = None
        obs.gauge("raft.fleet.replication.gap", replica=self.name).set(0)
        if start:
            self.start()

    @property
    def applier(self) -> WalApplier:
        return self._applier

    @property
    def gap(self) -> bool:
        with self._cond:
            return self._gap

    def start(self) -> "Replicator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"raft-fleet-replicator-{self.name}")
            self._thread.start()
        return self

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self) -> "Replicator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- catch-up ----------------------------------------------------------
    def caught_up(self) -> bool:
        """Is the follower at the log's tip now? A read-only probe from
        the applier's position (stale by one append the moment it
        returns)."""
        floor = max(self._applier.applied_seq,
                    self._applier._skip_upto)
        # a remote reader (fleet.transport.RemoteWalReader) probes the tip
        # over its own wire
        probe_fn = getattr(self._reader, "probe_caught_up", None)
        if probe_fn is not None:
            return bool(probe_fn(floor))
        try:
            probe = WalReader(self.wal_path, from_seq=floor)
            return not probe.tail(max_records=1)
        except (WalGapError, OSError):
            return False

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until the follower has applied everything the log held
        (the quiesce-then-compare barrier). False on timeout or a parked
        gap."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            if self.gap:
                return False
            if self.caught_up():
                return True
            time.sleep(min(self._poll_s, 0.02))
        return False

    # -- the tail loop -----------------------------------------------------
    def _loop(self) -> None:
        log = get_logger("fleet")
        while True:
            with self._cond:
                if self._closed:
                    return
                self._cond.wait(timeout=self._poll_s)
                if self._closed:
                    return
            try:
                recs = self._reader.tail()
            except WalGapError as e:
                with self._cond:
                    self._gap = True
                obs.counter("raft.fleet.replication.gaps.total",
                            replica=self.name).inc()
                obs.gauge("raft.fleet.replication.gap",
                          replica=self.name).set(1)
                log.warning(
                    "replicator %s: fell behind a checkpoint rewrite "
                    "(%r) — parked; re-bootstrap this replica",
                    self.name, e)
                return
            except OSError as e:
                # the log can be missing for a moment (a primary
                # restarting): count and keep polling
                obs.counter("raft.fleet.replication.errors.total",
                            replica=self.name).inc()
                log.warning("replicator %s: tail failed: %r",
                            self.name, e)
                continue
            if not recs:
                obs.gauge("raft.fleet.replication.lag_records",
                          replica=self.name).set(0)
                continue
            obs.gauge("raft.fleet.replication.lag_records",
                      replica=self.name).set(len(recs))
            applied = 0
            for rec in recs:
                try:
                    if self._applier.apply(rec) != "skipped":
                        applied += 1
                except Exception as e:
                    obs.counter("raft.fleet.replication.errors.total",
                                replica=self.name).inc()
                    log.error(
                        "replicator %s: apply of seq %d failed: %r "
                        "— parking (state may be behind, never wrong)",
                        self.name, rec.seq, e)
                    with self._cond:
                        self._gap = True
                    obs.gauge("raft.fleet.replication.gap",
                              replica=self.name).set(1)
                    return
            obs.counter("raft.fleet.replication.applied.total",
                        replica=self.name).inc(applied)
            obs.gauge("raft.fleet.replication.lag_records",
                      replica=self.name).set(0)
            # wall clock by design (GL005): the lag compares the
            # primary's record-write wall time with OUR wall clock, and
            # monotonic clocks do not compare across processes
            lag_s = max(0.0, time.time() - recs[-1].ts)  # graftlint: disable=GL005
            obs.gauge("raft.fleet.replication.lag_seconds",
                      replica=self.name).set(round(lag_s, 6))

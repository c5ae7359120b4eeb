"""MutableIndex: live upsert and delete over a built IVF index
(counterpart of ``raft_tpu.mutate.mutable``).

Any built ivf_flat, ivf_pq or ivf_bq index becomes mutable with no
preparation on the serving path:

* **delta segment** — upserts append into a flat host buffer whose
  device view walks the rung ladder of ``MutateConfig.delta_capacities``;
  every query scores it exactly and merges it with the main IVF top-k
  (:mod:`raft_tpu_torch.mutate.program`).
* **tombstones** — deletes set a bit in a packed bitmap over the main
  index's id space, filtered after the main top-k; an upsert of an
  existing id is tombstone + append (the delta row shadows the stale main
  row). Delta rows die in place: their slot id flips to -1.
* **background compaction** — a compactor
  (:class:`raft_tpu_torch.mutate.compactor.Compactor`, or a direct
  :meth:`MutableIndex.compact`) freezes a snapshot, folds it into the
  main lists (:mod:`raft_tpu_torch.mutate.compact`), prepares and warms
  the NEXT epoch's whole program grid off the serving path, and swaps the
  epoch under the lock. Mutations landing during the fold stay in the
  delta tail and survive the swap; deletes during the fold are replayed
  onto the new epoch's bitmap.

The device snapshot: each mutation publishes FRESH device tensors (the
delta view at the current rung and the bitmap), copied on the index's
own transfer stream and complete before they are published, and never
written again. A search takes the snapshot under the lock and marks each
tensor as used on its own stream (``record_stream``), so the caching
allocator cannot hand the memory to a later snapshot while a launched
search still reads it.

Threading model (the ``GUARDED_BY`` contract below): caller threads
mutate, the serving dispatcher searches, the compactor folds; all state
hand-off happens under ``self._cond``, and device work and program
preparation run outside the lock against immutable snapshots.

Durability: with a :class:`~raft_tpu_torch.mutate.wal.MutationWAL`
attached (:meth:`MutableIndex.attach_wal`), every upsert and delete
appends and fsyncs its record under the index lock BEFORE the in-memory
change, so :meth:`MutableIndex.recover` replays every acknowledged
mutation after process death. With a checkpoint path, each compaction
saves the folded inner index (``serialize.save``) and, at the epoch swap,
promotes it (``os.replace``) and rewrites the log to the still-pending
tail.

Mesh-wide serving (:meth:`MutableIndex.register_dist`,
:func:`build_dist_serve_ladder`): every epoch also holds a list-sharded
view of its index (``parallel.shard_ivf_flat`` / ``shard_ivf_pq``: views
where the ranks share a card) served by one ``serve.dist.DistSearchPlan``
per (shape, rung) at ``k + tombstone_slack``, and the tombstone filter
and the delta merge run as a standalone tail
(``program.compile_tail_program``) on the merged (nq, k) block, on rank
0's device. A compaction warms the next epoch's dist grid before the
swap. After a mesh rebuild (``compact(mode="rebuild", mesh=...)``) the
epoch's own lists are list-sharded; its single-device programs run over
the lists gathered once (``parallel.gather_index``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.interruptible import wait_ready
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.mutate import compact as compact_mod
from raft_tpu_torch.mutate import program as program_mod
from raft_tpu_torch.mutate.types import DeltaFullError, MutateConfig
from raft_tpu_torch.mutate.wal import (OP_DELETE, OP_META, OP_UPSERT,
                                       MutationWAL)
from raft_tpu_torch.obs import profiler, spans
from raft_tpu_torch.testing import faults
from raft_tpu_torch.util.host import host_array

__all__ = ["MutableIndex", "build_serve_ladder",
           "build_dist_serve_ladder"]


def _tomb_words(id_base: int) -> int:
    return max(1, -(-int(id_base) // 32))


def _set_tomb_bit(words: np.ndarray, id_: int) -> None:
    words[id_ >> 5] |= np.uint32(1 << (id_ & 31))


def _on_device(device) -> contextlib.AbstractContextManager:
    """``device`` as the calling thread's current CUDA device (the
    current device is per thread); a no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _checkpoint_identity(path: str) -> list:
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def _write_checkpoint_meta(ckpt_tmp: str, ckpt: str, meta: dict) -> None:
    """Promote the counters a checkpoint was folded under (``epoch``,
    ``id_base``, ``next_id``, ``folded_upto_seq``: the last log record
    the fold holds) to the sidecar beside ``ckpt``, BEFORE ``ckpt_tmp``
    itself is promoted. The sidecar names the file it belongs to by its
    size and modification time, which the rename keeps: a crash between
    the two promotions leaves a sidecar that matches no checkpoint, and
    :func:`_read_checkpoint_meta` ignores it."""
    side = ckpt + ".meta"
    body = dict(meta, checkpoint=_checkpoint_identity(ckpt_tmp))
    with open(side + ".tmp", "w") as f:
        json.dump(body, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(side + ".tmp", side)


def _read_checkpoint_meta(ckpt: str, identity: list) -> Optional[dict]:
    """The sidecar's counters when they belong to the checkpoint file
    whose ``[size, mtime_ns]`` is ``identity`` (the file a reader holds
    open), else None (no sidecar: a checkpoint written by the JAX
    package, or before the sidecar existed)."""
    try:
        with open(ckpt + ".meta") as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None
    if meta.get("checkpoint") != list(identity):
        return None
    return meta


def _load_checkpoint(ckpt: str, device) -> Tuple[object, Optional[dict]]:
    """``(index, sidecar counters or None)`` from ONE open of ``ckpt``:
    the sidecar is matched against the open file and the index read from
    it, so a fold promoting the next checkpoint meanwhile cannot pair one
    file's index with the other's counters."""
    from raft_tpu_torch.neighbors import serialize
    with open(ckpt, "rb") as f:
        st = os.fstat(f.fileno())
        meta = _read_checkpoint_meta(
            ckpt, [int(st.st_size), int(st.st_mtime_ns)])
        return serialize.load(f, device=device), meta


def _fold_window_skip(ckpt_meta: Optional[dict],
                      head_meta: Optional[dict]) -> Optional[int]:
    """The fold window: the last log seq the checkpoint already holds
    when its sidecar must be applied (the log's head is no meta record of
    the checkpoint's epoch or later: the checkpoint was promoted but the
    log not rewritten, so the log still holds the records it folded),
    else None (no sidecar, or a log rewritten after the fold)."""
    if ckpt_meta is None:
        return None
    if head_meta is not None and \
            int(head_meta.get("epoch", 0)) >= int(ckpt_meta["epoch"]):
        return None
    return int(ckpt_meta["folded_upto_seq"])


@dataclass
class _Epoch:
    """One immutable generation of the wrapped index plus its prepared
    program grid. Searches snapshot (epoch, device state) atomically; a
    compaction installs a fully warmed replacement."""

    index: object
    id_base: int                    # ids < id_base live in the main lists
    number: int
    tomb_words: int
    plans: Dict[tuple, object] = field(default_factory=dict)
    tails: Dict[tuple, object] = field(default_factory=dict)
    dist: Optional[dict] = None     # list-sharded view + DistSearchPlans
    # the index on one device (list-sharded lists gathered once), for
    # the single-device programs
    local: Optional[object] = None

    def local_index(self):
        if self.local is None:
            from raft_tpu_torch.parallel.ivf import gather_index
            from raft_tpu_torch.parallel.mesh import Sharded
            self.local = (gather_index(self.index) if isinstance(
                self.index.lists_indices, Sharded) else self.index)
        return self.local


@dataclass(frozen=True)
class _DeviceState:
    """The delta and tombstone operands on the device, pinned to the
    epoch and delta rung they were shaped for. Never written after it is
    published."""

    epoch_number: int
    rung: int
    delta_data: torch.Tensor
    delta_norms: torch.Tensor
    delta_ids: torch.Tensor
    tomb: torch.Tensor

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.delta_data, self.delta_norms, self.delta_ids,
                self.tomb)


class MutableIndex:
    """Live mutable wrapper over a built IVF index: ``upsert`` /
    ``delete`` / ``search`` under traffic, background compaction, no
    program prepared on the serving path once the grid is warm. ``k`` is
    fixed at construction (the plan contract); serving callers slice a
    smaller k as the batcher does. Tensors live on the wrapped index's
    device."""

    # static race contract: caller threads, the serving dispatcher and
    # the compactor meet on these fields; touch them only under
    # ``with self._cond`` or in ``_locked`` methods
    GUARDED_BY = ("_epoch", "_dev", "_delta_data", "_delta_norms",
                  "_delta_ids", "_delta_used", "_delta_live",
                  "_delta_map", "_tomb", "_tomb_ids", "_next_id",
                  "_compacting", "_frozen_id_base", "_pending_tombs",
                  "_rep", "_rungs", "_grid", "_dist_cfg", "_wal",
                  "_wal_ckpt", "_epoch_listeners")

    def __init__(self, index, k: int, params=None,
                 config: Optional[MutateConfig] = None):
        from raft_tpu_torch.neighbors import plan as plan_mod
        family, _ = plan_mod._resolve_builder(index)
        expects(getattr(index, "raw", None) is None,
                "mutate: the wrapped %s index carries a host rescore "
                "corpus (raw) whose id-indexing cannot survive "
                "deletes — rebuild with keep_raw=False (estimator + "
                "device tiers still apply)", family)
        self.family = family
        self.k = int(k)
        self.cfg = config if config is not None else MutateConfig()
        self.params = (params if params is not None
                       else plan_mod._default_params(family))
        self.device = index.device
        # the host-to-device copies of the snapshots run here, so a push
        # waits for its own copies, never for searches on other streams
        self._xfer = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._cond = threading.Condition()
        top = self.cfg.delta_capacities[-1]
        dim = int(index.dim)
        with self._cond:
            self._epoch = _Epoch(index=index, id_base=int(index.size),
                                 number=0,
                                 tomb_words=_tomb_words(index.size))
            self._delta_data = np.zeros((top, dim), np.float32)
            self._delta_norms = np.zeros((top,), np.float32)
            self._delta_ids = np.full((top,), -1, np.int32)
            self._delta_used = 0
            self._delta_live = 0
            self._delta_map: Dict[int, int] = {}
            self._tomb = np.zeros((self._epoch.tomb_words,), np.uint32)
            self._tomb_ids: set = set()
            self._next_id = int(index.size)
            self._compacting = False
            self._frozen_id_base = 0
            self._pending_tombs: set = set()
            self._rep: Optional[np.ndarray] = None
            self._rungs: Tuple[int, ...] = (
                min(self.params.n_probes, index.n_lists),)
            self._grid: set = set()
            self._dist_cfg: Optional[dict] = None
            self._wal: Optional[MutationWAL] = None
            self._wal_ckpt: Optional[str] = None
            self._epoch_listeners: Tuple = ()
            self._dev: Optional[_DeviceState] = None
            self._push_dev_locked()

    # -- introspection -----------------------------------------------------
    @property
    def dim(self) -> int:
        with self._cond:
            return int(self._epoch.index.dim)

    @property
    def metric(self) -> DistanceType:
        with self._cond:
            return self._epoch.index.metric

    @property
    def epoch(self) -> int:
        with self._cond:
            return self._epoch.number

    @property
    def index(self):
        """The CURRENT epoch's immutable inner index (pending delta rows
        and tombstones are NOT reflected — search through the
        MutableIndex for the live view)."""
        with self._cond:
            return self._epoch.index

    @property
    def size(self) -> int:
        """Live logical row count (main minus tombstones plus live delta
        rows; deletes of never-existing ids undercount)."""
        with self._cond:
            return (int(self._epoch.index.size) - len(self._tomb_ids)
                    + self._delta_live)

    def stats(self) -> dict:
        with self._cond:
            rung = self._rung_for_locked(self._delta_used)
            cap = self.cfg.delta_capacities[rung]
            return {
                "epoch": self._epoch.number,
                "id_base": self._epoch.id_base,
                "delta_used": self._delta_used,
                "delta_live": self._delta_live,
                "delta_rung": rung,
                "delta_capacity": cap,
                "delta_fill_frac": self._delta_used / cap,
                "tombstones": len(self._tomb_ids),
                "tombstone_frac": (len(self._tomb_ids)
                                   / max(1, self._epoch.id_base)),
                "compacting": self._compacting,
                "next_id": self._next_id,
            }

    def should_compact(self) -> bool:
        """The background compactor's trigger: used delta slots past
        ``compact_trigger_frac`` of the TOP rung, and no fold running."""
        with self._cond:
            trigger = (self.cfg.compact_trigger_frac
                       * self.cfg.delta_capacities[-1])
            return (not self._compacting
                    and self._delta_used >= trigger)

    # -- mutation ----------------------------------------------------------
    def upsert(self, vectors, ids=None) -> np.ndarray:
        """Insert-or-replace rows → the int32 ids they live under.
        Auto-assigned ids continue the monotone id space; passing an
        existing id replaces that row (tombstone + append). Raises
        :class:`DeltaFullError` when the delta segment is at its top
        rung — compaction is the only way to drain it."""
        x = program_mod._host_rows(vectors)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        with self._cond:
            dim = int(self._epoch.index.dim)
            metric = self._epoch.index.metric
        expects(x.ndim == 2 and x.shape[1] == dim,
                "mutate.upsert: vectors must be (n, dim=%d), got %s",
                dim, x.shape)
        if metric == DistanceType.CosineExpanded:
            # build() stores row-normalized vectors for cosine; the
            # delta segment must match or the ip core scores raw dots
            x = x / np.maximum(
                np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        top = self.cfg.delta_capacities[-1]
        with self._cond:
            if ids is None:
                expects(self._next_id + n < 2 ** 31,
                        "mutate.upsert: int32 id space exhausted")
                ids_arr = np.arange(self._next_id, self._next_id + n,
                                    dtype=np.int32)
            else:
                ids_arr = host_array(ids, np.int32).reshape(-1)
                expects(ids_arr.shape[0] == n and (ids_arr >= 0).all(),
                        "mutate.upsert: need %d non-negative ids", n)
            if self._delta_used + n > top:
                obs.counter("raft.mutate.delta.overflow.total").inc()
                raise DeltaFullError(
                    f"delta segment full ({self._delta_used}+{n} > "
                    f"top rung {top}): waiting on compaction")
            if self._wal is not None:
                # write-ahead: the record is durable (fsync'd) BEFORE
                # the in-memory apply, so an ack implies recoverability;
                # an append that made it to disk without the apply
                # (crash in between) replays harmlessly — the caller
                # was never acked, and at-least-once replay of explicit
                # ids reproduces the same logical state.  The fsync
                # MUST happen under the mutation lock (GL008): the log
                # must preserve the total mutation order the lock
                # defines, and durable-before-apply is only atomic
                # while the lock pins the apply.
                self._wal.append_upsert(ids_arr, x)  # graftlint: disable=GL008
            slots = np.arange(self._delta_used, self._delta_used + n)
            self._delta_data[slots] = x
            self._delta_norms[slots] = (x * x).sum(axis=1)
            self._delta_ids[slots] = ids_arr
            self._delta_used += n
            self._delta_live += n
            for j in range(n):
                id_ = int(ids_arr[j])
                old = self._delta_map.pop(id_, None)
                if old is not None:
                    self._delta_ids[old] = -1   # shadowed delta row
                    self._delta_live -= 1
                self._delta_map[id_] = int(slots[j])
                self._tombstone_locked(id_)
                self._next_id = max(self._next_id, id_ + 1)
            obs.counter("raft.mutate.upserts.total").inc()
            obs.counter("raft.mutate.upserts.rows").inc(n)
            self._push_dev_locked()
            self._cond.notify_all()
        return ids_arr

    def delete(self, ids) -> int:
        """Tombstone rows by id → number of ids newly marked dead.
        Main-index rows are filtered after the main top-k until the next
        compaction purges them; delta rows die in place."""
        ids_arr = host_array(ids, np.int64).reshape(-1)
        hit = 0
        with self._cond:
            if self._wal is not None:
                # same justified hold as upsert's append (GL008): the
                # WAL's total-order + durable-before-apply contract is
                # defined BY this lock
                self._wal.append_delete(ids_arr)  # graftlint: disable=GL008
            for id_ in ids_arr:
                id_ = int(id_)
                dead = False
                slot = self._delta_map.pop(id_, None)
                if slot is not None:
                    self._delta_ids[slot] = -1
                    self._delta_live -= 1
                    dead = True
                if self._tombstone_locked(id_):
                    dead = True
                hit += bool(dead)
            obs.counter("raft.mutate.deletes.total").inc()
            obs.counter("raft.mutate.deletes.rows").inc(
                int(ids_arr.shape[0]))
            self._push_dev_locked()
        return hit

    def _tombstone_locked(self, id_: int) -> bool:
        """Mark one id dead in the main-index bitmap (and the pending
        replay set while a fold is in flight) → True when the bit was
        newly set."""
        fresh = False
        if id_ < self._epoch.id_base and id_ not in self._tomb_ids:
            self._tomb_ids.add(id_)
            _set_tomb_bit(self._tomb, id_)
            fresh = True
        if self._compacting and id_ < self._frozen_id_base:
            self._pending_tombs.add(id_)
        return fresh

    # -- device state ------------------------------------------------------
    def _rung_for_locked(self, used: int) -> int:
        for r, cap in enumerate(self.cfg.delta_capacities):
            if used <= cap:
                return r
        return len(self.cfg.delta_capacities) - 1

    def _upload(self, arrays) -> Tuple[torch.Tensor, ...]:
        """Fresh device tensors holding copies of ``arrays``, complete
        when this returns: copied on the transfer stream, which is then
        waited for (on the CPU, fresh host copies)."""
        host = tuple(torch.from_numpy(np.array(a)) for a in arrays)
        if self._xfer is None:
            return host
        with torch.cuda.device(self.device), torch.cuda.stream(self._xfer):
            out = tuple(h.to(self.device, non_blocking=True) for h in host)
        self._xfer.synchronize()
        return out

    def _push_dev_locked(self) -> None:
        """Publish a new device snapshot after a state change: the delta
        buffer at the CURRENT rung capacity and the bitmap (its uint32
        bits as int32). Plain host-to-device copies, bounded by the top
        rung and the id space, atomic with the host-state change
        (publishing outside the lock would let an older snapshot replace
        a newer one)."""
        rung = self._rung_for_locked(self._delta_used)
        cap = self.cfg.delta_capacities[rung]
        try:
            faults.inject("mutate.transfer", epoch=self._epoch.number)
            self._dev = _DeviceState(
                self._epoch.number, rung, *self._upload((
                    self._delta_data[:cap], self._delta_norms[:cap],
                    self._delta_ids[:cap], self._tomb.view(np.int32))))
        except Exception:
            # a failed refresh leaves the PREVIOUS consistent snapshot
            # serving (stale by exactly this mutation); the caller sees
            # the error and the next successful mutation repairs the view
            obs.counter("raft.mutate.transfer.errors").inc()
            raise
        self._set_gauges_locked(rung, cap)

    def _set_gauges_locked(self, rung: int, cap: int) -> None:
        top = len(self.cfg.delta_capacities) - 1
        obs.gauge("raft.mutate.epoch").set(self._epoch.number)
        obs.gauge("raft.mutate.delta.rows").set(self._delta_live)
        obs.gauge("raft.mutate.delta.capacity").set(cap)
        obs.gauge("raft.mutate.delta.rung").set(rung)
        obs.gauge("raft.mutate.delta.fill_frac").set(
            round(self._delta_used / cap, 4))
        # a delta at its TOP rung with no fold in flight is a stalled
        # compactor
        obs.gauge("raft.mutate.delta.stalled").set(
            1.0 if (rung == top and not self._compacting) else 0.0)
        obs.gauge("raft.mutate.tombstone.rows").set(len(self._tomb_ids))
        obs.gauge("raft.mutate.tombstone.frac").set(
            round(len(self._tomb_ids) / max(1, self._epoch.id_base), 6))
        obs.gauge("raft.mutate.compact.inflight").set(
            1.0 if self._compacting else 0.0)

    # -- search ------------------------------------------------------------
    def search(self, queries, k: Optional[int] = None,
               block: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search the LIVE view (main minus tombstones plus delta) →
        (dists, ids), both (nq, k), on the index's device. Any nq: a cold
        shape prepares its program once (counted under
        ``raft.plan.cache.misses``) and caches it on the epoch; warmed
        shapes never prepare again."""
        expects(k is None or int(k) == self.k,
                "mutate.search: k=%s != plan k=%d (fixed at "
                "construction; slice smaller k caller-side)", k, self.k)
        return self._search_rung(queries, 0, block)

    def _search_rung(self, queries, rung_idx: int, block: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        from raft_tpu_torch.neighbors.plan import _stream_events
        # resource profiler admission (one None read when off): a sampled
        # blocking call is split into its host half and its device half,
        # two CUDA events around the program's work on its stream (on the
        # CPU, the wait itself), as ``SearchPlan.search`` splits it
        prof = block and profiler.sampled()
        t_call = time.perf_counter()
        q = torch.as_tensor(queries, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        q = q.to(self.device).contiguous()
        entry, dev = self._entry_for(q.shape[0], rung_idx, queries)
        if q.is_cuda:
            # the snapshot's memory must outlive this stream's use of it
            stream = torch.cuda.current_stream(q.device)
            for t in dev.tensors():
                t.record_stream(stream)
        events = _stream_events(q) if prof else None
        if events is not None:
            events[0].record(events[2])
        d, i = entry.run(q, *dev.tensors())
        if events is not None:
            events[1].record(events[2])
        if block:
            t_enq = time.perf_counter()
            wait_ready((d, i))
            if prof:
                t_ready = time.perf_counter()
                device_s = (events[0].elapsed_time(events[1]) / 1e3
                            if events is not None else t_ready - t_enq)
                spans.add_child_span(
                    profiler.SYNC_SPAN, t_enq, t_ready - t_enq,
                    program="mutate",
                    host_ms=round((t_enq - t_call) * 1e3, 3),
                    device_ms=round(device_s * 1e3, 3))
                profiler.record_sample(
                    program="mutate", family=self.family, rung=rung_idx,
                    host_s=t_enq - t_call, device_s=device_s)
        return d, i

    def _entry_for(self, nq: int, rung_idx: int, rep_q):
        """Atomically snapshot (prepared entry, device state) for the
        current epoch at the current delta rung, preparing the entry
        outside the lock when cold."""
        while True:
            with self._cond:
                epoch = self._epoch
                dev = self._dev
                entry = epoch.plans.get((nq, rung_idx, dev.rung))
            if entry is not None and dev.epoch_number == epoch.number:
                return entry, dev
            self._build_entry(epoch, nq, rung_idx, dev.rung, rep_q)

    def _build_entry(self, epoch: _Epoch, nq: int, rung_idx: int,
                     delta_rung: int, rep_q=None, warm: bool = True):
        """Prepare one (nq, n_probes-rung, delta-rung) program for
        ``epoch``, counted as a plan-cache miss, inserted under the
        lock."""
        key = (nq, rung_idx, delta_rung)
        with self._cond:
            entry = epoch.plans.get(key)
            if entry is not None:
                return entry
            rep = self._rep if self._rep is not None else rep_q
            n_probes = self._rungs[min(rung_idx, len(self._rungs) - 1)]
        expects(rep is not None,
                "mutate: no representative queries available — call "
                "warmup() before background prewarm")
        rep = program_mod._host_rows(rep)
        params = dataclasses.replace(self.params, n_probes=n_probes)
        delta_cap = self.cfg.delta_capacities[delta_rung]
        entry = program_mod.compile_mutate_program(
            epoch.local_index(), rep, nq, self.k, params, delta_cap,
            epoch.tomb_words, slack=self.cfg.tombstone_slack)
        if warm:
            # run once on empty delta operands, so the first served call
            # of this entry loads no kernel library and measures nothing
            dev = self.device
            reps = -(-nq // rep.shape[0])
            qw = torch.from_numpy(np.tile(rep, (reps, 1))[:nq]).to(dev)
            wait_ready(entry.run(
                qw, torch.zeros((delta_cap, rep.shape[1]), device=dev),
                torch.zeros((delta_cap,), device=dev),
                torch.full((delta_cap,), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((epoch.tomb_words,), dtype=torch.int32,
                            device=dev)))
        with self._cond:
            cur = epoch.plans.get(key)
            if cur is None:
                epoch.plans[key] = entry
            else:
                entry = cur
        return entry

    # -- warmup / ladder registration --------------------------------------
    def warmup(self, rep_queries,
               shapes: Tuple[int, ...] = (1, 8, 32, 128),
               probes_ladder: Tuple[int, ...] = ()) -> "MutableIndex":
        """Prepare and warm the full (shape × n_probes-rung × delta-rung)
        program grid so steady-state traffic — delta growth across rung
        boundaries and post-compaction epochs included — never prepares
        a program. The grid is remembered: the compactor warms every
        future epoch to it BEFORE swapping it in."""
        rep = program_mod._host_rows(rep_queries)
        with self._cond:
            index = self._epoch.index
        expects(rep.ndim == 2 and rep.shape[1] == index.dim,
                "mutate.warmup: rep_queries must be (nq, dim=%d), "
                "got %s", index.dim, rep.shape)
        with self._cond:
            self._rep = rep
            if probes_ladder:
                self._rungs = tuple(
                    min(p, index.n_lists) for p in probes_ladder)
            self._grid |= {(int(s), r) for s in shapes
                           for r in range(len(self._rungs))}
            epoch = self._epoch
        self._prewarm_epoch(epoch)
        return self

    def _warm_delta_rungs(self) -> range:
        n = len(self.cfg.delta_capacities)
        if self.cfg.prewarm_rungs > 0:
            n = min(n, self.cfg.prewarm_rungs)
        return range(n)

    def _prewarm_epoch(self, epoch: _Epoch) -> None:
        """Prepare and warm the registered grid for ``epoch`` (on the
        warmup caller or the compactor, never the serving path)."""
        with self._cond:
            grid = sorted(self._grid)
            dist_cfg = self._dist_cfg
        for (nq, rung_idx) in grid:
            for dr in self._warm_delta_rungs():
                self._build_entry(epoch, nq, rung_idx, dr)
        if dist_cfg is not None:
            self._prewarm_dist(epoch, dist_cfg)

    # -- distributed serving -----------------------------------------------
    def register_dist(self, mesh, axis: str, rep_queries,
                      shapes: Tuple[int, ...],
                      probes_ladder: Tuple[int, ...] = (),
                      merge: Optional[str] = None) -> None:
        """Attach a mesh: every epoch (this one and each compaction's)
        also warms a list-sharded view of its index served by
        ``DistSearchPlan`` ``shard_map`` runs at ``k + tombstone_slack``
        (``merge``: the cross-shard wire format, int8 unless
        ``RAFT_TPU_DIST_MERGE`` says otherwise), with the delta merge and
        the tombstone filter as a tail after the cross-shard merge (the
        delta segment is not sharded: it is orders of magnitude smaller
        than the lists)."""
        from raft_tpu_torch.serve.merge import merge_mode
        rep = program_mod._host_rows(rep_queries)
        with self._cond:
            index = self._epoch.index
            self._rep = rep if self._rep is None else self._rep
            if probes_ladder:
                self._rungs = tuple(probes_ladder)
            cfg = {"mesh": mesh, "axis": axis,
                   "shapes": tuple(int(s) for s in shapes),
                   "merge": (merge_mode(default="int8")
                             if merge is None else merge)}
            self._dist_cfg = cfg
            epoch = self._epoch
        expects(self.family in ("ivf_flat", "ivf_pq"),
                "mutate.register_dist: mesh-wide serving takes ivf_flat "
                "or ivf_pq indexes, not %s", self.family)
        expects(index.n_lists % mesh.shape[axis] == 0,
                "mutate.register_dist: n_lists=%d not divisible by %d "
                "shards", index.n_lists, mesh.shape[axis])
        self._prewarm_dist(epoch, cfg)

    def _prewarm_dist(self, epoch: _Epoch, cfg: dict) -> None:
        """Shard ``epoch``'s index over the registered mesh, build and
        warm one ``DistSearchPlan`` per (shape, rung), then the tails."""
        from raft_tpu_torch.parallel import ivf as pivf
        from raft_tpu_torch.serve.dist import DistSearchPlan
        mesh, axis = cfg["mesh"], cfg["axis"]
        with self._cond:
            rep = self._rep
            rungs = self._rungs
        shard = (pivf.shard_ivf_flat if self.family == "ivf_flat"
                 else pivf.shard_ivf_pq)
        sharded = shard(epoch.index, mesh, axis=axis)
        comms = pivf.get_comms(mesh, axis)
        plans = {}
        d_dt = i_dt = None
        # the mesh-wide main phase over-fetches k + slack candidates, so
        # the tail's tombstone filter never costs a result slot
        k_fetch = self.k + self.cfg.tombstone_slack
        for ri, n_probes in enumerate(rungs):
            p_r = dataclasses.replace(self.params, n_probes=n_probes)
            for s in cfg["shapes"]:
                dp = DistSearchPlan(self.family, sharded, mesh, axis, s,
                                    k_fetch, p_r, cfg["merge"], comms,
                                    level=ri)
                reps = -(-s // rep.shape[0])
                d, i = dp.search(np.tile(rep, (reps, 1))[:s], block=True)
                d_dt, i_dt = d.dtype, i.dtype
                plans[(s, ri)] = dp
        epoch.dist = {"index": sharded, "plans": plans,
                      "d_dtype": d_dt, "i_dtype": i_dt}
        dim = int(epoch.index.dim)
        for s in cfg["shapes"]:
            for dr in self._warm_delta_rungs():
                self._build_tail(epoch, s, dr, dim)

    def _build_tail(self, epoch: _Epoch, nq: int, delta_rung: int,
                    dim: int):
        """The (nq, delta-rung) tail of ``epoch``'s dist grid, prepared
        once (counted as a plan-cache miss)."""
        key = (nq, delta_rung)
        with self._cond:
            tail = epoch.tails.get(key)
        if tail is not None:
            return tail
        dist = epoch.dist
        tail = program_mod.compile_tail_program(
            nq, self.k, dim, epoch.index.metric,
            self.cfg.delta_capacities[delta_rung], epoch.tomb_words,
            k_main=self.k + self.cfg.tombstone_slack,
            d_dtype=dist["d_dtype"], i_dtype=dist["i_dtype"])
        with self._cond:
            cur = epoch.tails.get(key)
            if cur is None:
                epoch.tails[key] = tail
            else:
                tail = cur
        return tail

    def _dist_search(self, nq: int, rung_idx: int, queries,
                     block: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One mesh-wide search of the live view: the epoch's
        ``DistSearchPlan`` at (nq, rung), then the tail over the current
        delta and tombstones where the merged block landed."""
        q = program_mod._host_rows(queries)
        with self._cond:
            epoch = self._epoch
            dev = self._dev
            dist_cfg = self._dist_cfg
        if epoch.dist is None:
            # a mesh registered after this epoch was built (a cold path,
            # outside the steady-state contract): shard and warm it now
            expects(dist_cfg is not None,
                    "mutate: no mesh registered (register_dist)")
            self._prewarm_dist(epoch, dist_cfg)
        dp = epoch.dist["plans"][(nq, rung_idx)]
        d, i = dp.search(q, block=False)
        d, i = d.to(self.device), i.to(self.device)
        if d.is_cuda:
            stream = torch.cuda.current_stream(d.device)
            for t in dev.tensors():
                t.record_stream(stream)
        tail = epoch.tails.get((nq, dev.rung))
        if tail is None:
            tail = self._build_tail(epoch, nq, dev.rung, q.shape[1])
        d, i = tail.run(torch.from_numpy(q).to(self.device), d, i,
                        *dev.tensors())
        if block:
            wait_ready((d, i))
        return d, i

    def _dist_plan(self, nq: int, rung_idx: int):
        """The current epoch's ``DistSearchPlan`` at a grid point (the
        serving tier's gauges read it)."""
        with self._cond:
            dist = self._epoch.dist
        expects(dist is not None,
                "mutate: no mesh registered (register_dist)")
        return dist["plans"][(nq, rung_idx)]

    # -- epoch listeners ---------------------------------------------------
    def add_epoch_listener(self, fn) -> "MutableIndex":
        """Register ``fn(new_epoch_number)`` to run after every
        compaction's epoch swap (on the compacting thread, OUTSIDE the
        lock: listeners may touch this index). The quality monitor
        subscribes its :meth:`~raft_tpu_torch.obs.quality.QualityMonitor.
        note_epoch` here, so recall windows split exactly where the fold
        did."""
        with self._cond:
            self._epoch_listeners = self._epoch_listeners + (fn,)
        return self

    def _notify_epoch_listeners(self, number: int) -> None:
        with self._cond:
            listeners = self._epoch_listeners
        for fn in listeners:
            try:
                fn(number)
            except Exception as e:
                obs.counter("raft.mutate.epoch_listener.errors").inc()
                get_logger("mutate").warning(
                    "mutate: epoch listener %r failed for epoch %d: "
                    "%r", fn, number, e)

    # -- compaction --------------------------------------------------------
    def compact(self, mode: Optional[str] = None, mesh=None,
                axis: str = "data") -> bool:
        """Fold the delta and tombstones into the main lists and swap the
        epoch — under live traffic, with the next epoch's grid prepared
        and warmed HERE, on the calling or compactor thread, before the
        swap. Returns False when a fold is already in flight."""
        # fault-injection site (kill_compactor): raises BEFORE any state
        # is frozen, so a killed fold leaves serving untouched
        faults.inject("mutate.compact")
        with self._cond:
            if self._compacting:
                return False
            self._compacting = True
            self._frozen_id_base = self._next_id
            self._pending_tombs = set()
            used = self._delta_used
            live = self._delta_ids[:used] >= 0
            snap_rows = self._delta_data[:used][live].copy()
            snap_ids = self._delta_ids[:used][live].copy()
            snap_tombs = frozenset(self._tomb_ids)
            freeze_used = used
            # the last logged mutation the fold holds: a checkpoint
            # promoted without its log rewrite skips up to here
            folded_seq = (self._wal.next_seq - 1
                          if self._wal is not None else 0)
            old_epoch = self._epoch
            new_id_base = self._frozen_id_base
            self._set_gauges_locked(
                self._rung_for_locked(used),
                self.cfg.delta_capacities[self._rung_for_locked(used)])
        mode = mode if mode is not None else self.cfg.compact_mode
        try:
            with spans.span("raft.mutate.compact",
                            epoch=old_epoch.number, mode=mode,
                            rows=int(snap_rows.shape[0]),
                            tombstones=len(snap_tombs)) as sp, \
                    obs.timed("raft.mutate.compact"), \
                    _on_device(self.device):
                new_index = compact_mod.fold(
                    old_epoch.index, snap_rows, snap_ids, snap_tombs,
                    mode=mode, mesh=mesh, axis=axis,
                    stream_chunk=self.cfg.rebuild_stream_chunk)
                new_epoch = _Epoch(index=new_index,
                                   id_base=new_id_base,
                                   number=old_epoch.number + 1,
                                   tomb_words=_tomb_words(new_id_base))
                # warm the whole registered grid for the NEW epoch before
                # anyone can route to it; serving keeps running the old
                # epoch's programs meanwhile
                self._prewarm_epoch(new_epoch)
                sp.set_attr("new_size", int(new_index.size))
                ckpt_tmp = self._checkpoint_epoch(new_index)
            self._swap_epoch(new_epoch, freeze_used, new_id_base,
                             ckpt_tmp=ckpt_tmp, folded_seq=folded_seq)
            obs.counter("raft.mutate.compact.total").inc()
            self._notify_epoch_listeners(new_epoch.number)
            return True
        except BaseException:
            obs.counter("raft.mutate.compact.errors").inc()
            with self._cond:
                self._compacting = False
                self._push_dev_locked()
            raise

    def _checkpoint_epoch(self, new_index) -> Optional[str]:
        """Save the folded inner index beside the WAL checkpoint path (a
        tmp file; the swap promotes it atomically) through
        ``serialize.save`` → the tmp path. None when no WAL or no
        checkpoint is configured: then the log is never truncated and
        recovery replays it in full onto the original base index."""
        with self._cond:
            wal, ckpt = self._wal, self._wal_ckpt
        if wal is None or not ckpt:
            return None
        from raft_tpu_torch.neighbors import serialize
        tmp = ckpt + ".tmp"
        serialize.save(new_index, tmp)
        return tmp

    def _swap_epoch(self, new_epoch: _Epoch, freeze_used: int,
                    new_id_base: int, ckpt_tmp: Optional[str] = None,
                    folded_seq: int = 0) -> None:
        with self._cond:
            # rebase the delta: rows appended after the freeze slide to
            # the front; everything folded leaves the segment
            tail_n = self._delta_used - freeze_used
            if tail_n:
                self._delta_data[:tail_n] = \
                    self._delta_data[freeze_used:self._delta_used].copy()
                self._delta_norms[:tail_n] = \
                    self._delta_norms[freeze_used:self._delta_used].copy()
                self._delta_ids[:tail_n] = \
                    self._delta_ids[freeze_used:self._delta_used].copy()
            self._delta_ids[tail_n:self._delta_used] = -1
            self._delta_used = tail_n
            self._delta_map = {
                int(i): s for s, i in
                enumerate(self._delta_ids[:tail_n]) if i >= 0}
            self._delta_live = len(self._delta_map)
            # deletes that raced the fold replay onto the new bitmap
            self._tomb_ids = {i for i in self._pending_tombs
                              if i < new_id_base}
            self._pending_tombs = set()
            self._tomb = np.zeros((new_epoch.tomb_words,), np.uint32)
            for id_ in self._tomb_ids:
                _set_tomb_bit(self._tomb, id_)
            self._epoch = new_epoch
            self._compacting = False
            if self._wal is not None and ckpt_tmp is not None:
                # promote the checkpoint's counters, then the checkpoint,
                # then truncate the log to the still-pending tail:
                # deletes first, then live tail upserts, so a replayed
                # tail upsert re-shadows its tombstoned main row (each
                # step atomic; a crash after the checkpoint's promotion
                # leaves the old full log, and recover() takes the
                # counters from the sidecar and skips the folded records)
                meta = {"epoch": new_epoch.number,
                        "id_base": new_epoch.id_base,
                        "next_id": self._next_id}
                _write_checkpoint_meta(
                    ckpt_tmp, self._wal_ckpt,
                    dict(meta, folded_upto_seq=int(folded_seq)))
                os.replace(ckpt_tmp, self._wal_ckpt)
                live = self._delta_ids[:self._delta_used] >= 0
                # justified hold (GL008): the checkpoint promotion and
                # the log truncation to the still-pending tail must be
                # atomic with the epoch swap itself — a mutation landing
                # between swap and rewrite would be lost from the log;
                # this runs once per compaction, on the compactor thread
                self._wal.rewrite(  # graftlint: disable=GL008
                    meta=meta,
                    tomb_ids=np.asarray(sorted(self._tomb_ids),
                                        np.int64),
                    upsert_ids=self._delta_ids[:self._delta_used][live],
                    upsert_rows=self._delta_data[:self._delta_used][live])
            self._push_dev_locked()
            self._cond.notify_all()

    def apply_meta(self, meta: dict) -> "MutableIndex":
        """Restore the epoch and id-space counters a checkpointed inner
        index was folded under, before any mutation is applied: the WAL
        meta record at the head of a post-compaction log, applied by
        :meth:`recover` before it replays the tail. ``id_base`` may
        exceed the inner index's row count: ids are a space, rows a
        count."""
        with self._cond:
            expects(self._delta_used == 0 and not self._tomb_ids,
                    "mutate.apply_meta: only valid before any mutation "
                    "is applied (%d delta rows, %d tombstones pending)",
                    self._delta_used, len(self._tomb_ids))
            id_base = int(meta["id_base"])
            self._epoch = _Epoch(index=self._epoch.index,
                                 id_base=id_base,
                                 number=int(meta["epoch"]),
                                 tomb_words=_tomb_words(id_base))
            self._tomb = np.zeros((self._epoch.tomb_words,), np.uint32)
            self._next_id = int(meta["next_id"])
            self._push_dev_locked()
        return self

    # -- durability: the mutation WAL --------------------------------------
    def attach_wal(self, wal: MutationWAL,
                   checkpoint_path: Optional[str] = None
                   ) -> "MutableIndex":
        """Make every acknowledged mutation durable: subsequent
        ``upsert`` / ``delete`` calls append + fsync their WAL record
        BEFORE the in-memory apply, so :meth:`recover` replays 100% of
        them after process death. ``checkpoint_path`` also lets
        compactions truncate the log: the folded inner index is saved
        there (tmp + atomic replace at the epoch swap) and the WAL is
        rewritten to the still-pending tail; without it the log grows and
        recovery replays it in full onto the original base index."""
        with self._cond:
            self._wal = wal
            self._wal_ckpt = checkpoint_path
        return self

    @classmethod
    def recover(cls, wal_path: str, k: int, base_index=None,
                checkpoint_path: Optional[str] = None, params=None,
                config: Optional[MutateConfig] = None,
                sync: bool = True, device=None) -> "MutableIndex":
        """Rebuild the live mutable state after process death: load the
        latest durable inner index (the compaction checkpoint when one
        exists, through ``serialize.load`` onto ``device``: by default
        ``base_index``'s device, else ``cuda``; else ``base_index``, the
        index the WAL was started against), replay every acknowledged
        mutation from the log in order, and re-attach the log for new
        writes. Replay is at-least-once over explicit ids, so a record
        that was fsync'd but never acknowledged reproduces the same
        logical state; a replay that overflows the delta segment
        compacts inline and continues — recovery never fails on
        volume."""
        if device is None:
            device = (base_index.device if base_index is not None
                      else "cuda")
        ckpt_meta = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            inner, ckpt_meta = _load_checkpoint(checkpoint_path, device)
        else:
            inner = base_index
        expects(inner is not None,
                "mutate.recover: no checkpoint at %r and no base_index "
                "— recovery needs the index the WAL was started "
                "against", checkpoint_path)
        wal = MutationWAL(wal_path, sync=sync)
        records = wal.replay()
        m = cls(inner, k=int(k), params=params, config=config)
        head = (records[0].meta if records and records[0].op == OP_META
                else None)
        upto = _fold_window_skip(ckpt_meta, head)
        if upto is not None:
            m.apply_meta(ckpt_meta)
            records = [r for r in records if r.seq > upto]
        elif head is not None:
            m.apply_meta(head)
            records = records[1:]
        top = m.cfg.delta_capacities[-1]
        for rec in records:
            if rec.op == OP_DELETE:
                m.delete(rec.ids)
            elif rec.op == OP_UPSERT:
                ids32 = np.asarray(rec.ids, np.int32)
                # chunk to the top rung: the log may have been written
                # under a LARGER delta budget than the recovering
                # process configures
                for s in range(0, ids32.shape[0], top):
                    try:
                        m.upsert(rec.rows[s:s + top],
                                 ids=ids32[s:s + top])
                    except DeltaFullError:
                        m.compact()
                        m.upsert(rec.rows[s:s + top],
                                 ids=ids32[s:s + top])
        m.attach_wal(wal, checkpoint_path=checkpoint_path)
        return m

    # -- persistence (neighbors/serialize.py) ------------------------------
    def export_state(self) -> dict:
        """Consistent snapshot for :func:`serialize.save_mutable`."""
        with self._cond:
            used = self._delta_used
            return {
                "index": self._epoch.index,
                "epoch": self._epoch.number,
                "id_base": self._epoch.id_base,
                "next_id": self._next_id,
                "k": self.k,
                "delta_data": self._delta_data[:used].copy(),
                "delta_ids": self._delta_ids[:used].copy(),
                "tomb_ids": np.asarray(sorted(self._tomb_ids),
                                       np.int64),
            }

    @classmethod
    def restore(cls, index, state: dict, params=None,
                config: Optional[MutateConfig] = None
                ) -> "MutableIndex":
        """Rebuild a MutableIndex from an :meth:`export_state` payload:
        pending delta rows and tombstones survive the round trip."""
        m = cls(index, k=int(state["k"]), params=params, config=config)
        rows = np.asarray(state["delta_data"], np.float32)
        ids = np.asarray(state["delta_ids"], np.int32)
        tombs = np.asarray(state["tomb_ids"], np.int64)
        with m._cond:
            id_base = int(state["id_base"])
            m._epoch = _Epoch(index=index, id_base=id_base,
                              number=int(state["epoch"]),
                              tomb_words=_tomb_words(id_base))
            n = rows.shape[0]
            expects(n <= m.cfg.delta_capacities[-1],
                    "mutate.restore: %d saved delta rows exceed the "
                    "configured top rung %d", n,
                    m.cfg.delta_capacities[-1])
            m._delta_data[:n] = rows
            m._delta_norms[:n] = (rows * rows).sum(axis=1)
            m._delta_ids[:n] = ids
            m._delta_used = n
            m._delta_map = {int(i): s for s, i in enumerate(ids)
                            if i >= 0}
            m._delta_live = len(m._delta_map)
            m._tomb_ids = {int(i) for i in tombs}
            m._tomb = np.zeros((m._epoch.tomb_words,), np.uint32)
            for id_ in m._tomb_ids:
                _set_tomb_bit(m._tomb, id_)
            m._next_id = int(state["next_id"])
            m._push_dev_locked()
        return m


# ---------------------------------------------------------------------------
# serving-tier glue: PlanLadder handles over a MutableIndex
# ---------------------------------------------------------------------------


class _MutableServePlan:
    """Plan-like handle (the :class:`PlanLadder` contract: ``search``,
    ``nq``, ``n_probes``, ``device``) pinned to one (shape, rung) point;
    the current epoch's program at the current delta rung is resolved per
    call, so the ladder survives every compaction."""

    def __init__(self, mindex: MutableIndex, nq: int, rung: int,
                 n_probes: int):
        self._m = mindex
        self.nq = int(nq)
        self.rung = int(rung)
        self.n_probes = int(n_probes)
        self.device = mindex.device

    def search(self, queries, block: bool = False):
        return self._m._search_rung(queries, self.rung, block)


class _MutableDistPlan:
    """The mesh-wide counterpart: the current epoch's
    ``DistSearchPlan`` (one cached ``shard_map`` run), then the tail over
    the delta and the tombstones, resolved per call."""

    dist_like = True     # accepted by DistributedSearchServer

    def __init__(self, mindex: MutableIndex, nq: int, rung: int,
                 n_probes: int):
        self._m = mindex
        self.nq = int(nq)
        self.rung = int(rung)
        self.n_probes = int(n_probes)
        self.device = mindex.device

    @property
    def mesh(self):
        return self._m._dist_plan(self.nq, self.rung).mesh

    @property
    def n_shards(self) -> int:
        return self._m._dist_plan(self.nq, self.rung).n_shards

    @property
    def merge_ratio(self) -> float:
        return self._m._dist_plan(self.nq, self.rung).merge_ratio

    def search(self, queries, block: bool = False):
        return self._m._dist_search(self.nq, self.rung, queries, block)


def build_serve_ladder(mindex: MutableIndex, rep_queries,
                       shapes: Tuple[int, ...] = (1, 8, 32, 128),
                       probes_ladder: Tuple[int, ...] = (),
                       prewarm: bool = True):
    """The mutable analogue of :meth:`PlanLadder.build`: prepare and warm
    the (shape × rung × delta-rung) grid on the CURRENT epoch, register
    it so compactions warm every future epoch, and return a
    :class:`PlanLadder` of stable handles the micro-batcher serves from
    across epoch swaps."""
    from raft_tpu_torch.serve.ladder import PlanLadder
    if prewarm:
        mindex.warmup(rep_queries, shapes=shapes,
                      probes_ladder=probes_ladder)
    else:
        with mindex._cond:
            mindex._rep = program_mod._host_rows(rep_queries)
            if probes_ladder:
                mindex._rungs = tuple(probes_ladder)
            mindex._grid |= {(int(s), r) for s in shapes
                             for r in range(len(mindex._rungs))}
    with mindex._cond:
        rungs = mindex._rungs
    plans = {(s, r): _MutableServePlan(mindex, s, r, rungs[r])
             for s in shapes for r in range(len(rungs))}
    return PlanLadder(shapes=tuple(shapes), rungs=rungs, plans=plans,
                      dim=mindex.dim, k=mindex.k)


def build_dist_serve_ladder(mindex: MutableIndex, rep_queries,
                            mesh=None, axis: str = "data",
                            shapes: Tuple[int, ...] = (1, 8, 32, 128),
                            probes_ladder: Tuple[int, ...] = (),
                            merge: Optional[str] = None):
    """Mesh-wide mutable serving: list-shard the current epoch, build and
    warm its ``DistSearchPlan`` grid and tails, and register the mesh so
    every compaction shards and warms the next epoch before the swap →
    a :class:`PlanLadder` of stable mesh-wide handles."""
    from raft_tpu_torch.serve.ladder import PlanLadder
    expects(mesh is not None, "build_dist_serve_ladder: mesh required")
    mindex.register_dist(mesh, axis, rep_queries, shapes=shapes,
                         probes_ladder=probes_ladder, merge=merge)
    with mindex._cond:
        rungs = mindex._rungs
    plans = {}
    for s in shapes:
        for r in range(len(rungs)):
            dp = mindex._dist_plan(s, r)
            plans[(s, r)] = _MutableDistPlan(mindex, s, r, dp.n_probes)
    return PlanLadder(shapes=tuple(shapes), rungs=rungs, plans=plans,
                      dim=mindex.dim, k=mindex.k)

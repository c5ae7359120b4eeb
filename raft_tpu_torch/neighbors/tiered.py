"""Tiered device/host-RAM IVF serving: hot lists pinned on the device,
cold lists staged under the hot-tier scan (counterpart of
``raft_tpu.neighbors.tiered``).

An index must otherwise be fully device-resident to serve, so device
memory, not the corpus, caps the rows a card serves. ``host_memory``
serves past that but moves the whole probe working set every batch.
This module splits the difference with two tiers:

* **hot tier** — the highest-probe-mass lists live in a fixed-capacity
  device table (``(hot_cap + 1, max_list, ...)``; the extra slot is a
  permanent zeros/-1 pad target). Hotness is an EMA over per-list probe
  mass (``_ivf_scan.ProbeStats``); promotion and demotion happen ONLY at
  :meth:`TieredIndex.refresh` boundaries, under a device byte budget
  (``TieredConfig``: explicit bytes, a fraction of the list payload, or
  the card's free memory less the profiler's ``headroom_frac``
  guardrail, read from the allocator through ``core.memory.hbm_stats``).
  Capacity moves along the ``hot_capacities`` pow2 ladder, and the policy
  never allocates a table the budget cannot hold.
* **cold tier** — everything else stays in host RAM in the
  ``HostIvfFlat`` padded layout. Per batch, the cold lists the batch
  probes are gathered (``np.take``) into pooled PINNED staging buffers
  of the ``stage_capacities`` rungs (pow2 over the unique cold-list
  count, chunks of at most ``max_stage_lists``) and copied to the device
  on a side stream (``non_blocking``) WHILE the hot-tier scan runs on
  the search's stream; the cold scan waits on the copy's event. A
  staging buffer is refilled only after the event of the copy that read
  it has completed. ``raft.tiered.overlap.*`` credits the fetch time as
  hidden when the hot scan's event has not completed when the fetches
  are done (on the CPU nothing runs asynchronously: overlap 0).

Search = coarse top-``n_probes`` (kernel 2, ``ops.select_k``) → sync
the probes to the host → partition them by tier → hot scan → stage and
copy the cold payload → cold scan → tier merge (kernel 2's payload
select on the concatenated ``(nq, 2k)`` candidates, ties to the lower
column: the hot tier's, as ``lax.top_k`` breaks them). Both tiers run
the probe-major fine phase of ``host_memory`` (``ivf_flat._score_probe``
through ``_ivf_scan.probe_scan``) over the same row values, so the
merged top-k equals the fully-resident probe-order search at the same
``(nq, k, n_probes)`` point.

Plans: :func:`build_plan` caches :class:`TieredPlan` handles on
``index.plan_cache`` under the ``raft.plan.*`` counters, as the JAX
package does. The JAX package's ``_prewarm`` compiles a program at
every hot and stage rung over zero tables; eager PyTorch has nothing to
compile, so here it only loads kernel 2's library on the card and
allocates nothing on the device.

Threading: ``refresh`` swaps the hot-table tuple under ``_lock``; a
search takes the tuple under the lock and keeps its tensors alive for
its own calls, and marks them used on its stream (``record_stream``), so
the caching allocator cannot hand a replaced table's memory to another
stream while a launched scan reads it. Device work runs under
``torch.cuda.device(index.device)`` on the calling thread's current
stream; a blocking search waits on that stream only.

Metrics (``raft.tiered.*``): ``probes.{hot,cold}``, ``hit_rate``,
``fetch.{bytes,seconds}``, ``overlap.{seconds,frac}``,
``{promotions,demotions}.total``, ``refresh.total``, ``search.total``,
``budget.bytes``, ``hot.{lists,bytes}``; the ``raft.tiered.search``
span and the resource profiler's samples (program ``"tiered"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.interruptible import wait_ready
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan
from raft_tpu_torch.neighbors._ivf_scan import ProbeStats, note_probes
from raft_tpu_torch.neighbors.host_memory import (HostIvfFlat, _fetch,
                                                  _padded_take, _probe_scan,
                                                  to_host)
from raft_tpu_torch.neighbors.ivf_flat import (
    Index,
    SearchParams,
    _SQRT_METRICS,
    _metric_kind,
    _normalize_rows,
    _postprocess,
)
from raft_tpu_torch.obs import profiler, spans
from raft_tpu_torch.ops import select_k as _select_op

__all__ = ["TieredConfig", "TieredIndex", "TieredPlan", "build_plan",
           "build_ladder", "from_index", "from_host"]


def _pow2_ladder(top: int, lo: int = 8) -> Tuple[int, ...]:
    """Ascending pow2 rungs covering ``(0, top]``: ``lo, 2·lo, …`` plus
    the pow2 ceiling of ``top`` itself."""
    top = max(1, int(top))
    cap = 1 << max(top - 1, 0).bit_length()    # pow2 ceiling
    rungs = []
    c = min(lo, cap)
    while c < cap:
        rungs.append(c)
        c *= 2
    rungs.append(cap)
    return tuple(rungs)


def _merge_topk(d_a, i_a, d_b, i_b, k: int):
    """Fold two per-tier (nq, k) candidate sets into one: kernel 2's
    payload select on the concatenated (nq, 2k) candidates, ties to the
    lower column (``a``'s) — the merge step the probe-major scan runs per
    probe rank, so the merged set equals the single-scan result."""
    cat_d = torch.cat([d_a, d_b], dim=1).contiguous()
    cat_i = torch.cat([i_a, i_b], dim=1).to(torch.int32).contiguous()
    return _select_op.select_k_payload_any(cat_d, cat_i, k)


def _on_device(device) -> contextlib.AbstractContextManager:
    """``device`` as the calling thread's current CUDA device (the
    current device is per thread); a no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# host storage dtype -> the staging tensor's dtype (bfloat16 rows are
# held as their uint16 bit patterns, staged as int16 of the same bits)
_STAGE_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.uint16): torch.int16,
                 np.dtype(np.int32): torch.int32}


@dataclasses.dataclass(frozen=True)
class TieredConfig:
    """Placement policy knobs.

    Exactly one budget source applies, in precedence order:
    ``budget_bytes`` (explicit), ``hot_frac`` (that fraction of the total
    list payload), or the live device headroom —
    ``max(0, bytes_limit * (1 - headroom_frac) - bytes_in_use)`` from
    :func:`raft_tpu_torch.core.memory.hbm_stats` (the caching allocator's
    bytes in use and the card's total memory), i.e. pin as much as fits
    while keeping the profiler's guardrail fraction free. A CPU device
    has no such stats: set ``budget_bytes`` or ``hot_frac`` there."""

    budget_bytes: Optional[int] = None
    hot_frac: Optional[float] = None
    headroom_frac: Optional[float] = None
    ema_decay: float = 0.8
    # staging rung ceiling: one batch's unique cold lists above this are
    # staged in several chunks (bounds the pinned and device bytes)
    max_stage_lists: int = 1024


class TieredIndex:
    """Two-tier IVF-Flat index: device-pinned hot lists + host-RAM cold
    lists behind fixed-shape staging rungs. Build with :func:`from_index`
    / :func:`from_host`, serve with :func:`build_plan` (or hand it to
    ``SearchServer.from_index`` / ``PlanLadder.build``)."""

    # the placement and prefetcher state: every field is swapped or read
    # under ``_lock`` (search takes an immutable snapshot; refresh
    # replaces wholesale)
    GUARDED_BY = ("_hot_slot", "_hot_ids", "_hot_cap", "_hot_tables",
                  "_mass", "_ema", "_stage", "_budget_bytes",
                  "_cum_probes", "_cum_hot", "_cum_fetch_s",
                  "_cum_overlap_s")

    def __init__(self, host: HostIvfFlat,
                 config: Optional[TieredConfig] = None):
        self.cfg = config if config is not None else TieredConfig()
        self.centers = host.centers
        self.lists_data = host.lists_data
        self.lists_norms = host.lists_norms
        self.lists_indices = host.lists_indices
        self.metric = host.metric
        self.size = int(host.size)
        self.scale = float(host.scale)
        self.device = host.centers.device
        self.plan_cache: Dict[tuple, "TieredPlan"] = {}
        self.probe_stats = ProbeStats()
        # per-list payload bytes in the padded layout (the unit of both
        # the budget math and the fetch accounting)
        self.bytes_per_list = int(self.lists_data[0].nbytes
                                  + self.lists_norms[0].nbytes
                                  + self.lists_indices[0].nbytes)
        self.hot_capacities = _pow2_ladder(self.n_lists)
        self.stage_capacities = _pow2_ladder(
            min(self.n_lists, max(1, int(self.cfg.max_stage_lists))))
        # the cold copies run here, beside the search's stream
        self._xfer = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._hot_slot = np.full(self.n_lists, -1, np.int32)
        self._hot_ids = np.zeros(0, np.int64)
        self._hot_cap = 0
        self._hot_tables = None      # (data, norms, ids) device tensors
        self._mass = np.zeros(self.n_lists, np.float64)
        self._ema = np.zeros(self.n_lists, np.float64)
        self._stage: Dict[int, dict] = {}
        self._budget_bytes = 0
        self._cum_probes = 0
        self._cum_hot = 0
        self._cum_fetch_s = 0.0
        self._cum_overlap_s = 0.0
        # the highest capacity rung plans are built for: later budget
        # RAISES clamp here (the JAX package compiles up to it); drops
        # swap down the ladder
        self._warm_top = self._rung_for(self._derive_budget(None))
        self.refresh()

    # -- geometry ----------------------------------------------------------
    @property
    def n_lists(self) -> int:
        return int(self.centers.shape[0])

    @property
    def dim(self) -> int:
        return int(self.centers.shape[1])

    @property
    def max_list(self) -> int:
        return int(self.lists_data.shape[1])

    @property
    def hot_lists(self) -> int:
        with self._lock:
            return int(len(self._hot_ids))

    @property
    def budget_bytes(self) -> int:
        with self._lock:
            return int(self._budget_bytes)

    def table_bytes(self, cap: int) -> int:
        """Device bytes of a hot table at capacity rung ``cap`` (the +1
        is the permanent pad slot)."""
        return (int(cap) + 1) * self.bytes_per_list if cap else 0

    # -- placement policy --------------------------------------------------
    def _derive_budget(self, budget_bytes: Optional[int]) -> int:
        if budget_bytes is not None:
            return max(0, int(budget_bytes))
        if self.cfg.budget_bytes is not None:
            return max(0, int(self.cfg.budget_bytes))
        total = self.n_lists * self.bytes_per_list
        if self.cfg.hot_frac is not None:
            return max(0, int(float(self.cfg.hot_frac) * total))
        from raft_tpu_torch.core.memory import hbm_stats
        stats = hbm_stats(self.device)
        expects(bool(stats),
                "tiered: the %s device reports no memory stats to derive "
                "a hot-tier budget from; set TieredConfig.budget_bytes or "
                "TieredConfig.hot_frac", self.device)
        frac = (self.cfg.headroom_frac
                if self.cfg.headroom_frac is not None
                else profiler.ProfilerConfig().hbm_headroom_frac)
        free = (stats["bytes_limit"] * (1.0 - float(frac))
                - stats["bytes_in_use"])
        return max(0, min(int(free), total))

    def _rung_for(self, budget: int) -> int:
        """Largest capacity rung whose pinned payload fits ``budget`` (0 =
        no hot tier). The permanent pad slot (one list of zeros) rides as
        fixed overhead rather than against the budget, so ``hot_frac=1.0``
        pins the whole index: the policy only ever allocates
        ``rung * bytes_per_list`` budgeted bytes."""
        rung = 0
        for cap in self.hot_capacities:
            if cap * self.bytes_per_list <= budget:
                rung = cap
        return rung

    def refresh(self, budget_bytes: Optional[int] = None) -> dict:
        """Re-score hotness (EMA over the probe mass since the last
        refresh) and promote/demote under the byte budget. Returns a
        summary dict; increments ``raft.tiered.{promotions,demotions}
        .total``. Capacity only moves along the rung ladder, clamped at
        the build-time rung."""
        with self._lock:
            decay = float(self.cfg.ema_decay)
            self._ema = decay * self._ema + (1.0 - decay) * self._mass
            self._mass[:] = 0.0
            budget = self._derive_budget(budget_bytes)
            rung = min(self._rung_for(budget), self._warm_top)
            n_pin = min(rung, self.n_lists)
            # stable mass-descending order → deterministic placement
            order = np.argsort(-self._ema, kind="stable")
            new_ids = np.sort(order[:n_pin].astype(np.int64))
            old = set(int(i) for i in self._hot_ids)
            new = set(int(i) for i in new_ids)
            promoted = len(new - old)
            demoted = len(old - new)
            if rung != self._hot_cap or promoted or demoted:
                with _on_device(self.device):
                    self._install_hot_locked(rung, new_ids)
            self._budget_bytes = budget
        obs.counter("raft.tiered.refresh.total").inc()
        if promoted:
            obs.counter("raft.tiered.promotions.total").inc(promoted)
        if demoted:
            obs.counter("raft.tiered.demotions.total").inc(demoted)
        obs.gauge("raft.tiered.budget.bytes").set(float(budget))
        obs.gauge("raft.tiered.hot.lists").set(float(n_pin))
        obs.gauge("raft.tiered.hot.bytes").set(
            float(self.table_bytes(rung)))
        return {"budget_bytes": budget, "hot_cap": rung,
                "hot_lists": n_pin, "promoted": promoted,
                "demoted": demoted}

    def _install_hot_locked(self, rung: int, new_ids) -> None:
        """Swap the device hot table to ``rung`` holding ``new_ids``
        (sorted). Caller holds the lock. The replaced tables stay alive
        in the searches that took them."""
        if rung == 0:
            self._hot_tables = None
            self._hot_ids = np.zeros(0, np.int64)
            self._hot_slot = np.full(self.n_lists, -1, np.int32)
            self._hot_cap = 0
            return
        n = len(new_ids)
        self._hot_tables = tuple(
            _fetch(_padded_take(src, new_ids, rung + 1, fill), self.device)
            for src, fill in ((self.lists_data, 0), (self.lists_norms, 0),
                              (self.lists_indices, -1)))
        slot = np.full(self.n_lists, -1, np.int32)
        slot[new_ids] = np.arange(n, dtype=np.int32)
        self._hot_slot = slot
        self._hot_ids = np.asarray(new_ids, np.int64)
        self._hot_cap = int(rung)

    # -- staging -----------------------------------------------------------
    def _stage_rung(self, want: int) -> int:
        for cap in self.stage_capacities:
            if want <= cap:
                return cap
        return self.stage_capacities[-1]

    def _stage_alloc(self, rung: int):
        """A new set of staging buffers for ``rung`` (pinned on the
        card's host side): ``(tensors, numpy views)`` of ``rung + 1``
        lists, the last slot the zeros/-1 pad target (the others are
        filled per batch; a slot past a batch's lists is never indexed)."""
        pinned = self.device.type == "cuda"
        tensors, views = [], []
        for src, fill in ((self.lists_data, 0), (self.lists_norms, 0),
                          (self.lists_indices, -1)):
            t = torch.empty((rung + 1,) + src.shape[1:],
                            dtype=_STAGE_DTYPES[src.dtype],
                            pin_memory=pinned)
            a = t.numpy().view(src.dtype)
            a[rung] = fill
            tensors.append(t)
            views.append(a)
        return tuple(tensors), tuple(views)

    def _stage_acquire(self, rung: int):
        """Check the pooled staging buffers for ``rung`` out (or allocate
        a set when another search holds them) → ``(bufs, guard)``: wait
        for ``guard`` (the event of the copy that last read the buffers)
        before refilling them."""
        with self._lock:
            entry = self._stage.pop(rung, None)
        if entry is not None:
            return entry["bufs"], entry["guard"]
        return self._stage_alloc(rung), None

    def _stage_release(self, rung: int, bufs, guard) -> None:
        with self._lock:
            if rung not in self._stage:
                self._stage[rung] = {"bufs": bufs, "guard": guard}

    def _stage_copy(self, tensors, stream):
        """The staged buffers on the device → (device tensors, the copy's
        event or None). On the card: copied on the side stream into
        tensors allocated there, the search's ``stream`` made to wait on
        the copy's event, the tensors marked as used on it. On the CPU the
        staged tensors are scored where they are."""
        if self._xfer is None:
            return tensors, None
        with torch.cuda.stream(self._xfer):
            out = tuple(t.to(self.device, non_blocking=True)
                        for t in tensors)
            ev = torch.cuda.Event()
            ev.record(self._xfer)
        stream.wait_event(ev)
        for t in out:
            t.record_stream(stream)
        return out, ev

    # -- search ------------------------------------------------------------
    def _tier_search(self, q: torch.Tensor, k: int, n_probes: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two-tier search at one (nq, k, n_probes) point on the
        queries' device: the coarse probes are synced to the host once
        (they drive the staging); everything after is issued without a
        host wait on the search's stream."""
        full_fp32_matmul()
        kind = _metric_kind(self.metric)
        sqrt = self.metric in _SQRT_METRICS
        if self.metric == DistanceType.CosineExpanded:
            q = _normalize_rows(q)
        cuda = q.is_cuda
        stream = torch.cuda.current_stream(q.device) if cuda else None
        # the coarse phase on the always-resident centres (kernel 2)
        probes = _ivf_scan.coarse_probes(q, self.centers, n_probes,
                                         kind=kind)
        probes_np = probes.cpu().numpy()      # the one mid-search sync
        note_probes(probes_np, stats=self.probe_stats)
        with self._lock:
            hot_slot = self._hot_slot
            hot_cap = self._hot_cap
            hot_tables = self._hot_tables
            np.add.at(self._mass, probes_np.reshape(-1), 1.0)
        pos_hot = hot_slot[probes_np]                  # (nq, n_probes)
        hot_mask = pos_hot >= 0
        n_hot = int(hot_mask.sum())
        n_total = int(probes_np.size)

        parts = []
        hot_done = None
        t_enq = time.perf_counter()
        if hot_tables is not None and n_hot:
            if cuda:
                for t in hot_tables:
                    t.record_stream(stream)
            ph = np.where(hot_mask, pos_hot, hot_cap).astype(np.int32)
            parts.append(_probe_scan(
                q, *_device_rows(hot_tables), _positions(ph, q.device),
                self.scale, k, sqrt, kind))
            if cuda:
                hot_done = torch.cuda.Event()
                hot_done.record(stream)

        fetch_s = 0.0
        fetch_bytes = 0
        ucold = np.unique(probes_np[~hot_mask]) if n_hot < n_total \
            else np.zeros(0, np.int64)
        # stage cold lists in rung-sized chunks, each copy issued while
        # the hot scan is in flight on the card
        off = 0
        while off < len(ucold):
            chunk = ucold[off:off + self.stage_capacities[-1]]
            off += len(chunk)
            stage_cap = self._stage_rung(len(chunk))
            bufs, guard = self._stage_acquire(stage_cap)
            if guard is not None:
                guard.synchronize()
            t_f0 = time.perf_counter()
            u = len(chunk)
            tensors, views = bufs
            for src, a in zip((self.lists_data, self.lists_norms,
                               self.lists_indices), views):
                np.take(src, chunk, axis=0, out=a[:u])
            dev_tabs, ev = self._stage_copy(tensors, stream)
            fetch_s += time.perf_counter() - t_f0
            fetch_bytes += sum(a.nbytes for a in views)
            idx = np.searchsorted(chunk, probes_np)
            idx = np.minimum(idx, u - 1)
            in_chunk = (~hot_mask) & (chunk[idx] == probes_np)
            pc = np.where(in_chunk, idx, stage_cap).astype(np.int32)
            parts.append(_probe_scan(
                q, *_device_rows(dev_tabs), _positions(pc, q.device),
                self.scale, k, sqrt, kind))
            self._stage_release(stage_cap, bufs, ev)

        # the overlap accounting: the fetch walls above were spent while
        # the hot scan ran on the card — credit them as hidden only while
        # the hot result is demonstrably not ready yet (conservative: a
        # finished hot scan credits zero; on the CPU nothing is in flight)
        overlap_s = 0.0
        if hot_done is not None and fetch_s > 0 and not hot_done.query():
            overlap_s = fetch_s
        if parts:
            d, i = parts[0]
        else:
            d = torch.full((q.shape[0], k), float("inf"), device=q.device)
            i = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                           device=q.device)
        for d_p, i_p in parts[1:]:
            d, i = _merge_topk(d, i, d_p, i_p, k)
        self._note_search(n_total, n_hot, fetch_s, fetch_bytes,
                          overlap_s, time.perf_counter() - t_enq)
        return _postprocess(d, self.metric), i

    def _note_search(self, n_total: int, n_hot: int, fetch_s: float,
                     fetch_bytes: int, overlap_s: float,
                     wall_s: float) -> None:
        obs.counter("raft.tiered.search.total").inc()
        obs.counter("raft.tiered.probes.hot").inc(n_hot)
        obs.counter("raft.tiered.probes.cold").inc(n_total - n_hot)
        if fetch_bytes:
            obs.counter("raft.tiered.fetch.bytes").inc(fetch_bytes)
            obs.counter("raft.tiered.fetch.seconds").inc(fetch_s)
            obs.counter("raft.tiered.overlap.seconds").inc(overlap_s)
        with self._lock:
            self._cum_probes += n_total
            self._cum_hot += n_hot
            self._cum_fetch_s += fetch_s
            self._cum_overlap_s += overlap_s
            hit = (self._cum_hot / self._cum_probes
                   if self._cum_probes else 0.0)
            ofr = (self._cum_overlap_s / self._cum_fetch_s
                   if self._cum_fetch_s > 0 else 0.0)
        obs.gauge("raft.tiered.hit_rate").set(hit)
        obs.gauge("raft.tiered.overlap.frac").set(ofr)


def _positions(a: np.ndarray, device) -> torch.Tensor:
    """A small host array of table positions on ``device``, copied from
    pinned memory without a host wait on the card (a pageable copy would
    wait for the stream, and with it for the hot scan in flight)."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _device_rows(tables):
    """(data, norms, ids) device tables with bfloat16 rows viewed as
    bfloat16 (they travel as int16 bit patterns)."""
    data, norms, ids = tables
    if data.dtype == torch.int16:
        data = data.view(torch.bfloat16)
    return data, norms, ids


class TieredPlan:
    """The plan-contract handle over one ``(nq, k, n_probes)`` point of a
    :class:`TieredIndex` — drop-in for ``plan.SearchPlan`` in the serve
    ladder (``.search(q, block=)``, ``.nq`` / ``.k`` / ``.n_probes`` /
    ``.dim`` / ``.device``)."""

    family = "tiered_ivf_flat"

    def __init__(self, index: TieredIndex, nq: int, k: int,
                 n_probes: int, key: tuple):
        self.index = index
        self.nq = int(nq)
        self.k = int(k)
        self.n_probes = int(n_probes)
        self.dim = index.dim
        self.key = key
        self.device = index.device

    def search(self, queries, block: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one batch of exactly ``plan.nq`` queries → (dists, ids)
        on the index's device. The coarse → partition step syncs once
        mid-call (the probe ids drive the host-side staging); everything
        after is issued without a wait until ``block``, which waits on
        the calling thread's stream only. A sampled blocking call is
        split into its host half and its device half (two CUDA events
        around the search's work on its stream; on the CPU, the wait)."""
        from raft_tpu_torch.neighbors.plan import _stream_events
        prof = block and profiler.sampled()
        t_call = time.perf_counter()
        q = torch.as_tensor(queries, dtype=torch.float32)
        q = q.to(self.device).contiguous()
        expects(tuple(q.shape) == (self.nq, self.dim),
                "tiered plan.search: queries %s != plan shape (%d, %d)",
                tuple(q.shape), self.nq, self.dim)
        obs.counter("raft.plan.search.total").inc()
        obs.counter("raft.plan.search.queries").inc(self.nq)
        t_enq = t_ready = device_s = 0.0
        with spans.span("raft.tiered.search", nq=self.nq, k=self.k,
                        n_probes=self.n_probes,
                        hot_lists=self.index.hot_lists,
                        blocked=block), _on_device(self.device):
            events = _stream_events(q) if prof else None
            if events is not None:
                events[0].record(events[2])
            d, i = self.index._tier_search(q, self.k, self.n_probes)
            if events is not None:
                events[1].record(events[2])
            if block:
                t_enq = time.perf_counter()
                wait_ready((d, i))
                t_ready = time.perf_counter()
                if prof:
                    device_s = (events[0].elapsed_time(events[1]) / 1e3
                                if events is not None else t_ready - t_enq)
                    spans.add_child_span(
                        profiler.SYNC_SPAN, t_enq, t_ready - t_enq,
                        program="tiered",
                        host_ms=round((t_enq - t_call) * 1e3, 3),
                        device_ms=round(device_s * 1e3, 3))
        if prof and block:
            profiler.record_sample(
                program="tiered", family=self.family,
                rung=self.n_probes,
                host_s=(t_enq - t_call)
                + (time.perf_counter() - t_ready),
                device_s=device_s)
        return d, i

    def search_batched(self, queries, block: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Any number of queries through the plan's shape (the ragged
        tail padded with zero rows, its results dropped)."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        q = q.to(self.device).contiguous()
        expects(q.shape[1] == self.dim,
                "tiered plan.search_batched: dim mismatch (%d != %d)",
                q.shape[1], self.dim)
        if q.shape[0] == self.nq:
            return self.search(q, block=block)
        outs = []
        for off in range(0, q.shape[0], self.nq):
            qb = q[off:off + self.nq]
            if qb.shape[0] < self.nq:
                qb = torch.cat([qb, torch.zeros(
                    (self.nq - qb.shape[0], self.dim), device=q.device)])
            outs.append(self.search(qb, block=False))
        d = torch.cat([o[0] for o in outs])[:q.shape[0]]
        i = torch.cat([o[1] for o in outs])[:q.shape[0]]
        if block:
            wait_ready((d, i))
        return d, i


def from_host(host: HostIvfFlat,
              config: Optional[TieredConfig] = None) -> TieredIndex:
    """Wrap a host-resident index (its payload arrays are shared, not
    copied)."""
    return TieredIndex(host, config)


def from_index(index: Index,
               config: Optional[TieredConfig] = None) -> TieredIndex:
    """Tier a fully-resident ``ivf_flat.Index``: the payload moves to host
    RAM (``host_memory.to_host``), then the placement policy pins what the
    budget affords back onto the device."""
    return TieredIndex(to_host(index), config)


def _prewarm(index: TieredIndex, nq: int, k: int, n_probes: int
             ) -> None:
    """What a new plan needs before it serves: on the card, kernel 2's
    library (the coarse select and the tier merge), built or loaded now
    rather than on the first served call. Nothing else: the fine phase is
    eager PyTorch, whose shapes need no preparation, so unlike the JAX
    package (which compiles at every hot and stage rung over zero tables)
    nothing is allocated on the device."""
    if index.device.type == "cuda":
        from raft_tpu_torch.ops import _build
        _build.load("select_k")


def build_plan(index: TieredIndex, queries, k: int,
               params: Optional[SearchParams] = None,
               warm: bool = True) -> TieredPlan:
    """Build (or fetch from ``index.plan_cache``) the tiered plan for this
    batch shape — the same cache counters and LRU bound as
    ``plan.build_plan`` (``raft.plan.cache.*`` / ``raft.plan.build
    .total``), so the steady-state assertions read one taxonomy across
    families."""
    from raft_tpu_torch.neighbors import plan as plan_mod
    if params is None:
        params = SearchParams()
    q = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor)
                   else queries, np.float32)
    expects(q.ndim == 2 and q.shape[1] == index.dim,
            "tiered.build_plan: queries must be (nq, dim=%d), got %s",
            index.dim, q.shape)
    nq = int(q.shape[0])
    n_probes = min(int(params.n_probes), index.n_lists)
    key = ("tiered_ivf_flat", nq, index.dim, k, n_probes,
           _metric_kind(index.metric))
    with spans.span("raft.plan.build", family="tiered_ivf_flat",
                    nq=nq, k=k, n_probes=n_probes) as bsp, \
            obs.timed("raft.plan.build", family="tiered_ivf_flat"):
        cached = index.plan_cache.pop(key, None)
        if cached is not None:
            index.plan_cache[key] = cached      # LRU touch
            obs.counter("raft.plan.cache.hits").inc()
            bsp.set_attr("plan_cache", "hit")
            return cached
        obs.counter("raft.plan.cache.misses").inc()
        obs.counter("raft.plan.build.total").inc()
        bsp.set_attr("plan_cache", "miss")
        t_c0 = time.perf_counter()
        if warm:
            _prewarm(index, nq, k, n_probes)
        profiler.note_compile("tiered", time.perf_counter() - t_c0)
        plan = TieredPlan(index, nq, k, n_probes, key)
        index.plan_cache[key] = plan
        cache_max = plan_mod._plan_cache_max()
        if cache_max > 0:
            while len(index.plan_cache) > cache_max:
                index.plan_cache.pop(next(iter(index.plan_cache)))
                obs.counter("raft.plan.cache.evictions").inc()
        return plan


def build_ladder(index: TieredIndex, rep_queries, k: int,
                 params: Optional[SearchParams] = None,
                 shapes: Tuple[int, ...] = (1, 8, 32, 128),
                 probes_ladder: Tuple[int, ...] = (),
                 prewarm: bool = True):
    """The (shape × rung) tiered plan grid, in ``PlanLadder`` form — what
    ``PlanLadder.build`` (and so ``SearchServer.from_index``) delegates to
    for a :class:`TieredIndex`. A lower rung probes fewer lists, which
    also shrinks the cold fetch working set: load shedding and transfer
    pressure back off together."""
    from raft_tpu_torch.serve.ladder import PlanLadder
    if params is None:
        params = SearchParams()
    q = np.asarray(rep_queries.cpu() if isinstance(rep_queries,
                                                   torch.Tensor)
                   else rep_queries, np.float32)
    expects(q.ndim == 2 and q.shape[1] == index.dim,
            "tiered.build_ladder: rep_queries must be (nq, dim=%d), "
            "got %s", index.dim, q.shape)
    rungs = tuple(probes_ladder) or (min(params.n_probes,
                                         index.n_lists),)
    plans: Dict[Tuple[int, int], TieredPlan] = {}
    for ri, n_probes in enumerate(rungs):
        p_r = dataclasses.replace(params, n_probes=n_probes)
        for s in shapes:
            reps = -(-s // q.shape[0])
            q_s = np.tile(q, (reps, 1))[:s]
            plans[(s, ri)] = build_plan(index, q_s, k, p_r,
                                        warm=prewarm)
    return PlanLadder(shapes=tuple(shapes), rungs=rungs, plans=plans,
                      dim=index.dim, k=k)

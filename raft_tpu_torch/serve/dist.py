"""The mesh-wide distributed serving tier (counterpart of
``raft_tpu.serve.dist``).

One ``DistributedSearchServer.submit()`` front door over a list-sharded
IVF index spanning the mesh. It reuses the micro-batcher whole —
bounded admission, coalescing, deadlines, the ``n_probes`` degradation
ladder, the watchdog and retries — and swaps the plan layer: every
(shape, rung) point of the ladder is one cached ``shard_map`` callable
(``parallel.ivf._shmap_plan``) that fans the batch out over every
shard's lists and merges the shards' top-k with the quantized codec
(``serve.merge``; int8 by default here, ``RAFT_TPU_DIST_MERGE=f32``
for the exact merge).

Steady state: after the ladder's prewarm, serving traffic prepares
nothing anywhere on the mesh — ``raft.parallel.plan.misses``,
``raft.plan.cache.misses`` and ``raft.plan.build.total`` stay flat;
every dispatch is a ``raft.parallel.plan.hits`` hit.

Partial-mesh failover (``ServeConfig(failover=True)``): a failed
dispatch while the health plane names suspect ranks
(``raft.comms.health.suspect_rank``) switches the server to a pre-warmed
per-shard ladder — each healthy shard's single-device plan over its own
lists, merged on the host — serving typed partial results
(``SearchResult.partial``, ``coverage``) until a probe finds the
suspects cleared; recovery rides the still-warm full-mesh ladder.

Observability: ``raft.serve.dist.*`` and ``raft.serve.failover.*``
counters and gauges, rank-tagged ``raft.parallel.ivf.shard`` spans, and
``/healthz``'s ``dist`` section.

A :class:`~raft_tpu_torch.mutate.MutableIndex` is served mesh-wide by
:meth:`DistributedSearchServer.from_mutable`: each epoch's index
list-sharded, the delta merge and the tombstone filter a tail after the
cross-shard merge, compactions warming the next epoch off the serving
path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.interruptible import wait_ready
from raft_tpu_torch.core.logger import get_logger
from raft_tpu_torch.obs import profiler, spans
from raft_tpu_torch.parallel.mesh import CollectiveError, CollectiveTimeout
from raft_tpu_torch.serve.batcher import SearchServer
from raft_tpu_torch.serve.ladder import PlanLadder
from raft_tpu_torch.serve.merge import merge_mode, merge_wire_bytes
from raft_tpu_torch.serve.types import ServeConfig, ShardFailedError
from raft_tpu_torch.testing import faults

__all__ = [
    "DistSearchPlan",
    "DistributedSearchServer",
    "FailoverLadder",
    "build_dist_ladder",
    "build_failover_ladder",
]


def _resolve_family(index) -> str:
    """Which distributed search serves this list-sharded index."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    if isinstance(index, ivf_flat.Index):
        return "ivf_flat"
    if isinstance(index, ivf_pq.Index):
        expects(index.decoded is not None,
                "serve.dist: IVF-PQ index has no reconstruction cache — "
                "shard it via shard_ivf_pq / sharded_ivf_pq_build first")
        return "ivf_pq"
    expects(False, "serve.dist: unsupported index type %s (want a "
            "list-sharded ivf_flat/ivf_pq Index)", type(index).__name__)


class DistSearchPlan:
    """Plan-like object (the :class:`PlanLadder` contract: ``search``,
    ``nq``, ``n_probes``) over one (nq, rung) point of a list-sharded
    index: each ``search`` is one cached ``shard_map`` run over the
    whole mesh, its merge wire format pinned at build."""

    def __init__(self, family: str, index, mesh, axis: str, nq: int,
                 k: int, params, merge: str, comms, level: int = 0,
                 sync_timeout_s: Optional[float] = None):
        self.family = family
        self.nq = int(nq)
        self.dim = int(index.dim)
        self.k = int(k)
        self.n_probes = int(min(
            params.n_probes, index.n_lists // mesh.shape[axis]))
        self.merge = merge
        self.mesh = mesh
        self.axis = axis
        self.level = int(level)
        self.n_shards = int(mesh.shape[axis])
        # the participants this plan needs alive (stall_shard matches
        # them; ShardFailedError names suspects among them)
        self.ranks = tuple(range(self.n_shards))
        # the batcher makes this the dispatching thread's device
        self.device = mesh.devices_flat[0]
        self._index = index
        self._params = params
        self._comms = comms
        # when set, block=True waits through comms.sync_stream: a result
        # that never completes is a typed ABORT, not an endless wait
        self._sync_timeout_s = sync_timeout_s
        self._bytes_pre, self._bytes_post = merge_wire_bytes(
            self.nq, self.k, self.n_shards, merge, int(index.size))
        # profitability gate: at tiny shapes the two-stage codec's
        # per-row metadata outweighs the f32 allgather it replaces;
        # those points serve f32
        if merge == "int8" and 0 < self._bytes_pre <= self._bytes_post:
            self.merge = merge = "f32"
            self._bytes_post = self._bytes_pre

    @property
    def merge_ratio(self) -> float:
        return (self._bytes_post / self._bytes_pre
                if self._bytes_pre else 1.0)

    def search(self, queries, block: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one batch of exactly ``plan.nq`` queries across the
        mesh → (dists, ids), both (nq, k), on the first rank's device.
        A collective that timed out or was abandoned raises
        :class:`ShardFailedError` (retryable)."""
        from raft_tpu_torch.parallel import ivf as pivf
        q = np.asarray(queries, np.float32)
        expects(q.shape == (self.nq, self.dim),
                "dist plan.search: queries %s != plan shape (%d, %d)",
                q.shape, self.nq, self.dim)
        # chaos-harness site: a stall or drop rule matching any of this
        # plan's ranks fires here (a no-op without a rule)
        faults.inject("serve.dist.dispatch", ranks=self.ranks,
                      family=self.family)
        obs.counter("raft.serve.dist.batches", level=self.level).inc()
        obs.counter("raft.serve.dist.queries").inc(self.nq)
        obs.counter("raft.serve.dist.merge.bytes_pre",
                    level=self.level).inc(self._bytes_pre)
        obs.counter("raft.serve.dist.merge.bytes_post",
                    level=self.level).inc(self._bytes_post)
        # queries replicate: every shard scans its lists for all rows
        obs.counter("raft.serve.dist.shard.rows").inc(
            self.nq * self.n_shards)
        prof = block and profiler.sampled()
        t0 = time.perf_counter()
        search = (pivf.distributed_ivf_flat_search
                  if self.family == "ivf_flat"
                  else pivf.distributed_ivf_pq_search)
        with spans.span("raft.serve.dist.dispatch", family=self.family,
                        nq=self.nq, k=self.k, n_probes=self.n_probes,
                        n_shards=self.n_shards, merge=self.merge,
                        level=self.level):
            try:
                d, i = search(self._index, q, self.k, self._params,
                              mesh=self.mesh, axis=self.axis,
                              comms=self._comms, merge=self.merge)
            except CollectiveError as e:
                missing = (e.missing if isinstance(e, CollectiveTimeout)
                           else ())
                raise ShardFailedError(
                    f"cross-shard dispatch failed: {e}",
                    ranks=missing or self.ranks) from e
        t_enq = time.perf_counter()
        if block:
            if self._sync_timeout_s:
                st = self._comms.sync_stream(
                    d, i, timeout_s=self._sync_timeout_s)
                if getattr(st, "name", "SUCCESS") != "SUCCESS":
                    raise ShardFailedError(
                        f"cross-shard dispatch reported "
                        f"{getattr(st, 'name', st)}", ranks=self.ranks)
                if prof:
                    profiler.record_dispatch(
                        t0, t_enq, None, program="dist",
                        family=self.family, rung=self.level)
            elif prof:
                profiler.record_dispatch(
                    t0, t_enq, (d, i), program="dist",
                    family=self.family, rung=self.level)
            else:
                wait_ready((d, i))
        return d, i


def build_dist_ladder(index, rep_queries, k: int, params=None,
                      mesh=None, axis: str = "data",
                      shapes: Tuple[int, ...] = (1, 8, 32, 128),
                      probes_ladder: Tuple[int, ...] = (),
                      prewarm: bool = True,
                      merge: Optional[str] = None,
                      sync_timeout_s: Optional[float] = None
                      ) -> PlanLadder:
    """The (shape x rung) grid of distributed plans over a list-sharded
    index → a :class:`PlanLadder`. With ``prewarm`` every point runs once
    here (its ``shard_map`` cached, its kernels loaded), so serving
    prepares nothing."""
    expects(mesh is not None, "build_dist_ladder: mesh is required")
    from raft_tpu_torch.neighbors import plan as plan_mod
    from raft_tpu_torch.parallel import ivf as pivf
    family = _resolve_family(index)
    if params is None:
        params = plan_mod._default_params(family)
    merge = merge_mode(default="int8") if merge is None else merge
    expects(merge in ("f32", "int8"),
            "build_dist_ladder: merge must be 'f32' or 'int8', got %r",
            merge)
    comms = pivf.get_comms(mesh, axis)
    q = np.asarray(rep_queries, np.float32)
    expects(q.ndim == 2 and q.shape[1] == index.dim,
            "build_dist_ladder: rep_queries must be (nq, dim=%d), got %s",
            index.dim, q.shape)
    nl_local = index.n_lists // mesh.shape[axis]
    rungs = tuple(probes_ladder) or (min(params.n_probes, nl_local),)
    plans = {}
    for ri, n_probes in enumerate(rungs):
        p_r = dataclasses.replace(params, n_probes=n_probes)
        for s in shapes:
            plan = DistSearchPlan(family, index, mesh, axis, s, k, p_r,
                                  merge, comms, level=ri,
                                  sync_timeout_s=sync_timeout_s)
            if prewarm:
                reps = -(-s // q.shape[0])
                wait_ready(plan.search(np.tile(q, (reps, 1))[:s]))
            plans[(s, ri)] = plan
    return PlanLadder(shapes=tuple(shapes), rungs=rungs, plans=plans,
                      dim=index.dim, k=k)


# ---------------------------------------------------------------------------
# partial-mesh failover: degraded serving over the healthy shards


def _shard_local_view(index, rank: int, nl_local: int, family: str,
                      device):
    """Shard ``rank``'s slice of a list-sharded index as a standalone
    single-device index on ``device``: its own coarse centres and lists,
    global ids intact — what a healthy rank still holds when a peer is
    lost."""
    from raft_tpu_torch.parallel.mesh import Sharded
    sl = slice(rank * nl_local, (rank + 1) * nl_local)

    def put(a):
        if isinstance(a, Sharded):
            per = a.blocks[0].shape[0]
            expects(per == nl_local, "failover: shard blocks of %d lists, "
                    "want %d", per, nl_local)
            return a.blocks[rank].to(device)
        return torch.as_tensor(a)[sl].to(device)

    def whole(a):
        return a.gather(device) if isinstance(a, Sharded) else \
            torch.as_tensor(a).to(device)

    if family == "ivf_flat":
        from raft_tpu_torch.neighbors.ivf_flat import Index
        return Index(
            centers=put(index.centers), lists_data=put(index.lists_data),
            lists_indices=put(index.lists_indices),
            lists_norms=put(index.lists_norms),
            list_sizes=put(index.list_sizes), metric=index.metric,
            size=index.size, scale=index.scale)
    from raft_tpu_torch.neighbors.ivf_pq import CodebookGen, Index
    per_cluster = index.codebook_kind == CodebookGen.PER_CLUSTER
    return Index(
        centers=put(index.centers), centers_rot=put(index.centers_rot),
        rotation_matrix=whole(index.rotation_matrix),
        pq_centers=(put(index.pq_centers) if per_cluster
                    else whole(index.pq_centers)),
        codes=put(index.codes), lists_indices=put(index.lists_indices),
        list_sizes=put(index.list_sizes), metric=index.metric,
        pq_bits=index.pq_bits, size=index.size,
        codebook_kind=index.codebook_kind,
        code_norms=(put(index.code_norms)
                    if index.code_norms is not None else None),
        decoded=(put(index.decoded)
                 if index.decoded is not None else None),
        decoded_norms=(put(index.decoded_norms)
                       if index.decoded_norms is not None else None))


class _PartialMeshPlan:
    """Plan-like handle serving one batch over the healthy shards: each
    healthy shard's pre-warmed single-device plan scans its own lists
    (no collective: a lost rank cannot hang what it is not part of) and
    the per-shard top-k merge on the host. ``coverage`` is the share of
    the corpus's rows the surviving shards hold."""

    partial = True

    def __init__(self, ladder: "FailoverLadder", nq: int,
                 excluded: Tuple[int, ...]):
        self._ladder = ladder
        self.nq = int(nq)
        self.excluded = tuple(excluded)
        self.ranks = tuple(r for r in range(ladder.n_shards)
                           if r not in self.excluded)
        self.n_probes = ladder.n_probes
        self.coverage = ladder.coverage(self.excluded)
        self.k = ladder.k

    def search(self, queries, block: bool = False):
        lad = self._ladder
        faults.inject("serve.dist.dispatch", ranks=self.ranks,
                      family="failover")
        expects(self.ranks, "partial-mesh plan: every shard excluded")
        obs.counter("raft.serve.failover.batches.total").inc()
        with spans.span("raft.serve.dist.dispatch", mode="partial",
                        nq=self.nq, k=self.k, healthy=len(self.ranks),
                        excluded=len(self.excluded),
                        coverage=round(self.coverage, 4)):
            # issue every healthy shard's work before reading any back
            outs = [lad.plan(r, self.nq).search(queries, block=False)
                    for r in self.ranks]
            d = np.concatenate([o[0].cpu().numpy() for o in outs], axis=1)
            i = np.concatenate([o[1].cpu().numpy() for o in outs], axis=1)
            sel = np.argsort(-d if lad.descending else d, axis=1,
                             kind="stable")[:, :self.k]
            return (np.take_along_axis(d, sel, axis=1),
                    np.take_along_axis(i, sel, axis=1))


class FailoverLadder:
    """The pre-warmed degraded tier: per (rank, shape) single-device
    plans over each shard's own lists, built at server construction so
    engaging failover prepares nothing. One grid serves any suspect
    subset: exclusion is a host-side choice of which plans run."""

    def __init__(self, shapes: Tuple[int, ...],
                 plans: Dict[Tuple[int, int], object],
                 weights: Dict[int, float], n_shards: int, k: int,
                 n_probes: int, descending: bool):
        self.shapes = tuple(shapes)
        self._plans = dict(plans)
        self._weights = dict(weights)
        self.n_shards = int(n_shards)
        self.k = int(k)
        self.n_probes = int(n_probes)
        self.descending = bool(descending)

    def plan(self, rank: int, shape: int):
        return self._plans[(rank, shape)]

    def coverage(self, excluded: Tuple[int, ...]) -> float:
        return max(0.0, 1.0 - sum(self._weights.get(r, 0.0)
                                  for r in set(excluded)))

    def bind(self, rows: int, excluded: Tuple[int, ...]
             ) -> Tuple[int, _PartialMeshPlan]:
        """Smallest shape fitting ``rows`` → (shape, partial plan over
        the non-excluded shards)."""
        expects(0 < rows <= self.shapes[-1],
                "FailoverLadder: %d rows exceed the largest shape %d",
                rows, self.shapes[-1])
        for s in self.shapes:
            if rows <= s:
                return s, _PartialMeshPlan(self, s, excluded)
        raise AssertionError("unreachable")


def build_failover_ladder(index, rep_queries, k: int, params=None,
                          mesh=None, axis: str = "data",
                          shapes: Tuple[int, ...] = (1, 8, 32, 128),
                          prewarm: bool = True) -> FailoverLadder:
    """Build and warm the partial-mesh grid for a list-sharded index: a
    single-device plan per (shard, shape) over that shard's lists on its
    rank's device, at the full ``n_probes`` clamped to the local list
    count (degraded mode is the quality reduction)."""
    from raft_tpu_torch.neighbors import plan as plan_mod
    expects(mesh is not None, "build_failover_ladder: mesh is required")
    family = _resolve_family(index)
    if params is None:
        params = plan_mod._default_params(family)
    n_shards = int(mesh.shape[axis])
    nl_local = index.n_lists // n_shards
    q = np.asarray(rep_queries, np.float32)
    sizes = np.asarray(index.list_sizes).reshape(-1).astype(np.float64)
    total = max(1.0, float(sizes.sum()))
    weights = {r: float(sizes[r * nl_local:(r + 1) * nl_local].sum())
               / total for r in range(n_shards)}
    from raft_tpu_torch.parallel.mesh import _axis_devices
    devices = _axis_devices(mesh, axis)
    p_local = dataclasses.replace(
        params, n_probes=min(params.n_probes, nl_local))
    plans: Dict[Tuple[int, int], object] = {}
    for r in range(n_shards):
        sub = _shard_local_view(index, r, nl_local, family, devices[r])
        for s in shapes:
            reps = -(-s // q.shape[0])
            plans[(r, s)] = plan_mod.build_plan(
                sub, np.tile(q, (reps, 1))[:s], k, p_local, warm=prewarm)
    from raft_tpu_torch.distance.distance_types import DistanceType
    descending = index.metric in (DistanceType.InnerProduct,
                                  DistanceType.CosineExpanded)
    return FailoverLadder(shapes=tuple(shapes), plans=plans,
                          weights=weights, n_shards=n_shards, k=k,
                          n_probes=p_local.n_probes, descending=descending)


class DistributedSearchServer(SearchServer):
    """The mesh-wide serving front door: ``submit() -> Future`` with the
    single-device server's contract (bounded queue, deadlines, the
    degradation ladder, the watchdog and retries — all inherited), each
    coalesced batch one cached ``shard_map`` over the list-sharded index
    with the quantized cross-shard merge."""

    # the base server's cross-thread fields; the failover fields
    # (_failover, _excluded, _next_probe) are dispatcher-thread only
    GUARDED_BY = ("_q", "_rows_queued", "_closed", "_shed_times")

    def __init__(self, ladder: PlanLadder,
                 config: Optional[ServeConfig] = None,
                 start: bool = True,
                 failover_ladder: Optional[FailoverLadder] = None):
        p0 = ladder.plan_for(ladder.shapes[0], 0)[1]
        expects(isinstance(p0, DistSearchPlan)
                or getattr(p0, "dist_like", False),
                "DistributedSearchServer: ladder must hold DistSearchPlans "
                "(build via build_dist_ladder)")
        # the ratio gauge reports the saturated point (the largest
        # shape): tiny shapes ride the profitability fallback
        p_top = ladder.plan_for(ladder.max_shape, 0)[1]
        obs.gauge("raft.serve.dist.shards").set(p0.n_shards)
        obs.gauge("raft.serve.dist.merge.ratio").set(
            round(p_top.merge_ratio, 4))
        self._failover = failover_ladder
        self._excluded: Tuple[int, ...] = ()
        self._next_probe = 0.0
        obs.gauge("raft.serve.failover.engaged").set(0)
        super().__init__(ladder, config, start=start)

    # -- partial-mesh failover ---------------------------------------------
    @property
    def excluded_ranks(self) -> Tuple[int, ...]:
        """The shard ranks excluded now (dispatcher-thread state)."""
        return self._excluded

    def _suspects(self) -> Tuple[int, ...]:
        from raft_tpu_torch.comms.health import suspects_from_gauges
        return tuple(suspects_from_gauges(
            obs.snapshot().get("gauges", {})))

    def _engage_failover(self, suspects: Tuple[int, ...]) -> None:
        fresh = tuple(sorted(set(suspects)))
        if fresh == self._excluded:
            return
        first = not self._excluded
        self._excluded = fresh
        cov = self._failover.coverage(fresh)
        if first:
            obs.counter("raft.serve.failover.total").inc()
        obs.gauge("raft.serve.failover.engaged").set(1)
        obs.gauge("raft.serve.failover.coverage").set(round(cov, 4))
        self._next_probe = (time.monotonic()
                            + self._cfg.failover_probe_ms / 1e3)
        get_logger("serve").warn(
            "failover engaged: serving partial results over healthy "
            "shards (excluded ranks %s, coverage %.4f)", fresh, cov)

    def _maybe_recover(self) -> None:
        """While excluded, re-read the suspect gauges every
        ``failover_probe_ms``; a clean bill of health clears the
        exclusion and the next batch rides the still-warm full-mesh
        ladder."""
        now = time.monotonic()
        if now < self._next_probe:
            return
        self._next_probe = now + self._cfg.failover_probe_ms / 1e3
        suspects = self._suspects()
        if suspects:
            self._engage_failover(suspects)
            return
        self._excluded = ()
        obs.gauge("raft.serve.failover.engaged").set(0)
        obs.gauge("raft.serve.failover.coverage").set(1.0)
        obs.counter("raft.serve.failover.recovered.total").inc()
        get_logger("serve").warn(
            "failover recovered: suspect ranks cleared, back to the full "
            "mesh")

    def _plan_for_batch(self, rows: int, level: int):
        if self._excluded and self._failover is not None:
            self._maybe_recover()
            if self._excluded:
                return self._failover.bind(rows, self._excluded)
        return super()._plan_for_batch(rows, level)

    def _plan_after_failure(self, shape: int, level: int, err):
        if self._failover is None:
            return None
        suspects = self._suspects()
        if not suspects:
            return None     # nothing to exclude: retry the full mesh
        self._engage_failover(suspects)
        return self._failover.bind(shape, self._excluded)[1]

    def _quality_detail(self) -> str:
        """The excluded ranks, as a quality sample's label while
        failover is engaged (dispatcher-thread state)."""
        return ",".join(str(r) for r in self._excluded)

    @property
    def mesh(self):
        return self.ladder.plan_for(self.ladder.shapes[0], 0)[1].mesh

    @classmethod
    def from_sharded_index(cls, index, rep_queries, k: int, params=None,
                           mesh=None, axis: str = "data",
                           config: Optional[ServeConfig] = None,
                           merge: Optional[str] = None,
                           start: bool = True
                           ) -> "DistributedSearchServer":
        """Build and warm the distributed ladder for a list-sharded
        ``index`` (``shard_ivf_*`` / ``sharded_*_build``) and start
        serving the mesh; with ``config.failover`` the partial-mesh
        ladder is warmed too."""
        config = config if config is not None else ServeConfig()
        sync_timeout_s = (config.dispatch_timeout_ms / 1e3
                          if config.dispatch_timeout_ms > 0 else None)
        ladder = build_dist_ladder(
            index, rep_queries, k, params, mesh=mesh, axis=axis,
            shapes=config.batch_sizes, probes_ladder=config.probes_ladder,
            prewarm=config.prewarm, merge=merge,
            sync_timeout_s=sync_timeout_s)
        fol = None
        if config.failover:
            fol = build_failover_ladder(
                index, rep_queries, k, params, mesh=mesh, axis=axis,
                shapes=config.batch_sizes, prewarm=config.prewarm)
        srv = cls(ladder, config, start=start, failover_ladder=fol)
        srv._quality_meta = {"metric": getattr(index, "metric", None),
                             "family": type(index).__module__
                             .rsplit(".", 1)[-1],
                             "device": mesh.devices_flat[0]}
        return srv

    @classmethod
    def from_mutable(cls, mindex, rep_queries, mesh=None,
                     axis: str = "data",
                     config: Optional[ServeConfig] = None,
                     merge: Optional[str] = None,
                     start: bool = True) -> "DistributedSearchServer":
        """Serve a :class:`~raft_tpu_torch.mutate.MutableIndex` mesh-wide
        (``mutate.build_dist_serve_ladder``): each epoch's index
        list-sharded and served through the cached ``shard_map`` grid,
        the delta merge and the tombstone filter a tail after the
        cross-shard merge. Compactions shard and warm the next epoch off
        the serving path, then swap: the server never stops and prepares
        nothing in steady state. Partial-mesh failover is refused."""
        from raft_tpu_torch.mutate import build_dist_serve_ladder
        config = config if config is not None else ServeConfig()
        expects(not config.failover,
                "from_mutable: partial-mesh failover is not supported "
                "over a MutableIndex yet (the delta/tombstone tail "
                "would need per-shard recomposition) — serve with "
                "failover=False")
        ladder = build_dist_serve_ladder(
            mindex, rep_queries, mesh=mesh, axis=axis,
            shapes=config.batch_sizes,
            probes_ladder=config.probes_ladder, merge=merge)
        srv = cls(ladder, config, start=start)
        srv._quality_meta = {"metric": mindex.metric,
                             "family": mindex.family,
                             "device": mindex.device}
        srv._quality_src = mindex
        return srv

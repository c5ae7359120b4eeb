"""Search plans: prepared, host-sync-free IVF serving callables
(counterpart of ``raft_tpu.neighbors.plan``: IVF-Flat, IVF-PQ's code
and reconstruct scans, and IVF-BQ).

A :class:`SearchPlan` fixes one serving point (index, nq, k, params):
its operands are bound, its route (list- or probe-major) is decided,
and its inverted-table ``cap`` is measured once at build and cached on
the index (``index.cap_cache``), so a serving call never measures again
— ``raft.ivf_scan.resolve_cap.syncs`` stays flat on a warmed plan. The
JAX package compiles the plan ahead of time; eager PyTorch has nothing
to compile, so a plan here is the bound callable itself. An IVF-PQ or
IVF-BQ plan whose exact re-rank runs on the host (the raw corpus is not
on the device) syncs once per call for that re-rank.

Plans are cached on the index (``index.plan_cache``; hits, misses and
evictions under ``raft.plan.cache.*``), LRU-bounded by
``RAFT_TPU_PLAN_CACHE_MAX`` (default 64; <= 0 disables the bound).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan, ivf_bq, ivf_flat, ivf_pq


def _plan_cache_max() -> int:
    """LRU bound on ``index.plan_cache`` (``RAFT_TPU_PLAN_CACHE_MAX``),
    read per call."""
    try:
        return int(os.environ.get("RAFT_TPU_PLAN_CACHE_MAX", "64"))
    except ValueError:
        return 64


@dataclass
class SearchPlan:
    """One prepared serving callable for a fixed (index, nq, k, params)
    point. Built by :func:`build_plan` / :func:`warmup`."""

    family: str
    key: tuple
    nq: int
    dim: int
    k: int
    n_probes: int
    cap: int
    metric: DistanceType
    device: torch.device
    _fn: Callable = field(repr=False)

    def search(self, queries, block: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one batch of exactly ``nq`` queries → (dists, ids),
        both (nq, k), on the plan's device. ``block`` waits for the
        device to finish."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        q = q.to(self.device).contiguous()
        expects(tuple(q.shape) == (self.nq, self.dim),
                "plan.search: queries %s != plan shape (%d, %d) — build a "
                "plan per serving batch shape", tuple(q.shape), self.nq,
                self.dim)
        obs.counter("raft.plan.search.total").inc()
        obs.counter("raft.plan.search.queries").inc(self.nq)
        d, i = self._fn(q)
        if block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return d, i


def _flat_builder(index, k: int, params):
    """``make(nq, cap) -> (fn, key_bits)`` for an IVF-Flat index. ``fn``
    holds the index's arrays, not the index (see ``ivf_pq._Route``)."""
    ivf_flat._check_params(params)
    n_probes = min(params.n_probes, index.n_lists)
    metric = index.metric
    kind = ivf_flat._metric_kind(metric)
    sqrt = metric in ivf_flat._SQRT_METRICS
    cosine = metric == DistanceType.CosineExpanded
    n_lists = index.n_lists
    centers, data = index.centers, index.lists_data
    norms, ids, scale = index.lists_norms, index.lists_indices, index.scale

    def make(nq: int, cap: int):
        use_list = ivf_flat.use_list_order(params, nq, n_probes, n_lists)
        if use_list and k <= ivf_flat._FUSED_MAX_K:
            obs.counter("raft.ivf_scan.fused.total", family="ivf_flat").inc()

        def fn(q: torch.Tensor):
            full_fp32_matmul()
            if cosine:
                q = ivf_flat._normalize_rows(q)
            if use_list:
                d, i = _ivf_scan.fused_list_search(
                    q, centers, data, norms, ids, k=k, n_probes=n_probes,
                    cap=cap, bins=params.scan_bins, sqrt=sqrt, kind=kind,
                    internal_dtype=params.internal_distance_dtype,
                    scale=scale)
            else:
                d, i = ivf_flat._search_impl(q, centers, data, ids, norms,
                                             k, n_probes, sqrt, kind=kind,
                                             scale=scale)
            return ivf_flat._postprocess(d, metric), i

        return fn, ("list" if use_list else "probe", params.scan_bins,
                    str(params.internal_distance_dtype))

    return make, n_probes, kind


def _pq_builder(index, k: int, params):
    """``make(nq, cap) -> (fn, key_bits)`` for an IVF-PQ index: the code
    scan (fused kernel at kk <= 256, else the unfused kernel and the
    candidate merge) or the reconstruct scan (list- or probe-major, the
    decode cache filled here), then the exact re-rank, on the device
    when the raw corpus has a device copy, else on the host. The "lut"
    scan has no plan, as in the JAX package."""
    expects(params.scan_mode != "lut",
            "plan: ivf_pq scan_mode %r has no serving plan (use 'auto', "
            "'codes' or 'reconstruct')", params.scan_mode)
    route = ivf_pq._Route(index, k, params)
    raw_dev = (ivf_bq.resolve_raw_device(index, params.rescore_on_device)
               if route.rescoring else None)
    books, round_q, norms = None, False, None
    if route.scan_mode == "codes":
        norms = ivf_pq._ensure_code_norms(index, params, route.per_cluster,
                                          route.kind)
        books, round_q = ivf_pq._lut_books(index, params.lut_dtype)

    def make(nq: int, cap: int):
        if route.fused:
            obs.counter("raft.ivf_scan.fused.total", family="ivf_pq").inc()

        def fn(q: torch.Tensor):
            d, i = route.device_phase(q, cap, books, round_q, norms)
            return route.epilogue(d, i, q, raw_dev)

        key_bits = (route.scan_mode, route.list_major(nq), route.fused,
                    str(params.lut_dtype),
                    str(params.internal_distance_dtype), route.bins,
                    route.kk, route.rescoring, raw_dev is not None)
        return fn, key_bits

    return make, route.n_probes, route.kind


def _bq_builder(index, k: int, params):
    """``make(nq, cap) -> (fn, key_bits)`` for an IVF-BQ index: the bit
    scan (fused kernel at kk <= 256, else the unfused kernel and the
    candidate merge), then the estimator slice or the exact re-rank, on
    the device when the raw corpus has a device copy, else on the
    host."""
    route = ivf_bq._Route(index, k, params)
    raw_dev = (ivf_bq.resolve_raw_device(index, params.rescore_on_device)
               if route.rescoring else None)

    def make(nq: int, cap: int):
        if route.fused:
            obs.counter("raft.ivf_scan.fused.total", family="ivf_bq").inc()

        def fn(q: torch.Tensor):
            if route.cosine:
                q = ivf_flat._normalize_rows(q)
            d, i = route.device_phase(q, cap)
            return route.epilogue(d, i, q, raw_dev)

        key_bits = ("bits", route.fused, route.bins, route.kk,
                    route.rescoring, raw_dev is not None)
        return fn, key_bits

    return make, route.n_probes, route.kind


_BUILDERS = ((ivf_flat.Index, "ivf_flat", _flat_builder),
             (ivf_pq.Index, "ivf_pq", _pq_builder),
             (ivf_bq.Index, "ivf_bq", _bq_builder))


def _resolve_builder(index):
    """``(family, builder)`` for an index type."""
    for cls, family, builder in _BUILDERS:
        if isinstance(index, cls):
            return family, builder
    expects(False, "plan: unsupported index type %s (want ivf_flat, "
            "ivf_pq or ivf_bq Index)", type(index).__name__)


def _default_params(family: str):
    return {"ivf_flat": ivf_flat.SearchParams,
            "ivf_pq": ivf_pq.SearchParams,
            "ivf_bq": ivf_bq.SearchParams}[family]()


def build_plan(index, queries, k: int, params=None,
               warm: bool = True) -> SearchPlan:
    """Build (or fetch from ``index.plan_cache``) the serving plan for
    this (index, nq, k, params) point. ``queries`` is a representative
    batch: the inverted-table cap is measured from it (the one host sync
    of the plan's life). ``warm`` runs the plan once on it."""
    family, builder = _resolve_builder(index)
    if params is None:
        params = _default_params(family)
    q = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "plan: queries must be (nq, dim=%d), got %s", index.dim,
            tuple(q.shape))
    nq = q.shape[0]
    make, n_probes, kind = builder(index, k, params)
    q_cap = (ivf_flat._normalize_rows(q)
             if index.metric == DistanceType.CosineExpanded else q)
    cap = _ivf_scan.resolve_cap(index.cap_cache, q_cap, index.centers,
                                params, n_probes, index.n_lists, kind=kind)
    fn, key_bits = make(nq, cap)
    key = (family, nq, index.dim, k, n_probes, cap, kind) + key_bits
    plan = index.plan_cache.pop(key, None)
    if plan is not None:
        index.plan_cache[key] = plan      # re-insert at the MRU end
        obs.counter("raft.plan.cache.hits").inc()
    else:
        obs.counter("raft.plan.cache.misses").inc()
        obs.counter("raft.plan.build.total").inc()
        plan = SearchPlan(family=family, key=key, nq=nq, dim=index.dim,
                          k=k, n_probes=n_probes, cap=cap,
                          metric=index.metric, device=index.device,
                          _fn=fn)
        index.plan_cache[key] = plan
        cache_max = _plan_cache_max()
        if cache_max > 0:
            while len(index.plan_cache) > cache_max:
                index.plan_cache.pop(next(iter(index.plan_cache)))
                obs.counter("raft.plan.cache.evictions").inc()
    if warm:
        plan.search(q, block=True)
    return plan


def warmup(index, queries, k: int, params=None) -> SearchPlan:
    """Measure the cap, prepare the plan, run it once: afterwards
    same-shape serving calls (``plan.search`` or the family's ``search``)
    perform no measurement sync."""
    return build_plan(index, queries, k, params, warm=True)

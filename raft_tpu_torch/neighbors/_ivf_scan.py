"""List-major IVF helpers: coarse probes, probe inversion, cap policy,
and the fused list search (counterpart of ``raft_tpu.neighbors._ivf_scan``).

The fused list search runs the coarse GEMM, selects ``n_probes`` lists
per query with the ``select_k`` kernel (``n_probes <= 256``), inverts
the probe map into a (list → probing queries) table of width ``cap``
and hands the fine phase to the ``ivf_flat_scan`` kernel, whose
resident top-k state makes it the whole fine phase in one launch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.ops import ivf_scan as _scan_op
from raft_tpu_torch.ops import select_k as _select_op
from raft_tpu_torch.ops._util import stable_topk_min


def _round_cap(want: int, nq: int) -> int:
    """Inverted-table width bucketing: next power of two, >= 8, <= nq."""
    cap = 8
    while cap < want:
        cap *= 2
    return min(cap, nq)


def probe_cap(probes: torch.Tensor, n_lists: int) -> int:
    """Smallest drop-free table width: the most queries probing any one
    list, bucketed by :func:`_round_cap` (one host sync)."""
    counts = torch.bincount(probes.reshape(-1).long(), minlength=n_lists)
    return _round_cap(int(counts.max()), probes.shape[0])


def _invert_probes(probes: torch.Tensor, n_lists: int, cap: int):
    """(nq, n_probes) → ``qmap`` (n_lists, cap) query ids (-1 pad) and
    ``inv_pos`` (nq, n_probes): each pair's slot within its list's row.

    Slots fill in probe-rank order, so when ``cap`` is too small for a
    hot list the overflow drops the least-promising (high-rank) probes;
    dropped pairs keep ``inv_pos >= cap``. The sort is stable (the JAX
    package's is not): within one (list, rank) class, lower query ids
    take the lower slots. Slot order inside a list changes no result."""
    nq, n_probes = probes.shape
    dev = probes.device
    flat_list = probes.reshape(-1).long()
    qid = torch.arange(nq, device=dev).repeat_interleave(n_probes)
    p_rank = torch.arange(n_probes, device=dev).repeat(nq)
    counts = torch.bincount(flat_list, minlength=n_lists)
    order = torch.argsort(flat_list * n_probes + p_rank, stable=True)
    sl = flat_list[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(nq * n_probes, device=dev) - starts[sl]
    keep = pos < cap
    qmap = torch.full((n_lists * cap,), -1, dtype=torch.int32, device=dev)
    qmap[(sl * cap + pos)[keep]] = qid[order][keep].to(torch.int32)
    inv_pos = torch.empty(nq * n_probes, dtype=torch.int32, device=dev)
    inv_pos[order] = pos.to(torch.int32)
    return qmap.reshape(n_lists, cap), inv_pos.reshape(nq, n_probes)


def coarse_scores(queries: torch.Tensor, centers: torch.Tensor,
                  kind: str = "l2") -> torch.Tensor:
    """(nq, n_lists) smaller-is-better coarse scores: expanded L2
    ``max((|q|^2 + |c|^2) - 2 q.c, 0)``, or ``-q.c`` for the ip core."""
    full_fp32_matmul()
    ip = queries @ centers.T
    if kind == "ip":
        return -ip
    qq = (queries * queries).sum(dim=1)
    cc = (centers * centers).sum(dim=1)
    return torch.clamp((qq[:, None] + cc[None, :]) - 2.0 * ip, min=0.0)


def coarse_probes(queries: torch.Tensor, centers: torch.Tensor,
                  n_probes: int, kind: str = "l2") -> torch.Tensor:
    """Coarse phase of the list-major search: the ``n_probes`` best
    lists per query, best first. ``n_probes <= 256`` selects with the
    ``select_k`` kernel (the JAX package's Pallas select); beyond that
    a stable sort (the JAX package's ``lax.top_k``)."""
    coarse = coarse_scores(queries, centers, kind)
    if n_probes <= _select_op.MAX_K:
        return _select_op.select_k(coarse, n_probes)[1]
    return stable_topk_min(coarse, n_probes)[1].to(torch.int32)


def gather_query_rows(queries: torch.Tensor, qmap: torch.Tensor):
    """(n_lists, cap) query-id table → (n_lists, cap, dim) query rows
    (pad slots read row 0; their scores are never used)."""
    return queries[qmap.clamp(min=0).long()]


def resolve_cap(cache: Optional[dict], queries, centers, params,
                n_probes: int, n_lists: int, kind: str = "l2") -> int:
    """Inverted-table width policy (the JAX package's, unchanged):
    ``params.probe_cap`` > 0 pins a width (no sync); 0 measures the
    drop-free width once per (nq, n_probes) and caches it on the index,
    capped by ``RAFT_TPU_AUTO_CAP_MAX`` (default 256, rounded down to a
    power of two); -1 re-measures every batch. A batch overflowing a
    cached or pinned cap drops its highest-rank probes."""
    pc = getattr(params, "probe_cap", 0)
    if pc > 0:
        return _round_cap(pc, queries.shape[0])
    key = (queries.shape[0], n_probes)
    if pc == 0 and cache is not None and key in cache:
        obs.counter("raft.ivf_scan.resolve_cap.cache_hits").inc()
        return cache[key]
    obs.counter("raft.ivf_scan.resolve_cap.syncs").inc()
    probes = coarse_probes(queries, centers, n_probes, kind=kind)
    cap = probe_cap(probes, n_lists)
    if pc == 0:
        cap_max = int(os.environ.get("RAFT_TPU_AUTO_CAP_MAX", "256"))
        if cap_max > 0:
            floor = 8
            while floor * 2 <= cap_max:
                floor *= 2
            cap = min(cap, floor)
        if cache is not None:
            cache[key] = cap
    return cap


def fused_list_search(queries, centers, data, norms, ids, *, k: int,
                      n_probes: int, cap: int, bins: int, sqrt: bool,
                      kind: str):
    """List-major IVF-Flat search: coarse probes, probe inversion, and
    the fused scan + top-k kernel. Returns (dists, ids), best first;
    ip scores come back negated (callers postprocess)."""
    probes = coarse_probes(queries, centers, n_probes, kind=kind)
    qmap, inv_pos = _invert_probes(probes, centers.shape[0], cap)
    return _scan_op.fused_list_scan(queries, data, norms, ids, probes,
                                    inv_pos, qmap, cap, k, bins=bins,
                                    sqrt=sqrt, metric=kind)

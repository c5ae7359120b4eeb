"""List-major IVF helpers: coarse probes, probe inversion, cap policy,
and the fused list search (counterpart of ``raft_tpu.neighbors._ivf_scan``).

The list-major search runs the coarse GEMM, selects ``n_probes`` lists
per query with the ``select_k`` kernel (``n_probes <= 256``), inverts
the probe map into a (list → probing queries) table of width ``cap``
and hands the fine phase to the ``ivf_flat_scan`` kernels: at k <= 256
the fused scan, whose resident top-k state makes it the whole fine
phase in one launch; above that the unfused list scan and
:func:`merge_candidates`. IVF-PQ's "reconstruct" scan takes the same
inversion with its scoring in torch ops (:func:`inverted_scan`, the JAX
package's XLA tier): one bf16 product per chunk of lists, binned or
exact per-(list, query) candidates, then :func:`merge_candidates`.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.obs import spans
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


def probe_major_search(queries, centers, n_probes: int, k: int, sqrt: bool,
                       kind: str, score_probe):
    """The probe-major route (the JAX package's XLA scans): the top
    ``n_probes`` lists by :func:`coarse_probes` (kernel 2 on the card,
    the same (value, column) order as the JAX package's ``lax.top_k``),
    then :func:`probe_scan` → (dists, ids), best first."""
    probes = coarse_probes(queries, centers, n_probes, kind).long()
    return probe_scan(probes, k, sqrt, score_probe)


def probe_scan(probes: torch.Tensor, k: int, sqrt: bool, score_probe):
    """The probe-major merge step: per probe rank ``p``,
    ``score_probe(probes[:, p]) -> (scores (nq, max_list), ids)`` merged
    into the running top-k (stable: the state wins ties, as
    ``lax.top_k`` breaks them) → (dists, ids), best first. ``probes``
    (nq, n_probes) holds whatever the scorer indexes: list ids of the
    resident lists, or positions in a fetched or tiered sub-table."""
    nq, n_probes = probes.shape
    best_d = torch.full((nq, k), float("inf"), device=probes.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32,
                        device=probes.device)
    for p in range(n_probes):
        d, ids = score_probe(probes[:, p])
        best_d, sel = stable_topk_min(torch.cat([best_d, d], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1, sel)
    if sqrt:
        best_d = torch.sqrt(torch.clamp(best_d, min=0.0))
    return best_d, best_i


class ProbeStats:
    """Bounded host-side per-list probe-mass accumulator: the hotness
    signal the tiered placement policy reads. One ``np.bincount`` per
    batch over the coarse output already on the host. Memory is bounded:
    when more than ``2 * bound`` lists are tracked, the tail below the
    top ``bound`` by mass is dropped (probe mass is heavy-headed; that
    tail is the cold set)."""

    GUARDED_BY = ("_mass", "_batches", "_total")

    def __init__(self, bound: int = 4096):
        self._lock = threading.Lock()
        self._bound = max(1, int(bound))
        self._mass: dict = {}
        self._batches = 0
        self._total = 0

    def note(self, probes_np) -> None:
        """Fold one coarse output (any int array of list ids) in."""
        flat = np.asarray(probes_np).reshape(-1)
        if flat.size == 0:
            return
        counts = np.bincount(flat)
        nz = np.nonzero(counts)[0]
        with self._lock:
            self._batches += 1
            self._total += int(flat.size)
            for lid in nz:
                li = int(lid)
                self._mass[li] = self._mass.get(li, 0) + int(counts[li])
            if len(self._mass) > 2 * self._bound:
                keep = sorted(self._mass.items(),
                              key=lambda kv: (-kv[1], kv[0]))
                self._mass = dict(keep[:self._bound])

    def histogram(self, n: int = 16):
        """Top-``n`` ``(list_id, probe_mass)`` pairs, mass-descending
        (ties by list id)."""
        with self._lock:
            items = sorted(self._mass.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return items[:max(0, int(n))]

    def reset(self) -> None:
        with self._lock:
            self._mass = {}
            self._batches = 0
            self._total = 0


_GLOBAL_PROBE_STATS = ProbeStats()


def note_probes(probes_np, stats: Optional[ProbeStats] = None) -> None:
    """Export per-list probe mass from one coarse output on the host:
    the ``raft.ivf_scan.probes.{batches,mass}`` counters plus the bounded
    top-N tracker behind :func:`probe_histogram` (and ``stats``, when
    given)."""
    flat = np.asarray(probes_np)
    obs.counter("raft.ivf_scan.probes.batches").inc()
    obs.counter("raft.ivf_scan.probes.mass").inc(int(flat.size))
    _GLOBAL_PROBE_STATS.note(flat)
    if stats is not None:
        stats.note(flat)


def probe_histogram(n: int = 16):
    """Top-``n`` hottest lists by cumulative probe mass, process-wide
    (the ``raft.ivf_scan.probes.*`` tracker)."""
    return _GLOBAL_PROBE_STATS.histogram(n)


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
        cap = _round_cap(pc, queries.shape[0])
        spans.current_span().set_attrs(cap=cap, cap_mode="pinned")
        return cap
    key = (queries.shape[0], n_probes)
    if pc == 0 and cache is not None and key in cache:
        obs.counter("raft.ivf_scan.resolve_cap.cache_hits").inc()
        spans.current_span().set_attrs(cap=cache[key],
                                       cap_mode="cache_hit")
        return cache[key]
    obs.counter("raft.ivf_scan.resolve_cap.syncs").inc()
    # the measurement is the request's one host round trip: a child span
    # shows it in the trace (and its absence on a warm path)
    with spans.span("raft.ivf_scan.resolve_cap",
                    nq=int(queries.shape[0]), n_probes=n_probes):
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
    spans.current_span().set_attrs(cap=cap, cap_mode="measured")
    return cap


def largest_divisor_at_most(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want`` (>= 1)."""
    c = 1
    for d in range(1, n + 1):
        if n % d == 0 and d <= want:
            c = d
    return c


def _chunk_size(n_lists: int, cap: int, max_list: int,
                budget_elems: int = 1 << 24) -> int:
    """Largest divisor of n_lists whose (chunk, cap, max_list) score
    block stays under ``budget_elems`` f32 elements."""
    want = max(1, budget_elems // max(1, cap * max_list))
    return largest_divisor_at_most(n_lists, want)


def bf16_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (B, m, d) @ b (B, n, d).T`` of bf16-rounded operands with f32
    sums: the JAX package's one-pass bf16 product at
    ``Precision.DEFAULT`` with an f32 accumulator. On the card one bf16
    ``bmm`` writes its f32 accumulator (``out_dtype``); on the CPU, which
    has no such ``bmm``, the bf16 operands are widened to f32 first. Each
    product of two bf16 values is exact in f32 either way, and the
    scores are not rounded to bf16."""
    a16, b16 = a.bfloat16(), b.bfloat16()
    if a16.is_cuda:
        return torch.bmm(a16, b16.transpose(1, 2), out_dtype=torch.float32)
    full_fp32_matmul()
    return a16.float() @ b16.float().transpose(1, 2)


def binned_partial_topk(d: torch.Tensor, lid: torch.Tensor, bins: int):
    """Binned (min, argmin) along the trailing list axis: column c goes
    to bin ``c % bins`` (strided, as the kernels bin). ``d`` (..., cap,
    ML) scores, ``lid`` (..., ML) global ids (-1 pad) → per-bin ``(min
    (..., cap, bins), its id)``; of two equal minima the smaller id, and
    -1 where a bin holds no row."""
    *lead, cap, max_list = d.shape
    b = -(-max_list // bins)
    pad = bins * b - max_list
    db = torch.nn.functional.pad(d, (0, pad), value=float("inf")).reshape(
        *lead, cap, b, bins)
    cd = db.amin(dim=-2)
    col = torch.nn.functional.pad(lid[..., None, :].expand(d.shape),
                                  (0, pad), value=-1).reshape(
                                      *lead, cap, b, bins)
    big = torch.iinfo(torch.int32).max
    gl = torch.where(db == cd[..., None, :], col,
                     torch.full_like(col, big)).amin(dim=-2)
    return cd, torch.where(gl == big, torch.full_like(gl, -1), gl)


def merge_candidates(cand_d, cand_i, probes, inv_pos, k: int, sqrt: bool,
                     cap: int):
    """Tail of the unfused list-major scans: gather each (query, probe)
    pair's candidate row from the (n_lists, cap, kk) blocks and select
    the per-query top-k, ties to the lower column (probe rank, then
    bin). Pairs the inversion dropped (``inv_pos >= cap``) are masked.
    The selection runs through the ``select_k`` kernel when
    ``k <= 256``, else a stable sort (the JAX package's
    ``select_k_pallas`` contract either way). Returns (dists, ids)."""
    nq, n_probes = probes.shape
    kept = inv_pos < cap
    pl, ip = probes.long(), torch.clamp(inv_pos, max=cap - 1).long()
    pd = cand_d[pl, ip].reshape(nq, -1).float()
    pi = cand_i[pl, ip].reshape(nq, -1)
    inf = float("inf")
    keep_f = kept.repeat_interleave(pd.shape[1] // n_probes, dim=1)
    pi = torch.where(keep_f, pi, torch.full_like(pi, -1))
    pd = torch.where(pi >= 0, pd, torch.full_like(pd, inf))
    if pd.shape[1] < k:   # fewer candidates than k: pad like the state
        short = k - pd.shape[1]
        pd = torch.nn.functional.pad(pd, (0, short), value=inf)
        pi = torch.nn.functional.pad(pi, (0, short), value=-1)
    if k <= _select_op.MAX_K:
        d, sel = _select_op.select_k(pd.contiguous(), k)
    else:
        d, sel = stable_topk_min(pd, k)
    ids = torch.gather(pi, 1, torch.clamp(sel, min=0).long())
    ids = torch.where(sel >= 0, ids, torch.full_like(ids, -1))
    if sqrt:
        d = torch.sqrt(torch.clamp(d, min=0.0))
    return d, ids.to(torch.int32)


def fused_list_search(queries, centers, data, norms, ids, *, k: int,
                      n_probes: int, cap: int, bins: int, sqrt: bool,
                      kind: str, internal_dtype=torch.float32,
                      scale: float = 1.0):
    """List-major IVF-Flat search: coarse probes, probe inversion, then
    the fused scan + top-k kernel (``k <= 256``), or the unfused list
    scan (candidate scores in ``internal_dtype``) and the candidate
    merge, in f32. ``data`` in the index's storage (float32, bfloat16,
    or int8 dequantized by ``scale``). Returns (dists, ids), best first;
    ip scores come back negated (callers postprocess)."""
    probes = coarse_probes(queries, centers, n_probes, kind=kind)
    qmap, inv_pos = _invert_probes(probes, centers.shape[0], cap)
    if k <= _scan_op.MAX_K:
        return _scan_op.fused_list_scan(queries, data, norms, ids, probes,
                                        inv_pos, qmap, cap, k, bins=bins,
                                        sqrt=sqrt, metric=kind, scale=scale)
    bins, _ = _scan_op.resolve_bins(bins, k, ids.shape[1])
    cd, ci = _scan_op.list_scan(queries, data, norms, ids, qmap, bins,
                                metric=kind, out_dtype=internal_dtype,
                                scale=scale)
    return merge_candidates(cd, ci, probes, inv_pos, k, sqrt, cap=cap)


def inverted_scan(queries, data, norms, ids, probes, k: int, cap: int,
                  chunk: int, center_offset: Optional[torch.Tensor] = None,
                  bins: int = 0, sqrt: bool = False):
    """List-major scan of bf16 list rows in torch ops (the JAX package's
    ``inverted_scan`` at bf16 ``data``): per chunk of ``chunk`` lists,
    the probing queries (less ``center_offset`` of the list, the IVF-PQ
    residual form) against the rows, ``|q|^2 + norms - 2 q.row`` with
    the product of :func:`bf16_dot`; then ``bins`` > 0 strided bins per
    (list, query) (:func:`binned_partial_topk`) or the exact top-k, and
    :func:`merge_candidates` → (dists (nq, k), ids), best first."""
    nq = queries.shape[0]
    n_lists, max_list = ids.shape
    qmap, inv_pos = _invert_probes(probes, n_lists, cap)
    kk = min(k, max_list) if bins <= 0 else min(bins, max_list)
    dev = queries.device
    cand_d = torch.empty((n_lists, cap, kk), dtype=torch.float32, device=dev)
    cand_i = torch.empty((n_lists, cap, kk), dtype=torch.int32, device=dev)
    inf = float("inf")
    for l0 in range(0, n_lists, chunk):
        qm = qmap[l0:l0 + chunk]
        lid = ids[l0:l0 + chunk]
        qsub = queries[qm.clamp(0, nq - 1).long()]      # (chunk, cap, dim)
        if center_offset is not None:
            qsub = qsub - center_offset[l0:l0 + chunk, None, :]
        qq = (qsub * qsub).sum(dim=2)
        d = (qq[:, :, None] + norms[l0:l0 + chunk, None, :]) \
            - 2.0 * bf16_dot(qsub, data[l0:l0 + chunk])
        d = torch.where(lid[:, None, :] >= 0, torch.clamp(d, min=0.0),
                        torch.full_like(d, inf))
        if bins > 0 and kk < max_list:
            cd, ci = binned_partial_topk(d, lid, kk)
        else:
            g = d.shape[0]
            cd, sel = stable_topk_min(d.reshape(g * cap, max_list), kk)
            ci = torch.gather(lid[:, None, :].expand(g, cap, max_list)
                              .reshape(g * cap, max_list), 1, sel)
            cd, ci = cd.reshape(g, cap, kk), ci.reshape(g, cap, kk)
        cand_d[l0:l0 + chunk] = cd
        cand_i[l0:l0 + chunk] = ci
    return merge_candidates(cand_d, cand_i, probes, inv_pos, k, sqrt,
                            cap=cap)


def fused_reconstruct_list_search(queries, centers, centers_rot, rot,
                                  decoded, decoded_norms, ids, *, k: int,
                                  n_probes: int, cap: int, bins: int,
                                  sqrt: bool):
    """List-major IVF-PQ search over the bf16 reconstruction cache (L2):
    coarse probes on the unrotated centres, the query rotation, then
    :func:`inverted_scan` with each list's rotated centre as the
    offset."""
    full_fp32_matmul()
    probes = coarse_probes(queries, centers, n_probes)
    q_rot = queries @ rot.T
    chunk = _chunk_size(ids.shape[0], cap, ids.shape[1])
    return inverted_scan(q_rot, decoded, decoded_norms, ids, probes, k, cap,
                         chunk, center_offset=centers_rot, bins=bins,
                         sqrt=sqrt)

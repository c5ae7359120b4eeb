"""IVF-Flat ANN index (counterpart of ``raft_tpu.neighbors.ivf_flat``).

Layout: dense padded buckets — (n_lists, max_list, dim) list rows, with
pad slots carrying id -1 (scored +inf). Build = balanced k-means on a
subsample, nearest-centre assignment of every row, bucketing.

Search takes one of two routes, chosen exactly as the JAX package
chooses (``scan_order``; "auto" picks list-major when ``nq >= 64`` and
``nq * n_probes >= 4 * n_lists``):

* list-major: coarse GEMM + ``select_k`` kernel, probe inversion, and
  the fused ``ivf_flat_scan`` kernel (``neighbors._ivf_scan``);
* probe-major: plain PyTorch — per probe rank, one batched product over
  every query's p-th list and a merge into the running top-k (the JAX
  package leaves this route to XLA too).

Ported: float32 storage; metrics L2 (squared and sqrt), InnerProduct and
Cosine. Not ported yet: bf16/int8 storage and list-major search with
k > 256 (both raise ``NotImplementedError``), the trainer's bf16
tiers (``kmeans_kernel_precision``), ``extend``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan
from raft_tpu_torch.neighbors.ann_types import (MAX_QUERY_BATCH,
                                                batched_search,
                                                list_order_auto,
                                                pin_scan_order)
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.ops.ivf_scan import MAX_K as _FUSED_MAX_K
from raft_tpu_torch.util.host_sample import sample_rows, take_rows

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
            DistanceType.InnerProduct, DistanceType.CosineExpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SIM_METRICS = (DistanceType.InnerProduct, DistanceType.CosineExpanded)

# rows per block when computing list-row norms at build
_NORM_ROWS = 1 << 20


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    # only "float32" is ported
    storage_dtype: str = "float32"


@dataclass
class SearchParams:
    """``scan_order``: "probe" | "list" | "auto". ``scan_bins``: 0 = auto
    (``min(max(4k, 64), max_list)`` strided bins per list), -1 = exact,
    > 0 explicit. ``probe_cap``: 0 = measure once per (nq, n_probes) and
    cache on the index, -1 = re-measure every batch, > 0 = pinned."""

    n_probes: int = 20
    scan_order: str = "auto"
    scan_bins: int = 0
    probe_cap: int = 0


@dataclass
class Index:
    """IVF-Flat index: centres and padded per-list rows, ids, norms."""

    centers: torch.Tensor          # (n_lists, dim) f32
    lists_data: torch.Tensor       # (n_lists, max_list, dim) f32
    lists_indices: torch.Tensor    # (n_lists, max_list) int32, -1 = pad
    lists_norms: torch.Tensor      # (n_lists, max_list) f32
    list_sizes: torch.Tensor       # (n_lists,) int32
    metric: DistanceType
    size: int
    scale: float = 1.0
    # measured inverted-table widths keyed (nq, n_probes); not serialized
    cap_cache: dict = field(default_factory=dict, repr=False, compare=False)
    # serving plans keyed by shape identity (neighbors/plan.py)
    plan_cache: dict = field(default_factory=dict, repr=False,
                             compare=False)

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _metric_kind(metric: DistanceType) -> str:
    """"l2" or "ip": the two scoring cores (cosine rides the ip core
    on row-normalized vectors)."""
    return "ip" if metric in _SIM_METRICS else "l2"


def _postprocess(d: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    """Kernel scores are smaller-is-better (-sim for ip); map back: IP →
    similarities, cosine → 1 - cos."""
    if metric == DistanceType.InnerProduct:
        return -d
    if metric == DistanceType.CosineExpanded:
        return 1.0 + d
    return d


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-30)


def _bucketize(x: torch.Tensor, labels: torch.Tensor, n_lists: int,
               round_to: int = 8, row_ids: Optional[torch.Tensor] = None):
    """Scatter rows into padded per-list buckets of width ``max(count)``
    rounded up to ``round_to`` (one host sync). Rows keep dataset order
    within a list. Returns ``(data, ids, norms, counts)``."""
    n, dim = x.shape
    dev = x.device
    lab = labels.long()
    counts = torch.bincount(lab, minlength=n_lists)
    max_list = int(counts.max())
    max_list = max(round_to, -(-max_list // round_to) * round_to)
    if row_ids is None:
        row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    order = torch.argsort(lab, stable=True)
    sl = lab[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = sl * max_list + (torch.arange(n, device=dev) - starts[sl])
    data = torch.zeros((n_lists * max_list, dim), dtype=x.dtype, device=dev)
    data[slot] = x[order]
    ids = torch.full((n_lists * max_list,), -1, dtype=torch.int32,
                     device=dev)
    ids[slot] = row_ids[order].to(torch.int32)
    norms = torch.zeros(n_lists * max_list, dtype=torch.float32, device=dev)
    for s in range(0, n, _NORM_ROWS):
        xb = x[order[s:s + _NORM_ROWS]].float()
        norms[slot[s:s + _NORM_ROWS]] = (xb * xb).sum(dim=1)
    return (data.reshape(n_lists, max_list, dim),
            ids.reshape(n_lists, max_list),
            norms.reshape(n_lists, max_list), counts.to(torch.int32))


def build(dataset, params: IndexParams = IndexParams(), res=None,
          device=None) -> Index:
    """Train + populate on ``device`` (default ``cuda``; ``"cpu"`` only
    when asked). Cosine datasets are row-normalized at build."""
    res = ensure_resources(res, device)
    full_fp32_matmul()
    x = torch.as_tensor(dataset, dtype=torch.float32).to(res.device)
    n = x.shape[0]
    expects(params.n_lists <= n, "ivf_flat.build: n_lists > n_samples")
    expects(params.metric in _METRICS, "ivf_flat: unsupported metric %s",
            params.metric)
    if params.storage_dtype != "float32":
        raise NotImplementedError(
            f"ivf_flat.build: storage_dtype={params.storage_dtype!r} is "
            "not ported yet (float32 only)")
    obs.counter("raft.ivf_flat.build.total").inc()
    obs.counter("raft.ivf_flat.build.rows").inc(n)
    if params.metric == DistanceType.CosineExpanded:
        x = _normalize_rows(x)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = (take_rows(x, sample_rows(n, n_train, 0, x.device))
                if n_train < n else x)
    centers = kmeans_balanced.build_hierarchical(
        trainset, params.n_lists, params.kmeans_n_iters)
    del trainset
    labels = kmeans_balanced.predict(x, centers)
    data, ids, norms, counts = _bucketize(x, labels, params.n_lists)
    return Index(centers=centers, lists_data=data, lists_indices=ids,
                 lists_norms=norms, list_sizes=counts, metric=params.metric,
                 size=n, scale=1.0)


def index_from_numpy(arrays: dict, metric, size: int, scale: float = 1.0,
                     device="cuda") -> Index:
    """An :class:`Index` from numpy arrays (the fields the JAX package's
    ``ivf_flat.Index`` holds: ``centers``, ``lists_data``,
    ``lists_indices``, ``lists_norms``, ``list_sizes``) on ``device``."""
    dev = ensure_resources(None, device).device
    data = np.asarray(arrays["lists_data"])
    if data.dtype != np.float32:
        raise NotImplementedError(
            f"index_from_numpy: list storage {data.dtype} is not ported "
            "yet (float32 only)")

    def put(name, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(arrays[name], dtype=dtype)).to(dev)

    return Index(centers=put("centers", np.float32),
                 lists_data=put("lists_data", np.float32),
                 lists_indices=put("lists_indices", np.int32),
                 lists_norms=put("lists_norms", np.float32),
                 list_sizes=put("list_sizes", np.int32),
                 metric=DistanceType(int(metric)), size=int(size),
                 scale=float(scale))


def _score_probe(queries, qq, lists_data, lists_norms, lists_indices,
                 list_id, kind: str):
    """One probe rank: every query's scores against its ``list_id``
    list → ((nq, max_list) scores, ids); pads score +inf."""
    lid = list_id.long()
    data = lists_data[lid]                       # (nq, max_list, dim)
    ids = lists_indices[lid]                     # (nq, max_list)
    ip = torch.bmm(data, queries[:, :, None])[..., 0]
    inf = torch.full_like(ip, float("inf"))
    if kind == "ip":
        return torch.where(ids >= 0, -ip, inf), ids
    d = (qq[:, None] + lists_norms[lid]) - 2.0 * ip
    return torch.where(ids >= 0, torch.clamp(d, min=0.0), inf), ids


def _fine_phase(queries, lists_data, lists_norms, lists_indices, probes,
                k: int, sqrt: bool, kind: str):
    """Probe-major fine phase: per probe rank, score and merge into the
    running top-k (stable: the state wins ties, as ``lax.top_k`` does)."""
    nq = queries.shape[0]
    qq = (queries * queries).sum(dim=1)
    best_d = torch.full((nq, k), float("inf"), device=queries.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32,
                        device=queries.device)
    for p in range(probes.shape[1]):
        d, ids = _score_probe(queries, qq, lists_data, lists_norms,
                              lists_indices, probes[:, p], kind)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        best_d, sel = stable_topk_min(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    if sqrt:
        best_d = torch.sqrt(torch.clamp(best_d, min=0.0))
    return best_d, best_i


def _search_impl(queries, centers, lists_data, lists_indices, lists_norms,
                 k: int, n_probes: int, sqrt: bool, kind: str = "l2"):
    """Probe-major search: coarse GEMM + top-``n_probes``, fine phase."""
    coarse = _ivf_scan.coarse_scores(queries, centers, kind)
    probes = stable_topk_min(coarse, n_probes)[1]
    return _fine_phase(queries, lists_data, lists_norms, lists_indices,
                       probes, k, sqrt, kind)


def _as_queries(index: Index, queries) -> torch.Tensor:
    q = torch.as_tensor(queries, dtype=torch.float32)
    return q.to(index.device).contiguous()


def _check_storage(index: Index) -> None:
    if index.lists_data.dtype != torch.float32:
        raise NotImplementedError(
            f"ivf_flat.search: {index.lists_data.dtype} list storage is "
            "not ported yet (float32 only)")


def use_list_order(params: SearchParams, nq: int, n_probes: int,
                   n_lists: int, k: int) -> bool:
    """The route rule: "list" and "probe" as asked; "auto" list-major at
    high reuse (``list_order_auto``) while the fused kernel takes k."""
    if params.scan_order == "list":
        if k > _FUSED_MAX_K:
            raise NotImplementedError(
                f"ivf_flat.search: list-major search with k={k} > "
                f"{_FUSED_MAX_K} needs the unfused scan kernel, not "
                "ported yet")
        return True
    return (params.scan_order == "auto" and k <= _FUSED_MAX_K
            and list_order_auto(nq, n_probes, n_lists))


def search(index: Index, queries, k: int,
           params: SearchParams = SearchParams()
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search → (dists (nq, k) f32, neighbour ids (nq, k) int32) on the
    index's device."""
    full_fp32_matmul()
    _check_storage(index)
    q = _as_queries(index, queries)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "ivf_flat.search: dim mismatch")
    expects(params.scan_order in ("auto", "probe", "list"),
            "ivf_flat.search: unknown scan_order %r", params.scan_order)
    if q.shape[0] > MAX_QUERY_BATCH:
        pinned = pin_scan_order(params, q.shape[0], index.n_lists)
        return batched_search(lambda qb: search(index, qb, k, pinned), q,
                              max_batch=MAX_QUERY_BATCH)
    n_probes = min(params.n_probes, index.n_lists)
    nq = q.shape[0]
    obs.counter("raft.ivf_flat.search.queries").inc(nq)
    sqrt = index.metric in _SQRT_METRICS
    kind = _metric_kind(index.metric)
    if index.metric == DistanceType.CosineExpanded:
        q = _normalize_rows(q)
    if use_list_order(params, nq, n_probes, index.n_lists, k):
        cap = _ivf_scan.resolve_cap(index.cap_cache, q, index.centers,
                                    params, n_probes, index.n_lists,
                                    kind=kind)
        obs.counter("raft.ivf_scan.fused.total", family="ivf_flat").inc()
        obs.counter("raft.ivf_scan.fused.queries").inc(nq)
        d, i = _ivf_scan.fused_list_search(
            q, index.centers, index.lists_data, index.lists_norms,
            index.lists_indices, k=k, n_probes=n_probes, cap=cap,
            bins=params.scan_bins, sqrt=sqrt, kind=kind)
    else:
        d, i = _search_impl(q, index.centers, index.lists_data,
                            index.lists_indices, index.lists_norms, k,
                            n_probes, sqrt, kind=kind)
    return _postprocess(d, index.metric), i

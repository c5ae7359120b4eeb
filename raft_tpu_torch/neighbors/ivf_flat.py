"""IVF-Flat ANN index (counterpart of ``raft_tpu.neighbors.ivf_flat``).

Layout: dense padded buckets — (n_lists, max_list, dim) list rows, with
pad slots carrying id -1 (scored +inf). Build = balanced k-means on a
subsample, nearest-centre assignment of every row, bucketing.

Search takes one of two routes, chosen exactly as the JAX package
chooses (``scan_order``; "auto" picks list-major when ``nq >= 64`` and
``nq * n_probes >= 4 * n_lists``):

* list-major: coarse GEMM + ``select_k`` kernel, probe inversion, and
  the fused ``ivf_flat_scan`` kernel at k <= 256, or the unfused list
  scan kernel and the candidate merge above that
  (``neighbors._ivf_scan``);
* probe-major: the coarse GEMM and the ``select_k`` kernel, then plain
  PyTorch — per probe rank, one batched product over every query's p-th
  list and a merge into the running top-k (the JAX package leaves this
  route to XLA too).

List storage (``IndexParams.storage_dtype``): float32, bfloat16 (rows
rounded to nearest) or int8 (one global ``scale``, codes
``clip(round(x / scale), -127, 127)``); the norms are those of the stored
rows. Metrics L2 (squared and sqrt), InnerProduct and Cosine.
``kmeans_kernel_precision`` reaches the k-means trainer. :func:`extend`
adds rows with the centres fixed, as the JAX package does whatever
``adaptive_centers`` says.
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
from raft_tpu_torch.obs import spans
from raft_tpu_torch.ops.ivf_scan import MAX_K as _FUSED_MAX_K
from raft_tpu_torch.util.host_sample import sample_rows, take_rows

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
            DistanceType.InnerProduct, DistanceType.CosineExpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SIM_METRICS = (DistanceType.InnerProduct, DistanceType.CosineExpanded)

# rows per block when computing list-row norms at build
_NORM_ROWS = 1 << 20
# lists per block when narrowing the list storage
_QUANT_LISTS = 64
# the list storages: torch dtype -> IndexParams.storage_dtype
_STORAGE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                  torch.int8: "int8"}


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    # accepted; extend keeps the centres fixed either way (the JAX
    # package's behaviour)
    adaptive_centers: bool = False
    # the trainer's fused L2-NN tier (kernel 1): None, "bf16x3", "bf16",
    # "highest"
    kmeans_kernel_precision: object = None
    # list storage: "float32" | "bfloat16" | "int8"
    storage_dtype: str = "float32"


@dataclass
class SearchParams:
    """``scan_order``: "probe" | "list" | "auto". ``scan_bins``: 0 = auto
    (``min(max(4k, 64), max_list)`` strided bins per list), -1 = exact,
    > 0 explicit. ``probe_cap``: 0 = measure once per (nq, n_probes) and
    cache on the index, -1 = re-measure every batch, > 0 = pinned.
    ``internal_distance_dtype``: the candidate scores the unfused list
    scan (list-major, k > 256) hands to the merge, ``torch.float32`` or
    ``torch.bfloat16``; the merge and the results stay f32."""

    n_probes: int = 20
    scan_order: str = "auto"
    scan_bins: int = 0
    probe_cap: int = 0
    internal_distance_dtype: torch.dtype = torch.float32


@dataclass
class Index:
    """IVF-Flat index: centres and padded per-list rows, ids, norms.
    ``lists_data`` is float32, bfloat16 or int8; ``scale`` dequantizes
    int8 (a value is its code times ``scale``)."""

    centers: torch.Tensor          # (n_lists, dim) f32
    lists_data: torch.Tensor       # (n_lists, max_list, dim) f32|bf16|int8
    lists_indices: torch.Tensor    # (n_lists, max_list) int32, -1 = pad
    lists_norms: torch.Tensor      # (n_lists, max_list) f32, stored rows
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
               round_to: int = 8, row_ids: Optional[torch.Tensor] = None,
               compute_norms: bool = True):
    """Scatter rows into padded per-list buckets of width ``max(count)``
    rounded up to ``round_to`` (one host sync). Rows keep dataset order
    within a list; pad slots hold zeros. Returns ``(data, ids, norms,
    counts)``; ``compute_norms=False`` (integer payloads such as PQ
    codes) returns ``norms=None``."""
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
    if not compute_norms:
        return (data.reshape(n_lists, max_list, dim),
                ids.reshape(n_lists, max_list), None,
                counts.to(torch.int32))
    norms = torch.zeros(n_lists * max_list, dtype=torch.float32, device=dev)
    for s in range(0, n, _NORM_ROWS):
        xb = x[order[s:s + _NORM_ROWS]].float()
        norms[slot[s:s + _NORM_ROWS]] = (xb * xb).sum(dim=1)
    return (data.reshape(n_lists, max_list, dim),
            ids.reshape(n_lists, max_list),
            norms.reshape(n_lists, max_list), counts.to(torch.int32))


@spans.spanned("raft.ivf_flat.build")
@obs.timed("raft.ivf_flat.build")
def build(dataset, params: IndexParams = IndexParams(), res=None,
          device=None) -> Index:
    """Train + populate on ``device`` (default ``cuda``; ``"cpu"`` only
    when asked), the lists stored as ``params.storage_dtype``. Cosine
    datasets are row-normalized at build."""
    res = ensure_resources(res, device)
    full_fp32_matmul()
    x = torch.as_tensor(dataset, dtype=torch.float32).to(res.device)
    n = x.shape[0]
    expects(params.n_lists <= n, "ivf_flat.build: n_lists > n_samples")
    expects(params.metric in _METRICS, "ivf_flat: unsupported metric %s",
            params.metric)
    expects(params.storage_dtype in _STORAGE_NAMES.values(),
            "ivf_flat: storage_dtype must be float32|bfloat16|int8")
    obs.counter("raft.ivf_flat.build.total").inc()
    obs.counter("raft.ivf_flat.build.rows").inc(n)
    spans.current_span().set_attrs(rows=n, n_lists=params.n_lists)
    if params.metric == DistanceType.CosineExpanded:
        x = _normalize_rows(x)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = (take_rows(x, sample_rows(n, n_train, 0, x.device))
                if n_train < n else x)
    centers = kmeans_balanced.build_hierarchical(
        trainset, params.n_lists, params.kmeans_n_iters,
        kernel_precision=params.kmeans_kernel_precision)
    del trainset
    labels = kmeans_balanced.predict(x, centers)
    data, ids, norms, counts = _bucketize(x, labels, params.n_lists)
    del x, labels
    data, norms, scale = _quantize_lists(data, norms, params.storage_dtype)
    return Index(centers=centers, lists_data=data, lists_indices=ids,
                 lists_norms=norms, list_sizes=counts, metric=params.metric,
                 size=n, scale=scale)


def _quantize_lists(data: torch.Tensor, norms: torch.Tensor,
                    storage_dtype: str):
    """Narrow the bucketed f32 rows ``data`` (n_lists, max_list, dim) to
    ``storage_dtype``, as the JAX package's ``_quantize_lists`` does:
    ``"bfloat16"`` rounds to nearest; ``"int8"`` takes one global ``scale
    = max(max|x|, 1e-30) / 127`` (one host sync) and stores
    ``clip(round(x / scale), -127, 127)``, half to even. Narrow norms are
    those of the stored rows (rounded, or dequantized ``code * scale``),
    in f32; ``"float32"`` keeps ``norms``. Returns ``(data, norms,
    scale)``; works through blocks of lists, so its f32 temporaries stay
    small."""
    expects(storage_dtype in _STORAGE_NAMES.values(),
            "ivf_flat: storage_dtype must be float32|bfloat16|int8")
    if storage_dtype == "float32":
        return data, norms, 1.0
    dev = data.device
    int8 = storage_dtype == "int8"
    scale = 1.0
    if int8:  # max |x| without an |x| temporary
        max_abs = float(torch.maximum(data.max(), -data.min()))
        scale = max(max_abs, 1e-30) / 127.0
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    out = torch.empty(data.shape, device=dev,
                      dtype=torch.int8 if int8 else torch.bfloat16)
    out_norms = torch.empty(data.shape[:2], dtype=torch.float32, device=dev)
    for l0 in range(0, data.shape[0], _QUANT_LISTS):
        blk = data[l0:l0 + _QUANT_LISTS]
        if int8:
            q = torch.clamp(torch.round(blk / s), -127, 127).to(torch.int8)
            deq = q.float() * s
        else:
            q = blk.bfloat16()
            deq = q.float()
        out[l0:l0 + _QUANT_LISTS] = q
        out_norms[l0:l0 + _QUANT_LISTS] = (deq * deq).sum(dim=2)
    return out, out_norms, scale


def _dequantize(rows: torch.Tensor, scale: float) -> torch.Tensor:
    """Stored list rows as f32: int8 codes times ``scale``, bf16 widened."""
    if rows.dtype == torch.int8:
        return rows.float() * torch.tensor(scale, dtype=torch.float32,
                                           device=rows.device)
    return rows.float()


def extend(index: Index, new_vectors, new_indices=None, res=None) -> Index:
    """A new index holding ``index``'s rows and ``new_vectors`` (ids
    ``new_indices``, default ``size .. size + n_new``), on the index's
    device: the JAX package's ``extend``. Cosine rows are normalized; the
    stored rows are dequantized, every row is assigned again to the fixed
    centres (``kmeans_balanced.predict``), bucketed and stored again in
    the index's storage (int8: the scale recomputed over all rows, so old
    rows' codes can change)."""
    res = ensure_resources(res, index.device)
    full_fp32_matmul()
    dev = index.device
    x_new = torch.as_tensor(new_vectors, dtype=torch.float32).to(dev)
    expects(x_new.dim() == 2 and x_new.shape[1] == index.dim,
            "ivf_flat.extend: dim mismatch")
    if index.metric == DistanceType.CosineExpanded:
        x_new = _normalize_rows(x_new)
    storage = _STORAGE_NAMES[index.lists_data.dtype]
    valid = (index.lists_indices >= 0).reshape(-1)
    old = _dequantize(index.lists_data.reshape(-1, index.dim)[valid],
                      index.scale)
    old_ids = index.lists_indices.reshape(-1)[valid]
    n_new = x_new.shape[0]
    if new_indices is None:
        new_ids = torch.arange(index.size, index.size + n_new,
                               dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_indices).to(dev, torch.int32)
    expects(new_ids.shape == (n_new,),
            "ivf_flat.extend: %d new ids for %d rows", new_ids.numel(), n_new)
    all_data = torch.cat([old, x_new])
    del old, x_new
    all_ids = torch.cat([old_ids, new_ids])
    labels = kmeans_balanced.predict(all_data, index.centers)
    data, ids, norms, counts = _bucketize(all_data, labels, index.n_lists,
                                          row_ids=all_ids)
    del all_data, labels
    data, norms, scale = _quantize_lists(data, norms, storage)
    return Index(centers=index.centers, lists_data=data, lists_indices=ids,
                 lists_norms=norms, list_sizes=counts, metric=index.metric,
                 size=index.size + n_new, scale=scale)


def _host_array(a, dtype=None) -> np.ndarray:
    """``a`` as a contiguous numpy array of ``dtype``, copied if it is
    read-only (a torch tensor must not share read-only memory)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return a if a.flags.writeable else a.copy()


def _list_rows(a) -> torch.Tensor:
    """List rows from a host array: float32 and int8 as they are;
    bfloat16 given as a torch tensor, or as a numpy array of the JAX
    package's bfloat16 type (recognised by its dtype name) whose bits are
    viewed as they are."""
    if isinstance(a, torch.Tensor):
        return a
    a = _host_array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def index_from_numpy(arrays: dict, metric, size: int, scale: float = 1.0,
                     device="cuda", mesh=None, axis: str = "data") -> Index:
    """An :class:`Index` from host arrays (the fields the JAX package's
    ``ivf_flat.Index`` holds: ``centers``, ``lists_data``,
    ``lists_indices``, ``lists_norms``, ``list_sizes``) on ``device``.
    ``lists_data`` is float32, int8 (dequantized by ``scale``) or
    bfloat16 (see :func:`_list_rows`). With ``mesh``: a
    ``parallel.DistributedIvfFlat`` from the JAX package's multi-part
    fields (``centers``, ``parts_*``) over ``mesh[axis]``."""
    if mesh is not None:
        from raft_tpu_torch.parallel.ivf import _parts_from_numpy
        return _parts_from_numpy("ivf_flat", arrays, mesh, axis,
                                metric=metric, size=int(size))
    dev = ensure_resources(None, device).device
    data = _list_rows(arrays["lists_data"])
    expects(data.dtype in _STORAGE_NAMES,
            "index_from_numpy: list storage %s is not float32, bfloat16 "
            "or int8", data.dtype)

    def put(name, dtype):
        return torch.from_numpy(_host_array(arrays[name], dtype)).to(dev)

    return Index(centers=put("centers", np.float32),
                 lists_data=data.contiguous().to(dev),
                 lists_indices=put("lists_indices", np.int32),
                 lists_norms=put("lists_norms", np.float32),
                 list_sizes=put("list_sizes", np.int32),
                 metric=DistanceType(int(metric)), size=int(size),
                 scale=float(scale))


def _score_probe(queries, qq, lists_data, lists_norms, lists_indices,
                 list_id, kind: str, scale: float = 1.0):
    """One probe rank: every query's scores against its ``list_id``
    list → ((nq, max_list) scores, ids); pads score +inf. Narrow rows as
    the JAX package's probe-major route scores them: bf16 rows against
    the queries rounded to bf16 (exact products, f32 sums: the operands
    go to f32 first, as a bf16 ``bmm`` would round its sums); int8 rows
    against the f32 queries at f32, times ``scale`` (these queries are
    not rounded, unlike the list-major kernels')."""
    lid = list_id.long()
    data = lists_data[lid]                       # (nq, max_list, dim)
    ids = lists_indices[lid]                     # (nq, max_list)
    if data.dtype == torch.bfloat16:
        ip = torch.bmm(data.float(),
                       queries.bfloat16().float()[:, :, None])[..., 0]
    elif data.dtype == torch.int8:
        ip = scale * torch.bmm(data.float(), queries[:, :, None])[..., 0]
    else:
        ip = torch.bmm(data, queries[:, :, None])[..., 0]
    inf = torch.full_like(ip, float("inf"))
    if kind == "ip":
        return torch.where(ids >= 0, -ip, inf), ids
    d = (qq[:, None] + lists_norms[lid]) - 2.0 * ip
    return torch.where(ids >= 0, torch.clamp(d, min=0.0), inf), ids


def _search_impl(queries, centers, lists_data, lists_indices, lists_norms,
                 k: int, n_probes: int, sqrt: bool, kind: str = "l2",
                 scale: float = 1.0):
    """Probe-major search: coarse GEMM + top-``n_probes``, then per probe
    rank :func:`_score_probe` merged into the running top-k."""
    qq = (queries * queries).sum(dim=1)
    return _ivf_scan.probe_major_search(
        queries, centers, n_probes, k, sqrt, kind,
        lambda lid: _score_probe(queries, qq, lists_data, lists_norms,
                                 lists_indices, lid, kind, scale))


def _as_queries(index: Index, queries) -> torch.Tensor:
    q = torch.as_tensor(queries, dtype=torch.float32)
    return q.to(index.device).contiguous()


def _check_params(params: SearchParams) -> None:
    expects(params.scan_order in ("auto", "probe", "list"),
            "ivf_flat.search: unknown scan_order %r", params.scan_order)
    expects(params.internal_distance_dtype in (torch.float32,
                                               torch.bfloat16),
            "ivf_flat: internal_distance_dtype must be float32|bfloat16")


def use_list_order(params: SearchParams, nq: int, n_probes: int,
                   n_lists: int) -> bool:
    """The route rule: "list" and "probe" as asked; "auto" list-major at
    high reuse (``list_order_auto``), for every k."""
    if params.scan_order == "list":
        return True
    return (params.scan_order == "auto"
            and list_order_auto(nq, n_probes, n_lists))


@spans.spanned("raft.ivf_flat.search")
def search(index: Index, queries, k: int,
           params: SearchParams = SearchParams(), res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search → (dists (nq, k) f32, neighbour ids (nq, k) int32) on the
    index's device (``res``, if given, must name it)."""
    sp = spans.current_span()
    sp.set_attr("k", k)
    ensure_resources(res, index.device)
    full_fp32_matmul()
    q = _as_queries(index, queries)
    sp.set_attr("nq", int(q.shape[0]))
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "ivf_flat.search: dim mismatch")
    _check_params(params)
    if q.shape[0] > MAX_QUERY_BATCH:
        pinned = pin_scan_order(params, q.shape[0], index.n_lists)
        return batched_search(lambda qb: search(index, qb, k, pinned), q,
                              max_batch=MAX_QUERY_BATCH)
    n_probes = min(params.n_probes, index.n_lists)
    sp.set_attr("n_probes", n_probes)
    nq = q.shape[0]
    # per-batch telemetry (a batched search comes here per sub-batch)
    obs.counter("raft.ivf_flat.search.queries").inc(nq)
    obs.histogram("raft.ivf_flat.search.batch_size",
                  buckets=obs.SIZE_BUCKETS).observe(nq)
    obs.histogram("raft.ivf_flat.search.n_probes",
                  buckets=obs.SIZE_BUCKETS).observe(n_probes)
    sqrt = index.metric in _SQRT_METRICS
    kind = _metric_kind(index.metric)
    if index.metric == DistanceType.CosineExpanded:
        q = _normalize_rows(q)
    use_list = use_list_order(params, nq, n_probes, index.n_lists)
    order = "list" if use_list else "probe"
    sp.set_attr("order", order)
    with obs.timed("raft.ivf_flat.search", order=order):
        if use_list:
            cap = _ivf_scan.resolve_cap(index.cap_cache, q, index.centers,
                                        params, n_probes, index.n_lists,
                                        kind=kind)
            if k <= _FUSED_MAX_K:
                obs.counter("raft.ivf_scan.fused.total",
                            family="ivf_flat").inc()
                obs.counter("raft.ivf_scan.fused.queries").inc(nq)
            d, i = _ivf_scan.fused_list_search(
                q, index.centers, index.lists_data, index.lists_norms,
                index.lists_indices, k=k, n_probes=n_probes, cap=cap,
                bins=params.scan_bins, sqrt=sqrt, kind=kind,
                internal_dtype=params.internal_distance_dtype,
                scale=index.scale)
        else:
            d, i = _search_impl(q, index.centers, index.lists_data,
                                index.lists_indices, index.lists_norms, k,
                                n_probes, sqrt, kind=kind,
                                scale=index.scale)
    return _postprocess(d, index.metric), i

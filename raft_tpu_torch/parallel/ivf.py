"""List-sharded IVF: sharding, search and builds over a mesh
(counterpart of the list-sharded half of ``raft_tpu.parallel.ivf``).

The index's list dimension is sharded over the mesh's data axis; queries
are replicated. A sharded index is the port's own ``Index`` whose list
arrays are :class:`~raft_tpu_torch.parallel.mesh.Sharded` (one block of
``n_lists / n_shards`` lists a rank, each block a view of the rank's own
lists; :func:`gather_index` puts it back on one device). Each shard runs
the probe-major search on its own lists — the coarse select on kernel 2,
then per probe rank one batched product and a stable merge, exact per
probed set as the JAX package's ``_fine_scan`` — probing
``min(n_probes, n_lists // n_shards)`` of them, and the shards merge
their top-k: the exact f32 allgather (kernel 2's payload select, ties to
the lower column as ``lax.top_k``) or the int8 two-stage merge
(``serve.merge``). List ids are global row ids, so the merge translates
nothing.

The sharded builds (:func:`sharded_ivf_flat_build`, ``_pq_``, ``_bq_``)
train the coarse centres with the data-parallel balanced trainer
(kernel 1 per rank), label each rank's own rows (kernel 1 for L2),
bucket them at one agreed width, and move every list to the rank that
serves it with one ``alltoall``, then a stable compaction.

Plans: the JAX package caches one compiled ``shard_map`` program per
key (``_shmap_plan``); the port caches the ``shard_map`` callable under
the same keys and counters (``raft.parallel.plan.{hits,misses}``), so a
warm serving call prepares nothing.

The row-parts half (:class:`DistributedIvfFlat`, ``Pq``, ``Bq``; the
``distributed_ivf_*_build`` and ``distributed_ivf_*_search_parts``):
rows stay on the rank that holds them. The MNMG k-means trains the
coarse centres (kernel 1 per rank), each rank labels and buckets its own
rows at one agreed width into partial lists of every list with global
ids, and a search probes the same global centres on every rank, scans
the rank's partial lists probe-major and merges the ranks' top-k
exactly. The scanned set is the single-device index's at the same
``n_probes``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.obs import spans
from raft_tpu_torch.parallel.mesh import (P, Sharded, _split, shard_map,
                                          shard_rows)
from raft_tpu_torch.util.host_sample import sample_rows, take_rows

__all__ = ["DistributedIvfBq", "DistributedIvfFlat", "DistributedIvfPq",
           "distributed_ivf_bq_build", "distributed_ivf_bq_search_parts",
           "distributed_ivf_flat_build", "distributed_ivf_flat_search",
           "distributed_ivf_flat_search_parts", "distributed_ivf_pq_build",
           "distributed_ivf_pq_search", "distributed_ivf_pq_search_parts",
           "gather_index", "get_comms", "shard_ivf_flat", "shard_ivf_pq",
           "sharded_ivf_bq_build",
           "sharded_ivf_flat_build", "sharded_ivf_pq_build"]

# ---------------------------------------------------------------------------
# the plan cache (the JAX package's _shmap_plan) and the comms cache

_SHMAP_PLANS: dict = {}
_PLANS_LOCK = threading.Lock()


def _shmap_plan(key, builder):
    """The cached ``shard_map`` callable for ``key``, built by
    ``builder()`` on a miss."""
    with _PLANS_LOCK:
        fn = _SHMAP_PLANS.get(key)
        if fn is None:
            obs.counter("raft.parallel.plan.misses").inc()
            spans.current_span().set_attr("shmap_plan", "miss")
            fn = _SHMAP_PLANS[key] = builder()
        else:
            obs.counter("raft.parallel.plan.hits").inc()
            spans.current_span().set_attr("shmap_plan", "hit")
    return fn


_COMMS_CACHE: dict = {}


def get_comms(mesh, axis: str = "data"):
    """Cached :class:`~raft_tpu_torch.comms.comms.Comms` over
    ``mesh[axis]`` (built once per mesh axis)."""
    from raft_tpu_torch.comms.comms import build_comms
    key = (mesh, axis)
    c = _COMMS_CACHE.get(key)
    if c is None:
        c = _COMMS_CACHE[key] = build_comms(mesh, axis)
    return c


def _rank_spans(n_shards: int, t0: float, dt: float) -> None:
    """One rank-tagged child span per shard under the current trace (the
    ranks ran inside one host call)."""
    for r in range(n_shards):
        spans.add_child_span("raft.parallel.ivf.shard", t0, dt, rank=r)


def _shard0(arr, mesh, axis):
    """An array's leading (list) dimension in blocks over
    ``mesh[axis]`` (views where a rank shares the array's device)."""
    if isinstance(arr, Sharded):
        return arr
    return _split(torch.as_tensor(arr), mesh, axis)


def gather_index(index, device=None):
    """A sharded index's arrays put back together on ``device`` (default:
    the first block's): an ordinary single-device index."""
    kw = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, Sharded):
            v = v.gather(device)
        elif isinstance(v, torch.Tensor) and device is not None:
            v = v.to(device)
        kw[f.name] = v
    for name in ("cap_cache", "plan_cache"):
        if name in kw:
            kw[name] = {}
    return type(index)(**kw)


def shard_ivf_flat(index, mesh, axis: str = "data"):
    """An IVF-Flat index's lists in blocks over ``mesh[axis]`` (a new
    ``Index``); ``n_lists`` must divide evenly."""
    from raft_tpu_torch.neighbors.ivf_flat import Index
    n_shards = mesh.shape[axis]
    expects(index.n_lists % n_shards == 0,
            f"shard_ivf_flat: n_lists={index.n_lists} not divisible by "
            f"{n_shards} shards")
    return Index(
        centers=_shard0(index.centers, mesh, axis),
        lists_data=_shard0(index.lists_data, mesh, axis),
        lists_indices=_shard0(index.lists_indices, mesh, axis),
        lists_norms=_shard0(index.lists_norms, mesh, axis),
        list_sizes=_shard0(index.list_sizes, mesh, axis),
        metric=index.metric, size=index.size, scale=index.scale)


def shard_ivf_pq(index, mesh, axis: str = "data"):
    """An IVF-PQ index's lists in blocks over ``mesh[axis]``, with the
    bf16 reconstruction cache decoded shard by shard (the sharded scans
    read it; it never exists whole on one device)."""
    from raft_tpu_torch.neighbors.ivf_pq import (CodebookGen, Index,
                                                 _decode_lists, _norms_fn)
    n_shards = mesh.shape[axis]
    expects(index.n_lists % n_shards == 0,
            f"shard_ivf_pq: n_lists={index.n_lists} not divisible by "
            f"{n_shards} shards")
    per_cluster = index.codebook_kind == CodebookGen.PER_CLUSTER
    codes = _shard0(index.codes, mesh, axis)
    lists_indices = _shard0(index.lists_indices, mesh, axis)
    book_spec = P(axis) if per_cluster else P()
    pq_centers = (_shard0(index.pq_centers, mesh, axis) if per_cluster
                  else index.pq_centers)
    decoded = shard_map(
        lambda c, b, i: _decode_lists(c, b, i, per_cluster), mesh,
        (P(axis), book_spec, P(axis)), P(axis))(codes, pq_centers,
                                                lists_indices)
    if index.code_norms is not None:
        norms = _shard0(index.code_norms, mesh, axis)
    else:
        norms = shard_map(_norms_fn(per_cluster), mesh,
                          (P(axis), book_spec, P(axis)), P(axis))(
            codes, pq_centers, lists_indices)
    return Index(
        centers=_shard0(index.centers, mesh, axis),
        centers_rot=_shard0(index.centers_rot, mesh, axis),
        rotation_matrix=index.rotation_matrix, pq_centers=pq_centers,
        codes=codes, lists_indices=lists_indices,
        list_sizes=_shard0(index.list_sizes, mesh, axis),
        metric=index.metric, pq_bits=index.pq_bits, size=index.size,
        codebook_kind=index.codebook_kind, code_norms=norms,
        decoded=decoded, decoded_norms=norms)


# ---------------------------------------------------------------------------
# the cross-shard merge


def _global_merge(comms, axis, d, i, k):
    """The exact f32 merge: every shard's (nq, k) candidates allgathered,
    the k best of each row kept by kernel 2's payload select, a stable
    sort above k = 256 (ties to the lower column either way: shard-major,
    then rank within the shard)."""
    from raft_tpu_torch.ops.select_k import select_k_payload_any
    gd = comms.allgather(d)                   # (n_shards, nq, k)
    gi = comms.allgather(i.to(torch.int32))
    nq = d.shape[0]
    cat_d = gd.permute(1, 0, 2).reshape(nq, -1).contiguous()
    cat_i = gi.permute(1, 0, 2).reshape(nq, -1).contiguous()
    return select_k_payload_any(cat_d, cat_i, k)


def _merge_topk(comms, axis, d, i, k, merge: str, size: int):
    """The cross-shard top-k merge at the chosen wire format."""
    if merge == "int8":
        from raft_tpu_torch.serve.merge import compressed_merge
        return compressed_merge(comms, d, i, k, size)
    return _global_merge(comms, axis, d, i, k)


def _resolve_merge(merge):
    """The library functions' merge: exact f32 unless
    ``RAFT_TPU_DIST_MERGE`` (or the caller) asks for int8."""
    if merge is None:
        from raft_tpu_torch.serve.merge import merge_mode
        merge = merge_mode(default="f32")
    expects(merge in ("f32", "int8"),
            "distributed search: merge must be 'f32' or 'int8', got %r",
            merge)
    return merge


# ---------------------------------------------------------------------------
# list-sharded searches


def _flat_list_plan(mesh, axis: str, k: int, n_probes: int, kind: str,
                    sqrt: bool, scale: float, merge: str, size: int,
                    comms):
    """The cached ``shard_map`` of the list-sharded IVF-Flat search
    (shared with the serving tier's ladder, ``serve.dist``)."""
    from raft_tpu_torch.neighbors import ivf_flat

    def build():
        def local(centers, lists_data, lists_indices, lists_norms, q):
            full_fp32_matmul()
            d, i = ivf_flat._search_impl(q, centers, lists_data,
                                         lists_indices, lists_norms, k,
                                         n_probes, sqrt, kind=kind,
                                         scale=scale)
            return _merge_topk(comms, axis, d, i, k, merge, size)

        return shard_map(local, mesh,
                         (P(axis), P(axis), P(axis), P(axis), P()),
                         (P(), P()))

    return _shmap_plan(("flat_list", mesh, axis, k, n_probes, kind, sqrt,
                        scale, merge, size, comms), build)


def _replicated_queries(index, queries) -> torch.Tensor:
    dev = index.centers.device
    return torch.as_tensor(queries, dtype=torch.float32).to(dev).contiguous()


def distributed_ivf_flat_search(
    index, queries, k: int, params=None, mesh=None, axis: str = "data",
    comms=None, merge: str = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a list-sharded IVF-Flat index (:func:`shard_ivf_flat` /
    :func:`sharded_ivf_flat_build`) → (dists, ids) on the first rank's
    device. ``comms``: a prebuilt communicator (default the cached
    :func:`get_comms`); ``merge``: ``"f32"`` exact | ``"int8"``
    compressed (default f32 unless ``RAFT_TPU_DIST_MERGE`` says so)."""
    from raft_tpu_torch.neighbors import ivf_flat
    params = params or ivf_flat.SearchParams()
    expects(mesh is not None, "distributed ivf_flat: mesh is required")
    q = _replicated_queries(index, queries)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "distributed ivf_flat: dim mismatch")
    if index.metric == DistanceType.CosineExpanded:
        q = ivf_flat._normalize_rows(q)
    n_shards = mesh.shape[axis]
    nl_local = index.n_lists // n_shards
    n_probes = min(params.n_probes, nl_local)
    sqrt = index.metric in ivf_flat._SQRT_METRICS
    kind = ivf_flat._metric_kind(index.metric)
    merge = _resolve_merge(merge)
    comms = comms if comms is not None else get_comms(mesh, axis)
    with spans.span("raft.parallel.ivf.search", family="ivf_flat",
                    nq=int(q.shape[0]), k=k, n_probes=n_probes,
                    axis=axis, n_shards=n_shards, merge=merge):
        fn = _flat_list_plan(mesh, axis, k, n_probes, kind, sqrt,
                             float(index.scale), merge, int(index.size),
                             comms)
        t0 = time.perf_counter()
        d, i = fn(index.centers, index.lists_data, index.lists_indices,
                  index.lists_norms, q)
        _rank_spans(n_shards, t0, time.perf_counter() - t0)
    return ivf_flat._postprocess(d, index.metric), i


def _pq_list_plan(mesh, axis: str, k: int, n_probes: int, kind: str,
                  sqrt: bool, merge: str, size: int, comms):
    """The cached ``shard_map`` of the list-sharded IVF-PQ search over
    the reconstruction cache."""
    from raft_tpu_torch.neighbors import ivf_pq

    def build():
        def local(centers, centers_rot, rot, decoded, decoded_norms,
                  lists_indices, q):
            d, i = ivf_pq._search_impl_reconstruct(
                q, centers, centers_rot, rot, decoded, decoded_norms,
                lists_indices, k, n_probes, sqrt, kind=kind)
            return _merge_topk(comms, axis, d, i, k, merge, size)

        return shard_map(local, mesh,
                         (P(axis), P(axis), P(), P(axis), P(axis), P(axis),
                          P()), (P(), P()))

    return _shmap_plan(("pq_list", mesh, axis, k, n_probes, kind, sqrt,
                        merge, size, comms), build)


def distributed_ivf_pq_search(
    index, queries, k: int, params=None, mesh=None, axis: str = "data",
    comms=None, merge: str = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a list-sharded IVF-PQ index (:func:`shard_ivf_pq` /
    :func:`sharded_ivf_pq_build`) through its reconstruction cache.
    ``comms``/``merge`` as in :func:`distributed_ivf_flat_search`."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    params = params or ivf_pq.SearchParams()
    expects(mesh is not None, "distributed ivf_pq: mesh is required")
    q = _replicated_queries(index, queries)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "distributed ivf_pq: dim mismatch")
    expects(index.decoded is not None,
            "distributed ivf_pq: index not sharded via shard_ivf_pq")
    n_shards = mesh.shape[axis]
    nl_local = index.n_lists // n_shards
    n_probes = min(params.n_probes, nl_local)
    sqrt = index.metric in (DistanceType.L2SqrtExpanded,
                            DistanceType.L2SqrtUnexpanded)
    kind = ivf_flat._metric_kind(index.metric)
    merge = _resolve_merge(merge)
    comms = comms if comms is not None else get_comms(mesh, axis)
    with spans.span("raft.parallel.ivf.search", family="ivf_pq",
                    nq=int(q.shape[0]), k=k, n_probes=n_probes,
                    axis=axis, n_shards=n_shards, merge=merge):
        fn = _pq_list_plan(mesh, axis, k, n_probes, kind, sqrt, merge,
                           int(index.size), comms)
        t0 = time.perf_counter()
        d, i = fn(index.centers, index.centers_rot, index.rotation_matrix,
                  index.decoded, index.decoded_norms, index.lists_indices, q)
        _rank_spans(n_shards, t0, time.perf_counter() - t0)
    return ivf_flat._postprocess(d, index.metric), i


# ---------------------------------------------------------------------------
# the row-parts half: multi-part indexes whose rows stay on the rank
# that holds them


@dataclass
class DistributedIvfFlat:
    """Row-sharded multi-part IVF-Flat index. The ``parts_*`` are
    :class:`Sharded` over ``mesh[axis]``, one block a rank of shape (1,
    n_lists, ml, ...) (the whole: the JAX package's (n_shards, n_lists,
    ml, ...)); ``centers`` is replicated. ``parts_indices`` holds GLOBAL
    row ids, -1 for pads."""

    centers: torch.Tensor        # (n_lists, dim)
    parts_data: Sharded          # (n_shards, n_lists, ml, dim) f32
    parts_indices: Sharded       # (n_shards, n_lists, ml) int32
    parts_norms: Sharded         # (n_shards, n_lists, ml) f32
    metric: DistanceType
    size: int
    mesh: object
    axis: str

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]


@dataclass
class DistributedIvfPq:
    """Row-sharded multi-part IVF-PQ index: the uint8 codes, ids and
    exact code norms are the per-row ``parts_*`` (:class:`Sharded` as in
    :class:`DistributedIvfFlat`); centres, rotation and per-subspace
    codebooks are replicated."""

    centers: torch.Tensor        # (n_lists, dim)
    centers_rot: torch.Tensor    # (n_lists, rot_dim)
    rotation_matrix: torch.Tensor
    pq_centers: torch.Tensor     # (pq_dim, n_codes, pq_len)
    parts_codes: Sharded         # (n_shards, n_lists, ml, pq_dim) uint8
    parts_indices: Sharded       # (n_shards, n_lists, ml) int32
    parts_norms: Sharded         # (n_shards, n_lists, ml) f32
    metric: DistanceType
    pq_bits: int
    size: int
    mesh: object
    axis: str

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def pq_dim(self) -> int:
        return self.pq_centers.shape[0]


@dataclass
class DistributedIvfBq:
    """Row-sharded multi-part IVF-BQ index (the 1-bit tier, sharded as
    :class:`DistributedIvfFlat`): sign words (int32 holding the JAX
    package's uint32 bits), ``|r|^2`` and mean ``|r|`` per row. ``raw``
    optionally holds the whole dataset on the host for the exact re-rank
    after the merge; ``raw_dev`` is its lazy device copy
    (``ivf_bq.resolve_raw_device``)."""

    centers: torch.Tensor        # (n_lists, dim)
    centers_rot: torch.Tensor    # (n_lists, dim)
    rotation_matrix: torch.Tensor
    parts_bits: Sharded          # (n_shards, n_lists, ml, w) int32
    parts_norms2: Sharded        # (n_shards, n_lists, ml) f32
    parts_scales: Sharded        # (n_shards, n_lists, ml) f32
    parts_indices: Sharded       # (n_shards, n_lists, ml) int32
    metric: DistanceType
    size: int
    mesh: object
    axis: str
    raw: Optional[np.ndarray] = None
    raw_dev: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device


_PARTS_CLASSES = {"ivf_flat": DistributedIvfFlat, "ivf_pq": DistributedIvfPq,
                  "ivf_bq": DistributedIvfBq}
_PARTS_DTYPES = {"parts_codes": np.uint8, "parts_indices": np.int32,
                 "parts_bits": np.uint32}


def _parts_from_numpy(family: str, arrays: dict, mesh, axis: str = "data",
                     **meta):
    """A multi-part index of ``family`` from host arrays of the JAX
    package's fields (the ``parts_*`` of shape (n_shards, n_lists, ml,
    ...), split one block a rank; the rest replicated on the mesh's first
    device; uint32 bits viewed as int32) and its scalars ``meta``
    (``metric``, ``size``, ``pq_bits``, ``raw``). The ``mesh=`` form of
    the families' ``index_from_numpy``."""
    from raft_tpu_torch.neighbors.ivf_flat import _host_array
    cls = _PARTS_CLASSES[family]
    dev = mesh.devices_flat[0]
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        a = _host_array(arrays[f.name], _PARTS_DTYPES.get(f.name,
                                                          np.float32))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(a).to(dev)
        kw[f.name] = _split(t, mesh, axis) if f.name.startswith(
            "parts_") else t
    meta["metric"] = DistanceType(int(meta["metric"]))
    if meta.get("raw") is not None:
        meta["raw"] = np.ascontiguousarray(meta["raw"], np.float32)
    return cls(mesh=mesh, axis=axis, **kw, **meta)


def _parts_build(x, centers, mesh, axis, kind, encode, key, extra=()):
    """The per-rank half of the multi-part builds: each rank labels its
    own rows (kernel 1 for L2) and one host sync agrees the width every
    rank buckets at, ``ml = max(8, ceil8(the largest count))``; then per
    rank ``encode(x_loc, labels (pads at list 0), c,
    *extra)`` → payload rows, bucketed at the agreed width in row order
    (pads dropped: their slots stay zeros, id -1) → ``(payload (1,
    n_lists, ml, ...), ids (1, n_lists, ml))`` as :class:`Sharded`.
    ``extra`` are replicated tensors; ``encode`` holds no state of its
    own (the cached ``shard_map`` keeps the first build's)."""
    n_lists = centers.shape[0]
    xs, ids_s = _shard_rows(x, mesh, axis)
    # the JAX package's _label_and_agree_width: its width is the
    # list-sharded pass's per-rank bound (pad rows outside the counts)
    labels_s, ml, _, _ = _label_and_widths(xs, ids_s, centers, mesh, axis,
                                           n_lists, kind)

    def local(x_loc, lbl_loc, ids_loc, c, *rep):
        lbl = torch.where(lbl_loc < n_lists, lbl_loc,
                          torch.zeros_like(lbl_loc))
        payload = encode(x_loc, lbl.long(), c, *rep)
        data, idx = _bucketize_static(payload, lbl_loc, ids_loc, n_lists,
                                      ml)
        return data[None], idx[None]

    specs = (P(axis), P(axis), P(axis)) + (P(),) * (1 + len(extra))
    with obs.timed("raft.build.parts.encode", family=key[0]):
        fn = _shmap_plan(key + (mesh, axis, n_lists, ml),
                         lambda: shard_map(local, mesh, specs,
                                           (P(axis), P(axis))))
        return fn(xs, labels_s, ids_s, centers, *extra)


def _flat_rows(x_loc, lbl, c):
    return x_loc


def _pq_codes(x_loc, lbl, c, rot, books):
    from raft_tpu_torch.neighbors import ivf_pq
    return ivf_pq._encode((x_loc - c[lbl]) @ rot.T, books)


def _bq_payload(x_loc, lbl, c, rot):
    from raft_tpu_torch.neighbors import ivf_bq
    return ivf_bq._encode_payload(x_loc, c, lbl, rot)[0]


def _blockwise(fn, *arrs):
    """``fn`` over each rank's blocks of :class:`Sharded` arrays (on the
    calling thread) → a :class:`Sharded` of the results."""
    a0 = arrs[0]
    return Sharded([fn(*bs) for bs in zip(*(a.blocks for a in arrs))],
                   a0.mesh, a0.axis)


def _coarse_fit(x, params, mesh, axis):
    """The multi-part builds' coarse centres: the MNMG Lloyd loop over
    the row-sharded data, k-means++ init (``KMeansParams``' default)."""
    from raft_tpu_torch.cluster.kmeans_types import KMeansParams
    from raft_tpu_torch.parallel import kmeans as pkm
    with obs.timed("raft.build.parts.train"):
        centers, _, _ = pkm.distributed_kmeans_fit(
            x, KMeansParams(n_clusters=params.n_lists,
                            max_iter=params.kmeans_n_iters), mesh, axis)
    return centers


def _prep_parts(x, params, mesh):
    expects(mesh is not None, "distributed build: mesh is required")
    x = torch.as_tensor(x, dtype=torch.float32)
    expects(params.n_lists <= x.shape[0],
            "distributed build: n_lists > n_samples")
    full_fp32_matmul()
    return x


def distributed_ivf_flat_build(x, params=None, mesh=None,
                               axis: str = "data") -> DistributedIvfFlat:
    """Build a row-sharded multi-part IVF-Flat index on the mesh: MNMG
    k-means for the coarse centres, then each rank labels and buckets
    its own rows into partial lists with global ids. No single-device
    index exists at any point."""
    from raft_tpu_torch.neighbors import ivf_flat
    params = params or ivf_flat.IndexParams()
    expects(mesh is not None, "distributed build: mesh is required")
    expects(params.metric in ivf_flat._METRICS,
            "distributed ivf_flat build: unsupported metric %s",
            params.metric)
    expects(params.storage_dtype == "float32",
            "distributed ivf_flat build: narrow list storage (%s) is not "
            "implemented for sharded parts yet; use float32",
            params.storage_dtype)
    x = _prep_parts(x, params, mesh)
    if params.metric == DistanceType.CosineExpanded:
        x = ivf_flat._normalize_rows(x)
    kind = ivf_flat._metric_kind(params.metric)
    with spans.span("raft.build.parts", family="ivf_flat",
                    rows=int(x.shape[0]), n_lists=params.n_lists):
        centers = _coarse_fit(x, params, mesh, axis)
        data, idx = _parts_build(x, centers, mesh, axis, kind, _flat_rows,
                                 ("flat_dbucket", x.shape[1]))
        norms = _blockwise(lambda dt, it: torch.where(
            it >= 0, (dt * dt).sum(dim=3), 0.0), data, idx)
    return DistributedIvfFlat(
        centers=centers, parts_data=data, parts_indices=idx,
        parts_norms=norms, metric=params.metric, size=int(x.shape[0]),
        mesh=mesh, axis=axis)


def _parts_search(dindex, family: str, key, q, local, args, **attrs):
    """Run a multi-part search's cached ``shard_map`` (replicated
    arguments then the ``parts_*``, the queries last) under its span."""
    mesh, axis = dindex.mesh, dindex.axis
    n_shards = mesh.shape[axis]
    n_rep = len(args) - sum(isinstance(a, Sharded) for a in args)
    specs = tuple(P(axis) if isinstance(a, Sharded) else P()
                  for a in args) + (P(),)
    with spans.span("raft.parallel.ivf.search", family=family,
                    nq=int(q.shape[0]), axis=axis, n_shards=n_shards,
                    **attrs):
        fn = _shmap_plan(key + (mesh, axis, n_rep),
                         lambda: shard_map(local, mesh, specs, (P(), P())))
        t0 = time.perf_counter()
        out = fn(*args, q)
        _rank_spans(n_shards, t0, time.perf_counter() - t0)
    return out


def _parts_queries(dindex, queries) -> torch.Tensor:
    q = _replicated_queries(dindex, queries)
    expects(q.dim() == 2 and q.shape[1] == dindex.dim,
            "distributed search: dim mismatch")
    return q


def distributed_ivf_flat_search_parts(dindex, queries, k: int,
                                      params=None, comms=None):
    """Search a multi-part IVF-Flat index: every rank runs the
    probe-major search (``ivf_flat._search_impl``: the coarse select on
    kernel 2, per probe one product and a stable merge) of its partial
    lists against the GLOBAL centres, then the ranks merge their top-k
    (:func:`_global_merge`). The scanned set equals the single-device
    index's at the same ``n_probes`` → (dists, ids) on the first rank's
    device."""
    from raft_tpu_torch.neighbors import ivf_flat
    params = params or ivf_flat.SearchParams()
    q = _parts_queries(dindex, queries)
    if dindex.metric == DistanceType.CosineExpanded:
        q = ivf_flat._normalize_rows(q)
    kind = ivf_flat._metric_kind(dindex.metric)
    n_probes = min(params.n_probes, dindex.n_lists)
    sqrt = dindex.metric in ivf_flat._SQRT_METRICS
    comms = comms if comms is not None else get_comms(dindex.mesh,
                                                      dindex.axis)
    axis = dindex.axis

    def local(centers, pdata, pidx, pnorms, q_rep):
        full_fp32_matmul()
        d, i = ivf_flat._search_impl(q_rep, centers, pdata[0], pidx[0],
                                     pnorms[0], k, n_probes, sqrt,
                                     kind=kind)
        return _global_merge(comms, axis, d, i, k)

    d, i = _parts_search(
        dindex, "ivf_flat_parts",
        ("flat_parts", k, n_probes, kind, sqrt, comms), q, local,
        (dindex.centers, dindex.parts_data, dindex.parts_indices,
         dindex.parts_norms), k=k, n_probes=n_probes)
    return ivf_flat._postprocess(d, dindex.metric), i


def _pq_books(x, centers, rot, params, kind: str, pq_dim: int, pq_len: int,
              seed: int):
    """Per-subspace codebooks trained on a bounded subsample (``min(n,
    2^15)`` rows, ``sample_rows(n, m, seed + 3)``) of rotated residuals,
    replicated: the multi-part and list-sharded PQ builds' books."""
    from raft_tpu_torch.neighbors import ivf_pq
    n = x.shape[0]
    with obs.timed("raft.build.sharded.codebooks"):
        m = min(n, 1 << 15)
        sel = (sample_rows(n, m, seed + 3, x.device) if m < n
               else torch.arange(n, device=x.device))
        xs_cb = x[sel]
        resid_cb = (xs_cb - centers[_labels(xs_cb, centers, kind)]) @ rot.T
        return ivf_pq._train_codebooks_per_subspace(
            resid_cb, pq_dim, pq_len, 1 << params.pq_bits,
            params.kmeans_n_iters, seed + 2,
            reseed_threshold=params.reseed_threshold)


def _pq_geometry(params, n: int, dim: int):
    """``(pq_dim, rot_dim, pq_len)`` of a PQ build over ``n`` rows."""
    expects(n >= (1 << params.pq_bits),
            "distributed ivf_pq build: need at least 2^pq_bits (%d) "
            "training rows", 1 << params.pq_bits)
    pq_dim = params.pq_dim if params.pq_dim > 0 else max(1, dim // 4)
    rot_dim = -(-dim // pq_dim) * pq_dim
    return pq_dim, rot_dim, rot_dim // pq_dim


def distributed_ivf_pq_build(x, params=None, mesh=None, axis: str = "data",
                             seed: int = 0) -> DistributedIvfPq:
    """Build a row-sharded multi-part IVF-PQ index on the mesh: MNMG
    k-means coarse centres, the rotation (``seed + 1``) and per-subspace
    codebooks on a bounded subsample (:func:`_pq_books`), then each rank
    encodes and buckets its own rows. Codes never leave their rank."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    params = params or ivf_pq.IndexParams()
    expects(mesh is not None, "distributed build: mesh is required")
    expects(params.codebook_kind == ivf_pq.CodebookGen.PER_SUBSPACE,
            "distributed_ivf_pq_build: PER_CLUSTER codebooks are not "
            "supported on the distributed path yet — build single-host "
            "or use PER_SUBSPACE")
    expects(params.metric in ivf_pq._METRICS,
            "distributed ivf_pq build: L2-family and InnerProduct "
            "metrics are supported (got %s)", params.metric)
    x = _prep_parts(x, params, mesh)
    n, dim = x.shape
    pq_dim, rot_dim, pq_len = _pq_geometry(params, n, dim)
    kind = ivf_flat._metric_kind(params.metric)
    with spans.span("raft.build.parts", family="ivf_pq", rows=n,
                    n_lists=params.n_lists):
        centers = _coarse_fit(x, params, mesh, axis)
        rot = ivf_pq.make_rotation_matrix(dim, rot_dim,
                                          params.force_random_rotation,
                                          seed=seed + 1, device=x.device)
        books = _pq_books(x, centers, rot, params, kind, pq_dim, pq_len,
                          seed)
        codes, idx = _parts_build(x, centers, mesh, axis, kind, _pq_codes,
                                  ("pq_dencode", pq_dim, dim), (rot, books))
        norms = _blockwise(lambda cb, it: ivf_pq._code_norms(
            cb[0], books, it[0])[None], codes, idx)
    return DistributedIvfPq(
        centers=centers, centers_rot=centers @ rot.T, rotation_matrix=rot,
        pq_centers=books, parts_codes=codes, parts_indices=idx,
        parts_norms=norms, metric=params.metric, pq_bits=params.pq_bits,
        size=n, mesh=mesh, axis=axis)


def _pq_probe_scorer(q_rot, centers_rot, books, codes, ids, norms,
                     kind: str):
    """One probe rank of the multi-part IVF-PQ scan: the probed blocks'
    codes decoded by indexing the (rounded) books — one (nq, ml,
    rot_dim) f32 tile, where the JAX package's one-hot product gives the
    same values — then the IP score ``q.(dec + c)`` or the L2 score
    ``|q - c|^2 + |dec|^2 - 2 (q - c).dec``; pads +inf."""
    pq_dim, _, pq_len = books.shape
    subs = torch.arange(pq_dim, device=books.device)

    def score(list_id):
        lid = list_id.long()
        cb = codes[lid].long()                           # (nq, ml, S)
        pid = ids[lid]
        nq, ml = pid.shape
        dec = books[subs, cb].reshape(nq, ml, pq_dim * pq_len)
        inf = torch.full(pid.shape, float("inf"), device=dec.device)
        if kind == "ip":
            full = dec + centers_rot[lid][:, None, :]
            ip = torch.bmm(full, q_rot[:, :, None])[..., 0]
            return torch.where(pid >= 0, -ip, inf), pid
        resid = q_rot - centers_rot[lid]
        ip = torch.bmm(dec, resid[:, :, None])[..., 0]
        rr = (resid * resid).sum(dim=1)
        d = (rr[:, None] + norms[lid]) - 2.0 * ip
        return torch.where(pid >= 0, torch.clamp(d, min=0.0), inf), pid

    return score


def distributed_ivf_pq_search_parts(dindex, queries, k: int, params=None,
                                    comms=None):
    """Search a multi-part IVF-PQ index: per rank, the probe-major scan
    of its partial lists (:func:`_pq_probe_scorer`: the probed codes
    decoded transiently from the books rounded to ``params.lut_dtype``,
    float32 | bfloat16 | float8_e4m3fn widened to bf16), then the ranks'
    merge. The codes stay compressed at rest."""
    from raft_tpu_torch.neighbors import _ivf_scan, ivf_flat, ivf_pq
    from raft_tpu_torch.ops.ivf_pq_scan import LUT_DTYPES, lut_operands
    params = params or ivf_pq.SearchParams()
    q = _parts_queries(dindex, queries)
    kind = ivf_flat._metric_kind(dindex.metric)
    n_probes = min(params.n_probes, dindex.n_lists)
    sqrt = dindex.metric in ivf_flat._SQRT_METRICS
    expects(params.lut_dtype in LUT_DTYPES,
            "distributed ivf_pq search: lut_dtype must be "
            "float32|bfloat16|float8_e4m3fn")
    comms = comms if comms is not None else get_comms(dindex.mesh,
                                                      dindex.axis)
    axis = dindex.axis

    def local(centers, centers_rot, rot, books, pcodes, pidx, pnorms,
              q_rep):
        full_fp32_matmul()
        books_op = lut_operands(books, params.lut_dtype)[0].float()
        q_rot = q_rep @ rot.T
        d, i = _ivf_scan.probe_major_search(
            q_rep, centers, n_probes, k, sqrt, kind,
            _pq_probe_scorer(q_rot, centers_rot, books_op, pcodes[0],
                             pidx[0], pnorms[0], kind))
        return _global_merge(comms, axis, d, i, k)

    d, i = _parts_search(
        dindex, "ivf_pq_parts",
        ("pq_parts", k, n_probes, kind, sqrt, dindex.pq_dim,
         1 << dindex.pq_bits, str(params.lut_dtype), comms), q, local,
        (dindex.centers, dindex.centers_rot, dindex.rotation_matrix,
         dindex.pq_centers, dindex.parts_codes, dindex.parts_indices,
         dindex.parts_norms), k=k, n_probes=n_probes)
    return ivf_flat._postprocess(d, dindex.metric), i


def distributed_ivf_bq_build(x, params=None, mesh=None,
                             axis: str = "data") -> DistributedIvfBq:
    """Row-sharded IVF-BQ build: MNMG k-means coarse phase, then each
    rank sign-encodes its own rows against the random rotation (full f32
    products: the sign is the code) and buckets them. The whole dataset
    stays on the host as ``raw`` when ``params.keep_raw``."""
    from raft_tpu_torch.neighbors import ivf_bq, ivf_pq
    params = params or ivf_bq.IndexParams()
    expects(mesh is not None, "distributed build: mesh is required")
    expects(params.metric in (DistanceType.L2Expanded,
                              DistanceType.L2SqrtExpanded),
            "distributed ivf_bq build: L2 metrics only (got %s)",
            params.metric)
    x = _prep_parts(x, params, mesh)
    n, dim = x.shape
    w = -(-dim // 32)
    with spans.span("raft.build.parts", family="ivf_bq", rows=n,
                    n_lists=params.n_lists):
        centers = _coarse_fit(x, params, mesh, axis)
        rot = ivf_pq.make_rotation_matrix(dim, dim, force_random=True,
                                          device=x.device)
        payload, idx = _parts_build(x, centers, mesh, axis, "l2",
                                    _bq_payload, ("bq_dencode", dim), (rot,))
        split = [ivf_bq._split_payload(b[0], w) for b in payload.blocks]
        bits, norms2, scales = (
            Sharded([s[j][None] for s in split], mesh, axis)
            for j in range(3))
        del payload, split
    return DistributedIvfBq(
        centers=centers, centers_rot=centers @ rot.T, rotation_matrix=rot,
        parts_bits=bits, parts_norms2=norms2, parts_scales=scales,
        parts_indices=idx, metric=params.metric, size=n, mesh=mesh,
        axis=axis, raw=x.cpu().numpy() if params.keep_raw else None)


def distributed_ivf_bq_search_parts(dindex, queries, k: int, params=None,
                                    comms=None):
    """Search the multi-part binary index: every rank scans its partial
    probed lists with the 1-bit estimator (``|q_r|^2 + |r|^2 - 2 s <q_r,
    sign(r)>``, the ``q_r`` rounded to bf16 and the ``+-1`` exact), the
    ranks merge ``kk = max(rescore_factor, 1) * k`` candidates, and with
    ``raw`` the survivors are re-ranked exactly (``finish_search``, on
    the device under ``rescore_on_device``)."""
    from raft_tpu_torch.neighbors import _ivf_scan, ivf_bq
    params = params or ivf_bq.SearchParams()
    q = _parts_queries(dindex, queries)
    n_probes = min(params.n_probes, dindex.n_lists)
    rescore = params.rescore_factor > 0 and dindex.raw is not None
    kk = max(params.rescore_factor, 1) * k
    dim = dindex.dim
    comms = comms if comms is not None else get_comms(dindex.mesh,
                                                      dindex.axis)
    axis = dindex.axis

    def local(centers, centers_rot, rot, pbits, pn2, psc, pidx, q_rep):
        full_fp32_matmul()
        q_rot = q_rep @ rot.T

        def score(list_id):
            lid = list_id.long()
            pm1 = ivf_bq._unpack_pm1(pbits[0][lid], dim)   # (nq, ml, d)
            ql = q_rot - centers_rot[lid]
            ip = torch.bmm(pm1, ql.bfloat16().float()[:, :, None])[..., 0]
            qq = (ql * ql).sum(dim=1)[:, None]
            est = (qq + pn2[0][lid]) - 2.0 * psc[0][lid] * ip
            ids = pidx[0][lid]
            return torch.where(ids >= 0, est, float("inf")), ids

        d, i = _ivf_scan.probe_major_search(q_rep, centers, n_probes, kk,
                                            False, "l2", score)
        return _global_merge(comms, axis, d, i, kk)

    d_est, ids = _parts_search(
        dindex, "ivf_bq_parts", ("bq_parts", kk, n_probes, dim, comms), q,
        local,
        (dindex.centers, dindex.centers_rot, dindex.rotation_matrix,
         dindex.parts_bits, dindex.parts_norms2, dindex.parts_scales,
         dindex.parts_indices), k=k, n_probes=n_probes, rescore=rescore)
    raw_dev = (ivf_bq.resolve_raw_device(dindex, params.rescore_on_device)
               if rescore else None)
    return ivf_bq.finish_search(d_est, ids, dindex.raw, q, k,
                                metric=dindex.metric, rescore=rescore,
                                raw_dev=raw_dev)


# ---------------------------------------------------------------------------
# list-layout sharded builds


def _shard_rows(x, mesh, axis):
    """Rows in blocks over ``mesh[axis]`` (zero-padded) and their global
    ids (pad rows -1) → ``(Sharded rows, Sharded ids)``."""
    xs, pad = shard_rows(x, mesh, axis)
    n = x.shape[0]
    ids = torch.arange(n + pad, dtype=torch.int32, device=x.device)
    ids = torch.where(ids < n, ids, torch.full_like(ids, -1))
    return xs, _split(ids, mesh, axis)


def _train_coarse_sharded(x, params, mesh, axis: str, seed: int):
    """The coarse centres of a list-layout sharded build: the
    single-device build's trainset draw, fed to the data-parallel
    balanced trainer (the two-level single-device trainer above 16384
    lists)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    n = x.shape[0]
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = (take_rows(x, sample_rows(n, n_train, seed, x.device))
                if n_train < n else x)
    with obs.timed("raft.build.sharded.train"):
        if params.n_lists > kmeans_balanced.FLAT_MAX_CLUSTERS:
            return kmeans_balanced.build_hierarchical(
                trainset, params.n_lists, params.kmeans_n_iters, seed=seed,
                kernel_precision=params.kmeans_kernel_precision)
        return kmeans_balanced.balanced_kmeans_sharded(
            trainset, params.n_lists, params.kmeans_n_iters, seed=seed,
            kernel_precision=params.kmeans_kernel_precision, mesh=mesh,
            axis=axis)


def _labels(x: torch.Tensor, centers: torch.Tensor, kind: str):
    """Nearest-centre labels (int64): kernel 1 for L2, the coarse
    scores' argmin for the inner-product core."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors._ivf_scan import coarse_scores
    if kind == "l2":
        return kmeans_balanced.predict(x, centers).long()
    return torch.argmin(coarse_scores(x, centers, kind), dim=1)


def _label_and_widths(xs, ids_s, centers, mesh, axis, n_lists: int,
                      kind: str):
    """Each rank's labels (pad rows get ``n_lists``) and per-list counts,
    then one host sync agrees both bucket widths: ``ml_shard`` bounds
    any one rank's count of a list (the pre-exchange bucket),
    ``ml_global`` any list's total (the serving bucket). Returns
    ``(labels, ml_shard, ml_global, totals)``."""

    def build():
        def count_local(x_loc, ids_loc, c):
            lbl = _labels(x_loc, c, kind)
            lbl = torch.where(ids_loc >= 0, lbl,
                              torch.full_like(lbl, n_lists))
            cnt = torch.bincount(lbl, minlength=n_lists + 1)[:n_lists]
            return lbl, cnt

        return shard_map(count_local, mesh, (P(axis), P(axis), P()),
                         (P(axis), P(axis)))

    counted = _shmap_plan(("count_widths", mesh, axis, n_lists, kind),
                          build)
    labels_s, counts = counted(xs, ids_s, centers)
    c = counts.numpy().reshape(mesh.shape[axis], n_lists)
    ml_shard = max(8, -(-int(c.max()) // 8) * 8)
    totals = c.sum(axis=0)
    ml_global = max(8, -(-int(totals.max()) // 8) * 8)
    return labels_s, ml_shard, ml_global, totals.astype(np.int32)


def _bucketize_static(x, labels, ids, n_lists: int, width: int):
    """Rows with a label below ``n_lists`` scattered into
    (n_lists, width) buckets in row order (pads: zeros, id -1)."""
    keep = labels < n_lists
    x, labels, ids = x[keep], labels[keep], ids[keep]
    n = x.shape[0]
    counts = torch.bincount(labels, minlength=n_lists)
    order = torch.argsort(labels, stable=True)
    sl = labels[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = sl * width + (torch.arange(n, device=x.device) - starts[sl])
    data = torch.zeros((n_lists * width,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    data[slot] = x[order]
    idx = torch.full((n_lists * width,), -1, dtype=torch.int32,
                     device=x.device)
    idx[slot] = ids[order].to(torch.int32)
    return (data.reshape((n_lists, width) + tuple(x.shape[1:])),
            idx.reshape(n_lists, width))


def _exchange_lists(comms, data, idx, n_shards: int, ml_global: int):
    """Inside ``shard_map``: each rank's (n_lists, ml_shard, ...) buckets
    to the list-sharded serving layout. One ``alltoall`` gives every rank
    each peer's buckets of its own lists; they are laid side by side
    along the slot axis and the filled slots compacted to the front by a
    stable sort (rows keep source-rank-major order) → (nl_local,
    ml_global, ...). ``ml_global`` bounds every list's total, so nothing
    is dropped."""
    n_lists, ml_shard = idx.shape
    nl_local = n_lists // n_shards
    tail = tuple(data.shape[2:])
    d2 = comms.alltoall(data.reshape((n_shards, nl_local, ml_shard) + tail))
    i2 = comms.alltoall(idx.reshape(n_shards, nl_local, ml_shard))
    perm = (1, 0, 2) + tuple(range(3, 3 + len(tail)))
    d2 = d2.permute(perm).reshape((nl_local, n_shards * ml_shard) + tail)
    i2 = i2.permute(1, 0, 2).reshape(nl_local, n_shards * ml_shard)
    order = torch.argsort((i2 < 0).to(torch.int8), dim=1,
                          stable=True)[:, :ml_global]
    i2 = torch.gather(i2, 1, order)
    gidx = order.reshape(order.shape + (1,) * len(tail)).expand(
        order.shape + tail)
    d2 = torch.gather(d2, 1, gidx)
    return d2, i2


def _prep_build(x, params, mesh, axis, metrics, family: str):
    expects(mesh is not None, "sharded build: mesh is required")
    n_shards = mesh.shape[axis]
    expects(params.n_lists % n_shards == 0,
            "sharded_ivf_%s_build: n_lists=%d not divisible by %d shards",
            family, params.n_lists, n_shards)
    expects(params.metric in metrics,
            "sharded ivf_%s build: unsupported metric %s", family,
            params.metric)
    x = torch.as_tensor(x, dtype=torch.float32)
    expects(params.n_lists <= x.shape[0],
            "sharded build: n_lists > n_samples")
    return x, n_shards


def _run_lbuild(key, mesh, axis, local, in_specs, out_specs, args,
                family: str):
    with obs.timed("raft.build.sharded.encode", family=family):
        fn = _shmap_plan(key, lambda: shard_map(local, mesh, in_specs,
                                                out_specs))
        return fn(*args)


def sharded_ivf_flat_build(x, params=None, mesh=None, axis: str = "data",
                           seed: int = 0):
    """Build an IVF-Flat index straight into the list-sharded layout
    (the :func:`shard_ivf_flat` layout): data-parallel balanced k-means,
    per-rank labels and buckets of each rank's own rows, one
    ``alltoall`` landing every list on its rank. Served as it is by
    :func:`distributed_ivf_flat_search`, or gathered
    (:func:`gather_index`) for one device."""
    from raft_tpu_torch.neighbors import ivf_flat
    params = params or ivf_flat.IndexParams()
    x, n_shards = _prep_build(x, params, mesh, axis, ivf_flat._METRICS,
                              "flat")
    expects(params.storage_dtype == "float32",
            "sharded ivf_flat build: narrow list storage (%s) is not "
            "implemented for sharded lists yet; use float32",
            params.storage_dtype)
    full_fp32_matmul()
    if params.metric == DistanceType.CosineExpanded:
        x = ivf_flat._normalize_rows(x)
    n, dim = x.shape
    n_lists = params.n_lists
    kind = ivf_flat._metric_kind(params.metric)
    comms = get_comms(mesh, axis)
    with spans.span("raft.build.sharded", family="ivf_flat", rows=n,
                    n_lists=n_lists, n_shards=n_shards):
        obs.counter("raft.build.sharded.total", family="ivf_flat").inc()
        obs.counter("raft.build.sharded.rows", family="ivf_flat").inc(n)
        centers = _train_coarse_sharded(x, params, mesh, axis, seed)
        xs, ids_s = _shard_rows(x, mesh, axis)
        labels_s, ml_shard, ml_global, totals = _label_and_widths(
            xs, ids_s, centers, mesh, axis, n_lists, kind)

        def local(x_loc, lbl_loc, ids_loc):
            data, idx = _bucketize_static(x_loc, lbl_loc, ids_loc, n_lists,
                                          ml_shard)
            d2, i2 = _exchange_lists(comms, data, idx, n_shards, ml_global)
            del data, idx
            norms = (d2 * d2).sum(dim=2)
            return d2, i2, torch.where(i2 >= 0, norms,
                                       torch.zeros_like(norms))

        data, idx, norms = _run_lbuild(
            ("flat_lbuild", mesh, axis, n_lists, ml_shard, ml_global, dim),
            mesh, axis, local, (P(axis), P(axis), P(axis)),
            (P(axis), P(axis), P(axis)), (xs, labels_s, ids_s), "ivf_flat")
    return ivf_flat.Index(
        centers=_shard0(centers, mesh, axis), lists_data=data,
        lists_indices=idx, lists_norms=norms,
        list_sizes=_shard0(torch.from_numpy(totals).to(x.device), mesh,
                           axis),
        metric=params.metric, size=n, scale=1.0)


def sharded_ivf_pq_build(x, params=None, mesh=None, axis: str = "data",
                         seed: int = 0):
    """Build an IVF-PQ index straight into the list-sharded layout (the
    :func:`shard_ivf_pq` layout, reconstruction cache included):
    data-parallel coarse centres, replicated rotation and per-subspace
    codebooks trained on a bounded subsample, per-rank encode, one
    ``alltoall`` of the uint8 codes, shard-local decode."""
    from raft_tpu_torch.neighbors import ivf_pq
    params = params or ivf_pq.IndexParams()
    expects(params.codebook_kind == ivf_pq.CodebookGen.PER_SUBSPACE,
            "sharded_ivf_pq_build: PER_CLUSTER codebooks are not supported "
            "on the sharded path — build on one device or use PER_SUBSPACE")
    x, n_shards = _prep_build(x, params, mesh, axis, ivf_pq._METRICS, "pq")
    full_fp32_matmul()
    n, dim = x.shape
    pq_dim, rot_dim, pq_len = _pq_geometry(params, n, dim)
    n_lists = params.n_lists
    n_codes = 1 << params.pq_bits
    from raft_tpu_torch.neighbors.ivf_flat import _metric_kind
    kind = _metric_kind(params.metric)
    comms = get_comms(mesh, axis)
    with spans.span("raft.build.sharded", family="ivf_pq", rows=n,
                    n_lists=n_lists, n_shards=n_shards):
        obs.counter("raft.build.sharded.total", family="ivf_pq").inc()
        obs.counter("raft.build.sharded.rows", family="ivf_pq").inc(n)
        centers = _train_coarse_sharded(x, params, mesh, axis, seed)
        rot = ivf_pq.make_rotation_matrix(dim, rot_dim,
                                          params.force_random_rotation,
                                          seed=seed + 1, device=x.device)
        centers_rot = centers @ rot.T
        pq_centers = _pq_books(x, centers, rot, params, kind, pq_dim,
                               pq_len, seed)
        xs, ids_s = _shard_rows(x, mesh, axis)
        labels_s, ml_shard, ml_global, totals = _label_and_widths(
            xs, ids_s, centers, mesh, axis, n_lists, kind)

        def local(x_loc, lbl_loc, ids_loc, c, r, books):
            lbl = torch.where(lbl_loc < n_lists, lbl_loc,
                              torch.zeros_like(lbl_loc))
            codes = ivf_pq._encode((x_loc - c[lbl]) @ r.T, books)
            data, idx = _bucketize_static(codes, lbl_loc, ids_loc, n_lists,
                                          ml_shard)
            d2, i2 = _exchange_lists(comms, data, idx, n_shards, ml_global)
            norms = ivf_pq._code_norms(d2, books, i2)
            return d2, i2, norms, ivf_pq._decode_lists(d2, books, i2, False)

        codes_b, idx, norms, decoded = _run_lbuild(
            ("pq_lbuild", mesh, axis, n_lists, ml_shard, ml_global, pq_dim,
             n_codes, kind), mesh, axis, local,
            (P(axis), P(axis), P(axis), P(), P(), P()),
            (P(axis), P(axis), P(axis), P(axis)),
            (xs, labels_s, ids_s, centers, rot, pq_centers), "ivf_pq")
    return ivf_pq.Index(
        centers=_shard0(centers, mesh, axis),
        centers_rot=_shard0(centers_rot, mesh, axis), rotation_matrix=rot,
        pq_centers=pq_centers, codes=codes_b, lists_indices=idx,
        list_sizes=_shard0(torch.from_numpy(totals).to(x.device), mesh,
                           axis),
        metric=params.metric, pq_bits=params.pq_bits, size=n,
        codebook_kind=ivf_pq.CodebookGen.PER_SUBSPACE, code_norms=norms,
        decoded=decoded, decoded_norms=norms,
        raw=x.cpu().numpy() if params.keep_raw else None)


def sharded_ivf_bq_build(x, params=None, mesh=None, axis: str = "data",
                         seed: int = 0):
    """Build an IVF-BQ index into the list-sharded layout: data-parallel
    coarse phase, per-rank sign encode, one ``alltoall`` of the int32 bit
    payload. Returns an ``ivf_bq.Index`` whose list arrays are sharded;
    at one bit a row the payload usually fits one device, so callers
    often gather it (:func:`gather_index`) for single-device serving."""
    from raft_tpu_torch.neighbors import ivf_bq
    from raft_tpu_torch.neighbors.ivf_pq import make_rotation_matrix
    params = params or ivf_bq.IndexParams()
    x, n_shards = _prep_build(
        x, params, mesh, axis,
        (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded), "bq")
    full_fp32_matmul()
    n, dim = x.shape
    n_lists = params.n_lists
    w = -(-dim // 32)
    comms = get_comms(mesh, axis)
    with spans.span("raft.build.sharded", family="ivf_bq", rows=n,
                    n_lists=n_lists, n_shards=n_shards):
        obs.counter("raft.build.sharded.total", family="ivf_bq").inc()
        obs.counter("raft.build.sharded.rows", family="ivf_bq").inc(n)
        centers = _train_coarse_sharded(x, params, mesh, axis, seed)
        rot = make_rotation_matrix(dim, dim, force_random=True,
                                   device=x.device)
        xs, ids_s = _shard_rows(x, mesh, axis)
        labels_s, ml_shard, ml_global, totals = _label_and_widths(
            xs, ids_s, centers, mesh, axis, n_lists, "l2")

        def local(x_loc, lbl_loc, ids_loc, c, rt):
            lbl = torch.where(lbl_loc < n_lists, lbl_loc,
                              torch.zeros_like(lbl_loc))
            payload, _ = ivf_bq._encode_payload(x_loc, c, lbl, rt)
            data, idx = _bucketize_static(payload, lbl_loc, ids_loc,
                                          n_lists, ml_shard)
            d2, i2 = _exchange_lists(comms, data, idx, n_shards, ml_global)
            bits, norms2, scales = ivf_bq._split_payload(d2, w)
            return bits, norms2, scales, i2

        bits, norms2, scales, idx = _run_lbuild(
            ("bq_lbuild", mesh, axis, n_lists, ml_shard, ml_global, dim),
            mesh, axis, local, (P(axis), P(axis), P(axis), P(), P()),
            (P(axis),) * 4, (xs, labels_s, ids_s, centers, rot), "ivf_bq")
    return ivf_bq.Index(
        centers=_shard0(centers, mesh, axis),
        centers_rot=_shard0(centers @ rot.T, mesh, axis),
        rotation_matrix=rot, bits=bits, norms2=norms2, scales=scales,
        lists_indices=idx,
        list_sizes=_shard0(torch.from_numpy(totals).to(x.device), mesh,
                           axis),
        metric=params.metric, size=n,
        raw=x.cpu().numpy() if params.keep_raw else None)

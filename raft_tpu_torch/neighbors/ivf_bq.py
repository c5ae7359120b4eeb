"""IVF-BQ ANN index (counterpart of ``raft_tpu.neighbors.ivf_bq``): 1 bit
per dimension plus a per-row norm and scale, with exact rescoring.

Layout: the JAX package's. Coarse centres, a random (dim, dim) rotation
and the rotated centres; per list row the sign bits of the rotated
residual ``r = rot (x - c_l)`` packed 32 to an int32 word (bit ``j %
32`` of word ``j // 32`` is ``r_j >= 0``; the JAX package holds the
same bit patterns as uint32), ``norms2 = |r|^2`` and ``scales =
mean|r|``, in padded list buckets (n_lists, max_list, ...) with ids -1
on pad slots. The raw f32 vectors stay on the host (``keep_raw``) for
the exact re-rank.

Build = balanced k-means on a subsample, nearest-centre labels (the
``fused_l2_nn`` kernel), the rotation (full f32: the sign is the code),
sign packing, bucketing; no codebook. Search = coarse GEMM +
``select_k`` kernel, probe inversion, then the fused BQ scan kernel
(``kk = rescore_factor * k <= 256``) or the unfused one + the IP centre
term + the candidate merge (``kk > 256``), and the epilogue: estimator
slice or exact re-rank of the kk survivors on the device or the host.

The estimator (see ``ops.ivf_bq_scan``): ``|q_l|^2 + |r|^2 - 2 s
<q_l, sign(r)>`` with ``q_l = rot q - rot c_l`` (L2), ``-(q.c_l + s
<rot q, sign(r)>)`` (IP); cosine rides the IP core on row-normalized
vectors. Metrics: L2Expanded, L2SqrtExpanded, InnerProduct,
CosineExpanded.

:func:`extend` adds rows with the centres and rotation frozen.
``kmeans_kernel_precision`` reaches the k-means trainer. The rotation is
the port's ``ivf_pq.make_rotation_matrix`` (QR of a numpy-seeded
gaussian), not the JAX package's ``jax.random`` draw; an index built by
either package searches the same in both (``index_from_numpy``,
``serialize.load_ivf_bq``).
"""

from __future__ import annotations

import os
import threading
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
from raft_tpu_torch.neighbors import _ivf_scan, ivf_flat
from raft_tpu_torch.neighbors.ann_types import (MAX_QUERY_BATCH,
                                                batched_search)
from raft_tpu_torch.ops import ivf_bq_scan as bq_op
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.util.host_sample import sample_rows, take_rows

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct, DistanceType.CosineExpanded)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_RAW_DEV_LOCK = threading.Lock()

# rows per block of the build's encoding pass
_ROWS = 1 << 20


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 10          # coarse only; there is no codebook
    kmeans_trainset_fraction: float = 0.5
    # the trainer's fused L2-NN tier: None / "highest" (f32) only
    kmeans_kernel_precision: object = None
    # keep the raw f32 vectors on the host for the exact re-rank
    keep_raw: bool = True


@dataclass
class SearchParams:
    """``rescore_factor``: kk = factor * k estimator candidates
    re-ranked exactly against the raw vectors (0 = estimator distances).
    ``probe_cap``: as for IVF-Flat. ``scan_bins``: 0 = auto, ``min(max(
    128, 32 * kk // n_probes), max_list)`` strided bins per list.
    ``rescore_on_device``: "auto" | "always" | "never" places the
    re-rank (see :func:`resolve_raw_device`)."""

    n_probes: int = 20
    rescore_factor: int = 8
    probe_cap: int = 0
    scan_bins: int = 0
    rescore_on_device: str = "auto"


@dataclass
class Index:
    centers: torch.Tensor          # (n_lists, dim) f32
    centers_rot: torch.Tensor      # (n_lists, dim) f32, rot @ centers
    rotation_matrix: torch.Tensor  # (dim, dim) orthogonal
    bits: torch.Tensor             # (n_lists, max_list, words) int32
    norms2: torch.Tensor           # (n_lists, max_list) f32 |r|^2
    scales: torch.Tensor           # (n_lists, max_list) f32 mean|r|
    lists_indices: torch.Tensor    # (n_lists, max_list) int32, -1 = pad
    list_sizes: torch.Tensor       # (n_lists,) int32
    metric: DistanceType
    size: int
    # raw f32 vectors on the host (keep_raw builds), indexed by id
    raw: Optional[np.ndarray] = None
    cap_cache: dict = field(default_factory=dict, repr=False, compare=False)
    plan_cache: dict = field(default_factory=dict, repr=False,
                             compare=False)
    # lazy device copy of ``raw`` (rescore_on_device); not serialized
    raw_dev: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def words(self) -> int:
        return self.bits.shape[2]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def _pack_bits(r: torch.Tensor) -> torch.Tensor:
    """Sign bits of (n, d) → (n, ceil(d/32)) int32 bit patterns: bit i of
    word w is ``r[:, 32w + i] >= 0`` (bit 31 makes the word negative)."""
    n, d = r.shape
    b = (r >= 0).to(torch.int64)
    pad = (-d) % 32
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    shifts = torch.arange(32, dtype=torch.int64, device=r.device)
    words = (b.reshape(n, -1, 32) << shifts).sum(dim=2)     # [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


# (..., w) int32 → (..., d) f32 +-1, the decode tile
_unpack_pm1 = bq_op.unpack_pm1


def _encode_payload(x, centers, labels, rot):
    """Rotated residuals → the per-row int32 payload ``[words, norms2,
    scales]`` (the f32 columns as bit patterns) and the rotated centres.
    Full f32 rotation (no TF32): the sign is the code, and a rounded
    product flips the signs of near-zero components. In row blocks."""
    full_fp32_matmul()
    n, d = x.shape
    w = -(-d // 32)
    payload = torch.empty((n, w + 2), dtype=torch.int32, device=x.device)
    for s in range(0, n, _ROWS):
        lab = labels[s:s + _ROWS].long()
        r = (x[s:s + _ROWS] - centers[lab]) @ rot.T
        payload[s:s + _ROWS, :w] = _pack_bits(r)
        payload[s:s + _ROWS, w] = (r * r).sum(dim=1).view(torch.int32)
        payload[s:s + _ROWS, w + 1] = r.abs().mean(dim=1).view(torch.int32)
    return payload, centers @ rot.T


def _split_payload(bucketed: torch.Tensor, w: int):
    """Bucketed (n_lists, max_list, w + 2) int32 payload → (bits int32,
    norms2 f32, scales f32)."""
    return (bucketed[:, :, :w].contiguous(),
            bucketed[:, :, w].contiguous().view(torch.float32),
            bucketed[:, :, w + 1].contiguous().view(torch.float32))


def build(dataset, params: IndexParams = IndexParams(), res=None,
          device=None) -> Index:
    """Train + encode on ``device`` (default ``cuda``; ``"cpu"`` only
    when asked): balanced k-means coarse centres, the random rotation,
    sign-packed rotated residuals, bucketing. Cosine datasets are
    row-normalized at build (``raw`` keeps the normalized rows)."""
    from raft_tpu_torch.neighbors.ivf_pq import make_rotation_matrix
    res = ensure_resources(res, device)
    full_fp32_matmul()
    x = torch.as_tensor(dataset, dtype=torch.float32).to(res.device)
    n, d = x.shape
    expects(params.n_lists <= n, "ivf_bq.build: n_lists > n_samples")
    expects(params.metric in _METRICS, "ivf_bq: unsupported metric %s",
            params.metric)
    if params.metric == DistanceType.CosineExpanded:
        x = ivf_flat._normalize_rows(x)
    obs.counter("raft.ivf_bq.build.total").inc()
    obs.counter("raft.ivf_bq.build.rows").inc(n)
    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = (take_rows(x, sample_rows(n, n_train, 0, x.device))
                if n_train < n else x)
    centers = kmeans_balanced.build_hierarchical(
        trainset, params.n_lists, params.kmeans_n_iters,
        kernel_precision=params.kmeans_kernel_precision)
    del trainset
    labels = kmeans_balanced.predict(x, centers)
    rot = make_rotation_matrix(d, d, force_random=True, device=x.device)
    payload, centers_rot = _encode_payload(x, centers, labels, rot)
    bucketed, idx, _, counts = ivf_flat._bucketize(
        payload, labels, params.n_lists, compute_norms=False)
    del payload
    bits, norms2, scales = _split_payload(bucketed, -(-d // 32))
    return Index(centers=centers, centers_rot=centers_rot,
                 rotation_matrix=rot, bits=bits, norms2=norms2,
                 scales=scales, lists_indices=idx, list_sizes=counts,
                 metric=params.metric, size=n,
                 raw=x.cpu().numpy() if params.keep_raw else None)


def index_from_numpy(arrays: dict, metric, size: int, raw=None,
                     device="cuda") -> Index:
    """An :class:`Index` on ``device`` from numpy arrays of the JAX
    package's ``ivf_bq.Index`` fields (``centers``, ``centers_rot``,
    ``rotation_matrix``, ``bits`` (uint32), ``norms2``, ``scales``,
    ``lists_indices``, ``list_sizes``), with the optional host ``raw``
    corpus. The bits keep their bit patterns as int32."""
    dev = ensure_resources(None, device).device

    def put(name, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(arrays[name], dtype=dtype)).to(dev)

    bits = np.ascontiguousarray(arrays["bits"])
    expects(bits.dtype in (np.uint32, np.int32),
            "ivf_bq.index_from_numpy: bits must be uint32, got %s",
            bits.dtype)
    return Index(centers=put("centers", np.float32),
                 centers_rot=put("centers_rot", np.float32),
                 rotation_matrix=put("rotation_matrix", np.float32),
                 bits=torch.from_numpy(bits.view(np.int32)).to(dev),
                 norms2=put("norms2", np.float32),
                 scales=put("scales", np.float32),
                 lists_indices=put("lists_indices", np.int32),
                 list_sizes=put("list_sizes", np.int32),
                 metric=DistanceType(int(metric)), size=int(size),
                 raw=(np.ascontiguousarray(raw, np.float32)
                      if raw is not None else None))


def extend(index: Index, new_vectors, new_indices=None,
           res=None) -> Index:
    """A new index holding ``index``'s rows and ``new_vectors`` (ids
    ``new_indices``, default ``size .. size + n_new``), on the index's
    device: new rows (normalized for cosine) labelled with the frozen
    centres (``kmeans_balanced.predict``) and sign-encoded with the
    frozen rotation; old payloads are moved, never encoded again, and old
    and new are bucketed again. Custom ids only without ``raw`` (the exact
    re-rank reads ``raw`` by id); new rows are appended to ``raw``."""
    ensure_resources(res, index.device)
    full_fp32_matmul()
    dev = index.device
    x = torch.as_tensor(new_vectors, dtype=torch.float32).to(dev)
    expects(x.dim() == 2 and x.shape[1] == index.dim,
            "ivf_bq.extend: dim mismatch")
    if index.metric == DistanceType.CosineExpanded:
        x = ivf_flat._normalize_rows(x)
    n_new = x.shape[0]
    new_ids = (torch.arange(index.size, index.size + n_new,
                            dtype=torch.int32, device=dev)
               if new_indices is None
               else torch.as_tensor(new_indices).to(dev, torch.int32))
    expects(tuple(new_ids.shape) == (n_new,),
            "ivf_bq.extend: bad new_indices")
    expects(bool((new_ids >= 0).all()),
            "ivf_bq.extend: new_indices must be non-negative")
    expects(index.raw is None or new_indices is None,
            "ivf_bq.extend: custom new_indices are only supported on "
            "keep_raw=False indexes (raw rescore rows are id-indexed)")
    n_lists, ml, w = index.bits.shape
    valid = (index.lists_indices >= 0).reshape(-1)
    old_labels = torch.arange(n_lists, dtype=torch.int32,
                              device=dev).repeat_interleave(ml)[valid]
    old_payload = torch.cat(
        [index.bits.reshape(-1, w)[valid],
         index.norms2.reshape(-1)[valid].view(torch.int32)[:, None],
         index.scales.reshape(-1)[valid].view(torch.int32)[:, None]], dim=1)
    labels = kmeans_balanced.predict(x, index.centers)
    new_payload, _ = _encode_payload(x, index.centers, labels,
                                     index.rotation_matrix)
    bucketed, idx, _, counts = ivf_flat._bucketize(
        torch.cat([old_payload, new_payload]),
        torch.cat([old_labels, labels]), n_lists,
        row_ids=torch.cat([index.lists_indices.reshape(-1)[valid], new_ids]),
        compute_norms=False)
    del old_payload, new_payload
    bits, norms2, scales = _split_payload(bucketed, w)
    return Index(centers=index.centers, centers_rot=index.centers_rot,
                 rotation_matrix=index.rotation_matrix, bits=bits,
                 norms2=norms2, scales=scales, lists_indices=idx,
                 list_sizes=counts, metric=index.metric,
                 size=index.size + n_new,
                 raw=(np.concatenate([index.raw, x.cpu().numpy()])
                      if index.raw is not None else None))


def _exact_rescore_device(raw_dev: torch.Tensor, q: torch.Tensor,
                          ids: torch.Tensor, k: int, kind: str):
    """Exact re-rank of the kk estimator survivors where ``raw_dev``
    lives: gather by global id, f32 scores (squared L2, or the negated
    dot product), the k smallest with ties to the lower column."""
    cand = raw_dev[torch.clamp(ids, min=0).long()]          # (nq, kk, d)
    qf = q.float()
    if kind == "ip":
        ex = -torch.einsum("qkd,qd->qk", cand, qf)
    else:
        diff = cand - qf[:, None, :]
        ex = (diff * diff).sum(dim=2)
    ex = torch.where(ids >= 0, ex, torch.full_like(ex, float("inf")))
    vals, sel = stable_topk_min(ex, k)
    return vals, torch.gather(ids, 1, sel)


def resolve_raw_device(index, mode: str) -> Optional[torch.Tensor]:
    """Device copy of ``index.raw`` under the ``rescore_on_device``
    policy ("auto" | "always" | "never"), cached on the index; None
    means the host epilogue. "auto" keeps the re-rank on the host when
    the raw corpus exceeds ``RAFT_TPU_RESCORE_DEVICE_MB`` (default 4096)
    or the copy fails; "always" raises instead; "never" releases a
    cached copy."""
    expects(mode in ("auto", "always", "never"),
            "rescore_on_device: want auto|always|never, got %r", mode)
    if mode == "never" or index.raw is None:
        index.raw_dev = None
        return None
    if mode == "auto":
        budget_mb = int(os.environ.get("RAFT_TPU_RESCORE_DEVICE_MB", "4096"))
        if index.raw.nbytes > budget_mb << 20:
            return None
    with _RAW_DEV_LOCK:
        if (index.raw_dev is None
                or tuple(index.raw_dev.shape) != index.raw.shape):
            try:
                index.raw_dev = torch.from_numpy(np.ascontiguousarray(
                    index.raw, dtype=np.float32)).to(index.device)
            except RuntimeError:      # device memory full
                if mode == "always":
                    raise
                return None
        return index.raw_dev


def finish_search(d_est, ids, raw, q, k: int,
                  metric: DistanceType = DistanceType.L2Expanded,
                  rescore: bool = False, raw_dev=None):
    """Slice the estimator top-k, or re-rank the kk survivors exactly
    (on the device with ``raw_dev``, else against the host ``raw``).
    Scores come in smaller-is-better; the IVF-Flat output conventions
    are applied last (IP → similarities, L2Sqrt → euclidean)."""
    kind = ivf_flat._metric_kind(metric)
    sqrt = metric in _SQRT_METRICS
    if not rescore:
        d_out, i_out = d_est[:, :k], ids[:, :k]
    elif raw_dev is not None:
        ex, i_out = _exact_rescore_device(raw_dev, q, ids, k, kind)
        fin = torch.isfinite(ex)
        i_out = torch.where(fin, i_out, torch.full_like(i_out, -1))
        d_out = torch.where(fin, ex, torch.full_like(ex, float("inf")))
    else:
        # host epilogue: numpy on the host copy, as the JAX package does
        ids_h = ids.detach().cpu().numpy()
        qh = q.detach().cpu().numpy()
        cand = raw[np.maximum(ids_h, 0)]                     # (nq, kk, d)
        if kind == "ip":
            ex = -np.einsum("qkd,qd->qk", cand, qh)
        else:
            diff = cand - qh[:, None, :]
            ex = np.einsum("qkd,qkd->qk", diff, diff)
        ex = np.where(ids_h >= 0, ex, np.inf)
        order = np.argsort(ex, axis=1)[:, :k]
        dh = np.take_along_axis(ex, order, axis=1)
        ih = np.take_along_axis(ids_h, order, axis=1)
        ih = np.where(np.isfinite(dh), ih, -1)
        d_out = torch.from_numpy(np.ascontiguousarray(dh, np.float32)).to(
            q.device)
        i_out = torch.from_numpy(np.ascontiguousarray(ih, np.int32)).to(
            q.device)
    if sqrt:
        d_out = torch.sqrt(torch.clamp(d_out, min=0.0))
    return ivf_flat._postprocess(d_out, metric), i_out


def _check_params(params: SearchParams) -> None:
    expects(params.scan_bins >= 0,
            "ivf_bq.search: scan_bins must be >= 0 (0 = auto), got %d",
            params.scan_bins)
    expects(params.rescore_factor >= 0,
            "ivf_bq.search: rescore_factor must be >= 0, got %d",
            params.rescore_factor)
    expects(params.rescore_on_device in ("auto", "always", "never"),
            "ivf_bq.search: rescore_on_device: want auto|always|never, "
            "got %r", params.rescore_on_device)


def bq_scan(q_rot, centers_rot, bits, norms2, scales, ids, probes, kk: int,
            cap: int, bins: int, kind: str, fused: bool):
    """The fine phase over the bits (counterpart of the JAX package's
    ``ivf_bq_scan_pallas``): probe inversion, then the fused scan
    kernel, or the unfused one + the IP centre term + the candidate
    merge → kk (dists, ids), best first, smaller-is-better. ``bins``
    resolved (>= 1)."""
    qmap, inv_pos = _ivf_scan._invert_probes(probes, ids.shape[0], cap)
    args = (q_rot, centers_rot, bits, norms2, scales, ids)
    if fused:
        return bq_op.bq_scan_fused(*args, probes, inv_pos, qmap, cap, kk,
                                   bins, metric=kind)
    cd, ci = bq_op.bq_scan(*args, qmap, bins, metric=kind)
    if kind == "ip":
        # the kernel scored -s<q, sign(r)>; add the centre term -q.c_l
        full_fp32_matmul()
        qc = (q_rot @ centers_rot.T).T                      # (L, nq)
        corr = torch.gather(qc, 1, qmap.clamp(min=0).long())
        cd = cd - corr[:, :, None]
    return _ivf_scan.merge_candidates(cd, ci, probes, inv_pos, kk, False,
                                      cap=cap)


class _Route:
    """What one (index, k, params) point resolves to: the kk estimator
    depth, bins and whether the fused kernel takes it. It holds the
    index's arrays, never the index (see ``ivf_pq._Route``)."""

    def __init__(self, index: Index, k: int, params: SearchParams):
        _check_params(params)
        self.centers, self.centers_rot = index.centers, index.centers_rot
        self.rotation_matrix = index.rotation_matrix
        self.bits, self.norms2 = index.bits, index.norms2
        self.scales, self.ids = index.scales, index.lists_indices
        self.metric, self.raw = index.metric, index.raw
        self.k = k
        self.n_probes = min(params.n_probes, index.n_lists)
        self.kind = ivf_flat._metric_kind(index.metric)
        self.cosine = index.metric == DistanceType.CosineExpanded
        self.rescoring = params.rescore_factor > 0 and index.raw is not None
        self.kk = max(params.rescore_factor, 1) * k
        # a 32x-oversampled candidate pool spread over the probed lists,
        # floor 128 bins per list; exact when it reaches max_list
        self.bins = min(params.scan_bins
                        or max(128, (32 * self.kk) // max(self.n_probes, 1)),
                        index.bits.shape[1])
        self.fused = self.kk <= bq_op.MAX_K

    def device_phase(self, q: torch.Tensor, cap: int):
        """Coarse probes, query rotation and the bit scan → kk estimator
        candidates (dists, ids), best first. ``q`` already normalized
        for cosine."""
        full_fp32_matmul()
        probes = _ivf_scan.coarse_probes(q, self.centers, self.n_probes,
                                         kind=self.kind)
        q_rot = (q @ self.rotation_matrix.T).contiguous()
        return bq_scan(q_rot, self.centers_rot, self.bits, self.norms2,
                       self.scales, self.ids, probes, self.kk, cap,
                       self.bins, self.kind, self.fused)

    def epilogue(self, d, i, q, raw_dev):
        """Estimator slice or exact re-rank (on the device with
        ``raw_dev``, else on the host), then the output conventions."""
        return finish_search(d, i, self.raw, q, self.k, metric=self.metric,
                             rescore=self.rescoring, raw_dev=raw_dev)


def search(index: Index, queries, k: int,
           params: SearchParams = SearchParams(), res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimator scan on the device + exact re-rank → (dists (nq, k)
    f32, ids (nq, k) int32) on the index's device. When rescoring the
    distances are exact; in the IVF-Flat output conventions either way
    (squared L2 ascending, euclidean for L2Sqrt, IP similarities
    descending, 1 - cos for cosine)."""
    ensure_resources(res, index.device)
    full_fp32_matmul()
    q = torch.as_tensor(queries, dtype=torch.float32).to(
        index.device).contiguous()
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "ivf_bq.search: dim mismatch")
    route = _Route(index, k, params)
    if q.shape[0] > MAX_QUERY_BATCH:
        return batched_search(lambda qb: search(index, qb, k, params), q,
                              max_batch=MAX_QUERY_BATCH)
    obs.counter("raft.ivf_bq.search.queries").inc(q.shape[0])
    if route.cosine:
        q = ivf_flat._normalize_rows(q)
    cap = _ivf_scan.resolve_cap(index.cap_cache, q, index.centers, params,
                                route.n_probes, index.n_lists,
                                kind=route.kind)
    if route.fused:
        obs.counter("raft.ivf_scan.fused.total", family="ivf_bq").inc()
        obs.counter("raft.ivf_scan.fused.queries").inc(q.shape[0])
    d, i = route.device_phase(q, cap)
    raw_dev = (resolve_raw_device(index, params.rescore_on_device)
               if route.rescoring else None)
    return route.epilogue(d, i, q, raw_dev)

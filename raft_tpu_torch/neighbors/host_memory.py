"""Host-memory-resident IVF-Flat (counterpart of
``raft_tpu.neighbors.host_memory``).

Indexes larger than device memory keep their inverted lists in host RAM
(numpy) while the coarse centres stay on the device; per search batch,
only the UNION OF PROBED LISTS is moved to the device, once, in a
power-of-two bucket of lists, and scored by the same probe-major fine
phase as the resident index (``ivf_flat._score_probe`` through
``_ivf_scan.probe_scan``). So the device holds O(probed) bytes, never
O(n), and a search gives the same answer as the resident probe-order
search at the same ``(nq, k, n_probes)``.

The coarse top-``n_probes`` runs kernel 2 (``ops.select_k``, ties to the
lower column, as the resident route's stable sort) for ``n_probes <=
256``. :func:`build` and :func:`build_streaming` never hold the dataset
or the lists on the device: the centres train on a bounded subsample,
then each chunk is labelled by kernel 1 (``kmeans_balanced._nn``) and
the lists are assembled on the host, so device memory stays
O(chunk + train_rows + n_lists * dim).

List rows are float32, int8 (dequantized by ``scale``) or bfloat16,
which numpy lacks: bfloat16 rows live on the host as their uint16 bit
patterns (as the serialized format stores them) and are viewed as
``torch.bfloat16`` on the device. Every host-to-device transfer goes
through :func:`_fetch`. Entry points run on the device of the index's
centres (``build``: ``device``, default ``cuda``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan
from raft_tpu_torch.neighbors.ivf_flat import (
    Index,
    IndexParams,
    SearchParams,
    _SQRT_METRICS,
    _metric_kind,
    _normalize_rows,
    _postprocess,
    _score_probe,
)
from raft_tpu_torch.obs import spans
from raft_tpu_torch.util.host import host_array


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the host array ``a`` (no copy); uint16 bit
    patterns are bfloat16 rows."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The host numpy form of a tensor: bfloat16 as uint16 bit
    patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _fetch(a: np.ndarray, device) -> torch.Tensor:
    """Host→device transfer point (module-local so tests can observe
    fetch sizes). Both directions of the host-memory contract route
    through here: list fetches at search AND chunk ingestion at the
    streaming build, so a test asserting peak device allocation hooks
    ONE symbol. On the CPU the tensor shares ``a``'s memory."""
    return _host_tensor(np.ascontiguousarray(a)).to(device)


def _host_rows(dataset) -> np.ndarray:
    """A dataset (numpy, a sequence or a tensor on any device) as a
    contiguous float32 host array."""
    return np.ascontiguousarray(host_array(dataset, np.float32))


def _place_chunk(n_lists: int, cursor, chunk, labels, id_base: int,
                 lists_data, lists_idx, lists_norms=None, row_norms=None):
    """Place one host chunk's rows into their list slots (per-list write
    cursors) — the shared host-side assembly step of :func:`build` and
    :func:`build_streaming`. ``row_norms`` (when given) land in
    ``lists_norms`` alongside the rows."""
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(n_lists + 1))
    for l in range(n_lists):
        rows = order[bounds[l]:bounds[l + 1]]
        if rows.size:
            c = cursor[l]
            lists_data[l, c:c + rows.size] = chunk[rows]
            lists_idx[l, c:c + rows.size] = (id_base + rows)
            if lists_norms is not None:
                lists_norms[l, c:c + rows.size] = row_norms[rows]
            cursor[l] += rows.size


@dataclass
class HostIvfFlat:
    """IVF-Flat index with device-resident centres and host-resident
    lists. Build normally, then :func:`to_host`; or :func:`build` /
    :func:`build_streaming` straight into host memory."""

    centers: torch.Tensor           # (n_lists, dim) — stays on device
    lists_data: np.ndarray          # (n_lists, max_list, dim) host
    lists_norms: np.ndarray         # (n_lists, max_list) host
    lists_indices: np.ndarray       # (n_lists, max_list) host
    metric: DistanceType
    size: int
    scale: float = 1.0

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def to_host(index: Index) -> HostIvfFlat:
    """Demote an IVF-Flat index's lists to host memory (the device keeps
    only the coarse centres, O(n_lists * dim)). For datasets that never
    fit the device, use :func:`build` instead."""
    return HostIvfFlat(
        centers=index.centers,
        lists_data=_host_array(index.lists_data),
        lists_norms=_host_array(index.lists_norms),
        lists_indices=_host_array(index.lists_indices),
        metric=index.metric, size=index.size, scale=index.scale)


def build(dataset, params: IndexParams = IndexParams(),
          chunk_rows: int = 1 << 20, train_rows: int = 1 << 18,
          seed: int = 0, res=None, device=None) -> HostIvfFlat:
    """Build a host-resident index WITHOUT materializing the dataset (or
    the lists) on the device — the construction path for indexes larger
    than device memory.

    The coarse centres train on a ``train_rows`` subsample on the device;
    then the dataset streams through it in ``chunk_rows`` slices (labels
    by kernel 1 per chunk, O(chunk) device memory), while the inverted
    lists assemble on the host in numpy. Labelling shares the same
    ``predict`` as the resident build, so with equal centres the list
    membership is identical."""
    from raft_tpu_torch.cluster import kmeans_balanced
    res = ensure_resources(res, device)
    dev = res.device
    full_fp32_matmul()
    x = _host_rows(dataset)
    n, dim = x.shape
    expects(params.n_lists <= n, "host ivf build: n_lists > n_samples")

    rng = np.random.default_rng(seed)
    t_rows = min(n, train_rows)
    sub = x[rng.choice(n, t_rows, replace=False)] if t_rows < n else x
    centers = kmeans_balanced.build_hierarchical(
        _fetch(sub, dev), params.n_lists, params.kmeans_n_iters,
        kernel_precision=params.kmeans_kernel_precision, res=res)

    # pass 1: labels only (n·4 bytes of bookkeeping) — keeps peak host
    # memory at dataset + padded lists, not 3× the dataset
    labels_all = np.empty(n, np.int32)
    for start in range(0, n, chunk_rows):
        chunk = x[start:start + chunk_rows]
        labels_all[start:start + chunk.shape[0]] = kmeans_balanced.predict(
            _fetch(chunk, dev), centers, res=res).cpu().numpy()

    counts = np.bincount(labels_all, minlength=params.n_lists)
    max_list = max(8, int(-(-int(counts.max()) // 8) * 8))
    lists_data = np.zeros((params.n_lists, max_list, dim), np.float32)
    lists_idx = np.full((params.n_lists, max_list), -1, np.int32)

    # pass 2: place rows directly into their list slots (per-list write
    # cursors), chunk by chunk — no intermediate per-list copies
    cursor = np.zeros(params.n_lists, np.int64)
    for start in range(0, n, chunk_rows):
        chunk = x[start:start + chunk_rows]
        labels = labels_all[start:start + chunk.shape[0]]
        _place_chunk(params.n_lists, cursor, chunk, labels, start,
                     lists_data, lists_idx)

    # norms in list blocks: O(block·max_list·dim) f64 temporaries only
    norms = np.empty((params.n_lists, max_list), np.float32)
    blk = 64
    for l0 in range(0, params.n_lists, blk):
        seg = lists_data[l0:l0 + blk].astype(np.float64)
        norms[l0:l0 + blk] = (seg * seg).sum(-1).astype(np.float32)
    return HostIvfFlat(centers=centers, lists_data=lists_data,
                       lists_norms=norms, lists_indices=lists_idx,
                       metric=params.metric, size=n, scale=1.0)


def _label_norm(chunk: torch.Tensor, centers: torch.Tensor):
    """One chunk's nearest-centre labels (kernel 1 on the card) and row
    norms, on the chunk's device."""
    from raft_tpu_torch.cluster.kmeans_balanced import _nn
    labels, _ = _nn(chunk, centers)
    return labels.to(torch.int32), (chunk * chunk).sum(dim=1)


def build_streaming(chunks, params: IndexParams = IndexParams(),
                    train_rows: int = 1 << 18, seed: int = 0,
                    res=None, device=None) -> HostIvfFlat:
    """Build a host-resident IVF-Flat index from an ITERATOR of host
    chunks — the ingestion path for corpora that never fit the device.

    Peak device allocation is O(chunk + train_rows + n_lists * dim): the
    coarse centres train on a bounded subsample drawn across the whole
    stream, then every chunk is moved to the device, labelled (kernel 1)
    and normed, and both come back to the host before the next chunk
    moves, while the inverted lists assemble on the host. Chunks are
    buffered host-side (numpy): host RAM bounds the corpus, device memory
    never does. Every host→device transfer goes through :func:`_fetch`.

    Parity: labelling shares ``kmeans_balanced`` with the resident build,
    so with ``train_rows >= n`` the trainer sees the whole stream in
    order."""
    from raft_tpu_torch.cluster import kmeans_balanced
    res = ensure_resources(res, device)
    dev = res.device
    full_fp32_matmul()

    chunk_list = []
    for c in chunks:
        c = _host_rows(c)
        expects(c.ndim == 2, "build_streaming: chunks must be 2-D")
        if chunk_list:
            expects(c.shape[1] == chunk_list[0].shape[1],
                    "build_streaming: chunk dim mismatch (%d vs %d)",
                    c.shape[1], chunk_list[0].shape[1])
        if params.metric == DistanceType.CosineExpanded:
            c = c / np.maximum(
                np.linalg.norm(c, axis=1, keepdims=True), 1e-30)
        chunk_list.append(c)
    expects(len(chunk_list) > 0, "build_streaming: empty chunk stream")
    n = sum(c.shape[0] for c in chunk_list)
    dim = chunk_list[0].shape[1]
    expects(params.n_lists <= n, "build_streaming: n_lists > n_samples")

    with spans.span("raft.build.streaming", rows=n,
                    chunks=len(chunk_list), n_lists=params.n_lists):
        obs.counter("raft.build.streaming.chunks").inc(len(chunk_list))
        obs.counter("raft.build.streaming.rows").inc(n)

        # bounded trainset drawn across the whole stream (host-side
        # draw, row order preserved: train_rows >= n degenerates to the
        # whole stream in order)
        t_rows = min(n, train_rows)
        if t_rows < n:
            rng = np.random.default_rng(seed)
            sel = np.sort(rng.choice(n, t_rows, replace=False))
        else:
            sel = np.arange(n)
        train = np.empty((t_rows, dim), np.float32)
        off = pos = 0
        for c in chunk_list:
            hit = sel[(sel >= off) & (sel < off + c.shape[0])] - off
            train[pos:pos + hit.size] = c[hit]
            pos += hit.size
            off += c.shape[0]
        with obs.timed("raft.build.streaming.train"):
            centers = kmeans_balanced.build_hierarchical(
                _fetch(train, dev), params.n_lists, params.kmeans_n_iters,
                kernel_precision=params.kmeans_kernel_precision, res=res)
        del train

        # pass 1 over the stream: one label + norm step per chunk, the
        # results landing host-side at once (O(chunk) device memory)
        labels_h, norms_h = [], []
        with obs.timed("raft.build.streaming.label"):
            for c in chunk_list:
                lbl, nrm = _label_norm(_fetch(c, dev), centers)
                labels_h.append(lbl.cpu().numpy())
                norms_h.append(nrm.cpu().numpy())
                del lbl, nrm

        counts = np.zeros(params.n_lists, np.int64)
        for lbl in labels_h:
            counts += np.bincount(lbl, minlength=params.n_lists)
        max_list = max(8, int(-(-int(counts.max()) // 8) * 8))
        lists_data = np.zeros((params.n_lists, max_list, dim),
                              np.float32)
        lists_idx = np.full((params.n_lists, max_list), -1, np.int32)
        lists_norms = np.zeros((params.n_lists, max_list), np.float32)

        # pass 2: host-side placement, chunk by chunk (no device work)
        cursor = np.zeros(params.n_lists, np.int64)
        base = 0
        for c, lbl, nrm in zip(chunk_list, labels_h, norms_h):
            _place_chunk(params.n_lists, cursor, c, lbl, base,
                         lists_data, lists_idx, lists_norms, nrm)
            base += c.shape[0]
    return HostIvfFlat(centers=centers, lists_data=lists_data,
                       lists_norms=lists_norms, lists_indices=lists_idx,
                       metric=params.metric, size=n, scale=1.0)


def _probe_scan(queries, sub_data, sub_norms, sub_indices, probe_pos,
                scale, k: int, sqrt: bool, kind: str):
    """The shared probe-major fine phase over fetched (or tiered)
    sub-lists: ``probe_pos`` (nq, n_probes) indexes ``sub_*``'s first
    axis, rank by rank (``_ivf_scan.probe_scan`` over
    ``ivf_flat._score_probe``)."""
    qq = (queries * queries).sum(dim=1)
    return _ivf_scan.probe_scan(
        probe_pos, k, sqrt,
        lambda pos: _score_probe(queries, qq, sub_data, sub_norms,
                                 sub_indices, pos, kind, scale))


def _padded_take(src: np.ndarray, ids: np.ndarray, rows: int,
                 fill) -> np.ndarray:
    """``src[ids]`` in a new array of ``rows`` lists, the slots past
    ``len(ids)`` holding ``fill`` (one copy of the taken lists)."""
    out = np.empty((rows,) + src.shape[1:], src.dtype)
    np.take(src, ids, axis=0, out=out[:len(ids)])
    out[len(ids):] = fill
    return out


def search(index: HostIvfFlat, queries, k: int,
           params: SearchParams = SearchParams(), res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a host-resident index: coarse phase on the device (kernel
    2), fetch the union of probed lists host→device, fine phase on the
    device (the probe-major route with probe ids remapped into the
    union) → (dists, ids) on the centres' device.

    Peak device memory per batch: ``pow2_ceil(n_unique_probed) *
    max_list * dim`` list elements (the pow2 ceiling — up to 2x the
    unique count — buckets the shapes; pad slots transfer zeros with
    -1 ids), bounded by the probe working set, never by the database.
    Query sets above ``MAX_QUERY_BATCH`` are batched, each batch fetching
    its own union."""
    from raft_tpu_torch.neighbors.ann_types import (MAX_QUERY_BATCH,
                                                    batched_search)
    dev = index.device
    ensure_resources(res, dev)
    full_fp32_matmul()
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev).contiguous()
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "host ivf search: dim mismatch")
    if q.shape[0] > MAX_QUERY_BATCH:
        return batched_search(
            lambda qb: search(index, qb, k, params, res=res), q,
            max_batch=MAX_QUERY_BATCH)
    n_probes = min(params.n_probes, index.n_lists)
    kind = _metric_kind(index.metric)
    sqrt = index.metric in _SQRT_METRICS
    if index.metric == DistanceType.CosineExpanded:
        q = _normalize_rows(q)

    # coarse phase on device (centres are resident), then the one sync
    probes = _ivf_scan.coarse_probes(q, index.centers, n_probes, kind=kind)
    probes_np = probes.cpu().numpy()
    _ivf_scan.note_probes(probes_np)   # hotness export

    # host side: union of probed lists, fetched once per batch; pad
    # slots (pow2 bucketing) transfer zeros with -1 ids, never real data
    uniq, inv = np.unique(probes_np, return_inverse=True)
    u = len(uniq)
    up = 1 << max(u - 1, 0).bit_length() if u else 1   # pow2 bucket
    sub_data = _fetch(_padded_take(index.lists_data, uniq, up, 0), dev)
    sub_norms = _fetch(_padded_take(index.lists_norms, uniq, up, 0), dev)
    sub_idx = _fetch(_padded_take(index.lists_indices, uniq, up, -1), dev)
    probe_pos = torch.from_numpy(
        inv.reshape(probes_np.shape).astype(np.int32)).to(dev)
    d, i = _probe_scan(q, sub_data, sub_norms, sub_idx, probe_pos,
                       index.scale, k, sqrt, kind)
    return _postprocess(d, index.metric), i

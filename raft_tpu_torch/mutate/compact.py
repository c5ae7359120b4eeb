"""Compaction: fold the delta segment and the tombstones into the main
lists (counterpart of ``raft_tpu.mutate.compact``).

Two modes (``MutateConfig.compact_mode``):

* **fold** (default) — the coarse centres stay FROZEN: tombstoned slots
  are purged (their ``lists_indices`` entries flip to -1, the pad
  sentinel every scan masks), then the live delta rows ride the family's
  ``extend`` (labelled against the trained centres by kernel 1, encoded
  with the frozen books or rotation, one re-bucketing of the combined
  set). No re-training: the steady-state mode.
* **rebuild** — re-train from scratch on the live corpus (IVF-Flat only:
  flat lists dequantize back to the rows) through ``ivf_flat.build``: the
  periodic centre refresh that bounds drift after many folds. With a
  host-streaming chunk budget (``stream_chunk > 0``,
  ``MutateConfig.rebuild_stream_chunk``) the rows go back to the host and
  the rebuild runs ``host_memory.build_streaming`` over chunks of that
  many rows (device memory O(chunk + 4 * chunk training rows)), and the
  host lists come back to the device as an ``ivf_flat.Index``. With a
  ``mesh`` it runs ``parallel.sharded_ivf_flat_build`` on the live rows
  and renumbers the ids block by block, so the next epoch's lists stay
  list-sharded (:class:`~raft_tpu_torch.parallel.mesh.Sharded`).

A list-sharded epoch folds block by block: :func:`purge` flips each
block's dead slots, :func:`reconstruct_rows` takes each block's live
rows, and the fold buckets old and new rows at the frozen centres, as
``ivf_flat.extend`` does, then shards the lists again over the same mesh
(views of one tensor where the ranks share a device).

Everything here runs on the compactor thread against a frozen snapshot;
tensors stay on the wrapped index's device. A purged index gets a fresh
``plan_cache``: a cached plan's closure holds the lists it was built
over, and its key does not name them, so a shared cache would serve the
old epoch's lists (deleted rows included) to a plan built on the purged
index. Its ``cap_cache`` is shared: a cap depends on the centres alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.parallel.mesh import Sharded

__all__ = ["fold", "purge", "reconstruct_rows"]


def _family(index) -> str:
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    if isinstance(index, ivf_flat.Index):
        return "ivf_flat"
    if isinstance(index, ivf_pq.Index):
        return "ivf_pq"
    if isinstance(index, ivf_bq.Index):
        return "ivf_bq"
    expects(False, "mutate: unsupported index type %s (want ivf_flat/"
            "ivf_pq/ivf_bq Index)", type(index).__name__)


def _blocks(t):
    """A tensor's blocks: a :class:`Sharded`'s, or the tensor alone."""
    return t.blocks if isinstance(t, Sharded) else [t]


def _like(t, blocks):
    """``blocks`` in ``t``'s layout (a :class:`Sharded` over its mesh
    axis, or the one tensor)."""
    return Sharded(blocks, t.mesh, t.axis) if isinstance(t, Sharded) \
        else blocks[0]


def purge(index, tombstoned_ids):
    """Drop tombstoned rows from the main lists WITHOUT re-bucketing:
    their ``lists_indices`` slots flip to -1 in place (holes inside a
    list; a list's live rows are not its first ``list_sizes`` rows) and
    the per-list sizes and logical size are refreshed → ``(index,
    n_removed)``; block by block on a list-sharded index. The new index
    shares every untouched tensor (the dead slots' payload is never
    scored) and starts an empty plan cache."""
    tombs = np.asarray(sorted(tombstoned_ids), dtype=np.int64)
    if tombs.size == 0:
        return index, 0
    tombs = torch.from_numpy(tombs[tombs < 2 ** 31])
    new_ids, sizes, n_removed = [], [], 0
    for ids in _blocks(index.lists_indices):
        dead = (ids >= 0) & torch.isin(ids, tombs.to(ids.device, ids.dtype))
        n_removed += int(dead.sum())
        new_ids.append(torch.where(dead, -1, ids))
        sizes.append((new_ids[-1] >= 0).sum(dim=1).to(torch.int32))
    if n_removed == 0:
        return index, 0
    return dataclasses.replace(
        index, lists_indices=_like(index.lists_indices, new_ids),
        list_sizes=_like(index.lists_indices, sizes),
        size=int(index.size) - n_removed, plan_cache={}), n_removed


def reconstruct_rows(index):
    """(rows (n, dim) f32, ids (n,) int32) of every live slot of an
    IVF-Flat index, dequantized, on the index's device: the rebuild
    corpus. Row order is list-major (the bucketing order; block by block
    on a list-sharded index, the same order), which a re-train
    ignores."""
    from raft_tpu_torch.neighbors import ivf_flat
    expects(isinstance(index, ivf_flat.Index),
            "mutate: rebuild compaction reconstructs rows from flat "
            "lists only — use compact_mode='fold' for ivf_pq/ivf_bq")
    dev = index.device
    rows, ids = [], []
    for data, idx in zip(_blocks(index.lists_data),
                         _blocks(index.lists_indices)):
        flat = idx.reshape(-1)
        valid = flat >= 0
        rows.append(ivf_flat._dequantize(
            data.reshape(-1, index.dim)[valid], index.scale).to(dev))
        ids.append(flat[valid].to(dev, torch.int32))
    return torch.cat(rows), torch.cat(ids)


def _extend_sharded(purged, rows, ids):
    """``ivf_flat.extend`` of a list-sharded IVF-Flat index, block by
    block: its live rows (:func:`reconstruct_rows`, never the padded
    lists gathered) and the new rows bucketed at the frozen centres, as
    ``extend`` buckets them, then the lists sharded again over the
    index's mesh axis."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.core.precision import full_fp32_matmul
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel.ivf import shard_ivf_flat
    expects(isinstance(purged, ivf_flat.Index),
            "mutate: a list-sharded epoch folds IVF-Flat lists only")
    full_fp32_matmul()
    if purged.metric == DistanceType.CosineExpanded:
        rows = ivf_flat._normalize_rows(rows)
    old_rows, old_ids = reconstruct_rows(purged)
    all_rows = torch.cat([old_rows, rows])
    del old_rows
    all_ids = torch.cat([old_ids, ids])
    centers = purged.centers.gather() if isinstance(
        purged.centers, Sharded) else purged.centers
    labels = kmeans_balanced.predict(all_rows, centers)
    data, idx, norms, counts = ivf_flat._bucketize(
        all_rows, labels, purged.n_lists, row_ids=all_ids)
    del all_rows, labels
    data, norms, scale = ivf_flat._quantize_lists(
        data, norms, ivf_flat._STORAGE_NAMES[purged.lists_data.dtype])
    sh = purged.lists_indices
    return shard_ivf_flat(ivf_flat.Index(
        centers=centers, lists_data=data, lists_indices=idx,
        lists_norms=norms, list_sizes=counts, metric=purged.metric,
        size=int(purged.size) + int(rows.shape[0]), scale=scale),
        sh.mesh, sh.axis)


def fold(index, delta_rows, delta_ids, tombstoned_ids,
         mode: str = "fold", mesh=None, axis: str = "data",
         stream_chunk: int = 0, params=None):
    """Produce the next epoch's index from the frozen snapshot: purge the
    tombstones, then absorb the live delta rows (numpy or tensors, moved
    to the index's device). See the module note for the two modes;
    ``mesh`` picks the sharded rebuild."""
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    fam = _family(index)
    dev = index.device
    delta_rows = torch.as_tensor(delta_rows, dtype=torch.float32).to(dev)
    delta_ids = torch.as_tensor(delta_ids).to(dev, torch.int32)
    expects(delta_rows.shape[0] == delta_ids.shape[0],
            "mutate.fold: %d rows vs %d ids", delta_rows.shape[0],
            delta_ids.shape[0])
    purged, _removed = purge(index, tombstoned_ids)
    if mode == "rebuild":
        return _rebuild(purged, delta_rows, delta_ids, mesh=mesh,
                        axis=axis, stream_chunk=stream_chunk,
                        params=params)
    expects(mode == "fold", "mutate.fold: unknown mode %r", mode)
    if delta_rows.shape[0] == 0:
        return purged
    if isinstance(purged.lists_indices, Sharded):
        return _extend_sharded(purged, delta_rows, delta_ids)
    ext = {"ivf_flat": ivf_flat.extend, "ivf_pq": ivf_pq.extend,
           "ivf_bq": ivf_bq.extend}[fam]
    return ext(purged, delta_rows, new_indices=delta_ids)


def _rebuild(purged, delta_rows, delta_ids, mesh=None,
             axis: str = "data", stream_chunk: int = 0, params=None):
    """From-scratch re-train on the live corpus (IVF-Flat only), the
    periodic centre refresh, on the purged index's device (list-sharded
    over ``mesh[axis]`` when a mesh is given)."""
    from raft_tpu_torch.neighbors import ivf_flat
    old_rows, old_ids = reconstruct_rows(purged)
    rows = torch.cat([old_rows, delta_rows])
    ids = torch.cat([old_ids, delta_ids])
    del old_rows
    if params is None:
        params = ivf_flat.IndexParams(
            n_lists=purged.n_lists, metric=purged.metric,
            kmeans_n_iters=10)
    if mesh is not None:
        # the sharded list-layout build lands in the list-sharded serving
        # layout; its 0..n-1 ids then take the mutable id space. It
        # hands each rank one contiguous block of rows, so the rows go in
        # id order: in list-major order a rank would hold whole lists,
        # and every rank's pre-exchange buckets would be as wide as the
        # widest list
        from raft_tpu_torch.parallel.ivf import sharded_ivf_flat_build
        order = torch.argsort(ids)
        rows, ids = rows[order], ids[order]
        del order
        built = sharded_ivf_flat_build(rows, params=params, mesh=mesh,
                                       axis=axis)
        del rows
        return _renumber(built, ids)
    if stream_chunk > 0:
        from raft_tpu_torch.neighbors.host_memory import build_streaming
        host_rows = rows.cpu().numpy()
        del rows

        def chunks():
            for s in range(0, host_rows.shape[0], stream_chunk):
                yield host_rows[s:s + stream_chunk]

        built = build_streaming(chunks(), params=params,
                                train_rows=min(host_rows.shape[0],
                                               4 * stream_chunk),
                                device=purged.device)
        built = _as_device_flat(built, purged.metric)
        return _renumber(built, ids)
    return _renumber(ivf_flat.build(rows, params, device=purged.device),
                     ids)


def _as_device_flat(host_index, metric):
    """A host-resident streaming build as an ``ivf_flat.Index`` on its
    centres' device (the rebuild path serves device-resident)."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.neighbors.host_memory import _fetch
    if isinstance(host_index, ivf_flat.Index):
        return host_index
    dev = host_index.device
    ids = _fetch(host_index.lists_indices, dev)
    return ivf_flat.Index(
        centers=host_index.centers,
        lists_data=_fetch(host_index.lists_data, dev),
        lists_indices=ids,
        lists_norms=_fetch(host_index.lists_norms, dev),
        list_sizes=(ids >= 0).sum(dim=1).to(torch.int32),
        metric=metric, size=int(host_index.size),
        scale=float(host_index.scale))


def _renumber(index, row_ids):
    """Rewrite a freshly built index's 0..n-1 slot ids to the mutable id
    space (``row_ids[slot]``), block by block when the lists are
    sharded; pads stay -1."""
    row_ids = torch.as_tensor(row_ids).to(torch.int32)
    out = [torch.where(lists >= 0,
                       row_ids.to(lists.device)[
                           torch.clamp(lists, min=0).long()], -1)
           for lists in _blocks(index.lists_indices)]
    return dataclasses.replace(
        index, lists_indices=_like(index.lists_indices, out), plan_cache={})

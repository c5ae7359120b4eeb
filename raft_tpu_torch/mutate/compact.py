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
  host lists come back to the device as an ``ivf_flat.Index``.

The JAX package's mesh rebuild (its sharded build, ROADMAP.md queue 1
item 6) raises ``NotImplementedError``.

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


def purge(index, tombstoned_ids):
    """Drop tombstoned rows from the main lists WITHOUT re-bucketing:
    their ``lists_indices`` slots flip to -1 in place (holes inside a
    list; a list's live rows are not its first ``list_sizes`` rows) and
    the per-list sizes and logical size are refreshed → ``(index,
    n_removed)``. The new index shares every untouched tensor (the dead
    slots' payload is never scored) and starts an empty plan cache."""
    tombs = np.asarray(sorted(tombstoned_ids), dtype=np.int64)
    if tombs.size == 0:
        return index, 0
    ids = index.lists_indices
    t = torch.from_numpy(tombs[tombs < 2 ** 31]).to(ids.device, ids.dtype)
    dead = (ids >= 0) & torch.isin(ids, t)
    n_removed = int(dead.sum())
    if n_removed == 0:
        return index, 0
    new_ids = torch.where(dead, -1, ids)
    sizes = (new_ids >= 0).sum(dim=1).to(torch.int32)
    return dataclasses.replace(
        index, lists_indices=new_ids, list_sizes=sizes,
        size=int(index.size) - n_removed, plan_cache={}), n_removed


def reconstruct_rows(index):
    """(rows (n, dim) f32, ids (n,) int32) of every live slot of an
    IVF-Flat index, dequantized, on the index's device: the rebuild
    corpus. Row order is list-major (the bucketing order), which a
    re-train ignores."""
    from raft_tpu_torch.neighbors import ivf_flat
    expects(isinstance(index, ivf_flat.Index),
            "mutate: rebuild compaction reconstructs rows from flat "
            "lists only — use compact_mode='fold' for ivf_pq/ivf_bq")
    ids = index.lists_indices.reshape(-1)
    valid = ids >= 0
    data = index.lists_data.reshape(-1, index.dim)[valid]
    return (ivf_flat._dequantize(data, index.scale),
            ids[valid].to(torch.int32))


def _mesh_not_ported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mutate: mesh-wide compaction (the sharded list-layout "
            "rebuild and the sharded serving view) is not ported yet "
            "(ROADMAP.md queue 1 item 6)")


def fold(index, delta_rows, delta_ids, tombstoned_ids,
         mode: str = "fold", mesh=None, axis: str = "data",
         stream_chunk: int = 0, params=None):
    """Produce the next epoch's index from the frozen snapshot: purge the
    tombstones, then absorb the live delta rows (numpy or tensors, moved
    to the index's device). See the module note for the two modes;
    ``mesh`` raises ``NotImplementedError``."""
    from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
    _mesh_not_ported(mesh)
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
    ext = {"ivf_flat": ivf_flat.extend, "ivf_pq": ivf_pq.extend,
           "ivf_bq": ivf_bq.extend}[fam]
    return ext(purged, delta_rows, new_indices=delta_ids)


def _rebuild(purged, delta_rows, delta_ids, mesh=None,
             axis: str = "data", stream_chunk: int = 0, params=None):
    """From-scratch re-train on the live corpus (IVF-Flat only), the
    periodic centre refresh, on the purged index's device."""
    from raft_tpu_torch.neighbors import ivf_flat
    _mesh_not_ported(mesh)
    old_rows, old_ids = reconstruct_rows(purged)
    rows = torch.cat([old_rows, delta_rows])
    ids = torch.cat([old_ids, delta_ids])
    del old_rows
    if params is None:
        params = ivf_flat.IndexParams(
            n_lists=purged.n_lists, metric=purged.metric,
            kmeans_n_iters=10)
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
    space (``row_ids[slot]``); pads stay -1."""
    lists = index.lists_indices
    row_ids = torch.as_tensor(row_ids).to(lists.device, torch.int32)
    out = torch.where(lists >= 0, row_ids[torch.clamp(lists, min=0).long()],
                      -1)
    return dataclasses.replace(index, lists_indices=out, plan_cache={})

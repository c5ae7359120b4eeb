"""Distributed exact brute-force k-NN (counterpart of
``raft_tpu.parallel.knn``).

The database rows are sharded over the mesh's data axis; queries are
replicated. Each rank scans its rows in tiles — one product of the
queries against the tile (``distance.pairwise``), kernel 2's select of
the tile's k best (a stable sort above k = 256, or where the tile is
narrower than k), a stable merge into the running top-k — so the
result is exact, as the JAX package's (the approximate binning of the
fused k-NN kernel is not used). Local ids become global by the rank's
row offset; then the ranks merge: ``"ring"`` (n - 1 ``ring_permute``
hops, each rank's original candidates travelling the ring) or
``"allgather"`` (one gather and a select).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.ops import select_k as select_op
from raft_tpu_torch.parallel.ivf import _shmap_plan
from raft_tpu_torch.parallel.mesh import P, current_rank_context, shard_map

__all__ = ["distributed_knn"]

# database rows a rank scores at once: at most _TILE_ELEMS distances
_TILE_ELEMS = 1 << 26
_MAX_TILE = 1 << 16


def _db_tile(nq: int, rows: int) -> int:
    return max(1, min(rows, _MAX_TILE, _TILE_ELEMS // max(1, nq)))


def _select(v: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row of ``v`` with their ``ids``, ties to
    the lower column (``lax.top_k``'s rule)."""
    return select_op.select_k_payload_any(v.contiguous(),
                                          ids.to(torch.int32).contiguous(), k)


def _merge(d_a, i_a, d_b, i_b, k: int):
    return _select(torch.cat([d_a, d_b], dim=1),
                   torch.cat([i_a, i_b], dim=1), k)


def distributed_knn(db, queries, k: int, mesh, axis: str = "data",
                    metric: DistanceType = DistanceType.L2SqrtExpanded,
                    merge: str = "ring",
                    res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN with the database sharded over ``mesh[axis]`` →
    (dists, ids), both (nq, k), on the first rank's device. ``merge``:
    ``"ring"`` (n - 1 ring hops, constant memory a hop) or
    ``"allgather"`` (one gather + a select)."""
    from raft_tpu_torch.distance.pairwise import _pairwise
    from raft_tpu_torch.parallel.mesh import shard_rows
    db = torch.as_tensor(db, dtype=torch.float32)
    q = torch.as_tensor(queries, dtype=torch.float32)
    n_shards = mesh.shape[axis]
    n = db.shape[0]
    dbs, pad = shard_rows(db, mesh, axis)
    rows_per = (n + pad) // n_shards
    tile = _db_tile(q.shape[0], rows_per)

    def build():
        from raft_tpu_torch.comms.comms import build_comms
        comms = build_comms(mesh, axis)

        def local(db_shard, q_rep):
            dev = current_rank_context().device
            nq = q_rep.shape[0]
            best_d = torch.full((nq, k), float("inf"), device=dev)
            best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
            for off in range(0, rows_per, tile):
                dt = db_shard[off:off + tile]
                dd = _pairwise(q_rep, dt, metric, 2.0)
                col = torch.arange(off, off + dt.shape[0], dtype=torch.int32,
                                   device=dev)[None, :].expand(nq, -1)
                td, ti = _select(dd, col, min(k, dt.shape[0]))
                best_d, best_i = _merge(best_d, best_i, td, ti, k)
            # global ids; pad rows (global id >= n) masked
            offset = comms.get_rank() * rows_per
            gi = torch.where(best_i >= 0, best_i + offset, best_i)
            live = (gi >= 0) & (gi < n)
            d = torch.where(live, best_d, torch.full_like(best_d,
                                                          float("inf")))
            gi = torch.where(live, gi, torch.full_like(gi, -1))
            if merge == "allgather":
                gd = comms.allgather(d)                 # (n_shards, nq, k)
                gix = comms.allgather(gi)
                return _select(gd.permute(1, 0, 2).reshape(nq, -1),
                               gix.permute(1, 0, 2).reshape(nq, -1), k)
            # ring: each rank's original candidates travel the ring, so
            # after n - 1 hops every rank merged every shard's set once
            fd, fi, trav_d, trav_i = d, gi, d, gi
            for _ in range(n_shards - 1):
                trav_d = comms.ring_permute(trav_d, 1)
                trav_i = comms.ring_permute(trav_i, 1)
                fd, fi = _merge(fd, fi, trav_d, trav_i, k)
            return fd, fi

        return shard_map(local, mesh, (P(axis), P()), (P(), P()))

    fn = _shmap_plan(("bf_knn", mesh, axis, k, int(metric), merge, rows_per,
                      tile, n), build)
    return fn(dbs, q)

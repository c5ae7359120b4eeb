"""Brute-force k-NN (counterpart of ``raft_tpu.neighbors.brute_force``).

Two routes, as in the JAX package:

* exact (``mode="auto"`` / ``"exact"``): a loop over database tiles
  (:func:`_db_tile`), each giving an (n_queries, tile) block from
  ``distance.pairwise._pairwise`` (a full-f32 matmul for the expanded
  metrics, the elementwise kernel for the others), a per-tile top-k and
  a merge with the running (n_queries, k) result. The JAX package runs
  the same steps as a ``lax.scan``; ties go to the lower row in both.
* fused (``mode="fused"``): ``ops.fused_knn``, the hand-written binned
  k-NN kernel (L2, inner product; cosine and correlation through row
  preprocessing), whose selection is approximate: two neighbours in one
  bin keep only the nearer.

Inner product is a similarity: the k largest are selected.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _pairwise, as_device_tensor
from raft_tpu_torch.ops._util import stable_topk_min

_TILE_ELEMS = 1 << 22  # per-tile f32 budget for the (n_queries, tile) block

# metrics of the fused kernel: DistanceType -> (kernel metric, sqrt)
_FUSED_METRICS = {
    DistanceType.L2Expanded: ("l2", False),
    DistanceType.L2SqrtExpanded: ("l2", True),
    DistanceType.InnerProduct: ("ip", False),
}


def _db_tile(n_queries: int, n_db: int) -> int:
    t = max(128, min(n_db, _TILE_ELEMS // max(1, n_queries)))
    if t >= 128:
        t -= t % 128
    return min(t, n_db)


def _knn_scan(queries: torch.Tensor, db: torch.Tensor, k: int,
              metric: DistanceType, metric_arg: float, tile: int,
              select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    nq, n = queries.shape[0], db.shape[0]
    sign = 1.0 if select_min else -1.0
    best_d = torch.full((nq, k), float("inf"), device=queries.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32,
                        device=queries.device)
    for off in range(0, n, tile):
        d = sign * _pairwise(queries, db[off:off + tile], metric, metric_arg)
        # a per-tile top-k first, then a narrow merge with the carry
        td, tsel = stable_topk_min(d, min(k, d.shape[1]))
        cat_d = torch.cat([best_d, td], dim=1)
        cat_i = torch.cat([best_i, (tsel + off).to(torch.int32)], dim=1)
        best_d, sel = stable_topk_min(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return sign * best_d, best_i


def brute_force_knn(db, queries, k: int,
                    metric: DistanceType = DistanceType.L2SqrtExpanded,
                    metric_arg: float = 2.0, mode: str = "auto",
                    kernel_precision: Optional[str] = None, res=None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of ``queries`` against ``db`` → ``(dists, ids int32)``, both
    (n_queries, k), on ``device`` (default ``cuda``; ``"cpu"`` only when
    asked). ``mode``: ``"auto"``/``"exact"`` the exact tile scan, any
    :class:`DistanceType`; ``"fused"`` the binned fused kernel (L2, IP,
    cosine, correlation). ``kernel_precision`` (fused only):
    ``None`` (bf16x3 on the card, f32 on the CPU), ``"bf16x3"`` (three
    bf16 products of each operand's hi/lo split, the JAX package's TPU
    default), ``"bf16"`` (operands rounded to bf16), ``"highest"``
    (f32)."""
    dev = ensure_resources(res, device).device
    db, queries = as_device_tensor(db, dev), as_device_tensor(queries, dev)
    expects(db.shape[1] == queries.shape[1], "knn: dim mismatch")
    expects(k <= db.shape[0], "knn: k > database size")
    expects(mode in ("auto", "exact", "fused"),
            f"knn: unknown mode {mode!r} (auto|exact|fused)")
    metric = DistanceType(metric)
    if mode == "fused":
        if metric in (DistanceType.CosineExpanded,
                      DistanceType.CorrelationExpanded):
            from raft_tpu_torch.neighbors.processing import (
                _fused_knn_preprocessed)
            return _fused_knn_preprocessed(db, queries, k, metric,
                                           kernel_precision)
        fused = _FUSED_METRICS.get(metric)
        expects(fused is not None,
                f"fused knn supports L2/IP/cosine/correlation, got {metric}")
        from raft_tpu_torch.ops.fused_knn import fused_knn
        return fused_knn(queries, db, k, metric=fused[0], sqrt=fused[1],
                         kernel_precision=kernel_precision)
    tile = _db_tile(queries.shape[0], db.shape[0])
    return _knn_scan(queries, db, k, metric, float(metric_arg), tile,
                     select_min=metric != DistanceType.InnerProduct)


def knn(index: Sequence, search, k: int,
        metric: DistanceType = DistanceType.L2SqrtExpanded,
        metric_arg: float = 2.0, translations: Optional[Sequence[int]] = None,
        res=None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-part brute-force k-NN: ``index`` is a list of database
    parts; per-part results are merged and ids offset by each part's
    start (or by ``translations``)."""
    if not isinstance(index, (list, tuple)):
        index = [index]
    parts_d, parts_i = [], []
    offset = 0
    for p_idx, part in enumerate(index):
        n_part = len(part)
        d, i = brute_force_knn(part, search, min(k, n_part), metric,
                               metric_arg, res=res, device=device)
        base = translations[p_idx] if translations is not None else offset
        parts_d.append(d)
        parts_i.append(i + int(base))
        offset += n_part
    if len(parts_d) == 1:
        return parts_d[0], parts_i[0]
    return knn_merge_parts(parts_d, parts_i, k,
                           select_min=metric != DistanceType.InnerProduct,
                           res=res, device=device)


def knn_merge_parts(part_dists, part_indices, k: int, select_min: bool = True,
                    res=None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k lists into a global top-k: one concatenation
    and ``select_k`` (the selection kernel where it applies)."""
    from raft_tpu_torch.neighbors.selection import select_k
    dev = ensure_resources(res, device).device
    d = torch.cat([as_device_tensor(x, dev) for x in part_dists], dim=1)
    i = torch.cat([as_device_tensor(x, dev) for x in part_indices], dim=1)
    vals, sel = select_k(d, k, select_min=select_min)
    # -1 sentinels (rows with < k finite candidates) stay -1
    out_i = torch.gather(i, 1, sel.clamp(min=0).long())
    return vals, torch.where(sel >= 0, out_i, -1).to(torch.int32)


def haversine_knn(db, queries, k: int, res=None, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN under the haversine great-circle metric over (lat, lon)
    radian pairs: the exact scan with the haversine core."""
    return brute_force_knn(db, queries, k, DistanceType.Haversine, res=res,
                           device=device)


def fused_l2_knn(db, queries, k: int, sqrt: bool = False, res=None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 k-NN (the exact scan) with the reference's sqrt toggle."""
    metric = DistanceType.L2SqrtExpanded if sqrt else DistanceType.L2Expanded
    return brute_force_knn(db, queries, k, metric, res=res, device=device)

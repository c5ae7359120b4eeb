"""Sparse neighbours (counterpart of ``raft_tpu.sparse.neighbors``): CSR
brute-force k-NN, the kNN-graph builder and ``connect_components``, the
single-linkage fix-up that links every connected component of a kNN
graph to its nearest other component.

Selection is a stable sort (ties to the lower index, the contract of
the JAX package's ``lax.top_k``). ``cross_component_nn`` computes its
products in full f32 (no TF32), as the JAX package does at
``HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import resources_for
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import as_device_tensor
from raft_tpu_torch.neighbors.brute_force import brute_force_knn as _dense_knn
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.distance import pairwise_distance as sparse_pairwise
from raft_tpu_torch.sparse.linalg import symmetrize
from raft_tpu_torch.sparse.op import coo_reduce, csr_slice_rows

# f32 elements of one (rows, n) block of the masked 1-NN
_NN_TILE_ELEMS = 1 << 24


def brute_force_knn(x: CSR, queries: CSR, k: int,
                    metric: DistanceType = DistanceType.L2Expanded,
                    metric_arg: float = 2.0, batch_size: int = 4096,
                    res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of sparse queries against a sparse database → (dists, ids
    int32), both (n_queries, k): the sparse pairwise block of each query
    batch, then a stable selection (the k largest for inner product)."""
    metric = DistanceType(metric)
    largest = metric == DistanceType.InnerProduct
    nq = queries.shape[0]
    dists, ids = [], []
    for start in range(0, nq, batch_size):
        qt = csr_slice_rows(queries, start, min(start + batch_size, nq))
        d = sparse_pairwise(qt, x, metric, metric_arg, res=res)
        nd, ni = stable_topk_min(-d if largest else d, k)
        dists.append(-nd if largest else nd)
        ids.append(ni.to(torch.int32))
    return torch.cat(dists), torch.cat(ids)


def knn_graph(x, k: int, metric: DistanceType = DistanceType.L2SqrtExpanded,
              res=None) -> COO:
    """Symmetric kNN graph of dense rows ``x`` as COO (self edges
    dropped, mirrored entries merged by ``max``), from the exact
    ``brute_force_knn``."""
    r = resources_for(x, res)
    x = as_device_tensor(x, r.device)
    n = x.shape[0]
    dists, idx = _dense_knn(x, x, min(k + 1, n), metric, res=r)
    rows = torch.arange(n, dtype=torch.int32,
                        device=x.device).repeat_interleave(idx.shape[1])
    cols = idx.reshape(-1).to(torch.int32)
    keep = rows != cols
    return symmetrize(COO(rows[keep], cols[keep], dists.reshape(-1)[keep],
                          (n, n)), "max")


def _masked_nn(x: torch.Tensor, labels: torch.Tensor, clamp: bool):
    """Per row of ``x``: the least expanded squared L2 to a row with
    another label and that row (the first at a tie), +inf where none;
    full f32 products in (rows, n) tiles. ``clamp`` clamps distances at
    0 before the minimum."""
    full_fp32_matmul()
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    tile = max(1, min(n, _NN_TILE_ELEMS // max(1, n)))
    mins, argmins = [], []
    for s in range(0, n, tile):
        d = sq[s:s + tile, None] + sq[None, :] - 2.0 * (x[s:s + tile] @ x.T)
        if clamp:
            d = torch.clamp(d, min=0.0)
        same = labels[s:s + tile, None] == labels[None, :]
        d = d.masked_fill(same, float("inf"))
        v, i = d.min(dim=1)
        mins.append(v)
        argmins.append(i)
    return torch.cat(mins), torch.cat(argmins).to(torch.int32)


def cross_component_nn(x, labels, res=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For every row, its nearest row with a *different* label →
    (squared distances, ids int32, labels): the masked 1-NN of the
    reference's ``FixConnectivitiesRedOp``."""
    r = resources_for(x, res)
    x = as_device_tensor(x, r.device).float()
    labels = as_device_tensor(labels, r.device)
    d, i = _masked_nn(x, labels, clamp=True)
    return d, i, labels


def _component_min(values: torch.Tensor, labels: torch.Tensor):
    """(labels in ascending order, the row holding each label's least
    value, the first such row at a tie): two stable sorts."""
    order = torch.argsort(values, stable=True)
    order = order[torch.argsort(labels[order], stable=True)]
    lab = labels[order]
    first = torch.ones_like(lab, dtype=torch.bool)
    first[1:] = lab[1:] != lab[:-1]
    return lab[first], order[first]


def connect_components(x, labels, res=None) -> COO:
    """Each component's cheapest edge to another component, as a
    symmetric COO of squared L2 weights (mirrored entries merged by
    ``min``): enough for an MST to finish connecting the graph."""
    dists, nn_idx, labels = cross_component_nn(x, labels, res)
    n = labels.shape[0]
    _, best = _component_min(dists, labels)
    best = best[torch.isfinite(dists[best])]
    if best.numel() == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dists.device)
        return COO(empty, empty, torch.zeros(0, device=dists.device), (n, n))
    src = best.to(torch.int32)
    dst = nn_idx[best]
    w = dists[best]
    return coo_reduce(COO(torch.cat([src, dst]), torch.cat([dst, src]),
                          torch.cat([w, w]), (n, n)), "min")

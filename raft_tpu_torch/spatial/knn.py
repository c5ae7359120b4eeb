"""Legacy ``raft::spatial::knn`` API (counterpart of
``raft_tpu.spatial.knn``): thin forwards over the primary
:mod:`raft_tpu_torch.neighbors` implementations, and the runtime-dispatched
ANN entry points over the port's IVF-Flat and IVF-PQ."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.brute_force import (brute_force_knn, knn,
                                                  knn_merge_parts)
from raft_tpu_torch.neighbors.selection import select_k

__all__ = [
    "brute_force_knn", "knn", "knn_merge_parts", "select_k",
    "approx_knn_build_index", "approx_knn_search",
]

_ANNIndex = Union[ivf_flat.Index, ivf_pq.Index]


def approx_knn_build_index(
    dataset,
    params: Union[ivf_flat.IndexParams, ivf_pq.IndexParams],
    res=None,
    device=None,
) -> _ANNIndex:
    """Build an ANN index, dispatching on the parameter struct's type."""
    if isinstance(params, ivf_flat.IndexParams):
        return ivf_flat.build(dataset, params, res=res, device=device)
    if isinstance(params, ivf_pq.IndexParams):
        return ivf_pq.build(dataset, params, seed=0, res=res, device=device)
    raise TypeError(
        f"approx_knn_build_index: unknown params type {type(params).__name__}"
        " (want ivf_flat.IndexParams or ivf_pq.IndexParams)")


def approx_knn_search(
    index: _ANNIndex,
    queries,
    k: int,
    params: Union[ivf_flat.SearchParams, ivf_pq.SearchParams, None] = None,
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a built ANN index on its device."""
    if isinstance(index, ivf_flat.Index):
        return ivf_flat.search(index, queries, k,
                               params or ivf_flat.SearchParams(), res=res)
    if isinstance(index, ivf_pq.Index):
        return ivf_pq.search(index, queries, k,
                             params or ivf_pq.SearchParams(), res=res)
    raise TypeError(
        f"approx_knn_search: unknown index type {type(index).__name__}")

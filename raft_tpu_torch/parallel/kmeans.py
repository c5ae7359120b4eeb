"""Distributed (MNMG) k-means (counterpart of
``raft_tpu.parallel.kmeans``).

Data rows are sharded over the mesh's data axis; each Lloyd step assigns
every local row on kernel 1 (the fused L2-NN), sums the per-cluster
statistics in row order (``util.segment.segment_sum``), and
``allreduce``s them — added in rank order, so every rank holds the same
centroids bit for bit and two runs agree. The Lloyd loop runs inside
one ``shard_map``; its stopping test (``shift > tol``) reads the
replicated shift on every rank alike.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.parallel.mesh import (P, current_rank_context,
                                          make_mesh, shard_map, shard_rows)
from raft_tpu_torch.util.segment import segment_sum

__all__ = ["distributed_kmeans_fit", "distributed_kmeans_step"]


def distributed_kmeans_step(x_shard, centroids, valid, n_clusters: int,
                            axis: str = "data"):
    """One Lloyd step inside a ``shard_map`` body: local assignment
    (kernel 1) and weighted sums, ``allreduce`` over ``axis``,
    replicated centroid update (an empty cluster keeps its centroid) →
    ``(new_centroids, inertia)``. ``valid`` masks the pad rows."""
    from raft_tpu_torch.comms.comms import Comms
    ctx = current_rank_context()
    comms = Comms(axis_name=axis, n_ranks=ctx.mesh.shape[axis])
    kv = fused_l2_nn(x_shard, centroids, sqrt=False)
    labels, mind = kv.key, kv.value
    w = valid.to(torch.float32)
    local_sums, _ = segment_sum(x_shard * w[:, None], labels, n_clusters)
    local_counts, _ = segment_sum(w[:, None], labels, n_clusters)
    local_inertia = (torch.clamp(mind, min=0.0) * w).sum()
    sums = comms.allreduce(local_sums)
    counts = comms.allreduce(local_counts[:, 0])
    inertia = comms.allreduce(local_inertia)
    new_centroids = sums / torch.where(counts == 0.0,
                                       torch.ones_like(counts),
                                       counts)[:, None]
    new_centroids = torch.where((counts == 0.0)[:, None], centroids,
                                new_centroids)
    return new_centroids, inertia


def distributed_kmeans_fit(
    x,
    params: KMeansParams = KMeansParams(),
    mesh=None,
    axis: str = "data",
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fit k-means over a mesh → (centroids, inertia, n_iter). The
    initial centroids are drawn on the whole data (``Random``: distinct
    sampled rows; else k-means++), as the JAX package draws them."""
    from raft_tpu_torch.cluster.kmeans import _plus_plus, sample_centroids
    x = torch.as_tensor(x, dtype=torch.float32)
    if mesh is None:
        mesh = (res.mesh if res is not None
                else make_mesh(axis_names=(axis,)))
    n = x.shape[0]
    k = params.n_clusters
    if params.init == InitMethod.Random:
        c0 = sample_centroids(x, k, params.seed)
    else:
        c0 = _plus_plus(x, torch.ones(n, device=x.device), params.seed, k)
    xs, pad = shard_rows(x, mesh, axis)
    vs, _ = shard_rows(torch.arange(n + pad, device=x.device) < n, mesh,
                       axis)
    max_iter, tol = int(params.max_iter), float(params.tol)

    def local(x_shard, valid_shard, c_init):
        c = c_init
        inertia = torch.tensor(float("inf"), device=c.device)
        it, shift = 0, float("inf")
        while it < max_iter and shift > tol:
            new_c, inertia = distributed_kmeans_step(x_shard, c,
                                                     valid_shard, k, axis)
            shift = float(((new_c - c) ** 2).sum())
            c = new_c
            it += 1
        return c, inertia, it

    from raft_tpu_torch.parallel.ivf import _shmap_plan
    fn = _shmap_plan(("kmeans_fit", mesh, axis, k, max_iter, tol),
                     lambda: shard_map(local, mesh, (P(axis), P(axis), P()),
                                       (P(), P(), P())))
    centroids, inertia, n_iter = fn(xs, vs, c0)
    return centroids, inertia, int(n_iter)

"""Single-linkage agglomerative clustering (counterpart of
``raft_tpu.cluster.single_linkage``).

The distances, or the kNN graph, come from the device (the port's dense
``distance`` and exact ``brute_force_knn``); the minimum spanning tree
(Borůvka, ``sparse.solver.mst``), the dendrogram and the flat cut run on
the host in numpy, as in the JAX package's fallback route (its native
C++ route is not ported).

A kNN graph need not be connected. The JAX package then adds, for each
component, its cheapest edge to any other component, one numpy product
per component, and repeats until the MST spans. The port computes that
fix-up on the device as one masked 1-NN over all rows (each row's least
expanded squared L2 to a row of another component, full f32 products),
then a per-component minimum by two stable sorts. The edge is the same:
the smallest d² from a member to a non-member, ties to the first flat
index (the lowest member row, then the lowest non-member row), weight
``sqrt(max(d², 0))``.
"""

from __future__ import annotations

import enum
import time
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import resources_for
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import as_device_tensor, distance
from raft_tpu_torch.neighbors.brute_force import brute_force_knn
from raft_tpu_torch.sparse.neighbors import _component_min, _masked_nn
from raft_tpu_torch.sparse.solver.mst import boruvka_mst_edges

# the last call's parts: seconds of the kNN graph ("knn_s"), of each
# connectivity round with the components before it ("connect"), of the
# MST ("mst_s") and of the dendrogram and cut ("dendrogram_s"), and the
# merge heights ("heights", numpy)
last_run: dict = {}


class LinkageDistance(enum.IntEnum):
    PAIRWISE = 0
    KNN_GRAPH = 1


def _cross_component_edges(x: torch.Tensor, comp: np.ndarray):
    """Each component's cheapest edge to another component: (src, dst,
    weight) numpy arrays, one edge per component in label order."""
    labels = torch.from_numpy(comp).to(x.device)
    d2, nn = _masked_nn(x, labels, clamp=False)
    _, best = _component_min(d2, labels)
    best = best[torch.isfinite(d2[best])]
    w = torch.sqrt(torch.clamp(d2[best], min=0.0))
    return (best.cpu().numpy(), nn[best].long().cpu().numpy(),
            w.cpu().numpy())


def _mst_from_knn(x: torch.Tensor, k: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """kNN-graph edges + the cross-component fix-up until the graph
    spans; each part's seconds into ``last_run``."""
    n = x.shape[0]
    t0 = time.perf_counter()
    d, i = brute_force_knn(x, x, min(k + 1, n), DistanceType.L2SqrtExpanded,
                           device=x.device)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    last_run["knn_s"] = time.perf_counter() - t0
    src = np.repeat(np.arange(n), i.shape[1])
    dst = i.reshape(-1)
    w = d.reshape(-1)
    keep = src != dst
    edges = (src[keep], dst[keep], w[keep])
    rounds, mst_s = [], 0.0
    while True:
        t0 = time.perf_counter()
        mst_src, mst_dst, mst_w, comp = boruvka_mst_edges(n, *edges)
        mst_s += time.perf_counter() - t0
        n_comp = len(np.unique(comp))
        if n_comp == 1:
            last_run.update(mst_s=mst_s, connect=rounds)
            return mst_src, mst_dst, mst_w
        t0 = time.perf_counter()
        es, ed, ew = _cross_component_edges(x, comp)
        rounds.append({"components": n_comp,
                       "seconds": time.perf_counter() - t0})
        edges = (np.concatenate([edges[0], es]),
                 np.concatenate([edges[1], ed]),
                 np.concatenate([edges[2], ew.astype(np.float32)]))


def build_dendrogram_host(mst_src, mst_dst, mst_weight
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union-find over weight-sorted MST edges → (children (n-1, 2),
    heights, sizes), scipy-linkage style."""
    order = np.argsort(mst_weight, kind="stable")
    src, dst, w = mst_src[order], mst_dst[order], mst_weight[order]
    n = len(src) + 1
    parent = np.arange(2 * n - 1)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    children = np.zeros((n - 1, 2), np.int64)
    heights = np.zeros(n - 1, np.float64)
    sizes = np.zeros(n - 1, np.int64)
    cluster_size = np.ones(2 * n - 1, np.int64)
    next_label = n
    for e in range(n - 1):
        if not (0 <= src[e] < n and 0 <= dst[e] < n):
            raise ValueError("build_dendrogram: invalid MST edges (rc=-2)")
        ra, rb = find(src[e]), find(dst[e])
        if ra == rb:
            raise ValueError("build_dendrogram: invalid MST edges (rc=-1)")
        children[e] = (ra, rb)
        heights[e] = w[e]
        sizes[e] = cluster_size[ra] + cluster_size[rb]
        cluster_size[next_label] = sizes[e]
        parent[ra] = parent[rb] = next_label
        next_label += 1
    return children, heights, sizes


def _extract_flattened(children: np.ndarray, n: int, n_clusters: int
                       ) -> np.ndarray:
    """Cut the dendrogram at ``n_clusters``: apply the first
    ``n - n_clusters`` merges."""
    n_merges = n - n_clusters
    parent = np.arange(2 * n - 1)
    for e in range(n_merges):
        ra, rb = children[e]
        parent[ra] = parent[rb] = n + e

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def single_linkage(x, n_clusters: int = 2,
                   dist_type: LinkageDistance = LinkageDistance.KNN_GRAPH,
                   c: int = 15, res=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-linkage clustering → (labels int32 (n,), dendrogram
    children (n-1, 2) int32), both on the device of the call. ``c`` sets
    the kNN-graph degree: ``log2(n) + c``."""
    r = resources_for(x, res)
    x = as_device_tensor(x, r.device).float()
    n = x.shape[0]
    expects(1 <= n_clusters <= n, "single_linkage: bad n_clusters")
    last_run.clear()
    if dist_type == LinkageDistance.PAIRWISE:
        t0 = time.perf_counter()
        d = distance(x, x, DistanceType.L2SqrtExpanded, res=r).cpu().numpy()
        iu, ju = np.triu_indices(n, 1)
        last_run["distance_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        src, dst, w = boruvka_mst_edges(n, iu, ju, d[iu, ju])[:3]
        last_run["mst_s"] = time.perf_counter() - t0
    else:
        k = min(n - 1, max(2, int(np.log2(max(n, 2))) + c))
        src, dst, w = _mst_from_knn(x, k)
    t0 = time.perf_counter()
    children, heights, _ = build_dendrogram_host(src, dst, w)
    labels = _extract_flattened(children, n, n_clusters)
    last_run.update(dendrogram_s=time.perf_counter() - t0, heights=heights)
    return (torch.from_numpy(labels).to(x.device),
            torch.from_numpy(children.astype(np.int32)).to(x.device))

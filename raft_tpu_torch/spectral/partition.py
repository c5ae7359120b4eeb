"""Spectral graph partitioning and modularity maximization (counterpart
of ``raft_tpu.spectral.partition``): normalized Laplacian → Lanczos
smallest eigenvectors → columns scaled to unit norm → k-means on the
embedding; the largest eigenvectors of the modularity matrix
B = A − d dᵀ / (2m), applied implicitly; and the quality measures (edge
cut and cost, modularity).

Every step runs on the graph's device: the Laplacian, ``spmv``/``spmm``
and Lanczos on CSR tensors, then k-means, whose assignments are kernel
1 on the card. The implicit modularity operator hands Lanczos the
graph's device (it has no matrix to take it from).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.linalg import laplacian, spmm, spmv
from raft_tpu_torch.sparse.solver.lanczos import lanczos_largest
from raft_tpu_torch.spectral.eigen_solvers import (ClusterSolverConfig,
                                                   EigenSolverConfig,
                                                   KMeansSolver,
                                                   LanczosSolver)


def _transform_eigen_matrix(vecs: torch.Tensor) -> torch.Tensor:
    """Each eigenvector column scaled to unit L2 norm (the reference's
    ``transform_eigen_matrix``)."""
    norms = torch.linalg.norm(vecs, dim=0, keepdim=True)
    return vecs / torch.where(norms > 0, norms, torch.ones_like(norms))


def _configs(n_clusters, n_eig_vects, eigen_config, cluster_config):
    n_eig = n_eig_vects or n_clusters
    return (eigen_config or EigenSolverConfig(n_eigVecs=n_eig),
            cluster_config or ClusterSolverConfig(n_clusters=n_clusters))


def partition(
    graph: CSR,
    n_clusters: int,
    n_eig_vects: Optional[int] = None,
    eigen_config: Optional[EigenSolverConfig] = None,
    cluster_config: Optional[ClusterSolverConfig] = None,
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spectral partition → (labels (n,), eigenvalues ascending,
    eigenvectors (n, k))."""
    eigen_config, cluster_config = _configs(n_clusters, n_eig_vects,
                                            eigen_config, cluster_config)
    lap = laplacian(graph, normalized=True)
    evals, evecs = LanczosSolver(eigen_config).solve_smallest_eigenvectors(
        lap)
    emb = _transform_eigen_matrix(evecs)
    labels, _ = KMeansSolver(cluster_config).solve(emb, res=res)
    return labels, evals, evecs


def _one_hot(labels, n_clusters: int, device) -> torch.Tensor:
    return F.one_hot(as_array(labels, device).long(), n_clusters).float()


def analyze_partition(graph: CSR, labels, n_clusters: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (edge_cut, cost): edge_cut is half the sum over clusters of
    xᵀLx (the weight of the edges that leave each cluster), cost the sum
    of xᵀLx / |cluster| over the non-empty clusters."""
    lap = laplacian(graph, normalized=False)
    onehot = _one_hot(labels, n_clusters, graph.device)
    per_cluster_cut = (onehot * spmm(lap, onehot)).sum(dim=0)
    edge_cut = 0.5 * per_cluster_cut.sum()
    sizes = onehot.sum(dim=0)
    pos = sizes > 0
    cost = torch.where(pos, per_cluster_cut / torch.where(
        pos, sizes, torch.ones_like(sizes)), torch.zeros_like(sizes)).sum()
    return edge_cut, cost


def modularity_maximization(
    graph: CSR,
    n_clusters: int,
    n_eig_vects: Optional[int] = None,
    eigen_config: Optional[EigenSolverConfig] = None,
    cluster_config: Optional[ClusterSolverConfig] = None,
    res=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clusters from the largest eigenvectors of the modularity matrix
    B·x = A·x − d (dᵀx) / (2m) → (labels, eigenvalues largest first,
    eigenvectors). The embedding's columns are unit-normalized and
    weighted by max(λ, 0) / max(λ), as in the JAX package."""
    n = graph.shape[0]
    eigen_config, cluster_config = _configs(n_clusters, n_eig_vects,
                                            eigen_config, cluster_config)
    deg = spmv(graph, torch.ones(n, dtype=torch.float32,
                                 device=graph.device))
    two_m = deg.sum()

    def bmatvec(x):
        return spmv(graph, x) - deg * (torch.dot(deg, x) / two_m)

    evals, evecs = lanczos_largest(None, eigen_config.n_eigVecs,
                                   max_iter=eigen_config.maxIter or None,
                                   seed=eigen_config.seed, matvec=bmatvec,
                                   n=n, device=graph.device)
    scale = torch.clamp(evals, min=0.0) / torch.clamp(evals.max(),
                                                      min=1e-12)
    emb = _transform_eigen_matrix(evecs) * scale[None, :]
    labels, _ = KMeansSolver(cluster_config).solve(emb, res=res)
    return labels, evals, evecs


def analyze_modularity(graph: CSR, labels, n_clusters: int
                       ) -> torch.Tensor:
    """Modularity Q = Σ_c [e_c / (2m) − (d_c / (2m))²]."""
    full_fp32_matmul()
    n = graph.shape[0]
    deg = spmv(graph, torch.ones(n, dtype=torch.float32,
                                 device=graph.device))
    two_m = deg.sum()
    onehot = _one_hot(labels, n_clusters, graph.device)
    e_c = (onehot * spmm(graph, onehot)).sum(dim=0)
    d_c = onehot.T @ deg
    return (e_c / two_m - (d_c / two_m) ** 2).sum()

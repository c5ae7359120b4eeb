"""Pluggable eigen and cluster solvers for the spectral methods
(counterpart of ``raft_tpu.spectral.eigen_solvers``): config dataclasses
and callable solver objects, so ``partition`` and
``modularity_maximization`` can swap strategies. The eigen solver is
the port's Lanczos (``sparse.solver.lanczos``); the cluster solver is
Lloyd k-means (``cluster.kmeans.fit_predict``), whose assignments run
kernel 1 (``fused_l2_nn``) on the card."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from raft_tpu_torch.cluster.kmeans import fit_predict
from raft_tpu_torch.cluster.kmeans_types import KMeansParams
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.solver.lanczos import (lanczos_largest,
                                                  lanczos_smallest)


@dataclass
class EigenSolverConfig:
    """Mirrors ``eigen_solver_config_t``."""

    n_eigVecs: int
    maxIter: int = 0  # 0 → auto (4k+16)
    restartIter: int = 0  # unused: full-reorth Lanczos doesn't restart
    tol: float = 1e-4
    reorthogonalize: bool = True
    seed: int = 1234567


class LanczosSolver:
    """Mirrors ``lanczos_solver_t``: smallest/largest eigenpairs of a CSR."""

    def __init__(self, config: EigenSolverConfig):
        self.config = config

    def solve_smallest_eigenvectors(self, a: CSR
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return lanczos_smallest(a, self.config.n_eigVecs,
                                max_iter=self.config.maxIter or None,
                                seed=self.config.seed)

    def solve_largest_eigenvectors(self, a: CSR
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return lanczos_largest(a, self.config.n_eigVecs,
                               max_iter=self.config.maxIter or None,
                               seed=self.config.seed)


@dataclass
class ClusterSolverConfig:
    """Mirrors ``cluster_solver_config_t``."""

    n_clusters: int
    maxIter: int = 100
    tol: float = 1e-4
    seed: int = 123456


class KMeansSolver:
    """Mirrors ``kmeans_solver_t`` — cluster the rows of the embedding."""

    def __init__(self, config: ClusterSolverConfig):
        self.config = config

    def solve(self, embedding: torch.Tensor, res=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (labels, inertia)."""
        params = KMeansParams(n_clusters=self.config.n_clusters,
                              max_iter=self.config.maxIter,
                              tol=self.config.tol, seed=self.config.seed)
        labels, _centroids, inertia, _ = fit_predict(embedding, params,
                                                     res=res)
        return labels, inertia

"""Spectral methods (counterpart of ``raft_tpu.spectral``)."""

from raft_tpu_torch.spectral.eigen_solvers import (ClusterSolverConfig,
                                                   EigenSolverConfig,
                                                   KMeansSolver,
                                                   LanczosSolver)
from raft_tpu_torch.spectral.partition import (analyze_modularity,
                                               analyze_partition,
                                               modularity_maximization,
                                               partition)

__all__ = [
    "ClusterSolverConfig", "EigenSolverConfig", "KMeansSolver",
    "LanczosSolver",
    "analyze_modularity", "analyze_partition", "modularity_maximization",
    "partition",
]

"""Distances: the metric enum and tables, pairwise distances, the fused
L2 nearest neighbour and Gram matrices (the names ``raft_tpu.distance``
exports)."""

from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    SUPPORTED_DISTANCES,
                                                    DistanceType)
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn, fused_l2_nn_argmin
from raft_tpu_torch.distance.kernels import KernelParams, KernelType, gram_matrix
from raft_tpu_torch.distance.pairwise import distance, pairwise_distance

__all__ = [
    "DistanceType",
    "DISTANCE_TYPES",
    "SUPPORTED_DISTANCES",
    "pairwise_distance",
    "distance",
    "fused_l2_nn",
    "fused_l2_nn_argmin",
    "KernelType",
    "KernelParams",
    "gram_matrix",
]

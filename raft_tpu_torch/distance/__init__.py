"""Distances: metric enum and the fused L2 nearest neighbour."""

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn

__all__ = ["DistanceType", "fused_l2_nn"]

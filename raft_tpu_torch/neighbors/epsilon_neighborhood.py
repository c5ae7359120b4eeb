"""Epsilon neighbourhood (counterpart of
``raft_tpu.neighbors.epsilon_neighborhood``): the boolean adjacency of
points within eps² (squared L2) and each row's degree."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import distance


def eps_neighbors_l2sq(x, y, eps_sq: float, res=None, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``adj[i, j] = ||x_i - y_j||² < eps²`` and the row degrees (int32),
    on ``device`` (default ``cuda``; ``"cpu"`` only when asked)."""
    d = distance(x, y, DistanceType.L2Expanded, res=res, device=device)
    adj = d < eps_sq
    return adj, adj.to(torch.int32).sum(dim=1, dtype=torch.int32)

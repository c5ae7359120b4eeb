"""K-means parameters (counterpart of ``raft_tpu.cluster.kmeans_types``):
``InitMethod`` and ``KMeansParams`` with the JAX package's fields and
defaults."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class InitMethod(enum.IntEnum):
    KMeansPlusPlus = 0
    Random = 1
    Array = 2


@dataclass
class KMeansParams:
    n_clusters: int = 8
    init: InitMethod = InitMethod.KMeansPlusPlus
    max_iter: int = 300
    tol: float = 1e-4
    verbosity: int = 4
    seed: int = 0
    metric: int = 0  # DistanceType.L2Expanded
    n_init: int = 1
    oversampling_factor: float = 2.0
    # tiling bounds of the assignment step in the JAX package; the fused
    # L2-NN kernel tiles on its own, so they are accepted and unused
    batch_samples: int = 1 << 15
    batch_centroids: int = 0
    inertia_check: bool = False

"""Distance metric enumeration and name tables.

Copy of ``raft_tpu.distance.distance_types``: the integer values are the
reference ``DistanceType`` enum's, and ``serialize`` stores ``int(metric)``,
so both packages must keep them identical.
"""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    """Pairwise distance metrics (values match the reference enum)."""

    L2Expanded = 0            # sum(x^2) + sum(y^2) - 2*x.y
    L2SqrtExpanded = 1        # sqrt of the above
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4          # sum((x-y)^2) accumulated directly
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7                  # Chebyshev
    Canberra = 8
    LpUnexpanded = 9          # generalized Minkowski
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


# String → enum table; superset of the reference's (pairwise_distance.pyx:62).
DISTANCE_TYPES = {
    "l2": DistanceType.L2SqrtUnexpanded,
    "sqeuclidean": DistanceType.L2Unexpanded,
    "euclidean": DistanceType.L2SqrtUnexpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "cosine": DistanceType.CosineExpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "minkowski": DistanceType.LpUnexpanded,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
    "haversine": DistanceType.Haversine,
}

# Metrics accepted by pairwise_distance — the reference's runtime dispatch
# set (distance/distance.cuh:305-399 switch) plus the expanded set-metrics
# (jaccard/dice/braycurtis) which we support natively on TPU.
SUPPORTED_DISTANCES = [
    "euclidean", "l1", "cityblock", "l2", "inner_product", "chebyshev",
    "minkowski", "canberra", "kl_divergence", "correlation", "russellrao",
    "hellinger", "lp", "hamming", "jensenshannon", "cosine", "sqeuclidean",
    "jaccard", "dice", "braycurtis", "haversine",
]

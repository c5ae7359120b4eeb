"""Query/index preprocessing for metrics the fused kernel lacks
(counterpart of ``raft_tpu.neighbors.processing``).

The fused k-NN kernel speaks L2 and inner product only, so cosine rows
are L2-normalized and correlation rows mean-centred first, both sides
are searched by inner product (largest first), and the similarity is
turned back into a distance, ``1 - similarity``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.distance.distance_types import DistanceType

_EPS = 1e-12


def preprocess_rows(x: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    """Rows transformed so that their inner product is the metric's
    similarity: cosine → L2-normalized; correlation → mean-centred, then
    L2-normalized."""
    x = x.float()
    if metric == DistanceType.CorrelationExpanded:
        x = x - x.mean(dim=1, keepdim=True)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.clamp(norms, min=_EPS)


def postprocess_distances(sims: torch.Tensor,
                          metric: DistanceType) -> torch.Tensor:
    """Similarity → distance: ``1 - similarity`` for cosine and
    correlation."""
    del metric
    return 1.0 - sims


def fused_knn_preprocessed(db: torch.Tensor, queries: torch.Tensor, k: int,
                           metric: DistanceType
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine/correlation k-NN through the fused IP kernel."""
    return _fused_knn_preprocessed(db, queries, k, metric)


def _fused_knn_preprocessed(db: torch.Tensor, queries: torch.Tensor,
                            k: int, metric: DistanceType,
                            kernel_precision=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_knn_preprocessed` at a ``kernel_precision``
    (``brute_force_knn`` passes its own on, where the JAX package drops
    it)."""
    from raft_tpu_torch.ops.fused_knn import fused_knn
    if metric not in (DistanceType.CosineExpanded,
                      DistanceType.CorrelationExpanded):
        raise ValueError(
            f"fused_knn_preprocessed: metric {metric} needs no preprocessing"
            " (use brute_force_knn)")
    sims, idx = fused_knn(preprocess_rows(queries, metric),
                          preprocess_rows(db, metric), k, metric="ip",
                          kernel_precision=kernel_precision)
    return postprocess_distances(sims, metric), idx

"""Clustering: Lloyd k-means, the balanced k-means IVF trainer and
single-linkage."""

from raft_tpu_torch.cluster.kmeans import (cluster_cost,
                                           count_samples_in_cluster, fit,
                                           fit_predict, init_plus_plus,
                                           min_cluster_distance, predict,
                                           sample_centroids, transform)
from raft_tpu_torch.cluster.kmeans_balanced import (balanced_kmeans,
                                                    build_hierarchical)
from raft_tpu_torch.cluster.kmeans_balanced import \
    predict as balanced_predict
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
from raft_tpu_torch.cluster.single_linkage import (LinkageDistance,
                                                   single_linkage)

__all__ = [
    "KMeansParams", "InitMethod",
    "fit", "predict", "fit_predict", "transform", "cluster_cost",
    "init_plus_plus", "sample_centroids", "min_cluster_distance",
    "count_samples_in_cluster",
    "build_hierarchical", "balanced_kmeans", "balanced_predict",
    "single_linkage", "LinkageDistance",
]

"""Statistics: the clustering-quality and information metrics of
``raft_tpu.stats`` (its moments and regression metrics are not ported
yet)."""

from raft_tpu_torch.stats.clustering_metrics import (
    InformationCriterion,
    adjusted_rand_index,
    completeness_score,
    contingency_matrix,
    entropy,
    homogeneity_score,
    information_criterion,
    kl_divergence,
    mutual_info_score,
    rand_index,
    silhouette_score,
    trustworthiness_score,
    v_measure,
)

__all__ = [
    "contingency_matrix", "adjusted_rand_index", "rand_index",
    "mutual_info_score", "entropy", "homogeneity_score",
    "completeness_score", "v_measure", "kl_divergence", "silhouette_score",
    "trustworthiness_score", "information_criterion", "InformationCriterion",
]

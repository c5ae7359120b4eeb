"""Statistics (counterpart of ``raft_tpu.stats``): moments and summary
statistics, regression metrics, and the clustering-quality and
information metrics."""

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
from raft_tpu_torch.stats.moments import (col_weighted_mean, cov, dispersion,
                                          histogram, mean, mean_add,
                                          mean_center, meanvar, minmax,
                                          row_weighted_mean, stddev, sum_,
                                          vars_, weighted_mean)
from raft_tpu_torch.stats.regression import (accuracy, mean_squared_error,
                                             r2_score, regression_metrics)

__all__ = [
    "mean", "mean_center", "mean_add", "meanvar", "stddev", "vars_", "sum_",
    "cov", "minmax", "weighted_mean", "row_weighted_mean", "col_weighted_mean",
    "histogram", "dispersion",
    "accuracy", "r2_score", "regression_metrics", "mean_squared_error",
    "contingency_matrix", "adjusted_rand_index", "rand_index",
    "mutual_info_score", "entropy", "homogeneity_score",
    "completeness_score", "v_measure", "kl_divergence", "silhouette_score",
    "trustworthiness_score", "information_criterion", "InformationCriterion",
]

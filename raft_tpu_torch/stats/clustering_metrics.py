"""Clustering-quality and information metrics (counterpart of
``raft_tpu.stats.clustering_metrics``).

The contingency-table metrics build the table once (a ``bincount`` of
``true * n_pred + pred``, exact in any order) and derive everything from
it. ``silhouette_score`` keeps the JAX package's ``(chunk, n)`` tiles:
each tile's distances come from ``distance.pairwise_distance`` (kernel 7
on the card for the elementwise metrics such as ``"cityblock"``) and are
reduced to per-cluster sums by one product with the labels' one-hot
matrix. Each function runs on the device of its input tensor, or on
``res``'s (default ``cuda``).
"""

from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import resources_for
from raft_tpu_torch.distance.pairwise import (as_device_tensor,
                                              pairwise_distance)


def _labels(x, res) -> torch.Tensor:
    return as_device_tensor(x, resources_for(x, res).device).long()


def _n_classes(labels: torch.Tensor, n: Optional[int]) -> int:
    return int(labels.max()) + 1 if n is None else int(n)


def contingency_matrix(y_true, y_pred, n_classes_true: Optional[int] = None,
                       n_classes_pred: Optional[int] = None, res=None
                       ) -> torch.Tensor:
    """(n_true, n_pred) float32 label co-occurrence counts; labels
    0-based."""
    t = _labels(y_true, res)
    p = as_device_tensor(y_pred, t.device).long()
    n_t, n_p = _n_classes(t, n_classes_true), _n_classes(p, n_classes_pred)
    counts = torch.bincount(t * n_p + p, minlength=n_t * n_p)
    return counts.to(torch.float32).reshape(n_t, n_p)


def _comb2(x):
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(y_true, y_pred, res=None) -> torch.Tensor:
    """Adjusted Rand index from the contingency table."""
    c = contingency_matrix(y_true, y_pred, res=res)
    n = c.sum()
    sum_comb_c = _comb2(c).sum()
    sum_comb_a = _comb2(c.sum(dim=1)).sum()
    sum_comb_b = _comb2(c.sum(dim=0)).sum()
    expected = sum_comb_a * sum_comb_b / _comb2(n)
    denom = 0.5 * (sum_comb_a + sum_comb_b) - expected
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(denom == 0.0, torch.ones_like(denom),
                       (sum_comb_c - expected) / safe)


def rand_index(y_true, y_pred, res=None) -> torch.Tensor:
    """Unadjusted Rand index."""
    c = contingency_matrix(y_true, y_pred, res=res)
    n = c.sum()
    sum_comb = _comb2(c).sum()
    a = _comb2(c.sum(dim=1)).sum()
    b = _comb2(c.sum(dim=0)).sum()
    total = _comb2(n)
    return (total + 2.0 * sum_comb - a - b) / total


def entropy(labels, n_classes: Optional[int] = None,
            res=None) -> torch.Tensor:
    """Shannon entropy (nats) of a label distribution."""
    lab = _labels(labels, res)
    counts = torch.bincount(lab, minlength=_n_classes(lab, n_classes)).float()
    p = counts / counts.sum()
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return -torch.where(p > 0, p * torch.log(safe), torch.zeros_like(p)).sum()


def mutual_info_score(y_true, y_pred, res=None) -> torch.Tensor:
    """Mutual information (nats) from the contingency table."""
    c = contingency_matrix(y_true, y_pred, res=res)
    pij = c / c.sum()
    pi = pij.sum(dim=1, keepdim=True)
    pj = pij.sum(dim=0, keepdim=True)
    outer = pi * pj
    ratio = pij / torch.where(outer > 0, outer, torch.ones_like(outer))
    safe = torch.where(pij > 0, ratio, torch.ones_like(ratio))
    return torch.where(pij > 0, pij * torch.log(safe),
                       torch.zeros_like(pij)).sum()


def _ratio_or_one(num, den):
    safe = torch.where(den == 0.0, torch.ones_like(den), den)
    return torch.where(den == 0.0, torch.ones_like(den), num / safe)


def homogeneity_score(y_true, y_pred, res=None) -> torch.Tensor:
    """MI / H(true)."""
    return _ratio_or_one(mutual_info_score(y_true, y_pred, res=res),
                         entropy(y_true, res=res))


def completeness_score(y_true, y_pred, res=None) -> torch.Tensor:
    """MI / H(pred)."""
    return _ratio_or_one(mutual_info_score(y_true, y_pred, res=res),
                         entropy(y_pred, res=res))


def v_measure(y_true, y_pred, beta: float = 1.0, res=None) -> torch.Tensor:
    """Weighted harmonic mean of homogeneity and completeness."""
    h = homogeneity_score(y_true, y_pred, res=res)
    c = completeness_score(y_true, y_pred, res=res)
    denom = beta * h + c
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(denom == 0.0, torch.zeros_like(denom),
                       (1 + beta) * h * c / safe)


def kl_divergence(p, q, res=None) -> torch.Tensor:
    """Sum of p log(p / q) over two distributions."""
    p = as_device_tensor(p, resources_for(p, res).device).float()
    q = as_device_tensor(q, p.device).float()
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    safe_q = torch.where(q > 0, q, torch.ones_like(q))
    return torch.where(p > 0, p * torch.log(safe_p / safe_q),
                       torch.zeros_like(p)).sum()


def silhouette_score(x, labels, n_clusters: Optional[int] = None,
                     metric: str = "euclidean", chunk: int = 256,
                     res=None) -> torch.Tensor:
    """Mean silhouette coefficient, over ``(chunk, n)`` distance tiles:
    each tile's per-cluster distance sums are one product with the
    labels' one-hot (n, n_clusters) matrix."""
    r = resources_for(x, res)
    x = as_device_tensor(x, r.device).float()
    lab = as_device_tensor(labels, r.device).long()
    n = x.shape[0]
    n_clusters = _n_classes(lab, n_clusters)
    counts = torch.bincount(lab, minlength=n_clusters).float()
    onehot = torch.nn.functional.one_hot(lab, n_clusters).float()
    full_fp32_matmul()
    sums = torch.cat([pairwise_distance(x[s:s + chunk], x, metric=metric,
                                        res=r) @ onehot
                      for s in range(0, n, chunk)])
    own = counts[lab]
    own_sum = sums.gather(1, lab[:, None])[:, 0]
    # a(i): mean distance to the rest of its cluster (self-distance 0)
    a = torch.where(own > 1, own_sum / torch.clamp(own - 1, min=1),
                    torch.zeros_like(own))
    # b(i): the least mean distance to another cluster
    means = sums / torch.clamp(counts[None, :], min=1)
    means = torch.where(counts[None, :] > 0, means, math.inf)
    means.scatter_(1, lab[:, None], math.inf)
    b = means.amin(dim=1)
    s = torch.where(own > 1, (b - a) / torch.clamp(torch.maximum(a, b),
                                                   min=1e-12),
                    torch.zeros_like(a))
    return s.mean()


def trustworthiness_score(x, x_embedded, n_neighbors: int = 5,
                          metric: str = "euclidean",
                          res=None) -> torch.Tensor:
    """Trustworthiness of a low-dimensional embedding: penalises
    embedded-space neighbours that rank far in the original space."""
    r = resources_for(x, res)
    x = as_device_tensor(x, r.device).float()
    e = as_device_tensor(x_embedded, r.device).float()
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d_orig = pairwise_distance(x, x, metric=metric, res=r).masked_fill(
        eye, math.inf)
    d_emb = pairwise_distance(e, e, metric=metric, res=r).masked_fill(
        eye, math.inf)
    # rank of each j in i's original-space order
    orig_order = torch.argsort(d_orig, dim=1, stable=True)
    ranks = torch.empty((n, n), device=x.device)
    ranks.scatter_(1, orig_order, torch.arange(
        n, dtype=torch.float32, device=x.device).expand(n, n).contiguous())
    emb_nn = torch.argsort(d_emb, dim=1, stable=True)[:, :n_neighbors]
    rk = ranks.gather(1, emb_nn)
    penalty = torch.clamp(rk - n_neighbors + 1, min=0.0).sum()
    norm = 2.0 / (n * n_neighbors * (2.0 * n - 3.0 * n_neighbors - 1.0))
    return 1.0 - norm * penalty


class InformationCriterion(enum.IntEnum):
    """Akaike, corrected Akaike, Bayesian."""

    AIC = 0
    AICc = 1
    BIC = 2


def information_criterion(log_likelihood, ic_type: InformationCriterion,
                          n_params: int, n_samples: int,
                          res=None) -> torch.Tensor:
    """Information criterion of each log-likelihood."""
    ll = as_device_tensor(log_likelihood,
                          resources_for(log_likelihood, res).device).float()
    k, n = float(n_params), float(n_samples)
    ic = -2.0 * ll
    if ic_type == InformationCriterion.AIC:
        return ic + 2.0 * k
    if ic_type == InformationCriterion.AICc:
        return ic + 2.0 * k + 2.0 * k * (k + 1.0) / max(n - k - 1.0, 1e-6)
    if ic_type == InformationCriterion.BIC:
        return ic + k * math.log(n)
    raise ValueError(f"unknown IC type {ic_type}")

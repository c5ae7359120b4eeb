"""Lloyd k-means (counterpart of ``raft_tpu.cluster.kmeans``).

Each iteration assigns every row to its nearest centroid with the fused
L2-NN (``distance.fused_l2_nn``: kernel 1 on the card at bf16x3, the
card's default as the TPU kernel's, f32 on the CPU), then recomputes the
centroids as weighted per-cluster means whose sums are added in a fixed
order (``util.segment.segment_sum``), so two fits at one seed give the
same bits on the card. An empty cluster is re-seeded from the highest-cost
rows: the JAX package picks them with ``lax.approx_max_k``, the port takes
the exact top rows by a stable sort, ties to the lower row (on the CPU
the JAX operator is exact too). The JAX ``lax.while_loop`` on the
centroid shift is a host loop here, one sync an iteration; after it, one
more assignment gives the returned inertia.

k-means++ draws each next centre from a ``torch.Generator`` seeded by
``seed`` (Gumbel-argmax over the same logits as the JAX package's
``jax.random.categorical``), so the two packages pick other rows.
``sample_centroids`` draws its rows with ``util.host_sample`` (the JAX
package's numpy stream only above 65536 rows).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
# (labels int32, squared distances) of each row to its nearest centroid
from raft_tpu_torch.cluster.kmeans_balanced import _nn as _assign
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import resources_for
from raft_tpu_torch.distance.pairwise import as_device_tensor
from raft_tpu_torch.obs import spans
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.util.host_sample import sample_rows, take_rows
from raft_tpu_torch.util.segment import segment_sum


def _rows(x, res) -> torch.Tensor:
    """``x`` as float32 on the device the call runs on."""
    return as_device_tensor(x, resources_for(x, res).device).float()


def _weights(sample_weight, x: torch.Tensor) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones(x.shape[0], device=x.device)
    return as_device_tensor(sample_weight, x.device).float()


def _weighted_update(x, labels, weights, n_clusters: int):
    """Weighted per-cluster means and weight sums: one fixed-order
    segment sum of ``[x * w, w]``."""
    sums, _ = segment_sum(torch.cat([x * weights[:, None],
                                     weights[:, None]], dim=1),
                          labels, n_clusters)
    wsum = sums[:, -1]
    centroids = sums[:, :-1] / torch.where(wsum == 0.0,
                                           torch.ones_like(wsum),
                                           wsum)[:, None]
    return centroids, wsum


def _lloyd(x, weights, centroids, n_clusters: int, max_iter: int,
           tol: float):
    """Lloyd iterations until ``max_iter`` or a shift of at most ``tol``
    → (centroids, labels, inertia, n_iter)."""
    n_iter, shift = 0, float("inf")
    while n_iter < max_iter and shift > tol:
        labels, d = _assign(x, centroids)
        new, wsum = _weighted_update(x, labels, weights, n_clusters)
        # empty clusters: one of the n_clusters highest-cost rows each,
        # in cluster order
        empty = wsum == 0.0
        worst = stable_topk_min(-d, n_clusters)[1]
        slot = torch.cumsum(empty.to(torch.int64), 0) - 1
        seeds = x[worst[slot.clamp(0, n_clusters - 1)]]
        new = torch.where(empty[:, None], seeds, new)
        shift = float(((new - centroids) ** 2).sum())
        centroids = new
        n_iter += 1
    labels, d = _assign(x, centroids)
    return centroids, labels, (weights * d).sum(), n_iter


def _plus_plus(x: torch.Tensor, weights: torch.Tensor, seed: int,
               n_clusters: int) -> torch.Tensor:
    """k-means++ seeding: each next centre drawn with probability
    proportional to the weighted squared distance to the nearest centre
    so far (Gumbel-argmax over ``log(max(cost, 1e-37))``)."""
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=g, device=x.device))
    centers = torch.empty((n_clusters, x.shape[1]), device=x.device)
    centers[0] = x[first]
    mind = ((x - x[first]) ** 2).sum(dim=1)
    for i in range(1, n_clusters):
        logits = torch.log(torch.clamp(mind * weights, min=1e-37))
        u = torch.rand(n, generator=g, device=x.device)
        pick = torch.argmax(logits - torch.log(-torch.log(u)))
        c = x[pick]
        centers[i] = c
        mind = torch.minimum(mind, ((x - c) ** 2).sum(dim=1))
    return centers


def init_plus_plus(x, n_clusters: int, sample_weight=None, seed: int = 0,
                   res=None) -> torch.Tensor:
    """k-means++ seeding → (n_clusters, dim) rows of ``x``."""
    x = _rows(x, res)
    return _plus_plus(x, _weights(sample_weight, x), seed, n_clusters)


def sample_centroids(x, n_clusters: int, seed: int = 0,
                     res=None) -> torch.Tensor:
    """``n_clusters`` distinct rows of ``x`` drawn on the host."""
    x = as_device_tensor(x, resources_for(x, res).device)
    return take_rows(x, sample_rows(x.shape[0], n_clusters, seed, x.device))


@spans.spanned("raft.kmeans.fit")
@obs.timed("raft.kmeans.fit")
def fit(x, params: KMeansParams = KMeansParams(), sample_weight=None,
        init_centroids=None, res=None
        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fit k-means → (centroids (k, d), inertia (a 0-d tensor), n_iter).
    ``params.n_init`` restarts draw at ``seed + trial`` and keep the
    lowest inertia; an explicit ``init_centroids`` (or
    ``InitMethod.Array``) runs once."""
    x = _rows(x, res)
    n = x.shape[0]
    k = params.n_clusters
    expects(k <= n, "kmeans: n_clusters > n_samples")
    w = _weights(sample_weight, x)
    fixed = init_centroids is not None or params.init == InitMethod.Array
    if fixed:
        expects(init_centroids is not None,
                "kmeans: InitMethod.Array requires init_centroids")
    n_trials = 1 if fixed else max(1, params.n_init)
    best, inertias = None, []
    for trial in range(n_trials):
        if fixed:
            c0 = as_device_tensor(init_centroids, x.device).float()
        elif params.init == InitMethod.Random:
            c0 = sample_centroids(x, k, params.seed + trial)
        else:
            c0 = _plus_plus(x, w, params.seed + trial, k)
        out = _lloyd(x, w, c0, k, params.max_iter, params.tol)
        inertias.append(float(out[2]))
        if best is None or inertias[-1] < float(best[2]):
            best = out
    centroids, _, inertia, n_iter = best
    obs.counter("raft.kmeans.fit.total").inc()
    obs.counter("raft.kmeans.fit.rows").inc(n)
    spans.current_span().set_attrs(rows=n, n_clusters=k,
                                   n_iter=int(n_iter),
                                   inertia=float(inertia))
    obs.histogram("raft.kmeans.fit.iterations",
                  buckets=obs.SIZE_BUCKETS).observe(int(n_iter))
    obs.gauge("raft.kmeans.fit.inertia").set(float(inertia))
    if len(inertias) > 1:
        # how much the n_init restarts bought over the first trial
        obs.gauge("raft.kmeans.fit.inertia_delta").set(
            inertias[0] - float(inertia))
    return centroids, inertia, n_iter


def predict(x, centroids, sample_weight=None, res=None) -> torch.Tensor:
    """Nearest-centroid labels (int32)."""
    x = _rows(x, res)
    return _assign(x, as_device_tensor(centroids, x.device).float())[0]


def fit_predict(x, params: KMeansParams = KMeansParams(), sample_weight=None,
                res=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   int]:
    """(labels, centroids, inertia, n_iter)."""
    x = _rows(x, res)
    centroids, inertia, n_iter = fit(x, params, sample_weight)
    return predict(x, centroids), centroids, inertia, n_iter


def transform(x, centroids, res=None) -> torch.Tensor:
    """L2 distance (not squared) of every row to every centroid."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.distance.pairwise import distance
    r = resources_for(x, res)
    return distance(x, centroids, DistanceType.L2SqrtExpanded, res=r)


def cluster_cost(x, centroids, sample_weight=None, res=None) -> torch.Tensor:
    """Total (weighted) squared distance of the rows to their nearest
    centroid, a 0-d tensor."""
    x = _rows(x, res)
    d = _assign(x, as_device_tensor(centroids, x.device).float())[1]
    if sample_weight is not None:
        d = d * as_device_tensor(sample_weight, x.device)
    return d.sum()


def min_cluster_distance(x, centroids, res=None) -> torch.Tensor:
    """Per-row squared distance to the nearest centroid."""
    x = _rows(x, res)
    return _assign(x, as_device_tensor(centroids, x.device).float())[1]


def count_samples_in_cluster(x, centroids, res=None) -> torch.Tensor:
    """Rows per cluster (int32)."""
    x = _rows(x, res)
    c = as_device_tensor(centroids, x.device).float()
    labels = _assign(x, c)[0]
    return torch.bincount(labels.long(), minlength=c.shape[0]).to(torch.int32)

"""Balanced k-means — the IVF index trainer (counterpart of
``raft_tpu.cluster.kmeans_balanced``).

Each EM sweep assigns every row to its nearest centre with the fused
L2-NN kernel, recomputes centres from per-cluster sums added in a fixed
order (``util.segment.segment_sum``: the same bits on every run of one
seed, where ``index_add_`` on the card adds through atomics), and
re-seeds clusters below ``balance_threshold`` of the average size from
the highest-cost rows. The JAX package picks those rows with
``lax.approx_max_k``; the port takes the exact top rows by a stable
sort, ties to the lower row (on the CPU the JAX operator is exact too,
so the two agree there).

``kernel_precision`` reaches every assignment, as in the JAX package:
``None`` is bf16x3 on the card (the TPU kernel's default) and f32 on the
CPU; ``"bf16"`` is one bf16 pass, ``"highest"`` f32. :func:`predict`
takes none, so it uses the default. :func:`build_hierarchical` trains
flat up to ``FLAT_MAX_CLUSTERS`` centres and on two levels above that,
as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.util.host_sample import sample_rows, take_rows
from raft_tpu_torch.util.segment import segment_sum

FLAT_MAX_CLUSTERS = 16384


def _nn(x: torch.Tensor, centers: torch.Tensor, kernel_precision=None):
    kv = fused_l2_nn(x, centers, sqrt=False,
                     kernel_precision=kernel_precision)
    return kv.key, kv.value


def predict(x: torch.Tensor, centers: torch.Tensor,
            res=None) -> torch.Tensor:
    """Nearest-centre labels (int32)."""
    ensure_resources(res, x.device)
    labels, _ = _nn(x.float(), centers.float())
    return labels


def _em(x: torch.Tensor, centers: torch.Tensor, n_clusters: int,
        n_iters: int, balance_threshold: float,
        kernel_precision=None) -> torch.Tensor:
    avg = x.shape[0] / n_clusters
    for _ in range(n_iters):
        labels, d = _nn(x, centers, kernel_precision)
        sums, counts = segment_sum(x, labels, n_clusters)
        counts = counts.float()
        new_centers = sums / torch.where(counts == 0.0,
                                         torch.ones_like(counts),
                                         counts)[:, None]
        small = counts < balance_threshold * avg
        worst = stable_topk_min(-d, n_clusters)[1]
        slot = torch.cumsum(small.to(torch.int64), 0) - 1
        seeds = x[worst]
        centers = torch.where(small[:, None],
                              seeds[slot.clamp(0, n_clusters - 1)],
                              new_centers)
    return centers


def balanced_kmeans(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                    balance_threshold: float = 0.25, seed: int = 0,
                    kernel_precision: Optional[str] = None,
                    res=None) -> torch.Tensor:
    """Train ``n_clusters`` balanced centres → (n_clusters, dim), from
    the initial rows ``sample_rows(n, n_clusters, seed)`` (a host-side
    draw). ``kernel_precision``: the assignment's arithmetic (see the
    module note)."""
    ensure_resources(res, x.device)
    return _train_from(x, n_clusters, n_iters, balance_threshold, seed,
                       kernel_precision=kernel_precision)


def _train_from(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                balance_threshold: float = 0.25, seed: int = 0,
                init_idx: Optional[torch.Tensor] = None,
                kernel_precision: Optional[str] = None) -> torch.Tensor:
    """:func:`balanced_kmeans` from the initial rows ``init_idx``
    (default: the seeded draw), so a test can hand both packages the
    same rows."""
    x = x.float()
    expects(n_clusters <= x.shape[0],
            "balanced_kmeans: n_clusters=%d > n_rows=%d", n_clusters,
            x.shape[0])
    obs.counter("raft.kmeans_balanced.em_sweeps").inc(n_iters)
    if init_idx is None:
        init_idx = sample_rows(x.shape[0], n_clusters, seed, x.device)
    centers0 = take_rows(x, torch.as_tensor(init_idx, device=x.device))
    return _em(x, centers0, n_clusters, n_iters, balance_threshold,
               kernel_precision)


def build_hierarchical(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                       max_train_points: int = 1 << 18, seed: int = 0,
                       kernel_precision: Optional[str] = None,
                       res=None) -> torch.Tensor:
    """Train on a ``max_train_points`` subsample: flat balanced EM up to
    ``FLAT_MAX_CLUSTERS`` centres; above that two levels, as the JAX
    package does: ``isqrt(n_clusters)`` mesoclusters, ``km`` fine
    centres trained in each (its rows padded to a power of two by
    repeating them), then ``max(2, n_iters // 4)`` balancing sweeps over
    all centres. ``kernel_precision`` reaches every sweep."""
    ensure_resources(res, x.device)
    x = x.float()
    n = x.shape[0]
    if n > max_train_points:
        xt = take_rows(x, sample_rows(n, max_train_points, seed, x.device))
    else:
        xt = x
    if n_clusters <= FLAT_MAX_CLUSTERS:
        obs.counter("raft.kmeans_balanced.build.total", path="flat").inc()
        return balanced_kmeans(xt, n_clusters, n_iters, seed=seed,
                               kernel_precision=kernel_precision)
    obs.counter("raft.kmeans_balanced.build.total", path="two_level").inc()
    n_meso = math.isqrt(n_clusters)
    km = -(-n_clusters // n_meso)          # fine centres per mesocluster
    meso_centers = balanced_kmeans(xt, n_meso, n_iters, seed=seed,
                                   kernel_precision=kernel_precision)
    meso_labels = predict(xt, meso_centers)
    # the rows of each mesocluster, in row order (one host sync)
    order = torch.argsort(meso_labels.long(), stable=True)
    sizes = torch.bincount(meso_labels.long(), minlength=n_meso).tolist()
    starts = np.concatenate([[0], np.cumsum(sizes)])
    centers = []
    for m in range(n_meso):
        pts = xt[order[starts[m]:starts[m + 1]]]
        c = meso_centers[m][None, :]
        if pts.shape[0] == 0:
            centers.append(c.expand(km, -1))
        elif pts.shape[0] <= km:
            centers.append(torch.cat([pts, c.expand(km - pts.shape[0], -1)]))
        else:
            target = 1 << max(km.bit_length(),
                              (pts.shape[0] - 1).bit_length())
            reps = -(-target // pts.shape[0])
            centers.append(balanced_kmeans(
                pts.repeat(reps, 1)[:target], km, max(4, n_iters // 2),
                seed=seed + m + 1, kernel_precision=kernel_precision))
    all_centers = torch.cat(centers)[:n_clusters].contiguous()
    rounds = max(2, n_iters // 4)
    obs.counter("raft.kmeans_balanced.balancing_rounds").inc(rounds)
    return _em(xt, all_centers, n_clusters, rounds, 0.25, kernel_precision)

"""Balanced k-means — the IVF index trainer (counterpart of
``raft_tpu.cluster.kmeans_balanced``).

Each EM sweep assigns every row to its nearest centre with the fused
L2-NN kernel, recomputes centres from per-cluster sums (``index_add_``),
and re-seeds clusters below ``balance_threshold`` of the average size
from the highest-cost rows. The JAX package picks those rows with
``lax.approx_max_k``; the port uses the exact ``torch.topk`` (on the
CPU the JAX operator is exact too, so the two agree there).

Only the flat path of :func:`build_hierarchical` (``n_clusters <=
16384``) is ported; the two-level path raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn
from raft_tpu_torch.util.host_sample import sample_rows, take_rows

FLAT_MAX_CLUSTERS = 16384


def _nn(x: torch.Tensor, centers: torch.Tensor):
    kv = fused_l2_nn(x, centers, sqrt=False)
    return kv.key, kv.value


def predict(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre labels (int32)."""
    labels, _ = _nn(x.float(), centers.float())
    return labels


def _em(x: torch.Tensor, centers: torch.Tensor, n_clusters: int,
        n_iters: int, balance_threshold: float) -> torch.Tensor:
    n, dim = x.shape
    avg = n / n_clusters
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        labels, d = _nn(x, centers)
        lab = labels.long()
        counts = torch.zeros(n_clusters, device=x.device).index_add_(
            0, lab, ones)
        sums = torch.zeros((n_clusters, dim), device=x.device).index_add_(
            0, lab, x)
        new_centers = sums / torch.where(counts == 0.0,
                                         torch.ones_like(counts),
                                         counts)[:, None]
        small = counts < balance_threshold * avg
        worst = torch.topk(d, n_clusters, largest=True, sorted=True).indices
        slot = torch.cumsum(small.to(torch.int64), 0) - 1
        seeds = x[worst]
        centers = torch.where(small[:, None],
                              seeds[slot.clamp(0, n_clusters - 1)],
                              new_centers)
    return centers


def balanced_kmeans(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                    balance_threshold: float = 0.25, seed: int = 0,
                    init_idx: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Train ``n_clusters`` balanced centres → (n_clusters, dim).

    Initial centres are the rows ``init_idx`` (default: the host-side
    draw ``sample_rows(n, n_clusters, seed)``)."""
    x = x.float()
    expects(n_clusters <= x.shape[0],
            "balanced_kmeans: n_clusters=%d > n_rows=%d", n_clusters,
            x.shape[0])
    obs.counter("raft.kmeans_balanced.em_sweeps").inc(n_iters)
    if init_idx is None:
        init_idx = sample_rows(x.shape[0], n_clusters, seed, x.device)
    centers0 = take_rows(x, torch.as_tensor(init_idx, device=x.device))
    return _em(x, centers0, n_clusters, n_iters, balance_threshold)


def build_hierarchical(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                       max_train_points: int = 1 << 18,
                       seed: int = 0) -> torch.Tensor:
    """Train on a ``max_train_points`` subsample with flat balanced EM.
    The JAX package's two-level path (``n_clusters > 16384``) is not
    ported yet."""
    x = x.float()
    n = x.shape[0]
    if n > max_train_points:
        xt = take_rows(x, sample_rows(n, max_train_points, seed, x.device))
    else:
        xt = x
    if n_clusters <= FLAT_MAX_CLUSTERS:
        obs.counter("raft.kmeans_balanced.build.total", path="flat").inc()
        return balanced_kmeans(xt, n_clusters, n_iters, seed=seed)
    raise NotImplementedError(
        f"build_hierarchical: n_clusters={n_clusters} > "
        f"{FLAT_MAX_CLUSTERS} needs the two-level trainer, not ported yet")

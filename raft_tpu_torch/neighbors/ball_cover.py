"""Random ball cover k-NN (counterpart of ``raft_tpu.neighbors.ball_cover``).

√n landmarks from balanced k-means, every point bucketed under its
nearest landmark (``ivf_flat._bucketize``), each ball's radius kept. A
query ranks the balls by the triangle-inequality bound ``d(q, L) -
radius_L`` and scans them in that order, stopping once no query's next
ball can beat its k-th best (the JAX package's ``lax.while_loop``, here
a Python loop with one host check a step). With ``n_probes`` = all
landmarks the search is exact.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import _pairwise, as_device_tensor
from raft_tpu_torch.neighbors.ivf_flat import _bucketize
from raft_tpu_torch.ops._util import stable_topk_min

_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.Haversine,
            DistanceType.L2SqrtUnexpanded)


@dataclass
class BallCoverIndex:
    landmarks: torch.Tensor       # (n_l, dim)
    lists_data: torch.Tensor      # (n_l, max_list, dim)
    lists_indices: torch.Tensor   # (n_l, max_list) int32, -1 = pad
    radii: torch.Tensor           # (n_l,) max landmark -> member distance
    metric: DistanceType
    size: int

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]


def _ball_dists(q: torch.Tensor, vecs: torch.Tensor,
                metric: DistanceType) -> torch.Tensor:
    """Distance of each query ``q`` (nq, dim) to the rows of its own
    ball ``vecs`` (nq, max_list, dim) → (nq, max_list); the batched form
    of one ``_pairwise`` call per query."""
    if metric == DistanceType.Haversine:
        lat1, lon1 = q[:, 0:1], q[:, 1:2]
        lat2, lon2 = vecs[..., 0], vecs[..., 1]
        sdlat = torch.sin(0.5 * (lat2 - lat1))
        sdlon = torch.sin(0.5 * (lon2 - lon1))
        a = (sdlat * sdlat
             + torch.cos(lat1) * torch.cos(lat2) * sdlon * sdlon)
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    if metric == DistanceType.L2SqrtUnexpanded:
        diff = q[:, None, :] - vecs
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    qq = (q * q).sum(-1)
    vv = (vecs * vecs).sum(-1)
    ip = torch.einsum("qd,qld->ql", q, vecs)
    return torch.sqrt(torch.clamp(qq[:, None] + vv - 2.0 * ip, min=0.0))


def build(dataset, metric: DistanceType = DistanceType.L2SqrtExpanded,
          n_landmarks: int = 0, res=None, device=None) -> BallCoverIndex:
    """√n landmarks (balanced k-means), members bucketed, ball radii
    kept; on ``device`` (default ``cuda``; ``"cpu"`` only when asked)."""
    dev = ensure_resources(res, device).device
    x = as_device_tensor(dataset, dev).float()
    n = x.shape[0]
    if n_landmarks <= 0:
        n_landmarks = max(1, int(math.isqrt(n)))
    expects(metric in _METRICS,
            "ball_cover supports L2/haversine metrics (reference limitation)")
    landmarks = kmeans_balanced.balanced_kmeans(x, n_landmarks)
    labels = kmeans_balanced.predict(x, landmarks)
    data, idx, _, _ = _bucketize(x, labels, n_landmarks, compute_norms=False)
    mdist = _ball_dists(landmarks, data, metric)
    radii = torch.where(idx >= 0, mdist, 0.0).amax(dim=1)
    return BallCoverIndex(landmarks=landmarks, lists_data=data,
                          lists_indices=idx, radii=radii, metric=metric,
                          size=n)


def index_from_numpy(arrays: dict, metric, size: int,
                     device="cuda") -> BallCoverIndex:
    """A :class:`BallCoverIndex` from numpy arrays (the fields of the
    JAX package's ``BallCoverIndex``: ``landmarks``, ``lists_data``,
    ``lists_indices``, ``radii``) on ``device``."""
    dev = ensure_resources(None, device).device

    def put(name, dtype):
        return torch.from_numpy(
            np.array(arrays[name], dtype=dtype)).to(dev)

    return BallCoverIndex(landmarks=put("landmarks", np.float32),
                          lists_data=put("lists_data", np.float32),
                          lists_indices=put("lists_indices", np.int32),
                          radii=put("radii", np.float32),
                          metric=DistanceType(int(metric)), size=int(size))


def knn_query(index: BallCoverIndex, queries, k: int, n_probes: int = 0,
              prune: bool = True, res=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN through the ball cover → ``(dists, ids int32)`` (nq, k).

    Balls are scanned in order of their lower bound; with ``prune`` the
    scan stops once every query's next ball is excluded by ``bound >
    kth_best``. ``n_probes`` caps the depth (0 → every landmark when
    pruning, else ``2·√n_l + 1``)."""
    ensure_resources(res, index.landmarks.device)
    q = as_device_tensor(queries, index.landmarks.device).float()
    nq = q.shape[0]
    n_l = index.n_landmarks
    if n_probes <= 0:
        n_probes = n_l if prune else min(n_l,
                                         max(1, 2 * int(math.isqrt(n_l)) + 1))
    n_probes = min(n_probes, n_l)
    d_ql = _pairwise(q, index.landmarks, index.metric, 2.0)   # (nq, n_l)
    lower = torch.clamp(d_ql - index.radii[None, :], min=0.0)
    lb_ordered, order = stable_topk_min(lower, n_probes)
    best_d = torch.full((nq, k), float("inf"), device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=q.device)
    for p in range(n_probes):
        if prune and not bool((lb_ordered[:, p] < best_d[:, k - 1]).any()):
            break
        ball = order[:, p]
        ids = index.lists_indices[ball]                      # (nq, max_list)
        d = _ball_dists(q, index.lists_data[ball], index.metric)
        d = torch.where(ids >= 0, d, float("inf"))
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        best_d, sel = stable_topk_min(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d, best_i


def all_knn_query(index: BallCoverIndex, k: int, n_probes: int = 0,
                  res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-points k-NN over the indexed dataset itself."""
    ensure_resources(res, index.landmarks.device)
    dim = index.landmarks.shape[1]
    flat = index.lists_data.reshape(-1, dim)
    ids = index.lists_indices.reshape(-1)
    valid = ids >= 0
    x = torch.zeros((index.size, dim), dtype=flat.dtype, device=flat.device)
    x[ids[valid].long()] = flat[valid]
    return knn_query(index, x, k, n_probes)

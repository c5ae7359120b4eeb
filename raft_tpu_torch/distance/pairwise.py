"""Pairwise distances (counterpart of ``raft_tpu.distance.pairwise``).

Two families, split as the JAX package splits them:

* **Expanded** — metrics that are one matrix product plus row and column
  statistics (L2 with and without sqrt, cosine, correlation, inner
  product, hellinger, russellrao, jaccard, dice): one ``torch.matmul``
  under :func:`full_fp32_matmul` and an elementwise epilogue, as the JAX
  package leaves them to XLA.
* **Elementwise** — a nonlinearity per (x_ik, y_jk) (L1, L2 unexpanded,
  Linf, Canberra, Lp, Hamming, Jensen-Shannon, KL, Bray-Curtis):
  ``ops.elementwise_dist``, the hand-written kernel for CUDA tensors and
  its plain version for CPU tensors. The JAX package picks its Pallas
  kernel with ``RAFT_TPU_PALLAS``; the port dispatches on the tensor's
  device instead.

Haversine is plain torch. Everything is computed in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import (DISTANCE_TYPES,
                                                    SUPPORTED_DISTANCES,
                                                    DistanceType)
from raft_tpu_torch.ops import elementwise_dist as _elt


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def as_device_tensor(a, device: torch.device) -> torch.Tensor:
    """``a`` (tensor or array-like) as a tensor on ``device``."""
    return torch.as_tensor(a).to(device)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y.T in full float32."""
    full_fp32_matmul()
    return torch.matmul(_f32(x), _f32(y).T)


def _l2_expanded(x, y, sqrt: bool) -> torch.Tensor:
    xx = (_f32(x) * _f32(x)).sum(dim=1)
    yy = (_f32(y) * _f32(y)).sum(dim=1)
    d = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * _dot(x, y), min=0.0)
    return torch.sqrt(d) if sqrt else d


def _cosine(x, y) -> torch.Tensor:
    xn = torch.sqrt((_f32(x) ** 2).sum(dim=1))
    yn = torch.sqrt((_f32(y) ** 2).sum(dim=1))
    denom = xn[:, None] * yn[None, :]
    return 1.0 - _dot(x, y) / torch.where(denom == 0.0, 1.0, denom)


def _correlation(x, y) -> torch.Tensor:
    # 1 - pearson(x_i, y_j): numer = k<x,y> - sum(x)sum(y),
    # denom = sqrt(k x2 - sx^2) sqrt(k y2 - sy^2)
    k = x.shape[1]
    xf, yf = _f32(x), _f32(y)
    sx, sy = xf.sum(dim=1), yf.sum(dim=1)
    x2, y2 = (xf * xf).sum(dim=1), (yf * yf).sum(dim=1)
    numer = k * _dot(x, y) - sx[:, None] * sy[None, :]
    dx = torch.sqrt(torch.clamp(k * x2 - sx * sx, min=0.0))
    dy = torch.sqrt(torch.clamp(k * y2 - sy * sy, min=0.0))
    denom = dx[:, None] * dy[None, :]
    return 1.0 - numer / torch.where(denom == 0.0, 1.0, denom)


def _hellinger(x, y) -> torch.Tensor:
    ip = _dot(torch.sqrt(_f32(x)), torch.sqrt(_f32(y)))
    return torch.sqrt(torch.clamp(1.0 - torch.clamp(ip, max=1.0), min=0.0))


def _russellrao(x, y) -> torch.Tensor:
    k = x.shape[1]
    return (k - _dot(x, y)) / float(k)


def _set_terms(x, y):
    xb, yb = _f32(x != 0), _f32(y != 0)
    return _dot(xb, yb), xb.sum(dim=1), yb.sum(dim=1)


def _jaccard(x, y) -> torch.Tensor:
    inter, nx, ny = _set_terms(x, y)
    union = nx[:, None] + ny[None, :] - inter
    return 1.0 - inter / torch.where(union == 0.0, 1.0, union)


def _dice(x, y) -> torch.Tensor:
    inter, nx, ny = _set_terms(x, y)
    denom = nx[:, None] + ny[None, :]
    return 1.0 - 2.0 * inter / torch.where(denom == 0.0, 1.0, denom)


def _haversine(x, y) -> torch.Tensor:
    # great-circle distance over (lat, lon) radian pairs
    expects(x.shape[1] == 2, "haversine requires 2-d (lat, lon) inputs")
    lat1, lon1 = _f32(x[:, 0])[:, None], _f32(x[:, 1])[:, None]
    lat2, lon2 = _f32(y[:, 0])[None, :], _f32(y[:, 1])[None, :]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = torch.sin(0.5 * (lon2 - lon1))
    a = sdlat * sdlat + torch.cos(lat1) * torch.cos(lat2) * sdlon * sdlon
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


# elementwise-family metrics: DistanceType -> (kernel tag, sqrt)
ELT_KERNEL = {
    DistanceType.L1: ("l1", False),
    DistanceType.L2Unexpanded: ("l2unexp", False),
    DistanceType.L2SqrtUnexpanded: ("l2unexp", True),
    DistanceType.Linf: ("linf", False),
    DistanceType.Canberra: ("canberra", False),
    DistanceType.LpUnexpanded: ("minkowski", False),
    DistanceType.BrayCurtis: ("braycurtis", False),
    DistanceType.JensenShannon: ("jensen_shannon", False),
    DistanceType.HammingUnexpanded: ("hamming", False),
    DistanceType.KLDivergence: ("kl", False),
}

_EXPANDED = {
    DistanceType.L2Expanded: lambda x, y: _l2_expanded(x, y, False),
    DistanceType.L2SqrtExpanded: lambda x, y: _l2_expanded(x, y, True),
    DistanceType.CosineExpanded: _cosine,
    DistanceType.InnerProduct: _dot,
    DistanceType.CorrelationExpanded: _correlation,
    DistanceType.JaccardExpanded: _jaccard,
    DistanceType.HellingerExpanded: _hellinger,
    DistanceType.Haversine: _haversine,
    DistanceType.RusselRaoExpanded: _russellrao,
    DistanceType.DiceExpanded: _dice,
}


def _pairwise(x: torch.Tensor, y: torch.Tensor, metric: DistanceType,
              metric_arg: float) -> torch.Tensor:
    """(m, n) float32 distances of two tensors on one device."""
    if metric in ELT_KERNEL:
        tag, sqrt = ELT_KERNEL[metric]
        return _elt.elementwise_dist(_f32(x), _f32(y), tag, p=metric_arg,
                                     sqrt=sqrt)
    fn = _EXPANDED.get(metric)
    if fn is None:
        raise ValueError(f"Unknown or unsupported distance metric '{metric}'!")
    return fn(x, y)


def distance(x, y, metric: DistanceType, metric_arg: float = 2.0,
             res=None, device=None) -> torch.Tensor:
    """Distances under a :class:`DistanceType` (reference
    ``raft::distance::distance<>``), on ``device`` (default ``cuda``;
    ``"cpu"`` only when asked)."""
    dev = ensure_resources(res, device).device
    x, y = as_device_tensor(x, dev), as_device_tensor(y, dev)
    expects(x.dim() == 2 and y.dim() == 2, "distance: inputs must be rank-2")
    expects(x.shape[1] == y.shape[1],
            "Inputs must have same number of columns. a=%s, b=%s",
            x.shape[1], y.shape[1])
    return _pairwise(x, y, DistanceType(metric), float(metric_arg))


def pairwise_distance(x, y, metric: str = "euclidean",
                      metric_arg: float = 2.0, p: Optional[float] = None,
                      res=None, device=None) -> torch.Tensor:
    """All-pairs distances between rows of ``x`` (m, k) and ``y`` (n, k)
    → (m, n) float32, as ``pylibraft.distance.pairwise_distance`` names
    the metrics. ``p`` is the Minkowski exponent alias."""
    if metric not in SUPPORTED_DISTANCES:
        raise ValueError("metric %s is not supported" % metric)
    if p is not None:
        metric_arg = p
    return distance(x, y, DISTANCE_TYPES[metric], metric_arg, res=res,
                    device=device)

"""Moment and summary statistics (counterpart of
``raft_tpu.stats.moments``): means, sums, variances, covariance,
min/max, weighted means, the per-column histogram and the dispersion of
centroids, in float32 on the device of the input (or ``res``'s).

``histogram`` bins as the JAX package does, so values on a bin edge
land in the same bin: ``int((x - lower) / width)`` truncated toward 0
and clipped to [0, n_bins), ``width = (upper - lower) / n_bins`` in
float32; without ``upper``, the maximum nudged up by 1e-6 * max(|max|,
1) so that it falls in the last bin; constant data (width 0) all in
bin 0. Counts are exact (a ``bincount``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.core.precision import full_fp32_matmul


def _f32(data, res) -> torch.Tensor:
    return as_array(data, input_device(res, data)).float()


def mean(data, along_rows: bool = False, res=None) -> torch.Tensor:
    """Column means (per-row with ``along_rows``)."""
    return _f32(data, res).mean(dim=1 if along_rows else 0)


def sum_(data, along_rows: bool = False, res=None) -> torch.Tensor:
    return _f32(data, res).sum(dim=1 if along_rows else 0)


def meanvar(data, sample: bool = True, res=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (mean, variance); ``sample`` divides by n - 1."""
    data = _f32(data, res)
    return data.mean(dim=0), data.var(dim=0, correction=int(sample))


def vars_(data, mu=None, sample: bool = True, res=None) -> torch.Tensor:
    data = _f32(data, res)
    if mu is None:
        return data.var(dim=0, correction=int(sample))
    mu = as_array(mu, data.device)
    n = data.shape[0]
    ss = ((data - mu[None, :]) ** 2).sum(dim=0)
    return ss / (n - 1 if sample else n)


def stddev(data, mu=None, sample: bool = True, res=None) -> torch.Tensor:
    return torch.sqrt(vars_(data, mu, sample, res))


def mean_center(data, mu=None, along_rows: bool = False, res=None
                ) -> torch.Tensor:
    """Per-column (or per-row) means subtracted."""
    data = _f32(data, res)
    mu = mean(data, along_rows) if mu is None else as_array(mu, data.device)
    return data - (mu[:, None] if along_rows else mu[None, :])


def mean_add(data, mu, along_rows: bool = False, res=None) -> torch.Tensor:
    data = _f32(data, res)
    mu = as_array(mu, data.device)
    return data + (mu[:, None] if along_rows else mu[None, :])


def cov(data, mu=None, sample: bool = True, stable: bool = True,
        res=None) -> torch.Tensor:
    """Covariance of rows-as-samples; ``stable`` centres first (two
    passes), else E[xy] - E[x]E[y]."""
    full_fp32_matmul()
    data = _f32(data, res)
    n = data.shape[0]
    denom = n - 1 if sample else n
    mu = data.mean(dim=0) if mu is None else as_array(mu, data.device)
    if stable:
        c = data - mu[None, :]
        return (c.T @ c) / denom
    return (data.T @ data - n * torch.outer(mu, mu)) / denom


def minmax(data, res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max)."""
    data = as_array(data, input_device(res, data))
    return data.amin(dim=0), data.amax(dim=0)


def weighted_mean(data, weights, along_rows: bool = True, res=None
                  ) -> torch.Tensor:
    """Weighted mean per row (weights over the columns; default) or per
    column (weights over the rows)."""
    full_fp32_matmul()
    data = _f32(data, res)
    w = as_array(weights, data.device).float()
    if along_rows:
        return (data @ w) / w.sum()
    return (w @ data) / w.sum()


def row_weighted_mean(data, weights, res=None) -> torch.Tensor:
    return weighted_mean(data, weights, True, res)


def col_weighted_mean(data, weights, res=None) -> torch.Tensor:
    return weighted_mean(data, weights, False, res)


def _bound(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def histogram(data, n_bins: int, lower: Optional[float] = None,
              upper: Optional[float] = None, res=None) -> torch.Tensor:
    """Per-column histogram over [lower, upper) → (n_bins, n_cols)
    int32 (module doc: the binning)."""
    data = _f32(data, res)
    if data.dim() == 1:
        data = data[:, None]
    lo = data.min() if lower is None else lower
    if upper is None:
        hi = data.max()
        upper = hi + 1e-6 * torch.clamp(hi.abs(), min=1.0)
    width = _bound((upper - lo) / n_bins, data.device)
    safe = torch.where(width > 0, width, torch.ones_like(width))
    diff = data - (lo if isinstance(lo, torch.Tensor) else _bound(
        lo, data.device))
    bins = torch.clamp((diff / safe).to(torch.int32), 0, n_bins - 1).long()
    n_cols = data.shape[1]
    flat = (torch.arange(n_cols, device=data.device)[None, :] * n_bins
            + bins).reshape(-1)
    counts = torch.bincount(flat, minlength=n_cols * n_bins)
    return counts.reshape(n_cols, n_bins).T.to(torch.int32)


def dispersion(centroids, cluster_sizes, global_centroid=None,
               n_points: Optional[int] = None, res=None) -> torch.Tensor:
    """Size-weighted dispersion of centroids around the global centroid
    (used by information_criterion)."""
    c = _f32(centroids, res)
    sizes = as_array(cluster_sizes, c.device).float()
    if n_points is None:
        n_points = sizes.sum()
    if global_centroid is None:
        global_centroid = (c * sizes[:, None]).sum(dim=0) / n_points
    g = as_array(global_centroid, c.device)
    d2 = ((c - g[None, :]) ** 2).sum(dim=1)
    return torch.sqrt((sizes * d2).sum())

"""Regression and classification metrics (counterpart of
``raft_tpu.stats.regression``): accuracy, r², mean squared error and the
reference's regression_metrics (mean and median absolute error, mean
squared error), in float32."""

from __future__ import annotations

from typing import Dict

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def _pair(a, b, res, f32: bool = True):
    dev = input_device(res, a, b)
    a, b = as_array(a, dev), as_array(b, dev)
    return (a.float(), b.float()) if f32 else (a, b)


def accuracy(predictions, ref_predictions, res=None) -> torch.Tensor:
    """Fraction of exact matches."""
    p, r = _pair(predictions, ref_predictions, res, f32=False)
    return (p == r).float().mean()


def r2_score(y, y_hat, res=None) -> torch.Tensor:
    """Coefficient of determination."""
    y, y_hat = _pair(y, y_hat, res)
    ss_res = ((y - y_hat) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot


def mean_squared_error(y, y_hat, res=None) -> torch.Tensor:
    y, y_hat = _pair(y, y_hat, res)
    return ((y - y_hat) ** 2).mean()


def _median(v: torch.Tensor) -> torch.Tensor:
    """The median, the mean of the two middle values at an even count."""
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def regression_metrics(predictions, ref_predictions, res=None
                       ) -> Dict[str, torch.Tensor]:
    """{mean_abs_error, mean_squared_error, median_abs_error}."""
    p, r = _pair(predictions, ref_predictions, res)
    err = p - r
    return {"mean_abs_error": err.abs().mean(),
            "mean_squared_error": (err * err).mean(),
            "median_abs_error": _median(err.abs())}

"""Gram / kernel matrices (counterpart of ``raft_tpu.distance.kernels``).

Each kernel is one full-float32 matrix product plus an elementwise
epilogue:

  LINEAR      K = X Y^T
  POLYNOMIAL  K = (gamma X Y^T + coef0)^degree
  TANH        K = tanh(gamma X Y^T + coef0)
  RBF         K = exp(-gamma ||x-y||^2)   (expanded-L2 formulation)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.pairwise import _dot, as_device_tensor


class KernelType(enum.IntEnum):
    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


@dataclass(frozen=True)
class KernelParams:
    """The reference's POD struct (``distance_types.hpp:80-87``)."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


def gram_matrix(x, y, params: KernelParams = KernelParams(), res=None,
                device=None) -> torch.Tensor:
    """The (m, n) Gram matrix K(x_i, y_j), on ``device`` (default
    ``cuda``; ``"cpu"`` only when asked)."""
    dev = ensure_resources(res, device).device
    x, y = as_device_tensor(x, dev).float(), as_device_tensor(y, dev).float()
    kernel = KernelType(params.kernel)
    ip = _dot(x, y)
    if kernel == KernelType.LINEAR:
        return ip
    if kernel == KernelType.POLYNOMIAL:
        return (params.gamma * ip + params.coef0) ** int(params.degree)
    if kernel == KernelType.TANH:
        return torch.tanh(params.gamma * ip + params.coef0)
    if kernel == KernelType.RBF:
        xx = (x * x).sum(dim=1)
        yy = (y * y).sum(dim=1)
        d2 = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * ip, min=0.0)
        return torch.exp(-params.gamma * d2)
    raise ValueError(f"unknown kernel type {kernel}")

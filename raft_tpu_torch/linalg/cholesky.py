"""Rank-1 Cholesky update (counterpart of ``raft_tpu.linalg.cholesky``):
extend the lower factor L of A[:n, :n] to A[:n+1, :n+1] given the new
column — one triangular solve b = L⁻¹ a[:n] and d = sqrt(a[n] - bᵀb)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.core.precision import full_fp32_matmul


def cholesky_r1_update(l_factor, new_col, eps: float = 0.0, res=None
                       ) -> torch.Tensor:
    """Extend lower-triangular ``l_factor`` (n, n) with ``new_col``
    (n+1,) → the (n+1, n+1) factor; ``eps`` is added to the new diagonal
    entry before the square root."""
    full_fp32_matmul()
    dev = input_device(res, l_factor, new_col)
    l_factor = as_array(l_factor, dev).float()
    new_col = as_array(new_col, dev).float()
    n = l_factor.shape[0]
    expects(new_col.shape[0] == n + 1, "cholesky_r1_update: need n+1 entries")
    if n == 0:
        return torch.sqrt(torch.clamp(new_col[:1, None],
                                      min=eps if eps > 0 else 0.0))
    b = torch.linalg.solve_triangular(l_factor, new_col[:n, None],
                                      upper=False)[:, 0]
    d = torch.sqrt(torch.clamp(new_col[n] - torch.dot(b, b) + eps, min=0.0))
    out = torch.zeros((n + 1, n + 1), dtype=l_factor.dtype, device=dev)
    out[:n, :n] = l_factor
    out[n, :n] = b
    out[n, n] = d
    return out

"""Least squares (counterpart of ``raft_tpu.linalg.lstsq``): the
reference's four algorithms — through the SVD (``lstsq_svd_qr``, and
``lstsq_svd_jacobi`` on the same backend), the normal equations through
eigh (``lstsq_eig``), and QR (``lstsq_qr``: R x = Qᵀ b). Singular
values (eigenvalues) below 1e-7 of the largest are dropped, as in the
JAX package."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.linalg.svd import thin_svd


def _ab(a, b, res):
    full_fp32_matmul()
    dev = input_device(res, a, b)
    return as_array(a, dev).float(), as_array(b, dev).float()


def _via_svd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    u, s, vt = thin_svd(a)
    keep = s > 1e-7 * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    ub = u.T @ b
    return vt.T @ (s_inv[:, None] * ub if ub.dim() == 2 else s_inv * ub)


def lstsq_svd_qr(a, b, res=None) -> torch.Tensor:
    """min ||Ax - b|| via the SVD."""
    return _via_svd(*_ab(a, b, res))


def lstsq_svd_jacobi(a, b, res=None) -> torch.Tensor:
    """The reference's Jacobi-SVD variant; the same backend here."""
    return _via_svd(*_ab(a, b, res))


def lstsq_eig(a, b, res=None) -> torch.Tensor:
    """Normal equations (AᵀA) x = Aᵀb through eigh."""
    a, b = _ab(a, b, res)
    w, v = torch.linalg.eigh(a.T @ a)
    keep = w > 1e-7 * w.max()
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w))
    vb = v.T @ (a.T @ b)
    return v @ (w_inv[:, None] * vb if vb.dim() == 2 else w_inv * vb)


def lstsq_qr(a, b, res=None) -> torch.Tensor:
    """QR: R x = Qᵀ b by a triangular solve."""
    a, b = _ab(a, b, res)
    q, r = torch.linalg.qr(a)
    qb = q.T @ b
    x = torch.linalg.solve_triangular(
        r, qb[:, None] if qb.dim() == 1 else qb, upper=True)
    return x[:, 0] if qb.dim() == 1 else x

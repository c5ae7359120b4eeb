"""Singular value decomposition family (counterpart of
``raft_tpu.linalg.svd``): ``svd_qr`` (``torch.linalg.svd``, cuSOLVER's
``gesvd`` on the card), ``svd_eig`` (through the eigendecomposition of
AᵀA, the tall-skinny path), ``svd_jacobi`` (the same backend as
``svd_qr``), ``svd_reconstruction`` and ``rsvd``, the randomized SVD. V
is returned, not Vᵀ, as the reference does. ``rsvd``'s gaussian sketch
comes from a ``torch.Generator`` (``random.rng``), so it differs from
the JAX package's draw; the singular values it finds agree to the
method's accuracy."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.random.rng import KeyLike, _key


def thin_svd(a: torch.Tensor):
    """``torch.linalg.svd(a, full_matrices=False)``; on the card by
    cuSOLVER's QR-based ``gesvd``, the reference's svdQR (torch's default
    there, the Jacobi ``gesvdj`` at its default tolerance, reconstructs a
    4096 x 4096 float32 matrix only to ~1e-3 on the H100)."""
    return torch.linalg.svd(a, full_matrices=False,
                            driver="gesvd" if a.is_cuda else None)


def svd_qr(a, gen_u: bool = True, gen_v: bool = True, res=None):
    """Thin SVD → (U, S, V) with A = U diag(S) Vᵀ (None for a factor not
    asked for)."""
    u, s, vh = thin_svd(as_array(a, input_device(res, a)))
    return (u if gen_u else None), s, (vh.T if gen_v else None)


def svd_eig(a, res=None):
    """SVD from the eigendecomposition of AᵀA: one (k, k) eigh in place
    of an (m, k) SVD."""
    full_fp32_matmul()
    a = as_array(a, input_device(res, a)).float()
    w, v = torch.linalg.eigh(a.T @ a)  # ascending
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    u = (a @ v) / torch.where(s == 0.0, torch.ones_like(s), s)[None, :]
    return u, s, v


def svd_jacobi(a, tol: float = 1e-7, sweeps: int = 15, res=None):
    """The reference's Jacobi SVD; ``tol`` and ``sweeps`` are taken for
    API parity and the factorisation is ``svd_qr``'s."""
    return svd_qr(a, res=res)


def svd_reconstruction(u, s, v, res=None) -> torch.Tensor:
    """U diag(S) Vᵀ."""
    full_fp32_matmul()
    dev = input_device(res, u, s, v)
    u, s, v = as_array(u, dev), as_array(s, dev), as_array(v, dev)
    return (u * s[None, :]) @ v.T


def rsvd(a, k: int, p: Optional[int] = None, n_iter: int = 2,
         seed: KeyLike = 0, res=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized SVD: a gaussian sketch of k + p columns (``p``
    defaults to max(5, k // 10)), ``n_iter`` power iterations with QR
    re-orthonormalization, then an exact SVD of the small projection →
    rank-k (U, S, V)."""
    full_fp32_matmul()
    a = as_array(a, input_device(res, a)).float()
    m, n = a.shape
    if p is None:
        p = max(5, k // 10)
    ell = min(n, k + p)
    g = _key(seed, a.device)
    omega = torch.randn((n, ell), generator=g, device=a.device)
    y = a @ omega
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(y)
        q, _ = torch.linalg.qr(a.T @ q)
        y = a @ q
    q, _ = torch.linalg.qr(y)
    ub, s, vt = thin_svd(q.T @ a)
    u = q @ ub
    return u[:, :k], s[:k], vt[:k].T

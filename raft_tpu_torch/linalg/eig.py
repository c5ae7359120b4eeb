"""Symmetric eigendecomposition (counterpart of ``raft_tpu.linalg.eig``):
``eig_dc`` and ``eig_dc_selective`` by ``torch.linalg.eigh`` (cuSOLVER
syevd on the card), and ``eig_jacobi``, cyclic Jacobi with the
reference's ``tol``/``sweeps`` contract.

The JAX package's Jacobi forms a full n x n rotation and two n x n
products for every pair (p, q). A rotation in the (p, q) plane changes
only rows and columns p and q, so the port applies each to those two
rows and two columns (and to two columns of V): O(n) a pair, O(n^3) a
sweep. The cyclic pair order, the rotation angle, ``tol`` and
``sweeps`` and the stopping test (``off(m) <= tol`` before a sweep) are
the JAX package's. Each pair is a handful of small tensor operations:
meant for small matrices, like the reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, input_device


def eig_dc(a, res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric eig → (eigvals ascending, eigvecs as columns)."""
    w, v = torch.linalg.eigh(as_array(a, input_device(res, a)))
    return w, v


def eig_dc_selective(a, n_eig_vals: int, largest: bool = True, res=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_eig_vals`` eigenpairs from the top (``largest``) or the bottom
    of the spectrum, ascending."""
    a = as_array(a, input_device(res, a))
    n = a.shape[0]
    expects(0 < n_eig_vals <= n, "eig_dc_selective: invalid n_eig_vals")
    w, v = torch.linalg.eigh(a)
    if largest:
        return w[n - n_eig_vals:], v[:, n - n_eig_vals:]
    return w[:n_eig_vals], v[:, :n_eig_vals]


def _off(m: torch.Tensor) -> float:
    return float(torch.sqrt((torch.tril(m, -1) ** 2).sum() * 2.0))


def _rotate_cols(t: torch.Tensor, p: int, q: int, c, s) -> None:
    """t <- t @ G for the rotation G (G[p,p] = G[q,q] = c, G[p,q] = s,
    G[q,p] = -s), in place on columns p and q."""
    tp, tq = t[:, p].clone(), t[:, q]
    t[:, p] = c * tp - s * tq
    t[:, q] = s * tp + c * tq


def eig_jacobi(a, tol: float = 1e-7, sweeps: int = 15, res=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic Jacobi → (eigvals ascending, eigvecs as columns)."""
    m = as_array(a, input_device(res, a)).float().clone()
    n = m.shape[0]
    v = torch.eye(n, dtype=m.dtype, device=m.device)
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    sweep = 0
    while sweep < sweeps and _off(m) > tol:
        for p, q in pairs:
            theta = 0.5 * torch.atan2(2.0 * m[p, q], m[q, q] - m[p, p])
            c, s = torch.cos(theta), torch.sin(theta)
            # m <- G^T m G: columns p, q, then rows p, q
            _rotate_cols(m, p, q, c, s)
            _rotate_cols(m.T, p, q, c, s)
            _rotate_cols(v, p, q, c, s)
        sweep += 1
    w = torch.diagonal(m)
    order = torch.argsort(w, stable=True)
    return w[order], v[:, order]

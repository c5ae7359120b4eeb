"""Lanczos eigensolver for sparse symmetric matrices (counterpart of
``raft_tpu.sparse.solver.lanczos``).

m Lanczos steps with full reorthogonalization (two classical
Gram-Schmidt passes a step) build the basis V and the tridiagonal T;
the eigenpairs of T (``torch.linalg.eigh``) give the Ritz values and,
through V, the Ritz vectors. On a breakdown (beta below 1e-6: the Krylov
space is exhausted) the recurrence goes on from a fresh random vector
orthogonalized against the basis, with beta 0. The start vector and the
restart pool come from a ``torch.Generator`` seeded by ``seed`` (the JAX
package draws them from ``jax.random``), so the two packages start from
other vectors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import default_resources
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.linalg import spmv

_BREAKDOWN = 1e-6


def _lanczos_basis(matvec: Callable[[torch.Tensor], torch.Tensor], m: int,
                   v0: torch.Tensor, restart_pool: torch.Tensor):
    """(V (m, n), alpha (m,), beta (m - 1,))."""
    full_fp32_matmul()
    n = v0.shape[0]
    V = torch.zeros((m, n), dtype=v0.dtype, device=v0.device)

    def orthogonalize(w):
        # rows of V not filled yet are zero
        for _ in range(2):
            w = w - V.T @ (V @ w)
        return w

    v = v0 / torch.linalg.norm(v0)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for i in range(m):
        w = matvec(v)
        alpha = torch.dot(w, v)
        w = orthogonalize(w - alpha * v - beta_prev * v_prev)
        beta = torch.linalg.norm(w)
        V[i] = v
        r = orthogonalize(restart_pool[i])
        r_norm = torch.linalg.norm(r)
        broke = beta <= _BREAKDOWN
        v_next = torch.where(
            broke, r / torch.where(r_norm > 0, r_norm, 1.0),
            w / torch.where(beta > 0, beta, 1.0))
        beta_prev = torch.where(broke, 0.0, beta)
        v_prev, v = v, v_next
        alphas.append(alpha)
        betas.append(beta_prev)
    return V, torch.stack(alphas), torch.stack(betas)[:-1]


def _eig_from_lanczos(V, alphas, betas, k: int, largest: bool):
    m = alphas.shape[0]
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    evals, evecs = torch.linalg.eigh(T)  # ascending
    sel = (torch.arange(m - 1, m - k - 1, -1) if largest
           else torch.arange(k)).to(evals.device)
    return evals[sel], (evecs[:, sel].T @ V).T


def _solve(a, k, max_iter, seed, matvec, n, largest: bool, device=None):
    if matvec is None:
        expects(a is not None, "lanczos: need a CSR matrix or a matvec")
        n = a.shape[0]
        matvec = lambda v: spmv(a, v)  # noqa: E731
    # an implicit operator without a matrix runs on ``device``, else on
    # the default one
    if a is not None:
        device = a.device
    elif device is None:
        device = default_resources().device
    expects(k >= 1 and k < n, "lanczos: need 1 <= k < n")
    m = min(n - 1 if n > 1 else 1, max_iter or max(4 * k + 16, 32))
    m = max(m, k + 1)
    g = torch.Generator(device=device).manual_seed(int(seed))
    v0 = torch.randn(n, generator=g, device=device)
    pool = torch.randn((m, n), generator=g, device=device)
    V, alphas, betas = _lanczos_basis(matvec, m, v0, pool)
    return _eig_from_lanczos(V, alphas, betas, k, largest)


def lanczos_smallest(a: CSR, k: int, max_iter: Optional[int] = None,
                     seed: int = 0,
                     matvec: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None,
                     n: Optional[int] = None, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest eigenpairs of symmetric ``a`` → (evals (k,),
    evecs (n, k)); ``matvec`` and ``n`` may stand for ``a`` (then on
    ``device``, default ``cuda``)."""
    return _solve(a, k, max_iter, seed, matvec, n, False, device)


def lanczos_largest(a: CSR, k: int, max_iter: Optional[int] = None,
                    seed: int = 0,
                    matvec: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None,
                    n: Optional[int] = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest eigenpairs of symmetric ``a``, largest first."""
    return _solve(a, k, max_iter, seed, matvec, n, True, device)

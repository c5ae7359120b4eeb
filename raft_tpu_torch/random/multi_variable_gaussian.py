"""Multi-variate gaussian sampler (counterpart of
``raft_tpu.random.multi_variable_gaussian``): N(mu, cov) through a
Cholesky factor, or the eigendecomposition for a covariance that is
positive semi-definite but singular."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.random.rng import KeyLike, _key


def multi_variable_gaussian(rng: KeyLike, n_samples: int, mu, cov,
                            method: str = "cholesky",
                            device=None) -> torch.Tensor:
    """(n_samples, dim) draws from N(mu, cov) on the generator's device.
    ``method``: "cholesky" or "eig"."""
    full_fp32_matmul()
    g = _key(rng, device)
    mu = as_array(mu, g.device).float()
    cov = as_array(cov, g.device).float()
    z = torch.randn((n_samples, mu.shape[0]), generator=g, device=g.device)
    if method == "cholesky":
        root = torch.linalg.cholesky(cov)
    else:
        evals, evecs = torch.linalg.eigh(cov)
        root = evecs * torch.sqrt(torch.clamp(evals, min=0.0))[None, :]
    return mu[None, :] + z @ root.T

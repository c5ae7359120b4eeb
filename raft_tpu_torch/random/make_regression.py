"""Regression dataset generator (counterpart of
``raft_tpu.random.make_regression``): a gaussian design (low rank plus a
tail when ``effective_rank`` is set), ``n_informative`` random
coefficients in [0, 100), optional bias, noise and shuffle → (X, y[,
coef]). One generator draws, in turn, the design, the coefficients, the
noise and the shuffle."""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.random.rng import KeyLike, _key


def make_regression(
    n_samples: int = 100,
    n_features: int = 100,
    n_informative: int = 10,
    n_targets: int = 1,
    bias: float = 0.0,
    effective_rank: Optional[int] = None,
    tail_strength: float = 0.5,
    noise: float = 0.0,
    shuffle: bool = True,
    coef: bool = False,
    seed: KeyLike = 0,
    dtype=torch.float32,
    device=None,
):
    """→ (X (n_samples, n_features), y) or (X, y, coef (n_features,
    n_targets)); y is 1-D for one target. On ``device`` (default: the
    generator's, ``cuda`` for an int seed)."""
    full_fp32_matmul()
    g = _key(seed, device)
    dev = g.device
    n_informative = min(n_features, n_informative)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    if effective_rank is None:
        x = randn(n_samples, n_features)
    else:
        # low-rank-plus-tail singular profile
        rank = min(effective_rank, n_features, n_samples)
        u, v = randn(n_samples, rank), randn(rank, n_features)
        sing = torch.exp(-torch.arange(rank, dtype=dtype, device=dev)
                         / (tail_strength * rank + 1e-6))
        x = (u * sing[None, :]) @ v / torch.sqrt(
            torch.tensor(float(rank), dtype=dtype, device=dev))
    w = torch.zeros((n_features, n_targets), dtype=dtype, device=dev)
    w[:n_informative] = 100.0 * torch.rand(
        (n_informative, n_targets), generator=g, device=dev, dtype=dtype)
    y = x @ w + bias
    if noise > 0.0:
        y = y + noise * randn(*y.shape)
    if shuffle:
        perm = torch.randperm(n_samples, generator=g, device=dev)
        x, y = x[perm], y[perm]
    y = y[:, 0] if n_targets == 1 else y
    if coef:
        return x, y, w
    return x, y

"""Shared helpers of the kernel wrappers."""

from __future__ import annotations

import torch


def round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``v``."""
    return -(-v // m) * m


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` — what every kernel launch takes."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stable_topk_min(v: torch.Tensor, k: int):
    """Per-row k smallest of ``v`` (..., n), ascending, ties to the
    lower column: the ``lax.top_k(-v, k)`` contract (``torch.topk``
    leaves the order of equal values unspecified)."""
    vals, idx = torch.sort(v, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]

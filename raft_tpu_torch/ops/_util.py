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


# the products' arithmetic: :func:`resolve_precision`
PRECISIONS = ("bf16x3", "bf16", "f32")


def resolve_precision(kernel_precision, on_cuda: bool) -> str:
    """The products' arithmetic for a ``kernel_precision`` (kernel 1,
    kernel 5's pass A), with the JAX
    package's meanings (``raft_tpu/core/precision.py``
    ``resolve_kernel_mode``): ``"bf16x3"`` (three bf16 products of each
    operand's hi/lo split, the TPU kernel's default), ``"bf16"`` (one
    product of bf16-rounded operands) or ``"f32"``. ``None`` is the
    device's default: bf16x3 on the card, f32 on the CPU (the JAX
    package's interpret mode computes at ``HIGHEST``); ``"default"`` is
    ``"bf16"``, ``"highest"`` is f32."""
    if kernel_precision is None:
        return "bf16x3" if on_cuda else "f32"
    name = str(kernel_precision).lower()
    if name == "bf16x3":
        return "bf16x3"
    if name in ("bf16", "default"):
        return "bf16"
    if name == "highest":
        return "f32"
    raise ValueError(f"kernel precision {kernel_precision!r}: want "
                     "bf16x3|bf16|highest")


def dot_nt(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b.T`` at ``precision``; bf16x3 as
    ``raft_tpu/ops/_util.py`` ``dot_nt_f32``: each operand split into
    ``hi = bf16(v)`` and ``lo = bf16(v - hi)`` (round to nearest even, as
    the kernel's ``__float2bfloat16_rn``), three full-f32 products of the
    splits (each exact) summed hi.lo + lo.hi + hi.hi. Leading dimensions
    batch."""
    if precision == "f32":
        return a @ b.transpose(-2, -1)
    ah, bh = a.bfloat16().float(), b.bfloat16().float()
    if precision == "bf16":
        return ah @ bh.transpose(-2, -1)
    al, bl = (a - ah).bfloat16().float(), (b - bh).bfloat16().float()
    acc = ah @ bl.transpose(-2, -1)
    acc += al @ bh.transpose(-2, -1)
    acc += ah @ bh.transpose(-2, -1)
    return acc

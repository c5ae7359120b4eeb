"""BLAS-level ops (counterpart of ``raft_tpu.linalg.blas``): gemm with
alpha/beta and transpose flags, gemv, axpy, dot, transpose. Products run
in full float32 (no TF32), as the JAX package's at ``HIGHEST``; gemm
accumulates in float32 for narrower inputs and returns A's dtype."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.core.precision import full_fp32_matmul


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.float()


def gemm(a, b, alpha: float = 1.0, beta: float = 0.0, c=None,
         trans_a: bool = False, trans_b: bool = False, res=None
         ) -> torch.Tensor:
    """C = alpha * op(A) @ op(B) + beta * C."""
    full_fp32_matmul()
    dev = input_device(res, a, b)
    a, b = as_array(a, dev), as_array(b, dev)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = alpha * (_f32(a) @ _f32(b))
    if c is not None and beta != 0.0:
        out = out + beta * as_array(c, dev)
    return out.to(a.dtype)


def gemv(a, x, alpha: float = 1.0, beta: float = 0.0, y=None,
         trans: bool = False, res=None) -> torch.Tensor:
    """y = alpha * op(A) @ x + beta * y."""
    full_fp32_matmul()
    dev = input_device(res, a, x)
    a, x = as_array(a, dev), as_array(x, dev)
    if trans:
        a = a.T
    out = alpha * (a @ x)
    if y is not None and beta != 0.0:
        out = out + beta * as_array(y, dev)
    return out


def axpy(alpha: float, x, y, res=None) -> torch.Tensor:
    """alpha * x + y."""
    dev = input_device(res, x, y)
    return alpha * as_array(x, dev) + as_array(y, dev)


def dot(x, y, res=None) -> torch.Tensor:
    """<x, y> in float32 (a matrix product for higher ranks)."""
    full_fp32_matmul()
    dev = input_device(res, x, y)
    return torch.matmul(as_array(x, dev).float(), as_array(y, dev).float())


def transpose(a, res=None) -> torch.Tensor:
    """Transpose (a view; ``contiguous()`` copies it)."""
    return as_array(a, input_device(res, a)).T

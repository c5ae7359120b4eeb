"""Matmul precision for distance-critical float32 products.

The JAX package runs its distance matmuls at ``Precision.HIGHEST``
(full fp32). PyTorch's counterpart is ``allow_tf32 = False``: a TF32
product keeps ~10 mantissa bits and would reorder near neighbours.
:func:`full_fp32_matmul` sets it and asserts it before every coarse
GEMM and ``torch.matmul`` on the search and build paths.

:func:`check_f32_kernel_precision` guards the ``kernel_precision``
argument of the entry points whose kernel (fused L2-NN, kernel 1)
computes in f32 only.
"""

from __future__ import annotations

import torch


def full_fp32_matmul() -> None:
    """Force full-fp32 matmuls (no TF32) and assert that it held."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "full_fp32_matmul: TF32 matmuls are still enabled"


def check_f32_kernel_precision(what: str, kernel_precision) -> None:
    """Accept the ``kernel_precision`` values the f32 fused L2-NN kernel
    computes as asked (``None``, ``"highest"``); raise
    ``NotImplementedError`` for its bf16 tiers (``"bf16x3"``, ``"bf16"``,
    ``"default"``), not ported yet (ROADMAP.md queue 2a row 1)."""
    if kernel_precision is None or str(kernel_precision).lower() == \
            "highest":
        return
    if str(kernel_precision).lower() in ("bf16x3", "bf16", "default"):
        raise NotImplementedError(
            f"{what}: kernel_precision={kernel_precision!r} is not ported "
            "yet (ROADMAP.md queue 2a row 1: the fused L2-NN kernel "
            "computes in f32)")
    raise ValueError(f"{what}: kernel precision {kernel_precision!r}: "
                     "want bf16x3|bf16|highest")

"""Matmul precision for distance-critical float32 products.

The JAX package runs its distance matmuls at ``Precision.HIGHEST``
(full fp32). PyTorch's counterpart is ``allow_tf32 = False``: a TF32
product keeps ~10 mantissa bits and would reorder near neighbours.
:func:`full_fp32_matmul` sets it and asserts it before every coarse
GEMM and ``torch.matmul`` on the search and build paths.
"""

from __future__ import annotations

import torch


def full_fp32_matmul() -> None:
    """Force full-fp32 matmuls (no TF32) and assert that it held."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "full_fp32_matmul: TF32 matmuls are still enabled"

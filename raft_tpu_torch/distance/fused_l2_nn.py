"""Fused L2 nearest neighbour, public API (counterpart of
``raft_tpu.distance.fused_l2_nn``).

For each row of ``x``, the index and (squared, or with ``sqrt``) L2
distance of its nearest row of ``y``, without the (m, n) matrix. The
work goes to ``ops.fused_l2_nn``: a CUDA kernel for CUDA tensors, the
plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.ops import fused_l2_nn as _op


def fused_l2_nn(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False,
                kernel_precision: str | None = None,
                res=None) -> KeyValuePair:
    """``KeyValuePair(key=int32 (m,), value=float32 (m,))``; ties go to
    the lowest index of ``y``. ``x`` and ``y`` must share a device.
    ``kernel_precision``: ``None`` (bf16x3 on the card, the TPU kernel's
    default; f32 on the CPU, as the JAX package's interpret mode) |
    ``"bf16x3"`` | ``"bf16"``/``"default"`` (one pass of bf16-rounded
    operands) | ``"highest"`` (f32)."""
    expects(x.dim() == 2 and y.dim() == 2, "fused_l2_nn: inputs must be rank-2")
    expects(x.shape[1] == y.shape[1], "fused_l2_nn: dim mismatch")
    expects(x.device == y.device, "fused_l2_nn: x on %s, y on %s",
            x.device, y.device)
    expects(y.shape[0] > 0, "fused_l2_nn: y has no rows")
    ensure_resources(res, x.device)
    full_fp32_matmul()
    idx, d = _op.fused_l2_nn(x.float(), y.float(), bool(sqrt),
                             kernel_precision)
    return KeyValuePair(idx, d)


def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor,
                       sqrt: bool = True, res=None) -> torch.Tensor:
    """Index-only form (``pylibraft.distance.fused_l2_nn_argmin``)."""
    return fused_l2_nn(x, y, sqrt=sqrt, res=res).key

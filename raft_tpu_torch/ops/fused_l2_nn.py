"""Fused L2 nearest neighbour: kernel wrappers and plain version.

Kernels (replacing the JAX package's Pallas ``_nn_kernel``):
``csrc/fused_l2_nn_tc.cu`` on the tensor cores for ``"bf16x3"`` (the TPU
kernel's arithmetic and the card's default) and ``"bf16"``;
``csrc/fused_l2_nn.cu``, the f32 body, for ``"f32"`` (``"highest"``).
:func:`fused_l2_nn` resolves ``kernel_precision`` by device
(:func:`~raft_tpu_torch.ops._util.resolve_precision`) and dispatches on
the device of its inputs: CPU tensors take :func:`fused_l2_nn_plain`,
CUDA tensors launch a kernel (or raise).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import INT, PTR
from raft_tpu_torch.ops._util import (PRECISIONS, check_cuda_tensor, dot_nt,
                                      resolve_precision)

# launches since the last reset (plain integers): the tensor-core kernel
# (bf16x3, bf16) and the f32 body; ``shapes`` counts the launches of both
# by (rows of x, rows of y)
launches = 0
launches_f32 = 0
shapes: dict = {}

# the plain version's blocks of x rows: at most _PLAIN_ROWS rows and
# _PLAIN_ELEMS entries of the (rows, n) distance matrix
_PLAIN_ROWS = 1 << 16
_PLAIN_ELEMS = 1 << 26


def fused_l2_nn_plain(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False,
                      precision: str = "f32"):
    """Plain PyTorch version: ``(idx int32 (m,), dist float32 (m,))``
    with ``d = max((|y|^2 + |x|^2) - 2 x.y, 0)``, the product at
    ``precision`` (``"f32"``, ``"bf16x3"``, ``"bf16"``:
    :func:`~raft_tpu_torch.ops._util.dot_nt`), the norms from the
    unrounded rows, and ties to the lowest index (``torch.min`` returns
    the first minimum)."""
    if precision not in PRECISIONS:
        raise ValueError(f"fused_l2_nn: precision {precision!r} (want "
                         f"{'|'.join(PRECISIONS)})")
    full_fp32_matmul()
    x = x.float()
    y = y.float()
    yy = (y * y).sum(dim=1)
    idx = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    dist = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    rows = max(1, min(_PLAIN_ROWS, _PLAIN_ELEMS // max(1, y.shape[0])))
    for s in range(0, x.shape[0], rows):
        xb = x[s:s + rows]
        xx = (xb * xb).sum(dim=1)
        d = torch.clamp((yy[None, :] + xx[:, None])
                        - 2.0 * dot_nt(xb, y, precision), min=0.0)
        best, arg = torch.min(d, dim=1)
        idx[s:s + xb.shape[0]] = arg.to(torch.int32)
        dist[s:s + xb.shape[0]] = best
    if sqrt:
        dist = torch.sqrt(dist)
    return idx, dist


_F32 = _build.Entry("fused_l2_nn", "raft_fused_l2_nn",
                    [PTR] * 4 + [INT] * 4 + [PTR] * 3)
_TC = _build.Entry("fused_l2_nn_tc", "raft_fused_l2_nn_tc",
                   [PTR] * 3 + [INT] * 6 + [PTR] * 5)


def _tile_bytes(n: int, d: int, passes: int) -> int:
    """Bytes of the split centres (``raft_fused_l2_nn_tc_tile_bytes``)."""
    return (-(-n // 128)) * (-(-d // 64)) * (2 if passes == 3 else 1) * 16384


def fused_l2_nn_cuda(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False,
                     precision: str = "bf16x3"):
    """Launch a kernel on contiguous float32 CUDA tensors: the tensor-core
    kernel for ``"bf16x3"`` (3 passes) and ``"bf16"`` (1 pass), the f32
    body for ``"f32"``."""
    global launches, launches_f32
    check_cuda_tensor("fused_l2_nn x", x, torch.float32, 2)
    check_cuda_tensor("fused_l2_nn y", y, torch.float32, 2)
    if precision not in PRECISIONS:
        raise ValueError(f"fused_l2_nn: precision {precision!r} (want "
                         f"{'|'.join(PRECISIONS)})")
    m, d = x.shape
    n = y.shape[0]
    if y.shape[1] != d or x.device != y.device:
        raise ValueError("fused_l2_nn: x and y disagree on dim or device")
    if n < 1:
        raise ValueError("fused_l2_nn: y has no rows")
    dev = x.device
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    dist = torch.empty(m, dtype=torch.float32, device=dev)
    xx = torch.empty(m, dtype=torch.float32, device=dev)
    stream = _build.stream_handle(dev)
    with torch.cuda.device(dev):
        if precision == "f32":
            yy = torch.empty(n, dtype=torch.float32, device=dev)
            rc = _F32(x.data_ptr(), y.data_ptr(), xx.data_ptr(),
                      yy.data_ptr(), m, n, d, int(bool(sqrt)),
                      idx.data_ptr(), dist.data_ptr(), stream)
        else:
            passes = 3 if precision == "bf16x3" else 1
            tiles = torch.empty(_tile_bytes(n, d, passes), dtype=torch.uint8,
                                device=dev)
            yyp = torch.empty(-(-n // 128) * 128, dtype=torch.float32,
                              device=dev)
            vec4 = d % 4 == 0 and x.data_ptr() % 16 == 0
            rc = _TC(x.data_ptr(), y.data_ptr(), xx.data_ptr(), m, n, d,
                     passes, int(bool(sqrt)), int(vec4), tiles.data_ptr(),
                     yyp.data_ptr(), idx.data_ptr(), dist.data_ptr(), stream)
    _build.check(rc, "fused_l2_nn")
    if precision == "f32":
        launches_f32 += 1
    else:
        launches += 1
    shapes[(m, n)] = shapes.get((m, n), 0) + 1
    return idx, dist


def fused_l2_nn(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False,
                kernel_precision=None):
    """Index and distance of the nearest row of ``y`` for every row of
    ``x`` — the plain version for CPU tensors, a kernel for CUDA.
    ``kernel_precision``: ``None`` (bf16x3 on the card, f32 on the CPU)
    | ``"bf16x3"`` | ``"bf16"``/``"default"`` | ``"highest"`` (f32)."""
    precision = resolve_precision(kernel_precision, x.is_cuda)
    if x.is_cuda:
        return fused_l2_nn_cuda(x.contiguous(), y.contiguous(), sqrt,
                                precision)
    return fused_l2_nn_plain(x, y, sqrt, precision)

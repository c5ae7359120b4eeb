"""Fused L2 nearest neighbour: kernel wrapper and plain version.

Kernel: ``csrc/fused_l2_nn.cu`` (replaces the JAX package's Pallas
``_nn_kernel``). :func:`fused_l2_nn` dispatches on the device of its
inputs: CPU tensors take :func:`fused_l2_nn_plain`, CUDA tensors launch
the kernel (or raise).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import INT, PTR
from raft_tpu_torch.ops._util import check_cuda_tensor

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0

# rows of x per block of the plain version: bounds its (rows, n) matrix
_PLAIN_ROWS = 1 << 16


def fused_l2_nn_plain(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False):
    """Plain PyTorch version: ``(idx int32 (m,), dist float32 (m,))``
    with ``d = max((|y|^2 + |x|^2) - 2 x.y, 0)`` and ties to the lowest
    index (``torch.argmin`` returns the first minimum)."""
    x = x.float()
    y = y.float()
    yy = (y * y).sum(dim=1)
    idx = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    dist = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _PLAIN_ROWS):
        xb = x[s:s + _PLAIN_ROWS]
        xx = (xb * xb).sum(dim=1)
        d = torch.clamp((yy[None, :] + xx[:, None]) - 2.0 * (xb @ y.T),
                        min=0.0)
        best, arg = torch.min(d, dim=1)
        idx[s:s + xb.shape[0]] = arg.to(torch.int32)
        dist[s:s + xb.shape[0]] = best
    if sqrt:
        dist = torch.sqrt(dist)
    return idx, dist


_FUSED_L2_NN = _build.Entry("fused_l2_nn", "raft_fused_l2_nn",
                            [PTR] * 4 + [INT] * 4 + [PTR] * 3)


def fused_l2_nn_cuda(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False):
    """Launch the CUDA kernel on contiguous float32 CUDA tensors."""
    global launches
    check_cuda_tensor("fused_l2_nn x", x, torch.float32, 2)
    check_cuda_tensor("fused_l2_nn y", y, torch.float32, 2)
    m, d = x.shape
    n = y.shape[0]
    if y.shape[1] != d or x.device != y.device:
        raise ValueError("fused_l2_nn: x and y disagree on dim or device")
    if n < 1:
        raise ValueError("fused_l2_nn: y has no rows")
    idx = torch.empty(m, dtype=torch.int32, device=x.device)
    dist = torch.empty(m, dtype=torch.float32, device=x.device)
    xx = torch.empty(m, dtype=torch.float32, device=x.device)
    yy = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _FUSED_L2_NN(x.data_ptr(), y.data_ptr(), xx.data_ptr(),
                          yy.data_ptr(), m, n, d, int(bool(sqrt)),
                          idx.data_ptr(), dist.data_ptr(),
                          _build.stream_handle(x.device))
    _build.check(rc, "fused_l2_nn")
    launches += 1
    return idx, dist


def fused_l2_nn(x: torch.Tensor, y: torch.Tensor, sqrt: bool = False):
    """Index and distance of the nearest row of ``y`` for every row of
    ``x`` — the plain version for CPU tensors, the kernel for CUDA."""
    if x.is_cuda:
        return fused_l2_nn_cuda(x.contiguous(), y.contiguous(), sqrt)
    return fused_l2_nn_plain(x, y, sqrt)

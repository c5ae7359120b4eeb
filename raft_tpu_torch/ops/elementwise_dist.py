"""Elementwise-family pairwise distances: kernel wrapper and plain version.

Kernel: ``csrc/elementwise_dist.cu`` (replaces the JAX package's Pallas
``_elt_kernel``). :func:`elementwise_dist` dispatches on the device of
its inputs: CPU tensors take :func:`elementwise_dist_plain`, CUDA tensors
launch the kernel (or raise). The kernel walks the feature dim in
chunks, so it takes every dim; the JAX package's ``MAX_DIM`` route (a
VMEM limit of its kernel) has no counterpart here.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.distance import _elementwise_cores as cores
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import F32, INT, PTR
from raft_tpu_torch.ops._util import check_cuda_tensor

# kernel tag -> the metric id of csrc/elementwise_dist.cu's enum Metric
METRIC_IDS = {tag: i for i, tag in enumerate(cores.TAGS)}

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0

# peak (rows, n, dim) f32 elements of one row tile of the plain version
_TILE_BUDGET_ELEMS = 1 << 24
# rows of x per kernel launch: the kernel's grid holds 65535 row tiles of
# 64 rows or more (csrc/elementwise_dist.cu, Cfg::kBM)
_KERNEL_ROWS = 65535 * 64


def _row_tile(m: int, n: int, k: int) -> int:
    t = max(1, _TILE_BUDGET_ELEMS // max(1, n * k))
    t = min(t, m)
    if t >= 8:
        t -= t % 8
    return t


def elementwise_dist_plain(x: torch.Tensor, y: torch.Tensor, metric: str,
                           p: float = 2.0, sqrt: bool = False
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``D[i, j] = finalize(reduce_k(combine(x_ik,
    y_jk)))`` over row tiles of x that keep the (rows, n, dim) broadcast
    under 2^24 elements (the JAX package's ``_elementwise_xla``)."""
    x, y = x.float(), y.float()
    m, k = x.shape
    n = y.shape[0]
    pair = metric in cores.PAIR_ACCUM
    out = [torch.empty((m, n), dtype=torch.float32, device=x.device)
           for _ in range(2 if pair else 1)]
    t = _row_tile(m, n, k)
    for s in range(0, m, t):
        e = cores.combine(metric, x[s:s + t, None, :], y[None, :, :], p)
        if pair:
            for o, q in zip(out, e):
                o[s:s + t] = q.sum(dim=2)
        elif metric in cores.MAX_REDUCE:
            out[0][s:s + t] = e.amax(dim=2)
        else:
            out[0][s:s + t] = e.sum(dim=2)
    return cores.finalize(metric, tuple(out) if pair else out[0], p, k, sqrt)


_ELEMENTWISE = _build.Entry(
    "elementwise_dist", "raft_elementwise_dist",
    [PTR, PTR, INT, INT, INT, INT, F32, INT, PTR, PTR])


def elementwise_dist_cuda(x: torch.Tensor, y: torch.Tensor, metric: str,
                          p: float = 2.0, sqrt: bool = False
                          ) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous float32 CUDA tensors; one
    launch per ``_KERNEL_ROWS`` rows of x."""
    global launches
    check_cuda_tensor("elementwise_dist x", x, torch.float32, 2)
    check_cuda_tensor("elementwise_dist y", y, torch.float32, 2)
    m, d = x.shape
    n = y.shape[0]
    if y.shape[1] != d or x.device != y.device:
        raise ValueError("elementwise_dist: x and y disagree on dim or device")
    if not 1 <= d < 1 << 24:
        raise ValueError("elementwise_dist: dim must be in [1, 2^24)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        for s in range(0, m, _KERNEL_ROWS):
            rows = min(_KERNEL_ROWS, m - s)
            rc = _ELEMENTWISE(x[s].data_ptr(), y.data_ptr(), rows, n, d,
                              METRIC_IDS[metric], float(p), int(bool(sqrt)),
                              out[s].data_ptr(),
                              _build.stream_handle(x.device))
            _build.check(rc, "elementwise_dist")
            launches += 1
    return out


def elementwise_dist(x: torch.Tensor, y: torch.Tensor, metric: str,
                     p: float = 2.0, sqrt: bool = False) -> torch.Tensor:
    """(m, n) float32 distances of the elementwise family — the plain
    version for CPU tensors, the kernel for CUDA. ``metric``: one of
    ``TAGS`` of ``distance/_elementwise_cores.py``."""
    if metric not in METRIC_IDS:
        raise ValueError(f"elementwise_dist: unknown metric {metric!r}")
    if x.is_cuda:
        return elementwise_dist_cuda(x.float().contiguous(),
                                     y.float().contiguous(), metric, p, sqrt)
    return elementwise_dist_plain(x, y, metric, p, sqrt)

"""Exact per-row k-selection (k <= 256): kernel wrapper and plain version.

Kernel: ``csrc/select_k.cu`` (replaces the JAX package's Pallas
``_select_kernel``). :func:`select_k` dispatches on the device of its
input: CPU tensors take :func:`select_k_plain`, CUDA tensors launch the
kernel (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._util import check_cuda_tensor

MAX_K = 256

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0


def select_k_plain(v: torch.Tensor, k: int):
    """Plain PyTorch version: the k smallest of each row, ascending,
    ties to the lower column (a stable sort), ``+inf`` slots with id
    ``-1``; NaN reads as ``+inf``."""
    v = v.float()
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    vals, idx = torch.sort(v, dim=1, stable=True)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
    idx = torch.where(torch.isinf(vals) & (vals > 0),
                      torch.full_like(idx, -1), idx)
    return vals, idx


def _lib():
    fn = _build.load("select_k").raft_select_k
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def select_k_cuda(v: torch.Tensor, k: int):
    """Launch the CUDA kernel on a contiguous float32 (m, n) CUDA tensor."""
    global launches
    check_cuda_tensor("select_k values", v, torch.float32, 2)
    m, n = v.shape
    out_v = torch.empty((m, k), dtype=torch.float32, device=v.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=v.device)
    fn = _lib()
    with torch.cuda.device(v.device):
        rc = fn(v.data_ptr(), m, n, k, out_v.data_ptr(), out_i.data_ptr(),
                _build.stream_handle(v.device))
    _build.check(rc, "select_k")
    launches += 1
    return out_v, out_i


def select_k(v: torch.Tensor, k: int):
    """Exact k smallest per row of ``v`` (m, n) → ``(vals (m, k) f32,
    ids (m, k) int32)`` for ``1 <= k <= min(256, n)``."""
    if v.dim() != 2:
        raise ValueError(f"select_k: expected (m, n), got {tuple(v.shape)}")
    if not 1 <= k <= min(MAX_K, v.shape[1]):
        raise ValueError(f"select_k: k={k} outside [1, min(256, "
                         f"n={v.shape[1]})]")
    if v.is_cuda:
        return select_k_cuda(v.float().contiguous(), int(k))
    return select_k_plain(v, int(k))

"""Exact per-row k-selection (k <= 256): kernel wrappers and plain
versions.

Kernel: ``csrc/radix_select.cuh``, built into ``csrc/select_k.cu``
(replaces the JAX package's Pallas ``_select_kernel``). :func:`select_k`
returns the columns as ids; :func:`select_k_payload` carries each
entry's id from a second array instead — the fused scans' pass B (the
scans launch the same kernel from their own libraries), here on its own.
Each dispatches on the device of its input: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import INT, PTR
from raft_tpu_torch.ops._util import check_cuda_tensor, stable_topk_min

MAX_K = 256

# launches of the CUDA kernel since the last reset (plain integers):
# column ids, payload ids
launches = 0
launches_payload = 0


def _check_k(name: str, k: int) -> None:
    """The kernel's bound, held on every route: a CPU caller sees the
    ``ValueError`` a card caller would."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside [1, {MAX_K}]")


def select_k_plain(v: torch.Tensor, k: int):
    """Plain PyTorch version: the k smallest of each row, ascending,
    ties to the lower column (a stable sort), ``+inf`` slots with id
    ``-1``; NaN reads as ``+inf``. ``k <= 256``, as the kernel's."""
    _check_k("select_k", k)
    v = v.float()
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    vals, idx = torch.sort(v, dim=1, stable=True)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
    idx = torch.where(torch.isinf(vals) & (vals > 0),
                      torch.full_like(idx, -1), idx)
    return vals, idx


def select_k_payload_plain(v: torch.Tensor, ids: torch.Tensor, k: int,
                           sqrt: bool = False):
    """Plain version of :func:`select_k_payload` (``k <= 256``, as the
    kernel's): :func:`select_k_payload_sorted` under the kernel's bound."""
    _check_k("select_k_payload", k)
    return select_k_payload_sorted(v, ids, k, sqrt)


def select_k_payload_sorted(v: torch.Tensor, ids: torch.Tensor, k: int,
                            sqrt: bool = False):
    """Each row's k smallest of ``v`` (m, n) by (value, column) from a
    stable sort, at any k: NaN read as ``+inf``, the ids gathered from
    ``ids``; ``(+inf, -1)`` where fewer than k finite values exist (n < k
    included); the square root taken last."""
    m, n = v.shape
    v = torch.where(torch.isnan(v), float("inf"), v.float())
    if n < k:
        v = torch.cat([v, torch.full((m, k - n), float("inf"),
                                     device=v.device)], dim=1)
        ids = torch.cat([ids, torch.full((m, k - n), -1, dtype=ids.dtype,
                                         device=v.device)], dim=1)
    vals, sel = stable_topk_min(v, k)
    out_i = torch.gather(ids, 1, sel)
    empty = torch.isinf(vals) & (vals > 0)
    out_i = torch.where(empty, -1, out_i).to(torch.int32)
    if sqrt:
        vals = torch.where(empty, vals, torch.sqrt(torch.clamp(vals, min=0.0)))
    return vals.contiguous(), out_i.contiguous()


_SELECT_K = _build.Entry("select_k", "raft_select_k",
                         [PTR, INT, INT, INT, PTR, PTR, PTR])
_SELECT_K_PAYLOAD = _build.Entry("select_k", "raft_select_k_payload",
                                 [PTR, PTR, INT, INT, INT, INT, PTR, PTR,
                                  PTR])


def select_k_cuda(v: torch.Tensor, k: int):
    """Launch the CUDA kernel on a contiguous float32 (m, n) CUDA tensor."""
    global launches
    check_cuda_tensor("select_k values", v, torch.float32, 2)
    m, n = v.shape
    out_v = torch.empty((m, k), dtype=torch.float32, device=v.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _SELECT_K(v.data_ptr(), m, n, k, out_v.data_ptr(),
                       out_i.data_ptr(), _build.stream_handle(v.device))
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


def select_k_payload_cuda(v: torch.Tensor, ids: torch.Tensor, k: int,
                          sqrt: bool = False):
    """Launch the payload select on contiguous (m, n) float32 values and
    int32 ids on one card."""
    global launches_payload
    check_cuda_tensor("select_k_payload values", v, torch.float32, 2)
    check_cuda_tensor("select_k_payload ids", ids, torch.int32, 2)
    if ids.shape != v.shape or ids.device != v.device:
        raise ValueError("select_k_payload: ids and values disagree")
    _check_k("select_k_payload", k)
    m, n = v.shape
    out_v = torch.empty((m, k), dtype=torch.float32, device=v.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=v.device)
    with torch.cuda.device(v.device):
        rc = _SELECT_K_PAYLOAD(v.data_ptr(), ids.data_ptr(), m, n, k,
                               int(bool(sqrt)), out_v.data_ptr(),
                               out_i.data_ptr(),
                               _build.stream_handle(v.device))
    _build.check(rc, "select_k_payload")
    launches_payload += 1
    return out_v, out_i


def select_k_payload(v: torch.Tensor, ids: torch.Tensor, k: int,
                     sqrt: bool = False):
    """The fused scans' pass B on its own: per row of candidates ``v``
    (m, n) with their ``ids`` (m, n), the k <= 256 smallest by (value,
    column) → ``(vals (m, k) f32, ids (m, k) int32)``; NaN reads as
    ``+inf``, a slot no finite candidate reaches is ``(+inf, -1)`` (n < k
    allowed), ``sqrt`` applied last."""
    if v.dim() != 2:
        raise ValueError(f"select_k_payload: expected (m, n), got "
                         f"{tuple(v.shape)}")
    if v.is_cuda:
        return select_k_payload_cuda(v.float().contiguous(),
                                     ids.to(torch.int32).contiguous(),
                                     int(k), sqrt)
    return select_k_payload_plain(v, ids, int(k), sqrt)


def select_k_payload_any(v: torch.Tensor, ids: torch.Tensor, k: int):
    """:func:`select_k_payload` at any k: kernel 2 at ``k <= 256``, above
    that :func:`select_k_payload_sorted` (the same (value, column) order
    and ``(+inf, -1)`` slots), on either device."""
    if k <= MAX_K:
        return select_k_payload(v, ids, k)
    return select_k_payload_sorted(v.float(), ids.to(torch.int32), int(k))

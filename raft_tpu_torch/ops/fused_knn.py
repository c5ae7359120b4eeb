"""Fused brute-force k-NN with binned partial top-k: kernel wrapper, plain
version and the tile geometry.

Kernels (replacing the JAX package's Pallas ``_knn_kernel``, kernel 5,
and ``_knn_kernel_ktiled``, kernel 6, the latter launched for d > 4096):
``csrc/fused_knn_tc.cu``, the pass A of both on the tensor cores (bf16x3,
the TPU kernels' arithmetic and the card's default, or one bf16 pass;
kernel 6 streams the queries with the rows); ``csrc/fused_knn.cu``, both
kernels' f32 bodies (``"highest"``), the row norms and pass B.
:func:`fused_knn` picks the JAX package's geometry (:func:`geometry`)
and dispatches on the device of its inputs: CPU tensors take
:func:`fused_knn_plain`, CUDA tensors launch the kernels (or raise).

The result is the JAX kernel's: each db tile of ``tn`` rows is cut into
``l_bins`` contiguous bins, each bin contributes its minimum (lowest row
among ties), and each query keeps the k smallest of those candidates by
(value, row). Two true neighbours in one bin keep only the nearer, so the
geometry is part of the result; ``l_bins == tn`` is exact.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import I64, INT, PTR
from raft_tpu_torch.ops._util import (PRECISIONS, check_cuda_tensor, dot_nt,
                                      resolve_precision, round_up)
from raft_tpu_torch.ops.select_k import select_k_payload_sorted

# k served by the kernel's pass B (csrc/radix_select.cuh kRsMaxK); above
# it the candidates are ranked by a stable sort
MAX_K = 256
# the dimension chunk of the JAX package's K-staged kernel (kernel 6)
KT = 2048

# launches of the CUDA kernels since the last reset (plain integers):
# kernel 5 on the tensor cores (bf16x3, bf16), kernel 5's f32 body
# ("highest"), kernel 6 (d > 4096) on the tensor cores and its f32 body
launches = 0
launches_f32 = 0
launches_ktiled = 0
launches_ktiled_f32 = 0

# candidates (queries x bins) per kernel launch: bounds the pass-A buffer
_MAX_CAND_ELEMS = 1 << 28
# (queries x rows) distances per step of the plain version
_PLAIN_ELEMS = 1 << 24


def geometry(m: int, n: int, dim: int, k: int, tm: int = 0, tn: int = 0,
             l_bins: int = 0):
    """``(tm, tn, l_bins, kt)`` as ``fused_knn_pallas`` picks them
    (``raft_tpu/ops/pallas_fused_knn.py:257-282``): dimension thresholds
    512 / 2048 / 4096, ``tn <= round_up(n, 8)``, ``l_bins = max(2k, 64)``
    capped at ``tn`` and raised until it divides ``tn``; ``kt > 0`` (the
    K-staged kernel) for d > 4096."""
    kt = 0
    if dim > 4096:
        kt = KT
        tm, tn = (tm or 256), (tn or 1024)
    if tm <= 0 or tn <= 0:
        if dim <= 512:
            tm, tn = 1024, 4096
        elif dim <= 2048:
            tm, tn = 512, 1024
        else:
            tm, tn = 256, 512
    tm = min(tm, round_up(m, 8))
    tn = min(tn, round_up(n, 8))
    if l_bins <= 0:
        l_bins = max(2 * k, 64)
    l_bins = min(l_bins, tn)
    while tn % l_bins:  # terminates: tn % tn == 0
        l_bins += 1
    return tm, tn, l_bins, kt


def _product(x: torch.Tensor, y: torch.Tensor, kt: int,
             precision: str = "f32") -> torch.Tensor:
    """x @ y.T at ``precision`` (``"f32"``, ``"bf16x3"``, ``"bf16"``),
    summed over ``kt``-wide dimension chunks when ``0 < kt < dim``
    (kernel 6's staging)."""
    full_fp32_matmul()
    dim = x.shape[1]
    if not 0 < kt < dim:
        return dot_nt(x, y, precision)
    acc = dot_nt(x[:, :kt], y[:, :kt], precision)
    for c in range(kt, dim, kt):
        acc += dot_nt(x[:, c:c + kt], y[:, c:c + kt], precision)
    return acc


def bin_candidates_plain(x: torch.Tensor, y: torch.Tensor, metric: str,
                         tn: int, l_bins: int, kt: int = 0,
                         precision: str = "f32"):
    """Pass A in plain PyTorch: every bin's (minimum, row) → ``(cand_d,
    cand_i)`` (m, ceil(n / b)), b = tn / l_bins; a bin with no finite
    value holds (+inf, -1). Products at ``precision`` (``"f32"``,
    ``"bf16x3"``, ``"bf16"``); norms from the unrounded rows."""
    x, y = x.float(), y.float()
    m, n = x.shape[0], y.shape[0]
    b = tn // l_bins
    nb = -(-n // b)
    xx = (x * x).sum(dim=1)
    cand_d = torch.empty((m, nb), dtype=torch.float32, device=x.device)
    cand_i = torch.empty((m, nb), dtype=torch.int32, device=x.device)
    step = max(1, _PLAIN_ELEMS // max(1, m) // tn) * tn
    for s in range(0, n, step):
        yb = y[s:s + step]
        ip = _product(x, yb, kt, precision)
        if metric == "ip":
            d = -ip
        else:
            d = torch.clamp((yb * yb).sum(dim=1)[None, :] + xx[:, None]
                            - 2.0 * ip, min=0.0)
        rows = yb.shape[0]
        nbb = -(-rows // b)
        if nbb * b > rows:  # the last tile's padded rows are +inf
            d = torch.cat([d, torch.full((m, nbb * b - rows), float("inf"),
                                         device=x.device)], dim=1)
        v, a = d.view(m, nbb, b).min(dim=2)  # first minimum: lowest row
        rid = (s + torch.arange(nbb, device=x.device) * b)[None, :] + a
        c0 = s // b
        cand_d[:, c0:c0 + nbb] = v
        cand_i[:, c0:c0 + nbb] = torch.where(v < float("inf"), rid,
                                             -1).to(torch.int32)
    return cand_d, cand_i


def fused_knn_plain(x: torch.Tensor, y: torch.Tensor, k: int,
                    metric: str = "l2", sqrt: bool = False, tn: int = 4096,
                    l_bins: int = 64, kt: int = 0, precision: str = "f32"):
    """Plain PyTorch version: pass A (:func:`bin_candidates_plain`) and
    the ranking (``select_k_payload_sorted``); IP scores negated back."""
    cand_d, cand_i = bin_candidates_plain(x, y, metric, tn, l_bins, kt,
                                          precision)
    vals, ids = select_k_payload_sorted(cand_d, cand_i, k,
                                        sqrt and metric == "l2")
    return (-vals if metric == "ip" else vals), ids


_NORMS = _build.Entry("fused_knn", "raft_fused_knn_norms",
                      [PTR, I64, INT, PTR, PTR])
_BINS = _build.Entry("fused_knn", "raft_fused_knn_bins",
                     [PTR] * 4 + [INT] * 7 + [I64] + [PTR] * 3)
_TOPK = _build.Entry("fused_knn", "raft_fused_knn_topk",
                     [PTR] * 2 + [INT, I64] + [INT] * 2 + [PTR] * 3)
_BINS_TC = _build.Entry("fused_knn_tc", "raft_fused_knn_bins_tc",
                        [PTR] * 4 + [INT] * 8 + [I64] + [PTR] * 3)


def fused_knn_cuda(x: torch.Tensor, y: torch.Tensor, k: int,
                   metric: str = "l2", sqrt: bool = False, tn: int = 4096,
                   l_bins: int = 64, kt: int = 0, precision: str = "f32"):
    """Launch pass A and pass B on contiguous float32 CUDA tensors, one
    launch of each per chunk of queries (the candidate buffer stays under
    2^28 entries). Pass A: on the tensor cores
    (``csrc/fused_knn_tc.cu``) for ``precision`` ``"bf16x3"`` (3 passes)
    or ``"bf16"`` (1 pass), the f32 body (``csrc/fused_knn.cu``) for
    ``"f32"``; kernel 6 when ``0 < kt < dim`` (each ``kt``-feature
    slice's products summed on their own, then added in f32, as the TPU
    kernel's scratch; its f32 body accumulates the row norms itself),
    else kernel 5."""
    global launches, launches_f32, launches_ktiled, launches_ktiled_f32
    check_cuda_tensor("fused_knn x", x, torch.float32, 2)
    check_cuda_tensor("fused_knn y", y, torch.float32, 2)
    m, dim = x.shape
    n = y.shape[0]
    if y.shape[1] != dim or x.device != y.device:
        raise ValueError("fused_knn: x and y disagree on dim or device")
    if metric not in ("l2", "ip") or n < 1 or tn % l_bins:
        raise ValueError(f"fused_knn: bad metric {metric!r}, n={n}, "
                         f"tn={tn} or l_bins={l_bins}")
    ktiled = 0 < kt < dim
    if precision not in PRECISIONS:
        raise ValueError(f"fused_knn: precision {precision!r} (want "
                         f"{'|'.join(PRECISIONS)})")
    tc = precision != "f32"
    b = tn // l_bins
    nb = -(-n // b)
    dev = x.device
    stream = _build.stream_handle(dev)
    xx = yy = None
    with torch.cuda.device(dev):
        if metric == "l2" and (tc or not ktiled):
            xx = torch.empty(m, dtype=torch.float32, device=dev)
            yy = torch.empty(n, dtype=torch.float32, device=dev)
            _build.check(_NORMS(x.data_ptr(), m, dim, xx.data_ptr(),
                                stream), "fused_knn norms")
            _build.check(_NORMS(y.data_ptr(), n, dim, yy.data_ptr(),
                                stream), "fused_knn norms")
        out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((m, k), dtype=torch.int32, device=dev)
        mc = max(1, min(m, _MAX_CAND_ELEMS // nb))
        for s in range(0, m, mc):
            rows = min(mc, m - s)
            cand_d = torch.empty((rows, nb), dtype=torch.float32, device=dev)
            cand_i = torch.empty((rows, nb), dtype=torch.int32, device=dev)
            norm_ptrs = (xx[s].data_ptr() if xx is not None else None,
                         yy.data_ptr() if yy is not None else None)
            if tc:
                rc = _BINS_TC(x[s].data_ptr(), y.data_ptr(), *norm_ptrs,
                              rows, n, dim, tn, b, int(metric == "ip"),
                              3 if precision == "bf16x3" else 1,
                              kt if ktiled else 0, nb, cand_d.data_ptr(),
                              cand_i.data_ptr(), stream)
            else:
                rc = _BINS(x[s].data_ptr(), y.data_ptr(), *norm_ptrs,
                           rows, n, dim, tn, b, int(ktiled),
                           int(metric == "ip"), nb, cand_d.data_ptr(),
                           cand_i.data_ptr(), stream)
            _build.check(rc, "fused_knn")
            if ktiled and tc:
                launches_ktiled += 1
            elif ktiled:
                launches_ktiled_f32 += 1
            elif tc:
                launches += 1
            else:
                launches_f32 += 1
            do_sqrt = bool(sqrt) and metric == "l2"
            if k <= MAX_K:
                _build.check(_TOPK(cand_d.data_ptr(), cand_i.data_ptr(),
                                   rows, nb, k, int(do_sqrt),
                                   out_d[s].data_ptr(),
                                   out_i[s].data_ptr(), stream),
                             "fused_knn top-k")
            else:
                (out_d[s:s + rows],
                 out_i[s:s + rows]) = select_k_payload_sorted(
                    cand_d, cand_i, k, do_sqrt)
            del cand_d, cand_i
    return (-out_d if metric == "ip" else out_d), out_i


def _fused_knn_call(x: torch.Tensor, y: torch.Tensor, k: int, metric: str,
                    sqrt: bool, tm: int, tn: int, l_bins: int, kt: int = 0,
                    kernel_precision=None):
    """One fused k-NN at an explicit geometry (``tm`` only tiles the
    queries on the TPU and changes no result)."""
    del tm
    precision = resolve_precision(kernel_precision, x.is_cuda)
    if x.is_cuda:
        return fused_knn_cuda(x.float().contiguous(), y.float().contiguous(),
                              int(k), metric, bool(sqrt), int(tn),
                              int(l_bins), int(kt), precision)
    return fused_knn_plain(x, y, int(k), metric, bool(sqrt), int(tn),
                           int(l_bins), int(kt), precision)


def fused_knn(x: torch.Tensor, y: torch.Tensor, k: int, metric: str = "l2",
              sqrt: bool = False, tm: int = 0, tn: int = 0, l_bins: int = 0,
              kernel_precision=None):
    """Fused brute-force k-NN of queries ``x`` against database ``y`` →
    ``(dists (m, k) f32, ids (m, k) int32)``, rows best-first.
    ``metric``: ``"l2"`` (expanded, ``sqrt`` optional) or ``"ip"``
    (largest inner product first). ``l_bins`` (0 → ``max(2k, 64)``) sets
    the per-tile candidates; ``l_bins == tn`` is exact.
    ``kernel_precision`` (:func:`resolve_precision`): ``None`` (bf16x3
    on the card, f32 on the CPU) | ``"bf16x3"`` | ``"bf16"`` (operands
    rounded to bf16) | ``"highest"`` (f32), at every d."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"fused_knn: metric={metric!r}: want l2|ip")
    m, dim = x.shape
    n = y.shape[0]
    if k > n:
        raise ValueError(f"fused_knn: k={k} > n={n}")
    if m == 0:
        raise ValueError("fused_knn: empty query set")
    tm, tn, l_bins, kt = geometry(m, n, dim, k, tm, tn, l_bins)
    return _fused_knn_call(x, y, k, metric, sqrt, tm, tn, l_bins, kt,
                           kernel_precision)

"""IVF-BQ 1-bit scan, unfused and fused: kernel wrappers and plain versions.

Kernels: ``csrc/ivf_bq_scan.cu``, one list-major pass A on the tensor
cores (``csrc/list_scan_tc.cuh``, shared with the IVF-Flat scans) behind
both entry points. :func:`bq_scan` replaces the JAX
package's Pallas ``_bq_scan_kernel`` (per (list, table slot) binned
estimator candidates, merged afterwards); :func:`bq_scan_fused`
replaces ``_fused_bq_scan_kernel`` (the same candidates, IP centre term
included, merged into a per-query top-k). Each dispatches on the device
of its inputs: CPU tensors take the plain version, CUDA tensors launch
the kernel (or raise).

Both score a list row from its sign bits as ``est = (norms2 + |qsub|^2)
- 2 * scale * <bf16(qsub), +-1>`` (L2) or ``-(scale * <bf16(q_rot),
+-1>)`` (IP), not clamped, with ``qsub`` the rotated query's residual
against the list's rotated centre (L2) or the rotated query (IP). The
plain versions follow the TPU formulation (decode the bits to a +-1
tile, one f32 ``einsum`` with the bf16-rounded query); the kernel takes
the same exact products in one bf16 ``wgmma`` pass with f32
accumulation, so the two differ in f32 summation order only. See the
kernel's source note.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import INT, PTR
from raft_tpu_torch.ops._util import check_cuda_tensor, round_up
from raft_tpu_torch.ops.ivf_scan import (bin_rows, finish_state,
                                         kept_probes_sorted,
                                         merge_lists_into_state)

MAX_K = 256

# launches of the CUDA kernels since the last reset (plain integers)
launches = 0
launches_fused = 0

# element budget of one chunk's decode / score block in the plain versions
_PLAIN_BLOCK = 1 << 24
# candidates (queries x n_probes x bins) of one fused launch
# (csrc/list_scan_tc.cuh kListMaxCand)
_MAX_CAND = 1 << 28


def unpack_pm1(words: torch.Tensor, d: int) -> torch.Tensor:
    """(..., w) int32 bit patterns → (..., d) f32 +-1: bit ``j % 32`` of
    word ``j // 32`` set is +1. ``(w >> s) & 1`` reads bit s of an int32
    word whatever the arithmetic shift fills in above it."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    b = (words[..., None] >> shifts) & 1
    flat = b.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :d]
    return 2.0 * flat.float() - 1.0


def _cells(q_rot, centers_rot, bits, norms2, scales, ids, qm, l0: int,
           bins: int, mlp: int, metric: str, center_term: bool):
    """Binned estimator candidates (c, cap, bins) of the lists [l0, l0 +
    c) for the queries ``qm`` (c, cap) names — the plain per-cell
    body."""
    from raft_tpu_torch.neighbors._ivf_scan import gather_query_rows
    c = qm.shape[0]
    l1 = l0 + c
    d = q_rot.shape[1]
    qsub = gather_query_rows(q_rot, qm)                  # (c, cap, d)
    if metric != "ip":
        qsub = qsub - centers_rot[l0:l1, None, :]
    pm1 = unpack_pm1(bits[l0:l1], d)                     # (c, ML, d)
    ip = torch.einsum("gcd,gld->gcl", qsub.to(torch.bfloat16).float(), pm1)
    sc = scales[l0:l1][:, None, :]
    if metric == "ip":
        est = -(sc * ip)
    else:
        qq = (qsub * qsub).sum(dim=2)
        est = (norms2[l0:l1][:, None, :] + qq[:, :, None]) - (2.0 * sc) * ip
    cd, ci = bin_rows(est, ids[l0:l1], bins, mlp)
    if center_term and metric == "ip":
        corr = (qsub * centers_rot[l0:l1, None, :]).sum(dim=2)
        cd = cd - corr[:, :, None]
    empty = (qm < 0)[:, :, None]
    cd = torch.where(empty, torch.full_like(cd, float("inf")), cd)
    ci = torch.where(empty, torch.full_like(ci, -1), ci)
    return cd, ci


def _chunk(cap: int, mlp: int, d: int) -> int:
    return max(1, _PLAIN_BLOCK // max(1, mlp * max(cap, d)))


def bq_scan_plain(q_rot, centers_rot, bits, norms2, scales, ids, qmap,
                  bins: int, metric: str):
    """Plain version of :func:`bq_scan` (chunked over lists)."""
    n_lists, max_list = ids.shape
    cap = qmap.shape[1]
    mlp = round_up(max_list, bins)
    dev = q_rot.device
    out_d = torch.full((n_lists, cap, bins), float("inf"), device=dev)
    out_i = torch.full((n_lists, cap, bins), -1, dtype=torch.int32,
                       device=dev)
    chunk = _chunk(cap, mlp, q_rot.shape[1])
    for l0 in range(0, n_lists, chunk):
        qm = qmap[l0:l0 + chunk]
        if not bool((qm >= 0).any()):
            continue
        cd, ci = _cells(q_rot, centers_rot, bits, norms2, scales, ids, qm,
                        l0, bins, mlp, metric, False)
        out_d[l0:l0 + chunk] = cd
        out_i[l0:l0 + chunk] = ci.to(torch.int32)
    return out_d, out_i


def bq_scan_fused_plain(q_rot, centers_rot, bits, norms2, scales, ids, qmap,
                        k: int, bins: int, metric: str):
    """Plain version of :func:`bq_scan_fused`: list chunks in ascending
    id merged into the per-query state, which wins ties."""
    nq = q_rot.shape[0]
    n_lists, max_list = ids.shape
    mlp = round_up(max_list, bins)
    dev = q_rot.device
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    chunk = _chunk(qmap.shape[1], mlp, q_rot.shape[1])
    for l0 in range(0, n_lists, chunk):
        qm = qmap[l0:l0 + chunk]
        if not bool((qm >= 0).any()):
            continue
        cd, ci = _cells(q_rot, centers_rot, bits, norms2, scales, ids, qm,
                        l0, bins, mlp, metric, True)
        best_d, best_i = merge_lists_into_state(best_d, best_i, cd, ci, qm)
    return finish_state(best_d, best_i, False)


_SCAN = _build.Entry("ivf_bq_scan", "raft_ivf_bq_scan",
                     [PTR, INT, PTR, INT, INT, PTR, PTR, INT, PTR, PTR, PTR]
                     + [INT] * 3 + [PTR] * 4)
_FUSED = _build.Entry("ivf_bq_scan", "raft_ivf_bq_scan_fused",
                      [PTR, INT, PTR, INT, INT, PTR] + [INT] * 3
                      + [PTR, PTR, INT, PTR, PTR, PTR] + [INT] * 4
                      + [PTR] * 6)


def _check(q_rot, centers_rot, bits, norms2, scales, ids, qmap):
    check_cuda_tensor("ivf_bq_scan q_rot", q_rot, torch.float32, 2)
    check_cuda_tensor("ivf_bq_scan centers_rot", centers_rot,
                      torch.float32, 2)
    check_cuda_tensor("ivf_bq_scan bits", bits, torch.int32, 3)
    check_cuda_tensor("ivf_bq_scan norms2", norms2, torch.float32, 2)
    check_cuda_tensor("ivf_bq_scan scales", scales, torch.float32, 2)
    check_cuda_tensor("ivf_bq_scan ids", ids, torch.int32, 2)
    check_cuda_tensor("ivf_bq_scan qmap", qmap, torch.int32, 2)
    n_lists, max_list, words = bits.shape
    d = q_rot.shape[1]
    if (centers_rot.shape != (n_lists, d) or ids.shape != (n_lists, max_list)
            or norms2.shape != ids.shape or scales.shape != ids.shape
            or words != -(-d // 32) or qmap.shape[0] != n_lists):
        raise ValueError("ivf_bq_scan: index tensors disagree in shape")


def bq_scan_cuda(q_rot, centers_rot, bits, norms2, scales, ids, qmap,
                 bins: int, metric: str):
    """Launch kernel 10: the list-major pass A, one block per (list, tile
    of up to 64 table slots), writing the blocks."""
    global launches
    _check(q_rot, centers_rot, bits, norms2, scales, ids, qmap)
    n_lists, max_list, words = bits.shape
    cap = qmap.shape[1]
    dev = q_rot.device
    out_d = torch.empty((n_lists, cap, bins), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_lists, cap, bins), dtype=torch.int32, device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _SCAN(q_rot.data_ptr(), q_rot.shape[1], qmap.data_ptr(),
                   n_lists, cap, centers_rot.data_ptr(), bits.data_ptr(),
                   words, norms2.data_ptr(), scales.data_ptr(),
                   ids.data_ptr(), max_list, bins, int(metric == "ip"),
                   out_d.data_ptr(), out_i.data_ptr(), lists.data_ptr(),
                   _build.stream_handle(dev))
    _build.check(rc, "ivf_bq_scan")
    launches += 1
    return out_d, out_i


def bq_scan_fused_cuda(q_rot, centers_rot, bits, norms2, scales, ids,
                       probes, inv_pos, qmap, cap: int, k: int, bins: int,
                       metric: str):
    """Launch kernel 11 (all tensors contiguous, on one card): pass A over
    (list, query tile) blocks into per-query candidate rows, the IP centre
    term applied, then the top-k pass; queries in chunks of at most
    ``_MAX_CAND`` candidates."""
    global launches_fused
    _check(q_rot, centers_rot, bits, norms2, scales, ids, qmap)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ivf_bq_scan_fused: k={k} outside [1, {MAX_K}]")
    n_lists, max_list, words = bits.shape
    if qmap.shape[1] != cap:
        raise ValueError("ivf_bq_scan_fused: qmap is not (n_lists, cap)")
    nq, d = q_rot.shape
    kp = kept_probes_sorted(probes, inv_pos, cap)
    n_probes = kp.shape[1]
    ncols = n_probes * bins
    step = max(1, _MAX_CAND // max(1, ncols))
    dev = q_rot.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    cand_d = torch.empty((min(nq, step), ncols), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((min(nq, step), ncols), dtype=torch.int32,
                         device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        for q0 in range(0, nq, step):
            rc = _FUSED(q_rot.data_ptr(), d, qmap.data_ptr(), n_lists, cap,
                        kp.data_ptr(), n_probes, q0, min(nq, q0 + step),
                        centers_rot.data_ptr(), bits.data_ptr(), words,
                        norms2.data_ptr(), scales.data_ptr(), ids.data_ptr(),
                        max_list, bins, k, int(metric == "ip"),
                        cand_d.data_ptr(), cand_i.data_ptr(),
                        lists.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                        _build.stream_handle(dev))
            _build.check(rc, "ivf_bq_scan_fused")
            launches_fused += 1
    return out_d, out_i


def bq_scan(q_rot, centers_rot, bits, norms2, scales, ids, qmap, bins: int,
            metric: str = "l2"):
    """Kernel 10: binned estimator candidates of every (list, table slot)
    pair → ``(cd, ci)`` (n_lists, cap, bins), slot-major; an empty slot
    (qmap -1) is all (+inf, -1). ``bins`` >= 1 divides the bins-padded
    list length. IP scores lack the centre term (the caller adds it)."""
    if q_rot.is_cuda:
        return bq_scan_cuda(
            q_rot.contiguous(), centers_rot.contiguous(), bits.contiguous(),
            norms2.contiguous(), scales.contiguous(), ids.contiguous(),
            qmap.contiguous(), bins, metric)
    return bq_scan_plain(q_rot, centers_rot, bits, norms2, scales, ids, qmap,
                         bins, metric)


def bq_scan_fused(q_rot, centers_rot, bits, norms2, scales, ids, probes,
                  inv_pos, qmap, cap: int, k: int, bins: int,
                  metric: str = "l2"):
    """Kernel 11: the IVF-BQ fine phase → ``(dists (nq, k), ids (nq,
    k))``, best first, the k smallest binned estimator candidates under
    the key (score, list id, bin). ``probes`` (nq, n_probes) with
    ``inv_pos`` their slots in the inverted table ``qmap`` (n_lists,
    cap); pairs with ``inv_pos >= cap`` are dropped. IP scores come back
    negated, centre term included."""
    if q_rot.is_cuda:
        return bq_scan_fused_cuda(
            q_rot.contiguous(), centers_rot.contiguous(), bits.contiguous(),
            norms2.contiguous(), scales.contiguous(), ids.contiguous(),
            probes, inv_pos, qmap.contiguous(), cap, k, bins, metric)
    return bq_scan_fused_plain(q_rot, centers_rot, bits, norms2, scales, ids,
                               qmap, k, bins, metric)

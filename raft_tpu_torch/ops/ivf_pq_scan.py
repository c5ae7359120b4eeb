"""IVF-PQ code scan, unfused and fused: kernel wrappers and plain versions.

Kernels: ``csrc/ivf_pq_scan.cu``. :func:`pq_scan` replaces the JAX
package's Pallas ``_pq_scan_kernel`` (per (list, table slot) binned
candidates, merged afterwards); :func:`pq_scan_fused` replaces
``_fused_pq_scan_kernel`` (the same candidates merged into a per-query
top-k). Each dispatches on the device of its inputs: CPU tensors take
the plain version, CUDA tensors launch a kernel (or raise).

Both score a list row from its u8 codes as ``ip = sum_s op(qsub_s) .
op(book[c_s])`` with ``qsub`` the rotated query (IP) or its residual
against the list's rotated centre (L2), ``op`` the LUT tier: books
arrive already rounded (:func:`lut_operands`) and ``round_q`` rounds
the query to bf16. The plain versions follow the TPU formulation
(decode each row by gathering its codewords, one f32 ``einsum``). On
the card the tier picks the route:

* bf16 and fp8 (``round_q``): list-major on the tensor cores
  (``csrc/list_scan_tc.cuh`` with the ``PqRows`` policy): each probed
  list's codes decoded once per query tile into bf16 codebook values and
  scored against the tile's bf16 queries in one ``wgmma`` pass — exact
  products, f32 sums; kernel 9's pass B is the payload radix select
  (``csrc/radix_select.cuh``). Counters ``launches`` (kernel 8) and
  ``launches_fused`` (kernel 9).
* float32: list-major on the CUDA cores (``pq_f32_kernel``): each probed
  list's rows decoded once per tile of up to 32 table slots into f32
  codebook values, every slot's score summed per subspace as the f32
  table entry ``sum_j qsub_j * book[c][j]`` would be; the same pass B.
  No table is held whole, so every ``pq_dim`` and ``pq_bits`` runs.
  Counters ``launches_f32`` and ``launches_fused_f32``.

Either way the kernel and the plain version differ in f32 summation
order only. See the kernel's source note.
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
LUT_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)

# launches of the CUDA kernels since the last reset (plain integers): the
# list-major kernels 8 and 9 on the tensor cores (bf16, fp8), on the CUDA
# cores (float32)
launches = 0
launches_fused = 0
launches_f32 = 0
launches_fused_f32 = 0

# candidates (queries x n_probes x bins) of one fused list-major launch
# (csrc/list_scan_tc.cuh kListMaxCand)
_MAX_CAND = 1 << 28

# element budget of one chunk's decode / score block in the plain versions
_PLAIN_BLOCK = 1 << 24


def lut_operands(pq_centers: torch.Tensor, lut_dtype):
    """``(books, round_q)`` for a LUT tier: the codebooks rounded to the
    tier (float32; bf16; fp8 e4m3, widened exactly to bf16) and whether
    the query rounds to bf16 (every tier but float32)."""
    if lut_dtype not in LUT_DTYPES:
        raise ValueError(f"ivf_pq: lut_dtype must be one of {LUT_DTYPES}, "
                         f"got {lut_dtype}")
    books = pq_centers.float()
    if lut_dtype != torch.float32:
        books = books.to(lut_dtype).to(torch.bfloat16)
    return books.contiguous(), lut_dtype != torch.float32


def _cells(q_rot, centers_rot, books, codes, norms, ids, qm, l0: int,
           bins: int, mlp: int, metric: str, round_q: bool,
           per_cluster: bool, center_term: bool):
    """Binned candidates (c, cap, bins) of the lists [l0, l0 + c) for
    the queries ``qm`` (c, cap) names — the plain per-cell body."""
    from raft_tpu_torch.neighbors._ivf_scan import gather_query_rows
    c = qm.shape[0]
    l1 = l0 + c
    books = books.float()
    qsub = gather_query_rows(q_rot, qm)                  # (c, cap, rot)
    if metric != "ip":
        qsub = qsub - centers_rot[l0:l1, None, :]
    cb = codes[l0:l1].long()                             # (c, ML, pq_dim)
    ml, pq_dim = cb.shape[1], cb.shape[2]
    dev = q_rot.device
    if per_cluster:
        sel = torch.arange(l0, l1, device=dev)[:, None, None]
    else:
        sel = torch.arange(pq_dim, device=dev)[None, None, :]
    dec = books[sel, cb].reshape(c, ml, -1)              # (c, ML, rot)
    qop = qsub.to(torch.bfloat16).float() if round_q else qsub
    ip = torch.einsum("gcd,gld->gcl", qop, dec)          # (c, cap, ML)
    if metric == "ip":
        sc = -ip
    else:
        rr = (qsub * qsub).sum(dim=2)
        sc = torch.clamp((rr[:, :, None] + norms[l0:l1][:, None, :])
                         - 2.0 * ip, min=0.0)
    cd, ci = bin_rows(sc, ids[l0:l1], bins, mlp)
    if center_term and metric == "ip":
        corr = (qsub * centers_rot[l0:l1, None, :]).sum(dim=2)
        cd = cd - corr[:, :, None]
    empty = (qm < 0)[:, :, None]
    cd = torch.where(empty, torch.full_like(cd, float("inf")), cd)
    ci = torch.where(empty, torch.full_like(ci, -1), ci)
    return cd, ci


def _chunk(cap: int, mlp: int, rot_dim: int) -> int:
    return max(1, _PLAIN_BLOCK // max(1, mlp * max(cap, rot_dim)))


def pq_scan_plain(q_rot, centers_rot, books, codes, norms, ids, qmap,
                  bins: int, metric: str, round_q: bool, per_cluster: bool,
                  round_out: bool):
    """Plain version of :func:`pq_scan` (chunked over lists)."""
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
        cd, ci = _cells(q_rot, centers_rot, books, codes, norms, ids, qm,
                        l0, bins, mlp, metric, round_q, per_cluster, False)
        out_d[l0:l0 + chunk] = cd
        out_i[l0:l0 + chunk] = ci.to(torch.int32)
    if round_out:
        out_d = out_d.to(torch.bfloat16).float()
    return out_d, out_i


def pq_scan_fused_plain(q_rot, centers_rot, books, codes, norms, ids,
                        qmap, k: int, bins: int, sqrt: bool, metric: str,
                        round_q: bool, per_cluster: bool):
    """Plain version of :func:`pq_scan_fused`: list chunks in ascending
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
        cd, ci = _cells(q_rot, centers_rot, books, codes, norms, ids, qm,
                        l0, bins, mlp, metric, round_q, per_cluster, True)
        best_d, best_i = merge_lists_into_state(best_d, best_i, cd, ci, qm)
    return finish_state(best_d, best_i, sqrt)


_TOPK = _build.Entry("ivf_pq_scan", "raft_ivf_pq_topk",
                     [PTR] * 2 + [INT] * 4 + [PTR] * 3)
# kernel 8 on the tensor cores (bf16 books) and on the CUDA cores (f32
# books): one argument list
_LIST_ARGS = ([PTR, INT, PTR, INT, INT, PTR, PTR, PTR] + [INT] * 4
              + [PTR, PTR] + [INT] * 4 + [PTR] * 4)
_LIST_SCAN = _build.Entry("ivf_pq_scan", "raft_ivf_pq_list_scan", _LIST_ARGS)
_F32_SCAN = _build.Entry("ivf_pq_scan", "raft_ivf_pq_scan_f32", _LIST_ARGS)
_F32_FUSED = _build.Entry("ivf_pq_scan", "raft_ivf_pq_scan_f32_fused",
                          [PTR, INT, PTR, INT, INT, PTR, INT, INT, PTR, PTR,
                           PTR] + [INT] * 4 + [PTR, PTR] + [INT] * 3
                          + [PTR] * 4)
_LIST_FUSED = _build.Entry("ivf_pq_scan", "raft_ivf_pq_list_scan_fused",
                           [PTR, INT, PTR, INT, INT, PTR] + [INT] * 3
                           + [PTR] * 3 + [INT] * 4 + [PTR, PTR]
                           + [INT] * 5 + [PTR] * 6)


def _check(q_rot, centers_rot, books, codes, norms, ids, per_cluster,
           round_q):
    check_cuda_tensor("ivf_pq_scan q_rot", q_rot, torch.float32, 2)
    check_cuda_tensor("ivf_pq_scan centers_rot", centers_rot,
                      torch.float32, 2)
    # books: f32 for the f32 body, the bf16 values of the bf16 and fp8
    # tiers for the list-major kernels (lut_operands)
    check_cuda_tensor("ivf_pq_scan books", books,
                      torch.bfloat16 if round_q else torch.float32, 3)
    check_cuda_tensor("ivf_pq_scan codes", codes, torch.uint8, 3)
    check_cuda_tensor("ivf_pq_scan norms", norms, torch.float32, 2)
    check_cuda_tensor("ivf_pq_scan ids", ids, torch.int32, 2)
    n_lists, max_list, pq_dim = codes.shape
    rot_dim = q_rot.shape[1]
    n_codes, pq_len = books.shape[1], books.shape[2]
    if (centers_rot.shape != (n_lists, rot_dim) or ids.shape != (
            n_lists, max_list) or norms.shape != ids.shape
            or pq_dim * pq_len != rot_dim
            or books.shape[0] != (n_lists if per_cluster else pq_dim)):
        raise ValueError("ivf_pq_scan: index tensors disagree in shape")
    if round_q and (n_codes % 8 or not 8 <= n_codes <= 256):
        # the tensor-core kernels: 2^pq_bits codes, pq_bits 3..8
        raise ValueError(f"ivf_pq_scan: n_codes={n_codes}: the "
                         "list-major scan takes 8..256, a multiple of 8")
    return n_lists, max_list, pq_dim, rot_dim, n_codes, pq_len


def _book_args(codes, books, per_cluster):
    """The list-major entries' book arguments: pq_dim, pq_len, n_codes,
    per_cluster."""
    return (codes.shape[2], books.shape[2], books.shape[1],
            int(bool(per_cluster)))


def pq_scan_cuda(q_rot, centers_rot, books, codes, norms, ids, qmap,
                 bins: int, metric: str, round_q: bool, per_cluster: bool,
                 round_out: bool):
    """Launch kernel 8, list-major: on the tensor cores (one block per
    (list, tile of up to 64 table slots)) for the bf16 and fp8 tiers, on
    the CUDA cores (one block per (list, tile of up to 32 slots), walking
    the bins 64 at a time) for float32."""
    global launches, launches_f32
    n_lists, max_list, *_ = _check(q_rot, centers_rot, books, codes, norms,
                                   ids, per_cluster, round_q)
    check_cuda_tensor("ivf_pq_scan qmap", qmap, torch.int32, 2)
    if qmap.shape[0] != n_lists:
        raise ValueError("ivf_pq_scan: qmap is not (n_lists, cap)")
    cap = qmap.shape[1]
    dev = q_rot.device
    out_d = torch.empty((n_lists, cap, bins), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_lists, cap, bins), dtype=torch.int32, device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    entry = _LIST_SCAN if round_q else _F32_SCAN
    with torch.cuda.device(dev):
        rc = entry(q_rot.data_ptr(), q_rot.shape[1], qmap.data_ptr(),
                   n_lists, cap, centers_rot.data_ptr(), books.data_ptr(),
                   codes.data_ptr(), *_book_args(codes, books, per_cluster),
                   norms.data_ptr(), ids.data_ptr(), max_list, bins,
                   int(metric == "ip"), int(bool(round_out)),
                   out_d.data_ptr(), out_i.data_ptr(), lists.data_ptr(),
                   _build.stream_handle(dev))
    _build.check(rc, "ivf_pq_scan")
    if round_q:
        launches += 1
    else:
        launches_f32 += 1
    return out_d, out_i


def pq_scan_fused_cuda(q_rot, centers_rot, books, codes, norms, ids,
                       probes, inv_pos, qmap, cap: int, k: int, bins: int,
                       sqrt: bool, metric: str, round_q: bool,
                       per_cluster: bool):
    """Launch kernel 9 (all tensors contiguous, on one card): for the bf16
    and fp8 tiers the list-major pass A over (list, query tile) blocks
    into per-query candidate rows, the IP centre term applied, then pass
    B, queries in chunks of at most ``_MAX_CAND`` candidates; for float32
    the same walk on the CUDA cores into all queries' rows, then pass B."""
    global launches_fused, launches_fused_f32
    n_lists, max_list, *_ = _check(q_rot, centers_rot, books, codes, norms,
                                   ids, per_cluster, round_q)
    check_cuda_tensor("ivf_pq_scan_fused qmap", qmap, torch.int32, 2)
    if qmap.shape != (n_lists, cap):
        raise ValueError("ivf_pq_scan_fused: qmap is not (n_lists, cap)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ivf_pq_scan_fused: k={k} outside [1, {MAX_K}]")
    nq = q_rot.shape[0]
    kp = kept_probes_sorted(probes, inv_pos, cap)
    n_probes = kp.shape[1]
    ncols = n_probes * bins
    dev = q_rot.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if not round_q:
        cand_d = torch.empty((nq, ncols), dtype=torch.float32, device=dev)
        cand_i = torch.empty((nq, ncols), dtype=torch.int32, device=dev)
        lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = _F32_FUSED(
                q_rot.data_ptr(), q_rot.shape[1], qmap.data_ptr(), n_lists,
                cap, kp.data_ptr(), n_probes, nq, centers_rot.data_ptr(),
                books.data_ptr(), codes.data_ptr(),
                *_book_args(codes, books, per_cluster), norms.data_ptr(),
                ids.data_ptr(), max_list, bins, int(metric == "ip"),
                cand_d.data_ptr(), cand_i.data_ptr(), lists.data_ptr(),
                _build.stream_handle(dev))
            _build.check(rc, "ivf_pq_scan_fused")
            rc = _TOPK(cand_d.data_ptr(), cand_i.data_ptr(), nq, ncols, k,
                       int(bool(sqrt)), out_d.data_ptr(), out_i.data_ptr(),
                       _build.stream_handle(dev))
        _build.check(rc, "ivf_pq_scan_fused pass B")
        launches_fused_f32 += 1
        return out_d, out_i
    step = max(1, _MAX_CAND // max(1, ncols))
    cand_d = torch.empty((min(nq, step), ncols), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((min(nq, step), ncols), dtype=torch.int32,
                         device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        for q0 in range(0, nq, step):
            rc = _LIST_FUSED(
                q_rot.data_ptr(), q_rot.shape[1], qmap.data_ptr(), n_lists,
                cap, kp.data_ptr(), n_probes, q0, min(nq, q0 + step),
                centers_rot.data_ptr(), books.data_ptr(), codes.data_ptr(),
                *_book_args(codes, books, per_cluster), norms.data_ptr(),
                ids.data_ptr(), max_list, bins, k, int(metric == "ip"),
                int(bool(sqrt)), cand_d.data_ptr(), cand_i.data_ptr(),
                lists.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                _build.stream_handle(dev))
            _build.check(rc, "ivf_pq_scan_fused")
            launches_fused += 1
    return out_d, out_i


def pq_scan(q_rot, centers_rot, books, codes, norms, ids, qmap, bins: int,
            metric: str = "l2", round_q: bool = True,
            per_cluster: bool = False, round_out: bool = False):
    """Kernel 8: binned candidates of every (list, table slot) pair →
    ``(cd, ci)`` (n_lists, cap, bins), slot-major; an empty slot (qmap
    -1) is all (+inf, -1). ``bins`` >= 1 divides the bins-padded list
    length. ``round_out`` rounds the scores to bf16
    (``internal_distance_dtype``). IP scores lack the centre term (the
    caller adds it)."""
    if q_rot.is_cuda:
        return pq_scan_cuda(
            q_rot.contiguous(), centers_rot.contiguous(), books.contiguous(),
            codes.contiguous(), norms.contiguous(), ids.contiguous(),
            qmap.contiguous(), bins, metric, round_q, per_cluster,
            round_out)
    return pq_scan_plain(q_rot, centers_rot, books, codes, norms, ids, qmap,
                         bins, metric, round_q, per_cluster, round_out)


def pq_scan_fused(q_rot, centers_rot, books, codes, norms, ids, probes,
                  inv_pos, qmap, cap: int, k: int, bins: int,
                  sqrt: bool = False, metric: str = "l2",
                  round_q: bool = True, per_cluster: bool = False):
    """Kernel 9: the IVF-PQ fine phase → ``(dists (nq, k), ids (nq,
    k))``, best first, the k smallest binned candidates under the key
    (score, list id, bin). ``probes`` (nq, n_probes) with ``inv_pos``
    their slots in the inverted table ``qmap`` (n_lists, cap); pairs
    with ``inv_pos >= cap`` are dropped. IP scores come back negated,
    centre term included."""
    if q_rot.is_cuda:
        return pq_scan_fused_cuda(
            q_rot.contiguous(), centers_rot.contiguous(), books.contiguous(),
            codes.contiguous(), norms.contiguous(), ids.contiguous(), probes,
            inv_pos, qmap.contiguous(), cap, k, bins, sqrt, metric, round_q,
            per_cluster)
    return pq_scan_fused_plain(q_rot, centers_rot, books, codes, norms, ids,
                               qmap, k, bins, sqrt, metric, round_q,
                               per_cluster)

"""IVF-Flat fused fine phase: kernel wrapper and plain version.

Kernel: ``csrc/ivf_flat_scan.cu`` (replaces the JAX package's Pallas
``_fused_list_scan_kernel``). :func:`fused_list_scan` dispatches on the
device of its inputs: CPU tensors take :func:`fused_list_scan_plain`,
CUDA tensors launch the kernel (or raise).

Both compute, per query, the k smallest binned candidates under the key
(score, list id, bin index) — see the kernel's source note. The
kernel walks each query's probed lists (query-major); the plain version
walks lists in chunks and merges with a stable sort (list-major, like
the JAX package's XLA tier).
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._util import check_cuda_tensor, round_up

MAX_K = 256

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0

# element budget of one (lists, cap, rows) score block of the plain version
_PLAIN_BLOCK = 1 << 24


def resolve_bins(bins: int, k: int, max_list: int):
    """``(bins, mlp)``: the JAX ``_Layout`` rule. ``bins`` 0 = auto,
    ``min(max(4k, 64), max_list)``; ``-1`` = exact (one row per bin);
    ``> 0`` explicit. ``mlp`` is ``max_list`` padded to a multiple of
    ``bins`` (pad rows score +inf)."""
    if bins == 0:
        bins = min(max(4 * k, 64), max_list)
    mlp = round_up(max_list, bins if bins > 0 else 1)
    return (mlp if bins < 0 else bins), mlp


def fused_list_scan_plain(queries, data, norms, ids, probes, inv_pos,
                          qmap, cap: int, k: int, bins: int, sqrt: bool,
                          metric: str):
    """Plain PyTorch version (list-major, chunked over lists so the
    (lists, cap, rows) score block stays bounded on the card)."""
    from raft_tpu_torch.neighbors._ivf_scan import gather_query_rows
    nq = queries.shape[0]
    n_lists, max_list = ids.shape
    bins, mlp = resolve_bins(bins, k, max_list)
    dev = queries.device
    inf = float("inf")
    best_d = torch.full((nq, k), inf, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    chunk = max(1, _PLAIN_BLOCK // max(1, cap * mlp))
    for l0 in range(0, n_lists, chunk):
        l1 = min(n_lists, l0 + chunk)
        qm = qmap[l0:l1]                                 # (c, cap)
        if not bool((qm >= 0).any()):
            continue
        qsub = gather_query_rows(queries, qm)            # (c, cap, d)
        x = data[l0:l1].float()
        ip = torch.einsum("gcd,gld->gcl", qsub, x)       # (c, cap, ML)
        lid = ids[l0:l1]
        if metric == "ip":
            sc = -ip
        else:
            qq = (qsub * qsub).sum(dim=2)
            sc = torch.clamp((norms[l0:l1][:, None, :] + qq[:, :, None])
                             - 2.0 * ip, min=0.0)
        pad = (lid < 0)[:, None, :]
        sc = torch.where(pad, torch.full_like(sc, inf), sc)
        c = l1 - l0
        if mlp > max_list:
            sc = torch.nn.functional.pad(sc, (0, mlp - max_list), value=inf)
            lid = torch.nn.functional.pad(lid, (0, mlp - max_list), value=-1)
        # strided bins: row r -> bin r % bins; min per bin, ties to min id
        sb = sc.reshape(c, cap, mlp // bins, bins)
        cd = sb.min(dim=2).values                        # (c, cap, bins)
        lb = lid.reshape(c, 1, mlp // bins, bins).expand_as(sb)
        big = torch.iinfo(torch.int32).max
        ci = torch.where(sb == cd[:, :, None, :], lb,
                         torch.full_like(lb, big)).min(dim=2).values
        ci = torch.where(ci == big, torch.full_like(ci, -1), ci)
        # scatter each (list, slot) candidate row onto its query, in
        # (list, bin) order; unreached entries stay (+inf, -1)
        nd = torch.full((nq, c, bins), inf, device=dev)
        ni = torch.full((nq, c, bins), -1, dtype=torch.int32, device=dev)
        li, si = torch.nonzero(qm >= 0, as_tuple=True)
        qsel = qm[li, si].long()
        nd[qsel, li] = cd[li, si]
        ni[qsel, li] = ci[li, si].to(torch.int32)
        # stable merge: the state beats newcomers on ties, newcomers
        # keep (list, bin) order
        cat_d = torch.cat([best_d, nd.reshape(nq, c * bins)], dim=1)
        cat_i = torch.cat([best_i, ni.reshape(nq, c * bins)], dim=1)
        sd, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    best_d = torch.where(best_i >= 0, best_d, torch.full_like(best_d, inf))
    if sqrt:
        best_d = torch.sqrt(torch.clamp(best_d, min=0.0))
    return best_d, best_i


def _lib():
    fn = _build.load("ivf_flat_scan").raft_ivf_flat_scan
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def kept_probes_sorted(probes, inv_pos, cap: int):
    """Per-query probed list ids in ascending order, ``-1`` where the
    inversion dropped the pair (``inv_pos >= cap``) — the kernel's view
    of the probe map."""
    kept = torch.where(inv_pos < cap, probes,
                       torch.full_like(probes, -1)).to(torch.int32)
    return torch.sort(kept, dim=1).values.contiguous()


def fused_list_scan_cuda(queries, data, norms, ids, probes, inv_pos,
                         cap: int, k: int, bins: int, sqrt: bool,
                         metric: str):
    """Launch the CUDA kernel (all tensors contiguous, on one card)."""
    global launches
    check_cuda_tensor("ivf_flat_scan queries", queries, torch.float32, 2)
    check_cuda_tensor("ivf_flat_scan data", data, torch.float32, 3)
    check_cuda_tensor("ivf_flat_scan norms", norms, torch.float32, 2)
    check_cuda_tensor("ivf_flat_scan ids", ids, torch.int32, 2)
    nq, d = queries.shape
    n_lists, max_list = ids.shape
    if data.shape != (n_lists, max_list, d) or norms.shape != ids.shape:
        raise ValueError("ivf_flat_scan: list tensors disagree in shape")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ivf_flat_scan: k={k} outside [1, {MAX_K}]")
    bins, mlp = resolve_bins(bins, k, max_list)
    kp = kept_probes_sorted(probes, inv_pos, cap)
    vec4 = (d % 4 == 0 and queries.data_ptr() % 16 == 0
            and data.data_ptr() % 16 == 0)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=queries.device)
    fn = _lib()
    with torch.cuda.device(queries.device):
        rc = fn(queries.data_ptr(), nq, d, kp.data_ptr(), kp.shape[1],
                data.data_ptr(), norms.data_ptr(), ids.data_ptr(),
                max_list, bins, mlp, k, int(metric == "ip"), int(bool(sqrt)),
                int(vec4), out_d.data_ptr(), out_i.data_ptr(),
                _build.stream_handle(queries.device))
    _build.check(rc, "ivf_flat_scan")
    launches += 1
    return out_d, out_i


def fused_list_scan(queries, data, norms, ids, probes, inv_pos, qmap,
                    cap: int, k: int, bins: int = 0, sqrt: bool = False,
                    metric: str = "l2"):
    """IVF-Flat fine phase → ``(dists (nq, k), ids (nq, k))``, best first.

    ``probes`` (nq, n_probes) list ids with ``inv_pos`` (nq, n_probes)
    their slots in the inverted table ``qmap`` (n_lists, cap) (see
    ``neighbors._ivf_scan._invert_probes``); pairs with ``inv_pos >=
    cap`` are dropped. ``metric`` "l2" (squared, ``sqrt`` optional) or
    "ip" (negated similarities). ``bins``: see :func:`resolve_bins`."""
    if queries.is_cuda:
        return fused_list_scan_cuda(
            queries.contiguous(), data.contiguous(), norms.contiguous(),
            ids.contiguous(), probes, inv_pos, cap, k, bins, sqrt, metric)
    return fused_list_scan_plain(queries, data, norms, ids, probes, inv_pos,
                                 qmap, cap, k, bins, sqrt, metric)

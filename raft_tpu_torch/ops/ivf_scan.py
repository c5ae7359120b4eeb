"""IVF-Flat fine phase, fused and unfused: kernel wrappers and plain
versions.

Kernels: ``csrc/ivf_flat_scan.cu``, one list-major pass A on the tensor
cores behind both entry points, in the list storage of the index: f32
rows at bf16x3 (the TPU kernel's arithmetic), bf16 rows and int8 rows
(with the index's ``scale``) at one bf16 pass against the queries rounded
to bf16, as the TPU kernel's ``_flat_list_candidates`` computes them.
:func:`fused_list_scan` replaces the JAX package's Pallas
``_fused_list_scan_kernel``: per query, the k smallest binned candidates
under the key (score, list id, bin index) — see the kernel's source
note; pass A writes each query's candidates in (list id, bin) order and
pass B, the payload radix select (``csrc/radix_select.cuh``), keeps the
k best. The plain version walks lists in
chunks and merges with a stable sort (list-major, like the JAX
package's XLA tier). :func:`list_scan` replaces ``_list_scan_kernel``:
per (list, table slot), the slot's query's binned candidates, written
as (n_lists, cap, bins) blocks for
``neighbors._ivf_scan.merge_candidates`` (k > 256). Each dispatches on
the device of its inputs: CPU tensors take the plain version, CUDA
tensors launch the kernel (or raise). The plain versions take the f32
rows' ``precision``: ``"f32"`` (the CPU's, as the JAX package's
interpret mode) or ``"bf16x3"`` (the kernel's, for comparing on the
card); bf16 and int8 rows have one arithmetic on both devices.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops._build import F32, INT, PTR
from raft_tpu_torch.ops._util import check_cuda_tensor, dot_nt, round_up

MAX_K = 256

# launches of the CUDA kernels since the last reset (plain integers), by
# list storage: the fused scan (kernel 3) and the unfused list scan
# (kernel 4) on f32 rows (FlatRows), bf16 rows (Bf16Rows), int8 rows
# (Int8Rows)
launches = 0
launches_bf16 = 0
launches_int8 = 0
launches_list = 0
launches_list_bf16 = 0
launches_list_int8 = 0
_COUNTER_SUFFIX = ("", "_bf16", "_int8")

# element budget of one (lists, cap, rows) score block of the plain version
_PLAIN_BLOCK = 1 << 24
# candidates (queries x n_probes x bins) of one fused launch
# (csrc/ivf_flat_scan.cu kMaxCand)
_MAX_CAND = 1 << 28

# list storages: the kernels' storage codes (csrc/ivf_flat_scan.cu Storage)
STORAGES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _count(counter: str, storage: int) -> None:
    """One launch of ``counter`` (``"launches"`` or ``"launches_list"``)
    on rows of ``storage``."""
    name = counter + _COUNTER_SUFFIX[storage]
    globals()[name] += 1


_FUSED_SCAN = _build.Entry(
    "ivf_flat_scan", "raft_ivf_flat_scan",
    [PTR, INT, PTR, INT, INT, PTR] + [INT] * 3 + [PTR, INT, F32, PTR, PTR]
    + [INT] * 7 + [PTR] * 6)
_LIST_SCAN = _build.Entry(
    "ivf_flat_scan", "raft_ivf_list_scan",
    [PTR, INT, PTR, INT, INT, PTR, INT, F32, PTR, PTR] + [INT] * 6
    + [PTR] * 4)


def resolve_bins(bins: int, k: int, max_list: int):
    """``(bins, mlp)``: the JAX ``_Layout`` rule. ``bins`` 0 = auto,
    ``min(max(4k, 64), max_list)``; ``-1`` = exact (one row per bin);
    ``> 0`` explicit. ``mlp`` is ``max_list`` padded to a multiple of
    ``bins`` (pad rows score +inf)."""
    if bins == 0:
        bins = min(max(4 * k, 64), max_list)
    mlp = round_up(max_list, bins if bins > 0 else 1)
    return (mlp if bins < 0 else bins), mlp


def _list_scores(queries, data, norms, qm, l0: int, metric: str,
                 precision: str = "f32", scale: float = 1.0):
    """(c, cap, ML) scores of the lists [l0, l0 + c) against the queries
    ``qm`` (c, cap) names: L2 ``max((norm + |q|^2) - 2 ip, 0)`` or IP
    ``-ip``, |q|^2 from the f32 queries and the norms the caller's. ``ip``:
    f32 rows at ``precision`` (``"f32"`` or ``"bf16x3"``); bf16 rows
    against the queries rounded to bf16; int8 rows likewise, times
    ``scale`` (``_flat_list_candidates``' branches; the products are
    exact, the sums f32)."""
    from raft_tpu_torch.neighbors._ivf_scan import gather_query_rows
    if precision not in ("f32", "bf16x3"):
        raise ValueError(f"ivf_flat_scan: precision {precision!r} "
                         "(want f32|bf16x3)")
    l1 = l0 + qm.shape[0]
    qsub = gather_query_rows(queries, qm)                # (c, cap, d)
    y = data[l0:l1]
    if y.dtype == torch.float32 and precision == "bf16x3":
        ip = dot_nt(qsub, y, precision)
    elif y.dtype == torch.float32:
        ip = torch.einsum("gcd,gld->gcl", qsub, y)
    else:
        ip = torch.einsum("gcd,gld->gcl", qsub.bfloat16().float(), y.float())
        if y.dtype == torch.int8:
            ip = scale * ip
    if metric == "ip":
        return -ip
    qq = (qsub * qsub).sum(dim=2)
    return torch.clamp((norms[l0:l1][:, None, :] + qq[:, :, None])
                       - 2.0 * ip, min=0.0)


def fused_list_scan_plain(queries, data, norms, ids, probes, inv_pos,
                          qmap, cap: int, k: int, bins: int, sqrt: bool,
                          metric: str, precision: str = "f32",
                          scale: float = 1.0):
    """Plain PyTorch version (list-major, chunked over lists so the
    (lists, cap, rows) score block stays bounded on the card)."""
    nq = queries.shape[0]
    n_lists, max_list = ids.shape
    bins, mlp = resolve_bins(bins, k, max_list)
    dev = queries.device
    best_d = torch.full((nq, k), float("inf"), device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    chunk = max(1, _PLAIN_BLOCK // max(1, cap * mlp))
    for l0 in range(0, n_lists, chunk):
        l1 = min(n_lists, l0 + chunk)
        qm = qmap[l0:l1]                                 # (c, cap)
        if not bool((qm >= 0).any()):
            continue
        sc = _list_scores(queries, data, norms, qm, l0, metric, precision,
                          scale)
        cd, ci = bin_rows(sc, ids[l0:l1], bins, mlp)
        best_d, best_i = merge_lists_into_state(best_d, best_i, cd, ci, qm)
    return finish_state(best_d, best_i, sqrt)


def bin_rows(sc, lid, bins: int, mlp: int):
    """Strided bins of per-row scores: ``sc`` (c, cap, ML) against list
    ids ``lid`` (c, ML) → (c, cap, bins) minima and their ids. Row r goes
    to bin r % bins; pad rows (id < 0, or r >= ML inside the padded
    length ``mlp``) score +inf; ties go to the smallest id; an empty bin
    is (+inf, -1)."""
    inf = float("inf")
    c, cap, max_list = sc.shape
    sc = torch.where((lid < 0)[:, None, :], torch.full_like(sc, inf), sc)
    if mlp > max_list:
        sc = torch.nn.functional.pad(sc, (0, mlp - max_list), value=inf)
        lid = torch.nn.functional.pad(lid, (0, mlp - max_list), value=-1)
    sb = sc.reshape(c, cap, mlp // bins, bins)
    cd = sb.min(dim=2).values                            # (c, cap, bins)
    lb = lid.reshape(c, 1, mlp // bins, bins).expand_as(sb)
    big = torch.iinfo(torch.int32).max
    ci = torch.where(sb == cd[:, :, None, :], lb,
                     torch.full_like(lb, big)).min(dim=2).values
    return cd, torch.where(ci == big, torch.full_like(ci, -1), ci)


def merge_lists_into_state(best_d, best_i, cd, ci, qm):
    """Merge a chunk of lists' binned candidates ``cd``/``ci`` (c, cap,
    bins) into the per-query state (nq, k): each (list, slot) row goes to
    the query ``qm`` (c, cap) names (-1 = none), in (list, bin) order,
    and a stable sort lets the state win ties — the TPU kernels' resident
    top-k walk over lists in ascending id."""
    nq, k = best_d.shape
    c, _, bins = cd.shape
    dev = best_d.device
    # unreached (query, list) entries stay (+inf, -1)
    nd = torch.full((nq, c, bins), float("inf"), device=dev)
    ni = torch.full((nq, c, bins), -1, dtype=torch.int32, device=dev)
    li, si = torch.nonzero(qm >= 0, as_tuple=True)
    qsel = qm[li, si].long()
    nd[qsel, li] = cd[li, si].float()
    ni[qsel, li] = ci[li, si].to(torch.int32)
    cat_d = torch.cat([best_d, nd.reshape(nq, c * bins)], dim=1)
    cat_i = torch.cat([best_i, ni.reshape(nq, c * bins)], dim=1)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], torch.gather(cat_i, 1, order[:, :k])


def finish_state(best_d, best_i, sqrt: bool):
    """The resident state's output conventions: id -1 ⇒ +inf, then the
    optional sqrt."""
    best_d = torch.where(best_i >= 0, best_d,
                         torch.full_like(best_d, float("inf")))
    if sqrt:
        best_d = torch.sqrt(torch.clamp(best_d, min=0.0))
    return best_d, best_i


def kept_probes_sorted(probes, inv_pos, cap: int):
    """Per-query probed list ids in ascending order, ``-1`` where the
    inversion dropped the pair (``inv_pos >= cap``) — the kernel's view
    of the probe map."""
    kept = torch.where(inv_pos < cap, probes,
                       torch.full_like(probes, -1)).to(torch.int32)
    return torch.sort(kept, dim=1).values.contiguous()


def candidate_rows(cd, ci, probes, inv_pos, cap: int):
    """The fused scans' candidate rows from unfused blocks: per query, the
    (n_lists, cap, bins) blocks ``cd``/``ci`` of its kept probes in
    ascending list id (the dropped ones, -1, first and all (+inf, -1)) →
    ``(rows_d (nq, n_probes * bins) f32, rows_i int32)``: what pass A of
    a fused scan hands its pass B, up to the IP centre term."""
    nq = probes.shape[0]
    kept = inv_pos < cap
    order = torch.argsort(torch.where(kept, probes, -1), dim=1, stable=True)
    keep = kept.gather(1, order)
    pl = probes.gather(1, order).long()
    slot = inv_pos.gather(1, order).clamp(max=cap - 1).long()
    rows_d = torch.where(keep[:, :, None], cd[pl, slot].float(),
                         torch.tensor(float("inf"), device=cd.device))
    rows_i = torch.where(keep[:, :, None], ci[pl, slot],
                         torch.tensor(-1, dtype=torch.int32,
                                      device=cd.device))
    return (rows_d.reshape(nq, -1).contiguous(),
            rows_i.reshape(nq, -1).to(torch.int32).contiguous())


def _check_data(name: str, data) -> int:
    """The storage code of list rows ``data``; raises unless they are a
    contiguous rank-3 CUDA tensor of float32, bfloat16 or int8."""
    if data.dtype not in STORAGES:
        raise TypeError(f"{name}: list storage {data.dtype} is not "
                        "float32, bfloat16 or int8")
    check_cuda_tensor(name, data, data.dtype, 3)
    return STORAGES[data.dtype]


def _vec_flags(queries, data):
    """``(vec4, vec_rows)``: 16-byte loads of the queries (with f32 rows,
    of the rows too: ``FlatRows`` reads one flag), and of bf16 or int8
    rows (8 or 16 features a load): ``d`` a multiple of the features a
    load carries and 16-byte aligned bases."""
    d = queries.shape[1]
    q_ok = d % 4 == 0 and queries.data_ptr() % 16 == 0
    rows_ok = (d % (16 // data.element_size()) == 0
               and data.data_ptr() % 16 == 0)
    if data.dtype == torch.float32:
        return int(q_ok and rows_ok), 0
    return int(q_ok), int(rows_ok)


def fused_list_scan_cuda(queries, data, norms, ids, probes, inv_pos, qmap,
                         cap: int, k: int, bins: int, sqrt: bool,
                         metric: str, scale: float = 1.0):
    """Launch kernel 3 (all tensors contiguous, on one card): pass A over
    (list, query tile) blocks into per-query candidate rows, then the
    top-k pass; queries in chunks of at most ``_MAX_CAND`` candidates.
    ``data`` float32, bfloat16 or int8 (dequantized by ``scale``)."""
    check_cuda_tensor("ivf_flat_scan queries", queries, torch.float32, 2)
    storage = _check_data("ivf_flat_scan data", data)
    check_cuda_tensor("ivf_flat_scan norms", norms, torch.float32, 2)
    check_cuda_tensor("ivf_flat_scan ids", ids, torch.int32, 2)
    check_cuda_tensor("ivf_flat_scan qmap", qmap, torch.int32, 2)
    nq, d = queries.shape
    n_lists, max_list = ids.shape
    if (data.shape != (n_lists, max_list, d) or norms.shape != ids.shape
            or qmap.shape != (n_lists, cap)):
        raise ValueError("ivf_flat_scan: list tensors disagree in shape")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"ivf_flat_scan: k={k} outside [1, {MAX_K}]")
    bins, _ = resolve_bins(bins, k, max_list)
    kp = kept_probes_sorted(probes, inv_pos, cap)
    n_probes = kp.shape[1]
    ncols = n_probes * bins
    step = max(1, _MAX_CAND // max(1, ncols))
    dev = queries.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    cand_d = torch.empty((min(nq, step), ncols), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((min(nq, step), ncols), dtype=torch.int32,
                         device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    vec4, vec_rows = _vec_flags(queries, data)
    with torch.cuda.device(dev):
        for q0 in range(0, nq, step):
            rc = _FUSED_SCAN(
                queries.data_ptr(), d, qmap.data_ptr(), n_lists, cap,
                kp.data_ptr(), n_probes, q0, min(nq, q0 + step),
                data.data_ptr(), storage, float(scale), norms.data_ptr(),
                ids.data_ptr(), max_list, bins, k, int(metric == "ip"),
                int(bool(sqrt)), vec4, vec_rows, cand_d.data_ptr(),
                cand_i.data_ptr(), lists.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), _build.stream_handle(dev))
            _build.check(rc, "ivf_flat_scan")
            _count("launches", storage)
    return out_d, out_i


def fused_list_scan(queries, data, norms, ids, probes, inv_pos, qmap,
                    cap: int, k: int, bins: int = 0, sqrt: bool = False,
                    metric: str = "l2", scale: float = 1.0):
    """IVF-Flat fine phase → ``(dists (nq, k), ids (nq, k))``, best first.

    ``probes`` (nq, n_probes) list ids with ``inv_pos`` (nq, n_probes)
    their slots in the inverted table ``qmap`` (n_lists, cap) (see
    ``neighbors._ivf_scan._invert_probes``); pairs with ``inv_pos >=
    cap`` are dropped. ``metric`` "l2" (squared, ``sqrt`` optional) or
    "ip" (negated similarities). ``bins``: see :func:`resolve_bins`.
    ``data`` float32, bfloat16 or int8 rows (int8 values ``code *
    scale``), ``norms`` those of the stored rows."""
    if queries.is_cuda:
        return fused_list_scan_cuda(
            queries.contiguous(), data.contiguous(), norms.contiguous(),
            ids.contiguous(), probes, inv_pos, qmap.contiguous(), cap, k,
            bins, sqrt, metric, scale)
    return fused_list_scan_plain(queries, data, norms, ids, probes, inv_pos,
                                 qmap, cap, k, bins, sqrt, metric,
                                 scale=scale)


def list_scan_plain(queries, data, norms, ids, qmap, bins: int,
                    metric: str, out_dtype=torch.float32,
                    precision: str = "f32", scale: float = 1.0):
    """Plain version of :func:`list_scan` (chunked over lists)."""
    n_lists, max_list = ids.shape
    cap = qmap.shape[1]
    mlp = round_up(max_list, bins)
    dev = queries.device
    out_d = torch.full((n_lists, cap, bins), float("inf"), dtype=out_dtype,
                       device=dev)
    out_i = torch.full((n_lists, cap, bins), -1, dtype=torch.int32,
                       device=dev)
    chunk = max(1, _PLAIN_BLOCK // max(1, cap * mlp))
    for l0 in range(0, n_lists, chunk):
        qm = qmap[l0:l0 + chunk]
        if not bool((qm >= 0).any()):
            continue
        sc = _list_scores(queries, data, norms, qm, l0, metric, precision,
                          scale)
        cd, ci = bin_rows(sc, ids[l0:l0 + chunk], bins, mlp)
        empty = (qm < 0)[:, :, None]
        out_d[l0:l0 + chunk] = torch.where(
            empty, torch.full_like(cd, float("inf")), cd).to(out_dtype)
        out_i[l0:l0 + chunk] = torch.where(
            empty, torch.full_like(ci, -1), ci).to(torch.int32)
    return out_d, out_i


def list_scan_cuda(queries, data, norms, ids, qmap, bins: int, metric: str,
                   out_dtype=torch.float32, scale: float = 1.0):
    """Launch kernel 4: pass A alone, one block per (list, tile of up to
    64 table slots), writing the blocks. ``data`` as for
    :func:`fused_list_scan_cuda`."""
    check_cuda_tensor("ivf_list_scan queries", queries, torch.float32, 2)
    storage = _check_data("ivf_list_scan data", data)
    check_cuda_tensor("ivf_list_scan norms", norms, torch.float32, 2)
    check_cuda_tensor("ivf_list_scan ids", ids, torch.int32, 2)
    check_cuda_tensor("ivf_list_scan qmap", qmap, torch.int32, 2)
    d = queries.shape[1]
    n_lists, max_list = ids.shape
    cap = qmap.shape[1]
    if (data.shape != (n_lists, max_list, d) or norms.shape != ids.shape
            or qmap.shape[0] != n_lists):
        raise ValueError("ivf_list_scan: list tensors disagree in shape")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ivf_list_scan: out_dtype {out_dtype} is not "
                        "float32 or bfloat16")
    dev = queries.device
    out_d = torch.empty((n_lists, cap, bins), dtype=out_dtype, device=dev)
    out_i = torch.empty((n_lists, cap, bins), dtype=torch.int32, device=dev)
    lists = torch.empty(2 * n_lists, dtype=torch.int32, device=dev)
    vec4, vec_rows = _vec_flags(queries, data)
    with torch.cuda.device(dev):
        rc = _LIST_SCAN(queries.data_ptr(), d, qmap.data_ptr(), n_lists, cap,
                        data.data_ptr(), storage, float(scale),
                        norms.data_ptr(), ids.data_ptr(), max_list, bins,
                        int(metric == "ip"), vec4, vec_rows,
                        int(out_dtype == torch.bfloat16), out_d.data_ptr(),
                        out_i.data_ptr(), lists.data_ptr(),
                        _build.stream_handle(dev))
    _build.check(rc, "ivf_list_scan")
    _count("launches_list", storage)
    return out_d, out_i


def list_scan(queries, data, norms, ids, qmap, bins: int,
              metric: str = "l2", out_dtype=torch.float32,
              scale: float = 1.0):
    """Kernel 4: binned candidates of every (list, table slot) pair →
    ``(cd, ci)`` (n_lists, cap, bins), cap-major; an empty slot (qmap
    -1) is all (+inf, -1). ``bins`` >= 1 (resolved, see
    :func:`resolve_bins`) divides the bins-padded list length.
    ``out_dtype`` bfloat16 rounds the scores to nearest
    (``internal_distance_dtype``). IP scores come back negated. ``data``
    and ``scale`` as for :func:`fused_list_scan`."""
    if queries.is_cuda:
        return list_scan_cuda(queries.contiguous(), data.contiguous(),
                              norms.contiguous(), ids.contiguous(),
                              qmap.contiguous(), bins, metric, out_dtype,
                              scale)
    return list_scan_plain(queries, data, norms, ids, qmap, bins, metric,
                           out_dtype, scale=scale)

"""IVF-PQ ANN index (counterpart of ``raft_tpu.neighbors.ivf_pq``).

Layout: the JAX package's. Coarse centres and their rotated copies, a
(rot_dim, dim) rotation, codebooks ``pq_centers`` — per subspace
(pq_dim, 2^bits, pq_len) or per cluster (n_lists, 2^bits, pq_len) — and
one u8 code per subspace per row in padded list buckets (n_lists,
max_list, pq_dim), ids -1 on pad slots, exact decoded-residual norms.

Build = balanced k-means on a subsample, nearest-centre labels (the
``fused_l2_nn`` kernel), rotated residuals, then per-subspace codebooks
trained by the grouped balanced EM and encoding, or (``PER_CLUSTER``)
one codebook per list trained by a batched masked k-means over the
list's first subvectors and encoding in place; bucketing. :func:`extend`
encodes new rows with the frozen centres, rotation and books and
buckets old and new codes again. Search, by ``scan_mode``:

* "codes" ("auto"): coarse GEMM + ``select_k`` kernel, probe inversion,
  then the fused PQ scan kernel (``kk = rescore_factor * k <= 256``) or
  the unfused one with a candidate merge (``kk > 256``);
* "reconstruct": a bf16 cache of the decoded lists, filled at the first
  such search, scored in torch ops: probe-major, or list-major for L2
  (``scan_order``, as the JAX package chooses);
* "lut": per probe rank a lookup table per query and a gather of the
  codes, in torch ops (the CUDA formulation the JAX package keeps);

then the epilogue: estimator slice or exact re-rank on the device or the
host. ``kmeans_kernel_precision`` reaches the coarse k-means trainer;
the codebook trainers compute in f32 (the JAX package maps the knob onto
an XLA precision there). The rotation for ``rot_dim != dim`` or
``force_random_rotation`` is the QR of a numpy-seeded gaussian, and a
PER_CLUSTER list's initial codewords a numpy-seeded draw, where the JAX
package draws from ``jax.random``.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import _ivf_scan, ivf_flat
from raft_tpu_torch.neighbors.ann_types import (MAX_QUERY_BATCH,
                                                batched_search,
                                                list_order_auto,
                                                pin_scan_order)
from raft_tpu_torch.neighbors.ivf_bq import finish_search, resolve_raw_device
from raft_tpu_torch.obs import spans
from raft_tpu_torch.ops import ivf_pq_scan as pq_op
from raft_tpu_torch.ops._util import stable_topk_min
from raft_tpu_torch.ops.ivf_scan import resolve_bins
from raft_tpu_torch.util.host_sample import (sample_rows, sample_rows_np,
                                             take_rows)
from raft_tpu_torch.util.segment import segment_sum

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
            DistanceType.InnerProduct)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_SCAN_MODES = ("auto", "codes", "reconstruct", "lut")

# rows per block of the build's row-wise passes (residuals, encoding)
_ROWS = 1 << 20
_ENCODE_ROWS = 1 << 15
# the PER_CLUSTER trainer's subvectors per list
_PC_TRAIN_SUBS = 4096
# guards the lazy fill of the "reconstruct" cache (Index.decoded)
_DECODE_LOCK = threading.Lock()


class CodebookGen(enum.IntEnum):
    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclass
class IndexParams:
    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8          # 4..8
    pq_dim: int = 0           # 0 = dim // 4
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    force_random_rotation: bool = False
    # the trainer's fused L2-NN tier: None / "highest" (f32) only
    kmeans_kernel_precision: object = None
    # keep the raw f32 vectors on the host for exact rescoring
    keep_raw: bool = False
    # codewords under reseed_threshold * (rows / n_codes) assignments
    # re-seed from the highest-cost rows each sweep; 0 disables
    reseed_threshold: float = 0.25


@dataclass
class SearchParams:
    """``lut_dtype``: the scan's operand tier, ``torch.bfloat16``,
    ``torch.float32`` or ``torch.float8_e4m3fn`` (books stored fp8,
    computed in bf16). ``internal_distance_dtype``: the unfused scan's
    candidate scores, float32 or bfloat16. ``scan_mode``: "auto" and
    "codes" run the code scan, "reconstruct" the bf16 decoded-list scan,
    "lut" the lookup-table scan (float8 only with "codes"). ``scan_order``:
    "probe" | "list" | "auto", the reconstruct scan's route for L2 (IP
    is probe-major). ``rescore_factor``: kk = factor * k
    estimator candidates re-ranked exactly against the raw vectors
    (keep_raw builds); ``rescore_on_device`` "auto" | "always" |
    "never" places that re-rank. ``scan_bins``, ``probe_cap``: as for
    IVF-Flat; with kk > k, ``scan_bins=0`` takes
    ``min(max(128, 32 * kk // n_probes), max_list)`` bins."""

    n_probes: int = 20
    lut_dtype: torch.dtype = torch.bfloat16
    internal_distance_dtype: torch.dtype = torch.float32
    scan_mode: str = "auto"
    rescore_factor: int = 0
    scan_order: str = "auto"
    scan_bins: int = 0
    probe_cap: int = 0
    rescore_on_device: str = "auto"


@dataclass
class Index:
    centers: torch.Tensor          # (n_lists, dim)
    centers_rot: torch.Tensor      # (n_lists, rot_dim)
    rotation_matrix: torch.Tensor  # (rot_dim, dim)
    pq_centers: torch.Tensor       # (pq_dim | n_lists, n_codes, pq_len)
    codes: torch.Tensor            # (n_lists, max_list, pq_dim) uint8
    lists_indices: torch.Tensor    # (n_lists, max_list) int32, -1 = pad
    list_sizes: torch.Tensor       # (n_lists,) int32
    metric: DistanceType
    pq_bits: int
    size: int
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    # exact decoded-residual squared norms (n_lists, max_list), 0 on pads
    code_norms: Optional[torch.Tensor] = None
    # the "reconstruct" scan's bf16 decoded lists (n_lists, max_list,
    # rot_dim), pad slots 0, and their norms (the code norms): filled at
    # the first such search; not serialized
    decoded: Optional[torch.Tensor] = None
    decoded_norms: Optional[torch.Tensor] = None
    # the same over the fp8-rounded books (fp8 LUT tier, lazy)
    code_norms_fp8: Optional[torch.Tensor] = None
    # raw f32 vectors on the host (keep_raw builds), indexed by id
    raw: Optional[np.ndarray] = None
    cap_cache: dict = field(default_factory=dict, repr=False, compare=False)
    plan_cache: dict = field(default_factory=dict, repr=False,
                             compare=False)
    # lazy device copy of ``raw`` (rescore_on_device); not serialized
    raw_dev: Optional[torch.Tensor] = None
    # books rounded per LUT tier, keyed by dtype; not serialized
    _lut_cache: dict = field(default_factory=dict, repr=False,
                             compare=False)

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def pq_dim(self) -> int:
        return self.codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.pq_centers.shape[2]

    @property
    def rot_dim(self) -> int:
        return self.rotation_matrix.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def make_rotation_matrix(dim: int, rot_dim: int, force_random: bool = False,
                         seed: int = 7, device=None) -> torch.Tensor:
    """(rot_dim, dim) on ``device`` (default ``cuda``, through
    ``ensure_resources``; ``"cpu"`` only when asked): the identity when
    ``rot_dim == dim`` and not forced, else the orthogonal factor of the
    QR of ``g.T g + 1e-4 I`` for a numpy-seeded gaussian ``g`` (rows
    beyond ``dim`` are zero)."""
    device = ensure_resources(None, device).device
    if rot_dim == dim and not force_random:
        return torch.eye(dim, dtype=torch.float32, device=device)
    g = np.random.default_rng(seed).standard_normal(
        (max(rot_dim, dim), dim)).astype(np.float32)
    q, _ = np.linalg.qr(g.T @ g + 1e-4 * np.eye(dim, dtype=np.float32))
    full = q.T.astype(np.float32)
    if rot_dim <= dim:
        rot = full[:rot_dim]
    else:
        rot = np.concatenate([full, np.zeros((rot_dim - dim, dim),
                                             np.float32)])
    return torch.from_numpy(np.ascontiguousarray(rot)).to(device)


def _labels_and_prep(x: torch.Tensor, centers: torch.Tensor,
                     rot: torch.Tensor):
    """Nearest-centre labels (``fused_l2_nn``), the rotated centres and
    the rotated residuals ``(x - centers[label]) @ rot.T``, in row
    blocks."""
    full_fp32_matmul()
    labels = kmeans_balanced.predict(x, centers)
    centers_rot = centers @ rot.T
    res = torch.empty((x.shape[0], rot.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, x.shape[0], _ROWS):
        lab = labels[s:s + _ROWS].long()
        res[s:s + _ROWS] = (x[s:s + _ROWS] - centers[lab]) @ rot.T
    return labels, centers_rot, res


def _train_books_grouped(residuals_rot, cb_idx, valid, init_idx,
                         pq_dim: int, pq_len: int, n_codes: int,
                         n_iters: int, chunk: int,
                         reseed_threshold: float = 0.25):
    """All subspace codebooks by one batched balanced EM (the JAX
    package's grouped trainer): per sweep, nearest-codeword assignment
    and masked means per subspace, row-chunked, the coordinate sums in a
    fixed order (``segment_sum``; the counts of 0/1 flags are exact in
    any order); codewords under
    ``reseed_threshold`` of the average count re-seed from the
    highest-cost rows. ``cb_idx`` (m,) trainset rows padded cyclically
    to a chunk multiple, ``valid`` (m,) marks real rows, ``init_idx``
    (pq_dim, n_codes) positions into the trainset → (pq_dim, n_codes,
    pq_len)."""
    full_fp32_matmul()
    dev = residuals_rot.device
    m = cb_idx.shape[0]
    tr = residuals_rot[cb_idx.long()]
    sub = tr.reshape(m, pq_dim, pq_len).transpose(0, 1).contiguous()
    centers = torch.gather(sub, 1, init_idx.long()[:, :, None].expand(
        -1, -1, pq_len))
    vf = valid.float()
    avg = vf.sum() / n_codes
    row_of_s = (torch.arange(pq_dim, device=dev) * n_codes)[:, None]
    for _ in range(n_iters):
        cc = (centers * centers).sum(dim=2)                # (S, C)
        counts = torch.zeros(pq_dim * n_codes, device=dev)
        sums = torch.zeros((pq_dim * n_codes, pq_len), device=dev)
        wd = torch.full((pq_dim, n_codes), float("-inf"), device=dev)
        wi = torch.zeros((pq_dim, n_codes), dtype=torch.long, device=dev)
        for c0 in range(0, m, chunk):
            xb = sub[:, c0:c0 + chunk]                     # (S, B, l)
            vb = vf[c0:c0 + chunk]
            ip = torch.einsum("sbl,scl->sbc", xb, centers)
            bb = (xb * xb).sum(dim=2)
            d = (bb[:, :, None] + cc[:, None, :]) - 2.0 * ip
            assign = d.argmin(dim=2)                       # (S, B)
            dmin = torch.gather(d, 2, assign[:, :, None])[:, :, 0]
            slot = (row_of_s + assign).reshape(-1)
            # counts of 0/1 flags are exact in any order of adding
            counts.index_add_(0, slot, vb.expand(pq_dim, -1).reshape(-1))
            sums += segment_sum((xb * vb[None, :, None]).reshape(
                -1, pq_len), slot, pq_dim * n_codes)[0]
            # running top-n_codes worst-cost rows per subspace (the
            # reseed pool; padded rows never qualify), ties to the
            # earlier entry as lax.top_k breaks them
            dmin = torch.where(vb[None, :] > 0, dmin,
                               torch.full_like(dmin, float("-inf")))
            cd = torch.cat([wd, dmin], dim=1)
            cix = torch.cat([wi, torch.arange(c0, c0 + xb.shape[1],
                                              device=dev).expand(
                                                  pq_dim, -1)], dim=1)
            _, sel = stable_topk_min(-cd, n_codes)
            wd = torch.gather(cd, 1, sel)
            wi = torch.gather(cix, 1, sel)
        counts = counts.reshape(pq_dim, n_codes)
        sums = sums.reshape(pq_dim, n_codes, pq_len)
        newc = sums / torch.clamp(counts, min=1.0)[:, :, None]
        newc = torch.where(counts[:, :, None] > 0, newc, centers)
        small = counts < reseed_threshold * avg
        slot = torch.cumsum(small.to(torch.long), dim=1) - 1
        seeds = torch.gather(sub, 1, wi[:, :, None].expand(-1, -1, pq_len))
        reseed = torch.gather(seeds, 1, slot.clamp(0, n_codes - 1)[
            :, :, None].expand(-1, -1, pq_len))
        centers = torch.where(small[:, :, None], reseed, newc)
    return centers


def _train_codebooks_per_subspace(residuals_rot, pq_dim: int, pq_len: int,
                                  n_codes: int, n_iters: int, seed: int,
                                  cb_idx=None,
                                  reseed_threshold: float = 0.25):
    """Host glue around :func:`_train_books_grouped`: the chunk padding
    and the numpy-seeded initial codewords, drawn exactly as the JAX
    package draws them. ``cb_idx``: host trainset rows (None = all)."""
    n = residuals_rot.shape[0]
    if cb_idx is None:
        cb_idx = np.arange(n, dtype=np.int32)
    m = int(cb_idx.shape[0])
    chunk = min(m, 4096)
    m_pad = -(-m // chunk) * chunk
    pad_idx = np.asarray(cb_idx, np.int64)[np.arange(m_pad) % m]
    valid = np.arange(m_pad) < m
    rng = np.random.default_rng(seed)
    init_idx = np.stack([rng.choice(m, n_codes, replace=m < n_codes)
                         for _ in range(pq_dim)])
    dev = residuals_rot.device
    return _train_books_grouped(
        residuals_rot, torch.from_numpy(pad_idx).to(dev),
        torch.from_numpy(valid).to(dev),
        torch.from_numpy(init_idx.astype(np.int64)).to(dev), pq_dim,
        pq_len, n_codes, n_iters, chunk, reseed_threshold)


def _list_chunk(n_lists: int, per_list_elems: int,
                budget: int = 1 << 26) -> int:
    """Largest divisor of ``n_lists`` whose chunk keeps
    ``per_list_elems * chunk`` under ``budget`` elements (bounds the
    per-cluster trainer's and encoder's (chunk, M, C) blocks)."""
    return _ivf_scan.largest_divisor_at_most(
        n_lists, max(1, budget // max(1, per_list_elems)))


def _initial_codewords(valid: torch.Tensor, n_codes: int,
                       seed: int) -> torch.Tensor:
    """(L, n_codes) positions of each list's initial codewords: a random
    order of the list's valid rows (numpy-seeded), valid rows first, as
    the JAX package orders them from its ``jax.random`` draw."""
    rng = np.random.default_rng(seed)
    score = torch.from_numpy(rng.random(tuple(valid.shape),
                                        dtype=np.float32)).to(valid.device)
    score = score + torch.where(valid, 0.0, 2.0)
    return torch.argsort(score, dim=1, stable=True)[:, :n_codes]


def _train_books_per_cluster(data: torch.Tensor, valid: torch.Tensor,
                             n_codes: int, n_iters: int, chunk: int,
                             first: torch.Tensor) -> torch.Tensor:
    """One k-means per list over its masked rows (the JAX package's
    ``_batched_masked_kmeans``), ``chunk`` lists at a time: per sweep,
    nearest codeword by an f32 ``bmm``, then each codeword's mean of its
    valid rows as a one-hot ``bmm`` (a sum in a fixed order); a codeword
    with no row keeps its place. ``data`` (L, M, D) f32, ``valid`` (L, M)
    bool, ``first`` (L, n_codes) initial row positions → (L, n_codes, D)."""
    full_fp32_matmul()
    L, M, D = data.shape
    out = torch.empty((L, n_codes, D), dtype=torch.float32,
                      device=data.device)
    for l0 in range(0, L, chunk):
        db = data[l0:l0 + chunk]
        vb = valid[l0:l0 + chunk].float()
        c = torch.gather(db, 1, first[l0:l0 + chunk].long()[:, :, None]
                         .expand(-1, -1, D))
        xx = (db * db).sum(dim=2)[:, :, None]
        for _ in range(n_iters):
            cc = (c * c).sum(dim=2)[:, None, :]
            d = (xx + cc) - 2.0 * torch.bmm(db, c.transpose(1, 2))
            oh = torch.nn.functional.one_hot(d.argmin(dim=2), n_codes).float()
            oh = oh * vb[:, :, None]
            counts = oh.sum(dim=1)
            sums = torch.bmm(oh.transpose(1, 2), db)
            newc = sums / torch.clamp(counts, min=1.0)[:, :, None]
            c = torch.where(counts[:, :, None] > 0, newc, c)
        out[l0:l0 + chunk] = c
    return out


def _nearest_code(sub: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """argmin_j ||sub - books[j]||² over the last axis, batched over the
    leading dims: ``sub`` (..., S, l), ``books`` (..., C, l) → (..., S)
    uint8. The one per-cluster encoding equation, shared by the build and
    :func:`extend`."""
    full_fp32_matmul()
    ip = sub @ books.transpose(-2, -1)
    bb = (books * books).sum(dim=-1)[..., None, :]
    ss = (sub * sub).sum(dim=-1)[..., :, None]
    return ((ss + bb) - 2.0 * ip).argmin(dim=-1).to(torch.uint8)


def _encode_per_cluster(bucketed: torch.Tensor, books: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """codes[l, i, s] = nearest codeword of list l's book to subvector s
    of bucketed row (l, i), ``chunk`` lists at a time → (L, M, pq_dim)
    uint8."""
    L, M, rot_dim = bucketed.shape
    pq_len = books.shape[2]
    pq_dim = rot_dim // pq_len
    out = torch.empty((L, M, pq_dim), dtype=torch.uint8,
                      device=bucketed.device)
    for l0 in range(0, L, chunk):
        rb = bucketed[l0:l0 + chunk]
        sub = rb.reshape(rb.shape[0], M * pq_dim, pq_len)
        out[l0:l0 + chunk] = _nearest_code(
            sub, books[l0:l0 + chunk]).reshape(-1, M, pq_dim)
    return out


def _build_per_cluster(residuals_rot, labels, n_lists: int, pq_dim: int,
                       pq_len: int, n_codes: int, n_iters: int, seed: int):
    """The PER_CLUSTER branch of :func:`build`: bucket the rotated
    residuals, train each list's book on its first ``_PC_TRAIN_SUBS``
    subvectors (short lists repeated up to ``n_codes``) from the
    numpy-seeded initial codewords, encode each list in place →
    (books, codes_b, ids, counts)."""
    bucketed, idx, _, counts = ivf_flat._bucketize(
        residuals_rot, labels, n_lists, compute_norms=False)
    L, M, _ = bucketed.shape
    t_sub = min(M * pq_dim, _PC_TRAIN_SUBS)
    rows = -(-t_sub // pq_dim)
    tr_sub = bucketed[:, :rows].reshape(L, rows * pq_dim, pq_len)[:, :t_sub]
    tr_valid = (idx[:, :rows] >= 0).repeat_interleave(pq_dim, dim=1)[
        :, :t_sub]
    if t_sub < n_codes:
        # short lists: repeat the slice up to n_codes rows (duplicate
        # seeds are harmless: an empty codeword keeps its place)
        reps = -(-n_codes // t_sub)
        tr_sub = tr_sub.repeat(1, reps, 1)[:, :n_codes]
        tr_valid = tr_valid.repeat(1, reps)[:, :n_codes]
    books = _train_books_per_cluster(
        tr_sub.contiguous(), tr_valid, n_codes, n_iters,
        _list_chunk(L, tr_sub.shape[1] * n_codes),
        _initial_codewords(tr_valid, n_codes, seed))
    del tr_sub
    codes_b = _encode_per_cluster(bucketed, books,
                                  _list_chunk(L, M * pq_dim * n_codes))
    return books, codes_b, idx, counts


def _encode(residuals_rot: torch.Tensor, pq_centers: torch.Tensor):
    """codes[i, s] = argmin_j ||sub(i, s) - pq_centers[s, j]||², in row
    blocks (a (rows, pq_dim, n_codes) distance block each) → (n, pq_dim)
    uint8."""
    full_fp32_matmul()
    pq_dim, n_codes, pq_len = pq_centers.shape
    n = residuals_rot.shape[0]
    bb = (pq_centers * pq_centers).sum(dim=2)              # (S, C)
    out = torch.empty((n, pq_dim), dtype=torch.uint8,
                      device=residuals_rot.device)
    for s in range(0, n, _ENCODE_ROWS):
        sub = residuals_rot[s:s + _ENCODE_ROWS].reshape(-1, pq_dim, pq_len)
        vv = (sub * sub).sum(dim=2)
        ip = torch.einsum("bsl,scl->bsc", sub, pq_centers)
        d = (vv[:, :, None] + bb[None, :, :]) - 2.0 * ip
        out[s:s + _ENCODE_ROWS] = d.argmin(dim=2).to(torch.uint8)
    return out


def _code_norms(codes_b: torch.Tensor, pq_centers: torch.Tensor,
                lists_indices: torch.Tensor) -> torch.Tensor:
    """Exact ||decoded||² per bucketed slot, Σ_s ||book_s[c_s]||² added
    in subspace order; pad slots 0."""
    bb = (pq_centers * pq_centers).sum(dim=2)              # (S, C)
    norms = torch.zeros(lists_indices.shape, dtype=torch.float32,
                        device=codes_b.device)
    for s in range(codes_b.shape[2]):
        norms = norms + bb[s][codes_b[:, :, s].long()]
    return torch.where(lists_indices >= 0, norms, torch.zeros_like(norms))


def _code_norms_per_cluster(codes_b: torch.Tensor, books: torch.Tensor,
                            lists_indices: torch.Tensor) -> torch.Tensor:
    """The same for PER_CLUSTER books: list l's subspaces share its
    codebook, so the norm is Σ_s ||books_l[c_s]||²."""
    bb = (books * books).sum(dim=2)                        # (L, C)
    norms = torch.zeros(lists_indices.shape, dtype=torch.float32,
                        device=codes_b.device)
    for s in range(codes_b.shape[2]):
        norms = norms + torch.gather(bb, 1, codes_b[:, :, s].long())
    return torch.where(lists_indices >= 0, norms, torch.zeros_like(norms))


def _norms_fn(per_cluster: bool):
    return _code_norms_per_cluster if per_cluster else _code_norms


def _bucketize_codes(codes, labels, pq_centers, n_lists: int):
    """Bucket the (n, pq_dim) u8 codes into the padded list layout (rows
    in dataset order within a list) and compute their exact norms."""
    codes_b, idx, _, counts = ivf_flat._bucketize(codes, labels, n_lists,
                                                  compute_norms=False)
    return codes_b, idx, counts, _code_norms(codes_b, pq_centers, idx)


@spans.spanned("raft.ivf_pq.build")
@obs.timed("raft.ivf_pq.build")
def build(dataset, params: IndexParams = IndexParams(), seed: int = 0,
          res=None, device=None) -> Index:
    """Train + encode on ``device`` (default ``cuda``; ``"cpu"`` only
    when asked): balanced k-means coarse centres, rotation, codebooks on
    rotated residuals (per subspace, or per list for ``PER_CLUSTER``),
    encoding, bucketing."""
    res = ensure_resources(res, device)
    full_fp32_matmul()
    x = torch.as_tensor(dataset, dtype=torch.float32).to(res.device)
    n, dim = x.shape
    expects(params.n_lists <= n, "ivf_pq.build: n_lists > n_samples")
    expects(params.metric in _METRICS,
            "ivf_pq: L2-family and InnerProduct metrics are supported "
            "(got %s)", params.metric)
    pq_dim = params.pq_dim if params.pq_dim > 0 else max(1, dim // 4)
    rot_dim = -(-dim // pq_dim) * pq_dim
    pq_len = rot_dim // pq_dim
    n_codes = 1 << params.pq_bits
    expects(n >= n_codes,
            "ivf_pq.build: need at least 2^pq_bits (%d) training rows",
            n_codes)
    obs.counter("raft.ivf_pq.build.total").inc()
    obs.counter("raft.ivf_pq.build.rows").inc(n)
    spans.current_span().set_attrs(rows=n, n_lists=params.n_lists,
                                   pq_bits=params.pq_bits)

    n_train = max(params.n_lists, int(n * params.kmeans_trainset_fraction))
    trainset = (take_rows(x, sample_rows(n, n_train, seed, x.device))
                if n_train < n else x)
    centers = kmeans_balanced.build_hierarchical(
        trainset, params.n_lists, params.kmeans_n_iters,
        kernel_precision=params.kmeans_kernel_precision)
    del trainset
    rot = make_rotation_matrix(dim, rot_dim, params.force_random_rotation,
                               seed=seed + 1, device=x.device)
    labels, centers_rot, residuals_rot = _labels_and_prep(x, centers, rot)
    raw = x.cpu().numpy() if params.keep_raw else None
    if params.codebook_kind == CodebookGen.PER_CLUSTER:
        books, codes_b, idx, counts = _build_per_cluster(
            residuals_rot, labels, params.n_lists, pq_dim, pq_len, n_codes,
            params.kmeans_n_iters, seed + 2)
        del residuals_rot
        return Index(centers=centers, centers_rot=centers_rot,
                     rotation_matrix=rot, pq_centers=books, codes=codes_b,
                     lists_indices=idx, list_sizes=counts,
                     metric=params.metric, pq_bits=params.pq_bits, size=n,
                     codebook_kind=CodebookGen.PER_CLUSTER,
                     code_norms=_code_norms_per_cluster(codes_b, books, idx),
                     raw=raw)
    n_cb_train = min(n, 1 << 16)
    cb_idx = (sample_rows_np(n, n_cb_train, seed + 3)
              if n_cb_train < n else None)
    pq_centers = _train_codebooks_per_subspace(
        residuals_rot, pq_dim, pq_len, n_codes, params.kmeans_n_iters,
        seed + 2, cb_idx=cb_idx, reseed_threshold=params.reseed_threshold)
    codes = _encode(residuals_rot, pq_centers)
    del residuals_rot
    codes_b, idx, counts, norms = _bucketize_codes(codes, labels,
                                                   pq_centers,
                                                   params.n_lists)
    return Index(centers=centers, centers_rot=centers_rot,
                 rotation_matrix=rot, pq_centers=pq_centers, codes=codes_b,
                 lists_indices=idx, list_sizes=counts, metric=params.metric,
                 pq_bits=params.pq_bits, size=n, code_norms=norms, raw=raw)


def index_from_numpy(arrays: dict, metric, size: int, pq_bits: int,
                     codebook_kind=CodebookGen.PER_SUBSPACE, raw=None,
                     device="cuda", mesh=None, axis: str = "data") -> Index:
    """An :class:`Index` on ``device`` from numpy arrays of the JAX
    package's ``ivf_pq.Index`` fields (``centers``, ``centers_rot``,
    ``rotation_matrix``, ``pq_centers``, ``codes`` (u8),
    ``lists_indices``, ``list_sizes``), with the optional host ``raw``
    corpus; the code norms are derived. With ``mesh``: a
    ``parallel.DistributedIvfPq`` from the JAX package's multi-part
    fields (the replicated ones and ``parts_*``) over ``mesh[axis]``."""
    if mesh is not None:
        from raft_tpu_torch.parallel.ivf import _parts_from_numpy
        return _parts_from_numpy("ivf_pq", arrays, mesh, axis,
                                metric=metric, size=int(size),
                                pq_bits=int(pq_bits))
    dev = ensure_resources(None, device).device

    def put(name, dtype):
        return torch.from_numpy(ivf_flat._host_array(arrays[name],
                                                     dtype)).to(dev)

    kind = CodebookGen(int(codebook_kind))
    index = Index(centers=put("centers", np.float32),
                  centers_rot=put("centers_rot", np.float32),
                  rotation_matrix=put("rotation_matrix", np.float32),
                  pq_centers=put("pq_centers", np.float32),
                  codes=put("codes", np.uint8),
                  lists_indices=put("lists_indices", np.int32),
                  list_sizes=put("list_sizes", np.int32),
                  metric=DistanceType(int(metric)), pq_bits=int(pq_bits),
                  size=int(size), codebook_kind=kind,
                  raw=(np.ascontiguousarray(raw, np.float32)
                       if raw is not None else None))
    index.code_norms = _norms_fn(kind == CodebookGen.PER_CLUSTER)(
        index.codes, index.pq_centers, index.lists_indices)
    return index


def extend(index: Index, new_vectors, new_indices=None,
           res=None) -> Index:
    """A new index holding ``index``'s codes and ``new_vectors`` (ids
    ``new_indices``, default ``size .. size + n_new``), on the index's
    device: each new row labelled with the frozen centres
    (``kmeans_balanced.predict``), its rotated residual encoded with the
    frozen books (its list's book for ``PER_CLUSTER``), old and new codes
    bucketed again (old rows are moved, never encoded again), the code
    norms recomputed. Custom ids only without ``raw`` (the exact re-rank
    reads ``raw`` by id); new rows are appended to ``raw``."""
    ensure_resources(res, index.device)
    full_fp32_matmul()
    dev = index.device
    x = torch.as_tensor(new_vectors, dtype=torch.float32).to(dev)
    expects(x.dim() == 2 and x.shape[1] == index.dim,
            "ivf_pq.extend: dim mismatch")
    n_new = x.shape[0]
    new_ids = (torch.arange(index.size, index.size + n_new,
                            dtype=torch.int32, device=dev)
               if new_indices is None
               else torch.as_tensor(new_indices).to(dev, torch.int32))
    expects(tuple(new_ids.shape) == (n_new,),
            "ivf_pq.extend: bad new_indices")
    expects(bool((new_ids >= 0).all()),
            "ivf_pq.extend: new_indices must be non-negative (negative "
            "ids are the padding sentinel)")
    expects(index.raw is None or new_indices is None,
            "ivf_pq.extend: custom new_indices are only supported on "
            "keep_raw=False indexes (raw rescore rows are id-indexed)")
    per_cluster = index.codebook_kind == CodebookGen.PER_CLUSTER
    labels = kmeans_balanced.predict(x, index.centers)
    pq_dim, pq_len = index.pq_dim, index.pq_len
    new_codes = torch.empty((n_new, pq_dim), dtype=torch.uint8, device=dev)
    for s in range(0, n_new, _ENCODE_ROWS):
        lab = labels[s:s + _ENCODE_ROWS].long()
        r = (x[s:s + _ENCODE_ROWS] - index.centers[lab]) \
            @ index.rotation_matrix.T
        new_codes[s:s + _ENCODE_ROWS] = (
            _nearest_code(r.reshape(-1, pq_dim, pq_len),
                          index.pq_centers[lab])
            if per_cluster else _encode(r, index.pq_centers))
    n_lists, max_list = index.lists_indices.shape
    flat_ids = index.lists_indices.reshape(-1)
    valid = flat_ids >= 0
    old_list = torch.arange(n_lists, dtype=torch.int32,
                            device=dev).repeat_interleave(max_list)
    codes_b, idx, _, counts = ivf_flat._bucketize(
        torch.cat([index.codes.reshape(-1, pq_dim)[valid], new_codes]),
        torch.cat([old_list[valid], labels]), n_lists,
        row_ids=torch.cat([flat_ids[valid], new_ids]), compute_norms=False)
    return Index(centers=index.centers, centers_rot=index.centers_rot,
                 rotation_matrix=index.rotation_matrix,
                 pq_centers=index.pq_centers, codes=codes_b,
                 lists_indices=idx, list_sizes=counts, metric=index.metric,
                 pq_bits=index.pq_bits, size=index.size + n_new,
                 codebook_kind=index.codebook_kind,
                 code_norms=_norms_fn(per_cluster)(codes_b, index.pq_centers,
                                                   idx),
                 raw=(np.concatenate([index.raw, x.cpu().numpy()])
                      if index.raw is not None else None))


def _decode_lists(codes_b: torch.Tensor, books: torch.Tensor,
                  lists_indices: torch.Tensor,
                  per_cluster: bool) -> torch.Tensor:
    """The "reconstruct" cache: each slot's decoded rotated residual in
    bf16, (n_lists, max_list, rot_dim), pad slots 0; subspace s of a row
    decodes through book s, or its list's book (``per_cluster``). One
    gather per subspace."""
    L, M, pq_dim = codes_b.shape
    n_codes, pq_len = books.shape[1], books.shape[2]
    out = torch.empty((L, M, pq_dim * pq_len), dtype=torch.bfloat16,
                      device=codes_b.device)
    flat = books.reshape(-1, pq_len)
    base = (torch.arange(L, device=codes_b.device) * n_codes)[:, None]
    valid = (lists_indices >= 0)[:, :, None]
    for s in range(pq_dim):
        c = codes_b[:, :, s].long()
        dec = flat[base + c] if per_cluster else books[s][c]
        out[:, :, s * pq_len:(s + 1) * pq_len] = torch.where(
            valid, dec, torch.zeros_like(dec)).bfloat16()
    return out


def _ensure_decoded(index: Index, per_cluster: bool) -> None:
    """Fill the "reconstruct" cache once, under a lock (two serving
    threads must not decode it twice); its norms are the exact code
    norms."""
    if index.decoded is not None and index.decoded_norms is not None:
        return
    with _DECODE_LOCK:
        if index.decoded is None:
            index.decoded = _decode_lists(index.codes, index.pq_centers,
                                          index.lists_indices, per_cluster)
        if index.decoded_norms is None:
            if index.code_norms is None:
                index.code_norms = _norms_fn(per_cluster)(
                    index.codes, index.pq_centers, index.lists_indices)
            index.decoded_norms = index.code_norms


def _score_probe_reconstruct(q_rot, centers_rot, decoded, decoded_norms,
                             lists_indices, list_id, kind: str):
    """One probe rank on the reconstruct cache: every query against its
    ``list_id`` list → ((nq, max_list) scores, ids), pads +inf. L2:
    ``|r|^2 + |dec|^2 - 2 r.dec`` with ``r`` the bf16-rounded rotated
    residual; IP: ``-(q.dec + q.c_l)``, the first product on the bf16
    query. One bf16 product with f32 sums (``_ivf_scan.bf16_dot``)."""
    lid = list_id.long()
    data = decoded[lid]                               # (nq, ml, rot_dim)
    ids = lists_indices[lid]
    inf = torch.full(ids.shape, float("inf"), device=ids.device)
    if kind == "ip":
        ip = _ivf_scan.bf16_dot(q_rot[:, None, :], data)[:, 0]
        cq = (q_rot * centers_rot[lid]).sum(dim=1)
        return torch.where(ids >= 0, -(ip + cq[:, None]), inf), ids
    resid = (q_rot - centers_rot[lid]).bfloat16().float()
    ip = _ivf_scan.bf16_dot(resid[:, None, :], data)[:, 0]
    rr = (resid * resid).sum(dim=1)
    d = (rr[:, None] + decoded_norms[lid]) - 2.0 * ip
    return torch.where(ids >= 0, torch.clamp(d, min=0.0), inf), ids


def _search_impl_reconstruct(q, centers, centers_rot, rot, decoded,
                             decoded_norms, lists_indices, k: int,
                             n_probes: int, sqrt: bool, kind: str = "l2"):
    """Probe-major scan of the reconstruct cache → (dists, ids)."""
    full_fp32_matmul()
    q_rot = q @ rot.T
    return _ivf_scan.probe_major_search(
        q, centers, n_probes, k, sqrt, kind,
        lambda lid: _score_probe_reconstruct(q_rot, centers_rot, decoded,
                                             decoded_norms, lists_indices,
                                             lid, kind))


def _search_impl(q, centers, centers_rot, rot, pq_centers, codes,
                 lists_indices, k: int, n_probes: int, sqrt: bool,
                 kind: str = "l2", per_cluster: bool = False):
    """The "lut" scan, probe-major (the JAX package's ``_search_impl``):
    per probe rank a per-query table ``lut[q, s, j]`` — ``|r_s -
    book_j|^2`` of the rotated residual's subvector, or ``q_s.book_j``
    for IP (built once for per-subspace books, the centre term added
    after the gather) — then the gather of each row's codes and the sum
    over subspaces → (dists, ids)."""
    full_fp32_matmul()
    nq = q.shape[0]
    pq_dim, pq_len = codes.shape[2], pq_centers.shape[2]
    n_codes = pq_centers.shape[1]
    q_rot = q @ rot.T
    q_sub = q_rot.reshape(nq, pq_dim, pq_len)
    bb = (pq_centers * pq_centers).sum(dim=2)            # (pq_dim|L, C)
    ip_lut = None
    if kind == "ip" and not per_cluster:
        ip_lut = torch.einsum("qsl,sjl->qsj", q_sub, pq_centers)
    col = (torch.arange(pq_dim, device=q.device) * n_codes)[None, None, :]

    def score_probe(list_id):
        lid = list_id.long()
        if per_cluster:
            books = pq_centers[lid]                      # (nq, C, l)
            if kind == "ip":
                lut = torch.einsum("qsl,qjl->qsj", q_sub, books)
            else:
                sub = (q_rot - centers_rot[lid]).reshape(nq, pq_dim, pq_len)
                ip = torch.einsum("qsl,qjl->qsj", sub, books)
                ss = (sub * sub).sum(dim=2)
                lut = (ss[:, :, None] + bb[lid][:, None, :]) - 2.0 * ip
        elif kind == "ip":
            lut = ip_lut
        else:
            sub = (q_rot - centers_rot[lid]).reshape(nq, pq_dim, pq_len)
            ip = torch.einsum("qsl,sjl->qsj", sub, pq_centers)
            ss = (sub * sub).sum(dim=2)
            lut = (ss[:, :, None] + bb[None, :, :]) - 2.0 * ip
        pcodes = codes[lid].long()                       # (nq, ml, pq_dim)
        ids = lists_indices[lid]
        ml = pcodes.shape[1]
        d = torch.gather(lut.reshape(nq, -1), 1,
                         (pcodes + col).reshape(nq, -1)).reshape(
                             nq, ml, pq_dim).sum(dim=2)
        inf = torch.full_like(d, float("inf"))
        if kind == "ip":
            cq = (q_rot * centers_rot[lid]).sum(dim=1)
            return torch.where(ids >= 0, -(d + cq[:, None]), inf), ids
        return torch.where(ids >= 0, torch.clamp(d, min=0.0), inf), ids

    return _ivf_scan.probe_major_search(q, centers, n_probes, k, sqrt, kind,
                                        score_probe)


def _ensure_code_norms(index: Index, params: SearchParams,
                       per_cluster: bool, kind: str) -> torch.Tensor:
    """Code norms matched to the LUT tier: the fp8 tier's L2 scores use
    the norms of the fp8-rounded books; every other tier the exact
    build-time norms."""
    if params.lut_dtype == torch.float8_e4m3fn and kind == "l2":
        if index.code_norms_fp8 is None:
            books8 = index.pq_centers.to(torch.float8_e4m3fn).float()
            index.code_norms_fp8 = _norms_fn(per_cluster)(
                index.codes, books8, index.lists_indices)
        return index.code_norms_fp8
    if index.code_norms is None:
        index.code_norms = _norms_fn(per_cluster)(
            index.codes, index.pq_centers, index.lists_indices)
    return index.code_norms


def _lut_books(index: Index, lut_dtype):
    """``(books, round_q)`` of the LUT tier, cached on the index."""
    got = index._lut_cache.get(lut_dtype)
    if got is None:
        got = pq_op.lut_operands(index.pq_centers, lut_dtype)
        index._lut_cache[lut_dtype] = got
    return got


def _check_params(params: SearchParams) -> None:
    expects(params.scan_mode in _SCAN_MODES,
            "ivf_pq.search: unknown scan_mode %r", params.scan_mode)
    expects(params.scan_order in ("auto", "probe", "list"),
            "ivf_pq.search: unknown scan_order %r", params.scan_order)
    expects(params.rescore_factor >= 0,
            "ivf_pq.search: rescore_factor must be >= 0")
    expects(params.rescore_on_device in ("auto", "always", "never"),
            "ivf_pq.search: rescore_on_device: want auto|always|never, "
            "got %r", params.rescore_on_device)
    expects(params.lut_dtype in pq_op.LUT_DTYPES,
            "ivf_pq: lut_dtype must be float32|bfloat16|float8_e4m3fn")
    expects(params.internal_distance_dtype in (torch.float32,
                                               torch.bfloat16),
            "ivf_pq: internal_distance_dtype must be float32|bfloat16")


def code_scan(q_rot, centers_rot, books, round_q: bool, codes, norms, ids,
              probes, k: int, cap: int, bins: int, sqrt: bool, kind: str,
              per_cluster: bool, internal_bf16: bool, fused: bool):
    """The fine phase over the codes (counterpart of the JAX package's
    ``ivf_pq_code_scan_pallas``): probe inversion, then the fused scan
    kernel, or the unfused one + the IP centre term + the candidate
    merge → (dists (nq, k), ids), best first. ``bins``: 0 = auto
    (``ops.ivf_scan.resolve_bins``)."""
    n_lists, max_list = ids.shape
    bins, _ = resolve_bins(bins, k, max_list)
    qmap, inv_pos = _ivf_scan._invert_probes(probes, n_lists, cap)
    args = (q_rot, centers_rot, books, codes, norms, ids)
    if fused:
        return pq_op.pq_scan_fused(*args, probes, inv_pos, qmap, cap, k,
                                   bins, sqrt=sqrt, metric=kind,
                                   round_q=round_q, per_cluster=per_cluster)
    cd, ci = pq_op.pq_scan(*args, qmap, bins, metric=kind, round_q=round_q,
                           per_cluster=per_cluster, round_out=internal_bf16)
    if kind == "ip":
        # the kernel scored -q.dec; add the centre term -q.c_l
        qc = (q_rot @ centers_rot.T).T                      # (L, nq)
        corr = torch.gather(qc, 1, qmap.clamp(min=0).long())
        cd = cd - corr[:, :, None]
    return _ivf_scan.merge_candidates(cd, ci, probes, inv_pos, k, sqrt,
                                      cap=cap)


class _Route:
    """What one (index, k, params) point resolves to: the scan mode, the
    kk estimator depth, bins, sqrt placement and whether the fused kernel
    takes it. It holds the index's arrays that a search reads, never the
    index itself: a plan keeps its route, the index keeps its plans
    (``plan_cache``), and a reference back would keep a dropped index's
    device memory until a cyclic garbage-collection pass. A
    "reconstruct" route fills the index's decode cache."""

    def __init__(self, index: Index, k: int, params: SearchParams):
        _check_params(params)
        # "auto" is the code scan, where the kernels are
        self.scan_mode = ("codes" if params.scan_mode == "auto"
                          else params.scan_mode)
        expects(params.lut_dtype != torch.float8_e4m3fn
                or self.scan_mode == "codes",
                "ivf_pq: lut_dtype=float8_e4m3fn requires scan_mode='codes' "
                "(resolved scan_mode is %r)", self.scan_mode)
        self.centers, self.centers_rot = index.centers, index.centers_rot
        self.rotation_matrix = index.rotation_matrix
        self.codes, self.ids = index.codes, index.lists_indices
        self.pq_centers = index.pq_centers
        self.metric, self.raw = index.metric, index.raw
        self.k = k
        self.n_lists = index.n_lists
        self.n_probes = min(params.n_probes, index.n_lists)
        self.kind = ivf_flat._metric_kind(index.metric)
        self.sqrt = index.metric in _SQRT_METRICS
        self.per_cluster = index.codebook_kind == CodebookGen.PER_CLUSTER
        self.scan_order = params.scan_order
        self.rescoring = params.rescore_factor > 0 and index.raw is not None
        self.kk = max(params.rescore_factor, 1) * k
        # sqrt moves to the epilogue unless the scan's top-k is final
        self.dev_sqrt = self.sqrt and self.kk == k and not self.rescoring
        bins = params.scan_bins
        if bins == 0 and self.kk > k:
            # the global-pool rule: a 32x-oversampled pool spread over
            # the probed lists, floor 128
            bins = min(max(128, (32 * self.kk) // max(self.n_probes, 1)),
                       index.codes.shape[1])
        self.bins = bins
        self.fused = self.scan_mode == "codes" and self.kk <= pq_op.MAX_K
        self.internal_bf16 = params.internal_distance_dtype == torch.bfloat16
        if self.scan_mode == "reconstruct":
            _ensure_decoded(index, self.per_cluster)
            self.decoded = index.decoded
            self.decoded_norms = index.decoded_norms

    def list_major(self, nq: int) -> bool:
        """Whether ``nq`` queries take a list-major scan: the code scan
        always, the reconstruct scan for L2 by ``scan_order`` ("auto":
        ``list_order_auto``), the LUT scan never."""
        if self.scan_mode == "codes":
            return True
        return (self.scan_mode == "reconstruct" and self.kind == "l2"
                and (self.scan_order == "list"
                     or (self.scan_order == "auto"
                         and list_order_auto(nq, self.n_probes,
                                             self.n_lists))))

    def device_phase(self, q: torch.Tensor, cap: int, books=None,
                     round_q: bool = False, norms=None):
        """Coarse probes, query rotation and the scan of the route's mode
        → kk estimator candidates (dists, ids), best first. The code
        scan takes the LUT tier's ``books``, ``round_q`` and ``norms``;
        ``cap`` is read by the list-major scans."""
        full_fp32_matmul()
        if self.scan_mode == "reconstruct":
            if self.list_major(q.shape[0]):
                return _ivf_scan.fused_reconstruct_list_search(
                    q, self.centers, self.centers_rot, self.rotation_matrix,
                    self.decoded, self.decoded_norms, self.ids, k=self.kk,
                    n_probes=self.n_probes, cap=cap, bins=self.bins,
                    sqrt=self.dev_sqrt)
            return _search_impl_reconstruct(
                q, self.centers, self.centers_rot, self.rotation_matrix,
                self.decoded, self.decoded_norms, self.ids, self.kk,
                self.n_probes, self.dev_sqrt, kind=self.kind)
        if self.scan_mode == "lut":
            return _search_impl(q, self.centers, self.centers_rot,
                                self.rotation_matrix, self.pq_centers,
                                self.codes, self.ids, self.kk, self.n_probes,
                                self.dev_sqrt, kind=self.kind,
                                per_cluster=self.per_cluster)
        probes = _ivf_scan.coarse_probes(q, self.centers, self.n_probes,
                                         kind=self.kind)
        q_rot = (q @ self.rotation_matrix.T).contiguous()
        return code_scan(q_rot, self.centers_rot, books, round_q,
                         self.codes, norms, self.ids, probes,
                         self.kk, cap, self.bins, self.dev_sqrt, self.kind,
                         self.per_cluster, self.internal_bf16, self.fused)

    def epilogue(self, d, i, q, raw_dev):
        """Estimator slice or exact re-rank (on the device with
        ``raw_dev``, else on the host), then the output conventions."""
        if self.kk == self.k and not self.rescoring:
            return ivf_flat._postprocess(d, self.metric), i
        return finish_search(d, i, self.raw, q, self.k,
                             metric=self.metric, rescore=self.rescoring,
                             raw_dev=raw_dev)


@spans.spanned("raft.ivf_pq.search")
def search(index: Index, queries, k: int,
           params: SearchParams = SearchParams(), res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search → (dists (nq, k) f32, ids (nq, k) int32) on the index's
    device: exact distances when rescoring, PQ estimates otherwise, in
    the IVF-Flat output conventions."""
    sp = spans.current_span()
    sp.set_attr("k", k)
    ensure_resources(res, index.device)
    full_fp32_matmul()
    q = torch.as_tensor(queries, dtype=torch.float32).to(
        index.device).contiguous()
    sp.set_attr("nq", int(q.shape[0]))
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "ivf_pq.search: dim mismatch")
    route = _Route(index, k, params)
    if q.shape[0] > MAX_QUERY_BATCH:
        pinned = pin_scan_order(params, q.shape[0], index.n_lists)
        return batched_search(lambda qb: search(index, qb, k, pinned), q,
                              max_batch=MAX_QUERY_BATCH)
    sp.set_attr("n_probes", route.n_probes)
    # per-batch telemetry (a batched search comes here per sub-batch)
    obs.counter("raft.ivf_pq.search.queries").inc(q.shape[0])
    obs.histogram("raft.ivf_pq.search.batch_size",
                  buckets=obs.SIZE_BUCKETS).observe(q.shape[0])
    obs.histogram("raft.ivf_pq.search.n_probes",
                  buckets=obs.SIZE_BUCKETS).observe(route.n_probes)
    with obs.timed("raft.ivf_pq.search", mode=route.scan_mode):
        cap = (_ivf_scan.resolve_cap(index.cap_cache, q, index.centers,
                                     params, route.n_probes, index.n_lists,
                                     kind=route.kind)
               if route.list_major(q.shape[0]) else 0)
        books, round_q, norms = None, False, None
        if route.scan_mode == "codes":
            norms = _ensure_code_norms(index, params, route.per_cluster,
                                       route.kind)
            books, round_q = _lut_books(index, params.lut_dtype)
        if route.fused:
            obs.counter("raft.ivf_scan.fused.total", family="ivf_pq").inc()
            obs.counter("raft.ivf_scan.fused.queries").inc(q.shape[0])
        d, i = route.device_phase(q, cap, books, round_q, norms)
    raw_dev = (resolve_raw_device(index, params.rescore_on_device)
               if route.rescoring else None)
    return route.epilogue(d, i, q, raw_dev)

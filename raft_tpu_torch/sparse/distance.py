"""Sparse pairwise distances (counterpart of ``raft_tpu.sparse.distance``).

Two tiers, split by feature width exactly as the JAX package splits them:

* **Narrow tier**: densify row tiles of x (and all of y) and hand them to
  the dense ``distance.pairwise.distance``: kernel 7 on the card for the
  elementwise metrics, one full-f32 ``torch.matmul`` for the matmul
  family. Its result is the dense function's on the densified rows, bit
  for bit.
* **Wide tier** (the reference's hash strategy): never densify the
  feature dim. Both operands are scattered one column tile at a time
  (``col_tile`` wide) and per-tile partials accumulate: ``ip += Xt @
  Ytᵀ`` for the matmul family, with the row statistics its epilogues
  need summed straight off the CSR values; ``reduce_k(combine(x, y))``
  of ``distance/_elementwise_cores.py`` for the elementwise family,
  combined with ``+`` (``max`` for Linf) and finalized once. Every
  combine maps (0, 0) to 0, so the zeros of a tile are exact.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance import _elementwise_cores as cores
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.distance.pairwise import ELT_KERNEL
from raft_tpu_torch.distance.pairwise import distance as dense_distance
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.op import csr_slice_rows

# peak densified scratch, in f32 elements
_TILE_BUDGET_ELEMS = 1 << 23
# column-tile width of the wide tier
_WIDE_COL_TILE = 2048


def _densify(csr: CSR) -> torch.Tensor:
    return csr.todense().float()


class _CsrF32(NamedTuple):
    """A CSR unpacked for tile scatters: per-nonzero row, column and f32
    value, and the row lengths."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    lengths: torch.Tensor
    n_rows: int


def _unpack(csr: CSR) -> _CsrF32:
    return _CsrF32(csr.row_ids().long(), csr.indices.long(),
                   csr.data.float(), csr.row_lengths().long(), csr.shape[0])


def _tile_of(c: _CsrF32, start: int, width: int,
             transform=None) -> torch.Tensor:
    """Dense (n_rows, width) block of columns [start, start + width): one
    scatter of every nonzero, those outside the tile into an extra column
    that is dropped."""
    vals = c.vals if transform is None else transform(c.vals)
    in_tile = (c.cols >= start) & (c.cols < start + width)
    local = torch.where(in_tile, c.cols - start, width)
    out = torch.zeros((c.n_rows, width + 1), device=vals.device)
    out.index_put_((c.rows, local), vals, accumulate=True)
    return out[:, :width]


def _row_stat(c: _CsrF32, fn) -> torch.Tensor:
    """A per-row sum of ``fn`` of the values, straight off the CSR."""
    return torch.segment_reduce(fn(c.vals), "sum", lengths=c.lengths,
                                unsafe=True, initial=0)


def _accumulate_ip(x: _CsrF32, y: _CsrF32, k: int, tile: int,
                   transform=None) -> torch.Tensor:
    """Σ over column tiles of Xt @ Ytᵀ in full f32."""
    full_fp32_matmul()
    acc = torch.zeros((x.n_rows, y.n_rows), device=x.vals.device)
    for start in range(0, k, tile):
        xt = _tile_of(x, start, tile, transform)
        yt = _tile_of(y, start, tile, transform)
        acc += xt @ yt.T
    return acc


def _accumulate_elt(x: _CsrF32, y: _CsrF32, k: int, tile: int,
                    combine: Callable, max_reduce: bool, n_acc: int = 1):
    """reduce_k(combine(xt, yt)) accumulated over column tiles (sum, or
    max for Linf); the (rows, n, tile) broadcast is itself cut into row
    chunks of at most the scratch budget. ``combine`` returns ``n_acc``
    terms (Bray-Curtis two)."""
    m, n = x.n_rows, y.n_rows
    rt = max(1, min(m, _TILE_BUDGET_ELEMS // max(1, n * tile)))
    accs = [torch.zeros((m, n), device=x.vals.device) for _ in range(n_acc)]
    for start in range(0, k, tile):
        xt = _tile_of(x, start, tile)
        yt = _tile_of(y, start, tile)
        for s in range(0, m, rt):
            parts = combine(xt[s:s + rt, None, :], yt[None, :, :])
            if n_acc == 1:
                parts = (parts,)
            for acc, p in zip(accs, parts):
                if max_reduce:
                    torch.maximum(acc[s:s + rt], p.amax(dim=2),
                                  out=acc[s:s + rt])
                else:
                    acc[s:s + rt] += p.sum(dim=2)
    return accs[0] if n_acc == 1 else tuple(accs)


def _eps_div(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0.0, torch.ones_like(d), d)


def _wide_matmul(x: _CsrF32, y: _CsrF32, k: int, tile: int,
                 metric: DistanceType) -> torch.Tensor:
    if metric in (DistanceType.JaccardExpanded, DistanceType.DiceExpanded):
        def ind(v):
            return (v != 0).float()
        inter = _accumulate_ip(x, y, k, tile, transform=ind)
        nx, ny = _row_stat(x, ind), _row_stat(y, ind)
        if metric == DistanceType.JaccardExpanded:
            union = nx[:, None] + ny[None, :] - inter
            return 1.0 - inter / _eps_div(union)
        return 1.0 - 2.0 * inter / _eps_div(nx[:, None] + ny[None, :])
    if metric == DistanceType.HellingerExpanded:
        ip = _accumulate_ip(x, y, k, tile,
                            transform=lambda v: torch.sqrt(v.abs()))
        return torch.sqrt(torch.clamp(1.0 - torch.clamp(ip, max=1.0),
                                      min=0.0))
    ip = _accumulate_ip(x, y, k, tile)
    if metric == DistanceType.InnerProduct:
        return ip
    if metric == DistanceType.RusselRaoExpanded:
        return (k - ip) / float(k)

    def sq(v):
        return v * v
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xx, yy = _row_stat(x, sq), _row_stat(y, sq)
        d = torch.clamp(xx[:, None] + yy[None, :] - 2.0 * ip, min=0.0)
        return torch.sqrt(d) if metric == DistanceType.L2SqrtExpanded else d
    if metric == DistanceType.CosineExpanded:
        xn = torch.sqrt(_row_stat(x, sq))
        yn = torch.sqrt(_row_stat(y, sq))
        return 1.0 - ip / _eps_div(xn[:, None] * yn[None, :])
    if metric == DistanceType.CorrelationExpanded:
        def ident(v):
            return v
        sx, sy = _row_stat(x, ident), _row_stat(y, ident)
        x2, y2 = _row_stat(x, sq), _row_stat(y, sq)
        numer = k * ip - sx[:, None] * sy[None, :]
        dx = torch.sqrt(torch.clamp(k * x2 - sx * sx, min=0.0))
        dy = torch.sqrt(torch.clamp(k * y2 - sy * sy, min=0.0))
        return 1.0 - numer / _eps_div(dx[:, None] * dy[None, :])
    raise ValueError(f"wide sparse: unhandled matmul metric {metric}")


def _wide_elt(x: _CsrF32, y: _CsrF32, k: int, tile: int,
              metric: DistanceType, metric_arg: float) -> torch.Tensor:
    tag, sqrt = ELT_KERNEL[metric]
    p = float(metric_arg)
    d = _accumulate_elt(x, y, k, tile,
                        lambda a, b: cores.combine(tag, a, b, p),
                        tag in cores.MAX_REDUCE,
                        n_acc=2 if tag in cores.PAIR_ACCUM else 1)
    return cores.finalize(tag, d, p, k, sqrt)


_WIDE_MATMUL_METRICS = frozenset({
    DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
    DistanceType.CosineExpanded, DistanceType.CorrelationExpanded,
    DistanceType.InnerProduct, DistanceType.HellingerExpanded,
    DistanceType.RusselRaoExpanded, DistanceType.JaccardExpanded,
    DistanceType.DiceExpanded,
})
_WIDE_ELT_METRICS = frozenset(ELT_KERNEL)


def pairwise_distance(x: CSR, y: CSR,
                      metric: DistanceType = DistanceType.L2Expanded,
                      metric_arg: float = 2.0, res=None,
                      col_tile: Optional[int] = None) -> torch.Tensor:
    """All-pairs distances between the rows of two CSRs on one device →
    dense (m, n) float32. Narrow feature dims take the densified tiles;
    wide ones (``(m + n) * k`` over the scratch budget and ``k`` over the
    wide tile), or an explicit ``col_tile``, the column-tiled
    accumulation."""
    if x.shape[1] != y.shape[1]:
        raise ValueError("sparse pairwise: feature dim mismatch")
    ensure_resources(res, x.device)
    metric = DistanceType(metric)
    m, k = x.shape
    n = y.shape[0]
    wide_capable = metric in _WIDE_MATMUL_METRICS or \
        metric in _WIDE_ELT_METRICS
    auto_wide = (m + n) * k > _TILE_BUDGET_ELEMS and k > _WIDE_COL_TILE
    if wide_capable and (col_tile is not None or auto_wide):
        tile = min(int(col_tile) if col_tile else _WIDE_COL_TILE, k)
        xu, yu = _unpack(x), _unpack(y)
        if metric in _WIDE_MATMUL_METRICS:
            return _wide_matmul(xu, yu, k, tile, metric)
        return _wide_elt(xu, yu, k, tile, metric, float(metric_arg))

    yd = _densify(y)
    tile = max(1, min(m, _TILE_BUDGET_ELEMS // max(1, k)))
    if tile >= m:
        return dense_distance(_densify(x), yd, metric, metric_arg,
                              device=x.device)
    return torch.cat([
        dense_distance(_densify(csr_slice_rows(x, s, min(s + tile, m))), yd,
                       metric, metric_arg, device=x.device)
        for s in range(0, m, tile)])

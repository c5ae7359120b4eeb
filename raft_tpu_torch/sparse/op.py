"""Sparse structural ops (counterpart of ``raft_tpu.sparse.op``): sort,
filter, duplicate reduction, row slices and per-nonzero row ops.

Duplicate sums add each (row, col)'s values in their input order, as the
JAX package's ``np.add.at`` does (``torch.segment_reduce`` over the
stably sorted entries), so both give the same bits."""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.sparse.convert import _lexsort
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.csr import CSR


def coo_sort(coo: COO) -> COO:
    """Entries sorted by (row, col)."""
    order = _lexsort(coo.rows, coo.cols)
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape)


def coo_remove_zeros(coo: COO, eps: float = 0.0) -> COO:
    """Drop entries with ``|val| <= eps``."""
    keep = coo.vals.abs() > eps
    return COO(coo.rows[keep], coo.cols[keep], coo.vals[keep], coo.shape)


def coo_reduce(coo: COO, op: str = "sum") -> COO:
    """Merge duplicate (row, col) entries with ``sum``/``max``/``min``;
    sorted output."""
    if op not in ("sum", "max", "min"):
        raise ValueError(f"unknown reduce op {op!r}")
    key = coo.rows.long() * coo.shape[1] + coo.cols.long()
    order = torch.argsort(key, stable=True)
    key, vals = key[order], coo.vals[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    if key.numel() == 0:
        out = vals
    elif op == "sum" and vals.is_floating_point():
        out = torch.segment_reduce(vals, "sum", lengths=counts, unsafe=True)
    else:
        seg = torch.repeat_interleave(
            torch.arange(uniq.numel(), device=key.device), counts)
        how = {"sum": "sum", "max": "amax", "min": "amin"}[op]
        out = torch.zeros(uniq.numel(), dtype=vals.dtype,
                          device=vals.device).scatter_reduce_(
                              0, seg, vals, how, include_self=False)
    return COO((uniq // coo.shape[1]).to(torch.int32),
               (uniq % coo.shape[1]).to(torch.int32), out, coo.shape)


def csr_slice_rows(csr: CSR, start: int, stop: int) -> CSR:
    """Rows ``[start, stop)`` (one host read of two indptr entries)."""
    lo, hi = (int(v) for v in csr.indptr[[start, stop]].tolist())
    return CSR(csr.indptr[start:stop + 1] - lo, csr.indices[lo:hi],
               csr.data[lo:hi], (stop - start, csr.shape[1]))


def csr_row_op(csr: CSR, fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]) -> CSR:
    """``fn(row_ids, data) -> new_data`` over every nonzero at once."""
    return CSR(csr.indptr, csr.indices, fn(csr.row_ids(), csr.data),
               csr.shape)

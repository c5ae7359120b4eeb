"""Sparse linear algebra (counterpart of ``raft_tpu.sparse.linalg``):
spmv/spmm, add, degree, row norms, symmetrize, transpose and the graph
Laplacian.

The JAX package writes each as a gather and a ``segment_sum``. A CSR's
nonzeros are already grouped by row, so the port reduces them with
``torch.segment_reduce`` over the row lengths: no atomics, and the same
bits on every run."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.convert import coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.op import coo_reduce


def _row_sum(csr: CSR, per_nz: torch.Tensor, reduce: str = "sum"
             ) -> torch.Tensor:
    """Per-row reduction of per-nonzero values (nnz, ...) → (n_rows, ...);
    empty rows give 0."""
    return torch.segment_reduce(per_nz, reduce,
                                lengths=csr.row_lengths().long(), axis=0,
                                unsafe=True, initial=0)


def spmv(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for CSR A and a dense vector x."""
    return _row_sum(csr, csr.data * x[csr.indices.long()])


def spmm(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for CSR A (m, k) and dense X (k, n)."""
    return _row_sum(csr, csr.data[:, None] * x[csr.indices.long()])


def csr_add(a: CSR, b: CSR) -> CSR:
    """C = A + B, duplicates merged."""
    if a.shape != b.shape:
        raise ValueError(f"csr_add: shape mismatch {a.shape} vs {b.shape}")
    ca, cb = csr_to_coo(a), csr_to_coo(b)
    merged = COO(torch.cat([ca.rows, cb.rows]), torch.cat([ca.cols, cb.cols]),
                 torch.cat([ca.vals, cb.vals]), a.shape)
    return coo_to_csr(coo_reduce(merged, "sum"))


def csr_transpose(csr: CSR) -> CSR:
    """The transpose, as CSR."""
    coo = csr_to_coo(csr)
    return coo_to_csr(COO(coo.cols, coo.rows, coo.vals,
                          (csr.shape[1], csr.shape[0])))


def degree(coo: COO) -> torch.Tensor:
    """Nonzeros per row, in the values' dtype."""
    return torch.bincount(coo.rows.long(),
                          minlength=coo.shape[0]).to(coo.vals.dtype)


def row_normalize(csr: CSR, norm: str = "l1") -> CSR:
    """Each row scaled to unit L1, L2 or Linf norm (zero rows stay 0)."""
    if norm == "l1":
        acc = _row_sum(csr, csr.data.abs())
    elif norm == "l2":
        acc = torch.sqrt(_row_sum(csr, csr.data ** 2))
    elif norm in ("linf", "max"):
        acc = _row_sum(csr, csr.data.abs(), "max")
    else:
        raise ValueError(f"unknown norm {norm!r}")
    pos = acc > 0
    scale = torch.where(pos, 1.0 / torch.where(pos, acc, torch.ones_like(acc)),
                        torch.zeros_like(acc))
    return CSR(csr.indptr, csr.indices,
               csr.data * scale[csr.row_ids().long()], csr.shape)


def symmetrize(coo: COO, op: str = "max") -> COO:
    """A ∪ Aᵀ, mirrored entries merged with ``op``."""
    n = max(coo.shape)
    both = COO(torch.cat([coo.rows, coo.cols]), torch.cat([coo.cols, coo.rows]),
               torch.cat([coo.vals, coo.vals]), (n, n))
    return coo_reduce(both, op)


def laplacian(csr: CSR, normalized: bool = False) -> CSR:
    """L = D − A, or I − D^-½ A D^-½ with ``normalized``."""
    coo = csr_to_coo(csr)
    deg = _row_sum(csr, csr.data)
    n = csr.shape[0]
    diag = torch.arange(n, dtype=coo.rows.dtype, device=coo.rows.device)
    if not normalized:
        vals = torch.cat([-coo.vals, deg])
    else:
        pos = deg > 0
        inv_sqrt = torch.where(
            pos, 1.0 / torch.sqrt(torch.where(pos, deg, torch.ones_like(deg))),
            torch.zeros_like(deg))
        off = -coo.vals * inv_sqrt[coo.rows.long()] * inv_sqrt[coo.cols.long()]
        vals = torch.cat([off, pos.to(deg.dtype)])
    merged = COO(torch.cat([coo.rows, diag]), torch.cat([coo.cols, diag]),
                 vals, (n, n))
    return coo_to_csr(coo_reduce(merged, "sum"))

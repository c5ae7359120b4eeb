"""Sparse format conversions (counterpart of ``raft_tpu.sparse.convert``):
COO <-> CSR <-> dense and a boolean adjacency to CSR. A tensor input
stays on its device; any other input goes to the default device
(``cuda``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import resources_for
from raft_tpu_torch.distance.pairwise import as_device_tensor
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.csr import CSR


def _lexsort(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The order sorting by (row, col), equal pairs in input order."""
    order = torch.argsort(cols, stable=True)
    return order[torch.argsort(rows[order], stable=True)]


def _indptr(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    counts = torch.bincount(rows.long(), minlength=n_rows)
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(torch.int32)


def coo_to_csr(coo: COO) -> CSR:
    """Sort by (row, col) and build indptr from the row counts."""
    order = _lexsort(coo.rows, coo.cols)
    rows = coo.rows[order]
    return CSR(_indptr(rows, coo.shape[0]), coo.cols[order], coo.vals[order],
               coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    return COO(csr.row_ids(), csr.indices, csr.data, csr.shape)


def coo_to_dense(coo: COO) -> torch.Tensor:
    return coo.todense()


def csr_to_dense(csr: CSR) -> torch.Tensor:
    return csr.todense()


def dense_to_coo(x) -> COO:
    """The nonzeros of ``x`` in row-major order."""
    x = as_device_tensor(x, resources_for(x).device)
    rows, cols = torch.nonzero(x, as_tuple=True)
    return COO(rows.to(torch.int32), cols.to(torch.int32), x[rows, cols],
               tuple(x.shape))


def dense_to_csr(x) -> CSR:
    return coo_to_csr(dense_to_coo(x))


def adj_to_csr(adj) -> CSR:
    """Boolean adjacency matrix → CSR with unit float32 weights."""
    adj = as_device_tensor(adj, resources_for(adj).device)
    rows, cols = torch.nonzero(adj, as_tuple=True)
    return CSR(_indptr(rows, adj.shape[0]), cols.to(torch.int32),
               torch.ones(cols.shape[0], dtype=torch.float32,
                          device=adj.device), tuple(adj.shape))

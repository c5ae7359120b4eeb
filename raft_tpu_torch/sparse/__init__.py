"""Sparse stack (counterpart of ``raft_tpu.sparse``): COO/CSR containers
of tensors on one device, format conversion, structural ops, linear
algebra, pairwise distances (densified tiles, or column tiles for wide
rows), sparse neighbours and the solvers (Borůvka MST, Lanczos)."""

from raft_tpu_torch.sparse.convert import (adj_to_csr, coo_to_csr,
                                           coo_to_dense, csr_to_coo,
                                           csr_to_dense, dense_to_coo,
                                           dense_to_csr)
from raft_tpu_torch.sparse.coo import COO
from raft_tpu_torch.sparse.csr import CSR
from raft_tpu_torch.sparse.distance import pairwise_distance
from raft_tpu_torch.sparse.linalg import (csr_add, csr_transpose, degree,
                                          laplacian, row_normalize, spmm,
                                          spmv, symmetrize)
from raft_tpu_torch.sparse.neighbors import (brute_force_knn,
                                             connect_components,
                                             cross_component_nn, knn_graph)
from raft_tpu_torch.sparse.op import (coo_reduce, coo_remove_zeros, coo_sort,
                                      csr_row_op, csr_slice_rows)

__all__ = [
    "COO", "CSR",
    "adj_to_csr", "coo_to_csr", "coo_to_dense", "csr_to_coo",
    "csr_to_dense", "dense_to_coo", "dense_to_csr",
    "coo_reduce", "coo_remove_zeros", "coo_sort", "csr_row_op",
    "csr_slice_rows",
    "csr_add", "csr_transpose", "degree", "laplacian", "row_normalize",
    "spmm", "spmv", "symmetrize",
    "pairwise_distance",
    "brute_force_knn", "connect_components", "cross_component_nn",
    "knn_graph",
]

"""Dense linear algebra (counterpart of ``raft_tpu.linalg``): the BLAS
group, the solvers (QR, eigendecomposition, SVD, least squares, the
rank-1 Cholesky update), the elementwise framework and the reduction
framework. The large products and factorisations the JAX package
leaves to XLA are ``@`` and ``torch.linalg`` here (cuBLAS and cuSOLVER
on the card), in full float32."""

from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv, transpose
from raft_tpu_torch.linalg.cholesky import cholesky_r1_update
from raft_tpu_torch.linalg.eig import eig_dc, eig_dc_selective, eig_jacobi
from raft_tpu_torch.linalg.elementwise import (add, binary_op, divide,
                                               eltwise_add, init_arange,
                                               linewise_op, map_, map_reduce,
                                               matrix_vector_op,
                                               mean_squared_error, multiply,
                                               power, sqrt, subtract,
                                               ternary_op, unary_op)
from raft_tpu_torch.linalg.lstsq import (lstsq_eig, lstsq_qr, lstsq_svd_jacobi,
                                         lstsq_svd_qr)
from raft_tpu_torch.linalg.qr import qr_get_q, qr_get_qr
from raft_tpu_torch.linalg.reduce import (Apply, NormType, coalesced_reduction,
                                          col_norm, norm, normalize_rows,
                                          reduce, reduce_cols_by_key,
                                          reduce_rows_by_key, row_norm,
                                          strided_reduction)
from raft_tpu_torch.linalg.svd import (rsvd, svd_eig, svd_jacobi, svd_qr,
                                       svd_reconstruction)

__all__ = [
    "gemm", "gemv", "axpy", "dot", "transpose",
    "eig_dc", "eig_dc_selective", "eig_jacobi",
    "svd_qr", "svd_eig", "svd_jacobi", "svd_reconstruction", "rsvd",
    "qr_get_q", "qr_get_qr",
    "lstsq_svd_qr", "lstsq_svd_jacobi", "lstsq_eig", "lstsq_qr",
    "cholesky_r1_update",
    "unary_op", "binary_op", "ternary_op", "map_", "map_reduce",
    "add", "subtract", "multiply", "divide", "power", "sqrt", "eltwise_add",
    "mean_squared_error", "matrix_vector_op", "linewise_op", "init_arange",
    "Apply", "reduce", "coalesced_reduction", "strided_reduction",
    "norm", "NormType", "row_norm", "col_norm",
    "reduce_rows_by_key", "reduce_cols_by_key", "normalize_rows",
]

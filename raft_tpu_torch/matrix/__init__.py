"""Matrix utilities (counterpart of ``raft_tpu.matrix``)."""

from raft_tpu_torch.matrix.gather import gather, gather_if
from raft_tpu_torch.matrix.ops import (argmax, argmin, col_right_shift, copy,
                                       copy_upper_triangular, get_diagonal)
from raft_tpu_torch.matrix.ops import init as matrix_init
from raft_tpu_torch.matrix.ops import (invert_diagonal, line_power,
                                       matrix_max, matrix_min, power,
                                       print_matrix, ratio, reciprocal,
                                       seq_root, set_diagonal, sigmoid,
                                       sign_flip, slice_matrix, sqrt,
                                       zero_small_values)
from raft_tpu_torch.matrix.sort import argsort_cols, col_wise_sort

__all__ = [
    "gather", "gather_if", "col_wise_sort", "argsort_cols",
    "copy", "copy_upper_triangular", "matrix_init",
    "power", "ratio", "reciprocal", "sqrt", "sign_flip",
    "zero_small_values", "line_power", "seq_root",
    "set_diagonal", "get_diagonal", "invert_diagonal",
    "slice_matrix", "col_right_shift",
    "argmax", "argmin", "matrix_max", "matrix_min", "sigmoid",
    "print_matrix",
]

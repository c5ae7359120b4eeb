"""Elementwise lambda framework (counterpart of
``raft_tpu.linalg.elementwise``): unary/binary/ternary ops, n-ary map,
map-then-reduce, the eltwise arithmetic, ``matrix_vector_op`` and
``linewise_op`` (Apply::ALONG_ROWS|ALONG_COLUMNS broadcasts), on
tensors on the device of the first input (or ``res``'s)."""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.linalg.reduce import Apply


def _arrays(res, *xs):
    dev = input_device(res, *xs)
    return [as_array(x, dev) for x in xs]


def unary_op(x, op: Callable, res=None) -> torch.Tensor:
    return op(*_arrays(res, x))


def binary_op(x, y, op: Callable, res=None) -> torch.Tensor:
    return op(*_arrays(res, x, y))


def ternary_op(x, y, z, op: Callable, res=None) -> torch.Tensor:
    return op(*_arrays(res, x, y, z))


def map_(op: Callable, *arrays, res=None) -> torch.Tensor:
    """N-ary map."""
    return op(*_arrays(res, *arrays))


def map_reduce(op: Callable, reduce_op: Callable, neutral, *arrays,
               res=None) -> torch.Tensor:
    """Elementwise ``op``, then a full reduction by the binary
    ``reduce_op`` starting from ``neutral`` (a pairwise tree: log2(n)
    calls of ``reduce_op``, each on half the values)."""
    flat = op(*_arrays(res, *arrays)).reshape(-1)
    acc = torch.as_tensor(neutral, dtype=flat.dtype, device=flat.device)
    while flat.numel() > 1:
        if flat.numel() % 2:
            flat = torch.cat([flat, acc.reshape(1)])
        flat = reduce_op(flat[0::2], flat[1::2])
    return reduce_op(acc, flat[0]) if flat.numel() else acc


# -- eltwise arithmetic (linalg/{add,subtract,multiply,divide,power,sqrt}.cuh)
def add(x, y, res=None):
    a, b = _arrays(res, x, y)
    return a + b


def subtract(x, y, res=None):
    a, b = _arrays(res, x, y)
    return a - b


def multiply(x, y, res=None):
    a, b = _arrays(res, x, y)
    return a * b


def divide(x, y, res=None):
    a, b = _arrays(res, x, y)
    return a / b


def power(x, y, res=None):
    a, b = _arrays(res, x, y)
    return a ** b


def sqrt(x, res=None):
    return torch.sqrt(*_arrays(res, x))


def eltwise_add(*xs, res=None):
    arrs = _arrays(res, *xs)
    out = arrs[0]
    for x in arrs[1:]:
        out = out + x
    return out


def init_arange(n: int, start=0, step=1, dtype=torch.float32, res=None):
    """start + step * arange(n) on ``res``'s device (default ``cuda``)."""
    return start + step * torch.arange(n, dtype=dtype,
                                       device=input_device(res))


def mean_squared_error(a, b, weight: float = 1.0, res=None) -> torch.Tensor:
    a, b = _arrays(res, a, b)
    d = (a - b).float()
    return weight * (d * d).mean()


def matrix_vector_op(mat, vec, op: Callable = torch.add,
                     apply: Apply = Apply.ALONG_ROWS,
                     bcast_along_rows: bool = None, res=None
                     ) -> torch.Tensor:
    """Combine a vector with every row (``ALONG_ROWS``: vec of length
    n_cols) or every column (``ALONG_COLUMNS``: length n_rows) of a
    matrix; ``bcast_along_rows`` is the reference's bool form."""
    mat, vec = _arrays(res, mat, vec)
    if bcast_along_rows is not None:
        apply = Apply.ALONG_ROWS if bcast_along_rows else Apply.ALONG_COLUMNS
    if apply == Apply.ALONG_ROWS:
        expects(vec.shape[0] == mat.shape[1],
                "matrix_vector_op: vec len %d != n_cols %d", vec.shape[0],
                mat.shape[1])
        return op(mat, vec[None, :])
    expects(vec.shape[0] == mat.shape[0],
            "matrix_vector_op: vec len %d != n_rows %d", vec.shape[0],
            mat.shape[0])
    return op(mat, vec[:, None])


def linewise_op(mat, op: Callable, along_lines: bool, *vecs, res=None
                ) -> torch.Tensor:
    """``op(mat, *vecs)`` with each vector along the rows (length n_cols,
    ``along_lines=True``) or the columns."""
    mat, *vs = _arrays(res, mat, *vecs)
    vs = [v[None, :] if along_lines else v[:, None] for v in vs]
    return op(mat, *vs)

"""Matrix math and manipulation helpers (counterpart of
``raft_tpu.matrix.ops``): power, ratio, reciprocal, sqrt, sign flip,
small-value threshold, sigmoid, slicing, diagonals, argmax/argmin,
triangular copy, column shift and print. Each returns a new tensor on
the device of its input (``init`` on ``res``'s, default ``cuda``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def _arr(data, res) -> torch.Tensor:
    return as_array(data, input_device(res, data))


def copy(data, res=None) -> torch.Tensor:
    return _arr(data, res).clone()


def copy_upper_triangular(data, res=None) -> torch.Tensor:
    """The upper-triangular part, the rest zeroed."""
    return torch.triu(_arr(data, res))


def init(m: int, n: int, value=0.0, dtype=torch.float32, res=None
         ) -> torch.Tensor:
    return torch.full((m, n), value, dtype=dtype, device=input_device(res))


def power(data, scalar: float = 1.0, res=None) -> torch.Tensor:
    """element = (scalar * element)^2."""
    d = _arr(data, res)
    return (scalar * d) * (scalar * d)


def ratio(data, res=None) -> torch.Tensor:
    """element / sum(all elements)."""
    d = _arr(data, res)
    return d / d.sum()


def reciprocal(data, scalar: float = 1.0, setzero: bool = False,
               thres: float = 1e-15, res=None) -> torch.Tensor:
    """scalar / element; with ``setzero`` the entries with |x| <= thres
    become 0."""
    d = _arr(data, res)
    small = d.abs() <= thres
    out = scalar / torch.where(small, torch.ones_like(d), d)
    if setzero:
        out = torch.where(small, torch.zeros_like(out), out)
    return out


def sqrt(data, res=None) -> torch.Tensor:
    return torch.sqrt(_arr(data, res))


def sign_flip(data, res=None) -> torch.Tensor:
    """Each column's sign flipped so that its largest-|.| entry (the
    first of equals) is positive."""
    d = _arr(data, res)
    idx = torch.argmax(d.abs(), dim=0)
    signs = torch.sign(d[idx, torch.arange(d.shape[1], device=d.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return d * signs[None, :]


def zero_small_values(data, thres: float = 1e-15, res=None) -> torch.Tensor:
    d = _arr(data, res)
    return torch.where(d.abs() <= thres, torch.zeros_like(d), d)


def line_power(data, vec, res=None) -> torch.Tensor:
    """data[i, j] ** vec[j]."""
    d = _arr(data, res)
    return d ** as_array(vec, d.device)[None, :]


def seq_root(data, scalar: float = 1.0, res=None) -> torch.Tensor:
    """sqrt(max(scalar * element, 0))."""
    return torch.sqrt(torch.clamp(scalar * _arr(data, res), min=0.0))


def sigmoid(data, res=None) -> torch.Tensor:
    return torch.sigmoid(_arr(data, res))


def _diag_idx(d: torch.Tensor) -> torch.Tensor:
    return torch.arange(min(d.shape), device=d.device)


def set_diagonal(data, vec, res=None) -> torch.Tensor:
    d = _arr(data, res).clone()
    i = _diag_idx(d)
    d[i, i] = as_array(vec, d.device)[:i.numel()].to(d.dtype)
    return d


def get_diagonal(data, res=None) -> torch.Tensor:
    return torch.diagonal(_arr(data, res))


def invert_diagonal(data, res=None) -> torch.Tensor:
    """The diagonal replaced by its reciprocals (0 stays 0)."""
    d = _arr(data, res).clone()
    i = _diag_idx(d)
    diag = d[i, i]
    zero = diag == 0.0
    d[i, i] = torch.where(zero, torch.zeros_like(diag),
                          1.0 / torch.where(zero, torch.ones_like(diag),
                                            diag))
    return d


def slice_matrix(data, x1: int, y1: int, x2: int, y2: int, res=None
                 ) -> torch.Tensor:
    """The submatrix [x1:x2, y1:y2]."""
    return _arr(data, res)[x1:x2, y1:y2]


def col_right_shift(data, k: int = 1, res=None) -> torch.Tensor:
    """Columns rotated right by k."""
    return torch.roll(_arr(data, res), k, dims=1)


def argmax(data, along_rows: bool = True, res=None) -> torch.Tensor:
    """Per-row (or per-column) argmax, the first of equals, int32."""
    return torch.argmax(_arr(data, res), dim=1 if along_rows else 0).to(
        torch.int32)


def argmin(data, along_rows: bool = True, res=None) -> torch.Tensor:
    return torch.argmin(_arr(data, res), dim=1 if along_rows else 0).to(
        torch.int32)


def matrix_max(data, res=None) -> torch.Tensor:
    return _arr(data, res).max()


def matrix_min(data, res=None) -> torch.Tensor:
    return _arr(data, res).min()


def print_matrix(data, name: str = "", h_separator: str = " ",
                 v_separator: str = "\n") -> str:
    """Host-side pretty print; returns the text."""
    arr = as_array(data).detach().cpu().numpy()
    if arr.ndim < 2:
        arr = arr.reshape(1, -1)
    s = v_separator.join(h_separator.join(f"{v:g}" for v in row)
                         for row in arr)
    if name:
        s = f"{name}:\n{s}"
    print(s)
    return s

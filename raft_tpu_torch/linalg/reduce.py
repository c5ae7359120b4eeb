"""Reduction framework (counterpart of ``raft_tpu.linalg.reduce``): the
reference's ``reduce`` / ``coalesced_reduction`` / ``strided_reduction``
with main_op (per element), reduce_op and final_op; the L1/L2/Linf row
and column norms; row normalization; and the by-key sums.

The coalesced/strided distinction is the reference's memory layout; on
torch both are one reduction along a dimension. The by-key sums of
floats go through the port's fixed-order ``util.segment.segment_sum``
(the same bits on every run on the card; on the CPU equal to
``index_add_``); integer sums are exact in any order and use
``index_add_``.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, input_device
from raft_tpu_torch.util.segment import segment_sum


class Apply(enum.IntEnum):
    """reference linalg_types.hpp Apply::ALONG_ROWS|ALONG_COLUMNS."""

    ALONG_ROWS = 0
    ALONG_COLUMNS = 1


class NormType(enum.IntEnum):
    """reference linalg/norm_types.hpp."""

    L1Norm = 0
    L2Norm = 1
    LinfNorm = 2


_id = lambda x: x  # noqa: E731


def _like(v, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=t.dtype, device=t.device)


def reduce(data, along_rows: bool = True,
           main_op: Callable = _id,
           reduce_op: str = "add",
           final_op: Callable = _id,
           init=None, res=None) -> torch.Tensor:
    """Row- or column-wise lambda reduction. ``along_rows=True`` reduces
    each row to a scalar (length m). ``reduce_op``: "add", "min" or
    "max"; ``init``, when given, is combined into the result (the
    reference's seed of the accumulator)."""
    data = as_array(data, input_device(res, data))
    mapped = main_op(data)
    dim = 1 if along_rows else 0
    if reduce_op == "add":
        out = mapped.sum(dim=dim)
        if init is not None:
            out = out + init
    elif reduce_op == "min":
        out = mapped.amin(dim=dim)
        if init is not None:
            out = torch.minimum(out, _like(init, out))
    elif reduce_op == "max":
        out = mapped.amax(dim=dim)
        if init is not None:
            out = torch.maximum(out, _like(init, out))
    else:
        raise ValueError(f"unsupported reduce_op {reduce_op}")
    return final_op(out)


def coalesced_reduction(data, main_op: Callable = _id, reduce_op: str = "add",
                        final_op: Callable = _id, init=None, res=None):
    """Reduce along the contiguous (last) dim — row-wise."""
    return reduce(data, True, main_op, reduce_op, final_op, init, res)


def strided_reduction(data, main_op: Callable = _id, reduce_op: str = "add",
                      final_op: Callable = _id, init=None, res=None):
    """Reduce along the strided (first) dim — column-wise."""
    return reduce(data, False, main_op, reduce_op, final_op, init, res)


def norm(data, norm_type: NormType, along_rows: bool = True,
         sqrt: bool = False, res=None) -> torch.Tensor:
    """L1/L2/Linf norms per row or column, float32 (the reference's L2
    is the *squared* norm unless ``sqrt``)."""
    data = as_array(data, input_device(res, data)).float()
    dim = 1 if along_rows else 0
    if norm_type == NormType.L1Norm:
        out = data.abs().sum(dim=dim)
    elif norm_type == NormType.L2Norm:
        out = (data * data).sum(dim=dim)
    elif norm_type == NormType.LinfNorm:
        out = data.abs().amax(dim=dim)
    else:
        raise ValueError(f"unknown norm type {norm_type}")
    return torch.sqrt(out) if sqrt else out


def row_norm(data, norm_type: NormType = NormType.L2Norm, sqrt: bool = False,
             res=None):
    return norm(data, norm_type, True, sqrt, res)


def col_norm(data, norm_type: NormType = NormType.L2Norm, sqrt: bool = False,
             res=None):
    return norm(data, norm_type, False, sqrt, res)


def normalize_rows(data, res=None) -> torch.Tensor:
    """Rows scaled to unit L2 norm (zero rows stay 0), in the input's
    dtype."""
    data = as_array(data, input_device(res, data))
    n = torch.sqrt((data.float() ** 2).sum(dim=1, keepdim=True))
    return (data / torch.where(n == 0.0, torch.ones_like(n), n)).to(
        data.dtype)


def _sum_by_key(rows: torch.Tensor, keys: torch.Tensor, n_keys: int):
    if rows.is_floating_point():
        return segment_sum(rows, keys, n_keys)[0]
    out = torch.zeros((n_keys,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, keys.long(), rows)


def _n_keys(keys: torch.Tensor, n_keys: Optional[int]) -> int:
    return int(keys.max()) + 1 if n_keys is None else int(n_keys)


def reduce_rows_by_key(data, keys, n_keys: Optional[int] = None,
                       weights=None, res=None) -> torch.Tensor:
    """Sum of the rows sharing a key → (n_keys, n_cols), optionally
    weighted per row; keys in [0, n_keys)."""
    dev = input_device(res, data, keys)
    data = as_array(data, dev)
    keys = as_array(keys, dev)
    expects(keys.shape[0] == data.shape[0],
            "reduce_rows_by_key: key/row mismatch")
    if weights is not None:
        data = data * as_array(weights, dev)[:, None]
    return _sum_by_key(data, keys, _n_keys(keys, n_keys))


def reduce_cols_by_key(data, keys, n_keys: Optional[int] = None, res=None
                       ) -> torch.Tensor:
    """Sum of the columns sharing a key → (n_rows, n_keys)."""
    dev = input_device(res, data, keys)
    data = as_array(data, dev)
    keys = as_array(keys, dev)
    expects(keys.shape[0] == data.shape[1],
            "reduce_cols_by_key: key/col mismatch")
    return _sum_by_key(data.T, keys, _n_keys(keys, n_keys)).T

"""Row gather (counterpart of ``raft_tpu.matrix.gather``): rows of a
matrix picked by an index map, optionally transformed and/or
predicated; ``gather_if`` keeps one output row per map entry, the
unselected rows zeroed (the JAX package's map-shaped contract).

Indices follow ``jnp.take``: one in ``[-n_rows, 0)`` counts from the
end, one outside ``[-n_rows, n_rows)`` gives a filled row (NaN for
floats, the type's minimum for signed ints, its maximum otherwise).
The index is clamped before the gather, so no index reaches the device
out of range and a bad map never raises a device-side assert."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = data.shape[0]
    idx = idx.long()
    ok = (idx >= -n) & (idx < n)
    rows = data[torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))]
    mask = ok.reshape(ok.shape + (1,) * (data.dim() - 1))
    return torch.where(mask, rows, torch.full_like(rows,
                                                   _fill_value(rows.dtype)))


def gather(data, index_map, map_transform: Optional[Callable] = None,
           res=None) -> torch.Tensor:
    dev = input_device(res, data, index_map)
    data = as_array(data, dev)
    idx = as_array(index_map, dev).to(torch.int32)
    if map_transform is not None:
        idx = map_transform(idx)
    return _take_rows(data, idx)


def gather_if(data, index_map, stencil, pred: Callable,
              map_transform: Optional[Callable] = None, res=None
              ) -> torch.Tensor:
    dev = input_device(res, data, index_map, stencil)
    data = as_array(data, dev)
    idx = as_array(index_map, dev).to(torch.int32)
    if map_transform is not None:
        idx = map_transform(idx)
    keep = pred(as_array(stencil, dev))
    # an unselected entry may hold any sentinel: point it at row 0
    rows = _take_rows(data, torch.where(keep, idx, torch.zeros_like(idx)))
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))

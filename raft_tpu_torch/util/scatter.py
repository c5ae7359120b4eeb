"""Scatter helpers (counterpart of ``raft_tpu.util.scatter``; the
original's ``util/scatter.cuh`` strided scatter kernel).

The JAX package's semantics are ``out.at[idx].set(values, mode="drop")``:
a negative index counts from the end (numpy's rule), an index still
outside ``[0, out_len)`` after that is dropped (never an error, and on
the card never a device-side assert), and of duplicate indices the last
writer wins. Here each output row gathers from its last writer
(a ``scatter_reduce`` of positions, then one gather), so no two writes
race for a row and the winner is the same on every device.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array


def _scatter_last(v: torch.Tensor, i: torch.Tensor, n: int, fill):
    """``out (n, ...)`` of ``fill`` with ``out[i[j]] = v[j]``: negative
    indices from the end, out-of-range ones dropped, the largest ``j``
    winning a duplicate."""
    i = torch.where(i < 0, i + n, i)
    keep = (i >= 0) & (i < n)
    pos = torch.arange(i.shape[0], device=i.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=i.device)
    last = last.scatter_reduce(0, i[keep], pos[keep], reduce="amax")
    out = torch.full((n,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                     device=v.device)
    hit = last >= 0
    out[hit] = v[last[hit]]
    return out


def scatter(values, idx, out_len: int = 0, fill=0):
    """out[idx[i]] = values[i]; ``out_len`` defaults to len(values).
    Duplicate indices: the last write wins."""
    v = as_array(values)
    i = as_array(idx, v.device).to(torch.int32).long()
    n = out_len if out_len > 0 else v.shape[0]
    return _scatter_last(v, i, n, fill)


def scatter_if(values, idx, pred, out_len: int = 0, fill=0):
    """Like :func:`scatter` but only rows with ``pred[i] != 0`` land."""
    v = as_array(values)
    i = as_array(idx, v.device).to(torch.int32).long()
    p = as_array(pred, v.device) != 0
    n = out_len if out_len > 0 else v.shape[0]
    i = torch.where(p, i, torch.full_like(i, n))  # out of range → dropped
    return _scatter_last(v, i, n, fill)

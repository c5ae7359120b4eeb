"""mdspan/mdarray-shaped views over torch tensors (counterpart of
``raft_tpu.core.mdarray``).

A tensor already owns its storage, shape, dtype and device, so this
layer is thin: *views* check rank and dtype at API boundaries and carry
a declared layout (a col-major view of shape (m, n) is stored as its
(n, m) transpose; ``resolve()`` gives the row-major tensor); *factories*
allocate zeroed tensors on the handle's device.

:func:`as_array` is what every dense primitive calls on its inputs: a
tensor stays on its device unless one is asked for; anything else
(numpy, lists, scalars, dlpack producers) becomes a tensor on the
requested device, else on the default one (``cuda``). Host values are
taken as the JAX package takes them, 64-bit types narrowed to 32 bits.
:func:`input_device` picks the device an entry point runs on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import default_resources

ROW_MAJOR = "row_major"
COL_MAJOR = "col_major"

# host dtypes the JAX package narrows (64-bit types off)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


@dataclass(frozen=True)
class mdspan_view:
    """Non-owning typed view: tensor + declared layout."""

    array: torch.Tensor
    layout: str = ROW_MAJOR

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(self.array.shape)

    def extent(self, i: int) -> int:
        return self.array.shape[i]

    def resolve(self) -> torch.Tensor:
        """Row-major logical tensor (transposes col-major storage)."""
        if self.layout == COL_MAJOR and self.array.dim() == 2:
            return self.array.T
        return self.array


def input_device(res=None, *arrays) -> torch.device:
    """The device an entry point runs on: ``res``'s, else that of the
    first tensor (or view) among ``arrays``, else the default
    (``cuda``)."""
    if res is not None:
        return res.device
    for a in arrays:
        if isinstance(a, mdspan_view):
            a = a.array
        if isinstance(a, torch.Tensor):
            return a.device
    return default_resources().device


def as_array(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a view resolved, a tensor as it is (moved to
    ``device`` if given), anything else converted on the host and put on
    ``device`` (default: ``cuda``)."""
    if isinstance(x, mdspan_view):
        x = x.resolve()
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if hasattr(x, "__dlpack__") and not hasattr(x, "__array__"):
        t = torch.from_dlpack(x)
    else:
        a = np.asarray(x)
        t = torch.from_numpy(np.array(a, dtype=_NARROW.get(a.dtype, a.dtype),
                                      order="C"))
    return t.to(device if device is not None
                else default_resources().device)


def _checked(a, ndim: int, dtype, what: str) -> torch.Tensor:
    arr = as_array(a)
    expects(arr.dim() == ndim, "%s: expected rank-%d, got rank-%d", what,
            ndim, arr.dim())
    if dtype is not None:
        expects(arr.dtype == dtype, "%s: expected dtype %s, got %s", what,
                dtype, arr.dtype)
    return arr


def device_matrix_view(a, layout: str = ROW_MAJOR,
                       dtype=None) -> mdspan_view:
    """Validated rank-2 view."""
    return mdspan_view(_checked(a, 2, dtype, "device_matrix_view"), layout)


def device_vector_view(a, dtype=None) -> mdspan_view:
    """Validated rank-1 view."""
    return mdspan_view(_checked(a, 1, dtype, "device_vector_view"),
                       ROW_MAJOR)


def make_device_matrix(res, m: int, n: int, dtype=torch.float32,
                       layout: str = ROW_MAJOR) -> torch.Tensor:
    """Owning zeroed matrix on ``res``'s device (default ``cuda``);
    col-major storage is the (n, m) transpose."""
    shape = (m, n) if layout == ROW_MAJOR else (n, m)
    return torch.zeros(shape, dtype=dtype, device=input_device(res))


def make_device_vector(res, n: int, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=input_device(res))


def flatten(view) -> torch.Tensor:
    """Rank-collapsing view."""
    return as_array(view).reshape(-1)


def reshape(view, shape: Tuple[int, ...]) -> torch.Tensor:
    """Reshape of a contiguous view."""
    return as_array(view).reshape(shape)

"""Host arrays from whatever a caller hands an entry point.

The host-side entry points (the mutation log, the host-resident index
builds, the serving front door, the quality scorer) take numpy arrays,
sequences and tensors alike. ``np.asarray`` refuses a tensor that lives
on the card and ``Tensor.numpy()`` refuses a bfloat16 one, so every such
site goes through :func:`host_array`, which copies a tensor to the host in
the site's target dtype first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_array"]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype.newbyteorder("="))).dtype


def host_array(a, dtype) -> np.ndarray:
    """``a`` (numpy, a sequence or a tensor on any device, of any dtype)
    as a numpy array of ``dtype``. A tensor is detached and copied to the
    host in ``dtype`` (a bfloat16 tensor widens exactly, as numpy widens
    a bfloat16 array); anything else goes through ``np.asarray``, so the
    array may be a view and keeps its strides."""
    dtype = np.dtype(dtype)
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", _torch_dtype(dtype)).numpy()
    return np.asarray(a, dtype)

"""Column-wise sort (counterpart of ``raft_tpu.matrix.sort``): stable
sorts returning the sorted values and their source indices (int32)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def col_wise_sort(data, return_index: bool = True, res=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Each column sorted ascending → (sorted, source rows or None)."""
    data = as_array(data, input_device(res, data))
    vals, idx = torch.sort(data, dim=0, stable=True)
    return vals, (idx.to(torch.int32) if return_index else None)


def argsort_cols(data, res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's entries sorted ascending → (sorted, source columns)."""
    data = as_array(data, input_device(res, data))
    vals, idx = torch.sort(data, dim=1, stable=True)
    return vals, idx.to(torch.int32)

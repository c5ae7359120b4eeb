"""Row gather (counterpart of ``raft_tpu.matrix.gather``): rows of a
matrix picked by an index map, optionally transformed and/or
predicated; ``gather_if`` keeps one output row per map entry, the
unselected rows zeroed (the JAX package's map-shaped contract)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def gather(data, index_map, map_transform: Optional[Callable] = None,
           res=None) -> torch.Tensor:
    dev = input_device(res, data, index_map)
    data = as_array(data, dev)
    idx = as_array(index_map, dev).to(torch.int32)
    if map_transform is not None:
        idx = map_transform(idx)
    return data[idx.long()]


def gather_if(data, index_map, stencil, pred: Callable,
              map_transform: Optional[Callable] = None, res=None
              ) -> torch.Tensor:
    dev = input_device(res, data, index_map, stencil)
    rows = gather(as_array(data, dev), as_array(index_map, dev),
                  map_transform)
    keep = pred(as_array(stencil, dev))
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))

"""Key/value pair returned by argmin-style reductions (``raft::KeyValuePair``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class KeyValuePair(NamedTuple):
    """(key, value) pair of tensors: typically an int32 index tensor and
    a float32 distance tensor of the same shape."""

    key: torch.Tensor
    value: torch.Tensor

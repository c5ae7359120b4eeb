"""Class-label utilities (counterpart of ``raft_tpu.label.classlabels``):
the sorted distinct labels, and labels remapped onto 0..n_classes-1 by
rank."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device


def get_unique_labels(labels, res=None) -> torch.Tensor:
    """Sorted distinct labels (the count is data-dependent: one sync)."""
    return torch.unique(as_array(labels, input_device(res, labels)),
                        sorted=True)


def make_monotonic(labels, classes=None, res=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels mapped to their rank among ``classes`` (default: the
    distinct labels) → (mapped int32, classes)."""
    lab = as_array(labels, input_device(res, labels))
    classes = get_unique_labels(lab) if classes is None else \
        as_array(classes, lab.device).to(lab.dtype)
    return torch.searchsorted(classes, lab).to(torch.int32), classes

"""Label merging by connected-component propagation (counterpart of
``raft_tpu.label.merge_labels``): two labelings and a mask of bridge
points; points connected through either labeling take the minimum label.

The JAX package's ``lax.while_loop`` is a host loop here, one sync a
round: each round takes, per class of A and then per class of B, the
least label among the masked points (a ``scatter_reduce`` minimum,
exact in any order) until no label changes; the rounds are the JAX
package's. A last pass gives every point its A-class's minimum.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.mdarray import as_array, input_device

_BIG = torch.iinfo(torch.int32).max


def _class_min(values: torch.Tensor, classes: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Per class, the least value (``_BIG`` for an empty class)."""
    out = torch.full((n,), _BIG, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, classes, values, "amin", include_self=True)


def merge_labels(labels_a, labels_b, mask, n_classes: int, res=None
                 ) -> torch.Tensor:
    """Merge labeling B into A: masked points bridge their A- and
    B-classes; connected groups take the least A-label. Labels are
    0-based, below ``n_classes``."""
    dev = input_device(res, labels_a, labels_b, mask)
    a = as_array(labels_a, dev).to(torch.int32)
    b = as_array(labels_b, dev).to(torch.int32)
    m = as_array(mask, dev).bool()
    ai, bi = a.long(), b.long()
    big = torch.full_like(a, _BIG)

    def round_(lab):
        min_a = _class_min(torch.where(m, lab, big), ai, n_classes)
        lab1 = torch.where(m, torch.minimum(lab, min_a[ai]), lab)
        min_b = _class_min(torch.where(m, lab1, big), bi, n_classes)
        return torch.where(m, torch.minimum(lab1, min_b[bi]), lab1)

    merged = round_(a)
    changed = not torch.equal(merged, a)
    while changed:
        prop = round_(merged)
        changed = not torch.equal(prop, merged)
        merged = prop
    min_a = _class_min(torch.where(m, merged, big), ai, n_classes)[ai]
    return torch.where(min_a < _BIG, torch.minimum(merged, min_a), merged)

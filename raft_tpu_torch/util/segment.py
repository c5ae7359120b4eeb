"""Per-segment row sums in a fixed order (counterpart of the JAX
package's ``jax.ops.segment_sum`` where the trainers use it).

``Tensor.index_add_`` on a CUDA tensor adds through atomics, so the order
of a float sum, and its last bits, change from run to run. Here rows are
sorted stably by segment and each segment is reduced by
``torch.segment_reduce``, which adds a segment's rows one after another
in that order: the same bits on every run, and on the CPU the same sums
as ``index_add_``, which adds in row order too.
"""

from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, labels: torch.Tensor, n_segments: int):
    """``(sums (n_segments, ...) , counts (n_segments,) int64)``: the sum
    of the rows of ``x`` whose label is each segment, rows added in their
    order in ``x``; empty segments sum to 0. ``labels`` in
    ``[0, n_segments)``."""
    lab = labels.reshape(-1).long()
    counts = torch.bincount(lab, minlength=n_segments)
    order = torch.argsort(lab, stable=True)
    sums = torch.segment_reduce(x[order], "sum", lengths=counts, axis=0,
                                unsafe=True)
    return sums, counts

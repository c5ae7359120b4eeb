"""k-selection, public API (counterpart of ``raft_tpu.neighbors.selection``).

The JAX package's split is kept: ``k <= 256`` on a 2-D float input with
at least ``2k`` columns goes to the exact ``select_k`` kernel (plain
version on the CPU); anything else goes to a stable sort, which puts the
lower index first among equal values as the JAX package's ``lax.top_k``
does (``torch.topk`` leaves their order unspecified).

``mode="approx"`` takes the same exact route. The JAX package answers it
with ``lax.approx_{min,max}_k`` (the TPU's partial-reduce selection at
``recall_target``); the exact top-k has recall 1.0, which meets any
target, and equals the JAX operator's result wherever that is exact (on
the CPU).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.ops import select_k as _op

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _use_kernel(v: torch.Tensor, k: int) -> bool:
    # float64 stays off the kernel: it computes in float32
    return (k <= _op.MAX_K and v.dim() == 2 and v.shape[1] >= 2 * k
            and v.dtype in _FLOATS)


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             input_indices=None, mode: str = "exact",
             recall_target: float = 0.95,
             res=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row exact k smallest (or largest) values with their int32
    indices. ``input_indices`` maps columns to global ids (``-1`` stays
    ``-1``). ``mode``: ``"exact"`` or ``"approx"``, both exact here (see
    the module note), so ``recall_target`` is met whatever it is."""
    v = values if isinstance(values, torch.Tensor) else torch.as_tensor(values)
    ensure_resources(res, v.device)
    expects(v.dim() == 2, "select_k: values must be (n_rows, n_cols)")
    expects(1 <= k <= v.shape[1], "select_k: k=%d outside [1, %d]", k,
            v.shape[1])
    if _use_kernel(v, k):
        d, i = _op.select_k(v if select_min else -v, k)
        if not select_min:
            d = -d
    else:
        d, i = torch.sort(v, dim=1, descending=not select_min, stable=True)
        d, i = d[:, :k], i[:, :k].to(torch.int32)
    if input_indices is not None:
        idx = torch.as_tensor(input_indices, device=v.device).to(torch.int64)
        idx = idx.expand(v.shape[0], idx.shape[-1])
        mapped = torch.gather(idx, 1, i.clamp(min=0).long())
        i = torch.where(i >= 0, mapped.to(torch.int32), i)
    return d, i

"""k-selection, public API (counterpart of ``raft_tpu.neighbors.selection``).

The JAX package's split is kept: ``k <= 256`` on a 2-D float input with
at least ``2k`` columns goes to the exact ``select_k`` kernel (plain
version on the CPU); anything else goes to ``torch.topk`` (the JAX
package's ``lax.top_k``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.ops import select_k as _op

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _use_kernel(v: torch.Tensor, k: int) -> bool:
    # float64 stays on topk: the kernel computes in float32
    return (k <= _op.MAX_K and v.dim() == 2 and v.shape[1] >= 2 * k
            and v.dtype in _FLOATS)


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             input_indices=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row exact k smallest (or largest) values with their int32
    indices. ``input_indices`` maps columns to global ids (``-1`` stays
    ``-1``). The JAX package's ``mode="approx"`` is not ported."""
    v = values if isinstance(values, torch.Tensor) else torch.as_tensor(values)
    expects(v.dim() == 2, "select_k: values must be (n_rows, n_cols)")
    expects(1 <= k <= v.shape[1], "select_k: k=%d outside [1, %d]", k,
            v.shape[1])
    if _use_kernel(v, k):
        d, i = _op.select_k(v if select_min else -v, k)
        if not select_min:
            d = -d
    else:
        d, i = torch.topk(v, k, dim=1, largest=not select_min, sorted=True)
        i = i.to(torch.int32)
    if input_indices is not None:
        idx = torch.as_tensor(input_indices, device=v.device).to(torch.int64)
        idx = idx.expand(v.shape[0], idx.shape[-1])
        mapped = torch.gather(idx, 1, i.clamp(min=0).long())
        i = torch.where(i >= 0, mapped.to(torch.int32), i)
    return d, i

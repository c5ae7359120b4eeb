"""Host-side distinct-row sampling for trainset and init subsets.

Counterpart of ``raft_tpu.util.host_sample``. Indices are drawn on the
host with ``np.random.default_rng(seed).choice(n, m, replace=False)``
and sorted — the same stream the JAX package uses for ``n > 65536``, so
at realistic sizes both packages pick identical rows. (Below that width
the JAX package draws from ``jax.random``, which the port cannot
reproduce without JAX; callers that need identical small-``n`` draws
pass the indices in, as the parity tests do.)
"""

from __future__ import annotations

import numpy as np
import torch


def sample_rows_np(n: int, m: int, seed: int) -> np.ndarray:
    """``m`` distinct sorted indices in ``[0, n)`` as numpy int64."""
    idx = np.random.default_rng(seed).choice(n, size=m, replace=False)
    idx.sort()
    return idx


def sample_rows(n: int, m: int, seed: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """``m`` distinct sorted row indices in ``[0, n)`` on ``device``
    (int64, ready for indexing)."""
    return torch.from_numpy(sample_rows_np(n, m, seed)).to(device)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for row indices in ``[0, len(x))`` (as drawn by
    :func:`sample_rows`)."""
    return x.index_select(0, idx.to(device=x.device, dtype=torch.long))

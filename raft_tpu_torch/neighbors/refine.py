"""Candidate refinement: exact re-ranking (counterpart of
``raft_tpu.neighbors.refine``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.precision import full_fp32_matmul
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.ops._util import stable_topk_min


def refine(dataset, queries, candidates, k: int,
           metric: DistanceType = DistanceType.L2Expanded, res=None,
           device=None):
    """Re-rank ``candidates`` (nq, n_cand) with exact expanded-L2
    distances against ``dataset`` rows → exact (dists, ids) top-k, ties
    to the lower candidate column, on ``device`` (default ``cuda``;
    ``"cpu"`` only when asked). Candidate slots of -1 are ignored."""
    full_fp32_matmul()
    dev = ensure_resources(res, device).device
    x = torch.as_tensor(dataset, dtype=torch.float32).to(dev)
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    cand = torch.as_tensor(candidates).to(device=dev, dtype=torch.int32)
    vecs = x[torch.clamp(cand, 0, x.shape[0] - 1).long()]  # (nq, n_cand, d)
    qq = (q * q).sum(dim=1)
    vv = (vecs * vecs).sum(dim=2)
    ip = torch.einsum("qd,qcd->qc", q, vecs)
    d = torch.clamp((qq[:, None] + vv) - 2.0 * ip, min=0.0)
    if metric in (DistanceType.L2SqrtExpanded,
                  DistanceType.L2SqrtUnexpanded):
        d = torch.sqrt(d)
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    vals, sel = stable_topk_min(d, k)
    return vals, torch.gather(cand, 1, sel)

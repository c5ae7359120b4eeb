"""Exact-rescore helpers shared by the quantized IVF families
(counterpart of the epilogue half of ``raft_tpu.neighbors.ivf_bq``).

A quantized scan returns ``kk = rescore_factor * k`` estimator
candidates; :func:`finish_search` either slices the estimator top-k or
re-ranks the survivors exactly against the raw f32 vectors, on the
device when :func:`resolve_raw_device` placed a copy there, else on the
host. The IVF-BQ index itself is not ported yet.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.ops._util import stable_topk_min

_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
_RAW_DEV_LOCK = threading.Lock()


def _exact_rescore_device(raw_dev: torch.Tensor, q: torch.Tensor,
                          ids: torch.Tensor, k: int, kind: str):
    """Exact re-rank of the kk estimator survivors where ``raw_dev``
    lives: gather by global id, f32 scores (squared L2, or the negated
    dot product), the k smallest with ties to the lower column."""
    cand = raw_dev[torch.clamp(ids, min=0).long()]          # (nq, kk, d)
    qf = q.float()
    if kind == "ip":
        ex = -torch.einsum("qkd,qd->qk", cand, qf)
    else:
        diff = cand - qf[:, None, :]
        ex = (diff * diff).sum(dim=2)
    ex = torch.where(ids >= 0, ex, torch.full_like(ex, float("inf")))
    vals, sel = stable_topk_min(ex, k)
    return vals, torch.gather(ids, 1, sel)


def resolve_raw_device(index, mode: str) -> Optional[torch.Tensor]:
    """Device copy of ``index.raw`` under the ``rescore_on_device``
    policy ("auto" | "always" | "never"), cached on the index; None
    means the host epilogue. "auto" keeps the re-rank on the host when
    the raw corpus exceeds ``RAFT_TPU_RESCORE_DEVICE_MB`` (default 4096)
    or the copy fails; "always" raises instead; "never" releases a
    cached copy."""
    expects(mode in ("auto", "always", "never"),
            "rescore_on_device: want auto|always|never, got %r", mode)
    if mode == "never" or index.raw is None:
        index.raw_dev = None
        return None
    if mode == "auto":
        budget_mb = int(os.environ.get("RAFT_TPU_RESCORE_DEVICE_MB", "4096"))
        if index.raw.nbytes > budget_mb << 20:
            return None
    with _RAW_DEV_LOCK:
        if (index.raw_dev is None
                or tuple(index.raw_dev.shape) != index.raw.shape):
            try:
                index.raw_dev = torch.from_numpy(np.ascontiguousarray(
                    index.raw, dtype=np.float32)).to(index.device)
            except RuntimeError:      # device memory full
                if mode == "always":
                    raise
                return None
        return index.raw_dev


def finish_search(d_est, ids, raw, q, k: int,
                  metric: DistanceType = DistanceType.L2Expanded,
                  rescore: bool = False, raw_dev=None):
    """Slice the estimator top-k, or re-rank the kk survivors exactly
    (on the device with ``raw_dev``, else against the host ``raw``).
    Scores come in smaller-is-better; the IVF-Flat output conventions
    are applied last (IP → similarities, L2Sqrt → euclidean)."""
    from raft_tpu_torch.neighbors.ivf_flat import _metric_kind, _postprocess
    kind = _metric_kind(metric)
    sqrt = metric in _SQRT_METRICS
    if not rescore:
        d_out, i_out = d_est[:, :k], ids[:, :k]
    elif raw_dev is not None:
        ex, i_out = _exact_rescore_device(raw_dev, q, ids, k, kind)
        fin = torch.isfinite(ex)
        i_out = torch.where(fin, i_out, torch.full_like(i_out, -1))
        d_out = torch.where(fin, ex, torch.full_like(ex, float("inf")))
    else:
        # host epilogue: numpy on the host copy, as the JAX package does
        ids_h = ids.detach().cpu().numpy()
        qh = q.detach().cpu().numpy()
        cand = raw[np.maximum(ids_h, 0)]                     # (nq, kk, d)
        if kind == "ip":
            ex = -np.einsum("qkd,qd->qk", cand, qh)
        else:
            diff = cand - qh[:, None, :]
            ex = np.einsum("qkd,qkd->qk", diff, diff)
        ex = np.where(ids_h >= 0, ex, np.inf)
        order = np.argsort(ex, axis=1)[:, :k]
        dh = np.take_along_axis(ex, order, axis=1)
        ih = np.take_along_axis(ids_h, order, axis=1)
        ih = np.where(np.isfinite(dh), ih, -1)
        d_out = torch.from_numpy(np.ascontiguousarray(dh, np.float32)).to(
            q.device)
        i_out = torch.from_numpy(np.ascontiguousarray(ih, np.int32)).to(
            q.device)
    if sqrt:
        d_out = torch.sqrt(torch.clamp(d_out, min=0.0))
    return _postprocess(d_out, metric), i_out

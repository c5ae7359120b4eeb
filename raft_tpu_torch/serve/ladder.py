"""The plan-shape ladder: prepared fixed-shape SearchPlans (counterpart of
``raft_tpu.serve.ladder``).

Two-dimensional: ``shapes`` (batch nq, ascending) x ``rungs``
(``n_probes`` per degradation level, descending — rung 0 is full
quality). The load controller picks the rung; the batcher picks the
smallest shape that fits the coalesced rows. The ladder holds direct
references to its plans, so the LRU bound on ``index.plan_cache`` can
evict cache entries without breaking a running server.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from raft_tpu_torch.core.error import expects

__all__ = ["PlanLadder"]


class PlanLadder:
    """(shape, rung) → a plan-like object with ``.search(q, block=)``,
    ``.nq`` and ``.n_probes``. Build real ladders with :meth:`build`;
    tests may construct one from fake plans."""

    def __init__(self, shapes: Tuple[int, ...], rungs: Tuple[int, ...],
                 plans: Dict[Tuple[int, int], object], dim: int, k: int):
        expects(len(shapes) > 0 and len(rungs) > 0,
                "PlanLadder: need at least one shape and one rung")
        expects(list(shapes) == sorted(set(shapes)),
                "PlanLadder: shapes must be ascending and distinct")
        for s in shapes:
            for r in range(len(rungs)):
                expects((s, r) in plans,
                        "PlanLadder: missing plan for shape=%d rung=%d",
                        s, r)
        self.shapes = tuple(int(s) for s in shapes)
        self.rungs = tuple(int(r) for r in rungs)
        self.dim = int(dim)
        self.k = int(k)
        self._plans = dict(plans)

    @property
    def max_shape(self) -> int:
        return self.shapes[-1]

    def plan_for(self, rows: int, rung: int):
        """The smallest-shape plan that fits ``rows`` at ``rung`` →
        ``(shape, plan)``."""
        expects(0 < rows <= self.max_shape,
                "PlanLadder: %d rows exceed the largest shape %d",
                rows, self.max_shape)
        rung = min(max(rung, 0), len(self.rungs) - 1)
        for s in self.shapes:
            if rows <= s:
                return s, self._plans[(s, rung)]
        raise AssertionError("unreachable")

    @classmethod
    def build(cls, index, rep_queries, k: int, params=None,
              shapes: Tuple[int, ...] = (1, 8, 32, 128),
              probes_ladder: Tuple[int, ...] = (),
              prewarm: bool = True) -> "PlanLadder":
        """Prepare the full (shape x rung) grid from one representative
        query batch (tiled to each shape: the cap-measurement sample).
        ``params`` defaults to the index family's ``SearchParams``. A
        :class:`~raft_tpu_torch.neighbors.tiered.TieredIndex` builds its
        own grid of tiered plans (``tiered.build_ladder``)."""
        from raft_tpu_torch.neighbors import plan as plan_mod
        from raft_tpu_torch.neighbors import tiered as tiered_mod
        if isinstance(index, tiered_mod.TieredIndex):
            return tiered_mod.build_ladder(
                index, rep_queries, k, params, shapes=shapes,
                probes_ladder=probes_ladder, prewarm=prewarm)
        if params is None:
            params = plan_mod._default_params(
                plan_mod._resolve_builder(index)[0])
        q = np.asarray(rep_queries, np.float32)
        expects(q.ndim == 2 and q.shape[1] == index.dim,
                "PlanLadder: rep_queries must be (nq, dim=%d), got %s",
                index.dim, q.shape)
        rungs = tuple(probes_ladder) or (min(params.n_probes,
                                             index.n_lists),)
        plans: Dict[Tuple[int, int], object] = {}
        for ri, n_probes in enumerate(rungs):
            p_r = dataclasses.replace(params, n_probes=n_probes)
            for s in shapes:
                reps = -(-s // q.shape[0])
                q_s = np.tile(q, (reps, 1))[:s]
                plans[(s, ri)] = plan_mod.build_plan(index, q_s, k, p_r,
                                                     warm=prewarm)
        return cls(shapes=tuple(shapes), rungs=rungs, plans=plans,
                   dim=index.dim, k=k)

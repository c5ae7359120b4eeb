"""Mutable-index types: the config and the typed error (counterpart of
``raft_tpu.mutate.types``).

Stdlib only, so the error can travel through the serving stack without
pulling torch into an importer's graph (the ``serve/types.py``
convention).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

__all__ = ["DeltaFullError", "MutateConfig"]


class DeltaFullError(RuntimeError):
    """The delta segment is at its top rung and cannot take more rows
    until a compaction folds it into the main lists: admission control
    for writes (the write-side analogue of
    :class:`raft_tpu_torch.serve.RejectedError`). Nothing was applied."""


@dataclass(frozen=True)
class MutateConfig:
    """Operating contract of a :class:`~raft_tpu_torch.mutate.MutableIndex`.

    * ``delta_capacities`` — the delta segment's rung ladder (ascending
      row capacities). A search scores the delta at the smallest rung
      that holds its used slots, so the delta's operand shapes come from
      this short list and every (shape, rung) program is prepared ahead
      of traffic. Appends past the top rung fail at once with
      :class:`DeltaFullError`.
    * ``compact_trigger_frac`` — the background compactor folds when
      used delta slots reach this fraction of the TOP rung (the rest of
      the ladder is the headroom writes land in while the fold runs).
    * ``compact_mode`` — ``"fold"`` keeps the coarse centres frozen and
      folds the delta into the main lists through the family's
      ``extend``; ``"rebuild"`` re-trains IVF-Flat on the live corpus.
    * ``compact_poll_ms`` — the compactor thread's trigger-check interval
      while idle.
    * ``tombstone_slack`` — extra candidates the MAIN phase fetches (it
      runs at ``k + tombstone_slack`` and the merge cuts back to ``k``):
      the tombstone filter runs after the main top-k, so each dead id
      among a query's main candidates costs one slot, and the slack
      absorbs up to this many a query until compaction purges them
      (``raft.mutate.tombstone.frac`` is the gauge to watch).
    * ``rebuild_stream_chunk`` — host-streaming chunk rows of a rebuild
      (0 = plain build; > 0 streams the rows back through
      ``host_memory.build_streaming`` in chunks of this many rows).
    * ``prewarm_rungs`` — warm only this many delta rungs from the
      bottom (0 = all).
    """

    delta_capacities: Tuple[int, ...] = (1024, 4096, 16384)
    tombstone_slack: int = 16
    compact_trigger_frac: float = 0.5
    compact_mode: str = "fold"
    compact_poll_ms: float = 50.0
    rebuild_stream_chunk: int = 0
    prewarm_rungs: int = 0

    def __post_init__(self):
        caps = tuple(int(c) for c in self.delta_capacities)
        if not caps or list(caps) != sorted(set(caps)) or min(caps) < 8:
            raise ValueError(
                "MutateConfig.delta_capacities must be distinct "
                "ascending ints >= 8")
        object.__setattr__(self, "delta_capacities", caps)
        if not 0.0 < self.compact_trigger_frac <= 1.0:
            raise ValueError(
                "MutateConfig.compact_trigger_frac must be in (0, 1]")
        if self.compact_mode not in ("fold", "rebuild"):
            raise ValueError(
                "MutateConfig.compact_mode must be 'fold' or 'rebuild'")
        if self.tombstone_slack < 0:
            raise ValueError(
                "MutateConfig.tombstone_slack must be >= 0")

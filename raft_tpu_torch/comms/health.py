"""The participant-health plane's gauge parser (counterpart of
``raft_tpu.comms.health``).

A health monitor flags each rank whose heartbeat went stale with the
gauge ``raft.comms.health.suspect_rank{rank=<r>,session=<s>}`` = 1. The
debug endpoint's ``/healthz`` names those ranks in its ``serve.dist``
section through :func:`suspects_from_gauges`, the one parser of that
plane. The monitor itself, its heartbeat boards and the failure-aware
sync that reads it are ROADMAP.md queue 1 item 6; until then the fault
harness (``testing.faults.stall_shard``) is what sets the gauge.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["suspects_from_gauges"]


def suspects_from_gauges(gauges: Dict[str, float]) -> List[int]:
    """The ranks flagged in a snapshot's ``gauges`` dict (series name ->
    value) → sorted ranks currently suspect (as strings, sorted, if a
    rank label is not an integer)."""
    raw = {lbl.split("rank=")[1].rstrip("}").split(",")[0]
           for lbl, v in gauges.items()
           if lbl.startswith("raft.comms.health.suspect_rank{")
           and "rank=" in lbl and v > 0}
    try:
        return sorted(int(r) for r in raw)
    except ValueError:
        return sorted(raw)

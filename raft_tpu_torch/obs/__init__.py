"""Observability: counters and gauges (``obs.registry``) and the
shadow-exact quality monitor (``obs.quality``, imported on use)."""

from raft_tpu_torch.obs.registry import (CardinalityError, counter,
                                         counter_sum, gauge, snapshot)

__all__ = ["CardinalityError", "counter", "counter_sum", "gauge",
           "snapshot"]

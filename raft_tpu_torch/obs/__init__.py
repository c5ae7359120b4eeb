"""Observability: counters and gauges (``obs.registry``)."""

from raft_tpu_torch.obs.registry import counter, counter_sum, gauge, snapshot

__all__ = ["counter", "counter_sum", "gauge", "snapshot"]

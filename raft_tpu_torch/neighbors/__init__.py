"""Neighbours: k-selection, IVF-Flat, plans, serialization, and the
host-memory and tiered IVF-Flat indexes."""

from raft_tpu_torch.neighbors import host_memory, tiered

__all__ = ["host_memory", "tiered"]

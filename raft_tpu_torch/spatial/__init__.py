"""Legacy ``spatial`` namespace (counterpart of ``raft_tpu.spatial``):
forwards into :mod:`raft_tpu_torch.neighbors`."""

from raft_tpu_torch.spatial import knn

__all__ = ["knn"]

"""Label utilities (counterpart of ``raft_tpu.label``)."""

from raft_tpu_torch.label.classlabels import get_unique_labels, make_monotonic
from raft_tpu_torch.label.merge_labels import merge_labels

__all__ = ["get_unique_labels", "make_monotonic", "merge_labels"]

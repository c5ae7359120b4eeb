"""Core: errors, the device/stream handle, matmul precision, key/value pairs."""

from raft_tpu_torch.core.error import LogicError, RaftError, expects
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core.resources import Resources, ensure_resources

__all__ = ["KeyValuePair", "LogicError", "RaftError", "Resources",
           "ensure_resources", "expects"]

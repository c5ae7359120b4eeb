"""Core: errors, the device/stream handle, matmul precision, key/value pairs."""

from raft_tpu_torch.core.error import LogicError, RaftError, expects, fail
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           ensure_resources)

__all__ = ["KeyValuePair", "LogicError", "RaftError", "Resources",
           "default_resources", "ensure_resources", "expects", "fail"]

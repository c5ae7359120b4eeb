"""Core: errors, the device/stream handle, array views and factories,
matmul precision, key/value pairs."""

from raft_tpu_torch.core.error import LogicError, RaftError, expects, fail
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core.mdarray import (device_matrix_view,
                                         device_vector_view, flatten,
                                         make_device_matrix,
                                         make_device_vector, reshape)
from raft_tpu_torch.core.resources import (Resources, default_resources,
                                           ensure_resources)

__all__ = ["KeyValuePair", "LogicError", "RaftError", "Resources",
           "default_resources", "device_matrix_view", "device_vector_view",
           "ensure_resources", "expects", "fail", "flatten",
           "make_device_matrix", "make_device_vector", "reshape"]

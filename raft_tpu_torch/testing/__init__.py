"""raft_tpu_torch.testing — fault injection (counterpart of
``raft_tpu.testing``).

Stdlib only: :mod:`raft_tpu_torch.testing.faults` is imported by the
serving hot path for its injection points, so nothing here may pull in
torch or a device runtime.
"""

from raft_tpu_torch.testing.faults import (FaultError, FaultRule, inject,
                                           inject_fault, reset)

__all__ = ["FaultError", "FaultRule", "inject", "inject_fault", "reset"]

"""Solvers (counterpart of ``raft_tpu.solver``)."""

from raft_tpu_torch.solver.linear_assignment import (LinearAssignmentProblem,
                                                     linear_assignment)

__all__ = ["LinearAssignmentProblem", "linear_assignment"]

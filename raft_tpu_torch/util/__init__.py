"""Utilities (counterpart of ``raft_tpu.util``): power-of-two helpers,
the set-associative vector cache, scatter / scatter_if, the sieve and
host-side row sampling."""

from raft_tpu_torch.util.cache import VecCache
from raft_tpu_torch.util.host_sample import sample_rows
from raft_tpu_torch.util.pow2_utils import (Pow2, is_pow2, round_down_pow2,
                                            round_up_pow2)
from raft_tpu_torch.util.scatter import scatter, scatter_if
from raft_tpu_torch.util.seive import Seive

__all__ = [
    "Pow2", "round_up_pow2", "round_down_pow2", "is_pow2",
    "VecCache", "sample_rows", "scatter", "scatter_if", "Seive",
]

"""Sparse solvers: Borůvka MST and Lanczos."""

from raft_tpu_torch.sparse.solver.lanczos import (lanczos_largest,
                                                  lanczos_smallest)
from raft_tpu_torch.sparse.solver.mst import boruvka_mst_edges, mst

__all__ = ["mst", "boruvka_mst_edges", "lanczos_largest", "lanczos_smallest"]

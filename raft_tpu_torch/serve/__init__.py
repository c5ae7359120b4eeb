"""raft_tpu_torch.serve — the dynamic micro-batching serving runtime.

Quick use::

    from raft_tpu_torch import serve
    from raft_tpu_torch.neighbors import ivf_flat

    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=1024))
    srv = serve.SearchServer.from_index(
        index, sample_queries, k=32,
        params=ivf_flat.SearchParams(n_probes=96),
        config=serve.ServeConfig(batch_sizes=(1, 8, 32, 128)))
    dists, ids = srv.search(queries)
    srv.close()
"""

from raft_tpu_torch.serve.batcher import SearchServer
from raft_tpu_torch.serve.controller import LoadController
from raft_tpu_torch.serve.ladder import PlanLadder
from raft_tpu_torch.serve.types import (DeadlineExceeded, DispatchError,
                                        RejectedError, ServeConfig)

__all__ = ["DeadlineExceeded", "DispatchError", "LoadController",
           "PlanLadder", "RejectedError", "SearchServer", "ServeConfig"]

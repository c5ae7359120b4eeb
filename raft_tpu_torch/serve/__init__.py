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

Failure handling: ``ServeConfig(dispatch_timeout_ms=..., max_retries=...)``
bounds a hung dispatch and retries a failed one (``ShardFailedError``);
``raft_tpu_torch.testing.faults`` injects delays and errors at the
``serve.execute`` and ``serve.dist.dispatch`` sites to exercise it.

Mesh-wide serving: ``DistributedSearchServer.from_sharded_index`` over a
list-sharded index (``parallel.shard_ivf_flat`` /
``parallel.sharded_ivf_flat_build``), with the int8 cross-shard merge
(``serve.merge``) and, with ``ServeConfig(failover=True)``, partial
results over the healthy shards.
"""

from raft_tpu_torch.serve.batcher import (OCCUPANCY_BUCKETS,
                                          SERVE_LATENCY_BUCKETS,
                                          SearchServer)
from raft_tpu_torch.serve.controller import LoadController
from raft_tpu_torch.serve.dist import (DistributedSearchServer,
                                       DistSearchPlan, FailoverLadder,
                                       build_dist_ladder,
                                       build_failover_ladder)
from raft_tpu_torch.serve.ladder import PlanLadder
from raft_tpu_torch.serve.types import (DeadlineExceeded, DispatchError,
                                        RejectedError, SearchResult,
                                        ServeConfig, ShardFailedError)

__all__ = ["DeadlineExceeded", "DispatchError", "DistSearchPlan",
           "DistributedSearchServer", "FailoverLadder",
           "build_dist_ladder", "build_failover_ladder", "LoadController",
           "OCCUPANCY_BUCKETS", "PlanLadder", "RejectedError",
           "SERVE_LATENCY_BUCKETS", "SearchResult", "SearchServer",
           "ServeConfig", "ShardFailedError"]

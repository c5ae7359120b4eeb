"""raft_tpu_torch.mutate — live mutable indexes over the serving stack
(counterpart of ``raft_tpu.mutate``).

``MutableIndex`` wraps a built ivf_flat, ivf_pq or ivf_bq index with

* an append-only **delta segment** on a ladder of fixed capacities,
  scored exactly by every query and merged with the main top-k on kernel
  2 (``ops.select_k``),
* **tombstone bitmaps** for deletes, filtered after the main top-k
  (upsert = tombstone + append),
* a **background compactor** that folds the delta into the main lists
  (the family's ``extend`` with frozen centres, or an IVF-Flat rebuild)
  and swaps epochs under live traffic, the next epoch's program grid
  warmed on the compactor thread before the swap.

Quick use::

    from raft_tpu_torch import mutate, serve
    from raft_tpu_torch.neighbors import ivf_flat

    index = ivf_flat.build(db, ivf_flat.IndexParams(n_lists=1024))
    m = mutate.MutableIndex(index, k=10)
    srv = serve.SearchServer.from_index(m, sample_queries, k=10)
    comp = mutate.Compactor(m)           # background folds
    m.upsert(new_rows); m.delete([12, 99])
    dists, ids = srv.search(queries)     # live view, through the batcher
    comp.close(); srv.close()

Durability: ``m.attach_wal(MutationWAL(path), checkpoint_path=...)``
logs every mutation (fsync'd before it is applied) and
``MutableIndex.recover(path, k, base_index=...)`` replays them after a
crash; the log's byte format is the JAX package's.

Observability: the ``raft.mutate.*`` counters and gauges (the WAL's under
``raft.mutate.wal.*``) and the ``raft.mutate.compact`` span, as in the JAX
package. The mesh-wide half (``register_dist``,
``build_dist_serve_ladder``) is ROADMAP.md queue 1 item 6.
"""

from raft_tpu_torch.mutate.compactor import Compactor
from raft_tpu_torch.mutate.mutable import (MutableIndex,
                                           build_dist_serve_ladder,
                                           build_serve_ladder)
from raft_tpu_torch.mutate.types import DeltaFullError, MutateConfig
from raft_tpu_torch.mutate.wal import MutationWAL

__all__ = [
    "Compactor",
    "DeltaFullError",
    "MutableIndex",
    "MutateConfig",
    "MutationWAL",
    "build_dist_serve_ladder",
    "build_serve_ladder",
]

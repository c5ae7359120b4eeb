"""Algorithms over a mesh (counterpart of ``raft_tpu.parallel``):
distributed exact k-NN, MNMG k-means, and the list-sharded IVF builds
and searches, and the row-sharded multi-part IVF indexes."""

from raft_tpu_torch.parallel.mesh import (Mesh, P, PartitionSpec, Sharded,
                                          make_mesh, replicate, shard_map,
                                          shard_map_compat, shard_rows)
from raft_tpu_torch.parallel.knn import distributed_knn
from raft_tpu_torch.parallel.kmeans import (distributed_kmeans_fit,
                                            distributed_kmeans_step)
from raft_tpu_torch.parallel.ivf import (
    DistributedIvfBq,
    DistributedIvfFlat,
    DistributedIvfPq,
    distributed_ivf_bq_build,
    distributed_ivf_bq_search_parts,
    distributed_ivf_flat_build,
    distributed_ivf_flat_search,
    distributed_ivf_flat_search_parts,
    distributed_ivf_pq_build,
    distributed_ivf_pq_search,
    distributed_ivf_pq_search_parts,
    gather_index,
    get_comms,
    shard_ivf_flat,
    shard_ivf_pq,
    sharded_ivf_bq_build,
    sharded_ivf_flat_build,
    sharded_ivf_pq_build,
)

__all__ = [
    "Mesh", "P", "PartitionSpec", "Sharded", "make_mesh", "shard_rows",
    "replicate", "shard_map", "shard_map_compat", "get_comms",
    "distributed_knn", "distributed_kmeans_fit", "distributed_kmeans_step",
    "shard_ivf_flat", "shard_ivf_pq", "gather_index",
    "distributed_ivf_flat_search", "distributed_ivf_pq_search",
    "distributed_ivf_flat_build", "distributed_ivf_flat_search_parts",
    "distributed_ivf_pq_build", "distributed_ivf_pq_search_parts",
    "distributed_ivf_bq_build", "distributed_ivf_bq_search_parts",
    "sharded_ivf_flat_build", "sharded_ivf_pq_build",
    "sharded_ivf_bq_build", "DistributedIvfFlat", "DistributedIvfPq",
    "DistributedIvfBq",
]

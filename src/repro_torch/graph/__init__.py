"""Graph substrate (numpy): CSR containers, the synthetic datasets, the
partitioner with its padded ``[Q, ...]`` layout, and the out-of-core
pipeline (chunked stores, the streaming partitioner, per-worker shards)."""

from .data import GraphData, from_edge_list, normalized_edge_weights
from .partition import (PartitionedGraph, build_partitioned,
                        greedy_partition, metis_like_partition,
                        partition_graph, random_partition, refine_partition)
from .stream import (EdgeSpill, GraphStore, ShardSet, is_shard_dir, is_store,
                     load_graph_store, load_shards, open_store, shard_meta,
                     spill_to_store, stream_edge_cut, stream_partition,
                     write_graph_store, write_shards)
from .synthetic import (citation_graph, copurchase_graph, stream_powerlaw_graph,
                        stream_sbm_graph, tiny_graph)

__all__ = [
    "GraphData", "from_edge_list", "normalized_edge_weights",
    "PartitionedGraph", "build_partitioned", "greedy_partition",
    "metis_like_partition", "partition_graph", "random_partition",
    "refine_partition", "EdgeSpill", "GraphStore", "ShardSet",
    "is_shard_dir", "is_store", "load_graph_store", "load_shards",
    "open_store", "shard_meta", "spill_to_store", "stream_edge_cut",
    "stream_partition", "write_graph_store", "write_shards",
    "citation_graph", "copurchase_graph", "stream_powerlaw_graph",
    "stream_sbm_graph", "tiny_graph",
]

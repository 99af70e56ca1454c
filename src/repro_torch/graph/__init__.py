"""Graph substrate (numpy): CSR containers, the in-memory synthetic
datasets and the partitioner with its padded ``[Q, ...]`` layout."""

from .data import GraphData, from_edge_list, normalized_edge_weights
from .partition import (PartitionedGraph, build_partitioned,
                        greedy_partition, metis_like_partition,
                        partition_graph, random_partition, refine_partition)
from .synthetic import citation_graph, tiny_graph

__all__ = [
    "GraphData", "from_edge_list", "normalized_edge_weights",
    "PartitionedGraph", "build_partitioned", "greedy_partition",
    "metis_like_partition", "partition_graph", "random_partition",
    "refine_partition", "citation_graph", "tiny_graph",
]

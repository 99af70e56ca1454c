"""Distributed runtime: the p2p halo wire's host-side indices (``halo``),
the partition-parallel forward over it (``gnn_parallel``) and closed-loop
rate control (``ratectl``)."""

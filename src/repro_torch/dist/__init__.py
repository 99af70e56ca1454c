"""Distributed runtime: the p2p halo wire's host-side indices (``halo``),
the partition-parallel forward over it (``gnn_parallel``), closed-loop
rate control (``ratectl``), fault injection with degraded halo service
and elastic shrink (``faults``), VARCO gradient compression for
data-parallel LM training (``grad_compress``), and the transformer
sharding rules on DTensor (``sharding``)."""

from .faults import (CACHED, DEAD, FRESH, DegradeState, FaultSchedule,
                     degrade_plan, init_degrade, make_fault_train_step,
                     migrate_controller_state, migrate_degrade_state,
                     serve_masks, shrink_shards)
from .grad_compress import DPMesh, make_dp_mesh, make_varco_dp_train_step

__all__ = ["CACHED", "DEAD", "FRESH", "DegradeState", "FaultSchedule",
           "degrade_plan", "init_degrade", "make_fault_train_step",
           "migrate_controller_state", "migrate_degrade_state",
           "serve_masks", "shrink_shards",
           "DPMesh", "make_dp_mesh", "make_varco_dp_train_step"]

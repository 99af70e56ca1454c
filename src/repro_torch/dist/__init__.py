"""Distributed runtime: the p2p halo wire's host-side indices (``halo``),
the partition-parallel forward over it (``gnn_parallel``), closed-loop
rate control (``ratectl``) and fault injection with degraded halo service
and elastic shrink (``faults``)."""

from .faults import (CACHED, DEAD, FRESH, DegradeState, FaultSchedule,
                     degrade_plan, init_degrade, make_fault_train_step,
                     migrate_controller_state, migrate_degrade_state,
                     serve_masks, shrink_shards)

__all__ = ["CACHED", "DEAD", "FRESH", "DegradeState", "FaultSchedule",
           "degrade_plan", "init_degrade", "make_fault_train_step",
           "migrate_controller_state", "migrate_degrade_state",
           "serve_masks", "shrink_shards"]

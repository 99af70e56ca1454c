"""Full-batch distributed GNN trainer (the paper's experimental loop).

Counterpart of ``repro/train/trainer.py``: runs Algorithm 1 for
``epochs`` steps (full batch, one gradient step per epoch) with every
partition stacked on one device, or one process per worker, tracking the
communication ledger so accuracy can be plotted against epochs or
communicated floats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist.gnn_parallel import (DistMeta, follow_shrink,
                                           leave_group, make_eval_step,
                                           make_train_step,
                                           make_worker_mesh, shard_graph,
                                           shrink_mesh, spawn_workers)
from repro_torch.graph.partition import PartitionedGraph, partition_graph
from repro_torch.nn.gnn import GNNConfig, init_gnn, params_to
from repro_torch.spans import span
from repro_torch.train.optim import Optimizer, adamw


@dataclasses.dataclass
class History:
    """Per-epoch training record (the JAX package's columns).

    ``pair_transport_gf`` is the cumulative per-pair transport split
    (flattened receiver-major ``[Q*Q]`` Gfloats per logged epoch, auto
    policies), ``layer_transport_gf`` its per-layer refinement (per-layer
    auto policies) and ``comp_err`` the cumulative measured compression
    error.  ``width`` (the step's mean planned off-diagonal wire width,
    32 when exact), ``step_s`` (host seconds of the step, ending in the
    metrics' device sync; a crash's shrink and rebuild count in its
    epoch) and, under faults, ``cached_pairs``/``dead_pairs`` (the
    ladder's CACHED and DEAD pair counts of the step) and, on the worker
    backend, ``sent_bytes``/``staged_bytes``/``comm_s`` (``WorkerMesh``'s
    counters for the step: the bytes this worker handed the transport —
    the uint8 payloads and f32 scales of a sub-byte wire, the f32 rows
    and cotangents otherwise — computed from the payload sizes with an
    all-reduce counted as a ring's share, not read off the wire; the
    bytes copied between card and host for them; the host seconds spent
    in the transport) are the port's additions; ``row()`` keeps the JAX
    package's CSV columns.  Every column fills alike on both backends.
    """
    epoch: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    rate: list = dataclasses.field(default_factory=list)
    train_acc: list = dataclasses.field(default_factory=list)
    val_acc: list = dataclasses.field(default_factory=list)
    test_acc: list = dataclasses.field(default_factory=list)
    halo_gfloats: list = dataclasses.field(default_factory=list)  # cumulative
    transport_gfloats: list = dataclasses.field(default_factory=list)
    wall_s: list = dataclasses.field(default_factory=list)
    pair_transport_gf: list = dataclasses.field(default_factory=list)
    layer_transport_gf: list = dataclasses.field(default_factory=list)
    comp_err: list = dataclasses.field(default_factory=list)  # cumulative
    width: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)
    cached_pairs: list = dataclasses.field(default_factory=list)
    dead_pairs: list = dataclasses.field(default_factory=list)
    sent_bytes: list = dataclasses.field(default_factory=list)
    staged_bytes: list = dataclasses.field(default_factory=list)
    comm_s: list = dataclasses.field(default_factory=list)

    def row(self, i: int) -> dict:
        out = {k: getattr(self, k)[i] for k in
               ("epoch", "loss", "rate", "train_acc", "val_acc", "test_acc",
                "halo_gfloats", "transport_gfloats", "wall_s")}
        if self.pair_transport_gf:
            out["pair_transport_gf"] = "|".join(
                f"{v:.6g}" for v in self.pair_transport_gf[i])
        if self.layer_transport_gf:
            out["layer_transport_gf"] = "|".join(
                f"{v:.6g}" for v in self.layer_transport_gf[i])
        if self.comp_err:
            out["comp_err"] = self.comp_err[i]
        return out

    def rows(self):
        return [self.row(i) for i in range(len(self.epoch))]

    def layer_split(self, q: int) -> list:
        """Cumulative per-layer transport (Gfloats, ``[L]``) of the last
        logged epoch; empty for runs without per-layer plans."""
        if not self.layer_transport_gf:
            return []
        lt = self.layer_transport_gf[-1]
        n_pairs = q * q
        return [float(sum(lt[i * n_pairs:(i + 1) * n_pairs]))
                for i in range(len(lt) // n_pairs)]

    @property
    def final_test_acc(self) -> float:
        return self.test_acc[-1] if self.test_acc else float("nan")

    @property
    def best_test_acc(self) -> float:
        return max(self.test_acc) if self.test_acc else float("nan")

    @property
    def total_halo_gfloats(self) -> float:
        return self.halo_gfloats[-1] if self.halo_gfloats else 0.0

    @property
    def total_transport_gfloats(self) -> float:
        """Gfloats the wire format actually shipped."""
        return self.transport_gfloats[-1] if self.transport_gfloats else 0.0


@dataclasses.dataclass
class TrainResult:
    history: History
    params: Any
    meta: DistMeta
    policy_desc: str


def _plan_width(plan, q: int) -> float:
    if plan.widths is None:
        return 32.0
    off = ~np.eye(q, dtype=bool)
    return float(np.asarray(plan.widths, np.float32).reshape(-1, q, q)
                 [:, off].mean())


def _train_worker(mesh, g, kwargs: dict) -> "TrainResult":
    """One spawned worker of ``train_gnn(use_shard_map=True)``."""
    return train_gnn(g, use_shard_map=True, **kwargs)


def _wire_counters(mesh) -> tuple:
    return mesh.sent_bytes, mesh.staged_bytes, mesh.comm_s


def _world_size(g, q: int, peeked: dict | None = None) -> int:
    """The worker count a run over ``g`` needs: its partitioning's, else
    ``q``; resuming (``peeked``, the checkpoint's metadata) a run that
    recorded its live workers, their count."""
    from repro_torch.graph.stream import is_shard_dir, shard_meta

    alive = None if peeked is None else peeked.get("alive")
    if alive is not None:
        return len(alive)
    if is_shard_dir(g):
        return int(shard_meta(g)["q"])
    return int(getattr(g, "q", q))


def _peek_checkpoint(checkpoint_dir) -> dict:
    """The metadata of the checkpoint a resumed run starts from."""
    from repro_torch.train import checkpoint as ckpt

    if not checkpoint_dir:
        raise ValueError("resume=True needs checkpoint_dir")
    path = ckpt.latest_checkpoint(checkpoint_dir)
    if path is None:
        raise FileNotFoundError(
            f"resume=True but no checkpoint under {checkpoint_dir!r}")
    return ckpt.peek(path)


def _follow_crashes(sched, ranks: tuple, epoch: int, end: int) -> None:
    """A crashed worker's part in the rest of its run: the survivors'
    subgroup of every later crash before epoch ``end``
    (:func:`~repro_torch.dist.gnn_parallel.follow_shrink`); ``sched`` and
    ``ranks`` are the schedule and job-wide ranks after its own crash at
    ``epoch``."""
    for ep in range(epoch + 1, end):
        crash = sched.crash_at_step(ep)
        if crash is not None:
            ranks, _ = follow_shrink(ranks, crash)
            sched = sched.shrink(crash)


def train_gnn(g, *, q: int = 8, scheme: str = "random",
              policy: CommPolicy, epochs: int = 300, lr: float = 5e-3,
              weight_decay: float = 0.0, hidden: int = 256, layers: int = 3,
              conv: str = "sage", seed: int = 0, eval_every: int = 5,
              optimizer: Optimizer | None = None, sync: str = "grad",
              wire: str = "dense", device="cuda", params=None,
              use_shard_map: bool = False, faults=None,
              fault_max_stale: int = 5, fault_backoff_cap: int = 16,
              checkpoint_dir: str | None = None, checkpoint_every: int = 0,
              resume: bool = False, stop_after: int | None = None,
              log_fn=None) -> TrainResult:
    """Partition ``g`` over ``q`` workers and train under ``policy`` on
    ``device`` (every partition stacked on one card; ``device="cpu"``
    runs the kernels' plain versions).

    ``g`` is a host ``GraphData``, a ``PartitionedGraph`` already cut
    (then ``q`` and ``scheme`` come with it and the partitioner does not
    run again), or the out-of-core input: a shard directory written by
    ``repro_torch.graph.stream.write_shards`` (or the JAX package's) or a
    loaded ``ShardSet``, whose halo/ELL arrays and halo spec ship in the
    shards.  Mirrors the paper's §V setup by default: 3-layer SAGE,
    256 hidden, full batch, and the JAX package's default wire,
    ``"dense"``: each worker's boundary block compressed by the policy's
    compressor (the paper's ``randmask`` unless the policy names another)
    and all-gathered.  ``wire="packed"`` ships only the kept 128-lane
    blocks (feature widths multiples of 128, compressing policies with
    the ``blockmask`` compressor); ``wire="p2p"`` the neighbour-only halo
    wire with the ELL local aggregation (same constraints under
    compression), to which auto policies and ``faults`` default from
    ``"dense"``.  ``params`` (a parameter tree, e.g. ``params_from_jax``
    of the JAX package's ``init_gnn``) replaces the seeded
    initialisation, which draws from a CPU ``torch.Generator(seed)``.

    The paper's comparison (the JAX package's quickstart) on the CPU::

        for pol in (FULL_COMM, fixed(4.0), varco(300, slope=5)):
            res = train_gnn(g, q=4, policy=pol, epochs=300, device="cpu")

    ``auto:<controller>:<budget-bits>[:w<width>][:per-layer]`` closes the
    loop on the p2p or packed wire: the controller (``budget``,
    ``error``, ``stale`` or ``qos``) plans a per-pair rate map, widths
    under ``:w<width>`` and, under ``stale``, the pairs served from the
    halo cache, each epoch from measured transport; a quantising policy
    on the p2p wire carries error-feedback residuals (never under
    ``stale``, whose cache channel holds the halos).

    ``faults`` (a :class:`repro_torch.dist.faults.FaultSchedule`) turns
    on the degraded-mode loop: each epoch the schedule's seeded link
    drops feed the *exchange → cached → backoff-probe → local-only*
    ladder (``fault_max_stale`` staleness cap, ``fault_backoff_cap``
    probe backoff) and every policy's step runs through the fault
    channel (scalar policies on a uniform rate map); a ``crash_at`` event
    shrinks the run to Q − 1 (shard-backed input only), migrating the
    controller and ladder state.  ``checkpoint_dir`` + ``checkpoint_every``
    persist the full train state atomically every N epochs
    (``stop_after`` also saves, then stops after that many epochs);
    ``resume=True`` restores it and continues at the saved epoch —
    bitwise on the CPU; on the card the dense wire's scatter atomics
    reorder f32 sums — replaying any recorded worker shrink.  On the CPU::

        train_gnn(shard_dir, policy=CommPolicy.parse("varco:linear:5", 6),
                  epochs=6, wire="p2p", device="cpu",
                  faults=FaultSchedule(q=4, drop_rate=0.25,
                                       crash_at=((3, 1),)),
                  checkpoint_dir="ck", stop_after=4)
        train_gnn(shard_dir, ..., checkpoint_dir="ck", resume=True)

    ``use_shard_map=True`` runs the worker backend, one process per
    worker over ``torch.distributed``: under an initialised process group
    of world size Q (``torchrun --nproc_per_node Q``) this process trains
    as its rank, on ``cuda:{rank % device_count}`` (or the CPU), with its
    own partition — the in-memory partitioner's, or its ``part_*.npz``
    alone from a shard directory — and returns its result (the same
    parameters on every rank).  Without a group it spawns Q workers
    (:func:`~repro_torch.dist.gnn_parallel.spawn_workers`, ``nccl`` on
    the card, ``gloo`` on the CPU) and returns the result of rank 0 of
    the final mesh, so one call in one interpreter works::

        res = train_gnn(g, q=4, policy=CommPolicy.parse(
            "varco:linear:5", 3, compressor="blockmask"), epochs=3,
            wire="p2p", device="cpu", use_shard_map=True)

    The worker backend runs the open-loop policies on every wire and the
    closed loop (``auto:budget``, ``auto:error``, ``auto:qos``, their
    widths and per-layer plans) on the p2p and packed wires, under both
    ``sync`` modes: every worker runs the controller on the same
    replicated metrics and so plans alike, each holds its own
    error-feedback residual slabs, and a quantised hop crosses the
    process boundary as its uint8 payload and f32 scales.
    ``auto:stale`` raises ``ValueError`` there, as in the JAX package (a
    shape-uniform ring cannot drop a pair's buffer).  Under ``faults``
    every worker runs the ladder on the same replicated schedule and
    serves its CACHED and DEAD pairs on its own side of the ring from its
    receiver-major fault-cache block; as in the JAX package's
    ``shard_map`` worker it runs no error feedback and ships quantised
    hops on the fp32 value path, rounded half to even.  A crash shrinks
    the group (:func:`~repro_torch.dist.gnn_parallel.shrink_mesh`): the
    survivors, renumbered as ``shrink_shards`` renumbers the partitions
    (a worker then loads every partition on the host, to re-wire the
    halo), train on in a subgroup, and the crashed worker leaves the
    epoch loop, waits for the others at the end and returns ``None``.  A
    checkpoint gathers every worker's caches into the emulated backend's
    tree (the fault cache sender-major), written by rank 0 of the mesh,
    so a file written by either backend resumes on the other; resuming a
    run that shrank spawns its live workers.  Spawned workers receive the
    arguments pickled: pass ``optimizer=None`` (the AdamW of ``lr``/
    ``weight_decay``) or start the workers yourself, since the optimisers
    are closures.

    An auto policy's quantised wire rounds by the device's default (``ops.
    default_wire_rounding``): stochastically on the card, as the JAX
    package does on its hardware target, and half to even on the CPU,
    where the port is held to the JAX package's CPU runs.
    """
    with span("train.setup"):
        from repro_torch.dist import faults as faultlib
        from repro_torch.graph.stream import (ShardSet, is_shard_dir,
                                              load_shards)
        from repro_torch.train import checkpoint as ckpt

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "train_gnn was asked for a CUDA device but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain versions on the CPU")
        auto = policy.mode == "auto"
        fault = faults is not None
        peeked = _peek_checkpoint(checkpoint_dir) if resume else None
        mesh = None
        if use_shard_map:
            if auto and policy.controller == "stale":
                from repro_torch.dist.ratectl.driver import STALE_ON_MESH
                raise ValueError(STALE_ON_MESH)
            if not (dist.is_available() and dist.is_initialized()):
                kwargs = dict(q=q, scheme=scheme, policy=policy, epochs=epochs,
                              lr=lr, weight_decay=weight_decay, hidden=hidden,
                              layers=layers, conv=conv, seed=seed,
                              eval_every=eval_every, optimizer=optimizer,
                              sync=sync, wire=wire, device=str(device),
                              faults=faults, fault_max_stale=fault_max_stale,
                              fault_backoff_cap=fault_backoff_cap,
                              checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every, resume=resume,
                              stop_after=stop_after, log_fn=log_fn,
                              params=None if params is None else
                              params_to(params, "cpu"))
                return spawn_workers(_train_worker, _world_size(g, q, peeked),
                                     g, kwargs, device=device)
            mesh = make_worker_mesh(_world_size(g, q, peeked), device)
            device = mesh.device
        if (auto or fault) and wire == "dense":
            wire = "p2p"               # per-pair rates need a per-pair wire
        sched = faults
        alive = None if peeked is None else peeked.get("alive")
        shrunk = alive is not None and len(alive) < _world_size(g, q)
        if is_shard_dir(g):
            # a worker reads its own partition's file alone, unless a crash
            # re-wires the halo (shrink_shards needs every partition)
            own_part = mesh is not None and not shrunk and \
                not (fault and faults.crash_at)
            g = load_shards(g, parts=[mesh.rank] if own_part else None)
        elif isinstance(g, (str, bytes)):
            raise FileNotFoundError(f"{g!r} is no shard directory (no "
                                    f"shards.json)")
        cfg = GNNConfig(conv=conv, in_dim=g.feat_dim, hidden=hidden,
                        out_dim=g.num_classes, layers=layers)
        if params is None:
            params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                              device=device)
        params = params_to(params, device)
        # a worker holds its own partition (a one-part shard set) or stacks
        # every partition on the host and keeps its own row
        own = mesh is not None and isinstance(g, ShardSet) and \
            len(g.parts) == 1
        if own and g.parts != (mesh.rank,):
            raise ValueError(f"worker {mesh.rank} was given the shards of "
                             f"partition {g.parts[0]}")
        stack_on = device if mesh is None or own else torch.device("cpu")
        if isinstance(g, ShardSet):
            pg = g                     # partitioned offline; q comes with it
            with span("train.setup.device_arrays"):
                graph = pg.device_arrays(stack_on)
        else:
            pg = g if isinstance(g, PartitionedGraph) else \
                partition_graph(g, q, scheme=scheme, seed=seed)
            with span("train.setup.device_arrays"):
                graph = pg.device_arrays(stack_on)
            if wire == "p2p" or auto:      # auto's per-pair stats need them
                from repro_torch.dist.halo import attach_p2p
                with span("train.setup.attach_p2p"):
                    graph = attach_p2p(graph, pg, stack_on)
        q = pg.q
        if resume:
            if alive is not None and len(alive) < q:
                # the checkpointed run had already shrunk: replay the shrinks
                # so the like-tree (and every step closure) matches its world
                if not isinstance(pg, ShardSet):
                    raise ValueError("resuming a shrunk run needs "
                                     "shard-backed input (a ShardSet / "
                                     "shard dir)")
                cur = list(range(q))
                for w in sorted(set(cur) - set(int(a) for a in alive)):
                    pg = faultlib.shrink_shards(pg, cur.index(w))
                    cur.remove(w)
                q = pg.q
                with span("train.setup.device_arrays"):
                    graph = pg.device_arrays(stack_on)
                if sched is not None:
                    sched = dataclasses.replace(
                        sched, alive=tuple(int(a) for a in alive))
            if int(peeked.get("q", q)) != q:
                raise ValueError(f"checkpoint world size {peeked['q']} does "
                                 f"not match this run's q={q}")
        if mesh is not None and not own:
            graph = shard_graph(graph, mesh)
        with span("train.setup.meta"):
            meta = DistMeta.build(pg, params, wire=wire)
        if auto or fault:
            from repro_torch.dist.ratectl import (init_halo_cache,
                                                  init_wire_residuals,
                                                  make_auto_train_step,
                                                  make_controller,
                                                  uniform_plan)

        def _init_cache(meta_):
            if not auto:
                return ()
            if policy.controller == "stale":
                return init_halo_cache(meta_, cfg, device)
            if policy.max_width < 32 and meta_.wire == "p2p":
                # the cache channel carries error-feedback residuals
                # instead (a worker holds its own slab)
                return init_wire_residuals(meta_, cfg, device, mesh)
            return ()

        def _make_step(meta_):
            if fault:
                return faultlib.make_fault_train_step(
                    cfg, policy, opt, meta_, mesh=mesh, sync=sync)
            if auto:
                return make_auto_train_step(cfg, policy, opt, meta_,
                                            mesh=mesh, sync=sync)
            return make_train_step(cfg, policy, opt, meta_, mesh=mesh,
                                   sync=sync)

        with span("train.setup.steps"):
            opt = optimizer or adamw(lr, weight_decay=weight_decay)
            opt_state = opt.init(params)
            ctl = ctl_state = None
            if auto:
                ctl = make_controller(policy, meta, cfg, total_steps=epochs)
                ctl_state = ctl.init()
            cache = _init_cache(meta)
            fcache = init_halo_cache(meta, cfg, device, mesh) if fault else ()
            dstate = faultlib.init_degrade(q) if fault else None
            step = _make_step(meta)
            evaluate = make_eval_step(cfg, meta, mesh=mesh)

        hist = History()
        halo_bits_cum = transport_bits_cum = err_cum = 0.0
        pair_bits_cum = layer_bits_cum = None
        start_epoch = 0

        def _state_tree():
            tree = {"params": params, "opt": opt_state}
            if auto:
                tree["ctl"] = ctl_state
            if cache:
                tree["cache"] = tuple(cache)
            if fault:
                tree["fcache"] = tuple(fcache)
            return tree

        def _ck_tree():
            """The train state as the emulated backend holds it, so either
            backend resumes the file: on a worker every worker's residual
            slabs and fault-cache blocks are gathered, the fault cache turned
            sender-major."""
            tree = _state_tree()
            if mesh is not None:
                if cache:
                    tree["cache"] = tuple(mesh.all_gather(c[0]) for c in cache)
                if fault:
                    tree["fcache"] = tuple(faultlib._cache_recv_to_send(
                        mesh.all_gather(c[0]), q) for c in fcache)
            return tree

        def _ck_like():
            """:func:`_ck_tree`'s shapes to restore into (a worker's caches
            on the host: it keeps its own rows)."""
            tree = _state_tree()
            if mesh is not None:
                if cache:
                    tree["cache"] = init_wire_residuals(meta, cfg, "cpu")
                if fault:
                    tree["fcache"] = init_halo_cache(meta, cfg, "cpu")
            return tree

        def _ck_extra():
            return {
                "q": int(q),
                "alive": [int(w) for w in sched.alive_workers] if fault
                else None,
                "halo": float(halo_bits_cum),
                "transport": float(transport_bits_cum),
                "err": float(err_cum),
                "pair": None if pair_bits_cum is None
                else pair_bits_cum.tolist(),
                "layer": None if layer_bits_cum is None
                else layer_bits_cum.tolist(),
                "degrade": None if dstate is None else {
                    "age": dstate.age.tolist(),
                    "backoff": dstate.backoff.tolist(),
                    "next_try": dstate.next_try.tolist()},
                "policy": policy.describe(),
            }

        if resume:
            tree, start_epoch, ext = ckpt.restore_train_state(checkpoint_dir,
                                                              _ck_like())
            params, opt_state = tree["params"], tree["opt"]
            if auto:
                ctl_state = tree["ctl"]
            if "cache" in tree:
                cache = tree["cache"] if mesh is None else tuple(
                    c[mesh.rank:mesh.rank + 1].to(device)
                    for c in tree["cache"])
            if fault:
                fcache = tree["fcache"] if mesh is None else tuple(
                    faultlib._cache_send_to_recv(c, q)[mesh.rank:mesh.rank + 1]
                    .to(device) for c in tree["fcache"])
                dg = ext.get("degrade")
                if dg is not None:
                    dstate = faultlib.DegradeState(
                        age=np.asarray(dg["age"], np.int64),
                        backoff=np.asarray(dg["backoff"], np.int64),
                        next_try=np.asarray(dg["next_try"], np.int64))
            halo_bits_cum = float(ext.get("halo", 0.0))
            transport_bits_cum = float(ext.get("transport", 0.0))
            err_cum = float(ext.get("err", 0.0))
            if ext.get("pair") is not None:
                pair_bits_cum = np.asarray(ext["pair"], np.float64)
            if ext.get("layer") is not None:
                layer_bits_cum = np.asarray(ext["layer"], np.float64)

    crashed = False
    t0 = time.time()
    for epoch in range(start_epoch, epochs):
        with span("train.step"):
            t_step = time.perf_counter()
            if mesh is not None:
                wire0 = _wire_counters(mesh)
            width = 32.0
            if fault:
                crash = sched.crash_at_step(epoch)
                if crash is not None:
                    if not isinstance(pg, ShardSet):
                        raise ValueError(
                            "elastic worker-crash recovery needs shard-backed "
                            "input (a ShardSet / shard dir) — in-memory "
                            "partitions cannot be renumbered at Q - 1")
                    if q <= 2:
                        raise ValueError("cannot shrink below Q = 2 — the "
                                         "fault plane needs at least one link")
                    q_old = q
                    pg = faultlib.shrink_shards(pg, crash)
                    q = pg.q
                    meta = DistMeta.build(pg, params, wire=wire)
                    sched = sched.shrink(crash)
                    dstate = faultlib.migrate_degrade_state(dstate, crash)
                    if mesh is None:
                        graph = pg.device_arrays(device)
                    else:
                        ranks = mesh.ranks
                        mesh = shrink_mesh(mesh, crash)
                        if mesh is None:    # this worker crashed: it trains no
                            crashed = True  # more, and returns None
                            _follow_crashes(sched,
                                            ranks[:crash] + ranks[crash + 1:],
                                            epoch, epochs if stop_after is None
                                            else min(epochs, stop_after))
                            break
                        graph = shard_graph(pg.device_arrays("cpu"), mesh)
                    if auto:
                        ctl = make_controller(policy, meta, cfg,
                                              total_steps=epochs)
                        ctl_state = faultlib.migrate_controller_state(
                            ctl_state, crash, q_old)
                    cache = _init_cache(meta)   # stale/EF buffers restart cold
                    fcache = init_halo_cache(meta, cfg, device, mesh)
                    step = _make_step(meta)
                    evaluate = make_eval_step(cfg, meta, mesh=mesh)
                    # keep cumulative pair splits shaped [..., Q, Q]: the dead
                    # worker's history leaves the ledger with it
                    if pair_bits_cum is not None:
                        pair_bits_cum = np.delete(
                            np.delete(pair_bits_cum, crash, 0), crash, 1)
                    if layer_bits_cum is not None:
                        layer_bits_cum = np.delete(
                            np.delete(layer_bits_cum, crash, 1), crash, 2)
                serve, dstate = faultlib.degrade_plan(
                    dstate, sched.effective_drops(epoch), epoch,
                    max_stale=fault_max_stale, backoff_cap=fault_backoff_cap)
                fskip, dead = faultlib.serve_masks(serve)
                ladder = (int(fskip.sum()), int(dead.sum()))
                if auto:
                    plan, ctl_state = ctl.plan(ctl_state, epoch)
                    width = _plan_width(plan, q)
                else:
                    r = float(policy.rate(epoch)) if policy.compresses else 1.0
                    plan = uniform_plan(q, r)
                params, opt_state, m, cache, fcache = step(
                    params, opt_state, graph, prng.key(epoch), plan, fskip,
                    dead, cache, fcache)
                if auto:
                    ctl_state = ctl.observe(ctl_state, m)
            elif auto:
                plan, ctl_state = ctl.plan(ctl_state, epoch)
                width = _plan_width(plan, q)
                params, opt_state, m, cache = step(
                    params, opt_state, graph, prng.key(epoch), plan, cache)
                ctl_state = ctl.observe(ctl_state, m)
            else:
                params, opt_state, m = step(params, opt_state, graph, epoch,
                                            prng.key(epoch))
            if auto or fault:
                pair_t = np.asarray(m["pair_transport"], np.float64)
                pair_bits_cum = pair_t if pair_bits_cum is None \
                    else pair_bits_cum + pair_t
                err_cum += float(np.asarray(m["pair_err"], np.float64).sum())
                if "layer_transport" in m:
                    layer_t = np.asarray(m["layer_transport"], np.float64)
                    layer_bits_cum = layer_t if layer_bits_cum is None \
                        else layer_bits_cum + layer_t
            with span("sync.loss"):
                loss = float(m["loss"])             # the step's device sync
            step_s = time.perf_counter() - t_step
        if mesh is not None:
            moved = [b - a for a, b in zip(wire0, _wire_counters(mesh))]
        halo_bits_cum += float(m["halo_bits"])
        transport_bits_cum += float(m["transport_bits"])
        if epoch % eval_every == 0 or epoch == epochs - 1:
            with span("train.evaluate"):
                accs = evaluate(params, graph)
            hist.epoch.append(epoch)
            hist.loss.append(loss)
            hist.rate.append(float(m["rate"]))
            hist.train_acc.append(float(accs["train"]))
            hist.val_acc.append(float(accs["val"]))
            hist.test_acc.append(float(accs["test"]))
            hist.halo_gfloats.append(halo_bits_cum / 32.0 / 1e9)
            hist.transport_gfloats.append(transport_bits_cum / 32.0 / 1e9)
            hist.wall_s.append(time.time() - t0)
            hist.width.append(width)
            hist.step_s.append(step_s)
            if fault:
                hist.cached_pairs.append(ladder[0])
                hist.dead_pairs.append(ladder[1])
            if mesh is not None:
                hist.sent_bytes.append(moved[0])
                hist.staged_bytes.append(moved[1])
                hist.comm_s.append(moved[2])
            if pair_bits_cum is not None:
                hist.pair_transport_gf.append(tuple(
                    pair_bits_cum.ravel() / 32.0 / 1e9))
                hist.comp_err.append(err_cum)
            if layer_bits_cum is not None:
                hist.layer_transport_gf.append(tuple(
                    layer_bits_cum.ravel() / 32.0 / 1e9))
            if log_fn and (mesh is None or mesh.rank == 0):
                log_fn(hist.row(len(hist.epoch) - 1))
        done = epoch + 1
        if checkpoint_dir and (
                (checkpoint_every and done % checkpoint_every == 0)
                or done == stop_after):
            tree = _ck_tree()
            if mesh is None or mesh.rank == 0:
                ckpt.save_train_state(checkpoint_dir, tree, done,
                                      extra=_ck_extra())
            if mesh is not None:
                mesh.barrier()         # no worker reads it before the rename
        if stop_after is not None and done >= stop_after:
            break
    if use_shard_map:
        leave_group(mesh)              # a crashed worker too, with None
        if crashed:
            return None
    return TrainResult(hist, params, meta, policy.describe())

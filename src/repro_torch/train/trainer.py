"""Full-batch distributed GNN trainer (the paper's experimental loop).

Counterpart of ``repro/train/trainer.py`` on the emulated backend: runs
Algorithm 1 for ``epochs`` steps (full batch, one gradient step per
epoch) with every partition stacked on one device, tracking the
communication ledger so accuracy can be plotted against epochs or
communicated floats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist.gnn_parallel import (DistMeta, make_eval_step,
                                           make_train_step)
from repro_torch.graph.partition import PartitionedGraph, partition_graph
from repro_torch.nn.gnn import GNNConfig, init_gnn, params_to
from repro_torch.train.optim import Optimizer, adamw


@dataclasses.dataclass
class History:
    """Per-epoch training record (the JAX package's columns).

    ``pair_transport_gf`` is the cumulative per-pair transport split
    (flattened receiver-major ``[Q*Q]`` Gfloats per logged epoch, auto
    policies), ``layer_transport_gf`` its per-layer refinement (per-layer
    auto policies) and ``comp_err`` the cumulative measured compression
    error.  ``width`` (the step's mean planned off-diagonal wire width,
    32 when exact) and ``step_s`` (host seconds of the step, ending in the
    metrics' device sync) are the port's additions; ``row()`` keeps the
    JAX package's CSV columns.
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


def _not_ported(**knobs) -> None:
    for name, (value, item) in knobs.items():
        if value:
            raise NotImplementedError(
                f"train_gnn({name}=...) is not ported yet (ROADMAP {item})")


def _plan_width(plan, q: int) -> float:
    if plan.widths is None:
        return 32.0
    off = ~np.eye(q, dtype=bool)
    return float(np.asarray(plan.widths, np.float32).reshape(-1, q, q)
                 [:, off].mean())


def train_gnn(g, *, q: int = 8, scheme: str = "random",
              policy: CommPolicy, epochs: int = 300, lr: float = 5e-3,
              weight_decay: float = 0.0, hidden: int = 256, layers: int = 3,
              conv: str = "sage", seed: int = 0, eval_every: int = 5,
              optimizer: Optimizer | None = None, sync: str = "grad",
              wire: str = "dense", device="cuda", params=None,
              use_shard_map: bool = False, faults=None,
              checkpoint_dir: str | None = None, checkpoint_every: int = 0,
              resume: bool = False, stop_after: int | None = None,
              log_fn=None) -> TrainResult:
    """Partition ``g`` over ``q`` workers and train under ``policy`` on
    ``device`` (every partition stacked on one card; ``device="cpu"``
    runs the kernels' plain versions).

    ``g`` is a host ``GraphData``, or a ``PartitionedGraph`` already cut
    (then ``q`` and ``scheme`` come with it and the partitioner does not
    run again).  Mirrors the paper's §V setup by default: 3-layer SAGE,
    256 hidden, full batch, and the JAX package's default wire,
    ``"dense"``: each worker's boundary block compressed by the policy's
    compressor (the paper's ``randmask`` unless the policy names another)
    and all-gathered.  ``wire="packed"`` ships only the kept 128-lane
    blocks (feature widths multiples of 128, compressing policies with
    the ``blockmask`` compressor); ``wire="p2p"`` the neighbour-only halo
    wire with the ELL local aggregation (same constraints under
    compression), to which auto policies default from ``"dense"``.  ``params`` (a
    parameter tree, e.g. ``params_from_jax`` of the JAX package's
    ``init_gnn``) replaces the seeded initialisation, which draws from a
    CPU ``torch.Generator(seed)``.

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

    Not ported (raise ``NotImplementedError``): ``use_shard_map``,
    ``faults``, checkpointing (``checkpoint_dir``/``resume``/
    ``stop_after``), shard directories.  The quantised wire rounds half
    to even (the JAX package's default off the TPU;
    ``make_auto_train_step(rounding="stochastic")`` rounds unbiased).
    """
    _not_ported(use_shard_map=(use_shard_map, "queue 1: shard_map backend"),
                faults=(faults is not None, "queue 1: fault channels"),
                checkpoint_dir=(checkpoint_dir or checkpoint_every,
                                "queue 1: checkpoints"),
                resume=(resume, "queue 1: checkpoints"),
                stop_after=(stop_after is not None, "queue 1: checkpoints"))
    if isinstance(g, (str, bytes)):
        raise NotImplementedError("shard directories are not ported yet "
                                  "(ROADMAP queue 1: out-of-core graphs)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train_gnn was asked for a CUDA device but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain versions on the CPU")
    auto = policy.mode == "auto"
    if auto and wire == "dense":
        wire = "p2p"                   # per-pair rates need a per-pair wire
    cfg = GNNConfig(conv=conv, in_dim=g.feat_dim, hidden=hidden,
                    out_dim=g.num_classes, layers=layers)
    if params is None:
        params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                          device=device)
    params = params_to(params, device)
    pg = g if isinstance(g, PartitionedGraph) else \
        partition_graph(g, q, scheme=scheme, seed=seed)
    q = pg.q
    graph = pg.device_arrays(device)
    if wire == "p2p" or auto:          # auto's per-pair stats need them
        from repro_torch.dist.halo import attach_p2p
        graph = attach_p2p(graph, pg, device)
    meta = DistMeta.build(pg, params, wire=wire)
    opt = optimizer or adamw(lr, weight_decay=weight_decay)
    opt_state = opt.init(params)

    cache: tuple = ()
    if auto:
        from repro_torch.dist.ratectl import (init_halo_cache,
                                              init_wire_residuals,
                                              make_auto_train_step,
                                              make_controller)
        ctl = make_controller(policy, meta, cfg, total_steps=epochs)
        ctl_state = ctl.init()
        step = make_auto_train_step(cfg, policy, opt, meta, sync=sync)
        if policy.controller == "stale":
            cache = init_halo_cache(meta, cfg, device)
        elif policy.max_width < 32 and wire == "p2p":
            # the cache channel carries error-feedback residuals instead
            cache = init_wire_residuals(meta, cfg, device)
    else:
        step = make_train_step(cfg, policy, opt, meta, sync=sync)
    evaluate = make_eval_step(cfg, meta)

    hist = History()
    halo_bits_cum = transport_bits_cum = err_cum = 0.0
    pair_bits_cum = layer_bits_cum = None
    t0 = time.time()
    for epoch in range(epochs):
        t_step = time.perf_counter()
        width = 32.0
        if auto:
            plan, ctl_state = ctl.plan(ctl_state, epoch)
            width = _plan_width(plan, q)
            params, opt_state, m, cache = step(params, opt_state, graph,
                                               prng.key(epoch), plan, cache)
            ctl_state = ctl.observe(ctl_state, m)
            pair_t = np.asarray(m["pair_transport"], np.float64)
            pair_bits_cum = pair_t if pair_bits_cum is None \
                else pair_bits_cum + pair_t
            err_cum += float(np.asarray(m["pair_err"], np.float64).sum())
            if "layer_transport" in m:
                layer_t = np.asarray(m["layer_transport"], np.float64)
                layer_bits_cum = layer_t if layer_bits_cum is None \
                    else layer_bits_cum + layer_t
        else:
            params, opt_state, m = step(params, opt_state, graph, epoch,
                                        prng.key(epoch))
        loss = float(m["loss"])                 # the step's device sync
        step_s = time.perf_counter() - t_step
        halo_bits_cum += float(m["halo_bits"])
        transport_bits_cum += float(m["transport_bits"])
        if epoch % eval_every == 0 or epoch == epochs - 1:
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
            if pair_bits_cum is not None:
                hist.pair_transport_gf.append(tuple(
                    pair_bits_cum.ravel() / 32.0 / 1e9))
                hist.comp_err.append(err_cum)
            if layer_bits_cum is not None:
                hist.layer_transport_gf.append(tuple(
                    layer_bits_cum.ravel() / 32.0 / 1e9))
            if log_fn:
                log_fn(hist.row(len(hist.epoch) - 1))
    return TrainResult(hist, params, meta, policy.describe())

"""Worker functions of the worker-backend tests: each runs in every
process of a group started by ``repro_torch.dist.gnn_parallel.
spawn_workers`` and returns what the test compares (gathered to rank 0).

This module imports neither JAX nor the JAX package, so the spawned
workers start quickly and the card's test file can use it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core import collectives as col
from repro_torch.core.compression import get_compressor
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as gp
from repro_torch.dist.halo import attach_p2p
from repro_torch.dist.ratectl import (RatePlan, init_wire_residuals,
                                      make_auto_train_step, make_controller)
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.kernels.ell_spmm import ell_spmm
from repro_torch.kernels.varco_pack import (varco_pack,
                                            varco_pack_quant_stochastic,
                                            varco_unpack, varco_unpack_quant)
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim
from repro_torch.train.trainer import train_gnn

#: the collectives' shared key, and the packed wires' rate
KEY, RATE_MASK, RATE_PACK = 11, 4.0, 2.0
#: the key of the halos the backends are held to each other by
HALO_KEY = 5


@contextlib.contextmanager
def one_thread():
    """Run the test process's own (emulated) references on one CPU thread,
    as the spawned workers run: at these tiny shapes more threads buy
    nothing, and on a loaded machine their synchronisation costs 100×."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def collective_inputs(q: int, seed: int = 0, b: int = 24, f: int = 256,
                      h: int = 10) -> dict:
    """Seeded numpy inputs of every worker: boundary blocks ``x [Q, B,
    F]``, ring slots and validity ``[Q, Q-1, H]``, and one cotangent per
    worker for each output."""
    rng = np.random.default_rng(seed + q)
    d = max(q - 1, 1)
    return {
        "x": rng.normal(size=(q, b, f)).astype(np.float32),
        "slot": rng.integers(0, b, (q, d, h)).astype(np.int32),
        "valid": (rng.random((q, d, h)) < 0.8).astype(np.float32),
        "ct_gather": rng.normal(size=(q, q, b, f)).astype(np.float32),
        "ct_ring": rng.normal(size=(q, d * h, f)).astype(np.float32),
    }


def _vjp(out: torch.Tensor, x: torch.Tensor, ct) -> torch.Tensor:
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(ct))
    return dx


def collective_cases(mesh, seed: int = 0) -> list:
    """Every worker's ``(output, bits, input cotangent)`` of the dense,
    packed and p2p (unpacked and packed) collectives, and ``(output,
    bits)`` of the dense and p2p ones under ``group_bits=False``, in rank
    order."""
    q, r = mesh.q, mesh.rank
    inp = collective_inputs(q, seed)
    key = prng.key(KEY)
    f = inp["x"].shape[-1]
    n_keep = max(int(f // 128 / RATE_PACK), 1)
    out = {}

    def leaf():
        return torch.from_numpy(inp["x"][r].copy()).requires_grad_(True)

    x = leaf()
    y, bits = col.compressed_all_gather(
        x, mesh, compressor=get_compressor("randmask"), rate=RATE_MASK,
        key=key)
    out["dense"] = (y.detach(), float(bits), _vjp(y, x, inp["ct_gather"][r]))
    x = leaf()
    y, bits = col.packed_all_gather(x, mesh, key=key, n_keep=n_keep)
    out["packed"] = (y.detach(), float(bits),
                     _vjp(y, x, inp["ct_gather"][r]))
    for name, nk in (("p2p", None), ("p2p_packed", n_keep)):
        x = leaf()
        y, bits = col.neighbor_exchange(
            x, torch.from_numpy(inp["slot"][r]),
            torch.from_numpy(inp["valid"][r]), mesh, key=key, n_keep=nk)
        out[name] = (y.detach(), float(bits), _vjp(y, x, inp["ct_ring"][r]))
    # the runtime's calls: the same collectives without the bits'
    # all-reduce
    with torch.no_grad():
        x = leaf()
        out["dense_no_bits"] = col.compressed_all_gather(
            x, mesh, compressor=get_compressor("randmask"), rate=RATE_MASK,
            key=key, group_bits=False)
        for name, nk in (("p2p", None), ("p2p_packed", n_keep)):
            pending, bits = col.neighbor_exchange_start(
                x, torch.from_numpy(inp["slot"][r]),
                torch.from_numpy(inp["valid"][r]), mesh, key=key,
                n_keep=nk, group_bits=False)
            out[f"{name}_no_bits"] = (col.neighbor_exchange_finish(
                pending, mesh, key=key, n_keep=nk), bits)
    every = [None] * q
    dist.all_gather_object(every, out)
    return every


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

N, F, HIDDEN, LAYERS, LR, STEPS = 256, 128, 256, 3, 0.1, 3


def train_setup(q: int, params_np, device="cpu"):
    """The tiny graph cut into ``q`` partitions with its p2p arrays, the
    config and the starting parameters (``params_np``: the JAX package's
    initialisation as numpy)."""
    g = tiny_graph(n=N, feat_dim=F)
    pg = partition_graph(g, q, seed=0)
    graph = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    cfg = tgnn.GNNConfig(conv="sage", in_dim=F, hidden=HIDDEN,
                         out_dim=g.num_classes, layers=LAYERS)
    return pg, graph, cfg, tgnn.params_from_jax(params_np, device)


def case_policy(spec: str, comp):
    return CommPolicy.parse(spec, 40, compressor=comp)


def run_case(step, evaluate, params, opt, graph) -> dict:
    """``STEPS`` steps from ``params`` and an evaluation after the last:
    per-step loss, rate and bits, the accuracies, the final parameters
    and the optimiser's step count."""
    state = opt.init(params)
    rec = {"loss": [], "rate": [], "halo_bits": [], "transport_bits": []}
    for t in range(STEPS):
        params, state, m = step(params, state, graph, t, prng.key(t))
        for k in ("loss", "rate", "halo_bits", "transport_bits"):
            rec[k].append(float(m[k]))
    rec["acc"] = {k: float(v) for k, v in evaluate(params, graph).items()}
    rec["params"] = [t.detach().cpu().numpy()
                     for t in optim.tree_leaves(params)]
    rec["step_count"] = int(state["step"])
    return rec


def train_cases(mesh, cases: dict, params_np) -> dict:
    """Each case ``name -> (wire, spec, compressor, sync)`` through the
    worker backend: :func:`run_case` (rank 0's) and every worker's first
    halo."""
    pg, host, cfg, params = train_setup(mesh.q, params_np)
    graph = gp.shard_graph(host, mesh)
    out = {}
    for name, (wire, spec, comp, sync) in cases.items():
        meta = gp.DistMeta.build(pg, params, wire=wire)
        pol = case_policy(spec, comp)
        opt = optim.sgd(LR, momentum=0.9)
        step = gp.make_train_step(cfg, pol, opt, meta, mesh=mesh, sync=sync)
        rec = run_case(step, gp.make_eval_step(cfg, meta, mesh=mesh),
                       params, opt, graph)
        halo = gp.first_halo(graph, meta, pol, prng.key(HALO_KEY),
                             graph["features"], mesh)
        halos = [None] * mesh.q
        dist.all_gather_object(halos, halo.numpy())
        rec["halo"] = halos
        out[name] = rec
    return out


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 returns."""
    if mesh.rank == 1:
        raise ValueError("worker 1 failed on purpose")
    return "rank 0 done"


def card_step(mesh, spec: str = "varco:linear:5") -> dict:
    """One p2p step of ``spec`` on the card through the worker backend
    (the tiny graph, seeded parameters): loss, bits, updated parameters
    (moved to the CPU)."""
    g = tiny_graph(n=N, feat_dim=F)
    pg = partition_graph(g, mesh.q, seed=0)
    host = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    cfg = tgnn.GNNConfig(conv="sage", in_dim=F, hidden=HIDDEN,
                         out_dim=g.num_classes, layers=LAYERS)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                           device=mesh.device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    pol = case_policy(spec, "blockmask")
    opt = optim.sgd(LR)
    step = gp.make_train_step(cfg, pol, opt, meta, mesh=mesh)
    params, _, m = step(params, opt.init(params), gp.shard_graph(host, mesh),
                        0, prng.key(0))
    return {"loss": float(m["loss"]),
            "halo_bits": float(m["halo_bits"]),
            "params": [t.cpu() for t in optim.tree_leaves(params)],
            "launches": {fn.__name__: fn.launches for fn in (
                ell_spmm, varco_pack, varco_unpack)}}


# ---------------------------------------------------------------------------
# The closed loop on the worker group
# ---------------------------------------------------------------------------

#: auto runs: STEPS steps each, the controllers paced over STEPS
AUTO_STEPS = STEPS


def half_budget(pg) -> float:
    """Half the full-rate transport of an ``AUTO_STEPS`` run of the
    ``train_setup`` model (``halo_demand`` × every exchanged width × 32
    bits, both ways)."""
    widths = F + HIDDEN * (LAYERS - 1)
    return 0.5 * 2.0 * 32.0 * pg.halo_demand * widths * AUTO_STEPS


def fixed_plan(kind: str, q: int, seed: int = 3):
    """A seeded ``RatePlan`` (rates {1, 2, 3} off the diagonal): ``mixed``
    widths {4, 8, 32} with pair (0, 1) at 32 — an fp32 pair beside
    quantised ones, the straight-through value path — or ``w<b>`` every
    pair at ``b`` bits; ``per_layer`` adds a leading ``[L]`` axis with a
    rate map per layer."""
    rng = np.random.default_rng(seed)
    eye = np.eye(q, dtype=bool)
    lead = (LAYERS,) if kind.endswith("per_layer") else ()
    rates = np.where(eye, 1.0, rng.choice([1.0, 2.0, 3.0], lead + (q, q)))
    if kind.startswith("mixed"):
        widths = np.where(eye, 32.0, rng.choice([4.0, 8.0, 32.0], (q, q)))
        widths[0, 1] = 32.0
    else:
        widths = np.where(eye, 32.0, float(kind[1:].split("_")[0]))
    return RatePlan(rates.astype(np.float32), np.zeros((q, q), np.float32),
                    widths.astype(np.float32))


def _np(t):
    return None if t is None else np.asarray(
        t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def auto_case_policy(spec: str, pg):
    return CommPolicy.parse(spec.format(half=half_budget(pg)), AUTO_STEPS)


def run_auto_case(pg, graph, cfg, params, case: dict, mesh=None) -> dict:
    """``AUTO_STEPS`` auto steps of ``case`` (``wire``, ``spec`` with
    ``{half}`` for :func:`half_budget`, ``sync``, ``rounding``, ``plan``:
    ``"ctl"`` for the policy's controller, else a :func:`fixed_plan`
    kind) from ``params`` under SGD with momentum, emulated
    (``mesh=None``) or on this worker.  Records per step the loss, the
    ledger, the pair matrices and the plan; the controller state, the
    residual caches after the first step and the last, the final
    parameters, and layer 0's halo under the first plan."""
    meta = gp.DistMeta.build(pg, params, wire=case["wire"])
    pol = auto_case_policy(case["spec"], pg)
    q = meta.q
    lr = LR / q if mesh is None and case["sync"] == "fedavg" else LR
    opt = optim.sgd(lr, momentum=0.9)
    step = make_auto_train_step(cfg, pol, opt, meta, mesh=mesh,
                                sync=case["sync"], rounding=case["rounding"])
    ctl = make_controller(pol, meta, cfg, AUTO_STEPS)
    cstate = ctl.init()
    cache = init_wire_residuals(meta, cfg, "cpu", mesh) \
        if pol.max_width < 32 and meta.wire == "p2p" else ()
    state = opt.init(params)
    rec = {k: [] for k in ("loss", "rate", "halo_bits", "transport_bits",
                           "pair_transport", "pair_err", "rates",
                           "widths")}
    plans = []
    for t in range(AUTO_STEPS):
        if case["plan"] == "ctl":
            plan, cstate = ctl.plan(cstate, t)
        else:
            plan = fixed_plan(case["plan"], q)
        plans.append(plan)
        params, state, m, cache = step(params, state, graph, prng.key(t),
                                       plan, cache)
        cstate = ctl.observe(cstate, m)
        for k in ("loss", "rate", "halo_bits", "transport_bits",
                  "pair_transport", "pair_err"):
            rec[k].append(_np(m[k]))
        rec["rates"].append(_np(plan.rates))
        rec["widths"].append(_np(plan.widths))
        if t == 0:
            rec["resid_first"] = [_np(c) for c in cache]
    rec["resid_last"] = [_np(c) for c in cache]
    rec["ctl_state"] = [_np(v) for v in optim.tree_leaves(cstate)]
    rec["params"] = [_np(t) for t in optim.tree_leaves(params)]
    rec["halo"] = _np(gp.first_halo(graph, meta, pol,
                                    prng.key(HALO_KEY), graph["features"],
                                    mesh, plan=plans[0],
                                    rounding=case["rounding"]))
    return rec


def capture_wire(pg, graph, cfg, params, wire: str, width: int,
                 mesh=None) -> dict:
    """One forward with every pair at rate 2 and ``width`` bits, capturing
    the buffers each exchange handed to the transport (``wire_out``):
    their byte counts over the genuine rows, per (receiver, sender) pair
    (this worker's hops only under ``mesh``), and the ledger's per-pair
    transport bits."""
    q = pg.q
    eye = np.eye(q, dtype=bool)
    rm = np.where(eye, 1.0, 2.0).astype(np.float32)
    wm = np.where(eye, 32.0, float(width)).astype(np.float32)
    meta = gp.DistMeta.build(pg, params, wire=wire)
    pol = CommPolicy.parse("fixed:2", 1, compressor="blockmask")
    cap: list = []
    kw = dict(packed_k=dict(gp._packed_pair_k_for(meta, rm)), rate_map=rm,
              width_map=wm, store_w=gp._packed_store_w(meta, wm),
              wire_out=cap)
    one = torch.ones(())
    with torch.no_grad():
        agg = gp._make_aggregate_emulated(graph, meta, pol, one,
                                          prng.key(7), **kw) \
            if mesh is None else \
            gp._make_aggregate_shard(graph, meta, pol, one, prng.key(7),
                                     mesh, **kw)
        _, bits = tgnn.gnn_forward(params, cfg, graph["features"], agg)
    valid = graph["p2p_send_valid"].numpy()                # [Q|1, D, H]
    senders = range(q) if mesh is None else [mesh.rank]
    meas = np.zeros((q, q))
    per_row = []
    for payload, scales in cap:
        if mesh is not None:                       # this worker's buffers
            payload = payload[None]
            scales = None if scales is None else scales[None]
        # one row: of the first sender's payload, or of its first hop
        lead = (0,) * (payload.dim() - 1)
        per_row.append(payload[lead].numel() * payload.element_size() + (
            0 if scales is None else scales[lead].numel() * 4))
        if wire != "p2p":
            continue
        for i, j in enumerate(senders):
            for d in range(q - 1):
                sel = torch.from_numpy(valid[i, d] > 0)
                n = payload[i, d][sel].numel() * payload.element_size()
                if scales is not None:
                    n += scales[i, d][sel].numel() * 4
                meas[(j + d + 1) % q, j] += n
    return {"meas": meas, "per_row": per_row,
            "pair_t": bits[2:2 + q * q].numpy().astype(np.float64).reshape(
                q, q), "n_exchanges": len(cap)}


def auto_cases(mesh, cases: dict, captures: tuple, params_np) -> dict:
    """Every auto case through this worker (:func:`run_auto_case`), the
    ``(wire, width)`` captures (:func:`capture_wire`), and
    ``train_gnn(use_shard_map=True)`` under ``auto:budget:<half>:w8`` on
    the group already running, each worker's records gathered to rank
    0."""
    pg, host, cfg, params = train_setup(mesh.q, params_np)
    graph = gp.shard_graph(host, mesh)
    out = {"runs": {name: run_auto_case(pg, graph, cfg, params, case, mesh)
                    for name, case in cases.items()},
           "capture": {c: capture_wire(pg, graph, cfg, params, *c, mesh)
                       for c in captures}}
    res = train_gnn(tiny_graph(n=N, feat_dim=F), q=mesh.q,
                    **auto_train_kwargs(pg), use_shard_map=True)
    out["train_gnn"] = dataclasses.asdict(res.history)
    every = [None] * mesh.q
    dist.all_gather_object(every, out)
    return every


def auto_train_kwargs(pg) -> dict:
    """``train_gnn``'s arguments of the auto run the worker group is held
    to the emulated backend by."""
    return dict(policy=auto_case_policy("auto:budget:{half:g}:w8", pg),
                epochs=AUTO_STEPS, wire="p2p", device="cpu", hidden=HIDDEN,
                layers=LAYERS, eval_every=1)



def card_auto_step(mesh) -> dict:
    """One p2p ``auto:budget:…:w8`` step on the card through the worker
    backend under :func:`fixed_plan` ``"w8"`` (the tiny graph, seeded
    parameters, the card's default rounding: stochastic), from zero
    error-feedback residuals: loss, the first exchange's new residual
    slab and the codec launches (moved to the CPU)."""
    g = tiny_graph(n=N, feat_dim=F)
    pg = partition_graph(g, mesh.q, seed=0)
    host = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    cfg = tgnn.GNNConfig(conv="sage", in_dim=F, hidden=HIDDEN,
                         out_dim=g.num_classes, layers=LAYERS)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                           device=mesh.device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    opt = optim.sgd(LR)
    step = make_auto_train_step(cfg, CommPolicy.parse("auto:budget:1e9:w8",
                                                      1), opt, meta,
                                mesh=mesh)
    _, _, m, cache = step(params, opt.init(params),
                          gp.shard_graph(host, mesh), prng.key(0),
                          fixed_plan("w8", mesh.q),
                          init_wire_residuals(meta, cfg, mesh.device, mesh))
    return {"loss": float(m["loss"]), "resid": cache[0].cpu(),
            "launches": {fn.__name__: fn.launches for fn in (
                varco_pack_quant_stochastic, varco_unpack_quant)}}


# ---------------------------------------------------------------------------
# Faults, elastic shrink and checkpoints on the worker group
# ---------------------------------------------------------------------------

#: the fault world: the tiny graph cut ``metis-like`` into a shard set,
#: a 2-layer SAGE (the second exchange has two lane-blocks, so rate maps
#: pick kept counts per pair), runs of FAULT_EPOCHS epochs
FAULT_LAYERS, FAULT_EPOCHS = 2, 6
#: drops and latency spikes; the runs add their crash
FAULT_SCHED = dict(q=4, seed=0, drop_rate=0.25, spike_rate=0.05)


def write_fault_shards(root, q: int = 4) -> str:
    """The fault world's shard directory under ``root``."""
    from repro_torch.graph import stream as st

    store = st.write_graph_store(tiny_graph(n=N, feat_dim=F), root / "store")
    st.write_shards(store, st.stream_partition(store, q, "metis-like",
                                               seed=0), root / "shards")
    return str(root / "shards")


def fault_cfg(num_classes: int):
    return tgnn.GNNConfig(conv="sage", in_dim=F, hidden=HIDDEN,
                          out_dim=num_classes, layers=FAULT_LAYERS)


def fault_setup(shard_dir: str, params_np, device="cpu"):
    """Every partition of the shard set, its stacked host arrays, the
    config and the starting parameters (``params_np``: the JAX package's
    initialisation as numpy)."""
    from repro_torch.graph.stream import load_shards

    pg = load_shards(shard_dir)
    return pg, pg.device_arrays("cpu"), fault_cfg(pg.num_classes), \
        tgnn.params_from_jax(params_np, device)


def fault_masks(q: int, seed: int = 7) -> list:
    """Two seeded ``(fskip, dead)`` ladders' masks: every fourth
    off-diagonal pair CACHED, every fifth of the rest DEAD, and at least
    one of each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        u = rng.random((q, q))
        np.fill_diagonal(u, 1.0)
        fskip = (u < 0.25).astype(np.float32)
        dead = ((u >= 0.25) & (u < 0.45)).astype(np.float32)
        fskip[1, 0], dead[0, 1] = 1.0, 1.0
        fskip[0, 1], dead[1, 0] = 0.0, 0.0
        out.append((fskip, dead))
    return out


def random_fcache(meta, cfg, seed: int = 9) -> tuple:
    """A seeded sender-major fault cache (``init_halo_cache`` shapes)."""
    from repro_torch.dist.ratectl import init_halo_cache

    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=tuple(c.shape)).astype(
        np.float32)) for c in init_halo_cache(meta, cfg, "cpu"))


def fault_plan(spec: str, q: int):
    """The step's plan: the policy's uniform rate at epoch 1, or under
    an auto policy a seeded map of rates {1, 2} with every pair at 8
    bits."""
    from repro_torch.dist.ratectl import uniform_plan

    pol = CommPolicy.parse(spec, FAULT_EPOCHS, compressor="blockmask")
    if pol.mode != "auto":
        return uniform_plan(q, float(pol.rate(1)) if pol.compresses else 1.0)
    rng = np.random.default_rng(11)
    rates = rng.choice([1.0, 2.0], (q, q)).astype(np.float32)
    np.fill_diagonal(rates, 1.0)
    widths = np.full((q, q), 8.0, np.float32)
    np.fill_diagonal(widths, 32.0)
    return RatePlan(rates, np.zeros((q, q), np.float32), widths)


def run_fault_case(pg, graph, cfg, params, spec: str, sync: str,
                   mesh=None) -> dict:
    """Two fault steps of ``spec`` from ``params`` under SGD with
    momentum: step 0 under the first :func:`fault_masks` from
    :func:`random_fcache`, step 1 under the second from step 0's
    ``fcache'``; emulated with ``cache=()`` (``mesh=None``, FedAvg at
    ``lr / Q``) or on this worker, from its receiver-major row of the
    cache.  Records per step the loss, the ledger, the pair matrices and
    ``fcache'`` (a worker's ``[1, D, H, F]`` blocks), and the final
    parameters."""
    from repro_torch.dist.faults import (_cache_send_to_recv,
                                         make_fault_train_step)

    meta = gp.DistMeta.build(pg, params, wire="p2p")
    q = meta.q
    pol = CommPolicy.parse(spec, FAULT_EPOCHS, compressor="blockmask")
    opt = optim.sgd(LR / q if mesh is None and sync == "fedavg" else LR,
                    momentum=0.9)
    step = make_fault_train_step(cfg, pol, opt, meta, mesh=mesh, sync=sync)
    fcache = random_fcache(meta, cfg)
    if mesh is not None:
        fcache = tuple(_cache_send_to_recv(c, q)[mesh.rank:mesh.rank + 1]
                       for c in fcache)
    plan, state = fault_plan(spec, q), opt.init(params)
    rec = {k: [] for k in ("loss", "rate", "halo_bits", "transport_bits",
                           "pair_transport", "pair_err", "fcache")}
    for t, (fskip, dead) in enumerate(fault_masks(q)):
        params, state, m, cache, fcache = step(
            params, state, graph, prng.key(t), plan, fskip, dead, (), fcache)
        assert cache == ()
        for k in ("loss", "rate", "halo_bits", "transport_bits",
                  "pair_transport", "pair_err"):
            rec[k].append(_np(m[k]))
        rec["fcache"].append([_np(c) for c in fcache])
    rec["params"] = [_np(t) for t in optim.tree_leaves(params)]
    return rec


def _fault_forward(graph, meta, cfg, params, fskip, dead, fcache, mesh,
                   spec: str = "full"):
    """One forward through the fault channel at full rate: logits, the
    ledger vector and the served caches."""
    pol = CommPolicy.parse(spec, 1)
    rm = np.ones((meta.q, meta.q), np.float32)
    served: list = []
    kw = dict(packed_k=dict(gp._packed_pair_k_for(meta, rm)), rate_map=rm,
              fskip=fskip, fcache=fcache, fcache_out=served, dead=dead)
    if spec == "none":
        kw = {}
    with torch.no_grad():
        agg = gp._make_aggregate_shard(graph, meta, pol, torch.ones(()),
                                       prng.key(3), mesh, **kw)
        logits, bits = tgnn.gnn_forward(params, cfg, graph["features"], agg)
    return logits, bits.numpy().astype(np.float64), tuple(served)


def fault_identities(pg, graph, cfg, params, mesh) -> dict:
    """On this worker: a fresh forward; the same forward with pair
    (2 <- 0) CACHED from the fresh forward's served cache (logits and
    served blocks bitwise, the pair charged nothing); every off-diagonal
    pair DEAD against the No-Comm forward."""
    from repro_torch.dist.ratectl import init_halo_cache

    meta = gp.DistMeta.build(pg, params, wire="p2p")
    q, lq2 = meta.q, FAULT_LAYERS * meta.q * meta.q
    zeros = np.zeros((q, q), np.float32)
    cold = init_halo_cache(meta, cfg, "cpu", mesh)
    l0, b0, fresh = _fault_forward(graph, meta, cfg, params, zeros, zeros,
                                   cold, mesh)
    fskip = zeros.copy()
    fskip[2, 0] = 1.0
    l1, b1, served = _fault_forward(graph, meta, cfg, params, fskip, zeros,
                                    fresh, mesh)
    dead = 1.0 - np.eye(q, dtype=np.float32)
    ld, bd, _ = _fault_forward(graph, meta, cfg, params, zeros, dead, cold,
                               mesh)
    liso, _, _ = _fault_forward(graph, meta, cfg, params, None, None, None,
                                mesh, spec="none")
    t0 = b0[2:2 + lq2].reshape(FAULT_LAYERS, q, q)
    t1 = b1[2:2 + lq2].reshape(FAULT_LAYERS, q, q)
    return {"cached_logits_equal": torch.equal(l0, l1),
            "served_equal": all(torch.equal(a, b)
                                for a, b in zip(served, fresh)),
            "fresh_pair_bits": float(t0[:, 2, 0].sum()),
            "cached_pair_bits": float(t1[:, 2, 0].sum()),
            "transport_drop": float(b0[1] - b1[1]),
            "dead_vs_none": float((ld - liso).abs().max()),
            "dead_bits": (float(bd[0]), float(bd[1]))}


def fault_train_kwargs(params_np, spec: str, crashes: tuple,
                       max_stale: int) -> dict:
    """``train_gnn``'s arguments of a faulted run of the fault world
    (AdamW, every epoch logged): ``spec`` under :data:`FAULT_SCHED` with
    the ``crashes``, ``(epoch, worker)`` events."""
    from repro_torch.dist.faults import FaultSchedule

    return dict(policy=CommPolicy.parse(spec, FAULT_EPOCHS,
                                        compressor="blockmask"),
                epochs=FAULT_EPOCHS, wire="p2p", device="cpu",
                hidden=HIDDEN, layers=FAULT_LAYERS, eval_every=1,
                faults=FaultSchedule(**FAULT_SCHED, crash_at=crashes),
                fault_max_stale=max_stale,
                params=tgnn.params_from_jax(params_np, "cpu"))


def run_record(res) -> dict | None:
    """What a ``train_gnn`` call left this process: ``None`` on a worker
    that crashed, else the history, the final Q and parameters."""
    if res is None:
        return None
    return {"history": dataclasses.asdict(res.history), "q": res.meta.q,
            "params": [_np(t) for t in optim.tree_leaves(res.params)]}


def fault_group_cases(mesh, shard_dir: str, params_np, steps: dict,
                      runs: dict) -> list:
    """Every fault-step case ``name -> (spec, sync)`` on this worker
    (:func:`run_fault_case`), the fault identities, and each faulted
    ``train_gnn(use_shard_map=True)`` run ``name -> (spec, crashes,
    max_stale)`` on the group already running; every worker's records
    gathered."""
    pg, host, cfg, params = fault_setup(shard_dir, params_np)
    graph = gp.shard_graph(host, mesh)
    out = {"steps": {name: run_fault_case(pg, graph, cfg, params, *case,
                                          mesh=mesh)
                     for name, case in steps.items()},
           "ident": fault_identities(pg, graph, cfg, params, mesh),
           "runs": {}}
    for name, (spec, crashes, max_stale) in runs.items():
        res = train_gnn(shard_dir, use_shard_map=True,
                        **fault_train_kwargs(params_np, spec, crashes,
                                             max_stale))
        out["runs"][name] = run_record(res)
    out["slow"] = slow_crash_run(shard_dir, params_np)
    # every subgroup a shrink created is gone again: only the job's remains
    out["groups_left"] = len(dist.distributed_c10d._world.pg_map)
    every = [None] * mesh.q
    dist.all_gather_object(every, out)
    return every


#: the job's per-operation timeout during :func:`slow_crash_run`, and the
#: seconds every optimiser update sleeps there
SLOW_TIMEOUT_S, SLOW_PAUSE_S = 2.0, 1.0


def slow_crash_run(shard_dir: str, params_np) -> dict | None:
    """A faulted ``varco`` run with worker 1 crashing at epoch 1 whose
    later epochs outlast the job's per-operation timeout (cut to
    :data:`SLOW_TIMEOUT_S` for the run; every optimiser update sleeps
    :data:`SLOW_PAUSE_S`): the crashed worker must wait out the run
    without a timed operation."""
    import datetime
    import time

    from torch.distributed import distributed_c10d as c10d

    base = optim.adamw(5e-3)

    def update(grads, state, params):
        time.sleep(SLOW_PAUSE_S)
        return base.update(grads, state, params)

    default = c10d._get_default_group()
    was = default._get_backend(torch.device("cpu")).options._timeout
    c10d._set_pg_timeout(datetime.timedelta(seconds=SLOW_TIMEOUT_S))
    try:
        res = train_gnn(shard_dir, use_shard_map=True,
                        optimizer=optim.Optimizer(base.init, update),
                        **fault_train_kwargs(params_np, "varco:linear:5",
                                             ((1, 1),), 2))
    finally:
        c10d._set_pg_timeout(was)
    return run_record(res)


def resume_kwargs(params_np, spec: str, faulted: bool) -> dict:
    """``train_gnn``'s arguments of the resume tests' runs: ``spec`` over
    the fault world, under :data:`FAULT_SCHED` with worker 1 crashing at
    epoch 3 when ``faulted``."""
    kw = fault_train_kwargs(params_np, spec, ((3, 1),), 2)
    if not faulted:
        del kw["faults"], kw["fault_max_stale"]
    return kw


def resume_group_cases(mesh, shard_dir: str, ck_root: str, params_np,
                       runs: dict) -> list:
    """On the group already running, for each run ``name -> (spec,
    faulted, stops)``: the uninterrupted run, and for each ``stop`` in
    ``stops`` the run stopped after ``stop`` epochs into
    ``ck_root/<name>_<stop>`` then, when the checkpoint's live workers
    are this group's, resumed from it.  A resume the group cannot serve
    (the checkpoint of a run that shrank) records its ``ValueError``;
    every worker's records gathered."""
    import os

    from repro_torch.train import checkpoint as ckpt

    out = {}
    for name, (spec, faulted, stops) in runs.items():
        kw = resume_kwargs(params_np, spec, faulted)
        rec = {"whole": run_record(train_gnn(shard_dir, use_shard_map=True,
                                             **kw))}
        for stop in stops:
            ck = os.path.join(ck_root, f"{name}_{stop}")
            rec[f"stop{stop}"] = run_record(train_gnn(
                shard_dir, use_shard_map=True, checkpoint_dir=ck,
                stop_after=stop, **kw))
            alive = ckpt.peek(ckpt.latest_checkpoint(ck)).get("alive")
            try:
                rec[f"resume{stop}"] = run_record(train_gnn(
                    shard_dir, use_shard_map=True, checkpoint_dir=ck,
                    resume=True, **kw))
            except ValueError as err:
                assert alive is not None and len(alive) < mesh.q
                rec[f"resume{stop}"] = str(err)
        out[name] = rec
    every = [None] * mesh.q
    dist.all_gather_object(every, out)
    return every


def card_fault_step(mesh, spec: str = "varco:linear:5") -> dict:
    """One p2p fault step of ``spec`` on the card through the worker
    backend (the tiny graph cut into ``mesh.q``, a 2-layer SAGE, seeded
    parameters) under the first :func:`fault_masks`, from this worker's
    row of :func:`random_fcache`: loss, the served cache blocks and the
    kernels' launches (moved to the CPU)."""
    from repro_torch.dist.faults import (_cache_send_to_recv,
                                         make_fault_train_step)

    g = tiny_graph(n=N, feat_dim=F)
    pg = partition_graph(g, mesh.q, seed=0)
    host = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    cfg = fault_cfg(g.num_classes)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                           device=mesh.device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    opt = optim.sgd(LR)
    step = make_fault_train_step(cfg, CommPolicy.parse(
        spec, FAULT_EPOCHS, compressor="blockmask"), opt, meta, mesh=mesh)
    fcache = tuple(_cache_send_to_recv(c, mesh.q)[mesh.rank:mesh.rank + 1]
                   .to(mesh.device) for c in random_fcache(meta, cfg))
    fskip, dead = fault_masks(mesh.q)[0]
    _, _, m, _, served = step(params, opt.init(params),
                              gp.shard_graph(host, mesh), prng.key(0),
                              fault_plan(spec, mesh.q), fskip, dead, (),
                              fcache)
    return {"loss": float(m["loss"]), "fcache": [c.cpu() for c in served],
            "launches": {fn.__name__: fn.launches for fn in (
                ell_spmm, varco_pack, varco_unpack)}}


# ---------------------------------------------------------------------------
# VARCO data-parallel LM training on the worker group
# ---------------------------------------------------------------------------

#: the LM cases' global batch, sequence, steps, and first step key
LM_BATCH, LM_SEQ, LM_STEPS, LM_KEY = 8, 32, 3, 21


def lm_setup(arch: str, device="cpu", dtype: str | None = None):
    """``arch``'s smoke config (f32, or ``dtype`` for its weights and
    activations), its seeded port weights and one seeded ``[B, S]`` token
    batch per step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_lm

    cfg = get_config(arch, smoke=True)
    if dtype is not None:
        cfg = cfg.with_(param_dtype=dtype, activ_dtype=dtype)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    toks = np.random.default_rng(LM_KEY).integers(
        0, cfg.vocab_size, (LM_STEPS, LM_BATCH, LM_SEQ)).astype(np.int64)
    return cfg, params, toks


@contextlib.contextmanager
def recorded_compression(rec: list):
    """Every worker's compressed leaves, as ``(worker, [leaf, ...])`` in
    call order, while the context is open: a recorder around
    ``collectives._compress_leaves``, which both meshes call."""
    orig = col._compress_leaves

    def recorder(leaves, worker, **kw):
        bits = orig(leaves, worker, **kw)
        rec.append((worker, [t.detach().cpu().clone() for t in leaves]))
        return bits

    col._compress_leaves = recorder
    try:
        yield
    finally:
        col._compress_leaves = orig


def _flat(tree) -> torch.Tensor:
    """Every leaf's values as one f32 vector on the CPU (the optimiser's
    step count lives there whatever the weights' device)."""
    return torch.cat([t.detach().reshape(-1).float().cpu()
                      for t in optim.tree_leaves(tree)])


def run_lm_dp(cfg, params, toks, comm: str, mesh, device="cpu",
              opt=None) -> list:
    """One step per ``toks`` batch of ``make_varco_dp_train_step`` (``opt``,
    SGD lr 1 by default) over ``mesh`` (a ``DPMesh`` or this worker's
    ``WorkerMesh``), step key
    ``prng.key(LM_KEY + i)``: per step the metrics, every worker's
    compressed leaves (``{worker: [leaf, ...]}``; gathered over a group),
    the parameters and, over a group, whether every rank holds the same
    parameters and optimiser state bitwise."""
    from repro_torch.dist.grad_compress import make_varco_dp_train_step

    opt = optim.sgd(1.0) if opt is None else opt
    step = make_varco_dp_train_step(cfg, opt, CommPolicy.parse(comm, 10),
                                    mesh)
    state = opt.init(params)
    group = isinstance(mesh, col.WorkerMesh)
    out = []
    for i in range(len(toks)):
        rec: list = []
        batch = {"tokens": torch.from_numpy(toks[i]).to(device)}
        with recorded_compression(rec):
            params, state, m = step(params, state, batch, i,
                                    prng.key(LM_KEY + i))
        comp = dict(rec)
        if group and rec:
            (w, leaves), = rec
            comp = {r: [] for r in range(mesh.q)}
            for t in leaves:
                for r, part in enumerate(mesh.all_gather(t)):
                    comp[r].append(part.cpu())
        row = {"metrics": {k: float(v) for k, v in m.items()},
               "compressed": comp,
               "params": [t.detach().cpu().clone()
                          for t in optim.tree_leaves(params)]}
        if group:
            every = mesh.all_gather(torch.cat([_flat(params),
                                               _flat(state)]))
            row["replicas_equal"] = all(torch.equal(every[0], e)
                                        for e in every[1:])
        out.append(row)
    return out


def run_bf16_adamw(comm: str, mesh) -> list:
    """:func:`run_lm_dp` of granite's smoke config in bf16 under AdamW
    (``make_optimizer``, lr 3e-4)."""
    from repro_torch.launch.steps import make_optimizer

    cfg, params, toks = lm_setup("granite-3-2b", dtype="bfloat16")
    return run_lm_dp(cfg, params, toks, comm, mesh,
                     opt=make_optimizer(cfg, lr=3e-4))


def lm_dp_cases(mesh, cases: dict, jax_case: dict,
                bf16_cases: dict) -> dict | None:
    """Every ``(arch, comm)`` case of ``cases`` through
    :func:`run_lm_dp` on the group, and every comm of ``bf16_cases``
    through :func:`run_bf16_adamw`; ``jax_case`` is one step from the JAX
    package's weights (``params_np``, ``tokens``, ``comm``, ``key``);
    ``train_lm`` under each of ``jax_case["train_comms"]`` on the group
    (smoke, ``LM_STEPS`` steps).  Rank 0 returns the records."""
    from repro_torch.dist.grad_compress import make_varco_dp_train_step
    from repro_torch.launch.train import train_lm
    from repro_torch.models import lm_params_from_jax

    out = {}
    for name, (arch, comm) in cases.items():
        cfg, params, toks = lm_setup(arch)
        out[name] = run_lm_dp(cfg, params, toks, comm, mesh)
    for name, comm in bf16_cases.items():
        out[name] = run_bf16_adamw(comm, mesh)
    cfg, _, _ = lm_setup(jax_case["arch"])
    params = lm_params_from_jax(jax_case["params_np"], "cpu")
    opt = optim.sgd(1.0)
    step = make_varco_dp_train_step(
        cfg, opt, CommPolicy.parse(jax_case["comm"], 40), mesh)
    new, _, m = step(params, opt.init(params),
                     {"tokens": torch.from_numpy(jax_case["tokens"])}, 0,
                     prng.key(jax_case["key"]))
    out["jax"] = {"metrics": {k: float(v) for k, v in m.items()},
                  "delta": [(a - b).numpy() for a, b in zip(
                      optim.tree_leaves(params), optim.tree_leaves(new))]}
    for comm in jax_case["train_comms"]:
        _, _, hist = train_lm(jax_case["arch"], smoke=True, steps=LM_STEPS,
                              batch=LM_BATCH, seq=LM_SEQ, comm=comm,
                              mesh=mesh, log=None)
        out[f"train_lm:{comm}"] = hist
    return out if mesh.rank == 0 else None


def card_lm_dp_step(mesh, comm: str = "varco:linear:5") -> dict | None:
    """One step of granite's smoke config (f32) through the group's
    ``make_varco_dp_train_step`` on the card: metrics, the parameters
    (moved to the CPU), whether the replicas are equal, and the bf16 /
    f32 ``random_mask`` launches of this worker."""
    from repro_torch.kernels.randmask import random_mask

    cfg, params, toks = lm_setup("granite-3-2b", device=mesh.device)
    random_mask.launches = random_mask.bf16_launches = 0
    rows = run_lm_dp(cfg, params, toks[:1], comm, mesh, mesh.device)
    launches = {"random_mask": random_mask.launches,
                "random_mask_bf16": random_mask.bf16_launches}
    every = [None] * mesh.q
    dist.all_gather_object(every, launches)
    row = rows[0]
    return None if mesh.rank else {
        "metrics": row["metrics"], "params": row["params"],
        "replicas_equal": row["replicas_equal"], "launches": every}


# ---------------------------------------------------------------------------
# The sharded MoE on a 2 x 2 (data, model) DTensor mesh
# ---------------------------------------------------------------------------

#: the sharded MoE cases' mesh: its shape and axis names (4 ranks)
MOE_MESH = ((2, 2), ("data", "model"))


@contextlib.contextmanager
def recorded_choices(rec: list):
    """Append each MoE layer's top-k expert indices to ``rec`` as this
    rank's ``route`` computes them (on a mesh: its own tokens' rows)."""
    from repro_torch.models import moe

    route = moe.route

    def wrapped(params, m, xt):
        out = route(params, m, xt)
        rec.append(out[2].detach().clone())
        return out

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route


def _whole(t):
    """A ``DTensor`` gathered into one plain tensor (a collective: every
    rank calls it), a plain tensor as it is."""
    from repro_torch.layout import _is_dtensor

    return t.full_tensor() if _is_dtensor(t) else t


def moe_case_config(case: dict):
    """``case["arch"]``'s smoke config (f32), with the case's MoE
    capacity factor where it names one."""
    from repro_torch.configs.base import get_config

    cfg = get_config(case["arch"], smoke=True)
    if case.get("capacity_factor"):
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["capacity_factor"]))
    return cfg


def run_moe_case(case: dict, mesh, place) -> dict:
    """One sharded-MoE case inside ``mesh``'s ``activation_sharding``
    context, every tensor laid out by ``place(tensor, spec)``: the
    parameters by ``param_spec``, the tokens by ``batch_spec`` (a batch-1
    prompt by the dry run's ``batch_rule``), the MoE input as the model's
    residual stream.  ``place`` distributes on a ``DeviceMesh`` and is
    the identity for the plain run (``mesh`` then an ``AbstractMesh``).

    ``case["kind"]``: ``"ffn"`` — the first MoE layer's FFN on
    ``case["x"]``; ``"lm"`` — the training forward, ``lm_loss`` and its
    gradients on ``case["tokens"]``; ``"decode"`` — prefill of
    ``case["prompt"]`` on plain tensors, its cache laid out by the dry
    run's ``cache_rule``, then one decode step of ``case["next"]``.
    Returns plain tensors, and ``choices``: the expert indices each
    ``route`` call saw, in call order (this rank's rows on a mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist.sharding import (activation_sharding, batch_spec,
                                           data_axes, param_spec,
                                           tree_paths)
    from repro_torch.launch.dryrun import _cache_map, batch_rule, cache_rule
    from repro_torch.launch.steps import loss_and_grads, make_decode_step
    from repro_torch.models import lm_params_from_jax
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import (forward_train, lm_loss,
                                                prefill)

    cfg = moe_case_config(case)
    plain = lm_params_from_jax(case["params_np"], "cpu")
    paths = iter(tree_paths(plain))
    params = optim.tree_map(lambda t: place(t, param_spec(
        next(paths)[0], tuple(t.shape), mesh)), plain)
    rec: list = []
    out: dict = {}
    with activation_sharding(mesh), implicit_replication():
        if case["kind"] == "ffn":
            pi = next(i for i in range(len(cfg.pattern))
                      if cfg.layer_uses_moe(i))
            lp = optim.tree_map(lambda t: t[0], params["blocks"])[
                f"p{pi}_{cfg.pattern[pi]}"]["moe"]
            x = place(torch.from_numpy(case["x"]),
                      (data_axes(mesh), ("model",), None))
            with recorded_choices(rec):
                y, aux = moe_ffn(lp, cfg, x)
            out = {"out": _whole(y), "aux": _whole(aux)}
        elif case["kind"] == "lm":
            batch = {"tokens": place(torch.from_numpy(case["tokens"]),
                                     batch_spec(mesh) + (None,))}
            with recorded_choices(rec):
                h, _ = forward_train(params, cfg, batch)
            loss, parts = lm_loss(params, cfg, batch)
            _, _, grads = loss_and_grads(params, cfg, batch)
            out = {"hidden": _whole(h), "loss": _whole(loss),
                   "ce": _whole(parts["ce"]),
                   "moe_aux": _whole(parts["moe_aux"]),
                   "grads": [_whole(g) for g in optim.tree_leaves(grads)]}
        else:
            prompt = torch.from_numpy(case["prompt"])
            _, cache = prefill(plain, cfg, {"tokens": prompt},
                               max_len=prompt.shape[1] + 4)
            cache = _cache_map(cache, lambda t: place(
                t, cache_rule(tuple(t.shape), mesh)))
            nxt = torch.from_numpy(case["next"])
            with recorded_choices(rec):
                tok, logits, _ = make_decode_step(cfg)(
                    params, {"tokens": place(nxt, batch_rule(
                        tuple(nxt.shape), mesh))}, cache)
            out = {"token": _whole(tok), "logits": _whole(logits)}
    out["choices"] = rec
    return out


def moe_sharded_cases(group, cases: dict) -> dict | None:
    """Every case of ``cases`` through :func:`run_moe_case` on a 2 × 2
    ``DeviceMesh`` over the group's 4 ranks, the tensors distributed as
    the rules place them.  Rank 0 returns each case's outputs and every
    rank's ``(mesh coordinate, choices)``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import placements

    shape, names = MOE_MESH
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)

    def place(t, spec):
        return distribute_tensor(t, mesh, placements(spec, mesh))

    res = {}
    for name, case in cases.items():
        out = run_moe_case(case, mesh, place)
        every = [None] * group.q
        dist.all_gather_object(every, (tuple(mesh.get_coordinate()),
                                       out.pop("choices")))
        res[name] = dict(out, choices=every)
    return res if group.rank == 0 else None

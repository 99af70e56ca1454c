"""Worker functions of the worker-backend tests: each runs in every
process of a group started by ``repro_torch.dist.gnn_parallel.
spawn_workers`` and returns what the test compares (gathered to rank 0).

This module imports neither JAX nor the JAX package, so the spawned
workers start quickly and the card's test file can use it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core import collectives as col
from repro_torch.core.compression import get_compressor
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as gp
from repro_torch.dist.halo import attach_p2p
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.kernels.ell_spmm import ell_spmm
from repro_torch.kernels.varco_pack import varco_pack, varco_unpack
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim

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

"""Multi-pod dry run: trace every (arch × shape) at full size on a fake
256- or 512-rank mesh — counterpart of ``repro/launch/dryrun.py``.

For each combination this starts a ``"fake"`` process group (every
collective returns at once, nothing crosses a wire), builds the
production mesh on ``"cpu"``, initialises the full-size config under
``FakeTensorMode`` and carries it to the ``meta`` device (shapes and
dtypes only, no storage), places the
parameters, the AdamW state, the batch and the caches as DTensors under
the sharding rules (:mod:`repro_torch.dist.sharding`), and runs the
train, prefill or decode step once under
:func:`~repro_torch.dist.sharding.activation_sharding`, with a collective
counter (:class:`repro_torch.launch.comm_analysis.CollectiveCounter`)
and a per-rank FLOP counter active.  It records, per device (rank 0):

* ``memory.argument_bytes`` — exact: the bytes of rank 0's local shards
  of every argument;
* ``memory.peak_bytes`` — ``torch.distributed._tools.mem_tracker.
  MemTracker``'s peak over the step (it tracks meta storages), the
  arguments' local shards counted as resident;
* ``cost.flops`` — rank 0's local FLOPs (``torch.utils.flop_counter``'s
  formulas over the local ops DTensor runs);
* ``collectives`` — the ring-model bytes of every collective DTensor
  issued (``comm_analysis``);
* ``analytic`` — :func:`repro_torch.launch.analytic.estimate`;
* ``roofline`` — the analytic compute and memory terms and the counted
  collective bytes against the H100 datasheet constants
  (:data:`repro_torch.launch.mesh.HW`); ``model_flops_global`` and
  ``useful_flop_ratio``

into ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.  These
are arithmetic over a fake mesh with datasheet constants, not
measurements.  As in the JAX package's ``run_one``, a combination that
raises (an op without a DTensor sharding rule, say) is recorded with
``ok: false`` and its error, and the sweep goes on.

Where the plain tensors the model makes (positions, masks, zeros) meet
DTensors, the step runs under DTensor's ``implicit_replication()``: the
plain tensor counts as replicated on every rank, which is what it is.
DTensor on a ``"cpu"`` mesh turns a Shard-to-Shard redistribution
(an all-to-all) into an all-gather and a local chunk, so such moves are
counted as all-gathers of the whole dim.

The tensors are ``meta`` tensors rather than ``FakeTensorMode``'s: DTensor
computes the layout of a strided shard (a flattened ``[B, S]`` whose
``S`` is sharded) from an index tensor it builds with ``torch.arange``
and reads back with ``tolist()``, which fails inside ``FakeTensorMode``.
DTensor still infers each op's global output shape on fake tensors of
its own; those runs are not counted.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch granite-3-2b --shape train_4k [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.dist.sharding import (activation_sharding, cache_spec,
                                       data_axes, param_shardings,
                                       placements)
from repro_torch.launch import analytic
from repro_torch.launch.comm_analysis import CollectiveCounter
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.shapes import (SHAPES, InputShape, batch_specs,
                                       long_context_variant)
from repro_torch.train.optim import tree_map

OUT = "experiments/dryrun_torch"


# ---------------------------------------------------------------------------
# The fake world and the per-rank FLOP count
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_process_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks (this process
    is rank 0), destroyed on exit; an initialised group of that size is
    used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"ranks is initialised; the mesh needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class LocalFlops(TorchDispatchMode):
    """FLOPs of the ops this rank runs: the local ops a DTensor op
    becomes (the DTensor-level op itself, of global shape, is handed on
    uncounted), by ``torch.utils.flop_counter``'s formulas."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        # DTensor's global-shape inference runs on fake tensors: skipped
        if count is not None and not any(t is FakeTensor for t in types):
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


# ---------------------------------------------------------------------------
# Placement under the rules
# ---------------------------------------------------------------------------


def _place(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))


def _place_tree(tree, specs, mesh, place=_place):
    """Every leaf of ``tree`` through ``place(leaf, spec, mesh)`` with its
    spec in ``specs`` (:func:`param_shardings`' tree of specs)."""
    leaves = iter(_spec_leaves(specs))
    return tree_map(lambda t: place(t, next(leaves), mesh), tree)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a
    tuple, so the generic walk would descend into it)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def batch_rule(shape, mesh) -> tuple:
    """The JAX dry run's batch layout: the batch dim (dim 1 of a ``[3, B,
    S]`` M-RoPE id array, else dim 0) over the data axes when it
    divides, else the sequence (context parallelism at batch 1)."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
    bdim = 1 if tuple(shape[:1]) == (3,) and len(shape) == 3 else 0
    spec = [None] * len(shape)
    if shape[bdim] % dsize == 0 and dsize > 1:
        spec[bdim] = daxes
    elif len(shape) > bdim + 1 and shape[bdim + 1] % dsize == 0:
        spec[bdim + 1] = daxes
    return tuple(spec)


def cache_rule(shape, mesh) -> tuple:
    """The JAX dry run's cache layout by rank: ``[nb, B, W, KV, D]`` K/V
    (and the SSM state) batch, sequence and heads; ``[nb, B, W]``
    positions batch and sequence; scalars replicated; the rest batch."""
    if len(shape) >= 4:
        five = len(shape) == 5
        return cache_spec(shape, mesh, batch_dim=1,
                          seq_dim=2 if five else None,
                          head_dim=3 if five else None)
    if len(shape) == 3:
        return cache_spec(shape, mesh, batch_dim=1, seq_dim=2)
    if len(shape) == 0:
        return ()
    return cache_spec(shape, mesh, batch_dim=1)


def _cache_map(cache, fn):
    """``fn`` over every tensor of a ``Cache`` (its index kept)."""
    layers = tuple(type(c)(*(fn(t) for t in c)) for c in cache.layers)
    return type(cache)(layers, cache.index)


def _meta_batch(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """The model inputs as ``meta`` DTensors under :func:`batch_rule`."""
    return {k: _place(torch.zeros(v.shape, dtype=v.dtype, device="meta"),
                      batch_rule(tuple(v.shape), mesh), mesh)
            for k, v in batch_specs(cfg, shape).items()}


def build_dryrun(cfg: ArchConfig, shape: InputShape, mesh,
                 lr: float = 3e-4):
    """``(step, args, cfg used)``: the step of ``shape``'s kind over
    full-size ``meta`` DTensor arguments placed under the rules.  Call on
    a process group of the mesh's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.steps import (make_decode_step, make_optimizer,
                                          make_train_step)
    from repro_torch.models.transformer import init_cache, init_lm, prefill

    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    with FakeTensorMode():          # the seeded init, without storage
        fake = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    plain = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device="meta"), fake)
    del fake
    params = _place_tree(plain, param_shardings(plain, mesh), mesh)
    batch = _meta_batch(cfg, shape, mesh)

    if shape.kind == "train":
        opt = make_optimizer(cfg, lr)
        state = opt.init(plain)
        del plain
        state = _place_tree(state, param_shardings(state, mesh), mesh)
        step = make_train_step(cfg, opt)
        p_specs = param_shardings(params, mesh)
        s_specs = param_shardings(state, mesh)

        def train(params, state, batch):
            params, state, metrics = step(params, state, batch)
            # the JAX dry run's out_shardings
            return (_place_tree(params, p_specs, mesh, _redistribute),
                    _place_tree(state, s_specs, mesh, _redistribute),
                    metrics)

        return train, (params, state, batch), cfg
    del plain

    def to_rule(t):
        return t.redistribute(t.device_mesh, placements(
            cache_rule(tuple(t.shape), mesh), mesh))

    if shape.kind == "prefill":
        def pre(params, batch):
            logits, cache = prefill(params, cfg, batch)
            return logits, _cache_map(cache, to_rule)

        return pre, (params, batch), cfg

    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       device="meta")
    cache = _cache_map(cache, lambda t: _place(
        t, cache_rule(tuple(t.shape), mesh), mesh))
    return make_decode_step(cfg), (params, batch, cache), cfg


def _redistribute(t, spec, mesh):
    return t.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _leaves(x) -> list:
    """Every tensor of a nest of dicts, lists, tuples and named tuples,
    DTensors as their local shards."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return [x.to_local()]
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _traced(fn, args, mesh) -> dict:
    """Run ``fn(*args)`` once under the rules' context, the collective
    and FLOP counters and ``MemTracker`` (the arguments' local shards
    registered as already resident)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    tracker = MemTracker()
    tracker.track_external(*_leaves(args))
    with activation_sharding(mesh), implicit_replication(), tracker, \
            CollectiveCounter() as comm, LocalFlops() as flops:
        fn(*args)
    peak = tracker.get_tracker_snapshot("peak")
    return {"peak": max((int(v["Total"]) for v in peak.values()),
                        default=0),
            "collectives": comm.summary(), "flops": flops.flops}


def record(cfg: ArchConfig, shape: InputShape, mesh, n_chips: int) -> dict:
    """The dry run's fields of one combination (raises where the step
    does); call on a fake process group of ``n_chips`` ranks."""
    rec: dict = {}
    t0 = time.time()
    fn, args, cfg_used = build_dryrun(cfg, shape, mesh)
    rec["build_s"] = round(time.time() - t0, 1)
    arg_bytes = sum(t.numel() * t.element_size() for t in _leaves(args))
    t1 = time.time()
    traced = _traced(fn, args, mesh)
    rec["trace_s"] = round(time.time() - t1, 1)
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "peak_bytes": traced["peak"]}
    rec["cost"] = {"flops": traced["flops"]}
    rec["collectives"] = traced["collectives"]
    est = analytic.estimate(cfg_used, shape, n_chips)
    rec["analytic"] = {"flops_global": est.flops_global,
                       "hbm_bytes_per_dev": est.hbm_bytes_per_dev,
                       "param_bytes_per_dev": est.param_bytes_per_dev,
                       **est.detail}
    rec["roofline"] = {
        "compute_s": est.flops_global / n_chips / HW["peak_flops_bf16"],
        "memory_s": est.hbm_bytes_per_dev / HW["hbm_bw"],
        "collective_s": rec["collectives"]["bytes"] / HW["link_bw"]}
    rec["roofline"]["dominant"] = max(rec["roofline"],
                                      key=rec["roofline"].get)
    rec["roofline"]["hw"] = HW["card"]
    counts = cfg_used.param_counts()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model_flops = (6.0 if shape.kind == "train" else 2.0) \
        * counts["active"] * tokens
    rec["model_flops_global"] = model_flops
    rec["useful_flop_ratio"] = model_flops / est.flops_global
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: str = OUT) -> dict:
    """One combination on the production mesh (256 or 512 fake ranks),
    recorded to ``out_dir`` whether it ran or raised."""
    n_chips = 512 if multi_pod else 256
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": n_chips, "kind": shape.kind}
    t0 = time.time()
    try:
        with fake_process_group(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            rec.update(record(get_config(arch), shape, mesh, n_chips))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    for arch in archs:
        for shp in shapes:
            rec = run_one(arch, shp, args.multi_pod, args.out)
            mem = rec.get("memory") or {}
            print(json.dumps({k: rec.get(k) for k in (
                "arch", "shape", "mesh", "ok", "error", "total_s")} | {
                "argument_gb": (mem.get("argument_bytes") or 0) / 1e9,
                "dominant": (rec.get("roofline") or {}).get("dominant")}),
                flush=True)


if __name__ == "__main__":
    main()

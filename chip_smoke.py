#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # the full-size serving slice
    python3 chip_smoke.py --nodes 20000   # a quicker, smaller graph

Phases, each fatal on failure (exit code 1, no result line):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
   and power limit (``nvidia-smi``) and turns TF32 off for matmuls and
   cuDNN.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch/
   csrc`` with ``nvcc`` (one process per source, in parallel) and prints
   the build seconds and the compiler's register/spill report.
3. setup   — the OGBN-Arxiv analogue ``citation_graph(n=169_343,
   feat_dim=128)``, cut ``metis-like`` into Q = 4 partitions stacked on the
   card, and a ``ServingEngine`` over GraphSAGE at the paper's width (in
   128, hidden 256, out 40, 3 layers) with weights from a seeded
   ``torch.Generator``.
4. kernels — each kernel at the slice's shapes and at a ragged shape,
   against its plain PyTorch version on the same inputs (pack/unpack
   bitwise, ELL within 1e-5: FMA contraction reorders f32 sums), with
   CUDA-event times of the kernel, the plain version and one PyTorch
   library call where one computes the same function, beside the least
   time the card could take (bytes over 3.35 TB/s, flops over 67 TFLOP/s
   f32).
5. slice   — launch counts set to 0, then the main path: ``refresh(force=
   True)``, a few hundred node and edge queries through ``submit``/
   ``flush``, and three non-forced ``refresh()`` calls under the default
   ``auto:qos:<bits>:w8`` policy with queries between them; launch counts
   read right after (each kernel must have run).  The ``FRESH`` answers of
   the cold refresh must match ``centralized_forward`` on the card within
   1e-4 (atomic scatter-adds and FMA contraction reorder f32 sums).

The line before the last is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
ELL_TOL = 1e-5
FRESH_TOL = 1e-4

KERNELS = {
    "ell_spmm": {"source": "src/repro_torch/csrc/ell_spmm.cu",
                 "replaces": "src/repro/kernels/ell_spmm.py:78"},
    "varco_pack": {"source": "src/repro_torch/csrc/varco_pack.cu",
                   "replaces": "src/repro/kernels/varco_pack.py:66"},
    "varco_unpack": {"source": "src/repro_torch/csrc/varco_pack.cu",
                     "replaces": "src/repro/kernels/varco_pack.py:256"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_phase():
    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is False: this smoke run "
                      "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}", flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return card


def build_phase():
    from repro_torch.kernels import _build

    res = _build.build()
    ptxas = [ln.strip() for log in res["log"].values()
             for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": res["seconds"],
          "built": sorted(res["log"]), "ptxas": ptxas})


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _ell_case(name, x, nbr, w, reps):
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_plain

    out = ell_spmm(x, nbr, w)
    ref = ell_spmm_plain(x, nbr, w)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    check(err <= ELL_TOL, f"ell_spmm {name}: max abs err {err} > {ELL_TOL}")
    q, n_src, f = x.shape
    _, n_dst, k = nbr.shape
    valid = w != 0
    nnz = int(valid.sum())
    rows = int(torch.unique(nbr[valid].long() +
                            (torch.arange(q, device=x.device) * n_src)
                            [:, None, None].expand_as(nbr)[valid]).numel())
    # library yardstick: one cuSPARSE CSR product over the block-diagonal
    # [Q·Nd, Q·Ns] operator (built outside the timing)
    dst = torch.arange(q * n_dst, device=x.device)[:, None].expand(-1, k)
    src = nbr.long() + (torch.arange(q, device=x.device) * n_src)[:, None,
                                                                 None]
    coo = torch.sparse_coo_tensor(
        torch.stack([dst.reshape(q * n_dst, k)[valid.reshape(-1, k)],
                     src.reshape(q * n_dst, k)[valid.reshape(-1, k)]]),
        w[valid], (q * n_dst, q * n_src)).coalesce()
    csr = coo.to_sparse_csr()
    x2 = x.reshape(q * n_src, f)
    lib_err = float((torch.sparse.mm(csr, x2).reshape(q, n_dst, f) -
                     ref).abs().max())
    b_ms, b_by = bound_ms(rows * f * 4 + 2 * nbr.numel() * 4 +
                          q * n_dst * f * 4, 2.0 * nnz * f)
    rec = {"kernel": "ell_spmm", "case": name,
           "shape": {"x": list(x.shape), "nbr": list(nbr.shape)},
           "nnz": nnz, "max_abs_err": err, "library_max_abs_err": lib_err,
           "kernel_ms": cuda_ms(lambda: ell_spmm(x, nbr, w), reps),
           "plain_ms": cuda_ms(lambda: ell_spmm_plain(x, nbr, w),
                               max(reps // 5, 1)),
           "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, x2), reps),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _pack_case(name, x, kept, reps):
    from repro_torch.kernels.varco_pack import (LANE, varco_pack,
                                                varco_pack_plain)

    out = varco_pack(x, kept)
    ref = varco_pack_plain(x, kept)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"varco_pack {name}: not bitwise equal")
    q, n, f = x.shape
    k = kept.shape[1]
    xb = x.reshape(q, n, f // LANE, LANE)
    idx = kept.long()[:, None, :, None].expand(q, n, k, LANE)
    b_ms, b_by = bound_ms(2 * q * n * k * LANE * 4 + kept.numel() * 4)
    rec = {"kernel": "varco_pack", "case": name,
           "shape": {"x": list(x.shape), "kept": list(kept.shape)},
           "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: varco_pack(x, kept), reps),
           "plain_ms": cuda_ms(lambda: varco_pack_plain(x, kept), reps),
           "library_ms": cuda_ms(lambda: torch.gather(xb, 2, idx), reps),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec, out


def _unpack_case(name, packed, inv, reps):
    from repro_torch.kernels.varco_pack import (LANE, varco_unpack,
                                                varco_unpack_plain)

    out = varco_unpack(packed, inv)
    ref = varco_unpack_plain(packed, inv)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"varco_unpack {name}: not bitwise equal")
    q, m, kf = packed.shape
    nb = inv.shape[1]
    b_ms, b_by = bound_ms(q * m * kf * 4 + q * m * nb * LANE * 4 +
                          inv.numel() * 4)
    rec = {"kernel": "varco_unpack", "case": name,
           "shape": {"packed": list(packed.shape), "inv": list(inv.shape)},
           "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: varco_unpack(packed, inv), reps),
           "plain_ms": cuda_ms(lambda: varco_unpack_plain(packed, inv),
                               reps),
           "library_ms": None,   # no single PyTorch call zero-fills
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def kernels_phase(eng, reps: int = 20):
    """Every kernel at the slice's shapes (taken from the engine's graph:
    ELL lists, boundary block, hop buffers) and at one ragged shape.
    Returns ``{kernel: record at its main-path shape}`` with the largest
    error over all of its cases."""
    from repro_torch import prng
    from repro_torch.kernels.varco_pack import LANE, worker_block_maps_pos

    dev = eng.device
    meta, graph = eng.meta, eng.graph
    q, p_sz, b_sz = meta.q, meta.part_size, meta.halo_size
    d_hops, h_w = max(q - 1, 1), meta.p2p_hop_width
    gen = torch.Generator(device=dev).manual_seed(1)
    main, worst = {}, {}

    def keep(rec, is_main):
        worst[rec["kernel"]] = max(worst.get(rec["kernel"], 0.0),
                                   rec["max_abs_err"])
        if is_main:
            main[rec["kernel"]] = rec

    for f in (128, 256):
        x = torch.randn((q, p_sz, f), generator=gen, device=dev)
        keep(_ell_case(f"slice_f{f}", x, graph["ell_nbr"], graph["ell_w"],
                       reps), f == 256)
    for f in (128, 256):
        nb = f // LANE
        publish = torch.randn((q, b_sz, f), generator=gen, device=dev)
        for k in sorted({nb, 1}):
            kept, inv, _ = worker_block_maps_pos(
                prng.fold_in(prng.key(0), f + k), q, nb, k)
            kept_t = torch.from_numpy(kept).to(dev)
            inv_t = torch.from_numpy(inv).to(dev)
            rec, _ = _pack_case(f"slice_f{f}_k{k}", publish, kept_t, reps)
            keep(rec, f == 256 and k == nb)
            hops = torch.randn((q, d_hops * h_w, k * LANE), generator=gen,
                               device=dev)
            keep(_unpack_case(f"slice_f{f}_k{k}", hops, inv_t, reps),
                 f == 256 and k == nb)
    # ragged shapes: odd row counts, a width off the float4 grid, pad slots
    rng = np.random.default_rng(0)
    for f in (42, 384):
        x = torch.randn((3, 1001, f), generator=gen, device=dev)
        nbr = torch.from_numpy(rng.integers(0, 1001, (3, 777, 7))
                               .astype(np.int32)).to(dev)
        w = torch.from_numpy((rng.uniform(size=(3, 777, 7)) *
                              (rng.uniform(size=(3, 777, 7)) > 0.3))
                             .astype(np.float32)).to(dev)
        keep(_ell_case(f"ragged_f{f}", x, nbr, w, 5), False)
    x = torch.randn((3, 1001, 384), generator=gen, device=dev)
    kept, inv, _ = worker_block_maps_pos(prng.key(3), 3, 3, 2)
    rec, packed = _pack_case("ragged", x, torch.from_numpy(kept).to(dev), 5)
    keep(rec, False)
    keep(_unpack_case("ragged", packed, torch.from_numpy(inv).to(dev), 5),
         False)
    for name in main:
        main[name] = {**main[name], "max_abs_err": worst[name]}
    return main


# ---------------------------------------------------------------------------
# phase 3 + 5: the serving slice
# ---------------------------------------------------------------------------


def setup_phase(n_nodes: int, device: str, q: int = 4, seed: int = 0):
    from repro_torch.graph.synthetic import citation_graph
    from repro_torch.nn.gnn import GNNConfig, init_gnn
    from repro_torch.serve import ServingEngine

    t0 = time.perf_counter()
    g = citation_graph(n=n_nodes, feat_dim=128, seed=seed)
    t1 = time.perf_counter()
    cfg = GNNConfig(conv="sage", in_dim=128, hidden=256,
                    out_dim=g.num_classes, layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                      device=device)
    eng = ServingEngine(g, params, cfg, q=q, device=device, seed=seed)
    t2 = time.perf_counter()
    emit({"phase": "setup", "nodes": g.num_nodes,
          "directed_edges": g.num_edges, "q": q,
          "part_size": eng.meta.part_size, "halo_size": eng.meta.halo_size,
          "hop_width": eng.meta.p2p_hop_width,
          "ell_degree": int(eng.graph["ell_nbr"].shape[-1]),
          "halo_demand": eng.meta.halo_demand, "policy": str(eng.policy),
          "model": {"conv": cfg.conv, "in": cfg.in_dim, "hidden": cfg.hidden,
                    "out": cfg.out_dim, "layers": cfg.layers},
          "graph_s": t1 - t0, "partition_and_engine_s": t2 - t1})
    return g, cfg, params, eng


def _queries(eng, rng, n_nodes: int, n_edges: int, lat: list) -> int:
    """Submit node and edge queries in bursts through the micro-batcher
    and flush as its window trips; per-query latency (submit -> answer,
    host clock) lands in ``lat``."""
    n = eng.g.num_nodes
    hot = rng.integers(0, n, 32)
    pending: dict[int, float] = {}
    answered = 0
    reqs = [("node", int(u)) for u in np.where(
        rng.uniform(size=n_nodes) < 0.6, rng.choice(hot, n_nodes),
        rng.integers(0, n, n_nodes))] + \
        [("edge", (int(a), int(b))) for a, b in rng.integers(0, n,
                                                             (n_edges, 2))]
    order = rng.permutation(len(reqs))
    for burst in np.array_split(order, max(len(reqs) // 20, 1)):
        for i in burst:
            qy = eng.submit(reqs[i][1], tenant=reqs[i][0])
            pending[id(qy)] = qy.arrival
        while eng.batcher.pending:
            out = eng.flush()
            now = time.monotonic()
            for qy, emb in out:
                lat.append(now - pending.pop(id(qy)))
                check(np.isfinite(emb).all(), "non-finite answer")
                answered += 1
    return answered


def slice_phase(g, cfg, params, eng, seed: int = 0):
    from repro_torch.kernels.ell_spmm import ell_spmm
    from repro_torch.kernels.varco_pack import varco_pack, varco_unpack
    from repro_torch.nn.gnn import centralized_forward

    counters = {"ell_spmm": ell_spmm, "varco_pack": varco_pack,
                "varco_unpack": varco_unpack}
    rng = np.random.default_rng(seed)
    lat: list[float] = []
    refreshes = []

    def refresh(force):
        m = eng.refresh(force=force)
        rec = {"force": force, "status": eng.status(),
               "forward_ms": eng.timing["forward_s"] * 1e3,
               "host_copy_ms": eng.timing["host_copy_s"] * 1e3,
               "halo_bits": float(m["halo_bits"]),
               "transport_bits": float(m["transport_bits"])}
        refreshes.append(rec)
        emit({"phase": "refresh", **rec})

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    refresh(True)
    check(eng.status() == "FRESH", "cold refresh is not FRESH")
    last = len(params["layers"]) - 1
    fresh = eng.cache.gather(last, np.arange(g.num_nodes))
    answered = _queries(eng, rng, 150, 50, lat)
    for _ in range(3):
        refresh(False)
        answered += _queries(eng, rng, 100, 40, lat)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    emb, _ = eng.serve(np.arange(0, g.num_nodes, 97))
    check(np.isfinite(emb).all() and emb.shape[1] == cfg.out_dim,
          "served embeddings malformed")
    ref = centralized_forward(params, cfg, g, device=eng.device)
    err = float(np.abs(fresh - ref.cpu().numpy()).max())
    check(err <= FRESH_TOL,
          f"FRESH answers differ from centralized_forward by {err}")
    lat_ms = np.asarray(lat) * 1e3
    summary = {"phase": "slice", "wall_s": wall, "queries": answered,
               "serve_p50_ms": float(np.percentile(lat_ms, 50)),
               "serve_p99_ms": float(np.percentile(lat_ms, 99)),
               "refresh_forward_ms": [r["forward_ms"] for r in refreshes],
               "refresh_host_copy_ms": [r["host_copy_ms"]
                                        for r in refreshes],
               "ledger_halo_bits": float(eng.ledger.bits),
               "ledger_transport_bits": float(eng.ledger.transport),
               "status": eng.status(), "launches": launches,
               "fresh_vs_centralized_max_abs": err,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
               if eng.device.type == "cuda" else None}
    emit(summary)
    check(answered >= 300, f"only {answered} queries answered")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=169_343,
                    help="graph size (default: OGBN-Arxiv's node count)")
    args = ap.parse_args(argv)
    try:
        card = device_phase()
        build_phase()
        g, cfg, params, eng = setup_phase(args.nodes, "cuda")
        main_recs = kernels_phase(eng)
        launches = slice_phase(g, cfg, params, eng)
    except Failure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:                      # any phase's crash fails the run
        traceback.print_exc()
        return 1
    kernels = []
    for name, meta in KERNELS.items():
        r = main_recs[name]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

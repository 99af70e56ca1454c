#!/usr/bin/env python3
"""Time design variants of the ELL SpMM kernel on the card, in one call.

    python3 scripts/ell_spmm_variants.py                 # on an H100
    python3 scripts/ell_spmm_variants.py --nodes 20000   # a smaller graph

Each variant is the shipped source (``src/repro_torch/csrc/ell_spmm.cu``:
128-column slices, a half-warp of two 16-byte loads a lane per row, blocks
of 128 threads capped at 48 registers, tiles from a counter, 4 gathers in
flight) built with ``-D`` overrides of its design macros: the
column-slice width (32, 64, 128 or the full row at F = 256, through lanes
per row and chunks per lane), each with and without the L2 hints
(``evict_last`` gathers, streaming stores); each hint alone; the lists
loaded with ``evict_last``; a warp of 8-byte or 16-byte loads and a
quarter-warp per row; each row's lists loaded once with its slices looped
inside (tiles of partition and row tile, so no slice-major order); the
tile walk (a static stride, or one block a tile); 2 or 8 gathers in
flight; no register cap; blocks of 256 threads.  Three diagnostic builds
change the gathers by a text edit and compute the wrong function on
purpose: ``diag_no_gather`` drops them (lists, loop and stores only),
``diag_l2_resident`` reads rows ``j & 4095`` only (a set that stays in
L2) and ``diag_l1_resident`` rows ``j & 63`` (a set that stays in L1).
The kernel's earlier design (one warp per row, rows in order, no hints)
is built from a copy kept here as a diagnostic, ``warp_per_row``.

Every variant is built with the package's own ``nvcc`` flags, all at once
(one process each), into ``build/ell_spmm_variants/``, checked against the
plain version (diagnostics excepted) and timed by CUDA events at the GNN
path's three shapes on ``chip_smoke.py``'s graph: the forward lists at F =
256 and F = 128 and the reversed lists (the training backward) at F = 256,
twice in turns.  Prints one JSON line per measurement, the card's name and
power limit first, a summary (each variant's time per shape over the
turns) last.  Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ell_spmm as te  # noqa: E402

OUT = ROOT / "build" / "ell_spmm_variants"
ELL_TOL = 1e-5

_NO_HINTS = {"ELL_X_HINT": 0, "ELL_OUT_STREAM": 0}
# "full" (four 16-byte loads a lane) needs more than the shipped register
# cap, so it runs uncapped; so does the quarter-warp
_SLICES = {"sw32": {"ELL_LPR": 8, "ELL_CH": 1},
           "sw64": {"ELL_CH": 1},
           "sw128": {},
           "full": {"ELL_CH": 4, "ELL_MINB": 0}}
#: name -> (-D macros, text edits); "sw128" is the shipped design
VARIANTS = {
    **{name: (d, []) for name, d in _SLICES.items()},
    **{f"{name}_no_hints": ({**d, **_NO_HINTS}, [])
       for name, d in _SLICES.items()},
    "sw128_x_hint_only": ({"ELL_OUT_STREAM": 0}, []),
    "sw128_stream_only": ({"ELL_X_HINT": 0}, []),
    "sw128_list_evict_last": ({"ELL_LIST_HINT": 1}, []),
    "sw128_warp_8byte": ({"ELL_LPR": 32, "ELL_VEC": 2}, []),
    "sw128_warp_16byte": ({"ELL_LPR": 32, "ELL_CH": 1}, []),
    "sw128_quarter_warp": ({"ELL_LPR": 8, "ELL_CH": 4, "ELL_MINB": 0}, []),
    "sw128_lists_once": ({"ELL_SLICE_INNER": 1}, []),
    "sw64_lists_once": ({"ELL_SLICE_INNER": 1, "ELL_CH": 1}, []),
    "sw128_static_stride": ({"ELL_PERSIST": 1}, []),
    "sw128_not_persistent": ({"ELL_PERSIST": 0}, []),
    "sw128_unroll2": ({"ELL_UNROLL": 2}, []),
    "sw128_unroll8": ({"ELL_UNROLL": 8}, []),
    "sw128_no_register_cap": ({"ELL_MINB": 0}, []),
    "sw128_threads256": ({"ELL_THREADS": 256, "ELL_MINB": 5}, []),
    "diag_no_gather": ({}, [("? load_x<VEC>(xr + col, pol)",
                             "? Vec<VEC>::zero()")]),
    "diag_l2_resident": ({}, [("xq + (int64_t)j[u] * f;",
                               "xq + (int64_t)(j[u] & 4095) * f;")]),
    "diag_l1_resident": ({}, [("xq + (int64_t)j[u] * f;",
                               "xq + (int64_t)(j[u] & 63) * f;")]),
}

#: the earlier design (one warp per row), kept as a diagnostic build only
WARP_PER_ROW_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 2;
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                const float* __restrict__ w, float* __restrict__ out,
                int64_t rows, int64_t n_dst, int64_t n_src, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t part = row / n_dst;
  const float* xq = x + part * n_src * f;
  const int* nr = nbr + row * k;
  const float* wr = w + row * k;
  float* orow = out + row * f;
  constexpr int kTile = 32 * VEC * kChunks;
  for (int c0 = 0; c0 < f; c0 += kTile) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[c][v] = 0.f;
    for (int kb = 0; kb < k; kb += 32) {
      const int my = kb + lane;
      const int my_j = my < k ? nr[my] : 0;
      const float my_w = my < k ? wr[my] : 0.f;
      const int n_here = min(32, k - kb);
      for (int s = 0; s < n_here; ++s) {
        const int j = __shfl_sync(0xffffffffu, my_j, s);
        const float wj = __shfl_sync(0xffffffffu, my_w, s);
        if (wj == 0.f || j < 0 || j >= n_src) continue;
        const float* xr = xq + (int64_t)j * f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = c0 + c * 32 * VEC + lane * VEC;
          if (col < f) {
            if constexpr (VEC == 4) {
              const float4 v = *reinterpret_cast<const float4*>(xr + col);
              acc[c][0] = fmaf(wj, v.x, acc[c][0]);
              acc[c][1] = fmaf(wj, v.y, acc[c][1]);
              acc[c][2] = fmaf(wj, v.z, acc[c][2]);
              acc[c][3] = fmaf(wj, v.w, acc[c][3]);
            } else {
              acc[c][0] = fmaf(wj, xr[col], acc[c][0]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c0 + c * 32 * VEC + lane * VEC;
      if (col < f) {
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        } else {
          orow[col] = acc[c][0];
        }
      }
    }
  }
}
}  // namespace
extern "C" int ell_spmm_f32(const void* x, const void* nbr, const void* w,
                            void* out, void* /*counter*/, long long q,
                            long long n_dst, long long n_src, long long k,
                            long long f, int vec4, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t rows = (int64_t)q * n_dst;
  if (rows == 0 || f == 0) return (int)cudaGetLastError();
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    ell_spmm_kernel<4><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(nbr),
        static_cast<const float*>(w), static_cast<float*>(out), rows, n_dst,
        n_src, (int)k, (int)f);
  } else {
    ell_spmm_kernel<1><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(nbr),
        static_cast<const float*>(w), static_cast<float*>(out), rows, n_dst,
        n_src, (int)k, (int)f);
  }
  return (int)cudaGetLastError();
}
"""


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    """Every variant and the earlier design, one ``nvcc`` each, in parallel;
    returns ``{name: (library path, ptxas register/spill lines)}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ell_spmm.cu").read_text()
    jobs = {name: (variant_source(src, edits), macros)
            for name, (macros, edits) in VARIANTS.items()}
    jobs["warp_per_row"] = (WARP_PER_ROW_SOURCE, {})
    procs = {}
    for name, (text, macros) in jobs.items():
        cu = OUT / f"ell_spmm__{name}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        flags = [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (lib, [ln.split(":", 1)[-1].strip()
                            for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


def cuda_ms(fn, reps: int) -> float:
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


def path_shapes(n_nodes: int, gen: torch.Generator) -> dict:
    """``chip_smoke.py``'s graph cut as the serving engine cuts it, and the
    three ``ell_spmm`` calls of the GNN path: ``{name: (x, nbr, w)}``."""
    from repro_torch.dist.halo import ell_arrays
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import citation_graph

    g = citation_graph(n=n_nodes, feat_dim=128, seed=0)
    pg = partition_graph(g, 4, scheme="metis-like", seed=0)
    ell = {k: torch.from_numpy(v).cuda() for k, v in ell_arrays(pg).items()}
    q, p_sz = pg.q, pg.part_size
    nbr, w, rslot = ell["ell_nbr"], ell["ell_w"], ell["ell_rslot"]
    # the backward's weights: w gathered through rslot (ops.ell_aggregate)
    rw = torch.gather(w.reshape(q, -1), 1,
                      rslot.reshape(q, -1).clamp(min=0).long())
    rw = torch.where(rslot >= 0, rw.reshape(rslot.shape),
                     torch.zeros((), device="cuda")).contiguous()
    return {
        "slice_f256": (torch.randn((q, p_sz, 256), generator=gen,
                                   device="cuda"), nbr, w),
        "slice_f128": (torch.randn((q, p_sz, 128), generator=gen,
                                   device="cuda"), nbr, w),
        "reverse_f256": (torch.randn((q, p_sz, 256), generator=gen,
                                     device="cuda"), ell["ell_rnbr"], rw),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--nodes", type=int, default=169_343)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    libs = build_all()
    for name, (_, ptxas) in libs.items():
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
    shapes = path_shapes(args.nodes, torch.Generator(device="cuda")
                         .manual_seed(0))
    refs = {s: te.ell_spmm_plain(*a) for s, a in shapes.items()}
    for s, (x, nbr, w) in shapes.items():
        nnz = int((w != 0).sum())
        print(json.dumps({"shape": s, "x": list(x.shape),
                          "nbr": list(nbr.shape), "nnz": nnz,
                          "gathered_bytes": nnz * x.shape[2] * 4}),
              flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    for name, (lib, _) in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), "ell_spmm_f32")
        fn.argtypes = te._FUNCS["ell_spmm_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    times: dict = {}
    for turn in range(2):
        for name, fn in fns.items():
            for s, (x, nbr, w) in shapes.items():
                q, n_src, f = x.shape
                _, n_dst, k = nbr.shape
                out = torch.empty((q, n_dst, f), device="cuda")

                def call(fn=fn, x=x, nbr=nbr, w=w, out=out, q=q, n_dst=n_dst,
                         n_src=n_src, k=k, f=f):
                    counter.zero_()       # the dynamic walk's tile counter
                    return fn(x.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                              out.data_ptr(), counter.data_ptr(), q, n_dst,
                              n_src, k, f, 1, 0, stream)
                out.fill_(float("nan"))
                rc = call()
                torch.cuda.synchronize()
                err = None if name.startswith("diag") else \
                    float((out - refs[s]).abs().max())
                if rc != 0 or (err is not None and not err <= ELL_TOL):
                    print(json.dumps({"variant": name, "shape": s,
                                      "rc": rc, "max_abs_err": err,
                                      "error": "wrong or refused"}),
                          flush=True)
                    return 1
                ms = cuda_ms(call, args.reps)
                times.setdefault(name, {}).setdefault(s, []).append(ms)
                print(json.dumps({"variant": name, "shape": s, "turn": turn,
                                  "max_abs_err": err, "ms": ms}), flush=True)
    print(json.dumps({"summary": times, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

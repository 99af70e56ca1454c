#!/usr/bin/env python3
"""Time the CUDA-core (f32) and narrow-head tensor-core (bf16, D in {16,
32}) flash kernels on the card: design variants, and the earlier kernel
they replace, in one call.

    python3 scripts/flash_narrow_variants.py                 # on an H100
    python3 scripts/flash_narrow_variants.py --parent old/   # + the parent

Each variant is the shipped source (``src/repro_torch/csrc/
flash_attention.cu`` or ``flash_attention_mma.cu``) with a few named text
edits (a tile or an unroll choice flipped: the numbers behind the choices
in the sources' notes).  ``--parent DIR`` also builds ``DIR/src/
repro_torch/csrc/flash_attention.cu`` as it stands there (the earlier
CUDA-core kernel, which took f32 and bf16 through one C entry with a
dtype code) and times it on the same inputs, so the before and after
share a card.  Everything is built with the package's own ``nvcc`` flags
(one process per library, all at once) into ``build/flash_variants/``.

Per (kernel, variant, shape) and turn (two turns, in order parent,
variants, variants, parent within each shape family), one JSON line:
``ms`` — CUDA events around ``--reps`` back-to-back calls of the C entry
with prepared arguments (no Python checks), ``graph_ms`` — the same calls
captured once in a CUDA graph and replayed (device time without host
gaps), ``max_abs_err`` against the plain version.  The public wrapper
(``flash_attention``) and ``scaled_dot_product_attention`` are timed
beside them both ways (the plain version, ``flash_attention_plain``,
eagerly), and by the host clock around ``--reps`` calls
with no synchronisation (the host time of one call).  The card's name
and power limit come first.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, graph_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "flash_variants"


def _cfg(d: int, su: int, pu: int) -> str:
    return (f"struct Cfg<{d}> {{\n  static constexpr int R = " +
            _SHAPE[d] + f";\n  static constexpr int SU = {su}, PU = {pu};")


_SHAPE = {64: "8, TY = 4, TX = 8, WARPS = 4, BK = 64, MINB = 2",
          128: "8, TY = 4, TX = 8, WARPS = 2, BK = 32, MINB = 2"}
SIMT = {
    "shipped": [],
    "d64_su2": [(_cfg(64, 1, 2), _cfg(64, 2, 2))],
    "d64_pu1": [(_cfg(64, 1, 2), _cfg(64, 1, 1))],
    "d128_pu2": [(_cfg(128, 2, 1), _cfg(128, 2, 2))],
    "d64_bk32": [(_cfg(64, 1, 2), _cfg(64, 1, 2).replace("BK = 64",
                                                         "BK = 32"))],
}
_BK = "constexpr int kBK = 128;"
_ST = "constexpr int kStages = 3;"
MMA = {
    "shipped": [],
    "bk64": [(_BK, _BK.replace("128", "64"))],
    "stages2": [(_ST, _ST.replace("3", "2"))],
    "stages4": [(_ST, _ST.replace("3", "4"))],
}
#: (b, h, kv, s, d), causal; the ``smoke`` shapes are ``python -m
#: repro_torch.launch.serve --smoke``'s prefill (batch 8 × prompt 64) of
#: granite's and llama4's SMOKE configs, which serve in f32
SIMT_SHAPES = {"f32": (2, 32, 8, 2048, 64), "f32_d32": (2, 8, 4, 2048, 32),
               "f32_d16": (2, 8, 4, 2048, 16),
               "f32_d128": (2, 32, 8, 2048, 128),
               "f32_d256": (2, 16, 16, 2048, 256),
               "f32_smoke_d16": (8, 8, 2, 64, 16),
               "f32_smoke_d32": (8, 4, 2, 64, 32)}
MMA_SHAPES = {"bf16_d32": (2, 8, 4, 2048, 32),
              "bf16_d16": (2, 8, 4, 2048, 16)}
#: the earlier kernel's C entry: a dtype code after the seven pointers
_PARENT_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant edit not found: {old!r}")
        src = src.replace(old, new)
    return src


def build_all(parent: Path | None) -> dict:
    """{(library, variant): .so path}, every nvcc at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for lib, variants in (("flash_attention", SIMT),
                          ("flash_attention_mma", MMA)):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for name, edits in variants.items():
            path = OUT / f"{lib}-{name}.cu"
            path.write_text(variant_source(src, edits))
            jobs[(lib, name)] = path
    if parent is not None:
        path = OUT / "flash_attention-parent.cu"
        path.write_text((parent / "src/repro_torch/csrc/flash_attention.cu")
                        .read_text())
        jobs[("flash_attention", "parent")] = path
    procs = {}
    for key, path in jobs.items():
        so = path.with_suffix(".so")
        procs[key] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = so
    return libs


def load(path: Path, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent tree (its CUDA-core "
                         "flash source is timed beside the variants)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    libs = build_all(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    families = (("flash_attention", "flash_attention_fwd", SIMT,
                 SIMT_SHAPES, torch.float32, 2e-5),
                ("flash_attention_mma", "flash_attention_mma_fwd", MMA,
                 MMA_SHAPES, torch.bfloat16, 2e-2))
    for lib, symbol, variants, shapes, dtype, tol in families:
        for sname, (b, h, kv, s, d) in shapes.items():
            q, k, v = (torch.randn((b, s, n, d), generator=gen,
                                   device="cuda", dtype=dtype)
                       .transpose(1, 2) for n in (h, kv, kv))
            ref = fa.flash_attention_plain(q, k, v, True, 0).float()
            out = torch.empty_like(q)
            # the C entry's arguments, the stream read at call time (a
            # graph captures on its own stream)
            call_args = fa._launch_args(q, k, v, out, True, 0)[:-1]
            code = 0 if dtype == torch.float32 else 1
            order = list(variants)
            if ("flash_attention", "parent") in libs:
                order = ["parent", *order]
            for turn, names in enumerate((order, order[::-1])):
                for vname in names:
                    if vname == "parent":
                        fn = load(libs[("flash_attention", "parent")],
                                  "flash_attention_fwd", _PARENT_ARGS)
                        a = (*call_args[:7], code, *call_args[7:])
                    else:
                        fn = load(libs[(lib, vname)], symbol, fa._FWD_ARGS)
                        a = call_args

                    def call(fn=fn, a=a):
                        return fn(*a,
                                  torch.cuda.current_stream().cuda_stream)
                    out.zero_()
                    rc = call()
                    torch.cuda.synchronize()
                    print(json.dumps({
                        "kernel": lib, "variant": vname, "shape": sname,
                        "dims": [b, h, kv, s, d], "dtype": str(dtype),
                        "turn": turn, "rc": rc,
                        "max_abs_err": float((out.float() - ref).abs()
                                             .max()),
                        "ms": cuda_ms(call, args.reps),
                        "graph_ms": graph_ms(call, args.reps)}),
                        flush=True)
            host = {}
            for what, fn in (("wrapper", lambda: fa.flash_attention(
                    q, k, v, True, 0)), ("sdpa", lambda: sdpa(
                        q, k, v, is_causal=True, enable_gqa=True))):
                fn()                          # warm: loads the library
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    fn()
                host[f"{what}_host_us"] = \
                    (time.perf_counter() - t0) / args.reps * 1e6
                torch.cuda.synchronize()
            print(json.dumps({
                **host, "kernel": "wrapper+sdpa", "shape": sname, "dims":
                [b, h, kv, s, d], "dtype": str(dtype),
                "wrapper_ms": cuda_ms(lambda: fa.flash_attention(
                    q, k, v, True, 0), args.reps),
                "wrapper_graph_ms": graph_ms(lambda: fa.flash_attention(
                    q, k, v, True, 0), args.reps),
                "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, True, 0), args.reps),
                "sdpa_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True), args.reps),
                "sdpa_graph_ms": graph_ms(lambda: sdpa(
                    q, k, v, is_causal=True, enable_gqa=True), args.reps)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

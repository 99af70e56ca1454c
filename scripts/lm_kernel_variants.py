#!/usr/bin/env python3
"""Time design variants of the two LM kernels on the card, in one call.

    python3 scripts/lm_kernel_variants.py          # on a machine with an H100
    python3 scripts/lm_kernel_variants.py --reps 50

Each variant is the shipped source (``src/repro_torch/csrc/
flash_attention_wgmma.cu`` or ``ssd_chunk.cu``) with a few named text
edits: a scheduling choice flipped (the numbers behind the choices in the
sources' notes) or, for the ``diag_*`` flash variants, a part of the work
removed, to see where the time goes (their outputs are wrong by design and
are not checked).  Flash is also timed with explicit positions (granite's
prefill shape at S = 2000, half the rows left-padded, half shifted: the
position-mask path), where two variants bear on that path: the position
mask applied to every key tile (no wholly-unmasked run) and, as a
diagnostic, no position-mask pass at all.  Every variant is built with the package's own ``nvcc``
flags (all at once, one process each) into ``build/lm_kernel_variants/``
and timed by CUDA events at the LM paths' shapes, twice in turns; the SSD
``Y`` pass's heads per block is a launch argument and is swept too.
Prints one JSON line per measurement, the card's name and power limit
first.  Needs a card; exits 1 without one.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402

OUT = ROOT / "build" / "lm_kernel_variants"


def _cfg(d: int, body: str) -> str:
    return f"struct Cfg<{d}> {{\n{body}"


_D64 = _cfg(64, "  static constexpr int BK = 128, STAGES = 4;\n"
                "  static constexpr bool OVERLAP = true;")
_D128 = _cfg(128, "  static constexpr int BK = 128, STAGES = 3;\n"
                  "  static constexpr bool OVERLAP = true;")
_D256 = _cfg(256, "  static constexpr int BK = 64, STAGES = 2;\n"
                  "  static constexpr bool OVERLAP = false;")
_POS_PASS = ("      if (!(kt >= full_lo && kt + BK <= full_hi)) "
             "position_mask(kt);")
FLASH = {
    "shipped": [],
    "d64_no_overlap": [(_D64, _D64.replace("true", "false"))],
    "d64_stages3": [(_D64, _D64.replace("STAGES = 4", "STAGES = 3"))],
    "d128_no_overlap": [(_D128, _D128.replace("true", "false"))],
    "d256_overlap": [(_D256, _D256.replace("false", "true"))],
    # where the time goes: drop the softmax arithmetic, move exp2 off the
    # SFU (a stand-in of FMA-pipe ops), or drop one product
    "diag_no_softmax": [("  auto softmax = [&](int it) {\n",
                         "  auto softmax = [&](int it) {\n"
                         "    al_a = al_b = 1.f;\n"
                         "    l_a += sacc[0];\n"
                         "    return;\n")],
    "diag_exp2_on_fma": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "  y = x > -1e30f ? fmaf(x, 1e-9f, 1.f) : 0.f;")],
    "diag_no_pv": [("        wgmma_rs_n64(oacc + 32 * j, pa[t],",
                    "        if (it < 0) wgmma_rs_n64(oacc + 32 * j, pa[t],")],
    "diag_no_qk": [("      wgmma_ss<BK>(sacc,", "      if (kk < 0) "
                    "wgmma_ss<BK>(sacc,")],
    "position_mask_every_tile": [(_POS_PASS, _POS_PASS.replace(
        "!(kt >= full_lo && kt + BK <= full_hi)", "true"))],
    "diag_no_position_pass": [(_POS_PASS, "      ;")],
}
_HB = "  const int hb = rep;  // heads per Y block"
SSD = {
    "shipped": [],
    "state_four_heads": [("constexpr int kSHB = 2;",
                          "constexpr int kSHB = 4;")],
    **{f"y_{k}_heads": [(_HB, _HB.replace("rep;", f"{k};"))]
       for k in (12, 6, 2)},
}
FLASH_SHAPES = {  # name: (b, h, kv, s, d, window), causal, bf16
    "granite_prefill": (8, 32, 8, 2048, 64, 0),
    "window1024": (8, 32, 8, 2048, 64, 1024),
    "d128": (2, 32, 8, 2048, 128, 0),
    "d256": (2, 16, 16, 2048, 256, 0),
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kind, variants in (("flash_attention_wgmma", FLASH),
                           ("ssd_chunk", SSD)):
        src = (_build.CSRC / f"{kind}.cu").read_text()
        for name, edits in variants.items():
            cu = OUT / f"{kind}__{name}.cu"
            cu.write_text(variant_source(src, edits))
            lib = cu.with_suffix(".so")
            procs[(kind, name)] = (lib, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
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


def load(path: Path, symbol: str, argtypes) -> ctypes.CDLL:
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    flash_in = {}
    for name, (b, h, kv, s, d, window) in FLASH_SHAPES.items():
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (h, kv, kv))
        flash_in[name] = (q, k, v, window,
                          fa.flash_attention_plain(q, k, v, True, window))
    b_, s_ = 8, 2000
    q, k, v = (torch.randn((b_, s_, n, 64), generator=gen, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for n in (32, 8, 8))
    i = torch.arange(s_, dtype=torch.int32, device="cuda")
    pos = torch.stack([i + 7 + r if r % 2 else
                       torch.clamp(i - 97 * r, min=0) for r in range(b_)]
                      ).contiguous()
    ranges = fa.position_key_ranges(pos, pos, True, 0, fa.WGMMA_Q_TILE,
                                    fa.WGMMA_KEY_TILE[64])
    pos_in = (q, k, v, 0, fa.flash_attention_plain(q, k, v, True, 0, pos,
                                                   pos))
    for turn in range(2):
        for vname in FLASH:
            fn = load(libs[("flash_attention_wgmma", vname)],
                      "flash_attention_wgmma_fwd",
                      fa._FWD_ARGS)
            for sname, (q, k, v, window, ref) in flash_in.items():
                out = torch.empty_like(q)
                call_args = fa._launch_args(q, k, v, out, True, window)
                rc = fn(*call_args)
                torch.cuda.synchronize()
                err = None if vname.startswith("diag") else \
                    float((out.float() - ref.float()).abs().max())
                print(json.dumps({
                    "kernel": "flash_attention", "variant": vname,
                    "shape": sname, "turn": turn, "rc": rc,
                    "max_abs_err": err,
                    "ms": cuda_ms(lambda: fn(*call_args), args.reps)}),
                    flush=True)
        # the position-mask path: granite's widths at S = 2000, rows
        # alternately left-padded and shifted (positions built once, as
        # a prefill hands the same positions to every layer)
        q, k, v, _, _ = pos_in
        for vname in FLASH:
            if vname.startswith("diag_") and "position" not in vname:
                continue
            fn = load(libs[("flash_attention_wgmma", vname)],
                      "flash_attention_wgmma_fwd",
                      fa._FWD_ARGS)
            out = torch.empty_like(q)
            call_args = fa._launch_args(q, k, v, out, True, 0, pos, pos,
                                        ranges)
            rc = fn(*call_args)
            torch.cuda.synchronize()
            err = None if vname.startswith("diag") else \
                float((out.float() - pos_in[4].float()).abs().max())
            print(json.dumps({
                "kernel": "flash_attention", "variant": vname,
                "shape": "granite_positions_s2000", "turn": turn, "rc": rc,
                "max_abs_err": err,
                "ms": cuda_ms(lambda: fn(*call_args), args.reps)}),
                flush=True)
        q, k, v, window, _ = flash_in["granite_prefill"]
        print(json.dumps({
            "kernel": "scaled_dot_product_attention", "shape":
            "granite_prefill", "turn": turn, "ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), args.reps)}),
            flush=True)

    # mamba2-130m's prefill shape, x/B/C strided like the conv output
    b, nc, qn, h, p, g, n = 8, 8, 256, 24, 64, 1, 128
    wide = torch.randn((b, nc, qn, h * p + 2 * g * n), generator=gen,
                       device="cuda")
    x = wide[..., :h * p].reshape(b, nc, qn, h, p)
    bm = wide[..., h * p:h * p + g * n].reshape(b, nc, qn, g, n)
    cm = wide[..., h * p + g * n:].reshape(b, nc, qn, g, n)
    dt = torch.rand((b, nc, qn, h), generator=gen, device="cuda") * 0.099 \
        + 1e-3
    a = -torch.exp(torch.rand((h,), generator=gen, device="cuda") * 2 - 1)
    ssd_args = (x, dt, torch.cumsum(dt * a, dim=2), bm, cm)
    y_ref, s_ref = sc.ssd_chunk_plain(*ssd_args)
    views = [v for t in ssd_args for v in sc._view(t)]
    y = torch.empty(tuple(y_ref.shape), device="cuda")
    st = torch.empty(tuple(s_ref.shape), device="cuda")
    for turn in range(2):
        for vname in SSD:
            fn = load(libs[("ssd_chunk", vname)], "ssd_chunk_f32",
                      sc._FUNCS["ssd_chunk_f32"])

            def call(fn=fn):
                return fn(*views, y.data_ptr(), st.data_ptr(), b, nc, qn, h,
                          p, g, n, 0, stream)
            rc = call()
            torch.cuda.synchronize()
            err = max(float((y - y_ref).abs().max()),
                      float((st - s_ref).abs().max()))
            print(json.dumps({
                "kernel": "ssd_chunk", "variant": vname,
                "shape": "mamba2_prefill", "turn": turn, "rc": rc,
                "max_abs_err": err, "ms": cuda_ms(call, args.reps)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

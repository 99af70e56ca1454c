#!/usr/bin/env python3
"""Where the LM serving path's device time goes, by ``torch.profiler``.

    python3 scripts/profile_lm_serve.py --arch granite-3-2b
    python3 scripts/profile_lm_serve.py --arch mamba2-130m --decode-steps 4
    python3 scripts/profile_lm_serve.py --arch granite-3-2b --smoke \\
        --device cpu --prompt-len 64      # rehearsal: CPU times only

Builds the port's model at full size (random weights from a seeded
generator on the device), runs one untraced prefill + decode to build the
kernels and warm the allocator, then traces one prefill and
``--decode-steps`` decode steps separately.  For each it prints one JSON
line: the host-clock wall time (ending in a device sync), the device
time summed over every kernel, the device's idle share of the wall time
(the profiler's own host cost inflates the wall time, so the share is an
upper bound), and the kernels with the most device time.  For an MoE
architecture the stages of ``repro_torch.models.moe`` (``route``,
``slots``, ``dispatch``, ``experts``, ``combine``) run under
``record_function`` spans for the traced calls only, and the line adds
each stage's device time (the kernels launched inside its span), and the
gated MLPs (the shared experts', and any dense layer's) under ``mlp``.  The card's
name and power limit go on the first line.  On the CPU the list holds
operators' CPU self times, never device numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models.transformer import init_lm  # noqa: E402

TOP = 12    # kernels listed per phase
#: the MoE FFN's stages, each traced under a span of its name
MOE_STAGES = ("route", "slots", "dispatch", "experts", "combine")


def _device_total_us(evt) -> float:
    return float(getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0)))


def span_moe_stages() -> None:
    """Wrap each MoE stage (and the layers' gated MLP, which the shared
    experts run) in a ``record_function`` span named ``moe.<stage>``."""
    from repro_torch.models import layers, moe

    def spanned(name, fn):
        def inner(*args, **kwargs):
            with record_function(f"moe.{name}"):
                return fn(*args, **kwargs)
        return inner

    for name in MOE_STAGES:
        setattr(moe, name, spanned(name, getattr(moe, name)))
    layers.mlp = spanned("mlp", layers.mlp)


def _self_time_us(evt, on_card: bool) -> float:
    if on_card:
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))
    return float(evt.self_cpu_time_total)


def _trace(fn, device: torch.device) -> dict:
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    # on the card: the kernels (device-side events) only, so no time is
    # counted both under a kernel and under the operator that launched it
    # (the MoE stages' spans also appear on the device's timeline: they
    # are no kernels, so they stay out of the sum)
    rows = [(e.key[:160], _self_time_us(e, on_card), e.count)
            for e in prof.key_averages()
            if (not on_card or str(e.device_type).endswith("CUDA")) and
            not e.key.startswith("moe.")]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    spans = {e.key: (_device_total_us(e) if on_card
                     else float(e.cpu_time_total)) / 1e3
             for e in prof.key_averages() if e.key.startswith("moe.") and
             not str(e.device_type).endswith("CUDA")}
    busy_us = sum(r[1] for r in rows) if on_card else None
    return {"wall_ms": wall_us / 1e3,
            "device_ms": busy_us / 1e3 if on_card else None,
            "device_idle_share": 1.0 - busy_us / wall_us if on_card
            else None,
            "time_kind": "device self time" if on_card
            else "CPU self time (not a device number)",
            "top": [{"op": k, "ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:TOP]],
            **({"moe_stage_ms": spans} if spans else {})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else "nvidia-smi failed"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        card = "cpu"
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)

    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)) \
        .to(device)
    max_len = args.prompt_len + args.decode_steps + 1
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)

    def run_prefill():
        logits, cache = prefill(params, {"tokens": prompts})
        return logits.argmax(-1).to(torch.int32), cache

    def run_decode(tok, cache):
        for _ in range(args.decode_steps):
            tok, _, cache = decode(params, {"tokens": tok[:, None]}, cache)
        return tok

    tok, cache = run_prefill()                    # warm-up: builds kernels
    run_decode(tok, cache)
    if cfg.moe is not None:
        span_moe_stages()
    out = {}
    rec = _trace(lambda: out.update(zip(("tok", "cache"), run_prefill())),
                 device)
    print(json.dumps({"arch": cfg.name, "phase": "prefill",
                      "batch": args.batch, "prompt": args.prompt_len,
                      **rec}), flush=True)
    rec = _trace(lambda: run_decode(out["tok"], out["cache"]), device)
    rec["per_step_wall_ms"] = rec["wall_ms"] / args.decode_steps
    print(json.dumps({"arch": cfg.name, "phase": "decode",
                      "batch": args.batch, "steps": args.decode_steps,
                      **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

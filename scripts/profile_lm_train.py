#!/usr/bin/env python3
"""Where an LM training step's time goes on the card.

    python3 scripts/profile_lm_train.py                  # granite-3-2b, 8 x 2048
    python3 scripts/profile_lm_train.py --arch mamba2-130m --batch 4
    python3 scripts/profile_lm_train.py --smoke --device cpu --batch 2 \\
        --seq 64                                          # rehearsal

Builds the port's model at full size (random weights from a seeded
generator), AdamW from ``make_optimizer``, and ``make_train_step``; runs
two untraced steps, then times ``--steps`` warm steps on the host clock
(each ending in a sync) and traces one with ``torch.profiler`` (device
time summed over kernels, idle share, the kernels with the most device
time).  Then it times the step's parts alone with CUDA events at the
model's shapes: one attention layer's ``chunked_sdpa`` (or masked
``sdpa``) forward and forward + backward, with
``scaled_dot_product_attention``'s forward + backward on the same inputs
beside it (a library call, timed here only); one gated MLP forward +
backward; the LM head and cross-entropy forward + backward; the
optimiser update with ``clip_by_global_norm``.  ``attention_share`` is
the attention layers' part of a warm step: layers × (forward + forward
+ backward) under remat, layers × forward + backward without.  One JSON
line each; the card's name and power limit first.  On the CPU the times
are CPU times, never device numbers.
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
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.steps import (make_optimizer,  # noqa: E402
                                      make_train_step)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import (_lm_head,  # noqa: E402
                                            chunked_sdpa, init_lm)
from repro_torch.nn.modules import softmax_cross_entropy  # noqa: E402
from repro_torch.train.data import TokenPipeline  # noqa: E402
from repro_torch.train.optim import (apply_updates,  # noqa: E402
                                     clip_by_global_norm, tree_map)

TOP = 12


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn, device, reps: int = 3) -> float:
    """Mean ms of ``fn`` after one warm call: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _fwd_bwd(fn, *inputs):
    """``fn`` forward + backward against a fixed cotangent."""
    def run():
        xs = [x.detach().requires_grad_(True) for x in inputs]
        out = fn(*xs)
        out.backward(torch.ones_like(out))
    return run


def _trace(fn, device) -> dict:
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if on_card and not str(e.device_type).endswith("CUDA"):
            continue
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))) \
            if on_card else float(e.self_cpu_time_total)
        if us > 0:
            rows.append((e.key[:160], us, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) if on_card else None
    return {"wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3 if on_card else None,
            "device_idle_share": 1.0 - busy / wall_us if on_card else None,
            "time_kind": "device self time" if on_card
            else "CPU self time (not a device number)",
            "top": [{"op": k, "ms": us / 1e3, "calls": n}
                    for k, us, n in rows[:TOP]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (width stays)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
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
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         device=device)
    batch = next(pipe)
    for _ in range(2):
        params, state, m = step(params, state, batch)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(walls))
    out = {}
    rec = _trace(lambda: out.update(zip(("p", "s", "m"),
                                        step(params, state, batch))), device)
    print(json.dumps({
        "arch": cfg.name, "phase": "train_step", "layers": cfg.n_layers,
        "batch": args.batch, "seq": args.seq, "remat": cfg.remat,
        "step_ms": walls, "median_step_ms": step_ms,
        "tokens_per_s": args.batch * args.seq / (step_ms / 1e3),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9
        if device.type == "cuda" else None, **rec}), flush=True)
    del out

    # the step's parts alone, at the model's shapes
    b, s, d = args.batch, args.seq, cfg.d_model
    gen = torch.Generator(device=device).manual_seed(1)
    parts = {}
    x = torch.randn((b, s, d), generator=gen, device=device,
                    dtype=cfg.adtype)
    n_attn = cfg.n_blocks * cfg.pattern.count("attn")
    if n_attn:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = torch.randn((b, s, h, hd), generator=gen, device=device,
                        dtype=cfg.adtype)
        k = torch.randn((b, s, kv, hd), generator=gen, device=device,
                        dtype=cfg.adtype)
        v = torch.randn_like(k)
        pos = torch.arange(s, device=device)[None].expand(b, s)
        if L.use_chunked_sdpa(cfg, s, None):
            def attn(q, k, v):
                return chunked_sdpa(q, k, v, cfg.sliding_window)
        else:
            def attn(q, k, v):
                return L.sdpa(q, k, v, L._attn_mask(pos, pos,
                                                    cfg.sliding_window))

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)

        with torch.no_grad():
            parts["attention_fwd_ms"] = _ms(lambda: attn(q, k, v), device)
        parts["attention_fwd_bwd_ms"] = _ms(_fwd_bwd(attn, q, k, v), device)
        parts["sdpa_library_fwd_bwd_ms"] = _ms(_fwd_bwd(library, q, k, v),
                                               device)
        per_layer = parts["attention_fwd_bwd_ms"] + (
            parts["attention_fwd_ms"] if cfg.remat else 0.0)
        parts["attention_layers"] = n_attn
        parts["attention_share"] = n_attn * per_layer / step_ms
    if cfg.d_ff > 0 and "mlp" in params["blocks"].get(
            f"p0_{cfg.pattern[0]}", {}):
        lp = {k_: t[0].detach() for k_, t in
              params["blocks"][f"p0_{cfg.pattern[0]}"]["mlp"].items()}
        parts["mlp_fwd_bwd_ms"] = _ms(_fwd_bwd(
            lambda x_: L.mlp(lp, x_, cfg.mlp), x), device)

    labels = batch["tokens"]
    head = {k_: t.detach() for k_, t in params.items() if k_ != "blocks"}

    def head_loss(x_):
        logits = _lm_head(head, cfg, x_).float()
        return softmax_cross_entropy(logits[:, :-1], labels[:, 1:]).mean()
    parts["lm_head_ce_fwd_bwd_ms"] = _ms(_fwd_bwd(head_loss, x), device)

    grads = tree_map(lambda p: torch.randn_like(p) * 1e-3, params)

    def update():
        g, _ = clip_by_global_norm(grads, 1.0)
        u, _ = opt.update(g, state, params)
        apply_updates(params, u)
    parts["optimizer_ms"] = _ms(update, device, reps=2)
    print(json.dumps({"arch": cfg.name, "phase": "parts",
                      "batch": args.batch, "seq": args.seq,
                      "median_step_ms": step_ms, **parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

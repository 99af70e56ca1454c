"""Analytic FLOPs / HBM-bytes model per (arch × shape) — counterpart of
``repro/launch/analytic.py``, the same formulas over the port's configs.

Standard napkin math over the configs, the compute and memory terms of a
roofline (the bound of a training step or prefill, e.g. ``PERF.md``'s LM
rows).  ``estimate`` returns the JAX package's :class:`CostEstimate`
field for field.

Conventions (per *global* step; divide by chip count for per-device):
* matmul x@W: 2·m·k·n FLOPs.
* train: fwd + backward (2×fwd) + remat re-forward if enabled.
* attention: 4·B·S²·H·hd fwd (QKᵀ + PV), halved for causal.
* memory bytes/device: parameters touched (fwd + bwd + optimizer r/w) +
  activation traffic ≈ 2·(act writes + reads) + KV-cache traffic (decode).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.shapes import InputShape


@dataclasses.dataclass
class CostEstimate:
    flops_global: float           # per step, all chips
    hbm_bytes_per_dev: float      # per step, per chip
    param_bytes_per_dev: float
    act_bytes_per_dev: float
    detail: dict


def _layer_matmul_flops_per_tok(cfg: ArchConfig, pi: int) -> float:
    """Forward matmul FLOPs per token for pattern position ``pi``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kind = cfg.pattern[pi]
    f = 0.0
    if kind == "attn":
        f += 2.0 * d * cfg.n_heads * hd * 2          # wq, wo
        f += 2.0 * d * cfg.n_kv_heads * hd * 2       # wk, wv
    else:
        mc = cfg.mamba
        di = mc.d_inner(d)
        proj = 2 * di + 2 * mc.n_groups * mc.d_state + mc.n_heads(d)
        f += 2.0 * d * proj                          # in_proj
        f += 2.0 * di * d                            # out_proj
    if cfg.layer_uses_moe(pi):
        m = cfg.moe
        # top_k experts at capacity_factor occupancy + shared experts
        f += 2.0 * 3 * d * m.d_expert * m.top_k * m.capacity_factor
        if m.n_shared:
            f += 2.0 * 3 * d * m.shared_hidden
        f += 2.0 * d * m.n_experts                   # router
    elif cfg.d_ff > 0:
        f += 2.0 * 3 * d * cfg.d_ff
    return f


def _attn_seq_flops(cfg: ArchConfig, b: int, s: int, kv_len: int) -> float:
    """Per-layer attention score+value FLOPs (fwd) for q-len s vs kv_len."""
    hd = cfg.resolved_head_dim
    eff_kv = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len
    f = 4.0 * b * s * eff_kv * cfg.n_heads * hd
    if s == kv_len and not cfg.sliding_window:
        f *= 0.5                                     # causal half
    return f


def _mamba_seq_flops(cfg: ArchConfig, b: int, s: int) -> float:
    """SSD chunked-scan FLOPs (fwd) per layer."""
    mc = cfg.mamba
    h = mc.n_heads(cfg.d_model)
    p, n, q = mc.head_dim, mc.d_state, min(mc.chunk, s)
    # intra-chunk quadratic: scores 2·s·q·h·n + apply 2·s·q·h·p
    f = 2.0 * b * s * q * h * (n + p)
    # state build + inter-chunk apply: 2 × 2·s·h·p·n
    f += 4.0 * b * s * h * p * n
    return f


def _n_attn_mamba(cfg: ArchConfig) -> tuple[int, int]:
    na = sum(1 for k in cfg.pattern if k == "attn") * cfg.n_blocks
    nm = cfg.n_layers - na
    return na, nm


def _param_bytes(cfg: ArchConfig) -> float:
    return cfg.param_counts()["total"] * cfg.pdtype.itemsize


def estimate(cfg: ArchConfig, shape: InputShape, n_chips: int,
             moment_bytes: int | None = None) -> CostEstimate:
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    kv_len = shape.seq_len
    tokens = b * s
    na, nm = _n_attn_mamba(cfg)
    dt = cfg.adtype.itemsize

    # ---- FLOPs --------------------------------------------------------------
    matmul_tok = sum(_layer_matmul_flops_per_tok(cfg, pi)
                     for pi in range(cfg.pattern_period)) * cfg.n_blocks
    fwd = matmul_tok * tokens
    if na:
        fwd += na * _attn_seq_flops(cfg, b, s, kv_len if shape.kind ==
                                    "decode" else s)
    if nm:
        fwd += nm * (_mamba_seq_flops(cfg, b, s) if shape.kind != "decode"
                     else 4.0 * b * cfg.mamba.n_heads(cfg.d_model) *
                     cfg.mamba.head_dim * cfg.mamba.d_state)
    fwd += 2.0 * tokens * cfg.d_model * cfg.vocab_size  # lm head
    if shape.kind == "train":
        total = fwd * (3.0 + (1.0 if cfg.remat else 0.0))
    else:
        total = fwd

    # ---- HBM bytes per device ----------------------------------------------
    p_bytes_dev = _param_bytes(cfg) / n_chips
    mdt = moment_bytes if moment_bytes is not None else \
        2 * cfg.pdtype.itemsize  # 2 adam moments at param dtype by default
    if shape.kind == "train":
        # params: read fwd + read bwd (+ remat re-read) + grad write/read
        # + 2 moments read+write + param write
        reads = 2.0 + (1.0 if cfg.remat else 0.0)
        opt_traffic = p_bytes_dev * (2.0            # grad w+r
                                     + 1.0          # param write
                                     ) + \
            (cfg.param_counts()["total"] / n_chips) * mdt * 2.0
        param_traffic = p_bytes_dev * reads + opt_traffic
        act_per_layer = tokens * cfg.d_model * dt / n_chips
        # save + re-read block inputs, plus ~6 intermediate r/w per layer
        act_traffic = act_per_layer * cfg.n_layers * 8.0
    else:
        param_traffic = p_bytes_dev                  # read once per step
        act_per_layer = tokens * cfg.d_model * dt / n_chips
        act_traffic = act_per_layer * cfg.n_layers * 6.0
        if shape.kind == "decode" and na:
            w = min(kv_len, cfg.sliding_window) if cfg.sliding_window \
                else kv_len
            kv_bytes = (na * b * w * cfg.n_kv_heads *
                        cfg.resolved_head_dim * 2 * dt) / n_chips
            act_traffic += kv_bytes                  # read the KV cache
        if shape.kind == "prefill" and na:
            act_traffic += (na * tokens * cfg.n_kv_heads *
                            cfg.resolved_head_dim * 2 * dt * 2) / n_chips

    return CostEstimate(
        flops_global=total,
        hbm_bytes_per_dev=param_traffic + act_traffic,
        param_bytes_per_dev=p_bytes_dev,
        act_bytes_per_dev=act_traffic,
        detail={
            "fwd_flops": fwd,
            "matmul_flops_per_tok": matmul_tok,
            "attn_layers": na, "mamba_layers": nm,
            "param_traffic_dev": param_traffic,
        })

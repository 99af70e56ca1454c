"""Architecture configuration schema + registry.

Counterpart of ``repro/configs/base.py``: the same dataclasses, fields and
derived properties, with dtypes kept as strings and turned into torch
dtypes by :func:`torch_dtype`.  Every architecture of :data:`ARCH_IDS` has
one ``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (the exact
assignment) and ``SMOKE`` (the reduced same-family variant the CPU tests
use), copied field for field from the JAX package; :func:`get_config`
serves each of them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"`` ->
    ``torch.bfloat16``); the counterpart of ``jnp.dtype(name)``."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # shared-expert hidden dim (0 => n_shared*d_expert)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    every: int = 1                # MoE every `every` layers (others dense)
    pad_to: int = 0               # pad expert stacks so E divides the mesh
                                  # (padded experts are never routed to)

    @property
    def shared_hidden(self) -> int:
        return self.d_shared or self.n_shared * self.d_expert

    @property
    def e_padded(self) -> int:
        return max(self.pad_to, self.n_experts)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    ref: str                      # source paper / model card
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // n_heads
    # layer pattern, repeated to n_layers. entries: "attn" | "mamba"
    pattern: tuple = ("attn",)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    mlp: str = "swiglu"           # swiglu | geglu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()    # qwen2-vl M-RoPE (t, h, w) head_dim split
    sliding_window: int = 0       # 0 = full causal; >0 = SWA window
    embed_source: str = "tokens"  # tokens | patches (vlm) | codec (audio)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq_len: int = 524288
    # numerics
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    moment_dtype: str = "float32"
    remat: bool = False

    # ---- derived -----------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def pattern_period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.pattern_period == 0, \
            f"{self.name}: n_layers={self.n_layers} not divisible by " \
            f"pattern period {self.pattern_period}"
        return self.n_layers // self.pattern_period

    def layer_kind(self, pattern_idx: int) -> str:
        return self.pattern[pattern_idx]

    def layer_uses_moe(self, pattern_idx: int) -> bool:
        if self.moe is None:
            return False
        return pattern_idx % self.moe.every == (self.moe.every - 1)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.activ_dtype)

    @property
    def is_subquadratic(self) -> bool:
        """May run long_500k decode: SSM/hybrid or sliding-window attention."""
        return (self.family in ("ssm", "hybrid")) or self.sliding_window > 0

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter counts for roofline MODEL_FLOPS = 6 N D --------------

    def param_counts(self) -> dict:
        d, hd = self.d_model, self.resolved_head_dim
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_pattern = []
        for pi, kind in enumerate(self.pattern):
            n = 0
            if kind == "attn":
                n += d * self.n_heads * hd * 2              # wq, wo
                n += d * self.n_kv_heads * hd * 2           # wk, wv
            else:  # mamba
                mc = self.mamba
                di = mc.d_inner(d)
                n += d * (2 * di + 2 * mc.n_groups * mc.d_state
                          + mc.n_heads(d))                   # in_proj
                n += di * d                                  # out_proj
                n += (di + 2 * mc.n_groups * mc.d_state) * mc.d_conv
            # MLP / MoE
            if self.layer_uses_moe(pi):
                m = self.moe
                n += m.n_experts * 3 * d * m.d_expert
                n += 3 * d * m.shared_hidden if m.n_shared else 0
                n += d * m.n_experts                         # router
            else:
                n += 3 * d * self.d_ff
            per_pattern.append(n)
        body = self.n_blocks * sum(per_pattern)
        # active params (MoE: top_k + shared experts only)
        active_pp = []
        for pi, kind in enumerate(self.pattern):
            n = per_pattern[pi]
            if self.layer_uses_moe(pi):
                m = self.moe
                n -= m.n_experts * 3 * d * m.d_expert
                n += m.top_k * 3 * d * m.d_expert
            active_pp.append(n)
        active = self.n_blocks * sum(active_pp)
        return {"total": body + embed, "body": body, "embed": embed,
                "active": active + embed}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "gemma-7b",
    "qwen2-moe-a2.7b",
    "llama4-maverick-400b-a17b",
    "mamba2-130m",
    "musicgen-large",
    "qwen3-32b",
    "granite-3-2b",
    "qwen2-vl-2b",
    "yi-6b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict:
    """Every registered architecture's config, by id."""
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}

"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + 1 shared,
MoE interleaved every other layer, early-fusion multimodal (text backbone
here; fusion enters via embeddings) [hf:meta-llama/Llama-4-Scout-17B-16E].
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    ref="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("attn", "attn"),       # period 2: dense layer + MoE layer
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                  n_shared=1, d_shared=8192, every=2),
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    moment_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="llama4-smoke",
    family="moe",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    pattern=("attn", "attn"),
    moe=MoEConfig(n_experts=4, top_k=1, d_expert=256,
                  n_shared=1, d_shared=256, every=2),
)

"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887, Jamba-1.5].

72 layers = 9 blocks of 8 (7 Mamba + 1 attention at position 3, matching
Jamba's one-attention-per-8 placement); MoE every other layer (16 experts,
top-2).  GQA: 64 query heads over 8 KV heads.
"""

from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    ref="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
    mlp="swiglu",
    sliding_window=0,          # long_500k decode: attn layers get SWA variant
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    moment_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="jamba-smoke",
    family="hybrid",
    ref=CONFIG.ref,
    n_layers=2,                # one pattern period, reduced
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("mamba", "attn"),
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=512, every=2),
    mamba=MambaConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk=64),
)

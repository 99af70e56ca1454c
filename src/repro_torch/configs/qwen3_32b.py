"""qwen3-32b [dense] — qk-RMSNorm, GQA 64H/kv8, head_dim=128
[hf:Qwen/Qwen3-8B family card scaled per assignment]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    ref="hf:Qwen/Qwen3-8B",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,              # qwen3 uses decoupled head_dim (64*128 > d)
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="qwen3-smoke",
    family="dense",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    qk_norm=True,
)

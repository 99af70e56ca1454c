"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

Per-expert FFN hidden 1408; shared-expert hidden 5632 (= 4×1408).
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    ref="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632, every=1,
                  pad_to=64),   # 64 divides the 16-wide mesh axes
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="qwen2-moe-smoke",
    family="moe",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                  n_shared=1, d_shared=256, every=1),
)

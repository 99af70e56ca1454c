"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (kv=16) [arXiv:2403.08295]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    ref="arXiv:2403.08295",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,              # gemma's oversized heads: 16*256 = 4096 > d
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
    tie_embeddings=True,       # gemma ties input/output embeddings
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="gemma-smoke",
    family="dense",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    mlp="geglu",
    tie_embeddings=True,
)

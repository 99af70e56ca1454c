"""granite-3-2b [dense] — GQA 32H/kv8 [hf:ibm-granite/granite-3.0-2b-base]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    ref="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="granite-smoke",
    family="dense",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
)

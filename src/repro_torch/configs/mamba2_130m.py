"""mamba2-130m [ssm] — pure SSD (state-space duality), attention-free
[arXiv:2405.21060].  ssm_state=128, expand=2, head_dim=64.
"""

from repro_torch.configs.base import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    ref="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,                  # attention-free
    n_kv_heads=0,
    d_ff=0,                     # mamba blocks have no separate FFN
    vocab_size=50280,
    pattern=("mamba",),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
    tie_embeddings=True,
    param_dtype="float32",      # 130M fits easily; keep f32 like the release
    activ_dtype="float32",
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    pattern=("mamba",),
    mamba=MambaConfig(d_state=32, d_conv=4, expand=2, head_dim=32,
                      n_groups=1, chunk=64),
    tie_embeddings=True,
)

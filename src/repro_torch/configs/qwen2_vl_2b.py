"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution ViT frontend (stubbed)
[arXiv:2409.12191].

The vision encoder + projector is a stub per the assignment carve-out:
``input_specs()`` supplies pre-projected patch embeddings [B, S, d_model]
plus the 3-component (t, h, w) M-RoPE position ids.  The backbone decoder
(GQA 12H/kv2, M-RoPE sections 24/20/20 frequency pairs of head_dim 128)
is fully implemented.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    ref="arXiv:2409.12191",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mrope_sections=(24, 20, 20),   # t/h/w frequency-pair split of 128/2
    embed_source="patches",
    tie_embeddings=True,
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    mrope_sections=(6, 5, 5),
    embed_source="patches",
    tie_embeddings=True,
)

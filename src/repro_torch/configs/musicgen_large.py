"""musicgen-large [audio] — decoder-only LM over EnCodec tokens
[arXiv:2306.05284].

Transformer backbone only (assignment carve-out): the EnCodec conv codec is
a stub; ``input_specs()`` feeds codebook-token ids directly (MusicGen's
native interface is discrete EnCodec codes, vocab 2048).  MHA (kv=32).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    ref="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embed_source="codec",
    param_dtype="bfloat16",
    activ_dtype="bfloat16",
    remat=True,
)

SMOKE = ArchConfig(
    name="musicgen-smoke",
    family="audio",
    ref=CONFIG.ref,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    embed_source="codec",
)

"""The LM serving slice of the port against the live JAX package, on the CPU.

JAX's ``init_lm(jax.random.key(0), SMOKE)`` weights for every architecture
of the registry (dense, GeGLU, qk-norm, M-RoPE, audio, MoE, SSM and hybrid)
are carried across with ``lm_params_from_jax``. The port's ``prefill``
logits and every cache leaf, and three ``decode_step``s, must match JAX's
within 1e-5 (f32 sums in another order through two layers; measured ≤ 4e-6),
including a sliding-window variant whose decode wraps the ring, ``qk_norm``,
a 2048-token prompt that takes JAX's ``chunked_sdpa`` branch and prompts
with explicit (shifted, left-padded) positions, masked by position at S = 8
and by index at S = 2048 as the JAX package masks them, and qwen2-vl's
M-RoPE with explicit ``positions3``; ``serve``'s greedy tokens must equal a
JAX loop of ``make_prefill_step`` / ``make_decode_step``. The MoE configs
drop the same overflowing choices on both sides, so parity needs no capacity
headroom; the port's own decode-consistency check gives MoE layers
``capacity_factor=8.0``, as the JAX package's test does. Here the ops run
their plain versions; tests/test_torch_cuda.py holds the kernels to them.
"""

from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models import lm_params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.nn.modules import param_count

TOL = 1e-5
ARCHS = ["granite-3-2b", "mamba2-130m", "gemma-7b", "yi-6b", "qwen3-32b",
         "qwen2-vl-2b", "musicgen-large", "qwen2-moe-a2.7b",
         "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"]
assert sorted(ARCHS) == sorted(ARCH_IDS)


def _setup(arch, **over):
    jc = jget(arch, smoke=True).with_(**over)
    tc = tget(arch, smoke=True).with_(**over)
    jp = JT.init_lm(jax.random.key(0), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def models():
    return {arch: _setup(arch) for arch in ARCHS}


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _cache_leaves(cache):
    return [t for layer in cache.layers for t in layer]


def _assert_caches_close(jc, tc, k_tol=TOL):
    """Every cache leaf within ``TOL``; an attention layer's keys (its
    first leaf) within ``k_tol``."""
    jl = jax.tree_util.tree_leaves(jc.layers)
    tl = _cache_leaves(tc)
    assert len(jl) == len(tl)
    keys = {id(layer.k) for layer in tc.layers
            if isinstance(layer, TT.AttnCache)}
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        tol = k_tol if id(b) in keys else TOL
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=tol, atol=tol)
    assert tc.index == int(jc.index)


def _prefill_then_decode(jc, tc, jp, tp, toks, s, max_len, steps=3,
                         k_tol=TOL):
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :s])},
                            max_len=max_len)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :s])}, max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _assert_caches_close(jcache, tcache, k_tol)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jl, jcache = JT.decode_step(jp, jc, {"tokens": jnp.asarray(tok)},
                                    jcache)
        tl, tcache = TT.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok)}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        _assert_caches_close(jcache, tcache, k_tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    jc, tc, jp, tp = models[arch]
    # mamba2-smoke's chunk is 64: S = 128 runs two chunks (the inter-chunk
    # recurrence); granite's head dim is 16
    toks = _tokens(jc.vocab_size, 2, 131)
    _prefill_then_decode(jc, tc, jp, tp, toks, 128, 140)


@pytest.mark.parametrize("over,s,max_len", [
    ({"sliding_window": 8}, 16, 24),   # ring of 8: decode overwrites slots
    ({"sliding_window": 8}, 6, 24),    # prompt shorter than the window
    ({"qk_norm": True}, 24, 30),
])
def test_attention_variants_match_jax(over, s, max_len):
    jc, tc, jp, tp = _setup("granite-3-2b", **over)
    toks = _tokens(jc.vocab_size, 2, s + 10, seed=3)
    _prefill_then_decode(jc, tc, jp, tp, toks, s, max_len, steps=10)


def test_long_prompt_matches_jax_chunked_branch(models):
    """S = 2048 takes JAX's ``chunked_sdpa`` (online softmax over 1024-key
    chunks); the port runs the same flash op at every length.  Logits and
    values within 1e-5; the rotated keys within 5e-5, because XLA's fused
    f32 sin/cos in the scanned reference lose up to 2.6e-5 at angles near
    2047 rad (measured against a float64 RoPE), where the port's RoPE stays
    within 1e-6 of it (``test_rope_is_accurate_at_long_positions``)."""
    jc, tc, jp, tp = models["granite-3-2b"]
    toks = _tokens(jc.vocab_size, 1, 2049, seed=5)
    _prefill_then_decode(jc, tc, jp, tp, toks, 2048, 2056, steps=1,
                         k_tol=5e-5)


def test_rope_is_accurate_at_long_positions():
    from repro_torch.models.layers import apply_rope

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2048, 2, 16)).astype(np.float32) * 4
    pos = np.broadcast_to(np.arange(2048, dtype=np.int32), (2, 2048))
    freqs = (1.0 / 10000.0 ** (np.arange(0, 16, 2, dtype=np.float32) / 16)) \
        .astype(np.float32)
    ang = (pos[..., None].astype(np.float32) * freqs).astype(np.float64)
    cos, sin = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    x1, x2 = x[..., :8].astype(np.float64), x[..., 8:].astype(np.float64)
    want = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_jax_loop(models, arch):
    jc, tc, jp, tp = models[arch]
    b, s, new = 3, 64, 6
    prompts = _tokens(jc.vocab_size, b, s, seed=9)
    prefill = jax.jit(jsteps.make_prefill_step(jc, max_len=s + new))
    decode = jax.jit(jsteps.make_decode_step(jc))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompts)})
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [np.asarray(nxt)]
    for _ in range(new - 1):
        nxt, _, cache = decode(jp, {"tokens": nxt[:, None]}, cache)
        want.append(np.asarray(nxt))
    out = tserve.serve(tc, tp, prompts, new, device="cpu")
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(want, 1))
    np.testing.assert_allclose(out.prefill_logits.numpy(),
                               np.asarray(logits), rtol=TOL, atol=TOL)
    assert out.decode_tokens == b * (new - 1) and out.prefill_s > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency(models, arch):
    """prefill(s) + one decode step equals prefill(s + 1) at the last
    position, within 1e-5 (the decode path's sdpa / O(1) SSD step against
    the prefill's flash / chunked SSD, in f32)."""
    _, tc, _, tp = models[arch]
    if tc.moe is not None:      # no capacity drops: S = 16 + 1 vs S = 17
        tc = tc.with_(moe=dataclasses.replace(tc.moe, capacity_factor=8.0))
    toks = torch.from_numpy(_tokens(tc.vocab_size, 2, 17, seed=2))
    want, _ = TT.prefill(tp, tc, {"tokens": toks})
    _, cache = TT.prefill(tp, tc, {"tokens": toks[:, :16]}, max_len=24)
    got, cache = TT.decode_step(tp, tc, {"tokens": toks[:, 16:]}, cache)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert cache.index == 17


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weights_carry_over_bitwise(arch):
    jc = jget(arch, smoke=True).with_(param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray,
                                  JT.init_lm(jax.random.key(0), jc))
    leaves = jax.tree_util.tree_leaves(tree)
    tp = lm_params_from_jax(tree, "cpu")
    tl = jax.tree_util.tree_leaves(tp)
    assert len(tl) == len(leaves)
    for a, t in zip(leaves, tl):
        assert str(a.dtype) == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.uint16).view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_jax_layout(models, arch):
    jc, tc, jp, _ = models[arch]
    tp = TT.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    assert param_count(tp) == sum(a.size for _, a in jflat)


def test_prefill_refuses_non_default_positions(models):
    _, tc, _, tp = models["granite-3-2b"]
    toks = torch.from_numpy(_tokens(tc.vocab_size, 2, 8))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    want, _ = TT.prefill(tp, tc, {"tokens": toks})
    got, _ = TT.prefill(tp, tc, {"tokens": toks, "positions": pos})
    assert torch.equal(got, want)
    # shifted positions are served now (their parity with the JAX
    # package: test_prefill_with_explicit_positions_matches_jax)
    shifted, _ = TT.prefill(tp, tc, {"tokens": toks, "positions": pos + 3})
    assert bool(torch.isfinite(shifted).all())
    with pytest.raises(ValueError, match="window"):
        TT.prefill(tp, tc.with_(sliding_window=5), {"tokens": toks},
                   max_len=12)


def _positions(kind: str, b: int, s: int) -> np.ndarray:
    """int32 [B, S] prompt positions: ``shifted`` rows start at 5 and 11;
    ``left_padded`` rows repeat position 0 over their first 3 and 0
    slots, then count up (a left-padded batch); ``ragged`` mixes a
    shifted row with a repeated run inside the row."""
    if kind == "shifted":
        return (np.arange(s)[None] + np.array([[5], [11]])[:b]) \
            .astype(np.int32)
    if kind == "left_padded":
        pad = np.array([3, 0])[:b, None]
        return np.maximum(np.arange(s)[None] - pad, 0).astype(np.int32)
    out = np.stack([np.arange(s) + 2, np.minimum(np.arange(s), s // 2)])
    return out[:b].astype(np.int32)


def _prefill_pos_then_decode(jc, tc, jp, tp, toks, pos, max_len, steps,
                             k_tol=TOL):
    """Prefill with explicit ``pos`` then ``steps`` decode steps at the
    positions that follow each row's last, JAX against the port."""
    s = pos.shape[1]
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :s]),
                                     "positions": jnp.asarray(pos)},
                            max_len=max_len)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :s]), "positions": torch.from_numpy(pos)}, max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _assert_caches_close(jcache, tcache, k_tol)
    greedy_j, greedy_t = [], []
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        dpos = pos[:, -1:] + 1 + i
        jl, jcache = JT.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                             "positions": jnp.asarray(dpos)},
                                    jcache)
        tl, tcache = TT.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok), "positions": torch.from_numpy(dpos)}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        _assert_caches_close(jcache, tcache, k_tol)
        greedy_j.append(np.asarray(jnp.argmax(jl, -1)))
        greedy_t.append(tl.argmax(-1).numpy())
    np.testing.assert_array_equal(np.stack(greedy_t), np.stack(greedy_j))


@pytest.mark.parametrize("kind", ["shifted", "left_padded", "ragged"])
def test_prefill_with_explicit_positions_matches_jax(models, kind):
    """S = 8: the JAX package masks by position here (``_attn_mask(pos,
    pos)``), and so must the port; prefill logits and caches within 1e-5,
    then three decode steps at the following positions with equal greedy
    tokens."""
    jc, tc, jp, tp = models["granite-3-2b"]
    toks = _tokens(jc.vocab_size, 2, 11, seed=7)
    _prefill_pos_then_decode(jc, tc, jp, tp, toks,
                             _positions(kind, 2, 8), 16, steps=3)


def test_prefill_with_positions_matches_jax_sliding_window():
    jc, tc, jp, tp = _setup("granite-3-2b", sliding_window=4)
    toks = _tokens(jc.vocab_size, 2, 11, seed=8)
    _prefill_pos_then_decode(jc, tc, jp, tp, toks,
                             _positions("left_padded", 2, 8), 16, steps=3)


def test_long_prompt_with_shifted_positions_matches_jax_chunked_branch(
        models):
    """S = 2048 with shifted positions: JAX's ``chunked_sdpa`` masks by
    index and the positions reach only RoPE and the cache, so the port
    must mask by index too (``prefill_mask_positions`` returns None);
    the rotated keys within the 5e-5 of
    ``test_long_prompt_matches_jax_chunked_branch``."""
    from repro_torch.models.layers import prefill_mask_positions

    jc, tc, jp, tp = models["granite-3-2b"]
    toks = _tokens(jc.vocab_size, 1, 2049, seed=6)
    pos = (np.arange(2048)[None] + 37).astype(np.int32)
    assert prefill_mask_positions(tc, torch.from_numpy(
        _positions("left_padded", 1, 2048) + 0)) is None
    _prefill_pos_then_decode(jc, tc, jp, tp, toks, pos, 2056, steps=1,
                             k_tol=5e-5)


def test_prefill_mask_positions_decides_once():
    from repro_torch.models.layers import prefill_mask_positions

    _, tc, _, _ = _setup("granite-3-2b")
    shifted = torch.from_numpy(_positions("shifted", 2, 8))
    padded = torch.from_numpy(_positions("left_padded", 2, 8))
    assert prefill_mask_positions(tc, shifted) is None     # arange + c
    got = prefill_mask_positions(tc, padded)
    assert got.dtype == torch.int32 and torch.equal(got, padded)
    assert prefill_mask_positions(tc, padded[:, :2048]) is not None


def test_moe_configs_raise():
    """MoE configs no longer raise: granite-smoke given an MoE FFN in
    every layer builds the ``moe`` leaves in place of ``mlp``, and
    prefills, decodes and serves on the CPU with finite logits."""
    from repro_torch.configs.base import MoEConfig
    cfg = tget("granite-3-2b", smoke=True).with_(
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=1))
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = params["blocks"]["p0_attn"]
    assert "mlp" not in layer and set(layer["moe"]) == {
        "router", "w_gate", "w_up", "w_down", "shared"}
    assert tuple(layer["moe"]["w_gate"].shape) == (cfg.n_blocks, 4, 128, 64)
    out = tserve.serve(cfg, params, _tokens(cfg.vocab_size, 2, 12), 3,
                       device="cpu")
    assert tuple(out.tokens.shape) == (2, 3)
    assert bool(torch.isfinite(out.prefill_logits).all())


def test_serve_cli_runs_the_smoke_config_on_the_cpu(capsys):
    ap = tserve.build_parser()
    assert ap.get_default("device") == "cuda"
    assert ap.get_default("arch") == "granite-3-2b"
    tserve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "16", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "serving mamba2-smoke" in out and "prefill 2x16" in out
    assert "decode 4 tokens" in out
    assert "device" in inspect.signature(tserve.serve).parameters


def test_prefill_and_decode_from_embeds_match_jax(models):
    """The ``embeds`` input (the VLM / stubbed-frontend path) in place of
    tokens."""
    jc, tc, jp, tp = models["granite-3-2b"]
    emb = np.random.default_rng(6).normal(
        size=(2, 10, jc.d_model)).astype(np.float32)
    jl, jcache = JT.prefill(jp, jc, {"embeds": jnp.asarray(emb[:, :9])},
                            max_len=12)
    tl, tcache = TT.prefill(tp, tc, {"embeds": torch.from_numpy(
        emb[:, :9])}, max_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    jl, jcache = JT.decode_step(jp, jc, {"embeds": jnp.asarray(emb[:, 9:])},
                                jcache)
    tl, tcache = TT.decode_step(tp, tc, {"embeds": torch.from_numpy(
        emb[:, 9:])}, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _assert_caches_close(jcache, tcache)


def _mrope_ids(b: int, text: int, grid: int) -> np.ndarray:
    """int32 ``[3, B, text + grid²]`` (t, h, w) ids: ``text`` text tokens
    (all three ids equal), then a ``grid × grid`` image of patches at
    temporal id ``text`` with row / column ids from ``text``; row ``r`` of
    the batch is shifted by ``2r``."""
    t = np.arange(text)
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    ids = np.stack([np.concatenate([t, np.full(grid * grid, text)]),
                    np.concatenate([t, text + rows]),
                    np.concatenate([t, text + cols])])
    return np.stack([ids + 2 * r for r in range(b)], 1).astype(np.int32)


def test_qwen2_vl_prefill_and_decode_with_positions3_match_jax(models):
    """qwen2-vl's M-RoPE with explicit ``positions3``: 4 text tokens and a
    4 × 4 patch grid (S = 20), then three decode steps at the text ids
    that follow the grid; logits and caches within 1e-5, greedy tokens
    equal."""
    jc, tc, jp, tp = models["qwen2-vl-2b"]
    b, s = 2, 20
    toks = _tokens(jc.vocab_size, b, s + 3, seed=12)
    p3 = _mrope_ids(b, 4, 4)
    jl, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :s]),
                                     "positions3": jnp.asarray(p3)},
                            max_len=s + 3)
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :s]), "positions3": torch.from_numpy(p3)}, max_len=s + 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _assert_caches_close(jcache, tcache)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        d3 = np.broadcast_to(p3.max(axis=(0, 2))[None, :, None] + 1 + i,
                             (3, b, 1)).astype(np.int32)
        jl, jcache = JT.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                             "positions3": jnp.asarray(d3)},
                                    jcache)
        tl, tcache = TT.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok), "positions3": torch.from_numpy(d3.copy())}, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        _assert_caches_close(jcache, tcache)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jl, -1)))

"""The port's LM kernel modules, references and building blocks against the
JAX package, on the CPU.

The ops run their plain PyTorch versions here (the tensors lie on the
CPU).  Plain flash attention is held to the Pallas kernel in interpret
mode and to ``ref.mha_reference`` within 2e-5 in f32 (the softmax and
the two products sum in another order), and at ragged S — which the
Pallas kernel refuses — to ``mha_reference`` only; a bf16 case takes
2e-2 (one bf16 ulp of outputs of magnitude up to ~2).  The plain SSD
chunk form is held to the Pallas kernel in interpret mode within 2e-5;
the port's chunked scan to JAX's ``ssd_chunked`` within 1e-5 and to the
sequential oracle ``ref.ssd_reference`` within 1e-4 (the JAX package's
own tolerance for that pair).  The CUDA kernels are held to these plain
versions on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg_base
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd
from repro.models import mamba2 as jm
from repro.nn import modules as jmod
from repro_torch.configs import base as tcfg_base
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
from repro_torch.models import mamba2 as tm
from repro_torch.nn import modules as tmod


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, b, h, kv, s, d):
    return tuple(rng.normal(0, 1, shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))


# ---------------------------------------------------------------------------
# flash attention (plain version through ops.mha)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,kv,s,d", [
    (1, 2, 2, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA 2:1
    (1, 8, 1, 128, 128),     # MQA
    (1, 2, 2, 384, 256),     # gemma-sized heads
])
def test_mha_plain_matches_pallas_and_reference(b, h, kv, s, d):
    q, k, v = _qkv(np.random.default_rng(s + d + h), b, h, kv, s, d)
    got = tops.mha(_t(q), _t(k), _t(v), causal=True).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(pallas_flash(jq, jk, jv, causal=True,
                                     interpret=True)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.mha_reference(jq, jk, jv, causal=True)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [64, 128, 200])
def test_mha_plain_sliding_window(window):
    q, k, v = _qkv(np.random.default_rng(window), 1, 2, 2, 256, 64)
    got = tops.mha(_t(q), _t(k), _t(v), causal=True, window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(pallas_flash(jq, jk, jv, causal=True, window=window,
                                     interpret=True)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.mha_reference(jq, jk, jv, causal=True,
                                           window=window)),
        rtol=2e-5, atol=2e-5)


def test_mha_plain_noncausal():
    q, k, v = _qkv(np.random.default_rng(7), 1, 2, 2, 128, 64)
    got = tops.mha(_t(q), _t(k), _t(v), causal=False).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(pallas_flash(jq, jk, jv, causal=False,
                                     interpret=True)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(jref.mha_reference(jq, jk, jv, causal=False)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 50)])
def test_mha_plain_ragged_length_matches_reference(causal, window):
    """S = 200 is no multiple of the Pallas kernel's 128-row blocks; the
    port serves any length, held to ``mha_reference``."""
    q, k, v = _qkv(np.random.default_rng(200), 2, 4, 2, 200, 64)
    got = tops.mha(_t(q), _t(k), _t(v), causal=causal,
                   window=window).numpy()
    want = jref.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_mha_plain_bf16_matches_reference():
    q, k, v = _qkv(np.random.default_rng(3), 2, 4, 2, 128, 64)
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    got = tops.mha(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want = jref.mha_reference(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_mha_takes_strided_model_layout():
    """The model hands ``[B, S, H, D]`` tensors over as transposed views:
    the result equals the contiguous call."""
    q, k, v = _qkv(np.random.default_rng(5), 2, 4, 2, 96, 32)
    views = [_t(a).transpose(1, 2).contiguous().transpose(1, 2)
             for a in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(tops.mha(*views, causal=True, window=40),
                               tops.mha(_t(q), _t(k), _t(v), causal=True,
                                        window=40), rtol=0, atol=0)


def test_mha_references_agree():
    """The port's ``mha_reference`` against JAX's, and the plain kernel
    version against both, down to a diagonal-only window (window 1)."""
    q, k, v = _qkv(np.random.default_rng(11), 1, 4, 1, 64, 16)
    for causal, window in ((True, 0), (True, 1), (False, 8)):
        want = np.asarray(jref.mha_reference(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            window=window))
        ours = tref.mha_reference(_t(q), _t(k), _t(v), causal=causal,
                                  window=window).numpy()
        np.testing.assert_allclose(ours, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            flash_attention_plain(_t(q), _t(k), _t(v), causal,
                                  window).numpy(), want,
            rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# SSD chunk form (plain version through ops.ssd_chunk)
# ---------------------------------------------------------------------------


def _ssd_chunk_inputs(rng, b, nc, q, h, p, g, n):
    x = rng.normal(0, 1, (b, nc, q, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, nc, q, h)).astype(np.float32)
    a = -np.exp(rng.uniform(-1, 1, (h,)).astype(np.float32))
    cum = np.asarray(jnp.cumsum(jnp.asarray(dt * a), axis=2))
    bb = rng.normal(0, 1, (b, nc, q, g, n)).astype(np.float32)
    cc = rng.normal(0, 1, (b, nc, q, g, n)).astype(np.float32)
    return x, dt, cum, bb, cc


@pytest.mark.parametrize("q,h,p,n,g", [(64, 4, 32, 16, 4), (128, 2, 64, 128, 2),
                                       (32, 8, 16, 32, 8), (64, 4, 32, 16, 1),
                                       (32, 8, 16, 32, 2)])
def test_ssd_chunk_plain_matches_pallas(q, h, p, n, g):
    """B and C go to the port un-expanded ``[.., G, N]`` and to the Pallas
    kernel repeated to the heads (``g == h`` are the JAX package's own
    test shapes)."""
    x, dt, cum, bb, cc = _ssd_chunk_inputs(np.random.default_rng(q + n + g),
                                           2, 3, q, h, p, g, n)
    y, s = tops.ssd_chunk(*(_t(a) for a in (x, dt, cum, bb, cc)))
    rep = h // g
    jy, js = pallas_ssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(cum),
                        jnp.repeat(jnp.asarray(bb), rep, axis=3),
                        jnp.repeat(jnp.asarray(cc), rep, axis=3),
                        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-5,
                               atol=2e-5)


def _ssd_scan_inputs(rng, b, t, h, p, g, n):
    return (rng.normal(0, 1, (b, t, h, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, t, h)).astype(np.float32),
            rng.uniform(-1, 1, (h,)).astype(np.float32),
            rng.normal(0, 1, (b, t, g, n)).astype(np.float32),
            rng.normal(0, 1, (b, t, g, n)).astype(np.float32),
            rng.normal(0, 1, (h,)).astype(np.float32))


@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 32), (96, 96)])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_sequential(t, chunk, g):
    args = _ssd_scan_inputs(np.random.default_rng(t + chunk + g), 2, t, 4,
                            16, g, 8)
    y, _ = tm.ssd_chunked(*(_t(a) for a in args), chunk=chunk)
    want = jref.ssd_reference(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tref.ssd_reference(*(_t(a) for a in args))
                               .numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t,chunk,g", [(64, 16, 1), (128, 64, 2)])
def test_ssd_chunked_matches_jax_chunked(t, chunk, g):
    args = _ssd_scan_inputs(np.random.default_rng(t * g), 2, t, 4, 16, g, 8)
    init = np.random.default_rng(1).normal(0, 1, (2, 4, 16, 8)) \
        .astype(np.float32)
    y, st = tm.ssd_chunked(*(_t(a) for a in args), chunk=chunk,
                           initial_state=_t(init))
    jy, jst = jm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk,
                             initial_state=jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)


def test_ssd_chunked_refuses_ragged_chunks():
    args = _ssd_scan_inputs(np.random.default_rng(0), 1, 40, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="chunk"):
        tm.ssd_chunked(*(_t(a) for a in args), chunk=16)


# ---------------------------------------------------------------------------
# building blocks and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    gamma = rng.normal(0, 0.1, (64,)).astype(np.float32)
    want = np.asarray(jmod.rms_norm(jnp.asarray(x, dtype),
                                    jnp.asarray(gamma, dtype), 1e-5),
                      np.float32)
    got = tmod.rms_norm(_t(x).to(tcfg_base.torch_dtype(dtype)),
                        _t(gamma).to(tcfg_base.torch_dtype(dtype)), 1e-5)
    assert got.dtype == tcfg_base.torch_dtype(dtype)
    # f32: a different rsqrt/sum order; bf16: one ulp of the rounded output
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_cross_entropy_and_param_count_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (4, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tmod.softmax_cross_entropy(_t(logits), _t(labels)).numpy(),
        np.asarray(jmod.softmax_cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)
    tree = {"a": jnp.zeros((3, 4)), "b": [jnp.zeros(5), jnp.zeros((2, 2))]}
    ttree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5),
                                           torch.zeros(2, 2)]}
    assert tmod.param_count(ttree) == jmod.param_count(tree) == 21


@pytest.mark.parametrize("arch", jcfg_base.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_jax(arch, smoke):
    jc = jcfg_base.get_config(arch, smoke=smoke)
    tc = tcfg_base.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_counts() == jc.param_counts()
    assert tc.n_blocks == jc.n_blocks
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.pdtype == tcfg_base.torch_dtype(jc.param_dtype)
    assert str(jnp.dtype(jc.param_dtype)) == jc.param_dtype


def test_unported_configs_raise():
    """No id is left unported: ``get_config`` serves every id of the JAX
    registry, and each id's ``CONFIG`` and ``SMOKE`` equal the JAX
    package's field for field (the MoE and Mamba sub-configs included);
    an unknown id and an unknown dtype still raise."""
    assert tcfg_base.ARCH_IDS == jcfg_base.ARCH_IDS
    for arch in tcfg_base.ARCH_IDS:
        for smoke in (False, True):
            jc = jcfg_base.get_config(arch, smoke=smoke)
            tc = tcfg_base.get_config(arch, smoke=smoke)
            assert [f.name for f in dataclasses.fields(tc)] == \
                [f.name for f in dataclasses.fields(jc)]
            for f in dataclasses.fields(jc):
                want, got = getattr(jc, f.name), getattr(tc, f.name)
                if dataclasses.is_dataclass(want):
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (arch, f.name)
                else:
                    assert got == want, (arch, smoke, f.name)
    with pytest.raises(KeyError):
        tcfg_base.get_config("no-such-arch")
    with pytest.raises(ValueError):
        tcfg_base.torch_dtype("int4")


def test_mamba_init_matches_jax_layout():
    cfg_j = jcfg_base.get_config("mamba2-130m", smoke=True)
    cfg_t = tcfg_base.get_config("mamba2-130m", smoke=True)
    jp = jm.init_mamba(jax.random.key(0), cfg_j)
    tp = tm.init_mamba(torch.Generator().manual_seed(0), cfg_t)
    assert set(jp) == set(tp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    # log(1..H): torch's and XLA's f32 log may differ in the last ulp
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(tp["dt_bias"].double())
    assert float(dt.min()) >= 0.001 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6


# ---------------------------------------------------------------------------
# layer primitives the ported configs do not reach: the linear-cache decode
# branch of ``attention``, M-RoPE and GeGLU
# ---------------------------------------------------------------------------


def _layer_setup(**over):
    from repro.models import layers as jl
    from repro_torch.models import lm_params_from_jax

    jc = jcfg_base.get_config("granite-3-2b", smoke=True).with_(**over)
    tc = tcfg_base.get_config("granite-3-2b", smoke=True).with_(**over)
    jp = jl.init_attn(jax.random.key(3), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("over", [{}, {"sliding_window": 6, "qk_norm": True}])
def test_attention_layer_matches_jax_prefill_and_linear_cache_decode(over):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    jc, tc, jp, tp = _layer_setup(**over)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 12, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jy, jkv = jl.attention(jp, jc, jnp.asarray(x), jnp.asarray(pos))
    ty, tkv = tl.attention(tp, tc, _t(x), _t(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(jkv, tkv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    # decode one token into a 16-slot linear cache holding the prompt
    pad = ((0, 0), (0, 4), (0, 0), (0, 0))
    jcache = jl.KVCache(*(jnp.pad(a, pad) for a in jkv))
    tcache = tl.KVCache(*(torch.from_numpy(np.pad(np.asarray(a), pad))
                          for a in jkv))
    x1 = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    p1 = np.full((2, 1), 12, np.int32)
    jy, jkv = jl.attention(jp, jc, jnp.asarray(x1), jnp.asarray(p1),
                           cache=jcache, cache_index=jnp.int32(12))
    ty, tkv = tl.attention(tp, tc, _t(x1), _t(p1), cache=tcache,
                           cache_index=12)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(jkv, tkv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
    assert tcache.k[:, 12].abs().max() == 0   # the input cache is kept


def test_mrope_matches_jax():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 10, 3, 16)).astype(np.float32)
    p3 = rng.integers(0, 50, (3, 2, 10)).astype(np.int32)
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 10000.0,
                          (2, 3, 3))
    got = tl.apply_mrope(_t(x), _t(p3), 10000.0, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(_t(x), _t(p3), 10000.0, (2, 3, 2))


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_mlp_matches_jax(kind):
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    p = jl.init_mlp(jax.random.key(4), 32, 64, jnp.float32)
    x = np.random.default_rng(5).normal(size=(3, 7, 32)).astype(np.float32)
    want = jl.mlp(p, jnp.asarray(x), kind)
    got = tl.mlp({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# flash kernel choice and the smoke run's work counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
])
def test_flash_kernel_choice_by_dtype_and_head_dim(dtype, d, kernel):
    """bf16 at every full-size config's head dim takes the wgmma kernel,
    bf16 at the smoke configs' narrow heads the mma.sync kernel (both
    tensor cores); f32 takes the CUDA-core kernel at every head dim."""
    from repro_torch.kernels import flash_attention as tfa

    assert tfa.kernel_for(dtype, d) == kernel
    # each kernel refuses a CPU tensor rather than run something else
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    fn = tfa._KERNELS[kernel]
    assert fn.__name__ == f"flash_attention_{kernel}"
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, q, q)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attn_mask(s, causal, window):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window > 0:
        keep &= j > i - window
    return keep


@pytest.mark.parametrize("arch,dtype,kernel", [
    ("granite-3-2b", "bfloat16", "flash_attention_mma"),     # D = 16
    ("yi-6b", "bfloat16", "flash_attention_mma"),            # D = 32
    ("granite-3-2b", "float32", "flash_attention_simt"),
    ("yi-6b", "float32", "flash_attention_simt"),
])
def test_smoke_expected_launches_name_the_flash_kernel(arch, dtype, kernel):
    """``chip_smoke.expected_launches``: a bf16 SMOKE config (head dim 16
    or 32) launches the narrow-head kernel once per attention layer, an
    f32 one the CUDA-core kernel, and no other flash kernel runs; granite's
    full-size bf16 config (head dim 64) launches the wgmma kernel."""
    cs = _chip_smoke()
    smoke = tcfg_base.get_config(arch, smoke=True).with_(
        param_dtype=dtype, activ_dtype=dtype)
    n_attn = smoke.n_blocks * smoke.pattern.count("attn")
    assert n_attn > 0
    want = dict.fromkeys(cs.LM_KERNELS, 0)
    assert cs.expected_launches(smoke) == {**want, kernel: n_attn}
    full = tcfg_base.get_config("granite-3-2b")
    assert full.activ_dtype == "bfloat16" and full.resolved_head_dim == 64
    assert cs.expected_launches(full) == {**want,
                                          "flash_attention": full.n_layers}
    assert set(cs.FLASH_NAMES.values()) <= set(cs.LM_KERNELS) <= \
        set(cs.KERNELS)


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (7, True, 0), (130, True, 0), (130, False, 0),
    (130, True, 16), (130, False, 16), (64, True, 64), (50, True, 100)])
def test_smoke_attention_pair_count_is_the_masks_count(s, causal, window):
    """``chip_smoke._attn_pairs`` (the flash bound's work) equals the
    number of (query, key) pairs the plain version's mask keeps."""
    assert _chip_smoke()._attn_pairs(s, causal, window) == \
        int(_attn_mask(s, causal, window).sum())


@pytest.mark.parametrize("b,nc,q,h,p,g,n", [
    (1, 1, 5, 1, 3, 1, 2), (2, 3, 8, 4, 4, 1, 6), (1, 2, 9, 6, 2, 2, 3),
    (2, 1, 4, 2, 5, 2, 7)])
def test_smoke_ssd_flop_count_is_the_nonzero_products(b, nc, q, h, p, g, n):
    """``chip_smoke._ssd_flops`` counts 2 flops per product the inputs
    need: C·Bᵀ once per (batch, chunk, group) on the causal pairs, M·X
    per head on those pairs, the state per head on every row — counted
    here one product at a time by walking the masks."""
    causal = _attn_mask(q, True, 0)
    products = 0
    for _ in range(b * nc):
        for _ in range(g):                            # C·Bᵀ per group
            products += sum(n for t in range(q) for s in range(q)
                            if causal[t, s])
        for _ in range(h):                            # per head
            products += sum(p for t in range(q) for s in range(q)
                            if causal[t, s])          # M·X
            products += q * p * n                     # Xᵀ (w B)
    got = _chip_smoke()._ssd_flops(b, nc, q, h, p, g, n)
    assert got == 2 * products
    # the per-head count of the previous bound is larger whenever H > G
    pairs = q * (q + 1) // 2
    per_head = 2.0 * b * nc * h * (pairs * n + pairs * p + q * p * n)
    assert (got < per_head) == (h > g)


def _position_batch(rng, b, s):
    """Rows of prompt positions: shifted, left-padded (a run of 0s), and
    one with a repeated run inside."""
    rows = [np.arange(s) + rng.integers(1, 50),
            np.maximum(np.arange(s) - rng.integers(1, s // 2), 0),
            np.minimum(np.arange(s), s // 3 + rng.integers(0, s // 3))]
    return np.stack([rows[i % 3] for i in range(b)]).astype(np.int32)


@pytest.mark.parametrize("s,window", [(40, 0), (40, 7), (130, 0)])
def test_flash_plain_with_positions_matches_jax_sdpa(s, window):
    """The position mask of the JAX package's prefill: plain flash with
    ``q_pos = k_pos = positions`` against ``layers.sdpa`` under
    ``_attn_mask(positions, positions, window)`` within 2e-5 (f32)."""
    from repro.models import layers as jl

    rng = np.random.default_rng(s + window)
    b, h, kv, d = 3, 4, 2, 16
    q, k, v = _qkv(rng, b, h, kv, s, d)
    pos = _position_batch(rng, b, s)
    mask = jl._attn_mask(jnp.asarray(pos), jnp.asarray(pos), window)
    want = jl.sdpa(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                     for a in (q, k, v)), mask)
    tp = torch.from_numpy(pos)
    got = tops.mha(_t(q), _t(k), _t(v), causal=True, window=window,
                   q_pos=tp, k_pos=tp)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)
    ref = tref.mha_reference(_t(q), _t(k), _t(v), causal=True,
                             window=window, q_pos=tp, k_pos=tp)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,q_tile,key_tile,window",
                         [(300, 64, 64, 0), (300, 128, 128, 0),
                          (300, 128, 64, 50), (77, 128, 128, 9),
                          # the CUDA-core kernel's tiles (D <= 64, D >= 128)
                          # and the narrow-head kernel's
                          (300, 128, 64, 0), (300, 64, 32, 0),
                          (300, 64, 32, 40), (130, 64, 32, 7),
                          (300, 64, 128, 0), (300, 64, 128, 100),
                          (77, 64, 128, 9)])
def test_position_key_ranges_cover_every_live_key(s, q_tile, key_tile,
                                                  window):
    """The key range the kernels walk per query tile holds every key the
    position mask keeps for any query of the tile, starts on a key-tile
    boundary and leaves out whole tiles only; the run of tiles the
    kernels leave unmasked lies inside it, in whole tiles within S, and
    the mask keeps every key of it for every query of the tile."""
    from repro_torch.kernels.flash_attention import (attention_mask,
                                                     position_key_ranges)

    rng = np.random.default_rng(s + q_tile + window)
    pos = torch.from_numpy(_position_batch(rng, 3, s))
    ranges = position_key_ranges(pos, pos, True, window, q_tile, key_tile)
    n_qt = -(-s // q_tile)
    assert ranges.dtype == torch.int32 and \
        tuple(ranges.shape) == (3, n_qt, 4)
    mask = attention_mask(s, True, window, "cpu", pos, pos)   # [B, S, S]
    keys = torch.arange(s)
    runs = 0
    for bi in range(3):
        for t in range(n_qt):
            lo, hi, f_lo, f_hi = (int(x) for x in ranges[bi, t])
            assert lo % key_tile == 0 and 0 <= lo < hi <= s
            rows = mask[bi, t * q_tile:(t + 1) * q_tile]
            assert bool(((keys >= lo) & (keys < hi))[rows.any(0)].all())
            assert f_lo % key_tile == 0 and f_hi % key_tile == 0
            if f_hi > f_lo:
                runs += 1
                assert lo <= f_lo and f_hi <= hi
                assert bool(rows[:, f_lo:f_hi].all())
            else:
                assert f_lo == f_hi == 0
    assert runs > 0 or s < 2 * key_tile      # no whole tile fits
    # arange positions give the index walk's causal ranges
    ar = torch.arange(s, dtype=torch.int32).expand(2, s).contiguous()
    r = position_key_ranges(ar, ar, True, 0, q_tile, key_tile)
    q_last = torch.clamp((torch.arange(n_qt) + 1) * q_tile, max=s) - 1
    assert bool((r[..., 0] == 0).all())
    assert torch.equal(r[0, :, 1].long(), torch.clamp(
        (q_last // key_tile + 1) * key_tile, max=s))
    # the whole tiles: those wholly at or below the query tile's first row
    q0 = torch.arange(n_qt) * q_tile
    assert torch.equal(r[0, :, 3].long(), (q0 + 1) // key_tile * key_tile)

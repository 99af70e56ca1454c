"""The port's MoE FFN (``repro_torch.models.moe``) against the live JAX
package's ``repro.models.moe``, on the CPU.

JAX's ``init_moe`` weights are carried across with ``lm_params_from_jax``
and the same seeded input runs through both ``moe_ffn``s. In f32 the output
must match within 1e-5 and the router aux loss within 1e-6 relative (sums in
another order). In bf16 within 2^-6 of the largest output, two bf16 ulps at
the output's scale: XLA and torch round the bf16 SiLU differently in about a
third of its elements, and each such ulp carries through the down projection
(measured ≤ 0.0096 of the largest output over 18 seeded cases of the three
configs). The routing itself must be exact: each token's top-k expert
indices (lower index first on ties, as ``jax.lax.top_k``), each choice's
slot and the kept mask (``slot < capacity``) equal JAX's, including an input
with exact router ties, a forced overflow (``capacity_factor=0.5``) where
most choices drop, padded experts (``pad_to``) that no token reaches, and
two token groups.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import moe as JM
from repro_torch.configs.base import get_config as tget
from repro_torch.models import lm_params_from_jax
from repro_torch.models import moe as TM

MOE_ARCHS = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
             "jamba-1.5-large-398b"]
TOL, AUX_RTOL = 1e-5, 1e-6
BF16_REL = 2.0 ** -6


def _configs(arch, dtype="float32", **moe_over):
    jc = jget(arch, smoke=True)
    tc = tget(arch, smoke=True)
    over = dict(param_dtype=dtype, activ_dtype=dtype)
    return (jc.with_(moe=dataclasses.replace(jc.moe, **moe_over), **over),
            tc.with_(moe=dataclasses.replace(tc.moe, **moe_over), **over))


def _params(jc, seed=1, tie=None):
    """JAX ``init_moe`` weights and the port's copy; ``tie=(a, b)`` makes
    router column ``b`` equal column ``a`` (every token ties there)."""
    jp = JM.init_moe(jax.random.key(seed), jc)
    if tie is not None:
        a, b = tie
        jp["router"] = jp["router"].at[:, b].set(jp["router"][:, a])
    return jp, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")


def _input(jc, b=2, s=24, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, jc.d_model)).astype(np.float32)


def _jax_routing(jp, jc, x):
    """Expert indices [T, K], slots and the kept mask [T·K] as the JAX
    package's
    ``moe_ffn`` computes them (``repro/models/moe.py``, G = 1)."""
    m = jc.moe
    xt = x.reshape(-1, jc.d_model)
    logits = (xt @ jp["router"]).astype(jnp.float32)
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    fe = expert_idx.reshape(1, -1)
    onehot = jax.nn.one_hot(fe, m.e_padded, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.take_along_axis(pos_all, fe[..., None], axis=2)[..., 0]
    cap = JM._group_capacity(m, xt.shape[0])
    return np.asarray(expert_idx), np.asarray(pos)[0], \
        np.asarray(pos < cap)[0]


def _run(jc, tc, jp, tp, x, dtype="float32"):
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jo, ja = JM.moe_ffn(jp, jc, jx)
    to, ta = TM.moe_ffn(tp, tc, tx)
    assert to.dtype == tx.dtype and tuple(to.shape) == x.shape
    assert ta.dtype == torch.float32
    got, want = to.float().numpy(), np.asarray(jo.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL, atol=0)
    # routing: exact
    want_idx, want_pos, want_keep = _jax_routing(jp, jc, jx)
    xt = tx.reshape(-1, tc.d_model)
    _, _, idx = TM.route(tp, tc.moe, xt)
    _, pos, keep = TM.slots(idx, tc.moe, 1, TM.group_capacity(
        tc.moe, xt.shape[0]))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(pos[0].numpy(), want_pos)
    np.testing.assert_array_equal(keep[0].numpy(), want_keep)
    return idx.numpy(), keep[0].numpy()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    _run(jc, tc, jp, tp, _input(jc))


def test_moe_ffn_bf16_matches_jax():
    """bf16 weights and activations: the router logits round to bf16
    before the f32 softmax on both sides, so the choices stay exact."""
    jc, tc = _configs("qwen2-moe-a2.7b", "bfloat16")
    jp, tp = _params(jc, seed=2)
    _run(jc, tc, jp, tp, _input(jc, seed=3), "bfloat16")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_moe_ffn_forced_overflow_drops_as_jax(arch):
    """capacity_factor 0.5 with 96 tokens: a third of the choices or more
    overflow their expert; the dropped set equals JAX's."""
    jc, tc = _configs(arch, capacity_factor=0.5)
    jp, tp = _params(jc, seed=4)
    _, keep = _run(jc, tc, jp, tp, _input(jc, b=4, s=24, seed=5))
    assert 0 < keep.sum() < 0.67 * keep.size


def test_moe_ffn_padded_experts_get_no_tokens():
    jc, tc = _configs("qwen2-moe-a2.7b", pad_to=8)
    assert tc.moe.e_padded == 8 and tc.moe.n_experts == 4
    jp, tp = _params(jc, seed=6)
    assert tuple(tp["w_gate"].shape) == (8, tc.d_model, tc.moe.d_expert)
    idx, _ = _run(jc, tc, jp, tp, _input(jc, seed=7))
    assert idx.max() < tc.moe.n_experts


def test_moe_ffn_exact_router_ties_pick_the_lower_index():
    """Router columns 1 and 2 equal (every token ties there) and all-zero
    rows (every expert ties): the lower index comes first, as in
    ``jax.lax.top_k``."""
    jc, tc = _configs("qwen2-moe-a2.7b")
    jp, tp = _params(jc, seed=8, tie=(1, 2))
    x = _input(jc, seed=9)
    x[0, :5] = 0.0
    idx, _ = _run(jc, tc, jp, tp, x)
    np.testing.assert_array_equal(idx[:5], np.tile([0, 1], (5, 1)))
    both = (idx == 1).any(-1) & (idx == 2).any(-1)
    one = (idx == 1).any(-1) | (idx == 2).any(-1)
    # where exactly one of the tied pair is chosen, it is expert 1
    assert not ((idx == 2).any(-1) & ~(idx == 1).any(-1)).any()
    assert one.sum() > both.sum()


def test_moe_ffn_two_groups_match_jax(monkeypatch):
    """G = 2 token groups, each with its own capacity and slot count (the
    layout under a data mesh of 2; both packages' ``dispatch_groups`` are
    pinned to 2 here), under forced overflow."""
    monkeypatch.setattr(JM, "dispatch_groups", lambda: 2)
    monkeypatch.setattr(TM, "dispatch_groups", lambda: 2)
    jc, tc = _configs("qwen2-moe-a2.7b", capacity_factor=0.5)
    jp, tp = _params(jc, seed=10)
    x = _input(jc, b=4, s=12, seed=11)
    jo, ja = JM.moe_ffn(jp, jc, jnp.asarray(x))
    to, ta = TM.moe_ffn(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL, atol=0)
    monkeypatch.setattr(TM, "dispatch_groups", lambda: 1)
    one, _ = TM.moe_ffn(tp, tc, torch.from_numpy(x))
    assert not torch.allclose(one, to, rtol=TOL, atol=TOL)


def test_group_capacity_matches_jax():
    for arch in MOE_ARCHS:
        for tokens in (8, 48, 16384):
            jm, tm = jget(arch).moe, tget(arch).moe
            assert TM.group_capacity(tm, tokens) == \
                JM._group_capacity(jm, tokens)
    # qwen2-moe's decode step at batch 8: capacity 4 (the floor)
    assert TM.group_capacity(tget("qwen2-moe-a2.7b").moe, 8) == 4


def test_init_moe_matches_jax_layout():
    for arch in MOE_ARCHS:
        jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
        jp = JM.init_moe(jax.random.key(0), jc)
        tp = TM.init_moe(torch.Generator().manual_seed(0), tc, lead=(3,))
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
            [jax.tree_util.keystr(p) for p, _ in tflat]
        for (_, a), (_, t) in zip(jflat, tflat):
            assert tuple(t.shape) == (3, *a.shape)
            # the JAX scales: std 1/sqrt(fan-in) within 10%
            assert abs(float(t.float().std()) / float(np.std(a)) - 1) < 0.1

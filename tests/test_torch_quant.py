"""The port's fused quantised-wire codecs, the autograd wiring of its wire
and aggregation ops, its optimisers and its policy layer, against the
live JAX package on the CPU (the plain versions run: the tensors lie on
the CPU).

Held: the fused codecs bitwise against ``ref.pack_quant_reference`` /
``unpack_quant_reference``, the Pallas kernels in interpret mode and, for
mixed per-row widths, JAX's ``quant_levels`` + ``pack_bits``; the VJPs of
``wire_pack``, ``wire_unpack``, ``ell_aggregate`` and the sub-byte hop
within 1e-6 of ``jax.grad`` (f32 sums in another order); ``sgd``/``adamw``
within 1e-6; policies, schedules and their string forms equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as jsched
from repro.core.varco import CommPolicy as JPolicy
from repro.dist.halo import build_reverse_ell
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.train import optim as joptim
from repro_torch.core import schedulers as tsched
from repro_torch.core.varco import CommPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import varco_pack as tvp
from repro_torch.nn.gnn import params_from_jax
from repro_torch.train import optim as toptim

LANE = 128
GRAD_TOL = 1e-6


def _masks(rng, nb, k):
    kept = np.sort(rng.choice(nb, k, replace=False)).astype(np.int32)
    inv = np.full(nb, -1, np.int32)
    inv[kept] = np.arange(k, dtype=np.int32)
    return kept, inv


def _rows(rng, n, f):
    x = rng.normal(size=(n, f)).astype(np.float32)
    if n > 2:
        x[1, :LANE] = 0.0                               # an all-zero block
        x[2, :4] = [0.5, -0.5, 1.5, -2.5]               # rounding ties
    return x


# ---------------------------------------------------------------------------
# fused quantised codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("n,nb,k", [(1, 1, 1), (37, 2, 1), (300, 3, 2)])
def test_fused_codecs_bitwise_vs_jax(width, n, nb, k):
    rng = np.random.default_rng(width * 100 + n)
    x = _rows(rng, n, nb * LANE)
    kept, inv = _masks(rng, nb, k)
    payload, scales = tops.pack_quant(torch.from_numpy(x),
                                      torch.from_numpy(kept), width)
    jx, jk, ji = jnp.asarray(x), jnp.asarray(kept), jnp.asarray(inv)
    p_ref, s_ref = jref.pack_quant_reference(jx, jk, width)
    p_pal, s_pal = jops.pack_quant(jx, jk, width=width, interpret=True)
    assert payload.dtype == torch.uint8
    assert payload.shape == (n, k * LANE * width // 8)
    np.testing.assert_array_equal(payload.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(s_ref))
    # under jit a static width makes ``amax / qmax`` a division by a
    # constant, which XLA turns into a multiply by the f32 reciprocal: the
    # Pallas kernel's scales may sit one ulp off the IEEE quotient the
    # runtime (traced widths) and the port compute; the levels agree
    np.testing.assert_array_equal(payload.numpy(), np.asarray(p_pal))
    np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(s_pal),
                                    maxulp=1)
    pt, st = tref.pack_quant_reference(torch.from_numpy(x),
                                       torch.from_numpy(kept), width)
    assert torch.equal(pt, payload) and torch.equal(st, scales)
    out = tops.unpack_quant(payload, scales, torch.from_numpy(inv), width)
    want = jref.unpack_reference(jref.unpack_quant_reference(p_ref, s_ref,
                                                             width), ji)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jops.unpack_quant(p_ref, s_ref, ji,
                                                  width=width,
                                                  interpret=True)))
    np.testing.assert_array_equal(
        tref.unpack_quant_reference(payload, scales, width).numpy(),
        np.asarray(jref.unpack_quant_reference(p_ref, s_ref, width)))


@pytest.mark.parametrize("store_w", [4, 8])
def test_mixed_width_rows_vs_jax_quant_levels_pack_bits(store_w):
    """Per-row ``qmax`` at or below the storage width: each row equals
    JAX's ``pack_bits(quant_levels(pack(x), w_row), store_w)`` — the
    runtime's sub-byte hop under a mixed-width plan."""
    rng = np.random.default_rng(store_w)
    b, h, nb, k = 6, 41, 2, 1
    x = rng.normal(size=(b, h, nb * LANE)).astype(np.float32)
    masks = [_masks(rng, nb, k) for _ in range(b)]
    kept = np.stack([m[0] for m in masks])
    inv = np.stack([m[1] for m in masks])
    widths = np.asarray([w for w in (2, 4, 8) if w <= store_w] * b,
                        np.float32)[:b]
    qmax = tops.qmax_of(torch.from_numpy(widths))
    payload, scales = tops.pack_quant(torch.from_numpy(x),
                                      torch.from_numpy(kept), store_w, qmax)
    out = tops.unpack_quant(payload, scales, torch.from_numpy(inv), store_w)
    for i in range(b):
        hops = jops.wire_pack(jnp.asarray(x[i]), jnp.asarray(kept[i]),
                              jnp.asarray(inv[i]))
        levels, s_j = jops.quant_levels(hops, jnp.float32(widths[i]))
        p_j = jops.pack_bits(levels, store_w)
        np.testing.assert_array_equal(payload[i].numpy(), np.asarray(p_j))
        np.testing.assert_array_equal(scales[i].numpy(), np.asarray(s_j))
        sent = jops.wire_unpack(jops.dequant_bits(p_j, s_j, store_w),
                                jnp.asarray(kept[i]), jnp.asarray(inv[i]))
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(sent))


def test_quant_hop_forward_and_vjp_vs_jax_sub_byte_branch():
    """``quant_hop`` is JAX's sub-byte hop: the value rebuilt from the
    bytes, and the straight-through gradient followed by
    ``wire_unpack``'s VJP."""
    rng = np.random.default_rng(7)
    b, h, nb, store_w = 4, 23, 2, 8
    x = rng.normal(size=(b, h, nb * LANE)).astype(np.float32)
    masks = [_masks(rng, nb, 1) for _ in range(b)]
    kept = np.stack([m[0] for m in masks])
    inv = np.stack([m[1] for m in masks])
    widths = np.asarray([8, 4, 8, 2], np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jax_hop(xx):
        hops = jax.vmap(jops.wire_pack)(xx, jnp.asarray(kept),
                                        jnp.asarray(inv))
        levels, scales = jops.quant_levels(hops, jnp.asarray(widths)[:, None,
                                                                     None])
        dq = jops.dequant_bits(jops.pack_bits(levels, store_w), scales,
                               store_w)
        hq = (hops - jax.lax.stop_gradient(hops)) + \
            jax.lax.stop_gradient(dq)
        return jax.vmap(jops.wire_unpack)(hq, jnp.asarray(kept),
                                          jnp.asarray(inv))

    want, vjp = jax.vjp(jax_hop, jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tops.quant_hop(xt, torch.from_numpy(kept), torch.from_numpy(inv),
                         tops.qmax_of(torch.from_numpy(widths)), store_w)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_quant_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, LANE))
    kept = torch.zeros((1, 1), dtype=torch.int32)
    qmax = torch.ones((1,))
    before = (tvp.varco_pack_quant.launches, tvp.varco_unpack_quant.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tvp.varco_pack_quant(x, kept, qmax, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tvp.varco_unpack_quant(torch.zeros((1, 8, LANE), dtype=torch.uint8),
                               torch.ones((1, 8, 1)), kept, 8)
    with pytest.raises(ValueError, match="width"):
        tvp.varco_pack_quant(x, kept, qmax, 3)
    tops.pack_quant(x, kept, 8)                       # CPU: plain version
    assert (tvp.varco_pack_quant.launches,
            tvp.varco_unpack_quant.launches) == before


# ---------------------------------------------------------------------------
# VJPs against jax.grad
# ---------------------------------------------------------------------------


def test_wire_pack_unpack_vjps_vs_jax():
    rng = np.random.default_rng(3)
    n, nb, k = 29, 3, 2
    x = rng.normal(size=(n, nb * LANE)).astype(np.float32)
    kept, inv = _masks(rng, nb, k)
    g_p = rng.normal(size=(n, k * LANE)).astype(np.float32)
    g_u = rng.normal(size=x.shape).astype(np.float32)
    jk, ji = jnp.asarray(kept), jnp.asarray(inv)
    _, vjp_p = jax.vjp(lambda a: jops.wire_pack(a, jk, ji), jnp.asarray(x))
    packed = np.array(jops.wire_pack(jnp.asarray(x), jk, ji))
    _, vjp_u = jax.vjp(lambda a: jops.wire_unpack(a, jk, ji),
                       jnp.asarray(packed))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(packed).requires_grad_(True)
    kt, it = torch.from_numpy(kept), torch.from_numpy(inv)
    (gx,) = torch.autograd.grad(tops.wire_pack(xt, kt, it), xt,
                                torch.from_numpy(g_p))
    np.testing.assert_allclose(gx.numpy(),
                               np.asarray(vjp_p(jnp.asarray(g_p))[0]),
                               rtol=0, atol=GRAD_TOL)
    (gp,) = torch.autograd.grad(tops.wire_unpack(pt, it, kt), pt,
                                torch.from_numpy(g_u))
    np.testing.assert_allclose(gp.numpy(),
                               np.asarray(vjp_u(jnp.asarray(g_u))[0]),
                               rtol=0, atol=GRAD_TOL)
    # without the matched index map the ops are forward-only
    for y, a in ((tops.wire_pack(xt, kt), xt), (tops.wire_unpack(pt, it),
                                                pt)):
        with pytest.raises(ValueError, match="backward needs"):
            torch.autograd.grad(y.sum(), a)


def test_ell_aggregate_vjp_vs_jax():
    """dx over the reversed lists and dw (asked for explicitly), batched
    over partitions, against ``jax.grad`` of the JAX custom VJP."""
    rng = np.random.default_rng(4)
    q, p, k, f = 3, 40, 6, 128
    xs, nbrs, ws, rnbrs, rslots = [], [], [], [], []
    for _ in range(q):
        nbr = rng.integers(0, p, (p, k)).astype(np.int32)
        w = (rng.uniform(0.1, 1.0, (p, k)) / k).astype(np.float32)
        pad = rng.uniform(size=(p, k)) < 0.3
        w[pad], nbr[pad] = 0.0, 0
        rn, rs = build_reverse_ell(nbr, ~pad, p, rev_k=p)
        xs.append(rng.normal(size=(p, f)).astype(np.float32))
        nbrs.append(nbr), ws.append(w), rnbrs.append(rn), rslots.append(rs)
    x, nbr, w, rnbr, rslot = map(np.stack, (xs, nbrs, ws, rnbrs, rslots))
    g = rng.normal(size=(q, p, f)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tops.ell_aggregate(xt, torch.from_numpy(nbr), wt,
                             torch.from_numpy(rnbr), torch.from_numpy(rslot))
    gx, gw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g))
    for i in range(q):
        args = [jnp.asarray(a[i]) for a in (x, nbr, w, rnbr, rslot)]
        y, vjp = jax.vjp(lambda a, b: jops.ell_aggregate(
            a, args[1], b, args[3], args[4]), args[0], args[2])
        jx, jw = vjp(jnp.asarray(g[i]))
        np.testing.assert_allclose(out[i].detach().numpy(), np.asarray(y),
                                   rtol=0, atol=GRAD_TOL)
        np.testing.assert_allclose(gx[i].numpy(), np.asarray(jx), rtol=0,
                                   atol=GRAD_TOL)
        # dw sums F products per entry: held at 1e-6 of its magnitude
        np.testing.assert_allclose(gw[i].numpy(), np.asarray(jw), rtol=0,
                                   atol=GRAD_TOL * np.abs(jw).max())
    # without the reversed lists the op is forward-only
    y = tops.ell_aggregate(xt, torch.from_numpy(nbr), torch.from_numpy(w))
    with pytest.raises(ValueError, match="backward needs the reversed"):
        torch.autograd.grad(y.sum(), xt)


# ---------------------------------------------------------------------------
# optimisers
# ---------------------------------------------------------------------------


def _tree(rng):
    return {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)},
                       {"w": rng.normal(size=(3, 2)).astype(np.float32)}]}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"lr": 0.1}),
    ("sgd", {"lr": 0.05, "momentum": 0.9, "weight_decay": 0.01}),
    ("adamw", {"lr": 5e-3}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
])
def test_optimizers_match_jax(name, kw):
    rng = np.random.default_rng(5)
    p_np = _tree(rng)
    oj, ot = joptim.OPTIMIZERS[name](**kw), toptim.OPTIMIZERS[name](**kw)
    pj = jax.tree_util.tree_map(jnp.asarray, p_np)
    pt = params_from_jax(p_np, device="cpu")
    sj, st = oj.init(pj), ot.init(pt)
    for _ in range(3):
        g_np = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), p_np)
        uj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g_np), sj, pj)
        pj = joptim.apply_updates(pj, uj)
        ut, st = ot.update(params_from_jax(g_np, device="cpu"), st, pt)
        pt = toptim.apply_updates(pt, ut)
    for a, b in zip(jax.tree_util.tree_leaves(pj), toptim.tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=GRAD_TOL)
    assert int(st["step"]) == int(sj["step"]) == 3
    # the JAX state carries across and continues identically
    st2 = params_from_jax(jax.tree_util.tree_map(np.asarray, sj),
                          device="cpu")
    assert st2["step"].dtype == torch.int32
    g_np = jax.tree_util.tree_map(np.ones_like, p_np)
    uj, _ = oj.update(jax.tree_util.tree_map(jnp.asarray, g_np), sj, pj)
    ut, _ = ot.update(params_from_jax(g_np, device="cpu"), st2, pt)
    for a, b in zip(jax.tree_util.tree_leaves(uj), toptim.tree_leaves(ut)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=GRAD_TOL)


def test_norms_and_lr_schedules_match_jax():
    rng = np.random.default_rng(6)
    p_np = _tree(rng)
    np.testing.assert_allclose(
        float(toptim.global_norm(params_from_jax(p_np, device="cpu"))),
        float(joptim.global_norm(jax.tree_util.tree_map(jnp.asarray, p_np))),
        rtol=1e-6)
    clipped, _ = toptim.clip_by_global_norm(
        params_from_jax(p_np, device="cpu"), 0.5)
    want, _ = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, p_np), 0.5)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    toptim.tree_leaves(clipped)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for make in ("cosine_lr", "linear_decay_lr"):
        fj = getattr(joptim, make)(1e-2, 50, warmup=5)
        ft = getattr(toptim, make)(1e-2, 50, warmup=5)
        for s in (0, 3, 5, 20, 49, 60):
            np.testing.assert_allclose(float(ft(s)), float(fj(s)),
                                       rtol=0, atol=1e-6 * 1e-2)
    assert float(toptim.constant_lr(3e-3)(7)) == float(
        joptim.constant_lr(3e-3)(7))


# ---------------------------------------------------------------------------
# policies and schedules
# ---------------------------------------------------------------------------

SPECS = ["full", "none", "fixed:2", "fixed:4.5", "varco:linear:5",
         "varco:linear:2.5", "varco:exp", "varco:cosine", "varco:step:3",
         "auto:budget:2e+09", "auto:budget:1e+07:w8",
         "auto:qos:5e+06:w4:per-layer", "auto:error:3e+08:per-layer",
         "auto:stale:1e+06:w2"]


@pytest.mark.parametrize("spec", SPECS)
def test_policy_parse_str_round_trip_matches_jax(spec):
    pt = CommPolicy.parse(spec, 40, compressor="blockmask")
    pj = JPolicy.parse(spec, 40, compressor="blockmask")
    assert str(pt) == str(pj) == spec
    again = CommPolicy.parse(str(pt), 40, compressor="blockmask")
    assert str(again) == spec and again.describe() == pt.describe()
    if pt.scheduler is None:
        assert again == pt
    assert pt.describe() == pj.describe()
    assert (pt.communicates, pt.compresses) == (pj.communicates,
                                                pj.compresses)
    if pt.mode != "auto":
        # exp/cosine run f32 pow/cos, which XLA's and PyTorch's kernels
        # round an ulp apart (and 1 + cos cancels near the anneal's end)
        rtol = 1e-5 if spec in ("varco:exp", "varco:cosine") else 0.0
        for s in (0, 1, 7, 39, 80):
            np.testing.assert_allclose(float(pt.rate(s)), float(pj.rate(s)),
                                       rtol=rtol, atol=0, err_msg=spec)


def test_policy_suffix_order_and_errors_match_jax():
    spec = "auto:budget:1e6:per-layer:w4"
    assert str(CommPolicy.parse(spec, 5)) == str(JPolicy.parse(spec, 5)) == \
        "auto:budget:1e+06:w4:per-layer"
    for bad in ("auto:budget", "auto:budget:1e6:w3", "auto:budget:1e6:x",
                "bogus"):
        with pytest.raises(ValueError):
            CommPolicy.parse(bad, 5)
        with pytest.raises(ValueError):
            JPolicy.parse(bad, 5)


@pytest.mark.parametrize("spec", ["linear:5", "linear:2", "exp", "cosine",
                                  "step:7", "fixed:3", "full"])
def test_schedulers_match_jax(spec):
    st, sj = tsched.parse(spec, 30), jsched.parse(spec, 30)
    assert st.name == sj.name
    rtol = 1e-5 if spec in ("exp", "cosine") else 0.0      # f32 pow / cos
    for t in range(0, 40, 3):
        np.testing.assert_allclose(float(st(t)), float(sj(t)), rtol=rtol,
                                   atol=0)

"""Closed-loop auto steps on the p2p and packed wires, the stale hop reuse,
stochastic rounding and byte conservation, against the live JAX package
on the CPU (``device="cpu"``: the plain versions of the kernels run).

The world is ``tiny_graph(n=256, F=128)`` over Q = 4 workers and a
2-layer SAGE at hidden 256, so the second exchange has two lane-blocks
and the rate maps pick kept counts per pair (per sender on the packed
wire).  Held, as ``tests/test_torch_train.py`` holds the p2p auto step:
losses and updated parameters within 1e-5 (SGD with momentum), the
per-pair ledger (``halo_bits``, ``transport_bits``, ``pair_transport``)
at rel 1e-6, ``pair_err`` at rel 1e-5, ``pair_delta`` at rel 1e-6, the
stale halo cache within 1e-5 and the error-feedback residuals bitwise at
the first exchange (deeper, a value on a rounding boundary may land one
level apart); ``train_gnn`` per epoch as ``tests/test_torch_trainer.py``
holds it; the bytes each exchange ships equal to ``ceil(ledger bits /
8)`` exactly, and the first exchange's buffers (the features) equal to
the JAX package's bitwise; deeper exchanges quantise activations that
agree to ~1e-7, so their scales are held at rel 1e-6 and at most 1e-3 of
their payload bytes may differ (a value on a rounding boundary).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist import gnn_parallel as jgp
from repro.dist import ratectl as jrc
from repro.dist.halo import attach_p2p as j_attach
from repro.graph.partition import partition_graph as j_partition
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.nn import gnn as jgnn
from repro.train import optim as joptim
from repro.train.trainer import train_gnn as j_train
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist import ratectl as trc
from repro_torch.dist.halo import attach_p2p
from repro_torch.dist.ratectl import RatePlan
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

N, F, HIDDEN, LAYERS, Q, E = 256, 128, 256, 2, 4, 4
TOL = 1e-5
LANE = 128


def _port(tree):
    return tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


@pytest.fixture(scope="module")
def world():
    g, gj = tiny_graph(n=N, feat_dim=F), j_tiny(n=N, feat_dim=F)
    kw = dict(conv="sage", in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
              layers=LAYERS)
    cj, ct = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    pgj, pgt = j_partition(gj, Q, seed=0), partition_graph(g, Q, seed=0)
    w = {"g": g, "gj": gj, "cj": cj, "ct": ct, "pj": pj, "pgt": pgt,
         "graph_j": j_attach(pgj.device_arrays(), pgj),
         "graph_t": attach_p2p(pgt.device_arrays("cpu"), pgt, "cpu")}
    for wire in ("p2p", "packed"):
        w["meta_j", wire] = jgp.DistMeta.build(pgj, pj, wire=wire)
        w["meta_t", wire] = tgp.DistMeta.build(pgt, _port(pj), wire=wire)
    return w


def _assert_rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _assert_tree_close(t_tree, j_tree, tol=TOL):
    lt, lj = toptim.tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol)


def _assert_metrics(mt, mj):
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=0, atol=TOL)
    _assert_rel(mt["rate"], mj["rate"])
    for k in ("halo_bits", "transport_bits", "pair_transport",
              "pair_delta"):
        _assert_rel(mt[k], mj[k])
    _assert_rel(mt["pair_err"], mj["pair_err"], rtol=1e-5)


def _assert_cache(cache_t, cache_j, exact_first: bool):
    assert len(cache_t) == len(cache_j)
    for li, (a, b) in enumerate(zip(cache_t, cache_j)):
        a, b = a.numpy(), np.asarray(b)
        if li == 0 and exact_first:   # layer 0 quantises the features
            np.testing.assert_array_equal(a, b)
            continue
        # a deeper value on a rounding boundary may land one level apart:
        # at most 1e-4 of the entries, each by at most one level
        off = np.abs(a - b) > TOL
        assert off.mean() <= 1e-4, (li, int(off.sum()))
        assert np.abs(a - b).max() <= np.abs(b).max() + TOL


def _plan(kind: str, seed: int):
    """A seeded rate map (rates {1, 2, 3}) with widths: ``fp32`` none,
    ``mixed`` {4, 8, 32} with one pair at 32 (the straight-through value
    path), ``w8`` every pair at 8 (the fused sub-byte codec)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(Q, dtype=bool)
    rates = np.where(eye, 1.0, rng.choice([1.0, 2.0, 3.0], (Q, Q)))
    widths = None
    if kind == "mixed":
        widths = np.where(eye, 32.0, rng.choice([4.0, 8.0, 32.0], (Q, Q)))
        widths[0, 1] = 32.0
    elif kind == "w8":
        widths = np.where(eye, 32.0, 8.0)
    return rates.astype(np.float32), np.zeros((Q, Q), np.float32), \
        None if widths is None else widths.astype(np.float32)


def _steps(w, wire, spec, rounding=None, stale=None):
    oj, ot = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    kw_j = {} if rounding is None else {"rounding": rounding}
    step_j = jrc.make_auto_train_step(w["cj"], JPolicy.parse(spec, E), oj,
                                      w["meta_j", wire], stale=stale,
                                      **kw_j)
    step_t = trc.make_auto_train_step(w["ct"], CommPolicy.parse(spec, E),
                                      ot, w["meta_t", wire], stale=stale,
                                      rounding=rounding)
    return oj, ot, step_j, step_t


@pytest.mark.parametrize("rounding", ["rint", "stochastic"])
@pytest.mark.parametrize("kind", ["fp32", "mixed", "w8"])
@pytest.mark.parametrize("wire", ["p2p", "packed"])
def test_auto_step_matches_jax(world, wire, kind, rounding):
    """One planned step per wire × width plan × rounding: the p2p wire
    carries error-feedback residuals under a width plan, the packed wire
    none (one payload per sender at its receivers' maximum kept count
    and width)."""
    w = world
    rates, skip, widths = _plan(kind, seed=len(kind))
    oj, ot, step_j, step_t = _steps(w, wire, "auto:budget:1e9:w4",
                                    rounding)
    assert tgp._packed_store_w(w["meta_t", wire], widths) == \
        (8 if kind == "w8" else 0)
    ef = wire == "p2p" and widths is not None
    cache_j = jrc.init_wire_residuals(w["meta_j", "p2p"], w["cj"]) \
        if ef else ()
    cache_t = trc.init_wire_residuals(w["meta_t", "p2p"], w["ct"], "cpu") \
        if ef else ()
    pj, sj = w["pj"], oj.init(w["pj"])
    pt, st = _port(pj), ot.init(_port(pj))
    pj, sj, mj, cache_j = step_j(pj, sj, w["graph_j"], jax.random.key(3),
                                 jrc.RatePlan(rates, skip, widths), cache_j)
    pt, st, mt, cache_t = step_t(pt, st, w["graph_t"], prng.key(3),
                                 RatePlan(rates, skip, widths), cache_t)
    _assert_metrics(mt, mj)
    _assert_tree_close(pt, pj)
    _assert_cache(cache_t, cache_j, exact_first=True)
    if ef:
        assert any(float(np.abs(np.asarray(c)).max()) > 0 for c in cache_j)


@pytest.mark.parametrize("width", [32, 8])
def test_stale_steps_reuse_the_cache_like_jax(world, width):
    """Two ``stale`` steps: a fresh one from the zero cache, then one
    with a seeded skip mask — skipped pairs serve the cached rows and
    charge nothing; the returned halo caches, the drift ``pair_delta``
    and the ledger match the JAX package.  At w8 the communicating pairs
    ride the sub-byte codec and no residual is kept (stale XOR EF)."""
    w = world
    spec = "auto:stale:1e9" + (f":w{width}" if width < 32 else "")
    oj, ot, step_j, step_t = _steps(w, "p2p", spec)
    rates, _, _ = _plan("fp32", seed=5)
    widths = None if width == 32 else \
        np.where(np.eye(Q, dtype=bool), 32.0, float(width)).astype(
            np.float32)
    rng = np.random.default_rng(11)
    skips = [np.zeros((Q, Q), np.float32),
             ((rng.uniform(size=(Q, Q)) < 0.5) &
              ~np.eye(Q, dtype=bool)).astype(np.float32)]
    assert skips[1].sum() > 0
    cache_j = jrc.init_halo_cache(w["meta_j", "p2p"], w["cj"])
    cache_t = trc.init_halo_cache(w["meta_t", "p2p"], w["ct"], "cpu")
    pj, sj = w["pj"], oj.init(w["pj"])
    pt, st = _port(pj), ot.init(_port(pj))
    for t, skip in enumerate(skips):
        prev = cache_t
        pj, sj, mj, cache_j = step_j(pj, sj, w["graph_j"], jax.random.key(t),
                                     jrc.RatePlan(rates, skip, widths),
                                     cache_j)
        pt, st, mt, cache_t = step_t(pt, st, w["graph_t"], prng.key(t),
                                     RatePlan(rates, skip, widths), cache_t)
        _assert_metrics(mt, mj)
        _assert_tree_close(pt, pj)
        _assert_cache(cache_t, cache_j, exact_first=False)
        pair_t = mt["pair_transport"].numpy()
        assert (pair_t[skip > 0] == 0).all()
        if t:
            # a skipped pair's hop rows are the cached ones, bitwise
            src, dst = np.nonzero(skip.T)
            d = (dst - src) % Q - 1
            for new, old in zip(cache_t, prev):
                assert torch.equal(new[src, d], old[src, d])


def test_stale_refuses_the_packed_wire(world):
    with pytest.raises(ValueError, match="p2p"):
        trc.make_auto_train_step(world["ct"], CommPolicy.parse(
            "auto:stale:1e9", E), toptim.sgd(0.1), world["meta_t", "packed"])
    with pytest.raises(ValueError, match="rounding"):
        trc.make_auto_train_step(world["ct"], CommPolicy.parse(
            "auto:budget:1e9", E), toptim.sgd(0.1), world["meta_t", "p2p"],
            rounding="nearest")


def test_packed_budget_w8_carries_no_residuals(world):
    """``auto:budget:<b>:w8`` on the packed wire, two controller-planned
    steps: no error-feedback residuals ride the cache channel (the JAX
    package keeps them for the p2p wire only), and the losses match."""
    w = world
    d_full = 2.0 * 32.0 * w["meta_t", "packed"].halo_demand * (F + HIDDEN)
    spec = f"auto:budget:{0.5 * d_full * E:g}:w8"
    oj, ot, step_j, step_t = _steps(w, "packed", spec)
    ctl_j = jrc.make_controller(JPolicy.parse(spec, E), w["meta_j", "packed"],
                                w["cj"], E)
    ctl_t = trc.make_controller(CommPolicy.parse(spec, E),
                                w["meta_t", "packed"], w["ct"], E)
    cs_j, cs_t = ctl_j.init(), ctl_t.init()
    pj, sj = w["pj"], oj.init(w["pj"])
    pt, st = _port(pj), ot.init(_port(pj))
    cache_j, cache_t = (), ()
    for t in range(2):
        plan_j, cs_j = ctl_j.plan(cs_j, t)
        plan_t, cs_t = ctl_t.plan(cs_t, t)
        assert tgp._packed_store_w(w["meta_t", "packed"], plan_t.widths) == 8
        pj, sj, mj, cache_j = step_j(pj, sj, w["graph_j"], jax.random.key(t),
                                     plan_j, cache_j)
        pt, st, mt, cache_t = step_t(pt, st, w["graph_t"], prng.key(t),
                                     plan_t, cache_t)
        assert cache_t == () and cache_j == ()
        _assert_metrics(mt, mj)
        _assert_tree_close(pt, pj)
        cs_j, cs_t = ctl_j.observe(cs_j, mj), ctl_t.observe(cs_t, mt)


# ---------------------------------------------------------------------------
# train_gnn, epoch by epoch
# ---------------------------------------------------------------------------


def _half_transport() -> float:
    pg = partition_graph(tiny_graph(n=N, feat_dim=F), Q, seed=0)
    return 0.5 * 2.0 * 32.0 * pg.halo_demand * (F + HIDDEN) * E


TRAIN_RUNS = {"error_w8_p2p": ("auto:error:{half:g}:w8", "p2p"),
              "stale_p2p": ("auto:stale:{half:g}", "p2p"),
              "budget_w4_packed": ("auto:budget:{half:g}:w4", "packed")}


@pytest.mark.parametrize("name", list(TRAIN_RUNS))
def test_train_gnn_matches_jax(world, name):
    w = world
    spec = TRAIN_RUNS[name][0].format(half=_half_transport())
    wire = TRAIN_RUNS[name][1]
    kw = dict(q=Q, scheme="random", epochs=E, hidden=HIDDEN, layers=LAYERS,
              seed=0, eval_every=1, wire=wire)
    rj = j_train(w["gj"], policy=JPolicy.parse(spec, E), **kw)
    rt = train_gnn(w["g"], policy=CommPolicy.parse(spec, E), device="cpu",
                   params=_port(jgnn.init_gnn(jax.random.key(0), w["cj"])),
                   **kw)
    hj, ht = rj.history, rt.history
    assert ht.epoch == hj.epoch == list(range(E))
    np.testing.assert_allclose(ht.loss[0], hj.loss[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ht.rate, hj.rate, rtol=1e-6, atol=0)
    for split, n in (("train_acc", rt.meta.n_train),
                     ("val_acc", rt.meta.n_val),
                     ("test_acc", rt.meta.n_test)):
        np.testing.assert_allclose(getattr(ht, split), getattr(hj, split),
                                   rtol=0, atol=1.0 / n + 1e-7)
    for col in ("halo_gfloats", "transport_gfloats"):
        np.testing.assert_allclose(getattr(ht, col), getattr(hj, col),
                                   rtol=1e-6, atol=0)
    for a, b in zip(ht.pair_transport_gf, hj.pair_transport_gf):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ht.comp_err, hj.comp_err, rtol=1e-5, atol=0)
    assert rt.policy_desc == rj.policy_desc
    assert ht.transport_gfloats[-1] > 0.0
    assert np.isfinite(ht.loss).all()


# ---------------------------------------------------------------------------
# Byte conservation: the ledger against the buffers that crossed the wire
# ---------------------------------------------------------------------------


def _forward_capture(w, wire, width, rounding="rint"):
    """One forward through both packages' oracles with ``wire_out``
    capture, every pair at ``width`` and rate 2.  Returns the port's and
    the JAX package's ``(captures, ledger vector)``."""
    rm = np.where(np.eye(Q, dtype=bool), 1.0, 2.0).astype(np.float32)
    wm = np.where(np.eye(Q, dtype=bool), 32.0, float(width)).astype(
        np.float32)
    pol_j = JPolicy.parse("fixed:2", 1, compressor="blockmask")
    pol_t = CommPolicy.parse("fixed:2", 1, compressor="blockmask")
    mj, mt = w["meta_j", wire], w["meta_t", wire]
    sw = tgp._packed_store_w(mt, wm)
    assert sw == jgp._packed_store_w(mj, wm) == (width if width < 32 else 0)
    kb = dict(tgp._packed_pair_k_for(mt, rm))
    cap_j, cap_t = [], []
    agg_j = jgp._make_aggregate_emulated(
        w["graph_j"], mj, pol_j, None, jnp.ones(()), jax.random.key(7),
        packed_k=kb, rate_map=jnp.asarray(rm), width_map=jnp.asarray(wm),
        store_w=sw, wire_out=cap_j, rounding=rounding)
    _, bits_j = jgnn.gnn_forward(w["pj"], w["cj"], w["graph_j"]["features"],
                                 agg_j)
    agg_t = tgp._make_aggregate_emulated(
        w["graph_t"], mt, pol_t, torch.ones(()), prng.key(7), packed_k=kb,
        rate_map=rm, width_map=wm, store_w=sw, wire_out=cap_t,
        rounding=rounding)
    with torch.no_grad():
        _, bits_t = tgnn.gnn_forward(_port(w["pj"]), w["ct"],
                                     w["graph_t"]["features"], agg_t)
    return cap_t, bits_t, cap_j, bits_j


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _assert_shipped(e, pay_t, sc_t, pay_j, sc_j):
    """Exchange ``e``'s captured buffers against the JAX package's:
    bitwise at the first, close deeper (module docs)."""
    pay_t, pay_j = pay_t.numpy(), np.asarray(pay_j)
    if e == 0:
        np.testing.assert_array_equal(pay_t, pay_j)
    elif pay_t.dtype == np.uint8:
        assert pay_t.shape == pay_j.shape
        assert (pay_t != pay_j).mean() <= 1e-3, e
    else:
        np.testing.assert_allclose(pay_t, pay_j, rtol=0, atol=TOL)
    if sc_t is not None:
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j),
                                   rtol=0 if e == 0 else 1e-6, atol=0)


@pytest.mark.parametrize("width", [2, 4, 8, 32])
def test_p2p_hops_conserve_bytes(world, width):
    """Every captured p2p hop ships ``ceil(rows · k · bits_per_block /
    8)`` bytes over its genuine rows, the per-pair totals equal
    ``ceil(ledger transport / 8)``, and the buffers are the JAX
    package's (bitwise at the first exchange)."""
    w = world
    cap_t, bits_t, cap_j, _ = _forward_capture(w, "p2p", width)
    assert len(cap_t) == len(cap_j) == LAYERS
    valid = w["graph_t"]["p2p_send_valid"].numpy()          # [Q, D, H]
    d_hops = Q - 1
    meas = np.zeros((Q, Q))
    for e, ((pay_t, sc_t), (pay_j, sc_j)) in enumerate(zip(cap_t, cap_j)):
        assert (sc_t is None) == (sc_j is None) == (width >= 32)
        if width < 32:
            assert pay_t.dtype == torch.uint8
        _assert_shipped(e, pay_t, sc_t, pay_j, sc_j)
        f = (F, HIDDEN)[e]
        k = max(int(f // LANE // 2), 1)
        blk = LANE * 32.0 if width >= 32 else LANE * width + 32.0
        for j in range(Q):
            for d in range(d_hops):
                sel = torch.from_numpy(valid[j, d] > 0)
                m = _nbytes(pay_t[j, d][sel]) + (
                    0 if sc_t is None else _nbytes(sc_t[j, d][sel]))
                rows = int(sel.sum())
                assert m == math.ceil(rows * k * blk / 8.0), (e, j, d)
                meas[(j + d + 1) % Q, j] += m
    pair_t = bits_t[2:2 + Q * Q].numpy().astype(np.float64).reshape(Q, Q)
    np.testing.assert_array_equal(meas, np.ceil(pair_t / 8.0))


@pytest.mark.parametrize("width", [4, 8])
def test_packed_payloads_conserve_bytes(world, width):
    """On the packed wire every transported row is ``k·(128·w + 32)/8``
    bytes (the all-gather's ledger charges halo demand, not the padded
    buffer), and the payloads equal the JAX package's (bitwise at the
    first exchange) — also under stochastic rounding."""
    w = world
    for rounding in ("rint", "stochastic"):
        cap_t, _, cap_j, _ = _forward_capture(w, "packed", width, rounding)
        assert len(cap_t) == len(cap_j) == LAYERS
        for e, ((pay_t, sc_t), (pay_j, sc_j)) in enumerate(zip(cap_t,
                                                               cap_j)):
            assert pay_t.dtype == torch.uint8 and sc_t is not None
            _assert_shipped(e, pay_t, sc_t, pay_j, sc_j)
            k = max(int((F, HIDDEN)[e] // LANE // 2), 1)
            assert _nbytes(pay_t[0, 0]) + _nbytes(sc_t[0, 0]) == \
                math.ceil(k * (LANE * width + 32.0) / 8.0)

"""The JAX package's default wire in the port: the dense compressing
all-gather and the packed all-gather, against the live JAX package on the
CPU (``device="cpu"``: the plain versions of the ``random_mask`` and
pack/unpack kernels run).

Held, as ``tests/test_torch_train.py`` holds the p2p wire: one step per
open-loop policy and compressor (Q ∈ {1, 2, 4}; rates {1, 2, 4, 16} as
``tests/test_packed_wire.py`` sweeps them) with losses and updated
parameters within 1e-5 (f32 sums in another order; SGD with momentum),
``halo_bits``/``transport_bits`` at rel 1e-6; ``train_gnn`` of the JAX
package's quickstart (``varco(epochs, slope=5)`` on the default dense
wire, and on the packed wire) with per-epoch losses within 1e-5, rates
and ledger at rel 1e-6 and accuracies within one node; the halo the
packed wire delivers bitwise equal to the dense ``blockmask`` halo and
to the p2p wire's remote values at rate 2 (the JAX package's module
note); the packed transport per exchange exactly ``halo_demand × K·128 ×
32``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.core.varco import varco as j_varco
from repro.dist import gnn_parallel as jgp
from repro.graph.partition import partition_graph as j_partition
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.nn import gnn as jgnn
from repro.train import optim as joptim
from repro.train.trainer import train_gnn as j_train
from repro_torch import prng
from repro_torch.core.varco import CommPolicy, varco
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist import ratectl as trc
from repro_torch.dist.halo import attach_p2p
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

N, F, HIDDEN, LAYERS = 256, 128, 256, 3
TOL = 1e-5


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
    parts = {}

    def part(q):
        if q not in parts:
            parts[q] = (j_partition(gj, q, seed=0), partition_graph(g, q,
                                                                    seed=0))
        return parts[q]

    return {"g": g, "gj": gj, "cj": cj, "ct": ct, "pj": pj, "part": part}


def _metas(w, q, wire):
    pgj, pgt = w["part"](q)
    return (jgp.DistMeta.build(pgj, w["pj"], wire=wire),
            tgp.DistMeta.build(pgt, _port(w["pj"]), wire=wire))


def _assert_rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _assert_params_close(pt, pj, tol=TOL):
    lt, lj = toptim.tree_leaves(pt), jax.tree_util.tree_leaves(pj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol)


def _j_static_rate_step(cj, pol, opt, meta, graph, rate, key, params):
    """The JAX package's step for a compressor that needs a concrete rate
    (top-k: ``float(rate)``), which its jitted step cannot trace: the
    same loss and update, un-jitted."""
    comp = pol.compressor()

    def loss_fn(p):
        agg = jgp._make_aggregate_emulated(graph, meta, pol, comp, rate, key)
        return jgp._local_loss_fn(p, cj, graph, agg, meta)

    (loss, bits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    return joptim.apply_updates(params, updates), \
        jgp._step_metrics(loss, rate, bits)


STEP_CASES = [
    # (wire, q, spec, compressor)
    *[("dense", 4, s, c) for s, c in (
        ("full", None), ("none", None), ("fixed:1", "randmask"),
        ("fixed:2", "randmask"), ("fixed:4", "randmask"),
        ("fixed:16", "randmask"), ("varco:linear:5", "randmask"),
        ("fixed:4", "randmask_unbiased"), ("fixed:2", "blockmask"),
        ("fixed:8", "int8"), ("varco:linear:5", "int8"),
        ("fixed:4", "topk"))],
    ("dense", 1, "fixed:4", "randmask"), ("dense", 2, "fixed:4", "randmask"),
    ("dense", 2, "varco:linear:5", "randmask"),
    *[("packed", 4, s, "blockmask") for s in (
        "full", "none", "fixed:1", "fixed:2", "fixed:4", "fixed:16",
        "varco:linear:5")],
    ("packed", 1, "fixed:2", "blockmask"), ("packed", 2, "fixed:2",
                                            "blockmask"),
]


@pytest.mark.parametrize("wire,q,spec,comp", STEP_CASES,
                         ids=[f"{w}-q{q}-{s}-{c}" for w, q, s, c in
                              STEP_CASES])
def test_train_step_matches_jax(world, wire, q, spec, comp):
    """One step from the shared initialisation at step 3 of 100 (the
    linear schedule then sits near rate 109)."""
    w = world
    mj, mt = _metas(w, q, wire)
    pgj, pgt = w["part"](q)
    gj, gt = pgj.device_arrays(), pgt.device_arrays("cpu")
    pol_j = JPolicy.parse(spec, 100, compressor=comp)
    pol_t = CommPolicy.parse(spec, 100, compressor=comp)
    oj, ot = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    if comp == "topk":
        pj2, mjm = _j_static_rate_step(w["cj"], pol_j, oj, mj, gj, 4.0,
                                       jax.random.key(3), w["pj"])
    else:
        step_j = jgp.make_train_step(w["cj"], pol_j, oj, mj)
        pj2, _, mjm = step_j(w["pj"], oj.init(w["pj"]), gj, 3,
                             jax.random.key(3))
    step_t = tgp.make_train_step(w["ct"], pol_t, ot, mt)
    pt0 = _port(w["pj"])
    pt2, _, mtm = step_t(pt0, ot.init(pt0), gt, 3, prng.key(3))
    np.testing.assert_allclose(float(mtm["loss"]), float(mjm["loss"]),
                               rtol=0, atol=TOL)
    assert float(mtm["rate"]) == float(mjm["rate"])
    for k in ("halo_bits", "transport_bits"):
        _assert_rel(mtm[k], mjm[k])
    _assert_params_close(pt2, pj2)


@pytest.mark.parametrize("wire", ["dense", "packed"])
def test_train_gnn_quickstart_matches_jax(world, wire):
    """The JAX package's quickstart call, ``train_gnn(g, q=4, policy=
    varco(epochs, slope=5))`` on the default wire with the default
    compressor (the paper's random mask, ``randmask``), and on the packed
    wire with ``blockmask``; six epochs (rates 128, 22.2, then 1) from the
    same initial parameters."""
    w, e = world, 6
    kw = dict(q=4, scheme="random", epochs=e, hidden=HIDDEN, layers=LAYERS,
              seed=0, eval_every=1)
    pol_j, pol_t = j_varco(e, slope=5), varco(e, slope=5)
    if wire == "packed":
        kw["wire"] = "packed"
        pol_j = j_varco(e, slope=5, compressor="blockmask")
        pol_t = varco(e, slope=5, compressor="blockmask")
    rj = j_train(w["gj"], policy=pol_j, **kw)
    rt = train_gnn(w["g"], policy=pol_t, device="cpu",
                   params=_port(w["pj"]), **kw)
    assert len(set(rt.history.rate)) == 3
    assert rt.meta.wire == wire == rj.meta.wire
    hj, ht = rj.history, rt.history
    assert ht.epoch == hj.epoch == list(range(e))
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=0, atol=TOL)
    _assert_rel(ht.rate, hj.rate)
    for col in ("halo_gfloats", "transport_gfloats"):
        _assert_rel(getattr(ht, col), getattr(hj, col))
    for split, n in (("train_acc", rt.meta.n_train),
                     ("val_acc", rt.meta.n_val),
                     ("test_acc", rt.meta.n_test)):
        np.testing.assert_allclose(getattr(ht, split), getattr(hj, split),
                                   rtol=0, atol=1.0 / n + 1e-7)
    assert rt.policy_desc == rj.policy_desc


def _start(graph, meta, spec, comp, x, key):
    pol = CommPolicy.parse(spec, 10, compressor=comp)
    rate = pol.rate(0)
    kb = dict(tgp._packed_k_for(meta, float(rate)))
    agg = tgp._make_aggregate_emulated(graph, meta, pol, rate, key,
                                       packed_k=kb)
    return agg, agg.start(0, x)


@pytest.mark.parametrize("q", [2, 4])
def test_packed_dense_blockmask_and_p2p_deliver_the_same_halo(world, q):
    """At rate 2 over a 256-wide exchange: the packed halo equals the
    dense-``blockmask`` halo bitwise, and every remote edge reads the same
    value on the p2p wire; the dense-``randmask`` halo is another one."""
    w = world
    _, pgt = w["part"](q)
    graph = attach_p2p(pgt.device_arrays("cpu"), pgt, "cpu")
    p = _port(w["pj"])
    x = torch.from_numpy(np.random.default_rng(q).normal(
        size=(q, pgt.part_size, 256)).astype(np.float32))
    key = prng.fold_in(prng.key(11), 2)
    tok, bits = {}, {}
    aggs = {}
    for wire, comp in (("dense", "blockmask"), ("packed", "blockmask"),
                       ("p2p", "blockmask"), ("dense-rand", "randmask")):
        meta = tgp.DistMeta.build(pgt, p, wire=wire.split("-")[0])
        aggs[wire], (tok[wire], bits[wire]) = _start(graph, meta, "fixed:2",
                                                     comp, x, key)
    assert torch.equal(tok["packed"], tok["dense"])
    assert not torch.equal(tok["dense-rand"], tok["dense"])
    valid = graph["remote_w"] != 0
    via_dense = tok["dense"].index_select(
        0, graph["remote_src"].long().reshape(-1)).reshape(q, -1, 256)
    via_p2p = tgp._rows_of(tok["p2p"], graph["remote_src_p2p"],
                           tok["p2p"].shape[1])
    assert torch.equal(via_p2p[valid], via_dense[valid])
    # the aggregations agree too (ELL against edge-list sums: f32 order)
    out = {k: aggs[k].complete(0, x, tok[k]) for k in ("dense", "packed",
                                                       "p2p")}
    assert torch.equal(out["packed"], out["dense"])
    torch.testing.assert_close(out["p2p"], out["dense"], rtol=0, atol=TOL)
    # the analytic ledger agrees; packed and p2p ship the kept blocks
    for k in ("packed", "p2p"):
        assert float(bits[k][0]) == float(bits["dense"][0])
    assert float(bits["packed"][1]) == float(bits["p2p"][1]) < \
        float(bits["dense"][1])


@pytest.mark.parametrize("rate", [1.0, 2.0, 4.0, 16.0])
def test_packed_transport_is_the_kept_blocks(world, rate):
    """A packed step's transport is ``2 × Σ_exchanges halo_demand ×
    K·128 × 32`` exactly, with ``K = max(floor(nb / rate), 1)``."""
    w = world
    _, mt = _metas(w, 4, "packed")
    _, pgt = w["part"](4)
    ot = toptim.sgd(0.1)
    pt0 = _port(w["pj"])
    step = tgp.make_train_step(w["ct"], CommPolicy.parse(
        f"fixed:{rate:g}", 10, compressor="blockmask"), ot, mt)
    _, _, m = step(pt0, ot.init(pt0), pgt.device_arrays("cpu"), 0,
                   prng.key(0))
    want = 2.0 * sum(mt.halo_demand * max(int(d // 128 / rate), 1) * 128 *
                     32.0 for d in mt.layer_dims)
    assert float(m["transport_bits"]) == float(np.float32(want))
    assert float(m["transport_bits"]) == float(np.float32(2.0 * sum(
        float(mt.transport_bits(d, rate)) for d in mt.layer_dims)))


def test_wire_options_and_refusals(world):
    w = world
    _, pgt = w["part"](4)
    p = _port(w["pj"])
    packed = tgp.DistMeta.build(pgt, p, wire="packed")
    assert packed.pair_rows and packed.p2p_hop_width == 0
    assert tgp.WIRES == ("dense", "packed", "p2p")
    with pytest.raises(ValueError, match="divisible"):
        tgp.DistMeta.build(pgt, tgnn.init_gnn(
            tgnn.GNNConfig(in_dim=F, hidden=96, out_dim=4, layers=2),
            torch.Generator().manual_seed(0), device="cpu"), wire="packed")
    with pytest.raises(ValueError, match="blockmask"):
        tgp.make_train_step(w["ct"], CommPolicy.parse("fixed:2", 4),
                            toptim.sgd(0.1), packed)
    # auto policies on the packed wire are ported now: the same calls
    # build a step and train (their parity with the JAX package:
    # tests/test_torch_auto_wires.py)
    ot = toptim.sgd(0.1)
    step = trc.make_auto_train_step(w["ct"], CommPolicy.parse(
        "auto:budget:1e9", 4), ot, packed)
    eye = np.eye(4, dtype=bool)
    plan = trc.RatePlan(np.where(eye, 1.0, 2.0).astype(np.float32),
                        np.zeros((4, 4), np.float32))
    _, _, m, cache = step(p, ot.init(p), attach_p2p(
        pgt.device_arrays("cpu"), pgt, "cpu"), prng.key(0), plan)
    assert cache == () and float(m["transport_bits"]) > 0
    res = train_gnn(w["g"], q=4, policy=CommPolicy.parse("auto:budget:1e9",
                                                         2),
                    epochs=2, wire="packed", device="cpu", hidden=128,
                    layers=2)
    assert res.meta.wire == "packed" and np.isfinite(res.history.loss).all()

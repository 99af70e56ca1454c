"""The port's Algorithm-1 steps against the JAX package's, one step at a
time on the CPU (``device="cpu"``: the plain versions run), from the
same parameters and optimiser state carried over by ``params_from_jax``.

Held: losses and updated parameters within 1e-5 (f32 sums in another
order through forward and backward; the steps use SGD with momentum,
whose update is linear in the gradient — AdamW's first step divides
near-zero gradients by their own magnitude, and its parity is held
separately in tests/test_torch_quant.py), ``halo_bits``/``transport_bits`` and
the per-pair ledger at rel 1e-6, evaluation accuracies exactly, the
budget controller's plans (rates at rel 1e-6, widths and kept-block
counts equal) and the error-feedback residuals within 1e-5 (bitwise at
the first layer; deeper, a value on a rounding boundary may land one
level apart).  The hidden
width is 256 (two lane-blocks), so every compressed exchange picks its
kept block from the key stream.
"""

from __future__ import annotations

import jax
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

N, F, HIDDEN, LAYERS, Q, E = 256, 128, 256, 3, 4, 5
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return tgnn.params_from_jax(_np(tree), device="cpu")


@pytest.fixture(scope="module")
def setup():
    g, gj = tiny_graph(n=N, feat_dim=F), j_tiny(n=N, feat_dim=F)
    kw = dict(conv="sage", in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
              layers=LAYERS)
    cj, ct = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    pgj, pgt = j_partition(gj, Q, seed=0), partition_graph(g, Q, seed=0)
    return {
        "cj": cj, "ct": ct, "pj": pj,
        "graph_j": j_attach(pgj.device_arrays(), pgj),
        "graph_t": attach_p2p(pgt.device_arrays("cpu"), pgt, "cpu"),
        "meta_j": jgp.DistMeta.build(pgj, pj, wire="p2p"),
        "meta_t": tgp.DistMeta.build(pgt, _port(pj), wire="p2p"),
    }


def _opts():
    return (joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9))


def _assert_tree_close(t_tree, j_tree, tol=TOL):
    lt, lj = toptim.tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol)


def _assert_rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def test_meta_matches_jax(setup):
    mj, mt = setup["meta_j"], setup["meta_t"]
    for name in ("q", "part_size", "halo_size", "halo_demand", "n_train",
                 "n_val", "n_test", "layer_dims", "p2p_hop_width",
                 "p2p_compact", "pair_rows"):
        assert getattr(mt, name) == getattr(mj, name), name
    for feat, rate in ((128, 1.0), (256, 2.0), (256, 3.0)):
        _assert_rel(mt.ledger_bits(feat, rate), mj.ledger_bits(feat, rate))
        _assert_rel(mt.transport_bits(feat, rate),
                    mj.transport_bits(feat, rate))


@pytest.mark.parametrize("spec", ["full", "none", "fixed:2",
                                  "varco:linear:5"])
def test_train_step_matches_jax(setup, spec):
    """Two steps: the first from the shared initialisation, the second
    from the JAX package's state after its first step."""
    s = setup
    pol_j = JPolicy.parse(spec, 40, compressor="blockmask")
    pol_t = CommPolicy.parse(spec, 40, compressor="blockmask")
    oj, ot = _opts()
    step_j = jgp.make_train_step(s["cj"], pol_j, oj, s["meta_j"])
    step_t = tgp.make_train_step(s["ct"], pol_t, ot, s["meta_t"])
    pj, sj = s["pj"], oj.init(s["pj"])
    for t in (0, 1):
        pt, st = _port(pj), _port(sj)
        pj, sj, mj = step_j(pj, sj, s["graph_j"], t, jax.random.key(t))
        pt, st, mt = step_t(pt, st, s["graph_t"], t, prng.key(t))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=0, atol=TOL)
        assert float(mt["rate"]) == float(mj["rate"])
        for k in ("halo_bits", "transport_bits"):
            _assert_rel(mt[k], mj[k])
        _assert_tree_close(pt, pj)
        _assert_tree_close(st["mom"], sj["mom"])
        assert int(st["step"]) == int(sj["step"])


def test_eval_step_accuracies_match_jax_exactly(setup):
    s = setup
    ev_j = jgp.make_eval_step(s["cj"], s["meta_j"])
    ev_t = tgp.make_eval_step(s["ct"], s["meta_t"])
    step_j = jgp.make_train_step(s["cj"], JPolicy.parse("full", 1),
                                 joptim.adamw(5e-2), s["meta_j"])
    pj, sj = s["pj"], joptim.adamw(5e-2).init(s["pj"])
    for t in range(3):
        aj, at = ev_j(pj, s["graph_j"]), ev_t(_port(pj), s["graph_t"])
        for split in ("train", "val", "test"):
            assert float(at[split]) == float(aj[split]), (t, split)
        pj, sj, _ = step_j(pj, sj, s["graph_j"], t, jax.random.key(t))


def _budget_w8(meta) -> float:
    """Half the full-rate transport of ``E`` steps."""
    d_full = 2.0 * 32.0 * meta.halo_demand * (F + HIDDEN * (LAYERS - 1))
    return 0.5 * d_full * E


def _compare_auto_step(m_t, m_j, cache_t, cache_j, pt, pj):
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=0, atol=TOL)
    _assert_rel(m_t["rate"], m_j["rate"])
    for k in ("halo_bits", "transport_bits", "pair_transport"):
        _assert_rel(m_t[k], m_j[k])
    _assert_rel(m_t["pair_err"], m_j["pair_err"], rtol=1e-5)
    _assert_tree_close(pt, pj)
    assert len(cache_t) == len(cache_j)
    for li, (a, b) in enumerate(zip(cache_t, cache_j)):
        a, b = a.numpy(), np.asarray(b)
        if li == 0:           # layer 0 quantises the features: same input
            np.testing.assert_array_equal(a, b)
            continue
        # deeper layers quantise activations that agree to ~1e-7, so a
        # value sitting on a rounding boundary may land one level apart:
        # at most 1e-4 of the entries, each by at most one level
        off = np.abs(a - b) > TOL
        assert off.mean() <= 1e-4, (li, int(off.sum()))
        assert np.abs(a - b).max() <= np.abs(b).max() + TOL


def test_auto_budget_w8_steps_with_error_feedback_match_jax(setup):
    """Two controller-planned steps under ``auto:budget:<bits>:w8``: the
    plans pick w8 (every pair quantises, so the hops ride the fused
    sub-byte codec), and parameters, metrics and EF residuals agree."""
    s = setup
    spec = f"auto:budget:{_budget_w8(s['meta_t']):g}:w8"
    pol_j, pol_t = JPolicy.parse(spec, E), CommPolicy.parse(spec, E)
    oj, ot = _opts()
    ctl_j = jrc.make_controller(pol_j, s["meta_j"], s["cj"], E)
    ctl_t = trc.make_controller(pol_t, s["meta_t"], s["ct"], E)
    step_j = jrc.make_auto_train_step(s["cj"], pol_j, oj, s["meta_j"])
    step_t = trc.make_auto_train_step(s["ct"], pol_t, ot, s["meta_t"])
    cs_j, cs_t = ctl_j.init(), ctl_t.init()
    cache_j = jrc.init_wire_residuals(s["meta_j"], s["cj"])
    cache_t = trc.init_wire_residuals(s["meta_t"], s["ct"], "cpu")
    pj, sj = s["pj"], oj.init(s["pj"])
    pt, st = _port(pj), ot.init(_port(pj))
    for t in range(2):
        plan_j, cs_j = ctl_j.plan(cs_j, t)
        plan_t, cs_t = ctl_t.plan(cs_t, t)
        _assert_rel(plan_t.rates, plan_j.rates)
        np.testing.assert_array_equal(np.asarray(plan_t.widths),
                                      np.asarray(plan_j.widths))
        assert tgp._packed_store_w(s["meta_t"], plan_t.widths) == 8
        assert tgp._packed_pair_k_for(s["meta_t"], plan_t.rates) == \
            jgp._packed_pair_k_for(s["meta_j"], np.asarray(plan_j.rates))
        pj, sj, mj, cache_j = step_j(pj, sj, s["graph_j"],
                                     jax.random.key(t), plan_j, cache_j)
        pt, st, mt, cache_t = step_t(pt, st, s["graph_t"], prng.key(t),
                                     plan_t, cache_t)
        _compare_auto_step(mt, mj, cache_t, cache_j, pt, pj)
        assert any(float(np.abs(np.asarray(c)).max()) > 0 for c in cache_j)
        cs_j, cs_t = ctl_j.observe(cs_j, mj), ctl_t.observe(cs_t, mt)
        _assert_rel(cs_t["spent"], cs_j["spent"])


@pytest.mark.parametrize("fp32_pair", [False, True])
def test_hand_made_mixed_width_plan_matches_jax(setup, fp32_pair):
    """A mixed rate × width plan: widths 4 and 8 (every pair quantises:
    the fused codec stores at 8 bits with per-pair qmax) or, with one
    pair left at 32, the straight-through value path; EF on both."""
    s = setup
    rng = np.random.default_rng(int(fp32_pair))
    eye = np.eye(Q, dtype=bool)
    rates = np.where(eye, 1.0, rng.choice([1.0, 2.0, 3.0], (Q, Q)))
    widths = np.where(eye, 32.0, rng.choice([4.0, 8.0], (Q, Q)))
    if fp32_pair:
        widths[0, 1] = 32.0
    rates, widths = rates.astype(np.float32), widths.astype(np.float32)
    skip = np.zeros((Q, Q), np.float32)
    spec = "auto:budget:1e9:w4"
    oj, ot = _opts()
    step_j = jrc.make_auto_train_step(s["cj"], JPolicy.parse(spec, E), oj,
                                      s["meta_j"])
    step_t = trc.make_auto_train_step(s["ct"], CommPolicy.parse(spec, E), ot,
                                      s["meta_t"])
    assert tgp._packed_store_w(s["meta_t"], widths) == (0 if fp32_pair
                                                        else 8)
    cache_j = jrc.init_wire_residuals(s["meta_j"], s["cj"])
    cache_t = trc.init_wire_residuals(s["meta_t"], s["ct"], "cpu")
    pj, sj = s["pj"], oj.init(s["pj"])
    pt, st = _port(pj), ot.init(_port(pj))
    for t in range(2):
        pj, sj, mj, cache_j = step_j(
            pj, sj, s["graph_j"], jax.random.key(t),
            jrc.RatePlan(rates, skip, widths), cache_j)
        pt, st, mt, cache_t = step_t(pt, st, s["graph_t"], prng.key(t),
                                     RatePlan(rates, skip, widths), cache_t)
        _compare_auto_step(mt, mj, cache_t, cache_j, pt, pj)


def test_port_steps_refuse_unported_options(setup):
    """The open-loop and closed-loop steps run on the worker group (their
    parity: tests/test_torch_dist_train.py, test_torch_dist_auto.py) and
    refuse a mesh of another size.  Stochastic rounding and the
    ``error``/``stale`` controllers are ported now, so the same calls
    build a step or controller and run it once (their parity with the
    JAX package: tests/test_torch_ratectl.py, test_torch_auto_wires.py)."""
    from repro_torch.core.collectives import WorkerMesh

    s = setup
    two = WorkerMesh(q=2, rank=0, device=torch.device("cpu"),
                     backend="gloo")
    with pytest.raises(ValueError, match="mesh has 2 workers"):
        tgp.make_train_step(s["ct"], CommPolicy.parse("full", 1),
                            toptim.sgd(0.1), s["meta_t"], mesh=two)
    with pytest.raises(ValueError, match="mesh has 2 workers"):
        trc.make_auto_train_step(s["ct"], CommPolicy.parse(
            "auto:budget:1e9:w8", 1), toptim.sgd(0.1), s["meta_t"],
            mesh=two)
    p0 = _port(s["pj"])
    ot = toptim.sgd(0.1)
    step = trc.make_auto_train_step(s["ct"], CommPolicy.parse(
        "auto:budget:1e9:w8", 1), ot, s["meta_t"], rounding="stochastic")
    eye = np.eye(Q, dtype=bool)
    plan = RatePlan(np.where(eye, 1.0, 2.0).astype(np.float32),
                    np.zeros((Q, Q), np.float32),
                    np.where(eye, 32.0, 8.0).astype(np.float32))
    _, _, m, cache = step(p0, ot.init(p0), s["graph_t"], prng.key(0), plan,
                          trc.init_wire_residuals(s["meta_t"], s["ct"],
                                                  "cpu"))
    assert np.isfinite(float(m["loss"])) and len(cache) == LAYERS
    for ctl in ("error", "stale"):
        pol = CommPolicy.parse(f"auto:{ctl}:1e9", 4)
        c = trc.make_controller(pol, s["meta_t"], s["ct"], 4)
        plan, state = c.plan(c.init(), 0)
        cache = trc.init_halo_cache(s["meta_t"], s["ct"], "cpu") \
            if ctl == "stale" else ()
        _, _, m, cache = trc.make_auto_train_step(
            s["ct"], pol, ot, s["meta_t"])(p0, ot.init(p0), s["graph_t"],
                                           prng.key(0), plan, cache)
        state = c.observe(state, m)
        assert float(m["transport_bits"]) > 0 and float(state["spent"]) > 0
        assert len(cache) == (LAYERS if ctl == "stale" else 0)
    # the dense compressing wire is ported now: the same call builds a
    # step (its parity with the JAX package: tests/test_torch_dense_wire.py)
    dense = tgp.DistMeta.build(partition_graph(tiny_graph(n=64, feat_dim=F),
                                               2), _port(s["pj"]),
                               wire="dense")
    assert callable(tgp.make_train_step(s["ct"], CommPolicy.parse(
        "fixed:2", 1, compressor="blockmask"), toptim.sgd(0.1), dense))

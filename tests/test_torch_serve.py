"""The port's serving engine against the JAX package's, over one query
stream, on the CPU (``device="cpu"``: the plain versions run).

Held: cold-refresh hiddens within 1e-5 (f32 sum order differs between the
frameworks), ``halo_bits``/``transport_bits`` and the ledger at rel 1e-6,
the qos controller's rates and widths within 1e-6 (f32 host arithmetic on
both sides), equal drift-gate masks, and the embeddings of compressed
``auto:qos:<bits>:w8`` refreshes within 1e-5.  One configuration has a
hidden width of 256, so its second exchange picks one of two lane-blocks
per pair from the key stream.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist.ratectl import make_pacing as j_make_pacing
from repro.dist.ratectl import waterfill as j_waterfill
from repro.dist.ratectl.base import allowance as j_allowance
from repro.dist.ratectl.base import refine_widths as j_refine
from repro.dist.ratectl.stale import drift_skip as j_drift_skip
from repro.graph.synthetic import citation_graph as j_graph
from repro.nn import gnn as jgnn
from repro.serve import ServingEngine as JEngine
from repro_torch.core.varco import CommLedger, CommPolicy
from repro_torch.dist.ratectl import base as tbase
from repro_torch.dist.ratectl.stale import drift_skip
from repro_torch.graph.synthetic import citation_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.serve import MicroBatcher, ServingEngine

N, F, Q = 192, 128, 4
TOL = 1e-5


def _engines(hidden=F, layers=2, **kw):
    gj, gt = j_graph(n=N, feat_dim=F), citation_graph(n=N, feat_dim=F)
    cj = jgnn.GNNConfig(in_dim=F, hidden=hidden, out_dim=gj.num_classes,
                        layers=layers)
    ct = tgnn.GNNConfig(in_dim=F, hidden=hidden, out_dim=gt.num_classes,
                        layers=layers)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    pt = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                              device="cpu")
    ej = JEngine(gj, pj, cj, q=Q, seed=0, **kw)
    et = ServingEngine(gt, pt, ct, q=Q, seed=0, device="cpu", **kw)
    return ej, et, (gt, pt, ct)


def _query_stream(seed):
    rng = np.random.default_rng(seed)
    # skewed traffic: most queries land on a few hot nodes
    hot = rng.integers(0, N, 8)
    nodes = np.where(rng.uniform(size=60) < 0.7,
                     rng.choice(hot, 60), rng.integers(0, N, 60))
    edges = rng.integers(0, N, (20, 2))
    return nodes, edges


def _drive(engine, nodes, edges, t0):
    """Submit the stream through the micro-batcher, flush, and return the
    answers in submission order."""
    for i, u in enumerate(nodes):
        engine.submit(int(u), tenant="a", now=t0 + 1e-4 * i)
    for i, (u, v) in enumerate(edges):
        engine.submit((int(u), int(v)), tenant="b", now=t0 + 1e-4 * i)
    out = engine.flush(now=t0 + 1.0)
    return {(qy.nodes, qy.arrival, qy.tenant): emb for qy, emb in out}


def _all_layers(engine, n_layers):
    return [engine.cache.gather(li, np.arange(N)) for li in range(n_layers)]


def _check_metrics(mj, mt):
    for k in ("halo_bits", "transport_bits"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(mt["pair_transport"].numpy(),
                               np.asarray(mj["pair_transport"]), rtol=1e-6)
    np.testing.assert_allclose(mt["pair_delta"].numpy(),
                               np.asarray(mj["pair_delta"]), rtol=1e-4,
                               atol=1e-7)


def _check_plans(ej, et, step):
    pj, _ = ej.ctl.plan(ej._ctl_state, step)
    pt, _ = et.ctl.plan(et._ctl_state, step)
    np.testing.assert_allclose(pt.rates.numpy(), np.asarray(pj.rates),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.widths.numpy(), np.asarray(pj.widths),
                               rtol=1e-6)
    return pt


@pytest.mark.parametrize("hidden", [F, 2 * F])
def test_serving_stream_matches_jax(hidden):
    """Cold refresh, then three non-forced refreshes under the default
    ``auto:qos:<bits>:w8`` policy with queries between them: same
    hiddens, ledgers, plans, gate masks and answers."""
    ej, et, _ = _engines(hidden=hidden)
    assert str(ej.policy) == str(et.policy)
    assert str(et.policy).endswith(":w8")
    mj, mt = ej.refresh(force=True), et.refresh(force=True)
    _check_metrics(mj, mt)
    assert ej.status() == et.status() == "FRESH"
    for a, b in zip(_all_layers(ej, 2), _all_layers(et, 2)):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    compressed = 0
    for step in range(3):
        nodes, edges = _query_stream(step)
        aj = _drive(ej, nodes, edges, 10.0 * step)
        at = _drive(et, nodes, edges, 10.0 * step)
        assert aj.keys() == at.keys()
        for k in aj:
            np.testing.assert_allclose(at[k], aj[k], rtol=0, atol=TOL)
        np.testing.assert_array_equal(et.query_counts(), ej.query_counts())
        plan = _check_plans(ej, et, ej._step)
        np.testing.assert_array_equal(et._skip_next,
                                      np.asarray(ej._skip_next))
        mj, mt = ej.refresh(), et.refresh()
        _check_metrics(mj, mt)
        compressed += float(mt["transport_bits"]) > 0.0 and \
            bool((plan.rates.numpy() > 1.0).any() or
                 (plan.widths.numpy() < 32.0).any())
        assert ej.status() == et.status()
        emb_j, _ = ej.serve(np.arange(N))
        emb_t, _ = et.serve(np.arange(N))
        np.testing.assert_allclose(emb_t, emb_j, rtol=0, atol=TOL)
    assert compressed >= 1
    np.testing.assert_allclose(float(et.ledger.transport),
                               float(ej.ledger.transport), rtol=1e-6)
    np.testing.assert_allclose(float(et.ledger.bits), float(ej.ledger.bits),
                               rtol=1e-6)


def test_ungated_compressed_refreshes_match_jax():
    """threshold < 0 turns the drift gate off: every one of the three
    non-forced refreshes ships through the compressed w8 wire."""
    ej, et, _ = _engines(hidden=2 * F, threshold=-1.0)
    ej.refresh(force=True)
    et.refresh(force=True)
    for step in range(3):
        nodes, edges = _query_stream(10 + step)
        _drive(ej, nodes, edges, 10.0 * step)
        _drive(et, nodes, edges, 10.0 * step)
        mj, mt = ej.refresh(), et.refresh()
        assert float(mt["transport_bits"]) > 0.0
        _check_metrics(mj, mt)
        for a, b in zip(_all_layers(ej, 2), _all_layers(et, 2)):
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
        assert et.status() == ej.status() == "CACHED"


def test_fresh_serving_matches_centralized():
    ej, et, (g, params, cfg) = _engines()
    et.refresh(force=True)
    emb, status = et.serve(np.arange(N))
    assert status == "FRESH"
    ref = tgnn.centralized_forward(params, cfg, g, device="cpu").numpy()
    assert np.max(np.abs(emb - ref)) <= TOL
    # a fully gated refresh recomputes from identical halos: still FRESH
    et.refresh(force=True)
    m = et.refresh()
    assert float(m["transport_bits"]) == 0.0 and et.status() == "FRESH"
    edge, _ = et.serve_edges([(5, 7)])
    assert edge.shape == (1, 2 * cfg.out_dim)


def test_flush_window_and_query_mass():
    _, et, _ = _engines()
    et.refresh(force=True)
    et.submit(3, "a", now=0.0)
    et.submit((5, 7), "b", now=0.0)
    assert et.flush(now=0.0) == []                   # window still open
    out = et.flush(now=1.0)
    got = {qy.nodes: emb for qy, emb in out}
    np.testing.assert_array_equal(got[(3,)], et.serve([3])[0][0])
    assert et.query_counts().sum() == 4              # 1 + 2 flushed + 1
    mass0 = et._ctl_state["mass"].clone()
    et.refresh()
    assert et.query_counts().sum() == 0
    assert not torch.allclose(et._ctl_state["mass"], mass0)


def test_microbatcher_deadline_and_fill():
    mb = MicroBatcher(np.array([0, 0, 1, 1], np.int64), window_s=0.010,
                      max_batch=2)
    assert not mb.ready(now=0.0)
    mb.submit(0, "a", now=0.0)
    assert not mb.ready(now=0.005) and mb.ready(now=0.011)
    mb.submit(2, "b", now=0.005)
    mb.submit((3,), "b", now=0.006)
    assert mb.ready(now=0.006)
    assert sorted(mb.drain()) == [0, 1]
    with pytest.raises(ValueError):
        mb.submit((1, 2, 3))


# ---------------------------------------------------------------------------
# control plane (host float32) against the JAX package
# ---------------------------------------------------------------------------


def test_policy_parse_matches_jax():
    for spec in ("auto:qos:2e9", "auto:qos:2e9:w8", "auto:qos:1.5e7:w4",
                 "auto:budget:3e8:w2:per-layer"):
        pt, pj = CommPolicy.parse(spec, 10), JPolicy.parse(spec, 10)
        assert str(pt) == str(pj)
        assert (pt.controller, pt.budget_bits, pt.max_width,
                pt.per_layer) == (pj.controller, pj.budget_bits,
                                  pj.max_width, pj.per_layer)
    # the open-loop modes are ported with the training slice
    for spec in ("full", "fixed:4", "varco:linear:5"):
        pt, pj = CommPolicy.parse(spec, 10), JPolicy.parse(spec, 10)
        assert (str(pt), pt.mode) == (str(pj), pj.mode)
    with pytest.raises(ValueError):
        CommPolicy.parse("auto:qos:1e8:w3", 10)


def test_pacing_waterfill_refine_match_jax():
    class Meta:
        halo_demand = 1234

    rng = np.random.default_rng(0)
    pt = tbase.make_pacing(Meta, (128, 256), 64, 5e8)
    pj = j_make_pacing(Meta, (128, 256), 64, 5e8)
    np.testing.assert_array_equal(pt.phi.numpy(), np.asarray(pj.phi))
    np.testing.assert_array_equal(pt.cum.numpy(), np.asarray(pj.cum))
    assert pt.d_full == pj.d_full
    for step in (0, 3, 63, 80):
        spent = np.float32(rng.uniform(0, 5e8))
        integ = np.float32(rng.uniform(-2, 2))
        bt, it = tbase.allowance(pt, spent, integ, step)
        bj, ij = j_allowance(pj, spent, integ, step)
        np.testing.assert_allclose(float(bt), float(bj), rtol=1e-6)
        np.testing.assert_allclose(float(it), float(ij), rtol=1e-6)
    live = ~np.eye(Q, dtype=bool)
    for _ in range(5):
        rows = rng.integers(0, 50, (Q, Q)).astype(np.float32) * live
        dens = np.where(live, rng.uniform(0, 3, (Q, Q)), -np.inf)
        cap = np.float32(rows.sum() * rng.uniform(0.05, 1.2))
        yt = tbase.waterfill(dens, rows, cap, 1 / 128, 1.0)
        yj = j_waterfill(dens.astype(np.float32), rows, cap, 1 / 128, 1.0)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6)
        rt, wt = tbase.refine_widths(yt, (32, 8, 4), torch.from_numpy(live))
        rj, wj = j_refine(np.asarray(yj), (32, 8, 4), live)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_drift_skip_and_ledger_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        delta = rng.uniform(0, 0.1, (Q, Q)).astype(np.float32)
        age = rng.integers(0, 6, (Q, Q)).astype(np.float32)
        np.testing.assert_array_equal(
            drift_skip(delta, age, 0.05, 4),
            np.asarray(j_drift_skip(delta, age, 0.05, 4)))
    led = CommLedger.zero().add_bits(3.0, 2.0).add_bits(np.float32(1.5))
    assert float(led.bits) == 4.5 and float(led.transport) == 3.5
    assert float(led.floats) == 4.5 / 32.0

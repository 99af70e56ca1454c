"""The port's GNN forward and its p2p inference step against the JAX
package's, at the JAX parameters carried over by ``params_from_jax``.

Tolerance 1e-5: the matmuls and scatter-adds sum f32 products in another
order than XLA's CPU kernels.  The inference step is compared at a
``[Q, Q]`` rate map with mixed per-pair rates and width maps, at a hidden
width of 256 (two lane-blocks), where the kept blocks depend on the key
stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist import gnn_parallel as jgp
from repro.dist.halo import attach_p2p as j_attach
from repro.dist.ratectl import RatePlan as JPlan
from repro.dist.ratectl import init_halo_cache as j_cache
from repro.graph.partition import partition_graph as j_partition
from repro.graph.synthetic import citation_graph as j_graph
from repro.nn import gnn as jgnn
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist.halo import attach_p2p
from repro_torch.dist.ratectl import RatePlan, init_halo_cache
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import citation_graph
from repro_torch.nn import gnn as tgnn

N, Q = 192, 4
TOL = 1e-5


def _params(cfg_j, seed=0):
    pj = jgnn.init_gnn(jax.random.key(seed), cfg_j)
    pt = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                              device="cpu")
    return pj, pt


def _cfgs(**kw):
    return jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)


@pytest.mark.parametrize("conv,layers,hidden", [("sage", 2, 128),
                                                ("sage", 3, 256),
                                                ("poly", 2, 128)])
def test_centralized_forward_matches_jax(conv, layers, hidden):
    g = citation_graph(n=N, feat_dim=128)
    cj, ct = _cfgs(conv=conv, in_dim=128, hidden=hidden,
                   out_dim=g.num_classes, layers=layers)
    pj, pt = _params(cj)
    want = np.asarray(jgnn.centralized_forward(pj, cj, j_graph(
        n=N, feat_dim=128)))
    got = tgnn.centralized_forward(pt, ct, g, device="cpu")
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_gnn_forward_hidden_out_and_params_layout():
    g = citation_graph(n=N, feat_dim=128)
    cj, ct = _cfgs(in_dim=128, hidden=128, out_dim=g.num_classes, layers=2)
    pj, pt = _params(cj)
    assert pt["layers"][0]["self"]["w"].shape == (128, 128)     # [in, out]
    assert set(pt["layers"][0]) == {"self", "neigh"}
    assert "b" not in pt["layers"][0]["neigh"]
    hidden: list = []
    dst, src = g.edge_list()
    w = np.asarray(1.0 / np.maximum(g.degrees(), 1)[dst], np.float32)
    agg = tgnn.centralized_aggregate_fn(
        N, torch.from_numpy(dst), torch.from_numpy(src), torch.from_numpy(w))
    logits, bits = tgnn.gnn_forward(pt, ct, torch.from_numpy(g.features),
                                    agg, hidden_out=hidden)
    assert len(hidden) == 2 and hidden[-1] is logits
    assert float(bits) == 0.0 and bool((hidden[0] >= 0).all())
    init = tgnn.init_gnn(ct, torch.Generator().manual_seed(0), device="cpu")
    assert init["layers"][1]["self"]["w"].shape == (128, g.num_classes)
    again = tgnn.init_gnn(ct, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(init["layers"][0]["self"]["w"],
                       again["layers"][0]["self"]["w"])


@pytest.fixture(scope="module")
def p2p_setup():
    """Partition + p2p arrays + params for both packages (in 256 features,
    hidden 256: every exchange has two lane-blocks to choose between)."""
    gj = j_graph(n=N, feat_dim=256)
    gt = citation_graph(n=N, feat_dim=256)
    cj, ct = _cfgs(in_dim=256, hidden=256, out_dim=gt.num_classes,
                   layers=2)
    pj, pt = _params(cj, seed=1)
    pgj = j_partition(gj, Q, scheme="metis-like")
    pgt = partition_graph(gt, Q, scheme="metis-like")
    graph_j = j_attach(pgj.device_arrays(), pgj)
    graph_t = attach_p2p(pgt.device_arrays("cpu"), pgt, "cpu")
    meta_j = jgp.DistMeta.build(pgj, pj, wire="p2p")
    meta_t = tgp.DistMeta.build(pgt, pt, wire="p2p")
    # one JAX infer step for every case: its jit cache is shared
    infer_j = jgp.make_infer_step(cj, JPolicy.parse("auto:qos:1e8", 8),
                                  meta_j)
    return dict(cj=cj, ct=ct, pj=pj, pt=pt, graph_j=graph_j,
                graph_t=graph_t, meta_j=meta_j, meta_t=meta_t,
                infer_j=infer_j)


def test_dist_meta_matches(p2p_setup):
    mj, mt = p2p_setup["meta_j"], p2p_setup["meta_t"]
    for name in ("q", "part_size", "halo_size", "num_nodes", "feat_dim",
                 "halo_demand", "cross_edges", "n_train", "n_val", "n_test",
                 "layer_dims", "p2p_hop_width", "p2p_compact", "pair_rows"):
        assert getattr(mj, name) == getattr(mt, name), name


def _plans(q):
    rng = np.random.default_rng(4)
    eye = np.eye(q, dtype=bool)
    rates = np.where(eye, 1.0, rng.choice([1.0, 1.5, 2.0, 3.7], (q, q)))
    w_mixed = np.where(eye, 32.0, rng.choice([8.0, 32.0, 5.0], (q, q)))
    w_low = np.where(eye, 32.0, rng.choice([2.0, 4.0, 8.0], (q, q)))
    skip = np.where(eye, 0.0, (rng.uniform(size=(q, q)) < 0.4))
    return {
        "rate1": (np.ones((q, q)), None, np.zeros((q, q))),
        "rates": (rates, None, np.zeros((q, q))),
        "rates_w_mixed": (rates, w_mixed, np.zeros((q, q))),
        "rates_w_subbyte": (rates, w_low, np.zeros((q, q))),
        "rates_skip": (rates, None, skip),
    }


@pytest.mark.parametrize("name", ["rate1", "rates", "rates_w_mixed",
                                  "rates_w_subbyte", "rates_skip"])
def test_infer_step_matches_jax(p2p_setup, name):
    s = p2p_setup
    rates, widths, skip = _plans(Q)[name]
    rates = rates.astype(np.float32)
    skip = skip.astype(np.float32)
    widths = None if widths is None else widths.astype(np.float32)
    infer_j = s["infer_j"]
    infer_t = tgp.make_infer_step(s["ct"], CommPolicy.parse("auto:qos:1e8", 8),
                                  s["meta_t"])
    # a warm cache: one exact pass first, so skipped pairs read real rows
    ones, zeros = np.ones((Q, Q), np.float32), np.zeros((Q, Q), np.float32)
    _, _, _, cj = infer_j(s["pj"], s["graph_j"], jax.random.key(7),
                          JPlan(jnp.asarray(ones), jnp.asarray(zeros)),
                          j_cache(s["meta_j"], s["cj"]))
    _, _, _, ct = infer_t(s["pt"], s["graph_t"], prng.key(7),
                          RatePlan(ones, zeros),
                          init_halo_cache(s["meta_t"], s["ct"], "cpu"))
    for a, b in zip(cj, ct):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
    key_j = jax.random.fold_in(jax.random.key(7), 1)
    _, hj, mj, cj2 = infer_j(
        s["pj"], s["graph_j"], key_j,
        JPlan(jnp.asarray(rates), jnp.asarray(skip),
              None if widths is None else jnp.asarray(widths)), cj)
    _, ht, mt, ct2 = infer_t(
        s["pt"], s["graph_t"], np.asarray(jax.random.key_data(key_j)),
        RatePlan(rates, skip, widths), ct)
    for a, b in zip(hj, ht):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
    for a, b in zip(cj2, ct2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=TOL)
    for k in ("halo_bits", "transport_bits", "pair_transport"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-6, err_msg=k)
    for k in ("pair_err", "pair_delta"):
        np.testing.assert_allclose(mt[k].numpy(), np.asarray(mj[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_static_facts_match(p2p_setup):
    mj, mt = p2p_setup["meta_j"], p2p_setup["meta_t"]
    rng = np.random.default_rng(0)
    for _ in range(20):
        rm = rng.uniform(1.0, 4.0, (Q, Q)).astype(np.float32)
        wm = rng.choice([2.0, 3.0, 4.0, 8.0, 9.0, 32.0], (Q, Q))
        assert tgp._packed_pair_k_for(mt, rm) == jgp._packed_pair_k_for(mj, rm)
        assert tgp._packed_pair_w_for(mt, wm) == jgp._packed_pair_w_for(mj, wm)
        assert tgp._packed_store_w(mt, wm) == jgp._packed_store_w(mj, wm)
        for nb in (1, 2, 4):
            np.testing.assert_array_equal(
                tgp._pair_keep(nb, rm, nb),
                np.asarray(jgp._pair_keep(nb, jnp.asarray(rm), nb)))
    for v in (1.0, 2.0, 2.5, 4.0, 7.9, 8.0, 8.1, 32.0):
        assert tgp._snap_width(v) == jgp._snap_width(v)
    vals = torch.arange(Q * (Q - 1), dtype=torch.float32).reshape(Q, Q - 1)
    np.testing.assert_array_equal(
        tgp._scatter_pairs(vals, Q).numpy(),
        np.asarray(jgp._scatter_pairs(jnp.asarray(vals.numpy()), Q)))

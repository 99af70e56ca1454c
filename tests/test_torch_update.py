"""The port's streaming edge updates and stochastic-rounding serving
against the JAX package's, on the CPU (``device="cpu"``: the plain
versions run), at the JAX package's serving-test size (N = 192, Q = 4,
2 sage layers).

Held: the rebuilt CSR and the touched set exactly; the patched activation
stack within 1e-5 (f32 sum order differs between the frameworks and
between ``np.add.at`` and ``index_add_``) with the frontiers exactly; an
engine's update within 1e-5 of ``centralized_forward`` on the new graph
and of the JAX engine's cache; a ``rounding="stochastic"`` engine's
embeddings within 1e-5 of the JAX engine's over three compressed
refreshes, with equal transport bits.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.graph.synthetic import citation_graph as j_graph
from repro.nn import gnn as jgnn
from repro.serve import ServingEngine as JEngine
from repro.serve import apply_edge_updates as j_apply
from repro.serve import incremental_recompute as j_recompute
from repro_torch.graph.data import normalized_edge_weights
from repro_torch.graph.synthetic import citation_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.serve import (ServingEngine, apply_edge_updates,
                               incremental_recompute)

N, F, Q, LAYERS = 192, 128, 4, 2
TOL = 1e-5


def _models(hidden=F):
    gj, gt = j_graph(n=N, feat_dim=F, seed=0), citation_graph(n=N,
                                                              feat_dim=F,
                                                              seed=0)
    cj = jgnn.GNNConfig(conv="sage", in_dim=F, hidden=hidden,
                        out_dim=gj.num_classes, layers=LAYERS)
    ct = tgnn.GNNConfig(conv="sage", in_dim=F, hidden=hidden,
                        out_dim=gt.num_classes, layers=LAYERS)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    pt = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                              device="cpu")
    return (gj, cj, pj), (gt, ct, pt)


def _batch(g, seed, n_ins=6, n_del=5):
    rng = np.random.default_rng(seed)
    dst0, src0 = g.edge_list()
    pick = rng.integers(0, len(dst0), n_del)
    return ((rng.integers(0, N, n_ins), rng.integers(0, N, n_ins)),
            (dst0[pick], src0[pick]))


def _hidden_stack(params, cfg, g):
    """Every layer's full-graph output on ``g`` (the cache's content)."""
    dst, src = g.edge_list()
    w = normalized_edge_weights(g)
    agg = tgnn.centralized_aggregate_fn(
        N, torch.from_numpy(dst), torch.from_numpy(src),
        torch.from_numpy(np.asarray(w, np.float32)))
    hidden: list = []
    tgnn.gnn_forward(params, cfg, torch.from_numpy(g.features), agg,
                     hidden_out=hidden)
    return [h.numpy() for h in hidden]


def test_apply_edge_updates_netting_and_csr_match_jax():
    (gj, _, _), (gt, _, _) = _models()
    dst0, src0 = gt.edge_list()
    es = set(zip(dst0.tolist(), src0.tolist()))
    absent = next((u, v) for u in range(N) for v in range(u + 1, N)
                  if (u, v) not in es)
    # inserting a present edge and deleting an absent one are no-ops
    g2, touched = apply_edge_updates(gt, inserts=([dst0[0]], [src0[0]]),
                                     deletes=([absent[0]], [absent[1]]))
    np.testing.assert_array_equal(g2.indptr, gt.indptr)
    np.testing.assert_array_equal(g2.indices, gt.indices)
    assert set(touched) == {dst0[0], src0[0], absent[0], absent[1]}
    # a real delete removes both directions
    g3, _ = apply_edge_updates(gt, deletes=([dst0[0]], [src0[0]]))
    assert g3.num_edges == gt.num_edges - 2
    g3.validate()
    # a mixed batch, and inserts only: CSR and touched as the JAX package's
    for inserts, deletes in (_batch(gt, 3), (_batch(gt, 4)[0], None)):
        g_t, t_t = apply_edge_updates(gt, inserts, deletes, bucket_nodes=32)
        g_j, t_j = j_apply(gj, inserts, deletes)
        np.testing.assert_array_equal(g_t.indptr, g_j.indptr)
        np.testing.assert_array_equal(g_t.indices, g_j.indices)
        assert g_t.indices.dtype == g_j.indices.dtype
        np.testing.assert_array_equal(t_t, t_j)
        assert t_t.dtype == np.int64


def test_incremental_recompute_matches_jax():
    (gj, cj, pj), (gt, ct, pt) = _models()
    inserts, deletes = _batch(gt, 7)
    hidden_old = _hidden_stack(pt, ct, gt)
    g2, touched = apply_edge_updates(gt, inserts, deletes)
    g2j, _ = j_apply(gj, inserts, deletes)
    got, fronts = incremental_recompute(pt, ct, g2, hidden_old, touched,
                                        device="cpu")
    want, fronts_j = j_recompute(pj, cj, g2j, hidden_old, touched)
    assert len(fronts) == LAYERS and len(fronts[0]) <= len(fronts[1])
    for f_t, f_j in zip(fronts, fronts_j):
        np.testing.assert_array_equal(f_t, f_j)
        assert f_t.dtype == np.int64
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)
    # and the patched stack is a fresh forward on the new graph
    for a, b in zip(got, _hidden_stack(pt, ct, g2)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL)
    # the input stack is not written
    np.testing.assert_array_equal(hidden_old[0],
                                  _hidden_stack(pt, ct, gt)[0])


def test_engine_apply_updates_matches_jax_and_centralized():
    (gj, cj, pj), (gt, ct, pt) = _models()
    ej = JEngine(gj, pj, cj, q=Q, seed=0)
    et = ServingEngine(gt, pt, ct, q=Q, seed=0, device="cpu")
    ej.refresh(force=True)
    et.refresh(force=True)
    inserts, deletes = _batch(gt, 3)
    t_j, f_j = ej.apply_updates(inserts=inserts, deletes=deletes)
    t_t, f_t = et.apply_updates(inserts=inserts, deletes=deletes)
    np.testing.assert_array_equal(t_t, t_j)
    for a, b in zip(f_t, f_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(et.owner, ej.owner)
    np.testing.assert_array_equal(et.g.indices, ej.g.indices)
    emb, status = et.serve(np.arange(N))
    assert status == "CACHED" == ej.status()
    ref = tgnn.centralized_forward(pt, ct, et.g, device="cpu").numpy()
    assert np.max(np.abs(emb - ref)) <= TOL
    for li in range(LAYERS):
        np.testing.assert_allclose(
            et.cache.gather(li, np.arange(N)),
            ej.cache.gather(li, np.arange(N)), rtol=0, atol=TOL)
    assert set(et.timing) == {"spill_s", "gather_s", "recompute_s",
                              "rebuild_s"}
    # the rebuilt engine refreshes on the new topology like the JAX one
    mj, mt = ej.refresh(force=True), et.refresh(force=True)
    np.testing.assert_allclose(float(mt["halo_bits"]),
                               float(mj["halo_bits"]), rtol=1e-6)
    emb2, status2 = et.serve(np.arange(N))
    assert status2 == "FRESH"
    assert np.max(np.abs(emb2 - emb)) <= TOL
    mj, mt = ej.refresh(), et.refresh()
    np.testing.assert_allclose(float(mt["transport_bits"]),
                               float(mj["transport_bits"]), rtol=1e-6)
    np.testing.assert_allclose(et.serve(np.arange(N))[0],
                               ej.serve(np.arange(N))[0], rtol=0, atol=TOL)


def test_stochastic_serving_matches_jax():
    """``rounding="stochastic"`` with the drift gate off: three compressed
    w8 refreshes after the cold one, each as the JAX engine's with the
    same seed; the same engine under ``"rint"`` serves other numbers."""
    (gj, cj, pj), (gt, ct, pt) = _models(hidden=2 * F)
    kw = dict(q=Q, seed=0, threshold=-1.0)
    ej = JEngine(gj, pj, cj, rounding="stochastic", **kw)
    et = ServingEngine(gt, pt, ct, device="cpu", rounding="stochastic", **kw)
    er = ServingEngine(gt, pt, ct, device="cpu", **kw)
    assert et.rounding == "stochastic" and er.rounding == "rint"
    for e in (ej, et, er):
        e.refresh(force=True)
    differs = False
    for _ in range(3):
        mj, mt, _ = ej.refresh(), et.refresh(), er.refresh()
        assert float(mt["transport_bits"]) > 0.0
        assert float(mt["transport_bits"]) == float(mj["transport_bits"])
        np.testing.assert_array_equal(mt["pair_transport"].numpy(),
                                      np.asarray(mj["pair_transport"]))
        for li in range(LAYERS):
            np.testing.assert_allclose(
                et.cache.gather(li, np.arange(N)),
                ej.cache.gather(li, np.arange(N)), rtol=0, atol=TOL)
        differs |= not np.array_equal(et.serve(np.arange(N))[0],
                                      er.serve(np.arange(N))[0])
    assert differs
    np.testing.assert_allclose(float(et.ledger.transport),
                               float(ej.ledger.transport), rtol=1e-6)


def test_update_entry_points_refuse():
    (_, _, _), (gt, ct, pt) = _models()
    hidden = _hidden_stack(pt, ct, gt)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            incremental_recompute(pt, ct, gt, hidden, np.array([0]))
    with pytest.raises(ValueError, match="conv='sage'"):
        incremental_recompute(pt, tgnn.GNNConfig(conv="poly", in_dim=F,
                                                 hidden=F, out_dim=4,
                                                 layers=LAYERS),
                              gt, hidden, np.array([0]), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        incremental_recompute(pt, ct, gt, hidden[:1], np.array([0]),
                              device="cpu")
    with pytest.raises(ValueError, match="rounding"):
        ServingEngine(gt, pt, ct, q=Q, device="cpu", rounding="nearest")

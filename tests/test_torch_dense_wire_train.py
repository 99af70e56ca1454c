"""``train_gnn`` on the dense and packed wires and the halos they deliver,
against the live JAX package on the CPU (``device="cpu"``).

Held: ``train_gnn`` of the JAX package's quickstart (``varco(epochs,
slope=5)`` on the default dense wire, and on the packed wire) with
per-epoch losses within 1e-5, rates and ledger at rel 1e-6 and
accuracies within one node; the halo the packed wire delivers bitwise
equal to the dense ``blockmask`` halo and to the p2p wire's remote values
at rate 2 (the JAX package's module note); the packed transport per
exchange exactly ``halo_demand × K·128 × 32``.  One step per policy and
compressor: ``tests/test_torch_dense_wire.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.varco import varco as j_varco
from repro.train.trainer import train_gnn as j_train
from repro_torch import prng
from repro_torch.core.varco import CommPolicy, varco
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist.halo import attach_p2p
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

from torch_wire_parity import (HIDDEN, LAYERS, TOL, _assert_rel, _metas, _port,
                               port_on_one_thread, world)


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

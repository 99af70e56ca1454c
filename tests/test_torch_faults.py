"""The port's fault plane (``repro_torch.dist.faults`` and the fault
channel of ``_make_aggregate_emulated``) against the live JAX package on
the CPU (``device="cpu"``: the plain versions of the kernels run).

The world is ``tiny_graph(n=256, F=128)`` cut ``metis-like`` into Q = 4,
written as a shard set by the port and loaded by both packages, and a
2-layer SAGE at hidden 256 (the second exchange has two lane-blocks, so
rate maps pick kept counts per pair).  Held exactly: the schedule's
masks, latencies, crashes and shrinks, 40 steps of the degradation
ladder, the shrunk shard arrays and spec, and the controller-state
migration.  One fault step per policy (a fresh step, then one with
CACHED and DEAD pairs served from the fresh step's fault cache) holds
loss, updated parameters (SGD with momentum), ``fcache'`` and metrics
within 1e-5, the ledger (``halo_bits``, ``transport_bits``,
``pair_transport``) at rel 1e-6 and ``pair_err`` at rel 1e-5; under w8
a deeper cached value on a rounding boundary may land one level apart,
as ``tests/test_torch_auto_wires.py`` allows.  ``train_gnn`` under a
schedule that drops, spikes, kills pairs and crashes worker 1 at epoch 3
holds every epoch's loss within 1e-5 of the JAX package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist import faults as jf
from repro.dist import gnn_parallel as jgp
from repro.dist import ratectl as jrc
from repro.graph import stream as js
from repro.nn import gnn as jgnn
from repro.train import optim as joptim
from repro.train.trainer import train_gnn as j_train
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import faults as tf
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist import ratectl as trc
from repro_torch.graph import stream as ts
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

N, F, HIDDEN, LAYERS, Q = 256, 128, 256, 2, 4
TOL = 1e-5
SCHED = dict(q=Q, seed=0, drop_rate=0.25, spike_rate=0.05,
             crash_at=((3, 1),))


def _port(tree):
    return tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults")
    g = tiny_graph(n=N, feat_dim=F)
    st = ts.write_graph_store(g, root / "store")
    ts.write_shards(st, ts.stream_partition(st, Q, "metis-like", seed=0),
                    root / "shards")
    kw = dict(conv="sage", in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
              layers=LAYERS)
    cj, ct = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    tsh, jsh = ts.load_shards(root / "shards"), js.load_shards(root / "shards")
    return {"dir": str(root / "shards"), "cj": cj, "ct": ct, "pj": pj,
            "tsh": tsh, "jsh": jsh,
            "graph_t": tsh.device_arrays("cpu"),
            "graph_j": jsh.device_arrays(),
            "meta_t": tgp.DistMeta.build(tsh, _port(pj), wire="p2p"),
            "meta_j": jgp.DistMeta.build(jsh, pj, wire="p2p")}


# ---------------------------------------------------------------------------
# Schedule, ladder, shrink, migration: exact
# ---------------------------------------------------------------------------


def test_schedule_matches_jax():
    for kw in (SCHED, dict(q=5, seed=7, drop_rate=0.4, spike_rate=0.3,
                           spike_factor=6.0, crash_at=((2, 4), (5, 0)))):
        t, j = tf.FaultSchedule(**kw), jf.FaultSchedule(**kw)
        for _ in range(3):
            for step in range(8):
                for fn in ("link_drops", "latency", "effective_drops"):
                    a, b = getattr(t, fn)(step), getattr(j, fn)(step)
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                assert t.crash_at_step(step) == j.crash_at_step(step)
            assert t.alive_workers == j.alive_workers and t.cur_q == j.cur_q
            t, j = t.shrink(1), j.shrink(1)
    with pytest.raises(ValueError):
        tf.FaultSchedule(q=4, drop_rate=1.5)
    with pytest.raises(ValueError):
        tf.FaultSchedule(q=4, alive=(2, 1))
    with pytest.raises(ValueError):
        tf.FaultSchedule(q=4).shrink(4)


@pytest.mark.parametrize("max_stale,backoff_cap", [(2, 16), (1, 4), (5, 8)])
def test_degrade_plan_sequence_matches_jax(max_stale, backoff_cap):
    t, j = tf.FaultSchedule(**SCHED), jf.FaultSchedule(**SCHED)
    st, sj = tf.init_degrade(Q), jf.init_degrade(Q)
    seen = set()
    for step in range(40):
        drops, drops_j = t.effective_drops(step), j.effective_drops(step)
        if 10 <= step < 18 or step % 7 == 3:   # outages reach DEAD
            drops = drops_j = np.ones_like(drops)
        sv_t, st = tf.degrade_plan(st, drops, step, max_stale=max_stale,
                                   backoff_cap=backoff_cap)
        sv_j, sj = jf.degrade_plan(sj, drops_j, step, max_stale=max_stale,
                                   backoff_cap=backoff_cap)
        assert sv_t.dtype == sv_j.dtype
        np.testing.assert_array_equal(sv_t, sv_j)
        for k in ("age", "backoff", "next_try"):
            np.testing.assert_array_equal(getattr(st, k), getattr(sj, k))
        for a, b in zip(tf.serve_masks(sv_t), jf.serve_masks(sv_j)):
            np.testing.assert_array_equal(a, b)
        seen |= set(np.unique(sv_t).tolist())
    assert seen == {tf.FRESH, tf.CACHED, tf.DEAD}
    mt, mj = tf.migrate_degrade_state(st, 2), jf.migrate_degrade_state(sj, 2)
    for k in ("age", "backoff", "next_try"):
        np.testing.assert_array_equal(getattr(mt, k), getattr(mj, k))
    with pytest.raises(ValueError):
        tf.degrade_plan(st, np.zeros((Q, Q)), 0, max_stale=0)


@pytest.mark.parametrize("dead", [0, 1, 3])
def test_shrink_shards_matches_jax(world, dead):
    a, b = tf.shrink_shards(world["tsh"], dead), \
        jf.shrink_shards(world["jsh"], dead)
    assert a.halo_spec == tf.shrink_shards(world["tsh"], dead).halo_spec
    assert a.halo_spec.to_dict() == b.halo_spec.to_dict()
    for k in ("q", "part_size", "halo_size", "halo_demand", "cross_edges",
              "n_train", "n_val", "n_test", "name", "parts"):
        assert getattr(a, k) == getattr(b, k), k
    assert list(a.arrays) == list(b.arrays)
    for k, v in a.arrays.items():
        w = np.asarray(b.arrays[k])
        assert v.dtype == w.dtype, k
        np.testing.assert_array_equal(v, w, err_msg=k)
    # twice over, as a run that loses two workers does
    a2, b2 = tf.shrink_shards(a, 0), jf.shrink_shards(b, 0)
    for k, v in a2.arrays.items():
        np.testing.assert_array_equal(v, np.asarray(b2.arrays[k]))
    with pytest.raises(ValueError):
        tf.shrink_shards(world["tsh"], Q)
    with pytest.raises(TypeError):
        tf.shrink_shards("not a shard set", 0)
    with pytest.raises(ValueError, match="all partitions"):
        tf.shrink_shards(ts.load_shards(world["dir"], parts=[0, 1]), 0)


@pytest.mark.parametrize("spec", ["auto:budget:1e9:per-layer",
                                  "auto:error:1e9:w8",
                                  "auto:stale:1e9", "auto:qos:1e9"])
def test_migrate_controller_state_matches_jax(world, spec):
    ct, cj = world["ct"], world["cj"]
    st = trc.make_controller(CommPolicy.parse(spec, 4), world["meta_t"], ct,
                             total_steps=4).init()
    sj = jrc.make_controller(JPolicy.parse(spec, 4), world["meta_j"], cj,
                             total_steps=4).init()
    assert sorted(st) == sorted(sj)
    rng = np.random.default_rng(5)
    for k in st:                       # distinct values, the same each side
        if isinstance(st[k], torch.Tensor):
            v = rng.normal(size=tuple(st[k].shape)).astype(np.float32)
            st[k] = torch.from_numpy(v).to(st[k].dtype)
            sj[k] = jnp.asarray(v).astype(sj[k].dtype)
    mt, mj = tf.migrate_controller_state(st, 2, Q), \
        jf.migrate_controller_state(sj, 2, Q)
    assert sorted(mt) == sorted(mj)
    cut = 0
    for k in mt:
        a, b = mt[k], mj[k]
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            cut += tuple(a.shape[-2:]) == (Q - 1, Q - 1)
    assert cut >= (0 if spec.startswith("auto:budget") else 1)


# ---------------------------------------------------------------------------
# One fault step per policy
# ---------------------------------------------------------------------------


def _masks():
    fskip = np.zeros((Q, Q), np.float32)
    dead = np.zeros((Q, Q), np.float32)
    fskip[2, 0] = fskip[1, 3] = 1.0
    dead[0, 1] = dead[3, 2] = 1.0
    return fskip, dead


def _plans(spec: str, epochs: int):
    """``(port plan, JAX plan, residual caches?)`` at epoch 1."""
    tpol, jpol = CommPolicy.parse(spec, epochs, compressor="blockmask"), \
        JPolicy.parse(spec, epochs, compressor="blockmask")
    if tpol.mode != "auto":
        r = float(tpol.rate(1)) if tpol.compresses else 1.0
        return tpol, jpol, trc.uniform_plan(Q, r), jrc.uniform_plan(Q, r)
    rng = np.random.default_rng(11)
    rates = rng.choice([1.0, 2.0], (Q, Q)).astype(np.float32)
    np.fill_diagonal(rates, 1.0)
    widths = np.full((Q, Q), 8.0, np.float32)
    np.fill_diagonal(widths, 32.0)
    zeros = np.zeros((Q, Q), np.float32)
    return tpol, jpol, \
        trc.RatePlan(torch.from_numpy(rates), torch.from_numpy(zeros),
                     torch.from_numpy(widths)), \
        jrc.RatePlan(jnp.asarray(rates), jnp.asarray(zeros),
                     jnp.asarray(widths))


def _assert_fcache(fc_t, fc_j, quantised: bool):
    assert len(fc_t) == len(fc_j)
    for li, (a, b) in enumerate(zip(fc_t, fc_j)):
        a, b = a.numpy(), np.asarray(b)
        if not quantised or li == 0:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
            continue
        off = np.abs(a - b) > TOL      # a value on a rounding boundary
        assert off.mean() <= 1e-4, (li, int(off.sum()))
        assert np.abs(a - b).max() <= np.abs(b).max() + TOL


@pytest.mark.parametrize("spec", ["full", "fixed:4", "varco:linear:5",
                                  "auto:budget:1e9:w8"])
def test_fault_step_matches_jax(world, spec):
    ct, cj = world["ct"], world["cj"]
    tpol, jpol, plan_t, plan_j = _plans(spec, 4)
    opt_t, opt_j = toptim.sgd(0.1, momentum=0.9), \
        joptim.sgd(0.1, momentum=0.9)
    step_t = tf.make_fault_train_step(ct, tpol, opt_t, world["meta_t"])
    step_j = jf.make_fault_train_step(cj, jpol, opt_j, world["meta_j"])
    pj = world["pj"]
    pt, ot, oj = _port(pj), opt_t.init(_port(pj)), opt_j.init(pj)
    quant = spec.endswith("w8")
    cache_t = trc.init_wire_residuals(world["meta_t"], ct, "cpu") \
        if quant else ()
    cache_j = jrc.init_wire_residuals(world["meta_j"], cj) if quant else ()
    fc_t = trc.init_halo_cache(world["meta_t"], ct, "cpu")
    fc_j = jrc.init_halo_cache(world["meta_j"], cj)
    zeros = np.zeros((Q, Q), np.float32)
    for k, (fskip, dead) in enumerate([(zeros, zeros), _masks()]):
        pt, ot, mt, cache_t, fc_t = step_t(pt, ot, world["graph_t"],
                                           prng.key(k), plan_t, fskip, dead,
                                           cache_t, fc_t)
        pj, oj, mj, cache_j, fc_j = step_j(pj, oj, world["graph_j"],
                                           jax.random.key(k), plan_j,
                                           fskip, dead, cache_j, fc_j)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=0, atol=TOL)
        _assert_rel(mt["rate"], mj["rate"])
        for key in ("halo_bits", "transport_bits", "pair_transport"):
            _assert_rel(mt[key], mj[key])
        _assert_rel(mt["pair_err"], mj["pair_err"], rtol=1e-5)
        _assert_tree_close(pt, pj)
        _assert_fcache(fc_t, fc_j, quant)
        assert len(cache_t) == len(cache_j)
    # the cached and dead pairs charged nothing on the second step
    fskip, dead = _masks()
    pair = np.asarray(mt["pair_transport"])
    assert (pair[(fskip + dead) > 0] == 0).all()
    assert (pair[(fskip + dead + np.eye(Q)) == 0] > 0).all()


def test_fault_step_rejects_bad_setups(world):
    ct = world["ct"]
    opt = toptim.sgd(0.1)
    with pytest.raises(ValueError, match="communicating"):
        tf.make_fault_train_step(ct, CommPolicy.parse("none", 1), opt,
                                 world["meta_t"])
    from repro_torch.core.collectives import WorkerMesh
    two = WorkerMesh(q=2, rank=0, device=torch.device("cpu"),
                     backend="gloo")
    with pytest.raises(ValueError, match="mesh has 2 workers"):
        tf.make_fault_train_step(ct, CommPolicy.parse("full", 1), opt,
                                 world["meta_t"], mesh=two)
    import dataclasses
    with pytest.raises(ValueError, match="p2p"):
        tf.make_fault_train_step(ct, CommPolicy.parse("full", 1), opt,
                                 dataclasses.replace(world["meta_t"],
                                                     wire="dense"))
    step = tf.make_fault_train_step(ct, CommPolicy.parse("full", 1), opt,
                                    world["meta_t"])
    z = np.zeros((Q, Q), np.float32)
    p = _port(world["pj"])
    with pytest.raises(ValueError, match="fcache"):
        step(p, opt.init(p), world["graph_t"], prng.key(0),
             trc.uniform_plan(Q, 1.0), z, z, (), ())


# ---------------------------------------------------------------------------
# The cached-pair and all-dark identities
# ---------------------------------------------------------------------------


def _fault_forward(world, fskip, dead, fcache, spec="full"):
    meta, graph, ct = world["meta_t"], world["graph_t"], world["ct"]
    pol = CommPolicy.parse(spec, 1, compressor="blockmask")
    rm = np.ones((Q, Q), np.float32)
    fe: list = []
    agg = tgp._make_aggregate_emulated(
        graph, meta, pol, torch.ones(()), prng.key(3),
        packed_k=dict(tgp._packed_pair_k_for(meta, rm)), rate_map=rm,
        fskip=fskip, fcache=fcache, fcache_out=fe, dead=dead)
    with torch.no_grad():
        logits, bits = tgnn.gnn_forward(_port(world["pj"]), ct,
                                        graph["features"], agg)
    return logits, bits.numpy().astype(np.float64), tuple(fe)


def test_cached_pair_is_bitwise_and_charges_zero_bits(world):
    zeros = np.zeros((Q, Q), np.float32)
    l0, b0, fresh = _fault_forward(world, zeros, zeros,
                                   trc.init_halo_cache(world["meta_t"],
                                                       world["ct"], "cpu"))
    fskip = zeros.copy()
    fskip[2, 0] = 1.0
    l1, b1, served = _fault_forward(world, fskip, zeros, fresh)
    assert torch.equal(l0, l1)
    for a, b in zip(served, fresh):
        assert torch.equal(a, b)
    lq2 = LAYERS * Q * Q
    t0 = b0[2:2 + lq2].reshape(LAYERS, Q, Q)
    t1 = b1[2:2 + lq2].reshape(LAYERS, Q, Q)
    assert t0[:, 2, 0].sum() > 0 and t1[:, 2, 0].sum() == 0.0
    assert b1[0] < b0[0] and b1[1] < b0[1]
    np.testing.assert_allclose(b0[1] - b1[1], t0[:, 2, 0].sum())


def test_all_dark_matches_no_comm(world):
    zeros = np.zeros((Q, Q), np.float32)
    dead = 1.0 - np.eye(Q, dtype=np.float32)
    l1, b1, _ = _fault_forward(world, zeros, dead,
                               trc.init_halo_cache(world["meta_t"],
                                                   world["ct"], "cpu"))
    assert b1[0] == 0.0 and b1[1] == 0.0
    agg = tgp._make_aggregate_emulated(
        world["graph_t"], world["meta_t"], CommPolicy.parse("none", 1),
        torch.ones(()), prng.key(3))
    with torch.no_grad():
        l_iso, _ = tgnn.gnn_forward(_port(world["pj"]), world["ct"],
                                    world["graph_t"]["features"], agg)
    np.testing.assert_allclose(l1.numpy(), l_iso.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(tgp._dead_mix(world["meta_t"], dead),
                                  np.asarray(jgp._dead_mix(world["meta_j"],
                                                           dead)))


def test_fault_channel_needs_the_p2p_rate_map_wire(world):
    z = np.zeros((Q, Q), np.float32)
    with pytest.raises(ValueError, match="fault channel"):
        tgp._make_aggregate_emulated(world["graph_t"], world["meta_t"],
                                     CommPolicy.parse("full", 1),
                                     torch.ones(()), prng.key(0), dead=z)


# ---------------------------------------------------------------------------
# train_gnn under faults, with a crash on the shard set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["varco:linear:5", "auto:budget:2e7:w8"])
def test_train_gnn_faults_with_crash_matches_jax(world, spec):
    ep = 6
    kw = dict(epochs=ep, hidden=HIDDEN, layers=LAYERS, eval_every=1,
              wire="p2p", seed=0, fault_max_stale=2)
    rj = j_train(world["dir"], policy=JPolicy.parse(spec, ep,
                                                    compressor="blockmask"),
                 faults=jf.FaultSchedule(**SCHED),
                 optimizer=joptim.sgd(0.1, momentum=0.9), **kw)
    rt = train_gnn(world["dir"], policy=CommPolicy.parse(
        spec, ep, compressor="blockmask"), faults=tf.FaultSchedule(**SCHED),
        optimizer=toptim.sgd(0.1, momentum=0.9), device="cpu",
        params=_port(jgnn.init_gnn(jax.random.key(0), world["cj"])), **kw)
    hj, ht = rj.history, rt.history
    assert rt.meta.q == rj.meta.q == Q - 1
    assert ht.epoch == hj.epoch == list(range(ep))
    np.testing.assert_allclose(ht.loss, hj.loss, rtol=0, atol=TOL)
    np.testing.assert_allclose(ht.rate, hj.rate, rtol=1e-6, atol=0)
    for col in ("halo_gfloats", "transport_gfloats"):
        _assert_rel(getattr(ht, col), getattr(hj, col))
    assert len(ht.pair_transport_gf[-1]) == (Q - 1) ** 2
    for a, b in zip(ht.pair_transport_gf, hj.pair_transport_gf, strict=True):
        _assert_rel(a, b)       # [Q·Q] before the crash, [(Q-1)²] after
    _assert_tree_close(rt.params, rj.params, tol=1e-4)
    # in-memory partitions cannot take the elastic path
    with pytest.raises(ValueError, match="shard-backed"):
        train_gnn(tiny_graph(n=N, feat_dim=F), q=Q, policy=CommPolicy.parse(
            spec, ep, compressor="blockmask"),
            faults=tf.FaultSchedule(**SCHED), device="cpu", **kw)

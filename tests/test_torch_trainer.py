"""The port's ``train_gnn`` against a live JAX ``train_gnn`` on the CPU
(``device="cpu"``), from the same initial parameters (the JAX package's
``init_gnn`` carried over by ``params_from_jax``), over the p2p wire.

Held per logged epoch: the loss within 1e-5 at epoch 0 and 1e-4 after
(AdamW's normalised steps amplify f32 sum-order differences of near-zero
gradients), rates at rel 1e-6, accuracies within one node of each split,
and the ledger columns (halo and transport Gfloats, the per-pair
transport split, the measured compression error) at rel 1e-6.  The
quantised policy plans w8 on most steps, and there its hops ride the
sub-byte branch with ``store_w = 8``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.core.varco import CommPolicy as JPolicy
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.nn import gnn as jgnn
from repro.train.trainer import train_gnn as j_train
from repro_torch.core.varco import CommPolicy
from repro_torch.dist.faults import FaultSchedule
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

N, F, HIDDEN, LAYERS, Q, E = 256, 128, 256, 3, 4, 4


def _full_transport_bits() -> float:
    """Full-rate transport of the run's ``E`` epochs (both directions)."""
    pg = partition_graph(tiny_graph(n=N, feat_dim=F), Q, seed=0)
    return 2.0 * 32.0 * pg.halo_demand * (F + HIDDEN * (LAYERS - 1)) * E


def _specs() -> dict:
    half = 0.5 * _full_transport_bits()
    return {"full": "full", "none": "none", "fixed2": "fixed:2",
            "varco": "varco:linear:5",
            "auto_budget": f"auto:budget:{half:g}",
            "auto_budget_w8": f"auto:budget:{half:g}:w8",
            "auto_budget_w4_layers": f"auto:budget:{half:g}:w4:per-layer"}


def _runs(spec):
    g, gj = tiny_graph(n=N, feat_dim=F), j_tiny(n=N, feat_dim=F)
    cj = jgnn.GNNConfig(in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
                        layers=LAYERS)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    kw = dict(q=Q, scheme="random", epochs=E, hidden=HIDDEN, layers=LAYERS,
              seed=0, eval_every=1, wire="p2p")
    rj = j_train(gj, policy=JPolicy.parse(spec, E, compressor="blockmask"),
                 **kw)
    rt = train_gnn(g, policy=CommPolicy.parse(spec, E,
                                              compressor="blockmask"),
                   device="cpu", params=tgnn.params_from_jax(
                       jax.tree_util.tree_map(np.asarray, pj), "cpu"), **kw)
    return rj, rt


@pytest.mark.parametrize("name", list(_specs()))
def test_train_gnn_matches_jax(name):
    spec = _specs()[name]
    rj, rt = _runs(spec)
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
    assert len(ht.pair_transport_gf) == len(hj.pair_transport_gf)
    for a, b in zip(ht.pair_transport_gf, hj.pair_transport_gf):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ht.comp_err, hj.comp_err, rtol=1e-5, atol=0)
    assert rt.policy_desc == rj.policy_desc
    assert [r.keys() for r in ht.rows()] == [r.keys() for r in hj.rows()]
    floor = CommPolicy.parse(spec, E).max_width if ":w" in spec else 32
    if floor < 32:
        # the controller picks the narrow width whenever the allowance
        # cannot buy the exact wire at full rate
        assert set(ht.width) <= {float(w) for w in (2, 4, 8, 32)
                                 if w >= floor}
        assert sum(w < 32 for w in ht.width) >= 2
        assert ht.transport_gfloats[-1] < 0.5 * _full_transport_bits() / \
            32.0 / 1e9
    else:
        assert ht.width == [32.0] * E
    if "per-layer" in spec:
        np.testing.assert_allclose(ht.layer_split(Q), hj.layer_split(Q),
                                   rtol=1e-6)
    if name != "none":
        assert ht.transport_gfloats[-1] > 0.0
    assert np.isfinite(ht.loss).all() and all(s >= 0 for s in ht.step_s)


def test_train_gnn_reuses_a_partitioned_graph_and_refuses_unported(
        tmp_path):
    g = tiny_graph(n=128, feat_dim=F)
    pg = partition_graph(g, 2, scheme="random", seed=0)
    pol = CommPolicy.parse("fixed:2", 2, compressor="blockmask")
    kw = dict(policy=pol, epochs=2, hidden=128, layers=2, wire="p2p",
              eval_every=1, device="cpu", optimizer=toptim.sgd(0.1))
    a = train_gnn(g, q=2, scheme="random", **kw).history
    b = train_gnn(pg, q=7, scheme="metis-like", **kw).history
    assert a.loss == b.loss and a.transport_gfloats == b.transport_gfloats
    # the worker backend runs with checkpoints too (tests/
    # test_torch_dist_resume.py); resuming it reads the checkpoint before
    # any worker starts, so a missing one is refused in this process
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        train_gnn(pg, **{**kw, "use_shard_map": True, "resume": True,
                         "checkpoint_dir": str(tmp_path / "ck")})
    # ported since: resume needs a checkpoint directory, a path must be a
    # shard directory, and checkpointed and faulted runs train (their
    # parity: tests/test_torch_resume.py, tests/test_torch_faults.py)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        train_gnn(pg, **{**kw, "resume": True})
    with pytest.raises(FileNotFoundError):
        train_gnn(str(tmp_path / "shards"), **kw)
    ck = str(tmp_path / "ckpt")
    part = train_gnn(pg, **{**kw, "checkpoint_dir": ck,
                            "stop_after": 1}).history
    rest = train_gnn(pg, **{**kw, "checkpoint_dir": ck,
                            "resume": True}).history
    assert part.loss == b.loss[:1] and rest.loss == b.loss[1:]
    faulted = train_gnn(pg, **{**kw, "faults": FaultSchedule(
        q=2, drop_rate=0.0)}).history
    np.testing.assert_allclose(faulted.loss, b.loss, rtol=0, atol=1e-6)
    # the stale controller is ported now: the same call trains (its
    # parity with the JAX package: tests/test_torch_auto_wires.py)
    stale = train_gnn(pg, **{**kw, "policy": CommPolicy.parse(
        "auto:stale:1e9", 2)}).history
    assert np.isfinite(stale.loss).all() and stale.transport_gfloats[-1] > 0

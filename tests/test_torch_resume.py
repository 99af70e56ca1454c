"""Crash-consistent checkpoint/resume in the port (``repro_torch.train.
checkpoint`` and ``train_gnn(checkpoint_dir=..., stop_after=...,
resume=True)``) on the CPU.

A run interrupted by ``stop_after`` and resumed equals the port's own
uninterrupted run **bitwise** — losses, rates, accuracies, the cumulative
ledger and the final parameters — for ``full``, ``fixed:4``,
``auto:budget:…:w8`` (controller state and error-feedback residuals ride
the checkpoint) and a faulted run whose worker 1 crashes at epoch 3,
interrupted after the shrink (the resume replays the shrink; the fault
cache and the ladder state ride the checkpoint).  The uninterrupted runs
hold every epoch's loss within 1e-5 of the live JAX package's (from the
same initial parameters, SGD with momentum; the checkpointed runs use
the default AdamW).  ``restore`` names the path of a leaf at fault.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist.faults import FaultSchedule as JSchedule
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.nn import gnn as jgnn
from repro.train import optim as joptim
from repro.train.trainer import train_gnn as j_train
from repro_torch.core.varco import CommPolicy
from repro_torch.dist.faults import FaultSchedule
from repro_torch.graph import stream as ts
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

N, F, HIDDEN, LAYERS, Q, E = 256, 128, 256, 2, 4, 7
SCHED = dict(q=Q, seed=0, drop_rate=0.25, spike_rate=0.05,
             crash_at=((3, 1),))
#: name -> (policy spec, faulted, the epoch to interrupt after)
RUNS = {"full": ("full", False, 3),
        "fixed4": ("fixed:4", False, 4),
        "auto_budget_w8": ("auto:budget:3e7:w8", False, 3),
        "faulted_shrunk": ("varco:linear:5", True, 5)}


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    st = ts.write_graph_store(tiny_graph(n=N, feat_dim=F), root / "store")
    ts.write_shards(st, ts.stream_partition(st, Q, "metis-like", seed=0),
                    root / "shards")
    return str(root / "shards")


def _train(name, shard_dir, **kw):
    spec, faulted, _ = RUNS[name]
    g = shard_dir if faulted else tiny_graph(n=N, feat_dim=F)
    extra = dict(faults=FaultSchedule(**SCHED), fault_max_stale=2) \
        if faulted else {}
    return train_gnn(g, q=Q, policy=CommPolicy.parse(
        spec, E, compressor="blockmask"), epochs=E, hidden=HIDDEN,
        layers=LAYERS, seed=0, eval_every=1, wire="p2p", device="cpu",
        **extra, **kw)


_uninterrupted: dict = {}


def _full(name, shard_dir):
    if name not in _uninterrupted:
        _uninterrupted[name] = _train(name, shard_dir)
    return _uninterrupted[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_resume_is_bitwise(name, shard_dir, tmp_path):
    k = RUNS[name][2]
    full = _full(name, shard_dir)
    ck = str(tmp_path / "ck")
    part = _train(name, shard_dir, checkpoint_dir=ck, stop_after=k)
    assert len(part.history.loss) == k, "stop_after must halt the run"
    assert sorted(os.listdir(ck)) == [ckpt.TRAIN_STATE_FILE]
    extra = ckpt.peek(ckpt.latest_checkpoint(ck))
    assert extra["step"] == k and extra["q"] == part.meta.q
    resumed = _train(name, shard_dir, checkpoint_dir=ck, resume=True)
    hf, hr = full.history, resumed.history
    assert hr.epoch == hf.epoch[k:]
    for col in ("loss", "rate", "train_acc", "val_acc", "test_acc",
                "halo_gfloats", "transport_gfloats", "pair_transport_gf",
                "layer_transport_gf", "comp_err"):
        assert getattr(hr, col) == getattr(hf, col)[k:], col
    assert resumed.meta == full.meta
    for a, b in zip(toptim.tree_leaves(resumed.params),
                    toptim.tree_leaves(full.params)):
        assert torch.equal(a, b)
    if RUNS[name][1]:
        assert extra["alive"] == [0, 2, 3] and resumed.meta.q == Q - 1


@pytest.mark.parametrize("name", list(RUNS))
def test_uninterrupted_run_matches_jax(name, shard_dir):
    spec, faulted, _ = RUNS[name]
    cj = jgnn.GNNConfig(in_dim=F, hidden=HIDDEN, out_dim=4, layers=LAYERS)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    kw = dict(q=Q, epochs=E, hidden=HIDDEN, layers=LAYERS, seed=0,
              eval_every=1, wire="p2p")
    jf = dict(faults=JSchedule(**SCHED), fault_max_stale=2) if faulted \
        else {}
    tf = dict(faults=FaultSchedule(**SCHED), fault_max_stale=2) if faulted \
        else {}
    rj = j_train(shard_dir if faulted else j_tiny(n=N, feat_dim=F),
                 policy=JPolicy.parse(spec, E, compressor="blockmask"),
                 optimizer=joptim.sgd(0.1, momentum=0.9), **jf, **kw)
    rt = train_gnn(shard_dir if faulted else tiny_graph(n=N, feat_dim=F),
                   policy=CommPolicy.parse(spec, E, compressor="blockmask"),
                   optimizer=toptim.sgd(0.1, momentum=0.9), device="cpu",
                   params=tgnn.params_from_jax(
                       jax.tree_util.tree_map(np.asarray, pj), "cpu"),
                   **tf, **kw)
    assert rt.history.epoch == rj.history.epoch == list(range(E))
    np.testing.assert_allclose(rt.history.loss, rj.history.loss, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rt.history.transport_gfloats,
                               rj.history.transport_gfloats, rtol=1e-6,
                               atol=0)
    assert rt.meta.q == rj.meta.q


def test_resume_requires_checkpoint(shard_dir, tmp_path):
    with pytest.raises(FileNotFoundError):
        _train("full", shard_dir, checkpoint_dir=str(tmp_path / "none"),
               resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _train("full", shard_dir, resume=True)
    # a shrunk run resumes only from shard-backed input
    ck = str(tmp_path / "ck")
    _train("faulted_shrunk", shard_dir, checkpoint_dir=ck, stop_after=4)
    with pytest.raises(ValueError, match="shard-backed"):
        train_gnn(tiny_graph(n=N, feat_dim=F), q=Q,
                  policy=CommPolicy.parse("varco:linear:5", E,
                                          compressor="blockmask"),
                  epochs=E, hidden=HIDDEN, layers=LAYERS, wire="p2p",
                  device="cpu", faults=FaultSchedule(**SCHED),
                  checkpoint_dir=ck, resume=True)
    # a checkpoint of another world size is refused
    ck2 = str(tmp_path / "ck2")
    _train("full", shard_dir, checkpoint_dir=ck2, stop_after=1)
    with pytest.raises(ValueError, match="world size"):
        train_gnn(tiny_graph(n=N, feat_dim=F), q=2,
                  policy=CommPolicy.parse("full", E), epochs=E,
                  hidden=HIDDEN, layers=LAYERS, wire="p2p", device="cpu",
                  checkpoint_dir=ck2, resume=True)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((3, 4), generator=gen),
                       "b": torch.randn((4,), generator=gen)
                       .to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mom": None},
            "cache": (torch.zeros((2, 0, 5)), torch.tensor([True, False])),
            "ids": [torch.arange(5, dtype=torch.int64)]}


def test_save_restore_roundtrip_is_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "d" / "state.ckpt")
    ckpt.save(path, tree, extra={"epoch": 3, "alive": [0, 2]})
    assert sorted(os.listdir(tmp_path / "d")) == ["state.ckpt"]
    assert ckpt.peek(path) == {"epoch": 3, "alive": [0, 2]}
    out, extra = ckpt.restore(path, tree)
    assert extra["epoch"] == 3 and out["opt"]["mom"] is None
    assert isinstance(out["cache"], tuple) and isinstance(out["ids"], list)
    for a, b in zip(toptim.tree_leaves(out), toptim.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device and torch.equal(a, b)
    # overwriting in place leaves one file and the new contents
    tree["params"]["w"] += 1.0
    ckpt.save(path, tree)
    assert torch.equal(ckpt.restore(path, tree)[0]["params"]["w"],
                       tree["params"]["w"])
    assert sorted(os.listdir(tmp_path / "d")) == ["state.ckpt"]


def test_restore_names_the_leaf_at_fault(tmp_path):
    tree = _tree()
    path = str(tmp_path / "state.ckpt")
    ckpt.save(path, tree)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError,
                       match=r"shape mismatch at \['params'\]\['w'\]"):
        ckpt.restore(path, bad)
    bad = _tree()
    bad["params"]["b"] = bad["params"]["b"].float()
    with pytest.raises(ValueError, match=r"dtype mismatch at "
                       r"\['params'\]\['b'\]: checkpoint bfloat16"):
        ckpt.restore(path, bad)
    bad = _tree()
    bad["ids"].append(torch.zeros(1))
    with pytest.raises(ValueError, match="treedef"):
        ckpt.restore(path, bad)
    bad = _tree()
    bad["cache"] = list(bad["cache"])
    with pytest.raises(ValueError, match="treedef"):
        ckpt.restore(path, bad)
    with open(path, "r+b") as fh:
        fh.write(b"X")
    with pytest.raises(ValueError, match="magic"):
        ckpt.peek(path)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "none"), tree)

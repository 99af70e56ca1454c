"""``train_gnn(use_shard_map=True)``: the worker backend end to end on the
CPU, one ``gloo`` process per worker, against the emulated backend.

* Q = 4, p2p ``varco:linear:5`` (``blockmask``), 3 epochs from one call in
  this interpreter (``train_gnn`` spawns the workers and returns rank 0's
  result): losses within 1e-5, accuracies and the ledger's cumulative
  floats equal, and every worker shipped bytes each step;
* the same run booted from a shard directory, each worker loading only
  its own partition's file;
* the refusals: ``backend="nccl"`` on the CPU, a worker group without a
  process group, an argument the workers cannot receive (an optimiser
  closure), ``shard_graph`` on an unstacked leaf; and a worker's
  exception re-raised in the parent.  (Faults, checkpoints and resume on
  the group: ``tests/test_torch_dist_faults.py`` and
  ``tests/test_torch_dist_resume.py``.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.varco import CommPolicy
from repro_torch.core.collectives import WorkerMesh
from repro_torch.dist import gnn_parallel as gp
from repro_torch.graph import stream as st
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.train.optim import sgd
from repro_torch.train.trainer import train_gnn

import torch_dist_cases as cases

Q, EPOCHS, TOL = 4, 3, 1e-5


def _kw():
    return dict(policy=CommPolicy.parse("varco:linear:5", EPOCHS,
                                        compressor="blockmask"),
                epochs=EPOCHS, wire="p2p", device="cpu", hidden=256,
                layers=3, eval_every=1)


def _assert_same_run(dist, emu):
    hd, he = dist.history, emu.history
    np.testing.assert_allclose(hd.loss, he.loss, rtol=0, atol=TOL)
    for k in ("epoch", "rate", "train_acc", "val_acc", "test_acc",
              "halo_gfloats", "transport_gfloats"):
        assert getattr(hd, k) == getattr(he, k), k
    assert len(hd.sent_bytes) == EPOCHS and min(hd.sent_bytes) > 0
    assert hd.staged_bytes == [0] * EPOCHS          # gloo on the CPU
    assert len(hd.comm_s) == EPOCHS and min(hd.comm_s) > 0
    assert not he.sent_bytes
    assert dist.meta == emu.meta


def test_train_gnn_worker_backend_matches_emulated():
    g = tiny_graph(n=cases.N, feat_dim=cases.F)
    with cases.one_thread():
        emu = train_gnn(g, q=Q, **_kw())
    dist = train_gnn(g, q=Q, use_shard_map=True, **_kw())
    _assert_same_run(dist, emu)


def test_train_gnn_worker_backend_from_shards(tmp_path):
    g = tiny_graph(n=cases.N, feat_dim=cases.F)
    store = st.write_graph_store(g, tmp_path / "store")
    st.write_shards(store, st.stream_partition(store, Q, "metis-like"),
                    tmp_path / "shards")
    shards = str(tmp_path / "shards")
    with cases.one_thread():
        emu = train_gnn(shards, **_kw())
    dist = train_gnn(shards, use_shard_map=True, **_kw())
    _assert_same_run(dist, emu)


def test_group_refusals():
    with pytest.raises(ValueError, match="backend='gloo'"):
        gp.make_worker_mesh(2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        gp.spawn_workers(cases.fail_on_rank_1, 2, device="cpu",
                         backend="nccl")
    with pytest.raises(RuntimeError, match="initialised process group"):
        gp.make_worker_mesh(2, device="cpu")
    # spawned workers get their arguments pickled; an optimiser is a
    # closure, refused before any process starts
    with pytest.raises(TypeError, match="pickles fn and its arguments"):
        train_gnn(tiny_graph(n=64, feat_dim=128), q=2, use_shard_map=True,
                  optimizer=sgd(0.1), **{**_kw(), "layers": 2})
    mesh = WorkerMesh(q=2, rank=1, device=torch.device("cpu"),
                      backend="gloo")
    good = {"a": torch.arange(6).reshape(2, 3)}
    assert torch.equal(gp.shard_graph(good, mesh)["a"],
                       torch.tensor([[3, 4, 5]]))
    with pytest.raises(ValueError, match="'b'"):
        gp.shard_graph({**good, "b": torch.zeros(3, 2)}, mesh)


def test_worker_exception_reraised_in_parent():
    with pytest.raises(ValueError, match="worker 1 failed on purpose"):
        gp.spawn_workers(cases.fail_on_rank_1, 2, device="cpu")

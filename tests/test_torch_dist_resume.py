"""Checkpoint and resume on the worker backend: ``train_gnn(
use_shard_map=True, checkpoint_dir=..., stop_after=..., resume=True)``,
one ``gloo`` process per worker on the CPU, against the uninterrupted
group run and across backends.

The world is the fault tests' (``tiny_graph(n=256, F=128)`` as a
``metis-like`` shard set, a 2-layer SAGE at hidden 256, AdamW).  On one
spawned group of 4: ``varco:linear:5`` under drops, spikes and worker 1
crashing at epoch 3, uninterrupted, stopped after epoch 2 (before the
crash) and resumed on the group, and stopped after epoch 4 (after it);
and ``auto:budget:…:w8`` without faults (the error-feedback slabs and the
controller state ride the checkpoint) stopped after epoch 2 and resumed.
Every resumed epoch equals the uninterrupted group run's bitwise —
losses, rates, accuracies, the ladder's counts, the ledger — and so do
the final parameters.  The group of 4 refuses to resume the run that
shrank (its checkpoint holds 3 live workers).  From this process, that
checkpoint resumes over 3 spawned workers (bitwise again) and on the
emulated backend, and the emulated backend's own checkpoint after epoch 4
resumes over 3 spawned workers: both within 1e-5 of the uninterrupted
run.  The group's file and the emulated backend's hold the same tree
structure, shapes and ``extra`` keys.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

from repro.nn import gnn as jgnn
from repro_torch.dist import gnn_parallel as gp
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import train_gnn

import torch_dist_cases as cases

Q, E, TOL = 4, cases.FAULT_EPOCHS, 1e-5
#: name -> (policy spec, faulted, the epochs to stop after)
RUNS = {"faulted": ("varco:linear:5", True, (2, 4)),
        "auto_w8": ("auto:budget:2e7:w8", False, (2,))}
COLS = ("epoch", "loss", "rate", "train_acc", "val_acc", "test_acc",
        "halo_gfloats", "transport_gfloats", "pair_transport_gf",
        "comp_err", "cached_pairs", "dead_pairs", "width")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_resume")
    shard_dir = cases.write_fault_shards(root)
    from repro_torch.graph.stream import shard_meta
    cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                         out_dim=shard_meta(shard_dir)["num_classes"],
                         layers=cases.FAULT_LAYERS)
    params_np = jax.tree_util.tree_map(
        np.asarray, jgnn.init_gnn(jax.random.key(0), cfg))
    return {"dir": shard_dir, "ck": str(root / "ck"),
            "params_np": params_np}


@pytest.fixture(scope="module")
def group(world):
    return gp.spawn_workers(cases.resume_group_cases, Q, world["dir"],
                            world["ck"], world["params_np"], RUNS,
                            device="cpu")


def _kw(world, name):
    spec, faulted, _ = RUNS[name]
    return cases.resume_kwargs(world["params_np"], spec, faulted)


@pytest.fixture(scope="module")
def emulated(world, tmp_path_factory):
    """The emulated faulted run, uninterrupted and stopped after epoch 4
    (its checkpoint under ``ck``)."""
    ck = str(tmp_path_factory.mktemp("emulated_ck"))
    with cases.one_thread():
        whole = train_gnn(world["dir"], **_kw(world, "faulted"))
        stop4 = train_gnn(world["dir"], checkpoint_dir=ck, stop_after=4,
                          **_kw(world, "faulted"))
    return {"whole": whole, "stop4": stop4, "ck": ck}


def _assert_resumed(resumed: dict, whole: dict, k: int, exact: bool):
    hr, hw = resumed["history"], whole["history"]
    assert hr["epoch"] == list(range(k, E))
    for col in COLS:
        if exact or col not in ("loss", "halo_gfloats", "transport_gfloats",
                                "pair_transport_gf", "comp_err"):
            assert hr[col] == hw[col][k:], col
    if not exact:
        np.testing.assert_allclose(hr["loss"], hw["loss"][k:], rtol=0,
                                   atol=TOL)
        for col in ("halo_gfloats", "transport_gfloats", "comp_err"):
            np.testing.assert_allclose(hr[col], hw[col][k:], rtol=1e-6)
    assert resumed["q"] == whole["q"]
    for a, b in zip(resumed["params"], whole["params"], strict=True):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("name,stop", [("faulted", 2), ("auto_w8", 2)])
def test_resume_on_the_group_is_bitwise(group, name, stop):
    for r in range(Q):
        rec = group[r][name]
        assert len(rec[f"stop{stop}"]["history"]["loss"]) == stop
        if rec["whole"] is None:            # the worker that crashed
            assert RUNS[name][1] and r == 1
            assert rec[f"resume{stop}"] is None
            continue
        _assert_resumed(rec[f"resume{stop}"], rec["whole"], stop,
                        exact=True)


def test_group_checkpoint_after_the_crash(group, world):
    """Stopped after epoch 4: the file holds the three live workers, the
    crashed worker returned ``None``, and the group of 4 refuses to
    resume it."""
    extra = ckpt.peek(ckpt.latest_checkpoint(os.path.join(world["ck"],
                                                          "faulted_4")))
    assert extra["step"] == 4 and extra["alive"] == [0, 2, 3]
    assert extra["q"] == Q - 1
    for r in range(Q):
        rec = group[r]["faulted"]
        assert (rec["stop4"] is None) == (r == 1)
        assert (rec["whole"] is None) == (r == 1)
        assert "need 3 workers, the process group has 4" in rec["resume4"]


def test_shrunk_checkpoint_resumes_over_three_spawned_workers(group,
                                                              world):
    whole = group[0]["faulted"]["whole"]
    res = train_gnn(world["dir"], use_shard_map=True,
                    checkpoint_dir=os.path.join(world["ck"], "faulted_4"),
                    resume=True, **_kw(world, "faulted"))
    assert res.meta.q == Q - 1
    _assert_resumed(cases.run_record(res), whole, 4, exact=True)


def test_group_checkpoint_resumes_on_the_emulated_backend(group, world,
                                                          emulated):
    with cases.one_thread():
        res = train_gnn(world["dir"], resume=True,
                        checkpoint_dir=os.path.join(world["ck"],
                                                    "faulted_4"),
                        **_kw(world, "faulted"))
    _assert_resumed(cases.run_record(res), cases.run_record(emulated["whole"]), 4,
                    exact=False)
    _assert_resumed(cases.run_record(res), group[0]["faulted"]["whole"], 4,
                    exact=False)


def test_emulated_checkpoint_resumes_on_the_group(group, world, emulated):
    res = train_gnn(world["dir"], use_shard_map=True, resume=True,
                    checkpoint_dir=emulated["ck"], **_kw(world, "faulted"))
    _assert_resumed(cases.run_record(res), cases.run_record(emulated["whole"]), 4,
                    exact=False)
    _assert_resumed(cases.run_record(res), group[0]["faulted"]["whole"], 4,
                    exact=False)


def test_both_backends_write_the_same_file_layout(group, world, emulated):
    def header(d):
        with open(ckpt.latest_checkpoint(d), "rb") as f:
            return ckpt._read_header(f)

    g = header(os.path.join(world["ck"], "faulted_4"))
    e = header(emulated["ck"])
    assert g["treedef"] == e["treedef"]
    assert [(x["path"], x["dtype"], x["shape"]) for x in g["leaves"]] == \
        [(x["path"], x["dtype"], x["shape"]) for x in e["leaves"]]
    assert sorted(g["extra"]) == sorted(e["extra"])
    assert g["extra"]["alive"] == e["extra"]["alive"] == [0, 2, 3]
    assert "['fcache']" in " ".join(x["path"] for x in g["leaves"])


def test_uninterrupted_group_run_matches_emulated(group, emulated):
    _assert_resumed(group[0]["faulted"]["whole"],
                    cases.run_record(emulated["whole"]), 0, exact=False)

"""The fault channel and elastic shrink on the worker backend: the fault
step ``make_fault_train_step(..., mesh=...)`` and ``train_gnn(
use_shard_map=True, faults=...)``, one ``gloo`` process per worker on the
CPU (Q = 4), against the port's emulated backend and the JAX package's
``shard_map`` fault step.

The world is ``tiny_graph(n=256, F=128)`` written as a ``metis-like``
shard set and a 2-layer SAGE at hidden 256, from the JAX package's
initialisation.  Two fault steps per case (SGD with momentum): step 0
under seeded masks with CACHED and DEAD pairs from a seeded random fault
cache (each worker its receiver-major row), step 1 under other masks from
step 0's cache; ``full``, ``fixed:4``, ``varco:linear:5``,
``auto:budget:…:w8`` (against the emulated step called with ``cache=()``:
the worker runs no error feedback, as in the JAX package) and ``varco``
under ``sync="fedavg"`` (the emulated step at ``lr / Q``).  Held against
the emulated backend: losses and parameters within 1e-5, the ledger and
pair matrices at rel 1e-6 (``pair_err`` 1e-5), and step 0's served cache
bitwise (the workers' blocks gathered and turned sender-major).  Three
cases against the JAX package's ``make_fault_train_step(mesh=...)`` on 4
virtual CPU devices (one subprocess, started before the group): losses
within 1e-5, the first exchange's served cache bitwise and the others
within 1e-5 (the second layer's input differs from the JAX package's in
the last bits), pair matrices at rel 2e-5.  On each worker a CACHED pair
is served bitwise and charged nothing, and every pair DEAD equals the
No-Comm forward.  ``train_gnn`` under drops and spikes with worker 1
crashing at epoch 3 (staleness cap 1: pairs go DEAD) and, spawned from
this process, worker 0 crashing under ``auto:budget`` (cap 2): every
epoch's loss within 1e-5 of the emulated run's, the ladder's counts
equal, Q = 3 after the crash, ``None`` from the crashed worker and the
same result from every survivor, and the spawner's result that of the
new rank 0; and ``fixed:4`` with two crashes, Q 4 -> 3 -> 2 (the first
crashed process takes part in the second subgroup's creation).
``auto:stale`` and the dense wire stay refused.

The group is spawned once, in a module-scoped fixture, and runs every
step case, the identities and the group's runs; the emulated references
run on one thread (``one_thread``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.nn import gnn as jgnn
from repro_torch.core.collectives import WorkerMesh
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as gp
from repro_torch.dist.faults import (_cache_recv_to_send,
                                     make_fault_train_step)
from repro_torch.train import optim
from repro_torch.train.trainer import train_gnn

import torch_dist_cases as cases

ROOT = Path(__file__).resolve().parents[1]
Q, TOL, REL = 4, 1e-5, 1e-6
#: name -> (policy spec, sync) of the fault-step cases
STEPS = {"full": ("full", "grad"),
         "fixed4": ("fixed:4", "grad"),
         "varco": ("varco:linear:5", "grad"),
         "auto_w8": ("auto:budget:1e9:w8", "grad"),
         "varco_fedavg": ("varco:linear:5", "fedavg")}
JAX_STEPS = ("full", "varco", "auto_w8")
#: name -> (policy spec, (crash epoch, worker) events, staleness cap)
GROUP_RUN = {"crash1": ("varco:linear:5", ((3, 1),), 1),
             "crash1_then0": ("fixed:4", ((2, 1), (4, 0)), 2)}
SPAWNED_RUN = ("auto:budget:2e7", ((3, 0),), 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    shard_dir = cases.write_fault_shards(tmp_path_factory.mktemp("faults"))
    from repro_torch.graph.stream import shard_meta
    cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                         out_dim=shard_meta(shard_dir)["num_classes"],
                         layers=cases.FAULT_LAYERS)
    params_np = jax.tree_util.tree_map(
        np.asarray, jgnn.init_gnn(jax.random.key(0), cfg))
    return {"dir": shard_dir, "params_np": params_np}


@pytest.fixture(scope="module")
def jax_proc(world, tmp_path_factory):
    """The JAX package's shard_map fault steps, started in a subprocess
    before the worker group so the two overlap."""
    path = tmp_path_factory.mktemp("jax_faults") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    spec = {n: STEPS[n] for n in JAX_STEPS}
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(spec),
                             world["dir"], str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def dist_out(world, jax_proc):
    return gp.spawn_workers(cases.fault_group_cases, Q, world["dir"],
                            world["params_np"], STEPS, GROUP_RUN,
                            device="cpu")


@pytest.fixture(scope="module")
def emulated(world):
    pg, host, cfg, params = cases.fault_setup(world["dir"],
                                              world["params_np"])
    with cases.one_thread():
        steps = {name: cases.run_fault_case(pg, host, cfg, params, *case)
                 for name, case in STEPS.items()}
        runs = {name: train_gnn(world["dir"], **cases.fault_train_kwargs(
                    world["params_np"], *case))
                for name, case in {**GROUP_RUN,
                                   "spawned": SPAWNED_RUN}.items()}
    return {"steps": steps, "runs": runs}


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, path = jax_proc
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{out}\n{err}"
    assert "JAX_FAULTS_OK" in out
    with np.load(path) as z:
        return dict(z)


def _rel(got, want, rtol=REL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _gathered_cache(dist_out, name: str, t: int) -> list:
    """Step ``t``'s served cache of every worker, stacked receiver-major
    and turned sender-major: the emulated layout."""
    per = [dist_out[r]["steps"][name]["fcache"][t] for r in range(Q)]
    return [_cache_recv_to_send(torch.from_numpy(np.concatenate(
        [p[c] for p in per])), Q).numpy() for c in range(len(per[0]))]


@pytest.mark.parametrize("name", list(STEPS))
def test_fault_step_matches_emulated(dist_out, emulated, name):
    want = emulated["steps"][name]
    for r in range(Q):
        got = dist_out[r]["steps"][name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL)
        for k in ("rate", "halo_bits", "transport_bits", "pair_transport"):
            _rel(got[k], want[k])
        _rel(got["pair_err"], want["pair_err"], rtol=1e-5)
        for a, b in zip(got["params"], want["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(_gathered_cache(dist_out, name, 0), want["fcache"][0],
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_gathered_cache(dist_out, name, 1), want["fcache"][1],
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # the masks' CACHED and DEAD pairs charged nothing, the rest did
    for (fskip, dead), pair in zip(cases.fault_masks(Q),
                                   want["pair_transport"]):
        off = (fskip + dead) > 0
        assert off.any() and (pair[off] == 0).all()
        assert (pair[~off & ~np.eye(Q, dtype=bool)] > 0).all()


@pytest.mark.parametrize("name", JAX_STEPS)
def test_fault_step_matches_jax_shard_map(dist_out, jax_out, name):
    for r in range(Q):
        got = dist_out[r]["steps"][name]
        np.testing.assert_allclose(got["loss"], jax_out[name + "_loss"],
                                   rtol=0, atol=TOL)
        for k in ("pair_transport", "pair_err"):
            _rel(np.stack(got[k]), jax_out[f"{name}_{k}"], rtol=2e-5)
    for t in range(2):
        for c, a in enumerate(_gathered_cache(dist_out, name, t)):
            want = jax_out[f"{name}_fcache_{t}_{c}"]
            if t == 0 and c == 0:
                np.testing.assert_array_equal(a, want)
            else:
                np.testing.assert_allclose(a, want, rtol=0, atol=TOL)


def test_cached_pair_and_all_dead_on_the_group(dist_out):
    for r in range(Q):
        ident = dist_out[r]["ident"]
        assert ident["cached_logits_equal"] and ident["served_equal"], r
        assert ident["fresh_pair_bits"] > 0, r
        assert ident["cached_pair_bits"] == 0.0, r
        assert ident["transport_drop"] == ident["fresh_pair_bits"], r
        assert ident["dead_vs_none"] <= TOL, r
        assert ident["dead_bits"] == (0.0, 0.0), r


def _assert_same_faulted_run(got: dict, want):
    h = got["history"]
    np.testing.assert_allclose(h["loss"], want.history.loss, rtol=0,
                               atol=TOL)
    for k in ("epoch", "cached_pairs", "dead_pairs", "rate"):
        assert h[k] == getattr(want.history, k), k
    for k in ("halo_gfloats", "transport_gfloats"):
        _rel(h[k], getattr(want.history, k))
    assert [len(p) for p in h["pair_transport_gf"]] == \
        [Q * Q] * 3 + [(Q - 1) ** 2] * (cases.FAULT_EPOCHS - 3)
    for a, b in zip(h["pair_transport_gf"], want.history.pair_transport_gf,
                    strict=True):
        _rel(a, b)
    assert got["q"] == want.meta.q == Q - 1
    assert len(h["sent_bytes"]) == cases.FAULT_EPOCHS
    assert min(h["sent_bytes"]) > 0
    for a, b in zip(got["params"],
                    optim.tree_leaves(want.params), strict=True):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=TOL)
    assert max(h["cached_pairs"]) > 0


def test_train_gnn_crash_shrinks_the_group(dist_out, emulated):
    """Worker 1 crashes at epoch 3: it returns ``None``, the three
    survivors the same result, the emulated run's."""
    recs = [dist_out[r]["runs"]["crash1"] for r in range(Q)]
    assert recs[1] is None
    for r in (0, 2, 3):
        _assert_same_faulted_run(recs[r], emulated["runs"]["crash1"])
        assert recs[r]["history"]["loss"] == recs[0]["history"]["loss"]
    assert sum(recs[0]["history"]["dead_pairs"]) > 0


def test_train_gnn_two_crashes_shrink_the_group_twice(dist_out, emulated):
    """Worker 1 crashes at epoch 2 and worker 0 (of the three left) at
    epoch 4: the first crashed process still takes part in the second
    subgroup's creation; the two survivors match the emulated run."""
    recs = [dist_out[r]["runs"]["crash1_then0"] for r in range(Q)]
    want = emulated["runs"]["crash1_then0"]
    assert recs[0] is None and recs[1] is None
    assert want.meta.q == 2
    for r in (2, 3):
        h = recs[r]["history"]
        assert recs[r]["q"] == 2
        np.testing.assert_allclose(h["loss"], want.history.loss, rtol=0,
                                   atol=TOL)
        for k in ("cached_pairs", "dead_pairs", "rate"):
            assert h[k] == getattr(want.history, k), k
        assert [len(p) for p in h["pair_transport_gf"]] == \
            [Q * Q] * 2 + [(Q - 1) ** 2] * 2 + [(Q - 2) ** 2] * 2


def test_crashed_worker_outwaits_the_job_timeout(dist_out):
    """Worker 1 crashes at epoch 1 and the survivors' later epochs take
    longer than the job's per-operation timeout: the crashed process waits
    for them without a timed operation, and every shrink's subgroup is
    destroyed by the end of the runs."""
    recs = [dist_out[r]["slow"] for r in range(Q)]
    assert recs[1] is None
    after = recs[0]["history"]
    assert after["wall_s"][-1] - after["wall_s"][1] > cases.SLOW_TIMEOUT_S
    for r in (0, 2, 3):
        assert recs[r]["q"] == Q - 1
        assert recs[r]["history"]["loss"] == after["loss"]
    assert [dist_out[r]["groups_left"] for r in range(Q)] == [1] * Q


def test_train_gnn_crash_of_worker_0_returns_the_new_rank_0(world,
                                                            emulated):
    """Spawned from this process: worker 0 crashes, and the spawner
    returns the result of the new rank 0 (worker 1 before the crash)."""
    res = train_gnn(world["dir"], use_shard_map=True,
                    **cases.fault_train_kwargs(world["params_np"],
                                               *SPAWNED_RUN))
    assert res is not None and res.meta.q == Q - 1
    _assert_same_faulted_run(cases.run_record(res),
                             emulated["runs"]["spawned"])
    assert min(res.history.staged_bytes) == 0 == max(
        res.history.staged_bytes)


def test_fault_refusals_on_the_group(world):
    kw = cases.fault_train_kwargs(world["params_np"], "auto:stale:1e9",
                                  (3, 1), 2)
    with pytest.raises(ValueError, match="hop reuse is emulated-backend"):
        train_gnn(world["dir"], use_shard_map=True, **kw)
    pg, host, cfg, params = cases.fault_setup(world["dir"],
                                              world["params_np"])
    mesh = WorkerMesh(q=Q, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    with pytest.raises(ValueError, match="hop reuse is emulated-backend"):
        make_fault_train_step(cfg, CommPolicy.parse("auto:stale:1e9", 2),
                              optim.sgd(0.1), meta, mesh=mesh)
    dense = dataclasses.replace(meta, wire="dense")
    with pytest.raises(ValueError, match="needs wire='p2p'"):
        make_fault_train_step(cfg, CommPolicy.parse("full", 2),
                              optim.sgd(0.1), dense, mesh=mesh)
    z = np.zeros((Q, Q), np.float32)
    for m in (dense, meta):              # the dense wire; no rate map
        with pytest.raises(ValueError, match="fault channel rides"):
            gp._make_aggregate_shard(gp.shard_graph(host, mesh), m,
                                     CommPolicy.parse("full", 1),
                                     torch.ones(()), None, mesh, dead=z)


SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.varco import CommPolicy
from repro.dist import faults as jf
from repro.dist import gnn_parallel as jgp
from repro.dist import ratectl as jrc
from repro.graph.stream import load_shards
from repro.nn import gnn as jgnn
from repro.train import optim
import torch_dist_cases as cases

spec, shard_dir, out_path = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
q = 4
sh = load_shards(shard_dir)
mesh = jgp.make_worker_mesh(q)
graph = jgp.shard_graph(sh.device_arrays(), mesh)
cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                     out_dim=sh.num_classes, layers=cases.FAULT_LAYERS)
params0 = jgnn.init_gnn(jax.random.key(0), cfg)
meta = jgp.DistMeta.build(sh, params0, wire="p2p")
out = {}
for name, (pspec, sync) in spec.items():
    pol = CommPolicy.parse(pspec, cases.FAULT_EPOCHS, compressor="blockmask")
    opt = optim.sgd(cases.LR, momentum=0.9)
    step = jf.make_fault_train_step(cfg, pol, opt, meta, mesh=mesh,
                                    sync=sync)
    tp = cases.fault_plan(pspec, q)
    plan = jrc.RatePlan(jnp.asarray(np.asarray(tp.rates)),
                        jnp.asarray(np.asarray(tp.skip)),
                        None if tp.widths is None
                        else jnp.asarray(np.asarray(tp.widths)))
    fcache = tuple(jnp.asarray(c.numpy())
                   for c in cases.random_fcache(meta, cfg))
    params, state = params0, opt.init(params0)
    rec = {k: [] for k in ("loss", "pair_transport", "pair_err")}
    for t, (fskip, dead) in enumerate(cases.fault_masks(q)):
        params, state, m, _, fcache = step(params, state, graph,
                                           jax.random.key(t), plan, fskip,
                                           dead, (), fcache)
        for k in rec:
            rec[k].append(np.asarray(m[k]))
        for c, buf in enumerate(fcache):
            out[f"{name}_fcache_{t}_{c}"] = np.asarray(buf)
    for k, v in rec.items():
        out[f"{name}_{k}"] = np.stack(v)
np.savez(out_path, **out)
print("JAX_FAULTS_OK")
"""

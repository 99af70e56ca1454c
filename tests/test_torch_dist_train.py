"""The worker backend's train and eval steps (``make_train_step(...,
mesh=...)``, one ``gloo`` process per worker on the CPU, Q = 4) against
the port's emulated backend and the JAX package's ``shard_map`` steps.

Three steps per case from the JAX package's initialisation (SGD with
momentum, as ``tests/test_torch_train.py``): p2p ``full`` / ``fixed:4`` /
``varco`` (``blockmask``), dense ``full`` / ``varco`` (the paper's
``randmask``), packed ``fixed:2`` / ``varco``, and p2p ``varco`` under
``sync="fedavg"``.  Held against the emulated backend: losses and
parameters within 1e-5 (the JAX package's own bound for its two
backends, ``tests/test_multidevice.py``: per-worker sums all-reduced in
another order), ``halo_bits`` / ``transport_bits`` at rel 1e-6, the
evaluation accuracies after the last step exactly, and each worker's halo
of the first exchange bitwise (the emulated halo, or the worker's row of
the emulated compact hop buffers).  FedAvg averages local SGD steps of
gradients normalised by the global train count, so it is the emulated
step at ``lr / Q`` (as in the JAX package's test).  p2p ``varco``, dense
``varco`` and packed ``fixed:2`` are also held to the JAX package's
``make_train_step(mesh=...)`` on 4 virtual CPU devices (one subprocess)
within 1e-5.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.nn import gnn as jgnn
from repro_torch import prng
from repro_torch.dist import gnn_parallel as gp
from repro_torch.train import optim

import torch_dist_cases as cases

ROOT = Path(__file__).resolve().parents[1]
Q, TOL = 4, 1e-5
CASES = {
    "p2p_full": ("p2p", "full", "blockmask", "grad"),
    "p2p_fixed4": ("p2p", "fixed:4", "blockmask", "grad"),
    "p2p_varco": ("p2p", "varco:linear:5", "blockmask", "grad"),
    "dense_full": ("dense", "full", "randmask", "grad"),
    "dense_varco": ("dense", "varco:linear:5", "randmask", "grad"),
    "packed_fixed2": ("packed", "fixed:2", "blockmask", "grad"),
    "packed_varco": ("packed", "varco:linear:5", "blockmask", "grad"),
    "p2p_varco_fedavg": ("p2p", "varco:linear:5", "blockmask", "fedavg"),
}
JAX_CASES = ("p2p_varco", "dense_varco", "packed_fixed2")


def _init_np():
    cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                         out_dim=_classes(), layers=cases.LAYERS)
    return jax.tree_util.tree_map(
        np.asarray, jgnn.init_gnn(jax.random.key(0), cfg))


def _classes():
    from repro_torch.graph.synthetic import tiny_graph
    return tiny_graph(n=cases.N, feat_dim=cases.F).num_classes


@pytest.fixture(scope="module")
def params_np():
    return _init_np()


@pytest.fixture(scope="module")
def dist_out(params_np):
    return gp.spawn_workers(cases.train_cases, Q, CASES, params_np,
                            device="cpu")


@pytest.fixture(scope="module")
def emulated(params_np):
    pg, graph, cfg, params = cases.train_setup(Q, params_np)
    out = {}
    for name, (wire, spec, comp, sync) in CASES.items():
        meta = gp.DistMeta.build(pg, params, wire=wire)
        pol = cases.case_policy(spec, comp)
        # fedavg's mean of local steps is the emulated step at lr / Q
        lr = cases.LR / Q if sync == "fedavg" else cases.LR
        opt = optim.sgd(lr, momentum=0.9)
        with cases.one_thread():
            rec = cases.run_case(gp.make_train_step(cfg, pol, opt, meta),
                                 gp.make_eval_step(cfg, meta), params, opt,
                                 graph)
            rec["halo"] = gp.first_halo(graph, meta, pol,
                                        prng.key(cases.HALO_KEY),
                                        graph["features"])
        out[name] = rec
    return out


def _rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_worker_steps_match_emulated(dist_out, emulated, name):
    got, want = dist_out[name], emulated[name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=TOL)
    assert got["rate"] == want["rate"]
    for k in ("halo_bits", "transport_bits"):
        _rel(got[k], want[k])
    assert len(got["params"]) == len(want["params"])
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert got["step_count"] == want["step_count"] == cases.STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_worker_eval_matches_emulated(dist_out, emulated, name):
    assert dist_out[name]["acc"] == emulated[name]["acc"]


@pytest.mark.parametrize("name", list(CASES))
def test_worker_halo_is_the_emulated_halo_bitwise(dist_out, emulated, name):
    wire = CASES[name][0]
    want = emulated[name]["halo"]
    for r, halo in enumerate(dist_out[name]["halo"]):
        ref = want[r] if wire == "p2p" else want
        np.testing.assert_array_equal(halo, ref.numpy())


SCRIPT = r"""
import json, sys
import numpy as np
import jax
from repro.core.varco import CommPolicy
from repro.dist import gnn_parallel as jgp
from repro.dist.halo import attach_p2p
from repro.graph.partition import partition_graph
from repro.graph.synthetic import tiny_graph
from repro.nn import gnn as jgnn
from repro.train import optim
import torch_dist_cases as cases

spec = json.loads(sys.argv[1])
g = tiny_graph(n=cases.N, feat_dim=cases.F)
pg = partition_graph(g, 4, seed=0)
mesh = jgp.make_worker_mesh(4)
graph = jgp.shard_graph(attach_p2p(pg.device_arrays(), pg), mesh)
cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                     out_dim=g.num_classes, layers=cases.LAYERS)
params0 = jgnn.init_gnn(jax.random.key(0), cfg)
out = {}
for name, (wire, pol_spec, comp) in spec.items():
    meta = jgp.DistMeta.build(pg, params0, wire=wire)
    opt = optim.sgd(cases.LR, momentum=0.9)
    step = jgp.make_train_step(cfg, CommPolicy.parse(pol_spec, 40,
                                                     compressor=comp),
                               opt, meta, mesh=mesh)
    params, state = params0, opt.init(params0)
    losses, bits = [], []
    for t in range(cases.STEPS):
        params, state, m = step(params, state, graph, t, jax.random.key(t))
        losses.append(float(m["loss"]))
        bits.append(float(m["transport_bits"]))
    out[name + "_loss"] = np.asarray(losses)
    out[name + "_bits"] = np.asarray(bits)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        out[f"{name}_p{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("JAX_TRAIN_OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("jax_train") / "out.npz"
    spec = {n: CASES[n][:3] for n in JAX_CASES}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "JAX_TRAIN_OK" in run.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("name", JAX_CASES)
def test_worker_steps_match_jax_shard_map(dist_out, jax_out, name):
    got = dist_out[name]
    np.testing.assert_allclose(got["loss"], jax_out[name + "_loss"], rtol=0,
                               atol=TOL)
    _rel(got["transport_bits"], jax_out[name + "_bits"])
    for i, leaf in enumerate(got["params"]):
        np.testing.assert_allclose(leaf, jax_out[f"{name}_p{i}"], rtol=0,
                                   atol=TOL)

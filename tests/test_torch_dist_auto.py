"""The closed loop on the worker backend: ``make_auto_train_step(...,
mesh=...)`` and ``train_gnn(use_shard_map=True)`` under auto policies,
one ``gloo`` process per worker on the CPU (Q = 4), against the port's
emulated backend and the JAX package's ``shard_map`` step.

Three steps per case from the JAX package's initialisation (SGD with
momentum), the controller planning each step from the step's metrics on
every worker, or a fixed seeded plan: p2p ``auto:budget`` fp32, p2p
``auto:budget:w8`` rounded half to even and stochastically (sub-byte hops
with error-feedback residuals), p2p ``auto:error:w8``, packed
``auto:budget:w4`` (the sub-byte all-gather), a mixed-width plan (an fp32
pair beside quantised ones: the straight-through value path, stochastic),
a per-layer ``[L, Q, Q]`` plan and ``sync="fedavg"`` (the emulated step at
``lr / Q``).  Held against the emulated backend: losses and parameters
within 1e-5, the ledger and pair matrices and the controller state at
rel 1e-6, every worker's plan equal to the emulated plan (so to each
other's), and layer 0's halo under the first plan and every worker's
residual slabs after the first step bitwise (the emulated ``[Q, D, H, F]``
state's row; after the last, at most 1e-4 of the entries off by more than
1e-5, as ``tests/test_torch_auto_wires.py`` holds deeper residuals: a
value on a rounding boundary may land one level apart).  The buffers
each worker handed the transport (``wire_out``) carry ``ceil(ledger bits
/ 8)`` bytes per pair exactly, as ``tests/test_torch_auto_wires.py``
holds the emulated wire.  Three cases
are also held to the JAX package's ``make_auto_train_step(mesh=...)`` on
4 virtual CPU devices (one subprocess): losses within 1e-5, pair matrices
at rel 2e-5 (above the reference's own drift between its two backends,
ROADMAP.md queue 3), the first exchange's halos bitwise.
``train_gnn(use_shard_map=True)`` under ``auto:budget:<half>:w8`` runs on
the same group against the emulated run over 3 epochs; ``auto:stale``
with ``use_shard_map`` raises the JAX package's ``ValueError``.

The group is spawned once, in a module-scoped fixture, and runs every
case; the emulated references run on one thread (``one_thread``).
"""

from __future__ import annotations

import json
import math
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
from repro_torch.dist.ratectl import make_auto_train_step
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.train import optim
from repro_torch.train.trainer import train_gnn

import torch_dist_cases as cases

ROOT = Path(__file__).resolve().parents[1]
Q, TOL, REL = 4, 1e-5, 1e-6
#: name -> run_auto_case's case
CASES = {name: dict(zip(("wire", "spec", "sync", "rounding", "plan"), c))
         for name, c in {
    "p2p_budget_fp32": ("p2p", "auto:budget:{half:g}", "grad", "rint",
                        "ctl"),
    "p2p_budget_w8_rint": ("p2p", "auto:budget:{half:g}:w8", "grad", "rint",
                           "ctl"),
    "p2p_budget_w8_stochastic": ("p2p", "auto:budget:{half:g}:w8", "grad",
                                 "stochastic", "ctl"),
    "p2p_error_w8": ("p2p", "auto:error:{half:g}:w8", "grad", "rint",
                     "ctl"),
    "packed_budget_w4": ("packed", "auto:budget:{half:g}:w4", "grad",
                         "rint", "ctl"),
    "p2p_mixed": ("p2p", "auto:budget:{half:g}:w8", "grad", "stochastic",
                  "mixed"),
    "p2p_per_layer": ("p2p", "auto:budget:{half:g}:w8", "grad", "rint",
                      "w8_per_layer"),
    "p2p_fedavg": ("p2p", "auto:budget:{half:g}:w8", "fedavg", "rint",
                   "ctl"),
}.items()}
JAX_CASES = ("p2p_budget_w8_rint", "packed_budget_w4", "p2p_mixed")
#: (wire, width) of the byte-conservation captures
CAPTURES = (("p2p", 2), ("p2p", 4), ("p2p", 8), ("p2p", 32), ("packed", 4),
            ("packed", 8))
EF_CASES = [n for n, c in CASES.items()
            if c["wire"] == "p2p" and ":w" in c["spec"]]


@pytest.fixture(scope="module")
def params_np():
    from repro_torch.graph.synthetic import tiny_graph as t_tiny
    cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                         out_dim=t_tiny(n=cases.N, feat_dim=cases.F)
                         .num_classes, layers=cases.LAYERS)
    return jax.tree_util.tree_map(
        np.asarray, jgnn.init_gnn(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def dist_out(params_np):
    return gp.spawn_workers(cases.auto_cases, Q, CASES, CAPTURES, params_np,
                            device="cpu")


@pytest.fixture(scope="module")
def emulated(params_np):
    pg, graph, cfg, params = cases.train_setup(Q, params_np)
    with cases.one_thread():
        runs = {name: cases.run_auto_case(pg, graph, cfg, params, case)
                for name, case in CASES.items()}
        capture = {c: cases.capture_wire(pg, graph, cfg, params, *c)
                   for c in CAPTURES}
        res = train_gnn(tiny_graph(n=cases.N, feat_dim=cases.F), q=Q,
                        **cases.auto_train_kwargs(pg))
    return {"runs": runs, "capture": capture, "train_gnn": res.history}


def _rel(got, want, rtol=REL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_auto_steps_match_emulated(dist_out, emulated, name):
    want = emulated["runs"][name]
    for r in range(Q):
        got = dist_out[r]["runs"][name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=TOL)
        for k in ("rate", "halo_bits", "transport_bits", "pair_transport",
                  "pair_err"):
            _rel(got[k], want[k])
        assert len(got["ctl_state"]) == len(want["ctl_state"])
        for a, b in zip(got["ctl_state"], want["ctl_state"]):
            _rel(a, b)
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # the case runs what it names: compression, and quantisation where a
    # width is asked
    assert any((r > 1.0).any() for r in want["rates"]), want["rates"]
    quantises = [w is not None and (w < 32).any() for w in want["widths"]]
    assert any(quantises) == (":w" in CASES[name]["spec"]), name


@pytest.mark.parametrize("name", list(CASES))
def test_every_worker_plans_the_emulated_plan(dist_out, emulated, name):
    want = emulated["runs"][name]
    for r in range(Q):
        got = dist_out[r]["runs"][name]
        for k in ("rates", "widths"):
            for a, b in zip(got[k], want[k]):
                assert (a is None) == (b is None), (name, r, k)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_first_halo_and_residuals_bitwise(dist_out, emulated, name):
    want = emulated["runs"][name]
    for r in range(Q):
        got = dist_out[r]["runs"][name]
        ref = want["halo"][r] if CASES[name]["wire"] == "p2p" \
            else want["halo"]
        np.testing.assert_array_equal(got["halo"], ref)
        assert len(got["resid_first"]) == len(want["resid_first"])
        for a, b in zip(got["resid_first"], want["resid_first"]):
            assert a.shape == (1, *b.shape[1:])
            np.testing.assert_array_equal(a[0], b[r])
        for a, b in zip(got["resid_last"], want["resid_last"]):
            # parameters 1e-8 apart: a value on a rounding boundary may
            # land one level apart (the rule of test_torch_auto_wires)
            off = np.abs(a[0] - b[r]) > TOL
            assert off.mean() <= 1e-4, (name, r, int(off.sum()))
    assert bool(want["resid_first"]) == (name in EF_CASES)
    if name in EF_CASES:
        assert max(np.abs(c).max() for c in want["resid_first"]) > 0


@pytest.mark.parametrize("wire,width", CAPTURES)
def test_wire_out_conserves_bytes(dist_out, emulated, wire, width):
    """Each worker's shipped buffers: the same bytes a row as the emulated
    wire's; on the p2p wire the genuine rows of every (receiver, sender)
    pair, summed over the workers, carry ``ceil(ledger bits / 8)``."""
    want = emulated["capture"][wire, width]
    meas = np.zeros((Q, Q))
    for r in range(Q):
        got = dist_out[r]["capture"][wire, width]
        assert got["n_exchanges"] == want["n_exchanges"] == cases.LAYERS
        assert got["per_row"] == want["per_row"]
        np.testing.assert_array_equal(got["pair_t"], want["pair_t"])
        meas += got["meas"]
    for e, f in enumerate((cases.F, cases.HIDDEN, cases.HIDDEN)):
        k = max(f // 128 // 2, 1)
        blk = 128 * 32 if width >= 32 else 128 * width + 32
        assert want["per_row"][e] == math.ceil(k * blk / 8), (e, width)
    if wire == "p2p":
        np.testing.assert_array_equal(meas, want["meas"])
        np.testing.assert_array_equal(meas, np.ceil(want["pair_t"] / 8.0))


def test_train_gnn_auto_on_the_worker_group(dist_out, emulated):
    he = emulated["train_gnn"]
    for r in range(Q):
        hd = dist_out[r]["train_gnn"]
        np.testing.assert_allclose(hd["loss"], he.loss, rtol=0, atol=TOL)
        for k in ("epoch", "rate", "width", "train_acc", "val_acc",
                  "test_acc"):
            assert hd[k] == getattr(he, k), (r, k)
        for k in ("halo_gfloats", "transport_gfloats", "comp_err"):
            _rel(hd[k], getattr(he, k))
        for a, b in zip(hd["pair_transport_gf"], he.pair_transport_gf):
            _rel(a, b)
        assert len(hd["sent_bytes"]) == cases.AUTO_STEPS
        assert min(hd["sent_bytes"]) > 0 and not he.sent_bytes
    assert min(he.width) < 32.0 and max(he.rate) > 1.0


def test_stale_refused_on_the_worker_group(params_np):
    with pytest.raises(ValueError, match="hop reuse is emulated-backend"):
        train_gnn(tiny_graph(n=64, feat_dim=128), q=Q, use_shard_map=True,
                  policy=CommPolicy.parse("auto:stale:1e9", 2), epochs=2,
                  wire="p2p", device="cpu")
    pg, _, cfg, params = cases.train_setup(Q, params_np)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    mesh = WorkerMesh(q=Q, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    with pytest.raises(ValueError, match="hop reuse is emulated-backend"):
        make_auto_train_step(cfg, CommPolicy.parse("auto:stale:1e9", 2),
                             optim.sgd(0.1), meta, mesh=mesh)


SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core import collectives as JC
from repro.core.varco import CommPolicy
from repro.dist import gnn_parallel as jgp
from repro.dist.halo import attach_p2p
from repro.dist.ratectl import (RatePlan, init_wire_residuals,
                                make_auto_train_step, make_controller)
from repro.graph.partition import partition_graph
from repro.graph.synthetic import tiny_graph
from repro.nn import gnn as jgnn
from repro.train import optim
import torch_dist_cases as cases

spec = json.loads(sys.argv[1])
q = 4
g = tiny_graph(n=cases.N, feat_dim=cases.F)
pg = partition_graph(g, q, seed=0)
mesh = jgp.make_worker_mesh(q)
host = attach_p2p(pg.device_arrays(), pg)
graph = jgp.shard_graph(host, mesh)
cfg = jgnn.GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                     out_dim=g.num_classes, layers=cases.LAYERS)
params0 = jgnn.init_gnn(jax.random.key(0), cfg)
half = cases.half_budget(pg)


def first_halo(meta, pol, plan, rounding):
    rm = np.asarray(plan.rates, np.float32)
    kb = dict(jgp._packed_pair_k_for(meta, rm))
    wm = None
    if plan.widths is not None:
        wm = np.vectorize(jgp._snap_width)(
            np.asarray(plan.widths, np.float32)).astype(np.float32)
        wm = wm if jgp._packed_pair_w_for(meta, wm) else None
    sw = jgp._packed_store_w(meta, wm)

    def worker(gblk, rmap, wmap, k):
        agg = jgp._make_aggregate_shard(
            gblk, meta, pol, None, jnp.ones(()), k, packed_k=kb,
            rate_map=rmap, width_map=None if wm is None else wmap,
            store_w=sw, rounding=rounding)
        token, _ = agg.start(0, gblk["features"])
        if meta.wire != "p2p":
            return token[None]
        hops, k_call, n_keep, _ = token
        return JC.neighbor_exchange_finish(
            hops, jgp.AXIS, key=k_call, n_keep=n_keep,
            f=gblk["features"].shape[-1])[None]

    sm = jax.jit(shard_map(worker, mesh=mesh,
                           in_specs=(P(jgp.AXIS), P(), P(), P()),
                           out_specs=P(jgp.AXIS), check_rep=False))
    return np.asarray(sm(graph, jnp.asarray(rm),
                         jnp.zeros(()) if wm is None else jnp.asarray(wm),
                         jax.random.key(cases.HALO_KEY)))


out = {}
for name, case in spec.items():
    meta = jgp.DistMeta.build(pg, params0, wire=case["wire"])
    pol = CommPolicy.parse(case["spec"].format(half=half), cases.AUTO_STEPS)
    opt = optim.sgd(cases.LR, momentum=0.9)
    step = make_auto_train_step(cfg, pol, opt, meta, mesh=mesh,
                                sync=case["sync"],
                                rounding=case["rounding"])
    ctl = make_controller(pol, meta, cfg, cases.AUTO_STEPS)
    cstate = ctl.init()
    cache = init_wire_residuals(meta, cfg) \
        if pol.max_width < 32 and meta.wire == "p2p" else ()
    params, state = params0, opt.init(params0)
    rec = {k: [] for k in ("loss", "pair_transport", "pair_err")}
    for t in range(cases.AUTO_STEPS):
        if case["plan"] == "ctl":
            plan, cstate = ctl.plan(cstate, t)
        else:
            fp = cases.fixed_plan(case["plan"], q)
            plan = RatePlan(jnp.asarray(fp.rates), jnp.asarray(fp.skip),
                            jnp.asarray(fp.widths))
        if t == 0:
            out[name + "_halo"] = first_halo(meta, pol, plan,
                                             case["rounding"])
        params, state, m, cache = step(params, state, graph,
                                       jax.random.key(t), plan, cache)
        cstate = ctl.observe(cstate, m)
        for k in rec:
            rec[k].append(np.asarray(m[k]))
    for k, v in rec.items():
        out[f"{name}_{k}"] = np.stack(v)
np.savez(sys.argv[2], **out)
print("JAX_AUTO_OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_auto") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    spec = {n: CASES[n] for n in JAX_CASES}
    run = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "JAX_AUTO_OK" in run.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("name", JAX_CASES)
def test_auto_steps_match_jax_shard_map(dist_out, jax_out, name):
    for r in range(Q):
        got = dist_out[r]["runs"][name]
        np.testing.assert_allclose(got["loss"], jax_out[name + "_loss"],
                                   rtol=0, atol=TOL)
        for k in ("pair_transport", "pair_err"):
            _rel(np.stack(got[k]), jax_out[f"{name}_{k}"], rtol=2e-5)


@pytest.mark.parametrize("name", JAX_CASES)
def test_first_halo_matches_jax_shard_map(dist_out, jax_out, name):
    want = jax_out[name + "_halo"]                 # [Q, C, F] / [Q, Q·B, F]
    for r in range(Q):
        np.testing.assert_array_equal(dist_out[r]["runs"][name]["halo"],
                                      want[r])

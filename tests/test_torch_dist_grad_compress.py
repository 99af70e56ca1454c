"""VARCO data-parallel LM training on the worker group:
``make_varco_dp_train_step`` over a ``WorkerMesh`` of Q = 4 ``gloo``
processes on the CPU, against the port's emulated ``DPMesh(4)`` and the
JAX package's step under ``shard_map``.

One group (``spawn_workers``) runs every case; the emulated references
run in this process on one thread, as the workers do, while the group
runs.

* granite-3-2b and qwen2-moe-a2.7b smoke (f32) under ``varco:linear:5``,
  ``fixed:4`` and ``full``, 3 steps of SGD lr 1 from the port's seeded
  weights: ``grad_bits`` and ``rate`` exactly; ``loss``, ``ce`` and
  ``moe_aux`` within 1e-6 relative (both sides compute a worker's rows on
  one thread); each worker's compressed leaves bitwise (equal weights,
  equal rows, one key stream); parameters within 1e-5 of each leaf's
  largest, and in fact bitwise, since the group sums in rank order as
  the emulated workers are added; parameters and optimiser state bitwise
  equal across the ranks after every step.
* granite smoke in bf16 under AdamW (``train_lm``'s optimiser) through
  the group: bitwise equal to the emulated run (a backend all-reduce's
  own summation order drifts there by 3.8e-2 of a leaf's norm in three
  steps).
* granite smoke from the JAX package's weights, one ``varco:linear:5``
  step against ``repro.dist.grad_compress.make_varco_dp_train_step`` on 4
  virtual CPU devices (a subprocess that runs while the group does):
  parameter changes within 2e-5 of each leaf's largest (the reference's
  own backends drift by ≈ 8e-6, ROADMAP queue 3), ``grad_bits`` and
  ``rate`` exactly.
* ``train_lm`` on the group under ``varco:linear:5``, ``fixed:4`` and
  ``full`` against the same loop over ``DPMesh(4)`` (every metric equal),
  and ``train_lm(workers=4)`` spawning its own group.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import transformer as JT
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as gp
from repro_torch.dist.grad_compress import (make_dp_mesh,
                                            make_varco_dp_train_step)
from repro_torch.launch.steps import make_optimizer
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import init_lm
from repro_torch.train import optim
from repro_torch.train.data import TokenPipeline

import torch_dist_cases as cases

ROOT = Path(__file__).resolve().parents[1]
Q, TOL, LOSS_RTOL, JAX_TOL = 4, 1e-5, 1e-6, 2e-5
COMMS = ("varco:linear:5", "fixed:4", "full")
CASES = {f"{arch.split('-')[0]}_{comm.split(':')[0]}": (arch, comm)
         for arch in ("granite-3-2b", "qwen2-moe-a2.7b") for comm in COMMS}
#: granite smoke in bf16 under AdamW: (dtype overrides, comm)
BF16_CASES = {f"bf16_{c.split(':')[0]}": c for c in ("varco:linear:5",
                                                     "full")}
JAX_ARCH, JAX_COMM, JAX_KEY = "granite-3-2b", "varco:linear:5", 3

JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import get_config
from repro.core.varco import CommPolicy
from repro.dist import grad_compress as G
from repro.models import transformer as T
from repro.train import optim as O

arch, comm, key, path = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
cfg = get_config(arch, smoke=True)
params = jax.jit(T.init_lm, static_argnums=1)(jax.random.key(0), cfg)
toks = np.load(path + ".tokens.npy")
step = G.make_varco_dp_train_step(cfg, O.sgd(1.0), CommPolicy.parse(comm, 40),
                                  G.make_dp_mesh(4))
new, _, m = step(params, O.sgd(1.0).init(params),
                 {"tokens": jnp.asarray(toks)}, jnp.asarray(0),
                 jax.random.key(key))
delta = jax.tree_util.tree_leaves(
    jax.tree_util.tree_map(lambda a, b: a - b, params, new))
np.savez(path, *[np.asarray(d, np.float32) for d in delta],
         **{"m_" + k: np.asarray(v, np.float32) for k, v in m.items()})
print("JAX_DP_OK")
"""


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    jc = jget(JAX_ARCH, smoke=True)
    params = jax.jit(JT.init_lm, static_argnums=1)(jax.random.key(0), jc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (8, 64)).astype(np.int32)
    return {"arch": JAX_ARCH, "comm": JAX_COMM, "key": JAX_KEY,
            "params_np": jax.tree_util.tree_map(np.asarray, params),
            "tokens": toks, "train_comms": COMMS,
            "path": str(tmp_path_factory.mktemp("jax_dp") / "out")}


@pytest.fixture(scope="module")
def jax_proc(jax_case):
    """The JAX package's shard_map step, started before the worker group
    so the two overlap."""
    path = jax_case["path"]
    np.save(path + ".tokens.npy", jax_case["tokens"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, JAX_ARCH,
                             JAX_COMM, str(JAX_KEY), path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _emulated_runs() -> dict:
    """Every case, bf16 case and ``train_lm`` comm over the emulated
    ``DPMesh(4)`` on one thread."""
    out = {}
    with cases.one_thread():
        for name, (arch, comm) in CASES.items():
            cfg, params, toks = cases.lm_setup(arch)
            out[name] = cases.run_lm_dp(cfg, params, toks, comm,
                                        make_dp_mesh(Q, device="cpu"))
        for name, comm in BF16_CASES.items():
            out[name] = cases.run_bf16_adamw(comm,
                                             make_dp_mesh(Q, device="cpu"))
        for comm in COMMS:
            out[f"train_lm:{comm}"] = _emulated_train(comm)
    return out


@pytest.fixture(scope="module")
def runs(jax_case, jax_proc):
    """The group's records and the emulated references, computed in this
    process while the group's workers run."""
    case = {k: v for k, v in jax_case.items() if k != "path"}
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(gp.spawn_workers, cases.lm_dp_cases, Q, CASES,
                            case, BF16_CASES, device="cpu")
        emulated = _emulated_runs()
        return group.result(), emulated


@pytest.fixture(scope="module")
def dist_out(runs):
    return runs[0]


@pytest.fixture(scope="module")
def emulated(runs):
    return runs[1]


@pytest.fixture(scope="module")
def jax_out(jax_proc, jax_case):
    out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, f"{out}\n{err}"
    assert "JAX_DP_OK" in out
    with np.load(jax_case["path"] + ".npz") as z:
        return dict(z)


def _close_leaves(got, want, tol):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (i, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_group_step_matches_emulated(dist_out, emulated, name):
    for i, (got, want) in enumerate(zip(dist_out[name], emulated[name])):
        gm, wm = got["metrics"], want["metrics"]
        assert gm["grad_bits"] == wm["grad_bits"], (i, gm, wm)
        assert gm["rate"] == wm["rate"]
        for k in ("loss", "ce", "moe_aux"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_RTOL,
                                       atol=0, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                                   rtol=TOL, atol=0)
        _close_leaves(got["params"], want["params"], TOL)
        assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                     want["params"]))
        assert got["replicas_equal"], f"step {i}: ranks differ"
    if CASES[name][1] == "full":
        assert dist_out[name][0]["metrics"]["grad_bits"] > 0
        assert dist_out[name][0]["metrics"]["rate"] == 1.0
    if CASES[name][1].startswith("varco"):
        assert dist_out[name][0]["metrics"]["rate"] == 128.0


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_group_bf16_adamw_is_the_emulated_run(dist_out, emulated, name):
    for i, (got, emu) in enumerate(zip(dist_out[name], emulated[name],
                                       strict=True)):
        assert got["metrics"] == emu["metrics"], i
        assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                     emu["params"])), i
        assert got["replicas_equal"], i
        assert all(p.dtype == torch.bfloat16 for p in got["params"])


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items()
                                  if c != "full"])
def test_group_compresses_as_the_emulated_workers(dist_out, emulated, name):
    for i, (got, want) in enumerate(zip(dist_out[name], emulated[name])):
        assert sorted(got["compressed"]) == sorted(want["compressed"]) == \
            list(range(Q))
        for w in range(Q):
            for a, b in zip(got["compressed"][w], want["compressed"][w],
                            strict=True):
                assert torch.equal(a, b), (i, w)


def test_group_step_matches_jax_shard_map(dist_out, jax_out):
    got = dist_out["jax"]
    m = got["metrics"]
    assert m["grad_bits"] == float(jax_out["m_grad_bits"]) > 0
    assert m["rate"] == float(jax_out["m_rate"])
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(m[k], float(jax_out[f"m_{k}"]),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=k)
    want = [jax_out[f"arr_{i}"] for i in range(len(got["delta"]))]
    _close_leaves(got["delta"], want, JAX_TOL)


def _emulated_train(comm: str) -> list:
    """``train_lm``'s loop over the emulated ``DPMesh(4)``."""
    cfg, _, _ = cases.lm_setup(JAX_ARCH)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(cfg, lr=3e-3)
    state = opt.init(params)
    step = make_varco_dp_train_step(cfg, opt, CommPolicy.parse(
        comm, cases.LM_STEPS), make_dp_mesh(Q, device="cpu"))
    pipe = TokenPipeline(cfg.vocab_size, cases.LM_BATCH, cases.LM_SEQ,
                         device="cpu")
    hist = []
    for i, b in zip(range(cases.LM_STEPS), pipe):
        params, state, m = step(params, state, b, i, prng.key(i))
        hist.append({k: float(v) for k, v in m.items()})
    return hist


@pytest.mark.parametrize("comm", COMMS)
def test_train_lm_on_the_group_matches_emulated(dist_out, emulated, comm):
    got = dist_out[f"train_lm:{comm}"]
    want = emulated[f"train_lm:{comm}"]
    assert len(got) == len(want) == cases.LM_STEPS
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"])
        assert g["grad_bits"] > 0
        # the group sums in rank order: every metric is the emulated one
        assert {k: g[k] for k in w} == w
        # a worker ships 2(Q-1)/Q of the f32 gradient tree, and more
        assert g["sent_bytes"] >= 2 * (Q - 1) / Q * 4 * cases.lm_setup(
            JAX_ARCH)[1]["embed"].numel()
        assert g["staged_bytes"] == 0 and g["comm_s"] > 0


def test_train_lm_spawns_its_workers(dist_out):
    comm = "varco:linear:5"
    params, state, hist = train_lm(JAX_ARCH, smoke=True,
                                   steps=cases.LM_STEPS,
                                   batch=cases.LM_BATCH, seq=cases.LM_SEQ,
                                   comm=comm, device="cpu", workers=Q,
                                   log=None)
    def timeless(h):
        return [{k: v for k, v in m.items() if k != "comm_s"} for m in h]

    assert timeless(hist) == timeless(dist_out[f"train_lm:{comm}"])
    assert int(state["step"]) == cases.LM_STEPS
    assert all(torch.isfinite(t).all() for t in optim.tree_leaves(params))
    with pytest.raises(ValueError, match="not both"):
        train_lm(JAX_ARCH, smoke=True, device="cpu", workers=2,
                 mesh=object())

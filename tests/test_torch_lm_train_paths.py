"""The LM training slice's paths against the live JAX package, on the
CPU (the JAX package's smoke weights carried across as in
``tests/test_torch_lm_train.py``, ``tests/torch_lm_parity.py``):

* ``chunked_sdpa`` at S = 2048 with GQA and a window within 1e-5 (and the
  masked plain ``sdpa``), and the training forward's chunked branch (S =
  2048) within 1e-5;
* a bf16 step with f32 and with bf16 moments: XLA and torch round bf16
  chains differently (the forward already differs in 77% of the hidden
  entries by bf16 ulps), so the loss is held at rel 1e-4 and the gradient
  norm at rel 1e-3; the moments keep the requested dtype and agree within
  5e-2 of each leaf's norm; every parameter moves by at most 2.5 lr from
  JAX's, and at least 98% of the entries move alike;
* ``TokenPipeline`` bitwise for 3 batches;
* the training CLI (also ``--comm varco:linear:5`` and ``fixed:4``) and
  its refusals without a card;
* the SSD backward stays finite where JAX's overflows.

The training forward never reaches ``ops.mha``, ``ops.ssd_chunk`` or their
plain versions (patched to raise here).
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.nn.modules import param_count as j_param_count
from repro.train.data import TokenPipeline as JPipeline
from repro_torch.configs.base import get_config as tget
from repro_torch.core.varco import CommPolicy
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_lm
from repro_torch.models import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optim import tree_leaves

from torch_lm_parity import (LR, ROOT, TOL, _batches, _np, _port_grads,
                             _rel_close, _setup, port_on_one_thread)


@pytest.mark.parametrize("window", [0, 700])
def test_chunked_sdpa_matches_jax(window):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((1, 2048, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2048, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2048, 2, 16)).astype(np.float32)
    cot = rng.standard_normal((1, 2048, 4, 16)).astype(np.float32)

    def j_obj(q, k, v):
        return jnp.sum(JT.chunked_sdpa(q, k, v, window) * cot)

    j_out = JT.chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window)
    j_grads = jax.grad(j_obj, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TT.chunked_sdpa(tq, tk, tv, window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (tq, tk, tv))
    _rel_close(list(grads), list(j_grads))
    # and the masked plain sdpa computes the same attention
    pos = torch.arange(2048)[None]
    plain = L.sdpa(tq.detach(), tk.detach(), tv.detach(),
                   L._attn_mask(pos, pos, window))
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), rtol=0,
                               atol=TOL)


def test_forward_train_chunked_branch_matches_jax():
    """S = 2048 takes ``chunked_sdpa`` on both sides."""
    jc, tc, jp, tp = _setup("granite-3-2b")
    assert L.use_chunked_sdpa(tc, 2048, None)
    jb, tb = _batches(jc, 1, 2048, seed=3)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jc, b), has_aux=True))(jp, jb)
    tl, _, tg = _port_grads(tp, tc, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    _rel_close(tg, jg)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_bf16_step_matches_jax(moment_dtype):
    over = dict(param_dtype="bfloat16", activ_dtype="bfloat16",
                moment_dtype=moment_dtype)
    jc, tc, jp, tp = _setup("granite-3-2b", **over)
    jb, tb = _batches(jc, 2, 64)
    jopt = jsteps.make_optimizer(jc, lr=LR)
    topt = tsteps.make_optimizer(tc, lr=LR)
    js = jopt.init(jp)
    ts = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    want_dt = getattr(torch, moment_dtype)
    assert all(t.dtype == want_dt for t in tree_leaves(topt.init(tp)["mu"]))
    assert all(t.dtype == want_dt for t in tree_leaves(ts["nu"]))
    jp1, js1, jm = jax.jit(jsteps.make_train_step(jc, jopt))(jp, js, jb)
    tp1, ts1, tm = tsteps.make_train_step(tc, topt)(tp, ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-3)
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(js1[name]),
                        tree_leaves(ts1[name])):
            assert b.dtype == want_dt and str(a.dtype) == moment_dtype
            a, b = _np(a), _np(b)
            assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(a)
    for a0, a, b in zip(jax.tree_util.tree_leaves(jp),
                        jax.tree_util.tree_leaves(jp1), tree_leaves(tp1)):
        assert b.dtype == torch.bfloat16
        d_j, d_t = _np(a) - _np(a0), _np(b) - _np(a0)
        assert float(np.abs(d_t - d_j).max()) <= 2.5 * LR
        assert float(np.mean(np.sign(d_t) == np.sign(d_j))) >= 0.98


def test_token_pipeline_bitwise():
    jp = JPipeline(512, 3, 40, seed=5)
    tp = TokenPipeline(512, 3, 40, seed=5, device="cpu")
    for _ in range(3):
        a, b = next(jp)["tokens"], next(tp)["tokens"]
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _raise(*_a, **_k):
    raise AssertionError("the training path reached an LM kernel")


@pytest.mark.parametrize("arch,s", [("granite-3-2b", 64),
                                    ("granite-3-2b", 2048),
                                    ("mamba2-130m", 128),
                                    ("jamba-1.5-large-398b", 128)])
def test_training_path_reaches_no_kernel(monkeypatch, arch, s):
    _, tc, _, tp = _setup(arch)
    _, tb = _batches(tc, 1, s)
    for name in ("mha", "ssd_chunk", "flash_attention_plain",
                 "ssd_chunk_plain"):
        monkeypatch.setattr(ops, name, _raise)
    opt = tsteps.make_optimizer(tc, lr=LR)
    _, _, m = tsteps.make_train_step(tc, opt)(tp, opt.init(tp), tb)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(AssertionError, match="reached an LM kernel"):
        TT.prefill(tp, tc, tb)                 # serving still takes them


def test_train_cli_and_refusals(tmp_path, capsys):
    # one thread, as the module runs the port (port_on_one_thread)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ck = tmp_path / "lm.ckpt"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--smoke", "--steps", "3", "--device", "cpu",
         "--ckpt", str(ck)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    jc, _, jp, _ = _setup("granite-3-2b")
    n = j_param_count(jp)
    assert lines[0] == (f"arch=granite-smoke params={n:,} layers=2 "
                        f"d={jc.d_model}")
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"],
                                                     ["step", "2"]]
    assert all("loss" in ln and "grad_norm" in ln for ln in lines[1:3])
    assert lines[3] == f"checkpoint -> {ck}"
    assert checkpoint.peek(str(ck)) == {"arch": "granite-smoke", "steps": 3}
    tc = tget("granite-3-2b", smoke=True)
    like_p = TT.init_lm(tc, device="cpu")
    tree, _ = checkpoint.restore(str(ck), {
        "params": like_p,
        "opt": tsteps.make_optimizer(tc).init(like_p)})
    assert int(tree["opt"]["step"]) == 3
    assert tree["opt"]["mu"]["embed"].dtype == torch.float32
    # the compressing --comm specs run through the data-parallel step (one
    # worker), and each line adds the rate, as the JAX CLI's do
    capsys.readouterr()
    train_main(["--arch", "granite-3-2b", "--smoke", "--steps", "3",
                "--device", "cpu", "--comm", "varco:linear:5"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"],
                                                     ["step", "2"]]
    pol = CommPolicy.parse("varco:linear:5", 3)
    assert [float(ln.split("rate")[1].split()[0]) for ln in lines[1:3]] == \
        [float(pol.rate(0)), float(pol.rate(2))] == [128.0, 1.0]
    _, opt_state, ms = train_lm("granite-3-2b", smoke=True, steps=2,
                                comm="fixed:4", device="cpu", log=None)
    assert [m["rate"] for m in ms] == [4.0, 4.0]
    assert all(m["grad_bits"] == 0.0 and np.isfinite(m["loss"]) for m in ms)
    assert int(opt_state["step"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_lm("granite-3-2b", smoke=True, steps=1, log=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            TokenPipeline(512, 2, 8)


def test_ssd_backward_stays_finite_where_the_decay_overflows():
    """Large ``dt`` (``dt_bias`` + 4) puts a chunk's decay past e^88.  The
    JAX form exponentiates the non-causal entries before masking them and
    its gradient is NaN there (inf · 0); the port masks before the exp:
    the same loss, finite gradients."""
    jc, tc, jp, _ = _setup("mamba2-130m")
    mamba = dict(jp["blocks"]["p0_mamba"]["mamba"])
    mamba["dt_bias"] = mamba["dt_bias"] + 4.0
    jp = {**jp, "blocks": {"p0_mamba": {**jp["blocks"]["p0_mamba"],
                                        "mamba": mamba}}}
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb, tb = _batches(jc, 1, 64)
    jl, _ = JT.lm_loss(jp, jc, jb)
    tl, _, tg = _port_grads(tp, tc, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    assert all(bool(torch.isfinite(g).all()) for g in tg)

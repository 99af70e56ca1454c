"""The port's VARCO-compressed data-parallel LM step against the live JAX
package, on the CPU.

granite-3-2b's smoke config with JAX's ``init_lm`` weights carried across
(``lm_params_from_jax``), one SGD step (lr 1, so a parameter's change is
its clipped gradient; never AdamW's first update, which amplifies f32
sum-order noise in near-zero gradients):

* Q = 1 against ``make_varco_dp_train_step`` on a one-device mesh,
  in-process (``varco:linear:5`` at step 0, rate 128, and ``fixed:4``):
  loss, CE, aux and gradient norm within 1e-5, ``grad_bits`` (0 at Q =
  1) and ``rate`` exactly, every gradient leaf within 1e-5 of its largest
  JAX magnitude;
* Q = 4 emulated workers against the JAX step under ``shard_map`` on 4
  virtual CPU devices, in one subprocess (``varco:linear:5`` and
  ``full``): metrics and gradients within 2e-5 (the reference's own
  emulated and ``shard_map`` backends drift by ≈ 8e-6), ``grad_bits`` and
  ``rate`` exactly;
* at Q = 1 each leaf is compressed in place: when leaf ``i`` is
  compressed, the original gradients of leaves ``0..i-1`` are released.
"""

from __future__ import annotations

import functools
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.varco import CommPolicy as JPolicy
from repro.dist import grad_compress as JG
from repro.models import transformer as JT
from repro.train import optim as JO
from repro_torch import prng
from repro_torch.configs.base import get_config as tget
from repro_torch.core import collectives as TCOL
from repro_torch.core.compression import get_compressor
from repro_torch.core.varco import CommPolicy as TPolicy
from repro_torch.dist import grad_compress as TG
from repro_torch.models import lm_params_from_jax
from repro_torch.train import optim as TO

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-3-2b"
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    jc, tc = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.key(0), jc)
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (4, 64)).astype(np.int32)
    return jc, tc, jp, toks


def _port_params(jp):
    return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close_leaves(j_delta, t_delta, tol):
    flat = jax.tree_util.tree_flatten_with_path(j_delta)[0]
    got = TO.tree_leaves(t_delta)
    assert len(flat) == len(got)
    for (path, a), b in zip(flat, got):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("comm,step_idx", [("varco:linear:5", 0),
                                           ("fixed:4", 1)])
def test_one_worker_step_matches_jax(comm, step_idx):
    jc, tc, jp, toks = _setup()
    tp = _port_params(jp)
    jstep = JG.make_varco_dp_train_step(jc, JO.sgd(1.0),
                                        JPolicy.parse(comm, 40),
                                        JG.make_dp_mesh(1))
    tstep = TG.make_varco_dp_train_step(tc, TO.sgd(1.0),
                                        TPolicy.parse(comm, 40),
                                        TG.make_dp_mesh(1, device="cpu"))
    jp1, _, jm = jstep(jp, JO.sgd(1.0).init(jp),
                       {"tokens": jnp.asarray(toks)}, jnp.asarray(step_idx),
                       jax.random.key(step_idx + 5))
    tp1, _, tm = tstep(tp, TO.sgd(1.0).init(tp),
                       {"tokens": torch.from_numpy(toks)}, step_idx,
                       prng.key(step_idx + 5))
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert float(tm["grad_bits"]) == float(jm["grad_bits"]) == 0.0
    assert float(tm["rate"]) == float(jm["rate"])
    # lr 1: params - params' = the clipped (compressed) gradient
    _close_leaves(jax.tree_util.tree_map(lambda a, b: a - b, jp, jp1),
                  TO.tree_map(lambda a, b: a - b, tp, tp1), TOL)


def test_one_worker_compresses_in_place():
    """``compressed_psum`` at Q = 1 over a generator: when leaf ``i`` is
    compressed, the originals of the leaves before it are gone, so the
    peak grows by one leaf."""
    refs, alive_at = [], []
    comp = get_compressor("randmask")

    class Watch:
        def __call__(self, key, x, rate):
            alive_at.append(sum(r() is not None for r in refs))
            return comp(key, x, rate)

    def make():
        tree = {f"l{i}": torch.randn(64, 32) for i in range(5)}
        refs.extend(weakref.ref(v) for v in TO.tree_leaves(tree))
        return tree

    def trees():
        yield make()              # unbound, as the dp step yields

    out, bits = TCOL.compressed_psum(trees(), 1, compressor=Watch(),
                                     rate=4.0, key=prng.key(0))
    gc.collect()
    assert alive_at == [5, 4, 3, 2, 1]
    assert all(r() is None for r in refs)
    assert sorted(out) == [f"l{i}" for i in range(5)]
    assert float(bits) == 0.0


def test_step_refuses_a_batch_off_the_workers():
    _, tc, jp, toks = _setup()
    step = TG.make_varco_dp_train_step(
        tc, TO.sgd(1.0), TPolicy.parse("fixed:4", 4),
        TG.make_dp_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="divisible by 3"):
        step(_port_params(jp), TO.sgd(1.0).init(_port_params(jp)),
             {"tokens": torch.from_numpy(toks)}, 0, prng.key(0))
    with pytest.raises(ValueError, match="at least one worker"):
        TG.make_dp_mesh(0, device="cpu")


SCRIPT = r"""
import numpy as np
import jax, jax.numpy as jnp
import torch
from repro.configs.base import get_config as jget
from repro.core.varco import CommPolicy as JPolicy
from repro.dist import grad_compress as JG
from repro.models import transformer as JT
from repro.train import optim as JO
from repro_torch import prng
from repro_torch.configs.base import get_config as tget
from repro_torch.core.varco import CommPolicy as TPolicy
from repro_torch.dist import grad_compress as TG
from repro_torch.models import lm_params_from_jax
from repro_torch.train import optim as TO

TOL = 2e-5
jc, tc = jget("granite-3-2b", smoke=True), tget("granite-3-2b", smoke=True)
jp = jax.jit(JT.init_lm, static_argnums=1)(jax.random.key(0), jc)
tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
toks = np.random.default_rng(1).integers(0, jc.vocab_size, (8, 64)) \
    .astype(np.int32)
for comm in ("varco:linear:5", "full"):
    jstep = JG.make_varco_dp_train_step(jc, JO.sgd(1.0),
                                        JPolicy.parse(comm, 40),
                                        JG.make_dp_mesh(4))
    tstep = TG.make_varco_dp_train_step(tc, TO.sgd(1.0),
                                        TPolicy.parse(comm, 40),
                                        TG.make_dp_mesh(4, device="cpu"))
    jp1, _, jm = jstep(jp, JO.sgd(1.0).init(jp),
                       {"tokens": jnp.asarray(toks)}, jnp.asarray(0),
                       jax.random.key(3))
    tp1, _, tm = tstep(tp, TO.sgd(1.0).init(tp),
                       {"tokens": torch.from_numpy(toks)}, 0, prng.key(3))
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert float(tm["grad_bits"]) == float(jm["grad_bits"]) > 0, \
        (float(tm["grad_bits"]), float(jm["grad_bits"]))
    assert float(tm["rate"]) == float(jm["rate"])
    jd = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a, b: a - b, jp, jp1))
    td = TO.tree_leaves(TO.tree_map(lambda a, b: a - b, tp, tp1))
    assert len(jd) == len(td)
    worst = 0.0
    for a, b in zip(jd, td):
        a = np.asarray(a, np.float32)
        err = float(np.abs(a - b.numpy()).max())
        scale = max(float(np.abs(a).max()), 1e-30)
        assert err <= TOL * scale, (comm, err, scale)
        worst = max(worst, err / scale)
    print(comm, "OK", f"worst={worst:.2e}", float(tm["grad_bits"]))
print("DP_STEP_OK")
"""


def test_four_workers_match_shard_map():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "DP_STEP_OK" in out.stdout, out.stdout

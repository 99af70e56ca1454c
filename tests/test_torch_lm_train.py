"""The LM training slice of the port against the live JAX package, on the
CPU: loss, gradients and train steps of every architecture.

JAX's jitted ``init_lm(jax.random.key(0), SMOKE)`` weights for every architecture
of the registry are carried across with ``lm_params_from_jax``, and JAX's
AdamW state with ``adamw_state_from_jax`` (``tests/torch_lm_parity.py``).
Held in f32:

* ``lm_loss`` (CE and MoE aux) within 1e-5, and every gradient leaf within
  1e-5 of that leaf's largest JAX magnitude — except the SSD's per-head
  ``A_log`` and ``dt_bias`` leaves, held at 1e-4: each entry sums B·T·P·N
  terms that cancel to a few percent of the largest term, so f32 sum
  order shows above 1e-5 of the leaf's largest (measured 4.1e-5 on
  jamba's ``A_log``, whose largest gradient is 6e-5);
* one ``make_train_step`` step taken from the same populated AdamW state
  (JAX's params and state after one JAX step): params within 1e-5, the
  moments within 1e-5 of each leaf's largest, the metrics within 1e-5.
  The first step from the zero state is held the same way except for
  parameters whose JAX gradient is below 1e-6: there AdamW's first update
  ``lr · g / (|g| + eps)`` turns the frameworks' f32 gradient differences
  of ~1e-13 into update differences of up to ``lr`` (measured: 33 of
  541,312 granite entries above 1e-5, every one at ``|g| ≤ 2e-7``);
* the loss mask, as above;
* remat on and off give identical losses, and gradients within 1e-6 of
  each leaf's largest (the recomputed graph may accumulate a tensor's
  gradient contributions in another order: jamba's differ by 1.9e-9,
  qwen2-moe's not at all).

The attention paths, bf16 steps, the token pipeline and the CLI:
``tests/test_torch_lm_train_paths.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.launch import steps as tsteps
from repro_torch.models import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.train.optim import tree_leaves

from torch_lm_parity import (ARCHS, LR, TOL, _batches, _metrics_close, _np,
                             _port_grads, _rel_close, _seq, _setup,
                             port_on_one_thread)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_jax(arch):
    jc, tc, jp, tp = _setup(arch)
    jb, tb = _batches(jc, 2, _seq(jc))
    jopt = jsteps.make_optimizer(jc, lr=LR)
    topt = tsteps.make_optimizer(tc, lr=LR)
    jstep_fn = jsteps.make_train_step(jc, jopt)

    @jax.jit
    def jboth(p, s, b):                  # one compile: grads and the step
        return (jax.value_and_grad(lambda q: JT.lm_loss(q, jc, b),
                                   has_aux=True)(p), jstep_fn(p, s, b))

    ((jl, jparts), jg), (jp1, js1, jm1) = jboth(jp, jopt.init(jp), jb)
    _, (jp2, js2, jm2) = jboth(jp1, js1, jb)
    tl, tparts, tg = _port_grads(tp, tc, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    if tc.moe is not None:
        assert float(tparts["moe_aux"]) > 0.0
    _rel_close(tg, jg)

    tstep = tsteps.make_train_step(tc, topt)
    # the first step, from the zero state
    tp1, ts1, tm1 = tstep(tp, topt.init(tp), tb)
    _metrics_close(jm1, tm1)
    _rel_close(tree_leaves(ts1["mu"]), js1["mu"])
    _rel_close(tree_leaves(ts1["nu"]), js1["nu"])
    conditioned = [np.abs(_np(g)) >= 1e-6
                   for g in jax.tree_util.tree_leaves(jg)]
    for a, b, w in zip(jax.tree_util.tree_leaves(jp1), tree_leaves(tp1),
                       conditioned):
        assert float(np.abs(_np(a) - _np(b))[w].max(initial=0.0)) <= TOL
    # a step from the same populated state
    cp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp1), "cpu")
    cs = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, js1), "cpu")
    tp2, ts2, tm2 = tstep(cp, cs, tb)
    _metrics_close(jm2, tm2)
    assert int(ts2["step"]) == int(js2["step"]) == 2
    for a, b in zip(jax.tree_util.tree_leaves(jp2), tree_leaves(tp2)):
        assert b.dtype == cp["embed"].dtype
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=TOL)
    _rel_close(tree_leaves(ts2["mu"]), js2["mu"])
    _rel_close(tree_leaves(ts2["nu"]), js2["nu"])
    # the step did not write its inputs
    for a, b in zip(jax.tree_util.tree_leaves(jp1), tree_leaves(cp)):
        np.testing.assert_array_equal(_np(b), _np(a))


def test_loss_mask_matches_jax():
    jc, tc, jp, tp = _setup("granite-3-2b")
    jb, tb = _batches(jc, 2, 64, seed=1, mask=True)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, jc, jb), has_aux=True))(jp)
    tl, tparts, tg = _port_grads(tp, tc, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    _rel_close(tg, jg)
    # the mask changes the loss
    unmasked, _ = TT.lm_loss(tp, tc, {"tokens": tb["tokens"]})
    assert abs(float(unmasked) - float(tl)) > 1e-4


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_remat_gives_equal_losses_and_grads(arch):
    _, tc, _, tp = _setup(arch)
    _, tb = _batches(tc, 2, _seq(tc), seed=2)
    off = _port_grads(tp, tc.with_(remat=False), tb)
    on = _port_grads(tp, tc.with_(remat=True), tb)
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[1]["moe_aux"], off[1]["moe_aux"])
    for a, b in zip(on[2], off[2]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())

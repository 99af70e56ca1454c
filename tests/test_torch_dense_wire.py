"""The JAX package's default wire in the port: the dense compressing
all-gather and the packed all-gather, one step per policy and compressor,
against the live JAX package on the CPU (``device="cpu"``: the plain
versions of the ``random_mask`` and pack/unpack kernels run).

Held, as ``tests/test_torch_train.py`` holds the p2p wire: one step per
open-loop policy and compressor (Q ∈ {1, 2, 4}; rates {1, 2, 4, 16} as
``tests/test_packed_wire.py`` sweeps them) with losses and updated
parameters within 1e-5 (f32 sums in another order; SGD with momentum),
``halo_bits``/``transport_bits`` at rel 1e-6; and the wires' options and
refusals.  ``train_gnn`` on these wires and the halos they deliver:
``tests/test_torch_dense_wire_train.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist import gnn_parallel as jgp
from repro.train import optim as joptim
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist import ratectl as trc
from repro_torch.dist.halo import attach_p2p
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim
from repro_torch.train.trainer import train_gnn

from torch_wire_parity import (F, TOL, _assert_params_close, _assert_rel,
                               _metas, _port, port_on_one_thread, world)


def _j_static_rate_step(cj, pol, opt, meta, graph, rate, key, params):
    """The JAX package's step for a compressor that needs a concrete rate
    (top-k: ``float(rate)``), which its jitted step cannot trace: the
    same loss and update, un-jitted."""
    comp = pol.compressor()

    def loss_fn(p):
        agg = jgp._make_aggregate_emulated(graph, meta, pol, comp, rate, key)
        return jgp._local_loss_fn(p, cj, graph, agg, meta)

    (loss, bits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    return joptim.apply_updates(params, updates), \
        jgp._step_metrics(loss, rate, bits)


STEP_CASES = [
    # (wire, q, spec, compressor)
    *[("dense", 4, s, c) for s, c in (
        ("full", None), ("none", None), ("fixed:1", "randmask"),
        ("fixed:2", "randmask"), ("fixed:4", "randmask"),
        ("fixed:16", "randmask"), ("varco:linear:5", "randmask"),
        ("fixed:4", "randmask_unbiased"), ("fixed:2", "blockmask"),
        ("fixed:8", "int8"), ("varco:linear:5", "int8"),
        ("fixed:4", "topk"))],
    ("dense", 1, "fixed:4", "randmask"), ("dense", 2, "fixed:4", "randmask"),
    ("dense", 2, "varco:linear:5", "randmask"),
    *[("packed", 4, s, "blockmask") for s in (
        "full", "none", "fixed:1", "fixed:2", "fixed:4", "fixed:16",
        "varco:linear:5")],
    ("packed", 1, "fixed:2", "blockmask"), ("packed", 2, "fixed:2",
                                            "blockmask"),
]


@pytest.mark.parametrize("wire,q,spec,comp", STEP_CASES,
                         ids=[f"{w}-q{q}-{s}-{c}" for w, q, s, c in
                              STEP_CASES])
def test_train_step_matches_jax(world, wire, q, spec, comp):
    """One step from the shared initialisation at step 3 of 100 (the
    linear schedule then sits near rate 109)."""
    w = world
    mj, mt = _metas(w, q, wire)
    pgj, pgt = w["part"](q)
    gj, gt = pgj.device_arrays(), pgt.device_arrays("cpu")
    pol_j = JPolicy.parse(spec, 100, compressor=comp)
    pol_t = CommPolicy.parse(spec, 100, compressor=comp)
    oj, ot = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    if comp == "topk":
        pj2, mjm = _j_static_rate_step(w["cj"], pol_j, oj, mj, gj, 4.0,
                                       jax.random.key(3), w["pj"])
    else:
        step_j = jgp.make_train_step(w["cj"], pol_j, oj, mj)
        pj2, _, mjm = step_j(w["pj"], oj.init(w["pj"]), gj, 3,
                             jax.random.key(3))
    step_t = tgp.make_train_step(w["ct"], pol_t, ot, mt)
    pt0 = _port(w["pj"])
    pt2, _, mtm = step_t(pt0, ot.init(pt0), gt, 3, prng.key(3))
    np.testing.assert_allclose(float(mtm["loss"]), float(mjm["loss"]),
                               rtol=0, atol=TOL)
    assert float(mtm["rate"]) == float(mjm["rate"])
    for k in ("halo_bits", "transport_bits"):
        _assert_rel(mtm[k], mjm[k])
    _assert_params_close(pt2, pj2)


def test_wire_options_and_refusals(world):
    w = world
    _, pgt = w["part"](4)
    p = _port(w["pj"])
    packed = tgp.DistMeta.build(pgt, p, wire="packed")
    assert packed.pair_rows and packed.p2p_hop_width == 0
    assert tgp.WIRES == ("dense", "packed", "p2p")
    with pytest.raises(ValueError, match="divisible"):
        tgp.DistMeta.build(pgt, tgnn.init_gnn(
            tgnn.GNNConfig(in_dim=F, hidden=96, out_dim=4, layers=2),
            torch.Generator().manual_seed(0), device="cpu"), wire="packed")
    with pytest.raises(ValueError, match="blockmask"):
        tgp.make_train_step(w["ct"], CommPolicy.parse("fixed:2", 4),
                            toptim.sgd(0.1), packed)
    # auto policies on the packed wire are ported now: the same calls
    # build a step and train (their parity with the JAX package:
    # tests/test_torch_auto_wires.py)
    ot = toptim.sgd(0.1)
    step = trc.make_auto_train_step(w["ct"], CommPolicy.parse(
        "auto:budget:1e9", 4), ot, packed)
    eye = np.eye(4, dtype=bool)
    plan = trc.RatePlan(np.where(eye, 1.0, 2.0).astype(np.float32),
                        np.zeros((4, 4), np.float32))
    _, _, m, cache = step(p, ot.init(p), attach_p2p(
        pgt.device_arrays("cpu"), pgt, "cpu"), prng.key(0), plan)
    assert cache == () and float(m["transport_bits"]) > 0
    res = train_gnn(w["g"], q=4, policy=CommPolicy.parse("auto:budget:1e9",
                                                         2),
                    epochs=2, wire="packed", device="cpu", hidden=128,
                    layers=2)
    assert res.meta.wire == "packed" and np.isfinite(res.history.loss).all()

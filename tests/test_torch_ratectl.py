"""The port's closed-loop controllers and the quantised wire's stochastic
rounding against the live JAX package on the CPU.

Held: the ``error`` and ``stale`` controllers, scalar and per-layer, at
``max_width`` 32 and 8, over ``init`` and six ``plan``/``observe`` rounds
fed the same seeded measurements — rates, widths and every state entry
at rel 1e-6 (f32 arithmetic in another order: bisection water-fills and
PI gains), skip masks exactly; ``make_controller``'s knob errors as the
JAX package raises them; ``round_key`` bitwise; ``quant_levels`` /
``quant_dequant`` / ``wire_quant`` with keys bitwise; and the fused
``pack_quant(..., keys=)`` / ``quant_hop`` bitwise against ``pack_bits(
quant_levels(wire_pack(x), key))`` (the plain versions of the
stochastic codec and of ``random_uniform`` run here).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.varco import CommPolicy as JPolicy
from repro.dist import gnn_parallel as jgp
from repro.dist import ratectl as jrc
from repro.graph.partition import partition_graph as j_partition
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.kernels import ops as jops
from repro.nn import gnn as jgnn
from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist import ratectl as trc
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.kernels import ops as tops
from repro_torch.kernels import randmask as trm
from repro_torch.kernels import varco_pack as tvp
from repro_torch.nn import gnn as tgnn

N, F, HIDDEN, LAYERS, Q, ROUNDS = 256, 128, 128, 2, 4, 6
LANE = 128


@pytest.fixture(scope="module")
def world():
    g, gj = tiny_graph(n=N, feat_dim=F), j_tiny(n=N, feat_dim=F)
    kw = dict(conv="sage", in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
              layers=LAYERS)
    cj, ct = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    pt = tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    mj = jgp.DistMeta.build(j_partition(gj, Q, seed=0), pj, wire="p2p")
    mt = tgp.DistMeta.build(partition_graph(g, Q, seed=0), pt, wire="p2p")
    return {"cj": cj, "ct": ct, "mj": mj, "mt": mt}


def _budget(meta) -> float:
    """Half the full-rate transport of ``ROUNDS`` steps."""
    return 0.5 * 2.0 * 32.0 * meta.halo_demand * (F + HIDDEN) * ROUNDS


def _assert_rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _observation(rng, t: int) -> dict:
    """Seeded measurements of one step: per-pair error and drift, the
    per-layer error, and a transport spend near the pacing profile."""
    eye = np.eye(Q, dtype=bool)
    err = np.where(eye, 0.0, rng.uniform(0.0, 50.0, (Q, Q)))
    layer_err = np.where(eye[None], 0.0,
                         rng.uniform(0.0, 50.0, (LAYERS, Q, Q)))
    # small drifts after the first step, so some pairs skip and a few
    # go stale past their cap
    delta = np.where(eye, 0.0, rng.uniform(0.0, 0.1 if t else 1.0, (Q, Q)))
    obs = {"pair_err": err, "layer_err": layer_err, "pair_delta": delta,
           "transport_bits": rng.uniform(0.5, 1.5) * 1.2e6}
    return {k: np.asarray(v, np.float32) for k, v in obs.items()}


@pytest.mark.parametrize("width", [32, 8])
@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("name", ["error", "stale"])
def test_controller_matches_jax(world, name, per_layer, width):
    w = world
    spec = f"auto:{name}:{_budget(w['mt']):g}" + \
        (f":w{width}" if width < 32 else "") + \
        (":per-layer" if per_layer else "")
    ctl_j = jrc.make_controller(JPolicy.parse(spec, ROUNDS), w["mj"], w["cj"],
                                ROUNDS)
    ctl_t = trc.make_controller(CommPolicy.parse(spec, ROUNDS), w["mt"],
                                w["ct"], ROUNDS)
    assert ctl_t.name == ctl_j.name == name
    sj, st = ctl_j.init(), ctl_t.init()
    rng = np.random.default_rng(17)
    skipped = narrow = 0
    for t in range(ROUNDS):
        plan_j, sj = ctl_j.plan(sj, t)
        plan_t, st = ctl_t.plan(st, t)
        _assert_rel(plan_t.rates, plan_j.rates)
        np.testing.assert_array_equal(np.asarray(plan_t.skip),
                                      np.asarray(plan_j.skip))
        assert (plan_t.widths is None) == (plan_j.widths is None)
        if plan_j.widths is not None:
            np.testing.assert_array_equal(np.asarray(plan_t.widths),
                                          np.asarray(plan_j.widths))
        skipped += int(np.asarray(plan_t.skip).sum())
        if plan_t.widths is not None:
            narrow += int((np.asarray(plan_t.widths) < 32).sum())
        obs = _observation(rng, t)
        sj = ctl_j.observe(sj, {k: jnp.asarray(v) for k, v in obs.items()})
        st = ctl_t.observe(st, {k: torch.from_numpy(v)
                                for k, v in obs.items()})
        assert sorted(st) == sorted(sj)
        for k in sj:
            if k == "skip":
                np.testing.assert_array_equal(st[k].numpy(),
                                              np.asarray(sj[k]))
            else:
                _assert_rel(st[k], sj[k])
    if name == "stale":
        assert skipped > 0
    if width < 32:                # some step spends its bits narrow
        assert narrow > 0


def test_error_observe_needs_its_measurement(world):
    w = world
    for per_layer in (False, True):
        spec = "auto:error:1e9" + (":per-layer" if per_layer else "")
        ctl = trc.make_controller(CommPolicy.parse(spec, 4), w["mt"],
                                  w["ct"], 4)
        with pytest.raises(KeyError):
            ctl.observe(ctl.init(), {"transport_bits": 1.0})


@pytest.mark.parametrize("ctl,knobs", [
    ("budget", {"threshold": 0.1}), ("error", {"max_stale": 3}),
    ("qos", {"threshold": 0.1, "max_stale": 2}), ("budget", {"ema_decay": 0.5}),
    ("stale", {"ema_decay": 0.5})])
def test_make_controller_refuses_foreign_knobs(world, ctl, knobs):
    w = world
    spec = f"auto:{ctl}:1e9"
    with pytest.raises(ValueError) as ej:
        jrc.make_controller(JPolicy.parse(spec, 4), w["mj"], w["cj"], 4,
                            **knobs)
    with pytest.raises(ValueError) as et:
        trc.make_controller(CommPolicy.parse(spec, 4), w["mt"], w["ct"], 4,
                            **knobs)
    assert str(et.value) == str(ej.value)


def test_make_controller_passes_its_knobs(world):
    w = world
    stale = trc.make_controller(CommPolicy.parse("auto:stale:1e9", 4),
                                w["mt"], w["ct"], 4, threshold=2.0,
                                max_stale=1, c_max=64.0)
    s = stale.init()
    obs = {"pair_delta": np.full((Q, Q), 1.0, np.float32),
           "transport_bits": 1.0}
    s = stale.observe(s, obs)
    assert s["skip"].sum() == Q * Q - Q          # 1.0 <= threshold 2.0
    s = stale.observe(s, obs)
    assert s["skip"].sum() == 0                  # aged past max_stale 1
    layered = trc.make_controller(CommPolicy.parse("auto:stale:1e9:per-layer",
                                               4), w["mt"], w["ct"], 4,
                              ema_decay=0.5)
    assert "ema" in layered.init()


# ---------------------------------------------------------------------------
# Stochastic rounding
# ---------------------------------------------------------------------------


def _jkey(seed: int, call: int):
    return jax.random.fold_in(jax.random.key(seed), call)


def _tkey(seed: int, call: int):
    return prng.fold_in(prng.key(seed), call)


@pytest.mark.parametrize("sender,hop", [(0, None), (3, None), (1, 0),
                                        (2, 2), (70000, 5)])
def test_round_key_matches_jax(sender, hop):
    assert tops.ROUND_SALT == jops.ROUND_SALT
    got = tops.round_key(_tkey(4, 2), sender, hop)
    want = jax.random.key_data(jops.round_key(_jkey(4, 2), sender, hop))
    np.testing.assert_array_equal(got, np.asarray(want, np.uint32))


def test_default_wire_rounding_by_device():
    """``rounding=None`` resolves by the step's device: stochastic on the
    card (the JAX package's default on its hardware target), rint on the
    CPU (its default there, which CPU parity is held under)."""
    assert tops.default_wire_rounding("cpu") == jops.default_wire_rounding()
    assert tops.default_wire_rounding(torch.device("cpu")) == "rint"
    assert tops.default_wire_rounding("cuda") == "stochastic"
    assert tops.default_wire_rounding(torch.device("cuda", 1)) == \
        "stochastic"
    with pytest.raises(ValueError, match="meta"):
        tops.default_wire_rounding("meta")


@pytest.mark.parametrize("width", [2, 4, 8, 32])
def test_keyed_quant_codecs_match_jax_bitwise(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(3, 2, 5, 2 * LANE)).astype(np.float32)
    x[0, 0, 1, :LANE] = 0.0                       # an all-zero block
    xt = torch.from_numpy(x)
    # one key
    kj, kt = jops.round_key(_jkey(1, 0), 2), tops.round_key(_tkey(1, 0), 2)
    lj, sj = jops.quant_levels(x, width, key=kj)
    lt, st = tops.quant_levels(xt, width, key=kt)
    if width < 32:    # at 32 the levels are garbage callers discard
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tops.quant_dequant(xt, width, key=kt).numpy(),
        np.asarray(jops.quant_dequant(x, width, key=kj)))
    # keys per (sender, hop) over the leading [3, 2], widths per pair —
    # the p2p wire's vmapped draw
    wj = np.array([[width, 8], [4, 32], [2, width]], np.float32)
    keys_t = np.stack([[tops.round_key(_tkey(1, 0), j, d) for d in range(2)]
                       for j in range(3)])
    want = np.stack([np.stack([np.asarray(jops.wire_quant(
        x[j, d], wj[j, d], key=jops.round_key(_jkey(1, 0), j, d)))
        for d in range(2)]) for j in range(3)])
    got = tops.wire_quant(xt, torch.from_numpy(wj)[:, :, None, None],
                          key=keys_t)
    np.testing.assert_array_equal(got.numpy(), want)
    # stochastic rounding moves values off the nearest level
    if width < 32:
        assert not torch.equal(got, tops.wire_quant(
            xt, torch.from_numpy(wj)[:, :, None, None]))


@pytest.mark.parametrize("width", [2, 4, 8])
def test_fused_stochastic_codec_matches_jax(width):
    """``pack_quant(x, kept, keys=)`` and ``quant_hop(..., keys=)`` are
    bitwise ``pack_bits(quant_levels(wire_pack(x), w, key=keys[b]))`` and
    its decode, at a per-row ``qmax`` under the storage width, ragged
    row count; the plain stochastic codec draws through the plain
    ``random_uniform``."""
    rng = np.random.default_rng(width + 10)
    b, n, nb, k = 5, 37, 3, 2
    x = rng.normal(size=(b, n, nb * LANE)).astype(np.float32)
    x[1, 3] = 0.0
    kept = np.stack([np.sort(rng.choice(nb, k, replace=False))
                     for _ in range(b)]).astype(np.int32)
    inv = np.full((b, nb), -1, np.int32)
    for r in range(b):
        inv[r, kept[r]] = np.arange(k)
    row_w = np.array([width, 2, width, 2, width], np.float32)
    keys = np.stack([tops.round_key(_tkey(9, 1), r) for r in range(b)])
    xt, kt, it = (torch.from_numpy(a) for a in (x, kept, inv))
    before = (tvp.varco_pack_quant.launches,
              tvp.varco_pack_quant_stochastic.launches,
              trm.random_uniform.launches)
    payload, scales = tops.pack_quant(xt, kt, width, tops.qmax_of(row_w),
                                      keys=keys)
    for r in range(b):
        packed = np.asarray(jops.wire_pack(x[r], kept[r], inv[r]))
        lj, sj = jops.quant_levels(packed, row_w[r],
                                   key=jops.round_key(_jkey(9, 1), r))
        np.testing.assert_array_equal(
            payload[r].numpy(), np.asarray(jops.pack_bits(lj, width)))
        np.testing.assert_array_equal(scales[r].numpy(), np.asarray(sj))
    sent = tops.quant_hop(xt, kt, it, tops.qmax_of(row_w), width,
                          keys=torch.from_numpy(keys.view(np.int32)))
    assert torch.equal(sent, tops.unpack_quant(payload, scales, it, width))
    # the CPU runs the plain versions: no kernel counter moves
    assert (tvp.varco_pack_quant.launches,
            tvp.varco_pack_quant_stochastic.launches,
            trm.random_uniform.launches) == before
    # without keys the codec rounds half to even, as before
    p_rint, _ = tops.pack_quant(xt, kt, width, tops.qmax_of(row_w))
    assert not torch.equal(p_rint, payload)


def test_random_uniform_plain_is_jax_uniform():
    keys = np.stack([tops.round_key(_tkey(2, 5), j) for j in range(3)])
    got = trm.random_uniform_plain(trm.keys_tensor(keys, "cpu"), 1000,
                                   offset=0)
    for j in range(3):
        want = jax.random.uniform(jops.round_key(_jkey(2, 5), j), (1000,))
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want))

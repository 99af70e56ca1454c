"""The port's kernel modules against the JAX package's oracles.

On this CPU-only machine the ops run their plain PyTorch versions (the
tensors lie on the CPU).  Those are held to the JAX ``ref`` oracles, to
``_ell_cpu`` and to the Pallas kernels in interpret mode: bitwise for
pack/unpack and the bit codecs, 1e-6 for the ELL SpMM (the sum order of
f32 products differs between the frameworks).  The CUDA kernels are held
to the plain versions on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ell_spmm import ell_spmm as pallas_ell
from repro.kernels.varco_pack import varco_pack as pallas_pack
from repro.kernels.varco_pack import varco_unpack as pallas_unpack
from repro_torch.kernels import ell_spmm as tell
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import varco_pack as tvp

LANE = 128


def _masks(rng, nb, k):
    kept = np.sort(rng.choice(nb, k, replace=False)).astype(np.int32)
    inv = np.full(nb, -1, np.int32)
    inv[kept] = np.arange(k, dtype=np.int32)
    return kept, inv


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,f,k", [(8, 128, 1), (24, 256, 1), (24, 256, 2),
                                   (40, 1024, 5)])
def test_pack_unpack_plain_bitwise_vs_oracle_and_pallas(n, f, k):
    rng = np.random.default_rng(n * f + k)
    x = rng.normal(size=(n, f)).astype(np.float32)
    kept, inv = _masks(rng, f // LANE, k)
    packed = tops.wire_pack(torch.from_numpy(x), torch.from_numpy(kept))
    want = np.asarray(jref.pack_reference(jnp.asarray(x), jnp.asarray(kept)))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(pallas_pack(jnp.asarray(x),
                                               jnp.asarray(kept),
                                               interpret=True)))
    back = tops.wire_unpack(packed, torch.from_numpy(inv))
    want_u = np.asarray(jref.unpack_reference(jnp.asarray(want),
                                              jnp.asarray(inv)))
    np.testing.assert_array_equal(back.numpy(), want_u)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(pallas_unpack(jnp.asarray(want),
                                               jnp.asarray(inv),
                                               interpret=True)))


@pytest.mark.parametrize("q,n,nb,k", [(4, 37, 2, 1), (3, 5, 4, 3),
                                      (1, 1, 1, 1)])
def test_batched_pack_unpack_per_sender_rows(q, n, nb, k):
    """One launch serves every sender: batch row ``i`` uses index row
    ``i`` (ragged N included) — equal to the per-sender oracle calls."""
    rng = np.random.default_rng(q * 100 + n)
    x = rng.normal(size=(q, n, nb * LANE)).astype(np.float32)
    masks = [_masks(rng, nb, k) for _ in range(q)]
    kept = np.stack([m[0] for m in masks])
    inv = np.stack([m[1] for m in masks])
    packed = tops.wire_pack(torch.from_numpy(x), torch.from_numpy(kept))
    back = tops.wire_unpack(packed, torch.from_numpy(inv))
    for i in range(q):
        p_i = np.asarray(jref.pack_reference(jnp.asarray(x[i]),
                                             jnp.asarray(kept[i])))
        np.testing.assert_array_equal(packed[i].numpy(), p_i)
        np.testing.assert_array_equal(
            back[i].numpy(),
            np.asarray(jref.unpack_reference(jnp.asarray(p_i),
                                             jnp.asarray(inv[i]))))
        # dropped blocks are zero-filled
        for b in np.flatnonzero(inv[i] < 0):
            assert not back[i, :, b * LANE:(b + 1) * LANE].any()
    np.testing.assert_array_equal(
        tref.pack_reference(torch.from_numpy(x[0]),
                            torch.from_numpy(kept[0])).numpy(),
        packed[0].numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch their kernel or raise; they never run the
    plain version, and a refused call leaves the launch count alone."""
    x = torch.zeros((1, 8, 128))
    kept = torch.zeros((1, 1), dtype=torch.int32)
    before = (tvp.varco_pack.launches, tvp.varco_unpack.launches,
              tell.ell_spmm.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tvp.varco_pack(x, kept)
    with pytest.raises(ValueError, match="CUDA"):
        tvp.varco_unpack(x, kept)
    nbr = torch.zeros((1, 8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tell.ell_spmm(x, nbr, torch.zeros((1, 8, 2)))
    with pytest.raises(TypeError):
        tvp.varco_pack(x.double(), kept)
    # the CPU route of ops runs the plain version and launches nothing
    tops.wire_pack(x, kept)
    tops.ell_aggregate(x, nbr, torch.zeros((1, 8, 2)))
    assert (tvp.varco_pack.launches, tvp.varco_unpack.launches,
            tell.ell_spmm.launches) == before


# ---------------------------------------------------------------------------
# ELL SpMM
# ---------------------------------------------------------------------------


def _ell_inputs(rng, n_dst, n_src, k, f, pad_frac=0.3):
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    nbr = rng.integers(0, n_src, (n_dst, k)).astype(np.int32)
    # mean-aggregator scale: each row's weights sum to about 1
    w = (rng.uniform(0.1, 1.0, (n_dst, k)) / k).astype(np.float32)
    pad = rng.uniform(size=(n_dst, k)) < pad_frac
    w[pad] = 0.0                                    # pad slots: w == 0
    nbr[pad] = 0
    return x, nbr, w


@pytest.mark.parametrize("n_dst,n_src,k,f", [(128, 1024, 4, 128),
                                             (37, 53, 7, 128),
                                             (1, 9, 29, 256),
                                             (45, 45, 33, 40)])
def test_ell_plain_matches_jax(n_dst, n_src, k, f):
    rng = np.random.default_rng(n_dst + k)
    x, nbr, w = _ell_inputs(rng, n_dst, n_src, k, f)
    got = tops.ell_aggregate(torch.from_numpy(x)[None],
                             torch.from_numpy(nbr)[None],
                             torch.from_numpy(w)[None])[0].numpy()
    for want in (jref.ell_spmm_reference(jnp.asarray(x), jnp.asarray(nbr),
                                         jnp.asarray(w)),
                 jops._ell_cpu(jnp.asarray(x), jnp.asarray(nbr),
                               jnp.asarray(w))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tref.ell_spmm_reference(torch.from_numpy(x), torch.from_numpy(nbr),
                                torch.from_numpy(w)).numpy(), got,
        rtol=0, atol=0)


def test_ell_plain_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    x, nbr, w = _ell_inputs(rng, 128, 256, 6, 128)
    want = pallas_ell(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w),
                      src_chunk=128, interpret=True)
    got = tops.ell_aggregate(torch.from_numpy(x)[None],
                             torch.from_numpy(nbr)[None],
                             torch.from_numpy(w)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def citation_ell():
    """The port's own ELL lists of a small ``citation_graph`` cut
    ``metis-like`` into Q = 4 partitions, as the serving engine cuts it."""
    from repro_torch.dist.halo import ell_arrays
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import citation_graph

    pg = partition_graph(citation_graph(n=3000, feat_dim=16, seed=0), 4,
                         scheme="metis-like", seed=0)
    return pg, ell_arrays(pg)


def test_ell_lists_lead_with_valid_slots(citation_ell):
    """Valid slots of every row, forward and reversed, form a prefix with
    nonzero weights and in-range ids: the layout the CUDA kernel's early
    stop at the last valid slot pays off on."""
    pg, ell = citation_ell
    nbr, w = ell["ell_nbr"], ell["ell_w"]
    assert nbr.shape[0] == 4 and nbr.shape[1] == pg.part_size
    valid = w != 0
    assert valid.any()
    # a prefix: once a slot is empty, every later slot of the row is too
    assert not (np.diff(valid.astype(np.int8), axis=-1) > 0).any()
    assert ((nbr[valid] >= 0) & (nbr[valid] < pg.part_size)).all()
    rvalid = ell["ell_rslot"] >= 0
    assert not (np.diff(rvalid.astype(np.int8), axis=-1) > 0).any()
    assert int(rvalid.sum()) == int(valid.sum())
    # the reversed weights the backward gathers through rslot are nonzero
    rw = np.take_along_axis(w.reshape(4, -1),
                            np.maximum(ell["ell_rslot"], 0).reshape(4, -1),
                            axis=1).reshape(rvalid.shape)
    assert (rw[rvalid] != 0).all()


@pytest.mark.parametrize("f", [64, 100, 256])
def test_ell_plain_matches_jax_on_citation_lists(citation_ell, f):
    """``ell_spmm_plain`` over the port's lists of a citation graph equals
    the JAX ``ell_spmm_reference`` per partition within 1e-6."""
    pg, ell = citation_ell
    rng = np.random.default_rng(f)
    x = rng.normal(size=(4, pg.part_size, f)).astype(np.float32)
    got = tell.ell_spmm_plain(torch.from_numpy(x),
                              torch.from_numpy(ell["ell_nbr"]),
                              torch.from_numpy(ell["ell_w"])).numpy()
    for p in range(4):
        want = jref.ell_spmm_reference(jnp.asarray(x[p]),
                                       jnp.asarray(ell["ell_nbr"][p]),
                                       jnp.asarray(ell["ell_w"][p]))
        np.testing.assert_allclose(got[p], np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_ell_batched_partitions_are_independent():
    rng = np.random.default_rng(9)
    parts = [_ell_inputs(rng, 21, 30, 5, 128) for _ in range(3)]
    x = torch.from_numpy(np.stack([p[0] for p in parts]))
    nbr = torch.from_numpy(np.stack([p[1] for p in parts]))
    w = torch.from_numpy(np.stack([p[2] for p in parts]))
    out = tops.ell_aggregate(x, nbr, w)
    for i, (xi, ni, wi) in enumerate(parts):
        want = jops._ell_cpu(jnp.asarray(xi), jnp.asarray(ni),
                             jnp.asarray(wi))
        np.testing.assert_allclose(out[i].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# quantised-wire codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 4, 8])
def test_bit_codecs_bitwise(width):
    rng = np.random.default_rng(width)
    x = rng.normal(size=(6, 2 * LANE)).astype(np.float32)
    x[1, :LANE] = 0.0                                   # an all-zero block
    lv_t, sc_t = tref.quant_levels_reference(torch.from_numpy(x), width)
    lv_j, sc_j = jref.quant_levels_reference(jnp.asarray(x), width)
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    lv2, sc2 = tops.quant_levels(torch.from_numpy(x), width)
    np.testing.assert_array_equal(lv2.numpy(), lv_t.numpy())
    np.testing.assert_array_equal(sc2.numpy(), sc_t.numpy())
    pb_t = tops.pack_bits(lv_t, width)
    pb_j = jops.pack_bits(lv_j, width)
    np.testing.assert_array_equal(pb_t.numpy(), np.asarray(pb_j))
    for m in (None, 2 * LANE - 1):
        np.testing.assert_array_equal(
            tref.unpack_bits_reference(pb_t, width, m).numpy(),
            np.asarray(jref.unpack_bits_reference(pb_j, width, m)))
    np.testing.assert_array_equal(
        tops.dequant_bits(pb_t, sc_t, width).numpy(),
        np.asarray(jops.dequant_bits(pb_j, sc_j, width)))
    # odd lane count: tail lanes zero-padded into the last byte
    odd = lv_t[:, :LANE - 1]
    np.testing.assert_array_equal(
        tref.pack_bits_reference(odd, width).numpy(),
        np.asarray(jref.pack_bits_reference(jnp.asarray(odd.numpy()),
                                            width)))


def test_quant_dequant_per_pair_widths_bitwise():
    rng = np.random.default_rng(3)
    hops = rng.normal(size=(4, 3, 5, 2 * LANE)).astype(np.float32)
    widths = rng.choice([2.0, 4.0, 8.0, 32.0], (4, 3)).astype(np.float32)
    w4 = widths[:, :, None, None]
    got = tops.wire_quant(torch.from_numpy(hops), torch.from_numpy(w4))
    want = jops.wire_quant(jnp.asarray(hops), jnp.asarray(w4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lv_t, sc_t = tops.quant_levels(torch.from_numpy(hops),
                                   torch.from_numpy(np.minimum(w4, 8.0)))
    lv_j, sc_j = jops.quant_levels(jnp.asarray(hops),
                                   jnp.asarray(np.minimum(w4, 8.0)))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    for w in (2.0, 8.0, 32.0, widths):
        np.testing.assert_array_equal(
            tops.per_block_wire_bits(w).numpy(),
            np.asarray(jops.per_block_wire_bits(w)))

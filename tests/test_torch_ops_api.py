"""The port's counterparts of the JAX package's small public names, held
to the JAX functions on seeded numpy inputs:

* ``kernels.ops.compression_indices`` and
  ``kernels.varco_pack.block_mask_indices`` — bitwise the JAX package's
  ``(kept, inv)`` for the same key, block count and rate;
* ``kernels.ops.compress_pack`` / ``compress_unpack`` /
  ``compress_roundtrip`` — bitwise the Pallas kernels in interpret mode,
  and the same wire bits;
* ``kernels.ops.aggregate`` — the Pallas ELL SpMM in interpret mode
  within 1e-6 of the largest output (the f32 sum order differs);
* ``kernels.ops.unpack_bits`` and ``kernels.ref.pack_bits_reference`` /
  ``unpack_bits_reference`` — bitwise, at every sub-byte width;
* ``configs.all_configs`` — the same ids and equal configs, field for
  field;
* ``nn.layer_norm`` — within 1e-6;
* ``core.compression.Compressed.wire_bits`` — equal bit counts.

On this CPU-only machine the ops run their plain versions; the kernels
are held to those on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.core.compression import Compressed as JCompressed
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.varco_pack import block_mask_indices as j_block_mask
from repro.nn import layer_norm as j_layer_norm
from repro_torch import prng
from repro_torch.configs import all_configs as t_all_configs
from repro_torch.core import Compressed as TCompressed
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.varco_pack import block_mask_indices as t_block_mask
from repro_torch.nn import layer_norm as t_layer_norm

LANE = 128
RATES = (1.0, 2.0, 3.0, 4.0, 5.3, 16.0, 100.0)


@pytest.mark.parametrize("n_blocks", [1, 4, 8, 13])
@pytest.mark.parametrize("seed", [0, 7])
def test_block_mask_indices_bitwise(n_blocks, seed):
    for rate in RATES:
        want = j_block_mask(jax.random.key(seed), n_blocks, rate)
        for got in (t_block_mask(prng.key(seed), n_blocks, rate),
                    tops.compression_indices(prng.key(seed), n_blocks,
                                             rate)):
            for g, w in zip(got, want, strict=True):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=f"rate {rate}")


@pytest.mark.parametrize("n,f,rate", [(16, 256, 2.0), (32, 512, 4.0),
                                      (8, 1024, 3.0)])
def test_compress_pack_unpack_roundtrip_bitwise(n, f, rate):
    x = np.random.default_rng(n + f).normal(size=(n, f)).astype(np.float32)
    kept, inv = t_block_mask(prng.key(3), f // LANE, rate)
    packed = tops.compress_pack(torch.from_numpy(x), kept)
    want = jops.compress_pack(jnp.asarray(x), jnp.asarray(kept),
                              interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    back = tops.compress_unpack(packed, torch.from_numpy(inv))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.compress_unpack(
            want, jnp.asarray(inv), interpret=True)))
    got, bits = tops.compress_roundtrip(prng.key(3), torch.from_numpy(x),
                                        rate)
    jgot, jbits = jops.compress_roundtrip(jax.random.key(3), jnp.asarray(x),
                                          rate, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(got.numpy(), back.numpy())
    assert bits == int(jbits) == n * len(kept) * LANE * 32


@pytest.mark.parametrize("ns,nd,k,f", [(64, 32, 4, 128), (96, 40, 7, 256)])
def test_aggregate_matches_pallas(ns, nd, k, f):
    rng = np.random.default_rng(ns * k)
    x = rng.normal(size=(ns, f)).astype(np.float32)
    nbr = rng.integers(0, ns, (nd, k)).astype(np.int32)
    w = rng.normal(size=(nd, k)).astype(np.float32)
    got = tops.aggregate(torch.from_numpy(x), torch.from_numpy(nbr),
                         torch.from_numpy(w)).numpy()
    want = np.asarray(jops.aggregate(jnp.asarray(x), jnp.asarray(nbr),
                                     jnp.asarray(w), interpret=True))
    assert got.shape == want.shape == (nd, f)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("m", [128, 77])
def test_bit_codecs_bitwise(width, m):
    qmax = 2 ** (width - 1) - 1
    lv = np.random.default_rng(width * m).integers(
        -qmax, qmax + 1, (3, m)).astype(np.int8)
    packed = tref.pack_bits_reference(torch.from_numpy(lv), width)
    jpacked = jref.pack_bits_reference(jnp.asarray(lv), width)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    for got in (tref.unpack_bits_reference(packed, width, m),
                tops.unpack_bits(packed, width, m)):
        np.testing.assert_array_equal(got.numpy(), lv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jops.unpack_bits(jpacked, width, m)))
    whole = tops.unpack_bits(packed, width)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jref.unpack_bits_reference(jpacked,
                                                             width)))


@pytest.mark.parametrize("smoke", [False, True])
def test_all_configs_match_jax(smoke):
    got, want = t_all_configs(smoke=smoke), j_all_configs(smoke=smoke)
    assert list(got) == list(want)
    for arch in want:
        assert dataclasses.asdict(got[arch]) == \
            dataclasses.asdict(want[arch]), arch


@pytest.mark.parametrize("shape,eps", [((4, 32), 1e-5), ((2, 3, 64), 1e-3)])
def test_layer_norm_matches_jax(shape, eps):
    x = (np.random.default_rng(len(shape)).normal(size=shape) * 3 + 1.5) \
        .astype(np.float32)
    got = t_layer_norm(torch.from_numpy(x), eps=eps).numpy()
    want = np.asarray(j_layer_norm(jnp.asarray(x), eps=eps))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(j_layer_norm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_compressed_wire_bits_match_jax():
    rng = np.random.default_rng(5)
    payload = rng.normal(size=(6, 256)).astype(np.float32)
    idx = rng.integers(0, 99, (6, 16)).astype(np.int32)
    scales = rng.normal(size=(6,)).astype(np.float32)
    mask = rng.normal(size=(6, 256)).astype(np.float32)
    cases = [
        (payload, {"idx": idx, "scale": scales}, {"mask": mask}),
        (payload.astype(np.int8), {"scale": scales}, {}),
        (payload, {}, {"mask": mask}),
    ]
    for p, meta, aux in cases:
        want = JCompressed(jnp.asarray(p),
                           {k: jnp.asarray(v) for k, v in meta.items()},
                           {k: jnp.asarray(v) for k, v in aux.items()})
        got = TCompressed(torch.from_numpy(p),
                          {k: torch.from_numpy(v) for k, v in meta.items()},
                          {k: torch.from_numpy(v) for k, v in aux.items()})
        bits = got.wire_bits()
        assert bits.dtype == torch.float32
        assert float(bits) == float(want.wire_bits())
    half = TCompressed(torch.zeros(4, 128, dtype=torch.bfloat16), {}, {})
    want = JCompressed(jnp.zeros((4, 128), jnp.bfloat16), {}, {})
    assert float(half.wire_bits()) == float(want.wire_bits()) == 4 * 128 * 16

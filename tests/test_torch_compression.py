"""The port's key-stream draws and Definition-1 compressors against the JAX
package's, on the CPU (the ``random_mask`` kernel's plain version runs;
``tests/test_torch_cuda.py`` holds the kernel to it on the card).

Held bitwise: ``prng.uniform`` / ``bernoulli`` / ``random_bits_torch``
against ``jax.random`` (hypothesis over keys and shapes), the 64-bit
counter split against the numpy Threefry, and every compressor's output,
single-key and vmapped over workers, at rates {1, 2, 4, 5.3, 16}.  The
wire bits at rel 1e-6 (both are float32 sums of the same integers), the
gradients at 1e-6 against ``jax.grad`` (``int8``'s reaches ``x`` only
through the per-row scale, summed in another order), and ``eps2`` at
rel 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import compression as JC
from repro_torch import prng
from repro_torch.core import compression as TC
from repro_torch.core.varco import CommPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.randmask import keys_tensor, random_mask_plain

RATES = [1.0, 2.0, 4.0, 5.3, 16.0]


def _x(seed: int = 0, shape=(6, 256)) -> np.ndarray:
    """Activations with the edges the compressors care about: an all-zero
    row, zeros inside a row, and magnitude ties (for top-k's order and
    int8's amax split)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1, :5] = 0.0
    rows[2, 3], rows[2, 7], rows[2, 11] = 4.0, -4.0, 4.0
    rows[3, 10:20] = 0.5
    return x


def _jrate(name: str, rate: float):
    # top-k takes a static rate in the JAX package (float(rate))
    return rate if name == "topk" else jnp.float32(rate)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), data=st.integers(0, 2 ** 31 - 1),
       rows=st.integers(1, 9), cols=st.integers(1, 70))
def test_uniform_bernoulli_and_torch_bits_match_jax(seed, data, rows, cols):
    jk = jax.random.fold_in(jax.random.key(seed), data)
    tk = prng.fold_in(prng.key(seed), data)
    shape = (rows, cols)
    want_bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got_bits = prng.random_bits_torch(tk, shape).numpy()
    assert got_bits.dtype == np.int64
    assert np.array_equal(got_bits.astype(np.uint32), want_bits)
    assert np.array_equal(prng.uniform(tk, shape),
                          np.asarray(jax.random.uniform(jk, shape)))
    for rate in RATES:
        p = np.float32(1.0) / np.float32(rate)
        want = np.asarray(jax.random.bernoulli(
            jk, jnp.float32(1.0) / jnp.float32(rate), shape))
        assert np.array_equal(prng.bernoulli(tk, p, shape), want)


def test_torch_bits_split_the_64bit_counter():
    """Counters past 2^32 carry into the high word (a block of more than
    2^32 elements, reached by the offset rather than by memory)."""
    k = prng.fold_in(prng.key(5), 9)
    off = 2 ** 32 - 3
    got = prng.random_bits_torch(k, (2, 4), offset=off).numpy()
    c = np.arange(8, dtype=np.uint64) + np.uint64(off)
    a, b = prng.threefry2x32(k[0], k[1], (c >> np.uint64(32)).astype(
        np.uint32), (c & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(got.reshape(-1).astype(np.uint32), a ^ b)
    assert int((c >> np.uint64(32))[-1]) == 1
    # offset 0 is the stream jax.random.bits draws
    jk = jax.random.fold_in(jax.random.key(5), 9)
    assert np.array_equal(
        prng.random_bits_torch(k, (3, 5)).numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jk, (3, 5), jnp.uint32)))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("unbiased", [False, True])
def test_random_mask_plain_matches_jax_vmapped(rate, unbiased):
    """Per-worker keys ``fold_in(k_call, j)`` over a ``[Q, B, F]`` stack,
    as the dense wire draws them: mask, output and kept counts."""
    x = _x(1, (3, 40, 64))
    k_call = jax.random.fold_in(jax.random.key(7), 2)
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(k_call, jnp.arange(3))
    r = jnp.maximum(jnp.float32(rate), 1.0)
    masks = jax.vmap(lambda k: jax.random.bernoulli(k, 1.0 / r,
                                                    x.shape[1:]))(jkeys)
    scale = np.float32(rate) if unbiased else np.float32(1.0)
    want = np.where(np.asarray(masks), x * scale, 0.0)
    tkeys = np.stack([prng.fold_in(prng.fold_in(prng.key(7), 2), j)
                      for j in range(3)])
    p = float(np.float32(1.0) / np.float32(rate))
    out, counts = random_mask_plain(torch.from_numpy(x),
                                    keys_tensor(tkeys, "cpu"), p,
                                    float(scale), count=True)
    assert np.array_equal(out.numpy(), want)
    assert counts.tolist() == np.asarray(masks).reshape(3, -1).sum(1) \
        .tolist()
    op_out, op_counts = ops.random_mask(torch.from_numpy(x),
                                        keys_tensor(tkeys, "cpu"), p,
                                        float(scale))
    assert torch.equal(op_out, out) and torch.equal(op_counts, counts)


@pytest.mark.parametrize("name", JC.available_compressors())
@pytest.mark.parametrize("rate", RATES)
def test_compressor_matches_jax(name, rate):
    """Output bitwise, wire bits at rel 1e-6 and the gradient of
    ``Σ w · x_tilde`` at 1e-6 against ``jax.grad``."""
    x = _x()
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jk = jax.random.fold_in(jax.random.key(1), 3)
    tk = prng.fold_in(prng.key(1), 3)
    jf, tf = JC.get_compressor(name), TC.get_compressor(name)
    jr = _jrate(name, rate)
    jo, jb = jf(jk, jnp.asarray(x), jr)
    xt = torch.from_numpy(x).requires_grad_(True)
    to, tb = tf(tk, xt, rate)
    assert np.array_equal(to.detach().numpy(), np.asarray(jo))
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-6, atol=0)
    gj = jax.grad(lambda a: jnp.sum(jf(jk, a, jr)[0] * w))(jnp.asarray(x))
    (gt,) = torch.autograd.grad((to * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    for r in (1.0, rate, 2 * rate):
        np.testing.assert_allclose(float(tf.eps2(r)),
                                   float(jf.eps2(jnp.float32(r))),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", JC.available_compressors())
@pytest.mark.parametrize("rate", [2.0, 5.3])
def test_batched_compressor_matches_jax_vmap(name, rate):
    """``Compressor.batched`` (one call for all workers) against the JAX
    package's ``vmap`` of the compressor over per-worker keys."""
    x = _x(3, (4, 24, 256))
    k_call = jax.random.fold_in(jax.random.key(4), 1)
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(k_call, jnp.arange(4))
    jf, tf = JC.get_compressor(name), TC.get_compressor(name)
    jr = _jrate(name, rate)
    jo, jb = jax.vmap(lambda k, blk: jf(k, blk, jr))(jkeys, jnp.asarray(x))
    tkeys = np.stack([prng.fold_in(prng.fold_in(prng.key(4), 1), j)
                      for j in range(4)])
    to, tb = tf.batched(tkeys, torch.from_numpy(x), rate)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    with pytest.raises(ValueError, match="keys"):
        tf.batched(tkeys[:3], torch.from_numpy(x), rate)


@pytest.mark.parametrize("name", ["randmask", "int8"])
def test_straight_through_matches_jax(name):
    x = _x(5)
    jk, tk = jax.random.key(8), prng.key(8)
    jst = JC.straight_through(JC.get_compressor(name))
    tst = TC.straight_through(TC.get_compressor(name))
    jo, _ = jst(jk, jnp.asarray(x), jnp.float32(4.0))
    xt = torch.from_numpy(x).requires_grad_(True)
    to, _ = tst(tk, xt, 4.0)
    assert np.array_equal(to.detach().numpy(), np.asarray(jo))
    (g,) = torch.autograd.grad(to.sum(), xt)
    assert torch.equal(g, torch.ones_like(xt))


def test_registry_and_policy_compressor():
    assert TC.available_compressors() == JC.available_compressors()
    with pytest.raises(KeyError, match="unknown compressor"):
        TC.get_compressor("nope")
    for name in TC.available_compressors():
        pol = CommPolicy.parse("fixed:4", 10, compressor=name)
        assert pol.compressor().name == name
    assert CommPolicy.parse("varco:linear:5", 10).compressor().name == \
        "randmask"
    with pytest.raises(ValueError, match="divisible"):
        TC.get_compressor("blockmask")(prng.key(0), torch.zeros(2, 100), 2.0)

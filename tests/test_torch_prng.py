"""The port's key stream against ``jax.random``, bitwise.

``repro_torch.prng`` reimplements Threefry-2x32 ``key``/``fold_in``/
``split``/``bits``/``permutation`` in numpy; the wire's block masks
(``block_mask_indices_pos``, ``worker_block_maps_pos``) are built on it.
At rate 1 the kept set is ``arange(nb)`` whatever the key, so every ``k``
is swept: a slip in the counter layout shows only below ``nb``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import varco_pack as jvp
from repro_torch import prng
from repro_torch.kernels import varco_pack as tvp

SEEDS = (0, 1, 2, 7, 42, 1234, 99991, 2**31 - 1)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(prng.key(seed), _kd(k))
    for data in (0, 1, 5, 255, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data),
                                      _kd(jax.random.fold_in(k, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(prng.key(seed), num),
                                      _kd(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bitwise(seed):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    for shape in ((1,), (7,), (64,), (3, 5)):
        got = prng.random_bits(_kd(k), shape)
        want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_bitwise(seed):
    k = jax.random.key(seed)
    for n in list(range(1, 9)) + [100, 2000]:
        np.testing.assert_array_equal(
            prng.permutation(_kd(k), n),
            np.asarray(jax.random.permutation(k, n)))


MASK_SEEDS = (0, 3, 17)


@pytest.mark.parametrize("nb", range(1, 9))
def test_block_masks_bitwise_every_k(nb):
    """``block_mask_indices_pos`` and ``worker_block_maps_pos`` for every
    kept count ``k`` and every ``Q`` in 1..6.  Worker ``i`` draws from
    ``fold_in(key, i)`` alone, so JAX's ``Q = 6`` maps hold every smaller
    ``Q``'s as a prefix (pinned for each ``Q`` by the next test)."""
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(s), 1))(
        jnp.asarray(MASK_SEEDS))
    for k in range(1, nb + 1):
        want = jax.vmap(lambda kk: jvp.worker_block_maps_pos(
            kk, 6, nb, k))(keys)
        want = [np.asarray(w_) for w_ in want]
        for si in range(len(MASK_SEEDS)):
            raw = _kd(keys[si])
            for q in range(1, 7):
                got = tvp.worker_block_maps_pos(raw, q, nb, k)
                for g_, w_ in zip(got, want):
                    assert g_.dtype == np.int32
                    np.testing.assert_array_equal(g_, w_[si, :q])
            for i in range(6):
                got = tvp.block_mask_indices_pos(prng.fold_in(raw, i), nb, k)
                for g_, w_ in zip(got, want):
                    np.testing.assert_array_equal(g_, w_[si, i])
                kept, inv = tvp.block_mask_indices_k(prng.fold_in(raw, i),
                                                     nb, k)
                np.testing.assert_array_equal(kept, want[0][si, i])
                np.testing.assert_array_equal(inv, want[1][si, i])


@pytest.mark.parametrize("q", range(1, 7))
def test_worker_block_maps_pos_bitwise(q):
    key = jax.random.fold_in(jax.random.key(q), 2)
    for nb, k in ((4, 2),):
        got = tvp.worker_block_maps_pos(_kd(key), q, nb, k)
        want = jvp.worker_block_maps_pos(key, q, nb, k)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, np.asarray(w_))

"""The port's compressed gradient collectives and the bf16 random mask
against the live JAX package, on the CPU.

* ``_random_mask`` on a bf16 leaf (biased and unbiased, rates 1, 4 and
  5.3) bitwise, in-process: the output keeps bf16 and charges 16 bits a
  kept element;
* ``uncompressed_bits`` of a mixed-dtype tree exactly;
* ``compressed_psum`` / ``compressed_pmean`` / ``compressed_all_to_all``
  over Q = 4 emulated workers against the JAX functions under
  ``shard_map`` on 4 virtual CPU devices, in one subprocess (the main
  test process keeps its one device): every contribution is
  digit-coded (worker ``w`` sends ``d · 8^w`` with a digit ``d`` in
  1..7 in f32, ``±2^w`` in bf16), so each sum is exact in any order and
  names the workers that kept each element — equal sums are equal masks,
  bit for bit.  Rate 1 (nothing dropped), rate 4 biased and unbiased;
  bits exactly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as JCOL
from repro.core import compression as JC
from repro_torch import prng
from repro_torch.core import collectives as TCOL
from repro_torch.core import compression as TC

ROOT = Path(__file__).resolve().parents[1]


def _bf16_pair(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).normal(size=shape),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))
                               .copy()).to(torch.bfloat16)


@pytest.mark.parametrize("rate", [1.0, 4.0, 5.3])
@pytest.mark.parametrize("unbiased", [False, True])
def test_random_mask_bf16_matches_jax_bitwise(rate, unbiased):
    xj, xt = _bf16_pair((37, 129), 1)
    k = prng.fold_in(prng.key(3), int(rate * 10))
    oj, bj = JC._random_mask(jax.random.wrap_key_data(jnp.asarray(k)), xj,
                             jnp.float32(rate), unbiased)
    ot, bt = TC.random_mask_compressor(unbiased)(k, xt, rate)
    assert ot.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ot.view(torch.int16).numpy().view(np.uint16),
        np.asarray(oj).view(np.uint16))
    assert float(bt) == float(bj)
    kept = int((ot != 0).sum())
    assert float(bt) == 16.0 * kept


def test_uncompressed_bits_matches_jax():
    shapes = {"a": ((3, 5), np.float32), "b": ((7,), jnp.bfloat16),
              "c": {"d": ((2, 2, 2), np.int32), "e": ((1000, 999),
                                                      np.float32)}}

    def build(spec, fw):
        if isinstance(spec, dict):
            return {k: build(v, fw) for k, v in spec.items()}
        shape, dt = spec
        if fw == "jax":
            return jnp.zeros(shape, dt)
        tdt = {np.float32: torch.float32, np.int32: torch.int32,
               jnp.bfloat16: torch.bfloat16}[dt]
        return torch.zeros(shape, dtype=tdt)

    want = JCOL.uncompressed_bits(build(shapes, "jax"))
    got = TCOL.uncompressed_bits(build(shapes, "torch"))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_per_worker_keys_match_jax():
    key = prng.key(7)
    for w in range(4):
        want = jax.random.key_data(jax.random.fold_in(jax.random.key(7), w))
        np.testing.assert_array_equal(TCOL._per_device_key(key, w),
                                      np.asarray(want))


SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
import torch
from repro.core import collectives as JCOL
from repro.core.compression import get_compressor as jcomp
from repro_torch import prng
from repro_torch.core import collectives as TCOL
from repro_torch.core.compression import get_compressor as tcomp

Q = 4
mesh = Mesh(np.asarray(jax.devices()[:Q]), ("d",))
rng = np.random.default_rng(0)
scale = np.float32(8.0) ** np.arange(Q, dtype=np.float32)


def coded(shape):
    d = rng.integers(1, 8, (Q,) + shape).astype(np.float32)
    return d * scale.reshape((Q,) + (1,) * len(shape))


def signed_pow2(shape):
    s = rng.choice([-1.0, 1.0], (Q,) + shape).astype(np.float32)
    p = (2.0 ** np.arange(Q)).astype(np.float32)
    return s * p.reshape((Q,) + (1,) * len(shape))


tree = {"w": coded((6, 40)), "b": {"c": coded((33,))},
        "h": signed_pow2((5, 16))}
dtypes = {"w": jnp.float32, "c": jnp.float32, "h": jnp.bfloat16}


def jtree():
    return {"w": jnp.asarray(tree["w"]),
            "b": {"c": jnp.asarray(tree["b"]["c"])},
            "h": jnp.asarray(tree["h"], jnp.bfloat16)}


def ttree(w):
    return {"w": torch.from_numpy(tree["w"][w].copy()),
            "b": {"c": torch.from_numpy(tree["b"]["c"][w].copy())},
            "h": torch.from_numpy(tree["h"][w].copy()).to(torch.bfloat16)}


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def leaves(t):
    return [t["b"]["c"], t["h"], t["w"]]


key_j, key_t = jax.random.key(7), prng.key(7)
for name, rate in json.loads(sys.argv[1]):
    comp_j, comp_t = jcomp(name), tcomp(name)
    for fn_j, fn_t in ((JCOL.compressed_psum, TCOL.compressed_psum),
                       (JCOL.compressed_pmean, TCOL.compressed_pmean)):
        def worker(x, r, k):
            x = jax.tree_util.tree_map(lambda a: a[0], x)
            return fn_j(x, "d", compressor=comp_j, rate=r, key=k)
        sm = shard_map(worker, mesh=mesh, in_specs=(P("d"), P(), P()),
                       out_specs=(P(), P()), check_rep=False)
        out_j, bits_j = jax.jit(sm)(jtree(), jnp.float32(rate), key_j)
        out_t, bits_t = fn_t((ttree(w) for w in range(Q)), Q,
                             compressor=comp_t, rate=rate, key=key_t)
        for a, b in zip(leaves(out_j), leaves(out_t)):
            assert str(b.dtype).endswith(str(a.dtype)), (a.dtype, b.dtype)
            assert (f32(a) == f32(b)).all(), (name, rate, fn_t.__name__)
        assert float(bits_j) == float(bits_t), (float(bits_j),
                                               float(bits_t))
        kept = sum(int((f32(x) != 0).sum()) for x in leaves(out_t))
        if rate == 1.0:
            assert kept == sum(x[0].size for x in leaves(tree))
        else:
            assert 0 < kept < sum(x[0].size for x in leaves(tree))
    # all-to-all: worker w's local [Q, 3, 40] (split axis 0) and [3, Q,
    # 40] (split and concat axis 1), any values: no sums
    for split, shape in ((0, (Q, Q, 3, 40)), (1, (Q, 3, Q, 40))):
        x = rng.normal(size=shape).astype(np.float32)

        def a2a(v, r, k):
            out, bits = JCOL.compressed_all_to_all(
                v[0], "d", compressor=comp_j, rate=r, key=k,
                split_axis=split, concat_axis=split)
            return out[None], bits
        sm = shard_map(a2a, mesh=mesh, in_specs=(P("d"), P(), P()),
                       out_specs=(P("d"), P()), check_rep=False)
        out_j, bits_j = jax.jit(sm)(jnp.asarray(x), jnp.float32(rate),
                                    key_j)
        out_t, bits_t = TCOL.compressed_all_to_all(
            torch.from_numpy(x), compressor=comp_t, rate=rate, key=key_t,
            split_axis=split, concat_axis=split)
        assert out_t.shape == out_j.shape
        assert (np.asarray(out_j) == out_t.numpy()).all(), (name, split)
        assert float(bits_j) == float(bits_t)
    print(name, rate, "OK")
print("COLLECTIVES_OK")
"""


def test_collectives_match_shard_map_on_4_devices():
    cases = [("randmask", 1.0), ("randmask", 4.0),
             ("randmask_unbiased", 4.0)]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(cases)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "COLLECTIVES_OK" in out.stdout, out.stdout


def test_collectives_refuse_bad_worker_counts():
    comp = TC.get_compressor("randmask")
    with pytest.raises(ValueError, match="3 worker trees for q=4"):
        TCOL.compressed_psum([{"a": torch.ones(3)}] * 3, 4,
                             compressor=comp, rate=2.0, key=prng.key(0))
    with pytest.raises(ValueError, match="split axis"):
        TCOL.compressed_all_to_all(torch.ones(4, 3, 5), compressor=comp,
                                   rate=2.0, key=prng.key(0))

"""The port's ``launch/shapes.py`` and ``launch/analytic.py`` against the
JAX package's, exactly, on the CPU: the four assigned shapes,
``long_context_variant``, the model-input specs (meta tensors against
``ShapeDtypeStruct``s; the concrete ``default_rng(0)`` arrays bit for
bit), the decode cache's leaf shapes and dtypes, and ``estimate``'s
``CostEstimate`` field for field for every config (full and smoke) ×
shape × chip count × moment width."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget
from repro.launch import analytic as JA
from repro.launch import shapes as JS
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import analytic as TA
from repro_torch.launch import shapes as TS


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shapes_match_jax():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, js in JS.SHAPES.items():
        assert dataclasses.asdict(TS.SHAPES[name]) == dataclasses.asdict(js)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_and_specs_match_jax(arch):
    for smoke in (False, True):
        jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert TS.long_context_variant(tc).sliding_window == \
            JS.long_context_variant(jc).sliding_window
        assert TS.long_context_variant(tc, 4096).sliding_window == \
            JS.long_context_variant(jc, 4096).sliding_window
        for name, js in JS.SHAPES.items():
            ts = TS.SHAPES[name]
            for n_chips in (1, 4, 256):
                for mb in (None, 4):
                    want = JA.estimate(jc, js, n_chips, mb)
                    got = TA.estimate(tc, ts, n_chips, mb)
                    assert type(got).__name__ == "CostEstimate"
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (name, n_chips, mb)
            for kw in ({}, {"batch": 2, "seq": 16}):
                sj, st = JS.batch_specs(jc, js, **kw), \
                    TS.batch_specs(tc, ts, **kw)
                assert sorted(st) == sorted(sj)
                for k, spec in sj.items():
                    assert st[k].device.type == "meta"
                    assert tuple(st[k].shape) == tuple(spec.shape), k
                    assert _dtype_name(st[k].dtype) == str(spec.dtype), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_concrete_batches_and_caches_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    for name in ("prefill_32k", "decode_32k"):
        cj = JS.batch_specs(jc, JS.SHAPES[name], concrete=True, batch=2,
                            seq=8)
        ct = TS.batch_specs(tc, TS.SHAPES[name], concrete=True, batch=2,
                            seq=8, device="cpu")
        for k, a in cj.items():
            assert _dtype_name(ct[k].dtype) == str(a.dtype), k
            np.testing.assert_array_equal(
                ct[k].float().numpy(), np.asarray(a.astype(jnp.float32)))
    sj = JS.cache_specs(jc, JS.SHAPES["decode_32k"], batch=2, cache_len=64)
    st = TS.cache_specs(tc, TS.SHAPES["decode_32k"], batch=2, cache_len=64)
    jleaves = jax.tree_util.tree_leaves(sj.layers)
    tleaves = [t for layer in st.layers for t in layer]
    assert len(tleaves) == len(jleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.device.type == "meta"
        assert tuple(b.shape) == tuple(a.shape)
        assert _dtype_name(b.dtype) == str(a.dtype)
    assert st.index == 0 and sj.index.shape == ()
    concrete = TS.cache_specs(tc.with_(n_layers=tc.pattern_period),
                              TS.SHAPES["decode_32k"], concrete=True,
                              batch=1, cache_len=8, device="cpu")
    assert all(t.device.type == "cpu" for layer in concrete.layers
               for t in layer)


def test_batch_specs_default_to_the_card_when_concrete():
    import inspect
    for fn in (TS.batch_specs, TS.cache_specs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        cfg = tget("granite-3-2b", smoke=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.batch_specs(cfg, TS.SHAPES["train_4k"], concrete=True,
                           batch=1, seq=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.cache_specs(tget("granite-3-2b", smoke=True),
                           TS.SHAPES["decode_32k"], concrete=True, batch=1,
                           cache_len=8)

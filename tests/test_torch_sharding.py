"""The port's sharding rules (``repro_torch.dist.sharding``) against the
JAX package's (``repro.dist.sharding``), and the MoE dispatch at two
groups.

* ``param_spec`` of every parameter and AdamW-state leaf of every
  architecture's full config, on the 16 × 16, 2 × 16 × 16 and 2 × 4
  meshes: the port's tree (``init_lm`` under ``FakeTensorMode``) has the
  JAX tree's paths and shapes (``jax.eval_shape``, no weights), and every
  leaf's spec is JAX's.  Both sides take an abstract mesh (axis names and
  sizes only).
* ``cache_spec`` of every cache leaf of every architecture and ``SHAPES``
  entry under the dry run's rank rule, and ``batch_spec``, as JAX's.
* ``worker_graph_shardings`` refuses what JAX's refuses.
* On a fake group of 8 (one subprocess, with 8 virtual JAX devices):
  every rank's local shape and global offset of a few leaves, from the
  port's DTensor placements on ``make_small_mesh(2, 4)`` and on a 2 × 2 ×
  2 ``(pod, data, model)`` mesh, equal JAX's
  ``NamedSharding.devices_indices_map`` on the same meshes; and
  ``maybe_shard`` redistributes a DTensor inside ``activation_sharding``
  and is the identity outside it.
* ``moe_ffn`` inside ``activation_sharding`` of a 2 × 4 mesh (so
  ``dispatch_groups() == 2``) against JAX's ``moe_ffn`` with
  ``repro.models.moe.dispatch_groups`` set to return 2 (no JAX mesh is
  active, so JAX's ``maybe_shard`` is the identity), within 1e-5.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import ARCH_IDS, get_config as jget
from repro.dist import sharding as JS
from repro.launch.steps import make_optimizer as jopt
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tget
from repro_torch.dist import sharding as TS
from repro_torch.launch.dryrun import batch_rule, cache_rule
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import make_optimizer as topt
from repro_torch.models import lm_params_from_jax
from repro_torch.models import moe as TM
from repro_torch.models.transformer import init_cache, init_lm

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "small2x4": ((2, 4), ("data", "model"))}


def _jmesh(name):
    from jax.sharding import AbstractMesh
    shape, names = MESHES[name]
    return AbstractMesh(shape, names)


def _tmesh(name):
    return TS.AbstractMesh(*MESHES[name])


def _norm(spec) -> tuple:
    """A JAX ``PartitionSpec`` as the port's spec tuple."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf
    return out


@pytest.fixture(scope="module", params=ARCH_IDS)
def trees(request):
    arch = request.param
    jc, tc = jget(arch), tget(arch)
    jp = jax.eval_shape(lambda: JT.init_lm(jax.random.key(0), jc))
    jo = jax.eval_shape(jopt(jc).init, jp)
    with FakeTensorMode():
        tp = init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
        to = topt(tc).init(tp)
    return arch, jp, jo, tp, to


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_jax(trees, mesh):
    arch, jp, jo, tp, to = trees
    jm, tm = _jmesh(mesh), _tmesh(mesh)
    for jtree, ttree in ((jp, tp), (jo, to)):
        jpaths = _jax_paths(jtree)
        jspecs = _jax_paths(JS.param_shardings(jtree, jm))
        tpaths = dict(TS.tree_paths(ttree))
        assert sorted(jpaths) == sorted(tpaths), arch
        tspecs = dict(zip([p for p, _ in TS.tree_paths(ttree)],
                          _spec_leaves(TS.param_shardings(ttree, tm))))
        for path, leaf in jpaths.items():
            assert tuple(tpaths[path].shape) == tuple(leaf.shape), path
            want = _norm(jspecs[path].spec)
            assert tspecs[path] == want, (arch, mesh, path)
            assert TS.param_spec(path, leaf.shape, tm) == want


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def _jax_cache_rule(shape, mesh):
    """``repro/launch/dryrun.py``'s ``shard_cache_tree`` leaf rule."""
    if len(shape) >= 4:
        return JS.cache_spec(shape, mesh, batch_dim=1,
                             seq_dim=2 if len(shape) == 5 else None,
                             head_dim=3 if len(shape) == 5 else None)
    if len(shape) == 3:
        return JS.cache_spec(shape, mesh, batch_dim=1, seq_dim=2)
    if len(shape) == 0:
        return JS.P()
    return JS.cache_spec(shape, mesh, batch_dim=1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_jax(arch):
    tc = tget(arch)
    for mesh in MESHES:
        jm, tm = _jmesh(mesh), _tmesh(mesh)
        assert TS.batch_spec(tm) == _norm(JS.batch_spec(jm))
        assert TS.data_axes(tm) == JS.data_axes(jm)
        for shape in SHAPES.values():
            cache = init_cache(tc, shape.global_batch, shape.seq_len,
                               device="meta")
            for layer in cache.layers:
                for t in layer:
                    s = tuple(t.shape)
                    want = _norm(_jax_cache_rule(s, jm))
                    assert cache_rule(s, tm) == want, (arch, mesh, s)
                    for dims in ((0, 1, 2), (1, 2, None), (0, None, 1)):
                        if max(d for d in dims if d is not None) < len(s):
                            kw = dict(zip(("batch_dim", "seq_dim",
                                           "head_dim"), dims))
                            assert TS.cache_spec(s, tm, **kw) == \
                                _norm(JS.cache_spec(s, jm, **kw))
            # the batch leaves: the batch dim over the data axes
            with TS.activation_sharding(tm):
                groups = TS.dispatch_groups()
            if shape.global_batch % groups == 0:
                assert batch_rule((shape.global_batch, 8), tm) == \
                    _norm(JS.batch_spec(jm)) + (None,)


def test_batch_rule_falls_back_to_the_sequence():
    """``repro/launch/dryrun.py:70-84``: the batch dim (dim 1 of M-RoPE
    ids) over the data axes, else the next dim, else replicated."""
    tm = _tmesh("pod16x16")
    assert batch_rule((1, 524288), tm) == (None, ("data",))
    assert batch_rule((3, 256, 4096), tm) == (None, ("data",), None)
    assert batch_rule((3, 1, 4096), tm) == (None, None, ("data",))
    assert batch_rule((3, 5), tm) == (None, None)


def test_worker_graph_shardings_refuse_as_jax():
    from jax.sharding import AbstractMesh
    jm = AbstractMesh((4,), ("workers",))
    tm = TS.AbstractMesh((4,), ("workers",))
    good = {"x": np.zeros((4, 3)), "y": np.zeros((4,))}
    assert TS.worker_graph_shardings(good, tm) == {"x": (("workers",),),
                                                   "y": (("workers",),)}
    assert {k: _norm(v.spec) for k, v in
            JS.worker_graph_shardings(good, jm).items()} == \
        TS.worker_graph_shardings(good, tm)
    for bad in ({"x": np.zeros((3, 4))}, {"s": np.float32(1.0)},
                {"x": np.zeros((4, 3)), "h": np.zeros((2, 4))}):
        with pytest.raises(ValueError) as te:
            TS.worker_graph_shardings(bad, tm)
        with pytest.raises(ValueError) as je:
            JS.worker_graph_shardings(bad, jm)
        key = str(je.value).split("'")[1]
        assert f"'{key}'" in str(te.value)


def test_maybe_shard_is_the_identity_off_the_mesh():
    x = torch.randn(4, 8)
    assert TS.maybe_shard(x, "data", "model") is x
    with TS.activation_sharding(_tmesh("small2x4")):
        assert TS.maybe_shard(x, "data", "model") is x    # plain tensor
        assert TS.dispatch_groups() == 2
    with TS.activation_sharding(_tmesh("pod2x16x16")):
        assert TS.dispatch_groups() == 32
    assert TS.dispatch_groups() == 1


def test_moe_at_two_groups_matches_jax(monkeypatch):
    """qwen2-moe's smoke config at capacity factor 0.5 (overflow forced)
    with JAX's weights: the port's own ``dispatch_groups()`` inside a 2 ×
    4 mesh's context against JAX's set to 2 by monkeypatching (JAX's
    ``maybe_shard`` stays the identity)."""
    jc, tc = (get("qwen2-moe-a2.7b", smoke=True) for get in (jget, tget))
    jc = jc.with_(moe=dataclasses.replace(jc.moe, capacity_factor=0.5))
    tc = tc.with_(moe=dataclasses.replace(tc.moe, capacity_factor=0.5))
    jp = JM.init_moe(jax.random.key(10), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(11).normal(size=(4, 12, jc.d_model)) \
        .astype(np.float32)
    monkeypatch.setattr(JM, "dispatch_groups", lambda: 2)
    jout, jaux = JM.moe_ffn(jp, jc, jax.numpy.asarray(x))
    with TS.activation_sharding(_tmesh("small2x4")):
        assert TM.dispatch_groups() == 2
        tout, taux = TM.moe_ffn(tp, tc, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # outside the context one group: capacity binds otherwise
    one, _ = TM.moe_ffn(tp, tc, torch.from_numpy(x))
    assert not torch.allclose(one, tout, rtol=1e-5, atol=1e-5)


SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import torch
from repro.dist import sharding as JS
from repro_torch.dist import sharding as TS
from repro_torch.launch.dryrun import fake_process_group
from repro_torch.launch.mesh import make_small_mesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Replicate, Shard

LEAVES = [("blocks/p0_attn/attn/wq", (40, 2048, 32, 64)),
          ("blocks/p0_attn/attn/wo", (40, 32, 64, 2048)),
          ("blocks/p0_attn/mlp/w_down", (40, 8192, 2048)),
          ("blocks/p0_attn/moe/w_gate", (24, 64, 2048, 1408)),
          ("embed", (49155 - 3, 2048)),
          ("blocks/p0_attn/attn/wk", (40, 2048, 8, 64))]
CACHE = [(40, 16, 4096, 8, 64), (40, 1, 8192, 8, 64), (40, 16, 4096)]

def norm(spec):
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)

def check(jmesh, tmesh):
    n = 0
    cases = [(TS.param_spec(p, s, tmesh), JS.param_spec(p, s, jmesh), s)
             for p, s in LEAVES]
    cases += [(TS.cache_spec(s, tmesh, batch_dim=1, seq_dim=2,
                             head_dim=3 if len(s) == 5 else None),
               JS.cache_spec(s, jmesh, batch_dim=1, seq_dim=2,
                             head_dim=3 if len(s) == 5 else None), s)
              for s in CACHE]
    cases.append((TS.batch_spec(tmesh) + (None,),
                  P(*JS.batch_spec(jmesh), None), (64, 128)))
    for tspec, jspec, shape in cases:
        assert tspec == norm(jspec), (tspec, jspec)
        idx = NamedSharding(jmesh, jspec).devices_indices_map(shape)
        for coord in np.ndindex(*jmesh.devices.shape):
            sl = idx[jmesh.devices[coord]]
            want_off = tuple(s.start or 0 for s in sl)
            want_shape = tuple((s.stop if s.stop is not None else d)
                               - (s.start or 0) for s, d in zip(sl, shape))
            got = TS.local_shape_and_offset(shape, tspec, tmesh, coord)
            assert got == (want_shape, want_off), (shape, tspec, coord,
                                                    got, want_shape,
                                                    want_off)
            n += 1
    return n

devs = np.asarray(jax.devices()[:8])
with fake_process_group(8):
    small = make_small_mesh(2, 4, device_type="cpu")
    n = check(Mesh(devs.reshape(2, 4), ("data", "model")), small)
    pods = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    n += check(Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model")), pods)
    # maybe_shard redistributes a DTensor only inside the context
    x = distribute_tensor(torch.zeros(8, 16, 32, device="meta"), small,
                          [Replicate(), Replicate()])
    assert TS.maybe_shard(x, "data", "model", None) is x
    with TS.activation_sharding(small):
        y = TS.maybe_shard(x, ("pod", "data"), "model", None)
        assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
        z = TS.maybe_shard(y, None, None, "model")     # 32 % 4 == 0
        assert tuple(z.placements) == (Replicate(), Shard(2))
        w = TS.maybe_shard(y, "data", ("model",), None)  # no reshard
        assert tuple(w.placements) == (Shard(0), Shard(1))
        u = TS.unflatten(z, 2, (2, 16))                   # 2 % 4: gathered
        assert tuple(u.shape) == (8, 16, 2, 16)
        assert tuple(u.placements) == (Replicate(), Replicate())
print("LOCAL_SHARDS_OK", n)
"""


def test_local_shards_match_jax_device_indices():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr[-4000:]}"
    assert "LOCAL_SHARDS_OK" in out.stdout
    assert int(out.stdout.split("LOCAL_SHARDS_OK")[1]) == 2 * 10 * 8

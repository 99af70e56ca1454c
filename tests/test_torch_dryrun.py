"""The port's dry run (``repro_torch.launch.dryrun``) and collective
counter (``repro_torch.launch.comm_analysis``), in one subprocess that
holds a fake process group of 8 (a fake group left in a pytest worker
would break later tests that start a group) and, for the JAX side, no
devices beyond the CPU (the specs come from an ``AbstractMesh``).

* granite-3-2b's smoke config traces its train step (S = 256), prefill
  and decode on a fake 2 × 4 mesh: every record's FLOPs, collectives and
  peak are positive;
* the train record's ``memory.argument_bytes`` equals the bytes of rank
  0's shards computed from JAX's ``param_shardings`` specs of the same
  parameter and AdamW-state trees and the dry run's batch rule; and so
  does full-size granite-3-2b ``train_4k``'s on the 16 × 16 mesh (the
  arguments placed on 256 fake ranks, not traced);
* the collective counter charges hand-built DTensor collectives
  (all-gather, all-reduce, reduce-scatter; and an all-to-all of the
  functional collectives) the ring-model bytes, and those equal
  ``repro.launch.hlo_analysis.collective_bytes`` on HLO text of the same
  shapes and groups (written as ``tests/test_hlo_analysis.py`` writes
  it);
* qwen2-moe-a2.7b's smoke config (the MoE dispatch with expert
  parallelism) traces its train step, prefill and decode on the same
  mesh, its train record's ``argument_bytes`` equal to JAX's specs' sum;
  qwen2-vl-2b's smoke prefill with ``positions3`` (the position mask
  from positions a mesh holds) and a batch-1 decode with vocab-sharded
  logits (the greedy token over a gathered vocab, one replicated MoE
  group) trace too;
* a combination that raises (here a ``record`` made to raise) is
  recorded with ``ok: false``, its error and its traceback, as the JAX
  package's ``run_one`` records it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax
import torch
import torch.distributed._functional_collectives as funcol
from jax.sharding import AbstractMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import distribute_tensor

from repro.configs.base import get_config as jget
from repro.dist import sharding as JS
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.steps import make_optimizer as jopt
from repro.models import transformer as JT
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.comm_analysis import CollectiveCounter
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.launch.shapes import SHAPES, InputShape

out_dir = sys.argv[1]


def jax_arg_bytes(arch, smoke, mesh, batch_shape):
    # rank 0's shard bytes of params + AdamW state + tokens, from JAX's
    # specs: a sharded dim holds dim / (product of its axes' sizes)
    cfg = jget(arch, smoke=smoke)
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    params = jax.eval_shape(lambda: JT.init_lm(jax.random.key(0), cfg))
    state = jax.eval_shape(jopt(cfg).init, params)
    total = 0
    for tree in (params, state):
        leaves = jax.tree_util.tree_leaves(tree)
        specs = jax.tree_util.tree_leaves(
            JS.param_shardings(tree, mesh),
            is_leaf=lambda x: hasattr(x, "spec"))
        for leaf, sh in zip(leaves, specs):
            n = 1
            for d, entry in zip(leaf.shape, tuple(sh.spec) +
                                (None,) * len(leaf.shape)):
                axes = () if entry is None else \
                    (entry,) if isinstance(entry, str) else entry
                k = int(np.prod([sizes[a] for a in axes])) if axes else 1
                n *= d // k
            total += n * leaf.dtype.itemsize
    b, s = batch_shape
    k = int(np.prod([sizes[a] for a in JS.data_axes(mesh)]))
    return total + (b // k if b % k == 0 else b) * s * 4


KINDS = (InputShape("train_s", 256, 8, "train"),
         InputShape("prefill_s", 256, 8, "prefill"),
         InputShape("decode_s", 256, 8, "decode"))
recs, more = {}, {}
cfg = get_config("granite-3-2b", smoke=True)
moe_cfg = get_config("qwen2-moe-a2.7b", smoke=True)
with D.fake_process_group(8):
    mesh = make_small_mesh(device_type="cpu")
    small = AbstractMesh((2, 4), ("data", "model"))
    for shape in KINDS:
        recs[shape.kind] = D.record(cfg, shape, mesh, 8)
        more["moe_" + shape.kind] = D.record(moe_cfg, dataclasses.replace(
            shape, seq_len=64), mesh, 8)
    want = jax_arg_bytes("granite-3-2b", True, small, (8, 256))
    assert recs["train"]["memory"]["argument_bytes"] == want, (
        recs["train"]["memory"], want)
    want = jax_arg_bytes("qwen2-moe-a2.7b", True, small, (8, 64))
    assert more["moe_train"]["memory"]["argument_bytes"] == want, (
        more["moe_train"]["memory"], want)
    more["vl_prefill"] = D.record(get_config("qwen2-vl-2b", smoke=True),
                                  InputShape("prefill_s", 256, 8,
                                             "prefill"), mesh, 8)
    more["moe_decode_b1"] = D.record(moe_cfg, InputShape(
        "long_s", 1024, 1, "decode"), mesh, 8)

    # hand-built collectives on the 2 x 4 mesh: data groups {0,4},...
    # model groups {0,1,2,3},...
    x = distribute_tensor(torch.empty(16, 64, device="meta"), mesh,
                          [Shard(0), Replicate()])
    p = DTensor.from_local(torch.empty(16, 64, device="meta",
                                       dtype=torch.bfloat16), mesh,
                           [Replicate(), Partial()], run_check=False)
    with CollectiveCounter() as comm:
        x.redistribute(mesh, [Replicate(), Replicate()])   # all-gather
        p.redistribute(mesh, [Replicate(), Replicate()])   # all-reduce
        p.redistribute(mesh, [Replicate(), Shard(0)])      # reduce-scatter
        funcol.all_to_all_single(torch.empty(16, 64, device="meta"),
                                 None, None, (mesh, 1))
    got = comm.summary()
hlo = '''
HloModule jit_step

ENTRY %main (a: f32[8,64]) -> f32[16,64] {
  %a = f32[8,64]{1,0} parameter(0)
  %ag = f32[16,64]{1,0} all-gather(%a), replica_groups={{0,4},{1,5},{2,6},{3,7}}, dimensions={0}
  %ar = bf16[16,64]{1,0} all-reduce(%b), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %rs = bf16[4,64]{1,0} reduce-scatter(%b), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}, to_apply=%add
  %aa = f32[16,64]{1,0} all-to-all(%c), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  ROOT %out = f32[16,64]{1,0} copy(%ag)
}
'''
want = collective_bytes(hlo)
assert got["ops"] == want["ops"] == 4, (got, want)
assert got["per_kind"] == want["per_kind"], (got, want)
assert got["per_dtype"] == want["per_dtype"], (got, want)
assert got["bytes"] == want["bytes"] == 2048 + 3072 + 1536 + 3072, got

# full-size granite train_4k on 256 fake ranks: the arguments only
with D.fake_process_group(256):
    from repro_torch.launch.mesh import make_production_mesh
    big = make_production_mesh(device_type="cpu")
    _, args, _ = D.build_dryrun(get_config("granite-3-2b"),
                                SHAPES["train_4k"], big)
    full = sum(t.numel() * t.element_size() for t in D._leaves(args))
want_full = jax_arg_bytes("granite-3-2b", False, AbstractMesh(
    (16, 16), ("data", "model")), (256, 4096))
assert full == want_full, (full, want_full)

def broken(*args):
    raise RuntimeError("no sharding rule for this op")


D.record = broken
bad = D.run_one("granite-3-2b", "train_4k", False, out_dir)
print("DRYRUN_OK")
print(json.dumps({k: {"memory": r["memory"], "flops": r["cost"]["flops"],
                      "coll": r["collectives"]["bytes"],
                      "peak": r["memory"]["peak_bytes"]}
                  for k, r in {**recs, **more}.items()}))
print(json.dumps({"full_train_4k_argument_bytes": full,
                  "bad_ok": bad["ok"], "bad_error": bad.get("error")}))
"""


def test_dryrun_on_a_fake_mesh(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr[-4000:]}"
    recs, rest = (json.loads(line) for line in
                  out.stdout.split("DRYRUN_OK", 1)[1].strip().splitlines()[:2])
    assert sorted(recs) == ["decode", "moe_decode", "moe_decode_b1",
                            "moe_prefill", "moe_train", "prefill", "train",
                            "vl_prefill"]
    for kind, r in recs.items():
        assert r["flops"] > 0 and r["coll"] > 0, (kind, r)
        assert r["peak"] >= r["memory"]["argument_bytes"] > 0, (kind, r)
    assert rest["full_train_4k_argument_bytes"] > 1e9
    assert rest["bad_ok"] is False and "no sharding rule" in rest["bad_error"]
    saved = json.loads((tmp_path / "granite-3-2b__train_4k__pod16x16"
                        ".json").read_text())
    assert saved["ok"] is False and saved["mesh"] == "pod16x16"
    assert "no sharding rule" in saved["error"]
    assert "broken" in saved["traceback"]

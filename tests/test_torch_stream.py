"""The port's out-of-core pipeline (``repro_torch.graph.stream``, the
streaming generators of ``repro_torch.graph.synthetic`` and
``HaloSpec.to_dict``) against the live JAX package on the CPU.

Everything here is numpy on both sides, so every comparison is exact:
the on-disk files (``store.json``, ``edges_*``/``nodes_*``/``part_*.npz``,
``shards.json``, ``owner.npy``) equal the JAX package's key by key and
byte for byte in their ``np.load`` contents, owner vectors equal the JAX
partitioner's on the exact and on the multilevel path, and a shard set
written by either package loads in the other with ``device_arrays``
bitwise equal to the in-memory ``device_arrays`` + ``attach_p2p``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.dist.halo import build_halo_spec as j_build_halo_spec
from repro.graph import stream as js
from repro.graph import synthetic as jsyn
from repro.graph.partition import partition_graph as j_partition
from repro_torch.dist.halo import HaloSpec, attach_p2p, build_halo_spec
from repro_torch.graph import data as tdata
from repro_torch.graph import stream as ts
from repro_torch.graph import synthetic as tsyn
from repro_torch.graph.partition import partition_graph

N, F, Q = 256, 128, 4


def _npz_equal(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files), (a, b)
        for k in za.files:
            x, y = za[k], zb[k]
            assert x.dtype == y.dtype and x.shape == y.shape, (a, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{a}:{k}")


def _dirs_equal(a: str, b: str, manifest: str) -> None:
    """Every file of two store/shard directories equal: the JSON manifest
    as data, ``.npz``/``.npy`` by their loaded contents."""
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb
    with open(os.path.join(a, manifest)) as ha, \
            open(os.path.join(b, manifest)) as hb:
        ma, mb = json.load(ha), json.load(hb)
    ma.pop("path", None), mb.pop("path", None)
    assert ma == mb
    for name in fa:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            _npz_equal(pa, pb)
        elif name.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _graphs_equal(a, b) -> None:
    for k in ("indptr", "indices", "features", "labels", "train_mask",
              "val_mask", "test_mask"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.name == b.name


@pytest.fixture(scope="module")
def graphs():
    return tsyn.tiny_graph(n=N, feat_dim=F), jsyn.tiny_graph(n=N, feat_dim=F)


@pytest.mark.parametrize("chunks", [(64, 1 << 20), (50, 300)])
def test_store_files_match_jax(graphs, chunks, tmp_path):
    g, gj = graphs
    cn, ce = chunks
    st = ts.write_graph_store(g, tmp_path / "t", chunk_nodes=cn,
                              chunk_edges=ce)
    sj = js.write_graph_store(gj, tmp_path / "j", chunk_nodes=cn,
                              chunk_edges=ce)
    assert st.edge_rows == [tuple(r) for r in sj.edge_rows]
    _dirs_equal(str(tmp_path / "t"), str(tmp_path / "j"), "store.json")
    # each package reads the other's store back to the source graph
    _graphs_equal(ts.load_graph_store(ts.open_store(tmp_path / "j")), g)
    _graphs_equal(js.load_graph_store(js.open_store(tmp_path / "t")), gj)
    np.testing.assert_array_equal(st.degrees(), g.degrees())
    assert ts.is_store(tmp_path / "t") and not ts.is_store(tmp_path)


def test_edge_spill_canonicalises_like_from_edge_list(tmp_path):
    rng = np.random.default_rng(3)
    n = 300
    a, b = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    dst, src = np.concatenate([a, b, a[:50]]), np.concatenate([b, a, a[:50]])
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    ref = tdata.from_edge_list(n, dst, src, feats, labels)

    def emit(spill):
        for lo in range(0, len(dst), 700):         # arbitrary batches
            spill.add(dst[lo:lo + 700], src[lo:lo + 700])

    st = ts.spill_to_store(n, emit, tmp_path / "t", name="s",
                           chunk_nodes=64, chunk_edges=500, bucket_nodes=40)
    sj = js.spill_to_store(n, emit, tmp_path / "j", name="s",
                           chunk_nodes=64, chunk_edges=500, bucket_nodes=40)
    indptr = np.zeros(n + 1, np.int64)
    idx, base = [], 0
    for lo, hi, iptr, ind, wgt in st.edge_chunks():
        assert wgt is None
        indptr[lo + 1:hi + 1] = iptr[1:] + base
        base += int(iptr[-1])
        idx.append(ind)
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(np.concatenate(idx), ref.indices)
    _dirs_equal(str(tmp_path / "t"), str(tmp_path / "j"), "store.json")
    # the weighted, signed form sums duplicates and drops netted-out edges
    spill = ts.EdgeSpill(n, str(tmp_path / "w"), bucket_nodes=50,
                         weighted=True, drop_nonpositive=True)
    jspill = js.EdgeSpill(n, str(tmp_path / "wj"), bucket_nodes=50,
                          weighted=True, drop_nonpositive=True)
    w = np.where(rng.uniform(size=len(dst)) < 0.3, -1.0, 1.0)
    for sp in (spill, jspill):
        sp.add(dst, src, w)
    for x, y in zip(spill.canonical_edges(), jspill.canonical_edges()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["sbm", "powerlaw"])
def test_stream_generators_match_jax_at_two_chunk_sizes(kind, tmp_path):
    t_gen = getattr(tsyn, f"stream_{kind}_graph")
    j_gen = getattr(jsyn, f"stream_{kind}_graph")
    kw = dict(n=3000, feat_dim=16, avg_degree=6.0)
    small = dict(chunk_nodes=700, chunk_edges=2000)
    ta = t_gen(tmp_path / "ta", **kw, **small)
    tb = t_gen(tmp_path / "tb", **kw)
    ja = j_gen(tmp_path / "ja", **kw, **small)
    _dirs_equal(str(tmp_path / "ta"), str(tmp_path / "ja"), "store.json")
    g_a, g_b = ts.load_graph_store(ta), ts.load_graph_store(tb)
    _graphs_equal(g_a, g_b)
    _graphs_equal(g_a, js.load_graph_store(ja))
    assert g_a.num_edges > 3000 and ta.num_classes == ja.num_classes


def test_copurchase_and_load_match_jax():
    a = tsyn.copurchase_graph(n=2000, feat_dim=16)
    b = jsyn.copurchase_graph(n=2000, feat_dim=16)
    _graphs_equal(a, b)
    _graphs_equal(tsyn.load("tiny", n=128), jsyn.load("tiny", n=128))
    with pytest.raises(KeyError):
        tsyn.load("nope")


def test_stream_partition_exact_path_matches_jax(graphs, tmp_path):
    g, gj = graphs
    st = ts.write_graph_store(g, tmp_path / "s", chunk_nodes=37,
                              chunk_edges=200)
    sj = js.open_store(tmp_path / "s")
    for scheme in ("metis-like", "random"):
        owner = ts.stream_partition(st, Q, scheme, seed=0)
        assert owner.dtype == np.int32
        np.testing.assert_array_equal(
            owner, js.stream_partition(sj, Q, scheme, seed=0))
    np.testing.assert_array_equal(
        ts.stream_partition(st, Q, "metis-like", seed=0),
        partition_graph(g, Q, scheme="metis-like", seed=0).owner)
    owner = ts.stream_partition(st, Q, "metis-like", seed=0)
    assert ts.stream_edge_cut(st, owner) == js.stream_edge_cut(sj, owner)
    with pytest.raises(ValueError, match="unknown scheme"):
        ts.stream_partition(st, Q, "spectral")


def test_stream_partition_multilevel_path_matches_jax(tmp_path):
    tsyn.stream_sbm_graph(tmp_path / "s", n=4000, feat_dim=8,
                          avg_degree=6.0, chunk_nodes=1000,
                          chunk_edges=4000)
    st, sj = ts.open_store(tmp_path / "s"), js.open_store(tmp_path / "s")
    kw = dict(seed=1, in_core_nodes=1000, coarsen_target=600,
              refine_max_nodes=2500)
    owner = ts.stream_partition(st, Q, "metis-like", **kw)
    np.testing.assert_array_equal(
        owner, js.stream_partition(sj, Q, "metis-like", **kw))
    assert set(np.unique(owner)) == set(range(Q))
    sizes = np.bincount(owner, minlength=Q)
    assert sizes.max() <= 1.05 * 4000 / Q + 1


@pytest.fixture(scope="module")
def shard_dirs(graphs, tmp_path_factory):
    """The same store sharded by each package under one owner vector."""
    g, _ = graphs
    root = tmp_path_factory.mktemp("shards")
    st = ts.write_graph_store(g, root / "store", chunk_nodes=60,
                              chunk_edges=400)
    owner = ts.stream_partition(st, Q, "metis-like", seed=0)
    ts.write_shards(st, owner, root / "t")
    js.write_shards(js.open_store(root / "store"), owner, root / "j")
    return g, owner, str(root / "t"), str(root / "j")


def test_shard_files_match_jax(shard_dirs):
    _, _, dt, dj = shard_dirs
    _dirs_equal(dt, dj, "shards.json")
    assert ts.is_shard_dir(dt) and not ts.is_shard_dir(os.path.dirname(dt))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_device_arrays_equal_in_memory(graphs, shard_dirs, writer):
    g, owner, dt, dj = shard_dirs
    sh = ts.load_shards(dj if writer == "jax" else dt)
    pg = partition_graph(g, Q, scheme="metis-like", seed=0)
    np.testing.assert_array_equal(pg.owner, owner)
    want = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    got = sh.device_arrays("cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # the manifest's spec is the spec rebuilt from the arrays, and the
    # JAX package's
    assert sh.halo_spec == build_halo_spec(pg)
    assert sh.halo_spec == build_halo_spec(sh)
    pgj = j_partition(graphs[1], Q, scheme="metis-like", seed=0)
    assert sh.halo_spec.to_dict() == j_build_halo_spec(pgj).to_dict()
    for k in ("q", "part_size", "halo_size", "halo_demand", "cross_edges",
              "num_nodes", "feat_dim", "num_classes"):
        assert getattr(sh, k) == getattr(pg, k), k
    assert (sh.n_train, sh.n_val, sh.n_test) == (
        int(g.train_mask.sum()), int(g.val_mask.sum()),
        int(g.test_mask.sum()))
    # and the JAX package loads the port's shards to the same arrays
    jsh = js.load_shards(dt)
    for k, v in jsh.arrays.items():
        np.testing.assert_array_equal(np.asarray(v), got[k].numpy())


def test_halo_spec_dict_roundtrip(shard_dirs):
    sh = ts.load_shards(shard_dirs[2])
    d = sh.halo_spec.to_dict()
    assert HaloSpec.from_dict(json.loads(json.dumps(d))) == sh.halo_spec
    meta = ts.shard_meta(shard_dirs[2])
    assert meta["halo_spec"] == sh.halo_spec and meta["q"] == Q


def test_load_shards_subset_and_validation(shard_dirs):
    dt = shard_dirs[2]
    full = ts.load_shards(dt)
    sub = ts.load_shards(dt, parts=[2, 0])
    assert sub.parts == (2, 0) and sub.q == Q
    for k, v in sub.arrays.items():
        np.testing.assert_array_equal(v, full.arrays[k][[2, 0]])
    jsub = js.load_shards(dt, parts=[2, 0])
    for k, v in jsub.arrays.items():
        np.testing.assert_array_equal(np.asarray(v), sub.arrays[k])
    for parts, err in (([], ValueError), ([1, 1], ValueError),
                       ([Q], ValueError), ([-1], ValueError)):
        with pytest.raises(err):
            ts.load_shards(dt, parts=parts)
    os.rename(os.path.join(dt, "part_00003.npz"),
              os.path.join(dt, "part_00003.bak"))
    try:
        with pytest.raises(FileNotFoundError, match="part_00003"):
            ts.load_shards(dt)
    finally:
        os.rename(os.path.join(dt, "part_00003.bak"),
                  os.path.join(dt, "part_00003.npz"))

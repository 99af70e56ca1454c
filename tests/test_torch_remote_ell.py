"""The p2p wire's remote ELL lists (``repro_torch.dist.halo.remote_ell``)
and the remote aggregation over them (``gnn_parallel._p2p_remote``) on
the CPU, on one thread.  No JAX: the port against itself and against the
edge-list formula written out here.

* The lists derived at Q in {1, 3, 4}, and on an uneven cut of Q = 4 whose
  small partitions carry many pad edges: pads dropped, ``Kr``/``RKr`` the
  largest real degrees, each destination's slots in edge-list order, and
  reversed lists that invert the forward ones (each compact row's edges in
  edge-list order too).
* ``_p2p_remote``'s forward and its cotangent with respect to the compact
  buffer equal the edge-list formula (``w · compact[src]``, then
  ``index_add``) bitwise, through ``attach_p2p``, ``ShardSet.
  device_arrays`` (all partitions, and one partition as a worker loads
  it), a shrunk shard set and ``shard_graph``.
* The lists are derived once a graph, where they are first read, and
  attached by nothing: a dense-wire graph never holds them.
* The slot rule on the host (numpy) and on the device (torch) is one.
* A p2p training step allocates no ``[Q, Er, F]`` tensor.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.varco import CommPolicy
from repro_torch.dist import faults as tf
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.dist.halo import (_group_slots, attach_p2p, remote_ell,
                                   remote_ell_stats)
from repro_torch.graph import stream as ts
from repro_torch.graph.partition import build_partitioned, partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim

from torch_dist_cases import one_thread

N, F_IN = 600, 16
CUTS = ("q1", "q3", "q4", "q4_uneven")
LIST_KEYS = ("remote_nbr", "remote_ell_w", "remote_rnbr", "remote_rslot")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def tiny():
    return tiny_graph(n=N, feat_dim=F_IN)


def _cut(g, name: str):
    if name == "q4_uneven":
        # four partitions of 7% / 13% / 30% / 50% of the nodes: the small
        # ones pad their remote edge lists up to the largest one's
        owner = np.random.default_rng(0).choice(
            4, size=g.num_nodes, p=[0.07, 0.13, 0.3, 0.5]).astype(np.int32)
        return build_partitioned(g, owner, 4)
    q = int(name[1:])
    return partition_graph(g, q, scheme="metis-like" if q > 1 else "random",
                           seed=0)


def _graph(g, name: str) -> dict:
    pg = _cut(g, name)
    return attach_p2p(pg.device_arrays("cpu"), pg, "cpu")


def _n_compact(graph: dict) -> int:
    return graph["p2p_send_slot"].shape[1] * graph["p2p_send_slot"].shape[2]


def _edge_formula(graph: dict, compact: torch.Tensor) -> torch.Tensor:
    """``out[q, dst] += w · compact[q, src]`` over the padded remote edge
    list, pads into the dropped row ``P``."""
    q, c, f = compact.shape
    p_sz = graph["node_valid"].shape[1]
    src = graph["remote_src_p2p"].long() + (torch.arange(q) * c)[:, None]
    vals = graph["remote_w"][..., None] * compact.reshape(q * c, f) \
        .index_select(0, src.reshape(-1)).reshape(q, -1, f)
    dst = graph["remote_dst"].long() + (torch.arange(q) * (p_sz + 1))[:, None]
    out = torch.zeros((q * (p_sz + 1), f)).index_add(
        0, dst.reshape(-1), vals.reshape(-1, f))
    return out.reshape(q, p_sz + 1, f)[:, :p_sz]


def _check_lists(graph: dict) -> None:
    """The remote lists against the edge list, destination by destination
    and compact row by compact row."""
    dst, src, w = (graph[k].numpy() for k in ("remote_dst",
                                              "remote_src_p2p", "remote_w"))
    nbr, ew, rnbr, rslot = (remote_ell(graph)[k].numpy() for k in LIST_KEYS)
    q, p_sz = graph["node_valid"].shape
    n_c = _n_compact(graph)
    assert nbr.shape[:2] == (q, p_sz) and rnbr.shape[:2] == (q, n_c)
    assert nbr.dtype == rnbr.dtype == rslot.dtype == np.int32
    assert ew.dtype == np.float32
    k_max = rk_max = 1
    for i in range(q):
        real = w[i] != 0
        d, s, wv = dst[i][real], src[i][real], w[i][real]
        assert (d < p_sz).all() and (s < n_c).all()
        for node in range(p_sz):
            sel = d == node
            deg = int(sel.sum())
            k_max = max(k_max, deg)
            np.testing.assert_array_equal(nbr[i, node, :deg], s[sel])
            np.testing.assert_array_equal(ew[i, node, :deg], wv[sel])
            assert not nbr[i, node, deg:].any()
            assert not ew[i, node, deg:].any()
        for row in range(n_c):
            sel = s == row
            deg = int(sel.sum())
            rk_max = max(rk_max, deg)
            np.testing.assert_array_equal(rnbr[i, row, :deg], d[sel])
            # the flat slots point back at these edges' forward entries
            fwd = rslot[i, row, :deg]
            np.testing.assert_array_equal(fwd // nbr.shape[2], d[sel])
            np.testing.assert_array_equal(nbr[i].reshape(-1)[fwd], row)
            np.testing.assert_array_equal(ew[i].reshape(-1)[fwd], wv[sel])
            assert not rnbr[i, row, deg:].any()
            assert (rslot[i, row, deg:] == -1).all()
        # the pads are gone: as many filled slots as real edges, each way
        assert int((ew[i] != 0).sum()) == int((rslot[i] >= 0).sum()) == \
            int(real.sum())
    assert nbr.shape[2] == k_max and rnbr.shape[2] == rk_max
    stats = remote_ell_stats(graph)
    assert (stats["remote_ell_degree"], stats["remote_rev_degree"]) == \
        (k_max, rk_max)
    assert stats["remote_ell_fill"] == int((w != 0).sum()) / (q * p_sz * k_max)


def _check_aggregation(graph: dict, f: int, seed: int = 0) -> None:
    q, p_sz = graph["node_valid"].shape
    gen = torch.Generator().manual_seed(seed)
    compact = torch.randn((q, _n_compact(graph), f), generator=gen,
                          requires_grad=True)
    cot = torch.randn((q, p_sz, f), generator=gen)
    want = _edge_formula(graph, compact)
    got = tgp._p2p_remote(graph, compact, p_sz)
    assert torch.equal(got, want)
    g_want, = torch.autograd.grad(want, compact, cot)
    g_got, = torch.autograd.grad(got, compact, cot)
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("cut", CUTS)
def test_remote_lists_invert_the_edge_list(tiny, cut):
    graph = _graph(tiny, cut)
    _check_lists(graph)
    lists = remote_ell(graph)
    pads = (graph["remote_w"] == 0).sum(1)
    if cut == "q1":
        # no remote edge: one pad, and lists of one empty slot
        assert lists["remote_nbr"].shape[2] == 1 and \
            not lists["remote_ell_w"].any()
    if cut == "q4_uneven":
        # the smallest partition's list is mostly padding
        assert int(pads[0]) > graph["remote_w"].shape[1] // 2


@pytest.mark.parametrize("f", [16, 256])
@pytest.mark.parametrize("cut", CUTS)
def test_p2p_remote_equals_edge_formula_bitwise(tiny, cut, f):
    _check_aggregation(_graph(tiny, cut), f)


@pytest.fixture(scope="module")
def shards(tiny, tmp_path_factory):
    root = tmp_path_factory.mktemp("remote_ell")
    st = ts.write_graph_store(tiny, root / "store")
    ts.write_shards(st, ts.stream_partition(st, 4, "metis-like", seed=0),
                    root / "shards")
    return str(root / "shards")


def test_shard_device_arrays_derive_the_lists(tiny, shards):
    sh = ts.load_shards(shards)
    got = sh.device_arrays("cpu")
    _check_lists(got)
    _check_aggregation(got, 128, seed=1)
    # the shard files keep their format: nothing of the lists is stored,
    # and nothing of them is attached
    assert not set(LIST_KEYS) & (set(sh.arrays) | set(got))
    # a worker that loads its own partition derives its own lists (its
    # own degrees) and aggregates its row of the stacked result
    gen = torch.Generator().manual_seed(2)
    compact = torch.randn((4, _n_compact(got), 128), generator=gen)
    full = tgp._p2p_remote(got, compact, sh.part_size)
    for r in range(4):
        own = ts.load_shards(shards, parts=[r]).device_arrays("cpu")
        _check_lists(own)
        assert torch.equal(tgp._p2p_remote(own, compact[r:r + 1],
                                           sh.part_size), full[r:r + 1])


def test_shrunk_shards_derive_the_lists(shards):
    new = tf.shrink_shards(ts.load_shards(shards), 1)
    graph = new.device_arrays("cpu")
    assert remote_ell(graph)["remote_nbr"].shape[0] == 3
    _check_lists(graph)
    _check_aggregation(graph, 128, seed=3)


def test_shard_graph_workers_derive_their_lists(tiny):
    pg = _cut(tiny, "q4")
    host = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    gen = torch.Generator().manual_seed(4)
    compact = torch.randn((4, _n_compact(host), 64), generator=gen)
    full = tgp._p2p_remote(host, compact, pg.part_size)
    whole = remote_ell(host)
    for r in range(4):
        mesh = SimpleNamespace(q=4, rank=r, device=torch.device("cpu"))
        own = tgp.shard_graph(host, mesh)
        _check_lists(own)
        # the worker's lists are its row of the stacked ones, cut to its
        # own degrees (the rest of the row is padding); the flat slots
        # ``i·Kr + k`` name the same (destination, slot) pairs
        mine = remote_ell(own)
        for k in LIST_KEYS:
            deg = mine[k].shape[2]
            pad = -1 if k == "remote_rslot" else 0
            assert not (whole[k][r, :, deg:] - pad).any(), k
            cut = whole[k][r:r + 1, :, :deg]
            if k == "remote_rslot":
                k_own, k_all = mine["remote_nbr"].shape[2], \
                    whole["remote_nbr"].shape[2]
                live = cut >= 0
                assert torch.equal(mine[k] >= 0, live)
                assert torch.equal(mine[k][live] // k_own,
                                   cut[live] // k_all)
                assert torch.equal(mine[k][live] % k_own, cut[live] % k_all)
            else:
                assert torch.equal(mine[k], cut), k
        assert torch.equal(tgp._p2p_remote(own, compact[r:r + 1],
                                           pg.part_size), full[r:r + 1])
    assert tuple(whole) == LIST_KEYS


def test_lists_derived_once_per_graph(tiny):
    """``attach_p2p`` attaches no lists (a dense-wire or auto graph never
    pays for them); the first read derives them, later reads of the same
    graph's tensors get the same lists, and a graph with other remote
    weights gets its own."""
    pg = _cut(tiny, "q3")
    graph = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    assert not set(LIST_KEYS) & set(graph)
    lists = remote_ell(graph)
    assert remote_ell(dict(graph)) is lists
    again = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    for k in LIST_KEYS:
        assert torch.equal(remote_ell(again)[k], lists[k]), k
    halved = {**graph, "remote_w": graph["remote_w"] / 2}
    assert remote_ell(halved) is not lists
    assert torch.equal(remote_ell(halved)["remote_ell_w"],
                       lists["remote_ell_w"] / 2)
    assert torch.equal(remote_ell(halved)["remote_nbr"], lists["remote_nbr"])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_group_slots_is_the_stable_slot_rule(kind):
    """One slot rule for the local lists (numpy in, numpy out) and the
    remote ones (torch): numpy's stable argsort, and each element's index
    within its group."""
    ids = np.random.default_rng(5).integers(0, 37, 1000).astype(np.int32)
    order, slot_in, counts = _group_slots(
        ids if kind == "numpy" else torch.from_numpy(ids), 40)
    if kind == "torch":
        assert isinstance(order, torch.Tensor)
        order, slot_in, counts = (v.numpy() for v in (order, slot_in, counts))
    else:
        assert isinstance(order, np.ndarray)
    np.testing.assert_array_equal(order, np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(counts, np.bincount(ids, minlength=40))
    for i in range(40):
        np.testing.assert_array_equal(slot_in[ids[order] == i],
                                      np.arange(int((ids == i).sum())))


def test_p2p_step_allocates_no_edge_values(tiny):
    """One p2p training step under a dispatch mode that notes every op's
    output shape: none is ``[Q, Er, F]`` at an exchanged width."""
    from torch.utils._python_dispatch import TorchDispatchMode

    pg = _cut(tiny, "q4")
    graph = attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    q, er = graph["remote_w"].shape
    cfg = tgnn.GNNConfig(conv="sage", in_dim=F_IN, hidden=32,
                         out_dim=tiny.num_classes, layers=2)
    params = tgnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    meta = tgp.DistMeta.build(pg, params, wire="p2p")
    assert er not in (meta.part_size, meta.p2p_compact, meta.halo_size)
    opt = toptim.sgd(0.1)
    step = tgp.make_train_step(cfg, CommPolicy.parse("full", 1), opt, meta)
    shapes = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    with Shapes():
        _, _, m = step(params, opt.init(params), graph, 0, prng.key(0))
    assert np.isfinite(float(m["loss"]))
    widths = {F_IN, 32}
    assert shapes and not [s for s in shapes
                           if len(s) == 3 and s[:2] == (q, er)
                           and s[2] in widths]

"""Shared pieces of the dense and packed wires' parity tests
(``tests/test_torch_dense_wire.py``, ``tests/test_torch_dense_wire_train.py``):
the tiny graph and the JAX package's initialisation in both packages (the
``world`` fixture, partitions cut on demand), the metas of a wire, and the
closeness rules."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.dist import gnn_parallel as jgp
from repro.graph.partition import partition_graph as j_partition
from repro.graph.synthetic import tiny_graph as j_tiny
from repro.nn import gnn as jgnn
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.graph.partition import partition_graph
from repro_torch.graph.synthetic import tiny_graph
from repro_torch.nn import gnn as tgnn
from repro_torch.train import optim as toptim

from torch_dist_cases import one_thread

N, F, HIDDEN, LAYERS = 256, 128, 256, 3
TOL = 1e-5


def _port(tree):
    return tgnn.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


@pytest.fixture(scope="module")
def world():
    g, gj = tiny_graph(n=N, feat_dim=F), j_tiny(n=N, feat_dim=F)
    kw = dict(conv="sage", in_dim=F, hidden=HIDDEN, out_dim=g.num_classes,
              layers=LAYERS)
    cj, ct = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    pj = jgnn.init_gnn(jax.random.key(0), cj)
    parts = {}

    def part(q):
        if q not in parts:
            parts[q] = (j_partition(gj, q, seed=0), partition_graph(g, q,
                                                                    seed=0))
        return parts[q]

    return {"g": g, "gj": gj, "cj": cj, "ct": ct, "pj": pj, "part": part}


def _metas(w, q, wire):
    pgj, pgt = w["part"](q)
    return (jgp.DistMeta.build(pgj, w["pj"], wire=wire),
            tgp.DistMeta.build(pgt, _port(w["pj"]), wire=wire))


def _assert_rel(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0)


def _assert_params_close(pt, pj, tol=TOL):
    lt, lj = toptim.tree_leaves(pt), jax.tree_util.tree_leaves(pj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=tol)


@pytest.fixture(autouse=True, scope="module")
def port_on_one_thread():
    """The port's side of these tests runs on one CPU thread, as the
    worker-backend tests run theirs (``torch_dist_cases.one_thread``):
    at these small shapes more threads buy nothing, and when parallel
    test workers together ask for more threads than the machine has
    cores, their synchronisation multiplies each test's time."""
    with one_thread():
        yield

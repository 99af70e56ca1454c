"""The three helpers the paper's benchmarks call, against the JAX
package's, exactly: ``edge_cut_stats`` (Table I) on the
``tests/test_torch_graph.py`` graphs and partitions, and
``DistMeta.transport_bits_quant`` / ``DistMeta.collective_bits`` on every
wire at rate ∈ {1, 2, 4} and width ∈ {4, 8, 32}."""

from __future__ import annotations

import numpy as np
import pytest

from repro.dist import gnn_parallel as jgp
from repro.graph import partition as jpart
from repro.graph import synthetic as jsyn
from repro_torch.dist import gnn_parallel as tgp
from repro_torch.graph import partition as tpart
from repro_torch.graph import synthetic as tsyn

N, F = 192, 128


@pytest.mark.parametrize("scheme", ["metis-like", "random"])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_edge_cut_stats_match_jax(scheme, q):
    jg = jsyn.citation_graph(n=N, feat_dim=F)
    tg = tsyn.citation_graph(n=N, feat_dim=F)
    owner = jpart.PARTITIONERS[scheme](jg, q, seed=0)
    assert tpart.edge_cut_stats(tg, owner) == jpart.edge_cut_stats(jg, owner)
    got = tpart.edge_cut_stats(tg, tpart.PARTITIONERS[scheme](tg, q, seed=0))
    assert got == jpart.edge_cut_stats(jg, owner)
    assert got["self_edges"] + got["cross_edges"] == len(tg.edge_list()[0])


def _params(widths) -> dict:
    """A GNN parameter tree of the layer input widths ``widths`` (only
    the shapes are read)."""
    return {"layers": [{"self": {"w": np.zeros((w, 128), np.float32)}}
                       for w in widths]}


@pytest.mark.parametrize("wire", ["dense", "packed", "p2p"])
@pytest.mark.parametrize("q", [2, 4])
def test_wire_bit_helpers_match_jax(wire, q):
    jpg = jpart.partition_graph(jsyn.citation_graph(n=N, feat_dim=F), q)
    tpg = tpart.partition_graph(tsyn.citation_graph(n=N, feat_dim=F), q)
    params = _params((F, 256, 128))
    jm = jgp.DistMeta.build(jpg, params, wire=wire)
    tm = tgp.DistMeta.build(tpg, params, wire=wire)
    for feat in (128, 256):
        for rate in (1.0, 2.0, 4.0):
            for width in (4, 8, 32):
                got = tm.transport_bits_quant(feat, rate, width)
                want = jm.transport_bits_quant(feat, rate, width)
                assert float(got) == float(want), (feat, rate, width)
                assert got.dtype == tm.transport_bits(feat, rate).dtype
            assert tm.collective_bits(feat, rate) == \
                jm.collective_bits(feat, rate), (feat, rate)
    assert tm.transport_bits_quant(256, 2.0, 32) == tm.transport_bits(256,
                                                                     2.0)

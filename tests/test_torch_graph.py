"""The port's numpy graph, partition and halo/ELL builders against the
JAX package's, bitwise for the same seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.dist import halo as jhalo
from repro.graph import partition as jpart
from repro.graph import synthetic as jsyn
from repro_torch.dist import halo as thalo
from repro_torch.graph import partition as tpart
from repro_torch.graph import synthetic as tsyn

N, F = 192, 128


def _same_fields(a, b, names):
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


@pytest.mark.parametrize("seed", [0, 1])
def test_citation_graph_bitwise(seed):
    a = jsyn.citation_graph(n=N, feat_dim=F, seed=seed)
    b = tsyn.citation_graph(n=N, feat_dim=F, seed=seed)
    _same_fields(a, b, ("indptr", "indices", "features", "labels",
                        "train_mask", "val_mask", "test_mask", "name"))


def test_tiny_graph_bitwise():
    a, b = jsyn.tiny_graph(), tsyn.tiny_graph()
    _same_fields(a, b, ("indptr", "indices", "features", "labels", "name"))


PG_FIELDS = ("q", "part_size", "halo_size", "num_nodes", "feat_dim",
             "num_classes", "halo_demand", "cross_edges", "owner",
             "local_index", "features", "labels", "train_mask", "val_mask",
             "test_mask", "node_valid", "local_dst", "local_src", "local_w",
             "local_w_iso", "remote_dst", "remote_src", "remote_w",
             "send_idx", "send_valid")


@pytest.mark.parametrize("scheme", ["metis-like", "random"])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_partition_bitwise(scheme, q):
    a = jpart.partition_graph(jsyn.citation_graph(n=N, feat_dim=F), q,
                              scheme=scheme)
    b = tpart.partition_graph(tsyn.citation_graph(n=N, feat_dim=F), q,
                              scheme=scheme)
    _same_fields(a, b, PG_FIELDS)


@pytest.mark.parametrize("q", [1, 2, 4])
def test_halo_and_ell_arrays_bitwise(q):
    a = jpart.partition_graph(jsyn.citation_graph(n=N, feat_dim=F), q,
                              scheme="metis-like")
    b = tpart.partition_graph(tsyn.citation_graph(n=N, feat_dim=F), q,
                              scheme="metis-like")
    sa, sb = jhalo.build_halo_spec(a), thalo.build_halo_spec(b)
    for name in ("q", "hop_width", "compact_rows", "ell_degree",
                 "rev_degree", "pair_rows"):
        assert getattr(sa, name) == getattr(sb, name), name
    np.testing.assert_array_equal(sa.pair_table(), sb.pair_table())
    for fa, fb in ((jhalo.halo_arrays, thalo.halo_arrays),
                   (jhalo.ell_arrays, thalo.ell_arrays)):
        da, db = fa(a, sa), fb(b, sb)
        assert sorted(da) == sorted(db)
        for k in da:
            assert da[k].dtype == db[k].dtype, k
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_attach_p2p_tensors_match_arrays():
    pg = tpart.partition_graph(tsyn.citation_graph(n=N, feat_dim=F), 4,
                               scheme="metis-like")
    graph = thalo.attach_p2p(pg.device_arrays("cpu"), pg, "cpu")
    arrays = {**thalo.halo_arrays(pg), **thalo.ell_arrays(pg)}
    for k, v in arrays.items():
        assert graph[k].device.type == "cpu"
        np.testing.assert_array_equal(graph[k].numpy(), v, err_msg=k)
    assert graph["features"].dtype == torch.float32
    assert graph["send_idx"].dtype == torch.int32
    np.testing.assert_array_equal(graph["features"].numpy(), pg.features)


def test_pair_query_mass_matches():
    rows = np.array([[0, 4, 1], [2, 0, 0], [3, 5, 0]], np.float32)
    qc = np.array([3.0, 5.0, 1.0])
    np.testing.assert_array_equal(thalo.pair_query_mass(rows, qc),
                                  jhalo.pair_query_mass(rows, qc))
    with pytest.raises(ValueError):
        thalo.pair_query_mass(rows, np.zeros(2))

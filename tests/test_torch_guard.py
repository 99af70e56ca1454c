"""Guards of the port's boundaries: it imports neither ``jax`` nor the JAX
package (nor ``ml_dtypes`` or ``msgpack``, which the GPU machine lacks),
and its entry points default to the card instead of quietly running on
the CPU."""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    return files


FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes", "msgpack")


def test_port_imports_no_jax_and_no_reference_package():
    bad = {}
    for path in _port_files():
        hits = sorted(m for m in _imported_modules(path)
                      if m.split(".")[0] in FORBIDDEN)
        if hits:
            bad[str(path.relative_to(ROOT))] = hits
    assert not bad, f"the port must not import {FORBIDDEN}: {bad}"


def test_import_scan_sees_relative_and_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    import jax.numpy as jnp\n"
                   "from repro.graph import data\nfrom . import x\n")
    assert _imported_modules(src) == {"jax.numpy", "repro.graph"}
    src.write_text("import ml_dtypes\n")
    assert _imported_modules(src) & set(FORBIDDEN) == {"ml_dtypes"}
    src.write_text("import msgpack\n")
    assert _imported_modules(src) & set(FORBIDDEN) == {"msgpack"}


def test_entry_points_default_to_cuda():
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.dist.ratectl import init_halo_cache, init_wire_residuals
    from repro_torch.graph.partition import PartitionedGraph
    from repro_torch.graph.stream import ShardSet
    from repro_torch.nn.gnn import centralized_forward, init_gnn
    from repro_torch.serve import ServingEngine
    from repro_torch.train.trainer import train_gnn

    from repro_torch.launch.serve import build_parser, serve
    from repro_torch.models import lm_params_from_jax
    from repro_torch.models.transformer import init_cache, init_lm

    from repro_torch.launch.train import build_parser as train_parser
    from repro_torch.launch.train import train_lm
    from repro_torch.models import adamw_state_from_jax
    from repro_torch.serve import incremental_recompute
    from repro_torch.train.data import TokenPipeline

    from repro_torch.dist import make_dp_mesh, make_varco_dp_train_step

    from repro_torch.dist.gnn_parallel import make_worker_mesh, spawn_workers

    for fn in (ServingEngine.__init__, attach_p2p, init_gnn,
               centralized_forward, init_halo_cache, init_wire_residuals,
               PartitionedGraph.device_arrays, ShardSet.device_arrays,
               train_gnn, serve, init_lm,
               init_cache, lm_params_from_jax, adamw_state_from_jax,
               incremental_recompute, train_lm, TokenPipeline,
               make_dp_mesh, make_worker_mesh, spawn_workers):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the worker backend is train_gnn's switch; its group's backend
    # follows the device (nccl on the card)
    assert inspect.signature(train_gnn).parameters[
        "use_shard_map"].default is False
    assert inspect.signature(make_worker_mesh).parameters[
        "backend"].default is None
    assert build_parser().get_default("device") == "cuda"
    assert train_parser().get_default("device") == "cuda"
    # the data-parallel step's mesh defaults to one worker on the card
    assert inspect.signature(make_varco_dp_train_step).parameters[
        "mesh"].default is None


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.nn.gnn import GNNConfig, init_gnn
    from repro_torch.serve import ServingEngine

    g = tiny_graph(n=64, feat_dim=128)
    cfg = GNNConfig(in_dim=128, hidden=128, out_dim=g.num_classes, layers=2)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(g, params, cfg, q=2)
    from repro_torch.core.varco import CommPolicy
    from repro_torch.train.trainer import train_gnn
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gnn(g, q=2, policy=CommPolicy.parse("full", 1), epochs=1,
                  hidden=128, layers=2)
    pg = partition_graph(g, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        attach_p2p(pg.device_arrays("cpu"), pg)
    with pytest.raises((RuntimeError, AssertionError)):
        pg.device_arrays()
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init_lm
    lm_cfg = get_config("mamba2-130m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(lm_cfg)
    lm_params = init_lm(lm_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(lm_cfg, lm_params, np.zeros((1, 4), np.int32), 2)
    from repro_torch.dist import make_dp_mesh, make_varco_dp_train_step
    from repro_torch.launch.steps import make_optimizer
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dp_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_varco_dp_train_step(lm_cfg, make_optimizer(lm_cfg), CommPolicy
                                 .parse("varco:linear:5", 4))
    from repro_torch.dist.gnn_parallel import make_worker_mesh, spawn_workers
    with pytest.raises(RuntimeError, match="CUDA"):
        make_worker_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn_workers(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gnn(g, q=2, policy=CommPolicy.parse("full", 1), epochs=1,
                  hidden=128, layers=2, use_shard_map=True)
    assert serve(lm_cfg, lm_params, np.zeros((1, 4), np.int32), 2,
                 device="cpu").tokens.shape == (1, 2)
    # and the CPU, when asked for, runs
    eng = ServingEngine(g, params, cfg, q=2, device="cpu")
    eng.refresh(force=True)
    assert np.isfinite(eng.serve([0, 1])[0]).all()

"""CPU tests of the port's benchmark harness (``chipbench/``).

    python -m pytest -q chipbench/tests

They run the harness on the CPU at a small size: the program's plain
versions stand in for its kernels, so every number here is a count or a
comparison, never a device time.  The test marked ``cuda`` runs a cell
through ``chipbench/run.py`` on the card and skips where there is none.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import flops, graphgen, peaks, reference  # noqa: E402
from chipbench import run as bench  # noqa: E402
from chipbench import trace as tracelib  # noqa: E402
from chipbench.kinds import gnn_train  # noqa: E402

SPEC = bench.load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in SPEC["workloads"]]
SMALL = {"nodes": 2000, "job_epochs": 6}


def small_inputs(name: str, root: Path = ROOT, spec: dict = SPEC) -> dict:
    inputs = bench.cell_inputs(spec, name, root)
    inputs["config"]["graph"]["nodes"] = SMALL["nodes"]
    inputs["traffic"]["job_epochs"] = SMALL["job_epochs"]
    return inputs


def run_small(name: str, seed: int = 7, tracing: bool = False, **kw):
    inputs = kw.pop("inputs", None) or small_inputs(name)
    return gnn_train.run(inputs["cell"], inputs["config"], inputs["traffic"],
                         inputs["limits"], seed, 0.0, tracing, "cpu",
                         time.perf_counter())


# -- finding a cell's files by name ------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_its_files_by_name(name):
    inputs = bench.cell_inputs(SPEC, name)
    assert inputs["config"]["kind"] == "gnn_train"
    assert {"wire", "policy", "compressor", "job_epochs"} <= \
        set(inputs["traffic"])
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(inputs["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    reader = bench.load_file(bench.BENCH / "metrics" / f"{metric}.py",
                             "reader_under_test")
    assert callable(reader.read)
    empty = SimpleNamespace(trace=None, steps=0, step_s=[], window_s=0.0,
                              peaks=None, ell_launches=[], mask_launches=[],
                              wire_mb=0.0, flops=0.0, counts={})
    assert reader.read(empty) is None       # nothing to read: no number


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A new traffic mix, its limits and one entry in BENCHMARK.json make
    a cell: no file of the harness changes."""
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = {"wire": "p2p", "policy": "varco:linear:3",
               "compressor": "blockmask", "job_epochs": 100,
               "eval_every": 10}
    (tmp_path / "chipbench/traffic/p2p-varco3.json").write_text(
        json.dumps(traffic))
    (tmp_path / "chipbench/limits/arxiv-q16-p2p-varco3.json").write_text(
        json.dumps(bench.load_json(
            ROOT / "chipbench/limits/arxiv-q16-p2p-full.json")))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "arxiv-q16-p2p-varco3",
                              "config": "sage3-arxiv-q16-random",
                              "traffic": "p2p-varco3", "chips": 1,
                              "why": "a test"})
    out = run_small("arxiv-q16-p2p-varco3",
                    inputs=small_inputs("arxiv-q16-p2p-varco3", tmp_path,
                                        spec))
    assert out["correct"], out["checks"]


# -- the yardstick's pieces ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_frozen_generator_equals_the_programs(seed):
    from repro_torch.graph.synthetic import citation_graph

    want = citation_graph(n=3000, n_classes=40, feat_dim=128, seed=seed)
    got = graphgen.citation_graph(3000, 40, 128, 13.8, 0.82, 0.06,
                                  (0.54, 0.18, 0.28), seed)
    for k in ("indptr", "indices", "features", "labels", "train_mask",
              "val_mask", "test_mask"):
        np.testing.assert_array_equal(got[k], getattr(want, k))


def test_step_flops_by_hand():
    dims = flops.layer_dims(128, 256, 40, 3)
    assert dims == [(128, 256), (256, 256), (256, 40)]
    n, e = 10, 30
    fwd = (4 * n * 128 * 256 + 2 * e * 128) + \
        (4 * n * 256 * 256 + 2 * e * 256) + (4 * n * 256 * 40 + 2 * e * 256)
    back = 4 * n * 128 * 256 + \
        (8 * n * 256 * 256 + 2 * e * 256) + (8 * n * 256 * 40 + 2 * e * 256)
    assert flops.forward_flops(n, e, dims) == fwd
    assert flops.train_step_flops(n, e, dims) == fwd + back


def test_kernel_bounds_by_hand():
    h100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks.peaks_for("some other card") is None
    # bytes bound: 3.35 GB take a millisecond
    assert peaks.bound_s(h100, 3.35e9) == pytest.approx(1e-3)
    # operations bound: 67 GFLOP take a millisecond
    assert peaks.bound_s(h100, 1.0, 67e9) == pytest.approx(1e-3)
    assert h100["int32_ops"] == pytest.approx(33.45408e12)
    ell = bench.load_file(bench.BENCH / "metrics/ell_spmm.roofline_pct.py",
                          "ell_reader")
    mask = bench.load_file(
        bench.BENCH / "metrics/random_mask.roofline_pct.py", "mask_reader")

    class FakeTrace:
        def __init__(self, secs):
            self.secs = secs

        def device_seconds(self, match):
            return self.secs, 1

    # one ell launch: x [4, 1000, 256], nbr [4, 1000, 8]; 3000 local rows,
    # 20000 local edges: bytes 3000·256·4 + 2·32000·4 + 4·1000·256·4
    ctx = SimpleNamespace(trace=FakeTrace(1e-3), peaks=h100,
                            ell_launches=[((4, 1000, 256), (4, 1000, 8))],
                            counts={"local_rows": 3000,
                                    "local_edges": 20000},
                            mask_launches=[(4 * 1000 * 256, 4)])
    n_bytes = 3000 * 256 * 4 + 2 * 32000 * 4 + 4 * 1000 * 256 * 4
    assert ell.read(ctx) == pytest.approx(100 * n_bytes / 3.35e12 / 1e-3)
    # the mask: 8 bytes an element and the keys, against 76 integer
    # operations an element (at this size the bytes bound it, just)
    n = 4 * 1000 * 256
    least = max((8 * n + 4 * 8) / 3.35e12, 76 * n / h100["int32_ops"])
    assert least == (8 * n + 32) / 3.35e12
    assert mask.read(ctx) == pytest.approx(100 * least / 1e-3)


def test_trace_union_gaps_and_idle_names():
    spans = [("chipbench.window", 0, 1000_000), ("chipbench.step", 0, 400_000)]
    ops = ([100_000, 500_000], [300_000, 900_000], ["aten::mm", "aten::add"])
    t = tracelib.Trace(["k1", "k2", "k1"], [0, 50_000, 600_000],
                       [100_000, 150_000, 700_000], spans, ops)
    assert t.busy_s == pytest.approx(250_000e-9)
    assert t.window_s == pytest.approx(1e-3)
    assert t.gaps() == [(150_000, 600_000), (700_000, 1000_000)]
    idle = t.idle_by_host()
    assert idle == {"step: python": pytest.approx(450e-6),
                    "window: aten::add": pytest.approx(300e-6)}
    assert t.by_name() == {"k1": [pytest.approx(200e-6), 2],
                           "k2": [pytest.approx(100e-6), 1]}
    assert t.device_seconds(lambda n: n == "k1") == \
        (pytest.approx(200e-6), 2)


def test_rate_schedule_and_partition_check():
    tr = {"policy": "varco:linear:5", "job_epochs": 100}
    assert reference.rate_at(tr, 0) == np.float32(128.0)
    assert reference.rate_at(tr, 1) == np.float32(121.65)
    assert reference.rate_at(tr, 99) == np.float32(1.0)
    assert reference.rate_at({"policy": "full"}, 5) == 1.0
    from repro_torch.graph.partition import random_partition
    from repro_torch.graph.synthetic import citation_graph

    g = citation_graph(n=500, n_classes=4, seed=1)
    owner = random_partition(g, 4, seed=9)
    reference.check_partition(owner, 500, 4, "random", 9, 1.05)
    with pytest.raises(ValueError):
        reference.check_partition(owner, 500, 4, "random", 8, 1.05)
    lopsided = np.zeros(500, np.int64)
    lopsided[:3] = [1, 2, 3]
    with pytest.raises(ValueError):
        reference.check_partition(lopsided, 500, 4, "metis-like", 9, 1.05)


@pytest.mark.parametrize("name", CELLS)
def test_compared_steps_reach_full_rate(name):
    """Every cell's comparison reads steps at rate 1, past the ramp, and
    the job runs a step beyond them."""
    traffic = bench.cell_inputs(SPEC, name)["traffic"]
    plan = reference.steps_compared(traffic)
    assert plan["early"] == [0, 1, 2]
    assert all(reference.rate_at(traffic, t) == 1.0
               for t in plan["full_rate"])
    assert plan["follow"] == plan["full_rate"][-1] + 1
    assert plan["follow"] < traffic["job_epochs"]
    if traffic["policy"] == "varco:linear:5":
        # the ramp ends at step 20 of a 100-epoch job
        assert plan["full_rate"] == [20, 21, 22, 23]
        assert reference.rate_at(traffic, 19) > 1.0
    with pytest.raises(ValueError):
        reference.steps_compared({**traffic, "policy": "varco:linear:1",
                                  "job_epochs": 100})


def test_frozen_threefry_equals_the_programs():
    from repro_torch import prng

    k = prng.fold_in(prng.fold_in(prng.key(3), 1), 2)
    assert reference.fold_in(reference.fold_in(reference.key(3), 1), 2) == \
        tuple(int(v) for v in k)
    for n in (1, 2, 7):
        np.testing.assert_array_equal(reference.permutation(tuple(
            int(v) for v in k), n), prng.permutation(k, n))
    keys = torch.tensor([[int(k[0]), int(k[1])]], dtype=torch.int64)
    counters = torch.arange(64, dtype=torch.int64)[None] + 1000
    got = reference.uniform_at(keys, counters)
    want = prng.uniform(k, (1064,))[1000:]
    np.testing.assert_array_equal(got[0].numpy(), want)


# -- the reference against the program's CPU path ----------------------------


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_programs_cpu_path(name):
    out = run_small(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] == SMALL["job_epochs"] and out["failed"] == 0
    for key, (value, limit) in out["checks"].items():
        if key != "partition_valid":
            assert value < limit / 3, (key, value, limit)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in TF32, put in the program's place, is not
    correct."""
    inputs = small_inputs(name)
    cfg, traffic, limits = inputs["config"], inputs["traffic"], \
        inputs["limits"]
    graph, pg, params0, _ = gnn_train.setup(cfg, 11, "cpu", {})
    owner = np.asarray(pg.owner)
    control = reference.run(graph, owner, params0, traffic, cfg["recipe"],
                            "cpu", tf32=True)
    checks, correct = gnn_train.check(graph, owner, params0, cfg, traffic,
                                      limits, [control], "cpu")
    assert not correct, checks


def test_traced_run_reads_its_per_layer_metrics():
    out = run_small(CELLS[0], tracing=True)
    got = bench.read_per_layer(SPEC, CELLS[0], out["context"])
    # the CPU has no device operations: only the host-side readings
    assert set(got) == {"trainer.outside_step_pct", "halo.wire_MB_per_step"}
    assert out["trace"].busy_s == 0.0 and out["trace"].window_s > 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")


@pytest.mark.cuda
def test_a_run_on_the_card_prints_its_result(card):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chipbench/run.py"), "--workload",
         CELLS[-1], "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_step_ms", "peak_device_GB",
                                      "setup_s"}

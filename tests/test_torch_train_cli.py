"""The LM training CLI under ``torchrun``: every process is a
data-parallel worker (``gloo`` on the CPU), only rank 0 logs and writes
the checkpoint."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from repro_torch.train import checkpoint

ROOT = Path(__file__).resolve().parents[1]


def test_cli_under_torchrun_trains_on_the_group(tmp_path):
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-3-2b", "--smoke", "--steps", "3", "--batch", "4",
         "--seq", "32", "--device", "cpu", "--comm", "fixed:4", "--ckpt",
         str(ck)], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr[-4000:]}"
    steps = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    # rank 0 alone logs: steps 0 and 2, each with the policy's rate
    assert len(steps) == 2 and all("rate    4.0" in ln for ln in steps), \
        out.stdout
    assert out.stdout.count("arch=granite-smoke") == 1
    assert out.stdout.count("checkpoint ->") == 1
    assert checkpoint.peek(str(ck)) == {"arch": "granite-smoke",
                                        "steps": 3}

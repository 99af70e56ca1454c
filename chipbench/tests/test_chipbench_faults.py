"""The harness's ``correct`` comes out false when the timed path is
broken underneath it.

Each test drives the rest of a run on the CPU at a small size (the look
for a card skipped) with one fault planted in the program: a step that
returns its state unchanged, half the batch left out with the mean taken
over the rest, the halo exchange between the workers left out."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_chipbench_harness import CELLS, run_small  # noqa: E402


def _frozen(monkeypatch):
    from repro_torch.dist import gnn_parallel as gp

    monkeypatch.setattr(gp, "_optimize",
                        lambda opt, grads, state, params: (params, state))


def _half_batch(monkeypatch):
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.nn.gnn import gnn_forward, masked_loss_and_correct

    def loss(params, cfg, graph, aggregate, meta):
        logits, bits = gnn_forward(params, cfg, graph["features"], aggregate)
        mask = graph["train_mask"].clone()
        kept = mask.reshape(-1).nonzero()[:, 0]
        mask.reshape(-1)[kept[len(kept) // 2:]] = False
        loss_sum, _ = masked_loss_and_correct(logits, graph["labels"], mask)
        return loss_sum / mask.sum(), bits

    monkeypatch.setattr(gp, "_local_loss_fn", loss)


def _no_exchange(monkeypatch):
    from repro_torch.dist import gnn_parallel as gp

    def nothing(graph, halo, *a):
        q, p_sz = graph["features"].shape[:2]
        return torch.zeros((q, p_sz, halo.shape[-1]), dtype=halo.dtype)

    monkeypatch.setattr(gp, "_p2p_remote", nothing)
    monkeypatch.setattr(gp, "_gathered_remote", nothing)


@pytest.mark.parametrize("fault", [_frozen, _half_batch, _no_exchange],
                         ids=["state_unchanged", "half_batch",
                              "no_exchange"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(name)
    assert not out["correct"], out["checks"]

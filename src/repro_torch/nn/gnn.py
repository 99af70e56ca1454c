"""GNN models (paper §II eq. (2) + §V setup), over an aggregation oracle.

Counterpart of ``repro/nn/gnn.py``.  The model is written against an
abstract ``aggregate(layer, x) -> (Sx, wire_bits)`` so the same code runs
centralised (:func:`centralized_forward`, exact full-graph aggregation)
and distributed (``repro_torch.dist.gnn_parallel``, per-partition
aggregation with a compressed halo exchange).

Conv types: ``sage`` — ``h = ρ(x W_self + (S_mean x) W_neigh + b)``;
``poly`` — ``h = ρ(Σ_k (S^k x) H_k)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.graph.data import normalized_edge_weights
from repro_torch.spans import span

from .modules import dense, dense_init

# aggregate(layer_idx, x) -> (aggregated, wire_bits)
AggregateFn = Callable[[int, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    conv: str = "sage"          # "sage" | "poly"
    in_dim: int = 128
    hidden: int = 256           # paper §V: 256 hidden units
    out_dim: int = 40
    layers: int = 3             # paper §V: 3 layers
    k_taps: int = 2             # poly conv: number of filter taps K
    residual: bool = False

    def dims(self) -> list[tuple[int, int]]:
        ds = [self.in_dim] + [self.hidden] * (self.layers - 1) + [self.out_dim]
        return list(zip(ds[:-1], ds[1:]))


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cuda") -> dict:
    """Random parameters from ``generator`` (a CPU ``torch.Generator``):
    ``{"layers": [{"self": dense, "neigh": dense}, ...]}`` for sage,
    ``{"layers": [{"taps": [dense, ...]}, ...]}`` for poly."""
    params: dict = {"layers": []}
    for d_in, d_out in cfg.dims():
        if cfg.conv == "sage":
            layer = {"self": dense_init(generator, d_in, d_out, bias=True,
                                        device=device),
                     "neigh": dense_init(generator, d_in, d_out, bias=False,
                                         device=device)}
        elif cfg.conv == "poly":
            layer = {"taps": [dense_init(generator, d_in, d_out,
                                         bias=(t == 0), device=device)
                              for t in range(cfg.k_taps)]}
        else:
            raise ValueError(f"unknown conv {cfg.conv!r}")
        params["layers"].append(layer)
    return params


def params_from_jax(tree, device="cuda"):
    """Carry the JAX package's state into the port: ``tree`` is a JAX
    pytree (parameters, an optimiser state ``{"step", "mu", "nu"}``, an
    error-feedback residual tuple) with every leaf already converted to
    numpy by the caller (``jax.tree_util.tree_map(np.asarray, tree)``).
    Dicts, lists and tuples keep their structure and ``None`` stays
    ``None``; a floating array becomes a float32 tensor on ``device``, an
    integer one keeps its dtype; dense weights stay ``[d_in, d_out]``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    if not np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def params_to(params, device):
    """The same parameter tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return None if params is None else params.to(device)


def gnn_forward(params: dict, cfg: GNNConfig, x: torch.Tensor,
                aggregate: AggregateFn,
                hidden_out: list | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the GNN; returns ``(logits, total_wire_bits)``.

    ``hidden_out`` (optional list) collects every layer's post-activation
    output, the last being the logits.  When the oracle carries the
    split-phase attributes ``start(li, x) -> (token, bits)`` /
    ``complete(li, x, token) -> agg``, a sage layer issues its exchange
    first, computes the exchange-independent self term, and consumes the
    wire only in ``complete`` — the JAX package's pipelined schedule.
    """
    bits = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    n_layers = len(params["layers"])
    start = getattr(aggregate, "start", None)
    complete = getattr(aggregate, "complete", None)
    pipelined = start is not None and complete is not None

    for li, layer in enumerate(params["layers"]):
        if cfg.conv == "sage":
            if pipelined:
                with span("halo.start"):
                    token, b = start(li, h)            # issue the exchange
                self_term = dense(layer["self"], h)    # overlaps the wire
                with span("halo.complete"):
                    agg = complete(li, h, token)       # unpack + aggregate
                bits = bits + b
                h_new = self_term + dense(layer["neigh"], agg)
            else:
                agg, b = aggregate(li, h)
                bits = bits + b
                h_new = dense(layer["self"], h) + dense(layer["neigh"], agg)
        else:  # poly, eq. (2): taps chain, so the fused call is the schedule
            sk = h
            h_new = dense(layer["taps"][0], h)
            for t in range(1, cfg.k_taps):
                sk, b = aggregate(li, sk)
                bits = bits + b
                h_new = h_new + dense(layer["taps"][t], sk)
        if cfg.residual and h_new.shape == h.shape:
            h_new = h_new + h
        h = torch.relu(h_new) if li < n_layers - 1 else h_new
        if hidden_out is not None:
            hidden_out.append(h)
    return h, bits


def masked_loss_and_correct(logits: torch.Tensor, labels: torch.Tensor,
                            mask: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of softmax cross-entropy over masked nodes and the count of
    correct predictions (``logsumexp - gold``, as the JAX package)."""
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    m = mask.to(torch.float32)
    loss_sum = (ce * m).sum()
    correct = ((logits.argmax(-1) == labels) * m).sum()
    return loss_sum, correct


def centralized_aggregate_fn(n: int, dst: torch.Tensor, src: torch.Tensor,
                             w: torch.Tensor) -> AggregateFn:
    """Exact full-graph ``S x`` by scatter-add over the edge list; zero
    wire bits."""
    dst, src = dst.long(), src.long()

    def aggregate(_li: int, x: torch.Tensor):
        contrib = x[src] * w[:, None]
        agg = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device).index_add_(0, dst, contrib)
        return agg, torch.zeros((), dtype=torch.float32, device=x.device)

    return aggregate


def centralized_forward(params: dict, cfg: GNNConfig, g, norm: str = "mean",
                        device="cuda") -> torch.Tensor:
    """Full-graph forward on a host ``GraphData`` (the reference the
    distributed forward must match at full communication)."""
    dst, src = g.edge_list()
    w = normalized_edge_weights(g, kind=norm)
    agg = centralized_aggregate_fn(
        g.num_nodes, torch.from_numpy(dst).to(device),
        torch.from_numpy(src).to(device),
        torch.from_numpy(np.asarray(w, np.float32)).to(device))
    logits, _ = gnn_forward(params, cfg,
                            torch.from_numpy(g.features).to(device), agg)
    return logits

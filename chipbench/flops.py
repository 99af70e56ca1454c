"""Operations the work of a GraphSAGE job needs, counted from its shapes.

Counted on the unpadded graph (``n`` nodes, ``e`` directed edges), two
operations a multiply-add:

* forward, per layer ``d_in -> d_out``: the two products ``x W_self`` and
  ``(S x) W_neigh`` (``2 · 2 n d_in d_out``) and the mean aggregation
  (``2 e d_in``);
* backward: both weight gradients (``2 · 2 n d_in d_out``) and, above the
  first layer (the features need no gradient), the gradient of the
  layer's input through both products and the aggregation (``2 · 2 n d_in
  d_out + 2 e d_in``).

The loss, the activations, the masks and the optimizer's elementwise
update are left out: together under a thousandth of a step here.
"""

from __future__ import annotations


def forward_flops(n: int, e: int, dims) -> float:
    return float(sum(4 * n * a * b + 2 * e * a for a, b in dims))


def train_step_flops(n: int, e: int, dims) -> float:
    back = sum(4 * n * a * b + (4 * n * a * b + 2 * e * a if i else 0)
               for i, (a, b) in enumerate(dims))
    return forward_flops(n, e, dims) + float(back)


def layer_dims(in_dim: int, hidden: int, out_dim: int, layers: int) -> list:
    ds = [in_dim] + [hidden] * (layers - 1) + [out_dim]
    return list(zip(ds[:-1], ds[1:]))

"""Plain PyTorch reference of a partitioned GraphSAGE job's first steps,
through the schedule's ramp to its first steps at full rate.

It recomputes, on the whole graph at once and without any code of the
program, what the partitioned step of Algorithm 1 (VARCO, arXiv
2406.17611) computes over ``Q`` partitions:

* the mean aggregator ``S x`` split into local edges (both ends in one
  partition) and remote edges (the halo exchange).  Under ``varco`` the
  local weights blend toward the isolated-subgraph normalisation,
  ``w + (1 - 1/r)(w_iso - w)``, and the remote rows arrive compressed:
  ``blockmask`` keeps ``max(floor(F/128 / r), 1)`` whole 128-lane blocks
  of each sender's rows, ``randmask`` keeps each element of each sender's
  boundary block with probability ``1/r``; both drawn from the key
  ``fold_in(fold_in(key(step), layer), sender)`` of the Threefry stream;
* GraphSAGE, ``h = relu(x W_self + b + (S x) W_neigh)`` (no relu on the
  last layer), and the softmax cross entropy summed over the training
  nodes times ``1/n_train``;
* the gradient of that loss (the centralized gradient every worker
  applies after the gradient sync) and AdamW with decoupled weight decay.

The partition is the program's decision, not a value with one right
answer: the reference takes the ``owner`` array the program's partitioner
chose (checked by :func:`check_partition`) and derives every other layout
fact from it and the graph: local and remote edges, each partition's
boundary nodes and their slots (ascending global id).

``tf32=True`` is the control: every matrix product with its operands
rounded to TF32 (10 mantissa bits, round to nearest, ties away from
zero, as the tensor cores convert) and accumulated in float32, forward
and backward.  Everything else stays float32.

Nothing here imports the program: the Threefry stream below is a frozen
copy of the slice of ``jax.random`` the masks draw (``threefry2x32``,
``fold_in``, ``split``, 32-bit ``bits``, ``permutation``, ``uniform``) in
the ``jax_threefry_partitionable`` layout.
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 128
_F32 = torch.float32
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# -- the Threefry stream (numpy uint32 for keys, int64 torch for masks) ----


def _threefry(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on int64 arrays or tensors holding uint32
    values; ``k1``/``k2`` are ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def key(seed: int) -> tuple[int, int]:
    return 0, int(seed) & _M32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    a, b = _threefry(k[0], k[1], np.zeros(1, np.int64),
                     np.array([int(data) & _M32], np.int64))
    return int(a[0]), int(b[0])


def _bits(k: tuple[int, int], n: int) -> np.ndarray:
    c = np.arange(n, dtype=np.int64)
    a, b = _threefry(k[0], k[1], c >> 32, c & _M32)
    return a ^ b


def permutation(k: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` of ``arange(n)``."""
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2.0 ** 32 - 1)))
    for _ in range(rounds):
        a, b = _threefry(k[0], k[1], np.zeros(2, np.int64),
                         np.arange(2, dtype=np.int64))
        k, sub = (int(a[0]), int(b[0])), (int(a[1]), int(b[1]))
        x = x[np.argsort(_bits(sub, n), kind="stable")]
    return x


def uniform_at(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """float32 uniforms of the stream of ``keys [N, 2]`` (int64 uint32
    values, one key a row) at int64 ``counters [N, M]``."""
    a, b = _threefry(keys[:, :1], keys[:, 1:], counters >> 32,
                     counters & _M32)
    bits = (a ^ b) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


# -- the schedule, the partition and the layout ----------------------------


def rate_at(traffic: dict, step: int) -> np.float32:
    """The schedule's compression ratio at ``step`` in float32: ``full``
    is 1; ``varco:linear:a`` is ``c_max - a (c_max - c_min) t / T``
    clamped to ``[c_min, c_max]`` (paper eq. 8), with ``T`` the job's
    epochs."""
    kind = traffic["policy"].split(":")
    if kind[0] == "full":
        return np.float32(1.0)
    if kind[:2] != ["varco", "linear"]:
        raise ValueError(f"no reference for policy {traffic['policy']!r}")
    c_max, c_min = np.float32(128.0), np.float32(1.0)
    slope = float(kind[2])
    c = c_max - np.float32(slope * (128.0 - 1.0)) * np.float32(step) \
        / np.float32(traffic["job_epochs"])
    return np.float32(min(max(c, c_min), c_max))


#: steps of the compressed start whose losses and change are compared
EARLY_STEPS = 3
#: steps at full rate compared once the schedule's ramp has ended
FULL_RATE_STEPS = 4


def steps_compared(traffic: dict) -> dict:
    """Which steps of a job the comparison reads: the first
    :data:`EARLY_STEPS`, and the first :data:`FULL_RATE_STEPS` at rate 1
    (``varco:linear:5`` over 100 epochs reaches it at step 20, where the
    wire leaves its compressed path), kept short of the job's last step so
    that the program hands the parameters after them to a next update.
    ``{"early": [steps], "full_rate": [steps], "follow": steps the
    reference runs}``."""
    epochs = traffic["job_epochs"]
    first = next((t for t in range(epochs) if rate_at(traffic, t) == 1.0),
                 None)
    if first is None or first + 1 >= epochs:
        raise ValueError(f"a job of {epochs} epochs under "
                         f"{traffic['policy']!r} has no full-rate step "
                         f"before its last")
    full = list(range(first, min(first + FULL_RATE_STEPS, epochs - 1)))
    return {"early": list(range(EARLY_STEPS)), "full_rate": full,
            "follow": max(full[-1] + 1, EARLY_STEPS)}


def check_partition(owner: np.ndarray, n: int, q: int, scheme: str,
                    seed: int, slack: float) -> None:
    """Raise unless ``owner`` is a partition of ``n`` nodes into ``q``
    non-empty parts: for ``random``, exactly the seeded equal-size random
    assignment; for ``metis-like``, no part above ``slack · n / q``."""
    owner = np.asarray(owner)
    if owner.shape != (n,) or owner.min() < 0 or owner.max() >= q:
        raise ValueError("owner is no assignment of every node to a part")
    sizes = np.bincount(owner, minlength=q)
    if sizes.min() == 0:
        raise ValueError("a partition is empty")
    if scheme == "random":
        want = np.empty(n, np.int64)
        perm = np.random.default_rng(seed).permutation(n)
        for i in range(q):
            want[perm[i::q]] = i
        if not np.array_equal(owner, want):
            raise ValueError("owner is not the seeded random partition")
    elif sizes.max() > slack * n / q + 1:
        raise ValueError(f"a partition holds {sizes.max()} nodes, over "
                         f"{slack} of n/q")


class Layout:
    """The facts the partitioned step depends on, derived from the graph
    and ``owner``: edge lists with their mean and isolated weights split
    into local and remote edges, and each boundary node's slot."""

    def __init__(self, dst: np.ndarray, src: np.ndarray, n: int,
                 owner: np.ndarray, device):
        owner = np.asarray(owner, np.int64)
        deg = np.bincount(dst, minlength=n)
        local = owner[dst] == owner[src]
        local_deg = np.bincount(dst[local], minlength=n)
        w = (1.0 / np.maximum(deg, 1).astype(np.float32))[dst]
        w_iso = (1.0 / np.maximum(local_deg, 1).astype(np.float32))[dst]
        boundary = np.zeros(n, bool)
        boundary[src[~local]] = True
        slot = np.zeros(n, np.int64)
        for p in range(int(owner.max()) + 1):
            b = np.flatnonzero(boundary & (owner == p))
            slot[b] = np.arange(len(b))

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        self.n, self.q = n, int(owner.max()) + 1
        self.owner, self.slot = t(owner), t(slot)
        self.loc_dst, self.loc_src = t(dst[local]), t(src[local])
        self.loc_w, self.loc_w_iso = t(w[local], _F32), t(w_iso[local], _F32)
        self.rem_dst, self.rem_src = t(dst[~local]), t(src[~local])
        self.rem_w = t(w[~local], _F32)
        self.rem_nodes = t(np.flatnonzero(boundary))


def _remote_mask(lay: Layout, traffic: dict, step: int, layer: int, f: int,
                 rate: np.float32) -> torch.Tensor | None:
    """``[n, F]`` 0/1 float mask of what each sender's rows keep on the
    wire at this exchange (``None``: everything)."""
    if traffic["policy"] == "full":
        return None
    k_call = fold_in(key(step), layer)
    keys = [fold_in(k_call, j) for j in range(lay.q)]
    dev = lay.owner.device
    if traffic["compressor"] == "blockmask":
        nb = f // LANE
        k = max(int(nb / max(float(rate), 1.0)), 1)
        keep = np.zeros((lay.q, nb), np.float32)
        for j, kj in enumerate(keys):
            keep[j, permutation(kj, nb)[:k]] = 1.0
        blocks = torch.as_tensor(keep, device=dev)[lay.owner]
        return blocks.repeat_interleave(LANE, dim=1)
    if traffic["compressor"] == "randmask":
        p = np.float32(1.0) / max(rate, np.float32(1.0))
        mask = torch.zeros((lay.n, f), dtype=_F32, device=dev)
        kt = torch.as_tensor(np.asarray(keys, np.int64), device=dev)
        cols = torch.arange(f, device=dev)
        for chunk in torch.split(lay.rem_nodes, 1 << 16):
            counters = lay.slot[chunk, None] * f + cols
            u = uniform_at(kt[lay.owner[chunk]], counters)
            mask[chunk] = (u < torch.tensor(p, device=dev)).to(_F32)
        return mask
    raise ValueError(f"no reference for compressor "
                     f"{traffic['compressor']!r}")


# -- the model, the loss and the optimizer ---------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32: 10 mantissa bits, to nearest, ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).T, _tf32(a).T @ g


def _matmul(a, b, tf32: bool):
    return _MatmulTF32.apply(a, b) if tf32 else a @ b


def _aggregate(lay: Layout, x, mask, mix):
    """Mean aggregation: local edges (VARCO-blended weights) plus remote
    edges reading the masked rows."""
    w_loc = lay.loc_w if mix is None else \
        lay.loc_w + mix * (lay.loc_w_iso - lay.loc_w)
    out = torch.zeros_like(x).index_add(
        0, lay.loc_dst, x.index_select(0, lay.loc_src) * w_loc[:, None])
    xr = x if mask is None else x * mask
    return out.index_add(
        0, lay.rem_dst, xr.index_select(0, lay.rem_src) *
        lay.rem_w[:, None])


def loss_fn(params, lay: Layout, feats, labels, train_idx, per: float,
            traffic: dict, step: int, tf32: bool = False) -> torch.Tensor:
    """The partitioned step's loss at ``step``, on the whole graph."""
    rate = rate_at(traffic, step)
    mix = None
    if traffic["policy"].startswith("varco"):
        mix = torch.tensor(np.float32(1.0) - np.float32(1.0) / rate,
                           device=feats.device)
    h = feats
    layers = params["layers"]
    for li, layer in enumerate(layers):
        mask = _remote_mask(lay, traffic, step, li, h.shape[1], rate)
        agg = _aggregate(lay, h, mask, mix)
        h_new = _matmul(h, layer["self"]["w"], tf32) + layer["self"]["b"] \
            + _matmul(agg, layer["neigh"]["w"], tf32)
        h = torch.relu(h_new) if li < len(layers) - 1 else h_new
    logits = h.index_select(0, train_idx)
    gold = logits.gather(1, labels.index_select(0, train_idx)[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=1) - gold).sum() * per


def leaves(tree) -> list:
    """Tensor leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def run(graph: dict, owner: np.ndarray, params0, traffic: dict,
        recipe: dict, device, tf32: bool = False) -> dict:
    """Follow the job from ``params0`` through the steps
    :func:`steps_compared` names: ``{"loss": [a float a step], "grad0":
    first gradient leaves, "params": {k: leaves after k steps}}`` for the
    early and the full-rate change, leaves in sorted-key order."""
    from chipbench.graphgen import edge_list

    dst, src = edge_list(graph)
    n = len(graph["indptr"]) - 1
    lay = Layout(dst, src, n, owner, device)
    feats = torch.as_tensor(graph["features"], device=device)
    labels = torch.as_tensor(graph["labels"], dtype=torch.int64,
                             device=device)
    train_idx = torch.as_tensor(np.flatnonzero(graph["train_mask"]),
                                device=device)
    per = float(np.float32(1.0) / np.float32(max(len(train_idx), 1)))
    p = [t.detach().clone().to(device) for t in leaves(params0)]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    lr, wd = recipe["lr"], recipe["weight_decay"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    plan = steps_compared(traffic)
    losses, grad0, kept = [], None, {}
    for t in range(plan["follow"]):
        live = [x.requires_grad_(True) for x in p]
        loss = loss_fn(_rebuild(params0, iter(live)), lay, feats, labels,
                       train_idx, per, traffic, t, tf32)
        grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = [g.detach().clone() for g in grads]
        bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
        with torch.no_grad():
            for i, g in enumerate(grads):
                mu[i] = b1 * mu[i] + (1 - b1) * g
                nu[i] = b2 * nu[i] + (1 - b2) * g * g
                u = -lr * (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + eps)
                p[i] = p[i].detach() + (u - lr * wd * p[i].detach())
        if t + 1 in (EARLY_STEPS, plan["follow"]):
            kept[t + 1] = [x.detach() for x in p]
    return {"loss": losses, "grad0": grad0, "params": kept}


# -- the comparison --------------------------------------------------------


def _norms(ts) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double()))
                     for t in ts])


def leaf_gaps(prog: dict, ref: dict, params0, after: int) -> dict:
    """Per leaf, program against reference: the gap of the first
    gradient's norms and of the norms of each leaf's change over the first
    ``after`` steps, each over the reference's norm of that leaf or of the
    median leaf, whichever is larger; and which leaves move by more than
    round-off (reference gradient at least a thousandth of the median
    leaf's)."""
    g_ref, g_prog = _norms(ref["grad0"]), _norms(prog["grad0"])
    p_ref, p_prog = ref["params"][after], prog["params"][after]
    p0 = [t.to(p_ref[0].device) for t in leaves(params0)]
    c_ref = _norms([a - b for a, b in zip(p_ref, p0)])
    c_prog = _norms([a.to(b.device) - b for a, b in zip(p_prog, p0)])
    return {"grad": np.abs(g_prog - g_ref) / np.maximum(g_ref,
                                                         np.median(g_ref)),
            "change": np.abs(c_prog - c_ref) / np.maximum(c_ref,
                                                           np.median(c_ref)),
            "moved": g_ref >= 1e-3 * np.median(g_ref)}


def gaps(prog: dict, ref: dict, params0, plan: dict) -> dict:
    """The numbers compared, program against reference, for the steps of
    ``plan`` (:func:`steps_compared`):

    * ``loss``: the largest relative gap of an early step's loss;
    * ``grad``: the median leaf's first-gradient gap (:func:`leaf_gaps`).
      The worst leaf is a 256-element bias in most runs of the p2p cells,
      whose gradient sums one term a node: a ReLU that flips at one node
      between two summation orders moves it by about that node's share,
      up to ~3e-5, which the TF32 control does not clear by three times;
    * ``change``: the worst moving leaf's gap of the norm of its change
      over the early steps;
    * ``full_rate_loss`` and ``full_rate_change``: the same at the
      full-rate steps, where the halo arrives whole and the remote
      aggregation weighs most, and over every step up to them.
    """
    def loss_gap(steps):
        return float(max(abs(prog["loss"][t] - ref["loss"][t]) /
                         abs(ref["loss"][t]) for t in steps))

    early = leaf_gaps(prog, ref, params0, len(plan["early"]))
    late = leaf_gaps(prog, ref, params0, plan["follow"])
    return {"loss": loss_gap(plan["early"]),
            "grad": float(np.median(early["grad"])),
            "change": float(np.max(early["change"][early["moved"]])),
            "full_rate_loss": loss_gap(plan["full_rate"]),
            "full_rate_change": float(np.max(late["change"][late["moved"]]))}

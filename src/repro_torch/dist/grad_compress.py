"""VARCO gradient compression for data-parallel LM training.

Counterpart of ``repro/dist/grad_compress.py``: the paper's variable-rate
scheme transplanted from halo activations to the data-parallel gradient
all-reduce.  Each worker compresses its local gradient with a
Definition-1 compressor (per-worker mask streams derived from a shared
key), the compressed contributions are summed
(:func:`repro_torch.core.collectives.compressed_psum`), and the rate
anneals under the policy's scheduler: early steps ship a fraction of the
gradient bits, converging to exact synchronous SGD as ``rate -> 1``.

Two meshes run the ``"data"`` axis, behind one surface (``q``, the local
``workers``, ``reduce_leaves``, ``gather``), so the step runs one path:

* :class:`DPMesh` emulates its Q workers on one device, one after
  another: worker ``w`` computes the gradients of its ``B/Q`` rows,
  compresses them leaf by leaf into the running sum, and its tree is
  released before worker ``w + 1`` starts, so the step holds the sum and
  one worker's gradients, never Q trees.  At Q = 1 every leaf is
  compressed in place: the peak grows by one leaf over the plain step's.
* :class:`~repro_torch.core.collectives.WorkerMesh` is one process per
  worker over ``torch.distributed`` (the JAX package's ``shard_map``):
  each process computes the gradients of its own ``B/Q`` rows,
  compresses them in place under its rank's key stream and sums them
  over the group leaf by leaf, in rank order, at a ring all-reduce's
  traffic (:func:`repro_torch.core.collectives.compressed_psum`), so the
  sum is the emulated one bitwise; beside its gradient tree a process
  holds one more leaf's worth while a leaf is reduced.  The loss and its
  parts are all-gathered and averaged in rank order.  Every process
  applies the same update to its replica, so parameters and optimiser
  state stay bitwise equal across the group.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collectives import (DPMesh, WorkerMesh,
                                          compressed_psum, psum,
                                          uncompressed_bits)
from repro_torch.core.varco import CommPolicy
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.transformer import checked_device
from repro_torch.train.optim import (Optimizer, apply_updates,
                                     clip_by_global_norm, tree_leaves)

__all__ = ["DPMesh", "make_dp_mesh", "make_varco_dp_train_step"]


def make_dp_mesh(n_devices: int | None = None, device="cuda") -> DPMesh:
    """A data-parallel group of ``n_devices`` workers (1 by default: the
    one device) emulated on ``device``.

    Example::

        mesh = make_dp_mesh(4, device="cpu")     # axis name: "data"
        step = make_varco_dp_train_step(cfg, opt, policy, mesh)
    """
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a data-parallel mesh needs at least one worker, "
                         f"got {n}")
    return DPMesh(n, checked_device(device))


def _shard(batch: dict, w: int, q: int) -> dict:
    """Worker ``w``'s rows of every batch leaf (``P("data")``: the leading
    dimension split into Q contiguous blocks)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % q:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} rows, not "
                             f"divisible by {q} workers")
        n = v.shape[0] // q
        out[k] = v[w * n:(w + 1) * n]
    return out


def _mean(values: list) -> torch.Tensor:
    """``lax.pmean``: the sum in worker order, divided by Q."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total / len(values)


def make_varco_dp_train_step(cfg: ArchConfig, optimizer: Optimizer,
                             policy: CommPolicy,
                             mesh: DPMesh | WorkerMesh | None = None,
                             clip: float = 1.0):
    """Data-parallel LM train step with a VARCO-compressed gradient psum.

    ``step(params, opt_state, batch, step_idx, key)`` -> ``(params,
    opt_state, {loss, ce, moe_aux, grad_norm, grad_bits, rate})``, the
    metrics 0-d tensors.  ``mesh`` defaults to one worker on the card
    (``make_dp_mesh(1)``); ``key`` is a ``uint32[2]`` key
    (``repro_torch.prng``).

    The batch is split over ``data`` on its leading dim; parameters and
    optimizer state are replicated.  Each worker's gradients (its own MoE
    aux loss included) are compressed under ``fold_in(key, worker)``,
    summed, divided by Q, clipped to global norm ``clip`` and applied by
    one optimiser update.  ``grad_bits`` charges the ring all-reduce
    traffic of the compressed payload; the full-communication baseline
    charges the uncompressed equivalent, ``uncompressed_bits · 2(Q-1)``,
    so accuracy-per-byte curves share an axis.

    With a :class:`~repro_torch.core.collectives.WorkerMesh` every
    process of the group calls the step with the same global ``batch``
    and key; it computes worker ``mesh.rank``'s rows only, and the
    gradient sum, the metrics and ``grad_bits`` cross the group (module
    docstring).  The metrics are equal on every process.

    Example::

        cfg = get_config("granite-3-2b", smoke=True)
        policy = CommPolicy.parse("varco:linear:5", total_steps=200)
        step = make_varco_dp_train_step(cfg, make_optimizer(cfg), policy,
                                        make_dp_mesh(device="cpu"))
        params, opt_state, m = step(params, opt_state,
                                    {"tokens": tokens}, 0, prng.key(0))
    """
    mesh = make_dp_mesh(1) if mesh is None else mesh
    compressor = policy.compressor() if policy.compresses else None
    q = mesh.q

    def step(params, opt_state, batch, step_idx, key):
        rate = policy.rate(step_idx)
        parts = []

        def worker(w):
            loss, aux, grads = loss_and_grads(params, cfg,
                                              _shard(batch, w, q))
            parts.append(torch.stack([loss, aux["ce"], aux["moe_aux"]]))
            return grads

        def worker_grads():
            # yielded unbound: the generator keeps no reference to a tree
            # the psum compresses in place
            for w in mesh.workers:
                yield worker(w)

        if compressor is not None:
            grads, grad_bits = compressed_psum(
                worker_grads(), mesh, compressor=compressor, rate=rate,
                key=key)
        else:
            grads = psum(worker_grads(), mesh)
            grad_bits = uncompressed_bits(grads) * 2.0 * (q - 1)
        if q > 1:                 # g / 1 is g
            with torch.no_grad():
                for leaf in tree_leaves(grads):
                    leaf.div_(q)
        grads, gnorm = clip_by_global_norm(grads, clip)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        del grads                 # freed before the new params are made
        params = apply_updates(params, updates)
        # every worker's (loss, ce, aux), averaged in worker order
        every = mesh.gather(parts)
        metrics = {"loss": _mean([v[0] for v in every]),
                   "ce": _mean([v[1] for v in every]),
                   "moe_aux": _mean([v[2] for v in every]),
                   "grad_norm": gnorm, "grad_bits": grad_bits,
                   "rate": rate}
        return params, opt_state, metrics

    return step

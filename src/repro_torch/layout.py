"""Where a tensor lies on a mesh while the model runs: the activation
half of the sharding rules (:mod:`repro_torch.dist.sharding` holds the
parameter, cache and batch rules and re-exports these names).

* :func:`activation_sharding` — the context inside which
  :func:`maybe_shard` redistributes a ``DTensor`` to the layout the JAX
  model names at the same place, and :func:`dispatch_groups` returns the
  data-parallel degree (the MoE dispatch's token groups).  Outside it, or
  on a plain tensor, :func:`maybe_shard` is the identity and
  :func:`dispatch_groups` is 1, so the one-card paths do not change.
* :func:`flatten` / :func:`unflatten` / :func:`replicate_like` /
  :func:`write_at` — the reshapes, buffers and in-place writes of the
  models and the plain kernels that DTensor cannot take as they are; on
  plain tensors they are ``Tensor.flatten``, ``Tensor.unflatten``, the
  tensor itself and an indexed assignment.
* :func:`placements` — a spec (one entry per tensor dim, ``None`` or a
  tuple of mesh axis names, major to minor: what JAX's ``PartitionSpec``
  holds) as DTensor placements.

The models and kernels import this module, which imports nothing of the
port, so the distributed layer above them can import the models.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch

_ctx = threading.local()

#: the batch-parallel axes, in mesh order
_DATA = ("pod", "data")


def _current_mesh():
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Enable :func:`maybe_shard` redistributions against ``mesh`` (and
    :func:`dispatch_groups`' data-parallel degree) inside the block.

    Example::

        with activation_sharding(mesh):
            params, state, metrics = step(params, state, batch)
    """
    prev = _current_mesh()
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


# ---------------------------------------------------------------------------
# Axis helpers
# ---------------------------------------------------------------------------


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> dict:
    return dict(zip(_names(mesh), (int(n) for n in mesh.shape)))


def data_axes(mesh) -> tuple:
    """The batch-parallel axis group: ``(pod, data)`` filtered to the
    mesh, in mesh order (``("data",)`` on a single-pod mesh)."""
    return tuple(a for a in _names(mesh) if a in _DATA)


def _size(mesh, axes) -> int:
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def dispatch_groups() -> int:
    """Token groups of the MoE dispatch: the active data-parallel degree
    inside :func:`activation_sharding`, else 1."""
    mesh = _current_mesh()
    if mesh is None:
        return 1
    return max(_size(mesh, data_axes(mesh)), 1)


# ---------------------------------------------------------------------------
# Specs to DTensor placements
# ---------------------------------------------------------------------------


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` on every mesh dim that tensor dim ``i``'s entry names,
    ``Replicate()`` elsewhere.  An entry's axes must follow the mesh's
    order (major to minor), as every rule's do."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} of dim {dim} is not in the "
                             f"mesh's axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(dim)
    return out


# ---------------------------------------------------------------------------
# DTensor-aware reshapes
# ---------------------------------------------------------------------------


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``.  None exists before
    ``torch.distributed.tensor`` is imported, and that import takes
    seconds, so the one-card paths never trigger it here."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def unflatten(x, dim: int, sizes: tuple):
    """``x.unflatten(dim, sizes)``.  A ``DTensor`` whose ``dim`` is
    sharded over mesh dims that do not divide ``sizes[0]`` (8 KV heads ×
    64 on a 16-way model axis) is first gathered on those mesh dims:
    DTensor refuses to split a dim that would shard unevenly, where XLA
    reshards in the same place (the dry run's meshes,
    :mod:`repro_torch.launch.dryrun`).  A plain tensor is only
    unflattened, as on one card."""
    dim = dim % x.dim()
    if _is_dtensor(x):
        from torch.distributed.tensor import Replicate

        place, n = list(x.placements), 1
        for i, p in enumerate(place):
            if p.is_shard(dim):
                n *= x.device_mesh.size(i)
                if sizes[0] % n:
                    place[i] = Replicate()
        if place != list(x.placements):
            x = x.redistribute(x.device_mesh, place)
    return x.unflatten(dim, sizes)


class _Flatten(torch.autograd.Function):
    """``flatten`` of a ``DTensor`` whose backward splits the gradient with
    :func:`unflatten`."""

    @staticmethod
    def forward(ctx, x, start, end):
        ctx.start, ctx.sizes = start, tuple(x.shape[start:end + 1])
        return x.flatten(start, end)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, ctx.start, ctx.sizes), None, None


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``; on a ``DTensor`` the backward splits
    the gradient with :func:`unflatten`, which DTensor's own view
    backward cannot do where the split would shard unevenly.  A plain
    tensor is only flattened, as on one card."""
    if not _is_dtensor(x):
        return x.flatten(start, end)
    start, end = start % x.dim(), end % x.dim()
    return _Flatten.apply(x, start, end)


def replicate_like(t, ref):
    """``t`` as a replicated ``DTensor`` on ``ref``'s mesh when ``ref`` is
    a ``DTensor`` (a buffer the model allocates, such as prefill's
    cache, which DTensor activations are then written into), else ``t``
    itself."""
    if not _is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def write_at(buf, dim: int, index: int, value) -> None:
    """``buf[..., index, ...] = value`` at ``dim``, in place (a decode
    step's cache slot).  On a ``DTensor`` whose ``dim`` is sharded,
    DTensor's own indexed assignment writes into a gathered copy and is
    lost; here every rank lays ``value`` out as ``buf`` without ``dim``
    and the rank whose shard holds ``index`` writes it there."""
    if not _is_dtensor(buf):
        buf[(slice(None),) * dim + (index,)] = value
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, place = buf.device_mesh, buf.placements
    if not _is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    vplace = [Replicate() if p.is_shard(dim) else
              Shard(p.dim - (p.dim > dim)) if p.is_shard() else p
              for p in place]
    local_value = value.redistribute(mesh, vplace).to_local()
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh,
                                                          place)
    at = index - offset[dim]
    if 0 <= at < shape[dim]:
        buf.to_local()[(slice(None),) * dim + (at,)] = local_value


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------


def _activation_spec(x, dims, mesh) -> tuple:
    names = _names(mesh)
    spec = []
    for i, d in enumerate(dims):
        if d is None:
            spec.append(None)
            continue
        axes = (d,) if isinstance(d, str) else tuple(d)
        axes = tuple(a for a in axes if a in names)
        n = _size(mesh, axes) if axes else 1
        spec.append(axes if axes and n > 1 and x.shape[i] % n == 0
                    else None)
    return tuple(spec)


def maybe_shard(x, *dims):
    """Lay ``x`` out by ``dims``, one entry per dim (a name, a tuple of
    names, or ``None``).

    The identity outside an :func:`activation_sharding` context and on a
    plain tensor.  On a ``DTensor`` inside it, ``x.redistribute`` to the
    entries' placements: entries naming axes absent from the mesh, or
    groups that do not divide the dim, degrade to replicated.

    Example (activations ``[batch, seq, d_model]``)::

        h = maybe_shard(h, ("pod", "data"), None, "model")
    """
    mesh = _current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    spec = _activation_spec(x, dims, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


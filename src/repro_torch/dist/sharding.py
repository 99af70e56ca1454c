"""Mesh sharding rules for the transformer workloads on DTensor —
counterpart of ``repro/dist/sharding.py``, with its names.

Two surfaces:

* **Rules** — :func:`param_spec` / :func:`cache_spec` / :func:`batch_spec`
  map a parameter path and shape (or a cache layout, or the batch) to a
  *spec* under the production ``(data, model)`` or multi-pod ``(pod,
  data, model)`` meshes.  A spec is what JAX's ``PartitionSpec`` holds: a
  tuple with one entry per tensor dim, each ``None`` (replicated) or a
  tuple of mesh axis names (major to minor).  Every assignment is
  divisibility-guarded: a dim that does not divide its axis group is
  replicated rather than split unevenly (8 KV heads on a 16-way model
  axis).  The rules read only the mesh's axis names and sizes
  (``mesh_dim_names`` and ``shape``), so a
  ``torch.distributed.device_mesh.DeviceMesh`` and an :class:`AbstractMesh`
  (no process group) serve alike, as JAX's rules take an
  ``AbstractMesh``.  :func:`placements` turns a spec into DTensor
  placements: a dim over ``("pod", "data")`` is ``Shard(dim)`` on both
  mesh dims, the major axis first, so every rank's local shape and global
  offset are JAX's for the same spec and mesh.
* **Activation constraints** — :func:`maybe_shard` redistributes a
  ``DTensor`` *only* inside an :func:`activation_sharding` context; on a
  plain tensor, or outside the context, it is the identity, so the
  one-card paths do not change.  Axis names absent from the active mesh
  (``pod`` on a single-pod mesh) are dropped.  These, the DTensor-aware
  reshapes and :func:`placements` live in :mod:`repro_torch.layout`,
  which the models import, and are re-exported here.

The rule choices are the JAX package's: vocab tables shard over
``model`` only, MoE expert parallelism lives on the ``data`` axis, and the
``pod`` axis joins ``data`` for parameter and batch sharding.
"""

from __future__ import annotations

import dataclasses

from repro_torch.layout import (_names, _size, _sizes, activation_sharding,
                                data_axes, dispatch_groups, flatten,
                                maybe_shard, placements, replicate_like,
                                unflatten)

__all__ = ["AbstractMesh", "activation_sharding", "batch_spec",
           "cache_spec", "data_axes", "dispatch_groups", "flatten",
           "local_shape_and_offset", "maybe_shard", "param_shardings",
           "param_spec", "placements", "replicate_like", "tree_paths",
           "unflatten", "worker_graph_shardings"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only, no devices and no process group: what
    the rules read of a mesh (JAX's ``AbstractMesh``).

    Example::

        param_spec("blocks/attn/wq", (40, 2048, 32, 64),
                   AbstractMesh((16, 16), ("data", "model")))
    """

    shape: tuple
    mesh_dim_names: tuple


def batch_spec(mesh) -> tuple:
    """Leading-dim batch sharding over the data axis group: ``(data
    axes,)``, or ``()`` (replicated) on a mesh without one."""
    d = data_axes(mesh)
    return (d,) if d else ()


def local_shape_and_offset(shape, spec, mesh, coordinate=None) -> tuple:
    """``(local shape, global offset)`` of the shard at mesh
    ``coordinate`` (default: this rank's) of a tensor of ``shape`` laid
    out by ``spec``."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    if coordinate is None:
        coordinate = mesh.get_coordinate()
    return _compute_local_shape_and_global_offset(
        tuple(shape), tuple(mesh.shape), list(coordinate),
        placements(spec, mesh))


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def param_spec(path: str, shape, mesh) -> tuple:
    """The spec of the parameter at ``path`` (``/``-joined tree keys).

    Rules (megatron-style tensor parallelism over ``model``, FSDP-style
    weight sharding over the ``(pod, data)`` group; every assignment
    divisibility-guarded, a group that does not divide shrinking from its
    major end):

    * norms / 1-D / unrecognised 2-D      -> replicated
    * ``embed [V, d]``, ``lm_head [d, V]`` -> vocab over ``model`` only
    * attention ``wq/wk/wv [L, d, h, dh]`` -> d over data, heads over model
    * attention ``wo [L, h, dh, d]``       -> heads over model, d over data
    * MoE experts ``[L, E, a, b]``         -> E over data, d_expert over model
    * generic 3-D ``[L, d_in, d_out]``     -> column-parallel (``w_down``
      row-parallel)

    Example: ``param_spec("blocks/attn/wq", (32, 4096, 32, 128), mesh)``
    is ``(None, ("pod", "data"), ("model",), None)`` on a multi-pod mesh.
    """
    name = path.split("/")[-1]
    rank = len(shape)
    data = data_axes(mesh)
    model = ("model",) if "model" in _names(mesh) else ()
    spec = [None] * rank

    def assign(dim, axes):
        axes = tuple(axes)
        while axes and (_size(mesh, axes) <= 1
                        or shape[dim] % _size(mesh, axes) != 0):
            axes = axes[1:]                    # shrink the group, keep inner
        if axes and _size(mesh, axes) > 1:
            spec[dim] = axes

    if rank == 0 or "norm" in name or rank == 1:
        return tuple(spec)
    if name == "embed":
        assign(0, model)                       # vocab over model ONLY
    elif name == "lm_head":
        assign(1, model)
    elif name == "router":
        pass                                   # tiny; replicate
    elif rank == 4 and name in ("wq", "wk", "wv"):
        assign(1, data)
        assign(2, model)                       # query / kv heads
    elif rank == 4 and name == "wo":
        assign(1, model)
        assign(3, data)
    elif rank == 4:                            # stacked experts [L, E, a, b]
        assign(1, data)                        # expert parallel on data
        assign(2 if name == "w_down" else 3, model)
    elif rank == 3 and name == "w_down":       # row-parallel [L, f, d]
        assign(1, model)
        assign(2, data)
    elif rank == 3:                            # column-parallel [L, d, f]
        assign(1, data)
        assign(2, model)
    return tuple(spec)                         # unknown 2-D: replicated


def tree_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs of a tree in ``tree_leaves`` order, the path
    ``/``-joined keys and sequence indices (the JAX package's
    ``_path_str``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


def param_shardings(params, mesh):
    """The tree of :func:`param_spec` specs of a parameter (or optimiser
    state) tree, leaf for leaf; :func:`placements` turns each into
    DTensor placements on a ``DeviceMesh``.

    Example::

        specs = param_shardings(params, mesh)
        params = tree_map(lambda p, s: distribute_tensor(
            p, mesh, placements(s, mesh)), params, specs)
    """
    from repro_torch.train.optim import tree_map

    # tree_paths and tree_map walk the leaves in one order
    specs = iter([param_spec(path, tuple(leaf.shape), mesh)
                  for path, leaf in tree_paths(params)])
    return tree_map(lambda _: next(specs), params)


# ---------------------------------------------------------------------------
# Partition-parallel graph rules
# ---------------------------------------------------------------------------


def worker_graph_shardings(graph: dict, mesh, axis: str = "workers") -> dict:
    """The spec of every graph leaf for the GNN runtime on a mesh with a
    ``axis`` dim: each stacked ``[Q, ...]`` leaf splits its leading
    partition dim over ``axis``.  A leaf whose leading dim is not the
    axis size (an un-stacked host array slipped into the graph) is
    refused here, with its key named."""
    q = _sizes(mesh)[axis]
    for k, v in graph.items():
        shape = tuple(getattr(v, "shape", ()))
        if len(shape) == 0 or shape[0] != q:
            raise ValueError(
                f"graph leaf {k!r} has shape {shape}; expected a stacked "
                f"[Q, ...] array with Q == mesh {axis!r} size {q}")
    return {k: ((axis,),) for k in graph}


# ---------------------------------------------------------------------------
# KV / SSM cache rules
# ---------------------------------------------------------------------------


def cache_spec(shape, mesh, batch_dim: int | None = None,
               seq_dim: int | None = None,
               head_dim: int | None = None) -> tuple:
    """Cache layout: heads over ``model`` when they divide, else the
    sequence dim absorbs ``model``; batch over ``data`` when it divides,
    else (batch 1, long context) the sequence dim takes the data group
    too.

    Example (KV cache ``[batch, seq, kv_heads, head_dim]``)::

        spec = cache_spec(kv.shape, mesh, batch_dim=0, seq_dim=1,
                          head_dim=2)
    """
    spec = [None] * len(shape)
    data = data_axes(mesh)
    dsize = _size(mesh, data)
    model = ("model",) if "model" in _names(mesh) else ()
    msize = _size(mesh, model) if model else 1
    model_free = bool(model) and msize > 1

    if head_dim is not None and model_free and shape[head_dim] % msize == 0:
        spec[head_dim] = model
        model_free = False
    if batch_dim is not None and dsize > 1 and shape[batch_dim] % dsize == 0:
        spec[batch_dim] = data
        if seq_dim is not None and model_free and shape[seq_dim] % msize == 0:
            spec[seq_dim] = model
    elif seq_dim is not None:
        group = data + (model if model_free else ())
        while group and (_size(mesh, group) <= 1
                         or shape[seq_dim] % _size(mesh, group) != 0):
            group = group[1:]
        if group and _size(mesh, group) > 1:
            spec[seq_dim] = group
    return tuple(spec)

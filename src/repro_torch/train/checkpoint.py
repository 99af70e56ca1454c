"""Checkpointing: trees of tensors in one crash-consistent file.

Counterpart of ``repro/train/checkpoint.py`` with a format of the port's
own (numpy and the standard library only — no msgpack, no pickle):

    b"REPRO-TORCH-CKPT\\n"           magic line
    8 bytes, little-endian u64       length of the JSON header
    the JSON header                  {"version", "treedef", "leaves":
                                      [{"path", "dtype", "shape",
                                        "offset", "nbytes"}, ...],
                                      "extra"}
    the leaves' raw bytes            in tree order, C-contiguous

Leaves are tensors (any dtype torch has, ``bfloat16`` included) in dicts,
lists and tuples; ``None`` leaves are kept as structure.  The header is
readable without touching the leaves (:func:`peek`).

Crash consistency: :func:`save` writes a temp file in the target's
directory, fsyncs it, atomically renames it over the target and fsyncs
the directory — a crash at any point leaves either the old checkpoint or
the new one, never a torn file.  :func:`restore` checks the tree's
structure, the leaf count, and every leaf's shape and dtype, naming the
path of any leaf at fault, and puts every leaf on the device of the
matching leaf of the ``like`` tree.  :func:`save_train_state` /
:func:`restore_train_state` round-trip the full train state (parameters,
optimiser, controller state, halo/fault caches, EF residuals, cumulative
ledger counters, step) so ``train_gnn(resume=True)`` continues the
uninterrupted run.

Example::

    save("run/state.ckpt", {"params": params, "opt": opt_state},
         extra={"epoch": 7})
    tree, extra = restore("run/state.ckpt",
                          {"params": params, "opt": opt_state})
"""

from __future__ import annotations

import json
import os
import struct
import tempfile

import numpy as np
import torch

#: the single train-state file a checkpoint directory holds — the atomic
#: rename makes in-place overwrite crash-consistent
TRAIN_STATE_FILE = "state.ckpt"
MAGIC = b"REPRO-TORCH-CKPT\n"
VERSION = 1

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def _flatten(tree, path: str = ""):
    """``(treedef string, [(path, tensor), ...])`` in sorted-key /
    sequence order (``repro_torch.train.optim.tree_leaves``'s order)."""
    if isinstance(tree, dict):
        parts, leaves = [], []
        for k in sorted(tree):
            d, lv = _flatten(tree[k], f"{path}[{k!r}]")
            parts.append(f"{k!r}:{d}")
            leaves += lv
        return "{" + ",".join(parts) + "}", leaves
    if isinstance(tree, (list, tuple)):
        parts, leaves = [], []
        for i, v in enumerate(tree):
            d, lv = _flatten(v, f"{path}[{i}]")
            parts.append(d)
            leaves += lv
        br = "[]" if isinstance(tree, list) else "()"
        return br[0] + ",".join(parts) + br[1], leaves
    if tree is None:
        return "None", []
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaves must be tensors, got "
                        f"{type(tree).__name__} at {path or '<root>'}")
    return "*", [(path or "<root>", tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensor leaves taken from the
    iterator ``leaves`` in :func:`_flatten` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise TypeError(f"unsupported checkpoint dtype {t.dtype}")
    return name


def _leaf_bytes(t: torch.Tensor) -> bytes:
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def _fsync_dir(d: str) -> None:
    """Durably record the rename itself (best-effort where directories
    reject read-only opens)."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(path: str, tree, extra: dict | None = None) -> None:
    """Atomically write ``tree`` to ``path``: temp file + fsync + rename
    + directory fsync.  ``extra`` is any JSON-serialisable dict."""
    treedef, leaves = _flatten(tree)
    metas, blobs, offset = [], [], 0
    for p, t in leaves:
        b = _leaf_bytes(t)
        metas.append({"path": p, "dtype": _dtype_name(t),
                      "shape": list(t.shape), "offset": offset,
                      "nbytes": len(b)})
        blobs.append(b)
        offset += len(b)
    header = json.dumps({"version": VERSION, "treedef": treedef,
                         "leaves": metas, "extra": extra or {}}).encode()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
            for b in blobs:
                f.write(b)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read_header(f) -> dict:
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError("not a repro_torch checkpoint (bad magic)")
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    if header.get("version") != VERSION:
        raise ValueError(f"checkpoint version {header.get('version')} "
                         f"is not {VERSION}")
    return header


def peek(path: str) -> dict:
    """The ``extra`` metadata of a checkpoint without reading its leaves
    — resume uses it to learn the checkpoint's world (q, alive workers)
    before it can build the like-tree to restore into."""
    with open(path, "rb") as f:
        return _read_header(f)["extra"]


def restore(path: str, like):
    """``(tree, extra)``: the checkpoint restored into the structure of
    ``like`` (structure, leaf count and every leaf's shape and dtype
    checked, naming the path at fault), each leaf on the device of its
    ``like`` leaf."""
    with open(path, "rb") as f:
        header = _read_header(f)
        base = f.tell()
        treedef, ref_leaves = _flatten(like)
        if header["treedef"] != treedef:
            raise ValueError("checkpoint treedef mismatch: the saved tree "
                             f"is {header['treedef']}, expected {treedef}")
        stored = header["leaves"]
        if len(stored) != len(ref_leaves):
            raise ValueError(f"checkpoint leaf count mismatch: "
                             f"{len(stored)} saved, {len(ref_leaves)} "
                             f"expected")
        out = []
        for meta, (where, ref) in zip(stored, ref_leaves):
            if tuple(meta["shape"]) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch at {where}: checkpoint "
                    f"{tuple(meta['shape'])} vs expected {tuple(ref.shape)}")
            want = _dtype_name(ref)
            if meta["dtype"] != want:
                raise ValueError(
                    f"dtype mismatch at {where}: checkpoint "
                    f"{meta['dtype']} vs expected {want}")
            dtype = _DTYPES[meta["dtype"]]
            if meta["nbytes"]:
                f.seek(base + meta["offset"])
                raw = np.frombuffer(f.read(meta["nbytes"]), np.uint8).copy()
                t = torch.from_numpy(raw).view(dtype).reshape(meta["shape"])
            else:
                t = torch.empty(meta["shape"], dtype=dtype)
            out.append(t.to(ref.device))
    return _unflatten(like, iter(out)), header["extra"]


# ---------------------------------------------------------------------------
# Full-train-state API (crash-consistent resume)
# ---------------------------------------------------------------------------


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Path of the train-state checkpoint under ``ckpt_dir`` (or None)."""
    p = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    return p if os.path.exists(p) else None


def save_train_state(ckpt_dir: str, tree, step: int,
                     extra: dict | None = None) -> str:
    """Atomically persist the full train state after ``step`` completed
    steps.  Every piece of carried state (controller, caches, residuals,
    cumulative counters) belongs in ``tree`` or ``extra``, or the resume
    diverges from the uninterrupted run."""
    path = os.path.join(ckpt_dir, TRAIN_STATE_FILE)
    save(path, tree, extra={"step": int(step), **(extra or {})})
    return path


def restore_train_state(ckpt_dir: str, like):
    """``(tree, step, extra)`` from ``ckpt_dir`` — raises
    FileNotFoundError when no checkpoint exists."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(
            f"no {TRAIN_STATE_FILE} under {ckpt_dir!r}")
    tree, extra = restore(path, like)
    return tree, int(extra["step"]), extra

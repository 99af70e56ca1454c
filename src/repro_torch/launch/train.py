"""LM training launcher — counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 50 --device cpu      # the reduced config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 10 --batch 8 --seq 2048      # full size on the card

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke --steps 3 --device cpu --comm varco:linear:5

config -> random weights (a seeded generator on the device) -> AdamW with
the config's moment dtype -> :func:`repro_torch.launch.steps.
make_train_step` over :class:`repro_torch.train.data.TokenPipeline`
batches -> an optional checkpoint of ``{"params", "opt"}``
(:mod:`repro_torch.train.checkpoint`).  It prints the JAX CLI's lines.
:func:`train_lm` is the same loop as a function.

``--comm varco:linear:<a>`` / ``fixed:<r>`` compress the data-parallel
gradient all-reduce as the JAX CLI does: the step is
:func:`repro_torch.dist.grad_compress.make_varco_dp_train_step` with step
key ``prng.key(i)``, and each line adds the step's compression rate.  The
data-parallel group is the process group, as the JAX CLI's is every
device: under ``torchrun`` with a world size above one, every process is a
worker (:func:`repro_torch.dist.gnn_parallel.make_worker_mesh`), and
``train_lm(..., workers=Q)`` starts Q worker processes itself
(:func:`repro_torch.dist.gnn_parallel.spawn_workers`).  Each worker
takes its ``B/Q`` rows of the global batch.  As in JAX, the
data-parallel step runs whenever the policy compresses or the group has
more than one worker; ``full`` on one worker is the plain step.  Only
rank 0 logs and writes the checkpoint.  Workers that share a card (or
the CPU) run over ``gloo``; one card each, over ``nccl``.

    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch granite-3-2b --smoke --steps 12 --device cpu \
        --comm varco:linear:5
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.collectives import WorkerMesh
from repro_torch.core.varco import CommPolicy
from repro_torch.dist.gnn_parallel import make_worker_mesh, spawn_workers
from repro_torch.dist.grad_compress import (make_dp_mesh,
                                            make_varco_dp_train_step)
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.transformer import checked_device, init_lm
from repro_torch.nn.modules import param_count
from repro_torch.train import checkpoint
from repro_torch.train.data import TokenPipeline


def train_lm(arch: str = "granite-3-2b", *, smoke: bool = False,
             steps: int = 50, batch: int = 8, seq: int = 128,
             lr: float = 3e-3, comm: str = "full", ckpt: str | None = None,
             device="cuda", workers: int = 1, mesh: WorkerMesh | None = None,
             log=print):
    """Train ``arch`` for ``steps`` steps on the synthetic token stream;
    returns ``(params, opt_state, metrics)`` with one dict of floats per
    step.  ``comm`` is the gradient all-reduce's policy (``full``,
    ``fixed:<r>``, ``varco:linear:<a>``).  ``log`` gets the CLI's lines
    (None: silent).

    ``workers > 1`` starts that many worker processes
    (:func:`~repro_torch.dist.gnn_parallel.spawn_workers`; ``gloo`` where
    they share a card or the CPU) and returns rank 0's result; ``log``
    must then pickle (``print`` does).  ``mesh`` is this process's place
    in a group already started (under ``torchrun``): every process of it
    calls ``train_lm``, each gets the same result, and only rank 0 logs
    and writes ``ckpt``; each step's metrics then add the transport's
    ``sent_bytes``, ``staged_bytes`` and ``comm_s`` (this process's)."""
    if workers > 1:
        if mesh is not None:
            raise ValueError("pass workers= or mesh=, not both")
        dev = checked_device(device)
        backend = "nccl" if dev.type == "cuda" and \
            torch.cuda.device_count() >= workers else "gloo"
        return spawn_workers(
            _train_worker, workers, arch,
            dict(smoke=smoke, steps=steps, batch=batch, seq=seq, lr=lr,
                 comm=comm, ckpt=ckpt, log=log),
            device=str(dev), backend=backend, timeout=600.0)
    if mesh is not None and mesh.rank != 0:
        log = None
    log = log or (lambda *_a, **_k: None)
    device = checked_device(device) if mesh is None else mesh.device
    policy = CommPolicy.parse(comm, steps)
    cfg = get_config(arch, smoke=smoke)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    log(f"arch={cfg.name} params={param_count(params):,} "
        f"layers={cfg.n_layers} d={cfg.d_model}")
    opt = make_optimizer(cfg, lr=lr)
    opt_state = opt.init(params)
    if policy.mode != "full" or mesh is not None:
        # the data-parallel group: this device alone, or the process group
        dp_step = make_varco_dp_train_step(
            cfg, opt, policy,
            make_dp_mesh(1, device=device) if mesh is None else mesh)

        def step(p, o, b, i):
            return dp_step(p, o, b, i, prng.key(i))
    else:
        base = make_train_step(cfg, opt)

        def step(p, o, b, _i):
            return base(p, o, b)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, device=device)
    history = []
    t0 = time.time()
    for i, b in zip(range(steps), pipe):
        if mesh is not None:
            before = (mesh.sent_bytes, mesh.staged_bytes, mesh.comm_s)
        params, opt_state, m = step(params, opt_state, b, i)
        if mesh is not None:
            # the transport this step, as the GNN group's History keeps it
            m = dict(m, **{k: now - was for k, now, was in zip(
                ("sent_bytes", "staged_bytes", "comm_s"),
                (mesh.sent_bytes, mesh.staged_bytes, mesh.comm_s),
                before)})
        history.append(m)
        if i % 10 == 0 or i == steps - 1:
            extra = f" rate {float(m['rate']):6.1f}" if "rate" in m else ""
            log(f"step {i:4d}  loss {float(m['loss']):.4f}"
                f"  grad_norm {float(m['grad_norm']):.3f}{extra}"
                f"  ({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    metrics = [{k: float(v) for k, v in m.items()} for m in history]
    if ckpt and (mesh is None or mesh.rank == 0):
        checkpoint.save(ckpt, {"params": params, "opt": opt_state},
                        extra={"arch": cfg.name, "steps": steps})
        log(f"checkpoint -> {ckpt}")
    return params, opt_state, metrics


def _train_worker(mesh: WorkerMesh, arch: str, kwargs: dict):
    """One process of ``train_lm(workers=Q)``: rank 0 returns the run."""
    out = train_lm(arch, mesh=mesh, **kwargs)
    return out if mesh.rank == 0 else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="--comm: varco:/fixed: compress the gradient all-reduce of "
               "the data-parallel group, which is the process group: one "
               "worker when run alone, every process under torchrun "
               "(gloo where processes share a card or the CPU, else "
               "nccl); each worker trains on its B/Q rows of the batch")
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--comm", default="full",
                    help="full | fixed:<r> | varco:linear:<a> — gradient "
                         "all-reduce compression over the process group")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    kwargs = dict(smoke=args.smoke, steps=args.steps, batch=args.batch,
                  seq=args.seq, lr=args.lr, comm=args.comm, ckpt=args.ckpt)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        train_lm(args.arch, device=args.device, **kwargs)
        return
    # under torchrun: every process is a data-parallel worker
    dev = checked_device(args.device)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= world else "gloo"
    dist.init_process_group(backend)
    try:
        mesh = make_worker_mesh(world, dev, backend)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        train_lm(args.arch, mesh=mesh, **kwargs)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

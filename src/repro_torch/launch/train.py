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
data-parallel group is the one device (one worker, the JAX CLI's
``make_dp_mesh(1)`` on one device); ``full`` on one worker is the plain
step.  Workers on several cards wait for the multi-GPU backend.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.varco import CommPolicy
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
             device="cuda", log=print):
    """Train ``arch`` for ``steps`` steps on the synthetic token stream;
    returns ``(params, opt_state, metrics)`` with one dict of floats per
    step.  ``comm`` is the gradient all-reduce's policy (``full``,
    ``fixed:<r>``, ``varco:linear:<a>``).  ``log`` gets the CLI's lines
    (None: silent)."""
    log = log or (lambda *_a, **_k: None)
    device = checked_device(device)
    policy = CommPolicy.parse(comm, steps)
    cfg = get_config(arch, smoke=smoke)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    log(f"arch={cfg.name} params={param_count(params):,} "
        f"layers={cfg.n_layers} d={cfg.d_model}")
    opt = make_optimizer(cfg, lr=lr)
    opt_state = opt.init(params)
    if policy.mode != "full":
        # one worker: the data-parallel group is this device
        dp_step = make_varco_dp_train_step(cfg, opt, policy,
                                           make_dp_mesh(1, device=device))

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
        params, opt_state, m = step(params, opt_state, b, i)
        history.append(m)
        if i % 10 == 0 or i == steps - 1:
            extra = f" rate {float(m['rate']):6.1f}" if "rate" in m else ""
            log(f"step {i:4d}  loss {float(m['loss']):.4f}"
                f"  grad_norm {float(m['grad_norm']):.3f}{extra}"
                f"  ({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    metrics = [{k: float(v) for k, v in m.items()} for m in history]
    if ckpt:
        checkpoint.save(ckpt, {"params": params, "opt": opt_state},
                        extra={"arch": cfg.name, "steps": steps})
        log(f"checkpoint -> {ckpt}")
    return params, opt_state, metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="--comm: varco:/fixed: compress the gradient all-reduce of "
               "a data-parallel group that is the one device (one worker, "
               "as the JAX CLI's mesh on one device); workers on more "
               "than one card wait for the multi-GPU backend (ROADMAP.md "
               "queue 1 item 6)")
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--comm", default="full",
                    help="full | fixed:<r> | varco:linear:<a> — gradient "
                         "all-reduce compression (one worker on one card; "
                         "more cards wait for ROADMAP.md queue 1 item 6)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    train_lm(args.arch, smoke=args.smoke, steps=args.steps,
             batch=args.batch, seq=args.seq, lr=args.lr, comm=args.comm,
             ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()

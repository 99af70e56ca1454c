"""Batched LM serving launcher: prefill a request batch, greedy-decode N
tokens — counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --batch 8 --prompt-len 2048 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --smoke --device cpu          # the reduced config on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --prompt-len 2048   # any id of ARCH_IDS

Weights are random, drawn on the device from a seeded generator; prompts
come from ``numpy.random.default_rng(0)``.  :func:`serve` is the same path
as a function, returning the tokens and the timings.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import checked_device, init_lm
from repro_torch.nn.modules import param_count


@dataclasses.dataclass
class Served:
    """What :func:`serve` returns: greedy ``tokens`` [B, new_tokens] (the
    first from the prefill's logits), the prefill's last-position
    ``prefill_logits`` [B, V], and host-clock seconds that end in a device
    sync: ``prefill_s`` (prefill + first argmax) and ``decode_s`` (the
    ``new_tokens - 1`` decode steps)."""
    tokens: torch.Tensor
    prefill_logits: torch.Tensor
    prefill_s: float
    decode_s: float

    @property
    def decode_tokens(self) -> int:
        return self.tokens.shape[0] * (self.tokens.shape[1] - 1)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, params: dict, prompts, new_tokens: int,
          device="cuda") -> Served:
    """Prefill ``prompts`` [B, S] (ints), then greedy-decode until
    ``new_tokens`` tokens per row; the KV cache holds ``S + new_tokens``
    slots (or the sliding window)."""
    device = checked_device(device)
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    prefill = make_prefill_step(cfg, max_len=prompts.shape[1] + new_tokens)
    decode = make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    next_tok = logits.argmax(dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    toks = [next_tok]
    for _ in range(new_tokens - 1):
        next_tok, _, cache = decode(params, {"tokens": next_tok[:, None]},
                                    cache)
        toks.append(next_tok)
    _sync(device)
    t2 = time.perf_counter()
    return Served(tokens=torch.stack(toks, dim=1), prefill_logits=logits,
                  prefill_s=t1 - t0, decode_s=t2 - t1)


def build_parser() -> argparse.ArgumentParser:
    """CLI surface (separate from :func:`main` so tests can pin it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=False)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = checked_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    print(f"serving {cfg.name}: {param_count(params):,} params on {device}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    out = serve(cfg, params, prompts, args.new_tokens, device=device)
    print(f"prefill {args.batch}x{args.prompt_len}: {out.prefill_s:.2f}s")
    print(f"decode {out.decode_tokens} tokens: {out.decode_s:.2f}s "
          f"({out.decode_tokens_per_s:.1f} tok/s)")


if __name__ == "__main__":
    main()

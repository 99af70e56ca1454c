"""The paper's random element mask on Hopper — the dense compressing wire.

The paper's compression keeps each element of a worker's boundary block
independently with probability ``1/rate``; the receiver shares the key a
priori, so no index travels (``repro/core/compression.py::
_random_mask``).  The JAX package draws the mask with
``jax.random.bernoulli`` and leaves it to XLA: there is no Pallas kernel
for it.  Here it is one hand-written CUDA kernel (``csrc/randmask.cu``),
because the mask is one 20-round Threefry hash per activation — 45M per
exchange at the paper's width — and a plain PyTorch version spends over a
hundred elementwise int64 passes on it.

:func:`random_mask` — x ``[Q, N]`` f32 or bf16 (a worker's ``[B, F]``
block flattened, a gradient leaf, or any trailing shape), per-worker keys
``[Q, 2]`` -> ``where(mask, x · scale, 0)`` in x's dtype with ``mask[q,
i] = uniform(keys[q], i + offset) < p``, bitwise ``jax.random.bernoulli(
keys[q], p, block_shape)`` vmapped over workers; optionally each worker's
kept count.  The scale is cast to x's dtype first and the product rounded
once to it (the JAX package's ``x * scale.astype(x.dtype)``; in bf16 the
f32 product of two bf16 values is exact).  In f32 bound about equally by
bytes (8 an element) and integer operations (76 a hash at the SM's issue
ceiling); in bf16 (4 bytes an element) by the operations.  A thread
hashes 4 consecutive elements between one vector load and store, a block
serves one worker; each dtype is its own instantiation of the kernel
(``random_mask_f32``, ``random_mask_bf16``).

Beside the kernel: its plain version :func:`random_mask_plain` (the key
stream of ``repro_torch.prng.random_bits_torch``; what CPU tensors run)
and the launch counters ``random_mask.launches`` (every launch) and
``random_mask.bf16_launches`` (those of the bf16 instantiation).

:func:`random_uniform` — the same stream as float32 uniforms, ``out[b, i]
= uniform(keys[b], i + offset)``, bitwise ``jax.random.uniform(keys[b],
shape)`` with ``N = prod(shape)``: the draw of stochastic rounding where a
width map mixes fp32 and quantised pairs (``repro/kernels/ops.py::
quant_levels``, which draws it through XLA; no TPU kernel).  Bound by
integer operations (76 an element against 4 bytes written).  Its plain
version is :func:`random_uniform_plain`, its counter
``random_uniform.launches``; the Threefry round function lives in
``csrc/threefry.cuh``, shared with the fused stochastic codec.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import _build

_MASK_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
#: the mask's instantiations, by element dtype
_MASK_FUNCS = {torch.float32: "random_mask_f32",
               torch.bfloat16: "random_mask_bf16"}
_FUNCS = {
    "random_mask_f32": _MASK_ARGS,
    "random_mask_bf16": _MASK_ARGS,
    "random_uniform_f32": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 +
    [ctypes.c_int, ctypes.c_void_p],
}


def keys_tensor(keys, device) -> torch.Tensor:
    """``[Q, 2]`` uint32 keys (numpy) as the int32 tensor the kernel
    reads as uint32."""
    k = np.ascontiguousarray(np.asarray(keys, np.uint32).reshape(-1, 2))
    return torch.from_numpy(k.view(np.int32).copy()).to(device)


def _uint32(keys: torch.Tensor) -> np.ndarray:
    return keys.cpu().numpy().astype(np.int32).view(np.uint32)


def uniform_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's float32 draw from 32-bit ``bits`` (an int64
    tensor of uint32 values): ``((bits >> 9) | 0x3F800000)`` viewed as
    float32, minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def random_mask_plain(x: torch.Tensor, keys: torch.Tensor, p: float,
                      scale: float, offset: int = 0,
                      count: bool = False):
    """x ``[Q, ...]`` f32 or bf16, keys int32 ``[Q, 2]`` (uint32 bits) ->
    ``(out in x's dtype, counts int64 [Q] or None)``: the kernel's
    function in PyTorch.  The product is taken in f32 from the scale cast
    to x's dtype and rounded once, whatever PyTorch's promotion rules do
    with a 0-d f32 scale."""
    q = x.shape[0]
    bits = prng.random_bits_torch(_uint32(keys), tuple(x.shape[1:]),
                                  x.device, offset)
    mask = uniform_of_bits(bits) < torch.tensor(p, dtype=torch.float32,
                                                device=x.device)
    s = torch.tensor(scale, dtype=torch.float32).to(x.dtype).float()
    prod = (x.float() * s.to(x.device)).to(x.dtype)
    out = torch.where(mask, prod,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    counts = mask.reshape(q, -1).sum(-1) if count else None
    return out, counts


def random_mask(x: torch.Tensor, keys: torch.Tensor, p: float, scale: float,
                offset: int = 0, count: bool = False):
    """CUDA random mask: x ``[Q, ...]`` f32 or bf16 contiguous, keys int32
    ``[Q, 2]`` on the same card -> ``(out in x's dtype, counts int64 [Q]
    or None)``."""
    if x.dtype not in _MASK_FUNCS or keys.dtype != torch.int32:
        raise TypeError(f"random_mask needs f32 or bf16 x and int32 keys, "
                        f"got {x.dtype}, {keys.dtype}")
    if x.dim() < 1 or tuple(keys.shape) != (x.shape[0], 2):
        raise ValueError(f"random_mask needs x [Q, ...] and keys [Q, 2], "
                         f"got {tuple(x.shape)}, {tuple(keys.shape)}")
    for arg, t in (("x", x), ("keys", keys)):
        if not t.is_cuda:
            raise ValueError(f"random_mask: {arg} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"random_mask: {arg} must be contiguous")
    if keys.device != x.device:
        raise ValueError("random_mask: tensors on different devices")
    if not 0 <= offset < 2 ** 63:
        raise ValueError(f"random_mask: offset {offset} out of range")
    q = x.shape[0]
    n = x.numel() // max(q, 1)
    out = torch.empty_like(x)
    counts = torch.zeros((q,), dtype=torch.int64, device=x.device) \
        if count else None
    lib = _build.library("randmask", _FUNCS)
    _build.check(getattr(lib, _MASK_FUNCS[x.dtype])(
        x.data_ptr(), keys.data_ptr(), out.data_ptr(),
        counts.data_ptr() if count else None, q, n, offset, float(p),
        float(scale), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream), "random_mask")
    random_mask.launches += 1
    if x.dtype == torch.bfloat16:
        random_mask.bf16_launches += 1
    return out, counts


random_mask.launches = 0
random_mask.bf16_launches = 0


def random_uniform_plain(keys: torch.Tensor, n: int, offset: int = 0
                         ) -> torch.Tensor:
    """keys int32 ``[B, 2]`` (uint32 bits) -> float32 ``[B, n]`` on the
    keys' device: the kernel's function in PyTorch."""
    return uniform_of_bits(prng.random_bits_torch(_uint32(keys), (n,),
                                                  keys.device, offset))


def random_uniform(keys: torch.Tensor, n: int, offset: int = 0
                   ) -> torch.Tensor:
    """CUDA uniforms: keys int32 ``[B, 2]`` on the card -> float32 ``[B,
    n]``, row ``b`` the stream of ``keys[b]`` from counter ``offset``."""
    if keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"random_uniform needs int32 keys [B, 2], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not keys.is_cuda or not keys.is_contiguous():
        raise ValueError(f"random_uniform: keys must be a contiguous CUDA "
                         f"tensor, got {keys.device}")
    if n < 0 or not 0 <= offset < 2 ** 63:
        raise ValueError(f"random_uniform: n {n} or offset {offset} out of "
                         f"range")
    b = keys.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=keys.device)
    lib = _build.library("randmask", _FUNCS)
    _build.check(lib.random_uniform_f32(
        keys.data_ptr(), out.data_ptr(), b, n, offset, keys.device.index,
        torch.cuda.current_stream(keys.device).cuda_stream),
        "random_uniform")
    random_uniform.launches += 1
    return out


random_uniform.launches = 0

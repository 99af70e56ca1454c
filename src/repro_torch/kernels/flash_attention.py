"""Flash attention — causal / sliding-window, GQA — on Hopper.

``out[b, h, i] = Σ_j softmax_j(q_i · k_j / √D) v_j`` over the keys ``j``
that the mask keeps (``j ≤ i`` when causal, ``j > i − window`` when a
window is set), with query head ``h`` reading KV head ``h // group``.
Rows whose every key is masked give 0, as ``ref.mha_reference`` does.

Two CUDA kernels replace ``repro/kernels/flash_attention.py::
flash_attention`` (``_flash_kernel``, the ``pl.pallas_call`` at
``flash_attention.py:108``); :func:`flash_attention` picks one by the
explicit rule :func:`kernel_for` on ``(dtype, D)``:

* :func:`flash_attention_wgmma` (``csrc/flash_attention_wgmma.cu``) for
  bf16 at ``D ∈ {64, 128, 256}`` — every head dim of the repo's full-size
  configs.  Bound by operations (granite's prefill: 1.4e11 bf16 flops
  against 84 MB), so it runs both products on the tensor cores: TMA loads
  Q once and K/V tiles through a ring of mbarrier-paced stages, ``S =
  Q·Kᵀ`` by ``wgmma`` from shared memory, the online softmax on the f32
  accumulator fragment in registers, P rounded to bf16 straight into
  wgmma's register A operand for ``O += P·V``.  Rounding P to bf16 is its
  one rounding beyond the plain version's (about one bf16 ulp of the
  output, which is bf16 anyway).
* :func:`flash_attention_simt` (``csrc/flash_attention.cu``) for f32 and
  for bf16 at ``D ∈ {16, 32}`` (the smoke configs' widths): the first,
  CUDA-core design — 64×64 tiles as f32 in shared memory, FMA products,
  the online softmax in registers.

Both compute the same function: f32 ``m``/``l``/accumulators, key tiles
wholly outside the causal or window band skipped, keys past ``S`` masked
(any length runs; the Pallas kernel asserts ``S % 128 == 0``), masks from
indices as in the Pallas kernel and ``chunked_sdpa``.  This is a
dispatch, not a fallback: a failed build or launch of either raises.

Layout: the public function keeps the JAX layout ``[B, H, S, D]``, but
takes strided views — the model passes ``[B, S, H, D]`` tensors through
``transpose(1, 2)`` and both kernels read them in place through their
strides (no transpose copy); the output has ``q``'s strides.  The
tensor-core kernel's TMA needs 16-byte aligned pointers and strides.

Beside the kernels: the plain PyTorch version :func:`flash_attention_plain`
(dense masked softmax in f32; CPU tensors run it) and one launch counter
per kernel (``flash_attention_wgmma.launches``,
``flash_attention_simt.launches``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: head dims the CUDA-core kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims the tensor-core kernel takes (bf16 only)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FUNCS = {
    "flash_attention_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_WGMMA_FUNCS = {
    "flash_attention_wgmma_fwd": [ctypes.c_void_p] * 4 +
    [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3 +
    [ctypes.c_void_p],
}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """q ``[B, H, S, D]``, k/v ``[B, KV, S, D]`` -> ``[B, H, S, D]`` in
    q's dtype: scores ``q · k · (1/√D)`` in f32, the index mask, softmax,
    fully masked rows set to 0, then ``· v`` in f32.  GQA by reshaping the
    query heads into ``[KV, group]`` (no repeat of k/v)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qf = q.float().reshape(b, kvh, h // kvh, s, d)
    scores = qf @ k.float()[:, :, None].transpose(-1, -2)
    scores.mul_(1.0 / math.sqrt(d))
    idx = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[None, :] <= idx[:, None]
    if window > 0:
        mask &= idx[None, :] > idx[:, None] - window
    scores.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    del scores
    probs.nan_to_num_(0.0)                     # fully masked rows
    out = probs @ v.float()[:, :, None]
    return out.reshape(b, h, s, d).to(q.dtype)


def _check(q, k, v):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention needs q/k/v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention needs q [B, H, S, D] and k/v "
                         f"[B, KV, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or \
            h % k.shape[1] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (KV must divide H)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {arg} must be a CUDA "
                             f"tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different "
                             "devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {arg}'s last dim must be "
                             f"contiguous (stride 1)")


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel :func:`flash_attention` launches: ``"wgmma"`` (tensor
    cores) for bf16 at ``d`` in :data:`WGMMA_HEAD_DIMS`, else ``"simt"``
    (CUDA cores)."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


def _launch_args(q, k, v, out, causal, window):
    b, h, s, d = q.shape
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, d, *strides, int(causal), int(window),
            q.device.index, torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """The CUDA-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``, all
    f32 or all bf16, each with a contiguous last dim (other strides free)
    -> ``[B, H, S, D]`` in q's dtype, laid out like q."""
    _check(q, k, v)
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention", _FUNCS)
    args = _launch_args(q, k, v, out, causal, window)
    _build.check(lib.flash_attention_fwd(*args[:4], _DTYPE_CODE[q.dtype],
                                         *args[4:]), "flash_attention_simt")
    flash_attention_simt.launches += 1
    return out


flash_attention_simt.launches = 0


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """The tensor-core kernel: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all bf16 with ``D`` in :data:`WGMMA_HEAD_DIMS`, a contiguous last dim
    and 16-byte aligned pointers and strides -> ``[B, H, S, D]`` bf16,
    laid out like q."""
    _check(q, k, v)
    d = q.shape[-1]
    if q.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention_wgmma takes bf16 at head dims "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at {d}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % 8 for n, st in
                                    zip(t.shape[:3], t.stride()[:3])
                                    if n > 1):
            raise ValueError(f"flash_attention_wgmma: {arg} needs a "
                             f"16-byte aligned pointer and strides (TMA), "
                             f"got strides {t.stride()}")
    out = torch.empty_like(q)                  # q's strides
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention_wgmma", _WGMMA_FUNCS)
    _build.check(lib.flash_attention_wgmma_fwd(
        *_launch_args(q, k, v, out, causal, window)), "flash_attention_wgmma")
    flash_attention_wgmma.launches += 1
    return out


flash_attention_wgmma.launches = 0

_KERNELS = {"wgmma": flash_attention_wgmma, "simt": flash_attention_simt}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """CUDA flash attention: q ``[B, H, S, D]``, k/v ``[B, KV, S, D]``,
    all f32 or all bf16, each with a contiguous last dim -> ``[B, H, S,
    D]`` in q's dtype, laid out like q; launches the kernel that
    :func:`kernel_for` names."""
    _check(q, k, v)
    return _KERNELS[kernel_for(q.dtype, q.shape[-1])](q, k, v, causal, window)

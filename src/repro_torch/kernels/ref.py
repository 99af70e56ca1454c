"""Plain PyTorch counterparts of the JAX package's kernel oracles
(``repro/kernels/ref.py``), unbatched like those: ``[N, F]`` rows with one
index vector.  The batched plain versions the kernels are checked against
live beside each kernel (``varco_pack_plain``, ``ell_spmm_plain``)."""

from __future__ import annotations

import torch

from .ell_spmm import ell_spmm_plain
from .varco_pack import LANE, varco_pack_plain, varco_unpack_plain


def pack_reference(x: torch.Tensor, block_idx: torch.Tensor) -> torch.Tensor:
    """Gather kept lane-blocks. x [N, F] -> [N, K*LANE]."""
    return varco_pack_plain(x[None], block_idx[None])[0]


def unpack_reference(packed: torch.Tensor, inv_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Scatter kept blocks; zero dropped. packed [N, K*LANE] -> [N, F]."""
    return varco_unpack_plain(packed[None], inv_idx[None])[0]


def ell_spmm_reference(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
                       ) -> torch.Tensor:
    """out[i] = sum_k w[i,k] x[nbr[i,k]] (k ascending, f32)."""
    return ell_spmm_plain(x[None], nbr[None], w[None])[0]


def pack_bits_reference(levels: torch.Tensor, width: int) -> torch.Tensor:
    """Bit-pack int-``width`` levels into bytes: int8 ``[..., M]`` ->
    uint8 ``[..., ceil(M / (8/width))]``, ``8/width`` consecutive lanes per
    byte, little-endian within the byte, low ``width`` bits of each two's
    complement.  ``width == 8`` is the identity reinterpret; tail lanes
    are zero-padded into the last byte."""
    if width not in (2, 4, 8):
        raise ValueError(f"width must be 2, 4 or 8, got {width}")
    lv = levels.to(torch.int8)
    if width == 8:
        return lv.view(torch.uint8)
    vpb = 8 // width
    pad = (-lv.shape[-1]) % vpb
    if pad:
        lv = torch.nn.functional.pad(lv, (0, pad))
    u = lv.view(torch.uint8) & (2 ** width - 1)
    u = u.reshape(*lv.shape[:-1], -1, vpb)
    out = u[..., 0].clone()
    for j in range(1, vpb):
        out |= u[..., j] << (j * width)
    return out


def unpack_bits_reference(packed: torch.Tensor, width: int,
                          m: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_bits_reference`: uint8 bytes -> sign-extended
    int8 levels (``m`` trims the tail byte's zero-pad lanes)."""
    if width not in (2, 4, 8):
        raise ValueError(f"width must be 2, 4 or 8, got {width}")
    if width == 8:
        out = packed.view(torch.int8)
        return out if m is None else out[..., :m]
    vpb = 8 // width
    shifts = torch.arange(vpb, dtype=torch.uint8, device=packed.device) \
        * width
    v = ((packed[..., None] >> shifts) & (2 ** width - 1)).to(torch.int32)
    v = torch.where(v >= 2 ** (width - 1), v - 2 ** width, v)
    out = v.to(torch.int8).reshape(*packed.shape[:-1], -1)
    return out[..., : (m if m is not None else out.shape[-1])]


def quant_levels_reference(packed: torch.Tensor, width: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, block) symmetric quantisation of a packed fp32 payload:
    [N, K*LANE] -> (int8 levels [N, K*LANE], scales f32 [N, K]);
    ``qmax = 2^(width-1) - 1``, zero blocks get scale 1."""
    n, kf = packed.shape
    k = kf // LANE
    qmax = float(2 ** (width - 1) - 1)
    pb = packed.reshape(n, k, LANE)
    amax = pb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(pb / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8).reshape(n, kf), scale

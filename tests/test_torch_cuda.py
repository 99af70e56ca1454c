"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; the file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Pack/unpack are pure copies and must agree bitwise; the ELL SpMM within
1e-5 (the kernel contracts ``acc + w·x`` into an FMA, the plain version
rounds the product first).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmm as tell
from repro_torch.kernels import ops as tops
from repro_torch.kernels import varco_pack as tvp

LANE = 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _masks(rng, nb, k):
    kept = np.sort(rng.choice(nb, k, replace=False)).astype(np.int32)
    inv = np.full(nb, -1, np.int32)
    inv[kept] = np.arange(k, dtype=np.int32)
    return kept, inv


def _ell_inputs(rng, n_dst, n_src, k, f, pad_frac=0.3):
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    nbr = rng.integers(0, n_src, (n_dst, k)).astype(np.int32)
    w = (rng.uniform(0.1, 1.0, (n_dst, k)) / k).astype(np.float32)
    pad = rng.uniform(size=(n_dst, k)) < pad_frac
    w[pad] = 0.0
    nbr[pad] = 0
    return x, nbr, w


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,nb,k", [(4, 1000, 2, 1), (4, 1000, 2, 2),
                                      (3, 77, 4, 3), (1, 1, 1, 1)])
def test_cuda_pack_unpack_match_plain(cuda_device, q, n, nb, k):
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.normal(size=(q, n, nb * LANE))
                         .astype(np.float32)).to(cuda_device)
    masks = [_masks(rng, nb, k) for _ in range(q)]
    kept = torch.from_numpy(np.stack([m[0] for m in masks])).to(cuda_device)
    inv = torch.from_numpy(np.stack([m[1] for m in masks])).to(cuda_device)
    launches = (tvp.varco_pack.launches, tvp.varco_unpack.launches)
    packed = tops.wire_pack(x, kept)
    back = tops.wire_unpack(packed, inv)
    torch.cuda.synchronize()
    assert (tvp.varco_pack.launches, tvp.varco_unpack.launches) == \
        (launches[0] + 1, launches[1] + 1)
    assert torch.equal(packed, tvp.varco_pack_plain(x, kept))
    assert torch.equal(back, tvp.varco_unpack_plain(packed, inv))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n_dst,n_src,k,f", [(4, 1000, 1200, 29, 256),
                                               (2, 37, 53, 7, 128),
                                               (1, 45, 45, 33, 40),
                                               (3, 20, 31, 5, 42)])
def test_cuda_ell_matches_plain(cuda_device, q, n_dst, n_src, k, f):
    rng = np.random.default_rng(n_dst + f)
    parts = [_ell_inputs(rng, n_dst, n_src, k, f) for _ in range(q)]
    x, nbr, w = (torch.from_numpy(np.stack([p[i] for p in parts]))
                 .to(cuda_device) for i in range(3))
    launches = tell.ell_spmm.launches
    out = tops.ell_aggregate(x, nbr, w)
    torch.cuda.synchronize()
    assert tell.ell_spmm.launches == launches + 1
    torch.testing.assert_close(out, tell.ell_spmm_plain(x, nbr, w),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros((1, 8, 128), device=cuda_device)
    kept = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tvp.varco_pack(x.transpose(1, 2).contiguous().transpose(1, 2),
                       kept)
    with pytest.raises(TypeError):
        tvp.varco_pack(x, kept.long())
    with pytest.raises(ValueError):
        tvp.varco_pack(torch.zeros((1, 8, 100), device=cuda_device), kept)

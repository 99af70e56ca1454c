"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False; the file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Pack/unpack and the fused quantised codecs must agree bitwise (IEEE
division, round-half-even, one multiply per decoded lane); the ELL SpMM
within 1e-5 (the kernel contracts ``acc + w·x`` into an FMA, the plain
version rounds the product first), also at the p2p wire's remote
shapes (``Ns != Nd``, both ways).  Each autograd ``Function``'s backward
on the card is held to the plain version's autograd on the CPU within
1e-5 (atomic scatters and FMA contraction reorder f32 sums).  The LM
kernels: flash attention within 2e-5 in f32 and 2e-2 in bf16 (one bf16
ulp of the rounded output, relative 2^-8, where the two f32 sums straddle
a rounding edge; the tensor-core kernels also round P to bf16, about one
more ulp of the output), with a check of which of its three kernels ran
(each refuses the others' dtype and head dims);
the SSD chunk form within 1e-5 relative + 1e-4 absolute (f32 sums of up
to Q·N products in another order).  The dense wire's random mask
bitwise (a hash and one multiply per element), its VJP bitwise, and one
dense ``varco`` step on the card against the CPU within 1e-4.  The
stochastic fused codec and ``random_uniform`` bitwise (the same Threefry
stream, ``floor(v + u)`` with an IEEE add and division).  Flash
attention with explicit positions (shifted and left-padded prompts) on
all three kernels, under the same tolerances.  Two LM training steps of a
smoke config on the card against the CPU within 1e-4 (no LM kernel
launched), and a streaming-update frontier recompute on the card against
the CPU within 1e-5.  The worker backend: two worker processes on the
card over host-staged ``gloo`` (``tests/torch_dist_cases.py``), one p2p
``varco`` step within 1e-4 of the emulated step on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmm as tell
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_chunk as tssd
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


def _quant_inputs(rng, b, n, nb, k, zero_block=True):
    x = rng.normal(size=(b, n, nb * LANE)).astype(np.float32)
    if zero_block and n > 1:
        x[0, 1] = 0.0                                  # all-zero blocks
    masks = [_masks(rng, nb, k) for _ in range(b)]
    kept = np.stack([m[0] for m in masks])
    inv = np.stack([m[1] for m in masks])
    return x, kept, inv


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("b,n,nb,k", [(12, 1000, 2, 2), (12, 333, 2, 1),
                                      (3, 77, 3, 2), (1, 1, 1, 1)])
def test_cuda_quant_codecs_match_plain_bitwise(cuda_device, width, b, n, nb,
                                               k):
    rng = np.random.default_rng(width * 1000 + n + k)
    x, kept, inv = _quant_inputs(rng, b, n, nb, k)
    # per-row qmax at or below the storage width (a mixed-width plan)
    qmax = np.asarray([2.0 ** (rng.choice([w for w in (2, 4, 8)
                                            if w <= width]) - 1) - 1
                       for _ in range(b)], np.float32)
    xt, kt, it, qt = (torch.from_numpy(a).to(cuda_device)
                      for a in (x, kept, inv, qmax))
    before = (tvp.varco_pack_quant.launches, tvp.varco_unpack_quant.launches)
    payload, scales = tops.pack_quant(xt, kt, width, qt)
    out = tops.unpack_quant(payload, scales, it, width)
    torch.cuda.synchronize()
    assert (tvp.varco_pack_quant.launches,
            tvp.varco_unpack_quant.launches) == (before[0] + 1,
                                                 before[1] + 1)
    p_ref, s_ref = tvp.varco_pack_quant_plain(xt, kt, qt, width)
    assert torch.equal(payload, p_ref)
    assert torch.equal(scales, s_ref)
    assert torch.equal(out, tvp.varco_unpack_quant_plain(payload, scales, it,
                                                         width))


def _grad_pair(fn, inputs, cuda_device, seed):
    """``fn``'s output and input cotangents on the card and on the CPU
    (plain versions) for one seeded upstream cotangent."""
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        args = [a.to(dev) for a in inputs]
        args[0] = args[0].clone().requires_grad_(True)
        y = fn(*args)
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            size=tuple(y.shape)).astype(np.float32)).to(dev)
        (gx,) = torch.autograd.grad(y, args[0], g)
        outs.append((y.detach().cpu(), gx.cpu()))
    return outs


@pytest.mark.cuda
def test_cuda_wire_pack_unpack_backward(cuda_device):
    rng = np.random.default_rng(11)
    x, kept, inv = _quant_inputs(rng, 4, 300, 2, 1, zero_block=False)
    xt, kt, it = map(torch.from_numpy, (x, kept, inv))
    before = (tvp.varco_pack.launches, tvp.varco_unpack.launches)
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, k, i: tops.wire_pack(a, k, i), [xt, kt, it], cuda_device, 1)
    assert tvp.varco_unpack.launches == before[1] + 1     # the VJP
    assert torch.equal(y, y_ref) and torch.equal(gx, gx_ref)
    packed = torch.from_numpy(rng.normal(size=(4, 300, LANE))
                              .astype(np.float32))
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, i, k: tops.wire_unpack(a, i, k), [packed, it, kt],
        cuda_device, 2)
    assert torch.equal(y, y_ref) and torch.equal(gx, gx_ref)


@pytest.mark.cuda
def test_cuda_ell_aggregate_backward(cuda_device):
    """The x-cotangent is the ``ell_spmm`` kernel over the reversed
    lists; held to the plain version's autograd within 1e-5."""
    from repro_torch.dist.halo import build_reverse_ell

    rng = np.random.default_rng(12)
    q, p, k, f = 3, 500, 9, 256
    parts = [_ell_inputs(rng, p, p, k, f) for _ in range(q)]
    x, nbr, w = (torch.from_numpy(np.stack([pp[i] for pp in parts]))
                 for i in range(3))
    rev = [build_reverse_ell(nbr[i].numpy(), w[i].numpy() != 0, p)
           for i in range(q)]
    rk = max(r[0].shape[1] for r in rev)
    rnbr = np.zeros((q, p, rk), np.int32)
    rslot = np.full((q, p, rk), -1, np.int32)
    for i, (rn, rs) in enumerate(rev):
        rnbr[i, :, :rn.shape[1]], rslot[i, :, :rs.shape[1]] = rn, rs
    before = tell.ell_spmm.launches
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, n_, w_, rn, rs: tops.ell_aggregate(a, n_, w_, rn, rs),
        [x, nbr, w, torch.from_numpy(rnbr), torch.from_numpy(rslot)],
        cuda_device, 3)
    assert tell.ell_spmm.launches == before + 2           # forward + VJP
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(gx, gx_ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q,p,c,e,f", [(16, 661, 5870, 8600, 256),
                                       (4, 300, 2000, 2500, 128)])
def test_cuda_ell_remote_shapes(cuda_device, q, p, c, e, f):
    """The p2p wire's remote aggregation at its shapes scaled down (the
    first case is ``arxiv-q16-p2p-full``'s over 16): compact ``[Q, C, F]``
    -> partition ``[Q, P, F]`` over the remote lists that
    ``dist.halo.remote_ell`` derives from an edge list with pads, and the
    cotangent partition -> compact over their reversed lists; both ways
    ``ell_spmm`` against the plain version's autograd within 1e-5."""
    from repro_torch.dist.halo import remote_ell

    rng = np.random.default_rng(q * p)
    real = rng.uniform(size=(q, e)) < 0.8               # the rest pads
    dst = np.where(real, rng.integers(0, p, (q, e)), p)
    src = np.where(real, rng.integers(0, c, (q, e)), 0)
    w = np.where(real, rng.uniform(0.05, 0.2, (q, e)), 0.0)
    lists = remote_ell({
        "remote_dst": torch.from_numpy(dst.astype(np.int32)),
        "remote_src_p2p": torch.from_numpy(src.astype(np.int32)),
        "remote_w": torch.from_numpy(w.astype(np.float32)),
        "node_valid": torch.ones((q, p), dtype=torch.bool),
        "p2p_send_slot": torch.zeros((q, 1, c), dtype=torch.int32)})
    nbr, ew, rnbr, rslot = (lists[k] for k in (
        "remote_nbr", "remote_ell_w", "remote_rnbr", "remote_rslot"))
    assert nbr.shape[:2] == (q, p) and rnbr.shape[:2] == (q, c)
    x = torch.from_numpy(rng.normal(size=(q, c, f)).astype(np.float32))
    before = tell.ell_spmm.launches
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, n_, w_, rn, rs: tops.ell_aggregate(a, n_, w_, rn, rs),
        [x, nbr, ew, rnbr, rslot], cuda_device, 6)
    assert tell.ell_spmm.launches == before + 2           # forward + VJP
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(gx, gx_ref, rtol=0, atol=1e-5)


def _ell_hard_lists(rng, q, n_dst, n_src, k):
    """Lists that do not lean on ``ell_arrays``'s layout: ``w == 0`` slots
    anywhere in a row, ids below 0 and at or past ``n_src`` with nonzero
    weights, a row of degree 0 and a row of degree ``k`` in every
    partition.  Returns the lists and their sanitised twin (bad slots
    zeroed, ids 0), which the plain version can take."""
    nbr = rng.integers(0, n_src, (q, n_dst, k)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (q, n_dst, k)).astype(np.float32) / k
    w[rng.uniform(size=w.shape) < 0.3] = 0.0           # interspersed pads
    bad = rng.uniform(size=w.shape) < 0.1
    nbr[bad] = np.where(rng.uniform(size=int(bad.sum())) < 0.5, -1 -
                        rng.integers(0, 5, int(bad.sum())),
                        n_src + rng.integers(0, 5, int(bad.sum())))
    w[:, 0] = 0.0                                      # degree 0
    nbr[:, -1] = rng.integers(0, n_src, (q, k))        # degree k
    w[:, -1] = rng.uniform(0.1, 1.0, (q, k)) / k
    ok = (w != 0) & (nbr >= 0) & (nbr < n_src)
    return (nbr, w), (np.where(ok, nbr, 0).astype(np.int32),
                      np.where(ok, w, 0).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("f", [1, 60, 64, 100, 128, 192, 256, 384])
def test_cuda_ell_widths_and_hard_lists(cuda_device, q, f):
    """Widths on and off the 64-column slice (ragged last slices at 60
    and 100, whole slices at 64, 128, 192, 256 and 384), F % 4 != 0 (the
    4-byte path at 1), interspersed pads, out-of-range ids, degree-0 and
    degree-K rows, K past one 32-slot chunk."""
    rng = np.random.default_rng(100 * q + f)
    n_dst, n_src, k = 301, 257, 37
    x = rng.normal(size=(q, n_src, f)).astype(np.float32)
    (nbr, w), (nbr_ok, w_ok) = _ell_hard_lists(rng, q, n_dst, n_src, k)
    xt, nt, wt = (torch.from_numpy(a).to(cuda_device) for a in (x, nbr, w))
    before = tell.ell_spmm.launches
    out = tell.ell_spmm(xt, nt, wt)
    torch.cuda.synchronize()
    assert tell.ell_spmm.launches == before + 1
    want = tell.ell_spmm_plain(*(torch.from_numpy(a).to(cuda_device)
                                 for a in (x, nbr_ok, w_ok)))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    assert not out[:, 0].any()                         # the degree-0 row


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64, 256])
def test_cuda_ell_misaligned_view(cuda_device, f):
    """``x`` contiguous but 4 bytes off a 16-byte boundary: the kernel's
    4-byte path, held to the plain version on the same view."""
    rng = np.random.default_rng(f)
    q, n, k = 4, 200, 9
    buf = torch.from_numpy(rng.normal(size=q * n * f + 1)
                           .astype(np.float32)).to(cuda_device)
    x = buf[1:].view(q, n, f)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    (nbr, w), (nbr_ok, w_ok) = _ell_hard_lists(rng, q, n, n, k)
    out = tell.ell_spmm(x, torch.from_numpy(nbr).to(cuda_device),
                        torch.from_numpy(w).to(cuda_device))
    want = tell.ell_spmm_plain(x, torch.from_numpy(nbr_ok).to(cuda_device),
                               torch.from_numpy(w_ok).to(cuda_device))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q,p,k,f", [(1, 700, 29, 256), (4, 300, 40, 100),
                                     (4, 500, 7, 64)])
def test_cuda_ell_reverse_vjp(cuda_device, q, p, k, f):
    """The x-cotangent over the reversed lists (``rslot``-gathered
    weights; reversed degrees past one 32-slot chunk at K = 40) against
    the plain version's autograd within 1e-4."""
    from repro_torch.dist.halo import build_reverse_ell

    rng = np.random.default_rng(p + k)
    parts = [_ell_inputs(rng, p, p, k, f, pad_frac=0.5) for _ in range(q)]
    x, nbr, w = (torch.from_numpy(np.stack([pp[i] for pp in parts]))
                 for i in range(3))
    rev = [build_reverse_ell(nbr[i].numpy(), w[i].numpy() != 0, p)
           for i in range(q)]
    rk = max(r[0].shape[1] for r in rev)
    rnbr = np.zeros((q, p, rk), np.int32)
    rslot = np.full((q, p, rk), -1, np.int32)
    for i, (rn, rs) in enumerate(rev):
        rnbr[i, :, :rn.shape[1]], rslot[i, :, :rs.shape[1]] = rn, rs
    before = tell.ell_spmm.launches
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, n_, w_, rn, rs: tops.ell_aggregate(a, n_, w_, rn, rs),
        [x, nbr, w, torch.from_numpy(rnbr), torch.from_numpy(rslot)],
        cuda_device, 5)
    assert tell.ell_spmm.launches == before + 2           # forward + VJP
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(gx, gx_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_quant_hop_forward_and_backward(cuda_device):
    rng = np.random.default_rng(13)
    x, kept, inv = _quant_inputs(rng, 12, 400, 2, 1)
    qmax = np.full(12, 127.0, np.float32)
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, k, i, qm: tops.quant_hop(a, k, i, qm, 8),
        [torch.from_numpy(a) for a in (x, kept, inv, qmax)], cuda_device, 4)
    assert torch.equal(y, y_ref) and torch.equal(gx, gx_ref)


def _round_keys(b, seed):
    from repro_torch import prng
    from repro_torch.kernels.ops import round_key
    from repro_torch.kernels.randmask import keys_tensor

    k = prng.fold_in(prng.key(seed), 2)
    return keys_tensor(np.stack([round_key(k, r) for r in range(b)]), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("b,n,nb,k", [(12, 1000, 2, 2), (12, 333, 2, 1),
                                      (3, 77, 3, 2), (1, 1, 1, 1)])
def test_cuda_stochastic_codec_matches_plain_bitwise(cuda_device, width, b,
                                                     n, nb, k):
    """The stochastic instantiation of the fused codec: payload and
    scales bitwise the plain version's (Threefry uniforms, ``floor(v +
    u)``), at a per-row qmax, ragged row counts; its counter moves, the
    round-half-even counter does not; ``quant_hop`` with keys decodes
    the same bytes."""
    rng = np.random.default_rng(width * 100 + n + k)
    x, kept, inv = _quant_inputs(rng, b, n, nb, k)
    qmax = np.asarray([2.0 ** (rng.choice([w for w in (2, 4, 8)
                                            if w <= width]) - 1) - 1
                       for _ in range(b)], np.float32)
    keys = _round_keys(b, n)
    xt, kt, it, qt = (torch.from_numpy(a).to(cuda_device)
                      for a in (x, kept, inv, qmax))
    before = (tvp.varco_pack_quant.launches,
              tvp.varco_pack_quant_stochastic.launches)
    payload, scales = tops.pack_quant(xt, kt, width, qt,
                                      keys=keys.to(cuda_device))
    torch.cuda.synchronize()
    assert (tvp.varco_pack_quant.launches,
            tvp.varco_pack_quant_stochastic.launches) == (before[0],
                                                          before[1] + 1)
    p_ref, s_ref = tvp.varco_pack_quant_stochastic_plain(
        torch.from_numpy(x), torch.from_numpy(kept), torch.from_numpy(qmax),
        keys, width)
    assert torch.equal(payload.cpu(), p_ref)
    assert torch.equal(scales.cpu(), s_ref)
    out = tops.quant_hop(xt, kt, it, qt, width, keys=keys)
    assert torch.equal(out, tops.unpack_quant(payload, scales, it, width))
    rint, _ = tops.pack_quant(xt, kt, width, qt)
    assert b * n == 1 or not torch.equal(rint, payload)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,offset", [(12, 40960, 0), (3, 1001, 0),
                                        (2, 4096, 2 ** 32 - 2048), (1, 1, 0)])
def test_cuda_random_uniform_matches_plain(cuda_device, b, n, offset):
    """``random_uniform`` bitwise ``prng.random_bits_torch``'s floats, on
    the float4 path and the scalar one, across the 2^32 counter edge."""
    from repro_torch.kernels import randmask as trm

    keys = _round_keys(b, n)
    before = trm.random_uniform.launches
    out = trm.random_uniform(keys.to(cuda_device), n, offset)
    torch.cuda.synchronize()
    assert trm.random_uniform.launches == before + 1
    assert torch.equal(out.cpu(), trm.random_uniform_plain(keys, n, offset))
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0


@pytest.mark.cuda
def test_cuda_keyed_wire_quant_draws_through_the_kernel(cuda_device):
    """The mixed-width wire's ``wire_quant(x, w, key=keys)`` on the card:
    one ``random_uniform`` launch for all hops, bitwise the CPU's."""
    from repro_torch.kernels import randmask as trm

    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 3, 50, 256)).astype(np.float32))
    w = torch.tensor([8.0, 4.0, 32.0])[None, :, None, None].expand(4, 3, 1, 1)
    keys = _round_keys(12, 7).reshape(4, 3, 2)
    before = trm.random_uniform.launches
    got = tops.wire_quant(x.to(cuda_device), w.to(cuda_device), key=keys)
    torch.cuda.synchronize()
    assert trm.random_uniform.launches == before + 1
    assert torch.equal(got.cpu(), tops.wire_quant(x, w, key=keys))


# ---------------------------------------------------------------------------
# The dense wire's random element mask
# ---------------------------------------------------------------------------


def _mask_keys(q, seed):
    from repro_torch import prng
    from repro_torch.kernels.randmask import keys_tensor

    k = prng.fold_in(prng.key(seed), 3)
    return keys_tensor(np.stack([prng.fold_in(k, j) for j in range(q)]),
                       "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("q,b,f", [(4, 1000, 256), (4, 1000, 128),
                                   (3, 77, 42), (1, 1, 1)])
@pytest.mark.parametrize("rate,unbiased", [(2.0, False), (4.0, True),
                                           (5.3, False), (1.0, False)])
def test_cuda_random_mask_matches_plain(cuda_device, q, b, f, rate,
                                        unbiased):
    """Mask, output and kept counts bitwise, on the float4 path (F % 4
    == 0) and the scalar one, with the launch counted once."""
    from repro_torch.kernels import randmask as trm

    x = torch.from_numpy(np.random.default_rng(b + f).normal(
        size=(q, b, f)).astype(np.float32))
    keys = _mask_keys(q, b)
    p = float(np.float32(1.0) / np.float32(rate))
    scale = float(np.float32(rate)) if unbiased else 1.0
    before = trm.random_mask.launches
    out, counts = trm.random_mask(x.to(cuda_device), keys.to(cuda_device),
                                  p, scale, count=True)
    torch.cuda.synchronize()
    assert trm.random_mask.launches == before + 1
    ref, ref_counts = trm.random_mask_plain(x, keys, p, scale, count=True)
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(counts.cpu(), ref_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n", [(1, 4 * 49155), (4, 1000), (3, 1001),
                                 (1, 1)])
@pytest.mark.parametrize("rate,unbiased", [(4.0, False), (5.3, True),
                                           (1.0, False)])
def test_cuda_random_mask_bf16_matches_plain(cuda_device, q, n, rate,
                                             unbiased):
    """The bf16 instantiation (gradient leaves of the bf16 LM configs):
    output bitwise, bf16 out, kept counts equal, on the 8-byte path and
    the scalar one; both launch counters move by one."""
    from repro_torch.kernels import randmask as trm

    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(q, n)).astype(np.float32)).to(torch.bfloat16)
    keys = _mask_keys(q, n)
    p = float(np.float32(1.0) / np.float32(rate))
    scale = float(np.float32(rate)) if unbiased else 1.0
    before = (trm.random_mask.launches, trm.random_mask.bf16_launches)
    out, counts = trm.random_mask(x.to(cuda_device), keys.to(cuda_device),
                                  p, scale, count=True)
    torch.cuda.synchronize()
    assert (trm.random_mask.launches, trm.random_mask.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, ref_counts = trm.random_mask_plain(x, keys, p, scale, count=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.cpu().view(torch.int16), ref.view(torch.int16))
    assert torch.equal(counts.cpu(), ref_counts)


@pytest.mark.cuda
def test_cuda_random_mask_counter_past_2_32(cuda_device):
    """A block of more than 2^32 elements, reached by the counter offset:
    the high counter word carries on the card as in the plain version."""
    from repro_torch.kernels import randmask as trm

    x = torch.ones((2, 4096), device=cuda_device)
    keys = _mask_keys(2, 1).to(cuda_device)
    off = 2 ** 32 - 2048
    out, counts = trm.random_mask(x, keys, 0.5, 1.0, offset=off, count=True)
    ref, ref_counts = trm.random_mask_plain(x.cpu(), keys.cpu(), 0.5, 1.0,
                                            offset=off, count=True)
    assert torch.equal(out.cpu(), ref) and torch.equal(counts.cpu(),
                                                       ref_counts)
    lo, _ = trm.random_mask_plain(x.cpu(), keys.cpu(), 0.5, 1.0)
    assert not torch.equal(ref, lo)       # the offset moved the stream


@pytest.mark.cuda
def test_cuda_random_mask_vjp(cuda_device):
    """The backward is the same kernel on the cotangent: bitwise the
    plain version's autograd, and the launch count moves by two."""
    from repro_torch.kernels import randmask as trm

    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 300, 256)).astype(np.float32))
    keys = _mask_keys(4, 9)
    args = (keys, float(np.float32(0.25)), 4.0)
    before = trm.random_mask.launches
    (y, gx), (y_ref, gx_ref) = _grad_pair(
        lambda a, k: tops.random_mask(a, k, *args[1:])[0],
        [x, keys], cuda_device, 5)
    assert trm.random_mask.launches == before + 2
    assert torch.equal(y, y_ref) and torch.equal(gx, gx_ref)


@pytest.mark.cuda
def test_cuda_dense_varco_step_matches_cpu(cuda_device):
    """One dense-wire ``varco:linear:5`` step (the paper's random mask) on
    the card against the same step on the CPU, within 1e-4 (atomic
    scatters and FMA contraction reorder f32 sums), the mask kernel
    launched 5 times (3 forward exchanges, 2 cotangents: the raw
    features need none)."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as tgp
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.kernels import randmask as trm
    from repro_torch.nn.gnn import GNNConfig, init_gnn, params_to
    from repro_torch.train.optim import sgd, tree_leaves

    g = tiny_graph(n=512, feat_dim=128)
    cfg = GNNConfig(in_dim=128, hidden=256, out_dim=g.num_classes, layers=3)
    pg = partition_graph(g, 4, seed=0)
    pol = CommPolicy.parse("varco:linear:5", 100)
    init = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    results = []
    for dev in ("cpu", cuda_device):
        params = params_to(init, dev)
        meta = tgp.DistMeta.build(pg, params, wire="dense")
        opt = sgd(0.1, momentum=0.9)
        step = tgp.make_train_step(cfg, pol, opt, meta)
        before = trm.random_mask.launches
        new, _, m = step(params, opt.init(params), pg.device_arrays(dev), 3,
                         prng.key(3))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert trm.random_mask.launches == before + 5
        results.append((new, m))
    (pc, mc), (pg_, mg) = results
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-4
    assert float(mc["halo_bits"]) == float(mg["halo_bits"])
    for a, b in zip(tree_leaves(pc), tree_leaves(pg_)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# LM kernels: flash attention and the SSD chunk form
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 4, 2, 256, 64, True, 0),       # GQA 2:1
    (1, 2, 2, 384, 256, True, 0),      # gemma-sized heads
    (1, 8, 1, 200, 128, True, 0),      # MQA, ragged S
    (2, 4, 4, 130, 64, True, 64),      # window, ragged S
    (1, 4, 2, 300, 32, True, 200),     # window wider than a tile
    (1, 4, 2, 100, 64, False, 0),      # non-causal, ragged S
    (1, 2, 1, 77, 16, True, 20),
])
def test_cuda_flash_matches_plain(cuda_device, dtype, b, h, kv, s, d, causal,
                                  window):
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    # the model's layout [B, S, H, D], handed over as strided views
    q = torch.randn((b, s, h, d), generator=gen, device=cuda_device,
                    dtype=dtype).transpose(1, 2)
    k = torch.randn((b, s, kv, d), generator=gen, device=cuda_device,
                    dtype=dtype).transpose(1, 2)
    v = torch.randn((b, s, kv, d), generator=gen, device=cuda_device,
                    dtype=dtype).transpose(1, 2)
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_moved(before) == tfa.kernel_for(dtype, d)
    assert out.dtype == dtype and out.stride() == q.stride()
    ref = tfa.flash_attention_plain(q, k, v, causal, window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _flash_counts() -> dict:
    return {kind: fn.launches for kind, fn in tfa._KERNELS.items()}


def _flash_moved(before) -> str:
    """Which flash kernel launched once since ``before`` (the other two
    must not have moved)."""
    after = _flash_counts()
    moved = {kind: after[kind] - before[kind] for kind in after}
    assert sorted(moved.values()) == [0, 0, 1], moved
    return max(moved, key=moved.get)


#: (b, h, kv, s, causal, window) of the CUDA-core and narrow-head kernels'
#: own cases: ragged S across their query tiles (64 / 128 rows) and key
#: tiles (32 / 64 keys), S under one tile, GQA and MQA, windows narrower
#: and wider than a tile, non-causal
_NARROW_CASES = [
    (2, 4, 2, 256, True, 0), (1, 8, 1, 1000, True, 0),
    (2, 4, 4, 130, True, 64), (1, 4, 2, 300, True, 200),
    (1, 4, 2, 100, False, 0), (1, 2, 1, 77, True, 20),
    (1, 2, 2, 1, True, 0), (1, 4, 2, 40, True, 0),
    (2, 8, 2, 2048, True, 1024), (1, 8, 2, 300, False, 200),
    (1, 4, 4, 127, True, 0), (2, 8, 4, 520, True, 0),
]


def _bshd_or_bhsd(gen, dev, dtype, b, s, n, d, layout):
    shape = (b, s, n, d) if layout == "bshd" else (b, n, s, d)
    t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    return t.transpose(1, 2) if layout == "bshd" else t


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,h,kv,s,causal,window", _NARROW_CASES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_simt_matches_plain(cuda_device, d, b, h, kv, s, causal,
                                       window, layout):
    """The CUDA-core kernel (f32 at every head dim) against the plain
    version within 2e-5, the model's [B, S, H, D] views and contiguous
    [B, H, S, D] tensors, the output in q's strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + h)
    q, k, v = (_bshd_or_bhsd(gen, cuda_device, torch.float32, b, s, n, d,
                             layout) for n in (h, kv, kv))
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_moved(before) == "simt"
    assert out.dtype == torch.float32 and out.stride() == q.stride()
    ref = tfa.flash_attention_plain(q, k, v, causal, window)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("b,h,kv,s,causal,window", _NARROW_CASES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_mma_matches_plain(cuda_device, d, b, h, kv, s, causal,
                                      window, layout):
    """The narrow-head tensor-core kernel (bf16 at D in {16, 32}) against
    the plain version within 2e-2 (one bf16 ulp of the output, and the
    rounding of P to bf16), the output in q's strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + h)
    q, k, v = (_bshd_or_bhsd(gen, cuda_device, torch.bfloat16, b, s, n, d,
                             layout) for n in (h, kv, kv))
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_moved(before) == "mma"
    assert out.dtype == torch.bfloat16 and out.stride() == q.stride()
    ref = tfa.flash_attention_plain(q, k, v, causal, window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_kernels_refuse_each_others_inputs(cuda_device):
    """Each flash kernel refuses the dtype and head dims of the other two
    with ValueError (no kernel runs another's cases), and the cp.async
    kernels refuse views they cannot read in 16-byte pieces."""
    f32 = torch.zeros((1, 2, 64, 64), device=cuda_device)
    bf = {d: torch.zeros((1, 2, 64, d), device=cuda_device,
                         dtype=torch.bfloat16) for d in (16, 32, 64, 128)}
    refusals = [(tfa.flash_attention_simt, bf[16]),
                (tfa.flash_attention_simt, bf[64]),
                (tfa.flash_attention_mma, f32),
                (tfa.flash_attention_mma, f32[..., :32]),
                (tfa.flash_attention_mma, bf[64]),
                (tfa.flash_attention_mma, bf[128]),
                (tfa.flash_attention_wgmma, bf[16]),
                (tfa.flash_attention_wgmma, bf[32]),
                (tfa.flash_attention_wgmma, f32)]
    before = _flash_counts()
    for fn, t in refusals:
        with pytest.raises(ValueError, match="takes"):
            fn(t, t, t)
    wide = torch.zeros((1, 2, 64, 72), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_simt(*(wide[..., 1:65],) * 3)
    wide = wide.bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_mma(*(wide[..., 1:33],) * 3)
    assert _flash_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d", [("simt", 16), ("simt", 32),
                                    ("simt", 64), ("simt", 128),
                                    ("simt", 256), ("mma", 16), ("mma", 32)])
def test_cuda_flash_kernel_tiles_and_occupancy(cuda_device, kind, d):
    """The built library's tiles are the ones the position key ranges are
    built at, and the CUDA-core kernel keeps at least 2 blocks on an SM at
    D <= 128."""
    got = tfa.kernel_config(kind, d, cuda_device)
    assert (got["q_tile"], got["key_tile"]) == tfa._tiles(kind, d)
    assert got["blocks_per_sm"] >= (2 if d <= 128 else 1), got


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", [
    (2, 8, 8, 1024, 64, True, 0),      # MHA (group 1)
    (2, 16, 4, 1024, 64, True, 0),     # GQA group 4
    (1, 32, 4, 1024, 128, True, 0),    # GQA group 8
    (1, 8, 2, 1024, 256, True, 0),     # gemma-sized heads, group 4
    (1, 8, 8, 768, 64, False, 0),      # non-causal
    (1, 8, 2, 640, 128, False, 0),
    (1, 4, 4, 512, 256, False, 0),
    (2, 8, 2, 2048, 64, True, 1024),   # window 1024
    (1, 8, 4, 2048, 128, True, 1024),
    (1, 4, 2, 1300, 256, True, 1024),
    (1, 8, 1, 1000, 64, True, 0),      # ragged S, MQA
    (2, 8, 2, 1000, 128, False, 0),
    (1, 4, 4, 127, 256, True, 0),      # ragged, under one query tile
    (1, 8, 2, 127, 64, False, 0),
    (1, 4, 1, 40, 128, True, 0),       # S < one key tile
    (1, 2, 2, 1, 64, True, 0),
    (1, 8, 2, 300, 64, False, 200),    # window without causality
])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_wgmma_matches_plain(cuda_device, b, h, kv, s, d, causal,
                                        window, layout):
    """The tensor-core kernel (bf16, D in {64, 128, 256}) against the plain
    version: the model's [B, S, H, D] tensors as strided views and
    contiguous [B, H, S, D] ones, the output in q's strides."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + h)

    def make(n):
        shape = (b, s, n, d) if layout == "bshd" else (b, n, s, d)
        t = torch.randn(shape, generator=gen, device=cuda_device,
                        dtype=torch.bfloat16)
        return t.transpose(1, 2) if layout == "bshd" else t

    q, k, v = make(h), make(kv), make(kv)
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_moved(before) == "wgmma"
    assert out.dtype == torch.bfloat16 and out.stride() == q.stride()
    ref = tfa.flash_attention_plain(q, k, v, causal, window)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_wgmma_reads_wide_views(cuda_device):
    """q, k and v as column slices of wider [B, S, ·] buffers (as a fused
    projection would hand them over): TMA reads them in place through
    their strides, and the output is dense in q's dim order."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    b, s, h, kv, d = 2, 300, 8, 2, 128
    wide = torch.randn((b, s, (h + 2 * kv) * d), generator=gen,
                       device=cuda_device, dtype=torch.bfloat16)
    q = wide[..., :h * d].unflatten(-1, (h, d)).transpose(1, 2)
    k = wide[..., h * d:(h + kv) * d].unflatten(-1, (kv, d)).transpose(1, 2)
    v = wide[..., (h + kv) * d:].unflatten(-1, (kv, d)).transpose(1, 2)
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert _flash_moved(before) == "wgmma"
    assert out.transpose(1, 2).is_contiguous()
    ref = tfa.flash_attention_plain(q, k, v, True, 0)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    # refuses a view TMA cannot address rather than read it wrongly
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_wgmma(q[..., 1:65], k[..., 1:65], v[..., 1:65])


def _position_rows(b, s, seed):
    """int32 [B, S] prompt positions: shifted, left-padded (a run of
    repeated 0s) and a repeated run inside a row, in turn."""
    rng = np.random.default_rng(seed)
    rows = [np.arange(s) + rng.integers(1, 50),
            np.maximum(np.arange(s) - rng.integers(1, max(s // 2, 2)), 0),
            np.minimum(np.arange(s), s // 3 + rng.integers(0, s // 3 + 1))]
    return torch.from_numpy(np.stack([rows[i % 3] for i in range(b)])
                            .astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 128),
                                     (torch.float32, 32)])
@pytest.mark.parametrize("b,s,window", [(3, 300, 0), (3, 1000, 0),
                                        (2, 520, 100), (3, 40, 0)])
def test_cuda_flash_with_positions_matches_plain(cuda_device, dtype, d, b, s,
                                                 window):
    """Position masks (the JAX package's prefill mask) on both kernels:
    shifted, left-padded and repeated-run rows against the plain version,
    and the kernel that ``kernel_for`` names launched once."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=cuda_device,
                           dtype=dtype).transpose(1, 2) for n in (8, 2, 2))
    pos = _position_rows(b, s, s + window).to(cuda_device)
    before = _flash_counts()
    out = tops.mha(q, k, v, causal=True, window=window, q_pos=pos,
                   k_pos=pos)
    torch.cuda.synchronize()
    assert _flash_moved(before) == tfa.kernel_for(dtype, d)
    ref = tfa.flash_attention_plain(q, k, v, True, window, pos, pos)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # arange + c rows: the position mask is the index mask
    shifted = (torch.arange(s, device=cuda_device, dtype=torch.int32) +
               7).expand(b, s).contiguous()
    got = tops.mha(q, k, v, causal=True, window=window, q_pos=shifted,
                   k_pos=shifted)
    torch.testing.assert_close(got.float(), tops.mha(
        q, k, v, causal=True, window=window).float(), rtol=tol, atol=tol)


def _ssd_inputs(gen, dev, b, nc, q, h, p, g, n):
    """x, dt, cum, B, C as the model hands them over: x, B and C strided
    views of one conv-output-like buffer."""
    wide = torch.randn((b, nc, q, h * p + 2 * g * n + 8), generator=gen,
                       device=dev)
    x = wide[..., :h * p].reshape(b, nc, q, h, p)
    bm = wide[..., h * p:h * p + g * n].reshape(b, nc, q, g, n)
    cm = wide[..., h * p + g * n:h * p + 2 * g * n].reshape(b, nc, q, g, n)
    dt = torch.rand((b, nc, q, h), generator=gen, device=dev) * 0.099 + 1e-3
    a = -torch.exp(torch.rand((h,), generator=gen, device=dev) * 2 - 1)
    cum = torch.cumsum(dt * a, dim=2)
    return x, dt, cum, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("b,nc,q,h,p,g,n", [
    (8, 8, 256, 24, 64, 1, 128),       # mamba2-130m's prefill
    (2, 3, 100, 4, 32, 2, 16),         # two groups, ragged Q
    (1, 2, 64, 8, 16, 8, 32),          # one group per head
    (1, 1, 70, 2, 128, 1, 256),        # wide head and state
    (2, 3, 100, 6, 64, 2, 128),        # G = 2, H/G = 3, ragged Q
    (2, 2, 130, 6, 72, 3, 36),         # N, P not multiples of 64
    (1, 2, 448, 4, 64, 2, 128),        # the longest chunk
])
def test_cuda_ssd_chunk_matches_plain(cuda_device, b, nc, q, h, p, g, n):
    gen = torch.Generator(device=cuda_device).manual_seed(q + n)
    args = _ssd_inputs(gen, cuda_device, b, nc, q, h, p, g, n)
    before = tssd.ssd_chunk.launches
    y, st = tops.ssd_chunk(*args)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.launches == before + 1
    y_ref, st_ref = tssd.ssd_chunk_plain(*args)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_ssd_chunk_reads_unaligned_views(cuda_device):
    """x, B and C at a 4-byte offset in their buffer (no 16-byte copies
    possible) take the kernel's 4-byte copy path and still match."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, nc, q, h, p, g, n = 2, 3, 100, 6, 64, 2, 128
    wide = torch.randn((b, nc, q, h * p + 2 * g * n + 1), generator=gen,
                       device=cuda_device)[..., 1:]
    x = wide[..., :h * p].reshape(b, nc, q, h, p)
    bm = wide[..., h * p:h * p + g * n].reshape(b, nc, q, g, n)
    cm = wide[..., h * p + g * n:].reshape(b, nc, q, g, n)
    dt = torch.rand((b, nc, q, h), generator=gen, device=cuda_device) * 0.099 \
        + 1e-3
    cum = torch.cumsum(-dt, dim=2)
    assert x.data_ptr() % 16
    y, st = tssd.ssd_chunk(x, dt, cum, bm, cm)
    y_ref, st_ref = tssd.ssd_chunk_plain(x, dt, cum, bm, cm)
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(st, st_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_lm_wrappers_refuse_bad_inputs(cuda_device):
    q = torch.zeros((1, 2, 64, 64), device=cuda_device)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(2, 3)
        tfa.flash_attention(qt, qt, qt)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q.cpu(), q)
    pos = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="both"):
        tfa.flash_attention(q, q, q, q_pos=pos)
    with pytest.raises(ValueError, match="int32"):
        tfa.flash_attention(q, q, q, q_pos=pos.long(), k_pos=pos.long())
    x = torch.zeros((1, 1, 16, 4, 8), device=cuda_device)
    dt = torch.zeros((1, 1, 16, 4), device=cuda_device)
    bm = torch.zeros((1, 1, 16, 3, 8), device=cuda_device)
    with pytest.raises(ValueError, match="G \\| H"):
        tssd.ssd_chunk(x, dt, dt, bm, bm)
    with pytest.raises(TypeError):
        tssd.ssd_chunk(x.double(), dt, dt, bm[:, :, :, :1], bm[:, :, :, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m",
                                  "qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_cuda_lm_serving_matches_cpu(cuda_device, arch):
    """The smoke config's prefill (kernels) and three decode steps on the
    card against the same weights on the CPU (plain versions), within
    1e-4 (f32 sums in another order through two layers); the MoE configs
    route every token to the same experts on both (f32 router logits
    differ by ulps, far from a tie), and jamba's hybrid pattern runs one
    flash and one SSD launch per prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import init_lm

    cfg = get_config(arch, smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (2, 128))
    counter = tfa._KERNELS[tfa.kernel_for(cfg.adtype,
                                          cfg.resolved_head_dim)]
    counters = (counter.launches, tssd.ssd_chunk.launches)
    got = serve(cfg, on_card, prompts, 4, device=cuda_device)
    launched = (counter.launches - counters[0],
                tssd.ssd_chunk.launches - counters[1])
    assert launched == (cfg.n_blocks * cfg.pattern.count("attn"),
                        cfg.n_blocks * cfg.pattern.count("mamba"))
    want = serve(cfg, params, prompts, 4, device="cpu")
    torch.testing.assert_close(got.prefill_logits.cpu(), want.prefill_logits,
                               rtol=0, atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["varco:linear:5", "auto:budget:3e7:w8"])
def test_cuda_shard_fault_run_matches_cpu(cuda_device, spec, tmp_path):
    """A shard-backed ``train_gnn`` under faults (drops, DEAD pairs, a
    crash of worker 1 at epoch 3) and a checkpoint/resume on the card:
    the kernels' launch counters move (the fused codecs under w8), and
    every epoch's loss matches the CPU run's within 1e-4 (atomic scatters
    reorder f32 sums)."""
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist.faults import FaultSchedule
    from repro_torch.graph import stream as ts
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.train.trainer import train_gnn

    st = ts.write_graph_store(tiny_graph(n=512, feat_dim=128),
                              tmp_path / "store")
    shards = ts.write_shards(st, ts.stream_partition(st, 4, "metis-like"),
                             tmp_path / "shards")
    ep = 6

    def run(device, **kw):
        return train_gnn(shards, policy=CommPolicy.parse(
            spec, ep, compressor="blockmask"), epochs=ep, hidden=256,
            layers=2, eval_every=1, wire="p2p", device=device,
            faults=FaultSchedule(q=4, seed=0, drop_rate=0.25,
                                 spike_rate=0.05, crash_at=((3, 1),)),
            fault_max_stale=2, **kw)

    names = ["ell_spmm", "varco_pack", "varco_unpack"]
    if spec.endswith("w8"):
        names += ["varco_pack_quant", "varco_unpack_quant"]
    fns = {"ell_spmm": tell.ell_spmm, "varco_pack": tvp.varco_pack,
           "varco_unpack": tvp.varco_unpack,
           "varco_pack_quant": tvp.varco_pack_quant,
           "varco_unpack_quant": tvp.varco_unpack_quant}
    before = {n: fns[n].launches for n in names}
    got = run("cuda")
    for n in names:
        assert fns[n].launches > before[n], n
    want = run("cpu")
    assert got.meta.q == want.meta.q == 3
    np.testing.assert_allclose(got.history.loss, want.history.loss,
                               rtol=0, atol=1e-4)
    ck = str(tmp_path / "ck")
    run("cuda", checkpoint_dir=ck, stop_after=4)
    resumed = run("cuda", checkpoint_dir=ck, resume=True)
    np.testing.assert_allclose(resumed.history.loss, got.history.loss[4:],
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m",
                                  "qwen2-moe-a2.7b"])
def test_cuda_lm_train_step_matches_cpu(cuda_device, arch):
    """Two ``make_train_step`` steps of the smoke config (remat on) on the
    card against the same weights, state and batch on the CPU: losses and
    gradient norms within 1e-4, each moment leaf within 1e-4 of its
    largest magnitude and each parameter leaf within 1e-4 of its norm
    (AdamW's normalised update turns the sum-order error of a near-zero
    gradient entry into up to lr); the training path launches no LM
    kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optim import tree_leaves

    cfg = get_config(arch, smoke=True).with_(remat=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(cfg, lr=1e-3)
    step = make_train_step(cfg, opt)
    batches = [next(TokenPipeline(cfg.vocab_size, 2, 128, seed=s,
                                  device="cpu"))["tokens"] for s in (0, 1)]
    before = (_flash_counts(), tssd.ssd_chunk.launches)
    p_c, s_c = _to(params, cuda_device), opt.init(_to(params, cuda_device))
    p_h, s_h = params, opt.init(params)
    for toks in batches:
        p_c, s_c, m_c = step(p_c, s_c, {"tokens": toks.to(cuda_device)})
        p_h, s_h, m_h = step(p_h, s_h, {"tokens": toks})
        for k in ("loss", "grad_norm"):
            assert m_c[k].device.type == "cuda"
            assert abs(float(m_c[k]) - float(m_h[k])) <= 1e-4 * max(
                1.0, abs(float(m_h[k]))), k
    for a, b in zip(tree_leaves(p_c), tree_leaves(p_h)):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(s_c[name]), tree_leaves(s_h[name])):
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
                b.abs().max())
    assert (_flash_counts(), tssd.ssd_chunk.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,q", [("granite-3-2b", 4),
                                    ("granite-3-2b", 1),
                                    ("qwen2-moe-a2.7b", 2)])
def test_cuda_varco_dp_step_matches_cpu(cuda_device, arch, q):
    """Two ``make_varco_dp_train_step`` steps (``varco:linear:5``, Q
    emulated workers) on the card against the CPU from the same weights:
    the masks are the same Threefry draws, so ``grad_bits`` and the rate
    are equal and the losses, gradient norms and parameters agree within
    1e-4 (each parameter leaf by its norm); ``random_mask`` launches once
    a leaf, a worker and a step."""
    from repro_torch import prng
    from repro_torch.configs.base import get_config
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist.grad_compress import (make_dp_mesh,
                                                make_varco_dp_train_step)
    from repro_torch.kernels import randmask as trm
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.optim import tree_leaves

    cfg = get_config(arch, smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(cfg, lr=1e-3)
    policy = CommPolicy.parse("varco:linear:5", 4)
    steps = {dev: make_varco_dp_train_step(cfg, opt, policy,
                                           make_dp_mesh(q, device=dev))
             for dev in (cuda_device, "cpu")}
    batches = [next(TokenPipeline(cfg.vocab_size, 4, 64, seed=s,
                                  device="cpu"))["tokens"] for s in (0, 1)]
    p_c, s_c = _to(params, cuda_device), opt.init(_to(params, cuda_device))
    p_h, s_h = params, opt.init(params)
    before = trm.random_mask.launches
    for i, toks in enumerate(batches):
        p_c, s_c, m_c = steps[cuda_device](
            p_c, s_c, {"tokens": toks.to(cuda_device)}, i, prng.key(i))
        p_h, s_h, m_h = steps["cpu"](p_h, s_h, {"tokens": toks}, i,
                                     prng.key(i))
        assert float(m_c["grad_bits"]) == float(m_h["grad_bits"])
        assert float(m_c["rate"]) == float(m_h["rate"])
        for k in ("loss", "grad_norm"):
            assert abs(float(m_c[k]) - float(m_h[k])) <= 1e-4 * max(
                1.0, abs(float(m_h[k]))), k
    assert trm.random_mask.launches - before == \
        2 * q * len(tree_leaves(params))
    for a, b in zip(tree_leaves(p_c), tree_leaves(p_h)):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())


@pytest.mark.cuda
def test_cuda_incremental_recompute_matches_cpu(cuda_device):
    """A streaming edge batch's frontier recompute on the card against the
    CPU: the same frontiers, the patched stack within 1e-5 (atomic
    ``index_add_`` reorders f32 sums)."""
    from repro_torch.graph.data import normalized_edge_weights
    from repro_torch.graph.synthetic import citation_graph
    from repro_torch.nn.gnn import (GNNConfig, centralized_aggregate_fn,
                                    centralized_forward, gnn_forward,
                                    init_gnn, params_to)
    from repro_torch.serve.update import (apply_edge_updates,
                                          incremental_recompute)

    g = citation_graph(n=2000, feat_dim=128, seed=0)
    cfg = GNNConfig(conv="sage", in_dim=128, hidden=128,
                    out_dim=g.num_classes, layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    dst0, src0 = g.edge_list()
    pick = rng.integers(0, len(dst0), 20)
    g2, touched = apply_edge_updates(
        g, inserts=(rng.integers(0, 2000, 20), rng.integers(0, 2000, 20)),
        deletes=(dst0[pick], src0[pick]))
    hidden = []
    d, s = g.edge_list()
    agg = centralized_aggregate_fn(
        g.num_nodes, torch.from_numpy(d), torch.from_numpy(s),
        torch.from_numpy(normalized_edge_weights(g).astype(np.float32)))
    gnn_forward(params, cfg, torch.from_numpy(g.features), agg,
                hidden_out=hidden)
    hidden = [h.numpy() for h in hidden]
    got, f_c = incremental_recompute(params, cfg, g2, hidden, touched,
                                     device=cuda_device)
    want, f_h = incremental_recompute(params, cfg, g2, hidden, touched,
                                      device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(f_c, f_h))
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    fresh = centralized_forward(params_to(params, cuda_device), cfg, g2,
                                device=cuda_device)
    torch.testing.assert_close(got[-1], fresh, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_worker_backend_step_matches_emulated(cuda_device):
    """Two worker processes sharing the card over host-staged ``gloo`` run
    one p2p ``varco`` step (``make_train_step(mesh=...)``) that matches
    the emulated step on the card within 1e-4 (atomic scatters and the
    all-reduced gradients reorder f32 sums); NCCL with two workers on one
    card raises instead of switching backend."""
    from repro_torch import prng
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.nn.gnn import GNNConfig, init_gnn
    from repro_torch.train import optim

    import torch_dist_cases as cases

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="backend='gloo'"):
            gp.make_worker_mesh(2, backend="nccl")
    got = gp.spawn_workers(cases.card_step, 2, device=cuda_device,
                           backend="gloo")
    g = tiny_graph(n=cases.N, feat_dim=cases.F)
    pg = partition_graph(g, 2, seed=0)
    graph = attach_p2p(pg.device_arrays(cuda_device), pg, cuda_device)
    cfg = GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                    out_dim=g.num_classes, layers=cases.LAYERS)
    params = init_gnn(cfg, torch.Generator().manual_seed(0),
                      device=cuda_device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    opt = optim.sgd(cases.LR)
    step = gp.make_train_step(cfg, cases.case_policy("varco:linear:5",
                                                     "blockmask"), opt, meta)
    params, _, m = step(params, opt.init(params), graph, 0, prng.key(0))
    assert abs(got["loss"] - float(m["loss"])) <= 1e-4
    assert got["halo_bits"] == float(m["halo_bits"])
    for a, b in zip(got["params"], optim.tree_leaves(params)):
        torch.testing.assert_close(a, b.cpu(), rtol=0, atol=1e-4)
    assert all(n > 0 for n in got["launches"].values()), got["launches"]


@pytest.mark.cuda
def test_cuda_worker_backend_auto_step_matches_emulated(cuda_device):
    """Two worker processes on the card over ``gloo``: one p2p
    ``auto:budget:…:w8`` step (``make_auto_train_step(mesh=...)``) under a
    w8 plan, rounded stochastically (the card's default), launches the
    stochastic codec and ``varco_unpack_quant`` in the worker, leaves the
    emulated step's first residual slab bitwise (the same per-row keys)
    and its loss within 1e-4."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.dist.ratectl import (init_wire_residuals,
                                          make_auto_train_step)
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.nn.gnn import GNNConfig, init_gnn
    from repro_torch.train import optim

    import torch_dist_cases as cases

    got = gp.spawn_workers(cases.card_auto_step, 2, device=cuda_device,
                           backend="gloo")
    g = tiny_graph(n=cases.N, feat_dim=cases.F)
    pg = partition_graph(g, 2, seed=0)
    graph = attach_p2p(pg.device_arrays(cuda_device), pg, cuda_device)
    cfg = GNNConfig(conv="sage", in_dim=cases.F, hidden=cases.HIDDEN,
                    out_dim=g.num_classes, layers=cases.LAYERS)
    params = init_gnn(cfg, torch.Generator().manual_seed(0),
                      device=cuda_device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    opt = optim.sgd(cases.LR)
    step = make_auto_train_step(cfg, CommPolicy.parse("auto:budget:1e9:w8",
                                                      1), opt, meta)
    _, _, m, cache = step(params, opt.init(params), graph, prng.key(0),
                          cases.fixed_plan("w8", 2),
                          init_wire_residuals(meta, cfg, cuda_device))
    assert abs(got["loss"] - float(m["loss"])) <= 1e-4
    assert torch.equal(got["resid"][0], cache[0][0].cpu())
    assert all(n > 0 for n in got["launches"].values()), got["launches"]


@pytest.mark.cuda
def test_cuda_worker_backend_fault_step_matches_emulated(cuda_device):
    """Two worker processes on the card over ``gloo``: one p2p ``varco``
    fault step (``make_fault_train_step(mesh=...)``) with a CACHED and a
    DEAD pair launches ``ell_spmm``, ``varco_pack`` and ``varco_unpack``
    in the worker, matches the emulated step's loss within 1e-4, and
    serves rank 0's cache as the emulated step does: the first exchange
    bitwise, the second within 1e-4 (its input comes through the remote
    scatter's atomics)."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.faults import (_cache_send_to_recv,
                                         make_fault_train_step)
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import tiny_graph
    from repro_torch.nn.gnn import init_gnn
    from repro_torch.train import optim

    import torch_dist_cases as cases

    got = gp.spawn_workers(cases.card_fault_step, 2, device=cuda_device,
                           backend="gloo")
    g = tiny_graph(n=cases.N, feat_dim=cases.F)
    pg = partition_graph(g, 2, seed=0)
    graph = attach_p2p(pg.device_arrays(cuda_device), pg, cuda_device)
    cfg = cases.fault_cfg(g.num_classes)
    params = init_gnn(cfg, torch.Generator().manual_seed(0),
                      device=cuda_device)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    opt = optim.sgd(cases.LR)
    spec = "varco:linear:5"
    step = make_fault_train_step(cfg, CommPolicy.parse(
        spec, cases.FAULT_EPOCHS, compressor="blockmask"), opt, meta)
    fskip, dead = cases.fault_masks(2)[0]
    _, _, m, _, served = step(
        params, opt.init(params), graph, prng.key(0),
        cases.fault_plan(spec, 2), fskip, dead, (),
        tuple(c.to(cuda_device) for c in cases.random_fcache(meta, cfg)))
    assert abs(got["loss"] - float(m["loss"])) <= 1e-4
    for e, (a, b) in enumerate(zip(got["fcache"], served, strict=True)):
        want = _cache_send_to_recv(b, 2)[0:1].cpu()
        if e == 0:
            assert torch.equal(a, want)
        else:
            torch.testing.assert_close(a, want, rtol=0, atol=1e-4)
    assert all(n > 0 for n in got["launches"].values()), got["launches"]


@pytest.mark.cuda
def test_cuda_group_lm_dp_step_matches_emulated(cuda_device):
    """Two worker processes sharing the card over host-staged ``gloo`` run
    one ``varco:linear:5`` step of granite's smoke config (f32) through
    ``make_varco_dp_train_step`` over the group: ``grad_bits`` equal to
    the emulated ``DPMesh(2)`` step's on the card, loss and parameters
    within 1e-4 (the embedding backward's atomics reorder f32 sums), the
    replicas bitwise equal, and ``random_mask`` launched once a gradient
    leaf on each worker (no bf16 launch: the smoke config is f32)."""
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.grad_compress import make_dp_mesh
    from repro_torch.train import optim

    import torch_dist_cases as cases

    got = gp.spawn_workers(cases.card_lm_dp_step, 2, device=cuda_device,
                           backend="gloo")
    cfg, params, toks = cases.lm_setup("granite-3-2b", device=cuda_device)
    want = cases.run_lm_dp(cfg, params, toks[:1], "varco:linear:5",
                           make_dp_mesh(2, device=cuda_device),
                           cuda_device)[0]
    gm, wm = got["metrics"], want["metrics"]
    assert gm["grad_bits"] == wm["grad_bits"] > 0
    assert gm["rate"] == wm["rate"] == 128.0
    assert abs(gm["loss"] - wm["loss"]) <= 1e-4 * abs(wm["loss"])
    for a, b in zip(got["params"], want["params"], strict=True):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.norm()))
    assert got["replicas_equal"]
    n_leaves = len(optim.tree_leaves(params))
    assert got["launches"] == [{"random_mask": n_leaves,
                                "random_mask_bf16": 0}] * 2

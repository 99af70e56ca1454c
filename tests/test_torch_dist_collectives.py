"""The activation half of the port's collectives over real process groups
(``gloo``, Q ∈ {2, 4} worker processes on the CPU) against the port's
emulated wires and against the JAX package's collectives under
``shard_map``.

* ``compressed_all_gather`` (``randmask`` at rate 4), ``packed_all_gather``
  (rate 2) and the neighbour exchange, unpacked and packed (rate 2), each
  worker with its own seeded numpy block: the forward bitwise and the
  bits exactly against the emulated wires (the batched compressor under
  every worker's ``fold_in`` key; ``wire_pack`` / ``wire_unpack`` over
  the ``[Q, B, F]`` stack; every sender's hop rows routed to their
  receivers), the same outputs from the calls without the bits'
  all-reduce (``group_bits=False``, as the runtime makes them), and each
  worker's input cotangent within 1e-6 of the
  emulated VJP (the all-gather's cotangents summed over the receivers in
  another order; the hops' exact);
* the same outputs bitwise and bits exactly against JAX's
  ``compressed_all_gather`` / ``packed_all_gather`` / ``neighbor_exchange``
  under ``shard_map`` on 2 and 4 virtual CPU devices, in one subprocess.

The closed loop's channels of the same collectives (rate and width maps,
residuals, stochastic rounding, sub-byte storage) are held in
``tests/test_torch_dist_auto.py``.

Each Q's group is spawned once, in a module-scoped fixture.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.compression import get_compressor
from repro_torch.dist import gnn_parallel as gp
from repro_torch.kernels.ops import wire_pack, wire_unpack
from repro_torch.kernels.varco_pack import worker_block_maps

import torch_dist_cases as cases

ROOT = Path(__file__).resolve().parents[1]
QS = (2, 4)
CASES = ("dense", "packed", "p2p", "p2p_packed")
VJP_TOL = 1e-6


@pytest.fixture(scope="module")
def dist_out():
    return {q: gp.spawn_workers(cases.collective_cases, q, device="cpu")
            for q in QS}


def _emulated(q: int, case: str):
    """``(every worker's output, bits, input cotangents)`` of the port's
    emulated wire on the same inputs."""
    inp = cases.collective_inputs(q)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    key = prng.key(cases.KEY)
    f = x.shape[-1]
    n_keep = max(int(f // 128 / cases.RATE_PACK), 1)
    if case in ("dense", "packed"):
        if case == "dense":
            keys = np.stack([prng.fold_in(key, j) for j in range(q)])
            halo, per = get_compressor("randmask").batched(
                keys, x, cases.RATE_MASK)
            bits = float(per.sum()) * (q - 1)
        else:
            kept, inv = (torch.from_numpy(a) for a in
                         worker_block_maps(key, q, f // 128, n_keep))
            halo = wire_unpack(wire_pack(x, kept, inv), inv, kept)
            bits = float(x.shape[1] * n_keep * 128 * 32 * q * (q - 1))
        outs = [halo.detach()] * q
        ct = torch.from_numpy(inp["ct_gather"].sum(0))
        (dx,) = torch.autograd.grad(halo, x, ct)
        return outs, bits, dx
    publish = x
    width = f
    if case == "p2p_packed":
        kept, inv = (torch.from_numpy(a) for a in
                     worker_block_maps(key, q, f // 128, n_keep))
        publish = wire_unpack(wire_pack(x, kept, inv), inv, kept)
        width = n_keep * 128
    slot = torch.from_numpy(inp["slot"])
    valid = torch.from_numpy(inp["valid"])
    sent = gp._rows_of(publish, slot, x.shape[1]) * valid[..., None]
    # receiver i's hop d came from sender (i - d) mod q
    compact = torch.stack([torch.cat([sent[(i - d) % q, d - 1]
                                      for d in range(1, q)])
                           for i in range(q)])
    (dx,) = torch.autograd.grad(compact, x, torch.from_numpy(inp["ct_ring"]))
    bits = float(valid.sum()) * width * 32.0
    return list(compact.detach()), bits, dx


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("q", QS)
def test_collective_matches_emulated_wire(dist_out, q, case):
    with cases.one_thread():
        want_out, want_bits, want_dx = _emulated(q, case)
    for r in range(q):
        out, bits, dx = dist_out[q][r][case]
        assert torch.equal(out, want_out[r]), (q, case, r)
        assert bits == want_bits, (q, case, r, bits, want_bits)
        if case != "packed":         # the runtime's call, without the bits
            got, no_bits = dist_out[q][r][f"{case}_no_bits"]
            assert torch.equal(got, out) and no_bits is None, (q, case, r)
        np.testing.assert_allclose(dx.numpy(), want_dx[r].numpy(),
                                   rtol=0, atol=VJP_TOL)
    if case != "p2p":                # the compressing wires drop entries
        assert 0 < int((want_out[0] != 0).sum()) < want_out[0].numel()


SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import collectives as JC
from repro.core.compression import get_compressor
import torch_dist_cases as cases

out = {}
key = jax.random.key(cases.KEY)
for q in (2, 4):
    inp = cases.collective_inputs(q)
    mesh = Mesh(np.asarray(jax.devices()[:q]), ("d",))
    f = inp["x"].shape[-1]
    n_keep = max(int(f // 128 / cases.RATE_PACK), 1)

    def run(fn, *arrays):
        sm = shard_map(lambda *a: (lambda y, b: (y[None], b))(
            *fn(*(v[0] for v in a))), mesh=mesh,
            in_specs=tuple(P("d") for _ in arrays), out_specs=(P("d"), P()),
            check_rep=False)
        y, b = jax.jit(sm)(*(jnp.asarray(a) for a in arrays))
        return np.asarray(y), float(b)

    comp = get_compressor("randmask")
    res = {
        "dense": run(lambda x: JC.compressed_all_gather(
            x, "d", compressor=comp, rate=jnp.float32(cases.RATE_MASK),
            key=key), inp["x"]),
        "packed": run(lambda x: JC.packed_all_gather(
            x, "d", key=key, n_keep=n_keep), inp["x"]),
        "p2p": run(lambda x, s, v: JC.neighbor_exchange(
            x, s, v, "d"), inp["x"], inp["slot"], inp["valid"]),
        "p2p_packed": run(lambda x, s, v: JC.neighbor_exchange(
            x, s, v, "d", key=key, n_keep=n_keep), inp["x"], inp["slot"],
            inp["valid"]),
    }
    for case, (y, b) in res.items():
        out[f"{q}_{case}"] = y
        out[f"{q}_{case}_bits"] = np.float64(b)
np.savez(sys.argv[1], **out)
print("JAX_COLLECTIVES_OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_collectives") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, f"{run.stdout}\n{run.stderr}"
    assert "JAX_COLLECTIVES_OK" in run.stdout
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("q", QS)
def test_collective_matches_jax_shard_map(dist_out, jax_out, q, case):
    want = jax_out[f"{q}_{case}"]
    for r in range(q):
        out, bits, _ = dist_out[q][r][case]
        np.testing.assert_array_equal(out.numpy(), want[r])
        assert bits == float(jax_out[f"{q}_{case}_bits"]), (q, case, bits)

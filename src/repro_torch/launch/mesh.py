"""Production meshes — counterpart of ``repro/launch/mesh.py``.

Functions, not module-level constants, so importing starts no process
group.  Each builds a ``torch.distributed.device_mesh.DeviceMesh`` with
``init_device_mesh`` over the initialised default process group, whose
world size must be the mesh's size: a real job runs 256 or 512 ranks
(one card each); the dry run (:mod:`repro_torch.launch.dryrun`) fakes
them with the ``"fake"`` backend.  The shapes and axis names are the JAX
package's, so the sharding rules compare one to one.
"""

from __future__ import annotations


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 × 16 ``("data", "model")`` (256 ranks) or 2 × 16 × 16 ``("pod",
    "data", "model")`` (512 ranks)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_small_mesh(data: int = 2, model: int = 4,
                    device_type: str = "cuda"):
    """A reduced ``(data, model)`` mesh for tests (8 ranks by default)."""
    return _mesh((data, model), ("data", "model"), device_type)


#: NVIDIA H100 SXM datasheet constants (per card) for the roofline: dense
#: bf16 tensor-core FLOP/s, HBM3 bytes/s and capacity, and NVLink bytes/s
#: each way per card (900 GB/s in total, all to all within a host).
HW = {
    "card": "NVIDIA H100 SXM (datasheet)",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    "link_bw": 450e9,
}

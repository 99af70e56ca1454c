"""Hand-written Hopper kernels of the ported path, each beside its plain
PyTorch version and a launch counter:

* ``ell_spmm``   — ELLPACK neighbour aggregation (``csrc/ell_spmm.cu``)
* ``varco_pack`` — lane-block pack / unpack of the wire
  (``csrc/varco_pack.cu``)

``ops`` dispatches by the tensor's device; ``_build`` compiles the CUDA
sources with ``nvcc`` at first use.
"""

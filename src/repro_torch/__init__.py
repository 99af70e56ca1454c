"""repro_torch — the PyTorch/CUDA port of the VARCO reproduction.

The package mirrors ``repro``'s module names (``repro_torch.graph.partition``
is the counterpart of ``repro.graph.partition``, and so on).  It imports
``torch`` and numpy only: the host-side graph, halo and cache code is kept
as its own numpy copy, and every Pallas TPU kernel on the ported path is a
hand-written CUDA kernel under ``csrc/`` (built with ``nvcc`` for
``sm_90a`` at first use, bound through ``ctypes``).

Entry points take an explicit ``device=`` that defaults to ``"cuda"``; the
tests pass ``device="cpu"``, where each kernel wrapper runs its plain
PyTorch version because the tensor it was given lies on the CPU.

Ported so far: the serving slice — ``repro_torch.serve.ServingEngine`` over
the p2p halo wire, with the ``ell_spmm``, ``varco_pack`` and
``varco_unpack`` kernels.
"""

__version__ = "0.1.0"

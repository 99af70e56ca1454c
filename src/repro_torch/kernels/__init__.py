"""Hand-written Hopper kernels of the ported paths, each beside its plain
PyTorch version and a launch counter:

* ``ell_spmm``         — ELLPACK neighbour aggregation
  (``csrc/ell_spmm.cu``); its backward is the same kernel over the
  reversed lists
* ``varco_pack``       — lane-block pack / unpack of the wire
  (``csrc/varco_pack.cu``), each the other's VJP
* ``varco_pack_quant`` — the fused quantised-wire codecs
  (``csrc/varco_pack_quant.cu``), round half to even or, in a second
  instantiation (``varco_pack_quant_stochastic``), stochastic rounding
  from the shared Threefry stream (``csrc/threefry.cuh``)
* ``randmask``         — the paper's shared-key random element mask of
  the dense compressing wire and ``random_uniform``, the uniforms of
  stochastic rounding (``csrc/randmask.cu``; no TPU kernel: the JAX
  package draws both through XLA)
* ``flash_attention``  — causal / sliding-window GQA attention of the LM
  prefill, three kernels picked by ``kernel_for(dtype, head_dim)``: bf16
  at head dims 64/128/256 on the tensor cores by ``wgmma``
  (``csrc/flash_attention_wgmma.cu``), bf16 at the narrow heads 16/32 on
  the tensor cores by ``mma.sync`` (``csrc/flash_attention_mma.cu``), and
  f32 at every head dim on the CUDA cores (``csrc/flash_attention.cu``)
* ``ssd_chunk``        — the Mamba2 SSD intra-chunk quadratic form and
  chunk-state contribution (``csrc/ssd_chunk.cu``)

``ops`` dispatches by the tensor's device and wires the autograd
functions; ``_build`` compiles the CUDA sources with ``nvcc`` at first
use.
"""

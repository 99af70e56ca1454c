"""repro_torch — the PyTorch/CUDA port of the VARCO reproduction.

The package mirrors ``repro``'s module names (``repro_torch.graph.partition``
is the counterpart of ``repro.graph.partition``, and so on).  It imports
``torch`` and numpy only: the host-side graph, halo and cache code is kept
as its own numpy copy, and every Pallas TPU kernel on the ported paths is
a hand-written CUDA kernel under ``csrc/`` (built with ``nvcc`` for
``sm_90a`` at first use, bound through ``ctypes``).

Entry points take an explicit ``device=`` that defaults to ``"cuda"``; the
tests pass ``device="cpu"``, where each kernel wrapper runs its plain
PyTorch version because the tensor it was given lies on the CPU.

Ported so far:

* the serving slice — :class:`repro_torch.serve.ServingEngine` over the
  p2p halo wire;
* the training slice — :func:`repro_torch.train.train_gnn` (Algorithm 1,
  every partition stacked on one card) on the dense, packed and p2p
  wires under the open-loop policies and the closed-loop controllers
  (``budget``, :func:`error_controller`, :func:`stale_controller` with
  hop reuse, ``qos``), with the kernels' backward passes and the
  quantised wire's stochastic rounding (:func:`round_key`);

* the rest of ``train_gnn`` on one card — shard directories and loaded
  ``ShardSet`` objects as input (the out-of-core pipeline:
  :func:`open_store`, :func:`stream_partition`, :func:`write_shards`,
  :func:`load_shards`),
  the fault channel with degraded halo service and elastic shrink
  (:class:`FaultSchedule`), and crash-consistent checkpoint/resume
  (:mod:`repro_torch.train.checkpoint`, exported as ``checkpoint``);

over the ``ell_spmm``, ``varco_pack``, ``varco_unpack``,
``varco_pack_quant`` and ``varco_unpack_quant`` kernels; and

* the LM serving slice — :func:`serve_lm` (``repro_torch.launch.serve.
  serve``: prefill a prompt batch, greedy-decode) over
  :func:`init_lm` / :func:`prefill` / :func:`decode_step` for every
  architecture of the registry (dense, MoE through
  :mod:`repro_torch.models.moe`, SSM and hybrid), whose prefill runs the
  ``flash_attention`` and ``ssd_chunk`` kernels;

* streaming edge updates in GNN serving
  (:meth:`ServingEngine.apply_updates`, :mod:`repro_torch.serve.update`)
  and serving with ``rounding="stochastic"``;

* LM training on one card — :func:`train_lm` (``repro_torch.launch.train``)
  over :func:`forward_train` / :func:`lm_loss`, AdamW with the config's
  moment dtype and :class:`repro_torch.train.data.TokenPipeline`, in plain
  torch with autograd (the JAX package trains through XLA attention and
  the jnp SSD form too: neither kernel has a backward);

* VARCO data-parallel LM training — emulated on one card, or one process
  per worker (``train_lm(workers=Q)``, or every process under
  ``torchrun``) through :mod:`repro_torch.dist.grad_compress`; the
  sharding rules on DTensor (:mod:`repro_torch.dist.sharding`, hints at
  the JAX model's places), the production meshes
  (:mod:`repro_torch.launch.mesh`) and the dry run of every architecture
  × shape on a fake 256- or 512-rank mesh (:mod:`repro_torch.launch.
  dryrun`, collectives counted by :mod:`repro_torch.launch.
  comm_analysis`).
"""

__version__ = "0.2.0"
__all__ = ["CommPolicy", "FaultSchedule", "ServingEngine", "checkpoint",
           "decode_step", "error_controller", "forward_train", "init_lm",
           "lm_loss", "load_shards", "open_store", "prefill", "round_key",
           "serve_lm", "stale_controller", "stream_partition", "train_gnn",
           "train_lm", "write_shards"]


def __getattr__(name):
    # lazy, so importing the package stays cheap and cycle-free
    if name == "CommPolicy":
        from repro_torch.core.varco import CommPolicy
        return CommPolicy
    if name == "ServingEngine":
        from repro_torch.serve import ServingEngine
        return ServingEngine
    if name == "serve_lm":
        from repro_torch.launch.serve import serve
        return serve
    if name == "train_lm":
        from repro_torch.launch.train import train_lm
        return train_lm
    if name in ("init_lm", "prefill", "decode_step", "forward_train",
                "lm_loss"):
        from repro_torch.models import transformer
        return getattr(transformer, name)
    if name in ("error_controller", "stale_controller"):
        from repro_torch.dist import ratectl
        return getattr(ratectl, name)
    if name == "round_key":
        from repro_torch.kernels.ops import round_key
        return round_key
    if name == "FaultSchedule":
        from repro_torch.dist.faults import FaultSchedule
        return FaultSchedule
    if name in ("open_store", "write_shards", "load_shards",
                "stream_partition"):
        from repro_torch.graph import stream
        return getattr(stream, name)
    if name == "checkpoint":
        import importlib
        return importlib.import_module("repro_torch.train.checkpoint")
    if name == "train_gnn":
        from repro_torch.train.trainer import train_gnn
        return train_gnn
    raise AttributeError(name)

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # the full-size GNN serving +
                                          # training, then LM serving
    python3 chip_smoke.py --nodes 20000   # a quicker, smaller graph

Phases, each fatal on failure (exit code 1, no result line):

1. device  — needs ``torch.cuda.is_available()``; prints the card's name
   and power limit (``nvidia-smi``) and turns TF32 off for matmuls and
   cuDNN.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch/
   csrc`` with ``nvcc`` (one process per source, in parallel) and prints
   the build seconds, each library's register/spill report and, where the
   toolkit has ``cuobjdump``, the count of ``HGMMA``, ``HMMA`` and
   ``FFMA`` instructions in the three flash libraries' SASS (the wgmma
   library must hold HGMMA, the narrow-head one HMMA, the CUDA-core one
   FFMA and no tensor-core instruction), and the CUDA-core and
   narrow-head kernels' tiles and resident blocks per SM at every head
   dim they take (at least 2 at D <= 128).
3. setup   — the OGBN-Arxiv analogue ``citation_graph(n=169_343,
   feat_dim=128)``, cut ``metis-like`` into Q = 4 partitions stacked on the
   card, and a ``ServingEngine`` over GraphSAGE at the paper's width (in
   128, hidden 256, out 40, 3 layers) with weights from a seeded
   ``torch.Generator``.
4. kernels — each kernel at the paths' shapes and at a ragged shape,
   against its plain PyTorch version on the same inputs (pack/unpack and
   the fused quantised codecs bitwise, ELL within 1e-5: FMA contraction
   reorders f32 sums), with CUDA-event times of the kernel, the plain
   version and one PyTorch library call where one computes the same
   function, beside the least time the card could take (bytes over 3.35
   TB/s, flops over 67 TFLOP/s f32).  The dense wire's ``random_mask``
   runs over the boundary block ``[Q, B, F]`` at F = 256 and 128, rates
   2, 4 and 5.3, biased and unbiased, bitwise against its plain version
   (output and kept counts), its bound the larger of the bytes and 76
   integer operations an element at the card's integer issue ceiling
   (128 results per SM per clock × SMs × the maximum SM clock); PyTorch
   has no call that draws the same bits.  Its bf16 instantiation
   (``random_mask_bf16``) runs over granite-3-2b's gradient leaves as the
   one-worker VARCO step hands them over — the embedding ``[1, 49155,
   2048]`` and the stacked MLP projection ``[1, 40, 2048, 8192]`` at rate
   128 — and ragged, bitwise, its plain version over 2^26 elements at a
   time (each chunk from its counter offset).  The ELL SpMM also runs over the
   reversed lists (the training backward), and at ``arxiv-q16-p2p-full``'s
   remote shapes (the full-size graph cut at random into 16, built here:
   compact ``[16, C, 256]`` -> partition over the remote lists, and back
   over their reversed lists), beside the edge-list chain they replaced
   (gather, product, zero-fill, ``index_add``) as the library call; its
   records carry the bytes
   its gathers move (one row slice per valid slot) and their rate.  Each
   autograd function's backward on the card is held to the plain
   version's autograd within 1e-4 (atomic scatters reorder f32 sums).
   Stochastic rounding: the fused codec's stochastic instantiation at the
   p2p hop shape ``[12, 40960, 256]`` (w8, w4), at the packed all-gather's
   ``[4, 44227, 256]`` (w4) and ragged, and ``random_uniform`` over the
   hop's ``[12, 40960·256]``, each bitwise against its plain version, its
   bound the larger of the bytes and 76 integer operations an element
   (the rint kernel timed beside it on the same inputs).
5. slice   — launch counts set to 0, then the serving path: ``refresh(
   force=True)``, a few hundred node and edge queries through ``submit``/
   ``flush``, and three non-forced ``refresh()`` calls under the default
   ``auto:qos:<bits>:w8`` policy with queries between them; launch counts
   read right after (each serving kernel must have run, the rint
   quantised codec included: serving rounds half to even).  The ``FRESH``
   answers of the cold refresh must match ``centralized_forward`` on the
   card within 1e-4 (atomic scatter-adds and FMA contraction reorder f32
   sums).
6. train   — launch counts set to 0, then the training path, ``train_gnn``
   on the engine's partitioned graph: one ``sgd(0.1)`` step under
   ``full`` on the p2p and on the dense wire (each step-0 loss and
   updated parameters must match the centralized loss and one autograd
   step of ``centralized_forward`` within 1e-4: the grad-sync identity),
   then on the p2p wire ``full``, ``varco:linear:5`` and
   ``auto:budget:<half the full-rate transport>:w8``, on the dense wire
   the JAX package's quickstart trio ``full``, ``fixed:4`` and
   ``varco:linear:5`` (the paper's ``randmask``), on the packed wire
   ``varco:linear:5`` (``blockmask``), the closed loops
   ``auto:error:<half>:w8`` and ``auto:stale:<half>`` on the p2p wire and
   ``auto:budget:<half>:w4`` on the packed wire, 5 epochs each with
   AdamW, and one epoch each of ``fixed:4`` with ``topk`` and ``fixed:8``
   with ``int8`` on the dense wire; launch counts read right after (every kernel must
   have run, the stochastic quantised codec and the unpack codec during
   the w8 run — the card's default wire rounding is stochastic, so the
   rint codec must not run — ``random_mask`` in exactly the dense runs
   that draw the random mask).  Then, at rate 2
   on the card: the packed halo must equal the dense ``blockmask`` halo
   bitwise, the p2p wire's remote values the same, and one packed
   exchange's transport ``halo_demand × K·128 × 32`` exactly.  Every
   loss must be finite and both ``full`` runs' must fall; per-epoch loss,
   rate, width, bits, step time, test accuracy and the peak device
   memory are printed.
6b. auto  — launch counts set to 0, then three ``make_auto_train_step``
   steps with no rounding named (the card's default, stochastic): every
   pair at w8 on the p2p wire and at
   w4 on the packed wire (the fused stochastic codec) and a mixed-width
   p2p plan with one fp32 pair (``random_uniform``); counts read right
   after (both kernels must have run).  Each step's loss must match the
   same step with the plain codecs swapped in within 1e-4, and its
   layer-1 halo the plain codecs' bitwise; a ``stale`` step with every
   pair skipped must charge 0 bits and deliver the cache bitwise; one w4
   packed and one w8 p2p exchange must ship exactly ``ceil(ledger bits /
   8)`` bytes (``wire_out`` capture).
6c. resilience — the rest of ``train_gnn`` on the setup's graph, model
   and parameters, under the run's temporary directory (removed at the
   end of the run; the dist phase boots from its shards); launch
   counts set to 0 before each part and read after (``ell_spmm``,
   ``varco_pack`` and ``varco_unpack`` must run in each).  R1, the
   out-of-core boot: ``write_graph_store``, ``stream_partition(store, 4,
   "metis-like")`` (its exact path: the owner vector must equal the setup
   phase's), ``write_shards`` and ``load_shards``; the shard set's
   ``device_arrays("cuda")`` must equal the in-memory ``device_arrays`` +
   ``attach_p2p`` bitwise, key by key, and ``train_gnn(<shard dir>)``
   under ``varco:linear:5`` on the p2p wire must give the train phase's
   in-memory losses within 1e-4 (atomic scatters); seconds and bytes on
   disk of each step are printed.  R2, faults: 6 epochs each of
   ``varco:linear:5`` and ``auto:budget:<half>:w8`` under
   ``FaultSchedule(q=4, seed=0, drop_rate=0.25, spike_rate=0.05,
   crash_at=((3, 1),))`` with ``fault_max_stale=2``, and ``varco`` again
   at ``fault_max_stale=1`` (where pairs go DEAD: at 2 none does within
   6 epochs); every loss finite, Q = 3 from epoch 3 on with ``[3, 3]``
   pair ledgers, the fused codecs launched in the w8 run, the ladder's
   CACHED/DEAD counts printed per epoch; one fault step with pair (2 ← 0)
   CACHED from the fresh step's ``fcache_out`` gives the fresh loss
   within 1e-4, charges that pair 0 bits and serves its hop rows bitwise
   from the cache, and a forward with every off-diagonal pair DEAD equals
   the No-Comm forward within 1e-4.  R3, resume: R2's faulted ``varco``
   run checkpointed after epoch 4 (after the crash) and resumed must end
   within 1e-4 of the uninterrupted run, and a ``save`` → ``restore`` of
   a state tree of card tensors must be bitwise; save/restore ms and the
   file's bytes are printed, and the phase's peak device memory.
6d. dist — the worker backend: ``train_gnn(use_shard_map=True)`` over
   Q = 4 worker processes (``spawn_workers``), each loading only its own
   partition from the resilience phase's shard directory, at the setup's
   width and seeds, 3 epochs each: p2p ``full`` and ``varco:linear:5``,
   dense ``varco:linear:5`` (``randmask``), packed ``fixed:4``, and the
   closed loop at ``<half>`` (half the full-rate transport of 3 epochs
   over the shard partition): p2p ``auto:budget:<half>:w8`` (sub-byte
   hops with error-feedback residuals), p2p ``auto:error:<half>:w8`` and
   packed ``auto:budget:<half>:w4`` (the sub-byte all-gather), rounded
   stochastically (the card's default); then one
   ``make_auto_train_step(mesh=...)`` step under a mixed-width plan (an
   fp32 pair beside 8- and 4-bit pairs: the value path, whose uniforms
   ``random_uniform`` draws).  With four cards the workers run over
   NCCL; with fewer, all four over ``gloo`` on ``cuda:0`` with every
   transfer staged through pinned host memory (printed, with ``NCCL
   unverified: <n> card`` on a line of its own).  Each worker sets its
   launch counts to 0 before a run and reads them after; summed over the
   workers, ``ell_spmm`` (p2p), ``varco_pack``/``varco_unpack`` (p2p
   ``varco``, packed, the auto runs), ``random_mask`` (dense), the
   stochastic codec and ``varco_unpack_quant`` (every auto run whose
   plans quantise) and ``random_uniform`` (the mixed step, on every
   worker) must have run, and the rint codec must not (the card rounds
   stochastically).  Before the measured runs each worker runs them once
   more with every call of those eight kernels held against the plain
   version on the same arguments (everything bitwise but ELL, within
   1e-5: the codecs and uniforms draw the plain version's Threefry
   stream); that run must make as many calls as the measured run
   launches, and every signature (shapes, strides, dtypes, 16-byte
   alignment, scalar arguments) the measured run launches at must have
   been held so.  Held against the emulated backend's runs of the same
   settings on the same card: per-epoch losses within 1e-4, the
   cumulative ledger and ``pair_transport_gf`` at rel 1e-6, the
   controllers' rates equal, accuracies within 1e-3, the mixed step's
   loss within 1e-4; over a 256-wide exchange each worker's p2p compact
   hop buffer and packed halo at rate 2, and under the closed loop's
   plans (p2p w8, packed w4, the mixed plan; stochastic) its halo and
   its first error-feedback residual slab, equal its slice of the
   emulated backend's bitwise; one distributed ``sgd(0.1)`` ``full``
   step holds the grad-sync identity within 1e-4.  Printed per run:
   rank 0's step ms median beside the emulated step's, every worker's
   MB sent and staged (median and per step), host ms in the transport,
   peak GB and launches.  Then faults on the group, from the same
   shards under R2's schedule and 6 epochs: ``varco:linear:5`` at
   staleness caps 2 and 1 through ``train_gnn(use_shard_map=True,
   faults=...)`` (worker 1's crash at epoch 3 shrinks the group to 3
   processes: the crashed one must return ``None``) against R2's
   emulated runs (losses within 1e-4, CACHED / DEAD counts equal per
   epoch, Q = 3 from epoch 3, a DEAD pair at cap 1); one fault step a
   worker with CACHED and DEAD pairs from a seeded random cache against
   the emulated step (loss within 1e-4; the first exchange's served
   cache bitwise, the CACHED pairs' rows equal to the cache, the rest
   within 1e-4: f32 sums in another order); the cap-2 run stopped
   after epoch 4 into a checkpoint (one file, 3 live workers), resumed
   over 3 spawned workers and on the emulated backend, both within 1e-4
   of the uninterrupted group run.  Every kernel call of these runs is
   held against its plain version as above.  Printed: step ms, the
   crash epoch's ms, MB sent a step, the checkpoint's write ms and
   bytes, peak GB a worker and launches.
6e. update — streaming edge updates on the engine (after the other GNN
   phases: the update changes its graph): a forced refresh, then a seeded
   batch of 256 inserts and 256 deletes of existing edges through
   ``apply_updates`` (host ``EdgeSpill``, the frontier recompute on the
   card, a rebuild on the unchanged owner vector); the seconds of the
   spill, the ms of the recompute (ending in a sync), each frontier's size
   and the ms of the forced refresh that follows are printed.  The
   patched cache must match ``centralized_forward`` on the new graph and
   that forced refresh within 1e-4 (atomic scatter-adds reorder f32
   sums); launch counts set to 0, three non-forced refreshes, counts read
   (``ell_spmm`` and a wire pack must run).  Then an engine with
   ``rounding="stochastic"`` and the drift gate off: counts set to 0, a
   forced and two non-forced refreshes, counts read (the stochastic
   codec must run), and every exchange's halo of each refresh must equal
   the same refresh's with the plain codecs swapped in, bitwise (both
   runs in PyTorch's deterministic mode, so the remote-halo scatter sums
   in one order).

7. lm_kernels — ``flash_attention`` at qwen2-moe-a2.7b's prefill shape
   (q and k/v ``[8, 16, 2048, 128]``, bf16, causal, handed over as the
   model's ``[B, S, H, D]`` views), at every other full-size prefill
   shape of the registry (granite ``[8, 32, 2048, 64]`` kv 8, gemma
   ``[8, 16, 2048, 256]`` MHA, musicgen ``[8, 32, 2048, 64]`` MHA, yi
   ``[8, 32, 2048, 128]`` kv 4, qwen3 and jamba ``[8, 64, 2048, 128]`` kv
   8, llama4 ``[8, 40, 2048, 128]`` kv 8, qwen2-vl ``[8, 12, 2048, 128]``
   kv 2), at D = 128 and D = 256,
   with a window, at a ragged S — all on the tensor-core kernel — in f32
   at granite's widths and at D = 32 on the CUDA-core kernel, and in bf16
   at D = 32 and 16 on the narrow-head tensor-core kernel (each case
   checks that the counter of its kernel, and only that one, moved; the
   record's ``path`` names it; a bf16 narrow call takes about as long in
   the host's Python as on the card, so those cases time kernel and
   library alike by replaying a CUDA graph of ``NARROW_REPS`` calls,
   their eager times beside); ``ssd_chunk`` at mamba2-130m's (x ``[8, 8,
   256, 24, 64]``, B/C ``[8, 8, 256, 1, 128]``, f32, strided like the conv
   output), at jamba's (H = 256: x ``[8, 8, 256, 256, 64]``), at a
   two-group ragged shape and at G = 2, H/G = 3, Q = 100.
   Flash attention also runs with explicit positions (a shifted and a
   left-padded batch, the JAX package's prefill mask) on all three
   kernels,
   its bound from the (query, key) pairs the positions leave unmasked
   (counted on the host) and its library time that of
   ``scaled_dot_product_attention`` with the boolean position mask,
   built outside the timing.
   Each against its plain version (flash within 2e-5 in f32 and 2e-2 in
   bf16, one ulp of the rounded output; in bf16 also each output row
   within 2e-2 of its largest value, a limit that a control, the plain
   version with the window cut by 16 keys, must fail; SSD within 1e-5
   relative + 1e-4 absolute), with kernel, plain and library times
   (flash: ``scaled_dot_
   product_attention(is_causal=True, enable_gqa=True)``, or with a
   boolean ``attn_mask`` built outside the timing for the window, held to
   the plain version in bf16 and timed here only; SSD: none) and the bound (bf16 products against the 989 TFLOP/s
   tensor-core peak, f32 against 67 TFLOP/s; the SSD count takes C·Bᵀ
   once per group, as the inputs need).
8. lm — every architecture of the registry served at full width,
   random weights from a seeded generator on the card, batch 8, prompt
   2048, 32 new tokens, one after another (each freed before the next):
   granite-3-2b (40 bf16 layers), mamba2-130m (24 f32), qwen2-moe-a2.7b
   (24 bf16 layers, 60 routed experts top-4 padded to 64 + 4 shared),
   gemma-7b, yi-6b, musicgen-large, qwen2-vl-2b and qwen3-32b at full
   depth, llama4-maverick-400b-a17b at one period (2 layers: a dense and
   an MoE layer of 128 experts) and jamba-1.5-large-398b at the SMOKE
   config's period ``("mamba", "attn")`` (2 layers; the attention layer
   with an MoE of 16 experts); ``LM_SERVE`` holds the cuts.  Launch
   counts are set to 0 before each ``serve`` and read right after: each
   prefill must launch flash once per attention layer (on the kernel
   ``kernel_for`` picks: wgmma for every full-size bf16 config) and
   ``ssd_chunk`` once per mamba layer, and decode neither.  Each
   kernel-path prefill's logits must match the plain path's (the same
   call with the plain versions swapped in) within 5e-2 of the largest
   logit in bf16 and 1e-4 in f32 (qwen3's check at batch 2, its dense
   f32 scores beside 65.5 GB of weights); the MoE archs print the share
   of (layer, token) pairs whose top-k experts agree between the two
   paths, and the plain path's error when routed to the kernel path's
   experts.  Decode consistency — prefill over S − 1 tokens plus one
   decode step against the prefill over S — within 1e-3 of the largest
   logit (granite's bf16 weights run in f32 for this check; mamba2 at S
   = 256, since 2047 is no multiple of its chunk).  Granite's f32 check
   is the CUDA-core flash kernel's path: counts are set to 0 before it
   and read after (two prefills: 80 launches of it, none of the other
   two).  Granite's prefill with explicit positions,
   kernel path against plain path within 5e-2: a shifted batch at S =
   2048 (masked by index, as the JAX package's chunked branch) and a
   left-padded one at S = 2000 (masked by position).  Then qwen2-moe at
   full width and 2 layers in f32: kernel path (CUDA-core flash) against
   plain path within 1e-4 with the shared expert choices printed, and
   decode consistency within 1e-3 at ``capacity_factor=8.0`` on 2 rows
   (the JAX package's consistency test gives MoE the same headroom: a
   decode step routes 2 tokens, the prefill 4096, and the capacities
   then differ).  The narrow-head bf16 path: granite's and yi's SMOKE
   configs (head dims 16 and 32) in bf16, served at batch 8 × 2048 + 32
   tokens with counts set to 0 before and read after (one launch of the
   narrow-head kernel per attention layer, none of the others), prefill
   logits against the plain path within 5e-2 of the largest.
9. lm_train — launch counts set to 0, then LM training through
   ``make_train_step`` (AdamW, lr 3e-4, ``TokenPipeline`` batches):
   granite-3-2b at full size (40 bf16 layers, remat, f32 moments), batch 8
   × 2048, 10 steps; qwen2-moe-a2.7b at full width and 2 layers, batch 4 ×
   2048, 3 steps; mamba2-130m at full size (24 f32 layers), batch 8 ×
   2048, 5 steps — each at half the batch if the card runs out of memory
   (said in the record; width and depth are never cut); counts read after
   (no LM kernel may run: neither has a backward).  Every loss finite,
   granite's and mamba2's last three below their first, qwen2-moe's aux
   loss positive; the median step ms of steps 3 on (host clock ending in
   the loss read), tokens/s and peak memory are printed.  Granite's
   training forward (``forward_train`` + ``_lm_head`` at the last
   position) against its prefill (tensor-core flash) on the trained
   weights, batch 8 × 2048, within 5e-2 of the largest logit.  Granite at
   full width and 2 layers in f32, batch 2 × 512: one step on the card
   from zero state, then one more from that state on the card and on the
   CPU, loss within 1e-4 relative, every moment leaf within 1e-4 of its
   largest magnitude and every parameter leaf within 1e-4 of its norm
   (AdamW's normalised update turns the sum-order error of a near-zero
   gradient entry into up to lr; the worst single entries are printed).
   Then VARCO data-parallel training: granite-3-2b at full size, 8 ×
   2048, under ``varco:linear:5`` through ``make_varco_dp_train_step``
   with one worker (5 steps) and four (3 steps; half the batch if the
   card runs out of memory, said), counts set to 0 before each and read
   after: ``random_mask_bf16`` once a gradient leaf, a worker and a step,
   no f32 mask and no LM kernel; losses finite, step 0's rate 128,
   ``grad_bits`` 0 at one worker and positive at four; step ms beside the
   ``full`` run's.  The f32 2-layer check again through the dp step over
   4 workers of one row each (steps 0 and 1 of ``varco:linear:5`` over 10
   steps): the same tolerances, ``grad_bits`` equal card vs CPU.  Each
   training run and each served prefill records its bound from
   ``launch/analytic.estimate`` (FLOPs against the parameter dtype's
   peak, HBM bytes against 3.35 TB/s).
10. lm_dp — VARCO data-parallel LM training across worker processes:
   ``make_varco_dp_train_step`` over a ``WorkerMesh`` of 4 processes on
   the one card (``spawn_workers``, host-staged ``gloo``: NCCL refuses two
   ranks on one card, and the phase prints "NCCL unverified"), each
   training its 2 rows of granite-3-2b at full width and 10 layers (at
   11 the card is all but full; bf16, remat, f32 moments), batch 8 ×
   2048, 3 steps of ``varco:linear:5`` and of ``full``; the same runs through
   the emulated ``DPMesh(4)`` on the card first.  Checks: losses finite,
   step 0's rate 128, ``grad_bits`` equal group against emulated, every
   rank's parameters and optimiser state bitwise equal after every step
   (a 64-bit checksum of their bits), losses within 1e-4 relative and
   parameters within 1e-4 of each leaf's norm of the emulated run's;
   ``random_mask_bf16`` launched once a gradient leaf, a worker and a
   compressed step (0 under ``full``), no LM kernel (counts set to 0 in
   every worker before each run).  Printed: step ms (median of steps 1
   on) beside the emulated step's, ``sent_bytes``, ``staged_bytes`` and
   ``comm_s`` a step, peak GB a process.  Then the f32 2-layer check's
   steps 0 and 1 through the group against the emulated steps on the card,
   at that check's tolerances.  A worker that runs out of memory fails
   the run with the depth named; nothing is cut or moved to the CPU.  The
   dry run (``repro_torch.launch.dryrun``) runs no device code and is not
   a phase.  The sharded MoE (expert parallelism on a DTensor mesh)
   needs at least two ranks and a CUDA all-to-all that host-staged
   ``gloo`` lacks, so it runs on ``gloo`` CPU ranks in the tests
   (``tests/test_torch_moe_sharded.py``) and in the dry run, which
   traces all 40 arch × shape combinations; here the MoE runs its
   one-card path, unchanged.

The line before the last is the ``{"kernels": [...]}`` summary (launches
from the training path for the GNN kernels and ``random_mask``, which has
no TPU counterpart: its ``replaces`` names the JAX package's XLA draw,
plus the dist phase's workers' launches (also of the codecs and
``random_uniform``);
from serving for the rint quantised codec (train_gnn rounds
stochastically on the card); from the training path, the auto phase and
the update phase's stochastic serving for the stochastic codec and
``random_uniform``; from granite's one-worker VARCO run and the lm_dp group's workers for
``random_mask_bf16``;
from qwen2-moe-a2.7b's prefill for tensor-core flash, mamba2-130m's for
``ssd_chunk``, granite's f32 check for the CUDA-core flash kernel and
the bf16 SMOKE serving runs for the narrow-head one);
the last line is ``{"ok": true, "device": {...}}``.  ``--lm-only`` runs
the device, build, lm_kernels, lm, lm_train and lm_dp phases alone and
prints neither.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
ELL_TOL = 1e-5
FRESH_TOL = 1e-4
GRAD_TOL = 1e-4
TRAIN_EPOCHS = 5
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 flash: the worst output row's largest error over that row's
#: largest value, and the control that shows the limit catches a wrong
#: kernel (the plain version with the window cut by this many keys: the
#: last rows lose their oldest keys, within FLASH_TOL in absolute terms)
FLASH_ROW_TOL = 2e-2
FLASH_CONTROL_KEYS = 16
SSD_RTOL, SSD_ATOL = 1e-5, 1e-4
#: kernel path against plain path, of the largest logit, by param dtype
PLAIN_PATH_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
CONSISTENCY_TOL = 1e-3
#: calls in the replayed graph that times the narrow-head bf16 flash cases
NARROW_REPS = 100
LM_BATCH, LM_PROMPT, LM_NEW = 8, 2048, 32
#: the lm phase's architectures, in order, each at full width: ``cut``
#: overrides cut the depth to fit one 80 GB card beside the phase's
#: checks; ``plain_batch`` sizes a plain-path check whose f32 ``[B, H, S,
#: S]`` scores would not fit beside the weights at LM_BATCH
LM_SERVE = {
    "granite-3-2b": {}, "mamba2-130m": {}, "qwen2-moe-a2.7b": {},
    "gemma-7b": {}, "yi-6b": {}, "musicgen-large": {}, "qwen2-vl-2b": {},
    "qwen3-32b": {"plain_batch": 2},
    # one period: a dense layer and an MoE layer of 128 experts
    "llama4-maverick-400b-a17b": {"cut": {"n_layers": 2}},
    # the SMOKE config's period: a mamba layer and an attention + MoE one
    "jamba-1.5-large-398b": {"cut": {"n_layers": 2,
                                     "pattern": ("mamba", "attn")}},
}
#: the MoE architecture with the f32 and decode-consistency checks, and
#: the depth it runs them at
MOE_CHECK_ARCH, MOE_CHECK_LAYERS = "qwen2-moe-a2.7b", 2
#: capacity headroom of the MoE decode-consistency check (the JAX
#: package's consistency test uses the same): no choice drops in either
#: prefill or the decode step, which route different token counts
MOE_CONSISTENCY_CF = 8.0
#: 32-bit integer operations of one ``random_mask`` element: the counter
#: injection (2), 20 Threefry rounds of add, rotate and xor (60), 5 key
#: injections of two adds (10), the output xor, the shift, the or with
#: the exponent and the compare (4)
MASK_INT_OPS = 76
#: 32-bit integer results an SM can retire per clock: four schedulers,
#: each issuing one 32-lane warp instruction a clock.  No mix of integer
#: instructions runs faster; the ALU pipe (add, logic, funnel shift: 64
#: lanes) and the FMA pipe (IMAD: 64 lanes) together reach it.  The ALU
#: pipe's 64 alone is no ceiling: the kernel runs 21 T of these ops a
#: second, above 64 lanes × 132 SMs × 1.98 GHz = 16.7 T
INT_OPS_PER_SM_CLOCK = 128

KERNELS = {
    "ell_spmm": {"source": "src/repro_torch/csrc/ell_spmm.cu",
                 "replaces": "src/repro/kernels/ell_spmm.py:78"},
    "varco_pack": {"source": "src/repro_torch/csrc/varco_pack.cu",
                   "replaces": "src/repro/kernels/varco_pack.py:66"},
    "varco_unpack": {"source": "src/repro_torch/csrc/varco_pack.cu",
                     "replaces": "src/repro/kernels/varco_pack.py:256"},
    "varco_pack_quant": {"source": "src/repro_torch/csrc/varco_pack_quant.cu",
                         "replaces": "src/repro/kernels/varco_pack.py:158"},
    "varco_unpack_quant": {
        "source": "src/repro_torch/csrc/varco_pack_quant.cu",
        "replaces": "src/repro/kernels/varco_pack.py:213"},
    "flash_attention": {
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:108"},
    "flash_attention_simt": {
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:108"},
    "flash_attention_mma": {
        "source": "src/repro_torch/csrc/flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:108"},
    "ssd_chunk": {"source": "src/repro_torch/csrc/ssd_chunk.cu",
                  "replaces": "src/repro/kernels/ssd_chunk.py:77"},
    # no TPU kernel: the JAX package draws this mask through XLA at the
    # line named here
    "random_mask": {"source": "src/repro_torch/csrc/randmask.cu",
                    "replaces": "src/repro/core/compression.py:142"},
    # the fused codec with stochastic rounding: the TPU kernel rounds to
    # nearest; the JAX package rounds stochastically around it in XLA
    # (src/repro/kernels/ops.py:195)
    "varco_pack_quant_stochastic": {
        "source": "src/repro_torch/csrc/varco_pack_quant.cu",
        "replaces": "src/repro/kernels/varco_pack.py:158"},
    # no TPU kernel: the uniforms of stochastic rounding, drawn by XLA
    "random_uniform": {"source": "src/repro_torch/csrc/randmask.cu",
                       "replaces": "src/repro/kernels/ops.py:195"},
    # the mask's bf16 instantiation, over the gradient leaves of VARCO
    # data-parallel LM training; the JAX package draws the mask through
    # XLA at the line named here and multiplies in the leaf's dtype
    "random_mask_bf16": {"source": "src/repro_torch/csrc/randmask.cu",
                         "replaces": "src/repro/core/compression.py:142"},
}


#: the kernels train_gnn launches on the card; its quantising auto runs
#: round stochastically there (the card's default wire rounding), so the
#: rint codec ``varco_pack_quant`` runs in serving (the slice phase) and
#: under faults instead
GNN_KERNELS = ("ell_spmm", "varco_pack", "varco_unpack",
               "varco_pack_quant_stochastic", "varco_unpack_quant",
               "random_mask")
#: the kernels of stochastic rounding: launched by train_gnn's quantising
#: auto runs, the auto phase's steps and stochastic serving
STOCH_KERNELS = ("varco_pack_quant_stochastic", "random_uniform")
#: the quantised codecs a quantising auto run of train_gnn launches
TRAIN_QUANT_KERNELS = ("varco_pack_quant_stochastic", "varco_unpack_quant")
#: kernel -> the arch whose serving run gives the summary's launches (one
#: per attention / mamba layer of a prefill); the CUDA-core flash kernel
#: serves no full-size arch: its launches come from granite served in f32
#: (the decode-consistency check's path), and the narrow-head one's from
#: the SMOKE configs served in bf16 (``NARROW_SERVE``)
LM_KERNELS = {"flash_attention": "qwen2-moe-a2.7b", "ssd_chunk": "mamba2-130m",
              "flash_attention_simt": None, "flash_attention_mma": None}
#: the narrow-head bf16 path: SMOKE configs (dense) served in bf16 at head
#: dims 16 (granite) and 32 (yi)
NARROW_SERVE = ("granite-3-2b", "yi-6b")
#: the counter name of each flash kernel, by ``kernel_for``'s answer
FLASH_NAMES = {"wgmma": "flash_attention", "mma": "flash_attention_mma",
               "simt": "flash_attention_simt"}


class _Counter:
    """One counter attribute of a wrapper, read and set as ``.launches``
    (the bf16 launches of ``random_mask``, which ``random_mask.launches``
    also counts)."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def launch_counters() -> dict:
    from repro_torch.kernels.ell_spmm import ell_spmm
    from repro_torch.kernels.flash_attention import (flash_attention_mma,
                                                     flash_attention_simt,
                                                     flash_attention_wgmma)
    from repro_torch.kernels.randmask import random_mask, random_uniform
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.kernels import varco_pack as vp

    return {"ell_spmm": ell_spmm, "varco_pack": vp.varco_pack,
            "varco_unpack": vp.varco_unpack,
            "varco_pack_quant": vp.varco_pack_quant,
            "varco_unpack_quant": vp.varco_unpack_quant,
            "flash_attention": flash_attention_wgmma,
            "flash_attention_simt": flash_attention_simt,
            "flash_attention_mma": flash_attention_mma,
            "ssd_chunk": ssd_chunk, "random_mask": random_mask,
            "varco_pack_quant_stochastic": vp.varco_pack_quant_stochastic,
            "random_uniform": random_uniform,
            "random_mask_bf16": _Counter(random_mask, "bf16_launches")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failure(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls captured once in a
    CUDA graph and replayed, by CUDA events: the device's time without the
    host's launch gaps, for calls whose host time rivals their device
    time.  Warmed up on a side stream first, as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def analytic_bound(cfg, batch: int, seq: int, kind: str) -> dict:
    """The least time one card could take for a whole LM step of ``kind``
    (``"train"`` or ``"prefill"``) at ``batch × seq``, from the port's
    ``launch/analytic.estimate`` (its FLOPs against the peak of the
    config's parameter dtype, its HBM bytes against the memory rate; the
    config's moment width)."""
    from repro_torch.launch.analytic import estimate
    from repro_torch.launch.shapes import InputShape

    mb = torch.finfo(getattr(torch, cfg.moment_dtype)).bits // 8 \
        if cfg.moment_dtype else None
    est = estimate(cfg, InputShape("run", seq, batch, kind), 1,
                   moment_bytes=mb)
    peak = BF16_FLOPS_PER_S if cfg.param_dtype == "bfloat16" else \
        F32_FLOPS_PER_S
    ms, by = bound_ms(est.hbm_bytes_per_dev, est.flops_global, peak)
    return {"analytic_bound_ms": ms, "analytic_bound_by": by,
            "analytic_flops": est.flops_global,
            "analytic_hbm_bytes": est.hbm_bytes_per_dev}


def bound_ms(n_bytes: float, flops: float = 0.0,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: the larger of ``n_bytes`` over
    the memory rate and ``flops`` over the peak of their type."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def device_phase():
    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is False: this smoke run "
                      "needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}", flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return card


def _sass(lib: Path):
    """A built library's SASS text, or None where the toolkit has no
    ``cuobjdump``."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    return sass.stdout


def _op_count(sass, opcode: str):
    """Instructions of ``opcode`` (``HGMMA``, ``HMMA``, ``FFMA``, ...) in
    SASS text, or None without it."""
    if sass is None:
        return None
    return sum(f" {opcode}." in ln or f" {opcode} " in ln
               for ln in sass.splitlines())


def build_phase():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     MMA_HEAD_DIMS,
                                                     kernel_config)

    res = _build.build()
    # per library: each kernel's registers and spills (ptxas -v)
    ptxas = {name: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in res["log"].items()}
    sass = {name: _sass(_build.library_path(name))
            for name in ("flash_attention_wgmma", "flash_attention_mma",
                         "flash_attention")}
    ops = {name: {op: _op_count(text, op)
                  for op in ("HGMMA", "HMMA", "FFMA")}
           for name, text in sass.items()}
    # the CUDA-core and narrow-head flash kernels' tiles and occupancy
    tiling = {(kind, d): kernel_config(kind, d)
              for kind, dims in (("simt", HEAD_DIMS), ("mma", MMA_HEAD_DIMS))
              for d in dims}
    emit({"phase": "build", "seconds": res["seconds"],
          "built": sorted(res["log"]), "ptxas": ptxas,
          "flash_sass_ops": ops,
          "flash_tiling": {f"{k}_d{d}": t for (k, d), t in tiling.items()}})
    wg, mma, simt = (ops[n] for n in ("flash_attention_wgmma",
                                      "flash_attention_mma",
                                      "flash_attention"))
    check(wg["HGMMA"] is None or wg["HGMMA"] > 0, "no HGMMA instruction in "
          "the tensor-core flash library's SASS")
    check(mma["HMMA"] is None or mma["HMMA"] > 0, "no HMMA instruction in "
          "the narrow-head flash library's SASS")
    check(simt["HMMA"] is None or simt["HMMA"] == simt["HGMMA"] == 0 <
          simt["FFMA"], "the CUDA-core flash library is not f32 FMA only")
    for (kind, d), t in tiling.items():   # 2 blocks an SM at D <= 128
        check(t["blocks_per_sm"] >= (2 if d <= 128 else 1),
              f"flash {kind} at D = {d} holds {t['blocks_per_sm']} blocks "
              f"per SM")


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------


def _ell_case(name, x, nbr, w, reps, library=None):
    """One ``ell_spmm`` case against its plain version.  The library
    column is one cuSPARSE CSR product, or ``library``: a callable that
    computes the same function (timed as one)."""
    from repro_torch.kernels.ell_spmm import ell_spmm, ell_spmm_plain

    out = ell_spmm(x, nbr, w)
    ref = ell_spmm_plain(x, nbr, w)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    check(err <= ELL_TOL, f"ell_spmm {name}: max abs err {err} > {ELL_TOL}")
    q, n_src, f = x.shape
    _, n_dst, k = nbr.shape
    valid = w != 0
    nnz = int(valid.sum())
    rows = int(torch.unique(nbr[valid].long() +
                            (torch.arange(q, device=x.device) * n_src)
                            [:, None, None].expand_as(nbr)[valid]).numel())
    if library is None:
        # library yardstick: one cuSPARSE CSR product over the
        # block-diagonal [Q·Nd, Q·Ns] operator (built outside the timing)
        dst = torch.arange(q * n_dst, device=x.device)[:, None].expand(-1, k)
        src = nbr.long() + (torch.arange(q, device=x.device) *
                            n_src)[:, None, None]
        coo = torch.sparse_coo_tensor(
            torch.stack([dst.reshape(q * n_dst, k)[valid.reshape(-1, k)],
                         src.reshape(q * n_dst, k)[valid.reshape(-1, k)]]),
            w[valid], (q * n_dst, q * n_src)).coalesce()
        csr = coo.to_sparse_csr()
        x2 = x.reshape(q * n_src, f)

        def library():
            return torch.sparse.mm(csr, x2).reshape(q, n_dst, f)
    lib_err = float((library() - ref).abs().max())
    b_ms, b_by = bound_ms(rows * f * 4 + 2 * nbr.numel() * 4 +
                          q * n_dst * f * 4, 2.0 * nnz * f)
    kernel_ms = cuda_ms(lambda: ell_spmm(x, nbr, w), reps)
    # every valid slot gathers one row slice of F floats: the bytes the
    # kernel moves through L2, against the bound's each-row-once count
    gathered = nnz * f * 4
    rec = {"kernel": "ell_spmm", "case": name,
           "shape": {"x": list(x.shape), "nbr": list(nbr.shape)},
           "nnz": nnz, "max_abs_err": err, "library_max_abs_err": lib_err,
           "kernel_ms": kernel_ms, "gathered_bytes": gathered,
           "gathered_tb_s": gathered / (kernel_ms * 1e-3) / 1e12,
           "plain_ms": cuda_ms(lambda: ell_spmm_plain(x, nbr, w),
                               max(reps // 5, 1)),
           "library_ms": cuda_ms(library, reps),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _reverse_w(w, rslot):
    """The reversed lists' weights, gathered through ``rslot`` as the
    training backward gathers them (``-1`` pads weigh 0)."""
    q = w.shape[0]
    rw = torch.gather(w.reshape(q, -1), 1,
                      rslot.reshape(q, -1).clamp(min=0).long())
    return torch.where(rslot >= 0, rw.reshape(rslot.shape),
                       torch.zeros((), device=w.device)).contiguous()


def _remote_ell_cases(gen, reps):
    """The p2p wire's remote aggregation at ``arxiv-q16-p2p-full``'s shapes
    (the OGBN-Arxiv analogue at its full size, cut at random into 16): the
    forward over the remote lists, compact ``[16, C, 256]`` -> partition,
    and the cotangent over their reversed lists, partition -> compact.  The
    library column is the edge-list chain the lists replaced, timed as
    one: the gather of every remote edge's row, the weight product, the
    zero-fill and the ``index_add`` (backward: its mirror, as autograd ran
    it)."""
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.halo import attach_p2p, remote_ell, remote_ell_stats
    from repro_torch.graph.partition import partition_graph
    from repro_torch.graph.synthetic import citation_graph

    pg = partition_graph(
        citation_graph(n=169_343, n_classes=40, feat_dim=128,
                       avg_degree=13.8, homophily=0.82, feature_signal=0.06,
                       seed=0), 16, scheme="random", seed=0)
    dev = torch.device("cuda")
    graph = attach_p2p(pg.device_arrays(dev), pg, dev)
    del pg
    lists = remote_ell(graph)
    q, p_sz, _ = lists["remote_nbr"].shape
    n_c = lists["remote_rnbr"].shape[1]
    f = 256
    src, dst, w = (graph[k] for k in ("remote_src_p2p", "remote_dst",
                                      "remote_w"))
    off_c = (torch.arange(q, device=dev) * n_c)[:, None]
    x = torch.randn((q, n_c, f), generator=gen, device=dev)
    cot = torch.randn((q, p_sz, f), generator=gen, device=dev)

    def chain_forward():
        return gp._remote_scatter(w[..., None] * gp._rows_of(x, src, n_c),
                                  dst, p_sz)

    def chain_backward():
        g1 = torch.cat([cot, cot.new_zeros((q, 1, f))], 1)  # dropped row P
        vals = w[..., None] * gp._rows_of(g1, dst, p_sz + 1)
        return torch.zeros((q * n_c, f), device=dev).index_add(
            0, (src.long() + off_c).reshape(-1),
            vals.reshape(-1, f)).reshape(q, n_c, f)

    emit({"kernel": "ell_spmm", "case": "remote_lists",
          **remote_ell_stats(graph), "real_edges": int((w != 0).sum()),
          "padded_edges": w.numel(),
          "library": "gather · product · zero-fill · index_add"})
    return [_ell_case("remote_f256", x, lists["remote_nbr"],
                      lists["remote_ell_w"], reps, library=chain_forward),
            _ell_case("remote_reverse_f256", cot, lists["remote_rnbr"],
                      _reverse_w(lists["remote_ell_w"],
                                 lists["remote_rslot"]),
                      reps, library=chain_backward)]


def _pack_case(name, x, kept, reps):
    from repro_torch.kernels.varco_pack import (LANE, varco_pack,
                                                varco_pack_plain)

    out = varco_pack(x, kept)
    ref = varco_pack_plain(x, kept)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"varco_pack {name}: not bitwise equal")
    q, n, f = x.shape
    k = kept.shape[1]
    xb = x.reshape(q, n, f // LANE, LANE)
    idx = kept.long()[:, None, :, None].expand(q, n, k, LANE)
    b_ms, b_by = bound_ms(2 * q * n * k * LANE * 4 + kept.numel() * 4)
    rec = {"kernel": "varco_pack", "case": name,
           "shape": {"x": list(x.shape), "kept": list(kept.shape)},
           "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: varco_pack(x, kept), reps),
           "plain_ms": cuda_ms(lambda: varco_pack_plain(x, kept), reps),
           "library_ms": cuda_ms(lambda: torch.gather(xb, 2, idx), reps),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec, out


def _unpack_case(name, packed, inv, reps):
    from repro_torch.kernels.varco_pack import (LANE, varco_unpack,
                                                varco_unpack_plain)

    out = varco_unpack(packed, inv)
    ref = varco_unpack_plain(packed, inv)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"varco_unpack {name}: not bitwise equal")
    q, m, kf = packed.shape
    nb = inv.shape[1]
    b_ms, b_by = bound_ms(q * m * kf * 4 + q * m * nb * LANE * 4 +
                          inv.numel() * 4)
    rec = {"kernel": "varco_unpack", "case": name,
           "shape": {"packed": list(packed.shape), "inv": list(inv.shape)},
           "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: varco_unpack(packed, inv), reps),
           "plain_ms": cuda_ms(lambda: varco_unpack_plain(packed, inv),
                               reps),
           "library_ms": None,   # no single PyTorch call zero-fills
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _quant_case(name, x, kept, inv, width, reps):
    """The fused codecs at one shape and width: ``varco_pack_quant`` then
    ``varco_unpack_quant`` on its output, each bitwise against its plain
    version.  Returns the two records."""
    from repro_torch.kernels.ops import qmax_of
    from repro_torch.kernels.varco_pack import (LANE, varco_pack_quant,
                                                varco_pack_quant_plain,
                                                varco_unpack_quant,
                                                varco_unpack_quant_plain)

    b, h, f = x.shape
    k, nb = kept.shape[1], inv.shape[1]
    qmax = qmax_of(width).expand(b).contiguous().to(x.device)
    payload, scales = varco_pack_quant(x, kept, qmax, width)
    p_ref, s_ref = varco_pack_quant_plain(x, kept, qmax, width)
    out = varco_unpack_quant(payload, scales, inv, width)
    out_ref = varco_unpack_quant_plain(payload, scales, inv, width)
    torch.cuda.synchronize()
    check(torch.equal(payload, p_ref) and torch.equal(scales, s_ref),
          f"varco_pack_quant {name}: not bitwise equal")
    check(torch.equal(out, out_ref),
          f"varco_unpack_quant {name}: not bitwise equal")
    pay_bytes = b * h * k * LANE * width // 8
    sc_bytes = b * h * k * 4
    shape = {"x": list(x.shape), "kept": list(kept.shape), "width": width}
    recs = []
    for kernel, fn, plain, n_bytes in (
            ("varco_pack_quant",
             lambda: varco_pack_quant(x, kept, qmax, width),
             lambda: varco_pack_quant_plain(x, kept, qmax, width),
             b * h * k * LANE * 4 + kept.numel() * 4 + b * 4 + pay_bytes +
             sc_bytes),
            ("varco_unpack_quant",
             lambda: varco_unpack_quant(payload, scales, inv, width),
             lambda: varco_unpack_quant_plain(payload, scales, inv, width),
             pay_bytes + sc_bytes + inv.numel() * 4 + b * h * nb * LANE * 4)):
        b_ms, b_by = bound_ms(n_bytes)
        rec = {"kernel": kernel, "case": name, "shape": shape,
               "max_abs_err": 0.0, "kernel_ms": cuda_ms(fn, reps),
               "plain_ms": cuda_ms(plain, max(reps // 5, 1)),
               "library_ms": None,   # no single PyTorch call quantises
               "bound_ms": b_ms, "bound_by": b_by}
        emit(rec)
        recs.append(rec)
    return recs


def int32_ops_per_s() -> float:
    """The card's peak 32-bit integer rate: integer results per SM per
    clock × SMs (``torch.cuda.get_device_properties``) × the SM's maximum
    clock (``nvidia-smi``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    return INT_OPS_PER_SM_CLOCK * sms * mhz * 1e6


def _mask_keys(q: int, seed: int, dev):
    from repro_torch import prng
    from repro_torch.kernels.randmask import keys_tensor

    k = prng.fold_in(prng.key(seed), 1)
    return keys_tensor(np.stack([prng.fold_in(k, j) for j in range(q)]), dev)


#: elements a plain-version call of a gradient-leaf mask case covers: the
#: plain version's int64 Threefry temporaries over a whole 671M-element
#: MLP leaf would take tens of GB, so it runs over consecutive chunks,
#: each from its counter offset (the same function, element for element)
MASK_PLAIN_CHUNK = 1 << 26


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _mask_case(name, x, rate, unbiased, reps, int_rate, chunked=False):
    """``random_mask`` at one shape and rate (f32, or bf16: the
    ``random_mask_bf16`` record): output and kept counts bitwise against
    the plain version; kernel and plain times beside the bound (76
    integer ops an element at the integer issue ceiling, against the
    bytes of x and out).  ``chunked`` (x ``[1, ...]``): the plain version
    runs over ``MASK_PLAIN_CHUNK`` elements at a time."""
    from repro_torch.kernels.randmask import random_mask, random_mask_plain

    keys = _mask_keys(x.shape[0], int(rate * 10) + int(unbiased), x.device)
    p = float(np.float32(1.0) / np.float32(rate))
    scale = float(np.float32(rate)) if unbiased else 1.0
    out, counts = random_mask(x, keys, p, scale, count=True)
    if chunked:
        flat_x, flat_out = x.reshape(1, -1), out.reshape(1, -1)
        starts = range(0, flat_x.shape[1], MASK_PLAIN_CHUNK)

        def plain():
            return [random_mask_plain(flat_x[:, s:s + MASK_PLAIN_CHUNK],
                                      keys, p, scale, offset=s)
                    for s in starts]

        equal, kept = True, 0
        for s in starts:
            ref, c = random_mask_plain(flat_x[:, s:s + MASK_PLAIN_CHUNK],
                                       keys, p, scale, offset=s, count=True)
            equal &= _bitwise(flat_out[:, s:s + MASK_PLAIN_CHUNK], ref)
            kept += int(c.sum())
            del ref
        equal &= kept == int(counts.sum())
    else:
        def plain():
            return random_mask_plain(x, keys, p, scale)

        ref, ref_counts = random_mask_plain(x, keys, p, scale, count=True)
        equal = _bitwise(out, ref) and torch.equal(counts, ref_counts)
        del ref
    torch.cuda.synchronize()
    kernel = "random_mask_bf16" if x.dtype == torch.bfloat16 else \
        "random_mask"
    check(equal, f"{kernel} {name}: not bitwise equal to the plain version")
    n = x.numel()
    b_ms, b_by = bound_ms(2 * n * x.element_size() + keys.numel() * 4,
                          MASK_INT_OPS * n, int_rate)
    rec = {"kernel": kernel, "case": name,
           "shape": {"x": list(x.shape), "dtype": str(x.dtype),
                     "rate": rate, "unbiased": unbiased},
           "kept_fraction": float(counts.sum()) / n, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: random_mask(x, keys, p, scale),
                                reps),
           "plain_ms": cuda_ms(plain, max(reps // 5, 1)),
           "plain_chunked": chunked,
           "library_ms": None,   # PyTorch has no Threefry call
           "bound_ms": b_ms, "bound_by": b_by,
           "int_ops": MASK_INT_OPS * n, "int32_ops_per_s": int_rate}
    emit(rec)
    return rec


def _round_keys(b: int, seed: int, dev):
    """``b`` stochastic-rounding keys (``round_key`` of one exchange key,
    one per batch row) as the int32 ``[b, 2]`` tensor the kernels read."""
    from repro_torch import prng
    from repro_torch.kernels.ops import round_key
    from repro_torch.kernels.randmask import keys_tensor

    k = prng.fold_in(prng.key(seed), 1)
    return keys_tensor(np.stack([round_key(k, r) for r in range(b)]), dev)


def _stoch_case(name, x, kept, width, reps, int_rate):
    """The fused codec's stochastic instantiation at one shape and width:
    payload and scales bitwise against the plain version (``floor(v + u)``
    with ``prng.random_bits_torch`` uniforms); kernel, plain and, on the
    same inputs, the round-half-even kernel's times beside the bound (the
    bytes of the rint case against 76 integer ops per quantised element
    at the integer issue ceiling)."""
    from repro_torch.kernels.ops import qmax_of
    from repro_torch.kernels.varco_pack import (
        LANE, varco_pack_quant, varco_pack_quant_stochastic,
        varco_pack_quant_stochastic_plain)

    b, h, f = x.shape
    k = kept.shape[1]
    qmax = qmax_of(width).expand(b).contiguous().to(x.device)
    keys = _round_keys(b, width + f, x.device)
    payload, scales = varco_pack_quant_stochastic(x, kept, qmax, keys, width)
    p_ref, s_ref = varco_pack_quant_stochastic_plain(x, kept, qmax, keys,
                                                     width)
    rint, _ = varco_pack_quant(x, kept, qmax, width)
    torch.cuda.synchronize()
    check(torch.equal(payload, p_ref) and torch.equal(scales, s_ref),
          f"varco_pack_quant_stochastic {name}: not bitwise equal")
    check(not torch.equal(payload, rint),
          f"varco_pack_quant_stochastic {name}: rounds like rint")
    n = b * h * k * LANE
    n_bytes = n * 4 + kept.numel() * 4 + b * 4 + keys.numel() * 4 + \
        n * width // 8 + b * h * k * 4
    b_ms, b_by = bound_ms(n_bytes, MASK_INT_OPS * n, int_rate)
    rec = {"kernel": "varco_pack_quant_stochastic", "case": name,
           "shape": {"x": list(x.shape), "kept": list(kept.shape),
                     "width": width},
           "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: varco_pack_quant_stochastic(
               x, kept, qmax, keys, width), reps),
           "rint_kernel_ms": cuda_ms(lambda: varco_pack_quant(
               x, kept, qmax, width), reps),
           "plain_ms": cuda_ms(lambda: varco_pack_quant_stochastic_plain(
               x, kept, qmax, keys, width), max(reps // 10, 1)),
           "library_ms": None,   # PyTorch has no Threefry call
           "bound_ms": b_ms, "bound_by": b_by,
           "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
           "int_ops": MASK_INT_OPS * n, "int32_ops_per_s": int_rate}
    emit(rec)
    return rec


def _uniform_case(name, b, n, reps, int_rate, dev):
    """``random_uniform`` over ``b`` keys of ``n`` counters: bitwise
    against the plain version; bound by 76 integer ops an element against
    the 4 bytes it writes."""
    from repro_torch.kernels.randmask import (random_uniform,
                                              random_uniform_plain)

    keys = _round_keys(b, n, dev)
    out = random_uniform(keys, n)
    ref = random_uniform_plain(keys, n)
    torch.cuda.synchronize()
    check(torch.equal(out, ref),
          f"random_uniform {name}: not bitwise equal to the plain version")
    b_ms, b_by = bound_ms(b * n * 4 + keys.numel() * 4, MASK_INT_OPS * b * n,
                          int_rate)
    rec = {"kernel": "random_uniform", "case": name,
           "shape": {"keys": list(keys.shape), "n": n}, "max_abs_err": 0.0,
           "kernel_ms": cuda_ms(lambda: random_uniform(keys, n), reps),
           "plain_ms": cuda_ms(lambda: random_uniform_plain(keys, n),
                               max(reps // 10, 1)),
           "library_ms": None,   # PyTorch has no Threefry call
           "bound_ms": b_ms, "bound_by": b_by,
           "int_ops": MASK_INT_OPS * b * n, "int32_ops_per_s": int_rate}
    emit(rec)
    return rec


def _grad_err(fn, ref_fn, x, gen):
    """Max abs difference between ``fn``'s input cotangent (the autograd
    function, kernels on the card) and ``ref_fn``'s (the plain version's
    autograd) for one random upstream cotangent."""
    a = x.detach().clone().requires_grad_(True)
    y = fn(a)
    g = torch.randn(y.shape, generator=gen, device=x.device)
    (ga,) = torch.autograd.grad(y, a, g)
    r = x.detach().clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(ref_fn(r), r, g)
    torch.cuda.synchronize()
    return float((ga - gr).abs().max())


def vjp_phase(eng, gen):
    """Each autograd function's backward on the card at the training
    path's shapes against the plain version's autograd, within 1e-4."""
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmm import ell_spmm_plain
    from repro_torch.kernels.randmask import random_mask_plain
    from repro_torch.kernels.varco_pack import (LANE, varco_pack_plain,
                                                varco_unpack_plain,
                                                worker_block_maps_pos)

    dev = eng.device
    meta, graph = eng.meta, eng.graph
    q, p_sz, b_sz = meta.q, meta.part_size, meta.halo_size
    d_hops, h_w = max(q - 1, 1), meta.p2p_hop_width
    kept, inv, _ = worker_block_maps_pos(prng.key(9), q, 2, 1)
    kept, inv = torch.from_numpy(kept).to(dev), torch.from_numpy(inv).to(dev)
    nbr, w = graph["ell_nbr"], graph["ell_w"]
    rnbr, rslot = graph["ell_rnbr"], graph["ell_rslot"]
    bk = (torch.arange(q * d_hops, device=dev) // d_hops)
    kept_b, inv_b = kept[bk].contiguous(), inv[bk].contiguous()
    qmax = torch.full((q * d_hops,), 127.0, device=dev)
    mkeys = _mask_keys(q, 7, dev)
    cases = {
        "random_mask": (lambda a: ops.random_mask(a, mkeys, 0.25, 4.0)[0],
                        lambda a: random_mask_plain(a, mkeys, 0.25, 4.0)[0],
                        (q, b_sz, 256)),
        "ell_aggregate": (
            lambda a: ops.ell_aggregate(a, nbr, w, rnbr, rslot),
            lambda a: ell_spmm_plain(a, nbr, w), (q, p_sz, 256)),
        "wire_pack": (lambda a: ops.wire_pack(a, kept, inv),
                      lambda a: varco_pack_plain(a, kept), (q, b_sz, 256)),
        "wire_unpack": (lambda a: ops.wire_unpack(a, inv, kept),
                        lambda a: varco_unpack_plain(a, inv),
                        (q, b_sz, LANE)),
        "quant_hop": (lambda a: ops.quant_hop(a, kept_b, inv_b, qmax, 8),
                      lambda a: varco_unpack_plain(
                          varco_pack_plain(a, kept_b), inv_b),
                      (q * d_hops, h_w, 256)),
    }
    errs = {}
    for name, (fn, ref_fn, shape) in cases.items():
        x = torch.randn(shape, generator=gen, device=dev)
        errs[name] = _grad_err(fn, ref_fn, x, gen)
        check(errs[name] <= GRAD_TOL,
              f"{name} backward differs from the plain autograd by "
              f"{errs[name]}")
    emit({"phase": "vjp", "max_abs_err": errs})


def kernels_phase(eng, reps: int = 20):
    """Every kernel at the slice's shapes (taken from the engine's graph:
    ELL lists, boundary block, hop buffers) and at one ragged shape.
    Returns ``{kernel: record at its main-path shape}`` with the largest
    error over all of its cases."""
    from repro_torch import prng
    from repro_torch.kernels.varco_pack import LANE, worker_block_maps_pos

    dev = eng.device
    meta, graph = eng.meta, eng.graph
    q, p_sz, b_sz = meta.q, meta.part_size, meta.halo_size
    d_hops, h_w = max(q - 1, 1), meta.p2p_hop_width
    gen = torch.Generator(device=dev).manual_seed(1)
    main, worst = {}, {}

    def keep(rec, is_main):
        worst[rec["kernel"]] = max(worst.get(rec["kernel"], 0.0),
                                   rec["max_abs_err"])
        if is_main:
            main[rec["kernel"]] = rec

    for f in (128, 256):
        x = torch.randn((q, p_sz, f), generator=gen, device=dev)
        keep(_ell_case(f"slice_f{f}", x, graph["ell_nbr"], graph["ell_w"],
                       reps), f == 256)
    # the training backward: the same kernel over the reversed lists, with
    # the forward weights gathered through rslot
    keep(_ell_case("reverse_f256",
                   torch.randn((q, p_sz, 256), generator=gen, device=dev),
                   graph["ell_rnbr"],
                   _reverse_w(graph["ell_w"], graph["ell_rslot"]), reps),
         False)
    for rec in _remote_ell_cases(gen, reps):
        keep(rec, False)
    for f in (128, 256):
        nb = f // LANE
        publish = torch.randn((q, b_sz, f), generator=gen, device=dev)
        for k in sorted({nb, 1}):
            kept, inv, _ = worker_block_maps_pos(
                prng.fold_in(prng.key(0), f + k), q, nb, k)
            kept_t = torch.from_numpy(kept).to(dev)
            inv_t = torch.from_numpy(inv).to(dev)
            rec, _ = _pack_case(f"slice_f{f}_k{k}", publish, kept_t, reps)
            keep(rec, f == 256 and k == nb)
            hops = torch.randn((q, d_hops * h_w, k * LANE), generator=gen,
                               device=dev)
            keep(_unpack_case(f"slice_f{f}_k{k}", hops, inv_t, reps),
                 f == 256 and k == nb)
    # the fused quantised codecs at the hop shapes: B = Q·D (sender, ring
    # hop) rows of H hop rows each, one kept map per sender
    bk = np.arange(q * d_hops) // d_hops
    for f, k in ((256, 2), (256, 1), (128, 1)):
        kept, inv, _ = worker_block_maps_pos(prng.key(f + k), q, f // LANE,
                                             k)
        x = torch.randn((q * d_hops, h_w, f), generator=gen, device=dev)
        for width in (8, 4, 2):
            for rec in _quant_case(
                    f"hop_f{f}_k{k}_w{width}", x,
                    torch.from_numpy(kept[bk]).to(dev),
                    torch.from_numpy(inv[bk]).to(dev), width, reps):
                keep(rec, (f, k, width) == (256, 2, 8))
    # the dense wire's random mask over the boundary block [Q, B, F] at
    # the exchanged widths, over the rates it takes
    int_rate = int32_ops_per_s()
    for f in (256, 128):
        x = torch.randn((q, b_sz, f), generator=gen, device=dev)
        for rate in (2.0, 4.0, 5.3):
            for unbiased in (False, True):
                keep(_mask_case(f"halo_f{f}_r{rate:g}" +
                                ("_unbiased" if unbiased else ""), x, rate,
                                unbiased, reps, int_rate),
                     (f, rate, unbiased) == (256, 4.0, False))
    keep(_mask_case("ragged", torch.randn((3, 77, 42), generator=gen,
                                          device=dev), 5.3, False, 5,
                    int_rate), False)
    # the bf16 instantiation over granite-3-2b's gradient leaves as the
    # one-worker VARCO step hands them over (x[None]): the embedding and
    # an MLP projection stacked over the 40 layers, at step 0's rate 128;
    # and ragged, unbiased
    for leaf, shape in (("embed", (1, 49155, 2048)),
                        ("mlp_w_up", (1, 40, 2048, 8192))):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        keep(_mask_case(f"granite_{leaf}_r128", x, 128.0, False, reps,
                        int_rate, chunked=True), leaf == "embed")
        del x
    keep(_mask_case("ragged_bf16_unbiased",
                    torch.randn((3, 77, 42), generator=gen, device=dev,
                                dtype=torch.bfloat16), 5.3, True, 5,
                    int_rate), False)
    # stochastic rounding: the fused codec at the p2p hop shape (w8, w4)
    # and at the packed all-gather's [Q, B, F] (w4), and the uniforms of
    # the mixed-width hops over the same [Q·D, H·K·128]
    kept, _, _ = worker_block_maps_pos(prng.key(258), q, 2, 2)
    x = torch.randn((q * d_hops, h_w, 256), generator=gen, device=dev)
    kept_hop = torch.from_numpy(kept[bk]).to(dev)
    for width in (8, 4):
        keep(_stoch_case(f"hop_f256_k2_w{width}", x, kept_hop, width, reps,
                         int_rate), width == 8)
    keep(_stoch_case("packed_f256_k2_w4",
                     torch.randn((q, b_sz, 256), generator=gen, device=dev),
                     torch.from_numpy(kept).to(dev), 4, reps, int_rate),
         False)
    kept3, _, _ = worker_block_maps_pos(prng.key(5), 3, 3, 2)
    keep(_stoch_case("ragged_w2",
                     torch.randn((3, 1001, 384), generator=gen, device=dev),
                     torch.from_numpy(kept3).to(dev), 2, 5, int_rate), False)
    del x
    keep(_uniform_case("hop_f256_k2", q * d_hops, h_w * 256, reps, int_rate,
                       dev), True)
    keep(_uniform_case("ragged", 3, 1001 * 42 + 1, 5, int_rate, dev), False)
    kept, inv, _ = worker_block_maps_pos(prng.key(4), 3, 3, 2)
    for width in (8, 4, 2):
        for rec in _quant_case(
                f"ragged_w{width}",
                torch.randn((3, 1001, 384), generator=gen, device=dev),
                torch.from_numpy(kept).to(dev), torch.from_numpy(inv).to(dev),
                width, 5):
            keep(rec, False)
    vjp_phase(eng, gen)
    # ragged shapes: odd row counts, a width off the float4 grid, pad slots
    rng = np.random.default_rng(0)
    for f in (42, 384):
        x = torch.randn((3, 1001, f), generator=gen, device=dev)
        nbr = torch.from_numpy(rng.integers(0, 1001, (3, 777, 7))
                               .astype(np.int32)).to(dev)
        w = torch.from_numpy((rng.uniform(size=(3, 777, 7)) *
                              (rng.uniform(size=(3, 777, 7)) > 0.3))
                             .astype(np.float32)).to(dev)
        keep(_ell_case(f"ragged_f{f}", x, nbr, w, 5), False)
    x = torch.randn((3, 1001, 384), generator=gen, device=dev)
    kept, inv, _ = worker_block_maps_pos(prng.key(3), 3, 3, 2)
    rec, packed = _pack_case("ragged", x, torch.from_numpy(kept).to(dev), 5)
    keep(rec, False)
    keep(_unpack_case("ragged", packed, torch.from_numpy(inv).to(dev), 5),
         False)
    for name in main:
        main[name] = {**main[name], "max_abs_err": worst[name]}
    return main


# ---------------------------------------------------------------------------
# phase 3 + 5: the serving slice
# ---------------------------------------------------------------------------


def setup_phase(n_nodes: int, device: str, q: int = 4, seed: int = 0):
    from repro_torch.graph.synthetic import citation_graph
    from repro_torch.nn.gnn import GNNConfig, init_gnn
    from repro_torch.serve import ServingEngine

    t0 = time.perf_counter()
    g = citation_graph(n=n_nodes, feat_dim=128, seed=seed)
    t1 = time.perf_counter()
    cfg = GNNConfig(conv="sage", in_dim=128, hidden=256,
                    out_dim=g.num_classes, layers=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                      device=device)
    eng = ServingEngine(g, params, cfg, q=q, device=device, seed=seed)
    t2 = time.perf_counter()
    emit({"phase": "setup", "nodes": g.num_nodes,
          "directed_edges": g.num_edges, "q": q,
          "part_size": eng.meta.part_size, "halo_size": eng.meta.halo_size,
          "hop_width": eng.meta.p2p_hop_width,
          "ell_degree": int(eng.graph["ell_nbr"].shape[-1]),
          "halo_demand": eng.meta.halo_demand, "policy": str(eng.policy),
          "model": {"conv": cfg.conv, "in": cfg.in_dim, "hidden": cfg.hidden,
                    "out": cfg.out_dim, "layers": cfg.layers},
          "graph_s": t1 - t0, "partition_and_engine_s": t2 - t1})
    return g, cfg, params, eng


def _queries(eng, rng, n_nodes: int, n_edges: int, lat: list) -> int:
    """Submit node and edge queries in bursts through the micro-batcher
    and flush as its window trips; per-query latency (submit -> answer,
    host clock) lands in ``lat``."""
    n = eng.g.num_nodes
    hot = rng.integers(0, n, 32)
    pending: dict[int, float] = {}
    answered = 0
    reqs = [("node", int(u)) for u in np.where(
        rng.uniform(size=n_nodes) < 0.6, rng.choice(hot, n_nodes),
        rng.integers(0, n, n_nodes))] + \
        [("edge", (int(a), int(b))) for a, b in rng.integers(0, n,
                                                             (n_edges, 2))]
    order = rng.permutation(len(reqs))
    for burst in np.array_split(order, max(len(reqs) // 20, 1)):
        for i in burst:
            qy = eng.submit(reqs[i][1], tenant=reqs[i][0])
            pending[id(qy)] = qy.arrival
        while eng.batcher.pending:
            out = eng.flush()
            now = time.monotonic()
            for qy, emb in out:
                lat.append(now - pending.pop(id(qy)))
                check(np.isfinite(emb).all(), "non-finite answer")
                answered += 1
    return answered


def slice_phase(g, cfg, params, eng, seed: int = 0):
    from repro_torch.nn.gnn import centralized_forward

    counters = launch_counters()
    rng = np.random.default_rng(seed)
    lat: list[float] = []
    refreshes = []

    def refresh(force):
        m = eng.refresh(force=force)
        rec = {"force": force, "status": eng.status(),
               "forward_ms": eng.timing["forward_s"] * 1e3,
               "host_copy_ms": eng.timing["host_copy_s"] * 1e3,
               "halo_bits": float(m["halo_bits"]),
               "transport_bits": float(m["transport_bits"])}
        refreshes.append(rec)
        emit({"phase": "refresh", **rec})

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    refresh(True)
    check(eng.status() == "FRESH", "cold refresh is not FRESH")
    last = len(params["layers"]) - 1
    fresh = eng.cache.gather(last, np.arange(g.num_nodes))
    answered = _queries(eng, rng, 150, 50, lat)
    for _ in range(3):
        refresh(False)
        answered += _queries(eng, rng, 100, 40, lat)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    # serving's quantised wire rounds half to even (the JAX engine's
    # explicit default): the rint codec runs here
    for name in ("ell_spmm", "varco_pack", "varco_unpack",
                 "varco_pack_quant", "varco_unpack_quant"):
        check(launches[name] > 0, f"{name} never launched on the serving "
              f"path")
    emb, _ = eng.serve(np.arange(0, g.num_nodes, 97))
    check(np.isfinite(emb).all() and emb.shape[1] == cfg.out_dim,
          "served embeddings malformed")
    ref = centralized_forward(params, cfg, g, device=eng.device)
    err = float(np.abs(fresh - ref.cpu().numpy()).max())
    check(err <= FRESH_TOL,
          f"FRESH answers differ from centralized_forward by {err}")
    lat_ms = np.asarray(lat) * 1e3
    summary = {"phase": "slice", "wall_s": wall, "queries": answered,
               "serve_p50_ms": float(np.percentile(lat_ms, 50)),
               "serve_p99_ms": float(np.percentile(lat_ms, 99)),
               "refresh_forward_ms": [r["forward_ms"] for r in refreshes],
               "refresh_host_copy_ms": [r["host_copy_ms"]
                                        for r in refreshes],
               "ledger_halo_bits": float(eng.ledger.bits),
               "ledger_transport_bits": float(eng.ledger.transport),
               "status": eng.status(), "launches": launches,
               "fresh_vs_centralized_max_abs": err,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
               if eng.device.type == "cuda" else None}
    emit(summary)
    check(answered >= 300, f"only {answered} queries answered")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the training slice
# ---------------------------------------------------------------------------


def _grad_sync_identity(res, g, cfg, params) -> dict:
    """The ``full`` run's step-0 loss and its parameters after one
    ``sgd(0.1)`` step against the centralized loss and one autograd step
    of ``centralized_forward`` on the card."""
    from repro_torch.nn.gnn import (centralized_forward,
                                    masked_loss_and_correct)
    from repro_torch.train.optim import tree_leaves, tree_map

    dev = tree_leaves(params)[0].device
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    logits = centralized_forward(live, cfg, g, device=dev)
    loss_sum, _ = masked_loss_and_correct(
        logits, torch.from_numpy(g.labels).to(dev),
        torch.from_numpy(g.train_mask).to(dev))
    loss = loss_sum / int(g.train_mask.sum())
    grads = torch.autograd.grad(loss, tree_leaves(live))
    loss = float(loss.detach())
    p_err = max(float((got - (p.detach() - 0.1 * gr)).abs().max())
                for got, p, gr in zip(tree_leaves(res.params),
                                      tree_leaves(live), grads))
    return {"loss_err": abs(res.history.loss[0] - loss),
            "param_err": p_err, "centralized_loss": loss}


#: the dense and packed all-gather runs of the train phase: name ->
#: (policy spec, compressor, wire, epochs); the quickstart's three, the
#: packed wire's VARCO, and one epoch each of the other compressors
ALLGATHER_RUNS = {
    "dense_full": ("full", None, "dense", TRAIN_EPOCHS),
    "dense_fixed4": ("fixed:4", "randmask", "dense", TRAIN_EPOCHS),
    "dense_varco": ("varco:linear:5", "randmask", "dense", TRAIN_EPOCHS),
    "packed_varco": ("varco:linear:5", "blockmask", "packed", TRAIN_EPOCHS),
    "dense_topk4": ("fixed:4", "topk", "dense", 1),
    "dense_int8_8": ("fixed:8", "int8", "dense", 1),
}


def _wire_identity(eng, params, seed: int = 0) -> dict:
    """At rate 2 over a 256-wide exchange on the card: the packed halo
    against the dense ``blockmask`` halo (bitwise), the p2p wire's remote
    values against the same (bitwise), and the packed transport of one
    exchange at each exchanged width against ``halo_demand × K·128 ×
    32``."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.kernels.varco_pack import LANE

    pg, graph, q = eng.pg, eng.graph, eng.pg.q
    gen = torch.Generator(device=eng.device).manual_seed(seed + 5)
    pol = CommPolicy.parse("fixed:2", 1, compressor="blockmask")
    metas = {"dense": gp.DistMeta.build(pg, params, wire="dense"),
             "packed": gp.DistMeta.build(pg, params, wire="packed"),
             "p2p": eng.meta}
    tok, transport = {}, {}
    for f in (128, 256):
        x = torch.randn((q, pg.part_size, f), generator=gen,
                        device=eng.device)
        key = prng.fold_in(prng.key(seed + 3), f)
        for wire, meta in metas.items():
            agg = gp._make_aggregate_emulated(
                graph, meta, pol, pol.rate(0), key,
                packed_k=dict(gp._packed_k_for(meta, 2.0)))
            tok[wire, f], bits = agg.start(0, x)
            if wire == "packed":
                transport[f] = float(bits[1])
    valid = graph["remote_w"] != 0
    via_dense = tok["dense", 256].index_select(
        0, graph["remote_src"].long().reshape(-1)).reshape(q, -1, 256)
    p2p = tok["p2p", 256]
    via_p2p = gp._rows_of(p2p, graph["remote_src_p2p"], p2p.shape[1])
    torch.cuda.synchronize()
    want = {f: float(np.float32(pg.halo_demand * max(f // LANE // 2, 1) *
                                LANE * 32.0)) for f in (128, 256)}
    return {"packed_equals_dense_blockmask": all(
                torch.equal(tok["packed", f], tok["dense", f])
                for f in (128, 256)),
            "p2p_equals_dense_blockmask": torch.equal(via_p2p[valid],
                                                      via_dense[valid]),
            "packed_transport_bits": transport,
            "halo_demand_x_kept_x_32": want,
            "packed_transport_exact": transport == want}


def train_phase(g, cfg, params, eng, seed: int = 0):
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist.ratectl import exchange_widths
    from repro_torch.train.optim import sgd
    from repro_torch.train.trainer import train_gnn

    counters = launch_counters()
    pg = eng.pg
    common = dict(hidden=cfg.hidden, layers=cfg.layers, wire="p2p",
                  seed=seed, eval_every=1, device=eng.device, params=params)
    full_bits = 2.0 * 32.0 * pg.halo_demand * sum(exchange_widths(cfg)) * \
        TRAIN_EPOCHS
    half = 0.5 * full_bits
    specs = {"full": "full", "varco": "varco:linear:5",
             "auto_w8": f"auto:budget:{half:g}:w8",
             "auto_error_w8": f"auto:error:{half:g}:w8",
             "auto_stale": f"auto:stale:{half:g}"}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one = train_gnn(pg, policy=CommPolicy.parse("full", 1), epochs=1,
                    optimizer=sgd(0.1), **common)
    one_dense = train_gnn(pg, policy=CommPolicy.parse("full", 1), epochs=1,
                          optimizer=sgd(0.1), **{**common, "wire": "dense"})
    runs, quant_launches, mask_launches = {}, {}, {}
    plan = {name: (spec, "blockmask", "p2p", TRAIN_EPOCHS)
            for name, spec in specs.items()}
    plan.update(ALLGATHER_RUNS)
    plan["packed_auto_w4"] = (f"auto:budget:{half:g}:w4", "blockmask",
                              "packed", TRAIN_EPOCHS)
    for name, (spec, comp, wire, epochs) in plan.items():
        before = {k: fn.launches for k, fn in counters.items()}
        res = train_gnn(pg, policy=CommPolicy.parse(
            spec, epochs, compressor=comp), epochs=epochs,
            **{**common, "wire": wire})
        runs[name] = res.history
        quant_launches[name] = {
            k: counters[k].launches - before[k]
            for k in ("varco_pack_quant", *TRAIN_QUANT_KERNELS)}
        mask_launches[name] = counters["random_mask"].launches - \
            before["random_mask"]
        h = res.history
        for i, ep in enumerate(h.epoch):
            emit({"phase": "train_epoch", "run": name, "policy": spec,
                  "compressor": comp or "randmask", "wire": wire,
                  "epoch": ep, "loss": h.loss[i], "rate": h.rate[i],
                  "width": h.width[i], "step_ms": h.step_s[i] * 1e3,
                  "transport_gfloats": h.transport_gfloats[i],
                  "halo_gfloats": h.halo_gfloats[i],
                  "test_acc": h.test_acc[i]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ident = _grad_sync_identity(one, g, cfg, params)
    ident_dense = _grad_sync_identity(one_dense, g, cfg, params)
    wire_ident = _wire_identity(eng, params, seed)
    summary = {"phase": "train", "wall_s": wall, "epochs": TRAIN_EPOCHS,
               "launches": launches, "quant_launches": quant_launches,
               "random_mask_launches": mask_launches,
               "grad_sync_identity": ident,
               "dense_grad_sync_identity": ident_dense,
               "wire_identity": wire_ident, "peak_mem_gb": peak,
               "step_ms_median": {
                   k: float(np.median(np.asarray(h.step_s[1:] or
                                                 h.step_s) * 1e3))
                   for k, h in runs.items()},
               "final_loss": {k: h.loss[-1] for k, h in runs.items()},
               "transport_gfloats": {k: h.transport_gfloats[-1]
                                     for k, h in runs.items()}}
    emit(summary)
    for name in GNN_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the training "
              f"path")
    # the card's default rounding is stochastic: the w8 run's codec is the
    # stochastic instantiation, and the rint one never runs in train_gnn
    for name in TRAIN_QUANT_KERNELS:
        check(quant_launches["auto_w8"][name] > 0,
              f"{name} never launched during the w8 run")
    if min(runs["packed_auto_w4"].width) < 32:   # a sub-byte all-gather
        for name in TRAIN_QUANT_KERNELS:
            check(quant_launches["packed_auto_w4"][name] > 0,
                  f"{name} never launched during the packed auto run")
    check(launches["varco_pack_quant"] == 0, "train_gnn launched the rint "
          "codec: the card's default wire rounding is stochastic")
    check(ident["loss_err"] <= GRAD_TOL and ident["param_err"] <= GRAD_TOL,
          f"grad-sync identity broken: {ident}")
    check(ident_dense["loss_err"] <= GRAD_TOL and
          ident_dense["param_err"] <= GRAD_TOL,
          f"grad-sync identity broken on the dense wire: {ident_dense}")
    check(wire_ident["packed_equals_dense_blockmask"],
          "the packed halo differs from the dense blockmask halo")
    check(wire_ident["p2p_equals_dense_blockmask"],
          "the p2p remote values differ from the dense blockmask halo")
    check(wire_ident["packed_transport_exact"],
          f"packed transport is not halo_demand x K·128 x 32: {wire_ident}")
    for name, (spec, comp, wire, _) in plan.items():
        compresses = wire == "dense" and spec != "full" and \
            comp in ("randmask", "int8")
        check((mask_launches[name] > 0) == compresses,
              f"{name}: random_mask launched {mask_launches[name]} times")
    for name, h in runs.items():
        check(bool(np.isfinite(h.loss).all()), f"{name}: non-finite loss")
    for name in ("full", "dense_full"):
        check(runs[name].loss[-1] < runs[name].loss[0],
              f"{name}: loss did not fall ({runs[name].loss})")
    return launches, runs


# ---------------------------------------------------------------------------
# phase 6b: closed-loop steps — stochastic rounding, hop reuse, bytes
# ---------------------------------------------------------------------------

#: the plain versions the auto phase swaps in for the wire kernels
WIRE_KERNELS = ("varco_pack", "varco_unpack", "varco_pack_quant",
                "varco_pack_quant_stochastic", "varco_unpack_quant",
                "random_uniform")


@contextlib.contextmanager
def plain_codecs():
    """Run the wire with the plain versions in place of its kernels (for
    the comparison of the two on the card only)."""
    from repro_torch.kernels import ops

    saved = {n: getattr(ops, n) for n in WIRE_KERNELS}
    for n in WIRE_KERNELS:
        setattr(ops, n, getattr(ops, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def _pair_map(q: int, off: float, diag: float) -> np.ndarray:
    eye = np.eye(q, dtype=bool)
    return np.where(eye, diag, off).astype(np.float32)


#: the stochastic steps: name -> (wire, rate, off-diagonal width, one pair
#: left at fp32 (the mixed-width path through random_uniform))
STOCH_RUNS = {"p2p_w8": ("p2p", 1.0, 8.0, False),
              "packed_w4": ("packed", 1.0, 4.0, False),
              "p2p_mixed": ("p2p", 2.0, 8.0, True)}


def _conservation(graph, meta, wire, width, x, seed) -> dict:
    """One exchange at rate 2, every pair at ``width``, with ``wire_out``
    capture: each p2p hop ships ``ceil(rows · k · (128·w + 32) / 8)``
    bytes over its genuine rows and each pair ``ceil(ledger bits / 8)``;
    each packed row ``ceil(k · (128·w + 32) / 8)``."""
    import math

    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.kernels.varco_pack import LANE

    q = meta.q
    rm, wm = _pair_map(q, 2.0, 1.0), _pair_map(q, float(width), 32.0)
    cap: list = []
    agg = gp._make_aggregate_emulated(
        graph, meta, CommPolicy.parse("fixed:2", 1, compressor="blockmask"),
        torch.ones(()), prng.key(seed), rate_map=rm, width_map=wm,
        packed_k=dict(gp._packed_pair_k_for(meta, rm)),
        store_w=gp._packed_store_w(meta, wm), wire_out=cap)
    with torch.no_grad():
        _, bits = agg.start(1, x)
    torch.cuda.synchronize()
    payload, scales = cap[0]
    k = max(x.shape[-1] // LANE // 2, 1)
    row = payload.shape[-1] + 4 * scales.shape[-1]
    want_row = math.ceil(k * (LANE * width + 32.0) / 8.0)
    out = {"wire": wire, "width": width, "payload": list(payload.shape),
           "row_bytes": row, "want_row_bytes": want_row}
    if wire == "packed":
        out["ok"] = payload.dtype == torch.uint8 and row == want_row
        return out
    rows = graph["p2p_send_valid"].sum(-1).long().cpu().numpy()  # [Q, D]
    meas = np.zeros((q, q))
    ok = payload.dtype == torch.uint8
    for j in range(q):
        for d in range(q - 1):
            m = int(rows[j, d]) * row
            ok &= m == math.ceil(int(rows[j, d]) * k *
                                 (LANE * width + 32.0) / 8.0)
            meas[(j + d + 1) % q, j] += m
    pair_t = bits[2:2 + q * q].cpu().numpy().astype(np.float64).reshape(q, q)
    out["pair_bytes"] = float(meas.sum())
    out["ok"] = bool(ok and (meas == np.ceil(pair_t / 8.0)).all())
    return out


def auto_phase(eng, params, cfg, seed: int = 0) -> dict:
    """Launch counts set to 0, then three ``make_auto_train_step(rounding=
    "stochastic")`` steps (p2p w8 and packed w4 through the fused
    stochastic codec, a mixed-width p2p plan through ``random_uniform``);
    counts read right after.  Then each step's layer-1 halo against the
    same exchange with the plain codecs (bitwise) and its loss against
    the same step's (within 1e-4), a ``stale`` step with every pair
    skipped (0 transport bits, its halo the cache bitwise), and byte
    conservation of a w4 packed and a w8 p2p exchange."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.dist.ratectl import (RatePlan, init_halo_cache,
                                          init_wire_residuals,
                                          make_auto_train_step)
    from repro_torch.train.optim import sgd

    counters = launch_counters()
    dev = eng.device
    pg, q = eng.pg, eng.pg.q
    metas = {"p2p": eng.meta,
             "packed": gp.DistMeta.build(pg, params, wire="packed")}
    graphs = {"p2p": eng.graph,
              "packed": attach_p2p(pg.device_arrays(dev), pg, dev)}
    pol = CommPolicy.parse("auto:budget:1e9:w4", 1)
    opt = sgd(0.1)
    key = prng.key(seed + 11)

    def plan_of(rate, width, fp32_pair):
        wm = _pair_map(q, width, 32.0)
        if fp32_pair:
            wm[0, 1] = 32.0
        return RatePlan(_pair_map(q, rate, 1.0), _pair_map(q, 0.0, 0.0), wm)

    def run_step(name):
        wire, rate, width, fp32_pair = STOCH_RUNS[name]
        meta = metas[wire]
        # no rounding named: the card's default, stochastic
        step = make_auto_train_step(cfg, pol, opt, meta)
        cache = init_wire_residuals(meta, cfg, dev) if wire == "p2p" else ()
        t0 = time.perf_counter()
        _, _, m, _ = step(params, opt.init(params), graphs[wire], key,
                          plan_of(rate, width, fp32_pair), cache)
        loss = float(m["loss"])
        return loss, time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    losses, step_s = {}, {}
    for name in STOCH_RUNS:
        losses[name], step_s[name] = run_step(name)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    with plain_codecs():
        plain = {name: run_step(name)[0] for name in STOCH_RUNS}
    halo_equal = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    x = torch.randn((q, pg.part_size, 256), generator=gen, device=dev)
    for name, (wire, rate, width, fp32_pair) in STOCH_RUNS.items():
        plan = plan_of(rate, width, fp32_pair)
        meta, toks = metas[wire], []
        for ctx in (contextlib.nullcontext, plain_codecs):
            agg = gp._make_aggregate_emulated(
                graphs[wire], meta, pol, torch.ones(()), key,
                packed_k=dict(gp._packed_pair_k_for(meta, plan.rates)),
                rate_map=plan.rates, width_map=plan.widths,
                store_w=gp._packed_store_w(meta, plan.widths),
                rounding="stochastic")
            with ctx(), torch.no_grad():
                toks.append(agg.start(1, x)[0])
        torch.cuda.synchronize()
        halo_equal[name] = torch.equal(toks[0], toks[1])
    # hop reuse: a fresh stale step, then one with every pair skipped
    meta = metas["p2p"]
    stale = make_auto_train_step(cfg, CommPolicy.parse("auto:stale:1e9", 2),
                                 opt, meta)
    ones = _pair_map(q, 1.0, 1.0)
    p1, s1, m0, cache1 = stale(params, opt.init(params), graphs["p2p"],
                               prng.key(seed), RatePlan(
                                   ones, _pair_map(q, 0.0, 0.0)),
                               init_halo_cache(meta, cfg, dev))
    _, _, m1, cache2 = stale(p1, s1, graphs["p2p"], prng.key(seed + 1),
                             RatePlan(ones, _pair_map(q, 1.0, 0.0)), cache1)
    torch.cuda.synchronize()
    stale_rec = {"fresh_transport_bits": float(m0["transport_bits"]),
                 "skipped_transport_bits": float(m1["transport_bits"]),
                 "skipped_halo_bits": float(m1["halo_bits"]),
                 "halo_equals_cache": all(torch.equal(a, b) for a, b in
                                          zip(cache2, cache1)),
                 "loss": float(m1["loss"])}
    del cache1, cache2
    conserve = [_conservation(graphs["packed"], metas["packed"], "packed",
                              4, x, seed),
                _conservation(graphs["p2p"], metas["p2p"], "p2p", 8, x,
                              seed)]
    summary = {"phase": "auto", "launches": launches, "loss": losses,
               "plain_loss": plain, "step_s": step_s,
               "halo_equals_plain": halo_equal, "stale": stale_rec,
               "conservation": conserve}
    emit(summary)
    for name in STOCH_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the "
              f"stochastic-rounding path")
    for name in STOCH_RUNS:
        check(np.isfinite(losses[name]), f"{name}: non-finite loss")
        check(abs(losses[name] - plain[name]) <= GRAD_TOL,
              f"{name}: loss {losses[name]} vs plain codecs {plain[name]}")
        check(halo_equal[name], f"{name}: the halo differs from the plain "
              f"codecs' halo")
    check(stale_rec["fresh_transport_bits"] > 0 and
          stale_rec["skipped_transport_bits"] == 0.0 and
          stale_rec["skipped_halo_bits"] == 0.0,
          f"a fully skipped stale step charged bits: {stale_rec}")
    check(stale_rec["halo_equals_cache"],
          "a fully skipped stale step's halo differs from the cache")
    for rec in conserve:
        check(rec["ok"], f"bytes not conserved: {rec}")
    return {name: launches[name] for name in STOCH_KERNELS}


# ---------------------------------------------------------------------------
# phase 6c: resilience — the out-of-core boot, faults, checkpoint/resume
# ---------------------------------------------------------------------------

RES_EPOCHS = 6
#: R2's schedule: drops, latency spikes, worker 1 crashing at epoch 3
RES_SCHED = dict(q=4, seed=0, drop_rate=0.25, spike_rate=0.05,
                 crash_at=((3, 1),))
RES_MAX_STALE = 2
RES_TOL = 1e-4
RES_KERNELS = ("ell_spmm", "varco_pack", "varco_unpack")
QUANT_KERNELS = ("varco_pack_quant", "varco_unpack_quant")


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _fault_identities(cfg, params, shards, dev, seed: int = 0) -> dict:
    """On the Q = 4 shard set: a fresh fault step, then the same step with
    pair (2 ← 0) CACHED from the fresh step's ``fcache_out`` (loss,
    charged bits, served hop rows), and a forward with every off-diagonal
    pair DEAD against the No-Comm forward."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.faults import make_fault_train_step
    from repro_torch.dist.ratectl import init_halo_cache, uniform_plan
    from repro_torch.nn.gnn import gnn_forward
    from repro_torch.train.optim import adamw

    meta = gp.DistMeta.build(shards, params, wire="p2p")
    graph = shards.device_arrays(dev)
    q = meta.q
    pol = CommPolicy.parse("varco:linear:5", RES_EPOCHS,
                           compressor="blockmask")
    opt = adamw(5e-3)
    step = make_fault_train_step(cfg, pol, opt, meta)
    plan = uniform_plan(q, float(pol.rate(0)))
    zeros = np.zeros((q, q), np.float32)
    key = prng.key(seed)
    _, _, m0, _, fresh = step(params, opt.init(params), graph, key, plan,
                              zeros, zeros, (),
                              init_halo_cache(meta, cfg, dev))
    fskip = zeros.copy()
    fskip[2, 0] = 1.0
    _, _, m1, _, served = step(params, opt.init(params), graph, key, plan,
                               fskip, zeros, (), fresh)
    hop = (2 - 0) % q - 1               # sender 0's ring hop to receiver 2
    rows_equal = all(torch.equal(a[0, hop], b[0, hop])
                     for a, b in zip(served, fresh))
    dead = 1.0 - np.eye(q, dtype=np.float32)
    rm = np.ones((q, q), np.float32)
    full = CommPolicy.parse("full", 1)
    with torch.no_grad():
        agg = gp._make_aggregate_emulated(
            graph, meta, full, torch.ones(()), key,
            packed_k=dict(gp._packed_pair_k_for(meta, rm)), rate_map=rm,
            fskip=zeros, fcache=init_halo_cache(meta, cfg, dev),
            dead=dead)
        dark, dark_bits = gnn_forward(params, cfg, graph["features"], agg)
        agg = gp._make_aggregate_emulated(
            graph, meta, CommPolicy.parse("none", 1), torch.ones(()), key)
        iso, _ = gnn_forward(params, cfg, graph["features"], agg)
    return {"fresh_loss": float(m0["loss"]),
            "cached_loss": float(m1["loss"]),
            "fresh_pair_bits": float(m0["pair_transport"][2, 0]),
            "cached_pair_bits": float(m1["pair_transport"][2, 0]),
            "cached_rows_equal_cache": rows_equal,
            "all_dead_vs_none_max_abs": float((dark - iso).abs().max()),
            "all_dead_transport_bits": float(dark_bits[1])}


def resilience_phase(g, cfg, params, eng, varco_in_memory, workdir,
                     seed: int = 0):
    """R1: the graph written to a chunked store, cut by the streaming
    partitioner (the exact path: it must give the setup's owner vector),
    sharded, loaded (``device_arrays`` bitwise equal to the in-memory
    ones) and trained from the shard directory (``varco:linear:5`` on the
    p2p wire, losses within 1e-4 of the train phase's in-memory run).
    R2: 6 epochs each of ``varco:linear:5`` and ``auto:budget:<half>:w8``
    under a schedule that drops, spikes and crashes worker 1 at epoch 3
    (and ``varco`` once more at a staleness cap of 1, where pairs go
    DEAD), with the cached-pair and all-dead identities.  R3: the faulted
    ``varco`` run checkpointed after the crash and resumed, against the
    uninterrupted one, and a save→restore round trip of card tensors.
    Launch counts are set to 0 before each part and read after.  The
    store, the shards (which the dist phase boots from) and the
    checkpoints go under ``workdir``.  Returns R2's runs (the dist
    phase's references for its faulted runs)."""
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import faults as fl
    from repro_torch.dist.halo import attach_p2p
    from repro_torch.dist.ratectl import exchange_widths, init_halo_cache
    from repro_torch.graph import stream as st
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import adamw, tree_leaves
    from repro_torch.train.trainer import train_gnn

    counters = launch_counters()
    dev = eng.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    common = dict(hidden=cfg.hidden, layers=cfg.layers, wire="p2p",
                  seed=seed, eval_every=1, device=dev, params=params)
    full_bits = 2.0 * 32.0 * eng.pg.halo_demand * \
        sum(exchange_widths(cfg)) * RES_EPOCHS
    specs = {"varco": "varco:linear:5",
             "auto_w8": f"auto:budget:{0.5 * full_bits:g}:w8"}

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def read():
        sync()
        return {name: fn.launches for name, fn in counters.items()}

    def policy(spec, epochs):
        return CommPolicy.parse(spec, epochs, compressor="blockmask")

    tmp = Path(workdir)
    # ---- R1: the out-of-core boot ----------------------------------
    t = time.perf_counter()
    store = st.write_graph_store(g, tmp / "store")
    t_store = time.perf_counter() - t
    t = time.perf_counter()
    owner = st.stream_partition(store, eng.pg.q, "metis-like",
                                seed=seed)
    t_part = time.perf_counter() - t
    check(np.array_equal(owner, eng.pg.owner),
          "stream_partition's owner vector differs from the setup "
          "phase's partition_graph")
    t = time.perf_counter()
    st.write_shards(store, owner, tmp / "shards")
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    shards = st.load_shards(tmp / "shards")
    t_load = time.perf_counter() - t
    t = time.perf_counter()
    got = shards.device_arrays(dev)
    sync()
    t_h2d = time.perf_counter() - t
    want = attach_p2p(eng.pg.device_arrays(dev), eng.pg, dev)
    bad = [k for k in want if k not in got or got[k].dtype !=
           want[k].dtype or not torch.equal(got[k], want[k])]
    check(list(got) == list(want) and not bad,
          f"shard arrays differ from the in-memory ones at {bad}")
    del got, want
    zero()
    boot = train_gnn(str(tmp / "shards"),
                     policy=policy(specs["varco"], TRAIN_EPOCHS),
                     epochs=TRAIN_EPOCHS, **common)
    r1_launches = read()
    r1_err = float(np.abs(np.asarray(boot.history.loss) -
                          np.asarray(varco_in_memory.loss)).max())
    r1 = {"part": "R1", "store_write_s": t_store,
          "stream_partition_s": t_part, "shard_write_s": t_write,
          "shard_load_s": t_load, "device_arrays_s": t_h2d,
          "store_bytes": _dir_bytes(tmp / "store"),
          "shard_bytes": _dir_bytes(tmp / "shards"),
          "owner_equal": True, "arrays_bitwise": True,
          "loss": boot.history.loss,
          "loss_vs_in_memory_max_abs": r1_err,
          "step_ms": [x * 1e3 for x in boot.history.step_s],
          "launches": r1_launches}
    emit({"phase": "resilience", **r1})
    check(r1_err <= RES_TOL, f"shard-backed losses differ from the "
          f"in-memory run by {r1_err}")
    for name in RES_KERNELS:
        check(r1_launches[name] > 0, f"R1: {name} never launched")

    # ---- R2: faults ------------------------------------------------
    # at max_stale 2 this schedule leaves no pair DEAD within the 6
    # epochs; the third run, at max_stale 1, trains through DEAD pairs
    r2_runs = {name: (spec, RES_MAX_STALE)
               for name, spec in specs.items()}
    r2_runs["varco_stale1"] = (specs["varco"], 1)
    runs, r2_launches = {}, {}
    for name, (spec, max_stale) in r2_runs.items():
        zero()
        runs[name] = train_gnn(
            shards, policy=policy(spec, RES_EPOCHS), epochs=RES_EPOCHS,
            faults=fl.FaultSchedule(**RES_SCHED),
            fault_max_stale=max_stale, **common)
        r2_launches[name] = read()
    t = time.perf_counter()
    sched, dstate = fl.FaultSchedule(**RES_SCHED), fl.init_degrade(4)
    for ep in range(RES_EPOCHS):
        crash = sched.crash_at_step(ep)
        if crash is not None:
            sched = sched.shrink(crash)
            dstate = fl.migrate_degrade_state(dstate, crash)
        serve, dstate = fl.degrade_plan(
            dstate, sched.effective_drops(ep), ep,
            max_stale=RES_MAX_STALE)
        fl.serve_masks(serve)
    t_ladder = time.perf_counter() - t
    t = time.perf_counter()
    shrunk = fl.shrink_shards(shards, 1)
    t_shrink = time.perf_counter() - t
    del shrunk
    ident = _fault_identities(cfg, params, shards, dev, seed)
    r2 = {"part": "R2", "ladder_s": t_ladder, "shrink_shards_s": t_shrink,
          "identities": ident, "launches": r2_launches}
    for name, res in runs.items():
        h = res.history
        r2[name] = {"loss": h.loss, "cached": h.cached_pairs,
                    "dead": h.dead_pairs, "width": h.width,
                    "step_ms": [x * 1e3 for x in h.step_s],
                    "pairs": [len(p) for p in h.pair_transport_gf],
                    "transport_gfloats": h.transport_gfloats,
                    "q": res.meta.q}
    emit({"phase": "resilience", **r2})
    for name, res in runs.items():
        h = res.history
        check(bool(np.isfinite(h.loss).all()), f"R2 {name}: non-finite "
              f"loss {h.loss}")
        check(res.meta.q == 3 and all(
            len(p) == (16 if ep < 3 else 9)
            for ep, p in zip(h.epoch, h.pair_transport_gf)),
            f"R2 {name}: Q is not 3 from epoch 3 on")
        for k in RES_KERNELS:
            check(r2_launches[name][k] > 0, f"R2 {name}: {k} never "
                  f"launched")
    check(sum(runs["varco_stale1"].history.dead_pairs) > 0,
          "R2: no pair reached DEAD at max_stale 1")
    for k in QUANT_KERNELS:
        check(r2_launches["auto_w8"][k] > 0,
              f"R2 auto_w8: {k} never launched")
    check(abs(ident["cached_loss"] - ident["fresh_loss"]) <= RES_TOL,
          f"R2: a CACHED pair changed the loss: {ident}")
    check(ident["fresh_pair_bits"] > 0 and
          ident["cached_pair_bits"] == 0.0,
          f"R2: the CACHED pair was charged: {ident}")
    check(ident["cached_rows_equal_cache"],
          "R2: the CACHED pair's hop rows differ from the cache")
    check(ident["all_dead_vs_none_max_abs"] <= RES_TOL and
          ident["all_dead_transport_bits"] == 0.0,
          f"R2: an all-DEAD forward differs from No-Comm: {ident}")

    # ---- R3: checkpoint and resume ---------------------------------
    ck = tmp / "ck"
    kw = dict(policy=policy(specs["varco"], RES_EPOCHS),
              epochs=RES_EPOCHS, faults=fl.FaultSchedule(**RES_SCHED),
              fault_max_stale=RES_MAX_STALE, checkpoint_dir=str(ck),
              **common)
    zero()
    part = train_gnn(shards, stop_after=4, **kw)
    ck_extra = ckpt.peek(ckpt.latest_checkpoint(str(ck)))
    resumed = train_gnn(str(tmp / "shards"), resume=True, **kw)
    r3_launches = read()
    whole = runs["varco"].history.loss
    r3_err = float(np.abs(np.asarray(resumed.history.loss) -
                          np.asarray(whole[4:])).max())
    meta = resumed.meta
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    fcache = tuple(torch.randn(c.shape, generator=gen, device=dev)
                   for c in init_halo_cache(meta, cfg, dev))
    opt = adamw(5e-3)
    tree = {"params": resumed.params,
            "opt": opt.init(resumed.params), "fcache": fcache}
    path = str(tmp / "roundtrip.ckpt")
    sync()
    t = time.perf_counter()
    ckpt.save(path, tree, extra={"q": meta.q})
    t_save = time.perf_counter() - t
    t = time.perf_counter()
    back, _ = ckpt.restore(path, tree)
    sync()
    t_restore = time.perf_counter() - t
    bitwise = all(a.device == b.device and a.dtype == b.dtype and
                  torch.equal(a, b) for a, b in
                  zip(tree_leaves(back), tree_leaves(tree)))
    r3 = {"part": "R3", "stopped_at": len(part.history.loss),
          "checkpoint_step": ck_extra["step"],
          "checkpoint_alive": ck_extra["alive"],
          "resumed_loss": resumed.history.loss,
          "uninterrupted_loss": whole[4:],
          "resume_vs_uninterrupted_max_abs": r3_err,
          "train_state_bytes": os.path.getsize(
              ckpt.latest_checkpoint(str(ck))),
          "roundtrip_bytes": os.path.getsize(path),
          "save_ms": t_save * 1e3, "restore_ms": t_restore * 1e3,
          "roundtrip_bitwise": bitwise, "launches": r3_launches}
    emit({"phase": "resilience", **r3})
    check(ck_extra["step"] == 4 and ck_extra["alive"] == [0, 2, 3],
          f"R3: the checkpoint is not the shrunk run's after epoch 4: "
          f"{ck_extra}")
    check(r3_err <= RES_TOL, f"R3: resumed losses differ from the "
          f"uninterrupted run by {r3_err}")
    check(bitwise, "R3: save -> restore of card tensors is not bitwise")
    for k in RES_KERNELS:
        check(r3_launches[k] > 0, f"R3: {k} never launched")
    summary = {"phase": "resilience", "wall_s": time.perf_counter() -
               t_phase, "peak_mem_gb": torch.cuda.max_memory_allocated() /
               1e9 if on_card else None,
               "launches": {"R1": {k: r1_launches[k] for k in RES_KERNELS},
                            "R2": {n: {k: v[k] for k in RES_KERNELS +
                                       QUANT_KERNELS}
                                   for n, v in r2_launches.items()},
                            "R3": {k: r3_launches[k] for k in RES_KERNELS}}}
    emit(summary)
    return runs


# ---------------------------------------------------------------------------
# phase 6d: the worker backend, one process per worker
# ---------------------------------------------------------------------------

DIST_Q = 4
DIST_EPOCHS = 3
#: name -> (policy spec, compressor, wire); ``{half}`` is half the
#: full-rate transport of a ``DIST_EPOCHS`` run over the shard directory's
#: partition (the train phase's ``half``, over this phase's epochs)
DIST_RUNS = {"p2p_full": ("full", "blockmask", "p2p"),
             "p2p_varco": ("varco:linear:5", "blockmask", "p2p"),
             "dense_varco": ("varco:linear:5", "randmask", "dense"),
             "packed_fixed4": ("fixed:4", "blockmask", "packed"),
             "p2p_auto_w8": ("auto:budget:{half:g}:w8", "blockmask", "p2p"),
             "p2p_auto_error_w8": ("auto:error:{half:g}:w8", "blockmask",
                                   "p2p"),
             "packed_auto_w4": ("auto:budget:{half:g}:w4", "blockmask",
                                "packed")}
#: the kernels each run must launch (summed over the workers); an auto
#: run whose plans quantise also the sub-byte codecs (its rounding, the
#: card's default, is stochastic)
DIST_KERNELS = {"p2p_full": ("ell_spmm",),
                "p2p_varco": ("ell_spmm", "varco_pack", "varco_unpack"),
                "dense_varco": ("random_mask",),
                "packed_fixed4": ("varco_pack", "varco_unpack"),
                "p2p_auto_w8": ("ell_spmm", "varco_pack", "varco_unpack"),
                "p2p_auto_error_w8": ("ell_spmm", "varco_pack",
                                      "varco_unpack"),
                "packed_auto_w4": ("varco_pack", "varco_unpack"),
                "p2p_mixed_step": ("ell_spmm", "varco_pack", "varco_unpack",
                                   "random_uniform"),
                # the faulted runs, the fault step, the checkpointed run
                # and its resume over the three survivors
                "faults": ("ell_spmm", "varco_pack", "varco_unpack")}
DIST_LAUNCHES = ("ell_spmm", "varco_pack", "varco_unpack", "random_mask",
                 "varco_pack_quant", "varco_pack_quant_stochastic",
                 "varco_unpack_quant", "random_uniform")
DIST_TOL = 1e-4
DIST_ACC_TOL = 1e-3
#: seconds any wait on the worker group may take before the run fails
DIST_TIMEOUT = 300.0
#: the faulted runs on the group, from the resilience phase's shards under
#: its schedule and epochs: name -> staleness cap; R2's emulated runs of
#: the same names are their references
DIST_FAULT_RUNS = {"varco": RES_MAX_STALE, "varco_stale1": 1}
#: the group's checkpoint: after epoch 4, past the crash
DIST_STOP = 4


def _dist_half(shard_dir, cfg) -> float:
    from repro_torch.dist.ratectl import exchange_widths
    from repro_torch.graph.stream import shard_meta

    return 0.5 * 2.0 * 32.0 * shard_meta(shard_dir)["halo_demand"] * \
        sum(exchange_widths(cfg)) * DIST_EPOCHS


def _mixed_plan(q: int):
    """The mixed-width plan: every pair at rate 2 and 8 bits but pair
    (3 ← 2) at rate 1, pair (2 ← 3) at 4 bits and pair (0 ← 1) at fp32 —
    an fp32 pair beside quantised ones, so the hops take the
    straight-through value path, whose stochastic rounding draws its
    uniforms with ``random_uniform``."""
    from repro_torch.dist.ratectl import RatePlan

    rates, widths = _pair_map(q, 2.0, 1.0), _pair_map(q, 8.0, 32.0)
    rates[3, 2], widths[2, 3], widths[0, 1] = 1.0, 4.0, 32.0
    return RatePlan(rates, np.zeros((q, q), np.float32), widths)


def _signature(args) -> tuple:
    """A kernel call's signature: each tensor's shape, strides, dtype and
    16-byte alignment, and every other argument as it is."""
    return tuple((tuple(a.shape), tuple(a.stride()), str(a.dtype),
                  a.data_ptr() % 16) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _plain_err(kernel: str, out, ref) -> float:
    """Max abs error of a kernel's output against its plain version's
    (``inf`` on a shape or dtype mismatch; every kernel but ELL must be
    bitwise — the mask and its kept counts, pack/unpack, the codecs and
    the uniforms, which draw the plain version's Threefry stream: 0.0 or
    ``inf``)."""
    if kernel == "random_mask":
        (out, counts), (ref, ref_counts) = out, ref
        same = _bitwise(out, ref) and (counts is None) == (ref_counts is None)
        if counts is not None:
            same &= torch.equal(counts, ref_counts)
        return 0.0 if same else float("inf")
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    if any(a.shape != b.shape or a.dtype != b.dtype
           for a, b in zip(outs, refs)):
        return float("inf")
    if kernel == "ell_spmm":
        return float((out - ref).abs().max()) if out.numel() else 0.0
    return 0.0 if all(torch.equal(a, b) for a, b in zip(outs, refs)) \
        else float("inf")


@contextlib.contextmanager
def _kernel_calls(seen: dict, compare: bool):
    """Within the block, every call of a ``DIST_LAUNCHES`` kernel through
    ``repro_torch.kernels.ops`` (the route of every call on the worker
    backend's path) counts in ``seen[kernel][sig] = [calls, err]`` under
    its :func:`_signature`; with ``compare`` each call also runs the plain
    version on the same arguments, and ``err`` is the largest
    :func:`_plain_err` (``None`` without).  The kernel's own call is the
    one the path makes: its launch count moves as without the block."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmm import ell_spmm_plain
    from repro_torch.kernels.randmask import (random_mask_plain,
                                              random_uniform_plain)
    from repro_torch.kernels import varco_pack as vp

    routes = {"ell_spmm": ("ell_spmm", ell_spmm_plain),
              "varco_pack": ("varco_pack", vp.varco_pack_plain),
              "varco_unpack": ("varco_unpack", vp.varco_unpack_plain),
              "random_mask": ("random_mask_kernel", random_mask_plain),
              "varco_pack_quant": ("varco_pack_quant",
                                   vp.varco_pack_quant_plain),
              "varco_pack_quant_stochastic": (
                  "varco_pack_quant_stochastic",
                  vp.varco_pack_quant_stochastic_plain),
              "varco_unpack_quant": ("varco_unpack_quant",
                                     vp.varco_unpack_quant_plain),
              "random_uniform": ("random_uniform", random_uniform_plain)}
    saved = {attr: getattr(ops, attr) for attr, _ in routes.values()}

    def wrap(name, kernel, plain):
        def call(*args):
            out = kernel(*args)
            rec = seen[name].setdefault(_signature(args), [0, None])
            rec[0] += 1
            if compare:
                with torch.no_grad():
                    err = _plain_err(name, out, plain(*args))
                rec[1] = max(rec[1] or 0.0, err)
            return out
        return call

    for name, (attr, plain) in routes.items():
        seen.setdefault(name, {})
        setattr(ops, attr, wrap(name, saved[attr], plain))
    try:
        yield seen
    finally:
        for attr, fn in saved.items():
            setattr(ops, attr, fn)


def _dist_halos(mesh, shard_dir, params, seed: int) -> dict:
    """At rate 2 over a 256-wide exchange: this worker's p2p compact hop
    buffer and packed halo against its slice of the emulated backend's
    (every partition stacked on the same card), bitwise; and under the
    closed loop's plans, stochastically rounded — p2p every pair at 8 bits
    (the sub-byte hops), packed at 4 bits (the sub-byte all-gather) and
    :func:`_mixed_plan` (the value path) — the halo and, on the p2p wire,
    the error-feedback residual slab the exchange leaves, bitwise."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.ratectl import RatePlan
    from repro_torch.graph.stream import load_shards

    dev, r, q = mesh.device, mesh.rank, mesh.q
    mine = load_shards(shard_dir, parts=[r])
    graph_me = mine.device_arrays(dev)
    graph_all = load_shards(shard_dir).device_arrays(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    x = torch.randn(graph_all["features"].shape[:2] + (256,), generator=gen,
                    device=dev)
    key = prng.fold_in(prng.key(seed + 3), 256)
    rate2 = _pair_map(q, 2.0, 1.0)
    zeros = np.zeros((q, q), np.float32)
    cases = {"p2p": ("p2p", None), "packed": ("packed", None),
             "p2p_w8": ("p2p", RatePlan(rate2, zeros,
                                        _pair_map(q, 8.0, 32.0))),
             "packed_w4": ("packed", RatePlan(rate2, zeros,
                                              _pair_map(q, 4.0, 32.0))),
             "p2p_mixed": ("p2p", _mixed_plan(q))}
    out = {}
    for name, (wire, plan) in cases.items():
        pol = CommPolicy.parse("fixed:2" if plan is None else
                               "auto:budget:1e9:w8", 1,
                               compressor="blockmask")
        meta = gp.DistMeta.build(mine, params, wire=wire)
        kw = {} if plan is None else dict(plan=plan, rounding="stochastic")
        r_all, r_me = [], []
        want = gp.first_halo(graph_all, meta, pol, key, x, resid_out=r_all,
                             **kw)
        got = gp.first_halo(graph_me, meta, pol, key, x[r:r + 1], mesh,
                            resid_out=r_me, **kw)
        same = torch.equal(got, want[r] if wire == "p2p" else want)
        if plan is not None and wire == "p2p":
            same &= len(r_me) == len(r_all) == 1 and \
                torch.equal(r_me[0][0], r_all[0][r])
        out[name] = bool(same)
    return out


def _held_run(fn, counters: dict, on_card: bool, dev) -> tuple:
    """``fn()`` twice: once with every call of a ``DIST_LAUNCHES`` kernel
    held against its plain version at this worker's shapes, then —
    launch counts set to 0 and read after — measured, the plain versions'
    time and memory out of it.  Returns the measured result and its
    record: launches, peak GB, the held calls per signature and the
    signatures the measured run launched at that no check held."""
    checked = {}
    with _kernel_calls(checked, compare=True):
        fn()
    for c in counters.values():
        c.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    measured = {}
    with _kernel_calls(measured, compare=False):
        res = fn()
    if on_card:
        torch.cuda.synchronize(dev)
    return res, {
        "launches": {k: counters[k].launches for k in DIST_LAUNCHES},
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card
        else None,
        "checked": {k: [{"args": [list(a[0]) if isinstance(a, tuple) else a
                                  for a in sig],
                         "calls": n, "max_abs_err": err}
                        for sig, (n, err) in v.items()]
                    for k, v in checked.items()},
        "unchecked": {k: len(set(v) - set(checked[k]))
                      for k, v in measured.items()}}


def _mixed_step(mesh, shard_dir, cfg, params, half: float) -> dict:
    """One ``make_auto_train_step`` step under :func:`_mixed_plan`, rounded
    stochastically, from zero error-feedback residuals: on this worker of
    ``mesh`` over its own shard, or emulated (``mesh=None``) over every
    shard stacked on the card.  Returns the loss, the step's host ms
    (ending in the loss read) and, on a worker, the bytes it sent and
    staged."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.ratectl import (init_wire_residuals,
                                          make_auto_train_step)
    from repro_torch.graph.stream import load_shards
    from repro_torch.nn.gnn import params_to
    from repro_torch.train.optim import sgd, tree_leaves

    dev = tree_leaves(params)[0].device if mesh is None else mesh.device
    pg = load_shards(shard_dir, parts=None if mesh is None
                     else [mesh.rank])
    graph = pg.device_arrays(dev)
    params = params_to(params, dev)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    pol = CommPolicy.parse(f"auto:budget:{half:g}:w8", DIST_EPOCHS,
                           compressor="blockmask")
    opt = sgd(0.1)
    step = make_auto_train_step(cfg, pol, opt, meta, mesh=mesh,
                                rounding="stochastic")
    cache = init_wire_residuals(meta, cfg, dev, mesh)
    sent = (mesh.sent_bytes, mesh.staged_bytes) if mesh else (0, 0)
    t = time.perf_counter()
    _, _, m, _ = step(params, opt.init(params), graph, prng.key(0),
                      _mixed_plan(meta.q), cache)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t) * 1e3
    return {"loss": loss, "step_ms": ms,
            "sent_bytes": mesh.sent_bytes - sent[0] if mesh else 0,
            "staged_bytes": mesh.staged_bytes - sent[1] if mesh else 0}


def _fault_kwargs(cfg, params, seed: int, dev, max_stale: int) -> dict:
    """``train_gnn``'s arguments of R2's faulted ``varco`` run (its
    schedule, epochs, staleness cap ``max_stale``)."""
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist.faults import FaultSchedule

    return dict(policy=CommPolicy.parse("varco:linear:5", RES_EPOCHS,
                                        compressor="blockmask"),
                epochs=RES_EPOCHS, faults=FaultSchedule(**RES_SCHED),
                fault_max_stale=max_stale, hidden=cfg.hidden,
                layers=cfg.layers, wire="p2p", seed=seed, eval_every=1,
                device=dev, params=params)


def _fault_masks(q: int) -> tuple:
    """The fault step's ladder: pairs (2 <- 0) and (1 <- 3) CACHED, (0 <-
    1) and (3 <- 2) DEAD."""
    fskip, dead = np.zeros((q, q), np.float32), np.zeros((q, q), np.float32)
    fskip[2, 0] = fskip[1, 3] = 1.0
    dead[0, 1] = dead[3, 2] = 1.0
    return fskip, dead


def _fault_step(mesh, shard_dir, cfg, params, seed: int) -> dict:
    """One ``varco:linear:5`` fault step at rate 2 under
    :func:`_fault_masks`, from a seeded random sender-major fault cache:
    on this worker of ``mesh`` (its receiver-major row of the cache, its
    row of the shard set) or emulated (``mesh=None``, every shard stacked
    on the card).  Returns the loss, the step's host ms (ending in the
    loss read), the bytes sent, the fault cache it started from and the
    one it served."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import gnn_parallel as gp
    from repro_torch.dist.faults import (_cache_send_to_recv,
                                         make_fault_train_step)
    from repro_torch.dist.ratectl import exchange_widths, uniform_plan
    from repro_torch.graph.stream import load_shards
    from repro_torch.nn.gnn import params_to
    from repro_torch.train.optim import sgd, tree_leaves

    dev = tree_leaves(params)[0].device if mesh is None else mesh.device
    pg = load_shards(shard_dir)
    params = params_to(params, dev)
    graph = pg.device_arrays(dev) if mesh is None else \
        gp.shard_graph(pg.device_arrays("cpu"), mesh)
    meta = gp.DistMeta.build(pg, params, wire="p2p")
    q = meta.q
    opt = sgd(0.1)
    step = make_fault_train_step(cfg, CommPolicy.parse(
        "varco:linear:5", RES_EPOCHS, compressor="blockmask"), opt, meta,
        mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    fcache = tuple(torch.randn((q, q - 1, meta.p2p_hop_width, w),
                               generator=gen, device=dev)
                   for w in exchange_widths(cfg))
    if mesh is not None:
        fcache = tuple(_cache_send_to_recv(c, q)[mesh.rank:mesh.rank + 1]
                       .clone() for c in fcache)
    fskip, dead = _fault_masks(q)
    sent = mesh.sent_bytes if mesh else 0
    t = time.perf_counter()
    _, _, m, _, served = step(params, opt.init(params), graph,
                              prng.key(seed), uniform_plan(q, 2.0), fskip,
                              dead, (), fcache)
    loss = float(m["loss"])
    return {"loss": loss, "step_ms": (time.perf_counter() - t) * 1e3,
            "sent_bytes": mesh.sent_bytes - sent if mesh else 0,
            "fcache": fcache, "served": served}


def _fault_reference(shard_dir, cfg, params, seed: int, out: Path) -> dict:
    """The emulated :func:`_fault_step` on the card, its served cache
    written under ``out`` as each worker's receiver-major rows
    (``rank<r>.pt``), for the workers to hold theirs against."""
    from repro_torch.dist.faults import _cache_send_to_recv

    ref = _fault_step(None, shard_dir, cfg, params, seed)
    out.mkdir(parents=True, exist_ok=True)
    q = ref["served"][0].shape[0]
    for r in range(q):
        torch.save([_cache_send_to_recv(c, q)[r:r + 1].cpu()
                    for c in ref["served"]], out / f"rank{r}.pt")
    return {"loss": ref["loss"], "step_ms": ref["step_ms"]}


@contextlib.contextmanager
def _timed_saves(rec: list):
    """Within the block, each ``save_train_state`` call (rank 0 of the
    mesh writes) appends its ms and the file's bytes to ``rec``."""
    from repro_torch.train import checkpoint as ckpt

    save = ckpt.save_train_state

    def timed(*args, **kw):
        t = time.perf_counter()
        path = save(*args, **kw)
        rec.append({"ms": (time.perf_counter() - t) * 1e3,
                    "bytes": os.path.getsize(path)})
        return path

    ckpt.save_train_state = timed
    try:
        yield rec
    finally:
        ckpt.save_train_state = save


def _dist_fault_worker(mesh, shard_dir, cfg, params, seed, counters,
                       on_card, fault_ref: Path, ck: str) -> dict:
    """This worker's faulted runs: each of ``DIST_FAULT_RUNS`` through
    ``train_gnn(use_shard_map=True, faults=...)`` under :func:`_held_run`
    (``None`` for the history of the worker that crashes), one
    :func:`_fault_step` under it, held against the emulated step's served
    rows in ``fault_ref``, and the ``varco`` run stopped after
    ``DIST_STOP`` epochs into ``ck`` with every kernel call held and each
    checkpoint write timed."""
    from repro_torch.train.trainer import train_gnn

    dev = mesh.device
    runs = {}
    for name, max_stale in DIST_FAULT_RUNS.items():
        kw = _fault_kwargs(cfg, params, seed, dev, max_stale)
        res, rec = _held_run(lambda: train_gnn(
            shard_dir, use_shard_map=True, **kw), counters, on_card, dev)
        runs[name] = {"history": None if res is None else
                      dataclasses.asdict(res.history),
                      "q": None if res is None else res.meta.q, **rec}
    step, rec = _held_run(lambda: _fault_step(mesh, shard_dir, cfg, params,
                                              seed), counters, on_card, dev)
    ref = torch.load(fault_ref / f"rank{mesh.rank}.pt", map_location=dev)
    fskip, _ = _fault_masks(mesh.q)
    src = (mesh.rank - np.arange(1, mesh.q)) % mesh.q
    cached = [d for d in range(mesh.q - 1) if fskip[mesh.rank, src[d]]]
    served = step.pop("served")
    start = step.pop("fcache")
    step.update(rec, cached_hops=cached,
                first_exchange_bitwise=torch.equal(served[0], ref[0]),
                served_max_abs=[float((a - b).abs().max())
                                for a, b in zip(served, ref)],
                cached_rows_bitwise=all(
                    torch.equal(a[0, d], b[0, d])
                    for a, b in zip(served, start) for d in cached))
    del served, start, ref
    for c in counters.values():
        c.launches = 0
    saves, held = [], {}
    with _timed_saves(saves), _kernel_calls(held, compare=True):
        part = train_gnn(shard_dir, use_shard_map=True, checkpoint_dir=ck,
                         stop_after=DIST_STOP,
                         **_fault_kwargs(cfg, params, seed, dev,
                                         RES_MAX_STALE))
    if on_card:
        torch.cuda.synchronize(dev)
    return {"runs": runs, "step": step,
            "ckpt": {"saves": saves, "stopped": None if part is None
                     else len(part.history.loss),
                     "launches": {k: counters[k].launches
                                  for k in DIST_LAUNCHES},
                     "checked": {k: sum(n for n, _ in v.values())
                                 for k, v in held.items()},
                     "max_abs_err": {k: max((e for _, e in v.values()),
                                            default=None)
                                     for k, v in held.items()}}}


def _dist_resume_worker(mesh, shard_dir, cfg, params, seed, ck) -> dict:
    """A worker of the group that resumes ``ck`` (the checkpoint of the
    run that shrank, so one worker fewer): the resumed ``varco`` run under
    :func:`_held_run`, every worker's record gathered."""
    import torch.distributed as dist

    from repro_torch.train.trainer import train_gnn

    on_card = mesh.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = _fault_kwargs(cfg, params, seed, mesh.device, RES_MAX_STALE)
    res, rec = _held_run(lambda: train_gnn(
        shard_dir, use_shard_map=True, checkpoint_dir=ck, resume=True, **kw),
        launch_counters(), on_card, mesh.device)
    every = [None] * mesh.q
    dist.all_gather_object(every, rec)
    return {"workers": every, "history": dataclasses.asdict(res.history),
            "q": res.meta.q}


def _dist_worker(mesh, shard_dir, cfg, params, seed, half, fault_ref, ck):
    """One worker of the dist phase: the runs of ``DIST_RUNS`` through
    ``train_gnn(use_shard_map=True)`` from the shard directory (each
    worker loads its own partition) and the mixed-width step, each under
    :func:`_held_run`; the grad-sync identity's one ``sgd(0.1)`` step;
    and the halo identities.  Returns every worker's records (gathered to
    rank 0) and rank 0's identity run."""
    import torch.distributed as dist

    from repro_torch.core.varco import CommPolicy
    from repro_torch.train.optim import sgd
    from repro_torch.train.trainer import train_gnn

    on_card = mesh.device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = launch_counters()
    common = dict(hidden=cfg.hidden, layers=cfg.layers, seed=seed,
                  eval_every=1, device=mesh.device, params=params,
                  use_shard_map=True)

    def run(spec, comp, wire):
        return lambda: train_gnn(shard_dir, policy=CommPolicy.parse(
            spec.format(half=half), DIST_EPOCHS, compressor=comp),
            epochs=DIST_EPOCHS, wire=wire, **common)

    runs = {}
    for name, settings in DIST_RUNS.items():
        res, rec = _held_run(run(*settings), counters, on_card,
                             mesh.device)
        runs[name] = {"history": dataclasses.asdict(res.history), **rec}
    mixed, rec = _held_run(lambda: _mixed_step(mesh, shard_dir, cfg,
                                               params, half),
                           counters, on_card, mesh.device)
    mixed.update(rec)
    ident = train_gnn(shard_dir, policy=CommPolicy.parse("full", 1),
                      epochs=1, optimizer=sgd(0.1), wire="p2p", **common)
    halos = _dist_halos(mesh, shard_dir, ident.params, seed)
    fault = _dist_fault_worker(mesh, shard_dir, cfg, params, seed, counters,
                               on_card, fault_ref, ck)
    every = [None] * mesh.q
    dist.all_gather_object(every, {"runs": runs, "mixed": mixed,
                                   "halos": halos, "fault": fault,
                                   "device": str(mesh.device)})
    return {"workers": every, "ident": ident if mesh.rank == 0 else None}


def _median_ms(step_s) -> float:
    return float(np.median(np.asarray(step_s[1:] or step_s) * 1e3))


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) /
                        np.maximum(np.abs(want), 1e-30), initial=0.0))


def _held_checks(name: str, per: list) -> None:
    """Every signature a worker's measured run launched at was held
    against the plain version, as many calls held as launched, each
    within its tolerance (ELL 1e-5, the rest bitwise)."""
    for w, p in enumerate(per):
        for k in DIST_LAUNCHES:
            n = p["unchecked"][k]
            check(n == 0, f"dist {name}: worker {w} launched {k} at {n} "
                  f"signature(s) no check held against the plain version")
            held = sum(c["calls"] for c in p["checked"][k])
            check(held == p["launches"][k], f"dist {name}: worker {w} held "
                  f"{held} {k} calls against the plain version, its "
                  f"measured run launched {p['launches'][k]}")
            tol = ELL_TOL if k == "ell_spmm" else 0.0
            for c in p["checked"][k]:
                check(c["max_abs_err"] <= tol, f"dist {name}: worker {w}'s "
                      f"{k} at {c['args']} differs from the plain version "
                      f"by {c['max_abs_err']} > {tol}")


def _kernel_checks(per: list) -> dict:
    return {k: {"signatures": sum(len(p["checked"][k]) for p in per),
                "calls": sum(c["calls"] for p in per
                             for c in p["checked"][k]),
                "max_abs_err": max((c["max_abs_err"] for p in per
                                    for c in p["checked"][k]), default=None)}
            for k in DIST_LAUNCHES}


def _dist_faults(workers, r2, ref_step, shard_dir, cfg, params, eng, seed,
                 ck, backend) -> tuple:
    """The dist phase's faulted part, from each worker's
    :func:`_dist_fault_worker` record: the faulted runs against R2's
    emulated runs (``r2``), the fault step against the emulated step
    (``ref_step``), and the checkpoint after the crash resumed over three
    spawned workers and on the emulated backend.  Returns the launches
    summed over the workers and runs, and each kernel's largest error
    against its plain version."""
    from repro_torch.dist.gnn_parallel import spawn_workers
    from repro_torch.nn.gnn import params_to
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import train_gnn

    launches = {k: 0 for k in DIST_LAUNCHES}
    worst = {k: 0.0 for k in DIST_LAUNCHES}

    def count(per):
        summed = {k: sum(p["launches"][k] for p in per)
                  for k in DIST_LAUNCHES}
        for k, n in summed.items():
            launches[k] += n
        for k, c in _kernel_checks(per).items():
            worst[k] = max(worst[k], c["max_abs_err"] or 0.0)
        return summed

    crash_ep = RES_SCHED["crash_at"][0][0]
    runs = {}
    for name in DIST_FAULT_RUNS:
        per = [w["fault"]["runs"][name] for w in workers]
        # the result of rank 0 of the final mesh: the lowest survivor
        lead = next(p for p in per if p["history"] is not None)
        h, e = lead["history"], r2[name].history
        step_ms = [x * 1e3 for x in h["step_s"]]
        runs[name] = {
            "loss": h["loss"], "emulated_loss": e.loss,
            "loss_max_abs": float(np.abs(np.asarray(h["loss"]) -
                                         np.asarray(e.loss)).max()),
            "cached": h["cached_pairs"], "emulated_cached": e.cached_pairs,
            "dead": h["dead_pairs"], "emulated_dead": e.dead_pairs,
            "pairs": [len(x) for x in h["pair_transport_gf"]],
            "q": lead["q"],
            "returned_none": [p["history"] is None for p in per],
            "step_ms": step_ms,
            "step_ms_median": float(np.median(
                [x for ep, x in enumerate(step_ms) if ep not in
                 (0, crash_ep)])),
            "crash_epoch_ms": step_ms[crash_ep],
            "emulated_step_ms": [x * 1e3 for x in e.step_s],
            "sent_mb_per_step": [None if p["history"] is None else
                                 [b / 1e6 for b in p["history"]["sent_bytes"]]
                                 for p in per],
            "staged_mb_per_step": [
                None if p["history"] is None else
                [b / 1e6 for b in p["history"]["staged_bytes"]]
                for p in per],
            "peak_gb": [p["peak_gb"] for p in per],
            "launches": count(per),
            "launches_per_worker": [p["launches"] for p in per],
            "kernel_checks": _kernel_checks(per)}
        emit({"phase": "dist_fault_run", "run": name, "backend": backend,
              "max_stale": DIST_FAULT_RUNS[name], **runs[name]})
    per = [w["fault"]["step"] for w in workers]
    step = {"loss": [p["loss"] for p in per],
            "emulated_loss": ref_step["loss"],
            "loss_max_abs": max(abs(p["loss"] - ref_step["loss"])
                                for p in per),
            "step_ms": [p["step_ms"] for p in per],
            "emulated_step_ms": ref_step["step_ms"],
            "sent_mb": [p["sent_bytes"] / 1e6 for p in per],
            "cached_hops": [p["cached_hops"] for p in per],
            "first_exchange_bitwise": [p["first_exchange_bitwise"]
                                       for p in per],
            "cached_rows_bitwise": [p["cached_rows_bitwise"] for p in per],
            "served_max_abs": [p["served_max_abs"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per],
            "launches": count(per),
            "kernel_checks": _kernel_checks(per)}
    emit({"phase": "dist_fault_step", "backend": backend, **step})
    cks = [w["fault"]["ckpt"] for w in workers]
    extra = ckpt.peek(ckpt.latest_checkpoint(ck))
    t = time.perf_counter()
    resumed = spawn_workers(_dist_resume_worker, DIST_Q - 1, str(shard_dir),
                            cfg, params_to(params, "cpu"), seed, ck,
                            device=eng.device.type, backend=backend,
                            timeout=DIST_TIMEOUT)
    resume_wall = time.perf_counter() - t
    whole = next(p for p in (w["fault"]["runs"]["varco"] for w in workers)
                 if p["history"] is not None)["history"]["loss"]
    emu = train_gnn(shard_dir, checkpoint_dir=ck, resume=True,
                    **_fault_kwargs(cfg, params, seed, eng.device,
                                    RES_MAX_STALE)).history
    rh = resumed["history"]
    ck_launches = {k: sum(c["launches"][k] for c in cks)
                   for k in DIST_LAUNCHES}
    for k, n in ck_launches.items():
        launches[k] += n
        worst[k] = max([worst[k]] + [c["max_abs_err"][k] for c in cks
                                     if c["max_abs_err"][k] is not None])
    rec = {"checkpoint_step": extra["step"], "alive": extra["alive"],
           "stopped": [c["stopped"] for c in cks],
           "saves": [s for c in cks for s in c["saves"]],
           "resume_workers": resumed["q"], "resume_wall_s": resume_wall,
           "resumed_loss": rh["loss"], "uninterrupted_loss": whole[DIST_STOP:],
           "resume_vs_uninterrupted_max_abs": float(np.abs(
               np.asarray(rh["loss"]) - np.asarray(whole[DIST_STOP:])).max()),
           "resume_step_ms": [x * 1e3 for x in rh["step_s"]],
           "emulated_resume_loss": emu.loss,
           "emulated_resume_vs_group_max_abs": float(np.abs(
               np.asarray(emu.loss) - np.asarray(whole[DIST_STOP:])).max()),
           "checkpointed_run_launches": ck_launches,
           "checkpointed_run_held_calls": [c["checked"] for c in cks],
           "resume_launches": count(resumed["workers"]),
           "resume_kernel_checks": _kernel_checks(resumed["workers"])}
    emit({"phase": "dist_checkpoint", "backend": backend, **rec})

    must = DIST_KERNELS["faults"]
    for name, r in runs.items():
        _held_checks(f"faults {name}", [w["fault"]["runs"][name]
                                        for w in workers])
        check(bool(np.isfinite(r["loss"]).all()), f"dist faults {name}: "
              f"non-finite loss {r['loss']}")
        check(r["loss_max_abs"] <= DIST_TOL, f"dist faults {name}: losses "
              f"differ from R2's emulated run by {r['loss_max_abs']}")
        check(r["cached"] == r["emulated_cached"] and
              r["dead"] == r["emulated_dead"], f"dist faults {name}: the "
              f"ladder differs from R2's: {r['cached']}/{r['dead']} vs "
              f"{r['emulated_cached']}/{r['emulated_dead']}")
        check(r["q"] == 3 and r["pairs"] == [16] * crash_ep + [9] * (
            RES_EPOCHS - crash_ep), f"dist faults {name}: Q is not 3 from "
            f"epoch {crash_ep} on: {r['q']}, {r['pairs']}")
        check(r["returned_none"] == [w == 1 for w in range(DIST_Q)],
              f"dist faults {name}: the crashed worker, and only it, must "
              f"return None: {r['returned_none']}")
        for k in must:
            check(r["launches"][k] > 0, f"dist faults {name}: {k} never "
                  f"launched")
    check(sum(runs["varco_stale1"]["dead"]) > 0,
          "dist faults: no pair reached DEAD at max_stale 1")
    _held_checks("fault step", per)
    check(step["loss_max_abs"] <= DIST_TOL, f"dist fault step: losses "
          f"differ from the emulated step's by {step['loss_max_abs']}")
    check(all(step["first_exchange_bitwise"]), "dist fault step: a worker's "
          "first served cache differs from its rows of the emulated one")
    check(all(step["cached_rows_bitwise"]) and
          step["cached_hops"][1] and step["cached_hops"][2],
          "dist fault step: a CACHED pair was not served its cache rows")
    check(max(max(x) for x in step["served_max_abs"]) <= DIST_TOL,
          f"dist fault step: served caches differ from the emulated step's "
          f"by {step['served_max_abs']}")
    for k in must:
        check(step["launches"][k] > 0, f"dist fault step: {k} never "
              f"launched")
    check(extra["step"] == DIST_STOP and extra["alive"] == [0, 2, 3] and
          len(rec["saves"]) == 1, f"dist checkpoint: not the shrunk run's "
          f"single file after epoch {DIST_STOP}: {extra}, {rec['saves']}")
    check(resumed["q"] == 3, "dist checkpoint: the resume did not run 3 "
          "workers")
    check(rec["resume_vs_uninterrupted_max_abs"] <= DIST_TOL,
          f"dist checkpoint: the group's resume differs from the "
          f"uninterrupted group run by "
          f"{rec['resume_vs_uninterrupted_max_abs']}")
    check(rec["emulated_resume_vs_group_max_abs"] <= DIST_TOL,
          f"dist checkpoint: the emulated resume of the group's file "
          f"differs from the group run by "
          f"{rec['emulated_resume_vs_group_max_abs']}")
    for c, k in ((c, k) for c in cks for k in DIST_LAUNCHES):
        check(c["checked"][k] == c["launches"][k], f"dist checkpoint: "
              f"{c['checked'][k]} {k} calls held, {c['launches'][k]} "
              f"launched")
        tol = ELL_TOL if k == "ell_spmm" else 0.0
        check((c["max_abs_err"][k] or 0.0) <= tol, f"dist checkpoint: {k} "
              f"differs from its plain version by {c['max_abs_err'][k]}")
    _held_checks("faults resume", resumed["workers"])
    for k in must:
        check(rec["checkpointed_run_launches"][k] > 0 and
              rec["resume_launches"][k] > 0, f"dist checkpoint: {k} never "
              f"launched")
    return launches, worst


def dist_phase(g, cfg, params, eng, shard_dir, r2, seed: int = 0) -> dict:
    """``train_gnn(use_shard_map=True)`` at full width over Q = 4 worker
    processes booted from the resilience phase's shard directory, and one
    mixed-width auto step through ``make_auto_train_step(mesh=...)``,
    against the emulated backend on the same card.  Returns the launches
    summed over the workers and runs, and each kernel's largest error
    against its plain version at the workers' shapes."""
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist.gnn_parallel import spawn_workers
    from repro_torch.nn.gnn import params_to
    from repro_torch.train.trainer import train_gnn

    on_card = eng.device.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    backend = "nccl" if cards >= DIST_Q else "gloo"
    print(f"dist backend: {backend}, {DIST_Q} workers on {cards} card(s)" +
          (", every transfer staged through pinned host memory"
           if backend == "gloo" and on_card else ""), flush=True)
    if backend == "gloo":
        print(f"NCCL unverified: {cards} card{'s' * (cards != 1)}",
              flush=True)
    half = _dist_half(shard_dir, cfg)
    common = dict(hidden=cfg.hidden, layers=cfg.layers, seed=seed,
                  eval_every=1, device=eng.device, params=params)
    emulated = {}
    for name, (spec, comp, wire) in DIST_RUNS.items():
        emulated[name] = train_gnn(shard_dir, policy=CommPolicy.parse(
            spec.format(half=half), DIST_EPOCHS, compressor=comp),
            epochs=DIST_EPOCHS, wire=wire, **common).history
    emulated_mixed = _mixed_step(None, shard_dir, cfg, params, half)
    fault_ref, ck = Path(shard_dir).parent / "dist_fault_ref", \
        str(Path(shard_dir).parent / "dist_ck")
    ref_step = _fault_reference(shard_dir, cfg, params, seed, fault_ref)
    t = time.perf_counter()
    out = spawn_workers(_dist_worker, DIST_Q, str(shard_dir), cfg,
                        params_to(params, "cpu"), seed, half, fault_ref, ck,
                        device=eng.device.type, backend=backend,
                        timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t
    workers = out["workers"]
    ident = _grad_sync_identity(out["ident"], g, cfg, params)
    launches = {k: 0 for k in DIST_LAUNCHES}
    runs = {}
    for name in DIST_RUNS:
        h = workers[0]["runs"][name]["history"]
        e = emulated[name]
        per = [w["runs"][name] for w in workers]
        summed = {k: sum(p["launches"][k] for p in per)
                  for k in DIST_LAUNCHES}
        for k, n in summed.items():
            launches[k] += n
        hists = [p["history"] for p in per]
        runs[name] = {
            "loss": h["loss"], "emulated_loss": e.loss,
            "loss_max_abs": float(np.abs(np.asarray(h["loss"]) -
                                         np.asarray(e.loss)).max()),
            "ledger_max_rel": _rel_max(
                h["halo_gfloats"] + h["transport_gfloats"],
                e.halo_gfloats + e.transport_gfloats),
            "pair_transport_max_rel": _rel_max(h["pair_transport_gf"],
                                               e.pair_transport_gf),
            "rate": h["rate"], "emulated_rate": e.rate, "width": h["width"],
            "rates_equal": all(x["rate"] == e.rate for x in hists),
            "acc_max_abs": max(
                abs(a - b) for k in ("train_acc", "val_acc", "test_acc")
                for a, b in zip(h[k], getattr(e, k))),
            "step_ms_median": _median_ms(h["step_s"]),
            "emulated_step_ms_median": _median_ms(e.step_s),
            "step_ms": [x * 1e3 for x in h["step_s"]],
            "sent_mb_median": [float(np.median(x["sent_bytes"])) / 1e6
                               for x in hists],
            "staged_mb_median": [float(np.median(x["staged_bytes"])) / 1e6
                                 for x in hists],
            "sent_bytes_per_step": [x["sent_bytes"] for x in hists],
            "staged_bytes_per_step": [x["staged_bytes"] for x in hists],
            # host ms inside the transport: staging, collectives, waits
            "comm_ms_per_step": [[s * 1e3 for s in x["comm_s"]]
                                 for x in hists],
            "peak_gb": [p["peak_gb"] for p in per],
            "launches": summed,
            "launches_per_worker": [p["launches"] for p in per],
            # the per-worker kernel calls held against the plain versions
            "kernel_checks": _kernel_checks(per)}
        emit({"phase": "dist_run", "run": name, "backend": backend,
              **runs[name]})
    per = [w["mixed"] for w in workers]
    mixed_launches = {k: sum(p["launches"][k] for p in per)
                      for k in DIST_LAUNCHES}
    for k, n in mixed_launches.items():
        launches[k] += n
    mixed = {"loss": [p["loss"] for p in per],
             "emulated_loss": emulated_mixed["loss"],
             "loss_max_abs": max(abs(p["loss"] - emulated_mixed["loss"])
                                 for p in per),
             "step_ms": [p["step_ms"] for p in per],
             "emulated_step_ms": emulated_mixed["step_ms"],
             "sent_mb": [p["sent_bytes"] / 1e6 for p in per],
             "staged_mb": [p["staged_bytes"] / 1e6 for p in per],
             "peak_gb": [p["peak_gb"] for p in per],
             "launches": mixed_launches,
             "launches_per_worker": [p["launches"] for p in per],
             "kernel_checks": _kernel_checks(per)}
    emit({"phase": "dist_run", "run": "p2p_mixed_step", "backend": backend,
          **mixed})
    summary = {"phase": "dist", "backend": backend, "workers": DIST_Q,
               "cards": cards, "devices": [w["device"] for w in workers],
               "epochs": DIST_EPOCHS, "half_budget_bits": half,
               "wall_s": wall,
               "halo_identity": [w["halos"] for w in workers],
               "grad_sync_identity": ident, "launches": launches,
               "step_ms_median": {k: r["step_ms_median"]
                                  for k, r in runs.items()},
               "emulated_step_ms_median": {
                   k: r["emulated_step_ms_median"] for k, r in runs.items()}}
    emit(summary)
    for name, r in runs.items():
        _held_checks(name, [w["runs"][name] for w in workers])
        check(bool(np.isfinite(r["loss"]).all()), f"dist {name}: non-finite "
              f"loss {r['loss']}")
        check(r["loss_max_abs"] <= DIST_TOL, f"dist {name}: losses differ "
              f"from the emulated backend's by {r['loss_max_abs']}")
        check(r["ledger_max_rel"] <= 1e-6, f"dist {name}: ledger differs "
              f"from the emulated backend's (rel {r['ledger_max_rel']})")
        check(r["acc_max_abs"] <= DIST_ACC_TOL, f"dist {name}: accuracies "
              f"differ from the emulated backend's by {r['acc_max_abs']}")
        check(all(min(b) > 0 for b in r["sent_bytes_per_step"]),
              f"dist {name}: a worker shipped nothing")
        kernels = DIST_KERNELS[name]
        if name.startswith(("p2p_auto", "packed_auto")):
            check(r["rates_equal"], f"dist {name}: the workers' controllers "
                  f"planned other rates than the emulated one: "
                  f"{r['rate']} vs {r['emulated_rate']}")
            check(r["pair_transport_max_rel"] <= 1e-6, f"dist {name}: "
                  f"pair_transport_gf differs from the emulated backend's "
                  f"(rel {r['pair_transport_max_rel']})")
            if min(r["width"]) < 32:             # a sub-byte wire ran
                kernels += TRAIN_QUANT_KERNELS
        for k in kernels:
            check(r["launches"][k] > 0, f"dist {name}: {k} never launched "
                  f"by any worker")
    check(min(runs["p2p_auto_w8"]["width"]) < 32,
          "dist p2p_auto_w8: no epoch quantised")
    check(runs["dense_varco"]["launches"]["random_mask"] > 0 and
          runs["p2p_full"]["launches"]["varco_pack"] == 0,
          "dist: the wires launched the wrong kernels")
    check(launches["varco_pack_quant"] == 0, "dist: a worker launched the "
          "rint codec: the card's default wire rounding is stochastic")
    _held_checks("p2p_mixed_step", [w["mixed"] for w in workers])
    check(mixed["loss_max_abs"] <= DIST_TOL, f"dist p2p_mixed_step: losses "
          f"differ from the emulated step's by {mixed['loss_max_abs']}")
    for w, per_w in enumerate(mixed["launches_per_worker"]):
        for k in DIST_KERNELS["p2p_mixed_step"]:
            check(per_w[k] > 0, f"dist p2p_mixed_step: worker {w} never "
                  f"launched {k}")
    want = {k: True for k in ("p2p", "packed", "p2p_w8", "packed_w4",
                              "p2p_mixed")}
    for r, w in enumerate(workers):
        check(w["halos"] == want, f"dist: worker {r}'s halo or residual "
              f"differs from the emulated backend's slice: {w['halos']}")
    check(ident["loss_err"] <= GRAD_TOL and ident["param_err"] <= GRAD_TOL,
          f"dist: grad-sync identity broken: {ident}")
    worst = {}
    for k in DIST_LAUNCHES:
        errs = [r["kernel_checks"][k]["max_abs_err"] for r in
                (*runs.values(), mixed)]
        worst[k] = max((e for e in errs if e is not None), default=0.0)
    fault_launches, fault_worst = _dist_faults(
        workers, r2, ref_step, shard_dir, cfg, params, eng, seed, ck,
        backend)
    for k in DIST_LAUNCHES:
        launches[k] += fault_launches[k]
        worst[k] = max(worst[k], fault_worst[k])
    return launches, worst


# ---------------------------------------------------------------------------
# phase 6e: streaming edge updates, and serving with stochastic rounding
# ---------------------------------------------------------------------------

#: inserts and deletes (of existing edges) in the update batch
UPDATE_BATCH = 256


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic mode around a comparison of two runs: the
    remote-halo ``index_add_`` then sums in a fixed order (no atomics), so
    a later layer's activations, and the halos packed from them, repeat
    bit for bit.  ``warn_only``: cuBLAS stays as it is (deterministic on
    one stream)."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was)


def _stoch_refreshes(eng, n_refresh: int) -> list:
    """A forced and ``n_refresh - 1`` non-forced refreshes; each one's
    halo caches (the hop buffers as received, one per exchange) and
    transport bits."""
    out = []
    for i in range(n_refresh):
        m = eng.refresh(force=i == 0)
        torch.cuda.synchronize()
        out.append(([h.clone() for h in eng._halo_cache],
                    float(m["transport_bits"])))
    return out


def update_phase(g, cfg, params, eng, seed: int = 0) -> dict:
    """A seeded batch of ``UPDATE_BATCH`` inserts and as many deletes of
    existing edges through ``eng.apply_updates`` (host spill, frontier
    recompute on the card, repartition on the unchanged owner vector): the
    patched cache against ``centralized_forward`` on the new graph and
    against the forced refresh that follows, within 1e-4; launch counts
    set to 0, three non-forced refreshes on the new topology, counts read
    (``ell_spmm`` and the wire must run).  Then an engine with
    ``rounding="stochastic"`` and the drift gate off, counts set to 0, a
    forced and two non-forced refreshes, counts read (the stochastic codec
    must run); its halo caches must equal those of the same refreshes
    with the plain codecs swapped in, bitwise.  Runs last among the GNN
    phases: the update changes ``eng``'s graph."""
    import copy

    from repro_torch.nn.gnn import centralized_forward
    from repro_torch.serve import ServingEngine

    counters = launch_counters()
    rng = np.random.default_rng(seed + 20)
    n, n_layers = eng.g.num_nodes, len(params["layers"])
    dst0, src0 = eng.g.edge_list()
    pick = rng.integers(0, len(dst0), UPDATE_BATCH)
    edges_before = eng.g.num_edges
    eng.refresh(force=True)             # the cache the update patches
    touched, fronts = eng.apply_updates(
        inserts=(rng.integers(0, n, UPDATE_BATCH),
                 rng.integers(0, n, UPDATE_BATCH)),
        deletes=(dst0[pick], src0[pick]))
    timing = dict(eng.timing)
    status = eng.status()
    patched = [eng.cache.gather(li, np.arange(n)) for li in range(n_layers)]
    ref = centralized_forward(params, cfg, eng.g, device=eng.device)
    err_central = float(np.abs(patched[-1] - ref.cpu().numpy()).max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.refresh(force=True)
    forced_ms = (time.perf_counter() - t0) * 1e3
    err_forced = max(float(np.abs(patched[li] - eng.cache.gather(
        li, np.arange(n))).max()) for li in range(n_layers))
    for fn in counters.values():
        fn.launches = 0
    for _ in range(3):
        eng.refresh()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    wire = sum(launches[k] for k in ("varco_pack", "varco_pack_quant"))

    s_eng = ServingEngine(eng.g, params, cfg, q=eng.q, device=eng.device,
                          seed=seed, threshold=-1.0, rounding="stochastic")
    twin = copy.deepcopy(s_eng)          # the same state, for the plain run
    for fn in counters.values():
        fn.launches = 0
    with deterministic():
        stoch = _stoch_refreshes(s_eng, 3)
        s_launches = {name: counters[name].launches
                      for name in STOCH_KERNELS}
        with plain_codecs():
            plain = _stoch_refreshes(twin, 3)
    # per refresh, per exchange
    halo_equal = [[torch.equal(x, y) for x, y in zip(a[0], b[0])]
                  for a, b in zip(stoch, plain)]
    emb_err = float(np.abs(s_eng.serve(np.arange(n))[0] -
                           twin.serve(np.arange(n))[0]).max())
    rec = {"phase": "update", "nodes": n, "inserts": UPDATE_BATCH,
           "deletes": UPDATE_BATCH, "directed_edges_before": edges_before,
           "directed_edges_after": eng.g.num_edges,
           "touched": int(len(touched)),
           "frontier_sizes": [int(len(f)) for f in fronts],
           "spill_s": timing["spill_s"], "gather_s": timing["gather_s"],
           "recompute_ms": timing["recompute_s"] * 1e3,
           "rebuild_s": timing["rebuild_s"], "status": status,
           "patched_vs_centralized_max_abs": err_central,
           "patched_vs_forced_refresh_max_abs": err_forced,
           "forced_refresh_ms": forced_ms, "refresh_launches": launches,
           "stochastic_launches": s_launches,
           "stochastic_transport_bits": [t for _, t in stoch],
           "stochastic_halo_equals_plain": halo_equal,
           "stochastic_emb_vs_plain_max_abs": emb_err}
    emit(rec)
    check(status == "CACHED", f"after an update the status is {status}")
    check(err_central <= FRESH_TOL, f"the patched cache differs from "
          f"centralized_forward on the new graph by {err_central}")
    check(err_forced <= FRESH_TOL, f"the patched cache differs from a "
          f"forced refresh by {err_forced}")
    check(launches["ell_spmm"] > 0 and wire > 0, f"the refreshes after the "
          f"update launched {launches}")
    check(s_launches["varco_pack_quant_stochastic"] > 0,
          f"stochastic serving launched {s_launches}")
    check(all(t > 0 for _, t in stoch[1:]), "a stochastic refresh shipped "
          "nothing")
    check(all(len(h) == n_layers and all(h) for h in halo_equal),
          f"stochastic serving's halo differs from the plain codecs' "
          f"(per refresh, per exchange): {halo_equal}")
    del s_eng, twin, stoch, plain
    return s_launches


# ---------------------------------------------------------------------------
# phase 7: the LM kernels against their plain versions
# ---------------------------------------------------------------------------


def _within(got, want, rtol, atol) -> bool:
    """``|got − want| <= atol + rtol·|want|`` everywhere (in f32)."""
    want = want.float()
    return bool(((got.float() - want).abs() <= atol + rtol * want.abs())
                .all())


def _row_rel_err(out, ref) -> float:
    """The worst row's ``max |out − ref|`` over its ``max |ref|`` (rows
    whose reference is all 0 are held by the absolute check)."""
    err = (out.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    live = scale > 0
    return float((err[live] / scale[live]).max())


def _flash_row_check(name, out, ref, control) -> dict:
    """The bf16 row check: ``out`` within ``FLASH_ROW_TOL`` of ``ref`` row
    by row, and ``control`` (a wrong kernel's output) outside it."""
    row = _row_rel_err(out, ref)
    ctl = _row_rel_err(control, ref)
    check(row <= FLASH_ROW_TOL, f"flash_attention {name}: a row's error "
          f"is {row} of its largest value (limit {FLASH_ROW_TOL})")
    check(ctl > FLASH_ROW_TOL, f"flash_attention {name}: the row check "
          f"misses the control ({ctl} <= {FLASH_ROW_TOL})")
    return {"row_rel_err": row, "control_row_rel_err": ctl,
            "control_max_abs_err": float((control.float() - ref).abs()
                                         .max())}


def _attn_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one head: the work the data
    needs."""
    q = np.arange(s)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(s, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _ssd_flops(b: int, nc: int, q: int, h: int, p: int, g: int,
               n: int) -> float:
    """Flops the SSD chunk form needs: ``C·Bᵀ`` once per (batch, chunk,
    group) over the causal pairs, then per head ``M·X`` over those pairs
    and the ``[P, N]`` state contribution over the chunk's rows."""
    pairs = q * (q + 1) // 2
    return 2.0 * b * nc * (g * pairs * n + h * (pairs * p + q * p * n))


def _flash_case(name, b, h, kv, s, d, dtype, window, reps, gen,
                library=False, graph=False):
    """Flash attention at one shape against the plain version, on the
    kernel ``kernel_for`` names; with ``graph`` the kernel and library
    times are those of a replayed CUDA graph of ``reps`` calls (their
    eager times beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_for)

    dev = gen.device
    # the model's [B, S, H, D] layout, handed over as transposed views
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev,
                           dtype=dtype).transpose(1, 2)
               for n in (h, kv, kv))
    path = kernel_for(dtype, d)
    kernel = FLASH_NAMES[path]
    counters = launch_counters()
    before = {name_: counters[name_].launches
              for name_ in FLASH_NAMES.values()}
    out = flash_attention(q, k, v, True, window)
    ref = flash_attention_plain(q, k, v, True, window).float()
    torch.cuda.synchronize()
    moved = {name_: counters[name_].launches - before[name_]
             for name_ in before}
    check(moved == {name_: int(name_ == kernel) for name_ in before},
          f"flash_attention {name}: expected one launch of {kernel}, "
          f"counters moved {moved}")
    err = float((out.float() - ref).abs().max())
    tol = FLASH_TOL[dtype]
    check(_within(out, ref, tol, tol),
          f"flash_attention {name}: max abs err {err} (tol {tol})")
    rows = {} if dtype != torch.bfloat16 else _flash_row_check(
        name, out, ref, flash_attention_plain(
            q, k, v, True, (window or s) - FLASH_CONTROL_KEYS))
    elt = q.element_size()
    n_bytes = elt * d * s * b * (2 * h + 2 * kv)       # q, k, v, out
    flops = 4.0 * d * _attn_pairs(s, True, window) * b * h
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S
                          if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    timed = graph_ms if graph else cuda_ms
    lib_ms = lib_err = None
    if library:
        # causal: is_causal; a window: a boolean mask (True = attend),
        # built here, outside the timing
        mask = None
        if window > 0:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & \
                (i[None, :] > i[:, None] - window)
        kw = {"attn_mask": mask} if mask is not None else {"is_causal": True}
        lib = F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        lib_err = float((lib.float() - ref).abs().max())
        check(dtype != torch.bfloat16 or _within(lib, ref, tol, tol),
              f"scaled_dot_product_attention disagrees with the plain "
              f"version at {name} (max abs err {lib_err})")
        lib_ms = timed(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw), reps)
    rec = {"kernel": kernel, "path": path, "case": name,
           "shape": {"q": [b, h, s, d], "kv": [b, kv, s, d],
                     "dtype": str(dtype), "window": window},
           "max_abs_err": err, **rows,
           "kernel_ms": timed(lambda: flash_attention(q, k, v, True,
                                                      window), reps),
           "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, True,
                                                             window),
                               max(reps // 5, 1)),
           "library_ms": lib_ms, "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": n_bytes, "timed_by": "graph" if graph else "eager"}
    if graph:
        rec["kernel_eager_ms"] = cuda_ms(lambda: flash_attention(
            q, k, v, True, window), reps)
        if library:
            rec["library_eager_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, enable_gqa=True, **kw), reps)
    emit(rec)
    return rec


def prompt_positions(kind: str, b: int, s: int, device) -> torch.Tensor:
    """int32 ``[B, S]`` prompt positions: ``shifted`` rows start at 7 +
    3·row (``arange + c``); ``left_padded`` rows repeat position 0 over
    their first ``97·row mod S/2`` slots, then count up."""
    i = torch.arange(s, dtype=torch.int32)
    if kind == "shifted":
        rows = [i + 7 + 3 * r for r in range(b)]
    else:
        rows = [torch.clamp(i - (97 * r) % (s // 2), min=0) for r in range(b)]
    return torch.stack(rows).contiguous().to(device)


def _flash_pos_case(name, b, h, kv, s, d, dtype, window, kind, reps, gen,
                    graph=False):
    """Flash attention with explicit positions (the JAX package's prefill
    mask) against the plain version, on the kernel ``kernel_for`` names;
    kernel, plain and library times (``scaled_dot_product_attention``
    with the boolean position mask, built outside the timing) and the
    bound over the (query, key) pairs the positions leave unmasked,
    counted on the host; with ``graph`` the kernel and library times are
    those of a replayed CUDA graph of ``reps`` calls (their eager times
    beside them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_mask,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     kernel_for)

    dev = gen.device
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev,
                           dtype=dtype).transpose(1, 2)
               for n in (h, kv, kv))
    pos = prompt_positions(kind, b, s, dev)
    path = kernel_for(dtype, d)
    kernel = FLASH_NAMES[path]
    counters = launch_counters()
    before = counters[kernel].launches
    out = flash_attention(q, k, v, True, window, pos, pos)
    ref = flash_attention_plain(q, k, v, True, window, pos, pos).float()
    torch.cuda.synchronize()
    check(counters[kernel].launches == before + 1,
          f"flash_attention {name}: {kernel} did not launch once")
    err = float((out.float() - ref).abs().max())
    tol = FLASH_TOL[dtype]
    check(_within(out, ref, tol, tol),
          f"flash_attention {name}: max abs err {err} (tol {tol})")
    rows = {} if dtype != torch.bfloat16 else _flash_row_check(
        name, out, ref, flash_attention_plain(
            q, k, v, True, (window or s) - FLASH_CONTROL_KEYS, pos, pos))
    mask = attention_mask(s, True, window, dev, pos, pos)     # [B, S, S]
    pairs = int(mask.sum().cpu()) * h
    n_bytes = q.element_size() * d * s * b * (2 * h + 2 * kv)
    flops = 4.0 * d * pairs
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S
                          if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
    attn_mask = mask[:, None]                                 # [B, 1, S, S]
    lib = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                         enable_gqa=True)
    lib_err = float((lib.float() - ref).abs().max())
    check(dtype != torch.bfloat16 or _within(lib, ref, tol, tol),
          f"scaled_dot_product_attention disagrees with the plain version "
          f"at {name} (max abs err {lib_err})")
    timed = graph_ms if graph else cuda_ms
    rec = {"kernel": kernel, "path": path, "case": name,
           "shape": {"q": [b, h, s, d], "kv": [b, kv, s, d],
                     "dtype": str(dtype), "window": window,
                     "positions": kind},
           "max_abs_err": err, **rows,
           "kernel_ms": timed(lambda: flash_attention(
               q, k, v, True, window, pos, pos), reps),
           "plain_ms": cuda_ms(lambda: flash_attention_plain(
               q, k, v, True, window, pos, pos), max(reps // 5, 1)),
           "library_ms": timed(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=attn_mask, enable_gqa=True), reps),
           "library_max_abs_err": lib_err,
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": n_bytes, "pairs": pairs,
           "timed_by": "graph" if graph else "eager"}
    if graph:
        rec["kernel_eager_ms"] = cuda_ms(lambda: flash_attention(
            q, k, v, True, window, pos, pos), reps)
        rec["library_eager_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, enable_gqa=True), reps)
    emit(rec)
    return rec


def _ssd_case(name, b, nc, q, h, p, g, n, reps, gen):
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain

    dev = gen.device
    # x, B and C as strided views of one conv-output-like buffer
    wide = torch.randn((b, nc, q, h * p + 2 * g * n), generator=gen,
                       device=dev)
    x = wide[..., :h * p].reshape(b, nc, q, h, p)
    bm = wide[..., h * p:h * p + g * n].reshape(b, nc, q, g, n)
    cm = wide[..., h * p + g * n:].reshape(b, nc, q, g, n)
    dt = torch.rand((b, nc, q, h), generator=gen, device=dev) * 0.099 + 1e-3
    a = -torch.exp(torch.rand((h,), generator=gen, device=dev) * 2 - 1)
    cum = torch.cumsum(dt * a, dim=2)
    args = (x, dt, cum, bm, cm)
    y, st = ssd_chunk(*args)
    y_ref, st_ref = ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    err = max(float((y - y_ref).abs().max()), float((st - st_ref).abs()
                                                    .max()))
    for got, want, what in ((y, y_ref, "y"), (st, st_ref, "state")):
        check(_within(got, want, SSD_RTOL, SSD_ATOL),
              f"ssd_chunk {name}: {what} differs from the plain version "
              f"(max abs err {err})")
    flops = _ssd_flops(b, nc, q, h, p, g, n)
    n_bytes = 4 * (2 * x.numel() + 2 * dt.numel() + 2 * bm.numel() +
                   st.numel())                  # x, y; dt, cum; B, C; s
    b_ms, b_by = bound_ms(n_bytes, flops)
    rec = {"kernel": "ssd_chunk", "case": name,
           "shape": {"x": [b, nc, q, h, p], "bc": [b, nc, q, g, n]},
           "max_abs_err": err,
           "kernel_ms": cuda_ms(lambda: ssd_chunk(*args), reps),
           "plain_ms": cuda_ms(lambda: ssd_chunk_plain(*args),
                               max(reps // 5, 1)),
           "library_ms": None,    # no single PyTorch call computes it
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": n_bytes}
    emit(rec)
    return rec


def lm_kernels_phase(reps: int = 10) -> dict:
    """The LM kernels at the LM paths' shapes (main rows) and at the other
    shapes they take.  Returns ``{kernel: main record}`` with the
    largest error over its cases."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    # first record of each kernel: its main row (flash_attention: the
    # full-width MoE path's prefill; flash_attention_simt: the f32 granite
    # shape that the f32 serving path runs; flash_attention_mma: bf16 at
    # D = 32)
    flash = [
        _flash_case("qwen2_moe_prefill", 8, 16, 16, 2048, 128, bf16, 0, reps,
                    gen, library=True),
        _flash_case("granite_prefill", 8, 32, 8, 2048, 64, bf16, 0, reps,
                    gen, library=True),
        # every other full-size prefill shape: MHA at D = 256 (gemma) and
        # D = 64 (musicgen); GQA 32/4 (yi), 64/8 (qwen3, jamba), 40/8
        # (llama4), 12/2 (qwen2-vl)
        _flash_case("gemma_prefill", 8, 16, 16, 2048, 256, bf16, 0, reps,
                    gen, library=True),
        _flash_case("musicgen_prefill", 8, 32, 32, 2048, 64, bf16, 0, reps,
                    gen, library=True),
        _flash_case("yi_prefill", 8, 32, 4, 2048, 128, bf16, 0, reps, gen,
                    library=True),
        _flash_case("qwen3_jamba_prefill", 8, 64, 8, 2048, 128, bf16, 0,
                    reps, gen, library=True),
        _flash_case("llama4_prefill", 8, 40, 8, 2048, 128, bf16, 0, reps,
                    gen, library=True),
        _flash_case("qwen2_vl_prefill", 8, 12, 2, 2048, 128, bf16, 0, reps,
                    gen, library=True),
        _flash_case("d128", 2, 32, 8, 2048, 128, bf16, 0, reps, gen,
                    library=True),
        _flash_case("d256", 2, 16, 16, 2048, 256, bf16, 0, reps, gen,
                    library=True),
        _flash_case("window1024", 8, 32, 8, 2048, 64, bf16, 1024, reps, gen,
                    library=True),
        _flash_case("ragged_s1000", 2, 32, 8, 1000, 64, bf16, 0, reps, gen,
                    library=True),
        _flash_case("f32", 2, 32, 8, 2048, 64, f32, 0, reps, gen,
                    library=True),
        # the narrow heads of the SMOKE configs: bf16 on the narrow-head
        # tensor-core kernel, f32 on the CUDA-core one.  A bf16 call takes
        # ~30 us on the card and about as long in the host's Python, so
        # back-to-back calls time the host: kernel and library are timed
        # by a replayed graph of NARROW_REPS calls (eager times beside)
        _flash_case("bf16_d32", 2, 8, 4, 2048, 32, bf16, 0, NARROW_REPS, gen,
                    library=True, graph=True),
        _flash_case("bf16_d16", 2, 8, 4, 2048, 16, bf16, 0, NARROW_REPS, gen,
                    library=True, graph=True),
        _flash_case("f32_d32", 2, 8, 4, 2048, 32, f32, 0, reps, gen,
                    library=True),
        # explicit positions on both kernels: a shifted and a left-padded
        # batch at granite's widths (bf16) and in f32
        _flash_pos_case("granite_shifted", 8, 32, 8, 2048, 64, bf16, 0,
                        "shifted", reps, gen),
        _flash_pos_case("granite_left_padded", 8, 32, 8, 2000, 64, bf16, 0,
                        "left_padded", reps, gen),
        _flash_pos_case("window_left_padded", 2, 32, 8, 2000, 128, bf16,
                        512, "left_padded", reps, gen),
        _flash_pos_case("f32_left_padded", 2, 32, 8, 2000, 64, f32, 0,
                        "left_padded", reps, gen),
        _flash_pos_case("f32_shifted", 2, 32, 8, 2048, 64, f32, 0,
                        "shifted", reps, gen),
        _flash_pos_case("bf16_d32_left_padded", 2, 8, 4, 2000, 32, bf16, 0,
                        "left_padded", NARROW_REPS, gen, graph=True),
    ]
    ssd = [_ssd_case("mamba2_prefill", 8, 8, 256, 24, 64, 1, 128, reps, gen),
           # jamba's mamba layer: d_inner 16384 in 256 heads of 64
           _ssd_case("jamba_prefill", 8, 8, 256, 256, 64, 1, 128, reps, gen),
           _ssd_case("ragged_g2", 2, 3, 100, 4, 32, 2, 16, reps, gen),
           _ssd_case("g2_rep3_q100", 2, 3, 100, 6, 64, 2, 128, reps, gen)]
    main = {}
    for rec in flash + ssd:
        name = rec["kernel"]
        main.setdefault(name, dict(rec))
        main[name]["max_abs_err"] = max(main[name]["max_abs_err"],
                                        rec["max_abs_err"])
    return main


# ---------------------------------------------------------------------------
# phase 8: the LM serving slice
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Run the model with the plain versions in place of the LM kernels
    (for the comparison of the two paths on the card only)."""
    from repro_torch.kernels import ops

    saved = ops.flash_attention, ops.ssd_chunk_kernel
    ops.flash_attention = ops.flash_attention_plain
    ops.ssd_chunk_kernel = ops.ssd_chunk_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_chunk_kernel = saved


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got − want| over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() /
                 want.abs().max().clamp(min=1e-30))


def _consistency(cfg, params, prompts, s):
    """prefill(s − 1) + one decode step against prefill(s), relative to
    the largest logit."""
    from repro_torch.models.transformer import decode_step, prefill

    want, _ = prefill(params, cfg, {"tokens": prompts[:, :s]})
    _, cache = prefill(params, cfg, {"tokens": prompts[:, :s - 1]},
                       max_len=s + 8)
    got, _ = decode_step(params, cfg, {"tokens": prompts[:, s - 1:s]},
                         cache)
    return _rel_err(got, want)


@contextlib.contextmanager
def routed(record: list = None, replay: list = None):
    """Around MoE runs: append each MoE layer's top-k expert indices to
    ``record``, or route each layer to the experts ``replay`` holds (in
    call order), gate values renormalised from this run's router."""
    from repro_torch.models import moe

    route = moe.route
    it = iter(replay or ())

    def wrapped(params, m, xt):
        probs, gates, idx = route(params, m, xt)
        if replay is not None:
            idx = next(it)
            gates = probs.gather(1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        if record is not None:
            record.append(idx)
        return probs, gates, idx

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route


def _same_choices(a: list, b: list) -> float:
    """Share of (layer, token) pairs whose top-k expert sets are equal (the
    order within a token's choices changes no output)."""
    same = [(x.sort(-1).values == y.sort(-1).values).all(-1).float().mean()
            for x, y in zip(a, b)]
    return float(torch.stack(same).mean())


def expected_launches(cfg) -> dict:
    """Each LM kernel's launches in one prefill: one flash launch (on the
    kernel ``kernel_for`` picks) per attention layer, one SSD launch per
    mamba layer."""
    from repro_torch.kernels.flash_attention import kernel_for

    want = dict.fromkeys(LM_KERNELS, 0)
    n_attn = cfg.n_blocks * cfg.pattern.count("attn")
    if n_attn:
        want[FLASH_NAMES[kernel_for(cfg.adtype,
                                    cfg.resolved_head_dim)]] = n_attn
    want["ssd_chunk"] = cfg.n_blocks * cfg.pattern.count("mamba")
    return want


def _n_moe(cfg) -> int:
    return cfg.n_blocks * sum(cfg.layer_uses_moe(pi)
                              for pi in range(cfg.pattern_period))


def _prompts(cfg, seed: int, batch: int = LM_BATCH) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, LM_PROMPT)).astype(np.int32)).cuda()


def _init(cfg, seed: int):
    from repro_torch.models.transformer import init_lm

    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def lm_phase(seed: int = 0) -> dict:
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import prefill
    from repro_torch.nn.modules import param_count

    counters = launch_counters()
    launches = {}
    for arch, spec in LM_SERVE.items():
        cfg = get_config(arch).with_(**spec.get("cut", {}))
        params, init_s = _init(cfg, seed)
        prompts = _prompts(cfg, seed)
        n_moe = _n_moe(cfg)
        kernel_routes, plain_routes = [], []
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        out = serve(cfg, params, prompts, LM_NEW, device="cuda")
        got = {name: counters[name].launches for name in LM_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = expected_launches(cfg)
        check(got == want, f"{arch}: LM kernels launched {got} in one "
              f"prefill + {LM_NEW - 1} decode steps, expected {want}")
        for name, owner in LM_KERNELS.items():
            if owner == arch:
                launches[name] = got[name]
        check(tuple(out.tokens.shape) == (LM_BATCH, LM_NEW) and
              bool(((out.tokens >= 0) & (out.tokens < cfg.vocab_size))
                   .all()), f"{arch}: malformed tokens")
        check(bool(torch.isfinite(out.prefill_logits.float()).all()),
              f"{arch}: non-finite prefill logits")
        timing = {"prefill_ms": out.prefill_s * 1e3,
                  "prefill_tokens_per_s": LM_BATCH * LM_PROMPT /
                  out.prefill_s,
                  "decode_s": out.decode_s,
                  "decode_tokens_per_s": out.decode_tokens_per_s,
                  "decode_ms_per_step": out.decode_s / (LM_NEW - 1) * 1e3,
                  "peak_mem_gb": peak,
                  "first_tokens": out.tokens[0, :8].tolist(),
                  **analytic_bound(cfg, LM_BATCH, LM_PROMPT, "prefill")}
        del out
        _, timing["warm_prefill_ms"] = _timed_prefill(
            params, cfg, {"tokens": prompts})
        # the plain path on the same prompts (a smaller batch where its
        # dense scores would not fit: the kernel path again at that batch)
        pb = spec.get("plain_batch", LM_BATCH)
        with routed(record=kernel_routes):
            kernel_logits, _ = prefill(params, cfg, {"tokens": prompts[:pb]})
        with plain_kernels(), routed(record=plain_routes):
            plain, _ = prefill(params, cfg, {"tokens": prompts[:pb]},
                               max_len=LM_PROMPT + LM_NEW)
        plain_err = _rel_err(kernel_logits, plain)
        moe_rec = {}
        if n_moe:
            # in bf16 the two paths' roundings flip near-tied router
            # choices, and each flip moves a token's FFN output by O(1):
            # the plain path routed to the kernel path's experts is what
            # holds the kernels to the plain function; the free-running
            # error and the share of equal choices are printed beside it
            with plain_kernels(), routed(replay=kernel_routes):
                pinned, _ = prefill(params, cfg, {"tokens": prompts})
            moe_rec = {"same_expert_choices": _same_choices(kernel_routes,
                                                            plain_routes),
                       "free_routing_plain_path_rel_err": plain_err}
            plain_err = _rel_err(kernel_logits, pinned)
            del pinned
        pos_errs, pos_ms = {}, {}
        if arch == "granite-3-2b":
            pos_errs, pos_ms = _positions_prefill(cfg, params, prompts)
        cons, cons_launches = None, {}
        if cfg.mamba is not None and "attn" not in cfg.pattern:
            # S = one chunk: 2047 tokens would be no multiple of it
            cons = _consistency(cfg, params, prompts, cfg.mamba.chunk)
        elif arch == "granite-3-2b":
            # the identity in f32: a bf16 decode rounds its scores before
            # the softmax; batch 2 of the prompts.  Granite served in f32
            # is the CUDA-core flash kernel's path: two prefills
            for fn in counters.values():
                fn.launches = 0
            cons = _consistency(
                cfg.with_(param_dtype="float32", activ_dtype="float32"),
                _tree_float(params), prompts[:2], LM_PROMPT)
            cons_launches = {name: counters[name].launches
                             for name in LM_KERNELS}
            want = {**dict.fromkeys(LM_KERNELS, 0),
                    "flash_attention_simt": 2 * cfg.n_layers}
            check(cons_launches == want, f"{arch} in f32: flash launches "
                  f"{cons_launches}, expected {want}")
            launches["flash_attention_simt"] = cons_launches[
                "flash_attention_simt"]
        rec = {"phase": "lm", "arch": arch, "params": param_count(params),
               "dtype": cfg.param_dtype, "layers": cfg.n_layers,
               "pattern": list(cfg.pattern), "cut": spec.get("cut", {}),
               "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
               "init_s": init_s, **timing, "launches": got,
               "plain_path_batch": pb, "plain_path_rel_err": plain_err,
               **moe_rec,
               "positions_plain_path_rel_err": pos_errs,
               "positions_prefill_ms": pos_ms,
               "decode_consistency_rel_err": cons,
               **({"f32_consistency_launches": cons_launches}
                  if cons_launches else {})}
        emit(rec)
        tol = PLAIN_PATH_TOL[cfg.param_dtype]
        check(plain_err <= tol, f"{arch}: kernel-path prefill logits "
              f"differ from the plain path by {plain_err} of the largest "
              f"logit (limit {tol})")
        check(cons is None or cons <= CONSISTENCY_TOL,
              f"{arch}: prefill + decode differs from prefill by {cons}")
        for kind, e in pos_errs.items():
            check(e <= tol, f"{arch}: {kind} prefill, kernel path against "
                  f"plain path: {e} of the largest logit")
        del params, plain, kernel_logits
        torch.cuda.empty_cache()
    launches["flash_attention_mma"] = narrow_serve_phase(seed)
    moe_f32_phase(seed)
    return launches


def narrow_serve_phase(seed: int = 0) -> int:
    """The narrow-head bf16 path: each ``NARROW_SERVE`` SMOKE config in
    bf16 (head dims 16 and 32) served through ``serve`` at batch 8 ×
    prompt 2048 + 32 tokens, counts set to 0 before and read after (one
    ``flash_attention_mma`` launch per attention layer, no other flash
    kernel), its prefill logits against the plain path's within 5e-2 of
    the largest logit.  Returns the kernel's launches over the runs."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import prefill

    counters = launch_counters()
    total = 0
    for arch in NARROW_SERVE:
        cfg = get_config(arch, smoke=True).with_(param_dtype="bfloat16",
                                                 activ_dtype="bfloat16")
        params, _ = _init(cfg, seed)
        prompts = _prompts(cfg, seed)
        for fn in counters.values():
            fn.launches = 0
        out = serve(cfg, params, prompts, LM_NEW, device="cuda")
        got = {name: counters[name].launches for name in LM_KERNELS}
        want = expected_launches(cfg)
        with plain_kernels():
            plain, _ = prefill(params, cfg, {"tokens": prompts})
        err = _rel_err(out.prefill_logits, plain)
        emit({"phase": "lm_narrow", "arch": cfg.name,
              "head_dim": cfg.resolved_head_dim, "dtype": cfg.activ_dtype,
              "layers": cfg.n_layers, "batch": LM_BATCH,
              "prompt": LM_PROMPT, "new_tokens": LM_NEW, "launches": got,
              "prefill_ms": out.prefill_s * 1e3,
              "decode_tokens_per_s": out.decode_tokens_per_s,
              "plain_path_rel_err": err})
        check(want["flash_attention_mma"] > 0 and got == want,
              f"{cfg.name} in bf16: LM kernels launched {got}, expected "
              f"{want}")
        check(tuple(out.tokens.shape) == (LM_BATCH, LM_NEW) and
              bool(((out.tokens >= 0) & (out.tokens < cfg.vocab_size))
                   .all()), f"{cfg.name}: malformed tokens")
        check(err <= PLAIN_PATH_TOL["bfloat16"], f"{cfg.name} in bf16: "
              f"kernel-path prefill logits differ from the plain path by "
              f"{err} of the largest logit")
        total += got["flash_attention_mma"]
        del params, out, plain
        torch.cuda.empty_cache()
    return total


def moe_f32_phase(seed: int = 0) -> dict:
    """The MoE check arch at full width and ``MOE_CHECK_LAYERS`` layers in
    f32 (the CUDA-core flash kernel's path): kernel path against plain
    path within 1e-4 of the largest logit, with the share of identical
    expert choices; then prefill + decode consistency with
    ``MOE_CONSISTENCY_CF`` capacity headroom."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import prefill

    counters = launch_counters()
    cfg = get_config(MOE_CHECK_ARCH).with_(
        n_layers=MOE_CHECK_LAYERS, param_dtype="float32",
        activ_dtype="float32")
    params, init_s = _init(cfg, seed)
    prompts = _prompts(cfg, seed)
    kernel_routes, plain_routes = [], []
    for fn in counters.values():
        fn.launches = 0
    with routed(record=kernel_routes):
        got, _ = _timed_prefill(params, cfg, {"tokens": prompts})
    launched = {name: counters[name].launches for name in LM_KERNELS}
    want = expected_launches(cfg)
    check(launched == want, f"{MOE_CHECK_ARCH} in f32: LM kernels "
          f"launched {launched} in one prefill, expected {want}")
    with plain_kernels(), routed(record=plain_routes):
        plain, _ = prefill(params, cfg, {"tokens": prompts})
    err = _rel_err(got, plain)
    headroom = cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CONSISTENCY_CF))
    cons = _consistency(headroom, params, prompts[:2], LM_PROMPT)
    emit({"phase": "lm_moe_f32", "arch": MOE_CHECK_ARCH,
          "layers": cfg.n_layers, "dtype": cfg.param_dtype,
          "batch": LM_BATCH, "prompt": LM_PROMPT, "init_s": init_s,
          "launches": launched, "plain_path_rel_err": err,
          "same_expert_choices": _same_choices(kernel_routes, plain_routes),
          "decode_consistency_rel_err": cons,
          "consistency_capacity_factor": MOE_CONSISTENCY_CF,
          "consistency_batch": 2})
    check(err <= PLAIN_PATH_TOL["float32"], f"{MOE_CHECK_ARCH} in f32: "
          f"kernel path against plain path: {err} of the largest logit")
    check(cons <= CONSISTENCY_TOL, f"{MOE_CHECK_ARCH} in f32: prefill + "
          f"decode differs from prefill by {cons}")
    del params, got, plain
    torch.cuda.empty_cache()


def _timed_prefill(params, cfg, batch):
    from repro_torch.models.transformer import prefill

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    return logits, (time.perf_counter() - t0) * 1e3


def _positions_prefill(cfg, params, prompts) -> tuple[dict, dict]:
    """Granite's prefill with explicit positions, kernel path against
    plain path (relative to the largest logit): a shifted batch at S =
    2048 (the index mask, as the JAX package's chunked branch masks) and
    a left-padded one at S = 2000 (the position mask).  Also the host
    clock of each warm prefill beside the same prompts' prefill with the
    default positions."""
    from repro_torch.models.transformer import prefill

    errs, ms = {}, {}
    for kind, s in (("shifted", LM_PROMPT), ("left_padded", 2000)):
        batch = {"tokens": prompts[:, :s],
                 "positions": prompt_positions(kind, prompts.shape[0], s,
                                               prompts.device)}
        got, _ = _timed_prefill(params, cfg, batch)
        _, ms[kind] = _timed_prefill(params, cfg, batch)
        _, ms[f"{kind}_default_positions"] = _timed_prefill(
            params, cfg, {"tokens": prompts[:, :s]})
        with plain_kernels():
            want, _ = prefill(params, cfg, batch)
        check(bool(torch.isfinite(got.float()).all()),
              f"{kind} prefill: non-finite logits")
        errs[kind] = _rel_err(got, want)
    return errs, ms


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


# ---------------------------------------------------------------------------
# phase 9: LM training on the card
# ---------------------------------------------------------------------------

#: the training runs: arch -> (layers cut to, or None for full depth;
#: batch; sequence; steps; the loss must fall)
LM_TRAIN = {"granite-3-2b": (None, 8, 2048, 10),
            "qwen2-moe-a2.7b": (2, 4, 2048, 3),
            "mamba2-130m": (None, 8, 2048, 5)}
LM_TRAIN_LR = 3e-4
#: the f32 card-against-CPU step: granite at full width, 2 layers
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 512
TRAIN_TOL = 1e-4
#: VARCO data-parallel training of granite-3-2b at full size, 8 × 2048:
#: (workers, steps) of each run under LM_VARCO_COMM
LM_VARCO_COMM = "varco:linear:5"
LM_VARCO_RUNS = ((1, 5), (4, 3))
#: its f32 card-against-CPU step: Q workers of one row each, the policy's
#: schedule over this many steps (step 1 still compresses: rate 64.5)
DP_CHECK_Q, DP_CHECK_TOTAL = 4, 10


def _train_run(cfg, batch: int, seq: int, steps: int, seed: int,
               comm: str | None = None, q: int = 1) -> dict:
    """``steps`` steps from random weights on ``TokenPipeline`` batches —
    of ``make_train_step``, or with ``comm`` of ``make_varco_dp_train_step``
    over ``q`` emulated workers (step key ``prng.key(i)``, as
    ``train_lm`` runs it): losses, host-clock step times that end in a
    sync (the loss read), peak memory, and the dp step's rate and
    ``grad_bits``."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import make_dp_mesh, make_varco_dp_train_step
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.nn.modules import param_count
    from repro_torch.train.data import TokenPipeline

    params, init_s = _init(cfg, seed)
    opt = make_optimizer(cfg, lr=LM_TRAIN_LR)
    state = opt.init(params)
    if comm is None:
        base = make_train_step(cfg, opt)

        def step(p, s, b, _i):
            return base(p, s, b)
    else:
        dp = make_varco_dp_train_step(cfg, opt,
                                      CommPolicy.parse(comm, steps),
                                      make_dp_mesh(q))

        def step(p, s, b, i):
            return dp(p, s, b, i, prng.key(i))
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses, aux, gnorm, ms, rate, bits = [], [], [], [], [], []
    for i in range(steps):
        b = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b, i)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(m["moe_aux"]))
        gnorm.append(float(m["grad_norm"]))
        if comm is not None:
            rate.append(float(m["rate"]))
            bits.append(float(m["grad_bits"]))
    rec = {"params": param_count(params), "init_s": init_s,
           "loss": losses, "moe_aux": aux, "grad_norm": gnorm,
           "step_ms": ms, "peak_mem_gb":
           torch.cuda.max_memory_allocated() / 1e9, "_params": params}
    if comm is not None:
        rec.update({"comm": comm, "workers": q, "rate": rate,
                    "grad_bits": bits})
    return rec


def _train_or_halve(cfg, batch, seq, steps, seed, **kw) -> dict:
    """:func:`_train_run` at ``batch``, and at half of it if the card runs
    out of memory (said in the record; width and depth are never cut)."""
    try:
        return {"batch": batch, "halved": False,
                **_train_run(cfg, batch, seq, steps, seed, **kw)}
    except torch.cuda.OutOfMemoryError:
        pass                 # retried outside: the traceback holds memory
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": batch // 2, "halved": True,
            **_train_run(cfg, batch // 2, seq, steps, seed, **kw)}


def _step_on(cfg, params, state, batch, device, i: int = 0,
             q: int | None = None):
    """One ``make_train_step`` step on ``device`` or, with ``q``, step
    ``i`` of ``make_varco_dp_train_step`` under ``LM_VARCO_COMM`` over
    ``q`` workers (key ``prng.key(i)``)."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import make_dp_mesh, make_varco_dp_train_step
    from repro_torch.launch.steps import make_optimizer, make_train_step

    opt = make_optimizer(cfg, lr=LM_TRAIN_LR)
    to = (lambda t: t.to(device))
    args = (_tree_to(params, to), _tree_to(state, to),
            {"tokens": batch.to(device)})
    if q is None:
        p, s, m = make_train_step(cfg, opt)(*args)
    else:
        p, s, m = make_varco_dp_train_step(
            cfg, opt, CommPolicy.parse(LM_VARCO_COMM, DP_CHECK_TOTAL),
            make_dp_mesh(q, device=device))(*args, i, prng.key(i))
    return p, s, {k: float(v) for k, v in m.items()}


def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    return tree if tree.device.type == "cpu" and tree.dim() == 0 and \
        tree.dtype == torch.int32 else fn(tree)


def _leaf_errs(got, want, moments=None) -> dict:
    """``got`` against ``want`` leaf by leaf: the parameters' largest
    ``‖got − want‖ / ‖want‖``, with ``moments = (got state, want state)``
    the AdamW moments' largest ``max |got − want| / max |want|``, and the
    five leaves of largest max-relative error (``want`` may live on
    another device)."""
    worst, param_l2, moment_max = [], 0.0, 0.0
    parts = [("params", got, want)]
    if moments is not None:
        parts += [(k, moments[0][k], moments[1][k]) for k in ("mu", "nu")]
    for part, a_tree, b_tree in parts:
        for (path, a), (_, b) in zip(_leaf_paths(a_tree, part),
                                     _leaf_paths(b_tree, part)):
            b = b.to(a.device).float()
            d = a.float() - b
            big = float(b.abs().max())
            rel_max = float(d.abs().max()) / max(big, 1e-30)
            worst.append((rel_max, path, big))
            if part == "params":
                param_l2 = max(param_l2, float(
                    d.norm() / b.norm().clamp(min=1e-30)))
            else:
                moment_max = max(moment_max, rel_max)
    worst.sort(reverse=True)
    return {"param_leaf_l2_rel_err": param_l2,
            "moment_leaf_max_rel_err": moment_max,
            "worst_leaves": [{"leaf": p_, "max_rel_err": e, "largest": m}
                             for e, p_, m in worst[:5]]}


def _card_vs_cpu(seed: int, q: int | None = None) -> dict:
    """granite at full width, ``TRAIN_CHECK_LAYERS`` layers, in f32: one
    step on the card from zero state (so the AdamW moments are populated),
    then one more step from that state on the card and on the CPU — of
    ``make_train_step``, or with ``q`` of the VARCO data-parallel step
    over ``q`` workers of one row each (the masks are the same Threefry
    draws on both devices, so ``grad_bits`` must be equal).

    The moments are held leaf by leaf at max |card − CPU| ≤ 1e-4 of the
    leaf's largest magnitude; the parameters at ‖card − CPU‖ ≤ 1e-4 ·
    ‖CPU‖ per leaf.  AdamW's ``m̂ / (√v̂ + eps)`` turns a gradient entry's
    sum-order error into a parameter difference of up to lr where the
    entry's gradients are near zero or cancel, and a zero-initialised
    norm scale is itself only ~2 lr large after two steps; the largest
    single differences are printed (``worst_leaves``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train.data import TokenPipeline

    cfg = get_config("granite-3-2b").with_(
        n_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
        activ_dtype="float32")
    params, _ = _init(cfg, seed)
    batch = TRAIN_CHECK_BATCH if q is None else q
    pipe = TokenPipeline(cfg.vocab_size, batch, TRAIN_CHECK_SEQ,
                         seed=seed + 1, device="cpu")
    p1, s1, _ = _step_on(cfg, params, make_optimizer(cfg).init(params),
                         next(pipe)["tokens"], "cuda", 0, q)
    b2 = next(pipe)["tokens"]
    pc, sc, mc = _step_on(cfg, p1, s1, b2, "cuda", 1, q)
    ph, sh, mh = _step_on(cfg, p1, s1, b2, "cpu", 1, q)
    dp = {} if q is None else {
        "workers": q, "comm": LM_VARCO_COMM, "rate": mc["rate"],
        "grad_bits_card": mc["grad_bits"], "grad_bits_cpu": mh["grad_bits"]}
    return {**dp, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
            "batch": batch, "seq": TRAIN_CHECK_SEQ,
            "loss_card": mc["loss"], "loss_cpu": mh["loss"],
            "loss_rel_err": abs(mc["loss"] - mh["loss"]) / abs(mh["loss"]),
            "grad_norm_card": mc["grad_norm"], "grad_norm_cpu":
            mh["grad_norm"], **_leaf_errs(pc, ph, (sc, sh))}


def _leaf_paths(tree, path: str):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def lm_train_phase(seed: int = 0) -> dict:
    """LM training on the card: granite-3-2b at full size (10 steps),
    qwen2-moe-a2.7b at full width and 2 layers (3 steps), mamba2-130m at
    full size (5 steps), launch counts set to 0 before and read after
    (training launches no LM kernel: neither has a backward); then
    granite's training forward against its serving prefill (tensor-core
    flash) on the trained weights; granite at full size under
    ``varco:linear:5`` through the data-parallel step with one worker (5
    steps) and four (3 steps), counts set to 0 before each and read after
    (``random_mask_bf16`` once a leaf, a worker and a step); and one f32
    step on the card against the CPU, of the plain step and of the dp
    step over four workers."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import _lm_head, forward_train, \
        prefill

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for arch, (layers, batch, seq, steps) in LM_TRAIN.items():
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_(n_layers=layers)
        r = _train_or_halve(cfg, batch, seq, steps, seed)
        params = r.pop("_params")
        warm = r["step_ms"][2:] or r["step_ms"]
        r.update({"layers": cfg.n_layers, "dtype": cfg.param_dtype,
                  "remat": cfg.remat, "moment_dtype": cfg.moment_dtype,
                  "seq": seq, "steps": steps,
                  **analytic_bound(cfg, r["batch"], seq, "train"),
                  "median_step_ms": float(np.median(warm)),
                  "tokens_per_s": r["batch"] * seq /
                  (float(np.median(warm)) / 1e3)})
        runs[arch] = r
        if arch == "granite-3-2b":
            trained, g_cfg = params, cfg
        else:
            del params
            torch.cuda.empty_cache()
    launches = {name: fn.launches for name, fn in counters.items()}

    prompts = _prompts(g_cfg, seed + 5)
    with torch.no_grad():
        h, _ = forward_train(trained, g_cfg, {"tokens": prompts})
        train_logits = _lm_head(trained, g_cfg, h[:, -1:])[:, 0]
        del h
        serve_logits, _ = prefill(trained, g_cfg, {"tokens": prompts})
    fwd_err = _rel_err(train_logits, serve_logits)
    del trained, train_logits, serve_logits
    torch.cuda.empty_cache()

    # VARCO data-parallel training: granite at full size through the
    # compressed gradient all-reduce (random_mask_bf16 once a leaf, a
    # worker and a step), counts set to 0 before each run
    from repro_torch.train.optim import tree_leaves

    varco, varco_launches = {}, {}
    for q, steps in LM_VARCO_RUNS:
        for fn in counters.values():
            fn.launches = 0
        r = _train_or_halve(g_cfg, LM_TRAIN["granite-3-2b"][1],
                            LM_TRAIN["granite-3-2b"][2], steps, seed,
                            comm=LM_VARCO_COMM, q=q)
        n_leaves = len(tree_leaves(r.pop("_params")))
        torch.cuda.empty_cache()
        warm = r["step_ms"][2:] or r["step_ms"]
        r.update({"steps": steps, "median_step_ms": float(np.median(warm)),
                  "expected_mask_launches": n_leaves * q * steps,
                  **analytic_bound(g_cfg, r["batch"],
                                   LM_TRAIN["granite-3-2b"][2], "train")})
        varco[f"q{q}"] = r
        varco_launches[f"q{q}"] = {name: fn.launches
                                   for name, fn in counters.items()}
    cpu_check = _card_vs_cpu(seed)
    torch.cuda.empty_cache()
    dp_check = _card_vs_cpu(seed, DP_CHECK_Q)
    torch.cuda.empty_cache()

    rec = {"phase": "lm_train", "lr": LM_TRAIN_LR, "runs": runs,
           "launches": launches,
           "train_vs_prefill_rel_err": fwd_err,
           "train_vs_prefill_batch": LM_BATCH, "card_vs_cpu": cpu_check,
           "varco": varco, "varco_launches": varco_launches,
           "varco_vs_full_step_ms": {
               k: v["median_step_ms"] / runs["granite-3-2b"][
                   "median_step_ms"] for k, v in varco.items()},
           "dp_card_vs_cpu": dp_check}
    emit(rec)
    for arch, r in runs.items():
        check(all(np.isfinite(r["loss"])), f"{arch}: non-finite loss "
              f"{r['loss']}")
    for arch in ("granite-3-2b", "mamba2-130m"):
        ls = runs[arch]["loss"]
        check(np.mean(ls[-3:]) < ls[0], f"{arch}: the loss did not fall "
              f"({ls})")
    check(all(a > 0 for a in runs["qwen2-moe-a2.7b"]["moe_aux"]),
          "qwen2-moe: the MoE aux loss is not positive")
    check(all(launches[k] == 0 for k in LM_KERNELS), f"the training path "
          f"launched LM kernels: {launches}")
    check(fwd_err <= PLAIN_PATH_TOL["bfloat16"], f"granite: the training "
          f"forward's logits differ from prefill's by {fwd_err} of the "
          f"largest")
    for chk in (cpu_check, dp_check):
        check(chk["loss_rel_err"] <= TRAIN_TOL and
              chk["param_leaf_l2_rel_err"] <= TRAIN_TOL and
              chk["moment_leaf_max_rel_err"] <= TRAIN_TOL,
              f"the f32 step on the card differs from the CPU's: {chk}")
    check(dp_check["grad_bits_card"] == dp_check["grad_bits_cpu"] > 0,
          f"the dp step's grad_bits differ card vs CPU: {dp_check}")
    for k, r in varco.items():
        n = varco_launches[k]
        check(all(np.isfinite(r["loss"])), f"varco {k}: non-finite loss "
              f"{r['loss']}")
        check(r["rate"][0] == 128.0, f"varco {k}: step 0 rate {r['rate']}")
        check(n["random_mask_bf16"] == n["random_mask"] ==
              r["expected_mask_launches"], f"varco {k}: random_mask "
              f"launched {n['random_mask']} times ({n['random_mask_bf16']} "
              f"bf16), not {r['expected_mask_launches']}")
        check(all(n[name] == 0 for name in LM_KERNELS),
              f"varco {k} launched LM kernels: {n}")
        check(all((b > 0) == (r["workers"] > 1) for b in r["grad_bits"]),
              f"varco {k}: grad_bits {r['grad_bits']}")
    return rec


# ---------------------------------------------------------------------------
# phase 10: VARCO data-parallel LM training on the worker group
# ---------------------------------------------------------------------------

#: granite-3-2b at full width cut to LM_DP_LAYERS layers, global batch
#: LM_DP_BATCH × LM_DP_SEQ (two rows a worker), LM_DP_STEPS steps of each
#: policy, LM_DP_Q processes.  The functional AdamW update holds the old
#: and the new f32 moments, the gradients, their clipped copy, f32
#: updates and the new weights at once, so at 11 layers a process peaks
#: at 18.58 GB allocated and 19.7-20.9 GB reserved, and four of them left
#: 1.83 GB of an H100 80GB HBM3's 85.0 GB free after a step: too little
#: to count on from run to run.  Hence 10 layers.
LM_DP_Q, LM_DP_LAYERS, LM_DP_BATCH, LM_DP_SEQ = 4, 10, 8, 2048
LM_DP_STEPS = 3
LM_DP_COMMS = {"varco": "varco:linear:5", "full": "full"}
LM_DP_TOL = 1e-4
LM_DP_TIMEOUT = 900.0


def _lm_dp_cfg():
    from repro_torch.configs.base import get_config

    return get_config("granite-3-2b").with_(n_layers=LM_DP_LAYERS)


def _dp_f32_cfg():
    from repro_torch.configs.base import get_config

    return get_config("granite-3-2b").with_(
        n_layers=TRAIN_CHECK_LAYERS, param_dtype="float32",
        activ_dtype="float32")


def _bits_checksum(tree) -> list:
    """Per leaf, a weighted sum of its bits as 64-bit integers (the leaf
    viewed as int16 / int32 words, each times ``position % 65521 + 1``,
    wrapping): equal leaves give equal sums.  The ranks compare these
    where moving every replica's leaves would cost seconds a step."""
    from repro_torch.train.optim import tree_leaves

    words = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for t in tree_leaves(tree):
        flat = t.detach().reshape(-1).view(words[t.element_size()])
        total = 0
        for i in range(0, flat.numel(), 1 << 24):
            w = flat[i:i + (1 << 24)].to(torch.int64)
            pos = torch.arange(i, i + w.numel(), device=w.device) % 65521
            total += int((w * (pos + 1)).sum())
        out.append(total)
    return out


def _dp_steps(cfg, comm: str, mesh, steps: int, batch: int, seq: int,
              seed: int, total: int | None = None) -> dict:
    """``steps`` steps of ``make_varco_dp_train_step`` under ``comm`` over
    ``mesh`` (this worker's ``WorkerMesh``, or a ``DPMesh`` emulated on the
    card) from ``_init(cfg, seed)`` on ``TokenPipeline`` batches (step key
    ``prng.key(i)``; the policy's schedule over ``total`` steps, default
    ``steps``): losses, rates, ``grad_bits``, host ms a step ending in the
    loss read, each step's checksums of the parameters and optimiser
    state, the peak allocated and reserved, the card's free memory after
    the last step (every process's use counted); the final trees under
    ``_params`` / ``_state``."""
    from repro_torch import prng
    from repro_torch.core.varco import CommPolicy
    from repro_torch.dist import make_varco_dp_train_step
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train.data import TokenPipeline

    params, _ = _init(cfg, seed)
    opt = make_optimizer(cfg, lr=LM_TRAIN_LR)
    state = opt.init(params)
    step = make_varco_dp_train_step(
        cfg, opt, CommPolicy.parse(comm, total or steps), mesh)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=seed,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    rec = {k: [] for k in ("loss", "ce", "rate", "grad_bits", "step_ms",
                           "checksums")}
    for i in range(steps):
        b = next(pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b, i, prng.key(i))
        rec["loss"].append(float(m["loss"]))
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for k in ("ce", "rate", "grad_bits"):
            rec[k].append(float(m[k]))
        rec["checksums"].append(_bits_checksum({"p": params, "s": state}))
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    rec["card_free_gb"] = torch.cuda.mem_get_info()[0] / 1e9
    rec["_params"], rec["_state"] = params, state
    return rec


def _lm_dp_worker(mesh, seed: int, ref_dir: str):
    """One worker of the lm_dp phase: each policy of ``LM_DP_COMMS``
    through the group's dp step, then the f32 2-layer steps 0 and 1; rank
    0 holds its final trees against the emulated run's files in
    ``ref_dir``.  Every rank's records, gathered to rank 0."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = launch_counters()
    cfg = _lm_dp_cfg()
    runs = {}
    for name, comm in LM_DP_COMMS.items():
        for fn in counters.values():
            fn.launches = 0
        mesh.sent_bytes = mesh.staged_bytes = 0
        mesh.comm_s = 0.0
        try:
            r = _dp_steps(cfg, comm, mesh, LM_DP_STEPS, LM_DP_BATCH,
                          LM_DP_SEQ, seed)
        except torch.cuda.OutOfMemoryError as err:
            raise RuntimeError(
                f"lm_dp: worker {mesh.rank} ran out of memory training "
                f"granite-3-2b at {cfg.n_layers} layers, batch "
                f"{LM_DP_BATCH // LM_DP_Q} x {LM_DP_SEQ} a worker, with "
                f"{LM_DP_Q} processes on the card") from err
        params = r.pop("_params")
        del r["_state"]              # held, it would weigh on the next run
        r.update({"sent_bytes_per_step": mesh.sent_bytes / LM_DP_STEPS,
                  "staged_bytes_per_step": mesh.staged_bytes / LM_DP_STEPS,
                  "comm_s_per_step": mesh.comm_s / LM_DP_STEPS,
                  "launches": {k: fn.launches
                               for k, fn in counters.items()}})
        if mesh.rank == 0:
            r.update(_leaf_errs(params, torch.load(
                Path(ref_dir) / f"{name}.pt", map_location=mesh.device)))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        runs[name] = r
    for fn in counters.values():
        fn.launches = 0
    f32 = _dp_steps(_dp_f32_cfg(), LM_VARCO_COMM, mesh, 2, DP_CHECK_Q,
                    TRAIN_CHECK_SEQ, seed, total=DP_CHECK_TOTAL)
    got_p, got_s = f32.pop("_params"), f32.pop("_state")
    if mesh.rank == 0:
        ref = torch.load(Path(ref_dir) / "f32.pt", map_location=mesh.device)
        f32.update(_leaf_errs(got_p, ref["params"],
                              (got_s, ref["state"])))
    f32["launches"] = {k: fn.launches for k, fn in counters.items()}
    del got_p, got_s
    every = [None] * mesh.q
    dist.all_gather_object(every, {"runs": runs, "f32": f32,
                                   "device": str(mesh.device)})
    return every if mesh.rank == 0 else None


def lm_dp_phase(work: str, seed: int = 0) -> int:
    """VARCO data-parallel LM training over ``LM_DP_Q`` worker processes
    on the card (``gloo``: NCCL refuses two ranks on one card), against
    the emulated ``DPMesh(LM_DP_Q)`` on the same card: granite-3-2b at
    full width and ``LM_DP_LAYERS`` layers, batch 8 × 2048, ``LM_DP_STEPS``
    steps of ``varco:linear:5`` and of ``full``; then the f32 2-layer
    check's steps 0 and 1 through the group against the emulated step.
    Returns the workers' ``random_mask_bf16`` launches under
    ``varco:linear:5`` (counts set to 0 in every worker before each run
    and read after)."""
    from repro_torch.dist import make_dp_mesh
    from repro_torch.dist.gnn_parallel import spawn_workers
    from repro_torch.train.optim import tree_leaves, tree_map

    cfg = _lm_dp_cfg()
    ref = Path(work) / "lm_dp_ref"
    ref.mkdir()
    on_cpu = (lambda tree: tree_map(lambda t: t.cpu(), tree))
    emulated = {}
    for name, comm in LM_DP_COMMS.items():
        try:
            r = _dp_steps(cfg, comm, make_dp_mesh(LM_DP_Q), LM_DP_STEPS,
                          LM_DP_BATCH, LM_DP_SEQ, seed)
        except torch.cuda.OutOfMemoryError as err:
            raise RuntimeError(
                f"lm_dp: the emulated run ran out of memory at "
                f"{cfg.n_layers} layers") from err
        n_leaves = len(tree_leaves(r["_params"]))
        torch.save(on_cpu(r.pop("_params")), ref / f"{name}.pt")
        del r["_state"]
        emulated[name] = r
        gc.collect()
        torch.cuda.empty_cache()
    f32 = _dp_steps(_dp_f32_cfg(), LM_VARCO_COMM, make_dp_mesh(DP_CHECK_Q),
                    2, DP_CHECK_Q, TRAIN_CHECK_SEQ, seed,
                    total=DP_CHECK_TOTAL)
    torch.save({"params": on_cpu(f32.pop("_params")),
                "state": on_cpu(f32.pop("_state"))}, ref / "f32.pt")
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 1e9
    # the workers' allocator grows segments in place: four processes share
    # the card, and each one's fragments would be the others' headroom
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t = time.perf_counter()
    try:
        ranks = spawn_workers(_lm_dp_worker, LM_DP_Q, seed, str(ref),
                              device="cuda", backend="gloo",
                              timeout=LM_DP_TIMEOUT)
    finally:
        if prev is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    wall = time.perf_counter() - t
    g0 = ranks[0]
    runs = {}
    for name in LM_DP_COMMS:
        mine, emu = g0["runs"][name], emulated[name]
        per = [rk["runs"][name] for rk in ranks]
        runs[name] = {
            "loss": mine["loss"], "emulated_loss": emu["loss"],
            "loss_max_rel": max(abs(a - b) / abs(b) for a, b in
                                zip(mine["loss"], emu["loss"])),
            "rate": mine["rate"], "grad_bits": mine["grad_bits"],
            "emulated_grad_bits": emu["grad_bits"],
            "replicas_equal": [len({str(rk["checksums"][i]) for rk in per})
                               == 1 for i in range(LM_DP_STEPS)],
            "step_ms_median": _median_ms([x / 1e3 for x in mine["step_ms"]]),
            "emulated_step_ms_median": _median_ms(
                [x / 1e3 for x in emu["step_ms"]]),
            "sent_mb_per_step": [rk["sent_bytes_per_step"] / 1e6
                                 for rk in per],
            "staged_mb_per_step": [rk["staged_bytes_per_step"] / 1e6
                                   for rk in per],
            "comm_s_per_step": [rk["comm_s_per_step"] for rk in per],
            "peak_mem_gb": [rk["peak_mem_gb"] for rk in per],
            "peak_reserved_gb": [rk["peak_reserved_gb"] for rk in per],
            "card_free_gb": [rk["card_free_gb"] for rk in per],
            "emulated_peak_mem_gb": emu["peak_mem_gb"],
            "param_leaf_l2_rel_err": mine["param_leaf_l2_rel_err"],
            "worst_leaves": mine["worst_leaves"],
            "launches": {k: sum(rk["launches"][k] for rk in per)
                         for k in mine["launches"]}}
    gf = g0["f32"]
    f32_rec = {"loss": gf["loss"][-1], "emulated_loss": f32["loss"][-1],
               "loss_rel_err": abs(gf["loss"][-1] - f32["loss"][-1]) /
               abs(f32["loss"][-1]),
               "grad_bits": gf["grad_bits"][-1],
               "emulated_grad_bits": f32["grad_bits"][-1],
               "rate": gf["rate"][-1],
               "replicas_equal": len({str(rk["f32"]["checksums"][-1])
                                      for rk in ranks}) == 1,
               **{k: gf[k] for k in ("param_leaf_l2_rel_err",
                                     "moment_leaf_max_rel_err",
                                     "worst_leaves")}}
    rec = {"phase": "lm_dp", "arch": "granite-3-2b", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.param_dtype,
           "remat": cfg.remat, "moment_dtype": cfg.moment_dtype,
           "workers": LM_DP_Q, "backend": "gloo", "cards": 1,
           "devices": [rk["device"] for rk in ranks],
           "batch": LM_DP_BATCH, "seq": LM_DP_SEQ, "steps": LM_DP_STEPS,
           "n_leaves": n_leaves, "wall_s": wall,
           "card_gb": torch.cuda.mem_get_info()[1] / 1e9,
           "parent_reserved_gb": parent_gb, "runs": runs,
           "f32_check": f32_rec}
    emit(rec)
    print("NCCL unverified: 1 card (the lm_dp group ran over gloo)",
          flush=True)
    for name, r in runs.items():
        check(all(np.isfinite(r["loss"])), f"lm_dp {name}: non-finite "
              f"loss {r['loss']}")
        check(r["grad_bits"] == r["emulated_grad_bits"],
              f"lm_dp {name}: grad_bits {r['grad_bits']} against the "
              f"emulated {r['emulated_grad_bits']}")
        check(all(r["replicas_equal"]), f"lm_dp {name}: the ranks' "
              f"parameters differ: {r['replicas_equal']}")
        check(r["loss_max_rel"] <= LM_DP_TOL, f"lm_dp {name}: losses "
              f"{r['loss']} against the emulated {r['emulated_loss']}")
        check(r["param_leaf_l2_rel_err"] <= LM_DP_TOL, f"lm_dp {name}: "
              f"parameters off the emulated run's: {r['worst_leaves']}")
        n = r["launches"]
        want = n_leaves * LM_DP_Q * LM_DP_STEPS if name == "varco" else 0
        check(n["random_mask_bf16"] == n["random_mask"] == want,
              f"lm_dp {name}: random_mask launched {n['random_mask']} "
              f"times ({n['random_mask_bf16']} bf16), not {want}")
        check(all(n[k] == 0 for k in LM_KERNELS), f"lm_dp {name} "
              f"launched LM kernels: {n}")
    check(runs["varco"]["rate"][0] == 128.0,
          f"lm_dp varco: step 0 rate {runs['varco']['rate']}")
    check(all(b > 0 for b in runs["full"]["grad_bits"]),
          f"lm_dp full: grad_bits {runs['full']['grad_bits']}")
    check(f32_rec["loss_rel_err"] <= TRAIN_TOL and
          f32_rec["param_leaf_l2_rel_err"] <= TRAIN_TOL and
          f32_rec["moment_leaf_max_rel_err"] <= TRAIN_TOL and
          f32_rec["replicas_equal"],
          f"lm_dp: the f32 group step differs from the emulated one: "
          f"{f32_rec}")
    check(f32_rec["grad_bits"] == f32_rec["emulated_grad_bits"] > 0,
          f"lm_dp: the f32 group step's grad_bits {f32_rec}")
    return runs["varco"]["launches"]["random_mask_bf16"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=169_343,
                    help="graph size (default: OGBN-Arxiv's node count)")
    ap.add_argument("--lm-only", action="store_true",
                    help="only the device, build, lm_kernels, lm, "
                         "lm_train and lm_dp phases (a partial run: no "
                         "summary or result line)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        return run(args, work)


def run(args, work) -> int:
    """Every phase in order (files under ``work``); 0 on success."""
    try:
        card = device_phase()
        build_phase()
        if args.lm_only:
            lm_kernels_phase()
            lm_phase()
            lm_train_phase()
            lm_dp_phase(work)
            print("lm-only run: every LM check passed", flush=True)
            return 0
        g, cfg, params, eng = setup_phase(args.nodes, "cuda")
        main_recs = kernels_phase(eng)
        serving = slice_phase(g, cfg, params, eng)
        launches, runs = train_phase(g, cfg, params, eng)
        # the rint codec's user path on the card is serving: train_gnn
        # rounds stochastically there
        launches["varco_pack_quant"] = serving["varco_pack_quant"]
        for name, n in auto_phase(eng, params, cfg).items():
            launches[name] += n          # train_gnn's + the auto phase's
        r2 = resilience_phase(g, cfg, params, eng, runs["varco"], work)
        del runs
        dist_launches, dist_errs = dist_phase(g, cfg, params, eng,
                                              Path(work) / "shards", r2)
        del r2
        for name, n in dist_launches.items():
            launches[name] += n          # the worker processes' launches
            main_recs[name]["max_abs_err"] = max(
                main_recs[name]["max_abs_err"], dist_errs[name])
        for name, n in update_phase(g, cfg, params, eng).items():
            launches[name] += n          # stochastic serving's launches
        del eng
        torch.cuda.empty_cache()
        main_recs.update(lm_kernels_phase())
        launches.update(lm_phase())
        # the granite-3-2b one-worker VARCO run's bf16 mask launches
        launches["random_mask_bf16"] = lm_train_phase()["varco_launches"][
            "q1"]["random_mask_bf16"]
        # the lm_dp group's bf16 mask launches, summed over its workers
        launches["random_mask_bf16"] += lm_dp_phase(work)
    except Failure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:                      # any phase's crash fails the run
        traceback.print_exc()
        return 1
    kernels = []
    for name, meta in KERNELS.items():
        r = main_recs[name]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

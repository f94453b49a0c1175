#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100; check it.

    python3 chip_smoke.py

Phases:

1. Header and build: the card's name and power limit as ``nvidia-smi`` gives
   them, then the build of ``src/repro_torch/csrc`` (nvcc, sm_90a) and its
   time, the registers and spills ``nvcc -Xptxas -v`` gave each instance of
   the flash-attention (wgmma), RMSNorm, tensor-core SSD (``ssd_scan``,
   ``local_ssd``), reduce/scan (``piece_totals``, ``piece_scan`` and the
   combine passes) and weighted-scan (``wscan_pass``, ``wscan_fold``,
   ``wscan_carry``) kernels, and flash attention's dynamic shared memory
   per block.
2. Main path, four runs, each with every kernel's launch count set to 0
   just before it and read just after: the public ops (``repro_torch.ops``)
   at 2^24 elements and at the models' shapes, on the linear kernels and
   on the log-depth family (``policy="tile_logdepth"``), where every kernel
   must run, with the linear reduce, scan and weighted scan of 16 rows of
   2^20 held against ``policy="baseline"`` and a mixed-dtype SSD (bf16 x,
   f32 b, c) returning y in bf16 on both families; then the engine of
   ``repro_torch.launch.serve`` serving mamba2-1.3b FULL (48 layers),
   llama3.2-1b FULL (16 layers), and mamba2-1.3b at 8 of its 48 layers
   (``MAMBA_CUT_LAYERS``) under ``policy="ssd=tile_logdepth"``, random
   weights from seed 0, to four
   requests of up to 512 prompt tokens, 16 new
   tokens each; then the MoE family at its published widths with its
   depth cut to fit the card (``CUTS``): qwen3-moe-235b-a22b at 4 of
   94 layers (11.20 B parameters) and grok-1-314b at 2 of 64 (11.45 B);
   then the hybrid zamba2-2.7b cut to 12 of 54 Mamba-2 layers (``CUTS``;
   the shared attention block after every 6th); then the last dense
   configs: internlm2-20b cut to 24 of 48 layers (``CUTS``), deepseek-67b
   at its published widths cut to 4 of 95 layers (``CUTS``, 4.45 B) and
   h2o-danube-3-4b whole (24 layers, head dim 120, a sliding window of
   4096 that the served prompts stay inside). Each serve run must show the
   launches ``forward_launches`` gives its family: its layer kernel once
   per layer per prefill (48 SSD, 16 flash-attention, 8 local SSD
   launches, and no linear SSD launch in the log-depth run; zamba2 12 SSD
   and 2 flash attention, one a use of the shared block), every SSD launch
   on the tensor-core instance of the chunk body (the served type is
   bf16), 2 x layers + 2 x shared-block uses + 1 RMSNorm launches per
   forward (97, 33, 127; internlm2 97, deepseek 9, danube 49), and for MoE
   one ``tcu_scan`` launch (the capacity offsets) per MoE layer per
   forward.
   Each prefill's last-token logits, and the logits of two decode steps
   from its cache, are held against the same model on the kernels' plain
   versions (a model whose f32 copy passes ``F32_GATE_BYTES``, as the MoE
   cuts and internlm2: its first ``PARITY_LAYERS`` layers, the served model
   freed before their f32 copy; the tokens whose top-k experts differ
   between the two paths are printed), and its
   device time is split by kind of kernel with ``torch.profiler``, and the
   "other" kernels' time by the op that launched them, from a Chrome trace
   of ``repro_torch.obs.profiling.tracing`` (the ten largest); 15
   decode steps on the host clock against their device time give the
   card's idle share. These three runs use the wave scheduler.
   Before the serve runs, the ragged ops (``ops.ragged_reduce``,
   ``ops.ragged_scan``: one-hot matmuls, no kernel in the reference) under
   ``tile`` against ``baseline`` at the MoE router's (32, 936) ids in
   [0, 128) and on 65536 ids in 128 sorted segments: counts and ranks
   equal, the counts' exclusive scan on ``tcu_scan.cu`` equal to
   ``torch.cumsum``'s bit for bit, and ``guard_contiguous`` inside a CUDA
   graph's capture (NaN for unsorted ids, no host read).
   Then the continuous scheduler (the default): mamba2-1.3b FULL,
   llama3.2-1b FULL, qwen3-moe (4 layers), zamba2-2.7b FULL and
   h2o-danube-3-4b FULL (its ring 1024 rows a slot, inside its window), 8
   requests
   of up to 512 prompt tokens and 16 new
   tokens each on 4 slots, chunks of 16, every tick one block step
   replayed from a CUDA graph. A warm-up request of the same capacity
   bucket captures both graphs (T = 16 and T = 1); the measured run must
   capture none, admit and finish 8 requests with at least 4 slot
   refills, give every request tokens, and count a forward's RMSNorm
   launches a tick (2 x layers + 1, zamba2 127), and for MoE L
   ``tcu_scan`` (a replay adds what its capture counted). One T = 16
   and one T = 1 tick from the graph are held against the eager step on a
   clone of the cache (the same argmax for every active slot);
   ``torch.profiler`` over a replayed tick must show the RMSNorm kernel as
   many times (97, 33, 127, 49; the largest count of three profiled ticks,
   as the profiler may drop a record) and splits its device time by kind. In
   f32, each request's first-token logits are held against its
   ``prefill_last`` alone (B = 1, on the kernels) and the engine on the
   kernels against the same engine on the plain versions, both within
   1e-3 of the largest logit (MoE: at its first ``PARITY_LAYERS`` layers,
   ``gate_depth``).
   Printed: tok/s, TTFT, ticks by T, host ms a tick, device ms a tick by
   kind, the idle share of the T = 1 ticks, the capture time, peak memory,
   a T = 1 tick alone, graphed and eager, and the parameter bytes a tick
   reads over the card's memory rate.
   Then the paged KV pool (``cache_kind="paged"``, pages of 16 rows, 64 a
   slot at capacity 1024; h2o-danube's window rounds to 4096 rows, above
   that), FULL, bf16, 4 slots, chunks of 16: the five
   models serve the continuous runs' 8 requests, whose tokens must equal those
   ring runs', with no capture in the measured run and a forward's RMSNorm
   kernels a replayed tick; the largest logit difference from the
   ring run over all ticks is printed, and on each KV pool the
   copy-on-write copy of a tick is timed in the reference's form (the whole
   pool gathered) and the port's (the copied pages only). llama3.2-1b
   serves 8 requests that share a 392-token prefix under the ring and the
   paged cache (the paged run must share prompt tokens and copy pages on
   write). mamba2-1.3b at 8 of its 48 layers (``MAMBA_CUT_LAYERS``)
   serves four first turns and their second turns (each
   the first and 32 tokens more) under both caches: the paged run must
   share exactly the first turns whose snapshot landed before their second
   turn's admission. Both runs are served again in f32, where the paged
   tokens must equal the ring's (in bf16 a token depends on the tick
   schedule, which the paged cache changes; the bf16 agreement is
   printed). llama3.2-1b samples with
   ``greedy=False``: seed 7 twice gives the same tokens, seed 8 others, and
   2^16 draws over 16 classes lie within a total variation of 0.02 of
   their softmax. Printed for both caches: tok/s, TTFT, ticks, host ms a
   tick by T, device ms a replayed tick by T and kind, peak pages.
   Then observability (``repro_torch.obs``): llama3.2-1b serves the
   shared-prefix requests on the paged cache through
   ``repro_torch.launch.serve.main`` three times, with obs off, with
   ``--obs-events --metrics-out``, and with those and ``--profile-dir``
   (traces under ``build/obs/``). The three runs must give the same tokens
   and launch counts; each run with obs on must show one admit and one
   finish event per request, TTFT observed once per request,
   ``repro_serving_tokens_total`` equal to the tokens returned, the four
   tick phases summing to the ticks within 1e-6 s a tick, as many ``kv_cow``
   events as CoW copies, the peak-pages gauge at the pool's peak, and a
   resolution and a ``kernel_invoke`` event of RMSNorm on ``tile_gpu``; the
   trace must hold one ``serving/block_step`` range a tick and RMSNorm
   kernel records. Printed: the T = 1 tick's host ms in each of the three
   runs, beside the card's name and power limit.
   Then h2o-danube-3-4b whole on one prompt of 6144 tokens, past its
   window of 4096 (``window_pass``): ``prefill_last`` (flash attention at
   L = 6144, D = 120, with the window), the ring of 4096 rows it leaves,
   then 15 decode steps on that ring, launches gated, the prefill timed
   on the kernels and the plain versions; in f32 at ``PARITY_LAYERS``
   layers each step's logits within 1e-3 of the largest of the
   teacher-forced forward over the longer sequence.
   Then the models whose prefill takes a frontend's output
   (``FRONTENDS``), driven through ``prefill_last`` and ``decode`` as the
   wave scheduler cannot (it has no stub or frames to pass):
   internvl2-76b at its published widths cut to 4 of 80 layers (5.55 B
   parameters) behind a random stub prefix of 256 x 3200, and the
   encoder-decoder seamless-m4t-medium whole (12 + 12 layers, 0.98 B) on
   random frames of 4 x 512 x 1024: ``prefill_last`` on the wave's 4
   prompts, the cache grown by 15 rows, then 15 greedy decode steps, with
   the launches of ``forward_launches`` (internvl2: RMSNorm 9 and flash
   attention 4 a prefill, RMSNorm 9 a step; seamless: RMSNorm 62 and flash
   attention 36 a prefill, 12 of them the encoder's and 12 the
   cross-attention's, both without a causal mask, and RMSNorm 37 a step),
   finite logits, the prefill timed on the kernels and the plain versions
   and a decode step on the host clock; then, the bf16 model freed, the
   f32 logits of the prefill and two decode steps (internvl2 at
   ``PARITY_LAYERS`` layers, seamless whole), kernels against plain
   versions within 1e-3 of the largest logit.
   Then training (``repro_torch.training``, outside inference mode):
   mamba2-1.3b and llama3.2-1b FULL, zamba2-2.7b at its full widths cut
   to 12 of 54 layers (``TRAIN_LAYERS``: two uses of the shared block,
   0.77 B parameters) and seamless-m4t-medium whole (zero frames of 4 x
   512 beside the tokens, as the reference's train CLI feeds), bf16
   compute, f32 master weights,
   AdamW at the reference's ``OptConfig`` defaults, remat ``none``, batches
   of 4 x 512 from ``SyntheticLMPipeline(seed=0)``. 8 steps on one fixed
   batch (every loss finite, the last below the first), then 6 timed steps
   on the pipeline's batches (prefetch thread), each run with its launch
   counts from 0 and gated per step (``train_launches``): RMSNorm 2L + 2G
   + 1 forward and 2L again in the recompute of each layer (the shared
   block is not recomputed; seamless 2 (2E + 3D) + 2), flash attention
   (llama; seamless's three kinds) or the SSD (mamba, zamba2; every launch
   on the tensor-core instance) twice a layer, and
   flash attention once a use of zamba2's shared block, ``tcu_reduce``
   once per parameter leaf (the global norm), no other kernel. Printed:
   step host ms (median, range; synchronised), tok/s, one step's device ms
   by kind from ``torch.profiler`` and the idle share, peak GB, and the
   global norm's ``tcu_reduce`` over the real leaves against ``torch.sum``.
   In f32 at 2 layers (zamba2: 6, one group; seamless 2 + 2, on random
   frames; full width): one step on the kernels against the
   same step under ``policy="baseline"`` (loss rtol 1e-4, grad_norm rtol
   1e-3, gradients and params per leaf against the leaf's largest; see
   ``update_gate``), then the state checkpointed and restored bit for bit
   and a step from it against one from the state in memory.
   After the wave runs, the kernel policy (``repro_torch.core.policy``,
   ``.autotune``; the served runs above already run under its default,
   ``auto``, which on the card resolves every op to ``tile_gpu`` by the
   heuristic): for each op the default resolution and its one kernel
   launch, ``interpret`` (the plain version, no launch) and ``tile_tpu``
   (raises); ``backend="cpu"``, ``xla_tile``'s reduce against ``baseline``,
   ``REPRO_KERNEL_PATH=fused`` and ``REPRO_AUTOTUNE=off`` through
   ``default_policy()``; the host us of one memoised ``resolve``; the SSD
   under ``"tile,ssd.q=32"`` at the served shape on the tensor-core
   instance against its plain version, timed beside q = 64; every
   log-depth candidate spec of the sweep under ``tile_logdepth`` against
   the plain version, its ``kernel_invoke`` spec the geometry that ran;
   ``attention.block_q`` warned once and left out of the spec. Then the
   autotune table measured on the card over the reference's grid (bands
   4-13, f32 and bf16), written to ``chiprun_out/autotune_gpu.json`` over
   the checked-in ``cpu`` section, checked by ``check_default``, printed by
   op with its crossovers; qwen3-moe (4 layers) served on the wave under
   that table (the resolutions it moved off ``tile_gpu``; tokens equal to
   the default wave run's; f32 prefill logits at ``PARITY_LAYERS`` layers
   within 1e-3 of the default policy's); mamba2-1.3b whole on the wave
   under ``ModelConfig(policy="tile,ssd.q=32")`` (48 SSD launches a
   prefill at q = 32, all on the tensor cores; the prefill's SSD device ms
   beside the default's; f32 logits at 2 layers within 1e-3 of the plain
   path); the host time that resolving adds to a wave decode step (its
   resolutions times one memoised resolve) within 5% of the step, and the
   step under the default policy beside the step under ``"tile"``, in
   turns (their ratio printed with its quartiles).
   After training, the multi-device layer (``repro_torch.parallel``,
   ``distributed_pass``): a world of 4 ranks on this one card, each rank a
   process of this script (``--dist-worker``) joined by a gloo ``file://``
   init (NCCL refuses two ranks on one device, so every collective is
   staged through host memory and NCCL is not exercised). Each rank makes
   the inputs from seed 0, takes its shard as a ``DTensor`` and calls
   ``repro_torch.ops`` under ``make_context("data=4")``: the reduce of
   llama3.2-1b's tied embedding (1 x 262,668,288 f32), the scan and the
   weighted scan of 16 x 2^20 f32 (log-decays in (-1, 0]), and
   mamba2-1.3b's SSD sequence-sharded (bf16 B=1 L=65,536 H=64 P=64 N=128,
   and f32 at L=8192), each shard on its Hopper kernel, then GPipe over a
   ``stage`` mesh (4 stages x 8 microbatches of 4 x 512 rows, the block
   ``x + W2 silu(W1 rmsnorm(x))`` at d 2048, the RMSNorm on its kernel).
   Gated: each sharded result's largest error against the f64 plain
   result of the whole input at most twice the unsharded kernel's own
   (rank 0 runs each op unsharded; floored at one f32 ulp of the result),
   the f32 SSD's y and state within 2e-3 of the unsharded op, the pipeline
   within 1e-5 of the sequential run, every rank's launches (the per-shard
   kernel of each op, the SSD on the mma instance, one RMSNorm a tick) and
   4 routed calls a rank. Printed: the backend, each op's wall ms a rank
   split into local kernel, collectives and carry injection, the
   unsharded op's ms, the errors; the ranks' launches join the
   ``kernels`` line.
   Then sharded training and lockstep serving (``sharded_pass``; each rank
   a process of this script, ``--sharded-worker train|serve RANK WORLD
   DIR``, gloo through host memory): 4 ranks train llama3.2-1b FULL,
   then mamba2-1.3b FULL at 8 of 48 layers and seamless-m4t at 4 + 4 of
   12 + 12 (``SHARD_TRAIN_LAYERS``; zero frames; its encoder, decoder and
   cross-attention heads split) on ``data=2,model=2`` through the
   tensor-parallel step
   (``init_sharded_train_state``: each rank's quarter of the f32 masters
   and AdamW moments; bf16 compute; a rank's half of the heads, ``ff``
   columns, SSM heads and vocab, each layer's weights gathered over
   ``data`` inside the layer; global batch 4 x 512 from
   ``SyntheticLMPipeline(seed=0, sharding=ctx)``, 2 x 512 rows a rank),
   one warm step and 2 timed steps each (step ms a rank split into
   gather, forward+backward, reduce-scatter, the activations' all-reduces
   over ``model`` and update; peak GB a rank; the bytes a gather-whole
   rank would need reckoned first and printed), an async checkpoint of
   llama's state; then each model's f32 step at 2 layers against the
   unsharded ``make_train_step`` from the same state. The same 4 ranks then
   train llama3.2-1b FULL at 2 of 16 layers (``SHARD_GATHER_LAYERS``)
   again on ``data=4`` through the gather-whole step
   (each leaf's bf16 cast gathered whole before the forward: the step of
   every family on a data-only mesh), 1 x 512 rows a rank, with the same
   timing, f32 parity and
   gates (launches ``train_launches``, its own parts). A world of 4 ranks
   then serves on ``data=2,model=2`` in lockstep (``sharded_serve_worker``:
   4 slots, 2 a data rank; a rank's half of the heads, ``ff`` columns, SSM
   heads and vocab, ``wo``/``w_out``/``out_proj`` row-parallel): llama
   FULL from the training world's checkpoint, mamba2 at 8 of 48 layers and
   zamba2 at 12 of 54 (two uses of the shared block) from seed 0, the
   continuous phase's 8 requests on the ring and the paged cache (tok/s,
   host ms a T = 16 and T = 1 tick, their device ms by kind, peak GB, the
   cache a rank holds); then ``make_serve_step(bundle, mesh_ctx=)`` under
   the production rules' ``seq_shard=True``: llama's prefill of 4 x 2032
   tokens into 2048 cache rows (1024 a rank) and of one row of 8176 into
   8192 (2048 a rank, over ``data`` x ``model``), mamba2's of 4 x 2032 at
   8 layers, each with 16 decode steps (ms a rank split into collectives
   and the rest, peak GB); then qwen3-moe at 4 of 94 layers (ring and
   paged) and grok-1 at 2 of 64 (ring) on the same 8 requests, each
   rank's shards drawn leaf by leaf (``SHARD_MOE_SERVE``), and seamless's
   wave steps whole (4 rows of 512 frames and 468 tokens into 484
   self-cache rows, 16 decode steps) under the default rules and under
   ``seq_shard`` (``SHARD_ENCDEC_WAVES``). Then f32 at 2 layers (zamba2 6;
   qwen3-moe 2, grok-1 1, their unsharded run on rank 0 alone once the
   ranks have freed their shares): the ``model=2``
   path of PRs 27-29 (two replicas of ``model=2`` in the world) on the
   served runs' 8 x 512-token requests with 16 new tokens, each served run
   (8 prompts of up to 64 tokens, 4 new) and each wave against the
   unsharded engine or steps. Gated:
   train launches a step at the local shapes (llama RMSNorm 4L + 1, flash
   2L at Hq=16 Hkv=4, ``tcu_reduce`` one a leaf; mamba RMSNorm 2L + 1, the
   SSD 2L at H=32, ``tcu_reduce`` one a leaf and 2L for the split gated
   norm) on every rank, equal losses, each route's parts, rows by data
   coordinate, llama's tensor-parallel peak GB a rank below the
   gather-whole step's 10.04 (its measurement on ``data=2,model=2``), the
   f32 loss within 1e-5 and the params within 1e-5 plus AdamW's
   first-step conditioning (the rule of tests/test_torch_training.py); the
   restored params' digests equal the saved ones; every serving rank's
   tokens equal, a tick's launches a rank's share (RMSNorm 2L + 1, a Mamba
   layer's gated norm on ``tcu_reduce``), the waves' likewise plus flash
   and the SSD a layer, no graph, the cache a rank holds (half the KV or
   SSM heads of its 2 slots; under ``seq_shard`` its range of the rows
   with every KV head), the MoE's ``tcu_scan`` once a layer a tick and
   its expert leaves half the whole's bytes a rank, seamless's self and
   cross caches a rank's part; every f32 run's logits within 1e-4 of the
   unsharded one's and its tokens equal.
   Then the dry run and the roofline (``dryrun and roofline``): a CPU
   subprocess, started before the training phases and run beside them,
   runs ``repro_torch.launch.dryrun`` on DRYRUN_CELLS of the single mesh
   (rank 0 of a fake 256-rank world, FULL configs as fake tensors); here
   each record's status, peak GiB a rank, fit in 80 GB and roofline terms
   are printed (any ``fail`` fails the phase), after the four
   ``examples/torch_*.py`` run on the card at small sizes (each exits 0
   and prints its check; train_lm resumes from its checkpoint).
   Then the op analyser counts train_pass's llama3.2-1b FULL step and one
   mamba2-1.3b wave decode step on the kernel path and under ``baseline``
   (FLOPs and bytes equal within 1e-9), beside the step's measured ms:
   the bound on the H100's constants, the model FLOPs, MFU (model FLOPs
   over measured s x 989e12) and bound / measured, gated at 1.05. The
   phase's launches are not added to the main path's counts.
3. Per kernel: the kernel against its plain version on the card at the main
   path's shapes (the reduce and scan at 2^24 elements from 2^20 rows of 16
   to one row, the reduce also on the global norm's largest rows, RMSNorm also at the served decode and prefill shapes,
   the continuous T = 16 tick's 64 rows, the MoE widths 4096 and 6144,
   zamba2's 5120, internvl2's and deepseek's 8192, seamless's 1024 and
   h2o-danube's 3840 (6144 rows: its long prompt),
   flash attention also on its D = 128 instance, at the MoE waves'
   heads, at zamba2's D = 80, at internvl2's stub and prompts, at
   deepseek's 64 / 8 heads, at seamless's encoder and cross-attention
   (no causal mask, Lq 468 against Lk 512) and at h2o-danube's D = 120,
   the wave and the 6144-token prompt with its window (each also in
   f32), the scan also on the MoE router's (groups, experts) counts,
   bit for bit, the SSD scan also at the
   served waves (mamba2, zamba2's 80 heads and N = 64) and on a 64-chunk
   chain, the weighted scan from 65536 rows
   of 256 to one row of 2^24 and in bf16, its local pass also at 16 rows of
   2^20), with the error and its
   tolerance (flash attention row by row, against each output row's RMS),
   the times of the kernel,
   the plain version and one library call where PyTorch has one, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the peak rate of the input type, whichever is larger). Then each
   log-depth op whole (local kernel, tree and glue) beside the linear
   kernel's op at the same shapes.
4. A JSON line of the serve and train runs and whole-op times, a
   ``kernels`` JSON line (launches: the main path's runs, graph replays
   and train steps included), the
   ``nvidia-smi`` line, and last the ``ok`` line.

Exits non-zero and prints no result when there is no CUDA device or no
``src/repro_torch`` beside this script; exits 1 when any phase failed.
"""
from __future__ import annotations

import atexit
import bisect
import contextlib
import dataclasses
import faulthandler
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the card's constants and the cost formulas live in the package (the op
# analyser charges the dispatch ops by the same formulas); a directory with
# this script alone has no package, and main() says so
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:
    from repro_torch.core.costs import (
        attention_flops,
        local_ssd_flops,
        nbytes,
        rmsnorm_flops,
        ssd_flops,
    )
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.roofline import bound
except ImportError:
    pass

N_ELEMS = 1 << 24
# the largest parameter leaves the train step's global norm reduces:
# llama3.2-1b's tied embedding (128256 x 2048) and mamba2-1.3b's stacked
# in_proj (48 x 2048 x 8512)
GLOBAL_NORM_ROWS = (128256 * 2048, 48 * 2048 * 8512)
TP_NORM_ROWS = (2 * 512, 4096 // 2)   # mamba2's split gated norm, model=2
# the split gated norm's Σx² on a serving rank of data=2,model=2: (rows,
# columns, where): mamba2's d_inner 4096 and zamba2's 5120 halved
TP_SERVE_NORMS = ((32, 2048, "mamba2 T = 16 tick, 2 slots x 16"),
                  (2, 2048, "mamba2 T = 1 tick"),
                  (4064, 2048, "mamba2 wave prefill, 2 x 2032"),
                  (32, 2560, "zamba2 T = 16 tick"),
                  (2, 2560, "zamba2 T = 1 tick"))
SPIN_CAP_MS = 20.0                  # longest spin before a timed launch
OBS_DIR = Path(__file__).resolve().parent / "build" / "obs"   # traces


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        # the card's spin rate, so that a spin can be sized in ms
        torch.cuda._sleep(1000)
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 1e7 / start.elapsed_time(end)
        self.spread: dict = {}

    def _events(self):
        return tuple(self.torch.cuda.Event(enable_timing=True)
                     for _ in range(2))

    def fail(self, msg: str) -> None:
        self.failures.append(msg)
        print(f"FAIL {msg}", flush=True)

    def time_ms(self, fn, *, budget_ms: float = 300.0,
                max_iters: int = 20) -> float:
        """Median device time of ``fn`` with a cold L2; its spread over the
        samples is left in ``self.spread``.

        A 64 MB write and a spin on the card precede every timed launch. The
        spin is sized to outlast the host's enqueue of ``fn``, and each
        sample checks that it did: the host must have enqueued all of ``fn``
        before the spin could end, else the event pair may hold host time.
        Such a sample is dropped and the spin doubled, up to SPIN_CAP_MS;
        past that the samples are kept and marked ``host_bound`` (a function
        of thousands of launches fills the launch queue, and then the host
        waits for the card whatever the spin)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        spin_ms = min(SPIN_CAP_MS, max(0.2, 2.0 * host_ms))
        times, dropped, host_bound = [], 0, False
        while len(times) < max_iters:
            self.flush.zero_()
            start, end = self._events()
            t0 = time.perf_counter()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            start.record()
            fn()
            end.record()
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
            end.synchronize()
            clean = enqueue_ms < spin_ms
            if not clean and spin_ms < SPIN_CAP_MS:
                dropped += 1
                spin_ms = min(SPIN_CAP_MS, 2.0 * spin_ms)
                continue
            host_bound |= not clean
            times.append(start.elapsed_time(end))
            if len(times) >= 3 and sum(times) > budget_ms:
                break
        self.spread = dict(min=min(times), max=max(times), n=len(times),
                           dropped=dropped, spin_ms=spin_ms,
                           host_bound=host_bound)
        return statistics.median(times)


def ptxas_report(build_log: Path, names=("flash_attention_wgmma_kernel",
                                          "rmsnorm_kernel",
                                          "ssd_scan_mma_kernel",
                                          "local_ssd_mma_kernel",
                                          "piece_totals_kernel",
                                          "piece_scan_kernel",
                                          "tcu_reduce_combine_kernel",
                                          "tcu_scan_carry_kernel",
                                          "wscan_pass_kernel",
                                          "wscan_fold_kernel",
                                          "wscan_carry_kernel")
                 ) -> list[str]:
    """Registers, shared memory and spills that ``nvcc -Xptxas -v`` gave
    each instance of the named kernels, one line per instance."""
    out, cur = [], None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            cur = mangled if any(n in mangled for n in names) else None
        elif cur and "spill stores" in line:
            spill = line.strip()
        elif cur and "Used" in line and "registers" in line:
            out.append(f"ptxas {cur}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
            cur = None
    return out


def instance_text(instances: dict) -> str:
    """Launches by instance of the SSD chunk body: mma (tensor cores) or
    fma."""
    return ", ".join(f"{k}/{i} {n}" for (k, i), n in
                     sorted(instances.items())) or "none"


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# per-kernel cases: (label, inputs, kernel call, plain call, library call,
# tolerance, bytes, ops, input dtype)


def reduce_scan_cases(torch, kops, ref, gen):
    """The 2^24-element cases of both kernels, many short rows to few long
    ones: (dtype, rows, kernels)."""
    out = []
    f16, f32 = torch.float16, torch.float32
    for dtype, rows, kernels in (
            (f16, N_ELEMS // 16, "rs"), (f16, N_ELEMS // 256, "rs"),
            (f16, N_ELEMS // 4096, "rs"), (f32, N_ELEMS // 256, "rs"),
            # few long rows: cut into pieces across the card
            (f32, 16, "rs"), (f32, 1, "r")):
        n = N_ELEMS // rows
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        tag = f"{str(dtype).split('.')[-1]} rows={rows} n={n}"
        primary = (dtype, n) == (f16, 256)
        if "r" in kernels:
            out.append(dict(
                kernel="tcu_reduce", label=tag, primary=primary,
                run=lambda x=x: kops.segmented_reduce(x),
                plain=lambda x=x: ref.segmented_reduce_ref(x),
                library=lambda x=x: torch.sum(x, dim=-1,
                                              dtype=torch.float32),
                rtol=2e-4, nbytes=nbytes(x) + 4 * rows, ops=x.numel(),
                dtype=dtype))
        if "s" in kernels:
            out.append(dict(
                kernel="tcu_scan", label=tag, primary=primary,
                run=lambda x=x: kops.segmented_scan(x),
                plain=lambda x=x: ref.segmented_scan_ref(x),
                library=lambda x=x: torch.cumsum(x, dim=-1,
                                                 dtype=torch.float32),
                rtol=1e-3, nbytes=nbytes(x) + 4 * x.numel(), ops=x.numel(),
                dtype=dtype))
    # the split gated norm of mamba2's train step over model=2: the Σx² of
    # a rank's 2048 of d_inner's columns, 2 x 512 rows
    x = torch.randn(TP_NORM_ROWS, generator=gen, device="cuda") ** 2
    out.append(dict(
        kernel="tcu_reduce", label=f"float32 rows={TP_NORM_ROWS[0]} "
        f"n={TP_NORM_ROWS[1]} (split gated norm, model=2)", primary=False,
        run=lambda x=x: kops.segmented_reduce(x),
        plain=lambda x=x: ref.segmented_reduce_ref(x),
        library=lambda x=x: torch.sum(x, dim=-1, dtype=torch.float32),
        rtol=2e-4, nbytes=nbytes(x) + 4 * TP_NORM_ROWS[0],
        ops=x.numel(), dtype=torch.float32))
    for rows, n, where in TP_SERVE_NORMS:
        x = torch.randn(rows, n, generator=gen, device="cuda") ** 2
        out.append(dict(
            kernel="tcu_reduce", label=f"float32 rows={rows} n={n} (split "
            f"gated norm, {where}, data=2,model=2)", primary=False,
            run=lambda x=x: kops.segmented_reduce(x),
            plain=lambda x=x: ref.segmented_reduce_ref(x),
            library=lambda x=x: torch.sum(x, dim=-1, dtype=torch.float32),
            rtol=2e-4, nbytes=nbytes(x) + 4 * rows, ops=x.numel(),
            dtype=torch.float32))
    # the train step's global norm reduces each parameter leaf's squares as
    # one row: the largest leaves of both models, positive as squares are
    for n in GLOBAL_NORM_ROWS:
        x = torch.rand(1, n, generator=gen, device="cuda")
        out.append(dict(
            kernel="tcu_reduce", label=f"float32 rows=1 n={n} (global norm)",
            primary=False, run=lambda x=x: kops.segmented_reduce(x),
            plain=lambda x=x: ref.segmented_reduce_ref(x),
            library=lambda x=x: torch.sum(x, dim=-1, dtype=torch.float32),
            rtol=2e-4, nbytes=nbytes(x) + 4, ops=n, dtype=torch.float32))
    return out


# the MoE router's exclusive scans of (groups, experts) counts, as served:
# (rows, experts, where)
MOE_SCANS = ((16, 128, "qwen3-moe wave prefill; a data=2,model=2 rank's "
                        "T=16 tick"),
             (32, 128, "qwen3-moe T=16 tick"),
             (4, 128, "qwen3-moe decode step, T=1 tick"),
             (2, 128, "qwen3-moe T=1 tick, a data=2,model=2 rank"),
             (16, 8, "grok-1 wave prefill; a data=2,model=2 rank's T=16 "
                     "tick"),
             (4, 8, "grok-1 decode step"),
             (2, 8, "grok-1 T=1 tick, a data=2,model=2 rank"))


def moe_scan_cases(torch, kops, ref, gen):
    """tcu_scan.cu at the MoE router's served shapes on whole-number f32
    counts, as the router's are: held to the plain version bit for bit
    (tolerance 0; three exact bf16 parts keep whole numbers below 2^24
    exact)."""
    out = []
    for rows, n, where in MOE_SCANS:
        x = torch.randint(0, 16, (rows, n), generator=gen, device="cuda",
                          dtype=torch.float32)
        out.append(dict(
            kernel="tcu_scan", label=f"float32 rows={rows} n={n} ({where})",
            primary=False, run=lambda x=x: kops.segmented_scan(x),
            plain=lambda x=x: ref.segmented_scan_ref(x),
            library=lambda x=x: torch.cumsum(x, dim=-1), rtol=0.0,
            nbytes=2 * nbytes(x), ops=x.numel(), dtype=torch.float32))
    return out


def ssd_inputs(torch, gen, bsz, seqlen, nheads, hdim, ngroups, nstate,
               dtype):
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = rn(bsz, seqlen, nheads, hdim).to(dtype)
    dt = torch.nn.functional.softplus(rn(bsz, seqlen, nheads) - 4.0)
    a = -(1.0 + 15.0 * torch.rand(nheads, generator=gen, device="cuda"))
    b = (rn(bsz, seqlen, ngroups, nstate) / nstate ** 0.5).to(dtype)
    c = (rn(bsz, seqlen, ngroups, nstate) / nstate ** 0.5).to(dtype)
    return x, dt, a, b, c


def ssd_cases(torch, kops, ref, gen):
    out = []
    # mamba2-1.3b FULL prefill: B=4 prompts of 512, 64 heads of 64, N=128;
    # the served wave (left-padded to 468, a ragged last chunk); one
    # sequence of 4096 (a chain of 64 chunks through the two-stage ring);
    # f32 on the FMA instance
    for shape, dtype, primary in (((4, 512, 64, 64, 1, 128), torch.bfloat16,
                                   True),
                                  ((4, 468, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((1, 4096, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((2, 300, 8, 64, 2, 128), torch.float32,
                                   False),
                                  # zamba2-2.7b's served wave (80 heads,
                                  # N = 64) and its train step
                                  ((4, 468, 80, 64, 1, 64), torch.bfloat16,
                                   False),
                                  ((4, 512, 80, 64, 1, 64), torch.bfloat16,
                                   False),
                                  # mamba2's train step split over model=2:
                                  # a rank's 32 heads of its 2 rows
                                  ((2, 512, 32, 64, 1, 128), torch.bfloat16,
                                   False),
                                  # its sharded wave prefill on
                                  # data=2,model=2: 2 of 4 rows x 2032
                                  ((2, 2032, 32, 64, 1, 128), torch.bfloat16,
                                   False)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        bsz, seqlen, nheads, hdim, ngroups, nstate = shape
        y_bytes = bsz * seqlen * nheads * hdim * ins[0].element_size()
        st_bytes = bsz * nheads * hdim * nstate * 4
        out.append(dict(
            kernel="ssd_scan", label=f"{str(dtype).split('.')[-1]} "
            f"B={bsz} L={seqlen} H={nheads} P={hdim} G={ngroups} N={nstate}",
            primary=primary,
            run=lambda ins=ins: kops.ssd_scan(*ins, return_state=True),
            plain=lambda ins=ins: ref.ssd_scan_ref(*ins, return_state=True),
            library=None, rtol=8e-3 if dtype == torch.bfloat16 else 2e-3,
            nbytes=nbytes(*ins) + y_bytes + st_bytes,
            ops=ssd_flops(bsz, seqlen, nheads, hdim, nstate), dtype=dtype))
    return out


# the weighted scan's cases: (dtype, rows, n); the ops pass's shape first
WEIGHTED_CASES = (("float32", 64, 4096), ("float32", 65536, 256),
                  ("float32", 16, 1 << 20), ("float32", 1, 1 << 24),
                  ("bfloat16", 16, 1 << 20))


def weighted_cases(torch, kops, ref, gen):
    """weighted_scan.cu from many short rows to one row of 2^24, x and
    log_a in their own dtype, y in f32."""
    out = []
    for dtype, rows, n in WEIGHTED_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(rows, n, generator=gen, device="cuda").to(dt)
        la = (-0.5 * torch.rand(rows, n, generator=gen, device="cuda")).to(dt)
        out.append(dict(
            kernel="weighted_scan", label=f"{dtype} rows={rows} n={n}",
            primary=(dtype, rows, n) == WEIGHTED_CASES[0],
            run=lambda x=x, la=la: kops.weighted_scan(x, la),
            plain=lambda x=x, la=la: ref.weighted_scan_ref(x, la),
            library=None, rtol=2e-3, nbytes=nbytes(x, la) + 4 * x.numel(),
            # one multiply-add per element (and one exp)
            ops=2 * x.numel(), dtype=dt))
    return out


def logdepth_cases(torch, kops, ref, gen):
    """The three local passes of csrc/matmul_scan.cu, each with its block
    size from ``layout.DEFAULT_TUNING`` as the log-depth ops run it by
    default."""
    from repro_torch.kernels.layout import DEFAULT_TUNING

    geo = DEFAULT_TUNING["gpu"]
    out = []
    bn = geo["scan"]["block_n"]
    for dtype, rows, n in ((torch.float16, N_ELEMS // 256, 256),
                           (torch.float32, N_ELEMS // 256, 256),
                           (torch.float32, 16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        out.append(dict(
            kernel="matmul_local_scan",
            label=f"{str(dtype).split('.')[-1]} rows={rows} n={n} "
                  f"block_n={bn}",
            primary=dtype == torch.float16,
            run=lambda x=x: kops.matmul_local_scan(x, bn),
            plain=lambda x=x: ref.local_scan_ref(x, bn),
            library=lambda x=x: torch.cumsum(x.view(x.shape[0], -1, bn), -1,
                                             dtype=torch.float32),
            rtol=1e-3, nbytes=nbytes(x) + 4 * x.numel(), ops=x.numel(),
            dtype=dtype))
    q = geo["weighted_scan"]["q"]
    for rows, n in ((64, 4096), (16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda")
        la = -0.5 * torch.rand(rows, n, generator=gen, device="cuda")
        out.append(dict(
            kernel="matmul_local_weighted",
            label=f"f32 rows={rows} n={n} q={q}", primary=rows == 64,
            run=lambda x=x, la=la: kops.matmul_local_weighted(x, la, q),
            plain=lambda x=x, la=la: ref.local_weighted_ref(x, la, q),
            library=None, rtol=1e-4, nbytes=nbytes(x, la) + 4 * x.numel(),
            # one multiply-add per element (and one exp)
            ops=2 * x.numel(), dtype=torch.float32))
    q = geo["ssd"]["q"]
    for shape, dtype, primary in (((4, 512, 64, 64, 1, 128), torch.bfloat16,
                                   True),
                                  # the served wave, left-padded to 468
                                  ((4, 468, 64, 64, 1, 128), torch.bfloat16,
                                   False),
                                  ((2, 300, 8, 64, 2, 128), torch.float32,
                                   False)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        bsz, seqlen, nheads, hdim, ngroups, nstate = shape
        y_bytes = 4 * bsz * seqlen * nheads * hdim
        s_bytes = 4 * bsz * nheads * (-(-seqlen // q)) * nstate * hdim
        out.append(dict(
            kernel="matmul_local_ssd", label=f"{str(dtype).split('.')[-1]} "
            f"B={bsz} L={seqlen} H={nheads} P={hdim} G={ngroups} N={nstate}"
            f" q={q}", primary=primary,
            run=lambda ins=ins: kops.matmul_local_ssd(*ins, q),
            plain=lambda ins=ins: ref.local_ssd_ref(*ins, q), library=None,
            # both sides compute in f32 from the same inputs and write f32
            rtol=1e-4, nbytes=nbytes(*ins) + y_bytes + s_bytes,
            ops=local_ssd_flops(bsz, seqlen, nheads, hdim, nstate, q),
            dtype=dtype))
    return out


def rmsnorm_cases(torch, kops, ref, gen):
    import torch.nn.functional as F

    out = []
    # the ops pass's shapes, then the served ones: a decode step's 4 rows
    # (llama d 2048, mamba's inner norm and qwen3-moe d 4096, grok-1 and
    # internlm2 d 6144, zamba2's residual d 2560 and its shared-block and
    # inner norms d 5120, internvl2 and deepseek d 8192, seamless d 1024,
    # h2o-danube d 3840; the continuous T = 1 tick), the continuous T = 16
    # tick's 64 rows, the wave prefill's 1872 rows (4 x 468), internvl2's
    # 2896 (4 x (256 + 468)), the train steps' and seamless's encoder's
    # 2048 (4 x 512) and h2o-danube's long prompt's 6144
    for rows, d in ((2048, 2048), (2048, 4096), (4, 2048), (4, 4096),
                    (64, 2048), (64, 4096), (1872, 2048), (1872, 4096),
                    (4, 6144), (1872, 6144), (1872, 2560), (4, 2560),
                    (64, 2560), (2048, 2560), (1872, 5120), (4, 5120),
                    (64, 5120), (2048, 5120), (4, 8192), (2896, 8192),
                    (1872, 8192), (2048, 1024), (1872, 1024), (4, 1024),
                    (1872, 3840), (6144, 3840), (4, 3840), (64, 3840),
                    # a serving rank of data=2,model=2: 2 slots' T = 16 and
                    # T = 1 ticks (llama, mamba2, zamba2), the wave
                    # prefills' 2 x 2032 and 8176 rows
                    (32, 2048), (2, 2048), (32, 2560), (2, 2560),
                    (32, 5120), (2, 5120), (4064, 2048), (8176, 2048),
                    # ... and of the MoE (qwen3-moe d 4096, grok-1 d 6144:
                    # 2 slots' T = 16 and T = 1 ticks) and of seamless (its
                    # wave: 2 x 512 encoder rows, 2 x 468 decoder rows, 2
                    # rows a decode step; its train step, 2 x 512)
                    (32, 4096), (2, 4096), (32, 6144), (2, 6144),
                    (1024, 1024), (936, 1024), (2, 1024)):
        x = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
            torch.bfloat16)
        lib = (lambda x=x, w=w, d=d: F.rms_norm(x, (d,), w, eps=1e-5)) \
            if hasattr(F, "rms_norm") else None
        out.append(dict(
            kernel="rmsnorm", label=f"bf16 rows={rows} d={d}",
            primary=(rows, d) == (2048, 4096),
            run=lambda x=x, w=w: kops.rmsnorm(x, w, eps=1e-5),
            plain=lambda x=x, w=w: ref.rmsnorm_ref(x, w, eps=1e-5),
            library=lib, rtol=1e-2, nbytes=2 * nbytes(x) + nbytes(w),
            ops=rmsnorm_flops(x.numel()), dtype=torch.bfloat16))
    return out


def row_rel_err(got, want) -> float:
    """Largest error in any output row over that row's RMS in ``want``, so
    that an error confined to late rows, whose values are small, counts as
    much as one in the first rows."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / rms).max().item()


def attention_gate(kops, q, k, v, causal, window):
    """Holds the kernel's output against the plain version run in f32 on the
    same inputs, row by row (``row_rel_err``). f16/bf16: within twice the
    plain version's own distance from that f32 run; both round the output
    once, and the kernel also rounds P before P V, which puts it at 1.0 to
    1.35 times the plain version's distance (CPU emulation over the test
    shapes). f32: within 1e-4; three-part bf16 operands and f32 sums leave
    2e-5 on an H100, over 468 keys a row or 4096."""
    def plain(*ts):
        return kops.attention_plain(*ts, causal=causal, window=window)

    def gate(got):
        want = plain(q.float(), k.float(), v.float())
        tol = (1e-4 if q.element_size() == 4 else
               2.0 * row_rel_err(plain(q, k, v), want))
        return dict(errs=[row_rel_err(got, want)], tols=[tol],
                    max_abs_err=(got.float() - want).abs().max().item(),
                    measure="row-relative, against the plain version in f32")
    return gate


def attention_cases(torch, kops, gen):
    import torch.nn.functional as F

    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    out = []
    for (bsz, lq, lk, hq, hkv, dh, causal, window, dtype, primary) in (
            (4, 512, 512, 32, 8, 64, True, None, torch.bfloat16, True),
            # the served wave: left-padded to 468, a ragged tail tile
            (4, 468, 468, 32, 8, 64, True, None, torch.bfloat16, False),
            (1, 4096, 4096, 32, 8, 64, True, None, torch.bfloat16, False),
            (1, 4096, 4096, 32, 8, 64, True, 1024, torch.bfloat16, False),
            # the kernel's D = 128 instance
            (4, 512, 512, 32, 8, 128, True, None, torch.bfloat16, False),
            # the served MoE waves: qwen3-moe (64 / 4 heads) and grok-1
            # (48 / 8), D = 128, left-padded to 468
            (4, 468, 468, 64, 4, 128, True, None, torch.bfloat16, False),
            (4, 468, 468, 48, 8, 128, True, None, torch.bfloat16, False),
            # zamba2's shared block (D = 80 on the D = 128 instance), served
            # and in its train step, and internvl2's stub prefix and prompts
            # (256 + 468 rows)
            (4, 468, 468, 32, 32, 80, True, None, torch.bfloat16, False),
            (4, 512, 512, 32, 32, 80, True, None, torch.bfloat16, False),
            (4, 724, 724, 64, 8, 128, True, None, torch.bfloat16, False),
            (1, 100, 1000, 4, 2, 64, True, None, torch.float32, False),
            # deepseek-67b's wave (64 / 8 heads of 128)
            (4, 468, 468, 64, 8, 128, True, None, torch.bfloat16, False),
            # seamless-m4t: the encoder over 512 frames and the decoder's
            # cross-attention from the 468-token wave over them, both
            # without a causal mask, then the decoder's self-attention
            # (16 / 16 heads) at the wave and in the train step
            (4, 512, 512, 16, 16, 64, False, None, torch.bfloat16, False),
            (4, 468, 512, 16, 16, 64, False, None, torch.bfloat16, False),
            (4, 468, 468, 16, 16, 64, True, None, torch.bfloat16, False),
            (4, 512, 512, 16, 16, 64, True, None, torch.bfloat16, False),
            # h2o-danube's head dim 120 (the D = 128 instance, 8 columns of
            # zero fill): the served wave, and the long prompt past its
            # window of 4096; both also on the f32 instance (its f32 logit
            # gates), whose 16-column wmma tiles take D = 120 zero-padded
            (4, 468, 468, 32, 8, 120, True, None, torch.bfloat16, False),
            (1, 6144, 6144, 32, 8, 120, True, 4096, torch.bfloat16, False),
            (4, 468, 468, 32, 8, 120, True, None, torch.float32, False),
            (1, 6144, 6144, 32, 8, 120, True, 4096, torch.float32, False),
            # llama3.2-1b's train step split over model=2: a rank's 16 / 4
            # heads of its data coordinate's 2 rows
            (2, 512, 512, 16, 4, 64, True, None, torch.bfloat16, False),
            # its sharded wave prefills on data=2,model=2: 2 of 4 rows x
            # 2032, and the one row of 8176 (the long_500k layout)
            (2, 2032, 2032, 16, 4, 64, True, None, torch.bfloat16, False),
            (1, 8176, 8176, 16, 4, 64, True, None, torch.bfloat16, False),
            # seamless on a data=2,model=2 rank, 8 of its 16 heads of 2
            # rows: the encoder over 512 frames (and in its train step),
            # the cross-attention from 468 tokens, the decoder at 468 and
            # in its train step at 512
            (2, 512, 512, 8, 8, 64, False, None, torch.bfloat16, False),
            (2, 468, 512, 8, 8, 64, False, None, torch.bfloat16, False),
            (2, 468, 468, 8, 8, 64, True, None, torch.bfloat16, False),
            (2, 512, 512, 8, 8, 64, True, None, torch.bfloat16, False)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, k, v = rn(bsz, lq, hq, dh), rn(bsz, lk, hkv, dh), rn(bsz, lk, hkv,
                                                               dh)
        # the library call: torch's SDPA in its (B, H, S, D) layout, with
        # the same mask (bottom-right aligned, window) where is_causal's
        # top-left alignment or the window differ, and none without a
        # causal mask or a window; K/V repeated outside the timed call where
        # this torch has no enable_gqa
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not gqa:
            kt, vt = (t.repeat_interleave(hq // hkv, dim=1) for t in (kt, vt))
        mask = None
        if (causal and lq != lk) or window is not None:
            qpos = torch.arange(lq, device="cuda")[:, None] + (lk - lq)
            kpos = torch.arange(lk, device="cuda")[None, :]
            mask = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
            if window is not None:
                mask &= kpos > qpos - window
        kw = {"enable_gqa": True} if gqa else {}

        def lib(qt=qt, kt=kt, vt=vt, mask=mask, kw=kw, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, **kw)

        tag = (f"{str(dtype).split('.')[-1]} B={bsz} Lq={lq} Lk={lk} "
               f"Hq={hq} Hkv={hkv} D={dh} causal={causal} window={window}")
        out.append(dict(
            kernel="flash_attention", label=tag, primary=primary,
            run=lambda q=q, k=k, v=v, c=causal, w=window: kops.attention(
                q, k, v, causal=c, window=w),
            plain=lambda q=q, k=k, v=v, c=causal, w=window:
                kops.attention_plain(q, k, v, causal=c, window=w),
            library=lib, gate=attention_gate(kops, q, k, v, causal, window),
            nbytes=nbytes(q, k, v) + nbytes(q),
            ops=attention_flops(bsz, lq, lk, hq, dh, causal, window),
            dtype=dtype))
    return out


def max_err(got, want):
    """(max abs error, max |want|) over every output tensor."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    scales = [w.float().abs().max().item() for w in want]
    return errs, scales


def check_kernels(smoke: Smoke, kops, ref) -> dict:
    """Each kernel against its plain version; returns per-kernel rows."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = (reduce_scan_cases(torch, kops, ref, gen)
             + moe_scan_cases(torch, kops, ref, gen)
             + ssd_cases(torch, kops, ref, gen)
             + weighted_cases(torch, kops, ref, gen)
             + rmsnorm_cases(torch, kops, ref, gen)
             + attention_cases(torch, kops, gen)
             + logdepth_cases(torch, kops, ref, gen))
    rows: dict[str, dict] = {}
    for case in cases:
        name = case["kernel"]
        try:
            got = case["run"]()
            torch.cuda.synchronize()
            if "gate" in case:
                g = case["gate"](got)
                errs, tols, abs_err = g["errs"], g["tols"], g["max_abs_err"]
                measure = g["measure"]
            else:
                errs, scales = max_err(got, case["plain"]())
                tols = [case["rtol"] * max(1.0, s) for s in scales]
                abs_err, measure = max(errs), "abs"
            ok = all(e <= t for e, t in zip(errs, tols))
            ms = smoke.time_ms(case["run"])
            spread = smoke.spread
            plain_ms = smoke.time_ms(case["plain"], max_iters=5)
            plain_spread = smoke.spread
            lib_ms = (smoke.time_ms(case["library"])
                      if case["library"] is not None else None)
            lib_bound = lib_ms is not None and smoke.spread["host_bound"]
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"{name} [{case['label']}]: {exc!r}")
            continue
        bound_ms, bound_by = bound(case["nbytes"], case["ops"],
                                   case["dtype"])
        rec = dict(label=case["label"], max_abs_err=abs_err, err=max(errs),
                   tol=max(tols), measure=measure, ms=ms,
                   ms_spread=spread, plain_ms=plain_ms,
                   plain_ms_spread=plain_spread, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel {name} [{case['label']}]: err ({measure})="
              f"{[f'{e:.3e}' for e in errs]} tol={[f'{t:.3e}' for t in tols]}"
              f" max_abs_err={abs_err:.3e} ms={ms:.4f} (min "
              f"{spread['min']:.4f} max {spread['max']:.4f} n={spread['n']}"
              f"{' HOST-BOUND' if spread['host_bound'] else ''}) "
              f"plain_ms={plain_ms:.4f}"
              f"{' HOST-BOUND' if plain_spread['host_bound'] else ''} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'}"
              f"{' HOST-BOUND' if lib_bound else ''} "
              f"bound_ms={bound_ms:.4g} ({bound_by})"
              f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
        if not ok:
            smoke.fail(f"{name} [{case['label']}] disagrees with its plain "
                       f"version: {errs} > {tols} ({measure})")
        row = rows.setdefault(name, {"cases": []})
        row["cases"].append(rec)
        if case["primary"]:
            row.update({k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by")})
    return rows


def compare_whole_ops(smoke: Smoke, ops, ref) -> list[dict]:
    """Each log-depth op whole (local kernel, tree and glue) beside the
    linear kernel's op and, for the scan, ``torch.cumsum``, at the shapes of
    the local-kernel cases; the log-depth op is held against the plain
    version of the whole op."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for dtype, rows, n in ((torch.float16, N_ELEMS // 256, 256),
                           (torch.float32, N_ELEMS // 256, 256),
                           (torch.float32, 16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        cases.append((f"scan {str(dtype).split('.')[-1]} rows={rows} n={n}",
                      lambda p, x=x: ops.scan(x, policy=p),
                      lambda x=x: ref.segmented_scan_ref(x),
                      lambda x=x: torch.cumsum(x, -1, dtype=torch.float32),
                      1e-3))
    for rows, n in ((64, 4096), (16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda")
        la = -0.5 * torch.rand(rows, n, generator=gen, device="cuda")
        cases.append((f"weighted_scan f32 rows={rows} n={n}",
                      lambda p, x=x, la=la: ops.weighted_scan(x, la,
                                                              policy=p),
                      lambda x=x, la=la: ref.weighted_scan_ref(x, la), None,
                      2e-3))
    for shape, dtype in (((4, 512, 64, 64, 1, 128), torch.bfloat16),
                         ((4, 468, 64, 64, 1, 128), torch.bfloat16),
                         ((2, 300, 8, 64, 2, 128), torch.float32)):
        ins = ssd_inputs(torch, gen, *shape, dtype)
        cases.append((
            f"ssd {str(dtype).split('.')[-1]} B={shape[0]} L={shape[1]} "
            f"H={shape[2]} P={shape[3]} G={shape[4]} N={shape[5]}",
            lambda p, ins=ins: ops.ssd(*ins, policy=p, return_state=True),
            lambda ins=ins: ref.ssd_scan_ref(*ins, return_state=True), None,
            8e-3 if dtype == torch.bfloat16 else 2e-3))
    out = []
    for label, run, plain, library, rtol in cases:
        try:
            errs, scales = max_err(run("tile_logdepth"), plain())
            tols = [rtol * max(1.0, sc) for sc in scales]
            times = {}
            for key, fn in (("logdepth", lambda: run("tile_logdepth")),
                            ("linear", lambda: run("tile")),
                            ("library", library)):
                if fn is not None:
                    times[key] = (smoke.time_ms(fn),
                                  smoke.spread["host_bound"])
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"whole op [{label}]: {exc!r}")
            continue
        ok = all(e <= t for e, t in zip(errs, tols))
        rec = dict(label=label, max_abs_err=max(errs), tol=max(tols),
                   **{f"{k}_ms": v[0] for k, v in times.items()},
                   host_bound=[k for k, v in times.items() if v[1]])
        rec.setdefault("library_ms", None)
        out.append(rec)
        lib, host = rec["library_ms"], rec["host_bound"]
        print(f"whole op [{label}]: tile_logdepth {rec['logdepth_ms']:.4f} "
              f"ms, linear tile {rec['linear_ms']:.4f} ms, library "
              f"{'null' if lib is None else f'{lib:.4f}'} ms; log-depth vs "
              f"plain max_abs_err={max(errs):.3e} (tol {max(tols):.3e})"
              f"{f' HOST-BOUND {host}' if host else ''}"
              f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
        if not ok:
            smoke.fail(f"whole op [{label}] under tile_logdepth disagrees "
                       f"with the plain version: {errs} > {tols}")
    return out


# ---------------------------------------------------------------------------
# main path


def ops_pass(smoke: Smoke, ops, ref):
    """The public ops once each, at the sizes the paper and the model use,
    on the default kernels and under ``tile_logdepth``."""
    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(N_ELEMS // 256, 256, generator=gen, device="cuda").half()
    red = ops.reduce(x)
    sc = ops.scan(x, exclusive=True)
    la = -0.5 * torch.rand(64, 4096, generator=gen, device="cuda")
    ws_x = torch.randn(64, 4096, generator=gen, device="cuda")
    ws = ops.weighted_scan(ws_x, la)
    h = torch.randn(2048, 2048, generator=gen, device="cuda").bfloat16()
    nrm = ops.rmsnorm(h, torch.ones(2048, device="cuda",
                                    dtype=torch.bfloat16), eps=1e-5)
    ssd_in = ssd_inputs(torch, gen, 4, 512, 64, 64, 1, 128, torch.bfloat16)
    y, st = ops.ssd(*ssd_in, return_state=True)
    att = ops.attention(*(torch.randn(4, 512, h, 64, generator=gen,
                                      device="cuda").bfloat16()
                          for h in (32, 8, 8)))
    # the log-depth family on the same inputs, and on one long row, where
    # the linear scan's carry walks 4096 blocks in order
    ld = "tile_logdepth"
    ld_sc = ops.scan(x, exclusive=True, policy=ld)
    long_row = torch.randn(16, 1 << 20, generator=gen, device="cuda")
    ld_long = ops.scan(long_row, policy=ld)
    long_la = -0.5 * torch.rand(16, 1 << 20, generator=gen, device="cuda")
    ws_long = ops.weighted_scan(long_row, long_la)
    ld_ws = ops.weighted_scan(ws_x, la, policy=ld)
    ld_y, ld_st = ops.ssd(*ssd_in, policy=ld, return_state=True)
    torch.cuda.synchronize()
    for name, t, shape in (("reduce", red, (N_ELEMS // 256,)),
                           ("scan", sc, (N_ELEMS // 256, 256)),
                           ("weighted_scan", ws, (64, 4096)),
                           ("weighted_scan long row", ws_long,
                            (16, 1 << 20)),
                           ("rmsnorm", nrm, (2048, 2048)),
                           ("ssd.y", y, (4, 512, 64, 64)),
                           ("ssd.state", st, (4, 64, 64, 128)),
                           ("attention", att, (4, 512, 32, 64)),
                           ("scan[tile_logdepth]", ld_sc,
                            (N_ELEMS // 256, 256)),
                           ("scan[tile_logdepth] long row", ld_long,
                            (16, 1 << 20)),
                           ("weighted_scan[tile_logdepth]", ld_ws,
                            (64, 4096)),
                           ("ssd[tile_logdepth].y", ld_y, (4, 512, 64, 64)),
                           ("ssd[tile_logdepth].state", ld_st,
                            (4, 64, 64, 128))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            smoke.fail(f"ops.{name}: shape {tuple(t.shape)} (want {shape})"
                       " or non-finite values")
    for name, t in (("scan", sc), ("scan[tile_logdepth]", ld_sc)):
        if t[:, 0].abs().max().item() != 0.0:
            smoke.fail(f"ops.{name}(exclusive=True) does not start at 0")
    # the linear kernels on the long row, where each row is cut into pieces
    # across the card, against torch.sum / torch.cumsum and the weighted
    # scan's plain version
    base = "baseline"
    for name, got, want, rtol in (
            ("reduce", ops.reduce(long_row), ops.reduce(long_row,
                                                        policy=base), 2e-4),
            ("scan", ops.scan(long_row), ops.scan(long_row, policy=base),
             1e-3),
            ("weighted_scan", ws_long,
             ops.weighted_scan(long_row, long_la, policy=base), 2e-3)):
        err = (got - want).abs().max().item()
        tol = rtol * max(1.0, want.abs().max().item())
        if got.shape != want.shape or not err <= tol:
            smoke.fail(f"ops.{name} long row: tile and baseline differ by "
                       f"{err} (tol {tol})")
    # mixed dtypes: bf16 x with f32 b, c computes in f32 and returns y in
    # x's dtype, on both families, as the plain version does
    mx, mdt, ma, mb, mc = ssd_inputs(torch, gen, 2, 130, 4, 64, 1, 128,
                                     torch.float32)
    mx = mx.bfloat16()
    my_ref = ref.ssd_scan_ref(mx, mdt, ma, mb, mc)
    for p in ("tile", ld):
        my = ops.ssd(mx, mdt, ma, mb, mc, policy=p)
        err = (my.float() - my_ref.float()).abs().max().item()
        if my.dtype != torch.bfloat16 or not err <= 1e-2 * max(
                1.0, my_ref.float().abs().max().item()):
            smoke.fail(f"ops.ssd[{p}] mixed dtypes: y {my.dtype} (want "
                       f"bfloat16), max_abs_err {err}")
    # the two families on the same inputs: the same function, summed in
    # another order (the SSD output rounds to bf16 once on each side)
    for name, got, want, rtol in (
            ("scan", ld_sc, sc, 1e-3),
            ("scan long row", ld_long,
             ops.scan(long_row, policy="baseline"), 1e-3),
            ("weighted_scan", ld_ws, ws, 2e-3), ("ssd.y", ld_y, y, 8e-3),
            ("ssd.state", ld_st, st, 2e-3)):
        err = (got.float() - want.float()).abs().max().item()
        tol = rtol * max(1.0, want.float().abs().max().item())
        if not err <= tol:
            smoke.fail(f"ops.{name}: tile_logdepth and tile differ by {err}"
                       f" (tol {tol})")


# the ragged ops' cases: (label, ids shape, n_segments, ids sorted)
RAGGED = (("MoE router (32, 936) ids in [0, 128)", (32, 936), 128, False),
          ("1-D 65536 ids, 128 sorted segments", (65536,), 128, True))


def ragged_pass(smoke: Smoke, ops, kops) -> dict:
    """The ragged ops on the card: ``tile`` (their one-hot matmul forms; the
    reference has no kernel for them) against ``baseline`` (``scatter_add``,
    ``cumsum`` and a gather) at the MoE router's shape and on one long row.
    Counts of ones and within-segment ranks must be equal; the capacity
    offsets of the counts (``ops.scan`` exclusive, ``tcu_scan.cu``) must
    equal an exclusive ``torch.cumsum`` bit for bit; the scan of random
    values within 1e-3 of the largest. Then ``guard_contiguous`` inside a
    CUDA graph's capture, where no device value may be read: unsorted ids
    poison the replayed output with NaN, sorted ones leave it as the eager
    scan. Returns the launches and each op's times beside its baseline's."""
    from repro_torch.core import ragged

    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    kops.reset_launches()
    rows = []
    for label, shape, segs, srt in RAGGED:
        ids = torch.randint(0, segs, shape, generator=gen, device="cuda")
        if srt:
            ids = ids.sort(dim=-1).values
        ones = torch.ones(shape, device="cuda")
        x = torch.randn(shape, generator=gen, device="cuda")
        sorted_ids = ids.sort(dim=-1).values
        counts = ops.ragged_reduce(ones, ids, segs)
        offsets = ops.scan(counts, exclusive=True)
        cum = torch.cumsum(counts, dim=-1)
        want_off = torch.cat([torch.zeros_like(cum[..., :1]),
                              cum[..., :-1]], dim=-1)
        ranks = ops.ragged_scan(ones, sorted_ids, segs)
        got_scan = ops.ragged_scan(x, sorted_ids, segs)
        want_scan = ops.ragged_scan(x, sorted_ids, segs, policy="baseline")
        err = (got_scan - want_scan).abs().max().item()
        tol = 1e-3 * max(1.0, want_scan.abs().max().item())
        checks = {
            "counts": torch.equal(counts, ops.ragged_reduce(
                ones, ids, segs, policy="baseline")),
            "counts sum": counts.sum().item() == ones.numel(),
            "offsets": torch.equal(offsets, want_off),
            "ranks": torch.equal(ranks, ops.ragged_scan(
                ones, sorted_ids, segs, policy="baseline")),
            "scan": err <= tol}
        times = {}
        for op, fn in (("reduce", lambda p: ops.ragged_reduce(x, ids, segs,
                                                              policy=p)),
                       ("scan", lambda p: ops.ragged_scan(x, sorted_ids,
                                                          segs, policy=p))):
            for p in ("tile", "baseline"):
                times[f"{op} {p}"] = smoke.time_ms(lambda p=p, fn=fn: fn(p))
        # bytes: x and ids read once, the output written once; the
        # function's work is one add an element
        io = nbytes(x, ids)
        bounds = {"reduce": bound(io + 4 * counts.numel(), x.numel(),
                                  torch.float32)[0],
                  "scan": bound(io + nbytes(x), x.numel(),
                                torch.float32)[0]}
        rec = dict(label=label, checks=checks, scan_max_abs_err=err,
                   scan_tol=tol, ms=times, bound_ms=bounds)
        rows.append(rec)
        print(f"ragged [{label}]: {checks}; scan of random values "
              f"max_abs_err={err:.3e} (tol {tol:.3e}); ms (tile, baseline): "
              f"reduce {times['reduce tile']:.4f}, "
              f"{times['reduce baseline']:.4f}; scan "
              f"{times['scan tile']:.4f}, {times['scan baseline']:.4f}; "
              f"bound ms (bytes): reduce {bounds['reduce']:.5f}, scan "
              f"{bounds['scan']:.5f} ({smi_line()})", flush=True)
        for name, ok in checks.items():
            if not ok:
                smoke.fail(f"ragged [{label}]: {name} of tile and baseline "
                           "differ")
    # the guard inside a capture: no host read, NaN for unsorted ids
    x = torch.randn(4, 936, generator=gen, device="cuda")
    good = torch.randint(0, 128, (4, 936), generator=gen,
                         device="cuda").sort(dim=-1).values
    bad = good.flip(-1)
    try:
        ragged.tcu_ragged_segment_scan(x, bad, 128, debug=True)
        smoke.fail("ragged: guard_contiguous did not raise on unsorted ids "
                   "outside a capture")
    except ValueError:
        pass
    eager = ragged.tcu_ragged_segment_scan(x, good, 128, debug=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_bad = ragged.tcu_ragged_segment_scan(x, bad, 128, debug=True)
        out_good = ragged.tcu_ragged_segment_scan(x, good, 128, debug=True)
    graph.replay()
    torch.cuda.synchronize()
    guard = dict(bad_all_nan=bool(out_bad.isnan().all()),
                 good_equals_eager=bool(torch.equal(out_good, eager)))
    print(f"ragged: guard_contiguous under a CUDA graph's capture {guard}",
          flush=True)
    if not all(guard.values()):
        smoke.fail(f"ragged: guard_contiguous under capture {guard}")
    counts = kops.launch_counts()
    if counts["tcu_scan"] != len(RAGGED):
        smoke.fail(f"ragged: {counts['tcu_scan']} tcu_scan launches, want "
                   f"{len(RAGGED)} (the offsets)")
    return {"launches": counts, "cases": rows, "guard": guard}


KINDS = ("flash_attention", "ssd_scan", "local_ssd", "rmsnorm", "gemm")
# tcu_reduce.cu's kernels, kind "reduce", and tcu_scan.cu's, kind "scan"
# (torch's own reductions and scans are "other")
REDUCE_KERNELS = ("piece_totals", "tcu_reduce_combine")
SCAN_KERNELS = ("piece_scan", "tcu_scan_carry")
PRELUDE_SPINS = 16


def kernel_events(torch, fn) -> list | None:
    """(name, launches, device ms) of each kernel that one call of ``fn``
    runs, from ``torch.profiler``'s kernel events (a CUDA graph's replayed
    kernels among them); None when the profiler fails here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()        # nothing earlier still running
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a prelude of short spins, left out of the result: profiles
            # whose first work was a graph replay have lost up to 7 of its
            # kernel records
            for _ in range(PRELUDE_SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError as exc:
        print(f"profiler: {exc!r}", flush=True)
        return None
    # kernels only: a host op's device time repeats them
    return [(e.key, e.count, getattr(e, "self_device_time_total", getattr(
        e, "self_cuda_time_total", 0.0)) / 1e3)
        for e in events if e.device_type == DeviceType.CUDA
        and "spin_kernel" not in e.key]


def kind_of(name: str) -> str:
    """This repository's kernels by name (``tcu_reduce.cu``'s as
    ``reduce``, ``tcu_scan.cu``'s as ``scan``), matrix products
    (cuBLAS/CUTLASS kernels) as ``gemm``, the rest as ``other``."""
    name = name.lower()
    if any(k in name for k in REDUCE_KERNELS):
        return "reduce"
    if any(k in name for k in SCAN_KERNELS):
        return "scan"
    kind = next((k for k in KINDS if k in name), None)
    if kind is None and any(t in name for t in ("gemm", "xmma", "cutlass",
                                                 "nvjet")):
        kind = "gemm"
    return kind or "other"


def split_by_kind(events) -> dict | None:
    """Device ms of ``kernel_events`` by ``kind_of`` each kernel. A
    diagnostic: None, printed as not measured, when the profiler saw no
    device time."""
    split = dict.fromkeys((*KINDS, "reduce", "scan", "other"), 0.0)
    for name, _, ms in events or ():
        split[kind_of(name)] += max(ms, 0.0)
    if sum(split.values()) <= 0:
        return None
    return {k: round(v, 4) for k, v in split.items()}


def device_split(torch, fn) -> dict | None:
    """Device time of one call of ``fn`` by kind of kernel."""
    return split_by_kind(kernel_events(torch, fn))


def chrome_trace(profile_dir: Path) -> list:
    """The events of the one Chrome trace ``obs.profiling.tracing`` wrote
    into ``profile_dir``."""
    (path,) = profile_dir.glob("*.pt.trace.json")
    return json.loads(path.read_text())["traceEvents"]


def launching_ops(events) -> dict:
    """For each kernel record of a Chrome trace, by correlation id, the
    innermost CPU op around its launch (None outside any op)."""
    ops: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    ops = {key: sorted(v) for key, v in ops.items()}
    starts = {key: [o[0] for o in v] for key, v in ops.items()}
    out = {}
    for e in events:
        if e.get("cat") != "cuda_runtime" or "correlation" not in e.get(
                "args", {}):
            continue
        key, ts = (e["pid"], e["tid"]), e["ts"]
        found = None
        # the innermost op around ts is the latest-starting one that ends
        # after ts
        for j in range(bisect.bisect_right(starts.get(key, []), ts) - 1,
                       -1, -1):
            if ops[key][j][1] >= ts:
                found = ops[key][j][2]
                break
        out[e["args"]["correlation"]] = found
    return out


def other_by_op(fn, label: str, top: int = 10) -> dict:
    """Device ms of the "other" kernels (``kind_of``) of one call of ``fn``
    (warmed up), traced through ``repro_torch.obs.profiling.tracing``, by
    the CPU op that launched each (its kernel's name where no op was around
    the launch): the ``top`` largest and their total."""
    from repro_torch.obs import profiling

    out_dir = OBS_DIR / label
    shutil.rmtree(out_dir, ignore_errors=True)
    with profiling.tracing(str(out_dir)):
        fn()
    events = chrome_trace(out_dir)
    launcher = launching_ops(events)
    by_op: dict = {}
    for e in events:
        if e.get("cat") != "kernel" or "spin_kernel" in e["name"] or \
                kind_of(e["name"]) != "other":
            continue
        op = launcher.get(e.get("args", {}).get("correlation")) or \
            f"(no op) {e['name'][:60]}"
        n, ms = by_op.get(op, (0, 0.0))
        by_op[op] = (n + 1, ms + e["dur"] / 1e3)
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1][1])
    return {"other_ms": round(sum(ms for _, ms in by_op.values()), 4),
            "top": [(op, n, round(ms, 4)) for op, (n, ms) in ranked[:top]]}


# the runs of the served main path, each with its counts read on their own:
# (model, policy, the kernel it runs once per layer per prefill, a kernel
# the run must not launch)
SERVED = (("mamba2-1.3b", None, "ssd_scan", "matmul_local_ssd"),
          ("llama3.2-1b", None, "flash_attention", None),
          ("mamba2-1.3b", "ssd=tile_logdepth", "matmul_local_ssd",
           "ssd_scan"),
          ("qwen3-moe-235b-a22b", None, "flash_attention", None),
          ("grok-1-314b", None, "flash_attention", None),
          # cut (CUTS): flash attention in each use of the shared block is
          # gated beside the SSD by forward_launches
          ("zamba2-2.7b", None, "ssd_scan", "matmul_local_ssd"),
          # the last dense configs: internlm2-20b and deepseek-67b cut
          # (CUTS), h2o-danube-3-4b whole (head dim 120 and its window of
          # 4096, which the served prompts stay inside)
          ("internlm2-20b", None, "flash_attention", None),
          ("deepseek-67b", None, "flash_attention", None),
          ("h2o-danube-3-4b", None, "flash_attention", None))
# the models served at their published widths with their depth cut to fit
# the card's 80 GB: qwen3-moe's 94 layers of 2.488 B parameters are 468 GB
# in bf16, grok-1's 64 of 4.92 B 630 GB, deepseek-67b's 95 of 0.69 B 134.9
# GB; and, to keep the script inside its time limit as the sharded phase
# grew (PR 30), zamba2 at 12 of 54 layers (two uses of the shared block)
# and internlm2 at 24 of 48
CUTS = {"qwen3-moe-235b-a22b": 4, "grok-1-314b": 2, "deepseek-67b": 4,
        "zamba2-2.7b": 12, "internlm2-20b": 24}
# mamba2's depth in its runs beside the default wave and continuous ones,
# which serve it whole (cut to keep the script inside its time limit as the
# sharded phase grew, PR 30): the wave under ssd=tile_logdepth (a launch a
# layer is what it holds) and the multi-turn runs (prefix sharing is per
# slot)
MAMBA_CUT_LAYERS = 8
# the logit gates take the served model whole where its f32 copy is at most
# this, else its first PARITY_LAYERS layers (internlm2-20b is 79 GB in f32,
# qwen3-moe's 4 layers 45 GB)
F32_GATE_BYTES = 40e9


def full_engine(serve, arch: str, layers: int | None = None, **kw):
    """A serving engine of ``arch`` at its published widths, random weights
    from seed 0: ``serve.build_engine``'s FULL, or at ``layers`` layers (by
    default ``CUTS[arch]`` for a model there) its recipe on the FULL config
    cut to that depth."""
    layers = layers or CUTS.get(arch)
    if layers is None:
        return serve.build_engine(arch, "full", device="cuda", seed=0, **kw)
    import torch

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    full = configs.get(arch).FULL
    bundle = build(dataclasses.replace(full, n_layers=layers))
    print(f"serve: {arch} cut to {layers} of {full.n_layers} "
          f"layers at its published widths: {bundle.n_params / 1e9:.2f}B of "
          f"{build(full).n_params / 1e9:.2f}B parameters "
          f"({2 * bundle.n_params / 1e9:.1f} GB in bf16)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(bundle.params_pspec, gen, bundle.cfg.dtype)
    return ServingEngine(bundle, params, ServeConfig(seed=0, **kw))


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg``: each launches ``tcu_scan.cu`` once a
    forward (its capacity offsets)."""
    return cfg.n_layers if cfg.family == "moe" else 0


def forward_launches(cfg, policy: str | None = None,
                     prefill: bool = True) -> dict:
    """Kernel launches of one forward of ``cfg`` by family, L its layers and
    G the hybrid's groups (its shared block's uses; 0 elsewhere): RMSNorm
    two a layer, two a use of the shared block and the final norm (2L + 2G
    + 1), ``tcu_scan`` one a MoE layer, and in a prefill (the wave's
    ``lm_apply``) the layer kernels: flash attention one an attention layer
    or a use of the shared block, the SSD one a Mamba layer
    (``matmul_local_ssd`` under ``ssd=tile_logdepth``). A decode step and a
    continuous tick run decode attention and the SSD recurrence as torch
    ops: RMSNorm and ``tcu_scan`` only. The encoder-decoder (E encoder, D
    decoder layers): a prefill RMSNorm 2E + 1 + 3D + 1 and flash attention
    E + 2D (the encoder's, the decoder's self- and cross-attention), a
    decode step RMSNorm 3D + 1."""
    from repro_torch.models.lm import ATTN_FAMILIES, STATE_FAMILIES, n_groups

    if cfg.family == "encdec":
        enc, dec = cfg.enc_layers, cfg.n_layers
        if not prefill:
            return {"rmsnorm": 3 * dec + 1, "tcu_scan": 0}
        return {"rmsnorm": 2 * enc + 3 * dec + 2, "tcu_scan": 0,
                "flash_attention": enc + 2 * dec, "ssd_scan": 0}
    layers, groups = cfg.n_layers, n_groups(cfg)
    out = {"rmsnorm": 2 * layers + 2 * groups + 1,
           "tcu_scan": moe_layers(cfg)}
    if prefill:
        ssd = ("matmul_local_ssd" if policy and "ssd=tile_logdepth" in policy
               else "ssd_scan")
        out["flash_attention"] = (layers if cfg.family in ATTN_FAMILIES
                                  else groups)
        out[ssd] = layers if cfg.family in STATE_FAMILIES else 0
    return out


def gate_depth(cfg) -> int:
    """The depth the logit gates run at: the whole model where its f32 copy
    takes at most ``F32_GATE_BYTES``, else its first ``PARITY_LAYERS``
    layers, whose f32 copy fits beside nothing else (qwen3-moe's 2 layers
    are 24.9 GB in f32)."""
    from repro_torch.models import build

    if 4 * build(cfg).n_params <= F32_GATE_BYTES:
        return cfg.n_layers
    return min(cfg.n_layers, PARITY_LAYERS)


def first_layers(params, depth: int):
    """The parameters of a decoder-only model's first ``depth`` layers."""
    return dict(params, blocks=params["blocks"][:depth])


@contextlib.contextmanager
def routing(torch, sink: list):
    """Record in ``sink`` each MoE layer's expert choices (the forward's only
    ``torch.topk`` calls), as (tokens, k) rows sorted within each token."""
    real = torch.topk

    def topk(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append(out.indices.sort(dim=-1).values.reshape(
            -1, out.indices.shape[-1]))
        return out

    torch.topk = topk
    try:
        yield sink
    finally:
        torch.topk = real


def routing_flips(a: list, b: list) -> tuple[int, int]:
    """(token-layer pairs, tokens) whose top-k expert set differs between
    two recorded forwards of the same tokens."""
    if not a:
        return 0, 0
    diff = [(x != y).any(-1) for x, y in zip(a, b)]
    return (sum(int(d.sum()) for d in diff),
            int(sum(d.long() for d in diff).gt(0).sum()))


def wave_tokens(torch, reqs):
    """The requests' prompts as one batch on the card, left-padded to the
    longest, as the wave scheduler lays them out."""
    plen = max(len(r.prompt) for r in reqs)
    tokens = torch.zeros((len(reqs), plen), dtype=torch.long)
    for i, r in enumerate(reqs):
        tokens[i, plen - len(r.prompt):] = torch.from_numpy(
            r.prompt.astype("int64"))
    return tokens.cuda()


def batch_text(batch) -> str:
    bsz, plen = batch["tokens"].shape
    stub = batch.get("stub")
    return f"B={bsz} " + ("" if stub is None else
                          f"stub {stub.shape[1]} + ") + f"L={plen}"


def as_dtype(batch, dtype):
    """``batch`` with its floating inputs (a VLM's stub) in ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def prefill_fn(cfg, batch, path, dtype, params, depth=None):
    """One ``prefill_last`` of ``cfg`` under ``path`` in ``dtype`` at
    ``depth`` layers (all by default): its last-token logits in f32."""
    from repro_torch.models import build

    bundle = build(dataclasses.replace(
        cfg, policy=path, dtype=dtype, n_layers=depth or cfg.n_layers))
    batch = as_dtype(batch, dtype)
    return lambda: bundle.prefill_last(params, batch)[0].float()


def prefill_timing(smoke: Smoke, cfg, params, batch, policy: str | None,
                   tag: str, label: str) -> dict:
    """The prefill of ``batch`` on the kernels (device time) and on the
    plain versions, its device time by kind, and its "other" kernels by the
    op that launched them."""
    torch = smoke.torch
    kern = prefill_fn(cfg, batch, policy, cfg.dtype, params)
    plain = prefill_fn(cfg, batch, "baseline", cfg.dtype, params)
    prefill_ms = smoke.time_ms(kern, max_iters=5)
    spread = smoke.spread
    plain_ms = smoke.time_ms(plain, max_iters=3)
    split = device_split(torch, kern)
    other = other_by_op(kern, label)
    print(f"{tag}: prefill device ms of the 'other' kernels by the op that "
          f"launched them (obs.profiling.tracing, one prefill; "
          f"{smi_line()}): total {other['other_ms']}, largest "
          f"{other['top']}", flush=True)
    print(f"{tag}: prefill {batch_text(batch)}: {prefill_ms:.2f} ms on the "
          f"kernels (device time; min {spread['min']:.2f} max "
          f"{spread['max']:.2f}"
          f"{', HOST-BOUND' if spread['host_bound'] else ''}), "
          f"{plain_ms:.2f} ms on the plain versions; device time by kind "
          f"(torch.profiler, one prefill): "
          f"{split if split else 'not measured'}", flush=True)
    return dict(prefill_ms=prefill_ms, plain_prefill_ms=plain_ms,
                prefill_device_ms_by_kind=split,
                prefill_other_ms_by_op=other)


def decode_timing(smoke: Smoke, bundle, params, batch, tag: str,
                  n_steps: int = 15, n_prof: int = 5) -> dict:
    """Decode steps from the prefill of ``batch``, each on the host clock,
    against the device time of their kernels: the card's idle share during
    decode. The cache grows by a row a step, but never past a sliding
    window: a ring of the window's rows takes every position."""
    from repro_torch.models.lm import pad_cache_seq

    torch = smoke.torch
    _, cache = bundle.prefill_last(params, batch)
    grow, window = 1 + n_steps + n_prof, bundle.cfg.swa_window
    if window is not None and "attn" in cache:
        rows = cache["attn"]["k"].shape[2]
        grow = max(0, min(rows + grow, window) - rows)
    cache = pad_cache_seq(cache, grow)
    step = {"tokens": batch["tokens"][:, -1:]}

    def decode():
        bundle.decode(params, cache, step)

    decode()
    torch.cuda.synchronize()
    step_times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        step_times.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(step_times)
    dsplit = device_split(torch, lambda: [decode() for _ in range(n_prof)])
    if dsplit:
        dsplit = {k: round(v / n_prof, 4) for k, v in dsplit.items()}
    busy = sum(dsplit.values()) if dsplit else None
    idle = None if busy is None else [1.0 - busy / t for t in (
        step_ms, min(step_times), max(step_times))]
    print(f"{tag}: decode step {step_ms:.3f} ms on the host clock (median "
          f"of {n_steps}, min {min(step_times):.3f} max "
          f"{max(step_times):.3f}); device time per step by kind (mean of "
          f"{n_prof}) {dsplit if dsplit else 'not measured'}; idle share of "
          f"the card {'not measured' if idle is None else f'{idle[0]:.3f}'}"
          f"{'' if idle is None else f' ({idle[1]:.3f} to {idle[2]:.3f})'}",
          flush=True)
    return dict(decode_step_ms=step_ms, decode_step_ms_min=min(step_times),
                decode_step_ms_max=max(step_times),
                decode_device_ms_by_kind=dsplit,
                decode_idle_share=None if idle is None else idle[0],
                decode_idle_share_range=None if idle is None else idle[1:])


def logit_gates(smoke: Smoke, cfg, box: list, batch, policy: str | None,
                depth: int, tag: str) -> dict:
    """The last-token logits of the prefill of ``batch`` at ``depth``
    layers, kernels against plain versions, in ``cfg.dtype`` on the weights
    in ``box`` (a one-element list, emptied so that those weights are freed
    before their f32 copy is made) and in f32, and the f32 logits of two
    decode steps from the prefill's cache. Fails the run where they
    disagree."""
    from repro_torch.models import build
    from repro_torch.models.common import cast_tree
    from repro_torch.models.lm import pad_cache_seq

    torch = smoke.torch
    params = box.pop()

    def decoded(path, params, steps=2):
        """Logits of ``steps`` f32 decode steps from the prefill's cache:
        the state handed from prefill to decode is in them."""
        bundle = build(dataclasses.replace(
            cfg, policy=path, dtype=torch.float32, n_layers=depth))
        _, cache = bundle.prefill_last(params, as_dtype(batch, torch.float32))
        cache = pad_cache_seq(cache, steps)
        for _ in range(steps):
            logits, cache = bundle.decode(
                params, cache, {"tokens": batch["tokens"][:, -1:]})
        return logits.float()

    routes = {k: [] for k in ("bf16", "bf16 plain", "f32", "f32 plain")}
    with routing(torch, routes["bf16"]):
        got = prefill_fn(cfg, batch, policy, cfg.dtype, params, depth)()
    with routing(torch, routes["bf16 plain"]):
        want = prefill_fn(cfg, batch, "baseline", cfg.dtype, params, depth)()
    params = cast_tree(params, torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    # the same weights in f32 on both paths: kernels and plain versions
    # agree to about 1e-6 per op, so every layer stack of the port stays
    # within 1e-3 of the largest logit
    with routing(torch, routes["f32"]):
        got32 = prefill_fn(cfg, batch, policy, torch.float32, params, depth)()
    with routing(torch, routes["f32 plain"]):
        want32 = prefill_fn(cfg, batch, "baseline", torch.float32, params,
                            depth)()
    err32 = (got32 - want32).abs().max().item()
    tol32 = 1e-3 * want32.abs().max().item()
    dec_got = decoded(policy, params)
    dec_want = decoded("baseline", params)
    del params
    dec_err = (dec_got - dec_want).abs().max().item()
    dec_tol = 1e-3 * dec_want.abs().max().item()
    # bf16: every norm and every SSD or attention output of a forward
    # rounds to bf16, and the two paths may round a value one ulp apart. The
    # bf16 tolerance is the bf16 error of the plain path itself, measured
    # against its f32 run, twice over: two bf16 results each that far from
    # the f32 one are at most twice that far apart.
    noise = (want - want32).abs().max().item()
    err = (got - want).abs().max().item()
    tol = 2.0 * noise
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    flips = {dt: routing_flips(routes[dt], routes[f"{dt} plain"])
             for dt in ("f32", "bf16")}
    print(f"{tag}: last-token logits at {depth} of {cfg.n_layers} layers, "
          f"kernels vs plain versions: f32 "
          f"max_abs_err={err32:.4e} (tol {tol32:.4e}); bf16 max_abs_err="
          f"{err:.4e} (tol {tol:.4e} = 2 x the plain bf16 run's distance "
          f"from f32); kernels bf16 vs plain f32 "
          f"{(got - want32).abs().max().item():.4e}; max |logit| "
          f"{want32.abs().max().item():.3f}; argmax agreement {agree:.2f}; "
          f"f32 logits after 2 decode steps from the prefill's cache "
          f"max_abs_err={dec_err:.4e} (tol {dec_tol:.4e})"
          + ("" if not moe_layers(cfg) else
             f"; tokens whose top-{cfg.experts_per_tok} experts differ "
             f"between the kernel and the plain path (token-layer pairs, "
             f"tokens of {batch['tokens'].numel()}): f32 {flips['f32']}, "
             f"bf16 {flips['bf16']}"), flush=True)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(got32).all()
                  and torch.isfinite(dec_got).all())
    if not (err32 <= tol32 and err <= tol and dec_err <= dec_tol
            and finite):
        smoke.fail(f"{tag}: logits disagree with the plain model: prefill "
                   f"f32 {err32} (tol {tol32}), bf16 {err} (tol {tol}); "
                   f"decode f32 {dec_err} (tol {dec_tol})")
    out = dict(gate_layers=depth,
               logits_f32_max_abs_err=err32, logits_f32_tol=tol32,
               logits_bf16_max_abs_err=err, logits_bf16_tol=tol,
               decode_logits_f32_max_abs_err=dec_err,
               decode_logits_f32_tol=dec_tol)
    if moe_layers(cfg):
        out["routing_flips"] = flips
    return out


def serve_pass(smoke: Smoke, serve, kops, arch: str, policy: str | None,
               per_layer: str, absent: str | None):
    """``arch`` FULL (MoE: its depth cut) through the serving engine under
    ``policy``; returns its numbers."""
    torch = smoke.torch
    engine = full_engine(
        serve, arch, policy=policy, slots=4, max_new=16, scheduler="wave",
        layers=MAMBA_CUT_LAYERS if policy == "ssd=tile_logdepth" else None)
    cfg = engine.bundle.cfg
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"{engine.bundle.n_params / 1e9:.3f}B params {cfg.dtype}, "
          f"policy={policy}, scheduler=wave, 4 slots", flush=True)
    # warm-up: one short request (cuBLAS handles, allocator)
    engine.run(serve.make_requests(1, 16, cfg.vocab, seed=1))
    reqs = serve.make_requests(4, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.prefills = engine.decodes = 0
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    instances = kops.instance_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(r.tokens) for r in results)
    first = min(r.first_token_s for r in results)
    last = max(r.finish_s for r in results)
    ttft = [1e3 * (r.first_token_s - r.arrival_s) for r in results]
    stats = dict(
        requests=len(results), prompt_lens=[r.prompt_len for r in results],
        tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
        first_token_s=first, ttft_ms_median=statistics.median(ttft),
        ttft_ms_max=max(ttft),
        decode_ms_per_token=(1e3 * (last - first) / max(engine.decodes, 1)),
        prefills=engine.prefills, decodes=engine.decodes,
        peak_mem_gb=peak_gb, launches=counts)
    print(f"serve: {len(results)} requests, prompt lens "
          f"{stats['prompt_lens']}, {n_tok} tokens in {wall:.3f}s "
          f"({stats['tok_per_s']:.2f} tok/s), first token at "
          f"{1e3 * first:.1f} ms (TTFT median {stats['ttft_ms_median']:.1f} "
          f"max {stats['ttft_ms_max']:.1f} ms), decode "
          f"{stats['decode_ms_per_token']:.2f} ms/step, peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"serve: launches {counts} over {engine.prefills} prefill(s) and "
          f"{engine.decodes} decode step(s); SSD instances "
          f"{instance_text(instances)}", flush=True)
    fma = {k: n for (k, i), n in instances.items() if i == "fma"}
    if fma:
        smoke.fail(f"serve: {fma} SSD launches on the FMA instance, want "
                   f"every {cfg.dtype} launch on the tensor cores")
    if any(len(r.tokens) == 0 for r in results):
        smoke.fail("serve: a request produced no tokens")
    if policy is None:
        DEFAULT_TOKENS[arch] = [r.tokens for r in results]
    per_prefill = forward_launches(cfg, policy)
    per_step = forward_launches(cfg, policy, prefill=False)
    want = {k: n * engine.prefills + per_step.get(k, 0) * engine.decodes
            for k, n in per_prefill.items()}
    if counts[per_layer] != want[per_layer] or engine.prefills < 1:
        smoke.fail(f"serve: {counts[per_layer]} {per_layer} launches, want "
                   f"{want[per_layer]} ({per_prefill[per_layer]} per "
                   "prefill)")
    if absent is not None and counts[absent]:
        smoke.fail(f"serve: {counts[absent]} {absent} launches under "
                   f"policy {policy!r}, want 0")
    if counts["rmsnorm"] < want["rmsnorm"]:
        smoke.fail(f"serve: {counts['rmsnorm']} RMSNorm launches, want >= "
                   f"{want['rmsnorm']} ({per_step['rmsnorm']} per forward)")
    for k in ("tcu_scan", "flash_attention"):
        if counts[k] != want[k]:
            smoke.fail(f"serve: {counts[k]} {k} launches, want {want[k]} "
                       f"({per_prefill[k]} a prefill, {per_step.get(k, 0)} "
                       "a decode step)")

    # prefill, kernels against plain versions, on the served wave's batch
    batch = {"tokens": wave_tokens(torch, reqs)}
    stats.update(prefill_timing(
        smoke, cfg, engine.params, batch, policy, "serve",
        f"prefill-{arch}-{policy or 'tile'}".replace("=", "_")))
    stats.update(decode_timing(smoke, engine.bundle, engine.params, batch,
                               "serve"))
    # the logit gates, at gate_depth (the served model, or the first
    # PARITY_LAYERS layers of one whose f32 copy does not fit), on the served
    # weights; the engine is freed before the f32 copy is made
    depth = gate_depth(cfg)
    box = [first_layers(engine.params, depth)]
    del engine
    stats.update(logit_gates(smoke, cfg, box, batch, policy, depth, "serve"))
    return stats


# the continuous scheduler's runs: the reference's default serving path,
# every tick one block step replayed from a CUDA graph
CONTINUOUS = ("mamba2-1.3b", "llama3.2-1b", "qwen3-moe-235b-a22b",
              "zamba2-2.7b", "h2o-danube-3-4b")


def clone_tree(tree):
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def named_shapes(tree_items) -> dict:
    """``tree.items`` pairs -> {"attn/k": [shape], ...} of the tensors."""
    return {"/".join(re.findall(r"[\w.-]+", k)): list(v.shape)
            for k, v in tree_items if hasattr(v, "shape")}


def tree_max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max(tree_max_diff(a[k], b[k]) for k in a)
    return (a.float() - b.float()).abs().max().item()


def ms_text(values) -> str:
    if not values:
        return "none"
    return (f"{statistics.median(values):.3f} ({min(values):.3f}-"
            f"{max(values):.3f}, n={len(values)})")


def record_ticks(engine, keep_logits: bool = False) -> list:
    """Wrap the engine's block step and sampling: each tick appends (T, host
    ms from the step's inputs to the fetched tokens, inputs, logits)."""
    ticks, cur = [], {}
    step, sample = engine._block_step, engine._sample

    def timed_step(inputs):
        cur.update(t0=time.perf_counter(),
                   inputs={k: np.array(v) for k, v in inputs.items()})
        logits = step(inputs)
        cur["logits"] = logits.float().clone() if keep_logits else None
        return logits

    def timed_sample(logits):
        out = sample(logits)
        if "t0" in cur:
            ticks.append((cur["inputs"]["tokens"].shape[1],
                          1e3 * (time.perf_counter() - cur.pop("t0")),
                          cur.pop("inputs"), cur.pop("logits")))
        return out

    engine._block_step, engine._sample = timed_step, timed_sample
    return ticks


def device_inputs(torch, inputs: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v, np.int64)).cuda()
            for k, v in inputs.items()}


def eager_on(torch, engine, cache, inputs: dict):
    """The engine's eager block step on ``cache`` (a clone of its own)."""
    own, engine._cache = engine._cache, cache
    try:
        return engine._eager_step(device_inputs(torch, inputs))
    finally:
        engine._cache = own


def measured_run(smoke: Smoke, kops, engine, reqs, warm, label: str,
                 keep_logits: bool = False) -> dict:
    """A warm-up run of ``warm`` (it captures the step's graphs), then the
    measured run of ``reqs`` with every launch count set to 0 just before
    it, which must capture no graph. Returns its numbers."""
    torch = smoke.torch
    engine.run(warm)
    graphs = engine.compile_stats()
    ticks = record_ticks(engine, keep_logits)
    first_tick, trace_from = engine.ticks, len(engine.trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    captured = engine.compile_stats()["block"] - graphs["block"]
    if captured:
        smoke.fail(f"{label}: the measured run captured {captured} graph(s),"
                   " want 0")
    n_tok = sum(len(r.tokens) for r in results)
    return dict(
        results=results, ticks=ticks, counts=counts, wall=wall,
        events=engine.trace[trace_from:], first_tick=first_tick,
        n_ticks=engine.ticks - first_tick, graphs=graphs,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, n_tok=n_tok,
        ttft=[1e3 * (r.first_token_s - r.arrival_s) for r in results],
        by_t={t: [ms for tt, ms, *_ in ticks if tt == t] for t in (16, 1)})


def run_text(m: dict) -> str:
    """tok/s, TTFT, ticks and host ms a tick of a ``measured_run``."""
    by_t = m["by_t"]
    return (f"{len(m['results'])} requests, {m['n_tok']} tokens in "
            f"{m['wall']:.3f}s ({m['n_tok'] / m['wall']:.2f} tok/s); TTFT ms "
            f"median {statistics.median(m['ttft']):.1f} max "
            f"{max(m['ttft']):.1f}; {m['n_ticks']} ticks ({len(by_t[16])} of "
            f"T=16, {len(by_t[1])} of T=1); host ms a tick (inputs to "
            f"fetched tokens), median (min-max): T=16 {ms_text(by_t[16])}, "
            f"T=1 {ms_text(by_t[1])}")


def run_stats(m: dict) -> dict:
    """The JSON numbers of a ``measured_run``."""
    return dict(
        requests=len(m["results"]),
        prompt_lens=[r.prompt_len for r in m["results"]], tokens=m["n_tok"],
        wall_s=m["wall"], tok_per_s=m["n_tok"] / m["wall"],
        ttft_ms=m["ttft"], ttft_ms_median=statistics.median(m["ttft"]),
        ttft_ms_max=max(m["ttft"]), ticks=m["n_ticks"],
        ticks_by_t={t: len(v) for t, v in m["by_t"].items()},
        tick_ms=m["by_t"], peak_mem_gb=m["peak_gb"], launches=m["counts"])


def rmsnorms(events) -> int:
    return sum(n for name, n, _ in events or () if "rmsnorm" in name.lower())


def profiled_replays(smoke: Smoke, engine, inputs: dict, label: str,
                     norms: int) -> dict:
    """Three replayed ticks of each T, each under its own profiler: a replay
    launches the same kernels every time, but the profiler may drop a
    kernel record (96 of 97 once), so the gate reads the largest RMSNorm
    count. Returns the kernel events of that profile by T."""
    torch = smoke.torch

    def tick(t_len):
        logits = engine._graphs[t_len].replay(inputs[t_len])
        return torch.argmax(logits, dim=-1).cpu()

    profiled = {t: [kernel_events(torch, lambda t=t: tick(t))
                    for _ in range(3)] for t in inputs}
    per_replay = {t: [rmsnorms(ev) for ev in evs]
                  for t, evs in profiled.items()}
    kernels = {t: [sum(n for _, n, _ in ev or ()) for ev in evs]
               for t, evs in profiled.items()}
    if any(max(n) != norms for n in per_replay.values()):
        smoke.fail(f"{label}: torch.profiler saw {per_replay} RMSNorm "
                   f"launches in replayed ticks (of {kernels} kernels), "
                   f"want {norms}")
        for t, evs in profiled.items():
            print(f"profiler, {label}, T={t}: kernels by name "
                  f"{sorted((name[:80], n) for name, n, _ in evs[0] or ())}",
                  flush=True)
    return {"per_replay": per_replay, "kernels": kernels,
            "events": {t: max(evs, key=rmsnorms)
                       for t, evs in profiled.items()}}


def weight_floor(params) -> dict:
    """The parameter bytes a forward reads, all and the experts' (every
    expert runs in a block step: the grouped products take them all), and
    each over the card's memory rate: a floor under a T = 1 tick."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        if isinstance(tree, list):
            return [t for v in tree for t in leaves(v)]
        return [tree]

    # the embedding is gathered a row a token; an untied head is read whole
    read = {k: v for k, v in params.items()
            if k != "embed" or "head" not in params}
    experts = [t for blk in params["blocks"] if "moe" in blk
               for name, t in blk["moe"].items() if name != "router"]
    out = {}
    for key, ts in (("all", leaves(read)), ("experts", experts)):
        out[f"{key}_gb"] = nbytes(*ts) / 1e9
        out[f"{key}_floor_ms"] = nbytes(*ts) / HBM_BYTES_PER_S * 1e3
    return out


def continuous_pass(smoke: Smoke, serve, kops, arch: str, ring_ref: dict):
    """``arch`` FULL (MoE: its depth cut) under the continuous scheduler: 8
    requests of up to 512 prompt tokens on 4 slots, chunks of 16; returns
    its numbers and leaves the bf16 run's tokens and logits by tick in
    ``ring_ref[arch]``."""
    from repro_torch.models import build_lm
    from repro_torch.models.common import cast_tree
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    torch = smoke.torch
    engine = full_engine(serve, arch, slots=4, max_new=16,
                         scheduler="continuous", prefill_chunk=16)
    cfg = engine.bundle.cfg
    tick = forward_launches(cfg, prefill=False)
    norms, scans = tick["rmsnorm"], tick["tcu_scan"]
    print(f"serve: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
          f"scheduler=continuous, 4 slots, prefill_chunk 16", flush=True)
    reqs = serve.make_requests(8, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    # warm-up: the longest prompt alone, so the same capacity bucket; it
    # captures the T = 16 and T = 1 graphs
    longest = max(reqs, key=lambda r: len(r.prompt))
    m = measured_run(smoke, kops, engine, reqs,
                     [Request(uid=-1, prompt=longest.prompt, max_new=16)],
                     f"continuous {arch}", keep_logits=True)
    graphs, counts, by_t = m["graphs"], m["counts"], m["by_t"]
    if graphs["block"] != 2:
        smoke.fail(f"continuous {arch}: warm-up captured {graphs['block']} "
                   "graphs, want 2 (T = 16 and T = 1)")
    results, events, ticks = m["results"], m["events"], m["ticks"]
    ring_ref[arch] = ({r.uid: r.tokens for r in results},
                      [(ins, lg) for _, _, ins, lg in ticks])
    admits = [e for e in events if e["event"] == "admit"]
    finishes = [e for e in events if e["event"] == "finish"]
    refills = [e for e in admits if e["tick"] > m["first_tick"]]
    print(f"serve: {run_text(m)}; prompt lens "
          f"{[r.prompt_len for r in results]}; {len(admits)} admits"
          f" ({len(refills)} refills), {len(finishes)} finishes; graphs "
          f"{engine.compile_stats()['block']}, captured in "
          f"{graphs['capture_s']:.2f}s; peak memory {m['peak_gb']:.2f} GB; "
          f"launches {counts}", flush=True)
    if len(admits) != 8 or len(finishes) != 8 or len(refills) < 4:
        smoke.fail(f"continuous {arch}: {len(admits)} admits, "
                   f"{len(finishes)} finishes, {len(refills)} refills; want "
                   "8, 8 and >= 4")
    if len(results) != 8 or any(len(r.tokens) == 0 for r in results):
        smoke.fail(f"continuous {arch}: a request produced no tokens")
    if counts["rmsnorm"] != norms * m["n_ticks"]:
        smoke.fail(f"continuous {arch}: {counts['rmsnorm']} RMSNorm launches "
                   f"counted, want {norms} x {m['n_ticks']} ticks")
    if counts["tcu_scan"] != scans * m["n_ticks"]:
        smoke.fail(f"continuous {arch}: {counts['tcu_scan']} tcu_scan "
                   f"launches counted, want {scans} x {m['n_ticks']} ticks")

    # one T = 16 and one T = 1 tick from the graph against the eager step
    # on a clone of the cache, with the same inputs
    gen = np.random.default_rng(5)
    cases = {16: (np.array([16, 5, 1, 0]), np.array([True, False, False,
                                                     False])),
             1: (np.array([1, 1, 1, 0]), np.zeros(4, bool))}
    inputs, replay_err = {}, {}
    for t_len, (n_valid, reset) in cases.items():
        tokens = gen.integers(3, cfg.vocab, (4, t_len))
        inputs[t_len] = engine._step_inputs(tokens, n_valid, reset, None)
        clone = clone_tree(engine._cache)
        got = engine._graphs[t_len].replay(inputs[t_len]).clone()
        want = eager_on(torch, engine, clone, inputs[t_len])
        live = torch.from_numpy(n_valid > 0).cuda()
        same = bool((got[live].argmax(-1) == want[live].argmax(-1)).all())
        replay_err[t_len] = ((got[live].float() - want[live].float())
                             .abs().max().item(),
                             tree_max_diff(engine._cache, clone))
        if not same:
            smoke.fail(f"continuous {arch}: T={t_len} graph replay and eager "
                       "step pick different tokens")
    print(f"serve: graph replay vs eager step, largest logit difference "
          f"(active slots) and cache difference: T=16 {replay_err[16]}, "
          f"T=1 {replay_err[1]}", flush=True)

    def graphed(t_len):
        def tick():
            logits = engine._graphs[t_len].replay(inputs[t_len])
            return torch.argmax(logits, dim=-1).cpu()
        return tick

    def eager_tick():
        logits = engine._eager_step(device_inputs(torch, inputs[1]))
        return torch.argmax(logits, dim=-1).cpu()

    prof = profiled_replays(smoke, engine, inputs, f"continuous {arch}",
                            norms)
    per_replay, events = prof["per_replay"], prof["events"]
    top = {t: [(name[:60], n, round(ms, 4)) for name, n, ms in sorted(
        events[t] or (), key=lambda r: -r[2])[:6]] for t in events}
    n_prof = 5
    split = {16: split_by_kind(events[16])}
    sp = device_split(torch, lambda: [graphed(1)() for _ in range(n_prof)])
    split[1] = (None if sp is None else
                {k: round(v / n_prof, 4) for k, v in sp.items()})
    print(f"serve: the largest kernels of a replayed tick (name, launches, "
          f"ms): T=16 {top[16]}; T=1 {top[1]}", flush=True)
    loop = {}
    for name, fn in (("graphed", graphed(1)), ("eager", eager_tick)):
        fn()
        times = []
        for _ in range(15):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        loop[name] = times
    busy1 = sum(split[1].values()) if split[1] else None
    idle = (None if busy1 is None or not by_t[1] else
            1.0 - busy1 / statistics.median(by_t[1]))
    floor = weight_floor(engine.params)
    print(f"serve: device ms a tick by kind (torch.profiler, replayed): "
          f"T=16 {split[16] or 'not measured'}; T=1 (mean of {n_prof}) "
          f"{split[1] or 'not measured'}; idle share of the T=1 ticks "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; RMSNorm "
          f"launches in three profiled replays {per_replay}; a T=1 tick "
          f"alone, host "
          f"ms: graphed {ms_text(loop['graphed'])}, eager "
          f"{ms_text(loop['eager'])}; the parameters a tick reads "
          f"{floor['all_gb']:.2f} GB, a floor of "
          f"{floor['all_floor_ms']:.3f} ms at 3.35 TB/s (experts "
          f"{floor['experts_gb']:.2f} GB, {floor['experts_floor_ms']:.3f} "
          f"ms)", flush=True)
    stats = dict(
        scheduler="continuous", **run_stats(m),
        admits=len(admits), refills=len(refills), finishes=len(finishes),
        graphs=engine.compile_stats()["block"],
        capture_s=graphs["capture_s"], rmsnorm_per_replay=per_replay,
        device_ms_by_kind=split, top_kernels=top, idle_share_t1=idle,
        replay_vs_eager=replay_err, t1_tick_ms_graphed=loop["graphed"],
        t1_tick_ms_eager=loop["eager"], weight_floor=floor)
    # f32 (at gate_depth): the engine on the kernels
    # against each request's prefill alone, and against the same engine on
    # the plain versions
    depth = gate_depth(cfg)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=depth)
    params32 = cast_tree(first_layers(engine.params, depth), torch.float32)
    del engine, m, ticks
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    for path in (None, "baseline"):
        eng = ServingEngine(build_lm(dataclasses.replace(cfg32, policy=path)),
                            params32, ServeConfig(slots=4, max_new=16,
                                                  prefill_chunk=16))
        rec = record_ticks(eng, keep_logits=True)
        res = eng.run(reqs)
        runs[path] = (eng, rec, res)
    eng, rec, res = runs[None]
    slot_of = {e["uid"]: e["slot"] for e in eng.trace
               if e["event"] == "admit"}
    # MoE capacity couples the tokens of a group: a tick's groups of 2
    # tokens fit any expert's capacity of 8, but a prompt alone (one group
    # of up to 255 tokens a capacity of 128) may drop some, so the prompt
    # alone is held at a capacity where no token drops (its error at the
    # served capacity is printed)
    alone = eng.bundle
    if moe_layers(cfg):
        alone = build_lm(dataclasses.replace(
            cfg32, capacity_factor=float(cfg.n_experts)))
    first_err, first_tol, served_err = 0.0, 0.0, 0.0
    for r in res:
        tick = r.admitted_tick + -(-r.prompt_len // 16) - 1
        got = rec[tick][3][slot_of[r.uid]]
        prompt = {"tokens": torch.from_numpy(
            reqs[r.uid].prompt.astype("int64"))[None].cuda()}
        want = alone.prefill_last(eng.params, prompt)[0][0, -1].float()
        first_err = max(first_err, (got - want).abs().max().item())
        first_tol = max(first_tol, 1e-3 * want.abs().max().item())
        if alone is not eng.bundle:
            served = eng.bundle.prefill_last(eng.params, prompt)[0][0, -1]
            served_err = max(served_err,
                             (got - served.float()).abs().max().item())
    plain_rec = runs["baseline"][1]
    path_err, path_tol, compared = 0.0, 0.0, 0
    for (_, _, ins, lg), (_, _, pins, plg) in zip(rec, plain_rec):
        if not same_inputs(ins, pins):
            break               # the token streams parted: stop comparing
        live = torch.from_numpy(ins["n_valid"] > 0).cuda()
        path_err = max(path_err, (lg[live] - plg[live]).abs().max().item())
        path_tol = max(path_tol, 1e-3 * plg[live].abs().max().item())
        compared += 1
    note = ("" if alone is eng.bundle else
            f", capacity for every token; at the served capacity "
            f"max_abs_err={served_err:.4e}")
    print(f"serve: f32 first-token logits, continuous engine vs each "
          f"request's prefill alone (B=1, kernels; {depth} of "
          f"{cfg.n_layers} layers): max_abs_err={first_err:.4e} (tol "
          f"{first_tol:.4e}{note}); f32 continuous engine, "
          f"kernels vs plain versions over {compared} of {len(rec)} ticks: "
          f"max_abs_err={path_err:.4e} (tol {path_tol:.4e})", flush=True)
    if not first_err <= first_tol:
        smoke.fail(f"continuous {arch}: first-token logits {first_err} from "
                   f"the prefill's (tol {first_tol})")
    if compared == 0 or not path_err <= path_tol:
        smoke.fail(f"continuous {arch}: kernels vs plain versions "
                   f"{path_err} (tol {path_tol}) over {compared} ticks")
    stats.update(first_token_f32_max_abs_err=first_err,
                 first_token_f32_tol=first_tol,
                 first_token_f32_served_capacity_err=served_err,
                 plain_f32_max_abs_err=path_err, plain_f32_tol=path_tol,
                 plain_f32_ticks_compared=compared)
    return stats


def same_inputs(a: dict, b: dict) -> bool:
    """Whether two ticks' block-step inputs are the same."""
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


# the paged KV pool: the continuous scheduler's other cache kind, on the
# same runs, then the traffic it is for
# (h2o-danube: the pool's window rounding runs, its 4096 rows a slot above
# the 1024-row capacity these requests need, which stay inside the window)
PAGED = ("mamba2-1.3b", "llama3.2-1b", "qwen3-moe-235b-a22b",
         "zamba2-2.7b", "h2o-danube-3-4b")


def warm_request(vocab: int, n: int):
    """A warm-up request of ``n`` tokens drawn apart from the measured ones,
    so that it shares no page with them."""
    from repro_torch.serving import Request

    rng = np.random.default_rng(12345)
    return Request(uid=-1, prompt=rng.integers(3, vocab, n, dtype=np.int32),
                   max_new=16)


def last_inputs(m: dict) -> dict:
    """The inputs of the measured run's last tick of each T."""
    return {t: ins for t, _, ins, _ in m["ticks"]}


def tick_device_ms(smoke: Smoke, engine, inputs: dict) -> dict:
    """Device ms of one replayed tick of each T by kind of kernel."""
    torch = smoke.torch

    def tick(t_len):
        return torch.argmax(engine._graphs[t_len].replay(inputs[t_len]),
                            dim=-1).cpu()

    return {t: device_split(torch, lambda t=t: tick(t)) for t in inputs}


def add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + n for k, n in counts.items()}


def paged_parity(smoke: Smoke, serve, kops, arch: str, ring_ref: dict):
    """``arch`` FULL on the paged cache, the continuous pass's 8 requests:
    the tokens must equal that ring run's, no graph may be captured in the
    measured run, and a replayed tick launches 2 x layers + 1 RMSNorm
    kernels."""
    torch = smoke.torch
    engine = full_engine(serve, arch, slots=4, max_new=16, prefill_chunk=16,
                         cache_kind="paged")
    cfg = engine.bundle.cfg
    norms = forward_launches(cfg, prefill=False)["rmsnorm"]
    reqs = serve.make_requests(8, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    label = f"paged {arch}"
    m = measured_run(smoke, kops, engine, reqs, [warm_request(cfg.vocab, 510)],
                     label, keep_logits=True)
    ring_tokens, ring_ticks = ring_ref.pop(arch)
    got = {r.uid: r.tokens for r in m["results"]}
    if got != ring_tokens:
        smoke.fail(f"{label}: tokens differ from the ring run's for uids "
                   f"{[u for u in got if got[u] != ring_tokens.get(u)]}")
    diff, compared = 0.0, 0
    for (ins, lg), (_, _, pins, plg) in zip(ring_ticks, m["ticks"]):
        if not all(np.array_equal(ins[k], pins[k])
                   for k in ("tokens", "n_valid", "reset")):
            break               # the schedules parted: stop comparing
        live = torch.from_numpy(ins["n_valid"] > 0).cuda()
        diff = max(diff, (lg[live] - plg[live]).abs().max().item())
        compared += 1
    counts = m["counts"]
    if counts["rmsnorm"] != norms * m["n_ticks"]:
        smoke.fail(f"{label}: {counts['rmsnorm']} RMSNorm launches counted, "
                   f"want {norms} x {m['n_ticks']} ticks")
    if counts["tcu_scan"] != moe_layers(cfg) * m["n_ticks"]:
        smoke.fail(f"{label}: {counts['tcu_scan']} tcu_scan launches "
                   f"counted, want {moe_layers(cfg)} x {m['n_ticks']} ticks")
    inputs = last_inputs(m)
    prof = profiled_replays(smoke, engine, inputs, label, norms)
    split = {t: split_by_kind(ev) for t, ev in prof["events"].items()}
    kv = engine.kv_stats()
    print(f"serve: {cfg.name} paged KV pool ({kv}): {run_text(m)}; graphs "
          f"{engine.compile_stats()['block']}; launches {counts}; largest "
          f"logit difference from the ring run over {compared} of "
          f"{len(ring_ticks)} ticks (active slots) {diff:.4e}; RMSNorm "
          f"launches in three profiled replays {prof['per_replay']}; device "
          f"ms a replayed tick by kind {split}", flush=True)
    stats = dict(scheduler="continuous", cache_kind="paged", **run_stats(m),
                 kv=kv, logit_diff_vs_ring=diff, ticks_compared=compared,
                 rmsnorm_per_replay=prof["per_replay"],
                 device_ms_by_kind=split)
    if "attn" in engine._cache:
        stats["kv_copy"] = kv_copy_forms(smoke, engine)
    return stats


def kv_copy_forms(smoke: Smoke, engine) -> dict:
    """The copy-on-write page copy of one tick on the engine's KV pool, in
    the reference's form (the whole pool gathered through a page map that
    is the identity but for one page) and in the port's (the copied pages
    only, as the padded pairs of a T = 16 step of 4 slots)."""
    from repro_torch.serving import kvpool

    torch = smoke.torch
    k, v = engine._cache["attn"]["k"], engine._cache["attn"]["v"]
    n_pages = k.shape[1]
    plan = np.arange(n_pages)
    plan[1] = 0
    src, dst = (torch.from_numpy(a).cuda()
                for a in kvpool.cow_pairs(plan, 8))
    perm = torch.from_numpy(plan).cuda()

    def gather_all():
        return [torch.index_select(c, 1, perm) for c in (k, v)]

    def pairs():
        for c in (k, v):
            c.index_copy_(1, dst, c.index_select(1, src))

    out = dict(pool_mb=nbytes(k, v) / 2**20, pages=n_pages,
               gather_all_ms=smoke.time_ms(gather_all),
               pairs_ms=smoke.time_ms(pairs))
    print(f"serve: the copy-on-write copy of a tick on the {n_pages}-page "
          f"pool ({out['pool_mb']:.1f} MiB, k and v): the whole pool "
          f"gathered (the reference's kv_copy) {out['gather_all_ms']:.4f} "
          f"ms, 8 page pairs (the port's) {out['pairs_ms']:.4f} ms",
          flush=True)
    return out


def kind_text(kind: str, m: dict, kv, dev: dict) -> str:
    return (f"{kind}: {run_text(m)}; peak memory {m['peak_gb']:.2f} GB; "
            f"pool {kv}; device ms a replayed tick by kind {dev}")


def both_kinds(smoke: Smoke, serve, kops, arch: str, make_reqs, warm_len,
               label: str, on_engine=None, layers: int | None = None) -> dict:
    """The same requests under the ring and under the paged cache, each
    engine warmed up first: {kind: (measured run, kv stats, device ms a
    tick by T, what ``on_engine`` returned)}. Then both again in f32
    (``out["f32"]``: {kind: (results, kv stats)}): the bf16 engine's
    tokens depend on the tick schedule (a decode token in a T = 16 tick
    goes through other matrix-product shapes than in a T = 1 tick), and the
    paged cache changes the schedule by skipping prefill ticks, so the two
    caches are held token for token in f32. ``layers`` cuts the model's
    depth (None: ``full_engine``'s)."""
    from repro_torch.models import build_lm
    from repro_torch.models.common import cast_tree
    from repro_torch.serving import ServeConfig, ServingEngine

    torch = smoke.torch
    out, f32 = {}, {}
    for kind in ("ring", "paged"):
        engine = full_engine(serve, arch, layers=layers, slots=4,
                             max_new=16, prefill_chunk=16, cache_kind=kind)
        extra = on_engine(engine) if on_engine else None
        m = measured_run(smoke, kops, engine, make_reqs(),
                         [warm_request(engine.bundle.cfg.vocab, warm_len)],
                         f"{label} {kind}")
        dev = tick_device_ms(smoke, engine, last_inputs(m))
        out[kind] = (m, engine.kv_stats(), dev, extra)
        print(f"serve: {label}, {kind_text(kind, m, out[kind][1], dev)}",
              flush=True)
        cfg32 = dataclasses.replace(engine.bundle.cfg, dtype=torch.float32)
        params32 = cast_tree(engine.params, torch.float32)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        eng32 = ServingEngine(build_lm(cfg32), params32, ServeConfig(
            slots=4, max_new=16, prefill_chunk=16, cache_kind=kind))
        eng32.run([warm_request(cfg32.vocab, warm_len)])
        kops.reset_launches()
        f32[kind] = (eng32.run(make_reqs()), eng32.kv_stats(),
                     kops.launch_counts())
        del eng32, params32
        gc.collect()
        torch.cuda.empty_cache()
    out["f32"] = f32
    return out


def tokens_agree(smoke: Smoke, out: dict, label: str) -> dict:
    """Gate: the paged tokens equal the ring's in f32; the bf16 runs'
    agreement is printed."""
    def toks(results):
        return {r.uid: r.tokens for r in results}

    bf16 = [toks(out[k][0]["results"]) for k in ("ring", "paged")]
    f32 = [toks(out["f32"][k][0]) for k in ("ring", "paged")]
    same16 = [u for u in bf16[0] if bf16[0][u] == bf16[1][u]]
    same32 = [u for u in f32[0] if f32[0][u] == f32[1][u]]
    print(f"serve: {label}: requests whose paged tokens equal the ring's: "
          f"f32 {len(same32)} of {len(f32[0])}, bf16 {len(same16)} of "
          f"{len(bf16[0])}; f32 paged pool {out['f32']['paged'][1]}",
          flush=True)
    if len(same32) != len(f32[0]):
        smoke.fail(f"{label}: the f32 paged tokens differ from the ring's "
                   f"for uids {sorted(set(f32[0]) - set(same32))}")
    return {"same_tokens_f32": len(same32), "same_tokens_bf16": len(same16),
            "requests": len(f32[0]), "f32_kv": out["f32"]["paged"][1]}


def kinds_stats(out: dict) -> dict:
    stats = {kind: dict(**run_stats(out[kind][0]), kv=out[kind][1],
                        device_ms_by_kind=out[kind][2])
             for kind in ("ring", "paged")}
    launches = add_counts(out["ring"][0]["counts"], out["paged"][0]["counts"])
    for kind in ("ring", "paged"):
        launches = add_counts(launches, out["f32"][kind][2])
    stats["launches"] = launches
    return stats


def shared_prefix_requests():
    """A maker of llama3.2-1b's 8 requests that share a 392-token prefix
    (24.5 pages) with tails of 16 to 64 tokens (numpy seed 0), 16 new
    tokens each."""
    from repro_torch import configs
    from repro_torch.serving import Request

    vocab = configs.get("llama3.2-1b").FULL.vocab
    rng = np.random.default_rng(0)
    prefix = rng.integers(3, vocab, 392, dtype=np.int32)
    tails = [rng.integers(3, vocab, int(rng.integers(16, 65)),
                          dtype=np.int32) for _ in range(8)]

    def make_reqs():
        return [Request(uid=i, prompt=np.concatenate([prefix, t]),
                        max_new=16) for i, t in enumerate(tails)]

    return make_reqs


def shared_prefix_pass(smoke: Smoke, serve, kops):
    """llama3.2-1b FULL, the shared-prefix requests, under the ring and the
    paged cache: the tokens must be the same, and the paged run must share
    prompt tokens and copy pages on write."""
    label = "llama3.2-1b shared prefix"
    out = both_kinds(smoke, serve, kops, "llama3.2-1b",
                     shared_prefix_requests(), 440, label)
    agree = tokens_agree(smoke, out, label)
    for kv in (out["paged"][1], out["f32"]["paged"][1]):
        if not (kv["shared_tokens"] > 0 and kv["cow_copies"] > 0):
            smoke.fail(f"{label}: shared_tokens {kv['shared_tokens']}, "
                       f"cow_copies {kv['cow_copies']}; want both > 0")
    stats = kinds_stats(out)
    stats.update(agree)
    return stats


OBS_ARGV = ["--arch", "llama3.2-1b", "--config", "full", "--requests", "8",
            "--slots", "4", "--max-new", "16", "--prefill-chunk", "16",
            "--cache", "paged", "--seed", "0"]


@contextlib.contextmanager
def served_through_main(serve, make_reqs, starts: list):
    """``serve.main`` serves ``make_reqs()`` in place of its synthetic
    requests, and its engine appends (T, host clock) at the start of every
    block step to ``starts``."""
    build, make = serve.build_engine, serve.make_requests

    def build_timed(*args, **kw):
        engine = build(*args, **kw)
        step = engine._block_step

        def timed(inputs):
            starts.append((inputs["tokens"].shape[1], time.perf_counter()))
            return step(inputs)

        engine._block_step = timed
        return engine

    serve.build_engine = build_timed
    serve.make_requests = lambda *args, **kw: make_reqs()
    try:
        yield
    finally:
        serve.build_engine, serve.make_requests = build, make


def tick_ms(starts: list, t_len: int) -> list:
    """Host ms of each tick of ``t_len`` tokens, start to the next tick's
    start (everything the loop does for the tick, obs included), without
    the first of each T (its graph's capture) and the last tick."""
    out, seen = [], set()
    for (t, t0), (_, t1) in zip(starts, starts[1:]):
        if t in seen and t == t_len:
            out.append(1e3 * (t1 - t0))
        seen.add(t)
    return out


def prom_values(text: str) -> dict:
    """``{"name{labels}": value}`` of a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def obs_pass(smoke: Smoke, serve, kops):
    """llama3.2-1b FULL, bf16, the paged cache, the shared-prefix requests,
    served through ``repro_torch.launch.serve.main`` five times: with obs
    off, on (``--obs-events --metrics-out``), on, off (in turns, as the
    host clock drifts), then with those and ``--profile-dir``. Gates: the
    same tokens and launch counts in all five; in each run with obs on one
    admit and one finish event per request; TTFT observed once
    per request; ``repro_serving_tokens_total`` the tokens returned; the
    four tick phases summing to the ticks within 1e-6 s a tick; ``kv_cow``
    events the pool's CoW copies and the peak-pages gauge its peak; a
    resolution and a kernel_invoke event of RMSNorm on ``tile_gpu``; the trace
    holding one ``serving/block_step`` range a tick and RMSNorm kernel
    records."""
    from repro_torch import obs

    make_reqs = shared_prefix_requests()
    runs = {}
    on = ("events", "metrics")
    for label, flags in (("off a", ()), ("on a", on), ("on b", on),
                         ("off b", ()), ("on, traced", (*on, "profile"))):
        out_dir = OBS_DIR / f"serve-{len(runs)}"
        shutil.rmtree(out_dir, ignore_errors=True)
        out_dir.mkdir(parents=True)
        paths = {"events": out_dir / "events.jsonl",
                 "metrics": out_dir / "metrics.prom",
                 "profile": out_dir / "trace"}
        argv = list(OBS_ARGV)
        for flag in flags:
            argv += [{"events": "--obs-events", "metrics": "--metrics-out",
                      "profile": "--profile-dir"}[flag], str(paths[flag])]
        starts: list = []
        kops.reset_launches()
        with served_through_main(serve, make_reqs, starts):
            engine = serve.main(argv)
        smoke.torch.cuda.synchronize()
        counts = kops.launch_counts()
        runs[label] = dict(engine=engine, counts=counts, paths=paths,
                           flags=flags, t1=tick_ms(starts, 1))
        if obs.active() is not None:
            smoke.fail(f"obs {label}: a session outlived serve.main")
    base = runs["off a"]
    tokens = {k: {r.uid: r.tokens for r in m["engine"].results}
              for k, m in runs.items()}
    for label, m in runs.items():
        if tokens[label] != tokens["off a"] or m["counts"] != base["counts"]:
            smoke.fail(f"obs {label}: tokens or launch counts differ from "
                       f"the run with obs off ({m['counts']} against "
                       f"{base['counts']})")
    stats = {}
    for label, m in runs.items():
        if not m["flags"]:
            continue
        engine, paths = m["engine"], m["paths"]
        results = engine.results
        events = obs.load_jsonl(str(paths["events"]))
        prom = prom_values(paths["metrics"].read_text())
        kv = engine.kv_stats()
        n_req = len(results)
        n_tok = sum(len(r.tokens) for r in results)
        serving = [e for e in events if e["kind"] == "serving"]
        per_uid = {(r.uid, ev): sum(1 for e in serving if e["uid"] == r.uid
                                    and e["event"] == ev)
                   for r in results for ev in ("admit", "finish")}
        phase_sum = sum(v for k, v in prom.items()
                        if k.startswith("repro_serving_tick_phase_seconds_sum"))
        tick_sum = prom.get("repro_serving_tick_seconds_sum", float("nan"))
        n_ticks = prom.get("repro_serving_tick_seconds_count", 0)
        cow = sum(1 for e in events if e["kind"] == "kv_cow")
        res = {(e["op"], e["chosen_path"], e["level"]) for e in events
               if e["kind"] == "resolution"}
        inv = {(e["op"], e["path"]) for e in events
               if e["kind"] == "kernel_invoke"}
        checks = {
            "one admit and one finish per request":
                set(per_uid.values()) == {1} and n_req == 8,
            "TTFT count = requests":
                prom.get("repro_serving_ttft_seconds_count") == n_req,
            "tokens_total = tokens returned":
                prom.get("repro_serving_tokens_total") == n_tok,
            "phases sum to the ticks within 1e-6 s a tick":
                n_ticks == engine.ticks
                and abs(phase_sum - tick_sum) <= 1e-6 * n_ticks,
            "kv_cow events = cow_copies": cow == kv["cow_copies"] > 0,
            "peak pages gauge = kv_stats peak":
                prom.get("repro_kvpool_peak_pages_in_use")
                == kv["peak_pages_in_use"],
            "rmsnorm resolution and kernel_invoke on tile_gpu":
                ("rmsnorm", "tile_gpu", "kernel") in res
                and ("rmsnorm", "tile_gpu") in inv,
        }
        # mean ms of each phase a tick, from the run's own histograms
        head = "repro_serving_tick_phase_seconds_sum"
        phase_ms = {k[len(head):].split('"')[1]: round(
            1e3 * v / prom[k.replace("_sum{", "_count{")], 4)
            for k, v in prom.items() if k.startswith(head)}
        row = dict(ticks=engine.ticks, tokens=n_tok, cow=cow,
                   phase_sum_s=phase_sum, tick_sum_s=tick_sum,
                   events=len(events), phase_ms=phase_ms)
        if "profile" in m["flags"]:
            trace = chrome_trace(paths["profile"])
            spans = sum(1 for e in trace if e.get("name") ==
                        "serving/block_step" and e.get("cat") ==
                        "user_annotation")
            norms = sum(1 for e in trace if e.get("cat") == "kernel"
                        and "rmsnorm" in e["name"].lower())
            checks["one serving/block_step range a tick"] = \
                spans == engine.ticks
            checks["rmsnorm kernel records in the trace"] = norms > 0
            # each tick replays 2L + 1 RMSNorm kernels; each graph's eager
            # warm-up launched them once more
            row.update(block_step_ranges=spans, rmsnorm_records=norms,
                       rmsnorm_records_want=(2 * engine.bundle.cfg.n_layers
                                             + 1) * (engine.ticks +
                                                     engine.captures))
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            smoke.fail(f"obs {label}: {failed} ({row})")
        print(f"obs {label}: {row}; checks passed "
              f"{len(checks) - len(failed)} of {len(checks)}", flush=True)
        stats[label] = row
    cost = {label: m["t1"] for label, m in runs.items()}
    cost["off, a and b"] = cost["off a"] + cost["off b"]
    cost["on, a and b"] = cost["on a"] + cost["on b"]
    print(f"obs: T = 1 tick host ms, start to next start, median (min-max, "
          f"n), first tick of each T left out; {smi_line()}: "
          + "; ".join(f"obs {label} {ms_text(v)}" for label, v in
                      cost.items()), flush=True)
    launches = {}
    for m in runs.values():
        launches = add_counts(launches, m["counts"])
    stats.update(t1_tick_ms=cost, launches=launches)
    return stats


def multi_turn_pass(smoke: Smoke, serve, kops):
    """mamba2-1.3b at ``MAMBA_CUT_LAYERS`` of its 48 layers, its published
    widths: four first turns (the continuous pass's first four
    prompts), then each one's second turn, the first turn and 32 tokens
    more, queued behind them all, under the ring and the paged cache. The
    tokens must be the same, and the paged run must share the whole first
    turn of every second turn admitted after its snapshot landed."""
    from repro_torch import configs
    from repro_torch.serving import Request

    vocab = configs.get("mamba2-1.3b").FULL.vocab
    first = serve.make_requests(4, 512, vocab, seed=0)
    rng = np.random.default_rng(1)
    more = [rng.integers(3, vocab, 32, dtype=np.int32) for _ in first]

    def make_reqs():
        return ([Request(uid=r.uid, prompt=r.prompt, max_new=16)
                 for r in first] +
                [Request(uid=4 + r.uid, prompt=np.concatenate([r.prompt, x]),
                         max_new=16) for r, x in zip(first, more)])

    saves = []

    def watch_saves(engine):
        """Record the ticks whose plan saves a snapshot, and of which
        slots."""
        step_inputs = engine._step_inputs

        def recorded(tokens, n_valid, reset, plan):
            if plan is not None and (plan.get("snap_save", -1) >= 0).any():
                saves.append((engine.ticks,
                              np.flatnonzero(plan["snap_save"] >= 0)))
            return step_inputs(tokens, n_valid, reset, plan)

        engine._step_inputs = recorded

    label = "mamba2-1.3b multi-turn"
    out = both_kinds(smoke, serve, kops, "mamba2-1.3b", make_reqs, 500,
                     label, on_engine=watch_saves,
                     layers=MAMBA_CUT_LAYERS)
    paged = out["paged"][0]
    kv = out["paged"][1]
    agree = tokens_agree(smoke, out, label)
    # the tick each first turn's snapshot was saved at (the paged run's
    # saves, after its warm-up), and the tick each second turn was admitted
    admits = [e for e in paged["events"] if e["event"] == "admit"]

    def uid_at(slot, tick):
        return max((e for e in admits
                    if e["slot"] == slot and e["tick"] <= tick),
                   key=lambda e: e["tick"])["uid"]

    saved = {uid_at(int(s), t): t for t, slots in saves
             if t >= paged["first_tick"] for s in slots}
    admitted = {e["uid"]: e["tick"] for e in admits}
    landed = [r.uid for r in first if r.uid in saved and
              saved[r.uid] < admitted[4 + r.uid]]
    want = sum(len(r.prompt) for r in first if r.uid in landed)
    ttft = {kind: [round(t, 1) for t in out[kind][0]["ttft"][4:]]
            for kind in ("ring", "paged")}
    print(f"serve: {label}: second turns admitted after their first turn's "
          f"snapshot landed {[4 + u for u in landed]}, shared_tokens "
          f"{kv['shared_tokens']} (want {want}); second turns' TTFT ms, "
          f"ring {ttft['ring']}, paged {ttft['paged']}", flush=True)
    if kv["shared_tokens"] != want or not landed:
        smoke.fail(f"{label}: shared_tokens {kv['shared_tokens']}, want "
                   f"{want} (second turns {[4 + u for u in landed]})")
    if out["f32"]["paged"][1]["shared_tokens"] != want:
        smoke.fail(f"{label}: f32 shared_tokens "
                   f"{out['f32']['paged'][1]['shared_tokens']}, want {want}")
    stats = kinds_stats(out)
    stats.update(second_turn_ttft_ms=ttft, landed=landed,
                 shared_tokens_want=want, **agree)
    return stats


def sampling_pass(smoke: Smoke, serve, kops):
    """llama3.2-1b FULL with ``greedy=False``, temperature 1: seed 7 twice
    must give the same tokens and seed 8 other ones; the engine's draw over
    fixed logits (2^16 draws over 16 classes) must lie within a total
    variation distance of 0.02 of their softmax."""
    torch = smoke.torch
    counts, tokens = {}, []
    for seed in (7, 7, 8):
        engine = serve.build_engine("llama3.2-1b", "full", device="cuda",
                                    slots=4, max_new=16, prefill_chunk=16,
                                    greedy=False, temperature=1.0, seed=seed)
        reqs = serve.make_requests(4, 512, engine.bundle.cfg.vocab, seed=0)
        kops.reset_launches()
        res = engine.run(reqs)
        counts = add_counts(counts, kops.launch_counts())
        tokens.append([r.tokens for r in res])
    logits = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    draws = engine._sample(torch.from_numpy(logits).cuda().expand(1 << 16,
                                                                  16))
    freq = np.bincount(draws, minlength=16) / len(draws)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    tv = 0.5 * float(np.abs(freq - p).sum())
    same, differ = tokens[0] == tokens[1], tokens[0] != tokens[2]
    print(f"serve: sampling llama3.2-1b, temperature 1: seed 7 twice the "
          f"same tokens {same}, seed 8 other tokens {differ}; 2^16 draws over"
          f" 16 classes, total variation from the softmax {tv:.4f} (tol "
          f"0.02)", flush=True)
    if not (same and differ):
        smoke.fail(f"sampling: seed 7 twice same {same}, seed 8 differs "
                   f"{differ}")
    if not tv < 0.02:
        smoke.fail(f"sampling: total variation {tv} from the softmax")
    del engine
    return dict(seeded_same=same, other_seed_differs=differ, tv=tv,
                launches=counts)


# the models whose prefill takes a frontend's output beside the tokens:
# (arch, layers served (None: all), the frontend's input, the gates' depth
# (None: all), tag). internvl2-76b at its published widths with its depth
# cut (its 80 layers and stub projection are 70.6 B parameters, 141 GB in
# bf16) behind a random stub prefix of 256 x 3200 patch embeddings;
# seamless-m4t-medium whole (12 + 12 layers, 0.98 B parameters, 1.96 GB in
# bf16, 3.9 GB in f32 for its gates) on random frames of 4 x 512 x 1024
FRONTENDS = (("internvl2-76b", 4, "stub", 2, "vlm"),
             ("seamless-m4t-medium", None, "frames", None, "encdec"))
DIRECT_STEPS = 15
ENCDEC_FRAMES = 512


def frontend_input(torch, cfg, kind: str, gen):
    """The frontend's output, random from ``gen``: the vlm's stub prefix
    (4, stub_tokens, stub_dim) or the encoder-decoder's frames (4,
    ENCDEC_FRAMES, d_model)."""
    shape = ((4, cfg.stub_tokens, cfg.stub_dim) if kind == "stub" else
             (4, ENCDEC_FRAMES, cfg.d_model))
    return torch.randn(*shape, generator=gen, device="cuda").to(cfg.dtype)


def frontend_pass(smoke: Smoke, serve, kops, arch: str, layers, kind: str,
                  gate_layers, tag: str) -> dict:
    """``arch`` at its published widths (cut to ``layers`` layers):
    ``prefill_last`` on the wave's 4 prompts (left-padded) with the
    frontend's input, then ``DIRECT_STEPS`` greedy decode steps of
    ``Bundle.decode`` from the cache grown by that many rows (tokens only,
    as the reference's), launches gated by ``forward_launches``. Then the
    served models' timings and logit gates (``prefill_timing``,
    ``decode_timing``, ``logit_gates``), the gates at ``gate_layers``
    layers. The wave scheduler cannot serve either model (it has no stub or
    frames to give), so the bundle is driven directly, as the reference's
    ``bundle.prefill`` and ``bundle.decode`` serve it."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.common import init_params
    from repro_torch.models.lm import pad_cache_seq

    torch = smoke.torch
    full = configs.get(arch).FULL
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    bundle = build(cfg)
    print(f"{tag}: {arch} at its published widths, {cfg.n_layers} of "
          f"{full.n_layers} layers"
          + (f" (and {cfg.enc_layers} encoder layers)" if cfg.enc_layers
             else "")
          + f": {bundle.n_params / 1e9:.3f}B of "
          f"{build(full).n_params / 1e9:.3f}B parameters "
          f"({2 * bundle.n_params / 1e9:.2f} GB in bf16)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(bundle.params_pspec, gen, cfg.dtype)
    reqs = serve.make_requests(4, 512, cfg.vocab, seed=0)
    batch = {"tokens": wave_tokens(torch, reqs),
             kind: frontend_input(torch, cfg, kind, gen)}
    print(f"{tag}: {kind} {tuple(batch[kind].shape)}, prompts "
          f"{[len(r.prompt) for r in reqs]} left-padded to "
          f"{batch['tokens'].shape[1]}", flush=True)

    def generate(steps):
        logits, cache = bundle.prefill_last(params, batch)
        cache = pad_cache_seq(cache, steps)
        out = [logits.float()]
        for _ in range(steps):
            nxt = torch.argmax(out[-1][:, -1], dim=-1, keepdim=True)
            logits, cache = bundle.decode(params, cache, {"tokens": nxt})
            out.append(logits.float())
        torch.cuda.synchronize()
        return out

    generate(1)                                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    logits = generate(DIRECT_STEPS)
    counts = kops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = forward_launches(cfg)
    per_step = forward_launches(cfg, prefill=False)
    want = {k: per_prefill.get(k, 0) + DIRECT_STEPS * per_step.get(k, 0)
            for k in counts}
    print(f"{tag}: prefill and {DIRECT_STEPS} decode steps: launches "
          f"{counts}; peak memory {peak_gb:.2f} GB ({smi_line()})",
          flush=True)
    if counts != want:
        smoke.fail(f"{tag}: launches {counts}, want {want} ({per_prefill} a "
                   f"prefill, {per_step} a decode step)")
    if not all(bool(torch.isfinite(lg).all()) for lg in logits):
        smoke.fail(f"{tag}: non-finite logits")
    if tuple(logits[0].shape) != (4, 1, cfg.vocab):
        smoke.fail(f"{tag}: prefill logits of shape "
                   f"{tuple(logits[0].shape)}")
    del logits
    stats = dict(layers=cfg.n_layers, enc_layers=cfg.enc_layers,
                 n_params=bundle.n_params,
                 prompt_lens=[len(r.prompt) for r in reqs],
                 peak_mem_gb=peak_gb, launches=counts)
    stats.update(prefill_timing(smoke, cfg, params, batch, None, tag,
                                f"prefill-{arch}"))
    stats.update(decode_timing(smoke, bundle, params, batch, tag))
    depth = gate_layers or cfg.n_layers
    box = [params if depth == cfg.n_layers else first_layers(params, depth)]
    del params
    stats.update(logit_gates(smoke, cfg, box, batch, None, depth, tag))
    return stats


# h2o-danube whole on one prompt past its sliding window of 4096: the
# prefill's flash attention at L = 6144 and D = 120 with the window, the
# ring of 4096 rows it leaves, and decode steps on that ring
WINDOW_ARCH, WINDOW_PROMPT, WINDOW_STEPS = "h2o-danube-3-4b", 6144, 15


def window_pass(smoke: Smoke, kops) -> dict:
    """``WINDOW_ARCH`` FULL, bf16: ``prefill_last`` on one prompt of
    ``WINDOW_PROMPT`` tokens, then ``WINDOW_STEPS`` decode steps on the
    ring it leaves (not grown), each fed the next token of a longer
    sequence; launches gated by ``forward_launches``, the ring's rows, the
    prefill's device time on the kernels and the plain versions, a decode
    step on the host clock and the card's idle share (``decode_timing``).
    Then, the bf16 model freed, the same in f32 at ``PARITY_LAYERS``
    layers: each step's logits (and the prefill's) within 1e-3 of the
    largest of the teacher-forced forward on the plain versions over the
    longer sequence at that position. A wrong ring order passes every
    prefill check and shows only here."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.common import cast_tree, init_params
    from repro_torch.models.lm import lm_apply

    torch = smoke.torch
    cfg = configs.get(WINDOW_ARCH).FULL
    bundle = build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(bundle.params_pspec, gen, cfg.dtype)
    seq = torch.randint(3, cfg.vocab, (1, WINDOW_PROMPT + WINDOW_STEPS),
                        generator=gen, device="cuda")
    prompt = {"tokens": seq[:, :WINDOW_PROMPT]}

    def generate(b, p):
        logits, cache = b.prefill_last(p, prompt)
        out = [logits[:, -1].float()]
        for i in range(WINDOW_STEPS):
            tok = seq[:, WINDOW_PROMPT + i:WINDOW_PROMPT + i + 1]
            logits, cache = b.decode(p, cache, {"tokens": tok})
            out.append(logits[:, -1].float())
        torch.cuda.synchronize()
        return out, cache

    generate(bundle, params)                        # warm-up
    kops.reset_launches()
    out, cache = generate(bundle, params)
    counts = kops.launch_counts()
    rows = cache["attn"]["k"].shape[2]
    per_prefill = forward_launches(cfg)
    per_step = forward_launches(cfg, prefill=False)
    want = {k: per_prefill.get(k, 0) + WINDOW_STEPS * per_step.get(k, 0)
            for k in counts}
    if counts != want:
        smoke.fail(f"window: launches {counts}, want {want}")
    if rows != cfg.swa_window:
        smoke.fail(f"window: the prefill left a cache of {rows} rows, want "
                   f"the ring of {cfg.swa_window}")
    if not all(bool(torch.isfinite(lg).all()) for lg in out):
        smoke.fail("window: non-finite logits")
    del out, cache
    stats = dict(prompt=WINDOW_PROMPT, window=cfg.swa_window, ring_rows=rows,
                 launches=counts)
    print(f"window: {WINDOW_ARCH} whole, one prompt of {WINDOW_PROMPT} "
          f"tokens past its window of {cfg.swa_window}: launches {counts} "
          f"(want {want}); ring of {rows} rows ({smi_line()})", flush=True)
    stats.update(prefill_timing(smoke, cfg, params, prompt, None, "window",
                                f"prefill-{WINDOW_ARCH}-{WINDOW_PROMPT}"))
    stats.update(decode_timing(smoke, bundle, params, prompt, "window",
                               n_steps=WINDOW_STEPS))

    params = cast_tree(first_layers(params, PARITY_LAYERS), torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    b32 = build(dataclasses.replace(cfg, dtype=torch.float32,
                                    n_layers=PARITY_LAYERS))
    # the teacher-forced forward on the plain versions: the prefill's
    # logits and the ring steps are held against a path without the kernels
    forced = lm_apply(params, dataclasses.replace(b32.cfg, policy="baseline"),
                      {"tokens": seq})[0][0].float()
    want32 = forced[WINDOW_PROMPT - 1:]
    got32 = torch.stack(generate(b32, params)[0])[:, 0]
    err = (got32 - want32).abs().amax(-1)
    tol = 1e-3 * want32.abs().max().item()
    print(f"window: f32 at {PARITY_LAYERS} of {cfg.n_layers} layers, the "
          f"prefill's last logits and {WINDOW_STEPS} ring decode steps "
          f"against the teacher-forced forward over "
          f"{WINDOW_PROMPT + WINDOW_STEPS} tokens: max_abs_err by step "
          f"{[f'{e:.2e}' for e in err.tolist()]} (tol {tol:.3e})",
          flush=True)
    if not err.max().item() <= tol:
        smoke.fail(f"window: ring decode {err.max().item()} from the "
                   f"teacher-forced forward (tol {tol})")
    stats.update(f32_layers=PARITY_LAYERS,
                 decode_vs_forward_f32_max_abs_err=err.max().item(),
                 decode_vs_forward_f32_tol=tol)
    return stats


# ---------------------------------------------------------------------------
# training: repro_torch.training's step on both models, FULL, bf16 compute,
# f32 masters, AdamW at the reference's OptConfig defaults, remat "none"

TRAIN_ARCHS = ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b",
               "seamless-m4t-medium")
# zamba2 at full width with its depth cut: the whole model's f32 masters and
# AdamW state are about 39 GB before activations; 12 layers are 2 uses of
# the shared block, 0.77 B parameters
TRAIN_LAYERS = {"zamba2-2.7b": 12}
TRAIN_BATCH, TRAIN_SEQ = 4, 512     # the kernel table's rows 3 and 5
FIXED_STEPS, TIMED_STEPS = 8, 6
PARITY_LAYERS = 2                   # depth of the f32 parity gate alone
# the parity gate's checkpoint, deleted after; not launch/train.py's default
# directory (build/train_ckpt), which may hold a user's run
CKPT_DIR = OBS_DIR.parent / "smoke_train_ckpt"


def train_launches(cfg, n_leaves: int, kernels) -> dict:
    """Kernel launches of one train step: a forward's
    (``forward_launches``), and the layers' again when remat recomputes
    each layer in backward (RMSNorm 2L, the layer kernel and the MoE scan;
    not the final norm, nor the hybrid's shared block, which is not
    rematerialised: RMSNorm 4L + 2G + 1, flash attention 2L or G, the SSD
    2L; the encoder-decoder's layers all, not its two final norms: RMSNorm
    2 (2E + 3D) + 2, flash attention 2 (E + 2D)), and ``tcu_reduce`` once
    per parameter leaf (the global norm); no other."""
    from repro_torch.models.lm import ATTN_FAMILIES, n_groups

    want = dict.fromkeys(kernels, 0)
    fwd = forward_launches(cfg)
    want.update(fwd)
    groups = n_groups(cfg)
    final_norms = 2 if cfg.family == "encdec" else 1
    want["rmsnorm"] += fwd["rmsnorm"] - 2 * groups - final_norms
    if cfg.family in ATTN_FAMILIES + ("encdec",):
        want["flash_attention"] += fwd["flash_attention"]
    want["ssd_scan"] += fwd["ssd_scan"]
    want["tcu_scan"] += fwd["tcu_scan"]
    want["tcu_reduce"] = n_leaves
    return want


def parity_depth(cfg) -> int:
    """The depth of the f32 train parity gate: ``PARITY_LAYERS``, or for the
    hybrid one group (its shared block once); the encoder-decoder's
    encoder is cut to the same."""
    return max(PARITY_LAYERS, cfg.shared_attn_every)


def parity_cfg(full):
    """``full`` at ``parity_depth``, in f32."""
    import torch

    depth = parity_depth(full)
    return dataclasses.replace(
        full, n_layers=depth, dtype=torch.float32,
        enc_layers=min(full.enc_layers, depth))


def with_frames(torch, cfg, batch, gen=None):
    """An encoder-decoder's batch gains the frontend's frames (B, S,
    d_model): zeros, as the reference's train CLI feeds, or random from
    ``gen``; other models' batches are returned as they are."""
    if cfg.family != "encdec":
        return batch
    bsz, seq = batch["tokens"].shape
    frames = (torch.zeros(bsz, seq, cfg.d_model, device="cuda") if gen is None
              else torch.randn(bsz, seq, cfg.d_model, generator=gen,
                               device="cuda"))
    return dict(batch, frames=frames.to(cfg.dtype))


def scaled(counts: dict, k: int) -> dict:
    return {name: k * n for name, n in counts.items()}


def train_pass(smoke: Smoke, kops, arch: str) -> dict:
    """``arch`` FULL through ``make_train_step``: 8 steps on one fixed
    batch, then 6 timed steps on the pipeline's batches, with every launch
    count set to 0 before each run and gated per step; one step's device
    time by kind from ``torch.profiler``, and its "other" kernels by the op
    that launched them; the global norm's reduce over the real leaves
    against ``torch.sum``. Returns its numbers."""
    from repro_torch import configs, tree
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.training import init_train_state, make_train_step

    torch = smoke.torch
    full = configs.get(arch).FULL
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS.get(
        arch, full.n_layers))
    bundle = build(cfg)
    if cfg.n_layers != full.n_layers:
        print(f"train: {arch} cut to {cfg.n_layers} of {full.n_layers} "
              f"layers at its published widths: {bundle.n_params / 1e9:.2f}B "
              f"of {build(full).n_params / 1e9:.2f}B parameters",
              flush=True)
    opt_cfg = OptConfig()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             bundle, opt_cfg)
    n_leaves = len(tree.leaves(state["params"]))
    per_step = train_launches(cfg, n_leaves, kops.KERNELS)
    step = make_train_step(bundle, opt_cfg)
    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0), device="cuda")
    batch = with_frames(torch, cfg, data.device_batch(0))
    torch.cuda.synchronize()

    kops.reset_launches()
    losses = []
    for _ in range(FIXED_STEPS):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    fixed = kops.launch_counts()
    instances = kops.instance_counts()
    if fixed != scaled(per_step, FIXED_STEPS):
        smoke.fail(f"train {arch}: launches over {FIXED_STEPS} steps "
                   f"{fixed}, want {scaled(per_step, FIXED_STEPS)}")
    if fixed["ssd_scan"] and instances != {
            ("ssd_scan", "mma"): fixed["ssd_scan"]}:
        smoke.fail(f"train {arch}: SSD instances "
                   f"{instance_text(instances)}, want every launch on mma")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        smoke.fail(f"train {arch}: losses {losses} not finite or not "
                   "falling")

    data.skip_to(1)
    batches = iter(data)
    times = []
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    for _ in range(TIMED_STEPS):
        _, batch = next(batches)
        batch = with_frames(torch, cfg, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        metrics["loss"].item()
        times.append(1e3 * (time.perf_counter() - t0))
    data.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = kops.launch_counts()
    if timed != scaled(per_step, TIMED_STEPS):
        smoke.fail(f"train {arch}: launches over {TIMED_STEPS} timed steps "
                   f"{timed}, want {scaled(per_step, TIMED_STEPS)}")
    med = statistics.median(times)
    split = split_by_kind(kernel_events(torch, lambda: step(state, batch)))
    idle = None if split is None else 1.0 - sum(split.values()) / med
    other = other_by_op(lambda: step(state, batch), f"train_{arch}")

    with torch.no_grad():
        sq = [p.float().square().reshape(1, -1)
              for p in tree.leaves(state["params"])]
        norm_ms = smoke.time_ms(lambda: [kops.segmented_reduce(x)
                                         for x in sq])
        norm_spread = smoke.spread
        sum_ms = smoke.time_ms(lambda: [torch.sum(x, dim=-1) for x in sq])
        sum_spread = smoke.spread
        norm_bound = bound(sum(nbytes(x) for x in sq),
                           sum(x.numel() for x in sq), torch.float32)[0]
    del sq, state, metrics, batch
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    print(f"train {arch} FULL widths, {cfg.n_layers} layers, bf16, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}: "
          f"losses of {FIXED_STEPS} steps on one batch "
          f"{[round(x, 4) for x in losses]}; launches a step {per_step} "
          f"(SSD instances {instance_text(instances)}); {TIMED_STEPS} "
          f"pipeline steps, host ms median {ms_text(times)}, "
          f"{tok_s:.1f} tok/s; device ms of a step by kind {split}, idle "
          f"share {'not measured' if idle is None else f'{idle:.3f}'}; "
          f"peak {peak_gb:.2f} GB; global norm over {n_leaves} leaves: "
          f"tcu_reduce {norm_ms:.4f} ms (min {norm_spread['min']:.4f} max "
          f"{norm_spread['max']:.4f}"
          f"{' HOST-BOUND' if norm_spread['host_bound'] else ''}), "
          f"torch.sum {sum_ms:.4f} ms"
          f"{' HOST-BOUND' if sum_spread['host_bound'] else ''}, bound "
          f"{norm_bound:.4f} ms; \"other\" device ms by launching op "
          f"{other}", flush=True)
    out = dict(losses=losses, launches_per_step=per_step, step_ms=times,
               step_ms_median=med, tok_per_s=tok_s, device_ms=split,
               idle_share=idle, other_by_op=other, peak_mem_gb=peak_gb,
               global_norm_ms=norm_ms, global_norm_torch_sum_ms=sum_ms,
               global_norm_bound_ms=norm_bound,
               launches=add_counts(fixed, timed))
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = train_parity(smoke, arch)
    return out


def update_gate(got, want, old, dgrad=None, m_want=None, lr: float = 0.0,
                eps: float = 1e-8, b1: float = 0.9) -> dict:
    """Each leaf of the params after an AdamW step on one path (``got``)
    against another's (``want``), from the same ``old``: within 1e-3 of the
    leaf's largest change, plus one f32 rounding of the param.

    With ``dgrad`` (each leaf's largest gradient difference between the
    paths, clipped as the step clips) the first step's conditioning is
    added: its update ``g / (|g| + eps)`` (g the other path's clipped
    gradient, ``m / (1 - b1)``) moves by at most ``eps dg / (max(|g| - dg,
    0) + eps)^2``, and by at most 2, when g moves by dg; times ``lr``. That
    is nothing where |g| is far above dg and eps, and up to two whole
    updates where g's sign is not determined. Returns the worst error over
    tolerance, and the elements beyond the plain 1e-3 tolerance."""
    from repro_torch import tree

    worst, beyond, total = 0.0, 0, 0
    n = len(tree.leaves(got))
    for g_new, w_new, p_old, dg, m in zip(
            tree.leaves(got), tree.leaves(want), tree.leaves(old),
            dgrad or [None] * n,
            [None] * n if m_want is None else tree.leaves(m_want)):
        err = (g_new - w_new).abs()
        tol = 1e-3 * (w_new - p_old).abs().max()
        beyond += int((err > tol).sum())
        total += err.numel()
        tol = tol + float(np.finfo(np.float32).eps) * w_new.abs()
        if dg is not None:
            grad = m.float().abs() / (1 - b1)
            slack = eps * dg / ((grad - dg).clamp(min=0.0) + eps) ** 2
            tol = tol + lr * slack.clamp(max=2.0)
        worst = max(worst, float((err / tol).max()))
    return dict(worst=worst, beyond_plain=beyond, elements=total)


def train_parity(smoke: Smoke, arch: str) -> dict:
    """f32, ``PARITY_LAYERS`` layers, full width: one step on the kernels
    against the same step under ``policy="baseline"`` (loss rtol 1e-4,
    grad_norm rtol 1e-3, each gradient leaf within 1e-3 of its largest,
    params by ``update_gate`` with the first step's conditioning at the
    measured gradient differences); then the kernels' state saved and
    restored bit for bit, and a step from it against a step from the state
    in memory, within the same tolerances (params within 1e-3 of each
    leaf's largest change)."""
    from repro_torch import configs, tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.training import (init_train_state, make_train_step,
                                      value_and_grad)

    torch = smoke.torch
    cfg = parity_cfg(configs.get(arch).FULL)
    paths = {"kernels": None, "baseline": "baseline"}
    bundles = {k: build(dataclasses.replace(cfg, policy=p))
               for k, p in paths.items()}
    opts = {k: OptConfig(policy=p) for k, p in paths.items()}
    state0 = init_train_state(torch.Generator(device="cuda").manual_seed(1),
                              bundles["kernels"], opts["kernels"])
    # an encoder-decoder's frames random, so that the gate sees its encoder
    # and cross-attention (zero frames give a zero memory)
    batch = with_frames(torch, cfg, SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0), device="cuda").device_batch(0),
        torch.Generator(device="cuda").manual_seed(2))
    grads = {k: value_and_grad(b, state0["params"], batch)[1]
             for k, b in bundles.items()}
    dgrad = [(a - b).abs().max() for a, b in zip(
        tree.leaves(grads["kernels"]), tree.leaves(grads["baseline"]))]
    grad_err = max(float(d / b.abs().max()) for d, b in zip(
        dgrad, tree.leaves(grads["baseline"])))
    del grads
    steps = {k: make_train_step(bundles[k], opts[k]) for k in paths}
    new = {k: steps[k](state0, batch) for k in paths}

    def compare(label, a, b, old, cond):
        (sa, ma), (sb, mb) = a, b
        loss = abs(ma["loss"].item() / mb["loss"].item() - 1)
        gnorm = abs(ma["grad_norm"].item() / mb["grad_norm"].item() - 1)
        if cond:   # the step clips both paths' gradients by about this
            clip = min(1.0, opts["kernels"].clip_norm
                       / (mb["grad_norm"].item() + 1e-9))
            gate = update_gate(sa["params"], sb["params"], old,
                               [clip * d for d in dgrad], sb["opt"]["m"],
                               mb["lr"].item())
        else:
            gate = update_gate(sa["params"], sb["params"], old)
        ok = loss <= 1e-4 and gnorm <= 1e-3 and gate["worst"] <= 1.0
        print(f"train {arch} f32 {cfg.n_layers} layers, {label}: loss rel "
              f"{loss:.3e} (tol 1e-4), grad_norm rel {gnorm:.3e} (tol 1e-3),"
              f" params worst {gate['worst']:.3f} of tolerance, "
              f"{gate['beyond_plain']} of {gate['elements']} elements beyond "
              "1e-3 of their leaf's largest change"
              f"{'' if ok else '  <-- OUT OF TOLERANCE'}", flush=True)
        if not ok:
            smoke.fail(f"train {arch} {label}: loss {loss}, grad_norm "
                       f"{gnorm}, params {gate}")
        return dict(loss_rel=loss, grad_norm_rel=gnorm, **gate)

    parity = compare("kernels vs baseline", new["kernels"],
                     new["baseline"], state0["params"], cond=True)
    print(f"train {arch} f32: gradient leaves, kernels vs baseline, worst "
          f"{grad_err:.3e} of the leaf's largest (tol 1e-3)", flush=True)
    if not grad_err <= 1e-3:
        smoke.fail(f"train {arch}: gradients differ by {grad_err} of the "
                   "leaf's largest")
    parity["grad_rel"] = grad_err
    del new["baseline"]

    s1 = new["kernels"][0]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(str(CKPT_DIR), 1, s1)
    save_s = time.perf_counter() - t0
    size_gb = sum(f.stat().st_size for f in CKPT_DIR.rglob("*")) / 1e9
    t0 = time.perf_counter()
    restored = ckpt.restore(str(CKPT_DIR), 1, s1)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    differ = [k for (k, a), b in zip(tree.items(s1), tree.leaves(restored))
              if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                      else a.dtype == b.dtype and torch.equal(a, b))]
    print(f"train {arch} f32: checkpoint {size_gb:.2f} GB saved in "
          f"{save_s:.2f} s, restored in {restore_s:.2f} s; leaves not bit "
          f"for bit: {differ}", flush=True)
    if differ:
        smoke.fail(f"train {arch}: restored leaves differ: {differ}")
    resumed = compare("resumed step vs the step in memory",
                      steps["kernels"](restored, batch),
                      steps["kernels"](s1, batch), s1["params"], cond=False)
    return dict(parity=parity, resumed=resumed, ckpt_gb=size_gb,
                ckpt_save_s=save_s, ckpt_restore_s=restore_s)


# ---------------------------------------------------------------------------
# the kernel policy on the card (repro_torch.core.policy, .autotune)


POLICY_MOE = "qwen3-moe-235b-a22b"
POLICY_SSD = "mamba2-1.3b"
TUNE_SPEC = "tile,ssd.q=32"          # the slice's served knob
# the card's table: written here (chiprun_out/ is not committed), merged
# over the checked-in cpu section
AUTOTUNE_OUT = Path(__file__).resolve().parent / "chiprun_out" / \
    "autotune_gpu.json"
# samples of each contender of a bucket: a median of AUTOTUNE_ITERS event
# pairs, each around AUTOTUNE_REPS calls (the grid is launch-bound)
AUTOTUNE_ITERS, AUTOTUNE_REPS = 15, 5
RESOLVE_CALLS = 20000
DECODE_ROUNDS = 60                  # rounds of one decode step of each policy
DEFAULT_TOKENS: dict = {}           # the served runs' tokens, by arch


def op_calls(torch, ops, kops, ref, gen) -> dict:
    """Each public op at a small card shape: (run under a policy, the
    kernel it launches, its plain version)."""
    x = torch.randn(64, 4096, generator=gen, device="cuda")
    la = -0.5 * torch.rand(64, 4096, generator=gen, device="cuda")
    h = torch.randn(64, 2048, generator=gen, device="cuda").bfloat16()
    w = torch.ones(2048, device="cuda", dtype=torch.bfloat16)
    ssd_in = ssd_inputs(torch, gen, 2, 256, 8, 64, 1, 128, torch.bfloat16)
    q, k, v = (torch.randn(2, 256, heads, 64, generator=gen,
                           device="cuda").bfloat16() for heads in (8, 2, 2))
    return {
        "reduce": (lambda p: ops.reduce(x, policy=p), "tcu_reduce",
                   lambda: ref.segmented_reduce_ref(x)),
        "scan": (lambda p: ops.scan(x, policy=p), "tcu_scan",
                 lambda: ref.segmented_scan_ref(x)),
        "weighted_scan": (lambda p: ops.weighted_scan(x, la, policy=p),
                          "weighted_scan",
                          lambda: ref.weighted_scan_ref(x, la)),
        "rmsnorm": (lambda p: ops.rmsnorm(h, w, policy=p), "rmsnorm",
                    lambda: ref.rmsnorm_ref(h, w)),
        "attention": (lambda p: ops.attention(q, k, v, policy=p),
                      "flash_attention",
                      lambda: kops.attention_plain(q, k, v)),
        "ssd": (lambda p: ops.ssd(*ssd_in, policy=p), "ssd_scan",
                lambda: ref.ssd_scan_ref(*ssd_in)),
    }


def resolution_checks(smoke: Smoke, ops, kops, ref) -> dict:
    """For each op on the card: the default ``auto`` resolves to
    ``tile_gpu`` by the heuristic (the checked-in table has no ``gpu``
    section) and launches its kernel once; ``interpret`` runs the plain
    version (the same numbers, no launch); ``tile_tpu`` raises. Then
    ``backend="cpu"`` gives ``interpret``, ``xla_tile``'s reduce matches
    ``baseline``, ``REPRO_KERNEL_PATH=fused`` and ``REPRO_AUTOTUNE=off`` are
    seen through ``default_policy()``, and one memoised ``resolve`` is
    timed."""
    import os

    from repro_torch import obs
    from repro_torch.core import policy as kpolicy

    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    calls = op_calls(torch, ops, kops, ref, gen)
    out: dict = {}
    for op, (run, kernel, plain) in calls.items():
        before = kops.launch_counts()[kernel]
        with obs.using_obs() as sess:
            run(None)
        launched = kops.launch_counts()[kernel] - before
        first = sess.events.events("resolution")[0]
        got = (first["chosen_path"], first["table_src"], launched)
        before = kops.launch_counts()[kernel]
        errs, scales = max_err(run("interpret"), plain())
        interp_ok = max(errs) <= 1e-6 * max(1.0, max(scales))
        interp_launched = kops.launch_counts()[kernel] - before
        try:
            run("tile_tpu")
            tpu = "ran"
        except RuntimeError:
            tpu = "raised"
        out[op] = dict(default=got, interpret_err=max(errs),
                       interpret_launches=interp_launched, tile_tpu=tpu)
        print(f"policy: {op} default auto -> {got[0]} ({got[1]}), "
              f"{kernel} launched {launched}; interpret max_abs_err vs "
              f"plain {max(errs):.3e}, launches {interp_launched}; tile_tpu "
              f"{tpu}", flush=True)
        if got != ("tile_gpu", "heuristic", 1) or interp_launched or \
                not interp_ok or tpu != "raised":
            smoke.fail(f"policy: {op} resolves or runs wrong on the card: "
                       f"{out[op]}")
    x = torch.randn(64, 4096, generator=gen, device="cuda")
    cpu_pref = kpolicy.KernelPolicy(path="tile", backend="cpu").resolve(
        op="reduce", n=4096, dtype=x.dtype, device=x.device)
    errs, scales = max_err(ops.reduce(x, policy="xla_tile"),
                           ops.reduce(x, policy="baseline"))
    xla_ok = max(errs) <= 2e-4 * max(1.0, max(scales))
    env = {}
    names = (kpolicy.ENV_PATH, kpolicy.ENV_AUTOTUNE)
    try:
        os.environ.update({kpolicy.ENV_PATH: "fused"})
        with obs.using_obs() as sess:
            ops.reduce(x)
        env["REPRO_KERNEL_PATH=fused"] = (
            kpolicy.default_policy().path,
            sess.events.events("resolution")[0]["chosen_path"])
        os.environ.pop(kpolicy.ENV_PATH)
        os.environ.update({kpolicy.ENV_AUTOTUNE: "off"})
        with obs.using_obs() as sess:
            ops.scan(x)
        ev = sess.events.events("resolution")[0]
        env["REPRO_AUTOTUNE=off"] = (kpolicy.default_policy().autotune,
                                     ev["chosen_path"], ev["table_src"])
    finally:
        for name in names:
            os.environ.pop(name, None)
    print(f"policy: backend='cpu' tile -> {cpu_pref}; xla_tile reduce vs "
          f"baseline max_abs_err {max(errs):.3e}; env through "
          f"default_policy(): {env}", flush=True)
    if cpu_pref != "interpret" or not xla_ok or env != {
            "REPRO_KERNEL_PATH=fused": ("fused", "fused"),
            "REPRO_AUTOTUNE=off": ("off", "tile_gpu", "static")}:
        smoke.fail(f"policy: backend/xla_tile/env checks: {cpu_pref}, "
                   f"{errs}, {env}")
    # one memoised resolution, as a model's eager op pays it
    pol = kpolicy.get_policy()
    resolve = pol.resolve
    resolve(op="scan", n=4096, dtype=x.dtype, device=x.device)
    t0 = time.perf_counter()
    for _ in range(RESOLVE_CALLS):
        resolve(op="scan", n=4096, dtype=x.dtype, device=x.device)
    resolve_us = 1e6 * (time.perf_counter() - t0) / RESOLVE_CALLS
    t0 = time.perf_counter()
    for _ in range(RESOLVE_CALLS):
        kpolicy.as_policy(None).resolve(op="scan", n=4096, dtype=x.dtype,
                                        device=x.device)
    default_us = 1e6 * (time.perf_counter() - t0) / RESOLVE_CALLS
    t0 = time.perf_counter()
    for _ in range(RESOLVE_CALLS):
        kpolicy.as_policy("tile").resolve(op="scan", n=4096, dtype=x.dtype,
                                          device=x.device)
    string_us = 1e6 * (time.perf_counter() - t0) / RESOLVE_CALLS
    print(f"policy: one memoised resolve {resolve_us:.3f} us; with the "
          f"active policy looked up {default_us:.3f} us; with a string "
          f"policy coerced {string_us:.3f} us (host clock, mean of "
          f"{RESOLVE_CALLS}; {smi_line()})", flush=True)
    return dict(ops=out, backend_cpu=cpu_pref, xla_tile_err=max(errs),
                env=env, resolve_us=resolve_us,
                resolve_default_us=default_us, resolve_string_us=string_us)


def knob_checks(smoke: Smoke, ops, kops, ref) -> dict:
    """``ssd.q=32`` at the served shape (B=4 L=468 H=64 P=64 N=128 bf16) on
    the tensor-core instance, held against the plain version and timed
    beside q = 64 (PERF.md row 3g); each log-depth candidate spec under
    ``tile_logdepth`` held against the plain version of the op, its
    ``kernel_invoke`` spec the clamped geometry, and timed; a knob no Hopper
    kernel takes (``attention.block_q``) warns once and is left out of the
    spec."""
    import warnings

    from repro_torch import obs
    from repro_torch.core import policy as kpolicy
    from repro_torch.kernels import layout

    torch = smoke.torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = (4, 468, 64, 64, 1, 128)
    ins = ssd_inputs(torch, gen, *shape, torch.bfloat16)
    before = kops.instance_counts()
    with kpolicy.using_policy(TUNE_SPEC), obs.using_obs() as sess:
        got = ops.ssd(*ins, return_state=True)
    after = kops.instance_counts()
    inst = {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}
    (inv,) = sess.events.events("kernel_invoke")
    errs, scales = max_err(got, ref.ssd_scan_ref(*ins, return_state=True))
    tols = [8e-3 * max(1.0, sc) for sc in scales]
    bsz, seqlen, nheads, hdim, _, nstate = shape
    row = {}
    for q in (spec["q"] for spec in layout.candidate_tuning("gpu", "ssd")):
        ms = smoke.time_ms(lambda q=q: kops.ssd_scan(
            *ins, tuning={"q": q}, return_state=True))
        spread = smoke.spread
        io = nbytes(*ins) + bsz * seqlen * nheads * hdim * 2 + \
            bsz * nheads * hdim * nstate * 4
        bms, by = bound(io, ssd_flops(bsz, seqlen, nheads, hdim, nstate, q),
                        torch.bfloat16)
        row[q] = dict(ms=ms, min=spread["min"], max=spread["max"],
                      bound_ms=bms, bound_by=by)
    plain_ms = smoke.time_ms(lambda: ref.ssd_scan_ref(*ins,
                                                      return_state=True),
                             max_iters=3)
    print(f"policy: ssd under {TUNE_SPEC!r} at B={bsz} L={seqlen} "
          f"H={nheads} P={hdim} N={nstate} bf16: instances {inst}, "
          f"kernel_invoke tuning {inv['tuning']}, max_abs_err "
          f"{[f'{e:.3e}' for e in errs]} (tol "
          f"{[f'{t:.3e}' for t in tols]}); row 3g: "
          + "; ".join(f"q={q} {r['ms']:.4f} ms (min {r['min']:.4f} max "
                      f"{r['max']:.4f}, bound {r['bound_ms']:.4f} "
                      f"{r['bound_by']})" for q, r in row.items())
          + f"; plain {plain_ms:.4f} ms ({smi_line()})", flush=True)
    if inst != {("ssd_scan", "mma"): 1} or inv["tuning"] != {"q": 32} or \
            not all(e <= t for e, t in zip(errs, tols)):
        smoke.fail(f"policy: ssd.q=32 did not run q = 32 on the tensor "
                   f"cores within tolerance: {inst}, {inv['tuning']}, "
                   f"{errs}")
    # the log-depth candidates of the sweep, on long rows and the SSD wave
    x = torch.randn(16, 1 << 20, generator=gen, device="cuda")
    la = -0.5 * torch.rand(16, 1 << 20, generator=gen, device="cuda")
    ssd_in = ssd_inputs(torch, gen, 4, 512, 64, 64, 1, 128, torch.bfloat16)
    cases = {
        "scan": (lambda p: ops.scan(x, policy=p),
                 lambda: ref.segmented_scan_ref(x), 1e-3, x.shape[-1]),
        "weighted_scan": (lambda p: ops.weighted_scan(x, la, policy=p),
                          lambda: ref.weighted_scan_ref(x, la), 2e-3,
                          x.shape[-1]),
        "ssd": (lambda p: ops.ssd(*ssd_in, policy=p, return_state=True),
                lambda: ref.ssd_scan_ref(*ssd_in, return_state=True), 8e-3,
                ssd_in[0].shape[1]),
    }
    sweep = []
    for op, specs in layout.LOGDEPTH_CANDIDATE_TUNING["gpu"].items():
        run, plain, rtol, n = cases[op]
        want = plain()
        for spec in specs:
            pol = kpolicy.KernelPolicy(path="tile_logdepth",
                                       op_tuning={op: spec})
            with obs.using_obs() as sess:
                got = run(pol)
            (inv,) = sess.events.events("kernel_invoke")
            errs, scales = max_err(got, want)
            tols = [rtol * max(1.0, sc) for sc in scales]
            ms = smoke.time_ms(lambda pol=pol, run=run: run(pol))
            ran = layout.clamp_spec("gpu", op, spec, n=n)
            ok = all(e <= t for e, t in zip(errs, tols)) and \
                inv["tuning"] == ran
            sweep.append(dict(op=op, spec=inv["tuning"], ms=ms,
                              max_abs_err=max(errs), tol=max(tols)))
            print(f"policy: {op} tile_logdepth {inv['tuning']}: {ms:.4f} ms"
                  f" (device, whole op), max_abs_err {max(errs):.3e} (tol "
                  f"{max(tols):.3e}){'' if ok else '  <-- FAIL'}",
                  flush=True)
            if not ok:
                smoke.fail(f"policy: {op} log-depth candidate {spec}: "
                           f"{errs} > {tols} or spec {inv['tuning']} != "
                           f"{ran}")
    # a knob no Hopper kernel takes: warned once, left out of the spec
    q, k, v = (torch.randn(2, 256, heads, 64, generator=gen,
                           device="cuda").bfloat16() for heads in (8, 2, 2))
    with warnings.catch_warnings(record=True) as rec, \
            obs.using_obs() as sess:
        warnings.simplefilter("always")
        for _ in range(2):
            kpolicy.invalidate_cache()      # resolve anew each time
            ops.attention(q, k, v, policy="tile,attention.block_q=128")
    warned = sum("attention.block_q" in str(r.message) for r in rec)
    specs = [e["tuning"] for e in sess.events.events("kernel_invoke")]
    print(f"policy: attention.block_q=128 warned {warned} time(s); "
          f"kernel_invoke tuning {specs}", flush=True)
    if warned != 1 or specs != [{}, {}]:
        smoke.fail(f"policy: attention.block_q warned {warned} times, "
                   f"specs {specs}")
    return dict(ssd_q32=dict(instances={f"{a}/{b}": n for (a, b), n in
                                        inst.items()},
                             max_abs_err=max(errs)),
                row_3g={str(q): r for q, r in row.items()},
                ssd_plain_ms=plain_ms, logdepth_sweep=sweep,
                block_q_warnings=warned)


def crossovers(us_by_band: dict, a: str, b: str) -> list:
    """The bands at which the faster of contenders ``a`` and ``b`` changes
    (each given as ``band: winner-of-the-pair``)."""
    out, last = [], None
    for band, us in sorted(us_by_band.items()):
        if a not in us or b not in us:
            continue
        win = a if us[a] <= us[b] else b
        if win != last:
            out.append(f"{band}:{win}")
        last = win
    return out


def measured_auto(smoke: Smoke) -> dict:
    """The autotune table measured on the card over the reference's grid
    (every op, f32 and bf16, bands 4-13), written to ``AUTOTUNE_OUT``
    merged over the checked-in ``cpu`` section and checked; each op's
    winners by band and where ``tile``, ``baseline`` and ``tile_logdepth``
    cross."""
    from repro_torch.core import autotune

    t0 = time.perf_counter()
    measured = autotune.measure_table(device="cuda", iters=AUTOTUNE_ITERS,
                                      reps=AUTOTUNE_REPS)
    seconds = time.perf_counter() - t0
    table = autotune.merge_tables(
        autotune.load_table(autotune.DEFAULT_TABLE_PATH), measured)
    AUTOTUNE_OUT.parent.mkdir(parents=True, exist_ok=True)
    autotune.save_table(table, AUTOTUNE_OUT)
    problems = {bk: autotune.check_default(AUTOTUNE_OUT, backend_key=bk)
                for bk in ("gpu", "cpu")}
    entries = measured["backends"]["gpu"]["entries"]
    summary = {}
    for op in autotune.OP_CONTENDERS:
        for tag in ("f32", "bf16"):
            us = {b: entries[f"{op}/{tag}/{b}"]["us"]
                  for b in autotune.DEFAULT_BANDS}
            wins = {b: entries[f"{op}/{tag}/{b}"]["path"]
                    for b in autotune.DEFAULT_BANDS}
            cross = {f"{a}|{b}": crossovers(us, a, b) for a, b in (
                ("tile", "baseline"), ("tile", "tile_logdepth"),
                ("baseline", "tile_logdepth"), ("tile", "fused"))}
            summary[f"{op}/{tag}"] = dict(winners=wins, crossovers=cross)
            print(f"autotune gpu {op}/{tag}: winners by band {wins}; "
                  f"crossovers (band:faster) {cross}; us by band "
                  + "; ".join(f"{b}: " + ",".join(
                      f"{k} {v:.1f}" for k, v in sorted(us[b].items()))
                      for b in autotune.DEFAULT_BANDS), flush=True)
    print(f"autotune: measured {len(entries)} gpu buckets in {seconds:.1f} "
          f"s (median of {AUTOTUNE_ITERS} event pairs of {AUTOTUNE_REPS} "
          f"calls a contender), wrote {AUTOTUNE_OUT}; check_default "
          f"{problems} ({smi_line()})", flush=True)
    if any(problems.values()):
        smoke.fail(f"autotune: the card's table fails check_default: "
                   f"{problems}")
    return dict(seconds=seconds, buckets=len(entries), summary=summary,
                check=problems)


def moe_under_table(smoke: Smoke, serve, kops) -> dict:
    """qwen3-moe (``CUTS``) served on the wave under
    ``KernelPolicy(autotune_table=AUTOTUNE_OUT)``: the resolutions the
    card's table moved off ``tile_gpu``, its tokens against the default
    run's, and its f32 prefill logits at ``PARITY_LAYERS`` layers against
    the default policy's within 1e-3 of the largest."""
    from repro_torch import obs
    from repro_torch.core.policy import KernelPolicy
    from repro_torch.models.common import cast_tree

    torch = smoke.torch
    table_pol = KernelPolicy(autotune_table=str(AUTOTUNE_OUT))
    engine = full_engine(serve, POLICY_MOE, policy=table_pol, slots=4,
                         max_new=16, scheduler="wave")
    cfg = engine.bundle.cfg
    engine.run(serve.make_requests(1, 16, cfg.vocab, seed=1))   # warm-up
    reqs = serve.make_requests(4, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    kops.reset_launches()
    with obs.using_obs() as sess:
        results = engine.run(reqs)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    tokens = [r.tokens for r in results]
    src = str(AUTOTUNE_OUT)
    res = sess.events.events("resolution")
    moved = sorted({(e["op"], e["n"], e["dtype"], e["level"],
                     e["chosen_path"]) for e in res
                    if e["table_src"] == src
                    and e["chosen_path"] != "tile_gpu"})
    from_table = sorted({(e["op"], e["n"], e["dtype"], e["chosen_path"])
                         for e in res if e["table_src"] == src})
    want = DEFAULT_TOKENS.get(POLICY_MOE)
    batch = {"tokens": wave_tokens(torch, reqs)}
    params = first_layers(engine.params, PARITY_LAYERS)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    params = cast_tree(params, torch.float32)
    got32 = prefill_fn(cfg, batch, table_pol, torch.float32, params,
                       PARITY_LAYERS)()
    want32 = prefill_fn(cfg, batch, None, torch.float32, params,
                        PARITY_LAYERS)()
    del params
    err = (got32 - want32).abs().max().item()
    tol = 1e-3 * want32.abs().max().item()
    print(f"policy: {POLICY_MOE} wave under the card's table: launches "
          f"{counts}; resolutions from the table {from_table}; moved off "
          f"tile_gpu {moved}; tokens "
          f"{'equal to' if tokens == want else 'DIFFER from'} the default "
          f"run's{'' if want is not None else ' (no default run)'}; f32 "
          f"prefill logits at {PARITY_LAYERS} layers vs the default policy "
          f"max_abs_err {err:.4e} (tol {tol:.4e})", flush=True)
    if want is None or tokens != want or not err <= tol or not from_table:
        smoke.fail(f"policy: {POLICY_MOE} under the card's table: tokens "
                   f"equal {tokens == want}, f32 logits {err} (tol {tol}), "
                   f"table resolutions {from_table}")
    return dict(launches=counts, moved=moved, from_table=from_table,
                tokens_equal=tokens == want, logits_f32_max_abs_err=err,
                logits_f32_tol=tol)


def ssd_knob_pass(smoke: Smoke, serve, kops, resolve_us) -> dict:
    """mamba2-1.3b whole on the wave under ``ModelConfig(policy=TUNE_SPEC)``:
    48 SSD launches at q = 32 a prefill, every one on the tensor-core
    instance; the prefill's SSD device ms beside the default policy's; the
    f32 logits at ``PARITY_LAYERS`` layers against the plain path within
    1e-3. Then the cost of resolving in a wave decode step: its
    resolutions (``resolution`` events of one step under the default
    policy) times ``resolve_us`` (one memoised resolve under the active
    policy, timed by ``resolution_checks``) must stay within 5% of the
    step's host ms. The step under the default policy and under the
    explicit string ``"tile"``, in turns, is printed beside it: a ratio of
    two host-clock steps of 40-60 ms, whose noise is of the size the gate
    bounds."""
    from repro_torch import obs
    from repro_torch.models import build
    from repro_torch.models.common import cast_tree
    from repro_torch.models.lm import pad_cache_seq

    torch = smoke.torch
    engine = serve.build_engine(POLICY_SSD, "full", device="cuda", seed=0,
                                policy=TUNE_SPEC, slots=4, max_new=16,
                                scheduler="wave")
    cfg = engine.bundle.cfg
    engine.run(serve.make_requests(1, 16, cfg.vocab, seed=1))   # warm-up
    reqs = serve.make_requests(4, 512, cfg.vocab, seed=0)
    for r in reqs:
        r.max_new = 16
    engine.prefills = engine.decodes = 0
    kops.reset_launches()
    with obs.using_obs() as sess:
        results = engine.run(reqs)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    instances = kops.instance_counts()
    ssd_specs = [e["tuning"] for e in sess.events.events("kernel_invoke")
                 if e["op"] == "ssd_scan"]
    want = cfg.n_layers * engine.prefills
    q_ok = (counts["ssd_scan"] == len(ssd_specs) == want
            and all(sp == {"q": 32} for sp in ssd_specs)
            and instances.get(("ssd_scan", "mma"), 0) == want
            and not instances.get(("ssd_scan", "fma")))
    print(f"policy: {POLICY_SSD} wave under ModelConfig(policy="
          f"{TUNE_SPEC!r}): {counts['ssd_scan']} ssd_scan launches over "
          f"{engine.prefills} prefill(s) (want {want}), specs "
          f"{sorted({str(sp) for sp in ssd_specs})}, instances "
          f"{instance_text(instances)}; "
          f"{sum(len(r.tokens) for r in results)} tokens", flush=True)
    if not q_ok or any(len(r.tokens) == 0 for r in results):
        smoke.fail(f"policy: {POLICY_SSD} under {TUNE_SPEC}: ssd launches "
                   f"{counts['ssd_scan']} (want {want}), specs "
                   f"{set(map(str, ssd_specs))}, instances {instances}")
    batch = {"tokens": wave_tokens(torch, reqs)}
    params = engine.params
    split = {p: device_split(torch, prefill_fn(cfg, batch, p, cfg.dtype,
                                               params))
             for p in (TUNE_SPEC, None)}
    ssd_ms = {str(p): (s or {}).get("ssd_scan") for p, s in split.items()}
    # the wave's decode step, default policy against the string "tile", in
    # turns on one cache each
    bundles = {"default": build(dataclasses.replace(cfg, policy=None)),
               "tile": build(dataclasses.replace(cfg, policy="tile"))}
    step = {"tokens": batch["tokens"][:, -1:]}
    caches = {k: pad_cache_seq(b.prefill_last(params, batch)[1], 2)
              for k, b in bundles.items()}
    times = {k: [] for k in bundles}
    for k, b in bundles.items():
        b.decode(params, caches[k], step)
    torch.cuda.synchronize()
    for i in range(DECODE_ROUNDS):
        for k in (("default", "tile") if i % 2 == 0 else ("tile",
                                                          "default")):
            t0 = time.perf_counter()
            bundles[k].decode(params, caches[k], step)
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
    decode_ms = {k: statistics.median(v) for k, v in times.items()}
    # the host clock drifts by tens of percent over the run: each round's
    # two steps are neighbours in time, so the rounds' ratios are what the
    # policies differ by (printed, not gated: see the docstring)
    ratios = [d / t for d, t in zip(times["default"], times["tile"])]
    ratio = statistics.median(ratios)
    quartiles = statistics.quantiles(ratios, n=4)
    with obs.using_obs() as sess:
        bundles["default"].decode(params, caches["default"], step)
    torch.cuda.synchronize()
    resolutions = len(sess.events.events("resolution"))
    resolve_ms = (float("nan") if resolve_us is None
                  else resolutions * resolve_us / 1e3)
    resolve_share = resolve_ms / decode_ms["default"]
    print(f"policy: {POLICY_SSD} prefill {batch_text(batch)} SSD device ms "
          f"(torch.profiler, one prefill) under {TUNE_SPEC!r} "
          f"{ssd_ms[TUNE_SPEC]} vs the default {ssd_ms['None']}; wave "
          f"decode step host ms (median of {DECODE_ROUNDS}, in turns): "
          f"default policy {decode_ms['default']:.3f} (min "
          f"{min(times['default']):.3f} max {max(times['default']):.3f}), "
          f"policy 'tile' {decode_ms['tile']:.3f} (min "
          f"{min(times['tile']):.3f} max {max(times['tile']):.3f}), "
          f"ratio of a round's two steps median {ratio:.4f} quartiles "
          f"{quartiles[0]:.4f} {quartiles[2]:.4f}; resolving in one "
          f"default step: {resolutions} resolutions x {resolve_us} us = "
          f"{resolve_ms:.4f} ms, {resolve_share:.5f} of the step "
          f"({smi_line()})", flush=True)
    if not resolutions or not resolve_share <= 0.05:
        smoke.fail(f"policy: resolving adds {resolve_ms} ms "
                   f"({resolutions} resolutions x {resolve_us} us) to a "
                   f"{decode_ms['default']:.3f} ms decode step (want within "
                   f"5%)")
    depth = PARITY_LAYERS
    del engine, bundles, caches
    params = cast_tree(first_layers(params, depth), torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    got32 = prefill_fn(cfg, batch, TUNE_SPEC, torch.float32, params,
                       depth)()
    want32 = prefill_fn(cfg, batch, "baseline", torch.float32, params,
                        depth)()
    err = (got32 - want32).abs().max().item()
    tol = 1e-3 * want32.abs().max().item()
    print(f"policy: {POLICY_SSD} f32 last-token logits at {depth} layers "
          f"under {TUNE_SPEC!r} vs the plain path: max_abs_err {err:.4e} "
          f"(tol {tol:.4e})", flush=True)
    if not err <= tol:
        smoke.fail(f"policy: {POLICY_SSD} under {TUNE_SPEC}: f32 logits "
                   f"{err} > {tol}")
    return dict(launches=counts, ssd_launches=counts["ssd_scan"],
                ssd_device_ms=ssd_ms, decode_step_ms=decode_ms,
                decode_ratio=ratio, decode_ratio_quartiles=quartiles,
                decode_resolutions=resolutions, resolve_ms=resolve_ms,
                resolve_share=resolve_share, logits_f32_max_abs_err=err,
                logits_f32_tol=tol)


def policy_pass(smoke: Smoke, serve, ops, kops, ref) -> dict:
    """The kernel policy on the card: labels and env vars, tuning knobs,
    the measured ``auto``, then the two served runs (each with its own
    launch counts; their sum is this phase's)."""
    stats: dict = {}
    for name, fn in (("resolution", lambda: resolution_checks(
                          smoke, ops, kops, ref)),
                     ("knobs", lambda: knob_checks(smoke, ops, kops, ref)),
                     ("autotune", lambda: measured_auto(smoke))):
        try:
            stats[name] = fn()
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"policy {name}: {exc!r}")
    launches = {k: 0 for k in kops.KERNELS}
    for name, fn in (("moe under the card's table",
                      lambda: moe_under_table(smoke, serve, kops)),
                     (f"{POLICY_SSD} {TUNE_SPEC}",
                      lambda: ssd_knob_pass(
                          smoke, serve, kops, stats.get("resolution", {}).get(
                              "resolve_default_us")))):
        try:
            stats[name] = fn()
            for k, n in stats[name]["launches"].items():
                launches[k] += n
        except Exception as exc:  # a phase that raises is a failed phase
            smoke.fail(f"policy {name}: {exc!r}")
        gc.collect()
        smoke.torch.cuda.empty_cache()
    stats["launches"] = launches
    return stats


# ---------------------------------------------------------------------------
# the distributed phase: a gloo world of DIST_RANKS processes on the one card
# (NCCL refuses two ranks on one device); the per-shard kernels are the
# Hopper kernels, the collectives move shard totals and states through host
# memory

DIST_RANKS = 4
DIST_TIMEOUT_S = 420                # the whole world, start to exit
DIST_REPS = 5                       # timed repetitions of each call
# llama3.2-1b's tied embedding (128256 x 2048): the train step's global
# norm's largest leaf (row 1f)
DIST_REDUCE_N = 128256 * 2048
DIST_SCAN = (16, 1 << 20)           # rows 2d and 3b3
# mamba2-1.3b's layer (B, L, H, P, G, N), sequence-sharded, as the
# reference's examples/ssd_long_context.py shards it; f32 at a shorter L
DIST_SSD = {"bf16": (1, 65536, 64, 64, 1, 128),
            "f32": (1, 8192, 64, 64, 1, 128)}
# GPipe: 4 stages x 8 microbatches of 4 x 512 rows at d 2048
DIST_PIPE = dict(stages=4, microbatches=8, rows=(4, 512), d=2048)
DIST_OPS = ("reduce", "scan", "weighted_scan", "ssd")
DIST_KERNEL = {"reduce": "tcu_reduce", "scan": "tcu_scan",
               "weighted_scan": "weighted_scan", "ssd": "ssd_scan"}


def dist_inputs(torch, name: str):
    """One op's whole inputs on the card from seed 0, the same on every
    rank."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    if name == "reduce":            # positive, as the global norm's squares
        return (torch.rand(1, DIST_REDUCE_N, generator=gen, device="cuda"),)
    if name == "scan":
        return (torch.randn(*DIST_SCAN, generator=gen, device="cuda"),)
    if name == "weighted_scan":     # log-decays in (-1, 0]
        x = torch.randn(*DIST_SCAN, generator=gen, device="cuda")
        return x, -torch.rand(*DIST_SCAN, generator=gen, device="cuda")
    if name in ("ssd", "ssd_f32"):
        tag = "bf16" if name == "ssd" else "f32"
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        return ssd_inputs(torch, gen, *DIST_SSD[tag], dtype)
    if name == "pipeline":
        s, d = DIST_PIPE["stages"], DIST_PIPE["d"]
        rows = DIST_PIPE["microbatches"] * DIST_PIPE["rows"][0]
        x = torch.randn(rows, DIST_PIPE["rows"][1], d, generator=gen,
                        device="cuda")
        params = {
            "g": 1.0 + 0.1 * torch.randn(s, d, generator=gen, device="cuda"),
            "w1": torch.randn(s, d, d, generator=gen, device="cuda")
            / d ** 0.5,
            "w2": torch.randn(s, d, d, generator=gen, device="cuda")
            / d ** 0.5}
        return x, params
    raise ValueError(name)


def pipe_block(torch, ops, p, x):
    """One stage: ``x + W2 silu(W1 rmsnorm(x))``, the RMSNorm on its
    kernel."""
    h = ops.rmsnorm(x, p["g"])
    return x + torch.nn.functional.silu(h @ p["w1"]) @ p["w2"]


def ssd_f64(torch, x, dt, a, b, c, seg: int = 256):
    """The SSD recurrence in f64, independent of the port's forms: segments
    of ``seg`` positions in the quadratic form, the state carried between
    them in sequence. Returns (y, final state)."""
    bsz, seqlen, heads, hdim = x.shape
    rep = heads // b.shape[2]
    f64 = torch.float64
    xdt = x.to(f64) * dt.to(f64)[..., None]                   # (B,L,H,P)
    lam = dt.to(f64) * a.to(f64)                              # (B,L,H)
    bf = torch.repeat_interleave(b.to(f64), rep, dim=2)       # (B,L,H,N)
    cf = torch.repeat_interleave(c.to(f64), rep, dim=2)
    h = torch.zeros(bsz, heads, hdim, bf.shape[-1], dtype=f64,
                    device=x.device)
    ys = []
    for s0 in range(0, seqlen, seg):
        sl = slice(s0, min(seqlen, s0 + seg))
        cum = torch.cumsum(lam[:, sl], dim=1)                 # (B,q,H)
        q = cum.shape[1]
        tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        diff = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~tri[None, :, :, None], float("-inf"))            # (B,q,q,H)
        cb = torch.einsum("bihn,bjhn->bijh", cf[:, sl], bf[:, sl])
        y = torch.einsum("bijh,bjhp->bihp", cb * torch.exp(diff), xdt[:, sl])
        y = y + torch.einsum("bihn,bhpn->bihp",
                             cf[:, sl] * torch.exp(cum)[..., None], h)
        w = torch.exp(cum[:, -1:] - cum)                      # (B,q,H)
        h = torch.exp(cum[:, -1])[..., None, None] * h + torch.einsum(
            "bjhp,bjhn->bhpn", xdt[:, sl] * w[..., None], bf[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def weighted_f64(torch, x, la):
    """The decayed scan in f64 by a log-step scan of (decay, state) pairs."""
    a = torch.exp(la.to(torch.float64))
    y = x.to(torch.float64)
    d = 1
    while d < y.shape[-1]:
        y = torch.cat([y[..., :d], y[..., d:] + a[..., d:] * y[..., :-d]], -1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1)
        d *= 2
    return y


def dist_f64(torch, name: str, ins):
    """The f64 plain result of one op on its whole inputs."""
    if name == "reduce":
        return (ins[0].to(torch.float64).sum(-1),)
    if name == "scan":
        return (torch.cumsum(ins[0].to(torch.float64), -1),)
    if name == "weighted_scan":
        return (weighted_f64(torch, *ins),)
    return ssd_f64(torch, *ins)


def wall_ms(torch, dist, fn, reps: int = DIST_REPS) -> list:
    """Host ms of ``fn`` to its last kernel's end, every rank starting
    together (a barrier before each call), ``reps`` times after a warm
    call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def dist_local(dispatch, name: str, locs):
    """One op on this rank's local shards, the sharded call's first part."""
    if name == "ssd":
        return dispatch.ssd(*locs, return_state=True)
    return getattr(dispatch, name)(*locs)


def dist_parts(torch, name: str, part, locs, group):
    """The sharded call's other two parts on this rank's local result
    ``part``: the collective combine and the carry's injection (None for
    the reduce, whose all-reduce is the whole combine)."""
    from repro_torch.core.distributed import (
        all_reduce_sum,
        dist_exclusive_carry,
        weighted_exclusive_carry,
    )
    from repro_torch.parallel.shard_ops import ssd_inject, weighted_inject

    if name == "reduce":
        return (lambda: all_reduce_sum(part, group)), None
    if name == "scan":
        carry = dist_exclusive_carry(part[..., -1], group)
        return ((lambda: dist_exclusive_carry(part[..., -1], group)),
                lambda: part + carry[..., None])
    if name == "weighted_scan":
        decay = locs[1].float().sum(-1)
        carry = weighted_exclusive_carry(part[..., -1], decay, group)
        return ((lambda: weighted_exclusive_carry(part[..., -1], decay,
                                                  group)),
                lambda: weighted_inject(part, locs[1], carry))
    y_loc, h_loc = part
    lam = locs[1].float() * locs[2].float()
    decay = lam.sum(1)
    h_in = weighted_exclusive_carry(h_loc, decay, group)
    return ((lambda: weighted_exclusive_carry(h_loc, decay, group)),
            lambda: ssd_inject(y_loc, locs[4], lam, h_in))


def ulp32(v: float) -> float:
    """One f32 ulp at magnitude ``v``."""
    return float(np.spacing(np.float32(abs(v))))


def dist_worker(rank: int, world: int, out_dir: str) -> int:
    """One rank of the distributed phase (``chip_smoke.py --dist-worker
    RANK WORLD DIR``): its shards through ``repro_torch.ops`` on DTensors
    under ``make_context``, its errors against the f64 plain result of the
    whole input, its times, launches and routed calls, into
    ``DIR/rank<RANK>.json``. Rank 0 also runs each op unsharded."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import ops
    from repro_torch.core import dispatch
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import using_obs
    from repro_torch.parallel import make_context, shard_local_scope
    from repro_torch.parallel.pipeline import (
        PipelineConfig,
        pipeline_apply,
        pipeline_stats,
    )

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()                        # the parent built it: a cache hit
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/init",
                            rank=rank, world_size=world)
    report: dict = {"rank": rank}
    try:
        ctx = make_context(f"data={world}", device="cuda",
                           op_shard_axes={op: "data" for op in DIST_OPS})
        group = ctx.mesh.get_group("data")
        report["backend"] = dist.get_backend(group)
        report["init_s"] = time.perf_counter() - t_start

        def shard(t, dim):
            n = t.shape[dim] // world
            return DTensor.from_local(t.narrow(dim, rank * n, n).contiguous(),
                                      ctx.mesh, [Shard(dim)],
                                      run_check=False)

        def piece(t, dim):
            n = t.shape[dim] // world
            return t.narrow(dim, rank * n, n)

        shards, wholes = {}, {}
        for name in ("reduce", "scan", "weighted_scan", "ssd", "ssd_f32"):
            ins = dist_inputs(torch, name)
            dim = 1 if name.startswith("ssd") else -1
            if name.startswith("ssd"):
                x, dt, a, b, c = ins
                shards[name] = (shard(x, 1), shard(dt, 1), a, shard(b, 1),
                                shard(c, 1))
            else:
                shards[name] = tuple(shard(t, dim) for t in ins)
            wholes[name] = ins if rank == 0 or name == "ssd_f32" else None
            del ins

        # the main path: every count from 0, one call of each op
        kops.reset_launches()
        with torch.inference_mode(), using_obs() as sess, ctx:
            out = {"reduce": (ops.reduce(*shards["reduce"]),),
                   "scan": (ops.scan(*shards["scan"]),),
                   "weighted_scan": (ops.weighted_scan(
                       *shards["weighted_scan"]),),
                   "ssd": ops.ssd(*shards["ssd"], return_state=True)}
        torch.cuda.synchronize()
        report["launches"] = kops.launch_counts()
        report["instances"] = {f"{k}/{i}": n for (k, i), n in
                               kops.instance_counts().items()}
        report["routed"] = {k: v for k, v in
                            prom_values(sess.prometheus_text()).items()
                            if k.startswith("repro_sharded_dispatch_total")}
        report["route_events"] = len(sess.events.events("sharded_dispatch"))
        with torch.inference_mode(), ctx:
            kops.reset_launches()
            out["ssd_f32"] = ops.ssd(*shards["ssd_f32"], return_state=True)
            torch.cuda.synchronize()
            report["launches_ssd_f32"] = kops.launch_counts()
            report["instances_ssd_f32"] = {
                f"{k}/{i}": n for (k, i), n in
                kops.instance_counts().items()}

        # errors against the f64 plain result of the whole input: this
        # rank's piece of the sharded results; the state and the reduce
        # are replicated
        errs = {}
        with torch.inference_mode():
            for name in ("reduce", "scan", "weighted_scan", "ssd"):
                want = dist_f64(torch, name, dist_inputs(torch, name))
                got = [t.to_local() for t in out[name]]
                if name in ("scan", "weighted_scan"):
                    want = (piece(want[0], -1),)
                if name == "ssd":
                    want = (piece(want[0], 1), want[1])
                errs[name] = [float((g.double() - w).abs().max())
                              for g, w in zip(got, want)]
                errs[name + "_scale"] = [float(w.abs().max()) for w in want]
                del want
            # the f32 SSD against the unsharded op on this rank
            y_u, h_u = ops.ssd(*wholes["ssd_f32"], return_state=True)
            y_s, h_s = (t.to_local() for t in out["ssd_f32"])
            errs["ssd_f32_vs_unsharded"] = [
                float(((y_s - piece(y_u, 1)).abs()
                       - 2e-3 * piece(y_u, 1).abs()).max()),
                float(((h_s - h_u).abs() - 2e-3 * h_u.abs()).max())]
            errs["ssd_f32_abs"] = [float((y_s - piece(y_u, 1)).abs().max()),
                                   float((h_s - h_u).abs().max())]
        report["errors"] = errs

        # times: the sharded call whole, then its parts on the same shards
        timing = {}
        with torch.inference_mode():
            for name in ("reduce", "scan", "weighted_scan", "ssd"):
                sh = shards[name]
                locs = [t.to_local() if isinstance(t, DTensor) else t
                        for t in sh]
                with ctx:
                    whole = {"reduce": lambda: ops.reduce(*sh),
                             "scan": lambda: ops.scan(*sh),
                             "weighted_scan": lambda: ops.weighted_scan(*sh),
                             "ssd": lambda: ops.ssd(*sh, return_state=True)
                             }[name]
                    t_whole = wall_ms(torch, dist, whole)
                with shard_local_scope():
                    t_local = wall_ms(torch, dist, lambda: dist_local(
                        dispatch, name, locs))
                    part = dist_local(dispatch, name, locs)
                coll, inject = dist_parts(torch, name, part, locs,
                                          (ctx.mesh, "data"))
                timing[name] = {
                    "whole": t_whole, "local": t_local,
                    "collective": wall_ms(torch, dist, coll),
                    "inject": wall_ms(torch, dist, inject) if inject
                    else [0.0]}
            # rank 0 alone on the card: each op unsharded, whole input
            if rank == 0:
                for name in ("reduce", "scan", "weighted_scan", "ssd"):
                    ins = wholes[name]
                    fn = {"reduce": lambda: ops.reduce(*ins),
                          "scan": lambda: ops.scan(*ins),
                          "weighted_scan": lambda: ops.weighted_scan(*ins),
                          "ssd": lambda: ops.ssd(*ins, return_state=True)
                          }[name]
                    got = fn()
                    got = got if isinstance(got, tuple) else (got,)
                    want = dist_f64(torch, name, ins)
                    errs[name + "_unsharded"] = [
                        float((g.double() - w).abs().max())
                        for g, w in zip(got, want)]
                    del want, got
                    t0 = []
                    fn()
                    for _ in range(DIST_REPS):
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        t0.append(1e3 * (time.perf_counter() - t1))
                    timing[name]["unsharded"] = t0
            dist.barrier()
        report["timing"] = timing
        del shards, wholes, out

        # GPipe over a stage mesh: the rmsnorm kernel in every block
        stage = init_device_mesh("cuda", (world,), mesh_dim_names=("stage",))
        x, params = dist_inputs(torch, "pipeline")
        cfg = PipelineConfig(n_stages=DIST_PIPE["stages"],
                             n_microbatches=DIST_PIPE["microbatches"])

        def block(p, h):
            return pipe_block(torch, ops, p, h)

        with torch.inference_mode():
            kops.reset_launches()
            y = pipeline_apply(block, params, x, cfg, stage)
            torch.cuda.synchronize()
            report["launches_pipeline"] = kops.launch_counts()
            report["pipe_stats"] = pipeline_stats(cfg)
            report["timing"]["pipeline"] = {"whole": wall_ms(
                torch, dist, lambda: pipeline_apply(block, params, x, cfg,
                                                    stage), reps=3)}
            m = cfg.n_microbatches
            xq = x.reshape(m, -1, *x.shape[1:])
            per_mb = []
            for i in range(m):          # the sequential run, microbatch by
                h = xq[i]               # microbatch: the pipeline's shapes
                for s in range(cfg.n_stages):
                    h = block({k: v[s] for k, v in params.items()}, h)
                per_mb.append(h)
            seq = torch.stack(per_mb).reshape(x.shape)
            full = x                    # and the whole batch at once
            for s in range(cfg.n_stages):
                full = block({k: v[s] for k, v in params.items()}, full)
            report["pipe_err"] = float((y - seq).abs().max())
            report["pipe_err_full_batch"] = float((y - full).abs().max())
            report["pipe_scale"] = float(full.abs().max())
        dist.barrier()
        report["seconds"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    return 0


def dist_text(values: list) -> str:
    return (f"{statistics.median(values):.3f} ms "
            f"[{min(values):.3f}, {max(values):.3f}]")


def distributed_pass(smoke: Smoke, kops) -> dict:
    """The multi-device reduce, scan, weighted scan, SSD and GPipe schedule
    of ``repro_torch.parallel`` in a gloo world of DIST_RANKS processes on
    the one card (``--dist-worker``), gated here on what the ranks report:
    each sharded result's largest error against the f64 plain result of
    the whole input at most twice the unsharded kernel's own (floored at
    one f32 ulp of the result, as a replicated scalar's error is one
    sample), the f32 SSD's y and state within 2e-3 of the unsharded op,
    the pipeline within 1e-5 of the sequential run, the per-shard kernel
    launched on every rank (the SSD on the mma instance), four routed
    calls a rank."""
    torch = smoke.torch
    out_dir = OBS_DIR.parent / "dist_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    logs = [out_dir / f"rank{r}.log" for r in range(DIST_RANKS)]
    procs = []
    try:
        for r in range(DIST_RANKS):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--dist-worker", str(r), str(DIST_RANKS),
                     str(out_dir)], stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(1.0, DIST_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            print(f"distributed: rank {r} exit {procs[r].returncode}:\n"
                  f"{logs[r].read_text()[-3000:]}", flush=True)
        raise RuntimeError(f"distributed ranks {bad} failed")
    reports = [json.loads((out_dir / f"rank{r}.json").read_text())
               for r in range(DIST_RANKS)]
    shutil.rmtree(out_dir, ignore_errors=True)
    smi = smi_line()
    backend = {r["backend"] for r in reports}
    print(f"distributed: {DIST_RANKS} ranks on one card ({smi}), backend "
          f"{'/'.join(sorted(backend))}, staged through host memory: one "
          "card (NCCL not exercised: it refuses two ranks on one device); "
          f"world up in {max(r['init_s'] for r in reports):.1f} s",
          flush=True)
    if backend != {"gloo"}:
        smoke.fail(f"distributed: backend {backend}, want gloo")
    launches = {k: 0 for k in kops.KERNELS}
    r0 = reports[0]
    errs0 = r0["errors"]
    for rep in reports:
        rank = rep["rank"]
        counts = rep["launches"]
        for op in DIST_OPS:
            if counts[DIST_KERNEL[op]] < 1:
                smoke.fail(f"distributed rank {rank}: {op} launched "
                           f"{DIST_KERNEL[op]} no time ({counts})")
        if rep["instances"].get("ssd_scan/mma", 0) < 1 or \
                rep["instances"].get("ssd_scan/fma", 0):
            smoke.fail(f"distributed rank {rank}: bf16 SSD instances "
                       f"{rep['instances']}, want mma only")
        routed = sum(rep["routed"].values())
        if routed != 4 or rep["route_events"] != 4:
            smoke.fail(f"distributed rank {rank}: {routed} routed calls "
                       f"({rep['routed']}), {rep['route_events']} events, "
                       "want 4")
        if rep["launches_ssd_f32"]["ssd_scan"] < 1:
            smoke.fail(f"distributed rank {rank}: the f32 SSD launched no "
                       "ssd_scan")
        if rep["launches_pipeline"]["rmsnorm"] != \
                rep["pipe_stats"]["ticks"]:
            smoke.fail(f"distributed rank {rank}: pipeline rmsnorm "
                       f"{rep['launches_pipeline']['rmsnorm']}, want one a "
                       f"tick ({rep['pipe_stats']['ticks']})")
        for part in ("launches", "launches_ssd_f32", "launches_pipeline"):
            for k, n in rep[part].items():
                launches[k] += n
        errs = rep["errors"]
        for op in DIST_OPS:
            for i, (e, e_u, scale) in enumerate(zip(
                    errs[op], errs0[op + "_unsharded"], errs[op + "_scale"])):
                limit = 2.0 * max(e_u, ulp32(scale))
                if not e <= limit:
                    smoke.fail(f"distributed rank {rank}: {op} output {i} "
                               f"error {e:.3e} > {limit:.3e} (twice the "
                               f"unsharded kernel's {e_u:.3e})")
        worst = max(errs["ssd_f32_vs_unsharded"])
        if not worst <= 2e-3:
            smoke.fail(f"distributed rank {rank}: f32 SSD |sharded - "
                       f"unsharded| - 2e-3 |unsharded| reaches {worst:.3e} "
                       "over 2e-3")
        if not rep["pipe_err"] <= 1e-5:
            smoke.fail(f"distributed rank {rank}: pipeline differs from the "
                       f"sequential run by {rep['pipe_err']:.3e} > 1e-5")
    rows = {}
    for op in DIST_OPS + ("pipeline",):
        per_rank = [rep["timing"][op] for rep in reports]
        line = [f"distributed {op}:"]
        for rep, t in zip(reports, per_rank):
            parts = ", ".join(f"{k} {statistics.median(t[k]):.3f}"
                              for k in ("local", "collective", "inject")
                              if k in t)
            line.append(f"rank {rep['rank']} {dist_text(t['whole'])}"
                        + (f" ({parts})" if parts else ""))
        if "unsharded" in per_rank[0]:
            line.append(f"unsharded, one process "
                        f"{dist_text(per_rank[0]['unsharded'])}")
        if op in DIST_OPS:
            line.append("max err " + ", ".join(
                f"{max(rep['errors'][op][i] for rep in reports):.3e}"
                for i in range(len(errs0[op])))
                + " vs unsharded " + ", ".join(
                f"{e:.3e}" for e in errs0[op + "_unsharded"]))
        print("; ".join(line), flush=True)
        rows[op] = {
            "ms_whole_per_rank": [statistics.median(t["whole"])
                                  for t in per_rank],
            **{f"ms_{k}_per_rank": [statistics.median(t[k])
                                    for t in per_rank]
               for k in ("local", "collective", "inject")
               if k in per_rank[0]},
            "ms_unsharded": (statistics.median(per_rank[0]["unsharded"])
                             if "unsharded" in per_rank[0] else None),
            "max_err": ([max(rep["errors"][op][i] for rep in reports)
                         for i in range(len(errs0[op]))]
                        if op in DIST_OPS else None),
            "unsharded_err": errs0.get(op + "_unsharded")}
    print("distributed f32 SSD: |sharded - unsharded| y "
          f"{max(r['errors']['ssd_f32_abs'][0] for r in reports):.3e}, "
          f"state {max(r['errors']['ssd_f32_abs'][1] for r in reports):.3e}"
          "; pipeline: ticks "
          f"{r0['pipe_stats']['ticks']}, bubble "
          f"{r0['pipe_stats']['bubble_fraction']:.4f}, |pipe - sequential| "
          f"{max(r['pipe_err'] for r in reports):.3e} (by microbatch), "
          f"{max(r['pipe_err_full_batch'] for r in reports):.3e} (whole "
          f"batch, outputs up to {r0['pipe_scale']:.3f})", flush=True)
    print(f"distributed: ranks' launches {launches}; ranks' seconds "
          f"{[round(r['seconds'], 1) for r in reports]}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "ops": rows, "backend": sorted(backend)}


# ---------------------------------------------------------------------------
# sharded training and lockstep serving (``sharded_pass``)

SHARD_ARCH = "llama3.2-1b"
# trained on the mesh, each through the tensor-parallel step; the first's
# state is checkpointed for the serving world. The MoE is not: qwen3-moe at
# one layer (3.7 B parameters at its published widths) took 18.2 GiB a
# rank at the optimizer's update with AdamW and 17.4 with Adafactor, over
# the card for four ranks (PERF.md §4); the CPU tests hold its split step
SHARD_TRAIN_ARCHS = (SHARD_ARCH, "mamba2-1.3b", "seamless-m4t-medium")
SHARD_TRAIN_MESH = "data=2,model=2"
# depths cut to keep the script inside its time limit (llama whole: its
# peak is gated against the gather-whole step's at the same depth;
# seamless: encoder and decoder alike)
SHARD_TRAIN_LAYERS = {"mamba2-1.3b": 8, "seamless-m4t-medium": 4}
# llama trained again through the gather-whole step (every family's step on
# a mesh without a split model dim) on a data-only mesh of the same world,
# at this depth
SHARD_GATHER_MESH = "data=4"
SHARD_GATHER_LAYERS = 2
# llama's peak GB a training rank under the gather-whole step, which
# gathers every bf16 weight and gradient whole (this phase's earlier
# measurement on the H100); the tensor-parallel step must stay below it
SHARD_GATHER_WHOLE_PEAK_GB = 10.04
SHARD_SERVE_MESH = "data=2,model=2"
# served on SHARD_SERVE_MESH in lockstep at these depths (None: whole):
# llama's params from the training world's checkpoint, the others' drawn
# from seed 0; 4 slots, 2 a data rank
SHARD_SERVE = ((SHARD_ARCH, None), ("mamba2-1.3b", 8), ("zamba2-2.7b", 12))
# the model=2 path of PRs 27-29 (heads over model, the slots whole), held
# in f32 at PARITY_LAYERS: two replicas of a model=2 mesh in the same world
# (the batch rule names no ``replica`` dim)
SHARD_REPLICAS = (("replica", 2), ("model", 2))
# the wave steps under the production rules' seq_shard=True on
# SHARD_SERVE_MESH: (arch, depth, rows, prompt tokens, cache rows), then
# SHARD_DECODES decode steps; the rows over data where they divide it, the
# cache's rows over model (and data for the one row)
SHARD_WAVES = ((SHARD_ARCH, None, 4, 2032, 2048),
               (SHARD_ARCH, None, 1, 8176, 8192),
               ("mamba2-1.3b", 8, 4, 2032, None))
SHARD_DECODES = 16
# the MoE served on SHARD_SERVE_MESH like SHARD_SERVE, its experts over
# model: (arch, depth, caches); each rank draws its shards leaf by leaf
SHARD_MOE_SERVE = (("qwen3-moe-235b-a22b", 4, ("ring", "paged")),
                   ("grok-1-314b", 2, ("ring",)))
# their f32 gates' depths: four ranks' shares, then one whole f32 copy on
# rank 0 alone, fit the card
SHARD_MOE_PARITY = {"qwen3-moe-235b-a22b": 2, "grok-1-314b": 1}
# the encoder-decoder's wave steps on SHARD_SERVE_MESH through
# make_serve_step, whole: (rules, rows, frames, prompt tokens, self-cache
# rows), rules "mesh" the default table (the KV heads over model) or "seq"
# the production rules' seq_shard (the self and cross caches' rows over
# model), then SHARD_DECODES decode steps
SHARD_ENCDEC = "seamless-m4t-medium"
SHARD_ENCDEC_WAVES = (("mesh", 4, 512, 468, 484), ("seq", 4, 512, 468, 484))
# the f32 gates' requests of the data=2,model=2 engines: 8 prompts of up
# to this many tokens (the served runs' 512 cut, to keep the phase inside
# the script's time limit), 4 new tokens each; the model=2 path is held on
# the served runs' 8 x 512 with 16 new tokens, as before
SHARD_PARITY_PROMPT, SHARD_PARITY_NEW = 64, 4
SHARD_BATCH, SHARD_SEQ = 4, 512     # global batch, 2 x 512 rows a data rank
SHARD_TIMED = 2                     # timed steps after one warm step
SHARD_LR = 3e-4
SHARD_TIMEOUT_S = 900               # each world, start to exit
SHARD_CKPT = OBS_DIR.parent / "sharded_ckpt"
DIGEST_P = (1 << 31) - 1


def rank_state_gb(n_params: int, layers: int, d: int, vocab: int,
                  ranks: int, rows: int, seq: int) -> dict:
    """The bytes a training rank holds, reckoned before the run: its
    quarter of the f32 state (masters, m, v), the gathered bf16 params, their
    whole bf16 gradient before the reduce-scatter and the f32 slice it makes
    (the largest leaf's half), and the activations of ``rows x seq`` tokens
    (each layer's input kept, one layer recomputed, the logits in bf16 and
    f32 and their gradient)."""
    tokens = rows * seq
    acts = (layers * tokens * d * 2 + 16 * tokens * d * 2
            + tokens * vocab * (2 + 4 + 4))
    out = {"state": 12 * n_params / ranks, "gathered_bf16": 2 * n_params,
           "grad_bf16": 2 * n_params, "grad_f32_slice": 4 * vocab * d / 2,
           "activations": acts}
    out = {k: v / 1e9 for k, v in out.items()}
    out["total"] = sum(out.values())
    return out


def leaf_digest(torch, leaf) -> int:
    """An exact, order-free digest of the part of a ``DTensor`` leaf this
    process writes to a checkpoint (0 where it writes nothing): the sum of
    each element's bits times a hash of its global index, mod 2^31 - 1.
    Summed over the processes, it is the digest of the whole leaf, whatever
    the mesh that holds it."""
    from repro_torch.checkpoint.ckpt import _writes
    from repro_torch.parallel.sharded_state import local_index
    from repro_torch.parallel.sharding import spec_of

    if not _writes(leaf):
        return 0
    shard = leaf.to_local().contiguous()
    idx = local_index(leaf.shape, spec_of(leaf), leaf.device_mesh)
    strides = torch.empty(leaf.shape, device="meta").stride()
    bits = {4: torch.int32, 2: torch.int16}[shard.element_size()]
    dev = shard.device
    step = max(1, (1 << 24) // max(1, shard[0].numel()))
    total = 0
    for i in range(0, shard.shape[0], step):    # 2^24 elements at a time
        part = shard[i:i + step]
        word = part.reshape(-1).view(bits).long() & 0xFFFFFFFF
        flat = (torch.arange(part.shape[0], device=dev) + idx[0].start + i) \
            * strides[0]
        for d, sl in enumerate(idx[1:], start=1):
            flat = flat.unsqueeze(-1) + torch.arange(
                sl.start, sl.stop, device=dev) * strides[d]
        w = (flat.reshape(-1) * 2654435761 + 12345) % DIGEST_P
        total = (total + int(((word * w) % DIGEST_P).sum())) % DIGEST_P
    return total


def sharded_train_worker(rank: int, world: int, out_dir: str) -> dict:
    """One rank of the sharded phase's training world: on
    ``SHARD_TRAIN_MESH`` each of ``SHARD_TRAIN_ARCHS`` trained FULL by
    :func:`sharded_train_run` (the tensor-parallel step: their families
    split over ``model``), the first one's state checkpointed under
    ``SHARD_CKPT`` for the serving world; then ``SHARD_ARCH`` at
    ``SHARD_GATHER_LAYERS`` layers on ``SHARD_GATHER_MESH`` (the
    gather-whole step), under ``gather_whole``."""
    import torch.distributed as dist

    from repro_torch.parallel import make_context

    ctx = make_context(SHARD_TRAIN_MESH, device="cuda")
    report: dict = {"backend": dist.get_backend(),
                    "coordinate": list(ctx.mesh.get_coordinate())}
    for arch in SHARD_TRAIN_ARCHS:
        report[arch] = sharded_train_run(ctx, arch,
                                         checkpoint=arch == SHARD_ARCH,
                                         layers=SHARD_TRAIN_LAYERS.get(arch))
    report["rows"] = report[SHARD_ARCH]["rows"]
    report["gather_whole"] = sharded_train_run(
        make_context(SHARD_GATHER_MESH, device="cuda"), SHARD_ARCH,
        checkpoint=False, layers=SHARD_GATHER_LAYERS)
    return report


def shard_cfg(arch: str, layers: int | None):
    """``arch``'s FULL config at ``layers`` layers (None: all of them; an
    encoder-decoder's encoder cut alike)."""
    from repro_torch import configs

    full = configs.get(arch).FULL
    return dataclasses.replace(
        full, n_layers=layers or full.n_layers,
        enc_layers=min(full.enc_layers, layers or full.enc_layers))


def sharded_train_run(ctx, arch: str, checkpoint: bool,
                      layers: int | None = None) -> dict:
    """``arch`` FULL (bf16 compute, f32 masters, AdamW) at ``layers`` layers
    (None: all) on ``ctx``'s mesh:
    a warm step and ``SHARD_TIMED`` timed steps of the pipeline's rows of
    this rank's data coordinate (an encoder-decoder's with zero frames),
    with every launch count set to 0 before the timed steps; the digests of
    its params and, with ``checkpoint``, an async checkpoint under
    ``SHARD_CKPT``; then the f32 step at ``PARITY_LAYERS`` layers against
    the unsharded ``make_train_step`` from the same state."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline, \
        _philox_tokens
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build as build_model
    from repro_torch.optim import OptConfig
    from repro_torch.parallel.sharded_state import local
    from repro_torch.training import (
        init_sharded_train_state,
        init_train_state,
        make_train_step,
    )

    report: dict = {}
    cfg = shard_cfg(arch, layers)
    report["n_layers"] = cfg.n_layers
    bundle = build_model(cfg)
    opt_cfg = OptConfig(peak_lr=SHARD_LR, warmup_steps=0, decay_steps=100)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=SHARD_SEQ,
                          global_batch=SHARD_BATCH, seed=0)
    data = SyntheticLMPipeline(data_cfg, device="cuda", sharding=ctx)
    report["rows"] = list(data.host_range())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_sharded_train_state(
        torch.Generator(device="cuda").manual_seed(0), bundle, opt_cfg, ctx)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    report["state_gb"] = sum(
        local(t).numel() * local(t).element_size()
        for t in tree.leaves({"p": state["params"], "o": state["opt"]})
        if isinstance(t, torch.Tensor)) / 1e9
    report["n_leaves"] = len(tree.leaves(state["params"]))
    step = make_train_step(bundle, opt_cfg, mesh_ctx=ctx)

    def batch_of(s: int) -> dict:
        return with_frames(torch, cfg, data.device_batch(s))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batch_of(0))
    report["warm_loss"] = float(m["loss"])
    report["warm_s"] = time.perf_counter() - t0
    # the main path: every count from 0, the timed steps
    kops.reset_launches()
    walls, splits, losses = [], [], []
    for s in range(1, 1 + SHARD_TIMED):
        batch = batch_of(s)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))       # waits for the step
        walls.append(1e3 * (time.perf_counter() - t0))
        splits.append({k: 1e3 * v for k, v in step.split.items()})
    torch.cuda.synchronize()
    report["launches"] = kops.launch_counts()
    report["step_ms"], report["split_ms"] = walls, splits
    report["losses"] = losses
    report["grad_norm"] = float(m["grad_norm"])
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["digests"] = {k: leaf_digest(torch, v)
                         for k, v in tree.items(state["params"])}
    if checkpoint:
        # an async checkpoint of the state: the snapshot blocks, the write
        # not
        writer = ckpt.AsyncCheckpointer(str(SHARD_CKPT))
        t0 = time.perf_counter()
        writer.save(1 + SHARD_TIMED, state)
        report["ckpt_snapshot_s"] = time.perf_counter() - t0
    del state, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    if checkpoint:
        t0 = time.perf_counter()
        writer.wait()
        report["ckpt_write_wait_s"] = time.perf_counter() - t0

    # f32 at PARITY_LAYERS layers: the sharded step against the unsharded
    # one from the same state, this rank's shard of each; the ranks take the
    # unsharded step in turn (four whole f32 states and seamless's logits
    # over its 256206-token vocab do not fit the card together)
    pcfg = parity_cfg(cfg)
    pb = build_model(pcfg)
    sh = init_sharded_train_state(
        torch.Generator(device="cuda").manual_seed(0), pb, opt_cfg, ctx)
    tok = torch.from_numpy(_philox_tokens(data_cfg, 0, 0, SHARD_BATCH)
                           .astype(np.int64)).cuda()
    whole = with_frames(torch, pcfg, {"tokens": tok[:, :-1],
                                      "labels": tok[:, 1:]},
                        torch.Generator(device="cuda").manual_seed(3))
    lo, hi = report["rows"]
    mine = {k: v[lo:hi] for k, v in whole.items()}
    pstep = make_train_step(pb, opt_cfg, mesh_ctx=ctx)
    sh, ms = pstep(sh, mine)
    report["parity_split"] = sorted(pstep.split)
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            un = init_train_state(
                torch.Generator(device="cuda").manual_seed(0), pb, opt_cfg)
            un, mu = make_train_step(pb, opt_cfg)(un, whole)
            report["parity"] = train_parity_errors(torch, sh, un, mu,
                                                   opt_cfg)
            report["parity"].update(loss=float(ms["loss"]),
                                    grad_norm=float(ms["grad_norm"]))
            del un
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    del sh
    gc.collect()
    torch.cuda.empty_cache()
    return report


def train_parity_errors(torch, sh, un, mu, opt_cfg) -> dict:
    """The f32 sharded state ``sh`` after one step against the unsharded
    ``un`` (its metrics ``mu``): this rank's shard of each parameter, its
    largest error, its largest error past AdamW's first-step slack, and the
    elements past 1e-5."""
    from repro_torch import tree
    from repro_torch.parallel.sharded_state import local_index
    from repro_torch.parallel.sharding import spec_of

    lr, eps, b1 = float(mu["lr"]), opt_cfg.eps, opt_cfg.b1
    worst, raw, beyond, total = 0.0, 0.0, 0, 0
    for p_sh, p_un, m_un in zip(tree.leaves(sh["params"]),
                                tree.leaves(un["params"]),
                                tree.leaves(un["opt"]["m"])):
        idx = local_index(p_un.shape, spec_of(p_sh), p_sh.device_mesh)
        want, got = p_un[idx].double(), p_sh.to_local().double()
        err = (got - want).abs()
        # tests/test_torch_training.py's bound of AdamW's first step: 1e-5,
        # plus lr eps dg / (|g| - dg + eps)^2 (at most 2 lr) where the
        # gradient g may move by dg = 1e-4 |g| + 1e-6
        g = m_un[idx].double().abs() / (1 - b1)
        dg = 1e-4 * g + 1e-6
        slack = lr * (eps * dg / ((g - dg).clamp(min=0.0) + eps) ** 2
                      ).clamp(max=2.0)
        worst = max(worst, float((err - slack).max()))
        raw = max(raw, float(err.max()))
        beyond += int((err > 1e-5).sum())
        total += err.numel()
    return {"loss_unsharded": float(mu["loss"]),
            "grad_norm_unsharded": float(mu["grad_norm"]),
            "param_err_over_slack": worst, "param_err": raw,
            "beyond_1e-5": beyond, "elements": total}


def shard_serve_run(torch, kops, bundle, params, ctx, reqs, kind: str,
                    warm) -> dict:
    """One lockstep engine run on ``ctx`` (4 slots, chunks of 16): a warm
    run, then ``reqs`` with every launch count from 0 (tokens, launches,
    ticks, host ms a tick by T, peak GB, the cache a rank holds), then the
    device ms of one T = 16 and one T = 1 tick (the eager step on a clone
    of the cache, every rank together, rank 0 under the profiler)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.serving import ServeConfig, ServingEngine

    engine = ServingEngine(bundle, params, ServeConfig(
        slots=4, max_new=16, prefill_chunk=16, cache_kind=kind),
        mesh_ctx=ctx)
    engine.run(warm)
    ticks = record_ticks(engine)
    first = engine.ticks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    kops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    experts = [t for lp in engine.params["blocks"]
               for n, t in lp.get("moe", {}).items() if n != "router"]
    run = {"tokens": {r.uid: r.tokens for r in results},
           "expert_bytes": sum(t.numel() * t.element_size()
                               for t in experts),
           "launches": kops.launch_counts(), "wall_s": wall,
           "n_tok": sum(len(r.tokens) for r in results),
           "n_ticks": engine.ticks - first,
           "cache": named_shapes(tree.items(engine._cache)),
           "stats": engine.compile_stats(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "host_ms": {t: [ms for tt, ms, *_ in ticks if tt == t]
                       for t in (16, 1)}}
    gen = np.random.default_rng(5)
    cases = {16: (np.array([16, 5, 1, 0]),
                  np.array([True, False, False, False])),
             1: (np.array([1, 1, 1, 0]), np.zeros(4, bool))}
    run["device_ms"] = {}
    for t_len, (n_valid, reset) in cases.items():
        ins = dict(engine._idle_inputs(t_len), n_valid=n_valid, reset=reset,
                   tokens=gen.integers(3, bundle.cfg.vocab, (4, t_len)))
        clone = clone_tree(engine._cache)
        ran, events = [], None
        if dist.get_rank() == 0:    # one profiler on the card at a time
            try:
                events = kernel_events(torch, lambda: ran.append(eager_on(
                    torch, engine, clone, ins)))
            except Exception as exc:    # the profiler's: it reads none
                print(f"profiler: {exc!r}", flush=True)
        if not ran:     # the other ranks, or the profiler failed first
            eager_on(torch, engine, clone, ins)
        split = split_by_kind(events)
        run["device_ms"][t_len] = (None if split is None else
                                   {"total": sum(split.values()), **split})
        del clone
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run


def shard_wave_tokens(vocab: int, rows: int, seq: int) -> np.ndarray:
    """The wave's prompt tokens and, after them, the decode steps' inputs
    (teacher-forced: every rank feeds the same), from seed ``rows``."""
    rng = np.random.default_rng(rows)
    return rng.integers(3, vocab, (rows, seq + SHARD_DECODES),
                        dtype=np.int64)


def shard_wave_frames(torch, cfg, rows: int, frames: int | None) -> dict:
    """An encoder-decoder's wave frames (``rows`` x ``frames`` x d_model,
    from seed ``rows``, in the compute dtype) as a batch entry; none
    without ``frames``."""
    if frames is None:
        return {}
    gen = torch.Generator(device="cuda").manual_seed(rows)
    return {"frames": torch.randn(rows, frames, cfg.d_model, generator=gen,
                                  device="cuda").to(cfg.dtype)}


def shard_wave_run(torch, kops, bundle, params, seq, rows: int, prompt: int,
                   cap, frames: int | None = None) -> dict:
    """``make_serve_step(bundle, mesh_ctx=seq)``: a prefill of ``rows`` x
    ``prompt`` tokens (an encoder-decoder's after ``frames`` frames) into a
    cache of ``cap`` rows (None: the prompt's), then ``SHARD_DECODES``
    decode steps, each timed on every rank together and split by the
    step's ``split`` (collectives and the rest); this rank's logits (its
    rows, f32) after each, and the cache it holds."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.serving.engine import serving_params
    from repro_torch.training import make_serve_step

    mine = serving_params(params, bundle, seq)
    prefill, decode = make_serve_step(bundle, mesh_ctx=seq)
    tok = torch.from_numpy(shard_wave_tokens(bundle.cfg.vocab, rows,
                                             prompt)).cuda()
    extra = shard_wave_frames(torch, bundle.cfg, rows, frames)
    out = {"steps": [], "logits": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    kops.reset_launches()
    cache = None
    for i in range(1 + SHARD_DECODES):
        dist.barrier()
        t0 = time.perf_counter()
        if i == 0:
            lg, cache = prefill(mine, {"tokens": tok[:, :prompt], **extra},
                                cap)
            split = prefill.split
        else:
            lg, cache = decode(mine, cache, {
                "tokens": tok[:, prompt + i - 1:prompt + i]})
            split = decode.split
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        coll = 1e3 * sum(v for k, v in split.items() if k != "step")
        out["steps"].append({"ms": ms, "collective_ms": coll,
                             "local_ms": ms - coll})
        out["logits"].append(lg[:, -1].float())
    torch.cuda.synchronize()
    out["launches"] = kops.launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["cache"] = named_shapes(tree.items(cache))
    out["rows"] = cache.get("rows")
    del cache, mine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def unsharded_wave_logits(torch, bundle, params, rows: int, prompt: int,
                          cap, frames: int | None = None) -> list:
    """The unsharded ``make_serve_step``'s logits after its prefill and
    each decode step, on the same tokens (and frames) as
    :func:`shard_wave_run`."""
    from repro_torch.serving.engine import serving_params
    from repro_torch.training import make_serve_step

    prefill, decode = make_serve_step(bundle)
    whole = serving_params(params, bundle)
    tok = torch.from_numpy(shard_wave_tokens(bundle.cfg.vocab, rows,
                                             prompt)).cuda()
    lg, cache = prefill(whole, {"tokens": tok[:, :prompt],
                                **shard_wave_frames(torch, bundle.cfg, rows,
                                                    frames)}, cap)
    out = [lg[:, -1].float()]
    for i in range(SHARD_DECODES):
        lg, cache = decode(whole, cache,
                           {"tokens": tok[:, prompt + i:prompt + i + 1]})
        out.append(lg[:, -1].float())
    return out


def engine_ticks(bundle, params, mctx, reqs, kind: str) -> tuple:
    """(tokens by uid, each tick's (n_valid, logits on the host)) of an f32
    engine run on ``params`` (sharded on ``mctx``, or unsharded)."""
    from repro_torch.serving import ServeConfig, ServingEngine

    engine = ServingEngine(bundle, params, ServeConfig(
        slots=4, prefill_chunk=16, cache_kind=kind), mesh_ctx=mctx)
    ticks = record_ticks(engine, keep_logits=True)
    res = engine.run(reqs)
    return ({r.uid: r.tokens for r in res},
            [(ins["n_valid"], lg.cpu()) for _, _, ins, lg in ticks])


def ticks_parity(torch, sharded: tuple, unsharded: tuple) -> dict:
    """Two :func:`engine_ticks` runs: whether the tokens are equal, the
    largest logit difference over every tick's live slots, the largest
    logit."""
    errs = []
    for (nv, a), (_, b) in zip(sharded[1], unsharded[1]):
        live = torch.from_numpy(np.asarray(nv) > 0)
        errs.append(float((a[live] - b[live]).abs().max()))
    return {"ticks": [len(sharded[1]), len(unsharded[1])],
            "tokens_equal": sharded[0] == unsharded[0],
            "logit_err": max(errs) if errs else None,
            "scale": max(float(lg.abs().max()) for _, lg in unsharded[1])}


def shard_engine_parity(torch, bundle, params, ctx, reqs, kind: str) -> dict:
    """f32: the sharded engine on ``ctx`` (``params`` placed under its
    rules) against the unsharded engine on the same params and requests
    (:func:`ticks_parity`)."""
    from repro_torch.launch import serve
    from repro_torch.parallel.sharded_state import place_tree

    placed = place_tree(params, serve._param_shardings(bundle.params_pspec,
                                                       ctx))
    return ticks_parity(torch, engine_ticks(bundle, placed, ctx, reqs, kind),
                        engine_ticks(bundle, params, None, reqs, kind))


def placed_params(torch, bundle, ctx):
    """``bundle``'s parameters from seed 0 (``init_params``' values), each
    leaf drawn whole and placed at once under ``ctx``'s serving specs
    (``partition_specs(fsdp_ok=False)``), the ranks in turn: a rank holds
    its shards and the card one whole leaf at a time (four whole MoE models,
    or four of grok-1's 6 GB f32 draws at once, do not fit it)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.launch import serve
    from repro_torch.models.common import _init_leaf
    from repro_torch.parallel.sharded_state import place

    shardings = serve._param_shardings(bundle.params_pspec, ctx)
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device="cuda").manual_seed(0)
            out = tree.map_tree(
                lambda ps, sh: place(_init_leaf(ps, gen, bundle.cfg.dtype,
                                                "cuda"), sh),
                bundle.params_pspec, shardings)
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def moe_engine_parity(torch, bundle, ctx, reqs, kinds) -> dict:
    """f32: the sharded engine on ``ctx`` (:func:`placed_params`) on each
    cache of ``kinds``, then, once every rank has freed its share, the
    unsharded engine on the same params and requests on rank 0 alone (a
    whole f32 copy a rank does not fit the card): :func:`ticks_parity` by
    kind, rank 0's on every rank."""
    import torch.distributed as dist

    from repro_torch.models.common import init_params

    placed = placed_params(torch, bundle, ctx)
    sharded = {kind: engine_ticks(bundle, placed, ctx, reqs, kind)
               for kind in kinds}
    del placed
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    box = [None]
    if dist.get_rank() == 0:
        whole = init_params(bundle.params_pspec, torch.Generator(
            device="cuda").manual_seed(0), bundle.cfg.dtype)
        box[0] = {kind: ticks_parity(torch, sharded[kind], engine_ticks(
            bundle, whole, None, reqs, kind)) for kind in kinds}
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sharded_serve_worker(rank: int, world: int, out_dir: str) -> dict:
    """One rank of the sharded phase's serving world on
    ``SHARD_SERVE_MESH``: llama's params of the training world's checkpoint
    restored into this mesh's shards (their digests); each of
    ``SHARD_SERVE`` serves the continuous phase's 8 requests on the ring
    and the paged cache in lockstep (:func:`shard_serve_run`); the wave
    steps of ``SHARD_WAVES`` under the production rules' ``seq_shard``
    (:func:`shard_wave_run`); then f32 at ``PARITY_LAYERS`` layers: the
    ``model=2`` path on ``SHARD_REPLICAS``, every served run and every
    wave against the unsharded engine or steps on the same params and
    inputs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    from repro_torch.models import build as build_model
    from repro_torch.models.common import init_params, stack_pspec
    from repro_torch.parallel import make_context
    from repro_torch.parallel.mesh_context import DEFAULT_RULE_TABLE, \
        MeshContext
    from repro_torch.parallel.sharding import Rules
    from repro_torch.serving import Request

    report: dict = {}
    t_start = time.perf_counter()

    def progress(what: str) -> None:
        print(f"serve rank {rank}: {what} at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    ctx = make_context(SHARD_SERVE_MESH, device="cuda")
    seq = MeshContext(mesh=ctx.mesh, rules=mesh_lib.make_rules(
        ctx.mesh, fsdp=False, seq_shard=True))
    report["coordinate"] = list(ctx.mesh.get_coordinate())
    cfg = shard_cfg(SHARD_ARCH, None)
    bundle = build_model(cfg)
    latest = ckpt.latest_step(str(SHARD_CKPT))
    report["step"] = latest
    stacked = stack_pspec(bundle.params_pspec)
    target = {"params": tree.map_tree(
        lambda ps: torch.empty(0, device="cuda"), stacked)}
    t0 = time.perf_counter()
    restored = ckpt.restore(str(SHARD_CKPT), latest, target, shardings={
        "params": serve._param_shardings(stacked, ctx)})["params"]
    torch.cuda.synchronize()
    report["restore_s"] = time.perf_counter() - t0
    report["digests"] = {k: leaf_digest(torch, v)
                         for k, v in tree.items(restored)}
    progress("restored")

    def requests(vocab: int, prompt: int = 512, new: int = 16) -> list:
        """The continuous phase's 8 requests in ``vocab``."""
        reqs = serve.make_requests(8, prompt, vocab, seed=0)
        for r in reqs:
            r.max_new = new
        return reqs

    def params_of(arch, depth, dtype=None):
        c = shard_cfg(arch, depth)
        if dtype is not None:
            c = parity_cfg(c)
        b = build_model(c)
        if arch == SHARD_ARCH and dtype is None:
            return b, restored
        return b, init_params(b.params_pspec, torch.Generator(
            device="cuda").manual_seed(0), c.dtype)

    runs = {}
    for arch, depth in SHARD_SERVE:
        b, params = params_of(arch, depth)
        reqs = requests(b.cfg.vocab)
        # a short warm-up (T = 16 and T = 1 ticks): no graph to capture
        warm = [Request(uid=-1, prompt=reqs[0].prompt[:20], max_new=2)]
        runs[arch] = {"n_layers": b.cfg.n_layers}
        for kind in ("ring", "paged"):
            runs[arch][kind] = shard_serve_run(torch, kops, b, params, ctx,
                                               reqs, kind, warm)
            progress(f"{arch} {kind} served")
        del params
    report["runs"] = runs
    waves = []
    for arch, depth, rows, prompt, cap in SHARD_WAVES:
        b, params = params_of(arch, depth)
        w = shard_wave_run(torch, kops, b, params, seq, rows, prompt, cap)
        del w["logits"], params
        waves.append(w)
        progress(f"wave {arch} {rows}x{prompt}")
    report["waves"] = waves
    del restored
    gc.collect()
    torch.cuda.empty_cache()

    # the MoE, its experts over model, each rank's shards drawn leaf by
    # leaf; the encoder-decoder's wave steps, whole
    moe = {}
    for arch, depth, kinds in SHARD_MOE_SERVE:
        b = build_model(shard_cfg(arch, depth))
        params = placed_params(torch, b, ctx)
        reqs = requests(b.cfg.vocab)
        warm = [Request(uid=-1, prompt=reqs[0].prompt[:20], max_new=2)]
        moe[arch] = {"n_layers": depth}
        for kind in kinds:
            moe[arch][kind] = shard_serve_run(torch, kops, b, params, ctx,
                                              reqs, kind, warm)
            progress(f"{arch} {kind} served")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    report["moe"] = moe
    contexts = {"mesh": ctx, "seq": seq}
    encdec = []
    for rules, rows, frames, prompt, cap in SHARD_ENCDEC_WAVES:
        b, params = params_of(SHARD_ENCDEC, None)
        w = shard_wave_run(torch, kops, b, params, contexts[rules], rows,
                           prompt, cap, frames)
        del w["logits"], params
        encdec.append(w)
        progress(f"wave {SHARD_ENCDEC} {rules} {rows}x{frames}+{prompt}")
    report["encdec_waves"] = encdec
    gc.collect()
    torch.cuda.empty_cache()

    # f32 at PARITY_LAYERS layers: each sharded run against the unsharded
    # engine or steps on the same params and inputs
    replicas = init_device_mesh("cuda", tuple(n for _, n in SHARD_REPLICAS),
                                mesh_dim_names=tuple(a for a, _ in
                                                     SHARD_REPLICAS))
    model2 = MeshContext(mesh=replicas, rules=Rules(
        table=dict(DEFAULT_RULE_TABLE), axis_sizes=dict(SHARD_REPLICAS)))
    parity = {}
    b, params = params_of(SHARD_ARCH, None, torch.float32)
    # the model=2 path on the requests it was held on before (PRs 27-29)
    parity["model=2"] = shard_engine_parity(torch, b, params, model2,
                                            requests(b.cfg.vocab), "ring")
    progress("f32 model=2")
    for arch, depth in SHARD_SERVE:
        b, params = params_of(arch, depth, torch.float32)
        reqs = requests(b.cfg.vocab, SHARD_PARITY_PROMPT, SHARD_PARITY_NEW)
        for kind in ("ring", "paged"):
            parity[f"{arch} {kind}"] = shard_engine_parity(
                torch, b, params, ctx, reqs, kind)
            progress(f"f32 {arch} {kind}")
    for arch, depth, rows, prompt, cap in SHARD_WAVES:
        b, params = params_of(arch, depth, torch.float32)
        got = shard_wave_run(torch, kops, b, params, seq, rows, prompt,
                             cap)["logits"]
        want = unsharded_wave_logits(torch, b, params, rows, prompt, cap)
        r0 = report["coordinate"][0] * got[0].shape[0] \
            if got[0].shape[0] < rows else 0
        parity[f"wave {arch} {rows}x{prompt}"] = {
            "logit_err": max(float((g - w[r0:r0 + g.shape[0]]).abs().max())
                             for g, w in zip(got, want)),
            "scale": max(float(w.abs().max()) for w in want),
            "tokens_equal": all(
                torch.equal(g.argmax(-1), w[r0:r0 + g.shape[0]].argmax(-1))
                for g, w in zip(got, want))}
        progress(f"f32 wave {arch} {rows}x{prompt}")
    for arch, depth, kinds in SHARD_MOE_SERVE:
        b = build_model(dataclasses.replace(
            shard_cfg(arch, SHARD_MOE_PARITY[arch]), dtype=torch.float32))
        got = moe_engine_parity(torch, b, ctx, requests(
            b.cfg.vocab, SHARD_PARITY_PROMPT, SHARD_PARITY_NEW), kinds)
        for kind in kinds:
            parity[f"{arch} {kind}"] = got[kind]
        progress(f"f32 {arch}")
    for rules, rows, frames, prompt, cap in SHARD_ENCDEC_WAVES:
        b, params = params_of(SHARD_ENCDEC, None, torch.float32)
        got = shard_wave_run(torch, kops, b, params, contexts[rules], rows,
                             prompt, cap, frames)["logits"]
        want = unsharded_wave_logits(torch, b, params, rows, prompt, cap,
                                     frames)
        r0 = report["coordinate"][0] * got[0].shape[0]
        parity[f"wave {SHARD_ENCDEC} {rules} {rows}x{frames}+{prompt}"] = {
            "logit_err": max(float((g - w[r0:r0 + g.shape[0]]).abs().max())
                             for g, w in zip(got, want)),
            "scale": max(float(w.abs().max()) for w in want),
            "tokens_equal": all(
                torch.equal(g.argmax(-1), w[r0:r0 + g.shape[0]].argmax(-1))
                for g, w in zip(got, want))}
        del params
        progress(f"f32 wave {SHARD_ENCDEC} {rules}")
    report["parity"] = parity
    return report


def sharded_worker(role: str, rank: int, world: int, out_dir: str) -> int:
    """One rank of the sharded phase (``chip_smoke.py --sharded-worker ROLE
    RANK WORLD DIR``), ``ROLE`` ``train`` or ``serve``: its report into
    ``DIR/<role><RANK>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a rank that waits past the world's time on a peer shows where it was
    faulthandler.dump_traceback_later(SHARD_TIMEOUT_S - 30, exit=False)
    build.load()                        # the parent built it: a cache hit
    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/{role}",
                            rank=rank, world_size=world)
    try:
        report = {"train": sharded_train_worker,
                  "serve": sharded_serve_worker}[role](rank, world, out_dir)
        report["rank"] = rank
        dist.barrier()
        report["seconds"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"{role}{rank}.json").write_text(json.dumps(report))
    return 0


def run_world(role: str, ranks: int, out_dir: Path) -> list:
    """Start ``ranks`` processes of this script as one world of ``role`` and
    return their reports; raises if a rank fails or the world outlasts
    ``SHARD_TIMEOUT_S`` (each failed or killed rank's log tail printed)."""
    t0 = time.perf_counter()
    logs = [out_dir / f"{role}{r}.log" for r in range(ranks)]
    # four ranks share the card: grown segments, not fixed blocks, so that
    # the MoE's multi-GB leaves of one step reuse what the last one freed
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = []
    try:
        for r in range(ranks):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--sharded-worker", role, str(r), str(ranks),
                     str(out_dir)], stdout=log, stderr=subprocess.STDOUT,
                    env=env))
        # a rank that fails leaves the others waiting in a collective:
        # stop the world at the first failure
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                print(f"sharded {role}: the world outlasts "
                      f"{SHARD_TIMEOUT_S} s", flush=True)
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            print(f"sharded {role}: rank {r} exit {procs[r].returncode}:\n"
                  f"{logs[r].read_text()[-3000:]}", flush=True)
        raise RuntimeError(f"sharded {role} ranks {bad} failed")
    return [json.loads((out_dir / f"{role}{r}.json").read_text())
            for r in range(ranks)]


def tp_train_launches(cfg, n_leaves: int, kernels) -> dict:
    """Kernel launches of one tensor-parallel train step: a rank's share of
    ``train_launches``, where a Mamba layer's gated norm (its ``d_inner``
    split over ``model``) is ``split_rmsnorm``'s row-segmented reduce on
    ``tcu_reduce`` in place of ``rmsnorm`` (2L: forward and recompute)."""
    from repro_torch.models.lm import STATE_FAMILIES

    want = train_launches(cfg, n_leaves, kernels)
    if cfg.family in STATE_FAMILIES:
        want["rmsnorm"] -= 2 * cfg.n_layers
        want["tcu_reduce"] += 2 * cfg.n_layers
    return want


def sharded_train_gates(smoke: Smoke, kops, arch: str, reps: list,
                        smi: str, mesh: str = SHARD_TRAIN_MESH,
                        split: bool = True) -> dict:
    """The training world's gates on ``arch``'s reports on ``mesh``, one a
    rank, through the tensor-parallel step (``split``) or the gather-whole
    one: the launches a step (``tp_train_launches`` or
    ``train_launches``), the ranks' losses equal (each is the mean over
    ``data``), the step's parts those of the route, the f32 step within
    1e-5 (plus AdamW's first-step conditioning) of the unsharded step and
    its loss within 1e-5, and, split, llama's peak GB a rank below the
    gather-whole step's (``SHARD_GATHER_WHOLE_PEAK_GB``). Prints and
    returns its numbers."""
    cfg = shard_cfg(arch, reps[0]["n_layers"])
    launches = {k: 0 for k in kops.KERNELS}
    want = (tp_train_launches if split else train_launches)(
        cfg, reps[0]["n_leaves"], kops.KERNELS)
    parts = ["forward_backward", "gather", "reduce_scatter"] \
        + ["tp_all_reduce"] * split + ["update"]
    route = "tensor-parallel" if split else "gather-whole"
    tag = f"sharded train {arch} on {mesh}"
    for rep in reps:
        for k in launches:
            launches[k] += rep["launches"][k]
        got = {k: rep["launches"][k] for k in want}
        per = scaled(want, SHARD_TIMED)
        if got != per:
            smoke.fail(f"{tag} rank {rep['rank']}: launches "
                       f"{got}, want {per} ({SHARD_TIMED} steps)")
        if rep["losses"] != reps[0]["losses"] or \
                not all(np.isfinite(rep["losses"])):
            smoke.fail(f"{tag} rank {rep['rank']}: losses "
                       f"{rep['losses']} vs rank 0 {reps[0]['losses']}")
        if sorted(rep["split_ms"][0]) != parts or \
                rep["parity_split"] != parts:
            smoke.fail(f"{tag} rank {rep['rank']}: "
                       f"step parts {sorted(rep['split_ms'][0])}, want the "
                       f"{route} step's {parts}")
        par = rep["parity"]
        if not abs(par["loss"] - par["loss_unsharded"]) <= 1e-5:
            smoke.fail(f"{tag} rank {rep['rank']}: f32 loss "
                       f"{par['loss']} vs unsharded {par['loss_unsharded']}")
        if not par["param_err_over_slack"] <= 1e-5:
            smoke.fail(f"{tag} rank {rep['rank']}: f32 params "
                       f"differ from the unsharded step's by "
                       f"{par['param_err_over_slack']:.3e} over AdamW's "
                       "first-step slack (want <= 1e-5)")
        if split and arch == SHARD_ARCH and \
                not rep["peak_gb"] < SHARD_GATHER_WHOLE_PEAK_GB:
            smoke.fail(f"{tag} rank {rep['rank']}: peak "
                       f"{rep['peak_gb']:.2f} GB, want below the gather-"
                       f"whole step's {SHARD_GATHER_WHOLE_PEAK_GB}")
    step_ms = [statistics.median(r["step_ms"]) for r in reps]
    parts_ms = {k: [statistics.median(s[k] for s in r["split_ms"])
                    for r in reps] for k in reps[0]["split_ms"][0]}
    print(f"sharded train: {arch} FULL at {cfg.n_layers} of "
          f"{shard_cfg(arch, None).n_layers} layers on {mesh} ({route} "
          f"step), 4 ranks on one card ({smi}), gloo through host "
          f"memory; global batch {SHARD_BATCH} x {SHARD_SEQ}, a rank's rows "
          f"{[r['rows'] for r in reps]}; losses {reps[0]['losses']} "
          f"(warm {reps[0]['warm_loss']:.4f}, grad norm "
          f"{reps[0]['grad_norm']:.4f}); step ms a rank (median of "
          f"{SHARD_TIMED}) {[round(v, 1) for v in step_ms]}; split ms "
          + ", ".join(f"{k} {[round(v, 1) for v in vs]}"
                      for k, vs in parts_ms.items())
          + f"; warm step s {[round(r['warm_s'], 1) for r in reps]}; "
          f"state GB a rank {[round(r['state_gb'], 2) for r in reps]}; "
          f"peak GB a rank {[round(r['peak_gb'], 2) for r in reps]}; "
          f"launches a rank {reps[0]['launches']}", flush=True)
    par = [r["parity"] for r in reps]
    print(f"{tag} f32 parity at {parity_depth(cfg)} layers: "
          f"loss {par[0]['loss']:.7f} vs unsharded "
          f"{par[0]['loss_unsharded']:.7f}, grad norm "
          f"{par[0]['grad_norm']:.6f} vs {par[0]['grad_norm_unsharded']:.6f}"
          f"; params |sharded - unsharded| max "
          f"{max(p['param_err'] for p in par):.3e}, "
          f"{sum(p['beyond_1e-5'] for p in par)} of "
          f"{sum(p['elements'] for p in par)} elements past 1e-5, worst past "
          "the first-step slack "
          f"{max(p['param_err_over_slack'] for p in par):.3e}", flush=True)
    return {"launches": launches, "step_ms": step_ms, "split_ms": parts_ms,
            "peak_gb": [r["peak_gb"] for r in reps]}


def sharded_pass(smoke: Smoke, kops) -> dict:
    """Sharded training and lockstep serving on this one card: a gloo world
    of 4 ranks trains ``SHARD_TRAIN_ARCHS`` FULL (llama3.2-1b, mamba2-1.3b,
    seamless-m4t; depths of ``SHARD_TRAIN_LAYERS``) on
    ``data=2,model=2`` through the tensor-parallel step and checkpoints
    llama's state, and trains llama again at ``SHARD_GATHER_LAYERS`` on
    ``data=4`` through the gather-whole step; then a world of 4 ranks
    restores llama's params on ``data=2,model=2`` and serves
    (:func:`sharded_serve_worker`: the dense, SSM and hybrid runs, the MoE
    of ``SHARD_MOE_SERVE``, the encoder-decoder's wave steps). Gated here
    on the ranks' reports: the training gates of :func:`sharded_train_gates`
    for each run, the restored params' digests equal the saved ones, the
    serving gates of :func:`sharded_serve_gates`,
    :func:`sharded_wave_gates` and :func:`sharded_encdec_gates`, and every
    f32 run within 1e-4 of the unsharded engine's or steps' logits with its
    tokens equal."""
    from repro_torch import configs
    from repro_torch.models import build as build_model

    torch = smoke.torch
    out_dir = OBS_DIR.parent / "sharded_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(SHARD_CKPT, ignore_errors=True)
    out_dir.mkdir(parents=True)
    smi = smi_line()
    cfg = configs.get(SHARD_ARCH).FULL
    n_params = build_model(cfg).n_params
    need = rank_state_gb(n_params, cfg.n_layers, cfg.d_model,
                         cfg.vocab, 4, SHARD_BATCH // 2, SHARD_SEQ)
    print(f"sharded: {SHARD_ARCH} FULL ({n_params} params), reckoned GB a "
          f"training rank: " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in need.items())
          + f"; 4 ranks {4 * need['total']:.1f} of 80", flush=True)
    t0 = time.perf_counter()
    try:
        train = run_world("train", 4, out_dir)
        t_train = time.perf_counter() - t0
        serve_r = run_world("serve", 4, out_dir)
    finally:
        shutil.rmtree(SHARD_CKPT, ignore_errors=True)
    t_all = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {k: 0 for k in kops.KERNELS}

    # training
    if {r["backend"] for r in train} != {"gloo"}:
        smoke.fail(f"sharded train: backend {[r['backend'] for r in train]}")
    rows = sorted(tuple(r["rows"]) for r in train)
    if rows != [(0, 2), (0, 2), (2, 4), (2, 4)]:
        smoke.fail(f"sharded train: rows by rank {rows}, want 2 x [0, 2) and "
                   "2 x [2, 4)")
    trained = {}
    for arch in SHARD_TRAIN_ARCHS:
        reps = [dict(r[arch], rank=r["rank"]) for r in train]
        trained[arch] = sharded_train_gates(smoke, kops, arch, reps, smi)
        for k in launches:
            launches[k] += trained[arch]["launches"][k]
    rows = sorted(tuple(r["gather_whole"]["rows"]) for r in train)
    if rows != [(0, 1), (1, 2), (2, 3), (3, 4)]:
        smoke.fail(f"sharded train on {SHARD_GATHER_MESH}: rows by rank "
                   f"{rows}, want [0, 1) to [3, 4)")
    whole = sharded_train_gates(
        smoke, kops, SHARD_ARCH, [dict(r["gather_whole"], rank=r["rank"])
                                  for r in train],
        smi, mesh=SHARD_GATHER_MESH, split=False)
    trained["gather_whole"] = whole
    for k in launches:
        launches[k] += whole["launches"][k]
    saved = {k: sum(r[SHARD_ARCH]["digests"][k] for r in train) % DIGEST_P
             for k in train[0][SHARD_ARCH]["digests"]}
    print(f"sharded train: checkpoint snapshot s "
          f"{[round(r[SHARD_ARCH]['ckpt_snapshot_s'], 1) for r in train]}, "
          f"write wait s "
          f"{[round(r[SHARD_ARCH]['ckpt_write_wait_s'], 1) for r in train]};"
          f" world {t_train:.1f} s", flush=True)

    # serving
    restored = {k: sum(r["digests"][k] for r in serve_r) % DIGEST_P
                for k in serve_r[0]["digests"]}
    if restored != saved:
        bad = [k for k in saved if restored.get(k) != saved[k]]
        smoke.fail(f"sharded serve: restored params differ from the saved "
                   f"ones in {bad}")
    served = {}
    for arch, _ in SHARD_SERVE:
        served[arch] = sharded_serve_gates(
            smoke, kops, arch, [dict(r["runs"][arch], rank=r["rank"],
                                     coordinate=r["coordinate"])
                                for r in serve_r], smi)
        for k in launches:
            launches[k] += served[arch]["launches"][k]
    waves = sharded_wave_gates(smoke, kops, serve_r, smi)
    for k in launches:
        launches[k] += waves["launches"][k]
    for arch, depth, kinds in SHARD_MOE_SERVE:
        served[arch] = sharded_serve_gates(
            smoke, kops, arch, [dict(r["moe"][arch], rank=r["rank"],
                                     coordinate=r["coordinate"])
                                for r in serve_r], smi, kinds)
        for k in launches:
            launches[k] += served[arch]["launches"][k]
    encdec = sharded_encdec_gates(smoke, kops, serve_r, smi)
    for k in launches:
        launches[k] += encdec["launches"][k]
    worst = {}
    for name in serve_r[0]["parity"]:
        ps = [r["parity"][name] for r in serve_r]
        worst[name] = max(p["logit_err"] for p in ps)
        for rep, p in zip(serve_r, ps):
            if not p["tokens_equal"]:
                smoke.fail(f"sharded serve f32 {name} rank {rep['rank']}: "
                           "tokens differ from the unsharded run's")
            if p["logit_err"] is None or not p["logit_err"] <= 1e-4:
                smoke.fail(f"sharded serve f32 {name} rank {rep['rank']}: "
                           f"logits differ from the unsharded run's by "
                           f"{p['logit_err']} > 1e-4")
    print(f"sharded serve: checkpoint step {serve_r[0]['step']} restored on "
          f"{SHARD_SERVE_MESH} in "
          f"{[round(r['restore_s'], 1) for r in serve_r]} s, digests of "
          f"{len(saved)} leaves {'equal' if restored == saved else 'DIFFER'}"
          f"; f32 parity at {PARITY_LAYERS} layers (zamba2 "
          f"{parity_depth(shard_cfg('zamba2-2.7b', 12))}; the MoE "
          f"{SHARD_MOE_PARITY}), max |logit - "
          f"unsharded| and the largest logit: " + "; ".join(
              f"{name} {worst[name]:.3e} ({serve_r[0]['parity'][name]['scale']:.2f}"
              f", ticks {serve_r[0]['parity'][name].get('ticks', '-')})"
              for name in worst), flush=True)
    print(f"sharded: ranks' launches {launches}; train ranks' seconds "
          f"{[round(r['seconds'], 1) for r in train]}, serve ranks' "
          f"{[round(r['seconds'], 1) for r in serve_r]}; phase "
          f"{t_all:.1f} s", flush=True)
    return {"launches": launches, "train": trained, "reckoned_gb": need,
            "serve": {arch: served[arch]["stats"] for arch in served},
            "waves": waves["stats"], "encdec_waves": encdec["stats"],
            "parity": worst}


def tp_serve_launches(cfg, prefill: bool = False) -> dict:
    """Kernel launches of one forward of a serving rank under tensor
    parallelism: ``forward_launches``, where each Mamba layer's gated norm
    (its ``d_inner`` split over ``model``) is ``split_rmsnorm``'s
    row-segmented reduce on ``tcu_reduce`` in place of ``rmsnorm``."""
    from repro_torch.models.lm import STATE_FAMILIES

    want = forward_launches(cfg, prefill=prefill)
    want["tcu_reduce"] = 0
    if cfg.family in STATE_FAMILIES:
        want["rmsnorm"] -= cfg.n_layers
        want["tcu_reduce"] = cfg.n_layers
    return want


def cache_text(cache: dict) -> str:
    """What a rank's cache holds: the KV rows and heads, the SSM heads and
    conv channels, the pools' pages."""
    parts = []
    if "attn/k" in cache:
        k = cache["attn/k"]
        parts.append(f"KV {k[1]} x {k[2]} rows x {k[3]} heads" if len(k) == 5
                     else f"KV {k}")
    if "mamba/state" in cache:
        st, cv = cache["mamba/state"], cache["mamba/conv"]
        parts.append(f"state {st[1]} slots x {st[2]} heads, conv {cv[-1]} "
                     "channels")
    if "snap/state" in cache:
        parts.append(f"{cache['snap/state'][1]} snapshot pages")
    return ", ".join(parts) or "none"


def sharded_serve_gates(smoke: Smoke, kops, arch: str, reps: list,
                        smi: str, kinds=("ring", "paged")) -> dict:
    """The serving world's gates on ``arch``'s runs on the caches of
    ``kinds``, one report a rank: every rank the same tokens and 8 results
    with tokens, the launches a tick of a rank's share
    (``tp_serve_launches``: the MoE's ``tcu_scan`` once a layer), no graph,
    the cache a rank holds (its 2 of the 4 slots; half the KV heads or SSM
    heads, the conv channels of its heads), and the MoE's expert leaves a
    rank holds half of the whole's bytes. Prints and returns its
    numbers."""
    cfg = shard_cfg(arch, reps[0]["n_layers"])
    launches = {k: 0 for k in kops.KERNELS}
    per_tick = tp_serve_launches(cfg)
    experts = (cfg.n_layers * 3 * cfg.n_experts * cfg.d_model
               * cfg.moe_d_ff * smoke.torch.empty(0, dtype=cfg.dtype)
               .element_size())              # every rank's together
    texts, stats = [], {}
    for kind in kinds:
        r0 = reps[0][kind]
        if experts and not 0.45 <= r0["expert_bytes"] / experts <= 0.55:
            smoke.fail(f"sharded serve {arch} {kind}: a rank holds "
                       f"{r0['expert_bytes']} of the experts' {experts} "
                       "bytes, want about half (model=2)")
        for rep in reps:
            run = rep[kind]
            if run["tokens"] != r0["tokens"]:
                smoke.fail(f"sharded serve {arch} {kind} rank "
                           f"{rep['rank']}: tokens differ from rank 0's")
            for k in launches:
                launches[k] += run["launches"][k]
            got = {k: run["launches"][k] for k in per_tick}
            want = {k: v * run["n_ticks"] for k, v in per_tick.items()}
            if got != want:
                smoke.fail(f"sharded serve {arch} {kind} rank "
                           f"{rep['rank']}: launches {got}, want {want} "
                           f"({run['n_ticks']} ticks)")
            if run["stats"].get("graphs") != 0 or "eager" not in run["stats"]:
                smoke.fail(f"sharded serve {arch} {kind}: compile stats "
                           f"{run['stats']}, want no graph")
            c = run["cache"]
            heads = ({"attn/k": (3, cfg.n_kv_heads // 2)}
                     if "attn/k" in c else {})
            if "mamba/state" in c:
                heads["mamba/state"] = (2, cfg.ssm_heads // 2)
            for name, (dim, n) in heads.items():
                slots = c[name][1] if name != "attn/k" or kind == "ring" \
                    else 2
                if c[name][dim] != n or slots != 2:
                    smoke.fail(f"sharded serve {arch} {kind}: a rank's "
                               f"{name} {c[name]}, want 2 slots and {n} "
                               "heads")
        if len(r0["tokens"]) != 8 or any(not t for t in
                                         r0["tokens"].values()):
            smoke.fail(f"sharded serve {arch} {kind}: {len(r0['tokens'])} "
                       "results, want 8 with tokens")
        dev = r0["device_ms"]
        texts.append(
            f"{kind}: {r0['n_tok']} tokens in {r0['wall_s']:.3f}s "
            f"({r0['n_tok'] / r0['wall_s']:.2f} tok/s), {r0['n_ticks']} "
            f"ticks; host ms a tick, median (min-max): T=16 "
            f"{ms_text(r0['host_ms']['16'])}, T=1 "
            f"{ms_text(r0['host_ms']['1'])}; device ms (kernels) T=16 "
            + ("not measured" if dev["16"] is None
               else f"{dev['16']['total']:.3f} {dev['16']}")
            + ", T=1 " + ("not measured" if dev["1"] is None
                          else f"{dev['1']['total']:.3f} {dev['1']}")
            + f"; peak GB a rank {[round(r[kind]['peak_gb'], 2) for r in reps]}"
            f"; a rank holds {cache_text(r0['cache'])}"
            + (f", expert leaves {r0['expert_bytes'] / 1e9:.2f} of "
               f"{experts / 1e9:.2f} GB" if experts else "")
            + f"; launches {r0['launches']}")
        stats[kind] = {"tok_s": r0["n_tok"] / r0["wall_s"],
                       "device_ms": dev,
                       "peak_gb": max(r[kind]["peak_gb"] for r in reps)}
    print(f"sharded serve: {arch} FULL at {cfg.n_layers} layers on "
          f"{SHARD_SERVE_MESH}, 4 ranks on one card ({smi}), lockstep, 4 "
          f"slots (2 a data rank), no graph (eager: host-staged "
          f"collectives); " + "; ".join(texts), flush=True)
    return {"launches": launches, "stats": stats}


def sharded_wave_gates(smoke: Smoke, kops, serve_r: list, smi: str) -> dict:
    """The wave steps' gates, one report a rank: the launches of a prefill
    and ``SHARD_DECODES`` decode steps of a rank's share, the cache a rank
    holds (its rows of the batch; the KV rows split over ``model``, over
    ``data`` x ``model`` for one row, every KV head). Prints each step's
    ms a rank split into local compute and collectives, and the peak
    GB."""
    launches = {k: 0 for k in kops.KERNELS}
    stats = []
    for i, (arch, depth, rows, prompt, cap) in enumerate(SHARD_WAVES):
        cfg = shard_cfg(arch, depth)
        reps = [r["waves"][i] for r in serve_r]
        want = tp_serve_launches(cfg, prefill=True)
        dec = tp_serve_launches(cfg)
        want = {k: want.get(k, 0) + SHARD_DECODES * dec.get(k, 0)
                for k in set(want) | set(dec)}
        for rep in reps:
            for k in launches:
                launches[k] += rep["launches"][k]
            got = {k: rep["launches"].get(k, 0) for k in want}
            if got != want:
                smoke.fail(f"sharded wave {arch} {rows}x{prompt}: launches "
                           f"{got}, want {want}")
            if cap is not None:
                k = rep["cache"]["attn/k"]
                local = cap // (2 if rows > 1 else 4)
                if rep["rows"] != cap or k[1:4] != [max(rows // 2, 1),
                                                   local, cfg.n_kv_heads]:
                    smoke.fail(f"sharded wave {arch} {rows}x{prompt}: a "
                               f"rank's KV cache {k} of {rep['rows']} rows, "
                               f"want {max(rows // 2, 1)} x {local} rows x "
                               f"{cfg.n_kv_heads} heads")
        steps = [[s["ms"] for s in r["steps"][1:]] for r in reps]
        coll = [[s["collective_ms"] for s in r["steps"][1:]] for r in reps]
        pre = [r["steps"][0] for r in reps]
        stat = {"arch": arch, "rows": rows, "prompt": prompt, "cap": cap,
                "prefill_ms": [p["ms"] for p in pre],
                "prefill_collective_ms": [p["collective_ms"] for p in pre],
                "decode_ms": [statistics.median(v) for v in steps],
                "decode_collective_ms": [statistics.median(v) for v in coll],
                "peak_gb": [r["peak_gb"] for r in reps]}
        stats.append(stat)
        print(f"sharded wave: {arch} FULL at {cfg.n_layers} layers, "
              f"{rows} x {prompt} tokens"
              + (f" into {cap} cache rows" if cap else "")
              + f" on {SHARD_SERVE_MESH} under seq_shard ({smi}); a rank "
              f"holds {cache_text(reps[0]['cache'])}; prefill ms a rank "
              f"{[round(v, 1) for v in stat['prefill_ms']]} (collectives "
              f"{[round(v, 1) for v in stat['prefill_collective_ms']]}); "
              f"decode ms a rank, median of {SHARD_DECODES} "
              f"{[round(v, 2) for v in stat['decode_ms']]} (collectives "
              f"{[round(v, 2) for v in stat['decode_collective_ms']]}); "
              f"peak GB a rank {[round(v, 2) for v in stat['peak_gb']]}; "
              f"launches a rank {reps[0]['launches']}", flush=True)
    return {"launches": launches, "stats": stats}


def sharded_encdec_gates(smoke: Smoke, kops, serve_r: list,
                         smi: str) -> dict:
    """The encoder-decoder's wave steps' gates, one report a rank: the
    launches of a prefill and ``SHARD_DECODES`` decode steps of a rank's
    share, and the caches a rank holds: its 2 of the 4 rows; under the
    default rules half the KV heads of every row, under ``seq_shard`` half
    the self and cross caches' rows with every KV head. Prints each step's
    ms a rank split into local compute and collectives."""
    cfg = shard_cfg(SHARD_ENCDEC, None)
    pre, dec = tp_serve_launches(cfg, prefill=True), tp_serve_launches(cfg)
    want = {k: pre.get(k, 0) + SHARD_DECODES * dec.get(k, 0)
            for k in set(pre) | set(dec)}
    launches = {k: 0 for k in kops.KERNELS}
    stats = []
    for i, (rules, rows, frames, prompt, cap) in enumerate(
            SHARD_ENCDEC_WAVES):
        reps = [r["encdec_waves"][i] for r in serve_r]
        tag = f"sharded wave {SHARD_ENCDEC} {rules} {rows}x{frames}+{prompt}"
        split = rules == "seq"
        heads = cfg.n_kv_heads if split else cfg.n_kv_heads // 2
        shapes = {
            "self_k": [cfg.n_layers, rows // 2, cap // 2 if split else cap,
                       heads, cfg.dh],
            "cross_k": [cfg.n_layers, rows // 2,
                        frames // 2 if split else frames, heads, cfg.dh]}
        for rep in reps:
            for k in launches:
                launches[k] += rep["launches"][k]
            got = {k: rep["launches"].get(k, 0) for k in want}
            if got != want:
                smoke.fail(f"{tag}: launches {got}, want {want}")
            for name, shape in shapes.items():
                if rep["cache"].get(name) != shape or rep["rows"] != cap:
                    smoke.fail(f"{tag}: a rank's {name} "
                               f"{rep['cache'].get(name)} of {rep['rows']} "
                               f"rows, want {shape} of {cap}")
        steps = [[s["ms"] for s in r["steps"][1:]] for r in reps]
        coll = [[s["collective_ms"] for s in r["steps"][1:]] for r in reps]
        pre_ms = [r["steps"][0] for r in reps]
        stat = {"rules": rules, "rows": rows, "frames": frames,
                "prompt": prompt, "cap": cap,
                "prefill_ms": [p["ms"] for p in pre_ms],
                "prefill_collective_ms": [p["collective_ms"]
                                          for p in pre_ms],
                "decode_ms": [statistics.median(v) for v in steps],
                "decode_collective_ms": [statistics.median(v) for v in coll],
                "peak_gb": [r["peak_gb"] for r in reps]}
        stats.append(stat)
        print(f"{tag}: {SHARD_ENCDEC} FULL, {rows} x ({frames} frames, "
              f"{prompt} tokens) into {cap} self-cache rows on "
              f"{SHARD_SERVE_MESH} under the "
              + ("production rules' seq_shard" if split else "default rules")
              + f" ({smi}); a rank holds self {shapes['self_k']}, cross "
              f"{shapes['cross_k']}; prefill ms a rank "
              f"{[round(v, 1) for v in stat['prefill_ms']]} (collectives "
              f"{[round(v, 1) for v in stat['prefill_collective_ms']]}); "
              f"decode ms a rank, median of {SHARD_DECODES} "
              f"{[round(v, 2) for v in stat['decode_ms']]} (collectives "
              f"{[round(v, 2) for v in stat['decode_collective_ms']]}); "
              f"peak GB a rank {[round(v, 2) for v in stat['peak_gb']]}; "
              f"launches a rank {reps[0]['launches']}", flush=True)
    return {"launches": launches, "stats": stats}


# ---------------------------------------------------------------------------
# the dry run and the roofline

# the train cells of the split families (llama and mamba2, grok-1's MoE:
# every train step splits over model), both serve kinds of the dense
# family, the hybrid's decode, the SSM's 500k-position decode and the MoE's
# decode (its experts' e_ff columns over model=16)
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"),
                ("llama3.2-1b", "decode_32k"), ("mamba2-1.3b", "train_4k"),
                ("mamba2-1.3b", "long_500k"), ("zamba2-2.7b", "decode_32k"),
                ("grok-1-314b", "train_4k"), ("grok-1-314b", "decode_32k"))
DRYRUN_OUT = OBS_DIR.parent / "dryrun_smoke"
DRYRUN_LOG = OBS_DIR.parent / "dryrun_smoke.log"
DRYRUN_TIMEOUT_S = 600              # from its start to its records
DRYRUN_SCRIPT = """
import sys
from repro_torch.launch import dryrun
for cell in sys.argv[2:]:
    arch, shape = cell.split(":")
    rec = dryrun.run_cell(arch, shape, "single", sys.argv[1], force=True)
    print(dryrun.status_line(rec), flush=True)
"""
ANALYSE_REPS = 5                    # timed calls of each analysed step
ROOFLINE_SHARE_MAX = 1.05           # bound / measured: no card beats it
EXAMPLE_CKPT = OBS_DIR.parent / "train_lm_smoke"
EXAMPLES = (("torch_quickstart.py", (), "quickstart check: OK"),
            ("torch_serve_batch.py", ("--requests", "8", "--max-new", "8"),
             "serve_batch check: OK"),
            ("torch_ssd_long_context.py", (), "ssd_long_context check: OK"),
            ("torch_train_lm.py", ("--config", "smoke", "--steps", "4",
                                   "--ckpt-every", "2", "--ckpt-dir",
                                   str(EXAMPLE_CKPT)), "train_lm check: OK"),
            ("torch_train_lm.py", ("--config", "smoke", "--steps", "6",
                                   "--ckpt-every", "2", "--ckpt-dir",
                                   str(EXAMPLE_CKPT)), "resumed from step 4"))


def example_runs(smoke: Smoke) -> dict:
    """The four examples on the card (their default device), each a
    subprocess at a small size; train_lm twice, the second run resuming
    from the first's checkpoint. Each must exit 0 and print its check."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    out = {}
    for script, args, check in EXAMPLES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(root / "examples" / script),
                              *args], env=env, cwd=root, capture_output=True,
                             text=True, timeout=300)
        secs = time.perf_counter() - t0
        tail = run.stdout.strip().splitlines()[-1:] or [""]
        ok = run.returncode == 0 and check in run.stdout
        print(f"example {script} {' '.join(args[:2])}: exit "
              f"{run.returncode} in {secs:.1f} s: {tail[0]}", flush=True)
        if not ok:
            smoke.fail(f"example {script} {args}: exit {run.returncode}, "
                       f"{check!r} not printed: "
                       f"{(run.stdout + run.stderr)[-1500:]}")
        out[f"{script} {' '.join(args[:2])}".strip()] = dict(
            exit=run.returncode, seconds=secs, ok=ok)
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    return out


def dryrun_records(smoke: Smoke, proc, log: str) -> dict:
    """The dry-run subprocess's records, each printed: status, peak GiB a
    rank, whether it fits, and the three roofline terms."""
    if proc.returncode != 0:
        smoke.fail(f"dry run exited {proc.returncode}: {log[-3000:]}")
    out = {}
    for arch, shape in DRYRUN_CELLS:
        path = DRYRUN_OUT / "single" / f"{arch}__{shape}.json"
        if not path.exists():
            smoke.fail(f"dry run: no record of {arch} {shape}")
            continue
        rec = json.loads(path.read_text())
        if rec["status"] not in ("ok", "skip"):
            smoke.fail(f"dry run {arch} {shape}: {rec['status']}: "
                       f"{rec.get('reason', '')}")
        if rec["status"] == "ok":
            r = rec["roofline"]
            line = (f"peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB a "
                    f"rank, fits {rec['fits']}, compute {r['compute_s']:.4e} "
                    f"s, memory {r['memory_s']:.4e} s, collective "
                    f"{r['collective_s']:.4e} s ({r['dominant']}), trace "
                    f"{rec['trace_s']} s")
            out[f"{arch} {shape}"] = dict(
                status="ok", peak_bytes=rec["memory"]["peak_bytes"],
                fits=rec["fits"], roofline=r, trace_s=rec["trace_s"])
        else:
            line = rec["reason"]
            out[f"{arch} {shape}"] = dict(status=rec["status"],
                                          reason=rec["reason"])
        print(f"dry run {arch} {shape} (single mesh, 256 ranks): "
              f"{rec['status']}: {line}", flush=True)
    return out


def analysed(smoke: Smoke, kops, label: str, fn, args, model_flops: float,
             measured_ms: float) -> dict:
    """``fn(*args)`` under the op analyser on the kernel path (the default
    policy; its kernels must launch) and under ``baseline``: their FLOPs
    and bytes must agree (rel 1e-9). Then the roofline of the kernel
    path's count on the H100's constants against the measured time: the
    share bound / measured must stay at most ROOFLINE_SHARE_MAX."""
    from repro_torch.core import policy as kpolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.op_analysis import analyse, roofline_terms

    torch = smoke.torch
    kops.reset_launches()
    kernel = analyse(fn, *args)
    launched = {k: n for k, n in kops.launch_counts().items() if n}
    with kpolicy.using_policy("baseline"):
        base = analyse(fn, *args)
    torch.cuda.synchronize()
    if not launched:
        smoke.fail(f"analyser {label}: the kernel path launched no kernel")
    for key in ("flops", "memory_bytes"):
        if abs(kernel[key] - base[key]) > 1e-9 * max(abs(base[key]), 1.0):
            smoke.fail(f"analyser {label}: {key} {kernel[key]!r} on the "
                       f"kernels, {base[key]!r} under baseline")
            diff = {op: (kernel["aten_ops"].get(op), base["aten_ops"].get(op))
                    for op in set(kernel["aten_ops"]) | set(base["aten_ops"])
                    if kernel["aten_ops"].get(op) != base["aten_ops"].get(op)}
            print(f"analyser {label}: aten ops counted apart (kernels, "
                  f"baseline): {diff}", flush=True)
    terms = roofline_terms(kernel, peak_flops=mesh_lib.PEAK_FLOPS_BF16,
                           hbm_bw=mesh_lib.HBM_BW, link_bw=mesh_lib.LINK_BW)
    secs = measured_ms / 1e3
    share = terms["bound_s"] / secs
    mfu = model_flops / (secs * mesh_lib.PEAK_FLOPS_BF16)
    if not share <= ROOFLINE_SHARE_MAX:
        smoke.fail(f"analyser {label}: bound {terms['bound_s']:.6f} s over "
                   f"the measured {secs:.6f} s ({share:.3f} > "
                   f"{ROOFLINE_SHARE_MAX}): a wrong count or constant")
    print(f"analyser {label}: measured {measured_ms:.3f} ms; op flops "
          f"{kernel['flops']:.6e}, bytes {kernel['memory_bytes']:.6e} "
          f"(baseline {base['flops']:.6e}, {base['memory_bytes']:.6e}); "
          f"bound {terms['bound_s'] * 1e3:.3f} ms ({terms['dominant']}: "
          f"compute {terms['compute_s'] * 1e3:.3f}, memory "
          f"{terms['memory_s'] * 1e3:.3f}); model flops {model_flops:.6e}; "
          f"MFU {mfu:.4f}; bound / measured {share:.4f}; peak tracked "
          f"{kernel['memory']['peak_bytes'] / 1e9:.2f} GB; kernels launched "
          f"{launched}; dispatch ops {kernel['dispatch_ops']}", flush=True)
    return dict(measured_ms=measured_ms, flops=kernel["flops"],
                memory_bytes=kernel["memory_bytes"],
                baseline_flops=base["flops"],
                baseline_memory_bytes=base["memory_bytes"], roofline=terms,
                model_flops=model_flops, mfu=mfu, bound_share=share,
                memory=kernel["memory"], launched=launched)


def step_ms(torch, fn) -> float:
    """Median host ms of ANALYSE_REPS calls of ``fn``, each waited for."""
    times = []
    for _ in range(ANALYSE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def analysed_train(smoke: Smoke, kops) -> dict:
    """train_pass's llama3.2-1b FULL step (bf16, AdamW, B x S = 4 x 512)
    timed, then counted by the analyser."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMPipeline
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.training import init_train_state, make_train_step

    torch = smoke.torch
    cfg = configs.get("llama3.2-1b").FULL
    bundle = build(cfg)
    opt_cfg = OptConfig()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             bundle, opt_cfg)
    step = make_train_step(bundle, opt_cfg)
    batch = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0), device="cuda").device_batch(0)
    step(state, batch)
    ms = step_ms(torch, lambda: step(state, batch))
    mf = 6.0 * bundle.n_active_params * TRAIN_BATCH * TRAIN_SEQ
    out = analysed(smoke, kops, f"llama3.2-1b train step B={TRAIN_BATCH} "
                   f"S={TRAIN_SEQ}", step, (state, batch), mf, ms)
    del state, batch
    return out


def analysed_decode(smoke: Smoke, kops) -> dict:
    """One mamba2-1.3b FULL wave decode step (bf16, 4 slots after a 4 x 512
    prefill) timed, then counted by the analyser."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.common import init_params
    from repro_torch.training import make_serve_step

    torch = smoke.torch
    cfg = configs.get("mamba2-1.3b").FULL
    bundle = build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        params = init_params(bundle.params_pspec, gen, cfg.dtype)
        prefill_step, decode_step = make_serve_step(bundle)
        tokens = torch.randint(3, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                               generator=gen, device="cuda")
        _, cache = prefill_step(params, {"tokens": tokens})
        batch = {"tokens": tokens[:, -1:]}
        decode_step(params, cache, batch)
        ms = step_ms(torch, lambda: decode_step(params, cache, batch))
        mf = 2.0 * bundle.n_active_params * TRAIN_BATCH
        out = analysed(smoke, kops, f"mamba2-1.3b decode step B="
                       f"{TRAIN_BATCH}", decode_step, (params, cache, batch),
                       mf, ms)
    del params, cache
    return out


def start_dryrun():
    """Start the dry run of DRYRUN_CELLS on the single mesh: a CPU
    subprocess (a fake world of 256 ranks, one thread), its output into
    DRYRUN_LOG; killed at the script's exit if it still runs. -> (the
    process, its start time)."""
    src = Path(__file__).resolve().parent / "src"
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    with open(DRYRUN_LOG, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-W", "ignore", "-c", DRYRUN_SCRIPT,
             str(DRYRUN_OUT), *(f"{a}:{s}" for a, s in DRYRUN_CELLS)],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(stop_process, proc)
    return proc, time.perf_counter()


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def dryrun_pass(smoke: Smoke, kops, dry) -> dict:
    """The examples on the card, then the records of the dry run
    :func:`start_dryrun` started (``dry``), then the op analyser on the
    llama train step and the mamba decode step. The phase's launches are
    not counted into the main path's."""
    proc, t0 = dry
    try:
        examples = example_runs(smoke)
    finally:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_process(proc)
            smoke.fail(f"dry run: over {DRYRUN_TIMEOUT_S} s")
    log = DRYRUN_LOG.read_text()
    print(f"dry run of {len(DRYRUN_CELLS)} cells, beside the phases before "
          f"this one: records read {time.perf_counter() - t0:.1f} s after "
          "its start", flush=True)
    records = dryrun_records(smoke, proc, log)
    out = {"dryrun": records, "examples": examples,
           "train": analysed_train(smoke, kops)}
    gc.collect()
    smoke.torch.cuda.empty_cache()
    out["decode"] = analysed_decode(smoke, kops)
    out["launches"] = {k: 0 for k in kops.KERNELS}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no {src / 'repro_torch'} beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import ops
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve

    # references compute in full f32 (cuDNN would take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} capability "
          f"{torch.cuda.get_device_capability(0)}", flush=True)
    t0 = time.perf_counter()
    lib_path = build.library_path()
    build.load()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.1f}s "
          f"({'built' if build.build_seconds is not None else 'cached'})",
          flush=True)
    for line in ptxas_report(lib_path.parent / "build.log"):
        print(line, flush=True)
    lib = build.load()
    print("flash_attention.cu dynamic shared memory per block: " + ", ".join(
        f"{name} D={dh} Lk={lk} "
        f"{lib.flash_attention_smem_bytes(dh, lk, code)} B"
        for name, code in (("bf16", 2), ("f32", 0)) for dh in (64, 128)
        for lk in (512, 4096)), flush=True)
    smoke = Smoke(torch)
    with torch.inference_mode():
        kops.reset_launches()
        try:
            ops_pass(smoke, ops, ref)
        except Exception as exc:
            smoke.fail(f"ops pass: {exc!r}")
        ops_counts = kops.launch_counts()
        print(f"main path, ops: launches {ops_counts}; SSD instances "
              f"{instance_text(kops.instance_counts())}", flush=True)
        for name, count in ops_counts.items():
            if count < 1:
                smoke.fail(f"ops pass launched {name} no time")
        stats = {}
        launches = dict(ops_counts)
        runs = [("ragged ops", lambda: ragged_pass(smoke, ops, kops))]
        runs += [(f"{arch} wave" + ("" if policy is None else f" {policy}"),
                 lambda a=arch, p=policy, pl=per_layer, ab=absent:
                 serve_pass(smoke, serve, kops, a, p, pl, ab))
                for arch, policy, per_layer, absent in SERVED]
        runs += [("kernel policy", lambda: policy_pass(smoke, serve, ops,
                                                       kops, ref))]
        ring_ref: dict = {}
        runs += [(f"{arch} continuous",
                  lambda a=arch: continuous_pass(smoke, serve, kops, a,
                                                 ring_ref))
                 for arch in CONTINUOUS]
        runs += [(f"{arch} paged",
                  lambda a=arch: paged_parity(smoke, serve, kops, a,
                                              ring_ref))
                 for arch in PAGED]
        runs += [("llama3.2-1b shared prefix",
                  lambda: shared_prefix_pass(smoke, serve, kops)),
                 ("llama3.2-1b obs", lambda: obs_pass(smoke, serve, kops)),
                 ("mamba2-1.3b multi-turn",
                  lambda: multi_turn_pass(smoke, serve, kops)),
                 ("llama3.2-1b sampling",
                  lambda: sampling_pass(smoke, serve, kops)),
                 (f"{WINDOW_ARCH} window prefill and ring decode",
                  lambda: window_pass(smoke, kops))]
        runs += [(f"{arch} {kind} prefill and decode",
                  lambda a=arch, n=layers, k=kind, g=gate, t=tag:
                  frontend_pass(smoke, serve, kops, a, n, k, g, t))
                 for arch, layers, kind, gate, tag in FRONTENDS]
        for run, fn in runs:
            t_run = time.perf_counter()
            try:
                stats[run] = fn()
            except Exception as exc:
                smoke.fail(f"serve pass {run}: {exc!r}")
                stats[run] = {"launches": {k: 0 for k in ops_counts}}
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {run}: {time.perf_counter() - t_run:.1f} s",
                  flush=True)
            for k in launches:
                launches[k] += stats[run]["launches"][k]

    # the dry run on the CPU beside the phases from here to its own
    dry = start_dryrun()

    # training, outside inference mode
    for arch in TRAIN_ARCHS:
        run = f"{arch} train"
        t_run = time.perf_counter()
        try:
            stats[run] = train_pass(smoke, kops, arch)
        except Exception as exc:
            smoke.fail(f"train pass {arch}: {exc!r}")
            stats[run] = {"launches": {k: 0 for k in ops_counts}}
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase {run}: {time.perf_counter() - t_run:.1f} s",
              flush=True)
        for k in launches:
            launches[k] += stats[run]["launches"][k]

    # the multi-device ops and GPipe in a world of ranks on this card
    run = "distributed"
    t_run = time.perf_counter()
    try:
        stats[run] = distributed_pass(smoke, kops)
    except Exception as exc:
        smoke.fail(f"distributed pass: {exc!r}")
        stats[run] = {"launches": {k: 0 for k in ops_counts}}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {run}: {time.perf_counter() - t_run:.1f} s", flush=True)
    for k in launches:
        launches[k] += stats[run]["launches"][k]

    # sharded training and lockstep serving in worlds of ranks on this card
    run = "sharded"
    t_run = time.perf_counter()
    try:
        stats[run] = sharded_pass(smoke, kops)
    except Exception as exc:
        smoke.fail(f"sharded pass: {exc!r}")
        stats[run] = {"launches": {k: 0 for k in ops_counts}}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {run}: {time.perf_counter() - t_run:.1f} s", flush=True)
    for k in launches:
        launches[k] += stats[run]["launches"][k]

    # the dry run on a fake world, the op analyser, the examples
    run = "dryrun and roofline"
    t_run = time.perf_counter()
    try:
        stats[run] = dryrun_pass(smoke, kops, dry)
    except Exception as exc:
        smoke.fail(f"dryrun and roofline pass: {exc!r}")
        stats[run] = {"launches": {k: 0 for k in ops_counts}}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase {run}: {time.perf_counter() - t_run:.1f} s", flush=True)

    with torch.inference_mode():
        t_run = time.perf_counter()
        rows = check_kernels(smoke, kops, ref)
        whole_ops = compare_whole_ops(smoke, ops, ref)
        print(f"phase kernels: {time.perf_counter() - t_run:.1f} s",
              flush=True)

    kernels = []
    for name, k in kops.KERNELS.items():
        row = rows.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            **{key: row.get(key) for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "cases": row.get("cases", [])})
    print(json.dumps({"serve": stats, "whole_ops": whole_ops}))
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} failure(s):",
              file=sys.stderr)
        for f in smoke.failures:
            print(f"  {f}", file=sys.stderr)
        print(json.dumps({"kernels": kernels}))
        return 1
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(sys.argv[2], int(sys.argv[3]),
                                int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())

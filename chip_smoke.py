#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

It runs the paper's SUMMA engine at the commodity-cluster size of
``configs/paper_mm.py`` (N = 32768, block 256) on the 1x1 grid of one
card, through the entry points a user calls (``DistributedMatmul``, with
and without the schedule tuner, and ``NonuniformMatmul``), the
block-sparse tensor front-end (``DistributedMatmul.contract`` and
``contract_chain``) on a coupled-cluster contraction, then the LM
forwards of llama3.2-1b, the MoE, recurrent and frontend families
through ``models.model.forward``, a server (``launch.serve.main`` and
``serve.scheduler.Scheduler``), a trainer (``train.train_step`` and
``launch.train.main``), and checks every hand-written kernel
against its plain PyTorch version.  Phases, in the order they run — any failure
raises, so the script exits non-zero:

1. device: the card's name and power limit; TF32 off;
2. build: the four CUDA kernels from the checkout's sources (nvcc,
   sm_90a), with ptxas' register and spill report (and the bf16
   flash-attention kernel's shared memory at each Dh), and each kernel's
   count of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) instructions in its
   SASS; the bf16 flash-attention kernel and every instance of
   ``tiled_matmul``, ``bsmm`` and the grouped GEMM must have ``HGMMA``;
3. kernel vs plain version on the card, at the reference test shapes and
   at the shapes the main path gives each kernel, fp32 and bf16, each
   with its worst element as a share of the hold, and
   ``flash_attention`` also at head widths off its instances (8, 80,
   112);
4. main path, dense: 128 K panels through the ``tiled_matmul`` kernel,
   checked against ``torch.matmul``;
5. main path, block-sparse at block fill 0.3: the ``bsmm`` kernel on the
   plan's CSR map, checked against ``reference_blocksparse_matmul`` and
   against ``torch.matmul`` of operands masked here, independently of the
   port's own masking;

   [tuned] the same two products with ``tune=True``: the schedule tuner's
   record, ``tiled_matmul`` launched as the tuned executor issues it (one
   per K panel, or once for the all-gather schedule) and ``bsmm`` once, C
   against ``torch.matmul``;

   [25d] ``summa_25d_matmul`` on the 1x1x1 grid ``("pod", "data",
   "model")``, replicas over ``pod``, at the same size and ``k_blocks``:
   128 ``tiled_matmul`` launches, C bitwise equal to ``summa_matmul``'s
   on the 2-axis grid and within the fp32 hold of ``torch.matmul``; then
   ``summa_matmul`` with the tuple row axis ``("pod", "data")``, bitwise
   equal too;
6. main path, rank-sparse: A as low-rank block factors
   (``make_rank_factors``: 2342 of 16384 blocks, ranks up to 64, r_pad
   64), ``DistributedMatmul(None, b, a_ranks=rcsr)`` with stage 1 through
   the ``grouped_gemm`` kernel once per chunk of block rows, checked
   against ``torch.matmul`` of an A densified here from the factors;
   then the same product on the ``local_matmul="xla"`` route (torch
   products only), and a small case past the dense crossover (r_pad 136
   > r* = 128) whose panels all go through ``tiled_matmul``;
7. times of each kernel at the main path's shapes beside its plain
   version, one library call and the card's bound (the three matmul
   kernels' bound counts the function's FLOP at the bf16 peak, with the
   split's own floor of three bf16 products and the fp32-FMA bound of
   their earlier designs beside it);

   [tuner] ``tune_plan`` on abstract 4x4 and 16x16 grids at N with 128
   blocks, uniform and nonuniform, on the host, and ``python -m
   repro_torch.sched --grid 4 4 --extent 32768 --blocks 128
   --nonuniform``, whose JSON must parse;

   [autotune] a fresh ``KernelAutotuner`` times every route on the card
   (square buckets 128, 256, 512 in fp32 and bf16; the panel bucket
   (4096, 256, 4096) in fp32); ``tiled_matmul``, ``bsmm`` and
   ``grouped_gemm`` must each launch; its file must round-trip with a
   stable fingerprint; installed, it must steer a dense N = 4096 product's
   ``_local_dot`` to its bucket's winner;

   [nonuniform] the paper's commodity nonuniform product
   (``make_nonuniform_case(32768, 256)``) through ``NonuniformMatmul``
   (tile 256, ``k_blocks=185``, ``tune=True``) against ``torch.matmul``
   of the compact operands, its walls, peak memory, padding and the cost
   of its gathers; then ``tile="auto"`` on the autotune cache at
   ``nonuniform_medium`` (N = 4096);

   [contract] the tensor front-end, fp32: the coupled-cluster
   particle-particle ladder ``R[ijcd] = sum_ab T[ijab] V[abcd]`` at
   o = 64, v = 192, every mode in blocks of 16 (matricized (4096 x 36864)
   . (36864 x 36864) in merged blocks of 256; V is 5.44 GB), T's block
   fill 0.5 and V's 0.3: one ``bsmm`` launch, R against ``torch.matmul``
   of T and V masked here, the inferred mask against the boolean block
   product, a second call hitting its step program, ``compiled=False``
   equal bitwise, the kernel at the ladder's call against its plain
   version and alone, and the warm call's parts alone; the reference's
   seven contraction-oracle families at their shapes (plus the rank
   family in blocks of 32, where its factors stay factored), each kernel
   their plans launch held against its plain version at the plan's
   shapes, C against a float64 einsum at the oracle's hold and against
   the eager route bitwise; a tuned ``contract_chain`` of (A.B).C at
   N = 8192, blocks 256, decay masks: its report, the windows that ran,
   C against ``torch.matmul`` of operands masked here;

   [filter] norm-filtered (DBCSR-style screened) products: the
   reference ``bench_filter``'s workload at N = 32768, blocks 256,
   fp32, each block (i, k) of A and B scaled by exp(-0.8 |i - k|), norms
   from ``core.sparsity.block_norms``, through ``DistributedMatmul(...,
   a_norms, b_norms, filter_eps)`` with ``filter_eps`` = frac x the
   largest product bound, frac in (0, 1e-4, 1e-3, 1e-2, 5e-2): the eps-0
   plan's digest equal to the norm-free plan's, the launches per kernel
   (128 ``tiled_matmul`` unfiltered, one ``bsmm`` over the screened
   band), the gemm tasks never rising, ||C - C_exact||_F (C_exact in
   float64 on the card) within the plan's ``filter_bound`` plus
   bench_filter's slack scaled by sqrt(N / 1024), wall and peak, and each
   launched kernel against its plain version at the plan's shapes; the
   bsmm call at 1e-3 timed beside its plain version, ``torch.matmul``
   and its bound; a filtered ``contract_chain`` of (A.B).C at N = 8192:
   step 2 planned on step 1's filtered structure, C within b1 ||C||_F +
   b2 of a float64 chain;
8. LM forward: llama3.2-1b at full size (16 layers, d_model 2048, 32/8
   heads, d_ff 8192, vocab 128256, bf16, tied embeddings), weights from
   ``init_model`` with a seeded generator, 4 prompts x 4096 tokens.  An
   fp32 twin of the weights with plain attention is the yardstick: the
   fp32 forward through the kernel, and with ``matmul_strategy="summa"``
   on ``Grid.local`` (the FFN projections through ``DistributedMatmul``),
   must match it closely; the bf16 forwards — plain attention, the kernel
   (the main path: 16 ``flash_attention`` launches; each prompt's greedy
   next token) and summa — must each be no further from it than the
   plain one is, within the stated margins.  Then each bf16 forward again,
   warm, for its wall time and peak memory; one 32768-token prompt
   through the kernel (finite logits); the kernel's times beside its
   plain version (at 4096 only), ``scaled_dot_product_attention`` and
   its bound, at both lengths; and the kernel beside SDPA at 4 × 4096 with
   head widths 80 and 112 (hubert-xlarge's and kimi-k2's);

   [auto forward] llama3.2-1b at full width cut to 2 layers, 1 × 4096
   tokens, under ``matmul_strategy="auto"`` (the FFN projections on the
   tuner's schedule): 2 ``flash_attention`` launches, logits against the
   ``"summa"`` forward of the same weights within the bf16 pair hold;

   [moe] the mixture-of-experts family through ``models.model.forward
   (use_kernel=True)``, weights from ``init_model`` (seed 0), bf16:
   mixtral-8x7b at full width (d_model 4096, 8 experts of d_ff 14336,
   top-2, window 4096) on 4 prompts x 4096 tokens — first cut to 2
   layers and held against the fp32 forward of the same weights as
   phase 8 holds llama (the bf16 kernel forward no further from it than
   1.5x the bf16 einsum forward), then cut to 8 layers (its experts are
   22.5 GB; all 32 would be 90 GB, more than the card holds): warm wall,
   peak memory, greedy next tokens, 3 ``grouped_gemm`` launches a layer
   (gate, up, down) and one ``flash_attention``; then kimi-k2 at full
   width cut to 1 layer (384 experts of d_ff 2048, top-8, a shared
   expert, heads of 112; 39 GB in bf16) on 1 x 4096 tokens, its argmax
   held against its einsum forward's.  For each model: ``flash_attention``
   at its own attention call (mixtral B=4, 32/8 heads of 128, window
   4096; kimi-k2 B=1, 64/8 heads of 112) against its plain version; two
   witness forwards that split the kernel forward's distance from the
   einsum one between the kernels (plain attention with the kernel's
   experts, held to the einsum forward, and flash attention with einsum
   experts, held to the kernel forward, each within one bf16 rounding of
   a logit and 2e-2 of their rms); the first MoE layer through the kernel
   against the einsum route on the same input at the output's scale; and
   each ``grouped_gemm`` launch shape (the capacity buffer's C-row tiles:
   C = 1280 and 112) on the layer's own weights against
   ``grouped_gemm_plain`` at the output's scale, timed beside the plain
   version, one ``torch.bmm`` over the buffer grouped by expert and the
   card's bound;

   [recurrent] the recurrent families, bf16, weights from ``init_model``
   (seed 0): recurrentgemma-9b at full width and depth (38 layers, 17.5
   GiB) on 2 prompts x 4096 tokens — ``flash_attention`` at its own call
   (16/1 heads of 256, window 2048) against its plain version and timed
   beside SDPA with the window as a boolean mask; one unit (rglru, rglru,
   attn) held against its fp32 twin (``hold_against_twin``: plain,
   kernel and summa forms); the whole model's walls, peak, 12
   ``flash_attention`` launches and greedy tokens; one RG-LRU sublayer,
   its associative scan and the forward timed with CUDA events — then
   xlstm-1.3b at full width and depth (48 layers) on 4 x 4096 tokens,
   parallel and chunkwise (``mlstm_chunk=256``) mLSTM: one unit of 8
   blocks against its fp32 twin, the chunkwise core against a float64
   parallel core at the model's call, every mLSTM block of the whole
   model chunkwise against parallel on one input, walls and peak of both
   forms, and the sLSTM loop's share of device time; and each block
   kind's ``return_state`` over 256 tokens then 4 ``*_step`` against its
   sequence form (fp32 twin and bf16);

   [frontends] hubert-xlarge at full width and depth on 4 x 4096 stub
   frame embeddings (48 non-causal launches at Dh 80; its attention call
   held against plain and timed beside SDPA; the whole model against its
   fp32 twin), and qwen2-vl-72b at full width cut to 16 layers (80 are
   135 GiB) on 1024 stub patch embeddings and 3072 tokens with M-RoPE
   (t, h, w) streams built by the reference's rule: its attention call,
   the hold at 2 layers against the fp32 twin, text-only M-RoPE with
   equal streams against RoPE (bitwise), walls, peak, 16 launches;

   [serve] the serving path through ``launch.serve.main`` (its lines
   echoed) and ``serve.scheduler.Scheduler``, bf16, weights from
   ``init_model`` (seed 0), every kernel's plain version made to raise on
   a CUDA tensor meanwhile: llama3.2-1b at full width and depth, 4
   prompts of 4096 tokens generating 64 — first and warm calls (one
   ``flash_attention`` launch per layer in the prefill, none in decode),
   ``--matmul-strategy summa`` (every FFN projection through
   ``DistributedMatmul``; ``tiled_matmul`` launched once the autotune
   cache names it for the projections' panels, ``warm_kernel_cache``),
   ``auto`` with ``--plan-cache`` twice (the warm run tunes nothing and
   hits all four shapes), ``--continuous`` over ``launch.serve``'s 16 ragged
   requests (2048 or 4096 tokens, 16 or 64 new) on 4 slots, dense and
   ``--paged``, and ``ParallelCtx(kv_quant=True)``; then recurrentgemma-9b
   at full width and depth, 2 prompts of 4096 generating 32 (its window
   of 2048: prefill packs the ring, decode wraps it).  Holds: on an fp32
   twin cut to one unit, a prefill of 4096 and 8 decode steps against
   ``forward`` of the whole sequence at each position (the reference's
   serving hold), and continuous and paged tokens equal to the serial
   per-request loop's; in bf16 at full depth each step within 0.25 of
   max |logit| of the bf16 forward of the same weights (the forward one
   position earlier must fail that) and no further from the fp32 twin's
   forward than 1.5x the bf16 forward is; one decode
   step on the int8 cache against attention over the cache dequantized
   here.  Prints prefill and decode tok/s, continuous tok/s with p50 and
   p99 step ms, first call beside warm, peak memory and the int8 cache's
   bytes beside bf16's.  Then mixtral-8x7b at full width cut to 8 layers
   (MoE serving): the engine's prefill of 4 x 4096 (8 ``flash_attention``
   launches) and 63 decode steps wrapping its 4096-token window ring,
   first and warm, with p50/p99 step ms and a decode step's device kernel
   count; the scheduler over the same ragged trace (dense: paged is
   refused for a window, as in the reference); [serve]'s holds on an fp32
   twin cut to one layer and on the bf16 model, with a capacity factor
   that drops no token;

   [train] the training path, bf16, every kernel's plain version made to
   raise on a CUDA tensor: llama3.2-1b at full width and depth, its
   weights from ``make_train_state`` with a seeded generator, AdamW,
   ``attention_impl="chunked"`` and remat, 3 steps of ``SyntheticData``'s
   8 x 4096 tokens in 2 microbatches through ``build_train_step`` — the
   step walls (first and warm), tokens/s, peak memory, the losses and
   the four kernels' launches (0: no TPU kernel is on the reference's
   training path); at full width cut to 2 layers, a step of 2
   microbatches against 1 (params within 5e-2) and 3 steps under
   ``matmul_strategy="summa"`` (the FFN projections and both products of
   their backward through ``DistributedMatmul``) against ``"xla"``
   (losses within rtol 2e-2); mixtral-8x7b at full width cut to 2 layers,
   AdamW, chunked attention and remat, 3 steps of 2 x 4096 tokens in 2
   microbatches (walls, tokens/s, a peak under 70 GiB, finite losses and
   load-balance losses, no kernel launched), and at 1 layer against an
   fp32 twin of the same weights: the first update's moments and master
   changes leaf by leaf (the same step on half the batch must fail that),
   the params their masters rounded, and each bf16 step's loss within
   rtol 2e-2 of the twin's on the same weights (the twin left to itself
   printed beside);
   ``chunked_attention`` at llama's
   attention call (4 x 4096, 32/8 heads of 64) in fp32 against
   ``flash_attention_plain`` under autograd (output 2e-5, dQ/dK/dV 2e-4
   of the operands' rms), and forward + backward timed in fp32 and bf16
   beside the plain version and ``scaled_dot_product_attention``; then
   ``launch.train.main --smoke`` on the card: the loss falls over 40
   steps, ``--fail-at-step 16`` exits 42 and ``--resume`` ends within
   1e-4 of the uninterrupted run, and recurrentgemma-9b gives finite
   losses;

   [dryrun] the cost analysis (``analysis.cost``) against the dry run
   (``launch.dryrun``): four calls at full width, each counted on the
   card under the counter and by the dry run of the same call on
   ``meta`` — (a) llama3.2-1b's ``serve.engine.prefill`` of 4 x 4096
   tokens (16 ``flash_attention`` launches), (b) its train step at
   [train]'s shape (8 x 4096 in 2 microbatches, AdamW, chunked
   attention, remat), (c) mixtral-8x7b's forward cut to 1 layer on 1 x
   4096 tokens with ``use_kernel=True`` (3 ``grouped_gemm``, 1
   ``flash_attention``), (d) the block-sparse product at N = 32768, fill
   0.3 (one ``bsmm``), and ``tiled_matmul`` alone at phase 7's panel
   shape.  FLOP, bytes and collective bytes must be equal, each kernel's
   counted FLOP equal the figure phase 7's formula gives at its calls,
   and the dry run's peak above its arguments within 15 % of
   ``torch.cuda.max_memory_allocated``'s above what was allocated on
   entry (stats reset before the call).  For (a) and (b) it prints the
   uncounted warm wall, the bound on the card and its dominant term,
   bound / wall and model FLOP / (wall x the bf16 peak).  The card's
   peaks come from ``analysis.cost.DEFAULT_HW``.  (e) llama3.2-1b's
   ``serve.engine.decode_step`` at [serve]'s shape (4 slots, 4096 + 64
   context), held the same way, and: its bytes at least its weights plus
   the K/V cache it reads, and at most 1.1 x that plus the cache's fp32
   copy (``_partial_attn`` widens the bf16 cache, writing 2x its bytes
   and reading them again); its cache writes charged twice the update
   (``analyze_hlo``'s scatter rule); its temporaries the peak less the
   arguments less the outputs that are not the cache it updates in place,
   above 0.  And (b)'s FLOP fall from 3.51259605336064e14 by exactly the
   units' last products, 16 x 2 x 32768 x 8192 x 2048, which the remat
   backward no longer recomputes;

   [examples] the four examples (``examples/torch_*.py``), each imported
   and its ``main`` called on the card under the plain guard, every count
   set to 0 just before and read just after: the quickstart and the
   block-sparse contraction on the 1x1 grid (their products held against
   their oracles by the examples themselves; ``tiled_matmul`` and
   ``bsmm`` launched), the batched server on llama3.2-1b's smoke config
   (one ``flash_attention`` launch per layer), the training example for
   60 steps (the loss falls; resumed from step 50 it retraces the run;
   no kernel).  Each one's wall and launches are printed.

   [shard] the sharding rules (``dist.partitioning.shard_params``) as
   per-rank programs: two gloo processes on the one card (the same spawn
   as ``launch.mesh.spawn_gloo_ranks``; NCCL refuses two ranks on one
   device, so every collective goes through host memory and none across
   cards is measured), each holding only its blocks.  llama3.2-1b at full
   width and depth, bf16, a forward of 4 x 4096 on 1x2 (tp: 16 q / 4 kv
   heads per rank) and on 2x1 (dp: 2 rows per rank), each against the
   1x1 forward at the bf16 pair hold, 16 ``flash_attention`` launches per
   rank, the rank's parameter bytes equal to its spec's share, and on 1x2
   block 0 held layer by layer at the output's scale (its attention block
   against the 1x1 block, ``flash_attention`` at the rank's 16 q / 4 kv
   heads against its plain version); one AdamW
   step on 2x1 (FSDP + DP), 4 x 4096 in 2 microbatches, against the 1x1
   step at [train]'s holds (loss, every parameter block, every first
   moment), peak memory per process printed; mixtral-8x7b cut to 2 layers
   on 1 x 4096 at 1x2 (4 experts per rank, 3 ``grouped_gemm`` per layer on
   each rank) against the 1x1 forward, and block 0 layer by layer (its
   attention block and its MoE layer on the rank's experts against the
   1x1 ones, ``flash_attention`` and ``grouped_gemm`` on 4 experts against
   their plain versions, at the output's scale); the scheduler on 2x1,
   dense and paged (one page table over all slots, the pool whole on each
   rank), 4 ragged requests on 4 slots (2 per rank) on an fp32 twin at
   full width cut to 2 layers, every request's greedy tokens equal to the
   1x1 run's.

Every product runs on an empty autotune cache, so its launch counts do
not depend on the cache, except the two that check the cache: the end of
[autotune] and the ``tile="auto"`` product of [nonuniform] install the
tuned cache and reset it after.

The line before the last is a JSON object listing every kernel; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import DistributedMatmul, Grid  # noqa: E402
from repro_torch.analysis.cost import (  # noqa: E402
    DEFAULT_HW,
    analyze_step,
    roofline,
)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.paper_mm import (  # noqa: E402
    BENCH_CONFIGS,
    COMMODITY_BLOCK,
    COMMODITY_N,
    make_case,
    make_nonuniform_case,
    make_rank_factors,
)
from repro_torch.core import NonuniformMatmul, plan_matmul  # noqa: E402
from repro_torch.core import summa as core_summa  # noqa: E402
from repro_torch.core.blocking import (  # noqa: E402
    bucketize,
    nonuniform_tiling,
    uniform_tiling,
)
from repro_torch.core.contract import (  # noqa: E402
    BlockSparseTensor,
    _step_geometry,
    _unmatricize_step,
    parse_contraction,
)
from repro_torch.core.sparsity import (  # noqa: E402
    banded_block_mask,
    block_csr_from_mask,
    block_norms,
    decay_block_mask,
    decay_rank_map,
    random_block_mask,
    rank_panel_factored_comm,
    synthesize_rank_csr,
)
from repro_torch.core.summa import (  # noqa: E402
    RANK_CHUNK_BYTES,
    SummaConfig,
    rank_operands,
    reference_blocksparse_matmul,
    summa_25d_matmul,
    summa_matmul,
)
from repro_torch.dist.context import ParallelCtx  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    KernelAutotuner,
    bucket_key,
    set_autotune_cache,
)
from repro_torch.kernels.bsmm import (  # noqa: E402
    TILE_COLS,
    bsmm_cuda,
    bsmm_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_HEAD_DIMS,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.grouped_gemm import (  # noqa: E402
    grouped_gemm_cuda,
    grouped_gemm_plain,
    tile_pairs,
)
from repro_torch.kernels.tiled_matmul import (  # noqa: E402
    tiled_matmul_cuda,
    tiled_matmul_plain,
)
from repro_torch.kernels import bsmm as bsmm_kernel  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as attention_layer  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.chunked_attention import (  # noqa: E402
    chunked_attention,
)
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.convert import params_tree  # noqa: E402
from repro_torch.models.model import LM, forward, init_model  # noqa: E402
from repro_torch.sched import (  # noqa: E402
    abstract_summa_config,
    from_plan,
    tune_plan,
)
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.train import tree as train_tree  # noqa: E402
from repro_torch.train.data import SyntheticData  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptimizerConfig,
    make_optimizer,
)
from repro_torch.train.train_step import (  # noqa: E402
    build_train_step,
    make_train_state,
    train_state,
)
from repro_torch.serve.plan_service import set_plan_service  # noqa: E402
from repro_torch.serve.scheduler import Scheduler, ragged_trace  # noqa: E402

N, BLOCK = COMMODITY_N, COMMODITY_BLOCK
K_PANELS = N // BLOCK  # 128 K panels of width 256
SPARSE_FILL = 0.3
MAX_RANK = 64  # the rank-sparse case: r_pad 64, below r* = 128
FALLBACK_N, FALLBACK_RANK = 4096, 136  # r_pad 136 > r*: dense panels
SEED = 0
ROOT = Path(__file__).resolve().parent
#: [tuner]: abstract square grids the schedule tuner plans at N with
#: K_PANELS blocks
TUNER_GRIDS = (4, 16)
#: [autotune]: the square buckets tuned in fp32 and bf16, and the bucket a
#: main-path panel (N x 256) . (256 x N) looks up (clamped to 4096)
AUTOTUNE_SQUARES = (128, 256, 512)
AUTOTUNE_PANEL = (4096, BLOCK, 4096)
AUTOTUNE_N = 4096  # the dense product that consults the tuned cache
#: [nonuniform]: 256-wide K panels of the padded inner extent 47360
NONUNIFORM_K_BLOCKS = 185
#: [contract]: the coupled-cluster particle-particle ladder
#: R[ijcd] = sum_ab T[ijab] V[abcd] over o occupied and v virtual orbitals,
#: every mode blocked by LADDER_BLOCK; T's and V's block fills and seeds
LADDER_SPEC = "ijab,abcd->ijcd"
LADDER_O, LADDER_V, LADDER_BLOCK = 64, 192, 16
LADDER_FILLS, LADDER_SEEDS = (0.5, 0.3), (0, 1)
#: [contract]: the reference's contraction-oracle families
#: (tests/conftest.py::contract_case), their hold, and a chain
#: (A.B).C at CHAIN_N in blocks of CHAIN_BLOCK under decay masks
CONTRACT_FAMILIES = ("matmul", "free2", "multi_contracted", "transpose",
                     "batch", "rank_sparse", "rank_sparse_32", "nonuniform")
ORACLE_ATOL, ORACLE_RTOL = 5e-4, 1e-4
CHAIN_N, CHAIN_BLOCK, CHAIN_DECAY = 8192, 256, 0.5
#: [filter]: the reference's ``bench_filter`` workload (benchmarks/run.py)
#: at the commodity size: N x N fp32 operands in BLOCK blocks, each block
#: scaled by exp(-FILTER_DECAY |i - k|), norms from
#: ``core.sparsity.block_norms``, the sweep filter_eps = frac x pmax over
#: FILTER_FRACS.  The error is held to the plan's ``filter_bound`` plus
#: bench_filter's slack, 1e-5 ||C_exact||_F at its n = 1024, scaled by
#: sqrt(N / 1024) as the kernel holds scale their absolute part by
#: sqrt(K).  FILTER_TIMED_FRAC's bsmm call is timed for phase 7's table;
#: the filtered chain runs at CHAIN_N with FILTER_CHAIN_FRAC
FILTER_FRACS = (0.0, 1e-4, 1e-3, 1e-2, 5e-2)
FILTER_DECAY, FILTER_SLACK_AT_1024 = 0.8, 1e-5
FILTER_TIMED_FRAC, FILTER_CHAIN_FRAC = 1e-3, 1e-2
#: [auto forward]: llama3.2-1b at full width, depth cut to 2 layers
AUTO_LAYERS, AUTO_SEQ = 2, 4096
#: [25d]: the three axes of the multi-pod grid (replicas over the first)
AXES3 = ("pod", "data", "model")
#: [moe]: mixtral-8x7b at full width, 4 prompts of 4096 tokens, its depth
#: cut to MOE_LAYERS (32 layers of experts are 90 GB in bf16, more than
#: the card's 80 GB) and to MOE_HOLD_LAYERS for the hold against its fp32
#: twin (whose weights take twice the bf16 ones'); kimi-k2 at full width,
#: one layer (39 GB in bf16), one prompt of 4096 tokens
MOE_ARCH, MOE_LAYERS, MOE_HOLD_LAYERS = "mixtral-8x7b", 8, 2
MOE_BATCH, MOE_SEQ = 4, 4096
KIMI_ARCH, KIMI_LAYERS, KIMI_BATCH = "kimi-k2-1t-a32b", 1, 1
#: grouped_gemm launches of one MoE layer's expert GEMMs: gate, up, down
MOE_LAUNCHES_PER_LAYER = 3
#: [recurrent]: recurrentgemma-9b at full width and depth (38 layers,
#: 17.5 GiB in bf16) on 2 prompts of 4096 tokens (its tied 256000-wide
#: logits are 7.8 GiB in fp32); xlstm-1.3b at full width and depth (48
#: layers) on 4 x 4096, with the parallel and the chunkwise mLSTM
#: (chunk MLSTM_CHUNK); each held against an fp32 twin cut to one unit
#: of its block pattern; state continuation of each block kind over
#: REC_STATE_SEQ tokens, then REC_STEPS steps
RG_ARCH, RG_BATCH = "recurrentgemma-9b", 2
XL_ARCH, XL_BATCH, MLSTM_CHUNK = "xlstm-1.3b", 4, 256
REC_SEQ = 4096
REC_STATE_BATCH, REC_STATE_SEQ, REC_STEPS = 2, 256, 4
#: [frontends]: hubert-xlarge at full width and depth on 4 x 4096 frame
#: embeddings; qwen2-vl-72b at full width on 1 x 4096 positions (1024
#: patch embeddings, then 3072 tokens), its depth cut to VLM_LAYERS (80
#: layers are 135 GiB in bf16, more than the card holds) and to
#: VLM_HOLD_LAYERS for the hold against its fp32 twin
HUBERT_ARCH, HUBERT_BATCH = "hubert-xlarge", 4
VLM_ARCH, VLM_LAYERS, VLM_HOLD_LAYERS, VLM_BATCH = "qwen2-vl-72b", 16, 2, 1
FRONT_SEQ, VLM_PATCHES = 4096, 1024
#: one block in bf16 held at the reference's tolerance, 2e-2 x max|want|,
#: as the CPU tests hold the port's blocks (tests/test_torch_recurrent.py):
#: two routes of one block on one input, or a block's steps against its
#: fp32 sequence form
BF16_MAX_RTOL = 2e-2
#: the LM forward: full llama3.2-1b, train_4k's length and prefill_32k's
LM_ARCH = "llama3.2-1b"
LM_BATCH, LM_SEQ, LM_LONG_SEQ = 4, 4096, 32768
#: [serve]: the serving path through ``launch.serve.main`` and
#: ``serve.scheduler.Scheduler``, bf16, weights from init_model (seed 0):
#: llama3.2-1b at full width and depth, a fixed batch of SERVE_BATCH
#: prompts of SERVE_PROMPT tokens generating SERVE_GEN, and ``launch.serve``'s
#: ragged trace (4 x SERVE_BATCH requests of SERVE_PROMPT / 2 or
#: SERVE_PROMPT tokens, generating SERVE_GEN / 4 or SERVE_GEN) on
#: SERVE_BATCH slots; recurrentgemma-9b at full width and depth,
#: RG_SERVE_BATCH prompts of SERVE_PROMPT tokens generating RG_SERVE_GEN
#: (its window of 2048 makes prefill pack the ring, and decode wraps it).
#: The holds: a prefill then SERVE_HOLD_STEPS decode steps against the
#: forward of the whole sequence, on an fp32 twin cut to one unit
#: (SERVE_HOLD_LAYERS) at SERVE_HOLD_BATCH prompts, and at full depth in
#: bf16 on one prompt
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 64
RG_SERVE_BATCH, RG_SERVE_GEN = 2, 32
SERVE_HOLD_STEPS, SERVE_HOLD_BATCH = 8, 2
SERVE_HOLD_LAYERS = {LM_ARCH: 2, RG_ARCH: 3, MOE_ARCH: 1}
#: The bf16 engine at full depth against the bf16 forward of the same
#: weights (``hold_engine_depth``): max |difference| / max |logit|
ENGINE_PAIR_TOL = 0.25
#: [train]: llama3.2-1b's train step at full width and depth, bf16, AdamW,
#: chunked attention and remat, TRAIN_STEPS steps of TRAIN_BATCH x
#: TRAIN_SEQ tokens (train_4k's length) in TRAIN_MICRO microbatches; the
#: holds at full width cut to TRAIN_HOLD_LAYERS layers: microbatches 2
#: against 1 on TRAIN_HOLD_BATCH x TRAIN_SEQ (params within the
#: reference's 5e-2, tests/test_models.py:120; first moments within 5e-2
#: of each leaf's largest, a dropped microbatch outside it), summa against xla over TRAIN_HOLD_STEPS
#: steps (rtol 2e-2, tests/test_system.py:33); the chunked attention at
#: llama's call against the plain one at the reference's 2e-5 / 2e-4
#: (tests/test_perf_features.py); then launch.train's CLI with --smoke:
#: the loss falls over CLI_STEPS, a run killed at CLI_FAIL_AT of
#: CLI_RESUME_STEPS resumes losslessly
TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 4096, 3
#: [train] mixtral-8x7b: full width, MOE_TRAIN_LAYERS layers (AdamW's
#: fp32 master and moments of 2 layers' experts are 31 GiB beside their
#: 5.2 GiB of bf16 weights), MOE_TRAIN_BATCH x TRAIN_SEQ tokens a step in
#: MOE_TRAIN_MICRO microbatches, the printed peak under MOE_TRAIN_PEAK;
#: at MOE_TRAIN_HOLD_LAYERS against an fp32 twin (``hold_train_twin``):
#: the first update's moments and master changes per leaf, and each of
#: TRAIN_STEPS bf16 steps' losses against the twin's on the same weights
#: at [train]'s rtol
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_MICRO = 2, 2, 2
MOE_TRAIN_HOLD_LAYERS, MOE_TRAIN_PEAK = 1, 70 * 2**30
MOE_TWIN_MOMENT_HOLD, MOE_TWIN_CHANGE_HOLD = 0.15, 0.5
TRAIN_MICRO_BATCH = TRAIN_BATCH // TRAIN_MICRO
TRAIN_HOLD_LAYERS, TRAIN_HOLD_BATCH, TRAIN_HOLD_STEPS = 2, 4, 3
TRAIN_MB_HOLD, TRAIN_MB_M_HOLD, TRAIN_SUMMA_RTOL = 5e-2, 5e-2, 2e-2
CHUNKED_O_TOL, CHUNKED_GRAD_TOL = 2e-5, 2e-4
CLI_STEPS, CLI_RESUME_STEPS, CLI_FAIL_AT = 40, 24, 16
#: Tolerances of the whole forward (max |logit difference| / max |logit|,
#: and the least share of positions whose argmax agrees).  In fp32 the
#: kernel's forward (and the summa one) must equal the plain-attention
#: forward closely.  In bf16, rounding differences compound over 16
#: layers at this model's logit scale (max |logit| ~700) into ~5 % of max
#: |logit| and ~10 % of argmaxes between two forwards that differ only in
#: the order of an fp32 sum; so each bf16 forward is held against the
#: fp32 forward of the same weights, and must be no further from it than
#: the plain-attention bf16 forward is, within the stated margins.
LM_FP32_REL_TOL, LM_FP32_AGREE = 1e-3, 0.99
LM_BF16_REL_RATIO, LM_BF16_AGREE_DROP = 1.5, 0.03
#: Two bf16 forwards of the same weights that differ only in the order
#: of fp32 sums, held against each other: the kernel's against the plain
#: one's, and the summa one's against the xla one's.  Measured on an H100
#: 80GB HBM3 at 700 W: 4.85 % of max |logit| and 0.901 of argmaxes, and
#: 5.28 % and 0.889.
LM_BF16_PAIR_REL, LM_BF16_PAIR_AGREE = 0.08, 0.85
#: bf16 outputs held to their own scale (``hold_at_scale``): a kernel and
#: its plain version (flash_attention, grouped_gemm), or two routes of a
#: MoE layer or forward, both sum in fp32 and round once to bf16, so they
#: may differ by one bf16 ulp (at most 2**-7 of |want|) and by fp32 noise,
#: which the absolute term (a share of rms(want)) covers.  Two MoE
#: forwards whose *attention* differs in rounding also differ in routing:
#: a token whose k-th and (k+1)-th router logits lie within that rounding
#: goes to another expert (top-8 of 384 in kimi-k2), which moves its
#: output by a share of the whole layer; such a pair is held by its argmax
#: agreement (LM_BF16_PAIR_AGREE), and witness forwards with one kernel
#: each show which kernel the distance comes from.
BF16_ULP_RTOL, BF16_RMS_ATOL = 2.0 ** -7, 2e-2
#: published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet),
#: from the port's one source of them, ``analysis.cost.DEFAULT_HW``
PEAK_FP32_FLOPS = DEFAULT_HW.peak_fp32_flops
PEAK_BF16_FLOPS = DEFAULT_HW.peak_flops  # dense tensor cores
PEAK_HBM_BYTES_PER_S = DEFAULT_HW.hbm_bw
DTYPES = (torch.float32, torch.bfloat16)
DEVICE = "cuda"


def log(*args) -> None:
    print(*args, flush=True)


def tol(dtype) -> float:
    """The reference's kernel tolerance (tests/test_kernels.py::_tol)."""
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def compare(got, want, k: int, dtype, what: str) -> float:
    """Largest |got - want|; raises unless every element is finite and
    within ``atol = tol*sqrt(k)``, ``rtol = tol`` of ``want``."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    t = tol(dtype)
    err, worst, bad = 0.0, 0.0, 0
    for r in range(0, got.shape[0], 4096):  # row chunks bound the temporaries
        g, w = got[r:r + 4096].float(), want[r:r + 4096].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite values")
        diff = (g - w).abs()
        limit = t * math.sqrt(k) + t * w.abs()
        err = max(err, diff.max().item())
        worst = max(worst, (diff / limit).max().item())
        bad += (diff > limit).sum().item()
    log(f"  {what}: max_abs_err={err:.6g} (atol={t * math.sqrt(k):.4g}, "
        f"rtol={t}; worst element {worst:.4g} of the hold) -> "
        f"{'ok' if not bad else f'{bad} elements out of tolerance'}")
    if bad:
        raise AssertionError(f"{what}: {bad} elements out of tolerance")
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time in ms on the card, and what sets it."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def split_bound(flops: float, nbytes: float) -> tuple[float, str, str]:
    """The bound of a product on the split-bf16 engine: the function's
    ``flops`` at the bf16 tensor cores' peak against its bytes; and a text
    that also gives the split's own floor (three bf16 products) and the
    fp32-FMA bound of the earlier designs beside it."""
    bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    split_ms, _ = bound(3 * flops, nbytes, PEAK_BF16_FLOPS)
    fma_ms, _ = bound(flops, nbytes)
    text = (f"bound {bound_ms:.3f} ms ({by}: {nbytes:.4g} bytes at "
            f"{PEAK_HBM_BYTES_PER_S:.3g} B/s = "
            f"{nbytes / PEAK_HBM_BYTES_PER_S * 1e3:.4f} ms; {flops:.4g} FLOP "
            f"at {PEAK_BF16_FLOPS:.3g} FLOP/s = "
            f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms) [the split's floor "
            f"with its three bf16 products "
            f"({3 * flops / PEAK_BF16_FLOPS * 1e3:.4f} ms of them): "
            f"{split_ms:.3f} ms; fp32-FMA bound {fma_ms:.3f} ms]")
    return bound_ms, by, text


def tiled_flops(m: int, k: int, n: int) -> float:
    """The function ``tiled_matmul`` computes: 2·M·N·K FLOP."""
    return 2.0 * m * n * k


def bsmm_flops(live_blocks: int, bm: int, bk: int, n: int) -> float:
    """``bsmm``'s: each live block of A times its K panel of B, ``n``
    columns wide (a tile map's list: 256 columns)."""
    return 2.0 * live_blocks * bm * bk * n


def grouped_flops(t: int, d: int, f: int) -> float:
    """``grouped_gemm``'s: every tile of T rows times its expert's D x F."""
    return 2.0 * t * d * f


def attention_flops(b: int, h: int, dh: int, pairs: int) -> float:
    """Attention's two products over ``pairs`` (query, key) pairs a head."""
    return 4.0 * b * h * dh * pairs


def kron_mask(x: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """``x`` with its dead blocks zeroed through an element mask made by
    repeating each entry of the block mask over its block (``np.kron`` of
    the mask with a block of ones, built on the card): a mapping of blocks
    to elements that shares no code with the port's."""
    rb, cb = x.shape[0] // mask.shape[0], x.shape[1] // mask.shape[1]
    keep = torch.as_tensor(np.asarray(mask, bool), device=x.device)
    keep = keep.repeat_interleave(rb, 0).repeat_interleave(cb, 1)
    return x * keep


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------


def phase_device() -> tuple[str, int]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); the port's kernels run only on a card")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1 device] {kind} x{count}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda})")
    log(smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return kind, count


#: the bf16 flash-attention kernel's name in the built library
FA_TENSOR_CORE_KERNEL = "fa_wgmma_kernel"
#: the matmul kernels on split-bf16 wgmma, each with one instance per
#: (input, output) dtype pair
SPLIT_KERNELS = ("tiled_matmul_kernel", "bsmm_kernel", "grouped_gemm_kernel")
SPLIT_INSTANCES = 4


def _cuda_tool(name: str) -> str | None:
    """A CUDA binary tool, on PATH or under $CUDA_HOME/bin."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which(name) or shutil.which(
        name, path=os.path.join(cuda_home, "bin"))


def sass_census(lib: Path) -> dict[str, dict[str, int]]:
    """Per kernel of the built library, its count of ``HGMMA`` (wgmma) and
    ``HMMA`` (mma.sync) instructions, from ``cuobjdump -sass``."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found: the SASS of the kernels "
                           "cannot be read")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    census: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            census[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    census[name][op] += 1
    return census


def fa_wgmma_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of the bf16 attention kernel at head dim dh,
    as ``WgShape<DH>::kSmem`` in ``csrc/flash_attention.cu`` sizes it: Q's
    128 rows, 4/3/2 stages (Dh 64/128/256) of 64 K and 64 V rows, and 1 KB
    to align to the swizzle atom."""
    stages = {64: 4, 128: 3, 256: 2}[dh]
    return 128 * dh * 2 + 2 * stages * 64 * dh * 2 + 1024


def short_names(mangled: list[str]) -> dict[str, str]:
    """``kernel<args>`` of each mangled kernel name, through ``cu++filt``
    (the mangled name where it is missing)."""
    tool = _cuda_tool("cu++filt")
    if tool is None:
        return {m: m for m in mangled}
    out = subprocess.run([tool], input="\n".join(mangled), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return {m: d.replace("(anonymous namespace)::", "").replace("(int)", "")
            .split("(")[0].split("::")[-1] for m, d in zip(mangled, out)}


def phase_build() -> None:
    t0 = time.perf_counter()
    path, out, compile_s = _build.build()
    _build.load()
    log(f"[2 build] {path}: nvcc {compile_s:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s")
    entry = None
    for line in out.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("  " + line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and FA_TENSOR_CORE_KERNEL in entry and (
                "Used" in line or "spill" in line):
            dh = re.search(r"ILi(\d+)EE", entry).group(1)
            smem = fa_wgmma_smem_bytes(int(dh))
            log(f"  -> {FA_TENSOR_CORE_KERNEL} Dh={dh}: {line.strip()}"
                + (f"; dynamic shared memory {smem} bytes"
                   if "Used" in line else ""))
    census = sass_census(path)
    log("  SASS tensor-core instructions per kernel (HGMMA = wgmma, HMMA = "
        "mma.sync):")
    names = short_names(sorted(census))
    for name, ops in sorted(census.items()):
        log(f"    {names[name]}: HGMMA {ops['HGMMA']}, HMMA {ops['HMMA']}")
    fa = {n: ops for n, ops in census.items() if FA_TENSOR_CORE_KERNEL in n}
    if len(fa) != len(KERNEL_HEAD_DIMS) or any(
            ops["HGMMA"] == 0 for ops in fa.values()):
        raise AssertionError(
            f"the bf16 flash-attention kernel ({FA_TENSOR_CORE_KERNEL}, one "
            f"per Dh in {KERNEL_HEAD_DIMS}) must run on wgmma: found {fa}")
    for kernel in SPLIT_KERNELS:
        found = {names[n]: ops["HGMMA"] for n, ops in census.items()
                 if kernel in n}
        log(f"  {kernel}: HGMMA per instance {found}")
        if len(found) != SPLIT_INSTANCES or 0 in found.values():
            raise AssertionError(
                f"{kernel} (one instance per dtype pair) must run on wgmma "
                f"in every instance: found {found}")


def phase_kernels(sparse_plan, rank_plan, r_pad) -> dict:
    """Each kernel against its plain version; returns the main-shape fp32
    errors by kernel name."""
    log("[3 kernels vs plain versions]")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    for dtype in DTYPES:
        for m, k, n in ((64, 64, 64), (128, 256, 64), (96, 160, 224),
                        (100, 60, 36)):
            a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen)
            got = tiled_matmul_cuda(a, b)
            torch.cuda.synchronize()
            compare(got, tiled_matmul_plain(a, b), k, dtype,
                    f"tiled_matmul {dtype} ({m},{k})x({k},{n})")
        # the main path's panel: a (N, 256) column slice of an (N, N) shard
        a_full = randn((N, N), dtype, gen)
        a, b = a_full[:, BLOCK:2 * BLOCK], randn((BLOCK, N), dtype, gen)
        got = tiled_matmul_cuda(a, b)
        torch.cuda.synchronize()
        err = compare(got, tiled_matmul_plain(a, b), BLOCK, dtype,
                      f"tiled_matmul {dtype} main panel ({N},{BLOCK}; "
                      f"lda={a.stride(0)})x({BLOCK},{N})")
        if dtype == torch.float32:
            errs["tiled_matmul"] = err
        del a_full, a, b, got

        for fill in (0.1, 0.4, 1.0):
            for mb, kb in ((4, 8), (2, 2), (8, 4)):
                m, k, n = mb * 32, kb * 32, 96
                a, b = randn((m, k), dtype, gen), randn((k, n), dtype, gen)
                mask = random_block_mask(mb, kb, fill, seed=int(fill * 10) + mb)
                cols = _cols(mask)
                got = bsmm_cuda(a, b, cols, bm=32, bk=32, bn=32)
                torch.cuda.synchronize()
                compare(got, bsmm_plain(a, b, cols, bm=32, bk=32, bn=32), k,
                        dtype, f"bsmm {dtype} fill={fill} blocks=({mb},{kb})")
        mask = np.zeros((4, 4), dtype=bool)
        mask[0, 0] = True  # only one live block: rows 32.. must be zero
        a, b = randn((128, 128), dtype, gen), randn((128, 64), dtype, gen)
        got = bsmm_cuda(a, b, _cols(mask), bm=32, bk=32, bn=32)
        torch.cuda.synchronize()
        if not (torch.all(got[32:] == 0) and torch.any(got[:32] != 0)):
            raise AssertionError("bsmm: empty block rows must give zero")
        compare(got, bsmm_plain(a, b, _cols(mask), bm=32, bk=32, bn=32), 128,
                dtype, f"bsmm {dtype} empty rows")
        # the main path's call: gathered live panels, B's dead blocks
        # zeroed, and the executor's map (a tile map: B's mask kills some
        # products); then the same operands over A's map alone, the walk
        # of the callers without a B map
        a_g, b_g, cols, (bm, bk, bn) = _bsmm_operands(sparse_plan, dtype, gen)
        a_map = torch.as_tensor(sparse_plan.local_cols[0, 0], device=DEVICE)
        for walk, name in ((cols, "main"), (a_map, "A's map")):
            got = bsmm_cuda(a_g, b_g, walk, bm=bm, bk=bk, bn=bn)
            torch.cuda.synchronize()
            err = compare(got, bsmm_plain(a_g, b_g, walk, bm=bm, bk=bk, bn=bn),
                          a_g.shape[1], dtype,
                          f"bsmm {dtype} {name} ({N},{a_g.shape[1]}) blocks "
                          f"({bm},{bk}) map {tuple(walk.shape)}")
            if dtype == torch.float32 and name == "main":
                errs["bsmm"] = err
            del got
        del a_g, b_g
        torch.cuda.empty_cache()

        # the reference's shapes, tiles of 8 and 24 rows, a ragged F
        # and the main path's D with an uneven count of tiles per expert
        # (a block with one unit) and a ragged F
        for t, d, f, e, bt in ((256, 64, 96, 4, 64), (512, 128, 64, 8, 128),
                               (64, 32, 40, 3, 8), (72, 48, 100, 5, 24),
                               (960, 256, 300, 3, 64)):
            x, w = randn((t, d), dtype, gen), randn((e, d, f), dtype, gen)
            te = torch.randint(0, e, (t // bt,), generator=gen,
                               device=DEVICE, dtype=torch.int32).cpu()
            got = grouped_gemm_cuda(x, w, te, bt=bt)
            torch.cuda.synchronize()
            compare(got, grouped_gemm_plain(x, w, te, bt=bt), d, dtype,
                    f"grouped_gemm {dtype} T={t} D={d} F={f} E={e} bt={bt}")
        # one launch of the main path: a chunk of block rows' V tokens,
        # B's K-panels read in place as the experts
        x, w, te = _grouped_operands(rank_plan, r_pad, dtype, gen)
        got = grouped_gemm_cuda(x, w, te, bt=r_pad)
        torch.cuda.synchronize()
        err = compare(got, grouped_gemm_plain(x, w, te, bt=r_pad),
                      x.shape[1], dtype,
                      f"grouped_gemm {dtype} main T={x.shape[0]} "
                      f"D={x.shape[1]} F={w.shape[2]} E={w.shape[0]} "
                      f"bt={r_pad}")
        if dtype == torch.float32:
            errs["grouped_gemm"] = err
        del x, w, te, got
        torch.cuda.empty_cache()
    return errs


def _rank_chunks(plan, r_pad) -> tuple[int, int]:
    """(block rows per chunk, chunks) of the grouped rank route for
    ``plan`` on the 1x1 grid, from the byte budget the executor states."""
    live = len(plan.live_panels)
    mb = plan.a_ranks.shape[0]
    per_row = live * r_pad * plan.n_pad * 4
    rows = max(1, min(mb, RANK_CHUNK_BYTES // per_row))
    return rows, -(-mb // rows)


def _grouped_operands(plan, r_pad, dtype, gen, b=None):
    """Operands of one main-path ``grouped_gemm`` launch: V tokens of one
    chunk of block rows ordered (block row, panel, rank), the experts
    B (k_pad, n_pad) viewed (K panels, bk, n) and their tile map, on the
    host as the route gives it."""
    rows, _ = _rank_chunks(plan, r_pad)
    live = len(plan.live_panels)
    bk = plan.kb_width
    x = randn((rows * live * r_pad, bk), dtype, gen)
    if b is None:
        b = randn((plan.k_pad, plan.n_pad), dtype, gen)
    w = b.view(plan.k_steps, bk, plan.n_pad)
    te = np.tile(np.asarray(plan.live_panels, np.int32), rows)
    return x, w, te


def _cols(mask: np.ndarray) -> torch.Tensor:
    csr = block_csr_from_mask(mask)
    return torch.as_tensor(csr.padded_cols(max(csr.max_row_nnz, 1)),
                           dtype=torch.int32, device=DEVICE)


def cols_mask(cols: torch.Tensor, k_blocks: int) -> torch.Tensor:
    """The block mask (rows of blocks x ``k_blocks``) a CSR column map
    names (entries < 0 pad a row), built here."""
    mask = torch.zeros((cols.shape[0], k_blocks + 1), dtype=torch.bool,
                       device=cols.device)
    idx = torch.where(cols >= 0, cols.long(), k_blocks)
    mask.scatter_(1, idx, True)
    return mask[:, :k_blocks].float()


def _bsmm_operands(plan, dtype, gen, map_of=None):
    """Random operands of the shapes ``_exec_sparse_bsmm`` hands the kernel
    for ``plan`` on the 1x1 grid, B's dead blocks zeroed as the executor
    zeroes them, and the executor's map (``bsmm_walk``), or ``map_of``."""
    width = len(plan.live_panels) * plan.kb_width
    a_g = randn((plan.m_pad, width), dtype, gen)
    b_g = gathered_b_keep(plan, randn((width, plan.n_pad), dtype, gen))
    walk = bsmm_walk(plan)[0] if map_of is None else map_of
    return a_g, b_g, torch.as_tensor(walk, device=DEVICE), plan.local_block


def gathered_b_keep(plan, b_g: torch.Tensor) -> torch.Tensor:
    """``b_g``, B's live K panels gathered (rows of ``plan.live_panels``
    in order), with the blocks of ``plan.b_mask`` that are dead zeroed in
    place, row by gathered row (built here from the mask)."""
    if plan.b_mask is None:
        return b_g
    mask = np.asarray(plan.b_mask, bool)
    rb, cb = plan.k_pad // mask.shape[0], plan.n_pad // mask.shape[1]
    w = plan.kb_width
    rows = (np.repeat(np.asarray(plan.live_panels) * w, w)
            + np.tile(np.arange(w), len(plan.live_panels))) // rb
    for r in range(0, b_g.shape[0], 4096):  # row chunks bound the keep
        keep = torch.as_tensor(mask[rows[r:r + 4096]], device=b_g.device)
        b_g[r:r + 4096].mul_(keep.repeat_interleave(cb, 1)[:, :b_g.shape[1]])
    return b_g


def bsmm_walk(plan) -> tuple[np.ndarray, float, int]:
    """The map the executor hands ``bsmm`` for ``plan`` on the 1x1 grid
    (``core.summa._bsmm_walk``: A's CSR map, one list a block row, or
    where B's mask kills some of its products one list a block row and
    256-column tile), with the FLOP the kernel multiplies over it and the
    blocks of A it reads, both counted here from the map."""
    walk, _ = core_summa._bsmm_walk(plan, 0, 0, plan.n_pad)
    bm, bk, _ = plan.local_block
    k_blocks = len(plan.live_panels) * plan.kb_width // bk
    listed = np.where(np.logical_and.accumulate(walk >= 0, axis=-1), walk,
                      k_blocks)
    rows = listed.reshape(listed.shape[0], -1)
    seen = np.zeros((rows.shape[0], k_blocks + 1), bool)
    seen[np.arange(rows.shape[0])[:, None], rows] = True
    a_blocks = int(seen[:, :k_blocks].sum())
    if walk.ndim == 2:
        return walk, bsmm_flops(a_blocks, bm, bk, plan.n_pad), a_blocks
    per_tile = (listed < k_blocks).sum(axis=(0, 2))
    flops = sum(bsmm_flops(int(c), bm, bk,
                           min(TILE_COLS, plan.n_pad - t * TILE_COLS))
                for t, c in enumerate(per_tile))
    return walk, flops, a_blocks


COUNTERS = {"tiled_matmul": tiled_matmul_cuda, "bsmm": bsmm_cuda,
            "grouped_gemm": grouped_gemm_cuda,
            "flash_attention": flash_attention_cuda}


def run_path(mm, a, b, kernel_of_path, **masks):
    """One product through ``mm`` with every launch count set to 0 just
    before and read just after; returns (C, wall seconds, counts)."""
    counters = dict(COUNTERS)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = mm(a, b, **masks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    log(f"  launches {counts}; wall {wall:.3f} s")
    if kernel_of_path is not None and counts[kernel_of_path] == 0:
        raise AssertionError(f"the path never launched {kernel_of_path}")
    return c, wall, counts


def phase_dense(mm, a, b) -> tuple[int, float]:
    plan = mm.plan(N, N, N)
    log(f"[4 main path, dense] DistributedMatmul(taskbased, k_blocks="
        f"{K_PANELS}, local_matmul=pallas): k_steps={plan.k_steps}, "
        f"kb_width={plan.kb_width}, lookahead={plan.resolve_lookahead()}")
    c, wall, counts = run_path(mm, a, b, "tiled_matmul")
    if counts["tiled_matmul"] != plan.k_steps or plan.k_steps != K_PANELS:
        raise AssertionError(
            f"expected {K_PANELS} tiled_matmul launches, got {counts}"
        )
    if c.shape != (N, N) or c.dtype != torch.float32:
        raise AssertionError(f"dense C is {tuple(c.shape)} {c.dtype}")
    compare(c, torch.matmul(a, b), N, torch.float32,
            "dense C vs torch.matmul")
    return counts["tiled_matmul"], wall


def phase_sparse(mm, a, b, a_mask, b_mask) -> tuple[int, float]:
    plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    log(f"[5 main path, block-sparse fill {SPARSE_FILL}] local_impl="
        f"{plan.local_impl}, local_block={plan.local_block}, live panels "
        f"{len(plan.live_panels)}/{plan.k_steps}, fill_in="
        f"{plan.cost.fill_in:.4f}, S={plan.local_cols.shape[-1]}")
    if plan.local_impl != "bsmm":
        raise AssertionError(f"local_impl={plan.local_impl!r}, not 'bsmm'")
    c, wall, counts = run_path(mm, a, b, "bsmm", a_mask=a_mask, b_mask=b_mask)
    if counts["tiled_matmul"]:
        raise AssertionError("the bsmm route launched tiled_matmul")
    want = reference_blocksparse_matmul(a, b, a_mask, b_mask)
    compare(c, want, N, torch.float32,
            "block-sparse C vs reference_blocksparse_matmul")
    del want
    want = torch.matmul(kron_mask(a, a_mask), kron_mask(b, b_mask))
    compare(c, want, N, torch.float32,
            "block-sparse C vs torch.matmul of independently masked operands")
    return counts["bsmm"], wall


def expected_tiled_launches(plan) -> int:
    """``tiled_matmul`` launches of a dense plan's executor: one per K
    panel, or one for the all-gather schedule's single product."""
    return 1 if plan.cfg.strategy == "allgather" else plan.k_steps


def tuned_text(tuned: dict) -> str:
    keys = ("strategy", "k_blocks", "lookahead", "stationarity", "comm_mode",
            "makespan_s", "static_strategy", "static_makespan_s",
            "speedup_vs_static", "n_candidates")
    return ", ".join(f"{k}={tuned[k]}" for k in keys)


def phase_tuned(mm, a, b, a_mask, b_mask) -> dict:
    """[tuned] The commodity products with ``tune=True``: the schedule
    tuner's plan, executed through the kernels."""
    out = {}
    for name, masks, kernel in (
            ("dense", {}, "tiled_matmul"),
            (f"block-sparse fill {SPARSE_FILL}",
             dict(a_mask=a_mask, b_mask=b_mask), "bsmm")):
        t0 = time.perf_counter()
        plan = mm.plan(N, N, N, tune=True, **masks)
        tune_s = time.perf_counter() - t0
        log(f"[tuned] DistributedMatmul(taskbased, k_blocks={K_PANELS}, "
            f"local_matmul=pallas)(tune=True), {name}: local_impl="
            f"{plan.local_impl}, executed strategy {plan.cfg.strategy}, "
            f"k_steps {plan.k_steps}, lookahead {plan.resolve_lookahead()}; "
            f"tuned record: {tuned_text(plan.tuned)}; tuner host "
            f"{tune_s:.3f} s")
        c, wall, counts = run_path(mm, a, b, kernel, tune=True, **masks)
        if kernel == "tiled_matmul":
            want = expected_tiled_launches(plan)
            if counts["tiled_matmul"] != want or counts["bsmm"]:
                raise AssertionError(
                    f"expected {want} tiled_matmul launches (the tuned "
                    f"{plan.cfg.strategy} executor), got {counts}")
            ref = torch.matmul(a, b)
        else:
            if counts["bsmm"] != 1 or counts["tiled_matmul"]:
                raise AssertionError(
                    f"expected 1 bsmm and 0 tiled_matmul launches, got "
                    f"{counts}")
            ref = torch.matmul(kron_mask(a, a_mask), kron_mask(b, b_mask))
        compare(c, ref, N, torch.float32,
                f"tuned {name} C vs torch.matmul")
        del c, ref
        torch.cuda.empty_cache()
        out[name] = dict(wall=wall, tuned=plan.tuned,
                         launches=counts[kernel])
    if out["dense"]["tuned"]["strategy"] == "allgather":
        # the one product of the all-gather schedule, alone, beside
        # torch.matmul of the same operands
        ms = cuda_ms(lambda: tiled_matmul_cuda(a, b), 1)
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), 1)
        out["dense"]["kernel_ms"] = ms
        out["dense"]["library_ms"] = lib_ms
        log(f"  the tuned dense product's one tiled_matmul ({N}x{N})x({N}x"
            f"{N}) alone: {ms:.3f} ms, torch.matmul {lib_ms:.3f} ms (CUDA "
            f"events, one launch each after a warm-up)")
    return out


def phase_25d(a, b) -> dict:
    """[25d] 2.5D SUMMA on the 1x1x1 grid at the commodity size: one
    replica runs every K panel, so it launches what the 2-D route does
    and must equal its C bitwise; then tuple-axis SUMMA on the same
    grid."""
    kw = dict(strategy="taskbased", k_blocks=K_PANELS, local_matmul="pallas")
    grid3 = Grid.local(DEVICE, axis_names=AXES3)
    cfg2 = SummaConfig(grid=Grid.local(DEVICE), **kw)
    cfg25 = SummaConfig(grid=grid3, row_axis="data", col_axis="model", **kw)
    cfg_t = SummaConfig(grid=grid3, row_axis=("pod", "data"),
                        col_axis="model", **kw)
    log(f"[25d] summa_25d_matmul on the 1x1x1 grid {AXES3} (rep_axis "
        f"'pod'), N={N}, k_blocks={K_PANELS}, local_matmul=pallas, against "
        f"summa_matmul on the 1x1 grid")
    out = {}
    c2d, out["wall_2d"], _ = run_path(
        lambda a, b: summa_matmul(a, b, cfg2), a, b, "tiled_matmul")
    for key, call, what in (
            ("25d", lambda a, b: summa_25d_matmul(a, b, cfg25),
             "summa_25d_matmul"),
            ("tuple", lambda a, b: summa_matmul(a, b, cfg_t),
             "summa_matmul(row_axis=('pod', 'data'))")):
        c, out[f"wall_{key}"], counts = run_path(call, a, b, "tiled_matmul")
        if counts["tiled_matmul"] != K_PANELS:
            raise AssertionError(f"{what}: expected {K_PANELS} tiled_matmul "
                                 f"launches, got {counts}")
        out[f"launches_{key}"] = counts["tiled_matmul"]
        if not torch.equal(c, c2d):
            raise AssertionError(f"{what}: C differs from the 2-D route's")
        log(f"  {what}: C equals summa_matmul's on the 1x1 grid bitwise")
        if key == "25d":
            compare(c, torch.matmul(a, b), N, torch.float32,
                    f"{what} C vs torch.matmul")
        del c
        torch.cuda.empty_cache()
    log(f"  walls (host clock): 2-D {out['wall_2d']:.3f} s, 2.5D "
        f"{out['wall_25d']:.3f} s, tuple-axis {out['wall_tuple']:.3f} s")
    return out


def phase_tuner() -> None:
    """[tuner] ``tune_plan`` on abstract grids, on the host, and the
    scheduler's command line."""
    tilings = [nonuniform_tiling(N, N // BLOCK, seed=SEED + s)
               for s in range(3)]
    shapes = {"uniform": (N, N, N),
              "nonuniform": tuple(bucketize(t, BLOCK).padded_extent
                                  for t in tilings)}
    log(f"[tuner] tune_plan over abstract grids (host only), N={N}, "
        f"k_blocks={K_PANELS}; nonuniform = the bucketized extents "
        f"{shapes['nonuniform']} of nonuniform_tiling(N, {N // BLOCK}) at "
        f"tile {BLOCK}")
    for g in TUNER_GRIDS:
        for name, shape in shapes.items():
            cfg = abstract_summa_config(g, g, strategy="taskbased",
                                        k_blocks=K_PANELS)
            t0 = time.perf_counter()
            plan = tune_plan(plan_matmul(*shape, cfg))
            host_s = time.perf_counter() - t0
            t = plan.tuned
            log(f"  {g}x{g} {name}: {tuned_text(t)}; tuner host "
                f"{host_s:.3f} s")
            if t["makespan_s"] > t["static_makespan_s"] * (1 + 1e-9):
                raise AssertionError(f"{g}x{g} {name}: tuned worse than static")
    cmd = [sys.executable, "-m", "repro_torch.sched", "--grid", "4", "4",
           "--extent", str(N), "--blocks", str(K_PANELS), "--nonuniform"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600, check=True)
    cli = json.loads(proc.stdout)
    log(f"  python -m repro_torch.sched {' '.join(cmd[3:])}: "
        f"{time.perf_counter() - t0:.2f} s; sim {cli['sim']}; tasks "
        f"{cli['tasks']}")
    if not cli["sim"]["makespan_s"] > 0:
        raise AssertionError("the scheduler's command line gave no makespan")


def phase_autotune(repeats: int = 5) -> KernelAutotuner:
    """[autotune] A fresh ``KernelAutotuner`` times every route on the
    card; its file round-trips; a dense product consults it."""
    log(f"[autotune] KernelAutotuner.tune on the card: square buckets "
        f"{AUTOTUNE_SQUARES} in fp32 and bf16, and the panel bucket "
        f"{AUTOTUNE_PANEL} in fp32; best of {repeats} after a warm call")
    tuner = KernelAutotuner()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for c in AUTOTUNE_SQUARES:
        for dtype in DTYPES:
            tuner.tune(c, c, c, dtype=dtype, repeats=repeats, device=DEVICE)
    tuner.tune(*AUTOTUNE_PANEL, dtype=torch.float32, repeats=repeats,
               device=DEVICE)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    log(f"  tuning took {time.perf_counter() - t0:.2f} s; launches {counts}")
    for key, entry in tuner.table.items():
        times = ", ".join(f"{r} {t * 1e6:.2f}"
                          for r, t in entry["times_s"].items())
        log(f"  bucket {key}: winner {entry['winner']}; us: {times}; "
            f"tiles {entry['tiles']}")
    for name in ("tiled_matmul", "bsmm", "grouped_gemm"):
        if counts[name] == 0:
            raise AssertionError(f"the autotuner never launched {name}")
    path = ROOT / "build" / "chip_smoke_autotune.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    tuner.save(str(path))
    back = KernelAutotuner()
    n = back.load(str(path))
    fp = tuner.fingerprint()
    kind = torch.cuda.get_device_name(0)
    if (n != len(tuner.table) or back.table != tuner.table
            or back.fingerprint() != fp or tuner.fingerprint() != fp
            or not fp or back.device_kind != kind
            or tuner.device_kind != kind):
        raise AssertionError("the autotune cache did not round-trip")
    log(f"  save/load round-trip of {n} entries ({path.name}); fingerprint "
        f"{fp} stable; measured on {back.device_kind}")
    set_autotune_cache(tuner)
    try:
        winner = tuner.winner(AUTOTUNE_N, BLOCK, AUTOTUNE_N, device=DEVICE)
        mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                               k_blocks=AUTOTUNE_N // BLOCK,
                               local_matmul="pallas")
        plan = mm.plan(AUTOTUNE_N, AUTOTUNE_N, AUTOTUNE_N)
        want = 0 if winner == "xla" else plan.k_steps
        log(f"  with the cache installed: N={AUTOTUNE_N}, {plan.k_steps} "
            f"panels ({AUTOTUNE_N}x{BLOCK})x({BLOCK}x{AUTOTUNE_N}), whose "
            f"bucket's winner is {winner}: expect {want} tiled_matmul "
            f"launches")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        a = randn((AUTOTUNE_N, AUTOTUNE_N), torch.float32, gen)
        b = randn((AUTOTUNE_N, AUTOTUNE_N), torch.float32, gen)
        c, _, counts = run_path(mm, a, b, "tiled_matmul" if want else None)
        if counts["tiled_matmul"] != want:
            raise AssertionError(
                f"_local_dot took the wrong route: {counts}, want {want}")
        compare(c, torch.matmul(a, b), AUTOTUNE_N, torch.float32,
                "dense C on the autotuned route vs torch.matmul")
    finally:
        set_autotune_cache(None)
    return tuner


def fastest_square_bucket(tuner, max_block: int) -> tuple[int, dict]:
    """The tile ``tile="auto"`` should take, read off the table itself:
    the fp32 square bucket (c, c, c) of ``AUTOTUNE_SQUARES`` whose
    winner's time per FLOP is least, among those no wider than
    ``max_block`` rounded up to a power of two (256 if none was tuned).
    Returns it and each candidate's seconds per c**3."""
    cap = 1 << (max_block - 1).bit_length()
    per_flop = {}
    for c in AUTOTUNE_SQUARES:
        entry = tuner.table.get((c, c, c, 0, "float32"))
        if c <= cap and entry:
            per_flop[c] = entry["times_s"][entry["winner"]] / c ** 3
    return (min(per_flop, key=per_flop.get) if per_flop else 256), per_flop


def phase_nonuniform(tuner) -> dict:
    """[nonuniform] The paper's commodity nonuniform product through
    ``NonuniformMatmul`` (tile 256, tuned), then ``tile="auto"`` at
    ``nonuniform_medium`` with the autotune cache."""
    t0 = time.perf_counter()
    tilings, a_h, b_h = make_nonuniform_case(N, BLOCK, seed=SEED)
    log(f"[nonuniform] make_nonuniform_case({N}, {BLOCK}, seed={SEED}) on the "
        f"host: {time.perf_counter() - t0:.1f} s; logical blocks "
        f"{[t.num_blocks for t in tilings]}, largest "
        f"{[max(t.sizes) for t in tilings]}, smallest "
        f"{[min(t.sizes) for t in tilings]}")
    a = torch.from_numpy(a_h).to(DEVICE)
    b = torch.from_numpy(b_h).to(DEVICE)
    del a_h, b_h
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           k_blocks=NONUNIFORM_K_BLOCKS, local_matmul="pallas")
    nm = NonuniformMatmul(mm, *tilings, tile=BLOCK)
    extents = (nm.row_b.padded_extent, nm.inner_b.padded_extent,
               nm.col_b.padded_extent)
    work = math.prod(extents) / N ** 3
    t0 = time.perf_counter()
    plan = nm.plan(tune=True)
    tune_s = time.perf_counter() - t0
    want = expected_tiled_launches(plan)
    log(f"  NonuniformMatmul(tile={BLOCK}, k_blocks={NONUNIFORM_K_BLOCKS}, "
        f"local_matmul=pallas, tune=True): padded extents {extents} "
        f"({work:.4f} x the compact product's FLOP); padding_waste "
        f"{nm.padding_waste}; executed strategy {plan.cfg.strategy}, "
        f"k_steps {plan.k_steps}; tuned record: {tuned_text(plan.tuned)}; "
        f"tuner host {tune_s:.3f} s; expect {want} tiled_matmul launches")
    out = dict(extents=extents, work=work, waste=nm.padding_waste,
               tuned=plan.tuned, launches=want)
    resident = torch.cuda.memory_allocated()
    for key in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        c, out[key + "_wall"], counts = run_path(nm, a, b, "tiled_matmul",
                                                 tune=True)
        out[key + "_peak"] = torch.cuda.max_memory_allocated()
        if counts["tiled_matmul"] != want or counts["bsmm"]:
            raise AssertionError(
                f"expected {want} tiled_matmul launches, got {counts}")
        log(f"  {key} call: peak device memory "
            f"{out[key + '_peak'] / 2**30:.2f} GiB ({resident / 2**30:.2f} "
            f"GiB resident before the call)")
        if key == "cold":
            if c.shape != (N, N) or c.dtype != torch.float32:
                raise AssertionError(f"nonuniform C is {tuple(c.shape)} "
                                     f"{c.dtype}")
            ref = torch.matmul(a, b)
            out["err"] = compare(c, ref, N, torch.float32,
                                 "nonuniform C vs torch.matmul of the "
                                 "compact operands")
            del ref
        del c
        torch.cuda.empty_cache()
    # the gathers into and out of the padded layout, alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_p = nm._expand(nm._expand(a, nm.row_b, 0), nm.inner_b, 1)
    b_p = nm._expand(nm._expand(b, nm.inner_b, 0), nm.col_b, 1)
    torch.cuda.synchronize()
    out["expand_s"] = time.perf_counter() - t0
    if plan.cfg.strategy == "allgather":  # its one product, alone
        out["kernel_ms"] = cuda_ms(lambda: tiled_matmul_cuda(a_p, b_p), 1)
        out["library_ms"] = cuda_ms(lambda: torch.matmul(a_p, b_p), 1)
        log(f"  the one tiled_matmul ({extents[0]}x{extents[1]})x"
            f"({extents[1]}x{extents[2]}) alone: {out['kernel_ms']:.3f} ms, "
            f"torch.matmul {out['library_ms']:.3f} ms (CUDA events, one "
            f"launch each after a warm-up)")
    del a, b, a_p, b_p
    c_p = torch.zeros((extents[0], extents[2]), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = nm._compact(c_p)
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    del c, c_p
    torch.cuda.empty_cache()
    log(f"  the gathers alone: expand A and B {out['expand_s']:.3f} s, "
        f"compact C {out['compact_s']:.3f} s (of the warm "
        f"{out['warm_wall']:.3f} s)")
    # tile="auto" on the autotune cache, at nonuniform_medium
    cfg = BENCH_CONFIGS["nonuniform_medium"]
    tilings, a_h, b_h = make_nonuniform_case(cfg.n, cfg.block, seed=cfg.seed)
    max_block = max(max(t.sizes) for t in tilings)
    want_tile, per_flop = fastest_square_bucket(tuner, max_block)
    set_autotune_cache(tuner)
    try:
        nm = NonuniformMatmul(
            DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                              local_matmul="pallas"),
            *tilings, tile="auto")
        log(f"  nonuniform_medium (N={cfg.n}), tile='auto' on the autotune "
            f"cache: largest block {max_block}; fp32 square buckets, "
            f"winner's s per FLOP {per_flop}: expect tile {want_tile}; "
            f"NonuniformMatmul took {nm.tile}; padding_waste "
            f"{nm.padding_waste}")
        if nm.tile != want_tile:
            raise AssertionError(f"tile {nm.tile} != expected {want_tile}")
        # K panels BLOCK wide where the tile allows, so that they look up
        # the tuned panel bucket AUTOTUNE_PANEL
        width = BLOCK if nm.tile % BLOCK == 0 else nm.tile
        nm.mm = DistributedMatmul(
            Grid.local(DEVICE), strategy="taskbased",
            k_blocks=nm.inner_b.padded_extent // width,
            local_matmul="pallas")
        plan = nm.plan()
        (mp, kp), (_, np_) = plan.padded_shapes
        key = (mp, plan.kb_width, np_)
        entry = tuner.table.get(bucket_key(*key, dtype=torch.float32))
        winner = entry["winner"] if entry else None
        want = 0 if winner == "xla" else plan.k_steps
        log(f"  its {plan.k_steps} panels {key} fall in bucket "
            f"{bucket_key(*key, dtype=torch.float32)}, whose winner is "
            f"{winner}: expect {want} tiled_matmul launches")
        a = torch.from_numpy(a_h).to(DEVICE)
        b = torch.from_numpy(b_h).to(DEVICE)
        c, _, counts = run_path(nm, a, b, "tiled_matmul" if want else None)
        if counts["tiled_matmul"] != want:
            raise AssertionError(
                f"_local_dot took the wrong route: {counts}, want {want}")
        compare(c, torch.matmul(a, b), cfg.n, torch.float32,
                "nonuniform_medium C (tile='auto') vs torch.matmul")
        out["auto_tile"] = nm.tile
        del a, b, c
    finally:
        set_autotune_cache(None)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [contract] the block-sparse tensor front-end
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def executed_plans():
    """Records every plan ``core.summa.execute_plan`` runs meanwhile."""
    seen, real = [], core_summa.execute_plan

    def spy(a, b, plan, **kw):
        seen.append(plan)
        return real(a, b, plan, **kw)

    core_summa.execute_plan = spy
    try:
        yield seen
    finally:
        core_summa.execute_plan = real


def run_counted(fn, kernel):
    """``fn()`` with every launch count set to 0 just before and read just
    after; raises unless ``kernel`` launched.  Returns (out, wall, counts)."""
    for k in COUNTERS.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in COUNTERS.items()}
    log(f"    launches {counts}; wall {wall:.4f} s")
    if counts[kernel] == 0:
        raise AssertionError(f"the path never launched {kernel}")
    return out, wall, counts


def expand_here(mask: np.ndarray, tilings, device) -> torch.Tensor:
    """A block mask repeated over each block's elements, on ``device``: a
    mapping of blocks to elements that shares no code with the port's."""
    keep = torch.as_tensor(np.asarray(mask, bool), device=device)
    for axis, t in enumerate(tilings):
        keep = keep.repeat_interleave(
            torch.as_tensor(t.sizes, device=device), dim=axis)
    return keep


def dense_here(t: BlockSparseTensor) -> np.ndarray:
    """float64 numpy of ``t`` with its dead blocks zeroed (a factor payload
    densified block by block from U and V), built here."""
    if t.rank_csr is not None:
        r = t.rank_csr
        out = np.zeros(t.shape)
        rows = np.repeat(np.arange(r.csr.m_blocks), np.diff(r.csr.row_ptr))
        for s, (i, j) in enumerate(zip(rows, r.csr.col_idx)):
            out[i * r.bm:(i + 1) * r.bm, j * r.bk:(j + 1) * r.bk] = (
                r.u[s].astype(np.float64) @ r.v[s])
        return out
    data = t.data.double().cpu().numpy()
    if t.mask is None:
        return data
    return data * expand_here(t.mask, t.tilings, "cpu").numpy()


def hold_oracle(got: torch.Tensor, want: np.ndarray, what: str) -> float:
    """The contraction oracle's hold: |got - want| <= ORACLE_ATOL +
    ORACLE_RTOL |want| everywhere, values finite."""
    g = got.double().cpu().numpy()
    if g.shape != want.shape or not np.isfinite(g).all():
        raise AssertionError(f"{what}: shape {g.shape} (want {want.shape}) "
                             "or non-finite values")
    err = np.abs(g - want)
    worst = float((err / (ORACLE_ATOL + ORACLE_RTOL * np.abs(want))).max())
    log(f"    {what}: max_abs_err={err.max():.4g} (atol={ORACLE_ATOL}, "
        f"rtol={ORACLE_RTOL}; worst element {worst:.4g} of the hold) -> "
        f"{'ok' if worst <= 1 else 'OUT OF TOLERANCE'}")
    if worst > 1:
        raise AssertionError(f"{what}: out of tolerance")
    return float(err.max())


def plan_kernel(plan, r_pad=None) -> str:
    """The kernel ``execute_plan``/``execute_rank_plan`` launches for a
    plan with ``local_matmul="pallas"`` on one card."""
    if plan.local_impl == "bsmm":
        return "bsmm"
    if plan.local_impl == "ranksparse" and r_pad is not None:
        bm = plan.m_pad // plan.a_ranks.shape[0]
        if rank_panel_factored_comm(r_pad, bm, plan.kb_width):
            return "grouped_gemm"
    return "tiled_matmul"  # dense panels: dense, masked DAG, densified rank


def hold_plan_kernel(plan, r_pad, what: str, gen) -> str:
    """The kernel a plan launches, at the plan's shapes on the card, held
    against its plain version (fp32); returns its name."""
    kernel = plan_kernel(plan, r_pad)
    if kernel == "bsmm":
        a, b, cols, (bm, bk, bn) = _bsmm_operands(plan, torch.float32, gen)
        got = bsmm_cuda(a, b, cols, bm=bm, bk=bk, bn=bn)
        torch.cuda.synchronize()
        compare(got, bsmm_plain(a, b, cols, bm=bm, bk=bk, bn=bn), a.shape[1],
                torch.float32, f"{what}: bsmm ({plan.m_pad},{a.shape[1]})x"
                f"({a.shape[1]},{plan.n_pad}) blocks ({bm},{bk}) "
                f"map {tuple(cols.shape)} vs plain")
    elif kernel == "grouped_gemm":
        x, w, te = _grouped_operands(plan, r_pad, torch.float32, gen)
        got = grouped_gemm_cuda(x, w, te, bt=r_pad)
        torch.cuda.synchronize()
        compare(got, grouped_gemm_plain(x, w, te, bt=r_pad), x.shape[1],
                torch.float32, f"{what}: grouped_gemm T={x.shape[0]} "
                f"D={x.shape[1]} F={w.shape[2]} E={w.shape[0]} bt={r_pad} "
                "vs plain")
    else:  # one K panel of A (a column slice) times one of B
        a_full = randn((plan.m_pad, plan.k_pad), torch.float32, gen)
        a = a_full[:, :plan.kb_width]
        b = randn((plan.kb_width, plan.n_pad), torch.float32, gen)
        got = tiled_matmul_cuda(a, b)
        torch.cuda.synchronize()
        compare(got, tiled_matmul_plain(a, b), plan.kb_width, torch.float32,
                f"{what}: tiled_matmul ({plan.m_pad},{plan.kb_width}; "
                f"lda={a.stride(0)})x({plan.kb_width},{plan.n_pad}) vs plain")
    return kernel


def ladder_operands(gen):
    """T (o, o, v, v) and V (v, v, v, v) on the card, every mode in blocks
    of LADDER_BLOCK, with random 4-D block masks (numpy, seeded)."""
    o, v, blk = LADDER_O, LADDER_V, LADDER_BLOCK
    out = []
    for shape, fill, seed in zip(((o, o, v, v), (v, v, v, v)), LADDER_FILLS,
                                 LADDER_SEEDS):
        mask = np.random.default_rng(seed).random(
            tuple(d // blk for d in shape)) < fill
        out.append(BlockSparseTensor(
            data=torch.randn(shape, generator=gen, device=DEVICE),
            tilings=tuple(uniform_tiling(d, blk) for d in shape), mask=mask))
    return out


def phase_contract_ladder() -> dict:
    """[contract] The particle-particle ladder through
    ``DistributedMatmul.contract``: one ``bsmm`` on the 1x1 grid."""
    o, v, blk = LADDER_O, LADDER_V, LADDER_BLOCK
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    x, y = ladder_operands(gen)
    spec = parse_contraction(LADDER_SPEC)
    t0 = time.perf_counter()
    geom = _step_geometry(spec, x, y, 64)
    geom_s = time.perf_counter() - t0
    m, k = geom.x_geom.row_tiling.extent, geom.x_geom.col_tiling.extent
    n = geom.y_geom.col_tiling.extent
    log(f"[contract] ladder {LADDER_SPEC}: o={o}, v={v}, blocks {blk}; T "
        f"{tuple(x.shape)} block fill {x.block_mask.mean():.4f}, V "
        f"{tuple(y.shape)} ({y.data.numel() * 4 / 1e9:.2f} GB fp32) block "
        f"fill {y.block_mask.mean():.4f}; matricized ({m}x{k})x({k}x{n}) in "
        f"merged blocks of {geom.x_geom.row_tiling.sizes[0]}, dense FLOP "
        f"{2.0 * m * k * n:.4g}; geometry (uncached) on the host "
        f"{geom_s:.4f} s")
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           local_matmul="pallas")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log("  cold call:")
    r, cold, counts = run_counted(lambda: mm.contract(LADDER_SPEC, x, y),
                                  "bsmm")
    peak = torch.cuda.max_memory_allocated()
    (plan,) = mm._plan_cache.values()
    log(f"    plan: local_impl {plan.local_impl}, local_block "
        f"{plan.local_block}, live panels {len(plan.live_panels)}/"
        f"{plan.k_steps}, fill_in {plan.cost.fill_in:.4f}, useful FLOP "
        f"{plan.cost.flops_sparse:.4g}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident)")
    if (plan.local_impl != "bsmm" or counts["bsmm"] != 1
            or counts["tiled_matmul"] or counts["grouped_gemm"]):
        raise AssertionError(f"expected one bsmm launch, got {counts}")
    if tuple(r.data.shape) != (o, o, v, v) or r.data.dtype != torch.float32:
        raise AssertionError(f"R is {tuple(r.data.shape)} {r.data.dtype}")
    product = (x.mask.reshape(o * o // blk ** 2, -1).astype(np.int64)
               @ y.mask.reshape(v * v // blk ** 2, -1).astype(np.int64)) > 0
    if r.mask is None or not np.array_equal(r.mask,
                                            product.reshape(r.mask.shape)):
        raise AssertionError("the inferred mask of R is not the boolean "
                             "block product of T's and V's masks")
    log(f"    inferred mask of R = the boolean block product (fill "
        f"{r.mask.mean():.4f}) -> ok")
    log("  warm call:")
    r2, warm, _ = run_counted(lambda: mm.contract(LADDER_SPEC, x, y), "bsmm")
    stats = mm.cache_stats()
    c = stats["contract"]
    log(f"    cache_stats: {stats}")
    if c["step_hits"] != 1 or c["step_retraces"] != c["step_misses"]:
        raise AssertionError(f"a second call must hit its step program: {c}")
    del r2
    log("  compiled=False:")
    eager = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                              local_matmul="pallas", compiled=False)
    r_e, eager_wall, _ = run_counted(
        lambda: eager.contract(LADDER_SPEC, x, y), "bsmm")
    if not torch.equal(r_e.data, r.data):
        raise AssertionError("compiled and eager ladders differ")
    log("    eager R == compiled R bitwise -> ok")
    del r_e
    torch.cuda.empty_cache()

    # the kernel at the ladder's call, against its plain version, and alone
    hold_plan_kernel(plan, None, "ladder", gen)
    a_g, b_g, cols, (bm, bk, bn) = _bsmm_operands(plan, torch.float32, gen)
    _, flops, live_blocks = bsmm_walk(plan)
    nbytes = 4.0 * (live_blocks * bm * bk + b_g.numel() + m * n)
    bsmm_ms = cuda_ms(lambda: bsmm_cuda(a_g, b_g, cols, bm=bm, bk=bk, bn=bn),
                      3)
    # the library call: torch.matmul of A with its dead blocks zeroed here
    # (from A's CSR map) times the same B
    a_cols = torch.as_tensor(plan.local_cols[0, 0], device=DEVICE)
    a_z = a_g * cols_mask(a_cols, a_g.shape[1] // bk).repeat_interleave(
        bm, 0).repeat_interleave(bk, 1)
    lib_ms = cuda_ms(lambda: torch.matmul(a_z, b_g), 3)
    bound_ms, by, bound_text = split_bound(flops, nbytes)
    log(f"  bsmm at the ladder's call ({m},{a_g.shape[1]})x({a_g.shape[1]},"
        f"{n}), {live_blocks} live blocks, map {tuple(cols.shape)}: "
        f"{bsmm_ms:.3f} ms "
        f"({flops / bsmm_ms / 1e9:.2f} TFLOP/s of fp32 work), torch.matmul "
        f"(dense, masked operands) {lib_ms:.3f} ms, {bound_text}")
    del a_g, b_g, a_z

    # where the warm wall goes: each data step of the call, alone
    parts = {}
    a2 = geom.x_geom.matricize(x.data)
    b2 = geom.y_geom.matricize(y.data)
    parts["matricize T and V"] = cuda_ms(
        lambda: (geom.x_geom.matricize(x.data), geom.y_geom.matricize(y.data)),
        1)
    parts["mask A and B"] = cuda_ms(
        lambda: (core_summa._apply_block_mask(a2, plan.a_mask),
                 core_summa._apply_block_mask(b2, plan.b_mask)), 1)
    w = plan.kb_width
    idx = torch.cat([torch.arange(kk * w, (kk + 1) * w, device=DEVICE)
                     for kk in plan.live_panels])
    parts["gather live panels"] = cuda_ms(
        lambda: (a2[:, idx].contiguous(), b2[idx].contiguous()), 1)
    del a2, b2
    torch.cuda.empty_cache()
    parts["bsmm"] = bsmm_ms
    c2 = r.data.reshape(m, n)
    parts["un-matricize R"] = cuda_ms(
        lambda: _unmatricize_step(c2, geom, (o, o), (v, v)).contiguous(), 1)
    log(f"  the warm call's parts alone (CUDA events, ms): "
        + ", ".join(f"{k} {t:.3f}" for k, t in parts.items())
        + f"; geometry on the host {geom_s * 1e3:.3f} (cached in a warm "
        f"call); warm wall {warm * 1e3:.3f}")

    # R against a product of operands masked and laid out here
    tm = x.data * expand_here(x.mask, x.tilings, DEVICE)
    vm = y.data * expand_here(y.mask, y.tilings, DEVICE)
    want = torch.matmul(tm.reshape(o * o, v * v), vm.reshape(v * v, v * v))
    del tm, vm
    err = compare(r.data.reshape(o * o, v * v), want, v * v, torch.float32,
                  "ladder R vs torch.matmul of T and V masked here")
    del want, r, x, y
    torch.cuda.empty_cache()
    return dict(cold=cold, warm=warm, eager=eager_wall, peak=peak,
                resident=resident, geom_s=geom_s, parts=parts, err=err,
                bsmm_ms=bsmm_ms, bound_ms=bound_ms, flops=flops,
                live_panels=len(plan.live_panels), k_steps=plan.k_steps)


def family_case(name: str, seed: int):
    """One contraction family of the reference's oracle
    (``tests/conftest.py::contract_case``) at its shapes, built here:
    (spec, x, y, tile).  ``rank_sparse_32`` is ``rank_sparse`` in blocks of
    32, where the factor width (r_pad 8) is below the crossover r* = 16,
    so its panels stay factored."""
    rng = np.random.default_rng(seed)

    def dense(shape, block_shape, mask=None):
        data = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return BlockSparseTensor.from_dense(
            data.to(DEVICE), block_shape=block_shape, mask=mask)

    tile = 64
    if name == "matmul":
        spec = "ab,bc->ac"
        x = dense((64, 96), (16, 12), mask=banded_block_mask(4, 8, 2))
        y = dense((96, 80), (12, 20), mask=rng.random((8, 4)) < 0.6)
    elif name == "free2":
        spec = "abc,cd->abd"
        x = dense((8, 16, 96), (4, 8, 12), mask=rng.random((2, 2, 8)) < 0.6)
        y = dense((96, 80), (12, 20), mask=rng.random((8, 4)) < 0.7)
    elif name == "multi_contracted":
        spec = "abc,bcd->ad"
        x = dense((64, 8, 24), (16, 4, 6), mask=rng.random((4, 2, 4)) < 0.7)
        y = dense((8, 24, 40), (4, 6, 20))
    elif name == "transpose":
        spec = "ab,ca->cb"
        x = dense((64, 48), (16, 12), mask=rng.random((4, 4)) < 0.7)
        y = dense((40, 64), (20, 16), mask=rng.random((2, 4)) < 0.7)
    elif name == "batch":
        spec = "sab,sbc->sac"
        x = dense((4, 16, 24), (2, 8, 6), mask=rng.random((2, 2, 4)) < 0.6)
        y = dense((4, 24, 32), (2, 6, 8))
    elif name in ("rank_sparse", "rank_sparse_32"):
        spec = "ab,bc->ac"
        b = 16 if name == "rank_sparse" else 32
        bk = 12 if name == "rank_sparse" else 32
        rank_map = decay_rank_map(4, 8, b, bk, max_rank=4 * (b // 16),
                                  decay=0.6)
        x = BlockSparseTensor.from_rank_csr(
            synthesize_rank_csr(rank_map, seed=seed + 3))
        y = dense((8 * bk, 80), (bk, 20), mask=rng.random((8, 4)) < 0.7)
    elif name == "nonuniform":
        spec = "ab,bc->ac"
        rt = nonuniform_tiling(70, 5, seed=seed + 1)
        it = nonuniform_tiling(90, 6, seed=seed + 2)
        ct = nonuniform_tiling(60, 4, seed=seed + 3)
        x = BlockSparseTensor(
            data=torch.from_numpy(
                rng.normal(size=(70, 90)).astype(np.float32)).to(DEVICE),
            tilings=(rt, it), mask=rng.random((5, 6)) < 0.7)
        y = BlockSparseTensor(
            data=torch.from_numpy(
                rng.normal(size=(90, 60)).astype(np.float32)).to(DEVICE),
            tilings=(it, ct))
        tile = 16
    else:
        raise ValueError(f"unknown contraction family {name!r}")
    return spec, x, y, tile


def phase_contract_families() -> dict:
    """[contract] The oracle's families at their shapes: each kernel a
    family's plans launch held against its plain version at the plan's
    shapes, then C against the float64 einsum and against the eager
    route bitwise."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    out = {}
    for name in CONTRACT_FAMILIES:
        spec, x, y, tile = family_case(name, seed=SEED + 11)
        r_pad = x.rank_csr.r_pad if x.rank_csr is not None else None
        mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                               local_matmul="pallas")
        log(f"[contract] family {name}: {spec}, x {tuple(x.shape)} blocks "
            f"{[t.num_blocks for t in x.tilings]}, y {tuple(y.shape)} blocks "
            f"{[t.num_blocks for t in y.tilings]}"
            + (f", r_pad {r_pad}" if r_pad else ""))
        with executed_plans() as seen:
            res, wall, counts = run_counted(
                lambda: mm.contract(spec, x, y, tile=tile),
                "grouped_gemm" if name == "rank_sparse_32" else (
                    "tiled_matmul" if name in ("rank_sparse", "nonuniform")
                    else "bsmm"))
        plans = list(mm._plan_cache.values())
        kernels = {hold_plan_kernel(p, r_pad, f"{name} plan", gen)
                   for p in plans}
        want = {"bsmm": sum(p.local_impl == "bsmm" for p in seen)}
        log(f"    plans {[(p.local_impl, p.local_block) for p in plans]}; "
            f"kernels {sorted(kernels)}; products through execute_plan "
            f"{len(seen)}")
        if want["bsmm"] != counts["bsmm"]:
            raise AssertionError(f"{want['bsmm']} bsmm plans ran, "
                                 f"{counts['bsmm']} launches")
        err = hold_oracle(res.data, np.einsum(spec, dense_here(x),
                                              dense_here(y)),
                          f"{name} C vs float64 einsum")
        eager = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                                  local_matmul="pallas", compiled=False)
        if not torch.equal(eager.contract(spec, x, y, tile=tile).data,
                           res.data):
            raise AssertionError(f"{name}: compiled and eager C differ")
        log("    eager C == compiled C bitwise -> ok")
        out[name] = dict(counts=counts, wall=wall, err=err)
    return out


def phase_contract_chain() -> dict:
    """[contract] ``contract_chain`` of (A.B).C, tuned jointly: its report,
    the windows that ran, C against ``torch.matmul`` of masked operands."""
    nb = CHAIN_N // CHAIN_BLOCK
    mask = decay_block_mask(nb, nb, CHAIN_DECAY, 5e-2)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    ops = [BlockSparseTensor.from_dense(
        randn((CHAIN_N, CHAIN_N), torch.float32, gen),
        block_shape=(CHAIN_BLOCK, CHAIN_BLOCK), mask=mask) for _ in range(3)]
    steps = [("ab,bc->ac", ops[0], ops[1]), ("ac,cd->ad", ops[2])]
    log(f"[contract] chain (A.B).C at N={CHAIN_N}, blocks {CHAIN_BLOCK}, "
        f"decay_block_mask({nb}, {nb}, {CHAIN_DECAY}, 5e-2) on each operand "
        f"(block fill {mask.mean():.4f}), tune=True")
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           local_matmul="pallas")
    with executed_plans() as seen:
        (res, rep), wall, counts = run_counted(
            lambda: mm.contract_chain(steps, tune=True), "bsmm")
    ran = [p.lookahead for p in seen]
    log(f"    report: joint {rep['joint_makespan_s']:.6g} s, joint default "
        f"{rep['joint_default_makespan_s']:.6g} s, sequential "
        f"{rep['sequential_makespan_s']:.6g} s (simulated), speedup "
        f"{rep['speedup_vs_sequential']:.4f}; lookaheads "
        f"{rep['lookaheads']}; windows that ran {ran}; plans "
        f"{[(p['local_impl'], p['live_panels'], p['k_steps']) for p in rep['plans']]}")
    if ran != rep["lookaheads"] or counts["bsmm"] != 2:
        raise AssertionError(f"windows {ran} ran, the report names "
                             f"{rep['lookaheads']}; launches {counts}")
    for i, p in enumerate(seen):
        hold_plan_kernel(p, None, f"chain step {i}", gen)
    (_, warm, _) = run_counted(
        lambda: mm.contract_chain(steps, tune=True), "bsmm")
    eager = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                              local_matmul="pallas", compiled=False)
    if not torch.equal(eager.contract_chain(steps, tune=True)[0].data,
                       res.data):
        raise AssertionError("compiled and eager chains differ")
    log("    eager chain == compiled chain bitwise -> ok")
    a, b, c = (kron_mask(t.data, mask) for t in ops)
    ab = torch.matmul(a, b)
    # compare's hold is made for operands of unit scale; the second
    # product's left operand is A.B, of scale rms(A.B), so both sides are
    # divided by it (the same as an atol scaled by it)
    scale = ab.square().mean().sqrt()
    want = torch.matmul(ab, c)
    log(f"    the intermediate A.B has rms {scale.item():.4g}")
    err = compare(res.data / scale, want / scale, CHAIN_N, torch.float32,
                  "chain result vs torch.matmul of operands masked here, "
                  "both over rms(A.B)") * scale.item()
    del a, b, c, ab, want, res, ops, steps
    torch.cuda.empty_cache()
    return dict(wall=wall, warm=warm, report=rep, err=err)


# ---------------------------------------------------------------------------
# [filter]: norm-filtered (DBCSR-style screened) products
# ---------------------------------------------------------------------------


def decayed(n: int, block: int, gen) -> torch.Tensor:
    """bench_filter's operand on the card: standard normals, each block
    (i, k) scaled by exp(-FILTER_DECAY |i - k|)."""
    nb = n // block
    idx = torch.arange(nb, device=DEVICE, dtype=torch.float32)
    decay = torch.exp(-FILTER_DECAY * (idx[:, None] - idx[None, :]).abs())
    x = torch.randn((n, n), generator=gen, device=DEVICE)
    x.view(nb, block, nb, block).mul_(decay[:, None, :, None])
    return x


def fro_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want||_F in float64, by row chunks (bounded temporaries)."""
    total = 0.0
    for r in range(0, got.shape[0], 4096):
        d = got[r:r + 4096].double() - want[r:r + 4096].double()
        if not torch.isfinite(d).all():
            raise AssertionError("non-finite values")
        total += float(d.square().sum())
    return math.sqrt(total)


def expected_launches(plans) -> dict:
    """Launches of the plans ``execute_plan`` ran on one card with
    ``local_matmul="pallas"``: ``bsmm`` once a plan, ``tiled_matmul``
    once a K panel (or once for the all-gather schedule)."""
    want: dict = {}
    for p in plans:
        kernel = plan_kernel(p)
        want[kernel] = want.get(kernel, 0) + (
            expected_tiled_launches(p) if kernel == "tiled_matmul" else 1)
    return want


def masked_product(a, b, plan) -> torch.Tensor:
    """``torch.matmul`` of ``a`` and ``b`` with the blocks ``plan``'s
    masks leave dead zeroed here, the output blocks its ``c_mask`` leaves
    dead zeroed after: what a screened plan computes."""
    c = torch.matmul(kron_mask(a, plan.a_mask) if plan.a_mask is not None
                     else a,
                     kron_mask(b, plan.b_mask) if plan.b_mask is not None
                     else b)
    return kron_mask(c, plan.c_mask) if plan.c_mask is not None else c


def filter_slack(exact_fro: float, n: int) -> float:
    return FILTER_SLACK_AT_1024 * math.sqrt(n / 1024) * exact_fro


def phase_filter() -> dict:
    """[filter] the filtered product through ``DistributedMatmul(...,
    a_norms, b_norms, filter_eps)`` over FILTER_FRACS, then the filtered
    chain; returns their numbers."""
    t_phase = time.perf_counter()
    nb = N // BLOCK
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 28)
    a, b = decayed(N, BLOCK, gen), decayed(N, BLOCK, gen)
    t0 = time.perf_counter()
    an = block_norms(a.cpu().numpy(), nb, nb)
    bn = block_norms(b.cpu().numpy(), nb, nb)
    norms_s = time.perf_counter() - t0
    pmax = float(np.max(an[:, :, None] * bn[None]))
    log(f"[filter] bench_filter's workload at N={N}, blocks {BLOCK} "
        f"({nb} x {nb}), fp32: block (i, k) scaled by exp(-{FILTER_DECAY} "
        f"|i - k|); core.sparsity.block_norms on the host {norms_s:.1f} s; "
        f"pmax {pmax:.6g}; DistributedMatmul(taskbased, k_blocks="
        f"{K_PANELS}, local_matmul=pallas) on Grid.local")
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           k_blocks=K_PANELS, local_matmul="pallas")
    base, p0 = mm.plan(N, N, N), mm.plan(N, N, N, a_norms=an, b_norms=bn,
                                          filter_eps=0.0)
    hold(p0.digest() == base.digest(),
         f"the eps-0 plan's digest {p0.digest()[:16]} equals the norm-free "
         f"plan's {base.digest()[:16]}")
    exact = torch.matmul(a.double(), b.double())
    exact_fro = float(torch.linalg.norm(exact))
    slack = filter_slack(exact_fro, N)
    log(f"  C_exact: torch.matmul in float64 on the card, ||C_exact||_F "
        f"{exact_fro:.6g}; slack {slack:.6g} (1e-5 x ||C_exact||_F x "
        f"sqrt({N} / 1024))")
    out = {"rows": {}, "norms_s": norms_s}
    prev = None
    for frac in FILTER_FRACS:
        eps = frac * pmax
        plan = mm.plan(N, N, N, a_norms=an, b_norms=bn, filter_eps=eps)
        gemms = sum(1 for t in from_plan(plan).tasks
                    if t.kind == "gemm" and t.flops > 0)
        live = int(plan.a_mask.sum()) if plan.a_mask is not None else nb * nb
        log(f"  frac {frac:g} (filter_eps {eps:.6g}): local_impl "
            f"{plan.local_impl}, A's live blocks {live} of {nb * nb}, gemm "
            f"tasks {gemms}, filter_bound {plan.filter_bound:.6g}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        entry_bytes = torch.cuda.memory_allocated()
        with plain_guard(PLAIN_VERSIONS, "[filter]"), \
                executed_plans() as seen:
            c, wall, counts = run_counted(
                lambda: mm(a, b, a_norms=an, b_norms=bn, filter_eps=eps),
                plan_kernel(plan))
        peak = torch.cuda.max_memory_allocated() - entry_bytes
        hold_counts(counts, expected_launches(seen),
                    f"frac {frac:g}: {len(seen)} plan(s) run")
        if frac:  # the screened product itself, from the plan's masks
            compare(c, masked_product(a, b, plan), N, torch.float32,
                    f"frac {frac:g}: C vs torch.matmul of the operands "
                    "masked here by the plan's screened masks")
        err = fro_distance(c, exact)
        del c
        hold(err <= plan.filter_bound + slack,
             f"frac {frac:g}: ||C - C_exact||_F {err:.6g} within "
             f"filter_bound {plan.filter_bound:.6g} + slack {slack:.6g}")
        hold(prev is None or gemms <= prev,
             f"frac {frac:g}: gemm tasks {gemms} never rise (before: {prev})")
        prev = gemms
        for p in seen:
            hold_plan_kernel(p, None, f"[filter] frac {frac:g}", gen)
        torch.cuda.empty_cache()
        out["rows"][frac] = dict(launches=counts, live=live, gemms=gemms,
                                 bound=plan.filter_bound, err=err, wall=wall,
                                 peak=peak)
        log(f"  frac {frac:g}: launches {counts}, wall {wall:.4f} s (host "
            f"clock ending in synchronize), peak {peak / 2**30:.2f} GiB above "
            f"the {entry_bytes / 2**30:.2f} GiB held on entry")
        if frac == FILTER_TIMED_FRAC:
            out["bsmm"] = time_bsmm(plan, a, b, f"bsmm at frac {frac:g}")
    del a, b, exact
    torch.cuda.empty_cache()
    out["chain"] = filter_chain(gen)
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [filter] took {out['wall']:.1f} s")
    return out


def filter_chain(gen) -> dict:
    """The filtered ``contract_chain`` of (A.B).C at CHAIN_N on
    bench_filter's operands: step 2 planned on step 1's filtered
    structure (its fill below the unfiltered chain's), each kernel its
    plans launch held against its plain version, and the result within
    the chain's bound of the float64 chain.  Step 1's error E1 (||E1||_F
    <= b1) reaches the result as E1.C, so ||(A.B).C - R||_F <= b1 ||C||_F
    + b2 (+ the slack)."""
    nb = CHAIN_N // CHAIN_BLOCK
    ops = [BlockSparseTensor.from_dense(
        decayed(CHAIN_N, CHAIN_BLOCK, gen),
        block_shape=(CHAIN_BLOCK, CHAIN_BLOCK)) for _ in range(3)]
    an, bn = ops[0].block_norms(), ops[1].block_norms()
    eps = FILTER_CHAIN_FRAC * float(np.max(an[:, :, None] * bn[None]))
    steps = [("ik,kj->ij", ops[0], ops[1]), ("ik,kj->ij", ops[2])]
    log(f"[filter] chain (A.B).C at N={CHAIN_N}, blocks {CHAIN_BLOCK} ({nb} x "
        f"{nb}), the same decay, filter_eps {eps:.6g} ({FILTER_CHAIN_FRAC} x "
        f"pmax)")
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           local_matmul="pallas")
    with plain_guard(PLAIN_VERSIONS, "[filter]"):
        _, rep0 = mm.contract_chain(steps)
        with executed_plans() as seen:
            (res, rep), wall, counts = run_counted(
                lambda: mm.contract_chain(steps, filter_eps=eps), "bsmm")
    hold_counts(counts, expected_launches(seen),
                f"filtered chain: {len(seen)} plans run")
    fills = (rep0["plans"][1]["fill_in"], rep["plans"][1]["fill_in"])
    bounds = rep["filter_bounds"]
    hold(len(bounds) == 2 and min(bounds) >= 0 and fills[1] < fills[0]
         and res.mask is not None and not res.mask.all(),
         f"filtered chain report: bounds {bounds}, step 2's fill "
         f"{fills[1]:.4f} below the unfiltered chain's {fills[0]:.4f} (it "
         f"plans on step 1's filtered structure), result mask "
         f"{int(res.mask.sum())} of {res.mask.size} blocks")
    for i, p in enumerate(seen):
        hold_plan_kernel(p, None, f"filtered chain step {i}", gen)
    # the screened chain itself, from the two plans' masks; the second
    # product's left operand is not of unit scale (see phase_contract_chain)
    mid = masked_product(ops[0].data, ops[1].data, seen[0])
    scale = mid.square().mean().sqrt()
    compare(res.data / scale, masked_product(mid, ops[2].data, seen[1]) / scale,
            CHAIN_N, torch.float32, "filtered chain result vs torch.matmul "
            "of operands masked here by each step's screened masks, both "
            "over rms(step 1)")
    del mid
    a, b, c = (t.data.double() for t in ops)
    exact = torch.matmul(torch.matmul(a, b), c)
    c_fro = float(torch.linalg.norm(c))
    del a, b, c
    exact_fro = float(torch.linalg.norm(exact))
    err = fro_distance(res.data, exact)
    slack = filter_slack(exact_fro, CHAIN_N)
    limit = bounds[0] * c_fro + bounds[1] + slack
    hold(err <= limit, f"filtered chain: ||(A.B).C - R||_F {err:.6g} within "
         f"b1 ||C||_F + b2 + slack = {bounds[0]:.6g} x {c_fro:.6g} + "
         f"{bounds[1]:.6g} + {slack:.6g} = {limit:.6g} (float64 chain on "
         "the card)")
    del exact, res, ops, steps
    torch.cuda.empty_cache()
    return dict(wall=wall, launches=counts, bounds=bounds, fills=fills,
                err=err, limit=limit)


def densify_here(rcsr) -> torch.Tensor:
    """The dense A of a ``RankCSR``, built on the card from its factors:
    every stored block's ``u[s] @ v[s]`` written at (block row, column)
    of the CSR, sharing no code with the port's ``to_dense`` or
    ``rank_operands``."""
    csr = rcsr.csr
    bm, bk = rcsr.bm, rcsr.bk
    blocks = torch.bmm(torch.as_tensor(rcsr.u, device=DEVICE),
                       torch.as_tensor(rcsr.v, device=DEVICE))
    rows = np.repeat(np.arange(csr.m_blocks), np.diff(csr.row_ptr))
    a = torch.zeros((csr.m_blocks * bm, csr.n_blocks * bk), device=DEVICE)
    a4 = a.view(csr.m_blocks, bm, csr.n_blocks, bk)
    a4[torch.as_tensor(rows, device=DEVICE), :,
       torch.as_tensor(csr.col_idx, device=DEVICE, dtype=torch.int64), :] = (
        blocks)
    return a


def phase_rank(rcsr, b) -> dict:
    """The rank-sparse product on the grouped (main) and xla routes."""
    out = {}
    for route in ("pallas", "xla"):
        mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                               k_blocks=K_PANELS, local_matmul=route)
        plan = mm.plan(N, N, N, a_ranks=rcsr)
        rows, chunks = _rank_chunks(plan, rcsr.r_pad)
        log(f"[6 main path, rank-sparse, local_matmul={route}] local_impl="
            f"{plan.local_impl}, nnz {rcsr.nnz}/{(N // BLOCK) ** 2} blocks, "
            f"mean rank {rcsr.rank_map().mean_rank:.2f}, r_pad {rcsr.r_pad}, "
            f"live panels {len(plan.live_panels)}, useful FLOPs "
            f"{plan.cost.flops_sparse:.4g} (dense {plan.cost.flops_dense:.4g})"
            + (f", {chunks} chunks of {rows} block rows" if route == "pallas"
               else ""))
        if plan.local_impl != "ranksparse":
            raise AssertionError(f"local_impl={plan.local_impl!r}")
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        c, wall, counts = run_path(
            mm, None, b, "grouped_gemm" if route == "pallas" else None,
            a_ranks=rcsr,
        )
        peak = torch.cuda.max_memory_allocated()
        log(f"  peak device memory {peak / 2**30:.2f} GiB "
            f"({resident / 2**30:.2f} GiB resident before the call)")
        want_grouped = chunks if route == "pallas" else 0
        if counts["grouped_gemm"] != want_grouped or counts["tiled_matmul"]:
            raise AssertionError(
                f"expected {want_grouped} grouped_gemm and 0 tiled_matmul "
                f"launches, got {counts}")
        if c.shape != (N, N) or c.dtype != torch.float32:
            raise AssertionError(f"rank C is {tuple(c.shape)} {c.dtype}")
        want = torch.matmul(densify_here(rcsr), b)
        compare(c, want, N, torch.float32,
                "rank-sparse C vs torch.matmul of A densified from factors")
        del c, want
        out[route] = dict(wall=wall, peak=peak, resident=resident,
                          launches=counts["grouped_gemm"])
    return out


def phase_rank_fallback() -> None:
    """Ranks past the crossover: every panel densified, tiled_matmul only."""
    rcsr = make_rank_factors(FALLBACK_N, BLOCK, FALLBACK_RANK, seed=SEED)
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           k_blocks=FALLBACK_N // BLOCK, local_matmul="pallas")
    plan = mm.plan(FALLBACK_N, FALLBACK_N, FALLBACK_N, a_ranks=rcsr)
    live = len(plan.live_panels)
    log(f"[6 rank-sparse past the crossover] N={FALLBACK_N}, r_pad "
        f"{rcsr.r_pad} > r* = {BLOCK // 2}, live panels {live}")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    b = randn((FALLBACK_N, FALLBACK_N), torch.float32, gen)
    c, _, counts = run_path(mm, None, b, "tiled_matmul", a_ranks=rcsr)
    if counts["tiled_matmul"] != live or counts["grouped_gemm"]:
        raise AssertionError(
            f"expected {live} tiled_matmul and 0 grouped_gemm launches, got "
            f"{counts}")
    compare(c, torch.matmul(densify_here(rcsr), b), FALLBACK_N,
            torch.float32, "fallback C vs torch.matmul of A densified here")


def phase_times(a, b, sparse_plan, rank_plan, r_pad) -> dict:
    """Each kernel at the main path's shapes, on the main path's data (the
    rank case's B is make_case's A)."""
    b_rank = a
    log("[7 times] CUDA events, mean over repeated launches after a warm-up")
    out = {}
    a_panel, b_panel = a[:, :BLOCK], b[:BLOCK, :]
    flops = tiled_flops(N, BLOCK, N)
    nbytes = 4.0 * (N * BLOCK + BLOCK * N + N * N)
    ms = cuda_ms(lambda: tiled_matmul_cuda(a_panel, b_panel), 5)
    plain_ms = cuda_ms(lambda: tiled_matmul_plain(a_panel, b_panel), 5)
    lib_ms = cuda_ms(lambda: torch.matmul(a_panel, b_panel), 5)
    bound_ms, by, bound_text = split_bound(flops, nbytes)
    out["tiled_matmul"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=by, flops=flops)
    log(f"  tiled_matmul ({N},{BLOCK}; lda={a_panel.stride(0)})x({BLOCK},{N}) "
        f"fp32: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s of fp32 "
        f"work), plain {plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, "
        f"{bound_text}")

    out["bsmm"] = time_bsmm(sparse_plan, a, b, "bsmm")
    torch.cuda.empty_cache()
    out["grouped_gemm"] = _time_grouped(rank_plan, r_pad, b_rank)
    return out


def time_bsmm(plan, a, b, what: str) -> dict:
    """A main-path ``bsmm`` call of ``plan`` on the 1x1 grid, timed on its
    own operands: the masked operands' live panels, gathered as the
    executor gathers them, and the executor's map (``bsmm_walk``); beside
    its plain version, ``torch.matmul`` of the same gathered (masked)
    operands and the bound at the map's FLOP (``split_bound``).  Where the
    executor's map is a tile map, A's map alone is timed on the same
    operands too, with its bound, as an extra line (``a_map``)."""
    w = plan.kb_width
    idx = torch.cat([torch.arange(kk * w, (kk + 1) * w, device=DEVICE)
                     for kk in plan.live_panels])
    a_g = kron_mask(a, plan.a_mask)[:, idx].contiguous()
    b_g = kron_mask(b, plan.b_mask)[idx].contiguous()
    walk, flops, live_blocks = bsmm_walk(plan)
    cols = torch.as_tensor(walk, device=DEVICE)
    bm, bk, bn = plan.local_block
    m, n = a.shape[0], b.shape[1]
    nbytes = 4.0 * (live_blocks * bm * bk + b_g.numel() + m * n) + cols.numel() * 4
    ms = cuda_ms(lambda: bsmm_cuda(a_g, b_g, cols, bm=bm, bk=bk, bn=bn), 3)
    plain_ms = cuda_ms(
        lambda: bsmm_plain(a_g, b_g, cols, bm=bm, bk=bk, bn=bn), 3
    )
    lib_ms = cuda_ms(lambda: torch.matmul(a_g, b_g), 3)
    bound_ms, by, bound_text = split_bound(flops, nbytes)
    log(f"  {what} ({m},{a_g.shape[1]}) live blocks {live_blocks} "
        f"({live_blocks / cols.shape[0] / (a_g.shape[1] // bk):.4f} of A's), "
        f"map {tuple(cols.shape)}, FLOP {flops:.17g}: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s of fp32 work), plain "
        f"{plain_ms:.3f} ms, torch.matmul (dense, masked operands) "
        f"{lib_ms:.3f} ms, {bound_text}")
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=by, flops=flops,
               live_blocks=live_blocks)
    if walk.ndim == 3:
        a_cols = torch.as_tensor(plan.local_cols[0, 0], device=DEVICE)
        a_flops = bsmm_flops(live_blocks, bm, bk, n)
        a_ms = cuda_ms(lambda: bsmm_cuda(a_g, b_g, a_cols, bm=bm, bk=bk,
                                         bn=bn), 3)
        a_bound, _, a_text = split_bound(a_flops, nbytes)
        log(f"  {what}, A's map alone (the walk without a B map) "
            f"{tuple(a_cols.shape)}, FLOP {a_flops:.17g}: kernel "
            f"{a_ms:.3f} ms ({a_flops / a_ms / 1e9:.2f} TFLOP/s of fp32 "
            f"work), {a_text}")
        out["a_map"] = dict(ms=a_ms, bound_ms=a_bound, flops=a_flops)
    del a_g, b_g
    return out


def _time_grouped(plan, r_pad, b) -> dict:
    """One main-path launch of ``grouped_gemm``: a chunk's V tokens against
    the rank case's B panels, through the wrapper as the route calls it
    (its work list built on the host included); the library call is one
    ``torch.bmm`` over the same work grouped by expert (every live panel
    has one tile per block row of the chunk).  The bound counts the
    function's 2 T D F FLOP at the bf16 tensor cores' peak against the
    operands' bytes (``split_bound``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    x, w, te = _grouped_operands(plan, r_pad, torch.float32, gen, b=b)
    bt = r_pad
    n_pairs = tile_pairs(te, bt).shape[0]
    t, d = x.shape
    e, _, f = w.shape
    live = len(plan.live_panels)
    flops = grouped_flops(t, d, f)
    nbytes = 4.0 * (t * d + live * d * f + t * f) + te.size * 4
    ms = cuda_ms(lambda: grouped_gemm_cuda(x, w, te, bt=bt), 5)
    te_dev = torch.as_tensor(te, device=DEVICE)
    plain_ms = cuda_ms(lambda: grouped_gemm_plain(x, w, te_dev, bt=bt), 3)
    rows = t // (live * bt)
    x_by_expert = (x.view(rows, live, bt, d).transpose(0, 1)
                   .reshape(live, rows * bt, d))
    w_live = w[torch.as_tensor(plan.live_panels, device=DEVICE)]
    lib_ms = cuda_ms(lambda: torch.bmm(x_by_expert, w_live), 5)
    bound_ms, by, bound_text = split_bound(flops, nbytes)
    log(f"  grouped_gemm T={t} D={d} F={f} experts {live} bt={bt} fp32 "
        f"({n_pairs} unit pairs): kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s of fp32 work), plain "
        f"{plain_ms:.3f} ms, torch.bmm (grouped by expert) {lib_ms:.3f} ms, "
        f"{bound_text}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, flops=flops)



# ---------------------------------------------------------------------------
# flash attention and the LM forward
# ---------------------------------------------------------------------------

#: (h, hkv, s, causal, window): tests/test_kernels.py's shapes, the
#: window-8 case, a ragged S, lengths on both sides of the bf16 kernel's
#: 128-row query tile (two of its 64-key tiles), and a GQA group of 5
FA_SHAPES = ((4, 2, 256, True, None), (4, 1, 256, True, 64),
             (2, 2, 128, False, None), (8, 4, 512, True, 128),
             (2, 2, 256, True, 8), (4, 2, 1000, True, None),
             (4, 2, 1000, False, 100), (4, 2, 1, True, None),
             (4, 2, 127, True, None), (4, 2, 128, False, None),
             (4, 2, 129, True, None), (4, 2, 255, False, None),
             (10, 2, 300, True, None))


#: head widths off the kernel's instances, held and timed beside them
FA_ODD_HEAD_DIMS = (8, 80, 112)


def attention_tol(dtype) -> float:
    """The reference's attention tolerance (tests/test_kernels.py)."""
    return 2e-2 if dtype == torch.bfloat16 else 2e-3


def heads_view(b, s, h, dh, dtype, gen):
    """A (B, H, S, Dh) transposed view of a (B, S, H, Dh) tensor: the
    layout the attention layer hands the kernel."""
    return randn((b, s, h, dh), dtype, gen).transpose(1, 2)


def compare_attention(got, want, dtype, what: str) -> float:
    """Largest |got - want|; raises unless every element is finite and
    within ``atol = rtol = attention_tol(dtype)`` and, in bf16, also at
    the output's scale (``hold_at_scale``)."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    t = attention_tol(dtype)
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (g - w).abs()
    err = diff.max().item()
    bad = (diff > t + t * w.abs()).sum().item()
    log(f"  {what}: max_abs_err={err:.6g} (atol=rtol={t}) -> "
        f"{'ok' if not bad else f'{bad} elements out of tolerance'}")
    if bad:
        raise AssertionError(f"{what}: {bad} elements out of tolerance")
    if dtype == torch.bfloat16:
        hold_at_scale(got, want, what)
    return err


def hold_at_scale(got, want, what: str) -> float:
    """Raises unless every element of ``got`` is finite and within
    ``BF16_ULP_RTOL * |want| + BF16_RMS_ATOL * rms(want)`` of ``want``:
    one bf16 rounding of each value and fp32 noise at a share of the
    values' scale.  Returns the worst element's share of its limit."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    rows = max(1, 2**26 // max(1, want[0].numel()))  # bounds temporaries
    sq = sum(w.float().square().sum().item() for w in want.split(rows))
    atol = BF16_RMS_ATOL * math.sqrt(sq / max(1, want.numel()))
    worst = 0.0
    for g, w in zip(got.split(rows), want.split(rows)):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite values")
        limit = atol + BF16_ULP_RTOL * w.abs()
        worst = max(worst, ((g - w).abs() / limit).max().item())
    log(f"    at the output's scale (atol {BF16_RMS_ATOL} x rms = "
        f"{atol:.4g}, rtol 2**-7): worst element at {worst:.4g} of its "
        f"limit -> {'ok' if worst <= 1 else 'OUT OF TOLERANCE'}")
    if worst > 1:
        raise AssertionError(f"{what}: out of tolerance at the output's "
                             f"scale")
    return worst


def attention_operands(cfg, b, s, gen):
    """Q, K, V of the LM's attention call at batch ``b``, length ``s``."""
    dh = cfg.resolved_head_dim
    return (heads_view(b, s, cfg.num_heads, dh, torch.bfloat16, gen),
            heads_view(b, s, cfg.num_kv_heads, dh, torch.bfloat16, gen),
            heads_view(b, s, cfg.num_kv_heads, dh, torch.bfloat16, gen))


def phase_attention_kernel(cfg) -> float:
    """flash_attention against its plain version; returns the error at the
    LM's shape (bf16, causal)."""
    log("[3 flash_attention vs plain version]")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    for dtype in DTYPES:
        for h, hkv, s, causal, window in FA_SHAPES:
            q = heads_view(2, s, h, 64, dtype, gen)
            k = heads_view(2, s, hkv, 64, dtype, gen)
            v = heads_view(2, s, hkv, 64, dtype, gen)
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            compare_attention(
                got, flash_attention_plain(q, k, v, causal=causal,
                                           window=window), dtype,
                f"flash_attention {dtype} h={h} hkv={hkv} S={s} "
                f"causal={causal} window={window}")
        # the wide instances, and widths that run on the next instance up
        # (8: the smoke configs; 80: hubert-xlarge; 112: kimi-k2)
        for dh in (128, 256) + FA_ODD_HEAD_DIMS:
            q = heads_view(2, 600, 4, dh, dtype, gen)
            k = heads_view(2, 600, 1, dh, dtype, gen)
            v = heads_view(2, 600, 1, dh, dtype, gen)
            for causal, window in ((True, None), (True, 100)):
                got = flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
                torch.cuda.synchronize()
                compare_attention(
                    got, flash_attention_plain(q, k, v, causal=causal,
                                               window=window), dtype,
                    f"flash_attention {dtype} Dh={dh} S=600 causal={causal} "
                    f"window={window}")
    q, k, v = attention_operands(cfg, LM_BATCH, LM_SEQ, gen)
    got = flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = compare_attention(
        got, flash_attention_plain(q, k, v, causal=True), torch.bfloat16,
        f"flash_attention bf16 main (B={LM_BATCH}, H={cfg.num_heads}, "
        f"Hkv={cfg.num_kv_heads}, S={LM_SEQ}, Dh={cfg.resolved_head_dim}, "
        f"causal)")
    del q, k, v, got
    torch.cuda.empty_cache()
    return err


def live_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave live in one head of length s."""
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(
        q - window + 1, 0)
    hi = q + 1 if causal else np.full(s, s)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_mask(s: int, causal: bool, window: int | None):
    """The boolean mask (True: attend) of ``causal`` attention with
    ``window`` for ``scaled_dot_product_attention``, or None where
    ``is_causal`` says it."""
    if window is None:
        return None
    q = torch.arange(s, device=DEVICE)[:, None]
    k = torch.arange(s, device=DEVICE)[None, :]
    keep = k > q - window
    return keep & (k <= q) if causal else keep


def time_attention(cfg, b, s, iters, plain=True) -> dict:
    """The kernel at the LM's attention call (``cfg``'s causality and
    window) beside its plain version (at S <= 4096, unless ``plain`` is
    false), ``scaled_dot_product_attention`` (with the window as a
    boolean mask) and its bound: 4·B·H·Dh FLOP per live (query, key) pair
    at the bf16 tensor-core peak, against Q, K, V read once and O written
    once at the card's memory rate."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    q, k, v = attention_operands(cfg, b, s, gen)
    causal, window = cfg.causal, cfg.window
    pairs = live_pairs(s, causal, window)
    flops = attention_flops(b, cfg.num_heads, cfg.resolved_head_dim, pairs)
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                              window=window), iters)
    out = dict(ms=ms, flops=flops, nbytes=nbytes, pairs=pairs)
    if plain and s <= LM_SEQ:  # its scores: 8.6 GB at B=4, S=4096
        out["plain_ms"] = cuda_ms(
            lambda: flash_attention_plain(q, k, v, causal=causal,
                                          window=window), iters)
    mask = sdpa_mask(s, causal, window)
    out["library_ms"] = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), iters)
    out["bound_ms"], out["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    mode = ("causal" if causal else "non-causal") + (
        f", window {window}" if window is not None else "")
    log(f"  flash_attention B={b} H={cfg.num_heads} Hkv={cfg.num_kv_heads} "
        f"S={s} Dh={cfg.resolved_head_dim} bf16 {mode}: kernel {ms:.3f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s), "
        + (f"plain {out['plain_ms']:.3f} ms, " if "plain_ms" in out else
           "plain not run, " if not plain else
           "plain not run (its scores would take "
           f"{4.0 * b * cfg.num_heads * s * s / 1e9:.0f} GB), ")
        + f"scaled_dot_product_attention"
        + (" (boolean mask)" if mask is not None else "")
        + f" {out['library_ms']:.3f} ms "
        f"({flops / out['library_ms'] / 1e9:.2f} TFLOP/s), "
        + f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
        f"{flops:.4g} FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s = "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms; {nbytes:.4g} bytes at "
        f"{PEAK_HBM_BYTES_PER_S:.3g} B/s = "
        f"{nbytes / PEAK_HBM_BYTES_PER_S * 1e3:.4f} ms)")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def expert_route(kernel: bool):
    """``forward``'s MoE blocks with their expert GEMMs on the kernel
    (``kernel`` true) or the einsum route, whatever its ``use_kernel``
    says of attention: a witness forward with one kernel of the two."""
    moe_ffn = lm_model.moe_ffn

    def routed(*args, use_kernel=False):
        del use_kernel  # the witness's choice stands
        return moe_ffn(*args, use_kernel=kernel)

    lm_model.moe_ffn = routed
    try:
        yield
    finally:
        lm_model.moe_ffn = moe_ffn


def attention_blocks(cfg) -> int:
    """The attention blocks of ``cfg``'s stack (its layers, for a model of
    attention blocks only)."""
    return (cfg.units * cfg.block_pattern.count("attn")
            + cfg.tail.count("attn"))


def stream_shape(inputs: dict, cfg) -> tuple[int, int]:
    """(B, S) of the residual stream ``inputs`` give: embeddings first,
    then the tokens (when the model embeds them)."""
    parts = [inputs[k] for k in ("embeds", "tokens") if inputs.get(k) is
             not None and (k == "embeds" or cfg.embed_inputs)]
    return parts[0].shape[0], sum(x.shape[1] for x in parts)


def run_forward(model, inputs, cfg, ctx, *, use_kernel, what, experts=None,
                shape=None):
    """One forward of ``inputs`` (a dict, or the tokens alone) with every
    launch count set to 0 just before and read just after; returns
    (logits, wall seconds, counts, peak bytes).  ``experts`` (default
    ``use_kernel``) sets the MoE blocks' expert GEMMs apart from attention
    (``expert_route``).  ``shape`` is the logits' (a rank's, on a sharded
    model), by default the whole batch's."""
    if isinstance(inputs, torch.Tensor):
        inputs = {"tokens": inputs}
    experts = use_kernel if experts is None else experts
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.inference_mode(), expert_route(experts):
        logits, _ = forward(model, inputs, cfg, ctx, use_kernel=use_kernel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    log(f"  {what}: launches {counts}; wall {wall:.3f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
        f"before the call)")
    n_attn = attention_blocks(cfg)
    want = {"flash_attention": n_attn if use_kernel else 0,
            "grouped_gemm": (MOE_LAUNCHES_PER_LAYER * n_attn
                             if experts and cfg.moe is not None else 0)}
    if any(n != want.get(name, 0) for name, n in counts.items()):
        raise AssertionError(
            f"{what}: expected launches {want} and no other kernel, got "
            f"{counts}")
    shape = shape or (*stream_shape(inputs, cfg), cfg.vocab_size)
    if logits.shape != shape or logits.dtype != torch.float32:
        raise AssertionError(f"{what}: logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    return logits, wall, counts, peak


def logit_distance(got, want, what: str) -> tuple[float, float]:
    """(max |got - want| / max |want|, share of positions whose argmax
    agrees); raises unless every logit is finite."""
    diff = scale = 0.0
    agree = 0
    for i in range(got.shape[0]):  # one prompt at a time bounds temporaries
        g, w = got[i], want[i]
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{what}: non-finite logits")
        diff = max(diff, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        agree += (g.argmax(-1) == w.argmax(-1)).sum().item()
    rel = diff / scale
    share = agree / (got.shape[0] * got.shape[1])
    log(f"  {what}: max |logit difference| {diff:.6g} = {rel:.6g} of max "
        f"|logit| {scale:.6g}; argmax agrees at {share:.6f} of positions")
    return rel, share


def hold(ok: bool, what: str) -> None:
    log(f"    -> {what}: {'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        raise AssertionError(f"{what}: out of tolerance")


def fp32_twin(model, cfg):
    """The model with every parameter widened to fp32 (exact)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    twin = LM(cfg32, device=DEVICE)
    params = dict(model.named_parameters())
    for name, p in twin.named_parameters():
        p.data.copy_(params[name])
    return twin, cfg32


def phase_lm(cfg) -> dict:
    """The LM forward at full size; returns its numbers."""
    n_params = cfg.param_count()
    log(f"[8 LM forward] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} (Dh "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, tied embeddings {cfg.tie_embeddings}; "
        f"{n_params / 1e9:.3f} B parameters")
    t0 = time.perf_counter()
    model = init_model(cfg, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  init_model on the card: {time.perf_counter() - t0:.2f} s, "
        f"{weights / 2**30:.2f} GiB of weights")
    tok_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=tok_gen, device=DEVICE)
    out = {}
    xla = ParallelCtx(None)
    summa = ParallelCtx(Grid.local(DEVICE), matmul_strategy="summa")
    # the yardstick: an fp32 twin of the same weights, plain attention
    model32, cfg32 = fp32_twin(model, cfg)
    ref32, _, _, _ = run_forward(
        model32, tokens, cfg32, xla, use_kernel=False,
        what=f"fp32 forward(use_kernel=False) B={LM_BATCH} S={LM_SEQ}")
    for ctx, what in ((xla, "fp32 kernel forward vs fp32 plain forward"),
                      (summa, "fp32 summa kernel forward vs fp32 plain "
                              "forward")):
        got, _, _, _ = run_forward(model32, tokens, cfg32, ctx,
                                   use_kernel=True, what=what.split(" vs")[0])
        rel, share = logit_distance(got, ref32, what)
        hold(rel <= LM_FP32_REL_TOL and share >= LM_FP32_AGREE,
             f"{what} within {LM_FP32_REL_TOL} and at least {LM_FP32_AGREE}")
        out["fp32_summa" if ctx is summa else "fp32"] = (rel, share)
        del got
    del model32
    torch.cuda.empty_cache()
    # the bf16 forwards: plain attention, the kernel (the main path), and
    # the kernel with the FFN projections on the engine
    plain, _, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=False,
        what=f"forward(use_kernel=False) B={LM_BATCH} S={LM_SEQ}")
    rel_p, share_p = logit_distance(plain, ref32,
                                    "bf16 plain forward vs fp32 forward")
    logits, _, counts, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what=f"forward(use_kernel=True) B={LM_BATCH} S={LM_SEQ}")
    out["launches"] = counts["flash_attention"]
    greedy = logits[:, -1].argmax(-1).tolist()
    log(f"  greedy next token of each prompt: {greedy}")
    out["rel"], out["agree"] = logit_distance(
        logits, plain, "bf16 kernel forward vs bf16 plain forward")
    hold(out["rel"] <= LM_BF16_PAIR_REL and out["agree"] >= LM_BF16_PAIR_AGREE,
         f"bf16 kernel forward vs bf16 plain forward within "
         f"{LM_BF16_PAIR_REL} and at least {LM_BF16_PAIR_AGREE}")
    del plain
    torch.cuda.empty_cache()
    bf16_bound = (f"no further from the fp32 forward than {LM_BF16_REL_RATIO}"
                  f" x the plain forward's {rel_p:.6g}, argmax within "
                  f"{LM_BF16_AGREE_DROP} of its {share_p:.6f}")
    rel, share = logit_distance(logits, ref32,
                                "bf16 kernel forward vs fp32 forward")
    hold(rel <= LM_BF16_REL_RATIO * rel_p
         and share >= share_p - LM_BF16_AGREE_DROP,
         f"bf16 kernel forward vs fp32 forward: {bf16_bound}")
    on_engine, _, _, _ = run_forward(
        model, tokens, cfg, summa, use_kernel=True,
        what=f"forward(use_kernel=True, matmul_strategy='summa') "
             f"B={LM_BATCH} S={LM_SEQ}")
    stats = summa.matmul().cache_stats()["plan"]
    log(f"  the engine's plan cache over the forwards: {stats}")
    out["summa_rel"], out["summa_agree"] = logit_distance(
        on_engine, logits, "bf16 summa forward vs bf16 xla forward")
    hold(out["summa_rel"] <= LM_BF16_PAIR_REL
         and out["summa_agree"] >= LM_BF16_PAIR_AGREE,
         f"bf16 summa forward vs bf16 xla forward within "
         f"{LM_BF16_PAIR_REL} and at least {LM_BF16_PAIR_AGREE}")
    rel, share = logit_distance(on_engine, ref32,
                                "bf16 summa forward vs fp32 forward")
    hold(rel <= LM_BF16_REL_RATIO * rel_p
         and share >= share_p - LM_BF16_AGREE_DROP,
         f"bf16 summa forward vs fp32 forward: {bf16_bound}")
    del on_engine, logits, ref32
    torch.cuda.empty_cache()
    # walls and peaks: each bf16 forward again, warm, with nothing but
    # the weights resident
    for key, ctx, use_kernel in (("", xla, True), ("plain_", xla, False),
                                 ("summa_", summa, True)):
        _, out[key + "wall"], _, out[key + "peak"] = run_forward(
            model, tokens, cfg, ctx, use_kernel=use_kernel,
            what=f"warm forward(use_kernel={use_kernel}, "
                 f"matmul_strategy={ctx.matmul_strategy!r}) B={LM_BATCH} "
                 f"S={LM_SEQ}")
    # one prompt at prefill_32k's length: no plain yardstick (its scores
    # would take 137 GB)
    long_tokens = torch.randint(0, cfg.vocab_size, (1, LM_LONG_SEQ),
                                generator=tok_gen, device=DEVICE)
    logits, out["long_wall"], counts, out["long_peak"] = run_forward(
        model, long_tokens, cfg, xla, use_kernel=True,
        what=f"forward(use_kernel=True) B=1 S={LM_LONG_SEQ}")
    for i in range(0, LM_LONG_SEQ, 4096):
        if not torch.isfinite(logits[0, i:i + 4096]).all():
            raise AssertionError(f"S={LM_LONG_SEQ} forward: non-finite logits")
    log(f"  S={LM_LONG_SEQ} forward: all {logits.numel()} logits finite; greedy next "
        f"token {logits[0, -1].argmax().item()}")
    out["long_launches"] = counts["flash_attention"]
    del logits, model
    torch.cuda.empty_cache()
    log("[7 times] flash_attention at the LM's attention calls")
    out["times"] = time_attention(cfg, LM_BATCH, LM_SEQ, 10)
    out["long_times"] = time_attention(cfg, 1, LM_LONG_SEQ, 5)
    for dh in FA_ODD_HEAD_DIMS[1:]:  # hubert-xlarge's and kimi-k2's widths
        out[f"times_dh{dh}"] = time_attention(
            dataclasses.replace(cfg, head_dim=dh), LM_BATCH, LM_SEQ, 10,
            plain=False)
    for key, wall, t in ((f"B={LM_BATCH} S={LM_SEQ}", out["wall"], out["times"]),
                         (f"B=1 S={LM_LONG_SEQ}", out["long_wall"], out["long_times"])):
        share = cfg.num_layers * t["ms"] / 1e3 / wall
        log(f"  forward at {key}: wall {wall:.3f} s, of which "
            f"{cfg.num_layers} kernel launches {cfg.num_layers * t['ms']:.1f} "
            f"ms ({share:.3f} of the wall)")
    return out


def phase_auto_forward() -> dict:
    """[auto forward] llama3.2-1b at full width, depth cut to AUTO_LAYERS,
    under ``matmul_strategy="auto"`` (the FFN projections on the tuned
    schedule), against the ``"summa"`` forward of the same weights."""
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=AUTO_LAYERS)
    log(f"[auto forward] {cfg.name} at full width, {cfg.num_layers} layers, "
        f"B=1 S={AUTO_SEQ}, bf16, ParallelCtx(Grid.local, "
        f"matmul_strategy='auto') against matmul_strategy='summa'")
    model = init_model(cfg, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (1, AUTO_SEQ),
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(SEED + 8),
                           device=DEVICE)
    auto = ParallelCtx(Grid.local(DEVICE), matmul_strategy="auto")
    summa = ParallelCtx(Grid.local(DEVICE), matmul_strategy="summa")
    got, cold_wall, counts, _ = run_forward(
        model, tokens, cfg, auto, use_kernel=True,
        what="forward(use_kernel=True, matmul_strategy='auto'), first call "
             "(tunes each projection shape)")
    for plan in auto.matmul()._plan_cache.values():
        log(f"  tuned projection {plan.m}x{plan.k}x{plan.n}: executed "
            f"strategy {plan.cfg.strategy}, k_steps {plan.k_steps}; "
            f"{tuned_text(plan.tuned)}")
    want, _, _, _ = run_forward(
        model, tokens, cfg, summa, use_kernel=True,
        what="forward(use_kernel=True, matmul_strategy='summa')")
    rel, share = logit_distance(got, want,
                                "bf16 auto forward vs bf16 summa forward")
    hold(rel <= LM_BF16_PAIR_REL and share >= LM_BF16_PAIR_AGREE,
         f"bf16 auto forward vs bf16 summa forward within "
         f"{LM_BF16_PAIR_REL} and at least {LM_BF16_PAIR_AGREE}")
    del got, want
    _, wall, _, peak = run_forward(
        model, tokens, cfg, auto, use_kernel=True,
        what="warm forward(use_kernel=True, matmul_strategy='auto')")
    _, summa_wall, _, _ = run_forward(
        model, tokens, cfg, summa, use_kernel=True,
        what="warm forward(use_kernel=True, matmul_strategy='summa')")
    del model
    torch.cuda.empty_cache()
    return dict(rel=rel, agree=share, launches=counts["flash_attention"],
                cold_wall=cold_wall, wall=wall, summa_wall=summa_wall,
                peak=peak)


def moe_launches(layer, cfg, b: int, s: int, gen, iters: int) -> dict:
    """The ``grouped_gemm`` launches of one MoE layer of ``cfg`` on ``b``
    prompts of ``s`` tokens, on the layer's own weights and random bf16
    tokens filling its capacity buffer ``(b, E, C, D)``: gate (up has its
    shape) and down, each held against ``grouped_gemm_plain`` (the
    reference's tolerance and ``hold_at_scale``) and timed
    through ``ops.grouped_gemm`` as the layer calls it (host tile map),
    beside the plain version, one ``torch.bmm`` over the buffer grouped
    by expert and the card's bound (one bf16 product: its FLOP at the
    bf16 peak against its bytes)."""
    e = layer.w_gate.shape[0]
    cap = moe_layer.capacity(cfg.moe, s, e)
    te = np.tile(np.arange(e, dtype=np.int32), b)
    te_dev = torch.as_tensor(te, device=DEVICE)
    t = b * e * cap
    out = {}
    for name, w in (("gate", layer.w_gate), ("down", layer.w_down)):
        d, f = w.shape[1], w.shape[2]
        x = randn((t, d), torch.bfloat16, gen)
        what = (f"grouped_gemm bf16 {cfg.name} {name} T={t} D={d} F={f} "
                f"E={e} bt={cap}")
        got = kops.grouped_gemm(x, w, te, bt=cap)
        torch.cuda.synchronize()
        want = grouped_gemm_plain(x, w, te_dev, bt=cap)
        err = compare(got, want, d, torch.bfloat16, what)
        hold_at_scale(got, want, what)
        del got, want
        flops = grouped_flops(t, d, f)
        nbytes = 2.0 * (t * d + e * d * f + t * f)
        ms = cuda_ms(lambda: kops.grouped_gemm(x, w, te, bt=cap), iters)
        plain_ms = cuda_ms(lambda: grouped_gemm_plain(x, w, te_dev, bt=cap),
                           2)
        x_by_expert = (x.view(b, e, cap, d).transpose(0, 1)
                       .reshape(e, b * cap, d))
        lib_ms = cuda_ms(lambda: torch.bmm(x_by_expert, w), iters)
        bound_ms, by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"  {what}: kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms, torch.bmm (grouped by expert) "
            f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}: {flops:.4g} "
            f"FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s = "
            f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms; {nbytes:.4g} bytes at "
            f"{PEAK_HBM_BYTES_PER_S:.3g} B/s = "
            f"{nbytes / PEAK_HBM_BYTES_PER_S * 1e3:.4f} ms)")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=by, max_abs_err=err,
                         flops=flops, nbytes=nbytes)
        del x, x_by_expert
        torch.cuda.empty_cache()
    layer_ms = 2 * out["gate"]["ms"] + out["down"]["ms"]
    layer_bound = 2 * out["gate"]["bound_ms"] + out["down"]["bound_ms"]
    log(f"  {cfg.name}: one layer's {MOE_LAUNCHES_PER_LAYER} launches "
        f"{layer_ms:.3f} ms against a bound of {layer_bound:.3f} ms")
    return out


def hold_moe_layer(model, cfg, tokens) -> float:
    """The first MoE layer of ``model`` on the embedded ``tokens``: the
    kernel route (``MOE_LAUNCHES_PER_LAYER`` ``grouped_gemm`` launches)
    against the einsum route on the same input, held at the output's
    scale (``hold_at_scale``: both route alike and round their GEMMs
    once), and their aux losses equal; returns the distance over max
    |output|."""
    layer = model.units[0]["b0"].moe
    with torch.inference_mode():
        x = model_layers.embed(model.embed, tokens)
        grouped_gemm_cuda.launches = 0
        got, aux = moe_layer.moe_ffn(layer, x, cfg, ParallelCtx(None),
                                     use_kernel=True)
        torch.cuda.synchronize()
        launches = grouped_gemm_cuda.launches
        want, want_aux = moe_layer.moe_ffn(layer, x, cfg, ParallelCtx(None))
    if launches != MOE_LAUNCHES_PER_LAYER:
        raise AssertionError(f"{cfg.name} MoE layer: {launches} grouped_gemm "
                             f"launches, not {MOE_LAUNCHES_PER_LAYER}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name} MoE layer: non-finite output")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    what = f"{cfg.name} MoE layer 0 on the embedded prompts, kernel vs einsum"
    log(f"  {what}: max |difference| {diff:.6g} = {diff / scale:.6g} of "
        f"max |output| {scale:.6g} (bitwise equal: {torch.equal(got, want)});"
        f" aux {float(aux):.6g} vs {float(want_aux):.6g}")
    hold_at_scale(got, want, what)
    hold(float(aux) == float(want_aux), f"{what}: aux losses equal")
    return diff / scale


def hold_moe_attention(cfg, b: int, gen) -> float:
    """``flash_attention`` at ``cfg``'s own attention call on ``b`` prompts
    of ``MOE_SEQ`` tokens (causal, the config's window) against its plain
    version; returns the error."""
    q, k, v = attention_operands(cfg, b, MOE_SEQ, gen)
    got = flash_attention_cuda(q, k, v, causal=True, window=cfg.window)
    torch.cuda.synchronize()
    err = compare_attention(
        got, flash_attention_plain(q, k, v, causal=True, window=cfg.window),
        torch.bfloat16,
        f"flash_attention bf16 {cfg.name} (B={b}, H={cfg.num_heads}, "
        f"Hkv={cfg.num_kv_heads}, S={MOE_SEQ}, Dh={cfg.resolved_head_dim}, "
        f"causal, window {cfg.window})")
    del q, k, v, got
    torch.cuda.empty_cache()
    return err


def hold_witnesses(model, tokens, cfg, plain, kernel) -> dict:
    """Where the bf16 kernel forward's distance from the einsum forward
    (``kernel``, ``plain``: their logits) comes from, by two witness
    forwards with one kernel each.  Plain attention with the kernel's
    experts routes as the einsum forward does (its routers see the same
    inputs up to the experts' own rounding, none at all in one layer), so
    it must equal the einsum forward at the logits' scale
    (``hold_at_scale``); flash attention with einsum experts routes as
    the kernel forward does and must equal it likewise.  What is left,
    the flash-attention witness's distance from the einsum forward, is
    attention's rounding moving routers; returns the distances."""
    xla = ParallelCtx(None)
    experts, _, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=False, experts=True,
        what="witness: plain attention, kernel experts")
    hold_at_scale(experts, plain, "plain attention with kernel experts vs "
                  "the einsum forward")
    e_rel, _ = logit_distance(experts, plain, "plain attention with kernel "
                              "experts vs the einsum forward")
    del experts
    attn, _, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=True, experts=False,
        what="witness: flash attention, einsum experts")
    hold_at_scale(kernel, attn, "the kernel forward vs flash attention with "
                  "einsum experts")
    a_rel, a_share = logit_distance(attn, plain, "flash attention with "
                                    "einsum experts vs the einsum forward")
    del attn
    torch.cuda.empty_cache()
    return dict(experts_rel=e_rel, attention_rel=a_rel,
                attention_share=a_share)


def card_model(cfg):
    """``cfg``'s model on the card, from ``init_model`` (seed 0)."""
    t0 = time.perf_counter()
    model = init_model(cfg, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    count = sum(p.numel() for p in model.parameters())
    log(f"  init_model({cfg.name}, {cfg.num_layers} layers) on the card: "
        f"{time.perf_counter() - t0:.2f} s, {count / 1e9:.3f} B parameters, "
        f"{weights / 2**30:.2f} GiB of weights")
    return model


def prompt_tokens(cfg, b: int, seed: int, s: int = MOE_SEQ) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator(
                             device=DEVICE).manual_seed(seed),
                         device=DEVICE)


def phase_moe() -> dict:
    """[moe] mixtral-8x7b and kimi-k2 at full width through
    ``forward(use_kernel=True)``; returns their numbers."""
    xla = ParallelCtx(None)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    out = {}
    base = get_config(MOE_ARCH)
    log(f"[moe] {base.name} at full width: d_model {base.d_model}, "
        f"{base.moe.num_experts} experts of d_ff {base.moe.d_ff}, top-"
        f"{base.moe.top_k}, heads {base.num_heads}/{base.num_kv_heads} (Dh "
        f"{base.resolved_head_dim}), window {base.window}, vocab "
        f"{base.vocab_size}, {base.dtype}; B={MOE_BATCH} S={MOE_SEQ}")
    # the hold: MOE_HOLD_LAYERS layers against their fp32 twin
    cfg = dataclasses.replace(base, num_layers=MOE_HOLD_LAYERS)
    out["mixtral_attention"] = hold_moe_attention(cfg, MOE_BATCH, gen)
    model = card_model(cfg)
    tokens = prompt_tokens(cfg, MOE_BATCH, SEED + 10)
    model32, cfg32 = fp32_twin(model, cfg)
    ref32, _, _, _ = run_forward(
        model32, tokens, cfg32, xla, use_kernel=False,
        what=f"fp32 forward(use_kernel=False), {MOE_HOLD_LAYERS} layers")
    del model32
    torch.cuda.empty_cache()
    plain, _, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=False,
        what=f"bf16 forward(use_kernel=False), {MOE_HOLD_LAYERS} layers")
    rel_p, share_p = logit_distance(plain, ref32,
                                    "bf16 einsum forward vs fp32 forward")
    got, _, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what=f"bf16 forward(use_kernel=True), {MOE_HOLD_LAYERS} layers")
    rel, share = logit_distance(got, ref32,
                                "bf16 kernel forward vs fp32 forward")
    hold(rel <= LM_BF16_REL_RATIO * rel_p
         and share >= share_p - LM_BF16_AGREE_DROP,
         f"bf16 kernel forward vs fp32 forward: no further than "
         f"{LM_BF16_REL_RATIO} x the einsum forward's {rel_p:.6g}, argmax "
         f"within {LM_BF16_AGREE_DROP} of its {share_p:.6f}")
    del ref32
    out["hold"] = dict(rel=rel, share=share, rel_plain=rel_p,
                       share_plain=share_p,
                       **hold_witnesses(model, tokens, cfg, plain, got))
    del got, plain, model
    torch.cuda.empty_cache()
    # the depth-cut model: walls, memory, greedy tokens, the kernels
    cfg = dataclasses.replace(base, num_layers=MOE_LAYERS)
    model = card_model(cfg)
    logits, cold, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what=f"forward(use_kernel=True), {MOE_LAYERS} layers, first call")
    for i in range(MOE_BATCH):
        if not torch.isfinite(logits[i]).all():
            raise AssertionError(f"{cfg.name}: non-finite logits")
    greedy = logits[:, -1].argmax(-1).tolist()
    log(f"  all logits finite; greedy next token of each prompt: {greedy}")
    del logits
    _, wall, counts, peak = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what=f"warm forward(use_kernel=True), {MOE_LAYERS} layers")
    out["mixtral"] = dict(cold=cold, wall=wall, peak=peak, launches=counts,
                          greedy=greedy,
                          layer_rel=hold_moe_layer(model, cfg, tokens))
    out["mixtral_times"] = moe_launches(model.units[0]["b0"].moe, cfg,
                                        MOE_BATCH, MOE_SEQ, gen, 10)
    del model
    torch.cuda.empty_cache()
    # kimi-k2: top-8 of 384 experts, a shared expert, heads of 112
    cfg = dataclasses.replace(get_config(KIMI_ARCH), num_layers=KIMI_LAYERS)
    log(f"[moe] {cfg.name} at full width, {KIMI_LAYERS} layer: d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts of d_ff "
        f"{cfg.moe.d_ff} + {cfg.moe.num_shared_experts} shared, top-"
        f"{cfg.moe.top_k}, heads {cfg.num_heads}/{cfg.num_kv_heads} (Dh "
        f"{cfg.resolved_head_dim}), vocab {cfg.vocab_size}; B={KIMI_BATCH} "
        f"S={MOE_SEQ}")
    out["kimi_attention"] = hold_moe_attention(cfg, KIMI_BATCH, gen)
    model = card_model(cfg)
    tokens = prompt_tokens(cfg, KIMI_BATCH, SEED + 11)
    plain, _, _, _ = run_forward(model, tokens, cfg, xla, use_kernel=False,
                                 what="bf16 forward(use_kernel=False)")
    logits, cold, _, _ = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what="bf16 forward(use_kernel=True), first call")
    k_rel, k_share = logit_distance(
        logits, plain, "bf16 kernel forward vs bf16 einsum forward")
    hold(k_share >= LM_BF16_PAIR_AGREE,
         f"bf16 kernel forward vs bf16 einsum forward: argmax agrees at "
         f"least at {LM_BF16_PAIR_AGREE} of positions (its distance is "
         f"held through the witnesses below)")
    greedy = logits[:, -1].argmax(-1).tolist()
    log(f"  greedy next token: {greedy}")
    witnesses = hold_witnesses(model, tokens, cfg, plain, logits)
    del plain, logits
    _, wall, counts, peak = run_forward(
        model, tokens, cfg, xla, use_kernel=True,
        what="warm forward(use_kernel=True)")
    out["kimi"] = dict(cold=cold, wall=wall, peak=peak, launches=counts,
                       greedy=greedy, rel=k_rel, share=k_share,
                       layer_rel=hold_moe_layer(model, cfg, tokens),
                       **witnesses)
    out["kimi_times"] = moe_launches(model.units[0]["b0"].moe, cfg,
                                     KIMI_BATCH, MOE_SEQ, gen, 5)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# [recurrent] and [frontends]


def hold_against_twin(model, inputs, cfg, forms, what: str) -> dict:
    """``forms``: (label, ctx, use_kernel, fp32 tolerance) of the forward,
    the first the yardstick's.  The fp32 twin of ``model`` runs each form;
    every other form must agree with the first on LM_FP32_AGREE of
    argmaxes and, where its tolerance is not None, equal it within that
    share of max |logit|.  Then in bf16 each other form must be no
    further from the fp32 first form than LM_BF16_REL_RATIO x the bf16
    first form is, its argmax agreement within LM_BF16_AGREE_DROP of that
    one's.  Returns the distances."""
    out = {}
    model32, cfg32 = fp32_twin(model, cfg)
    inputs32 = {k: (v.float() if k == "embeds" else v)  # exact
                for k, v in inputs.items()}
    label0, ctx0, kernel0, _ = forms[0]
    ref32, _, _, _ = run_forward(model32, inputs32, cfg32, ctx0,
                                 use_kernel=kernel0,
                                 what=f"{what} fp32 {label0}")
    for label, ctx, use_kernel, fp32_tol in forms[1:]:
        got, _, _, _ = run_forward(model32, inputs32, cfg32, ctx,
                                   use_kernel=use_kernel,
                                   what=f"{what} fp32 {label}")
        rel, share = logit_distance(got, ref32,
                                    f"fp32 {label} vs fp32 {label0}")
        hold((fp32_tol is None or rel <= fp32_tol)
             and share >= LM_FP32_AGREE,
             f"fp32 {label} vs fp32 {label0}: "
             + (f"within {fp32_tol} and " if fp32_tol is not None else "")
             + f"argmax at least {LM_FP32_AGREE}")
        out[f"fp32 {label}"] = (rel, share)
        del got
    del model32
    torch.cuda.empty_cache()
    first, _, _, _ = run_forward(model, inputs, cfg, ctx0, use_kernel=kernel0,
                                 what=f"{what} bf16 {label0}")
    rel_p, share_p = logit_distance(first, ref32,
                                    f"bf16 {label0} vs fp32 {label0}")
    out[f"bf16 {label0}"] = (rel_p, share_p)
    del first
    for label, ctx, use_kernel, _ in forms[1:]:
        got, _, _, _ = run_forward(model, inputs, cfg, ctx,
                                   use_kernel=use_kernel,
                                   what=f"{what} bf16 {label}")
        rel, share = logit_distance(got, ref32,
                                    f"bf16 {label} vs fp32 {label0}")
        hold(rel <= LM_BF16_REL_RATIO * rel_p
             and share >= share_p - LM_BF16_AGREE_DROP,
             f"bf16 {label} vs fp32 {label0}: no further than "
             f"{LM_BF16_REL_RATIO} x the bf16 {label0}'s {rel_p:.6g}, argmax "
             f"within {LM_BF16_AGREE_DROP} of its {share_p:.6f}")
        out[f"bf16 {label}"] = (rel, share)
        del got
    del ref32
    torch.cuda.empty_cache()
    return out


def hold_attention_call(cfg, b: int, s: int, gen) -> float:
    """``flash_attention`` at ``cfg``'s own attention call on ``b``
    prompts of ``s`` positions (its causality and window) against its
    plain version; returns the error."""
    q, k, v = attention_operands(cfg, b, s, gen)
    got = flash_attention_cuda(q, k, v, causal=cfg.causal, window=cfg.window)
    torch.cuda.synchronize()
    err = compare_attention(
        got, flash_attention_plain(q, k, v, causal=cfg.causal,
                                   window=cfg.window), torch.bfloat16,
        f"flash_attention bf16 {cfg.name} (B={b}, H={cfg.num_heads}, "
        f"Hkv={cfg.num_kv_heads}, S={s}, Dh={cfg.resolved_head_dim}, "
        f"{'causal' if cfg.causal else 'non-causal'}, window {cfg.window})")
    del q, k, v, got
    torch.cuda.empty_cache()
    return err


def depth_run(model, inputs, cfg, what: str) -> dict:
    """The kernel forward twice (first and warm): walls, peak, launches,
    finite logits and each prompt's greedy next token."""
    xla = ParallelCtx(None)
    logits, cold, _, _ = run_forward(model, inputs, cfg, xla, use_kernel=True,
                                     what=f"{what}, first call")
    for i in range(logits.shape[0]):
        if not torch.isfinite(logits[i]).all():
            raise AssertionError(f"{what}: non-finite logits")
    greedy = logits[:, -1].argmax(-1).tolist()
    log(f"  all logits finite; greedy next token of each prompt: {greedy}")
    del logits
    _, wall, counts, peak = run_forward(model, inputs, cfg, xla,
                                        use_kernel=True,
                                        what=f"{what}, warm")
    return dict(cold=cold, wall=wall, peak=peak, greedy=greedy,
                launches=counts["flash_attention"])


def event_ms(fn) -> float:
    """Elapsed device time of one call of ``fn`` between two CUDA events
    (idle time inside it included)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def continue_state(p, kind: str, cfg, x) -> tuple:
    """(the sequence form of block ``p`` over all of ``x`` at its last
    REC_STEPS positions, ``return_state`` over the rest then REC_STEPS
    tokens of ``*_step``)."""
    seq = {"rglru": rec.rglru_block, "mlstm": rec.mlstm_block,
           "slstm": rec.slstm_block}[kind]
    step = {"rglru": rec.rglru_step, "mlstm": rec.mlstm_step,
            "slstm": rec.slstm_step}[kind]
    ctx = ParallelCtx(None)
    s = x.shape[1] - REC_STEPS
    with torch.inference_mode():
        whole = seq(p, x, cfg, ctx)[:, s:]
        _, state = seq(p, x[:, :s], cfg, ctx, return_state=True)
        got = []
        for t in range(s, s + REC_STEPS):
            y, state = step(p, x[:, t], state, cfg)
            got.append(y)
    return whole, torch.stack(got, 1)


def state_continuation(p, kind: str, cfg, gen) -> dict:
    """``return_state`` over REC_STATE_SEQ tokens, then REC_STEPS tokens of
    ``*_step``, against the sequence form over all of them at those
    positions.  In an fp32 twin of the block the two must agree within
    LM_FP32_REL_TOL of max |output|; in bf16 the step form must lie within
    the bf16 tolerance (BF16_MAX_RTOL of max |output|) of the fp32
    sequence form, which is the truth both bf16 forms round away from
    (``*_step`` sums the conv in fp32 where the sequence form rounds each
    tap to bf16, as the reference's do, so the two bf16 forms differ by
    their roundings).  Returns the distances."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = type(p)(cfg32, dtype=torch.float32, device=DEVICE)
    params = dict(p.named_parameters())
    for name, q in p32.named_parameters():
        q.data.copy_(params[name])
    x = randn((REC_STATE_BATCH, REC_STATE_SEQ + REC_STEPS, cfg.d_model),
              torch.bfloat16, gen)
    what = (f"{cfg.name} {kind}: return_state over {REC_STATE_SEQ} tokens "
            f"+ {REC_STEPS} {kind}_step vs the sequence form over "
            f"{REC_STATE_SEQ + REC_STEPS}")
    whole32, step32 = continue_state(p32, kind, cfg32, x.float())
    del p32
    scale = whole32.abs().max().item()
    rel32 = (step32 - whole32).abs().max().item() / scale
    log(f"  {what}, fp32: {rel32:.6g} of max |output| {scale:.6g}")
    hold(rel32 <= LM_FP32_REL_TOL, f"fp32 within {LM_FP32_REL_TOL}")
    whole, step = continue_state(p, kind, cfg, x)
    rel_seq = (whole.float() - whole32).abs().max().item() / scale
    rel = (step.float() - whole32).abs().max().item() / scale
    log(f"  {what}, bf16: the step form {rel:.6g} and the sequence form "
        f"{rel_seq:.6g} of max |output| from the fp32 sequence form")
    hold(torch.isfinite(step).all().item() and rel <= BF16_MAX_RTOL,
         f"bf16 step form within {BF16_MAX_RTOL} of the fp32 sequence form")
    return dict(fp32=rel32, bf16=rel, bf16_sequence=rel_seq)


def mlstm_core_fp64(q, k, v, i_pre, f_pre) -> torch.Tensor:
    """The stabilized parallel mLSTM (the xLSTM paper's quadratic form)
    written here in float64, as the yardstick of the port's fp32 cores."""
    q, k, v = q.double(), k.double(), v.double()
    s, dh = q.shape[2], q.shape[3]
    cum_f = torch.cumsum(torch.nn.functional.logsigmoid(f_pre.double()), -1)
    dmat = cum_f[..., :, None] - cum_f[..., None, :] + i_pre.double()[..., None, :]
    dmat.masked_fill_(~torch.ones((s, s), dtype=torch.bool,
                                  device=q.device).tril(), -math.inf)
    m = dmat.amax(-1, keepdim=True)
    w = torch.exp(dmat.sub_(m))
    del dmat
    sw = torch.matmul(q, k.transpose(-1, -2)).mul_(w) / math.sqrt(dh)
    del w
    norm = torch.maximum(sw.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return torch.matmul(sw.div_(norm), v)


def hold_mlstm_core(cfg, b: int, s: int, gen) -> dict:
    """The chunkwise mLSTM core and the parallel one in fp32 at the
    model's call (B, H, S, Di/H), on draws as the reference's own test
    makes them (tests/test_perf_features.py::
    test_chunkwise_mlstm_matches_parallel: normal q, k, v and input gates,
    forget gates shifted by 2), against the parallel form in float64
    (``mlstm_core_fp64``): the chunkwise core must lie within the
    reference test's 1e-4 of max |output| of it, or no further than
    LM_BF16_REL_RATIO x the fp32 parallel core does (at S = 4096 the
    parallel form subtracts cumulative log-gates of ~500 in fp32).
    Returns the distances."""
    nh = cfg.num_heads
    dh = 2 * cfg.d_model // nh
    q, k, v = (torch.randn((b, nh, s, dh), generator=gen, device=DEVICE)
               for _ in range(3))
    i_pre = torch.randn((b, nh, s), generator=gen, device=DEVICE)
    f_pre = torch.randn((b, nh, s), generator=gen, device=DEVICE) + 2.0
    with torch.inference_mode():
        full = rec._mlstm_core(q, k, v, i_pre, f_pre)
        chunked = rec._mlstm_core_chunked(q, k, v, i_pre, f_pre, MLSTM_CHUNK)
        torch.cuda.empty_cache()
        want = mlstm_core_fp64(q, k, v, i_pre, f_pre)
    if not torch.isfinite(chunked).all():
        raise AssertionError("chunkwise mLSTM core: non-finite values")
    scale = want.abs().max().item()
    out = dict(parallel=(full.double() - want).abs().max().item() / scale,
               chunked=(chunked.double() - want).abs().max().item() / scale,
               pair=((full - chunked).abs().max() / full.abs().max()).item())
    log(f"  mLSTM core, fp32, B={b} H={nh} S={s} Dh={dh}: from the float64 "
        f"parallel core, parallel {out['parallel']:.6g} and chunkwise "
        f"({MLSTM_CHUNK}) {out['chunked']:.6g} of max |output|; chunkwise "
        f"vs parallel {out['pair']:.6g}")
    hold(out["chunked"] <= max(1e-4, LM_BF16_REL_RATIO * out["parallel"]),
         f"chunkwise mLSTM core within 1e-4 of the float64 core or no "
         f"further than {LM_BF16_REL_RATIO} x the parallel core")
    del q, k, v, full, chunked, want
    torch.cuda.empty_cache()
    return out


def walk_blocks(model, inputs, cfg, ctx, other, kinds, what: str) -> float:
    """``model`` block by block under ``ctx``; each block of ``kinds`` also
    runs under ``other`` on the same input and is held to the first at
    BF16_MAX_RTOL x max |output| (a chain of forwards in bf16 would
    compound each rounding that differs); returns the worst share."""
    worst = 0.0
    with torch.inference_mode():
        x = lm_model.embed_inputs(model, inputs, cfg, ctx)
        b, s = x.shape[:2]
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        blocks = [(kind, unit[f"b{j}"]) for unit in model.units
                  for j, kind in enumerate(cfg.block_pattern)]
        blocks += list(zip(cfg.tail, model.tail))
        for i, (kind, p) in enumerate(blocks):
            y, _ = lm_model.apply_block(kind, p, x, pos, cfg, ctx)
            if kind in kinds:
                z, _ = lm_model.apply_block(kind, p, x, pos, cfg, other)
                w = abs_worst(z, y)
                worst = max(worst, w)
                del z
            x = y
    log(f"  {what}: worst block at {worst:.4g} of {BF16_MAX_RTOL} x "
        f"max|output| -> {'ok' if worst <= 1 else 'OUT OF TOLERANCE'}")
    if worst > 1:
        raise AssertionError(f"{what}: out of tolerance")
    return worst


def abs_worst(got, want) -> float:
    """max |got - want| over BF16_MAX_RTOL x max|want|; raises on a
    non-finite value."""
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values")
    limit = BF16_MAX_RTOL * want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / limit


def phase_recurrent() -> dict:
    """[recurrent] recurrentgemma-9b and xlstm-1.3b at full width through
    ``forward(use_kernel=True)``; returns their numbers."""
    xla = ParallelCtx(None)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    out = {}
    base = get_config(RG_ARCH)
    log(f"[recurrent] {base.name} at full width: {base.num_layers} layers "
        f"(units {base.block_pattern} x {base.units} + tail {base.tail}), "
        f"d_model {base.d_model}, heads {base.num_heads}/{base.num_kv_heads} "
        f"(Dh {base.resolved_head_dim}), window {base.window}, d_ff "
        f"{base.d_ff}, vocab {base.vocab_size}, {base.dtype}; B={RG_BATCH} "
        f"S={REC_SEQ}")
    out["rg_attention"] = hold_attention_call(base, RG_BATCH, REC_SEQ, gen)
    out["rg_times"] = time_attention(base, RG_BATCH, REC_SEQ, 10)
    cfg = dataclasses.replace(base, num_layers=len(base.block_pattern))
    model = card_model(cfg)
    tokens = prompt_tokens(cfg, RG_BATCH, SEED + 13, REC_SEQ)
    summa = ParallelCtx(Grid.local(DEVICE), matmul_strategy="summa")
    out["rg_hold"] = hold_against_twin(
        model, {"tokens": tokens}, cfg,
        [("plain", xla, False, None), ("kernel", xla, True, LM_FP32_REL_TOL),
         ("summa kernel", summa, True, LM_FP32_REL_TOL)],
        f"{cfg.name} one unit")
    out["rglru_state"] = state_continuation(model.units[0]["b0"].rec,
                                            "rglru", cfg, gen)
    del model
    torch.cuda.empty_cache()
    model = card_model(base)
    out["rg"] = depth_run(model, {"tokens": tokens}, base,
                          f"{base.name} forward(use_kernel=True), "
                          f"{base.num_layers} layers")
    # where the time goes: one RG-LRU block, its scan alone, the forward
    with torch.inference_mode():
        x = model_layers.embed(model.embed, tokens)
        p = model.units[0]["b0"].rec
        block_ms = event_ms(lambda: rec.rglru_block(p, x, base, xla))
        a = torch.rand((RG_BATCH, REC_SEQ, base.d_model), generator=gen,
                       device=DEVICE)
        scan_ms = cuda_ms(lambda: rec.associative_scan(a, a), 5)
        del a
        fwd_ms = event_ms(lambda: forward(model, {"tokens": tokens}, base,
                                          xla, use_kernel=True))
    n_rglru = (base.units * base.block_pattern.count("rglru")
               + base.tail.count("rglru"))
    out["rg_profile"] = dict(block_ms=block_ms, scan_ms=scan_ms,
                             forward_ms=fwd_ms, n_rglru=n_rglru)
    log(f"  {base.name}: one RG-LRU sublayer {block_ms:.3f} ms (its "
        f"associative scan alone {scan_ms:.3f} ms), the forward "
        f"{fwd_ms:.3f} ms of device time; {n_rglru} RG-LRU sublayers "
        f"{n_rglru * block_ms / fwd_ms:.3f} of it, their scans "
        f"{n_rglru * scan_ms / fwd_ms:.3f}")
    del model, x
    torch.cuda.empty_cache()
    # xlstm-1.3b: no attention, so no kernel; the two mLSTM forms
    base = get_config(XL_ARCH)
    chunked = ParallelCtx(None, mlstm_chunk=MLSTM_CHUNK)
    log(f"[recurrent] {base.name} at full width: {base.num_layers} layers "
        f"(units {base.block_pattern} x {base.units}), d_model "
        f"{base.d_model}, {base.num_heads} heads, vocab {base.vocab_size}, "
        f"{base.dtype}; B={XL_BATCH} S={REC_SEQ}; mLSTM parallel and chunkwise "
        f"(mlstm_chunk={MLSTM_CHUNK})")
    cfg = dataclasses.replace(base, num_layers=len(base.block_pattern))
    model = card_model(cfg)
    tokens = prompt_tokens(cfg, XL_BATCH, SEED + 14, REC_SEQ)
    out["xl_hold"] = hold_against_twin(
        model, {"tokens": tokens}, cfg,
        [("parallel mLSTM", xla, True, None),
         ("chunkwise mLSTM", chunked, True, None)],
        f"{cfg.name} one unit")
    out["mlstm_core"] = hold_mlstm_core(cfg, XL_BATCH, REC_SEQ, gen)
    out["mlstm_state"] = state_continuation(model.units[0]["b0"].rec,
                                            "mlstm", cfg, gen)
    out["slstm_state"] = state_continuation(model.units[0]["b7"].rec,
                                            "slstm", cfg, gen)
    del model
    torch.cuda.empty_cache()
    model = card_model(base)
    out["xl"] = depth_run(model, {"tokens": tokens}, base,
                          f"{base.name} forward, parallel mLSTM, "
                          f"{base.num_layers} layers")
    _, wall, _, peak = run_forward(
        model, tokens, base, chunked, use_kernel=True,
        what=f"{base.name} forward, chunkwise mLSTM ({MLSTM_CHUNK}), "
             f"{base.num_layers} layers")
    out["xl_chunked"] = dict(wall=wall, peak=peak)
    out["xl_walk"] = walk_blocks(
        model, {"tokens": tokens}, base, xla, chunked, ("mlstm",),
        f"{base.name}: each of {base.units * 7} mLSTM blocks chunkwise vs "
        f"parallel on the parallel stream's input")
    with torch.inference_mode():
        x = model_layers.embed(model.embed, tokens)
        p = model.units[0]["b7"].rec
        slstm_ms = event_ms(lambda: rec.slstm_block(p, x, base, xla))
        p = model.units[0]["b0"].rec
        mlstm_ms = event_ms(lambda: rec.mlstm_block(p, x, base, xla))
        mlstm_chunk_ms = event_ms(lambda: rec.mlstm_block(p, x, base,
                                                          chunked))
        fwd_ms = event_ms(lambda: forward(model, {"tokens": tokens}, base,
                                          xla))
    n_slstm = base.units * base.block_pattern.count("slstm")
    out["xl_profile"] = dict(slstm_ms=slstm_ms, mlstm_ms=mlstm_ms,
                             mlstm_chunk_ms=mlstm_chunk_ms,
                             forward_ms=fwd_ms, n_slstm=n_slstm)
    log(f"  {base.name}: one sLSTM block {slstm_ms:.3f} ms ({REC_SEQ} cell "
        f"steps), one mLSTM block {mlstm_ms:.3f} ms parallel / "
        f"{mlstm_chunk_ms:.3f} ms chunkwise, the forward {fwd_ms:.3f} ms of "
        f"device time; {n_slstm} sLSTM loops {n_slstm * slstm_ms / fwd_ms:.3f}"
        f" of it")
    del model, x
    torch.cuda.empty_cache()
    return out


def mrope_positions(batch: int, s_vis: int, s_text: int) -> torch.Tensor:
    """(B, S, 3) t/h/w positions: vision patches on a ~square grid, text
    sequential after the vision span (the reference's rule for its VLM
    data, Qwen2-VL's scheme simplified)."""
    side = max(int(math.isqrt(s_vis)), 1)
    idx = torch.arange(s_vis)
    vis = torch.stack([torch.zeros_like(idx), idx // side, idx % side], -1)
    start = int(vis.max()) + 1 if s_vis else 0
    txt = (start + torch.arange(s_text))[:, None].expand(s_text, 3)
    pos = torch.cat([vis, txt], 0)
    return pos[None].expand(batch, -1, -1).contiguous().to(DEVICE)


def vlm_inputs(cfg, b: int, gen) -> dict:
    """VLM_PATCHES stub patch embeddings (N(0, 1), bf16) before
    FRONT_SEQ - VLM_PATCHES tokens, with their (t, h, w) streams."""
    s_text = FRONT_SEQ - VLM_PATCHES
    tokens = torch.randint(0, cfg.vocab_size, (b, s_text), generator=gen,
                           device=DEVICE)
    return {"embeds": randn((b, VLM_PATCHES, cfg.d_model), torch.bfloat16,
                            gen),
            "tokens": tokens,
            "positions": mrope_positions(b, VLM_PATCHES, s_text)}


def phase_frontends() -> dict:
    """[frontends] hubert-xlarge and qwen2-vl-72b through
    ``forward(use_kernel=True)``; returns their numbers."""
    xla = ParallelCtx(None)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    out = {}
    cfg = get_config(HUBERT_ARCH)
    log(f"[frontends] {cfg.name} at full width and depth: {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} (Dh {cfg.resolved_head_dim}), non-causal, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; B={HUBERT_BATCH} x {FRONT_SEQ} "
        f"frame embeddings")
    out["hubert_attention"] = hold_attention_call(cfg, HUBERT_BATCH,
                                                  FRONT_SEQ, gen)
    out["hubert_times"] = time_attention(cfg, HUBERT_BATCH, FRONT_SEQ, 10)
    model = card_model(cfg)
    inputs = {"embeds": randn((HUBERT_BATCH, FRONT_SEQ, cfg.d_model),
                              torch.bfloat16, gen)}
    out["hubert_hold"] = hold_against_twin(
        model, inputs, cfg, [("plain", xla, False, None),
                             ("kernel", xla, True, LM_FP32_REL_TOL)],
        cfg.name)
    out["hubert"] = depth_run(model, inputs, cfg,
                              f"{cfg.name} forward(use_kernel=True)")
    del model, inputs
    torch.cuda.empty_cache()
    base = get_config(VLM_ARCH)
    log(f"[frontends] {base.name} at full width: d_model {base.d_model}, "
        f"heads {base.num_heads}/{base.num_kv_heads} (Dh "
        f"{base.resolved_head_dim}), d_ff {base.d_ff}, vocab "
        f"{base.vocab_size}, M-RoPE; {VLM_PATCHES} patch embeddings + "
        f"{FRONT_SEQ - VLM_PATCHES} tokens, B={VLM_BATCH}")
    out["vlm_attention"] = hold_attention_call(base, VLM_BATCH, FRONT_SEQ,
                                               gen)
    out["vlm_times"] = time_attention(base, VLM_BATCH, FRONT_SEQ, 10)
    cfg = dataclasses.replace(base, num_layers=VLM_HOLD_LAYERS)
    model = card_model(cfg)
    inputs = vlm_inputs(cfg, VLM_BATCH, gen)
    out["vlm_hold"] = hold_against_twin(
        model, inputs, cfg, [("plain", xla, False, None),
                             ("kernel", xla, True, LM_FP32_REL_TOL)],
        f"{cfg.name} {VLM_HOLD_LAYERS} layers")
    # text only: three equal position streams make M-RoPE RoPE
    tokens = inputs["tokens"][:, :FRONT_SEQ - VLM_PATCHES]
    pos = torch.arange(tokens.shape[1], device=DEVICE)[None].expand(
        VLM_BATCH, -1)
    mrope, _, _, _ = run_forward(
        model, {"tokens": tokens, "positions": pos[..., None].expand(
            -1, -1, 3)}, cfg, xla, use_kernel=True,
        what="text only, three equal streams, M-RoPE")
    rope, _, _, _ = run_forward(
        model, {"tokens": tokens, "positions": pos},
        dataclasses.replace(cfg, rope="rope"), xla, use_kernel=True,
        what="text only, the same model under RoPE")
    out["vlm_text_equal"] = torch.equal(mrope, rope)
    hold(out["vlm_text_equal"], "M-RoPE with equal streams equals RoPE "
         "bitwise")
    del model, mrope, rope
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, num_layers=VLM_LAYERS)
    model = card_model(cfg)
    out["vlm"] = depth_run(model, inputs, cfg,
                           f"{cfg.name} forward(use_kernel=True), "
                           f"{VLM_LAYERS} layers")
    del model, inputs
    torch.cuda.empty_cache()
    return out


# -- [serve] ---------------------------------------------------------------

#: every kernel's plain version where the wrappers and the attention layer
#: reach it: [serve] makes each raise on a CUDA tensor
PLAIN_VERSIONS = ((kops, "tiled_matmul_plain"), (kops, "bsmm_plain"),
                  (kops, "grouped_gemm_plain"),
                  (kops, "flash_attention_plain"),
                  (attention_layer, "flash_attention_plain"),
                  (bsmm_kernel, "tiled_matmul_plain"))


@contextlib.contextmanager
def plain_guard(versions=PLAIN_VERSIONS, phase: str = "[serve]"):
    """Inside: each of ``versions`` (module, name of a kernel's plain
    version) called with a CUDA tensor raises, so the path is shown to
    launch the kernels and nothing else."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in versions]

    def guard(fn, name):
        def run(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise AssertionError(f"{phase}: {name} ran on a CUDA tensor")
            return fn(*args, **kw)
        return run

    for mod, name, fn in saved:
        setattr(mod, name, guard(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def zero_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def hold_counts(counts: dict, want: dict, what: str) -> None:
    """Raises unless every kernel launched exactly ``want`` times (none
    for a kernel ``want`` does not name)."""
    hold(all(n == want.get(name, 0) for name, n in counts.items()),
         f"{what}: launches {counts}, expected {want} and no other kernel")


def serve_main(argv: list, what: str) -> tuple:
    """``launch.serve.main(argv)`` on the card inside the [serve]
    ``plain_guard``, every count set to 0 just before and read just after;
    its printed lines echoed.  Returns (its result, its text, counts, peak bytes)."""
    buf = io.StringIO()
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with plain_guard(PLAIN_VERSIONS, "[serve]"), \
            contextlib.redirect_stdout(buf):
        result = launch_serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = read_counts(), torch.cuda.max_memory_allocated()
    text = buf.getvalue()
    log(f"  {what}: python -m repro_torch.launch.serve {' '.join(argv)}")
    for line in text.splitlines():
        log(f"    | {line}")
    log(f"    launches {counts}; whole call {wall:.3f} s (model init "
        f"included); peak device memory {peak / 2**30:.2f} GiB")
    return result, text, counts, peak


def fixed_walls(text: str) -> tuple[float, float]:
    """(prefill s, decode s) from ``launch.serve``'s ``wall:`` line."""
    m = re.search(r"wall: prefill ([0-9.]+) s, decode ([0-9.]+) s", text)
    if m is None:
        raise AssertionError("launch.serve printed no wall line")
    return float(m.group(1)), float(m.group(2))


def cut_twin(model, cfg, layers: int):
    """An fp32 copy of ``model``'s first ``layers`` layers (exact)."""
    cut = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
    twin = LM(cut, device=DEVICE)
    params = dict(model.named_parameters())
    for name, p in twin.named_parameters():
        p.data.copy_(params[name])
    return twin, cut


def engine_steps(model, cfg, tokens, what: str) -> torch.Tensor:
    """Prefill ``tokens`` less the last SERVE_HOLD_STEPS, then one decode
    step on each of those, through the engine on the card (under the
    [serve] ``plain_guard``): one ``flash_attention`` launch per
    attention block in the prefill, none in decode.  Returns the logits of the
    prefill's last position and of each step, (B, 1 + steps, V)."""
    xla = ParallelCtx(None)
    total = tokens.shape[1]
    p = total - SERVE_HOLD_STEPS
    with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[serve]"):
        zero_counts()
        logits, cache = serve_engine.prefill(model, {"tokens": tokens[:, :p]},
                                             cfg, xla, max_len=total)
        hold_counts(read_counts(),
                    {"flash_attention": attention_blocks(cfg)},
                    f"{what}: prefill of {p} tokens")
        steps = [logits]
        zero_counts()
        for t in range(SERVE_HOLD_STEPS):
            logits, cache = serve_engine.decode_step(model, cache,
                                                     tokens[:, p + t], cfg,
                                                     xla)
            steps.append(logits)
        torch.cuda.synchronize()
        hold_counts(read_counts(), {}, f"{what}: {SERVE_HOLD_STEPS} decode "
                    "steps")
    return torch.stack(steps, dim=1)


def hold_engine_twin(model, cfg, gen, what: str) -> float:
    """The engine on an fp32 twin of ``model`` cut to one unit, held
    against ``forward`` (plain attention) of the whole sequence at each
    position, at the reference's serving hold (tests/test_serve.py):
    atol max(2e-3 x max|logit|, 1e-3), rtol 0.01.  Returns the worst
    element's share of its limit."""
    layers = SERVE_HOLD_LAYERS[cfg.name]
    twin, cut = cut_twin(model, cfg, layers)
    total = SERVE_PROMPT + SERVE_HOLD_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_HOLD_BATCH, total),
                           generator=gen, device=DEVICE)
    with torch.inference_mode():
        full, _ = forward(twin, {"tokens": tokens}, cut, ParallelCtx(None),
                          use_kernel=False)
        want = full[:, SERVE_PROMPT - 1:].clone()
        del full
    got = engine_steps(twin, cut, tokens, f"{what} fp32 twin, {layers} "
                       "layers")
    scale = want.abs().max().item()
    atol = max(2e-3 * scale, 1e-3)
    share = ((got - want).abs() / (atol + 0.01 * want.abs())).amax(
        dim=(0, 2)).tolist()
    log(f"  {what} fp32 twin ({layers} layers), B={SERVE_HOLD_BATCH}: engine "
        f"against forward(use_kernel=False) of the whole {total} tokens; "
        f"worst element's share of the hold (atol {atol:.4g}, rtol 0.01) at "
        f"the prefill's last position and each decode step: "
        + ", ".join(f"{x:.4g}" for x in share))
    hold(torch.isfinite(got).all().item() and max(share) <= 1,
         f"{what}: prefill and {SERVE_HOLD_STEPS} decode steps equal the "
         "forward of the whole sequence")
    del twin, got, want
    torch.cuda.empty_cache()
    return max(share)


def twin_forward(model, cfg, tokens) -> torch.Tensor:
    """The logits of ``forward`` (plain attention) of ``model``'s fp32
    twin on ``tokens``.  Where the twin (twice the bf16 weights) would not
    fit beside the model, the model waits in host memory meanwhile."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    park = 3 * weights > 0.8 * torch.cuda.get_device_properties(0).total_memory
    if park:
        model.to("cpu")
        torch.cuda.empty_cache()
    twin, cfg32 = fp32_twin(model, cfg)
    with torch.inference_mode():
        logits, _ = forward(twin, {"tokens": tokens}, cfg32,
                            ParallelCtx(None), use_kernel=False)
    del twin
    torch.cuda.empty_cache()
    if park:
        model.to(DEVICE)
        log(f"  (the bf16 model, {weights / 2**30:.2f} GiB, waited in host "
            f"memory while its fp32 twin ran)")
    return logits


def hold_engine_depth(model, cfg, gen, what: str) -> dict:
    """At full depth in bf16, one prompt, at the prefill's last position
    and each decode step:

    * the engine against the bf16 ``forward(use_kernel=True)`` of the
      whole sequence: max |difference| / max |logit| of that forward
      within ENGINE_PAIR_TOL.  The forward's logits one position earlier
      (what a step that reads the wrong position gives) must fail that at
      every position, so each run shows the check can fail;
    * each step's distance from the fp32 twin's forward (max |difference|
      / max |logit| of the twin), printed beside the bf16 forward's own
      there, no larger than LM_BF16_REL_RATIO x the forward's (phase 8's
      margin).  Where bf16 alone moves the logits by their own scale, as
      in mixtral's 8 random layers, this one cannot tell a fault."""
    xla = ParallelCtx(None)
    total = SERVE_PROMPT + SERVE_HOLD_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen,
                           device=DEVICE)
    ref32 = twin_forward(model, cfg, tokens)
    with torch.inference_mode():
        bf16, _ = forward(model, {"tokens": tokens}, cfg, xla,
                          use_kernel=True)
    rel_fwd, _ = logit_distance(bf16, ref32, f"{what} bf16 forward(use_kernel"
                                "=True) vs fp32 twin, whole sequence")
    scale = ref32.abs().max().item()
    scale16 = bf16.abs().max().item()
    want = ref32[:, SERVE_PROMPT - 1:].clone()
    fwd = bf16[:, SERVE_PROMPT - 1:].clone()
    prev = bf16[:, SERVE_PROMPT - 2:-1].clone()
    del ref32, bf16
    torch.cuda.empty_cache()
    got = engine_steps(model, cfg, tokens, f"{what} bf16, full depth")
    pair = ((got - fwd).abs().amax(dim=(0, 2)) / scale16).tolist()
    shift = ((prev - fwd).abs().amax(dim=(0, 2)) / scale16).tolist()
    agree = float((got.argmax(-1) == fwd.argmax(-1)).float().mean())
    eng = ((got - want).abs().amax(dim=(0, 2)) / scale).tolist()
    own = ((fwd - want).abs().amax(dim=(0, 2)) / scale).tolist()
    log(f"  {what} bf16 at full depth, at the prefill's last position and "
        f"each decode step: the engine's distance from the bf16 forward "
        f"(share of its max |logit| {scale16:.6g}) "
        + ", ".join(f"{x:.4g}" for x in pair)
        + f", argmax agreeing at {agree:.4g}; the forward one position "
        f"earlier "
        + ", ".join(f"{x:.4g}" for x in shift)
        + f"; distance from the fp32 twin's forward (share of max |logit| "
        f"{scale:.6g}): engine "
        + ", ".join(f"{x:.4g}" for x in eng) + "; bf16 forward "
        + ", ".join(f"{x:.4g}" for x in own))
    hold(max(pair) <= ENGINE_PAIR_TOL, f"{what}: the bf16 engine within "
         f"{max(pair):.4g} of the bf16 forward's max |logit| at every "
         f"position (<= {ENGINE_PAIR_TOL})")
    hold(min(shift) > ENGINE_PAIR_TOL, f"{what}: the forward one position "
         f"earlier at least {min(shift):.4g} from it (> {ENGINE_PAIR_TOL}: "
         "the check fails a step at the wrong position)")
    hold(all(e <= LM_BF16_REL_RATIO * o for e, o in zip(eng, own)),
         f"{what}: the bf16 engine no further from the fp32 twin than "
         f"{LM_BF16_REL_RATIO} x the bf16 forward at each position (the "
         f"forward's {rel_fwd:.6g} over the whole sequence)")
    del got, want, fwd, prev
    torch.cuda.empty_cache()
    return dict(engine=max(eng), forward=rel_fwd, pair=max(pair),
                shift=min(shift), agree=agree)


def serial_outputs(model, cfg, reqs) -> dict:
    """Each request alone through the engine, batch 1: prefill, then
    greedy decode (the reference's yardstick for the scheduler)."""
    xla = ParallelCtx(None)
    out = {}
    max_len = SERVE_PROMPT + SERVE_GEN
    with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[serve]"):
        for r in reqs:
            prompt = torch.as_tensor(r.prompt.astype(np.int64),
                                     device=DEVICE)[None]
            logits, cache = serve_engine.prefill(model, {"tokens": prompt},
                                                 cfg, xla, max_len=max_len)
            tok = logits.argmax(-1)
            toks = [tok]
            for _ in range(r.max_new_tokens - 1):
                logits, cache = serve_engine.decode_step(model, cache, tok,
                                                         cfg, xla)
                tok = logits.argmax(-1)
                toks.append(tok)
            out[r.rid] = torch.cat(toks).tolist()
    return out


def serve_trace(cfg) -> list:
    """``launch.serve``'s ragged trace of ``--continuous`` (launch.serve)."""
    return ragged_trace(4 * SERVE_BATCH,
                        prompt_lens=(SERVE_PROMPT // 2, SERVE_PROMPT),
                        gen_lens=(SERVE_GEN // 4, SERVE_GEN),
                        vocab=cfg.vocab_size, seed=SEED)


def agreement(got: dict, want: dict) -> float:
    """Share of generated tokens equal position by position."""
    same = total = 0
    for rid, toks in want.items():
        total += len(toks)
        same += sum(a == b for a, b in zip(got[rid], toks))
    return same / total


def hold_scheduler_twin(model, cfg) -> None:
    """Continuous (and paged, for an arch without a window) on the fp32
    twin cut to one unit: the tokens of every request equal the serial
    per-request loop's."""
    twin, cut = cut_twin(model, cfg, SERVE_HOLD_LAYERS[cfg.name])
    want = serial_outputs(twin, cut, serve_trace(cut))
    # paged serving is for archs without a window, as in the reference
    for backend in ("dense",) if cfg.window else ("dense", "paged"):
        with torch.inference_mode(), \
                plain_guard(PLAIN_VERSIONS, "[serve]"):
            res = Scheduler(twin, cut, ParallelCtx(None),
                            n_slots=SERVE_BATCH,
                            max_len=SERVE_PROMPT + SERVE_GEN,
                            backend=backend).run(serve_trace(cut))
        hold(res["outputs"] == want,
             f"fp32 twin ({cut.num_layers} layers): continuous[{backend}] "
             f"tokens equal the serial per-request loop's, request by "
             f"request ({res['generated_tokens']} tokens, {res['steps']} "
             "steps)")
    del twin
    torch.cuda.empty_cache()


def cache_bytes(cache) -> int:
    """Bytes a serving cache's tensors hold."""
    sizes = []
    serve_engine.map_cache(
        lambda _, x: sizes.append(x.numel() * x.element_size()), cache)
    return sum(sizes)


def own_quantize(x: torch.Tensor) -> tuple:
    """Absmax int8 quantization of the last axis, written here."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-6) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127), s


def hold_kv_quant_step(cache, cfg, gen) -> float:
    """One decode-attention step on the first layer's int8 cache (a copy)
    against an attention over the cache dequantized here, in float64,
    the new token quantized here and written at its slot; fp32 hold."""
    b, hkv, s_c, dh = cache["units"]["b0"]["k"][0].shape
    kq, vq, ks, vs = (cache["units"]["b0"][n][0].clone()
                      for n in ("k", "v", "k_s", "v_s"))
    q = torch.randn((b, cfg.num_heads, dh), generator=gen, device=DEVICE)
    k_new = torch.randn((b, hkv, 1, dh), generator=gen, device=DEVICE)
    v_new = torch.randn((b, hkv, 1, dh), generator=gen, device=DEVICE)
    slot = torch.full((b,), SERVE_PROMPT, dtype=torch.int64, device=DEVICE)
    ctx = ParallelCtx(Grid.local(DEVICE), kv_quant=True)
    k = kq.double() * ks.double()
    v = vq.double() * vs.double()
    for buf, new in ((k, k_new), (v, v_new)):
        nq, ns = own_quantize(new.double())
        buf[:, :, SERVE_PROMPT] = (nq * ns)[:, :, 0]
    with torch.inference_mode():
        got = serve_engine._decode_attention(q, k_new, v_new, kq, vq, slot,
                                             slot + 1, ctx, ks, vs)[0]
    g = cfg.num_heads // hkv
    qg = q.double().reshape(b, hkv, g, dh) / math.sqrt(dh)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, :SERVE_PROMPT + 1])
    want = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(scores, -1),
                        v[:, :, :SERVE_PROMPT + 1]).reshape(b, -1, dh)
    return compare_attention(got, want.float(), torch.float32,
                             "kv_quant decode attention (int8 cache, first "
                             "layer) vs float64 attention over the cache "
                             "dequantized here")


def phase_serve() -> dict:
    """[serve] the serving path on the card; returns its numbers."""
    out = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    cfg = get_config(LM_ARCH)
    max_len = SERVE_PROMPT + SERVE_GEN
    fixed = ["--arch", LM_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
             str(SERVE_PROMPT), "--gen", str(SERVE_GEN)]
    log(f"[serve] {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, vocab {cfg.vocab_size}), bf16, init_model seed {SEED}: "
        f"{SERVE_BATCH} x {SERVE_PROMPT} prompts, {SERVE_GEN} tokens each")
    n_attn = attention_blocks(cfg)
    runs = {}
    for label in ("first", "warm"):
        tokens, text, counts, peak = serve_main(fixed, f"fixed batch, {label}")
        hold_counts(counts, {"flash_attention": n_attn},
                    f"fixed batch ({label}): one prefill")
        hold(tokens.shape == (SERVE_BATCH, SERVE_GEN)
             and int(tokens.min()) >= 0
             and int(tokens.max()) < cfg.vocab_size,
             f"fixed batch ({label}): {tokens.shape} in-vocab tokens")
        runs[label] = dict(tokens=tokens, walls=fixed_walls(text), peak=peak)
    hold(np.array_equal(runs["first"]["tokens"], runs["warm"]["tokens"]),
         "the warm call generates the first call's tokens")
    out["fixed"] = runs
    # summa: every FFN projection through DistributedMatmul, whose local
    # products are torch.matmul (local_matmul "xla", as the reference's)
    # on an empty autotune cache; then with the cache naming the kernel
    # for the projections' panel buckets (warm_kernel_cache)
    projections = 3 * cfg.num_layers * SERVE_GEN  # one run per call
    out["summa"] = {}
    for label in ("cold autotune cache", "tiled_matmul on the autotune "
                  "cache"):
        set_autotune_cache(None)
        kernel = label.startswith("tiled")
        if kernel:
            buckets = serve_engine.warm_kernel_cache(
                cfg, ParallelCtx(Grid.local(DEVICE), matmul_strategy="summa"),
                SERVE_BATCH, SERVE_PROMPT, routes=("pallas",))
            set_plan_service(None)
            log(f"  warm_kernel_cache(routes=('pallas',)): buckets {buckets}")
        hits = core_summa.executable_cache_stats()["hits"]
        tokens, text, counts, _ = serve_main(
            fixed + ["--matmul-strategy", "summa"], f"fixed batch, summa, "
            f"{label}")
        hits = core_summa.executable_cache_stats()["hits"] - hits
        set_autotune_cache(None)
        hold(counts["flash_attention"] == n_attn
             and (counts["tiled_matmul"] > 0) == kernel
             and counts["bsmm"] == counts["grouped_gemm"] == 0
             and hits >= projections,
             f"summa, {label}: {n_attn} flash_attention launches, "
             f"tiled_matmul {counts['tiled_matmul']}, {hits} engine runs "
             f"(at least {projections}: every FFN projection of the prefill "
             f"and of each step)")
        out["summa"][label] = dict(
            walls=fixed_walls(text), launches=counts["tiled_matmul"],
            agree=float((tokens == runs["warm"]["tokens"]).mean()))
        log(f"  summa ({label}) tokens agree with the xla route's at "
            f"{out['summa'][label]['agree']:.4f} of positions (bf16; not "
            "held)")
    plans = ROOT / "build" / "serve_plans.json"
    plans.parent.mkdir(parents=True, exist_ok=True)
    plans.unlink(missing_ok=True)
    stats = []
    for label in ("cold", "warm"):
        set_plan_service(None)  # each run starts as a fresh process does
        _, text, counts, _ = serve_main(
            fixed + ["--matmul-strategy", "auto", "--plan-cache",
                     str(plans)], f"fixed batch, auto, plan cache {label}")
        m = re.search(r"tunes=(\d+) hits=(\d+)", text)
        stats.append((int(m.group(1)), int(m.group(2))))
        hold_counts(counts, {"flash_attention": n_attn},
                    f"auto ({label}): one prefill")
    hold(stats[0][0] == 4 and stats[1] == (0, 4),
         f"plan cache: the cold run tunes every shape ({stats[0]}), the warm "
         f"run tunes none and hits all four ({stats[1]})")
    plans.unlink(missing_ok=True)
    set_plan_service(None)
    trace_out = {}
    for backend in ("dense", "paged"):
        flags = ["--continuous"] + (["--paged"] if backend == "paged" else [])
        res, _, counts, peak = serve_main(fixed + flags,
                                          f"continuous[{backend}]")
        hold_counts(counts, {"flash_attention": n_attn * res["prefills"]},
                    f"continuous[{backend}]: {res['prefills']} prefills")
        trace_out[backend] = dict(res, peak=peak)
    out["continuous"] = trace_out
    model = card_model(cfg)
    serial = serial_outputs(model, cfg, serve_trace(cfg))
    for backend, res in trace_out.items():
        res["agree"] = agreement(res["outputs"], serial)
        log(f"  bf16 continuous[{backend}] tokens agree with the serial "
            f"per-request loop's at {res['agree']:.4f} (not held: in bf16 a "
            f"greedy path parts where another order of fp32 sums rounds a "
            f"near-tie the other way)")
    inputs = launch_serve.prompt_inputs(cfg, SERVE_BATCH, SERVE_PROMPT,
                                        DEVICE)
    ctxq = ParallelCtx(Grid.local(DEVICE), kv_quant=True)
    with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[serve]"):
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = serve_engine.prefill(model, inputs, cfg, ctxq,
                                             max_len=max_len)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        out["kv_quant_attention"] = hold_kv_quant_step(cache, cfg, gen)
        toks = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN - 1):
            logits, cache = serve_engine.decode_step(model, cache, tok, cfg,
                                                     ctxq)
            tok = logits.argmax(-1)
            toks.append(tok)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    hold_counts(read_counts(), {"flash_attention": n_attn},
                "kv_quant: one prefill")
    quant_tokens = torch.stack(toks, 1).cpu().numpy()
    bf16_bytes = cache_bytes(serve_engine.init_cache(
        cfg, SERVE_BATCH, max_len, device="meta"))
    out["kv_quant"] = dict(
        walls=(t_pre, t_dec), peak=torch.cuda.max_memory_allocated(),
        bytes=cache_bytes(cache), bf16_bytes=bf16_bytes,
        agree=float((quant_tokens == runs["warm"]["tokens"]).mean()))
    log(f"  kv_quant fixed batch: prefill {t_pre:.4f} s, decode {t_dec:.4f} s "
        f"over {SERVE_GEN - 1} steps; cache {out['kv_quant']['bytes']:,} "
        f"bytes against bf16's {bf16_bytes:,}; peak "
        f"{out['kv_quant']['peak'] / 2**30:.2f} GiB; tokens agree with the "
        f"bf16 cache's at {out['kv_quant']['agree']:.4f} (not held)")
    del cache, logits
    out["twin"] = hold_engine_twin(model, cfg, gen, cfg.name)
    hold_scheduler_twin(model, cfg)
    out["depth"] = hold_engine_depth(model, cfg, gen, cfg.name)
    del model
    torch.cuda.empty_cache()

    rg = get_config(RG_ARCH)
    log(f"[serve] {rg.name} at full width and depth ({rg.num_layers} layers, "
        f"window {rg.window}), bf16: {RG_SERVE_BATCH} x {SERVE_PROMPT} "
        f"prompts, {RG_SERVE_GEN} tokens each")
    tokens, text, counts, peak = serve_main(
        ["--arch", RG_ARCH, "--batch", str(RG_SERVE_BATCH), "--prompt-len",
         str(SERVE_PROMPT), "--gen", str(RG_SERVE_GEN)], "fixed batch")
    hold_counts(counts, {"flash_attention": attention_blocks(rg)},
                "recurrentgemma fixed batch: one prefill")
    hold(tokens.shape == (RG_SERVE_BATCH, RG_SERVE_GEN)
         and int(tokens.max()) < rg.vocab_size, "in-vocab tokens")
    out["rg"] = dict(walls=fixed_walls(text), peak=peak)
    model = card_model(rg)
    out["rg_twin"] = hold_engine_twin(model, rg, gen, rg.name)
    out["rg_depth"] = hold_engine_depth(model, rg, gen, rg.name)
    del model
    torch.cuda.empty_cache()
    return out


def no_drop(cfg):
    """``cfg`` with a capacity factor of num_experts / top_k: an expert's
    capacity is then at least the row's tokens, and as a token sends at
    most one copy to an expert, no copy is dropped (the CPU tests' rule,
    tests/test_torch_serve.py).  Serving a prompt and the forward of the
    longer sequence then route alike at every shared position."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def decode_kernels(model, cache, tok, cfg) -> float | None:
    """Device kernels one decode step launches (``torch.profiler``, one
    step traced after the loop), or None where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        serve_engine.decode_step(model, cache, tok, cfg, ParallelCtx(None))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return sum(e.count for e in events) if events else None


def phase_serve_moe() -> dict:
    """[serve] mixtral-8x7b: the engine's fixed batch, the scheduler on
    ``launch.serve``'s ragged trace, and [serve]'s holds; returns the
    numbers."""
    t_phase = time.perf_counter()
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, num_layers=MOE_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 29)
    xla = ParallelCtx(None)
    max_len = SERVE_PROMPT + SERVE_GEN
    n_attn = attention_blocks(cfg)
    log(f"[serve] {cfg.name} at full width, {MOE_LAYERS} of its "
        f"{base.num_layers} layers ({cfg.moe.num_experts} experts of d_ff "
        f"{cfg.moe.d_ff}, top-{cfg.moe.top_k}, window {cfg.window}), bf16, "
        f"init_model seed {SEED}: {SERVE_BATCH} x {SERVE_PROMPT} prompts, "
        f"{SERVE_GEN} tokens each (decode wraps the window's ring); the "
        "engine's prefill and decode_step, and serve.scheduler.Scheduler")
    model = card_model(cfg)
    inputs = launch_serve.prompt_inputs(cfg, SERVE_BATCH, SERVE_PROMPT,
                                        DEVICE)
    out = {}
    for label in ("first", "warm"):
        with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[serve]"):
            zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, cache = serve_engine.prefill(model, inputs, cfg, xla,
                                                 max_len=max_len)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            hold_counts(read_counts(), {"flash_attention": n_attn},
                        f"{cfg.name} fixed batch ({label}): one prefill")
            zero_counts()
            toks, steps = [tok], []
            for _ in range(SERVE_GEN - 1):
                t0 = time.perf_counter()
                logits, cache = serve_engine.decode_step(model, cache, tok,
                                                         cfg, xla)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t0)
                toks.append(tok)
            hold_counts(read_counts(), {}, f"{cfg.name} fixed batch "
                        f"({label}): {SERVE_GEN - 1} decode steps")
        tokens = torch.stack(toks, 1).cpu().numpy()
        hold(tokens.shape == (SERVE_BATCH, SERVE_GEN)
             and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
             f"{cfg.name} fixed batch ({label}): {tokens.shape} in-vocab "
             "tokens")
        lat = np.array(steps) * 1e3
        out[label] = dict(
            prefill_s=t_pre, decode_s=float(sum(steps)),
            p50=float(np.percentile(lat, 50)),
            p99=float(np.percentile(lat, 99)),
            peak=torch.cuda.max_memory_allocated(), tokens=tokens)
        r = out[label]
        log(f"  fixed batch ({label}; host clock, each decode step ending "
            f"in synchronize): prefill {SERVE_BATCH * SERVE_PROMPT / t_pre:,.0f}"
            f" tok/s ({t_pre:.4f} s), decode "
            f"{SERVE_BATCH * (SERVE_GEN - 1) / r['decode_s']:,.0f} tok/s "
            f"({r['decode_s']:.4f} s over {SERVE_GEN - 1} steps), step p50 "
            f"{r['p50']:.3f} ms / p99 {r['p99']:.3f} ms, peak "
            f"{r['peak'] / 2**30:.2f} GiB")
    out["agree"] = float((out["first"]["tokens"]
                          == out["warm"]["tokens"]).mean())
    with plain_guard(PLAIN_VERSIONS, "[serve]"):
        zero_counts()
        out["decode_kernels"] = decode_kernels(model, cache, tok, cfg)
        hold_counts(read_counts(), {}, f"{cfg.name}: the traced decode step")
    log(f"  warm tokens agree with the first call's at {out['agree']:.4f} "
        f"(not held); one decode step launches "
        f"{out['decode_kernels'] or 'not measured (no device events)'} "
        f"device kernels (torch.profiler), none of them the four "
        "hand-written ones")
    del cache, logits
    torch.cuda.empty_cache()
    try:
        Scheduler(model, cfg, xla, n_slots=SERVE_BATCH, max_len=max_len,
                  backend="paged")
    except NotImplementedError as e:
        log(f"    -> paged backend refused for a window, as in the "
            f"reference ({e}): ok")
    else:
        raise AssertionError("the paged backend took a windowed arch")
    with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[serve]"):
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = Scheduler(model, cfg, xla, n_slots=SERVE_BATCH,
                        max_len=max_len).run(serve_trace(cfg))
        hold_counts(read_counts(), {"flash_attention":
                                    n_attn * res["prefills"]},
                    f"{cfg.name} continuous[dense]: {res['prefills']} "
                    "prefills")
    out["continuous"] = dict(res, peak=torch.cuda.max_memory_allocated(),
                             outputs=None)
    log(f"  continuous[dense] over {res['requests']} requests on "
        f"{SERVE_BATCH} slots: {res['steps']} steps, "
        f"{res['tokens_per_s']:,.0f} tok/s, p50 {res['p50_step_ms']:.3f} ms"
        f" / p99 {res['p99_step_ms']:.3f} ms, peak "
        f"{out['continuous']['peak'] / 2**30:.2f} GiB")
    held = no_drop(cfg)
    out["twin"] = hold_engine_twin(model, held, gen, cfg.name)
    hold_scheduler_twin(model, held)
    out["depth"] = hold_engine_depth(model, held, gen, cfg.name)
    del model
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [serve] {cfg.name} took {out['wall']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [train]: the training path (models.chunked_attention, train/, launch.train)
# ---------------------------------------------------------------------------

#: [train]'s guards: every kernel's plain version raises on a CUDA tensor
#: in llama3.2-1b's train step (chunked attention); ``launch.train``'s CLI
#: trains with the reference's default ``attention_impl="ref"``, the plain
#: attention the attention layer calls itself (no kernel stands for it in
#: training: the flash kernel is forward-only, in both packages), so there
#: only the kernel wrappers' plain versions are made to raise
CLI_PLAIN_VERSIONS = tuple(v for v in PLAIN_VERSIONS
                           if v != (attention_layer, "flash_attention_plain"))


def state_bytes(state) -> dict:
    """Bytes of the train state's parts: bf16 params, and each optimizer
    slot."""
    out = {"params": sum(p.numel() * p.element_size()
                         for p in state["params"].parameters())}
    for slot, tree in state["opt"].items():
        out[slot] = sum(t.numel() * t.element_size()
                        for _, t in train_tree.leaves(tree))
    return out


def run_train_steps(state, step_fn, data, steps: int, what: str) -> dict:
    """``steps`` train steps on ``data.batch_at(i)`` inside the plain
    guard, every count set to 0 just before and read just after: each
    step's wall (host clock ending in ``synchronize``), loss and metrics."""
    walls, losses, aux = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_guard(PLAIN_VERSIONS, "[train]"):
        zero_counts()
        for i in range(steps):
            batch = data.batch_at(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux"]))
        counts = read_counts()
    hold_counts(counts, {}, f"{what}: {steps} train steps")
    hold(all(math.isfinite(x) for x in losses + aux), f"{what}: finite "
         f"losses {losses} (aux {aux})")
    return dict(state=state, walls=walls, losses=losses, aux=aux,
                counts=counts, peak=torch.cuda.max_memory_allocated())


def train_ctx(strategy: str = "xla") -> ParallelCtx:
    return ParallelCtx(Grid.local(DEVICE), matmul_strategy=strategy,
                       attention_impl="chunked")


def train_opt(steps: int):
    return make_optimizer(OptimizerConfig(total_steps=steps, warmup_steps=1))


def new_train_state(cfg, ctx, opt):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    return make_train_state(cfg, ctx, opt, generator=gen, device=DEVICE)


def first_moment_gap(m, ref) -> float:
    """max over leaves of max |m - ref| / max |ref| (fp32 trees of one
    layout)."""
    gap = 0.0
    for path, x in train_tree.leaves(m):
        r = train_tree.at(ref, path)
        d, scale = float((x - r).abs().max()), float(r.abs().max())
        gap = max(gap, d / scale if scale else d)
    return gap


def hold_train_microbatches(cut) -> dict:
    """One step with ``microbatches=2`` against ``microbatches=1`` from
    the same state, clipping off.  The updated params within the
    reference's 5e-2 (``tests/test_models.py:120``): a first AdamW step
    moves a parameter by about ``lr``, so that alone cannot fail.  So the
    step's first moment ``m`` (``(1 - b1)`` times the accumulated fp32
    gradient) is held too: per leaf, max |m2 - m1| within TRAIN_MB_M_HOLD
    of max |m1|.  The same check on the first microbatch's ``m`` halved
    (what the accumulation gives if it drops the second microbatch) must
    fail, so each run shows the check can fail.  Returns the gaps."""
    ctx = train_ctx()
    opt = make_optimizer(OptimizerConfig(
        total_steps=TRAIN_HOLD_STEPS, warmup_steps=1, clip_norm=math.inf))
    base = new_train_state(cut, ctx, opt)
    batch = SyntheticData(cut, TRAIN_HOLD_BATCH, TRAIN_SEQ,
                          seed=SEED + 1).batch_at(0)
    first = {k: x[:TRAIN_HOLD_BATCH // 2] for k, x in batch.items()}
    params, m = {}, {}
    with plain_guard(PLAIN_VERSIONS, "[train]"):
        zero_counts()
        for name, mb, data in (("first", 1, first), ("one", 1, batch),
                               ("two", 2, batch)):
            st = base if name == "two" else copy.deepcopy(base)
            st, _ = build_train_step(cut, ctx, opt, microbatches=mb)(st, data)
            params[name] = {n: p.detach().float() for n, p
                            in st["params"].named_parameters()}
            m[name] = st["opt"]["m"]
            del st
        hold_counts(read_counts(), {}, "[train] microbatch hold")
    out = dict(
        params=max(float((p - params["one"][n]).abs().max())
                   for n, p in params["two"].items()),
        m=first_moment_gap(m["two"], m["one"]),
        fault=first_moment_gap(
            train_tree.tree_map(lambda x: 0.5 * x, m["first"]), m["one"]))
    what = (f"{cut.num_layers} layers, {TRAIN_HOLD_BATCH} x {TRAIN_SEQ}, "
            f"a step of 2 microbatches vs 1")
    hold(out["params"] < TRAIN_MB_HOLD, f"{what}: params differ by at most "
         f"{out['params']:.3e} (< {TRAIN_MB_HOLD})")
    hold(out["m"] <= TRAIN_MB_M_HOLD, f"{what}: first moments differ by at "
         f"most {out['m']:.3e} of the leaf's max |m| (<= {TRAIN_MB_M_HOLD})")
    hold(out["fault"] > TRAIN_MB_M_HOLD, f"{what}, the second microbatch "
         f"dropped: first moments differ by {out['fault']:.3e} of the "
         f"leaf's max |m| (> {TRAIN_MB_M_HOLD}: the check fails it)")
    del base, params, m
    torch.cuda.empty_cache()
    return out


def hold_train_summa(cut) -> dict:
    """``matmul_strategy="summa"`` on ``Grid.local`` (every FFN projection
    and the two products of its backward through ``DistributedMatmul``)
    against ``"xla"``: the losses of TRAIN_HOLD_STEPS steps within rtol
    2e-2 (``tests/test_system.py:33``)."""
    data = SyntheticData(cut, TRAIN_HOLD_BATCH // 2, TRAIN_SEQ, seed=SEED + 2)
    out = {}
    for strategy in ("xla", "summa"):
        ctx, opt = train_ctx(strategy), train_opt(TRAIN_HOLD_STEPS)
        r = run_train_steps(new_train_state(cut, ctx, opt),
                            build_train_step(cut, ctx, opt), data,
                            TRAIN_HOLD_STEPS, f"[train] {strategy}")
        out[strategy] = dict(losses=r["losses"], walls=r["walls"])
        log(f"  {strategy}: losses {r['losses']}, step walls "
            f"{[round(w, 4) for w in r['walls']]} s")
        del r
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["summa"]["losses"],
                                                  out["xla"]["losses"]))
    hold(rel < TRAIN_SUMMA_RTOL, f"summa losses within rtol {rel:.3e} of "
         f"xla's (< {TRAIN_SUMMA_RTOL})")
    return out


def attention_grads(fn, q, k, v, do):
    """(output, dq, dk, dv) of ``fn`` under autograd."""
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = fn(qs, ks, vs)
    o.backward(do)
    return [o.detach(), qs.grad, ks.grad, vs.grad]


def hold_chunked_attention(cfg) -> dict:
    """``chunked_attention`` at llama3.2-1b's attention call (B, 32/8
    heads, Dh 64, S 4096) in fp32 against ``flash_attention_plain`` under
    autograd: the output within 2e-5 and dQ/dK/dV within 2e-4 of the
    operands' rms (the reference's holds, ``tests/test_perf_features.py``),
    then forward + backward times in fp32 and bf16 beside the plain
    version and ``scaled_dot_product_attention``."""
    b, s, h, hkv, dh = (TRAIN_MICRO_BATCH, TRAIN_SEQ, cfg.num_heads,
                        cfg.num_kv_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    q, k, v, do = (randn(shape, torch.float32, gen) for shape in
                   ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh),
                    (b, h, s, dh)))
    scale = max(float(t.square().mean().sqrt()) for t in (q, k, v, do))
    got = attention_grads(chunked_attention, q, k, v, do)
    want = attention_grads(flash_attention_plain, q, k, v, do)
    out = {}
    for name, g, w, tol in zip(("o", "dq", "dk", "dv"), got, want,
                               (CHUNKED_O_TOL,) + (CHUNKED_GRAD_TOL,) * 3):
        err = float((g - w).abs().max())
        out[name] = err
        hold(err <= tol * scale, f"chunked {name} vs plain at B={b} "
             f"{h}/{hkv} heads S={s} Dh={dh} fp32: max |diff| {err:.3e} = "
             f"{err / (tol * scale):.3f} of the hold ({tol} x rms "
             f"{scale:.4f})")
    del got, want
    torch.cuda.empty_cache()
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (q, k, v, do)]
        routes = (("chunked", chunked_attention),
                  ("plain", flash_attention_plain),
                  ("sdpa", lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(
                      q_, k_, v_, is_causal=True, enable_gqa=True)))
        for name, fn in routes:
            ms = cuda_ms(lambda fn=fn: attention_grads(fn, *args), 2)
            times[(name, dtype)] = ms
            torch.cuda.empty_cache()
        # causal: ~half the S x S pairs, 2 products forward, 5 backward
        # (dP, dQ, dK, dV and the recomputed S), 2 Dh FLOP each
        flop = live_pairs(s, True, None) * b * h * dh * 2 * 7
        nbytes = sum(t.numel() * t.element_size() for t in args) * 2
        bnd, by = bound(flop, nbytes, PEAK_BF16_FLOPS
                        if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
        log(f"  attention forward + backward at B={b} {h}/{hkv} heads "
            f"S={s} Dh={dh} {str(dtype).split('.')[1]} (CUDA events, "
            f"{torch.cuda.get_device_name(0)}): chunked "
            f"{times[('chunked', dtype)]:.3f} ms, plain "
            f"{times[('plain', dtype)]:.3f} ms, "
            f"scaled_dot_product_attention {times[('sdpa', dtype)]:.3f} ms; "
            f"bound {bnd:.3f} ms ({by})")
        del args
    out["times"] = times
    return out


def train_cli(argv: list, what: str) -> tuple:
    """``launch.train.main(argv)`` on the card inside the CLI guard, every
    count set to 0 just before and read just after; its printed lines
    echoed.  Returns (its losses or the SystemExit it raised, counts)."""
    buf = io.StringIO()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with plain_guard(CLI_PLAIN_VERSIONS, "[train]"), \
                contextlib.redirect_stdout(buf):
            result = launch_train.main(argv)
    except SystemExit as exc:
        result = exc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  {what}: python -m repro_torch.launch.train {' '.join(argv)}")
    for line in buf.getvalue().splitlines():
        log(f"    | {line}")
    log(f"    launches {counts}; whole call {wall:.3f} s")
    hold_counts(counts, {}, what)
    return result, counts


def phase_train_cli() -> dict:
    """``launch.train.main`` on the card with ``--smoke``: the loss falls
    over CLI_STEPS steps, a run killed at step CLI_FAIL_AT (exit 42) and
    resumed ends within 1e-4 of the uninterrupted run, and the hybrid
    recurrentgemma-9b trains to finite losses."""
    dev = ["--device", DEVICE]
    losses, _ = train_cli(["--arch", LM_ARCH, "--smoke", "--steps",
                           str(CLI_STEPS), "--global-batch", "4", "--seq",
                           "64", "--log-every", "10", *dev], "loss falls")
    hold(losses[-1] < 0.9 * losses[0], f"loss {losses[0]:.4f} -> "
         f"{losses[-1]:.4f} over {CLI_STEPS} steps (< 0.9 x the first)")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    common = ["--arch", LM_ARCH, "--smoke", "--steps", str(CLI_RESUME_STEPS),
              "--global-batch", "2", "--seq", "32", "--ckpt-every", "8",
              "--log-every", "50", *dev]
    ref, _ = train_cli(common + ["--ckpt-dir", str(ckpt_dir / "ref")],
                       "uninterrupted")
    died, _ = train_cli(common + ["--ckpt-dir", str(ckpt_dir / "ft"),
                                  "--fail-at-step", str(CLI_FAIL_AT)],
                        f"killed at step {CLI_FAIL_AT}")
    hold(isinstance(died, SystemExit) and died.code == 42,
         f"--fail-at-step {CLI_FAIL_AT} exits 42 "
         f"({getattr(died, 'code', died)})")
    resumed, _ = train_cli(common + ["--ckpt-dir", str(ckpt_dir / "ft"),
                                     "--resume"], "resumed")
    gap = abs(resumed[-1] - ref[-1])
    hold(len(resumed) == CLI_RESUME_STEPS - CLI_FAIL_AT and gap < 1e-4,
         f"resumed run's last loss {resumed[-1]:.6f} within {gap:.2e} of the "
         f"uninterrupted {ref[-1]:.6f} (< 1e-4)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rg, _ = train_cli(["--arch", RG_ARCH, "--smoke", "--steps", "10",
                       "--global-batch", "2", "--seq", "32", "--log-every",
                       "100", *dev], "hybrid")
    hold(all(math.isfinite(x) for x in rg), f"{RG_ARCH} --smoke: finite "
         f"losses {[round(x, 4) for x in rg]}")
    return dict(first=losses[0], last=losses[-1], gap=gap)


def norm_gap(got, want) -> float:
    """||got - want|| / ||want|| (||got|| where want is 0)."""
    scale = float(torch.linalg.norm(want))
    diff = float(torch.linalg.norm(got - want))
    return diff / scale if scale else diff


def first_update(state, step_fn, batch) -> tuple:
    """One train step of a fresh AdamW ``state``: (state, metrics, the
    step's first and second moments and each master's change, ``{slot:
    {path: leaf}}``).  The optimizer stores new leaves, so the moments are
    kept by reference, and they stay as they are through later steps."""
    old = dict(train_tree.leaves(state["opt"]["master"]))
    state, metrics = step_fn(state, batch)
    opt = state["opt"]
    moved = {"m": dict(train_tree.leaves(opt["m"])),
             "v": dict(train_tree.leaves(opt["v"])),
             "change": {path: x - old.pop(path) for path, x
                        in train_tree.leaves(opt["master"])}}
    return state, metrics, moved


def update_gaps(moved: dict, ref: dict) -> dict:
    """``norm_gap`` of each slot's leaf against ``ref``'s."""
    return {slot: {path: norm_gap(x, ref[slot][path])
                   for path, x in leaves.items()}
            for slot, leaves in moved.items()}


def worst_leaf(gaps: dict) -> dict:
    """Each slot's largest gap over its leaves."""
    return {slot: max(by_leaf.values()) for slot, by_leaf in gaps.items()}


def hold_train_twin(cut, opt, data, what: str) -> dict:
    """``cut`` trained in bf16 against its fp32 twin (the same weights
    widened, exact), TRAIN_STEPS steps of ``data``:

    * the first update: from the same weights, the bf16 step's first and
      second moments within MOE_TWIN_MOMENT_HOLD of the twin step's, and
      each master's change within MOE_TWIN_CHANGE_HOLD of the twin's, per
      leaf (``norm_gap``); the bf16 params are their masters rounded.
      The same step on the batch's first half (a step that drops its
      second microbatch) must fail each of the two holds, so each run
      shows they can fail; a backward, a moment or an update that is
      wrong, or a state left unchanged, fails them too;
    * each bf16 step's loss within TRAIN_SUMMA_RTOL of the twin's loss
      on the step's own weights and batch;
    * printed, not held: the twin left to itself over the same steps.
      Two runs left alone part after the first update (it moves each
      weight by ~lr, ~2 % of it, where bf16 keeps it to ~0.4 %)."""
    ctx = train_ctx()
    cut32 = dataclasses.replace(cut, dtype="float32")
    weights = {name: p.detach() for name, p in
               new_train_state(cut, ctx, opt)["params"].named_parameters()}

    def fresh(config):
        model = LM(config, device=DEVICE)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        return model

    def on_card(batch):
        return {k: torch.from_numpy(np.asarray(v)).to(DEVICE, torch.int64)
                for k, v in batch.items()}

    batches = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    step32 = build_train_step(cut32, ctx, opt)
    step16 = build_train_step(cut, ctx, opt)
    with plain_guard(PLAIN_VERSIONS, "[train]"):
        zero_counts()
        # the fp32 twin left to itself; its first update is the yardstick
        state, metrics, ref = first_update(
            train_state(fresh(cut32), opt, ctx), step32, batches[0])
        free = [float(metrics["loss"])]
        for batch in batches[1:]:
            state, metrics = step32(state, batch)
            free.append(float(metrics["loss"]))
        del state
        torch.cuda.empty_cache()
        # the control: the bf16 step on the first half of the batch
        half = {k: v[:len(v) // 2] for k, v in batches[0].items()}
        state, _, moved = first_update(
            train_state(fresh(cut), opt, ctx), step16, half)
        fault = update_gaps(moved, ref)
        del state, moved
        torch.cuda.empty_cache()
        # the bf16 run: its first update against the twin's, and each
        # step's loss against the twin's on the step's weights
        state = train_state(fresh(cut), opt, ctx)
        del weights
        losses, forced = [], [free[0]]
        for i, batch in enumerate(batches):
            if i == 0:
                state, metrics, moved = first_update(state, step16, batch)
                gaps = update_gaps(moved, ref)
                rounded = all(torch.equal(x, train_tree.at(
                    state["opt"]["master"], path).to(x.dtype))
                    for path, x in train_tree.leaves(
                        params_tree(state["params"])))
                del moved, ref
            else:
                twin = LM(cut32, device=DEVICE)
                params = dict(state["params"].named_parameters())
                with torch.no_grad():
                    for name, p in twin.named_parameters():
                        p.copy_(params[name])
                    loss32, _ = lm_model.loss_fn(twin, on_card(batch), cut32,
                                                 ctx)
                forced.append(float(loss32))
                del twin, params, loss32
                state, metrics = step16(state, batch)
            losses.append(float(metrics["loss"]))
        hold_counts(read_counts(), {}, f"{what}: {TRAIN_STEPS} steps, the "
                    "twin's and the control's")
    del state
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, forced)]
    apart = [abs(a - b) / abs(b) for a, b in zip(losses, free)]
    worst, worst_fault = worst_leaf(gaps), worst_leaf(fault)
    for slot in gaps:
        log(f"  {what}: the first update's {slot} against the fp32 twin's, "
            f"||bf16 - fp32|| / ||fp32|| by leaf: "
            f"{ {k: float(f'{v:.3e}') for k, v in gaps[slot].items()} }; "
            f"the half-batch control's "
            f"{ {k: float(f'{v:.3e}') for k, v in fault[slot].items()} }")
    log(f"  {what}: bf16 losses {losses}; the fp32 twin's on the same "
        f"weights {forced} (relative gaps {[f'{x:.3e}' for x in rel]}); "
        f"the twin left to itself {free} (gaps, not held, "
        f"{[f'{x:.3e}' for x in apart]})")
    hold(rounded, f"{what}: after the first step each bf16 param is its "
         "fp32 master rounded")
    for slots, limit in ((("m", "v"), MOE_TWIN_MOMENT_HOLD),
                         (("change",), MOE_TWIN_CHANGE_HOLD)):
        for slot in slots:
            hold(worst[slot] <= limit, f"{what}: the first update's {slot} "
                 f"within {worst[slot]:.3e} of the fp32 twin's at every "
                 f"leaf (<= {limit})")
            hold(worst_fault[slot] > limit, f"{what}, the step on half the "
                 f"batch: its {slot} {worst_fault[slot]:.3e} from the twin's "
                 f"at its worst leaf (> {limit}: the check fails it)")
    hold(max(rel) < TRAIN_SUMMA_RTOL, f"{what}: bf16 losses within rtol "
         f"{max(rel):.3e} of the fp32 twin's on the same weights at each "
         f"step (< {TRAIN_SUMMA_RTOL})")
    return dict(rel=rel, apart=apart, losses=losses, free=free,
                gaps=worst, fault=worst_fault)


def phase_train_moe() -> dict:
    """[train] mixtral-8x7b's train step at full width; returns its
    numbers."""
    t_phase = time.perf_counter()
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(base, num_layers=MOE_TRAIN_LAYERS)
    log(f"[train] {cfg.name} at full width, {MOE_TRAIN_LAYERS} of its "
        f"{base.num_layers} layers (d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts of d_ff {cfg.moe.d_ff}, top-"
        f"{cfg.moe.top_k}, window {cfg.window}), bf16, AdamW, "
        f"attention_impl=chunked, remat; SyntheticData {MOE_TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step in {MOE_TRAIN_MICRO} microbatches; "
        "every kernel's plain version raises on a CUDA tensor")
    ctx, opt = train_ctx(), train_opt(TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = new_train_state(cfg, ctx, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    parts = state_bytes(state)
    n_params = sum(p.numel() for p in state["params"].parameters())
    log(f"  train state: {n_params:,} parameters; bytes {parts} "
        f"({sum(parts.values()) / 2**30:.2f} GiB); make_train_state "
        f"{init_s:.3f} s")
    step_fn = build_train_step(cfg, ctx, opt, microbatches=MOE_TRAIN_MICRO,
                               remat=True)
    data = SyntheticData(cfg, MOE_TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    r = run_train_steps(state, step_fn, data, TRAIN_STEPS,
                        f"[train] {cfg.name}")
    warm = min(r["walls"][1:])
    tokens = MOE_TRAIN_BATCH * TRAIN_SEQ
    out = dict(walls=r["walls"], losses=r["losses"], aux=r["aux"],
               peak=r["peak"], warm=warm, tokens_per_s=tokens / warm,
               counts=r["counts"])
    log(f"  {cfg.name} train step ({torch.cuda.get_device_name(0)}; host "
        f"clock ending in synchronize): walls "
        f"{[round(w, 4) for w in r['walls']]} s (first {r['walls'][0]:.4f}, "
        f"warm {warm:.4f}), {tokens / warm:,.0f} tokens/s warm, peak device "
        f"memory {r['peak'] / 2**30:.2f} GiB, losses {r['losses']}, aux "
        f"{r['aux']}, launches {r['counts']}")
    hold(r["peak"] < MOE_TRAIN_PEAK, f"{cfg.name} train step: peak "
         f"{r['peak'] / 2**30:.2f} GiB under {MOE_TRAIN_PEAK / 2**30:.0f} GiB")
    del state, r, step_fn
    torch.cuda.empty_cache()
    # the hold: bf16 against its fp32 twin at MOE_TRAIN_HOLD_LAYERS
    cut = dataclasses.replace(cfg, num_layers=MOE_TRAIN_HOLD_LAYERS)
    data = SyntheticData(cut, MOE_TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 3)
    r = hold_train_twin(cut, opt, data, f"[train] {cut.name}, "
                        f"{MOE_TRAIN_HOLD_LAYERS} layer")
    out["hold"] = r
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [train] {cfg.name} took {out['wall']:.1f} s")
    return out


def phase_train() -> dict:
    """[train] the training path on the card; returns its numbers."""
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    log(f"[train] {cfg.name} at full width and depth ({cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, tied), "
        f"bf16, AdamW, attention_impl=chunked, remat; SyntheticData "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_MICRO} "
        f"microbatches of {TRAIN_MICRO_BATCH}; every kernel's plain version "
        f"raises on a CUDA tensor")
    ctx, opt = train_ctx(), train_opt(TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = new_train_state(cfg, ctx, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    parts = state_bytes(state)
    n_params = sum(p.numel() for p in state["params"].parameters())
    log(f"  train state: {n_params:,} parameters; bytes {parts} "
        f"({sum(parts.values()) / 2**30:.2f} GiB; with the bf16 grads and "
        f"the fp32 accumulator of a step "
        f"{(sum(parts.values()) + n_params * 6) / 2**30:.2f} GiB); "
        f"make_train_state {init_s:.3f} s")
    step_fn = build_train_step(cfg, ctx, opt, microbatches=TRAIN_MICRO,
                               remat=True)
    data = SyntheticData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    r = run_train_steps(state, step_fn, data, TRAIN_STEPS, f"[train] {cfg.name}")
    warm = min(r["walls"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = dict(walls=r["walls"], losses=r["losses"], peak=r["peak"],
               warm=warm, tokens_per_s=tokens / warm, counts=r["counts"])
    log(f"  {cfg.name} train step ({torch.cuda.get_device_name(0)}; host "
        f"clock ending in synchronize): walls {[round(w, 4) for w in r['walls']]}"
        f" s (first {r['walls'][0]:.4f}, warm {warm:.4f}), "
        f"{tokens / warm:,.0f} tokens/s warm, peak device memory "
        f"{r['peak'] / 2**30:.2f} GiB, losses {r['losses']}, launches "
        f"{r['counts']}")
    del state, r, step_fn
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=TRAIN_HOLD_LAYERS)
    out["microbatches"] = hold_train_microbatches(cut)
    out["summa"] = hold_train_summa(cut)
    out["attention"] = hold_chunked_attention(cfg)
    out["cli"] = phase_train_cli()
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [train] took {out['wall']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# [dryrun]: the cost analysis of the card's calls against the dry run's
# ---------------------------------------------------------------------------

#: [dryrun]: llama3.2-1b's prefill of DRY_PREFILL_BATCH x LM_SEQ tokens, its
#: train step at [train]'s shape, mixtral-8x7b's forward cut to
#: DRY_MOE_LAYERS layers on DRY_MOE_BATCH x MOE_SEQ tokens and the
#: block-sparse product at N (fill SPARSE_FILL): each counted on the card
#: and by the dry run on ``meta``; the dry run's peak above its arguments
#: within DRY_PEAK_RTOL of the allocator's peak above what was allocated
#: on entry
DRY_PREFILL_BATCH = 4
DRY_MOE_LAYERS, DRY_MOE_BATCH = 1, 1
DRY_PEAK_RTOL = 0.15
#: [train]'s step as counted while remat still recomputed each unit's last
#: product
DRY_TRAIN_FLOP_BEFORE = 3.51259605336064e14
#: (e): the decode step's bytes over its weights, the K/V cache it reads
#: and the cache's fp32 copy
DRY_DECODE_BYTES_RTOL = 1.1


def meta_ctx(**kw) -> ParallelCtx:
    """The dry run's context on the card's grid (``launch.dryrun``)."""
    return launch_dryrun.make_ctx(Grid.local("meta"), False, **kw)


def timed(fn, *args) -> float:
    """One uncounted call's wall (host clock ending in synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def card_count(fn, *args, kernels: dict, what: str):
    """``fn(*args)`` on the card under ``analysis.cost``'s counter, inside
    the plain guard, every launch count set to 0 just before and held to
    ``kernels`` just after: (WeightedCost, MemoryCost, the allocator's
    peak above the bytes allocated on entry)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with plain_guard(PLAIN_VERSIONS, "[dryrun]"):
        zero_counts()
        out, wc, mem = analyze_step(fn, *args, device=DEVICE)
        torch.cuda.synchronize()
        counts = read_counts()
    alloc = torch.cuda.max_memory_allocated() - base
    del out
    hold_counts(counts, kernels, what)
    return wc, mem, alloc


def hold_dry(what: str, card, meta, kernel_flops: dict) -> dict:
    """Raises unless the card's count equals the dry run's exactly (FLOP,
    bytes, collective bytes by kind), each kernel's counted FLOP equal
    the figure phase 7's formula gives at its calls (``kernel_flops``),
    and the dry run's peak above its arguments is within DRY_PEAK_RTOL of
    the allocator's peak above what was allocated on entry."""
    wc, _, alloc = card
    mwc, mmem = meta
    log(f"  {what}: FLOP card {wc.flops:.17g} / dry run {mwc.flops:.17g}; "
        f"bytes {wc.hbm_bytes:.17g} / {mwc.hbm_bytes:.17g}; collective "
        f"bytes {wc.coll_bytes:.17g} / {mwc.coll_bytes:.17g}")
    same = (wc.flops == mwc.flops and wc.hbm_bytes == mwc.hbm_bytes
            and wc.coll_bytes_by_op == mwc.coll_bytes_by_op)
    if not same:  # name the ops that differ before failing
        for op in sorted(set(wc.by_op) | set(mwc.by_op)):
            if wc.by_op.get(op) != mwc.by_op.get(op):
                log(f"    {op} [calls, FLOP, bytes]: card "
                    f"{wc.by_op.get(op)}, dry run {mwc.by_op.get(op)}")
    hold(same, f"{what}: the card's count equals the dry run's")
    for name, want in kernel_flops.items():
        for side, c in (("card", wc), ("dry run", mwc)):
            got = c.by_op[name][1]
            hold(got == want, f"{what}: {name}'s counted FLOP on the {side} "
                 f"{got:.17g} == phase 7's figure {want:.17g} "
                 f"({c.by_op[name][0]:g} calls)")
    grown = mmem.peak_live_bytes - mmem.argument_size_in_bytes
    ratio = grown / alloc if alloc else math.inf
    log(f"  {what}: peak above the arguments, dry run {grown / 2**30:.3f} "
        f"GiB, allocator {alloc / 2**30:.3f} GiB (ratio {ratio:.4f}); "
        f"arguments {mmem.argument_size_in_bytes / 2**30:.3f} GiB, dry-run "
        f"peak live {mmem.peak_live_bytes / 2**30:.3f} GiB")
    hold(abs(ratio - 1) <= DRY_PEAK_RTOL,
         f"{what}: peak within {DRY_PEAK_RTOL:.0%} of the allocator's")
    return dict(flops=mwc.flops, bytes=mwc.hbm_bytes, peak=mmem.peak_live_bytes,
                alloc=alloc, ratio=ratio)


def dry_roofline(what: str, wc, wall: float, model_flops: float) -> dict:
    """The counted step's bound on the card beside its warm wall."""
    rep = roofline(wc.flops, wc.hbm_bytes, wc.wire_bytes, chips=1,
                   model_flops=model_flops)
    mfu = model_flops / (wall * DEFAULT_HW.peak_flops)
    log(f"  {what}: warm wall {wall:.4f} s (uncounted); bound_s "
        f"{rep.bound_s:.4f} s, dominant {rep.dominant} (compute "
        f"{rep.compute_s:.4f} s at {DEFAULT_HW.peak_flops:.3g} FLOP/s, "
        f"memory {rep.memory_s:.4f} s at {DEFAULT_HW.hbm_bw:.3g} B/s); "
        f"bound_s / wall {rep.bound_s / wall:.4f}; model FLOP "
        f"{model_flops:.4g}, model_flops / (wall x "
        f"{DEFAULT_HW.peak_flops:.3g}) {mfu:.4f}; useful ratio "
        f"{rep.useful_ratio:.4f}")
    return dict(wall=wall, bound_s=rep.bound_s, dominant=rep.dominant,
                bound_over_wall=rep.bound_s / wall, mfu=mfu)


def dry_prefill() -> dict:
    cfg = get_config(LM_ARCH)
    b, s = DRY_PREFILL_BATCH, LM_SEQ
    what = f"(a) prefill {cfg.name} {b} x {s}"
    shape = ShapeConfig("prefill", s, b, "prefill")
    model = card_model(cfg)
    ctx = ParallelCtx(Grid.local(DEVICE))
    inputs = {"tokens": prompt_tokens(cfg, b, SEED + 25, s).int()}

    def fn(m, x):
        return serve_engine.prefill(m, x, cfg, ctx, max_len=s)

    fn(model, inputs)
    card = card_count(fn, model, inputs, what=what,
                      kernels={"flash_attention": cfg.num_layers})
    wall = timed(fn, model, inputs)
    del model
    torch.cuda.empty_cache()
    meta = launch_dryrun.count_cell(cfg, shape, meta_ctx(), 1)
    out = hold_dry(what, card, meta, {"flash_attention": cfg.num_layers
                                      * attention_flops(
                                          b, cfg.num_heads,
                                          cfg.resolved_head_dim, s * s)})
    log(f"    (flash_attention counts the plain route's products over all "
        f"{s * s} (query, key) pairs a head; phase 7's causal bound counts "
        f"the {live_pairs(s, True, None)} live ones)")
    out.update(dry_roofline(what, card[0], wall,
                            launch_dryrun.model_flops_per_step(cfg, shape)))
    return out


def dry_train() -> dict:
    cfg = get_config(LM_ARCH)
    what = (f"(b) train step {cfg.name} {TRAIN_BATCH} x {TRAIN_SEQ} in "
            f"{TRAIN_MICRO} microbatches")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ctx, opt = train_ctx(), train_opt(TRAIN_STEPS)
    state = new_train_state(cfg, ctx, opt)
    step = build_train_step(cfg, ctx, opt, microbatches=TRAIN_MICRO,
                            remat=True)
    batch = {k: torch.as_tensor(v).to(DEVICE, torch.int32) for k, v in
             SyntheticData(cfg, TRAIN_BATCH, TRAIN_SEQ,
                           seed=SEED).batch_at(0).items()}
    card = card_count(step, state, batch, kernels={}, what=what)
    with plain_guard(PLAIN_VERSIONS, "[dryrun]"):
        wall = timed(step, state, batch)
    del state, step
    torch.cuda.empty_cache()
    meta = launch_dryrun.count_cell(
        cfg, shape, meta_ctx(attention_impl="chunked"), TRAIN_MICRO,
        opt=train_opt(TRAIN_STEPS))
    out = hold_dry(what, card, meta, {})
    # remat no longer recomputes each unit's last product, the FFN's down
    # projection over the step's tokens
    dead = cfg.units * 2 * TRAIN_BATCH * TRAIN_SEQ * cfg.d_ff * cfg.d_model
    hold(DRY_TRAIN_FLOP_BEFORE - out["flops"] == dead,
         f"{what}: FLOP {out['flops']:.17g} = the earlier count "
         f"{DRY_TRAIN_FLOP_BEFORE:.17g} less the units' last products "
         f"{dead:.17g}")
    out.update(dry_roofline(what, card[0], wall,
                            launch_dryrun.model_flops_per_step(cfg, shape)))
    return out


def dry_decode() -> dict:
    cfg = get_config(LM_ARCH)
    b, s = SERVE_BATCH, SERVE_PROMPT + SERVE_GEN
    what = f"(e) decode step {cfg.name} {b} slots x {s} context"
    shape = ShapeConfig("decode", s, b, "decode")
    model = card_model(cfg)
    ctx = ParallelCtx(Grid.local(DEVICE))
    cache = serve_engine.init_cache(cfg, b, s, device=DEVICE)
    tokens = torch.zeros((b,), dtype=torch.int32, device=DEVICE)

    def fn(m, c, t):
        return serve_engine.decode_step(m, c, t, cfg, ctx)

    # not under inference_mode: there composite ops (einsum, matmul) reach
    # the counter whole, where ``meta`` counts their products
    fn(model, cache, tokens)
    card = card_count(fn, model, cache, tokens, kernels={}, what=what)
    wall = timed(fn, model, cache, tokens)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = sum(t.numel() * t.element_size()
             for _, t in train_tree.leaves(cache) if t.is_floating_point())
    del model, cache
    torch.cuda.empty_cache()
    meta = launch_dryrun.count_cell(cfg, shape, meta_ctx(), 1)
    out = hold_dry(what, card, meta, {})
    wc, mem, _ = card
    reads, widened = weights + kv, weights + 5 * kv
    log(f"  {what}: bytes {wc.hbm_bytes:.17g}; weights {weights} + K/V "
        f"cache {kv} = {reads} ({wc.hbm_bytes / reads:.4f} x); with the "
        f"cache's fp32 copy written and read, {widened} "
        f"({wc.hbm_bytes / widened:.4f} x)")
    hold(reads <= wc.hbm_bytes <= DRY_DECODE_BYTES_RTOL * widened,
         f"{what}: weights + cache <= bytes <= {DRY_DECODE_BYTES_RTOL} x "
         "(weights + cache + its fp32 copy written and read)")
    update = b * cfg.num_kv_heads * cfg.resolved_head_dim * 2  # bf16 rows
    writes = 2 * cfg.num_layers  # K and V of every layer
    hold(wc.by_op.get("aten.index_put_") == [writes, 0.0, writes * 2 * update],
         f"{what}: cache writes {wc.by_op.get('aten.index_put_')} = "
         f"{writes} x twice the {update}-byte update")
    temp = mem.peak_live_bytes - mem.argument_size_in_bytes - (
        mem.output_size_in_bytes - mem.alias_size_in_bytes)
    hold(mem.temp_size_in_bytes == temp > 0,
         f"{what}: temporaries {mem.temp_size_in_bytes:.17g} = peak less "
         f"arguments less the outputs not updated in place "
         f"({mem.alias_size_in_bytes:.17g} aliased)")
    out.update(dry_roofline(what, wc, wall,
                            launch_dryrun.model_flops_per_step(cfg, shape)))
    out.update(weights=weights, kv=kv, temp=mem.temp_size_in_bytes)
    return out


def dry_moe() -> dict:
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=DRY_MOE_LAYERS)
    b, s = DRY_MOE_BATCH, MOE_SEQ
    what = f"(c) MoE forward {cfg.name} ({DRY_MOE_LAYERS} layer) {b} x {s}"
    model = card_model(cfg)
    ctx = ParallelCtx(Grid.local(DEVICE))
    inputs = {"tokens": prompt_tokens(cfg, b, SEED + 26, s).int()}

    def fn(m, x, ctx=ctx):
        return forward(m, x, cfg, ctx, use_kernel=True)

    fn(model, inputs)
    e = model.units[0]["b0"].moe.w_gate.shape[0]
    card = card_count(fn, model, inputs, what=what, kernels={
        "flash_attention": DRY_MOE_LAYERS,
        "grouped_gemm": MOE_LAUNCHES_PER_LAYER * DRY_MOE_LAYERS})
    del model
    torch.cuda.empty_cache()
    meta_inputs = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                         device="meta")}
    _, mwc, mmem = analyze_step(lambda m, x: fn(m, x, meta_ctx()),
                                LM(cfg, device="meta"), meta_inputs)
    t = b * e * moe_layer.capacity(cfg.moe, s, e)
    return hold_dry(what, card, (mwc, mmem), {
        "flash_attention": DRY_MOE_LAYERS * attention_flops(
            b, cfg.num_heads, cfg.resolved_head_dim, s * s),
        # gate and up (D x F), down (F x D): each 2·T·D·F
        "grouped_gemm": MOE_LAUNCHES_PER_LAYER * DRY_MOE_LAYERS
        * grouped_flops(t, cfg.d_model, cfg.moe.d_ff)})


def dry_bsmm(a_mask, b_mask) -> dict:
    what = f"(d) block-sparse product N={N} fill {SPARSE_FILL}"
    kw = dict(strategy="taskbased", k_blocks=K_PANELS, local_matmul="pallas")
    mm = DistributedMatmul(Grid.local(DEVICE), **kw)
    mm_meta = DistributedMatmul(Grid.local("meta"), **kw)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 27)
    a = torch.randn((N, N), generator=gen, device=DEVICE)
    b = torch.randn((N, N), generator=gen, device=DEVICE)

    def fn(a, b, mm=mm):
        return mm(a, b, a_mask=a_mask, b_mask=b_mask)

    fn(a, b)  # both counted warm: the executable holds its masks and map
    card = card_count(fn, a, b, what=what, kernels={"bsmm": 1})
    # the wrapper alone at phase 7's panel shape, on the card and on meta
    a_panel, b_panel = a[:, :BLOCK], b[:BLOCK, :]
    _, tc, _ = analyze_step(kops.tiled_matmul, a_panel, b_panel)
    del a, b, a_panel, b_panel
    torch.cuda.empty_cache()
    am = torch.empty((N, N), device="meta")
    fn(am, am, mm_meta)
    _, mwc, mmem = analyze_step(fn, am, am, mm_meta)
    _, tm, _ = analyze_step(kops.tiled_matmul, am[:, :BLOCK], am[:BLOCK, :])
    hold(tc.by_op == tm.by_op and tc.by_op["tiled_matmul"][1] == tiled_flops(
        N, BLOCK, N), f"tiled_matmul ({N},{BLOCK})x({BLOCK},{N}) counts "
         f"{tc.by_op['tiled_matmul']} on the card, "
         f"{tm.by_op['tiled_matmul']} on meta; phase 7's figure "
         f"{tiled_flops(N, BLOCK, N):.17g}")
    plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    bm, bk, _ = plan.local_block
    _, flops, _ = bsmm_walk(plan)
    # B's mask blocks are the kernel's 256-column tiles, so the tile map
    # multiplies each live block triple of the masks once
    triples = int((a_mask.astype(np.int64) @ b_mask.astype(np.int64)).sum())
    hold(BLOCK == TILE_COLS and flops == bsmm_flops(triples, bm, bk,
                                                    TILE_COLS),
         f"{what}: phase 7's figure {flops:.17g} == the masks' live block "
         f"triples {triples} x 2 bm bk {TILE_COLS}")
    return hold_dry(what, card, (mwc, mmem), {"bsmm": flops})


def phase_dryrun(a_mask, b_mask) -> dict:
    """[dryrun] each call counted with ``analysis.cost`` on the card equals
    the dry run of the same call on ``meta``; returns the numbers."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[dryrun] analysis.cost on the card against launch.dryrun on meta "
        f"({smi()}; peaks from analysis.cost.DEFAULT_HW: "
        f"{DEFAULT_HW.peak_flops:.4g} FLOP/s bf16, {DEFAULT_HW.hbm_bw:.4g} "
        f"B/s)")
    out = {"bsmm": dry_bsmm(a_mask, b_mask), "prefill": dry_prefill(),
           "moe": dry_moe(), "train": dry_train(), "decode": dry_decode()}
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [dryrun] took {out['wall']:.1f} s")
    return out


# -- [examples] ------------------------------------------------------------

EXAMPLE_TRAIN_STEPS = 60


def run_example(script: str, argv: list, versions, want: dict,
                exact: bool) -> dict:
    """``examples/<script>``'s ``main(argv)`` on the card inside the plain
    guard, every count set to 0 just before and read just after; its
    printed lines echoed.  Each kernel of ``want`` must have launched
    that many times (``exact``) or at least once (not ``exact``: the
    engine's schedules decide how many)."""
    path = ROOT / "examples" / script
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with plain_guard(versions, "[examples]"), contextlib.redirect_stdout(buf):
        result = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"  python examples/{script} {' '.join(argv)}")
    for line in buf.getvalue().splitlines():
        log(f"    | {line}")
    log(f"    wall {wall:.3f} s (host clock ending in synchronize); "
        f"launches {counts}")
    if exact:
        hold_counts(counts, want, script)
    else:
        hold(all(counts[k] > 0 for k in want),
             f"{script}: launches {counts}, each of {sorted(want)} at least "
             "once")
    return dict(wall=wall, launches=counts, result=result)


def phase_examples() -> dict:
    """[examples] the four examples on the card; returns their walls and
    launches."""
    t_phase = time.perf_counter()
    log(f"[examples] examples/torch_*.py on the card ({smi()})")
    smoke = get_config(LM_ARCH, smoke=True)
    dev = ["--device", DEVICE]
    out = {
        "quickstart": run_example("torch_quickstart.py", dev, PLAIN_VERSIONS,
                                  {"tiled_matmul": 1}, exact=False),
        "blocksparse": run_example("torch_blocksparse_contraction.py", dev,
                                   PLAIN_VERSIONS, {"bsmm": 1}, exact=False),
        "serve": run_example("torch_serve_batch.py",
                             ["--arch", LM_ARCH, *dev], PLAIN_VERSIONS,
                             {"flash_attention": smoke.num_layers},
                             exact=True),
        "train": run_example("torch_train_e2e.py",
                             ["--steps", str(EXAMPLE_TRAIN_STEPS), *dev],
                             CLI_PLAIN_VERSIONS, {}, exact=True),
    }
    losses = out["train"]["result"]["losses"]
    hold(losses[-1] < losses[0], f"torch_train_e2e.py: loss {losses[0]:.4f}"
         f" -> {losses[-1]:.4f} over {len(losses)} steps")
    shutil.rmtree(ROOT / "build" / "torch_train_e2e", ignore_errors=True)
    out["wall"] = time.perf_counter() - t_phase
    log(f"  [examples] took {out['wall']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [shard]: per-rank programs on sharded parameters
# ---------------------------------------------------------------------------

#: [shard]: two gloo processes on the one card (NCCL refuses two ranks on
#: one device), each holding only its blocks of the parameters
#: (``dist.partitioning.shard_params``) and running its rows, heads,
#: hidden columns, experts and vocab; every collective goes through host
#: memory (gloo), so the phase shows the per-rank programs and their
#: kernels right at shard shapes and measures no collective across cards.
#: llama3.2-1b at full width and depth, a bf16 forward of LM_BATCH x
#: LM_SEQ on 1x2 (tp: 16 q / 4 kv heads per rank) and 2x1 (dp: 2 rows per
#: rank) against the 1x1 forward at the bf16 pair hold; one AdamW step on
#: 2x1 (FSDP + DP) of SHARD_TRAIN_BATCH x TRAIN_SEQ in TRAIN_MICRO
#: microbatches against the 1x1 step at [train]'s holds; mixtral-8x7b cut
#: to SHARD_MOE_LAYERS layers on 1 x MOE_SEQ at 1x2 (4 experts per rank);
#: and the scheduler on 2x1, dense and paged, SHARD_REQUESTS ragged
#: requests on SHARD_SLOTS slots (2 per rank), on an fp32 twin at full
#: width cut to SHARD_SERVE_LAYERS layers, its greedy tokens equal to the
#: 1x1 run's (4 requests a backend: a forward on 2x1 takes seconds, every
#: collective going through host memory)
SHARD_WORLD = 2
SHARD_TRAIN_BATCH = 4
SHARD_MOE_LAYERS = 2
SHARD_SERVE_LAYERS, SHARD_SLOTS, SHARD_REQUESTS = 2, 4, 4
SHARD_PROMPTS, SHARD_GENS = (128, 256), (2, 8)


def shard_forward(model, tokens, cfg, grid, ref, what: str) -> dict:
    """``model`` cut to this rank's blocks on ``grid``; its forward
    through the kernels (counts read per rank) against this rank's part
    of the 1x1 logits ``ref`` at the bf16 pair hold (a MoE pair by its
    argmax agreement alone: a token whose router logits tie within the
    rounding goes to another expert, see LM_BF16_PAIR_AGREE); its held
    bytes equal to the spec's share.  On a tensor-parallel grid, block 0
    and the kernels at the rank's shapes are held layer by layer
    (``hold_shard_layers``)."""
    from repro_torch.dist.partitioning import shard_params

    ctx = ParallelCtx(grid)
    part = shard_params(copy.deepcopy(model), grid)
    whole, held = launch_serve.param_bytes(part, grid)
    _, share = launch_serve.param_bytes(model, grid)
    hold(held == share, f"{what}: the rank holds {held:,} of {whole:,} bytes "
         f"of parameters, the spec's share {share:,}")
    rows = ctx.block(torch.arange(tokens.shape[0]), ctx.dp)
    v0, n = ctx.tp_part(cfg.vocab_size)
    shape = (len(rows), tokens.shape[1], n)
    logits, wall, counts, peak = run_forward(
        part, tokens, cfg, ctx, use_kernel=True, what=what, shape=shape)
    rel, share_ok = logit_distance(
        logits, ref[rows.tolist()][..., v0:v0 + n], f"{what} vs 1x1")
    if cfg.moe is None:
        hold(rel <= LM_BF16_PAIR_REL and share_ok >= LM_BF16_PAIR_AGREE,
             f"{what} vs the 1x1 forward within {LM_BF16_PAIR_REL} and at "
             f"least {LM_BF16_PAIR_AGREE}")
    else:
        hold(share_ok >= LM_BF16_PAIR_AGREE, f"{what} vs the 1x1 forward: "
             f"argmax agreement at least {LM_BF16_PAIR_AGREE}")
    del logits
    torch.cuda.empty_cache()
    layers = (hold_shard_layers(model, part, tokens, cfg, ctx, what)
              if ctx.tp_size > 1 else {})
    del part
    torch.cuda.empty_cache()
    return dict(rel=rel, agree=share_ok, wall=wall, peak=peak,
                launches=counts, held=held, layers=layers)


def hold_shard_layers(model, part, tokens, cfg, ctx, what: str) -> dict:
    """Block 0 of the rank's sharded ``part`` against block 0 of the 1x1
    ``model`` on the same embedded ``tokens`` (this rank's rows), each at
    the output's scale (``hold_at_scale``): the attention block (the
    rank's heads, their partial outputs summed over tp) and, for a MoE
    config, the MoE layer on the rank's experts (routed alike: its router
    weight is gathered whole), aux losses equal within 1e-6.  And each
    kernel at the rank's shapes against its plain version on the same
    operands, at ``hold_at_scale``: ``flash_attention`` on the q, k, v of
    the rank's heads (the first row), ``grouped_gemm`` on a capacity
    buffer of the rank's experts.  These launches are not the main path's (its counts were
    read before).  Returns each worst share of its limit."""
    rows = ctx.block(torch.arange(tokens.shape[0]), ctx.dp).tolist()
    blk, one = part.units[0]["b0"], model.units[0]["b0"]
    xla = ParallelCtx(None)
    out = {}
    with torch.inference_mode():
        x = model_layers.embed(model.embed, tokens[rows])
        b, s = x.shape[:2]
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        got = attention_layer.attention(blk.attn, x, pos, cfg, ctx,
                                        window=cfg.window, use_kernel=True)
        want = attention_layer.attention(one.attn, x, pos, cfg, xla,
                                         window=cfg.window, use_kernel=True)
        out["attention"] = hold_at_scale(
            got, want, f"{what}: attention block 0 on the rank's heads vs "
            "the 1x1 block")
        h = model_layers.rmsnorm(blk.attn.norm, x, cfg.norm_eps)
        # the first row: the plain version holds its fp32 scores
        q, k, v = (t[:1].transpose(1, 2) for t in
                   attention_layer._project_qkv(blk.attn, h, pos, cfg, ctx))
        got = flash_attention_cuda(q, k, v, causal=cfg.causal,
                                   window=cfg.window)
        out["flash_attention"] = hold_at_scale(
            got, flash_attention_plain(q, k, v, causal=cfg.causal,
                                       window=cfg.window),
            f"{what}: flash_attention at the rank's {q.shape[1]} q / "
            f"{k.shape[1]} kv heads (B=1, S={s}) vs its plain version")
        del got, want, h, q, k, v
        if blk.moe is not None:
            got, aux = moe_layer.moe_ffn(blk.moe, x, cfg, ctx,
                                         use_kernel=True)
            want, want_aux = moe_layer.moe_ffn(one.moe, x, cfg, xla,
                                               use_kernel=True)
            out["moe"] = hold_at_scale(
                got, want, f"{what}: MoE layer 0 on the rank's experts vs "
                "the 1x1 layer")
            hold(abs(float(aux) - float(want_aux))
                 <= 1e-6 * abs(float(want_aux)),
                 f"{what}: MoE aux loss {float(aux):.8g} vs the 1x1 layer's "
                 f"{float(want_aux):.8g}")
            w = ctx.weight(blk.moe.w_gate, tp_dim=0)  # the rank's experts
            e_loc = w.shape[0]
            cap = moe_layer.capacity(cfg.moe, s, moe_layer.padded_experts(
                cfg.moe, ctx.tp_size))
            buf = torch.randn((b * e_loc * cap, cfg.d_model),
                              generator=torch.Generator(
                                  device=DEVICE).manual_seed(SEED + 11),
                              device=DEVICE).to(w.dtype)
            te = torch.from_numpy(np.tile(np.arange(e_loc, dtype=np.int32),
                                          b))
            got = grouped_gemm_cuda(buf, w, te, bt=cap)
            out["grouped_gemm"] = hold_at_scale(
                got, grouped_gemm_plain(buf, w, te, bt=cap),
                f"{what}: grouped_gemm on the rank's {e_loc} experts "
                f"(T={buf.shape[0]}, D={cfg.d_model}, F={w.shape[2]}, "
                f"bt={cap}) vs its plain version")
            del got, want, w, buf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def shard_forwards(tp, dp) -> dict:
    cfg = get_config(LM_ARCH)
    model = card_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=torch.Generator(
                               device=DEVICE).manual_seed(SEED + 6),
                           device=DEVICE)
    ref, _, _, _ = run_forward(model, tokens, cfg, ParallelCtx(None),
                               use_kernel=True,
                               what=f"1x1 forward B={LM_BATCH} S={LM_SEQ}")
    out = {}
    for name, grid in (("1x2", tp), ("2x1", dp)):
        out[name] = shard_forward(model, tokens, cfg, grid, ref,
                                  f"{name} forward B={LM_BATCH} S={LM_SEQ}")
    del ref, model
    torch.cuda.empty_cache()
    return out


def shard_train(dp, rank: int) -> dict:
    """One AdamW step on 2x1 (FSDP + DP) against the 1x1 step on the same
    batch: the loss within TRAIN_SUMMA_RTOL, the rank's block of every
    parameter within TRAIN_MB_HOLD, of every first moment within
    TRAIN_MB_M_HOLD of its leaf's max |m|.  The 1x1 step runs on one rank
    at a time."""
    import torch.distributed as dist

    from repro_torch.dist.partitioning import block_of
    from repro_torch.models.convert import params_tree
    from repro_torch.train import train_step as ts

    cfg = get_config(LM_ARCH)
    opt = train_opt(TRAIN_STEPS)
    batch = SyntheticData(cfg, SHARD_TRAIN_BATCH, TRAIN_SEQ,
                          seed=SEED + 1).batch_at(0)
    ctx = ParallelCtx(dp, attention_impl="chunked")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = new_train_state(cfg, ctx, opt)
    with plain_guard(PLAIN_VERSIONS, "[shard]"):
        zero_counts()
        t0 = time.perf_counter()
        state, metrics = build_train_step(
            cfg, ctx, opt, microbatches=TRAIN_MICRO)(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hold_counts(read_counts(), {}, "[shard] 2x1 train step")
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    specs = ts.state_shardings(state, ctx)
    mine = {"p": params_tree(state["params"]), "m": state["opt"]["m"]}
    log(f"  2x1 train step, {SHARD_TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MICRO} microbatches: loss {loss:.6f}, wall {wall:.3f} s, "
        f"peak {peak / 2**30:.2f} GiB in this process")
    del state, metrics
    torch.cuda.empty_cache()

    def blocks(tree, spec_tree):
        return train_tree.tree_map(
            lambda x, spec: block_of(x, spec, dp) if spec else x, tree,
            spec_tree)

    ref = {}
    for turn in range(SHARD_WORLD):  # the 1x1 step, one rank at a time
        if turn == rank:
            one = train_ctx()
            st = new_train_state(cfg, one, opt)
            with plain_guard(PLAIN_VERSIONS, "[shard]"):
                st, met = build_train_step(
                    cfg, one, opt, microbatches=TRAIN_MICRO)(st, batch)
            ref = {"p": blocks(params_tree(st["params"]), specs["params"]),
                   "m": blocks(st["opt"]["m"], specs["opt"]["m"]),
                   "loss": float(met["loss"])}
            del st, met
            torch.cuda.empty_cache()
        dist.barrier()
    gap_p = max(float((x.float() - train_tree.at(ref["p"], path).float())
                      .abs().max())
                for path, x in train_tree.leaves(mine["p"]))
    gap_m = first_moment_gap(mine["m"], ref["m"])
    what = f"2x1 train step vs 1x1 ({cfg.num_layers} layers)"
    hold(abs(loss - ref["loss"]) <= TRAIN_SUMMA_RTOL * abs(ref["loss"]),
         f"{what}: loss {loss:.6f} against {ref['loss']:.6f} within rtol "
         f"{TRAIN_SUMMA_RTOL}")
    hold(gap_p < TRAIN_MB_HOLD, f"{what}: the rank's parameter blocks differ "
         f"by at most {gap_p:.3e} (< {TRAIN_MB_HOLD})")
    hold(gap_m <= TRAIN_MB_M_HOLD, f"{what}: first moments differ by at most "
         f"{gap_m:.3e} of the leaf's max |m| (<= {TRAIN_MB_M_HOLD})")
    del mine, ref
    torch.cuda.empty_cache()
    return dict(loss=loss, gap_p=gap_p, gap_m=gap_m, wall=wall, peak=peak)


def shard_moe(tp) -> dict:
    """mixtral-8x7b cut to SHARD_MOE_LAYERS layers at full width on 1x2:
    4 of its 8 experts per rank, 3 grouped_gemm launches per layer on the
    rank, the logits against the 1x1 forward at the bf16 pair hold."""
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=SHARD_MOE_LAYERS)
    model = init_model(cfg, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED), device=DEVICE, ep=2)
    tokens = prompt_tokens(cfg, 1, SEED + 9)
    ref, _, _, _ = run_forward(model, tokens, cfg, ParallelCtx(None),
                               use_kernel=True,
                               what=f"{MOE_ARCH} ({SHARD_MOE_LAYERS} layers) "
                                    f"1x1 forward 1 x {MOE_SEQ}")
    from repro_torch.dist.partitioning import shard_params

    part = shard_params(copy.deepcopy(model), tp)
    experts = part.units[0]["b0"].moe.w_gate.shape[0]
    hold(experts == cfg.moe.num_experts // 2,
         f"{MOE_ARCH} on 1x2: {experts} experts per rank")
    del part
    out = shard_forward(model, tokens, cfg, tp, ref,
                        f"{MOE_ARCH} ({SHARD_MOE_LAYERS} layers) 1x2 forward "
                        f"1 x {MOE_SEQ}")
    out["experts"] = experts
    del model, ref
    torch.cuda.empty_cache()
    return out


def shard_serve(dp) -> dict:
    """The scheduler on 2x1 (a slot pool of SHARD_SLOTS split over dp)
    against the 1x1 scheduler on the same trace: every request's greedy
    tokens equal.  fp32 twin at full width cut to SHARD_SERVE_LAYERS."""
    from repro_torch.dist.partitioning import shard_params

    cfg = get_config(LM_ARCH)
    model = card_model(cfg)
    twin, cut = cut_twin(model, cfg, SHARD_SERVE_LAYERS)
    del model
    torch.cuda.empty_cache()

    def trace():
        return ragged_trace(SHARD_REQUESTS, prompt_lens=SHARD_PROMPTS,
                            gen_lens=SHARD_GENS, vocab=cut.vocab_size,
                            seed=SEED)

    max_len = SHARD_PROMPTS[-1] + SHARD_GENS[-1]
    sharded = shard_params(copy.deepcopy(twin), dp)
    out = {}
    for name, ctx, m, backend in (
            ("1x1", ParallelCtx(None), twin, "dense"),
            ("2x1", ParallelCtx(dp), sharded, "dense"),
            ("2x1 paged", ParallelCtx(dp), sharded, "paged")):
        with torch.inference_mode(), plain_guard(PLAIN_VERSIONS, "[shard]"):
            zero_counts()
            t0 = time.perf_counter()
            res = Scheduler(m, cut, ctx, n_slots=SHARD_SLOTS,
                            max_len=max_len, backend=backend).run(trace())
            torch.cuda.synchronize()
            counts = read_counts()
        out[name] = dict(outputs=res["outputs"], steps=res["steps"],
                         wall=time.perf_counter() - t0, launches=counts)
        hold_counts(counts, {"flash_attention": SHARD_REQUESTS
                             * attention_blocks(cut)},
                    f"[shard] {name} scheduler ({SHARD_REQUESTS} prefills)")
    for name in ("2x1", "2x1 paged"):
        hold(out[name]["outputs"] == out["1x1"]["outputs"],
             f"{name} scheduler ({SHARD_SLOTS} slots, {SHARD_SLOTS // 2} per "
             f"rank, {out[name]['steps']} steps): every request's greedy "
             "tokens equal the 1x1 run's")
    return {k: dict(v, outputs=None) for k, v in out.items()}


def shard_child(argv: list) -> None:
    """One rank of [shard]: joins the gloo world of SHARD_WORLD processes
    (``launch.mesh.spawn_gloo_ranks``' arguments), runs the cases, prints
    its result as ``SHARD-RESULT {json}``."""
    import torch.distributed as dist

    rank = int(argv[argv.index("--rank") + 1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=argv[
        argv.index("--init-method") + 1], rank=rank, world_size=SHARD_WORLD)
    tp = Grid.from_process_group(1, SHARD_WORLD, device=DEVICE)
    dp = Grid.from_process_group(SHARD_WORLD, 1, device=DEVICE)
    out = {"rank": rank}
    out["forward"] = shard_forwards(tp, dp)
    out["train"] = shard_train(dp, rank)
    out["moe"] = shard_moe(tp)
    out["serve"] = shard_serve(dp)
    out["peak"] = torch.cuda.max_memory_allocated()
    print("SHARD-RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def phase_shard() -> dict:
    """[shard] (see SHARD_WORLD): spawns the ranks, echoes their lines,
    and returns rank 0's result with each rank's peak memory."""
    from repro_torch.launch.mesh import spawn_gloo_ranks

    log(f"[shard] {SHARD_WORLD} gloo processes on the one card: "
        f"per-rank programs on sharded parameters (collectives through "
        f"host memory; no collective across cards is measured)")
    t0 = time.perf_counter()
    outs = spawn_gloo_ranks(str(Path(__file__).resolve()), ["--shard"],
                            SHARD_WORLD, timeout=900)
    results = []
    for rank, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("SHARD-RESULT "):
                results.append(json.loads(line[len("SHARD-RESULT "):]))
            else:
                log(f"  [rank {rank}] {line}")
    if len(results) != SHARD_WORLD:
        raise AssertionError(f"[shard]: {len(results)} of {SHARD_WORLD} "
                             "ranks reported")
    out = results[0]
    out["peaks"] = [r["peak"] for r in results]
    out["wall"] = time.perf_counter() - t0
    log(f"  [shard] took {out['wall']:.1f} s; peak device memory per process "
        f"{[f'{p / 2**30:.2f} GiB' for p in out['peaks']]}")
    return out


def main() -> None:
    kind, count = phase_device()
    phase_build()
    t0 = time.perf_counter()
    # make_case's operands do not depend on the fill: one call gives the
    # dense instance (fill 1.0 masks are all-live and unused) and the masks
    # of the block-sparse one; its A is also make_rank_case's B
    a_h, b_h, a_mask, b_mask = make_case(N, BLOCK, SPARSE_FILL, seed=SEED)
    log(f"[data] make_case({N}, {BLOCK}, fill={SPARSE_FILL}, seed={SEED}) "
        f"on the host: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rcsr = make_rank_factors(N, BLOCK, MAX_RANK, seed=SEED)
    mm = DistributedMatmul(Grid.local(DEVICE), strategy="taskbased",
                           k_blocks=K_PANELS, local_matmul="pallas")
    sparse_plan = mm.plan(N, N, N, a_mask=a_mask, b_mask=b_mask)
    rank_plan = mm.plan(N, N, N, a_ranks=rcsr)
    log(f"[data] make_rank_factors({N}, {BLOCK}, {MAX_RANK}, seed={SEED}) "
        f"on the host: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rank_operands(rcsr, rank_plan)  # the factor layout, memoized on rcsr
    layout_s = time.perf_counter() - t0
    log(f"[data] the factors' layout on the host (rank_operands, memoized on "
        f"rcsr; a caller's first product pays it): {layout_s:.3f} s")
    errs = phase_kernels(sparse_plan, rank_plan, rcsr.r_pad)
    lm_cfg = get_config(LM_ARCH)
    errs["flash_attention"] = phase_attention_kernel(lm_cfg)
    torch.cuda.reset_peak_memory_stats()
    a = torch.from_numpy(a_h).to(DEVICE)
    b = torch.from_numpy(b_h).to(DEVICE)
    del a_h, b_h
    dense_launches, dense_wall = phase_dense(mm, a, b)
    torch.cuda.empty_cache()
    sparse_launches, sparse_wall = phase_sparse(mm, a, b, a_mask, b_mask)
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    tuned = phase_tuned(mm, a, b, a_mask, b_mask)
    summa_25d = phase_25d(a, b)
    rank = phase_rank(rcsr, a)
    phase_rank_fallback()
    torch.cuda.empty_cache()
    times = phase_times(a, b, sparse_plan, rank_plan, rcsr.r_pad)
    log(f"  whole products (host clock, ending in synchronize): dense "
        f"{dense_wall:.3f} s, block-sparse {sparse_wall:.3f} s; peak device "
        f"memory over the two products {peak / 2**30:.2f} GiB")
    log(f"  rank-sparse product, factor layout already cached: grouped "
        f"route {rank['pallas']['wall']:.3f} s "
        f"(peak {rank['pallas']['peak'] / 2**30:.2f} GiB), xla route "
        f"{rank['xla']['wall']:.3f} s "
        f"(peak {rank['xla']['peak'] / 2**30:.2f} GiB); a first product "
        f"adds the layout's {layout_s:.3f} s")
    log(f"  tuned products (host clock): dense "
        f"{tuned['dense']['wall']:.3f} s ({tuned['dense']['launches']} "
        f"tiled_matmul, {tuned['dense']['tuned']['strategy']}), "
        f"block-sparse {tuned[f'block-sparse fill {SPARSE_FILL}']['wall']:.3f}"
        f" s")
    del a, b
    torch.cuda.empty_cache()
    phase_tuner()
    tuner = phase_autotune()
    nonuniform = phase_nonuniform(tuner)
    log(f"  nonuniform product (host clock, warm): {nonuniform['warm_wall']:.3f}"
        f" s for {nonuniform['work']:.4f} x the uniform product's FLOP "
        f"(uniform: {dense_wall:.3f} s taskbased, "
        f"{tuned['dense']['wall']:.3f} s tuned); peak "
        f"{nonuniform['warm_peak'] / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    ladder = phase_contract_ladder()
    families = phase_contract_families()
    chain = phase_contract_chain()
    log(f"  [contract] took {time.perf_counter() - t0:.1f} s: ladder cold "
        f"{ladder['cold']:.3f} s, warm {ladder['warm']:.3f} s, eager "
        f"{ladder['eager']:.3f} s, peak {ladder['peak'] / 2**30:.2f} GiB; "
        f"families {sum(f['wall'] for f in families.values()):.3f} s; "
        f"chain {chain['wall']:.3f} s (warm {chain['warm']:.3f} s)")
    filt = phase_filter()
    for frac, r in filt["rows"].items():
        log(f"  [filter] frac {frac:g}: launches {r['launches']}, live blocks "
            f"{r['live']}, gemm tasks {r['gemms']}, filter_bound "
            f"{r['bound']:.6g}, ||C - C_exact||_F {r['err']:.6g}, wall "
            f"{r['wall']:.4f} s, peak {r['peak'] / 2**30:.2f} GiB")
    fc = filt["chain"]
    log(f"  [filter] chain: launches {fc['launches']}, bounds {fc['bounds']}, "
        f"step 2's fill {fc['fills'][1]:.4f} (unfiltered {fc['fills'][0]:.4f})"
        f", error {fc['err']:.6g} within {fc['limit']:.6g}, wall "
        f"{fc['wall']:.4f} s; [filter] {filt['wall']:.1f} s")
    lm = phase_lm(lm_cfg)
    times["flash_attention"] = lm["times"]
    log(f"  LM forward (host clock, ending in synchronize): B={LM_BATCH} "
        f"S={LM_SEQ} {lm['wall']:.3f} s through the kernel (peak "
        f"{lm['peak'] / 2**30:.2f} GiB), {lm['plain_wall']:.3f} s with plain "
        f"attention (peak {lm['plain_peak'] / 2**30:.2f} GiB), "
        f"{lm['summa_wall']:.3f} s with summa FFN projections; B=1 "
        f"S={LM_LONG_SEQ} {lm['long_wall']:.3f} s (peak "
        f"{lm['long_peak'] / 2**30:.2f} GiB)")
    auto = phase_auto_forward()
    log(f"  auto forward ({AUTO_LAYERS} layers, B=1 S={AUTO_SEQ}): warm "
        f"{auto['wall']:.3f} s (summa {auto['summa_wall']:.3f} s), "
        f"{auto['launches']} flash_attention launches")
    moe = phase_moe()
    for arch, key in ((MOE_ARCH, "mixtral"), (KIMI_ARCH, "kimi")):
        r = moe[key]
        log(f"  {arch} forward (host clock, ending in synchronize; "
            f"{MOE_LAYERS if key == 'mixtral' else KIMI_LAYERS} layers): "
            f"warm {r['wall']:.3f} s, first {r['cold']:.3f} s, peak "
            f"{r['peak'] / 2**30:.2f} GiB, launches {r['launches']}")
    recurrent = phase_recurrent()
    frontends = phase_frontends()
    for arch, r in ((RG_ARCH, recurrent["rg"]), (XL_ARCH, recurrent["xl"]),
                    (HUBERT_ARCH, frontends["hubert"]),
                    (f"{VLM_ARCH} ({VLM_LAYERS} layers)", frontends["vlm"])):
        log(f"  {arch} forward (host clock, ending in synchronize): warm "
            f"{r['wall']:.3f} s, first {r['cold']:.3f} s, peak "
            f"{r['peak'] / 2**30:.2f} GiB, {r['launches']} flash_attention "
            f"launches, greedy {r['greedy']}")
    serve = phase_serve()
    serve_moe = phase_serve_moe()
    train = phase_train()
    train_moe = phase_train_moe()
    dry = phase_dryrun(a_mask, b_mask)
    examples = phase_examples()
    shard = phase_shard()
    fixed, cont, quant = serve["fixed"], serve["continuous"], serve["kv_quant"]
    for label in ("first", "warm"):
        pre, dec = fixed[label]["walls"]
        log(f"  {LM_ARCH} serving, fixed batch {SERVE_BATCH} x {SERVE_PROMPT}"
            f" + {SERVE_GEN} ({label} call; host clock ending in "
            f"synchronize): prefill {SERVE_BATCH * SERVE_PROMPT / pre:,.0f} "
            f"tok/s ({pre:.4f} s), decode "
            f"{SERVE_BATCH * (SERVE_GEN - 1) / dec:,.0f} tok/s ({dec:.4f} s),"
            f" peak {fixed[label]['peak'] / 2**30:.2f} GiB")
    log(f"  {LM_ARCH} serving, continuous over {4 * SERVE_BATCH} requests on "
        f"{SERVE_BATCH} slots: dense {cont['dense']['tokens_per_s']:,.0f} "
        f"tok/s (p50 {cont['dense']['p50_step_ms']:.3f} / p99 "
        f"{cont['dense']['p99_step_ms']:.3f} ms), paged "
        f"{cont['paged']['tokens_per_s']:,.0f} tok/s (p50 "
        f"{cont['paged']['p50_step_ms']:.3f} / p99 "
        f"{cont['paged']['p99_step_ms']:.3f} ms); kv_quant cache "
        f"{quant['bytes'] / 2**20:.1f} MiB against bf16's "
        f"{quant['bf16_bytes'] / 2**20:.1f} MiB")
    pre, dec = serve["rg"]["walls"]
    log(f"  {RG_ARCH} serving, fixed batch {RG_SERVE_BATCH} x {SERVE_PROMPT} "
        f"+ {RG_SERVE_GEN}: prefill {RG_SERVE_BATCH * SERVE_PROMPT / pre:,.0f}"
        f" tok/s ({pre:.4f} s), decode "
        f"{RG_SERVE_BATCH * (RG_SERVE_GEN - 1) / dec:,.0f} tok/s "
        f"({dec:.4f} s), peak {serve['rg']['peak'] / 2**30:.2f} GiB")
    for label in ("first", "warm"):
        r = serve_moe[label]
        log(f"  {MOE_ARCH} serving ({MOE_LAYERS} layers), fixed batch "
            f"{SERVE_BATCH} x {SERVE_PROMPT} + {SERVE_GEN} ({label}): prefill "
            f"{SERVE_BATCH * SERVE_PROMPT / r['prefill_s']:,.0f} tok/s, decode "
            f"{SERVE_BATCH * (SERVE_GEN - 1) / r['decode_s']:,.0f} tok/s, "
            f"step p50 {r['p50']:.3f} / p99 {r['p99']:.3f} ms, peak "
            f"{r['peak'] / 2**30:.2f} GiB")
    mc = serve_moe["continuous"]
    log(f"  {MOE_ARCH} serving, continuous[dense] over {mc['requests']} "
        f"requests on {SERVE_BATCH} slots: {mc['tokens_per_s']:,.0f} tok/s "
        f"(p50 {mc['p50_step_ms']:.3f} / p99 {mc['p99_step_ms']:.3f} ms), "
        f"peak {mc['peak'] / 2**30:.2f} GiB; a decode step "
        f"{serve_moe['decode_kernels']} device kernels; [serve] {MOE_ARCH} "
        f"{serve_moe['wall']:.1f} s")
    log(f"  {MOE_ARCH} train step ({MOE_TRAIN_LAYERS} layers), "
        f"{MOE_TRAIN_BATCH} x {TRAIN_SEQ} tokens in {MOE_TRAIN_MICRO} "
        f"microbatches: first {train_moe['walls'][0]:.4f} s, warm "
        f"{train_moe['warm']:.4f} s, {train_moe['tokens_per_s']:,.0f} "
        f"tokens/s, peak {train_moe['peak'] / 2**30:.2f} GiB, launches "
        f"{train_moe['counts']}, losses {train_moe['losses']}; at 1 layer "
        f"the first update's worst leaf against the fp32 twin's "
        f"{ {k: float(f'{v:.3e}') for k, v in train_moe['hold']['gaps'].items()} }"
        f" (half-batch control "
        f"{ {k: float(f'{v:.3e}') for k, v in train_moe['hold']['fault'].items()} }"
        f"), losses within rtol {max(train_moe['hold']['rel']):.3e} of the "
        f"twin's on the same weights; [train] {MOE_ARCH} "
        f"{train_moe['wall']:.1f} s")
    log(f"  {LM_ARCH} train step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_MICRO} microbatches (host clock ending in synchronize): "
        f"first {train['walls'][0]:.4f} s, warm {train['warm']:.4f} s, "
        f"{train['tokens_per_s']:,.0f} tokens/s, peak "
        f"{train['peak'] / 2**30:.2f} GiB, launches {train['counts']}; "
        f"[train] {train['wall']:.1f} s")
    for key in ("prefill", "train", "decode"):
        d = dry[key]
        log(f"  [dryrun] {LM_ARCH} {key}: warm {d['wall']:.4f} s, bound "
            f"{d['bound_s']:.4f} s ({d['dominant']}), bound/wall "
            f"{d['bound_over_wall']:.4f}, model FLOP share "
            f"{d['mfu']:.4f}; counted peak {d['peak'] / 2**30:.2f} GiB "
            f"(peak above the arguments at {d['ratio']:.4f} of the "
            f"allocator's); [dryrun] {dry['wall']:.1f} s")
    for name, e in examples.items():
        if name != "wall":
            log(f"  [examples] {name}: {e['wall']:.3f} s, launches "
                f"{e['launches']}")
    log(f"  {XL_ARCH} chunkwise mLSTM forward: warm "
        f"{recurrent['xl_chunked']['wall']:.3f} s, peak "
        f"{recurrent['xl_chunked']['peak'] / 2**30:.2f} GiB")
    log(f"  [25d] 2.5D {summa_25d['wall_25d']:.3f} s and tuple-axis "
        f"{summa_25d['wall_tuple']:.3f} s against the 2-D route's "
        f"{summa_25d['wall_2d']:.3f} s, {summa_25d['launches_25d']} "
        f"tiled_matmul launches each")
    for name in ("1x2", "2x1"):
        f = shard["forward"][name]
        log(f"  [shard] {LM_ARCH} forward on {name} (rank 0, {LM_BATCH} x "
            f"{LM_SEQ}): {f['rel']:.4g} of max |logit| from the 1x1 forward, "
            f"argmax agrees at {f['agree']:.4f}; wall {f['wall']:.3f} s, peak "
            f"{f['peak'] / 2**30:.2f} GiB, holds {f['held'] / 2**30:.2f} GiB "
            f"of parameters, launches {f['launches']}; block 0 at its "
            f"limits' shares {f['layers']}")
    t, m = shard["train"], shard["moe"]
    log(f"  [shard] {LM_ARCH} train step on 2x1 (rank 0): loss "
        f"{t['loss']:.6f}, parameter gap {t['gap_p']:.3e}, first-moment gap "
        f"{t['gap_m']:.3e}; wall {t['wall']:.3f} s, peak "
        f"{t['peak'] / 2**30:.2f} GiB")
    log(f"  [shard] {MOE_ARCH} ({SHARD_MOE_LAYERS} layers) on 1x2 (rank 0): "
        f"{m['experts']} experts, launches {m['launches']}, "
        f"{m['rel']:.4g} of max |logit|, agreement {m['agree']:.4f}; block "
        f"0 at its limits' shares {m['layers']}")
    sv = shard["serve"]
    log(f"  [shard] scheduler on 2x1: dense {sv['2x1']['steps']} steps in "
        f"{sv['2x1']['wall']:.3f} s, paged {sv['2x1 paged']['steps']} steps "
        f"in {sv['2x1 paged']['wall']:.3f} s (1x1: {sv['1x1']['wall']:.3f} "
        f"s); [shard] {shard['wall']:.1f} s")
    launches = {"tiled_matmul": dense_launches, "bsmm": sparse_launches,
                "grouped_gemm": rank["pallas"]["launches"],
                "flash_attention": lm["launches"]}
    sources = {"tiled_matmul": ("src/repro_torch/csrc/tiled_matmul.cu",
                                "src/repro/kernels/tiled_matmul.py:32"),
               "bsmm": ("src/repro_torch/csrc/bsmm.cu",
                        "src/repro/kernels/bsmm.py:30"),
               "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                                "src/repro/kernels/grouped_gemm.py:28"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:30")}
    kernels = []
    for name, (source, replaces) in sources.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)


if __name__ == "__main__":
    if "--shard" in sys.argv:
        shard_child(sys.argv)
    else:
        main()

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout; it imports the port from ``src/`` there
and never imports jax or the JAX package.  Phases, each fatal on failure:

  1. device: the card's name and power limit; the CUDA kernels are built
     from ``src/repro_torch/kernels/csrc`` (build seconds printed);
  2. each kernel against its plain PyTorch version on the card, bit-exact,
     over (b, L), ragged n and m, τ and base planes with BIG lanes; the
     flash forward at head dim 80, and ptxas's registers of every bf16
     forward instance (``flash_fwd_wg_kernel``, D 16/64/80/128, with and
     without the lse), none with a spill;
  3. the main path at the size of the paper's Review dataset
     (n = 12,886,488, L = 16, b = 2): ``build_bst``, ``make_batch_searcher``
     at τ = 1, 2, 3 and ``topk_batch(k=10)`` for 64 queries, checked
     against the ``LinearScan`` distance kernel and a numpy host check,
     with every kernel's launch count read around the run;
  4. times (CUDA events, after a warm-up): each kernel at the main path's
     shapes beside its bound, its plain version and a library call, the
     end-to-end ``topk_batch`` and the peak device memory;
  5. the segmented path at the Review size: 12,886,488 token sets
     (vocabulary 256, 8-39 distinct tokens each) sketched on the card by
     ``bbit_minhash`` (L = 16, b = 2), their ``pack_sets`` payloads,
     ingested into ``SegmentedIndex(auto_merge=True, delta_cap=2^22)``
     with 1% of the ids deleted; for 64 queries (32 perturbed database
     sets, 32 fresh sets) ``topk_batch``, ``search_columns_batch`` and
     the Jaccard re-ranked ``topk_batch`` checked against the
     ``LinearScan`` kernel and numpy, the fan-out (``use_arena=False``)
     against the fused path, the kernels' launches read around the run,
     and the new kernels timed at its shapes;
  6. the plane fallback: the CP geometry (L = 32, b = 2) at 2^20 uniform
     rows, where b·S > 32 sends the suffix store through the
     ``sparse_verify_arena`` kernel; suffix and full layouts checked
     against each other and the brute force;
  7. serving smollm-135m at full width (30 layers, d_model 576, GQA 9/3,
     vocabulary 49,152; random weights from ``--seed``, f32 masters,
     bf16 compute): the flash kernel against its plain version over
     masks, dtypes (bf16: the wgmma kernel; float32: the scalar
     one), D 16/64/128, S up to 2,000 (ragged) and query blocks at an
     offset, and the GQA path; then 8 requests of 2,000 prompt tokens
     and 48 greedy tokens through ``launch.serve.generate`` with the
     wgmma kernel's 30 launches per prefill counted, its logits
     and greedy tokens held against the plain ``attn_impl="ref"`` path,
     prefill and decode times, peak memory, and the kernel timed on
     contiguous and on the model's strided views beside its bound, its
     plain version, the float32 route and
     ``scaled_dot_product_attention``;
  8. hubert-xlarge at full width and depth (48 layers, 16 heads of 80,
     bidirectional; random weights from ``--seed``): one ``forward`` of
     2 x 1,000 frame embeddings with the bf16 flash kernel's 48 launches
     counted, its logits no farther from the f32 plain path than the bf16
     plain path's, and the float32 route's within 2^-5 of it; the kernel
     at that shape timed beside its bound, plain version and SDPA;
  9. ``zbit_cws`` at the SIFT (2^22 rows, dim 128, L 32, b 4) and GIST
     (2^18 rows, dim 960, L 64, b 8) shapes, rows/s, the first 4,096
     rows held against the CPU run under a 4-ulp rule;
 10. the other backends: (a) the static MI-bST (2 blocks) on phase 3's
     Review sketches, ``mi_search_batch`` at τ = 1, 2, 3 for the 64
     queries held against the scan kernel at τ, its candidates and
     ``choose_plan``; (b) the static sharded bST (4 shards) there,
     ``make_sharded_searcher`` (scan) at τ = 1-3, ``gather_ids`` and
     ``gather_topk`` against the scan, a stable sort and numpy, and one
     ``verify="gather"`` call; the MI candidate verify
     (``hamming_distances_gather``, one launch per call over all
     queries, held bit for bit against its plain version at τ 3's
     captured shape and timed beside its bound and the old chain of
     gather, copy and batched scan from the same ids) and the batched
     verify (one per call over all shards) counted and timed; (c) ``SegmentedIndex`` with the
     multi and sharded backends and ``ShardedSegmentedIndex`` over bst
     stacks on 1,200,000 of phase 5's token sets (delta_cap 2^18), 1%
     deleted and a live delta buffer: top-k and range planes against the
     scan kernel, the fan-out against the fused path, the stacks' Jaccard
     re-rank against numpy; (d) SIH, MIH and HmSearch on 2^19 of phase
     3's rows, masks against ``LinearScan``, MIH's and HmSearch's
     verifies through ``hamming_distances_gather``.  Range-search and top-k times beside the
     bst backend's of phases 4 and 5;
 11. the retrieval server (``repro_torch.serving`` and ``store``) on
     4,500,000 of phase 5's token sets (L 16, b 2, Wp 8, delta_cap 2^20,
     auto_merge): (1) a child process ingests them into a durable
     collection through ``Scheduler.submit_insert`` (chunks of 2^16,
     with payloads), deletes 1% through ``submit_delete``, writes its
     top-k, range (τ 2) and Jaccard re-rank answers, syncs the journal
     and dies by ``os._exit``; (2) ``CollectionRegistry.open`` recovers
     it on the card and must answer bit for bit as the child did, with
     journal records replayed; (3) the threaded scheduler (``max_batch``
     64, 2 ms flush, after ``warmup``) serves 8 client threads 1,024
     top-k, 64 re-ranked and 16 range requests, each held against the
     scan kernel, a stable sort and numpy, with rows 2, 3 and 5 counted
     and no program built after the warm-up; p50 / p99, queries/s and
     the batch fill printed; (4) a burst of 4 × max_queue requests with
     admission, the degradation ladder and the breaker on: the shed
     count equals submitted minus admitted, and every admitted answer
     equals an undegraded run at its effective (k, rerank) and τ; the
     next insert takes the next id; (5) ``launch.serve.main`` with
     ``--ingest --data-dir D --rerank jaccard``, ``--ingest --recover``
     and ``--retrieval --arch smollm-135m`` returns 0;
 12. the dedup-fed trainer: (a) ``SketchDedupPipeline`` at a trainer's
     scale (8,192 candidates of 2,048 tokens a step, vocabulary 49,152,
     L 16, b 2, τ 2, 16 steps), every step's accepted rows checked on
     the host with numpy (pairwise > τ, and > τ from the history the
     bST holds; ROADMAP F7: rows accepted since its last doubling are
     not searched, as in the JAX package), the
     history search's verify launches counted, the first 2 steps held
     bit for bit against the CPU pipeline; (b) the FA-2 backward kernel
     against its plain version at smollm's train shape (f32 and bf16),
     hubert's and a windowed, capped D = 128 case, each twice for the
     same bits, the forward's lse against the plain lse, no ptxas spill
     in any bf16 backward kernel, both passes timed at the D = 128 case
     and at the train shape beside the bound, the latter also beside
     SDPA's backward; (c) smollm-135m trained
     at full width through ``launch.train.main`` (--dedup batches of 8 x
     2,048 tokens, bf16 compute, remat, AdamW, 8 steps, a checkpoint
     every 4) with the flash forward's and backward's launches counted,
     one step held against the ``attn_impl="ref"`` path, step time,
     tokens/s, peak memory and a profiled step (the restart drill of
     ``launch.train.main`` runs in phase 16 (b), over two ranks).
 13. the MoE, SSM and hybrid families served (granite-moe-3b-a800m,
     mamba2-1.3b, zamba2-2.7b at full width and depth; 8 x 2,000 prompt
     tokens, 48 greedy; deepseek-moe-16b is served whole in phase 18):
     flash launches counted a prefill, the flash
     wrapper held against its plain version at each family's attention
     shape, the prefill against the plain and f32 paths, MoE routing
     differences and drops, prefill-then-decode against the forward,
     prefill and decode times, peak memory.
 14. the port's tools on the card, each a process: eval_recall --check,
     capacity, recovery and the overload tool's full and --smoke bursts
     must return 0;
 15. the mesh layer on torch.distributed process groups, each rank a
     process of its own, after the flash wrapper is held at yi-9b's
     prefill shape as phase 13 holds each family's, and held and timed
     at one of two model ranks' heads (16 of 32, 2 of 4 KV): (a) one rank
     (nccl), mesh (1, 1):
     granite-moe-3b-a800m through the expert-parallel MoE and yi-9b
     through the sequence-parallel decode, mamba2-1.3b and zamba2-2.7b
     at full width and depth (bf16 parameters, 8 x 2,000 prompt tokens +
     48 greedy; the two SSM models the prefill and 3 decode steps)
     against the same models with no mesh — kept (token, slot) masks,
     the second rule of phase 7, greedy tokens where the margin is sure,
     32 / 48 / 0 / 9 flash launches a prefill; (b) two ranks sharing the
     card (gloo), mesh (1, 2), the dense layers tensor parallel: half
     the heads, ffn, vocabulary (where 2 divides it), experts, SSM heads
     and cache slots a rank, each rank's parameter bytes against the
     leaves it holds whole (yi-9b's half of (a)'s within 1%), peak a
     rank, held to (a)'s rules against (a) over the prefill and 3 decode
     steps (yi-9b, mamba2 and zamba2 on 2 of the 8 prompts), 32 / 48 /
     0 / 9 flash launches a prefill on each rank, the SSM models' conv
     and SSM states after the prefill (units 0 and -1) against (a)'s
     no-mesh states on the rank's heads, the new K/V on the owner rank
     only (zamba2's shared block: at its slot on every rank's heads),
     the collectives' bytes and seconds,
     which collectives gloo runs on CUDA tensors; (c) two data ranks on
     the card: granite's prefill with one MoE group over both ranks'
     rows keeps one rank's mask; ``launch.serve`` (smollm-135m, phase
     7's requests) under torch.distributed.run with ``--model-ranks 2``
     prints one rank's tokens, each rank's prefill's and last step's
     logits one rank's within 2^-5 of the largest.
 16. training under a mesh of ranks and the dry-run tooling: (a)
     ``launch.dryrun``'s count of phase 12 (c)'s step (``meta`` tensors,
     mesh (1, 1)): its argument bytes equal the card's parameters,
     moments and batch exactly, its FLOPs and bytes beside the measured
     step (achieved TFLOP/s, t_bound / measured), its peak beside
     ``max_memory_allocated``; every architecture's train_4k cell counted
     at (16, 16) in processes of their own (bytes a rank with the dense
     leaves over "model", fits, bottleneck); (b)
     ``python -m torch.distributed.run --nproc-per-node 2 -m
     repro_torch.launch.train`` (smollm-135m at full size, FSDP over two
     gloo ranks on the card, phase 12 (c)'s batches): losses and norms
     against phase 12's one rank, the drill (both ranks exit 13, the rerun
     resumes bit for bit), the checkpoint restored with no mesh, 60 lse
     forwards and 30 backwards a step on each rank; (c)
     granite-moe-3b-a800m cut to 8 layers at mesh (1, 2), 20 experts and
     12 of 24 heads a rank (attention tensor parallel), and mamba2-1.3b
     cut to 8 layers there, 32 of 64 SSM heads a rank (the gated norm
     summed over "model"), through ``make_train_step`` under
     ``use_mesh``: kept masks, losses, norms and the updated expert,
     ``wz`` / ``wx`` / ``out_proj`` shards against one rank, granite's 16
     lse forwards and 8 backwards a step on each rank, none for mamba2.
 17. the families trained: mamba2-1.3b, hubert-xlarge,
     granite-moe-3b-a800m (all 32 layers) and zamba2-2.7b at full width
     and depth through ``launch.train.main`` (f32 masters, bf16 compute,
     remat, AdamW, weights drawn on the card), each step first counted by
     ``launch.dryrun`` at mesh (1, 1) in a process of its own (started
     beside phase 16 (b)): 8 x 2,048 tokens (hubert: frames) a step, the
     batch halved where the count passes 72 GB (granite: 4 x 2,048), in
     the count's microbatches; 3 steps with finite losses and norms, the
     step time, tokens/s and the peak beside the count; the flash
     launches derived from the config (two lse forwards under remat and
     one backward for each attention layer a microbatch runs); step 1
     held against ``attn_impl="ref"`` (mamba2: float32 compute) on the
     same weights and batch, granite's routings that differ printed;
     then rows 6l and 7 at zamba2's causal and hubert's bidirectional
     D 80 training shapes held against their plain versions and timed
     beside the bound and SDPA.
 18. the registry's three largest dense architectures and
     deepseek-moe-16b served whole, one at a time on the emptied card,
     bf16 parameters drawn there: gemma2-27b (local / global layers,
     both softcaps, the rolling cache) at its 8,192-token context (2 x
     8,144 prompt tokens + 48 greedy), command-r-35b, chameleon-34b and
     deepseek-moe-16b (28 MoE layers of 64 experts, top-6 and 2 shared)
     at phase 7's requests: the flash launches a prefill (46 / 40 / 48 /
     28, gemma2's split by window and cap), the flash wrapper at each
     prefill shape against ``blockwise_attention``, the kernel path's
     prefill logits under phase 7's second rule against an f32 plain
     path streamed a unit at a time (2 requests; deepseek's routings
     that differ and dropped pairs printed), prefill and decode times,
     peak memory and a profiled prefill; gemma2's prefill-then-decode
     across its wrapped ring and deepseek's against the full forward (2
     units at full width, f32).

Phase 2 also sweeps the batched launches (grid.z over the batch) of the
scan and the verify: batch 1, 3, 4 and 64, ragged n and m, shared and
per-entry query planes, base planes with BIG lanes; and the candidate
verify: b 1/2/4/8, W 1-2, n not a multiple of 32, counts of 0, ragged
and C, ids at 0 and n - 1.

Phase 2 also sweeps the flash kernel at head dim 80 on both routes.
Phase 5 also puts half of its index's block bytes in the cold tier
(pinned host memory, staged per query) and holds top-k, range and the
re-rank against the all-hot bits at equal launches, with the staging
time; runs one ``explain=True`` re-rank and traced calls (the Chrome
trace goes to ``build/chip_smoke_trace.json``); phase 6 one cold call.

Each phase prints its seconds.  The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the rest of the repository beside it,
the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The paper's Review dataset (configs/registry.py in the JAX package):
# its size and sketch geometry, and the layer boundaries the paper reports.
REVIEW_N = 12_886_488
REVIEW_L = 16
REVIEW_B = 2
PAPER_LM, PAPER_LS = 8, 11
M_QUERIES = 64
# phase 10 (b) holds gather_ids and gather_topk against the scan kernel
# and a stable sort on these rows of its 64 queries (cut from all 64, each
# a host pass over 12.9 M ids, to make room for tensor parallelism in
# phase 15; the searches themselves still run all 64)
GATHER_CHECK_ROWS = (0, 1, 31, 63)
TOPK = 10
BIG = 1 << 20

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# 32-bit non-tensor rate (listed for float32; no int32 figure is given).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SWEEP_BL = [(1, 8), (2, 16), (2, 32), (4, 32), (8, 64), (4, 100)]
SWEEP_N = [1, 130, 4097, 1_000_003]
SWEEP_M = [1, 3, 8, 64]
SWEEP_TAU = [0, 3]
SWEEP_BS = [(1, 32), (2, 16), (2, 4), (4, 8), (8, 4), (2, 0)]
SWEEP_T = [1, 7, 100_003]
SWEEP_WP = [1, 8, 33]
METRICS = ("jaccard", "cosine", "containment")

# The segmented cell: the recall harness's corpus shape
# (tools/eval_recall.py:46-66) at the Review size, ingested with a delta
# buffer of DELTA5_CAP: its size-tiered ingest builds 20 M rows (3
# flushes of 2^22, one merge into 2^23) where a buffer of 2^20 built 44 M
# (12 flushes, 10 merges), and ends on the same stack (2^23 + 2^22 rows
# and 303,576 in the buffer) — cut to make room for phase 16.
VOCAB = 256
SET_MIN, SET_MAX = 8, 40              # rng.integers(8, 40): 8..39 tokens
DELTA_CAP = 1 << 20
DELTA5_CAP = 1 << 22
GEN_CHUNK = 1 << 19
DELETE_FRAC = 0.01
# The CP geometry (configs/registry.py:92) at 2^20 rows: the plane fallback.
CP_L, CP_B, CP_N, CP_DELTA = 32, 2, 1 << 20, 1 << 19

# The serving cell: smollm-135m at full width (configs/smollm_135m.py), 8
# requests of 2,000 prompt tokens and 48 greedy tokens (s_max 2,048, its
# context).  The flash sweep: (causal, window, cap) x f32/bf16 x D 64/128
# x S, with the Pallas tests' tolerances.  Logits of the kernel path, the
# plain path and the f32 plain path are held within LOGIT_RTOL of the
# largest logit: bf16 keeps 8 significant bits (a relative rounding of
# up to 2^-9), and each of the 30 layers rounds its activations at a
# dozen places; as a random walk that is sqrt(360) x 2^-9 ≈ 3.7% of the
# logits' scale, and 2^-5 ≈ 3.1% of the largest logit is the tolerance.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "smollm-135m", 8, 2000, 48
FLASH_MASKS = [(True, 0, 0.0), (False, 0, 0.0), (True, 96, 0.0),
               (True, 0, 30.0)]
FLASH_S = [128, 384, 1000, 2000]
LOGIT_RTOL = 2 ** -5
# bf16 attention is also held row by row: max |got - want| over a row's D
# outputs, over the row's largest |want|.  Rounding the output to bf16 on
# both paths can differ by one ulp, at most 2^-7 of a row's largest
# element, and P rounded to bf16 adds about 0.1%; dropping one 64-key
# tile fails the limit on every late row of a causal S = 2000
# (tests/test_torch_flash.py::test_row_error_sees_a_dropped_tile).  The
# absolute 2e-2 says little there, where |out| is 0.03-0.06.
FLASH_BF16_ROW_RTOL = 1.5e-2
COMPARE_STEPS = 4
# bf16 tensor-core peak of the H100 SXM (NVIDIA data sheet, dense): the
# bound of attention, whose FLOPs are matrix products.
PEAK_BF16_FLOPS = 989e12
# The designs the query-major packed verify, the tensor-core flash
# kernel, the strip re-rank and the slab-pass plane verify replaced, at
# the shapes of phases 5, 7, 5 and 6 (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md's kernel table): printed beside the new times.
PACKED_COLUMN_MAJOR_MS = 21.637
FLASH_SCALAR_MS = 3.540
RERANK_TILED_MS = 4.732
PLANE_TILED_MS = 0.756
# hubert-xlarge (configs/hubert_xlarge.py: 48 layers, head dim 80,
# bidirectional) on 2 clips of 1,000 frames, 20 s of audio at 50 Hz each:
# up to 1,024 frames the model's non-causal flash path takes any length
# (a longer one must be a multiple of its 1,024-key block, in the JAX
# package as here).
HUBERT_BATCH, HUBERT_FRAMES = 2, 1000
# 0-bit CWS at the paper's SIFT and GIST geometries (configs/registry.py
# in the JAX package: dim 128 / L 32 / b 4 and dim 960 / L 64 / b 8), the
# rows cut to 2^22 and 2^18; the first CWS_CHECK_ROWS held against the
# CPU.
CWS_SHAPES = [("SIFT", 1 << 22, 128, 32, 4), ("GIST", 1 << 18, 960, 64, 8)]
CWS_CHECK_ROWS = 4096
# Phase 2's sweep of the batched launches (grid.z over the batch): the
# batch sizes of the paths (1; 3 and 4 shards; 64 queries of the MI
# verify), over geometries, ragged n and m.
SWEEP_BATCH = [1, 3, 4, 64]
BATCH_BL = [(1, 8), (2, 16), (4, 32), (8, 64)]
BATCH_N = [1, 130, 4097, 100_003]
BATCH_M = [1, 3, 8]
# ... and of the candidate verify: (b, L) over W 1-2, n, C slots a query
# (5 queries: counts 0, C and three ragged).
GATHER_BL = [(1, 8), (2, 16), (4, 40), (8, 64)]
GATHER_N = [4097, 1_000_003]
GATHER_C = [1, 300, 2049]
# Phase 10, the other backends: MI-bST over MI_BLOCKS blocks (the plan
# choose_plan picks at the Review geometry and τ = 3) and the sharded bST
# over SHARDS shards on phase 3's sketches; the segmented backends on the
# first SEG10_N of phase 5's token sets with a delta buffer of DELTA10_CAP
# (cut from 12,886,488 rows and 2^20 to keep the three ingests within the
# phase's time, then from 2,400,000 and 2^19 to make room for phase 17;
# each of the SHARDS stacks needs more than DELTA10_CAP rows for a segment
# of its own); the baselines on BASE_N of phase 3's rows for
# BASE_Q queries (host numpy indexes: the full size's HmSearch sorts
# ≈ 116 M keys a block), MIH at τ = 2, where its block thresholds keep the
# pigeonhole bound.
MI_BLOCKS, SHARDS = 2, 4
SEG10_N, DELTA10_CAP = 1_200_000, 1 << 18
RS_N = 4_500_000
BASE_N, BASE_Q = 1 << 19, 16
SIH_TAU, MIH_TAU, HM_TAU = 2, 2, 3
# Phase 11, the retrieval server: the first RS_N of phase 5's token sets
# (L 16, b 2, Wp 8, delta_cap 2^20, auto_merge; rows cut from 12,886,488
# because durability writes the stack three times — journal, snapshots
# at every seal and merge, recovery's rebuild — and phase 5 already
# ingests the full size; not cut to 2,400,000 (phase 10 (c)'s size once):
# at that size the served queries climb τ-ladder rungs that the scheduler's
# warm-up on zero queries does not build, and phase 11 holds 0 builds
# after the warm-up).  Inserts in chunks of
# RS_CHUNK; RS_CLIENTS client threads send RS_TOPK_REQ single top-k
# requests (k = TOPK), RS_RERANK_REQ Jaccard re-ranked ones and
# RS_RANGE_REQ range requests at RS_TAU to a scheduler batching up to
# RS_MAX_BATCH with a RS_MAX_WAIT_MS flush; the overload burst is
# 4 x RS_OVL_QUEUE requests in waves of RS_OVL_WAVE, RS_OVL_GAP_S apart
# (longer together than a few of the admission controller's 100 ms
# intervals, so that its pressure can rise).
RS_CHUNK = 1 << 16
RS_CLIENTS = 8
RS_TOPK_REQ, RS_RERANK_REQ, RS_RANGE_REQ = 1024, 64, 16
RS_TAU = 2
RS_MAX_BATCH, RS_MAX_WAIT_MS = 64, 2.0
RS_OVL_QUEUE = 256
RS_OVL_WAVE, RS_OVL_GAP_S = 128, 0.05
# popcounts an SM issues a clock on Hopper (the integer pipe's rate for
# POPC); times the SMs and the SM clock, the re-rank's popcount bound
POPC_PER_SM_CLOCK = 16
# Phase 12, the dedup-fed trainer.  (a) The pipeline at a trainer's scale:
# documents of 2,048 tokens of smollm-135m's 49,152-token vocabulary,
# 4,096 accepted a step from 8,192 candidates (oversample 2, a quarter
# near-duplicates), sketched L 16, b 2 and filtered at τ 2, for
# TRAIN_DATA_STEPS steps: 131,072 candidates sketched on the card and a
# history bST that grows to 65,536 rows; the first TRAIN_DATA_CPU_STEPS
# held bit for bit against the CPU.  (b) The FA-2 backward against its
# plain version at smollm's train shape, hubert's and a windowed, capped
# D = 128 case.  (c) smollm-135m trained at full size through
# launch/train.py: batches of 8 x 2,048 tokens from the --dedup pipeline,
# TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY (the
# restart drill is phase 16 (b)'s, over two ranks).
TRAIN_DATA = dict(vocab=49152, batch=4096, seq=2048, dedup=True,
                  oversample=2, dup_frac=0.25, dedup_L=16, dedup_b=2,
                  dedup_tau=2)
TRAIN_DATA_STEPS, TRAIN_DATA_CPU_STEPS = 16, 2
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "smollm-135m", 8, 2048
# TRAIN_STEPS cut from 12 to 8 to make room for phase 16, which trains the
# same steps over two ranks
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
TRAIN_WARMUP = 2             # steps left out of the step-time median
# the backward kernel against its plain version: float32 to 5e-4, the
# tolerance of tests/test_flash.py's gradients; bfloat16 (the wgmma
# kernels, P and dS rounded to bf16 as the plain version's bf16 tiles do):
# both sum in float32 from the same bf16 operands and round each gradient
# to bf16 once, so an element may land a bf16 ulp (2^-8 of its magnitude)
# apart where the sums' order moves it, or a P or dS, across a rounding
# boundary: 2^-7 of the tensor's largest magnitude.
BWD_F32_TOL = 5e-4
BWD_BF16_RTOL = 2 ** -7
BWD_CASES = [(8, 9, 2048, 64, dict(causal=True)),        # smollm, training
             (2, 16, 1000, 80, dict(causal=False)),      # hubert-xlarge
             (2, 4, 1024, 128, dict(causal=True, window=256, cap=50.0))]
# one bf16 train step through the kernels against attn_impl="ref" on the
# same parameters and batch: phase 7 holds the two paths' logits within
# 2^-5 of the largest logit; the loss averages 16,384 tokens' NLL and the
# gradient norm sums every weight's square, so both sit far inside that:
# the loss within 2^-7 and the gradient norm within 2^-5, relative.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2 ** -7, 2 ** -5
# Phase 13, the model families past the dense ones, served as phase 7
# serves smollm-135m (8 requests of 2,000 prompt tokens, 48 greedy
# tokens, random weights from --seed, f32 masters, bf16 compute):
# granite-moe-3b-a800m, mamba2-1.3b and zamba2-2.7b at their published
# width and depth (deepseek-moe-16b, whose 16.9 B weights are 67.5 GB as
# f32 masters, is served whole with bf16 parameters in phase 18).
# Each prefill is held against the plain attn_impl="ref" path under
# phase 7's second rule, and prefill-then-decode against the full
# forward at the next position on one request, the JAX package's own
# check (tests/test_models_smoke.py: 2e-2, float32 compute), with the
# caches in float32 too so that the check reads the caches' handling and
# not bf16's rounding of them.  The MoE models run that check at the
# lossless capacity factor E / top_k, as their SMOKE configs do: at 1.25
# the forward drops (token, slot) pairs of the last position that the
# one-token decode keeps (cap = max(⌈k/E · 1.25⌉, k)), so the two differ
# by design (granite-moe at full width on an H100: 44.6 at logits of 370).
FAMILIES = ["granite-moe-3b-a800m", "mamba2-1.3b", "zamba2-2.7b"]
FAMILY_CONSISTENCY_TOL = 2e-2
# Phase 14, the port's tools on the card at their own default sizes, each
# a process of its own that must return 0: the overload tool both at its
# full burst (160 requests against 2 x 30 co-tenant ones) and at --smoke's
# 120, whose victim dispatches stall 80 ms so that its deadline gate bites
# whatever the card's dispatch time (ROADMAP Queue 3, F9).  The first
# three hold no timing gate and start together (their seconds are mostly
# process start-up); the overload tool, whose gates read latencies, runs
# alone after them.
TOOLS = [("tools/eval_recall_torch.py", ["--check"]),
         ("tools/capacity_smoke_torch.py", []),
         ("tools/recovery_smoke_torch.py", []),
         ("tools/overload_smoke_torch.py", []),
         ("tools/overload_smoke_torch.py", ["--smoke"])]
TOOLS_TOGETHER = 3
TOOL_TIMEOUT_S = 300


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, iters: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the card's
    memory rate and the operations over its 32-bit rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(b: int, W: int, n: int, m: int, verify: bool):
    """(bound_ms, bound_by) of one scan: each input read once, each output
    written once, against the card's peak bytes and operations.  Per
    (query, column): W·(b XOR + (b-1) OR + popc + add) ops, plus add,
    compare and min for the verify."""
    return batched_bound(1, b, W, n, m, 1, verify)


def arena_bound(groups, m: int, T: int):
    """Bound of one rung's arena verifies.  ``groups``: (n, words per
    column, ops per (query, column)) for each launch.  Bytes: each column
    lane once (its words, base index and liveness), the (m, T) base plane
    once, the query words and the two (m, n) output planes."""
    nbytes = 4 * m * T + sum(n * (4 * w + 4 + 1) + 4 * w * m + 8 * m * n
                             for n, w, _ in groups)
    ops = sum(m * n * per for n, _, per in groups)
    return bound_ms(nbytes, ops)


def rerank_bound(Wp: int, n: int, m: int, cols: int, lanes: int,
                 popc_per_s: float):
    """Bound of one re-rank pass, from its compulsory bytes: the (m, n)
    survivor plane in and the scores out, the (Wp, m) query words, and
    the payload words of only the ``cols`` columns where a lane survives
    (a column with no survivor needs no payload); per surviving lane
    (``lanes``) Wp·(and + popc + add) plus ~8 float ops, Wp·(popc + add)
    per such column for |B|, and a select per (query, column).  The
    operations take the longer of the 32-bit rate and the popcounts
    alone at the card's popcount issue rate (``popc_per_s``: 16 a clock
    an SM), which binds when most lanes survive."""
    nbytes = 4 * (2 * m * n + Wp * m + Wp * cols)
    ops = lanes * (3 * Wp + 8) + 2 * Wp * cols + m * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(ops / PEAK_OPS_PER_S, Wp * (lanes + cols) / popc_per_s) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def queued_ms(torch, fn, calls: int = 20) -> float:
    """Mean device time of ``calls`` calls of ``fn`` queued back to back
    (the host works ahead of the card: the kernel's own time whenever
    the host's share of a call is the shorter)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def perturb(rng, s, vocab: int, frac: float = 0.25) -> np.ndarray:
    """The recall harness's query perturbation (tools/eval_recall.py:54):
    drop a quarter of the set's tokens, then add random ones until the
    set has at least that many."""
    s = set(int(t) for t in s)
    n_swap = max(1, int(len(s) * frac))
    drop = rng.choice(sorted(s), size=min(n_swap, len(s) - 1), replace=False)
    s -= set(int(t) for t in drop)
    while len(drop):
        s.add(int(rng.integers(0, vocab)))
        if len(s) >= n_swap:
            break
    return np.array(sorted(s), np.int64)


def random_sets(torch, gen, c: int, dev):
    """c token sets of SET_MIN..SET_MAX-1 distinct tokens over VOCAB, made
    on the card: (c, SET_MAX) int32 items with their validity mask, and
    the (c, VOCAB) multihot."""
    order = torch.rand((c, VOCAB), generator=gen, device=dev).argsort(dim=1)
    order = order[:, :SET_MAX]
    size = torch.randint(SET_MIN, SET_MAX, (c,), generator=gen, device=dev)
    mask = torch.arange(SET_MAX, device=dev)[None, :] < size[:, None]
    multihot = torch.zeros((c, VOCAB), dtype=torch.bool, device=dev)
    multihot.scatter_(1, order, mask)
    return order.to(torch.int32), mask, multihot


def set_of(payload_row: np.ndarray) -> np.ndarray:
    """The token ids of one (Wp,) uint32 payload bitmap."""
    bits = np.unpackbits(payload_row.astype("<u4").view(np.uint8),
                         bitorder="little")
    return np.flatnonzero(bits)


def jaccard_np(q_row: np.ndarray, pays: np.ndarray) -> np.ndarray:
    """numpy float32 Jaccard of one query bitmap against (k, Wp) rows:
    inter / ((|A| + |B|) - inter), 0.0 on an empty union."""
    def pop(x):
        x = np.ascontiguousarray(x, np.uint32)
        return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)
    inter = pop(pays & q_row[None, :]).astype(np.float32)
    den = (np.float32(pop(q_row[None, :])[0]) + pop(pays).astype(np.float32)) \
        - inter
    safe = np.where(den > 0, den, np.float32(1))
    return np.where(den > 0, (inter / safe).astype(np.float32),
                    np.float32(0))


def check_arena_kernels(torch, ops, ref, dev, gen, words, maxerr,
                        err) -> int:
    """Phase 2, the slice-2 kernels: packed verify over SWEEP_BS, plane
    verify over SWEEP_BL, both over SWEEP_T roots with ragged n and m,
    dead lanes and BIG bases; re-rank over SWEEP_WP words, all metrics,
    empty sets and a sparse survivor mask, its scores compared as int32
    bit patterns.  Returns the number of shapes checked."""
    checks = 0
    for n in SWEEP_N:
        for m in SWEEP_M:
            for T in SWEEP_T:
                plane = torch.randint(0, 6, (m, T), dtype=torch.int32,
                                      device=dev, generator=gen)
                pruned = torch.rand((m, T), device=dev, generator=gen) < 0.2
                plane[pruned] = BIG
                idx = torch.randint(0, T, (n,), dtype=torch.int32, device=dev,
                                    generator=gen)
                live = torch.rand(n, device=dev, generator=gen) < 0.8
                db, q = words(n), words(m)
                for b, S in SWEEP_BS:
                    got = ops.sparse_verify_arena_packed(
                        db, q, plane, idx, live, b=b, S=S, tau=3)
                    want = ref.sparse_verify_arena_packed_ref(
                        db, q, plane, idx, live, b, S, 3)
                    e = max(maxerr(got[0], want[0]), maxerr(got[1], want[1]))
                    err["sparse_verify_arena_packed"] = max(
                        err["sparse_verify_arena_packed"], e)
                    check(e == 0, f"sparse_verify_arena_packed b={b} S={S} "
                                  f"n={n} m={m} T={T}")
                    checks += 1
                for b, L in SWEEP_BL:
                    W = (L + 31) // 32
                    dbv, qv = words(b, W, n), words(b, W, m)
                    got = ops.sparse_verify_arena(dbv, qv, plane, idx, live,
                                                  tau=3)
                    want = ref.sparse_verify_arena_ref(dbv, qv, plane, idx,
                                                       live, 3)
                    e = max(maxerr(got[0], want[0]), maxerr(got[1], want[1]))
                    err["sparse_verify_arena"] = max(
                        err["sparse_verify_arena"], e)
                    check(e == 0, f"sparse_verify_arena b={b} L={L} n={n} "
                                  f"m={m} T={T}")
                    checks += 1
            for Wp in SWEEP_WP:
                pay, qp = words(Wp, n), words(Wp, m)
                pay[:, n // 3] = 0                          # |B| = 0
                qp[:, 0] = 0                                # |A| = 0
                surv = (torch.rand((m, n), device=dev, generator=gen)
                        < 0.1).to(torch.int32)
                for metric in METRICS:
                    got = ops.exact_rerank(pay, qp, surv, metric=metric)
                    want = ref.exact_rerank_ref(pay, qp, surv, metric)
                    e = maxerr(got.view(torch.int32), want.view(torch.int32))
                    err["exact_rerank"] = max(err["exact_rerank"], e)
                    check(e == 0, f"exact_rerank {metric} Wp={Wp} n={n} m={m}")
                    checks += 1
    return checks


def profile_window(torch, name: str, fn, calls: int = 3) -> None:
    """Where the time goes: ``torch.profiler`` over ``calls`` calls of
    ``fn``; prints the device's busy share of the window (kernel time
    over wall time), the kernels by device time and the host ops by
    self CPU time (a host that waits shows as a sync op there)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not dev_ms:
        print(f"{name}: the profiler saw no device time; busy share not "
              "measured", flush=True)
        return
    print(f"{name}: profiler window {window_ms:.2f} ms for {calls} calls, "
          f"device kernel time {dev_ms:.2f} ms, busy share "
          f"{dev_ms / window_ms:.3f}; by kernel (ms per call):", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / calls:9.3f}  "
              f"x{e.count // calls:<4d} {e.key[:90]}", flush=True)
    host = [e for e in prof.key_averages() if e.device_type != DeviceType.CUDA]
    print("  host ops by self CPU time (ms per call):", ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / calls:.2f} "
        f"x{e.count // calls}" for e in sorted(
            host, key=lambda e: -e.self_cpu_time_total)[:6]), flush=True)


def token_corpus(torch, seed: int, dev, n: int):
    """``n`` token sets made from ``seed`` (sketched by ``bbit_minhash``
    and packed by ``pack_sets`` on the card, chunk by chunk: the first m
    rows are the same for every n >= m) and M_QUERIES queries (perturbed
    database sets and fresh sets) with their payloads.  Returns
    (sketches, payloads, qs, qp, rng): ``rng`` is the query draw's
    generator, which the Review cell goes on to draw its deletes from.
    Prints the corpus."""
    from repro_torch.core import (bbit_minhash, hash_params, pack_sets,
                                  sketch_tokens)

    L, b = REVIEW_L, REVIEW_B
    Wp = (VOCAB + 31) // 32
    params = hash_params(L, torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    t0 = time.perf_counter()
    sketches = np.empty((n, L), np.uint8)
    payloads = np.empty((n, Wp), np.uint32)
    for lo in range(0, n, GEN_CHUNK):
        c = min(GEN_CHUNK, n - lo)
        items, mask, multihot = random_sets(torch, gen, c, dev)
        sketches[lo:lo + c] = bbit_minhash(params, items, mask, L=L,
                                           b=b).cpu().numpy()
        payloads[lo:lo + c] = pack_sets(multihot.cpu().numpy(), VOCAB)
        del items, mask, multihot
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed + 5)
    src = rng.choice(n, size=M_QUERIES // 2, replace=False)
    q_sets = [perturb(rng, set_of(payloads[i]), VOCAB) for i in src]
    q_sets += [rng.choice(VOCAB, size=int(rng.integers(SET_MIN, SET_MAX)),
                          replace=False) for _ in range(M_QUERIES // 2)]
    tokens = np.full((M_QUERIES, SET_MAX), -1, np.int32)
    for r, toks in enumerate(q_sets):
        tokens[r, :len(toks)] = toks
    qs = sketch_tokens(params, torch.from_numpy(tokens).to(dev), L=L,
                       b=b).cpu().numpy()
    qp = pack_sets(q_sets, VOCAB)
    head = payloads[:65536]
    print(f"corpus: {n} sets of {SET_MIN}-{SET_MAX - 1} tokens over "
          f"{VOCAB}, bbit_minhash L={L} b={b} and pack_sets Wp={Wp} on the "
          f"card in {gen_s:.1f} s; mean set size "
          f"{np.unpackbits(head.view(np.uint8)).sum() / len(head):.2f}",
          flush=True)
    return sketches, payloads, qs, qp, rng


def review_cell(torch, seed: int, dev):
    """The segmented Review cell, made from ``seed``: the REVIEW_N token
    sets and M_QUERIES queries of ``token_corpus``, the
    ``SegmentedIndex`` they are ingested into (size-tiered
    ``auto_merge``), and DELETE_FRAC of the ids deleted.  Prints the
    corpus, ingest and stack."""
    from types import SimpleNamespace

    from repro_torch.core import SegmentedIndex

    n, L, b = REVIEW_N, REVIEW_L, REVIEW_B
    Wp = (VOCAB + 31) // 32
    sketches, payloads, qs, qp, rng = token_corpus(torch, seed, dev, n)

    idx = SegmentedIndex(L, b, delta_cap=DELTA5_CAP, payload_words=Wp,
                         device="cuda")
    t0 = time.perf_counter()
    step = DELTA_CAP // 4
    for lo in range(0, n, step):
        idx.insert(sketches[lo:lo + step], payloads=payloads[lo:lo + step])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    stack = [(s.n, s.index.ls, int(s.index.tail.t_root), s.index.t[-1])
             for s in idx.segments]
    T = 1 + sum(t_root for _, _, t_root, _ in stack)
    nd = len(idx._delta_ids)
    print(f"ingest: {ingest_s:.1f} s (host clock, {idx.counters}); stack "
          f"(rows, l_s, roots, leaves) {stack}; delta rows {nd}; T = {T}",
          flush=True)
    sizes = [s[0] for s in stack]
    check(sum(sizes) + nd == n and nd == n % DELTA5_CAP
          and len({s.bit_length() for s in sizes}) == len(sizes),
          f"the size-tiered policy left {stack}, delta {nd}")

    dead = rng.choice(n, size=int(n * DELETE_FRAC), replace=False)
    check(idx.delete(dead) == len(dead), "delete count")
    live = np.ones(n, bool)
    live[dead] = False
    return SimpleNamespace(idx=idx, sketches=sketches, payloads=payloads,
                           qs=qs, qp=qp, live=live, T=T, Wp=Wp)


def segmented_review(torch, args, dev, ops, ref, err, maxerr) -> dict:
    """Phase 5: the segmented path at the Review size.  Returns the JSON
    fields (launches and times) of the packed verify and the re-rank."""
    from repro_torch.core import (LinearScan, dispatch_stats,
                                  pack_suffix_words_torch,
                                  reset_dispatch_stats)
    from repro_torch.core.hamming import as_words
    from repro_torch.core.segments import _root_plane, _stack_inverse

    cell = review_cell(torch, args.seed, dev)
    idx, sketches, payloads = cell.idx, cell.sketches, cell.payloads
    qs, qp, live, T, Wp = cell.qs, cell.qp, cell.live, cell.T, cell.Wp
    L, b = REVIEW_L, REVIEW_B
    scan = LinearScan.build(sketches, b, device="cuda")
    d = scan.distances(qs)
    d = torch.where(torch.from_numpy(live).to(dev)[None, :], d, BIG)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_stats()                       # the path's window
    reset_dispatch_stats()
    t0 = time.perf_counter()
    top = idx.topk_batch(qs, TOPK)
    cols = idx.search_columns_batch(qs, top.tau)
    rr = idx.topk_batch(qs, TOPK, rerank="jaccard", q_payloads=qp)
    idx.use_arena = False                          # the reference fan-out
    fan = idx.topk_batch(qs, TOPK)
    idx.use_arena = True
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    disp = dispatch_stats()
    peak = torch.cuda.max_memory_allocated()
    print(f"segmented path: {path_s:.2f} s, launches {launches}, dispatches "
          f"{disp}, peak {peak / 2**30:.2f} GiB", flush=True)
    for name in ("sparse_verify_arena_packed", "hamming_distances",
                 "exact_rerank", "sparse_verify_batch"):
        check(launches.get(name, 0) > 0,
              f"{name} kernel not launched on the segmented path")
    check(not any(k.endswith(":ref") for k in launches),
          f"plain version ran on the segmented path: {launches}")

    check(top.overflow == 0 and rr.overflow == 0, "segmented topk overflow")
    for r0 in range(0, M_QUERIES, 8):              # stable sort: ties by id
        sd, si = torch.sort(d[r0:r0 + 8], dim=1, stable=True)
        check(torch.equal(top.ids[r0:r0 + 8], si[:, :TOPK].to(torch.int32))
              and torch.equal(top.dists[r0:r0 + 8], sd[:, :TOPK]),
              f"segmented topk rows {r0}..{r0 + 7} != brute force")
        del sd, si
    check(fan.tau == top.tau and fan.overflow == 0
          and torch.equal(fan.ids, top.ids)
          and torch.equal(fan.dists, top.dists),
          "use_arena=False top-k differs from the fused path")
    want = d.index_select(1, torch.from_numpy(cols.ids).to(dev))
    want = torch.where(want <= top.tau, want, BIG)
    check(cols.overflow == 0 and torch.equal(cols.dist, want)
          and torch.equal(cols.mask, want <= top.tau),
          "search_columns_batch differs from the brute force in the ball")
    del want
    r_ids, r_d = rr.ids.cpu().numpy(), rr.dists.cpu().numpy()
    r_s = rr.scores.cpu().numpy()
    n_surv = []
    for i in range(M_QUERIES):
        cand = torch.nonzero(d[i] <= rr.tau).flatten().cpu().numpy()
        n_surv.append(len(cand))
        sc = jaccard_np(qp[i], payloads[cand])
        order = np.lexsort((cand, -sc))[:TOPK]
        k = len(order)
        check(np.array_equal(r_ids[i, :k], cand[order])
              and np.array_equal(r_d[i, :k], d[i].index_select(
                  0, torch.from_numpy(cand[order]).to(dev)).cpu().numpy())
              and np.array_equal(r_s[i, :k].view(np.int32),
                                 sc[order].view(np.int32))
              and (r_ids[i, k:] == -1).all(),
              f"re-ranked top-{TOPK} row {i} != numpy Jaccard")
    print(f"segmented path exact: top-{TOPK} (tau*={top.tau}), the fan-out, "
          f"search_columns at tau*, and the Jaccard re-rank (tau={rr.tau}, "
          f"survivors per query min/median/max {min(n_surv)}/"
          f"{int(np.median(n_surv))}/{max(n_surv)}) match the scan kernel, "
          "the stable sort and numpy", flush=True)

    for rerank, extra in ((None, {}),
                          ("jaccard", dict(rerank="jaccard", q_payloads=qp))):
        ops.reset_kernel_stats()
        reset_dispatch_stats()
        idx.topk_batch(qs, TOPK, **extra)
        torch.cuda.synchronize()
        print(f"per topk_batch (rerank={rerank}): launches "
              f"{ops.kernel_stats()}, dispatches {dispatch_stats()}",
              flush=True)

    e2e = {}
    for rerank, extra in ((None, {}),
                          ("jaccard", dict(rerank="jaccard", q_payloads=qp))):
        idx.topk_batch(qs, TOPK, **extra)          # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            idx.topk_batch(qs, TOPK, **extra)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[rerank] = statistics.median(times)
        print(f"segmented topk_batch (m={M_QUERIES}, k={TOPK}, "
              f"rerank={rerank}): {e2e[rerank]:.2f} ms median of 5 "
              f"({sorted(round(t, 2) for t in times)}), "
              f"{M_QUERIES / e2e[rerank] * 1e3:.0f} queries/s", flush=True)

    t_prof = time.perf_counter()
    profile_window(torch, "segmented topk_batch + Jaccard re-rank",
                   lambda: idx.topk_batch(qs, TOPK, rerank="jaccard",
                                          q_payloads=qp))
    print(f"(profile windows: {time.perf_counter() - t_prof:.1f} s)",
          flush=True)

    # the kernels at the path's shapes: the rung's packed launches on
    # the base plane its traversal gives, and the re-rank of its plane
    store = idx._refresh_store()
    plan = store.plan()
    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)
    base_plane, _ = _root_plane(idx._stack_constants(top.tau, 0), qs_t,
                                top.tau, True)
    groups = []
    for g in plan:
        check(g.geom.packed, f"Review segment not packed: {g.geom}")
        S = g.geom.suffix_len
        groups.append((g.cols_hot, pack_suffix_words_torch(qs_t[:, L - S:], b),
                       g.base_idx,
                       store.live[torch.from_numpy(g.perm).to(dev)], S))
    slices = range(0, M_QUERIES, 8)

    def packed_kernel():
        return [ops.sparse_verify_arena_packed(c, q, base_plane, bi, lv, b=b,
                                               S=S, tau=top.tau)
                for c, q, bi, lv, S in groups]

    def packed_plain():
        return [[ref.sparse_verify_arena_packed_ref(
            c, q[r0:r0 + 8], base_plane[r0:r0 + 8], bi, lv, b, S, top.tau)
            for r0 in slices] for c, q, bi, lv, S in groups]

    for (mask_k, dist_k), plain in zip(packed_kernel(), packed_plain()):
        for r0, (w_mask, w_dist) in zip(slices, plain):
            e = max(maxerr(mask_k[r0:r0 + 8], w_mask),
                    maxerr(dist_k[r0:r0 + 8], w_dist))
            err["sparse_verify_arena_packed"] = max(
                err["sparse_verify_arena_packed"], e)
            check(e == 0, "packed verify at the segmented path's shape")
    del mask_k, dist_k, plain, w_mask, w_dist
    pk_ms = time_ms(torch, packed_kernel)
    pk_plain = time_ms(torch, packed_plain, iters=3)
    pk_bound, pk_by = arena_bound([(c.shape[0], 1, 3 * b + 4)
                                   for c, *_ in groups],
                                  M_QUERIES, base_plane.shape[1])
    check(base_plane.shape[1] == T, f"root plane width {base_plane.shape[1]}")
    shapes = [(c.shape[0], S) for c, *_, S in groups]
    print(f"sparse_verify_arena_packed (groups (n, S) {shapes}, "
          f"m={M_QUERIES}, T={T}, query-major): {pk_ms:.3f} ms "
          f"(the column-major kernel before it: {PACKED_COLUMN_MAJOR_MS} "
          f"ms), bound {pk_bound:.3f} ms ({pk_by}), plain {pk_plain:.3f} ms",
          flush=True)
    del base_plane, groups

    dist, _, _ = idx._fused_call("dist", qs, rr.tau)
    surv = (dist < BIG).to(torch.int32)
    del dist
    inv = _stack_inverse(plan, dev)
    pays = torch.cat([g.pays_hot for g in plan], dim=-1)
    if inv is not None:
        pays = pays.index_select(1, inv)
    pays = torch.cat([pays, idx._delta_pay_planes()], dim=-1).contiguous()
    q_pay = as_words(qp.T, dev)
    R = pays.shape[1]
    got = ops.exact_rerank(pays, q_pay, surv, metric="jaccard")
    for r0 in slices:
        want = ref.exact_rerank_ref(pays, q_pay[:, r0:r0 + 8],
                                    surv[r0:r0 + 8], "jaccard")
        e = maxerr(got[r0:r0 + 8].view(torch.int32), want.view(torch.int32))
        err["exact_rerank"] = max(err["exact_rerank"], e)
        check(e == 0, "exact_rerank at the segmented path's shape")
    del got, want
    def rerank():
        return ops.exact_rerank(pays, q_pay, surv, metric="jaccard")

    rk_ms = time_ms(torch, rerank)
    rk_queued = queued_ms(torch, rerank)
    rk_plain = time_ms(torch, lambda: [ref.exact_rerank_ref(
        pays, q_pay[:, r0:r0 + 8], surv[r0:r0 + 8], "jaccard")
        for r0 in slices], iters=3)
    lanes = int(surv.sum())
    cols = int(surv.any(dim=0).sum())
    rk_bound, rk_by = rerank_bound(Wp, R, M_QUERIES, cols, lanes,
                                   args.popc_per_s)
    print(f"exact_rerank (Wp={Wp}, n={R}, m={M_QUERIES}, {lanes} "
          f"survivors in {cols} columns): {rk_ms:.3f} ms, queued "
          f"{rk_queued:.3f} ms (the tiled kernel before it: "
          f"{RERANK_TILED_MS} ms), bound {rk_bound:.3f} ms ({rk_by}: the "
          f"flags, the scores and the survivors' payloads), plain "
          f"{rk_plain:.3f} ms", flush=True)
    print(f"max_memory_allocated: segmented path {peak / 2**30:.2f} GiB",
          flush=True)
    del pays, surv, q_pay, d, scan, store, plan
    torch.cuda.empty_cache()
    t_cold = time.perf_counter()
    cold_tier(torch, idx, qs, qp, ops)
    print(f"(cold tier: {time.perf_counter() - t_cold:.1f} s)", flush=True)
    del idx
    torch.cuda.empty_cache()
    return {
        "corpus10": (sketches[:RS_N].copy(), payloads[:RS_N].copy(),
                     qs, qp),
        "topk_ms": e2e[None],
        "sparse_verify_arena_packed": {
            "launches": launches["sparse_verify_arena_packed"], "ms": pk_ms,
            "plain_ms": pk_plain, "bound_ms": pk_bound, "bound_by": pk_by,
            "library_ms": None},
        "exact_rerank": {
            "launches": launches["exact_rerank"], "ms": rk_ms,
            "plain_ms": rk_plain, "bound_ms": rk_bound, "bound_by": rk_by,
            "library_ms": None},
    }


def same_answers(torch, a, b) -> bool:
    """Two (top-k, range columns, re-rank) triples of the segmented path,
    bit for bit: ids, dists, τ*, overflow, the column planes and the
    scores' float32 bit patterns."""
    (t0, c0, r0), (t1, c1, r1) = a, b
    return (t0.tau == t1.tau and t0.overflow == t1.overflow == 0
            and torch.equal(t0.ids, t1.ids) and torch.equal(t0.dists, t1.dists)
            and c0.overflow == c1.overflow and np.array_equal(c0.ids, c1.ids)
            and torch.equal(c0.mask, c1.mask) and torch.equal(c0.dist, c1.dist)
            and r0.tau == r1.tau and torch.equal(r0.ids, r1.ids)
            and torch.equal(r0.dists, r1.dists)
            and torch.equal(r0.scores.view(torch.int32),
                            r1.scores.view(torch.int32)))


def cold_tier(torch, idx, qs, qp, ops) -> None:
    """Phase 5b: the cold tier on phase 5's own index.  A budget of half
    the block bytes demotes the least recently used block to pinned host
    memory; top-k, range and the Jaccard re-rank must give the all-hot
    bits at the same fused dispatches and kernel launches, staging the
    cold block's bytes per fused query.  Then one explained re-rank and
    traced calls (bit-identical, no extra dispatch; the Chrome trace to
    build/), and a budget that promotes every block back."""
    from repro_torch.core import (dispatch_stats, reset_dispatch_stats,
                                  reset_tier_stats, tier_stats)
    from repro_torch.obs import Span, attach, write_chrome

    store = idx._refresh_store()

    def window():
        """The three calls with every count set to 0 before and read
        after."""
        torch.cuda.synchronize()
        ops.reset_kernel_stats()
        reset_dispatch_stats()
        reset_tier_stats()
        top = idx.topk_batch(qs, TOPK)
        out = (top, idx.search_columns_batch(qs, top.tau),
               idx.topk_batch(qs, TOPK, rerank="jaccard", q_payloads=qp))
        torch.cuda.synchronize()
        return out, ops.kernel_stats(), dispatch_stats(), tier_stats()

    def median_ms(extra, n=5):
        idx.topk_batch(qs, TOPK, **extra)
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            idx.topk_batch(qs, TOPK, **extra)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), sorted(round(t, 2) for t in times)

    rr_kw = dict(rerank="jaccard", q_payloads=qp)
    hot, l_hot, d_hot, t_hot = window()
    check(not any(t_hot.values()), f"the all-hot window staged {t_hot}")
    hot_ms = {k: median_ms(kw) for k, kw in (("topk", {}), ("rerank", rr_kw))}
    block_bytes = sum(blk.block_bytes for blk in store.blocks)
    store.hot_bytes = block_bytes // 2
    t0 = time.perf_counter()
    store._enforce_budget()
    demote_s = time.perf_counter() - t0
    summary = store.tier_summary()
    cold_blks = [blk for blk in store.blocks if blk.tier == "cold"]
    print(f"cold tier: hot_bytes {store.hot_bytes} (half of {block_bytes} "
          f"block bytes), demoted in {demote_s:.2f} s: {summary}; "
          f"array_bytes {store.array_bytes()}, host_bytes "
          f"{store.host_bytes()} (pinned: "
          f"{all(b.cols_cold.is_pinned() for b in cold_blks)})", flush=True)
    check(summary["cold_blocks"] >= 1, f"nothing went cold: {summary}")
    torch.cuda.reset_peak_memory_stats()
    cold, l_cold, d_cold, t_cold = window()
    peak = torch.cuda.max_memory_allocated()
    check(same_answers(torch, hot, cold),
          "the cold tier's answers differ from the all-hot ones")
    check(l_cold == l_hot and d_cold == d_hot,
          f"cold launches {l_cold} / dispatches {d_cold} differ from hot "
          f"{l_hot} / {d_hot}")
    col_b = sum(b.col_bytes for b in cold_blks)
    pay_b = sum(b.pay_bytes for b in cold_blks)
    stagings = t_cold["prefetches"] // len(cold_blks)
    check(stagings >= 1
          and t_cold["prefetches"] == stagings * len(cold_blks)
          and t_cold["staged_bytes"] == stagings * col_b + pay_b
          and t_cold["staged_payload_bytes"] == pay_b,
          f"tier_stats {t_cold}: want {stagings} x {col_b} column bytes and "
          f"{pay_b} payload bytes")
    print(f"cold tier exact: top-{TOPK} (tau*={cold[0].tau}), range columns "
          f"and the Jaccard re-rank equal the all-hot bits; launches "
          f"{l_cold} and dispatches {d_cold} equal; tier_stats {t_cold} "
          f"({stagings} stagings of {col_b} column bytes, {pay_b} payload "
          f"bytes); peak {peak / 2**30:.2f} GiB", flush=True)

    for what, fn, nbytes in (("columns", store.stage, col_b),
                             ("payloads", store.stage_payloads, pay_b)):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for slab in fn():
                if slab is not None:
                    slab.wait()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        print(f"staging the cold {what}: {nbytes} bytes in {ms:.3f} ms "
              f"median of 5 (CUDA events, host issue included), "
              f"{nbytes / ms / 1e6:.2f} GB/s = {nbytes / ms / 64e6:.3f} of "
              f"PCIe Gen5 x16's 64 GB/s", flush=True)
    for k, kw in (("topk", {}), ("rerank", rr_kw)):
        ms, times = median_ms(kw)
        print(f"segmented topk_batch (rerank={kw.get('rerank')}), cold: "
              f"{ms:.2f} ms median of 5 ({times}) against all-hot "
              f"{hot_ms[k][0]:.2f} ({hot_ms[k][1]})", flush=True)

    # explain and tracing, on the cold index
    plain = idx.topk_batch(qs, TOPK, **rr_kw)
    res, ex = idx.topk_batch(qs, TOPK, explain=True, **rr_kw)
    check(torch.equal(res.ids, plain.ids) and torch.equal(res.dists, plain.dists)
          and torch.equal(res.scores.view(torch.int32),
                          plain.scores.view(torch.int32))
          and res.tau == plain.tau,
          "explain=True re-rank differs from the plain call")
    print(f"explain=True re-rank: bit-identical; {ex.summary().splitlines()[0]}"
          f"; {len(ex.rungs)} rungs, dispatch {ex.dispatch}, tier {ex.tier}",
          flush=True)
    root = Span("request")
    traced = []
    for extra in ({}, rr_kw):
        reset_dispatch_stats()
        p = idx.topk_batch(qs, TOPK, **extra)
        d_plain = dispatch_stats()
        reset_dispatch_stats()
        with attach(root):
            t = idx.topk_batch(qs, TOPK, **extra)
        check(dispatch_stats() == d_plain and torch.equal(t.ids, p.ids)
              and torch.equal(t.dists, p.dists),
              f"a traced call differs: dispatches {dispatch_stats()} against "
              f"{d_plain}")
        traced.append(t)
    idx.use_arena = False
    with attach(root):
        idx.search_columns_batch(qs, hot[0].tau)
    idx.use_arena = True
    names = ("rung_dispatch", "tier_stage", "tier_stage_payloads",
             "topk_readback", "rerank", "segment_fanout", "delta_scan")
    missing = [n for n in names if root.find(n) is None]
    check(not missing, f"spans missing from the trace: {missing}")
    out = ROOT / "build" / "chip_smoke_trace.json"
    out.parent.mkdir(exist_ok=True)
    write_chrome([root], str(out))
    print(f"traced calls: bit-identical, no extra dispatch; spans "
          f"{list(names)} -> {out.relative_to(ROOT)}", flush=True)

    store.hot_bytes = 10 ** 12
    store._enforce_budget()
    check(store.tier_summary()["cold_blocks"] == 0,
          f"promotion left {store.tier_summary()}")
    again, l_again, d_again, t_again = window()
    check(same_answers(torch, hot, again) and l_again == l_hot
          and not any(t_again.values()),
          "answers after promotion differ from the all-hot ones")
    print(f"promoted back: {store.tier_summary()}; answers equal", flush=True)
    for k, kw in (("topk", {}), ("rerank", rr_kw)):   # hot, cold, hot
        ms, times = median_ms(kw)
        print(f"segmented topk_batch (rerank={kw.get('rerank')}), all-hot "
              f"again: {ms:.2f} ms median of 5 ({times})", flush=True)


def plane_fallback(torch, args, dev, ops, ref, err, maxerr) -> dict:
    """Phase 6: the CP geometry at 2^20 uniform rows, where b·S > 32 sends
    the suffix store through the plane-packed ``sparse_verify_arena``
    kernel.  Returns that kernel's JSON fields."""
    from repro_torch.core import (LinearScan, SegmentedIndex,
                                  reset_tier_stats, tier_stats)
    from repro_torch.core.hamming import pack_vertical_torch
    from repro_torch.core.segments import _root_plane

    L, b, n = CP_L, CP_B, CP_N
    rng = np.random.default_rng(args.seed + 6)
    db = rng.integers(0, 1 << b, size=(n, L), dtype=np.uint8)
    near = db[rng.integers(0, n, size=M_QUERIES // 2)].copy()
    for row in near:                     # 0-3 symbols perturbed per row
        pos = rng.choice(L, size=rng.integers(0, 4), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 1 << b, size=len(pos))) \
            % (1 << b)
    qs = np.concatenate([near, rng.integers(0, 1 << b, size=(
        M_QUERIES // 2, L), dtype=np.uint8)])
    t0 = time.perf_counter()
    sfx = SegmentedIndex(L, b, delta_cap=CP_DELTA, device="cuda")
    full = SegmentedIndex(L, b, delta_cap=CP_DELTA, layout="full",
                          device="cuda")
    for idx in (sfx, full):
        for lo in range(0, n, 1 << 18):
            idx.insert(db[lo:lo + (1 << 18)])
    store = sfx._refresh_store()
    geoms = [blk.geom for blk in store.blocks]
    print(f"CP ingest: {time.perf_counter() - t0:.1f} s for both layouts; "
          f"suffix stack {[(s.n, s.index.ls) for s in sfx.segments]}, "
          f"geometries {geoms}", flush=True)
    check(any(not g.packed for g in geoms), f"no plane group: {geoms}")

    ops.reset_kernel_stats()                       # the path's window
    rs = sfx.topk_batch(qs, TOPK)
    torch.cuda.synchronize()
    l_sfx = ops.kernel_stats()
    ops.reset_kernel_stats()
    rf = full.topk_batch(qs, TOPK)
    torch.cuda.synchronize()
    l_full = ops.kernel_stats()
    print(f"CP launches: suffix {l_sfx}, full {l_full}", flush=True)
    check(l_sfx.get("sparse_verify_arena", 0) > 0,
          "sparse_verify_arena not launched on the suffix layout")
    check(not any(k.endswith(":ref") for k in {**l_sfx, **l_full}),
          "plain version ran on the plane-fallback path")
    check(rs.overflow == 0 and rs.tau == rf.tau
          and torch.equal(rs.ids, rf.ids) and torch.equal(rs.dists, rf.dists),
          "suffix and full layouts disagree")
    d = LinearScan.build(db, b, device="cuda").distances(qs)
    for r0 in range(0, M_QUERIES, 8):
        sd, si = torch.sort(d[r0:r0 + 8], dim=1, stable=True)
        check(torch.equal(rs.ids[r0:r0 + 8], si[:, :TOPK].to(torch.int32))
              and torch.equal(rs.dists[r0:r0 + 8], sd[:, :TOPK]),
              f"CP topk rows {r0}..{r0 + 7} != brute force")
    del d, sd, si
    print(f"CP top-{TOPK} (tau*={rs.tau}): suffix == full == brute force",
          flush=True)

    plan = store.plan()
    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)
    base_plane, _ = _root_plane(sfx._stack_constants(rs.tau, 0), qs_t,
                                rs.tau, True)
    g = next(g for g in plan if not g.geom.packed)
    S = g.geom.suffix_len
    qv = ops.to_lane_major(pack_vertical_torch(qs_t[:, L - S:], b))
    lv = store.live[torch.from_numpy(g.perm).to(dev)]
    slices = range(0, M_QUERIES, 8)

    def kernel():
        return ops.sparse_verify_arena(g.cols_hot, qv, base_plane, g.base_idx,
                                       lv, tau=rs.tau)

    def plain():
        return [ref.sparse_verify_arena_ref(g.cols_hot, qv[..., r0:r0 + 8],
                                            base_plane[r0:r0 + 8],
                                            g.base_idx, lv, rs.tau)
                for r0 in slices]

    mask_k, dist_k = kernel()
    for r0, (w_mask, w_dist) in zip(slices, plain()):
        e = max(maxerr(mask_k[r0:r0 + 8], w_mask),
                maxerr(dist_k[r0:r0 + 8], w_dist))
        err["sparse_verify_arena"] = max(err["sparse_verify_arena"], e)
        check(e == 0, "sparse_verify_arena at the CP path's shape")
    bw, W_s, n_g = g.cols_hot.shape
    ms = time_ms(torch, kernel)
    queued = queued_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, iters=3)
    bnd, by = arena_bound([(n_g, bw * W_s, W_s * (2 * bw + 1) + 4)],
                          M_QUERIES, base_plane.shape[1])
    print(f"sparse_verify_arena (b={bw} W={W_s} S={S} n={n_g} m={M_QUERIES} "
          f"T={base_plane.shape[1]}, {ops._slab_queries(base_plane.shape[1])}"
          f" queries a slab pass): {ms:.3f} ms, queued {queued:.3f} ms (the "
          f"tiled kernel before it: {PLANE_TILED_MS} ms), bound {bnd:.3f} "
          f"ms ({by}), plain {plain_ms:.3f} ms", flush=True)

    # one cold call: every block of the suffix stack (the plane group
    # too) in pinned host memory, staged per query
    store.hot_bytes = 0
    store._enforce_budget()
    ops.reset_kernel_stats()
    reset_tier_stats()
    rc = sfx.topk_batch(qs, TOPK)
    torch.cuda.synchronize()
    l_cold, t_cold = ops.kernel_stats(), tier_stats()
    check(store.tier_summary()["hot_blocks"] == 0 and t_cold["prefetches"] > 0
          and l_cold == l_sfx and rc.tau == rs.tau and rc.overflow == 0
          and torch.equal(rc.ids, rs.ids) and torch.equal(rc.dists, rs.dists),
          f"the CP cold call differs: launches {l_cold} against {l_sfx}, "
          f"tier {t_cold}")
    print(f"CP cold call: every block cold {store.tier_summary()}, staged "
          f"{t_cold}; top-{TOPK} bit-identical at the same launches",
          flush=True)
    return {"sparse_verify_arena": {
        "launches": l_sfx["sparse_verify_arena"]
        + l_full.get("sparse_verify_arena", 0),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None}}


def row_rel_err(got, want) -> float:
    """The largest, over rows, of max |got - want| along D over the
    row's largest |want| (a row with no visible key is 0 on both)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-6)).max())


def check_flash_kernel(torch, ops, ref, dev, gen, err) -> tuple:
    """Phase 7a: the flash kernel against its plain version over
    FLASH_MASKS x dtypes x D x S (ragged 1000 and 2000 included; B·H = 72
    at S = 2000, 6 below), and the GQA path of ``models/flash.py``
    against the port's plain ``blockwise_attention``; bf16 also row by
    row (FLASH_BF16_ROW_RTOL).  Returns the number of shapes checked and
    the largest bf16 row error."""
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import blockwise_attention

    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    checks, row_err = 0, 0.0

    def check_rows(got, want, what):
        nonlocal row_err
        if got.dtype == torch.bfloat16:
            r = row_rel_err(got, want)
            row_err = max(row_err, r)
            check(r <= FLASH_BF16_ROW_RTOL, f"{what}: row error {r:.4g} > "
                                            f"{FLASH_BF16_ROW_RTOL}")
    for causal, window, cap in FLASH_MASKS:
        for dtype in (torch.float32, torch.bfloat16):
            tol = tols[dtype]
            for D in (64, 128):
                for S in FLASH_S:
                    B, H = (8, 9) if S == 2000 else (2, 3)
                    q, k, v = (torch.randn((B, H, S, D), device=dev,
                                           generator=gen).to(dtype)
                               for _ in range(3))
                    kw = dict(causal=causal, window=window, cap=cap)
                    got = ops.flash_attention_fwd(q, k, v, **kw)
                    want = ref.flash_attention_ref(q, k, v, **kw)
                    e = float((got.float() - want.float()).abs().max())
                    err["flash_attention_fwd"] = max(
                        err["flash_attention_fwd"], e)
                    check(got.dtype == dtype and got.shape == q.shape
                          and bool(torch.isfinite(got).all())
                          and torch.allclose(got.float(), want.float(),
                                             rtol=tol, atol=tol),
                          f"flash_attention_fwd causal={causal} "
                          f"window={window} cap={cap} {dtype} D={D} S={S}: "
                          f"max err {e}")
                    check_rows(got, want, f"flash_attention_fwd "
                                          f"causal={causal} window={window} "
                                          f"cap={cap} D={D} S={S}")
                    checks += 1
    for dtype in (torch.float32, torch.bfloat16):   # offsets, D = 16
        for Sq, Skv, D, off, kw in ((300, 1000, 64, 700, dict(window=200)),
                                    (130, 130, 16, 0, dict(cap=20.0)),
                                    (64, 2000, 128, 1936, {})):
            q = torch.randn((2, 3, Sq, D), device=dev,
                            generator=gen).to(dtype)
            k, v = (torch.randn((2, 3, Skv, D), device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
            got = ops.flash_attention_fwd(q, k, v, causal=True, q_offset=off,
                                          **kw)
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           q_offset=off, **kw)
            e = float((got.float() - want.float()).abs().max())
            err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
            tol = tols[dtype]
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"flash_attention_fwd {dtype} Sq={Sq} Skv={Skv} D={D} "
                  f"q_offset={off} {kw}: max err {e}")
            check_rows(got, want, f"flash_attention_fwd Sq={Sq} Skv={Skv} "
                                  f"D={D} q_offset={off} {kw}")
            checks += 1
    for S, window, cap in ((2000, 0, 0.0), (1000, 96, 30.0)):
        q = torch.randn((8, S, 9, 64), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((8, S, 3, 64), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        got = flash_attention(q, k, v, causal=True, window=window, cap=cap)
        want = blockwise_attention(q, k, v, causal=True, window=window,
                                   cap=cap)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        tol = tols[torch.bfloat16]
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"models/flash.py GQA 9/3 S={S} window={window} cap={cap}: "
              f"max err {e}")
        check_rows(got, want, f"models/flash.py GQA 9/3 S={S} "
                              f"window={window} cap={cap}")
        checks += 1
    return checks, row_err


def check_flash_d80(torch, ops, ref, dev, gen, err) -> int:
    """Phase 2, flash at hubert-xlarge's head dim 80 against its plain
    version: both routes (float32 scalar, bf16 wgmma), causal and
    bidirectional, ragged S up to 1,500 at hubert's 16 heads, and a
    windowed, capped query block at an offset; bf16 also row by row.
    Returns the number of shapes checked."""
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    checks = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [((2, 16, S, S), dict(causal=causal))
                 for causal in (True, False) for S in (1, 130, 1000, 1500)]
        cases.append(((2, 16, 300, 700), dict(causal=True, window=200,
                                             cap=30.0, q_offset=400)))
        for (B, H, Sq, Skv), kw in cases:
            q = torch.randn((B, H, Sq, 80), device=dev, generator=gen).to(dtype)
            k, v = (torch.randn((B, H, Skv, 80), device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
            got = ops.flash_attention_fwd(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            e = float((got.float() - want.float()).abs().max())
            err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
            tol = tols[dtype]
            what = f"flash_attention_fwd D=80 {dtype} Sq={Sq} Skv={Skv} {kw}"
            check(got.shape == q.shape and bool(torch.isfinite(got).all())
                  and torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol), f"{what}: max err {e}")
            if dtype == torch.bfloat16:
                r = row_rel_err(got, want)
                check(r <= FLASH_BF16_ROW_RTOL, f"{what}: row error {r:.4g}")
            checks += 1
    return checks


def hubert_forward(torch, args, dev, ops, ref) -> dict:
    """Phase 8: hubert-xlarge at full width and depth (48 layers, d_model
    1280, 16 heads of 80, d_ff 5120; random weights from ``--seed``, f32
    masters, bf16 compute): one ``forward`` of HUBERT_BATCH x
    HUBERT_FRAMES frame embeddings with the flash kernel's launches
    counted around it, its logits held against the plain
    ``attn_impl="ref"`` paths as below; then the kernel
    at hubert's attention shape beside its bound, plain version and
    ``scaled_dot_product_attention``.  Returns the kernel's fields.

    The logits are held two ways.  In float32 compute (the scalar kernel,
    48 launches) against the f32 plain path within 2^-5 of the largest
    logit.  In bf16 compute, the main path, the kernel path must lie no
    farther from the f32 plain path than the bf16 plain path does (x
    1.5), phase 7's second rule; the bf16 paths' distance from each
    other is printed, not held to 2^-5: each rounds its activations at a
    dozen places in each of 48 layers (sqrt(576) x 2^-9 ≈ 4.7% of the
    logits' scale as a random walk, past 2^-5 ≈ 3.1%)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.train.steps import cast_for_compute

    cfg = get_config("hubert-xlarge")
    B, S = HUBERT_BATCH, HUBERT_FRAMES
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    params = M.init_params(gen, cfg, device="cuda")
    params_c = cast_for_compute(params, bf16)
    batch = {"embeds": torch.randn((B, S, cfg.d_model), device=dev,
                                   generator=gen)}
    n_params = sum(p.numel() for p in params.parameters())
    print(f"hubert-xlarge: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_params} parameters (f32 masters, bf16 compute); "
          f"{B} x {S} frame embeddings ({S / 50:.0f} s of audio at 50 Hz), "
          "bidirectional", flush=True)
    ops.reset_kernel_stats()                       # the path's window
    t0 = time.perf_counter()
    logits = M.forward(params_c, cfg, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    check(launches == {"flash_attention_fwd": cfg.num_layers,
                       "flash_attention_fwd:bf16": cfg.num_layers},
          f"hubert flash launches {launches}, want {cfg.num_layers} of the "
          "bf16 wgmma kernel and no plain version")
    check(logits.shape == (B, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "hubert logits")
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    lr = M.forward(params_c, cfg_ref, batch)
    check(ops.kernel_stats() == launches, "the ref path launched the kernel")
    l32 = M.forward(params, cfg_ref, batch)
    # the float32 route through all 48 layers, against the f32 plain path
    ops.reset_kernel_stats()
    lk32 = M.forward(params, cfg, batch)
    f32_launches = ops.kernel_stats()
    check(f32_launches == {"flash_attention_fwd": cfg.num_layers,
                           "flash_attention_fwd:f32": cfg.num_layers},
          f"hubert f32 flash launches {f32_launches}")
    tol32 = LOGIT_RTOL * float(l32.abs().max())
    d32 = float((lk32 - l32).abs().max())
    tol = LOGIT_RTOL * float(lr.abs().max())
    diff = float((logits - lr).abs().max())
    to32_k = float((logits - l32).abs().max())
    to32_r = float((lr - l32).abs().max())
    print(f"hubert forward: {first_s:.2f} s (first call), launches "
          f"{launches}; f32 compute: kernel path vs plain path max |diff| "
          f"{d32:.3g} (tolerance {tol32:.4f} = {LOGIT_RTOL} x max|logit|); "
          f"bf16 compute: max|logit| {float(lr.abs().max()):.3f}, kernel vs "
          f"plain path max |diff| {diff:.4f} = {diff / tol * LOGIT_RTOL:.4f} "
          f"x max|logit| (reported: at 48 layers the two bf16 paths' own "
          f"roundings part by more than {LOGIT_RTOL}), to the f32 plain "
          f"path: kernel path {to32_k:.4f}, bf16 plain path {to32_r:.4f}",
          flush=True)
    check(d32 <= tol32, f"hubert f32 logits: kernel vs plain path {d32} > "
                        f"{tol32}")
    check(to32_k <= max(tol, 1.5 * to32_r),
          "the hubert kernel path is farther from the f32 plain path than "
          "bf16 compute explains")
    del lr, l32, lk32
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        M.forward(params_c, cfg, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(times)
    print(f"hubert forward ({B} x {S} frames): {fwd_ms:.2f} ms median of 5 "
          f"({sorted(round(t, 2) for t in times)}), "
          f"{B * S / fwd_ms * 1e3:.0f} frames/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_window(torch, "hubert forward", lambda: M.forward(
        params_c, cfg, batch), calls=2)

    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = (torch.randn((B, H, S, D), device=dev, generator=gen).to(bf16)
               for _ in range(3))
    got = ops.flash_attention_fwd(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    r = row_rel_err(got, want)
    check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
          and r <= FLASH_BF16_ROW_RTOL, f"flash at hubert's shape: row "
                                        f"error {r:.4g}")
    ms = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v,
                                                        causal=False))
    queued = queued_ms(torch, lambda: ops.flash_attention_fwd(q, k, v,
                                                              causal=False))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v,
                                                             causal=False))
    sdpa = F.scaled_dot_product_attention(q, k, v)
    check(torch.allclose(sdpa.float(), want.float(), rtol=2e-2, atol=2e-2),
          "scaled_dot_product_attention disagrees at hubert's shape")
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4 * B * H * S * S * D
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = 4 * B * H * S * D * 2 / PEAK_BYTES_PER_S * 1e3
    bnd, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                    else "bytes")
    print(f"flash_attention_fwd at hubert's shape (B={B} H={H} S={S} D={D} "
          f"bf16 bidirectional): {ms:.4f} ms, queued {queued:.4f} ms "
          f"({flops / queued / 1e9:.1f} TFLOP/s), bound {bnd:.4f} ms ({by}), "
          f"plain {plain_ms:.3f} ms, scaled_dot_product_attention "
          f"{lib_ms:.4f} ms; max abs err "
          f"{float((got.float() - want.float()).abs().max()):.4g}, row "
          f"error {r:.4g}", flush=True)
    del q, k, v, got, want, sdpa, params, params_c, logits, batch
    torch.cuda.empty_cache()
    return {"launches": launches["flash_attention_fwd"], "ms": ms,
            "queued_ms": queued, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": lib_ms}


def cws_unsure(torch, weights, params, ulps: int = 4):
    """(batch, L) bool, on the CPU: the lanes where a ``floor`` argument
    of ``zbit_cws`` lies within ``ulps`` float32 ulps of an integer, or
    the two smallest ln a lie within ``ulps`` ulps of each other — where
    one ulp of ``log`` between two devices may flip the symbol."""
    r, c, beta = params
    out = []
    for lo in range(0, weights.shape[0], 256):
        w = weights[lo:lo + 256]
        logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)),
                           -torch.inf)
        x = logw[:, None, :] / r + beta
        fin = torch.isfinite(x)
        xs = torch.where(fin, x, 0.0)
        ulp = torch.nextafter(xs.abs(), torch.tensor(torch.inf)) - xs.abs()
        near = (fin & ((xs - torch.round(xs)).abs() <= ulps * ulp)).any(-1)
        lna = torch.log(c) - r * (torch.floor(x) - beta) - r
        lna = torch.where(torch.isfinite(logw)[:, None, :], lna, torch.inf)
        top2 = torch.topk(lna, 2, dim=-1, largest=False).values
        fin2 = torch.isfinite(top2[..., 1])
        top2 = torch.where(torch.isfinite(top2), top2, 0.0)
        big = top2.abs().amax(-1)
        gap = torch.nextafter(big, torch.tensor(torch.inf)) - big
        out.append(near | (fin2 & (top2[..., 1] - top2[..., 0] <= ulps * gap)))
    return torch.cat(out)


def cws_sketching(torch, args, dev) -> None:
    """Phase 9: ``zbit_cws`` at the paper's SIFT and GIST shapes
    (CWS_SHAPES), weights and draws made on the card from ``--seed``:
    rows/s by CUDA events, and the first CWS_CHECK_ROWS rows held against
    the port's CPU run, equal except at the lanes ``cws_unsure`` names."""
    from repro_torch.core import cws_params, zbit_cws

    for name, n, dim, L, b in CWS_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(args.seed + dim)
        if name == "SIFT":       # uint8-valued descriptors, a third zero
            w = torch.randint(0, 256, (n, dim), generator=gen,
                              device=dev).float()
            w[torch.rand((n, dim), generator=gen, device=dev) < 1 / 3] = 0
        else:                    # non-negative real-valued descriptors
            w = torch.rand((n, dim), generator=gen, device=dev)
        params = cws_params(L, dim, gen, device=dev)
        zbit_cws(params, w[:CWS_CHECK_ROWS], L=L, b=b)      # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sk = zbit_cws(params, w, L=L, b=b)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        check(sk.shape == (n, L) and sk.dtype == torch.uint8
              and int(sk.max()) < (1 << b), f"zbit_cws {name} output")
        w_cpu = w[:CWS_CHECK_ROWS].cpu()
        p_cpu = tuple(p.cpu() for p in params)
        want = zbit_cws(p_cpu, w_cpu, L=L, b=b)
        unsure = cws_unsure(torch, w_cpu, p_cpu)
        differ = sk[:CWS_CHECK_ROWS].cpu() != want
        check(not bool((differ & ~unsure).any()),
              f"zbit_cws {name}: {int((differ & ~unsure).sum())} symbols "
              "differ from the CPU run outside the ulp rule")
        print(f"zbit_cws {name} (n={n} dim={dim} L={L} b={b}): {ms:.1f} ms, "
              f"{n / ms * 1e3:.0f} rows/s; first {CWS_CHECK_ROWS} rows "
              f"against the CPU: {int(differ.sum())} symbols differ, "
              f"{int(unsure.sum())} of {unsure.numel()} lanes within 4 "
              f"ulps", flush=True)
        del w, sk, params
        torch.cuda.empty_cache()


def serving_smollm(torch, args, dev, ops, ref) -> dict:
    """Phase 7b: serve smollm-135m at full width — SERVE_BATCH requests of
    SERVE_PROMPT uniform token ids, SERVE_GEN greedy tokens each, random
    weights from ``--seed`` (f32 masters, bf16 compute) — through
    ``launch.serve.generate``, with the flash kernel's launches counted
    around it; the kernel path's prefill held against the plain
    ``attn_impl="ref"`` path on the same weights and prompts; then the
    times.  Returns the flash kernel's JSON fields."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.train.steps import (cast_for_compute, make_decode_step,
                                         make_prefill_step)

    cfg = get_config(SERVE_ARCH)
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    s_max = S + G
    bf16 = torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device="cuda")
    rng = np.random.default_rng(args.seed + 7)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                               .astype(np.int32)).to(dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{SERVE_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv} x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters (f32 "
          f"masters, bf16 compute); {B} requests x {S} prompt tokens + {G} "
          f"greedy, s_max {s_max}", flush=True)

    ops.reset_kernel_stats()                       # the main path's window
    t0 = time.perf_counter()
    tokens, logits = generate(params, cfg, prompts, G, s_max=s_max,
                              compute_dtype=bf16)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    peak = torch.cuda.max_memory_allocated() - base_mem
    print(f"serving path: {serve_s:.2f} s (first call), launches {launches}, "
          f"peak {peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} "
          f"GiB held before it", flush=True)
    check(launches == {"flash_attention_fwd": cfg.num_layers,
                       "flash_attention_fwd:bf16": cfg.num_layers},
          f"flash launches per prefill {launches}, want {cfg.num_layers} "
          "of the bf16 wgmma kernel and no plain version")
    check(tokens.shape == (B, G) and tokens.dtype == torch.int32
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
          f"generated tokens {tuple(tokens.shape)} {tokens.dtype}")
    check(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite")

    # the kernel path against the plain path, same weights and prompts
    params_c = cast_for_compute(params, bf16)
    pre = make_prefill_step(cfg, s_max=s_max, compute_dtype=bf16)
    pre_ref = make_prefill_step(dataclasses.replace(cfg, attn_impl="ref"),
                                s_max=s_max, compute_dtype=bf16)
    dec = make_decode_step(cfg, compute_dtype=bf16)
    lk, ck, n = pre(params_c, {"tokens": prompts})
    ops.reset_kernel_stats()
    lr, cr, _ = pre_ref(params_c, {"tokens": prompts})
    check(ops.kernel_stats() == {}, f"the ref path launched "
          f"{ops.kernel_stats()}")
    # the f32 plain path: how far bf16 compute alone moves the logits
    l32 = make_prefill_step(dataclasses.replace(cfg, attn_impl="ref"),
                            s_max=s_max, compute_dtype=torch.float32)(
        params, {"tokens": prompts})[0]
    tol = LOGIT_RTOL * float(lr.abs().max())
    to32_k = float((lk - l32).abs().max())
    to32_r = float((lr - l32).abs().max())
    print(f"prefill logits: max|logit| {float(lr.abs().max()):.3f}; max "
          f"|diff| to the f32 plain path: kernel path {to32_k:.4f}, bf16 "
          f"plain path {to32_r:.4f}", flush=True)
    check(to32_k <= max(tol, 1.5 * to32_r),
          "the kernel path is farther from the f32 plain path than bf16 "
          "compute explains")
    del l32
    for step in range(COMPARE_STEPS):
        diff = float((lk - lr).abs().max())
        check(diff <= tol, f"logits step {step}: kernel path vs ref path "
                           f"max |diff| {diff} > {tol}")
        top2 = torch.topk(lr, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        same = torch.argmax(lk, -1) == torch.argmax(lr, -1)
        check(bool(same[sure].all()), f"greedy tokens differ at step {step} "
                                      "where the margin exceeds the tolerance")
        print(f"step {step}: max |logit diff| kernel vs ref path {diff:.4f} "
              f"(tolerance {tol:.4f} = {LOGIT_RTOL} x max|logit|), greedy "
              f"tokens equal {int(same.sum())}/{B}, {int(sure.sum())} with a "
              "margin above the tolerance", flush=True)
        tok = torch.argmax(lk, dim=-1).to(torch.int32)[:, None]
        lk, ck = dec(params_c, tok, ck, n + step)
        lr, cr = dec(params_c, tok, cr, n + step)
    check(torch.equal(tokens[:, 0], torch.argmax(logits, -1).to(torch.int32)),
          "generate's first token is not the prefill's argmax")
    del ck, cr, lk, lr

    # times
    def prefill_once():
        return pre(params_c, {"tokens": prompts})

    prefill_once()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        prefill_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times)
    _, cache, n = prefill_once()
    tok = tokens[:, :1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G - 1):
        lg, cache = dec(params_c, tok, cache, n + i)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (G - 1)
    profile_window(torch, "decode step", lambda: dec(     # the last slot,
        params_c, tok, cache, n + G - 1), calls=3)        # rewritten
    del cache
    e2e_s = (prefill_ms + decode_ms * (G - 1)) / 1e3
    print(f"prefill ({B} x {S} tokens): {prefill_ms:.2f} ms median of 5 "
          f"({sorted(round(x, 2) for x in times)}), "
          f"{B * S / prefill_ms * 1e3:.0f} prompt tokens/s", flush=True)
    print(f"decode: {decode_ms:.3f} ms per step (batch {B}, {G - 1} steps), "
          f"{B / decode_ms * 1e3:.0f} generated tokens/s; a request of {S} + "
          f"{G} tokens: {e2e_s:.3f} s, {B * G / e2e_s:.0f} generated "
          f"tokens/s over prefill and decode", flush=True)
    print(f"max_memory_allocated: serving {peak / 2**30:.3f} GiB (f32 "
          "masters, bf16 copy, caches, activations)", flush=True)
    profile_window(torch, "prefill", prefill_once, calls=2)

    # the kernel at the prefill's shape, beside its bound, plain and SDPA:
    # the bf16 route on contiguous (B, H, S, D) inputs and on the model's
    # strided (B, S, H, D) views, and the float32 route
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = (torch.randn((B, H, S, D), device=dev, generator=gen).to(bf16)
               for _ in range(3))
    q_s, k_s, v_s = (torch.randn((B, S, H, D), device=dev, generator=gen)
                     .to(bf16).transpose(1, 2) for _ in range(3))
    for what, x in (("(B, H, S, D)", (q, k, v)),
                    ("the strided (B, S, H, D) views", (q_s, k_s, v_s))):
        got = ops.flash_attention_fwd(*x, causal=True)
        want = ref.flash_attention_ref(*x, causal=True)
        r = row_rel_err(got, want)
        check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
              and r <= FLASH_BF16_ROW_RTOL,
              f"flash kernel on {what}: row error {r:.4g}")
        print(f"flash kernel on {what} at the prefill's shape: max abs err "
              f"{float((got.float() - want.float()).abs().max()):.4g}, row "
              f"error {r:.4g} (limit {FLASH_BF16_ROW_RTOL})", flush=True)
    del got, want
    q32, k32, v32 = q.float(), k.float(), v.float()
    f32_ms = time_ms(torch, lambda: ops.flash_attention_fwd(
        q32, k32, v32, causal=True), iters=3)
    del q32, k32, v32
    ms = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, causal=True))
    strided_ms = time_ms(torch, lambda: ops.flash_attention_fwd(
        q_s, k_s, v_s, causal=True))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v,
                                                             causal=True))
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    check(torch.allclose(sdpa.float(), want.float(), rtol=2e-2, atol=2e-2),
          "scaled_dot_product_attention disagrees with the plain version")
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    nbytes = 4 * B * H * S * D * 2
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bnd, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                    else "bytes")
    print(f"flash_attention_fwd float32 route (scalar kernel, B={B} H={H} "
          f"S={S} D={D} causal): {f32_ms:.3f} ms per launch", flush=True)
    print(f"flash_attention_fwd (B={B} H={H} S={S} D={D} bf16 causal, "
          f"wgmma): {ms:.4f} ms per launch on (B, H, S, D), "
          f"{strided_ms:.4f} ms on the strided (B, S, H, D) views (the "
          f"scalar kernel before it: {FLASH_SCALAR_MS} ms), bound "
          f"{bnd:.4f} ms ({by}; bytes {t_bytes:.4f} ms), "
          f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; "
          f"scaled_dot_product_attention {lib_ms:.4f} ms", flush=True)
    del q, k, v, q_s, k_s, v_s, sdpa, want, params, params_c
    torch.cuda.empty_cache()
    return {"launches": launches["flash_attention_fwd"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def review_static(seed: int):
    """Phase 3's Review sketches and queries, made from ``seed``: REVIEW_N
    uniform sketches, M_QUERIES // 2 database rows with 0-3 symbols
    perturbed and as many uniform rows."""
    rng = np.random.default_rng(seed)
    sketches = rng.integers(0, 1 << REVIEW_B, size=(REVIEW_N, REVIEW_L),
                            dtype=np.uint8)
    near = sketches[rng.integers(0, REVIEW_N, size=M_QUERIES // 2)].copy()
    for row in near:                     # 0-3 symbols perturbed per row
        pos = rng.choice(REVIEW_L, size=rng.integers(0, 4), replace=False)
        row[pos] = (row[pos] + rng.integers(1, 1 << REVIEW_B, size=len(pos))) \
            % (1 << REVIEW_B)
    far = rng.integers(0, 1 << REVIEW_B, size=(M_QUERIES // 2, REVIEW_L),
                       dtype=np.uint8)
    return sketches, np.concatenate([near, far])


def check_batched_kernels(torch, ops, ref, dev, gen, words, maxerr,
                          err) -> int:
    """Phase 2, the batched launches of the scan and the verify (grid.z
    over the batch): SWEEP_BATCH entries over BATCH_BL, ragged n and m,
    the scan's query planes shared (batch stride 0) and per entry, the
    verify's base planes with BIG lanes.  Returns the shapes checked."""
    checks = 0
    for B in SWEEP_BATCH:
        for b, L in BATCH_BL:
            W = (L + 31) // 32
            for n in BATCH_N:
                db = words(B, b, W, n)
                for m in BATCH_M:
                    for shared in (True, False):
                        q = words(1 if shared else B, b, W, m)
                        got = ops.hamming_distances_batched(db, q)
                        want = ref.hamming_distances_batched_ref(db, q)
                        e = maxerr(got, want)
                        err["hamming_distances_batched"] = max(
                            err["hamming_distances_batched"], e)
                        check(e == 0, f"hamming_distances_batched B={B} "
                                      f"b={b} L={L} n={n} m={m} "
                                      f"shared={shared}")
                        checks += 1
                    q = words(b, W, m)
                    for tau in SWEEP_TAU:
                        base = torch.randint(0, tau + 3, (B, m, n),
                                             dtype=torch.int32, device=dev,
                                             generator=gen)
                        pruned = torch.rand((B, m, n), device=dev,
                                            generator=gen) < 0.2
                        base[pruned] = BIG
                        got = ops.sparse_verify_batch_batched(db, q, base,
                                                              tau=tau)
                        want = ref.sparse_verify_batch_batched_ref(db, q,
                                                                   base, tau)
                        e = max(maxerr(got[0], want[0]),
                                maxerr(got[1], want[1]))
                        err["sparse_verify_batch_batched"] = max(
                            err["sparse_verify_batch_batched"], e)
                        check(e == 0, f"sparse_verify_batch_batched B={B} "
                                      f"b={b} L={L} n={n} m={m} tau={tau}")
                        checks += 1
                del db
    return checks


def gather_ids(torch, gen, dev, n: int, counts, C: int):
    """(m, C) int32 candidate ids: each row's valid prefix ascending random
    ids, 0 and n - 1 at its ends where it holds two, random ids past it
    (what the compaction leaves there is never read)."""
    ids = torch.randint(0, n, (len(counts), C), dtype=torch.int32,
                        device=dev, generator=gen)
    for j, k in enumerate(counts):
        if k:
            row = torch.randint(0, n, (k,), dtype=torch.int32, device=dev,
                                generator=gen).sort().values
            if k >= 2:
                row[0], row[-1] = 0, n - 1
            ids[j, :k] = row
    return ids


def check_gather_kernel(torch, ops, ref, dev, gen, words, maxerr,
                        err) -> int:
    """Phase 2, the candidate verify (``hamming_distances_gather``) against
    its plain version: GATHER_BL over W 1-2, n not a multiple of 32, 5
    queries whose counts are 0, C and ragged, ids at 0 and n - 1.
    Returns the shapes checked."""
    checks = 0
    for b, L in GATHER_BL:
        W = (L + 31) // 32
        for n in GATHER_N:
            db = words(b, W, n)
            for C in GATHER_C:
                m = 5
                q = words(b, W, m)
                ragged = torch.randint(0, C + 1, (3,), generator=gen,
                                       device=dev).tolist()
                counts = [0, C, *ragged]
                ids = gather_ids(torch, gen, dev, n, counts, C)
                cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
                got = ops.hamming_distances_gather(db, q, ids, cnt)
                e = maxerr(got, ref.hamming_distances_gather_ref(db, q, ids,
                                                                 cnt))
                err["hamming_distances_gather"] = max(
                    err["hamming_distances_gather"], e)
                check(e == 0, f"hamming_distances_gather b={b} L={L} n={n} "
                              f"C={C} counts={counts}")
                checks += 1
            del db
    return checks


def gather_bound(ops, full, qp, ids, counts):
    """(bound_ms, bound_by, sector_ms) of one candidate verify from its
    arguments: the bound over ``ops._gather_cost``'s bytes and
    operations (the function's own), and the same bytes with a 32-byte
    sector for each gathered word — what the (b, W, n) layout costs the
    card when the candidates lie far apart, a layout figure beside the
    bound."""
    n_ops, nbytes, _ = ops._gather_cost(full, qp, ids, counts)
    b, W, _ = full.shape
    V = int(counts.clamp(0, ids.shape[1]).sum())
    ms, by = bound_ms(nbytes, n_ops)
    return ms, by, bound_ms(nbytes + 28 * b * W * V, n_ops)[0]


def device_ms(torch, fn, calls: int = 20) -> float:
    """Mean device time of ``calls`` calls of ``fn`` queued behind a sleep
    kernel (the kernels' own time, whatever the host's share of a
    call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)        # ≈ 25 ms at the H100's clocks
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def cold_device_ms(torch, fn, iters: int = 5) -> float:
    """Median device time of one call of ``fn`` with the L2 cold: before
    each call a 256 MB fill evicts the card's 50 MB L2 and a short sleep
    kernel covers the host's enqueue, so the events bracket the kernels
    alone."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.fill_(_)
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def host_ms(torch, fn, iters: int = 5):
    """(median, sorted samples): host-clock ms of a synchronised ``fn``
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), sorted(round(t, 2) for t in times)


def capture_args(ops, name: str, fn) -> tuple:
    """Run ``fn`` once with the wrapper ``ops.<name>`` recording the
    positional operands of its last call: the kernel's inputs on the
    path, for timing it alone."""
    orig = getattr(ops, name)
    seen = {}

    def spy(*a, **kw):
        seen["args"] = a
        return orig(*a, **kw)
    setattr(ops, name, spy)
    try:
        fn()
    finally:
        setattr(ops, name, orig)
    return seen["args"]


def planes_to_symbols(torch, planes, b: int, L: int):
    """(B, b, W, n) int32 bit-plane words -> (B, n, L) float32 symbols,
    the inverse of ``pack_vertical`` (bit l of word l // 32 of plane i is
    bit i of symbol l): the operand of the library call ``cdist(p=0)``."""
    pos = torch.arange(L, device=planes.device)
    words = planes[:, :, pos // 32, :]                    # (B, b, L, n)
    bits = (words >> (pos % 32)[None, None, :, None]) & 1
    sym = sum(bits[:, i] << i for i in range(b))          # (B, L, n)
    return sym.transpose(1, 2).float().contiguous()


def batched_bound(B: int, b: int, W: int, n: int, m: int, q_sets: int,
                  verify: bool):
    """(bound_ms, bound_by) of one batched launch: B databases of (b, W,
    n) words and ``q_sets`` sets of m query columns read once, B (m, n)
    planes in (the verify's base) and out; per (entry, query, column) the
    operations of ``bound``."""
    planes = 3 if verify else 1                   # base in; mask, dist out
    nbytes = 4 * (B * b * W * n + q_sets * b * W * m + planes * B * m * n)
    ops = B * m * n * (W * (2 * b + 1) + (3 if verify else 0))
    return bound_ms(nbytes, ops)


def static_multi(torch, dev, ops, ref, err, maxerr, sketches, qs, d,
                 si_ms) -> tuple:
    """Phase 10 (a): the static MI-bST on the Review sketches.  Returns the
    kernel lines of the candidate verify and of the batched scan (timed
    on the same candidates, off the MI path)."""
    from repro_torch.core import build_multi_index, choose_plan, mi_search_batch
    from repro_torch.core.multi_index import candidate_capacity

    n, L, b = len(sketches), REVIEW_L, REVIEW_B
    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    mi = build_multi_index(sketches, b, MI_BLOCKS, device=dev)
    torch.cuda.synchronize()
    blocks = [(lo, hi, blk.ls, blk.t[-1])
              for blk, (lo, hi) in zip(mi.blocks, mi.bounds)]
    print(f"(a) build_multi_index m={MI_BLOCKS} n={n}: "
          f"{time.perf_counter() - t0:.1f} s; blocks (lo, hi, l_s, leaves) "
          f"{blocks}; model_bits {mi.model_bits()}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_stats()                       # the static MI path
    res, per_call = {}, {}
    for tau in (1, 2, 3):
        before = ops.kernel_stats().get("hamming_distances_gather", 0)
        res[tau] = mi_search_batch(mi, qs_t, tau)
        per_call[tau] = ops.kernel_stats().get("hamming_distances_gather",
                                               0) - before
    torch.cuda.synchronize()
    launches = ops.kernel_stats()
    peak = torch.cuda.max_memory_allocated()
    print(f"(a) mi_search_batch tau=1,2,3 (m={M_QUERIES}): launches "
          f"{launches}, candidate verifies a call {per_call}, peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    check(all(c >= 1 for c in per_call.values()),
          f"the candidate verify kernel not launched on every MI call: "
          f"{per_call}")
    check(not any(k.startswith("hamming_distances_batched")
                  for k in launches),
          f"the batched scan ran on the MI path: {launches}")
    check(not any(k.endswith(":ref") for k in launches),
          f"plain version ran on the MI path: {launches}")
    for tau, r in res.items():
        inside = d <= tau
        check(int(r.overflow.sum()) == 0, f"MI tau={tau}: overflow")
        check(torch.equal(r.mask, inside)
              and torch.equal(r.dist, torch.where(inside, d, BIG)),
              f"MI tau={tau}: mask/dist != the scan kernel at tau")
        c = r.candidates.float()
        print(f"(a) tau={tau}: candidates per query min/median/max "
              f"{int(c.min())}/{int(c.median())}/{int(c.max())} (capacity "
              f"{candidate_capacity(mi, tau)}), overflow 0", flush=True)
        del inside
    del res
    plan = choose_plan(b, L, 3, n)
    check(plan == ("multi", 2), f"choose_plan({b}, {L}, 3, {n}) = {plan}")
    print(f"(a) MI-bST masks and distances exact at tau=1,2,3 against the "
          f"scan kernel; choose_plan({b}, {L}, 3, {n}) = {plan}", flush=True)
    for tau in (1, 2, 3):
        ms, samples = host_ms(torch, lambda: mi_search_batch(mi, qs_t, tau))
        print(f"(a) range search tau={tau}, m={M_QUERIES}: MI-bST {ms:.2f} "
              f"ms median of 5 {samples}; SI-bST {si_ms[tau]:.2f} ms "
              "(phase 4)", flush=True)
    profile_window(torch, "(a) mi_search_batch tau=3",
                   lambda: mi_search_batch(mi, qs_t, 3))
    # the candidate verify at tau 3's captured shape, whole (m, C) output
    full, qp, ids, counts = capture_args(
        ops, "hamming_distances_gather", lambda: mi_search_batch(mi, qs_t, 3))
    W = full.shape[1]
    m, C = ids.shape
    n_valid = int(counts.sum())                   # the verify's real work

    def gather():
        return ops.hamming_distances_gather(full, qp, ids, counts)
    got = gather()
    want = ref.hamming_distances_gather_ref(full, qp, ids, counts)
    e = maxerr(got, want)
    err["hamming_distances_gather"] = max(err["hamming_distances_gather"], e)
    check(e == 0, "candidate verify at the MI verify's shape")
    g_ms = time_ms(torch, gather)
    g_queued = queued_ms(torch, gather)
    g_device = device_ms(torch, gather)
    g_cold = cold_device_ms(torch, gather)
    g_plain = time_ms(torch, lambda: ref.hamming_distances_gather_ref(
        full, qp, ids, counts), iters=3)
    g_bnd, g_by, g_sector = gather_bound(ops, full, qp, ids, counts)
    # the parent's chain from the same ids: the gather of every slot's
    # columns, the copy into (m, b, W, C) and the batched scan over them
    valid = torch.arange(C, device=dev)[None, :] < counts[:, None]
    q_sets = qp.permute(2, 0, 1)[..., None].contiguous()     # (m, b, W, 1)

    def gathered():
        safe = torch.where(valid, ids, 0)
        return full.index_select(2, safe.reshape(-1)).reshape(
            b, W, m, C).permute(2, 0, 1, 3).contiguous()

    def old_chain():
        return ops.hamming_distances_batched(gathered(), q_sets,
                                             block_m=1)[:, 0, :]
    check(torch.equal(torch.where(valid, old_chain(), BIG), got),
          "the old chain disagrees with the candidate verify")
    chain_ms = time_ms(torch, old_chain)
    chain_queued = queued_ms(torch, old_chain)
    chain_device = device_ms(torch, old_chain)
    chain_cold = cold_device_ms(torch, old_chain)
    # the batched scan alone on the gathered slots (kernel row 2b's old
    # design, off the MI path now): held bit for bit against its plain
    # version and the same (m, 1, C) distances in one library call,
    # batched cdist(p=0) over the symbols decoded from the same words;
    # timed once each for its line of the kernels JSON
    cand = gathered()
    scan = ops.hamming_distances_batched(cand, q_sets, block_m=1)
    e = maxerr(scan, ref.hamming_distances_batched_ref(cand, q_sets))
    err["hamming_distances_batched"] = max(err["hamming_distances_batched"], e)
    check(e == 0, "batched scan at the MI verify's shape")
    s_ms = time_ms(torch, lambda: ops.hamming_distances_batched(
        cand, q_sets, block_m=1))
    s_plain = time_ms(torch, lambda: ref.hamming_distances_batched_ref(
        cand, q_sets), iters=3)
    qf, cf = (planes_to_symbols(torch, x, b, L) for x in (q_sets, cand))
    check(torch.equal(torch.cdist(qf, cf, p=0).to(torch.int32), scan),
          "batched cdist(p=0) disagrees with the batched scan at the MI verify")
    lib_ms = time_ms(torch, lambda: torch.cdist(qf, cf, p=0))
    # the old 4-byte reckoning (each word once, as if the candidates were
    # contiguous), over the valid candidates and over every slot
    old_bnd, by = batched_bound(1, b, W, n_valid, 1, m, verify=False)
    pad_bnd, _ = batched_bound(m, b, W, C, 1, m, verify=False)
    print(f"hamming_distances_gather at the MI verify ({m} queries, b={b} "
          f"W={W}, C={C} slots, {n_valid} valid candidates): {g_ms:.4f} "
          f"ms, queued {g_queued:.4f} ms, device {g_device:.4f} ms, L2 "
          f"cold {g_cold:.4f} ms, bound {g_bnd:.4f} ms ({g_by}; with a "
          f"32-byte sector a gathered word {g_sector:.4f}; old reckoning "
          f"{old_bnd:.4f} over the valid candidates, {pad_bnd:.4f} over "
          f"the slots), plain "
          f"{g_plain:.3f} ms; the old chain (index_select + permute + "
          f"batched scan) {chain_ms:.4f} ms, queued {chain_queued:.4f} ms, "
          f"device {chain_device:.4f} ms, L2 cold {chain_cold:.4f} ms",
          flush=True)
    print(f"hamming_distances_batched on the gathered slots (tile 1): "
          f"{s_ms:.4f} ms, plain {s_plain:.3f} ms, batched cdist(p=0) "
          f"{lib_ms:.3f} ms", flush=True)
    del mi, full, qp, ids, counts, got, want, cand, scan, qf, cf, valid
    torch.cuda.empty_cache()
    gather_json = {"launches": launches["hamming_distances_gather"],
                   "ms": g_ms, "queued_ms": g_queued, "device_ms": g_device,
                   "cold_device_ms": g_cold,
                   "plain_ms": g_plain, "bound_ms": g_bnd, "bound_by": g_by,
                   "library_ms": None, "sector_reckoning_ms": g_sector,
                   "old_reckoning_ms": old_bnd,
                   "slots_reckoning_ms": pad_bnd,
                   "old_chain_ms": chain_ms,
                   "old_chain_queued_ms": chain_queued,
                   "old_chain_device_ms": chain_device,
                   "old_chain_cold_device_ms": chain_cold}
    # off the MI path: launched on the main path no time
    batched_json = {"launches": launches.get("hamming_distances_batched", 0),
                    "main_path": False, "ms": s_ms, "plain_ms": s_plain, "bound_ms": old_bnd,
                    "bound_by": by, "library_ms": lib_ms,
                    "batched": "queries"}
    return gather_json, batched_json


def static_sharded(torch, dev, ops, ref, err, maxerr, sketches, qs, d,
                   si_ms) -> dict:
    """Phase 10 (b): the static sharded bST, S = SHARDS, on the Review
    sketches."""
    from repro_torch.core import (build_sharded_bst, gather_ids, gather_topk,
                                  make_sharded_searcher)

    n, b = len(sketches), REVIEW_B
    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    sh = build_sharded_bst(sketches, b, SHARDS, device=dev)
    torch.cuda.synchronize()
    print(f"(b) build_sharded_bst S={SHARDS} n={n}: "
          f"{time.perf_counter() - t0:.1f} s; lm={sh.lm} ls={sh.ls} kinds "
          f"{list(sh.kinds)}, n_max {sh.n_max}, padded leaves "
          f"{sh.paths_vert.shape[-1]}, model_bits {sh.model_bits()}",
          flush=True)
    searchers = {tau: make_sharded_searcher(sh, tau) for tau in (1, 2, 3)}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_stats()                       # the static sharded path
    res = {tau: fn(qs_t) for tau, fn in searchers.items()}
    torch.cuda.synchronize()
    launches = ops.kernel_stats()
    peak = torch.cuda.max_memory_allocated()
    print(f"(b) sharded searcher (scan) tau=1,2,3 (m={M_QUERIES}): launches "
          f"{launches}, peak {peak / 2**30:.2f} GiB", flush=True)
    check(launches.get("sparse_verify_batch_batched", 0) == 3,
          "the shard-batched verify not launched once a call")
    check(not any(k.endswith(":ref") for k in launches),
          f"plain version ran on the sharded path: {launches}")

    def merged(x):                                 # (m, S, n_max) -> (m, n)
        return x.reshape(M_QUERIES, -1).index_select(1, sh.merge_idx)
    for tau, (masks, dists, ov) in res.items():
        inside = d <= tau
        check(int(ov) == 0, f"sharded tau={tau}: overflow {int(ov)}")
        check(torch.equal(merged(masks), inside)
              and torch.equal(merged(dists), torch.where(inside, d, BIG)),
              f"sharded tau={tau}: mask/dist != the scan kernel at tau")
        del inside
    masks, dists, _ = res[3]
    # the host merges run on the checked rows alone (cut: over all 64
    # queries they took ≈ 40 s of host numpy at this n)
    rows = list(GATHER_CHECK_ROWS)
    got_ids = gather_ids(sh, masks[rows])
    for j, i in enumerate(rows):
        want = torch.nonzero(d[i] <= 3).flatten().cpu().numpy()
        check(np.array_equal(got_ids[j], want), f"gather_ids row {i}")
    ids, dk = gather_topk(sh, dists[rows], TOPK)
    sd, si = torch.sort(torch.where(d[rows] <= 3, d[rows], BIG), dim=1,
                        stable=True)                # ties by id
    real = sd[:, :TOPK] < BIG
    check(np.array_equal(ids, torch.where(
        real, si[:, :TOPK], -1).cpu().numpy())
          and np.array_equal(dk, sd[:, :TOPK].cpu().numpy()),
          f"gather_topk rows {rows} != the stable sort")
    for i in (0, M_QUERIES - 1):                   # host witness
        j = rows.index(i)
        hd = (sketches != qs[i][None, :]).sum(axis=1)
        hd = np.where(hd <= 3, hd, BIG)
        # (distance, id) order: a stable sort of the distances, one byte
        # each (0..3, and 4 for BIG), which numpy sorts by radix
        order = np.argsort(np.minimum(hd, 4).astype(np.uint8),
                           kind="stable")[:TOPK]
        check(np.array_equal(ids[j], np.where(hd[order] < BIG, order, -1))
              and np.array_equal(dk[j], hd[order]),
              f"gather_topk row {i} != the numpy host check")
    del res, masks, dists, sd, si
    g = make_sharded_searcher(sh, 2, verify="gather")
    t0 = time.perf_counter()
    gm, gd, gov = g(qs_t[:8])
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    sm, sd, _ = searchers[2](qs_t[:8])
    check(int(gov) == 0 and torch.equal(gm, sm) and torch.equal(gd, sd),
          "verify='gather' differs from the scan at tau=2")
    print(f"(b) sharded bST exact at tau=1,2,3 against the scan kernel; "
          f"gather_ids and gather_topk(k={TOPK}) at tau=3 against it and "
          f"the stable sort on rows {rows}, numpy on rows 0 and "
          f"{M_QUERIES - 1}; verify='gather' (8 queries, tau=2, the "
          f"plain verify per query and shard) equal to the scan in "
          f"{g_s:.2f} s", flush=True)
    del gm, gd, sm, sd
    for tau, fn in searchers.items():
        ms, samples = host_ms(torch, lambda: fn(qs_t))
        print(f"(b) range search tau={tau}, m={M_QUERIES}: sharded bST "
              f"S={SHARDS} {ms:.2f} ms median of 5 {samples}; SI-bST "
              f"{si_ms[tau]:.2f} ms (phase 4)", flush=True)
    profile_window(torch, "(b) sharded searcher tau=3",
                   lambda: searchers[3](qs_t))
    paths, q_sfx, base = capture_args(ops, "sparse_verify_batch_batched",
                                      lambda: searchers[3](qs_t))
    S, bb, W, n_pad = paths.shape
    got = ops.sparse_verify_batch_batched(paths, q_sfx, base, tau=3)
    slices = range(0, M_QUERIES, 8)

    def plain():
        return [ref.sparse_verify_batch_batched_ref(
            paths, q_sfx[..., r0:r0 + 8], base[:, r0:r0 + 8], 3)
            for r0 in slices]
    for r0, (w_mask, w_dist) in zip(slices, plain()):
        e = max(maxerr(got[0][:, r0:r0 + 8], w_mask),
                maxerr(got[1][:, r0:r0 + 8], w_dist))
        err["sparse_verify_batch_batched"] = max(
            err["sparse_verify_batch_batched"], e)
        check(e == 0, "shard-batched verify at the sharded path's shape")
    del got, w_mask, w_dist
    ms = time_ms(torch, lambda: ops.sparse_verify_batch_batched(
        paths, q_sfx, base, tau=3))
    plain_ms = time_ms(torch, plain, iters=3)
    bnd, by = batched_bound(S, bb, W, n_pad, M_QUERIES, 1, verify=True)
    print(f"sparse_verify_batch_batched at the sharded scan (S={S} shards, "
          f"b={bb} W={W}, {n_pad} padded leaves, m={M_QUERIES}): {ms:.3f} "
          f"ms, bound {bnd:.3f} ms ({by}), plain {plain_ms:.3f} ms",
          flush=True)
    del sh, searchers, paths, q_sfx, base
    torch.cuda.empty_cache()
    return {"launches": launches["sparse_verify_batch_batched"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "batched": "shards"}


def segmented_backends(torch, dev, ops, corpus10, bst_ms) -> None:
    """Phase 10 (c): ``SegmentedIndex(backend="multi")``,
    ``SegmentedIndex(backend="sharded")`` and ``ShardedSegmentedIndex``
    over bst stacks, on the first SEG10_N of phase 5's token sets, 1%
    deleted and a live delta buffer; top-k and range planes against the
    scan kernel with dead ids at BIG, the fan-out against the fused path,
    the stacks' Jaccard re-rank against numpy."""
    from repro_torch.core import (LinearScan, SegmentedIndex,
                                  ShardedSegmentedIndex, dispatch_stats,
                                  reset_dispatch_stats)

    sk, pay, qs, qp = corpus10
    sk, pay = sk[:SEG10_N], pay[:SEG10_N]
    n, L, b, Wp = len(sk), REVIEW_L, REVIEW_B, pay.shape[1]
    dead = seg10_dead(n)
    live = np.ones(n, bool)
    live[dead] = False
    d = LinearScan.build(sk, b, device=dev).distances(qs)
    d = torch.where(torch.from_numpy(live).to(dev)[None, :], d, BIG)
    stacks = {
        "multi": (lambda: SegmentedIndex(L, b, delta_cap=DELTA10_CAP,
                                         backend="multi",
                                         mi_blocks=MI_BLOCKS, device=dev),
                  ("hamming_distances_gather", "hamming_distances")),
        "sharded": (lambda: SegmentedIndex(L, b, delta_cap=DELTA10_CAP,
                                           backend="sharded",
                                           n_shards=SHARDS, device=dev),
                    ("sparse_verify_batch_batched", "hamming_distances")),
        "sharded-stacks": (lambda: ShardedSegmentedIndex(
            L, b, n_shards=SHARDS, delta_cap=DELTA10_CAP, payload_words=Wp,
            device=dev), ("sparse_verify_arena_packed", "hamming_distances",
                          "exact_rerank", "sparse_verify_batch")),
    }
    for name, (make, kernels) in stacks.items():
        idx = make()
        stacked = isinstance(idx, ShardedSegmentedIndex)
        t0 = time.perf_counter()
        step = DELTA10_CAP // 4
        for lo in range(0, n, step):
            idx.insert(sk[lo:lo + step],
                       payloads=pay[lo:lo + step] if stacked else None)
        check(idx.delete(dead) == len(dead), f"{name}: delete count")
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        parts = idx.shards if stacked else [idx]
        delta = sum(len(p._delta_ids) for p in parts)
        print(f"(c) {name}: ingest {ingest_s:.1f} s, segments "
              f"{[[s.n for s in p.segments] for p in parts]}, delta rows "
              f"{delta}", flush=True)
        check(delta > 0, f"{name}: no live delta buffer")

        def fanout(on: bool) -> None:
            for p in parts:
                p.use_arena = not on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_stats()                   # this backend's path
        reset_dispatch_stats()
        top = idx.topk_batch(qs, TOPK)
        if stacked:
            plane = idx.search_batch(qs, top.tau)
            rr = idx.topk_batch(qs, TOPK, rerank="jaccard", q_payloads=qp)
        else:
            cols = idx.search_columns_batch(qs, top.tau)
        fanout(True)
        fan = idx.topk_batch(qs, TOPK)
        fanout(False)
        torch.cuda.synchronize()
        launches = ops.kernel_stats()
        peak = torch.cuda.max_memory_allocated()
        print(f"(c) {name}: launches {launches}, dispatches "
              f"{dispatch_stats()}, peak {peak / 2**30:.2f} GiB", flush=True)
        for k in kernels:
            check(launches.get(k, 0) > 0, f"{name}: {k} not launched")
        check(not any(k.endswith(":ref") for k in launches),
              f"{name}: plain version ran: {launches}")
        check(top.overflow == 0, f"{name}: top-k overflow")
        for r0 in range(0, M_QUERIES, 8):          # stable sort: ties by id
            sd, si = torch.sort(d[r0:r0 + 8], dim=1, stable=True)
            check(torch.equal(top.ids[r0:r0 + 8], si[:, :TOPK].to(torch.int32))
                  and torch.equal(top.dists[r0:r0 + 8], sd[:, :TOPK]),
                  f"{name}: top-k rows {r0}..{r0 + 7} != the scan kernel")
        check(fan.tau == top.tau and torch.equal(fan.ids, top.ids)
              and torch.equal(fan.dists, top.dists),
              f"{name}: the fan-out differs from the fused path")
        inside = torch.where(d <= top.tau, d, BIG)
        if stacked:
            check(plane.overflow == 0 and torch.equal(plane.dist, inside)
                  and torch.equal(plane.mask, inside <= top.tau),
                  f"{name}: search_batch != the scan kernel in the ball")
            r_ids, r_s = rr.ids.cpu().numpy(), rr.scores.cpu().numpy()
            for i in range(M_QUERIES):
                cand = torch.nonzero(d[i] <= rr.tau).flatten().cpu().numpy()
                sc = jaccard_np(qp[i], pay[cand])
                order = np.lexsort((cand, -sc))[:TOPK]
                k = len(order)
                check(np.array_equal(r_ids[i, :k], cand[order])
                      and np.array_equal(r_s[i, :k].view(np.int32),
                                         sc[order].view(np.int32)),
                      f"{name}: re-ranked row {i} != numpy Jaccard")
        else:
            want = inside.index_select(1, torch.from_numpy(cols.ids).to(dev))
            check(cols.overflow == 0 and torch.equal(cols.dist, want),
                  f"{name}: search_columns_batch != the scan kernel")
            del want
        del inside
        ms, samples = host_ms(torch, lambda: idx.topk_batch(qs, TOPK))
        print(f"(c) {name} exact (tau*={top.tau}; top-{TOPK}, range, "
              f"fan-out{', Jaccard re-rank' if stacked else ''}); topk_batch "
              f"{ms:.2f} ms median of 5 {samples} at {n} rows; the bst "
              f"backend's at {REVIEW_N} rows: {bst_ms:.2f} ms (phase 5)",
              flush=True)
        del idx, parts
        torch.cuda.empty_cache()


def baselines_check(torch, dev, ops, sketches) -> None:
    """Phase 10 (d): SIH, MIH and HmSearch (host numpy indexes; MIH's and
    HmSearch's candidates verified by the candidate verify kernel) on the
    first BASE_N Review rows, BASE_Q queries, masks against
    ``LinearScan``."""
    from repro_torch.core import MIH, SIH, HmSearch, LinearScan

    db = sketches[:BASE_N]
    rng = np.random.default_rng(BASE_N)
    qs = db[rng.integers(0, BASE_N, size=BASE_Q)].copy()
    for row in qs:
        pos = rng.choice(REVIEW_L, size=rng.integers(0, 3), replace=False)
        row[pos] = (row[pos] + 1) % (1 << REVIEW_B)
    scan = LinearScan.build(db, REVIEW_B, device=dev)
    for name, build, tau, search in (
            ("SIH", lambda: SIH.build(db, REVIEW_B), SIH_TAU,
             lambda ix, q: ix.search(q, SIH_TAU)[0]),
            ("MIH", lambda: MIH.build(db, REVIEW_B, MI_BLOCKS, device=dev),
             MIH_TAU, lambda ix, q: ix.search(q, MIH_TAU)[0]),
            ("HmSearch", lambda: HmSearch.build(db, REVIEW_B, HM_TAU,
                                                device=dev),
             HM_TAU, lambda ix, q: ix.search(q, HM_TAU)[0])):
        t0 = time.perf_counter()
        ix = build()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ops.reset_kernel_stats()
        masks = [search(ix, q) for q in qs]
        torch.cuda.synchronize()
        query_s = time.perf_counter() - t0
        launches = ops.kernel_stats()     # SIH enumerates, verifies nothing
        check((name == "SIH" or launches.get("hamming_distances_gather", 0))
              and not any(k.endswith(":ref") for k in launches),
              f"{name}: the candidate verify kernel not launched: "
              f"{launches}")
        for i, (q, mask) in enumerate(zip(qs, masks)):
            check(np.array_equal(mask, scan.search(q, tau)),
                  f"{name} tau={tau} query {i} != LinearScan")
        print(f"(d) {name} tau={tau} on {BASE_N} rows: build {build_s:.2f} "
              f"s, {BASE_Q} queries {query_s:.3f} s, masks equal to "
              f"LinearScan; {ix.array_bytes()} index bytes", flush=True)


def served_answers(torch, idx, qs, qp) -> dict:
    """Phase 11's answers of ``idx`` for the queries ``qs`` (and payloads
    ``qp``) as host arrays: top-k, the Jaccard re-rank (score bits) and
    the range planes at τ = RS_TAU as (query, id) pairs with their
    distances, plus whether every lane off the pairs holds BIG — together
    the dense planes, bit for bit."""
    top = idx.topk_batch(qs, TOPK)
    rr = idx.topk_batch(qs, TOPK, rerank="jaccard", q_payloads=qp)
    res = idx.search_batch(qs, RS_TAU)
    q_i, ids = torch.nonzero(res.mask, as_tuple=True)
    off_big = bool(((res.dist == BIG) | res.mask).all())
    out = {"ids": top.ids, "dists": top.dists, "tau": top.tau,
           "overflow": top.overflow, "rr_ids": rr.ids, "rr_dists": rr.dists,
           "rr_scores": rr.scores.view(torch.int32), "rr_tau": rr.tau,
           "r_q": q_i, "r_ids": ids, "r_dist": res.dist[res.mask],
           "r_overflow": res.overflow, "r_off_big": off_big,
           "n_ids": res.mask.shape[1]}
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def crash_child(work: Path) -> int:
    """Phase 11 step 1, in a process of its own: a durable collection
    under ``work/data`` on the card, phase 10's rows inserted through
    ``Scheduler.submit_insert`` in chunks of RS_CHUNK with their
    payloads, 1% deleted through ``submit_delete`` (a delta buffer
    stays), the answers written to ``work/answers.npz``, the journal
    synced — then ``os._exit``: no close, no flush."""
    import torch
    from repro_torch.serving import (CollectionConfig, CollectionRegistry,
                                     Scheduler, SchedulerConfig)

    sk, pay = np.load(work / "sk.npy"), np.load(work / "pay.npy")
    qs, qp = np.load(work / "qs.npy"), np.load(work / "qp.npy")
    n = len(sk)
    t0 = time.perf_counter()
    reg = CollectionRegistry(str(work / "data"), device="cuda")
    sched = Scheduler(registry=reg, config=SchedulerConfig(
        max_batch=RS_MAX_BATCH))
    coll = sched.create_collection("docs", CollectionConfig(
        L=REVIEW_L, b=REVIEW_B, delta_cap=DELTA_CAP,
        payload_words=pay.shape[1]))
    futs = [sched.submit_insert("docs", sk[lo:lo + RS_CHUNK],
                                payloads=pay[lo:lo + RS_CHUNK])
            for lo in range(0, n, RS_CHUNK)]
    sched.pump()
    ids = np.concatenate([f.result() for f in futs])
    check(np.array_equal(ids, np.arange(n)), "child: insert ids")
    dead = seg10_dead(n)
    removed = sched.submit_delete("docs", dead)
    sched.pump()
    check(removed.result() == len(dead), "child: delete count")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    idx = coll.index
    check(len(idx._delta_ids) > 0, "child: no live delta buffer")
    ans = served_answers(torch, idx, qs, qp)
    np.savez(work / "answers.npz", **ans)
    coll.store.wal.sync()
    st = coll.store.stats()
    print(json.dumps({"ingest_s": ingest_s, "segments": [
        s.n for s in idx.segments], "delta_rows": len(idx._delta_ids),
        "n_live": idx.n_live, "wal_bytes": st["wal_bytes"],
        "snapshot_bytes": st["snapshot_bytes"],
        "segments_written": st["segments_written"],
        "wal_truncations": st["wal_truncations"]}), flush=True)
    os._exit(0)


def seg10_dead(n: int) -> np.ndarray:
    """Phase 10 (c)'s and phase 11's deleted ids: 1% of the ``n`` rows,
    from seed RS_N."""
    rng = np.random.default_rng(RS_N)
    return rng.choice(n, size=int(n * DELETE_FRAC), replace=False)


def scan_topk(torch, scan, live_t, qs, k: int):
    """Exact top-k of ``qs`` from the scan kernel: dead ids at BIG, then
    a stable sort (ties by id) — (ids, dists) host arrays."""
    ids, dists = [], []
    for r0 in range(0, len(qs), M_QUERIES):
        d = scan.distances(qs[r0:r0 + M_QUERIES])
        d = torch.where(live_t[None, :], d, BIG)
        sd, si = torch.sort(d, dim=1, stable=True)
        ids.append(si[:, :k].to(torch.int32).cpu().numpy())
        dists.append(sd[:, :k].cpu().numpy())
        del d, sd, si
    return np.concatenate(ids), np.concatenate(dists)


def retrieval_server(torch, args, dev, ops, corpus10) -> dict:
    """Phase 11: the retrieval server on phase 10's rows — a crash and
    its recovery, the threaded scheduler under load, the overload
    control plane and the serving CLI.  Returns the launches of rows 2,
    3 and 5 in the scheduled run."""
    import contextlib
    import io
    import shutil
    import tempfile
    import threading
    from repro_torch.core import LinearScan, searcher_cache_info
    from repro_torch.launch import serve
    from repro_torch.obs.prom import parse_exposition
    from repro_torch.serving import (CollectionRegistry, Scheduler,
                                     SchedulerConfig)

    sk, pay, qs, qp = corpus10
    n = len(sk)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_",
                                 dir=ROOT / "build"))
    try:
        # -- 1. the crash --------------------------------------------------
        for name, arr in (("sk", sk), ("pay", pay), ("qs", qs), ("qp", qp)):
            np.save(work / f"{name}.npy", arr)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--crash-child",
             str(work)], capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        child_s = time.perf_counter() - t0
        check(child.returncode == 0, f"crash child failed "
              f"({child.returncode}):\n{child.stderr[-4000:]}")
        cst = json.loads(child.stdout.strip().splitlines()[-1])
        print(f"(11) crash child: {n} rows through submit_insert in chunks "
              f"of {RS_CHUNK} and 1% through submit_delete in "
              f"{cst['ingest_s']:.1f} s (process {child_s:.1f} s); segments "
              f"{cst['segments']} + {cst['delta_rows']} delta rows; journal "
              f"{cst['wal_bytes']} B, snapshots {cst['snapshot_bytes']} B "
              f"({cst['segments_written']} segments written, "
              f"{cst['wal_truncations']} truncations); killed with os._exit",
              flush=True)
        want = dict(np.load(work / "answers.npz"))

        # -- 2. recovery on the card ---------------------------------------
        t0 = time.perf_counter()
        reg = CollectionRegistry.open(str(work / "data"), device="cuda")
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        coll = reg.get("docs")
        idx, store = coll.index, coll.store
        check(idx.device.type == "cuda", "recovered off the card")
        sst = store.stats()
        check(sst["replayed_records"] > 0, "recovery replayed no record")
        got = served_answers(torch, idx, qs, qp)
        check(got.keys() == want.keys(), "answer keys")
        for key in want:
            check(np.array_equal(got[key], want[key]),
                  f"recovered {key} differs from the crashed child's")
        check(bool(want["r_off_big"]) and int(want["overflow"]) == 0,
              "child's range plane not BIG off the ball / top-k overflow")
        print(f"(11) recovery: {recover_s:.2f} s on the card, "
              f"{sst['recovered_segments']} segments "
              f"{[s.n for s in idx.segments]}, {sst['replayed_records']} "
              f"journal records replayed ({len(idx._delta_ids)} delta "
              f"rows); journal {sst['wal_bytes']} B, snapshots "
              f"{sst['snapshot_bytes']} B; top-{TOPK} (tau*={got['tau']}), "
              f"range at tau={RS_TAU} ({len(got['r_ids'])} hits) and the "
              f"Jaccard re-rank equal the child's bit for bit", flush=True)

        # -- 3. serving: the threaded scheduler under 8 clients -----------
        live = np.ones(n, bool)
        live[seg10_dead(n)] = False
        live_t = torch.from_numpy(live).to(dev)
        scan = LinearScan.build(sk, REVIEW_B, device=dev)
        rng = np.random.default_rng(args.seed + 11)
        tq = sk[rng.choice(n, RS_TOPK_REQ, replace=False)]
        work_items = ([("topk", i) for i in range(RS_TOPK_REQ)]
                      + [("rerank", i) for i in range(RS_RERANK_REQ)]
                      + [("range", i) for i in range(RS_RANGE_REQ)])
        # every request may stand in the queue at once: this run
        # measures the served path, the overload step its limits
        sched = Scheduler(registry=reg, config=SchedulerConfig(
            max_batch=RS_MAX_BATCH, max_wait_ms=RS_MAX_WAIT_MS,
            max_queue=len(work_items)))
        t0 = time.perf_counter()
        warm = sched.warmup(ks=(TOPK,), taus=(RS_TAU,),
                            reranks=("jaccard",))
        warm_s = time.perf_counter() - t0
        traces0 = searcher_cache_info()["traces"]
        sched.metrics.rebaseline()
        sched.start()
        ops.reset_kernel_stats()                   # the served window
        order = rng.permutation(len(work_items))
        shares = [[work_items[j] for j in order[c::RS_CLIENTS]]
                  for c in range(RS_CLIENTS)]
        results, errs = {}, []

        def client(share):
            try:
                futs = []
                for kind, i in share:
                    if kind == "topk":
                        f = sched.submit_topk("docs", tq[i], TOPK)
                    elif kind == "rerank":
                        f = sched.submit_topk("docs", qs[i], TOPK,
                                              rerank="jaccard",
                                              q_payload=qp[i])
                    else:
                        f = sched.submit_search("docs", qs[i], RS_TAU)
                    futs.append(((kind, i), f))
                for key, f in futs:
                    results[key] = f.result(timeout=300)
            except Exception as e:                 # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(s,))
                   for s in shares]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        sched.stop()
        launches = ops.kernel_stats()
        check(not errs, f"a client's request failed: {errs[:1]}")
        check(len(results) == len(work_items), "responses missing")
        traces = searcher_cache_info()["traces"] - traces0
        snap = sched.stats()
        for name in ("hamming_distances", "sparse_verify_arena_packed",
                     "exact_rerank"):
            check(launches.get(name, 0) > 0,
                  f"{name} kernel not launched under the scheduler")
        check(not any(k.endswith(":ref") for k in launches),
              f"plain version ran under the scheduler: {launches}")
        check(traces == 0, f"{traces} program builds after warmup")

        w_ids, w_d = scan_topk(torch, scan, live_t, tq, TOPK)
        for i in range(RS_TOPK_REQ):
            r = results[("topk", i)]
            check(r.overflow == 0 and np.array_equal(r.ids, w_ids[i])
                  and np.array_equal(r.dists, w_d[i]),
                  f"scheduled top-{TOPK} request {i} != the scan kernel")
        d = torch.where(live_t[None, :], scan.distances(qs), BIG)
        for i in range(RS_RANGE_REQ):
            r = results[("range", i)]
            inside = (d[i] <= RS_TAU).cpu().numpy()
            check(np.array_equal(r.mask, inside) and np.array_equal(
                r.dist, np.where(inside, d[i].cpu().numpy(), BIG)),
                f"scheduled range request {i} != the scan kernel")
        for i in range(RS_RERANK_REQ):
            r = results[("rerank", i)]
            check_rerank_row(torch, d[i], r, qp[i], pay,
                             f"scheduled re-rank request {i}")
        del d
        lat, ex = snap["latency"], snap["exec_latency"]
        n_batches = sum(v for k, v in snap["counters"].items()
                        if k.startswith("batches_total:"))
        fams = sorted({s[0] for s in parse_exposition(
            sched.render_stats())["samples"]})
        n_req = len(work_items)
        print(f"(11) warmup: {warm['calls']} calls over {warm['buckets']} "
              f"buckets, {warm['traces']} program builds, {warm_s:.2f} s",
              flush=True)
        print(f"(11) served {n_req} requests from {RS_CLIENTS} client "
              f"threads in {serve_s:.3f} s ({n_req / serve_s:.0f} queries/s):"
              f" top-k p50 {lat['topk']['p50_ms']:.2f} ms, p99 "
              f"{lat['topk']['p99_ms']:.2f} ms; range p50 "
              f"{lat['search']['p50_ms']:.2f} ms, p99 "
              f"{lat['search']['p99_ms']:.2f} ms; batch fill "
              f"{snap['batch_fill_ratio']:.3f} over "
              f"{snap['counters'].get('batches_total:topk', 0)} top-k and "
              f"{snap['counters'].get('batches_total:search', 0)} range "
              f"batches; a batch's execution p50 {ex['topk']['p50_ms']:.2f}"
              f" ms (top-k), {ex['search']['p50_ms']:.2f} ms (range); "
              f"{snap['device_dispatch']['fused'] / n_batches:.2f} fused "
              f"dispatches a batch; launches {launches}; dispatches "
              f"{snap['device_dispatch']}; 0 builds after warmup",
              flush=True)
        print(f"(11) every scheduled answer exact: {RS_TOPK_REQ} top-{TOPK} "
              f"against the scan kernel and a stable sort, {RS_RANGE_REQ} "
              f"range planes, {RS_RERANK_REQ} Jaccard re-ranks against "
              f"numpy", flush=True)
        print(f"(11) render_stats families ({len(fams)}): {' '.join(fams)}",
              flush=True)

        # -- 4. overload ---------------------------------------------------
        ovl = overload_burst(torch, reg, idx, tq, qs, qp)

        # -- the next insert takes the next id ----------------------------
        n_ids = idx.n_ids
        new = idx.insert(sk[:1], payloads=pay[:1])
        check(int(new[0]) == n_ids == n, f"next id {new} after {n_ids}")
        reg.close()
        del idx, coll, reg, scan, store, sched
        torch.cuda.empty_cache()

        # -- 5. the CLI ----------------------------------------------------
        cli_dir = str(work / "cli")
        for argv in (["--ingest", "--data-dir", cli_dir,
                      "--rerank", "jaccard"],
                     ["--ingest", "--recover", "--data-dir", cli_dir],
                     ["--retrieval", "--arch", SERVE_ARCH]):
            argv = argv + ["--device", "cuda"]
            ops.reset_kernel_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            check(rc == 0, f"serve.main({argv}) returned {rc}")
            text = buf.getvalue()
            body, _, stats = text.partition("--- /stats ---")
            print(f"(11) python -m repro_torch.launch.serve "
                  f"{' '.join(argv)}: rc 0, {cli_s:.1f} s, launches "
                  f"{ops.kernel_stats()}", flush=True)
            for line in body.strip().splitlines():
                print(f"    {line}", flush=True)
            if stats:
                print(f"    --- /stats --- ({len(stats.splitlines())} "
                      "lines)", flush=True)
        return {"launches": {k: launches.get(k, 0) for k in (
            "hamming_distances", "sparse_verify_arena_packed",
            "exact_rerank")}, **ovl}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_rerank_row(torch, d_row, r, q_row, pay, what: str) -> None:
    """One re-ranked response against numpy: the survivors within the
    response's τ, float32 Jaccard, ordered by (score desc, id asc)."""
    cand = torch.nonzero(d_row <= r.tau).flatten().cpu().numpy()
    sc = jaccard_np(q_row, pay[cand])
    order = np.lexsort((cand, -sc))[:len(r.ids)]
    k = len(order)
    check(np.array_equal(r.ids[:k], cand[order])
          and np.array_equal(r.dists[:k], d_row.index_select(
              0, torch.from_numpy(cand[order]).to(d_row.device))
              .cpu().numpy())
          and np.array_equal(r.scores[:k].view(np.int32),
                             sc[order].view(np.int32))
          and (r.ids[k:] == -1).all(), f"{what} != numpy Jaccard")


def overload_burst(torch, reg, idx, tq, qs, qp) -> dict:
    """Phase 11 step 4: a burst of 4 × RS_OVL_QUEUE top-k and re-rank
    requests, in waves of RS_OVL_WAVE RS_OVL_GAP_S apart, at a scheduler
    with admission, the degradation ladder and the breaker on.  Every
    shed request is counted; every admitted answer equals an undegraded
    call at its effective (k, rerank) and its response's τ."""
    from repro_torch.serving import (AdmissionConfig, BreakerConfig,
                                     DegradePolicy, OverloadError,
                                     Scheduler, SchedulerConfig)

    pol = DegradePolicy()
    sched = Scheduler(registry=reg, config=SchedulerConfig(
        max_batch=RS_MAX_BATCH, max_wait_ms=RS_MAX_WAIT_MS,
        max_queue=RS_OVL_QUEUE, admission=AdmissionConfig(), degrade=pol,
        breaker=BreakerConfig())).start()
    submitted, admitted = 0, []
    t0 = time.perf_counter()
    for j in range(4 * RS_OVL_QUEUE):
        if j and j % RS_OVL_WAVE == 0:
            time.sleep(RS_OVL_GAP_S)     # waves: the queue stands for a
            #                              few CoDel intervals
        rerank = j % 4 == 3
        i = j % len(qs) if rerank else j % len(tq)
        try:
            if rerank:
                f = sched.submit_topk("docs", qs[i], TOPK, rerank="jaccard",
                                      q_payload=qp[i])
            else:
                f = sched.submit_topk("docs", tq[i], TOPK)
            admitted.append((rerank, i, f))
        except OverloadError:
            pass
        submitted += 1
    answers = [(rerank, i, f.result(timeout=300))
               for rerank, i, f in admitted]
    burst_s = time.perf_counter() - t0
    sched.stop()
    snap = sched.stats()
    rejected = snap["counters"].get("rejected_total", 0)
    check(rejected == submitted - len(admitted),
          f"rejected {rejected} != submitted {submitted} - admitted "
          f"{len(admitted)}")
    level_of = {None: 0, **{s: i + 1 for i, s in enumerate(pol.stages)}}
    groups = {}
    for rerank, i, r in answers:
        k, _, metric, stage = pol.apply_topk(
            level_of[r.degraded], TOPK, None, "jaccard" if rerank else None)
        check(stage == r.degraded and len(r.ids) == k,
              f"degraded label {r.degraded} inconsistent")
        groups.setdefault((k, r.tau, metric), []).append(
            (qs[i] if rerank else tq[i], qp[i] if rerank else None, r))
    for (k, tau, metric), rows in groups.items():
        for r0 in range(0, len(rows), RS_MAX_BATCH):
            part = rows[r0:r0 + RS_MAX_BATCH]
            q = np.stack([p[0] for p in part])
            extra = ({} if metric is None else dict(
                rerank=metric, q_payloads=np.stack([p[1] for p in part])))
            ref = idx.topk_batch(q, k, tau0=tau, **extra)
            check(ref.tau == tau, "undegraded run left the response's tau")
            for j, (_, _, r) in enumerate(part):
                ok = (np.array_equal(r.ids, ref.ids[j].cpu().numpy())
                      and np.array_equal(r.dists, ref.dists[j].cpu().numpy()))
                if metric is not None:
                    ok = ok and np.array_equal(
                        r.scores.view(np.int32),
                        ref.scores[j].view(torch.int32).cpu().numpy())
                check(ok, f"admitted answer (k={k}, tau={tau}, "
                          f"rerank={metric}) != the undegraded run")
    stages = {}
    for _, _, r in answers:
        stages[r.degraded] = stages.get(r.degraded, 0) + 1
    shed = {k.split(":", 1)[1]: v for k, v in snap["counters"].items()
            if k.startswith("shed_total:")}
    print(f"(11) overload: {submitted} submitted in a burst at max_queue "
          f"{RS_OVL_QUEUE}, {len(admitted)} admitted, {rejected} shed "
          f"{shed}; answers by stage {stages}; {burst_s:.2f} s; every "
          f"admitted answer equals the undegraded run at its effective "
          f"(k, rerank) and tau", flush=True)
    return {"overload": {"submitted": submitted,
                         "admitted": len(admitted), "shed": shed,
                         "stages": {str(k): v for k, v in stages.items()}}}


def close_pairs(a: np.ndarray, b: np.ndarray, tau: int, same: bool) -> int:
    """Pairs of rows (i of ``a``, j of ``b``; i < j when ``same``) within
    Hamming distance ``tau``, counted exactly on the host with numpy: a
    pair that differs in at most tau symbols agrees on one of tau + 1
    disjoint blocks (pigeonhole), so only the pairs that share a block's
    value are compared in full."""
    L = a.shape[1]
    edges = np.linspace(0, L, tau + 2).astype(int)
    cand = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        def key(x):
            k = np.zeros(len(x), np.int64)
            for c in range(lo, hi):
                k = k * 256 + x[:, c]
            return k
        ka, kb = key(a), key(b)
        order = np.argsort(kb, kind="stable")
        kbs = kb[order]
        left = np.searchsorted(kbs, ka, "left")
        counts = np.searchsorted(kbs, ka, "right") - left
        ii = np.repeat(np.arange(len(a), dtype=np.int64), counts)
        offs = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                   counts)
        jj = order[np.repeat(left, counts) + offs]
        cand.append(ii * len(b) + jj)
    cand = np.unique(np.concatenate(cand))
    ii, jj = cand // len(b), cand % len(b)
    if same:
        ii, jj = ii[ii < jj], jj[ii < jj]
    return int(((a[ii] != b[jj]).sum(axis=1) <= tau).sum())


def dedup_pipeline(torch, args, ops) -> None:
    """Phase 12 (a): the dedup pipeline at a trainer's scale on the card,
    every step's accepted rows checked on the host, the first steps held
    bit for bit against the CPU."""
    from repro_torch.core.hamming import hamming_pairwise_naive
    from repro_torch.core.sketch import sketch_tokens
    from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline

    cfg = DataConfig(seed=args.seed, **TRAIN_DATA)
    tau = cfg.dedup_tau
    pipe = SketchDedupPipeline(cfg, device="cuda")
    params = pipe._sketch_params
    # the host checker against the card's brute force on step 0's
    # candidates, where the injected near-duplicates make pairs within tau
    sk0 = pipe._sketch(pipe._candidates(0))
    d0 = hamming_pairwise_naive(sk0, sk0)
    brute = int(torch.triu((d0 <= tau).to(torch.uint8), diagonal=1).sum())
    got = close_pairs(sk0.cpu().numpy(), sk0.cpu().numpy(), tau, True)
    check(got == brute and brute > 0, f"host pair checker {got} != the "
                                      f"card's brute force {brute}")
    del sk0, d0
    print(f"dedup pipeline: {cfg.batch * cfg.oversample} candidates of "
          f"{cfg.seq} tokens a step, vocab {cfg.vocab}, L {cfg.dedup_L} b "
          f"{cfg.dedup_b} tau {tau}; host checker agrees with the card on "
          f"step 0's {brute} candidate pairs within tau", flush=True)

    first = []
    step_s = []
    tail_hits = 0
    ops.reset_kernel_stats()                       # the pipeline's window
    for step in range(TRAIN_DATA_STEPS):
        # the history bST holds the first _index_size accepted rows: it
        # is rebuilt when the history has doubled, and the rows accepted
        # since are not searched (ROADMAP F7)
        prev = pipe._history
        n_prev = 0 if prev is None else len(prev)
        indexed = None if prev is None else prev[:pipe._index_size]
        tail = None if prev is None else prev[pipe._index_size:]
        t0 = time.perf_counter()
        batch = pipe.batch_for_step(step)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        acc = pipe._history[n_prev:]
        toks = batch["tokens"]
        check(toks.shape == (cfg.batch, cfg.seq) and toks.dtype == torch.int32
              and toks.is_cuda and batch["targets"].shape == toks.shape,
              f"step {step}: batch {tuple(toks.shape)} {toks.dtype}")
        check(len(acc) == cfg.batch, f"step {step}: {len(acc)} accepted "
                                     f"rows for a batch of {cfg.batch}")
        sk = sketch_tokens(params, toks, L=cfg.dedup_L, b=cfg.dedup_b)
        check(np.array_equal(sk.cpu().numpy(), acc),
              f"step {step}: the batch is not the accepted documents")
        inside = close_pairs(acc, acc, tau, True)
        check(inside == 0, f"step {step}: {inside} accepted pairs within "
                           f"tau {tau}")
        if indexed is not None:
            hist = close_pairs(acc, indexed, tau, False)
            check(hist == 0, f"step {step}: {hist} accepted rows within tau "
                             "of the indexed history")
            if len(tail):
                tail_hits += close_pairs(acc, tail, tau, False)
        if step < TRAIN_DATA_CPU_STEPS:
            first.append((toks.cpu(), batch["targets"].cpu(),
                          dict(pipe.stats)))
    launches = ops.kernel_stats()
    check(launches.get("sparse_verify_batch", 0) == TRAIN_DATA_STEPS - 1
          and not any(k.endswith(":ref") for k in launches),
          f"history search launches {launches}: want the verify kernel once "
          "a step from step 1")
    n_cand = TRAIN_DATA_STEPS * cfg.batch * cfg.oversample
    total = sum(step_s)
    print(f"dedup pipeline: {TRAIN_DATA_STEPS} steps, {n_cand} candidates "
          f"in {total:.2f} s ({n_cand / total:.0f} candidates/s; a step "
          f"median {statistics.median(step_s) * 1e3:.1f} ms); stats "
          f"{pipe.stats}; history {len(pipe._history)} rows; "
          f"{pipe.rebuilds} history builds in {pipe.rebuild_seconds:.2f} s; "
          f"launches {launches}; every step's accepted rows pairwise > tau "
          "and > tau from the indexed history (host check); pairs within "
          f"tau of rows accepted since the last build (not searched, F7): "
          f"{tail_hits}", flush=True)
    t0 = time.perf_counter()
    cpu = SketchDedupPipeline(cfg, device="cpu", sketch_params=params)
    for step, (toks, targets, stats) in enumerate(first):
        b = cpu.batch_for_step(step)
        check(torch.equal(b["tokens"], toks)
              and torch.equal(b["targets"], targets) and cpu.stats == stats,
              f"step {step}: the card's batch differs from the CPU's")
    print(f"dedup pipeline: the first {len(first)} steps equal the CPU "
          f"pipeline's bit for bit ({time.perf_counter() - t0:.1f} s on the "
          "CPU)", flush=True)


def check_flash_bwd(torch, ops, ref, dev, gen, err) -> dict:
    """Phase 12 (b): the FA-2 backward kernel against its plain version
    over BWD_CASES in float32 and bfloat16 (each run twice: the same
    bits), the forward's lse against the plain lse; ptxas's report of
    every bf16 backward kernel (BWD_BF16_KERNELS) without a spill; then
    both passes timed at the D = 128 case and at smollm's train shape
    (bf16), each call beside its bound, the latter also beside the plain
    version and SDPA's backward.  Returns the two JSON rows' fields."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build

    for B, H, S, D, kw in BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((B, H, S, D), device=dev,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            _, lse_r = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            fin = torch.isfinite(lse_r)
            e_lse = float((lse - lse_r)[fin].abs().max())
            err["flash_attention_fwd_lse"] = max(
                err["flash_attention_fwd_lse"], e_lse)
            check(torch.equal(fin, torch.isfinite(lse)) and e_lse <= 1e-4,
                  f"lse {dtype} B={B} H={H} S={S} D={D} {kw}: max err {e_lse}")
            got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            # the bf16 kernels round P and dS to bf16 for their products:
            # their specification is the plain version with bf16 tiles
            bf = dtype == torch.bfloat16
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                               tile_bf16=bf, **kw)
            errs = []
            for a, b, w, name in zip(got, again, want, ("dq", "dk", "dv")):
                what = f"{name} {dtype} B={B} H={H} S={S} D={D} {kw}"
                check(torch.equal(a, b), f"{what}: two runs differ")
                e = float((a.float() - w.float()).abs().max())
                top = float(w.float().abs().max())
                err["flash_attention_bwd"] = max(err["flash_attention_bwd"],
                                                 e)
                if dtype == torch.float32:
                    ok = torch.allclose(a, w, rtol=BWD_F32_TOL,
                                        atol=BWD_F32_TOL)
                else:
                    ok = e <= BWD_BF16_RTOL * top
                check(ok and a.dtype == dtype and bool(torch.isfinite(a).all()),
                      f"{what}: max err {e} (largest {top})")
                errs.append(e)
            tiles = ""
            if bf:                           # beside the float32 tiles
                f32 = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
                tiles = ", from float32 tiles " + "/".join(
                    f"{float((a.float() - w.float()).abs().max()):.3g}"
                    for a, w in zip(got, f32))
                del f32
            print(f"flash_attention_bwd vs plain, {str(dtype)[6:]} B={B} "
                  f"H={H} S={S} D={D} {kw}: max err dq/dk/dv "
                  f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}{tiles}, lse "
                  f"{e_lse:.3g}, two runs bit-identical", flush=True)
            del q, k, v, do, out, lse, lse_r, got, again, want

    kern = bf16_bwd_ptxas(_build)
    check(set(kern) == BWD_BF16_KERNELS,
          f"ptxas report: bf16 backward kernels {sorted(kern)}, want "
          f"{sorted(BWD_BF16_KERNELS)}")
    spilled = {k: v for k, v in kern.items() if v[1] or v[2]}
    check(not spilled, f"ptxas spills in bf16 backward kernels: {spilled}")
    print(f"ptxas: the {len(kern)} bf16 backward kernels spill nothing "
          f"(registers {', '.join(f'{k} {v[0]}' for k, v in kern.items())})",
          flush=True)

    bf16 = torch.bfloat16
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def passes_ms(args_):
        def one_pass(passes):
            code = lib.flash_attention_bwd_launch(*args_, passes, stream)
            check(code == 0,
                  f"flash_attention_bwd_launch passes={passes}: {code}")
        return (time_ms(torch, lambda: one_pass(1)),
                time_ms(torch, lambda: one_pass(2)))

    # the windowed, capped D = 128 case of BWD_CASES beside its bound
    B, H, S, D, kw = BWD_CASES[2]
    q, k, v, do = (torch.randn((B, H, S, D), device=dev, generator=gen)
                   .to(bf16) for _ in range(4))
    out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, args_ = ops.flash_bwd_args(q, k, v, out, lse, do, scale=D ** -0.5,
                                  q_offset=0, tile_bf16=False, **kw)
    d128_dq, d128_dkdv = passes_ms(args_)
    d128_ms = time_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    pairs = B * H * sum(min(i + 1, kw["window"]) for i in range(S))
    d128_bound, d128_by = max_bound(10 * pairs * D,
                                    2 * 8 * B * H * S * D + 4 * B * H * S)
    print(f"flash_attention_bwd (B={B} H={H} S={S} D={D} bf16 {kw}): "
          f"{d128_ms:.4f} ms a call (dq pass {d128_dq:.4f} ms, dk/dv pass "
          f"{d128_dkdv:.4f} ms), bound {d128_bound:.4f} ms ({d128_by}), "
          f"{10 * pairs * D / d128_ms / 1e9:.1f} TFLOP/s", flush=True)
    del q, k, v, do, out, lse

    B, H, S, D = BWD_CASES[0][:4]
    q, k, v, do = (torch.randn((B, H, S, D), device=dev, generator=gen)
                   .to(bf16) for _ in range(4))
    out, lse = ops.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    _, args_ = ops.flash_bwd_args(q, k, v, out, lse, do, causal=True,
                                  window=0, cap=0.0, scale=D ** -0.5,
                                  q_offset=0, tile_bf16=False)
    dq_ms, dkdv_ms = passes_ms(args_)
    bwd_ms = time_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True))
    bwd_plain = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True), iters=3)
    lse_ms = time_ms(torch, lambda: ops.flash_attention_fwd(
        q, k, v, causal=True, return_lse=True))
    fwd_ms = time_ms(torch, lambda: ops.flash_attention_fwd(
        q, k, v, causal=True))
    lse_plain = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=True, return_lse=True), iters=3)
    qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    F.scaled_dot_product_attention(qq, kk, vv, is_causal=True).backward(do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    sdpa_err = [float((g.float() - w.float()).abs().max())
                for g, w in zip((qq.grad, kk.grad, vv.grad), want)]
    sdpa_fwd_ag = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True))
    sdpa_total = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True).backward(do))
    sdpa_bwd = sdpa_total - sdpa_fwd_ag
    # the same two, 20 calls queued back to back: the device's time with
    # the host's share of a call hidden (the step queues its calls)
    bwd_queued = queued_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True))
    sdpa_bwd_queued = queued_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True).backward(do)) - queued_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True))
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    pairs = B * H * (S * (S + 1) // 2)
    elems = B * H * S * D
    # backward: s recomputed, dp, dq, dk, dv (5 products of the visible
    # pairs); q, k, v, out, dout read, dq, dk, dv written, lse read
    bwd_bound, bwd_by = max_bound(10 * pairs * D, 2 * 8 * elems + 4 * B * H * S)
    lse_bound, lse_by = max_bound(4 * pairs * D, 2 * 4 * elems + 4 * B * H * S)
    print(f"flash_attention_bwd (B={B} H={H} S={S} D={D} bf16 causal): "
          f"{bwd_ms:.3f} ms a call (dq pass {dq_ms:.3f} ms, dk/dv pass "
          f"{dkdv_ms:.3f} ms), bound {bwd_bound:.4f} ms ({bwd_by}), "
          f"{10 * pairs * D / bwd_ms / 1e9:.1f} TFLOP/s; plain "
          f"{bwd_plain:.3f} ms; scaled_dot_product_attention backward "
          f"{sdpa_bwd:.3f} ms ({sdpa_total:.3f} forward under autograd and "
          f"backward, {sdpa_fwd_ag:.3f} the forward; its dq/dk/dv "
          f"{'/'.join(f'{e:.3g}' for e in sdpa_err)} from the plain "
          f"version); queued: {bwd_queued:.4f} ms a call "
          f"({10 * pairs * D / bwd_queued / 1e9:.1f} TFLOP/s), SDPA's "
          f"backward {sdpa_bwd_queued:.4f} ms", flush=True)
    print(f"flash_attention_fwd with lse (same shape): {lse_ms:.4f} ms, "
          f"without {fwd_ms:.4f} ms (the serving launch), bound "
          f"{lse_bound:.4f} ms ({lse_by}); plain {lse_plain:.3f} ms; "
          f"scaled_dot_product_attention {sdpa_fwd:.4f} ms", flush=True)
    del q, k, v, do, out, lse, qq, kk, vv, want
    torch.cuda.empty_cache()
    return {"bwd": {"ms": bwd_ms, "dq_ms": dq_ms, "dkdv_ms": dkdv_ms,
                    "plain_ms": bwd_plain, "bound_ms": bwd_bound,
                    "bound_by": bwd_by, "library_ms": sdpa_bwd,
                    "queued_ms": bwd_queued,
                    "library_queued_ms": sdpa_bwd_queued,
                    "d128": {"ms": d128_ms, "dq_ms": d128_dq,
                             "dkdv_ms": d128_dkdv, "bound_ms": d128_bound,
                             "bound_by": d128_by},
                    "ptxas": {k: list(v) for k, v in kern.items()}},
            "lse": {"ms": lse_ms, "serving_ms": fwd_ms, "plain_ms": lse_plain,
                    "bound_ms": lse_bound, "bound_by": lse_by,
                    "library_ms": sdpa_fwd}}


# the bf16 backward kernels by head dim: the wgmma kernels at every D (D 80
# and 16 with a 16-column tail under the 32-byte swizzle)
BWD_BF16_KERNELS = {f"flash_bwd_{p}_wg_kernel<{d}>"
                    for p in ("dq", "dkdv") for d in (16, 64, 80, 128)}


def bf16_bwd_ptxas(_build) -> dict:
    """ptxas's (registers, spill store bytes, spill load bytes) of each
    bf16 backward kernel in the last build's report, by a short name."""
    import re
    out = {}
    for name, v in _build.ptxas_kernels(_build.BUILD_INFO["report"]).items():
        m = re.search(r"(flash_bwd_(?:dq|dkdv)_wg_kernel)ILi(\d+)E",
                      name)
        if m:
            out[f"{m.group(1)}<{m.group(2)}>"] = v
    return out


# the bf16 forward kernel's instances: the wgmma kernel at every D, without
# and with the lse (D 80 and 16 with a 16-column tail under the 32-byte
# swizzle)
FWD_BF16_KERNELS = {f"flash_fwd_wg_kernel<{d}, {lse}>"
                    for d in (16, 64, 80, 128) for lse in (0, 1)}


def bf16_fwd_ptxas(_build) -> dict:
    """ptxas's (registers, spill store bytes, spill load bytes) of each
    bf16 forward instance in the last build's report, by a short name."""
    import re
    out = {}
    for name, v in _build.ptxas_kernels(_build.BUILD_INFO["report"]).items():
        m = re.search(r"(flash_fwd_wg_kernel)ILi(\d+)ELb([01])E", name)
        if m:
            out[f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"] = v
    return out


def check_fwd_ptxas(_build) -> dict:
    """Phase 2: every bf16 forward instance (FWD_BF16_KERNELS) in ptxas's
    report, none with a spill.  Returns them for row 6's JSON line."""
    kern = bf16_fwd_ptxas(_build)
    check(set(kern) == FWD_BF16_KERNELS,
          f"ptxas report: bf16 forward kernels {sorted(kern)}, want "
          f"{sorted(FWD_BF16_KERNELS)}")
    spilled = {k: v for k, v in kern.items() if v[1] or v[2]}
    check(not spilled, f"ptxas spills in bf16 forward kernels: {spilled}")
    print(f"ptxas: the {len(kern)} bf16 forward kernels spill nothing "
          f"(registers {', '.join(f'{k} {v[0]}' for k, v in kern.items())})",
          flush=True)
    return {k: list(v) for k, v in sorted(kern.items())}


def max_bound(flops: float, nbytes: float):
    """(bound_ms, bound_by) of a bf16 tensor-core computation: the larger
    of its FLOPs over the bf16 peak and its bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def train_smollm(torch, args, ops) -> dict:
    """Phase 12 (c): smollm-135m trained at full size through
    ``launch.train.main`` with --dedup batches and checkpoints; one
    kernel-path step against the plain path; step
    time, tokens/s, peak memory and a profiled step.  Returns the
    launches of the training run."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.layers import Params
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = get_config(TRAIN_ARCH)
    n_layers = cfg.num_layers
    tokens = TRAIN_BATCH * TRAIN_SEQ
    argv = ["--arch", TRAIN_ARCH, "--dedup", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
            "--seed", str(args.seed)]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_",
                                 dir=ROOT / "build"))

    def recorder(store):
        def on_step(step, metrics):
            store[step] = (float(metrics["loss"]),
                           float(metrics["grad_norm"]), time.perf_counter())
        return on_step

    try:
        full = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        ops.reset_kernel_stats()                   # the main path's window
        t0 = time.perf_counter()
        rc = train.main(argv + ["--ckpt-dir", str(work / "full")],
                        on_step=recorder(full))
        run_s = time.perf_counter() - t0
        launches = ops.kernel_stats()
        peak = torch.cuda.max_memory_allocated() - base_mem
        check(rc == 0 and sorted(full) == list(range(TRAIN_STEPS)),
              f"launch.train returned {rc} after steps {sorted(full)}")
        fwd_per = 2 * n_layers                     # + the recompute (remat)
        check(launches.get("flash_attention_fwd") == fwd_per * TRAIN_STEPS
              and launches.get("flash_attention_fwd:lse")
              == fwd_per * TRAIN_STEPS
              and launches.get("flash_attention_fwd:bf16")
              == fwd_per * TRAIN_STEPS
              and launches.get("flash_attention_bwd") == n_layers * TRAIN_STEPS
              and launches.get("flash_attention_bwd:bf16")
              == n_layers * TRAIN_STEPS
              and launches.get("sparse_verify_batch", 0) > 0
              and not any(k.endswith(":ref") for k in launches),
              f"training launches {launches}: want {fwd_per} bf16 forwards "
              f"with lse and {n_layers} backwards a step, the history "
              "search's verify kernel, no plain version")
        losses = [full[s][0] for s in range(TRAIN_STEPS)]
        check(all(np.isfinite(losses)), f"losses {losses}")
        args.phase12_steps = dict(full)            # phase 16 (b)'s reference
        stamps = [t0] + [full[s][2] for s in range(TRAIN_STEPS)]
        loop_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        step_ms = statistics.median(loop_ms[TRAIN_WARMUP:])
        print(f"train {TRAIN_ARCH} (--dedup, {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"tokens, f32 masters, bf16 compute, remat): {TRAIN_STEPS} "
              f"steps in {run_s:.1f} s; losses "
              f"{[round(x, 4) for x in losses]}; grad norms "
              f"{[round(full[s][1], 3) for s in range(TRAIN_STEPS)]}",
              flush=True)
        print(f"train loop: a step {step_ms:.1f} ms median after "
              f"{TRAIN_WARMUP} (data, step and checkpoint copies; "
              f"{[round(x, 1) for x in loop_ms]}), {tokens / step_ms * 1e3:.0f}"
              f" tokens/s; peak memory {peak / 2**30:.2f} GiB; launches "
              f"{launches}: {launches['flash_attention_fwd'] // TRAIN_STEPS} "
              f"flash forwards ({n_layers} + {n_layers} recomputed) and "
              f"{launches['flash_attention_bwd'] // TRAIN_STEPS} backwards a "
              f"step, {launches.get('sparse_verify_batch', 0)} history "
              "searches (row 1)", flush=True)

        # the step alone, its launches and a profile; the kernel path
        # against the plain path from the same parameters and batch
        hyper = Hyper(warmup_steps=2, total_steps=TRAIN_STEPS)
        p0 = M.init_params(torch.Generator().manual_seed(args.seed), cfg,
                           device="cuda")
        batch = SketchDedupPipeline(DataConfig(
            vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            seed=args.seed, dedup=True), device="cuda").batch_for_step(0)

        def clone(p):
            def copy(t):
                if isinstance(t, dict):
                    return {k: copy(v) for k, v in t.items()}
                if isinstance(t, list):
                    return [copy(u) for u in t]
                return t.clone()
            return Params(copy(p.tree()))

        metrics = {}
        for impl in ("ref", "flash"):
            step = make_train_step(dataclasses.replace(cfg, attn_impl=impl),
                                   hyper)
            p = clone(p0)
            _, _, m = step(p, adamw_init(p), batch)
            metrics[impl] = (float(m["loss"]), float(m["grad_norm"]))
            del p
        (l_ref, g_ref), (l_k, g_k) = metrics["ref"], metrics["flash"]
        check(abs(l_k - l_ref) <= TRAIN_LOSS_RTOL * abs(l_ref)
              and abs(g_k - g_ref) <= TRAIN_GNORM_RTOL * abs(g_ref),
              f"kernel path loss {l_k} gnorm {g_k} vs ref path {l_ref} "
              f"{g_ref}")
        print(f"one step, kernel path vs attn_impl='ref': loss {l_k:.6f} vs "
              f"{l_ref:.6f} (|diff| {abs(l_k - l_ref):.3g}, limit "
              f"{TRAIN_LOSS_RTOL} relative), grad norm {g_k:.5f} vs "
              f"{g_ref:.5f} (|diff| {abs(g_k - g_ref):.3g}, limit "
              f"{TRAIN_GNORM_RTOL} relative)", flush=True)
        step = make_train_step(cfg, hyper)
        opt = adamw_init(p0)
        step(p0, opt, batch)
        torch.cuda.synchronize()
        ops.reset_kernel_stats()
        step(p0, opt, batch)
        per_step = ops.kernel_stats()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            step(p0, opt, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        print(f"train step alone (no data): {statistics.median(times):.1f} "
              f"ms median of 3 {[round(x, 1) for x in times]}, "
              f"{tokens / statistics.median(times) * 1e3:.0f} tokens/s; "
              f"launches a step {per_step}", flush=True)
        profile_window(torch, "train step", lambda: step(p0, opt, batch),
                       calls=1)
        del p0, opt, batch, step
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def record_routes(fn, limit=None):
    """Run ``fn`` with every MoE routing recorded (the first ``limit``
    when given): the (1, T, k) expert indices of each layer, in order."""
    from repro_torch.models import moe
    routes, route = [], moe._route

    def recording(router_w, x, top_k):
        gates, idx = route(router_w, x, top_k)
        if limit is None or len(routes) < limit:
            routes.append(idx)
        return gates, idx

    moe._route = recording
    try:
        out = fn()
    finally:
        moe._route = route
    return out, routes


def moe_routing(torch, cfg, arch: str, r_k, r_r, r_32=None) -> str:
    """The (token, slot) routings that differ between the kernel path's
    per-layer expert indices ``r_k`` and the plain path's ``r_r`` (in all
    and layer by layer), and from the f32 plain path's ``r_32`` where
    given; the pairs the kernel path's capacity plan drops."""
    from repro_torch.models.moe import _capacity_plan
    E, k = cfg.n_experts, cfg.top_k
    runs = [r for r in (r_k, r_r, r_32) if r is not None]
    check(all(len(r) == cfg.num_layers for r in runs), f"{arch}: "
          f"{[len(r) for r in runs]} routings recorded, want {cfg.num_layers}"
          " a path")
    per = [routing_differences(torch, [a], [b], E) for a, b in zip(r_k, r_r)]
    differ = sum(per)
    dropped = sum(int((~_capacity_plan(a, E, cfg.capacity_factor)[0]).sum())
                  for a in r_k)
    pairs = len(r_k) * r_k[0].shape[-2] * k
    line = (f"MoE routing: {differ} of {pairs} (token, slot) routings differ "
            f"between the kernel and plain paths ({differ / pairs:.4%}; by "
            f"layer {per})")
    if r_32 is not None:
        line += (f", {routing_differences(torch, r_k, r_32, E)} and "
                 f"{routing_differences(torch, r_r, r_32, E)} of each from "
                 "the f32 plain path")
    return (line + f"; {dropped} pairs dropped a prefill ({dropped / pairs:.4%})"
            f" at capacity factor {cfg.capacity_factor}")


def check_family_flash(torch, dev, cfg, arch: str, seed: int, err: dict,
                       B: int = SERVE_BATCH, S: int = SERVE_PROMPT) -> None:
    """The flash wrapper the model calls (``models/flash.py``) at the
    family's prefill shape, B x S (phase 7's requests by default) with its
    heads, kv heads and head dim, causal, at each window its layers use
    and its cap, on random bf16 tensors, against the port's plain
    ``blockwise_attention``: allclose at 2e-2 and row by row
    (FLASH_BF16_ROW_RTOL), as phase 7a holds smollm's GQA path."""
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import blockwise_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    windows = ({0} if cfg.ssm else
               {cfg.window if k == "local" else 0 for k in cfg.attn_kinds})
    for window in sorted(windows):
        q = torch.randn((B, S, H, D), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        kw = dict(causal=cfg.causal, window=window, cap=cfg.softcap_attn)
        got = flash_attention(q, k, v, **kw)
        want = blockwise_attention(q, k, v, **kw)
        e = float((got.float() - want.float()).abs().max())
        r = row_rel_err(got, want)
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        what = (f"{arch}: models/flash.py at B {B}, S {S}, heads {H}/{Hkv} x "
                f"{D}, {kw}")
        print(f"{what} against blockwise_attention: max err {e:.4g}, row "
              f"error {r:.4g} (limits 2e-2, {FLASH_BF16_ROW_RTOL})",
              flush=True)
        check(got.shape == q.shape and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), rtol=2e-2,
                                 atol=2e-2), f"{what}: max err {e}")
        check(r <= FLASH_BF16_ROW_RTOL, f"{what}: row error {r:.4g}")
        del q, k, v, got, want


def serve_family(torch, args, dev, ops, arch: str, err: dict) -> int:
    """Phase 13, one model: SERVE_BATCH requests of SERVE_PROMPT tokens and
    SERVE_GEN greedy ones through ``launch.serve.generate`` with the flash
    launches counted; the flash wrapper against its plain version at the
    family's attention shape; the kernel path's prefill against the plain
    path;
    for MoE, the routings in which the two paths differ and the dropped
    (token, slot) pairs; prefill-then-decode against the full forward;
    prefill and decode times and the peak memory.  Returns the flash
    launches of one prefill."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.train.steps import cast_for_compute, make_decode_step

    cfg = get_config(arch)
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    s_max = S + G
    bf16, f32 = torch.bfloat16, torch.float32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = M.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device="cuda")
    rng = np.random.default_rng(args.seed + 13)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                               .astype(np.int32)).to(dev)
    n_params = sum(p.numel() for p in params.parameters())
    n_attn = M.n_attention_layers(cfg)
    print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"attention layers a prefill {n_attn} (heads {cfg.n_heads}/"
          f"{cfg.n_kv} x {cfg.head_dim}), experts {cfg.n_experts} top-"
          f"{cfg.top_k} shared {cfg.n_shared}, ssm {cfg.ssm}, vocab "
          f"{cfg.vocab}: {n_params} parameters ({cfg.param_dtype}); "
          f"{B} requests x {S} prompt tokens + {G} greedy", flush=True)

    ops.reset_kernel_stats()                       # the main path's window
    t0 = time.perf_counter()
    tokens, logits = generate(params, cfg, prompts, G, s_max=s_max,
                              compute_dtype=bf16)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    print(f"serving path: {serve_s:.2f} s (first call), launches "
          f"{launches}", flush=True)
    want = ({"flash_attention_fwd": n_attn,
             "flash_attention_fwd:bf16": n_attn} if n_attn else {})
    check(launches == want, f"{arch}: launches per prefill {launches}, want "
          f"{want} (every attention layer through the bf16 kernel)")
    check(tokens.shape == (B, G) and bool(((tokens >= 0)
                                           & (tokens < cfg.vocab)).all()),
          f"{arch}: generated tokens {tuple(tokens.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: logits not finite")
    if n_attn:
        check_family_flash(torch, dev, cfg, arch, args.seed + 130, err)

    # the kernel path against the plain path (phase 7's second rule)
    params_c = cast_for_compute(params, bf16)
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    (lk, _, _), r_k = record_routes(lambda: M.prefill(
        params_c, cfg, {"tokens": prompts}, s_max=s_max))
    ops.reset_kernel_stats()
    (lr, _, _), r_r = record_routes(lambda: M.prefill(
        params_c, ref_cfg, {"tokens": prompts}, s_max=s_max))
    check(ops.kernel_stats() == {}, f"{arch}: the ref path launched "
          f"{ops.kernel_stats()}")
    l32 = M.prefill(params, ref_cfg, {"tokens": prompts},
                    s_max=s_max)[0]
    tol = LOGIT_RTOL * float(lr.abs().max())
    to32_k = float((lk - l32).abs().max())
    to32_r = float((lr - l32).abs().max())
    print(f"prefill logits: max|logit| {float(lr.abs().max()):.3f}; max "
          f"|diff| to the f32 plain path: kernel path {to32_k:.4f}, bf16 "
          f"plain path {to32_r:.4f} (rule: <= max({tol:.4f}, 1.5 x "
          f"{to32_r:.4f})); kernel vs plain path "
          f"{float((lk - lr).abs().max()):.4f}", flush=True)
    check(to32_k <= max(tol, 1.5 * to32_r),
          f"{arch}: the kernel path is farther from the f32 plain path "
          "than bf16 compute explains")
    if not n_attn:                          # no attention: the same ops
        check(torch.equal(lk, lr), f"{arch}: with no attention layer the "
              "kernel and plain paths differ")
    same = torch.argmax(lk, -1) == torch.argmax(lr, -1)
    print(f"greedy first tokens equal on the two paths: {int(same.sum())}/"
          f"{B}", flush=True)
    if cfg.n_experts:
        print(moe_routing(torch, cfg, arch, r_k, r_r), flush=True)
    del lr, l32, r_k, r_r

    # prefill-then-decode against the full forward, f32 compute, request 0
    one = prompts[:1]
    ccfg = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k) if cfg.n_experts else cfg)
    _, cache, n1 = M.prefill(params, ccfg, {"tokens": one[:, :-1]},
                             s_max=S + 1, cache_dtype=f32)
    dec_logits, _ = M.decode_step(params, ccfg, one[:, -1:], cache, n1)
    with torch.no_grad():
        full = M.forward(params, ccfg, {"tokens": one})[:, -1]
    diff = (dec_logits - full).abs()
    lim = FAMILY_CONSISTENCY_TOL * (1 + full.abs())
    lossless = (f", capacity factor {ccfg.capacity_factor}"
                if cfg.n_experts else "")
    print(f"prefill {S - 1} + decode 1 vs the full forward (f32{lossless})"
          f": max |diff| "
          f"{float(diff.max()):.3g}, max |logit| {float(full.abs().max()):.3f}"
          f", worst diff / (2e-2 + 2e-2 |logit|) "
          f"{float((diff / lim).max()):.3f}", flush=True)
    check(bool((diff <= lim).all()), f"{arch}: prefill-then-decode differs "
          "from the full forward by more than 2e-2 + 2e-2 |logit|")
    del cache, dec_logits, full

    # times
    dec = make_decode_step(cfg, compute_dtype=bf16)

    def prefill_once():
        return M.prefill(params_c, cfg, {"tokens": prompts}, s_max=s_max)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times)
    _, cache, n = prefill_once()
    tok = tokens[:, :1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(G - 1):
        lg, cache = dec(params_c, tok, cache, n + i)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (G - 1)
    del cache
    peak = torch.cuda.max_memory_allocated() - base_mem
    print(f"prefill ({B} x {S} tokens): {prefill_ms:.2f} ms median of 3 "
          f"({sorted(round(x, 2) for x in times)}), "
          f"{B * S / prefill_ms * 1e3:.0f} prompt tokens/s; decode "
          f"{decode_ms:.3f} ms per step (batch {B}, {G - 1} steps); peak "
          f"{peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} GiB held "
          f"before it", flush=True)
    profile_window(torch, f"{arch} prefill", prefill_once, calls=1)
    del params, params_c, tokens, logits, lk
    torch.cuda.empty_cache()
    return n_attn


def model_families(torch, args, dev, ops, err: dict) -> dict:
    """Phase 13: the MoE, SSM and hybrid families served on the card.
    Returns each model's flash launches a prefill."""
    out = {}
    for arch in FAMILIES:
        t0 = time.perf_counter()
        out[arch] = serve_family(torch, args, dev, ops, arch, err)
        print(f"({arch}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def tools_on_card() -> None:
    """Phase 14: the port's tools, each in a process of its own on the
    card (``--device`` left at its default, cuda): each must return 0."""
    import concurrent.futures

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")

    def run(tool):
        script, argv = tool
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / script), *argv],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=TOOL_TIMEOUT_S)
        return tool, proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(TOOLS_TOGETHER) as pool:
        together = list(pool.map(run, TOOLS[:TOOLS_TOGETHER]))
    for i, ((script, argv), proc, secs) in enumerate(
            together + [run(t) for t in TOOLS[TOOLS_TOGETHER:]]):
        tail = proc.stdout.strip().splitlines()[-6:]
        print(f"{script} {' '.join(argv)}: rc {proc.returncode} in "
              f"{secs:.1f} s{' (started together)' * (i < TOOLS_TOGETHER)}",
              flush=True)
        for line in tail:
            print(f"  {line}", flush=True)
        check(proc.returncode == 0, f"{script} returned {proc.returncode}: "
              f"{proc.stderr.strip()[-2000:]}")


# Phase 15, the mesh layer (launch/mesh.py, distributed/sharding.py,
# models/io.py, models/moe_sharded.py, models/decode_sp.py, the
# tensor-parallel regions of models/model.py) on torch.distributed
# process groups, each rank a process of its own that the script starts
# (``chip_smoke.py --mesh-child``), with PYTHONHASHSEED fixed so that every
# rank draws the same ``synthetic_batch`` (ROADMAP F10).  The requests
# are phase 7's: 8 prompts of 2,000 tokens (``synthetic_batch``, step 0)
# and 48 greedy tokens, bf16 parameters drawn from --seed: yi-9b's 8.8 B
# weights are 17.6 GB in bf16, where f32 masters beside a bf16 copy
# would take ≈ 53 GB, and (b)'s two ranks each hold a copy on the one
# card.  (a) one rank, nccl, mesh (1, 1) over ("data", "model"):
# granite-moe-3b-a800m (its MoE blocks through moe_apply_sharded) and
# yi-9b (its decode through decode_attention_seq_sharded) at full width
# and depth, against the same model with no mesh: the kept (token, slot)
# masks those of one rank's plan on the same routings, the prefill
# logits within phase 7's second rule against an f32 plain path, the
# greedy tokens equal wherever the no-mesh path's top-2 margin exceeds
# LOGIT_RTOL of its largest logit (48 steps, the no-mesh path fed the
# mesh path's tokens), the flash launches of a prefill 32 and 48.
# mamba2-1.3b and zamba2-2.7b (the SSM heads and the gated norm, zamba2's
# shared attention block) join them at full width and depth over the
# prefill and MESH_B_STEPS - 1 decode steps only (a cut: (b) holds no
# more), their no-mesh conv and SSM states of units 0 and -1 saved after
# the prefill.
# (b) two ranks sharing the card (gloo, which NCCL's one-rank-a-card rule
# leaves), mesh (1, 2), the dense layers tensor parallel over "model":
# granite's 12 of 24 heads, 4 of 8 KV heads and 20 of 40 experts (its
# 49,155-row vocabulary whole), yi-9b's 16 of 32 heads, 2 of 4 KV heads,
# 5,504 of 11,008 ffn, 32,000 of 64,000 vocabulary rows and 1,024 of
# 2,048 cache slots a rank, mamba2's 32 of 64 SSM heads (the gated norm's
# squares summed over "model") and 25,140 of 50,280 vocabulary rows,
# zamba2's 40 of 80 SSM heads and its shared block's 16 of 32 heads (D
# 80) and KV heads (each rank's parameter bytes printed and checked
# against the leaves the placement halves and those it keeps whole,
# yi-9b's at half of (a)'s within 1%, the peak a rank once the whole
# parameters are dropped), (a)'s tokens fed, (a)'s rules against (a)'s
# no-mesh run over the prefill and MESH_B_STEPS - 1 decode steps; the
# new K/V on the owner rank only at every decode step of a sequence-split
# cache, at its slot on every rank of a head-split one; the SSM models'
# conv and SSM states after the prefill on each rank against (a)'s on
# the rank's heads and channels; the collectives' bytes and seconds of a
# prefill and a decode step.  (c) data parallelism over two ranks on the card: granite's
# prefill at two data ranks (capacity 1.25, one MoE group over both
# ranks' rows) keeps one rank's (token, slot) mask and meets (a)'s rules
# on its logits.  Then the serve CLI at phase 7's requests: one rank in
# this process, and python -m torch.distributed.run --nproc-per-node 2
# over launch.serve --model-ranks 2 (mesh (1, 2), the dense layers
# tensor parallel, smollm's 9 heads whole): each rank's greedy tokens
# one rank's, its prefill's and last step's logits within LOGIT_RTOL of
# the largest of one rank's.
MESH_MOE, MESH_SEQ = "granite-moe-3b-a800m", "yi-9b"
MESH_SSM = ("mamba2-1.3b", "zamba2-2.7b")
MESH_ARCHS = [MESH_MOE, MESH_SEQ, *MESH_SSM]
# (b)'s prompts of an arch where not all SERVE_BATCH: yi-9b's tensor-
# parallel prefill sums 131 MB over "model" twice a layer through gloo's
# host staging (≈ 0.6 GB/s), so its prompts are cut to 2 rows; mamba2's
# and zamba2's sum 66 / 82 MB once a block (48 / 54 blocks, zamba2's
# shared block twice more 9 times) and are cut alike
MESH_B_ROWS = {MESH_SEQ: 2, MESH_SSM[0]: 2, MESH_SSM[1]: 2}
# (b)'s steps (the prefill and MESH_B_STEPS - 1 teacher-forced decode
# steps, of (a)'s SERVE_GEN): each tensor-parallel decode step sums over
# "model" two or three times a layer through gloo (0.2–0.9 s a step), so
# (b) is cut to 4 of (a)'s 48, which makes room for phase 18
MESH_B_STEPS = 4
MESH_HASH_SEED = "0"
MESH_TIMEOUT_S = 480          # a part's ranks, build-free (phase 1 built)
MESH_GROUP_TIMEOUT_S = 180    # a collective that waits longer fails
MESH_OWNER_LAYERS = (0, -1)   # units whose KV writes are checked a step
# (b)'s SSM states after the prefill (conv windows and the scan's state of
# every SSM layer of units MESH_OWNER_LAYERS) on the rank's heads and
# channels, under phase 7's second rule in norms: each tensor's distance
# to (a)'s f32 plain path's (f32 parameters, compute and caches), over
# the f32 tensor's norm, within 1.5 x (a)'s no-mesh bf16 tensor's, or
# within MESH_STATE_RTOL.  In bf16 compute each rank's out_proj partial
# product is rounded to bf16 before the sum over "model" (the whole
# product once), so the residual stream entering a layer differs by a
# rounding a block, and both bf16 paths drift from the f32 one as deep
# into the stack as unit -1 (47 mamba2 blocks, 53 zamba2 ones).  A bound
# on single elements did not hold that drift on an H100: mamba2's last
# conv_x window came 0.168 from the no-mesh bf16 one at a largest 4.16
# (1.29 x 2^-5 of it), and the elementwise second rule (1.5 x the no-mesh
# path's largest distance to the f32 states) reached 0.80 of its limit
# on rank 0 and failed on rank 1: the largest error of 0.5 M elements
# is a tail statistic two bf16 paths do not share.  Norms average it; a
# rank holding another rank's heads, or a norm summed over too few
# ranks, is O(1) away from the f32 states in norm too.  The elementwise
# distances are printed.
MESH_STATE_RTOL = 2 ** -5
# (c)'s serve CLI: phase 7's requests, one rank and then two model ranks
SERVE_CLI_ARGV = ["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
                  "--prompt-len", str(SERVE_PROMPT), "--gen-len",
                  str(SERVE_GEN)]
SERVE_CLI_RANKS = 2


def mesh_env() -> dict:
    env = dict(os.environ, PYTHONHASHSEED=MESH_HASH_SEED)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return env


def mesh_spawn(torch, args, part: str, world: int, work: Path) -> list:
    """Phase 15 part ``part`` in ``world`` ranks, each a process of its
    own; rank 0's output is printed.  Fails on any rank's nonzero exit or
    on MESH_TIMEOUT_S (every rank killed).  Returns the ranks' results."""
    procs, logs = [], []
    for r in range(world):
        spec = json.dumps({"part": part, "rank": r, "world": world,
                           "dir": str(work), "seed": args.seed})
        logs.append(open(work / f"{part}{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-child",
             spec], cwd=ROOT, env=mesh_env(), stdout=logs[-1],
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for line in (work / f"{part}0.log").read_text().splitlines():
        print(f"  {line}", flush=True)
    failed = [f"rank {r} exited {p.returncode}:\n"
              f"{(work / f'{part}{r}.log').read_text()[-4000:]}"
              for r, p in enumerate(procs) if p.returncode != 0]
    check(not failed, f"phase 15 ({part}) " + "\n".join(failed))
    return [torch.load(work / f"{part}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def mesh_child(spec: dict) -> int:
    """A rank of phase 15: starts the process group (file rendezvous
    under the part's directory), runs its part and saves the result."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    work, part = Path(spec["dir"]), spec["part"]
    init_distributed("cuda", init_method=f"file://{work}/group_{part}",
                     rank=spec["rank"], world_size=spec["world"],
                     timeout_s=MESH_GROUP_TIMEOUT_S)
    try:
        out = {"a": mesh_part_a, "b": mesh_part_b,
               "ep": mesh_part_ep}[part](torch, spec, work)
    finally:
        dist.destroy_process_group()
    torch.save(out, work / f"{part}_rank{spec['rank']}.pt")
    return 0


def mesh_model(torch, arch: str, seed: int):
    """(cfg with bf16 parameters, parameters on the card, prompts) of
    phase 15: the prompts are ``synthetic_batch``'s step 0."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models.io import synthetic_batch

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg, device="cuda")
    prompts = synthetic_batch(cfg, SERVE_BATCH, SERVE_PROMPT, 0,
                              with_targets=False)["tokens"]
    return cfg, params, prompts


def batch_digest(torch, prompts) -> int:
    """A 62-bit digest of the prompts (the same on every rank that drew
    the same batch)."""
    w = torch.arange(1, prompts.numel() + 1, device=prompts.device,
                     dtype=torch.int64)
    return int((prompts.reshape(-1).to(torch.int64) * w % 1_000_000_007
                * 7919).sum() % (1 << 62))


def recorded_plans(fn):
    """Run ``fn`` with every MoE capacity plan recorded: the sharded path's
    (routings (t, k), kept (t·k,), first expert, experts) and the
    data-parallel path's (routings (1, t, k), kept (1, t, k))."""
    from repro_torch.models import moe, moe_sharded
    plans, local, plan = [], moe_sharded._local_plan, moe._capacity_plan

    def local_rec(idx, lo, e_loc, cap):
        keep, rel, pos = local(idx, lo, e_loc, cap)
        plans.append(("sharded", idx, keep, lo, e_loc))
        return keep, rel, pos

    def plan_rec(idx, n_experts, capacity_factor, *, mesh=None):
        out = plan(idx, n_experts, capacity_factor, mesh=mesh)
        plans.append(("grouped", idx, out[0]))
        return out

    moe_sharded._local_plan, moe._capacity_plan = local_rec, plan_rec
    try:
        out = fn()
    finally:
        moe_sharded._local_plan, moe._capacity_plan = local, plan
    return out, plans


def sharded_plan_mismatches(torch, plans, cfg) -> tuple:
    """(pairs whose kept bit differs from one rank's plan on the same
    routings, pairs kept) over the sharded path's recorded plans: a rank
    keeps exactly the pairs of its own experts that one rank keeps."""
    from repro_torch.models.moe import _capacity_plan
    bad = kept = 0
    for _, idx, keep, lo, e_loc in plans:
        want = _capacity_plan(idx[None], cfg.n_experts,
                              cfg.capacity_factor)[0].reshape(-1)
        flat = idx.reshape(-1)
        own = (flat >= lo) & (flat < lo + e_loc)
        bad += int((keep != (want & own)).sum())
        kept += int(keep.sum())
    return bad, kept


def routing_differences(torch, a, b, n_experts: int) -> int:
    """(token, slot) routings that differ between two runs' per-layer
    expert indices (..., k)."""
    differ = 0
    for x, y in zip(a, b):
        oh_x = torch.nn.functional.one_hot(x.long(), n_experts).sum(-2)
        oh_y = torch.nn.functional.one_hot(y.long(), n_experts).sum(-2)
        differ += int((oh_x - oh_y).abs().sum()) // 2
    return differ


def ssm_states(cache) -> dict:
    """{(unit, layer): {field: tensor}} of the SSM caches (conv windows
    and state, ``models/ssm.py``'s ``SSMCache``) of units
    MESH_OWNER_LAYERS, copied."""
    return {(u, name): {f: t.clone() for f, t in zip(c._fields, c)}
            for u in MESH_OWNER_LAYERS for name, c in cache[u].items()
            if hasattr(c, "_fields")}


def mesh_generate(torch, cfg, params, prompts, mesh, fed=None,
                  n_steps: int = SERVE_GEN) -> dict:
    """Prefill ``prompts`` and decode ``n_steps`` - 1 tokens (``fed``'s when
    given, else the greedy ones) under ``mesh`` (None: no mesh), the MoE
    plans of the prefill recorded: per-step logits (B, V) on the card,
    the tokens, the prefill's flash launches, the SSM states after the
    prefill (``ssm_states``), the prefill and decode
    times and collective stats."""
    import contextlib

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    s_max = SERVE_PROMPT + SERVE_GEN
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    stats = {}
    with ctx:
        torch.cuda.synchronize()
        if mesh is not None:
            mesh.stats.clear()
        ops.reset_kernel_stats()
        t0 = time.perf_counter()
        (logits, cache, n), plans = recorded_plans(lambda: M.prefill(
            params, cfg, {"tokens": prompts}, s_max=s_max))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.kernel_stats()
        if mesh is not None:
            stats["prefill"] = {k: list(v) for k, v in mesh.stats.items()}
        states = ssm_states(cache) if cfg.ssm else {}
        steps = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens = [tok if fed is None else fed[:, :1]]
        t0 = time.perf_counter()
        for i in range(n_steps - 1):
            if mesh is not None and i == 0:
                mesh.stats.clear()
            logits, cache = M.decode_step(params, cfg, tokens[-1], cache,
                                          n + i)
            if mesh is not None and i == 0:
                torch.cuda.synchronize()
                stats["decode"] = {k: list(v) for k, v in mesh.stats.items()}
            steps.append(logits)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            tokens.append(tok if fed is None else fed[:, i + 1:i + 2])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (n_steps - 1)
    return {"logits": steps, "tokens": torch.cat(tokens, 1), "plans": plans,
            "launches": launches, "states": states, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "stats": stats, "cache": cache}


def hold_steps(torch, got, want, what: str) -> str:
    """(a)'s token rule at every step: the greedy tokens of ``got`` equal
    ``want``'s wherever ``want``'s top-2 margin exceeds LOGIT_RTOL of its
    largest logit.  Returns a summary line."""
    worst = sure_n = same_n = 0
    for step, (g, w) in enumerate(zip(got, want)):
        tol = LOGIT_RTOL * float(w.abs().max())
        top2 = torch.topk(w, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        same = torch.argmax(g, -1) == torch.argmax(w, -1)
        check(bool(same[sure].all()), f"{what}: greedy tokens differ at step "
              f"{step} where the margin exceeds {tol:.4f}")
        worst = max(worst, float((g - w).abs().max()) / tol)
        sure_n += int(sure.sum())
        same_n += int(same.sum())
    n = len(got) * got[0].shape[0]
    return (f"{what}: greedy tokens equal {same_n}/{n} over {len(got)} steps, "
            f"all {sure_n} with a margin above 2^-5 of the largest logit; "
            f"worst |logit diff| {worst:.3f} x that tolerance")


def second_rule(torch, got, ref, f32, what: str,
                ref_name: str = "the no-mesh path") -> str:
    """Phase 7's second rule on prefill logits: ``got`` no farther from
    the f32 plain path than ``ref`` (x 1.5), or within LOGIT_RTOL of the
    largest logit."""
    tol = LOGIT_RTOL * float(ref.abs().max())
    to32, to32_ref = (float((x - f32).abs().max()) for x in (got, ref))
    check(to32 <= max(tol, 1.5 * to32_ref), f"{what}: prefill logits "
          f"{to32:.4f} from the f32 plain path, the reference {to32_ref:.4f}"
          f" (tolerance {tol:.4f})")
    return (f"{what}: prefill max |diff| to the f32 plain path {to32:.4f}, "
            f"{ref_name}'s {to32_ref:.4f} (rule: <= max({tol:.4f}, "
            f"1.5 x {to32_ref:.4f})); to {ref_name} "
            f"{float((got - ref).abs().max()):.4f}")


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def tp_placement(cfg, m: int) -> str:
    """What a "model" axis of ``m`` ranks splits of ``cfg``'s dense
    layers (the divisibility fallback keeps the rest whole)."""
    def part(n, what):
        return f"{what} {n // m} of {n}" if n % m == 0 else f"{what} {n} whole"
    parts = ([part(cfg.n_heads, "heads"), part(cfg.n_kv, "KV heads")]
             if cfg.n_heads else [])
    if cfg.ssm:
        parts.append(part(cfg.n_ssm_heads, "SSM heads"))
    if cfg.d_ff:
        parts.append(part(cfg.d_ff, "ffn"))
    if cfg.n_experts:
        parts.append(part(cfg.n_experts, "experts"))
    parts.append(part(cfg.vocab, "vocabulary"))
    return ", ".join(parts)


def mesh_part_a(torch, spec, work: Path) -> dict:
    """Phase 15 (a): one rank, mesh (1, 1), against no mesh.  Saves each
    model's reference for (b) and (c) beside the result."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    mesh = make_mesh((1, 1), ("data", "model"))
    print(f"(a) backend {dist.get_backend()}, {dist.get_world_size()} rank, "
          f"mesh {mesh.shape}", flush=True)
    out = {}
    for arch in MESH_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, prompts = mesh_model(torch, arch, spec["seed"])
        mine = shard_state(params, mesh)
        n_attn = M.n_attention_layers(cfg)
        whole_bytes = param_bytes(params)
        print(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"heads {cfg.n_heads}/{cfg.n_kv} x {cfg.head_dim}, experts "
              f"{cfg.n_experts} top-{cfg.top_k}, decode_kv_shard "
              f"{cfg.decode_kv_shard}: "
              f"{sum(p.numel() for p in params.parameters())} bf16 "
              f"parameters; {SERVE_BATCH} x {SERVE_PROMPT} prompt tokens + "
              f"{SERVE_GEN} greedy", flush=True)
        M.prefill(params, cfg, {"tokens": prompts},       # warm-up at the
                  s_max=SERVE_PROMPT + SERVE_GEN)         # prefill's shapes
        n_steps = MESH_B_STEPS if cfg.ssm else SERVE_GEN  # the SSMs: (b)'s
        got = mesh_generate(torch, cfg, mine, prompts, mesh, n_steps=n_steps)
        want = {"flash_attention_fwd": n_attn,
                "flash_attention_fwd:bf16": n_attn} if n_attn else {}
        check(got["launches"] == want, f"(a) {arch}: launches a prefill "
              f"{got['launches']}, want {want}")
        ref = mesh_generate(torch, cfg, params, prompts, None,
                            fed=got["tokens"], n_steps=n_steps)
        del mine
        got.pop("cache"), ref.pop("cache")
        if cfg.n_experts:
            bad, kept = sharded_plan_mismatches(torch, got["plans"], cfg)
            check(bad == 0 and len(got["plans"]) == cfg.num_layers,
                  f"(a) {arch}: {bad} kept (token, slot) pairs differ from "
                  "one rank's plan")
            differ = routing_differences(
                torch, [p[1] for p in got["plans"]],
                [p[1][0] for p in ref["plans"]], cfg.n_experts)
            pairs = cfg.num_layers * SERVE_BATCH * SERVE_PROMPT * cfg.top_k
            print(f"kept (token, slot) masks: {kept} of {pairs} pairs kept, "
                  f"0 differ from one rank's plan on the same routings; "
                  f"routings differing from the no-mesh run: {differ}",
                  flush=True)
        params32 = copy.deepcopy(params).float()
        del params
        rows = MESH_B_ROWS.get(arch, SERVE_BATCH)
        l32, cache32, _ = M.prefill(params32, dataclasses.replace(
            cfg, attn_impl="ref"), {"tokens": prompts},
            s_max=SERVE_PROMPT + 1, cache_dtype=torch.float32)
        states32 = ssm_states(cache32) if cfg.ssm else {}
        del params32, cache32
        print(second_rule(torch, got["logits"][0], ref["logits"][0], l32,
                          f"(a) {arch}"), flush=True)
        print(hold_steps(torch, got["logits"], ref["logits"], f"(a) {arch}"),
              flush=True)
        print(f"prefill {got['prefill_ms']:.2f} ms under the mesh, "
              f"{ref['prefill_ms']:.2f} without; decode "
              f"{got['decode_ms']:.3f} / {ref['decode_ms']:.3f} ms a step "
              f"over {n_steps - 1} steps; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"flash launches a prefill {got['launches']}", flush=True)
        torch.save({"digest": batch_digest(torch, prompts),
                    "param_bytes": whole_bytes,
                    "tokens": got["tokens"].cpu(),
                    "logits": [x.cpu() for x in ref["logits"]],
                    "f32": l32.cpu(),
                    "routes": [p[1][0].to(torch.uint8).cpu()
                               for p in ref["plans"]],
                    **{key: {k: {f: t[:rows].cpu() for f, t in v.items()}
                             for k, v in states.items()}
                       for key, states in (("states", ref["states"]),
                                           ("states32", states32))}},
                   work / f"ref_{arch}.pt")
        out[arch] = {"launches": got["launches"].get("flash_attention_fwd",
                                                     0),
                     "prefill_ms": got["prefill_ms"],
                     "decode_ms": got["decode_ms"],
                     "param_bytes": whole_bytes}
        del got, ref, l32, prompts
        torch.cuda.empty_cache()
    return out


def gloo_cuda_collectives(torch) -> dict:
    """Which collectives the started gloo group runs on CUDA tensors in
    this torch: "ok" or the error each raises."""
    import torch.distributed as dist
    world, res = dist.get_world_size(), {}
    x = torch.ones(4, device="cuda")
    tries = {
        "all_reduce sum bf16": lambda: dist.all_reduce(
            torch.ones(4, device="cuda", dtype=torch.bfloat16)),
        "all_reduce max f32": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "all_reduce sum int64": lambda: dist.all_reduce(
            torch.ones(4, device="cuda", dtype=torch.int64)),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * 4, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device="cuda"),
            torch.ones(world * 4, device="cuda")),
    }
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    return res


def stats_line(stats: dict) -> str:
    return ", ".join(f"{k} x{c} {b / 2**20:.2f} MiB {s * 1e3:.1f} ms"
                     for k, (c, b, s) in sorted(stats.items())) or "none"


def leaf_split(whole: dict, mine) -> tuple:
    """(the parameter bytes a rank of two model ranks holds by the
    placement: half of every leaf it splits, the others whole; the leaves
    it keeps whole, unit indices dropped).  Fails on a leaf that is
    neither.  ``whole``: each leaf's element count before the split."""
    import re
    want, kept = 0, set()
    for name, p in mine.named_parameters():
        n = whole[name]
        check(p.numel() in (n, n // 2) and not (p.numel() < n and n % 2),
              f"(b) {name}: {p.numel()} of {n} elements on a rank")
        if p.numel() == n:
            kept.add(re.sub(r"^units\.\d+\.(l\d+\.)?", "", name))
        want += p.numel() * p.element_size()
    return want, sorted(kept)


def check_ssm_states(mesh, got: dict, ref: dict, ref32: dict) -> str:
    """Phase 15 (b)'s state check (the comment above MESH_STATE_RTOL):
    each of this rank's SSM caches after the prefill against (a)'s
    no-mesh bf16 one ``ref`` and f32 plain one ``ref32`` on the rank's
    heads (the state's heads, conv_x's channels; conv_B and conv_C
    whole).  Returns, by field, the worst relative distances in norm to
    the f32 states (this rank's, the no-mesh path's) and the largest
    elementwise distance to the no-mesh bf16 states relative to their
    largest magnitude."""
    r = mesh.coord("model")
    check(sorted(got) == sorted(ref) == sorted(ref32), f"(b) SSM caches "
          f"{sorted(got)}, (a)'s {sorted(ref)} and {sorted(ref32)}")
    worst = {}
    for key, fields in ref.items():
        for f in fields:
            have = got[key][f].float()
            want, want32 = (x[key][f].to(have.device).float()
                            for x in (ref, ref32))
            dim = {"state": 1, "conv_x": 2}.get(f)
            if dim is not None:
                n = have.shape[dim]
                check(2 * n == want.shape[dim], f"(b) {key} {f}: {n} of "
                      f"{want.shape[dim]} a rank, not half")
                want, want32 = (x.narrow(dim, r * n, n) for x in (want,
                                                                  want32))
            check(have.shape == want.shape, f"(b) {key} {f}: "
                  f"{tuple(have.shape)}, (a) {tuple(want.shape)}")
            norm32 = max(float(want32.norm()), 1e-30)
            to32 = float((have - want32).norm()) / norm32
            ref_to32 = float((want - want32).norm()) / norm32
            drift = (float((have - want).abs().max())
                     / max(float(want.abs().max()), 1e-30))
            check(to32 <= max(MESH_STATE_RTOL, 1.5 * ref_to32), f"(b) {key} "
                  f"{f}: {to32:.4g} (relative norm) from the f32 plain path's"
                  f" state, the no-mesh bf16 state {ref_to32:.4g}")
            w = worst.setdefault(f, [0.0, 0.0, 0.0])
            w[:] = max(w[0], to32), max(w[1], ref_to32), max(w[2], drift)
    return (f"SSM states after the prefill ({len(ref)} layers of units "
            f"{MESH_OWNER_LAYERS}) on rank {r}'s heads, worst by field: "
            "relative norm distance to the f32 plain path's states (rule: "
            "<= max(2^-5, 1.5 x the no-mesh bf16 path's)), this rank / no "
            "mesh; largest elementwise distance to the no-mesh bf16 states "
            "over their largest: " + ", ".join(
                f"{f} {a:.4f} / {b:.4f}; {c:.4f}"
                for f, (a, b, c) in sorted(worst.items())))


def mesh_part_b(torch, spec, work: Path) -> dict:
    """Phase 15 (b): two ranks on the one card, mesh (1, 2)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    rank = dist.get_rank()
    coll = gloo_cuda_collectives(torch)
    mesh = make_mesh((1, 2), ("data", "model"))
    if rank == 0:
        print(f"(b) backend {dist.get_backend()}, {dist.get_world_size()} "
              f"ranks on {torch.cuda.device_count()} card, mesh "
              f"{mesh.shape}; gloo on CUDA tensors: {coll}", flush=True)
    out = {"collectives": coll}
    for arch in MESH_ARCHS:
        ref = torch.load(work / f"ref_{arch}.pt", weights_only=False)
        cfg, params, prompts = mesh_model(torch, arch, spec["seed"])
        digests = mesh.all_gather(torch.tensor(
            [batch_digest(torch, prompts)], device="cuda"), "model")
        check(bool((digests == ref["digest"]).all()), f"(b) {arch}: ranks "
              f"drew batches {digests.tolist()}, (a) {ref['digest']}")
        whole = {n: p.numel() for n, p in params.named_parameters()}
        mine = shard_state(params, mesh)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_bytes = param_bytes(mine)
        share = held_bytes / ref["param_bytes"]
        want_bytes, kept = leaf_split(whole, mine)
        check(held_bytes == want_bytes, f"(b) {arch}: rank {rank} holds "
              f"{held_bytes} parameter bytes, the placement {want_bytes}")
        if arch == MESH_SEQ:               # every dense dimension divides
            check(abs(share - 0.5) <= 0.005, f"(b) {arch}: rank {rank} "
                  f"holds {held_bytes} parameter bytes, {share:.4f} of "
                  f"(a)'s {ref['param_bytes']}, not half within 1%")
        rows = MESH_B_ROWS.get(arch, SERVE_BATCH)
        n_attn = M.n_attention_layers(cfg)
        held = {}
        if cfg.n_experts:
            e = mine["units"][0]["l0"]["moe"]["w_gate"].shape[0]
            held["experts"] = e
        got = mesh_generate_owner(torch, cfg, mine, prompts[:rows], mesh,
                                  ref["tokens"][:rows].to("cuda"), held,
                                  n_steps=MESH_B_STEPS)
        want = {"flash_attention_fwd": n_attn,
                "flash_attention_fwd:bf16": n_attn} if n_attn else {}
        check(got["launches"] == want, f"(b) {arch}: launches a prefill "
              f"{got['launches']}, want {want}")
        same = mesh.all_gather(got["logits"][-1].contiguous()[None], "model")
        check(torch.equal(same[0], same[1]), f"(b) {arch}: the ranks' "
              "logits differ")
        peak = torch.cuda.max_memory_allocated()
        lines = [f"tensor parallel over 2 model ranks: "
                 f"{tp_placement(cfg, 2)}; rank {rank} holds "
                 f"{held_bytes / 1e9:.3f} GB of parameters, {share:.4f} of "
                 f"(a)'s {ref['param_bytes'] / 1e9:.3f} GB, the placement's "
                 f"bytes exactly (leaves kept whole: {', '.join(kept)}); "
                 f"{rows} of {SERVE_BATCH} prompts"]
        if cfg.n_experts:
            bad, kept_pairs = sharded_plan_mismatches(torch, got["plans"],
                                                      cfg)
            check(bad == 0, f"(b) {arch}: rank {rank}: {bad} kept pairs "
                  "differ from one rank's plan")
            differ = routing_differences(
                torch, [p[1] for p in got["plans"]],
                [r.to("cuda") for r in ref["routes"]], cfg.n_experts)
            lines.append(f"rank 0 holds {held['experts']} of "
                         f"{cfg.n_experts} experts; its kept pairs "
                         f"({kept_pairs}) are one rank's plan's on its "
                         f"experts, 0 differ; routings differing from (a): "
                         f"{differ}")
        lines.append(held["cache"])
        if cfg.ssm:
            lines.append(check_ssm_states(mesh, got["states"], ref["states"],
                                          ref["states32"]))
        lines.append(second_rule(torch, got["logits"][0],
                                 ref["logits"][0][:rows].to("cuda"),
                                 ref["f32"][:rows].to("cuda"), f"(b) {arch}"))
        lines.append(hold_steps(torch, got["logits"],
                                [x[:rows].to("cuda")
                                 for x in ref["logits"][:MESH_B_STEPS]],
                                f"(b) {arch}"))
        lines.append(f"collectives of the prefill: "
                     f"{stats_line(got['stats']['prefill'])}; of one decode "
                     f"step: {stats_line(got['stats']['decode'])}")
        lines.append(f"prefill {got['prefill_ms']:.2f} ms, decode "
                     f"{got['decode_ms']:.3f} ms a step (two ranks on one "
                     f"card); peak {peak / 2**30:.2f} GiB a rank after the "
                     "whole parameters were dropped")
        if rank == 0:
            for line in lines:
                print(line, flush=True)
        out[arch] = {"stats": got["stats"], "prefill_ms": got["prefill_ms"],
                     "decode_ms": got["decode_ms"], "param_bytes": held_bytes,
                     "peak": peak, "launches": n_attn}
        del got, mine, ref, prompts, same
        torch.cuda.empty_cache()
    out["c"] = mesh_data_parallel(torch, spec, work)
    return out


def mesh_generate_owner(torch, cfg, params, prompts, mesh, fed,
                        held: dict, n_steps: int = SERVE_GEN) -> dict:
    """``mesh_generate`` with every decode step's KV writes checked on
    units MESH_OWNER_LAYERS (the first layer's cache; zamba2's shared
    block's): a sequence-split cache changed exactly slot ``cache_len``
    of the owner rank's slice and nothing of the other's; a cache split
    by heads (or whole) changed exactly that slot on every rank.  The SSM
    caches are replaced whole each step (their prefill states are checked
    in ``mesh_part_b``); mamba2 keeps no KV cache.  ``held["cache"]``
    gets the summary line."""
    from repro_torch.models import model as M
    if cfg.ssm and not cfg.shared_attn_every:
        held["cache"] = ("no KV cache: the SSM states are replaced whole "
                         "each decode step")
        return mesh_generate(torch, cfg, params, prompts, mesh, fed=fed,
                             n_steps=n_steps)
    seq = cfg.decode_kv_shard == "seq"
    name = "shared" if cfg.ssm else "l0"
    layers = [(u % cfg.n_units, name) for u in MESH_OWNER_LAYERS]
    step, orig = [0], M.decode_step

    def checked(params_, cfg_, tokens, cache, cache_len, **kw):
        before = [[t.clone() for t in cache[u][n]] for u, n in layers]
        out = orig(params_, cfg_, tokens, cache, cache_len, **kw)
        s_loc, kv = cache[0][name][0].shape[1:3]
        owner, slot = ((int(cache_len) // s_loc, int(cache_len) % s_loc)
                       if seq else (mesh.coord("model"), int(cache_len)))
        held.update(slots=s_loc, kv_heads=kv)
        for (u, n), old in zip(layers, before):
            for new, o in zip(cache[u][n], old):
                changed = (new != o).any(dim=(0, 2, 3))
                if mesh.coord("model") == owner:
                    ok = bool(changed[slot]) and int(changed.sum()) == 1
                else:
                    ok = not bool(changed.any())
                check(ok, f"(b) decode step {step[0]}: rank "
                      f"{mesh.coord('model')}'s slice of unit {u} {n} "
                      f"changed at {changed.nonzero().flatten().tolist()}, "
                      f"owner {owner} slot {slot}")
        step[0] += 1
        return out

    M.decode_step = checked
    try:
        got = mesh_generate(torch, cfg, params, prompts, mesh, fed=fed,
                            n_steps=n_steps)
    finally:
        M.decode_step = orig
    where = (f"{held['slots']} of {SERVE_PROMPT + SERVE_GEN} cache slots; "
             "the new K/V landed on the owner rank only" if seq else
             f"{held['kv_heads']} of {cfg.n_kv} KV heads of the {name} "
             "cache; the new K/V landed at its slot on every rank")
    held["cache"] = (f"rank 0 holds {where} at all {step[0]} decode steps "
                     f"(units {MESH_OWNER_LAYERS} checked)")
    return got


def mesh_data_parallel(torch, spec, work: Path) -> dict:
    """Phase 15 (c), in (b)'s ranks: granite's prefill at two data ranks
    on the one card (the host mesh), one MoE group over both ranks'
    rows."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import batch_coord, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.moe import _capacity_plan

    arch = MESH_MOE
    mesh = make_host_mesh()
    n, r = mesh.shape["data"], batch_coord(mesh)
    ref = torch.load(work / f"ref_{arch}.pt", weights_only=False)
    cfg, params, prompts = mesh_model(torch, arch, spec["seed"])
    digests = mesh.all_gather(torch.tensor([batch_digest(torch, prompts)],
                                           device="cuda"), "data")
    check(bool((digests == ref["digest"]).all()), f"(c) ranks drew batches "
          f"{digests.tolist()}, (a) {ref['digest']}")
    rows = SERVE_BATCH // n
    mesh.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        (logits, _, _), plans = recorded_plans(lambda: M.prefill(
            params, cfg, {"tokens": prompts[r * rows:(r + 1) * rows]},
            s_max=SERVE_PROMPT + SERVE_GEN))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    stats = {k: list(v) for k, v in mesh.stats.items()}
    check(len(plans) == cfg.num_layers, f"(c) {len(plans)} MoE plans")
    bad = kept = 0
    routes = []
    for _, idx, keep in plans:
        whole = mesh.all_gather(idx, "data", dim=1)         # (1, T, k)
        want = _capacity_plan(whole, cfg.n_experts, cfg.capacity_factor)[0]
        t = idx.shape[1]
        bad += int((keep != want[:, r * t:(r + 1) * t]).sum())
        kept += int(keep.sum())
        routes.append(whole[0])
    check(bad == 0, f"(c) rank {r}: {bad} kept (token, slot) pairs differ "
          "from one rank's plan")
    kept = int(mesh.all_reduce(torch.tensor([kept], device="cuda"),
                               "data")[0])
    logits = mesh.all_gather(logits.contiguous(), "data")
    if r == 0:
        differ = routing_differences(torch, routes,
                                     [x.to("cuda") for x in ref["routes"]],
                                     cfg.n_experts)
        pairs = cfg.num_layers * SERVE_BATCH * SERVE_PROMPT * cfg.top_k
        print(f"(c) backend {dist.get_backend()}, {n} data ranks on one "
              f"card; {arch} at capacity {cfg.capacity_factor}: {kept} of "
              f"{pairs} (token, slot) pairs kept, each rank's mask one "
              f"rank's plan's on the gathered routings (0 differ); routings "
              f"differing from (a)'s no-mesh run: {differ}", flush=True)
        print(second_rule(torch, logits, ref["logits"][0].to("cuda"),
                          ref["f32"].to("cuda"), f"(c) {arch}"), flush=True)
        print(hold_steps(torch, [logits], [ref["logits"][0].to("cuda")],
                         f"(c) {arch} first token"), flush=True)
        print(f"(c) prefill {prefill_ms:.2f} ms (4 rows a rank, two ranks on "
              f"one card); collectives {stats_line(stats)}", flush=True)
    return {"prefill_ms": prefill_ms, "stats": stats}


def tp_local_flash(torch, dev, seed: int, err: dict) -> dict:
    """The flash wrapper (``models/flash.py``) at yi-9b's prefill shape
    on one of two model ranks' heads, as (b) launches it: B SERVE_BATCH x
    S SERVE_PROMPT, 16 of 32 q heads, 2 of 4 KV heads, D 128, causal,
    bf16; held against ``blockwise_attention`` (phase 13's rules) and
    timed (one call between two events) beside it, SDPA on the same
    heads (the KV heads repeated for it) and the bound: the q, k and v
    read once and the output written once over 3.35 TB/s, the causal
    FLOPs over 989 TFLOP/s."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.models.flash import flash_attention
    from repro_torch.models.layers import _repeat_kv, blockwise_attention

    cfg = get_config(MESH_SEQ)
    B, S, H, Hkv, D = (SERVE_BATCH, SERVE_PROMPT, cfg.n_heads // 2,
                       cfg.n_kv // 2, cfg.head_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((B, S, Hkv, D), device=dev, generator=gen)
            .bfloat16() for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    want = blockwise_attention(q, k, v, causal=True)
    e, r = float((got.float() - want.float()).abs().max()), row_rel_err(
        got, want)
    err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
    check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
          and r <= FLASH_BF16_ROW_RTOL, f"flash at yi-9b's local heads: max "
          f"err {e:.4g}, row error {r:.4g}")
    ms = time_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: blockwise_attention(q, k, v,
                                                          causal=True),
                       iters=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * 2
    t_ops, t_bytes = (flops / PEAK_BF16_FLOPS * 1e3,
                      nbytes / PEAK_BYTES_PER_S * 1e3)
    bnd, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                    else "bytes")
    print(f"models/flash.py at yi-9b's prefill on one of two model ranks "
          f"(B {B}, S {S}, heads {H}/{Hkv} x {D}, causal, bf16): max err "
          f"{e:.4g}, row error {r:.4g}; {ms:.4f} ms a call, bound {bnd:.4f} "
          f"ms ({by}), plain {plain_ms:.3f} ms, scaled_dot_product_attention"
          f" {lib_ms:.4f} ms", flush=True)
    del q, k, v, got, want, qt, kt, vt
    torch.cuda.empty_cache()
    return {"shape": [B, S, H, Hkv, D], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
            "max_abs_err": e}


def record_serve(torch, argv: list, path: Path) -> int:
    """``launch.serve.main(argv)`` with this rank's prefill's and last
    decode step's logits, and its tokens, saved to ``path`` (float32, on
    the host) as generation returns them."""
    from repro_torch.launch import serve

    orig = serve._generate

    def recording(*a, **kw):
        tokens, first, last = orig(*a, **kw)
        torch.save({"first": first.float().cpu(), "last": last.float().cpu(),
                    "tokens": tokens.cpu()}, path)
        return tokens, first, last

    serve._generate = recording
    try:
        return serve.main(argv)
    finally:
        serve._generate = orig


def serve_child(work: Path) -> int:
    """A rank of phase 15 (c)'s serve CLI under torch.distributed.run."""
    import torch
    return record_serve(torch, SERVE_CLI_ARGV + ["--model-ranks",
                                                 str(SERVE_CLI_RANKS)],
                        work / f"serve_rank{os.environ['RANK']}.pt")


def serve_cli_ranks(torch, work: Path) -> str:
    """Phase 15 (c): ``launch.serve`` for smollm-135m at phase 7's
    requests in this process (one rank), then under
    torch.distributed.run with ``--model-ranks 2`` (two gloo ranks on
    the card, mesh (1, 2)): rank 0 prints the same greedy tokens, and
    each rank's tokens equal one rank's, its prefill's and last step's
    logits within LOGIT_RTOL of the largest of one rank's."""
    import contextlib
    import io

    out = {}
    for n in (1, SERVE_CLI_RANKS):
        t0 = time.perf_counter()
        if n == 1:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = record_serve(torch, SERVE_CLI_ARGV, work / "serve_one.pt")
            text = buf.getvalue()
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(n), str(Path(__file__).resolve()),
                 "--serve-child", str(work)], cwd=ROOT, env=mesh_env(),
                capture_output=True, text=True, timeout=TOOL_TIMEOUT_S)
            rc, text = proc.returncode, proc.stdout
            check(rc != 0 or (f"process group: backend gloo, {n} ranks" in text
                              and f"x {n} model ranks" in text),
                  f"serve over {n} model ranks: {text[-2000:]}")
        check(rc == 0, f"serve over {n} rank(s) returned {rc}: "
              f"{text[-2000:]}")
        lines = text.splitlines()
        out[n] = [ln for ln in lines if ln.startswith("continuation ids:")]
        check(len(out[n]) == 1, f"serve over {n} rank(s) printed "
              f"{text[-2000:]}")
        served = [ln for ln in lines if ln.startswith(("served",
                                                       "process group"))]
        print(f"  serve, {n} rank(s), {time.perf_counter() - t0:.1f} s "
              "(process start-up included): " + " | ".join(served),
              flush=True)
    check(out[1] == out[SERVE_CLI_RANKS], f"serve over {SERVE_CLI_RANKS} "
          f"model ranks printed {out[SERVE_CLI_RANKS]}, one rank {out[1]}")
    one = torch.load(work / "serve_one.pt")
    for r in range(SERVE_CLI_RANKS):
        got = torch.load(work / f"serve_rank{r}.pt")
        what = f"serve, model rank {r} of {SERVE_CLI_RANKS}"
        check(torch.equal(got["tokens"], one["tokens"]), f"{what}: tokens "
              "are not one rank's")
        for key in ("first", "last"):
            tol = LOGIT_RTOL * float(one[key].abs().max())
            diff = float((got[key] - one[key]).abs().max())
            check(got[key].shape == one[key].shape and diff <= tol,
                  f"{what}: {key} logits {diff:.4f} from one rank's "
                  f"(tolerance {tol:.4f})")
            print(f"  {what}: the {key} step's logits max |diff| "
                  f"{diff:.4f} to one rank's (tolerance {tol:.4f})",
                  flush=True)
        print("  " + hold_steps(torch, [got["first"], got["last"]],
                                [one["first"], one["last"]],
                                f"{what} (prefill, last step)"), flush=True)
    rows = {tuple(r) for r in one["tokens"].tolist()}
    print(f"  serve: {len(rows)} distinct token rows of "
          f"{one['tokens'].shape[0]}", flush=True)
    return out[1][0]


def mesh_layer(torch, args, dev, err: dict) -> dict:
    """Phase 15: the flash wrapper at each model's prefill shape that phase
    13 did not hold, at zamba2's shared block on one of two model ranks'
    heads (as (b) launches it) and at yi-9b's local heads, then (a)–(c) in
    processes of their own; returns the flash launches of a prefill of
    each model under the mesh (a) and on each rank of (b), and the
    local-head wrapper's record."""
    import dataclasses
    import shutil

    from repro_torch.configs.registry import get_config

    for i, arch in enumerate(MESH_ARCHS):
        if arch not in FAMILIES:
            check_family_flash(torch, dev, get_config(arch), arch,
                               args.seed + 150 + i, err)
    zamba2 = get_config(MESH_SSM[1])
    check_family_flash(torch, dev, dataclasses.replace(
        zamba2, n_heads=zamba2.n_heads // 2, n_kv=zamba2.n_kv // 2),
        f"{MESH_SSM[1]} on one of two model ranks", args.seed + 155, err,
        B=MESH_B_ROWS[MESH_SSM[1]])
    local = tp_local_flash(torch, dev, args.seed + 160, err)
    torch.cuda.empty_cache()
    print(f"phase 15 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
          " GiB held by this process", flush=True)
    work = ROOT / "build" / f"chip_smoke_mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        a = mesh_spawn(torch, args, "a", 1, work)[0]
        print(f"(a: {time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        b = mesh_spawn(torch, args, "b", 2, work)
        print(f"(b and (c)'s granite: {time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        tokens = serve_cli_ranks(torch, work)
        print(f"(c) serve CLI: one rank and {SERVE_CLI_RANKS} model ranks "
              f"print the same {tokens[:80]}... "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"a": {arch: a[arch]["launches"] for arch in MESH_ARCHS},
            "b": {arch: [r[arch]["launches"] for r in b]
                  for arch in MESH_ARCHS},
            "local_heads": local}


# Phase 16, training under a mesh of ranks (distributed/sharding.py's
# training placement, the FSDP gathers of models/model.py, the reductions
# of train/steps.py, logical checkpoints) and the dry-run tooling
# (launch/dryrun.py, op_cost.py, op_analysis.py).  (a) launch.dryrun's
# count of phase 12 (c)'s step (smollm-135m at full width and depth, 8 x
# 2,048 tokens, bf16 compute, remat, mesh (1, 1)) against the same step
# on the card: its argument bytes equal the real parameters, moments and
# batch exactly, its FLOPs and bytes stand beside the measured step, its
# peak beside max_memory_allocated; every architecture's train_4k cell
# counted at (16, 16) by one launch.dryrun process (meta tensors, no
# card) that runs beside (b) and (c) and is read after them.  (b) data
# parallelism through the CLI: python -m torch.distributed.run
# --nproc-per-node 2 -m repro_torch.launch.train (two gloo ranks sharing
# the card, FSDP over "data"), phase 12 (c)'s batches and schedule
# (TRAIN_STEPS steps), two launches: the drill (a checkpoint every
# P16_CKPT_EVERY steps, --fail-at P16_FAIL_AT: both ranks exit 13 after
# P16_FAIL_AT uninterrupted steps), then its rerun, which resumes from
# the checkpoint before the drill's last (that one is moved aside) and
# so repeats steps the drill ran uninterrupted (each checkpoint gathers
# 1.6 GB over gloo);
# each step's loss within TRAIN_LOSS_RTOL and gradient norm within
# TRAIN_GNORM_RTOL of phase 12's one-rank run on the same batches, the
# repeated steps' lines and the checkpoint both runs wrote equal bit for
# bit, that checkpoint restored whole on one process with no mesh bit for
# bit and its rank shards tiling it; 60 lse forwards and 30 backwards a
# step on each rank.  (c) expert parallelism: granite-moe-3b-a800m cut
# to P16_EP_LAYERS layers (f32 masters: two ranks' masters and moments,
# and the one-rank reference before them, on one card, beside (b)'s
# rerun), mesh (1, 2), 20 of its 40 experts and 12 of its 24 heads a
# rank (the attention tensor parallel), P16_EP_STEPS steps
# through make_train_step under use_mesh against the one-rank step on the
# same batches: kept masks one
# rank's plan on the same routings, losses and norms under (b)'s rule,
# each rank's updated experts (first and last layer) the matching slice
# of the one-rank update within TRAIN_LOSS_RTOL of its norm (a norm, not
# each weight: Adam's first steps move a weight by ±lr wherever |g| is
# well above eps, so a weight whose bf16 gradient rounds across zero in
# one path moves the other way; the update's own distance is printed).
# mamba2-1.3b, cut to P16_EP_LAYERS of 48 layers at full width, trains in
# the same two ranks after granite, against its own one-rank reference
# (run beside granite's): 32 of its 64 SSM heads a rank, the gated norm's
# squares summed over "model", 25,140 of 50,280 vocabulary rows; the same
# rules on losses and norms, and each rank's updated wz / wx (in_proj's z
# and x streams) and out_proj slices of the first and last layer against
# the one-rank update's (bf16 compute, as granite's: the SSD backward
# through the _ToModel / _FromModel pair on CUDA tensors).
P16_CKPT_EVERY, P16_FAIL_AT = 3, 7
P16_EP_ARCH, P16_EP_LAYERS, P16_EP_STEPS, P16_EP_BATCH = (
    "granite-moe-3b-a800m", 8, 3, 4)
# the two models of (c), and the leaves (block, leaf, the dimension the
# "model" axis splits) whose slices are held against the one-rank update
P16_TP_LEAVES = {P16_EP_ARCH: (("moe", "w_gate", 0), ("moe", "w_down", 0)),
                 "mamba2-1.3b": (("ssm", "wz", 1), ("ssm", "wx", 1),
                                 ("ssm", "out_proj", 0))}
P16_DRYRUN_TIMEOUT_S = 420
P16_CLI_TIMEOUT_S = 300


def dryrun_counts():
    """Start every architecture's train_4k count at (16, 16): one
    ``python -m repro_torch.launch.dryrun --all --shape train_4k`` with no
    card visible, writing under a temporary ``build/`` directory (phase 16
    (a) reads and removes it).  Returns (the process, the directory)."""
    work = ROOT / "build" / f"chip_smoke_dryrun_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(mesh_env(), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = work / "dryrun.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--shape", "train_4k", "--mesh", "single", "--out",
             str(work / "dryrun"), "--force"], cwd=ROOT, env=env,
            stdout=out, stderr=subprocess.STDOUT)
    return proc, work


def dryrun_against_card(torch, args) -> dict:
    """Phase 16 (a): the count of phase 12 (c)'s step beside the step on
    the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import CountingMesh, make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("phase12c", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec, cost = trace_cell(TRAIN_ARCH, shape.name,
                           CountingMesh((1, 1), ("data", "model")), cfg=cfg,
                           shape=shape, exact=True)
    n = cfg.num_layers
    kernels = {k: v[0] for k, v in cost.kernels.items()}
    check(kernels == {"flash_attention_fwd": 2 * n,
                      "flash_attention_bwd": n},
          f"(a) counted kernels {kernels}")
    params = M.init_params(torch.Generator().manual_seed(args.seed), cfg,
                           device="cuda")
    opt = adamw_init(params)
    batch = SketchDedupPipeline(DataConfig(
        vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=args.seed,
        dedup=True), device="cuda").batch_for_step(0)
    tensors = (list(params.parameters()) + list(opt.mu.parameters())
               + list(opt.nu.parameters()) + [opt.step]
               + list(batch.values()))
    real = sum(t.numel() * t.element_size() for t in tensors)
    counted = rec["memory"]["argument_bytes"]
    check(counted == real, f"(a) argument_bytes {counted} != the card's "
          f"parameters, moments and batch {real}")
    step = make_train_step(cfg, Hyper(warmup_steps=2,
                                      total_steps=TRAIN_STEPS),
                           num_microbatches=rec["num_microbatches"])
    with use_mesh(make_mesh((1, 1), ("data", "model"))):
        step(params, opt, batch)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    roof = rec["roofline"]
    t_bound = max(roof["t_compute_s"], roof["t_memory_s"],
                  roof["t_collective_s"])
    print(f"(a) {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ}, mesh (1, 1): "
          f"argument_bytes {counted} = the card's parameters, moments and "
          f"batch; counted {cost.flops:.4e} FLOPs and {cost.bytes:.4e} bytes "
          f"(unfused upper bound), kernels {kernels}; the step on the card "
          f"{ms:.1f} ms median of 3 {[round(t, 1) for t in times]}: "
          f"{cost.flops / ms / 1e9:.1f} TFLOP/s achieved, t_bound "
          f"{t_bound * 1e3:.1f} ms ({roof['bottleneck']}) = "
          f"{t_bound * 1e3 / ms:.3f} of the measured step; counted peak "
          f"{rec['memory']['total_bytes'] / 2**30:.2f} GiB (arguments + "
          f"{rec['memory']['temp_bytes'] / 2**30:.2f} live), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (before the step "
          f"{base / 2**30:.2f}); trace {rec['trace_s']} s", flush=True)
    del params, opt, batch, step
    torch.cuda.empty_cache()
    return {"step_ms": ms, "flops": cost.flops, "bytes": cost.bytes,
            "t_bound_ms": t_bound * 1e3, "peak": peak,
            "counted_total": rec["memory"]["total_bytes"]}


def cli_start(argv: list, tag: str, work: Path):
    """Start one ``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train`` run; its output goes to
    ``work/<tag>.log``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + argv
    log = open(work / f"{tag}.log", "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=mesh_env(), stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log, tag, time.perf_counter()


def cli_wait(run, work: Path) -> tuple:
    """(returncode, output) of a run ``cli_start`` began; killed after
    P16_CLI_TIMEOUT_S."""
    proc, log, tag, t0 = run
    try:
        proc.wait(timeout=max(P16_CLI_TIMEOUT_S - (time.perf_counter() - t0),
                              1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.close()
    out = (work / f"{tag}.log").read_text()
    print(f"(b) {tag}: rc {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return proc.returncode, out


def step_lines(out: str) -> dict:
    """{step: (loss text, gnorm text, seconds)} from the driver's lines."""
    import re
    got = {}
    for m in re.finditer(r"step\s+(\d+)\s+loss (\S+)\s+gnorm (\S+)\s+lr "
                         r"\S+\s+\((\S+)s\)", out):
        got[int(m.group(1))] = (m.group(2), m.group(3), float(m.group(4)))
    return got


def rank_launches(out: str) -> dict:
    import ast
    import re
    got = {}
    for m in re.finditer(r"\[rank (\d+)\] kernel launches over (\d+) steps:"
                         r" (\{[^}]*\})", out):
        got[int(m.group(1))] = (int(m.group(2)), ast.literal_eval(m.group(3)))
    return got


def data_parallel_cli(torch, args, work: Path, beside) -> dict:
    """Phase 16 (b); ``beside()`` runs once the rerun has started.
    Returns each rank's launches of rows 1, 6l and 7 in the rerun."""
    import re

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.checkpoint import restore_checkpoint
    from repro_torch.distributed.sharding import local_shard, train_specs
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import abstract_opt_state

    argv = ["--arch", TRAIN_ARCH, "--dedup", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--log-every", "1", "--seed", str(args.seed), "--ckpt-every",
            str(P16_CKPT_EVERY)]
    drill = work / "drill"
    rc, out_fail = cli_wait(cli_start(
        argv + ["--ckpt-dir", str(drill), "--fail-at", str(P16_FAIL_AT)],
        "drill", work), work)
    thirteen = sorted(set(re.findall(
        r"rank\s*:\s*(\d+) \(local_rank: \d+\)\s*\n\s*exitcode\s*:\s*13\b",
        out_fail)))
    check(rc != 0 and thirteen == ["0", "1"], f"(b) the drill returned {rc} "
          f"with ranks {thirteen} at exit code 13:\n{out_fail[-3000:]}")
    # the drill's last checkpoint moved aside: the rerun resumes from the
    # one before and writes it again
    last = P16_FAIL_AT // P16_CKPT_EVERY * P16_CKPT_EVERY
    start = last - P16_CKPT_EVERY
    name = f"step_{last:07d}"
    kept = work / f"drill_{name}"
    (drill / name).rename(kept)
    resume_run = cli_start(argv + ["--ckpt-dir", str(drill)], "resume", work)
    beside()
    rc, out_res = cli_wait(resume_run, work)
    check(rc == 0 and f"[resume] from step {start}" in out_res
          and "train: done" in out_res,
          f"(b) the rerun returned {rc}:\n{out_res[-3000:]}")

    first, resumed = step_lines(out_fail), step_lines(out_res)
    for tag, got in (("drill", first), ("resume", resumed)):
        print(f"(b) {tag}: (step, loss, gnorm, s) "
              f"{[(k,) + v for k, v in sorted(got.items())]}", flush=True)
    check(sorted(first) == list(range(1, P16_FAIL_AT + 1))
          and sorted(resumed) == list(range(start + 1, TRAIN_STEPS + 1)),
          f"(b) the drill printed {sorted(first)}, the rerun "
          f"{sorted(resumed)}")
    repeated = sorted(set(first) & set(resumed))
    check(all(resumed[s][:2] == first[s][:2] for s in repeated),
          f"(b) the rerun's steps {repeated} differ from the drill's "
          "uninterrupted ones")
    steps = {**first, **resumed}
    one = args.phase12_steps
    worst_l = worst_g = 0.0
    for s, (loss, gnorm, _) in steps.items():
        l1, g1 = one[s - 1][:2]
        worst_l = max(worst_l, abs(float(loss) - l1) / abs(l1))
        worst_g = max(worst_g, abs(float(gnorm) - g1) / abs(g1))
    check(worst_l <= TRAIN_LOSS_RTOL and worst_g <= TRAIN_GNORM_RTOL,
          f"(b) against phase 12's one rank: loss {worst_l:.3g}, gnorm "
          f"{worst_g:.3g} relative")
    with np.load(kept / "arrays.npz") as a, \
            np.load(drill / name / "arrays.npz") as b:
        check(sorted(a.files) == sorted(b.files)
              and all(np.array_equal(a[k], b[k]) for k in a.files),
              f"(b) the rerun's step-{last} checkpoint differs from the "
              "drill's")
        arrays = {k: a[k] for k in a.files}
    cfg = get_config(TRAIN_ARCH)
    abstract = M.abstract_params(cfg)
    whole = restore_checkpoint(str(drill), last,
                               {"params": abstract,
                                "opt": abstract_opt_state(abstract)},
                               device="cpu")
    params = whole["params"]
    for n, p in params.named_parameters():
        key = "params/" + n.replace(".", "/")
        if n.startswith("units."):
            u, rest = n.split(".", 2)[1:]
            key = "params/units/" + rest.replace(".", "/")
            want = arrays[key][int(u)]
        else:
            want = arrays[key]
        check(np.array_equal(p.detach().cpu().numpy(), want),
              f"(b) {n} restored with no mesh != the checkpoint")
    tiles = 0
    ranks = [CountingMesh((2,), ("data",), {"data": r}) for r in (0, 1)]
    specs = train_specs(params, ranks[0])
    for n, p in params.named_parameters():
        parts = [local_shard(p.detach(), specs[n], rank) for rank in ranks]
        dim = next((i for i, e in enumerate(specs[n]) if e), None)
        if dim is not None:
            tiles += 1
            check(torch.equal(torch.cat(parts, dim), p.detach()),
                  f"(b) {n}: the 2-rank shards do not tile the restored "
                  "tensor")
    launches = rank_launches(out_res)
    ran = TRAIN_STEPS - start
    for r, (n_steps, counts) in sorted(launches.items()):
        check(n_steps == ran
              and counts.get("flash_attention_fwd:lse") == 2 * cfg.num_layers
              * ran
              and counts.get("flash_attention_bwd") == cfg.num_layers * ran
              and counts.get("sparse_verify_batch", 0) > 0
              and not any(k.endswith(":ref") for k in counts),
              f"(b) rank {r} launches {counts}")
    check(sorted(launches) == [0, 1],
          f"(b) launch lines of ranks {sorted(launches)}")
    secs = [t for s, (_, _, t) in first.items() if s > 2]
    print(f"(b) 2 ranks, FSDP over 'data' (gloo on one card): "
          f"{TRAIN_STEPS} steps, loss and gnorm against phase 12's one rank "
          f"within {worst_l:.2e} and {worst_g:.2e} relative (limits "
          f"{TRAIN_LOSS_RTOL}, {TRAIN_GNORM_RTOL}); loop step "
          f"{statistics.median(secs) * 1e3:.0f} ms median of the drill's "
          f"steps 3-{P16_FAIL_AT}; the drill's ranks exited 13 after step "
          f"{P16_FAIL_AT}, the rerun resumed at step {start}, repeated steps "
          f"{repeated[0]}-{repeated[-1]} bit for bit and wrote the step-{last}"
          f" checkpoint's {len(arrays)} arrays as the drill did, bit for "
          f"bit; restored with no mesh bit for bit, {tiles} leaves cut by "
          f"the 2-rank placement tile it; launches over the rerun's {ran} "
          f"steps by rank { {r: c for r, (_, c) in launches.items()} }",
          flush=True)
    del whole, params
    torch.cuda.empty_cache()
    return {r: counts for r, (_, counts) in launches.items()}


def ep_config(arch: str):
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), num_layers=P16_EP_LAYERS)


def ep_batch(torch, cfg, step: int, seed: int) -> dict:
    rng = np.random.default_rng((seed, 16, step))
    toks = rng.integers(0, cfg.vocab, (P16_EP_BATCH, TRAIN_SEQ + 1),
                        dtype=np.int64).astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).cuda(),
            "targets": torch.from_numpy(toks[:, 1:].copy()).cuda()}


def ep_steps(torch, cfg, params, seed: int, mesh=None) -> dict:
    """P16_EP_STEPS train steps of ``params`` (whole, or the rank's shards
    under ``mesh``): losses, norms, step ms, the first step's MoE plans."""
    import contextlib

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step

    step = make_train_step(cfg, Hyper(warmup_steps=1,
                                      total_steps=P16_EP_STEPS))
    opt = adamw_init(params)
    out = {"loss": [], "gnorm": [], "ms": []}
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        for s in range(P16_EP_STEPS):
            batch = ep_batch(torch, cfg, s, seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if s == 0:
                (params, opt, m), out["plans"] = recorded_plans(
                    lambda: step(params, opt, batch))
            else:
                params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(float(m["loss"]))
            out["gnorm"].append(float(m["grad_norm"]))
    return out


def ep_leaves(params, cfg) -> dict:
    """P16_TP_LEAVES of the first and last layers, on the host."""
    units = params["units"]
    return {(u, b, k): units[u]["l0"][b][k].detach().float().cpu().clone()
            for u in (0, cfg.n_units - 1)
            for b, k, _ in P16_TP_LEAVES[cfg.arch_id]}


def mesh_part_ep(torch, spec, work: Path) -> dict:
    """Phase 16 (c), one rank of mesh (1, 2): each model of
    P16_TP_LEAVES in turn."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    mesh = make_mesh((1, 2), ("data", "model"))
    res = {}
    for arch in P16_TP_LEAVES:
        cfg = ep_config(arch)
        whole = M.init_params(torch.Generator(device="cuda").manual_seed(
            spec["seed"]), cfg, device="cuda")
        mine = shard_state(whole, mesh)
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh.stats.clear()
        ops.reset_kernel_stats()
        out = ep_steps(torch, cfg, mine, spec["seed"], mesh)
        launches = ops.kernel_stats()
        bad, kept = sharded_plan_mismatches(torch, out.pop("plans"), cfg)
        check(bad == 0, f"(c) {arch} rank {dist.get_rank()}: {bad} of the "
              "kept pairs differ from one rank's plan")
        out.update(kept=kept, leaves=ep_leaves(mine, cfg), launches=launches,
                   stats={k: list(v) for k, v in mesh.stats.items()},
                   peak=torch.cuda.max_memory_allocated())
        res[arch] = out
        del mine
        torch.cuda.empty_cache()
    return res


def tensor_parallel_training(torch, args, work: Path) -> dict:
    """Phase 16 (c): each model's one-rank reference here, then both
    models in two ranks; returns each model's flash launches by rank."""
    from repro_torch.models import model as M

    ref = {}
    for arch in P16_TP_LEAVES:
        cfg = ep_config(arch)
        params = M.init_params(torch.Generator(device="cuda").manual_seed(
            args.seed), cfg, device="cuda")
        before = ep_leaves(params, cfg)
        one = ep_steps(torch, cfg, params, args.seed)
        one.pop("plans")
        ref[arch] = (one, before, ep_leaves(params, cfg))
        del params
        torch.cuda.empty_cache()
    ranks = mesh_spawn(torch, args, "ep", 2, work)
    for arch, (one, before, want) in ref.items():
        cfg = ep_config(arch)
        split = {k: d for _, k, d in P16_TP_LEAVES[arch]}
        worst_w = worst_d = 0.0
        for r, res in enumerate(ranks):
            got = res[arch]
            for i in range(P16_EP_STEPS):
                check(abs(got["loss"][i] - one["loss"][i])
                      <= TRAIN_LOSS_RTOL * abs(one["loss"][i])
                      and abs(got["gnorm"][i] - one["gnorm"][i])
                      <= TRAIN_GNORM_RTOL * abs(one["gnorm"][i]),
                      f"(c) {arch} rank {r} step {i}: loss {got['loss'][i]} "
                      f"gnorm {got['gnorm'][i]}, one rank {one['loss'][i]} "
                      f"{one['gnorm'][i]}")
            for key, w in got["leaves"].items():
                dim = split[key[2]]
                n = w.shape[dim]
                check(2 * n == want[key].shape[dim], f"(c) {arch} rank {r} "
                      f"{key}: {n} of {want[key].shape[dim]} a rank")
                mine = want[key].narrow(dim, r * n, n)
                err = float((w - mine).norm() / mine.norm())
                worst_w = max(worst_w, err)
                check(err <= TRAIN_LOSS_RTOL, f"(c) {arch} rank {r} {key}: "
                      f"the updated slice {err:.3g} (relative norm) from the "
                      "one-rank slice")
                start = before[key].narrow(dim, r * n, n)
                worst_d = max(worst_d, float((w - start - (mine - start))
                                             .norm() / (mine - start).norm()))
            counts, attn = got["launches"], M.n_attention_layers(cfg)
            check(counts.get("flash_attention_fwd", 0)
                  == counts.get("flash_attention_fwd:lse", 0)
                  == 2 * attn * P16_EP_STEPS
                  and counts.get("flash_attention_bwd", 0)
                  == attn * P16_EP_STEPS
                  and not any(k.endswith(":ref") for k in counts),
                  f"(c) {arch} rank {r} launches {counts}")
        stats = ranks[0][arch]["stats"]
        what = (f"{cfg.n_experts // 2} experts a rank" if cfg.n_experts else
                f"{cfg.n_ssm_heads // 2} of {cfg.n_ssm_heads} SSM heads a "
                "rank")
        leaves = "/".join(k for _, k, _ in P16_TP_LEAVES[arch])
        masks = (f"kept masks one rank's ({ranks[0][arch]['kept']} and "
                 f"{ranks[1][arch]['kept']} pairs kept); " if cfg.n_experts
                 else "")
        print(f"(c) {arch} tensor parallel over 2 model ranks: "
              f"{tp_placement(cfg, 2)}; flash launches by rank over "
              f"{P16_EP_STEPS} steps {[r[arch]['launches'] for r in ranks]}",
              flush=True)
        print(f"(c) {arch} cut to {P16_EP_LAYERS} layers, mesh (1, 2), "
              f"{what}, {P16_EP_STEPS} steps of {P16_EP_BATCH} x {TRAIN_SEQ}"
              f": {masks}losses "
              f"{[round(x, 4) for x in ranks[0][arch]['loss']]} (one rank "
              f"{[round(x, 4) for x in one['loss']]}), gnorms "
              f"{[round(x, 4) for x in ranks[0][arch]['gnorm']]} (one rank "
              f"{[round(x, 4) for x in one['gnorm']]}); the updated {leaves}"
              f" shards within {worst_w:.2e} of the one-rank slices (relative"
              f" norm), their updates within {worst_d:.2e}; step ms "
              f"{[round(x, 1) for x in ranks[0][arch]['ms']]} (one rank "
              f"{[round(x, 1) for x in one['ms']]}); peak a rank "
              f"{max(r[arch]['peak'] for r in ranks) / 2**30:.2f} GiB; "
              f"collectives of {P16_EP_STEPS} steps on rank 0 (calls, bytes, "
              f"host s): "
              f"{ {k: [v[0], v[1], round(v[2], 3)] for k, v in stats.items()} }",
              flush=True)
    return {arch: {r: res[arch]["launches"] for r, res in enumerate(ranks)}
            for arch in P16_TP_LEAVES}


def mesh_training(torch, args, start_counts=lambda: None) -> dict:
    """Phase 16: (a)–(c) (the comment above P16_FAIL_AT).  The train_4k
    counts need no card: they run beside (b) and (c), whose seconds are
    mostly process start-up and gloo, and so do phase 17's
    (``start_counts``); nothing else timed runs beside them.  Returns each rank's launches in (b)'s resumed run and in
    (c)."""
    import shutil

    work = ROOT / "build" / f"chip_smoke_train_mesh_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    counts = counted = None
    ep: dict = {}
    try:
        t0 = time.perf_counter()
        dryrun_against_card(torch, args)
        print(f"(a: {time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        counts, counted = dryrun_counts()
        start_counts()

        def tensor_parallel():
            t1 = time.perf_counter()
            ep.update(tensor_parallel_training(torch, args, work))
            print(f"(c: {time.perf_counter() - t1:.1f} s, beside (b)'s "
                  "runs)", flush=True)
        launches = data_parallel_cli(torch, args, work, tensor_parallel)
        print(f"(b and c: {time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        try:
            rc = counts.wait(timeout=P16_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            counts.kill()
            rc = counts.wait()
        out = (counted / "dryrun.log").read_text()
        check(rc == 0, f"(a) the train_4k counts returned {rc}:\n"
              f"{out[-3000:]}")
        from repro_torch.configs.registry import all_cells
        archs = [a for a, shape in all_cells() if shape == "train_4k"]
        for arch in archs:
            rec = json.loads((counted / "dryrun" /
                              f"16x16__{arch}__train_4k.json").read_text())
            check(rec["status"] == "ok", f"(a) {arch}: {rec.get('error')}")
            check("dense_replicated_over_model" not in rec,
                  f"(a) {arch}: the dense layers replicated over 'model'")
            r, tp = rec["roofline"], rec["tensor_parallel"]
            print(f"(a) {arch} train_4k at 16x16, rank 0 (counted on meta "
                  f"in {rec['trace_s']} s): "
                  f"{rec['memory']['total_bytes'] / 1e9:.1f} GB a rank "
                  f"(arguments {rec['memory']['argument_bytes'] / 1e9:.2f}), "
                  f"dense leaves over 'model' {tp['dense_leaves_split']} "
                  f"split / {tp['dense_leaves_whole']} whole, fits "
                  f"{rec['fits']}, bottleneck {r['bottleneck']} (Tc "
                  f"{r['t_compute_s']:.3f} s, Tm {r['t_memory_s']:.3f} s, "
                  f"Tcoll {r['t_collective_s']:.3f} s), "
                  f"{rec['num_microbatches']} microbatches, useful FLOPs "
                  f"{r['useful_flops_ratio']:.3f}", flush=True)
        print(f"(a) the {len(archs)} train_4k counts waited on: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if counts is not None and counts.poll() is None:
            counts.kill()
            counts.wait()
        shutil.rmtree(work, ignore_errors=True)
        if counted is not None:
            shutil.rmtree(counted, ignore_errors=True)
    return {"b": launches, "c": ep}


# Phase 17, the families trained: mamba2-1.3b (SSD under autograd and
# remat), hubert-xlarge (the encoder: D 80, not causal),
# granite-moe-3b-a800m (all 32 layers: the MoE dispatch's backward) and
# zamba2-2.7b (the hybrid's shared block: D 80, causal) at their published
# width and depth, each through launch.train.main as phase 12 (c) trains
# smollm-135m (f32 masters, bf16 compute, remat, AdamW; no --dedup: phase
# 12 drives the pipeline), P17_STEPS steps of P17_BATCH x P17_SEQ tokens
# (hubert: frames, a multiple of 1,024: F2) from --seed, the weights drawn
# on the card (--device-init: a CPU generator's draws of the four
# families' 8.2 B weights take minutes).  Each step is first counted by
# launch.dryrun at mesh (1, 1) (a process of its own, --count-child,
# started beside phase 16 (b) and read here); where the counted peak
# passes P17_PEAK the batch is halved, never the width or the depth, and
# the step takes the count's microbatches (the reference's remat-stash
# rule, STASH_BUDGET).  Flash launches a step: two forwards with lse (one
# recomputed under remat) and one backward for each attention layer a
# microbatch runs.  One step is held against a plain path on the same
# parameters (drawn again from the seed once the run's are freed: one
# model at a time) and batch 0: attn_impl="ref" for the three with
# attention, under phase 12's TRAIN_LOSS_RTOL / TRAIN_GNORM_RTOL; mamba2,
# which launches no kernel, against float32 compute.  That distance is
# the compute copy's rounding itself, as between phase 12's two bf16
# paths: every matmul operand rounded to bf16's 8 significant bits (2^-9
# relative) once, the loss a mean of 16,384 tokens' NLLs whose roundings
# fall either way, the gradient norm a sum of 1.3 B squares whose
# roundings do too; so the same limits, 2^-7 and 2^-5 relative.  Then
# rows 6l and 7 at the two D 80 training shapes (a microbatch's rows, the
# model's strided views): held against their plain versions, timed beside
# the bound and SDPA.
P17_ARCHS = ["mamba2-1.3b", "hubert-xlarge", "granite-moe-3b-a800m",
             "zamba2-2.7b"]
P17_BATCH, P17_SEQ, P17_STEPS = 8, 2048, 3
P17_PEAK = 72e9
P17_COUNT_TIMEOUT_S = 300


def count_child(work: Path) -> int:
    """Phase 17's counts, in a process of its own: each family's step at
    mesh (1, 1) on ``meta`` tensors (``launch.dryrun.trace_cell``), the
    batch halved while the counted peak passes P17_PEAK; one JSON file a
    family under ``work``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import CountingMesh
    from repro_torch.models.config import ShapeConfig

    for arch in P17_ARCHS:
        cfg, batch, tried = get_config(arch), P17_BATCH, []
        while True:
            shape = ShapeConfig("phase17", P17_SEQ, batch, "train")
            rec, cost = trace_cell(arch, shape.name, CountingMesh(
                (1, 1), ("data", "model")), cfg=cfg, shape=shape)
            tried.append([batch, rec["memory"]["total_bytes"]])
            if rec["memory"]["total_bytes"] <= P17_PEAK or batch == 1:
                break
            batch //= 2
        out = {"batch": batch, "tried": tried,
               "mb": rec["num_microbatches"], "memory": rec["memory"],
               "flops": cost.flops, "trace_s": rec["trace_s"],
               "kernels": {k: v[0] for k, v in cost.kernels.items()}}
        tmp = work / f"{arch}.json.tmp"
        tmp.write_text(json.dumps(out))
        os.replace(tmp, work / f"{arch}.json")      # read whole or not at all
    return 0


def count_start():
    """Start ``count_child`` under a temporary ``build/`` directory (no
    card touched, one host thread).  Returns (the process, the
    directory)."""
    work = ROOT / "build" / f"chip_smoke_p17_counts_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(mesh_env(), OMP_NUM_THREADS="1")
    log = open(work / "count.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--count-child",
         str(work)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, work


def count_read(counts, arch: str) -> dict:
    """The count of ``arch`` from ``count_start``'s process, waited for."""
    proc, work = counts
    path = work / f"{arch}.json"
    deadline = time.perf_counter() + P17_COUNT_TIMEOUT_S
    while not path.exists():
        check(proc.poll() in (None, 0) and time.perf_counter() < deadline,
              f"phase 17's count of {arch}: rc {proc.poll()}:\n"
              f"{(work / 'count.log').read_text()[-3000:]}")
        time.sleep(0.2)
    return json.loads(path.read_text())


def train_family(torch, args, ops, arch: str, plan: dict) -> dict:
    """Phase 17, one family: P17_STEPS steps through ``launch.train.main``
    at ``plan``'s batch and microbatches, the flash launches against the
    config's, one step against the plain path, the peak beside the count.
    Returns the run's launches and the microbatch's shape."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = get_config(arch)
    B, mb = plan["batch"], plan["mb"]
    n_attn = M.n_attention_layers(cfg)
    tokens = B * P17_SEQ
    argv = ["--arch", arch, "--steps", str(P17_STEPS), "--batch", str(B),
            "--seq", str(P17_SEQ), "--microbatches", str(mb), "--log-every",
            "1", "--seed", str(args.seed), "--device-init"]
    routed = 2 * cfg.num_layers * mb if cfg.n_experts else 0
    full = {}

    def on_step(step, metrics):
        full[step] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_kernel_stats()                       # the main path's window
    t0 = time.perf_counter()
    rc, r_kern = record_routes(lambda: train.main(argv, on_step=on_step),
                               limit=routed)
    run_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    check(rc == 0 and sorted(full) == list(range(P17_STEPS)),
          f"{arch}: launch.train returned {rc} after steps {sorted(full)}")
    losses = [full[s][0] for s in range(P17_STEPS)]
    norms = [full[s][1] for s in range(P17_STEPS)]
    check(all(np.isfinite(losses + norms)), f"{arch}: losses {losses} "
          f"gnorms {norms}")
    fwd, bwd = 2 * n_attn * mb * P17_STEPS, n_attn * mb * P17_STEPS
    want = ({"flash_attention_fwd": fwd, "flash_attention_fwd:lse": fwd,
             "flash_attention_fwd:bf16": fwd, "flash_attention_bwd": bwd,
             "flash_attention_bwd:bf16": bwd} if n_attn else {})
    check(launches == want, f"{arch}: launches {launches}, want {want} "
          f"({n_attn} attention layers, {mb} microbatches, remat)")
    stamps = [t0] + [full[s][2] for s in range(P17_STEPS)]
    loop_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_ms = statistics.median(loop_ms[1:])
    mem = plan["memory"]
    print(f"{arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_attn} attention layers a microbatch): {P17_STEPS} steps of "
          f"{B} x {P17_SEQ} in {mb} microbatches in {run_s:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; a step {step_ms:.1f} ms after "
          f"the first ({[round(x, 1) for x in loop_ms]}), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated above "
          f"{base / 2**30:.2f}) against the count's "
          f"{mem['total_bytes'] / 2**30:.2f} GiB (arguments "
          f"{mem['argument_bytes'] / 2**30:.2f} + live "
          f"{mem['temp_bytes'] / 2**30:.2f}; counted at batch "
          f"{[b for b, _ in plan['tried']]}: "
          f"{[round(t / 1e9, 1) for _, t in plan['tried']]} GB, "
          f"{plan['trace_s']} s); launches {launches}", flush=True)

    # one step on the plain path: the same weights, batch 0
    p0 = M.init_params(torch.Generator(device="cuda").manual_seed(args.seed),
                       cfg, device="cuda")
    batch = SketchDedupPipeline(DataConfig(
        vocab=cfg.vocab, batch=B, seq=P17_SEQ, seed=args.seed, dedup=False,
        embeds_dim=cfg.d_model if cfg.inputs_embeds else 0),
        device="cuda").batch_for_step(0)
    if n_attn:
        plain, what = dataclasses.replace(cfg, attn_impl="ref"), \
            "attn_impl='ref'"
        dtype = torch.bfloat16
    else:
        plain, what, dtype = cfg, "float32 compute", torch.float32
    step = make_train_step(plain, Hyper(warmup_steps=2,
                                        total_steps=P17_STEPS),
                           num_microbatches=mb, compute_dtype=dtype)
    ops.reset_kernel_stats()
    t1 = time.perf_counter()
    (_, _, m), r_plain = record_routes(
        lambda: step(p0, adamw_init(p0), batch), limit=routed)
    l_p, g_p = float(m["loss"]), float(m["grad_norm"])
    plain_s = time.perf_counter() - t1
    check(ops.kernel_stats() == {}, f"{arch}: the plain path launched "
          f"{ops.kernel_stats()}")
    (l_k, g_k) = full[0][:2]
    print(f"{arch} step 1, the run's against {what} ({plain_s:.1f} s): "
          f"loss {l_k:.6f} vs {l_p:.6f} (|diff| / loss "
          f"{abs(l_k - l_p) / abs(l_p):.3g}, limit {TRAIN_LOSS_RTOL:.3g}), "
          f"grad norm {g_k:.5f} vs {g_p:.5f} (|diff| / norm "
          f"{abs(g_k - g_p) / abs(g_p):.3g}, limit {TRAIN_GNORM_RTOL:.3g})",
          flush=True)
    check(abs(l_k - l_p) <= TRAIN_LOSS_RTOL * abs(l_p)
          and abs(g_k - g_p) <= TRAIN_GNORM_RTOL * abs(g_p),
          f"{arch}: kernel path loss {l_k} gnorm {g_k} vs {what} {l_p} "
          f"{g_p}")
    if cfg.n_experts:
        check(len(r_kern) == len(r_plain) == routed,
              f"{arch}: {len(r_kern)} / {len(r_plain)} routings recorded, "
              f"want {routed}")
        differ = routing_differences(torch, r_kern, r_plain, cfg.n_experts)
        pairs = routed * (tokens // mb) * cfg.top_k
        print(f"{arch} step 1's MoE routing (forward and recompute): "
              f"{differ} of {pairs} (token, slot) routings differ between "
              f"the kernel and plain paths ({differ / pairs:.4%})",
              flush=True)
    del p0, batch, step, m, r_kern, r_plain
    torch.cuda.empty_cache()
    return {"launches": launches, "shape": (B // mb, cfg.n_heads,
                                            P17_SEQ, cfg.head_dim,
                                            cfg.causal)}


def check_d80_train(torch, ops, ref, dev, gen, err, B: int, H: int, S: int,
                    D: int, causal: bool) -> dict:
    """Rows 6l and 7 at a D 80 training shape (the model's strided views
    of (B, S, H, D)): the forward's output and lse and the backward
    against their plain versions (bf16 tiles; BWD_BF16_RTOL; the backward
    twice, for the same bits), then each timed beside its bound, its
    plain version and SDPA; the backward also 20 calls queued (beside
    SDPA's backward, queued) and each of its two passes alone, queued."""
    import torch.nn.functional as F

    def views():
        return (torch.randn((B, S, H, D), device=dev, generator=gen)
                .bfloat16().transpose(1, 2) for _ in range(4))

    q, k, v, do = views()
    what = f"B={B} H={H} S={S} D={D} bf16 causal={causal}"
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
    out_r, lse_r = ref.flash_attention_ref(q, k, v, causal=causal,
                                           return_lse=True)
    e_out = float((out.float() - out_r.float()).abs().max())
    e_lse = float((lse - lse_r).abs().max())
    err["flash_attention_fwd_lse"] = max(err["flash_attention_fwd_lse"],
                                         e_lse)
    check(e_out <= 2e-2 and e_lse <= 1e-4, f"lse forward {what}: max err "
          f"{e_out} (out), {e_lse} (lse)")
    del out_r, lse_r
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       tile_bf16=True)
    errs = []
    for a, b, w, name in zip(got, again, want, ("dq", "dk", "dv")):
        check(torch.equal(a, b), f"{name} {what}: two runs differ")
        e = float((a.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        err["flash_attention_bwd"] = max(err["flash_attention_bwd"], e)
        check(e <= BWD_BF16_RTOL * top and bool(torch.isfinite(a).all()),
              f"{name} {what}: max err {e} (largest {top})")
        errs.append(e)
    del got, again, want
    from repro_torch.kernels import _build
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    _, args_ = ops.flash_bwd_args(q, k, v, out, lse, do, causal=causal,
                                  window=0, cap=0.0, scale=D ** -0.5,
                                  q_offset=0, tile_bf16=False)

    def one_pass(passes):
        code = lib.flash_attention_bwd_launch(*args_, passes, stream)
        check(code == 0, f"flash_attention_bwd_launch passes={passes}: {code}")

    # each pass alone, 20 launches queued: the device's time of each
    dq_ms = queued_ms(torch, lambda: one_pass(1))
    dkdv_ms = queued_ms(torch, lambda: one_pass(2))
    del args_
    fwd_ms = time_ms(torch, lambda: ops.flash_attention_fwd(
        q, k, v, causal=causal, return_lse=True))
    bwd_ms = time_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal))
    bwd_queued = queued_ms(torch, lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, causal=causal))
    fwd_plain = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, return_lse=True), iters=3)
    bwd_plain = time_ms(torch, lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal), iters=3)
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
    qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa_fwd_ag = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=causal))
    sdpa_total = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=causal).backward(do))
    sdpa_bwd_queued = queued_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, is_causal=causal).backward(do)) - queued_ms(
        torch, lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=causal))
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    elems = B * H * S * D
    fwd_bound, fwd_by = max_bound(4 * pairs * D,
                                  2 * 4 * elems + 4 * B * H * S)
    bwd_bound, bwd_by = max_bound(10 * pairs * D,
                                  2 * 8 * elems + 4 * B * H * S)
    print(f"flash at {what} (strided views): lse forward {fwd_ms:.4f} ms, "
          f"bound {fwd_bound:.4f} ({fwd_by}), plain {fwd_plain:.3f}, SDPA "
          f"{sdpa_fwd:.4f}; backward {bwd_ms:.4f} ms, bound "
          f"{bwd_bound:.4f} ({bwd_by}), plain {bwd_plain:.3f}, SDPA's "
          f"backward {sdpa_total - sdpa_fwd_ag:.4f}; queued: backward "
          f"{bwd_queued:.4f} ms a call (dq pass {dq_ms:.4f}, dk/dv pass "
          f"{dkdv_ms:.4f}), SDPA's backward {sdpa_bwd_queued:.4f}; max err "
          f"out {e_out:.3g}, lse {e_lse:.3g}, dq/dk/dv "
          f"{'/'.join(f'{e:.3g}' for e in errs)}", flush=True)
    del q, k, v, do, out, lse, qq, kk, vv
    torch.cuda.empty_cache()
    shape = {"B": B, "H": H, "S": S, "D": D, "causal": causal}
    return {"lse": {"shape": shape, "ms": fwd_ms, "plain_ms": fwd_plain,
                    "bound_ms": fwd_bound, "bound_by": fwd_by,
                    "library_ms": sdpa_fwd},
            "bwd": {"shape": shape, "ms": bwd_ms, "plain_ms": bwd_plain,
                    "bound_ms": bwd_bound, "bound_by": bwd_by,
                    "library_ms": sdpa_total - sdpa_fwd_ag,
                    "queued_ms": bwd_queued,
                    "library_queued_ms": sdpa_bwd_queued,
                    "dq_ms": dq_ms, "dkdv_ms": dkdv_ms}}


def family_training(torch, args, ops, ref, dev, gen, err, counts) -> dict:
    """Phase 17: the families trained at full width (the comment above
    P17_ARCHS) on ``count_start``'s counts, then rows 6l and 7 at their
    D 80 training shapes.  Returns each family's launches and the rows'
    D 80 fields."""
    out = {"launches": {}, "d80": {}}
    for arch in P17_ARCHS:
        t0 = time.perf_counter()
        got = train_family(torch, args, ops, arch, count_read(counts, arch))
        out["launches"][arch] = got["launches"]
        B, H, S, D, causal = got["shape"]
        if D == 80:
            out["d80"][arch] = (B, H, S, D, causal)
        print(f"({arch}: {time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    for arch, shape in out["d80"].items():
        out["d80"][arch] = check_d80_train(torch, ops, ref, dev, gen, err,
                                           *shape)
    print(f"(rows 6l and 7 at D 80: {time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


# Phase 18, the registry's three largest dense architectures and its one
# MoE too large for phase 13's f32 masters, served whole: gemma2-27b (the
# only local/global stack: 23 layers at window 4,096 with a rolling cache
# of 4,096 slots, 23 global, the attention softcap 50 in every layer, the
# final softcap 30, post norms, gelu, sqrt(4,608) embedding scale, a
# 256,000-row tied head) at its published context, 2 requests of 8,144
# prompt tokens + 48 greedy (s_max 8,192, so the window bites at every
# position past 4,096); command-r-35b (256,000-row tied head),
# chameleon-34b and deepseek-moe-16b (28 layers of 64 routed experts,
# top-6, and 2 shared, capacity factor 1.25, a 102,400-row head) at phase
# 7's requests.  bf16 parameters drawn on the card at full width and depth
# (54.5 / 60.6 / 68.6 / 33.8 GB: none fits beside an f32 copy), one model
# at a time on a card the earlier phases have emptied (under
# LARGE_HELD_MAX held before the first draw).  Each: (a) the serving path
# through launch.serve.generate, its flash launches a prefill (every
# attention layer, :bf16, none :ref) and gemma2's window and cap a call;
# (b) the flash wrapper at the model's prefill shape against
# blockwise_attention (phase 13's check; chameleon's attention shape is
# command-r's, held once); (c) phase 7's second rule on LARGE_F32_ROWS
# requests (gemma2: both; the others: 0-1, a cut): the kernel path's
# prefill logits against the streamed f32 plain path, beside the bf16
# attn_impl="ref" path, and the greedy first tokens equal wherever the f32
# path's top-2 margin exceeds LOGIT_RTOL of its largest logit; for
# deepseek all three paths prefill those requests alone (the capacity is
# the batch's), and the routings that differ between them (per layer
# between the kernel and plain paths) and the dropped (token, slot) pairs
# are printed, as phase 13 prints granite's; (e) prefill ms (median of 3
# after the first call), decode ms a step over (a)'s SERVE_GEN - 1 steps,
# the parameter bytes and the peak above the base, one profiled prefill;
# then, for gemma2 and deepseek once their parameters are freed, (d)
# prefill-then-decode against the full forward at FAMILY_CONSISTENCY_TOL
# (phase 13's rule, deepseek at the lossless capacity factor E / top_k)
# on LARGE_RING_UNITS units at full width with f32 masters: request 0's
# served tokens (gemma2 8,192, deepseek 2,048), all but the last
# prefilled with an f32 cache, the last decoded (gemma2's at position
# 8,191 overwrites slot 4,095 of each local layer's ring).
LARGE_MODELS = [("gemma2-27b", 2, 8144),
                ("command-r-35b", SERVE_BATCH, SERVE_PROMPT),
                ("chameleon-34b", SERVE_BATCH, SERVE_PROMPT),
                ("deepseek-moe-16b", SERVE_BATCH, SERVE_PROMPT)]
LARGE_CONSISTENCY = ("gemma2-27b", "deepseek-moe-16b")
LARGE_F32_ROWS = 2
LARGE_RING_UNITS = 2
LARGE_HEAD_ROWS = 1 << 15     # head rows a float32 chunk (≈ 0.6-1.1 GB)
LARGE_HELD_MAX = 1 << 30


def streamed_prefill_f32(params, cfg, batch: dict,
                         head_rows: int = LARGE_HEAD_ROWS,
                         moe_groups: int = 1):
    """``M.prefill``'s last-position logits (B, vocab) with
    ``attn_impl="ref"`` in float32, for parameters too large to copy whole
    to float32: the embedding rows the tokens use, then one unit's leaves
    at a time, then the head ``head_rows`` vocabulary rows at a time, each
    cast to float32 and dropped before the next, through the functions
    ``M.prefill`` calls (``embed_inputs``, ``_attn_layer`` per
    ``_layer_kind``, ``_lm_logits``).  Token stacks of attention layers,
    dense or MoE (no SSM, no frame embeddings): an MoE layer routes and
    drops as ``M.prefill``'s does at the same ``moe_groups`` (both
    default to one group over the batch) and the config's capacity
    factor, through ``_attn_layer``'s own dispatch."""
    import dataclasses

    import torch
    from repro_torch.models import model as M

    if cfg.ssm or cfg.inputs_embeds:
        raise ValueError(f"{cfg.arch_id}: the streamed path runs token "
                         "stacks of attention layers only (dense or MoE)")
    cfg = dataclasses.replace(cfg, attn_impl="ref")

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    with torch.no_grad():
        rows, tokens = torch.unique(batch["tokens"].long(),
                                    return_inverse=True)
        x = M.embed_inputs({"embed": params["embed"][rows].float()}, cfg,
                           {"tokens": tokens})
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
        for unit in params["units"]:
            unit = f32(unit.tree())
            for pos in range(cfg.period):
                x, _ = M._attn_layer(unit[f"l{pos}"], x, cfg,
                                     M._layer_kind(cfg, pos),
                                     positions=positions,
                                     moe_groups=moe_groups)
            del unit
        x = x[:, -1:]
        top = {"final_norm": params["final_norm"].float()}
        parts = []
        for lo in range(0, cfg.vocab, head_rows):
            if "lm_head" in params:
                top["lm_head"] = params["lm_head"][:, lo:lo + head_rows].float()
            else:
                top["embed"] = params["embed"][lo:lo + head_rows].float()
            parts.append(M._lm_logits(top, cfg, x))
        return torch.cat(parts, -1)[:, 0]


def record_flash(fn):
    """Run ``fn`` with the (window, cap) of every ``ops.flash_attention_fwd``
    call counted (``models/flash.py`` calls it through the module)."""
    from collections import Counter

    from repro_torch.kernels import ops
    seen, fwd = Counter(), ops.flash_attention_fwd

    def recording(q, k, v, **kw):
        seen[(int(kw.get("window", 0)), float(kw.get("cap", 0.0)))] += 1
        return fwd(q, k, v, **kw)

    ops.flash_attention_fwd = recording
    try:
        out = fn()
    finally:
        ops.flash_attention_fwd = fwd
    return out, seen


def release_card(torch) -> int:
    """Drop what the earlier phases left pinned (the searcher and fused
    program caches hold their indexes) and return the bytes still held;
    where that passes LARGE_HELD_MAX, print the largest live blocks on
    the card, with the Python frames that allocated them where the
    allocator records its history."""
    import gc

    import importlib

    from repro_torch.core import clear_mi_searcher_cache, clear_searcher_cache
    segments = importlib.import_module("repro_torch.core.segments")
    clear_searcher_cache()
    clear_mi_searcher_cache()
    segments.clear_fused_cache()
    segments._SHARDED_SEARCHER_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held >= LARGE_HELD_MAX:
        blocks = [b for seg in torch.cuda.memory._snapshot()["segments"]
                  for b in seg["blocks"] if b["state"] == "active_allocated"]
        for b in sorted(blocks, key=lambda b: -b["size"])[:12]:
            frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in b.get("frames", [])
                      if "repro_torch" in f["filename"]
                      or f["filename"].endswith("chip_smoke.py")]
            print(f"  held: {b['size'] / 2**20:.1f} MiB allocated at "
                  f"{frames[:6] or 'no recorded frame'}", flush=True)
    return held


def unit_consistency(torch, args, arch: str, seq) -> None:
    """Phase 18 (d): ``arch`` at full width cut to LARGE_RING_UNITS units
    (f32 masters, drawn on the card; an MoE at the lossless capacity
    factor E / top_k): prefill ``seq`` (1, S) but its last token into an
    f32 cache of S slots (gemma2's local layers' rings of ``window`` slots
    wrapped), decode that token at position S - 1, and hold the logits
    against ``M.forward`` at that position."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    base = get_config(arch)
    cfg = dataclasses.replace(base, num_layers=LARGE_RING_UNITS * base.period)
    lossless = ""
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
        lossless = f", capacity factor {cfg.capacity_factor}"
    f32 = torch.float32
    params = M.init_params(torch.Generator(device="cuda").manual_seed(
        args.seed + 181), cfg, device="cuda")
    S = seq.shape[1]
    _, cache, n = M.prefill(params, cfg, {"tokens": seq[:, :-1]}, s_max=S,
                            cache_dtype=f32)
    slots = {M._layer_kind(cfg, pos): cache[0][f"l{pos}"][0].shape[1]
             for pos in range(cfg.period)}
    want = {kind: min(cfg.window, S) if kind == "local" else S
            for kind in slots}
    check(slots == want, f"{arch}: cache slots {slots}, want {want} (a "
          f"{cfg.window}-slot ring for local layers)")
    ring = (f"ring slot {n % cfg.window} of {cfg.window}; "
            if "local" in slots else "")
    dec, _ = M.decode_step(params, cfg, seq[:, -1:], cache, n)
    del cache
    with torch.no_grad():
        full = M.forward(params, cfg, {"tokens": seq})[:, -1].clone()
    diff = (dec - full).abs()
    lim = FAMILY_CONSISTENCY_TOL * (1 + full.abs())
    print(f"(d) {arch} cut to {cfg.num_layers} layers (f32{lossless}): "
          f"prefill {n} + decode 1 at position {n} ({ring}slots {slots}) vs "
          f"the full forward: max |diff| {float(diff.max()):.3g}, max "
          f"|logit| {float(full.abs().max()):.3f}, worst diff / (2e-2 + "
          f"2e-2 |logit|) {float((diff / lim).max()):.3f}", flush=True)
    check(bool((diff <= lim).all()), f"{arch}: prefill-then-decode differs "
          "from the full forward by more than 2e-2 + 2e-2 |logit|")
    del params, dec, full


def timed_decode(torch, fn):
    """Run ``fn``, a ``launch.serve.generate`` call, with its decode steps
    timed (``serve.make_decode_step`` wrapped: the card synchronised
    before the first step and after ``fn``).  Returns (``fn``'s result,
    the steps, their ms a step)."""
    from repro_torch.launch import serve
    make, state = serve.make_decode_step, {"steps": 0}

    def making(cfg, **kw):
        step = make(cfg, **kw)

        def timed(*a, **k):
            if not state["steps"]:
                torch.cuda.synchronize()
                state["t0"] = time.perf_counter()
            state["steps"] += 1
            return step(*a, **k)
        return timed

    serve.make_decode_step = making
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        serve.make_decode_step = make
    n = state["steps"]
    return out, n, ((time.perf_counter() - state["t0"]) * 1e3 / n if n
                    else 0.0)


def serve_large(torch, args, dev, ops, arch: str, B: int, S: int, err: dict,
                held: dict) -> int:
    """Phase 18, one model ((a)-(e) of the comment above LARGE_MODELS);
    ``held`` maps each attention shape already held against
    ``blockwise_attention`` to its model.  Returns the flash launches of a
    prefill."""
    import dataclasses
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    G, s_max, bf16 = SERVE_GEN, S + SERVE_GEN, torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(
        args.seed + 180), cfg, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_bytes = param_bytes(params)
    rng = np.random.default_rng(args.seed + 18)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                               .astype(np.int32)).to(dev)
    n_attn = M.n_attention_layers(cfg)
    kinds = [M._layer_kind(cfg, pos) for pos in range(cfg.period)]
    n_local = kinds.count("local") * cfg.n_units
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared} "
           f"shared (d_ff {cfg.moe_d_ff}), capacity factor "
           f"{cfg.capacity_factor}" if cfg.n_experts else "")
    print(f"{arch}: {cfg.num_layers} layers ({n_local} local at window "
          f"{cfg.window}), d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv} x {cfg.head_dim}, d_ff {cfg.d_ff}{moe}, vocab "
          f"{cfg.vocab} (tied {cfg.tie_embeddings}), softcaps "
          f"{cfg.softcap_attn} / "
          f"{cfg.softcap_final}: {n_bytes / 1e9:.2f} GB of bf16 parameters "
          f"drawn on the card in {draw_s:.1f} s; {B} requests x {S} prompt "
          f"tokens + {G} greedy (s_max {s_max})", flush=True)

    # (a) the serving path, its decode steps timed (e)
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    ((tokens, logits), steps, decode_ms), windows = record_flash(
        lambda: timed_decode(torch, lambda: generate(
            params, cfg, prompts, G, s_max=s_max, compute_dtype=bf16)))
    serve_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    want_w = {(cfg.window if kind == "local" else 0, cfg.softcap_attn):
              kinds.count(kind) * cfg.n_units for kind in set(kinds)}
    print(f"(a) serving path: {serve_s:.2f} s (first call), launches "
          f"{launches}, flash calls by (window, cap) {dict(windows)}",
          flush=True)
    check(launches == {"flash_attention_fwd": n_attn,
                       "flash_attention_fwd:bf16": n_attn},
          f"{arch}: launches per prefill {launches}, want {n_attn} through "
          "the bf16 kernel")
    check(dict(windows) == want_w, f"{arch}: flash calls by (window, cap) "
          f"{dict(windows)}, want {want_w}")
    check(steps == G - 1, f"{arch}: {steps} decode steps, want {G - 1}")
    check(tokens.shape == (B, G) and bool(((tokens >= 0)
                                           & (tokens < cfg.vocab)).all()),
          f"{arch}: generated tokens {tuple(tokens.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: logits not finite")

    # (b) the flash wrapper at the model's prefill shape
    t0 = time.perf_counter()
    shape = (B, S, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.causal,
             cfg.window if "local" in kinds else 0, cfg.softcap_attn)
    if shape in held:
        print(f"(b) {arch}: the attention shape of {held[shape]} (B {B}, S "
              f"{S}, heads {cfg.n_heads}/{cfg.n_kv} x {cfg.head_dim}), held "
              "there", flush=True)
    else:
        check_family_flash(torch, dev, cfg, arch, args.seed + 182, err, B=B,
                           S=S)
        held[shape] = arch
    flash_s = time.perf_counter() - t0

    # (c) the kernel path against the plain paths on LARGE_F32_ROWS requests
    # (an MoE's capacity is the batch's: all three prefill the rows alone)
    rows = {"tokens": prompts[:LARGE_F32_ROWS]}
    t0 = time.perf_counter()
    if cfg.n_experts:
        (lk, _, _), r_k = record_routes(lambda: M.prefill(
            params, cfg, rows, s_max=s_max))
    else:
        lk = logits[:LARGE_F32_ROWS]
    ops.reset_kernel_stats()
    (lr, _, _), r_r = record_routes(lambda: M.prefill(
        params, dataclasses.replace(cfg, attn_impl="ref"), rows,
        s_max=s_max))
    check(ops.kernel_stats() == {}, f"{arch}: the ref path launched "
          f"{ops.kernel_stats()}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l32, r_32 = record_routes(lambda: streamed_prefill_f32(params, cfg, rows))
    torch.cuda.synchronize()
    ref_s, f32_s = t1 - t0, time.perf_counter() - t1
    what = f"(c) {arch}, requests 0-{LARGE_F32_ROWS - 1}"
    print(second_rule(torch, lk, lr, l32, what, "the bf16 plain path")
          + f"; max |logit| {float(l32.abs().max()):.3f}", flush=True)
    print(hold_steps(torch, [lk], [l32], f"{what}, first tokens against the "
                     "f32 plain path"), flush=True)
    if cfg.n_experts:
        print(f"(c) {arch}: " + moe_routing(torch, cfg, arch, r_k, r_r, r_32),
              flush=True)
        del r_k
    del lr, l32, lk, r_r, r_32

    # (e) times and memory
    def prefill_once():
        return M.prefill(params, cfg, {"tokens": prompts}, s_max=s_max)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() - base_mem
    print(f"(e) {arch} prefill ({B} x {S} tokens): {prefill_ms:.2f} ms "
          f"median of 3 ({sorted(round(x, 2) for x in times)}), "
          f"{B * S / prefill_ms * 1e3:.0f} prompt tokens/s; decode "
          f"{decode_ms:.3f} ms a step (batch {B}, the {steps} steps of (a));"
          f" parameters {n_bytes / 2**30:.3f} GiB; peak {peak / 2**30:.3f} "
          f"GiB above the {base_mem / 2**30:.3f} GiB held before the draw; "
          f"(b) {flash_s:.1f} s, (c) the bf16 plain path {ref_s:.1f} s, the "
          f"streamed f32 path {f32_s:.1f} s", flush=True)
    profile_window(torch, f"(e) {arch} prefill", prefill_once, calls=1)
    seq = torch.cat([prompts[:1], tokens[:1]], 1)
    del params, prompts, tokens, logits
    gc.collect()
    torch.cuda.empty_cache()
    if arch in LARGE_CONSISTENCY:
        t0 = time.perf_counter()
        unit_consistency(torch, args, arch, seq)
        torch.cuda.empty_cache()
        print(f"((d): {time.perf_counter() - t0:.1f} s)", flush=True)
    return n_attn


def large_models(torch, args, dev, ops, err: dict) -> dict:
    """Phase 18 (the comment above LARGE_MODELS).  Returns each model's
    flash launches a prefill."""
    held = release_card(torch)
    print(f"phase 18 starts with {held / 2**30:.3f} GiB held by this "
          f"process (limit {LARGE_HELD_MAX / 2**30:.0f} GiB)", flush=True)
    check(held < LARGE_HELD_MAX, f"phase 18: {held} bytes held on the card "
          "before the first draw")
    out, shapes = {}, {}
    for arch, B, S in LARGE_MODELS:
        t0 = time.perf_counter()
        out[arch] = serve_large(torch, args, dev, ops, arch, B, S, err,
                                shapes)
        print(f"({arch}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--count-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    if args.crash_child:                 # phase 11's child process
        return crash_child(Path(args.crash_child))
    if args.mesh_child:                  # a rank of phase 15
        return mesh_child(json.loads(args.mesh_child))
    if args.serve_child:                 # a rank of phase 15 (c)'s serve CLI
        return serve_child(Path(args.serve_child))
    if args.count_child:                 # phase 17's counts, beside phase 16
        return count_child(Path(args.count_child))
    from repro_torch.core import (LinearScan, build_bst, make_batch_searcher,
                                  topk_batch)
    from repro_torch.core.cost_model import frontier_capacities
    from repro_torch.core.hamming import pack_vertical_torch
    from repro_torch.core.search import (CAP_MAX_DEFAULT,
                                         _traverse_frontier_batch,
                                         scatter_root_plane)
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.1f} s "
              f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB held)",
              flush=True)
        t_phase = now

    # -- 1. device and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)   # name, power limit
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr}")
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    args.popc_per_s = POPC_PER_SM_CLOCK * n_sm * sm_mhz * 1e6
    print(f"{n_sm} SMs, max SM clock {sm_mhz:.0f} MHz: popcount issue "
          f"{args.popc_per_s / 1e12:.2f} T/s", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    _build.load_library()
    print(f"kernel build: {_build.BUILD_INFO['seconds']:.2f} s -> "
          f"{_build.BUILD_INFO['path']}", flush=True)
    for line in _build.BUILD_INFO["report"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    for name, (regs, st, ld) in {**bf16_fwd_ptxas(_build),
                                 **bf16_bwd_ptxas(_build)}.items():
        print(f"  ptxas {name}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads")
    phase_done("1 (device and build)")

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    err = dict.fromkeys(("sparse_verify_batch", "hamming_distances",
                         "sparse_verify_arena_packed", "sparse_verify_arena",
                         "exact_rerank", "sparse_verify_batch_batched",
                         "hamming_distances_batched",
                         "hamming_distances_gather"), 0)
    err["flash_attention_fwd"] = 0.0
    n_checks = 0

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    def maxerr(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    t0 = time.perf_counter()
    for b, L in SWEEP_BL:
        W = (L + 31) // 32
        for n in SWEEP_N:
            db = words(b, W, n)
            for m in SWEEP_M:
                q = words(b, W, m)
                got = ops.hamming_distances(db, q)
                want = ref.hamming_distances_ref(db, q)
                e = maxerr(got, want)
                err["hamming_distances"] = max(err["hamming_distances"], e)
                check(e == 0, f"hamming_distances b={b} L={L} n={n} m={m}")
                for tau in SWEEP_TAU:
                    base = torch.randint(0, tau + 3, (m, n), dtype=torch.int32,
                                         device=dev, generator=gen)
                    pruned = torch.rand((m, n), device=dev, generator=gen) < 0.2
                    base[pruned] = BIG
                    mask, dist = ops.sparse_verify_batch(db, q, base, tau=tau)
                    w_mask, w_dist = ref.sparse_verify_batch_ref(db, q, base, tau)
                    e = max(maxerr(mask, w_mask), maxerr(dist, w_dist))
                    if m == 1:                       # the m=1 wrapper too
                        one = ops.sparse_verify(db, q[..., 0].contiguous(),
                                                base[0], tau=tau)
                        e = max(e, maxerr(one[0], w_mask[0]),
                                maxerr(one[1], w_dist[0]))
                    err["sparse_verify_batch"] = max(err["sparse_verify_batch"], e)
                    check(e == 0, f"sparse_verify_batch b={b} L={L} n={n} "
                                  f"m={m} tau={tau}")
                    n_checks += 1
            del db
    # the sweep's last planes, held by main's names until now
    del q, got, want, base, pruned, mask, dist, w_mask, w_dist
    torch.cuda.synchronize()
    print(f"kernels vs plain: {n_checks} verify + "
          f"{n_checks // len(SWEEP_TAU)} scan shapes bit-exact "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    batched_checks = check_batched_kernels(torch, ops, ref, dev, gen, words,
                                           maxerr, err)
    torch.cuda.synchronize()
    print(f"batched scan and verify launches vs plain: {batched_checks} "
          f"bit-exact, batch {SWEEP_BATCH} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    gather_checks = check_gather_kernel(torch, ops, ref, dev, gen, words,
                                        maxerr, err)
    torch.cuda.synchronize()
    print(f"candidate verify vs plain: {gather_checks} bit-exact "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    arena_checks = check_arena_kernels(torch, ops, ref, dev, gen, words,
                                       maxerr, err)
    torch.cuda.synchronize()
    print(f"arena and re-rank kernels vs plain: {arena_checks} bit-exact "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    d80_checks = check_flash_d80(torch, ops, ref, dev, gen, err)
    torch.cuda.synchronize()
    print(f"flash kernel at head dim 80 vs plain: {d80_checks} shapes within "
          f"2e-5 (f32) / 2e-2 (bf16), bf16 rows within "
          f"{FLASH_BF16_ROW_RTOL} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    fwd_ptxas = check_fwd_ptxas(_build)
    phase_done("2 (kernels against their plain versions)")

    # -- 3. main path at the Review size -------------------------------------
    t0 = time.perf_counter()
    sketches, qs = review_static(args.seed)
    index = build_bst(sketches, REVIEW_B, device="cuda")
    torch.cuda.synchronize()
    print(f"build_bst n={REVIEW_N} L={REVIEW_L} b={REVIEW_B}: "
          f"{time.perf_counter() - t0:.1f} s; lm={index.lm} ls={index.ls} "
          f"(paper {PAPER_LM}, {PAPER_LS}) t_L={index.t[-1]} "
          f"kinds={list(index.kinds)} model_bits={index.model_bits()}",
          flush=True)
    t0 = time.perf_counter()
    scan = LinearScan.build(sketches, REVIEW_B, device="cuda")
    print(f"LinearScan.build: {time.perf_counter() - t0:.1f} s", flush=True)

    qs_t = torch.from_numpy(qs.astype(np.int32)).to(dev)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_stats()                       # the main path's window
    t0 = time.perf_counter()
    ranges = {tau: make_batch_searcher(index, tau)(qs_t) for tau in (1, 2, 3)}
    top = topk_batch(index, qs_t, TOPK)
    d = scan.distances(qs)                         # (m, n) brute force
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ops.kernel_stats()
    peak_main = torch.cuda.max_memory_allocated()
    print(f"main path: {main_s:.2f} s, launches {launches}, "
          f"peak {peak_main / 2**30:.2f} GiB", flush=True)
    check(launches.get("sparse_verify_batch", 0) > 0,
          "sparse_verify_batch kernel not launched on the main path")
    check(launches.get("hamming_distances", 0) > 0,
          "hamming_distances kernel not launched on the main path")
    check(not any(k.endswith(":ref") for k in launches),
          f"plain version ran on the main path: {launches}")

    check(d.shape == (M_QUERIES, REVIEW_N) and d.dtype == torch.int32,
          f"scan shape {tuple(d.shape)} {d.dtype}")
    for tau, res in ranges.items():
        inside = d <= tau
        check(int(res.overflow.sum()) == 0, f"tau={tau}: frontier overflow")
        check(torch.equal(res.mask, inside), f"tau={tau}: mask != (d <= tau)")
        check(torch.equal(res.dist, torch.where(inside, d, BIG)),
              f"tau={tau}: dist not exact inside the ball / BIG outside")
        print(f"tau={tau}: hits per query min/median/max "
              f"{inside.sum(1).min().item()}/"
              f"{inside.sum(1).median().item()}/"
              f"{inside.sum(1).max().item()}", flush=True)
    check(top.overflow == 0, f"topk overflow {top.overflow}")
    for r0 in range(0, M_QUERIES, 8):              # stable sort: ties by id
        sd, si = torch.sort(d[r0:r0 + 8], dim=1, stable=True)
        check(torch.equal(top.ids[r0:r0 + 8], si[:, :TOPK].to(torch.int32))
              and torch.equal(top.dists[r0:r0 + 8], sd[:, :TOPK]),
              f"topk rows {r0}..{r0 + 7} differ from the brute-force scan")
        del sd, si
    host_ids, host_d = top.ids.cpu().numpy(), top.dists.cpu().numpy()
    for i in (0, 1, M_QUERIES // 2, M_QUERIES - 1):  # host witness
        hd = (sketches != qs[i][None, :]).sum(axis=1)
        check(np.array_equal(d[i].cpu().numpy(), hd), f"scan row {i} != host")
        cand = np.flatnonzero(hd <= top.tau)
        order = cand[np.lexsort((cand, hd[cand]))][:TOPK]
        check(np.array_equal(host_ids[i], order)
              and np.array_equal(host_d[i], hd[order]),
              f"topk row {i} != host top-{TOPK}")
    print(f"main path exact: ranges tau=1,2,3 and top-{TOPK} (tau*={top.tau}) "
          "match the scan kernel, the stable sort and the numpy host check",
          flush=True)
    phase_done("3 (static main path)")

    ops.reset_kernel_stats()
    topk_batch(index, qs_t, TOPK)
    torch.cuda.synchronize()
    per_topk = ops.kernel_stats()
    print(f"launches per topk_batch call: {per_topk}", flush=True)

    # -- 4. kernels at the main path's shapes; times ------------------------
    tail = index.tail
    b, W, t_L = tail.paths_vert.shape
    caps = frontier_capacities(index.t, index.b, top.tau, CAP_MAX_DEFAULT)
    f_ids, f_dists, f_valid, _, _ = _traverse_frontier_batch(
        index, qs_t, tau=top.tau, caps=caps)
    base = scatter_root_plane(f_ids, f_dists, f_valid, M_QUERIES,
                              tail.t_root).index_select(1, tail.leaf_root)
    q_sfx = ops.to_lane_major(pack_vertical_torch(qs_t[:, index.ls:], index.b))
    qv = ops.to_lane_major(pack_vertical_torch(qs_t, REVIEW_B))
    del f_ids, f_dists, f_valid, d, ranges, res, inside
    torch.cuda.empty_cache()
    slices = range(0, M_QUERIES, 8)              # 8-query slices bound memory

    def plain_verify():
        return [ref.sparse_verify_batch_ref(tail.paths_vert,
                                            q_sfx[..., r0:r0 + 8],
                                            base[r0:r0 + 8], top.tau)
                for r0 in slices]

    def plain_scan():
        return [ref.hamming_distances_ref(scan.full_vert, qv[..., r0:r0 + 8])
                for r0 in slices]

    mask, dist = ops.sparse_verify_batch(tail.paths_vert, q_sfx, base,
                                         tau=top.tau)
    for r0, (w_mask, w_dist) in zip(slices, plain_verify()):
        e = max(maxerr(mask[r0:r0 + 8], w_mask), maxerr(dist[r0:r0 + 8], w_dist))
        err["sparse_verify_batch"] = max(err["sparse_verify_batch"], e)
        check(e == 0, f"sparse_verify_batch at the main path's shape, rows {r0}+")
    del mask, dist, w_mask, w_dist
    dd = ops.hamming_distances(scan.full_vert, qv)
    for r0, want in zip(slices, plain_scan()):
        e = maxerr(dd[r0:r0 + 8], want)
        err["hamming_distances"] = max(err["hamming_distances"], e)
        check(e == 0, f"hamming_distances at the main path's shape, rows {r0}+")
    del want
    print("kernels vs plain at the main path's shapes: bit-exact", flush=True)

    sfx_ms = time_ms(torch, lambda: ops.sparse_verify_batch(
        tail.paths_vert, q_sfx, base, tau=top.tau))
    sfx_plain = time_ms(torch, plain_verify, iters=3)
    sfx_bound, sfx_by = bound(b, W, t_L, M_QUERIES, verify=True)
    Ws = scan.full_vert.shape[1]
    scan_ms = time_ms(torch, lambda: ops.hamming_distances(scan.full_vert, qv))
    scan_plain = time_ms(torch, plain_scan, iters=3)
    scan_bound, scan_by = bound(REVIEW_B, Ws, REVIEW_N, M_QUERIES, verify=False)
    qf = qs_t.float()
    dbf = torch.from_numpy(sketches).to(dev).float()
    check(torch.equal(torch.cdist(qf, dbf, p=0).to(torch.int32), dd),
          "cdist(p=0) disagrees with the scan kernel")
    del dd
    scan_lib = time_ms(torch, lambda: torch.cdist(qf, dbf, p=0))
    del dbf
    print(f"sparse_verify_batch (b={b} W={W} n={t_L} m={M_QUERIES}): "
          f"{sfx_ms:.3f} ms, bound {sfx_bound:.3f} ms ({sfx_by}), "
          f"plain {sfx_plain:.3f} ms", flush=True)
    print(f"hamming_distances (b={REVIEW_B} W={Ws} n={REVIEW_N} "
          f"m={M_QUERIES}): {scan_ms:.3f} ms, bound {scan_bound:.3f} ms "
          f"({scan_by}), plain {scan_plain:.3f} ms, "
          f"cdist(p=0) {scan_lib:.3f} ms", flush=True)

    n_med = 1_000_003                              # a medium shape
    db_med = words(REVIEW_B, 1, n_med)
    q_med = words(REVIEW_B, 1, M_QUERIES)
    base_med = torch.randint(0, 6, (M_QUERIES, n_med), dtype=torch.int32,
                             device=dev, generator=gen)
    med = {
        "verify kernel": lambda: ops.sparse_verify_batch(db_med, q_med,
                                                         base_med, tau=3),
        "verify plain": lambda: ref.sparse_verify_batch_ref(db_med, q_med,
                                                            base_med, 3),
        "scan kernel": lambda: ops.hamming_distances(db_med, q_med),
        "scan plain": lambda: ref.hamming_distances_ref(db_med, q_med),
    }
    print(f"medium shape b={REVIEW_B} W=1 n={n_med} m={M_QUERIES}: " + ", ".join(
        f"{k} {time_ms(torch, fn):.3f} ms" for k, fn in med.items()), flush=True)
    del db_med, q_med, base_med

    si_ms = {}
    for tau in (1, 2, 3):
        si_ms[tau], samples = host_ms(
            torch, lambda: make_batch_searcher(index, tau)(qs_t))
        print(f"range search tau={tau} (m={M_QUERIES}): {si_ms[tau]:.2f} ms "
              f"median of 5 {samples}", flush=True)
    topk_batch(index, qs_t, TOPK)                  # warm-up
    torch.cuda.synchronize()
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        topk_batch(index, qs_t, TOPK)
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    e2e_ms = statistics.median(e2e)
    print(f"topk_batch e2e (m={M_QUERIES}, k={TOPK}, tau*={top.tau}): "
          f"{e2e_ms:.2f} ms median of 5, {M_QUERIES / e2e_ms * 1e3:.0f} "
          f"queries/s", flush=True)
    print(f"max_memory_allocated: main path {peak_main / 2**30:.2f} GiB, "
          f"run {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del index, scan, qs_t, tail, base, q_sfx, qv, qf, sketches
    torch.cuda.empty_cache()
    phase_done("4 (static kernels timed)")

    seg = segmented_review(torch, args, dev, ops, ref, err, maxerr)
    corpus10, bst_seg_ms = seg.pop("corpus10"), seg.pop("topk_ms")
    phase_done("5 (segmented path at the Review size)")
    cp = plane_fallback(torch, args, dev, ops, ref, err, maxerr)
    phase_done("6 (plane fallback, CP geometry)")

    # -- 7. serving smollm-135m at full width, the flash kernel -----------
    t0 = time.perf_counter()
    flash_checks, row_err = check_flash_kernel(torch, ops, ref, dev, gen,
                                               err)
    torch.cuda.synchronize()
    print(f"flash kernel vs plain: {flash_checks} shapes within 2e-5 (f32) "
          f"/ 2e-2 (bf16), max abs err {err['flash_attention_fwd']:.3g}; "
          f"bf16 row error {row_err:.4g} (limit {FLASH_BF16_ROW_RTOL}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    flash = serving_smollm(torch, args, dev, ops, ref)
    phase_done("7 (serving smollm-135m, flash kernel)")
    hubert = hubert_forward(torch, args, dev, ops, ref)
    phase_done("8 (hubert-xlarge forward, flash at head dim 80)")
    cws_sketching(torch, args, dev)
    phase_done("9 (zbit_cws at the SIFT and GIST shapes)")

    # -- 10. the other backends --------------------------------------------
    t_sub = time.perf_counter()

    def sub_done(name: str) -> None:
        nonlocal t_sub
        print(f"({name}: {time.perf_counter() - t_sub:.1f} s)", flush=True)
        t_sub = time.perf_counter()

    sketches, qs = review_static(args.seed)
    d = LinearScan.build(sketches, REVIEW_B, device="cuda").distances(qs)
    sub_done("Review sketches and the scan")
    gather_json, mi_json = static_multi(torch, dev, ops, ref, err, maxerr,
                                        sketches, qs, d, si_ms)
    sub_done("a")
    sh_json = static_sharded(torch, dev, ops, ref, err, maxerr, sketches, qs,
                             d, si_ms)
    sub_done("b")
    del d
    torch.cuda.empty_cache()
    segmented_backends(torch, dev, ops, corpus10, bst_seg_ms)
    sub_done("c")
    baselines_check(torch, dev, ops, sketches)
    sub_done("d")
    del sketches, qs
    phase_done("10 (the other backends)")
    served = retrieval_server(torch, args, dev, ops, corpus10)
    phase_done("11 (the retrieval server)")

    # -- 12. the dedup-fed trainer -----------------------------------------
    dedup_pipeline(torch, args, ops)
    err["flash_attention_fwd_lse"] = err["flash_attention_bwd"] = 0.0
    attn = check_flash_bwd(torch, ops, ref, dev, gen, err)
    trained = train_smollm(torch, args, ops)
    phase_done("12 (the dedup-fed trainer)")

    # -- 13. the MoE, SSM and hybrid families; 14. the tools -------------
    families = model_families(torch, args, dev, ops, err)
    phase_done("13 (the MoE, SSM and hybrid families)")
    tools_on_card()
    phase_done("14 (the port's tools on the card)")
    mesh = mesh_layer(torch, args, dev, err)
    phase_done("15 (the mesh layer: expert-parallel MoE, sequence-parallel "
               "decode, data-parallel serving)")
    import shutil

    p17_counts = []                      # phase 17's counts, started in 16
    try:
        mesh_train = mesh_training(torch, args, lambda: p17_counts.append(
            count_start()))
        phase_done("16 (training under a mesh of ranks, the dry-run against "
                   "the card)")
        families_trained = family_training(torch, args, ops, ref, dev, gen,
                                           err, p17_counts[0])
    finally:
        for proc, work in p17_counts:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(work, ignore_errors=True)
    phase_done("17 (the families trained at full width)")
    large = large_models(torch, args, dev, ops, err)
    phase_done("18 (the large models served whole)")

    kernels = [
        {"name": "sparse_verify_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:114",
         "launches": launches["sparse_verify_batch"],
         "train_launches": trained["sparse_verify_batch"],
         "mesh_train_launches": {r: c.get("sparse_verify_batch", 0)
                                 for r, c in mesh_train["b"].items()},
         "max_abs_err": err["sparse_verify_batch"], "ms": sfx_ms,
         "plain_ms": sfx_plain, "bound_ms": sfx_bound, "bound_by": sfx_by,
         "library_ms": None},
        {"name": "hamming_distances", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:70",
         "launches": launches["hamming_distances"],
         "served_launches": served["launches"]["hamming_distances"],
         "max_abs_err": err["hamming_distances"], "ms": scan_ms,
         "plain_ms": scan_plain, "bound_ms": scan_bound, "bound_by": scan_by,
         "library_ms": scan_lib},
        {"name": "sparse_verify_arena_packed", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/arena.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:203",
         "served_launches":
             served["launches"]["sparse_verify_arena_packed"],
         "max_abs_err": err["sparse_verify_arena_packed"],
         **seg["sparse_verify_arena_packed"]},
        {"name": "sparse_verify_arena", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/arena.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:278",
         "max_abs_err": err["sparse_verify_arena"],
         **cp["sparse_verify_arena"]},
        {"name": "exact_rerank", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:381",
         "served_launches": served["launches"]["exact_rerank"],
         "max_abs_err": err["exact_rerank"], **seg["exact_rerank"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn_kernel.py:93",
         "max_abs_err": err["flash_attention_fwd"], **flash,
         "head_dims": list(ops.FLASH_HEAD_DIMS), "ptxas": fwd_ptxas,
         "d80_hubert": hubert,
         "family_launches": families,
         "large_model_launches": large,
         "mesh_launches": mesh["a"],
         "tp_launches": mesh["b"], "tp_local_heads": mesh["local_heads"]},
        {"name": "flash_attention_fwd_lse", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn_kernel.py:93",
         "launches": trained["flash_attention_fwd:lse"],
         "mesh_train_launches": {r: c.get("flash_attention_fwd:lse", 0)
                                 for r, c in mesh_train["b"].items()},
         "tp_train_launches": {
             a: {r: c.get("flash_attention_fwd:lse", 0) for r, c in rc.items()}
             for a, rc in mesh_train["c"].items()},
         "family_train_launches": {
             a: c.get("flash_attention_fwd:lse", 0)
             for a, c in families_trained["launches"].items()},
         "d80_train": {a: t["lse"]
                       for a, t in families_trained["d80"].items()},
         "max_abs_err": err["flash_attention_fwd_lse"], **attn["lse"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
         "replaces": "src/repro/models/flash.py:134",
         "launches": trained["flash_attention_bwd"],
         "mesh_train_launches": {r: c.get("flash_attention_bwd", 0)
                                 for r, c in mesh_train["b"].items()},
         "tp_train_launches": {
             a: {r: c.get("flash_attention_bwd", 0) for r, c in rc.items()}
             for a, rc in mesh_train["c"].items()},
         "family_train_launches": {
             a: c.get("flash_attention_bwd", 0)
             for a, c in families_trained["launches"].items()},
         "d80_train": {a: t["bwd"]
                       for a, t in families_trained["d80"].items()},
         "max_abs_err": err["flash_attention_bwd"], **attn["bwd"]},
        {"name": "sparse_verify_batch_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:114",
         "max_abs_err": err["sparse_verify_batch_batched"], **sh_json},
        {"name": "hamming_distances_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:70",
         "max_abs_err": err["hamming_distances_batched"], **mi_json},
        {"name": "hamming_distances_gather", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hamming.cu",
         "replaces": "src/repro/kernels/hamming_kernel.py:70",
         "reached_through": "src/repro/core/multi_index.py:167",
         "max_abs_err": err["hamming_distances_gather"], **gather_json},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

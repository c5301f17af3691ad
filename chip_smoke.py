#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: card name and power limit, torch / CUDA versions, TF32
     off, bf16 reduced-precision reductions in matmuls off;
  2. build all nineteen kernels from src/repro_torch/kernels/csrc (twelve
     sources, one nvcc per source, all at once), and hold the port's
     shared-memory estimate (engine.smem_bytes) equal to each library's own;
     0 spill bytes in ptxas's report for gcrn_step, stacked_step,
     ell_spmm and static_engine, and no generic LD in their SASS
     (cuobjdump -sass: the shared loads of all but the SpMM are LDS);
  3. every kernel against its plain PyTorch version on the card:
     a. narrow odd widths with partial node tiles, ragged with a length-0
        row, with and without edge messages / the static edge term, the
        paged engines at ring depths 1, 2 and 4 (also bit-for-bit against
        the resident engine), the GRU / LSTM cells at their kernel's edges
        (a partial row tile and unit slice, din 13 and an x 4 bytes off a
        16-byte boundary on the 4-byte staging, din = H = 512), gcrn_step,
        stacked_step and ell_spmm at their edges (n 37: a partial row tile;
        H 20 / 24, din 12 / 13, stacked dmid din + 7; k 1 / 27 / 33 / 40;
        every row dead (stacked also with h 0), a single live row; with and
        without edge messages; the SpMM also at d 12 / 13 / 64 / 128 and
        with x 4 bytes off a 16-byte boundary; two calls bit for bit equal;
        their launches equal to engine.step_plan), stacked_step at the
        widest shapes the one-CTA kernel took (Wg read from L2) and n
        66,000, and static_engine on STATIC_CASES (the pack's widths, D 13,
        three layers, square, each variant of its launch up to D 806, n
        66,000, with and without the edge term; the columns past the
        widths zero; its launch equal to engine.static_plan) (<= 1e-4:
        fp32 with TF32 off, only the order of summation differs);
     b. the five stream engines at full width (BC-Alpha, n_pad 640,
        G 3468): a T = 8, B = 2 ragged case (<= 1e-4) and the main path's
        own shapes (all 137 steps, 176 TGN event batches or 137 static
        slots; <= 1e-3 for the recurrences, which compound sum-order
        differences, <= 1e-4 for the static GCN); the four paged engines
        (td 16) on the same inputs at depths 1, 2 and 4, bit-for-bit
        against the resident engine and against their plain versions,
        each depth timed beside the resident engine; the four cluster
        engines (gcrn_engine, evolve_engine, stacked_engine, tgn_engine: a
        stream on a thread-block cluster of engine.CLUSTER CTAs) on narrow
        cases (H 20 / 24 / 128, D 8 / 24 / 128 / 256, n 37 / 40 / 640 /
        1000 (GCRN's resident rows in global scratch), with and without
        edge messages, TGN's event times up to 137, B 1 / 2 / 17, a
        length-0 stream and a dead step) against their plain versions
        (<= 1e-4), paged bit for bit against resident at td 8 / 16 and
        depths 1 / 2 / 4, two calls bit for bit, the launch the library
        builds (cluster, CTAs, threads, shared memory, column slices, the
        weights in shared memory or not) equal to
        engine.engine_cluster_config; the widest plans the one-CTA stacked
        / TGN kernels took (stacked dmid = H = 736 and dmid 128, H 1,348;
        TGN H 496 and 492) and paged TGN at n 1,400, and every cluster
        engine at n 66,000 (two chunks of live-tile bits), each against
        its plain version; 0 spill bytes in ptxas's report for the stacked
        and TGN kernels; a B 1 launch one cluster of >= 8 CTAs, and
        resident and paged d1 / d2 / d4 timed in turns at B 1 and at the
        V3_WINDOWS batch (B 4; TGN: EVENT_V3_WINDOWS); then the static
        checker (analysis_phase): python -m repro_torch.analysis's run on
        the card with zero findings (the library's shared memory, cluster
        launch and static plan equal to the port's at every sweep point;
        each stateful sweep point launched with its protocol log and
        replayed), each sweep point's device log equal row for row to its
        plain version (engine.protocol_plain), and the main path's own
        launches with the log (the four resident engines, and the paged
        ones at td 16, depths 1, 2 and 4): replayed clean (the paged rings
        and EvolveGCN's GRU slab ring and W planes), no overflow, the plain
        version's rows, the results bit for bit those without the log;
        with --parent DIR, the eight engine variants (the paged ones at
        every depth) timed in turns with DIR's build of its sources;
     c. the three per-step kernels (V2 steps, ELL SpMM) on the inputs the
        main path hands them at full width, recorded from one run of a path
        that launches each, every step of the stream (<= 1e-4; stacked_step
        also on a one-GCN-layer stacked run's, with edge messages), each timed
        per call three ways (bare launches on CUDA events and a CUDA graph
        of the calls, in turns; the profiler's kernel duration after phase
        6; medians of 9), the ELL
        SpMM by width and edge messages, gcrn_step's and ell_spmm's launch
        at those shapes equal to engine.step_plan; static_engine's main
        launch (at the layers' true widths) the same three ways, its
        launch equal to engine.static_plan, and a probe of its waves (the
        first 132 slots, all, the rest, the largest alone); the GRU /
        LSTM cells at benchmarks/kernel_bench.py's shape (640 rows, 128
        wide, tb 128; their grid, from the library, fills the card), then
        at three larger shapes;
     each timed with CUDA events beside its bound, the ELL SpMM beside
     torch.sparse.mm of the same matrix, the cells beside torch.gru_cell /
     torch.lstm_cell (medians of 9 samples taken in turns, and from CUDA
     graphs of 20 calls, the larger shapes from graphs only; the graph
     time over the serial K rows beside the tb-row kernel's);
  4. main path: every level of GCRN-M2, EvolveGCN-O, the stacked
     GCN -> GRU, TGN and the static GCN through BoosterSession (run on the
     whole BC-Alpha stream, run_batched over windows: ragged at v3, equal at
     the per-step levels), and build_model(cfg, impl="pallas") with
     run_plan / run_plan_batched at the per-step levels. TGN runs on the
     BC-Alpha events (sorted by time, batches of 200: 176 event batches),
     the others on the 137 snapshots. Then the paged paths: plan(cfg,
     level="v3", td=16, state_residency="hbm_paged", buffer_depth=d) for
     GCRN-M2 at d = 1, 2, 4 and the other three stateful families at
     d = 2, 4, through the session (run and run_batched) and through
     run_arrays, each bit-for-bit against the resident run; the capacity
     path (EvolveGCN-O at hidden 256 on 16 snapshots: resident refuses with
     the hint to page, paged runs); and ops.fused_gru / ops.fused_lstm.
     The launch counts are set to 0 just before each path and read just
     after it; each path's results are held against its force-ref run on
     the card (<= 1e-3; <= 1e-4 for the cells).
     Then the serve layer (serve_phase) on the 137 raw BC-Alpha COO
     snapshots, every result held against the offline run of the same
     snapshots padded into one bucket through run_plan with force_ref on
     the card (outputs on each snapshot's real rows and final states,
     <= 1e-3; <= 1e-4 for the static express lane), every fault-free path
     with no degraded launch and its engine's launch count equal to the
     server's: (1) BoosterSession.serve of the whole stream for GCRN-M2,
     EvolveGCN-O and the stacked GCN -> GRU at v3, chunks of 8, in one
     fixed bucket (640) and in DEFAULT_BUCKETS; (2) serve_multi's round
     scheduler, eight GCRN-M2 tenants (a window of ~17 snapshots each) with
     DEFAULT_BUCKETS and promote_buckets 4.0 under the static and the
     measured guard (its per-bucket times printed beside bucket_cost; its
     calibration launches, two a bucket, counted), the callers' state
     tensors unchanged; (3) the express lane, a static GCN session serving
     four tenants beside four GCRN-M2 ones (static_engine launches equal
     to express_launches); (4) four fault plans under supervision
     "isolate": a persistent launch fault on one tenant (quarantined, the
     others equal offline), a transient one retried, a kernel-scoped one
     served by the degradation ladder's oracle rung (no engine launch
     reached), a mid-commit evolve fault on EvolveGCN-O rolled back (bit
     for bit the fault-free serve); (6) the continuous scheduler
     (serve_continuous): (a) GCRN-M2, EvolveGCN-O and the stacked GCN -> GRU,
     the eight tenants of (2) in the fixed bucket with state_pool_pages 2
     and prefill_chunk 2, outputs and final states bit for bit the round
     scheduler's on the same plan, tenants evicted and recovered (an
     eviction's and a recovery's ms printed); (d) GCRN-M2's device memory
     in that run: the peak from the first tick to the flush within
     (capacity + the largest launch's B) x a tenant's state bytes + a
     launch's working set, the allocation back at its base once the states
     are dropped; (b) DEFAULT_BUCKETS with promote_buckets 4.0 (static
     guard); (c) twelve tenants on an hbm_paged plan (td 16) with one
     nominal page (capacity 8): evictions as that capacity implies,
     gcrn_engine_paged launched, bit for bit its round run, its memory as
     (d); (e) the express lane beside four tenants (static_engine launches
     equal to express_launches); (f) a persistent and a transient launch
     fault under "isolate", the survivors bit for bit (a)'s run; (g)
     benchmarks/kernel_bench.py's skewed workload (a backlog of all 137
     snapshots beside three tenants whose 24 snapshots arrive one every 20
     ms) under both schedulers, a warm run and two paced ones each: the
     incremental tenants' p50 / p99 sojourn (commit ms minus arrival),
     snapshots/s, ticks, prefill chunks, launches, and the two schedulers'
     outputs bit for bit; (5) python -m repro_torch.launch.serve --dgnn
     gcrn-m2 in a process of its own. Paths 1-3 and 6 print ms a snapshot
     of staging + launch (a chunk's stacking, copy to the card, launch and
     synchronize over its live snapshots), host preprocessing ms and
     snapshots/s beside the card's name and power limit.
     Then the paths that launch no kernel (plain torch, as the JAX
     package's are plain XLA; every launch count reads 0 around them),
     timed before the first profiler window: (7) the DGNN trainer
     (examples/torch/train_evolvegcn.py: EvolveGCN-O at v1, BC-Alpha link
     prediction) at the example's full width (n_pad 640, e_pad 4096, k_max
     64, a window of 6, 256 pairs): 20 steps with a checkpoint every 10
     into a temporary directory, finite losses, the restored tensors equal
     the trained ones, a second run resumes from step 20 to 24; the first
     3 losses within 1e-5 relative of the same run on the CPU in this
     process, step 1's gradients within 1e-5 of each leaf's max |value|;
     ms a step; (8) mamba2-2.7b (64 layers, d_model 2560, 80 SSD heads of
     64, state 128, chunk 256) and granite-moe-3b-a800m (32 layers,
     d_model 1536, 40 experts top-8, d_ff 512, the dense MoE path) at full
     width and depth, bf16 weights drawn on the card from the seed: a
     prefill of 2 x 2048 tokens with finite logits (ms median of 3),
     generate as the LM phase's (b) (ms a decode step), the decode logits
     after the last prompt token against a prefill of the prompts (within
     3e-2 for granite; mamba2's decode, an fp32 recurrence, and prefill,
     bf16 intra-chunk scores, round at other places through 64 layers:
     within 0.12 with the argmax equal, each layer's mixer teacher-forced
     within 3e-2), the peak memory; (9) each examples/torch/*.py in a
     process of its own at small flags (train_evolvegcn --steps 10,
     quickstart, serve_stream --snapshots 8 --streams 2, lm_generate:
     jamba-v0.1-52b reduced), each exiting 0; (10) device sharding
     (sharding_phase): the card count; where the host has two cards,
     each family's v3 run_batched at B 4 with DeviceSpec(2) bit for bit
     the unsharded launch, else plan(..., DeviceSpec(2)) refused; a
     world-1 NCCL group from make_host_mesh(): compressed_all_reduce and
     bf16_all_reduce of 64 MiB of fp32 bit for bit their local quantise /
     dequantise and cast (timed beside them), the GPipe pipeline at one
     stage against reference_stack (<= 1e-5); granite-moe-3b-a800m at
     full width and depth with moe_impl="ep" on that mesh: at ample
     capacity (cf_send 1, cf_local E / top_k) no copy dropped, each MoE
     sublayer teacher-forced on the dense prefill's inputs within 2e-2 of
     the dense path and the logits' argmax the dense prefill's, the
     busiest expert's load by layer, the sublayer alone both ways; at the
     default cf 1.25 / 1.25 prefill ms (median of 3), peak memory over the
     weights and dropped copies by layer beside the dense path's; a
     checkpoint restored onto the mesh with its logical axes bit for bit,
     and the tokens under the mesh.
  5. the device's busy share of one run at baseline, v2 and v3, resident
     and paged (kernel time over wall time, torch.profiler recording the
     device only), with the CTAs a v3 launch of each stateful family uses.
  6. a probe of where a live node tile's time goes: gcrn_step and
     stacked_step on synthetic full-width inputs that vary live rows,
     lanes, the rows with a nonzero h and widths, timed the three ways of
     3c. It runs before phase 5, and the kernel
     durations of 3c and 6 are taken after it: no profiler window opens
     before the last host-dispatched timing of phases 3-6 (a process the
     profiler has traced dispatches from the host more slowly).
Then the LM serving path, Qwen2.5-14B at full width and depth (48 layers,
d_model 5120, 40 / 8 heads, head_dim 128, d_ff 13824, vocab 152064, QKV
bias) with random bf16 weights drawn on the card from the seed:
  3d. both flash kernels (flash_attention, flash_fwd) against their plain
     versions: narrow cases (head_dim 16 / 80 / 96 / 128, S 64 / 128 /
     200 / 384: partial 128-row tiles, causal and not, group 1 / 3 / 4 /
     5;
     every head_dim 8..128; Skv unlike S; fp32 <= 1e-4 and bf16 <= 2e-2,
     lse <= 1e-4), the refusals (a tail, head_dim 136), then the q / k /
     v of layer 0 and the last layer of one prefill (B 2, S 2048), timed
     beside the bound, the plain version and
     F.scaled_dot_product_attention (enable_gqa), which the port never
     calls: the kernel and SDPA in turns on CUDA events and from CUDA
     graphs, each with its TFLOP/s and share of the bound; flash_fwd also
     on phi3-mini-3.8b's training shape (q (64, 2048, 96), group 1) and
     granite-moe-3b-a800m's (q (48, 2048, 64), k / v (16, 2048, 64), group
     3), each against its plain version and timed as above; the bf16
     launch the library builds (tiles, ring, shared memory, grid) equal to
     engine.flash_config at all three shapes;
  4. (a) prefill_step with attn_impl="flash" on 2 prompts of 2048 random
     tokens: flash_fwd launched exactly once a layer and nothing else;
     each layer's attention sublayer, teacher-forced, within 3e-2 of
     attn_impl="xla" on the same input (the gate of the path); the
     logits within 0.12 of max |logits| of attn_impl="xla" and of the
     same path on the kernel's plain version, with the same argmax (48
     random layers amplify a bf16 ulp to ~0.1); ms median of 3, counts
     read around the timed calls too; (b) generate answers 2 requests
     (16-token prompts, 16 new tokens, a 64-slot cache), ms a decode step,
     and the decode logits after the last prompt token within 3e-2 of an
     xla prefill of the prompts and 0.12 of a flash one; flash_attention's
     own entry point (no model path reaches it). The kernels line's
     launches are the counts read around these runs; the comparisons'
     own launches are not in them;
  5. the device's busy share of one prefill and of one decode step.
Then, with the serving weights freed, the LM training path:
  3e. both flash backward kernels (flash_bwd_dkv, flash_bwd_dq) against
     their plain versions: narrow cases (head_dim 32 / 96 / 128, S 64 / 128
     / 200 with the default bq = bk = 512: partial 128-row tiles, causal
     and not, group 1 / 3 / 4 / 5; every head_dim 8..128; Skv unlike S; fp32
     <= 1e-4 and bf16 <= 2e-2 of max |plain|), a tail refused, then
     Qwen2.5-14B's layer shape (q (80, 2048, 128), k / v (16, 2048, 128),
     bf16, causal, dO from the seed), phi3-mini-3.8b's training shape
     (q / k / v (64, 2048, 96), group 1) and granite-moe-3b-a800m's (q
     (48, 2048, 64), k / v (16, 2048, 64), group 3: the dkv CTA walks 3 q
     heads a kv head): against the plain versions, two
     calls bit for bit equal (no atomics), the bf16 launches the library
     builds equal to engine.flash_bwd_config, then dkv, dq and SDPA's
     backward alone (enable_gqa, retain_graph; the port never calls it)
     timed in turns on CUDA events and from CUDA graphs, each with its
     TFLOP/s and share of the bound; the plain versions timed at each;
  4. (c) phi3-mini-3.8b at full width and depth (32 layers, d_model 3072,
     32 heads of 96, d_ff 8192, vocab 32064), fp32 parameters and AdamW
     moments on the card, attn_impl="flash", remat: ``train`` runs 3 steps
     on 2 x 2048 synthetic tokens; finite losses, counts read around each
     step (flash_fwd 64, flash_bwd_dkv 32, flash_bwd_dq 32, nothing
     else), ms a step and tokens/s beside the step's GEMM bound, the peak
     memory, and the busy share of one step; (d) the gradient gate: each
     layer's attention sublayer, teacher-forced on the xla path's hidden
     state with one cotangent, dx and the attention weights' grads with
     flash against xla (TOL_TRAIN_LAYER), and the kernels with delta
     from an fp32 o against the sublayer in fp32 (TOL_TRAIN_REF), then the
     full-depth loss and grad norm, flash against xla (TOL_TRAIN_DRIFT: a
     blow-up only); (e) the reduced phi3 trains 4 steps with a checkpoint every 2 into a
     temporary directory, the restored tensors equal the trained ones,
     and a second run resumes from step 4 to 6.
  4. (c2) SSM / MoE training, after every earlier model is freed:
     mamba2-2.7b and granite-moe-3b-a800m at full width and depth, fp32
     parameters and AdamW moments drawn on the card from the seed, remat
     (the SSD's chunks recomputed inside each layer's), the dense MoE
     (all 40 experts for every token), flash attention for granite; each:
     (b) a gate on step 1's gradients: granite's attention sublayers
     teacher-forced and held to the same pairs and limits as (d) holds
     phi3's (train_pairs_gate); mamba2's
     layer-0 mixer, its input and weight grads on the card against the
     same call on the CPU in this process (3e-2 of max |grad|); (d)
     granite's gradients with moe_impl="ep" at ample capacity, the
     parameters distributed over the world-1 NCCL 1x1 mesh, against the
     dense path (no optimizer state): the loss within 2e-2, each MoE
     sublayer teacher-forced (dx, router and experts' grads) within 2e-2,
     and at full depth each leaf as near the fp32 gradient as the dense
     path's within 2e-2 (gross faults only; beside it each leaf's ep vs
     dense reading); (a) ``train``
     runs 3 steps of 2 x 2048 synthetic tokens: finite losses, counts read
     around each step (granite: flash_fwd 64, flash_bwd_dkv 32,
     flash_bwd_dq 32, nothing else; mamba2: nothing), ms a step and
     tokens/s beside the GEMM bound, the peak memory beside
     memory_allocated at the path's start, the busy share of one more
     step; then (c) python -m
     repro_torch.launch.train --arch <arch> --full --batch 2 --seq 2048
     --steps 3 (granite with --attn-impl flash), each a process of its
     own, exits 0 with finite losses.
  - The LM under the world-1 NCCL 1x1 mesh (the TP phase): Qwen2.5-14B's
    prefill and a decode step with the parameters (and caches)
    distributed by their Axes trees, bit for bit the unsharded calls,
    flash_fwd once a layer, ms both ways (after (a)-(b)); phi3's train
    step through ``launch.steps.make_train_step_fn``, the moments by
    ``opt_state_axes``, loss and parameters bit for bit (after (d));
    then the port's dry runs (CPU processes on a fake process group) of
    those two workloads at one chip, their roofline at the H100's peaks
    beside the measured ms, and of qwen3-32b decode_32k and gcrn-m2 at
    4096 streams on a fake 16 x 16 mesh (records under
    results/dryrun_torch/chip_smoke/).
Prints ms/snapshot per path, an {"analysis": {...}} line (sweep points,
findings, log rows; with --parent, the turns), a {"kernels": [...]} line
with all nineteen kernels and, last, the device line.

    python3 chip_smoke.py [--parent DIR]

Imports nothing of the JAX package.
"""
import argparse
import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import analysis, api  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.dgnn import (BC_ALPHA, EVOLVEGCN, GCRN_M2,  # noqa: E402
                                      STACKED, STATIC_GCN, TGN)
from repro_torch.core.dataflow import (build_model, init_states_batched,  # noqa: E402
                                       run_plan, run_plan_batched,
                                       stack_time)
from repro_torch.core.evolvegcn import layer_dims  # noqa: E402
from repro_torch.graph import (DEFAULT_BUCKETS, bucket_cost,  # noqa: E402
                               choose_bucket, generate_temporal_graph,
                               max_in_degree,
                               pad_event_block, pad_snapshot,
                               renumber_and_normalize, slice_snapshots)
from repro_torch.graph.padding import (PaddedSnapshot, pow2_target,  # noqa: E402
                                       stack_ragged)
from repro_torch.kernels import engine, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.models import (RuntimeConfig, decode_step,  # noqa: E402
                                init_caches, init_params, loss_fn,
                                prefill_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.api import (Axes, distribute,  # noqa: E402
                                         sharding_ctx, tree_map2,
                                         tree_shardings)
from repro_torch.launch.steps import make_train_step_fn  # noqa: E402
from repro_torch.distributed.pipeline import (pipeline,  # noqa: E402
                                              reference_stack)
from repro_torch.launch.mesh import DeviceSpec, make_host_mesh  # noqa: E402
from repro_torch.nn import attention as attention_mod  # noqa: E402
from repro_torch.nn import layers as layers_mod  # noqa: E402
from repro_torch.nn import mamba2 as mamba2_mod  # noqa: E402
from repro_torch.nn import mlp as mlp_mod  # noqa: E402
from repro_torch.nn import moe as moe_mod  # noqa: E402
from repro_torch.nn.layers import embed_lookup, rms_norm  # noqa: E402
from repro_torch.optim import (AdamWConfig, global_norm,  # noqa: E402
                               init_opt_state, opt_state_axes, tree_leaves)
from repro_torch.serve import (FaultPlan, FaultSpec, InjectedFault,  # noqa: E402
                               SnapshotServer, generate)
from repro_torch.serve.state_pool import HBM_PAGE_FACTOR  # noqa: E402
from repro_torch.train import (TrainLoopConfig, make_train_step,  # noqa: E402
                               train)

# published H100 SXM peaks: fp32 outside the tensor cores, bf16 dense
# tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 1e-4
TOL_STREAM = 1e-3
N_PAD = 640
SEED = 0
CONFIGS = (GCRN_M2, EVOLVEGCN, STACKED, TGN, STATIC_GCN)
# TGN's event batches: the TGN paper's batch size
EVENT_BATCH = 200
# run_batched windows of the stream: ragged at v3 (the stream engine's
# lengths), equal at the per-step levels (which need equal T)
V3_WINDOWS = ((0, 137), (0, 100), (40, 137), (0, 64))
STEP_WINDOWS = ((0, 45), (46, 91), (92, 137))
# the same over TGN's 176 event batches
EVENT_V3_WINDOWS = ((0, 176), (0, 120), (50, 176), (0, 64))
EVENT_STEP_WINDOWS = ((0, 58), (59, 117), (118, 176))
# the T = 8, B = 2 ragged engine check at full width (lengths 8 and 5)
CHECK_WINDOWS = ((0, 8), (40, 48))
# timed repeats of each main path's run after the checked one
RUN_REPS = 3
SRC = "src/repro_torch/kernels/csrc"
# the stream-engine kernel of each family
ENGINE = {"gcrn": "gcrn_engine", "evolve": "evolve_engine",
          "stacked": "stacked_engine", "tgn": "tgn_engine",
          "static_gcn": "static_engine"}
# the paged engine of each stateful family (hbm_paged residency), its
# window width on the main path (8 windows of the 128-wide state) and the
# ring depths of its paged main paths
PAGED = {"gcrn": "gcrn_engine_paged", "evolve": "evolve_engine_paged",
         "stacked": "stacked_engine_paged", "tgn": "tgn_engine_paged"}
PAGED_TD = 16
PAGED_DEPTHS = {GCRN_M2.name: (1, 2, 4), EVOLVEGCN.name: (2, 4),
                STACKED.name: (2, 4), TGN.name: (2, 4)}
# the capacity path: EvolveGCN-O at this hidden width (square D = 256, over
# the resident engine's shared memory) on the stream's first snapshots
CAPACITY_HIDDEN = 256
CAPACITY_T = 16
# the GRU / LSTM cells' shape (benchmarks/kernel_bench.py): rows, input and
# hidden width, row tile
RNN_ROWS, RNN_DIN, RNN_H, RNN_TB = 640, 128, 128, 128
# the cells' narrow cases (rows, din, H, tb): 96 rows at tb 48 and 32,
# 40 rows (a partial 32-row tile), a partial 8-unit slice (H 20 and 18),
# din 13 and H 18 (4-byte staging: rows not 16-byte aligned), din 16
# (16-byte staging), and a wide case whose K loop runs 16 chunks
RNN_NARROW = ((96, 13, 24, 48), (96, 13, 24, 32), (40, 13, 24, 8),
              (40, 16, 20, 8), (40, 16, 18, 8), (256, 512, 512, 128))
# the cells' timing: the median of RNN_SAMPLES samples, kernel and torch's
# cell in turns, each sample RNN_CALLS back-to-back calls (CUDA events
# around host-dispatched calls, and around one replay of a CUDA graph that
# holds RNN_CALLS calls)
RNN_SAMPLES, RNN_CALLS = 9, 20
# the per-step kernels' timing (gcrn_step, stacked_step, ell_spmm): the
# median of STEP_SAMPLES samples, each one pass over the recorded calls
STEP_SAMPLES = 9
# the cells' earlier tb-row kernels (one CTA a tb-row tile walking 32-row
# sub-tiles; PERF.md's kernel table, rows 10-11 in brackets, NVIDIA H100
# 80GB HBM3, 700.00 W): ms a launch at the shape above, and the serial K
# rows a CTA walked, for the cost a K row
RNN_TB_ROW_MS = {"fused_gru": 0.1869, "fused_lstm": 0.2596}
RNN_TB_ROW_K_ROWS = RNN_TB // 32 * (RNN_DIN + RNN_H)
# larger cells (rows, din, H), checked and timed from CUDA graphs beside
# torch's cells: a deeper K, more rows, a wider H
RNN_LARGER = ((640, 896, 128), (2560, 128, 128), (640, 128, 512))
# the LM serving path: Qwen2.5-14B at full width and depth, bf16 weights;
# a prefill of LM_BATCH prompts of LM_SEQ tokens, then generate with
# LM_PROMPT-token prompts, LM_NEW new tokens and a cache of LM_SKV
LM_ARCH = "qwen2.5-14b"
LM_RT = RuntimeConfig(param_dtype="bf16")
LM_BATCH, LM_SEQ = 2, 2048
LM_PROMPT, LM_NEW, LM_SKV = 16, 16, 64
# logits, of max |logits| over the real vocabulary: TOL_LOGITS where the
# two paths do not compound a difference (a layer's attention sublayer on
# the same input; decode against the xla prefill, both with bf16 scores;
# relative to max |output| there), TOL_DRIFT across the full depth
# between paths that round at other places (fp32 against bf16 scores, or
# only another summation order: the kernel against its plain version),
# with the argmax over the vocabulary equal. Qwen2.5-14B's 48 random
# layers amplify a bf16 ulp: such paths measured 6.5e-2 to 1.05e-1 apart
# on the card (PERF.md, the flash findings), so the teacher-forced
# sublayers at TOL_LOGITS are the gate that tells a wrong kernel apart
TOL_LOGITS = 3e-2
TOL_DRIFT = 0.12
# a flash kernel against its plain version: fp32 differs only in the
# order of summation; bf16 by one or two bf16 ulps at |o| <= 3
TOL_FLASH = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_LSE = 1e-4
# the flash kernels' narrow cases (bq = bk = 128, or S where 128 does not
# divide it: min(bq, S) must divide S): S 64 and 200 leave the bf16
# kernel's 128-row q tile and 128-key kv tile partial
FLASH_HD, FLASH_S, FLASH_GROUPS = (16, 80, 96, 128), (64, 128, 200, 384), \
    (1, 3, 4, 5)
# and beside them (head_dim, S, Skv, causal, group): every head_dim the
# kernels take, and Skv unlike S
FLASH_EDGE = tuple((d, 200, 200, True, 4) for d in range(8, 129, 8)) + tuple(
    (d, s, skv, causal, 1) for d in (96, 128)
    for s, skv in ((200, 384), (384, 200)) for causal in (True, False))
# flash_fwd's timing: the median of FLASH_SAMPLES samples, the kernel and
# SDPA in turns, each sample FLASH_CALLS back-to-back calls (CUDA events),
# and the same from CUDA graphs of FLASH_CALLS calls
FLASH_SAMPLES, FLASH_CALLS = 9, 10
# the flash backward kernels' narrow cases (default bq = bk = 512: S 64
# and 200 leave the bf16 kernels' 128-row tiles partial, S 200 their 64-row
# streamed tiles too) and their tolerance, of max |plain| (the sums run in
# another order; bf16 rounds p and dS at values that differ by it)
FLASH_BWD_HD, FLASH_BWD_S = (32, 96, 128), (64, 128, 200)
# and beside them (head_dim, S, Skv, causal, group): every head_dim the
# kernels take, and Skv unlike S
FLASH_BWD_EDGE = tuple((d, 200, 200, True, 4) for d in range(8, 129, 8)) \
    + tuple((d, s, skv, causal, 1) for d in (96, 128)
            for s, skv in ((200, 384), (384, 200)) for causal in (True, False))
TOL_FLASH_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the LM training path: phi3-mini-3.8b at full width and depth, fp32
# parameters and AdamW moments, flash attention, per-layer remat, on
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ synthetic tokens
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_RT = RuntimeConfig(attn_impl="flash", remat=True)
TRAIN_OPT = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# the training gate: each layer's attention sublayer, teacher-forced, its
# dx and attention-weight grads, of max |other|. The pairs that tell a
# wrong kernel apart: flash on the kernels against flash on their plain
# versions, both with delta taken from an fp32 o, within
# TOL_FLASH_BWD[bf16] (measured 1.22e-2 on an H100, PERF.md, the
# training findings, as every figure here); the same two as the path runs
# them, with the JAX algorithm's delta from the bf16-rounded o, within
# TOL_TRAIN_PLAIN (measured 3.9e-2: where the kernel and its plain version
# round an o element apart, dS = p (dP - delta) moves that row's dq / dk);
# and the kernels with an fp32-o delta against the same sublayer in fp32
# (the xla path with fp32 activations) within TOL_TRAIN_REF (measured
# 1.3e-2). Flash against xla within TOL_TRAIN_LAYER bounds that bias of
# the algorithm, not the kernels: after three AdamW steps flash measured
# 0.13-0.15 from fp32 on dwq / dwk, xla 1.6e-2 (these two pairs logged,
# None). The full-depth loss and grad norm, flash against xla, within
# TOL_TRAIN_DRIFT relative: a limit that catches a blow-up only
TOL_TRAIN_PLAIN = 0.1
TOL_TRAIN_LAYER = 0.3
TOL_TRAIN_REF = 5e-2
TOL_TRAIN_DRIFT = 0.25
TRAIN_PAIRS = {
    "flash-fp32-o vs flash-plain-fp32-o": TOL_FLASH_BWD[torch.bfloat16],
    "flash vs flash-plain": TOL_TRAIN_PLAIN,
    "flash-fp32-o vs fp32": TOL_TRAIN_REF,
    "flash vs xla": TOL_TRAIN_LAYER,
    "flash vs fp32": None, "xla vs fp32": None}
# the DGNN trainer (examples/torch/train_evolvegcn.py) at the example's
# full width: TRAINER_STEPS steps with a checkpoint every
# TRAINER_CKPT_EVERY, a resume to TRAINER_RESUME_TO, and its first
# TRAINER_CPU_STEPS steps against the same run on the CPU within
# TOL_TRAINER relative (losses) and of each leaf's max |grad| (step 1)
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_RESUME_TO = 20, 10, 24
TRAINER_CPU_STEPS = 3
TOL_TRAINER = 1e-5
# the Mamba2 mixer and the MoE MLP at full width and depth, bf16 weights:
# a prefill of LM_BATCH x LM_SEQ tokens and generate as the LM phase's
SSM_MOE_ARCHS = ("mamba2-2.7b", "granite-moe-3b-a800m")
SSM_MOE_RT = RuntimeConfig(param_dtype="bf16", moe_impl="dense")
# path (c2), SSM / MoE training: the same two at full width and depth,
# fp32 parameters and AdamW moments, per-layer remat (the SSD's chunks
# recomputed inside it), the dense MoE, flash attention for granite;
# TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ as phi3's path (c). Its
# gates on step 1's gradients: granite's attention sublayers teacher-forced
# (train_layer_check, every TRAIN_PAIRS pair with a limit held to it, as
# phi3's gate holds them), one full-width Mamba2 mixer's input and weight
# grads on the card within TOL_SSM_GRAD of max |grad| of the same layer on
# the CPU (tests/test_torch_ssm_moe.py's TOL_GRAD: cuBLAS and the CPU
# round the bf16 intra-chunk scores apart), and granite's gradients with
# moe_impl="ep" at ample capacity on the world-1 NCCL 1x1 mesh against the
# dense path's (ep_grad_check)
MOE_TRAIN_ARCH = "granite-moe-3b-a800m"
SSM_MOE_TRAIN_RT = {
    "mamba2-2.7b": RuntimeConfig(remat=True, moe_impl="dense"),
    MOE_TRAIN_ARCH: RuntimeConfig(remat=True, moe_impl="dense",
                                  attn_impl="flash")}
TOL_SSM_GRAD = 3e-2
# the flash kernels' training shapes (3d / 3e): each arch and the key of
# its fields in the kernels' records
FLASH_TRAIN = {TRAIN_ARCH: "train_shape", MOE_TRAIN_ARCH: "granite_shape"}
# the sharding phase: a sharded DGNN launch's batch and shards (where the
# host has the cards), the world-1 collectives' tensor (64 MiB of fp32),
# the one-stage pipeline (micro-batches, rows, width; <= TOL_PIPE), and
# granite-moe-3b-a800m with moe_impl="ep" on the host mesh: each MoE
# sublayer teacher-forced at ample capacity within TOL_EP (the bound of
# tests/test_multidevice.py) of the dense path, then at the default
# capacity factors beside the dense path
SHARD_B, SHARD_N = 4, 2
COLLECTIVE_NUMEL = 16 * 2 ** 20
PIPE_MICRO, PIPE_ROWS, PIPE_D = 4, 64, 256
TOL_PIPE = 1e-5
EP_ARCH = "granite-moe-3b-a800m"
TOL_EP = 2e-2
# every example of the port, a process of its own, at small flags
EXAMPLES = {
    "train_evolvegcn": ["--steps", "10"],
    "quickstart": [],
    "serve_stream": ["--snapshots", "8", "--streams", "2"],
    "lm_generate": [],
}
REPLACES = {
    "gcrn_engine": "src/repro/kernels/stream_fused.py:833",
    "evolve_engine": "src/repro/kernels/stream_fused.py:1191",
    "stacked_engine": "src/repro/kernels/stream_fused.py:1015",
    "tgn_engine": "src/repro/kernels/stream_fused.py:1381",
    "static_engine": "src/repro/kernels/stream_fused.py:1562",
    "gcrn_step": "src/repro/kernels/dgnn_fused.py:58",
    "stacked_step": "src/repro/kernels/dgnn_fused.py:119",
    "ell_spmm": "src/repro/kernels/csr_spmm.py:47",
    # the engine's hbm_paged protocol: _Engine.stage_in / write_back /
    # paged_fill, with the family's cell
    **{name: "src/repro/kernels/stream_fused.py:515"
       for name in PAGED.values()},
    "fused_gru": "src/repro/kernels/fused_rnn.py:35",
    "fused_lstm": "src/repro/kernels/fused_rnn.py:75",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "flash_fwd": "src/repro/kernels/flash_attention.py:240",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention.py:155",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:196",
    # no Pallas kernel: XLA ops in EvolveGCN._edge_aggs
    "edge_terms": "src/repro/core/evolvegcn.py:112",
}


def log(*a):
    print(*a, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (not an ``assert``: ``-O`` drops those)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(fns, calls: int, samples: int) -> list:
    """Median ms a call of each of ``fns``: ``samples`` rounds, each timing
    ``calls`` back-to-back calls of every fn in turn with CUDA events (one
    warm-up call of each first), so all of them see the same clocks."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = [[] for _ in fns]
    for _ in range(samples):
        for t, fn in zip(times, fns):
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end) / calls)
    return [float(np.median(t)) for t in times]


def graph_of(make_call, calls: int, side=None):
    """A CUDA graph of ``calls`` calls of the function ``make_call()``
    returns, made on the capturing stream ``side`` (a new one unless given;
    a prepared launch binds the stream current at ``prepare``), after a
    warm-up on that stream."""
    side = torch.cuda.Stream() if side is None else side
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        make_call()()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn = make_call()
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return graph


def flat(r) -> list:
    """Tensors of a (nested) result: tuples, lists and state dicts."""
    if isinstance(r, dict):
        return [x for k in sorted(r) for x in flat(r[k])]
    if isinstance(r, (tuple, list)):
        return [x for y in r for x in flat(y)]
    return [r]


def max_err(a, b) -> float:
    """Largest absolute difference of two results (0 for two empty
    states)."""
    a, b = flat(a), flat(b)
    check(len(a) == len(b), "results of different structure")
    return max((float((x - y).abs().max()) for x, y in zip(a, b)),
               default=0.0)


def rel_err(got, want) -> float:
    """Largest |got - want| relative to max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bc_alpha():
    """The whole BC-Alpha stream padded into one bucket (numpy)."""
    tg, feat = generate_temporal_graph(BC_ALPHA, feat_dim=GCRN_M2.in_dim)
    locs = [renumber_and_normalize(s) for s in slice_snapshots(tg, 1.0)]
    k_max = max(4, max(max_in_degree(ls) for ls in locs))
    e_pad = max(ls.src.shape[0] for ls in locs)
    n_max = max(ls.n_nodes for ls in locs)
    check(n_max <= N_PAD, f"max nodes {n_max} > n_pad {N_PAD}")
    stream = stack_time([pad_snapshot(ls, feat, N_PAD, e_pad, k_max)
                         for ls in locs])
    log(f"bc-alpha: T={len(locs)} n_global={tg.n_global_nodes} "
        f"n_pad={N_PAD} e_pad={e_pad} k_max={k_max} max_nodes={n_max}")
    return stream, tg.n_global_nodes


def bc_alpha_events():
    """The BC-Alpha interactions as TGN event batches (numpy): sorted by
    time (stable), batches of ``EVENT_BATCH``, n_pad 640, k_max the most
    events a node has in one batch."""
    tg, feat = generate_temporal_graph(BC_ALPHA, feat_dim=TGN.in_dim)
    order = np.argsort(tg.time, kind="stable")
    src, dst, ts = tg.src[order], tg.dst[order], tg.time[order]
    cuts = range(0, src.size, EVENT_BATCH)
    k_max = max(int(np.unique(np.concatenate(
        [src[a:a + EVENT_BATCH], dst[a:a + EVENT_BATCH]]),
        return_counts=True)[1].max()) for a in cuts)
    blocks = [pad_event_block(src[a:a + EVENT_BATCH], dst[a:a + EVENT_BATCH],
                              ts[a:a + EVENT_BATCH], feat, N_PAD, k_max)
              for a in cuts]
    touched = [int(b.n_nodes) for b in blocks]
    log(f"bc-alpha events: {src.size} events, T={len(blocks)} batches of "
        f"{EVENT_BATCH}, n_global={tg.n_global_nodes} n_pad={N_PAD} "
        f"k_max={k_max} touched nodes {min(touched)}-{max(touched)} "
        f"(mean {np.mean(touched):.1f}), ts {ts.min()}-{ts.max()}")
    return stack_time(blocks)


def window(s, a: int, b: int):
    """Entries [a, b) of a padded snapshot or event-block stream."""
    return type(s)(**{k: v[a:b] for k, v in vars(s).items()})


def batch_of(s: PaddedSnapshot, wins) -> PaddedSnapshot:
    """B windows of one stream stacked to the longest (ragged)."""
    return stack_ragged([window(s, a, b) for a, b in wins], "cuda")[0]


# ------------------------------------------------------- bound counts ----

def _live(coef):
    """(rows with a nonzero lane, nonzero lanes) of (..., n, k) coef."""
    live = coef != 0
    return float(live.any(-1).sum()), float(live.sum()), live


def _distinct(index, live, rows_per_graph: int) -> int:
    """Distinct (graph, row) pairs the live lanes of (..., n, k) read."""
    graph = torch.arange(index[..., 0, 0].numel(), device=index.device)
    graph = graph.view(*index.shape[:-2], 1, 1) * rows_per_graph
    return torch.unique((graph + index)[live]).numel()


def gcrn_cost(inp):
    """(flop, bytes) the GCRN engine's function needs on these inputs: the
    ELL lanes, x row and row id of each real row (mask != 0), the edge
    messages its live lanes read, the weights, the stores in and out, the
    per-step h output, and the gather / scatter of each real row's h and c."""
    idx, coef, eidx, x, rowg, mask, h0, c0, wx, wh, b, em = inp
    B, T, n, k = idx.shape
    din, h = x.shape[-1], h0.shape[-1]
    rows = float((mask != 0).sum())
    _, lanes, live = _live(coef)
    flops = 2 * rows * (din + h) * 4 * h + 2 * lanes * (din + h)
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    if em is not None:
        byts += _distinct(eidx, live, em.shape[2]) * din * 4
    byts += nbytes(wx, wh, b) + 2 * nbytes(h0, c0) + B * T * n * h * 4
    byts += rows * 2 * h * 4 * 2
    return flops, byts


def stacked_cost(inp):
    """(flop, bytes) the stacked engine's function needs on these inputs:
    as ``gcrn_cost``, with the NT product and the GRU against the own row
    in place of the gate product, one store (h) instead of two."""
    idx, coef, eidx, x, rowg, mask, h0, wg, bg, wx, wh, b, em = inp
    B, T, n, k = idx.shape
    din, dmid, h = x.shape[-1], wg.shape[1], h0.shape[-1]
    rows = float((mask != 0).sum())
    _, lanes, live = _live(coef)
    flops = (2 * rows * (din * dmid + dmid * 3 * h + h * 3 * h)
             + 2 * lanes * din)
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    if em is not None:
        flops += lanes * din
        byts += _distinct(eidx, live, em.shape[2]) * din * 4
    byts += nbytes(wg, bg, wx, wh, b) + 2 * nbytes(h0) + B * T * n * h * 4
    byts += rows * h * 4 * 2
    return flops, byts


def evolve_cost(inp, dims):
    """(flop, bytes) the EvolveGCN kernel's function needs on these inputs,
    at each layer's true widths ``dims``: the ELL lanes and x row of each
    real row, its edge term at each layer's input width, the live flags,
    the weights in and out, the GCN and GRU params, and the output."""
    idx, coef, x, mask, live, *_ = inp
    B, T, n, k = idx.shape
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    n_live = float(live.sum())
    flops = 0.0
    for din, dout in dims:
        flops += 2 * lanes * din + 2 * rows * din * dout
        flops += n_live * 2 * (2 * dout * din * 3 * din)
    byts = nbytes(mask, live) + rows * (k * 2 * 4 + dims[0][0] * 4)
    if inp[-1] is not None:
        byts += rows * sum(din for din, _ in dims) * 4
    byts += B * T * n * dims[-1][1] * 4
    byts += 4 * sum(2 * B * din * dout + dout + 2 * din * 3 * din + 3 * din
                    for din, dout in dims)
    return flops, byts


def tgn_cost(inp):
    """(flop, bytes) the TGN engine's function needs on these inputs: per
    touched row (mask != 0) its lanes' ids, coefs and times, its x row and
    row id, the input projection and the GRU; per live lane and column the
    two aggregations, ts * freq and one cos (counted as one operation); the
    weights, the store in and out, the per-batch outputs, and the gather /
    scatter of each touched row's memory (partners are touched rows of the
    same batch, so their reads are those gathers)."""
    gidx, coef, ts, x, rowg, mask, mem0, freq, w_in, wx, wh, b = inp
    B, T, n, k = gidx.shape
    din, h = x.shape[-1], mem0.shape[-1]
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    flops = (2 * rows * (din * h + 2 * h * 3 * h)
             + lanes * h * (2 * 2 + 1 + 1))
    byts = nbytes(mask) + rows * (k * 3 * 4 + din * 4 + 4)
    byts += nbytes(freq, w_in, wx, wh, b) + 2 * nbytes(mem0)
    byts += B * T * n * h * 4 + rows * h * 4 * 2
    return flops, byts


def static_cost(inp, dims):
    """(flop, bytes) the static GCN kernel's function needs on these
    inputs, at each layer's true widths ``dims``: per real row (mask != 0)
    its lanes, its x row, its edge term at layer 0's input width and each
    layer's product; per live lane each layer's aggregation; the shared
    weights once; the output at its true width."""
    idx, coef, x, mask, w, bg, eagg = inp
    B, T, n, k = idx.shape
    rows = float((mask != 0).sum())
    lanes = float((coef != 0).sum())
    flops = sum(2 * lanes * din + 2 * rows * din * dout
                for din, dout in dims)
    byts = nbytes(mask) + rows * (k * 2 * 4 + dims[0][0] * 4)
    if eagg is not None:
        flops += rows * dims[0][0]
        byts += rows * dims[0][0] * 4
    byts += 4 * sum(din * dout + dout for din, dout in dims)
    byts += B * T * n * dims[-1][1] * 4
    return flops, byts


def ell_cost(call):
    """(flop, bytes) of one ELL SpMM: the lanes of rows with a live lane,
    the x rows and edge rows the live lanes read, the whole output."""
    idx, coef, eidx, x, em = call
    n, k, d = idx.shape[-2], idx.shape[-1], x.shape[-1]
    rows, lanes, live = _live(coef)
    flops = 2 * lanes * d
    byts = rows * k * 4 * 2 + _distinct(idx, live, x.shape[-2]) * d * 4
    if em is not None:
        flops += lanes * d
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[-2]) * d * 4
    return flops, byts + n * d * 4


def gcrn_step_cost(call):
    """(flop, bytes) of one V2 GC-LSTM step: the gate product of rows with
    a live lane (a row without one takes the bias as its gates), the ELL
    lanes of those rows, the x / h / edge rows live lanes read, every c
    row, the weights, the h and c outputs."""
    idx, coef, eidx, x, h, c, wx, wh, b, em = call
    n, k = idx.shape
    din, H = x.shape[1], h.shape[1]
    rows, lanes, live = _live(coef)
    src = _distinct(idx, live, n)
    flops = 2 * rows * (din + H) * 4 * H + 2 * lanes * (din + H)
    byts = rows * k * 4 * 2 + src * (din + H) * 4 + nbytes(c, wx, wh, b)
    if em is not None:
        flops += lanes * din
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[0]) * din * 4
    return flops, byts + 2 * n * H * 4


def stacked_step_cost(call):
    """(flop, bytes) of one V2 GCN -> GRU step: the NT product of rows with
    a live lane (nt = bg on the others), the GRU of rows with a live lane or
    a nonzero h (the rest share one value), the ELL lanes, the x / edge
    rows live lanes read, every h row, the weights, the output."""
    idx, coef, eidx, x, h, wg, bg, wx, wh, b, em = call
    n, k = idx.shape
    din, dmid, H = x.shape[1], wg.shape[1], h.shape[1]
    rows, lanes, live = _live(coef)
    gru_rows = float((live.any(-1) | (h != 0).any(-1)).sum()) + 1
    flops = (2 * lanes * din + 2 * rows * din * dmid
             + 2 * gru_rows * (dmid * 3 * H + H * 3 * H))
    byts = (rows * k * 4 * 2 + _distinct(idx, live, n) * din * 4
            + nbytes(h, wg, bg, wx, wh, b))
    if em is not None:
        flops += lanes * din
        byts += rows * k * 4 + _distinct(eidx, live, em.shape[0]) * din * 4
    return flops, byts + n * H * 4


def bound(flops, byts):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, byts / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ------------------------------------------------------------ kernels ----

def kernel_inputs(model, params, snaps, lengths=None, residency="vmem"):
    """The kernel wrapper's inputs for a (B, T, ...) batch: the model's
    stream arguments, packed by kernels/ops.py as the main path packs them
    (the static GCN's (B, T) snapshots folded onto (B * T, 1) slots, its
    lengths turned into per-slot liveness, as StaticGCN does; TGN's
    partners as local ids for its paged engine)."""
    if model.stream_family == "static_gcn":
        snaps, lengths = model.fold_slots(snaps, lengths)
    B = snaps.node_mask.shape[0]
    state = init_states_batched(model, params, B)
    return ops.pack(model.stream_family,
                    *model.stream_args(params, state, snaps), lengths=lengths,
                    residency=residency)


def record(name: str, **kw):
    """A kernel's JSON record with the keys every kernel carries."""
    return {"name": name, "route": "cuda",
            "source": f"{SRC}/{engine.SOURCE[name]}.cu",
            "replaces": REPLACES[name], "launches": 0, "library_ms": None,
            **kw}


def expect_raises(fn, exc, text: str) -> str:
    """Run ``fn``, which must raise ``exc`` with ``text`` in its message;
    returns the message. Anything else ends the run."""
    try:
        fn()
    except exc as e:
        check(text in str(e), f"{exc.__name__} without {text!r}: {e}")
        return str(e)
    raise RuntimeError(f"chip_smoke check failed: no {exc.__name__} "
                       f"({text!r})")


def bitwise(a, b) -> bool:
    """Two results of the same structure are equal bit for bit."""
    a, b = flat(a), flat(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def check_engine(name, kernel, plain, check_inp, main_inp, cost, tol_main):
    """A stream engine vs its plain version on the card (the main path's
    inputs within ``tol_main``); its record."""
    got, want = kernel(*check_inp), plain(*check_inp)
    torch.cuda.synchronize()
    err_small = max_err(got, want)
    log(f"{name}: T=8 B=2 ragged max_abs_err={err_small:.3e} "
        f"(tol {TOL_KERNEL})")
    check(np.isfinite(err_small) and err_small <= TOL_KERNEL, name)
    got, want = kernel(*main_inp), plain(*main_inp)
    torch.cuda.synchronize()
    err = max_err(got, want)
    log(f"{name}: main-path shapes max_abs_err={err:.3e} (tol {tol_main})")
    check(np.isfinite(err) and err <= tol_main, name)
    ms = cuda_ms(lambda: kernel(*main_inp), reps=5)
    plain_ms = cuda_ms(lambda: plain(*main_inp), reps=2)
    flops, byts = cost(main_inp)
    bound_ms, bound_by = bound(flops, byts)
    log(f"{name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
        f"bound {bound_ms:.4f} ms ({flops:.3e} flop, {byts:.3e} B)")
    return record(name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, err_t8_b2=err_small)


def check_paged_engine(family, resident_inp, paged_inp, cost, ms_resident):
    """A paged engine on the inputs of ``check_engine`` (``resident_inp`` /
    ``paged_inp``: (T = 8 B = 2 ragged, main path) packed for the resident
    and the paged wrapper) at td 16 and every ring depth: bit for bit
    against the resident kernel, against its plain version (<= 1e-4 /
    <= 1e-3), and timed beside the resident kernel in the same run; its
    record (``ms`` at depth 2, the main path's default)."""
    name, resident = PAGED[family], getattr(engine, ENGINE[family])
    kernel = getattr(engine, name)
    plain = getattr(engine, f"{family}_paged_plain")
    ring = lambda d: dict(td=PAGED_TD, depth=d)
    errs = {}
    for label, r_in, p_in, tol in (
            ("T=8 B=2 ragged", resident_inp[0], paged_inp[0], TOL_KERNEL),
            ("main-path shapes", resident_inp[1], paged_inp[1], TOL_STREAM)):
        want_r = resident(*r_in)
        want_p = plain(*p_in, **ring(2))
        for depth in engine.RING_DEPTHS:
            got = kernel(*p_in, **ring(depth))
            torch.cuda.synchronize()
            same = bitwise(got, want_r)
            err = max_err(got, want_p)
            errs[(label, depth)] = err
            log(f"{name}: {label} td={PAGED_TD} depth={depth} bitwise vs "
                f"{ENGINE[family]} {same}, max_abs_err={err:.3e} vs plain "
                f"(tol {tol})")
            check(same, f"{name} depth {depth} {label} bit-identical")
            check(np.isfinite(err) and err <= tol, f"{name} {label}")
    main_p, main_r = paged_inp[1], resident_inp[1]
    ms = {d: cuda_ms(lambda d=d: kernel(*main_p, **ring(d)), reps=5)
          for d in engine.RING_DEPTHS}
    ms_res = cuda_ms(lambda: resident(*main_r), reps=5)
    plain_ms = cuda_ms(lambda: plain(*main_p, **ring(2)), reps=2)
    flops, byts = cost(main_r)
    bound_ms, bound_by = bound(flops, byts)
    log(f"{name}: depth 1/2/4 {ms[1]:.3f} / {ms[2]:.3f} / {ms[4]:.3f} ms, "
        f"{ENGINE[family]} {ms_res:.3f} ms in this run ({ms_resident:.3f} "
        f"in its own check), {plain_ms:.3f} ms plain, bound {bound_ms:.4f} "
        f"ms ({flops:.3e} flop, {byts:.3e} B)")
    return record(name, max_abs_err=errs[("main-path shapes", 2)], ms=ms[2],
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  ms_depth={str(d): v for d, v in ms.items()},
                  resident_ms=ms_res, td=PAGED_TD,
                  err_t8_b2=max(v for (lb, _), v in errs.items()
                                if lb.startswith("T=8")))


# ------------------------------------------------- the static checker ----
# repro_torch.analysis on the card: its whole run (the contract pass
# launches every stateful sweep point with its protocol log and holds the
# libraries' shared memory, cluster launches and static plan against the
# port's mirrors), each sweep point's device log against its plain version
# row for row, and the main path's own launches with the log: the four
# paged engines at every depth and the four resident ones, full width.

# samples of the eight engine variants timed in turns with another
# checkout's build (``--parent DIR``)
TURN_SAMPLES = 9


def logged_launch(name, inp, label, **ring) -> int:
    """Engine ``name`` on ``inp`` with its protocol log and without: the
    results bit for bit equal, the log its plain version's rows (that of
    the same launch, recorded), replayed clean and not overflowed. Returns
    its rows."""
    kernel = getattr(engine, name)
    got = kernel(*inp, **ring, proto=True)
    base = kernel(*inp, **ring)
    torch.cuda.synchronize()
    plog = got[-1]
    with engine.recording_launches() as recorded:
        kernel(*inp, **ring)
    plain = engine.protocol_of(recorded[0])
    findings = contracts.replay(plog, label)
    for f in findings[:5]:
        log(f"  {f.rule}: {f.message}")
    rings = sorted({int(r) for r in plog.rows[:, 1]})
    log(f"{label}: {len(plog.rows)} log rows (rings {rings}, capacity "
        f"{plog.capacity}), {len(findings)} finding(s), the plain log's "
        f"rows {np.array_equal(plog.rows, plain.rows)}, results bit for bit "
        f"{bitwise(got[:-1], base)}")
    check(not findings and not plog.overflow, f"{label}: protocol replay")
    check(np.array_equal(plog.rows, plain.rows),
          f"{label}: the device log is its plain version's")
    check(bitwise(got[:-1], base), f"{label}: results with the log")
    return len(plog.rows)


def parent_engine(root: Path):
    """``kernels/engine.py`` of another checkout at ``root`` (its sources,
    its build directory under ``root``)."""
    import importlib.util

    path = root / "src" / "repro_torch" / "kernels" / "engine.py"
    spec = importlib.util.spec_from_file_location("parent_engine", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def parent_turns(parent: Path, inputs, paged_inputs) -> dict:
    """The eight engine variants (resident; paged at td 16, depths 1 / 2 /
    4) on the main path's inputs, this tree's build and ``parent``'s in
    turns (parent, this, this, parent; medians of TURN_SAMPLES rounds of
    2 calls): {label: (parent ms, this ms)}."""
    other = parent_engine(parent)
    other.build(tuple(ENGINE[f] for f in PAGED))
    out = {}
    for family in PAGED:
        variants = [(ENGINE[family], inputs[family][1], {})] + [
            (PAGED[family], paged_inputs[family][1],
             dict(td=PAGED_TD, depth=d)) for d in engine.RING_DEPTHS]
        for name, inp, ring in variants:
            a = lambda n=name, i=inp, r=ring: getattr(other, n)(*i, **r)
            b = lambda n=name, i=inp, r=ring: getattr(engine, n)(*i, **r)
            check(bitwise(a(), b()), f"{name} {ring}: parent's bits")
            a1, b1, b2, a2 = interleaved_ms([a, b, b, a], 2, TURN_SAMPLES)
            label = name + (f" d{ring['depth']}" if ring else "")
            out[label] = ((a1 + a2) / 2, (b1 + b2) / 2)
            log(f"turns {label}: parent {out[label][0]:.4f} ms, this "
                f"{out[label][1]:.4f} ms (proto null; {a1:.4f} / {b1:.4f} / "
                f"{b2:.4f} / {a2:.4f})")
    return out


def analysis_phase(inputs, paged_inputs, parent=None) -> dict:
    """The static checker on the card (zero findings), then the sweep's
    and the main path's protocol logs; with ``parent``, the eight engine
    variants in turns with that checkout's build. Returns the summary
    that chip_smoke prints as its ``{"analysis": ...}`` line."""
    t0 = time.time()
    report = analysis.run_all(device="cuda")
    log(f"repro_torch.analysis --device cuda: {report.to_text()}")
    check(not report.findings and not report.suppressed,
          "the analyzer on the card: 0 findings")
    points = contracts.registry_points()
    rows = 0
    for point in points:
        (rec,) = contracts.record_point(point)
        if rec.name not in engine.CLUSTER_ENGINES:
            continue
        plog = contracts.launch_logged(rec)
        same = np.array_equal(plog.rows, engine.protocol_of(rec).rows)
        check(same and not plog.overflow,
              f"{point.label()}: the device log is its plain version's")
        rows += len(plog.rows)
    log(f"analysis: {len(points)} sweep points, {rows} device log rows, "
        "each its plain version's")
    main_rows = {}
    for family in PAGED:
        name = ENGINE[family]
        main_rows[name] = logged_launch(name, inputs[family][1],
                                        f"{name} main path")
        for d in engine.RING_DEPTHS:
            label = f"{PAGED[family]} d{d}"
            main_rows[label] = logged_launch(
                PAGED[family], paged_inputs[family][1], f"{label} main path",
                td=PAGED_TD, depth=d)
    check(all(main_rows[ENGINE[f]] == 0 for f in ("gcrn", "stacked", "tgn")),
          "resident GCRN, stacked and TGN launches log nothing")
    summary = {"points": len(points), "findings": len(report.findings),
               "suppressed": report.suppressed,
               "rules": len(report.rules_run), "sweep_log_rows": rows,
               "main_log_rows": main_rows}
    if parent is not None:
        summary["turns_ms"] = {k: list(v) for k, v in parent_turns(
            parent, inputs, paged_inputs).items()}
    log(f"analysis phase: {time.time() - t0:.1f} s")
    return summary


# ------------------------------------------------- the cluster engines ----
# The four stateful engines, resident and paged, run one stream on a
# thread-block cluster of engine.CLUSTER CTAs, each owning a slice of the
# state's columns (hidden units, columns of W_l). Their narrow cases: slices
# that C does not divide evenly, B past one wave of clusters, a length-0
# stream and a dead step, against the plain versions (TOL_KERNEL) and bit
# for bit between residencies and between two calls; and the launch the
# library builds against engine.engine_cluster_config. Then the widest
# plans the one-CTA kernels took, and n past 65,536 rows (two chunks of
# live-tile bits) for every name.
CLUSTER_TDS = (8, 16)
CLUSTER_FAMILIES = ("gcrn", "evolve", "stacked", "tgn")
#: rows of a step past one chunk of a CTA's live-tile bits
CLUSTER_ROWS_PAST = 66_000


def cluster_rows(rng, B, T, n):
    """Real rows of each step: ragged counts; every step of stream 1 (of 3
    or more) empty (a length-0 stream) and step 1 of stream 0 empty."""
    nr = rng.integers(max(1, n // 4), n + 1, (B, T))
    if B >= 3:
        nr[1] = 0
    if T > 2:
        nr[0, 1] = 0
    return nr


def cluster_ell(rng, B, T, n, k, nr):
    """(real-row mask, ELL ids, coefs) of random steps with nr real rows."""
    rows = np.arange(n) < nr[..., None]
    idx = (rng.random((B, T, n, k)) * np.maximum(nr, 1)[..., None, None]
           ).astype(np.int32)
    coef = (rng.random((B, T, n, k)) * (rng.random((B, T, n, k)) > 0.3)
            * rows[..., None]).astype(np.float32)
    return rows, idx, coef


def cluster_rowg(rng, B, T, n, G, rows):
    """Distinct global rows of each step's real rows, G on padding."""
    perm = np.stack([[rng.permutation(G)[:n] for _ in range(T)]
                     for _ in range(B)])
    return np.where(rows, perm, G).astype(np.int32)


def on_card(args):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            .cuda() for a in args]


def cluster_gcrn_case(seed, B, T, n, k, din, H, G, edges):
    """Random packed gcrn_engine inputs on the card (numpy, from seed)."""
    rng = np.random.default_rng(seed)
    rows, idx, coef = cluster_ell(rng, B, T, n, k, cluster_rows(rng, B, T, n))
    e = 3 * n
    eidx = rng.integers(0, e, (B, T, n, k)).astype(np.int32)
    rowg = cluster_rowg(rng, B, T, n, G, rows)
    mask = rows.astype(np.float32)
    f = lambda *sh: (rng.normal(size=sh) * 0.3).astype(np.float32)
    args = [idx, coef, eidx, f(B, T, n, din) * mask[..., None], rowg, mask,
            f(B, G, H), f(B, G, H), f(din, 4 * H), f(H, 4 * H), f(4 * H)]
    if edges:
        args.append(f(B, T, e, din))
    return on_card(args)


def cluster_evolve_case(seed, B, T, n, k, L, D, edges):
    """Random packed evolve_engine inputs on the card (numpy, from seed);
    the D-wide weights scaled by 4 / sqrt(D) so their sums stay of order
    1."""
    rng = np.random.default_rng(seed)
    nr = cluster_rows(rng, B, T, n)
    rows, idx, coef = cluster_ell(rng, B, T, n, k, nr)
    mask = rows.astype(np.float32)
    live = (nr > 0).astype(np.int32)
    f = lambda *sh: (rng.normal(size=sh) * 0.3).astype(np.float32)
    wide = min(1.0, 4.0 / float(np.sqrt(D)))
    args = [idx, coef, f(B, T, n, D) * mask[..., None], mask, live,
            f(B, L, D, D) * wide, f(L, D), f(L, D, 3 * D) * wide,
            f(L, D, 3 * D) * wide, f(L, 3 * D)]
    if edges:
        args.append(f(B, T, L, n, D))
    return on_card(args)


def cluster_stacked_case(seed, B, T, n, k, din, dmid, H, G, edges):
    """Random packed stacked_engine inputs on the card (numpy, from seed);
    the wide weights scaled by 4 / sqrt(width) so their sums stay of order
    1."""
    rng = np.random.default_rng(seed)
    rows, idx, coef = cluster_ell(rng, B, T, n, k, cluster_rows(rng, B, T, n))
    e = 3 * n
    eidx = rng.integers(0, e, (B, T, n, k)).astype(np.int32)
    rowg = cluster_rowg(rng, B, T, n, G, rows)
    mask = rows.astype(np.float32)
    f = lambda *sh: (rng.normal(size=sh) * 0.3).astype(np.float32)
    sc = lambda w: min(1.0, 4.0 / float(np.sqrt(w)))
    args = [idx, coef, eidx, f(B, T, n, din) * mask[..., None], rowg, mask,
            f(B, G, H), f(din, dmid) * sc(din), f(dmid),
            f(dmid, 3 * H) * sc(dmid), f(H, 3 * H) * sc(H), f(3 * H)]
    if edges:
        args.append(f(B, T, e, din))
    return on_card(args)


def cluster_tgn_case(seed, B, T, n, k, din, H, G):
    """Random packed tgn_engine inputs on the card (numpy, from seed) under
    the event contract (every live lane's partner a real row of its
    batch), event times up to 137 (BC-Alpha's); returns (resident args:
    partners by global row, paged args: by local id)."""
    rng = np.random.default_rng(seed)
    rows, idx, coef = cluster_ell(rng, B, T, n, k, cluster_rows(rng, B, T, n))
    rowg = cluster_rowg(rng, B, T, n, G, rows)
    gidx = np.take_along_axis(rowg, idx.reshape(B, T, n * k), axis=-1)
    gidx = np.where(gidx < G, gidx, 0).reshape(B, T, n, k).astype(np.int32)
    ts = (rng.uniform(0.0, 137.0, (B, T, n, k)) * (coef != 0)).astype(
        np.float32)
    mask = rows.astype(np.float32)
    f = lambda *sh: (rng.normal(size=sh) * 0.3).astype(np.float32)
    sc = lambda w: min(1.0, 4.0 / float(np.sqrt(w)))
    freq = (1.0 / 10.0 ** np.linspace(0.0, 4.0, H)).astype(np.float32)
    rest = [coef, ts, f(B, T, n, din) * mask[..., None], rowg, mask,
            f(B, G, H), freq, f(din, H) * sc(din), f(H, 3 * H) * sc(H),
            f(H, 3 * H) * sc(H), f(3 * H)]
    rest = on_card(rest)
    return on_card([gidx])[0:1] + rest, on_card([idx])[0:1] + rest


def cluster_narrow_cases():
    """(family, label, args, run resident): GCRN at (H, din, n, k) = (20,
    12, 40, 5), (24, 13, 37, 5), (128, 64, 640, 27), (128, 64, 1000, 27)
    (n 1000: the resident CTA's gathered rows do not fit its shared memory
    and sit in global scratch); EvolveGCN at (D, n, k) = (8, 40, 5), (24,
    37, 5), (128, 640, 27), (256, 40, 5) (D 256 paged only: the resident CTA
    is over the card); the stacked engine at (H, din, dmid, n, k) = (20, 12,
    16, 40, 5), (24, 13, 24, 37, 5), (128, 64, 128, 640, 27), (128, 64, 128,
    1000, 27); TGN at (H, din, n, k) = (20, 12, 40, 5), (24, 13, 37, 5),
    (128, 64, 640, 22), (128, 64, 1000, 22); each with and without edge
    messages / edge terms (TGN has none), at B 1, 2 and 17 (17 clusters:
    more than the card holds at once; n 640 and 1000 at B 1 and 2 only), 3
    steps. TGN's args are (resident, paged)."""
    cases = []
    for B in (1, 2, 17):
        for H, din, n, k in ((20, 12, 40, 5), (24, 13, 37, 5),
                             (128, 64, 640, 27), (128, 64, 1000, 27)):
            if B == 17 and n >= 640:
                continue
            for edges in (False, True):
                cases.append(("gcrn", f"B={B} H={H} din={din} n={n} "
                              f"edges={edges}",
                              cluster_gcrn_case(B * 7 + H, B, 3, n, k, din, H,
                                                2 * n + 9, edges), True))
                dmid = {12: 16, 13: 24}.get(din, 128)
                cases.append(("stacked", f"B={B} H={H} din={din} dmid={dmid} "
                              f"n={n} edges={edges}",
                              cluster_stacked_case(B * 5 + H, B, 3, n, k, din,
                                                   dmid, H, 2 * n + 9, edges),
                              True))
            kt = 22 if k == 27 else k
            cases.append(("tgn", f"B={B} H={H} din={din} n={n} k={kt}",
                          cluster_tgn_case(B * 3 + H, B, 3, n, kt, din, H,
                                           2 * n + 9), True))
        for D, n, k in ((8, 40, 5), (24, 37, 5), (128, 640, 27),
                        (256, 40, 5)):
            if B == 17 and n == 640:
                continue
            for edges in (False, True):
                cases.append(("evolve", f"B={B} D={D} n={n} edges={edges}",
                              cluster_evolve_case(B * 11 + D, B, 3, n, k, 2,
                                                  D, edges),
                              engine.smem_bytes("evolve_engine", k=k, L=2, D=D)
                              <= engine.SMEM_LIMIT))
    return cases


def cluster_wide_cases():
    """The widest plans the one-CTA kernels took, resident (their CTA holds
    its weights in global memory there): the stacked engine at k 27, din
    64, dmid = H = 736 and dmid 128, H 1,348; TGN at k 22, din 64, H 496
    and k 27, H 492; and paged TGN at n 1,400 (td 16, depth 2), which the
    one-CTA kernel refused; B 1, 2 steps."""
    return [
        ("stacked", "widest dmid=H=736", cluster_stacked_case(
            41, 1, 2, 64, 27, 64, 736, 736, 200, True), True),
        ("stacked", "widest dmid=128 H=1348", cluster_stacked_case(
            42, 1, 2, 64, 27, 64, 128, 1348, 200, False), True),
        ("tgn", "widest k=22 H=496", cluster_tgn_case(
            43, 1, 2, 64, 22, 64, 496, 200), True),
        ("tgn", "widest k=27 H=492", cluster_tgn_case(
            44, 1, 2, 64, 27, 64, 492, 200), True),
        ("tgn", "n=1400 k=22 H=128", cluster_tgn_case(
            45, 1, 2, 1400, 22, 64, 128, 2809), True),
    ]


def cluster_rows_past_cases():
    """One narrow case a family at n CLUSTER_ROWS_PAST (two chunks of
    live-tile bits), B 1, 2 steps."""
    n = CLUSTER_ROWS_PAST
    return [
        ("gcrn", f"n={n}", cluster_gcrn_case(51, 1, 2, n, 5, 12, 24,
                                             n + 9, False), True),
        ("evolve", f"n={n}", cluster_evolve_case(52, 1, 2, n, 5, 2, 24,
                                                 False), True),
        ("stacked", f"n={n}", cluster_stacked_case(53, 1, 2, n, 5, 12, 16, 24,
                                                   n + 9, False), True),
        ("tgn", f"n={n}", cluster_tgn_case(54, 1, 2, n, 5, 12, 24, n + 9),
         True),
    ]


def cluster_dims(family, args) -> dict:
    """The shared-memory dims of a packed cluster-engine call."""
    if family == "gcrn":
        return dict(k=args[0].shape[-1], din=args[3].shape[-1],
                    H=args[6].shape[-1], n=args[0].shape[2])
    if family == "stacked":
        return dict(k=args[0].shape[-1], din=args[3].shape[-1],
                    dmid=args[7].shape[-1], H=args[6].shape[-1])
    if family == "tgn":
        return dict(k=args[0].shape[-1], din=args[3].shape[-1],
                    H=args[6].shape[-1])
    return dict(k=args[0].shape[-1], L=args[5].shape[1], D=args[5].shape[2])


def cluster_paged_dims(family, dims, td, depth, n) -> dict:
    d = {key: v for key, v in dims.items()
         if not (family == "evolve" and key == "L")}
    if family == "tgn":
        d["n"] = n
    return dict(d, td=td, depth=depth)


def check_cluster_config(name, B, dims) -> dict:
    """The library's launch of ``name`` over B streams equals the mirror's
    (cluster, CTAs, threads, a CTA's shared memory, every CTA's column
    slice, stacked / TGN: the weights in shared memory or not); returns the
    library's."""
    want = engine.engine_cluster_config(name, B, **dims)
    got = engine.library_engine_cluster_config(name, B, **dims)
    check(all(got[key] == v for key, v in want.items())
          and engine.library_smem_bytes(name, **dims) == want["smem"],
          f"{name} B={B} {dims}: library launch {got} == mirror {want}")
    return got


def cluster_case_check(family, label, args, resident, config=True,
                       tds=CLUSTER_TDS, depths=engine.RING_DEPTHS) -> float:
    """One narrow case: the resident kernel within TOL_KERNEL of its plain
    version, two calls bit for bit equal, then the paged kernel at ``tds``
    and ``depths`` (where its CTA fits) within TOL_KERNEL and bit for bit
    equal to the resident one (or to itself where there is none); with
    ``config``, every launch's library config against the mirror. TGN's
    args are (resident, paged): partners by global row, by local id.
    Returns the largest error."""
    kernel = getattr(engine, f"{family}_engine")
    paged = getattr(engine, f"{family}_engine_paged")
    plain = getattr(engine, f"{family}_plain")
    args, p_args = args if family == "tgn" else (args, args)
    B, n, dims = args[0].shape[0], args[0].shape[2], cluster_dims(family, args)
    want = plain(*args)
    ref, worst = None, 0.0
    if resident:
        if config:
            check_cluster_config(f"{family}_engine", B, dims)
        ref, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        worst = max_err(ref, want)
        check(np.isfinite(worst) and worst <= TOL_KERNEL,
              f"{family}_engine {label}: {worst:.3e} vs plain")
        check(bitwise(ref, again), f"{family}_engine {label}: two calls")
    for td in tds:
        for depth in depths:
            pd = cluster_paged_dims(family, dims, td, depth, n)
            if engine.smem_bytes(f"{family}_engine_paged", **pd) > \
                    engine.SMEM_LIMIT:
                continue
            if config:
                check_cluster_config(f"{family}_engine_paged", B, pd)
            got = paged(*p_args, td=td, depth=depth)
            torch.cuda.synchronize()
            err = max_err(got, want)
            worst = max(worst, err)
            what = f"{family}_engine_paged {label} td={td} depth={depth}"
            check(np.isfinite(err) and err <= TOL_KERNEL,
                  f"{what}: {err:.3e} vs plain")
            check(bitwise(got, ref if ref is not None else
                          paged(*p_args, td=td, depth=depth)),
                  f"{what}: bit for bit vs "
                  + ("resident" if ref is not None else "a second call"))
    return worst


def cluster_timings(inputs, label="") -> dict:
    """ms a call of the cluster engines on the main path's inputs
    (``inputs``: {(family, B): (resident args, paged args)}, B 1 and 4),
    resident and paged (td PAGED_TD) at every ring depth, in turns
    (interleaved_ms: median of 5 samples of one call each)."""
    out = {}
    for (family, B), (args, p_args) in inputs.items():
        kernel = getattr(engine, f"{family}_engine")
        paged = getattr(engine, f"{family}_engine_paged")
        fns = {"resident": lambda: kernel(*args)}
        for d in engine.RING_DEPTHS:
            fns[f"paged d{d}"] = lambda d=d: paged(*p_args, td=PAGED_TD,
                                                   depth=d)
        for key, ms in zip(fns, interleaved_ms(list(fns.values()), 1, 5)):
            out[(family, B, key)] = ms
        log(f"{family}_engine{label} B={B} in turns: "
            + ", ".join(f"{key} {out[(family, B, key)]:.4f} ms"
                        for key in fns))
    return out


#: the cluster-engine functions whose spills ptxas must report as 0 (the
#: redesigned stacked and TGN engines, resident and paged), by source
NO_SPILL = ("stacked_engine", "tgn_engine")


def spill_bytes(source: str) -> dict:
    """{kernel function: spill store + load bytes} of a source's build, from
    ptxas's -v report in engine.BUILD_LOG (kept beside the library, so a
    library built by an earlier run reports too)."""
    out, func = {}, None
    for line in engine.BUILD_LOG.get(source, "").splitlines():
        if "Function properties for" in line:
            func = line.split("Function properties for")[1].strip()
        elif "spill stores" in line and func is not None:
            words = line.replace(",", " ").split()
            out[func] = sum(int(words[i - 2]) for i, w in enumerate(words)
                            if w == "spill" and i > 1)
    return out


def cluster_engine_checks(main_inputs) -> dict:
    """The narrow cases, the widest plans, n past one chunk of live-tile
    bits, 0 spill bytes for the redesigned engines, the main path's launch
    config (B 1 and 4) and the timings in turns; returns {kernel: extra
    record fields}."""
    t0 = time.time()
    for source in NO_SPILL:
        spills = spill_bytes(source)
        log(f"{source}: ptxas spill bytes {spills}")
        # resident, paged, and paged with its protocol log
        engine_fns = [f for f in spills if "engine_kernel" in f]
        check(len(engine_fns) == 3 and not any(spills[f] for f in engine_fns),
              f"{source}: 0 spill bytes in all three kernels ({spills})")
    worst = {family: 0.0 for family in CLUSTER_FAMILIES}
    cases = cluster_narrow_cases()
    for family, label, args, resident in cases:
        worst[family] = max(worst[family],
                            cluster_case_check(family, label, args, resident))
    log(f"cluster engines: {len(cases)} narrow cases (H 20 / 24 / 128, "
        f"n 37 to 1000, D 8 / 24 / 128 / 256, B 1 / 2 / 17) within "
        f"{TOL_KERNEL} (largest "
        + ", ".join(f"{worst[f]:.3e} {f}" for f in CLUSTER_FAMILIES)
        + f"), paged bit for bit at td {CLUSTER_TDS} and depths "
        f"{engine.RING_DEPTHS}, {time.time() - t0:.1f} s")
    t0 = time.time()
    for family, label, args, resident in cluster_wide_cases():
        err = cluster_case_check(family, label, args, resident, tds=(16,),
                                 depths=(2,))
        dims = cluster_dims(family, args[0] if family == "tgn" else args)
        cfg = engine.engine_cluster_config(f"{family}_engine", 1, **dims)
        log(f"{family}_engine {label}: max_abs_err={err:.3e} (tol "
            f"{TOL_KERNEL}), {cfg['smem']} B a CTA, weights in shared "
            f"memory {cfg['weights_smem']}")
    for family, label, args, resident in cluster_rows_past_cases():
        err = cluster_case_check(family, label, args, resident, config=False,
                                 tds=(8,), depths=(2,))
        log(f"{family}_engine {label}: max_abs_err={err:.3e} (tol "
            f"{TOL_KERNEL}), resident and paged d2 bit for bit")
    log(f"cluster engines: widest plans and n {CLUSTER_ROWS_PAST}, "
        f"{time.time() - t0:.1f} s")
    ms = cluster_timings(main_inputs)
    extra = {}
    for family in CLUSTER_FAMILIES:
        for B in (1, 4):
            args, p_args = main_inputs[(family, B)]
            dims = cluster_dims(family, args)
            for name, d in ((f"{family}_engine", dims),
                            (f"{family}_engine_paged", cluster_paged_dims(
                                family, dims, PAGED_TD, 2,
                                args[0].shape[2]))):
                cfg = check_cluster_config(name, B, d)
                rec = extra.setdefault(name, {})
                rec[f"b{B}_launch"] = {key: cfg[key] for key in (
                    "cluster", "ctas", "threads", "smem",
                    "max_active_clusters", "weights_smem") if key in cfg}
                if B == 1:
                    check(cfg["cluster"] >= 8 and cfg["ctas"] == cfg["cluster"],
                          f"{name}: a B 1 launch is one cluster of >= 8 CTAs")
        for B in (1, 4):
            extra[f"{family}_engine"][f"b{B}_turns_ms"] = \
                ms[(family, B, "resident")]
            extra[f"{family}_engine_paged"][f"b{B}_turns_ms_depth"] = {
                str(d): ms[(family, B, f"paged d{d}")]
                for d in engine.RING_DEPTHS}
    return extra


def rnn_inputs(cell: str, rows: int, din: int, h: int, seed: int):
    """Random CUDA inputs of a GRU / LSTM cell (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    g = 3 if cell == "fused_gru" else 4
    f32 = lambda *shape: torch.from_numpy(
        (rng.normal(size=shape) * 0.3).astype(np.float32)).cuda()
    c = (f32(rows, h),) if cell == "fused_lstm" else ()
    return (f32(rows, din), f32(rows, h), *c, f32(din, g * h), f32(h, g * h),
            f32(g * h))


def rnn_cost(cell: str, inp):
    """(flop, bytes) of one GRU / LSTM cell: both products (2 rows (din +
    H) G H) and ~10 element operations a gate output; every input read once
    and the outputs written once."""
    rows, din = inp[0].shape
    h = inp[1].shape[1]
    g = 3 if cell == "fused_gru" else 4
    outs = 1 if cell == "fused_gru" else 2
    flops = 2 * rows * (din + h) * g * h + 10 * rows * h * g
    return flops, nbytes(*inp) + outs * rows * h * 4


def torch_cell(cell: str, inp):
    """The one PyTorch call that computes the cell (weights transposed,
    no hidden bias: tests/test_torch_fused_rnn.py pins it)."""
    if cell == "fused_gru":
        x, h, wx, wh, b = inp
        zero = torch.zeros_like(b)
        return lambda: torch.gru_cell(x, h, wx.T, wh.T, b, zero)
    x, h, c, wx, wh, b = inp
    zero = torch.zeros_like(b)
    return lambda: torch.lstm_cell(x, (h, c), wx.T, wh.T, b, zero)


def rnn_graph_ms(cell: str, inp):
    """ms a call of the cell kernel and of torch's cell at ``inp``, each
    from a CUDA graph of RNN_CALLS calls (the card's time without host
    dispatch): the median of RNN_SAMPLES replays, the two in turns."""
    def kernel_call():
        p = engine.prepare(cell, *inp, tb=RNN_TB)
        return lambda: engine.launch(p)

    graphs = [graph_of(kernel_call, RNN_CALLS),
              graph_of(lambda: torch_cell(cell, inp), RNN_CALLS)]
    return tuple(t / RNN_CALLS for t in interleaved_ms(
        [g.replay for g in graphs], 1, RNN_SAMPLES))


def check_rnn_cell(cell: str, inp):
    """A GRU / LSTM cell kernel vs its plain version at the benchmark's
    shape (<= 1e-4), timed beside its bound, the plain version and
    torch.gru_cell / torch.lstm_cell: bare launches and torch's calls in
    turns (median of RNN_SAMPLES), then both from CUDA graphs; its grid
    (from the library) fills the card. Then the same check and graph
    timing at RNN_LARGER. Returns its record."""
    wrapper, plain = getattr(engine, cell), getattr(engine, f"{cell}_plain")
    got, want = wrapper(*inp, tb=RNN_TB), plain(*inp)
    lib = torch_cell(cell, inp)
    lib_err = max_err(lib(), want)
    torch.cuda.synchronize()
    err = max_err(got, want)
    rows, din = inp[0].shape
    H = inp[1].shape[1]
    torch_name = f"torch {cell.removeprefix('fused_')}_cell"
    log(f"{cell}: rows={rows} din={din} H={H} tb={RNN_TB} "
        f"max_abs_err={err:.3e} (tol {TOL_KERNEL}); {torch_name} vs plain "
        f"{lib_err:.3e}")
    check(np.isfinite(err) and err <= TOL_KERNEL, cell)
    prepared = engine.prepare(cell, *inp, tb=RNN_TB)
    ms, lib_ms = interleaved_ms([lambda: engine.launch(prepared), lib],
                                RNN_CALLS, RNN_SAMPLES)
    graph_ms, lib_graph_ms = rnn_graph_ms(cell, inp)
    plain_ms = cuda_ms(lambda: plain(*inp), reps=20)
    flops, byts = rnn_cost(cell, inp)
    bound_ms, bound_by = bound(flops, byts)
    ctas = engine.library_ctas(cell, rows, H)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"{cell}: {ms:.4f} ms kernel, {lib_ms:.4f} ms {torch_name} "
        f"(median of {RNN_SAMPLES}, {RNN_CALLS} calls a sample, in turns); "
        f"from a CUDA graph {graph_ms:.4f} ms kernel, {lib_graph_ms:.4f} ms "
        f"{torch_name}; {plain_ms:.4f} ms plain; bound {bound_ms:.5f} ms "
        f"({flops:.3e} flop, {byts:.3e} B); {ctas} CTAs on {sms} SMs")
    check(ctas >= sms, f"{cell}: {ctas} CTAs fill {sms} SMs")
    log(f"{cell}: graph time a launch over its {din + H} serial K rows, "
        f"{graph_ms * 1e6 / (din + H):.1f} ns a K row (launch, first chunk "
        "and epilogue included: an upper bound); the tb-row kernel "
        f"{RNN_TB_ROW_MS[cell] * 1e6 / RNN_TB_ROW_K_ROWS:.1f} ns "
        f"({RNN_TB_ROW_MS[cell]} ms, PERF.md, over {RNN_TB_ROW_K_ROWS} K "
        "rows a CTA)")
    for shape in RNN_LARGER:
        big = rnn_inputs(cell, *shape, SEED + 2)
        big_err = max_err(wrapper(*big, tb=RNN_TB), plain(*big))
        k_ms, t_ms = rnn_graph_ms(cell, big)
        log(f"{cell}: rows={shape[0]} din={shape[1]} H={shape[2]} "
            f"max_abs_err={big_err:.3e} (tol {TOL_KERNEL}); from a CUDA "
            f"graph {k_ms:.4f} ms kernel, {t_ms:.4f} ms {torch_name}")
        check(np.isfinite(big_err) and big_err <= TOL_KERNEL,
              f"{cell} rows={shape[0]} din={shape[1]} H={shape[2]}")
    return record(cell, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                  graph_ms=graph_ms, library_graph_ms=lib_graph_ms)


def smem_check(main_inp, paged_main_inp):
    """engine.smem_bytes (the estimate the wrappers refuse launches by)
    equals each library's own <name>_smem_bytes, at the main path's widths
    (resident, and paged at every depth), at the capacity path's D = 256,
    and for the cells (also at din 13, H 24 and din = H = 1024: the same
    bytes)."""
    dims = {}
    g = main_inp["gcrn"]
    dims["gcrn_engine"] = dict(k=g[0].shape[-1], din=g[3].shape[-1],
                               H=g[6].shape[-1], n=g[0].shape[2])
    dims["gcrn_step"] = dims["gcrn_engine"]
    ev = main_inp["evolve"]
    dims["evolve_engine"] = dict(k=ev[0].shape[-1], L=ev[5].shape[1],
                                 D=ev[5].shape[-1])
    st = main_inp["stacked"]
    dims["stacked_engine"] = dict(k=st[0].shape[-1], din=st[3].shape[-1],
                                  dmid=st[7].shape[-1], H=st[6].shape[-1])
    dims["stacked_step"] = dims["stacked_engine"]
    tg = main_inp["tgn"]
    dims["tgn_engine"] = dict(k=tg[0].shape[-1], din=tg[3].shape[-1],
                              H=tg[6].shape[-1])
    sg = main_inp["static_gcn"]
    dims["static_engine"] = dict(k=sg[0].shape[-1], D=sg[4].shape[-1])
    dims["fused_gru"] = dims["fused_lstm"] = dict(din=RNN_DIN, H=RNN_H)
    cases = list(dims.items())
    for family, name in PAGED.items():
        n = paged_main_inp[family][0].shape[2]
        base = dict(dims[ENGINE[family]])
        if family in ("gcrn", "tgn"):
            base["n"] = n
        cases += [(name, dict(base, td=PAGED_TD, depth=d))
                  for d in engine.RING_DEPTHS]
    cases += [(cell, dict(din=din, H=H))
              for cell in ("fused_gru", "fused_lstm")
              for din, H in ((13, 24), (1024, 1024))]
    k = dims["evolve_engine"]["k"]
    cases += [("evolve_engine", dict(k=k, L=2, D=CAPACITY_HIDDEN)),
              ("evolve_engine_paged", dict(k=k, D=CAPACITY_HIDDEN,
                                           td=PAGED_TD, depth=2))]
    for name, d in cases:
        est, lib = engine.smem_bytes(name, **d), engine.library_smem_bytes(
            name, **d)
        log(f"smem {name} {d}: estimate {est} B, library {lib} B"
            + (" (over the budget)" if est > engine.SMEM_LIMIT else ""))
        check(est == lib, f"smem_bytes({name}, {d}) == library")


def static_wave_probe(inp, widths):
    """What spreading the static GCN's slots over the SMs costs:
    static_engine (at the layers' true ``widths``) on the main path's
    slots, timed on the first 132, on all of them, on those past 132, and
    on the slot with the most real rows alone (ms a launch, the wrapper
    included)."""
    idx, coef, x, mask, w, bg, eagg = inp
    B = idx.shape[0]
    rows = (mask != 0).sum(dim=(1, 2))
    big = int(rows.argmax())

    def pick(sel):
        take = lambda t: None if t is None else t[sel].contiguous()
        return (take(idx), take(coef), take(x), take(mask), w, bg, take(eagg))

    for label, sel in ((f"first {min(B, 132)} slots", slice(0, 132)),
                       (f"all {B} slots", slice(0, B)),
                       (f"the {max(B - 132, 0)} slots past 132",
                        slice(132, B)),
                       (f"the largest slot alone ({int(rows[big])} real "
                        "rows)", slice(big, big + 1))):
        args = pick(sel)
        if args[0].shape[0] == 0:
            continue
        run = functools.partial(engine.static_engine, *args, widths=widths)
        log(f"static wave probe: {label}: "
            f"{cuda_ms(run, reps=20):.4f} ms")


@contextlib.contextmanager
def recording(name: str):
    """Record the CUDA inputs of every call of the kernel wrapper
    ``engine.<name>`` (kernels/ops.py looks it up at each call)."""
    calls, original = [], getattr(engine, name)

    def wrapper(*args, **kwargs):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return original(*args, **kwargs)

    setattr(engine, name, wrapper)
    try:
        yield calls
    finally:
        setattr(engine, name, original)


def sparse_mm_inputs(call):
    """torch.sparse.mm's operands for a no-edge ELL SpMM call: the CSR
    matrix of its live lanes (duplicates summed) and x."""
    idx, coef, _, x, _ = call
    n = idx.shape[0]
    live = coef != 0
    rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
    with warnings.catch_warnings():  # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(
            torch.stack([rows[live], idx[live].long()]), coef[live],
            (n, x.shape[0]), check_invariants=True).coalesce().to_sparse_csr()
    return a, x


# ------------------------------------------------- the per-step kernels ----
# gcrn_step (32-row x 8-unit CTAs, the unit slices of a row tile sharing
# its aggregation on a cluster) and ell_spmm (a warp, or half of one, a
# row) at their edges: node counts that leave a partial row tile (n 37), a
# partial unit slice (H 20), din 12 / 13 (13: the 4-byte variants), k 1 /
# 27 / 33 / 40 (past one 32-entry round), every row dead or a single live
# row, with and without edge messages; the SpMM also at d 12 / 13 / 64 /
# 128 and with x 4 bytes past a 16-byte boundary.
STEP_EDGE_K = (1, 27, 33, 40)
STEP_EDGE_WIDTHS = ((12, 24), (13, 20), (12, 20), (13, 24))
SPMM_EDGE_D = (12, 13, 64, 128)
STEP_EDGE_LIVE = ("mixed", "dead", "one row")
#: the kernels whose ptxas spills must be 0 and whose loads include no
#: generic LD, by source; of those, the ones whose shared loads must show
#: as LDS
STEP_SOURCES = ("gcrn_step", "ell_spmm", "stacked_step", "static_engine")
LDS_SOURCES = ("gcrn_step", "stacked_step", "static_engine")


def step_edge_ell(rng, n, k, live, e):
    """CUDA (idx, coef, eidx) of an n-row ELL with k lanes: some coef-0
    lanes and padding rows ("mixed"), no live lane ("dead") or one row with
    live lanes ("one row")."""
    n_real = n - 5
    idx = rng.integers(0, n_real, (n, k)).astype(np.int32)
    coef = (rng.uniform(0.1, 1.0, (n, k))
            * (rng.uniform(size=(n, k)) < 0.6)).astype(np.float32)
    coef[n_real:] = 0.0
    if live == "dead":
        coef[:] = 0.0
    elif live == "one row":
        coef[np.arange(n) != n // 2] = 0.0
        coef[n // 2, -1] = 0.5  # its last lane live: past 32 at k 33 / 40
    eidx = rng.integers(0, e, (n, k)).astype(np.int32)
    cu = lambda a: torch.from_numpy(a).cuda()
    return cu(idx), cu(coef), cu(eidx)


def step_case_check(label, fn, args) -> float:
    """The kernel through ``fn`` (an ops function) against its force-ref
    call (<= 1e-4), and two calls bit for bit equal."""
    got, again = fn(*args), fn(*args)
    err = max_err(got, fn(*args, force_ref=True))
    same = bitwise(got, again)
    check(np.isfinite(err) and err <= TOL_KERNEL and same,
          f"{label}: max_abs_err={err:.3e} (tol {TOL_KERNEL}), two calls "
          f"bitwise {same}")
    return err


def step_plan_check(name, dims) -> dict:
    """The launch the library builds equals engine.step_plan."""
    mine, lib = engine.step_plan(name, **dims), engine.library_step_plan(
        name, **dims)
    check(mine == lib, f"{name} plan at {dims}: {mine} != library {lib}")
    return lib


def step_kernel_edges():
    """gcrn_step, stacked_step (dmid = din + 7; a dead tile also with h 0,
    the padding rows' shortcut) and ell_spmm at their edges (STEP_EDGE_*),
    each against its plain version and bit for bit across two calls, their
    launches equal to engine.step_plan."""
    rng = np.random.default_rng(SEED + 7)
    f32 = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.3).astype(np.float32)).cuda()
    n, e = 37, 50
    worst = {"gcrn_step": 0.0, "stacked_step": 0.0, "ell_spmm": 0.0}
    cases = 0
    for k in STEP_EDGE_K:
        for live in STEP_EDGE_LIVE:
            ell = step_edge_ell(rng, n, k, live, e)
            for din, H in STEP_EDGE_WIDTHS:
                args = (*ell, f32(n, din), f32(n, H), f32(n, H),
                        f32(din, 4 * H), f32(H, 4 * H), f32(4 * H))
                for em in (None, f32(e, din)):
                    full = args if em is None else (*args, em)
                    worst["gcrn_step"] = max(worst["gcrn_step"], step_case_check(
                        f"gcrn_step n={n} k={k} din={din} H={H} {live} "
                        f"edges={em is not None}", ops.dgnn_fused_step, full))
                    cases += 1
                step_plan_check("gcrn_step", dict(n=n, k=k, din=din, H=H))
                dmid = din + 7
                for h in [f32(n, H)] + ([torch.zeros(n, H, device="cuda")]
                                        if live == "dead" else []):
                    args = (*ell, f32(n, din), h, f32(din, dmid), f32(dmid),
                            f32(dmid, 3 * H), f32(H, 3 * H), f32(3 * H))
                    for em in (None, f32(e, din)):
                        full = args if em is None else (*args, em)
                        worst["stacked_step"] = max(
                            worst["stacked_step"], step_case_check(
                                f"stacked_step n={n} k={k} din={din} "
                                f"dmid={dmid} H={H} {live}"
                                f"{'' if h.any() else ' h 0'} "
                                f"edges={em is not None}",
                                ops.stacked_fused_step, full))
                        cases += 1
                step_plan_check("stacked_step", dict(n=n, k=k, din=din,
                                                     dmid=dmid, H=H))
            for d in SPMM_EDGE_D:
                x = f32(n, d)
                views = [("", x)]
                if d % 4 == 0 and live == "mixed":
                    x_off = torch.empty(n * d + 1, device="cuda")[1:]
                    x_off.copy_(x.flatten())
                    views.append((" x offset 4 B", x_off.view(n, d)))
                for tag, xv in views:
                    for em in (None, f32(e, d)):
                        full = (*ell, xv) if em is None else (*ell, xv, em)
                        worst["ell_spmm"] = max(worst["ell_spmm"], step_case_check(
                            f"ell_spmm n={n} k={k} d={d}{tag} {live} "
                            f"edges={em is not None}", ops.ell_spmm, full))
                        cases += 1
                    step_plan_check("ell_spmm", dict(
                        L=1, n=n, d=d, aligned=int(xv.data_ptr() % 16 == 0)))
    log(f"per-step kernel edges: {cases} cases (n {n}, k "
        f"{'/'.join(map(str, STEP_EDGE_K))}, din/H (stacked dmid din + 7) "
        f"{', '.join(f'{a}/{b}' for a, b in STEP_EDGE_WIDTHS)}, d "
        f"{'/'.join(map(str, SPMM_EDGE_D))}, {', '.join(STEP_EDGE_LIVE)}, "
        "with and without edges, x offset 4 B) within "
        f"{TOL_KERNEL} and bit for bit across two calls (largest "
        + ", ".join(f"{v:.3e} {k}" for k, v in worst.items()) + ")")


#: stacked_step past its edges (n, k, din, dmid, H): the widest shapes the
#: one-CTA kernel took at k 1, one whose Wg slice no longer fits shared
#: memory (read from L2) and the widest H at din 16 and dmid 8 (4-byte
#: copies), and n past 65,536 rows at the main path's widths
STACKED_WIDE = ((37, 1, 600, 600, 400), (37, 1, 16, 8, 1587),
                (CLUSTER_ROWS_PAST, 27, 128, 128, 128))


def stacked_step_wide():
    """stacked_step at STACKED_WIDE (a third of the rows live, some lanes
    dead, edge messages) against its plain version, two calls bit for bit,
    its launch equal to engine.step_plan."""
    rng = np.random.default_rng(SEED + 11)
    f32 = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.3).astype(np.float32)).cuda()
    for n, k, din, dmid, H in STACKED_WIDE:
        e = 64
        ell = step_edge_ell(rng, n, k, "mixed", e)
        ell[1][n // 3:] = 0.0  # the rows past a third: padding, h 0
        h = f32(n, H)
        h[n // 3:] = 0.0
        args = (*ell, f32(n, din), h, f32(din, dmid), f32(dmid),
                f32(dmid, 3 * H), f32(H, 3 * H), f32(3 * H), f32(e, din))
        plan = step_plan_check("stacked_step", dict(n=n, k=k, din=din,
                                                    dmid=dmid, H=H))
        err = step_case_check(f"stacked_step n={n} k={k} din={din} "
                              f"dmid={dmid} H={H} edges=True",
                              ops.stacked_fused_step, args)
        log(f"stacked_step wide n={n} k={k} din={din} dmid={dmid} H={H}: "
            f"max_abs_err={err:.3e}, launch {plan}")
        del args, ell, h
        torch.cuda.empty_cache()


#: the static engine's cases (B, n, k, D, widths or None (D throughout),
#: edge term): the widths of ops' packs (D 16 at 13 / 11 / 7: the V 1
#: gathers), the main path's (64 / 128 / 64), D 13 (4-byte rows), three
#: layers, a square D 96, the widest W slice in shared memory (D 256), the
#: widest two-tile pass (384, W read from L2), the widest D the one-CTA
#: kernel took (806, one tile a pass), and n past 65,536 rows (two chunks
#: of live-tile bits); slot 0 partly live, slot 1 dead, the rest full
STATIC_CASES = ((3, 37, 5, 16, (13, 11, 7), True),
                (3, 200, 27, 128, (64, 128, 64), True),
                (2, 70, 33, 13, (13, 9, 5), False),
                (3, 100, 1, 64, (32, 64, 40, 24), True),
                (2, 37, 40, 96, None, False),
                (3, 130, 5, 256, (256, 256), True),
                (3, 130, 5, 384, (384, 384), True),
                (3, 100, 1, 806, None, False),
                (2, CLUSTER_ROWS_PAST, 27, 64, (64, 64, 32), True))


def static_case(rng, B, n, k, D, widths, edges):
    """CUDA packed inputs of static_engine: rows past n // 2 of slot 0 and
    all of slot 1 padding (mask 0, no lanes), x / W / b / eagg zero past
    each layer's widths."""
    L = len(widths) - 1
    rows = np.ones((B, n), bool)
    rows[0, n // 2:] = False
    rows[1] = False
    idx = rng.integers(0, max(n // 2, 1), (B, 1, n, k)).astype(np.int32)
    coef = (rng.uniform(0.1, 1.0, (B, 1, n, k))
            * (rng.uniform(size=(B, 1, n, k)) < 0.6)
            * rows[:, None, :, None]).astype(np.float32)
    mask = rows[:, None].astype(np.float32)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    x = np.zeros((B, 1, n, D), np.float32)
    x[..., :widths[0]] = f32(B, 1, n, widths[0])
    w = np.zeros((L, D, D), np.float32)
    bg = np.zeros((L, D), np.float32)
    for l in range(L):
        w[l, :widths[l], :widths[l + 1]] = f32(widths[l], widths[l + 1])
        bg[l, :widths[l + 1]] = f32(widths[l + 1])
    eagg = None
    if edges:
        eagg = np.zeros((B, 1, L, n, D), np.float32)
        for l in range(L):
            eagg[:, :, l, :, :widths[l]] = f32(B, 1, n, widths[l])
    cu = lambda a: None if a is None else torch.from_numpy(a).cuda()
    return tuple(map(cu, (idx, coef, x, mask, w, bg, eagg)))


def static_engine_edges():
    """static_engine at STATIC_CASES against its plain version (<= 1e-4;
    the columns past the last width exactly zero), two calls bit for bit,
    its launch equal to engine.static_plan."""
    rng = np.random.default_rng(SEED + 13)
    worst = 0.0
    for B, n, k, D, widths, edges in STATIC_CASES:
        wd = list(widths) if widths is not None else [D, D, D]
        inp = static_case(rng, B, n, k, D, wd, edges)
        got = engine.static_engine(*inp, widths=widths)
        again = engine.static_engine(*inp, widths=widths)
        err = max_err(got, engine.static_plain(*inp))
        pad_zero = not got[..., wd[-1]:].any()
        same = bitwise(got, again)
        mine = engine.static_plan(B, k, D, wd)
        lib = engine.library_static_plan(B, k, D)
        label = (f"static_engine B={B} n={n} k={k} D={D} widths={widths} "
                 f"edges={edges}")
        log(f"{label}: max_abs_err={err:.3e} (tol {TOL_KERNEL}), columns "
            f"past the widths zero {pad_zero}, two calls bitwise {same}, "
            f"launch {lib}")
        check(np.isfinite(err) and err <= TOL_KERNEL and pad_zero and same
              and lib == {key: mine[key] for key in lib}, label)
        worst = max(worst, err)
        del inp, got, again
        torch.cuda.empty_cache()
    log(f"static_engine: {len(STATIC_CASES)} cases within {TOL_KERNEL} "
        f"(largest {worst:.3e})")


def sass_loads(source: str) -> dict:
    """{kernel function: {mnemonic: count}} of the load instructions
    (LDS shared, LDG global, LD generic, LDGSTS cp.async) in the built
    library of ``source``, from ``cuobjdump -sass``."""
    tool = Path(engine._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(engine._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    out, func = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
            out[func] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(LD\w*)", line)
        if m and func is not None:
            op = m.group(1)
            out[func][op] = out[func].get(op, 0) + 1
    return out


def step_build_checks():
    """0 spill bytes in ptxas's report for the per-step kernels and the
    static engine, and their shared-memory loads compiled to LDS: no
    generic LD in any of their kernels (cuobjdump -sass)."""
    for source in STEP_SOURCES:
        spills = spill_bytes(source)
        log(f"{source}: ptxas spill bytes {spills}")
        check(spills and not any(spills.values()),
              f"{source}: 0 spill bytes ({spills})")
        loads = sass_loads(source)
        for func, ops_ in loads.items():
            log(f"{source}: sass loads of {func}: {ops_}")
        check(loads and not any("LD" in ops_ for ops_ in loads.values()),
              f"{source}: a generic LD in {loads}")
        if source in LDS_SOURCES:
            check(all(ops_.get("LDS", 0) > 0 for ops_ in loads.values()),
                  f"{source}: its shared loads are LDS ({loads})")


def recorded_step_calls(params, n_global, stream, np_stream):
    """The CUDA inputs of every per-step kernel call of one solo run of the
    whole stream: (gcrn_step's, from GCRN-M2 v2 through the session;
    stacked_step's, from the stacked family's v2; ell_spmm's, from
    GCRN-M2 baseline with impl "pallas": two a step, x with edge messages
    and h without)."""
    T = stream.node_mask.shape[0]
    with recording("gcrn_step") as g_calls:
        drive(GCRN_M2, "v2", "session", params[GCRN_M2.name], n_global,
              stream, np_stream)
    with recording("stacked_step") as s_calls:
        drive(STACKED, "v2", "session", params[STACKED.name], n_global,
              stream, np_stream)
    with recording("ell_spmm") as e_calls:
        drive(GCRN_M2, "baseline", "pallas", params[GCRN_M2.name], n_global,
              stream, np_stream)
    e_calls = e_calls[:2 * T]
    check(len(e_calls) == 2 * T
          and sum(c[4] is None for c in e_calls) == T,
          f"ell_spmm recorded {len(e_calls)} calls")
    return g_calls[:T], s_calls[:T], e_calls


def stacked_one_layer_check(n_global, stream, np_stream):
    """stacked_step on the inputs a one-GCN-layer stacked model's V2 session
    run hands it (din 64, the projected edge messages: the kernel's edge
    variant), every step's call against its plain version (<= 1e-4)."""
    cfg = dataclasses.replace(STACKED, n_gnn_layers=1)
    model = build_model(cfg, n_global=n_global)
    params = ops.to_device(model.init(torch.Generator().manual_seed(SEED + 5)),
                           "cuda")
    with recording("stacked_step") as calls:
        drive(cfg, "v2", "session", params, n_global, stream, np_stream)
    calls = calls[:stream.node_mask.shape[0]]
    err = max(max_err(engine.stacked_step(*c), engine.stacked_step_plain(*c))
              for c in calls)
    edges = sum(c[10] is not None for c in calls)
    log(f"stacked_step, one GCN layer: {len(calls)} main-path calls (din "
        f"{calls[0][3].shape[-1]}, {edges} with edge messages) "
        f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
    check(edges == len(calls) and np.isfinite(err) and err <= TOL_KERNEL,
          "stacked_step on the one-GCN-layer path")


def ell_groups(calls) -> dict:
    """ELL SpMM calls by width and edge messages ({label: calls}), the
    no-edge calls of the widest group first (PERF.md's row 9)."""
    groups = {}
    for c in calls:
        groups.setdefault((c[4] is not None, -c[3].shape[-1]), []).append(c)
    return {f"d {-d}{' edges' if edges else ''}": groups[(edges, d)]
            for edges, d in sorted(groups)}


def kernel_duration_ms(fn, match: str) -> float:
    """ms a launch of the kernels whose profiler name holds ``match``
    during one call of ``fn``: their summed device duration over their
    count (torch.profiler; nan where it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and match in e.key]
    count = sum(e.count for e in evs)
    return (sum(e.self_device_time_total for e in evs) / 1e3 / count
            if count else float("nan"))


def launches_of(prepared):
    """One pass of prepared per-step launches."""
    return lambda: [engine.launch(p) for p in prepared]


#: kernel-duration measurements waiting for ``kernel_durations``: (label,
#: a pass of launches, launches a pass, profiler name to match, the dict
#: whose "kernel" it fills)
PENDING_DURATIONS = []


def step_turns(prepare, match: str, label: str) -> dict:
    """ms a call of one pass of launches (``prepare`` makes it, a list of
    engine.Prepared on the current stream), two ways in turns, medians of
    STEP_SAMPLES: ``events`` (bare launches, CUDA events around the pass)
    and ``graph`` (one replay of a CUDA graph of the pass). The third,
    ``kernel`` (the profiler's duration a launch of the kernels named like
    ``match``), is nan here and filled in by ``kernel_durations``: a process
    the profiler has traced dispatches from the host more slowly, so its
    windows wait until every host-dispatched timing is done."""
    prepared = prepare()
    calls = len(prepared)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the graph's launches bind its stream
        captured = prepare()
    graph = graph_of(lambda: launches_of(captured), 1, side)
    events, graph_ms = interleaved_ms([launches_of(prepared), graph.replay],
                                      1, STEP_SAMPLES)
    t = {"events": events / calls, "graph": graph_ms / calls,
         "kernel": float("nan")}
    # the graph holds raw pointers into `captured`'s tensors: both go
    # together
    del graph, captured
    PENDING_DURATIONS.append((label, launches_of(prepared), calls, match,
                              t))
    return t


def kernel_durations() -> None:
    """The profiler's kernel duration a launch (medians of STEP_SAMPLES
    windows, each one pass) of every pass ``step_turns`` timed, into the
    dict it returned; a profiler window now and then reports no kernel
    (nan): the median of the windows that did."""
    for label, fn, calls, match, t in PENDING_DURATIONS:
        k = [kernel_duration_ms(fn, match) for _ in range(STEP_SAMPLES)]
        t["kernel"] = ms = (float(np.nanmedian(k)) if np.isfinite(k).any()
                            else float("nan"))
        log(f"{label}: {ms:.4f} ms kernel duration a launch (profiler, "
            f"median of {STEP_SAMPLES} windows, {calls} launches a window)")
    PENDING_DURATIONS.clear()


def edge_terms_narrow(seed):
    """The edge-term kernel's arguments at narrow odd shapes: B 2, T 3,
    n 37 (a partial 32-row block), k 1 and 27, De 3, layer widths 13 and
    24 (a float4 across din 13), one empty snapshot, coef 0 on a tenth of
    the lanes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.rand(s, generator=g, device="cuda")
    for k in (1, 27):
        n_nodes = (rand(2, 3) * 38).to(torch.int32)
        n_nodes[0, 1] = 0
        live = (torch.arange(37, device="cuda")[:, None]
                < n_nodes[..., None, None].long()).expand(2, 3, 37, k)
        eidx = torch.where(live, (rand(2, 3, 37, k) * 50).long(), 0)
        coef = torch.where(live & (rand(2, 3, 37, k) > 0.1),
                           rand(2, 3, 37, k) * 2 - 1, 0.0)
        yield (eidx.to(torch.int32), coef, rand(2, 3, 50, 3) * 4 - 2,
               n_nodes, [rand(3, 13) * 2 - 1, rand(3, 24) * 2 - 1], 24)


def check_edge_terms(params, batches) -> dict:
    """The edge-term kernel against its plain version (the torch path's
    terms in the square layout) bit for bit: at narrow odd shapes, then on
    the main path's snapshots (``batches``: the T = 8 B = 2 check batch and
    the whole stream); timed on the whole stream beside its bound (the
    output's bytes, zeros included, and 8 bytes a live row's lane) and the
    plain version; its record."""
    name = "edge_terms"
    for i, args in enumerate(edge_terms_narrow(SEED)):
        check(torch.equal(engine.edge_terms(*args),
                          engine.edge_terms_plain(*args)),
              f"{name} narrow case {i} bit for bit")
    w_edge = [p["w_edge"] for p in params["gcn"]]
    D = ops.square_width(layer_dims(EVOLVEGCN))
    for snaps in batches:
        args = (snaps.neigh_eidx, snaps.neigh_coef, snaps.edge_feat,
                snaps.n_nodes, w_edge, D)
        check(torch.equal(engine.edge_terms(*args),
                          engine.edge_terms_plain(*args)),
              f"{name} main-path snapshots {tuple(snaps.n_nodes.shape)} "
              "bit for bit")
    ms = cuda_ms(lambda: engine.edge_terms(*args), reps=20)
    plain_ms = cuda_ms(lambda: engine.edge_terms_plain(*args), reps=3)
    n, k = snaps.neigh_eidx.shape[-2:]
    rows = float(snaps.n_nodes.clamp(0, n).sum())
    S = int(np.prod(snaps.neigh_eidx.shape[:-2]))
    flops = rows * (2 * k * w_edge[0].shape[0]
                    + sum(2 * w.numel() for w in w_edge))
    byts = 4 * S * len(w_edge) * n * D + 8 * rows * k
    bound_ms, bound_by = bound(flops, byts)
    log(f"{name}: main-path snapshots bit for bit; {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms ({flops:.3e} "
        f"flop, {byts:.3e} B, {bound_by})")
    return record(name, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by)


def check_step_kernel(name, plain, calls, groups, cost, library=None):
    """A per-step kernel vs its plain version on every recorded main-path
    call (<= 1e-4), then timed per call on each of ``groups`` ({label:
    calls}; the ELL SpMM's by width and edge messages) by ``step_turns``
    beside the group's bound; the first group also beside the plain
    version and ``library`` (zero-argument calls, one a timed call) where
    one PyTorch call computes the same function, in turns with the
    kernel's bare launches. The record's times are the first group's; each
    group's kernel duration arrives in its ``groups`` entry with
    ``kernel_durations``."""
    wrapper = getattr(engine, name)
    err = 0.0
    for c in calls:
        err = max(err, max_err(wrapper(*c), plain(*c)))
    torch.cuda.synchronize()
    log(f"{name}: {len(calls)} main-path calls max_abs_err={err:.3e} "
        f"(tol {TOL_KERNEL})")
    check(np.isfinite(err) and err <= TOL_KERNEL, name)
    times = {}
    for label, timed in groups.items():
        t = step_turns(lambda timed=timed: [engine.prepare(name, *c)
                                            for c in timed],
                       name, f"{name} {label}")
        costs = [cost(c) for c in timed]
        flops, byts = sum(f for f, _ in costs), sum(b for _, b in costs)
        bound_ms, bound_by = bound(flops, byts)
        n_t = len(timed)
        t.update(bound_ms=bound_ms / n_t, bound_by=bound_by, calls=n_t)
        times[label] = t
        log(f"{name} {label}: per call {t['events']:.4f} ms bare launches, "
            f"{t['graph']:.4f} ms from a CUDA graph (medians of "
            f"{STEP_SAMPLES} in turns, {n_t} calls a pass); bound "
            f"{bound_ms / n_t:.5f} ms ({flops / n_t:.3e} flop, "
            f"{byts / n_t:.3e} B, {bound_by})")
    first = next(iter(groups))
    timed, t = groups[first], times[first]
    plain_ms = cuda_ms(lambda: [plain(*c) for c in timed], reps=2) / len(
        timed)
    lib_ms = None
    if library is not None:
        prepared = [engine.prepare(name, *c) for c in timed]
        ms, lib_ms = (m / len(timed) for m in interleaved_ms(
            [launches_of(prepared), lambda: [f() for f in library]], 1,
            STEP_SAMPLES))
        log(f"{name} {first}: in turns, {ms:.4f} ms bare launches, "
            f"{lib_ms:.4f} ms torch.sparse.mm (medians of {STEP_SAMPLES})")
    log(f"{name} {first}: plain {plain_ms:.4f} ms a call")
    return record(name, max_abs_err=err, ms=t["events"], graph_ms=t["graph"],
                  plain_ms=plain_ms, bound_ms=t["bound_ms"],
                  bound_by=t["bound_by"], library_ms=lib_ms,
                  timed_calls=t["calls"], groups=times)


def paged_small_check(family, args, lengths, resident, want, label):
    """The family's paged engine through ops at narrow widths: bit for bit
    against the resident run and within 1e-4 of the force-ref run, at
    windows that divide the state (td 8) or leave a narrower last one
    (td 16 of 24), at every ring depth."""
    for td, depth in ((8, 1), (8, 2), (8, 4), (16, 2)):
        got = ops.stream_steps_batched(
            family, *args, lengths=lengths, td=td, device="cuda",
            state_residency="hbm_paged", buffer_depth=depth)
        same, err = bitwise(got, resident), max_err(got, want)
        log(f"{PAGED[family]}: n=37 {label} td={td} depth={depth} bitwise "
            f"vs resident {same}, max_abs_err={err:.3e} (tol {TOL_KERNEL})")
        check(same and np.isfinite(err) and err <= TOL_KERNEL,
              f"{PAGED[family]} {label} td={td} depth={depth}")


def small_shapes_check():
    """Every kernel through ops at narrow widths and a node count that
    leaves a partial 32-row tile and a partial 8-row micro-tile (n = 37,
    H = 24, D = 16), random data from the seed, with and without edge
    messages, the stream engines ragged; each against its force-ref run
    (<= 1e-4)."""
    rng = np.random.default_rng(SEED)
    B, T, n, k, din, h, G, e = 3, 3, 37, 5, 12, 24, 90, 120
    nr = rng.integers(10, n + 1, (B, T))
    rows = np.arange(n) < nr[..., None]
    idx = (rng.random((B, T, n, k)) * nr[..., None, None]).astype(np.int32)
    coef = (rng.random((B, T, n, k)) * (rng.random((B, T, n, k)) > 0.4)
            * rows[..., None]).astype(np.float32)
    eidx = rng.integers(0, e, (B, T, n, k)).astype(np.int32)
    ren = np.where(rows, np.stack([[rng.permutation(G)[:n] for _ in range(T)]
                                   for _ in range(B)]), -1).astype(np.int32)
    mask = rows.astype(np.float32)
    f32 = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    x = f32(B, T, n, din) * mask[..., None]
    em = f32(B, T, e, din)
    lengths = [3, 1, 2]
    dims = [(din, 16), (16, 8)]
    cases = {
        "gcrn": (idx, coef, eidx, x, ren, mask, f32(B, G, h), f32(B, G, h),
                 f32(din, 4 * h), f32(h, 4 * h), f32(4 * h)),
        "stacked": (idx, coef, eidx, x, ren, mask, f32(B, G, h),
                    f32(din, 16), f32(16), f32(16, 3 * h), f32(h, 3 * h),
                    f32(3 * h)),
        "evolve": (idx, coef, x, mask, np.ones((B, T), np.int32),
                   [f32(B, *d) for d in dims], [f32(d[1]) for d in dims],
                   [f32(d[0], 3 * d[0]) for d in dims],
                   [f32(d[0], 3 * d[0]) for d in dims],
                   [f32(3 * d[0]) for d in dims]),
    }
    # the evolve edge terms in the square layout (B, T, L, n, D) the pack
    # reads: layer l's in its first din_l columns, zeros past them
    eagg = np.zeros((B, T, len(dims), n, ops.square_width(dims)), np.float32)
    for l, d in enumerate(dims):
        eagg[:, :, l, :, :d[0]] = f32(B, T, n, d[0])
    edge_args = {"gcrn": em, "stacked": em, "evolve": eagg}
    for family, args in cases.items():
        for edges in (False, True):
            full = args + (edge_args[family],) if edges else args
            got, want = (ops.stream_steps_batched(
                family, *full, lengths=lengths, device="cuda", force_ref=fr)
                for fr in (False, True))
            err = max_err(got, want)
            log(f"{family}_engine: n=37 H/D=24/16 ragged edges={edges} "
                f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
            check(np.isfinite(err) and err <= TOL_KERNEL, family)
            paged_small_check(family, full, lengths, got, want,
                              f"edges={edges}")
    # TGN and the static GCN: odd feature widths, a length-0 ragged row
    # (a dead slot for the static GCN), event times up to BC-Alpha's
    din_o, dims_o = 13, [(13, 11), (11, 7)]
    x_o = f32(B, T, n, din_o) * mask[..., None]
    ts = (rng.uniform(0.0, 137.0, (B, T, n, k)) * (coef != 0)).astype(
        np.float32)
    freq = (1.0 / 10.0 ** np.linspace(0.0, 4.0, h)).astype(np.float32)
    static = (idx[:, :1], coef[:, :1], x_o[:, :1], mask[:, :1],
              [f32(*d) for d in dims_o], [f32(d[1]) for d in dims_o])
    for family, full, lens, label in (
            ("tgn", (idx, coef, ts, x_o, ren, mask, f32(B, G, h), freq,
                     f32(din_o, h), f32(h, 3 * h), f32(h, 3 * h),
                     f32(3 * h)), [3, 0, 2], "no edge variant"),
            ("static_gcn", static, [1, 0, 1], "edge term=False"),
            ("static_gcn", static + ([f32(B, 1, n, d[0]) for d in dims_o],),
             [1, 0, 1], "edge term=True")):
        got, want = (ops.stream_steps_batched(
            family, *full, lengths=lens, device="cuda", force_ref=fr)
            for fr in (False, True))
        err = max_err(got, want)
        log(f"{ENGINE[family]}: n=37 k=5 din=13 H/D=24/13,11,7 ragged "
            f"{lens} {label} max_abs_err={err:.3e} (tol {TOL_KERNEL})")
        check(np.isfinite(err) and err <= TOL_KERNEL, family)
        if family in PAGED:
            paged_small_check(family, full, lens, got, want, label)
    # the GRU / LSTM cells at their edges (RNN_NARROW), then with x 4 bytes
    # past a 16-byte boundary (din 16: the 4-byte staging)
    for cell in ("fused_gru", "fused_lstm"):
        for rows, din_c, h_c, tb in RNN_NARROW:
            inp = rnn_inputs(cell, rows, din_c, h_c, SEED)
            cases = [("", inp)]
            if (rows, din_c, h_c) == (40, 16, 20):
                x_off = torch.empty(rows * din_c + 1, device="cuda")[1:]
                x_off.copy_(inp[0].flatten())
                cases.append((" x offset 4 B", (x_off.view(rows, din_c),
                                                *inp[1:])))
            for label, args in cases:
                got = getattr(ops, cell)(*args, tb=tb)
                err = max_err(got, getattr(ops, cell)(*args, force_ref=True))
                log(f"{cell}: rows={rows} din={din_c} H={h_c} tb={tb}{label} "
                    f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
                check(np.isfinite(err) and err <= TOL_KERNEL,
                      f"{cell} rows={rows} din={din_c} H={h_c}{label}")
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    g = [cu(a[0, 0]) for a in (idx, coef, eidx)]
    xs, hs, cs = cu(x[0, 0]), cu(f32(n, h)), cu(f32(n, h))
    # (label, op, arguments, the edge messages of its edge variant)
    steps = (
        ("ell_spmm d=12", ops.ell_spmm, (*g, xs), cu(em[0, 0])),
        ("ell_spmm d=24", ops.ell_spmm, (*g, hs), cu(f32(e, h))),
        ("ell_spmm (2, 3) graphs d=12", ops.ell_spmm,
         tuple(cu(a[:2]) for a in (idx, coef, eidx, x)), cu(em[:2])),
        ("gcrn_step", ops.dgnn_fused_step,
         (*g, xs, hs, cs, cu(f32(din, 4 * h)), cu(f32(h, 4 * h)),
          cu(f32(4 * h))), cu(em[0, 0])),
        ("stacked_step", ops.stacked_fused_step,
         (*g, xs, hs, cu(f32(din, 16)), cu(f32(16)), cu(f32(16, 3 * h)),
          cu(f32(h, 3 * h)), cu(f32(3 * h))), cu(em[0, 0])),
    )
    for label, fn, args, edge_msg in steps:
        for full in (args, (*args, edge_msg)):
            got, want = fn(*full), fn(*full, force_ref=True)
            err = max_err(got, want)
            log(f"{label}: n=37 edges={len(full) > len(args)} "
                f"max_abs_err={err:.3e} (tol {TOL_KERNEL})")
            check(np.isfinite(err) and err <= TOL_KERNEL, label)


# ---------------------------------------------------------- main path ----

def per_step_levels(cfg):
    return [lv for lv in api.FAMILY_LEVELS[api.family_for(cfg)] if lv != "v3"]


def main_paths():
    """(cfg, level, impl) of every main path: every level through the
    session, then the per-step levels with the ELL SpMM (impl "pallas";
    TGN has no GCN, so none of its levels reaches it)."""
    for cfg in CONFIGS:
        for level in api.FAMILY_LEVELS[api.family_for(cfg)]:
            yield cfg, level, "session"
    for cfg in CONFIGS:
        if cfg is TGN:
            continue
        for level in per_step_levels(cfg):
            yield cfg, level, "pallas"



def expected_kernels(cfg, level, impl) -> set:
    """The kernels a main path must launch (TGN and the static GCN launch
    none at baseline through the session: plain PyTorch steps)."""
    family = api.family_for(cfg)
    if level == "v3":
        # EvolveGCN-O's edge terms: one edge-term launch a call
        return {ENGINE[family]} | ({"edge_terms"} if family == "evolve"
                                   and cfg.edge_dim else set())
    names = set()
    if level == "v2":
        names.add(f"{family}_step")
    # at v2 the fused step does the message passing of the last GCN
    # layer; only the stacked family's earlier layers use the ELL SpMM
    if impl == "pallas" and not (level == "v2" and (
            family == "gcrn" or cfg.n_gnn_layers == 1)):
        names.add("ell_spmm")
    return names


def windows_for(cfg, level):
    """run_batched windows of a path's stream."""
    if cfg is TGN:
        return EVENT_V3_WINDOWS if level == "v3" else EVENT_STEP_WINDOWS
    return V3_WINDOWS if level == "v3" else STEP_WINDOWS


def out_width(cfg) -> int:
    """Width of a path's outputs: TGN's are its memory and the stacked
    family's its GRU state (cfg.hidden); the others end in a head or a last
    GCN layer of cfg.out_dim."""
    return (cfg.hidden if api.family_for(cfg) in ("stacked", "tgn")
            else cfg.out_dim)


def drive(cfg, level, impl, params, n_global, stream, np_stream, *,
          force_ref=False, reps=0, plan_kw=None):
    """One main path: a run of the whole stream, then a batched run over
    windows (``plan_kw``: more fields of the session's plan). Returns
    ((outs, state, outs_b, states_b), run ms/snapshot of the first run and
    of ``reps`` more runs of the same stream)."""
    T = stream.node_mask.shape[0]
    wins = windows_for(cfg, level)
    ms = []

    def timed(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / T)
        return out

    if impl == "session":
        sess = api.BoosterSession(cfg, api.plan(cfg, level=level,
                                                **(plan_kw or {})),
                                  n_global=n_global, params=params,
                                  device="cuda", force_ref=force_ref)
        outs = timed(lambda: sess.run(stream))
        state = sess.state
        states_b, outs_b = sess.run_batched([window(np_stream, a, b)
                                             for a, b in wins])
        for _ in range(reps):
            timed(lambda: sess.run(stream))
    else:
        model = build_model(cfg, impl="pallas", n_global=n_global)
        p = api.plan(cfg, level=level)
        state0 = model.init_state(params, mode=level)
        run = lambda: run_plan(model, params, state0, stream, p,
                               force_ref=force_ref)
        state, outs = timed(run)
        B = len(wins)
        states_b, outs_BT = run_plan_batched(
            model, params, init_states_batched(model, params, B, mode=level),
            batch_of(np_stream, wins), api.plan(cfg, level=level, batch=B),
            force_ref=force_ref)
        outs_b = list(outs_BT)
        for _ in range(reps):
            timed(run)
    torch.cuda.synchronize()
    return (outs, state, outs_b, states_b), ms


def check_path(label, cfg, level, res, ref, T):
    outs, state, outs_b, states_b = res
    wins = windows_for(cfg, level)
    width = out_width(cfg)
    check(outs.shape == (T, N_PAD, width),
          f"{label} output shape {tuple(outs.shape)}")
    check(all(o.shape[0] == b - a for o, (a, b) in zip(outs_b, wins)),
          f"{label} batched output lengths")
    check(all(bool(torch.isfinite(o).all()) for o in (outs, *outs_b)),
          f"{label} outputs finite")
    check(float(outs.abs().max()) > 0, f"{label} outputs nonzero")
    errs = {"run outs": max_err(outs, ref[0]),
            "run state": max_err(state, ref[1]),
            "batched outs": max_err(list(outs_b), list(ref[2])),
            "batched states": max_err(states_b, ref[3])}
    log(f"{label} vs force_ref: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_STREAM})")
    check(all(np.isfinite(v) and v <= TOL_STREAM for v in errs.values()),
          f"{label} vs force_ref {errs}")


def paged_plan(depth: int) -> dict:
    """The plan fields of a paged main path."""
    return dict(td=PAGED_TD, state_residency="hbm_paged", buffer_depth=depth)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms on (index_add_ without atomics: the
    stacked model's earlier GCN layer scatter-adds), so two runs of a
    session path give the same bits; the kernels are deterministic
    either way."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def check_bitwise(label, res, resident) -> None:
    """A paged path's results equal the resident path's bit for bit."""
    same = {"run outs": bitwise(res[0], resident[0]),
            "run state": bitwise(res[1], resident[1]),
            "batched outs": bitwise(list(res[2]), list(resident[2])),
            "batched states": bitwise(res[3], resident[3])}
    log(f"{label} bitwise vs resident: "
        + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"{label} bit-identical to resident {same}")


def arrays_inputs(cfg, params, n_global, stream, np_stream):
    """run_arrays' argument lists for a path: the whole stream (solo) and
    its v3 windows stacked ragged (batched), and the windows' lengths."""
    model = build_model(cfg, n_global=n_global)
    solo = model.stream_args(params, model.init_state(params, mode="v3"),
                             stream)
    wins = windows_for(cfg, "v3")
    snaps, lens = stack_ragged([window(np_stream, a, b) for a, b in wins],
                               "cuda")
    batched = model.stream_args(
        params, init_states_batched(model, params, len(wins), mode="v3"),
        snaps)
    return solo, batched, tuple(lens)


def drive_arrays(cfg, inputs, plan_kw, force_ref=False):
    """A run_arrays path: the solo stream, then the ragged batch."""
    solo, batched, lens = inputs
    a = api.run_arrays(api.plan(cfg, level="v3", **plan_kw), *solo,
                       force_ref=force_ref, device="cuda")
    b = api.run_arrays(api.plan(cfg, level="v3", batch=len(lens),
                                lengths=lens, **plan_kw), *batched,
                       force_ref=force_ref, device="cuda")
    torch.cuda.synchronize()
    return a, b


def launched(label: str) -> dict:
    """The launch counts of the path just run (nonzero ones), logged."""
    counts = {k: v for k, v in engine.LAUNCHES.items() if v}
    log(f"path {label}: launches {counts}")
    return counts


def capacity_path(n_global, np_stream, gen) -> dict:
    """EvolveGCN-O at hidden 256 (square D = 256) on the stream's first
    CAPACITY_T snapshots: the resident engine's W copy is over the card's
    shared memory, so the resident session refuses with the hint to page
    before the engine's launch (its one launch is the edge terms, which
    come first); the paged session (td 16, depth 2) runs and matches its
    force-ref run. Returns the paged run's launch counts."""
    cfg = dataclasses.replace(EVOLVEGCN, hidden=CAPACITY_HIDDEN)
    model = build_model(cfg, n_global=n_global)
    params = ops.to_device(model.init(gen), "cuda")
    snaps = window(np_stream, 0, CAPACITY_T).to("cuda")
    D = max(max(d) for d in layer_dims(cfg))
    session = lambda plan_kw, force_ref=False: api.BoosterSession(
        cfg, api.plan(cfg, level="v3", **plan_kw), n_global=n_global,
        params=params, device="cuda", force_ref=force_ref)
    label = f"capacity {cfg.name} hidden={CAPACITY_HIDDEN} (D={D}) T={CAPACITY_T}"
    engine.reset_launches()
    msg = expect_raises(lambda: session({}).run(snaps), ValueError,
                        "page the state store with plan(state_residency="
                        "'hbm_paged', td=...)")
    refused = {k: v for k, v in engine.LAUNCHES.items() if v}
    check(refused == {"edge_terms": 1},
          f"{label}: refused, launched {refused}")
    log(f"{label} resident: refused: {msg}")
    engine.reset_launches()
    sess = session(paged_plan(2))
    outs = sess.run(snaps)
    torch.cuda.synchronize()
    counts = launched(f"{label} hbm_paged d2")
    check(counts.get("evolve_engine_paged", 0) > 0,
          f"{label} launched evolve_engine_paged")
    ref = session(paged_plan(2), force_ref=True)
    ref_outs = ref.run(snaps)
    errs = {"outs": max_err(outs, ref_outs),
            "state": max_err(sess.state, ref.state)}
    log(f"{label} hbm_paged d2 vs force_ref: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_STREAM})")
    check(outs.shape == (CAPACITY_T, N_PAD, cfg.out_dim)
          and bool(torch.isfinite(outs).all())
          and float(outs.abs().max()) > 0, f"{label} outputs")
    check(all(np.isfinite(v) and v <= TOL_STREAM for v in errs.values()),
          f"{label} vs force_ref {errs}")
    return counts


def rnn_path(cell: str) -> dict:
    """ops.fused_gru / ops.fused_lstm at the benchmark's shape, against the
    force-ref call (<= 1e-4); returns the launch counts."""
    inp = rnn_inputs(cell, RNN_ROWS, RNN_DIN, RNN_H, SEED + 1)
    engine.reset_launches()
    got = getattr(ops, cell)(*inp, tb=RNN_TB)
    torch.cuda.synchronize()
    counts = launched(f"ops.{cell} rows={RNN_ROWS} tb={RNN_TB}")
    check(counts.get(cell, 0) > 0, f"ops.{cell} launched {cell}")
    err = max_err(got, getattr(ops, cell)(*inp, tb=RNN_TB, force_ref=True))
    log(f"ops.{cell} vs force_ref: max_abs_err={err:.3e} (tol {TOL_KERNEL})")
    check(np.isfinite(err) and err <= TOL_KERNEL, f"ops.{cell}")
    return counts


def tile_probe() -> dict:
    """Where a live node tile's time goes: gcrn_step at full width (n 640,
    din 64, H 128, k 27), then stacked_step (n 640, din = dmid = H = 128,
    k 27), on synthetic inputs that vary the live rows, the live lanes a
    row, the rows with a nonzero h (stacked) and the widths, each case a
    pass of 20 launches timed three ways (``step_turns``: bare launches, a
    CUDA graph, and later the kernel's duration; us a call). With 5 live
    lanes a row and 128 live rows it matches the main path's shape (~107
    real rows, ~5 live lanes)."""
    def inputs(live_rows=128, live_lanes=5, k=27, din=64, H=128):
        g = torch.Generator().manual_seed(SEED)
        n = N_PAD
        live_rows = min(live_rows, n)
        idx = torch.randint(0, max(live_rows, 1), (n, k), generator=g,
                            dtype=torch.int32)
        coef = torch.zeros(n, k)
        coef[:live_rows, :live_lanes] = torch.rand(live_rows, live_lanes,
                                                   generator=g) + 0.1
        dense = [torch.randn(*shape, generator=g) * 0.3 for shape in
                 ((n, din), (n, H), (n, H), (din, 4 * H), (H, 4 * H))]
        return [t.cuda() for t in (idx, coef, torch.zeros_like(idx), *dense,
                                   torch.zeros(4 * H))]

    cases = (("128 live rows, 5 of 27 lanes", {}),
             ("128 live rows, 1 of 27 lanes", dict(live_lanes=1)),
             ("128 live rows, k = 1", dict(live_lanes=1, k=1)),
             ("128 live rows, 27 of 27 lanes", dict(live_lanes=27)),
             ("32 live rows (one tile), 5 lanes", dict(live_rows=32)),
             ("640 live rows, 5 lanes", dict(live_rows=640)),
             ("no live row (bias only)", dict(live_rows=0)),
             ("128 live rows, din 32, H 64", dict(din=32, H=64)))
    probe = {}
    for label, kw in cases:
        args = inputs(**kw)
        t = probe[label] = step_turns(
            lambda: [engine.prepare("gcrn_step", *args)] * 20, "gcrn_step",
            f"tile probe gcrn_step: {label}")
        log(f"tile probe gcrn_step: {label}: {t['events'] * 1e3:.2f} us "
            f"bare launches, {t['graph'] * 1e3:.2f} us graph a call")

    def stacked_inputs(live_rows=128, live_lanes=5, k=27, din=128, dmid=128,
                       H=128, h_rows=None):
        """stacked_step at full width (n 640): the first ``live_rows`` rows
        with ``live_lanes`` live lanes, the first ``h_rows`` (default
        live_rows) with a nonzero h, the rest padding (h 0)."""
        g = torch.Generator().manual_seed(SEED + 1)
        n = N_PAD
        live_rows = min(live_rows, n)
        h_rows = live_rows if h_rows is None else h_rows
        idx = torch.randint(0, max(live_rows, 1), (n, k), generator=g,
                            dtype=torch.int32)
        coef = torch.zeros(n, k)
        coef[:live_rows, :live_lanes] = torch.rand(live_rows, live_lanes,
                                                   generator=g) + 0.1
        h = torch.zeros(n, H)
        h[:h_rows] = torch.randn(h_rows, H, generator=g) * 0.3
        dense = [torch.randn(*shape, generator=g) * 0.3 for shape in
                 ((n, din), (din, dmid), (dmid,), (dmid, 3 * H),
                  (H, 3 * H), (3 * H,))]
        x, wg, bg, wx, wh, b = dense
        return [t.cuda() for t in (idx, coef, torch.zeros_like(idx), x, h,
                                   wg, bg, wx, wh, b)]

    stacked_cases = (
        ("128 live rows, 5 of 27 lanes", {}),
        ("128 live rows, 27 of 27 lanes", dict(live_lanes=27)),
        ("32 live rows (one tile), 5 lanes", dict(live_rows=32)),
        ("640 live rows, 5 lanes", dict(live_rows=640)),
        ("no live row, h 0 (padding rows)", dict(live_rows=0)),
        ("no live row, h on 128 rows", dict(live_rows=0, h_rows=128)),
        ("128 live rows, din 64 (one GCN layer)", dict(din=64)))
    for label, kw in stacked_cases:
        args = stacked_inputs(**kw)
        t = probe[f"stacked_step {label}"] = step_turns(
            lambda: [engine.prepare("stacked_step", *args)] * 20,
            "stacked_step", f"tile probe stacked_step: {label}")
        log(f"tile probe stacked_step: {label}: {t['events'] * 1e3:.2f} us "
            f"bare launches, {t['graph'] * 1e3:.2f} us graph a call")
    return probe


def busy_share(cfg, level, params, n_global, stream, plan_kw=None):
    """(wall ms, device ms) of one session ``run`` of the whole stream under
    torch.profiler (busy_share_fn)."""
    sess = api.BoosterSession(cfg, api.plan(cfg, level=level,
                                            **(plan_kw or {})),
                              n_global=n_global, params=params,
                              device="cuda")
    return busy_share_fn(lambda: sess.run(stream))


# ------------------------------------------------- the LM serving path ----

def flash_case(seed, bh, s, d, group, dtype, skv=None):
    """Random CUDA q / k / v of one flash call (numpy, from ``seed``):
    unit-normal, distinct K / V per kv head; Skv = S unless given."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dtype).cuda()
    skv = s if skv is None else skv
    return t(bh, s, d), t(bh // group, skv, d), t(bh // group, skv, d)


def narrow_tile(s: int) -> int:
    """bq = bk of a narrow flash case: 128 where min(128, S) divides S,
    else S."""
    return 128 if s % min(128, s) == 0 else s


def flash_small_check():
    """Both flash kernels against their plain versions on narrow cases:
    head_dim 16 / 80 / 96 / 128, S 64 / 128 / 200 / 384 (narrow_tile),
    causal and not, group 1 / 4 / 5 (B 2, 2 kv heads), and FLASH_EDGE,
    fp32 and bf16; o within TOL_FLASH[dtype], lse within TOL_LSE;
    flash_attention's o equal to flash_fwd's bit for bit (one kernel
    template). Then the refusals on CUDA tensors: a tail and a head_dim
    over the limit, launching nothing. Returns the largest errors by
    dtype."""
    cases = [(d, s, s, causal, group) for d in FLASH_HD for s in FLASH_S
             for causal in (True, False) for group in FLASH_GROUPS]
    cases += FLASH_EDGE
    worst = {dt: 0.0 for dt in TOL_FLASH}
    lse_worst, n = 0.0, 0
    for dtype in TOL_FLASH:
        for d, s, skv, causal, group in cases:
            n += 1
            q, k, v = flash_case(n, 2 * 2 * group, s, d, group, dtype, skv)
            args = (q, k, v, causal, narrow_tile(s), narrow_tile(skv), group)
            o, lse = fa.flash_fwd(*args)
            o2 = fa.flash_attention(q, k, v, causal=causal, bq=args[4],
                                    bk=args[5], group=group)
            o_p, lse_p = fa.flash_fwd_plain(*args)
            torch.cuda.synchronize()
            err = max_err(o.float(), o_p.float())
            err_lse = max_err(lse, lse_p)
            label = (f"flash d={d} S={s} Skv={skv} causal={causal} "
                     f"group={group} {dtype}")
            check(np.isfinite(err) and err <= TOL_FLASH[dtype]
                  and err_lse <= TOL_LSE,
                  f"{label}: o {err:.3e}, lse {err_lse:.3e}")
            check(torch.equal(o, o2), f"{label}: flash_attention o equals "
                  "flash_fwd o")
            worst[dtype] = max(worst[dtype], err)
            lse_worst = max(lse_worst, err_lse)
    for dtype, err in worst.items():
        log(f"flash narrow cases {dtype}: {n // 2} cases, max_abs_err o "
            f"{err:.3e} (tol {TOL_FLASH[dtype]}); flash_attention o equal "
            "to flash_fwd o")
    log(f"flash narrow cases: max_abs_err lse {lse_worst:.3e} (tol {TOL_LSE})")
    engine.reset_launches()
    q, k, v = flash_case(0, 4, 96, 16, 2, torch.bfloat16)
    for name in ("flash_attention", "flash_fwd"):
        fn = getattr(fa, name)
        msg = expect_raises(lambda: fn(q, k, v, causal=True, bq=64, bk=32,
                                       group=2), ValueError, "must divide")
        log(f"{name}: S=96 bq=64 refused: {msg}")
        big = flash_case(0, 2, 64, 136, 1, torch.bfloat16)
        msg = expect_raises(lambda: fn(*big, causal=True, bq=64, bk=64,
                                       group=1), ValueError,
                            "multiple of 8 up to 128")
        log(f"{name}: head_dim 136 refused: {msg}")
    check(not any(engine.LAUNCHES.values()), "a refused flash call launched")
    return worst


def lm_model():
    """Qwen2.5-14B at full width and depth, random bf16 weights drawn on the
    card from the seed; (cfg, params)."""
    cfg = ARCHS[LM_ARCH]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, LM_RT, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in flat(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / {cfg.n_kv_heads} kv, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"(padded {cfg.padded_vocab()}), qkv_bias {cfg.qkv_bias}; "
        f"{n / 1e9:.3f} B params, "
        f"{nbytes(*flat(params)) / 1e9:.2f} GB bf16, init "
        f"{time.time() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return cfg, params


def lm_tokens(b, s, seed, vocab):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (b, s)).astype(
        np.int32)).cuda()


@contextlib.contextmanager
def recording_flash(keep, name="flash_fwd"):
    """Record the CUDA inputs of the ``name`` calls whose index (the layer,
    in one prefill) is in ``keep``; nn/attention reaches the kernels
    through kernels/flash_attention.flash_mha and flash_bwd, which look
    them up at each call."""
    calls, original, seen = {}, getattr(fa, name), [0]

    def wrapper(*args, **kwargs):
        if seen[0] in keep:
            calls[seen[0]] = tuple(a.clone() if torch.is_tensor(a) else a
                                   for a in args)
        seen[0] += 1
        return original(*args, **kwargs)

    setattr(fa, name, wrapper)
    try:
        yield calls
    finally:
        setattr(fa, name, original)


def flash_cost(q, k, causal):
    """(flop, bytes) of one flash call: 4 d flops per (q, k) pair a row
    sees (S (S + 1) / 2 pairs a head when causal), q / k / v read once, o
    and the lse rows written once."""
    bh, s, d = q.shape
    skv = k.shape[1]
    pairs = s * (s + 1) // 2 if causal else s * skv
    flops = 4.0 * d * pairs * bh
    byts = 2 * nbytes(q) + 2 * nbytes(k) + bh * s * 4
    return flops, byts


def sdpa_call(q, k, v, group, causal):
    """The one PyTorch call that computes the same attention:
    scaled_dot_product_attention with enable_gqa, a kv head's ``group`` q
    heads as one (B * Hkv, group, S, d) block against its (B * Hkv, 1, Skv,
    d) K / V."""
    s, d = q.shape[1:]
    q4 = q.view(-1, group, s, d)
    k4, v4 = k.view(-1, 1, k.shape[1], d), v.view(-1, 1, v.shape[1], d)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  enable_gqa=True)


def flash_timings(label, run, q, k, v, causal, group):
    """ms a call of ``run`` (a flash kernel on q / k / v) and of SDPA on the
    same inputs, in turns: on CUDA events (FLASH_SAMPLES samples of
    FLASH_CALLS calls) and from CUDA graphs of FLASH_CALLS calls; each
    logged with its TFLOP/s and share of the bound. Returns (ms, SDPA ms,
    graph ms, SDPA graph ms, bound ms, bound by)."""
    sdpa = sdpa_call(q, k, v, group, causal)
    ms, lib_ms = interleaved_ms([run, sdpa], FLASH_CALLS, FLASH_SAMPLES)
    graphs = [graph_of(lambda: run, FLASH_CALLS),
              graph_of(lambda: sdpa, FLASH_CALLS)]
    graph_ms, lib_graph_ms = (t / FLASH_CALLS for t in interleaved_ms(
        [g.replay for g in graphs], 1, FLASH_SAMPLES))
    flops, byts = flash_cost(q, k, causal)
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, byts / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    rate = lambda t: (f"{t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, "
                      f"{bound_ms / t:.3f} of the bound)")
    log(f"{label}: q {tuple(q.shape)} k {tuple(k.shape)} causal={causal} "
        f"group={group}; kernel {rate(ms)}, SDPA {rate(lib_ms)} (median of "
        f"{FLASH_SAMPLES}, {FLASH_CALLS} calls a sample, in turns); from a "
        f"CUDA graph kernel {rate(graph_ms)}, SDPA {rate(lib_graph_ms)}; "
        f"kernel / SDPA {ms / lib_ms:.2f} (graph {graph_ms / lib_graph_ms:.2f})"
        f"; bound {bound_ms:.4f} ms ({by}: {flops:.3e} flop, {byts:.3e} B)")
    return ms, lib_ms, graph_ms, lib_graph_ms, bound_ms, by


def flash_train_shape(arch=TRAIN_ARCH):
    """q / k / v at ``arch``'s training shape (TRAIN_BATCH x TRAIN_SEQ;
    phi3-mini-3.8b: 32 heads of 96, group 1, the bf16 kernel holding d 96
    as 128 columns; granite-moe-3b-a800m: 24 heads of 64, group 3), from
    the seed; (q, k, v, group)."""
    cfg = ARCHS[arch]
    group = cfg.n_heads // cfg.n_kv_heads
    q, k, v = flash_case(SEED + 5, TRAIN_BATCH * cfg.n_heads, TRAIN_SEQ,
                         cfg.resolved_head_dim, group, torch.bfloat16)
    return q, k, v, group


def check_flash_config(*qs):
    """The bf16 launch the library's launcher builds for both flash entry
    points (tiles, ring, threads, shared memory, grid) equals
    engine.flash_config at each q of ``qs``, and fits the card's shared
    memory."""
    for q in qs:
        bh, s, d = q.shape
        lib = engine.library_flash_config(bh, s)
        want = engine.flash_config(bh, s, d)
        log(f"flash launch at q {tuple(q.shape)}: {lib}")
        check(lib == want, f"the flash library's launch {lib} equals "
              f"engine.flash_config {want}")
        check(lib["smem"] <= engine.SMEM_LIMIT, "flash shared memory")


def check_flash_kernel(name, calls):
    """A flash kernel on the prefill's own q / k / v (layer 0 and the last
    layer) against its plain version (<= TOL_FLASH bf16, lse <= TOL_LSE),
    timed beside its bound, the plain version and SDPA (flash_timings);
    flash_fwd also at phi3's and granite's training shapes (FLASH_TRAIN:
    the records' train_shape_* and granite_shape_* fields), and the launch
    at every shape held to engine.flash_config; its record (times of the
    last layer's call)."""
    err, err_lse = 0.0, 0.0
    for layer, (q, k, v, causal, bq, bk, group) in sorted(calls.items()):
        if name == "flash_fwd":
            o, lse = fa.flash_fwd(q, k, v, causal, bq, bk, group)
        else:
            o, lse = fa.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk,
                                        group=group), None
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, bq, bk, group)
        lib = sdpa_call(q, k, v, group, causal)()
        torch.cuda.synchronize()
        e = max_err(o.float(), o_p.float())
        e_lib = max_err(lib.reshape(o.shape).float(), o_p.float())
        e_lse = 0.0 if lse is None else max_err(lse, lse_p)
        log(f"{name}: layer {layer} q {tuple(q.shape)} k {tuple(k.shape)} "
            f"{q.dtype} causal={causal} group={group} max_abs_err o "
            f"{e:.3e} (tol {TOL_FLASH[torch.bfloat16]}), lse {e_lse:.3e} "
            f"(tol {TOL_LSE}); SDPA vs plain {e_lib:.3e}")
        check(np.isfinite(e) and e <= TOL_FLASH[torch.bfloat16]
              and e_lse <= TOL_LSE, f"{name} layer {layer}")
        err, err_lse = max(err, e), max(err_lse, e_lse)
    q, k, v, causal, bq, bk, group = calls[max(calls)]
    if name == "flash_fwd":
        run = lambda: fa.flash_fwd(q, k, v, causal, bq, bk, group)
    else:
        run = lambda: fa.flash_attention(q, k, v, causal=causal, bq=bq,
                                         bk=bk, group=group)
    ms, lib_ms, graph_ms, lib_graph_ms, bound_ms, by = flash_timings(
        f"{name} layer {max(calls)}", run, q, k, v, causal, group)
    plain_ms = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, bq, bk,
                                                  group), reps=3)
    log(f"{name}: {plain_ms:.4f} ms plain")
    extra, shapes = {}, [q]
    for arch, key in (FLASH_TRAIN.items() if name == "flash_fwd" else ()):
        tq, tk, tv, tgroup = flash_train_shape(arch)
        o, lse = fa.flash_fwd(tq, tk, tv, True, bq, bk, tgroup)
        o_p, lse_p = fa.flash_fwd_plain(tq, tk, tv, True, bq, bk, tgroup)
        torch.cuda.synchronize()
        e, e_lse = max_err(o.float(), o_p.float()), max_err(lse, lse_p)
        log(f"{name}: {arch}'s training shape q {tuple(tq.shape)} k "
            f"{tuple(tk.shape)} group {tgroup} max_abs_err o {e:.3e} (tol "
            f"{TOL_FLASH[torch.bfloat16]}), lse {e_lse:.3e} (tol {TOL_LSE})")
        check(np.isfinite(e) and e <= TOL_FLASH[torch.bfloat16]
              and e_lse <= TOL_LSE, f"{name} at {arch}'s training shape")
        t = flash_timings(f"{name} {arch} training shape",
                          lambda: fa.flash_fwd(tq, tk, tv, True, bq, bk,
                                               tgroup),
                          tq, tk, tv, True, tgroup)
        t_plain = cuda_ms(lambda: fa.flash_fwd_plain(tq, tk, tv, True, bq,
                                                     bk, tgroup), reps=3)
        log(f"{name}: {t_plain:.4f} ms plain at {arch}'s training shape")
        extra.update({f"{key}": list(tq.shape), f"{key}_ms": t[0],
                      f"{key}_library_ms": t[1], f"{key}_graph_ms": t[2],
                      f"{key}_library_graph_ms": t[3],
                      f"{key}_bound_ms": t[4], f"{key}_plain_ms": t_plain,
                      f"{key}_max_abs_err": e})
        shapes.append(tq)
    if name == "flash_fwd":
        check_flash_config(*shapes)
    return record(name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
                  graph_ms=graph_ms, library_graph_ms=lib_graph_ms,
                  lse_max_abs_err=err_lse, shape=list(q.shape),
                  kv_shape=list(k.shape), **extra)


def logits_err(got, want, vocab):
    """Largest difference over the real vocabulary, relative to max
    |want| there."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def plain_flash():
    """Route the model's flash calls, forward and backward, to the
    kernels' plain versions (on the card): the same functions, summed in
    another order."""
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    originals = [getattr(fa, name) for name in names]
    for name in names:
        setattr(fa, name, getattr(fa, f"{name}_plain"))
    try:
        yield
    finally:
        for name, fn in zip(names, originals):
            setattr(fa, name, fn)


def layer_check(cfg, params, tokens):
    """Every layer of one prefill, teacher-forced: each layer's attention
    sublayer (the part the flash kernel changes) with attn_impl="flash"
    against "xla" on the same input, the xla path's own hidden state, so a
    layer's difference does not compound through the later ones; and the
    whole layer's update (output minus input) the same way, logged.
    The layers are walked as backbone walks them (lm.iter_layers,
    lm.attention_sublayer, lm.layer_apply). Its flash launches are a check,
    not the main path: the callers read the counts around the main path
    alone. Returns the largest attention-sublayer difference relative to
    max |output| of that layer, its layer, and the largest update
    difference."""
    rts = {impl: dataclasses.replace(LM_RT, attn_impl=impl)
           for impl in ("flash", "xla")}
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    worst, at, worst_update = 0.0, -1, 0.0
    with torch.inference_mode():
        x = embed_lookup(params["embed"], tokens)
        for layer, (_, mlp, pl, _) in enumerate(lm.iter_layers(params, cfg)):
            att = {impl: lm.attention_sublayer(pl, cfg, rt, x, positions)[0]
                   for impl, rt in rts.items()}
            err = rel_err(att["flash"], att["xla"])
            if err > worst:
                worst, at = err, layer
            y = {impl: lm.layer_apply(pl, cfg, rt, mlp, x, positions)[0]
                 for impl, rt in rts.items()}
            worst_update = max(worst_update,
                               rel_err(y["flash"] - x, y["xla"] - x))
            x = y["xla"]
    return worst, at, worst_update


def lm_prefill_path(cfg, params, tokens):
    """Path (a): prefill_step with attn_impl="flash" on the prompts, counts
    read around it (flash_fwd exactly once a layer, nothing else); its
    logits against attn_impl="xla" (the full / chunked torch path at
    attn_chunk 2048) and against the same path on the kernel's plain
    version, within TOL_DRIFT of max |logits| (the full-depth spread of
    bf16 paths that round at other places) with the same argmax, and each
    layer's attention sublayer, teacher-forced, against xla within
    TOL_LOGITS; then timed (median of 3, host clock to a sync), counts read
    around the timed calls. Returns (the counts of the checked and the
    timed prefills, ms)."""
    rt = dataclasses.replace(LM_RT, attn_impl="flash")
    engine.reset_launches()
    logits = prefill_step(params, cfg, rt, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = launched(f"{cfg.name} prefill flash B={tokens.shape[0]} "
                      f"S={tokens.shape[1]}")
    check(counts == {"flash_fwd": cfg.n_layers},
          f"prefill launched flash_fwd once a layer, nothing else: {counts}")
    check(logits.shape == (tokens.shape[0], 1, cfg.padded_vocab())
          and bool(torch.isfinite(logits).all()), "prefill logits")
    V = cfg.vocab_size
    ref = prefill_step(params, cfg, dataclasses.replace(LM_RT,
                                                        attn_impl="xla"),
                       {"tokens": tokens})
    with plain_flash():
        plain = prefill_step(params, cfg, rt, {"tokens": tokens})
    errs = {"flash vs xla": logits_err(logits, ref, V),
            "flash vs flash-plain": logits_err(logits, plain, V),
            "flash-plain vs xla": logits_err(plain, ref, V)}
    same = {k: torch.equal(x[..., :V].argmax(-1), y[..., :V].argmax(-1))
            for k, (x, y) in (("flash vs xla", (logits, ref)),
                              ("flash vs flash-plain", (logits, plain)))}
    log(f"prefill logits, max |diff| / max |logits| (max |logits| "
        f"{float(ref[..., :V].abs().max()):.3f}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {TOL_DRIFT}); argmax equal {same}")
    check(all(np.isfinite(v) and v <= TOL_DRIFT for v in errs.values()),
          f"prefill logits {errs}")
    check(all(same.values()), f"prefill logits argmax {same}")
    del ref, plain
    err, at, err_update = layer_check(cfg, params, tokens)
    log(f"prefill layers, teacher-forced, flash vs xla: attention sublayer "
        f"max |diff| / max |output| {err:.3e} (worst layer {at}; tol "
        f"{TOL_LOGITS}); whole-layer update {err_update:.3e}")
    check(np.isfinite(err) and err <= TOL_LOGITS, "prefill layers")
    ms = []
    engine.reset_launches()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_step(params, cfg, rt, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    timed = launched(f"{cfg.name} prefill flash, 3 timed calls")
    check(timed == {"flash_fwd": 3 * cfg.n_layers},
          f"timed prefills launched flash_fwd once a layer: {timed}")
    for k, v in timed.items():
        counts[k] += v
    log(f"prefill flash: {float(np.median(ms)):.2f} ms median of 3 (all "
        f"{', '.join(f'{m:.2f}' for m in ms)}), "
        f"{tokens.numel() / np.median(ms) * 1e3:.0f} tokens/s")
    return counts, float(np.median(ms))


def lm_generate_path(cfg, params):
    """Path (b): generate answers LM_BATCH requests (LM_PROMPT-token
    prompts, LM_NEW new tokens, a cache of LM_SKV), counts read around
    it; then the decode logits after the last prompt token (decode_step
    through the caches) against a flash prefill of the same prompts
    within TOL_DRIFT, and against an xla prefill (bf16 scores, as decode)
    within TOL_LOGITS. The reference prefill's launches are a check, not
    the path's. Returns (counts, decode ms a token)."""
    prompt = lm_tokens(LM_BATCH, LM_PROMPT, SEED + 2, cfg.vocab_size)
    engine.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, cfg, LM_RT, prompt, LM_NEW, LM_SKV)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    counts = launched(f"{cfg.name} generate B={LM_BATCH} prompt "
                      f"{LM_PROMPT} new {LM_NEW} skv {LM_SKV}")
    n_steps = LM_PROMPT + LM_NEW - 1
    check(out.shape == (LM_BATCH, LM_NEW) and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"generate tokens {tuple(out.shape)}")
    log(f"generate: {total:.1f} ms for {n_steps} decode steps, "
        f"{total / n_steps:.2f} ms a step (B={LM_BATCH}); tokens "
        f"{out.tolist()}")
    caches = init_caches(cfg, LM_RT, LM_BATCH, LM_SKV)
    for i in range(LM_PROMPT):
        logits, caches = decode_step(params, cfg, LM_RT, prompt[:, i:i + 1],
                                     caches)
    engine.reset_launches()
    ref = prefill_step(params, cfg, dataclasses.replace(
        LM_RT, attn_impl="flash"), {"tokens": prompt})
    torch.cuda.synchronize()
    ref_counts = launched(f"{cfg.name} prefill flash of the prompts")
    check(ref_counts == {"flash_fwd": cfg.n_layers},
          f"prompt prefill launched flash_fwd once a layer: {ref_counts}")
    ref_xla = prefill_step(params, cfg, dataclasses.replace(
        LM_RT, attn_impl="xla"), {"tokens": prompt})
    err = logits_err(logits, ref, cfg.vocab_size)
    err_xla = logits_err(logits, ref_xla, cfg.vocab_size)
    first = torch.equal(out[:, 0].long(),
                        ref[:, -1, :cfg.vocab_size].argmax(-1))
    log(f"decode after the prompt, max |diff| / max |logits|: vs flash "
        f"prefill {err:.3e} (tol {TOL_DRIFT}), vs xla prefill (the same "
        f"bf16 scores) {err_xla:.3e} (tol {TOL_LOGITS}); first generated "
        f"token = flash prefill argmax {first}")
    check(np.isfinite(err) and err <= TOL_DRIFT, "decode vs flash prefill")
    check(np.isfinite(err_xla) and err_xla <= TOL_LOGITS,
          "decode vs xla prefill")
    return counts, total / n_steps


def flash_attention_path(call):
    """flash_attention's own entry point (no model path reaches it, as in
    the JAX package) on the prefill's layer-0 q / k / v, counts read
    around it; its o equals flash_fwd's."""
    q, k, v, causal, bq, bk, group = call
    want, _ = fa.flash_fwd(q, k, v, causal, bq, bk, group)
    engine.reset_launches()
    o = fa.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk, group=group)
    torch.cuda.synchronize()
    counts = launched("kernels.flash_attention.flash_attention on the "
                      "prefill's layer-0 q / k / v")
    check(counts == {"flash_attention": 1}, f"flash_attention {counts}")
    check(torch.equal(o, want), "flash_attention o equals flash_fwd o")
    return counts


def busy_share_fn(fn):
    """(wall ms, device ms) of one ``fn()`` after a warm call, under
    torch.profiler recording the device's activity only: the device time
    is the kernels' summed self time; the wall time holds what the
    profiler costs the host, so 1 - device / wall overstates the idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.key[:90]}")
    return wall, device


# -------------------------------------------------- the LM training path ----

def flash_bwd_inputs(seed, bh, s, d, group, dtype, causal, skv=None):
    """One backward call's CUDA inputs from ``seed``: q / k / v / dO
    unit-normal (distinct K / V per kv head; Skv = S unless given), o and
    lse from flash_fwd, delta = rowsum(dO o); the argument tuple of
    flash_bwd_dkv / _dq."""
    q, k, v = flash_case(seed, bh, s, d, group, dtype, skv)
    do = flash_case(seed + 7919, bh, s, d, 1, dtype)[0]
    with torch.no_grad():
        o, lse = fa.flash_fwd(q, k, v, causal, 512, 512, group)
    delta = (do.float() * o.float()).sum(dim=-1)
    return (q, k, v, do, lse, delta, causal, 512, 512, group)


def bwd_errs(args):
    """(largest |diff| / max |plain| over dq, dk, dv, largest |diff|) of
    both backward kernels against their plain versions."""
    got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    want = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    rel = max(max_err(g.float(), w.float()) / float(w.float().abs().max())
              for g, w in zip(got, want))
    return rel, {name: max_err(g.float(), w.float()) for name, g, w in
                 zip(("dq", "dk", "dv"), got, want)}


def flash_bwd_small_check():
    """Both backward kernels against their plain versions on narrow cases:
    head_dim 32 / 96 / 128, S 64 / 128 / 200 with the default bq = bk =
    512, causal and not, group 1 / 4 / 5 (2 kv heads), and FLASH_BWD_EDGE
    (every head_dim 8..128; Skv unlike S), fp32 and bf16, each within
    TOL_FLASH_BWD of max |plain|; then a tail refused on CUDA tensors,
    launching nothing."""
    cases = [(d, s, s, causal, group) for d in FLASH_BWD_HD
             for s in FLASH_BWD_S for causal in (True, False)
             for group in FLASH_GROUPS]
    cases += FLASH_BWD_EDGE
    worst, n = {dt: 0.0 for dt in TOL_FLASH_BWD}, 0
    for dtype in TOL_FLASH_BWD:
        for d, s, skv, causal, group in cases:
            n += 1
            rel, _ = bwd_errs(flash_bwd_inputs(100 + n, 2 * group, s, d,
                                               group, dtype, causal, skv))
            check(np.isfinite(rel) and rel <= TOL_FLASH_BWD[dtype],
                  f"flash bwd d={d} S={s} Skv={skv} causal={causal} "
                  f"group={group} {dtype}: {rel:.3e}")
            worst[dtype] = max(worst[dtype], rel)
    for dtype, err in worst.items():
        log(f"flash bwd narrow cases {dtype}: {n // 2} cases, max |diff| / "
            f"max |plain| {err:.3e} (tol {TOL_FLASH_BWD[dtype]})")
    args = list(flash_bwd_inputs(0, 4, 96, 16, 2, torch.bfloat16, True))
    args[7:9] = [64, 32]  # bq 64 does not divide S 96
    engine.reset_launches()
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        msg = expect_raises(lambda: getattr(fa, name)(*args), ValueError,
                            "must divide")
        log(f"{name}: S=96 bq=64 refused: {msg}")
    check(not any(engine.LAUNCHES.values()), "a refused flash bwd launched")
    return worst


def flash_bwd_cost(q, k, causal, per_pair):
    """(flop, bytes) of one backward pass: ``per_pair`` d flops per (q, k)
    pair a row sees (8 for dK / dV: q.k, dO.v, p.dO, dS.q; 6 for dQ: q.k,
    dO.v, dS.k); q, k, v, dO, lse and delta read once, dK and dV (or dQ)
    written once."""
    bh, s, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * k.shape[1]
    flops = float(per_pair) * d * pairs * bh
    reads = 2 * nbytes(q) + 2 * nbytes(k) + 2 * bh * s * 4
    writes = 2 * nbytes(k) if per_pair == 8 else nbytes(q)
    return flops, reads + writes


def sdpa_bwd_call(q, k, v, do, group, causal, stream):
    """SDPA's backward alone with enable_gqa on the same q / k / v / dO:
    the forward runs once on ``stream`` (so autograd runs the backward
    there too), and the returned call reruns its backward
    (retain_graph); yardstick only, the port never calls it."""
    s, d = q.shape[1:]
    q4, do4 = q.view(-1, group, s, d), do.view(-1, group, s, d)
    k4, v4 = k.view(-1, 1, k.shape[1], d), v.view(-1, 1, v.shape[1], d)
    leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
    torch.cuda.current_stream().wait_stream(stream)
    return lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True)


def check_flash_bwd_launch(q, k, group):
    """The bf16 launches the library builds for both passes (tiles, ring,
    threads, shared memory, grid) equal engine.flash_bwd_config at q / k's
    shape and fit the card's shared memory."""
    bh, s, d = q.shape
    for kind in engine.FLASH_BWD_KINDS:
        lib = engine.library_flash_bwd_config(bh, s, group, kind,
                                              skv=k.shape[1])
        want = engine.flash_bwd_config(bh, s, d, group, kind, skv=k.shape[1])
        log(f"flash bwd {kind} launch at q {tuple(q.shape)} group {group}: "
            f"{lib}")
        check(lib == want, f"the flash bwd library's {kind} launch {lib} "
              f"equals engine.flash_bwd_config {want}")
        check(lib["smem"] <= engine.SMEM_LIMIT, "flash bwd shared memory")


def flash_bwd_shape_check(label, args):
    """Both backward kernels on one shape's inputs: against their plain
    versions (TOL_FLASH_BWD bf16 of max |plain|), two calls bit for bit
    equal (every output written once: no atomics), the launches held to
    engine.flash_bwd_config; then dkv, dq and SDPA's backward timed in
    turns on CUDA events (FLASH_SAMPLES samples of FLASH_CALLS calls) and
    from CUDA graphs of FLASH_CALLS calls, each logged with its TFLOP/s
    and share of the bound. Returns {name: fields of its record}."""
    q, k, v, do = args[:4]
    group = args[-1]
    rel, errs = bwd_errs(args)
    log(f"flash bwd {label}: q {tuple(q.shape)} k {tuple(k.shape)} bf16 "
        f"causal={args[6]} group={group}: max |diff| / max |plain| "
        f"{rel:.3e} (tol {TOL_FLASH_BWD[torch.bfloat16]}), max |diff| {errs}")
    check(np.isfinite(rel) and rel <= TOL_FLASH_BWD[torch.bfloat16],
          f"flash bwd at {label}")
    first = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"flash bwd {label}: two calls bit for bit equal (dq, dk, dv): "
        f"{same}")
    check(same, f"flash bwd at {label} repeats bit for bit")
    del first, again
    check_flash_bwd_launch(q, k, group)

    side = torch.cuda.Stream()
    sdpa = sdpa_bwd_call(q, k, v, do, group, args[6], side)
    calls = {"flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args)}
    ms = interleaved_ms([*calls.values(), sdpa], FLASH_CALLS, FLASH_SAMPLES)
    graphs = [graph_of(lambda fn=fn: fn, FLASH_CALLS) for fn in calls.values()]
    try:
        graphs.append(graph_of(lambda: sdpa, FLASH_CALLS, side=side))
    except RuntimeError as e:
        torch.cuda.synchronize()
        log(f"flash bwd {label}: SDPA's backward does not capture in a CUDA "
            f"graph ({type(e).__name__}: {str(e).splitlines()[0]})")
    graph_ms = [t / FLASH_CALLS for t in interleaved_ms(
        [g.replay for g in graphs], 1, FLASH_SAMPLES)]
    lib_ms = ms[2]
    lib_graph_ms = graph_ms[2] if len(graph_ms) == 3 else None
    out, bounds = {}, {}
    for i, (name, per_pair) in enumerate((("flash_bwd_dkv", 8),
                                          ("flash_bwd_dq", 6))):
        flops, byts = flash_bwd_cost(q, k, args[6], per_pair)
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, byts / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bounds[name] = bound_ms
        rate = lambda t: (f"{t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s, "
                          f"{bound_ms / t:.3f} of the bound)")
        log(f"{name} {label}: kernel {rate(ms[i])} (median of "
            f"{FLASH_SAMPLES}, {FLASH_CALLS} calls a sample, in turns with "
            f"the other pass and SDPA's backward), from a CUDA graph "
            f"{rate(graph_ms[i])}; bound {bound_ms:.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
            f"{flops:.3e} flop, {byts:.3e} B)")
        out[name] = {"ms": ms[i], "graph_ms": graph_ms[i],
                     "bound_ms": bound_ms,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "max_abs_err": max(errs["dk"], errs["dv"])
                     if name == "flash_bwd_dkv" else errs["dq"]}
    both, both_graph = ms[0] + ms[1], graph_ms[0] + graph_ms[1]
    sdpa_graph = (f"{lib_graph_ms:.4f} ms" if lib_graph_ms is not None
                  else "not captured")
    log(f"flash bwd {label}: SDPA's backward (both passes, enable_gqa) "
        f"{lib_ms:.4f} ms events, {sdpa_graph} from a graph; dkv + dq "
        f"{both:.4f} ms = {both / lib_ms:.2f}x SDPA's backward (graph "
        + (f"{both_graph / lib_graph_ms:.2f}x" if lib_graph_ms else "n/a")
        + f"); both passes at {sum(bounds.values()) / both:.3f} of their "
        "summed bound")
    for rec in out.values():
        rec.update(library_ms=lib_ms, library_graph_ms=lib_graph_ms)
    return out


def check_flash_bwd_kernels():
    """Both backward kernels at Qwen2.5-14B's layer shape (the serving
    path's flash shape: q (80, 2048, 128), k / v (16, 2048, 128), bf16,
    causal; dO from the seed) and at the training shapes of FLASH_TRAIN
    (phi3-mini-3.8b: q / k / v (64, 2048, 96), group 1;
    granite-moe-3b-a800m: q (48, 2048, 64), k / v (16, 2048, 64), group 3)
    through flash_bwd_shape_check, the plain versions timed at each; their
    records (Qwen's times, phi3's as train_shape_*, granite's as
    granite_shape_*)."""
    cfg = ARCHS[LM_ARCH]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    group = hq // hkv
    args = flash_bwd_inputs(SEED + 5, LM_BATCH * hq, LM_SEQ, d, group,
                            torch.bfloat16, True)
    q, k = args[:2]

    def plain_ms(label, args):
        ms = {name: cuda_ms(lambda: getattr(fa, f"{name}_plain")(*args),
                            reps=3) for name in ("flash_bwd_dkv", "flash_bwd_dq")}
        log(f"flash bwd plain versions at {label}: "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items()))
        return ms

    fields = flash_bwd_shape_check("Qwen2.5-14B layer shape", args)
    plain = plain_ms("Qwen2.5-14B's layer shape", args)
    del args
    out = {name: record(name, plain_ms=plain[name], shape=list(q.shape),
                        kv_shape=list(k.shape), **f)
           for name, f in fields.items()}
    for i, (arch, key) in enumerate(FLASH_TRAIN.items()):
        tcfg = ARCHS[arch]
        targs = flash_bwd_inputs(SEED + 6 + i, TRAIN_BATCH * tcfg.n_heads,
                                 TRAIN_SEQ, tcfg.resolved_head_dim,
                                 tcfg.n_heads // tcfg.n_kv_heads,
                                 torch.bfloat16, True)
        tfields = flash_bwd_shape_check(f"{arch} training shape", targs)
        tplain = plain_ms(f"{arch}'s training shape", targs)
        for name, t in tfields.items():
            out[name].update({
                key: list(targs[0].shape),
                f"{key}_kv": list(targs[1].shape), f"{key}_ms": t["ms"],
                f"{key}_graph_ms": t["graph_ms"],
                f"{key}_library_ms": t["library_ms"],
                f"{key}_library_graph_ms": t["library_graph_ms"],
                f"{key}_bound_ms": t["bound_ms"],
                f"{key}_plain_ms": tplain[name],
                f"{key}_max_abs_err": t["max_abs_err"]})
        del targs
    return list(out.values())


def train_model():
    """phi3-mini-3.8b at full width and depth, random fp32 weights drawn
    on the card from the seed; (cfg, params)."""
    cfg = ARCHS[TRAIN_ARCH]
    t0 = time.time()
    params = init_params(cfg, TRAIN_RT, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} / {cfg.n_kv_heads} kv, head_dim "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"(padded {cfg.padded_vocab()}); {n / 1e9:.3f} B params, "
        f"{nbytes(*tree_leaves(params)) / 1e9:.2f} GB fp32, init "
        f"{time.time() - t0:.1f} s")
    return cfg, params


def gemm_flops(cfg, params, tokens: int) -> float:
    """The training step's GEMM work: 8 flops a token per weight of a
    matrix product (forward 2, the remat recompute 2, backward 4); the
    embedding (a gather) excluded unless tied (then it is the head's
    product, whose chunks are recomputed too), the norms and attention's
    own products too; a dense MoE's every expert (it runs them all for
    every token)."""
    n = sum(t.numel() for t in tree_leaves(params) if t.dim() >= 2)
    if not cfg.tie_embeddings:
        n -= params["embed"].numel()
    return 8.0 * n * tokens


def counted(batches, steps: int, per_step: list):
    """``steps`` batches of ``batches``; each fetch after the first (the
    loop fetches a step's batch after the last step is done and synced)
    records the launch counts of the step before and sets them to 0."""
    for i in range(steps):
        batch = next(batches)
        if i:
            per_step.append({k: v for k, v in engine.LAUNCHES.items() if v})
        engine.reset_launches()
        yield batch


def flash_layers(cfg, params, rt) -> dict:
    """The flash launches a training step makes with ``rt`` (remat):
    flash_fwd 2 an attention layer (forward and remat), flash_bwd_dkv and
    flash_bwd_dq 1 each; none without attention layers or with "xla"."""
    n = sum("attn" in pl for _, _, pl, _ in lm.iter_layers(params, cfg))
    if rt.attn_impl != "flash" or not n:
        return {}
    return {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}


def lm_train_path(cfg, params, rt=TRAIN_RT):
    """Path (c) (and (c2) with its ``rt``): ``train`` runs TRAIN_STEPS
    steps (loss_fn with ``rt``, autograd, apply_updates) with no
    checkpoint directory, on synthetic_lm_batches; counts read around each
    step, exactly flash_layers(): with attn_impl="flash" flash_fwd 2 an
    attention layer (forward and remat), flash_bwd_dkv and flash_bwd_dq 1
    each, nothing else. Returns (the counts of all steps, the final
    params, step ms, peak bytes)."""
    per_step = []
    batches = counted(synthetic_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                           seed=SEED, device="cuda"),
                      TRAIN_STEPS, per_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, res = train(lambda p, b: loss_fn(p, cfg, rt, b), params,
                        batches, TRAIN_OPT,
                        TrainLoopConfig(total_steps=TRAIN_STEPS))
    wall = time.time() - t0
    per_step.append({k: v for k, v in engine.LAUNCHES.items() if v})
    peak = torch.cuda.max_memory_allocated()
    want = flash_layers(cfg, params, rt)
    log(f"train {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ}: {res.final_step} "
        f"steps in {wall:.1f} s, losses {res.losses}, launches a step "
        f"{per_step}")
    check(res.final_step == TRAIN_STEPS and len(per_step) == TRAIN_STEPS,
          f"train ran {res.final_step} steps")
    check(all(np.isfinite(x) for x in res.losses), f"losses {res.losses}")
    check(all(c == want for c in per_step),
          f"each step launched {want}: {per_step}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = gemm_flops(cfg, params, tokens)
    ms = [t * 1e3 for t in res.step_times]
    dense_moe = (f"; the dense MoE path runs all {cfg.n_experts} experts "
                 f"for every token (top-{cfg.top_k} routing), and the bound "
                 "counts them all" if cfg.n_experts
                 and rt.moe_impl == "dense" else "")
    log(f"train step {cfg.name}: {float(np.median(ms)):.1f} ms median of "
        f"{len(ms)} (all {', '.join(f'{m:.1f}' for m in ms)}), "
        f"{tokens / np.median(ms) * 1e3:.0f} tokens/s; GEMM bound "
        f"{flops / PEAK_BF16 * 1e3:.1f} ms ({flops:.3e} flop at 989 "
        f"TFLOP/s bf16{dense_moe}); peak memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    counts = {k: sum(c.get(k, 0) for c in per_step) for k in want}
    return counts, params, float(np.median(ms)), peak


def train_step_busy(cfg, params, rt=TRAIN_RT):
    """The device's busy share of one training step (make_train_step with
    ``rt`` on a fresh optimizer state), under torch.profiler."""
    batch = next(synthetic_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED + 1, device="cuda"))
    opt_state = init_opt_state(params, TRAIN_OPT)
    step = make_train_step(lambda p, b: loss_fn(p, cfg, rt, b), TRAIN_OPT)
    wall, device = busy_share_fn(lambda: step(params, opt_state, batch))
    del opt_state
    return wall, device


@contextlib.contextmanager
def fp32_activations():
    """Run the LM in fp32: every module that casts to the activation dtype
    (nn.layers.ACT_DTYPE, bf16) casts to fp32 instead, so with fp32
    parameters (and an fp32 x given to a sublayer) every product, norm
    and softmax is fp32 (the reference of the training gates)."""
    mods = (layers_mod, lm, attention_mod, moe_mod, mlp_mod)
    original = [m.ACT_DTYPE for m in mods]
    for m in mods:
        m.ACT_DTYPE = torch.float32
    try:
        yield
    finally:
        for m, dtype in zip(mods, original):
            m.ACT_DTYPE = dtype


@contextlib.contextmanager
def fp32_o_delta():
    """flash_mha's backward with delta = rowsum(dO o) from an fp32 o (the
    plain forward on the q / k / v upcast) in place of the kernel's bf16
    o; the same two backward kernels."""
    original = fa.flash_bwd

    def bwd(q, k, v, o, lse, do, causal, bq, bk, group):
        o32, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal,
                                    bq, bk, group)
        delta = (do.float() * o32).sum(dim=-1)
        args = (q, k, v, do, lse, delta, causal, bq, bk, group)
        return (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))

    fa.flash_bwd = bwd
    try:
        yield
    finally:
        fa.flash_bwd = original


def sublayer_grads(pl, cfg, rt, x, positions, dy):
    """{name: grad} of one attention sublayer at x with cotangent dy: dx
    and the attention weights' grads."""
    x = x.detach().requires_grad_(True)
    att = {k: w.detach().requires_grad_(True) for k, w in pl["attn"].items()}
    y, _ = lm.attention_sublayer({**pl, "attn": att}, cfg, rt, x, positions)
    grads = torch.autograd.grad(y, (x, *att.values()), dy.to(y.dtype))
    return dict(zip(("dx", *(f"d{k}" for k in att)), grads))


def train_layer_check(cfg, params, tokens, rt=TRAIN_RT):
    """Every layer of one training forward, teacher-forced: on the xla
    path's hidden state and one cotangent dy (unit-normal bf16 from the
    seed), the attention sublayer's dx and its weights' grads (wq, wk, wv,
    wo) with attn_impl="flash" on the kernels, on their plain versions,
    with the kernels and an fp32-o delta, with "xla", and in fp32 (the
    reference); the layers walked as backbone walks them. Its launches are
    a check, not the main path. Returns {pair: {grad name: (largest |diff|
    / max |other| over the layers, its layer)}} for the pairs of
    TRAIN_PAIRS. ``rt``: the path's (attn_impl replaced)."""
    rts = {impl: dataclasses.replace(rt, attn_impl=impl)
           for impl in ("flash", "xla")}
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev).expand(b, s)
    gen = torch.Generator(device=dev.type).manual_seed(SEED + 9)
    dy = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                     dtype=torch.float32).to(torch.bfloat16)
    worst = {pair: {} for pair in TRAIN_PAIRS}
    with torch.no_grad():
        x = embed_lookup(params["embed"], tokens)
    for layer, (_, mlp, pl, _) in enumerate(lm.iter_layers(params, cfg)):
        g = {impl: sublayer_grads(pl, cfg, rt, x, positions, dy)
             for impl, rt in rts.items()}
        with fp32_o_delta():
            g["flash-fp32-o"] = sublayer_grads(pl, cfg, rts["flash"], x,
                                               positions, dy)
        with plain_flash():
            g["flash-plain"] = sublayer_grads(pl, cfg, rts["flash"], x,
                                              positions, dy)
            with fp32_o_delta():
                g["flash-plain-fp32-o"] = sublayer_grads(
                    pl, cfg, rts["flash"], x, positions, dy)
        with fp32_activations():
            g["fp32"] = sublayer_grads(pl, cfg, rts["xla"], x.float(),
                                       positions, dy)
        for pair in worst:
            a, ref = pair.split(" vs ")
            for k, want in g[ref].items():
                e = rel_err(g[a][k], want)
                if e >= worst[pair].get(k, (-1.0, -1))[0]:
                    worst[pair][k] = (e, layer)
        with torch.no_grad():
            x = lm.layer_apply(pl, cfg, rts["xla"], mlp, x, positions)[0]
    return worst


def full_depth_grads(cfg, params, batch):
    """The full-depth loss and gradient norm with attn_impl "flash" and
    "xla" on one batch (loss_fn, then autograd); and the flash run's
    kernel inputs of layers 0 and n_layers - 1 ({kernel: {call index:
    args}}: flash_fwd's forward calls come first, the backward walks the
    layers from the last)."""
    out = {}
    leaves = tree_leaves(params)
    keep = {0, cfg.n_layers - 1}
    for impl in ("flash", "xla"):
        rt = dataclasses.replace(TRAIN_RT, attn_impl=impl)
        for p in leaves:
            p.requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if impl == "flash":
                calls = {name: stack.enter_context(recording_flash(keep,
                                                                   name))
                         for name in ("flash_fwd", "flash_bwd_dkv")}
            loss = loss_fn(params, cfg, rt, batch)
            grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        out[impl] = (float(loss.detach()), float(global_norm(grads)))
        del grads, loss
    return out, calls


def check_train_calls(calls):
    """The three flash kernels on the training path's own inputs (phi3's
    q / k / v / dO / lse / delta of layers 0 and n_layers - 1, recorded
    from a full-depth flash backward) against their plain versions:
    flash_fwd's o within TOL_FLASH of max |plain| (a deep layer's |o|
    passes 4, where one bf16 ulp is 3.1e-2) and lse within TOL_LSE, the
    backward kernels within TOL_FLASH_BWD of max |plain|. Returns the
    largest relative errors by kernel."""
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for i, (q, k, v, causal, bq, bk, group) in sorted(
            calls["flash_fwd"].items()):
        o, lse = fa.flash_fwd(q, k, v, causal, bq, bk, group)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, bq, bk, group)
        torch.cuda.synchronize()
        err, e_lse = max_err(o.float(), o_p.float()), max_err(lse, lse_p)
        scale = float(o_p.float().abs().max())
        e = err / scale
        log(f"flash_fwd on the training path's call {i}: q "
            f"{tuple(q.shape)} {q.dtype} max |diff| o {err:.3e} at max "
            f"|plain| {scale:.3f}: {e:.3e} of it (tol {TOL_FLASH[q.dtype]}),"
            f" lse {e_lse:.3e} (tol {TOL_LSE})")
        check(np.isfinite(e) and e <= TOL_FLASH[q.dtype]
              and e_lse <= TOL_LSE, f"flash_fwd on training call {i}")
        worst["flash_fwd"] = max(worst["flash_fwd"], e)
    for i, args in sorted(calls["flash_bwd_dkv"].items()):
        q = args[0]
        rel, errs = bwd_errs(args)
        log(f"flash bwd on the training path's call {i}: q "
            f"{tuple(q.shape)} {q.dtype} group={args[-1]}: max |diff| / max "
            f"|plain| {rel:.3e} (tol {TOL_FLASH_BWD[q.dtype]}), max |diff| "
            f"{errs}")
        check(np.isfinite(rel) and rel <= TOL_FLASH_BWD[q.dtype],
              f"flash bwd on training call {i}")
        worst["flash_bwd"] = max(worst["flash_bwd"], rel)
    return worst


def train_pairs_gate(cfg, worst) -> None:
    """train_layer_check's readings (``worst``) printed, then every pair of
    TRAIN_PAIRS with a limit held to it; the pairs at None are logged."""
    for pair, errs in worst.items():
        tol = TRAIN_PAIRS[pair]
        log(f"train layers {cfg.name}, teacher-forced, {pair}: attention "
            "sublayer grads max |diff| / max |other| (layer) "
            + ", ".join(f"{k} {e:.3e} ({at})" for k, (e, at) in errs.items())
            + (f" (tol {tol})" if tol else " (logged)"))
    for pair, errs in worst.items():
        if TRAIN_PAIRS[pair] is not None:
            check(all(np.isfinite(e) and e <= TRAIN_PAIRS[pair]
                      for e, _ in errs.values()),
                  f"{cfg.name} train layers {pair}")


def train_gate(cfg, params):
    """Check (d): the teacher-forced sublayers' pairs within their
    TRAIN_PAIRS limits (train_pairs_gate); the flash kernels on a
    full-depth flash backward's own inputs against their plain versions;
    the full-depth loss and grad norm, flash against xla, within
    TOL_TRAIN_DRIFT. Each reading is printed before its limit applies."""
    batch = next(synthetic_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED + 2, device="cuda"))
    worst = train_layer_check(cfg, params, batch["tokens"])
    full, calls = full_depth_grads(cfg, params, batch)
    (lf, gf), (lx, gx) = full["flash"], full["xla"]
    drift = {"loss": abs(lf - lx) / abs(lx), "grad norm": abs(gf - gx) / gx}
    log(f"full depth, flash vs xla: loss {lf:.6f} / {lx:.6f}, grad norm "
        f"{gf:.6f} / {gx:.6f}; relative "
        + ", ".join(f"{k} {v:.3e}" for k, v in drift.items())
        + f" (tol {TOL_TRAIN_DRIFT})")
    train_pairs_gate(cfg, worst)
    check_train_calls(calls)
    check(all(np.isfinite(v) and v <= TOL_TRAIN_DRIFT
              for v in drift.values()), f"full depth drift {drift}")


def train_loop_path():
    """Path (e): the loop's mechanics on the card, on the reduced config:
    4 steps with a checkpoint every 2 into a temporary directory, the
    restored tensors equal to the trained ones, then a resume from step 4
    to 6. Returns the launch counts of both runs."""
    cfg = reduce_for_smoke(ARCHS[TRAIN_ARCH])
    seq = 64

    def fresh():
        return init_params(cfg, TRAIN_RT, torch.Generator(
            device="cuda").manual_seed(SEED), device="cuda")

    loss = lambda p, b: loss_fn(p, cfg, TRAIN_RT, b)
    engine.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoopConfig(total_steps=4, checkpoint_every=2,
                               checkpoint_dir=tmp)
        p4, res = train(loss, fresh(), synthetic_lm_batches(
            cfg, TRAIN_BATCH, seq, seed=SEED, device="cuda"), TRAIN_OPT,
            loop)
        mgr = CheckpointManager(tmp)
        check(res.final_step == 4 and res.resumed_from is None
              and mgr.all_steps() == [2, 4], f"loop saves {mgr.all_steps()}")
        saved = mgr.restore(4, {"params": fresh(),
                                "opt": init_opt_state(p4, TRAIN_OPT)})
        same = bitwise(saved["params"], p4)
        check(same and int(saved["opt"]["step"]) == 4,
              "restored tensors equal the trained ones")
        _, res2 = train(loss, fresh(), synthetic_lm_batches(
            cfg, TRAIN_BATCH, seq, seed=SEED + 1, device="cuda"), TRAIN_OPT,
            dataclasses.replace(loop, total_steps=6))
        check(res2.resumed_from == 4 and res2.final_step == 6
              and all(np.isfinite(x) for x in res.losses + res2.losses),
              f"resume: from {res2.resumed_from} to {res2.final_step}")
    counts = launched(f"{cfg.name} train 4 steps, checkpoint, resume to 6")
    log(f"train loop {cfg.name}: saved steps [2, 4], restored = trained "
        f"{same}, resumed_from {res2.resumed_from}, losses "
        f"{res.losses + res2.losses}")
    return counts


# ------------------------------------------ path (c2): SSM / MoE training ----

def ssm_moe_train_model(arch: str):
    """``arch`` at full width and depth, random fp32 weights drawn on the
    card from the seed; (cfg, params)."""
    cfg = ARCHS[arch]
    t0 = time.time()
    params = init_params(cfg, SSM_MOE_TRAIN_RT[arch], torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {n / 1e9:.3f} B params, "
        f"{nbytes(*tree_leaves(params)) / 1e9:.2f} GB fp32 (with grads and "
        f"AdamW's two fp32 moments {4 * nbytes(*tree_leaves(params)) / 1e9:.2f}"
        f" GB), init {time.time() - t0:.1f} s")
    return cfg, params


def mixer_grads(p, cfg, h, dy):
    """{name: grad} of one Mamba2 mixer (mamba_block, no norm or residual)
    at its input ``h`` with cotangent ``dy``: dh and every weight's."""
    h = h.detach().requires_grad_(True)
    w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
    y, _ = mamba2_mod.mamba_block(w, cfg, h)
    grads = torch.autograd.grad(y, (h, *w.values()), dy.to(y.dtype))
    return dict(zip(("dh", *(f"d{k}" for k in w)), grads))


def ssm_mixer_grad_gate(cfg, params, tokens) -> dict:
    """Gate (b) for Mamba2: layer 0's mixer at full width, teacher-forced on
    its normed input from ``tokens`` with one cotangent (unit-normal bf16
    from the seed): its input and weight grads on the card against the
    same call on the CPU in this process (the weights, input and cotangent
    copied), each of max |CPU grad|; printed, then held within
    TOL_SSM_GRAD. Returns {grad name: error}."""
    _, _, pl, _ = next(lm.iter_layers(params, cfg))
    with torch.no_grad():
        h = rms_norm(embed_lookup(params["embed"], tokens), pl["norm1"],
                     cfg.norm_eps)
    gen = torch.Generator(device=h.device.type).manual_seed(SEED + 11)
    dy = torch.randn(h.shape, generator=gen, device=h.device,
                     dtype=torch.float32).to(torch.bfloat16)
    t0 = time.time()
    card = mixer_grads(pl["ssm"], cfg, h, dy)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    cpu = mixer_grads({k: t.cpu() for k, t in pl["ssm"].items()}, cfg,
                      h.cpu(), dy.cpu())
    t_cpu = time.time() - t0
    errs = {k: rel_err(card[k].cpu(), cpu[k]) for k in cpu}
    log(f"train gate {cfg.name}: layer 0's mixer (h {tuple(h.shape)}, "
        f"{cfg.ssm_nheads} SSD heads, chunk {cfg.ssm_chunk}) teacher-forced, "
        f"card vs CPU, max |diff| / max |CPU|: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {TOL_SSM_GRAD}); {t_card:.2f} s on the card, {t_cpu:.1f} s "
        f"on the CPU ({torch.get_num_threads()} threads)")
    check(all(np.isfinite(e) and e <= TOL_SSM_GRAD for e in errs.values()),
          f"{cfg.name} mixer grads card vs CPU")
    return errs


def loss_and_grads(cfg, params, rt, batch):
    """One loss_fn and its gradients (autograd) with ``rt``: (the loss as a
    float, the grads in tree_leaves order)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, cfg, rt, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    loss = loss.detach()
    return float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss), grads


def leaf_names(tree, prefix="") -> list:
    """The leaves' paths in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(
            tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(
            v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def moe_sublayer_grads(cfg, params, rt, batch, mesh, cf_local) -> dict:
    """Every MoE sublayer teacher-forced on the dense path's own inputs
    (one no-grad forward of loss_fn) with one cotangent (unit-normal bf16
    from the seed): dx and the router's and experts' grads with "ep" at
    ample capacity on ``mesh`` against "dense". Returns {grad name: (the
    largest error of max |dense| over the layers, its layer)}."""
    inputs = []
    with torch.no_grad(), recording_moe({}, inputs):
        loss_fn(params, cfg, rt, batch)
    gen = torch.Generator(device=batch["tokens"].device.type).manual_seed(
        SEED + 12)
    worst = {}
    for layer, (p, h) in enumerate(inputs):
        dy = torch.randn(h.shape, generator=gen, device=h.device,
                         dtype=torch.float32).to(h.dtype)
        got = {}
        for impl in ("dense", "ep"):
            x = h.detach().requires_grad_(True)
            w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            with (sharding_ctx(mesh) if impl == "ep"
                  else contextlib.nullcontext()):
                y = moe_mod.moe_block(w, cfg, x, impl=impl, cf_send=1.0,
                                      cf_local=cf_local)
                got[impl] = dict(zip(("dx", *(f"d{k}" for k in w)),
                                     torch.autograd.grad(y, (x, *w.values()),
                                                         dy)))
        for k, want in got["dense"].items():
            e = rel_err(got["ep"][k], want)
            if e >= worst.get(k, (-1.0, -1))[0]:
                worst[k] = (e, layer)
    return worst


def ep_grad_check(cfg, params, rt, batch, card) -> None:
    """Check (d): granite's gradients with moe_impl="ep" at ample capacity
    (cf_send 1, cf_local E / top_k: no copy dropped), the parameters
    distributed by param_axes over the world-1 NCCL 1x1 host mesh, against
    the dense path unsharded (both with ``rt``'s attention and remat), on
    one batch, no optimizer state: (1) the loss within TOL_EP relative;
    (2) each MoE sublayer teacher-forced (moe_sublayer_grads), dx and every
    weight's grad within TOL_EP of max |dense|; (3) at full depth each
    leaf no farther from the fp32 gradient (the dense path with "xla"
    attention under fp32_activations) than the dense path is, give or take
    TOL_EP of max |fp32|: a check of gross faults (a leaf zero or of the
    wrong sign), not of drift, since dense itself sits up to ~0.19 from
    fp32 on the MoE leaves. Beside them it prints each leaf's full-depth
    ep vs dense reading. The group is torn down at the end."""
    t0 = time.time()
    dense_rt = dataclasses.replace(rt, moe_impl="dense")
    ep_rt = dataclasses.replace(rt, moe_impl="ep", moe_cf_send=1.0,
                                moe_cf_local=cfg.padded_experts(1)
                                / cfg.top_k)
    names = leaf_names(params)
    # on the card: the fp32 grads wait on the host, a leaf at a time back
    errs = lambda got, want: [rel_err(g, w.to(g.device))
                              for g, w in zip(got, want)]
    xla_rt = dataclasses.replace(dense_rt, attn_impl="xla")
    # the NCCL communicator first, while the card has room for its buffers
    # (the allocator's cache of the fp32 pass leaves NCCL none)
    mesh = make_host_mesh()
    try:
        torch.distributed.all_reduce(torch.zeros(1, device=params[
            "embed"].device), group=mesh.get_group("model"))
        with fp32_activations():
            # inside: remat recomputes each layer in the backward
            loss_32, grads = loss_and_grads(cfg, params, xla_rt, batch)
        grads_32 = [g.cpu() for g in grads]
        del grads
        loss_d, grads_d = loss_and_grads(cfg, params, dense_rt, batch)
        dense_32 = errs(grads_d, grads_32)
        torch.cuda.empty_cache()
        with sharding_ctx(mesh):
            dp = tp_place(params, lm.param_axes(cfg, ep_rt), mesh)
            loss_e, grads = loss_and_grads(cfg, dp, ep_rt, batch)
            del dp
            grads = [g.full_tensor() for g in grads]  # views at world 1
        ep_dense, ep_32 = errs(grads, grads_d), errs(grads, grads_32)
        del grads, grads_d, grads_32
        torch.cuda.empty_cache()
        sub = moe_sublayer_grads(cfg, params, dense_rt, batch, mesh,
                                 ep_rt.moe_cf_local)
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    loss_err = abs(loss_e - loss_d) / abs(loss_d)
    log(f"train {cfg.name} ep gradients on the world-1 NCCL 1x1 mesh "
        f"(cf_send {ep_rt.moe_cf_send}, cf_local {ep_rt.moe_cf_local}, "
        f"{rt.attn_impl} attention, remat) vs dense unsharded: loss "
        f"{loss_e:.6f} / {loss_d:.6f} (fp32 {loss_32:.6f}), relative "
        f"{loss_err:.3e} (tol {TOL_EP}); {time.time() - t0:.1f} s; on {card}")
    log(f"train {cfg.name} ep gradients, MoE sublayers teacher-forced, ep "
        f"vs dense, max |diff| / max |dense| (layer): "
        + ", ".join(f"{k} {e:.3e} ({at})" for k, (e, at) in sub.items())
        + f" (tol {TOL_EP})")
    log(f"train {cfg.name} full-depth gradients by leaf, max |diff| / max "
        f"|other|: ep vs dense; ep vs fp32 / dense vs fp32 (held: ep vs "
        f"fp32 <= dense vs fp32 + {TOL_EP}): "
        + "; ".join(f"{n} {a:.3e}; {c:.3e} / {d:.3e}"
                    for n, a, c, d in zip(names, ep_dense, ep_32, dense_32)))
    check(np.isfinite(loss_err) and loss_err <= TOL_EP,
          f"{cfg.name} ep loss within {TOL_EP} of dense")
    check(all(np.isfinite(e) and e <= TOL_EP for e, _ in sub.values()),
          f"{cfg.name} ep MoE sublayer grads within {TOL_EP} of dense")
    check(all(np.isfinite(a) and a <= b + TOL_EP
              for a, b in zip(ep_32, dense_32)),
          f"{cfg.name} ep gradients as near the fp32 ones as dense's")


def train_launcher(arch: str) -> None:
    """Check (c): python -m repro_torch.launch.train --arch ``arch`` --full
    --batch TRAIN_BATCH --seq TRAIN_SEQ --steps TRAIN_STEPS (granite with
    --attn-impl flash), a process of its own on the card, exits 0 with
    finite losses."""
    cmd = ["--arch", arch, "--full", "--batch", str(TRAIN_BATCH), "--seq",
           str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS)]
    if SSM_MOE_TRAIN_RT[arch].attn_impl == "flash":
        cmd += ["--attn-impl", "flash"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *cmd], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    losses = re.search(r"loss first\d+=(\S+) last\d+=(\S+)", run.stdout)
    finite = bool(losses) and all(np.isfinite(float(v))
                                  for v in losses.groups())
    log(f"launch.train {' '.join(cmd)}: rc {run.returncode} in "
        f"{time.time() - t0:.1f} s: {run.stdout.strip()} "
        f"{run.stderr.strip()[-2000:]}")
    check(run.returncode == 0 and finite,
          f"launch.train --arch {arch} --full exits 0 with finite losses")


def ssm_moe_train_phase(card) -> dict:
    """Path (c2): for each of SSM_MOE_ARCHS at full width and depth (fp32
    weights from the seed, after the earlier phases' models are freed):
    (b) the gate on step 1's gradients (granite: train_layer_check and
    train_pairs_gate, as phi3's; mamba2: ssm_mixer_grad_gate); (d)
    granite's ep gradients (ep_grad_check); (a) lm_train_path with the
    arch's SSM_MOE_TRAIN_RT, counts read around each
    step (granite: flash_fwd 64, flash_bwd_dkv 32, flash_bwd_dq 32;
    mamba2: none), ms a step, tokens/s, the GEMM bound and the peak memory
    beside memory_allocated at the path's start, and the busy share of one
    more step (train_step_busy); then (c) both launchers. Returns the flash
    launches of the (a) runs."""
    total = {}
    for arch in SSM_MOE_ARCHS:
        t0 = time.time()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated()
        cfg, params = ssm_moe_train_model(arch)
        rt = SSM_MOE_TRAIN_RT[arch]
        batch = next(synthetic_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                          seed=SEED, device="cuda"))
        if rt.attn_impl == "flash":
            train_pairs_gate(cfg, train_layer_check(cfg, params,
                                                    batch["tokens"], rt))
        else:
            ssm_mixer_grad_gate(cfg, params, batch["tokens"])
        if cfg.n_experts:
            ep_grad_check(cfg, params, rt, batch, card)
        del batch
        counts, params, step_ms, peak = lm_train_path(cfg, params, rt)
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        wall, device = train_step_busy(cfg, params, rt)
        share = (f"{device / wall:.3f}" if device > 0
                 else "not measured (the profiler saw no device time)")
        log(f"busy {cfg.name} train step B={TRAIN_BATCH} S={TRAIN_SEQ}: "
            f"{wall:.2f} ms wall under the profiler, {device:.2f} ms of "
            f"kernels, busy share {share}")
        log(f"path (c2) {cfg.name}: memory_allocated at the path's start "
            f"{start / 1e9:.2f} GB (the earlier phases' tensors), peak "
            f"{peak / 1e9:.2f} GB in the train loop (weights, grads, AdamW "
            f"moments, activations), {step_ms:.1f} ms a step; on {card}; "
            f"{time.time() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()
    t0 = time.time()
    for arch in SSM_MOE_ARCHS:
        train_launcher(arch)
    log(f"path (c2) launchers: {time.time() - t0:.1f} s")
    return total


# ------------------------------------------------------ the serve phase ----
# The DGNN serve layer (serve/engine.py) on the card: BoosterSession.serve,
# serve_multi (the round scheduler) with promotion under both guards, the
# express lane, four fault plans, the continuous scheduler
# (serve/scheduler.py) and the DGNN launcher, on the raw BC-Alpha COO
# snapshots. Each result is held against the offline run of the same
# snapshots, padded into one bucket, through run_plan with force_ref on the
# card (outputs on each snapshot's real rows, and the final state).

SERVE_CHUNK = 8
# the fixed bucket that covers the stream; the plan's default one
SERVE_FIXED = dict(n_pad=N_PAD, e_pad=4096, k_max=64)
SERVE_BUCKET = (N_PAD, 4096, 64)
# serve_multi: eight GCRN-M2 tenants, a window of the stream each
SERVE_WINDOWS = ((0, 17), (17, 34), (34, 51), (51, 68), (68, 85), (85, 102),
                 (102, 119), (119, 137))
SERVE_PROMOTE = 4.0
# the express lane: four static tenants beside four recurrent ones; the
# fault plans: four tenants
SERVE_SMALL = 4
SERVE_FAMILIES = (GCRN_M2, EVOLVEGCN, STACKED)


def bc_alpha_coo():
    """The raw BC-Alpha COO snapshots and the global feature table."""
    tg, feat = generate_temporal_graph(BC_ALPHA, feat_dim=GCRN_M2.in_dim)
    return slice_snapshots(tg, 1.0), feat, tg.n_global_nodes


def serve_offline(cfg, params, n_global, snaps, feat):
    """The offline reference: ``snaps`` padded into SERVE_BUCKET through
    run_plan with force_ref on the card. Returns (outputs (T, n_pad, out)
    on the host, final state); no kernel launches."""
    model = build_model(cfg, n_global=n_global)
    pads = [pad_snapshot(renumber_and_normalize(s), feat, *SERVE_BUCKET)
            for s in snaps]
    engine.reset_launches()
    state, outs = run_plan(model, params, model.init_state(params,
                                                           mode="v3"),
                           stack_time(pads).to("cuda"),
                           api.plan(cfg, level="v3"), force_ref=True)
    torch.cuda.synchronize()
    check(not any(engine.LAUNCHES.values()),
          f"{cfg.name} offline force_ref reached a kernel")
    return outs.cpu().numpy(), state


def serve_errs(outs, state, snaps, ref) -> tuple:
    """Largest |served - offline| over each output's real rows, and over
    the final state (0 for a stateless tenant)."""
    ref_outs, ref_state = ref
    check(len(outs) == len(snaps), "served one output a snapshot")
    rows = [renumber_and_normalize(s).n_nodes for s in snaps]
    check(all(np.isfinite(o).all() for o in outs), "served outputs finite")
    out_err = max(float(np.abs(o[:n] - r[:n]).max())
                  for o, r, n in zip(outs, ref_outs, rows))
    return out_err, (max_err(state, ref_state) if state else 0.0)


def serve_session(cfg, params, n_global, feat, **plan_kw):
    plan = api.plan(cfg, level="v3", stream_chunk=SERVE_CHUNK, **plan_kw)
    return api.BoosterSession(cfg, plan, n_global=n_global, feat_table=feat,
                              params=params, device="cuda")


def serve_counts(label, stats, want: dict) -> dict:
    """The launch counts of the serve path just run: nonzero ones equal
    ``want`` exactly (every served chunk went through its engine), and no
    launch degraded to the plain path."""
    counts = {k: v for k, v in engine.LAUNCHES.items() if v}
    log(f"serve {label}: launches {counts}, stats.launches "
        f"{stats.launches} {stats.launches_by_family}, degraded "
        f"{stats.degraded_launches}")
    check(stats.degraded_launches == 0, f"serve {label} degraded a launch")
    check(counts == want, f"serve {label} launches {counts} != {want}")
    return counts


def serve_want(cfg, name, launches) -> dict:
    """The launch counts a serve path of ``cfg`` must show: its engine
    ``name`` at ``launches``, one a served chunk, and as many of every
    other kernel its v3 level launches a call (EvolveGCN-O's edge
    terms)."""
    family = api.family_for(cfg)
    return {k: launches for k in expected_kernels(cfg, "v3", None)
            - {ENGINE[family]} | {name}}


def serve_timing(label, stats, card) -> None:
    served = len(stats.per_snapshot_ms)
    log(f"serve {label}: {stats.mean_latency_ms:.4f} ms/snapshot staging + "
        f"launch, host preprocessing "
        f"{float(np.mean(stats.preprocess_ms)):.4f} "
        f"ms/snapshot, {served / (stats.total_ms / 1e3):.1f} snapshots/s "
        f"({served} in {stats.total_ms:.1f} ms; live "
        f"{stats.live_snapshots}, padded {stats.padded_snapshots}, "
        f"promoted {stats.promoted_chunks}, launches {stats.launches}); "
        f"{card}")


def serve_check(label, errs, tol) -> None:
    log(f"serve {label} vs offline force_ref: outputs {errs[0]:.3e}, "
        f"final state {errs[1]:.3e} (tol {tol})")
    check(all(np.isfinite(e) and e <= tol for e in errs),
          f"serve {label} vs offline {errs}")


def serve_windows(snaps, wins) -> dict:
    return {f"t{i}": snaps[a:b] for i, (a, b) in enumerate(wins)}


def serve_streams(params, n_global, snaps, feat, buckets, card) -> dict:
    """Path 1: BoosterSession.serve, one stream of all 137 snapshots, for
    GCRN-M2, EvolveGCN-O and the stacked GCN -> GRU at v3, chunks of 8: a
    fixed bucket, then the bucket set."""
    launches = {}
    for cfg in SERVE_FAMILIES:
        p = params[cfg.name]
        ref = serve_offline(cfg, p, n_global, snaps, feat)
        name = ENGINE[api.family_for(cfg)]
        for how, kw in (("fixed 640", SERVE_FIXED),
                        ("buckets", dict(buckets=buckets))):
            label = f"{cfg.name} serve {how}"
            sess = serve_session(cfg, p, n_global, feat, **kw)
            engine.reset_launches()
            outs, stats = sess.serve(snaps)
            torch.cuda.synchronize()
            counts = serve_counts(label, stats,
                                  serve_want(cfg, name, stats.launches))
            serve_timing(label, stats, card)
            serve_check(label, serve_errs(outs, sess.state, snaps, ref),
                        TOL_STREAM)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    return launches


def serve_multi_paths(params, n_global, snaps, feat, buckets, card) -> dict:
    """Path 2: serve_multi, the round scheduler: eight GCRN-M2 tenants from
    fresh state, a window each, with the bucket set and promote_buckets
    4.0, under the static guard and then the measured one (its per-bucket
    times printed beside bucket_cost). The caller's state tensors must be
    untouched by the serve (the reference checkpoint's premise)."""
    cfg, p = GCRN_M2, params[GCRN_M2.name]
    streams = serve_windows(snaps, SERVE_WINDOWS)
    refs = {sid: serve_offline(cfg, p, n_global, s, feat)
            for sid, s in streams.items()}
    launches = {}
    for guard in ("static", "measured"):
        label = f"{cfg.name} serve_multi x{len(streams)} {guard} guard"
        sess = serve_session(cfg, p, n_global, feat, buckets=buckets,
                             promote_buckets=SERVE_PROMOTE,
                             promotion_guard=guard)
        srv = SnapshotServer(session=sess)
        states = {sid: sess.model.init_state(p, mode="v3")
                  for sid in streams}
        held = {sid: {k: v.clone() for k, v in st.items()}
                for sid, st in states.items()}
        ins = dict(states)
        engine.reset_launches()
        states, outs, stats = srv.run_multi(p, states, streams)
        torch.cuda.synchronize()
        calib = 2 * len(buckets) if guard == "measured" else 0
        counts = serve_counts(label, stats, {
            ENGINE["gcrn"]: stats.launches + calib})
        serve_timing(label, stats, card)
        check(all(bitwise(ins[sid], held[sid]) for sid in streams),
              f"{label} changed a caller's state tensor")
        check(not stats.tenant_errors, f"{label} tenant errors")
        errs = [serve_errs(outs[sid], states[sid], s, refs[sid])
                for sid, s in streams.items()]
        serve_check(label, (max(e[0] for e in errs), max(e[1] for e in errs)),
                    TOL_STREAM)
        if guard == "measured":
            check(stats.calibration_fallback is None,
                  f"{label} calibration fell back")
            ms = srv._bucket_ms
            log(f"serve measured guard, per-bucket step ms (calibration: an "
                "empty chunk of 8 a bucket) beside bucket_cost: " + "; ".join(
                    f"{b}: {ms[b]:.4f} ms, cost {bucket_cost(b)}"
                    for b in buckets)
                + f"; measured ratios "
                + ", ".join(f"{ms[b2] / ms[b1]:.3f}" for b1, b2
                            in zip(buckets, buckets[1:]))
                + ", static " + ", ".join(
                    f"{bucket_cost(b2) / bucket_cost(b1):.3f}"
                    for b1, b2 in zip(buckets, buckets[1:])))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def serve_express_path(params, n_global, snaps, feat, card) -> dict:
    """Path 3: the express lane: a static GCN session as ``express=``,
    four express tenants beside four recurrent GCRN-M2 ones (fixed
    bucket)."""
    cfg, p = GCRN_M2, params[GCRN_M2.name]
    xcfg, xp = STATIC_GCN, params[STATIC_GCN.name]
    wins = SERVE_WINDOWS
    streams = serve_windows(snaps, wins[:SERVE_SMALL])
    xstreams = {f"x{i}": snaps[a:b]
                for i, (a, b) in enumerate(wins[SERVE_SMALL:])}
    sess = serve_session(cfg, p, n_global, feat, **SERVE_FIXED)
    xsess = api.BoosterSession(xcfg, api.plan(xcfg, level="v3",
                                              **SERVE_FIXED),
                               n_global=n_global, feat_table=feat,
                               params=xp, device="cuda")
    srv = SnapshotServer(session=sess, express=xsess)
    refs = {sid: serve_offline(cfg, p, n_global, s, feat)
            for sid, s in streams.items()}
    xrefs = {sid: serve_offline(xcfg, xp, n_global, s, feat)
             for sid, s in xstreams.items()}
    states = {sid: sess.model.init_state(p, mode="v3") for sid in streams}
    label = (f"express lane: {len(xstreams)} {xcfg.name} beside "
             f"{len(streams)} {cfg.name}")
    engine.reset_launches()
    states, outs, stats = srv.run_multi(p, states, streams,
                                        express_streams=xstreams,
                                        express_params=xp)
    torch.cuda.synchronize()
    check(stats.express_launches > 0, f"{label}: no express launch")
    check(stats.launches_by_family.get("static_gcn") == stats.express_launches,
          f"{label}: {stats.launches_by_family}")
    counts = serve_counts(label, stats, {
        ENGINE["gcrn"]: stats.launches_by_family["gcrn"],
        "static_engine": stats.express_launches})
    serve_timing(label, stats, card)
    check(not stats.tenant_errors, f"{label} tenant errors")
    errs = [serve_errs(outs[sid], states[sid], s, refs[sid])
            for sid, s in streams.items()]
    serve_check(f"{label}, recurrent",
                (max(e[0] for e in errs), max(e[1] for e in errs)),
                TOL_STREAM)
    xerrs = [serve_errs(outs[sid], {}, s, xrefs[sid])
             for sid, s in xstreams.items()]
    serve_check(f"{label}, express", (max(e[0] for e in xerrs), 0.0),
                TOL_KERNEL)
    return counts


def serve_faults(params, n_global, snaps, feat) -> dict:
    """Path 4: four fault plans under supervision="isolate", four tenants:
    a persistent launch fault on one tenant (quarantined, the others equal
    offline), a transient one with max_retries=1 (retried, rolled back,
    equal offline), a kernel-scoped fault with degrade=True (served by the
    oracle rung, counted), and a mid-commit ``evolve`` fault on
    EvolveGCN-O (rolled back; bit for bit the fault-free serve)."""
    streams = serve_windows(snaps, SERVE_WINDOWS[:SERVE_SMALL])
    launches = {}
    refs = {}
    for cfg in (GCRN_M2, EVOLVEGCN):
        refs[cfg.name] = {sid: serve_offline(cfg, params[cfg.name], n_global,
                                             s, feat)
                          for sid, s in streams.items()}

    def serve(label, cfg, specs, **kw):
        p = params[cfg.name]
        fp = FaultPlan(specs=tuple(FaultSpec(**s) for s in specs),
                       seed=SEED) if specs else None
        sess = serve_session(cfg, p, n_global, feat, supervision="isolate",
                             retry_backoff_ms=1.0, fault_plan=fp,
                             **SERVE_FIXED, **kw)
        states = {sid: sess.model.init_state(p, mode="v3")
                  for sid in streams}
        engine.reset_launches()
        with deterministic():
            res = SnapshotServer(session=sess).run_multi(p, states, streams)
        torch.cuda.synchronize()
        counts = {k: v for k, v in engine.LAUNCHES.items() if v}
        stats = res[2]
        log(f"serve fault plan {label}: launches {counts}, stats.launches "
            f"{stats.launches}, retries {stats.retries}, rollbacks "
            f"{stats.rollbacks}, degraded {stats.degraded_launches}, "
            f"quarantined {sorted(stats.tenant_errors)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return res

    def offline_errs(cfg, res, sids):
        states, outs, _ = res
        errs = [serve_errs(outs[sid], states[sid], streams[sid],
                           refs[cfg.name][sid]) for sid in sids]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    sids = sorted(streams)
    # (a) a persistent launch fault on t1
    res = serve("persistent launch fault on t1", GCRN_M2,
                [dict(site="launch", tenant="t1", index=0, count=99)])
    err = res[2].tenants["t1"].error
    check(isinstance(err, InjectedFault)
          and res[2].tenants["t1"].failed_site == "launch"
          and set(res[2].tenant_errors) == {"t1"},
          f"persistent fault: t1 not quarantined alone ({err!r})")
    serve_check("persistent launch fault, the others",
                offline_errs(GCRN_M2, res, [s for s in sids if s != "t1"]),
                TOL_STREAM)
    # (b) a transient launch fault, retried once
    res = serve("transient launch fault", GCRN_M2,
                [dict(site="launch", index=0, count=1)], max_retries=1)
    check(not res[2].tenant_errors and res[2].retries >= 1
          and res[2].rollbacks >= 1, "transient fault: retried, rolled back")
    serve_check("transient launch fault", offline_errs(GCRN_M2, res, sids),
                TOL_STREAM)
    # (c) a kernel-scoped fault: the ladder's oracle rung serves
    res = serve("kernel-scoped fault, degrade", GCRN_M2,
                [dict(site="launch", scope="kernel", index=0, count=999)],
                degrade=True)
    check(not res[2].tenant_errors
          and res[2].degraded_launches >= len(sids)
          and engine.LAUNCHES[ENGINE["gcrn"]] == 0,
          "kernel-scoped fault: served by the oracle rung, counted, no "
          "kernel launch reached")
    serve_check("kernel-scoped fault, oracle rung",
                offline_errs(GCRN_M2, res, sids), TOL_STREAM)
    # (d) a mid-commit evolve fault on EvolveGCN-O: rolled back, exact
    clean = serve("EvolveGCN-O fault-free", EVOLVEGCN, [])
    res = serve("mid-commit evolve fault on t1", EVOLVEGCN,
                [dict(site="evolve", tenant="t1", index=0, count=1)],
                max_retries=1)
    check(not res[2].tenant_errors and res[2].rollbacks >= 1,
          "mid-commit fault: rolled back, no tenant lost")
    same = all(bitwise(res[0][sid], clean[0][sid])
               and all(np.array_equal(a, b) for a, b
                       in zip(res[1][sid], clean[1][sid])) for sid in sids)
    log(f"serve mid-commit evolve fault: bit for bit the fault-free serve "
        f"{same}")
    check(same, "mid-commit fault: not exact")
    serve_check("mid-commit evolve fault",
                offline_errs(EVOLVEGCN, res, sids), TOL_STREAM)
    return launches


# Path 6, the continuous scheduler (serve/scheduler.py): the fields of its
# plans (a pool of 2 tenants' pages, backlogs served 2 snapshots a tick)
SERVE_CONTINUOUS = dict(scheduler="continuous", state_pool_pages=2,
                        prefill_chunk=2)
# (c): this many GCRN-M2 tenants on an hbm_paged plan with one nominal page
SERVE_PAGED_TENANTS = 12
# (g): the skewed workload of benchmarks/kernel_bench.py's scheduler rows:
# one backlog tenant with the whole stream at t = 0 beside incremental
# tenants whose snapshots arrive one every SKEW_INTERVAL_MS
SKEW_INC = 3
SKEW_INC_SNAPS = 24
SKEW_INTERVAL_MS = 20.0
SKEW_PLAN = dict(prefill_chunk=2, state_pool_pages=4, queue_depth=64)
SKEW_PACED = 2


@contextlib.contextmanager
def pool_probe():
    """Instruments the state pool for the serve runs inside it: the host ms
    of each eviction and recovery (the copies synchronize), and the device
    memory from the first tick to the flush (the peak reset as the first
    tick acquires its working set, read as the flush begins, before it
    brings every spilled tenant back)."""
    from repro_torch.serve.state_pool import TenantStatePool
    from repro_torch.serve.supervision import TenantSupervisor

    rec = {"evict_ms": [], "recover_ms": [], "peak": None, "resident": None,
           "capacity": None, "ticking": False}
    saved = {(TenantSupervisor, "evict_to_host"): "evict_ms",
             (TenantSupervisor, "recover_from_host"): "recover_ms",
             (TenantStatePool, "acquire"): None,
             (TenantStatePool, "flush"): None}
    orig = {key: getattr(*key) for key in saved}

    def timed(fn, into):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec[into].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def acquire(self, sids):
        if not rec["ticking"]:
            rec["ticking"] = True
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return orig[(TenantStatePool, "acquire")](self, sids)

    def flush(self):
        torch.cuda.synchronize()
        rec.update(peak=torch.cuda.max_memory_allocated(),
                   resident=len(self.resident), capacity=self.capacity)
        return orig[(TenantStatePool, "flush")](self)

    for (cls, name), into in saved.items():
        setattr(cls, name, timed(orig[(cls, name)], into) if into
                else {"acquire": acquire, "flush": flush}[name])
    try:
        yield rec
    finally:
        for (cls, name), fn in orig.items():
            setattr(cls, name, fn)


def launch_working_set(srv, params, streams, B) -> int:
    """Device bytes one staged launch of B tenants' first chunks takes
    beyond their states (the stacked chunk and states, the engine's state
    clones, the outputs and packs): its peak over what was allocated
    before it."""
    sids = sorted(streams)[:B]
    group = [(sid, [pad_snapshot(renumber_and_normalize(s), srv.feat_table,
                                 *SERVE_BUCKET)
                    for s in streams[sid][:srv.stream_chunk]], SERVE_BUCKET)
             for sid in sids]
    states = {sid: srv.model.init_state(params, mode="v3") for sid in sids}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    staged = srv._stage_group(params, states, group)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del staged, states
    return peak


def served_equal(a, b, sids) -> bool:
    """Two serve_multi results: every tenant's outputs and final state bit
    for bit."""
    (st_a, outs_a, _), (st_b, outs_b, _) = a, b
    return all(bitwise(st_a[sid], st_b[sid])
               and len(outs_a[sid]) == len(outs_b[sid])
               and all(np.array_equal(x, y)
                       for x, y in zip(outs_a[sid], outs_b[sid]))
               for sid in sids)


def continuous_stats(label, stats, probe=None) -> None:
    ev = probe["evict_ms"] if probe else []
    rc = probe["recover_ms"] if probe else []
    log(f"serve {label}: ticks {stats.ticks}, prefill chunks "
        f"{stats.prefill_chunks}, evictions {stats.evictions}, recoveries "
        f"{stats.recoveries}"
        + (f"; an eviction {float(np.mean(ev)):.4f} ms (median "
           f"{float(np.median(ev)):.4f}, {len(ev)}), a recovery "
           f"{float(np.mean(rc)):.4f} ms (median {float(np.median(rc)):.4f},"
           f" {len(rc)}; the flush's included), {sum(ev) + sum(rc):.2f} ms "
           f"of paging in {stats.total_ms:.1f} ms" if ev else ""))


def serve_multi_run(label, cfg, params, n_global, feat, streams, card,
                    want=None, probe=False, **plan_kw) -> tuple:
    """One serve_multi on a fresh server and fresh states, deterministic
    algorithms on; its launch counts held to ``want`` (by default
    ``serve_want``: the family's engine at stats.launches). With ``probe``
    the pool is instrumented (pool_probe) and the device memory read
    around the run. Returns (result, counts, probe record, memory
    record)."""
    sess = serve_session(cfg, params, n_global, feat, **plan_kw)
    srv = SnapshotServer(session=sess)
    mem = {}
    if probe:
        B = pow2_target(min(len(streams), srv.state_pool_pages
                            * (HBM_PAGE_FACTOR if sess.plan.state_residency
                               == "hbm_paged" else 1)))
        mem["B"] = B
        mem["working_set"] = launch_working_set(srv, params, streams, B)
    torch.cuda.synchronize()
    mem["before"] = torch.cuda.memory_allocated()
    states = {sid: sess.model.init_state(params, mode="v3")
              for sid in streams}
    mem["state_bytes"] = sum(t.nbytes for t in flat(states[min(streams)]))
    engine.reset_launches()
    with deterministic(), (pool_probe() if probe
                           else contextlib.nullcontext({})) as rec:
        res = srv.run_multi(params, states, streams)
    torch.cuda.synchronize()
    del states
    stats = res[2]
    if want is None:
        family = api.family_for(cfg)
        want = serve_want(cfg, ENGINE[family] if sess.plan.state_residency
                          != "hbm_paged" else PAGED[family], stats.launches)
    counts = serve_counts(label, stats, want)
    serve_timing(label, stats, card)
    if sess.plan.scheduler == "continuous":
        continuous_stats(label, stats, rec if probe else None)
    return res, counts, rec, mem


def memory_check(label, rec, mem, res) -> None:
    """(d): the peak device memory from the first tick to the flush stays
    within (the pool's capacity + the largest launch's B) x a tenant's
    state bytes + one launch's working set over what was allocated before
    the tenants' states; and once the run's states are dropped the
    allocation falls back to that."""
    S, B, W = mem["state_bytes"], mem["B"], mem["working_set"]
    cap = rec["capacity"]
    used = rec["peak"] - mem["before"]
    bound = (cap + B) * S + W
    log(f"serve {label} device memory: {S / 2**20:.3f} MB of state a tenant, "
        f"pool capacity {cap} ({rec['resident']} resident as the flush "
        f"begins), largest launch B {B}, a launch's working set "
        f"{W / 2**20:.3f} MB; peak from the first tick to the flush "
        f"{used / 2**20:.3f} MB over the states' base (bound (capacity + B)"
        f" x state + working set = {bound / 2**20:.3f} MB; all "
        f"{len(res[0])} tenants' states {len(res[0]) * S / 2**20:.3f} MB)")
    check(used <= bound, f"serve {label}: peak {used} B over the bound {bound}")
    res[0].clear()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated() - mem["before"]
    log(f"serve {label}: {after} B allocated over the base once the run's "
        "states are dropped (the server's session, and its own state, went "
        "with them)")
    check(after <= 2**20, f"serve {label}: {after} B left after the states "
          "were dropped")


def serve_continuous(params, n_global, snaps, feat, buckets, card) -> dict:
    """Path 6: serve_multi on the continuous scheduler. (a) GCRN-M2,
    EvolveGCN-O and the stacked GCN -> GRU, the eight windows of path 2 in
    the fixed bucket, a pool of 2 pages and prefill chunks of 2: bit for bit
    the round scheduler on the same plan, within 1e-3 of offline, tenants
    evicted and recovered; (d) GCRN-M2's device memory in that run; (b)
    DEFAULT_BUCKETS with promotion under the static guard; (c) twelve
    tenants on an hbm_paged plan (td 16) with one nominal page (capacity
    8): bit for bit its round run, its memory as (d); (e) the express lane
    beside four tenants; (f) two fault plans; (g) the skewed workload."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    streams = serve_windows(snaps, SERVE_WINDOWS)
    base = None
    for cfg in SERVE_FAMILIES:
        p = params[cfg.name]
        refs = {sid: serve_offline(cfg, p, n_global, s, feat)
                for sid, s in streams.items()}
        runs = {}
        for sched, kw in (("rounds", {}), ("continuous", SERVE_CONTINUOUS)):
            label = (f"{cfg.name} serve_multi x{len(streams)} {sched}"
                     + (" (2 pages, prefill 2)" if kw else ""))
            probe = bool(kw) and cfg is GCRN_M2
            res, counts, rec, mem = serve_multi_run(
                label, cfg, p, n_global, feat, streams, card, probe=probe,
                **SERVE_FIXED, **kw)
            add(counts)
            check(not res[2].tenant_errors, f"{label} tenant errors")
            errs = [serve_errs(res[1][sid], res[0][sid], s, refs[sid])
                    for sid, s in streams.items()]
            serve_check(label, (max(e[0] for e in errs),
                                max(e[1] for e in errs)), TOL_STREAM)
            runs[sched] = (res, rec, mem)
        res_c = runs["continuous"][0]
        same = served_equal(runs["rounds"][0], res_c, streams)
        log(f"serve {cfg.name} continuous vs rounds, outputs and final "
            f"states bit for bit: {same}")
        check(same, f"{cfg.name}: continuous != rounds")
        check(res_c[2].evictions > 0
              and res_c[2].recoveries == res_c[2].evictions,
              f"{cfg.name} continuous: evictions {res_c[2].evictions}, "
              f"recoveries {res_c[2].recoveries}")
        if cfg is GCRN_M2:
            # host copies: the memory check drops the run's states
            base = {sid: (ops.to_device(res_c[0][sid], "cpu"), res_c[1][sid])
                    for sid in streams}
            memory_check(f"{cfg.name} continuous", *runs["continuous"][1:],
                         res_c)
        del runs

    # (b) buckets and promotion under the static guard
    cfg, p = GCRN_M2, params[GCRN_M2.name]
    refs = {sid: serve_offline(cfg, p, n_global, s, feat)
            for sid, s in streams.items()}
    label = (f"{cfg.name} serve_multi x{len(streams)} continuous, buckets, "
             "promote 4.0 static guard")
    res, counts, _, _ = serve_multi_run(
        label, cfg, p, n_global, feat, streams, card, buckets=buckets,
        promote_buckets=SERVE_PROMOTE, **SERVE_CONTINUOUS)
    add(counts)
    check(not res[2].tenant_errors, f"{label} tenant errors")
    errs = [serve_errs(res[1][sid], res[0][sid], s, refs[sid])
            for sid, s in streams.items()]
    serve_check(label, (max(e[0] for e in errs), max(e[1] for e in errs)),
                TOL_STREAM)

    # (c) the paged plan: 12 tenants, 1 nominal page = capacity 8
    cuts = np.linspace(0, len(snaps), SERVE_PAGED_TENANTS + 1).astype(int)
    pstreams = serve_windows(snaps, tuple(zip(cuts[:-1], cuts[1:])))
    prefs = {sid: serve_offline(cfg, p, n_global, s, feat)
             for sid, s in pstreams.items()}
    runs = {}
    for sched, kw in (("rounds", {}),
                      ("continuous", dict(scheduler="continuous",
                                          state_pool_pages=1))):
        label = (f"{cfg.name} hbm_paged d2 serve_multi "
                 f"x{SERVE_PAGED_TENANTS} {sched}"
                 + (" (1 page: capacity 8)" if kw else ""))
        res, counts, rec, mem = serve_multi_run(
            label, cfg, p, n_global, feat, pstreams, card, probe=bool(kw),
            **SERVE_FIXED, **paged_plan(2), **kw)
        add(counts)
        check(not res[2].tenant_errors, f"{label} tenant errors")
        errs = [serve_errs(res[1][sid], res[0][sid], s, prefs[sid])
                for sid, s in pstreams.items()]
        serve_check(label, (max(e[0] for e in errs), max(e[1] for e in errs)),
                    TOL_STREAM)
        runs[sched] = (res, rec, mem)
    res_c = runs["continuous"][0]
    same = served_equal(runs["rounds"][0], res_c, pstreams)
    over = SERVE_PAGED_TENANTS - HBM_PAGE_FACTOR
    log(f"serve {cfg.name} hbm_paged continuous vs rounds bit for bit: {same};"
        f" evictions {res_c[2].evictions} (>= {over}: {SERVE_PAGED_TENANTS} "
        f"tenants over a capacity of {HBM_PAGE_FACTOR})")
    check(same, f"{cfg.name} hbm_paged: continuous != rounds")
    check(res_c[2].evictions >= over
          and res_c[2].recoveries == res_c[2].evictions,
          f"{cfg.name} hbm_paged continuous: evictions")
    memory_check(f"{cfg.name} hbm_paged continuous", *runs["continuous"][1:],
                 res_c)
    del runs, res_c

    # (e) the express lane under ticks
    xcfg, xp = STATIC_GCN, params[STATIC_GCN.name]
    wins = SERVE_WINDOWS
    estreams = serve_windows(snaps, wins[:SERVE_SMALL])
    xstreams = {f"x{i}": snaps[a:b]
                for i, (a, b) in enumerate(wins[SERVE_SMALL:])}
    sess = serve_session(cfg, p, n_global, feat, **SERVE_FIXED,
                         scheduler="continuous", state_pool_pages=2)
    xsess = api.BoosterSession(xcfg, api.plan(xcfg, level="v3",
                                              **SERVE_FIXED),
                               n_global=n_global, feat_table=feat,
                               params=xp, device="cuda")
    xrefs = {sid: serve_offline(xcfg, xp, n_global, s, feat)
             for sid, s in xstreams.items()}
    states = {sid: sess.model.init_state(p, mode="v3") for sid in estreams}
    label = (f"express lane, continuous: {len(xstreams)} {xcfg.name} beside "
             f"{len(estreams)} {cfg.name}")
    engine.reset_launches()
    states, outs, stats = SnapshotServer(session=sess, express=xsess) \
        .run_multi(p, states, estreams, express_streams=xstreams,
                   express_params=xp)
    torch.cuda.synchronize()
    check(stats.express_launches > 0
          and stats.launches_by_family.get("static_gcn")
          == stats.express_launches, f"{label}: {stats.launches_by_family}")
    add(serve_counts(label, stats, {
        ENGINE["gcrn"]: stats.launches_by_family["gcrn"],
        "static_engine": stats.express_launches}))
    serve_timing(label, stats, card)
    continuous_stats(label, stats)
    check(not stats.tenant_errors, f"{label} tenant errors")
    errs = [serve_errs(outs[sid], states[sid], s, refs[sid])
            for sid, s in estreams.items()]
    serve_check(f"{label}, recurrent", (max(e[0] for e in errs),
                                        max(e[1] for e in errs)), TOL_STREAM)
    xerrs = [serve_errs(outs[sid], {}, s, xrefs[sid])
             for sid, s in xstreams.items()]
    serve_check(f"{label}, express", (max(e[0] for e in xerrs), 0.0),
                TOL_KERNEL)
    del states, outs

    # (f) faults under ticks: survivors bit for bit the fault-free run (a)
    fsids = sorted(estreams)
    for what, specs, kw in (
            ("persistent launch fault on t1",
             [dict(site="launch", tenant="t1", index=0, count=99)], {}),
            ("transient launch fault",
             [dict(site="launch", index=0, count=1)], dict(max_retries=1))):
        label = f"{cfg.name} continuous, {what}"
        fp = FaultPlan(specs=tuple(FaultSpec(**s) for s in specs), seed=SEED)
        sess = serve_session(cfg, p, n_global, feat, supervision="isolate",
                             retry_backoff_ms=1.0, fault_plan=fp,
                             **SERVE_FIXED, **SERVE_CONTINUOUS, **kw)
        states = {sid: sess.model.init_state(p, mode="v3")
                  for sid in estreams}
        engine.reset_launches()
        with deterministic():
            states, outs, stats = SnapshotServer(session=sess).run_multi(
                p, states, estreams)
        torch.cuda.synchronize()
        counts = {k: v for k, v in engine.LAUNCHES.items() if v}
        add(counts)
        log(f"serve {label}: launches {counts}, stats.launches "
            f"{stats.launches}, retries {stats.retries}, rollbacks "
            f"{stats.rollbacks}, quarantined {sorted(stats.tenant_errors)}")
        if kw:
            check(not stats.tenant_errors and stats.retries >= 1
                  and stats.rollbacks >= 1, f"{label}: retried, rolled back")
            survivors = fsids
        else:
            err = stats.tenants["t1"].error
            check(isinstance(err, InjectedFault)
                  and set(stats.tenant_errors) == {"t1"},
                  f"{label}: t1 not quarantined alone ({err!r})")
            survivors = [s for s in fsids if s != "t1"]
        same = all(bitwise(ops.to_device(states[sid], "cpu"), base[sid][0])
                   and len(outs[sid]) == len(base[sid][1])
                   and all(np.array_equal(x, y)
                           for x, y in zip(outs[sid], base[sid][1]))
                   for sid in survivors)
        log(f"serve {label}: {survivors} bit for bit the fault-free "
            f"continuous run {same}")
        check(same, f"{label}: survivors differ from the fault-free run")
        del states, outs
    del base
    add(serve_skewed(params, n_global, snaps, feat, card))
    return launches


def serve_skewed(params, n_global, snaps, feat, card) -> dict:
    """(g) benchmarks/kernel_bench.py's skewed workload on BC-Alpha
    GCRN-M2, fixed bucket, chunks of 8: one backlog tenant with all the
    snapshots at t = 0, SKEW_INC incremental tenants whose SKEW_INC_SNAPS
    snapshots arrive one every SKEW_INTERVAL_MS. Each scheduler: one
    unpaced warm run, then SKEW_PACED paced runs; the incremental tenants'
    sojourn (commit ms minus the arrival clock) p50 / p99, snapshots/s,
    ticks, prefill chunks and launches. No limit is set; the two
    schedulers' outputs must agree bit for bit."""
    cfg, p = GCRN_M2, params[GCRN_M2.name]
    inc = [f"inc{i}" for i in range(SKEW_INC)]
    tenant = {"backlog": snaps}
    for i, sid in enumerate(inc):
        tenant[sid] = snaps[i * SKEW_INC_SNAPS:(i + 1) * SKEW_INC_SNAPS]

    def paced(sid, arrivals):
        for i, s in enumerate(tenant[sid]):
            time.sleep(SKEW_INTERVAL_MS / 1e3)
            arrivals[(sid, i)] = time.perf_counter()
            yield s

    launches, served = {}, {}
    for sched, kw in (("rounds", dict(queue_depth=SKEW_PLAN["queue_depth"])),
                      ("continuous", dict(scheduler="continuous",
                                          **SKEW_PLAN))):
        sess = serve_session(cfg, p, n_global, feat, **SERVE_FIXED, **kw)
        srv = SnapshotServer(session=sess)
        for run in range(1 + SKEW_PACED):
            arrivals: dict = {}
            streams = {sid: (paced(sid, arrivals) if run and sid in inc
                             else list(s)) for sid, s in tenant.items()}
            states = {sid: sess.model.init_state(p, mode="v3")
                      for sid in streams}
            engine.reset_launches()
            with deterministic():
                res = srv.run_multi(p, states, streams)
            torch.cuda.synchronize()
            stats = res[2]
            for k, v in engine.LAUNCHES.items():
                if v:
                    launches[k] = launches.get(k, 0) + v
            check(not stats.tenant_errors
                  and all(len(res[1][sid]) == len(tenant[sid])
                          for sid in tenant), f"skewed {sched}: served all")
            check(engine.LAUNCHES[ENGINE["gcrn"]] == stats.launches,
                  f"skewed {sched}: launches")
            n = sum(len(v) for v in stats.commit_ms.values())
            line = (f"serve skewed {sched} {'paced' if run else 'warm'}: "
                    f"{n / (stats.total_ms / 1e3):.1f} snapshots/s ({n} in "
                    f"{stats.total_ms:.1f} ms), ticks {stats.ticks}, prefill "
                    f"chunks {stats.prefill_chunks}, launches "
                    f"{stats.launches}, evictions {stats.evictions}")
            if run:
                soj = [stats.commit_ms[sid][i]
                       - (arrivals[(sid, i)] - srv._t0_run) * 1e3
                       for sid in inc for i in range(len(tenant[sid]))]
                line += (f"; incremental sojourn p50 "
                         f"{float(np.percentile(soj, 50)):.2f} ms, p99 "
                         f"{float(np.percentile(soj, 99)):.2f} ms")
            log(line + f"; {card}")
            served[sched] = res
        if sched == "continuous":
            check(stats.prefill_chunks > 0, "skewed continuous: no prefill")
    same = served_equal(served["rounds"], served["continuous"], tenant)
    log(f"serve skewed: continuous vs rounds bit for bit {same}")
    check(same, "skewed: continuous != rounds")
    return launches


def serve_launcher() -> None:
    """Path 5: python -m repro_torch.launch.serve --dgnn gcrn-m2, a
    process of its own, exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--dgnn", "gcrn-m2"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    log(f"launch.serve --dgnn gcrn-m2: rc {run.returncode}: "
        f"{run.stdout.strip()} {run.stderr.strip()[-2000:]}")
    check(run.returncode == 0, "launch.serve --dgnn gcrn-m2 exits 0")


def serve_phase(params, card) -> dict:
    """The serve phase; returns the kernels' launch counts of its serve
    paths (the offline force-ref references launch nothing)."""
    snaps, feat, n_global = bc_alpha_coo()
    buckets = DEFAULT_BUCKETS
    for s in snaps:
        ls = renumber_and_normalize(s)
        choose_bucket(ls.n_nodes, ls.src.shape[0], max_in_degree(ls),
                      buckets)  # the bucket set covers every snapshot
    launches = {}
    for part in (serve_streams(params, n_global, snaps, feat, buckets, card),
                 serve_multi_paths(params, n_global, snaps, feat, buckets,
                                   card),
                 serve_express_path(params, n_global, snaps, feat, card),
                 serve_faults(params, n_global, snaps, feat),
                 serve_continuous(params, n_global, snaps, feat, buckets,
                                  card)):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    serve_launcher()
    return launches


# ------------------------------------------------ trainer, SSM / MoE ----
# The DGNN trainer and the Mamba2 / MoE LM paths launch no hand-written
# kernel (plain torch, as the JAX package's are plain XLA): every launch
# count reads 0 around them.

def load_example(name: str):
    """examples/torch/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trainer_grads(ex, device):
    """Step 1's loss and gradient leaves of the trainer on ``device``."""
    tg, ft, snaps, model, params, v1 = ex.setup(device, seed=SEED)
    batch = next(ex.build_batches(tg, ft, snaps, 1, device=device))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ex.make_loss_fn(model, v1, tg.n_global_nodes)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def trainer_phase(card) -> None:
    """The DGNN trainer at the example's full width (BC-Alpha, n_pad 640,
    e_pad 4096, k_max 64, a window of 6, 256 pairs): TRAINER_STEPS steps
    on the card with a checkpoint every TRAINER_CKPT_EVERY into a
    temporary directory, the restored tensors equal to the trained ones,
    a resume to TRAINER_RESUME_TO; finite losses and no kernel launched;
    the first TRAINER_CPU_STEPS losses and step 1's gradients against the
    same run on the CPU; ms a step."""
    ex = load_example("train_evolvegcn")
    t0 = time.time()
    tg, ft, snaps, model, params, v1 = ex.setup("cuda", seed=SEED)
    loss = ex.make_loss_fn(model, v1, tg.n_global_nodes)
    opt = ex.optimizer(TRAINER_STEPS)
    engine.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoopConfig(total_steps=TRAINER_STEPS,
                               checkpoint_every=TRAINER_CKPT_EVERY,
                               checkpoint_dir=tmp)
        trained, res = train(loss, params, ex.build_batches(
            tg, ft, snaps, TRAINER_STEPS, device="cuda"), opt, loop)
        counts = launched(f"trainer {TRAINER_STEPS} steps")
        check(not counts, f"the trainer launched no kernel: {counts}")
        mgr = CheckpointManager(tmp)
        steps = list(range(TRAINER_CKPT_EVERY, TRAINER_STEPS + 1,
                           TRAINER_CKPT_EVERY))
        check(res.final_step == TRAINER_STEPS and res.resumed_from is None
              and mgr.all_steps() == steps,
              f"trainer saves {mgr.all_steps()}")
        check(all(np.isfinite(x) for x in res.losses)
              and len(res.losses) == TRAINER_STEPS, "finite trainer losses")
        saved = mgr.restore(TRAINER_STEPS, {
            "params": ex.setup("cuda", seed=SEED + 1)[4],
            "opt": init_opt_state(trained, opt)})
        same = bitwise(saved["params"], trained)
        check(same and int(saved["opt"]["step"]) == TRAINER_STEPS,
              "trainer: restored tensors equal the trained ones")
        engine.reset_launches()
        _, res2 = train(loss, ex.setup("cuda", seed=SEED)[4],
                        ex.build_batches(tg, ft, snaps, TRAINER_RESUME_TO,
                                         device="cuda"),
                        ex.optimizer(TRAINER_RESUME_TO),
                        dataclasses.replace(loop,
                                            total_steps=TRAINER_RESUME_TO))
        check(not launched("trainer resume"), "the resume launched nothing")
        check(res2.resumed_from == TRAINER_STEPS
              and res2.final_step == TRAINER_RESUME_TO
              and all(np.isfinite(x) for x in res2.losses),
              f"trainer resume: from {res2.resumed_from} to "
              f"{res2.final_step}")
    # the same run on the CPU (same seed and batches, TF32 off on the card)
    ctg, cft, csnaps, cmodel, cparams, cv1 = ex.setup("cpu", seed=SEED)
    _, cres = train(ex.make_loss_fn(cmodel, cv1, ctg.n_global_nodes),
                    cparams, ex.build_batches(ctg, cft, csnaps,
                                              TRAINER_STEPS, device="cpu"),
                    opt, TrainLoopConfig(total_steps=TRAINER_CPU_STEPS,
                                         checkpoint_dir=None),
                    device="cpu")
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(res.losses[:TRAINER_CPU_STEPS], cres.losses))
    gl, gg = trainer_grads(ex, "cuda")
    cl, cg = trainer_grads(ex, "cpu")
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(gg, cg))
    ms = float(np.mean(res.step_times[1:])) * 1e3
    log(f"trainer EvolveGCN-O v1 BC-Alpha (n_pad 640, e_pad 4096, k_max 64,"
        f" window 6, 256 pairs): {TRAINER_STEPS} steps, {ms:.3f} ms a step "
        f"(mean of steps 2-{TRAINER_STEPS}; all "
        f"{', '.join(f'{t * 1e3:.3f}' for t in res.step_times)}) on "
        f"{card}; losses {res.losses[0]:.6f} -> {res.losses[-1]:.6f}; "
        f"saved {steps}, restored = trained {same}, resumed "
        f"{res2.resumed_from} -> {res2.final_step}; card vs CPU: first "
        f"{TRAINER_CPU_STEPS} losses {loss_err:.3e} relative, step 1 "
        f"loss {abs(gl - cl) / abs(cl):.3e}, grads {grad_err:.3e} of max "
        f"|grad| (tol {TOL_TRAINER}); {time.time() - t0:.1f} s")
    check(np.isfinite(loss_err) and loss_err <= TOL_TRAINER,
          "trainer losses card vs CPU")
    check(np.isfinite(grad_err) and grad_err <= TOL_TRAINER,
          "trainer step 1 grads card vs CPU")


def ssm_moe_path(arch: str, card) -> None:
    """``arch`` at full width and depth, bf16 weights drawn on the card
    from the seed: a prefill of LM_BATCH x LM_SEQ tokens (finite logits,
    ms median of 3 after a warm call), then generate (LM_PROMPT-token
    prompts, LM_NEW new tokens, a cache of LM_SKV: ms a decode step), and
    the decode logits after the last prompt token against a prefill of
    the prompts: within TOL_LOGITS, or with Mamba2 layers (their decode
    and prefill round at other places, compounding through depth) within
    TOL_DRIFT and each mixer teacher-forced within TOL_LOGITS
    (``ssm_mixer_gate``), the argmax equal; no kernel launched; the peak
    memory over what earlier phases hold."""
    cfg = ARCHS[arch]
    t0 = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, SSM_MOE_RT, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    weights = torch.cuda.memory_allocated() - base
    tokens = lm_tokens(LM_BATCH, LM_SEQ, SEED + 1, cfg.vocab_size)
    engine.reset_launches()
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = prefill_step(params, cfg, SSM_MOE_RT, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    check(logits.shape == (LM_BATCH, 1, cfg.padded_vocab())
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} finite")
    prompt = lm_tokens(LM_BATCH, LM_PROMPT, SEED + 2, cfg.vocab_size)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = generate(params, cfg, SSM_MOE_RT, prompt, LM_NEW, LM_SKV)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t1) * 1e3
    n_steps = LM_PROMPT + LM_NEW - 1
    check(out.shape == (LM_BATCH, LM_NEW) and out.dtype == torch.int32
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"{arch} generate tokens {tuple(out.shape)}")
    caches = init_caches(cfg, SSM_MOE_RT, LM_BATCH, LM_SKV)
    for i in range(LM_PROMPT):
        dec, caches = decode_step(params, cfg, SSM_MOE_RT,
                                  prompt[:, i:i + 1], caches)
    ref = prefill_step(params, cfg, SSM_MOE_RT, {"tokens": prompt})
    mixer_err = ssm_mixer_gate(params, cfg, prompt)
    counts = launched(f"{arch} prefill, generate, decode")
    check(not counts, f"{arch} launched no kernel: {counts}")
    err = logits_err(dec, ref, cfg.vocab_size)
    # Mamba2's decode (an fp32 recurrence) and prefill (the chunked scan's
    # bf16 scores) round at other places, which compounds through depth:
    # the teacher-forced mixers are its gate, the logits TOL_DRIFT
    tol = TOL_LOGITS if mixer_err is None else TOL_DRIFT
    same_argmax = torch.equal(dec[:, -1, :cfg.vocab_size].argmax(-1),
                              ref[:, -1, :cfg.vocab_size].argmax(-1))
    log(f"{arch}: decode after the prompt vs its prefill {err:.3e} of max "
        f"|logits| (tol {tol}), argmax equal {same_argmax}; teacher-forced "
        f"Mamba2 mixers, decode from the prefix's state vs prefill, max "
        f"{mixer_err} (tol {TOL_LOGITS})")
    check(bool(torch.isfinite(dec).all()) and np.isfinite(err)
          and err <= tol and same_argmax, f"{arch} decode vs prefill")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"{arch} (bf16, {cfg.n_layers} layers, d_model {cfg.d_model}): "
        f"prefill B={LM_BATCH} S={LM_SEQ} {float(np.median(ms[1:])):.2f} ms "
        f"median of 3 (first {ms[0]:.2f}); generate {total:.1f} ms for "
        f"{n_steps} decode steps, {total / n_steps:.2f} ms a step "
        f"(B={LM_BATCH}); weights {weights / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB over what the earlier phases hold; tokens "
        f"{out.tolist()}; on {card}; {time.time() - t0:.1f} s")
    del params, caches, logits, ref, dec
    torch.cuda.empty_cache()


def ssm_mixer_gate(params, cfg, prompt):
    """Each Mamba2 layer's mixer on the prefill path's own hidden state
    (teacher-forced): the last prompt position decoded from the state of
    the prefix's prefill, against the whole prompt's prefill, relative to
    max |output|; the largest over the layers (None: no Mamba2 layer),
    checked within TOL_LOGITS."""
    errs = []
    with torch.inference_mode():
        x = embed_lookup(params["embed"], prompt)
        s = prompt.shape[1]
        positions = torch.arange(s, device=x.device).expand(x.shape[0], s)
        for _, mlp, pl, _ in lm.iter_layers(params, cfg):
            if "ssm" in pl:
                h = rms_norm(x, pl["norm1"], cfg.norm_eps)
                full, _ = mamba2_mod.mamba_block(pl["ssm"], cfg, h)
                _, state = mamba2_mod.mamba_block(pl["ssm"], cfg, h[:, :-1])
                one, _ = mamba2_mod.mamba_block(pl["ssm"], cfg, h[:, -1:],
                                            state=state)
                errs.append(rel_err(one[:, 0], full[:, -1]))
            x = lm.layer_apply(pl, cfg, SSM_MOE_RT, mlp, x, positions)[0]
    if not errs:
        return None
    worst = max(errs)
    check(np.isfinite(worst) and worst <= TOL_LOGITS,
          f"{cfg.name} teacher-forced Mamba2 mixers {worst:.3e}")
    return worst


@contextlib.contextmanager
def recording_moe(stats: dict, inputs=None):
    """``moe_mod.moe_block`` (as models/lm.py calls it) with ``stats``
    collecting each call's dropped copies, and each call's input appended
    to ``inputs`` when given."""
    inner = moe_mod.moe_block

    def wrapped(p, cfg, x, **kw):
        if inputs is not None:
            inputs.append((p, x))
        return inner(p, cfg, x, stats=stats, **kw)

    moe_mod.moe_block = wrapped
    try:
        yield
    finally:
        moe_mod.moe_block = inner


def sharded_dgnn_check(params, streams, n_global, card) -> None:
    """The sharded DGNN launch: with SHARD_N cards, each family's v3
    run_batched over the first SHARD_B windows with DeviceSpec(SHARD_N)
    bit for bit the unsharded one; with fewer, the plan refused."""
    n = torch.cuda.device_count()
    log(f"sharding: torch.cuda.device_count() = {n} on {card}")
    if n < SHARD_N:
        log(f"sharding: the sharded DGNN launch (DeviceSpec({SHARD_N})) "
            f"needs {SHARD_N} cards; this host has {n}, so plan() must "
            "refuse it")
        msg = expect_raises(lambda: api.plan(
            GCRN_M2, level="v3", batch=SHARD_B,
            device=DeviceSpec(n_devices=SHARD_N)), ValueError,
            f"this host has {n}")
        log(f"sharding: plan refused: {msg}")
        return
    for cfg in CONFIGS:
        path_stream, path_np = streams[cfg.name]
        wins = windows_for(cfg, "v3")[:SHARD_B]
        runs = []
        for spec in (DeviceSpec(n_devices=SHARD_N), DeviceSpec()):
            sess = api.BoosterSession(
                cfg, api.plan(cfg, level="v3", batch=SHARD_B, device=spec),
                n_global=n_global, params=params[cfg.name], device="cuda")
            with deterministic():
                runs.append(sess.run_batched([window(path_np, a, b)
                                              for a, b in wins]))
        same = bitwise(runs[0], runs[1])
        log(f"sharding: {cfg.name} v3 run_batched B={SHARD_B} over "
            f"{SHARD_N} cards bit for bit the unsharded launch: {same}")
        check(same, f"{cfg.name} sharded launch bit for bit")


def world1_collectives(card) -> None:
    """compressed_all_reduce / bf16_all_reduce on the world-1 NCCL group
    against their local quantise / dequantise and cast; the pipeline at
    one stage against reference_stack."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(COLLECTIVE_NUMEL, generator=gen, device="cuda")
    y, r = compression.compressed_all_reduce(x, torch.zeros_like(x))
    q, scale, err = compression._quant(x)
    want = compression._dequant(q, scale, x.shape)
    same_c = torch.equal(y, want) and torch.equal(r, err)
    b = compression.bf16_all_reduce(x)
    same_b = torch.equal(b, x.to(torch.bfloat16).float())
    res = torch.zeros_like(x)
    ms_c = cuda_ms(lambda: compression.compressed_all_reduce(x, res), 5)
    ms_q = cuda_ms(lambda: compression._dequant(*compression._quant(x)[:2],
                                                x.shape), 5)
    ms_b = cuda_ms(lambda: compression.bf16_all_reduce(x), 5)
    log(f"sharding: world-1 {torch.distributed.get_backend()} group, "
        f"{x.numel() * 4 / 2 ** 20:.0f} MiB fp32: compressed_all_reduce "
        f"bit for bit its local quantise / dequantise {same_c} ({ms_c:.3f} "
        f"ms against {ms_q:.3f} local), bf16_all_reduce bit for bit the "
        f"cast {same_b} ({ms_b:.3f} ms); on {card}")
    check(same_c and same_b, "world-1 collectives equal their local "
          "versions")
    stage = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    sp = {"w": torch.randn((1, PIPE_D, PIPE_D), generator=gen,
                           device="cuda") / PIPE_D ** 0.5,
          "b": torch.randn((1, PIPE_D), generator=gen, device="cuda") * 0.1}
    xs = torch.randn((PIPE_MICRO, PIPE_ROWS, PIPE_D), generator=gen,
                     device="cuda")
    block = lambda p, v: torch.tanh(v @ p["w"] + p["b"])
    got = pipeline(block, stage, 1, PIPE_MICRO)(sp, xs)
    err = max_err(got, reference_stack(block, sp, xs))
    log(f"sharding: pipeline, 1 stage x {PIPE_MICRO} micro-batches of "
        f"({PIPE_ROWS}, {PIPE_D}), against reference_stack: {err:.3e} "
        f"(tol {TOL_PIPE})")
    check(np.isfinite(err) and err <= TOL_PIPE, "pipeline at one stage")


def ep_prefill(params, cfg, rt, tokens, stats=None):
    """Prefill ms (median of 3 after a warm call) and peak bytes over the
    allocation before it, and the last logits."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for i in range(4):
        st = {} if stats is not None and i == 0 else None
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if st is not None:
            with recording_moe(st):
                logits = prefill_step(params, cfg, rt, {"tokens": tokens})
            stats.update(st)
        else:
            logits = prefill_step(params, cfg, rt, {"tokens": tokens})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return (float(np.median(ms[1:])), ms,
            torch.cuda.max_memory_allocated() - base, logits)


def ep_moe_path(mesh, card) -> None:
    """granite-moe-3b-a800m at full width and depth (bf16 weights from the
    seed) with moe_impl="ep" on the host mesh: at ample capacity (no copy
    can be dropped) each MoE sublayer, teacher-forced on the dense
    prefill's own inputs, within TOL_EP of the dense path and the logits'
    argmax equal to the dense prefill's; then at the default capacity
    factors prefill ms, peak memory and dropped copies a layer beside the
    dense path's figures; no kernel launched."""
    cfg = ARCHS[EP_ARCH]
    t0 = time.time()
    torch.cuda.empty_cache()
    dense_rt = RuntimeConfig(param_dtype="bf16", moe_impl="dense")
    ep_rt = dataclasses.replace(dense_rt, moe_impl="ep")
    e_pad = cfg.padded_experts(1)
    ample = dataclasses.replace(ep_rt, moe_cf_send=1.0,
                                moe_cf_local=e_pad / cfg.top_k)
    params = init_params(cfg, dense_rt, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    tokens = lm_tokens(LM_BATCH, LM_SEQ, SEED + 1, cfg.vocab_size)
    engine.reset_launches()
    with sharding_ctx(mesh):
        # the dense prefill's MoE inputs, then each sublayer both ways
        inputs = []
        with torch.no_grad(), recording_moe({}, inputs):
            dense_logits = prefill_step(params, cfg, dense_rt,
                                        {"tokens": tokens})
        errs, drops, loads = [], [], []
        with torch.no_grad():
            for p, h in inputs:
                st = {}
                ep = moe_mod.moe_block(p, cfg, h, impl="ep",
                                       cf_send=ample.moe_cf_send,
                                       cf_local=ample.moe_cf_local, stats=st)
                errs.append(rel_err(ep, moe_mod.moe_block(p, cfg, h,
                                                          impl="dense")))
                drops.append(int(sum(st["dropped"])))
                # the routing's skew: the busiest expert's token copies
                _, eidx = moe_mod._route(p["router"],
                                         h.reshape(-1, cfg.d_model), cfg)
                loads.append(int(torch.bincount(eidx.reshape(-1)).max()))
            # the MoE sublayer alone on the first and the last layer's
            # input, each way, at the default capacity factors
            alone = {}
            for i in (0, len(inputs) - 1):
                p, h = inputs[i]
                alone[i] = [cuda_ms(lambda impl=impl: moe_mod.moe_block(
                    p, cfg, h, impl=impl, cf_send=ep_rt.moe_cf_send,
                    cf_local=ep_rt.moe_cf_local), 5)
                    for impl in ("ep", "dense")]
        log(f"sharding: {EP_ARCH} routing, the busiest expert's copies by "
            f"layer {loads} (of {LM_BATCH * LM_SEQ} tokens; the default "
            f"cap_local keeps 1.25 x the mean); the MoE sublayer alone, "
            f"ep / dense ms (CUDA events, mean of 5): "
            + ", ".join(f"layer {i} {a:.3f} / {b:.3f}"
                        for i, (a, b) in alone.items()))
        del inputs
        with torch.no_grad():
            ample_logits = prefill_step(params, cfg, ample,
                                        {"tokens": tokens})
        same_argmax = torch.equal(
            ample_logits[:, -1, :cfg.vocab_size].argmax(-1),
            dense_logits[:, -1, :cfg.vocab_size].argmax(-1))
        ample_err = logits_err(ample_logits, dense_logits, cfg.vocab_size)
        log(f"sharding: {EP_ARCH} ep at ample capacity (cf_send "
            f"{ample.moe_cf_send}, cf_local {ample.moe_cf_local}): dropped "
            f"copies {sum(drops)}; MoE sublayers teacher-forced vs dense, "
            f"max {max(errs):.3e} of max |dense| (tol {TOL_EP}; by layer "
            f"{', '.join(f'{e:.2e}' for e in errs)}); logits vs the dense "
            f"prefill {ample_err:.3e}, "
            f"argmax equal {same_argmax}")
        check(sum(drops) == 0 and np.isfinite(max(errs))
              and max(errs) <= TOL_EP and same_argmax,
              f"{EP_ARCH} ep at ample capacity")
        del ample_logits, dense_logits
        torch.cuda.empty_cache()
        with torch.no_grad():
            stats = {}
            ep_ms, ep_all, ep_peak, ep_logits = ep_prefill(
                params, cfg, ep_rt, tokens, stats)
            d_ms, d_all, d_peak, d_logits = ep_prefill(params, cfg,
                                                       dense_rt, tokens)
    counts = launched(f"{EP_ARCH} ep and dense prefills")
    check(not counts, f"{EP_ARCH} ep launched no kernel: {counts}")
    dropped = [int(d) for d in stats["dropped"]]
    check(len(dropped) == cfg.n_layers and bool(
        torch.isfinite(ep_logits).all()), f"{EP_ARCH} ep prefill")
    t = LM_BATCH * LM_SEQ
    cap_send = max(8, int(np.ceil(t * cfg.top_k * ep_rt.moe_cf_send)))
    cap_local = max(8, int(np.ceil(cap_send * ep_rt.moe_cf_local / e_pad)))
    log(f"sharding: {EP_ARCH} (bf16, {cfg.n_layers} layers, {cfg.n_experts} "
        f"experts top-{cfg.top_k}) prefill B={LM_BATCH} S={LM_SEQ} on the "
        f"1x1 mesh: ep (cf {ep_rt.moe_cf_send} / {ep_rt.moe_cf_local}: "
        f"cap_send {cap_send}, cap_local {cap_local}) {ep_ms:.2f} ms median "
        f"of 3 (all {', '.join(f'{m:.2f}' for m in ep_all)}), peak "
        f"{ep_peak / 1e9:.2f} GB, dropped copies by layer {dropped} (of "
        f"{t * cfg.top_k} a layer); dense {d_ms:.2f} ms (all "
        f"{', '.join(f'{m:.2f}' for m in d_all)}), peak {d_peak / 1e9:.2f} "
        f"GB; logits ep vs dense "
        f"{logits_err(ep_logits, d_logits, cfg.vocab_size):.3e}; on {card}; "
        f"{time.time() - t0:.1f} s")
    del params, ep_logits, d_logits
    torch.cuda.empty_cache()


def restore_on_mesh(mesh) -> None:
    """A checkpoint saved, then restored onto the host mesh with its
    logical axes: DTensors whose local shards are the saved tensors bit
    for bit; the synthetic tokens under the mesh the same as without."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    tree = {"w_gate": torch.randn((8, 256, 128), generator=gen,
                                  device="cuda"),
            "embed": torch.randn((512, 256), generator=gen,
                                 device="cuda").to(torch.bfloat16),
            "steps": [torch.arange(10, device="cuda", dtype=torch.int32)]}
    axes = {"w_gate": Axes("experts", "embed_fsdp", None),
            "embed": Axes("vocab", "embed"), "steps": [Axes(None)]}
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(1, tree, blocking=True)
        got = mgr.restore(1, tree, axes=axes, mesh=mesh)
    pairs = [(got["w_gate"], tree["w_gate"]), (got["embed"], tree["embed"]),
             (got["steps"][0], tree["steps"][0])]
    same = all(torch.equal(g.to_local(), w) for g, w in pairs)
    cfg = reduce_for_smoke(ARCHS[EP_ARCH])
    plain = next(synthetic_lm_batches(cfg, 2, 16, seed=3, device="cuda"))
    sharded = next(synthetic_lm_batches(cfg, 2, 16, seed=3, device="cuda",
                                        mesh=mesh))
    same_tok = all(torch.equal(sharded[k].to_local(), plain[k])
                   for k in plain)
    log(f"sharding: elastic restore onto the 1x1 mesh bit for bit {same} "
        f"(placements {[str(g.placements) for g, _ in pairs]}); tokens "
        f"under the mesh {same_tok}")
    check(same and same_tok, "elastic restore / tokens on the mesh")


def sharding_phase(params, streams, n_global, card) -> None:
    """Device sharding: the card count and the sharded DGNN launch; a
    world-1 NCCL group from make_host_mesh() (its collectives, the
    pipeline); granite-moe-3b-a800m's expert-parallel prefill on that
    mesh; elastic restore. The group is torn down at the end."""
    t0 = time.time()
    sharded_dgnn_check(params, streams, n_global, card)
    mesh = make_host_mesh()
    check(torch.distributed.get_backend() == "nccl"
          and torch.distributed.get_world_size() == 1,
          "the host mesh is a world-1 NCCL group")
    try:
        world1_collectives(card)
        ep_moe_path(mesh, card)
        restore_on_mesh(mesh)
    finally:
        torch.distributed.destroy_process_group()
    log(f"phase 4 (sharding): {time.time() - t0:.1f} s")


# --------------------------------------------- tensor parallelism (TP) ----

#: the dry runs of the roofline phase: (label, arguments of the module)
TP_DRYRUNS = (
    ("qwen2.5-14b prefill, 1 chip", ["repro_torch.launch.dryrun", "--arch",
     "qwen2.5-14b", "--shape", "prefill_32k", "--mesh", "1x1", "--batch",
     str(LM_BATCH), "--seq", str(LM_SEQ), "--overrides",
     json.dumps({"rt": {"attn_impl": "flash", "param_dtype": "bf16"}})]),
    ("phi3-mini-3.8b train step, 1 chip", ["repro_torch.launch.dryrun",
     "--arch", "phi3-mini-3.8b", "--shape", "train_4k", "--mesh", "1x1",
     "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--overrides",
     json.dumps({"rt": {"attn_impl": "flash"}})]),
    ("qwen3-32b decode_32k, 16x16", ["repro_torch.launch.dryrun", "--arch",
     "qwen3-32b", "--shape", "decode_32k"]),
    ("gcrn-m2 4096 streams, 16x16", ["repro_torch.launch.dgnn_dryrun",
     "--model", "gcrn-m2", "--streams", "4096"]),
)


def tp_place(tree, axes, mesh):
    """A tree distributed over ``mesh`` by its Axes tree."""
    return tree_map2(distribute, tree, tree_shardings(tree, axes, mesh))


def host_ms(fn, reps: int = 3):
    """(median ms, all ms, the last result) of ``reps`` calls, host clock
    to a sync."""
    ms, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), ms, out


def tp_serving_path(cfg, params, tokens, card) -> tuple:
    """Qwen2.5-14B's prefill (flash) and one decode step with the
    parameters (and the caches) distributed by their Axes trees over the
    world-1 NCCL host mesh, under sharding_ctx: the logits bit for bit
    the unsharded calls', flash_fwd launched once a layer, ms both ways
    (median of 3). Returns (the flash launches, the unsharded prefill's
    ms)."""
    rt = dataclasses.replace(LM_RT, attn_impl="flash")
    batch = {"tokens": tokens}
    want = prefill_step(params, cfg, rt, batch)
    plain_ms, plain_all, _ = host_ms(lambda: prefill_step(params, cfg, rt,
                                                          batch))
    tok = lm_tokens(LM_BATCH, 1, SEED + 5, cfg.vocab_size)
    caches = init_caches(cfg, LM_RT, LM_BATCH, LM_SKV)
    dec_want = decode_step(params, cfg, LM_RT, tok, caches)[0]
    dplain_ms, dplain_all, _ = host_ms(lambda: decode_step(
        params, cfg, LM_RT, tok, caches))
    mesh = make_host_mesh()
    try:
        with sharding_ctx(mesh):
            dp = tp_place(params, lm.param_axes(cfg, rt), mesh)
            engine.reset_launches()
            got = prefill_step(dp, cfg, rt, batch)
            torch.cuda.synchronize()
            counts = launched(f"{cfg.name} prefill flash under the 1x1 mesh")
            check(counts == {"flash_fwd": cfg.n_layers},
                  f"the prefill under the mesh launched flash_fwd once a "
                  f"layer: {counts}")
            same = torch.equal(got.full_tensor(), want)
            engine.reset_launches()
            ms, all_ms, _ = host_ms(lambda: prefill_step(dp, cfg, rt, batch))
            timed = launched(f"{cfg.name} prefill under the mesh, 3 timed")
            check(timed == {"flash_fwd": 3 * cfg.n_layers},
                  f"timed prefills under the mesh: {timed}")
            dcaches = tp_place(caches, lm.cache_axes(cfg, LM_RT), mesh)
            dgot = decode_step(dp, cfg, LM_RT, tok, dcaches)[0]
            dsame = torch.equal(dgot.full_tensor(), dec_want)
            dms, dall, _ = host_ms(lambda: decode_step(dp, cfg, LM_RT, tok,
                                                       dcaches))
    finally:
        torch.distributed.destroy_process_group()
    log(f"tp: {cfg.name} prefill B={LM_BATCH} S={LM_SEQ} flash, params "
        f"distributed by param_axes over the world-1 NCCL 1x1 mesh: logits "
        f"bit for bit the unsharded prefill's {same}; flash_fwd launches "
        f"{counts['flash_fwd']}; {ms:.2f} ms median of 3 (all "
        f"{', '.join(f'{m:.2f}' for m in all_ms)}) against {plain_ms:.2f} "
        f"unsharded ({', '.join(f'{m:.2f}' for m in plain_all)}): DTensor's "
        f"host dispatch {ms - plain_ms:.2f} ms; on {card}")
    log(f"tp: {cfg.name} decode step B={LM_BATCH} (cache {LM_SKV}, caches "
        f"distributed by cache_axes): logits bit for bit {dsame}; {dms:.2f} "
        f"ms median of 3 (all {', '.join(f'{m:.2f}' for m in dall)}) "
        f"against {dplain_ms:.2f} unsharded "
        f"({', '.join(f'{m:.2f}' for m in dplain_all)})")
    check(same and dsame, "prefill and decode under the 1x1 mesh bit for "
          "bit the unsharded calls")
    total = {k: counts.get(k, 0) + timed.get(k, 0) for k in counts}
    return total, plain_ms


def _timed_step(step, params, opt, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, batch)
    torch.cuda.synchronize()
    return params, opt, loss, (time.perf_counter() - t0) * 1e3


def tp_train_path(cfg, params, card) -> tuple:
    """phi3-mini-3.8b (fp32) trained through make_train_step_fn one step
    unsharded and one under the world-1 NCCL 1x1 mesh (parameters by
    param_axes, the moments by opt_state_axes) from the same parameters
    and a fresh state: the loss and every updated parameter bit for bit;
    then a second step each way, timed. Returns (the flash launches of
    the compared step under the mesh, the unsharded step's ms)."""
    batch = next(synthetic_lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=SEED + 9, device="cuda"))
    step = make_train_step_fn(cfg, TRAIN_RT, TRAIN_OPT, device="cuda")
    leaves = tree_leaves(params)
    start = [t.detach().cpu() for t in leaves]
    params, opt, loss_a, _ = _timed_step(step, params,
                                         init_opt_state(params, TRAIN_OPT),
                                         batch)
    after = [t.detach().cpu() for t in tree_leaves(params)]
    params, opt, _, plain_ms = _timed_step(step, params, opt, batch)
    del opt
    with torch.no_grad():
        for t, h in zip(tree_leaves(params), start):
            t.copy_(h)
    del start
    axes = lm.param_axes(cfg, TRAIN_RT)
    mesh = make_host_mesh()
    try:
        with sharding_ctx(mesh):
            dp = tp_place(params, axes, mesh)
            fresh = init_opt_state(params, TRAIN_OPT)
            oaxes = opt_state_axes(axes, TRAIN_OPT)
            dopt = {"m": tp_place(fresh["m"], oaxes["m"], mesh),
                    "v": tp_place(fresh["v"], oaxes["v"], mesh),
                    "step": fresh["step"]}  # the host scalar stays local
            del fresh
            engine.reset_launches()
            dp, dopt, loss_b, _ = _timed_step(step, dp, dopt, batch)
            counts = launched(f"{cfg.name} train step under the 1x1 mesh")
            same_loss = torch.equal(loss_b.full_tensor().cpu(), loss_a.cpu())
            same = all(torch.equal(t.full_tensor(), h.cuda()) for t, h in
                       zip(tree_leaves(dp), after))
            dp, dopt, _, ms = _timed_step(step, dp, dopt, batch)
    finally:
        torch.distributed.destroy_process_group()
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers}
    log(f"tp: {cfg.name} train step B={TRAIN_BATCH} S={TRAIN_SEQ} (fp32, "
        f"flash, remat) through make_train_step_fn under the 1x1 mesh: loss "
        f"{float(loss_a):.6f}, bit for bit the unsharded step's "
        f"{same_loss}; every updated parameter bit for bit {same}; launches "
        f"{counts}; the second step {ms:.1f} ms against {plain_ms:.1f} "
        f"unsharded; on {card}")
    check(same_loss and same, "the train step under the 1x1 mesh bit for "
          "bit the unsharded step")
    check(counts == want, f"the train step under the mesh launched {want}")
    return counts, plain_ms


def tp_dryruns(measured: dict, card) -> None:
    """The dry runs of TP_DRYRUNS, each a process of its own on the CPU (a
    fake process group; no card): the roofline of the two measured
    workloads beside their ms, and the production cells' records."""
    out = ROOT / "results" / "dryrun_torch" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, (label, args) in enumerate(TP_DRYRUNS):
        path = out / f"dryrun_{i}.json"
        procs.append((label, path, time.time(), subprocess.Popen(
            [sys.executable, "-m", *args, "--out", str(path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for label, path, t0, proc in procs:
        text, _ = proc.communicate(timeout=600)
        wall = time.time() - t0
        check(proc.returncode == 0, f"dry run {label} exited "
              f"{proc.returncode}: {text[-2000:]}")
        rec = json.loads(path.read_text())
        rl = rec["roofline"]
        t_bound = max(rl["t_compute"], rl["t_memory"], rl["t_collective"])
        line = (f"dryrun {label}: {wall:.1f} s wall; per device flops "
                f"{rl['flops']:.4e}, bytes {rl['bytes_hbm']:.4e}, "
                f"collective bytes {rl['bytes_coll']:.4e} "
                f"{rec['collectives']['bytes_by_op']}; t_compute "
                f"{rl['t_compute'] * 1e3:.3f} ms, t_memory "
                f"{rl['t_memory'] * 1e3:.3f} ms, t_collective "
                f"{rl['t_collective'] * 1e3:.3f} ms, t_bound "
                f"{t_bound * 1e3:.3f} ms ({rl['bottleneck']}); memory "
                f"{rec['memory']}")
        if label in measured:
            ms = measured[label]
            line += (f"; measured {ms:.2f} ms on {card}: measured / bound "
                     f"{ms / (t_bound * 1e3):.2f}")
        if "corrections" in rec:
            line += f"; corrections added {rec['corrections']['added']}"
        log(line)
        check(rl["flops"] > 0 and t_bound > 0, f"dry run {label} roofline")


def examples_phase() -> None:
    """Each examples/torch/*.py in a process of its own at EXAMPLES' flags,
    on the card: each exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for name, args in EXAMPLES.items():
        with tempfile.TemporaryDirectory() as tmp:
            extra = (["--ckpt", str(Path(tmp) / "ckpt")]
                     if name == "train_evolvegcn" else [])
            t0 = time.time()
            run = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch"
                                     / f"{name}.py"), *args, *extra],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=600)
        out = run.stdout.strip().splitlines()
        log(f"example {name} {' '.join(args)}: rc {run.returncode} in "
            f"{time.time() - t0:.1f} s; " + " | ".join(out[-12:])
            + (f" {run.stderr.strip()[-2000:]}" if run.returncode else ""))
        check(run.returncode == 0, f"examples/torch/{name}.py exits 0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "CUDA card")
    ap.add_argument("--parent", type=Path, default=None, metavar="DIR",
                    help="another checkout (e.g. the parent commit's git "
                         "archive) whose stream engines the analyzer phase "
                         "times in turns with this tree's")
    parent = ap.parse_args(argv).parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = smi()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        "matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    # phase 2: build
    t0 = time.time()
    paths = engine.build()
    log(f"build: {time.time() - t0:.1f} s -> "
        + ", ".join(str(p.relative_to(ROOT)) if p.is_relative_to(ROOT)
                    else str(p) for p in paths.values()))
    for name, text in engine.BUILD_LOG.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the kernel, and its template flag (Lb1: the paged variant)
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif ("registers" in line or "spill" in line
                  or "(C75" in line):  # ptxas: serialised wgmmas
                log(f"  {name}: {line.strip()}")
    step_build_checks()

    np_stream, n_global = bc_alpha()
    stream = np_stream.to("cuda")
    T = stream.node_mask.shape[0]
    np_events = bc_alpha_events()
    events = np_events.to("cuda")
    T_ev = events.node_mask.shape[0]
    # each path's stream: TGN's event batches, the others' snapshots
    streams = {cfg.name: (events, np_events) if cfg is TGN
               else (stream, np_stream) for cfg in CONFIGS}
    gen = torch.Generator().manual_seed(SEED)
    models, params = {}, {}
    for cfg in CONFIGS:
        models[cfg.name] = build_model(cfg, n_global=n_global)
        params[cfg.name] = ops.to_device(models[cfg.name].init(gen), "cuda")

    # phase 3a: narrow widths
    t0 = time.time()
    small_shapes_check()
    step_kernel_edges()
    stacked_step_wide()
    static_engine_edges()

    # phase 3b: the stream engines at full width
    check_b = batch_of(np_stream, CHECK_WINDOWS)
    solo = batch_of(np_stream, ((0, T),))
    check_ev = batch_of(np_events, CHECK_WINDOWS)
    solo_ev = batch_of(np_events, ((0, T_ev),))
    static_dims = [(STATIC_GCN.in_dim, STATIC_GCN.hidden),
                   (STATIC_GCN.hidden, STATIC_GCN.out_dim)]
    # the layers' true widths, which the main path's launch computes alone
    static_widths = [static_dims[0][0]] + [d for _, d in static_dims]
    records = []
    inputs, paged_inputs, costs = {}, {}, {}
    for cfg, name, plain, cost, (b_in, s_in), tol in (
            (GCRN_M2, "gcrn_engine", engine.gcrn_plain, gcrn_cost,
             (check_b, solo), TOL_STREAM),
            (EVOLVEGCN, "evolve_engine", engine.evolve_plain,
             lambda inp: evolve_cost(inp, layer_dims(EVOLVEGCN)),
             (check_b, solo), TOL_STREAM),
            (STACKED, "stacked_engine", engine.stacked_plain, stacked_cost,
             (check_b, solo), TOL_STREAM),
            (TGN, "tgn_engine", engine.tgn_plain, tgn_cost,
             (check_ev, solo_ev), TOL_STREAM),
            (STATIC_GCN, "static_engine", engine.static_plain,
             lambda inp: static_cost(inp, static_dims), (check_b, solo),
             TOL_KERNEL)):
        kernel = getattr(engine, name)
        if name == "static_engine":
            kernel = functools.partial(kernel, widths=static_widths)
        m, p = models[cfg.name], params[cfg.name]
        family = m.stream_family
        inputs[family] = (kernel_inputs(m, p, b_in, lengths=[8, 5]),
                          kernel_inputs(m, p, s_in))
        costs[family] = cost
        # the paged engines take the resident packs, but TGN's partners
        # as local ids
        paged_inputs[family] = inputs[family] if family != "tgn" else (
            kernel_inputs(m, p, b_in, lengths=[8, 5], residency="hbm_paged"),
            kernel_inputs(m, p, s_in, residency="hbm_paged"))
        records.append(check_engine(name, kernel, plain, *inputs[family],
                                    cost, tol))
    for family in PAGED:
        records.append(check_paged_engine(
            family, inputs[family], paged_inputs[family], costs[family],
            next(r["ms"] for r in records if r["name"] == ENGINE[family])))
    # the static checker on the card and the protocol logs
    analysis_summary = analysis_phase(inputs, paged_inputs, parent)
    # the cluster engines: narrow cases, launch configs, B 1 / 4 in turns
    cluster_inputs = {}
    for cfg in (GCRN_M2, EVOLVEGCN, STACKED, TGN):
        m = models[cfg.name]
        family = m.stream_family
        np_s = np_events if cfg is TGN else np_stream
        wins = EVENT_V3_WINDOWS if cfg is TGN else V3_WINDOWS
        b4 = batch_of(np_s, wins)
        lens = [b - a for a, b in wins]
        cluster_inputs[(family, 1)] = (inputs[family][1],
                                       paged_inputs[family][1])
        resident = kernel_inputs(m, params[cfg.name], b4, lengths=lens)
        cluster_inputs[(family, 4)] = (resident, kernel_inputs(
            m, params[cfg.name], b4, lengths=lens, residency="hbm_paged")
            if cfg is TGN else resident)
    for name, extra in cluster_engine_checks(cluster_inputs).items():
        next(r for r in records if r["name"] == name).update(extra)
    del cluster_inputs
    smem_check({f: v[1] for f, v in inputs.items()},
               {f: v[1] for f, v in paged_inputs.items()})
    del paged_inputs

    # the static engine's launch three ways (bare launches and a CUDA graph
    # in turns; its kernel duration after phase 6), and its plan
    st_main = inputs["static_gcn"][1]
    turns_ = step_turns(lambda: [engine.prepare(
        "static_engine", *st_main, widths=static_widths)], "static_engine",
        "static_engine main path")
    B_st, k_st, D_st = st_main[0].shape[0], st_main[0].shape[-1], \
        st_main[4].shape[-1]
    lib_plan = engine.library_static_plan(B_st, k_st, D_st)
    plan = engine.static_plan(B_st, k_st, D_st, static_widths)
    check(lib_plan == {key: plan[key] for key in lib_plan},
          f"static_engine plan {plan} != library {lib_plan}")
    log(f"static_engine main path: {turns_['events']:.4f} ms bare launches, "
        f"{turns_['graph']:.4f} ms from a CUDA graph a launch (medians of "
        f"{STEP_SAMPLES} in turns); launch {plan}")
    rec = next(r for r in records if r["name"] == "static_engine")
    # beside the wrapper's time (``ms``, as every engine's: index checks and
    # a host sync included), a prepared launch alone and from a graph
    rec.update(launch_ms=turns_["events"], graph_ms=turns_["graph"],
               turns=turns_, plan=lib_plan)
    static_wave_probe(st_main, static_widths)
    del inputs, st_main

    # phase 3c: the per-step kernels on recorded main-path inputs
    g_calls, s_calls, e_calls = recorded_step_calls(
        params, n_global, stream, np_stream)
    stacked_one_layer_check(n_global, stream, np_stream)
    e_groups = ell_groups(e_calls)
    idx, _, _, x, h = g_calls[0][:5]
    plan = step_plan_check("gcrn_step", dict(
        n=idx.shape[0], k=idx.shape[1], din=x.shape[1], H=h.shape[1]))
    log(f"gcrn_step launch at the main path's shape: {plan}")
    for label, calls in e_groups.items():
        idx, x, em = calls[0][0], calls[0][3], calls[0][4]
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, em)
                      if t is not None)
        plan = step_plan_check("ell_spmm", dict(
            L=int(np.prod(idx.shape[:-2])), n=idx.shape[-2], d=x.shape[-1],
            aligned=int(aligned)))
        log(f"ell_spmm launch, {label}: {plan}")
    no_edge = e_groups[next(iter(e_groups))]
    lib = [sparse_mm_inputs(c) for c in no_edge]
    lib_err = max(max_err(torch.sparse.mm(a, x), engine.ell_spmm_plain(*c))
                  for (a, x), c in zip(lib, no_edge))
    log(f"torch.sparse.mm vs plain ELL SpMM: max_abs_err={lib_err:.3e}")
    records += [
        check_step_kernel("gcrn_step", engine.gcrn_step_plain, g_calls,
                          {"all": g_calls}, gcrn_step_cost),
        check_step_kernel("stacked_step", engine.stacked_step_plain, s_calls,
                          {"all": s_calls}, stacked_step_cost),
        check_step_kernel("ell_spmm", engine.ell_spmm_plain, e_calls,
                          e_groups, ell_cost,
                          library=[lambda a=a, x=x: torch.sparse.mm(a, x)
                                   for a, x in lib]),
    ]
    records += [check_rnn_cell(cell, rnn_inputs(cell, RNN_ROWS, RNN_DIN,
                                                RNN_H, SEED))
                for cell in ("fused_gru", "fused_lstm")]
    records.append(check_edge_terms(params[EVOLVEGCN.name], (check_b, solo)))
    log(f"phase 3 (kernel checks and timings): {time.time() - t0:.1f} s")

    # phase 4: the main paths, counts read around each
    t0 = time.time()
    launches = {name: 0 for name in engine.KERNELS}
    for cfg, level, impl in main_paths():
        label = f"{cfg.name} {level} {impl}"
        p = params[cfg.name]
        path_stream, path_np = streams[cfg.name]
        T_path = path_stream.node_mask.shape[0]
        engine.reset_launches()
        res, ms = drive(cfg, level, impl, p, n_global, path_stream, path_np,
                        reps=RUN_REPS)
        counts = {k: v for k, v in engine.LAUNCHES.items() if v}
        log(f"path {label}: run {float(np.median(ms[1:])):.4f} ms/snapshot "
            f"median of {RUN_REPS} (first {ms[0]:.4f}, all "
            f"{', '.join(f'{m:.4f}' for m in ms)}; T={T_path}), "
            f"launches {counts}")
        for name in expected_kernels(cfg, level, impl):
            check(counts.get(name, 0) > 0, f"{label} launched {name}")
        for name, v in counts.items():
            launches[name] += v
        engine.reset_launches()
        ref, _ = drive(cfg, level, impl, p, n_global, path_stream, path_np,
                       force_ref=True)
        check(not any(engine.LAUNCHES.values()),
              f"{label} force_ref reached a kernel")
        check_path(label, cfg, level, res, ref, T_path)
    log(f"phase 4 (main paths): {time.time() - t0:.1f} s")

    # phase 4, paged: the session paths, then run_arrays, at every depth;
    # each session path is timed as the others, then run once more beside
    # a resident run with deterministic algorithms for the bitwise check
    t0 = time.time()
    for cfg in (GCRN_M2, EVOLVEGCN, STACKED, TGN):
        p = params[cfg.name]
        path_stream, path_np = streams[cfg.name]
        T_path = path_stream.node_mask.shape[0]
        family = api.family_for(cfg)
        with deterministic():
            resident_bits, _ = drive(cfg, "v3", "session", p, n_global,
                                     path_stream, path_np)
        for depth in PAGED_DEPTHS[cfg.name]:
            kw = paged_plan(depth)
            label = f"{cfg.name} v3 hbm_paged d{depth} session"
            engine.reset_launches()
            res, ms = drive(cfg, "v3", "session", p, n_global, path_stream,
                            path_np, reps=RUN_REPS, plan_kw=kw)
            counts = {k: v for k, v in engine.LAUNCHES.items() if v}
            log(f"path {label}: run {float(np.median(ms[1:])):.4f} "
                f"ms/snapshot median of {RUN_REPS} (first {ms[0]:.4f}, all "
                f"{', '.join(f'{m:.4f}' for m in ms)}; T={T_path}), "
                f"launches {counts}")
            check(counts.get(PAGED[family], 0) > 0
                  and counts.get(ENGINE[family], 0) == 0,
                  f"{label} launched {PAGED[family]} only")
            for name, v in counts.items():
                launches[name] += v
            with deterministic():
                bits, _ = drive(cfg, "v3", "session", p, n_global,
                                path_stream, path_np, plan_kw=kw)
            check_bitwise(label, bits, resident_bits)
            engine.reset_launches()
            ref, _ = drive(cfg, "v3", "session", p, n_global, path_stream,
                           path_np, force_ref=True, plan_kw=kw)
            check(not any(engine.LAUNCHES.values()),
                  f"{label} force_ref reached a kernel")
            check_path(label, cfg, "v3", res, ref, T_path)
        arr = arrays_inputs(cfg, p, n_global, path_stream, path_np)
        resident = drive_arrays(cfg, arr, {})
        ref = drive_arrays(cfg, arr, {}, force_ref=True)
        for depth in PAGED_DEPTHS[cfg.name]:
            label = f"{cfg.name} hbm_paged d{depth} run_arrays"
            engine.reset_launches()
            got = drive_arrays(cfg, arr, paged_plan(depth))
            counts = launched(label)
            check(counts.get(PAGED[family], 0) > 0
                  and counts.get(ENGINE[family], 0) == 0,
                  f"{label} launched {PAGED[family]} only")
            for name, v in counts.items():
                launches[name] += v
            same = bitwise(got, resident)
            err = max_err(got, ref)
            log(f"{label}: solo + ragged batch {arr[2]} bitwise vs resident "
                f"{same}, vs force_ref {err:.3e} (tol {TOL_STREAM})")
            check(same and np.isfinite(err) and err <= TOL_STREAM, label)
        del arr, resident, ref, resident_bits
    for name, v in capacity_path(n_global, np_stream, gen).items():
        launches[name] += v
    for cell in ("fused_gru", "fused_lstm"):
        for name, v in rnn_path(cell).items():
            launches[name] += v
    log(f"phase 4 (paged paths, capacity, RNN cells): "
        f"{time.time() - t0:.1f} s")

    # phase 4, serve: the DGNN serve layer on the stream engines, counts
    # read around each serve path
    t0 = time.time()
    for name, v in serve_phase(params, card).items():
        launches[name] += v
    log(f"phase 4 (serve): {time.time() - t0:.1f} s")

    # phase 4, the paths that launch no kernel: the DGNN trainer, the
    # Mamba2 / MoE LM paths and the examples, timed before the first
    # profiler window (phase 6 below)
    t0 = time.time()
    trainer_phase(card)
    for arch in SSM_MOE_ARCHS:
        ssm_moe_path(arch, card)
    examples_phase()
    log(f"phase 4 (trainer, Mamba2 / MoE, examples): "
        f"{time.time() - t0:.1f} s")
    sharding_phase(params, streams, n_global, card)

    # phase 6: where a live node tile's time goes, run before phase 5: no
    # host-dispatched timing follows a profiler window (a traced process
    # dispatches more slowly). Then the profiler's kernel durations of 3c
    # and 6
    tile_probe()
    kernel_durations()

    # phase 5: the device's busy share of a run, per kind of level
    for cfg, level, kw in ((GCRN_M2, "baseline", {}), (GCRN_M2, "v2", {}),
                           (GCRN_M2, "v3", {}), (EVOLVEGCN, "v3", {}),
                           (STACKED, "v3", {}), (TGN, "v3", {}),
                           (STATIC_GCN, "v3", {}),
                           (GCRN_M2, "v3", paged_plan(2)),
                           (EVOLVEGCN, "v3", paged_plan(2)),
                           (TGN, "v3", paged_plan(2))):
        wall, device = busy_share(cfg, level, params[cfg.name], n_global,
                                  streams[cfg.name][0], plan_kw=kw)
        share = (f"{device / wall:.3f}" if device > 0
                 else "not measured (the profiler saw no device time)")
        paged = f" hbm_paged d{kw['buffer_depth']}" if kw else ""
        ctas = ""
        if level == "v3" and cfg in (GCRN_M2, EVOLVEGCN, STACKED, TGN):
            name = ENGINE[api.family_for(cfg)] + ("_paged" if kw else "")
            launch = next(r for r in records if r["name"] == name)["b1_launch"]
            ctas = (f"; a launch: {launch['ctas']} CTAs, one cluster of "
                    f"{launch['cluster']} ({launch['threads']} threads, "
                    f"{launch['smem']} B of shared memory a CTA)")
        log(f"busy {cfg.name} {level}{paged}: run {wall:.2f} ms wall under "
            f"the profiler, {device:.2f} ms of kernels, busy share {share}"
            + ctas)

    del models, params, streams, stream, events

    # the LM serving path. Phase 3d: both flash kernels on narrow cases,
    # then on the q / k / v of layer 0 and the last layer of one full-width
    # prefill
    t0 = time.time()
    flash_small_check()
    cfg_lm, lm_params = lm_model()
    flash_rt = dataclasses.replace(LM_RT, attn_impl="flash")
    tokens = lm_tokens(LM_BATCH, LM_SEQ, SEED + 1, cfg_lm.vocab_size)
    with recording_flash({0, cfg_lm.n_layers - 1}) as calls:
        prefill_step(lm_params, cfg_lm, flash_rt, {"tokens": tokens})
    check(sorted(calls) == [0, cfg_lm.n_layers - 1],
          f"recorded flash calls {sorted(calls)}")
    records += [check_flash_kernel("flash_fwd", calls),
                check_flash_kernel("flash_attention", calls)]
    log(f"phase 3d (flash kernels): {time.time() - t0:.1f} s")

    # phase 4, LM: (a) the prefill, (b) generate, and flash_attention's own
    # entry point; counts read around each
    t0 = time.time()
    counts, prefill_ms = lm_prefill_path(cfg_lm, lm_params, tokens)
    for source in (counts, lm_generate_path(cfg_lm, lm_params)[0],
                   flash_attention_path(calls[0])):
        for name, v in source.items():
            launches[name] += v
    del calls
    log(f"phase 4 (LM paths): {time.time() - t0:.1f} s")

    # phase 5, LM: the device's busy share of one prefill
    wall, device = busy_share_fn(lambda: prefill_step(
        lm_params, cfg_lm, flash_rt, {"tokens": tokens}))
    share = (f"{device / wall:.3f}" if device > 0
             else "not measured (the profiler saw no device time)")
    log(f"busy {cfg_lm.name} prefill flash B={LM_BATCH} S={LM_SEQ}: "
        f"{wall:.2f} ms wall under the profiler, {device:.2f} ms of "
        f"kernels, busy share {share}")
    # and of one decode step (B 2, after one token in a 64-slot cache)
    tok = lm_tokens(LM_BATCH, 1, SEED + 3, cfg_lm.vocab_size)
    caches = decode_step(lm_params, cfg_lm, LM_RT, tok,
                         init_caches(cfg_lm, LM_RT, LM_BATCH, LM_SKV))[1]
    wall, device = busy_share_fn(lambda: decode_step(
        lm_params, cfg_lm, LM_RT, tok, caches))
    share = (f"{device / wall:.3f}" if device > 0
             else "not measured (the profiler saw no device time)")
    log(f"busy {cfg_lm.name} decode step B={LM_BATCH}: {wall:.2f} ms wall "
        f"under the profiler, {device:.2f} ms of kernels, busy share "
        f"{share}")
    # the LM under the 1x1 mesh: the same prefill and a decode step with
    # DTensor parameters, bit for bit the unsharded calls
    t0 = time.time()
    tp_counts, tp_prefill_ms = tp_serving_path(cfg_lm, lm_params, tokens,
                                               card)
    for name, v in tp_counts.items():
        launches[name] += v
    log(f"phase 4 (TP serving): {time.time() - t0:.1f} s")
    # the serving weights (29.5 GB) and the training state (~61 GB) do not
    # fit together
    del lm_params, caches, tokens, tok
    torch.cuda.empty_cache()

    # the LM training path. Phase 3e: both flash backward kernels on narrow
    # cases, then at the serving path's layer shape
    t0 = time.time()
    flash_bwd_small_check()
    records += check_flash_bwd_kernels()
    log(f"phase 3e (flash backward kernels): {time.time() - t0:.1f} s")

    # phase 4, training: (c) phi3-mini-3.8b trains, counts read around each
    # step; (d) the gradient gate; (e) the loop's checkpoint and resume
    t0 = time.time()
    cfg_tr, tr_params = train_model()
    counts, tr_params, step_ms, peak = lm_train_path(cfg_tr, tr_params)
    for name, v in counts.items():
        launches[name] += v
    wall, device = train_step_busy(cfg_tr, tr_params)
    share = (f"{device / wall:.3f}" if device > 0
             else "not measured (the profiler saw no device time)")
    log(f"busy {cfg_tr.name} train step B={TRAIN_BATCH} S={TRAIN_SEQ}: "
        f"{wall:.2f} ms wall under the profiler, {device:.2f} ms of "
        f"kernels, busy share {share}")
    train_gate(cfg_tr, tr_params)
    t1 = time.time()
    tp_counts, tp_step_ms = tp_train_path(cfg_tr, tr_params, card)
    for name, v in tp_counts.items():
        launches[name] += v
    log(f"phase 4 (TP training step): {time.time() - t1:.1f} s")
    del tr_params
    torch.cuda.empty_cache()
    train_loop_path()
    log(f"phase 4 (LM training): {time.time() - t0:.1f} s")

    # phase 4, SSM / MoE training: (c2) mamba2-2.7b and granite-moe-3b-a800m
    # at full width and depth, their gates, granite's ep gradients and the
    # two launchers; the flash counts read around each granite step
    t0 = time.time()
    for name, v in ssm_moe_train_phase(card).items():
        launches[name] += v
    log(f"phase 4 (SSM / MoE training): {time.time() - t0:.1f} s")

    # the roofline against the card: the port's dry runs of the two
    # measured workloads at one chip, and two production cells
    t0 = time.time()
    tp_dryruns({TP_DRYRUNS[0][0]: tp_prefill_ms,
                TP_DRYRUNS[1][0]: tp_step_ms}, card)
    log(f"phase 4 (dry runs): {time.time() - t0:.1f} s")

    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} launched on the main path")
    check({r["name"] for r in records} == set(engine.KERNELS),
          "a record for every kernel")

    log(json.dumps({"analysis": analysis_summary}))
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

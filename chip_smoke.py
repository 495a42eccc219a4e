#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py                      # every phase (the full check)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each printing one JSON line:

  device       the card, from nvidia-smi (its raw line is printed too);
  build        compile the CUDA kernels (csrc/*.cu, one nvcc each, in
               parallel) into build/repro_torch/; then each library's
               kernels through cuobjdump --dump-resource-usage (registers,
               static shared memory, stack and local bytes; the whole
               table to build/repro_torch/kernel_resources.json), the
               static shared bytes held to what the port's analyzer
               reckons from the sources (repro_torch.analysis, PK402) for
               every instance it evaluates: equal, up to the block's 1 KB
               system reserve and the arrays an instance never reads
               (the compiler drops them; the line names each);
  kernels      every kernel against its plain PyTorch version on the card,
               at the shapes the main path gives it (K1 f32 at the fit's
               level 0, the stream's 8192 x 131,072 and the serve shape;
               K3 at the level-0 reduce, the Lloyd statistics and the KV
               compressions, bit for bit against the plain version on the
               CPU; K1's bf16 and int8 key instances at the serve shape and
               at d 64): error within the stated tolerance, indices equal
               except at distance near-ties, the route each row timed
               (K1's tensor-core "tc3xtf32", "cuda_core_split" or
               "cuda_core", for every key type; K3's "few" or "many"
               segments; K5's "split_kv", "tiled_mma" or "tiled"), and
               times (CUDA events, median of 10 after a warm-up; the plain
               version at the fit's largest K1 shapes, one call; K1 in each
               key type, K2 at d 256, K3 and K5 also their device time
               alone); the lm_moe phase's shapes: K2 and K3 at d 128, K5's
               bf16 prefill and decode at head_dim 128 without softcap,
               with scaled_dot_product_attention timed beside them; the
               lm_vlm and lm_encdec phases' shapes the same way: K2 and K3
               at d 96 (K3 also 192) over phi-3-vision's 2,464-slot cache,
               K5's prefill at head_dim 96 on the tensor-core route and, in
               f32, on the tiled route, its decode at head_dim 96, and
               seamless's encoder, cross-attention prefill and cross
               decode calls at head_dim 64;
               then awkward shapes on a dyadic grid, where kernel and plain
               version must agree bit for bit, tie-breaking included, and
               the edge cases of K1's tensor-core and split routes (every
               key type), of K3's paths, of K4's two instances (bit for
               bit up to n * m > 2^31) and of K5's routes; K4 at its
               paths' four shapes: k-means over 2,390 x 7 and 15,625 x 3,
               HAC's 4,096^2 and DBSCAN's 50,000^2 (there the error is read
               on the first 4,096 and the last 1,024 rows), with its time
               on the device and torch.cdist's beside it; K1-K4 at the
               select phase's shapes (d 64: K1 8192 x 65,536, k 1, on the
               split route; K2 at 8,192 rows; K3 65,536 into 32,768; K4
               65,536 x 16,384);
  fit          the main path: repro_torch.fit on a covertype-sized
               Gaussian-mixture analog (n = 581,012, d = 6, 7 components,
               standardized), t = 3, m = 5, k-means k = 7;
  serve        the main path, continued: ClusterIndex.build on that fit,
               ClusterService with buckets (32, 128, 512, 2048), requests of
               1, 100, 2048 and 5000 points, held against the plain path;
  sharded      the sharded fit (repro_torch.core.distributed) at the fit's
               full size, every rank on this card: four ranks over gloo
               (CUDA tensors copied through the ranks' device mailboxes,
               opened by CUDA IPC; reductions through host memory) fit the
               analog's first 579,312 rows (every level size divides by
               the shard multiple 8), twice, and serve 4,999 queries under
               the mesh: bit for bit the memory executor's fit and the
               one-device assign; then all 581,012 rows (the padded path:
               labels >= 0, clusters >= 3^5, mass sum n); stream_to_mesh in
               chunks of 131,072 and a fit of its output (bitwise the
               memory fit); streaming_sharded on aligned chunks of 132,192
               (reservoir 220,320) bitwise the streaming executor; then
               one rank over NCCL, the aligned fit again, bitwise; K1 at a
               ring step's shape (queries of one rank against another's
               block, self-exclusion shifted out of range) and K3 at a
               rank's block partial held against their plain versions;
               per rank the wall per level, MIS rounds, peak memory,
               launches per route and the collectives' bytes, staged
               through the host and through the mailboxes;
  tune         the autotuner (repro_torch.tune) on the main path: the
               CLI's populate into a temporary cache at the main path's
               buckets (knn, knn_block and assign at the fit's 581,012 x 6,
               k 2; assign at the serve shape; segment_sum at the level-0
               reduce and the Lloyd statistics; pairwise_sq_l2 at the
               k-means 2,390 x 7), every candidate's median ms; every
               candidate route held against its plain version (K1/K2
               within DIST_TOL, indices only at near-ties, at a cut
               4,096 x 65,536 and the level-4 7,172 rows; the assign
               cell's candidates at the serve shape, labels only at
               near-ties; K3 bit for bit against the CPU fold; K4 within
               DIST_TOL) with the rows where each differs from the default
               route; the covertype fit under tune="cached" against the
               fit phase's untuned one (label agreement >= 0.999, bitwise
               when every winner is the default route) and again
               (bitwise), with the plan's frozen fields, the launches per
               route and the cache's hits and misses; the fit served
               under "cached"; stale entries planted (a "pallas" winner,
               a plain version under the card's kind, tc3xtf32 at d 64, a
               3000-row block), warned about, pruned, and the fit on the
               constants; one onthefly plan_fit on a miss, which measures
               while its execution does not;
  headline     the paper's GMM at n = 1,000,000, t = 2, m = 3, k = 3:
               accuracy must be >= 0.90 (its launches are counted too; the
               kernels phase times K1 at its three level sizes);
  determinism  n = 65,536: the kernel path twice (bitwise equal labels) and
               the plain path once (label agreement >= 0.999);
  hac          IHTC + ward HAC on the paper's GMM at n = 1,000,000, t = 2,
               k = 3, m the first level whose prototype count fits the
               reference's 4,096-prototype HAC budget (a probe fit counts
               each level's), then m + 1 and m + 2: accuracy >=
               MIN_HAC_ACCURACY at each; then HAC alone on the fit's
               prototypes in all four linkages, kernel path against plain
               path (labels >= 0.999 equal after best matching; where the
               merge sequences part, a near-tie within DIST_TOL), and the
               merge loop once under torch.cuda.set_sync_debug_mode("error");
  dbscan       IHTC + DBSCAN on the covertype analog cut to 50,000 rows
               (eps the median 4-NN distance of a 1,000-row subsample,
               min_pts 16, t = 2, m = 0, 1, 2: the paper's Table 9): walls,
               clusters, noise share, BSS/TSS, peak memory, propagation
               rounds; then DBSCAN alone on the m = 2 prototypes, kernel
               path against plain path (labels >= 0.999 equal; with no pair
               whose two distances lie on opposite sides of eps², bitwise);
  online       the online loop: a 10,485,760-point blobs stream (d = 6, 7
               blobs, 80 chunks of 131,072) folded by an OnlineFitter
               (t = 3, m = 4, k-means k = 7, prefetch depth 2), its snapshot
               packed into an index, saved to and loaded from an
               IndexStore, served by an AsyncClusterService on an asyncio
               loop under fused, fused_bf16 and fused_int8 (requests of 1,
               100, 2048, 5000 points), then a RefreshDriver folding a
               drifted stream refreshes once under live traffic (snapshot,
               pack, save, warmup, hot-swap); the fit's prototypes,
               clustered under 16 k-means seedings, must match the
               generating blobs (accuracy >= 0.97); then a determinism
               check on the first 8 chunks (prefetch depth 0 vs 2 bitwise,
               kernel path vs plain path level-0 maps agreement >= 0.999,
               both paths' prototypes as above, lowest inertias within
               5 %);
  train        the trainer at the full gemma2-2b config through
               repro_torch.launch.train's functions: f32 weights drawn from
               a seeded generator, AdamW state in f32, b 8, s 256, remat
               "block", 24 steps under warm-up 5 / decay 60 at peak lr 3e-4;
               the mean of the last four losses must be below 0.92 x the
               first four's (the reference test's criterion); the first 4
               steps again from the seeded state must give the same losses
               and parameters bit for bit; then 10 steps straight against
               5 + checkpoint + restore + 5 at the smoke config, bit for
               bit; the first step's ms apart, step p50/p99 and tokens/s
               over the others, peak memory and AdamW's share of a step
               (CUDA events); no kernel may launch (training takes the
               plain route under autograd);
  select       the paper's instance selection on a synth_tokens corpus of
               65,536 examples of 257 tokens, featurized with the train
               phase's embedding table (dim 64) under the reference's
               default SelectionConfig (t* 2, m 2), and again at m 4 (its
               8,192-row level runs K2): masses must sum to n within 1e-2;
               the plain path on the card must agree on >= 0.999 of the
               examples (prototype, medoid, mass), bit for bit unless the
               two paths' level-0 kNN lists differ at a near-tie; then 8
               weighted train steps on selected rows (loss finite, the
               weight metric = sum of mass x labels);
  train_moe, train_ssm, train_hybrid, train_vlm, train_encdec
               the train phase's set-up on the other families at full
               width, 16 steps each (TRAIN_FAMILIES): deepseek-moe-16b cut
               to 4 layers (1 dense + 3 MoE, top-6 of 64 + 2 shared),
               mamba2-370m whole, jamba cut to 2 layers (Mamba + dense,
               Mamba + MoE), phi-3-vision whole (each row the 256-token
               patch prefix), seamless whole (256 encoder frames a row),
               the depth cut where 16 B a parameter would not fit the card
               (the line states the arithmetic); the same criterion,
               finite grad norms at every step, a bitwise repeat (deepseek
               at top-6 too), a bitwise resume at the family's smoke
               config, peak memory, the MoE's aux losses and dropped slots,
               the SSD scan's largest decay sum above the diagonal; with
               profile, one more step under torch.profiler;
  train_mesh   the trainer over data ranks (TRAIN_MESH): gemma2-2b at full
               width cut to 2 layers, four gloo ranks on this card for 3
               steps (copies through the ranks' device mailboxes), bit for
               bit the one-device step at 4 microbatches (losses, grad
               norms, weights, the moments gathered from the ZeRO-1
               shards); a step-2 checkpoint that two ranks restore for
               step 3, bit for bit the one-device schedule; one NCCL rank
               against 1 microbatch; the int8 error-feedback all-reduce on
               the step-0 gradients (the reference's criteria, the card's
               bits the host's); the first step apart, bytes a rank a
               step, peak memory, spawn and phase seconds; the phase fails
               past 60 s;
  mesh_tp      the model axis (MESH_TP): gemma2-2b cut as train_mesh cuts
               it over 8 gloo ranks on this card at (data 2, model 4), one
               spawn from train_mesh's rank server: every rank draws its
               slices of the seeded model at once, one whole leaf at a
               time (its peak then held to check_fits' reckoning); 3 train
               steps within
               tests/test_torch_train.py's bounds of the one-device step at
               2 microbatches (run first, in this process: loss and grad
               norm within 8 bf16 ulps, each step-0 gradient within 8 ulps
               of its leaf's largest |g|, weights within 2·Σlr and on
               average 0.1·Σlr), a second run bitwise the first, every
               replicated leaf bitwise across the model ranks; the lm
               phase's traffic served with a shorter decode (batch 4, 2
               rows a data rank, prompt 2048, 48 tokens, compressed with a
               32-slot tail: one in-flight recompression) with each rank's
               K5, K2 and K3 launches counted, prefill and 8 forced decode
               steps within
               lm_parity's limits of the one-device kernel path and bitwise
               on repeat, every K5 call at the ranks' heads held against
               K5's plain version, each rank's compressed slots the one-device
               compression of the ranks' raw caches put together; step ms,
               mailbox and staged bytes a rank a step, peak memory against
               check_fits' reckoning; the phase fails past 40 s;
  lm           the LM serving path at the full gemma2-2b config (random
               weights from a seeded generator): ServeEngine.generate with
               batch 4, prompt 2048, 160 new tokens, IHTC KV compression
               t = 2, m = 1, tail 128 (one in-flight recompression); then the
               kernel path against two plain paths (prefill, compress, 8
               teacher-forced decode steps), the same arithmetic (K5's
               plain version) and the reference's chunked route, within
               LOGIT_ULPS, with a planted fault (K5's bias dropped for one
               step) that must exceed it; then a second
               kernel-path run (bitwise equal tokens);
  dryrun       the dry run (repro_torch.launch.dryrun) on the meta device
               against what the card measured: train_gemma2's step (the
               train phase's p50 and peak), lm_gemma2's prefill of the
               2048-token prompt into its 2,208-slot cache and one decode
               step over a compressed 1,232-slot cache (both timed here on
               the lm phase's model, DRYRUN's repeats), and one mesh_tp
               rank's step (the mesh_tp phase's rank 0); each line has the
               reckoned FLOPs by dtype, bytes, peak and model FLOPs beside
               the measured p50 and the step's own peak (the card's
               max_memory_allocated less what was allocated beside the
               step's inputs): mfu (model FLOPs over p50 x the bf16 peak)
               and hw_flops_share (the counted FLOPs at their types' peaks
               over p50) must be <= 1, peak_ratio (reckoned / measured) in
               DRYRUN's band, the mesh_tp rank's reckoned collectives
               equal, op by op, to what every rank recorded over its last
               step, and the phase within DRYRUN's 20 s; run alone it
               first runs the phases it compares against;
  lm_moe       the lm phase's serving, compression and parity on
               deepseek-moe-16b whole (28 layers, MHA 16 x 128, 64 routed
               experts top-6 + 2 shared; 16.4e9 random bf16 parameters):
               K5 at head_dim 128 without softcap, K2 and K3 at d 128;
               slots dropped for capacity at the prefill (none may drop at
               decode); the parity runs 32 teacher-forced steps, and the
               two plain paths run with every MoE call's routing pinned to
               the kernel path's (RoutingPin: a step function of the
               router probabilities that would otherwise turn last-bit
               differences into whole experts; the tokens pinned within
               2^-5 of their top-k boundary and beyond it reported, with
               the largest gap), top-1 agreement read over all rows of the
               prefill and the steps; every K5 call of the kernel path
               (each layer's prefill and every step) is held against K5's
               plain version on its own inputs (ATTN_TOL_BF16); the
               planted fault is read on the logits, or, where zeroing
               every attention output moves the logits less than the
               bound, at K5's output against the plain version;
  lm_hybrid    the same on jamba-v0.1-52b at full width cut to one period
               of 8 layers (attention at layer 4, GQA 32/8, Mamba at the
               other seven, MoE 16 experts top-2 at the odd layers); then
               mamba2-370m whole: its prefill and 32 teacher-forced decode
               steps against its full forward within LOGIT_ULPS, no kernel
               launched, compress=True refused; each phase first frees
               what the earlier phases hold and prints its seconds;
  lm_vlm       phi-3-vision-4.2b whole (32 layers, MHA 32 x 96; random bf16
               parameters) at batch 2, each row the stubbed vision tower's
               256-token patch prefix and a 2048-token prompt, 160 new
               tokens, compressed at t = 2, m = 1, tail 128: K5 at head_dim
               96 (tiled_mma prefill, split-kv decode with the
               position-and-mass bias), K2 and K3 at d 96 / 192; the kernel
               path against the plain paths over the prefill and 32
               teacher-forced steps, every K5 call against its plain
               version, K5's bias dropped as the planted fault, the
               compressed slots and a repeat, as lm_moe;
  lm_encdec    seamless-m4t-large-v2 whole (24 encoder and 24 decoder
               layers, MHA 16 x 64) at batch 4 over 2048 encoder frames (the
               stubbed speech encoder's output), a 128-token decoder prompt
               and 160 new tokens, no compression (an enc-dec cache is not
               compressed): K5 on the non-causal encoder calls, the causal
               decoder calls and the non-causal cross-attention calls
               (tiled_mma at head_dim 64 in the prefill, split-kv at decode,
               the cross decode without a bias); the same checks, the
               planted fault the encoder's and the cross calls made causal,
               read at the prefill;
  profile      (only when asked for) the fit, the headline fit, (after
               the train or select phase) one train step, (after
               the lm phase) one generate and (after the online phase) the
               stream's first 16 chunks again under torch.profiler: kernel
               time by name and the device busy share;
  basins       (only when asked for) which k-means optimum the kernel and
               the plain path reach on the online stream's first 8 chunks,
               under 6 keys and on data scaled by 1 + 2^-22; then k-means
               alone on each path's prototypes under 12 keys.

The kernel launch counts are set to 0 just before the fit and read after
the fit and after the serve phase, set to 0 again just before the tune
phase's tuned fit and read after its serve (K1-K4 must launch, K1 and
K2 on the plan's frozen route; K2 only where a level fits the plan's
row block), set to 0 again just before the
headline fit and read after it, just before the hac fit and read after
it, just before the three dbscan fits and read after them, just before
the online phase's stream and read after its refresh, just before the
steps of the train phase and of each train_* phase (none may launch),
just before the select phase's
two selections and read after them, and again just
before the generate of each of the lm, lm_moe, lm_hybrid, lm_vlm and
lm_encdec phases and read right after it (lm_encdec: K5 alone, 72
prefill calls and 48 a step); every kernel of
each path must have launched (K1-K4 in fit and serve; K1-K4 in select;
K1, K3 and K4 in
hac, K4 on its tiled instance for the (n, n) matrices of HAC and DBSCAN,
and in every dbscan fit; K1 and its bf16 and int8 key
instances, K3 and K4 in online, the quantized ones never on the CUDA-core
route at k <= 8; K2, K3 and K5 in lm, lm_moe and lm_hybrid, K5 once per
global attention layer of the prefill on its tensor-core tiled route
(route count K5/tiled_mma), and once per attention layer of every decode
step on its split-kv route, counted apart as K5-decode, K2 once per
attention layer, sequence and kv head of each compression). The hac,
dbscan, online and lm lines also list the
launches per route, and the kernels line K4's per path and instance.
Then one JSON line lists every kernel and variant (launches summed over
the paths),
the card's name and power limit are printed, and the last line is
``{"ok": true, "device": {...}}``. Any
failure raises and the script exits nonzero without that line; so does a
machine without a GPU, or a directory without the repository's ``src/``.
It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import ast
import atexit
import asyncio
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEFAULT_PHASES = ("device", "build", "kernels", "fit", "serve", "sharded", "tune",
                  "headline",
                  "determinism", "hac", "dbscan", "online", "train", "select",
                  "train_moe", "train_ssm", "train_hybrid", "train_vlm",
                  "train_encdec", "train_mesh", "mesh_tp", "lm", "dryrun", "lm_moe",
                  "lm_hybrid",
                  "lm_vlm",
                  "lm_encdec")
#: "profile" (not run by default): the fit and the headline fit once more
#: under torch.profiler — device time by kernel and the device's busy share
ALL_PHASES = DEFAULT_PHASES + ("profile", "basins")


def _peaks():
    """(f32, bf16, tf32 FLOP/s, B/s): the H100 SXM's data-sheet peaks, from
    the port's one source (repro_torch.utils.roofline; main puts src/ on
    the path)."""
    from repro_torch.utils import roofline

    by = roofline.PEAK_FLOPS_BY_DTYPE
    return by["float32"], by["bfloat16"], by["tf32"], roofline.HBM_BW


# distance tolerance, kernel vs plain version, both f32 on the card: they
# round |x|²+|y|²−2x·y in other orders (sequential fma vs cuBLAS and
# torch.sum), a few ulps of values up to ~100 on standardized data
DIST_TOL = dict(rtol=1e-5, atol=1e-4)
# segment sums: the plain version uses float atomics (any order) on the card
SUM_TOL = dict(rtol=1e-5, atol=1e-4)
# attention, kernel vs plain version: both fold in f32 (online vs dense
# softmax, sums over up to 2208 keys in other orders); in bf16 both round
# the output once, so they may land one bf16 ulp (2^-7 relative) apart
ATTN_TOL_F32 = dict(rtol=1e-5, atol=3e-5)
ATTN_TOL_BF16 = dict(rtol=2 ** -7, atol=1e-5)
# LM logits, the kernel path against two plain paths, each compressing its
# own cache: the same arithmetic (K5's plain version, f32 probabilities
# times v; plain K2/K3) and the reference's "xla" route (chunked attention,
# bf16 P·V products; plain K2/K3). Both within LOGIT_ULPS bf16 ulps of the
# largest |logit|, top-1 agreement >= 0.9: the route bound
# tests/test_torch_lm.py states, and on the card the readings of PERF.md
# section 2 (at most 23.3 ulps on either path) stay below it, while one
# decode step with K5's bias dropped (72 ulps) must exceed it
LOGIT_ULPS, MIN_TOP1 = 32, 0.9
# compressed caches, kernel vs plain compression of one cache: prototype
# slots within one bf16 ulp; TC may split a distance near-tie another way,
# which moves a few clusters, so >= 0.999 of the slots must agree
MIN_SLOT_AGREEMENT = 0.999

#: where the script runs and at what sizes (the main path's; a rehearsal
#: elsewhere may shrink them)
DEV = "cuda"
SIZES = dict(covertype=581_012, segments=193_670, blocked_q=8192,
             assign_q=2048, protos=2390, knn_n=7172, centres=7,
             gmm=1_000_000, det=65_536, lloyd_n=15_625)
#: the sharded phase: ranks on this card over gloo, the aligned rows (1944 x
#: 298: 579,312 -> 193,104 -> 64,368 -> 21,456 -> 7,152 -> 2,384, each a
#: multiple of 8), the stream's chunks (131,072 for stream_to_mesh; 132,192
#: = 1944 x 68 for streaming_sharded, whose per-chunk outputs of 44,064 and
#: five-chunk reservoir of 220,320 -> ... -> 2,720 divide by 8), queries
#: (not a multiple of the ranks: the pad path), the seconds a spawn may take
SHARDED = dict(ranks=4, aligned=579_312, t=3, m=5, k=7, stream_chunk=131_072,
               aligned_chunk=132_192, reservoir=220_320, queries=4_999,
               timeout=600.0, one_rank_backend="nccl")
#: the lm phase: gemma2-2b served at batch 4, prompt 2048, 160 new tokens,
#: compressed at t = 2, m = 1 with a 128-slot tail (cache 2208 slots, 1232
#: after the first compress), 8 teacher-forced steps in the parity check
LM = dict(arch="gemma2-2b", batch=4, prompt=2048, new_tokens=160, t=2, m=1,
          tail=128, forced_steps=8)
#: the lm_moe and lm_hybrid phases: the lm phase's traffic on
#: deepseek-moe-16b whole (28 layers, MHA 16 x 128, 64 experts top-6 + 2
#: shared) and on jamba-v0.1-52b at full width cut to its first 8 layers
#: (one period of its layer pattern: attention at layer 4, Mamba at the
#: other seven, MoE 16 experts top-2 at the odd layers: 26.5 GB of bf16
#: weights, where all 32 layers would be 104 GB), 32 teacher-forced steps
#: in the parity check (132 rows for the top-1 agreement); the hybrid phase
#: also serves mamba2-370m whole (no attention), its prefill and ssm_steps
#: teacher-forced decode steps held against its full forward
LM_MOE = dict(LM, arch="deepseek-moe-16b", forced_steps=32)
LM_HYBRID = dict(LM_MOE, arch="jamba-v0.1-52b", layers=8, ssm_arch="mamba2-370m",
                 ssm_steps=32)
#: the lm_vlm and lm_encdec phases: phi-3-vision-4.2b whole (32 layers, MHA
#: 32 x 96) at batch 2, each row the 256-token patch prefix of the stubbed
#: vision tower (VISION_PREFIX, repro_torch.models.frontends) and a 2048-
#: token prompt, 160 new tokens, compressed at t = 2, m = 1, tail 128 (2,304
#: valid of 2,464 slots, 1,360 after the first compress, one in flight;
#: batch 2, not 4: a compression's K2 and K3 calls are one a layer,
#: sequence and kv head, 2,048 at batch 2); seamless-m4t-large-v2 whole (24 + 24 layers, MHA 16 x
#: 64) at batch 4 over 2048 encoder frames (the stubbed speech encoder's
#: output), a 128-token decoder prompt and 160 new tokens, no compression
#: (an enc-dec cache is not compressed); 32 teacher-forced steps each
VISION_PREFIX = 256
LM_VLM = dict(LM, arch="phi-3-vision-4.2b", batch=2, forced_steps=32)
LM_ENCDEC = dict(LM, arch="seamless-m4t-large-v2", batch=4, prompt=128, frames=2048,
                 forced_steps=32)
#: the online phase: the blobs stream, its fit, the serve ladder and
#: request sizes, the refresh (a drifted stream: the shift of
#: benchmarks/bench_lifecycle.py), the open-loop traffic around it, and the
#: stand-in final index (its buffer rows) of the kernels phase's K1-variant
#: rows, which the online phase measures again on the real index
ONLINE = dict(n=10_485_760, d=6, k=7, chunk=131_072, t=3, m=4, depth=2,
              buckets=(32, 128, 512, 2048), sizes=(1, 100, 2048, 5000),
              reps={1: 40, 100: 40, 2048: 20, 5000: 20},
              refresh_points=1_048_576, drift_shift=6.0, qps=100.0,
              traffic_s=3.0, det_chunks=8, protos=5393, shortlist=8,
              basin_keys=6)
#: quantized vs exact labels, and kernel path vs plain path, both online
MIN_QUANT_AGREEMENT = 0.999
#: the online fits' quality, with the k-means seeding taken out: each fit's
#: final prototypes are clustered under SEED_RESTARTS keys and the lowest
#: inertia kept (one seeding lands the blob mixture in a worse optimum for
#: about half of all keys, on either path). Its labels must match the
#: generating blobs on >= MIN_BLOB_ACCURACY of the points (readings
#: 0.982-0.989 in the best optimum, the 80-chunk fit lowest, and at most
#: 0.792 in the others; PERF.md, PR 13), and the kernel path's lowest
#: inertia must lie within MAX_INERTIA_GAP of the plain path's (reading
#: -1.3 %; the next optimum is 27 % higher)
SEED_RESTARTS = 16
MIN_BLOB_ACCURACY = 0.97
MAX_INERTIA_GAP = 0.05

#: the hac phase: IHTC + ward HAC on the paper's GMM (n = SIZES["gmm"]), t 2,
#: k 3, m the first level whose prototype count fits the reference's HAC
#: budget (benchmarks/bench_table2_hac.py), found by a probe fit to probe_m
#: levels, then m + 1 and m + 2 as that benchmark's rows; accuracy >=
#: MIN_HAC_ACCURACY at each. Ward HAC's top merges move with the prototypes:
#: on an H100 the fit at m = 6 reads 0.896474, and the JAX package's HAC on
#: the same 2,470 prototypes gives the same labels (tests/
#: hac_reference_check.py on the --save-hac file), while m = 7 and 8 read
#: 0.9289 and 0.9137 (PERF.md). The JAX package on the CPU read
#: 0.9299 at n 8,000, m 2 and 0.9345 at n 20,000, m 3; the paper's k-means
#: headline 0.9239. The limit keeps the reference's own answer at m = 6 and
#: fails a broken linkage (complete reads 0.79 and single 0.50 there).
HAC = dict(t=2, k=3, linkage="ward", budget=4096, probe_m=8, extra_levels=2)
MIN_HAC_ACCURACY = 0.89
#: the dbscan phase: the covertype analog cut to 50,000 rows, eps the
#: median 4-NN distance of a 1,000-row subsample, min_pts 16, t 2, m 0-2
#: (benchmarks/bench_table9_dbscan.py)
DBSCAN = dict(n=50_000, t=2, ms=(0, 1, 2), min_pts=16.0, eps_rows=1000)
#: kernel path vs plain path labels of HAC (after best matching) and DBSCAN
MIN_BACKEND_AGREEMENT = 0.999
#: K4's edge cases past 32-bit offsets (n * m > 2^31), (n, m, d): the tiled
#: instance at 46,341^2 and the small-m one at 2^27 + 1000 rows x 16, each
#: about 8.6 GB of output
K4_BEYOND_2_31 = ((46_341, 46_341, 2), ((1 << 27) + 1000, 16, 1))
#: the train phase: gemma2-2b at full width, the launcher's b 8, s 256,
#: remat "block", 24 steps under the reference test's schedule (warm-up 5,
#: decay 60) at the default peak lr; the first repeat_steps again from the
#: seeded state; a checkpoint resume at the smoke config (5 + 5 vs 10)
TRAIN = dict(arch="gemma2-2b", seed=0, steps=24, repeat_steps=4, peak_lr=3e-4,
             warmup=5, decay=60, resume_steps=10, resume_at=5)
#: the reference test's criterion: the mean of the last four losses below
#: this share of the mean of the first four
MIN_LOSS_DROP = 0.92
#: the train_moe, train_ssm, train_hybrid, train_vlm and train_encdec
#: phases: each family at full width with the train phase's set-up (random
#: f32 weights from TRAIN's seed, AdamW under its schedule, remat "block",
#: the launcher's s 256), `steps` steps, the first repeat_steps again, a
#: resume at the family's smoke config. Depth is cut where 16 B a parameter
#: (f32 weights and gradients, AdamW's two moments) would not fit one
#: 80 GB card: deepseek-moe-16b to 4 layers (1 dense + 3 MoE, 64 experts
#: top-6 + 2 shared; 28 layers would be 262 GB), jamba to 2 (Mamba + dense,
#: Mamba + MoE 16 experts top-2; the first cut holding its attention layer
#: is 5 layers, 114 GB: its attention trains at smoke_config on the CPU
#: until ROADMAP Queue 1 item 7d). The batch is 8, cut to 4 for a phase
#: whose predicted peak passes 75 GB (none: PERF.md)
TRAIN_FAMILY = dict(steps=16, seq=256, batch=8)
#: log of the largest f32: exp overflows past it
EXP_F32_MAX_ARG = float(np.log(np.finfo(np.float32).max))
TRAIN_FAMILIES = {
    "train_moe": dict(arch="deepseek-moe-16b", layers=4, batch=8),
    "train_ssm": dict(arch="mamba2-370m", layers=0, batch=8),
    "train_hybrid": dict(arch="jamba-v0.1-52b", layers=2, batch=8),
    "train_vlm": dict(arch="phi-3-vision-4.2b", layers=0, batch=8),
    "train_encdec": dict(arch="seamless-m4t-large-v2", layers=0, batch=8),
}
#: the train_mesh phase: gemma2-2b at full width cut to 2 decoder layers
#: (0.7456e9 parameters) over four gloo ranks on the card (8 + 8/4 B a
#: parameter a rank, 7.5 GB; four ranks 30 GB), the train phase's batch (b 8,
#: s 256, remat "block", one 2-row microbatch a rank) and schedule, 3 steps
#: with a checkpoint after step 2; 2 of the ranks restore it for step 3;
#: rank 0 alone over NCCL (one spawn for all three); the compressed all-reduce on the layers' step-0 gradients (the
#: 590 M-parameter embedding left out), 16 feedback rounds on one matrix.
#: The phase fails past ``limit_s`` (60 s); its steps were cut from 4 to 3
#: to keep within it (PERF.md)
TRAIN_MESH = dict(arch="gemma2-2b", layers=2, ranks=4, elastic_ranks=2, steps=3,
                  save_at=2, batch=8, seq=256, rounds=16,
                  rounds_leaf="layers.0.attn.wo", one_rank_backend="nccl",
                  timeout=600.0, limit_s=60.0)
#: the mesh_tp phase: gemma2-2b cut as TRAIN_MESH cuts it over 8 gloo
#: ranks at (data 2, model 4) (a rank 186.4e6 parameters: a quarter of the
#: embedding and of the layers; 8 + 8/2 B each, 2.24 GB); the train phase's
#: batch, sequence, remat and schedule for ``steps`` steps against the
#: one-device step at ``data`` microbatches; the lm phase's traffic (batch
#: 4, prompt 2048, compressed at t 2, m 1) with its decode cut to 48 tokens
#: behind a 32-slot tail (still one in-flight recompression) and 8 forced
#: decode steps, as the lm phase's parity takes. The phase fails past
#: ``limit_s`` (40 s); at 160 tokens, a 128-slot tail and 32 forced steps
#: it read 31.9-52.3 s on one card as the host's speed varied (PERF.md)
MESH_TP = dict(arch="gemma2-2b", layers=2, data=2, model=4, batch=8, seq=256,
               steps=3, serve_batch=4, prompt=2048, new_tokens=48, t=2, m=1,
               tail=32, forced_steps=8, timeout=300.0, limit_s=40.0)
#: the dryrun phase: the lm decode step's cache (the compressed cache of
#: the lm phase's K5 decode row), timed repeats, the band of reckoned over
#: measured peak memory, and the phase's budget (seconds)
DRYRUN = dict(decode_cache=1232, reps=5, peak_ratio=(0.75, 1.33), limit_s=20.0)
#: gradients, losses and grad norms against the one-device step (bf16 ulps,
#: tests/test_torch_train.py)
GRAD_ULPS = 8
#: the reference's criteria (tests/test_distribution.py::
#: test_compressed_psum_error_feedback): each leaf's compressed mean within
#: this share of its largest exact mean; 16 rounds of error feedback
#: averaged below this share of the one-shot error
MAX_COMPRESS_REL_ERR = 0.02
MAX_FEEDBACK_RATIO = 0.6
#: the tune phase: timed runs per candidate of populate after its untimed
#: warm-up run (the median is kept; 3 took 75 s of the script's time limit,
#: where the routes the phase picks between differ by 3x), the cut shape the K1 routes are held against the plain version
#: at (queries x keys of the covertype analog), and the rows of the
#: onthefly plan's fit
TUNE = dict(repeats=1, check_q=4096, check_keys=65_536, onthefly_n=32_768)
#: tuned vs untuned covertype fit: label agreement (bitwise when every
#: winner is its kernel's default route)
MIN_TUNED_AGREEMENT = 0.999

#: the select phase: a synth_tokens corpus of n examples of seq + 1 tokens
#: (vocab 256,000), the reference's default SelectionConfig (t* 2, m 2,
#: dim 64), a deeper selection at m_deep (its 8,192-row level runs K2), then
#: `steps` weighted train steps of `batch` selected rows
SELECT = dict(n=65_536, seq=256, seed=1, m_deep=4, steps=8, batch=8)
#: kernel vs plain selection: per example, the same prototype, medoid and mass
MIN_SELECT_AGREEMENT = 0.999

KERNEL_META = {
    "K1": ("fused_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/fused_assign.py:61"),
    "K2": ("knn_topk", "src/repro_torch/csrc/topk.cu",
           "src/repro/kernels/knn_topk.py:25"),
    "K3": ("segment_sum", "src/repro_torch/csrc/segment_sum.cu",
           "src/repro/kernels/segment_sum.py:20"),
    "K4": ("pairwise_sq_l2", "src/repro_torch/csrc/pairwise_l2.cu",
           "src/repro/kernels/pairwise_l2.py:22"),
    "K5": ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:23"),
    "K5-decode": ("flash_attention_split_kv",
                  "src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:23"),
    "K5-prefill": ("flash_attention_tiled_mma",
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:23"),
    "K1-bf16": ("fused_topk_bf16", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/fused_assign.py:61"),
    "K1-int8": ("fused_topk_int8", "src/repro_torch/csrc/topk.cu",
                "src/repro/kernels/fused_assign.py:61"),
}


#: the top-k libraries' route codes (repro_topk_route, every key type)
TOPK_ROUTES = {0: "cuda_core", 1: "tc3xtf32", 2: "cuda_core_split"}
#: the flash-attention library's route codes (repro_flash_attention_route)
K5_ROUTES = {0: "tiled", 1: "split_kv", 2: "tiled_mma"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def dev(a) -> torch.Tensor:
    return torch.as_tensor(a).to(DEV)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds of device time per call of ``fn()``: the calls are
    queued behind a spin kernel (``torch.cuda._sleep``) that holds the
    card until the host has queued them all, so the CUDA events around
    them read the kernels back to back, not the host (a call of several
    small launches spends more on the host than on the device, and
    ``cuda_ms`` reads the host then)."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~60 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0):
    """(bound_ms, bound_by): the larger of the operations' time (``flops``
    at the f32 peak plus ``bf16_flops``, products of bf16 operands, at the
    bf16 tensor-core peak) and bytes at the memory rate."""
    f32, bf16, _, hbm = _peaks()
    t_ops = flops / f32 + bf16_flops / bf16
    t_bytes = nbytes / hbm
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def distance_bound(pairs: float, d: int, nbytes: float, *, f32_flops: float = 0.0,
                   bf16_operands: bool = False):
    """(bound_ms, bound_by) of a function that forms ``pairs`` squared
    distances max(‖x‖²+‖y‖²−2x·y, 0) of ``d`` features: the larger of the
    bytes' time and the least time of the two ways the card can do the
    operations, whatever route the kernel takes. On the CUDA cores d fma
    of the cross term plus the add, subtract and max (2·d + 3 a pair) at
    the f32 peak; on the tensor cores the cross term as three TF32
    products (3·2·d a pair at the TF32 peak; with ``bf16_operands``, bf16
    queries and keys, one bf16 product, 2·d a pair at the bf16 peak, is
    exact) beside the 3 a pair at the f32 peak. ``f32_flops``: other work
    at the f32 peak on either way (K4's norms)."""
    f32, bf16, tf32, hbm = _peaks()
    t_cuda_core = (pairs * (2 * d + 3) + f32_flops) / f32
    t_cross = (2 * d * pairs / bf16 if bf16_operands else 3 * 2 * d * pairs / tf32)
    t_ops = min(t_cuda_core, max(t_cross, (3 * pairs + f32_flops) / f32))
    t_bytes = nbytes / hbm
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bound(nq: int, p: int, d: int, nbytes: float, bf16_operands: bool = False):
    """(bound_ms, bound_by) of a top-k launch of ``nq`` queries against
    ``p`` keys (``distance_bound``)."""
    return distance_bound(float(nq) * p, d, nbytes, bf16_operands=bf16_operands)


def topk_mismatches(q, keys, got_d, got_i, ref_d, ref_i):
    """(index mismatches, of which not near-ties). A mismatch is a near-tie
    when the distance of the kernel's pick, recomputed in float64, is
    within DIST_TOL of the plain version's distance at that slot."""
    mism = (got_i != ref_i).nonzero()
    if mism.numel() == 0:
        return 0, 0
    r, s = mism[:, 0], mism[:, 1]
    gi = got_i[r, s].long()
    qd = q[r].double()
    kd = keys[gi.clamp_min(0)].double()
    true_d = ((qd - kd) ** 2).sum(1)
    ok = (gi >= 0) & torch.isclose(true_d, ref_d[r, s].double(),
                                   rtol=DIST_TOL["rtol"], atol=DIST_TOL["atol"])
    return int(mism.shape[0]), int((~ok).sum())


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    compile_s = _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.library(name)
    spills = {}
    for name in _cuda.SOURCES:
        log = _cuda.library_path(name).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        # ptxas -v: "... N bytes spill stores, M bytes spill loads" per function
        spills[name] = sum(int(v) > 0 for v in
                           re.findall(r"(\d+) bytes spill stores", text))
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         compile_seconds=round(compile_s, 3),
         functions_with_spills=spills)
    # registers and spills per instance: K1's tensor-core route and its
    # merge, the split route and its merge (each key type), K3's kernels,
    # the any-d top-k kernel (each key type), and K5's three routes
    for name, marker in (("topk", "topk_tc_kernel"), ("topk", "topk_merge_kernel"),
                         ("topk", "topk_split_kernel"),
                         ("topk", "topk_split_merge_kernel"),
                         ("topk_bf16", "topk_tc_kernel"),
                         ("topk_bf16", "topk_merge_kernel"),
                         ("topk_bf16", "topk_split_kernel"),
                         ("topk_int8", "topk_tc_kernel"),
                         ("topk_int8", "topk_merge_kernel"),
                         ("topk_int8", "topk_split_kernel"),
                         ("segment_sum", "_kernel"),
                         ("topk", "topk_chunked_kernel"),
                         ("topk_bf16", "topk_chunked_kernel"),
                         ("topk_int8", "topk_chunked_kernel"),
                         ("flash_attention", "flash_kernel"),
                         ("flash_attention", "flash_mma_kernel"),
                         ("flash_attention", "split_kv_kernel"),
                         ("flash_attention", "split_combine_kernel")):
        text = _cuda.library_path(name).with_suffix(".log").read_text()
        emit("ptxas", library=name, functions=_ptxas_usage(text, marker))
    _kernel_resources()


def _cuobjdump_usage(lib_path: Path, tools: Path) -> list:
    """(kernel, int template arguments, registers, static shared, stack,
    local bytes) of each function ``cuobjdump --dump-resource-usage``
    lists in one library, names demangled by ``cu++filt``."""
    out = subprocess.run([str(tools / "cuobjdump"), "--dump-resource-usage",
                          str(lib_path)], capture_output=True, text=True, timeout=120,
                         check=True).stdout
    rows = re.findall(r"Function ([^\s:]+):\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                      r"LOCAL:(\d+)", out)
    names = subprocess.run([str(tools / "cu++filt")], input="\n".join(r[0] for r in rows),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.split("\n")
    usage = []
    for (_, reg, stack, shared, local), name in zip(rows, names):
        # "void <unnamed>::topk_kernel<float, (int)32, (int)128>(const float *, ...)"
        head = re.sub(r"\((?:unsigned )?int\)|\(bool\)", "", name)
        m = re.match(r"(?:void\s+)?(?:[\w<>]+::)*(\w+)(?:<([^()]*)>)?\(", head)
        kernel = m.group(1) if m else name
        args = tuple(int(a) for a in (x.strip() for x in ((m and m.group(2)) or "").split(","))
                     if re.fullmatch(r"-?\d+", a))
        usage.append(dict(kernel=kernel, args=list(args), registers=int(reg),
                          shared=int(shared), stack=int(stack), local=int(local),
                          demangled=name))
    return usage


#: shared bytes the card reserves for the system in a block that uses
#: shared memory or barriers (sm_8x and sm_90: 1 KB,
#: cudaDevAttrReservedSharedMemoryPerBlock), which cuobjdump's SHARED adds
RESERVED_SHARED = 1024


def _shared_explained(got: int, e: dict):
    """How cuobjdump's static shared bytes ``got`` follow from the
    analyzer's entry ``e``: ``(reserve, dropped)`` — its declarations
    placed (less the arrays the compiler dropped, ``dropped``, because
    this instance never reads them), plus the system reserve or not — or
    None when nothing explains them."""
    import itertools

    from repro_torch.analysis.rules.pk import place

    decls = e["decls"]
    for k in range(len(decls) + 1):
        for gone in itertools.combinations(range(len(decls)), k):
            kept = [d for i, d in enumerate(decls) if i not in gone]
            for reserve in (RESERVED_SHARED, 0):
                if got == place(kept) + reserve:
                    return reserve, [decls[i][0] for i in gone]
    return None


def _kernel_resources() -> None:
    """Every built kernel's registers, static shared memory and stack /
    local (spill) bytes from cuobjdump, the static shared bytes held to
    the port's analyzer's reckoning (PK402's ``static_shared``) for every
    instance the analyzer evaluates: equal, up to the block's system
    reserve and the arrays an instance never reads (the compiler drops
    them; each named); the whole table goes to
    build/repro_torch/kernel_resources.json."""
    from repro_torch.analysis.context import CudaContext
    from repro_torch.analysis.rules.pk import static_shared
    from repro_torch.kernels import _cuda

    tools = Path(_cuda.nvcc()).parent
    table, compared, mismatches, unbuilt, summary = {}, 0, [], [], {}
    exact, dropped = 0, {}
    for name, (source, _) in _cuda.SOURCES.items():
        usage = _cuobjdump_usage(_cuda.library_path(name), tools)
        table[name] = usage
        built = {}
        for u in usage:
            built.setdefault((u["kernel"], tuple(u["args"])), set()).add(u["shared"])
        src = (_cuda.CSRC / source).read_text()
        seen = set()
        for kernel, entries in static_shared(CudaContext(source, src)).items():
            for e in entries:
                key = (kernel, tuple(e["args"]))
                if "bytes" not in e or key in seen:  # one int-argument instance once
                    continue
                seen.add(key)
                got = built.get(key)
                if got is None:
                    unbuilt.append(f"{name}:{kernel}{list(e['args'])}")
                    continue
                compared += 1
                how = [_shared_explained(g, e) for g in sorted(got)]
                if any(h is None for h in how):
                    mismatches.append({"library": name, "kernel": kernel,
                                       "args": list(e["args"]), "reckoned": e["bytes"],
                                       "cuobjdump": sorted(got)})
                    continue
                for _, gone in how:
                    if gone:
                        dropped[f"{name}:{kernel}{list(e['args'])}"] = gone
                    else:
                        exact += 1
        spills = sorted({f"{u['kernel']}{u['args']}" for u in usage
                         if u["local"] or u["stack"]})
        summary[name] = dict(functions=len(usage),
                             max_registers=max(u["registers"] for u in usage),
                             max_shared=max(u["shared"] for u in usage),
                             with_stack_or_local=spills)
    path = _cuda.BUILD_DIR / "kernel_resources.json"
    path.write_text(json.dumps(table, indent=1))
    emit("kernel_resources", libraries=summary, analyzer_compared=compared,
         analyzer_equal=exact, analyzer_arrays_dropped=dropped,
         reserved_shared=RESERVED_SHARED,
         analyzer_mismatches=mismatches, analyzer_not_built=sorted(set(unbuilt)),
         table=str(path.relative_to(ROOT)))
    check(compared > 0, "kernel_resources: no kernel instance compared with the analyzer")
    check(not mismatches, f"kernel_resources: the analyzer's static shared bytes "
          f"differ from cuobjdump's: {mismatches}")


def _ptxas_usage(log: str, marker: str) -> list:
    """(mangled name, registers, spill store bytes) of each entry function
    whose name holds ``marker``, from ``ptxas -v`` output."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        fn = block.split("'", 1)[0]
        if marker not in fn:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append({"function": fn, "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None})
    return out


def _analog(n: int, seed: int = 0):
    """(standardized covertype analog (n, 6) on the device, components)."""
    from repro_torch.core.prototypes import standardize
    from repro_torch.data import PAPER_DATASETS, dataset_analog

    spec = next(s for s in PAPER_DATASETS if s.name == "covertype")
    x, comp = dataset_analog(spec, seed=seed, max_n=n, return_components=True)
    return standardize(dev(x)), comp


def phase_kernels(results: dict) -> None:
    t0 = time.perf_counter()
    gen = np.random.default_rng(1)
    x, _ = _analog(SIZES["covertype"])
    bq, aq, npro = SIZES["blocked_q"], SIZES["assign_q"], SIZES["protos"]

    # K1 at the shapes the main path gives it. Level 0 of the fit launches
    # it with one 8192-row query block against all 581,632 rows of the
    # padded key set (pad rows invalid, self-excluded through q_gidx): take
    # a block from the middle, k = t - 1 = 2. That case dominates the fit;
    # its plain version, seconds a call, is timed on one call. Then 8192
    # queries against 8192 keys (k = 1, 2), and the assign shape (2048
    # queries against 2390 prototypes, k = 1).
    n_all = x.shape[0]
    n_pad = -(-n_all // bq) * bq
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n_all))
    vp = torch.arange(n_pad, device=DEV) < n_all
    q0 = (n_pad // bq // 2) * bq
    mid_gidx = torch.arange(q0, q0 + bq, dtype=torch.int32, device=DEV)
    cases = [(xp[q0:q0 + bq], xp, vp, mid_gidx, 2, 1)]
    for nq, p, k, self_excl in ((bq, bq, 1, True), (bq, bq, 2, True),
                                (aq, npro, 1, False)):
        keys = x[:p].contiguous() if self_excl else x[-p:].contiguous()
        gidx = (torch.arange(nq, dtype=torch.int32, device=DEV)
                if self_excl else None)
        cases.append((x[:nq].contiguous(), keys, dev(gen.random(p) > 0.05),
                      gidx, k, 10))
    for q, keys, valid, gidx, k, plain_reps in cases:
        row = _k1_row("fit", q, keys, valid, gidx, k, plain_reps)
        results.setdefault("K1", row)
    # the stream's shape: one 8192-row query block of a 131,072-point chunk
    # against the whole chunk (2,607 launches of the online run), k = t - 1
    xs, _ = _stream_chunk()
    _k1_row("online", xs[:bq].contiguous(), xs, None,
            torch.arange(bq, dtype=torch.int32, device=DEV), ONLINE["t"] - 1, 1)
    # the serve shape: the largest request against the final index, k = 1
    protos, pvalid, queries = _standin_index()
    _k1_row("serve", queries, protos, pvalid, None, 1, 10)
    # the headline fit's shapes: the paper's GMM at n = 10^6 and its next
    # two levels' sizes (5 * 10^5, 2.5 * 10^5), d 2, k = t - 1 = 1, one
    # 8192-row query block from the middle of the padded key set
    from repro_torch.data import gmm_sample

    g_all = dev(gmm_sample(SIZES["gmm"], seed=0)[0])
    for n in (SIZES["gmm"], SIZES["gmm"] // 2, SIZES["gmm"] // 4):
        n_pad = -(-n // bq) * bq
        gp = torch.nn.functional.pad(g_all[:n], (0, 0, 0, n_pad - n))
        q0 = (n_pad // bq // 2) * bq
        _k1_row("headline", gp[q0:q0 + bq].contiguous(), gp,
                torch.arange(n_pad, device=DEV) < n,
                torch.arange(q0, q0 + bq, dtype=torch.int32, device=DEV), 1, 1)
    del g_all

    _k1_variants(results, protos, pvalid, queries)

    # K2: the one-shot TC graph (level 4 of the fit: 7172 rows, under the
    # 8192-row blocking threshold)
    _k2_row("fit", x[:SIZES["knn_n"]].contiguous(), 2)
    _k2_compression(results)
    _k2_compression(results, d=128, path="lm_moe")
    _k2_compression(results, d=96, path="lm_vlm",
                    n=VISION_PREFIX + LM_VLM["prompt"] + LM_VLM["new_tokens"],
                    n_valid=VISION_PREFIX + LM_VLM["prompt"])

    # K3: the level-0 prototype reduce, 8 blocks of 72,627 rows into
    # 193,670 segments (ids include dropped ones); then the headline fit's
    # Lloyd statistics: 15,625 prototypes (10^6 / 4^3) of d = 2 into k = 3
    n, S = x.shape[0], SIZES["segments"]
    ids = dev(gen.integers(-1, S, size=n).astype(np.int32))
    w = dev(gen.integers(1, 4, size=n).astype(np.float32))
    results["K3"] = _k3_row("fit", x, ids, S, w)
    g2 = dev(gen.normal(size=(SIZES["lloyd_n"], 2)).astype(np.float32))
    _k3_row("lloyd", g2, dev(gen.integers(0, 3, size=g2.shape[0])), 3,
            dev(gen.integers(1, 9, size=g2.shape[0]).astype(np.float32)))

    # K4 at the four shapes its paths give it: k-means++/Lloyd over the
    # covertype fit's 2390 prototypes (7 centres) and over the headline's
    # 15,625 (3 centres); HAC's (n, n) matrix at the reference's 4,096-
    # prototype budget (bench_table2_hac.py); DBSCAN's at m = 0 on the
    # 50,000-row covertype analog (bench_table9_dbscan.py's max_n)
    from repro_torch.data import gmm_sample

    n, m = npro, SIZES["centres"]
    _k4_row("fit", x[:n].contiguous(), x[n:n + m].contiguous(), None)
    g = dev(gmm_sample(SIZES["lloyd_n"] + 3, seed=1)[0])
    _k4_row("lloyd", g[:-3].contiguous(), g[-3:].contiguous(),
            dev(np.array([True, True, True])))
    g = dev(gmm_sample(HAC["budget"], seed=2)[0])
    _k4_row("hac", g, g, None)
    del g
    xd = _dbscan_data()
    results["K4"] = _k4_row("dbscan", xd, xd, None)
    del xd
    torch.cuda.empty_cache()
    _k3_compression()
    _select_shapes()
    _k5_path_shapes(results)
    _k5_head_dim_128()
    _k5_vlm_encdec()
    _edge_checks(gen)
    _attention_edges()
    emit("kernels_done", seconds=round(time.perf_counter() - t0, 3))


#: the plain K1 fold's key tile in the kernels phase's K1 rows, against
#: the whole query block (the runtime's 256 x 512 tiles mirror the TPU
#: kernel's; there the rows' plain calls, host-bound, took 75-118 s of the
#: script's time limit). The fold's lists do not depend on its tiles (the
#: running list wins ties, then the earlier key); its distances differ by
#: the matmul's rounding at most, within DIST_TOL, as the tune phase's
#: check at whole tiles reads
PLAIN_BLOCK_K = 16_384


def _k1_row(path: str, q, keys, valid, gidx, k: int, plain_reps: int) -> dict:
    """K1 f32 at one of the main path's shapes against its plain version
    (at PLAIN_BLOCK_K tiles): distances within DIST_TOL, index mismatches
    only at near-ties; the kernel's time, its plain version's
    (``plain_reps`` calls) and the bound of the route it took."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import fused_assign as fa

    nq, p, d = q.shape[0], keys.shape[0], q.shape[1]
    route = fa.route(q.dtype, keys.dtype, d, k)
    check(TOPK_ROUTES[_cuda.library("topk").repro_topk_route(d, k)] == route,
          f"K1 route rule differs from the library's at d {d}, k {k}")
    gd, gi = fa.fused_topk(q, keys, k, valid, q_gidx=gidx)
    tiles = dict(block_q=nq, block_k=min(p, PLAIN_BLOCK_K))
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rd, ri = fa.fused_topk_plain(q, keys, k, valid, q_gidx=gidx, **tiles)
    end.record()
    end.synchronize()
    err = float((gd - rd).abs().max())
    mism, bad = topk_mismatches(q, keys, gd, gi, rd, ri)
    check(torch.allclose(gd, rd, **DIST_TOL), f"K1 ({path}) distances off: {err}")
    check(bad == 0, f"K1 ({path}): {bad} index mismatches that are not near-ties")
    ms = cuda_ms(lambda: fa.fused_topk(q, keys, k, valid, q_gidx=gidx))
    # one call (seconds at the fit's largest shapes): the checked call itself
    plain = (start.elapsed_time(end) if plain_reps == 1 else
             cuda_ms(lambda: fa.fused_topk_plain(q, keys, k, valid, q_gidx=gidx,
                                                 **tiles),
                     reps=plain_reps))
    # bytes: queries, keys, valid, q_gidx in; distances and indices out
    nbytes = ((nq + p) * d * 4 + (0 if valid is None else p)
              + (0 if gidx is None else nq * 4) + nq * k * 8)
    b_ms, b_by = k1_bound(nq, p, d, nbytes)
    dev_ms = device_ms(lambda: fa.fused_topk(q, keys, k, valid, q_gidx=gidx))
    row = dict(kernel="K1", path=path, variant=route, nq=nq, p=p, d=d, k=k,
               max_abs_err=err, index_mismatches=mism, ms=ms, device_ms=dev_ms,
               plain_ms=plain,
               plain_reps=plain_reps, plain_block_k=tiles["block_k"], bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    emit("kernels", **row)
    return row


def _k2_row(path: str, x, k: int) -> dict:
    """K2 (one-shot self-kNN, f32) at one of its paths' shapes against its
    plain version: distances within DIST_TOL, index mismatches only at
    near-ties; the kernel's time, the plain version's and the bound."""
    from repro_torch.kernels import fused_assign, knn_topk, ref

    n, d = x.shape
    gd, gi = knn_topk.knn_topk(x, k)
    rd, ri = ref.knn(x, k)
    sync()
    err = float((gd - rd).abs().max())
    mism, bad = topk_mismatches(x, x, gd, gi, rd, ri)
    check(torch.allclose(gd, rd, **DIST_TOL), f"K2 ({path}) distances off: {err}")
    check(bad == 0, f"K2 ({path}): {bad} index mismatches that are not near-ties")
    ms = cuda_ms(lambda: knn_topk.knn_topk(x, k))
    plain = cuda_ms(lambda: ref.knn(x, k))
    route = fused_assign.route(x.dtype, x.dtype, d, k)
    b_ms, b_by = k1_bound(n, n, d, n * d * 4 + n * k * 8)
    row = dict(kernel="K2", path=path, variant=route, n=n, d=d, k=k,
               max_abs_err=err, index_mismatches=mism, ms=ms, plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit("kernels", **row)
    return row


def _select_shapes() -> None:
    """K1-K4 at the select phase's shapes, on its kind of data: a
    synth_tokens corpus of SELECT["n"] examples pooled through an N(0, 1)
    table's first 64 columns (the train phase's table is drawn so) and
    standardized. K1 at level 0 (an 8192-row block from the middle against
    all rows, k = t* - 1 = 1, on the split route at d 64), K2 at the m 4
    selection's 8,192-row level, K3 at the level-0 reduce (8 blocks into
    n / 2 segments) and K4 at the medoid matrix (n x n / 4)."""
    from repro_torch import prng
    from repro_torch.core.prototypes import standardize
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.data.instance_selection import featurize

    n, bq = SELECT["n"], SIZES["blocked_q"]
    vocab = 256_000
    corpus = synth_tokens(prng.PRNGKey(SELECT["seed"]), n, SELECT["seq"], vocab,
                          DataConfig(), device=DEV)
    table = torch.randn((vocab, 64), generator=torch.Generator(DEV).manual_seed(0),
                        device=DEV)
    f = standardize(featurize(corpus, vocab, 64, embed_table=table))
    del corpus, table
    q0 = n // 2
    _k1_row("select", f[q0:q0 + bq].contiguous(), f, None,
            torch.arange(q0, q0 + bq, dtype=torch.int32, device=DEV), 1, 10)
    _k2_row("select", f[:bq].contiguous(), 1)
    g = torch.Generator(DEV).manual_seed(1)
    ids = torch.randint(0, n // 2, (n,), generator=g, device=DEV, dtype=torch.int32)
    _k3_row("select", f, ids, n // 2, torch.ones((n,), device=DEV))
    _k4_row("select", f, f[:n // 4].contiguous(), None)
    torch.cuda.empty_cache()


def _k4_row(path: str, x, y, valid) -> dict:
    """K4 at one of its paths' shapes against its plain version: distances
    within DIST_TOL (at n * m above 2^26 on row slices: the first 4,096
    rows and the last 1,024, whose offsets pass 2^31 at the DBSCAN shape),
    a repeat bitwise; its time between events and on the device, the plain
    version's, torch.cdist's (the square root of the same distances: a
    yardstick the port never calls) and the bound."""
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import pairwise_l2 as pw

    n, d = x.shape
    m = y.shape[0]
    route = pw.route(m, d)
    c_route = _cuda.library("pairwise_l2").repro_pairwise_sq_l2_route(m, d)
    check(("small_m", "tiled")[c_route] == route,
          f"K4: the wrapper's route {route} is not the kernel's ({c_route})")
    got = pw.pairwise_sq_l2(x, y, valid)
    if n * m <= 1 << 26:
        slices, rows = [slice(0, n)], "all"
    else:
        slices, rows = [slice(0, 4096), slice(n - 1024, n)], "first 4096, last 1024"
    err = 0.0
    for sl in slices:
        want = ref.pairwise_sq_l2(x[sl], y, y_valid=valid)
        check(torch.allclose(got[sl], want, **DIST_TOL),
              f"K4 distances off at {path} rows {sl}")
        err = max(err, float((got[sl] - want).abs().max()))
        del want
    check(torch.equal(pw.pairwise_sq_l2(x, y, valid), got), f"K4 repeat differs at {path}")
    del got
    torch.cuda.empty_cache()
    reps = 10 if n * m <= 1 << 26 else 5

    def k4():
        return pw.pairwise_sq_l2(x, y, valid)

    ms = cuda_ms(k4, reps=reps)
    dev_ms = device_ms(k4, reps=reps)
    plain = cuda_ms(lambda: ref.pairwise_sq_l2(x, y, y_valid=valid), reps=reps, warmup=1)
    torch.cuda.empty_cache()
    lib = cuda_ms(lambda: torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist"),
                  reps=reps, warmup=1)
    torch.cuda.empty_cache()
    b_ms, b_by = distance_bound(float(n) * m, d, (n + m) * d * 4 + n * m * 4
                                + (m if valid is not None else 0),
                                f32_flops=2 * (n + m) * d)
    row = dict(kernel="K4", path=path, variant=route, n=n, m=m, d=d,
               max_abs_err=err, err_rows=rows, bitwise_repeat=True, ms=ms,
               device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib, library="torch.cdist (use_mm_for_euclid_dist)")
    emit("kernels", **row)
    return row


def _dbscan_data() -> torch.Tensor:
    """The DBSCAN phase's rows on the device: the covertype analog cut to
    50,000 rows, unstandardized (bench_table9_dbscan.py)."""
    from repro_torch.data import PAPER_DATASETS, dataset_analog

    spec = next(s for s in PAPER_DATASETS if s.name == "covertype")
    return dev(dataset_analog(spec, seed=0, max_n=DBSCAN["n"]))


def _stream_chunk():
    """(chunk 0 of the online phase's blobs stream on the device, cfg)."""
    from repro_torch.data import PointStreamConfig, point_chunk

    cfg = PointStreamConfig(n=ONLINE["n"], d=ONLINE["d"], chunk=ONLINE["chunk"],
                            seed=0, kind="blobs", k=ONLINE["k"])
    return dev(point_chunk(cfg, 0)), cfg


def _k3_row(path: str, x, ids, S: int, w, n_blocks: int = 8) -> dict:
    """K3 under the n_blocks fold against its plain version: the bits of
    the plain version on the CPU (which folds each block's rows in row
    order), and within SUM_TOL of the plain version on the card (float
    atomics there); times of the kernel, the plain version and one
    ``index_add_`` of the same sums (float atomics, any order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as seg

    n, d = x.shape
    gs, gm = ops.blocked_segment_sum(x, ids, S, weights=w, n_blocks=n_blocks,
                                     impl="cuda")
    rs, rm = ops.blocked_segment_sum(x, ids, S, weights=w, n_blocks=n_blocks,
                                     impl="ref")
    sync()
    err = max(float((gs - rs).abs().max()), float((gm - rm).abs().max()))
    check(torch.allclose(gs, rs, **SUM_TOL) and torch.allclose(gm, rm, **SUM_TOL),
          f"K3 ({path}, d {d}) sums off: {err}")
    cs, cm = ops.blocked_segment_sum(x.cpu(), ids.cpu(), S, weights=w.cpu(),
                                     n_blocks=n_blocks, impl="ref")
    check(torch.equal(gs.cpu(), cs) and torch.equal(gm.cpu(), cm),
          f"K3 ({path}, d {d}) differs from the CPU plain version's bits")
    ms = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w,
                                                 n_blocks=n_blocks, impl="cuda"))
    plain = cuda_ms(lambda: ops.blocked_segment_sum(x, ids, S, weights=w,
                                                    n_blocks=n_blocks, impl="ref"))
    keep = (ids >= 0) & (ids < S)
    lib_ids = torch.where(keep, ids, S)
    src = torch.cat([x * w[:, None], w[:, None]], dim=1).contiguous()
    lib_out = torch.zeros((S + 1, d + 1), device=DEV)
    library = cuda_ms(lambda: lib_out.index_add_(0, lib_ids, src))
    # per row: d products and d + 1 sums; bytes: x, the ids at their width
    # and the weights in, (S, d) sums and (S,) masses out
    b_ms, b_by = bound(n * (2 * d + 1),
                       n * d * 4 + n * ids.element_size() + n * 4 + S * (d + 1) * 4)
    dev_ms = device_ms(lambda: ops.blocked_segment_sum(
        x, ids, S, weights=w, n_blocks=n_blocks, impl="cuda"))
    lib_dev_ms = device_ms(lambda: lib_out.index_add_(0, lib_ids, src))
    row = dict(kernel="K3", path=path, variant=seg.plan(n, S, n_blocks)[0],
               n=n, d=d, segments=S, blocks=n_blocks, max_abs_err=err,
               bit_equal_to_cpu_plain=True, ms=ms, device_ms=dev_ms,
               library_device_ms=lib_dev_ms, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=library)
    emit("kernels", **row)
    return row


def _standin_index():
    """(protos, valid, queries) shaped as the online phase's final index and
    its largest request: ONLINE["protos"] rows from the blobs stream, 5000
    queries from later in it."""
    from repro_torch.data import PointStreamConfig, point_chunk

    cfg = PointStreamConfig(n=ONLINE["n"], d=ONLINE["d"], chunk=ONLINE["chunk"],
                            seed=0, kind="blobs", k=ONLINE["k"])
    protos = dev(point_chunk(cfg, 0)[:ONLINE["protos"]])
    valid = torch.ones(protos.shape[0], dtype=torch.bool, device=DEV)
    queries = dev(point_chunk(cfg, 1)[:max(ONLINE["sizes"])])
    return protos, valid, queries


def _k1_variants(results: dict, protos, valid, queries, path="kernels") -> None:
    """K1's bf16 and int8 key instances at the serve shape (the largest
    request against the final index, the k = 8 shortlist), each against
    its plain version on the same packed buffer: distances within
    DIST_TOL, indices equal except at near-ties, a repeat bitwise; with the
    route taken (the library's rule too), the time between events and on
    the device, the bound of that route and, beside it, the CUDA-core
    count the earlier rows used. In the kernels phase also at d 64
    (synthetic keys and queries of the same counts: the split route)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import fused_assign as fa

    k = ONLINE["shortlist"]
    shapes = [(protos, queries, path)]
    if path == "kernels":
        g = torch.Generator(device=DEV).manual_seed(11)
        shapes.append((torch.randn((protos.shape[0], 64), generator=g, device=DEV),
                       torch.randn((queries.shape[0], 64), generator=g, device=DEV),
                       "kernels_d64"))
    for keys32, qs, label in shapes:
        nq, p, d = qs.shape[0], keys32.shape[0], keys32.shape[1]
        q8, scale, zero = fa.quantize_keys(keys32, valid)
        cases = {
            "K1-bf16": (qs.bfloat16(), keys32.bfloat16(), {}, 2, 2),
            "K1-int8": (qs, q8, dict(keys_scale=scale, keys_zero=zero), 4, 1),
        }
        for kid, (q, keys, kw, q_bytes, k_bytes) in cases.items():
            route = fa.route(q.dtype, keys.dtype, d, k)
            lib = _cuda.library(fa.KEY_TYPES[kid][0])
            check(TOPK_ROUTES[lib.repro_topk_route(d, k)] == route
                  and route == ("tc3xtf32" if d <= fa.TC_MAX_D else "cuda_core_split"),
                  f"{kid} at d {d}, k {k}: route {route}, library "
                  f"{lib.repro_topk_route(d, k)}")
            gd, gi = fa.fused_topk(q, keys, k, valid, **kw)
            again = fa.fused_topk(q, keys, k, valid, **kw)
            rd, ri = fa.fused_topk_plain(q, keys, k, valid, **kw)
            sync()
            err = float((gd - rd).abs().max())
            # near-ties judged on the keys as the kernel sees them (widened or
            # dequantized), in float64
            keys_f = (keys.float() * scale + zero) if kw else keys.float()
            mism, bad = topk_mismatches(q.float(), keys_f, gd, gi, rd, ri)
            check(torch.allclose(gd, rd, **DIST_TOL), f"{kid} ({label}) distances off: {err}")
            check(bad == 0, f"{kid} ({label}): {bad} index mismatches that are not near-ties")
            check(torch.equal(gd, again[0]) and torch.equal(gi, again[1]),
                  f"{kid} ({label}): a repeat differs")
            ms = cuda_ms(lambda: fa.fused_topk(q, keys, k, valid, **kw))
            dev_ms = device_ms(lambda: fa.fused_topk(q, keys, k, valid, **kw))
            plain = cuda_ms(lambda: fa.fused_topk_plain(q, keys, k, valid, **kw))
            # operations as for K1 f32 (the widening or dequantization is per
            # key element, not per pair); bytes: keys at their width, queries,
            # valid, scale and zero in, distances and indices out
            nbytes = (p * d * k_bytes + nq * d * q_bytes + p
                      + (2 * d * 4 if kw else 0) + nq * k * 8)
            b_ms, b_by = k1_bound(nq, p, d, nbytes, bf16_operands=kid == "K1-bf16")
            cc_ms, _ = bound(nq * p * (2 * d + 3), nbytes)
            row = dict(kernel=kid, path=label, variant=route, nq=nq, p=p, d=d, k=k,
                       max_abs_err=err, index_mismatches=mism, bitwise_repeat=True,
                       ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, bound_ms_cuda_core=cc_ms, library_ms=None)
            emit("kernels", **row)
            if label == path:
                results[kid] = row


def _head_keys(n: int, d: int, seed: int) -> torch.Tensor:
    """(n, d) f32 keys as one KV head holds them: bf16 values."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((n, d), generator=g, device=DEV).bfloat16().float()


def _k2_compression(results: dict, d: int = 256, path: str = "lm",
                    n: int = LM["prompt"] + LM["new_tokens"],
                    n_valid: int = LM["prompt"]) -> None:
    """K2 at a compression shape: one (batch, kv-head) cache of ``n``
    slots (2208: the lm phase's, K2's entry in the kernels line at d 256;
    the lm_moe and lm_hybrid phases' at d 128; phi-3-vision's 2464 at d 96)
    of width head_dim ``d``, the first ``n_valid`` written (valid), k = t -
    1 = 1, on the CUDA-core split route (its key ranges as the library
    counts them)."""
    from repro_torch.kernels import _cuda, fused_assign, knn_topk, ref

    k = LM["t"] - 1
    route = fused_assign.route(torch.float32, torch.float32, d, k)
    lib = _cuda.library("topk")
    splits, keys_per_split = fused_assign.split_plan(n, n)
    check(route == "cuda_core_split"
          and TOPK_ROUTES[lib.repro_topk_route(d, k)] == route
          and lib.repro_topk_split_count(n, n) == splits,
          f"K2 at d {d}: route {route}, library route "
          f"{lib.repro_topk_route(d, k)}, splits {lib.repro_topk_split_count(n, n)} "
          f"against {splits}")
    x = _head_keys(n, d, 3)
    valid = torch.arange(n, device=DEV) < n_valid
    gd, gi = knn_topk.knn_topk(x, k, valid)
    rd, ri = ref.knn(x, k, valid=valid)
    sync()
    ok = torch.isfinite(rd)
    err = float((gd[ok] - rd[ok]).abs().max())
    mism, bad = topk_mismatches(x, x, gd, gi, rd, ri)
    check(torch.equal(torch.isfinite(gd), ok), f"K2 (d {d}): filled slots differ")
    check(torch.allclose(gd[ok], rd[ok], rtol=1e-5, atol=1e-3),
          f"K2 (d {d}) distances off: {err}")
    check(bad == 0, f"K2 (d {d}): {bad} index mismatches that are not near-ties")
    ms = cuda_ms(lambda: knn_topk.knn_topk(x, k, valid))
    dev_ms = device_ms(lambda: knn_topk.knn_topk(x, k, valid))
    plain = cuda_ms(lambda: ref.knn(x, k, valid=valid))
    # per pair: d fma of the cross term + add, subtract, max; bytes: x and
    # valid in, distances and indices out
    b_ms, b_by = k1_bound(n, n, d, n * d * 4 + n + n * k * 8)
    row = dict(kernel="K2", path=path, variant=route, n=n, d=d, k=k,
               splits=splits, keys_per_split=keys_per_split,
               max_abs_err=err,
               index_mismatches=mism, ms=ms, device_ms=dev_ms,
               plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    if d == 256:
        results["K2"] = row
    emit("kernels", **row)


def _k3_compression() -> None:
    """K3 at the compression shapes: the keys (d 256) and the [k||v]
    payload (d 512) of one head of the lm phase, and the keys of one head
    of the lm_moe and lm_hybrid phases (d 128; their [k||v] is d 256), 2208
    rows into 1104 prototypes; phi-3-vision's keys (d 96) and [k||v] (d
    192), 2464 rows into 1232; through the 8-block fold."""
    gen = np.random.default_rng(4)
    n, S = LM["prompt"] + LM["new_tokens"], (LM["prompt"] + LM["new_tokens"]) // LM["t"]
    ids = dev(np.where(np.arange(n) < LM["prompt"], gen.integers(0, S, size=n), -1)
              .astype(np.int32))
    w = torch.ones(n, device=DEV)
    for d in (256, 512):
        _k3_row("lm", _head_keys(n, d, d), ids, S, w)
    _k3_row("lm_moe", _head_keys(n, 128, 128), ids, S, w)
    # phi-3-vision's: 2464 slots (prefix, prompt and new tokens), 2304
    # written, into 1232 prototypes; the keys (d 96) and [k||v] (d 192)
    n, valid = VISION_PREFIX + LM_VLM["prompt"] + LM_VLM["new_tokens"], \
        VISION_PREFIX + LM_VLM["prompt"]
    S = n // LM_VLM["t"]
    ids = dev(np.where(np.arange(n) < valid, gen.integers(0, S, size=n), -1)
              .astype(np.int32))
    w = torch.ones(n, device=DEV)
    for d in (96, 192):
        _k3_row("lm_vlm", _head_keys(n, d, d), ids, S, w)


def _attention_work(b, hq, hkv, lq, lk, dh, causal, elt, bias_heads):
    """(f32 flops, bf16 flops, bytes) attention needs per visible (query,
    key) pair: 2·dh for q·k, 2·dh for p·v and 8 for the logit's scale,
    softcap, bias, max, exp and sum; with ``causal`` the masked future half
    is not counted. With bf16 q and k (``elt`` 2) q·k is a product of bf16
    operands, exact in f32, so the card could run it on its bf16 tensor
    cores; p is f32, so p·v and the softmax count at the f32 peak. Bytes:
    q, k, v and the bias read once, the output written once."""
    i = np.arange(lq)
    visible = (np.clip(i + lk - lq + 1, 0, lk).sum() if causal else lq * lk)
    pairs = float(b * hq * visible)
    qk = pairs * 2 * dh
    f32 = pairs * (2 * dh + 8) + (0.0 if elt == 2 else qk)
    nbytes = (2 * b * hq * lq * dh + 2 * b * hkv * lk * dh) * elt + b * bias_heads * lk * 4
    return f32, (qk if elt == 2 else 0.0), nbytes


def _attn_inputs(b, hq, hkv, lq, lk, dh, dtype, seed, bias=None):
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = (torch.randn((b, hq, lq, dh), generator=g, device=DEV) * 4).to(dtype)
    k = torch.randn((b, hkv, lk, dh), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, lk, dh), generator=g, device=DEV).to(dtype)
    kb = None
    if bias is not None:
        hb = hq if bias == "q_heads" else hkv
        kb = torch.randn((b, hb, lk), generator=g, device=DEV)
        if bias == "masked":   # -1e30 entries scattered through the keys
            kb = torch.where(torch.rand((b, hb, lk), generator=g, device=DEV) < 0.1,
                             -1e30, kb)
        if bias == "first_tile":  # every key of the first 40 masked
            kb[..., :40] = -1e30
        if bias == "first_tile64":  # a whole 64-key tile of the tensor-core route
            kb[..., :64] = -1e30
        if bias == "masked_split":  # keys 64-127 (a whole split) and the tail
            kb[..., 64:128] = -1e30
            kb[..., lk - lk // 3:] = -1e30
    return q, k, v, kb


def _mma_attention_work(b, hq, lq, lk, dh, causal):
    """(bf16 tensor-core flops, f32 flops) of the tensor-core tiled route
    per visible (query, key) pair: q·k (2·dh) and p·v twice (p_hi and
    p_lo, 4·dh) as products of bf16 operands, and the 8 f32 operations of
    the logit and the softmax; the masked future half not counted."""
    i = np.arange(lq)
    visible = (np.clip(i + lk - lq + 1, 0, lk).sum() if causal else lq * lk)
    pairs = float(b * hq * visible)
    return pairs * 6 * dh, pairs * 8


def _k5_path_shapes(results: dict) -> None:
    """K5 at the lm phase's shapes: prefill of a global layer (causal, no
    bias) in the working type, bf16 (the tensor-core tiled route), and the
    same call in f32 (the tiled route); one decode step over the
    compressed cache (P = 1104 prototypes with log-mass bias, one written
    tail slot, the rest of the tail masked by the position mask; the
    split-kv route, its splits as the library counts them), in bf16 and, to
    the f32 tolerance, in f32. Each route's rule is the library's too; a
    second call must give the same bits. The bf16 prefill's bound is that
    of its tensor-core form (q·k and the two bf16 p·v at the bf16 peak);
    beside it, as ``bound_ms_f32_pv``, the count of the earlier rows: q·k
    at the bf16 peak and p·v at the f32 peak (the f32 p of the
    reference)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa

    B, hq, hkv, dh = LM["batch"], 8, 4, 256
    S, P = LM["prompt"], (LM["prompt"] + LM["new_tokens"]) // LM["t"]
    lk_dec = P + LM["tail"]
    bias = torch.full((B, hkv, lk_dec), -1e30, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(7)
    bias[..., :P] = torch.log(torch.randint(1, 5, (B, hkv, P), generator=g,
                                            device=DEV).float())
    bias[..., P] = 0.0
    shapes = (("K5-prefill", "prefill", (B, hq, hkv, S, S, dh), True, None, torch.bfloat16),
              ("K5", "prefill", (B, hq, hkv, S, S, dh), True, None, torch.float32),
              ("K5-decode", "decode", (B, hq, hkv, 1, lk_dec, dh), False, bias,
               torch.bfloat16))
    lib = _cuda.library("flash_attention")
    want_routes = {"K5-prefill": "tiled_mma", "K5": "tiled", "K5-decode": "split_kv"}
    for kid, label, (b, hq_, hkv_, lq, lk, d), causal, kb, dt in shapes:
        variant = fa.route(hq_, hkv_, lq, dt, d)
        lib_route = K5_ROUTES[lib.repro_flash_attention_route(
            hq_, hkv_, lq, int(dt == torch.bfloat16), d)]
        check(variant == want_routes[kid] and lib_route == variant
              and lib.repro_flash_attention_split_keys(lk) == fa.split_keys(lk),
              f"{kid} {label}: route {variant} (library {lib_route}) or its split "
              f"rule differs")
        q, k, v, _ = _attn_inputs(b, hq_, hkv_, lq, lk, d, torch.bfloat16, 8)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=50.0)
        tol = ATTN_TOL_BF16 if dt == torch.bfloat16 else ATTN_TOL_F32
        got = fa.flash_attention(q, k, v, kb, **kw)
        again = fa.flash_attention(q, k, v, kb, **kw)
        want = fa.flash_attention_plain(q, k, v, kb, **kw)
        sync()
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, again), f"{kid} {label}: a repeat differs")
        check(bool(torch.isfinite(got.float()).all()), f"{kid} {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"{kid} {label} ({dt}) off: {err}")
        row = dict(kernel=kid, path="lm", shape=label, variant=variant,
                   q=list(q.shape), kv=list(k.shape), causal=causal,
                   bias=kb is not None, dtype=str(dt).replace("torch.", ""),
                   max_abs_err=err, bitwise_repeat=True)
        if kid == "K5-decode":
            # the same call in f32, held to the f32 tolerance
            got32 = fa.flash_attention(q.float(), k.float(), v.float(), kb, **kw)
            want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), kb, **kw)
            err32 = float((got32 - want32).abs().max())
            check(torch.allclose(got32, want32, **ATTN_TOL_F32),
                  f"K5 {label} (f32) off: {err32}")
            row.update(max_abs_err_f32=err32, split_keys=fa.split_keys(lk),
                       splits=-(-lk // fa.split_keys(lk)))
            del got32, want32
        del got, again, want
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kb, **kw))
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, kb, **kw))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, kb, **kw))
        elt = 2 if dt == torch.bfloat16 else 4
        flops, tc_flops, nbytes = _attention_work(
            b, hq_, hkv_, lq, lk, d, causal, elt, 0 if kb is None else kb.shape[1])
        b_ms, b_by = bound(flops, nbytes, bf16_flops=tc_flops)
        if variant == "tiled_mma":
            mma_tc, mma_f32 = _mma_attention_work(b, hq_, lq, lk, d, causal)
            row["bound_ms_f32_pv"] = b_ms
            b_ms, b_by = bound(mma_f32, nbytes, bf16_flops=mma_tc)
        row.update(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, causal_half_counted=False, library_ms=None)
        emit("kernels", **row)
        results[kid] = row


def _decode_bias(b: int, h: int, P: int, tail: int, seed: int) -> torch.Tensor:
    """A decode step's bias over a compressed cache: log-masses of P
    prototypes, one written tail slot (0), the rest of the tail masked."""
    bias = torch.full((b, h, P + tail), -1e30, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed)
    bias[..., :P] = torch.log(torch.randint(1, 5, (b, h, P), generator=g,
                                            device=DEV).float())
    bias[..., P] = 0.0
    return bias


def _k5_head_dim_128() -> None:
    """K5 at the lm_moe and lm_hybrid phases' shapes (head_dim 128, no
    softcap): the bf16 prefill of one layer (causal, the tensor-core tiled
    route) at deepseek-moe-16b's MHA 16 x 16 and at jamba's GQA 32 x 8,
    and deepseek's decode step over the compressed cache (P = 1104
    prototypes with log-mass bias, one written tail slot, the rest
    masked; the split-kv route)."""
    B, dh = LM_MOE["batch"], 128
    S, P = LM_MOE["prompt"], (LM_MOE["prompt"] + LM_MOE["new_tokens"]) // LM_MOE["t"]
    bias = _decode_bias(B, 16, P, LM_MOE["tail"], 9)
    _k5_library_rows((
        ("K5-prefill", "prefill_dh128", "lm_moe", B, 16, 16, S, S, dh, True, None,
         "tiled_mma"),
        ("K5-prefill", "prefill_dh128_gqa", "lm_hybrid", B, 32, 8, S, S, dh, True,
         None, "tiled_mma"),
        ("K5-decode", "decode_dh128", "lm_moe", B, 16, 16, 1, P + LM_MOE["tail"], dh,
         False, bias, "split_kv")), seed=10)


def _k5_vlm_encdec() -> None:
    """K5 at the lm_vlm and lm_encdec phases' shapes (no softcap): phi-3-
    vision's prefill of one layer (q 2 x 32 x 2304 x 96: the 256-token
    patch prefix and the 2048-token prompt, causal) on the tensor-core
    route and, in f32, on the tiled route (where a bf16 call at head_dim
    96 went before it had a tensor-core instance), and its decode step at
    head_dim 96 over the compressed cache (P = 1232 prototypes with
    log-mass bias, one written tail slot, the rest masked); seamless's
    encoder call (4 x 16 x 2048 x 64, non-causal), its cross-attention
    prefill (128 queries over the 2048 encoder frames, non-causal) and
    decode (one query over them, no bias)."""
    v, e = LM_VLM, LM_ENCDEC
    S = VISION_PREFIX + v["prompt"]
    P = (S + v["new_tokens"]) // v["t"]
    bias = _decode_bias(v["batch"], 32, P, v["tail"], 11)
    F, T = e["frames"], e["prompt"]
    _k5_library_rows((
        ("K5-prefill", "prefill_dh96", "lm_vlm", v["batch"], 32, 32, S, S, 96, True,
         None, "tiled_mma"),
        ("K5", "prefill_dh96_f32", "lm_vlm", v["batch"], 32, 32, S, S, 96, True,
         None, "tiled"),
        ("K5-decode", "decode_dh96", "lm_vlm", v["batch"], 32, 32, 1, P + v["tail"],
         96, False, bias, "split_kv"),
        ("K5-prefill", "encoder_dh64", "lm_encdec", e["batch"], 16, 16, F, F, 64,
         False, None, "tiled_mma"),
        ("K5-prefill", "cross_prefill_dh64", "lm_encdec", e["batch"], 16, 16, T, F,
         64, False, None, "tiled_mma"),
        ("K5-decode", "cross_decode_dh64", "lm_encdec", e["batch"], 16, 16, 1, F, 64,
         False, None, "split_kv")), seed=12)


def _k5_library_rows(cases, seed: int) -> None:
    """Each case (kernel id, label, path, b, hq, hkv, lq, lk, dh, causal,
    bias, route), bf16 unless the route is "tiled" (f32): K5 against its
    plain version, a repeat bitwise, then its time, the plain version's
    and, without a softcap, one PyTorch call's that computes the same
    function: ``scaled_dot_product_attention`` (kv heads shared with
    ``enable_gqa``; a bias as an ``attn_mask`` in q's type, so its output
    is not the same bits), timed as the library column, its largest
    difference from the plain version reported."""
    from repro_torch.kernels import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for kid, label, path, B, hq, hkv, lq, lk, dh, causal, kb, want_route in cases:
        dt = torch.float32 if want_route == "tiled" else torch.bfloat16
        variant = fa.route(hq, hkv, lq, dt, dh)
        check(variant == want_route, f"{kid} {label}: route {variant}")
        q, k, v, _ = _attn_inputs(B, hq, hkv, lq, lk, dh, dt, seed)
        scale = 1.0 / dh ** 0.5
        kw = dict(causal=causal, scale=scale, logit_softcap=0.0)
        got = fa.flash_attention(q, k, v, kb, **kw)
        again = fa.flash_attention(q, k, v, kb, **kw)
        want = fa.flash_attention_plain(q, k, v, kb, **kw)
        mask = None if kb is None else kb[:, :, None, :].to(dt)
        lib = lambda: sdpa(q, k, v, attn_mask=mask, is_causal=causal,  # noqa: E731
                           scale=scale, enable_gqa=hq != hkv)
        lib_err = float((lib().float() - want.float()).abs().max())
        sync()
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL_BF16 if dt == torch.bfloat16 else ATTN_TOL_F32
        check(torch.equal(got, again), f"{kid} {label}: a repeat differs")
        check(bool(torch.isfinite(got.float()).all()), f"{kid} {label}: non-finite")
        check(torch.allclose(got.float(), want.float(), **tol),
              f"{kid} {label} off: {err}")
        del got, again, want
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kb, **kw))
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, kb, **kw))
        plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, kb, **kw))
        library = cuda_ms(lib)
        lib_dev = device_ms(lib)
        elt = 2 if dt == torch.bfloat16 else 4
        flops, tc_flops, nbytes = _attention_work(
            B, hq, hkv, lq, lk, dh, causal, elt, 0 if kb is None else kb.shape[1])
        b_ms, b_by = bound(flops, nbytes, bf16_flops=tc_flops)
        row = dict(kernel=kid, path=path, shape=label, variant=variant,
                   q=list(q.shape), kv=list(k.shape), causal=causal,
                   bias=kb is not None, dtype=str(dt).replace("torch.", ""),
                   max_abs_err=err, bitwise_repeat=True, library_max_abs_err=lib_err)
        if variant == "tiled_mma":
            mma_tc, mma_f32 = _mma_attention_work(B, hq, lq, lk, dh, causal)
            row["bound_ms_f32_pv"] = b_ms
            b_ms, b_by = bound(mma_f32, nbytes, bf16_flops=mma_tc)
        elif variant == "split_kv":
            row.update(split_keys=fa.split_keys(lk), splits=-(-lk // fa.split_keys(lk)))
        row.update(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, causal_half_counted=False, library_ms=library,
                   library_device_ms=lib_dev)
        emit("kernels", **row)
        del q, k, v


def _edge_checks(gen) -> None:
    """Every kernel against its plain version on awkward shapes with
    dyadic-grid data (multiples of 1/4: every distance and partial sum is
    exact in f32, and ties are common), where the two must agree bit for
    bit, tie-breaking included: d = 1 and d > 32, k = 1 and k = 32, k > p,
    masked keys, self-exclusion, out-of-range segment ids."""
    from repro_torch.kernels import fused_assign, knn_topk, ops, ref

    def grid(*shape):
        return dev((gen.integers(-16, 17, size=shape) * 0.25).astype(np.float32))

    cases = 0
    for nq, p, d, k in ((7, 33, 1, 1), (33, 17, 5, 3), (9, 9, 2, 9),
                        (40, 70, 33, 32), (300, 1000, 6, 2), (5, 3, 4, 8),
                        (40, 130, 256, 2), (33, 65, 512, 32), (70, 200, 300, 1)):
        q, keys = grid(nq, d), grid(p, d)
        valid = dev(gen.random(p) > 0.3)
        gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
        for v, g in ((None, None), (valid, gidx)):
            got = fused_assign.fused_topk(q, keys, k, v, q_gidx=g)
            want = fused_assign.fused_topk_plain(q, keys, k, v, q_gidx=g)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K1 differs from its plain version at {(nq, p, d, k)}")
            cases += 1
    cases += _variant_edges(gen, grid)
    cases += _k1_tc_edges(gen, grid)
    cases += _k2_split_edges(gen)
    cases += _k3_edges(gen)
    for n, d, k in ((17, 1, 16), (200, 6, 2), (64, 40, 5), (300, 256, 1),
                    (100, 512, 3)):
        x = grid(n, d)
        valid = dev(gen.random(n) > 0.2)
        for v in (None, valid):
            got, want = knn_topk.knn_topk(x, k, v), ref.knn(x, k, valid=v)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K2 differs from its plain version at {(n, d, k)}")
            cases += 1
    for n, d, s in ((7, 1, 1), (1000, 6, 37), (333, 3, 500), (500, 40, 37),
                    (300, 512, 20)):
        x = grid(n, d)
        ids = dev(gen.integers(-1, s + 1, size=n))
        w = dev((gen.integers(1, 5, size=n) * 0.5).astype(np.float32))
        got = ops.blocked_segment_sum(x, ids, s, weights=w, impl="cuda")
        want = ops.blocked_segment_sum(x, ids, s, weights=w, impl="ref")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K3 differs from its plain version at {(n, d, s)}")
        cases += 1
    cases += _k4_edges(gen, grid)
    sync()
    emit("kernels_edges", cases=cases, bitwise=True)


def _k4_edges(gen, grid) -> int:
    """K4 against its plain version, bit for bit, on dyadic grids: m in
    {1, 3, 7, 8, 9, 16, 17} x d in {1, 2, 6, 37, 64, 65, 200} (both
    instances and their boundary; m not a multiple of 4 leaves rows off the
    float4 alignment), tile edges, every key invalid, and n * m > 2^31 on
    each instance, compared on the first and the last rows."""
    from repro_torch.kernels import pairwise_l2 as pw
    from repro_torch.kernels import ref

    def same(x, y, valid, rows=None):
        got = pw.pairwise_sq_l2(x, y, valid)
        for sl in rows or [slice(0, x.shape[0])]:
            check(torch.equal(got[sl], ref.pairwise_sq_l2(x[sl], y, y_valid=valid)),
                  f"K4 differs from its plain version at {(x.shape[0], y.shape[0], x.shape[1])}"
                  f" rows {sl}")
        return 1

    cases = 0
    for m in (1, 3, 7, 8, 9, 16, 17):
        for d in (1, 2, 6, 37, 64, 65, 200):
            x, y = grid(37, d), grid(m, d)
            cases += same(x, y, None) + same(x, y, dev(gen.random(m) > 0.3))
    for n, m, d in ((64, 128, 6), (65, 129, 6), (130, 131, 3), (1, 257, 2),
                    (200, 18, 33), (7, 9, 1), (100, 7, 6), (33, 65, 40),
                    (300, 1000, 2)):
        cases += same(grid(n, d), grid(m, d), dev(gen.random(m) > 0.3))
    for n, m, d in ((50, 5, 3), (70, 300, 6)):
        got = pw.pairwise_sq_l2(grid(n, d), grid(m, d), dev(np.zeros(m, bool)))
        check(bool(torch.isinf(got).all()), "K4: an invalid key got a finite distance")
        cases += 1
    g = torch.Generator(device=DEV).manual_seed(11)
    for n, m, d in K4_BEYOND_2_31:
        x = torch.randint(-16, 17, (n, d), generator=g, device=DEV).float() * 0.25
        y = x[:m].clone() if m == n else grid(m, d)
        cases += same(x, y, None, rows=[slice(0, 1024), slice(n - 1024, n)])
        del x, y
        torch.cuda.empty_cache()
    return cases


def _k1_tc_edges(gen, grid) -> int:
    """K1 f32 on the tensor-core route (3xTF32) against its plain version:
    d in {1, 2, 6, 8, 9, 32}, k in {1, 2, 8}, query and key counts that fill
    no tile or split; bit for bit on dyadic grids (the split is exact there)
    with duplicate keys (ties go to the lowest index), masks, every key
    invalid (inf / -1), self-exclusion; then rows of magnitude about 10^3
    within DIST_TOL, indices equal except at near-ties. That last case runs
    at d = 8 and 32: at d <= 6 the f32 formula |x|^2 + |y|^2 - 2 x.y itself
    loses more than DIST_TOL to cancellation at the nearest keys, whatever
    the route (an exactly rounded cross term lands more than DIST_TOL from
    the plain version there; tests/test_torch_topk_tc.py)."""
    from repro_torch.kernels import fused_assign as fa

    cases = 0
    for d in (1, 2, 6, 8, 9, 32):
        for k in (1, 2, 8):
            check(fa.route(torch.float32, torch.float32, d, k) == "tc3xtf32",
                  f"K1 at d {d}, k {k} does not take the tensor-core route")
            for nq, p in ((130, 1100), (70, 3000), (5, 3)):
                q = grid(nq, d)
                base = grid(max(p // 3, 1), d)
                keys = base[dev(gen.integers(0, base.shape[0], size=p))]  # duplicates
                valid = dev(gen.random(p) > 0.3)
                gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
                none = torch.zeros(p, dtype=torch.bool, device=DEV)
                runs = ((None, None), (valid, gidx), (none, None))
                for v, g in runs:
                    got = fa.fused_topk(q, keys, k, v, q_gidx=g)
                    want = fa.fused_topk_plain(q, keys, k, v, q_gidx=g)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"K1 (tc) differs from its plain version at {(nq, p, d, k)}")
                    cases += 1
                check(bool(torch.isinf(got[0]).all() and (got[1] == -1).all()),
                      f"K1 (tc) with every key invalid at {(nq, p, d, k)}")
            # self-exclusion on the K2 layout: keys = queries, q_gidx = arange
            x = grid(500, d)
            self_g = torch.arange(500, dtype=torch.int32, device=DEV)
            got = fa.fused_topk(x, x, k, None, q_gidx=self_g)
            want = fa.fused_topk_plain(x, x, k, None, q_gidx=self_g)
            check(all(torch.equal(a, b) for a, b in zip(got, want))
                  and not bool((got[1] == self_g[:, None]).any()),
                  f"K1 (tc) self-exclusion at d {d}, k {k}")
            cases += 1
    worst = 0.0
    for d in (8, 32):
        q = dev((gen.normal(size=(3000, d)) * 1e3).astype(np.float32))
        keys = dev((gen.normal(size=(5000, d)) * 1e3).astype(np.float32))
        for k in (1, 8):
            gd, gi = fa.fused_topk(q, keys, k)
            rd, ri = fa.fused_topk_plain(q, keys, k)
            sync()
            err = float((gd - rd).abs().max())
            _, bad = topk_mismatches(q, keys, gd, gi, rd, ri)
            check(torch.allclose(gd, rd, **DIST_TOL),
                  f"K1 (tc) at |x| ~ 1e3, d {d}: distances off by {err}")
            check(bad == 0, f"K1 (tc) at |x| ~ 1e3, d {d}: {bad} index "
                            f"mismatches that are not near-ties")
            worst = max(worst, float(((gd - rd).abs()
                                      / (DIST_TOL["atol"] + DIST_TOL["rtol"] * rd.abs())).max()))
            cases += 1
    emit("kernels_edges", kernel="K1", variant="tc3xtf32", cases=cases,
         large_magnitude_err_over_tol=worst)
    return cases


def _k2_split_edges(gen) -> int:
    """K2 on the CUDA-core split route (f32, d > 32, k <= 8) against its
    plain version, bit for bit: d in {33, 64, 256, 512}, k in {1, 2, 8},
    n = 200 and 700 (ranges of 64 keys, the last short), a coarse dyadic
    grid (many exact ties) with the rows on both sides of every range
    boundary equal (ties across ranges go to the lowest index), with and
    without masked rows; the self-exclusion holds."""
    from repro_torch.kernels import fused_assign, knn_topk, ref

    cases = 0
    for d in (33, 64, 256, 512):
        for k in (1, 2, 8):
            check(fused_assign.route(torch.float32, torch.float32, d, k)
                  == "cuda_core_split", f"K2 at d {d}, k {k} is not on the split route")
            for n in (200, 700):
                _, per = fused_assign.split_plan(n, n)
                x = (gen.integers(-2, 3, size=(n, d)) * 0.25).astype(np.float32)
                for b in range(per, n, per):
                    x[b - 2:b + 2] = x[b - 3]
                x = dev(x)
                valid = dev(gen.random(n) > 0.25)
                for v in (None, valid):
                    got, want = knn_topk.knn_topk(x, k, v), ref.knn(x, k, valid=v)
                    check(all(torch.equal(a, b) for a, b in zip(got, want))
                          and not bool((got[1] == torch.arange(n, device=DEV)[:, None]).any()),
                          f"K2 (split) differs from its plain version at {(n, d, k)}")
                    cases += 1
    emit("kernels_edges", kernel="K2", variant="cuda_core_split", cases=cases,
         bitwise=True)
    return cases


def _k3_edges(gen) -> int:
    """K3 bit for bit against the plain version on the CPU (the contract),
    on continuous data, where any other fold order shows: S = 1; every id
    dropped; n < n_blocks; one segment holding every row (a run that fits
    the block-wide sort, 5,000 rows, and one longer than it, 20,000 rows,
    which walks every row); runs of exactly 32/33, 64/65, 256/257 and
    8192/8193 rows (the capacities of the group sort and the block sort);
    a segment whose rows skip blocks; ids -5, S, S + 7 and int64 ids above
    2^31; d in {1, 6, 31, 32, 256, 512}; n_blocks 1, 3 and 8."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_sum as seg

    def case(x, ids, S, w, n_blocks, label):
        got = seg.blocked_segment_sum(x, ids, S, w, n_blocks=n_blocks)
        want = ref.blocked_segment_sum(x.cpu(), ids.cpu(), S,
                                       weights=None if w is None else w.cpu(),
                                       n_blocks=n_blocks)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"K3 differs from the CPU plain version's bits: {label}, "
              f"d {x.shape[1]}, n {x.shape[0]}, S {S}, n_blocks {n_blocks}")

    def data(n, d):
        return (dev(gen.normal(size=(n, d)).astype(np.float32)),
                dev(gen.random(n).astype(np.float32) + 0.5))

    cases = 0
    for d in (1, 6, 31, 32, 256, 512):
        for n_blocks in (1, 3, 8):
            n = 3000
            x, w = data(n, d)
            for S in (1, 37, 500):
                ids = gen.integers(-1, S + 1, size=n)
                ids[:4] = (-5, S, S + 7, 2 ** 31 + 3)
                ids[4:8] = 2 ** 33 + np.arange(4)  # int64 ids far out of range
                case(x, dev(ids), S, w, n_blocks, "random ids")
                case(x, dev(ids.clip(-1, S).astype(np.int32)), S, None, n_blocks,
                     "i32 ids, no weights")
                cases += 2
            # runs of the group sort's and block sort's capacities
            lens = [32, 33, 64, 65, 256, 257, 1, 2]
            if d == 6 and n_blocks == 8:
                lens += [8192, 8193]
            ids = np.repeat(np.arange(len(lens)), lens)
            ids = np.concatenate([ids, gen.integers(len(lens), 300, size=2000)])
            gen.shuffle(ids)
            x, w = data(ids.shape[0], d)
            case(x, dev(ids), 300, w, n_blocks, "run lengths")
            cases += 1
        # a segment whose rows lie in blocks 0 and 5 of 8 only
        n = 8000
        ids = gen.integers(1, 120, size=n)
        ids[[3, 17, 500, 5200, 5300]] = 0
        x, w = data(n, d)
        case(x, dev(ids), 120, w, 8, "empty blocks inside a run")
        cases += 1
    for d in (1, 6, 256):
        for n_blocks in (1, 8):
            # every id dropped
            x, w = data(1000, d)
            case(x, dev(np.full(1000, -1)), 100, w, n_blocks, "all dropped")
            # n < n_blocks
            x3, w3 = data(3, d)
            for S in (2, 100):
                case(x3, dev(np.array([0, 1, 0]) % S), S, w3, 8, "n < n_blocks")
            # one segment holding every row: the block sort, the walk, few
            for n, S in ((5000, 1000), (20000, 1000), (20000, 1)):
                x, w = data(n, d)
                case(x, dev(np.full(n, S - 1)), S, w, n_blocks, "one segment")
            cases += 6
    emit("kernels_edges", kernel="K3", cases=cases, bitwise_to_cpu_plain=True)
    return cases


def _variant_edges(gen, grid) -> int:
    """K1's bf16 and int8 key instances against their plain versions, bit
    for bit, on every route: the tensor-core route (d 2, 6, 8, 16, 32;
    k <= 8), the split route (d 33, 64, 130, 256; k <= 8) and the CUDA-core
    kernels (k 20). Dyadic keys and queries (exact in bf16; int8 values in
    [-16, 16] with scales 1/4 or 1/2 and dyadic zero points, so every
    dequantized value, product and sum of 256 squares is exact in f32),
    coarse grids and duplicate keys that force distance ties (the lowest
    index wins), masks, every key invalid (inf / -1), self-exclusion
    through q_gidx and on the K2 layout (keys = queries), query and key
    counts that fill no tile or split; and the FMA case: q8 = 127 with
    scale 1 + 2^-23 and zero -127 gives 2^-16 by a rounded multiply then an
    add, 127·2^-23 by one fused multiply-add, so a zero query must see
    every valid key at d·2^-32."""
    from repro_torch.kernels import fused_assign

    cases = 0
    shapes = [(nq, p, k) for nq, p in ((130, 1100), (70, 3000), (5, 3)) for k in (1, 2, 8)]
    shapes += [(33, 70, 1), (40, 129, 3), (9, 300, 8), (70, 65, 20)]
    for d in (2, 6, 8, 16, 32, 33, 64, 130, 256):
        for nq, p, k in shapes:
            valid = dev(gen.random(p) > 0.3)
            gidx = dev(gen.integers(0, 2 * p, size=nq).astype(np.int32))
            none = torch.zeros(p, dtype=torch.bool, device=DEV)
            lim = 2 if k >= 8 else 16  # a coarse grid: many exact ties
            qb = dev((gen.integers(-lim, lim + 1, size=(nq, d)) * 0.25)
                     .astype(np.float32))
            pick = gen.integers(0, max(p // 3, 1), size=p)  # duplicate rows
            kb = dev((gen.integers(-lim, lim + 1, size=(max(p // 3, 1), d)) * 0.25)
                     [pick].astype(np.float32))
            q8 = dev(gen.integers(-16, 17, size=(max(p // 3, 1), d))[pick].astype(np.int8))
            scale = dev((2.0 ** -gen.integers(1, 3, size=d)).astype(np.float32))
            zero = dev((gen.integers(-8, 9, size=d) * 0.25).astype(np.float32))
            want_route = ("cuda_core" if k > fused_assign.TC_MAX_K else
                          "tc3xtf32" if d <= fused_assign.TC_MAX_D else "cuda_core_split")
            runs = [(qb.bfloat16(), kb.bfloat16(), {}),
                    (qb, q8, dict(keys_scale=scale, keys_zero=zero))]
            for q, keys, kw in runs:
                check(fused_assign.route(q.dtype, keys.dtype, d, k) == want_route,
                      f"K1 {keys.dtype} at d {d}, k {k} is not on {want_route}")
                for v, g in ((None, None), (valid, gidx), (none, None)):
                    got = fused_assign.fused_topk(q, keys, k, v, q_gidx=g, **kw)
                    want = fused_assign.fused_topk_plain(q, keys, k, v,
                                                         q_gidx=g, **kw)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"K1 ({keys.dtype}, q {q.dtype}, {want_route}) differs "
                          f"from its plain version at {(nq, p, d, k)}, masked "
                          f"{v is not None}")
                    cases += 1
                check(bool(torch.isinf(got[0]).all() and (got[1] == -1).all()),
                      f"K1 ({keys.dtype}) with every key invalid at {(nq, p, d, k)}")
        # the K2 layout: keys = queries (as the kernel reads them), q_gidx =
        # arange
        q8 = dev(gen.integers(-16, 17, size=(300, d)).astype(np.int8))
        scale = dev((2.0 ** -gen.integers(1, 3, size=d)).astype(np.float32))
        zero = dev((gen.integers(-8, 9, size=d) * 0.25).astype(np.float32))
        x = grid(300, d)
        self_g = torch.arange(300, dtype=torch.int32, device=DEV)
        for k in (1, 2, 8):
            for q, keys, kw in ((x.bfloat16(), x.bfloat16(), {}),
                                (q8.float() * scale + zero, q8,
                                 dict(keys_scale=scale, keys_zero=zero))):
                got = fused_assign.fused_topk(q, keys, k, None, q_gidx=self_g, **kw)
                want = fused_assign.fused_topk_plain(q, keys, k, None, q_gidx=self_g, **kw)
                check(all(torch.equal(a, b) for a, b in zip(got, want))
                      and not bool((got[1] == self_g[:, None]).any()),
                      f"K1 ({keys.dtype}) self-exclusion at d {d}, k {k}")
                cases += 1
        # the FMA case
        p, k = 50, 8
        q8 = torch.full((p, d), 127, dtype=torch.int8, device=DEV)
        scale = torch.full((d,), 1 + 2.0 ** -23, device=DEV)
        zero = torch.full((d,), -127.0, device=DEV)
        valid = dev(gen.random(p) > 0.5)
        q = torch.zeros((5, d), device=DEV)
        got = fused_assign.fused_topk(q, q8, k, valid, keys_scale=scale,
                                      keys_zero=zero)
        want = fused_assign.fused_topk_plain(q, q8, k, valid, keys_scale=scale,
                                             keys_zero=zero)
        first = valid.nonzero()[:k, 0].to(torch.int32)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K1 int8 FMA case differs from its plain version at d {d}")
        check(bool((got[0] == d * 2.0 ** -32).all())
              and torch.equal(got[1], first.expand(5, -1)),
              f"K1 int8 at d {d}: dequantization is not a rounded multiply "
              f"then an add, or the tie order is off")
        cases += 1
    emit("kernels_edges", kernel="K1-bf16/K1-int8",
         variant="tc3xtf32/cuda_core_split/cuda_core", cases=cases, bitwise=True)
    return cases


def _attention_edges() -> None:
    """K5 against its plain version on awkward shapes: rows that fill no
    whole tile, lq < lk, head_dim 16, 64, 100 and 256, one kv head, a bias
    per query head, -1e30 bias entries scattered, and every key of the first
    kv tile masked; on the tensor-core tiled route (bf16 at head_dim 64, 128
    and 256) a block that straddles two query heads, g 1, 2, 4 and 16, a
    bias per kv and per query head, softcap 0, 30 and 50, the first kv tile
    wholly masked, no causal mask, one query row per head, one head of the
    LM's prefill in batch 1; at head_dim 96 causal, non-causal with lq <
    lk, GQA, a bias per kv and per query head, lk off the 64-key tile and
    one head of phi-3-vision's prefill; seamless's non-causal self and
    cross calls at head_dim 64; on the split-kv route (lq 1 and 2) a split
    wholly masked in the middle of the keys beside a masked tail, lk below
    one split and one key past it, a bias per query head, head_dim 96 and
    64 without a bias. Within the stated tolerance, no NaN, and a second
    call gives the same bits."""
    from repro_torch.kernels import flash_attention as fa

    cases = (
        # b, hq, hkv, lq, lk, dh, causal, bias, softcap, dtype
        (1, 4, 2, 100, 100, 64, True, None, 50.0, torch.float32),
        (2, 4, 2, 37, 300, 64, True, "kv", 50.0, torch.float32),
        (1, 2, 1, 5, 77, 16, True, "masked", 0.0, torch.float32),
        (1, 8, 1, 70, 70, 16, True, None, 30.0, torch.float32),
        (2, 8, 4, 1, 1232, 256, False, "masked", 50.0, torch.float32),
        (1, 2, 1, 1, 90, 16, False, "first_tile", 50.0, torch.float32),
        (1, 2, 1, 20, 90, 16, True, "first_tile", 50.0, torch.float32),
        (1, 4, 2, 9, 33, 256, True, "q_heads", 50.0, torch.float32),
        (2, 8, 4, 65, 129, 256, True, "kv", 50.0, torch.bfloat16),
        # the tensor-core tiled route (bf16, head_dim 64/128/256)
        (1, 4, 2, 100, 100, 64, True, None, 50.0, torch.bfloat16),
        (2, 4, 2, 37, 300, 128, True, "kv", 0.0, torch.bfloat16),
        (1, 8, 2, 70, 200, 64, True, "q_heads", 50.0, torch.bfloat16),
        (1, 2, 1, 70, 200, 128, True, "first_tile64", 50.0, torch.bfloat16),
        (1, 4, 1, 40, 90, 256, False, "masked", 50.0, torch.bfloat16),
        (1, 16, 1, 1, 77, 64, False, "kv", 30.0, torch.bfloat16),
        (1, 8, 4, 2048, 2048, 256, True, None, 50.0, torch.bfloat16),
        # the split-kv route
        (4, 8, 4, 1, 1232, 256, False, "masked_split", 50.0, torch.bfloat16),
        (2, 8, 4, 1, 300, 256, False, "masked_split", 50.0, torch.float32),
        (2, 8, 4, 1, 40, 256, False, "kv", 50.0, torch.float32),
        (2, 8, 4, 1, 65, 256, False, "kv", 50.0, torch.bfloat16),
        (2, 8, 4, 1, 65, 256, False, "kv", 0.0, torch.float32),
        (1, 8, 4, 1, 300, 256, False, "q_heads", 50.0, torch.float32),
        (1, 8, 4, 2, 150, 64, True, "kv", 50.0, torch.float32),
        (1, 2, 2, 1, 100, 100, False, "kv", 0.0, torch.float32),
        # head_dim 96 on the tensor-core route (phi-3-vision): causal,
        # non-causal with lq < lk, GQA, a bias per kv and per query head,
        # lk not a multiple of the 64-key tile
        (1, 4, 4, 130, 130, 96, True, None, 0.0, torch.bfloat16),
        (2, 4, 4, 70, 300, 96, False, "kv", 0.0, torch.bfloat16),
        (1, 8, 2, 77, 201, 96, True, "q_heads", 30.0, torch.bfloat16),
        (1, 4, 4, 64, 190, 96, True, "first_tile64", 0.0, torch.bfloat16),
        (1, 2, 2, 2304, 2304, 96, True, None, 0.0, torch.bfloat16),
        # seamless's calls at head_dim 64: non-causal self and cross
        (1, 4, 4, 200, 200, 64, False, None, 0.0, torch.bfloat16),
        (1, 4, 4, 33, 257, 64, False, None, 0.0, torch.bfloat16),
        # the split-kv route at head_dim 96 (its DH 128 instance) and 64:
        # no bias, a bias, lk not a multiple of 64
        (2, 4, 4, 1, 300, 96, False, None, 0.0, torch.bfloat16),
        (2, 4, 4, 1, 1360, 96, False, "masked_split", 0.0, torch.bfloat16),
        (1, 4, 4, 1, 77, 96, False, "kv", 0.0, torch.bfloat16),
        (2, 4, 4, 1, 2048, 64, False, None, 0.0, torch.bfloat16),
        (1, 4, 4, 1, 131, 64, False, None, 0.0, torch.float32),
    )
    worst = 0.0
    routes = {}
    for i, (b, hq, hkv, lq, lk, dh, causal, bias, cap, dt) in enumerate(cases):
        q, k, v, kb = _attn_inputs(b, hq, hkv, lq, lk, dh, dt, 20 + i, bias)
        kw = dict(causal=causal, scale=1.0 / 16, logit_softcap=cap)
        got = fa.flash_attention(q, k, v, kb, **kw)
        again = fa.flash_attention(q, k, v, kb, **kw)
        want = fa.flash_attention_plain(q, k, v, kb, **kw).float()
        sync()
        tol = ATTN_TOL_F32 if dt == torch.float32 else ATTN_TOL_BF16
        err = float((got.float() - want).abs().max())
        check(torch.equal(got, again), f"K5 edge {i}: a repeat differs")
        check(bool(torch.isfinite(got.float()).all()), f"K5 edge {i}: non-finite")
        check(torch.allclose(got.float(), want, **tol), f"K5 edge {i} off: {err}")
        worst = max(worst, err)
        route = fa.route(hq, hkv, lq, dt, dh)
        routes[route] = routes.get(route, 0) + 1
    emit("kernels_edges", kernel="K5", cases=len(cases), routes=routes,
         bitwise_repeat=True, max_abs_err=worst)


def phase_fit(state: dict) -> None:
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.cluster.metrics import clustering_accuracy

    n = SIZES["covertype"]
    x, comp = _analog(n)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                          device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    labels = res.labels
    check(labels.shape == (n,) and labels.dtype == torch.int32, "labels shape")
    check(bool(((labels >= 0) & (labels < 7)).all()), "labels outside [0, 7)")
    check(bool(torch.isfinite(res.protos).all()), "non-finite prototypes")
    sizes = torch.bincount(labels.long(), minlength=7)
    nonempty = sizes[sizes > 0]
    check(int(nonempty.min()) >= 3 ** 5, "a final cluster below t^m units")
    for name in ("K1", "K2", "K3", "K4"):
        check(counts[name] > 0, f"{name} was not launched by the fit")
    state.update(fit=res, x=x, fit_counts=counts)
    emit("fit", n=n, d=x.shape[1], t=3, m=5, k=7, seconds=round(wall, 3),
         level_sizes=res.info["level_sizes"], n_valid=res.info["n_valid"],
         mis_rounds=res.info["mis_rounds"], n_prototypes=int(res.n_prototypes),
         lloyd_iters=res.backend_result.iters,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         accuracy_vs_components=clustering_accuracy(comp, labels, 7),
         launches=counts)


def phase_serve(state: dict) -> None:
    from repro_torch import kernels
    from repro_torch.core.index import ClusterIndex
    from repro_torch.serve import ClusterService

    t0 = time.perf_counter()
    x = state["x"]
    idx = ClusterIndex.build(state["fit"]).check_servable(expect_dim=6)
    svc = ClusterService(idx, buckets=(32, 128, 512, 2048))
    svc.warmup()
    k1_before = kernels.launch_counts()["K1"]
    gen = np.random.default_rng(2)
    latencies, agree, total, mism_total, not_ties = {}, 0, 0, 0, 0
    for size in (1, 100, 2048, 5000):
        rows = dev(gen.integers(0, x.shape[0], size=size))
        noise = dev(gen.normal(scale=0.05, size=(size, 6)).astype(np.float32))
        q = x[rows] + noise
        sync()
        t1 = time.perf_counter()
        got = svc.assign(q)
        sync()
        latencies[str(size)] = round((time.perf_counter() - t1) * 1e3, 3)
        want = idx.assign(q, impl="ref")
        check(got.shape == (size,), "serve output shape")
        diff = (got != want).nonzero()[:, 0]
        agree += int((got == want).sum())
        total += size
        mism_total += int(diff.numel())
        if diff.numel():
            # a mismatch must be a near-tie: the two owners' prototypes are
            # (almost) equally near in float64
            _, pk = _owner(idx, q[diff], "fused")
            _, pr = _owner(idx, q[diff], "ref")
            dk = ((q[diff].double() - idx.protos[pk].double()) ** 2).sum(1)
            dr = ((q[diff].double() - idx.protos[pr].double()) ** 2).sum(1)
            not_ties += int((~torch.isclose(dk, dr, **DIST_TOL)).sum())
    counts = kernels.launch_counts()
    state["main_counts"] = counts
    state["main_routes"] = kernels.route_counts()
    check(counts["K1"] > k1_before, "K1 did not launch while serving")
    rate = agree / total
    check(rate >= 0.999, f"serve agreement with the plain path {rate} < 0.999")
    check(not_ties == 0, f"{not_ties} serve mismatches are not near-ties")
    emit("serve", buckets=list(svc.buckets), request_ms=latencies,
         agreement_with_plain=rate, mismatches=mism_total,
         stats=svc.stats, k1_launches_while_serving=counts["K1"] - k1_before,
         seconds=round(time.perf_counter() - t0, 3), launches=counts)


def _fit_arrays(res) -> dict:
    """A fit's result fields as host arrays (labels, the final buffers,
    the k-means centres)."""
    out = {f: getattr(res, f).detach().cpu().numpy()
           for f in ("protos", "proto_mass", "proto_valid", "proto_labels",
                     "n_prototypes")}
    lab = res.labels  # a device tensor, or a stream's lazy host view
    out["labels"] = (lab.cpu().numpy() if isinstance(lab, torch.Tensor)
                     else np.asarray(lab))
    out["centers"] = res.backend_result.centers.detach().cpu().numpy()
    return out


def _digest(arrays: dict) -> str:
    """SHA-1 of a result's bytes, field by field (ranks compare results by
    it: each returns its digest, rank 0 its arrays too)."""
    h = hashlib.sha1()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _bit_equal(a: dict, b: dict) -> list:
    """The fields of two results whose bytes differ."""
    return [k for k in sorted(a) if a[k].dtype != b[k].dtype
            or a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes()]


def sharded_rank(rank: int, cfg: dict) -> dict:
    """One rank of the sharded phase (started by spawn_ranks in a fresh
    process; module level, so the process can import it). Every rank runs
    the same fits on its own rows; rank 0 returns the arrays, every rank
    its digests, walls, rounds, peak memory, launches and staged bytes."""
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.core import _collectives
    from repro_torch.core.distributed import make_data_mesh
    from repro_torch.core.index import ClusterIndex
    from repro_torch.data import stream_to_mesh

    dev = torch.device(cfg["device"])
    on_card = dev.type == "cuda"
    sync_here = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = make_data_mesh(backend=cfg["backend"], device_type=dev.type)
    x = np.load(cfg["x_path"])
    xa = x[:cfg["aligned"]]
    q = np.load(cfg["q_path"])
    t, m, k, key = cfg["t"], cfg["m"], cfg["k"], prng.PRNGKey(0)
    out = {"rank": rank, "results": {}, "digests": {}}

    def keep(name, arrays):
        out["digests"][name] = _digest(arrays)
        if rank == 0:
            out["results"][name] = arrays

    def run_fit(data, **kw):
        sync_here()
        t0 = time.perf_counter()
        res = repro_torch.fit(data, t, m, "kmeans", k=k, key=key, mesh=mesh,
                              device=dev, **kw)
        sync_here()
        return res, time.perf_counter() - t0

    # the main path: the aligned fit and the mesh assign, counted alone
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _collectives.reset_staging_counts()
    res, wall = run_fit(xa)
    t0 = time.perf_counter()
    labels_q = ClusterIndex.build(res).assign(q, mesh=mesh)
    sync_here()
    out["assign_s"] = time.perf_counter() - t0
    out["launches"] = kernels.launch_counts()
    out["routes"] = kernels.route_counts()
    out["staged"] = _collectives.staging_counts()
    out["ipc"] = _collectives.ipc_counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["aligned"] = dict(seconds=wall, executor=res.executor,
                          level_seconds=res.info["level_seconds"],
                          level_sizes=res.info["level_sizes"],
                          mis_rounds=res.info["mis_rounds"],
                          lloyd_iters=res.backend_result.iters)
    keep("aligned", _fit_arrays(res))
    keep("assign", {"labels": labels_q.cpu().numpy()})
    res, out["repeat_s"] = run_fit(xa)
    keep("repeat", _fit_arrays(res))
    if cfg["full"]:
        res, wall = run_fit(x)
        out["full"] = dict(seconds=wall, level_sizes=res.info["level_sizes"],
                           mis_rounds=res.info["mis_rounds"])
        keep("full", _fit_arrays(res))
    if cfg["stream"]:
        c = cfg["stream_chunk"]
        sync_here()
        t0 = time.perf_counter()
        xs, vs = stream_to_mesh((xa[i:i + c] for i in range(0, len(xa), c)), mesh,
                                len(xa), xa.shape[1], device=dev)
        sync_here()
        out["stream_to_mesh_s"] = time.perf_counter() - t0
        res, out["streamed_fit_s"] = run_fit(xs, valid=vs)
        keep("streamed", _fit_arrays(res))
        c = cfg["aligned_chunk"]
        res, out["streaming_sharded_s"] = run_fit(
            (xa[i:i + c] for i in range(0, len(xa), c)),
            reservoir_n=cfg["reservoir"])
        out["streaming_sharded_cascades"] = res.n_cascades
        out["streaming_sharded_executor"] = res.executor
        keep("streaming_sharded", _fit_arrays(res))
    return out


def _sharded_ring_kernels(x, ids, per: int, S: int) -> None:
    """K1 at a ring step's shape (2,048 queries of rank 1's block against
    rank 0's block of ``per`` keys: the self-exclusion index falls outside
    the keys) and K3 at one rank's block partial, each against its plain
    version (launches outside any counted run)."""
    q = x[per:per + 2048]
    keys = x[:per]
    gidx = (per + torch.arange(2048, device=x.device)).to(torch.int32)
    _k1_row("sharded ring step", q, keys, None, gidx, 2, plain_reps=1)
    sub = per // 2  # n_blocks 8 over 4 ranks: two block partials a rank
    _k3_row("sharded block partial", x[:sub], ids[:sub], S,
            torch.ones((sub,), device=x.device), n_blocks=1)


def phase_sharded(state: dict) -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.core.index import ClusterIndex
    from repro_torch.launch.mesh import spawn_ranks

    t_start = time.perf_counter()
    cfg = SHARDED
    t, m, k, p = cfg["t"], cfg["m"], cfg["k"], cfg["ranks"]
    n = SIZES["covertype"]
    x = state["x"] if "x" in state else _analog(n)[0]
    xa = x[:cfg["aligned"]]
    gen = np.random.default_rng(3)
    rows = dev(gen.integers(0, cfg["aligned"], size=cfg["queries"]))
    q = xa[rows] + dev(gen.normal(scale=0.05, size=(cfg["queries"], x.shape[1]))
                       .astype(np.float32))
    # the one-device references, on this card
    want = repro_torch.fit(xa, t, m, "kmeans", k=k, key=prng.PRNGKey(0), device=DEV)
    want_q = ClusterIndex.build(want).assign(q).cpu().numpy()
    xa_host = xa.cpu().numpy()
    c = cfg["aligned_chunk"]
    want_stream = repro_torch.fit(
        (xa_host[i:i + c] for i in range(0, len(xa_host), c)), t, m, "kmeans",
        k=k, key=prng.PRNGKey(0), reservoir_n=cfg["reservoir"], device=DEV)
    full = state.get("fit") or repro_torch.fit(x, t, m, "kmeans", k=k,
                                               key=prng.PRNGKey(0), device=DEV)
    _sharded_ring_kernels(xa, want.assignments[0], cfg["aligned"] // p,
                          want.info["level_sizes"][1])
    sync()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-sharded-") as tmp:
        np.save(f"{tmp}/x.npy", x.cpu().numpy())
        np.save(f"{tmp}/q.npy", q.cpu().numpy())
        base = dict(cfg, device=DEV, x_path=f"{tmp}/x.npy", q_path=f"{tmp}/q.npy")
        t0 = time.perf_counter()
        gloo = spawn_ranks(sharded_rank, p, backend="gloo", device=DEV,
                           init_dir=tmp, timeout=cfg["timeout"],
                           args=(dict(base, backend="gloo", full=True, stream=True),))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = cfg["one_rank_backend"]
        nccl = spawn_ranks(sharded_rank, 1, backend=one, device=DEV,
                           init_dir=tmp, timeout=cfg["timeout"],
                           args=(dict(base, backend=one, full=False, stream=False),))
        nccl_s = time.perf_counter() - t0

    ref = _fit_arrays(want)
    ref_stream = _fit_arrays(want_stream)
    for run, outs, streamed in (("gloo", gloo, True),
                                (cfg["one_rank_backend"], nccl, False)):
        for name, dg in outs[0]["digests"].items():
            same = all(o["digests"][name] == dg for o in outs)
            check(same, f"sharded ({run}, {len(outs)} ranks): the ranks' {name} "
                        f"results differ")
        got = outs[0]["results"]
        for name in ("aligned", "repeat") + (("streamed",) if streamed else ()):
            diff = _bit_equal(got[name], ref)
            check(not diff, f"sharded ({run}): the {name} fit differs from the "
                            f"memory executor's in {diff}")
        check(np.array_equal(got["assign"]["labels"], want_q),
              f"sharded ({run}): the mesh assign differs from the one-device "
                    f"assign on {int((got['assign']['labels'] != want_q).sum())} "
                    f"queries")
        for o in outs:
            for kid in ("K1", "K3", "K4"):
                check(o["launches"][kid] > 0,
                      f"sharded ({run}): {kid} was not launched on rank {o['rank']}")
            check(o["launches"]["K2"] == 0, "sharded: the ring kNN launched K2")
    got = gloo[0]["results"]
    diff = _bit_equal(got["streaming_sharded"], ref_stream)
    check(not diff, f"sharded: streaming_sharded differs from the streaming "
                    f"executor in {diff}")
    check(gloo[0]["streaming_sharded_executor"] == "streaming_sharded",
          "the chunk stream under a mesh did not plan streaming_sharded")
    lab = got["full"]["labels"]
    sizes = np.bincount(lab[lab >= 0], minlength=k)
    mass = float(got["full"]["proto_mass"].astype(np.float64).sum())
    check(lab.shape == (n,) and int(lab.min()) >= 0, "sharded full run: a label < 0")
    check(int(sizes[sizes > 0].min()) >= t ** m,
          f"sharded full run: a cluster below t^m: {sizes.tolist()}")
    check(abs(mass - n) <= 1e-2, f"sharded full run: mass sums to {mass}, not {n}")
    agreement = clustering_accuracy(full.labels.cpu().numpy(), lab, k)
    counts = {}
    routes = {}
    for o in gloo:
        for kid, v in o["launches"].items():
            counts[kid] = counts.get(kid, 0) + v
        for r, v in o["routes"].items():
            routes[r] = routes.get(r, 0) + v
    state["sharded_counts"], state["sharded_routes"] = counts, routes

    def per_rank(outs):
        return [dict(rank=o["rank"], level_seconds=[round(v, 4) for v in
                                                   o["aligned"]["level_seconds"]],
                     mis_rounds=o["aligned"]["mis_rounds"],
                     fit_seconds=round(o["aligned"]["seconds"], 3),
                     repeat_seconds=round(o["repeat_s"], 3),
                     assign_seconds=round(o["assign_s"], 4),
                     lloyd_iters=o["aligned"]["lloyd_iters"],
                     peak_bytes=o["peak_bytes"], launches_by_route=o["routes"],
                     staged=o["staged"],
                     staged_bytes=sum(v["bytes"] for v in o["staged"].values()),
                     ipc=o["ipc"], ipc_bytes=sum(v["bytes"] for v in o["ipc"].values()))
                for o in outs]

    emit("sharded", ranks=p, backend="gloo", n=cfg["aligned"], d=x.shape[1], t=t,
         m=m, k=k, level_sizes=gloo[0]["aligned"]["level_sizes"],
         bitwise_memory_executor=True, bitwise_repeat=True,
         assign_queries=cfg["queries"], assign_bitwise=True,
         per_rank=per_rank(gloo), spawn_seconds=round(gloo_s, 3),
         memory_fit_mis_rounds=want.info["mis_rounds"])
    emit("sharded_nccl", ranks=1, backend=cfg["one_rank_backend"],
         bitwise_memory_executor=True,
         bitwise_repeat=True, per_rank=per_rank(nccl),
         spawn_seconds=round(nccl_s, 3))
    o = gloo[0]
    emit("sharded_full", ranks=p, n=n, level_sizes=o["full"]["level_sizes"],
         mis_rounds=o["full"]["mis_rounds"], seconds=round(o["full"]["seconds"], 3),
         min_cluster=int(sizes[sizes > 0].min()), mass_sum=mass,
         label_agreement_with_memory_fit=agreement)
    emit("sharded_stream", ranks=p, stream_chunk=cfg["stream_chunk"],
         stream_to_mesh_seconds=round(o["stream_to_mesh_s"], 3),
         streamed_fit_seconds=round(o["streamed_fit_s"], 3),
         streamed_fit_bitwise_memory=True, aligned_chunk=c,
         reservoir=cfg["reservoir"],
         streaming_sharded_seconds=round(o["streaming_sharded_s"], 3),
         cascades=o["streaming_sharded_cascades"], bitwise_streaming=True)
    emit("sharded_phase", seconds=round(time.perf_counter() - t_start, 3),
         launches=counts)


def _owner(idx, q, impl):
    from repro_torch.core.index import nearest_valid_prototype

    d, i = nearest_valid_prototype(q, idx.protos, idx.proto_valid, impl=impl)
    return d, i.long()


#: a line of ``populate --verbose``: "#   <cell> <params> -> <ms> ms"
_CANDIDATE_LINE = re.compile(r"^#   (\S+) (\{.*\}) -> ([0-9.]+) ms$")


def _populate(path: str, p: int) -> tuple:
    """Run ``python -m repro_torch.tune populate`` (its ``main``, in this
    process) into ``path`` at the main path's buckets (``p``: the served
    index's prototype rows). Returns the requested (cell, dims), the
    candidates' median ms per cell, and the skipped candidates' lines."""
    from repro_torch.tune.__main__ import main as tune_cli

    n, d = SIZES["covertype"], 6
    runs = (
        ("knn,knn_block", f"{n}x{d}x2"),
        ("assign", f"nq{n}:p{n}:d{d}:k2,nq5000:p{p}:d{d}:k1"),
        ("segment_sum", f"n{n}:d{d}:s{SIZES['segments']},"
                        f"n{SIZES['protos']}:d{d}:s{SIZES['centres']}"),
        ("pairwise_sq_l2", f"n{SIZES['protos']}:m{SIZES['centres']}:d{d}"),
    )
    out = io.StringIO()
    for kernels, shapes in runs:
        with contextlib.redirect_stdout(out):
            rc = tune_cli(["--cache", path, "populate", "--kernels", kernels,
                           "--shapes", shapes, "--repeats", str(TUNE["repeats"]),
                           "--verbose"])
        check(rc == 0, f"populate --kernels {kernels} exited {rc}")
    requested = [("knn", dict(n=n, d=d, k=2)), ("knn_block", dict(n=n, d=d, k=2)),
                 ("assign", dict(nq=n, p=n, d=d, k=2)),
                 ("assign", dict(nq=5000, p=p, d=d, k=1)),
                 ("segment_sum", dict(n=n, d=d, s=SIZES["segments"])),
                 ("segment_sum", dict(n=SIZES["protos"], d=d, s=SIZES["centres"])),
                 ("pairwise_sq_l2", dict(n=SIZES["protos"], m=SIZES["centres"], d=d))]
    timings, skipped, cells, current = {}, [], [], []
    for line in out.getvalue().splitlines():
        m = _CANDIDATE_LINE.match(line)
        if m:
            current.append((ast.literal_eval(m.group(2)), float(m.group(3))))
        elif line.startswith("# tuned "):  # closes a cell
            cells.append((line.split()[2], current))
            current = []
        elif line.startswith("# skipped"):
            skipped.append(line[2:])
    check(len(cells) == len(requested),
          f"populate measured {len(cells)} cells, {len(requested)} requested")
    for (kernel, dims), (name, cands) in zip(requested, cells):
        check(name == kernel, f"populate's cell order: {name} where {kernel}")
        timings[(kernel, tuple(sorted(dims.items())))] = cands
    return requested, timings, skipped


def _default_params(kernel: str, dims: dict) -> dict:
    """What the hand-picked rules dispatch at ``dims`` on the card, in a
    cell's terms (the routes of the call's own shape)."""
    from repro_torch.core.knn import AUTO_KNN_BLOCK
    from repro_torch.kernels import fused_assign, pairwise_l2
    from repro_torch.kernels import segment_sum as seg

    if kernel == "knn":
        return {"impl": "cuda", "route": fused_assign.route(torch.float32, torch.float32,
                                                            dims["d"], dims["k"])}
    if kernel == "assign":
        return {"impl": "fused", "route": fused_assign.route(torch.float32, torch.float32,
                                                             dims["d"], dims["k"])}
    if kernel == "knn_block":
        return {"knn_block": AUTO_KNN_BLOCK}
    if kernel == "pairwise_sq_l2":
        return {"impl": "cuda", "route": pairwise_l2.route(dims["m"], dims["d"])}
    return {"impl": "cuda", "route": seg.plan(dims["n"], dims["s"], 8)[0]}


def _label_not_ties(idx, q, got, want) -> int:
    """Of queries labelled ``got`` where the plain path says ``want``, how
    many are not near-ties: the nearest valid prototype carrying each
    label, in float64, farther apart than DIST_TOL."""
    if q.shape[0] == 0:
        return 0
    dd = ((q.double()[:, None, :] - idx.protos.double()[None]) ** 2).sum(-1)
    lab = torch.where(idx.proto_valid, idx.proto_labels, -2)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=q.device)
    dg = torch.where(lab[None, :] == got[:, None], dd, inf).amin(1)
    dw = torch.where(lab[None, :] == want[:, None], dd, inf).amin(1)
    return int((~torch.isclose(dg, dw, **DIST_TOL)).sum())


def _tune_candidate_checks(state: dict) -> dict:
    """Every candidate route of the populated cells against its cell's
    plain version at the main path's shapes (K1 at a cut 4,096 queries x
    65,536 keys of the analog, d 6, k 2 and at the serve shape; K2 at the
    level-4 7,172 rows; K3 at the level-0 reduce and the Lloyd statistics,
    bit for bit against the CPU fold; K4 at 2,390 x 7), and the rows where
    each differs from the default route."""
    from repro_torch.core.index import ClusterIndex
    from repro_torch.kernels import fused_assign as fa
    from repro_torch.kernels import knn_topk, pairwise_l2, ref
    from repro_torch.kernels import segment_sum as seg

    x, res = state["x"], state["fit"]
    out = {}
    gen = torch.Generator(device="cpu").manual_seed(7)
    # K1: the TC's blocked kNN inner loop, cut; self-exclusion by index
    rows = torch.randperm(TUNE["check_keys"], generator=gen)[:TUNE["check_q"]].to(DEV)
    q, keys = x[rows], x[:TUNE["check_keys"]]
    gidx = rows.to(torch.int32)
    rd, ri = fa.fused_topk_plain(q, keys, 2, q_gidx=gidx, block_q=TUNE["check_q"],
                                 block_k=TUNE["check_keys"])
    base = fa.fused_topk(q, keys, 2, q_gidx=gidx)
    for r in fa.ROUTES:
        gd, gi = fa.fused_topk(q, keys, 2, q_gidx=gidx, route=r)
        mism, bad = topk_mismatches(q, keys, gd, gi, rd, ri)
        err = float((gd - rd).abs().max())
        check(torch.allclose(gd, rd, **DIST_TOL), f"K1/{r} distances off: {err}")
        check(bad == 0, f"K1/{r}: {bad} index mismatches that are not near-ties")
        diff = int(((gd != base[0]) | (gi != base[1])).any(1).sum())
        out[f"K1/{r}"] = dict(max_abs_err=err, index_mismatches=mism, rows_differ=diff)
    # K2: the level-4 one-shot kNN
    x4 = x[:SIZES["knn_n"]]
    rd, ri = ref.knn(x4, 2)
    base = knn_topk.knn_topk(x4, 2)
    for r in fa.ROUTES:
        gd, gi = knn_topk.knn_topk(x4, 2, route=r)
        mism, bad = topk_mismatches(x4, x4, gd, gi, rd, ri)
        err = float((gd - rd).abs().max())
        check(torch.allclose(gd, rd, **DIST_TOL), f"K2/{r} distances off: {err}")
        check(bad == 0, f"K2/{r}: {bad} index mismatches that are not near-ties")
        diff = int(((gd != base[0]) | (gi != base[1])).any(1).sum())
        out[f"K2/{r}"] = dict(max_abs_err=err, index_mismatches=mism, rows_differ=diff)
    # the assign cell's candidates at the serve shape: labels against the
    # plain path, a mismatch only where the nearest prototype of either
    # label is (almost) equally near in float64
    idx = ClusterIndex.build(res)
    gq = np.random.default_rng(2)
    qs = x[dev(gq.integers(0, x.shape[0], size=5000))] + dev(
        gq.normal(scale=0.05, size=(5000, 6)).astype(np.float32))
    want = idx.assign(qs, impl="ref")
    base = idx.assign(qs, impl="fused")
    cands = [("fused", r) for r in fa.ROUTES] + [("fused_bf16", None),
                                                 ("fused_int8", None), ("cuda", None)]
    for impl, r in cands:
        got = idx.assign(qs, impl=impl, route=r)
        diff = (got != want).nonzero()[:, 0]
        not_ties = _label_not_ties(idx, qs[diff], got[diff], want[diff])
        check(not_ties == 0, f"assign {impl}/{r}: {not_ties} label mismatches "
                             f"that are not near-ties")
        out[f"assign/{impl}" + (f"/{r}" if r else "")] = dict(
            mismatches=int(diff.numel()), rows_differ=int((got != base).sum()))
    # K3: both paths where they run, bit for bit against the CPU fold
    lv0 = res.assignments[0].long()
    ones = torch.ones(x.shape[0], device=DEV)
    lloyd_x, lloyd_w = res.protos, res.proto_mass
    lloyd_ids = torch.where(res.proto_valid, res.proto_labels.long(), -1)
    for name, (xx, ids, S, w) in {
            "level0": (x, lv0, SIZES["segments"], ones),
            "lloyd": (lloyd_x, lloyd_ids, SIZES["centres"], lloyd_w)}.items():
        cs, cm = ref.blocked_segment_sum(xx.cpu(), ids.cpu(), S, weights=w.cpu(),
                                         n_blocks=8)
        for r in seg.ROUTES:
            if not seg.route_ok(r, S):
                continue
            gs, gm = seg.blocked_segment_sum(xx, ids, S, w, n_blocks=8, route=r)
            check(torch.equal(gs.cpu(), cs) and torch.equal(gm.cpu(), cm),
                  f"K3/{r} ({name}) differs from the CPU plain version's bits")
            out[f"K3/{r}/{name}"] = dict(bit_equal_to_cpu_plain=True)
    # a route asked for where it cannot run raises (never rerouted), and
    # the wrappers' legality rule is the library's
    from repro_torch.kernels import _cuda

    lib = _cuda.library("topk")
    rule = [(r, dd, kk) for r in fa.ROUTES for dd in (1, 6, 8, 31, 32, 33, 64, 300)
            for kk in (1, 2, 8, 9, 32, 33)]
    check(all(fa.route_ok(r, dd, kk) == bool(lib.repro_topk_route_ok(
        fa.ROUTES.index(r), dd, kk)) for r, dd, kk in rule),
        "K1's route rule differs from the library's")
    refused = 0
    for call in (lambda: fa.fused_topk(x[:64, :6].repeat(1, 11), x[:64, :6].repeat(1, 11),
                                       2, route="tc3xtf32"),
                 lambda: knn_topk.knn_topk(x[:64], 9, route="cuda_core_split"),
                 lambda: pairwise_l2.pairwise_sq_l2(x[:64], x[:17], route="small_m"),
                 lambda: seg.blocked_segment_sum(x[:64], torch.arange(64, device=DEV), 65,
                                                 route="few")):
        try:
            call()
        except ValueError:
            refused += 1
    check(refused == 4, f"{4 - refused} illegal routes ran")
    out["illegal_routes_refused"] = refused
    # K4: the k-means distances
    cx = res.protos
    cy = res.backend_result.centers
    rdist = ref.pairwise_sq_l2(cx, cy)
    base = pairwise_l2.pairwise_sq_l2(cx, cy)
    for r in pairwise_l2.ROUTES:
        got = pairwise_l2.pairwise_sq_l2(cx, cy, route=r)
        err = float((got - rdist).abs().max())
        check(torch.allclose(got, rdist, **DIST_TOL), f"K4/{r} distances off: {err}")
        out[f"K4/{r}"] = dict(max_abs_err=err,
                              rows_differ=int((got != base).any(1).sum()))
    return out


def _counted_lookups():
    """Wrap TuningCache.lookup to count hits and misses (this phase only)."""
    from repro_torch.tune.cache import TuningCache

    counts = {"hits": 0, "misses": 0}
    orig = TuningCache.lookup

    def lookup(self, *args, **kwargs):
        got = orig(self, *args, **kwargs)
        counts["hits" if got is not None else "misses"] += 1
        return got

    @contextlib.contextmanager
    def scope():
        TuningCache.lookup = lookup
        try:
            yield counts
        finally:
            TuningCache.lookup = orig

    return scope()


_FROZEN = ("impl", "knn_block", "block_q", "block_k", "knn_route")


def phase_tune(state: dict) -> None:
    import repro_torch
    from repro_torch import kernels, prng, runtime, tune
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.core.index import ClusterIndex
    from repro_torch.core.plan import execute_plan, plan_fit
    from repro_torch.kernels import ops
    from repro_torch.serve import ClusterService
    from repro_torch.tune import autotune

    t0 = time.perf_counter()
    if "fit" not in state:  # the untuned fit the tuned one is held against
        phase_fit(state)
    x, off = state["x"], state["fit"]
    n, d = x.shape
    kind = autotune.current_device_kind()
    prev_cache = tune.get_cache()
    key = prng.PRNGKey(0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_tune_") as tmp:
        path = str(Path(tmp) / "tune_cache.json")
        t1 = time.perf_counter()
        requested, timings, skipped = _populate(path, int(off.protos.shape[0]))
        populate_s = time.perf_counter() - t1
        cache = tune.set_cache(path)
        check(len(cache) == len(requested),
              f"{len(cache)} cache entries for {len(requested)} requested cells")
        cells, all_default = [], True
        for kernel, dims in requested:
            bucket = tune.shape_bucket(**dims)
            params = cache.lookup(kind, kernel, bucket)
            check(params is not None, f"no {kind}|{kernel}|{bucket} entry")
            why = tune._stale_reason(params, kernel, kind, dims)
            check(why is None, f"{kernel}|{bucket}: the stale gate refuses "
                               f"the populated winner: {why}")
            default = _default_params(kernel, dims)
            is_default = all(params.get(a) == v for a, v in default.items())
            all_default &= is_default
            rec = dict(cache.entries())[(kind, kernel, bucket, "float32")]
            cells.append(dict(cell=kernel, dims=dims, bucket=bucket, winner=params,
                              default=default, winner_is_default=is_default,
                              seconds=rec["seconds"],
                              candidates_ms={json.dumps(p, sort_keys=True): ms
                                             for p, ms in timings[(kernel, tuple(
                                                 sorted(dims.items())))]}))
        t1 = time.perf_counter()
        checks = _tune_candidate_checks(state)
        checks_s = time.perf_counter() - t1

        # the covertype fit under "cached", against the untuned fit
        kernels.reset_launch_counts()
        with runtime.configure(tune="cached"), _counted_lookups() as lookups:
            sync()
            t1 = time.perf_counter()
            plan = plan_fit(x, 3, 5, "kmeans", k=7, key=key, device=DEV)
            tuned = execute_plan(plan, x)
            sync()
            tuned_s = time.perf_counter() - t1
            fit_lookups = dict(lookups)
            again = repro_torch.fit(x, 3, 5, "kmeans", k=7, key=key, device=DEV)
            before_serve = dict(lookups)
            # served under "cached": the service's buckets and the whole
            # 5000-point request (the populated serve shape)
            idx = ClusterIndex.build(tuned).check_servable(expect_dim=d)
            svc = ClusterService(idx, buckets=(32, 128, 512, 2048))
            svc.warmup()
            gen = np.random.default_rng(2)
            agree = total = 0
            for size in (1, 100, 2048, 5000):
                q = x[dev(gen.integers(0, n, size=size))] + dev(
                    gen.normal(scale=0.05, size=(size, d)).astype(np.float32))
                for got in (svc.assign(q), idx.assign(q)):
                    with runtime.configure(tune="off"):
                        want = idx.assign(q, impl="ref")
                    agree += int((got == want).sum())
                    total += size
            sync()
            serve_lookups = {k: lookups[k] - before_serve[k] for k in lookups}
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        state["tune_counts"], state["tune_routes"] = counts, routes
        # the TC's kNN: blocked (K1) above the plan's row block, one-shot
        # (K2) at or below it, on the frozen route when there is one
        block = plan.knn_block or 8192
        tc_sizes = off.info["level_sizes"][:-1]
        want_k = {"K1": True,  # the serve's assign launches it in any case
                  "K2": any(s <= block for s in tc_sizes), "K3": True, "K4": True}
        for kid, want in want_k.items():
            check((counts[kid] > 0) == want,
                  f"{kid}: {counts[kid]} launches in the tuned fit and serve, "
                  f"expected {'some' if want else 'none'} (row block {block})")
        on_route = {"K1": any(s > block for s in tc_sizes), "K2": want_k["K2"]}
        if plan.knn_route is not None:
            for kid in ("K1", "K2"):
                check(not on_route[kid] or routes.get(f"{kid}/{plan.knn_route}", 0) > 0,
                      f"{kid} did not launch on the frozen route "
                      f"{plan.knn_route}: {routes}")
        winners = {c["cell"]: c["winner"] for c in cells[:3]}
        raw = float((tuned.labels == off.labels).float().mean())
        renamed = clustering_accuracy(off.labels, tuned.labels, 7)
        bitwise = bool(torch.equal(tuned.labels, off.labels))
        check(max(raw, renamed) >= MIN_TUNED_AGREEMENT,
              f"tuned vs untuned label agreement {max(raw, renamed)} < "
              f"{MIN_TUNED_AGREEMENT}")
        if all_default:
            check(bitwise, "every winner is the default route, yet the tuned "
                           "fit's labels differ from the untuned fit's")
        check(torch.equal(again.labels, tuned.labels)
              and torch.equal(again.protos, tuned.protos),
              "two tuned fits differ")
        serve_rate = agree / total
        check(serve_rate >= 0.999, f"tuned serve agreement {serve_rate} < 0.999")

        # stale entries at the fit's keys (and tc3xtf32 at d 64): warned
        # about, pruned, and the fit runs on the constants
        stale = tune.set_cache(str(Path(tmp) / "stale.json"))
        planted = [("knn", dict(n=n, d=d, k=2), {"impl": "pallas", "block_q": 256}),
                   ("assign", dict(nq=n, p=n, d=d, k=2), {"impl": "ref"}),
                   ("knn_block", dict(n=n, d=d, k=2), {"knn_block": 3000}),
                   ("knn", dict(n=2048, d=64, k=2), {"impl": "cuda", "route": "tc3xtf32"})]
        for kernel, dims, params in planted:
            stale.record(kind, kernel, tune.shape_bucket(**dims), params)
        x64 = torch.randn(2048, 64, generator=torch.Generator().manual_seed(3)).to(DEV)
        with runtime.configure(tune="cached"), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            splan = plan_fit(x, 3, 5, "kmeans", k=7, key=key, device=DEV)
            sfit = execute_plan(splan, x)
            ops.knn(x64, 2)
        stale_warnings = [str(w.message) for w in caught
                          if "stale tuning-cache" in str(w.message)]
        check(len(stale_warnings) == len(planted),
              f"{len(stale_warnings)} stale warnings for {len(planted)} planted")
        check(len(stale) == 0 and len(tune.TuningCache(stale.path)) == 0,
              "stale entries were not pruned")
        base_plan = plan_fit(x, 3, 5, "kmeans", k=7, key=key, device=DEV)
        check(all(getattr(splan, f) == getattr(base_plan, f) for f in _FROZEN),
              "a stale entry reached the plan")
        check(torch.equal(sfit.labels, off.labels),
              "the fit after the stale entries differs from the untuned fit")

        # onthefly: plan_fit on a miss measures and persists, the execution
        # (clamped to "cached") measures nothing
        fly = tune.set_cache(str(Path(tmp) / "onthefly.json"))
        xs = x[:TUNE["onthefly_n"]]
        with runtime.configure(tune="onthefly"):
            t1 = time.perf_counter()
            fplan = plan_fit(xs, 3, 3, "kmeans", k=7, key=key, device=DEV)
            fly_plan_s = time.perf_counter() - t1
            after_plan = len(fly)
            fres = execute_plan(fplan, xs)
            sync()
        check(after_plan == 3, f"onthefly plan_fit persisted {after_plan} "
                               f"entries (knn, knn_block, assign expected)")
        check(len(fly) == after_plan and len(tune.TuningCache(fly.path)) == after_plan,
              "execution measured under onthefly")
        check(bool(((fres.labels >= 0) & (fres.labels < 7)).all()),
              "onthefly fit labels outside [0, 7)")
        tune.set_cache(prev_cache)
    emit("tune", device_kind=kind, repeats=TUNE["repeats"],
         populate_seconds=round(populate_s, 3), cells=cells, skipped=skipped,
         every_winner_default=all_default, candidate_checks=checks,
         candidate_checks_seconds=round(checks_s, 3),
         fit=dict(seconds=round(tuned_s, 3),
                  frozen={f: getattr(plan, f) for f in _FROZEN},
                  untuned_frozen={f: getattr(base_plan, f) for f in _FROZEN},
                  agreement_with_untuned=raw, agreement_renamed=renamed,
                  bitwise_with_untuned=bitwise, bitwise_repeat=True,
                  lookups=fit_lookups, winners=winners),
         serve=dict(agreement_with_plain=serve_rate, lookups=serve_lookups),
         launches={kid: counts[kid] for kid in ("K1", "K1-bf16", "K1-int8", "K2",
                                                "K3", "K4")},
         launches_by_route=routes,
         stale=dict(warned=len(stale_warnings), pruned=len(planted),
                    fit_on_constants=True),
         onthefly=dict(n=TUNE["onthefly_n"], entries_after_plan=after_plan,
                       entries_after_execute=len(fly),
                       plan_seconds=round(fly_plan_s, 3),
                       frozen={f: getattr(fplan, f) for f in _FROZEN}),
         seconds=round(time.perf_counter() - t0, 3))


def phase_headline(state: dict) -> None:
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import gmm_sample

    n = SIZES["gmm"]
    x, comp = gmm_sample(n, seed=0)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = repro_torch.fit(x, 2, 3, "kmeans", k=3, key=prng.PRNGKey(0),
                          device=DEV)
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    state.update(headline_counts=counts, headline_routes=kernels.route_counts())
    acc = clustering_accuracy(comp, res.labels, 3)
    check(acc >= 0.90, f"GMM accuracy {acc} < 0.90 (the paper reports 0.9239)")
    check(counts["K1"] > 0, "K1 was not launched by the headline fit")
    emit("headline", n=n, t=2, m=3, k=3, accuracy=acc,
         seconds=round(wall, 3), mis_rounds=res.info["mis_rounds"],
         lloyd_iters=res.backend_result.iters,
         launches={kid: counts[kid] for kid in ("K1", "K2", "K3", "K4")},
         launches_by_route=state["headline_routes"])


def phase_determinism() -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy

    t0 = time.perf_counter()
    n = SIZES["det"]
    x, _ = _analog(n)
    runs = [repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                            device=DEV) for _ in range(2)]
    check(torch.equal(runs[0].labels, runs[1].labels)
          and torch.equal(runs[0].protos, runs[1].protos),
          "two kernel-path fits differ")
    plain = repro_torch.fit(x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0),
                            device=DEV, impl="ref")
    a, b = runs[0].labels, plain.labels
    raw = float((a == b).float().mean())
    renamed = clustering_accuracy(b, a, 7)
    check(max(raw, renamed) >= 0.999,
          f"kernel vs plain path label agreement {max(raw, renamed)} < 0.999")
    emit("determinism", n=n, bitwise_repeat=True,
         agreement_with_plain=raw, agreement_with_plain_renamed=renamed,
         assignments_equal=[bool(torch.equal(p, q)) for p, q in
                            zip(runs[0].assignments, plain.assignments)],
         seconds=round(time.perf_counter() - t0, 3))


def _no_backend(x, *, valid=None, weights=None, key=None, impl=None, **_):
    """A backend that labels every prototype 0: the hac phase's probe fit,
    which only counts each level's prototypes."""
    return torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)


def _valid_protos(res):
    """(prototypes, masses) of a fit's valid final rows."""
    keep = torch.nonzero(res.proto_valid).squeeze(1)
    return res.protos[keep].contiguous(), res.proto_mass[keep].contiguous()


def _hac_near_tie(p, w, merges, s0, pick_k, pick_p, linkage) -> dict:
    """Whether the kernel's and the plain path's picks at merge ``s0`` (the
    first where they part; the merges before it are the same) are a
    near-tie. Both picks' linkage heights are recomputed in float64 from
    the clusters' members (as tests/test_cluster_oracle.py defines them)
    and their gap is read in the units K4 computes, squared distances:
    for ward, the gap over the larger pair's mass factor w_a w_b / (w_a +
    w_b); for the other linkages, the gap between the squared heights. A
    near-tie is a gap within DIST_TOL of those squared distances."""
    x = p.double().cpu().numpy()
    mass = w.double().cpu().numpy()
    root = np.arange(x.shape[0])

    def find(i):
        while root[i] != i:
            i = root[i]
        return i

    for i, j in merges[:s0].tolist():
        root[find(j)] = find(i)
    members = {}
    for i in range(x.shape[0]):
        members.setdefault(find(i), []).append(i)

    def height(pair):
        a, b = (members[find(int(v))] for v in pair)
        wa, wb = mass[a], mass[b]
        if linkage == "ward":
            ca = (x[a] * wa[:, None]).sum(0) / wa.sum()
            cb = (x[b] * wb[:, None]).sum(0) / wb.sum()
            factor = wa.sum() * wb.sum() / (wa.sum() + wb.sum())
            return factor * float(((ca - cb) ** 2).sum()), factor
        dist = np.sqrt(((x[a][:, None, :] - x[b][None, :, :]) ** 2).sum(-1))
        if linkage == "single":
            return float(dist.min()), 1.0
        if linkage == "complete":
            return float(dist.max()), 1.0
        return float((wa[:, None] * wb[None, :] * dist).sum() / (wa.sum() * wb.sum())), 1.0

    (hk, fk), (hp, fp) = height(pick_k), height(pick_p)
    if linkage == "ward":
        scale = max(fk, fp)
        gap, sq = abs(hk - hp) / scale, max(hk / fk, hp / fp)
    else:
        gap, sq = abs(hk * hk - hp * hp), max(hk * hk, hp * hp)
    return dict(kernel_pair=[int(v) for v in pick_k], plain_pair=[int(v) for v in pick_p],
                kernel_height64=hk, plain_height64=hp, gap_sq_units=gap,
                near_tie=bool(gap <= DIST_TOL["atol"] + DIST_TOL["rtol"] * sq))


def phase_hac(state: dict, save: str = "") -> None:
    """IHTC + ward HAC on the paper's GMM at n = 10^6: m is the first level
    whose prototype count fits the HAC budget (and m + 1, m + 2); accuracy
    >= MIN_HAC_ACCURACY (``save``: an .npz of the fit's prototypes and
    labels, for tests/hac_reference_check.py). Then HAC alone on that
    fit's prototypes in all four linkages, kernel path (K4) and plain path;
    the merge loop once under sync debug mode "error"."""
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.cluster import hac as hac_mod
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import gmm_sample

    h = HAC
    t0 = time.perf_counter()
    x, comp = gmm_sample(SIZES["gmm"], seed=0)
    xd = dev(x)
    # each level draws the next key of one split chain, so a level's
    # prototypes do not depend on how many levels follow: one probe fit
    # counts them all
    probe = repro_torch.fit(xd, h["t"], h["probe_m"], _no_backend,
                            key=prng.PRNGKey(0), device=DEV)
    after = list(probe.info["n_valid"][1:]) + [int(probe.n_prototypes)]
    m = next((i + 1 for i, c in enumerate(after) if c <= h["budget"]), None)
    check(m is not None, f"no level of {h['probe_m']} fits the HAC budget: {after}")
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    res = repro_torch.fit(xd, h["t"], m, "hac", k=h["k"], linkage=h["linkage"],
                          key=prng.PRNGKey(0), device=DEV)
    sync()
    wall = time.perf_counter() - t1
    counts, routes = kernels.launch_counts(), kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    state.update(hac_counts=counts, hac_routes=routes)
    n_protos = int(res.n_prototypes)
    check(n_protos == after[m - 1] <= h["budget"],
          f"hac fit: {n_protos} prototypes, the probe counted {after[m - 1]}")
    for kid in ("K1", "K3", "K4"):
        check(counts[kid] > 0, f"{kid} was not launched by the hac path")
    check(routes.get("K4/tiled", 0) > 0, "K4's tiled instance did not run on HAC")
    if save:
        np.savez(save, protos=res.protos.cpu().numpy(), mass=res.proto_mass.cpu().numpy(),
                 valid=res.proto_valid.cpu().numpy(),
                 proto_labels=res.proto_labels.cpu().numpy(),
                 labels=res.labels.cpu().numpy(), n=SIZES["gmm"], m=m)
    # the reference benchmark's rows: the first level that fits, and the
    # next two
    accuracy = {m: clustering_accuracy(comp, res.labels, h["k"])}
    for mm in range(m + 1, m + 1 + h["extra_levels"]):
        r = repro_torch.fit(xd, h["t"], mm, "hac", k=h["k"], linkage=h["linkage"],
                            key=prng.PRNGKey(0), device=DEV)
        accuracy[mm] = clustering_accuracy(comp, r.labels, h["k"])
    for mm, acc in accuracy.items():
        check(acc >= MIN_HAC_ACCURACY,
              f"IHTC + HAC accuracy {acc} < {MIN_HAC_ACCURACY} at m = {mm}")
    acc = accuracy[m]

    # HAC alone on the fit's prototypes: kernel path against plain path
    p, w = _valid_protos(res)
    linkages = {}
    for linkage in ("single", "complete", "average", "ward"):
        t2 = time.perf_counter()
        a = hac_mod.hac(p, h["k"], weights=w, linkage=linkage, impl="cuda")
        sync()
        sec = time.perf_counter() - t2
        b = hac_mod.hac(p, h["k"], weights=w, linkage=linkage, impl="ref")
        agree = clustering_accuracy(b.labels, a.labels, h["k"])
        row = dict(seconds=sec, agreement=agree, n_merges=int(a.n_merges))
        parted = (a.merges != b.merges).any(dim=1).nonzero()
        if parted.numel():
            s0 = int(parted[0, 0])
            tie = _hac_near_tie(p, w, a.merges, s0, a.merges[s0], b.merges[s0], linkage)
            row.update(first_parting_merge=s0, kernel_height=float(a.heights[s0]),
                       plain_height=float(b.heights[s0]), **tie)
            check(tie["near_tie"], f"HAC {linkage}: the paths part at merge {s0} "
                  f"on no near-tie: {tie}")
        check(agree >= MIN_BACKEND_AGREEMENT,
              f"HAC {linkage}: kernel vs plain agreement {agree}")
        linkages[linkage] = row
        if linkage == h["linkage"]:
            ward = a

    # the merge loop alone under sync debug mode "error": no merge reads
    # the device
    d0 = hac_mod._initial_matrix(p, w, h["linkage"], "cuda")
    merges = int(ward.n_merges)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, pairs, _ = hac_mod.merge_loop(d0, w, h["linkage"], merges)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(pairs, ward.merges), "the merge loop under sync debug differs")
    emit("hac", n=SIZES["gmm"], t=h["t"], m=m, k=h["k"], linkage=h["linkage"],
         budget=h["budget"], prototypes_per_level=after, n_prototypes=n_protos,
         seconds=wall, n_merges=int(res.backend_result.n_merges), accuracy=acc,
         accuracy_by_m={str(k): v for k, v in accuracy.items()},
         max_memory_allocated=peak, launches={kid: counts[kid] for kid in
                                              ("K1", "K2", "K3", "K4")},
         launches_by_route=routes, linkages=linkages, sync_free_merge_loop=True,
         phase_seconds=time.perf_counter() - t0)


def _calibrate_eps(x: torch.Tensor, rows: int, seed: int = 0) -> float:
    """bench_table9_dbscan.calibrate_eps with the port's kNN: the median
    4-NN distance of a ``rows``-row subsample."""
    from repro_torch.core.knn import knn_graph

    rng = np.random.default_rng(seed)
    sub = x[dev(rng.choice(x.shape[0], size=min(rows, x.shape[0]), replace=False))]
    d, _ = knn_graph(sub.contiguous(), 4)
    return float(np.sqrt(np.median(d.cpu().numpy()[:, -1])))


def phase_dbscan(state: dict) -> None:
    """IHTC + DBSCAN on the 50,000-row covertype analog at m = 0, 1, 2
    (the paper's Table 9): walls, clusters, noise share, BSS/TSS, peak
    memory, propagation rounds. Then DBSCAN alone on the m = 2 fit's
    prototypes, kernel path against plain path."""
    import repro_torch
    from repro_torch import kernels, prng
    from repro_torch.cluster import dbscan as dbscan_mod
    from repro_torch.cluster.metrics import bss_tss
    from repro_torch.kernels import ops

    c = DBSCAN
    t0 = time.perf_counter()
    x = _dbscan_data()
    eps = _calibrate_eps(x, c["eps_rows"])
    sync()
    kernels.reset_launch_counts()
    fits, rows = {}, []
    for m in c["ms"]:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res = repro_torch.fit(x, c["t"], m, "dbscan", eps=eps, min_pts=c["min_pts"],
                              key=prng.PRNGKey(2), device=DEV)
        sync()
        rows.append(dict(m=m, seconds=time.perf_counter() - t1,
                         n_prototypes=int(res.n_prototypes),
                         rounds=res.backend_result.rounds,
                         max_memory_allocated=torch.cuda.max_memory_allocated()))
        fits[m] = res
    counts, routes = kernels.launch_counts(), kernels.route_counts()
    state.update(dbscan_counts=counts, dbscan_routes=routes)
    check(counts["K4"] >= len(c["ms"]), "K4 was not launched by every dbscan fit")
    check(routes.get("K4/tiled", 0) > 0, "K4's tiled instance did not run on DBSCAN")
    for row in rows:
        lab = fits[row["m"]].labels
        check(lab.shape == (x.shape[0],), "dbscan labels shape")
        k_found = int(lab.max()) + 1
        row.update(clusters=k_found, noise_share=float((lab < 0).float().mean()),
                   bss_tss=float(bss_tss(x, lab, max(k_found, 1))))
        check(np.isfinite(row["bss_tss"]), "non-finite BSS/TSS")

    # kernel path against plain path on the m = 2 fit's prototypes: where
    # labels differ, some pair's kernel and plain distances lie on opposite
    # sides of eps²; with no such pair the two must agree bit for bit
    p, w = _valid_protos(fits[max(c["ms"])])
    a = dbscan_mod.dbscan(p, eps, c["min_pts"], weights=w, impl="cuda")
    b = dbscan_mod.dbscan(p, eps, c["min_pts"], weights=w, impl="ref")
    agree = float((a.labels == b.labels).float().mean())
    eps2 = dbscan_mod._f32(dbscan_mod._f32(eps) ** 2)
    across = int(((ops.pairwise_sq_l2(p, p, impl="cuda") <= eps2)
                  != (ops.pairwise_sq_l2(p, p, impl="ref") <= eps2)).sum())
    check(agree >= MIN_BACKEND_AGREEMENT, f"DBSCAN kernel vs plain agreement {agree}")
    if across == 0:
        check(torch.equal(a.labels, b.labels) and torch.equal(a.is_core, b.is_core),
              "DBSCAN paths differ with the same eps-graph")
    emit("dbscan", n=x.shape[0], d=x.shape[1], t=c["t"], eps=eps,
         min_pts=c["min_pts"], fits=rows,
         plain_vs_kernel=dict(m=max(c["ms"]), prototypes=p.shape[0], agreement=agree,
                              core_agreement=float((a.is_core == b.is_core).float().mean()),
                              pairs_across_eps2=across, rounds=[a.rounds, b.rounds]),
         launches={kid: counts[kid] for kid in ("K1", "K2", "K3", "K4")},
         launches_by_route=routes, seconds=time.perf_counter() - t0)


def _pct(values, q) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


async def _closed_loop(svc, queries, reps: int) -> list:
    """``reps`` requests one after another (each awaited): latencies, ms."""
    loop = asyncio.get_running_loop()
    out = []
    for _ in range(reps):
        t0 = loop.time()
        await svc.submit(queries)
        out.append((loop.time() - t0) * 1e3)
    return out


async def _open_loop(svc, pool, *, qps, duration, sizes, fire_at, fire):
    """Open-loop traffic at ``qps`` for ``duration`` seconds, request sizes
    cycling through ``sizes``; ``fire()`` (loop-blocking: the refresh)
    runs at ``fire_at``. Returns (records, errors, swap window)."""
    loop = asyncio.get_running_loop()
    rng = np.random.default_rng(5)
    records, errors, window = [], [], None
    t0 = loop.time()
    next_t, i = 0.0, 0
    while next_t < duration:
        if window is None and next_t >= fire_at:
            w0 = loop.time()
            fire()
            window = (w0, loop.time())
        gap = t0 + next_t - loop.time()
        if gap > 0:
            await asyncio.sleep(gap)
        n = sizes[i % len(sizes)]
        lo = int(rng.integers(0, pool.shape[0] - n))
        rec = {"n": n, "t_submit": loop.time(), "t_done": None}
        fut = svc.submit(pool[lo:lo + n])

        def done(f, rec=rec):
            rec["t_done"] = loop.time()
            if f.cancelled() or f.exception() is not None:
                errors.append(repr(f.exception()))
        fut.add_done_callback(done)
        records.append(rec)
        i += 1
        next_t += 1.0 / qps
    while any(r["t_done"] is None for r in records):
        await asyncio.sleep(0.002)
    return records, errors, window


def phase_online(results: dict, state: dict) -> None:
    """The online loop at full size: stream → fit → pack → store → async
    serve under the three fused impls → refresh under live traffic."""
    from repro_torch import kernels, prng
    from repro_torch.core.index import ClusterIndex, nearest_valid_prototype
    from repro_torch.data import PointStreamConfig, point_chunk, point_chunks
    from repro_torch.serve import (AsyncClusterService, IndexStore,
                                   OnlineFitter, RefreshDriver, RefreshPolicy)

    o = ONLINE
    t_phase = time.perf_counter()
    cfg = PointStreamConfig(n=o["n"], d=o["d"], chunk=o["chunk"], seed=0,
                            kind="blobs", k=o["k"])
    n_chunks = -(-o["n"] // o["chunk"])
    # the same generator further on: points the fit never saw (100,000
    # for serving, then the drifted stream)
    n_home = -(-100_000 // o["chunk"])
    n_drift = o["refresh_points"] // o["chunk"]
    beyond = PointStreamConfig(n=(n_chunks + n_home + n_drift) * o["chunk"],
                               d=o["d"], chunk=o["chunk"], seed=0,
                               kind="blobs", k=o["k"])
    store_dir = ROOT / "build" / "online_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    # ---- stream → fit
    t0 = time.perf_counter()
    fitter = OnlineFitter(point_chunks(cfg), o["t"], o["m"], "kmeans",
                          k=o["k"], prefetch_depth=o["depth"],
                          key=prng.PRNGKey(0), device=DEV)
    sync()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = fitter.snapshot()
    sync()
    snapshot_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = snap.spill.ingest_stats
    check(fitter.n_points == o["n"] and fitter.n_chunks == n_chunks,
          f"stream folded {fitter.n_points} points in {fitter.n_chunks} chunks")
    check(bool(torch.isfinite(snap.protos).all()), "non-finite prototypes")
    mass = float(snap.proto_mass[snap.proto_valid].double().sum())
    check(abs(mass - o["n"]) < 1e-3 * o["n"], f"prototype mass {mass} != n")

    # ---- pack → store → load
    t0 = time.perf_counter()
    index = ClusterIndex.build(snap, pack=True).check_servable(expect_dim=o["d"])
    store = IndexStore(store_dir)
    v1 = store.save(index, metadata={"n_points": fitter.n_points})
    loaded = store.load(v1, expect_dim=o["d"], device=DEV)
    sync()
    store_s = time.perf_counter() - t0
    for f in ("protos", "proto_valid", "proto_labels", "protos_bf16",
              "protos_q8", "q8_scale", "q8_zero"):
        check(torch.equal(getattr(loaded, f), getattr(index, f)),
              f"IndexStore round trip changed {f}")

    # ---- serve under the three fused impls
    gen = np.random.default_rng(3)
    home = np.concatenate([point_chunk(beyond, n_chunks + j)
                           for j in range(n_home)])[:100_000]
    assign_ms, agreement, services = {}, {}, {}

    async def serve_all():
        for impl in ("fused", "fused_bf16", "fused_int8"):
            # no flush deadline: a request dispatches at once, so a closed
            # loop times the serve path, not the batching wait
            svc = AsyncClusterService(loaded, buckets=o["buckets"], impl=impl,
                                      max_wait=0.0, queue_depth=1 << 22)
            services[impl] = svc
            lat = {}
            for n in o["sizes"]:
                lo = int(gen.integers(0, home.shape[0] - n))
                lat[str(n)] = await _closed_loop(svc, home[lo:lo + n],
                                                 o["reps"][n])
            assign_ms[impl] = {n: {"p50": _pct(v, 50), "p99": _pct(v, 99)}
                               for n, v in lat.items()}
            agreement[impl] = await svc.submit(home)
    asyncio.run(serve_all())
    exact = agreement["fused"]
    plain = loaded.assign(home, impl="ref").cpu().numpy()
    agree = {impl: float((lab == exact).mean()) for impl, lab in agreement.items()}
    agree["plain_vs_fused"] = float((plain == exact).mean())
    for name, a in agree.items():
        check(a >= MIN_QUANT_AGREEMENT, f"online label agreement {name}: {a}")

    # ---- refresh under live traffic (the drifted stream)
    svc = services["fused_int8"]
    drifted = [point_chunk(beyond, n_chunks + n_home + i) + o["drift_shift"]
               for i in range(n_drift)]
    pool = np.concatenate(drifted[:2])
    driver = RefreshDriver(svc, fitter, store=store,
                           policy=RefreshPolicy(max_points=o["refresh_points"]))
    t0 = time.perf_counter()
    for c in drifted[:-1]:  # evidence ahead of the timed window
        check(driver.observe(c) is None, "refresh fired before the window")
    sync()
    observe_s = time.perf_counter() - t0
    stale = svc.current_index()
    fired = []
    records, errors, window = asyncio.run(_open_loop(
        svc, pool, qps=o["qps"], duration=o["traffic_s"], sizes=o["sizes"],
        fire_at=o["traffic_s"] / 2,
        fire=lambda: fired.append(driver.observe(drifted[-1]))))
    sched = svc.stats_snapshot()["scheduler"]
    check(fired == [2] and svc.version() == 2,
          f"the refresh did not install version 2 ({fired})")
    check(not errors and sched["failed"] == 0 and sched["rejected"] == 0,
          f"requests failed across the swap: {errors[:3]} {sched}")
    swap_ms = (window[1] - window[0]) * 1e3
    lat = [(r["t_done"] - r["t_submit"]) * 1e3 for r in records]
    stalled = [(r["t_done"] - r["t_submit"]) * 1e3 for r in records
               if r["t_submit"] <= window[1] and r["t_done"] >= window[0]]
    fresh = svc.current_index()
    saved = store.load(store.latest(), device=DEV)
    for f in ("protos", "protos_q8", "q8_scale", "protos_bf16", "proto_labels"):
        check(torch.equal(getattr(saved, f), getattr(fresh, f)),
              f"the stored refresh differs from the installed index in {f}")

    def mean_dist(idx, x):
        dd, _ = nearest_valid_prototype(dev(x), idx.protos, idx.proto_valid)
        return float(torch.sqrt(torch.clamp_min(dd, 0.0)).mean())
    ratio = mean_dist(fresh, pool) / max(mean_dist(stale, pool), 1e-12)
    check(ratio < 1.0, f"the refresh did not move the index toward the "
                       f"drifted traffic (distance ratio {ratio})")
    asyncio.run(_drain_all(services))
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    state["online_counts"] = counts
    state["online_routes"] = routes
    # the quantized shortlist (k 8) never takes the CUDA-core route
    stale_routes = {r: n for r, n in routes.items()
                    if r.startswith(("K1-bf16/", "K1-int8/")) and r.endswith("/cuda_core")}
    check(not stale_routes, f"quantized K1 launches on the CUDA-core route: {stale_routes}")
    # every level of this path has more than 8192 rows (the smallest TC
    # input is the finalize's 3rd level, about 19,400), so K2 is not on it
    for kid in ("K1", "K1-bf16", "K1-int8", "K3", "K4"):
        check(counts[kid] > 0, f"{kid} was not launched by the online path")

    # the whole stream's prototypes, seeding taken out (see _restarted),
    # against the generating blobs on every 10th chunk
    sample = range(0, n_chunks, 10)
    truth = np.concatenate([point_chunk(cfg, c, with_labels=True)[1]
                            for c in sample])
    quality = _restarted(snap, sample, truth)
    check(quality["accuracy"] >= MIN_BLOB_ACCURACY,
          f"online fit: accuracy {quality['accuracy']} against the "
          f"generating blobs")

    # the K1 variants at the serve shape, on the real final index
    _k1_variants(results, loaded.protos, loaded.proto_valid,
                 dev(home[:max(o["sizes"])]), path="online")

    emit("online", n=o["n"], d=o["d"], chunks=n_chunks, chunk=o["chunk"],
         t=o["t"], m=o["m"], k=o["k"], prefetch_depth=o["depth"],
         stream_s=stream_s, stream_points_per_s=o["n"] / stream_s,
         snapshot_s=snapshot_s, ingest_wait_s=st["ingest_wait_s"],
         cascades=fitter.n_cascades, reservoir_n=st["reservoir_n"],
         finalize_level_sizes=st["finalize_level_sizes"],
         n_prototypes=int(index.n_prototypes), index_rows=index.protos.shape[0],
         quality=quality,
         max_memory_allocated=peak, store_s=store_s, assign_ms=assign_ms,
         label_agreement=agree, refresh={
             "observe_s": observe_s, "swap_ms": swap_ms,
             "stall_p99_ms": _pct(stalled, 99) if stalled else 0.0,
             "stalled_requests": len(stalled), "requests": len(records),
             "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
             "failed": sched["failed"] + len(errors), "swaps": sched["swaps"],
             "distance_ratio": ratio, "history": driver.history},
         launches={kid: counts[kid] for kid in
                   ("K1", "K1-bf16", "K1-int8", "K2", "K3", "K4", "K5")},
         launches_by_route=routes, seconds=time.perf_counter() - t_phase)
    _online_determinism(cfg)


async def _drain_all(services) -> None:
    for svc in services.values():
        await svc.drain()


def _partition_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of points whose cluster in ``a`` maps onto their cluster in
    ``b`` (each cluster of one labelling matched to the cluster of the
    other that holds most of its points; the smaller of both directions).
    Invariant to renumbering: TC numbers its clusters by seed rank, so one
    extra seed renumbers every later cluster."""
    def one_way(x, y):
        keep = (x >= 0) & (y >= 0)
        x, y = x[keep].astype(np.int64), y[keep].astype(np.int64)
        pairs, counts = np.unique(x * (int(y.max()) + 1) + y, return_counts=True)
        best = np.zeros(int(x.max()) + 1, np.int64)
        np.maximum.at(best, pairs // (int(y.max()) + 1), counts)
        return float(best.sum()) / max(x.size, 1)
    return min(one_way(a, b), one_way(b, a))


def _restarted(r, chunk_ids, truth) -> dict:
    """k-means alone on a fit's final prototypes (mass-weighted) under
    SEED_RESTARTS keys; the lowest-inertia run's labels backed out through
    the fit's spill to the points of ``chunk_ids`` and held against their
    generating components. One k-means++ seeding lands this blob mixture
    in a worse local optimum for about half of all keys, on either path
    (PERF.md, PR 13), so the restarts take the seeding out of what is
    compared and leave the levels that built the prototypes."""
    from repro_torch import prng
    from repro_torch.cluster.kmeans import kmeans
    from repro_torch.cluster.metrics import clustering_accuracy

    o = ONLINE
    t0 = time.perf_counter()
    runs = [kmeans(r.protos, o["k"], valid=r.proto_valid, weights=r.proto_mass,
                   key=prng.PRNGKey(s)) for s in range(SEED_RESTARTS)]
    best = min(runs, key=lambda x: float(x.inertia))
    plab = best.labels.cpu().numpy()
    lab = np.concatenate([r.spill.labels_for(c, plab) for c in chunk_ids])
    own = np.concatenate([r.labels_for(c) for c in chunk_ids])
    return {"inertia": float(best.inertia),
            "accuracy": clustering_accuracy(truth, lab, o["k"]),
            "own_inertia": float(r.backend_result.inertia),
            "own_accuracy": clustering_accuracy(truth, own, o["k"]),
            "seconds": time.perf_counter() - t0}


def _online_determinism(cfg) -> None:
    """The first chunks of the stream through the streaming executor:
    prefetch depth 0 and 2 must give the same bits; the plain path
    (impl="ref") must agree with the kernel path on >= 0.999 of every
    chunk's level-0 partition (compared up to renumbering, see
    _partition_agreement); and each path's final prototypes, clustered
    with SEED_RESTARTS k-means seedings, must label the points as the
    generating blobs do (accuracy >= MIN_BLOB_ACCURACY) at a lowest
    inertia within MAX_INERTIA_GAP of the other path's. The fits' own
    labels (one seeding each) and their agreement are reported."""
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import point_chunk

    o = ONLINE
    t0 = time.perf_counter()
    pairs = [point_chunk(cfg, i, with_labels=True) for i in range(o["det_chunks"])]
    chunks = [c for c, _ in pairs]
    truth = np.concatenate([comp for _, comp in pairs])
    kw = dict(k=o["k"], key=prng.PRNGKey(0), device=DEV)
    runs = {depth: repro_torch.fit(iter(chunks), o["t"], o["m"], "kmeans",
                                   prefetch_depth=depth, **kw)
            for depth in (0, 2)}
    a, b = runs[0], runs[2]
    la, lb = np.asarray(a.labels), np.asarray(b.labels)
    check(np.array_equal(la, lb) and torch.equal(a.protos, b.protos),
          "prefetch depth 0 and 2 streams differ")
    plain = repro_torch.fit(iter(chunks), o["t"], o["m"], "kmeans", impl="ref",
                            **kw)
    maps = [_partition_agreement(x, y) for x, y in
            zip(a.spill.chunk_assign, plain.spill.chunk_assign)]
    ids = range(o["det_chunks"])
    quality = {"kernel": _restarted(a, ids, truth),
               "plain": _restarted(plain, ids, truth)}
    gap = quality["kernel"]["inertia"] / quality["plain"]["inertia"] - 1.0
    emit("online_determinism", chunks=o["det_chunks"], depth0_vs_depth2_bitwise=True,
         level0_partition_agreement=maps,
         final_label_agreement_renamed=clustering_accuracy(
             np.asarray(plain.labels), la, o["k"]),
         restarts=SEED_RESTARTS, quality=quality, inertia_gap=gap,
         cascades=[a.n_cascades, plain.n_cascades],
         n_prototypes=[int(a.n_prototypes), int(plain.n_prototypes)],
         seconds=time.perf_counter() - t0)
    check(min(maps) >= MIN_QUANT_AGREEMENT,
          f"stream kernel vs plain path: level-0 partition agreement {min(maps)}")
    for path, q in quality.items():
        check(q["accuracy"] >= MIN_BLOB_ACCURACY,
              f"stream {path} path: accuracy {q['accuracy']} against the "
              f"generating blobs")
    check(abs(gap) <= MAX_INERTIA_GAP,
          f"stream kernel vs plain path: lowest k-means inertia {gap:+.4f} apart")


def _point_sse(x: torch.Tensor, labels: np.ndarray, k: int) -> float:
    """Within-cluster sum of squares of the points under ``labels``
    (centres are the label means; float64 on the device)."""
    lab = torch.as_tensor(labels, device=x.device).long()
    keep = lab >= 0
    xd, lab = x[keep].double(), lab[keep]
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    sums.index_add_(0, lab, xd)
    cnt = torch.bincount(lab, minlength=k).double().clamp_min(1.0)
    return float(((xd - (sums / cnt[:, None])[lab]) ** 2).sum())


def phase_basins() -> None:
    """Which k-means optimum the kernel path and the plain path reach on
    the online stream's first 8 chunks: both paths under several PRNG
    keys, on the data and on the data scaled by 1 + 2^-22, each with its
    prototype-level inertia, the points' within-cluster sum of squares and
    its accuracy against the generating components; then k-means alone
    (both impls, the same keys) on each path's final prototypes, which
    separates the prototypes from the seeding."""
    import repro_torch
    from repro_torch import prng
    from repro_torch.cluster.kmeans import kmeans
    from repro_torch.cluster.metrics import clustering_accuracy
    from repro_torch.data import PointStreamConfig, point_chunk

    o = ONLINE
    t0 = time.perf_counter()
    cfg = PointStreamConfig(n=o["n"], d=o["d"], chunk=o["chunk"], seed=0,
                            kind="blobs", k=o["k"])
    pairs = [point_chunk(cfg, i, with_labels=True) for i in range(o["det_chunks"])]
    chunks = [c for c, _ in pairs]
    truth = np.concatenate([comp for _, comp in pairs])
    x = dev(np.concatenate(chunks))
    emit("basins", run="truth", point_sse=_point_sse(x, truth, o["k"]))
    keep = {}
    for scale in (1.0, 1 + 2.0 ** -22):
        data = chunks if scale == 1.0 else [c * np.float32(scale) for c in chunks]
        for seed in range(o["basin_keys"] if scale == 1.0 else 1):
            for path, impl in (("kernel", None), ("plain", "ref")):
                r = repro_torch.fit(iter(data), o["t"], o["m"], "kmeans",
                                    k=o["k"], key=prng.PRNGKey(seed),
                                    impl=impl, device=DEV)
                lab = np.asarray(r.labels)
                if seed == 0 and scale == 1.0:
                    keep[path] = r
                emit("basins", run="fit", path=path, key=seed, scale=scale,
                     n_prototypes=int(r.n_prototypes),
                     inertia=float(r.backend_result.inertia),
                     lloyd_iters=int(r.backend_result.iters),
                     point_sse=_point_sse(x, lab, o["k"]),
                     accuracy=clustering_accuracy(truth, lab, o["k"]))
    for path, r in keep.items():
        for impl in (None, "ref"):
            inert = [float(kmeans(r.protos, o["k"], valid=r.proto_valid,
                                  weights=r.proto_mass, key=prng.PRNGKey(s),
                                  impl=impl).inertia)
                     for s in range(2 * o["basin_keys"])]
            emit("basins", run="kmeans_on_prototypes", prototypes=path,
                 impl=impl or "auto", inertia=inert)
    emit("basins", run="done", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------- training


def _trainer(state: dict) -> dict:
    """The train and select phases' trainer, built once: gemma2-2b at full
    width, f32 trainable weights drawn from a seeded generator, zero AdamW
    state, the launcher's batches (b 8, s 256) and a remat="block" step
    under the reference test's schedule at the default peak lr."""
    if "trainer" in state:
        return state["trainer"]
    from repro_torch.configs import ARCHS, SHAPES, ParallelConfig
    from repro_torch.launch.train import batch_dims, batch_fn, init_state
    from repro_torch.train import OptConfig, make_train_step

    t0 = time.perf_counter()
    cfg = ARCHS[TRAIN["arch"]]
    bundle, model, opt = init_state(cfg, device=DEV, seed=TRAIN["seed"])
    opt_cfg = OptConfig(peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup"],
                        decay_steps=TRAIN["decay"])
    b, s = batch_dims(SHAPES["train_4k"])
    sync()
    state["trainer"] = dict(
        cfg=cfg, bundle=bundle, model=model, opt=opt, b=b, s=s,
        step=make_train_step(bundle, opt_cfg, ParallelConfig(remat="block")),
        bfs=batch_fn(cfg, SHAPES["train_4k"], b, s, torch.device(DEV)),
        init_s=time.perf_counter() - t0)
    return state["trainer"]


def _synced(step_fn):
    """The step, ending in a synchronise: StepStats then times device work."""
    def run(*args):
        out = step_fn(*args)
        sync()
        return out
    return run


@contextlib.contextmanager
def _timed_adamw(times: list):
    """While the block runs, each AdamW update of the train step is timed
    with CUDA events (milliseconds appended to ``times`` at exit)."""
    from repro_torch.train import train_step as ts

    inner, events = ts.adamw_update, []

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kw)
        z.record()
        events.append((a, z))
        return out

    ts.adamw_update = timed
    try:
        yield
    finally:
        ts.adamw_update = inner
        sync()
        times.extend(a.elapsed_time(z) for a, z in events)


def _host_params(model) -> dict:
    """A host copy of every parameter, pinned where the host allows it."""
    out = {}
    for n, p in model.named_parameters():
        try:
            h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
        except RuntimeError:  # no page-locked memory left: a pageable copy
            h = torch.empty(p.shape, dtype=p.dtype)
        out[n] = h.copy_(p.detach(), non_blocking=True)
    sync()
    return out


def _tensor_bytes(*trees) -> int:
    """Bytes of the distinct storages of every tensor in ``trees`` (a
    module counts its parameters)."""
    from torch.utils._pytree import tree_flatten

    seen = {}
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters())
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _beside_inputs(model, *inputs) -> int:
    """Reset the card's peak memory and return the bytes allocated beside a
    step's inputs (the parameters and ``inputs``: the optimizer state, the
    caches; a train step's last gradients go first, as the step's first act
    drops them): a step's own peak is then ``max_memory_allocated()`` less
    this."""
    for p in model.parameters():
        p.grad = None
    if not torch.cuda.is_available():
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() - _tensor_bytes(model, *inputs)


def _steps_timed(step, model, opt, bfs, n_rep: int, n_steps: int) -> dict:
    """``n_steps`` synchronised steps from (model, opt), a host copy of the
    parameters taken after the first ``n_rep`` (outside the step times);
    each AdamW update timed with CUDA events."""
    from repro_torch.train.fault_tolerance import run_training

    mets: list = []
    adamw_ms: list = []
    t0 = time.perf_counter()
    with _timed_adamw(adamw_ms):
        model, opt, st_a = run_training(
            train_step=step, init_state=(model, opt), batch_for_step=bfs,
            n_steps=n_rep, on_metrics=lambda s, m: mets.append(m))
        t_snap = time.perf_counter()
        snap = _host_params(model)
        snapshot_s = time.perf_counter() - t_snap
        model, opt, st_b = run_training(
            train_step=step, init_state=(model, opt), batch_for_step=bfs,
            n_steps=n_steps, start_step=n_rep, on_metrics=lambda s, m: mets.append(m))
    return dict(model=model, opt=opt, mets=mets, snap=snap, adamw_ms=adamw_ms,
                times=st_a.times + st_b.times, train_s=time.perf_counter() - t0,
                snapshot_s=snapshot_s)


def _repeat_from_seed(run: dict, step, bfs, seed: int, n_rep: int):
    """The first ``n_rep`` steps again from the seeded draw and a fresh
    AdamW state: (model, opt, losses equal, parameters equal), bit for bit
    against the first run's metrics and host copy."""
    from repro_torch.train.fault_tolerance import run_training
    from repro_torch.train.optimizer import init_opt_state

    model = run.pop("model")
    run.pop("opt")  # its moments go before the fresh ones are made
    model.init_weights(torch.Generator(device=DEV).manual_seed(seed))
    again: list = []
    model, opt, _ = run_training(
        train_step=step, init_state=(model, init_opt_state(model)),
        batch_for_step=bfs, n_steps=n_rep, on_metrics=lambda s, m: again.append(m))
    snap = run.pop("snap")
    loss_repeat = all(torch.equal(a["loss"], b["loss"])
                      for a, b in zip(again, run["mets"]))
    param_repeat = all(torch.equal(p.detach(), snap[n].to(p.device, non_blocking=True))
                       for n, p in model.named_parameters())
    return model, opt, loss_repeat, param_repeat


def _resume_at_smoke(arch: str):
    """A checkpoint resume at the smoke config of ``arch`` (the reference
    test's set-up): 10 steps straight against 5 + save + restore (into a
    model drawn from another seed) + 5, bit for bit. (equal, config name)"""
    import tempfile

    from repro_torch.configs import ARCHS, SHAPES, smoke_config
    from repro_torch.launch.train import batch_fn, init_state
    from repro_torch.train import CheckpointManager, OptConfig, make_train_step
    from repro_torch.train.fault_tolerance import run_training

    scfg = smoke_config(ARCHS[arch])
    rs, at = TRAIN["resume_steps"], TRAIN["resume_at"]
    sbundle, _, _ = init_state(scfg, device=DEV)
    sstep = make_train_step(sbundle, OptConfig(peak_lr=1e-2, warmup_steps=5,
                                               decay_steps=60))
    sbfs = batch_fn(scfg, SHAPES["train_4k"], 8, 32, torch.device(DEV))
    _, pa, oa = init_state(scfg, device=DEV)
    pa, _, _ = run_training(train_step=sstep, init_state=(pa, oa),
                            batch_for_step=sbfs, n_steps=rs)
    _, p5, o5 = init_state(scfg, device=DEV)
    p5, o5, _ = run_training(train_step=sstep, init_state=(p5, o5),
                             batch_for_step=sbfs, n_steps=at)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(at, {"params": p5, "opt": o5})
        _, other, other_opt = init_state(scfg, device=DEV, seed=1)
        rest = ck.restore(at, {"params": other, "opt": other_opt})
    pb, _, _ = run_training(train_step=sstep, init_state=(rest["params"], rest["opt"]),
                            batch_for_step=sbfs, n_steps=rs, start_step=at)
    sync()
    return all(torch.equal(a, b) for a, b in zip(pa.parameters(), pb.parameters(),
                                                 strict=True)), scfg.name


def _step_fields(times: list, tokens_per_step: int, adamw_ms: list) -> dict:
    """The first step apart (warm-up: allocator, cuBLAS handles), then
    p50/p99, tokens/s and AdamW's median and share over steps 2..n."""
    step_ms = [t * 1e3 for t in times]
    steady = step_ms[1:]
    return dict(step_ms_first=step_ms[0],
                step_ms_p50=float(np.quantile(steady, 0.5)),
                step_ms_p99=float(np.quantile(steady, 0.99)),
                tokens_per_s=tokens_per_step * len(steady) * 1e3 / sum(steady),
                tokens_per_s_at_p50=tokens_per_step * 1e3 / np.quantile(steady, 0.5),
                adamw_ms_p50=float(np.median(adamw_ms[1:])),
                adamw_share=sum(adamw_ms[1:]) / sum(steady))


def _train_checks(which: str, losses: list, gnorms: list, loss_repeat: bool,
                  param_repeat: bool, resume: bool, counts: dict) -> None:
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"{which}: non-finite loss or grad norm")
    check(last < MIN_LOSS_DROP * first,
          f"{which}: loss did not fall: mean of the last four {last} >= "
          f"{MIN_LOSS_DROP} x mean of the first four {first}")
    check(loss_repeat, f"{which}: two repeats of the first steps differ in loss")
    check(param_repeat, f"{which}: two repeats of the first steps differ in parameters")
    check(resume, f"{which}: a resumed run differs from the straight run")
    check(not any(counts.values()),
          f"{which}: training launched kernels {counts}: it takes the plain route")


def phase_train(state: dict) -> None:
    """gemma2-2b at full width through the launcher's functions: 24 AdamW
    steps (loss criterion), two repeats of 4 steps from the seeded state
    (bitwise), then a checkpoint resume at the smoke config (bitwise)."""
    from repro_torch import kernels
    from repro_torch.utils.tree import tree_bytes, tree_size

    tr = _trainer(state)
    n_rep = TRAIN["repeat_steps"]
    step = _synced(tr["step"])
    other = _beside_inputs(tr["model"], tr["opt"])
    kernels.reset_launch_counts()
    run = _steps_timed(step, tr["model"], tr["opt"], tr["bfs"], n_rep, TRAIN["steps"])
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    state["train_counts"] = counts
    state["train_routes"] = kernels.route_counts()
    n_params = tree_size(run["model"])
    state_bytes = tree_bytes({"p": run["model"], "o": run["opt"]})
    losses = [float(m["loss"]) for m in run["mets"]]
    gnorms = [float(m["grad_norm"]) for m in run["mets"]]

    tr["opt"] = None
    tr["model"], tr["opt"], loss_repeat, param_repeat = _repeat_from_seed(
        run, step, tr["bfs"], TRAIN["seed"], n_rep)
    resume, resume_arch = _resume_at_smoke(TRAIN["arch"])

    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    fields = _step_fields(run["times"], tr["b"] * tr["s"], run["adamw_ms"])
    state["train_measured"] = dict(p50_ms=fields["step_ms_p50"], peak_bytes=peak,
                                   beside_bytes=other, batch=tr["b"], seq=tr["s"])
    emit("train", arch=tr["cfg"].name, params=n_params, state_bytes=state_bytes,
         batch=tr["b"], seq=tr["s"], steps=len(losses), remat="block",
         init_s=round(tr["init_s"], 3), train_s=round(run["train_s"], 3),
         snapshot_s=round(run["snapshot_s"], 3),
         loss_first4=losses[:4], loss_last4=losses[-4:],
         loss_ratio=last / first, grad_norms=gnorms, **fields,
         max_memory_allocated=peak,
         launches={k: v for k, v in counts.items() if v},
         bitwise_repeat=bool(loss_repeat and param_repeat),
         resume_bitwise=bool(resume), resume_arch=resume_arch)
    _train_checks("train", losses, gnorms, loss_repeat, param_repeat, resume, counts)


@contextlib.contextmanager
def _segsum_diffs():
    """While the block runs, each SSD chunk's largest decay sum above the
    diagonal is appended as a device scalar (``mamba2.segsum_exp`` is
    wrapped). Past EXP_F32_MAX_ARG the reference's exp-then-mask overflows
    there and its backward gives NaN; the port masks first."""
    from repro_torch.models import mamba2

    real = mamba2.segsum_exp
    diffs: list = []

    def watched(a):
        cs = torch.cumsum(a.detach(), dim=-2).transpose(-1, -2)
        q = cs.shape[-1]
        upper = torch.triu(torch.ones(q, q, dtype=torch.bool, device=a.device), 1)
        diff = cs[..., :, None] - cs[..., None, :]
        diffs.append(torch.where(upper, diff, -torch.inf).amax())
        return real(a)

    mamba2.segsum_exp = watched
    try:
        yield diffs
    finally:
        mamba2.segsum_exp = real


def _draws_on_card(cfg, bfs) -> dict:
    """The card's draws against the host's, bit for bit (the host's are
    ``jax.random``'s: tests/test_torch_prng.py): 2^20 normal,
    exponential, Gumbel and Pareto draws, and the phase's first batch."""
    from repro_torch import prng
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch

    key, n = prng.PRNGKey(7), 1 << 20
    out = {}
    for name, draw in (("normal", prng.normal), ("exponential", prng.exponential),
                       ("gumbel", prng.gumbel),
                       ("pareto", lambda k, s, **kw: prng.pareto(k, 1.3, s, **kw))):
        out[name] = torch.equal(draw(key, n, device=DEV).cpu(), draw(key, n))
    card = bfs(0)
    b, s = card["tokens"].shape
    host = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=b, seq_override=s)
    out["batch"] = set(card) == set(host) and all(
        torch.equal(card[k].cpu(), host[k]) for k in host)
    return out


def _train_cut(full, cfg, n_params: int, full_params: int, per_param: int) -> str:
    gb = per_param / 1e9
    if cfg.n_layers == full.n_layers:
        return (f"whole: {n_params / 1e9:.3f}e9 parameters x {per_param} B = "
                f"{n_params * gb:.1f} GB of f32 weights, gradients and AdamW moments")
    return (f"{cfg.n_layers} of {full.n_layers} layers at full width: "
            f"{n_params / 1e9:.3f}e9 parameters x {per_param} B = {n_params * gb:.1f} "
            f"GB of f32 weights, gradients and AdamW moments; all "
            f"{full.n_layers} would be {full_params / 1e9:.2f}e9 x {per_param} B = "
            f"{full_params * gb:.1f} GB, more than one card")


def phase_train_family(state: dict, which: str, profile: bool = False) -> None:
    """One non-dense family trained at full width as the train phase trains
    gemma2-2b (TRAIN_FAMILIES): its steps, a bitwise repeat of the first
    four, a bitwise resume at its smoke config; the MoE's aux losses and
    dropped slots, the SSD scan's largest decay sum above the diagonal.
    ``profile``: one more step under torch.profiler before the repeat."""
    import dataclasses
    import gc

    from repro_torch import kernels
    from repro_torch.configs import ARCHS, SHAPES, ParallelConfig
    from repro_torch.launch.train import (
        STATE_BYTES_PER_PARAM,
        batch_fn,
        check_fits,
        init_state,
        param_count,
    )
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.utils.tree import tree_bytes, tree_size

    _free_models(state)
    spec = TRAIN_FAMILIES[which]
    full = ARCHS[spec["arch"]]
    cfg = dataclasses.replace(full, n_layers=spec["layers"]) if spec["layers"] else full
    check_fits(cfg, torch.device(DEV))
    b, s, n_rep = spec["batch"], TRAIN_FAMILY["seq"], TRAIN["repeat_steps"]
    t_phase = time.perf_counter()
    bundle, model, opt = init_state(cfg, device=DEV, seed=TRAIN["seed"])
    step = _synced(make_train_step(
        bundle, OptConfig(peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup"],
                          decay_steps=TRAIN["decay"]), ParallelConfig(remat="block")))
    bfs = batch_fn(cfg, SHAPES["train_4k"], b, s, torch.device(DEV))
    sync()
    init_s = time.perf_counter() - t_phase
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers)) if cfg.n_experts else 0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _moe_drops() as drops, _segsum_diffs() as diffs:
        run = _steps_timed(step, model, opt, bfs, n_rep, TRAIN_FAMILY["steps"])
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    state[f"{which}_counts"] = counts
    state[f"{which}_routes"] = kernels.route_counts()
    del model, opt
    if profile:
        _profiled(f"{which}_step", lambda: step(run["model"], run["opt"],
                                                 bfs(TRAIN_FAMILY["steps"])))
    n_params = tree_size(run["model"])
    state_bytes = tree_bytes({"p": run["model"], "o": run["opt"]})
    mets = run["mets"]
    losses = [float(m["loss"]) for m in mets]
    gnorms = [float(m["grad_norm"]) for m in mets]
    n_steps = len(mets)
    extra: dict = {}
    if n_moe:
        # remat recomputes each forward in the backward: the same slots
        # drop again, so a forward's drops are the share of its calls
        per_fwd = n_moe * n_steps / max(len(drops), 1)
        dropped = float(sum(int(d) for d in drops)) * per_fwd / n_steps
        slots = b * s * cfg.n_experts_per_tok * n_moe
        extra.update(aux_losses=[float(m["aux_loss"]) for m in mets],
                     moe_layers=n_moe, top_k=cfg.n_experts_per_tok,
                     n_experts=cfg.n_experts, slots_dropped_per_step=dropped,
                     dropped_share=dropped / slots)
    if diffs:
        d = torch.stack(diffs).float().cpu()
        extra.update(max_segsum_diff=float(d.amax()),
                     segsum_calls=len(diffs),
                     segsum_calls_past_exp_range=int((d > EXP_F32_MAX_ARG).sum()))
    prefix = 256 if cfg.frontend == "vision" else 0
    extra["positions_per_step"] = b * (s + prefix) + (b * s if cfg.n_enc_layers else 0)
    if cfg.frontend:  # its batches carry draws of jax.random.normal
        extra["draws_card_vs_host_bitwise"] = _draws_on_card(cfg, bfs)

    t0 = time.perf_counter()
    model, opt, loss_repeat, param_repeat = _repeat_from_seed(
        run, step, bfs, TRAIN["seed"], n_rep)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    repeat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resume, resume_arch = _resume_at_smoke(spec["arch"])
    resume_s = time.perf_counter() - t0

    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    cut = _train_cut(full, cfg, n_params, param_count(full), STATE_BYTES_PER_PARAM)
    emit(which, arch=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
         cut=cut, params=n_params, state_bytes=state_bytes, batch=b, seq=s,
         batch_cut=spec["batch"] != TRAIN_FAMILY["batch"], steps=n_steps,
         remat="block", init_s=round(init_s, 3), train_s=round(run["train_s"], 3),
         loss_first4=losses[:4], loss_last4=losses[-4:], loss_ratio=last / first,
         grad_norms=gnorms,
         **_step_fields(run["times"], b * s, run["adamw_ms"]),
         max_memory_allocated=peak,
         card_bytes=torch.cuda.get_device_properties(0).total_memory,
         launches={k: v for k, v in counts.items() if v},
         bitwise_repeat=bool(loss_repeat and param_repeat),
         resume_bitwise=bool(resume), resume_arch=resume_arch,
         snapshot_s=round(run["snapshot_s"], 3), repeat_s=round(repeat_s, 3),
         resume_s=round(resume_s, 3), phase_s=round(time.perf_counter() - t_phase, 3),
         **extra)
    _train_checks(which, losses, gnorms, loss_repeat, param_repeat, resume, counts)
    for name, same in extra.get("draws_card_vs_host_bitwise", {}).items():
        check(same, f"{which}: the card's {name} draws differ from the host's")
    if n_moe:
        check(len(drops) % (n_moe * n_steps) == 0,
              f"{which}: {len(drops)} MoE dispatches for {n_moe} layers x {n_steps} "
              f"steps")
    del run
    gc.collect()
    torch.cuda.empty_cache()


def _rank_sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def _fingerprint(t: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """An int64 fingerprint of a tensor's bits, taken in chunks (ranks
    compare their copies of the gathered weights by it; equal tensors give
    equal prints)."""
    bits = t.detach().reshape(-1).view(torch.int32)
    acc = torch.zeros(2, dtype=torch.int64, device=bits.device)
    for a in range(0, bits.numel(), chunk):
        b = bits[a:a + chunk].to(torch.int64)
        w = torch.arange(a + 1, a + 1 + b.numel(), device=b.device,
                         dtype=torch.int64) % 65521
        acc += torch.stack([b.sum(), (b * w).sum()])
    return acc


def _one_device_run(cfg, job: dict, dev, schedule) -> tuple:
    """The one-device trainer from the seeded state along ``schedule``
    ((steps, microbatches), ...): (losses, grad norms, model, opt)."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.launch.train import batch_fn, init_state
    from repro_torch.train import OptConfig, make_train_step

    bundle, model, opt = init_state(cfg, device=dev, seed=job["seed"])
    opt_cfg = OptConfig(**job["opt"])
    bfs = batch_fn(cfg, SHAPES["train_4k"], job["batch"], job["seq"], dev)
    losses, gnorms, s = [], [], 0
    for n, mb in schedule:
        step = make_train_step(bundle, opt_cfg, ParallelConfig(remat=job["remat"],
                                                               microbatches=mb))
        for _ in range(n):
            model, opt, m = step(model, opt, bfs(s))
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            s += 1
    for p in model.parameters():
        p.grad = None
    return losses, gnorms, model, opt


def _step0_grads(model, bundle, cfg, job: dict, axis, bfs) -> dict:
    """This rank's gradients of both layers' matrices on its rows of the
    step-0 batch at the seeded weights (the compressed all-reduce's input)."""
    from repro_torch.train.train_step import _local_rows, make_loss_fn

    leaves = [n for n, p in model.named_parameters()
              if n.startswith("layers.") and p.dim() == 2]
    for p in model.parameters():
        p.grad = None
    loss, _ = make_loss_fn(bundle, "ref", job["remat"])(
        model, _local_rows(bfs(0), cfg, axis)[0])
    loss.backward()
    named = dict(model.named_parameters())
    g0 = {n: named[n].grad.detach().clone() for n in leaves}
    for p in model.parameters():
        p.grad = None
    return g0


def _compress_checks(g0: dict, job: dict, axis, mesh, on_card: bool) -> dict:
    """The int8 error-feedback all-reduce over the ranks on ``g0`` (the
    reference's criteria against the rank-order mean), 16 rounds on one
    leaf, and the same call on host tensors."""
    from repro_torch.train.compression import (compressed_psum,
                                               psum_with_error_feedback,
                                               tree_compressed_psum)
    from repro_torch.train.train_step import _reduce_grads

    leaves = list(g0)
    _rank_sync(on_card)
    t0 = time.perf_counter()
    exact = {n: g.clone() for n, g in g0.items()}
    _reduce_grads(list(exact.values()), axis, axis.size)  # the mean, rank order
    means, new_errs = tree_compressed_psum(
        g0, {n: torch.zeros_like(g) for n, g in g0.items()}, "data", mesh=mesh)
    rel = {n: float((means[n] - exact[n]).abs().max() / exact[n].abs().max())
           for n in leaves}
    _rank_sync(on_card)
    tree_s = time.perf_counter() - t0
    x = g0[job["rounds_leaf"]]
    want = exact[job["rounds_leaf"]]
    one_err = float((compressed_psum(x, "data", mesh=mesh) - want).abs().max())
    err, tot = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(job["rounds"]):
        o, err = psum_with_error_feedback(x, err, "data", mesh=mesh)
        tot += o
    avg_err = float((tot / job["rounds"] - want).abs().max())
    _rank_sync(on_card)
    rounds_s = time.perf_counter() - t0 - tree_s
    t1 = time.perf_counter()
    host = {n: g.cpu() for n, g in g0.items()}
    means_h, errs_h = tree_compressed_psum(
        host, {n: torch.zeros_like(g) for n, g in host.items()}, "data", mesh=mesh)
    host_equal = all(torch.equal(means_h[n], means[n].cpu())
                     and torch.equal(errs_h[n], new_errs[n].cpu()) for n in leaves)
    return dict(leaves=len(leaves), elements=sum(g.numel() for g in g0.values()),
                max_rel_err=max(rel.values()), rel_err=rel, one_shot_err=one_err,
                avg_err_16=avg_err, tree_s=tree_s, rounds_s=rounds_s,
                host_s=time.perf_counter() - t1, host_equal=host_equal)


def _moved_bytes() -> list:
    """[bytes staged through the host, bytes through the mailboxes] that
    this rank's copies have moved since the counts were reset."""
    from repro_torch.core import _collectives

    return [sum(v["bytes"] for v in c().values())
            for c in (_collectives.staging_counts, _collectives.ipc_counts)]


def train_mesh_rank(rank: int, jobs: list) -> list:
    """One rank of the train_mesh phase (started by spawn_ranks): each job
    in turn on the spawn's first ``job["ranks"]`` ranks over
    ``job["backend"]`` (a group of its own where those are not all the
    ranks), the others waiting; this rank's result of each job, None where
    it took no part."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import make_data_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores (the host-side checks, gloo's reductions)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    outs = []
    for job in jobs:
        n, kind = job["ranks"], torch.device(job["device"]).type
        if n == dist.get_world_size() and job["backend"] == dist.get_backend():
            mesh = make_data_mesh(backend=job["backend"], device_type=kind)
        else:
            group = dist.new_group(list(range(n)), backend=job["backend"])
            mesh = (DeviceMesh.from_group(group, kind, mesh_dim_names=("data",))
                    if rank < n else None)
        outs.append(None if mesh is None else _train_mesh_job(rank, job, mesh))
        if kind == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return outs


def _train_mesh_job(rank: int, job: dict, mesh) -> dict:
    """One job of :func:`train_mesh_rank` on ``mesh``: the data-parallel
    trainer on this rank's rows of the train phase's batches, timed per
    step; optionally a checkpoint after ``save_at`` or a restore of step
    ``restore``, the compressed all-reduce, and on rank 0 the one-device
    run of ``schedule`` held against the mesh's losses, grad norms, weights
    and moments."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.core import _collectives
    from repro_torch.launch.mesh import data_axis
    from repro_torch.launch.train import batch_fn, init_state
    from repro_torch.train import (CheckpointManager, OptConfig, make_train_step,
                                   mesh_opt_specs)
    from repro_torch.train.fault_tolerance import run_training
    from repro_torch.train.optimizer import gather_whole

    started_s = time.time() - job["spawned_at"]
    t_in = time.perf_counter()
    dev = torch.device(job["device"])
    on_card = dev.type == "cuda"
    cfg = job["cfg"]
    axis = data_axis(mesh)
    bundle, model, opt = init_state(cfg, device=dev, seed=job["seed"], mesh=mesh)
    specs = mesh_opt_specs(model, mesh)
    step = make_train_step(bundle, OptConfig(**job["opt"]),
                           ParallelConfig(remat=job["remat"]), mesh=mesh)
    bfs = batch_fn(cfg, SHAPES["train_4k"], job["batch"], job["seq"], dev)
    ckpt = CheckpointManager(job["ckpt_dir"]) if job["ckpt_dir"] else None
    out = {"rank": rank, "size": axis.size, "start_s": started_s}
    start = 0
    if job["restore"]:
        t0 = time.perf_counter()
        start = job["restore"]
        state = ckpt.restore(start, {"params": model, "opt": opt}, mesh=mesh,
                             specs={"opt": specs})
        model, opt = state["params"], state["opt"]
        _rank_sync(on_card)
        out["restore_s"] = time.perf_counter() - t0
    g0 = _step0_grads(model, bundle, cfg, job, axis, bfs) if job["compress"] else None
    out["setup_s"] = time.perf_counter() - t_in
    axis.barrier()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _collectives.reset_staging_counts()

    def synced(*args):
        r = step(*args)
        _rank_sync(on_card)
        return r

    mets, times = [], []
    t0 = time.perf_counter()
    save_at = job["save_at"]
    out["save_s"], out["save_bytes"] = 0.0, [0, 0]
    for lo, hi in ((start, save_at), (max(start, save_at), job["steps"])):
        if hi <= lo:
            continue
        model, opt, st = run_training(
            train_step=synced, init_state=(model, opt), batch_for_step=bfs,
            n_steps=hi, start_step=lo, on_metrics=lambda s, m: mets.append(m),
            mesh=mesh, opt_specs=specs)
        times += st.times
        if hi == save_at:
            # gathered now; rank 0 writes it while the rank goes on (waited
            # for before the state is freed)
            t1, moved = time.perf_counter(), _moved_bytes()
            ckpt.save(save_at, {"params": model, "opt": opt}, async_=True, mesh=mesh,
                      specs={"opt": specs})
            out["save_s"] = time.perf_counter() - t1
            out["save_bytes"] = [b - a for a, b in zip(moved, _moved_bytes(), strict=True)]
    out["train_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else None
    out["staged"] = _collectives.staging_counts()
    out["ipc"] = _collectives.ipc_counts()
    out["step_s"] = times
    losses = [m["loss"] for m in mets]
    gnorms = [m["grad_norm"] for m in mets]
    out["losses"] = [float(v) for v in losses]
    out["grad_norms"] = [float(v) for v in gnorms]
    prints = torch.stack([_fingerprint(p) for p in model.parameters()])
    all_prints = axis.gather_rows(prints[None]).cpu()
    out["weights_same_on_every_rank"] = bool((all_prints == all_prints[0]).all())
    t0 = time.perf_counter()
    moments = {"m": {}, "v": {}}  # whole, on rank 0's card
    for key, whole in moments.items():
        for n, t in opt[key].items():
            w = gather_whole(t, specs[key][n], axis)
            if rank == 0:
                whole[n] = w
    _rank_sync(on_card)
    out["gather_s"] = time.perf_counter() - t0
    if job["compress"]:
        out["compress"] = _compress_checks(g0, job, axis, mesh, on_card)
        del g0
    t0 = time.perf_counter()
    if ckpt is not None:
        ckpt.wait()
    out["write_wait_s"] = time.perf_counter() - t0
    # the ranks' state goes before rank 0's one-device run takes the card
    for p in model.parameters():
        p.grad = None
    del opt
    if rank != 0:
        del model
    if on_card:
        torch.cuda.empty_cache()
    axis.barrier()
    if rank == 0 and job["schedule"]:
        t0 = time.perf_counter()
        r_loss, r_gn, r_model, r_opt = _one_device_run(cfg, job, dev, job["schedule"])
        out["reference_s"] = time.perf_counter() - t0
        r_loss, r_gn = r_loss[start:], r_gn[start:]
        out["losses_equal"] = all(torch.equal(a, b) for a, b in zip(losses, r_loss,
                                                                    strict=True))
        out["grad_norms_equal"] = all(torch.equal(a, b) for a, b in zip(gnorms, r_gn,
                                                                        strict=True))
        named = dict(r_model.named_parameters())
        out["weights_differ"] = [n for n, p in model.named_parameters()
                                 if not torch.equal(p, named[n])]
        out["moments_differ"] = [f"{key} {n}" for key in ("m", "v")
                                 for n, t in moments[key].items()
                                 if not torch.equal(t, r_opt[key][n])]
        out["reference_losses"] = [float(v) for v in r_loss]
    out["job_s"] = time.perf_counter() - t_in
    return out


def phase_train_mesh(state: dict) -> None:
    """The trainer over data ranks on the card (TRAIN_MESH): gemma2-2b at
    full width cut to 2 layers, the train phase's batch and schedule, in
    one spawn of four gloo ranks. All four (TRAIN_MESH's steps, a
    checkpoint after ``save_at``) against the one-device step at
    microbatches 4; the first two restore that checkpoint and take the
    rest against the one-device schedule of ``save_at`` steps at 4
    microbatches and the rest at 2; rank 0 alone over NCCL against
    microbatches 1; the int8 error-feedback all-reduce on the four ranks'
    step-0 gradients. Every comparison bitwise."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import check_fits, param_count, state_bytes_per_rank

    t_start = time.perf_counter()
    _free_models(state)
    cfg = dataclasses.replace(ARCHS[TRAIN_MESH["arch"]], n_layers=TRAIN_MESH["layers"])
    p, p2 = TRAIN_MESH["ranks"], TRAIN_MESH["elastic_ranks"]
    n_params = param_count(cfg)
    check_fits(cfg, torch.device(DEV), data_ranks=p, ranks_per_card=p)
    reckoning = {f"P={k}": state_bytes_per_rank(n_params, k) for k in (p, p2, 1)}
    steps, save_at = TRAIN_MESH["steps"], TRAIN_MESH["save_at"]
    base = dict(cfg=cfg, device=DEV, seed=TRAIN["seed"], batch=TRAIN_MESH["batch"],
                seq=TRAIN_MESH["seq"], remat="block", steps=steps,
                opt=dict(peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup"],
                         decay_steps=TRAIN["decay"]),
                rounds=TRAIN_MESH["rounds"], rounds_leaf=TRAIN_MESH["rounds_leaf"])
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-mesh-") as tmp:
        ckpt_dir = f"{tmp}/ckpt"
        jobs = [dict(ranks=p, backend="gloo", save_at=save_at, restore=0, compress=True,
                     schedule=((steps, p),), ckpt_dir=ckpt_dir),
                dict(ranks=p2, backend="gloo", save_at=0, restore=save_at,
                     compress=False, schedule=((save_at, p), (steps - save_at, p2)),
                     ckpt_dir=ckpt_dir),
                dict(ranks=1, backend=TRAIN_MESH["one_rank_backend"], save_at=0,
                     restore=0, compress=False, schedule=((steps, 1),), ckpt_dir="")]
        t0 = time.perf_counter()
        at = time.time()
        outs = spawn_ranks(train_mesh_rank, p, backend="gloo", device=DEV,
                           init_dir=tmp, timeout=TRAIN_MESH["timeout"],
                           args=([dict(base, spawned_at=at, **j) for j in jobs],))
        spawn_s = time.perf_counter() - t0
    runs = {name: [o[i] for o in outs[:jobs[i]["ranks"]]]
            for i, name in enumerate(("gloo", "elastic", "nccl"))}

    def per_rank(outs, n_steps):
        rows = []
        for o in outs:
            ms = [t * 1e3 for t in o["step_s"]]
            staged = {op: v["bytes"] for op, v in o["staged"].items()}
            ipc = {op: v["bytes"] for op, v in o["ipc"].items()}
            # the steps' bytes: the checkpoint's gathers are counted apart
            step_bytes = sum(staged.values()) - o["save_bytes"][0]
            ipc_bytes = sum(ipc.values()) - o["save_bytes"][1]
            rows.append(dict(rank=o["rank"], start_s=round(o["start_s"], 3),
                             setup_s=round(o["setup_s"], 3),
                             train_s=round(o["train_s"], 3),
                             save_s=round(o["save_s"], 3),
                             write_wait_s=round(o["write_wait_s"], 3),
                             gather_s=round(o["gather_s"], 3),
                             step_ms_first=ms[0],
                             step_ms_p50_rest=float(np.median(ms[1:])) if len(ms) > 1 else None,
                             staged_bytes_per_step=step_bytes / n_steps,
                             staged_by_op=staged,
                             ipc_bytes_per_step=ipc_bytes / n_steps, ipc_by_op=ipc,
                             save_bytes_staged_ipc=o["save_bytes"],
                             peak_bytes=o["peak_bytes"],
                             restore_s=o.get("restore_s")))
        return rows

    def bitwise(outs):
        o = outs[0]
        return dict(losses=o["losses_equal"], grad_norms=o["grad_norms_equal"],
                    weights=not o["weights_differ"], moments=not o["moments_differ"],
                    ranks_agree=all(x["weights_same_on_every_rank"]
                                    and x["losses"] == o["losses"] for x in outs))

    gloo, el, one = runs["gloo"], runs["elastic"], runs["nccl"]
    comp = [o["compress"] for o in gloo]
    c = comp[0]
    peak = max(o["peak_bytes"] or 0 for o in gloo)
    emit("train_mesh", arch=cfg.name, layers=cfg.n_layers, params=n_params,
         batch=TRAIN_MESH["batch"], seq=TRAIN_MESH["seq"], remat="block",
         ranks=p, backend="gloo", steps=steps, save_at=save_at,
         state_bytes_per_rank_reckoned=reckoning, peak_bytes_max=peak,
         losses=gloo[0]["losses"], grad_norms=gloo[0]["grad_norms"],
         one_device_microbatches=p, bitwise=bitwise(gloo), per_rank=per_rank(gloo, steps),
         spawn_seconds=round(spawn_s, 3), job_seconds=round(gloo[0]["job_s"], 3),
         reference_s=round(gloo[0]["reference_s"], 3),
         elastic=dict(ranks=p2, restored_step=save_at, steps=steps - save_at,
                      losses=el[0]["losses"], one_device_schedule=[
                          [save_at, p], [steps - save_at, p2]], bitwise=bitwise(el),
                      per_rank=per_rank(el, steps - save_at),
                      job_seconds=round(el[0]["job_s"], 3)))
    emit("train_mesh_nccl", ranks=1, backend=TRAIN_MESH["one_rank_backend"],
         steps=steps, losses=one[0]["losses"], one_device_microbatches=1,
         bitwise=bitwise(one),
         per_rank=per_rank(one, steps), job_seconds=round(one[0]["job_s"], 3))
    emit("train_mesh_compress", ranks=p, leaves=c["leaves"], elements=c["elements"],
         max_rel_err=max(x["max_rel_err"] for x in comp),
         rel_err_rank0=c["rel_err"], rounds=TRAIN_MESH["rounds"],
         rounds_leaf=TRAIN_MESH["rounds_leaf"],
         one_shot_err=[x["one_shot_err"] for x in comp],
         avg_err_16=[x["avg_err_16"] for x in comp],
         host_equal=all(x["host_equal"] for x in comp),
         tree_s=[round(x["tree_s"], 3) for x in comp],
         rounds_s=[round(x["rounds_s"], 3) for x in comp],
         host_s=[round(x["host_s"], 3) for x in comp])
    seconds = round(time.perf_counter() - t_start, 3)
    emit("train_mesh_phase", seconds=seconds, limit_s=TRAIN_MESH["limit_s"])
    check(DEV != "cuda" or seconds <= TRAIN_MESH["limit_s"],
          f"train_mesh: the phase took {seconds} s, past its {TRAIN_MESH['limit_s']} s")
    for name, outs in runs.items():
        o = outs[0]
        check(all(x["weights_same_on_every_rank"] for x in outs),
              f"train_mesh ({name}): the ranks' gathered weights differ")
        check(all(x["losses"] == o["losses"] for x in outs),
              f"train_mesh ({name}): the ranks' losses differ")
        check(o["losses_equal"] and o["grad_norms_equal"],
              f"train_mesh ({name}): losses or grad norms differ from the one-device "
              f"run: {o['losses']} vs {o['reference_losses']}")
        check(not o["weights_differ"],
              f"train_mesh ({name}): weights differ from the one-device run: "
              f"{o['weights_differ'][:5]}")
        check(not o["moments_differ"],
              f"train_mesh ({name}): moments differ from the one-device run: "
              f"{o['moments_differ'][:5]}")
        check(all(np.isfinite(o["losses"])) and all(np.isfinite(o["grad_norms"])),
              f"train_mesh ({name}): a non-finite loss or grad norm")
    check(all(x["max_rel_err"] < MAX_COMPRESS_REL_ERR for x in comp),
          f"train_mesh_compress: a leaf's error {max(x['max_rel_err'] for x in comp)} "
          f">= {MAX_COMPRESS_REL_ERR} of its largest mean")
    check(all(x["avg_err_16"] < MAX_FEEDBACK_RATIO * x["one_shot_err"] for x in comp),
          f"train_mesh_compress: 16 rounds of error feedback averaged "
          f"{c['avg_err_16']}, not below {MAX_FEEDBACK_RATIO} x the one-shot "
          f"{c['one_shot_err']}")
    check(all(x["host_equal"] for x in comp),
          "train_mesh_compress: the card's outputs differ from the same call on host "
          "tensors")
    check(DEV != "cuda" or all(reckoning[f"P={p}"] <= o["peak_bytes"] for o in gloo),
          f"train_mesh: a rank's peak {peak} B is below the {reckoning[f'P={p}']} B "
          f"of state check_fits reckons: the reckoning is wrong")


def _bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7)) if x else 0.0


def _tp_train(job: dict, mesh, dev) -> dict:
    """The tensor-parallel trainer twice from the seeded state (MESH_TP's
    steps), the first run held against the one-device step's step-0
    gradients and final weights (``job["ref"]``, shared by the parent)."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import _collectives
    from repro_torch.launch.mesh import make_plan
    from repro_torch.launch.train import batch_fn, init_state
    from repro_torch.models.tensor_parallel import model_dim
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import local_shard

    cfg, on_card = job["cfg"], dev.type == "cuda"
    ref = job["ref"]
    plan = make_plan(cfg, ShapeConfig("mesh_tp", job["seq"], job["batch"], "train"), mesh)
    bfs = batch_fn(cfg, SHAPES["train_4k"], job["batch"], job["seq"], dev)
    runs = []
    for attempt in range(2):
        t0 = time.perf_counter()
        before = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        # every rank draws its slices at once, one whole leaf at a time
        bundle, model, opt = init_state(cfg, device=dev, seed=job["seed"], mesh=mesh)
        init_peak = torch.cuda.max_memory_allocated() - before if on_card else None
        tp = model.tp
        coords = {"model": (tp.index, tp.size)}  # slices of the one-device leaves
        step = make_train_step(bundle, OptConfig(**job["opt"]),
                               ParallelConfig(remat="block"), mesh=mesh, plan=plan)
        _rank_sync(on_card)
        run = {"init_s": time.perf_counter() - t0, "init_peak_bytes": init_peak}
        tp.axis.barrier()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _collectives.reset_staging_counts()
        losses, gnorms, times = [], [], []
        for s in range(job["steps"]):
            dry = attempt == 1 and s == job["steps"] - 1  # the dryrun phase's step
            if dry:
                _collectives.reset_op_counts()
                beside = _beside_inputs(model, opt) if on_card else None
            t0 = time.perf_counter()
            model, opt, m = step(model, opt, bfs(s))
            _rank_sync(on_card)
            times.append(time.perf_counter() - t0)
            if dry:
                run["dry_step"] = dict(
                    ops=_collectives.op_counts(), ms=times[-1] * 1e3, beside_bytes=beside,
                    peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            if s == 0 and attempt == 0:
                worst = 0.0
                for n, p in model.named_parameters():
                    want = ref["grads0"][n]
                    err = float((p.grad - local_shard(want, tp.specs[n], coords))
                                .abs().max())
                    bound = GRAD_ULPS * _bf16_ulp(float(want.abs().max()))
                    worst = max(worst, err / bound if bound else (0.0 if err == 0 else
                                                                  float("inf")))
                run["grad_ratio_max"] = worst
        run.update(step_s=times, losses=[float(v) for v in losses],
                   grad_norms=[float(v) for v in gnorms], moved=_moved_bytes(),
                   staged=_collectives.staging_counts(), ipc=_collectives.ipc_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
        named = dict(model.named_parameters())
        run["prints"] = torch.stack([_fingerprint(p) for p in named.values()]).cpu()
        if attempt == 0:
            dmax, dsum, count = {}, {}, {}
            for n, p in named.items():
                d = (p.detach() - local_shard(ref["params"][n], tp.specs[n], coords)).abs()
                dmax[n], dsum[n], count[n] = float(d.max()), float(d.sum()), d.numel()
            run.update(dmax=dmax, dsum=dsum, count=count)
            rep = [n for n in named if model_dim(tp.specs[n]) is None]
            mine = torch.stack([_fingerprint(named[n]) for n in rep])
            every = tp.axis.gather_rows(mine[None]).cpu()
            run["replicated_equal"] = bool((every == every[0]).all())
            run["replicated_leaves"] = len(rep)
        runs.append(run)
        del model, opt, step, named
        if on_card:
            torch.cuda.empty_cache()
    a, b = runs
    return dict(runs[0], repeat_bitwise=(a["losses"] == b["losses"]
                                         and a["grad_norms"] == b["grad_norms"]
                                         and torch.equal(a["prints"], b["prints"])),
                repeat_init_s=b["init_s"], repeat_step_s=b["step_s"],
                repeat_init_peak_bytes=b["init_peak_bytes"], dry_step=b["dry_step"],
                prints=None)


def _tp_serve(job: dict, mesh, dev) -> dict:
    """The lm phase's traffic through ServeEngine on the mesh (launches
    counted), then the forced route twice, the first with every K5 call
    held against its plain version at the ranks' shapes; the raw and the
    compressed caches of the first gathered whole (every row, every kv
    head) on rank 0."""
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import data_axis, make_plan
    from repro_torch.models import build
    from repro_torch.models.tensor_parallel import cache_kv_heads, gather_dim
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, S = job["cfg"], job["sizes"]
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=dev).manual_seed(0), device=dev,
                        mesh=mesh)
    tp = model.tp
    plan = make_plan(cfg, ShapeConfig("mesh_tp", S["prompt"], S["serve_batch"],
                                      "decode"), mesh)
    engine = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=S["new_tokens"], compress=True, compress_t=S["t"],
        compress_m=S["m"], compress_tail=S["tail"], impl="auto"), plan=plan, mesh=mesh)
    rows = data_axis(mesh)
    _rank_sync(on_card)
    out = {"init_s": time.perf_counter() - t0}
    rows.barrier()
    kernels.reset_launch_counts()
    gen = engine.generate({"tokens": job["prompts"]})
    _rank_sync(on_card)
    out.update(counts=kernels.launch_counts(), routes=kernels.route_counts(),
               tokens=gen["tokens"].cpu().numpy(), timings=gen["timings"],
               n_steps=gen["n_steps"], compressions=gen["compressions"])
    # the launches this rank's generate makes: K5 at each global layer's
    # prefill and at every layer of every decode step, K2 once a (row, kv
    # head) a layer a compression
    n_global = sum(cfg.attn_type(l) == "global" for l in range(cfg.n_layers))
    heads = cache_kv_heads(cfg, tp.size)
    out["want"] = {"K5": n_global + cfg.n_layers * S["new_tokens"],
                   "K5-decode": cfg.n_layers * S["new_tokens"],
                   "K2": cfg.n_layers * (S["serve_batch"] // rows.size) * heads
                   * len(gen["timings"]["compress"])}
    per = S["serve_batch"] // rows.size
    lo = rows.index * per
    tok = torch.from_numpy(job["prompts"][lo:lo + per]).to(dev)
    steps = torch.from_numpy(job["forced"][lo:lo + per]).to(dev)
    route = dict(impl="auto", compress_impl="auto", cache_kw=dict(tp_size=tp.size),
                 plan=plan, whole=lambda x: rows.gather_rows(gather_dim(x, tp.axis, 1)),
                 traffic=dict(LM, t=S["t"], m=S["m"], tail=S["tail"],
                              new_tokens=S["new_tokens"]))
    held = []
    t0 = time.perf_counter()
    first, raw, comp = _forced_route(bundle, model, tok, steps, held=held, **route)
    again = _forced_route(bundle, model, tok, steps, **route)[0]
    _rank_sync(on_card)
    out["forced_s"] = time.perf_counter() - t0
    out["repeat_bitwise"] = all(torch.equal(a, b) for a, b in zip(first, again,
                                                                  strict=True))
    out["diffs"] = [_logit_diff(a, b) for a, b in zip(first, job["ref"]["logits"],
                                                      strict=True)]
    out["held"] = _held_summary(held)
    out["held_want"] = [n_global, cfg.n_layers * steps.shape[1]]
    local_heads = heads < cfg.n_kv_heads

    def whole(c):  # every row and kv head
        got = {}
        for k in ("k", "v", "mass"):
            if k in c:
                t = gather_dim(c[k], tp.axis, 1) if local_heads else c[k]
                got[k] = rows.gather_rows(t.contiguous())
        return dict(got, pos=c["pos"])

    def host(c):  # numpy for the parent (bf16 widened to f32: exact)
        return {k: v if k == "pos" else v.float().cpu().numpy() for k, v in c.items()}

    raw_all = [whole(c) for c in raw["layers"]]
    comp_all = [whole(c) for c in comp["layers"]]
    out.update(rows=(lo, lo + per), heads=((tp.index * heads, (tp.index + 1) * heads)
                                           if local_heads else None))
    if rows.index == 0 and tp.index == 0:
        out.update(raw=dict(raw, layers=[host(c) for c in raw_all]),
                   comp={"layers": [host(c) for c in comp_all]})
    del raw_all, comp_all
    del model, engine
    if on_card:
        torch.cuda.empty_cache()
    return out


def mesh_tp_rank(rank: int, job: dict) -> dict:
    """One rank of the mesh_tp phase (started by spawn_ranks): the debug
    mesh, the tensor-parallel trainer, then the server."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))
    dev = torch.device(job["device"])
    started_s = time.time() - job["spawned_at"]
    t0 = time.perf_counter()
    mesh = make_debug_mesh(job["data"], job["model"], device_type=dev.type)
    train = _tp_train(job, mesh, dev)
    train_s = time.perf_counter() - t0
    serve = _tp_serve(job, mesh, dev)
    return {"rank": rank, "coords": {a: int(mesh.get_local_rank(a))
                                     for a in ("data", "model")},
            "start_s": started_s, "train_s": train_s,
            "serve_s": time.perf_counter() - t0 - train_s, "train": train,
            "serve": serve}


def _tp_reference(cfg, dev, prompts) -> tuple:
    """The one-device oracles of the mesh_tp phase, in this process: the
    trainer at ``data`` microbatches (losses, grad norms, step-0 gradients,
    final weights) and the kernel path's generate and forced route."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.launch.train import batch_fn, init_state
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import OptConfig, make_train_step

    S = MESH_TP
    t0 = time.perf_counter()
    bundle, model, opt = init_state(cfg, device=dev, seed=TRAIN["seed"])
    step = make_train_step(bundle, OptConfig(**_mesh_tp_opt()),
                           ParallelConfig(remat="block", microbatches=S["data"]))
    bfs = batch_fn(cfg, SHAPES["train_4k"], S["batch"], S["seq"], dev)
    losses, gnorms, lrs, grads0 = [], [], [], None
    sync_ = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync_()
    init_s = time.perf_counter() - t0
    for s in range(S["steps"]):
        model, opt, m = step(model, opt, bfs(s))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if s == 0:
            grads0 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    steps_s = time.perf_counter() - t0 - init_s
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync_()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb = build(cfg)
    smodel = sb.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(sb, smodel, ServeConfig(
        max_new_tokens=S["new_tokens"], compress=True, compress_t=S["t"],
        compress_m=S["m"], compress_tail=S["tail"], impl="auto"))
    gen = engine.generate({"tokens": prompts})
    tok = torch.from_numpy(prompts).to(dev)
    forced = gen["tokens"][:, :S["forced_steps"]].to(dev, torch.int64)
    logits = _forced_route(sb, smodel, tok, forced, impl="auto", compress_impl="auto",
                           traffic=dict(LM, t=S["t"], m=S["m"], tail=S["tail"],
                                        new_tokens=S["new_tokens"]))[0]
    del smodel, engine
    sync_()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return (dict(losses=losses, grad_norms=gnorms, lrs=lrs, grads0=grads0,
                 params=params, logits=logits, tokens=gen["tokens"].cpu().numpy(),
                 timings=gen["timings"], forced=forced.cpu().numpy(),
                 init_s=init_s, steps_s=steps_s),
            train_s, time.perf_counter() - t0)


def _mesh_tp_opt() -> dict:
    return dict(peak_lr=TRAIN["peak_lr"], warmup_steps=TRAIN["warmup"],
                decay_steps=TRAIN["decay"])


def _on_card(caches: dict) -> dict:
    """Host caches (numpy, bf16 keys and values widened to f32) back on the
    card as the model keeps them."""
    def one(c):
        return {k: (v if k == "pos" else torch.from_numpy(v).to(
            DEV, torch.float32 if k == "mass" else torch.bfloat16)) for k, v in c.items()}
    return dict(caches, layers=[one(c) for c in caches["layers"]])


def _sliced(caches: dict, rows, heads) -> dict:
    """The (rows, kv heads) block of every layer's cache (``heads`` None:
    all of them)."""
    sl = (slice(*rows), slice(*heads) if heads else slice(None))
    return {"layers": [{k: (v[sl] if torch.is_tensor(v) else v) for k, v in c.items()}
                       for c in caches["layers"]]}


def phase_mesh_tp(state: dict) -> None:
    """The model axis on the card (MESH_TP): the one-device oracles in this
    process, then one spawn of data x model gloo ranks (train_mesh's rank
    server) running the tensor-parallel trainer and server, held against
    them (see the module docstring)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import (init_bytes_per_rank, rank_param_count,
                                          state_bytes_per_rank)
    from repro_torch.serve.kv_compression import compress_model_caches

    t_start = time.perf_counter()
    _free_models(state)
    S = MESH_TP
    cfg = dataclasses.replace(ARCHS[S["arch"]], n_layers=S["layers"])
    n_ranks = S["data"] * S["model"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(S["serve_batch"], S["prompt"]))
    ref, ref_train_s, ref_serve_s = _tp_reference(cfg, torch.device(DEV), prompts)
    per_rank_params = rank_param_count(cfg, S["model"])
    reckoned = state_bytes_per_rank(per_rank_params, S["data"])
    init_reckoned = init_bytes_per_rank(cfg, per_rank_params, S["data"],
                                        model_ranks=S["model"])
    job = dict(cfg=cfg, device=DEV, seed=TRAIN["seed"], data=S["data"], model=S["model"],
               batch=S["batch"], seq=S["seq"], steps=S["steps"], opt=_mesh_tp_opt(),
               prompts=prompts, forced=ref["forced"], sizes=dict(S),
               ref={k: ref[k] for k in ("grads0", "params", "logits")})
    parent_bytes = ([torch.cuda.memory_allocated(), torch.cuda.memory_reserved()]
                    if DEV == "cuda" else None)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-tp-") as tmp:
        t0 = time.perf_counter()
        job["spawned_at"] = time.time()
        outs = spawn_ranks(mesh_tp_rank, n_ranks, backend="gloo", device=DEV,
                           init_dir=tmp, timeout=S["timeout"], args=(job,))
        spawn_s = time.perf_counter() - t0
    del job
    # the train checks
    trains = [o["train"] for o in outs]
    lr_sum = sum(ref["lrs"])
    loss_ok = all(abs(a - b) <= GRAD_ULPS * _bf16_ulp(b)
                  for t in trains for key in ("losses", "grad_norms")
                  for a, b in zip(t[key], ref[key], strict=True))
    grad_ratio = max(t["grad_ratio_max"] for t in trains)
    names = list(trains[0]["dmax"])
    dmax = {n: max(t["dmax"][n] for t in trains) for n in names}
    dmean = {}
    row0 = [o["train"] for o in outs if o["coords"]["data"] == 0]
    for n in names:  # every element once: a sharded leaf's slices on data row 0
        parts = row0 if trains[0]["count"][n] < ref["params"][n].numel() else row0[:1]
        dmean[n] = sum(t["dsum"][n] for t in parts) / sum(t["count"][n] for t in parts)
    weights_ok = all(dmax[n] <= 2 * lr_sum and dmean[n] <= 0.1 * lr_sum for n in names)
    # the serve checks
    serves = [o["serve"] for o in outs]
    diffs = serves[0]["diffs"]
    zero = next(sv for sv in serves if "raw" in sv)
    together = compress_model_caches(_on_card(zero["raw"]), S["t"], S["m"],
                                     tail=S["tail"], impl="auto")
    comp = _on_card(zero["comp"])
    slots = [_slot_agreement(_sliced(comp, sv["rows"], sv["heads"]),
                             _sliced(together, sv["rows"], sv["heads"])) for sv in serves]
    counts, routes = {}, {}
    for sv in serves:
        for k, v in sv["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in sv["routes"].items():
            routes[k] = routes.get(k, 0) + v
    state["mesh_tp_counts"], state["mesh_tp_routes"] = counts, routes
    state["mesh_tp_measured"] = dict(
        trains[0]["dry_step"], ranks_ops=[t["dry_step"]["ops"] for t in trains],
        p50_ms=float(np.median([x * 1e3 for x in trains[0]["step_s"][1:]])))
    tokens_equal = float((serves[0]["tokens"] == ref["tokens"]).mean())

    def rank_row(o):
        t, sv = o["train"], o["serve"]
        ms = [x * 1e3 for x in t["step_s"]]
        tm = sv["timings"]
        n_tok = sv["tokens"].shape[0] * sv["n_steps"] // S["data"]
        return dict(rank=o["rank"], coords=o["coords"], start_s=round(o["start_s"], 3),
                    train_s=round(o["train_s"], 3), serve_s=round(o["serve_s"], 3),
                    init_s=round(t["init_s"], 3), init_peak_bytes=t["init_peak_bytes"],
                    repeat_init_peak_bytes=t["repeat_init_peak_bytes"],
                    step_ms_first=ms[0], step_ms_p50_rest=float(np.median(ms[1:])),
                    repeat_step_ms=[x * 1e3 for x in t["repeat_step_s"]],
                    staged_bytes_per_step=t["moved"][0] / S["steps"],
                    ipc_bytes_per_step=t["moved"][1] / S["steps"],
                    staged_by_op=t["staged"], ipc_by_op=t["ipc"],
                    peak_bytes=t["peak_bytes"], launches=sv["counts"],
                    launches_want=sv["want"], launches_by_route=sv["routes"],
                    prefill_ms=tm["prefill_s"] * 1e3, decode_s=tm["decode_s"],
                    decode_tok_per_s=n_tok / tm["decode_s"],
                    compress_ms=[c["seconds"] * 1e3 for c in tm["compress"]],
                    forced_s=round(sv["forced_s"], 3))

    rows = [rank_row(o) for o in outs]
    peak = max((r["peak_bytes"] or 0) for r in rows)
    init_peak = max(max(r["init_peak_bytes"] or 0, r["repeat_init_peak_bytes"] or 0)
                    for r in rows)
    held = [sv["held"] for sv in serves]
    tm = ref["timings"]
    emit("mesh_tp", arch=cfg.name, layers=cfg.n_layers, mesh=[S["data"], S["model"]],
         backend="gloo", params_per_rank=per_rank_params,
         state_bytes_per_rank_reckoned=reckoned, peak_bytes_max=peak,
         init_bytes_per_rank_reckoned=init_reckoned, init_peak_bytes_max=init_peak,
         train=dict(batch=S["batch"], seq=S["seq"], remat="block", steps=S["steps"],
                    one_device_microbatches=S["data"], losses=trains[0]["losses"],
                    reference_losses=ref["losses"], grad_norms=trains[0]["grad_norms"],
                    reference_grad_norms=ref["grad_norms"], grad_ratio_max=grad_ratio,
                    weights_dmax_max=max(dmax.values()),
                    weights_dmean_max=max(dmean.values()), lr_sum=lr_sum,
                    repeat_bitwise=all(t["repeat_bitwise"] for t in trains),
                    replicated_leaves=trains[0]["replicated_leaves"],
                    replicated_equal=all(t["replicated_equal"] for t in trains)),
         serve=dict(batch=S["serve_batch"], prompt=S["prompt"],
                    new_tokens=S["new_tokens"], forced_steps=S["forced_steps"],
                    logit_ulps=LOGIT_ULPS, steps=[_rounded(d) for d in diffs],
                    slot_agreement=min(slots), tokens_equal_share=tokens_equal,
                    k5_held=held, k5_held_want=serves[0]["held_want"],
                    repeat_bitwise=all(sv["repeat_bitwise"] for sv in serves),
                    launches=counts, launches_by_route=routes,
                    one_device=dict(prefill_ms=tm["prefill_s"] * 1e3,
                                    decode_s=tm["decode_s"],
                                    decode_tok_per_s=S["serve_batch"] * S["new_tokens"]
                                    / tm["decode_s"],
                                    compress_ms=[c["seconds"] * 1e3
                                                 for c in tm["compress"]])),
         per_rank=rows, reference_train_s=round(ref_train_s, 3),
         reference_init_s=round(ref["init_s"], 3),
         reference_steps_s=round(ref["steps_s"], 3),
         reference_serve_s=round(ref_serve_s, 3), spawn_seconds=round(spawn_s, 3),
         parent_allocated_reserved_bytes=parent_bytes)
    del ref
    seconds = round(time.perf_counter() - t_start, 3)
    emit("mesh_tp_phase", seconds=seconds, limit_s=S["limit_s"])
    check(DEV != "cuda" or seconds <= S["limit_s"],
          f"mesh_tp: the phase took {seconds} s, past its {S['limit_s']} s")
    check(loss_ok, f"mesh_tp: losses or grad norms past {GRAD_ULPS} bf16 ulps of the "
          f"one-device step: {trains[0]['losses']} vs the reference's")
    check(grad_ratio <= 1.0, f"mesh_tp: a step-0 gradient past {GRAD_ULPS} bf16 ulps "
          f"of its leaf's largest |g| (ratio {grad_ratio})")
    check(weights_ok, f"mesh_tp: weights past 2·Σlr or a mean past 0.1·Σlr "
          f"({max(dmax.values())}, {max(dmean.values())}; Σlr {lr_sum})")
    check(all(t["repeat_bitwise"] for t in trains), "mesh_tp: the second run differs")
    check(all(t["replicated_equal"] for t in trains),
          "mesh_tp: a replicated leaf differs across the model ranks")
    check(all(o["train"]["losses"] == trains[0]["losses"] for o in outs),
          "mesh_tp: the ranks' losses differ")
    for i, e in enumerate(diffs):
        check(e["finite"], f"mesh_tp step {i}: non-finite logits")
        check(e["err"] <= e["bound"],
              f"mesh_tp step {i}: max |dlogit| {e['err']} > {e['bound']}")
        check(e["top1"] >= MIN_TOP1, f"mesh_tp step {i}: top-1 agreement {e['top1']}")
    for sv in serves:
        h = sv["held"]
        got = [h.get("prefill", {}).get("calls"), h.get("decode", {}).get("calls")]
        check(got == sv["held_want"], f"mesh_tp: K5 held against its plain version in "
              f"{got} (prefill, decode) calls, want {sv['held_want']}")
        for name, a in h.items():
            check(a["ratio"] <= 1.0,
                  f"mesh_tp: K5's {name} at a rank's heads against its plain version: {a}")
    check(min(slots) >= MIN_SLOT_AGREEMENT,
          f"mesh_tp: compressed slots agree {min(slots)} with the caches put together")
    check(all(sv["repeat_bitwise"] for sv in serves),
          "mesh_tp: a second prefill and forced decode differ")
    check(all(np.array_equal(sv["tokens"], serves[0]["tokens"]) for sv in serves),
          "mesh_tp: the ranks' gathered tokens differ")
    for sv in serves:
        c = sv["counts"]
        check(DEV != "cuda" or (all(c.get(k, 0) == n for k, n in sv["want"].items())
                                and c.get("K3", 0) > 0),
              f"mesh_tp: a rank's serving launched {c}, want {sv['want']} and K3")
    check(DEV != "cuda" or all(reckoned <= (r["peak_bytes"] or 0) for r in rows),
          f"mesh_tp: a rank's peak {peak} B is below the {reckoned} B of state "
          f"check_fits reckons: the reckoning is wrong")
    check(DEV != "cuda" or init_peak <= init_reckoned,
          f"mesh_tp: a rank's peak while the model is drawn, {init_peak} B, is past "
          f"the {init_reckoned} B check_fits reckons for it")


def _timed_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` between CUDA events (one warm-up)."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def _lm_measured(state: dict) -> dict:
    """The lm phase's model, timed here: the prompt's prefill into a cache
    of prompt + new_tokens slots, and one decode step over a compressed
    cache of DRYRUN's slots (zero prototype bias and mass, the last slot
    being written); each its p50 over DRYRUN's repeats, and its peak."""
    engine, prompts = state["lm_engine"]
    bundle, model = engine.bundle, engine.model
    b = prompts.shape[0]
    tok = torch.from_numpy(prompts).to(DEV)
    out = {}
    with torch.inference_mode():
        caches = bundle.init_caches(b, LM["prompt"] + LM["new_tokens"], device=DEV)

        def prefill():
            return bundle.prefill(model, caches, {"tokens": tok}, impl="auto")

        ms = _timed_ms(prefill, DRYRUN["reps"])
        sync()
        beside = _beside_inputs(model, caches, tok)
        prefill()
        sync()
        out["prefill"] = dict(p50_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
                              beside_bytes=beside)
        del caches
        slots = DRYRUN["decode_cache"]
        caches = bundle.init_caches(b, slots, device=DEV)
        for c in caches["layers"]:
            c["pos"] = slots - 1
            c["bias"] = torch.zeros(c["k"].shape[:-1], dtype=torch.float32, device=DEV)
            c["mass"] = torch.zeros(c["k"].shape[:-1], dtype=torch.float32, device=DEV)
        step_tok = tok[:, :1]

        def decode():
            return bundle.decode_step(model, caches, {"tokens": step_tok}, impl="auto")

        ms = _timed_ms(decode, DRYRUN["reps"])
        sync()
        beside = _beside_inputs(model, caches, step_tok)
        decode()
        sync()
        out["decode"] = dict(p50_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
                             beside_bytes=beside)
        del caches
    return out


def _dry_line(cell: str, cfg, shape, got: dict, measured: dict, n_active: int) -> dict:
    """One dryrun line: the reckoning beside the card's numbers and the
    shares that hold them together."""
    from repro_torch.utils import roofline

    p50_s = measured["p50_ms"] / 1e3
    model_flops = roofline.model_flops_for(cfg, shape, n_active=n_active)
    step_peak = measured["peak_bytes"] - measured["beside_bytes"]
    line = dict(cell=cell, kind=shape.kind, batch=shape.global_batch, seq=shape.seq_len,
                flops_by_dtype=got["flops_by_dtype"], bytes=got["bytes"],
                peak_bytes_reckoned=got["peak_bytes"], inputs_bytes=got["start_bytes"],
                kernels=got["kernels"], collectives=got["op_counts"],
                model_flops=model_flops, p50_ms=measured["p50_ms"],
                peak_bytes_measured=step_peak,
                mfu=model_flops / (p50_s * roofline.PEAK_FLOPS),
                hw_flops_share=roofline.compute_seconds(got["flops_by_dtype"]) / p50_s,
                bytes_share=got["bytes"] / roofline.HBM_BW / p50_s,
                peak_ratio=got["peak_bytes"] / step_peak)
    emit("dryrun", **line)
    return line


def phase_dryrun(state: dict) -> None:
    """The dry run against the card (module docstring, ``dryrun``)."""
    import dataclasses

    from repro_torch.configs import ARCHS, ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    if "train_measured" not in state:  # run alone: what it compares against
        phase_train(state)
        state.pop("trainer", None)
    if "mesh_tp_measured" not in state:
        phase_mesh_tp(state)
    if "lm_engine" not in state:
        phase_lm(state)
    t0 = time.perf_counter()
    gemma = ARCHS[TRAIN["arch"]]
    n_active = dryrun._active_params(gemma, dryrun._model(gemma, trainable=False,
                                                          mesh=None))
    lines = []
    tm = state["train_measured"]
    shape = ShapeConfig("train_gemma2", tm["seq"], tm["batch"], "train")
    got = dryrun.trace_step(gemma, shape, None, parallel=ParallelConfig(remat="block"))
    lines.append(_dry_line("train_gemma2", gemma, shape, got, tm, n_active))
    lm = _lm_measured(state)
    shape = ShapeConfig("lm_gemma2_prefill", LM["prompt"], LM["batch"], "prefill")
    got = dryrun.trace_step(gemma, shape, None, parallel=ParallelConfig(remat="none"),
                            cache_len=LM["prompt"] + LM["new_tokens"])
    lines.append(_dry_line("lm_gemma2_prefill", gemma, shape, got, lm["prefill"],
                           n_active))
    shape = ShapeConfig("lm_gemma2_decode", LM["prompt"], LM["batch"], "decode")
    got = dryrun.trace_step(gemma, shape, None, parallel=ParallelConfig(remat="none"),
                            variant="ihtc-kv", cache_len=DRYRUN["decode_cache"])
    lines.append(_dry_line("lm_gemma2_decode", gemma, shape, got, lm["decode"],
                           n_active))
    S, mt = MESH_TP, state["mesh_tp_measured"]
    cut = dataclasses.replace(gemma, n_layers=S["layers"])
    shape = ShapeConfig("mesh_tp_gemma2", S["seq"], S["batch"], "train")
    got = dryrun.trace_step(cut, shape, MeshShape(("data", "model"), (S["data"], S["model"])),
                            parallel=ParallelConfig(remat="block"))
    rank = dict(mt, p50_ms=mt["p50_ms"])
    cut_active = dryrun._active_params(cut, dryrun._model(cut, trainable=False, mesh=None))
    lines.append(_dry_line("mesh_tp_gemma2_rank", cut, shape, got, rank, cut_active))
    seconds = round(time.perf_counter() - t0, 3)
    emit("dryrun_phase", seconds=seconds, limit_s=DRYRUN["limit_s"])
    lo, hi = DRYRUN["peak_ratio"]
    for ln in lines:
        for key in ("mfu", "hw_flops_share"):
            check(ln[key] <= 1.0, f"dryrun {ln['cell']}: {key} {ln[key]} > 1: the count "
                  f"is wrong")
        check(lo <= ln["peak_ratio"] <= hi,
              f"dryrun {ln['cell']}: reckoned / measured peak {ln['peak_ratio']} "
              f"outside [{lo}, {hi}]")
    for r, ops in enumerate(mt["ranks_ops"]):
        check(ops == got["op_counts"],
              f"dryrun: mesh_tp rank {r} recorded {ops}, the dry run reckons "
              f"{got['op_counts']}")
    check(seconds <= DRYRUN["limit_s"],
          f"dryrun: the phase took {seconds} s, past its {DRYRUN['limit_s']} s")


def phase_select(state: dict) -> None:
    """The paper's instance selection on a 65,536-example corpus with the
    train phase's embedding table, kernel path against the plain path,
    then weighted training steps on the selected corpus."""
    from repro_torch import kernels, prng
    from repro_torch.core.itis import level_sizes
    from repro_torch.core.knn import knn_graph_blocked
    from repro_torch.core.prototypes import standardize
    from repro_torch.data import DataConfig, synth_tokens
    from repro_torch.data.instance_selection import (
        SelectionConfig,
        featurize,
        reduced_batch,
        select_instances,
    )
    from repro_torch.train.fault_tolerance import run_training
    from repro_torch.utils.tree import tree_bytes

    tr = _trainer(state)
    cfg, model = tr["cfg"], tr["model"]
    n, s = SELECT["n"], SELECT["seq"]
    scfg = SelectionConfig()
    t, m = scfg.threshold, scfg.iterations
    sizes = level_sizes(n, t, m)
    k4_bytes = n * sizes[-1] * 4
    resident = tree_bytes({"p": model, "o": tr["opt"]}) + 4 * sum(
        p.numel() for p in model.parameters())  # params, moments, grads
    total = torch.cuda.get_device_properties(0).total_memory
    check(resident + k4_bytes < total,
          f"the trainer's {resident} bytes and K4's {k4_bytes} do not fit")
    corpus = synth_tokens(prng.PRNGKey(SELECT["seed"]), n, s, cfg.vocab_size,
                          DataConfig(), device=DEV)
    table = model.embed.table
    sync()
    t0 = time.perf_counter()
    featurize(corpus, cfg.vocab_size, scfg.feature_dim, embed_table=table)
    sync()
    feat_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sel = select_instances(corpus, cfg.vocab_size, scfg, embed_table=table)
    sync()
    select_s = time.perf_counter() - t0
    deep_cfg = SelectionConfig(iterations=SELECT["m_deep"])
    t0 = time.perf_counter()
    deep = select_instances(corpus, cfg.vocab_size, deep_cfg, embed_table=table)
    sync()
    deep_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    state["select_counts"], state["select_routes"] = counts, routes

    def summary(r, mm):
        valid = r.valid.cpu()
        n_sel = int(valid.sum())
        mass = float(torch.where(r.valid, r.weights, 0.0).double().sum())
        idx = r.indices.cpu()[valid]
        return dict(m=mm, selected=n_sel, reduction=n / n_sel, mass_sum=mass,
                    distinct=len(set(idx.tolist())) == n_sel,
                    assigned=bool((r.assignment >= 0).all()))

    main_sum, deep_sum = summary(sel, m), summary(deep, SELECT["m_deep"])

    # the plain path on the card, and the level-0 kNN of both paths
    t0 = time.perf_counter()
    ref = select_instances(corpus, cfg.vocab_size,
                           SelectionConfig(impl="ref"), embed_table=table)
    sync()
    plain_s = time.perf_counter() - t0
    feats = standardize(featurize(corpus, cfg.vocab_size, scfg.feature_dim,
                                  embed_table=table))
    kd, ki = knn_graph_blocked(feats, t - 1, impl="auto")
    rd, ri = knn_graph_blocked(feats, t - 1, impl="ref")
    knn_mism, knn_far = topk_mismatches(feats, feats, kd, ki, rd, ri)
    a_k, a_r = sel.assignment.long(), ref.assignment.long()
    agree = {
        "assignment": float((a_k == a_r).double().mean()),
        "indices": float((sel.indices[a_k] == ref.indices[a_r]).double().mean()),
        "weights": float((sel.weights[a_k] == ref.weights[a_r]).double().mean()),
    }
    bitwise = all(torch.equal(getattr(sel, f), getattr(ref, f))
                  for f in ("indices", "weights", "valid", "assignment"))

    # weighted steps on the selected corpus (weights = masses)
    rb = reduced_batch(corpus, sel)
    bsz, n_steps = SELECT["batch"], SELECT["steps"]

    def rows(step):
        sl = slice(step * bsz, (step + 1) * bsz)
        return {k: v[sl] for k, v in rb.items()}

    wm: list = []
    model, opt, _ = run_training(
        train_step=_synced(tr["step"]), init_state=(model, tr["opt"]),
        batch_for_step=rows, n_steps=n_steps, on_metrics=lambda st, mt: wm.append(mt))
    tr["model"], tr["opt"] = model, opt
    w_losses = [float(x["loss"]) for x in wm]
    w_got = [float(x["weight"]) for x in wm]
    w_want = [float((rows(i)["weights"].double()
                     * (rows(i)["labels"] >= 0).sum(1).double()).sum())
              for i in range(n_steps)]

    emit("select", n=n, seq=s + 1, vocab=cfg.vocab_size,
         feature_dim=scfg.feature_dim, t=t, level_sizes=sizes,
         k4_matrix_bytes=k4_bytes, resident_bytes=resident,
         reckoned_peak_bytes=resident + k4_bytes, card_bytes=total,
         **main_sum, deep=deep_sum,
         walls={"featurize_s": round(feat_s, 4), "select_s": round(select_s, 4),
                "deep_select_s": round(deep_s, 4), "plain_select_s": round(plain_s, 4)},
         max_memory_allocated=peak,
         launches={k: v for k, v in counts.items() if v}, launches_by_route=routes,
         agreement=agree, bitwise=bitwise, level0_knn_mismatches=knn_mism,
         level0_knn_not_near_ties=knn_far,
         weighted_losses=w_losses, weight_metric=w_got, weight_expected=w_want)
    for sm in (main_sum, deep_sum):
        check(abs(sm["mass_sum"] - n) < 1e-2,
              f"m={sm['m']}: masses sum to {sm['mass_sum']}, want {n}")
        check(sm["selected"] <= n // t ** sm["m"], f"m={sm['m']}: too many selected")
        check(sm["distinct"] and sm["assigned"],
              f"m={sm['m']}: selected examples repeat or an example has no prototype")
    for kid in ("K1", "K2", "K3", "K4"):
        check(counts[kid] > 0, f"{kid} was not launched by the select path")
    check(counts["K5"] == 0, "the select path launched K5")
    check(knn_far == 0, f"{knn_far} level-0 kNN mismatches are not near-ties")
    check(min(agree.values()) >= MIN_SELECT_AGREEMENT,
          f"kernel vs plain selection: agreement {agree}")
    check(bitwise or knn_mism > 0,
          "kernel and plain selection differ with no level-0 near-tie")
    check(all(np.isfinite(w_losses)), f"weighted steps: losses {w_losses}")
    check(np.allclose(w_got, w_want, rtol=1e-6, atol=0),
          f"weighted steps: weight metric {w_got}, want {w_want}")


def _logit_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """(b, vocab) logits of two paths: max |Δlogit|, its bound (LOGIT_ULPS
    bf16 ulps of the largest |logit|), top-1 agreement."""
    top = float(want.abs().max())
    return {"err": float((got - want).abs().max()),
            "bound": LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7),
            "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def _slot_agreement(a: dict, b: dict) -> float:
    """Share of (layer, batch, head, prototype slot) entries whose key,
    value (bf16: within one ulp) and mass (SUM_TOL) agree in two compressed
    caches of the same model."""
    agree = total = 0
    for ca, cb in zip(a["layers"], b["layers"], strict=True):
        if "k" not in ca:  # a Mamba layer's state: not compressed
            continue
        P = ca["pos"]
        check(P == cb["pos"], "compressed caches of different sizes")
        ok = torch.isclose(ca["mass"][..., :P], cb["mass"][..., :P], **SUM_TOL)
        for name in ("k", "v"):
            x, y = ca[name][:, :, :P].float(), cb[name][:, :, :P].float()
            ok &= torch.isclose(x, y, rtol=2 ** -7, atol=1e-5).all(-1)
        agree += int(ok.sum())
        total += ok.numel()
    return agree / total


@contextlib.contextmanager
def _attention_as(fn):
    """While the block runs, the model's windowless attention (its calls to
    ``ops.flash_attention``, K5 on the card) goes to ``fn(q, k, v, kv_bias,
    causal=, scale=, logit_softcap=)``; ``None`` leaves it alone."""
    from repro_torch.kernels import ops

    real = ops.flash_attention
    if fn is not None:
        ops.flash_attention = (lambda q, k, v, *, kv_bias=None, impl=None, **kw:
                               fn(q, k, v, kv_bias, **kw))
    try:
        yield
    finally:
        ops.flash_attention = real


def _cloned(c):
    """A copy of a cache tree whose tensors are cloned (the decode steps
    write the caches in place)."""
    if torch.is_tensor(c):
        return c.clone()
    if isinstance(c, dict):
        return {n: _cloned(a) for n, a in c.items()}
    if isinstance(c, list):
        return [_cloned(a) for a in c]
    return c


def _forced_route(bundle, model, tok, steps, *, impl, compress_impl,
                  attention=None, traffic=LM, held=None, inputs=None,
                  cache_kw=None, compress=True, plan=None, whole=None):
    """One route through prefill, compression and teacher-forced decode:
    (last-position f32 logits of the prefill and of each step, the prefill
    caches, a copy of the compressed caches as the steps found them).
    ``held``: a list that receives, for every windowless attention call
    of the route, its output held against K5's plain version on the same
    inputs (``_attention_held``). ``inputs``: the prefill's other batch
    entries (a VLM's ``patch_embeds``, an enc-dec model's ``frames``, with
    its ``enc_len`` in ``cache_kw``); ``compress=False`` decodes from the
    raw caches (then the copy is of those). On a mesh's model axis:
    ``plan`` (``make_plan``), ``cache_kw=dict(tp_size=)`` and ``whole``,
    which puts one rank's last-position logits (its rows, its vocabulary
    columns) together into the whole batch's."""
    from repro_torch.serve.kv_compression import compress_model_caches

    B, S = tok.shape
    with torch.inference_mode(), _attention_as(attention), \
            (_attention_held(held) if held is not None else contextlib.nullcontext()):
        raw = bundle.init_caches(B, S + traffic["new_tokens"], device=tok.device,
                                 **(cache_kw or {}))
        pl = {} if plan is None else {"plan": plan}
        logits, raw = bundle.prefill(model, raw, {"tokens": tok, **(inputs or {})},
                                     impl=impl, **pl)

        def last(x):
            return (x[:, -1] if whole is None else whole(x[:, -1])).float()

        out = [last(logits)]
        comp = (compress_model_caches(raw, traffic["t"], traffic["m"],
                                      tail=traffic["tail"], impl=compress_impl)
                if compress else raw)
        start = _cloned(comp)
        for i in range(steps.shape[1]):
            logits, comp = bundle.decode_step(model, comp,
                                              {"tokens": steps[:, i:i + 1]},
                                              impl=impl, **pl)
            out.append(last(logits))
    return out, raw, start


@contextlib.contextmanager
def _attention_held(held: list):
    """While the block runs, every windowless attention call (through
    ``ops.flash_attention``, whatever stands there) is held against K5's
    plain version on the same inputs: ``held`` receives one entry a call,
    its query length, the largest |difference| and its ratio to the
    tolerance (ATTN_TOL_BF16, or ATTN_TOL_F32 for f32: at most 1 where
    ``torch.allclose`` holds)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    inner = ops.flash_attention

    def checked(q, k, v, *, kv_bias=None, impl=None, causal=True, scale=None,
                logit_softcap=0.0):
        out = inner(q, k, v, kv_bias=kv_bias, impl=impl, causal=causal,
                    scale=scale, logit_softcap=logit_softcap)
        want = fa.flash_attention_plain(q, k, v, kv_bias, causal=causal, scale=scale,
                                        logit_softcap=logit_softcap).float()
        tol = ATTN_TOL_BF16 if q.dtype == torch.bfloat16 else ATTN_TOL_F32
        diff = (out.float() - want).abs()
        held.append({"lq": q.shape[2], "err": float(diff.max()),
                     "ratio": float((diff / (tol["atol"] + tol["rtol"] * want.abs())
                                     ).max())})
        return out

    ops.flash_attention = checked
    try:
        yield held
    finally:
        ops.flash_attention = inner


def _held_summary(held: list) -> dict:
    """The worst prefill call and the worst decode call of ``_attention_held``."""
    out = {}
    for name, calls in (("prefill", [h for h in held if h["lq"] > 1]),
                        ("decode", [h for h in held if h["lq"] == 1])):
        if calls:
            w = max(calls, key=lambda h: h["ratio"])
            out[name] = {"calls": len(calls), "err": w["err"], "ratio": w["ratio"]}
    return out


def lm_engine():
    """The lm phase's serving set-up: the seeded full-width model, its
    prompts and the engine that compresses the KV cache.
    Returns (cfg, bundle, model, engine, prompts)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = ARCHS[LM["arch"]]
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM["batch"], LM["prompt"]))
    engine = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=LM["new_tokens"], compress=True, compress_t=LM["t"],
        compress_m=LM["m"], compress_tail=LM["tail"], impl="auto"))
    return cfg, bundle, model, engine, prompts


def phase_lm(state: dict) -> None:
    """Serve the full gemma2-2b with IHTC KV compression, then hold the
    kernel path against two plain paths and against itself."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.kv_compression import compress_model_caches

    t0 = time.perf_counter()
    cfg, bundle, model, engine, prompts = lm_engine()
    sync()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = engine.generate({"tokens": prompts})
    sync()
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    tm = out["timings"]
    n_global = sum(cfg.attn_type(l) == "global" for l in range(cfg.n_layers))
    want_k5 = n_global + cfg.n_layers * LM["new_tokens"]
    heads = cfg.n_layers * LM["batch"] * cfg.n_kv_heads
    check(out["compressions"] >= 1, "no in-flight recompression")
    check(tuple(out["tokens"].shape) == (LM["batch"], LM["new_tokens"]),
          "lm output shape")
    check(bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()),
          "tokens outside the vocabulary")
    check(counts["K5"] == want_k5,
          f"K5 launched {counts['K5']} times, want {want_k5} ({n_global} "
          f"global prefill layers + {cfg.n_layers} per decode step)")
    want_decode = cfg.n_layers * LM["new_tokens"]
    check(counts["K5-decode"] == want_decode
          and counts["K5"] - counts["K5-decode"] == n_global,
          f"K5's split-kv route launched {counts['K5-decode']} times, want "
          f"{want_decode} (every decode step), and the others "
          f"{counts['K5'] - counts['K5-decode']}, want {n_global} (the prefill)")
    check(routes.get("K5/tiled_mma") == n_global and "K5/tiled" not in routes,
          f"K5's prefill took routes {routes}, want {n_global} calls on tiled_mma")
    check(counts["K2"] == heads * len(tm["compress"]),
          f"K2 launched {counts['K2']} times, want one per head and compress")
    check(counts["K3"] > 0, "K3 was not launched by the lm phase")
    state["lm_counts"] = counts
    state["lm_routes"] = routes
    state["lm_engine"] = (engine, prompts)
    n_tok = LM["batch"] * out["n_steps"]
    emit("lm", arch=cfg.name, batch=LM["batch"], prompt=LM["prompt"],
         new_tokens=out["n_steps"], init_s=round(init_s, 3),
         prefill_ms=tm["prefill_s"] * 1e3,
         compress=[{"ms": c["seconds"] * 1e3, "slots_before": c["slots_before"],
                    "slots_after": c["slots_after"]} for c in tm["compress"]],
         decode_s=tm["decode_s"], decode_tok_per_s=n_tok / tm["decode_s"],
         compressions=out["compressions"], max_memory_allocated=peak,
         tokens_sha1=hashlib.sha1(out["tokens"].cpu().numpy().tobytes()).hexdigest(),
         launches={k: counts[k] for k in ("K2", "K3", "K5", "K5-decode")},
         launches_by_route=routes, k5_expected=want_k5)

    # the kernel path against the plain paths: prefill, each path
    # compresses its own cache, then teacher-forced decode steps fed the
    # tokens the kernel path generated
    t1 = time.perf_counter()
    tok = torch.from_numpy(prompts).to(DEV)
    steps = out["tokens"][:, :LM["forced_steps"]].to(DEV, torch.int64)
    kern, raw, start = _forced_route(bundle, model, tok, steps, impl="auto",
                                     compress_impl="auto")
    with torch.inference_mode():
        # one cache compressed by both paths
        slots = _slot_agreement(start, compress_model_caches(
            raw, LM["t"], LM["m"], tail=LM["tail"], impl="ref"))
        del raw
        # the planted fault: the first step again with K5's bias dropped
        with _attention_as(lambda q, k, v, kv_bias, **kw:
                           fa.flash_attention(q, k, v, None, **kw)):
            fault, _ = bundle.decode_step(model, start, {"tokens": steps[:, :1]},
                                          impl="auto")
        del start
    plain = _forced_route(bundle, model, tok, steps, impl="auto",
                          compress_impl="ref",
                          attention=fa.flash_attention_plain)[0]
    route = _forced_route(bundle, model, tok, steps, impl="ref",
                          compress_impl="ref")[0]
    sync()
    errs = {"plain": [_logit_diff(a, b) for a, b in zip(kern, plain)],
            "route": [_logit_diff(a, b) for a, b in zip(kern, route)]}
    planted = _logit_diff(fault[:, -1].float(), plain[1])
    parity_s = time.perf_counter() - t1

    # the kernel path again: the same tokens, bit for bit
    again = engine.generate({"tokens": prompts})
    repeat = bool(torch.equal(again["tokens"], out["tokens"]))

    emit("lm_parity", logit_ulps=LOGIT_ULPS,
         steps={name: [_rounded(e) for e in es] for name, es in errs.items()},
         planted_fault=_rounded(planted), compressed_slot_agreement=slots,
         bitwise_repeat=repeat, parity_s=round(parity_s, 3),
         seconds=round(time.perf_counter() - t0, 3))
    for name, es in errs.items():
        for i, e in enumerate(es):  # step 0 is the prefill
            check(e["finite"], f"{name} step {i}: non-finite logits")
            check(e["err"] <= e["bound"],
                  f"{name} step {i}: max |dlogit| {e['err']} > {e['bound']}")
            check(e["top1"] >= MIN_TOP1,
                  f"{name} step {i}: top-1 agreement {e['top1']}")
    check(planted["err"] > planted["bound"],
          f"K5 with its bias dropped stays within the logit bound "
          f"({planted['err']} <= {planted['bound']})")
    check(slots >= MIN_SLOT_AGREEMENT,
          f"kernel vs plain compression: slot agreement {slots}")
    check(repeat, "two kernel-path generations differ")


def _rounded(e: dict) -> dict:
    """A reading's floats to 6 decimals, for its JSON line."""
    return {k: round(v, 6) if isinstance(v, float) else v for k, v in e.items()}


def _family_logit_diff(got: torch.Tensor, want: torch.Tensor, vocab: int) -> dict:
    """``_logit_diff`` over the first ``vocab`` columns (the padding
    columns hold -1e30)."""
    return _logit_diff(got[..., :vocab], want[..., :vocab])


def _top1_over_rows(errs: list) -> float:
    """Top-1 agreement over every row of a route's prefill and steps (each
    step has the same batch). At batch 4 a single step reads 0.75 as soon
    as one row's two best logits lie nearer than the difference between
    the paths, which random-init logits often do; over 132 rows the share
    reads the rate of such flips."""
    return float(np.mean([e["top1"] for e in errs]))


class RoutingPin:
    """Hold two runs of one MoE model to the same routing, for comparing
    them. While a block runs it stands in for
    ``repro_torch.models.moe.top_k`` (a module attribute: one comparison
    at a time in a process).

    Routing is a step function of the router probabilities: where a
    token's k-th and (k+1)-th probabilities nearly tie, a last-bit
    difference upstream (another attention kernel, another framework)
    picks another expert and moves that token's output by a whole
    expert's share. ``record()`` keeps the (T, k) top-k indices of every
    MoE call of one run in ``calls``, in call order (a caller may fill
    ``calls`` from another package's run instead). In ``replay()`` a
    second run of the same calls compares its own choice with the
    recorded one, token by token. A token whose choice differs only among
    experts within a relative ``BAND`` (2^-5) of its own top-k boundary
    (the mean of its k-th and (k+1)-th probabilities) takes the recorded
    choice and counts in ``near``; any other differing token counts in
    ``far`` and takes the recorded choice only with ``pin_far``.
    ``pinned`` counts the tokens that took the recorded choice;
    ``worst_gap`` is the largest relative distance from the boundary of an
    expert a pinned token swapped.

        pin = RoutingPin()
        with pin.record():  run_a()
        with pin.replay():  run_b()      # then require pin.far == 0
    """

    BAND = 2.0 ** -5

    def __init__(self, pin_far: bool = False):
        self.pin_far = pin_far
        self.calls: list = []
        self._i = 0
        self._counts: list = []

    @contextlib.contextmanager
    def _standing_in(self, fn):
        from repro_torch.models import moe

        real = moe.top_k
        moe.top_k = fn
        try:
            yield self
        finally:
            moe.top_k = real

    def record(self):
        """While the block runs, keep each call's (T, k) indices."""
        from repro_torch.models import moe

        real = moe.top_k
        self.calls = []

        def rec(probs, k):
            vals, idx = real(probs, k)
            self.calls.append(idx.clone())
            return vals, idx
        return self._standing_in(rec)

    def replay(self):
        """While the block runs, take the recorded choices (class doc)."""
        from repro_torch.models import moe

        real = moe.top_k
        self._i, self._counts = 0, []

        def rep(probs, k):
            vals, idx = real(probs, k)
            want = self.calls[self._i]
            want = (want if torch.is_tensor(want) else torch.tensor(want)).to(
                idx.device, torch.long)
            self._i += 1
            e = probs.shape[-1]
            own = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, idx, True)
            rec = torch.zeros_like(own).scatter_(-1, want, True)
            differ = own ^ rec
            rows = differ.any(dim=-1)
            if k < e:
                srt = torch.sort(probs, dim=-1, descending=True).values
                edge = 0.5 * (srt[:, k - 1] + srt[:, k])
            else:  # every expert is chosen: no boundary
                edge = torch.ones_like(probs[:, 0])
            gap = torch.where(differ, (probs - edge[:, None]).abs()
                              / edge[:, None], torch.zeros_like(probs)).amax(dim=-1)
            near = rows & (gap <= self.BAND)
            far = rows & ~near
            take = rows if self.pin_far else near
            self._counts.append((near.sum(), far.sum(), take.sum(),
                                 torch.where(take, gap, 0.0).amax()))
            pick = torch.where(take[:, None], want, idx)
            return torch.gather(probs, -1, pick), pick
        return self._standing_in(rep)

    @property
    def near(self) -> int:
        return int(sum(int(c[0]) for c in self._counts))

    @property
    def far(self) -> int:
        return int(sum(int(c[1]) for c in self._counts))

    @property
    def pinned(self) -> int:
        return int(sum(int(c[2]) for c in self._counts))

    @property
    def worst_gap(self) -> float:
        return max((float(c[3]) for c in self._counts), default=0.0)

    def summary(self) -> dict:
        return {"pinned": self.pinned, "near": self.near, "far": self.far,
                "band": self.BAND, "worst_gap": self.worst_gap}


@contextlib.contextmanager
def _moe_drops():
    """While the block runs, each MoE call appends the number of valid
    token slots its dispatch dropped for capacity (a device scalar, read
    afterwards): ``moe.dispatch_indices`` is wrapped, and its ``ok`` mask
    read (top-k ids are always valid)."""
    from repro_torch.models import moe

    real = moe.dispatch_indices
    drops: list = []

    def counted(expert_ids, n_experts, capacity):
        flat, ok = real(expert_ids, n_experts, capacity)
        drops.append((~ok).sum())
        return flat, ok

    moe.dispatch_indices = counted
    try:
        yield drops
    finally:
        moe.dispatch_indices = real


def _parity_checks(which: str, errs: dict, top1: dict, att: dict, want_calls,
                   planted: dict, level: str, att_fault: dict, slots, repeat: bool
                   ) -> None:
    """The verdict of a family phase's parity run: every route's logits
    finite and within the bound at the prefill and each step, top-1 over
    the rows; K5 held in ``want_calls`` (prefill, decode) calls, each
    within its tolerance; the planted fault beyond the bound at its
    ``level``; the compressed slots (``slots`` None: no compression); a
    bitwise repeat."""
    for name, es in errs.items():
        for i, e in enumerate(es):  # step 0 is the prefill
            check(e["finite"], f"{name} step {i}: non-finite logits")
            check(e["err"] <= e["bound"],
                  f"{name} step {i}: max |dlogit| {e['err']} > {e['bound']}")
        check(top1[name] >= MIN_TOP1,
              f"{name}: top-1 agreement over the rows {top1[name]}")
    got = (att.get("prefill", {}).get("calls"), att.get("decode", {}).get("calls"))
    check(got == tuple(want_calls),
          f"K5 held against its plain version in {att} calls, want {want_calls[0]} "
          f"prefill and {want_calls[1]} decode")
    for name, a in att.items():
        check(a["ratio"] <= 1.0,
              f"K5's {name} on the {which} path against its plain version: {a}")
    if level == "logits":
        check(planted["err"] > planted["bound"],
              f"the planted fault stays within the logit bound "
              f"({planted['err']} <= {planted['bound']})")
    else:
        check(att_fault["ratio"] > 1.0,
              f"the planted fault stays within the tolerance of the plain "
              f"version at K5's output ({att_fault})")
    if slots is not None:
        check(slots >= MIN_SLOT_AGREEMENT,
              f"kernel vs plain compression: slot agreement {slots}")
    check(repeat, "two kernel-path generations differ")


def _free_models(state: dict) -> None:
    """Drop what earlier phases hold on the card before a large model
    loads (the lm phase's engine; main drops the train phase's state)."""
    import gc

    state.pop("lm_engine", None)
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_family(state: dict, which: str) -> None:
    """Serve deepseek-moe-16b whole (``lm_moe``) or jamba at full width cut
    to one 8-layer period (``lm_hybrid``) with IHTC KV compression, as the
    lm phase serves gemma2-2b; then hold the kernel path against the two
    plain paths with the MoE routing pinned to the kernel path's, every K5
    call of the kernel path against its plain version, the planted fault,
    the compressed slots and a repeat. The
    hybrid phase then serves mamba2-370m whole against its full forward."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.kv_compression import compress_model_caches

    tr = LM_MOE if which == "lm_moe" else LM_HYBRID
    _free_models(state)
    t0 = time.perf_counter()
    cfg = ARCHS[tr["arch"]]
    if "layers" in tr:
        cfg = dataclasses.replace(cfg, n_layers=tr["layers"])
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    n_params = sum(p.numel() for p in model.parameters())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(tr["batch"], tr["prompt"]))
    engine = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=tr["new_tokens"], compress=True, compress_t=tr["t"],
        compress_m=tr["m"], compress_tail=tr["tail"], impl="auto"))
    sync()
    init_s = time.perf_counter() - t0
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    check(all(cfg.attn_type(l) == "global" for l in range(cfg.n_layers)),
          f"{cfg.name}: a windowed layer (its prefill would not run K5)")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _moe_drops() as drops:
        out = engine.generate({"tokens": prompts})
    sync()
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    drops = [int(d) for d in drops]
    prefill_drops, decode_drops = sum(drops[:n_moe]), sum(drops[n_moe:])
    tm = out["timings"]
    want_k5 = n_attn + n_attn * tr["new_tokens"]
    want_k2 = n_attn * tr["batch"] * cfg.n_kv_heads * len(tm["compress"])
    check(out["compressions"] >= 1, "no in-flight recompression")
    check(tuple(out["tokens"].shape) == (tr["batch"], tr["new_tokens"]),
          f"{which} output shape")
    check(bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()),
          "tokens outside the vocabulary")
    check(counts["K5"] == want_k5,
          f"K5 launched {counts['K5']} times, want {want_k5} ({n_attn} prefill "
          f"layers + {n_attn} per decode step)")
    check(counts["K5-decode"] == n_attn * tr["new_tokens"],
          f"K5's split-kv route launched {counts['K5-decode']} times, want "
          f"{n_attn * tr['new_tokens']}")
    check(routes.get("K5/tiled_mma") == n_attn and "K5/tiled" not in routes,
          f"K5's prefill took routes {routes}, want {n_attn} calls on tiled_mma")
    check(counts["K2"] == want_k2,
          f"K2 launched {counts['K2']} times, want {want_k2} (one per attention "
          f"layer, sequence, kv head and compression)")
    check(counts["K3"] > 0, f"K3 was not launched by the {which} phase")
    check(len(drops) == n_moe * (1 + tr["new_tokens"]),
          f"{len(drops)} MoE calls, want {n_moe} a forward")
    check(decode_drops == 0, f"decode steps dropped {decode_drops} slots")
    state[f"{which}_counts"] = counts
    state[f"{which}_routes"] = routes
    n_tok = tr["batch"] * out["n_steps"]
    emit(which, arch=cfg.name, layers=cfg.n_layers, params=n_params,
         batch=tr["batch"], prompt=tr["prompt"], new_tokens=out["n_steps"],
         init_s=round(init_s, 3), prefill_ms=tm["prefill_s"] * 1e3,
         compress=[{"ms": c["seconds"] * 1e3, "slots_before": c["slots_before"],
                    "slots_after": c["slots_after"]} for c in tm["compress"]],
         decode_s=tm["decode_s"], decode_tok_per_s=n_tok / tm["decode_s"],
         compressions=out["compressions"], max_memory_allocated=peak,
         moe_layers=n_moe, prefill_dropped_slots=prefill_drops,
         prefill_slots=n_moe * tr["batch"] * tr["prompt"] * cfg.n_experts_per_tok,
         decode_dropped_slots=decode_drops,
         tokens_sha1=hashlib.sha1(out["tokens"].cpu().numpy().tobytes()).hexdigest(),
         launches={k: counts[k] for k in ("K2", "K3", "K5", "K5-decode")},
         launches_by_route=routes, k5_expected=want_k5, k2_expected=want_k2)

    # the kernel path against the plain paths, every MoE call of the plain
    # paths pinned to the kernel path's routing (the MoE code is the same on
    # every path, so a routing that parts follows from hidden states that
    # part, which the logits read; the choices beyond 2^-5 of their top-k
    # boundary are counted apart); every K5 call of the kernel path held
    # against its plain version on its own inputs
    t1 = time.perf_counter()
    tok = torch.from_numpy(prompts).to(DEV)
    steps = out["tokens"][:, :tr["forced_steps"]].to(DEV, torch.int64)
    pin = RoutingPin(pin_far=True)
    held, f_held = [], []
    with pin.record():
        kern, raw, start = _forced_route(bundle, model, tok, steps, impl="auto",
                                         compress_impl="auto", traffic=tr,
                                         held=held)
    with torch.inference_mode():
        slots = _slot_agreement(start, compress_model_caches(
            raw, tr["t"], tr["m"], tail=tr["tail"], impl="ref"))
        del raw
        # the planted fault: the first step again with K5's bias dropped
        with _attention_as(lambda q, k, v, kv_bias, **kw:
                           fa.flash_attention(q, k, v, None, **kw)), \
                _attention_held(f_held):
            fault, _ = bundle.decode_step(model, start, {"tokens": steps[:, :1]},
                                          impl="auto")
        # how far the attention layers move the logits at all: the first
        # step with every attention output zeroed
        with _attention_as(lambda q, k, v, kv_bias, **kw: torch.zeros_like(q)):
            no_attn, _ = bundle.decode_step(model, start, {"tokens": steps[:, :1]},
                                            impl="auto")
        del start
    pinned = {}
    with pin.replay():
        plain = _forced_route(bundle, model, tok, steps, impl="auto",
                              compress_impl="ref", attention=fa.flash_attention_plain,
                              traffic=tr)[0]
    pinned["plain"] = pin.summary()
    with pin.replay():
        route = _forced_route(bundle, model, tok, steps, impl="ref",
                              compress_impl="ref", traffic=tr)[0]
    pinned["route"] = pin.summary()
    sync()
    v = cfg.vocab_size
    errs = {"plain": [_family_logit_diff(a, b, v) for a, b in zip(kern, plain)],
            "route": [_family_logit_diff(a, b, v) for a, b in zip(kern, route)]}
    top1 = {name: _top1_over_rows(es) for name, es in errs.items()}
    planted = _family_logit_diff(fault[:, -1].float(), plain[1], v)
    reach = _family_logit_diff(no_attn[:, -1].float(), kern[1], v)
    att = _held_summary(held)
    att_fault = _held_summary(f_held)["decode"]
    # the planted fault is read on the logits, unless even zeroed attention
    # outputs stay within the logit bound: then at K5's output
    level = "logits" if reach["err"] > reach["bound"] else "attention"
    parity_s = time.perf_counter() - t1

    again = engine.generate({"tokens": prompts})
    repeat = bool(torch.equal(again["tokens"], out["tokens"]))
    del engine, again

    emit(f"{which}_parity", logit_ulps=LOGIT_ULPS,
         steps={name: [_rounded(e) for e in es] for name, es in errs.items()},
         top1_over_rows=top1, pinned_routing=pinned, planted_fault=_rounded(planted),
         zeroed_attention=_rounded(reach), planted_level=level,
         attention_vs_plain=att, attention_planted_fault=att_fault,
         compressed_slot_agreement=slots, bitwise_repeat=repeat,
         parity_s=round(parity_s, 3))
    _parity_checks(which, errs, top1, att, (n_attn, n_attn * tr["forced_steps"]),
                   planted, level, att_fault, slots, repeat)
    del model, bundle, kern, plain, route, fault, no_attn
    if which == "lm_hybrid":
        _free_models(state)
        _ssm_whole(tr)
    emit(f"{which}_done", seconds=round(time.perf_counter() - t0, 3))


def _all_causal(q, k, v, kv_bias, *, causal=True, **kw):
    """K5 with every call made causal: lm_encdec's planted fault (the
    encoder's and the cross-attention's calls are the non-causal ones)."""
    from repro_torch.kernels import flash_attention as fa

    return fa.flash_attention(q, k, v, kv_bias, causal=True, **kw)


def phase_lm_frontend(state: dict, which: str) -> None:
    """Serve phi-3-vision-4.2b whole with its patch prefix and IHTC KV
    compression (``lm_vlm``) or seamless-m4t-large-v2 whole over encoder
    frames (``lm_encdec``); then hold the kernel path against the two plain
    paths over the prefill and the teacher-forced steps, every K5 call of
    the kernel path against its plain version on its own inputs, a planted
    fault (lm_vlm: K5's bias dropped at the first step; lm_encdec: the
    encoder's and the cross-attention's calls made causal at the prefill),
    the compressed slots (lm_vlm) and a repeat."""
    from repro_torch import kernels, prng
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import frontend_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build, frontends
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.kv_compression import compress_model_caches

    vlm = which == "lm_vlm"
    tr = LM_VLM if vlm else LM_ENCDEC
    _free_models(state)
    t0 = time.perf_counter()
    cfg = ARCHS[tr["arch"]]
    check(frontends.VISION_PREFIX_TOKENS == VISION_PREFIX,
          f"the patch prefix is {frontends.VISION_PREFIX_TOKENS} tokens")
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    n_params = sum(p.numel() for p in model.parameters())
    B = tr["batch"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                size=(B, tr["prompt"]))
    # the stubbed front end's output, drawn as make_batch draws it
    inputs = frontend_batch(cfg, prng.PRNGKey(0), B, tr.get("frames", tr["prompt"]),
                            device=DEV)
    cache_kw = {} if vlm else {"enc_len": tr["frames"]}
    engine = ServeEngine(bundle, model, ServeConfig(
        max_new_tokens=tr["new_tokens"], compress=vlm, compress_t=tr["t"],
        compress_m=tr["m"], compress_tail=tr["tail"], impl="auto"))
    sync()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = engine.generate({"tokens": prompts, **inputs}, **cache_kw)
    sync()
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    tm = out["timings"]
    L, N = cfg.n_layers, tr["new_tokens"]
    # K5 calls: the prefill's (phi-3: one a layer; seamless: each encoder
    # layer, and each decoder layer's self and cross attention) on
    # tiled_mma, and each decode step's (self, and seamless's cross) on
    # split-kv
    n_prefill = L if vlm else cfg.n_enc_layers + 2 * L
    n_step = L if vlm else 2 * L
    want_k5 = n_prefill + n_step * N
    want_k2 = L * B * cfg.n_kv_heads * len(tm["compress"])
    check(tuple(out["tokens"].shape) == (B, N), f"{which} output shape")
    check(bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()),
          "tokens outside the vocabulary")
    check(counts["K5"] == want_k5,
          f"K5 launched {counts['K5']} times, want {want_k5} ({n_prefill} prefill "
          f"calls + {n_step} per decode step)")
    check(counts["K5-decode"] == n_step * N,
          f"K5's split-kv route launched {counts['K5-decode']} times, want "
          f"{n_step * N}")
    check(routes.get("K5/tiled_mma") == n_prefill and "K5/tiled" not in routes,
          f"K5's prefill took routes {routes}, want {n_prefill} calls on tiled_mma")
    if vlm:
        check(out["compressions"] >= 1, "no in-flight recompression")
        check(counts["K2"] == want_k2,
              f"K2 launched {counts['K2']} times, want {want_k2} (one per layer, "
              f"sequence, kv head and compression)")
        check(counts["K3"] > 0, f"K3 was not launched by the {which} phase")
    else:
        check(not tm["compress"] and counts["K2"] == counts["K3"] == 0,
              f"{which}: a compression ran ({counts})")
    state[f"{which}_counts"] = counts
    state[f"{which}_routes"] = routes
    n_tok = B * out["n_steps"]
    emit(which, arch=cfg.name, layers=L, enc_layers=cfg.n_enc_layers,
         params=n_params, batch=B, prompt=tr["prompt"],
         prefix=VISION_PREFIX if vlm else 0, frames=tr.get("frames", 0),
         new_tokens=out["n_steps"], init_s=round(init_s, 3),
         prefill_ms=tm["prefill_s"] * 1e3,
         compress=[{"ms": c["seconds"] * 1e3, "slots_before": c["slots_before"],
                    "slots_after": c["slots_after"]} for c in tm["compress"]],
         decode_s=tm["decode_s"], decode_tok_per_s=n_tok / tm["decode_s"],
         compressions=out["compressions"], max_memory_allocated=peak,
         tokens_sha1=hashlib.sha1(out["tokens"].cpu().numpy().tobytes()).hexdigest(),
         launches={k: counts[k] for k in ("K2", "K3", "K5", "K5-decode")},
         launches_by_route=routes, k5_expected=want_k5,
         k2_expected=want_k2 if vlm else 0)

    # the kernel path against the plain paths; every K5 call of the kernel
    # path held against its plain version on its own inputs
    t1 = time.perf_counter()
    tok = torch.from_numpy(prompts).to(DEV)
    steps = out["tokens"][:, :tr["forced_steps"]].to(DEV, torch.int64)
    route_kw = dict(traffic=tr, inputs=inputs, cache_kw=cache_kw, compress=vlm)
    held, f_held = [], []
    kern, raw, start = _forced_route(bundle, model, tok, steps, impl="auto",
                                     compress_impl="auto", held=held, **route_kw)
    with torch.inference_mode():
        slots = (_slot_agreement(start, compress_model_caches(
            raw, tr["t"], tr["m"], tail=tr["tail"], impl="ref")) if vlm else None)
        del raw
        if vlm:
            # the planted fault: the first step again with K5's bias dropped
            with _attention_as(lambda q, k, v, kv_bias, **kw:
                               fa.flash_attention(q, k, v, None, **kw)), \
                    _attention_held(f_held):
                fault, _ = bundle.decode_step(model, start, {"tokens": steps[:, :1]},
                                              impl="auto")
            with _attention_as(lambda q, k, v, kv_bias, **kw: torch.zeros_like(q)):
                no_attn, _ = bundle.decode_step(model, start,
                                                {"tokens": steps[:, :1]}, impl="auto")
        else:
            # the planted fault: the prefill again with the encoder's and the
            # cross-attention's calls (the non-causal ones) made causal
            fresh = bundle.init_caches(B, tr["prompt"] + N, device=DEV, **cache_kw)
            with _attention_as(_all_causal), _attention_held(f_held):
                fault, _ = bundle.prefill(model, fresh, {"tokens": tok, **inputs},
                                          impl="auto")
            fresh = bundle.init_caches(B, tr["prompt"] + N, device=DEV, **cache_kw)
            with _attention_as(lambda q, k, v, kv_bias, **kw: torch.zeros_like(q)):
                no_attn, _ = bundle.prefill(model, fresh, {"tokens": tok, **inputs},
                                            impl="auto")
            del fresh
        del start
    plain = _forced_route(bundle, model, tok, steps, impl="auto", compress_impl="ref",
                          attention=fa.flash_attention_plain, **route_kw)[0]
    route = _forced_route(bundle, model, tok, steps, impl="ref", compress_impl="ref",
                          **route_kw)[0]
    sync()
    v = cfg.vocab_size
    errs = {"plain": [_family_logit_diff(a, b, v) for a, b in zip(kern, plain)],
            "route": [_family_logit_diff(a, b, v) for a, b in zip(kern, route)]}
    top1 = {name: _top1_over_rows(es) for name, es in errs.items()}
    at = 1 if vlm else 0  # the fault's forward: the first step, or the prefill
    planted = _family_logit_diff(fault[:, -1].float(), plain[at], v)
    reach = _family_logit_diff(no_attn[:, -1].float(), kern[at], v)
    att = _held_summary(held)
    att_fault = _held_summary(f_held)["decode" if vlm else "prefill"]
    level = "logits" if reach["err"] > reach["bound"] else "attention"
    parity_s = time.perf_counter() - t1

    again = engine.generate({"tokens": prompts, **inputs}, **cache_kw)
    repeat = bool(torch.equal(again["tokens"], out["tokens"]))
    del engine, again

    emit(f"{which}_parity", logit_ulps=LOGIT_ULPS,
         steps={name: [_rounded(e) for e in es] for name, es in errs.items()},
         top1_over_rows=top1, planted_fault=_rounded(planted),
         zeroed_attention=_rounded(reach), planted_level=level,
         attention_vs_plain=att, attention_planted_fault=att_fault,
         compressed_slot_agreement=slots, bitwise_repeat=repeat,
         parity_s=round(parity_s, 3))
    _parity_checks(which, errs, top1, att, (n_prefill, n_step * tr["forced_steps"]),
                   planted, level, att_fault, slots, repeat)
    del model, bundle, kern, plain, route, fault, no_attn
    _free_models(state)
    emit(f"{which}_done", seconds=round(time.perf_counter() - t0, 3))


def _ssm_whole(tr: dict) -> None:
    """mamba2-370m whole: the prefill and ``ssm_steps`` teacher-forced
    decode steps (the recurrence) against the full forward (the chunked
    scan) at the same positions, within LOGIT_ULPS, top-1 over every row
    at least MIN_TOP1; no kernel may launch (no layer attends), and
    compress=True must refuse the model."""
    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    cfg = ARCHS[tr["ssm_arch"]]
    bundle = build(cfg)
    model = bundle.init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    B, S, N = tr["batch"], tr["prompt"], tr["ssm_steps"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S + N))).to(DEV)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        full, _ = bundle.forward(model, {"tokens": toks}, impl="auto")
        sync()
        t1 = time.perf_counter()
        caches = bundle.init_caches(B, S + N, device=DEV)
        lg, caches = bundle.prefill(model, caches, {"tokens": toks[:, :S]})
        v = cfg.vocab_size
        errs = [_family_logit_diff(lg[:, -1].float(), full[:, S - 1], v)]
        sync()
        t2 = time.perf_counter()
        for i in range(N):
            lg, caches = bundle.decode_step(model, caches,
                                            {"tokens": toks[:, S + i:S + i + 1]})
            errs.append(_family_logit_diff(lg[:, -1].float(), full[:, S + i], v))
        sync()
        t3 = time.perf_counter()
    counts = kernels.launch_counts()
    try:
        ServeEngine(bundle, model, ServeConfig(max_new_tokens=2, compress=True)
                    ).generate({"tokens": toks[:1, :8].cpu().numpy()})
        refused = False
    except ValueError as e:
        refused = cfg.name in str(e)
    worst = max(errs, key=lambda e: e["err"] / e["bound"])
    top1 = _top1_over_rows(errs)
    emit("lm_ssm", arch=cfg.name, layers=cfg.n_layers,
         params=sum(p.numel() for p in model.parameters()), batch=B, prompt=S,
         decode_steps=N, prefill_ms=(t2 - t1) * 1e3,
         decode_tok_per_s=B * N / (t3 - t2),
         worst_step={k: round(v, 6) if isinstance(v, float) else v
                     for k, v in worst.items()}, top1_over_rows=top1,
         launches={k: v for k, v in counts.items() if v}, compress_refused=refused,
         seconds=round(time.perf_counter() - t0, 3))
    for i, e in enumerate(errs):
        check(e["finite"] and e["err"] <= e["bound"],
              f"mamba2 decode step {i} against the forward: {e}")
    check(top1 >= MIN_TOP1, f"mamba2 decode against the forward: top-1 {top1}")
    check(not any(counts.values()), f"a kernel launched on an attention-free "
          f"model: {counts}")
    check(refused, "compress=True did not refuse a model without attention")


def _profiled(label: str, fn) -> None:
    """Run ``fn`` under torch.profiler; emit wall time, total kernel time,
    the busy share and the kernels that took most of the device time."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit("profile", cell=label, profiled_wall_s=round(wall, 4),
         device_busy_s=round(busy_us / 1e6, 4),
         busy_share=round(busy_us / 1e6 / wall, 4),
         top=[{"kernel": e.key[:90], "count": e.count,
               "ms": round(e.self_device_time_total / 1e3, 3)} for e in top])


def phase_profile(state: dict) -> None:
    import repro_torch
    from repro_torch import prng
    from repro_torch.data import gmm_sample

    x = state["x"] if "x" in state else _analog(SIZES["covertype"])[0]
    _profiled("fit_covertype", lambda: repro_torch.fit(
        x, 3, 5, "kmeans", k=7, key=prng.PRNGKey(0), device=DEV))
    g, _ = gmm_sample(SIZES["gmm"], seed=0)
    _profiled("fit_gmm_headline", lambda: repro_torch.fit(
        g, 2, 3, "kmeans", k=3, key=prng.PRNGKey(0), device=DEV))
    if "lm_engine" in state:  # the lm phase's generate, once more
        engine, prompts = state["lm_engine"]
        _profiled("lm_gemma2", lambda: engine.generate({"tokens": prompts}))
    if "online_counts" in state:  # the online stream's first 16 chunks
        from repro_torch.data import PointStreamConfig, point_chunks

        o = ONLINE
        cfg = PointStreamConfig(n=16 * o["chunk"], d=o["d"], chunk=o["chunk"],
                                seed=0, kind="blobs", k=o["k"])
        _profiled("online_stream_16_chunks", lambda: repro_torch.fit(
            point_chunks(cfg), o["t"], o["m"], "kmeans", k=o["k"],
            prefetch_depth=o["depth"], key=prng.PRNGKey(0), device=DEV))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--save-hac", default="", metavar="PATH",
                    help="write the hac fit's prototypes and labels to PATH (.npz)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions: full f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    if {"sharded", "train_mesh", "mesh_tp"} & set(phases):
        from repro_torch.launch.mesh import start_rank_server, stop_rank_server

        start_rank_server()  # the ranks' server imports in the background
        atexit.register(stop_rank_server)
    device = phase_device() if "device" in phases else None
    if "build" in phases:
        phase_build()
    results, state = {}, {}
    if "kernels" in phases:
        phase_kernels(results)
    if "fit" in phases:
        phase_fit(state)
        if "serve" in phases:
            phase_serve(state)
    if "sharded" in phases:
        phase_sharded(state)
    if "tune" in phases:
        phase_tune(state)
    if "headline" in phases:
        phase_headline(state)
    if "determinism" in phases:
        phase_determinism()
    if "hac" in phases:
        phase_hac(state, args.save_hac)
    if "dbscan" in phases:
        phase_dbscan(state)
    if "online" in phases:
        phase_online(results, state)
    if "train" in phases:
        phase_train(state)
    if "select" in phases:
        phase_select(state)
    if "profile" in phases and "trainer" in state:  # one more train step
        tr = state["trainer"]
        _profiled("train_gemma2_step",
                  lambda: tr["step"](tr["model"], tr["opt"], tr["bfs"](0)))
    state.pop("trainer", None)  # the lm phase serves its own model
    torch.cuda.empty_cache()
    for which in TRAIN_FAMILIES:
        if which in phases:
            phase_train_family(state, which, profile="profile" in phases)
    if "train_mesh" in phases:
        phase_train_mesh(state)
    if "mesh_tp" in phases:
        phase_mesh_tp(state)
    if "lm" in phases:
        phase_lm(state)
    if "dryrun" in phases:
        phase_dryrun(state)
    if "profile" in phases:
        phase_profile(state)
    if "basins" in phases:
        phase_basins()
    for family in ("lm_moe", "lm_hybrid"):
        if family in phases:
            phase_lm_family(state, family)
    for family in ("lm_vlm", "lm_encdec"):
        if family in phases:
            phase_lm_frontend(state, family)
    if results:
        paths = {"fit_serve": state.get("main_counts", state.get("fit_counts", {})),
                 "sharded": state.get("sharded_counts", {}),
                 "tune": state.get("tune_counts", {}),
                 "headline": state.get("headline_counts", {}),
                 "hac": state.get("hac_counts", {}),
                 "dbscan": state.get("dbscan_counts", {}),
                 "online": state.get("online_counts", {}),
                 "train": state.get("train_counts", {}),
                 "select": state.get("select_counts", {}),
                 **{w: state.get(f"{w}_counts", {}) for w in TRAIN_FAMILIES},
                 "mesh_tp": state.get("mesh_tp_counts", {}),
                 "lm": state.get("lm_counts", {}),
                 "lm_moe": state.get("lm_moe_counts", {}),
                 "lm_hybrid": state.get("lm_hybrid_counts", {}),
                 "lm_vlm": state.get("lm_vlm_counts", {}),
                 "lm_encdec": state.get("lm_encdec_counts", {})}
        routes = {"fit_serve": state.get("main_routes", {}),
                  "sharded": state.get("sharded_routes", {}),
                  "tune": state.get("tune_routes", {}),
                  "headline": state.get("headline_routes", {}),
                  "hac": state.get("hac_routes", {}),
                  "dbscan": state.get("dbscan_routes", {}),
                  "online": state.get("online_routes", {}),
                  "train": state.get("train_routes", {}),
                  "select": state.get("select_routes", {}),
                  **{w: state.get(f"{w}_routes", {}) for w in TRAIN_FAMILIES},
                  "mesh_tp": state.get("mesh_tp_routes", {}),
                  "lm": state.get("lm_routes", {}),
                  "lm_moe": state.get("lm_moe_routes", {}),
                  "lm_hybrid": state.get("lm_hybrid_routes", {}),
                  "lm_vlm": state.get("lm_vlm_routes", {}),
                  "lm_encdec": state.get("lm_encdec_routes", {})}
        line = []
        for kid in ("K1", "K1-bf16", "K1-int8", "K2", "K3", "K4", "K5", "K5-decode",
                    "K5-prefill"):
            if kid not in results:  # a run without the kernels phase
                continue
            r = results[kid]
            name, source, replaces = KERNEL_META[kid]
            by_path = {p: c.get(kid, 0) for p, c in paths.items() if c}
            if kid in ("K5", "K5-prefill"):  # one route's kernel alone
                key = "K5/tiled" if kid == "K5" else "K5/tiled_mma"
                by_path = {p: routes[p].get(key, 0) for p in by_path}
            entry = {"name": name, "route": "cuda",
                     "variant": r.get("variant", "cuda_core"),
                     "source": source, "replaces": replaces,
                     "launches": sum(by_path.values()) if by_path else None,
                     "launches_by_path": by_path,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            if kid == "K4":  # launches of each instance, per path
                entry["launches_by_route"] = {
                    p: {k: v for k, v in routes[p].items() if k.startswith("K4/")}
                    for p in by_path}
            line.append(entry)
        print(json.dumps({"kernels": line}), flush=True)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))
    if device is None:
        device = {"name": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device["name"],
                                             "count": device["count"]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port (``tpu_llama_torch``) on one NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (any failure exits non-zero and prints no result line):

1. the device: ``torch.cuda`` name and count, and ``nvidia-smi``'s name and
   power limit;
2. build every CUDA kernel from ``tpu_llama_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the ``-Xptxas -v`` register/spill summary;
3. each kernel (K1 W8A8 GEMM, its decode tile at M 8 and its wgmma kernel
   from M 16 up to the admission's 4096, also with its residual epilogue, and
   at M 1000 and 2048 on the fused layer's products, each row with its share
   of the int8 peak; K1's int32 form at tp = 2's wo and w2 K-slices, M 8 and
   1024, two slices' sums through ``w8a8_epilogue`` against K1; K2 row
   quant and K3 rmsnorm+quant (at the admission's 4096 rows, a chunk's 2048
   and a decode step's 8), K4 silu*up+quant, K5 rope+split+KV quant, K6
   INT8 prefill attention, K7 slot scatter, K9 and K19 INT8 decode
   attention, K10 row flush, K18 chunk write; K8 stacked-weight product,
   K11 fused decode layer, K12 mega2 layer with the next layer's attention;
   K25 Q8_0 product, its wgmma kernel at the admission's M 4096 and its
   decode kernel at M 8 (device time from a trace beside the event time),
   then its ragged edges; the f32 and bf16 forms of K6 (on the split
   tensor-core cells: bound by their passes' TF32 or bf16 operations, the
   f32 SIMT bound beside it), K7, K9, K19 and K10;
   the paged kernels K15 page scatter, K14 row flush, K13 and K20 decode
   attention, on a 33-page pool whose pages a ``PagePool`` handed out of
   order; the pool-direct admission's K17 chunk write and K16 chunk
   attention at a 16-slot admission wave's shapes, and K22 write-then-attend
   decode attention at K13's; the classifier's K1, K8, K11, K13 and K14
   also at batch 32, phase 4f's decode; the opt-in decodes' K26 mega3 pair
   and K27 mega layer, K28 decode row write on INT8, f32 and bf16 caches,
   and K29 resident-x W8A8 rows kernel at the admission's M 4096 and at M
   1000 and 2048, at every cluster size (1, 2, 4, 8), each with the bytes
   that leave L2 and their rate; the
   tensor-parallel decode's K21 write-then-attend decode attention, both
   forms on INT8, f32 and bf16 caches, K23 FFN span and K24 rmsnorm + quant
   + qkv span at the local shapes of tp 1, 2, 4 and 8)
   at the Llama-2 7B shapes of the serving paths, against its plain PyTorch
   version on the same inputs: K1, K2, K7, K8, K10, K11, K18, and K14 and
   K15 outside the trash page 0, exact; K3, K4 and K5 within
   QUANT_FLIPS / QUANT_SCALE_RTOL, K6 (on caches whose rows no query
   attends are poisoned), K9 and K19 within K6_TOL (K9, and K13 below,
   under the split rule's count and at one split, each against its plain
   version at that count, with the split cell's residency and the trace's
   device ms beside), K12's
   residual exact and its int8 outputs, scales and attention output within
   those limits (its trailing cells under their rule's count of splits,
   ``fused_splits``, and at one, K26 likewise, both with the trace's device
   ms beside; the attention output's int8 at more than one split within
   SPLIT_ATT_FLIPS), K13 and K20 within K6_TOL (K13 also bit-equal to K9 at
   block_s 256 and the same splits on a paged copy of its cache), K17
   exact outside page 0 (one slot's start past its table), K16 within
   K6_TOL and bit-equal to K6 on a dense copy of its keys, K22 within
   K6_TOL (K20 and K22, whole pages as the rounding block, under their
   rule's count of page runs and at one, as K13, with their cell's
   residency and the trace's device ms beside), K25 within K25_TOL, the fp
   forms of K6, K9 and K19 within FP_TOL with f32 queries (K6_TOL for K6's
   bf16 outputs beside them), K7's and K10's exact; the decode attention
   kernels (K9, K19, K12, K13, K20, K22, INT8 and fp) and K16 on caches
   whose rows at and past each slot's pos (for a pool, every row no slot or
   query attends) are poisoned; K26 also bit-equal to two chained K12
   launches and, layer by layer, within K12's limits of its plain version
   (each layer's plain version fed what the kernel's layer before left);
   K21 within K6_TOL (INT8) or FP_TOL (fp, f32 queries) on caches poisoned
   past each slot's pos (K19 and K21's single-pass form, the normalized
   cluster cell, under their rule's count of splits and at one, each with
   its blocks per SM and resident clusters and the trace's device ms beside
   SDPA's), K23 and K24 exact (the trace's device ms beside);
   K11 also by the trace's device ms; K27 (its cells under the split rule's
   count and at one, with the trace's device ms beside) with its attention
   output within K12's limits of its plain version at the same splits (one
   flipped int8 allowed, ``_att_reading``; SPLIT_ATT_FLIPS past one split),
   its linear outputs bit-equal to K11's phases on that output, and all of
   it bit-equal to K9 at the same splits, K2 and K11 launched in turn; K28
   (a slot at pos S, one parked at 0) and K29 (also bit-equal to K1, at
   every cluster size) exact; kernel,
   plain-version and
   PyTorch-library times
   (CUDA events) beside the bound (the larger of bytes / 3.35 TB/s and
   operations / the card's peak for their type);
4. the serving path at full 7B width and depth with random W8A8 weights in
   the fused wqkv / w13 layouts (``random_quant_params(fuse=True)``, as
   bench.py serves): ``Engine(max_batch=8, INT8 dense KV, seq_len=2048)``
   (decode attention "auto": K9 on the card; fused decode "auto": mega2,
   one K12 launch per layer) + ``ContinuousBatcher`` serving 10 requests
   (prompts in the 16..512 buckets, greedy and seeded temperature
   sampling); every request must finish with in-vocab tokens, and every
   kernel must launch exactly as often as the path requires (per admission
   group and layer: K3 twice, K4, K5 and K6 once; per decode step what
   ``decode_launches`` lists for the resolved mode), no plain version may
   run;
4j. ``serve_7b_http`` (right after phase 4, on its weights, its engine
   released), the text server: ``LlamaServer(port=0, warmup=True,
   warmup_max_bucket=512)`` over ``Engine(max_batch=8, kv_dtype="int8",
   seq_len=2048)`` with a 32000-entry byte tokenizer (``byte_tokenizer``):
   warmup's buckets [16 .. 512] and seconds, /healthz, one greedy /generate
   equal to a direct ``ContinuousBatcher`` run of its prompt on the same
   engine, 8 concurrent greedy requests with top-2 logprobs equal to their
   direct run but at near ties (PARITY_NEAR_TIE), a streamed request's
   pieces equal to the text, a device-sampled request, /metrics counting
   every request, phase 4's launch formula (``check_serve_launches``) and
   no plain version; tok/s and TTFT beside phase 4's;
4b. ``serve_7b_long``, the long-prompt path on phase 4's weights:
   ``ContinuousBatcher(max_chunk=16, prefix_cache_size=8)``; wave A, 8
   device-sampled requests of 1100-1950 prompt tokens, is one admission of
   8 x 2048 rows, prefilled in 8 chunks of 256 (K18 landing each fused
   chunk), then decode + sample chunks of up to 16 steps; wave B, after
   it, 4 prefix hits continued at start_pos > 0 in one ``prefill_continue``
   and 1 whole-prompt hit; every request must finish with in-vocab tokens,
   ``prefix_hits`` must be 5, every kernel must launch exactly as the path
   requires (``serve_7b_long`` writes the formula), no plain version may
   run;
4c. ``serve_7b_dense``, the JAX server's default model: random dense f32
   weights (``random_params``) fused as ``serve()`` fuses them,
   ``Engine(max_batch=8, seq_len=2048)`` with the default float32 cache,
   phase 4's 10 requests; 4d. ``serve_7b_q8``: those weights in Q8_0
   (``quantize_params``' default; the f32 ones freed first) with a bfloat16
   cache.  Every request must finish with in-vocab tokens, every kernel
   must launch exactly as the path requires (``serve_7b_fp`` writes the
   formula), no plain version may run;
4e. ``serve_7b_paged`` (run after 4b, on phase 4's weights), the paged
   INT8 path: ``Engine(max_batch=8, kv_layout="paged",
   page_size=512)`` (K13 and the two-launch K11 decode): phase 4's 10
   requests, whose streams must equal a dense-INT8 engine's with K9 at K13's
   block; 6 prefix hits on shared pages (boundary-page copies and a
   page-aligned prefix) with device sampling; a 7-page pool serving 8
   requests under backpressure; exact launch counts, no plain version, the
   pools back to every page free;
4f. ``serve_7b_paged_direct`` (after 4e, on phase 4's weights), the
   pool-direct paged admission: ``Engine(max_batch=32, kv_layout="paged",
   page_size=512, num_pages=97)``, 32 prompts of 600-1000 tokens arriving
   together (one 32 x 1024 admission, two waves of 16 slots), then 8
   device-sampled prompts of 1100-2000 tokens (8 x 2048, one wave): per
   admission 256 launches each of K16 and K17 and none of K15, a memory rise
   under a quarter of the compact block it avoids, exact launch counts, no
   plain version, every page free after retirement; both admissions again,
   bit-equal to the dense chunked prefill (K18 + K6) of the same prompts in
   their logits and every row of each slot's pages;
4g. ``serve_7b_mega`` (after 4f, on phase 4's weights), the opt-in fused
   decodes: ``Engine(fused="mega3")`` (K26, one launch per pair of layers),
   then ``Engine(fused="mega")`` (K27, the attention leading each layer's
   launch) and its reference, the two-launch decode (``fused=True``), each
   serving phase 4's 10 requests (with top-2 logprobs): mega3's greedy
   streams equal phase 4's mega2 streams token for token, mega's equal the
   two-launch decode's run with K9 at K27's splits (K27 is K9 at the same
   splits, K2 and K11 bit for bit); exact launch
   counts, no plain version; 4h. ``admission_k29``: one 8 x 512 admission with
   ``TPU_LLAMA_ROWS_RESIDENT=1`` (K29 for every product of 4096 rows), then
   the same with the switch restored (K1): logits and cache bit-equal;
4i. ``serve_7b_tp`` (after 4h, on phase 4's weights): the tensor-parallel
   serving path at full width and depth, ``parallel.launch.serve_card`` as
   one process on NCCL (tp = 1) and as two processes on the one card over
   gloo (tp = 2): ``Engine(mesh, tp_fused=True)`` + ``ContinuousBatcher``
   serving 4 greedy requests (the fused TP decode: K8, K9, K2, K23, K24,
   K10), the unfused TP decode on K21 (INT8, f32 and bf16 caches), a timed
   and a traced decode step; held to the single-device engine (tp = 1) and to
   tp = 1 (tp = 2), both ranks equal, exact launches per step; and a prefix
   hit (the TP continuation prefill) whose stream equals a cold admission's;
4k. ``serve_7b_mesh`` (after 4i, on phase 4's weights in the unfused
   layouts, INT8 cache, B 8): the sharded engine (``Engine(mesh)``, JAX's
   GSPMD program) on ranks driven from this process by
   ``parallel.launch.MeshEngine``, at tp = 1 (one NCCL rank) and tp = 2
   (two gloo ranks on the card): ``ContinuousBatcher`` here serves 4 greedy
   requests in two waves, the last a prefix hit, and the streams, the
   prefill's and first decode step's logits equal the single-device
   engine's bit for bit, every rank's logits equal (digests); at tp = 2 the
   row-sharded products run K1's int32 form, and ``LlamaServer`` over the
   controller answers 2 requests with the single-device server's text; a timed
   and a traced decode step per mesh, its launches held to
   ``mesh_step_launches``;
5. port parity: the same model cut to 2 layers serves one greedy request on
   the card (kernels) and on the CPU (plain versions) with the same explicit
   decode attention and fused decode, and the prefill attention "flash" on
   both sides (K6 and its plain version), on unfused weights once each "xla"
   (plain PyTorch on both sides), "flash" (K19) and "flash_dma" (K9), and
   on fused weights with "flash_dma" (the fused prefill, K3-K5) and each of
   the unfused, the two-launch (K8, K11 + K9), the mega2 (K8, K9, K12), the
   mega3 (K8, K9, K26) and the mega (K8, K27) decode, the card fed the
   CPU's picks: f32 activations (logits within LOGITS_TOL at all 8 steps,
   picks equal, on the fused layouts but at near ties, PARITY_NEAR_TIE)
   and bf16 activations (prefill logits within LOGITS_TOL);
   then, f32 and fused layouts, the long-prompt paths (``parity_long_paths``):
   the chunked prefill against the one-shot one, prefix reuse against a
   cold prefill, and the device sampler; the paged path (``parity_paged``:
   K13 and K20, unfused and two-launch decodes, pages of 16 rows, and a
   paged prefix continuation against a cold paged prefill); the pool-direct
   prefill (``parity_pool_direct``: B 2, T 1024, chunk 256, then 8 greedy
   decode steps, picks equal but at near ties, POOL_NEAR_TIE, and
   ``start0`` waves against the one-shot call on each side); then the same shape written as a llama2.c checkpoint and read back
   (``parity_checkpoint``): dense f32
   weights over f32 and bf16 caches and Q8_0 weights over a bf16 cache,
   card against CPU at ``precision="highest"``; that file then drives the
   text surface (``checkpoint_text_surface``): ``python3 -m
   tpu_llama_torch.cli ... --quant w8a8 --kv-dtype int8 -t 0 -n 24`` as a
   subprocess exits 0 with the text of an in-process greedy run on the
   engine that ``EngineConfig.build_engine`` builds for the same files, and
   the same files with a mesh of model 2 and unfused layouts build the
   sharded engine on two gloo ranks (``mesh_route``), whose greedy stream
   equals one device's;
6. a JSON line of the kernels (launches counted on the path that runs
   each: phase 4, phase 4b for K18, phase 4e for K13, K14 and K15, phase 4f
   for K16 and K17, phases 4c and 4d for K25 and the fp forms, phase 4g for
   K26 and K27, phase 4h for K29, phase 4i for K21 (and its fp forms), K23
   and K24, phase 4k for K1's int32 form (the tp = 2 rank 0's count), and
   phase 5 for a kernel that those do
   not run: K19, K11, K20, the fp forms of K19; K22 and K28, which no path
   calls, their counts summed over phases 4-4h, which must be 0), then the
   result line.
   Each phase prints its seconds.

Exits non-zero without a CUDA card and when run outside a checkout of the
repo (``tpu_llama_torch`` must be importable from beside this file).

``python3 chip_smoke.py --parity-seeds 1 2 3`` builds the kernels and runs
only phase 5's f32 greedy runs over those weight seeds (the readings behind
PARITY_NEAR_TIE and POOL_NEAR_TIE), and prints no result line.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
K6_TOL = 2.0 ** -7 + 1e-5  # of max |ref|: one bf16 rounding step + f32 noise
# Port parity, card against CPU, on the 2-layer 7B-width model (phase 5),
# both sides with the prefill attention "flash" (the CPU runs K6's plain
# version, the card's function; "auto" there would be JAX's f32 "xla"
# attention).  With f32 activations K1 and K2 are exact and K6 (and K16)
# round q and p * vs to bf16 where their plain versions do, over the same
# key tiles, so the logits differ only where a reordered f32 sum moves an
# activation across an int8 (or a rare bf16) rounding boundary.  Every
# step's logits must lie within LOGITS_TOL of max |logit| and the greedy
# picks agree as PARITY_NEAR_TIE below says.  With bf16
# activations a one-ulp difference in the residual stream moves about half
# of the affected int8 inputs: only the prefill logits are held to
# LOGITS_TOL there.  One moved int8 input of the classifier moves logits
# by up to ~3% of max |logit|.  Readings on an H100 with K6 in f32 (before
# its tensor-core cell): sound runs at most 2.95e-2 (f32) and 2.35e-2
# (bf16); a K6 whose causal bound admits one future key read 0.21 in both,
# and its f32 tokens differed from step 0.  So a bf16 run decodes
# PARITY_BF16_STEPS steps (their launches and finite logits checked): no
# check reads later ones.
PARITY_STEPS = 8
PARITY_BF16_STEPS = 1
LOGITS_TOL = 5e-2
# Phase 5 runs the card fed the CPU's picks, so every step compares the
# same inputs.  The picks must be equal where they held in every reading:
# the unfused layouts (xla, K19, K9: the logits agree to ~1e-6 of max
# |logit|) and the paged path.  On the fused layouts and the pool-direct
# prefill, where a flipped int8 of K3-K5 or K16 moves logits by up to ~3% of
# max |logit|, a pick may part from the CPU's at a near tie only: the CPU's
# gap between the two logits that swap at most PARITY_NEAR_TIE (the fused
# layouts' 16-token request) or POOL_NEAR_TIE (the pool-direct prefill's
# 1024-token prompts) of that row's max |logit|.  Before K6's tensor-core
# cell those picks too were held equal; its rounding changed the streams,
# which then met ties at step 4.  Readings over weight seeds 1-7 (``python3
# chip_smoke.py --parity-seeds 1 2 3 4 5 6 7``; H100 80GB HBM3, 700 W;
# PERF.md §6): the fused layouts parted in 10 of 35 runs, 16 partings at
# gaps of 1.8e-4 to 5.64e-3 of max |logit|; the pool-direct prefill in 4
# of 7, 6 partings at 2.3e-3 to 1.54e-2; the paged path in none of 14, the
# unfused layouts at seed 1 in none (logits ~1e-6 apart).  Each limit is
# 1.5x its group's largest reading.
PARITY_NEAR_TIE = 8.5e-3
POOL_NEAR_TIE = 2.3e-2
# Phase 4i's 2-layer TP parity: where the two sides' picks differ, the
# CPU's gap between the two logits that swapped may be at most
# TIE_ERR_RATIO of the rows' largest card-CPU logit error (a swap needs the
# gap within twice it).  Readings (H100 80GB HBM3, 700 W) over weight seeds
# 1-6 at tp 1 and 2 (tpu_llama_torch/tp_parity_seeds.py): 10 partings of
# 24 decodes at 0.12-0.63 of the error; the rule takes 1.6x the largest
# (its earlier rule allowed 2).
TIE_ERR_RATIO = 1.0
# K3, K4, K5 and K12's fresh K/V rows against their plain versions: the
# same f32 steps with round-to-nearest intrinsics, so equal unless K3's f64
# sum of squares lies on an f32 rounding boundary or CUDA's expf and
# PyTorch's sigmoid part: at most one int8 step on at most QUANT_FLIPS of
# the entries, scales within QUANT_SCALE_RTOL (two f32 ulps).  K12's
# attention output sums in another order (K9's), so its int8 is held to
# QUANT_FLIPS and its scales and dequantized values to K6_TOL.
QUANT_FLIPS = 1e-4
QUANT_SCALE_RTOL = 2.0 ** -22
# K12's and K26's attention outputs with the trailing cells at more than one
# split: each p rounds at its split's own max and the partials merge through
# more exps and sums, so more entries sit near an int8 rounding boundary.
# One step on at most this share of the entries (the card tests' share for
# K12 and K27; on an H100 the most seen was 4 of 32768, 1.2e-4, K26 at
# batch 8, 8 splits), scales and dequantized values as at one split.
SPLIT_ATT_FLIPS = 1e-3
# K25 against its plain version: the same bf16 products, exact in f32,
# summed in another order (f32 outputs): 1e-4 of max |ref|.
K25_TOL = 1e-4
# The fp forms of K6, K9 and K19 against their plain versions with f32
# queries and outputs, as the dense and Q8_0 paths run them: f32 dots
# (K6's as sums of exact products of split operands on the tensor cores,
# csrc/prefill_split.cuh), nothing rounded to bf16, sums in another order
# and exp as exp2: 1e-5 of max |ref|.  A kernel that rounded p or q to
# bf16 (the INT8 forms' arithmetic) misses by ~1e-3.  K6 with bf16 outputs
# is held to K6_TOL.
FP_TOL = 1e-5

SRC = {
    "K1": ("tpu_llama_torch/csrc/w8a8_matmul.cu", "tpu_llama/ops/matmul.py:483"),
    "K1:i32": ("tpu_llama_torch/csrc/w8a8_matmul.cu", "tpu_llama/ops/matmul.py:483"),
    "K2": ("tpu_llama_torch/csrc/quantize_rows.cu", "tpu_llama/ops/quant.py:275"),
    "K3": ("tpu_llama_torch/csrc/rmsnorm_quantize.cu", "tpu_llama/ops/quant.py:340"),
    "K4": ("tpu_llama_torch/csrc/silu_mul_quantize.cu", "tpu_llama/ops/quant.py:396"),
    "K5": ("tpu_llama_torch/csrc/rope_split_quantize.cu", "tpu_llama/ops/quant.py:476"),
    "K6": ("tpu_llama_torch/csrc/flash_prefill.cu", "tpu_llama/ops/attention.py:1654"),
    "K7": ("tpu_llama_torch/csrc/kv_scatter.cu", "tpu_llama/ops/attention.py:1212"),
    "K9": ("tpu_llama_torch/csrc/flash_decode_dma.cu", "tpu_llama/ops/attention.py:335"),
    "K10": ("tpu_llama_torch/csrc/kv_flush_rows.cu", "tpu_llama/ops/attention.py:2470"),
    "K18": ("tpu_llama_torch/csrc/kv_write_chunk.cu", "tpu_llama/ops/attention.py:2102"),
    "K19": ("tpu_llama_torch/csrc/flash_decode_fresh.cu", "tpu_llama/ops/attention.py:807"),
    "K8": ("tpu_llama_torch/csrc/w8a8_matmul.cu", "tpu_llama/ops/fused_layer.py:541"),
    "K11": ("tpu_llama_torch/csrc/fused_layer.cu", "tpu_llama/ops/fused_layer.py:204"),
    "K12": ("tpu_llama_torch/csrc/fused_step2.cu", "tpu_llama/ops/fused_step2.py:537"),
    "K25": ("tpu_llama_torch/csrc/q8_matmul.cu", "tpu_llama/ops/matmul.py:142"),
    "K13": ("tpu_llama_torch/csrc/paged_flash_decode_dma.cu", "tpu_llama/ops/attention.py:466"),
    "K14": ("tpu_llama_torch/csrc/kv_pool_flush_rows.cu", "tpu_llama/ops/attention.py:1301"),
    "K15": ("tpu_llama_torch/csrc/kv_pool_scatter.cu", "tpu_llama/ops/attention.py:1095"),
    "K20": ("tpu_llama_torch/csrc/paged_flash_decode_fresh.cu",
            "tpu_llama/ops/attention.py:1012"),
    "K16": ("tpu_llama_torch/csrc/paged_flash_prefill.cu", "tpu_llama/ops/attention.py:1990"),
    "K17": ("tpu_llama_torch/csrc/kv_pool_write_chunk.cu", "tpu_llama/ops/attention.py:2189"),
    "K22": ("tpu_llama_torch/csrc/paged_flash_decode.cu", "tpu_llama/ops/attention.py:933"),
    "K26": ("tpu_llama_torch/csrc/fused_step3.cu", "tpu_llama/ops/fused_step3.py:475"),
    "K27": ("tpu_llama_torch/csrc/fused_step.cu", "tpu_llama/ops/fused_step.py:313"),
    "K28": ("tpu_llama_torch/csrc/kv_write_decode.cu", "tpu_llama/ops/attention.py:2345"),
    "K29": ("tpu_llama_torch/csrc/w8a8_rows_resident.cu", "tpu_llama/ops/matmul.py:314"),
    "K21": ("tpu_llama_torch/csrc/flash_decode.cu", "tpu_llama/ops/attention.py:616"),
    "K23": ("tpu_llama_torch/csrc/fused_ffn.cu", "tpu_llama/ops/fused_layer.py:376"),
    "K24": ("tpu_llama_torch/csrc/fused_rms_qkv.cu", "tpu_llama/ops/fused_layer.py:488"),
}
SRC.update({f"{k}:{sfx}": SRC[k] for k in ("K6", "K7", "K9", "K10", "K19", "K21", "K28")
            for sfx in ("f32", "bf16")})  # one templated kernel per INT8 and fp form
# K22 and K28 are on no path: the port calls neither, and the JAX package
# only from a benchmark tool (phase 3 and the card tests run them).  Their
# launches in the kernels line are those that phases 4-4h counted, and the
# run fails unless they are 0.
NO_PATH = {"K22", "K28", "K28:f32", "K28:bf16"}
DECODE_KERNEL = {"flash_dma": "K9", "flash": "K19"}  # decode attention -> its kernel
PAGED_KERNEL = {"flash_dma": "K13", "flash": "K20"}  # ... on a paged cache
PREFILL_PATH = {"K1", "K2", "K6", "K7"}  # what an admission launches; "xla" decode adds none
FUSED_PREFILL_PATH = PREFILL_PATH | {"K3", "K4", "K5"}  # ... on fused layouts
DECODE_POS = [0, 1, 127, 128, 511, 1000, 1900, 2047]  # one per slot at batch 8
# ... at batch 32, phase 4f's decode: DECODE_POS, then 24 drawn from a seed
DECODE_POS32 = DECODE_POS + [int(p) for p in np.random.default_rng(32).integers(0, 2048, 24)]
CARD = "cuda"  # the card side of the parity phases


def decode_launches(fused, attn: str, L: int, paged: bool = False) -> dict:
    """Kernel launches per decode step of ``forward_decode`` in each
    resolved mode: the unfused stack (K2 + K1 per matmul, 4 per layer on
    fused layouts), the two-launch stack (prologue K3 + K8, per layer the
    attention, K2 and K11) and mega2 (prologue K3, K8, K9, K2, then one
    K12 per layer), mega3 (mega2's prologue, then one K26 per pair of
    layers) and mega (prologue K3 + K8, then one K27 per layer); each with
    one K10 flush and the classifier's K2 + K1.  On a paged cache the
    attention is K13 (K20 for "flash") and the flush K14; mega2, mega3 and
    mega never run there."""
    att, flush = (PAGED_KERNEL[attn], "K14") if paged else (DECODE_KERNEL[attn], "K10")
    if fused == "mega2":
        return {"K3": 1, "K8": 1, "K9": 1, "K2": 2, "K12": L, "K10": 1, "K1": 1}
    if fused == "mega3":
        return {"K3": 1, "K8": 1, "K9": 1, "K2": 2, "K26": L // 2, "K10": 1, "K1": 1}
    if fused == "mega":
        return {"K3": 1, "K8": 1, "K27": L, "K2": 1, "K10": 1, "K1": 1}
    if fused:
        return {"K3": 1, "K8": 1, att: L, "K2": L + 1, "K11": L, flush: 1, "K1": 1}
    return {att: L, "K2": 4 * L + 1, "K1": 4 * L + 1, flush: 1}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn(i)`` over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_launch_us(torch, n: int = 2000) -> float:
    """Host microseconds to launch one tiny kernel (an add on 8 floats),
    over ``n`` launches after a warm-up: the host speed that a decode step
    bound by its launches follows.  Hosts of one-card machines differ and
    are shared, so each serving phase reads it beside its step time."""
    x = torch.zeros(8, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def n_copies(nbytes: float) -> int:
    """Input copies to rotate through so that repeated calls find them cold
    in the 50 MB L2, as the serving path does."""
    return int(min(8, max(1, math.ceil(2 * 50e6 / nbytes))))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the 7B shapes
# ---------------------------------------------------------------------------


def int8_peak_share(m: int, k: int, n: int, ms: float) -> float:
    """The share of the card's int8 tensor-core peak that an M x K x N
    product run in ``ms`` reaches."""
    return 2 * m * k * n / PEAK_OPS_S["int8"] / (ms * 1e-3)


def check_k1(torch, tq, tm, results):
    """K1 at M 8 (decode) and 4096 (the 8 x 512 admission) on the unfused
    and the fused (wqkv 4096 -> 12288, w13 4096 -> 22016) shapes, then its
    residual epilogue on wo and w2 at M 4096, then the classifier at M 16
    and 32 (phase 4f's admission waves and decode), then the fused layer's
    products at M 1000 (a prefix continuation) and 2048 (a 256-row chunk of
    8 slots); bf16 out, bit-equal.  Every row above 16 rows reads its share
    of the int8 peak."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(m, k, n, False) for m in (8, 4096)
             for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                          (4096, 12288), (4096, 22016))]
    cases += [(4096, 4096, 4096, True), (4096, 11008, 4096, True)]
    # the classifier of phase 4f: a 16-slot admission wave's rows, and the
    # 32-slot decode (M 32: the wgmma kernel's 128-row tile, partly filled)
    cases += [(16, 4096, 32000, False), (32, 4096, 32000, False)]
    cases += [(m, k, n, res) for m in (1000, 2048)
              for k, n, res in ((4096, 12288, False), (4096, 4096, True), (4096, 22016, False),
                                (11008, 4096, True))]
    for m, k, n, with_res in cases:
        copies = n_copies(n * k)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.05
        ws = [tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                            dtype=torch.int8),
            s=torch.full((n,), 2e-4, device="cuda")) for _ in range(copies)]
        res = (torch.randn(m, n, generator=gen, device="cuda") * 4).to(torch.bfloat16) \
            if with_res else None
        got = tm.w8a8_matmul_prequant(xq, sx, ws[0], out_dtype=torch.bfloat16, residual=res)
        torch.cuda.synchronize()
        want = tm.w8a8_matmul_prequant_plain(xq, sx, ws[0], out_dtype=torch.bfloat16,
                                             residual=res)
        err = (got.float() - want.float()).abs().max().item()
        label = f"K1 w8a8_matmul M={m} K={k} N={n}" + (" +residual" if with_res else "")
        check(torch.equal(got, want), f"{label}: max err {err}")
        ms = cuda_ms(torch, lambda i: tm.w8a8_matmul_prequant(
            xq, sx, ws[i % copies], out_dtype=torch.bfloat16, residual=res), 20 if m > 8 else 50)
        plain_ms = cuda_ms(torch, lambda i: tm.w8a8_matmul_prequant_plain(
            xq, sx, ws[i % copies], out_dtype=torch.bfloat16, residual=res), 3, warmup=1)
        # torch._int_mm wants more than 16 rows: the library call gets
        # the decode rows padded to 32
        xl = torch.nn.functional.pad(xq, (0, 0, 0, max(0, 32 - m)))
        sxl = torch.nn.functional.pad(sx, (0, max(0, 32 - m)))

        def lib(i):
            w = ws[i % copies]
            acc = torch._int_mm(xl, w.q.t())
            out = (acc.float() * sxl[:, None] * w.s[None, :]).to(torch.bfloat16)
            return out if res is None else res + out

        try:
            library_ms = cuda_ms(torch, lib, 20 if m > 8 else 50)
        except RuntimeError as e:  # an _int_mm shape this build refuses
            print(f"K1 library call unavailable: {e}", file=sys.stderr)
            library_ms = None
        nbytes = m * k + 4 * m + n * k + 4 * n + 2 * m * n * (2 if with_res else 1)
        b_ms, by = bound_ms(nbytes, 2 * m * k * n, "int8")
        results.append(dict(kernel="K1", name=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                            library_ms=library_ms, int8_peak_share=int8_peak_share(m, k, n, ms),
                            form=tm.w8a8_plan(m, k, n).form))
        del ws, xq, got, want, res
    torch.cuda.empty_cache()


def check_k1_int32(torch, tq, tm, results):
    """K1's int32 form at the K-slices a tp = 2 rank of the sharded engine
    runs at 7B: wo (K 2048) and w2 (K 5504) into 4096 columns, at M 8 (the
    decode tile) and M 1024 (the wgmma form: an admission's rows); exact
    against its plain version.  Then two K-slices' sums (the two ranks'),
    added and passed through ``w8a8_epilogue`` with a bf16 residual, against
    K1 on the whole K with its residual epilogue: bit for bit.  The library
    call is ``torch._int_mm`` (rows padded to 32 below 17)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for m, k, n in ((8, 2048, 4096), (8, 5504, 4096), (1024, 2048, 4096), (1024, 5504, 4096)):
        copies = n_copies(n * k)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        ws = [tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8),
            s=torch.full((n,), 2e-4, device="cuda")) for _ in range(copies)]
        got = tm.w8a8_matmul_int32(xq, ws[0])
        torch.cuda.synchronize()
        want = tm.w8a8_matmul_int32_plain(xq, ws[0])
        err = (got.double() - want.double()).abs().max().item()
        label = f"K1:i32 w8a8_matmul_int32 M={m} K={k} N={n}"
        check(torch.equal(got, want), f"{label}: max err {err}")
        # the two ranks' slices of the whole K, their sums all-reduced, then
        # the epilogue: K1 on the whole K
        x2 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w2 = tq.ChannelQuantTensor(q=torch.randint(-127, 128, (n, k), generator=gen,
                                                   device="cuda", dtype=torch.int8), s=ws[0].s)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.05
        res = (torch.randn(m, n, generator=gen, device="cuda") * 4).to(torch.bfloat16)
        whole = tq.ChannelQuantTensor(q=torch.cat([ws[0].q, w2.q], dim=1), s=ws[0].s)
        acc = got + tm.w8a8_matmul_int32(x2, w2)
        summed = tm.w8a8_epilogue(acc, sx, ws[0].s, torch.bfloat16, res)
        k1 = tm.w8a8_matmul_prequant(torch.cat([xq, x2], dim=1), sx, whole,
                                     out_dtype=torch.bfloat16, residual=res)
        torch.cuda.synchronize()
        check(torch.equal(summed, k1), f"{label}: two slices' sums through the epilogue differ "
                                       f"from K1 on the whole K by "
                                       f"{(summed.float() - k1.float()).abs().max().item()}")
        ms = cuda_ms(torch, lambda i: tm.w8a8_matmul_int32(xq, ws[i % copies]),
                     20 if m > 8 else 50)
        plain_ms = cuda_ms(torch, lambda i: tm.w8a8_matmul_int32_plain(xq, ws[i % copies]), 3,
                           warmup=1)
        xl = torch.nn.functional.pad(xq, (0, 0, 0, max(0, 32 - m)))
        try:
            library_ms = cuda_ms(torch, lambda i: torch._int_mm(xl, ws[i % copies].q.t()),
                                 20 if m > 8 else 50)
        except RuntimeError as e:  # an _int_mm shape this build refuses
            print(f"K1:i32 library call unavailable: {e}", file=sys.stderr)
            library_ms = None
        b_ms, by = bound_ms(m * k + n * k + 4 * m * n, 2 * m * k * n, "int8")
        results.append(dict(kernel="K1:i32", name=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                            library_ms=library_ms, int8_peak_share=int8_peak_share(m, k, n, ms),
                            form=tm.w8a8_plan(m, k, n).form))
        del ws, xq, x2, w2, whole, got, want, acc, summed, k1
    torch.cuda.empty_cache()


def _quant_reading(torch, label, pairs):
    """Holds kernel (q, s) pairs to their plain versions within QUANT_FLIPS
    and QUANT_SCALE_RTOL; returns (max |difference| of int8 steps and
    scales, share of int8 entries that differ, max relative scale error)."""
    err, flips, n, s_rel = 0.0, 0, 0, 0.0
    for (q, s), (qp, sp) in pairs:
        d = (q.int() - qp.int()).abs()
        rel = ((s - sp).abs() / sp.abs().clamp_min(1e-30)).max().item()
        err = max(err, d.max().item(), (s - sp).abs().max().item())
        flips += int((d != 0).sum().item())
        n += d.numel()
        s_rel = max(s_rel, rel)
        check(d.max().item() <= 1, f"{label}: an int8 differs by {d.max().item()} steps")
    check(flips <= QUANT_FLIPS * n and s_rel <= QUANT_SCALE_RTOL,
          f"{label}: {flips} of {n} int8 differ, scales by up to {s_rel} (limits "
          f"{QUANT_FLIPS}, {QUANT_SCALE_RTOL})")
    return err, flips / n, s_rel


def _quant_result(kernel, label, reading, ms, plain_ms, nbytes, ops):
    b_ms, by = bound_ms(nbytes, ops, "f32")
    err, share, s_rel = reading
    return dict(kernel=kernel, name=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=None, int8_flip_share=share,
                scale_max_rel_err=s_rel)


def check_k3(torch, tq, results):
    """K3 as the main path runs it: the 8 x 512 admission's rows, bf16 x
    [4096, 4096] with bf16 w; a 256-row chunk of 8 slots, bf16 [2048,
    4096]; a decode step's 8 rows, bf16 [8, 4096], and as mega2's prologue
    runs them, f32 x [8, 4096] (the f32 embedding rows) with bf16 w.  w is
    random around 1 (the served weights' norms are not all ones).  Trace
    device ms beside the events, as K2's."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 4096
    w = (1 + 0.2 * torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
    for m, dt in ((4096, "bf16"), (2048, "bf16"), (8, "bf16"), (8, "f32")):
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        eb = torch.empty(0, dtype=dtype).element_size()
        copies = n_copies(eb * m * n)
        xs = [(torch.randn(m, n, generator=gen, device="cuda") * 2).to(dtype)
              for _ in range(copies)]
        label = f"K3 rmsnorm_quantize {dt} [{m}, {n}], bf16 w"
        got = tq.rmsnorm_quantize(xs[0], w)
        torch.cuda.synchronize()
        reading = _quant_reading(torch, label, [(got, tq.rmsnorm_quantize_plain(xs[0], w))])

        def run(i, xs=xs, copies=copies):
            return tq.rmsnorm_quantize(xs[i % copies], w)

        ms = cuda_ms(torch, run, 50)
        plain_ms = cuda_ms(torch, lambda i: tq.rmsnorm_quantize_plain(xs[i % copies], w), 10)
        # ~6 f32 operations per element: square-add, two products, abs-max, scale, round
        results.append(dict(_quant_result("K3", label, reading, ms, plain_ms,
                                          eb * m * n + 2 * n + m * n + 4 * m, 6 * m * n),
                            device_ms=device_ms(torch, run)))
        del xs


def check_k4(torch, tq, results):
    """K4 on the column halves of the w13 product bf16 [4096, 22016]."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    m, h = 4096, 11008
    gus = [(torch.randn(m, 2 * h, generator=gen, device="cuda") * 3).to(torch.bfloat16)
           for _ in range(n_copies(4 * m * h))]
    copies = len(gus)
    label = f"K4 silu_mul_quantize bf16 halves of [{m}, {2 * h}]"

    def run(i, fn=tq.silu_mul_quantize):
        gu = gus[i % copies]
        return fn(gu[:, :h], gu[:, h:])

    got = run(0)
    torch.cuda.synchronize()
    reading = _quant_reading(torch, label, [(got, run(0, tq.silu_mul_quantize_plain))])
    ms = cuda_ms(torch, run, 50)
    plain_ms = cuda_ms(torch, lambda i: run(i, tq.silu_mul_quantize_plain), 5)
    # ~10 f32 operations per element: exp, add, reciprocal, two products,
    # abs-max, scale, round
    results.append(_quant_result("K4", label, reading, ms, plain_ms,
                                 2 * 2 * m * h + m * h + 4 * m, 10 * m * h))
    del gus


def check_k5(torch, tq, results):
    """K5 at the admission's shape: qkv bf16 [4096, 12288] (32 + 2 x 32
    heads of 128), cos/sin [4096, 64], K/V written head-major into a layer's
    block of the compact cache [8, 32, 512, 128], as the fused prefill does."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, T, NH, KVH, hd = 8, 512, 32, 32, 128
    M, D, KVD = B * T, NH * hd, KVH * hd
    copies = n_copies(2 * M * (D + 2 * KVD))
    qkvs = [(torch.randn(M, D + 2 * KVD, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            for _ in range(copies)]
    ang = torch.arange(T, device="cuda", dtype=torch.float32)[:, None] * \
        (10000.0 ** (-torch.arange(0, hd, 2, device="cuda", dtype=torch.float32) / hd))
    cos, sin = ang.cos().repeat(B, 1), ang.sin().repeat(B, 1)

    def cache():
        return [torch.zeros(B, KVH, T, *d, dtype=t, device="cuda")
                for t, d in [(torch.int8, (hd,)), (torch.float32, ())] * 2]  # k, ks, v, vs

    blocks, blocks_p = cache(), cache()
    outs, outs_p = ([b.transpose(1, 2) for b in bl] for bl in (blocks, blocks_p))

    def run(i, fn=tq.rope_split_quantize, out=outs):
        return fn(qkvs[i % copies], cos, sin, D, KVH, hd, out=out)

    got = run(0)
    torch.cuda.synchronize()
    want = run(0, tq.rope_split_quantize_plain, outs_p)
    label = f"K5 rope_split_quantize bf16 M={M} heads {NH}+{KVH}+{KVH} into the cache"
    check(torch.equal(got[0], want[0]), f"{label}: roped q differs")
    reading = _quant_reading(torch, label, [((got[1], got[2]), (want[1], want[2])),
                                            ((got[3], got[4]), (want[3], want[4]))])
    ms = cuda_ms(torch, run, 50)
    plain_ms = cuda_ms(torch, lambda i: run(i, tq.rope_split_quantize_plain, outs_p), 5)
    nbytes = 2 * M * (D + 2 * KVD) + 2 * 4 * M * hd // 2 + 2 * M * D + 2 * M * KVD + 2 * 4 * M * KVH
    # ~8 f32 operations per element: the rotation's 4 products and 2 sums,
    # abs-max, round (v: 3)
    results.append(_quant_result("K5", label, reading, ms, plain_ms, nbytes,
                                 8 * M * (D + KVD) + 3 * M * KVD))
    del qkvs, blocks, blocks_p


def check_k2(torch, tq, results):
    """K2 on the admission's wo input bf16 [4096, 4096] and the unfused
    w2 input [4096, 11008], a 256-row chunk of 8 slots [2048, 4096], a
    decode step's 8 rows bf16 [8, 4096], and as mega2 runs it (its two
    launches a step on the f32 attention rows) f32 [8, 4096]; bit-equal.
    Each row's trace device ms beside its events (which, on a slow host,
    read the wrapper's launch path at these shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for m, n, dt in ((4096, 4096, "bf16"), (4096, 11008, "bf16"), (2048, 4096, "bf16"),
                     (8, 4096, "bf16"), (8, 4096, "f32")):
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        eb = torch.empty(0, dtype=dtype).element_size()
        copies = n_copies(eb * m * n)
        xs = [torch.randn(m, n, generator=gen, device="cuda").mul_(2).to(dtype)
              for _ in range(copies)]
        label = f"K2 quantize_rows {dt} [{m}, {n}]"
        q, s = tq.quantize_activations(xs[0])
        torch.cuda.synchronize()
        qp, sp = tq.quantize_activations_plain(xs[0])
        err = max((q.int() - qp.int()).abs().max().item(), (s - sp).abs().max().item())
        check(torch.equal(q, qp) and torch.equal(s, sp), f"{label}: max err {err}")

        def run(i, xs=xs, copies=copies):
            return tq.quantize_activations(xs[i % copies])

        ms = cuda_ms(torch, run, 50)
        plain_ms = cuda_ms(torch, lambda i: tq.quantize_activations_plain(xs[i % copies]),
                           10)
        b_ms, by = bound_ms(eb * m * n + m * n + 4 * m, 4 * m * n, "f32")
        results.append(dict(kernel="K2", name=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=by, library_ms=None,
                            device_ms=device_ms(torch, run)))
        del xs


def _k6_inputs(torch, gen, B, T, NH, KVH, S, hd):
    q = torch.randn(B, T, NH, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randint(-127, 128, (B, KVH, S, hd), generator=gen, device="cuda",
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, KVH, S, hd), generator=gen, device="cuda",
                      dtype=torch.int8)
    ks = torch.rand(B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
    vs = torch.rand(B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
    return q, k, v, ks, vs


def check_k6(torch, tatt, results):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    # (B, T, NH, KVH, S, hd, start): the 7B admission shape, then a chunk
    # continuing at start > 0 in a 2048-row cache
    for B, T, NH, KVH, S, hd, start in ((8, 512, 32, 32, 512, 128, [0] * 8),
                                        (2, 128, 32, 32, 2048, 128, [600, 1900])):
        st = torch.tensor(start, dtype=torch.int32, device="cuda")
        in_bytes = B * T * NH * hd * 2 + 2 * B * KVH * S * (hd + 4)
        copies = n_copies(in_bytes)
        ins = [_k6_inputs(torch, gen, B, T, NH, KVH, S, hd) for _ in range(copies)]
        for arrs in ins:  # poison the cache rows no query attends
            for b, s0 in enumerate(start):
                for a, val in zip(arrs[1:], (127, 127, 1e4, 1e4)):
                    a[b, :, s0 + T:] = val

        def run(i, fn=tatt.flash_prefill_attention):
            q, k, v, ks, vs = ins[i % copies]
            return fn(q, k, v, st, ks, vs, out_dtype=torch.bfloat16)

        got = run(0)
        torch.cuda.synchronize()
        want = run(0, tatt.flash_prefill_attention_plain)
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        check(err <= K6_TOL * peak, f"K6 B={B} T={T} start={start[:2]}: err {err} > "
                                    f"{K6_TOL} * {peak}")
        ms = cuda_ms(torch, run, 20)
        plain_ms = cuda_ms(torch, lambda i: run(i, tatt.flash_prefill_attention_plain), 5)
        # the library call: SDPA on the dequantized bf16 cache (NH == KVH
        # here), causal when the chunk is the whole cache from position 0,
        # else with the mask s <= start[b] + t
        deq = [(q.transpose(1, 2), (k.float() * ks[..., None]).to(torch.bfloat16),
                (v.float() * vs[..., None]).to(torch.bfloat16)) for q, k, v, ks, vs in ins]
        if T == S and not any(start):
            mask = None
        else:
            t_pos = st[:, None, None, None] + torch.arange(T, device="cuda")[None, None, :, None]
            mask = torch.arange(S, device="cuda")[None, None, None, :] <= t_pos
        library_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            *deq[i % copies], attn_mask=mask, is_causal=mask is None), 20)
        del deq, mask
        keys = sum(min(S, s + t + 1) for s in start for t in range(T))  # attended pairs / head
        used = sum(min(S, s + T) for s in start)  # key rows read per kv head
        nbytes = B * T * NH * hd * 2 * 2 + 2 * KVH * used * (hd + 4) + 4 * B
        b_ms, by = bound_ms(nbytes, 4 * hd * NH * keys, "bf16")
        results.append(dict(kernel="K6", name=f"K6 flash_prefill B={B} T={T} S={S} "
                            f"start={'0' if not any(start) else '>0'}",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=by, library_ms=library_ms))
        del ins, got, want


def check_k7(torch, tatt, results):
    gen = torch.Generator(device="cuda").manual_seed(7)
    L, n, KVH, T, hd, B, S = 32, 8, 32, 512, 128, 8, 2048

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    small = (ri(L, n, KVH, T, hd), ri(L, n, KVH, T, hd),
             torch.rand(L, n, KVH, T, generator=gen, device="cuda"),
             torch.rand(L, n, KVH, T, generator=gen, device="cuda"))
    cache = [torch.zeros(L, B, KVH, S, hd, dtype=torch.int8, device="cuda"),
             torch.zeros(L, B, KVH, S, hd, dtype=torch.int8, device="cuda"),
             torch.zeros(L, B, KVH, S, device="cuda"),
             torch.zeros(L, B, KVH, S, device="cuda")]
    slots = [5, 0, 7, 2, 1, 6, 3, 4]
    sl = torch.tensor(slots, device="cuda")

    def run(i):
        tatt.kv_cache_scatter_slots(small[0], small[1], slots, cache[0], cache[1], small[2],
                                    small[3], cache[2], cache[3])

    run(0)
    torch.cuda.synchronize()
    ref = [torch.zeros_like(c) for c in cache]
    tatt.kv_cache_scatter_slots_plain(small[0], small[1], slots, ref[0], ref[1], small[2],
                                      small[3], ref[2], ref[3])
    check(all(torch.equal(a, b) for a, b in zip(cache, ref)), "K7: cache differs")
    del ref
    ms = cuda_ms(torch, run, 20)
    plain_ms = cuda_ms(torch, lambda i: tatt.kv_cache_scatter_slots_plain(
        small[0], small[1], slots, cache[0], cache[1], small[2], small[3], cache[2],
        cache[3]), 5)

    def lib(i):
        for c, s in zip(cache, small):
            c[:, sl, :, :T] = s

    library_ms = cuda_ms(torch, lib, 5)
    b_ms, by = bound_ms(2 * (2 * L * n * KVH * T * hd + 2 * L * n * KVH * T * 4), 0, "int8")
    results.append(dict(kernel="K7", name=f"K7 kv_scatter L={L} n={n} T={T} S={S}",
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=by, library_ms=library_ms))


def _sdpa_ms(torch, q, k, v, ks, vs, nk, nv, nks, nvs, pos, layers, copies, device=False):
    """The library yardstick of K9 and K19: scaled_dot_product_attention on
    the dequantized bf16 cache with the fresh row written in place at pos
    and a boolean mask s <= pos; with ``device``, (event ms, device ms from
    a trace)."""
    import torch.nn.functional as F

    B, KVH, G, hd = q[0].shape
    S = k.shape[3]
    b_ix = torch.arange(B, device="cuda")
    deq = []
    for i in range(copies):
        kd = k[layers[i]].float() * ks[layers[i]][..., None]
        vd = v[layers[i]].float() * vs[layers[i]][..., None]
        kd[b_ix, :, pos.long()] = nk[i].float() * nks[i][..., None]
        vd[b_ix, :, pos.long()] = nv[i].float() * nvs[i][..., None]
        deq.append((q[i].reshape(B, KVH * G, 1, hd), kd.to(torch.bfloat16),
                    vd.to(torch.bfloat16)))
        del kd, vd
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    kw = dict(enable_gqa=True) if G > 1 else {}

    def lib(i):
        return F.scaled_dot_product_attention(*deq[i % copies], attn_mask=mask, **kw)

    try:
        ms = cuda_ms(torch, lib, 50)
        return (ms, device_ms(torch, lib, 20)) if device else ms
    except (TypeError, RuntimeError) as e:  # a GQA call this build refuses
        print(f"decode attention library call unavailable: {e}", file=sys.stderr)
        return (None, None) if device else None


def _poison(k, v, ks, vs, pos):
    """Every INT8 cache row at and past each slot's pos set to 127 with
    scale 1e4 (all layers): a kernel that read one stale row would miss its
    plain version by orders of magnitude, not by a fraction of a limit."""
    for b, p in enumerate(pos):
        for a, val in ((k, 127), (v, 127), (ks, 1e4), (vs, 1e4)):
            a[:, b, :, p:] = val


def split_variants(tatt, B: int, KVH: int, ts: int, rows_max: int) -> list[int]:
    """The splits K9 and K13 are held and timed at: the rule's, and one
    (the sequential walk) where the rule splits."""
    n = tatt.decode_splits(B, KVH, ts, rows_max)
    return [n, 1] if n > 1 else [1]


def page_variants(tatt, q, k_pool, page_table) -> list[int]:
    """The splits K20 and K22 are held and timed at: the rule's (runs of
    whole pages, ``page_splits``), and one where the rule splits."""
    n = tatt.page_splits(q, k_pool, page_table, None)
    return [n, 1] if n > 1 else [1]


def page_residency(_kernels, tatt, kernel: str, G: int, hd: int, ps: int) -> dict:
    """The page-block cell's blocks per SM, ring tiles (of K13's block rows,
    ``_paged_block``) and shared memory bytes at a launch's shapes (CUDA's
    occupancy query)."""
    ts = tatt._paged_block(ps)
    blocks, tiles, nbytes = _kernels.page_split_residency(kernel, G, hd, ts, ps)
    return dict(resident_blocks=blocks, ring_tiles=tiles, ring_rows=ts, smem_bytes=nbytes)


def split_residency(_kernels, kv_dtype, G: int, hd: int, ts: int) -> dict:
    """The split cell's blocks per SM, ring tiles and shared memory bytes
    at a launch's shapes (CUDA's occupancy query)."""
    blocks, tiles, nbytes = _kernels.decode_split_residency(kv_dtype, G, hd, ts)
    return dict(resident_blocks=blocks, ring_tiles=tiles, smem_bytes=nbytes)


def norm_variants(tatt, B: int, KVH: int, ts: int, S: int) -> list[int]:
    """The splits K19 and K21's single-pass form are held and timed at: the
    rule's (``norm_splits``, one thread-block cluster), and one where the
    rule splits."""
    n = tatt.norm_splits(B, KVH, ts, S)
    return [n, 1] if n > 1 else [1]


def norm_residency(_kernels, kernel: str, kv_dtype, G: int, hd: int, S: int, ts: int,
                   splits: int) -> dict:
    """The normalized cluster cell's blocks per SM, ring tiles, shared
    memory bytes and resident clusters of ``splits`` blocks at a launch's
    shapes (CUDA's occupancy queries)."""
    blocks, tiles, nbytes, clusters = _kernels.norm_split_residency(kernel, kv_dtype, G, hd, S,
                                                                    ts, splits)
    return dict(resident_blocks=blocks, ring_tiles=tiles, smem_bytes=nbytes,
                resident_clusters=clusters)


def check_decode_attention(torch, tatt, results):
    """K9 and K19 on the same inputs: a 32-layer 2048-row cache, layer 17,
    at batch 8 (one slot at each of DECODE_POS; MHA and a GQA group of 4)
    and at batch 1, the rows at and past each pos poisoned (``_poison``);
    K9 and K19 under their split rules' counts (``decode_splits``,
    ``norm_splits``) and, where that is more than one, at one split, each
    against its plain version at the same splits.
    Repeated calls rotate through other layers of the cache and other
    queries, so they find the rows cold in L2."""
    from tpu_llama_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(9)
    L, S, hd, layer = 32, 2048, 128, 17

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rs(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.03 + 0.01

    for B, KVH, G, pos in ((8, 32, 1, DECODE_POS), (8, 8, 4, DECODE_POS), (1, 32, 1, [511]),
                           (1, 32, 1, [2047])):
        k, v, ks, vs = ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rs(L, B, KVH, S), \
            rs(L, B, KVH, S)
        _poison(k, v, ks, vs, pos)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rows = KVH * sum(pos)  # cache rows the function reads
        copies = n_copies(rows * (2 * hd + 8))
        layers = [(layer + i) % L for i in range(copies)]
        q = [torch.randn(B, KVH, G, hd, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(copies)]
        nk = [ri(B, KVH, hd) for _ in range(copies)]
        nv = [ri(B, KVH, hd) for _ in range(copies)]
        nks = [rs(B, KVH) for _ in range(copies)]
        nvs = [rs(B, KVH) for _ in range(copies)]
        library_ms, library_dev = _sdpa_ms(torch, q, k, v, ks, vs, nk, nv, nks, nvs, pt, layers,
                                           copies, device=True)
        torch.cuda.empty_cache()
        nbytes = (rows * (2 * hd + 8) + B * KVH * G * hd * (2 + 4) + B * KVH * (2 * hd + 8)
                  + 4 * B)
        ops = 4 * hd * G * (rows + B * KVH)  # the QK and PV dots, fresh column included
        b_ms, by = bound_ms(nbytes, ops, "bf16")
        res = split_residency(_kernels, torch.int8, G, hd, 128)
        for kernel, name, n in [("K9", "dma", n) for n in split_variants(tatt, B, KVH, 128, S)] \
                + [("K19", "fresh", n) for n in norm_variants(tatt, B, KVH, 128, S)]:
            fn = getattr(tatt, f"flash_decode_attention_{name}")
            plain = getattr(tatt, f"flash_decode_attention_{name}_plain")
            kw = dict(splits=n)

            def run(i, f=fn):
                j = i % copies
                return f(q[j], k, v, pt, nk[j], nv[j], ks, vs, nks[j], nvs[j], layer=layers[j],
                         **kw)

            got = run(0)
            torch.cuda.synchronize()
            want = run(0, plain)
            err = (got - want).abs().max().item()
            peak = want.abs().max().item()
            label = f"{kernel} {name} B={B} KVH={KVH} G={G} pos={pos[0] if B == 1 else 'mix'}" \
                f" splits={n}"
            check(err <= K6_TOL * peak, f"{label}: err {err} > {K6_TOL} * {peak}")
            ms = cuda_ms(torch, run, 50)
            plain_ms = cuda_ms(torch, lambda i: run(i, plain), 5)
            cell = res if kernel == "K9" else norm_residency(_kernels, "K19", torch.int8, G, hd,
                                                             S, 128, n)
            extra = dict(splits=n, **cell, device_ms=device_ms(torch, run),
                         library_device_ms=library_dev)
            print(f"  {label}: {ms:.4f} ms (SDPA {library_ms}, bound {b_ms:.4f}) {extra}",
                  flush=True)
            results.append(dict(kernel=kernel, name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, **extra))
        del k, v, ks, vs
        torch.cuda.empty_cache()


def check_k10(torch, tatt, results):
    """K10 at the 7B step shape, bit-equal to its plain version; the slot at
    pos S must come out untouched."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    L, B, KVH, S, hd = 32, 8, 32, 2048, 128
    pos = [0, 1, 127, 128, 511, 1000, S, 2047]

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rf(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    cache = [ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rf(L, B, KVH, S), rf(L, B, KVH, S)]
    copies = n_copies(L * B * KVH * (2 * hd + 8))
    rows = [(ri(L, B, KVH, hd), ri(L, B, KVH, hd), rf(L, B, KVH), rf(L, B, KVH))
            for _ in range(copies)]
    pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ref = [c.clone() for c in cache]
    skipped = [c[:, 6].clone() for c in cache]

    def run(i, arrays=cache, fn=tatt.kv_cache_flush_rows):
        rk, rv, rks, rvs = rows[i % copies]
        fn(rk, rv, pt, arrays[0], arrays[1], rks, rvs, arrays[2], arrays[3])

    run(0)
    torch.cuda.synchronize()
    run(0, ref, tatt.kv_cache_flush_rows_plain)
    check(all(torch.equal(a, b) for a, b in zip(cache, ref)), "K10: cache differs")
    check(all(torch.equal(c[:, 6], s) for c, s in zip(cache, skipped)),
          "K10: the slot at pos S was written")
    del ref, skipped
    ms = cuda_ms(torch, run, 50)
    plain_ms = cuda_ms(torch, lambda i: run(i, cache, tatt.kv_cache_flush_rows_plain), 10)
    ok = [b for b, p in enumerate(pos) if p < S]
    ix = (torch.arange(L, device="cuda")[:, None, None],
          torch.tensor(ok, device="cuda")[None, :, None],
          torch.arange(KVH, device="cuda")[None, None, :],
          torch.tensor([pos[b] for b in ok], device="cuda")[None, :, None])
    okt = ix[1][0, :, 0]

    def lib(i):
        for c, r in zip(cache, rows[i % copies]):
            c[ix] = r[:, okt]

    library_ms = cuda_ms(torch, lib, 50)
    b_ms, by = bound_ms(2 * L * len(ok) * KVH * (2 * hd + 8) + 4 * B, 0, "int8")
    results.append(dict(kernel="K10", name=f"K10 kv_flush_rows L={L} B={B} S={S}",
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=by, library_ms=library_ms))
    del cache, rows
    torch.cuda.empty_cache()


def check_k18(torch, tatt, results):
    """K18 at the chunked admission's shape: one chunk of the compact 8 x
    2048 block (B 8, KVH 32, Tc 256, hd 128) into layer 17 of a
    [32, 8, 32, 2048, 128] cache at start 1024, bit-equal to its plain
    version; repeated calls rotate through other chunk rows, layers and
    starts.  The library call is one sliced ``copy_`` per array."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    L, B, KVH, S, hd, Tc, layer, start = 32, 8, 32, 2048, 128, 256, 17, 1024

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rf(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    cache = [ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rf(L, B, KVH, S), rf(L, B, KVH, S)]
    nbytes = 2 * (2 * B * KVH * Tc * hd + 2 * 4 * B * KVH * Tc)  # each byte in once, out once
    copies = n_copies(nbytes / 2)
    rows = [(ri(B, KVH, Tc, hd), ri(B, KVH, Tc, hd), rf(B, KVH, Tc), rf(B, KVH, Tc))
            for _ in range(copies)]
    where = [((start + Tc * i) % S, (layer + i) % L) for i in range(copies)]
    ref = [c.clone() for c in cache]
    tatt.kv_cache_write_chunk(*rows[0], start, layer, *cache)
    torch.cuda.synchronize()
    tatt.kv_cache_write_chunk_plain(*rows[0], start, layer, *ref)
    check(all(torch.equal(a, b) for a, b in zip(cache, ref)), "K18: cache differs")
    del ref

    def run(i, fn=tatt.kv_cache_write_chunk):
        st, ly = where[i % copies]
        fn(*rows[i % copies], st, ly, *cache)

    ms = cuda_ms(torch, run, 50)
    plain_ms = cuda_ms(torch, lambda i: run(i, tatt.kv_cache_write_chunk_plain), 20)

    def lib(i):
        st, ly = where[i % copies]
        for c, r in zip(cache, rows[i % copies]):
            c[ly, :, :, st:st + Tc].copy_(r)

    library_ms = cuda_ms(torch, lib, 50)
    b_ms, by = bound_ms(nbytes, 0, "int8")
    results.append(dict(kernel="K18", name=f"K18 kv_write_chunk B={B} KVH={KVH} Tc={Tc} "
                        f"into [{L}, {B}, {KVH}, {S}, {hd}] layer {layer} start {start}",
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                        library_ms=library_ms))
    del cache, rows
    torch.cuda.empty_cache()


# the paged kernels: K15 page scatter, K14 row flush, K13 / K20 decode attention
PAGED_PS = 512  # the served page size (Engine's default)


def scattered_pool(PagePool, B: int, MP: int, ps: int, seed: int = 0):
    """A ``PagePool`` of B * MP + 1 pages whose B slots each hold MP pages
    (the whole context), handed out after rounds of random reserves and
    releases, until no slot's pages are contiguous."""
    rng = np.random.default_rng(seed)
    pool = PagePool(B * MP + 1, ps, B, MP)
    for _ in range(20):
        for _ in range(64):
            s = int(rng.integers(B))
            if pool.held(s):
                pool.release(s)
            else:
                pool.reserve(s, int(rng.integers(1, MP * ps + 1)))
        for s in rng.permutation(B):
            pool.release(int(s))
        for s in rng.permutation(B):
            check(pool.reserve(int(s), MP * ps) is not None, "scattered pool: a reserve failed")
        if not any(np.all(np.diff(np.sort(pool.table[b])) == 1) for b in range(B)):
            return pool
    raise SmokeFailure(f"scattered pool: contiguous pages left: {pool.table.tolist()}")


def _live_rows(table, pos, P: int, ps: int):
    """For each pool page, how many of its first rows some slot attends
    (rows < pos); every other row is stale."""
    live = np.zeros(P, np.int64)
    for b, p in enumerate(pos):
        for j in range(-(-min(p, table.shape[1] * ps) // ps)):
            live[table[b, j]] = max(live[table[b, j]], min(ps, p - j * ps))
    return live


def check_paged_writes(torch, tatt, PagePool, results):
    """K15 and K14 at the 7B shapes (L32, KVH32, hd128, ps 512, a 33-page
    pool of 8 slots x 4 pages from ``scattered_pool``): K15 lands the 8 x
    512 compact admission block (and, checked only, a 700-row block whose
    last page is zero-padded, one slot's second page its trash page 0), K14
    one step's rows at mixed positions, one past the table and one of a
    parked slot, at batch 8 and at batch 32 (phase 4f's decode, on a
    129-page pool of 32 slots); both bit-equal to their plain versions
    outside page 0."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    L, KVH, hd, ps, B = 32, 32, 128, PAGED_PS, 8
    MP = 2048 // ps
    pool = scattered_pool(PagePool, B, MP, ps)
    P = pool.num_pages
    pt = torch.tensor(pool.table, device="cuda")

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rf(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    pools = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rf(L, P, KVH, ps), rf(L, P, KVH, ps)]
    slots = [5, 0, 7, 2, 1, 6, 3, 4]
    for T, table in ((700, pt.clone()), (512, pt)):
        if T == 700:
            table[2, 1:] = 0  # slot 2 reserved one page: its second lands on the trash page
        small = [ri(L, B, KVH, T, hd), ri(L, B, KVH, T, hd), rf(L, B, KVH, T), rf(L, B, KVH, T)]
        ref = [a.clone() for a in pools]
        tatt.kv_pool_scatter_pages(*small, slots, table, *pools)
        torch.cuda.synchronize()
        tatt.kv_pool_scatter_pages_plain(*small, slots, table, *ref)
        check(all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pools, ref)),
              f"K15 T={T}: pool differs outside page 0")
        del ref
    pages = table[torch.tensor(slots, device="cuda")][:, :1].long()  # [n, 1]
    blk = [a.view(L, B, KVH, 1, ps, *a.shape[4:]).transpose(2, 3) for a in small]

    def run(i, fn=tatt.kv_pool_scatter_pages):
        fn(*small, slots, pt, *pools)

    ms = cuda_ms(torch, run, 20)
    plain_ms = cuda_ms(torch, lambda i: run(i, tatt.kv_pool_scatter_pages_plain), 5)

    def lib(i):
        for a, b in zip(pools, blk):
            a[:, pages] = b

    library_ms = cuda_ms(torch, lib, 5)
    b_ms, by = bound_ms(2 * (2 * L * B * KVH * 512 * hd + 2 * L * B * KVH * 512 * 4)
                        + 4 * B * (MP + 1), 0, "int8")
    results.append(dict(kernel="K15", name=f"K15 kv_pool_scatter L={L} n={B} T=512 ps={ps} "
                        f"P={P}", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=by, library_ms=library_ms))
    del small, blk

    # K14 at batch 8 on that pool, then at batch 32 (phase 4f's decode) on a
    # 129-page pool of 32 slots; slot 6 past the table (trash page), slot 1
    # parked (its row lands on page 0)
    for B, sp in ((8, pool), (32, scattered_pool(PagePool, 32, MP, ps, seed=5))):
        if B == 32:
            del pools
            torch.cuda.empty_cache()
            P = sp.num_pages
            pools = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rf(L, P, KVH, ps),
                     rf(L, P, KVH, ps)]
        pos = list(DECODE_POS32[:B])
        pos[6] = MP * ps
        table = torch.tensor(sp.table, device="cuda")
        table[1] = 0
        copies = n_copies(L * B * KVH * (2 * hd + 8))
        rows = [(ri(L, B, KVH, hd), ri(L, B, KVH, hd), rf(L, B, KVH), rf(L, B, KVH))
                for _ in range(copies)]
        p32 = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ref = [a.clone() for a in pools]
        tatt.kv_pool_flush_rows(*rows[0], p32, table, *pools)
        torch.cuda.synchronize()
        tatt.kv_pool_flush_rows_plain(*rows[0], p32, table, *ref)
        check(all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(pools, ref)),
              f"K14 B={B}: pool differs outside page 0")
        del ref

        def run14(i, fn=tatt.kv_pool_flush_rows):
            fn(*rows[i % copies], p32, table, *pools)

        ms = cuda_ms(torch, run14, 50)
        plain_ms = cuda_ms(torch, lambda i: run14(i, tatt.kv_pool_flush_rows_plain), 10)
        ok, page, row = tatt._flush_targets(p32, table, P, ps)
        ix = (torch.arange(L, device="cuda")[:, None, None], page[None, :, None],
              torch.arange(KVH, device="cuda")[None, None, :], row[None, :, None])

        def lib14(i):
            for a, r in zip(pools, rows[i % copies]):
                a[ix] = r[:, ok]

        library_ms = cuda_ms(torch, lib14, 50)
        b_ms, by = bound_ms(2 * L * B * KVH * (2 * hd + 8) + 4 * B * (MP + 1), 0, "int8")
        results.append(dict(kernel="K14", name=f"K14 kv_pool_flush_rows L={L} B={B} ps={ps} "
                            f"P={P}", max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=by, library_ms=library_ms))
        del rows
    del pools
    torch.cuda.empty_cache()


def check_paged_attention(torch, tatt, PagePool, results):
    """K13 and K20 on the same inputs at the 7B shapes: 32-layer pools of
    ps 512 in ``scattered_pool``'s out-of-order pages, layer 17, at batch 8
    (one slot at each of DECODE_POS; MHA and a GQA group of 4) and at
    batch 1 at pos 511 and 2047; K13 also at batch 32 (DECODE_POS32, a
    32-slot pool: phase 4f's decode); every pool row that no slot attends (rows
    at and past each pos, unused pages, page 0) poisoned with int8 127 and
    scale 1e4.  Each within K6_TOL of its plain version.  K13 is then held
    to K9 on a paged copy of the same cache (``paged_view``): bit-equal at
    K9's block_s = 256 (K13's block: the same split cell over the same
    blocks and spans in the same order); the difference at K9's default
    block of 128 rows is recorded.  K13 runs under the split rule's count
    and, where that is more than one, at one split, each against its plain
    version and K9 at the same splits; K20 (whole pages as the rounding
    block) under its own rule (``page_variants``), each against its plain
    version at the same splits, with the trace's device ms and the cell's
    occupancy beside.  Repeated calls rotate through other layers and
    queries."""
    from tpu_llama_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(13)
    L, hd, ps, layer = 32, 128, PAGED_PS, 17
    MP = 2048 // ps
    pool = scattered_pool(PagePool, 8, MP, ps, seed=1)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rs(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.03 + 0.01

    for B, KVH, G, pos in ((8, 32, 1, DECODE_POS), (8, 8, 4, DECODE_POS), (1, 32, 1, [511]),
                           (1, 32, 1, [2047]), (32, 32, 1, DECODE_POS32)):
        if B == 32:  # phase 4f's decode, K13 only: a 129-page pool of 32 slots
            pool = scattered_pool(PagePool, 32, MP, ps, seed=4)
        P = pool.num_pages
        table = pool.table[:B] if B > 1 else pool.table[7:8]
        arrs = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rs(L, P, KVH, ps),
                rs(L, P, KVH, ps)]
        for pg, n in enumerate(_live_rows(table, pos, P, ps)):
            for a, val in zip(arrs, (127, 127, 1e4, 1e4)):
                a[:, pg, :, n:] = val
        pt = torch.tensor(table, device="cuda")
        p32 = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rows = KVH * sum(pos)
        copies = n_copies(rows * (2 * hd + 8))
        layers = [(layer + i) % L for i in range(copies)]
        q = [torch.randn(B, KVH, G, hd, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(copies)]
        nk = [ri(B, KVH, hd) for _ in range(copies)]
        nv = [ri(B, KVH, hd) for _ in range(copies)]
        nks = [rs(B, KVH) for _ in range(copies)]
        nvs = [rs(B, KVH) for _ in range(copies)]
        dense = [tatt.paged_view(a, pt, layer) for a in arrs]  # [1, B, KVH, S(, hd)]
        library_ms, library_dev = _sdpa_ms(torch, q, *dense, nk, nv, nks, nvs, p32,
                                           [0] * copies, copies, device=True)
        torch.cuda.empty_cache()
        nbytes = (rows * (2 * hd + 8) + B * KVH * G * hd * (2 + 4) + B * KVH * (2 * hd + 8)
                  + 4 * B * (MP + 1))
        b_ms, by = bound_ms(nbytes, 4 * hd * G * (rows + B * KVH), "bf16")
        ts = tatt._paged_block(ps)
        variants = [("K13", "dma", n) for n in split_variants(tatt, B, KVH, ts, MP * ps)]
        if B != 32:
            variants += [("K20", "fresh", n) for n in page_variants(tatt, q[0], arrs[0], pt)]
        for kernel, name, n in variants:
            fn = getattr(tatt, f"paged_flash_decode_attention_{name}")
            plain = getattr(tatt, f"paged_flash_decode_attention_{name}_plain")
            kw = dict(splits=n)

            def run(i, f=fn):
                j = i % copies
                return f(q[j], *arrs, pt, p32, nk[j], nv[j], nks[j], nvs[j], layer=layers[j],
                         **kw)

            got = run(0)
            torch.cuda.synchronize()
            want = run(0, plain)
            err = (got - want).abs().max().item()
            peak = want.abs().max().item()
            label = f"{kernel} paged_{name} B={B} KVH={KVH} G={G} ps={ps} pos=" \
                    f"{pos[0] if B == 1 else 'mix'} splits={n}"
            check(err <= K6_TOL * peak, f"{label}: err {err} > {K6_TOL} * {peak}")
            if kernel == "K20":
                extra = dict(splits=n, **page_residency(_kernels, tatt, "K20", G, hd, ps),
                             device_ms=device_ms(torch, run), library_device_ms=library_dev)
            else:  # K13 against K9 on the paged copy of layer 17, same splits
                k9 = [tatt.flash_decode_attention_dma(q[0], dense[0], dense[1], p32, nk[0], nv[0],
                                                      dense[2], dense[3], nks[0], nvs[0],
                                                      layer=0, block_s=bs, splits=n)
                      for bs in (256, 128)]
                torch.cuda.synchronize()
                extra = dict(k9_block256_max_diff=(got - k9[0]).abs().max().item(),
                             k9_block128_max_diff=(got - k9[1]).abs().max().item())
                check(torch.equal(got, k9[0]), f"{label}: K13 != K9 (block_s 256) on the paged "
                                               f"copy: {extra}")
                extra.update(splits=n, **split_residency(_kernels, torch.int8, G, hd, ts),
                             device_ms=device_ms(torch, run), library_device_ms=library_dev)
            ms = cuda_ms(torch, run, 50)
            plain_ms = cuda_ms(torch, lambda i: run(i, plain), 3)
            print(f"  {label}: {ms:.4f} ms (SDPA {library_ms}, bound {b_ms:.4f}) {extra}",
                  flush=True)
            results.append(dict(kernel=kernel, name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, **extra))
        del arrs, dense
        torch.cuda.empty_cache()


# the pool-direct admission's kernels (K17 chunk write, K16 chunk attention)
# and the paged write-then-attend decode attention (K22)
WAVE = dict(B=16, KVH=32, G=1, Tc=256, hd=128, start=768)  # one 7B admission wave
WAVE_GQA = dict(B=8, KVH=8, G=4, Tc=256, hd=128, start=1792)


def check_pool_direct(torch, tatt, PagePool, results):
    """K17 and K16 at a 7B admission wave's shapes (B 16, KVH 32, Tc 256, hd
    128, chunk start 768, layer 17 of 32-layer pools of 512-row pages that
    ``scattered_pool`` handed out of order; K16 also at a GQA shape, B 8,
    KVH 8, G 4, start 1792).  K17 bit-equal to its plain version outside
    page 0, one slot's start past the table (its rows land on page 0).  K16
    within K6_TOL of its plain version on pools whose rows no query attends
    are poisoned (int8 127, scale 1e4), and bit-equal to K6 on a dense copy
    of the same keys: the slots' pages as dense rows, the fresh rows at
    [start, start + Tc).  Repeated calls rotate through layers."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(16)
    L, ps, layer = 32, PAGED_PS, 17
    MP = 2048 // ps

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rs(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.03 + 0.01

    for shape in (WAVE, WAVE_GQA):
        B, KVH, G, Tc, hd, start = (shape[k] for k in ("B", "KVH", "G", "Tc", "hd", "start"))
        NH = KVH * G
        pool = scattered_pool(PagePool, B, MP, ps, seed=B + G)
        P = pool.num_pages
        table = pool.table.copy()
        pt = torch.tensor(table, device="cuda")
        arrs = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rs(L, P, KVH, ps),
                rs(L, P, KVH, ps)]
        rows = [ri(B, KVH, Tc, hd), ri(B, KVH, Tc, hd), rs(B, KVH, Tc), rs(B, KVH, Tc)]
        starts = [start] * B
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        if G == 1:  # K17, its starts on the card as the model passes them
            past = starts[:-1] + [MP * ps]  # the last slot past its table: page 0
            ref = [a.clone() for a in arrs]
            tatt.kv_pool_write_chunk(*rows, pt, torch.tensor(past, dtype=torch.int32,
                                                             device="cuda"), layer, *arrs)
            torch.cuda.synchronize()
            tatt.kv_pool_write_chunk_plain(*rows, pt, past, layer, *ref)
            check(all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(arrs, ref)),
                  "K17: pool differs outside page 0")
            del ref
            pages = pt[:, start // ps].long()
            off = start % ps

            def run17(i, fn=tatt.kv_pool_write_chunk, s=st):
                fn(*rows, pt, s, (layer + i) % L, *arrs)

            ms = cuda_ms(torch, run17, 50)
            plain_ms = cuda_ms(torch, lambda i: run17(i, tatt.kv_pool_write_chunk_plain, starts),
                               10)

            def lib17(i):
                for a, r in zip(arrs, rows):
                    a[(layer + i) % L][pages, :, off:off + Tc] = r

            library_ms = cuda_ms(torch, lib17, 50)
            nbytes = 2 * (2 * B * KVH * Tc * hd + 2 * 4 * B * KVH * Tc) + 4 * B * (MP + 1)
            b_ms, by = bound_ms(nbytes, 0, "int8")
            results.append(dict(kernel="K17", name=f"K17 kv_pool_write_chunk B={B} KVH={KVH} "
                                f"Tc={Tc} ps={ps} P={P} layer {layer} start {start}",
                                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=by, library_ms=library_ms))
        # K16: the rows no query attends poisoned (past rows at and past start)
        for pg, n in enumerate(_live_rows(table, starts, P, ps)):
            for a, val in zip(arrs, (127, 127, 1e4, 1e4)):
                a[:, pg, :, n:] = val
        q = torch.randn(B, Tc, NH, hd, generator=gen, device="cuda").to(torch.bfloat16)
        W = -(-start // ps)

        def run16(i, fn=tatt.paged_flash_prefill_attention):
            return fn(q, *arrs, pt, st, *rows, layer=(layer + i) % L, past_pages=W,
                      out_dtype=torch.bfloat16)

        got = run16(0)
        torch.cuda.synchronize()
        want = run16(0, tatt.paged_flash_prefill_attention_plain)
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        label = f"K16 paged_flash_prefill B={B} KVH={KVH} G={G} Tc={Tc} ps={ps} start {start}"
        check(err <= K6_TOL * peak, f"{label}: err {err} > {K6_TOL} * {peak}")
        dense = [tatt.paged_view(a, pt, layer)[0].clone() for a in arrs]  # [B, KVH, 2048..]
        for d, f in zip(dense, rows):
            d[:, :, start:start + Tc] = f
        k6 = tatt.flash_prefill_attention(q, dense[0], dense[1], st, dense[2], dense[3],
                                          out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        k6_diff = (got.float() - k6.float()).abs().max().item()
        check(torch.equal(got, k6), f"{label}: K16 != K6 on the dense copy (max diff {k6_diff})")
        ms = cuda_ms(torch, run16, 20)
        # K6 on the dense copy, the same work: what K16's paged, one-run-tile
        # addressing costs over K6's dense one (one layer's copy, 134 MB of
        # K and V at the wave shape, so mostly cold in the 50 MB L2 as well)
        k6_ms = cuda_ms(torch, lambda i: tatt.flash_prefill_attention(
            q, dense[0], dense[1], st, dense[2], dense[3], out_dtype=torch.bfloat16), 20)
        plain_ms = cuda_ms(torch, lambda i: run16(i, tatt.paged_flash_prefill_attention_plain), 3)
        # the library call: SDPA on the gathered, dequantized past rows and
        # the fresh rows (bf16, the query heads' K/V expanded), mask s <= start + t
        kd = (dense[0][:, :, :start + Tc].float() * dense[2][:, :, :start + Tc, None])
        vd = (dense[1][:, :, :start + Tc].float() * dense[3][:, :, :start + Tc, None])
        kd = kd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        vd = vd.to(torch.bfloat16).repeat_interleave(G, dim=1)
        qt = q.transpose(1, 2)
        mask = (torch.arange(start + Tc, device="cuda")[None, :]
                <= start + torch.arange(Tc, device="cuda")[:, None])
        library_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask), 20)
        del kd, vd, dense, k6
        pairs = B * sum(start + t + 1 for t in range(Tc))  # attended (query, key) per head
        nbytes = (2 * B * Tc * NH * hd * 2 + B * KVH * (start + Tc) * (2 * hd + 8)
                  + 4 * B * (MP + 1))
        b_ms, by = bound_ms(nbytes, 4 * hd * NH * pairs, "bf16")
        results.append(dict(kernel="K16", name=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                            library_ms=library_ms, k6_dense_copy_max_diff=k6_diff,
                            k6_dense_copy_ms=k6_ms))
        del arrs, rows, got, want
        torch.cuda.empty_cache()


def check_k22(torch, tatt, PagePool, results):
    """K22 at K13's four shapes (check_paged_attention): 32-layer pools of
    ps 512 in ``scattered_pool``'s pages, layer 17, batch 8 at DECODE_POS
    (MHA and a GQA group of 4) and batch 1 at pos 511 and 2047; every pool
    row that no slot attends (past each pos: K22 attends rows <= pos)
    poisoned.  Under its split rule (``page_variants``) and, where that is
    more than one, at one split, each within K6_TOL of its plain version at
    the same splits, with the trace's device ms and the cell's occupancy
    beside.  The library call is SDPA on the gathered, dequantized rows
    with the mask s <= pos (event and device ms)."""
    import torch.nn.functional as F

    from tpu_llama_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(22)
    L, hd, ps, layer = 32, 128, PAGED_PS, 17
    MP = 2048 // ps
    S = MP * ps
    pool = scattered_pool(PagePool, 8, MP, ps, seed=2)
    P = pool.num_pages

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rs(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.03 + 0.01

    for B, KVH, G, pos in ((8, 32, 1, DECODE_POS), (8, 8, 4, DECODE_POS), (1, 32, 1, [511]),
                           (1, 32, 1, [2047])):
        table = pool.table[:B] if B == 8 else pool.table[7:8]
        arrs = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rs(L, P, KVH, ps),
                rs(L, P, KVH, ps)]
        for pg, n in enumerate(_live_rows(table, [p + 1 for p in pos], P, ps)):
            for a, val in zip(arrs, (127, 127, 1e4, 1e4)):
                a[:, pg, :, n:] = val
        pt = torch.tensor(table, device="cuda")
        p32 = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rows = KVH * sum(p + 1 for p in pos)
        copies = n_copies(rows * (2 * hd + 8))
        layers = [(layer + i) % L for i in range(copies)]
        q = [torch.randn(B, KVH, G, hd, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(copies)]
        deq = []
        for j in range(copies):
            d = [tatt.paged_view(a, pt, layers[j])[0] for a in arrs]
            deq.append((q[j].reshape(B, KVH * G, 1, hd),
                        (d[0].float() * d[2][..., None]).to(torch.bfloat16),
                        (d[1].float() * d[3][..., None]).to(torch.bfloat16)))
        mask = (torch.arange(S, device="cuda")[None, :] <= p32[:, None])[:, None, None, :]
        kw = dict(enable_gqa=True) if G > 1 else {}

        def lib(i):
            return F.scaled_dot_product_attention(*deq[i % copies], attn_mask=mask, **kw)

        try:
            library_ms, library_dev = cuda_ms(torch, lib, 50), device_ms(torch, lib, 20)
        except (TypeError, RuntimeError) as e:  # a GQA call this build refuses
            print(f"K22 library call unavailable: {e}", file=sys.stderr)
            library_ms = library_dev = None
        del deq
        torch.cuda.empty_cache()
        nbytes = rows * (2 * hd + 8) + B * KVH * G * hd * (2 + 4) + 4 * B * (MP + 1)
        b_ms, by = bound_ms(nbytes, 4 * hd * G * rows, "bf16")
        res = page_residency(_kernels, tatt, "K22", G, hd, ps)
        for n in page_variants(tatt, q[0], arrs[0], pt):

            def run(i, f=tatt.paged_flash_decode_attention):
                j = i % copies
                return f(q[j], *arrs, pt, p32, layer=layers[j], splits=n)

            got = run(0)
            torch.cuda.synchronize()
            want = run(0, tatt.paged_flash_decode_attention_plain)
            err = (got - want).abs().max().item()
            peak = want.abs().max().item()
            label = f"K22 paged_flash_decode B={B} KVH={KVH} G={G} ps={ps} pos=" \
                    f"{pos[0] if B == 1 else 'mix'} splits={n}"
            check(err <= K6_TOL * peak, f"{label}: err {err} > {K6_TOL} * {peak}")
            ms = cuda_ms(torch, run, 50)
            plain_ms = cuda_ms(torch, lambda i: run(i, tatt.paged_flash_decode_attention_plain),
                               3)
            extra = dict(splits=n, **res, device_ms=device_ms(torch, run),
                         library_device_ms=library_dev)
            print(f"  {label}: {ms:.4f} ms (SDPA {library_ms}, bound {b_ms:.4f}) {extra}",
                  flush=True)
            results.append(dict(kernel="K22", name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, **extra))
        del arrs
        torch.cuda.empty_cache()


def device_ms(torch, fn, n: int = 20) -> float:
    """Device milliseconds per call of ``fn(i)``: the kernels' own time in a
    ``torch.profiler`` trace of ``n`` calls (no launch gaps), summed and
    divided by ``n``.  Few-us launches timed back to back with events read
    the host's launch rate instead."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that caught no kernel (seen in development runs) is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            break
    return total / 1e3 / n


def _q8_weights(torch, tq, gen, n, k, copies=1, pad_out=None, layers=1):
    """Random Q8_0 weights [n, k] (rows padded to ``pad_out``), Q8_0's group
    for k; ``layers`` > 1 stacks them and returns the last layer's view."""
    g = tq.pick_group_size(k)
    rows = pad_out or n
    out = []
    for _ in range(copies):
        q = torch.randint(-127, 128, (layers, rows, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(layers, rows, k // g, generator=gen, device="cuda") * 1e-3 + 1e-4
        w = tq.QuantTensor(q=q, s=s, logical_in=k, logical_out=n)
        out.append(w.layer(layers - 1) if layers > 1 else tq.QuantTensor(
            q=q[0], s=s[0], logical_in=k, logical_out=n))
    return out


def check_k25(torch, tq, tm, results):
    """K25 at the 7B shapes of the Q8_0 path: M 8 (a decode step) on wqkv,
    wo, w13, w2 and the classifier (q8_gemv_kernel), M 4096 (the 8 x 512
    admission) on wqkv, wo, w13 and w2 (q8_matmul_wgmma_kernel, x cast to
    bf16 by the wrapper); f32 activations, as the served model's; random
    int8 weights with Q8_0's groups (g 64 for in 4096, 32 for in 11008).
    Against the plain version within K25_TOL; the library call is
    ``torch.matmul`` on the weight dequantized once to bf16.  The M 8 rows
    also read both sides' device time from a trace (``device_ms``).  Then
    the ragged edges, checked only: M 17, 1000 (in 11008, g 32, a layer
    view of stacked weights), 4095 with out 4000 of 4096 padded rows, and
    the decode kernel at M 1 and 16, f32 and bf16 x; one bf16-output case
    within one bf16 step (2^-7) of the peak."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    cases = [(8, 4096, 12288), (8, 4096, 4096), (8, 4096, 22016), (8, 11008, 4096),
             (8, 4096, 32000), (4096, 4096, 12288), (4096, 4096, 4096), (4096, 4096, 22016),
             (4096, 11008, 4096)]
    for m, k, n in cases:
        g = tq.pick_group_size(k)
        wbytes = n * k + 4 * n * (k // g)
        copies = n_copies(wbytes)
        ws = _q8_weights(torch, tq, gen, n, k, copies)
        x = torch.randn(m, k, generator=gen, device="cuda")
        got = tm.q8_matmul(x, ws[0], out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = tm.q8_matmul_plain(x, ws[0], out_dtype=torch.float32)
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        label = f"K25 q8_matmul M={m} K={k} N={n} g={g}"
        check(err <= K25_TOL * peak, f"{label}: err {err} > {K25_TOL} * {peak}")
        iters = 50 if m == 8 else 10
        ms = cuda_ms(torch, lambda i: tm.q8_matmul(x, ws[i % copies]), iters)
        plain_ms = cuda_ms(torch, lambda i: tm.q8_matmul_plain(x, ws[i % copies]), 3, warmup=1)
        wb = [tm.q8_weight_bf16(w) for w in ws]
        xb = x.to(torch.bfloat16)
        library_ms = cuda_ms(torch, lambda i: torch.matmul(xb, wb[i % copies].t()), iters)
        extra = {}
        if m <= tm.Q8_GEMV_ROWS:
            extra = dict(device_ms=device_ms(torch, lambda i: tm.q8_matmul(x, ws[i % copies])),
                         library_device_ms=device_ms(
                             torch, lambda i: torch.matmul(xb, wb[i % copies].t())))
        del wb
        b_ms, by = bound_ms(wbytes + 4 * m * k + 4 * m * n, 2 * m * k * n, "bf16")
        results.append(dict(kernel="K25", name=label, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                            library_ms=library_ms, **extra))
        del ws, x, got, want
    torch.cuda.empty_cache()
    # the ragged edges: (M, K, N, padded out rows, stacked layers, x dtype)
    f32, bf16 = torch.float32, torch.bfloat16
    for m, k, n, pad, layers, xdt, odt in (
            (17, 4096, 4096, None, 1, f32, f32), (1000, 11008, 4096, None, 3, bf16, f32),
            (4095, 4096, 4000, 4096, 1, f32, f32), (1, 4096, 12288, None, 1, f32, f32),
            (16, 11008, 4096, None, 3, bf16, f32), (16, 4096, 1000, 1024, 1, f32, f32),
            (1000, 4096, 4000, 4096, 1, f32, bf16)):
        w = _q8_weights(torch, tq, gen, n, k, 1, pad, layers)[0]
        x = torch.randn(m, k, generator=gen, device="cuda").to(xdt)
        got = tm.q8_matmul(x, w, out_dtype=odt)
        torch.cuda.synchronize()
        want = tm.q8_matmul_plain(x, w, out_dtype=odt)
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        tol = K25_TOL if odt == f32 else 2.0 ** -7
        label = (f"K25 q8_matmul M={m} K={k} N={n} of {pad or n} layers={layers} "
                 f"x={_sfx(xdt)} out={_sfx(odt)}")
        check(got.shape == (m, n) and err <= tol * peak, f"{label}: err {err} > {tol} * {peak}")
        print(json.dumps(dict(kernel="K25", name=label, max_err=err, peak=peak, tol=tol)),
              flush=True)
        del w, x, got, want
    torch.cuda.empty_cache()


FP_NAMES = {"K6": "flash_prefill_attention", "K7": "kv_cache_scatter_slots",
            "K9": "flash_decode_attention_dma", "K19": "flash_decode_attention_fresh",
            "K10": "kv_cache_flush_rows"}


def _sfx(dtype) -> str:
    return "f32" if str(dtype) == "torch.float32" else "bf16"


def _fp_label(kernel: str, dtype) -> tuple[str, str]:
    """(the launch-count id, the name prefix) of an fp form: ("K6:f32",
    "K6:f32 flash_prefill_attention[f32]")."""
    sfx = _sfx(dtype)
    return f"{kernel}:{sfx}", f"{kernel}:{sfx} {FP_NAMES[kernel]}[{sfx}]"


def check_fp_forms(torch, tatt, results):
    """The fp forms of K6, K7, K9, K19 and K10 on f32 and bf16 caches at the
    shapes their INT8 forms are checked at: K6 at the 8 x 512 admission and
    a continuation at start > 0 in a 2048-row cache, K7 into a
    [32, 8, 32, 2048, 128] cache, K9 and K19 on layer 17 of a 32-layer
    2048-row cache at batch 8 (one slot at each of DECODE_POS) and batch 1
    at position 2047, with every row at and past a slot's pos poisoned with
    1e4, K10 at the step's shape.  K6, K9 and K19 take f32 queries (and K6
    writes f32 outputs), as the dense and Q8_0 paths pass them, within
    FP_TOL of their plain versions; bf16 queries beside them (K6 writing
    bf16, within K6_TOL); K7 and K10 exact.  K6's bound is its split cell's
    own (csrc/prefill_split.cuh: the TF32 or bf16 passes' operations),
    with the f32 SIMT bound beside it (``simt_bound_ms``).  Library calls:
    SDPA on the fp cache, as for the INT8 forms, and the indexed copies.
    K9 runs under the split rule's count and, where that is more than one,
    at one split."""
    import torch.nn.functional as F

    from tpu_llama_torch.ops import _kernels

    for dt in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dt).element_size()
        gen = torch.Generator(device="cuda").manual_seed(60 + es)
        # K6: f32 queries and outputs, as the dense and Q8_0 paths pass them,
        # within FP_TOL; bf16 ones beside them, within K6_TOL (bf16 outputs)
        kid, prefix = _fp_label("K6", dt)
        for (B, T, NH, KVH, S, hd, start), (qdt, tol) in itertools.product(
                ((8, 512, 32, 32, 512, 128, [0] * 8), (2, 128, 32, 32, 2048, 128, [600, 1900])),
                ((torch.float32, FP_TOL), (torch.bfloat16, K6_TOL))):
            qb = torch.tensor([], dtype=qdt).element_size()
            st = torch.tensor(start, dtype=torch.int32, device="cuda")
            copies = n_copies(B * T * NH * hd * qb + 2 * B * KVH * S * hd * es)
            ins = [(torch.randn(B, T, NH, hd, generator=gen, device="cuda").to(qdt),
                    torch.randn(B, KVH, S, hd, generator=gen, device="cuda").to(dt),
                    torch.randn(B, KVH, S, hd, generator=gen, device="cuda").to(dt))
                   for _ in range(copies)]

            def run(i, fn=tatt.flash_prefill_attention):
                q, k, v = ins[i % copies]
                return fn(q, k, v, st, out_dtype=qdt)

            got = run(0)
            torch.cuda.synchronize()
            want = run(0, tatt.flash_prefill_attention_plain)
            err = (got.float() - want.float()).abs().max().item()
            peak = want.float().abs().max().item()
            label = (f"{prefix} B={B} T={T} S={S} start={'0' if not any(start) else '>0'} "
                     f"q={_sfx(qdt)}")
            check(err <= tol * peak, f"{label}: err {err} > {tol} * {peak}")
            ms = cuda_ms(torch, run, 20)
            plain_ms = cuda_ms(torch, lambda i: run(i, tatt.flash_prefill_attention_plain), 3,
                               warmup=1)
            sd = [(q.transpose(1, 2).to(dt), k, v) for q, k, v in ins]
            if T == S and not any(start):
                mask = None
            else:
                t_pos = (st[:, None, None, None]
                         + torch.arange(T, device="cuda")[None, None, :, None])
                mask = torch.arange(S, device="cuda")[None, None, None, :] <= t_pos
            library_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                *sd[i % copies], attn_mask=mask, is_causal=mask is None), 20)
            keys = sum(min(S, s + t + 1) for s in start for t in range(T))
            used = sum(min(S, s + T) for s in start)
            nbytes = B * T * NH * hd * qb * 2 + 2 * KVH * used * hd * es + 4 * B
            # the split cells' passes (csrc/prefill_split.cuh): a bf16 cache
            # runs bf16 ones, QK^T one per bf16 term of q (3 for f32 q) and
            # PV 3; an f32 cache TF32 ones, QK^T 2 (3 for f32 q) and PV 3;
            # beside it the bound of the f32 dots on the SIMT cores
            if dt == torch.bfloat16:
                passes, kind = (3 if qdt == torch.float32 else 1) + 3, "bf16"
            else:
                passes, kind = (3 if qdt == torch.float32 else 2) + 3, "tf32"
            b_ms, by = bound_ms(nbytes, 2 * hd * NH * keys * passes, kind)
            simt_ms, _ = bound_ms(nbytes, 4 * hd * NH * keys, "f32")
            results.append(dict(kernel=kid, name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, simt_bound_ms=simt_ms))
            del ins, sd, got, want, mask
            torch.cuda.empty_cache()

        # K7
        kid, prefix = _fp_label("K7", dt)
        L, n, KVH, T, hd, B, S = 32, 8, 32, 512, 128, 8, 2048
        small = [torch.randn(L, n, KVH, T, hd, generator=gen, device="cuda").to(dt)
                 for _ in range(2)]
        cache = [torch.zeros(L, B, KVH, S, hd, dtype=dt, device="cuda") for _ in range(2)]
        slots = [5, 0, 7, 2, 1, 6, 3, 4]
        tatt.kv_cache_scatter_slots(*small, slots, *cache)
        torch.cuda.synchronize()
        ref = [torch.zeros_like(c) for c in cache]
        tatt.kv_cache_scatter_slots_plain(*small, slots, *ref)
        check(all(torch.equal(a, b) for a, b in zip(cache, ref)), f"{prefix}: cache differs")
        del ref
        ms = cuda_ms(torch, lambda i: tatt.kv_cache_scatter_slots(*small, slots, *cache), 20)
        plain_ms = cuda_ms(torch, lambda i: tatt.kv_cache_scatter_slots_plain(
            *small, slots, *cache), 5)
        sl = torch.tensor(slots, device="cuda")

        def lib(i):
            for c, sm in zip(cache, small):
                c[:, sl, :, :T] = sm

        library_ms = cuda_ms(torch, lib, 5)
        b_ms, by = bound_ms(2 * 2 * L * n * KVH * T * hd * es, 0, "f32")
        results.append(dict(kernel=kid, name=f"{prefix} L={L} n={n} T={T} S={S}",
                            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=by, library_ms=library_ms))
        del small, cache
        torch.cuda.empty_cache()

        # K9 and K19, then K10, on one 32-layer cache
        L, S, hd, layer = 32, 2048, 128, 17
        for B, KVH, G, pos in ((8, 32, 1, DECODE_POS), (1, 32, 1, [2047])):
            k = torch.randn(L, B, KVH, S, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(L, B, KVH, S, hd, generator=gen, device="cuda").to(dt)
            for b, p in enumerate(pos):  # rows at and past pos: stale, never read
                k[:, b, :, p:] = 1e4
                v[:, b, :, p:] = 1e4
            pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
            rows = KVH * sum(pos)
            copies = n_copies(rows * 2 * hd * es)
            layers = [(layer + i) % L for i in range(copies)]
            qf = [torch.randn(B, KVH, G, hd, generator=gen, device="cuda")
                  for _ in range(copies)]
            nk = [torch.randn(B, KVH, hd, generator=gen, device="cuda").to(dt)
                  for _ in range(copies)]
            nv = [torch.randn(B, KVH, hd, generator=gen, device="cuda").to(dt)
                  for _ in range(copies)]
            library_ms, library_dev = _sdpa_fp_ms(torch, qf, k, v, nk, nv, pt, layers, copies,
                                                  device=True)
            torch.cuda.empty_cache()
            # f32 queries, as the dense and Q8_0 paths pass them; bf16 beside;
            # K9 under the split rule's count and at one split
            res = split_residency(_kernels, dt, G, hd, 64)
            k9 = [("K9", "dma", n) for n in split_variants(tatt, B, KVH, 64, S)]
            k19 = [("K19", "fresh", n) for n in norm_variants(tatt, B, KVH, 64, S)]
            for (kernel, name, n), qdt in itertools.product(k9 + k19,
                                                            (torch.float32, torch.bfloat16)):
                kid, prefix = _fp_label(kernel, dt)
                fn = getattr(tatt, f"flash_decode_attention_{name}")
                plain = getattr(tatt, f"flash_decode_attention_{name}_plain")
                q = [t.to(qdt) for t in qf]
                qb = torch.tensor([], dtype=qdt).element_size()
                nbytes = (rows * 2 * hd * es + B * KVH * G * hd * (qb + 4)
                          + B * KVH * 2 * hd * es + 4 * B)
                b_ms, by = bound_ms(nbytes, 4 * hd * G * (rows + B * KVH), "f32")
                kw = dict(splits=n)

                def run(i, f=fn):
                    j = i % copies
                    return f(q[j], k, v, pt, nk[j], nv[j], layer=layers[j], **kw)

                got = run(0)
                torch.cuda.synchronize()
                want = run(0, plain)
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                label = (f"{prefix} B={B} KVH={KVH} G={G} pos={pos[0] if B == 1 else 'mix'} "
                         f"q={_sfx(qdt)} splits={n}")
                check(err <= FP_TOL * peak, f"{label}: err {err} > {FP_TOL} * {peak}")
                ms = cuda_ms(torch, run, 50)
                plain_ms = cuda_ms(torch, lambda i: run(i, plain), 3, warmup=1)
                cell = res if kernel == "K9" else norm_residency(_kernels, "K19", dt, G, hd, S,
                                                                 64, n)
                extra = dict(splits=n, **cell, device_ms=device_ms(torch, run),
                             library_device_ms=library_dev)
                print(f"  {label}: {ms:.4f} ms (SDPA {library_ms}, bound {b_ms:.4f}) {extra}",
                      flush=True)
                results.append(dict(kernel=kid, name=label, max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                    library_ms=library_ms, **extra))
            if B == 8:  # K10 at the step's shape on this cache
                kid, prefix = _fp_label("K10", dt)
                fpos = [0, 1, 127, 128, 511, 1000, S, 2047]
                pf = torch.tensor(fpos, dtype=torch.int32, device="cuda")
                fr = [(torch.randn(L, B, KVH, hd, generator=gen, device="cuda").to(dt),
                       torch.randn(L, B, KVH, hd, generator=gen, device="cuda").to(dt))
                      for _ in range(copies)]
                ref = [k.clone(), v.clone()]
                tatt.kv_cache_flush_rows(*fr[0], pf, k, v)
                torch.cuda.synchronize()
                tatt.kv_cache_flush_rows_plain(*fr[0], pf, *ref)
                check(torch.equal(k, ref[0]) and torch.equal(v, ref[1]),
                      f"{prefix}: cache differs")
                del ref
                ms = cuda_ms(torch, lambda i: tatt.kv_cache_flush_rows(*fr[i % copies], pf, k,
                                                                        v), 50)
                plain_ms = cuda_ms(torch, lambda i: tatt.kv_cache_flush_rows_plain(
                    *fr[i % copies], pf, k, v), 10)
                ok = [b for b, p in enumerate(fpos) if p < S]
                ix = (torch.arange(L, device="cuda")[:, None, None],
                      torch.tensor(ok, device="cuda")[None, :, None],
                      torch.arange(KVH, device="cuda")[None, None, :],
                      torch.tensor([fpos[b] for b in ok], device="cuda")[None, :, None])

                def lib(i):
                    for c, r in zip((k, v), fr[i % copies]):
                        c[ix] = r[:, ix[1][0, :, 0]]

                library_ms = cuda_ms(torch, lib, 50)
                b_ms10, by10 = bound_ms(2 * L * len(ok) * KVH * 2 * hd * es + 4 * B, 0, "f32")
                results.append(dict(kernel=kid, name=f"{prefix} L={L} B={B} S={S}",
                                    max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms10,
                                    bound_by=by10, library_ms=library_ms))
                del fr
            del k, v, q, qf, nk, nv
            torch.cuda.empty_cache()


def _sdpa_fp_ms(torch, q, k, v, nk, nv, pos, layers, copies, device=False):
    """The library yardstick of the fp forms of K9 and K19: SDPA on the fp
    cache's layer with the fresh row written at pos and the mask s <= pos;
    with ``device``, (event ms, device ms from a trace)."""
    import torch.nn.functional as F

    B, KVH, G, hd = q[0].shape
    S = k.shape[3]
    b_ix = torch.arange(B, device="cuda")
    sd = []
    for i in range(copies):
        kd, vd = k[layers[i]].clone(), v[layers[i]].clone()
        kd[b_ix, :, pos.long()] = nk[i]
        vd[b_ix, :, pos.long()] = nv[i]
        sd.append((q[i].reshape(B, KVH * G, 1, hd).to(k.dtype), kd, vd))
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    kw = dict(enable_gqa=True) if G > 1 else {}

    def lib(i):
        return F.scaled_dot_product_attention(*sd[i % copies], attn_mask=mask, **kw)

    try:
        ms = cuda_ms(torch, lib, 50)
        return (ms, device_ms(torch, lib, 20)) if device else ms
    except (TypeError, RuntimeError) as e:  # a call this build refuses
        print(f"fp decode attention library call unavailable: {e}", file=sys.stderr)
        return (None, None) if device else None


def _layer_weights(torch, tq, gen, L, D, H, QO):
    """Random stacked W8A8 weights of a fused 7B layer stack: wo, w13, w2,
    wqkv (K-major) and bf16 rms rows."""
    def qt(n_in, n_out):
        return tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=gen, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=gen, device="cuda") * 2e-4 + 1e-4)

    rms = [(1 + 0.1 * torch.randn(L, D, generator=gen, device="cuda")).to(torch.bfloat16)
           for _ in range(2)]
    return (qt(D, D), qt(D, 2 * H), qt(H, D), qt(D, QO)), rms


def check_fused(torch, tq, tfl, tfs, results):
    """K8, K11 and K12 at 7B width against their plain versions on a
    32-layer stack: K8 on layer 0's wqkv at batch 8 and 32; K11 at batch 8
    and 32 (phase 4f's decode) on layers 17 and 31 (the last: no phase D),
    timed by events and by the trace's device ms;
    K12 on layer 17 at batch 8
    (one slot at each of DECODE_POS) and at batch 1 (pos 511, 2047), and on
    the last layer, its trailing cells at their split rule (``fused_splits``)
    and at one split, against the plain version at the same splits.  K8 and
    K11 bit-equal, K12's x_next bit-equal, its
    fresh K/V rows within QUANT_FLIPS and their scales within
    QUANT_SCALE_RTOL (the plain version's steps); its attention output, whose
    f32 sums run in another order (K9's), within QUANT_FLIPS as int8 at one
    split and SPLIT_ATT_FLIPS at more, its scales and dequantized values
    within K6_TOL.  Timed calls rotate through
    the layers, so the weights come cold from device memory; K12 also by
    the trace's device ms.  K12's cache rows at and past each pos are
    poisoned (``_poison``)."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import attention as tatt

    cfg = LLAMA2_7B
    L, D, H, KVH, hd, S = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_kv_heads, \
        cfg.head_dim, cfg.seq_len
    QO = D + 2 * KVH * hd
    gen = torch.Generator(device="cuda").manual_seed(12)
    (wo, w13, w2, wqkv), (rf, ra) = _layer_weights(torch, tq, gen, L, D, H, QO)
    wbytes = {n: w.q[0].numel() + 4 * w.s[0].numel()
              for n, w in (("wo", wo), ("w13", w13), ("w2", w2), ("wqkv", wqkv))}
    int8_ops = 2 * (D * D + D * 2 * H + H * D + D * QO)  # per row, all four products

    def rows(B):
        x = torch.randn(B, D, generator=gen, device="cuda")
        attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda", dtype=torch.int8)
        return x, attq, torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005

    # K8: layer 0's qkv product at batch 8 and 32 (phase 4f's decode)
    for M in (8, 32):
        xq = torch.randint(-127, 128, (M, D), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(M, generator=gen, device="cuda") * 0.05
        got = tfl.w8a8_matmul_stacked(xq, sx, wqkv, 0)
        torch.cuda.synchronize()
        want = tfl.w8a8_matmul_stacked_plain(xq, sx, wqkv, 0)
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"K8 M={M} {D}x{QO}: max err {err}")
        ms = cuda_ms(torch, lambda i: tfl.w8a8_matmul_stacked(xq, sx, wqkv, i % L), 50)
        plain_ms = cuda_ms(torch, lambda i: tfl.w8a8_matmul_stacked_plain(xq, sx, wqkv, i % L),
                           5)
        # the library call: torch._int_mm on the layer's view plus the
        # scales, rows padded to 32 as for K1
        xl = torch.nn.functional.pad(xq, (0, 0, 0, 32 - M))
        sxl = torch.nn.functional.pad(sx, (0, 32 - M))

        def lib(i):
            w = wqkv.layer(i % L)
            return torch._int_mm(xl, w.q.t()).float() * sxl[:, None] * w.s[None, :]

        try:
            library_ms = cuda_ms(torch, lib, 50)
        except RuntimeError as e:  # an _int_mm shape this build refuses
            print(f"K8 library call unavailable: {e}", file=sys.stderr)
            library_ms = None
        b_ms, by = bound_ms(M * D + 4 * M + wbytes["wqkv"] + 4 * M * QO, M * 2 * D * QO, "int8")
        results.append(dict(kernel="K8", name=f"K8 w8a8_matmul_stacked M={M} {D}x{QO} layer 0",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=by, library_ms=library_ms))

    # K11 at batch 8 (its one-tile instantiation) and 32 (the four-tile one,
    # phase 4f's decode), layer 17 and the last layer
    for B in (8, 32):
        x, attq, satt = rows(B)
        for layer in (17, L - 1):
            last = layer == L - 1
            args = (x, attq, satt, wo, w13, w2, wqkv, rf, ra)
            got = tfl.fused_layer_linear(*args, layer, L)
            torch.cuda.synchronize()
            want = tfl.fused_layer_linear_plain(*args, layer, L)
            pairs = [(got[0], want[0])] + ([] if last else [(got[1], want[1])])
            err = max((a - b).abs().max().item() for a, b in pairs)
            label = f"K11 fused_layer_linear B={B} layer {layer}" + (" (last)" if last else "")
            check(all(torch.equal(a, b) for a, b in pairs), f"{label}: max err {err}")
            layers = [layer] if last else [(layer + i) % (L - 1) for i in range(8)]
            def run(i, layers=layers):
                return tfl.fused_layer_linear(*args, layers[i % len(layers)], L)

            ms = cuda_ms(torch, run, 20)
            dev_ms = device_ms(torch, run, 16)
            plain_ms = cuda_ms(torch, lambda i: tfl.fused_layer_linear_plain(
                *args, layers[i % len(layers)], L), 3, warmup=1)
            nbytes = (B * D * (4 + 1 + 4) + 4 * B + wbytes["wo"] + wbytes["w13"] + wbytes["w2"]
                      + 2 * D * 2 + (0 if last else wbytes["wqkv"] + 2 * D + 4 * B * QO))
            b_ms, by = bound_ms(nbytes, B * (int8_ops - (2 * D * QO if last else 0)), "int8")
            print(f"  {label}: {ms:.4f} ms, device {dev_ms:.4f} (bound {b_ms:.4f})", flush=True)
            results.append(dict(kernel="K11", name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                                device_ms=dev_ms))

    # K12: layer 17 at batch 8 and 1, then the last layer at batch 8; the
    # trailing cells at their split rule (fused_splits) and at one split
    for B, pos, layer in ((8, DECODE_POS, 17), (1, [511], 17), (1, [2047], 17),
                          (8, DECODE_POS, L - 1)):
        last = layer == L - 1
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                  for _ in range(2)]
        _poison(*cache, *scales, pos)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ang = torch.rand(B, hd // 2, generator=gen, device="cuda") * 6.3
        x, attq, satt = rows(B)
        args = (x, attq, satt, cache[0], cache[1], scales[0], scales[1], pt, ang.cos(),
                ang.sin(), wo, w13, w2, wqkv, rf, ra)
        rule = tfs.fused_splits(B, KVH, tatt._dma_block(S, None), S)
        for n in [rule] if last or rule == 1 else [rule, 1]:
            got = tfs.fused_step2_layer(*args, layer, L, cfg.n_heads, splits=n)
            torch.cuda.synchronize()
            want = tfs.fused_step2_layer_plain(*args, layer, L, cfg.n_heads, splits=n)
            label = (f"K12 fused_step2_layer B={B} pos={pos[0] if B == 1 else 'mix'} layer "
                     f"{layer}" + (" (last)" if last else f" splits={n}"))
            err = (got[0] - want[0]).abs().max().item()
            check(torch.equal(got[0], want[0]), f"{label}: x_next max err {err}")
            extra = {}
            if not last:
                # the fresh K/V rows: the same steps as the plain version
                reading = _quant_reading(torch, label, [((got[3], got[4]), (want[3], want[4])),
                                                        ((got[5], got[6]), (want[5], want[6]))])
                # the attention output: K9's sums in another order, so its row
                # scales (absmax / 127) are held to K6_TOL as its values are
                d = (got[1].int() - want[1].int()).abs()
                att_flips = (d != 0).float().mean().item()
                flip_limit = QUANT_FLIPS if n == 1 else SPLIT_ATT_FLIPS
                satt_rel = ((got[2] - want[2]).abs() / want[2].abs().clamp_min(1e-30)).max().item()
                att, att_p = (o[1].float() * o[2][:, None] for o in (got, want))
                att_err = (att - att_p).abs().max().item()
                peak = att_p.abs().max().item()
                check(d.max().item() <= 1 and att_flips <= flip_limit and satt_rel <= K6_TOL
                      and att_err <= K6_TOL * peak,
                      f"{label}: attention output: int8 up to {d.max().item()} steps on "
                      f"{att_flips} of entries, scales {satt_rel} apart, dequantized err "
                      f"{att_err} (limits {flip_limit}, K6_TOL {K6_TOL} * {peak})")
                err = max(err, att_err)
                extra = dict(splits=n, int8_flip_share=reading[1], scale_max_rel_err=reading[2],
                             att_int8_flip_share=att_flips, att_scale_max_rel_err=satt_rel)
            layers = [layer] if last else [(layer + i) % (L - 1) for i in range(8)]

            def run(i, n=n):
                return tfs.fused_step2_layer(*args, layers[i % len(layers)], L, cfg.n_heads,
                                             splits=n)

            ms = cuda_ms(torch, run, 20)
            extra["device_ms"] = device_ms(torch, run, 16)
            plain_ms = cuda_ms(torch, lambda i: tfs.fused_step2_layer_plain(
                *args, layers[i % len(layers)], L, cfg.n_heads, splits=n), 3, warmup=1)
            rows_read = 0 if last else KVH * sum(pos)
            nbytes = (B * D * (4 + 1 + 4) + 4 * B + wbytes["wo"] + wbytes["w13"]
                      + wbytes["w2"] + 2 * D * 2
                      + (0 if last else wbytes["wqkv"] + 2 * D + rows_read * (2 * hd + 8)
                         + 4 * B + 4 * B * hd + B * D + 4 * B + B * KVH * (2 * hd + 8)))
            ops = B * (int8_ops - (2 * D * QO if last else 0))
            b_ms, by = bound_ms(nbytes, ops, "int8")
            print(f"  {label}: {ms:.4f} ms, device {extra['device_ms']:.4f} (bound {b_ms:.4f}) "
                  f"{extra}", flush=True)
            results.append(dict(kernel="K12", name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                                **extra))
        del cache, scales, args, got, want
        torch.cuda.empty_cache()
    del wo, w13, w2, wqkv
    torch.cuda.empty_cache()


def _att_reading(torch, label, got, want, split=False):
    """Holds a quantized attention output (int8 [B, D], f32 scales [B]) to
    its plain version at K12's limits, with room for one flipped entry: its
    f32 sums run in another order (K9's), which can move a value across an
    int8 rounding boundary -- one step on at most QUANT_FLIPS of entries, or
    on one entry where that share is less than one (batch 1's 4096 entries;
    seen on an H100 at B1 pos 2047), each flipped entry within one step of
    its row's scale plus K6_TOL of max |value|, the others within K6_TOL of
    it, the scales within K6_TOL.  With ``split`` (the trailing cells at
    more than one split) the share of flipped entries is SPLIT_ATT_FLIPS,
    K12's limit at that count, in place of QUANT_FLIPS.  Returns (max
    dequantized error, flip share, max relative scale error)."""
    (q, sc), (qp, scp) = got, want
    d = (q.int() - qp.int()).abs()
    n_flips = int((d != 0).sum().item())
    flip_limit = SPLIT_ATT_FLIPS if split else QUANT_FLIPS
    s_rel = ((sc - scp).abs() / scp.abs().clamp_min(1e-30)).max().item()
    diff = (q.float() * sc[:, None] - qp.float() * scp[:, None]).abs()
    peak = (qp.float() * scp[:, None]).abs().max().item()
    beyond = torch.where(d != 0, (diff - sc[:, None]).clamp_min(0), diff).max().item()
    err = diff.max().item()
    check(d.max().item() <= 1 and n_flips <= max(1.0, flip_limit * d.numel())
          and s_rel <= K6_TOL and beyond <= K6_TOL * peak,
          f"{label}: attention output: int8 up to {d.max().item()} steps on {n_flips} of "
          f"{d.numel()} entries, scales {s_rel} apart, dequantized err {err} ({beyond} past "
          f"a flipped entry's step; limits {flip_limit}, K6_TOL {K6_TOL} * {peak})")
    return err, n_flips / d.numel(), s_rel


def check_mega_kernels(torch, tq, tfl, tfs, tfs3, tfst, tatt, results):
    """K26 and K27 at 7B width on a 32-layer stack, the K12 shapes: batch 8
    (one slot at each of DECODE_POS) and batch 1 (pos 511, 2047), and the
    last layer (pair) at batch 8; cache rows at and past each pos poisoned.
    K26 on the pair (16, 17) and the last pair (30, 31), its trailing cells
    at their split rule (``fused_splits``) and at one split: bit-equal to two
    chained K12 launches at the same splits (every output); timed by events
    and by the trace's device ms; against its plain version layer by
    layer, as check_fused holds K12 -- K12's plain version of layer l0, then
    of layer l0 + 1 on the seam the first half left (a seam int8 that K9's
    sum order flipped would otherwise move the whole next layer) -- x_next
    bit-equal, the fresh K/V rows within
    QUANT_FLIPS / QUANT_SCALE_RTOL, the seam's and the last attention
    output at K12's limits with room for one flipped entry
    (``_att_reading``).  K27 on layer 17 and the last layer, its cells at
    their split rule (``fused_splits``) and at one split: its quantized
    attention output (``att_out``) at K12's limits of the plain version's
    at the same splits (SPLIT_ATT_FLIPS past one split, QUANT_FLIPS at
    one), its linear outputs bit-equal to K11's phases
    (``linear_phases_plain``) run on that output, and every output bit-equal
    to K9 at the same splits, K2 and K11 launched in turn; timed at the rule
    by events and by the trace's device ms.  Timed calls rotate through the
    layers, so the weights come cold."""
    from tpu_llama_torch.config import LLAMA2_7B

    cfg = LLAMA2_7B
    L, D, H, KVH, hd, S = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.n_kv_heads, \
        cfg.head_dim, cfg.seq_len
    NH, QO = cfg.n_heads, D + 2 * KVH * hd
    gen = torch.Generator(device="cuda").manual_seed(26)
    (wo, w13, w2, wqkv), (rf, ra) = _layer_weights(torch, tq, gen, L, D, H, QO)
    ws = (wo, w13, w2, wqkv)
    wbytes = {n: w.q[0].numel() + 4 * w.s[0].numel()
              for n, w in (("wo", wo), ("w13", w13), ("w2", w2), ("wqkv", wqkv))}
    int8_ops = 2 * (D * D + D * 2 * H + H * D + D * QO)  # per row, all four products

    def layer_bytes(B, with_qkv, rows_read):
        """One layer's weights and rms rows, and with the next qkv its
        weights, the cache rows read and the fresh rows written."""
        n = wbytes["wo"] + wbytes["w13"] + wbytes["w2"] + 2 * D * 2
        if with_qkv:
            n += wbytes["wqkv"] + 2 * D + rows_read * (2 * hd + 8) + B * KVH * (2 * hd + 8)
        return n

    for B, pos, l0 in ((8, DECODE_POS, 16), (1, [511], 16), (1, [2047], 16),
                       (8, DECODE_POS, L - 2)):
        last = l0 + 2 == L
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                  for _ in range(2)]
        _poison(*cache, *scales, pos)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ang = torch.rand(B, hd // 2, generator=gen, device="cuda") * 6.3
        x = torch.randn(B, D, generator=gen, device="cuda")
        attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda", dtype=torch.int8)
        satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005
        rest = (cache[0], cache[1], scales[0], scales[1], pt, ang.cos(), ang.sin(), *ws, rf, ra)
        rule = tfs.fused_splits(B, KVH, tatt._dma_block(S, None), S)
        for n in [rule] if rule == 1 else [rule, 1]:
            kw = dict(splits=n)
            label = (f"K26 fused_step3_pair B={B} pos={pos[0] if B == 1 else 'mix'} layers "
                     f"{l0}, {l0 + 1}" + (" (last pair)" if last else "") + f" splits={n}")
            got = tfs3.fused_step3_pair(x, attq, satt, *rest, l0, L, NH, **kw)
            torch.cuda.synchronize()
            one = tfs.fused_step2_layer(x, attq, satt, *rest, l0, L, NH, **kw)
            two = tfs.fused_step2_layer(*one[:3], *rest, l0 + 1, L, NH, **kw)
            torch.cuda.synchronize()
            chained = (two[0], two[1], two[2], one[3:], two[3:])
            same = [torch.equal(got[0], chained[0])] + [
                torch.equal(a, b) for a, b in zip(got[3], chained[3])]
            if not last:
                same += [torch.equal(got[1], chained[1]), torch.equal(got[2], chained[2])] + [
                    torch.equal(a, b) for a, b in zip(got[4], chained[4])]
            check(all(same), f"{label}: differs from two chained K12 launches ({same})")
            # against the plain version, one layer at a time: K12's plain version
            # of layer l0, then of layer l0 + 1 on the seam (K26's first half,
            # which the chained launches expose), each held to K12's limits
            want1 = tfs.fused_step2_layer_plain(x, attq, satt, *rest, l0, L, NH, **kw)
            want2 = tfs.fused_step2_layer_plain(*one[:3], *rest, l0 + 1, L, NH, **kw)
            err = (got[0] - want2[0]).abs().max().item()
            check(torch.equal(one[0], want1[0]) and torch.equal(got[0], want2[0]),
                  f"{label}: x_next max err {err} against the plain version")
            row_pairs = [((got[3][0], got[3][1]), (want1[3], want1[4])),
                         ((got[3][2], got[3][3]), (want1[5], want1[6]))]
            a_err, a_flips, a_rel = _att_reading(torch, label + " (seam)", one[1:3], want1[1:3],
                                                 split=n > 1)
            err = max(err, a_err)
            extra = dict(splits=n, att_int8_flip_share=a_flips, att_scale_max_rel_err=a_rel)
            if not last:
                row_pairs += [((got[4][0], got[4][1]), (want2[3], want2[4])),
                              ((got[4][2], got[4][3]), (want2[5], want2[6]))]
                a_err, a_flips, a_rel = _att_reading(torch, label, got[1:3], want2[1:3],
                                                     split=n > 1)
                err = max(err, a_err)
                extra.update(att_int8_flip_share=max(a_flips, extra["att_int8_flip_share"]),
                             att_scale_max_rel_err=max(a_rel, extra["att_scale_max_rel_err"]))
            reading = _quant_reading(torch, label, row_pairs)
            extra.update(int8_flip_share=reading[1], scale_max_rel_err=reading[2])
            pairs = [l0] if last else [2 * ((l0 // 2 + i) % (L // 2 - 1)) for i in range(8)]

            def run(i, kw=kw):
                return tfs3.fused_step3_pair(x, attq, satt, *rest, pairs[i % len(pairs)], L, NH,
                                             **kw)

            ms = cuda_ms(torch, run, 20)
            extra["device_ms"] = device_ms(torch, run, 8)
            plain_ms = cuda_ms(torch, lambda i: tfs3.fused_step3_pair_plain(
                x, attq, satt, *rest, pairs[i % len(pairs)], L, NH, **kw), 3, warmup=1)
            io = B * D * (4 + 1 + 4) + 4 * B + 4 * B + 4 * B * hd  # x, attq, x_next, satt, pos, rope
            nbytes = (io + layer_bytes(B, True, KVH * sum(pos))
                      + layer_bytes(B, not last, KVH * sum(pos)) + (0 if last else B * D + 4 * B))
            ops = B * (2 * int8_ops - (2 * D * QO if last else 0))
            b_ms, by = bound_ms(nbytes, ops, "int8")
            print(f"  {label}: {ms:.4f} ms, device {extra['device_ms']:.4f} (bound {b_ms:.4f}) "
                  f"{extra}", flush=True)
            results.append(dict(kernel="K26", name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                                **extra))

        # K27 on layer l0 + 1 (17, or the last layer) of the same cache, its
        # cells at their split rule (fused_splits) and at one split; timed at
        # the rule
        layer = l0 + 1
        lastl = layer == L - 1
        q = torch.randn(B, KVH, 1, hd, generator=gen, device="cuda")
        nk, nv = (torch.randint(-127, 128, (B, KVH, hd), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        nks, nvs = (torch.rand(B, KVH, generator=gen, device="cuda") * 0.03 + 0.01
                    for _ in range(2))
        args = (x, q, nk, nv, nks, nvs, *cache, *scales, pt, *ws, rf, ra)
        for n in [rule] if rule == 1 else [rule, 1]:
            label = (f"K27 fused_step_layer B={B} pos={pos[0] if B == 1 else 'mix'} layer "
                     f"{layer}" + (" (last)" if lastl else "") + f" splits={n}")
            att_k = (torch.empty(B, D, dtype=torch.int8, device="cuda"),
                     torch.empty(B, device="cuda"))
            got = tfst.fused_step_layer(*args, layer, L, att_out=att_k, splits=n)
            torch.cuda.synchronize()
            att_p = (torch.empty_like(att_k[0]), torch.empty_like(att_k[1]))
            tfst.fused_step_layer_plain(*args, layer, L, att_out=att_p, splits=n)
            err, a_flips, a_rel = _att_reading(torch, label, att_k, att_p, split=n > 1)
            views = tfl.layer_views(*ws, rf, ra, layer, L)
            lin = tfl.linear_phases_plain(x, att_k[0], att_k[1], *views, last=lastl)
            same = [torch.equal(got[0], lin[0])] + ([] if lastl else [torch.equal(got[1], lin[1])])
            check(all(same), f"{label}: the linear outputs differ from K11's phases on the "
                             f"kernel's attention output ({same})")
            att9 = tatt.flash_decode_attention_dma(q, cache[0], cache[1], pt, nk, nv, scales[0],
                                                   scales[1], nks, nvs, layer=layer, splits=n)
            q2, s2 = tq.quantize_activations(att9.reshape(B, D))
            comp = tfl.fused_layer_linear(x, q2, s2, *ws, rf, ra, layer, L)
            torch.cuda.synchronize()
            same = [torch.equal(att_k[0], q2), torch.equal(att_k[1], s2),
                    torch.equal(got[0], comp[0])]
            same += [] if lastl else [torch.equal(got[1], comp[1])]
            check(all(same), f"{label}: differs from K9 (same splits), K2 and K11 launched in "
                             f"turn ({same})")
            if n != rule:
                print(f"  {label}: held (attention int8 flips {a_flips})", flush=True)
                continue
            layers = [layer] if lastl else [(layer + i) % (L - 1) for i in range(8)]

            def run(i, n=n):
                return tfst.fused_step_layer(*args, layers[i % len(layers)], L, splits=n)

            ms = cuda_ms(torch, run, 20)
            dev_ms = device_ms(torch, run, 8)
            plain_ms = cuda_ms(torch, lambda i: tfst.fused_step_layer_plain(
                *args, layers[i % len(layers)], L, splits=n), 3, warmup=1)
            nbytes = (B * D * (4 + 4) + 4 * B * D + B * KVH * (2 * hd + 8) + 4 * B
                      + KVH * sum(pos) * (2 * hd + 8) + wbytes["wo"] + wbytes["w13"]
                      + wbytes["w2"] + 2 * D * 2 + (0 if lastl else wbytes["wqkv"] + 4 * B * QO))
            ops = B * (int8_ops - (2 * D * QO if lastl else 0))
            b_ms, by = bound_ms(nbytes, ops, "int8")
            print(f"  {label}: {ms:.4f} ms, device {dev_ms:.4f} (bound {b_ms:.4f})", flush=True)
            results.append(dict(kernel="K27", name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                                device_ms=dev_ms, splits=n, att_int8_flip_share=a_flips,
                                att_scale_max_rel_err=a_rel))
        del cache, scales, rest, args, got, want1, want2, one, two, chained
        torch.cuda.empty_cache()
    del wo, w13, w2, wqkv, ws
    torch.cuda.empty_cache()


def check_k28(torch, tatt, results):
    """K28 on INT8, f32 and bf16 caches [8, 8, 32, 2048, 128], layer 5, at
    batch 8: slot 0 parked at position 0, slot 6 at pos S (skipped), the
    others at DECODE_POS; bit-equal to its plain version, the skipped slot
    untouched.  Repeated calls rotate through the layers and other rows.
    The library call is one indexed write per array of the rows already
    cast (fp) or quantized (INT8: values and scales, four arrays)."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    L, B, KVH, S, hd, layer = 8, 8, 32, 2048, 128, 5
    pos = [0, 1, 127, 128, 511, 1000, S, 2047]
    pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ok = [b for b, p in enumerate(pos) if 0 <= p < S]
    for dtype in (torch.int8, torch.float32, torch.bfloat16):
        int8 = dtype == torch.int8
        kernel = "K28" if int8 else f"K28:{_sfx(dtype)}"
        if int8:
            cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                                   dtype=torch.int8) for _ in range(2)]
            cache += [torch.rand(L, B, KVH, S, generator=gen, device="cuda") for _ in range(2)]
        else:
            cache = [torch.randn(L, B, KVH, S, hd, generator=gen, device="cuda").to(dtype)
                     for _ in range(2)]
        copies = 8
        rows = [(torch.randn(B, KVH, hd, generator=gen, device="cuda") * 3,
                 torch.randn(B, KVH, hd, generator=gen, device="cuda") * 3)
                for _ in range(copies)]
        rows[0][0][1, 2] = 0.0  # a zero row: scale 0
        ref = [c.clone() for c in cache]
        skipped = [c[:, 6].clone() for c in cache]
        tatt.kv_cache_write_decode(*rows[0], pt, layer, *cache)
        torch.cuda.synchronize()
        tatt.kv_cache_write_decode_plain(*rows[0], pt, layer, *ref)
        label = (f"K28 kv_cache_write_decode {'int8' if int8 else _sfx(dtype)} cache L={L} "
                 f"B={B} S={S}")
        check(all(torch.equal(a, b) for a, b in zip(cache, ref)), f"{label}: cache differs")
        check(all(torch.equal(c[:, 6], s_) for c, s_ in zip(cache, skipped)),
              f"{label}: the slot at pos S was written")
        del ref, skipped

        def run(i, fn=tatt.kv_cache_write_decode):
            fn(*rows[i % copies], pt, (layer + i) % L, *cache)

        ms = cuda_ms(torch, run, 50)
        plain_ms = cuda_ms(torch, lambda i: run(i, tatt.kv_cache_write_decode_plain), 10)
        if int8:  # the rows quantized ahead: K28's quant has no one library call
            cast = [(*tatt.quantize_kv(k), *tatt.quantize_kv(v)) for k, v in rows]
            cast = [(kq, vq, kss, vss) for kq, kss, vq, vss in cast]
        else:
            cast = [(k.to(dtype), v.to(dtype)) for k, v in rows]
        okt = torch.tensor(ok, device="cuda")
        ix = (okt[:, None], torch.arange(KVH, device="cuda")[None, :],
              torch.tensor([pos[b] for b in ok], device="cuda")[:, None])

        def lib(i):
            lay = (layer + i) % L
            for c, r in zip(cache, cast[i % copies]):
                c[lay][ix] = r[okt]

        library_ms = cuda_ms(torch, lib, 50)
        el = cache[0].element_size()
        nbytes = 2 * B * KVH * hd * 4 + 4 * B + 2 * len(ok) * KVH * (hd * el + 4 * int8)
        b_ms, by = bound_ms(nbytes, 0, "f32")
        results.append(dict(kernel=kernel, name=label, max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                            library_ms=library_ms))
        del cache, rows
        torch.cuda.empty_cache()


def check_k29(torch, tq, tm, results):
    """K29 at the 8 x 512 admission's M = 4096 on K1's four 7B shapes and
    the fused wqkv and w13 (bf16 out), the two residual shapes (wo, w2),
    and the fused layer's wqkv and w2 at M 1000 and 2048: bit-equal to K1's
    kernel and to its plain version (K1's), at the cluster size the wrapper
    picks and at every other (1, 2, 4, 8).  Each row times every cluster
    size and reads, for each, the bytes that leave L2 (the weights once per
    cluster of m-blocks, x once), their rate and the clusters the card keeps
    resident at once; the row's ``ms`` is the picked size's.  Timed calls
    rotate through weight copies past L2; the library call is
    ``torch._int_mm`` plus the scales."""
    from tpu_llama_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(29)
    cases = [(4096, k, n, False) for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                                              (4096, 32000), (4096, 12288), (4096, 22016))]
    cases += [(4096, 4096, 4096, True), (4096, 11008, 4096, True)]
    cases += [(m, k, n, res) for m in (1000, 2048)
              for k, n, res in ((4096, 12288, False), (11008, 4096, True))]
    for m, k, n, with_res in cases:
        copies = n_copies(n * k)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=gen, device="cuda") * 0.05
        ws = [tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8),
            s=torch.full((n,), 2e-4, device="cuda")) for _ in range(copies)]
        res = (torch.randn(m, n, generator=gen, device="cuda") * 4).to(torch.bfloat16) \
            if with_res else None
        label = f"K29 w8a8_rows_resident M={m} K={k} N={n}" + (" +residual" if with_res else "")
        plan = tm.rows_resident_plan(k)
        picked = tm.rows_resident_cluster(m, plan.bm)
        k1 = tm.launch_w8a8("K1", xq, sx, ws[0], torch.bfloat16, res)
        want = tm.w8a8_matmul_prequant_plain(xq, sx, ws[0], out_dtype=torch.bfloat16,
                                             residual=res)
        err, cluster_ms, l2_gb, l2_rate = 0.0, {}, {}, {}
        resident = {c: _kernels.k29_max_clusters(k, c) for c in tm.RESIDENT_CLUSTERS}
        for c in tm.RESIDENT_CLUSTERS:
            got = tm.w8a8_rows_resident(xq, sx, ws[0], out_dtype=torch.bfloat16, residual=res,
                                        cluster=c)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            check(torch.equal(got, want) and torch.equal(got, k1),
                  f"{label} cluster {c}: max err {e} against its plain version, equal to K1: "
                  f"{torch.equal(got, k1)}")
            err = max(err, e)
            cluster_ms[c] = cuda_ms(torch, lambda i, c=c: tm.w8a8_rows_resident(
                xq, sx, ws[i % copies], out_dtype=torch.bfloat16, residual=res, cluster=c), 20)
            nm, _ = tm.rows_resident_grid(m, n, plan, c)
            l2_gb[c] = (nm // c * n * k + m * k) / 1e9
            l2_rate[c] = l2_gb[c] / (cluster_ms[c] * 1e-3)
            del got
        ms = cluster_ms[picked]
        plain_ms = cuda_ms(torch, lambda i: tm.w8a8_matmul_prequant_plain(
            xq, sx, ws[i % copies], out_dtype=torch.bfloat16, residual=res), 3, warmup=1)

        def lib(i):
            w = ws[i % copies]
            out = (torch._int_mm(xq, w.q.t()).float() * sx[:, None] * w.s[None, :]).to(
                torch.bfloat16)
            return out if res is None else res + out

        try:
            library_ms = cuda_ms(torch, lib, 20)
        except RuntimeError as e:  # an _int_mm shape this build refuses
            print(f"K29 library call unavailable: {e}", file=sys.stderr)
            library_ms = None
        nbytes = m * k + 4 * m + n * k + 4 * n + 2 * m * n * (2 if with_res else 1)
        b_ms, by = bound_ms(nbytes, 2 * m * k * n, "int8")
        results.append(dict(kernel="K29", name=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                            int8_peak_share=int8_peak_share(m, k, n, ms), cluster=picked,
                            rows=plan.bm, consumers=plan.consumers, cluster_ms=cluster_ms,
                            l2_gb=l2_gb, l2_gb_s=l2_rate, resident_clusters=resident))
        del ws, xq, want, k1, res
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the tensor-parallel decode's kernels (K21, K23, K24) at the local
# shapes of 7B for tp in TP_SIZES
# ---------------------------------------------------------------------------
TP_SIZES = (1, 2, 4, 8)


def _sdpa_k21_ms(torch, q, k, v, ks, vs, pos, layers, copies):
    """K21's library yardstick: scaled_dot_product_attention on the layer's
    dequantized (INT8) or upcast (fp) cache in bf16 with the mask s <= pos,
    as K22's row has it: (event ms, device ms from a trace)."""
    import torch.nn.functional as F

    B, KVH, G, hd = q[0].shape
    S = k.shape[3]
    deq = []
    for i in range(copies):
        kd, vd = k[layers[i]].float(), v[layers[i]].float()
        if ks is not None:
            kd, vd = kd * ks[layers[i]][..., None], vd * vs[layers[i]][..., None]
        deq.append((q[i].to(torch.bfloat16).reshape(B, KVH * G, 1, hd), kd.to(torch.bfloat16),
                    vd.to(torch.bfloat16)))
        del kd, vd
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
    kw = dict(enable_gqa=True) if G > 1 else {}

    def lib(i):
        return F.scaled_dot_product_attention(*deq[i % copies], attn_mask=mask, **kw)

    try:
        return cuda_ms(torch, lib, 50), device_ms(torch, lib, 20)
    except (TypeError, RuntimeError) as e:
        print(f"K21 library call unavailable: {e}", file=sys.stderr)
        return None, None


def check_tp_kernels(torch, tatt, tq, tfl, results):
    """K21, K23 and K24 against their plain versions at the local shapes of
    7B under tensor parallelism, tp in TP_SIZES: KVH = 32 / tp kv heads of
    head_dim 128 over a 2048-row cache, Hl = 11008 / tp hidden columns,
    QOl = 12288 / tp qkv columns, at batch 8 (one slot at each of
    DECODE_POS) and 32 (DECODE_POS32); at batch 8 and tp 1 and 2 also at
    the slots and positions of phase 4i's unfused TP decode (TP_PROMPT_LENS
    plus each step, the other slots at 0).  K21 in both forms (one key block,
    the TP decode's; blocks of 128 rows) on INT8 (bf16 queries, within
    K6_TOL), f32 and bf16 caches (f32 queries, within FP_TOL), every row
    past each slot's pos poisoned, the single-pass form under the rule's
    count of splits (``norm_splits``) and at one where the rule splits,
    with its cell's residency and the trace's device ms beside SDPA's; K23
    and K24 (the streaming body's phases B-C and D, fused_step2.cuh) bit-equal
    (K11's arithmetic), each shape's trace device ms beside its events.
    Timed calls rotate through layers (and K21 through query sets) so the
    data comes cold from device memory; the library call of K21 is SDPA on
    the dequantized layer."""
    from tpu_llama_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(21)
    S, hd, D, H, QO = 2048, 128, 4096, 11008, 12288
    for tp, B, (dt, name) in itertools.product(
            TP_SIZES, (8, 32), ((torch.int8, "int8"), (torch.float32, "f32"),
                                (torch.bfloat16, "bf16"))):
        KVH, pos = 32 // tp, DECODE_POS if B == 8 else DECODE_POS32
        int8 = dt == torch.int8
        es = torch.tensor([], dtype=dt).element_size()
        rows = KVH * sum(p + 1 for p in pos)  # cache rows the function reads
        row_bytes = 2 * hd * es + (8 if int8 else 0)
        copies = n_copies(rows * row_bytes)
        L = copies + 1
        shape = (L, B, KVH, S, hd)

        def make_cache():
            if int8:
                k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8) for _ in range(2))
                ks, vs = (torch.rand(shape[:-1], generator=gen, device="cuda") * 0.03 + 0.01
                          for _ in range(2))
                return k, v, ks, vs
            k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(2))
            return k, v, None, None

        def poison(pos):  # rows past pos poisoned (K21 reads s <= pos)
            for b, p in enumerate(pos):
                for a, val in ((k, 127 if int8 else 1e4), (v, 127 if int8 else 1e4), (ks, 1e4),
                               (vs, 1e4)):
                    if a is not None:
                        a[:, b, :, p + 1:] = val

        k, v, ks, vs = make_cache()
        poison(pos)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        layers = list(range(1, L))
        qdt = torch.bfloat16 if int8 else torch.float32
        q = [torch.randn(B, KVH, 1, hd, generator=gen, device="cuda").to(qdt)
             for _ in range(copies)]
        library_ms, library_dev = _sdpa_k21_ms(torch, q, k, v, ks, vs, pt, layers, copies)
        nbytes = rows * row_bytes + B * KVH * hd * (q[0].element_size() + 4) + 4 * B
        b_ms, by = bound_ms(nbytes, 4 * hd * rows, "bf16" if int8 else "f32")
        kid = "K21" if int8 else f"K21:{name}"
        tol = K6_TOL if int8 else FP_TOL
        ts = tatt._norm_block(S, es)
        forms = [(None, n, "single-pass") for n in norm_variants(tatt, B, KVH, ts, S)]
        for block_s, n, form in forms + [(128, None, "blocked")]:
            def run(i, f=tatt.flash_decode_attention, bs=block_s, kw=dict(splits=n)):
                j = i % copies
                return f(q[j], k, v, pt, ks, vs, block_s=bs, layer=layers[j], **kw)

            got = run(0)
            torch.cuda.synchronize()
            want = run(0, tatt.flash_decode_attention_plain)
            err = (got - want).abs().max().item()
            peak = want.abs().max().item()
            label = f"{kid} {form} tp={tp} B={B} KVH={KVH} {name}" + \
                ("" if n is None else f" splits={n}")
            check(err <= tol * peak, f"{label}: err {err} > {tol} * {peak}")
            ms = cuda_ms(torch, run, 30)
            plain_ms = cuda_ms(torch, lambda i: run(i, tatt.flash_decode_attention_plain), 3,
                               warmup=1)
            extra = {} if n is None else dict(
                splits=n, **norm_residency(_kernels, "K21", dt, 1, hd, S, ts, n),
                device_ms=device_ms(torch, run), library_device_ms=library_dev)
            print(f"  {label}: {ms:.4f} ms (SDPA {library_ms}, bound {b_ms:.4f}) {extra}",
                  flush=True)
            # the kernels line carries the TP decode's form (single-pass INT8) at
            # every shape and the others at tp = 1; every reading prints in phase 3
            results.append(dict(kernel=kid, name=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                library_ms=library_ms, **extra,
                                in_line=tp == 1 or (int8 and block_s is None)))
        if B == 8 and tp in (1, 2):  # 4i's unfused TP decode: its slots and positions
            del k, v, ks, vs  # over a fresh cache, rows past each step's positions
            k, v, ks, vs = make_cache()  # poisoned (the last step's first)
            worst = 0.0
            for step in reversed(range(TP_PROBE_STEPS if int8 else TP_FP_STEPS)):
                p4 = [n + step for n in TP_PROMPT_LENS] + [0] * (B - len(TP_PROMPT_LENS))
                poison(p4)
                for block_s in (None, 128):
                    args = (q[0], k, v, torch.tensor(p4, dtype=torch.int32, device="cuda"), ks,
                            vs)
                    got = tatt.flash_decode_attention(*args, block_s=block_s, layer=layers[0])
                    want = tatt.flash_decode_attention_plain(*args, block_s=block_s,
                                                             layer=layers[0])
                    err = (got - want).abs().max().item() / want.abs().max().item()
                    check(err <= tol, f"{kid} tp={tp} 4i slots step {step} block {block_s}: "
                                      f"err {err} of peak > {tol}")
                    worst = max(worst, err)
            print(json.dumps(dict(kernel=kid, name=f"{kid} tp={tp} B={B} {name} at 4i's slots "
                                                    f"and positions, both forms",
                                  max_err_of_peak=worst, tol=tol)), flush=True)
        del k, v, ks, vs, q
        torch.cuda.empty_cache()

    # K23 and K24: four layers of the local weights (timed calls rotate)
    Lw = 4
    for tp in TP_SIZES:
        Hl, QOl = H // tp, QO // tp
        (_, w13, w2, wqkv), (rf, ra) = _layer_weights(torch, tq, gen, Lw, D, Hl, QOl)
        for B in (8, 32):
            x = torch.randn(B, D, generator=gen, device="cuda")
            for kid, fn, plain, args, wb, ops, out_w in (
                    ("K23", tfl.fused_ffn_stacked, tfl.fused_ffn_stacked_plain,
                     (x, w13, w2, rf), 3 * Hl * D + 4 * (2 * Hl + D), 2 * 3 * Hl * D, D),
                    ("K24", tfl.fused_rms_qkv_stacked, tfl.fused_rms_qkv_stacked_plain,
                     (x, wqkv, ra), QOl * D + 4 * QOl, 2 * QOl * D, QOl)):
                got = fn(*args, 1)
                torch.cuda.synchronize()
                want = plain(*args, 1)
                err = (got - want).abs().max().item()
                label = f"{kid} tp={tp} B={B} D={D} " + (f"Hl={Hl}" if kid == "K23" else
                                                          f"QOl={QOl}")
                check(torch.equal(got, want), f"{label}: max err {err}")
                ms = cuda_ms(torch, lambda i: fn(*args, i % Lw), 20)
                dev = device_ms(torch, lambda i: fn(*args, i % Lw))
                plain_ms = cuda_ms(torch, lambda i: plain(*args, i % Lw), 3, warmup=1)
                b_ms, by = bound_ms(B * D * 4 + wb + 2 * D + B * out_w * 4, B * ops, "int8")
                print(f"  {label}: {ms:.4f} ms, device {dev:.4f} ms (bound {b_ms:.4f})",
                      flush=True)
                results.append(dict(kernel=kid, name=label, max_abs_err=err, ms=ms,
                                    device_ms=dev, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=by, library_ms=None, in_line=tp == 1 or B == 8))
        del w13, w2, wqkv
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4-5: the serving path
# ---------------------------------------------------------------------------


def make_requests(Request, vocab: int, logprobs: int = 0):
    rng = np.random.default_rng(0)
    # first admission: 8 prompts (with BOS) spanning the 16..512 buckets, one
    # group at T = 512; two more join when slots free (T = 256 bucket)
    lens = [511, 300, 200, 127, 100, 60, 15, 8, 120, 250]
    reqs = []
    for i, n in enumerate(lens):
        prompt = [int(t) for t in rng.integers(3, vocab, n)]
        temp = 0.0 if i % 2 == 0 else 0.8
        reqs.append(Request(prompt_tokens=prompt, steps=n + 1 + 64, temperature=temp,
                            topp=0.9 if i % 4 == 3 else 1.0, seed=1000 + i, logprobs=logprobs))
    return reqs


def serve_7b(torch, smi_line, params, params_s):
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    t0 = time.time()
    engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    torch.cuda.synchronize()
    setup_s = params_s + time.time() - t0
    reqs = make_requests(Request, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(engine)
    _kernels.reset_counts()  # counts from here on belong to the main path
    t0 = time.time()
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    check(all(r.done for r in reqs), "a request did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
          "served tokens missing or out of vocabulary")
    attn, fused = engine.decode_attn, engine.decode_fused
    groups = check_serve_launches(launches, plain, engine, batcher, "serve_7b")
    rep = summarize(reqs)
    line = dict(phase="serve_7b", layouts="fused", decode_attn=attn, decode_fused=fused,
                admission_groups=groups,
                k2_launches=launches["K2"], n_requests=rep.n_requests,
                tokens=rep.total_tokens,
                wall_s=wall, tok_per_s=rep.tokens_per_sec, ttft_p50_ms=rep.ttft_p50_s * 1e3,
                ttft_p95_ms=rep.ttft_p95_s * 1e3, setup_s=setup_s,
                decode_steps=batcher.timers["decode_steps"],
                decode_ms_per_step=batcher.timers["decode"] * 1e3
                / max(1, batcher.timers["decode_steps"]),
                admit_s=batcher.timers["admit"], emit_s=batcher.timers["emit"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                host_launch_us=host_launch_us(torch),
                launches=launches, plain_calls=plain, card=smi_line)
    print(json.dumps(line), flush=True)
    del engine, batcher
    torch.cuda.empty_cache()
    return launches, [r.out_tokens for r in reqs], line


def check_serve_launches(launches, plain, engine, batcher, label: str) -> int:
    """Hold a serving run's launches to the W8A8 fused path's formula and
    its plain-version calls to none; returns its admission groups.  Per
    admission group and layer the fused body runs K3 twice, K4, K5 and K6
    once, and K1 four times (qkv, wo, w13, w2), K2 only for wo; the
    classifier adds one K2 + K1 per group; each decode step what its
    resolved mode launches (``decode_launches``)."""
    attn, fused = engine.decode_attn, engine.decode_fused
    steps = batcher.timers["decode_steps"]
    L = engine.config.n_layers
    groups = launches["K7"]  # one K7 scatter per admission group
    want = dict(K3=2 * L * groups, K4=L * groups, K5=L * groups, K6=L * groups, K7=groups,
                K1=(4 * L + 1) * groups, K2=(L + 1) * groups)
    for k, n in decode_launches(fused, attn, L).items():
        want[k] = want.get(k, 0) + n * steps
    got = {k: n for k, n in launches.items() if n > 0}
    check(groups > 0 and got == want,
          f"{label}: {groups} admission groups, {steps} decode steps (fused={fused!r}, {attn}): "
          f"want exactly {want}, got {got}")
    check(all(v == 0 for v in plain.values()), f"{label}: plain versions ran: {plain}")
    return groups


def byte_tokenizer(vocab: int):
    """A ``vocab``-entry byte tokenizer (``make_byte_tokenizer``: 3
    specials, 256 bytes, then pads that no text merges into), as
    tests/conftest.py builds its tiny one."""
    from tpu_llama_torch.io.tokenizer import make_byte_tokenizer

    return make_byte_tokenizer([(f"<pad{i}>", -1e5) for i in range(vocab - 259)])


def http_prompts(n: int, seed: int = 0) -> list:
    """``n`` English-like prompts of 15-500 characters (one byte token each
    under ``byte_tokenizer``), spanning the 16..512 buckets."""
    words = ("once upon a time there was a little model that served text on a card and every "
             "request it answered came back token for token the same").split()
    rng = np.random.default_rng(seed)
    lens = [400, 15, 200, 120, 60, 30, 250, 90, 480, 40][:n]
    out = []
    for m in lens:
        text = ""
        while len(text) < m:
            text += (" " if text else "") + str(rng.choice(words))
        out.append(text[:m].capitalize())
    return out


def _http(port: int, path: str, payload=None, stream: bool = False, timeout: float = 300):
    """One request to the local server: JSON back, or a stream's events."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if stream:
            return [json.loads(line) for line in r]
        return json.loads(r.read())


def serve_7b_http(torch, smi_line, params, serve_line):
    """Phase 4j: the text server on phase 4's weights (phase 4's engine
    released): ``Engine(max_batch=8, kv_dtype="int8", seq_len=2048)`` under
    ``LlamaServer(port=0, warmup=True, warmup_max_bucket=512)`` with a
    32000-entry byte tokenizer.  Holds: warmup's buckets [16 .. 512];
    /healthz ok; one greedy /generate equal to a direct
    ``ContinuousBatcher`` run of its encoded prompt on the same engine
    (after ``reset``), token for token; 8 concurrent greedy requests with
    top-2 logprobs each equal to its stream in a direct run of the 8, or
    parting only where the direct run's top-2 gap is within
    PARITY_NEAR_TIE of that step's max |logit| (HTTP arrivals form other
    admission groups); a streamed request's pieces equal to the first
    request's text; a device-sampled request's tokens in the vocabulary;
    /metrics counting every request; the launches of every admission group
    and decode step exactly ``check_serve_launches``' formula, and no plain
    version.  Returns the run's launches."""
    import threading

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime import scheduler as sched
    from tpu_llama_torch.runtime.metrics import summarize
    from tpu_llama_torch.runtime.server import LlamaServer

    cfg = LLAMA2_7B
    tok = byte_tokenizer(cfg.vocab_size)
    prompts = http_prompts(10)
    engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    t0 = time.time()
    srv = LlamaServer(engine, tok, port=0, warmup=True, warmup_max_bucket=512).start()
    warmup_s = time.time() - t0
    check(srv.warmup_buckets == [16, 32, 64, 128, 256, 512],
          f"warmup buckets {srv.warmup_buckets}")
    try:
        health = _http(srv.port, "/healthz")
        check(health.get("ok") is True, f"/healthz: {health}")
        _kernels.reset_counts()  # counts from here on belong to the served requests
        t0 = time.time()
        first = _http(srv.port, "/generate", dict(prompt=prompts[0], steps=len(prompts[0]) + 49,
                                                  temperature=0.0))
        conc = [dict(prompt=p, steps=len(p) + 33, temperature=0.0, logprobs=2)
                for p in prompts[1:9]]
        answers = [None] * len(conc)

        def call(i):
            answers[i] = _http(srv.port, "/generate", conc[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(conc))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads) and all(answers),
              "a concurrent request did not answer")
        events = _http(srv.port, "/generate", dict(prompt=prompts[0], temperature=0.0,
                                                   steps=len(prompts[0]) + 49, stream=True),
                       stream=True)
        sampled = _http(srv.port, "/generate", dict(prompt=prompts[9], steps=len(prompts[9]) + 33,
                                                    temperature=0.8, seed=7,
                                                    device_sampling=True))
        serve_s = time.time() - t0
        launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
        metrics = _http(srv.port, "/metrics")
    finally:
        srv.stop()
    n_req = 1 + len(conc) + 1 + 1
    groups = check_serve_launches(launches, plain, engine, srv.batcher, "serve_7b_http")
    check(metrics["n_requests"] == n_req == len(srv.batcher.finished),
          f"/metrics counts {metrics['n_requests']} requests, want {n_req}")
    pieces = "".join(e["piece"] for e in events if "piece" in e)
    check(events[-1].get("done") is True and pieces == first["text"],
          f"streamed pieces {pieces!r} != the text {first['text']!r}")
    check(len(sampled["tokens"]) > 0 and all(0 <= t < cfg.vocab_size for t in sampled["tokens"]),
          f"device-sampled tokens missing or out of vocabulary: {sampled['tokens']}")
    # the direct runs on the same engine, the server stopped
    engine.reset()
    direct = Request(prompt_tokens=tok.encode(prompts[0]), steps=len(prompts[0]) + 49,
                     temperature=0.0)
    b = ContinuousBatcher(engine)
    b.submit(direct)
    b.run()
    check(first["tokens"] == direct.out_tokens and len(direct.out_tokens) > 0,
          f"/generate {first['tokens']} != the direct run {direct.out_tokens}")
    engine.reset()
    reqs = [Request(prompt_tokens=tok.encode(c["prompt"]), steps=c["steps"], temperature=0.0,
                    logprobs=2) for c in conc]
    peaks = {}
    record = sched._record_logprobs

    def record_peak(logits, token, req):  # each step's max |logit| beside its logprobs
        record(logits, token, req)
        peaks.setdefault(id(req), []).append(float(np.abs(np.asarray(logits)).max()))

    sched._record_logprobs = record_peak
    try:
        b = ContinuousBatcher(engine)
        for r in reqs:
            b.submit(r)
        b.run()
    finally:
        sched._record_logprobs = record
    parted = _streams_parted([a["tokens"] for a in answers], [r.out_tokens for r in reqs],
                             [r.out_top_logprobs for r in reqs])
    # a direct stream that ended (BOS) where the served one went on has no
    # logprobs at that step: its gap is unknown, and the check fails
    partings = [dict(request=i, step=p[0], gap=p[1],
                     gap_share=(p[1] / peaks[id(reqs[i])][p[0]]
                                if p[0] < len(peaks[id(reqs[i])]) else math.inf))
                for i, p in enumerate(parted) if p is not None]
    check(all(p["gap_share"] <= PARITY_NEAR_TIE for p in partings),
          f"concurrent greedy streams part from their direct runs beyond a near tie "
          f"(PARITY_NEAR_TIE {PARITY_NEAR_TIE}): {partings}")
    rep = summarize(srv.batcher.finished)
    line = dict(phase="serve_7b_http", warmup_s=warmup_s, warmup_buckets=srv.warmup_buckets,
                decode_attn=engine.decode_attn, decode_fused=engine.decode_fused,
                n_requests=rep.n_requests, tokens=rep.total_tokens, serve_s=serve_s,
                tok_per_s=rep.tokens_per_sec, ttft_p50_ms=rep.ttft_p50_s * 1e3,
                ttft_p95_ms=rep.ttft_p95_s * 1e3, first_ttft_ms=first["ttft_s"] * 1e3,
                serve_7b_tok_per_s=serve_line["tok_per_s"],
                serve_7b_ttft_p50_ms=serve_line["ttft_p50_ms"],
                serve_7b_ttft_p95_ms=serve_line["ttft_p95_ms"], admission_groups=groups,
                decode_steps=srv.batcher.timers["decode_steps"], partings=partings,
                streams_equal=sum(p is None for p in parted), launches=launches,
                plain_calls=plain, card=smi_line)
    print(json.dumps(line), flush=True)
    del engine, b
    torch.cuda.empty_cache()
    return launches


def long_requests(Request, vocab: int):
    """Wave A: 8 device-sampled prompts of 1100-1950 tokens after BOS (four
    of them at most 1600), 48 new tokens each, temperatures 0, 0.8 with
    top-p 0.9 and 0.8 with top-k 40.  Wave B, for after wave A: four of
    the shorter prompts plus a 64-300-token suffix (prefix hits, one batched
    continuation) and one wave-A prompt unchanged (a whole-prompt hit)."""
    rng = np.random.default_rng(44)
    lens = [int(n) for n in rng.integers(1100, 1601, 4)] + \
        [int(n) for n in rng.integers(1601, 1951, 4)]
    modes = [dict(temperature=0.0), dict(temperature=0.8, topp=0.9),
             dict(temperature=0.8, topk=40)]
    prompts = [[int(t) for t in rng.integers(3, vocab, n)] for n in lens]
    wave_a = [Request(prompt_tokens=p, steps=len(p) + LONG_NEW, seed=2000 + i,
                      device_sampling=True, **modes[i % 3]) for i, p in enumerate(prompts)]
    wave_b = []
    for i in range(4):
        suffix = [int(t) for t in rng.integers(3, vocab, int(rng.integers(64, 301)))]
        p = prompts[i] + suffix
        wave_b.append(Request(prompt_tokens=p, steps=len(p) + LONG_NEW, seed=3000 + i,
                              device_sampling=True, **modes[i % 3]))
    wave_b.append(Request(prompt_tokens=prompts[5], steps=len(prompts[5]) + LONG_NEW,
                          seed=3004, device_sampling=True, **modes[2]))
    return wave_a, wave_b


LONG_NEW = 48  # new tokens per phase-4b request
LONG_CHUNK = 16  # the batcher's max_chunk in phase 4b


def serve_7b_long(torch, smi_line, params):
    """Phase 4b: the long-prompt path at 7B on phase 4's weights.
    ``Engine(max_batch=8, INT8 dense KV, seq_len=2048)`` +
    ``ContinuousBatcher(max_chunk=16, prefix_cache_size=8)``: wave A is one
    admission group of 8 x 2048 rows (> 8192: chunked prefill, 8 chunks of
    256, K18 landing each fused chunk), device sampling with decode chunks
    of up to 16 steps; wave B restores 5 prefixes (4 continuations at
    start_pos > 0 in one ``prefill_continue``, 1 whole-prompt hit).  Every
    kernel must launch exactly as the path requires, no plain version may
    run.  Returns the kernel launches."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    L = cfg.n_layers
    engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    batcher = ContinuousBatcher(engine, max_chunk=LONG_CHUNK, prefix_cache_size=8)
    wave_a, wave_b = long_requests(Request, cfg.vocab_size)
    walls = {"prefill": [], "prefill_continue": [], "snapshot_slot": [], "restore_slot": []}

    def timed(name):  # host wall of the call, closed by a sync
        fn = getattr(engine, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            walls[name].append((time.time() - t0) * 1e3)
            return out
        return call

    for name in walls:
        setattr(engine, name, timed(name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()  # counts from here on belong to this path
    t0 = time.time()
    for wave in (wave_a, wave_b):
        for r in wave:
            batcher.submit(r)
        batcher.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    reqs = wave_a + wave_b
    check(all(r.done for r in reqs), "a long request did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
          "served tokens missing or out of vocabulary")
    check(batcher.prefix_hits == 5, f"prefix hits {batcher.prefix_hits}, want 5")
    check(all(v == 0 for v in plain.values()), f"plain versions ran: {plain}")
    check(len(walls["prefill"]) == 1 and len(walls["prefill_continue"]) == 1,
          f"admissions: {len(walls['prefill'])} prefills, {len(walls['prefill_continue'])} "
          "continuations, want one each")
    steps = batcher.timers["decode_steps"]
    attn, fused = engine.decode_attn, engine.decode_fused
    chunks = 2048 // 256
    # one chunked group: per chunk and layer K3 twice, K1 four times (qkv, wo,
    # w13, w2), K2 once (wo), K4, K5, K6 and K18 once; per chunk the
    # classifier's K2 + K1; one K7.  One continuation group: per layer the
    # start_pos > 0 body's K3 twice, K1 four times, K2, K4, K5 and K6 once,
    # the cache write a plain indexed copy; its classifier's K2 + K1.  Each
    # decode step what its resolved mode launches.
    groups = chunks + 1
    want = dict(K3=2 * L * groups, K1=(4 * L + 1) * groups, K2=(L + 1) * groups,
                K4=L * groups, K5=L * groups, K6=L * groups, K18=L * chunks, K7=1)
    for k, n in decode_launches(fused, attn, L).items():
        want[k] = want.get(k, 0) + n * steps
    got = {k: n for k, n in launches.items() if n > 0}
    check(got == want, f"{steps} decode steps (fused={fused!r}, {attn}): want exactly {want}, "
                       f"got {got}")
    # the continuation's gather and write-back alone, on its 4 slots
    idx = torch.arange(4, device=engine.cache.k.device)

    def gather(_):
        for n in ("k", "v", "ks", "vs"):
            c = getattr(engine.cache, n)
            c.index_copy_(1, idx, c.index_select(1, idx))

    gather_ms = cuda_ms(torch, gather, 5)
    t = batcher.timers
    rep_a, rep_b, rep = summarize(wave_a), summarize(wave_b), summarize(reqs)
    line = dict(phase="serve_7b_long", layouts="fused", decode_attn=attn, decode_fused=fused,
                n_requests=rep.n_requests, tokens=rep.total_tokens, wall_s=wall,
                tok_per_s=rep.tokens_per_sec,
                ttft_p50_ms_a=rep_a.ttft_p50_s * 1e3, ttft_p95_ms_a=rep_a.ttft_p95_s * 1e3,
                ttft_p50_ms_b=rep_b.ttft_p50_s * 1e3, ttft_p95_ms_b=rep_b.ttft_p95_s * 1e3,
                chunked_admission_ms=walls["prefill"][0],
                continuation_ms=walls["prefill_continue"][0],
                continuation_gather_writeback_ms=gather_ms, snapshot_ms=walls["snapshot_slot"],
                restore_ms=walls["restore_slot"], prefix_hits=batcher.prefix_hits,
                decode_steps=steps, chunks=t["chunks"], chunk_steps=t["chunk_steps"],
                decode_ms_per_step=t["decode"] * 1e3 / max(1, steps),
                decode_ms_per_chunk=(t["decode_dispatch"] + t["decode_read"]) * 1e3
                / max(1, t["chunks"]),
                admit_s=t["admit"], decode_dispatch_s=t["decode_dispatch"],
                decode_read_s=t["decode_read"], emit_s=t["emit"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                host_launch_us=host_launch_us(torch),
                launches=launches, plain_calls=plain, card=smi_line)
    print(json.dumps(line), flush=True)
    del engine, batcher
    torch.cuda.empty_cache()
    return launches


def serve_7b_fp(torch, smi_line, params, phase: str, kv_dtype: str, setup_s: float):
    """Phases 4c and 4d: the JAX server's model path at full 7B width and
    depth, ``Engine(max_batch=8, seq_len=2048)`` + ``ContinuousBatcher``
    serving phase 4's 10 requests on dense f32 weights in the fused layouts
    with the default (float32) cache ("serve_7b_dense"), or on their Q8_0
    form with a bfloat16 cache ("serve_7b_q8").  Every request must finish
    with in-vocab tokens, no plain version may run, and every kernel must
    launch exactly as the path requires: per admission group K6's fp form
    once per layer and K7's fp form once (every bucket); per decode step K9's
    fp form once per layer and one fp K10 flush (decode attention "auto":
    K9; fused decode "auto": False on these weights); on Q8_0 weights K25
    four times per layer and once for the classifier in each admission
    group and each decode step (4 x 32 + 1 = 129).  Returns the launches."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.ops.quant import QuantTensor
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime import engine as engine_mod
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    L = cfg.n_layers
    t0 = time.time()
    kw = {} if kv_dtype == "float32" else dict(kv_dtype=kv_dtype)  # 4c: the default cache
    engine = Engine(params, cfg, max_batch=8, seq_len=2048, **kw)
    torch.cuda.synchronize()
    setup_s += time.time() - t0
    check(str(engine.cache.k.dtype) == f"torch.{kv_dtype}",
          f"{phase}: cache {engine.cache.k.dtype}, want {kv_dtype}")
    buckets = []  # each admission group's T
    inner = engine_mod._prefill_into_slots

    def counted(p, cache, tokens, *a, **k):
        buckets.append(tokens.shape[1])
        return inner(p, cache, tokens, *a, **k)

    engine_mod._prefill_into_slots = counted
    reqs = make_requests(Request, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(engine)
    _kernels.reset_counts()  # counts from here on belong to this path
    t0 = time.time()
    try:
        for r in reqs:
            batcher.submit(r)
        batcher.run()
        torch.cuda.synchronize()
    finally:
        engine_mod._prefill_into_slots = inner
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    check(all(r.done for r in reqs), f"{phase}: a request did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
          f"{phase}: served tokens missing or out of vocabulary")
    check(all(v == 0 for v in plain.values()), f"{phase}: plain versions ran: {plain}")
    attn, fused = engine.decode_attn, engine.decode_fused
    check(attn == "flash_dma" and fused is False,
          f"{phase}: decode resolved to {attn}, fused={fused!r}")
    steps = batcher.timers["decode_steps"]
    groups = len(buckets)
    sfx = "f32" if kv_dtype == "float32" else "bf16"
    want = {f"K6:{sfx}": L * groups, f"K7:{sfx}": groups, f"K9:{sfx}": L * steps,
            f"K10:{sfx}": steps}
    if isinstance(params.layers.wq, QuantTensor):
        want["K25"] = (4 * L + 1) * (groups + steps)
    got = {k: n for k, n in launches.items() if n > 0}
    check(groups > 0 and steps > 0 and got == want,
          f"{phase}: {groups} admission groups (buckets {buckets}), {steps} decode steps: want "
          f"exactly {want}, got {got}")
    rep = summarize(reqs)
    line = dict(phase=phase, layouts="fused", weights=type(params.layers.wq).__name__,
                kv_dtype=kv_dtype, precision=engine.precision, decode_attn=attn,
                decode_fused=fused, admission_groups=groups, buckets=buckets,
                n_requests=rep.n_requests, tokens=rep.total_tokens, wall_s=wall,
                tok_per_s=rep.tokens_per_sec, ttft_p50_ms=rep.ttft_p50_s * 1e3,
                ttft_p95_ms=rep.ttft_p95_s * 1e3, setup_s=setup_s, decode_steps=steps,
                decode_ms_per_step=batcher.timers["decode"] * 1e3 / max(1, steps),
                admit_s=batcher.timers["admit"], emit_s=batcher.timers["emit"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                host_launch_us=host_launch_us(torch),
                launches=got, plain_calls=plain, card=smi_line)
    print(json.dumps(line), flush=True)
    del engine, batcher
    torch.cuda.empty_cache()
    return launches


def paged_prefix_requests(Request, vocab: int):
    """Phase 4e's wave 2, all device-sampled: two seeds (a 300-token fed
    prefix, which ends inside a page, and a 512-token one, a page exactly),
    then 4 requests extending the first, 1 extending the second and the
    first again whole: 6 prefix hits."""
    rng = np.random.default_rng(77)
    p300 = [int(t) for t in rng.integers(3, vocab, 299)]  # fed: BOS + 299 = 300
    p512 = [int(t) for t in rng.integers(3, vocab, 511)]
    modes = [dict(temperature=0.0), dict(temperature=0.8, topp=0.9),
             dict(temperature=0.8, topk=40)]

    def req(prompt, i):
        return Request(prompt_tokens=prompt, steps=len(prompt) + 1 + PAGED_NEW, seed=4000 + i,
                       device_sampling=True, **modes[i % 3])

    seeds = [req(p300, 0), req(p512, 1)]
    hits = [req(p300 + [int(t) for t in rng.integers(3, vocab, int(rng.integers(40, 201)))], i)
            for i in range(2, 6)]
    hits += [req(p512 + [int(t) for t in rng.integers(3, vocab, 100)], 6), req(p300, 7)]
    return seeds, hits


PAGED_NEW = 32  # new tokens per phase-4e wave-2 and wave-3 request
PAGED_CHUNK = 16  # the batcher's max_chunk in phase 4e wave 2
PAGED_W3_PAGES = 1 + 3 * 2  # wave 3's pool: three requests of two pages each


def serve_7b_paged(torch, smi_line, params):
    """Phase 4e: the paged INT8 serving path at full 7B width and depth on
    phase 4's fused W8A8 weights: ``Engine(max_batch=8, kv_layout="paged",
    page_size=512, seq_len=2048)``, a 33-page pool (decode attention
    "auto": K13; fused decode "auto": the two-launch K11 decode).

    Wave 1: phase 4's 10 requests, host sampling; the streams must equal a
    dense-INT8 ``Engine(fused=True)``'s on the same weights and prompts,
    whose K9 runs with block_s = 256 (K13's block: the two kernels are then
    bit-equal, phase 3); the first decode step's logits against K9 at its
    default block of 128 rows are recorded (rounding points apart).  Wave 2:
    ``ContinuousBatcher(prefix_cache_size=8, max_chunk=16)``,
    ``paged_prefix_requests``: 6 prefix hits (4 continuations past a
    boundary page, 1 past a page-aligned prefix, 1 whole-prompt hit), the
    snapshots and restores timed.  Wave 3: a second engine on the same
    weights with a 7-page pool serves 8 requests of two pages each, so at
    most 3 run at once: it must refuse admissions (``can_admit``) and serve
    all.  Every request must finish with in-vocab tokens, every kernel must
    launch exactly as the path requires (per compact admission group the
    fused prefill body and one K15, per continuation the body without it,
    per decode step what ``decode_launches`` lists for the paged two-launch
    decode; no K7, K9, K10 or K12), no plain version may run, and each pool
    must be back to num_pages - 1 free pages with every refcount zero after
    its retirements and evictions.  Returns the launches of waves 1-2."""
    import functools

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.profile_serving import summarize as trace_summary
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime import engine as engine_mod
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    L, V = cfg.n_layers, cfg.vocab_size
    t0 = time.time()
    engine = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=PAGED_PS,
                    seq_len=2048)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    pool_class = type(engine.pool).__name__
    attn, fused = engine.decode_attn, engine.decode_fused
    check(attn == "flash_dma" and fused is True, f"4e: decode resolved to {attn}, {fused!r}")
    groups, walls = [], {"snapshot_slot": [], "restore_slot": [], "prefill_continue": []}
    inner = engine_mod._prefill_into_slots

    def counted(p, cache, tokens, *a, **k):
        groups.append(tokens.shape[1])
        return inner(p, cache, tokens, *a, **k)

    def timed(eng, name):  # host wall of the call, closed by a sync
        fn = getattr(eng, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            walls[name].append((time.time() - t) * 1e3)
            return out
        return call

    for name in walls:
        setattr(engine, name, timed(engine, name))

    def want_launches(n_groups, n_cont, steps):
        body = n_groups + n_cont  # prefill bodies: compact groups and continuations
        want = dict(K3=2 * L * body, K4=L * body, K5=L * body, K6=L * body,
                    K1=(4 * L + 1) * body, K2=(L + 1) * body, K15=n_groups)
        for k, n in decode_launches(fused, attn, L, paged=True).items():
            want[k] = want.get(k, 0) + n * steps
        return {k: n for k, n in want.items() if n}

    def serve(batcher, reqs):
        for r in reqs:
            batcher.submit(r)
        batcher.run()
        torch.cuda.synchronize()

    def pool_clean(eng, label):
        pool = eng.pool
        check(pool.free_pages == pool.num_pages - 1 and not any(
            pool.refcount(p) for p in range(pool.num_pages)),
            f"{label}: {pool.free_pages} of {pool.num_pages - 1} pages free after retirement")

    engine_mod._prefill_into_slots = counted
    try:
        # wave 1: phase 4's requests
        reqs1 = make_requests(Request, V)
        torch.cuda.reset_peak_memory_stats()
        b1 = ContinuousBatcher(engine)
        _kernels.reset_counts()
        t0 = time.time()
        serve(b1, reqs1)
        wall1 = time.time() - t0
        got1 = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
        steps1 = b1.timers["decode_steps"]
        want1 = want_launches(len(groups), 0, steps1)
        check(got1 == want1, f"4e wave 1: {len(groups)} groups {groups}, {steps1} steps: want "
                             f"exactly {want1}, got {got1}")
        check(not plain, f"4e wave 1: plain versions ran: {plain}")
        pool_clean(engine, "4e wave 1")
        groups1 = list(groups)
        # wave 2: prefix reuse, device sampling, decode chunks
        seeds, hits = paged_prefix_requests(Request, V)
        b2 = ContinuousBatcher(engine, prefix_cache_size=8, max_chunk=PAGED_CHUNK)
        groups.clear()
        _kernels.reset_counts()
        t0 = time.time()
        serve(b2, seeds)
        serve(b2, hits)
        wall2 = time.time() - t0
        got2 = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
        steps2 = b2.timers["decode_steps"]
        n_cont = len(walls["prefill_continue"])
        want2 = want_launches(len(groups), n_cont, steps2)
        check(b2.prefix_hits == 6, f"4e wave 2: prefix hits {b2.prefix_hits}, want 6")
        check(n_cont == 1 and len(walls["restore_slot"]) == 6,
              f"4e wave 2: {n_cont} continuations, {len(walls['restore_slot'])} restores")
        check(got2 == want2, f"4e wave 2: {len(groups)} groups, {n_cont} continuations, "
                             f"{steps2} steps: want exactly {want2}, got {got2}")
        check(not plain, f"4e wave 2: plain versions ran: {plain}")
        for e in b2._prefix.values():  # evict every entry
            engine.release_snapshot(e["snap"])
        b2._prefix.clear()
        pool_clean(engine, "4e wave 2")
    finally:
        engine_mod._prefill_into_slots = inner
        for name in walls:
            delattr(engine, name)
    reqs = reqs1 + seeds + hits
    check(all(r.done for r in reqs), "4e: a request did not finish")
    check(len(walls["snapshot_slot"]) == 2, f"4e wave 2: {len(walls['snapshot_slot'])} "
                                            "snapshots, want 2 (the seeds)")
    toks = [t for r in reqs for t in r.out_tokens]
    check(len(toks) > 0 and all(0 <= t < V for t in toks), "4e: tokens missing or out of vocab")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: got1.get(k, 0) + got2.get(k, 0) for k in set(got1) | set(got2)}

    # the same requests on a dense INT8 engine: K9 at K13's block gives the same streams
    dense = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048, fused=True)
    k9 = tl.flash_decode_attention_dma
    tl.flash_decode_attention_dma = functools.partial(k9, block_s=256)
    try:
        ref = make_requests(Request, V)
        serve(ContinuousBatcher(dense), ref)
    finally:
        tl.flash_decode_attention_dma = k9
    same = [r.out_tokens == d.out_tokens for r, d in zip(reqs1, ref)]
    check(all(same), f"4e: paged streams differ from dense K9 (block 256) ones: {same}")
    # the first decode step's logits against K9 at its default block (128 rows)
    prompts = [[1] + r.prompt_tokens for r in reqs1[:8]]
    last = [engine.prefill(prompts, list(range(8)), reserve_tokens=[len(p) + 9 for p in prompts]),
            dense.prefill(prompts, list(range(8)))]
    tok = np.array([int(np.argmax(x)) for x in last[0]])
    at = np.array([len(p) for p in prompts])
    step = [e.decode(tok, at) for e in (engine, dense)]
    first_err = float(np.abs(step[0] - step[1]).max())
    first_peak = float(np.abs(step[1]).max())
    # device time of the paged decode step: 4 traced steps of all 8 slots
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for i in range(4):
        engine.decode(tok, at + 1 + i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            engine.decode(tok, at + 5 + i)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    trace = trace_summary("serve_7b_paged_decode_b8", prof, wall, traced, smi_line)
    del dense, ref
    engine.reset()
    torch.cuda.empty_cache()

    # wave 3: backpressure on a pool for three requests at a time
    small = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=PAGED_PS,
                   seq_len=2048, num_pages=PAGED_W3_PAGES)
    refused, live = [], []
    can, dec = small.can_admit, small.decode_device

    def probe(*a):
        ok = can(*a)
        refused.append(not ok)
        return ok

    def decode(*a):
        live.append(int(np.count_nonzero(small.pool.table[:, 0])))
        return dec(*a)

    small.can_admit, small.decode_device = probe, decode
    rng = np.random.default_rng(78)
    reqs3 = [Request(prompt_tokens=[int(t) for t in rng.integers(3, V, 600)],
                     steps=601 + PAGED_NEW, temperature=0.0, seed=5000 + i) for i in range(8)]
    t0 = time.time()
    serve(ContinuousBatcher(small), reqs3)
    wall3 = time.time() - t0
    check(all(r.done for r in reqs3), "4e wave 3: a request did not finish")
    check(any(refused) and max(live) == 3, f"4e wave 3: refused {sum(refused)} admissions, "
                                           f"at most {max(live)} requests at once (want 3)")
    pool_clean(small, "4e wave 3")
    del small

    rep1, rep2, rep3 = summarize(reqs1), summarize(hits), summarize(reqs3)
    t1, t2 = b1.timers, b2.timers
    line = dict(phase="serve_7b_paged", layouts="fused", decode_attn=attn, decode_fused=fused,
                page_size=PAGED_PS, num_pages=engine.pool.num_pages, pool_class=pool_class,
                admission_groups=groups1, n_requests=rep1.n_requests, tokens=rep1.total_tokens,
                wall_s=wall1, tok_per_s=rep1.tokens_per_sec, ttft_p50_ms=rep1.ttft_p50_s * 1e3,
                ttft_p95_ms=rep1.ttft_p95_s * 1e3, setup_s=setup_s, decode_steps=steps1,
                decode_ms_per_step=t1["decode"] * 1e3 / max(1, steps1),
                decode_device_ms_per_step=trace["device_busy_ms"] / 4,
                decode_host_ms_per_step=wall * 1e3 / 4, decode_idle_share=trace["idle_share"],
                decode_launches_per_step=trace["n_kernels"] / 4,
                decode_device_ms=trace["device_ms"],
                streams_equal_dense_k9_block256=all(same),
                first_step_logit_max_err_vs_k9_block128=first_err, first_step_logit_peak=first_peak,
                admit_s=t1["admit"], emit_s=t1["emit"],
                wave2=dict(prefix_hits=b2.prefix_hits, wall_s=wall2, tokens=rep2.total_tokens,
                           ttft_p50_ms=rep2.ttft_p50_s * 1e3, ttft_p95_ms=rep2.ttft_p95_s * 1e3,
                           snapshot_ms=walls["snapshot_slot"], restore_ms=walls["restore_slot"],
                           continuation_ms=walls["prefill_continue"], decode_steps=steps2,
                           chunks=t2["chunks"], chunk_steps=t2["chunk_steps"]),
                wave3=dict(num_pages=PAGED_W3_PAGES, refused=sum(refused), max_live=max(live),
                           wall_s=wall3, tok_per_s=rep3.tokens_per_sec,
                           ttft_p50_ms=rep3.ttft_p50_s * 1e3, ttft_p95_ms=rep3.ttft_p95_s * 1e3),
                peak_mem_gb=peak_gb, host_launch_us=host_launch_us(torch),
                launches=launches, card=smi_line)
    print(json.dumps(line), flush=True)
    del engine, b1, b2
    torch.cuda.empty_cache()
    return launches


DIRECT_NEW = 32  # new tokens per phase-4f request
DIRECT_SLOTS = 32
DIRECT_PAGES = 1 + DIRECT_SLOTS * 3  # 32 slots of up to 3 pages, and the trash page


def direct_requests(Request, vocab: int):
    """Phase 4f's traffic, batch document jobs whose long prompts arrive
    together: wave 1, 32 prompts of 600-1000 tokens (greedy and seeded
    temperature sampling on the host), one admission group of 32 x 1024
    rows; wave 2, after it, 8 device-sampled prompts of 1100-2000 tokens,
    one group of 8 x 2048 rows; 32 new tokens each."""
    rng = np.random.default_rng(77)
    wave1 = []
    for i, n in enumerate(rng.integers(600, 1001, DIRECT_SLOTS)):
        prompt = [int(t) for t in rng.integers(3, vocab, int(n))]
        wave1.append(Request(prompt_tokens=prompt, steps=int(n) + 1 + DIRECT_NEW,
                             temperature=0.0 if i % 2 == 0 else 0.8,
                             topp=0.9 if i % 4 == 3 else 1.0, seed=3000 + i))
    wave2 = []
    for i, n in enumerate(rng.integers(1100, 2001, 8)):
        prompt = [int(t) for t in rng.integers(3, vocab, int(n))]
        wave2.append(Request(prompt_tokens=prompt, steps=int(n) + 1 + DIRECT_NEW,
                             temperature=(0.0, 0.8, 0.8)[i % 3], topp=0.9 if i % 3 == 1 else 1.0,
                             topk=40 if i % 3 == 2 else 0, seed=4000 + i,
                             device_sampling=True))
    return wave1, wave2


def serve_7b_paged_direct(torch, smi_line, params):
    """Phase 4f: the pool-direct paged admission at full 7B width and depth
    on phase 4's fused W8A8 weights: ``Engine(max_batch=32,
    kv_layout="paged", page_size=512, seq_len=2048, num_pages=97)`` (32
    slots x 3 pages and the trash page, ~13 GB of pool) +
    ``ContinuousBatcher``, ``direct_requests``' two waves (wave 2 with
    ``max_chunk=16``).  Each admission group passes the pool-direct gate and
    is prefilled straight into its pages in waves of 16 slots: 32 x 1024
    in two waves of 4 chunks, 8 x 2048 in one wave of 8 chunks, so each
    launches K16 and K17 256 times (32 layers x 8 chunk steps) and K15 0
    times, and must raise ``max_memory_allocated`` by less than a quarter
    of the compact [L, n, KVH, T, hd] block it avoids.  Every request must
    finish with in-vocab tokens, every kernel must launch exactly as the
    path requires, no plain version may run, and the pool must be back to
    every page free.  Then each wave's prompts are admitted once more (the
    same engine calls, untimed) and held to the dense chunked prefill of
    the same prompts (``forward_prefill_chunked``: K5, K18, K6) bit for
    bit: the last logits and every row of each slot's pages.  Returns the
    served run's launches."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime import engine as engine_mod
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    L, V, KVH, hd = cfg.n_layers, cfg.vocab_size, cfg.n_kv_heads, cfg.head_dim
    chunk, wave_slots = engine_mod._POOL_CHUNK, engine_mod._WAVE_ROWS // engine_mod._POOL_CHUNK
    t0 = time.time()
    engine = Engine(params, cfg, max_batch=DIRECT_SLOTS, kv_layout="paged", page_size=PAGED_PS,
                    seq_len=2048, num_pages=DIRECT_PAGES)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    attn, fused = engine.decode_attn, engine.decode_fused
    check(attn == "flash_dma" and fused is True, f"4f: decode resolved to {attn}, {fused!r}")
    pool_gb = sum(getattr(engine.cache, a).numel() * getattr(engine.cache, a).element_size()
                  for a in engine.cache.arrays) / 1e9
    admissions, waves, peak = [], [], [0]
    inner, inner_wave = engine.prefill, engine_mod.forward_prefill_paged_chunked

    def prefill(prompts, slots, *a, **k):  # wall, launches and memory rise of one admission
        torch.cuda.synchronize()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        before = dict(_kernels.LAUNCHES)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        waves.clear()
        t = time.time()
        out = inner(prompts, slots, *a, **k)
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
        rise = torch.cuda.max_memory_allocated() - base
        T = min(engine_mod._bucket(max(len(p) for p in prompts)), engine.seq_len)
        n = len(prompts)
        block = L * n * KVH * T * (2 * hd + 8)  # the compact block pool-direct avoids
        admissions.append(dict(n=n, T=T, wall_ms=wall, pool_direct_waves=list(waves),
                               launches={x: _kernels.LAUNCHES[x] - before[x]
                                         for x in ("K15", "K16", "K17")},
                               want=L * (T // chunk) * -(-n // wave_slots),
                               mem_rise_gb=rise / 1e9, compact_block_gb=block / 1e9))
        return out

    def counted(p, cache, tokens, *a, **k):  # one pool-direct wave
        waves.append(tokens.shape[0])
        return inner_wave(p, cache, tokens, *a, **k)

    def pool_clean(label):
        pool = engine.pool
        check(pool.free_pages == pool.num_pages - 1 and not any(
            pool.refcount(p) for p in range(pool.num_pages)),
            f"{label}: {pool.free_pages} of {pool.num_pages - 1} pages free after retirement")

    wave1, wave2 = direct_requests(Request, V)
    engine.prefill = prefill
    engine_mod.forward_prefill_paged_chunked = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_counts()  # counts from here on belong to this path
        b1 = ContinuousBatcher(engine)
        t0 = time.time()
        for r in wave1:
            b1.submit(r)
        b1.run()
        torch.cuda.synchronize()
        wall1 = time.time() - t0
        pool_clean("4f wave 1")
        b2 = ContinuousBatcher(engine, max_chunk=LONG_CHUNK)
        t0 = time.time()
        for r in wave2:
            b2.submit(r)
        b2.run()
        torch.cuda.synchronize()
        wall2 = time.time() - t0
        pool_clean("4f wave 2")
    finally:
        engine_mod.forward_prefill_paged_chunked = inner_wave
        del engine.prefill
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
    launches = dict(_kernels.LAUNCHES)
    plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
    reqs = wave1 + wave2
    check(all(r.done for r in reqs), "4f: a request did not finish")
    toks = [t for r in reqs for t in r.out_tokens]
    check(len(toks) > 0 and all(0 <= t < V for t in toks), "4f: tokens missing or out of vocab")
    check(not plain, f"4f: plain versions ran: {plain}")
    shapes = [(a["n"], a["T"]) for a in admissions]
    check(shapes == [(DIRECT_SLOTS, 1024), (8, 2048)],
          f"4f: admission groups {shapes}, want [(32, 1024), (8, 2048)]")
    for a in admissions:
        want = dict(K15=0, K16=a["want"], K17=a["want"])
        check(a["launches"] == want and a["pool_direct_waves"] == [
            min(wave_slots, a["n"] - w) for w in range(0, a["n"], wave_slots)],
            f"4f admission {a['n']} x {a['T']}: launches {a['launches']}, want {want}; waves "
            f"{a['pool_direct_waves']}")
        check(a["mem_rise_gb"] < a["compact_block_gb"] / 4,
              f"4f admission {a['n']} x {a['T']}: memory rose {a['mem_rise_gb']} GB, the compact "
              f"block it avoids is {a['compact_block_gb']} GB")
    steps = b1.timers["decode_steps"] + b2.timers["decode_steps"]
    body = sum(a["want"] // L for a in admissions)  # chunk steps of all waves
    want = dict(K3=2 * L * body, K4=L * body, K5=L * body, K16=L * body, K17=L * body,
                K1=(4 * L + 1) * body, K2=(L + 1) * body)
    for k, n in decode_launches(fused, attn, L, paged=True).items():
        want[k] = want.get(k, 0) + n * steps
    got = {k: n for k, n in launches.items() if n}
    check(got == want, f"4f: {shapes} admissions, {steps} decode steps: want exactly {want}, "
                       f"got {got}")

    # each wave's prompts again, held to the dense chunked prefill bit for bit
    equal = []
    for reqs_w in (wave2, wave1):
        prompts = [[1] + r.prompt_tokens for r in reqs_w]
        n = len(prompts)
        T = min(engine_mod._bucket(max(len(p) for p in prompts)), engine.seq_len)
        last = engine.prefill(prompts, list(range(n)), reserve_tokens=[len(p) for p in prompts],
                              return_device=True)
        tk = np.zeros((n, T), np.int64)
        for i, p in enumerate(prompts):
            tk[i, :len(p)] = p
        dense = tl.make_kv_cache(cfg, n, kv_dtype="int8", seq_len=T)
        ref, _ = tl.forward_prefill_chunked(params, dense, torch.tensor(tk, device="cuda"),
                                            torch.tensor([len(p) for p in prompts],
                                                         device="cuda"),
                                            cfg, chunk=chunk, precision=engine.precision)
        torch.cuda.synchronize()
        diff = []
        for i, p in enumerate(prompts):
            pages = [int(x) for x in engine.pool.table[i, :engine.pool.pages_needed(len(p))]]
            for a in engine.cache.arrays:
                rows = torch.cat([getattr(engine.cache, a)[:, pg] for pg in pages], dim=2)
                d = rows != getattr(dense, a)[:, i, :, :rows.shape[2]]
                if d.any():
                    diff.append(dict(slot=i, array=a,
                                     first_layer=int(d.flatten(1).any(1).nonzero()[0]),
                                     share=d.float().mean().item()))
        equal.append(dict(n=n, T=T, logits_equal=torch.equal(last, ref),
                          logit_max_diff=(last - ref).abs().max().item(), pool_rows_differ=diff))
        for s in range(n):
            engine.release_slot(s)
        del dense, ref, last
        torch.cuda.empty_cache()
    pool_clean("4f after the comparisons")
    rep1, rep2 = summarize(wave1), summarize(wave2)
    t1, t2 = b1.timers, b2.timers
    line = dict(phase="serve_7b_paged_direct", layouts="fused", decode_attn=attn,
                decode_fused=fused, page_size=PAGED_PS, num_pages=DIRECT_PAGES,
                pool_gb=pool_gb, setup_s=setup_s, admissions=admissions,
                wave1=dict(n_requests=rep1.n_requests, tokens=rep1.total_tokens, wall_s=wall1,
                           tok_per_s=rep1.tokens_per_sec, ttft_p50_ms=rep1.ttft_p50_s * 1e3,
                           ttft_p95_ms=rep1.ttft_p95_s * 1e3, decode_steps=t1["decode_steps"],
                           decode_ms_per_step=t1["decode"] * 1e3 / max(1, t1["decode_steps"]),
                           admit_s=t1["admit"], emit_s=t1["emit"]),
                wave2=dict(n_requests=rep2.n_requests, tokens=rep2.total_tokens, wall_s=wall2,
                           tok_per_s=rep2.tokens_per_sec, ttft_p50_ms=rep2.ttft_p50_s * 1e3,
                           ttft_p95_ms=rep2.ttft_p95_s * 1e3, decode_steps=t2["decode_steps"],
                           decode_ms_per_step=t2["decode"] * 1e3 / max(1, t2["decode_steps"]),
                           chunks=t2["chunks"], admit_s=t2["admit"]),
                free_pages_after=engine.pool.free_pages, peak_mem_gb=peak[0] / 1e9,
                equal_to_dense_chunked=equal, host_launch_us=host_launch_us(torch),
                launches=launches, card=smi_line)
    print(json.dumps(line), flush=True)
    check(all(e["logits_equal"] and not e["pool_rows_differ"] for e in equal),
          f"4f: pool-direct admissions differ from the dense chunked prefill: {equal}")
    del engine, b1, b2
    torch.cuda.empty_cache()
    return launches


def serve_7b_mega(torch, smi_line, params, mega2_streams):
    """Phase 4g: the opt-in fused decodes at 7B on phase 4's weights,
    ``Engine(max_batch=8, int8 dense KV, seq_len=2048, fused=mode)`` serving
    phase 4's 10 requests (with top-2 logprobs) through ``ContinuousBatcher``
    for mode "mega3" (K26), "mega" (K27) and, as mega's reference, the
    two-launch decode (``True``: K9, K2 and K11, which K27 equals bit for
    bit with K9 at K27's splits -- ``fused_splits``, 8 at batch 8 over 2048
    rows, where the served two-launch decode's K9 takes ``decode_splits``'
    one -- so the reference run's K9 is called at those splits): every
    request finishes with in-vocab tokens, every kernel launches
    exactly as the path requires and no plain version runs; mega3's greedy
    streams equal phase 4's mega2 streams token for token, mega's equal the
    two-launch decode's.  mega is not held to mega2: K12 rounds q and h2 to
    bf16 where K27 keeps f32 (by design, as in JAX), and at 7B with random
    weights that moves the logits far past a near tie (on an H100 every
    greedy stream parted from mega2's within 5 steps, at top-2 gaps of
    4.4e-3 to 0.13); where each parts is printed.  Prints each mode's ms a
    step, tok/s and launches a step; returns the launches of each mode's
    run."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.ops import fused_step as tfst
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime.metrics import summarize

    cfg = LLAMA2_7B
    L = cfg.n_layers
    greedy = [i for i, r in enumerate(make_requests(Request, cfg.vocab_size))
              if r.temperature == 0.0]
    k9 = tl.flash_decode_attention_dma

    def k9_at_k27_splits(q, k_cache, *rest, splits=None, **kw):
        # ``splits``: the count the engine pins (None on one device: K27's rule)
        _, B, KVH, S, _ = k_cache.shape
        return k9(q, k_cache, *rest, splits=tfst.step_splits(B, KVH, S, splits), **kw)

    runs, out = {}, {}
    for mode in ("mega3", "mega", True):
        engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048, fused=mode)
        check(engine.decode_fused == mode, f"4g: fused={mode!r} resolved to "
                                           f"{engine.decode_fused!r}")
        reqs = make_requests(Request, cfg.vocab_size, logprobs=2)
        batcher = ContinuousBatcher(engine)
        _kernels.reset_counts()  # counts from here on belong to this path
        t0 = time.time()
        for r in reqs:
            batcher.submit(r)
        if mode is True:
            tl.flash_decode_attention_dma = k9_at_k27_splits
        try:
            batcher.run()
        finally:
            tl.flash_decode_attention_dma = k9
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
        check(all(r.done for r in reqs), f"4g {mode}: a request did not finish")
        toks = [t for r in reqs for t in r.out_tokens]
        check(len(toks) > 0 and all(0 <= t < cfg.vocab_size for t in toks),
              f"4g {mode}: served tokens missing or out of vocabulary")
        check(all(v == 0 for v in plain.values()), f"4g {mode}: plain versions ran: {plain}")
        steps = batcher.timers["decode_steps"]
        groups = launches["K7"]
        want = dict(K3=2 * L * groups, K4=L * groups, K5=L * groups, K6=L * groups, K7=groups,
                    K1=(4 * L + 1) * groups, K2=(L + 1) * groups)
        per_step = decode_launches(mode, engine.decode_attn, L)
        for k, n in per_step.items():
            want[k] = want.get(k, 0) + n * steps
        got = {k: n for k, n in launches.items() if n > 0}
        check(groups > 0 and got == want,
              f"4g {mode}: {groups} admission groups, {steps} decode steps: want exactly "
              f"{want}, got {got}")
        rep = summarize(reqs)
        out[str(mode)] = dict(tok_per_s=rep.tokens_per_sec, tokens=rep.total_tokens,
                              wall_s=wall, ttft_p50_ms=rep.ttft_p50_s * 1e3, decode_steps=steps,
                              decode_ms_per_step=batcher.timers["decode"] * 1e3 / max(1, steps),
                              port_launches_per_step=sum(per_step.values()),
                              admission_groups=groups, emit_s=batcher.timers["emit"],
                              launches=launches)
        runs[mode] = (reqs, launches)
        del engine, batcher
        torch.cuda.empty_cache()
    m3, mg, two = (runs[m][0] for m in ("mega3", "mega", True))
    same3 = {i: m3[i].out_tokens == mega2_streams[i] for i in greedy}
    same_two = {i: mg[i].out_tokens == two[i].out_tokens for i in greedy}
    all_two = all(a.out_tokens == b.out_tokens for a, b in zip(mg, two))
    parts = {}
    for i in greedy:  # where mega parts from mega3 (= mega2), and mega3's top-2 gap there
        a, b = m3[i], mg[i]
        part = next((j for j, (x, y) in enumerate(zip(a.out_tokens, b.out_tokens)) if x != y),
                    None)
        if part is not None:
            (_, top1), (_, top2) = a.out_top_logprobs[part][:2]
            parts[i] = dict(step=part, mega2_top2_gap=top1 - top2)
    print(json.dumps(dict(phase="serve_7b_mega", layouts="fused", **out,
                          mega3_greedy_equal_mega2=same3, mega_greedy_equal_two_launch=same_two,
                          mega_all_streams_equal_two_launch=all_two,
                          mega_parts_from_mega2=parts, host_launch_us=host_launch_us(torch),
                          card=smi_line)), flush=True)
    check(all(same3.values()), f"4g: mega3's greedy streams differ from mega2's: {same3}")
    check(all(same_two.values()),
          f"4g: mega's greedy streams differ from the two-launch decode's: {same_two}")
    return {mode: launches for mode, (_, launches) in runs.items()}


def admission_k29(torch, smi_line, params):
    """Phase 4h: one 8 x 512 admission (phase 4's first eight prompts, each
    padded into the 512 bucket) with ``TPU_LLAMA_ROWS_RESIDENT=1`` -- every
    product of its 4096 rows on K29 -- and then with the switch restored
    (K1): the last-token logits and every cache row bit-equal.  Returns the
    switched admission's launches."""
    import os

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine, Request

    cfg = LLAMA2_7B
    L = cfg.n_layers
    prompts = [[1] + r.prompt_tokens for r in make_requests(Request, cfg.vocab_size)[:8]]
    before = os.environ.get("TPU_LLAMA_ROWS_RESIDENT")
    side = {}
    try:
        for switch in ("1", before):
            if switch is None:
                os.environ.pop("TPU_LLAMA_ROWS_RESIDENT", None)
            else:
                os.environ["TPU_LLAMA_ROWS_RESIDENT"] = switch
            engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
            torch.cuda.synchronize()
            _kernels.reset_counts()
            t0 = time.time()
            logits = engine.prefill(prompts, list(range(8)))
            torch.cuda.synchronize()
            side[switch == "1"] = dict(logits=np.asarray(logits), cache=engine.cache,
                                       launches=dict(_kernels.LAUNCHES),
                                       ms=(time.time() - t0) * 1e3)
            del engine
    finally:
        if before is None:
            os.environ.pop("TPU_LLAMA_ROWS_RESIDENT", None)
        else:
            os.environ["TPU_LLAMA_ROWS_RESIDENT"] = before
    on, off = side[True], side[False]
    equal = bool(np.array_equal(on["logits"], off["logits"])) and all(
        torch.equal(getattr(on["cache"], n), getattr(off["cache"], n))
        for n in ("k", "v", "ks", "vs"))
    launches = on["launches"]
    k29, k1 = launches.get("K29", 0), launches.get("K1", 0)
    print(json.dumps(dict(phase="admission_k29", B=8, T=512, equal_to_default=equal,
                          k29_launches=k29, k1_launches=k1, wall_ms_switched=on["ms"],
                          wall_ms_default=off["ms"], card=smi_line)), flush=True)
    check(equal, "4h: the admission through K29 differs from the default one")
    # per layer qkv, wo, w13 and w2 on 4096 rows; the classifier's 8 rows stay on K1
    check(k29 == 4 * L and k1 == 1 and off["launches"].get("K29", 0) == 0,
          f"4h: K29 launched {k29} times, K1 {k1}: want {4 * L} and 1")
    del side, on, off
    torch.cuda.empty_cache()
    return launches


# phase 4i: the tensor-parallel serving path at 7B (tp = 1 on NCCL, tp = 2
# as two processes on the one card over gloo)
TP_PROMPT_LENS = (17, 100, 200, 300)  # BOS included
TP_NEW = 24  # new tokens per request
TP_PROBE_STEPS = 4  # teacher-forced decode steps held to the reference
TP_FP_STEPS = 2  # unfused TP decode steps on the f32 and bf16 caches (K21's fp forms)
TP_TIMED_STEPS = 8
TP_TIMEOUT = 480  # seconds a run of ranks may take
TP_PARITY_PROMPTS = (16, 9)  # the 2-layer card-against-CPU parity's prompt lengths
TP_PARITY_STEPS = 4
OVERLAP_TOL = 1e-5  # of max |logit|: the ring collective matmul against the all-reduce
# form, f32 weights and cache on one device (only the order of f32 sums may differ)
# phase 4k: the sharded engine at 7B (tp = 1 on NCCL, tp = 2 as two gloo processes)
MESH_PROMPT_LENS = TP_PROMPT_LENS[:3]  # wave 1 (BOS included); wave 2 extends the first
MESH_PREFIX_EXTRA = 40  # the prefix hit's suffix tokens (4i's hit too)
MESH_NEW = 16  # new tokens per request
MESH_HTTP_REQUESTS = 2
MESH_HTTP_TOKENS = 12
MESH_TIMED_STEPS = 6
MESH_TIMEOUT = 420  # seconds a call to the ranks may take


def tp_prompts(vocab: int):
    rng = np.random.default_rng(41)
    return [[1] + [int(t) for t in rng.integers(3, vocab, n - 1)] for n in TP_PROMPT_LENS]


class PrefillDecode:
    """An engine that admits through ``pre`` and decodes through ``dec``,
    two single-device engines sharing one cache: the single-device
    arithmetic of the TP serving path at tp = 1 (the unfused prefill body,
    the two-launch fused decode: K8 + K23 + K24 is K11 bit for bit)."""

    def __init__(self, pre, dec):
        self.pre, self.dec = pre, dec
        dec.cache = pre.cache

    def prefill(self, *args, **kw):
        return self.pre.prefill(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.dec, name)


def tp_reference(torch, params):
    """The single-device references of phase 4i on phase 4's weights, the
    TP path's arithmetic at tp = 1: prefill on the unfused layouts
    (``unfuse_projections``), decode on the two-launch fused decode (``fused=
    True``: K3 + K8, per layer K9, K2, K11) from that cache; probed on
    TP_PROMPT_LENS (the greedy picks become the teacher tokens) and serving
    their greedy requests with top-2 logprobs (``PrefillDecode``); and the
    unfused decode with ``attn="flash"`` (K19: p normalized, as K21's) from
    the same prefill, fed the teacher tokens."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models.llama import unfuse_projections
    from tpu_llama_torch.parallel import launch
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

    cfg = LLAMA2_7B
    prompts = tp_prompts(cfg.vocab_size)
    unfused = unfuse_projections(params, cfg)

    def engine(p, **kw):
        return Engine(p, cfg, max_batch=8, kv_dtype="int8", seq_len=2048, **kw)

    ref = PrefillDecode(engine(unfused), engine(params, fused=True))
    out = {"probe": launch.probe(ref, prompts, TP_PROBE_STEPS)}
    out["teacher"] = np.stack(out["probe"]["picks"][:TP_PROBE_STEPS])
    ref.cache.zero_()
    reqs = [Request(prompt_tokens=p[1:], steps=len(p) + TP_NEW, temperature=0.0, logprobs=2)
            for p in prompts]
    batcher = ContinuousBatcher(ref)
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    out["streams"] = [r.out_tokens for r in reqs]
    out["top"] = [r.out_top_logprobs for r in reqs]
    del ref, batcher
    out["unfused"] = launch.probe(engine(unfused, attn="flash"), prompts, TP_PROBE_STEPS,
                                  out["teacher"])
    torch.cuda.empty_cache()
    return out


def _streams_parted(got, ref, ref_top):
    """For each stream, None where it equals the reference's, else (step,
    the reference's top-1 minus top-2 logprob at that step)."""
    out = []
    for g, r, top in zip(got, ref, ref_top):
        k = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b), None)
        if k is None and len(g) != len(r):
            k = min(len(g), len(r))
        out.append(None if k is None else (k, top[k][0][1] - top[k][1][1] if k < len(top)
                                           else 0.0))
    return out


def tp_step_launches(L: int) -> dict:
    """Kernel launches of one fused TP decode step (tp_forward_decode_fused,
    head_dim 128 on the card): the prologue's K3 and K8, per layer K9, K2,
    K8 (the wo partial), K23 and K24, one K10 flush, the classifier's
    K2 + K1."""
    return {"K3": 1, "K8": 1 + L, "K9": L, "K2": L + 1, "K23": L, "K24": L, "K10": 1, "K1": 1}


def serve_7b_tp(torch, smi_line, ref):
    """Phase 4i: the TP serving path at 7B full width and depth on phase
    4's weights (each rank draws them again from the seed, puts them in the
    tp-interleaved order and keeps its shard): ``parallel.launch.
    serve_card`` in one process on NCCL (tp = 1) and in two processes on
    the one card over gloo (tp = 2; NCCL refuses two ranks on one device):
    ``Engine(mesh, tp_fused=True)`` + ``ContinuousBatcher`` serving
    TP_PROMPT_LENS greedy requests of TP_NEW new tokens, the fused TP decode
    (K8, K9, K2, K23, K24, K10) and the unfused one (K21 on INT8, f32 and
    bf16 caches).  Held: at tp = 1 the probe's logits and the greedy
    streams bit for bit to the single-device engine of the same arithmetic
    (``tp_reference``); at each tp the TP paths of the model cut to 2
    layers (``launch.tp_parity``, f32 activations) to the same tp on the
    CPU (plain versions; gloo ranks for tp = 2): logits within LOGITS_TOL,
    greedy picks equal up to the first step where the two logits that swap
    lie within TIE_ERR_RATIO of the measured card-CPU error of those rows (a
    flip the logits' own noise explains: at 7B width one moved int8 moves logits by
    ~3% of max |logit|, far above the tiny card tests' NEAR_TIE); the ring
    collective matmul (``overlap=True``; at tp = 2 on the card its hops
    staged through host memory, each counted) within OVERLAP_TOL of the
    all-reduce form on each side; both ranks equal bit for bit; exact
    launches per step; no plain version.
    Read, not held: K21's 7B decode against the single-device K19 decode,
    and tp = 2 against tp = 1 at 7B -- both part by 0.11-0.18 of max
    |logit|: K19 scores the step's own row with the f32 query and weights
    its V unrounded (the deferred flush's fresh column) where K21 reads it
    back from the cache as any other row (bf16 query, bf16(p * vs)), and
    tp = 2 quantizes the attention output and h2 per shard (JAX's TP
    semantics), so neither is the same function as its yardstick.  The witness line
    prints the same two comparisons on the 2-layer model, the card's beside
    the CPU's plain versions: where they agree, the gap is the function's,
    not a kernel's.  Returns tp = 1's launches: those of its serving run
    (K23, K24) and of its unfused steps (K21 and its fp forms)."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.parallel import MeshConfig, launch, single_device_mesh

    cfg = LLAMA2_7B
    prompts = tp_prompts(cfg.vocab_size)
    requests = [(p[1:], len(p) + TP_NEW) for p in prompts]
    small = dataclasses.replace(cfg, n_layers=2)
    rng = np.random.default_rng(7)
    parity = (small, 1, [[1] + [int(t) for t in rng.integers(3, cfg.vocab_size, n - 1)]
                         for n in TP_PARITY_PROMPTS], TP_PARITY_STEPS)
    prefix = prefix_pair(prompts[0])
    runs, pars, errs_7b = {}, {}, {}
    for tp, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.time()
        ranks = launch.run(launch.serve_card, MeshConfig(1, tp),
                           args=(cfg, 0, prompts, TP_PROBE_STEPS, ref["teacher"], requests,
                                 TP_PROBE_STEPS, TP_FP_STEPS, TP_TIMED_STEPS, 8, 2048, parity,
                                 prefix),
                           backend=backend, device="cuda", timeout=TP_TIMEOUT, threads=4)
        wall = time.time() - t0
        t0 = time.time()
        if tp == 1:
            cpu = launch.tp_parity(single_device_mesh("cpu"), *parity)
        else:
            cpu = launch.run(launch.tp_parity, MeshConfig(1, tp), args=parity, backend="gloo",
                             device="cpu", timeout=TP_TIMEOUT, threads=4)[0]
        cpu_s = time.time() - t0
        label = f"4i tp={tp} ({backend})"
        r0 = ranks[0]
        want = ref if tp == 1 else {"probe": runs[1]["probe"], "streams": runs[1]["streams"],
                                    "top": runs[1]["top"],
                                    "unfused": {"decode": runs[1]["unfused_int8"]}}
        probe_errs = [launch.logits_err(g, w) for g, w in zip(
            [r0["probe"]["prefill"]] + r0["probe"]["decode"],
            [want["probe"]["prefill"]] + want["probe"]["decode"])]
        k21_errs = [launch.logits_err(g, w) for g, w in zip(r0["unfused_int8"],
                                                      want["unfused"]["decode"])]
        parted = _streams_parted(r0["streams"], want["streams"], want["top"])
        host = sorted(r0["step_host_ms"])[len(r0["step_host_ms"]) // 2]
        print(json.dumps(dict(
            phase="serve_7b_tp", tp=tp, backend=backend, ranks=len(ranks), B=8, pos=512,
            wall_s=wall, serve_s=r0["serve_s"], step_host_ms_median=host,
            step_host_ms=r0["step_host_ms"], step_traced_host_ms=r0["step_traced_host_ms"],
            step_device_ms=[r["step_device_ms"] for r in ranks],
            step_collective_host_ms=[r["step_collective_host_ms"] for r in ranks],
            collective_share=r0["step_collective_host_ms"] / r0["step_traced_host_ms"],
            step_launches=r0["step_launches"], step_kernels=r0["step_kernels"],
            probe_logits_err=probe_errs, k21_logits_err=k21_errs, streams_parted=parted,
            reference="single-device engine" if tp == 1 else "tp=1", prefix=r0["prefix"],
            serve_launches=r0["serve_launches"], unfused_launches=r0["unfused_launches"],
            parity_cpu_s=cpu_s, card=smi_line)), flush=True)
        reading = launch.parity_reading(r0["parity"], cpu)
        overlap = {side: launch.run_gap(par["overlap"]["ring"], par["overlap"]["allreduce"],
                                        forced=True)
                   for side, par in (("card", r0["parity"]), ("cpu", cpu))}
        hops = 2 * small.n_layers * TP_PARITY_STEPS * (tp - 1) if backend == "gloo" else 0
        print(json.dumps(dict(phase="serve_7b_tp_parity", tp=tp, layers=2, **reading,
                              overlap=overlap, overlap_tol=OVERLAP_TOL,
                              host_staged_hops=[r["parity"]["host_staged"] for r in ranks],
                              card_launches=r0["parity"]["launches"], tol=LOGITS_TOL)),
              flush=True)
        for side, ov in overlap.items():
            check(max(ov["logits_err"]) <= OVERLAP_TOL and ov["parted_at"] is None,
                  f"{label} {side}: the ring collective matmul parts from the all-reduce form: "
                  f"{ov} (limit {OVERLAP_TOL})")
        check(all(r["parity"]["host_staged"] == hops for r in ranks) and cpu["host_staged"] == 0,
              f"{label}: ring hops staged through host memory "
              f"{[r['parity']['host_staged'] for r in ranks]} on the card, {cpu['host_staged']} on "
              f"the CPU; want {hops} and 0")
        pars[tp] = (r0["parity"], cpu)
        errs_7b[tp] = dict(probe=probe_errs, k21=k21_errs)
        for mode, rd in reading.items():
            tie = "gap" not in rd or rd["gap"] <= TIE_ERR_RATIO * rd["row_err"]
            check(rd["logits_err"] <= LOGITS_TOL and tie,
                  f"{label} 2-layer parity {mode}: {rd} (logits limit {LOGITS_TOL}; greedy picks "
                  f"may part only where the two logits that swap lie within {TIE_ERR_RATIO} of "
                  f"the rows' measured error of each other)")
        for r in ranks:
            check(not r["serve_plain"] and not r["parity"]["plain"],
                  f"{label} rank {r['rank']}: plain versions ran: {r['serve_plain']}, "
                  f"{r['parity']['plain']}")
            check(r["streams"] == r0["streams"] and all(
                np.array_equal(a, b) for a, b in zip(r["probe"]["decode"],
                                                     r0["probe"]["decode"])),
                  f"{label}: rank {r['rank']} parts from rank 0")
            check(r["step_launches"] == tp_step_launches(cfg.n_layers),
                  f"{label} rank {r['rank']}: a step launched {r['step_launches']}, want "
                  f"{tp_step_launches(cfg.n_layers)}")
        check(r0["emitted"] == sum(len(s) for s in r0["streams"])
              and all(r["emitted"] == 0 for r in ranks[1:]), f"{label}: rank 0 alone emits")
        check(r0["prefix"]["hits"] == 1 and r0["prefix"]["hot"] == r0["prefix"]["cold"]
              and r0["prefix"]["hot"], f"{label}: the prefix hit's stream parts from a cold "
                                       f"admission's: {r0['prefix']}")
        check(all(s and all(0 <= t < cfg.vocab_size for t in s) for s in r0["streams"]),
              f"{label}: a stream is empty or out of vocabulary")
        check(all(math.isfinite(e) for e in probe_errs + k21_errs)
              and all(np.isfinite(g).all() for kv in ("float32", "bfloat16")
                      for g in r0[f"unfused_{kv}"]), f"{label}: logits not finite")
        if tp == 1:  # the single-device engine of the same arithmetic: bit for bit
            check(max(probe_errs) == 0.0 and not any(parted),
                  f"{label}: the probe's logits {probe_errs} of max |logit| and the streams "
                  f"{parted} part from the single-device engine")
        runs[tp] = r0
        torch.cuda.empty_cache()
    # the witness (no kernel on the CPU side): the 7B readings' comparisons on
    # the 2-layer model, the card's beside the CPU's
    witness = {side: dict(
        tp2_vs_tp1={m: launch.run_gap(pars[2][i][m], pars[1][i][m])
                    for m in ("fused", "unfused")},
        unfused_vs_single=launch.run_gap(pars[1][i]["unfused"], pars[1][i]["single"],
                                         forced=True))
        for side, i in (("card", 0), ("cpu", 1))}
    print(json.dumps(dict(phase="serve_7b_tp_witness", layers=2, sides=witness,
                          at_7b=dict(tp2_vs_tp1_probe=errs_7b[2]["probe"],
                                     unfused_vs_single=errs_7b[1]["k21"]), card=smi_line)),
          flush=True)
    launches = {**runs[1]["serve_launches"], **runs[1]["unfused_launches"]}
    tp_kernels = {k: launches.get(k, 0) for k in ("K21", "K21:f32", "K21:bf16", "K23", "K24")}
    check(all(tp_kernels.values()), f"4i: a TP kernel did not launch: {tp_kernels}")
    return launches


def mesh_step_launches(L: int, tp: int) -> dict:
    """Kernel launches of one sharded decode step (``spmd_forward_decode``,
    unfused W8A8 layouts, INT8 cache, flash_dma) on a rank: per layer K2
    before each of the seven products and K1 for each, except that above
    tp = 1 wo and w2 run K1's int32 form; K9 per layer; one K10 flush; the
    classifier's K2 + K1."""
    out = {"K1": (7 if tp == 1 else 5) * L + 1, "K2": 7 * L + 1, "K9": L, "K10": 1}
    if tp > 1:
        out["K1:i32"] = 2 * L
    return out


def prefix_pair(prompt: list, extra: int = MESH_PREFIX_EXTRA, new: int = MESH_NEW):
    """Two greedy requests ((prompt without BOS, steps)): ``prompt`` and
    ``prompt`` with ``extra`` more tokens, which a batcher that served the
    first finds in its prefix cache."""
    more = [int(t) for t in np.random.default_rng(len(prompt)).integers(3, 32000, extra)]
    return (prompt[1:], len(prompt) + new), (prompt[1:] + more, len(prompt) + extra + new)


def mesh_waves(vocab: int):
    """Phase 4k's requests in two waves: MESH_PROMPT_LENS' greedy requests,
    then one that extends the first's prompt (a prefix hit)."""
    prompts = tp_prompts(vocab)[:len(MESH_PROMPT_LENS)]
    first, hit = prefix_pair(prompts[0])
    return prompts, [[first] + [(p[1:], len(p) + MESH_NEW) for p in prompts[1:]], [hit]]


def _mesh_http(srv_engine, prompts) -> list:
    """Greedy /generate of ``prompts`` from a ``LlamaServer`` on
    ``srv_engine``: the responses."""
    from tpu_llama_torch.runtime.server import LlamaServer

    srv = LlamaServer(srv_engine, byte_tokenizer(32000), port=0).start()
    try:
        return [_http(srv.port, "/generate", {"prompt": t, "temperature": 0.0,
                                              "steps": len(t) + 1 + MESH_HTTP_TOKENS})
                for t in prompts]
    finally:
        srv.stop()


def mesh_reference(torch, params):
    """Phase 4k's single-device reference on phase 4's weights in the
    unfused layouts (``unfuse_projections``): ``Engine(max_batch=8, INT8
    cache)`` -- the K6 prefill body, the unfused decode (K9 and one K10 flush a
    step) -- probed on the waves' prompts (the prefill and one decode
    step), serving ``mesh_waves`` with a prefix cache, and answering phase
    4k's HTTP prompts."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models.llama import unfuse_projections
    from tpu_llama_torch.parallel import launch
    from tpu_llama_torch.runtime import Engine

    cfg = LLAMA2_7B
    prompts, waves = mesh_waves(cfg.vocab_size)
    eng = Engine(unfuse_projections(params, cfg), cfg, max_batch=8, kv_dtype="int8",
                 seq_len=2048)
    check(eng.decode_attn == "flash_dma" and eng.decode_fused is False,
          f"4k reference: decode {eng.decode_attn} / {eng.decode_fused!r}")
    out = {"probe": launch.probe(eng, prompts, 1)}
    eng.reset()
    out["served"] = launch.serve_waves(eng, waves, prefix_cache_size=4)
    eng.reset()
    out["http"] = _mesh_http(eng, http_prompts(MESH_HTTP_REQUESTS, seed=4))
    del eng
    torch.cuda.empty_cache()
    return out


def serve_7b_mesh(torch, smi_line, ref):
    """Phase 4k: the sharded engine (``Engine(mesh)``, JAX's GSPMD single
    program) at 7B full width and depth on phase 4's weights in the unfused
    layouts, INT8 cache, B 8: a ``MeshEngine`` of one NCCL rank (tp = 1:
    the single-device forward on the rank) and of two gloo ranks on the
    card (tp = 2: column-sharded products, attention on each rank's 16 kv
    heads at the whole batch's split counts, wo and w2 through K1's int32
    form with an int32 all-reduce), each rank drawing the weights again
    from the seed (``launch.build_card_spmd_engine``).  Per mesh,
    ``ContinuousBatcher`` in this process serves ``mesh_waves`` through the
    controller (the second wave a prefix hit: a snapshot and a continuation on
    the ranks): the streams, the probe's prefill and first decode step
    logits bit-equal to the single-device engine's (``mesh_reference``),
    every rank's logits equal (digests), the main path's launches (rank 0's)
    with no plain version and, at tp = 2, K1's int32 form; at tp = 2
    ``LlamaServer`` over the controller answers MESH_HTTP_REQUESTS prompts with
    the single-device server's responses; a timed and a traced decode step
    at B 8, position 512.  Returns tp = 2's launches of the serving run."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.parallel import MeshConfig, launch

    cfg = LLAMA2_7B
    prompts, waves = mesh_waves(cfg.vocab_size)
    texts = http_prompts(MESH_HTTP_REQUESTS, seed=4)
    out = {}
    for tp, backend in ((1, "nccl"), (2, "gloo")):
        label = f"4k tp={tp} ({backend})"
        t0 = time.time()
        with launch.MeshEngine(launch.build_card_spmd_engine, (cfg, 0),
                               dict(max_batch=8, kv_dtype="int8", seq_len=2048),
                               mesh_config=MeshConfig(1, tp), backend=backend, device="cuda",
                               timeout=MESH_TIMEOUT, threads=4) as eng:
            build_s = time.time() - t0
            check(eng.spmd and eng.decode_attn == "flash_dma" and eng.decode_fused is False,
                  f"{label}: decode {eng.decode_attn} / {eng.decode_fused!r}")
            t1 = time.time()
            probe = eng.run(launch.probe_digest, prompts, 1)
            probe_s = time.time() - t1
            eng.reset()
            eng.run(launch.kernel_counts, True)
            t1 = time.time()
            served = launch.serve_waves(eng, waves, prefix_cache_size=4)
            serve_s = time.time() - t1
            counts = eng.run(launch.kernel_counts)
            http = []
            t1 = time.time()
            if tp == 2:
                eng.reset()
                http = _mesh_http(eng, texts)
            http_s = time.time() - t1
            eng.reset()
            t1 = time.time()
            timing = eng.run(launch.engine_step_reading, 0, MESH_TIMED_STEPS)
            timing_s = time.time() - t1
        wall = time.time() - t0
        host = sorted(timing["step_host_ms"])[len(timing["step_host_ms"]) // 2]
        equal = dict(prefill=bool(np.array_equal(probe["prefill"], ref["probe"]["prefill"])),
                     decode=bool(np.array_equal(probe["decode"][0], ref["probe"]["decode"][0])),
                     streams=served["streams"] == ref["served"]["streams"],
                     http=[h["text"] for h in http] == [h["text"] for h in ref["http"]][:len(http)])
        print(json.dumps(dict(
            phase="serve_7b_mesh", tp=tp, backend=backend, B=8, wall_s=wall, build_s=build_s,
            probe_s=probe_s, serve_s=serve_s, http_s=http_s, timing_s=timing_s,
            admit_ms=timing["admit_ms"], trace_s=timing["trace_s"], prefix_hits=served["prefix_hits"], equal_to_single_device=equal,
            rank_digests_equal=len(set(probe["digests"])) == 1, step_host_ms_median=host,
            step_host_ms=timing["step_host_ms"], step_traced_host_ms=timing["step_traced_host_ms"],
            step_device_ms=timing["step_device_ms"],
            step_collective_host_ms=timing["step_collective_host_ms"],
            step_launches=timing["step_launches"], step_kernels=timing["step_kernels"],
            serve_launches=counts["launches"], http_requests=len(http), card=smi_line)),
            flush=True)
        check(len(probe["digests"]) == tp and len(set(probe["digests"])) == 1,
              f"{label}: the ranks' logits differ: {probe['digests']}")
        check(equal["prefill"] and equal["decode"],
              f"{label}: the prefill's or the first decode step's logits part from the "
              f"single-device engine's")
        check(equal["streams"] and served["prefix_hits"] == ref["served"]["prefix_hits"] == 1,
              f"{label}: streams {served['streams']} (hits {served['prefix_hits']}) != the "
              f"single-device engine's {ref['served']['streams']} (hits "
              f"{ref['served']['prefix_hits']})")
        check(all(s and all(0 <= t < cfg.vocab_size for t in s) for s in served["streams"]),
              f"{label}: a stream is empty or out of vocabulary")
        check(not counts["plain"], f"{label}: plain versions ran: {counts['plain']}")
        want = mesh_step_launches(cfg.n_layers, tp)
        check(timing["step_launches"] == want,
              f"{label}: a decode step launched {timing['step_launches']}, want {want}")
        path = {"K1", "K2", "K6", "K7", "K9", "K10"} | ({"K1:i32"} if tp == 2 else set())
        check(path <= set(counts["launches"]) and (tp == 2 or "K1:i32" not in counts["launches"]),
              f"{label}: the serving run launched {counts['launches']}, want {sorted(path)}")
        if tp == 2:
            check(len(http) == MESH_HTTP_REQUESTS and equal["http"],
                  f"{label}: HTTP answers {[h['text'] for h in http]} != the single-device "
                  f"server's {[h['text'] for h in ref['http']]}")
        out[tp] = counts["launches"]
        torch.cuda.empty_cache()
    return out[2]


def _to(obj, device):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if not dataclasses.is_dataclass(obj):
        return obj  # a QuantTensor's logical sizes
    return type(obj)(**{f.name: _to(getattr(obj, f.name), device)
                        for f in dataclasses.fields(obj)})


def _greedy(engine, logits, slot: int, pos: int, steps: int, teacher=None):
    """``steps`` greedy decode steps of one slot from its next-token logits,
    fed at ``pos`` on (each step's pick, or ``teacher``'s tokens where
    given); the engine's other slots feed token 0 at position 0.  Returns
    (the picks, the logits of every step, the first included)."""
    toks, out = [], [logits]
    B = engine.max_batch
    for i in range(steps):
        toks.append(int(np.argmax(out[-1])))
        tok, p = np.zeros(B, np.int64), np.zeros(B, np.int64)
        tok[slot], p[slot] = toks[-1] if teacher is None else teacher[i], pos
        out.append(engine.decode(tok, p)[slot])
        pos += 1
    return toks, out


def _greedy_prompt(engine, seq, steps, teacher=None):
    """Prefill ``seq`` into slot 0 (a paged engine reserves the pages of
    the whole run), then ``_greedy``."""
    first = engine.prefill([seq], [0], reserve_tokens=[len(seq) + steps + 1])[0]
    return _greedy(engine, first, 0, len(seq), steps, teacher)


def _parity(torch, cfg, act_dtype, seq, attn, fuse, fused=False, page_size=None, seed=1,
            steps=PARITY_STEPS):
    """One greedy request of ``steps`` decode steps on the card and on the CPU,
    from the same weights (drawn from ``seed``; fused layouts with
    ``fuse``), both with decode
    attention ``attn`` and fused decode ``fused``, on a dense INT8 cache or,
    with ``page_size``, a paged one; returns the reading as a dict, with the
    card run's kernel launches."""
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    gpu = random_quant_params(cfg, seed=seed, norm_dtype=act_dtype, fuse=fuse)
    cpu = _to(gpu, "cpu")
    paged = page_size is not None
    kw = dict(max_batch=1, kv_dtype="int8", seq_len=64, attn=attn, fused=fused,
              prefill_attn="flash")
    if paged:
        kw.update(kv_layout="paged", page_size=page_size)
    t0 = time.time()
    c_toks, c_log = _greedy_prompt(Engine(cpu, cfg, device="cpu", **kw), seq, steps)
    t1 = time.time()
    _kernels.reset_counts()  # the card, fed the CPU's picks: every step sees the same inputs
    g_toks, g_log = _greedy_prompt(Engine(gpu, cfg, **kw), seq, steps, teacher=c_toks)
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_CALLS)
    t2 = time.time()
    path = FUSED_PREFILL_PATH if fuse else PREFILL_PATH
    if paged:
        path = path - {"K7"} | {"K15"}
    if attn == "xla":  # the plain PyTorch decode launches no kernel
        decode = {}
    else:
        decode = {k: n * steps
                  for k, n in decode_launches(fused, attn, cfg.n_layers, paged).items()}
    got = {k: n for k, n in launches.items() if n > 0}
    check(set(got) == path | set(decode) and not any(plain.values())
          and all(launches[k] >= n for k, n in decode.items())
          and all(launches[k] == n for k, n in decode.items() if k not in path),
          f"parity {attn} fused={fused!r}: want launches of exactly {sorted(path | set(decode))} "
          f"(per decode step "
          f"{decode_launches(fused, attn, cfg.n_layers, paged) if decode else {}}), "
          f"got {launches}; plain calls {plain}")
    same = next((i for i, (a, b) in enumerate(zip(g_toks, c_toks)) if a != b), steps)
    errs = [float(np.abs(g - c).max()) for g, c in zip(g_log, c_log)]
    parts = [_parting(g, c, step=i) for i, (g, c) in enumerate(zip(g_log, c_log))
             if np.argmax(g) != np.argmax(c)]
    return dict(activations=str(act_dtype).removeprefix("torch."), fused_layouts=fuse,
                fused_decode=fused, steps=steps,
                tokens_equal=same, card_tokens=g_toks, cpu_tokens=c_toks, partings=parts,
                prefill_logit_max_err=errs[0], logit_max_err=max(errs),
                logit_peak=float(np.abs(c_log[0]).max()),
                finite=bool(all(np.isfinite(x).all() for x in g_log)),
                card_s=t2 - t1, cpu_s=t1 - t0, card_launches=launches)


def _parting(g, c, **where) -> dict:
    """A step (and slot) whose card logits ``g`` pick another token than
    the CPU's ``c``: the CPU's gap between the two picks, as a share of the
    row's max |logit| too, and the row's largest card-CPU error."""
    cp, gp = int(np.argmax(c)), int(np.argmax(g))
    gap, peak = float(c[cp] - c[gp]), float(np.abs(c).max())
    return dict(**where, gap=gap, gap_share=gap / peak, err=float(np.abs(g - c).max()))


def _parity_prompt(cfg) -> list:
    """Phase 5's 16-token prompt."""
    return [1] + [int(t) for t in np.random.default_rng(5).integers(3, cfg.vocab_size, 15)]


def _check_picks(label: str, r: dict, near_tie: float | None) -> None:
    """The card's picks equal the CPU's, fed the same tokens; with a
    ``near_tie`` limit but where the CPU's gap between the two is at most
    that share of the row's max |logit|."""
    ok = all(near_tie is not None and p["gap_share"] <= near_tie for p in r["partings"])
    rule = (f"may part only at a CPU gap within {near_tie} of max |logit|"
            if near_tie is not None else "may not part")
    check(ok, f"{label}: greedy picks part ({rule}): {r['partings']}; "
              f"card {r['card_tokens']}, cpu {r['cpu_tokens']}")


def parity_2layer(torch):
    """Phase 5 for each decode attention on unfused weights, and on fused
    ones for K9 with the unfused decode, the two-launch decode (K11 + K9),
    mega2 (K12), mega3 (K26) and mega (K27); returns the card launches of
    each f32 run, by its (attn, fused decode)."""
    from tpu_llama_torch.config import LLAMA2_7B

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    seq = _parity_prompt(cfg)
    launches = {}
    for attn, fuse, fused in (("xla", False, False), ("flash", False, False),
                              ("flash_dma", False, False), ("flash_dma", True, False),
                              ("flash_dma", True, True), ("flash_dma", True, "mega2"),
                              ("flash_dma", True, "mega3"), ("flash_dma", True, "mega")):
        f32 = _parity(torch, cfg, torch.float32, seq, attn, fuse, fused)
        bf16 = _parity(torch, cfg, torch.bfloat16, seq, attn, fuse, fused,
                       steps=PARITY_BF16_STEPS)
        launches[attn, fused] = f32["card_launches"]
        attn = attn + (" fused layouts" if fuse else "") + (f", fused={fused!r}" if fused else "")
        print(json.dumps(dict(phase="parity_2layer", attn=attn, f32=f32, bf16=bf16,
                              tol=LOGITS_TOL)), flush=True)
        check(f32["finite"] and bf16["finite"], f"{attn}: card logits not finite")
        _check_picks(f"{attn} f32", f32, near_tie=PARITY_NEAR_TIE if fuse else None)
        check(f32["logit_max_err"] <= LOGITS_TOL * f32["logit_peak"],
              f"{attn}: f32 logits: max err {f32['logit_max_err']} > {LOGITS_TOL} * "
              f"{f32['logit_peak']}")
        check(bf16["prefill_logit_max_err"] <= LOGITS_TOL * bf16["logit_peak"],
              f"{attn}: bf16 prefill logits: max err {bf16['prefill_logit_max_err']} > "
              f"{LOGITS_TOL} * {bf16['logit_peak']}")
    return launches


PARITY_PS = 16  # phase 5's page size: the 16-token prompt ends on a page boundary


def parity_paged(torch):
    """Phase 5 for the paged path on the 2-layer 7B-width model in the fused
    layouts with f32 activations, card (kernels) against CPU (plain
    versions), pages of PARITY_PS rows: one greedy request per decode
    attention (K13 "flash_dma", K20 "flash") and fused decode (False, the
    two-launch True), the card fed the CPU's picks: logits within
    LOGITS_TOL of max |logit| at all PARITY_STEPS steps and picks equal;
    then a paged prefix continuation on a
    pool of 128-row pages (300-token prefill, snapshot: a boundary page
    copied, restore into another slot, ``prefill_continue`` of 40 more
    tokens through the mp_cap-bounded gather, 8 greedy steps), whose tokens
    must equal a cold 340-token paged prefill's on the same side, and the
    card's the CPU's.  Returns the card launches of each greedy run, by its
    (attn, fused decode)."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    seq = _parity_prompt(cfg)
    launches = {}
    for attn, fused in (("flash_dma", False), ("flash", False), ("flash_dma", True),
                        ("flash", True)):
        r = _parity(torch, cfg, torch.float32, seq, attn, True, fused, page_size=PARITY_PS)
        launches[attn, fused] = r["card_launches"]
        label = f"paged {attn}, fused={fused!r}"
        print(json.dumps(dict(phase="parity_paged", attn=attn, fused_decode=fused,
                              page_size=PARITY_PS, f32=r, tol=LOGITS_TOL)), flush=True)
        check(r["finite"], f"{label}: card logits not finite")
        _check_picks(label, r, near_tie=None)
        check(r["logit_max_err"] <= LOGITS_TOL * r["logit_peak"],
              f"{label}: logits: max err {r['logit_max_err']} > {LOGITS_TOL} * {r['logit_peak']}")

    gpu = tl.random_quant_params(cfg, seed=3, norm_dtype=torch.float32, fuse=True, device=CARD)
    cpu = _to(gpu, "cpu")
    seq = [1] + [int(t) for t in np.random.default_rng(56).integers(3, cfg.vocab_size, 339)]
    streams = {}
    for params, dev in ((gpu, CARD), (cpu, "cpu")):
        _kernels.reset_counts()
        kw = dict(seq_len=512, kv_layout="paged", page_size=128, attn="flash_dma", fused=True,
                  prefill_attn="flash", device=dev)
        eng = Engine(params, cfg, max_batch=2, **kw)
        budget = len(seq) + PARITY_STEPS + 1
        eng.prefill([seq[:300]], [0], reserve_tokens=[budget])
        snap = eng.snapshot_slot(0, 300)
        check(snap is not None and len(snap["pages"]) == 3, f"paged prefix: snapshot {snap}")
        eng.release_slot(0)  # parked: its decode rows go to the trash page, not the shared ones
        eng.restore_slot(1, snap, reserve_tokens=budget)
        first = eng.prefill_continue([seq[300:]], [1], [300])[0]
        cont, _ = _greedy(eng, first, 1, len(seq), PARITY_STEPS)
        eng.release_snapshot(snap)
        eng.release_slot(1)
        cold, _ = _greedy(eng, eng.prefill([seq], [0], reserve_tokens=[budget])[0], 0, len(seq),
                          PARITY_STEPS)
        streams[dev] = dict(continued=cont, cold=cold)
        if dev == CARD:
            got = {k for k, n in _kernels.LAUNCHES.items() if n}
            plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
            check(not plain and got == FUSED_PREFILL_PATH - {"K7"} | {
                "K15", "K8", "K11", "K13", "K14"}, f"paged prefix: launches {got}, plain {plain}")
        del eng
    print(json.dumps(dict(phase="parity_paged_prefix", prefix=300, suffix=len(seq) - 300,
                          page_size=128, steps=PARITY_STEPS, tokens=streams)), flush=True)
    check(all(v["continued"] == v["cold"] for v in streams.values()),
          f"paged prefix parity: continued and cold streams differ: {streams}")
    check(streams[CARD] == streams["cpu"], f"paged prefix parity: card and CPU differ: {streams}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return launches


def parity_pool_direct(torch, seed=4, hold_picks=True):
    """Phase 5 for the pool-direct prefill on the 2-layer 7B-width model in
    the fused layouts with f32 activations (weights drawn from ``seed``),
    card (kernels) against CPU (plain versions):
    ``forward_prefill_paged_chunked`` of B 2, T 1024
    (lengths 1024 and 700), chunk 256, into a paged engine's reserved pages
    (ps 512), then PARITY_STEPS greedy decode steps of both slots (the
    two-launch decode with K13, what "auto" picks on the card, asked for on
    the CPU), the card fed the CPU's picks: every step's logits within
    LOGITS_TOL of max |logit| and picks equal but at near ties
    (POOL_NEAR_TIE; the seed sweep that sets it passes ``hold_picks``
    False).  On each side the same prompts prefilled in two
    waves through ``start0`` (0 and 512, max_pos 1024) must leave the pool
    the one-shot call leaves and give its logits (both rows end in the
    second wave), bit for bit.  Returns the reading."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    gpu = tl.random_quant_params(cfg, seed=seed, norm_dtype=torch.float32, fuse=True,
                                 device=CARD)
    cpu = _to(gpu, "cpu")
    rng = np.random.default_rng(57)
    B, T, chunk, W = 2, 1024, 256, 512
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    lengths = np.array([1024, 700])
    side = {}
    for params, dev in ((cpu, "cpu"), (gpu, CARD)):  # the card is fed the CPU's picks
        t0 = time.time()
        tk, ln = torch.tensor(toks, device=dev), torch.tensor(lengths, device=dev)
        engines = []
        for _ in range(2):
            eng = Engine(params, cfg, max_batch=B, kv_layout="paged", page_size=PAGED_PS,
                         seq_len=2048, attn="flash_dma", fused=True, device=dev)
            for s, n in enumerate(lengths):
                eng.pool.reserve(s, int(n) + PARITY_STEPS + 1)
            eng._sync_page_table()
            engines.append(eng)
        _kernels.reset_counts()
        last, _ = tl.forward_prefill_paged_chunked(params, engines[0].cache, tk, ln, [0, 1], cfg,
                                                   chunk=chunk, precision=engines[0].precision)
        launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
        waves = [tl.forward_prefill_paged_chunked(params, engines[1].cache, tk[:, w:w + W], ln,
                                                  [0, 1], cfg, chunk=chunk, start0=w,
                                                  max_pos=T)[0] for w in range(0, T, W)]
        waves_equal = torch.equal(waves[-1], last) and all(
            torch.equal(getattr(engines[0].cache, a)[:, 1:], getattr(engines[1].cache, a)[:, 1:])
            for a in engines[0].cache.arrays)
        del engines[1], waves
        eng = engines[0]
        logits = [last.cpu().numpy()]
        out, pos = [], lengths.copy()
        for i in range(PARITY_STEPS):
            out.append(np.argmax(logits[-1], axis=-1))
            feed = out[-1] if dev == "cpu" else np.asarray(side["cpu"]["tokens"])[:, i]
            logits.append(eng.decode(feed, pos))
            pos = pos + 1
        side[dev] = dict(tokens=np.stack(out, 1).tolist(), logits=logits, waves_equal=waves_equal,
                         launches=launches, plain=plain, s=time.time() - t0)
        del eng, engines
    card, cpu_s = side[CARD], side["cpu"]
    same = next((i for i in range(PARITY_STEPS)
                 if [t[i] for t in card["tokens"]] != [t[i] for t in cpu_s["tokens"]]),
                PARITY_STEPS)
    errs = [float(np.abs(g - c).max()) for g, c in zip(card["logits"], cpu_s["logits"])]
    parts = [_parting(g[b], c[b], step=i, slot=b)
             for i, (g, c) in enumerate(zip(card["logits"], cpu_s["logits"])) for b in range(B)
             if g[b].argmax() != c[b].argmax()]
    peak = float(np.abs(cpu_s["logits"][0]).max())
    L = cfg.n_layers
    reading = dict(phase="parity_pool_direct", seed=seed, B=B, T=T, chunk=chunk,
                   lengths=lengths.tolist(), page_size=PAGED_PS, steps=PARITY_STEPS,
                   tokens_equal=same, card_tokens=card["tokens"], cpu_tokens=cpu_s["tokens"],
                   partings=parts, prefill_logit_max_err=errs[0], logit_max_err=max(errs),
                   logit_peak=peak, tol=LOGITS_TOL,
                   waves_equal_one_shot=dict(card=card["waves_equal"], cpu=cpu_s["waves_equal"]),
                   card_prefill_launches=card["launches"], card_s=card["s"], cpu_s=cpu_s["s"])
    print(json.dumps(reading), flush=True)
    n = L * T // chunk
    check(not card["plain"] and card["launches"].get("K16") == n
          and card["launches"].get("K17") == n and "K15" not in card["launches"],
          f"pool-direct parity: card launches {card['launches']}, plain {card['plain']}")
    check(all(np.isfinite(x).all() for x in card["logits"]), "pool-direct parity: not finite")
    if hold_picks:
        _check_picks("pool-direct parity", reading, near_tie=POOL_NEAR_TIE)
    check(max(errs) <= LOGITS_TOL * peak,
          f"pool-direct parity: logits differ by {max(errs)} > {LOGITS_TOL} * {peak}")
    check(card["waves_equal"] and cpu_s["waves_equal"],
          "pool-direct parity: start0 waves differ from the one-shot prefill")
    del gpu, cpu
    torch.cuda.empty_cache()
    return reading


def parity_seed_sweep(torch, seeds, smi) -> None:
    """``--parity-seeds``: phase 5's f32 greedy runs over weight ``seeds``,
    the card fed the CPU's picks as there: the fused layouts with each
    fused decode, the paged path (K13, K20) and the pool-direct prefill.
    Prints each run's partings (the CPU's gap over the row's max |logit|)
    and logits error, then the largest gap share by group: the readings
    that set PARITY_NEAR_TIE and POOL_NEAR_TIE."""
    from tpu_llama_torch.config import LLAMA2_7B

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    seq = _parity_prompt(cfg)
    groups = {"fused layouts": [], "paged": [], "pool-direct": []}
    for seed in seeds:
        runs = [("fused layouts", f"fused={f!r}", dict(attn="flash_dma", fused=f))
                for f in (False, True, "mega2", "mega3", "mega")]
        runs += [("paged", f"paged {a}", dict(attn=a, fused=False, page_size=PARITY_PS))
                 for a in ("flash_dma", "flash")]
        for group, name, kw in runs:
            r = _parity(torch, cfg, torch.float32, seq, fuse=True, seed=seed, **kw)
            groups[group].append(r)
            print(json.dumps(dict(phase="parity_seed", seed=seed, run=name,
                                  partings=r["partings"],
                                  logit_err_share=r["logit_max_err"] / r["logit_peak"],
                                  card=smi)), flush=True)
        groups["pool-direct"].append(parity_pool_direct(torch, seed=seed, hold_picks=False))
    summary = {g: dict(runs=len(rs), parted=sum(bool(r["partings"]) for r in rs),
                       partings=sum(len(r["partings"]) for r in rs),
                       max_gap_share=max((p["gap_share"] for r in rs for p in r["partings"]),
                                         default=None),
                       max_logit_err_share=max(r["logit_max_err"] / r["logit_peak"] for r in rs))
               for g, rs in groups.items()}
    print(json.dumps(dict(phase="parity_seed_summary", seeds=seeds, groups=summary, card=smi)),
          flush=True)


# phase 5's checkpoint runs: (weights, cache, decode attention) on both
# sides, and the limit of every step's logits as a share of max |logit|.
# Readings on an H100: dense f32 weights over an f32 cache 8.2e-6 (f32 sum
# order only), over a bf16 cache 4.8e-4 (a K/V value rounded to bf16 on
# either side of a boundary), Q8_0 over bf16 8.0e-3 (K25 rounds x to
# bf16).  The limits are ~10x those, LOGITS_TOL for Q8_0: an fp form that
# rounded q or p to bf16 moves its attention output by ~1e-3 of itself.
CKPT_RUNS = (("dense", "float32", "flash_dma", 1e-4), ("dense", "float32", "flash", 1e-4),
             ("q8_0", "bfloat16", "flash_dma", LOGITS_TOL), ("dense", "bfloat16", "flash", 5e-3))


def parity_checkpoint(torch):
    """Phase 5 for this slice's paths: the 2-layer 7B-width model written as
    a llama2.c checkpoint (``make_random_weights`` -> ``write_checkpoint``
    into an ignored directory of the checkout) and read back
    (``load_checkpoint`` -> ``params_from_raw``, f32), one greedy request
    of PARITY_STEPS steps on the card (kernels) and on the CPU (plain
    versions) with ``precision="highest"`` and the same explicit decode
    attention and ``fused=False`` on both sides, for each of CKPT_RUNS:
    dense f32 weights over a float32 cache (K9's and K19's fp forms) and a
    bfloat16 one (K19's), Q8_0 weights (quantized once, on the card, and
    copied) over a bfloat16 cache.  f32 activations: greedy tokens equal at
    every step, every step's logits within the run's limit of max |logit|.
    Returns the card launches of each run, by its (weights, cache,
    attention)."""
    from pathlib import Path

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.io import load_checkpoint, make_random_weights, write_checkpoint
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    path = Path(__file__).resolve().parent / "build" / "parity" / "model.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    write_checkpoint(path, make_random_weights(cfg, seed=7))
    raw = load_checkpoint(path)
    check(raw.config == cfg, f"checkpoint header {raw.config} != {cfg}")
    dense = {CARD: tl.params_from_raw(raw, device=CARD), "cpu": tl.params_from_raw(raw,
                                                                                  device="cpu")}
    q8 = tl.quantize_params(dense[CARD])
    weights = {"dense": dense, "q8_0": {CARD: q8, "cpu": _to(q8, "cpu")}}
    del raw
    ckpt_s = time.time() - t0
    seq = [1] + [int(t) for t in np.random.default_rng(6).integers(3, cfg.vocab_size, 15)]
    launches = {}
    for w, kv, attn, tol in CKPT_RUNS:
        side = {}
        for dev in (CARD, "cpu"):
            _kernels.reset_counts()
            t0 = time.time()
            eng = Engine(weights[w][dev], cfg, max_batch=1, kv_dtype=kv, precision="highest",
                         seq_len=64, attn=attn, fused=False, prefill_attn="flash", device=dev)
            toks, logits = _greedy_prompt(eng, seq, PARITY_STEPS)
            side[dev] = dict(toks=toks, logits=logits, s=time.time() - t0,
                             launches={k: n for k, n in _kernels.LAUNCHES.items() if n},
                             plain={k: n for k, n in _kernels.PLAIN_CALLS.items() if n})
            del eng
        card, cpu = side[CARD], side["cpu"]
        launches[w, kv, attn] = card["launches"]
        same = next((i for i, (a, b) in enumerate(zip(card["toks"], cpu["toks"])) if a != b),
                    PARITY_STEPS)
        errs = [float(np.abs(card["logits"][i] - cpu["logits"][i]).max())
                for i in range(same + 1)]
        peak = float(np.abs(cpu["logits"][0]).max())
        print(json.dumps(dict(phase="parity_checkpoint", weights=w, kv_dtype=kv, attn=attn,
                              steps=PARITY_STEPS, tokens_equal=same, card_tokens=card["toks"],
                              cpu_tokens=cpu["toks"], prefill_logit_max_err=errs[0],
                              logit_max_err=max(errs), logit_peak=peak, tol=tol,
                              card_launches=card["launches"], card_plain_calls=card["plain"],
                              card_s=card["s"], cpu_s=cpu["s"], checkpoint_s=ckpt_s)),
              flush=True)
        label = f"checkpoint parity {w} weights, {kv} cache, {attn}"
        check(not card["plain"], f"{label}: plain versions ran on the card: {card['plain']}")
        check(all(np.isfinite(x).all() for x in card["logits"]), f"{label}: logits not finite")
        check(same == PARITY_STEPS, f"{label}: greedy tokens differ at step {same}: card "
                                    f"{card['toks']}, cpu {cpu['toks']}")
        check(max(errs) <= tol * peak, f"{label}: logits differ by {max(errs)} > {tol} * {peak}")
    del weights, dense, q8
    torch.cuda.empty_cache()
    return launches


def checkpoint_text_surface(torch, smi_line):
    """Phase 5 on ``parity_checkpoint``'s file (the 2-layer 7B-width
    llama2.c checkpoint, kept for this), with a 32000-entry byte
    tokenizer's ``tokenizer.bin`` saved beside it: ``python3 -m
    tpu_llama_torch.cli <ckpt> --tokenizer <tok> --quant w8a8 --kv-dtype
    int8 -t 0 -n 24 -i <prompt>`` as a subprocess on the card exits 0, and
    its stdout before the tok/s line equals the prompt echo and the text of
    an in-process greedy run of the same request on the engine that
    ``EngineConfig.build_engine`` builds from a JSON naming the same files
    (the CLI's settings: fused W8A8, INT8 cache, one slot, mega2), which
    serves it through ``ContinuousBatcher``.  Removes both files."""
    import os
    from pathlib import Path

    from tpu_llama_torch.io.tokenizer import BOS
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import ContinuousBatcher, Request
    from tpu_llama_torch.utils import EngineConfig

    root = Path(__file__).resolve().parent
    d = root / "build" / "parity"
    ckpt, tok_path, cfg_path = d / "model.bin", d / "tokenizer.bin", d / "engine.json"
    prompt, steps = "Once upon a time", 24  # 16 prompt tokens after BOS: 7 generated
    try:
        tok = byte_tokenizer(32000)
        tok.save(tok_path)
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "tpu_llama_torch.cli", str(ckpt), "--tokenizer",
             str(tok_path), "--quant", "w8a8", "--kv-dtype", "int8", "-t", "0", "-n",
             str(steps), "-i", prompt], cwd=root, capture_output=True, timeout=600,
            env=dict(os.environ, PYTHONIOENCODING="utf-8"))
        cli_s = time.time() - t0
        out = res.stdout.decode("utf-8", errors="replace")
        check(res.returncode == 0, f"the CLI exited {res.returncode}: "
                                   f"{res.stderr.decode(errors='replace')[-2000:]}")
        check("\n\nachieved tok/s: " in out, f"the CLI printed no tok/s line: {out[-500:]!r}")
        cli_text = out.split("\n\nachieved tok/s")[0]
        t0 = time.time()
        EngineConfig(checkpoint=str(ckpt), tokenizer=str(tok_path), quant="w8a8",
                     kv_dtype="int8", max_batch=1, precision="highest").save(cfg_path)
        engine, tok2 = EngineConfig.load(cfg_path).build_engine()
        build_s = time.time() - t0
        check(engine.device.type == "cuda" and engine.decode_fused == "mega2",
              f"EngineConfig built {engine.device} / {engine.decode_fused!r}")
        ptoks = tok2.encode(prompt)
        req = Request(prompt_tokens=ptoks, steps=steps, temperature=0.0)
        _kernels.reset_counts()
        b = ContinuousBatcher(engine)
        b.submit(req)
        b.run()
        plain = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
        text = tok2.decode(ptoks, prev_token=BOS) + tok2.decode(req.out_tokens,
                                                                prev_token=ptoks[-1])
        print(json.dumps(dict(phase="checkpoint_text_surface", cli_s=cli_s, build_engine_s=build_s,
                              cli_rc=res.returncode, prompt_tokens=len(ptoks),
                              tokens=req.out_tokens, texts_equal=cli_text == text,
                              card_plain_calls=plain, card=smi_line)), flush=True)
        check(req.done and len(req.out_tokens) > 0, "the EngineConfig engine served no tokens")
        check(not plain, f"plain versions ran on the card: {plain}")
        check(cli_text == text, f"the CLI's text {cli_text!r} != the in-process run's {text!r}")
        del engine, b
        torch.cuda.empty_cache()
        mesh_route(torch, smi_line, ckpt, tok_path, cfg_path, ptoks, steps)
    finally:
        for f in (ckpt, tok_path, cfg_path):
            f.unlink(missing_ok=True)
    torch.cuda.empty_cache()


def mesh_route(torch, smi_line, ckpt, tok_path, cfg_path, ptoks, steps):
    """Phase 5's mesh route on the same checkpoint: ``EngineConfig`` with
    ``"mesh": {"data": 1, "model": 2}`` and unfused layouts (``fuse``
    false: the sharded engine) builds a ``MeshEngine`` of two gloo ranks on
    the card, each loading the memory-mapped file and quantizing and
    cutting its shard on the card in turn (``rank_engine``); one greedy
    request through ``ContinuousBatcher`` on it equals, token for token,
    the single-device engine that the same file builds without a mesh.
    Prints the build's seconds of each."""
    from tpu_llama_torch.runtime import ContinuousBatcher, Request
    from tpu_llama_torch.utils import EngineConfig

    def serve(mesh_model):
        cfg = EngineConfig(checkpoint=str(ckpt), tokenizer=str(tok_path), quant="w8a8",
                           kv_dtype="int8", max_batch=1, fuse=False)
        cfg.mesh_model = mesh_model
        cfg.save(cfg_path)
        t0 = time.time()
        engine, _ = EngineConfig.load(cfg_path).build_engine()
        build_s = time.time() - t0
        req = Request(prompt_tokens=ptoks, steps=steps, temperature=0.0)
        b = ContinuousBatcher(engine)
        b.submit(req)
        b.run()
        kind = (type(engine).__name__, engine.spmd, engine.tp_fused, engine.decode_fused)
        if mesh_model > 1:
            engine.close()
        return dict(tokens=req.out_tokens, build_s=build_s, kind=kind)

    single = serve(1)
    torch.cuda.empty_cache()
    mesh = serve(2)
    print(json.dumps(dict(phase="checkpoint_mesh_route", mesh={"data": 1, "model": 2},
                          backend="gloo", build_s=mesh["build_s"],
                          single_build_s=single["build_s"], tokens=mesh["tokens"],
                          equal_to_single_device=mesh["tokens"] == single["tokens"],
                          card=smi_line)), flush=True)
    check(mesh["kind"] == ("MeshEngine", True, False, False),
          f"the mesh config built {mesh['kind']}, want the sharded engine")
    check(len(single["tokens"]) > 0 and mesh["tokens"] == single["tokens"],
          f"the mesh route's stream {mesh['tokens']} != one device's {single['tokens']}")


def parity_long_paths(torch):
    """Phase 5 for this slice's paths on the 2-layer 7B-width model with f32
    activations in the fused layouts, card (kernels) against CPU (plain
    versions), decode attention "flash_dma" and mega2 on both sides:
    (i) ``forward_prefill_chunked`` (B 2, T 1024, chunk 256, lengths 1024
    and 700) against the one-shot fresh prefill on each side, then card
    against CPU, last-token logits within LOGITS_TOL of max |logit|, and
    the share of int8 K/V entries that differ in the prompts' rows; (ii)
    prefix reuse: a 300-token prefill into slot 0, snapshot, restore into
    slot 1, ``prefill_continue`` of 40 more tokens and 8 greedy steps, whose
    tokens must equal a cold 340-token prefill's on the same side and the
    card's the CPU's; (iii) the device sampler on one [8, 32000] logits
    tensor with per-row keys, temperatures, top-p and top-k: equal random
    bits and equal tokens on both devices."""
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.ops import sampling as ts
    from tpu_llama_torch.runtime import Engine

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    gpu = tl.random_quant_params(cfg, seed=3, norm_dtype=torch.float32, fuse=True,
                                 device=CARD)
    cpu = _to(gpu, "cpu")
    rng = np.random.default_rng(55)

    # (i) chunked against one-shot
    B, T, chunk = 2, 1024, 256
    toks = rng.integers(3, cfg.vocab_size, (B, T))
    lengths = np.array([1024, 700])
    side = {}
    for params, dev in ((gpu, CARD), (cpu, "cpu")):
        _kernels.reset_counts()
        t0 = time.time()
        tk, ln = torch.tensor(toks, device=dev), torch.tensor(lengths, device=dev)
        cc = tl.make_kv_cache(cfg, B, kv_dtype="int8", seq_len=T, device=dev)
        chunked, _ = tl.forward_prefill_chunked(params, cc, tk, ln, cfg, chunk=chunk,
                                                attn="flash")
        co = tl.make_kv_cache(cfg, B, kv_dtype="int8", seq_len=T, device=dev)
        one, _ = tl.forward_prefill(params, co, tk, torch.zeros(B, device=dev), ln, cfg,
                                    logits_mode="last", assume_fresh=True, attn="flash")
        side[dev] = dict(chunked=chunked.cpu().numpy(), one=one.cpu().numpy(),
                         kv=[c.cpu() for c in (cc.k, cc.v)], kv_one=[c.cpu() for c in (co.k, co.v)],
                         launches=dict(_kernels.LAUNCHES), s=time.time() - t0)
        del cc, co

    def flip_share(a, b):
        rows = [(x[:, i, :, :n] != y[:, i, :, :n]).float().mean().item()
                for x, y in zip(a, b) for i, n in enumerate(lengths)]
        return float(np.mean(rows))

    peak = float(np.abs(side["cpu"]["one"]).max())
    errs = dict(card_chunked_vs_one_shot=float(np.abs(side[CARD]["chunked"]
                                                      - side[CARD]["one"]).max()),
                cpu_chunked_vs_one_shot=float(np.abs(side["cpu"]["chunked"]
                                                     - side["cpu"]["one"]).max()),
                card_vs_cpu_chunked=float(np.abs(side[CARD]["chunked"]
                                                 - side["cpu"]["chunked"]).max()))
    flips = dict(card_chunked_vs_one_shot=flip_share(side[CARD]["kv"], side[CARD]["kv_one"]),
                 card_vs_cpu_chunked=flip_share(side[CARD]["kv"], side["cpu"]["kv"]))
    k18 = side[CARD]["launches"]["K18"]
    print(json.dumps(dict(phase="parity_chunked", B=B, T=T, chunk=chunk,
                          lengths=lengths.tolist(), logit_max_err=errs, logit_peak=peak,
                          int8_kv_flip_share=flips, card_k18_launches=k18,
                          card_s=side[CARD]["s"], cpu_s=side["cpu"]["s"], tol=LOGITS_TOL)),
          flush=True)
    check(k18 == cfg.n_layers * T // chunk, f"chunked parity: K18 launched {k18} times")
    check(all(np.isfinite(side[d][k]).all() for d in side for k in ("chunked", "one")),
          "chunked parity: logits not finite")
    check(all(e <= LOGITS_TOL * peak for e in errs.values()),
          f"chunked parity: logits differ by {errs} > {LOGITS_TOL} * {peak}")
    del side

    # (ii) prefix reuse against a cold prefill
    seq = [1] + [int(t) for t in rng.integers(3, cfg.vocab_size, 339)]
    streams = {}
    for params, dev in ((gpu, CARD), (cpu, "cpu")):
        kw = dict(kv_dtype="int8", seq_len=512, attn="flash_dma", fused="mega2",
                  prefill_attn="flash", device=dev)
        eng = Engine(params, cfg, max_batch=2, **kw)
        eng.prefill([seq[:300]], [0])
        eng.restore_slot(1, eng.snapshot_slot(0, 300))
        first = eng.prefill_continue([seq[300:]], [1], [300])[0]
        cont, _ = _greedy(eng, first, 1, len(seq), PARITY_STEPS)
        cold, _ = _greedy_prompt(Engine(params, cfg, max_batch=1, **kw), seq, PARITY_STEPS)
        streams[dev] = dict(continued=cont, cold=cold)
        del eng
    print(json.dumps(dict(phase="parity_prefix", prefix=300, suffix=len(seq) - 300,
                          steps=PARITY_STEPS, tokens=streams)), flush=True)
    check(all(v["continued"] == v["cold"] for v in streams.values()),
          f"prefix parity: continued and cold streams differ: {streams}")
    check(streams[CARD] == streams["cpu"], f"prefix parity: card and CPU differ: {streams}")

    # (iii) the sampler
    x = (rng.standard_normal((8, cfg.vocab_size)) * 3).astype(np.float32)
    keys = ts.fold_in(torch.tensor(ts.keys_numpy(range(100, 108))), torch.arange(8) * 250)
    params = (torch.tensor([0.0, 0.8, 1.3, 0.8, 1.3, 0.8, 0.0, 1.0]),
              torch.tensor([1.0, 0.9, 1.0, 1.0, 0.9, 0.9, 1.0, 0.95]),
              torch.tensor([0, 0, 40, 40, 0, 40, 0, 0]))
    u = [ts.uniform(keys.to(d), (cfg.vocab_size,), 1e-20, 1.0).cpu() for d in (CARD, "cpu")]
    toks = {}
    for name in ("sample", "sample_nosort"):
        fn = getattr(ts, name)
        toks[name] = [fn(torch.tensor(x).to(d), keys.to(d), *(p.to(d) for p in params)).tolist()
                      for d in (CARD, "cpu")]
    bits_equal = torch.equal(u[0].view(torch.int32), u[1].view(torch.int32))
    print(json.dumps(dict(phase="parity_sampler", bits_equal=bits_equal, tokens=toks)),
          flush=True)
    check(bits_equal, "sampler parity: the uniform bits differ")
    check(all(a == b for a, b in toks.values()), f"sampler parity: tokens differ: {toks}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Build and drive the port on one CUDA card.")
    ap.add_argument("--parity-seeds", type=int, nargs="+", metavar="SEED",
                    help="only build and run phase 5's greedy runs over these weight seeds "
                         "(the readings behind PARITY_NEAR_TIE, POOL_NEAR_TIE); prints no "
                         "result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from tpu_llama_torch.ops import _kernels
        from tpu_llama_torch.ops import attention as tatt
        from tpu_llama_torch.ops import fused_layer as tfl
        from tpu_llama_torch.ops import fused_step as tfst
        from tpu_llama_torch.ops import fused_step2 as tfs
        from tpu_llama_torch.ops import fused_step3 as tfs3
        from tpu_llama_torch.ops import matmul as tm
        from tpu_llama_torch.ops import quant as tq
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # 1. the device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.time()
    logs = _kernels.build()
    slowest = sorted(_kernels.BUILD_SECONDS.items(), key=lambda kv: -kv[1])[:4]
    print(f"build: {len(logs)} sources ready in {time.time() - t0:.1f} s (slowest: "
          + ", ".join(f"{n} {sec:.1f} s" for n, sec in slowest) + ")")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")
    sys.stdout.flush()

    if args.parity_seeds:
        parity_seed_sweep(torch, args.parity_seeds, smi)
        print(f"total {time.time() - t_start:.1f} s")
        return 0

    # 3. kernels against their plain versions
    results = []
    check_k1(torch, tq, tm, results)
    check_k1_int32(torch, tq, tm, results)
    check_k2(torch, tq, results)
    check_k3(torch, tq, results)
    check_k4(torch, tq, results)
    check_k5(torch, tq, results)
    check_k6(torch, tatt, results)
    check_k7(torch, tatt, results)
    torch.cuda.empty_cache()
    check_decode_attention(torch, tatt, results)
    check_k10(torch, tatt, results)
    check_k18(torch, tatt, results)
    from tpu_llama_torch.runtime import PagePool

    check_paged_writes(torch, tatt, PagePool, results)
    check_paged_attention(torch, tatt, PagePool, results)
    check_pool_direct(torch, tatt, PagePool, results)
    check_k22(torch, tatt, PagePool, results)
    check_fused(torch, tq, tfl, tfs, results)
    check_mega_kernels(torch, tq, tfl, tfs, tfs3, tfst, tatt, results)
    check_k28(torch, tatt, results)
    check_k29(torch, tq, tm, results)
    check_k25(torch, tq, tm, results)
    check_fp_forms(torch, tatt, results)
    check_tp_kernels(torch, tatt, tq, tfl, results)
    print(f"phase 3: {time.time() - t_start:.1f} s", flush=True)
    for r in results:  # launches follow in the kernels line, after the main path
        extra = {k: r[k] for k in ("int8_flip_share", "scale_max_rel_err", "att_int8_flip_share",
                                   "att_scale_max_rel_err", "k9_block256_max_diff",
                                   "k9_block128_max_diff", "k6_dense_copy_max_diff",
                                   "k6_dense_copy_ms", "device_ms", "library_device_ms",
                                   "simt_bound_ms", "int8_peak_share", "form", "cluster", "rows",
                                   "consumers", "cluster_ms", "l2_gb", "l2_gb_s",
                                   "resident_clusters", "splits", "resident_blocks", "ring_tiles",
                                   "smem_bytes") if k in r}
        print(json.dumps(dict(kernel=r["kernel"], name=r["name"], kernel_ms=r["ms"],
                              plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                              bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                              max_err=r["max_abs_err"], **extra, card=smi)), flush=True)

    # 4. the serving path at 7B; 4b. the long-prompt path on the same weights
    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models.llama import random_quant_params

    t0 = time.time()
    params = random_quant_params(LLAMA2_7B, seed=0, norm_dtype=torch.bfloat16, fuse=True)
    torch.cuda.synchronize()
    launches, mega2_streams, serve_line = serve_7b(torch, smi, params, time.time() - t0)
    # a kernel on no path: its launches summed over every phase-4 path's own
    # counts (each reset just before that path runs), and held to 0
    on_no_path = {k: launches.get(k, 0) for k in NO_PATH}

    def no_path(got):
        for k in NO_PATH:
            on_no_path[k] += got.get(k, 0)

    print(f"phase 4: {time.time() - t0:.1f} s", flush=True)
    # 4j. the text server on the same weights, phase 4's engine released
    t0 = time.time()
    no_path(serve_7b_http(torch, smi, params, serve_line))
    print(f"phase 4j: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    got = serve_7b_long(torch, smi, params)
    launches["K18"] = got["K18"]
    no_path(got)
    torch.cuda.empty_cache()
    print(f"phase 4b: {time.time() - t0:.1f} s", flush=True)
    # 4e. the paged INT8 path on the same weights: K15, K13, K14 count there
    t0 = time.time()
    got = serve_7b_paged(torch, smi, params)
    launches.update({k: got.get(k, 0) for k in ("K13", "K14", "K15")})
    no_path(got)
    torch.cuda.empty_cache()
    print(f"phase 4e: {time.time() - t0:.1f} s", flush=True)
    # 4f. the pool-direct paged admission on the same weights: K16, K17 count there
    t0 = time.time()
    got = serve_7b_paged_direct(torch, smi, params)
    launches.update({k: got.get(k, 0) for k in ("K16", "K17")})
    no_path(got)
    torch.cuda.empty_cache()
    print(f"phase 4f: {time.time() - t0:.1f} s", flush=True)
    # 4g. the opt-in fused decodes on the same weights: K26 (mega3) and K27
    # (mega) count there; 4h. an admission through K29, which counts there
    t0 = time.time()
    got = serve_7b_mega(torch, smi, params, mega2_streams)
    launches["K26"], launches["K27"] = got["mega3"]["K26"], got["mega"]["K27"]
    for g in got.values():
        no_path(g)
    print(f"phase 4g: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    got = admission_k29(torch, smi, params)
    launches["K29"] = got["K29"]
    no_path(got)
    print(f"phase 4h: {time.time() - t0:.1f} s", flush=True)
    # 4i. the tensor-parallel serving path: the single-device references on
    # these weights, then ranks that draw them again (the parent's copy
    # freed first); K21, K23 and K24 count there
    t0 = time.time()
    ref_tp = tp_reference(torch, params)
    t_ref = time.time()
    ref_mesh = mesh_reference(torch, params)  # phase 4k's, on these weights
    mesh_ref_s = time.time() - t_ref
    del params
    torch.cuda.empty_cache()
    got = serve_7b_tp(torch, smi, ref_tp)
    launches.update({k: got[k] for k in ("K21", "K21:f32", "K21:bf16", "K23", "K24")})
    no_path(got)
    print(f"phase 4i: {time.time() - t0 - mesh_ref_s:.1f} s", flush=True)
    # 4k. the sharded engine (JAX's GSPMD program) through the controller; K1's
    # int32 form counts there
    t0 = time.time()
    got = serve_7b_mesh(torch, smi, ref_mesh)
    launches["K1:i32"] = got["K1:i32"]
    no_path(got)
    print(f"phase 4k: {time.time() - t0 + mesh_ref_s:.1f} s (its single-device reference "
          f"{mesh_ref_s:.1f} s)", flush=True)

    # 4c. the server's default model: dense f32 weights, fused as serve()
    # fuses them, the default f32 cache; 4d. those weights in Q8_0 (the f32
    # ones freed first) with a bf16 cache.  Each path's kernels count there.
    from tpu_llama_torch.models.llama import fuse_projections, quantize_params, random_params

    t0 = time.time()
    params = fuse_projections(random_params(LLAMA2_7B, dtype=torch.float32, seed=0))
    torch.cuda.synchronize()
    got = serve_7b_fp(torch, smi, params, "serve_7b_dense", "float32", time.time() - t0)
    # the fp forms 4c runs; K21's count in 4i
    launches.update({k: n for k, n in got.items() if ":f32" in k and k != "K21:f32"})
    no_path(got)
    print(f"phase 4c: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    q8 = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got = serve_7b_fp(torch, smi, q8, "serve_7b_q8", "bfloat16", time.time() - t0)
    launches.update({k: n for k, n in got.items()
                     if (":bf16" in k and k != "K21:bf16") or k == "K25"})
    no_path(got)
    del q8
    torch.cuda.empty_cache()
    print(f"phase 4d: {time.time() - t0:.1f} s", flush=True)

    # 5. port parity, card against CPU; a kernel that phase 4 did not run
    # counts its launches on its phase-5 path: K19 on the unfused decode with
    # "flash", K11 on the two-launch decode (and the paths of whatever
    # "auto" did not resolve to)
    t0 = time.time()
    parity = parity_2layer(torch)
    for kernel, path in (("K19", ("flash", False)), ("K11", ("flash_dma", True)),
                         ("K12", ("flash_dma", "mega2")), ("K8", ("flash_dma", "mega2")),
                         ("K9", ("flash_dma", False))):
        if launches[kernel] == 0:
            launches[kernel] = parity[path][kernel]
    parity_long_paths(torch)
    # the paged path; K20 ("flash") counts its launches here (4e decodes with K13)
    launches["K20"] = parity_paged(torch)["flash", False].get("K20", 0)
    parity_pool_direct(torch)
    # the checkpoint-loaded model; K19's fp forms count their launches here
    # (4c and 4d decode with K9's)
    ckpt = parity_checkpoint(torch)
    checkpoint_text_surface(torch, smi)
    for kernel, run in (("K19:f32", ("dense", "float32", "flash")),
                        ("K19:bf16", ("dense", "bfloat16", "flash"))):
        launches[kernel] = ckpt[run].get(kernel, 0)
    print(f"phase 5: {time.time() - t0:.1f} s", flush=True)

    # 6. result lines
    check(not any(on_no_path.values()), f"a main path launched a kernel on no path: "
                                        f"{on_no_path}")
    launches.update(on_no_path)
    missing = sorted({r["kernel"] for r in results
                      if r["kernel"] not in NO_PATH and launches.get(r["kernel"], 0) == 0})
    check(not missing, f"kernels no main path launched: {missing}")
    kernels = []
    for r in results:
        if not r.get("in_line", True):
            continue
        src, replaces = SRC[r["kernel"]]
        kernels.append(dict(name=r["name"], route="cuda", source=src, replaces=replaces,
                            launches=launches[r["kernel"]], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(f"total {time.time() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

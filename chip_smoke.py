#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and runs,
in order, printing one JSON line per phase:

  1. device   -- the card, its power limit, the build time and the
                 ``-Xptxas -v`` report of every kernel; the tensor-core
                 instructions of each (``cuobjdump -sass``): DMMA in the f64
                 kernels of sketch_accum, sketch_matmul, project_out,
                 panel_deflate and tsolve, none in their f32 kernels nor in
                 panel_gram's, panel_apply's, fwht's and panel_step's
                 (factor and sweeps), the TF32 HMMA in every flash kernel,
                 no spills in any;
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the main path's shapes, for f32, f64, c64 and c128, with
                 the tolerance stated; sketch_accum's chunk invariance
                 (bit-exact), and f64 sketch_accum on an operand 8 bytes off
                 16-byte alignment (bit-equal to the aligned call);
                 duplicate-column panels; fwht bit-equal in
                 the real types; tsolve on a pivoted-QR R1 and, by its
                 backward error, on the bench's ill-conditioned R1, and at
                 k=1000 (T re-read) with NaN below R1's diagonal;
                 panel_apply at a 4-rank shard (n=4096) and a ragged
                 shape, repeated bit for bit; panel_step at ragged l and n
                 with b = 1, 17, 33, 64 and in the re-reading geometry
                 (l=4000); fwht at m = 1, 2, 64, 512 (n = 1001) and 2^18;
                 project_out (k=400) and panel_deflate (b=32) at l=800,
                 n=2^14, both outputs of panel_deflate, and panel_deflate
                 at b = 1, 16, 32, 64, at a ragged l and n, in the
                 re-reading geometry (l=4000) and its repeat bit for bit;
                 panel_gram's column split and n = 0 identities (bit for
                 bit); flash at granite's prefill (32 heads, hd 64,
                 S=T=4000, causal), danube's (32 heads, hd 80,
                 S=T=6144, window 4096), qwen2-moe's (16 heads, hd 128,
                 S=T=4000, causal), jamba's (32 heads, hd 128,
                 S=T=4096, causal) and qwen2-vl's (12 heads, hd 128,
                 S=T=4096, causal), a non-causal, a ragged S != T and
                 an hd 256 case, q f32 with k/v bf16 and all f32, each
                 also with its lse (o bit-equal, lse against flash_ref's);
  3. main     -- ``rid(seed, A, 400, sketch_kind="gaussian")`` on a real
                 f64 ``A = B0 @ P0`` of 2^16 x 2^14 (the paper's Table row
                 k=400, m=2^16, n=2^14), with the launch counts of its
                 kernels and the paper's eq. (3) bound;
  stream   -- the streamed ID, ``rid_streamed``, on one card: (a) the
                 main row from an ``ArraySource`` over the host copy of
                 phase main's ``A`` (chunks of 8192 rows through the
                 pinned ring), bit-equal in B, P, J, Q and R to phase
                 main's ``rid``, with the copies overlapped and not, its
                 H2D GB/s and, traced, pass 1's idle share; (b) the
                 paper's 64 GB row (PAPER_GRID[3]: k=400, m=2^18,
                 n=2^14) from a ``SpectrumSource`` generated on the card,
                 f64 and c128: wall, peak device memory within 1 % of the
                 same call at m=2^16, eq. (3) in closed form for the
                 blocked engine (reported) and for CGS2 on the same
                 sketch (gated); (c) a job killed in pass 1 and in pass 2,
                 resumed, bit-equal to an uninterrupted run; no ref.py
                 function given a CUDA tensor;
  sharded  -- ``rid_streamed(..., group=g)`` on a one-rank NCCL group:
                 (a) the main row from the host copy of phase main's
                 ``A``, bit-equal in B, P, J, Q and R to
                 ``rid_distributed(..., qr_impl="panel_parallel")`` on that
                 matrix, overlapped and not, with the launches of
                 sketch_accum (one a chunk), panel_coeff and panel_apply;
                 (b) the paper's 64 GB row in c128 from a
                 ``SpectrumSource`` on the card, peak memory within 1 % of
                 m=2^16's, eq. (3) in closed form, the pivots against phase
                 stream's, watched by a ``TelemetryServer`` on 127.0.0.1
                 (scraped mid pass 1 and at the end, equal to the tracer's
                 counters) and a ``ProgressReporter``; (c) its timeline
                 (self times summing to the wall within 1 %, the critical
                 path), the overlap report of (a)'s two runs and (a)'s
                 ``psum_overlap``; (d) a kill in each pass, resumed
                 bit-equal; (e) ``bench_stream``'s sharded sweep (a
                 ``FileSource``) and ``bench_trace``, both traces
                 validated; (f) a deep-traced ``rid``: 13 ``qr.panel``
                 spans with their device times;
  srht     -- ``rid(seed, A, 400, sketch_kind="srht")`` on a matrix of the
                 main row's shape: the fwht kernel once a factor; eq. (3)
                 for it reported (the blocked engine's reading, ROADMAP
                 Queue C) and for CGS2 on the same sketch gated;
  4. default  -- ``rid(seed, A, 100)`` (srft) on a complex128 ``A`` of
                 2^14 x 2^14 (the paper's row k=100, m=n=2^14);
                 in phases main, srht, default and Table 2, no function of
                 a kernel package's ref.py is given a CUDA tensor;
  5. distributed -- ``rid_distributed(seed, A_loc, 400, group=g,
                 qr_impl="panel_parallel")`` on a one-rank NCCL group at
                 the main path's matrix: launch counts, first and warm wall
                 time, peak memory, eq. (3), pivot overlap with ``rid``;
                 the same call with stage B through panel_apply's plain
                 version (the pivot set equal, P to rounding);
  6. gram     -- ``panel_parallel_pivoted_qr(Y, 400, group=g,
                 panel_impl="gram")`` on that sketch, against the fused
                 path, and its warm wall time;
  7. c128     -- ``rid_distributed(..., qr_impl="panel_parallel")`` on a
                 complex128 ``A`` of 2^14 x 2^14, k=100;
  bench       -- the paper's phase benchmarks (src/repro_torch/benchmarks):
                 Table 2 (bench_sketch) and Table 4 (bench_tsolve) at the
                 main row in f64, Table 1 (bench_total, srft) at the row
                 k=100, m=n=2^14 in c128, with the launch counts of
                 sketch_matmul, fwht (srht_s and srht_cuda_s) and tsolve
                 per call; Table 3
                 (bench_qr) at the main row in f64 and its fused-vs-split
                 sweep (l=256, n=4096, k=128, f32), Table 5 (bench_error)
                 at the row k=100, m=n=2^14 in c128 and its known-spectrum
                 grid on a one-rank NCCL group, with the launches of
                 project_out, panel_deflate, panel_gram and panel_step
                 per call against the counts the code implies;
  serve       -- granite-3-2b at full width (40 layers, d_model 2048,
                 random weights from a seed) through ``ServeEngine(max_batch
                 =4, max_len=4608)``: 6 short prompts and prompts of 3000
                 and 4000 tokens, 16 new tokens each; flash launched once a
                 layer for each long prompt (80); tokens per second, the
                 4000-token prefill, the mean decode step, peak memory; then
                 that prompt's one-shot prefill against ``prefill_chunk`` in
                 512-token chunks (dense, no flash) to a bf16 tolerance,
                 and one prefill and one decode step under
                 ``torch.profiler``;
  swa         -- h2o-danube-1.8b at full width, depth cut to 4 layers: a
                 6144-token prefill (window 4096: skipped kv blocks and the
                 ring-buffer fill; 4 flash launches), 16 decode steps on the
                 ring buffer, the first layer's attention against ref.py;
  moe         -- (a) qwen2-moe-a2.7b at full width and depth (24 layers,
                 60 experts top-4 and 4 shared, 1.432e10 parameters, 57.3
                 GB in f32, random weights from a seed) through the serve
                 phase's engine and 8 requests: flash launched 48 times
                 and nothing else, tokens per second, the 4000-token
                 prefill, the mean decode step, peak memory, the long
                 prefill's moe_drop by layer, the weight casts' byte floor,
                 and one prefill and one batch-4 decode step under
                 ``torch.profiler`` (flash, the dtype casts, the expert
                 SwiGLU and the rest); (b) one layer's moe_ffn on 512
                 tokens in f32 on the card and the CPU: top-k and keep
                 equal, y and the aux values within 1e-4, two card calls
                 bit-equal, the bf16 compute gap; (c) phi3.5-moe and (d)
                 qwen3-8b and qwen2-7b at full width, 4 layers: a
                 4000-token prefill (4 flash launches), 16 decode steps,
                 the first layer's attention against ref.py; (e) qwen2-moe
                 at 2 layers, 1 x 4096 tokens, 2 steps through
                 ``launch.steps``, twice: bit-equal, finite, grad norm > 0;
  hybrid      -- (a) jamba-v0.1-52b at full width, depth cut to one
                 pattern period of 8 layers (7 Mamba, 1 attention, MoE on
                 4; 1.326e10 parameters, 53.1 GB in f32, random weights
                 from a seed) through the serve phase's engine: 5 prompts
                 of at most 128 tokens and one of 4096, flash launched once
                 (the long prompt's one attention layer) and nothing else,
                 tokens per second, the long prefill, the mean decode step,
                 peak memory, and one prefill and one batch-4 decode step
                 under ``torch.profiler`` (flash, the Mamba scan with its
                 launches, the MoE weight casts, the expert SwiGLU and the
                 rest); (b) one Mamba layer on 4096 tokens in f32 on the
                 card and the CPU within 1e-4, two card calls bit-equal;
                 (c) a 120-token prefill and 8 decode steps against
                 ``forward`` over the 128 tokens (f32, dropless MoE) within
                 1e-4; (d) a 4000-token prompt (not a multiple of the
                 scan's 128-token chunk) refused with a ValueError, by
                 ``prefill`` and by the engine, which serves the next
                 request;
  xlstm       -- (a) xlstm-125m at full width and depth (12 layers:
                 mLSTM, sLSTM at 1 and 7; random weights from a seed)
                 through the serve phase's engine: 5 prompts of 14-60
                 tokens and one of 4096, no kernel launched, tokens per
                 second, the long prefill, the mean decode step, peak
                 memory, and one prefill and one batch-4 decode step under
                 ``torch.profiler`` (the ranges xlstm.mlstm and xlstm.slstm
                 with their launches, and the rest); (b) one mLSTM and one
                 sLSTM layer on 1024 tokens in f32, card against CPU within
                 1e-4, two card calls bit-equal; (c) a 64-token prefill and
                 64 decode steps against ``forward`` over the 128 (f32)
                 within 1e-4; (d) a 100-token prompt (over the mLSTM's
                 64-token chunk, not a multiple of it) refused with a
                 ValueError, by ``prefill`` and by the engine, which serves
                 the next request;
  encdec      -- whisper-tiny at full width and depth (4 encoder and 4
                 decoder layers, 1500 frames from a seed): (a) a prefill of
                 4 x 8 tokens with the frames and 32 greedy decode steps,
                 each timed; (b) in f32 the same prefill and 8 decode steps,
                 card against CPU and decode against ``forward``, within
                 1e-4; (c) the engine's refusal of an encoder-decoder;
  vlm         -- (a) qwen2-vl-2b at full width and depth (28 layers,
                 1.544e9 parameters) through the serve phase's engine: 5
                 prompts of at most 128 tokens and one of 4096, flash
                 launched once a layer (28) and nothing else, tokens per
                 second, peak memory, the long prefill under
                 ``torch.profiler`` (flash and the rest); (b) at 2 layers in
                 f32, ``forward`` with patch embeddings on a 4 x 8 image
                 grid before the text and distinct (t, h, w) ids, card
                 against CPU within 1e-4, and the text M-RoPE tables equal
                 to plain RoPE's on the card;
  analysis    -- ``repro_torch.analysis.run_all(device="cuda")`` on a
                 one-rank NCCL group (what ``python -m repro_torch.analysis``
                 runs): 0 new findings against the empty baseline, every
                 control present, big_copy launched on that path; every
                 production kernel's declared launch (grid, block, dynamic
                 shared bytes) equal to the C side's and within 232448 B
                 (panel_deflate, panel_apply, tsolve, flash, panel_step
                 and fwht also at the main path's shapes, panel_deflate and tsolve in their
                 re-reading geometries, panel_apply at a 4-rank shard),
                 big_copy's 64 MiB example over it; then big_copy bit-equal
                 to big_copy_ref at fitting f32 and c128 shapes, its
                 example refused as a status, and sketch_accum right
                 after the refusal held to its plain version;
  8. times    -- each kernel's time at the main path's shapes beside its
                 bound (and, as achieved TFLOP/s and bound / time, the
                 share of it; and the host's time a call, unsynchronized), its plain version's time and the library
                 call's (panel_gram also with n = 0, the Gram alone;
                 panel_step, panel_coeff and tsolve also timed three ways:
                 this script's rounds of events (the first is ``ms``),
                 bench_dmma's least of two rounds, and under
                 ``torch.profiler`` their kernels' device time and device
                 span a call, with the SM clock)
                 (flash at granite's, qwen2-moe's, jamba's and qwen2-vl's
                 serve shapes, beside
                 ``F.scaled_dot_product_attention``, its bound two TF32
                 passes on the tensor cores; big_copy at the
                 analysis phase's f32 shape, beside ``Tensor.clone``);
  9. trace    -- the main path once more: the sketch and the rest timed
                 apart, then one ``rid`` under ``torch.profiler`` (device
                 time by kernel, device idle share).
  10. train   -- granite-3-2b at full width and depth (random weights from
                 a seed, synthetic batches of 2 x 4096 tokens): (a) 5 steps
                 through ``launch.train.train_loop`` (wall, tokens/s, loss,
                 grad norm and lr a step, peak memory, 80 flash launches a
                 step: forward and remat recompute; finite losses and a
                 positive grad norm gated), one more step under
                 ``torch.profiler`` (busy and idle share, the flash kernel,
                 the plain backward, the GEMMs, AdamW), and the attention's
                 forward and plain backward timed alone at the step's shape
                 beside SDPA's; (b) one layer's attention (B=1, 32 heads,
                 S=T=4096) through ``FlashAttention`` against autograd
                 through flash_ref, k/v f32 and bf16, o bit-equal with and
                 without lse, lse against flash_ref's; (c) at 2 layers: two
                 runs bit-equal, a ``fail_at`` run resumed from its
                 checkpoint bit-equal to the uninterrupted one, RandLR rank
                 8 over 2 pod groups within 5 % of the dense loss at the
                 reference test's settings, and at lr 3e-4 cutting the
                 loss by at least half the dense run's drop.
  11. mesh    -- the sharded steps on a one-rank NCCL mesh (1, 1)
                 ("data", "model"), granite-3-2b at full width and depth:
                 (a) 3 sharded train steps of phase train's batches in
                 mode tp, losses within 1e-5 of phase train's (bit-equality
                 reported), and with cast_params within 1e-5 of an
                 unsharded cast run; warm step, tokens/s, peak, the DTensor
                 overhead against an unsharded run of the same config
                 beside it (plain, tp, cast, plain cast), 80 flash launches a
                 step; (b) the sharded prefill of 4 x 4000 tokens and 16
                 greedy decode steps against the plain ones (the serve
                 phase's tolerance, tokens equal, 40 flash launches on
                 each path); (c) the dry-run of five production cells on
                 torch's fake backend (a CPU process a cell, after (a) and
                 (b)): each ``ok``, its per-device peak beside the H100's
                 80 GB, its collective bytes by kind.
  12. scaling -- the paper's Figures 1-2 through
                 ``benchmarks.bench_scaling``: (a) PAPER_GRID rows 0 and 6,
                 blocked and panel_parallel, one rank's work at 4..128
                 ranks counted on torch's fake backend (CPU subprocesses,
                 after (b) and (c): no wall is taken beside them),
                 speedup and efficiency on the H100's published constants
                 (a model, not a multi-card run); (b) SMALL_GRID row 1 and
                 the main row executed on the one-rank NCCL group (4
                 calls), measured over modeled seconds, the main row's
                 launches against phases main and distributed; (c)
                 ``examples/torch/quickstart.py`` on the card, held to the
                 eq. (3) bound it prints.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before that line.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero at once.
"""
from __future__ import annotations

import atexit
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path
from unittest import mock

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
# Phase train's steps are deterministic (``launch.steps``): cuBLAS reads its
# workspace setting when the process makes its first GEMM.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

try:
    from repro_torch.configs import PAPER_GRID
except ImportError as exc:
    print(f"chip_smoke: the port is not beside this script ({exc})",
          file=sys.stderr)
    sys.exit(2)

SEED = 0
# The paper's Table rows (PAPER_GRID[2] and PAPER_GRID[0]); l = 2k.
MAIN, DEFAULT = PAPER_GRID[2], PAPER_GRID[0]
MAIN_K, MAIN_M, MAIN_N = MAIN.k, MAIN.m, MAIN.n
DEFAULT_K, DEFAULT_M, DEFAULT_N = DEFAULT.k, DEFAULT.m, DEFAULT.n
PANEL = 32
# Phase scaling: the rank counts of Figures 1-2 and the engines modeled.
SCALING_PROCS = "4,8,16,32,64,128"
SCALING_IMPLS = ("blocked", "panel_parallel")
# c128 sketch_accum and sketch_matmul run at a quarter of the main path's
# m, so that phase 2 stays within a few seconds (4x the flops of f64 per
# element); c128 fwht at a quarter of n, so that its plain version (a new
# tensor per stage) stays within the card's memory.
C128_ACCUM_M = 2 ** 14
C128_FWHT_N = 2 ** 12
# Normwise backward error bar of the triangular solve, times k * eps.
TSOLVE_BWD_C = 4

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W) for the bounds of the
# f64 timings: HBM3 bytes/s, and the FP64 tensor-core rate, the least time
# the card could take for f64 work.  sketch_accum and project_out run f64 on
# the FP64 tensor cores (DMMA, csrc/dmma_tile.cuh); the other kernels run
# DFMA, whose peak is half of it.
HBM_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 67e12
PEAK_NAME = "FP64 tensor 67 TFLOP/s"
# Kernel-vs-plain tolerances, relative to the largest entry of the plain
# output: the two sum in different orders (the kernel in its own tiles, the
# plain version through the library's GEMMs), so they agree to rounding
# that grows with the reduction length, far inside these bounds.
REL_TOL = {"float32": 1e-4, "complex64": 1e-4,
           "float64": 1e-10, "complex128": 1e-10}
# H100 SXM float32 rate outside the tensor cores (FFMA), the TF32 tensor-
# core rate (the flash kernel's products: two TF32 passes a product with
# f32 q and bf16 k/v, its bound), and the bf16 tensor-core rate (reported
# beside it).
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# Flash kernel vs plain version, relative to the largest plain entry: f32
# sums in another order (online softmax in 64-key blocks against a dense
# softmax).
FLASH_TOL = 1e-5
# (case, B*H, S, T, hd, causal, window): the prefill shapes of granite-3-2b
# and h2o-danube-1.8b, a non-causal and a ragged case, and qwen2-moe-a2.7b's,
# jamba-v0.1-52b's and qwen2-vl-2b's prefills (the last three; their inputs
# come from generators of their own, so the shared generator's draws for the
# main path are the earlier cases').
FLASH_CASES = (("granite prefill", 32, 4000, 4000, 64, True, None),
               ("danube prefill", 32, 6144, 6144, 80, True, 4096),
               ("non-causal", 32, 1024, 1024, 64, False, None),
               ("ragged", 32, 1500, 3000, 80, True, None),
               ("hd 256", 8, 1024, 1024, 256, True, None),
               ("qwen2-moe prefill", 16, 4000, 4000, 128, True, None),
               ("jamba prefill", 32, 4096, 4096, 128, True, None),
               ("qwen2-vl prefill", 12, 4096, 4096, 128, True, None))
# The serve phase: granite-3-2b's engine, its long prompts and the chunked
# cross-check.  Tolerance of the one-shot (flash) against the chunked
# (dense) prefill's last-token logits, both in bf16 compute through 40
# layers: relative l2 and max |diff| over max |logit|.  The two paths round
# in bf16 at different places (bf16 scores on the dense path, f32 q on the
# flash path); their gap is of the order of bf16 against f32 compute,
# which the phase also reports.
SERVE_BATCH, SERVE_LEN, SERVE_LONG, SERVE_NEW = 4, 4608, (3000, 4000), 16
CHUNK = 512
CHUNK_TOL = {"rel_l2": 0.05, "max_abs_over_max": 0.1}
SWA_LAYERS, SWA_PROMPT, SWA_STEPS = 4, 6144, 16
# The moe phase: qwen2-moe-a2.7b at full width and depth through the serve
# phase's engine and requests; one of its layers' moe_ffn on 512 tokens in
# f32 compute on the card and on the CPU (routing equal; y and the aux
# values within MOE_TOL of the largest entry: f32 sums in another order
# over d=2048 and f=1408, the gaps about 1e-6); phi3.5-moe, qwen3-8b and
# qwen2-7b at full width with their depth cut to MOE_CUT_LAYERS (a 4000-
# token prefill, 16 decode steps); qwen2-moe at 2 layers trained on
# 1 x 4096 tokens for 2 steps, twice.
MOE_LAYER_TOKENS, MOE_TOL = 512, 1e-4
MOE_CUT_LAYERS, MOE_PROMPT, MOE_STEPS = 4, 4000, 16
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 4096, 2
# The hybrid phase: jamba-v0.1-52b at full width, one pattern period of
# HYBRID_LAYERS = 8 layers (7 Mamba, 1 attention, MoE on 4; 1.326e10
# parameters, 53.1 GB in f32: 32 layers are 206 GB), through the serve
# phase's engine: one HYBRID_LONG-token prompt and HYBRID_SHORTS prompts of
# at most 128 tokens.  One Mamba layer on HYBRID_LONG tokens in f32, card
# against CPU; a prefill of HYBRID_PREFIX tokens and HYBRID_STEPS decode
# steps against forward over the 128 tokens (one chunk of the scan) in f32
# at a dropless MoE capacity; both within HYBRID_TOL of the largest entry
# (f32 sums in another order over d_model 4096 and d_inner 8192; the same
# doubling scan on both sides).  A HYBRID_OFF-token prompt, over 128 and
# not a multiple of it, is refused as the reference refuses it.
HYBRID_LAYERS, HYBRID_LONG, HYBRID_SHORTS = 8, 4096, 5
HYBRID_PREFIX, HYBRID_STEPS, HYBRID_OFF, HYBRID_TOL = 120, 8, 4000, 1e-4
# The xlstm phase: xlstm-125m at full width and depth (12 layers, sLSTM at
# 1 and 7, mLSTM elsewhere; 1.968e8 parameters in its tensors, 0.79 GB in
# f32) through the serve phase's engine: XLSTM_SHORTS prompts of 14-60
# tokens and one of XLSTM_LONG (a multiple of the mLSTM's 64-token chunk).
# One mLSTM and one sLSTM layer on XLSTM_LAYER_TOKENS tokens in f32, card
# against CPU; a prefill of XLSTM_PREFIX tokens and XLSTM_STEPS decode
# steps against forward over all of them in f32; both within XLSTM_TOL of
# the largest entry (f32 sums in another order over d_inner 1536).  An
# XLSTM_OFF-token prompt, over 64 and not a multiple of it, is refused as
# the reference refuses it.
XLSTM_SHORTS, XLSTM_LONG, XLSTM_LAYER_TOKENS = 5, 4096, 1024
XLSTM_PREFIX, XLSTM_STEPS, XLSTM_OFF, XLSTM_TOL = 64, 64, 100, 1e-4
# The encdec phase: whisper-tiny at full width and depth (4 encoder and 4
# decoder layers, 1500 encoder frames drawn from a seed): a prefill of
# ENCDEC_BATCH x ENCDEC_PROMPT tokens with the frames, then ENCDEC_STEPS
# greedy decode steps; in f32 the same prefill and ENCDEC_CHECK decode
# steps, card against CPU and decode against forward, within ENCDEC_TOL.
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_STEPS = 4, 8, 32
ENCDEC_CHECK, ENCDEC_TOL = 8, 1e-4
# The vlm phase: qwen2-vl-2b at full width and depth (28 layers, 1.544e9
# parameters, 6.2 GB in f32) through the serve phase's engine: VLM_SHORTS
# prompts of at most 128 tokens and one of VLM_LONG (flash once a layer);
# at VLM_CHECK_LAYERS layers in f32, forward with patch embeddings on an
# image grid of VLM_GRID (h, w) patches before the text and distinct
# (t, h, w) ids, card against CPU within VLM_TOL.
VLM_SHORTS, VLM_LONG, VLM_CHECK_LAYERS, VLM_GRID, VLM_TOL = (
    5, 4096, 2, (4, 8), 1e-4)
# The train phase: granite-3-2b at full width and depth, batch 2 x 4096
# (train_4k's length), 5 steps; (c) at 2 layers.  Tolerance of the
# Function's gradients against autograd through flash_ref, relative to the
# largest entry: f32 k and v 1e-4 (the kernel's o and lse carry its 1e-5,
# and the backward sums 4096 keys in f32 in another order); bf16 k and v
# 1e-2 (dk and dv are rounded to bf16 on both sides, a bf16 step apart
# where they round differently).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SMALL_LAYERS = 5, 2, 4096, 2
# The mesh phase: the sharded steps on a one-rank NCCL mesh (1, 1)
# ("data", "model") at granite-3-2b's full width and depth: MESH_STEPS
# train steps of phase train's batch in mode tp, their losses within
# MESH_LOSS_TOL of phase train's (the same seed, batches and schedule), and
# with cast_params within MESH_LOSS_TOL of an unsharded cast run; the
# sharded prefill of MESH_BATCH
# prompts of MESH_PROMPT tokens and MESH_NEW greedy decode steps against
# the plain ones (the serve phase's CHUNK_TOL, tokens equal).  (c) the
# dry-run of MESH_DRY_CELLS on torch's fake backend, a CPU process a cell,
# started after (a) and (b).
MESH_STEPS, MESH_LOSS_TOL = 3, 1e-5
MESH_DRY_TIMEOUT = 600
MESH_BATCH, MESH_PROMPT, MESH_NEW = 4, 4000, 16
MESH_DRY_CELLS = ("granite-3-2b:train_4k:pod", "qwen2-moe-a2.7b:train_4k:pod",
                  "phi3.5-moe-42b-a6.6b:train_4k:pod",
                  "qwen2-vl-2b:prefill_32k:pod",
                  "jamba-v0.1-52b:long_500k:multipod")
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The stream phase's chunk: 8192 rows (1.07 GB of the main row in f64, 2.1
# GB of the paper's 64 GB row in c128), a multiple of ACCUM_BLOCK.
STREAM_CHUNK = 8192


class PhaseError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    try:
        import torch.distributed as dist
        from repro_torch.core import (error_bound, expected_sigma_kp1,
                                      panel_parallel_pivoted_qr, pivoted_qr,
                                      rid,
                                      rid_distributed, rid_from_sketch,
                                      sketch, spectral_error)
        from repro_torch.kernels import _build
        from repro_torch.kernels.cgs import panel_deflate, project_out
        from repro_torch.kernels.cgs.kernel import (DEFLATE_LAUNCHES,
                                                    deflate_geometry)
        from repro_torch.kernels.cgs.kernel import (
            LAUNCHES as PROJECT_LAUNCHES)
        from repro_torch.kernels.cgs.ref import (panel_deflate_ref,
                                                 project_out_ref)
        from repro_torch.kernels.panel_gram import panel_gram
        from repro_torch.kernels.panel_gram.kernel import (
            LAUNCHES as GRAM_LAUNCHES)
        from repro_torch.kernels.panel_gram.ref import panel_gram_ref
        from repro_torch.kernels.panel_step import (panel_apply, panel_coeff,
                                                    panel_step)
        from repro_torch.kernels.panel_step.kernel import (
            APPLY_LAUNCHES, APPLY_NORMS_LAUNCHES, COEFF_LAUNCHES)
        from repro_torch.kernels.panel_step.kernel import (
            LAUNCHES as PANEL_LAUNCHES)
        from repro_torch.kernels.panel_step.ref import (
            colnorms2, panel_apply_norms_ref, panel_apply_ref,
            panel_coeff_ref, panel_step_ref)
        from repro_torch.kernels.sketch_accum import sketch_accum
        from repro_torch.kernels.sketch_accum.kernel import (
            LAUNCHES as ACCUM_LAUNCHES)
        from repro_torch.kernels.sketch_accum.ref import sketch_accum_ref
        from repro_torch.kernels.sketch_matmul import sketch_matmul
        from repro_torch.kernels.sketch_matmul.kernel import (
            LAUNCHES as MATMUL_LAUNCHES)
        from repro_torch.kernels.sketch_matmul.ref import sketch_matmul_ref
        from repro_torch.kernels.srht import fwht, fwht_factors
        from repro_torch.kernels.srht.kernel import LAUNCHES as FWHT_LAUNCHES
        from repro_torch.kernels.srht.kernel import fwht_pass_launch
        from repro_torch.kernels.srht.ref import fwht_ref
        from repro_torch.kernels.tsolve import tsolve
        from repro_torch.kernels.tsolve.kernel import (
            LAUNCHES as TSOLVE_LAUNCHES)
        from repro_torch.kernels.tsolve.ref import tsolve_ref
        from repro_torch.benchmarks import (bench_error, bench_qr,
                                            bench_sketch, bench_total,
                                            bench_tsolve)
        from repro_torch.core import resolve_panel
        from repro_torch.benchmarks.bench_dmma import (
            _cuda_ms as bench_cuda_ms)
        from repro_torch.benchmarks.bench_tsolve import (backward_error,
                                                         bench_system)
        from repro_torch.benchmarks.common import ITERS, WARMUP
        import numpy as np
        import torch.nn.functional as F
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash.kernel import (
            LAUNCHES as FLASH_LAUNCHES)
        from repro_torch.kernels.flash.kernel import flash_attention_kernel
        from repro_torch.kernels.flash.ref import flash_ref
        from repro_torch.models import (decode_step, forward, init_caches,
                                        init_params, prefill, prefill_chunk)
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import mamba as mamba_mod
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import xlstm as xlstm_mod
        from repro_torch.models import params_from_jax, params_to_numpy
        from repro_torch.models.config import MLSTM, SLSTM
        from repro_torch.models.rope import (mrope_cos_sin, text_positions,
                                             text_mrope_positions)
        from repro_torch.models import transformer as tr_mod
        from repro_torch.models.norms import rmsnorm
        from repro_torch.models.rope import apply_rope, rope_cos_sin
        from repro_torch.models.transformer import embed_tokens
        from repro_torch.obs import Tracer, tracing
        from repro_torch.serving import GenerationRequest, ServeEngine
        from repro_torch.analysis.fixtures.badkernel.contract import (
            CONTRACT as COPY_CONTRACT)
        from repro_torch.analysis.fixtures.badkernel.kernel import (
            LAUNCHES as COPY_LAUNCHES)
        from repro_torch.analysis.fixtures.badkernel.kernel import (
            library as copy_library)
        from repro_torch.analysis.fixtures.badkernel.ops import big_copy
        from repro_torch.analysis.fixtures.badkernel.ref import big_copy_ref
        from repro_torch.analysis.kernels import geometry_report, hold_launch
        from repro_torch.analysis.report import (diff_against_baseline,
                                                 load_baseline)
        from repro_torch.analysis.runner import CONTROLS, run_all
        from repro_torch.kernels.cgs.kernel import (panel_deflate_launch,
                                                    project_out_launch)
        from repro_torch.kernels.flash.kernel import flash_launch
        from repro_torch.kernels.panel_gram.kernel import panel_gram_launch
        from repro_torch.kernels.sketch_matmul.kernel import (
            sketch_matmul_launch)
        from repro_torch.kernels.sketch_accum.kernel import (
            sketch_accum_launch)
        from repro_torch.kernels.common import SMEM_BUDGET_BYTES
        from repro_torch.kernels.panel_step.kernel import (apply_geometry,
                                                           apply_launch,
                                                           factor_launch,
                                                           factor_resident,
                                                           coeff_launches,
                                                           step_launches)
        from repro_torch.kernels.tsolve.kernel import (tsolve_geometry,
                                                       tsolve_launch)
        from repro_torch.core import qr_dist
        from repro_torch.benchmarks.bench_chaos import (
            fields_equal, killed_twice_then_resumed)
        from repro_torch.data import spectrum_id_error
        from repro_torch.obs import tracing
        from repro_torch.obs import (ProgressReporter, TelemetryServer,
                                     Timeline, overlap_report)
        from repro_torch.benchmarks import bench_stream, bench_trace
        from repro_torch.stream import ArraySource, SpectrumSource, rid_streamed
        from repro_torch.data import SyntheticConfig, batch_for_step
        from repro_torch.launch import steps as steps_mod
        from repro_torch.launch.steps import (TrainConfig, init_train_state,
                                              make_train_step)
        from repro_torch.launch.train import train_loop
        from repro_torch.kernels.flash import BLOCK_KV, FlashAttention
        from repro_torch.optim import CompressorConfig
        from repro_torch.runtime import HostFailure
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(shape, dtype):
        if dtype.is_complex:
            rdt = dtype.to_real()
            return torch.complex(
                torch.randn(shape, generator=gen, dtype=rdt, device=dev),
                torch.randn(shape, generator=gen, dtype=rdt, device=dev))
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    def rel_err(got, want) -> float:
        scale = max(float(want.abs().max()), 1e-300)
        return float((got - want).abs().max()) / scale

    def cuda_ms(fn, reps: int) -> float:
        fn()                                    # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def dname(dtype) -> str:
        return str(dtype).replace("torch.", "")

    # ---------------------------------------------------------- 1. device
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    # Tensor-core instructions by kernel: DMMA in the f64 kernels of the
    # ID's GEMMs and panel_deflate, none in their f32 kernels (TF32 would
    # break eq. (3)), the split-TF32 HMMA in flash, and no spills in any.
    mma_ops = _build.tensor_core_ops(_build.build_info["path"])
    emit({"phase": "device", "ok": True,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": round(build_s, 3),
          "ptxas": _build.build_info["ptxas"],
          "tensor_core_ops": {k: v for k, v in mma_ops.items() if v}})
    dmma_kernels = [f"{name}<{flag}>" for name in (
        "sketch_accum_dmma_kernel", "sketch_matmul_dmma_kernel",
        "project_w_dmma_kernel", "project_o_dmma_kernel")
        for flag in ("true", "false")]
    # No tensor-core instruction in the f32 GEMMs (TF32 would break eq.
    # (3)), nor in panel_gram, whose sums are in-order FMA chains.
    fma_kernels = [f"{name}<float32>" for name in (
        "sketch_accum_kernel", "sketch_matmul_kernel", "project_w_kernel",
        "project_o_kernel")] + [
        f"panel_gram_kernel<{t},{flag},{tj}>" for t in (
            "float32", "float64", "complex64", "complex128")
        for flag in ("true", "false")
        for tj in ((1, 2) if t == "complex128" else (1, 2, 4))]
    # panel_deflate<T, slab width, resident, 16-byte copies>: DMMA in f64,
    # no tensor-core instruction in f32 (IEEE FFMA, eq. (3)) nor in the
    # complex types; flash: the TF32 HMMA of its split products.
    deflate_kernels = {t: [f"panel_deflate_kernel<{t},{nc},{res},{vec}>"
                           for nc in ((16,) if t == "complex128" else (16, 32))
                           for res in ("true", "false")
                           for vec in ("true", "false")]
                       for t in ("float32", "float64", "complex64",
                                 "complex128")}
    dmma_kernels += deflate_kernels["float64"]
    fma_kernels += [k for t in ("float32", "complex64", "complex128")
                    for k in deflate_kernels[t]]
    # tsolve<T, resident>: DMMA in f64's trailing update, FFMA in f32, the
    # register tile in the complex types; panel_apply<T, slab columns,
    # 16-byte copies>: the sweep's in-order DFMA / FFMA chains, never a
    # tensor core (its bits are the parent's).
    types = ("float32", "float64", "complex64", "complex128")
    dmma_kernels += [f"tsolve_kernel<float64,{r}>" for r in ("true", "false")]
    fma_kernels += [f"tsolve_kernel<{t},{r}>" for t in types if t != "float64"
                    for r in ("true", "false")] + [
        f"panel_apply_kernel<{t},{nc * 16 // size},{vec}>"
        for t, size in zip(types, (4, 8, 8, 16)) for nc in (16, 32, 64)
        for vec in ("true", "false")]
    # fwht<T, register rows log2, 16-byte copies> and panel_step's factor
    # <T, resident>: exact adds and in-order DFMA / FFMA chains, never a
    # tensor core (their bits are the parent's).
    tf = ("true", "false")
    fma_kernels += [f"fwht_kernel<{t},{rl},{v}>" for t in types
                    for rl in range(5) for v in tf] + [
        f"panel_factor_kernel<{t},{r}>" for t in types for r in tf]
    flash_kernels = [f"flash_fwd_kernel<{q},{kv},{hd}>"
                     for q in ("float32", "bfloat16")
                     for kv in ("float32", "bfloat16") for hd in (64, 128, 256)]
    check(all(mma_ops.get(k) == ["DMMA"] for k in dmma_kernels),
          f"device: DMMA missing from {dmma_kernels}: {mma_ops}")
    check(all(k in mma_ops and not mma_ops[k] for k in fma_kernels),
          f"device: tensor-core instructions in {fma_kernels}: {mma_ops}")
    check(all(mma_ops.get(k) == ["HMMA"] for k in flash_kernels),
          f"device: the TF32 HMMA missing from {flash_kernels}: {mma_ops}")
    redesigned = dmma_kernels + fma_kernels + flash_kernels + [
        f"{name}<{t}>" for name in ("sketch_accum_kernel",
                                    "sketch_matmul_kernel", "project_w_kernel",
                                    "project_o_kernel")
        for t in ("complex64", "complex128")]
    ptxas = {r["kernel"]: r for r in _build.build_info["ptxas"]}
    check(all(k in ptxas for k in redesigned),
          f"device: not in the ptxas report: "
          f"{[k for k in redesigned if k not in ptxas]}")
    spills = [ptxas[k] for k in redesigned
              if ptxas[k].get("spill_stores") or ptxas[k].get("spill_loads")]
    check(not spills, f"device: spills in {spills}")

    def max_abs(got, want) -> float:
        return max(float((u - v).abs().max()) for u, v in zip(got, want))

    def panel_orth(qp) -> float:
        eye = torch.eye(qp.shape[1], dtype=qp.dtype, device=dev)
        return float((qp.mH @ qp - eye).abs().max())

    def sqrt_eps(dtype) -> float:
        return math.sqrt(torch.finfo(dtype.to_real() if dtype.is_complex
                                     else dtype).eps)

    # --------------------------------------- 2. kernels vs plain versions
    accum_err_f64 = panel_err_f64 = None
    split_err_f64 = {}          # max abs error at f64, b=32, per kernel
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        name, tol = dname(dtype), REL_TOL[dname(dtype)]
        l, n = 2 * MAIN_K, MAIN_N
        m = C128_ACCUM_M if dtype == torch.complex128 else MAIN_M
        x, a, acc = randn((l, m), dtype), randn((m, n), dtype), randn((l, n), dtype)
        got = sketch_accum(x, a, acc)
        want = sketch_accum_ref(x, a, acc)
        err = rel_err(got, want)
        # chunk invariance: four calls over row ranges at block multiples
        chunk = m // 4
        acc_c = acc
        for r0 in range(0, m, chunk):
            acc_c = sketch_accum(x[:, r0:r0 + chunk].contiguous(),
                                 a[r0:r0 + chunk], acc_c)
        torch.cuda.synchronize()
        chunk_exact = bool(torch.equal(acc_c, got))
        unaligned = None
        if dtype == torch.float64:
            # a on a base 8 bytes off 16: the DMMA kernel's 8-byte copies,
            # against the 16-byte copies of the aligned call above.
            a_off = torch.empty(m * n + 1, dtype=dtype, device=dev)[1:]
            a_off = a_off.view(m, n).copy_(a)
            got_off = sketch_accum(x, a_off, acc)
            torch.cuda.synchronize()
            unaligned = {"a_base_mod_16": a_off.data_ptr() % 16,
                         "rel_err": rel_err(got_off, want),
                         "same_bits_as_aligned": bool(torch.equal(got_off, got))}
            del a_off, got_off
        emit({"phase": "kernels", "kernel": "sketch_accum", "dtype": name,
              "l": l, "m": m, "n": n,
              "reduced": (f"m cut from {MAIN_M} to {m} (phase time)"
                          if m != MAIN_M else None),
              "max_abs_err": float((got - want).abs().max()),
              "rel_err": err, "rel_tol": tol, "chunks": 4,
              "chunk_invariant_bit_exact": chunk_exact,
              "unaligned_operand": unaligned})
        check(err <= tol, f"sketch_accum {name}: rel err {err} > {tol}")
        check(chunk_exact, f"sketch_accum {name}: chunked != one call")
        if unaligned is not None:
            check(unaligned["a_base_mod_16"] == 8
                  and unaligned["rel_err"] <= tol
                  and unaligned["same_bits_as_aligned"],
                  f"sketch_accum {name}: unaligned operand {unaligned}")
        if dtype == torch.float64:
            accum_err_f64 = float((got - want).abs().max())
        del x, a, acc, got, want, acc_c
        torch.cuda.empty_cache()

        z = randn((l, n), dtype)
        for b in (PANEL, MAIN_K % PANEL):
            c = randn((l, b), dtype)
            qp, o, w, r2 = panel_step(c, z, emit_w=True)
            qp2, o2, w2, r22 = panel_step(c, z, emit_w=False)
            ref = panel_step_ref(c, z)
            errs = {k: rel_err(u, v) for k, u, v in
                    zip(("qp", "o", "w", "r2"), (qp, o, w, r2), ref)}
            torch.cuda.synchronize()
            same = bool(torch.equal(o2, o) and torch.equal(r22, r2)
                        and w2 is None)
            emit({"phase": "kernels", "kernel": "panel_step", "dtype": name,
                  "l": l, "b": b, "n": n, "rel_err": errs, "rel_tol": tol,
                  "max_abs_err": max(float((u - v).abs().max()) for u, v in
                                     zip((qp, o, w, r2), ref)),
                  "emit_w_false_same_bits": same})
            check(max(errs.values()) <= tol,
                  f"panel_step {name} b={b}: rel errs {errs} > {tol}")
            check(same, f"panel_step {name} b={b}: emit_w=False differs")
            if dtype == torch.float64 and b == PANEL:
                panel_err_f64 = max(float((u - v).abs().max()) for u, v in
                                    zip((qp, o, w, r2), ref))
        # duplicate-column panel: finite, and not orthonormal
        c16 = randn((l, PANEL // 2), dtype)
        cdup = torch.cat([c16, c16], dim=1)
        qp, o, _, r2 = panel_step(cdup, z, emit_w=False)
        orth = panel_orth(qp)
        finite = all(bool(torch.isfinite(t).all()) for t in (qp, o, r2))
        emit({"phase": "kernels", "kernel": "panel_step",
              "case": "duplicate columns", "dtype": name, "finite": finite,
              "orth_err": orth})
        check(finite and orth > sqrt_eps(dtype),
              f"panel_step {name}: duplicate panel finite={finite} "
              f"orth={orth}")
        del c, qp, o, w, r2, qp2, o2, r22, ref

        # The distributed engine's split panel (stage A, stage B in both
        # modes) and the gram oracle's pass, on the same residual.
        r2in = colnorms2(z)
        r2in[::7] = -1.0                       # picked columns' sentinel
        for b in (PANEL, MAIN_K % PANEL):
            c = randn((l, b), dtype)
            coeff = panel_coeff(c, z, r2in)
            qp, w = coeff[0], coeff[1]
            apply = panel_apply(qp, w, z)
            apply_n = panel_apply(qp, w, z, emit_norms=True)
            gram = panel_gram(c, z)
            checks = {
                "panel_coeff": (coeff, panel_coeff_ref(c, z, r2in)),
                "panel_apply": ((apply,), (panel_apply_ref(qp, w, z),)),
                "panel_apply(emit_norms)": (apply_n,
                                            panel_apply_norms_ref(qp, w, z)),
                "panel_gram": (gram, panel_gram_ref(c, z)),
            }
            torch.cuda.synchronize()
            same = bool(torch.equal(apply, apply_n[0]))
            for kname, (got, want) in checks.items():
                errs = [rel_err(u, v) for u, v in zip(got, want)]
                err_abs = max_abs(got, want)
                emit({"phase": "kernels", "kernel": kname, "dtype": name,
                      "l": l, "b": b, "n": n, "rel_err": max(errs),
                      "rel_tol": tol, "max_abs_err": err_abs})
                check(max(errs) <= tol,
                      f"{kname} {name} b={b}: rel errs {errs} > {tol}")
                if dtype == torch.float64 and b == PANEL:
                    split_err_f64[kname] = err_abs
            check(same, f"panel_apply {name} b={b}: emit_norms changes O")
            check(bool((coeff[2][::7] == 0).all()),
                  f"panel_coeff {name} b={b}: sentinel columns not clamped")
            # panel_gram's own invariants: every element one in-order sum,
            # so V of z[:, :h] is the first h columns of V (h not on a slab
            # boundary) and G is the n = 0 call's, bit for bit.
            h = n // 2 + 37
            g_h, v_h = panel_gram(c, z[:, :h])
            g_0, v_0 = panel_gram(c, z[:, :0])
            torch.cuda.synchronize()
            split = {"v_split_bit_equal": bool(
                         torch.equal(v_h, gram[1][:, :h])),
                     "g_split_bit_equal": bool(torch.equal(g_h, gram[0])),
                     "g_n0_bit_equal": bool(torch.equal(g_0, gram[0])
                                            and v_0.shape == (b, 0))}
            emit({"phase": "kernels", "kernel": "panel_gram",
                  "check": "column split and n = 0", "dtype": name, "l": l,
                  "b": b, "n": n, "h": h, **split})
            check(all(split.values()),
                  f"panel_gram {name} b={b}: identities {split}")
            del c, coeff, qp, w, apply, apply_n, gram, checks, g_h, v_h, g_0
        qp, w, r2 = panel_coeff(cdup, z, r2in)
        finite = all(bool(torch.isfinite(t).all()) for t in (qp, w, r2))
        orth = panel_orth(qp)
        emit({"phase": "kernels", "kernel": "panel_coeff",
              "case": "duplicate columns", "dtype": name, "finite": finite,
              "orth_err": orth})
        check(finite and orth > sqrt_eps(dtype),
              f"panel_coeff {name}: duplicate panel finite={finite} "
              f"orth={orth}")
        del z, qp, w, r2, r2in, cdup
        torch.cuda.empty_cache()

    # The kernels of the phase benchmarks (paper Tables 2 and 4), each
    # against its plain version at the main row's shapes.
    bench_err_f64 = {}          # max abs error at f64, per kernel
    tsolve_main_f64 = None      # (R1, R) of the f64 pivoted QR, for phase 8
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        name, tol = dname(dtype), REL_TOL[dname(dtype)]
        eps = torch.finfo(dtype.to_real() if dtype.is_complex else dtype).eps
        l, k, n = 2 * MAIN_K, MAIN_K, MAIN_N
        m = C128_ACCUM_M if dtype == torch.complex128 else MAIN_M
        omega, a = randn((l, m), dtype), randn((m, n), dtype)
        before = MATMUL_LAUNCHES.count
        got = sketch_matmul(omega, a)
        launches = MATMUL_LAUNCHES.count - before
        want = sketch_matmul_ref(omega, a)
        err, err_abs = rel_err(got, want), float((got - want).abs().max())
        emit({"phase": "kernels", "kernel": "sketch_matmul", "dtype": name,
              "cuda_kernel": ("sketch_matmul_dmma_kernel"
                              if dtype == torch.float64
                              else "sketch_matmul_kernel"),
              "l": l, "m": m, "n": n, "launches_per_call": launches,
              "reduced": (f"m cut from {MAIN_M} to {m} (phase time)"
                          if m != MAIN_M else None),
              "max_abs_err": err_abs, "rel_err": err, "rel_tol": tol})
        check(err <= tol, f"sketch_matmul {name}: rel err {err} > {tol}")
        check(launches == 1, f"sketch_matmul {name}: {launches} launches")
        if dtype == torch.float64:
            bench_err_f64["sketch_matmul"] = err_abs
        del omega, a, got, want
        torch.cuda.empty_cache()

        nf = C128_FWHT_N if dtype == torch.complex128 else MAIN_N
        x = randn((MAIN_M, nf), dtype)
        before = FWHT_LAUNCHES.count
        got = fwht(x)
        launches = FWHT_LAUNCHES.count - before
        want = fwht_ref(x)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want))
        err, err_abs = rel_err(got, want), float((got - want).abs().max())
        emit({"phase": "kernels", "kernel": "fwht", "dtype": name,
              "m": MAIN_M, "n": nf, "factors_log2": fwht_factors(MAIN_M),
              "launches_per_call": launches,
              "reduced": (f"n cut from {MAIN_N} to {nf} (the plain "
                          f"version's memory)" if nf != MAIN_N else None),
              "bit_equal": exact, "max_abs_err": err_abs, "rel_err": err,
              "rel_tol": 0.0 if not dtype.is_complex else tol})
        check(exact or (dtype.is_complex and err <= tol),
              f"fwht {name}: not bit-equal (rel err {err})")
        check(launches == len(fwht_factors(MAIN_M)),
              f"fwht {name}: {launches} launches")
        if dtype == torch.float64:
            bench_err_f64["fwht"] = err_abs
        del x, got, want
        torch.cuda.empty_cache()

        # R1 of the main path: the pivoted QR of a rank-k sketch (l x n).
        Y = randn((l, k), dtype) @ randn((k, n), dtype)
        qr = pivoted_qr(Y, k)
        R1, R = qr.R.index_select(1, qr.piv).contiguous(), qr.R
        before = TSOLVE_LAUNCHES.count
        got = tsolve(R1, R)
        launches = TSOLVE_LAUNCHES.count - before
        want = tsolve_ref(R1, R)
        err, err_abs = rel_err(got, want), float((got - want).abs().max())
        # The bench's R1 = triu(randn) + 3 I, exponentially ill-conditioned
        # in k: held to its normwise backward error.
        B1, B2 = bench_system(gen, k, n, dtype, dev)
        bwd = backward_error(B1, B2, tsolve(B1, B2))
        bwd_plain = backward_error(B1, B2, tsolve_ref(B1, B2))
        bar = TSOLVE_BWD_C * k * eps
        emit({"phase": "kernels", "kernel": "tsolve", "dtype": name, "k": k,
              "n": n, "launches_per_call": launches,
              "pivoted_qr_R1": {"max_abs_err": err_abs, "rel_err": err,
                                "rel_tol": tol},
              "bench_R1": {"backward_err": bwd,
                           "backward_err_plain": bwd_plain,
                           "bar": bar, "bar_is": f"{TSOLVE_BWD_C} k eps"}})
        check(err <= tol, f"tsolve {name}: rel err {err} > {tol}")
        check(bwd <= bar, f"tsolve {name}: backward error {bwd} > {bar}")
        check(launches == 1, f"tsolve {name}: {launches} launches")
        if dtype == torch.float64:
            bench_err_f64["tsolve"] = err_abs
            tsolve_main_f64 = (R1, R)
        del Y, qr, got, want, B1, B2
        torch.cuda.empty_cache()

    # panel_apply at the other slab widths the shapes select (the loop
    # above ran the main shape: 64 vectors, 32 in f32): a 4-rank shard
    # (n = 4096: 16 vectors), ragged l, n and b; each repeated for its bits.
    # tsolve in the re-reading geometry (k = 1000: T's rows read back
    # through the ring), with NaN below R1's diagonal, which it must not
    # read.  The inputs come from a generator of their own, so that the
    # later phases' draws do not depend on these checks.
    def randn_with(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def draw(shape, dtype):
            if dtype.is_complex:
                rdt = dtype.to_real()
                return torch.complex(
                    torch.randn(shape, generator=gen, dtype=rdt, device=dev),
                    torch.randn(shape, generator=gen, dtype=rdt, device=dev))
            return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        return draw

    randn_own, randn_coeff = randn_with(SEED + 20), randn_with(SEED + 22)

    def same_bits(a, b) -> bool:
        """Bit for bit, NaN included (a real tensor)."""
        ints = {8: torch.int64, 4: torch.int32}[a.element_size()]
        return bool(torch.equal(a.view(ints), b.view(ints)))

    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        name, tol = dname(dtype), REL_TOL[dname(dtype)]
        for l, b, n in ((2 * MAIN_K, PANEL, 4096), (131, 17, 1037)):
            qp = torch.linalg.qr(randn_own((l, b), dtype)).Q.contiguous()
            w, z = randn_own((b, n), dtype), randn_own((l, n), dtype)
            o, r2 = panel_apply(qp, w, z, emit_norms=True)
            o2, r22 = panel_apply(qp, w, z, emit_norms=True)
            want = panel_apply_norms_ref(qp, w, z)
            errs = [rel_err(u, v) for u, v in zip((o, r2), want)]
            torch.cuda.synchronize()
            same = bool(torch.equal(o, o2) and torch.equal(r2, r22))
            emit({"phase": "kernels", "kernel": "panel_apply(emit_norms)",
                  "dtype": name, "l": l, "b": b, "n": n,
                  "slab_columns": apply_geometry(dtype, b, n),
                  "rel_err": max(errs), "rel_tol": tol,
                  "repeat_same_bits": same})
            check(max(errs) <= tol and same,
                  f"panel_apply {name} (l, b, n)={(l, b, n)}: rel errs "
                  f"{errs}, repeat bits {same}")
            del qp, w, z, o, r2, o2, r22, want
        k, n = 1000, 1037
        R1 = torch.linalg.qr(randn_own((k + 20, k), dtype)).R
        R2 = randn_own((k, n), dtype)
        junk = torch.full((k, k), float("nan"), dtype=dtype, device=dev)
        got = tsolve(R1 + torch.tril(junk, -1), R2)
        err = rel_err(got, tsolve_ref(R1, R2))
        torch.cuda.synchronize()
        same = bool(torch.equal(got, tsolve(R1, R2)))
        emit({"phase": "kernels", "kernel": "tsolve", "dtype": name, "k": k,
              "n": n, "resident": tsolve_geometry(dtype, k)[1],
              "nan_below_diagonal": True, "rel_err": err, "rel_tol": tol,
              "same_bits_as_zeros_below": same})
        check(err <= tol and same,
              f"tsolve {name} k={k}: rel err {err}, junk read {not same}")
        del R1, R2, junk, got
        # panel_step at ragged shapes: l not a multiple of the rings'
        # chunks, n not of the slabs, b = 1, 17, 33 and 64 (the factor's
        # unrolled solves and its block Cholesky past 32), and l = 4000,
        # where the factor re-reads its panel; each against its plain
        # version and repeated for its bits.
        cases = []
        for l, b, n in ((777, 1, 1001), (777, 17, 1001), (777, 33, 1001),
                        (777, 64, 1001), (4000, 32, 333)):
            c, z = randn_own((l, b), dtype), randn_own((l, n), dtype)
            got = panel_step(c, z)
            again = panel_step(c, z, emit_w=False)
            want = panel_step_ref(c, z)
            torch.cuda.synchronize()
            cases.append({
                "l": l, "b": b, "n": n,
                "factor_resident": factor_resident(dtype, l, b),
                "rel_err": max(rel_err(u, v) for u, v in zip(got, want)),
                "repeat_same_bits": bool(
                    torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1])
                    and torch.equal(got[3], again[3]))})
            del c, z, got, again, want
        emit({"phase": "kernels", "kernel": "panel_step", "dtype": name,
              "cases": cases, "rel_tol": tol})
        check(all(c["rel_err"] <= tol and c["repeat_same_bits"]
                  for c in cases), f"panel_step {name}: ragged {cases}")
        check(not cases[-1]["factor_resident"],
              f"panel_step {name}: l=4000 kept its panel resident")
        # panel_coeff's sweep (panel_gram's W pass with the downdate in its
        # epilogue) held to the arithmetic of the sweep it replaced, bit
        # for bit: W is one in-order sum over l (panel_gram's V of Q_p),
        # and the downdate's colnorms^2(W) the 8 partials over the rows = g
        # (mod 8) added in g order, which is panel_apply's norms of O = W
        # (Q_p = 0).  At the main shape, b = 1, 17, 33, 64 at a ragged l
        # and n, and l = 4000 (the factor re-reads its panel); r2 with
        # picked columns' sentinels and NaN, which the max must keep.
        cases = []
        for l, b, n in ((2 * MAIN_K, PANEL, MAIN_N), (777, 1, 1001),
                        (777, 17, 1001), (777, 33, 1001), (777, 64, 1001),
                        (4000, 32, 333)):
            c, z = randn_coeff((l, b), dtype), randn_coeff((l, n), dtype)
            r2in = colnorms2(z)
            r2in[::7] = -1.0
            r2in[3::101] = float("nan")
            qp, w, r2 = panel_coeff(c, z, r2in)
            again = panel_coeff(c, z, r2in)
            want = panel_coeff_ref(c, z, r2in)
            v = panel_gram(qp, z)[1]
            t = panel_apply(torch.zeros((b, 1), dtype=dtype, device=dev),
                            torch.zeros((1, n), dtype=dtype, device=dev), w,
                            emit_norms=True)[1]
            d = r2in - t
            r2_parent = torch.where(d < 0, torch.zeros_like(d), d)
            torch.cuda.synchronize()
            cases.append({
                "l": l, "b": b, "n": n,
                "rel_err": max(rel_err(u.nan_to_num(), v_.nan_to_num())
                               for u, v_ in zip((qp, w, r2), want)),
                "w_parent_bits": bool(torch.equal(w, v)),
                "r2_parent_bits": same_bits(r2, r2_parent),
                "nan_kept": bool(r2[3::101].isnan().all()),
                "repeat_same_bits": bool(
                    torch.equal(qp, again[0]) and torch.equal(w, again[1])
                    and same_bits(r2, again[2]))})
            del c, z, r2in, qp, w, r2, again, want, v, t, d, r2_parent
        emit({"phase": "kernels", "kernel": "panel_coeff", "dtype": name,
              "check": "the parent's bits", "cases": cases, "rel_tol": tol})
        check(all(c["rel_err"] <= tol and c["w_parent_bits"]
                  and c["r2_parent_bits"] and c["nan_kept"]
                  and c["repeat_same_bits"] for c in cases),
              f"panel_coeff {name}: {cases}")
        # fwht at ragged shapes: m = 1, 2, 64, a single 2^9 sweep with a
        # row of n = 1001 elements (one element a copy), two 2^9 sweeps.
        cases = []
        for m, n in ((1, 3), (2, 3), (64, 40), (512, 1001), (2 ** 18, 24)):
            x = randn_own((m, n), dtype)
            before = FWHT_LAUNCHES.count
            got = fwht(x)
            launches = FWHT_LAUNCHES.count - before
            want = fwht_ref(x)
            torch.cuda.synchronize()
            cases.append({"m": m, "n": n, "launches": launches,
                          "factors_log2": fwht_factors(m),
                          "bit_equal": bool(torch.equal(got, want)),
                          "rel_err": rel_err(got, want)})
            del x, got, want
        emit({"phase": "kernels", "kernel": "fwht", "dtype": name,
              "cases": cases, "rel_tol": 0.0 if not dtype.is_complex else tol})
        check(all(c["launches"] == len(c["factors_log2"]) and (
            c["bit_equal"] or (dtype.is_complex and c["rel_err"] <= tol))
            for c in cases), f"fwht {name}: ragged {cases}")
        torch.cuda.empty_cache()

    # The CGS kernels of paper Table 3 at its main row: project_out against
    # an orthonormal l x k basis, panel_deflate against its first 32
    # columns; both outputs of panel_deflate are checked.
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        name, tol = dname(dtype), REL_TOL[dname(dtype)]
        l, k, n = 2 * MAIN_K, MAIN_K, MAIN_N
        q = torch.linalg.qr(randn((l, k), dtype)).Q.contiguous()
        qp = q[:, :PANEL].contiguous()
        z = randn((l, n), dtype)
        before = PROJECT_LAUNCHES.count
        got = project_out(q, z)
        launches = PROJECT_LAUNCHES.count - before
        want = project_out_ref(q, z)
        again = project_out(q, z)
        torch.cuda.synchronize()
        same = bool(torch.equal(again, got))
        err, err_abs = rel_err(got, want), float((got - want).abs().max())
        emit({"phase": "kernels", "kernel": "project_out", "dtype": name,
              "l": l, "k": k, "n": n, "launches_per_call": launches,
              "max_abs_err": err_abs, "rel_err": err, "rel_tol": tol,
              "repeat_same_bits": same})
        check(err <= tol, f"project_out {name}: rel err {err} > {tol}")
        check(launches == 1, f"project_out {name}: {launches} launches")
        check(same, f"project_out {name}: a repeated call gave other bits")
        if dtype == torch.float64:
            bench_err_f64["project_out"] = err_abs
        before = DEFLATE_LAUNCHES.count
        got = panel_deflate(qp, z)
        launches = DEFLATE_LAUNCHES.count - before
        want = panel_deflate_ref(qp, z)
        errs = {key: rel_err(u, v) for key, u, v in zip(("o", "w"), got, want)}
        err_abs = max_abs(got, want)
        emit({"phase": "kernels", "kernel": "panel_deflate", "dtype": name,
              "l": l, "b": PANEL, "n": n, "launches_per_call": launches,
              "max_abs_err": err_abs, "rel_err": errs, "rel_tol": tol})
        check(max(errs.values()) <= tol,
              f"panel_deflate {name}: rel errs {errs} > {tol}")
        check(launches == 1, f"panel_deflate {name}: {launches} launches")
        if dtype == torch.float64:
            bench_err_f64["panel_deflate"] = err_abs
        # panel_deflate's own kernel at other panel widths (b = 1: the panel
        # padded to 16 columns), a ragged l and n, a 16-column slab (f64 and
        # c64 at b = 64, f32 at l = 2400, c128 always), the re-reading
        # geometry (l = 4000: no slab fits one block), each repeated for its
        # bits.
        cases = []
        for b, ll, nn in ((1, l, n), (16, l, n), (64, l, n), (32, 777, 1037),
                          (32, 2400, 1037), (32, 4000, 2000)):
            qb = (q[:, :b] if ll == l else
                  torch.linalg.qr(randn((ll, b), dtype)).Q).contiguous()
            zb = z if ll == l else randn((ll, nn), dtype)
            got = panel_deflate(qb, zb)
            again = panel_deflate(qb, zb)
            want = panel_deflate_ref(qb, zb)
            torch.cuda.synchronize()
            nc, resident = deflate_geometry(dtype, ll, b)
            cases.append({"b": b, "l": ll, "n": nn, "slab_cols": nc,
                          "resident": resident,
                          "rel_err": {key: rel_err(u, v) for key, u, v in
                                      zip(("o", "w"), got, want)},
                          "repeat_same_bits": all(
                              bool(torch.equal(u, v))
                              for u, v in zip(got, again))})
            del qb, zb, got, again, want
        emit({"phase": "kernels", "kernel": "panel_deflate", "dtype": name,
              "cases": cases, "rel_tol": tol})
        check(all(max(c["rel_err"].values()) <= tol for c in cases),
              f"panel_deflate {name}: rel errs {cases} > {tol}")
        check(all(c["repeat_same_bits"] for c in cases),
              f"panel_deflate {name}: a repeated call gave other bits")
        check(not cases[-1]["resident"],
              f"panel_deflate {name}: l=4000 kept its slab resident")
        del q, qp, z
        torch.cuda.empty_cache()

    # The flash kernel of the LM stack's prefill against its plain version.
    # q is drawn already scaled, as the op hands it to the kernel.
    def live_pairs(s, t, causal, window) -> int:
        """(q, k) pairs the mask keeps: the work these inputs need."""
        i = np.arange(s)
        hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
        lo = np.maximum(i - window + 1, 0) if window else np.zeros(s, int)
        return int(np.maximum(hi - lo + 1, 0).sum())

    def live_block_share(s, t, causal, window, blk=64) -> float:
        """Share of (q block, kv block) pairs the kernel loads."""
        nq, nk = -(-s // blk), -(-t // blk)
        live = 0
        for qb in range(nq):
            q0, q_end = qb * blk, qb * blk + blk - 1
            for kb in range(nk):
                k0 = kb * blk
                live += not ((causal and k0 > q_end)
                             or (window and k0 + blk - 1 <= q0 - window))
        return live / (nq * nk)

    flash_err = None            # max abs error at granite's shape, f32/bf16
    gen_moe_case = torch.Generator(device=dev)
    gen_moe_case.manual_seed(SEED + 26)
    gen_jamba_case = torch.Generator(device=dev)
    gen_jamba_case.manual_seed(SEED + 30)
    gen_vlm_case = torch.Generator(device=dev)
    gen_vlm_case.manual_seed(SEED + 45)
    for case, bh, s, t, hd, causal, window in FLASH_CASES:
        g_case = {"qwen2-moe prefill": gen_moe_case,
                  "jamba prefill": gen_jamba_case,
                  "qwen2-vl prefill": gen_vlm_case}.get(case, gen)
        for qdt, kvdt in ((torch.float32, torch.bfloat16),
                          (torch.float32, torch.float32)):
            q = torch.randn((bh, s, hd), generator=g_case,
                            device=dev) * hd ** -0.5
            k = torch.randn((bh, t, hd), generator=g_case,
                            device=dev).to(kvdt)
            v = torch.randn((bh, t, hd), generator=g_case,
                            device=dev).to(kvdt)
            before = FLASH_LAUNCHES.count
            got = flash_attention_kernel(q, k, v, causal=causal,
                                         window=window)
            launches = FLASH_LAUNCHES.count - before
            # With the logsumexp (the training path): o bit-equal, lse
            # against flash_ref's, relative to its largest entry.
            got_lse, lse = flash_attention_kernel(q, k, v, causal=causal,
                                                  window=window,
                                                  return_lse=True)
            want, want_lse = flash_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
            err, err_abs = rel_err(got, want), float((got - want).abs().max())
            lse_err = rel_err(lse, want_lse)
            emit({"phase": "kernels", "kernel": "flash", "case": case,
                  "bh": bh, "s": s, "t": t, "hd": hd, "causal": causal,
                  "window": window, "q_dtype": dname(qdt),
                  "kv_dtype": dname(kvdt), "launches_per_call": launches,
                  "live_pairs": bh * live_pairs(s, t, causal, window),
                  "live_block_share": live_block_share(s, t, causal, window),
                  "max_abs_err": err_abs, "rel_err": err,
                  "rel_tol": FLASH_TOL, "lse_rel_err": lse_err,
                  "o_bit_equal_with_lse": same_bits(got, got_lse)})
            check(err <= FLASH_TOL, f"flash {case} {dname(kvdt)}: rel err "
                  f"{err} > {FLASH_TOL}")
            check(lse_err <= FLASH_TOL, f"flash {case} {dname(kvdt)}: lse "
                  f"rel err {lse_err} > {FLASH_TOL}")
            check(same_bits(got, got_lse), f"flash {case} {dname(kvdt)}: o "
                  f"changed with lse")
            check(launches == 1, f"flash {case}: {launches} launches")
            if case == "granite prefill" and kvdt == torch.bfloat16:
                flash_err = err_abs
            del q, k, v, got, want, got_lse, lse, want_lse
            torch.cuda.empty_cache()

    # ----------------------------------------- 3. main path, f64 gaussian
    def lowrank(m, n, k, dtype):
        return randn((m, k), dtype) @ randn((k, n), dtype)

    split_counters = {"project_out": PROJECT_LAUNCHES,
                      "panel_deflate": DEFLATE_LAUNCHES,
                      "panel_coeff": COEFF_LAUNCHES,
                      "panel_apply": APPLY_LAUNCHES,
                      "panel_apply(emit_norms)": APPLY_NORMS_LAUNCHES,
                      "panel_gram": GRAM_LAUNCHES,
                      "panel_step": PANEL_LAUNCHES,
                      "sketch_accum": ACCUM_LAUNCHES,
                      "sketch_matmul": MATMUL_LAUNCHES,
                      "fwht": FWHT_LAUNCHES,
                      "tsolve": TSOLVE_LAUNCHES,
                      "flash": FLASH_LAUNCHES,
                      "big_copy": COPY_LAUNCHES}

    def reset_counts():
        for ctr in split_counters.values():
            ctr.reset()

    def read_counts() -> dict:
        return {name: ctr.count for name, ctr in split_counters.items()}

    def eq3_report(A, dec, k) -> dict:
        m, n = A.shape
        J = dec.J
        eye = torch.eye(k, dtype=dec.P.dtype, device=dev)
        err = float(spectral_error(SEED + 1, A, dec.B, dec.P))
        bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
        return {"J_distinct": int(torch.unique(J).numel()) == k,
                "J_in_range": bool(((J >= 0) & (J < n)).all()),
                "P_J_identity": bool(torch.equal(dec.P[:, J], eye)),
                "finite": bool(torch.isfinite(dec.P).all()),
                "spectral_error": err, "eq3_bound": bound,
                "error_over_bound": err / bound}

    def check_id(res: dict, what: str) -> None:
        check(res["J_distinct"] and res["J_in_range"] and res["P_J_identity"]
              and res["finite"], f"{what}: J or P malformed")
        check(res["error_over_bound"] <= 1, f"{what}: eq.(3) violated")

    def profiled(fn) -> dict:
        """One call of ``fn`` under ``torch.profiler``: wall, device busy
        time, device idle share and the top kernels by device time.  Only
        device events count: an operator's row repeats its kernels' time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        check(busy_ms > 0, "trace: no device time recorded")
        return {"traced_wall_s": wall, "device_busy_ms": busy_ms,
                "device_idle_share": 1 - busy_ms / (1e3 * wall),
                "top_kernels": [{"name": key[:80], "ms": ms, "count": cnt}
                                for key, ms, cnt in rows[:12]]}

    def run_distributed_phases(g):
        """Phases 5-7 on the one-rank group ``g``; returns the launch
        counts of the distributed run (phase 5) and of the gram run
        (phase 6)."""
        k, m, n, l = MAIN_K, MAIN_M, MAIN_N, 2 * MAIN_K
        n_panels = math.ceil(k / PANEL)
        A = lowrank(m, n, k, torch.float64)
        J_single = rid(SEED, A, k, sketch_kind="gaussian").J
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        dec = rid_distributed(SEED, A, k, group=g, sketch_kind="gaussian",
                              qr_impl="panel_parallel")
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        dec2 = rid_distributed(SEED, A, k, group=g, sketch_kind="gaussian",
                               qr_impl="panel_parallel")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        same = bool(torch.equal(dec.J, dec2.J) and torch.equal(dec.P, dec2.P))
        overlap = len(set(dec.J.tolist()) & set(J_single.tolist())) / k
        # The same run with stage B through its plain version on the card
        # (Z - Q_p W and its norms by the library's GEMM): the pivots as a
        # set, and P to rounding.

        def plain_apply(qp, w, z, *, emit_norms=False):
            return (panel_apply_norms_ref(qp, w, z) if emit_norms
                    else panel_apply_ref(qp, w, z))
        before = APPLY_LAUNCHES.count
        with mock.patch.object(qr_dist, "panel_apply", plain_apply):
            dec_plain = rid_distributed(SEED, A, k, group=g,
                                        sketch_kind="gaussian",
                                        qr_impl="panel_parallel")
        torch.cuda.synchronize()
        plain_stage_b = {
            "apply_launches": APPLY_LAUNCHES.count - before,
            "pivot_sets_equal": set(dec.J.tolist()) == set(
                dec_plain.J.tolist()),
            "P_max_abs_diff_rel": rel_err(dec.P, dec_plain.P)}
        del dec_plain
        res = eq3_report(A, dec, k)
        trace = profiled(lambda: rid_distributed(
            SEED, A, k, group=g, sketch_kind="gaussian",
            qr_impl="panel_parallel"))
        emit({"phase": "distributed",
              "call": "rid_distributed(seed, A_loc, 400, group=g, "
                      "sketch_kind='gaussian', qr_impl='panel_parallel')",
              "backend": dist.get_backend(g), "world": dist.get_world_size(g),
              "m": m, "n": n, "k": k, "l": l, "dtype": "float64",
              "launches": counts, "wall_first_s": first, "wall_warm_s": warm,
              "max_memory_allocated": peak, "repeat_same_bits": same,
              "pivot_overlap_with_rid": overlap,
              "against_plain_stage_b": plain_stage_b, **res, "trace": trace})
        check(plain_stage_b["apply_launches"] == 0
              and plain_stage_b["pivot_sets_equal"]
              and plain_stage_b["P_max_abs_diff_rel"] <= 1e-8,
              f"distributed: against the plain stage B {plain_stage_b}")
        check(counts["panel_coeff"] == n_panels
              and counts["panel_apply"] == n_panels,
              f"distributed: panel_coeff/panel_apply launched "
              f"{counts['panel_coeff']}/{counts['panel_apply']} times, "
              f"expected {n_panels}")
        check(counts["panel_apply(emit_norms)"] == 1,
              "distributed: expected one norm-recompute panel")
        check(counts["panel_step"] == 0 and counts["sketch_accum"] == 1,
              f"distributed: unexpected launches {counts}")
        check(same, "distributed: a repeated call gave other bits")
        check_id(res, "distributed")
        del dec, dec2, J_single

        # ---------------------- 6. gram oracle against the fused path
        Y = sketch(SEED, A, l, kind="gaussian").Y
        del A
        torch.cuda.empty_cache()
        fused = panel_parallel_pivoted_qr(Y, k, group=g)
        reset_counts()
        gram = panel_parallel_pivoted_qr(Y, k, group=g, panel_impl="gram")
        torch.cuda.synchronize()
        gcounts = read_counts()
        t0 = time.perf_counter()
        panel_parallel_pivoted_qr(Y, k, group=g, panel_impl="gram")
        torch.cuda.synchronize()
        gram_warm = time.perf_counter() - t0
        same_piv = bool(torch.equal(gram.piv, fused.piv))
        scale = float(Y.abs().max())
        out = {"phase": "gram",
               "call": "panel_parallel_pivoted_qr(Y, 400, group=g, "
                       "panel_impl='gram')",
               "l": l, "n": n, "k": k, "launches": gcounts,
               "wall_warm_s": gram_warm, "pivots_equal": same_piv,
               "pivot_set_overlap": len(set(gram.piv.tolist())
                                        & set(fused.piv.tolist())) / k,
               "orth_err_gram": panel_orth(gram.Q),
               "orth_err_fused": panel_orth(fused.Q)}
        if same_piv:
            out["Q_max_abs_diff"] = float((gram.Q - fused.Q).abs().max())
            out["R_max_abs_diff_rel"] = float(
                (gram.R - fused.R).abs().max()) / scale
        for name, qr in (("gram", gram), ("fused", fused)):
            R1 = torch.triu(qr.R.index_select(1, qr.piv))
            out[f"recon_err_rel_{name}"] = float(torch.linalg.norm(
                Y.index_select(1, qr.piv) - qr.Q @ R1)) / float(
                torch.linalg.norm(Y))
        emit(out)
        check(gcounts["panel_gram"] == n_panels,
              f"gram: panel_gram launched {gcounts['panel_gram']} times, "
              f"expected {n_panels}")
        check(out["orth_err_gram"] < 1e-8 and out["orth_err_fused"] < 1e-8
              and out["recon_err_rel_gram"] < 1e-8
              and out["recon_err_rel_fused"] < 1e-8,
              f"gram: Q not orthonormal or pivot columns not reproduced: "
              f"{out}")
        del Y, fused, gram
        torch.cuda.empty_cache()

        # ------------------------------ 7. c128 distributed, k=100
        k, m, n = DEFAULT_K, DEFAULT_M, DEFAULT_N
        A = lowrank(m, n, k, torch.complex128)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dec = rid_distributed(SEED, A, k, group=g, qr_impl="panel_parallel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ccounts = read_counts()
        res = eq3_report(A, dec, k)
        emit({"phase": "c128",
              "call": "rid_distributed(seed, A_loc, 100, group=g, "
                      "qr_impl='panel_parallel')",
              "m": m, "n": n, "k": k, "dtype": "complex128",
              "launches": ccounts, "wall_s": wall, **res})
        check(ccounts["panel_coeff"] == math.ceil(k / PANEL)
              and ccounts["panel_apply"] == math.ceil(k / PANEL),
              f"c128: unexpected launches {ccounts}")
        check_id(res, "c128")
        del A, dec
        torch.cuda.empty_cache()
        return counts, gcounts

    def ref_calls_on_card(fn):
        """``fn()`` with every function of the kernel packages' ref.py
        modules, wherever the port holds it, wrapped: returns ``fn``'s
        result and the names of those that were given a CUDA tensor (the
        port sends CUDA tensors to its kernels only)."""
        import inspect
        hits, targets = set(), []
        for modname, mod in list(sys.modules.items()):
            if mod is None or not modname.startswith("repro_torch"):
                continue
            for attr, obj in list(vars(mod).items()):
                if (inspect.isfunction(obj)
                        and obj.__module__.startswith("repro_torch.kernels.")
                        and obj.__module__.endswith(".ref")):
                    targets.append((mod, attr, obj))

        def wrap(f):
            def guarded(*args, **kwargs):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (*args, *kwargs.values())):
                    hits.add(f"{f.__module__}.{f.__name__}")
                return f(*args, **kwargs)
            return guarded
        with contextlib.ExitStack() as stack:
            for mod, attr, obj in targets:
                stack.enter_context(mock.patch.object(mod, attr, wrap(obj)))
            out = fn()
        return out, sorted(hits)

    def stream_call(source, k, tracer=None, **kw) -> tuple:
        """One ``rid_streamed`` on the card under the obs tracer (``tracer``
        when given), its launch counts from 0, its peak device memory over
        the call: ``(result, row)``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with tracing(tracer) as tr:
            dec = rid_streamed(SEED, source, k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = {}
        for sp in tr.spans:
            if sp.name in ("rid_streamed", "stream.pass1", "stream.qr_interp",
                           "stream.pass2"):
                spans[sp.name.removeprefix("stream.") + "_s"] = sp.dur
        h2d = tr.metrics.counter("stream.h2d_bytes").value
        return dec, {"wall_s": wall, **spans, "h2d_bytes": h2d,
                     "h2d_gbs": h2d / spans["pass1_s"] / 1e9,
                     "launches": read_counts(),
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}

    def run_stream_phase(keep) -> dict:
        """(a) the main row streamed from the host copy of phase main's
        ``A``, bit for bit against phase main's ``rid``, with and without
        the copies overlapped, and one traced call; (b) the paper's 64 GB
        row (PAPER_GRID[3]) from a ``SpectrumSource`` on the card, f64 and
        c128, its peak memory against the same call at m = 2^16, eq. (3)
        in closed form for the blocked engine and CGS2 on the same
        sketch; (c) a job killed in pass 1 and in pass 2 and resumed, bit
        for bit against an uninterrupted run."""
        out = {"chunk_rows": STREAM_CHUNK}
        src = ArraySource(keep["A"], STREAM_CHUNK)
        want = keep["dec"]
        # The first call also pays for the pinned buffers (the caching host
        # allocator keeps them for the calls after it).
        dec, out["main_row_first_call"] = stream_call(src, MAIN_K)
        del dec
        for overlap in (True, False):
            dec, row = stream_call(src, MAIN_K, overlap=overlap)
            row["bit_equal_to_main"] = {
                f: bool(torch.equal(getattr(dec, f).cpu(), want[f]))
                for f in "BPJQR"}
            out["main_row_overlap" if overlap else "main_row_serial"] = row
            del dec
        traced = profiled(lambda: stream_call(src, MAIN_K))
        kern = {"sketch_accum": 0.0, "Memcpy HtoD": 0.0}
        for r in traced["top_kernels"]:
            for key in kern:
                if key in r["name"]:
                    kern[key] += r["ms"]
        pass1_ms = 1e3 * out["main_row_overlap"]["pass1_s"]
        out["main_row_traced"] = {
            **traced, "sketch_accum_ms": kern["sketch_accum"],
            "h2d_copy_ms": kern["Memcpy HtoD"],
            "pass1_compute_idle_share": 1 - kern["sketch_accum"] / pass1_ms,
            "pass1_copy_busy_share": kern["Memcpy HtoD"] / pass1_ms}
        del src
        torch.cuda.empty_cache()

        big = PAPER_GRID[3]
        for dtype in (torch.float64, torch.complex128):
            rows = {}
            for m in (big.m, MAIN_M):
                spec = SpectrumSource(SEED + 40, m, big.n, "fast_decay", big.k,
                                      chunk_rows=STREAM_CHUNK, dtype=dtype,
                                      floor=1e-12, device=dev)
                dec, row = stream_call(spec, big.k)
                bound = error_bound(m, big.n, big.k) * float(
                    spec.sigmas[big.k])
                row["error_over_bound"] = spectrum_id_error(
                    spec.factors, dec.J, dec.P) / bound
                row["finite"] = bool(torch.isfinite(dec.P).all()
                                     and torch.isfinite(dec.B).all())
                row["J_distinct"] = int(torch.unique(dec.J).numel()) == big.k
                keep[f"stream_J_{dname(dtype)}_{m}"] = dec.J.cpu()
                if m == big.m:
                    row["input_bytes"] = m * big.n * dec.B.element_size()
                    cg, cg_row = stream_call(spec, big.k, qr_impl="cgs2")
                    row["cgs2_same_sketch"] = {
                        "wall_s": cg_row["wall_s"],
                        "error_over_bound": spectrum_id_error(
                            spec.factors, cg.J, cg.P) / bound}
                    del cg
                rows[f"m={m}"] = row
                del dec, spec
                torch.cuda.empty_cache()
            out[f"paper_row_{dname(dtype)}"] = rows

        gen_k = torch.Generator()
        gen_k.manual_seed(SEED + 41)
        A_small = torch.randn((4096, 1024), generator=gen_k,
                              dtype=torch.float64)
        clean = rid_streamed(1, ArraySource(A_small, 512), 32)
        killed1, killed2, resumed = killed_twice_then_resumed(
            A_small, 512, 32, dev)
        out["kill_resume"] = {"m": 4096, "n": 1024, "k": 32,
                              "chunk_rows": 512, "pass1_kill_fired": killed1,
                              "pass2_kill_fired": killed2,
                              "bit_equal": fields_equal(clean, resumed)}
        return out

    def check_stream(res: dict) -> None:
        n_main = math.ceil(MAIN_M / STREAM_CHUNK)
        n_panels = math.ceil(MAIN_K / PANEL)
        for key in ("main_row_overlap", "main_row_serial"):
            row = res[key]
            check(all(row["bit_equal_to_main"].values()),
                  f"stream {key}: not bit-equal to phase main's rid: "
                  f"{row['bit_equal_to_main']}")
            check(row["launches"]["sketch_accum"] == n_main
                  and row["launches"]["panel_step"] == n_panels,
                  f"stream {key}: launches {row['launches']}")
        big = PAPER_GRID[3]
        for dtype in ("float64", "complex128"):
            rows = res[f"paper_row_{dtype}"]
            full, small = rows[f"m={big.m}"], rows[f"m={MAIN_M}"]
            check(full["launches"]["sketch_accum"]
                  == math.ceil(big.m / STREAM_CHUNK),
                  f"stream {dtype}: launches {full['launches']}")
            check(full["finite"] and full["J_distinct"],
                  f"stream {dtype}: J or P malformed")
            flat = abs(full["max_memory_allocated"]
                       / small["max_memory_allocated"] - 1)
            check(flat <= 0.01, f"stream {dtype}: peak memory "
                  f"{full['max_memory_allocated']} at m={big.m} against "
                  f"{small['max_memory_allocated']} at m={MAIN_M}")
            check(full["cgs2_same_sketch"]["error_over_bound"] <= 1,
                  f"stream {dtype}: eq.(3) violated by CGS2")
        kr = res["kill_resume"]
        check(kr["pass1_kill_fired"] and kr["pass2_kill_fired"]
              and kr["bit_equal"], f"stream: kill and resume {kr}")

    def scrape(url: str) -> str:
        with urllib.request.urlopen(url, timeout=30) as resp:
            check(resp.status == 200, f"sharded: {url} answered "
                  f"{resp.status}")
            return resp.read().decode()

    def prom_value(text: str, name: str) -> float:
        for line in text.splitlines():
            if line.startswith(name + " "):
                return float(line.split(" ")[1])
        raise PhaseError(f"sharded: {name} missing from the scrape")

    def run_sharded_phase(keep, g) -> dict:
        """Phase sharded, (a)-(d) and (f) on the one-rank group ``g``:
        (a) the main row from the host copy of phase main's ``A``, bit for
        bit against phase distributed's call on that matrix, overlapped
        and not; (b) the paper's 64 GB row in c128 from a
        ``SpectrumSource`` on the card, watched through a
        ``TelemetryServer`` and a ``ProgressReporter``, and at m = 2^16;
        (c) the timeline of (b), the overlap report and ``psum_overlap``
        of (a); (d) a kill in each pass, resumed; (f) one deep-traced
        ``rid`` at the main row."""
        out = {"world": dist.get_world_size(g),
               "backend": str(dist.get_backend(g)),
               "chunk_rows": STREAM_CHUNK}
        k, l = MAIN_K, 2 * MAIN_K
        n_panels = math.ceil(k / PANEL)
        src = ArraySource(keep["A"], STREAM_CHUNK)
        A = keep["A"].to(dev)
        want = rid_distributed(SEED, A, k, group=g, sketch_kind="gaussian",
                               qr_impl="panel_parallel")
        want = {f: getattr(want, f).cpu() for f in "BPJQR"}
        # (f) one deep-traced rid at the main row: a qr.panel span a panel,
        # each closed on the device.
        with tracing(deep=True) as tr_deep:
            rid(SEED, A, k, sketch_kind="gaussian")
        panels = [sp for sp in tr_deep.spans if sp.name == "qr.panel"]
        out["f_deep_rid"] = {
            "qr_panel_spans": len(panels),
            "qr_panel_ms": [1e3 * sp.dur for sp in panels],
            "qr_final_r_ms": [1e3 * sp.dur for sp in tr_deep.spans
                              if sp.name == "qr.final_r"],
            "qr_panels_counter": tr_deep.metrics.counter("qr.panels").value}
        del A
        torch.cuda.empty_cache()
        # (a) the main row, streamed and sharded.
        dec, out["a_first_call"] = stream_call(src, k, group=g)
        del dec
        traces = {}
        for overlap in (True, False):
            traces[overlap] = Tracer()
            dec, row = stream_call(src, k, tracer=traces[overlap], group=g,
                                   overlap=overlap)
            row["bit_equal_to_rid_distributed"] = {
                f: bool(torch.equal(getattr(dec, f).cpu(), want[f]))
                for f in "BPJQR"}
            row["expected_launches"] = {
                "sketch_accum": math.ceil(MAIN_M / STREAM_CHUNK),
                "panel_coeff": n_panels, "panel_apply": n_panels,
                "panel_apply(emit_norms)": 1, "panel_step": 0}
            out["a_overlap" if overlap else "a_serial"] = row
            del dec
        traced = profiled(lambda: stream_call(src, k, group=g))
        out["a_traced"] = {key: traced[key] for key in (
            "traced_wall_s", "device_busy_ms", "device_idle_share",
            "top_kernels")}
        del src, want
        torch.cuda.empty_cache()
        # (c) the overlap audit of (a) and its panel schedule.
        tl_pipe = Timeline.from_tracer(traces[True])
        out["c_overlap_report"] = overlap_report(
            tl_pipe, Timeline.from_tracer(traces[False]))
        out["c_psum_overlap"] = tl_pipe.psum_overlap()
        out["c_psum_expected"] = (n_panels - 1) / n_panels

        # (b) the paper's 64 GB row in c128, watched.
        big = PAPER_GRID[3]
        C = math.ceil(big.m / STREAM_CHUNK)
        rows = {}
        for m in (MAIN_M, big.m):
            spec = SpectrumSource(SEED + 40, m, big.n, "fast_decay", big.k,
                                  chunk_rows=STREAM_CHUNK,
                                  dtype=torch.complex128, floor=1e-12,
                                  device=dev)
            if m != big.m:
                dec, row = stream_call(spec, big.k, group=g)
                rows[f"m={m}"] = row
                del dec, spec
                torch.cuda.empty_cache()
                continue
            tracer, mid = Tracer(), {}
            rep_ = ProgressReporter()
            with TelemetryServer(registry=tracer.metrics, progress=rep_,
                                 host="127.0.0.1", port=0) as srv:

                def scrape_mid(snap, url=srv.url):
                    if snap["phase"] == "pass1" and snap["done"] == C // 2 \
                            and not mid:
                        text = scrape(url + "/metrics")
                        mid.update(done=snap["done"], chunks=prom_value(
                            text, "repro_stream_chunks_total"))
                rep_.callbacks.append(scrape_mid)
                dec, row = stream_call(spec, big.k, tracer=tracer, group=g,
                                       progress=rep_)
                final = scrape(srv.url + "/metrics")
                prog = json.loads(scrape(srv.url + "/progress"))
                health = json.loads(scrape(srv.url + "/healthz"))
                row["telemetry"] = {
                    "url": srv.url, "mid_pass1": mid,
                    "chunks_scraped": prom_value(
                        final, "repro_stream_chunks_total"),
                    "chunks_traced": tracer.metrics.counter(
                        "stream.chunks").value,
                    "h2d_bytes_scraped": prom_value(
                        final, "repro_stream_h2d_bytes_total"),
                    "h2d_bytes_traced": tracer.metrics.counter(
                        "stream.h2d_bytes").value,
                    "progress": {key: prog[key] for key in
                                 ("state", "phase", "done", "total")},
                    "healthz": health["status"]}
            bound = error_bound(m, big.n, big.k) * float(spec.sigmas[big.k])
            row["error_over_bound"] = spectrum_id_error(
                spec.factors, dec.J, dec.P) / bound
            row["finite"] = bool(torch.isfinite(dec.P).all()
                                 and torch.isfinite(dec.B).all())
            row["J_distinct"] = int(torch.unique(dec.J).numel()) == big.k
            unsharded = keep[f"stream_J_complex128_{m}"]
            row["pivot_overlap_with_stream_blocked"] = len(
                set(dec.J.tolist()) & set(unsharded.tolist())) / big.k
            row["input_bytes"] = m * big.n * dec.B.element_size()
            # (c) the timeline of the watched run.
            tl = Timeline.from_tracer(tracer)
            self_sum = sum(st.self_total for st in tl.phases().values())
            row["timeline"] = {
                "wall_s": tl.wall(), "self_time_sum_s": self_sum,
                "critical_path": tl.critical_path()[:8],
                "throughput": tl.throughput()}
            rows[f"m={m}"] = row
            del dec, spec
            torch.cuda.empty_cache()
        out["b_paper_row_complex128"] = rows

        # (d) a kill in each pass, resumed, sharded.
        gen_k = torch.Generator()
        gen_k.manual_seed(SEED + 41)
        A_small = torch.randn((4096, 1024), generator=gen_k,
                              dtype=torch.float64)
        clean = rid_streamed(1, ArraySource(A_small, 512), 32, group=g)
        killed1, killed2, resumed = killed_twice_then_resumed(
            A_small, 512, 32, dev, group=g)
        out["d_kill_resume"] = {"m": 4096, "n": 1024, "k": 32,
                                "chunk_rows": 512,
                                "pass1_kill_fired": killed1,
                                "pass2_kill_fired": killed2,
                                "bit_equal": fields_equal(clean, resumed)}
        return out

    def check_sharded(res: dict) -> None:
        for key in ("a_overlap", "a_serial"):
            row = res[key]
            check(all(row["bit_equal_to_rid_distributed"].values()),
                  f"sharded {key}: not bit-equal to rid_distributed: "
                  f"{row['bit_equal_to_rid_distributed']}")
            got = {name: row["launches"][name]
                   for name in row["expected_launches"]}
            check(got == row["expected_launches"],
                  f"sharded {key}: launches {got}, expected "
                  f"{row['expected_launches']}")
        big = PAPER_GRID[3]
        rows = res["b_paper_row_complex128"]
        full, small = rows[f"m={big.m}"], rows[f"m={MAIN_M}"]
        check(full["launches"]["sketch_accum"]
              == math.ceil(big.m / STREAM_CHUNK),
              f"sharded (b): launches {full['launches']}")
        check(full["finite"] and full["J_distinct"]
              and full["error_over_bound"] <= 1,
              f"sharded (b): J, P or eq. (3) off: {full['error_over_bound']}")
        flat = abs(full["max_memory_allocated"]
                   / small["max_memory_allocated"] - 1)
        check(flat <= 0.01, f"sharded (b): peak memory "
              f"{full['max_memory_allocated']} at m={big.m} against "
              f"{small['max_memory_allocated']} at m={MAIN_M}")
        tel = full["telemetry"]
        C = math.ceil(big.m / STREAM_CHUNK)
        check(tel["mid_pass1"].get("chunks") == C // 2
              and tel["chunks_scraped"] == tel["chunks_traced"] == C
              and tel["h2d_bytes_scraped"] == tel["h2d_bytes_traced"],
              f"sharded (b): telemetry against the tracer {tel}")
        check(tel["progress"]["done"] == tel["progress"]["total"] == 2 * C
              and tel["progress"]["state"] == "done"
              and tel["healthz"] == "ok",
              f"sharded (b): /progress or /healthz {tel}")
        tl = full["timeline"]
        check(abs(tl["self_time_sum_s"] / tl["wall_s"] - 1) <= 0.01,
              f"sharded (c): phase self-times {tl['self_time_sum_s']} "
              f"against the wall {tl['wall_s']}")
        check(0.0 <= res["c_overlap_report"]["hidden_fraction"] <= 1.0,
              f"sharded (c): {res['c_overlap_report']}")
        check(res["c_psum_overlap"] == res["c_psum_expected"],
              f"sharded (c): psum_overlap {res['c_psum_overlap']}")
        kr = res["d_kill_resume"]
        check(kr["pass1_kill_fired"] and kr["pass2_kill_fired"]
              and kr["bit_equal"], f"sharded (d): kill and resume {kr}")
        deep = res["f_deep_rid"]
        n_panels = math.ceil(MAIN_K / PANEL)
        check(deep["qr_panel_spans"] == n_panels == deep["qr_panels_counter"]
              and all(ms > 0 for ms in deep["qr_panel_ms"]),
              f"sharded (f): {deep}")

    def run_sharded_benchmarks(g) -> dict:
        """Phase sharded (e): ``bench_stream``'s sharded sweep on ``g``
        (world 1, a ``FileSource`` in a temporary directory), then
        ``bench_trace`` into a temporary directory, both traces
        validated."""
        with contextlib.redirect_stdout(io.StringIO()):
            rows = bench_stream.stream_sharded_sweep(g, device=dev)
        check(len(rows) == 1 and rows[0]["ndev"] == 1
              and rows[0]["on_disk_bytes"] > rows[0]["peak_device_bytes"],
              f"sharded (e): bench_stream --sharded rows {rows}")
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(io.StringIO()):
                written = bench_trace.main(["--out", tmp])
            traces = []
            for path, nspans in written:
                bench_trace.validate(path)
                traces.append({"file": Path(path).name, "spans": nspans,
                               "bytes": Path(path).stat().st_size})
        check([t["file"] for t in traces] == ["stream_trace.json",
                                                "serve_trace.json"],
              f"sharded (e): bench_trace wrote {traces}")
        return {"bench_stream_sharded": rows, "bench_trace": traces}

    def run_rid(m, n, k, dtype, keep=None, **kw):
        """One ``rid`` on a fresh low-rank ``A``; with ``keep`` (a dict),
        host copies of ``A`` and of the result's fields go there."""
        A = lowrank(m, n, k, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        dec = rid(SEED, A, k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        out = {"m": m, "n": n, "k": k, "l": 2 * k, "dtype": dname(dtype),
               "launches": counts, "wall_s": wall,
               "max_memory_allocated": peak, **eq3_report(A, dec, k)}
        if keep is not None:
            keep["A"] = A.cpu()
            keep["dec"] = {f: getattr(dec, f).cpu() for f in "BPJQR"}
        del A, dec
        torch.cuda.empty_cache()
        return out

    main_keep = {}
    res, ref_hits = ref_calls_on_card(lambda: run_rid(
        MAIN_M, MAIN_N, MAIN_K, torch.float64, keep=main_keep,
        sketch_kind="gaussian"))
    emit({"phase": "main", "call": "rid(seed, A, 400, sketch_kind='gaussian')",
          **res, "ref_py_given_cuda_tensors": ref_hits})
    check(not ref_hits, f"main: CUDA tensors reached {ref_hits}")
    n_panels = math.ceil(MAIN_K / PANEL)
    check(res["launches"]["sketch_accum"] == 1,
          f"main: sketch_accum launched {res['launches']['sketch_accum']} "
          f"times, expected 1")
    check(res["launches"]["panel_step"] == n_panels,
          f"main: panel_step launched {res['launches']['panel_step']} "
          f"times, expected {n_panels}")
    check_id(res, "main")
    main_launches = res["launches"]

    # ------------------- stream: the streamed ID (rid_streamed) on one card
    res, ref_hits = ref_calls_on_card(
        lambda: run_stream_phase(main_keep))
    emit({"phase": "stream", **res, "ref_py_given_cuda_tensors": ref_hits})
    check(not ref_hits, f"stream: CUDA tensors reached {ref_hits}")
    check_stream(res)

    # ----------- sharded: rid_streamed(group=) on the one-rank NCCL group
    t_sharded = time.perf_counter()
    with bench_error.one_rank_group(dev) as g:
        res, ref_hits = ref_calls_on_card(
            lambda: run_sharded_phase(main_keep, g))
        emit({"phase": "sharded", **res,
              "ref_py_given_cuda_tensors": ref_hits})
        check(not ref_hits, f"sharded: CUDA tensors reached {ref_hits}")
        check_sharded(res)
        res = run_sharded_benchmarks(g)
    del main_keep
    emit({"phase": "sharded", "part": "e", **res,
          "phase_s": time.perf_counter() - t_sharded})

    # ------------------- srht: the main row through the fwht kernel
    # rid(sketch_kind="srht") on a matrix of the main row's shape from a
    # generator of its own (the later phases keep their draws): the fwht
    # kernel once a factor, panel_step once a panel, no sketch_accum.
    # eq. (3) is reported for the blocked engine and gated for CGS2 on the
    # same sketch.  The blocked engine reads above the bound on this draw;
    # so does the reference's blocked engine on the same sketch at smaller
    # exact-rank shapes, with the port's pivots (bench_error --witness,
    # tests/test_torch_eq3_witness.py; ROADMAP Queue C).
    gen_srht = torch.Generator(device=dev)
    gen_srht.manual_seed(SEED + 30)

    def run_srht():
        A = torch.randn((MAIN_M, MAIN_K), generator=gen_srht,
                        dtype=torch.float64, device=dev) @ torch.randn(
            (MAIN_K, MAIN_N), generator=gen_srht, dtype=torch.float64,
            device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        dec = rid(SEED, A, MAIN_K, sketch_kind="srht")
        torch.cuda.synchronize()
        out = {"m": MAIN_M, "n": MAIN_N, "k": MAIN_K, "l": 2 * MAIN_K,
               "dtype": "float64", "launches": read_counts(),
               "wall_s": time.perf_counter() - t0,
               **eq3_report(A, dec, MAIN_K)}
        Y = sketch(SEED, A, 2 * MAIN_K, kind="srht").Y
        out["cgs2_same_sketch"] = eq3_report(
            A, rid_from_sketch(A, Y, MAIN_K, qr_impl="cgs2"), MAIN_K)
        del A, dec, Y
        torch.cuda.empty_cache()
        return out
    res, ref_hits = ref_calls_on_card(run_srht)
    emit({"phase": "srht", "call": "rid(seed, A, 400, sketch_kind='srht')",
          **res, "eq3_gated": "cgs2_same_sketch only",
          "ref_py_given_cuda_tensors": ref_hits})
    check(not ref_hits, f"srht: CUDA tensors reached {ref_hits}")
    check(res["launches"]["fwht"] == len(fwht_factors(MAIN_M))
          and res["launches"]["panel_step"] == n_panels
          and res["launches"]["sketch_accum"] == 0,
          f"srht: launches {res['launches']}")
    for what in (res, res["cgs2_same_sketch"]):
        check(what["J_distinct"] and what["J_in_range"] and what["P_J_identity"]
              and what["finite"], "srht: J or P malformed")
    check(res["cgs2_same_sketch"]["error_over_bound"] <= 1,
          "srht: eq.(3) violated by CGS2 on the srht sketch")

    # ----------------------------------------- 4. default path, c128 srft
    res, ref_hits = ref_calls_on_card(lambda: run_rid(
        DEFAULT_M, DEFAULT_N, DEFAULT_K, torch.complex128))
    emit({"phase": "default", "call": "rid(seed, A, 100)", **res,
          "ref_py_given_cuda_tensors": ref_hits})
    check(not ref_hits, f"default: CUDA tensors reached {ref_hits}")
    n_panels = math.ceil(DEFAULT_K / PANEL)
    check(res["launches"]["panel_step"] == n_panels,
          f"default: panel_step launched {res['launches']['panel_step']} "
          f"times, expected {n_panels}")
    check_id(res, "default")

    # ------------- 5. distributed path on a one-rank NCCL group, f64 main
    with bench_error.one_rank_group(dev) as group:
        dist_launches, gram_launches = run_distributed_phases(group)

    # ------------- bench: the paper's phase benchmarks (Tables 1, 2 and 4)
    calls = WARMUP + ITERS          # calls of each column's op per row

    def bench(fn) -> tuple[list, dict, float]:
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return rows, read_counts(), wall

    def finite_times(rows) -> bool:
        return all(math.isfinite(v) and v > 0 for r in rows
                   for key, v in r.items() if key.endswith("_s"))

    (sk_rows, sk_counts, sk_wall), ref_hits = ref_calls_on_card(
        lambda: bench(lambda: bench_sketch.run([MAIN], torch.float64)))
    check(not ref_hits, f"bench_sketch: CUDA tensors reached {ref_hits}")
    n_factors = len(fwht_factors(MAIN_M))
    per_call = {"sketch_matmul": sk_counts["sketch_matmul"] / calls,
                "fwht": sk_counts["fwht"] / (2 * calls),
                "sketch_accum": sk_counts["sketch_accum"] / calls}
    emit({"phase": "bench", "table": 2,
          "call": "bench_sketch.run([PAPER_GRID[2]], torch.float64)",
          "rows": sk_rows, "launches": sk_counts,
          "launches_per_call": per_call, "calls_per_column": calls,
          "wall_s": sk_wall})
    check(finite_times(sk_rows), f"bench_sketch: rows {sk_rows}")
    # fwht: the srht_s column (srht_sketch) and the srht_cuda_s column.
    check(sk_counts["sketch_matmul"] == calls
          and sk_counts["fwht"] == 2 * calls * n_factors
          and sk_counts["sketch_accum"] == calls,
          f"bench_sketch: launches {sk_counts}, expected {calls} "
          f"sketch_matmul, {2 * calls * n_factors} fwht, {calls} "
          f"sketch_accum")

    ts_rows, ts_counts, ts_wall = bench(
        lambda: bench_tsolve.run([MAIN], torch.float64))
    bar = TSOLVE_BWD_C * MAIN_K * torch.finfo(torch.float64).eps
    # one call more than the timed ones: the backward-error check
    emit({"phase": "bench", "table": 4,
          "call": "bench_tsolve.run([PAPER_GRID[2]], torch.float64)",
          "rows": ts_rows, "launches": ts_counts,
          "launches_per_call": {"tsolve": ts_counts["tsolve"] / (calls + 1)},
          "calls": calls + 1, "backward_err_bar": bar, "wall_s": ts_wall})
    check(finite_times(ts_rows), f"bench_tsolve: rows {ts_rows}")
    check(ts_counts["tsolve"] == calls + 1,
          f"bench_tsolve: {ts_counts['tsolve']} tsolve launches, expected "
          f"{calls + 1}")
    check(ts_rows[0]["cuda_backward_err"] <= bar,
          f"bench_tsolve: backward error {ts_rows[0]['cuda_backward_err']} "
          f"> {bar}")

    bt_rows, bt_counts, bt_wall = bench(
        lambda: bench_total.run([DEFAULT], "srft", torch.complex128))
    emit({"phase": "bench", "table": 1,
          "call": "bench_total.run([PAPER_GRID[0]], 'srft', "
                  "torch.complex128)",
          "rows": bt_rows, "launches": bt_counts, "wall_s": bt_wall})
    check(finite_times(bt_rows), f"bench_total: rows {bt_rows}")
    check(bt_counts["panel_step"] == calls * math.ceil(DEFAULT_K / PANEL),
          f"bench_total: launches {bt_counts}")
    bench_launches = {"sketch_matmul": sk_counts["sketch_matmul"],
                      "fwht": sk_counts["fwht"], "tsolve": ts_counts["tsolve"]}

    # Tables 3 and 5.  The modules print their CSV rows; those go into the
    # phase lines instead, so that standard output stays one JSON object a
    # line.
    cgs_names = ("project_out", "panel_deflate", "panel_gram", "panel_step")

    def _quiet_call(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    def check_counts(what, counts, expected, calls_):
        got = {name: counts[name] for name in expected}
        emit({"phase": "bench", "table": what, "launches": got,
              "expected": expected, "calls": calls_,
              "launches_per_call": {name: got[name] / calls_
                                    for name in cgs_names}})
        check(got == expected, f"{what}: launches {got}, expected {expected}")

    def n_panels(k, widths):
        return sum(math.ceil(k / b) for b in widths)

    q3_rows, q3_counts, q3_wall = bench(
        lambda: bench_qr.run([MAIN], torch.float64))
    emit({"phase": "bench", "table": 3,
          "call": "bench_qr.run([PAPER_GRID[2]], torch.float64)",
          "rows": q3_rows, "wall_s": q3_wall})
    check(finite_times(q3_rows), f"bench_qr: rows {q3_rows}")
    # One project_out and one panel_deflate per call of their columns;
    # ceil(k / b) panel_step per blocked call at each width.
    check_counts(3, q3_counts,
                 {"project_out": calls, "panel_deflate": calls,
                  "panel_gram": 0,
                  "panel_step": calls * n_panels(MAIN_K,
                                                 bench_qr.PANEL_SWEEP)},
                 calls)
    qr_launches = {name: q3_counts[name]
                   for name in ("project_out", "panel_deflate")}

    sw_rows, sw_counts, sw_wall = bench(lambda: _quiet_call(
        lambda: bench_qr.fused_vs_split_sweep(bench_qr.PANEL_SWEEP)))
    emit({"phase": "bench", "table": "3 (fused vs split)",
          "call": "bench_qr.fused_vs_split_sweep(PANEL_SWEEP)",
          "rows": sw_rows, "wall_s": sw_wall})
    check(finite_times(sw_rows), f"fused_vs_split_sweep: rows {sw_rows}")
    # Per split call ceil(k / b) panel_gram and panel_deflate; per fused
    # call ceil(k / b) panel_step.
    sw_panels = calls * n_panels(bench_qr.ACCEPT_K, bench_qr.PANEL_SWEEP)
    check_counts("3 (fused vs split)", sw_counts,
                 {"project_out": 0, "panel_deflate": sw_panels,
                  "panel_gram": sw_panels, "panel_step": sw_panels}, calls)

    t5_rows, t5_counts, t5_wall = bench(
        lambda: bench_error.run([DEFAULT]))
    emit({"phase": "bench", "table": 5,
          "call": "bench_error.run([PAPER_GRID[0]])",
          "sketch": "srft", "qr_impl": "cgs2", "dtype": "complex128",
          "rows": t5_rows, "wall_s": t5_wall})
    check(all(math.isfinite(r["err_2norm"]) for r in t5_rows),
          f"bench_error: rows {t5_rows}")
    check(all(r["within_bound"] for r in t5_rows),
          f"bench_error: eq.(3) violated: {t5_rows}")
    # The paper's CGS2 QR and the SRFT run no kernel of the port.
    check_counts(5, t5_counts, {name: 0 for name in cgs_names}, 1)

    with bench_error.one_rank_group(dev) as group:
        gr_rows, gr_counts, gr_wall = bench(lambda: _quiet_call(
            lambda: bench_error.grid_sweep(group=group, device=dev)))
    grid = [r for r in gr_rows if r["bench"] == "error_grid"]
    width = [r for r in gr_rows if r["bench"] == "error_grid_width"]
    summary = [r for r in gr_rows if r["bench"] == "error_grid_summary"]
    emit({"phase": "bench", "table": "5 (known-spectrum grid)",
          "call": "bench_error.grid_sweep(group=g)",
          "rows": len(gr_rows), "worst_ratio": summary, "width": width,
          "max_grid_ratio": max(r["ratio"] for r in grid),
          "wall_s": gr_wall})
    # grid_sweep asserts the gated rows itself; checked again here.
    check(all(r["within_bound"] for r in grid + summary),
          "bench_error grid: eq.(3) violated")
    # Per gaussian rid: one sketch_accum; per blocked rid ceil(k / b)
    # panel_step with b the auto width (or the sweep's width); per
    # panel_parallel rid ceil(k / b) panel_coeff and panel_apply.
    auto = {r["k"]: math.ceil(r["k"] / resolve_panel("auto", r["k"],
                                                      2 * r["k"]))
            for r in grid}
    par = sum(auto[r["k"]] for r in grid if r["impl"] == "panel_parallel")
    check_counts("5 (known-spectrum grid)", gr_counts,
                 {"project_out": 0, "panel_deflate": 0, "panel_gram": 0,
                  "panel_step": sum(auto[r["k"]] for r in grid
                                    if r["impl"] == "blocked")
                  + sum(math.ceil(r["k"] / r["panel"]) for r in width),
                  "panel_coeff": par, "panel_apply": par,
                  "sketch_accum": len(grid) + len(width)},
                 len(grid) + len(width))

    # ------------- serve: granite-3-2b at full width through ServeEngine
    cfg = get_config("granite-3-2b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = []
    for _ in range(6):                  # as launch/serve.py draws them
        plen = int(rng.integers(4, 12))
        prompts.append(rng.integers(0, cfg.vocab_size, plen).astype(np.int32))
    prompts += [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in SERVE_LONG]
    eng = ServeEngine(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN)
    reqs = [GenerationRequest(request_id=i, prompt=p,
                              max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    tracer = Tracer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with tracing(tracer):
        eng.run()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = read_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    spans = {}
    for sp in tracer.spans:
        spans.setdefault(sp.name, []).append(sp)
    long_prefill = [sp.dur for sp in spans.get("serve.prefill", [])
                    if sp.attrs.get("prompt_tokens") == SERVE_LONG[-1]]
    decode_s = [sp.dur for sp in spans.get("serve.decode", [])]
    tokens = sum(len(r.output) for r in reqs)
    n_long = sum(len(p) > attn_mod.BLOCKWISE_THRESHOLD for p in prompts)
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, "init_s": init_s, "wall_s": serve_wall,
          "generated_tokens": tokens, "tokens_per_s": tokens / serve_wall,
          "prefill_4000_s": long_prefill[0] if long_prefill else None,
          "decode_steps": len(decode_s),
          "decode_step_mean_s": (sum(decode_s) / len(decode_s)
                                 if decode_s else None),
          "max_memory_allocated": serve_peak, "launches": serve_launches,
          "statuses": sorted({r.status for r in reqs})})
    check(all(r.status == "done" and len(r.output) == SERVE_NEW
              for r in reqs), f"serve: {[(r.status, len(r.output)) for r in reqs]}")
    check(serve_launches["flash"] == n_long * cfg.n_layers == 80,
          f"serve: flash launched {serve_launches['flash']} times, expected "
          f"{n_long} x {cfg.n_layers}")
    check(all(v == 0 for name, v in serve_launches.items() if name != "flash"),
          f"serve: other kernels launched {serve_launches}")
    check(len(long_prefill) == 1, "serve: no prefill span of the long prompt")
    del eng, reqs, tracer, spans
    torch.cuda.empty_cache()

    # The long prompt once more: one-shot prefill (flash) against the
    # chunked prefill (attention_extend, dense) at full width.
    toks = torch.as_tensor(prompts[-1], dtype=torch.int64, device=dev)[None]
    lg_one, caches = prefill(model, cfg, toks, max_len=SERVE_LEN)
    nxt = torch.argmax(lg_one[:, -1], dim=-1)[:, None]
    lg_dec, _ = decode_step(model, cfg, nxt, toks.shape[1], caches)
    del caches
    # Where a prefill's and a decode step's time goes (batch 4, the
    # engine's shared cache of max_len).
    prefill_trace = profiled(lambda: prefill(model, cfg, toks,
                                             max_len=SERVE_LEN))
    batch = init_caches(cfg, SERVE_BATCH, SERVE_LEN, dev)
    step_toks = nxt.expand(SERVE_BATCH, 1).contiguous()
    step_pos = torch.full((SERVE_BATCH,), toks.shape[1], device=dev)
    decode_step(model, cfg, step_toks, step_pos, batch)
    decode_trace = profiled(lambda: decode_step(model, cfg, step_toks,
                                                step_pos, batch))
    emit({"phase": "serve", "check": "trace", "prompt_tokens": toks.shape[1],
          "prefill": prefill_trace, "decode_step_batch": SERVE_BATCH,
          "decode_step": decode_trace})
    del batch
    chunked = init_caches(cfg, 1, SERVE_LEN, dev)
    reset_counts()
    for p0 in range(0, toks.shape[1], CHUNK):
        lg_chunk, chunked = prefill_chunk(model, cfg, toks[:, p0:p0 + CHUNK],
                                          p0, chunked)
    torch.cuda.synchronize()
    chunk_launches = read_counts()["flash"]
    del chunked
    torch.cuda.empty_cache()
    lg_f32, _ = prefill(model, cfg.replace(dtype="float32"), toks,
                        max_len=SERVE_LEN)
    a, b, c = (x.float().flatten() for x in (lg_one, lg_chunk, lg_f32))
    cross = {"rel_l2": float((a - b).norm() / a.norm()),
             "max_abs_over_max": float((a - b).abs().max() / a.abs().max())}
    emit({"phase": "serve", "check": "one-shot (flash) vs chunked prefill",
          "prompt_tokens": toks.shape[1], "chunk": CHUNK,
          "chunk_flash_launches": chunk_launches, **cross, "tol": CHUNK_TOL,
          "max_abs_logit": float(a.abs().max()),
          "argmax_equal": bool(a.argmax() == b.argmax()),
          "bf16_vs_f32_compute_rel_l2": float((a - c).norm() / c.norm()),
          "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()
                         and torch.isfinite(lg_dec).all())})
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()
               and torch.isfinite(lg_dec).all()), "serve: logits not finite")
    check(chunk_launches == 0, "serve: chunked prefill launched flash")
    check(all(cross[key] <= CHUNK_TOL[key] for key in CHUNK_TOL),
          f"serve: one-shot vs chunked {cross} beyond {CHUNK_TOL}")
    del model, lg_one, lg_chunk, lg_f32, lg_dec, toks
    torch.cuda.empty_cache()

    # ------------- swa: h2o-danube-1.8b at full width, depth cut to 4
    dcfg = get_config("h2o-danube-1.8b").replace(n_layers=SWA_LAYERS)
    dmodel = init_params(SEED, dcfg, device=dev)
    toks = torch.randint(0, dcfg.vocab_size, (1, SWA_PROMPT), generator=gen,
                         device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, caches = prefill(dmodel, dcfg, toks, max_len=SWA_PROMPT + SWA_STEPS)
    torch.cuda.synchronize()
    swa_prefill_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(lg).all())
    for i in range(SWA_STEPS):
        nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
        lg, caches = decode_step(dmodel, dcfg, nxt, SWA_PROMPT + i, caches)
        finite = finite and bool(torch.isfinite(lg).all())
    swa_launches = read_counts()
    # The first layer's attention at the prompt: the kernel (through the
    # model's blockwise path) against ref.py on the same q, k, v.
    blk = dmodel.blocks[0]
    h = rmsnorm(blk.ln1, embed_tokens(dmodel, dcfg, toks), dcfg.norm_eps)
    q, k, v = attn_mod._project_qkv(blk.mixer, dcfg, h, h)
    pos = torch.arange(SWA_PROMPT, device=dev)[None]
    cos, sin = rope_cos_sin(pos, dcfg.hd, dcfg.rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    g = dcfg.n_heads // dcfg.n_kv_heads
    kr, vr = (torch.repeat_interleave(x, g, dim=2) for x in (k, v))
    got = attn_mod._attention_blockwise(q, kr, vr, causal=True,
                                        window=dcfg.sliding_window)
    B, S, H, hd = q.shape
    tohm = lambda x: x.transpose(1, 2).reshape(B * H, S, hd)  # noqa: E731
    want = flash_ref(tohm(q.float()) * torch.tensor(hd ** -0.5, device=dev),
                     tohm(kr), tohm(vr), causal=True,
                     window=dcfg.sliding_window)
    want = want.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
    swa_err = rel_err(got, want)
    emit({"phase": "swa", "arch": dcfg.name, "n_layers": SWA_LAYERS,
          "reduced": f"depth cut from 24 to {SWA_LAYERS} layers (run time)",
          "d_model": dcfg.d_model, "hd": dcfg.hd,
          "window": dcfg.sliding_window, "prompt_tokens": SWA_PROMPT,
          "ring_buffer_len": caches["self"][0].k.shape[1],
          "decode_steps": SWA_STEPS, "prefill_s": swa_prefill_s,
          "launches": swa_launches, "finite": finite,
          "layer0_attention_rel_err": swa_err, "rel_tol": FLASH_TOL,
          "live_block_share": live_block_share(SWA_PROMPT, SWA_PROMPT, True,
                                               dcfg.sliding_window)})
    check(finite, "swa: logits not finite")
    check(swa_launches["flash"] == SWA_LAYERS,
          f"swa: flash launched {swa_launches['flash']} times, expected "
          f"{SWA_LAYERS}")
    check(caches["self"][0].k.shape[1] == dcfg.sliding_window,
          "swa: the cache is not the window's ring buffer")
    check(swa_err <= FLASH_TOL, f"swa: layer-0 attention rel err {swa_err}")
    del dmodel, caches, lg, toks, h, q, k, v, kr, vr, got, want
    torch.cuda.empty_cache()

    # ------------- moe: qwen2-moe-a2.7b at full width and depth; phi3.5-moe,
    # qwen3-8b and qwen2-7b at full width, depth cut to 4 (own generator).
    gen_moe = torch.Generator(device=dev)
    gen_moe.manual_seed(SEED + 27)

    @contextlib.contextmanager
    def recording_moe(record):
        """The models' moe_ffn, keeping each call's aux values."""
        real = tr_mod.moe_ffn

        def rec(p, c, x, *, group_size=None):
            y, aux = real(p, c, x, group_size=group_size)
            record.append(aux)
            return y, aux
        with mock.patch.object(tr_mod, "moe_ffn", rec):
            yield record

    def profiled_parts(fn) -> dict:
        """One call of ``fn`` under ``torch.profiler``: busy and idle share,
        and the device time of the flash kernel, of the dtype casts (under
        ``aten::_to_copy``: the f32 -> bf16 weight casts and a few small
        activation casts), of the expert SwiGLU (the ``moe.experts``
        range: three batched GEMMs and the gate) and of the rest."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                          for e in averages
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda r: -r[1])
        busy = sum(r[1] for r in kernels)
        check(busy > 0, "moe trace: no device time recorded")

        def under(name) -> float:
            return max([e.device_time_total / 1e3 for e in averages
                        if e.key == name], default=0.0)
        parts = {"flash_ms": sum(r[1] for r in kernels
                                 if "flash_fwd_kernel" in r[0]),
                 "casts_ms": under("aten::_to_copy"),
                 "expert_swiglu_ms": under("moe.experts")}
        parts["rest_ms"] = busy - sum(parts.values())
        return {"traced_wall_s": wall, "device_busy_ms": busy,
                "device_idle_share": 1 - busy / (1e3 * wall), **parts,
                "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                                for k, ms, c in kernels[:12]]}

    def cast_bytes(model) -> int:
        """Bytes a forward's weight casts move: every block weight the
        model casts to the compute dtype (all but the norms' scales and
        the f32 router), read in f32 and written in bf16."""
        return sum(6 * t.numel() for name, t in model.named_parameters()
                   if name.startswith("blocks.") and "norm" not in name
                   and not name.endswith(("ln1.scale", "ln2.scale",
                                          "router")))

    moe_flash_launches = 0
    # (a) qwen2-moe-a2.7b at full width and depth through the engine.
    cfg = get_config("qwen2-moe-a2.7b")
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = []
    for _ in range(6):                  # as launch/serve.py draws them
        plen = int(rng.integers(4, 12))
        prompts.append(rng.integers(0, cfg.vocab_size, plen).astype(np.int32))
    prompts += [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in SERVE_LONG]
    eng = ServeEngine(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN)
    reqs = [GenerationRequest(request_id=i, prompt=p,
                              max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    tracer = Tracer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with tracing(tracer):
        eng.run()
    torch.cuda.synchronize()
    moe_wall = time.perf_counter() - t0
    moe_launches = read_counts()
    moe_peak = torch.cuda.max_memory_allocated()
    moe_flash_launches += moe_launches["flash"]
    long_prefill = [sp.dur for sp in tracer.spans if sp.name == "serve.prefill"
                    and sp.attrs.get("prompt_tokens") == SERVE_LONG[-1]]
    decode_s = [sp.dur for sp in tracer.spans if sp.name == "serve.decode"]
    tokens = sum(len(r.output) for r in reqs)
    n_long = sum(len(p) > attn_mod.BLOCKWISE_THRESHOLD for p in prompts)
    statuses = [(r.status, len(r.output)) for r in reqs]
    del eng, reqs, tracer
    torch.cuda.empty_cache()
    # The long prompt once more, its layers' drops recorded, then a
    # profiled prefill and a profiled batch-4 decode step.
    toks = torch.as_tensor(prompts[-1], dtype=torch.int64, device=dev)[None]
    with recording_moe([]) as record:
        lg, caches = prefill(model, cfg, toks, max_len=SERVE_LEN)
    long_drop = [float(a.dropped_fraction) for a in record]
    long_lb = [float(a.load_balance_loss) for a in record]
    check(len(long_drop) == cfg.n_layers, f"moe (a): {len(long_drop)} MoE "
          f"calls in the long prefill")
    nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
    finite = bool(torch.isfinite(lg).all())
    del caches, lg
    prefill_trace = profiled_parts(lambda: prefill(model, cfg, toks,
                                                   max_len=SERVE_LEN))
    batch = init_caches(cfg, SERVE_BATCH, SERVE_LEN, dev)
    step_toks = nxt.expand(SERVE_BATCH, 1).contiguous()
    step_pos = torch.full((SERVE_BATCH,), toks.shape[1], device=dev)
    decode_step(model, cfg, step_toks, step_pos, batch)
    decode_trace = profiled_parts(lambda: decode_step(model, cfg, step_toks,
                                                      step_pos, batch))
    del batch
    torch.cuda.empty_cache()
    moved = cast_bytes(model)
    emit({"phase": "moe", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_experts": cfg.n_experts, "top_k": cfg.n_experts_active,
          "n_shared_experts": cfg.n_shared_experts,
          "moe_d_ff": cfg.moe_d_ff, "params": cfg.param_count(),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "memory_allocated_at_start": mem_start, "init_s": init_s,
          "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, "wall_s": moe_wall,
          "generated_tokens": tokens, "tokens_per_s": tokens / moe_wall,
          "prefill_4000_s": long_prefill[0] if long_prefill else None,
          "decode_steps": len(decode_s),
          "decode_step_mean_s": (sum(decode_s) / len(decode_s)
                                 if decode_s else None),
          "max_memory_allocated": moe_peak, "launches": moe_launches,
          "long_prefill_moe_drop_mean": sum(long_drop) / len(long_drop),
          "long_prefill_moe_drop_by_layer": long_drop,
          "long_prefill_moe_lb_mean": sum(long_lb) / len(long_lb),
          "cast_bytes_per_forward": moved,
          "cast_floor_ms": 1e3 * moved / HBM_BYTES_PER_S,
          "prefill_trace": prefill_trace, "decode_step_batch": SERVE_BATCH,
          "decode_step_trace": decode_trace, "finite": finite})
    check(all(st == "done" and n == SERVE_NEW for st, n in statuses),
          f"moe (a): {statuses}")
    check(moe_launches["flash"] == n_long * cfg.n_layers == 48,
          f"moe (a): flash launched {moe_launches['flash']} times, expected "
          f"{n_long} x {cfg.n_layers}")
    check(all(v == 0 for name, v in moe_launches.items() if name != "flash"),
          f"moe (a): other kernels launched {moe_launches}")
    check(len(long_prefill) == 1, "moe (a): no prefill span of the long "
          "prompt")
    check(finite, "moe (a): logits not finite")

    # (b) One layer's moe_ffn at full width on 512 tokens in f32 compute,
    # on the card (twice) and on the CPU with the same weights and input.
    lcfg = cfg.replace(dtype="float32")
    layer = model.blocks[0].moe
    x = torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=gen_moe,
                    device=dev)
    y1, aux1 = moe_mod.moe_ffn(layer, lcfg, x)
    y2, aux2 = moe_mod.moe_ffn(layer, lcfg, x)
    y_bf16, _ = moe_mod.moe_ffn(layer, cfg, x)
    cpu_layer = moe_mod.MoE(lcfg)
    for a, b in zip(cpu_layer.parameters(), layer.parameters()):
        a.copy_(b.cpu())
    t0 = time.perf_counter()
    y_cpu, aux_cpu = moe_mod.moe_ffn(cpu_layer, lcfg, x.cpu())
    cpu_s = time.perf_counter() - t0
    capacity = moe_mod.moe_capacity(lcfg, MOE_LAYER_TOKENS)
    routing = []
    for mod, t in ((layer, x), (cpu_layer, x.cpu())):
        _, _, top_i = moe_mod.route(mod, lcfg, t)
        _, keep = moe_mod.dispatch_indices(top_i.reshape(1, -1),
                                           cfg.n_experts, capacity)
        routing.append((top_i.cpu(), keep.cpu()))
    y_err = rel_err(y1.cpu(), y_cpu)
    aux_err = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
               for a, b in zip(aux1, aux_cpu)]
    repeat = bool(torch.equal(y1, y2) and all(
        torch.equal(a, b) for a, b in zip(aux1, aux2)))
    top_equal = bool(torch.equal(routing[0][0], routing[1][0]))
    keep_equal = bool(torch.equal(routing[0][1], routing[1][1]))
    emit({"phase": "moe", "part": "b", "arch": cfg.name, "layer": 0,
          "tokens": MOE_LAYER_TOKENS, "capacity": capacity,
          "compute_dtype": "float32", "topk_equal": top_equal,
          "keep_equal": keep_equal, "kept_pairs": int(routing[0][1].sum()),
          "y_rel_err": y_err, "aux_rel_err": aux_err, "tol": MOE_TOL,
          "moe_lb": float(aux1.load_balance_loss),
          "moe_drop": float(aux1.dropped_fraction),
          "card_repeat_bit_equal": repeat, "cpu_s": cpu_s,
          "bf16_vs_f32_compute_rel_err": rel_err(y_bf16.float(), y1)})
    check(top_equal and keep_equal, "moe (b): routing differs from the CPU")
    check(y_err <= MOE_TOL and all(e <= MOE_TOL for e in aux_err),
          f"moe (b): y {y_err}, aux {aux_err} beyond {MOE_TOL}")
    check(repeat, "moe (b): two card calls differ")
    del model, layer, cpu_layer, x, y1, y2, y_bf16, y_cpu, toks, nxt
    del step_toks, step_pos
    torch.cuda.empty_cache()

    # (c), (d) phi3.5-moe, qwen3-8b and qwen2-7b at full width, 4 layers.
    def cut_run(name) -> dict:
        c = get_config(name).replace(n_layers=MOE_CUT_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        m = init_params(SEED, c, device=dev)
        toks = torch.randint(0, c.vocab_size, (1, MOE_PROMPT),
                             generator=gen_moe, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        with recording_moe([]) as record:
            t0 = time.perf_counter()
            lg, caches = prefill(m, c, toks, max_len=MOE_PROMPT + MOE_STEPS)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            n_prefill = len(record)
            finite = bool(torch.isfinite(lg).all())
            t0 = time.perf_counter()
            for i in range(MOE_STEPS):
                nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
                lg, caches = decode_step(m, c, nxt, MOE_PROMPT + i, caches)
                finite = finite and bool(torch.isfinite(lg).all())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        launches = read_counts()
        drops = [float(a.dropped_fraction) for a in record]
        # The first layer's attention at the prompt (qk-norm, QKV bias and
        # GQA on the card): the kernel through the model's blockwise path
        # against ref.py on the same q, k, v.
        blk = m.blocks[0]
        h = rmsnorm(blk.ln1, embed_tokens(m, c, toks), c.norm_eps)
        q, k, v = attn_mod._project_qkv(blk.mixer, c, h, h)
        pos = torch.arange(MOE_PROMPT, device=dev)[None]
        cos, sin = rope_cos_sin(pos, c.hd, c.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        g = c.n_heads // c.n_kv_heads
        kr, vr = attn_mod._repeat_kv(k, g), attn_mod._repeat_kv(v, g)
        got = attn_mod._attention_blockwise(q, kr, vr, causal=True,
                                            window=None)
        B, S, H, hd = q.shape
        tohm = lambda t: t.transpose(1, 2).reshape(B * H, S, hd)  # noqa: E731
        want = flash_ref(tohm(q.float()) * torch.tensor(hd ** -0.5,
                                                         device=dev),
                         tohm(kr), tohm(vr), causal=True)
        want = want.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
        err = rel_err(got, want)
        out = {"arch": c.name, "n_layers": MOE_CUT_LAYERS,
               "reduced": f"depth cut from {get_config(name).n_layers} to "
                          f"{MOE_CUT_LAYERS} layers (device memory and run "
                          f"time)",
               "d_model": c.d_model, "n_heads": c.n_heads,
               "n_kv_heads": c.n_kv_heads, "hd": c.hd, "qk_norm": c.qk_norm,
               "qkv_bias": c.qkv_bias, "params": c.param_count(),
               "prompt_tokens": MOE_PROMPT, "decode_steps": MOE_STEPS,
               "prefill_s": prefill_s,
               "decode_step_mean_s": decode_s / MOE_STEPS,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches, "finite": finite,
               "layer0_attention_rel_err": err, "rel_tol": FLASH_TOL}
        if c.moe:
            out.update(n_experts=c.n_experts, top_k=c.n_experts_active,
                       moe_d_ff=c.moe_d_ff,
                       prefill_moe_drop_mean=sum(drops[:n_prefill])
                       / n_prefill,
                       decode_moe_drop_mean=sum(drops[n_prefill:])
                       / max(1, len(drops) - n_prefill))
        check(finite, f"moe {name}: logits not finite")
        check(launches["flash"] == MOE_CUT_LAYERS,
              f"moe {name}: flash launched {launches['flash']} times, "
              f"expected {MOE_CUT_LAYERS}")
        check(all(v == 0 for key, v in launches.items() if key != "flash"),
              f"moe {name}: other kernels launched {launches}")
        check(len(drops) == (MOE_CUT_LAYERS * (1 + MOE_STEPS) if c.moe
                             else 0), f"moe {name}: {len(drops)} MoE calls")
        check(err <= FLASH_TOL, f"moe {name}: layer-0 attention rel err "
              f"{err}")
        del m, toks, lg, caches, h, q, k, v, kr, vr, got, want
        torch.cuda.empty_cache()
        return out

    for part, name in (("c", "phi3.5-moe-42b-a6.6b"), ("d", "qwen3-8b"),
                       ("d", "qwen2-7b")):
        res = cut_run(name)
        moe_flash_launches += res["launches"]["flash"]
        emit({"phase": "moe", "part": part, **res})

    # (e) qwen2-moe at full width, 2 layers, batch 1 x 4096 through
    # launch.steps: two runs of 2 steps from one seed, bit for bit.
    c2 = cfg.replace(n_layers=MOE_TRAIN_LAYERS)
    tcfg = TrainConfig(peak_lr=3e-4, warmup_steps=1,
                       total_steps=MOE_TRAIN_STEPS)
    data_cfg = SyntheticConfig(vocab_size=c2.vocab_size,
                               seq_len=MOE_TRAIN_SEQ, global_batch=1,
                               seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs = []
    for _ in range(2):
        state = init_train_state(SEED, c2, tcfg, device=dev)
        step_fn = make_train_step(c2, tcfg)
        hist = []
        for s in range(MOE_TRAIN_STEPS):
            batch = batch_for_step(data_cfg, s, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            hist.append({"seconds": time.perf_counter() - t0,
                         **{key: float(m[key]) for key in (
                             "loss", "grad_norm", "lr", "moe_lb",
                             "moe_drop", "z_loss")}})
        runs.append((hist, [p.detach().clone()
                            for p in state.params.parameters()]))
        del state, step_fn, batch, m
        torch.cuda.empty_cache()
    train_launches_moe = read_counts()
    train_peak_moe = torch.cuda.max_memory_allocated()
    strip = [[{k: v for k, v in h.items() if k != "seconds"} for h in hist]
             for hist, _ in runs]
    replay = strip[0] == strip[1] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    hist = runs[0][0]
    del runs
    torch.cuda.empty_cache()
    moe_flash_launches += train_launches_moe["flash"]
    emit({"phase": "moe", "part": "e", "arch": c2.name,
          "n_layers": MOE_TRAIN_LAYERS,
          "reduced": f"depth cut from {cfg.n_layers} to {MOE_TRAIN_LAYERS} "
                     f"layers (f32 masters and AdamW of 24 layers take about "
                     f"229 GB)",
          "params": c2.param_count(), "batch": 1, "seq": MOE_TRAIN_SEQ,
          "remat": c2.remat, "steps": hist, "replay_bit_equal": replay,
          "max_memory_allocated": train_peak_moe,
          "launches": train_launches_moe})
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"moe (e): losses {[h['loss'] for h in hist]}")
    check(all(h["grad_norm"] > 0 and math.isfinite(h["grad_norm"])
              for h in hist), f"moe (e): grad norms "
          f"{[h['grad_norm'] for h in hist]}")
    check(replay, "moe (e): two runs differ")
    check(train_launches_moe["flash"] == 2 * 2 * MOE_TRAIN_LAYERS
          * MOE_TRAIN_STEPS, f"moe (e): flash launched "
          f"{train_launches_moe['flash']} times")
    check(all(v == 0 for name, v in train_launches_moe.items()
              if name != "flash"), f"moe (e): other kernels "
          f"{train_launches_moe}")

    # ------------- hybrid: jamba-v0.1-52b at full width, one pattern period
    # of 8 layers (own generators).  Phase moe freed its models above.
    gen_hy = torch.Generator(device=dev)
    gen_hy.manual_seed(SEED + 29)
    rng_hy = np.random.default_rng(SEED + 29)

    def profiled_ranges(fn, ranges) -> dict:
        """One call of ``fn`` under ``torch.profiler``: busy and idle share,
        the flash kernel's device time, and for each profiler range in
        ``ranges`` the device time and count of the kernels that start
        inside its spans on the device timeline (one stream, so a kernel
        belongs to the range whose span holds it) and its share of busy
        time; the rest is busy time outside them all.  It reads the raw
        Kineto events: parsing them into ``prof.events()`` takes tens of
        seconds at the 10^5 launches of an sLSTM prefill.  Each range also
        has its host spans (``calls``) and how many of them issued a kernel
        launch (``calls_with_launches``)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = prof.profiler.kineto_results.events()
        on_dev = [e for e in evs if e.device_type() == DeviceType.CUDA]
        kern = [(e.name(), e.start_ns(), e.duration_ns() / 1e6)
                for e in on_dev if not e.is_user_annotation()]
        busy = sum(ms for _, _, ms in kern)
        check(busy > 0, "profiled trace: no device time recorded")
        out = {"traced_wall_s": wall, "device_busy_ms": busy,
               "device_idle_share": 1 - busy / (1e3 * wall),
               "flash_ms": sum(ms for name, _, ms in kern
                               if "flash_fwd_kernel" in name)}
        inside = out["flash_ms"]
        # Kernel launches on the host timeline (the runtime calls inside a
        # range's host span), which the program issues whatever the device
        # trace keeps.
        host_launches = [e.start_ns() for e in evs
                         if e.device_type() == DeviceType.CPU
                         and "LaunchKernel" in e.name()]
        for rname in ranges:
            spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in on_dev
                     if e.is_user_annotation() and e.name() == rname]
            ks = [ms for _, t, ms in kern
                  if any(lo <= t < hi for lo, hi in spans)]
            inside += sum(ks)
            host = [(e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in evs if e.name() == rname
                    and e.device_type() == DeviceType.CPU]
            out[rname] = {"ms": sum(ks), "launches": len(ks),
                          "calls": len(host),
                          "calls_with_launches": sum(
                              1 for lo, hi in host
                              if any(lo <= t < hi for t in host_launches)),
                          "device_spans": len(spans),
                          "share_of_busy": sum(ks) / busy}
        out["rest_ms"] = busy - inside
        top = {}
        for name, _, ms in kern:
            t = top.setdefault(name[:80], [0.0, 0])
            t[0] += ms
            t[1] += 1
        out["top_kernels"] = [{"name": k, "ms": v[0], "count": v[1]}
                              for k, v in sorted(top.items(),
                                                 key=lambda r: -r[1][0])[:12]]
        return out

    # (a) jamba at full width and 8 layers through the serve phase's engine.
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=HYBRID_LAYERS)
    n_attn = len(cfg.attn_layers)
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = [rng_hy.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng_hy.integers(8, 129, HYBRID_SHORTS)]
    prompts.append(rng_hy.integers(0, cfg.vocab_size,
                                   HYBRID_LONG).astype(np.int32))
    eng = ServeEngine(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN)
    reqs = [GenerationRequest(request_id=i, prompt=p,
                              max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    tracer = Tracer()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with tracing(tracer):
        eng.run()
    torch.cuda.synchronize()
    hybrid_wall = time.perf_counter() - t0
    hybrid_launches = read_counts()
    hybrid_peak = torch.cuda.max_memory_allocated()
    long_prefill = [sp.dur for sp in tracer.spans if sp.name == "serve.prefill"
                    and sp.attrs.get("prompt_tokens") == HYBRID_LONG]
    decode_s = [sp.dur for sp in tracer.spans if sp.name == "serve.decode"]
    tokens = sum(len(r.output) for r in reqs)
    n_long = sum(len(p) > attn_mod.BLOCKWISE_THRESHOLD for p in prompts)
    statuses = [(r.status, len(r.output)) for r in reqs]
    del eng, reqs, tracer
    torch.cuda.empty_cache()
    # The long prompt once more, profiled, then a profiled batch-4 decode
    # step on the engine's shared caches.
    toks = torch.as_tensor(prompts[-1], dtype=torch.int64, device=dev)[None]
    lg, _ = prefill(model, cfg, toks, max_len=SERVE_LEN)
    nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
    finite = bool(torch.isfinite(lg).all())
    del lg
    hy_ranges = ("mamba.scan", "moe.casts", "moe.experts")
    prefill_trace = profiled_ranges(
        lambda: prefill(model, cfg, toks, max_len=SERVE_LEN), hy_ranges)
    batch = init_caches(cfg, SERVE_BATCH, SERVE_LEN, dev)
    step_toks = nxt.expand(SERVE_BATCH, 1).contiguous()
    step_pos = torch.full((SERVE_BATCH,), toks.shape[1], device=dev)
    decode_step(model, cfg, step_toks, step_pos, batch)
    decode_trace = profiled_ranges(
        lambda: decode_step(model, cfg, step_toks, step_pos, batch),
        hy_ranges)
    del batch, toks, step_toks, step_pos
    torch.cuda.empty_cache()
    emit({"phase": "hybrid", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers,
          "reduced": f"depth cut from 32 to {cfg.n_layers} layers, one "
                     f"pattern period (32 layers are 2.06e11 B in f32)",
          "pattern": [f"{k}{'+moe' if m else ''}"
                      for k, m in tr_mod.pattern(cfg)],
          "d_model": cfg.d_model, "d_inner": cfg.d_inner,
          "d_state": cfg.mamba_d_state, "n_experts": cfg.n_experts,
          "top_k": cfg.n_experts_active, "moe_d_ff": cfg.moe_d_ff,
          "params": cfg.param_count(),
          "param_numel": sum(p.numel() for p in model.parameters()),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "memory_allocated_at_start": mem_start, "init_s": init_s,
          "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, "wall_s": hybrid_wall,
          "generated_tokens": tokens, "tokens_per_s": tokens / hybrid_wall,
          "prefill_long_s": long_prefill[0] if long_prefill else None,
          "decode_steps": len(decode_s),
          "decode_step_mean_s": (sum(decode_s) / len(decode_s)
                                 if decode_s else None),
          "max_memory_allocated": hybrid_peak, "launches": hybrid_launches,
          "prefill_trace": prefill_trace, "decode_step_batch": SERVE_BATCH,
          "decode_step_trace": decode_trace, "finite": finite})
    check(all(st == "done" and n == SERVE_NEW for st, n in statuses),
          f"hybrid (a): {statuses}")
    check(hybrid_launches["flash"] == n_long * n_attn == 1,
          f"hybrid (a): flash launched {hybrid_launches['flash']} times, "
          f"expected {n_long} x {n_attn}")
    check(all(v == 0 for name, v in hybrid_launches.items()
              if name != "flash"), f"hybrid (a): other kernels launched "
          f"{hybrid_launches}")
    check(len(long_prefill) == 1, "hybrid (a): no prefill span of the long "
          "prompt")
    check(finite, "hybrid (a): logits not finite")
    # The gate reads what the program decides: one host-side mamba.scan
    # range a Mamba layer, each issuing kernel launches.  The ranges' spans
    # on the device timeline are printed beside it: the profiler has
    # dropped one of the seven there in a run while the host saw all.
    n_mamba = cfg.n_layers - n_attn
    scans = {key: {k: tr["mamba.scan"][k] for k in
                   ("calls", "calls_with_launches", "device_spans")}
             for key, tr in (("prefill", prefill_trace),
                             ("decode", decode_trace))}
    emit({"phase": "hybrid", "part": "a", "mamba_layers": n_mamba,
          "mamba_scan_ranges": scans})
    check(all(sc["calls"] == sc["calls_with_launches"] == n_mamba
              for sc in scans.values()),
          f"hybrid (a): Mamba scan ranges {scans}, expected {n_mamba} a "
          f"call, each launching kernels")
    check(prefill_trace["rest_ms"] >= 0 and decode_trace["rest_ms"] >= 0,
          "hybrid (a): the ranges' kernels exceed the busy time")

    # (b) One Mamba layer at full width on HYBRID_LONG tokens in f32, on
    # the card (twice) and on the CPU with the same weights and input.
    lcfg = cfg.replace(dtype="float32")
    layer = model.blocks[0].mixer
    x = torch.randn((1, HYBRID_LONG, cfg.d_model), generator=gen_hy,
                    device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y1 = mamba_mod.mamba_forward(layer, lcfg, x)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    y2 = mamba_mod.mamba_forward(layer, lcfg, x)
    y_bf16 = mamba_mod.mamba_forward(layer, cfg, x.to(cfg.compute_dtype))
    cpu_layer = mamba_mod.Mamba(lcfg)
    for a, b in zip(cpu_layer.parameters(), layer.parameters()):
        a.copy_(b.cpu())
    t0 = time.perf_counter()
    y_cpu = mamba_mod.mamba_forward(cpu_layer, lcfg, x.cpu())
    cpu_s = time.perf_counter() - t0
    y_err = rel_err(y1.cpu(), y_cpu)
    repeat = bool(torch.equal(y1, y2))
    emit({"phase": "hybrid", "part": "b", "arch": cfg.name, "layer": 0,
          "tokens": HYBRID_LONG, "chunk": mamba_mod.MAMBA_CHUNK,
          "compute_dtype": "float32", "y_rel_err": y_err, "tol": HYBRID_TOL,
          "card_repeat_bit_equal": repeat, "card_first_s": card_s,
          "cpu_s": cpu_s,
          "bf16_vs_f32_compute_rel_err": rel_err(y_bf16.float(), y1)})
    check(y_err <= HYBRID_TOL, f"hybrid (b): y {y_err} beyond {HYBRID_TOL}")
    check(repeat, "hybrid (b): two card calls differ")
    del layer, cpu_layer, x, y1, y2, y_bf16, y_cpu
    torch.cuda.empty_cache()

    # (c) Prefill of HYBRID_PREFIX tokens and HYBRID_STEPS teacher-forced
    # decode steps against forward over all of them (128: one chunk), in
    # f32 at a dropless MoE capacity (factor 8, as the reference's tests),
    # where neither the groups nor the chunks change the arithmetic.
    ccfg = cfg.replace(dtype="float32", moe_capacity_factor=8.0)
    n_all = HYBRID_PREFIX + HYBRID_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, n_all), generator=gen_hy,
                         device=dev)
    with torch.no_grad():
        full, aux = forward(model, ccfg, toks)
    lg, caches = prefill(model, ccfg, toks[:, :HYBRID_PREFIX], max_len=n_all)
    step_err = [rel_err(lg[:, 0], full[:, HYBRID_PREFIX - 1])]
    for i in range(HYBRID_STEPS):
        p = HYBRID_PREFIX + i
        lg, caches = decode_step(model, ccfg, toks[:, p:p + 1], p, caches)
        step_err.append(rel_err(lg[:, 0], full[:, p]))
    emit({"phase": "hybrid", "part": "c", "arch": cfg.name,
          "prefix_tokens": HYBRID_PREFIX, "decode_steps": HYBRID_STEPS,
          "compute_dtype": "float32", "moe_capacity_factor": 8.0,
          "forward_moe_drop": float(aux.dropped_fraction),
          "rel_err_by_step": step_err, "tol": HYBRID_TOL,
          "finite": bool(torch.isfinite(full).all())})
    check(float(aux.dropped_fraction) == 0.0, "hybrid (c): forward dropped "
          "pairs at capacity factor 8")
    check(max(step_err) <= HYBRID_TOL, f"hybrid (c): prefill + decode vs "
          f"forward {step_err} beyond {HYBRID_TOL}")
    del full, lg, caches, toks
    torch.cuda.empty_cache()

    # (d) A prompt over 128 tokens and not a multiple of 128: prefill
    # raises the ValueError that names the rule, and the engine fails that
    # request alone and serves the next.
    bad = rng_hy.integers(0, cfg.vocab_size, HYBRID_OFF).astype(np.int32)
    try:
        prefill(model, cfg, torch.as_tensor(bad, device=dev)[None],
                max_len=SERVE_LEN)
        refused = "nothing raised"
    except Exception as e:              # noqa: BLE001 — reported, gated
        refused = f"{type(e).__name__}: {e}"
    eng = ServeEngine(cfg, model, max_batch=1, max_len=SERVE_LEN)
    reqs = [GenerationRequest(request_id=0, prompt=bad, max_new_tokens=2),
            GenerationRequest(request_id=1, prompt=prompts[0],
                              max_new_tokens=2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    emit({"phase": "hybrid", "part": "d", "prompt_tokens": HYBRID_OFF,
          "prefill_raised": refused,
          "engine": [{"status": r.status, "error": r.error,
                      "new_tokens": len(r.output)} for r in reqs]})
    check(refused.startswith("ValueError") and "multiple" in refused,
          f"hybrid (d): prefill of {HYBRID_OFF} tokens gave {refused}")
    check(reqs[0].status == "failed" and reqs[0].error.startswith(
        "ValueError") and reqs[1].status == "done",
          f"hybrid (d): engine {[(r.status, r.error) for r in reqs]}")
    del eng, reqs, model
    torch.cuda.empty_cache()

    # -------- xlstm: xlstm-125m at full width and depth (own generators).
    # Phase hybrid freed its model above.
    gen_xl = torch.Generator(device=dev)
    gen_xl.manual_seed(SEED + 42)
    rng_xl = np.random.default_rng(SEED + 42)
    xl_ranges = ("xlstm.mlstm", "xlstm.slstm")
    t_phase = time.perf_counter()

    def serve_through_engine(cfg, model, prompts):
        """The serve phase's engine over ``prompts`` (SERVE_NEW new tokens
        each), traced: (wall s, launches, peak bytes, the longest prompt's
        prefill spans, the decode spans, [(status, tokens)], tokens)."""
        eng = ServeEngine(cfg, model, max_batch=SERVE_BATCH,
                          max_len=SERVE_LEN)
        reqs = [GenerationRequest(request_id=i, prompt=p,
                                  max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        tracer = Tracer()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with tracing(tracer):
            eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        longest = max(len(p) for p in prompts)
        return {"wall_s": wall, "launches": read_counts(),
                "peak": torch.cuda.max_memory_allocated(),
                "long_prefill": [sp.dur for sp in tracer.spans
                                 if sp.name == "serve.prefill"
                                 and sp.attrs.get("prompt_tokens")
                                 == longest],
                "decode_s": [sp.dur for sp in tracer.spans
                             if sp.name == "serve.decode"],
                "statuses": [(r.status, len(r.output)) for r in reqs],
                "tokens": sum(len(r.output) for r in reqs)}

    # (a) The engine: XLSTM_SHORTS short prompts and one of XLSTM_LONG; then
    # the long prefill and a batch-4 decode step profiled.
    cfg = get_config("xlstm-125m")
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(gen_xl, cfg, device=dev)
    prompts = [rng_xl.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng_xl.integers(14, 61, XLSTM_SHORTS)]
    prompts.append(rng_xl.integers(0, cfg.vocab_size,
                                   XLSTM_LONG).astype(np.int32))
    served = serve_through_engine(cfg, model, prompts)
    xlstm_launches = served["launches"]
    toks = torch.as_tensor(prompts[-1], dtype=torch.int64, device=dev)[None]
    lg, _ = prefill(model, cfg, toks, max_len=SERVE_LEN)
    nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
    finite = bool(torch.isfinite(lg).all())
    del lg
    prefill_trace = profiled_ranges(
        lambda: prefill(model, cfg, toks, max_len=SERVE_LEN), xl_ranges)
    batch = init_caches(cfg, SERVE_BATCH, SERVE_LEN, dev)
    step_toks = nxt.expand(SERVE_BATCH, 1).contiguous()
    step_pos = torch.full((SERVE_BATCH,), toks.shape[1], device=dev)
    decode_step(model, cfg, step_toks, step_pos, batch)
    decode_trace = profiled_ranges(
        lambda: decode_step(model, cfg, step_toks, step_pos, batch),
        xl_ranges)
    del batch, toks, step_toks, step_pos
    torch.cuda.empty_cache()
    decode_s = served["decode_s"]
    emit({"phase": "xlstm", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers, "reduced": "none (full width and depth)",
          "kinds": kinds, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "mlstm_head_dim": xlstm_mod._mlstm_dims(cfg)[2],
          "params": cfg.param_count(),
          "param_numel": sum(p.numel() for p in model.parameters()),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "memory_allocated_at_start": mem_start,
          "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, "wall_s": served["wall_s"],
          "generated_tokens": served["tokens"],
          "tokens_per_s": served["tokens"] / served["wall_s"],
          "prefill_long_s": (served["long_prefill"][0]
                             if served["long_prefill"] else None),
          "decode_steps": len(decode_s),
          "decode_step_mean_s": (sum(decode_s) / len(decode_s)
                                 if decode_s else None),
          "max_memory_allocated": served["peak"],
          "launches": xlstm_launches, "prefill_trace": prefill_trace,
          "decode_step_batch": SERVE_BATCH,
          "decode_step_trace": decode_trace, "finite": finite})
    check(all(st == "done" and n == SERVE_NEW for st, n in served["statuses"]),
          f"xlstm (a): {served['statuses']}")
    check(all(v == 0 for v in xlstm_launches.values()),
          f"xlstm (a): kernels launched {xlstm_launches}")
    check(len(served["long_prefill"]) == 1,
          "xlstm (a): no prefill span of the long prompt")
    check(finite, "xlstm (a): logits not finite")
    for key, tr in (("prefill", prefill_trace), ("decode", decode_trace)):
        # One range a layer of each kind: on the host, each issuing
        # launches, and on the device timeline.
        spans = {r: (tr[r]["calls"], tr[r]["calls_with_launches"],
                     tr[r]["device_spans"]) for r in xl_ranges}
        want = {"xlstm.mlstm": (kinds.count(MLSTM),) * 3,
                "xlstm.slstm": (kinds.count(SLSTM),) * 3}
        check(spans == want, f"xlstm (a): {key} ranges (host calls, calls "
              f"with launches, device spans) {spans}, expected {want}")
        check(tr["rest_ms"] >= 0, f"xlstm (a): {key} ranges exceed busy")

    # (b) One mLSTM and one sLSTM layer at full width on XLSTM_LAYER_TOKENS
    # tokens in f32, on the card (twice) and on the CPU with the same
    # weights and input.
    lcfg = cfg.replace(dtype="float32")
    x = torch.randn((1, XLSTM_LAYER_TOKENS, cfg.d_model), generator=gen_xl,
                    device=dev)
    layers_b = []
    for i in (kinds.index(MLSTM), kinds.index(SLSTM)):
        layer = model.blocks[i].mixer
        fwd = (xlstm_mod.mlstm_forward if kinds[i] == MLSTM
               else xlstm_mod.slstm_forward)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y1 = fwd(layer, lcfg, x)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        y2 = fwd(layer, lcfg, x)
        cpu_layer = type(layer)(lcfg)
        for a, b in zip(cpu_layer.parameters(), layer.parameters()):
            a.copy_(b.cpu())
        t0 = time.perf_counter()
        y_cpu = fwd(cpu_layer, lcfg, x.cpu())
        cpu_s = time.perf_counter() - t0
        layers_b.append({"layer": i, "kind": kinds[i],
                         "y_rel_err": rel_err(y1.cpu(), y_cpu),
                         "card_repeat_bit_equal": bool(torch.equal(y1, y2)),
                         "card_first_s": card_s, "cpu_s": cpu_s})
        del layer, cpu_layer, y1, y2, y_cpu
    emit({"phase": "xlstm", "part": "b", "arch": cfg.name,
          "tokens": XLSTM_LAYER_TOKENS, "chunk": xlstm_mod.MLSTM_CHUNK,
          "compute_dtype": "float32", "tol": XLSTM_TOL, "layers": layers_b})
    for row in layers_b:
        check(row["y_rel_err"] <= XLSTM_TOL, f"xlstm (b): {row['kind']} "
              f"y {row['y_rel_err']} beyond {XLSTM_TOL}")
        check(row["card_repeat_bit_equal"],
              f"xlstm (b): {row['kind']}: two card calls differ")
    del x
    torch.cuda.empty_cache()

    # (c) Prefill of XLSTM_PREFIX tokens (one chunk) and XLSTM_STEPS
    # teacher-forced decode steps against forward over all of them (two
    # chunks), in f32.
    n_all = XLSTM_PREFIX + XLSTM_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, n_all), generator=gen_xl,
                         device=dev)
    with torch.no_grad():
        full, _ = forward(model, lcfg, toks)
    lg, caches = prefill(model, lcfg, toks[:, :XLSTM_PREFIX], max_len=n_all)
    step_err = [rel_err(lg[:, 0], full[:, XLSTM_PREFIX - 1])]
    for i in range(XLSTM_STEPS):
        p = XLSTM_PREFIX + i
        lg, caches = decode_step(model, lcfg, toks[:, p:p + 1], p, caches)
        step_err.append(rel_err(lg[:, 0], full[:, p]))
    emit({"phase": "xlstm", "part": "c", "arch": cfg.name,
          "prefix_tokens": XLSTM_PREFIX, "decode_steps": XLSTM_STEPS,
          "compute_dtype": "float32", "max_rel_err": max(step_err),
          "rel_err_last": step_err[-1], "tol": XLSTM_TOL,
          "finite": bool(torch.isfinite(full).all())})
    check(max(step_err) <= XLSTM_TOL, f"xlstm (c): prefill + decode vs "
          f"forward {max(step_err)} beyond {XLSTM_TOL}")
    del full, lg, caches, toks
    torch.cuda.empty_cache()

    # (d) A prompt over 64 tokens and not a multiple of 64: prefill raises
    # the ValueError that names the rule; the engine fails that request
    # alone and serves the next.
    bad = rng_xl.integers(0, cfg.vocab_size, XLSTM_OFF).astype(np.int32)
    try:
        prefill(model, cfg, torch.as_tensor(bad, device=dev)[None],
                max_len=SERVE_LEN)
        refused = "nothing raised"
    except Exception as e:              # noqa: BLE001 — reported, gated
        refused = f"{type(e).__name__}: {e}"
    eng = ServeEngine(cfg, model, max_batch=1, max_len=SERVE_LEN)
    reqs = [GenerationRequest(request_id=0, prompt=bad, max_new_tokens=2),
            GenerationRequest(request_id=1, prompt=prompts[0],
                              max_new_tokens=2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    emit({"phase": "xlstm", "part": "d", "prompt_tokens": XLSTM_OFF,
          "prefill_raised": refused,
          "engine": [{"status": r.status, "error": r.error,
                      "new_tokens": len(r.output)} for r in reqs],
          "phase_s": time.perf_counter() - t_phase})
    check(refused.startswith("ValueError") and "multiple" in refused,
          f"xlstm (d): prefill of {XLSTM_OFF} tokens gave {refused}")
    check(reqs[0].status == "failed" and reqs[0].error.startswith(
        "ValueError") and reqs[1].status == "done",
          f"xlstm (d): engine {[(r.status, r.error) for r in reqs]}")
    del eng, reqs, model
    torch.cuda.empty_cache()

    # -------- encdec: whisper-tiny at full width and depth (own generator).
    gen_ed = torch.Generator(device=dev)
    gen_ed.manual_seed(SEED + 43)
    t_phase = time.perf_counter()
    cfg = get_config("whisper-tiny")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(gen_ed, cfg, device=dev)

    # (a) A prefill of ENCDEC_BATCH x ENCDEC_PROMPT tokens with 1500
    # frames, then ENCDEC_STEPS greedy decode steps, each timed.
    frames = torch.randn((ENCDEC_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                         generator=gen_ed, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT),
                         generator=gen_ed, device=dev)
    max_len = ENCDEC_PROMPT + ENCDEC_STEPS
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lg, caches = prefill(model, cfg, toks, max_len=max_len, frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_s, finite = [], bool(torch.isfinite(lg).all())
    for i in range(ENCDEC_STEPS):
        nxt = torch.argmax(lg[:, -1], dim=-1)[:, None]
        t0 = time.perf_counter()
        lg, caches = decode_step(model, cfg, nxt, ENCDEC_PROMPT + i, caches)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(lg).all())
    encdec_launches = read_counts()
    emit({"phase": "encdec", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers, "n_encoder_layers": cfg.n_encoder_layers,
          "reduced": "none (full width and depth)",
          "frames": cfg.n_frontend_tokens, "d_model": cfg.d_model,
          "params": cfg.param_count(),
          "param_numel": sum(p.numel() for p in model.parameters()),
          "compute_dtype": cfg.dtype, "batch": ENCDEC_BATCH,
          "prompt_tokens": ENCDEC_PROMPT, "prefill_s": prefill_s,
          "decode_steps": ENCDEC_STEPS, "decode_step_s": step_s,
          "decode_step_mean_s": sum(step_s) / len(step_s),
          "decode_step_mean_s_after_first": (sum(step_s[1:])
                                             / (len(step_s) - 1)),
          "tokens_per_s": ENCDEC_BATCH * ENCDEC_STEPS / sum(step_s),
          "cross_cache_shape": list(caches["cross"][0][0].shape),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": encdec_launches, "finite": finite})
    check(finite, "encdec (a): logits not finite")
    check(all(v == 0 for v in encdec_launches.values()),
          f"encdec (a): kernels launched {encdec_launches}")
    del lg, caches, toks

    # (b) The same prefill and ENCDEC_CHECK teacher-forced decode steps in
    # f32, card against CPU (the same weights and frames), and decode
    # against forward over the same tokens on the card.
    ccfg = cfg.replace(dtype="float32")
    n_all = ENCDEC_PROMPT + ENCDEC_CHECK
    toks = torch.randint(0, cfg.vocab_size, (ENCDEC_BATCH, n_all),
                         generator=gen_ed, device=dev)
    cpu_model = params_from_jax(params_to_numpy(model), ccfg, device="cpu")

    def encdec_steps(m, t, f):
        lg, caches = prefill(m, ccfg, t[:, :ENCDEC_PROMPT], max_len=n_all,
                             frames=f)
        out = [lg[:, 0]]
        for i in range(ENCDEC_CHECK):
            p = ENCDEC_PROMPT + i
            lg, caches = decode_step(m, ccfg, t[:, p:p + 1], p, caches)
            out.append(lg[:, 0])
        return torch.stack(out, 1)

    card = encdec_steps(model, toks, frames)
    t0 = time.perf_counter()
    cpu = encdec_steps(cpu_model, toks.cpu(), frames.cpu())
    cpu_s = time.perf_counter() - t0
    with torch.no_grad():
        full, _ = forward(model, ccfg, toks, frames=frames)
    cpu_err = rel_err(card.cpu(), cpu)
    fwd_err = max(rel_err(card[:, i], full[:, ENCDEC_PROMPT - 1 + i])
                  for i in range(ENCDEC_CHECK + 1))
    emit({"phase": "encdec", "part": "b", "compute_dtype": "float32",
          "prefix_tokens": ENCDEC_PROMPT, "decode_steps": ENCDEC_CHECK,
          "card_vs_cpu_rel_err": cpu_err, "decode_vs_forward_rel_err":
          fwd_err, "tol": ENCDEC_TOL, "cpu_s": cpu_s})
    check(cpu_err <= ENCDEC_TOL, f"encdec (b): card vs CPU {cpu_err} beyond "
          f"{ENCDEC_TOL}")
    check(fwd_err <= ENCDEC_TOL, f"encdec (b): decode vs forward {fwd_err} "
          f"beyond {ENCDEC_TOL}")
    del cpu_model, card, cpu, full, toks

    # (c) The engine refuses an encoder-decoder when it is built.
    try:
        ServeEngine(cfg, model, max_batch=SERVE_BATCH, max_len=SERVE_LEN)
        refused = "nothing raised"
    except Exception as e:              # noqa: BLE001 — reported, gated
        refused = f"{type(e).__name__}: {e}"
    emit({"phase": "encdec", "part": "c", "engine_raised": refused,
          "phase_s": time.perf_counter() - t_phase})
    check(refused.startswith("ValueError") and "encoder-decoder" in refused,
          f"encdec (c): the engine gave {refused}")
    del model, frames
    torch.cuda.empty_cache()

    # -------- vlm: qwen2-vl-2b at full width and depth (own generators).
    gen_vl = torch.Generator(device=dev)
    gen_vl.manual_seed(SEED + 44)
    rng_vl = np.random.default_rng(SEED + 44)
    t_phase = time.perf_counter()

    # (a) The engine: VLM_SHORTS prompts of at most 128 tokens and one of
    # VLM_LONG (flash once a layer); the long prefill profiled.
    cfg = get_config("qwen2-vl-2b")
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(gen_vl, cfg, device=dev)
    prompts = [rng_vl.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng_vl.integers(8, 129, VLM_SHORTS)]
    prompts.append(rng_vl.integers(0, cfg.vocab_size,
                                   VLM_LONG).astype(np.int32))
    served = serve_through_engine(cfg, model, prompts)
    vlm_launches = served["launches"]
    n_long = sum(len(p) > attn_mod.BLOCKWISE_THRESHOLD for p in prompts)
    toks = torch.as_tensor(prompts[-1], dtype=torch.int64, device=dev)[None]
    prefill(model, cfg, toks, max_len=SERVE_LEN)
    prefill_trace = profiled_ranges(
        lambda: prefill(model, cfg, toks, max_len=SERVE_LEN), ())
    del toks
    decode_s = served["decode_s"]
    emit({"phase": "vlm", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers, "reduced": "none (full width and depth)",
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "hd": cfg.hd,
          "mrope_sections": list(cfg.mrope_sections),
          "params": cfg.param_count(),
          "param_numel": sum(p.numel() for p in model.parameters()),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
          "memory_allocated_at_start": mem_start,
          "max_batch": SERVE_BATCH, "max_len": SERVE_LEN,
          "prompt_tokens": [len(p) for p in prompts],
          "new_tokens": SERVE_NEW, "wall_s": served["wall_s"],
          "generated_tokens": served["tokens"],
          "tokens_per_s": served["tokens"] / served["wall_s"],
          "prefill_long_s": (served["long_prefill"][0]
                             if served["long_prefill"] else None),
          "decode_steps": len(decode_s),
          "decode_step_mean_s": (sum(decode_s) / len(decode_s)
                                 if decode_s else None),
          "max_memory_allocated": served["peak"],
          "launches": vlm_launches, "prefill_trace": prefill_trace})
    check(all(st == "done" and n == SERVE_NEW for st, n in served["statuses"]),
          f"vlm (a): {served['statuses']}")
    check(vlm_launches["flash"] == n_long * cfg.n_layers == cfg.n_layers,
          f"vlm (a): flash launched {vlm_launches['flash']} times, expected "
          f"{n_long} x {cfg.n_layers}")
    check(all(v == 0 for name, v in vlm_launches.items() if name != "flash"),
          f"vlm (a): other kernels launched {vlm_launches}")
    check(len(served["long_prefill"]) == 1,
          "vlm (a): no prefill span of the long prompt")
    check(prefill_trace["flash_ms"] > 0 and prefill_trace["rest_ms"] >= 0,
          f"vlm (a): prefill trace {prefill_trace['flash_ms']}, "
          f"{prefill_trace['rest_ms']}")
    del model
    torch.cuda.empty_cache()

    # (b) At VLM_CHECK_LAYERS layers in f32: forward with patch embeddings
    # on an image grid before the text and distinct (t, h, w) ids, card
    # against CPU; the text M-RoPE tables against plain RoPE's, on the card.
    scfg = cfg.replace(n_layers=VLM_CHECK_LAYERS, dtype="float32")
    small = init_params(gen_vl, scfg, device=dev)
    gh, gw = VLM_GRID
    n_img = gh * gw
    n_txt = n_img
    hh, ww = np.divmod(np.arange(n_img), gw)
    txt = max(gh, gw) + np.arange(n_txt)
    pos = torch.as_tensor(np.stack([
        np.concatenate([np.zeros(n_img, int), txt]),
        np.concatenate([hh, txt]), np.concatenate([ww, txt])])[:, None],
        dtype=torch.int64, device=dev)                     # (3, 1, S)
    toks = torch.randint(0, cfg.vocab_size, (1, n_img + n_txt),
                         generator=gen_vl, device=dev)
    patches = torch.zeros((1, n_img + n_txt, cfg.d_model), device=dev)
    patches[:, :n_img] = torch.randn((1, n_img, cfg.d_model),
                                     generator=gen_vl, device=dev)
    with torch.no_grad():
        card, _ = forward(small, scfg, toks, positions=pos, patches=patches)
        cpu_small = params_from_jax(params_to_numpy(small), scfg,
                                    device="cpu")
        cpu, _ = forward(cpu_small, scfg, toks.cpu(), positions=pos.cpu(),
                         patches=patches.cpu())
    vlm_err = rel_err(card.cpu(), cpu)
    p3 = text_mrope_positions(1, VLM_LONG, device=dev)
    c3, s3 = mrope_cos_sin(p3, cfg.hd, cfg.rope_theta, cfg.mrope_sections)
    c1, s1 = rope_cos_sin(text_positions(1, VLM_LONG, device=dev), cfg.hd,
                          cfg.rope_theta)
    tables_equal = bool(torch.equal(c3, c1) and torch.equal(s3, s1))
    emit({"phase": "vlm", "part": "b", "n_layers": VLM_CHECK_LAYERS,
          "compute_dtype": "float32", "image_grid": list(VLM_GRID),
          "text_tokens": n_txt, "rel_err": vlm_err, "tol": VLM_TOL,
          "text_mrope_equals_rope_tokens": VLM_LONG,
          "text_mrope_equals_rope": tables_equal,
          "finite": bool(torch.isfinite(card).all()),
          "phase_s": time.perf_counter() - t_phase})
    check(vlm_err <= VLM_TOL, f"vlm (b): card vs CPU {vlm_err} beyond "
          f"{VLM_TOL}")
    check(tables_equal, "vlm (b): text M-RoPE tables differ from RoPE's")
    del small, cpu_small, card, cpu, toks, patches, pos, c3, s3, c1, s1
    torch.cuda.empty_cache()

    # ---------- analysis: python -m repro_torch.analysis's run on the card
    # run_all: the dataflow entries on a one-rank NCCL group, the kernel
    # contracts held to the C side, the lint, the controls (big_copy's
    # refusal and its launch at a fitting shape among them).  0 new
    # findings against the empty baseline.
    reset_counts()
    t0 = time.perf_counter()
    with bench_error.one_rank_group(dev):
        report = run_all(device=dev)
    torch.cuda.synchronize()
    analysis_s = time.perf_counter() - t0
    analysis_launches = read_counts()
    new, suppressed, stale = diff_against_baseline(report, load_baseline())
    # Each production kernel's launches at its contract's example shape
    # (cgs: panel_deflate, then project_out's two f64 launches), and
    # panel_coeff, panel_apply and the f32 launches of sketch_accum and
    # project_out at their package's, panel_deflate (f64, resident,
    # re-reading, 16 columns) and flash (granite's prefill) at the main
    # path's shapes, held to the C side; big_copy's at its 64 MiB example.
    f32 = torch.float32
    geometry = {name: geometry_report(pkg) for name, pkg in (
        ("sketch_accum", "sketch_accum"), ("panel_step", "panel_step"),
        ("panel_gram", "panel_gram"), ("cgs", "cgs"),
        ("sketch_matmul", "sketch_matmul"), ("fwht", "srht"),
        ("tsolve", "tsolve"), ("flash", "flash"))}
    lib = _build.load_library()
    for name, launches in (
            ("panel_coeff", coeff_launches(f32, 256, 32, 4096)),
            ("panel_coeff(f64, main)", coeff_launches(
                torch.float64, 2 * MAIN_K, PANEL, MAIN_N)),
            ("panel_apply", (apply_launch(f32, 256, 32, 4096),)),
            ("panel_apply(f64, main)", (apply_launch(
                torch.float64, 2 * MAIN_K, PANEL, MAIN_N),)),
            ("panel_apply(f64, 4-rank shard)", (apply_launch(
                torch.float64, 2 * MAIN_K, PANEL, MAIN_N // 4),)),
            ("tsolve(f64, main)", (tsolve_launch(
                torch.float64, MAIN_K, MAIN_N),)),
            ("tsolve(f64, re-reading)", (tsolve_launch(
                torch.float64, 1000, MAIN_N),)),
            ("sketch_accum(f32)", (sketch_accum_launch(f32, 96, 1024, 512),)),
            ("project_out(f32)", project_out_launch(f32, 256, 400, 4096)),
            ("sketch_matmul(f32)", (sketch_matmul_launch(f32, 128, 1024,
                                                         512),)),
            ("panel_gram(c128, b=64)", (panel_gram_launch(
                torch.complex128, 256, 64, 4096),)),
            ("panel_deflate(f64, main)", (panel_deflate_launch(
                torch.float64, 2 * MAIN_K, PANEL, MAIN_N),)),
            ("panel_deflate(f64, re-reading)", (panel_deflate_launch(
                torch.float64, 4000, PANEL, 2000),)),
            ("panel_deflate(f64, 16 columns)", (panel_deflate_launch(
                torch.float64, 1200, PANEL, MAIN_N),)),
            ("flash(granite prefill)", (flash_launch(
                f32, torch.bfloat16, 32, SERVE_LONG[-1], SERVE_LONG[-1],
                64),)),
            ("panel_step(f64, main)", step_launches(
                torch.float64, 2 * MAIN_K, PANEL, MAIN_N)),
            ("panel_step(c128, main)", step_launches(
                torch.complex128, 2 * MAIN_K, PANEL, MAIN_N)),
            ("panel_step(f64, b=64)", step_launches(
                torch.float64, 2 * MAIN_K, 2 * PANEL, MAIN_N)),
            ("panel_step(f64, re-reading)", step_launches(
                torch.float64, 4000, PANEL, 2000)),
            ("panel_step(f32, 4-rank shard)", step_launches(
                f32, 2 * MAIN_K, PANEL, MAIN_N // 4)),
            ("fwht(f64, main)", tuple(
                fwht_pass_launch(torch.float64, MAIN_M, MAIN_N, f,
                                 1 << sum(fwht_factors(MAIN_M)[:i]),
                                 1.0 / math.sqrt(MAIN_M)
                                 if i == len(fwht_factors(MAIN_M)) - 1
                                 else 1.0)
                for i, f in enumerate(fwht_factors(MAIN_M)))),
            ("fwht(f64, 2^18 x 24)", tuple(
                fwht_pass_launch(torch.float64, 2 ** 18, 24, f,
                                 1 << sum(fwht_factors(2 ** 18)[:i]), 1.0)
                for i, f in enumerate(fwht_factors(2 ** 18))))):
        geometry[name] = [hold_launch(ln, lib, SMEM_BUDGET_BYTES)
                          for ln in launches]
    geometry["big_copy"] = [hold_launch(ln, copy_library(),
                                        COPY_CONTRACT.smem_budget)
                            for ln in COPY_CONTRACT.example().launches]
    emit({"phase": "analysis", "call": "run_all(device='cuda')",
          "seconds": analysis_s, "passes": report.passes_run,
          "subjects": {k: len(v) for k, v in report.subjects.items()},
          "findings": [[f.rule, f.subject, f.key, f.severity]
                       for f in report.findings],
          "new": [[f.rule, f.subject, f.key, f.message] for f in new],
          "launches": analysis_launches,
          "geometry": {name: [{key: row[key] for key in (
              "kernel", "grid", "threads", "declared_smem", "c_smem",
              "static_smem", "registers", "spills", "budget", "equal")}
              for row in rows] for name, rows in geometry.items()}})
    check(not new and not suppressed,
          f"analysis: new findings {[(f.rule, f.subject, f.key) for f in new]}")
    check(report.passes_run == ["dataflow", "kernels", "lint", "controls"]
          and tuple(report.subjects["controls"]) == tuple(sorted(CONTROLS)),
          f"analysis: passes {report.passes_run}")
    check(len(geometry) == 31 and all(
        row["equal"] for rows in geometry.values() for row in rows),
        "analysis: a declared launch differs from the C side")
    check(all(row["c_smem"] + row["static_smem"] <= SMEM_BUDGET_BYTES
              for name, rows in geometry.items() if name != "big_copy"
              for row in rows), "analysis: a production launch over budget")
    check(geometry["big_copy"][0]["c_smem"] == 4096 * 4096 * 4
          > SMEM_BUDGET_BYTES, "analysis: big_copy's example not over budget")
    check(analysis_launches["big_copy"] >= 1,
          "analysis: big_copy was not launched on the analysis path")
    # big_copy against its plain version (the identity), bit for bit, at
    # shapes inside one block's shared memory: f32 (4 CTAs) and c128
    # (ragged last block); the example refused as a status; sketch_accum
    # right after the refusal, held to its plain version.
    copy_cases = []
    for shape, dtype, bn in (((48, 1024), torch.float32, 256),
                             ((32, 448), torch.complex128, 128)):
        x = randn(shape, dtype)
        got = big_copy(x, bn=bn)
        torch.cuda.synchronize()
        copy_cases.append({"shape": list(shape), "dtype": dname(dtype),
                           "bn": bn, "smem": x.numel() * x.element_size(),
                           "bit_equal": bool(torch.equal(got,
                                                         big_copy_ref(x)))})
    x = torch.zeros((4096, 4096), dtype=torch.float32, device=dev)
    try:
        big_copy(x, bn=2048)
        torch.cuda.synchronize()
        refusal = None
    except RuntimeError as exc:
        refusal = str(exc)
    del x
    xa, aa = randn((96, 1024), torch.float64), randn((1024, 512),
                                                      torch.float64)
    acc0 = torch.zeros((96, 512), dtype=torch.float64, device=dev)
    after_err = rel_err(sketch_accum(xa, aa), sketch_accum_ref(xa, aa, acc0))
    emit({"phase": "analysis", "check": "big_copy", "cases": copy_cases,
          "example_refused": refusal,
          "sketch_accum_after_refusal_rel_err": after_err,
          "rel_tol": REL_TOL["float64"]})
    check(all(c["bit_equal"] for c in copy_cases),
          "analysis: big_copy differs from big_copy_ref")
    check(refusal is not None, "analysis: big_copy's 64 MiB example launched")
    check(after_err <= REL_TOL["float64"],
          f"analysis: sketch_accum after the refusal rel err {after_err}")
    del xa, aa, acc0
    torch.cuda.empty_cache()

    # ------------------------------------ 8. times at the main path shapes
    dtype, esize = torch.float64, 8
    l, m, n, b = 2 * MAIN_K, MAIN_M, MAIN_N, PANEL

    def sm_clock() -> str:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                 "clocks_throttle_reasons.active", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            return out.stdout.strip()
        except (OSError, subprocess.TimeoutExpired):
            return "unknown"

    def readings(fn, kernels: int, reps: int = 20) -> dict:
        """``fn`` (``kernels`` launches a call) timed three ways here:
        ``cuda_ms`` (one round of ``reps`` calls), ``bench_dmma``'s (the
        least of two rounds), and under ``torch.profiler``: ten calls in a
        warmup cycle, then ``reps + 10`` calls in the active cycle, of
        which the last ``reps * kernels`` device events count: their time
        a call, and the device span a call (the first one's start to the
        last one's end), whose excess is gaps between kernels;
        ``cuda_ms`` once more after the trace; the SM clock, power draw and
        throttle reasons before and after.  A session's first events are
        not reliable: without a warmup cycle it loses its first device
        event once the process has traced a training step
        (``benchmarks.profiler_probe``; eleven events in one run), and the
        active cycle's start can gain the warmup's last event or lose its
        own first; the warmup cycle and the ten calls of margin keep the
        readings independent of the order of the phases."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule
        clock_before = sm_clock()
        smoke_ms = cuda_ms(fn, reps)
        bench_ms = bench_cuda_ms(fn, reps)
        traced = []

        def keep(prof):
            # Kernels only: the cycle's ProfilerStep range also shows as a
            # device span.
            traced.extend(sorted(
                (e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")))

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=keep) as prof:
            for n_calls in (10, reps + 10):
                for _ in range(n_calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        spans = traced
        check(len(spans) >= reps * kernels,
              f"times: the trace recorded {len(spans)} device events")
        spans = spans[-reps * kernels:]
        busy_ms = sum(b - a for a, b in spans) / 1e3 / reps
        span_ms = (max(b for _, b in spans) - spans[0][0]) / 1e3 / reps
        return {"smoke_cuda_ms": smoke_ms, "bench_cuda_ms": bench_ms,
                "trace_device_ms_per_call": busy_ms,
                "trace_span_ms_per_call": span_ms,
                "trace_gap_ms_per_call": span_ms - busy_ms,
                "smoke_cuda_ms_after_trace": cuda_ms(fn, reps),
                "sm_clock_before": clock_before, "sm_clock_after": sm_clock()}

    def timed(name, source, replaces, launches, err, fn, plain, library,
              flops, nbytes, shape, reps=20, plain_reps=5, three_ways=0,
              **extra):
        """The kernels-line entry of one kernel, timed at ``shape``, with
        its bound from ``flops`` and ``nbytes``; also emitted as a phase
        line with ``extra``.  ``three_ways``, the kernels a call if given:
        ``ms`` is the first of three rounds of ``cuda_ms`` (all three
        kept), then ``readings``."""
        t_flop, t_byte = flops / PEAK_F64_FLOPS, nbytes / HBM_BYTES_PER_S
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = 1e3 * (time.perf_counter() - t0) / reps
        rounds_ms = [cuda_ms(fn, reps) for _ in range(3 if three_ways
                                                      else 1)]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": rounds_ms[0],
               "plain_ms": cuda_ms(plain, plain_reps),
               "bound_ms": 1e3 * max(t_flop, t_byte),
               "bound_by": "operations" if t_flop >= t_byte else "bytes",
               "library_ms": cuda_ms(library, reps) if library else None}
        if three_ways:
            extra["readings"] = {"first_rounds_ms": rounds_ms,
                                 **readings(fn, three_ways, reps)}
        emit({"phase": "times", "kernel": name, "dtype": "float64", **shape,
              "flops": flops, "bytes": nbytes, "peak": PEAK_NAME, **extra,
              **{key: row[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")},
              "enqueue_ms": enqueue_ms,
              "tflops": flops / row["ms"] / 1e9,
              "library_tflops": (flops / row["library_ms"] / 1e9
                                 if row["library_ms"] else None),
              "bound_over_ms": row["bound_ms"] / row["ms"]})
        return row

    # The five ID kernels' bounds (ops, bytes) are scaling_worker's, which
    # also counts them on the fake backend: each input read once, each
    # output written once.
    from repro_torch.benchmarks.scaling_worker import KERNEL_COSTS

    def kernel_bound(name, *args, **kwargs):
        return KERNEL_COSTS[name][0](*args, **kwargs)

    x, a = randn((l, m), dtype), randn((m, n), dtype)
    acc = torch.zeros((l, n), dtype=dtype, device=dev)
    accum = timed(
        "sketch_accum", "src/repro_torch/csrc/sketch_accum.cu",
        "src/repro/kernels/sketch_accum/kernel.py:52",
        main_launches["sketch_accum"], accum_err_f64,
        lambda: sketch_accum(x, a, acc), lambda: sketch_accum_ref(x, a, acc),
        lambda: torch.addmm(acc, x, a),
        *kernel_bound("sketch_accum", x, a, acc),
        {"l": l, "m": m, "n": n}, reps=3, plain_reps=3)
    del x, a, acc
    torch.cuda.empty_cache()

    c, z = randn((l, b), dtype), randn((l, n), dtype)
    shape = {"l": l, "b": b, "n": n}
    pstep = timed(
        "panel_step", "src/repro_torch/csrc/panel_step.cu",
        "src/repro/kernels/panel_step/kernel.py:147",
        main_launches["panel_step"], panel_err_f64,
        lambda: panel_step(c, z, emit_w=False), lambda: panel_step_ref(c, z),
        None, *kernel_bound("panel_step", c, z), shape, three_ways=3)
    r2in = colnorms2(z)
    coeff = timed(
        "panel_coeff", "src/repro_torch/csrc/panel_step.cu",
        "src/repro/kernels/panel_step/kernel.py:202",
        dist_launches["panel_coeff"], split_err_f64["panel_coeff"],
        lambda: panel_coeff(c, z, r2in), lambda: panel_coeff_ref(c, z, r2in),
        None, *kernel_bound("panel_coeff", c, z, r2in), shape, three_ways=2)
    qp, w, _ = panel_coeff(c, z, r2in)
    apply_norms_ms = cuda_ms(lambda: panel_apply(qp, w, z, emit_norms=True), 20)
    apply = timed(
        "panel_apply", "src/repro_torch/csrc/panel_apply.cu",
        "src/repro/kernels/panel_step/kernel.py:257",
        dist_launches["panel_apply"], split_err_f64["panel_apply"],
        lambda: panel_apply(qp, w, z), lambda: panel_apply_ref(qp, w, z),
        lambda: torch.addmm(z, qp, w, alpha=-1),
        *kernel_bound("panel_apply", qp, w, z), shape,
        emit_norms_ms=apply_norms_ms,
        emit_norms_bound_ms=1e3 * kernel_bound(
            "panel_apply", qp, w, z, emit_norms=True)[1] / HBM_BYTES_PER_S,
        launches_emit_norms=dist_launches["panel_apply(emit_norms)"])
    z0 = z[:, :0]
    gram = timed(
        "panel_gram", "src/repro_torch/csrc/panel_gram.cu",
        "src/repro/kernels/panel_gram/kernel.py:43",
        gram_launches["panel_gram"], split_err_f64["panel_gram"],
        lambda: panel_gram(c, z), lambda: panel_gram_ref(c, z),
        lambda: c.mH @ torch.cat([c, z], 1),
        *kernel_bound("panel_gram", c, z), shape,
        gram_alone_ms=cuda_ms(lambda: panel_gram(c, z0), 20),
        gram_alone_library_ms=cuda_ms(lambda: c.mH @ c, 20))
    del c, z, z0, qp, w, r2in
    torch.cuda.empty_cache()

    # The kernels of the phase benchmarks; launches from the bench phase.
    omega, a = randn((l, m), dtype), randn((m, n), dtype)
    matmul = timed(
        "sketch_matmul", "src/repro_torch/csrc/sketch_matmul.cu",
        "src/repro/kernels/sketch_matmul/kernel.py:41",
        bench_launches["sketch_matmul"], bench_err_f64["sketch_matmul"],
        lambda: sketch_matmul(omega, a), lambda: sketch_matmul_ref(omega, a),
        lambda: torch.matmul(omega, a), 2.0 * l * m * n,
        esize * (l * m + m * n + l * n), {"l": l, "m": m, "n": n},
        reps=3, plain_reps=3)
    matmul.update(cuda_kernel="sketch_matmul_dmma_kernel",
                  launches_per_call=1)
    del omega
    # m n log2(m) butterfly adds and m n scale multiplies; x read once,
    # the result written once (the split's extra sweep is not counted).
    hadamard = timed(
        "fwht", "src/repro_torch/csrc/fwht.cu",
        "src/repro/kernels/srht/kernel.py:46",
        bench_launches["fwht"], bench_err_f64["fwht"],
        lambda: fwht(a), lambda: fwht_ref(a), None,
        m * n * (math.log2(m) + 1.0), esize * 2 * m * n, {"m": m, "n": n},
        reps=5, plain_reps=3, factors_log2=fwht_factors(m))
    del a
    torch.cuda.empty_cache()
    R1, R = tsolve_main_f64
    kk = R1.shape[0]
    # k^2 n (k(k+1)/2 n multiply-adds); R1 and R2 read, T written.
    trisolve = timed(
        "tsolve", "src/repro_torch/csrc/tsolve.cu",
        "src/repro/kernels/tsolve/kernel.py:62",
        bench_launches["tsolve"], bench_err_f64["tsolve"],
        lambda: tsolve(R1, R), lambda: tsolve_ref(R1, R),
        lambda: torch.linalg.solve_triangular(R1, R, upper=True),
        1.0 * kk * kk * n, esize * (kk * kk + 2 * kk * n), {"k": kk, "n": n},
        plain_reps=3, three_ways=1)
    del R1, R, tsolve_main_f64

    # The CGS kernels of Table 3 at phase 2's shapes; launches from the
    # bench phase's Table 3 run.  The library pair is two DGEMMs.
    q = torch.linalg.qr(randn((l, MAIN_K), dtype)).Q.contiguous()
    qp = q[:, :b].contiguous()
    z = randn((l, n), dtype)

    def library_pair(basis):
        def pair():
            w = basis.mH @ z
            return torch.addmm(z, basis, w, alpha=-1)
        return pair

    # W and O (2 l k n each); bytes: Q, Z in, O out (the k x n workspace
    # is the kernel's own traffic, not the function's).
    proj = timed(
        "project_out", "src/repro_torch/csrc/cgs.cu",
        "src/repro/kernels/cgs/kernel.py:45",
        qr_launches["project_out"], bench_err_f64["project_out"],
        lambda: project_out(q, z), lambda: project_out_ref(q, z),
        library_pair(q), 4.0 * l * MAIN_K * n,
        esize * (l * MAIN_K + 2 * l * n), {"l": l, "k": MAIN_K, "n": n})
    # LAUNCHES counts calls; each call launches W = Q^H Z, then O = Z - Q W.
    proj["launches_per_call"] = 2
    # W and O (2 l b n each); bytes: Q_p, Z in, O, W out.
    deflate = timed(
        "panel_deflate", "src/repro_torch/csrc/panel_deflate.cu",
        "src/repro/kernels/cgs/kernel.py:74",
        qr_launches["panel_deflate"], bench_err_f64["panel_deflate"],
        lambda: panel_deflate(qp, z), lambda: panel_deflate_ref(qp, z),
        library_pair(qp), 4.0 * l * b * n,
        esize * (l * b + 2 * l * n + b * n), shape,
        slab_cols=deflate_geometry(dtype, l, b)[0])
    del q, qp, z
    torch.cuda.empty_cache()

    # flash at granite's serve shape (the 4000-token prefill: 32 heads, hd
    # 64, causal, q f32 and k/v bf16 as the model passes them); launches
    # from the serve and train phases.  Operations: 4 hd per live (q, k) pair (q k^T
    # and p v), each product two TF32 passes on the tensor cores (q split
    # into hi and lo, bf16 k and v exact); bytes: q, k, v read once, o
    # written once.  The library call is scaled_dot_product_attention on
    # the same inputs in f32 (one dtype), with q already scaled.
    bh, S, hd = 32, SERVE_LONG[-1], 64
    q = randn((bh, S, hd), torch.float32) * hd ** -0.5
    k = randn((bh, S, hd), torch.float32).to(torch.bfloat16)
    v = randn((bh, S, hd), torch.float32).to(torch.bfloat16)
    k4, v4 = (x.float()[None] for x in (k, v))
    pairs = bh * live_pairs(S, S, True, None)
    flash_flops = 4.0 * hd * pairs
    flash_bytes = bh * S * hd * (4 + 2 + 2 + 4)
    t_flop = 2 * flash_flops / PEAK_TF32_FLOPS
    t_byte = flash_bytes / HBM_BYTES_PER_S
    flash = {"name": "flash", "route": "cuda",
             "source": "src/repro_torch/csrc/flash.cu",
             "replaces": "src/repro/kernels/flash/kernel.py:86",
             "launches": serve_launches["flash"], "max_abs_err": flash_err,
             "ms": cuda_ms(lambda: flash_attention_kernel(q, k, v), 20),
             "plain_ms": cuda_ms(lambda: flash_ref(q, k, v), 3),
             "bound_ms": 1e3 * max(t_flop, t_byte),
             "bound_by": "operations" if t_flop >= t_byte else "bytes",
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 q[None], k4, v4, is_causal=True, scale=1.0), 20)}
    emit({"phase": "times", "kernel": "flash", "bh": bh, "s": S, "t": S,
          "hd": hd, "causal": True, "q_dtype": "float32",
          "kv_dtype": "bfloat16", "live_pairs": pairs, "flops": flash_flops,
          "bytes": flash_bytes, "peak": "TF32 tensor 495 TFLOP/s, 2 passes",
          "ffma_bound_ms": 1e3 * max(flash_flops / PEAK_F32_FLOPS, t_byte),
          "bf16_tensor_bound_ms": 1e3 * max(flash_flops / PEAK_BF16_FLOPS,
                                            t_byte),
          "tflops": flash_flops / flash["ms"] / 1e9,
          **{key: flash[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}})
    del q, k, v, k4, v4
    torch.cuda.empty_cache()

    # flash at qwen2-moe-a2.7b's 4000-token prefill (16 heads, hd 128,
    # causal; the same bound, bytes and library call as above), from a
    # generator of its own; launches from phase moe (a).
    gen_fm = torch.Generator(device=dev)
    gen_fm.manual_seed(SEED + 28)
    bh, S, hd = 16, SERVE_LONG[-1], 128
    q = torch.randn((bh, S, hd), generator=gen_fm, device=dev) * hd ** -0.5
    k, v = (torch.randn((bh, S, hd), generator=gen_fm,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    k4, v4 = (x.float()[None] for x in (k, v))
    pairs = bh * live_pairs(S, S, True, None)
    moe_flops = 4.0 * hd * pairs
    moe_bytes = bh * S * hd * (4 + 2 + 2 + 4)
    t_flop = 2 * moe_flops / PEAK_TF32_FLOPS
    t_byte = moe_bytes / HBM_BYTES_PER_S
    moe_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v), 20)
    emit({"phase": "times", "kernel": "flash", "case": "qwen2-moe prefill",
          "bh": bh, "s": S, "t": S, "hd": hd, "causal": True,
          "q_dtype": "float32", "kv_dtype": "bfloat16",
          "launches_in_phase_moe_a": moe_launches["flash"],
          "live_pairs": pairs, "flops": moe_flops, "bytes": moe_bytes,
          "peak": "TF32 tensor 495 TFLOP/s, 2 passes", "ms": moe_ms,
          "tflops": moe_flops / moe_ms / 1e9,
          "plain_ms": cuda_ms(lambda: flash_ref(q, k, v), 3),
          "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
              q[None], k4, v4, is_causal=True, scale=1.0), 20),
          "bound_ms": 1e3 * max(t_flop, t_byte),
          "bound_by": "operations" if t_flop >= t_byte else "bytes",
          "ffma_bound_ms": 1e3 * max(moe_flops / PEAK_F32_FLOPS, t_byte)})
    del q, k, v, k4, v4
    torch.cuda.empty_cache()

    # flash at jamba-v0.1-52b's 4096-token prefill (32 heads, hd 128,
    # causal), from a generator of its own; launches from phase hybrid (a).
    gen_fj = torch.Generator(device=dev)
    gen_fj.manual_seed(SEED + 31)
    bh, S, hd = 32, HYBRID_LONG, 128
    q = torch.randn((bh, S, hd), generator=gen_fj, device=dev) * hd ** -0.5
    k, v = (torch.randn((bh, S, hd), generator=gen_fj,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    k4, v4 = (x.float()[None] for x in (k, v))
    pairs = bh * live_pairs(S, S, True, None)
    jamba_flops = 4.0 * hd * pairs
    jamba_bytes = bh * S * hd * (4 + 2 + 2 + 4)
    t_flop = 2 * jamba_flops / PEAK_TF32_FLOPS
    t_byte = jamba_bytes / HBM_BYTES_PER_S
    jamba_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v), 20)
    emit({"phase": "times", "kernel": "flash", "case": "jamba prefill",
          "bh": bh, "s": S, "t": S, "hd": hd, "causal": True,
          "q_dtype": "float32", "kv_dtype": "bfloat16",
          "launches_in_phase_hybrid_a": hybrid_launches["flash"],
          "live_pairs": pairs, "flops": jamba_flops, "bytes": jamba_bytes,
          "peak": "TF32 tensor 495 TFLOP/s, 2 passes", "ms": jamba_ms,
          "tflops": jamba_flops / jamba_ms / 1e9,
          "plain_ms": cuda_ms(lambda: flash_ref(q, k, v), 3),
          "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
              q[None], k4, v4, is_causal=True, scale=1.0), 20),
          "bound_ms": 1e3 * max(t_flop, t_byte),
          "bound_by": "operations" if t_flop >= t_byte else "bytes",
          "ffma_bound_ms": 1e3 * max(jamba_flops / PEAK_F32_FLOPS, t_byte)})
    del q, k, v, k4, v4
    torch.cuda.empty_cache()

    # flash at qwen2-vl-2b's 4096-token prefill (12 heads, hd 128, causal;
    # GQA 12/2 repeated to 12), from a generator of its own; launches from
    # phase vlm (a).
    gen_fv = torch.Generator(device=dev)
    gen_fv.manual_seed(SEED + 46)
    bh, S, hd = 12, VLM_LONG, 128
    q = torch.randn((bh, S, hd), generator=gen_fv, device=dev) * hd ** -0.5
    k, v = (torch.randn((bh, S, hd), generator=gen_fv,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    k4, v4 = (x.float()[None] for x in (k, v))
    pairs = bh * live_pairs(S, S, True, None)
    vlm_flops = 4.0 * hd * pairs
    vlm_bytes = bh * S * hd * (4 + 2 + 2 + 4)
    t_flop = 2 * vlm_flops / PEAK_TF32_FLOPS
    t_byte = vlm_bytes / HBM_BYTES_PER_S
    vlm_ms = cuda_ms(lambda: flash_attention_kernel(q, k, v), 20)
    emit({"phase": "times", "kernel": "flash", "case": "qwen2-vl prefill",
          "bh": bh, "s": S, "t": S, "hd": hd, "causal": True,
          "q_dtype": "float32", "kv_dtype": "bfloat16",
          "launches_in_phase_vlm_a": vlm_launches["flash"],
          "live_pairs": pairs, "flops": vlm_flops, "bytes": vlm_bytes,
          "peak": "TF32 tensor 495 TFLOP/s, 2 passes", "ms": vlm_ms,
          "tflops": vlm_flops / vlm_ms / 1e9,
          "plain_ms": cuda_ms(lambda: flash_ref(q, k, v), 3),
          "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
              q[None], k4, v4, is_causal=True, scale=1.0), 20),
          "bound_ms": 1e3 * max(t_flop, t_byte),
          "bound_by": "operations" if t_flop >= t_byte else "bytes",
          "ffma_bound_ms": 1e3 * max(vlm_flops / PEAK_F32_FLOPS, t_byte)})
    del q, k, v, k4, v4
    torch.cuda.empty_cache()

    # ------------------- 9. where the main path's time goes (one more run)
    A = lowrank(MAIN_M, MAIN_N, MAIN_K, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y = sketch(SEED, A, 2 * MAIN_K, kind="gaussian").Y
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rid_from_sketch(A, Y, MAIN_K)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trace = profiled(lambda: rid(SEED, A, MAIN_K, sketch_kind="gaussian"))
    emit({"phase": "trace", "call": "rid(seed, A, 400, sketch_kind='gaussian')",
          "sketch_s": t1 - t0, "qr_interp_gather_s": t2 - t1, **trace})
    del A, Y
    torch.cuda.empty_cache()

    # big_copy at the fitting f32 shape of the analysis phase; launches
    # from the analysis run.  It moves the operand once in and once out
    # (each CTA re-reading all of it is the kernel's own traffic); the
    # library call is Tensor.clone.
    x = randn((48, 1024), torch.float32)
    copy_bytes = 2.0 * x.numel() * x.element_size()
    copy = {"name": "big_copy", "route": "cuda",
            "source": "src/repro_torch/analysis/fixtures/badkernel/"
                      "big_copy.cu",
            "replaces": "src/repro/analysis/fixtures/badkernel/kernel.py:16",
            "launches": analysis_launches["big_copy"], "max_abs_err": 0.0
            if all(c["bit_equal"] for c in copy_cases) else None,
            "ms": cuda_ms(lambda: big_copy(x, bn=256), 50),
            "plain_ms": cuda_ms(lambda: big_copy_ref(x), 50),
            "bound_ms": 1e3 * copy_bytes / HBM_BYTES_PER_S,
            "bound_by": "bytes",
            "library_ms": cuda_ms(lambda: x.clone(), 50)}
    emit({"phase": "times", "kernel": "big_copy", "m": 48, "n": 1024,
          "bn": 256, "dtype": "float32", "bytes": copy_bytes,
          **{key: copy[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}})
    del x

    # ------------- train: granite-3-2b at full width and depth, seq 4096
    # (a) five steps through train_loop on synthetic batches; the flash
    # kernel runs forward and again in each block's recompute, its
    # gradient through FlashAttention's plain backward.
    cfg = get_config("granite-3-2b")
    tcfg = TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = train_loop(cfg, tcfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     steps=TRAIN_STEPS, log=lambda *a: None, device=dev)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = read_counts()
    train_peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps_out = [dict(h, tokens_per_s=tokens / h["seconds"]) for h in hist]
    # One warm step more under torch.profiler: device busy and idle share,
    # device time by kernel, and by part: the flash kernel, the plain
    # backward (FlashAttention's node), the GEMMs, AdamW (a profiler range
    # around optim.adamw_update).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    state = out["state"]
    del out
    step_fn = make_train_step(cfg, tcfg)
    data_cfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=SEED)
    batch = batch_for_step(data_cfg, TRAIN_STEPS, device=dev)
    adamw_plain = steps_mod.adamw_update

    def adamw_ranged(*a, **kw):
        with record_function("adamw_update"):
            return adamw_plain(*a, **kw)

    torch.cuda.synchronize()
    with mock.patch.object(steps_mod, "adamw_update", adamw_ranged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # Kernels only: the adamw_update range also shows as a device span.
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in averages
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and e.key != "adamw_update"
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)

    def under(name) -> float:
        return max([e.device_time_total / 1e3 for e in averages
                    if e.key.endswith(name)], default=0.0)

    gemm = ("gemm", "xmma", "cutlass", "nvjet")
    parts = {"flash_fwd_ms": sum(r[1] for r in kernels
                                 if "flash_fwd_kernel" in r[0]),
             "flash_plain_backward_ms": under("FlashAttentionBackward"),
             "gemm_ms": sum(r[1] for r in kernels
                            if any(w in r[0] for w in gemm)),
             "adamw_span_ms": under("adamw_update")}
    del state, m, batch, step_fn
    torch.cuda.empty_cache()
    emit({"phase": "train", "part": "a", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "d_ff": cfg.d_ff, "padded_vocab": cfg.padded_vocab,
          "params": cfg.param_count(), "remat": cfg.remat,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps_out,
          "wall_s": train_wall, "max_memory_allocated": train_peak,
          "launches": train_launches,
          "flash_launches_per_step": train_launches["flash"] / TRAIN_STEPS,
          "profiled_step": {"traced_wall_s": traced_wall,
                            "device_busy_ms": busy_ms,
                            "device_idle_share": 1 - busy_ms
                            / (1e3 * traced_wall),
                            **parts,
                            "top_kernels": [{"name": k[:80], "ms": ms,
                                             "count": c}
                                            for k, ms, c in kernels[:15]]}})
    check(all(math.isfinite(h["loss"]) for h in hist),
          f"train: losses {[h['loss'] for h in hist]}")
    check(all(h["grad_norm"] > 0 and math.isfinite(h["grad_norm"])
              for h in hist), f"train: grad norms "
          f"{[h['grad_norm'] for h in hist]}")
    check(train_launches["flash"] == 2 * cfg.n_layers * TRAIN_STEPS,
          f"train: flash launched {train_launches['flash']} times, expected "
          f"{2 * cfg.n_layers} a step (forward and recompute)")
    check(all(v == 0 for name, v in train_launches.items()
              if name != "flash"), f"train: other kernels {train_launches}")
    check(busy_ms > 0, "train: no device time recorded")

    # The attention's forward and plain backward at the train step's shape
    # (B=2, 32 heads, S=T=4096, hd 64; q f32, k and v bf16), timed alone,
    # beside the library's scaled_dot_product_attention forward and
    # backward in f32.  A step runs it once a layer.
    bh = TRAIN_BATCH * cfg.n_heads
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(SEED + 24)
    qf = (torch.randn((bh, TRAIN_SEQ, cfg.hd), generator=gen_t, device=dev)
          * cfg.hd ** -0.5).requires_grad_(True)
    kf, vf = (torch.randn((bh, TRAIN_SEQ, cfg.hd), generator=gen_t,
                          device=dev).to(torch.bfloat16).requires_grad_(True)
              for _ in range(2))
    dout = torch.randn((bh, TRAIN_SEQ, cfg.hd), generator=gen_t, device=dev)
    o = FlashAttention.apply(qf, kf, vf, True, None, BLOCK_KV)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qf, kf, vf), dout, retain_graph=True), 3)
    fwd_ms = cuda_ms(lambda: FlashAttention.apply(qf, kf, vf, True, None,
                                                  BLOCK_KV), 5)
    q4, k4, v4 = (x.detach().float()[None].requires_grad_(True)
                  for x in (qf, kf, vf))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        scale=1.0)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), dout[None], retain_graph=True), 3)
    pairs = bh * live_pairs(TRAIN_SEQ, TRAIN_SEQ, True, None)
    all_pairs = bh * TRAIN_SEQ * TRAIN_SEQ
    # The plain backward: five products of 2 hd flop a (q, k) pair, over
    # every pair (masked blocks included), in f32 without tensor cores.
    bwd_flops = 10.0 * cfg.hd * all_pairs
    step_mean_s = sum(h["seconds"] for h in hist[1:]) / (len(hist) - 1)
    emit({"phase": "train", "part": "attention timing", "bh": bh,
          "s": TRAIN_SEQ, "hd": cfg.hd, "q_dtype": "float32",
          "kv_dtype": "bfloat16", "flash_fwd_lse_ms": fwd_ms,
          "plain_backward_ms": bwd_ms,
          "plain_backward_flops": bwd_flops,
          "plain_backward_tflops": bwd_flops / bwd_ms / 1e9,
          "plain_backward_ffma_bound_ms": 1e3 * bwd_flops / PEAK_F32_FLOPS,
          "live_pairs": pairs, "all_pairs": all_pairs,
          "live_backward_ffma_bound_ms": 1e3 * 10.0 * cfg.hd * pairs
          / PEAK_F32_FLOPS,
          "sdpa_f32_backward_ms": sdpa_bwd_ms,
          "plain_backward_ms_per_step": bwd_ms * cfg.n_layers,
          "plain_backward_share_of_step": bwd_ms * cfg.n_layers / 1e3
          / step_mean_s, "warm_step_mean_s": step_mean_s})
    del qf, kf, vf, dout, o, q4, k4, v4, o4
    torch.cuda.empty_cache()

    # (b) One layer's attention (B=1, 32 heads, S=T=4096, hd 64) through
    # the kernel's Function against autograd through flash_ref (dense, 2.1
    # GB of scores), k and v in f32 and in bf16 (the model's); the kernel's
    # o bit-equal with and without lse, and its lse against flash_ref's.
    grad_check = {}
    for kvdt in (torch.float32, torch.bfloat16):
        gen_t.manual_seed(SEED + 25)
        q1 = torch.randn((cfg.n_heads, TRAIN_SEQ, cfg.hd), generator=gen_t,
                         device=dev) * cfg.hd ** -0.5
        k1, v1 = (torch.randn((cfg.n_heads, TRAIN_SEQ, cfg.hd),
                              generator=gen_t, device=dev).to(kvdt)
                  for _ in range(2))
        d1 = torch.randn((cfg.n_heads, TRAIN_SEQ, cfg.hd), generator=gen_t,
                         device=dev)
        res = []
        for fn in (lambda a, b, c: FlashAttention.apply(a, b, c, True, None,
                                                        BLOCK_KV),
                   lambda a, b, c: flash_ref(a, b, c)):
            a, b, c = (x.clone().requires_grad_(True) for x in (q1, k1, v1))
            out1 = fn(a, b, c)
            res.append([out1.detach()] + list(torch.autograd.grad(
                out1, (a, b, c), d1)))
            del a, b, c, out1
        errs = {name: rel_err(g.float(), w.float())
                for name, g, w in zip(("o", "dq", "dk", "dv"), *res)}
        o_plain = flash_attention_kernel(q1, k1, v1)
        o_lse, lse = flash_attention_kernel(q1, k1, v1, return_lse=True)
        _, lse2 = flash_attention_kernel(q1, k1, v1, return_lse=True)
        _, lse_ref = flash_ref(q1, k1, v1, return_lse=True)
        grad_check[dname(kvdt)] = {
            "rel_err": errs, "tol": TRAIN_GRAD_TOL[dname(kvdt)],
            "o_bit_equal_with_lse": same_bits(o_plain, o_lse),
            "lse_repeat_bit_equal": same_bits(lse, lse2),
            "lse_rel_err": rel_err(lse, lse_ref)}
        del q1, k1, v1, d1, res, o_plain, o_lse, lse, lse2, lse_ref
        torch.cuda.empty_cache()
    emit({"phase": "train", "part": "b", "bh": cfg.n_heads, "s": TRAIN_SEQ,
          "t": TRAIN_SEQ, "hd": cfg.hd, "causal": True, "q_dtype": "float32",
          "backward_block": BLOCK_KV, "checks": grad_check,
          "lse_tol": FLASH_TOL})
    for name, c in grad_check.items():
        check(all(e <= c["tol"] for e in c["rel_err"].values()),
              f"train (b) {name}: gradients {c['rel_err']} beyond {c['tol']}")
        check(c["o_bit_equal_with_lse"] and c["lse_repeat_bit_equal"],
              f"train (b) {name}: o or lse not bit-equal")
        check(c["lse_rel_err"] <= FLASH_TOL,
              f"train (b) {name}: lse rel err {c['lse_rel_err']}")

    # (c) Two layers at full width, seq 4096: two runs from one seed bit
    # for bit; a run failed at step 2 and resumed from its checkpoint,
    # bit-equal to the uninterrupted run; RandLR rank 8 over 2 pod groups
    # against the dense loss after 4 steps, gated as the reference's
    # test_train_step_sharded_with_compression gates it (TrainConfig()'s
    # defaults: warmup 100, so lr <= 9e-6 here: within 5 % of the dense
    # loss), and at the train phase's lr (peak 3e-4 after 1 warmup step),
    # where the loss moves: the compressed run's drop over its 3 updates
    # is at least half the dense run's (the compressed step equals the
    # reference's on the same Omega, tests/test_torch_train.py; a step
    # that applied no gradient would drop nothing).
    c2 = cfg.replace(n_layers=TRAIN_SMALL_LAYERS)
    kw = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              log=lambda *a: None, device=dev)
    t3 = TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=3)
    runs = [train_loop(c2, t3, steps=3, **kw) for _ in range(2)]
    params_equal = all(torch.equal(p, q) for p, q in zip(
        runs[0]["state"].params.parameters(),
        runs[1]["state"].params.parameters()))
    losses_equal = runs[0]["losses"] == runs[1]["losses"]
    del runs[1]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        failed = False
        try:
            train_loop(c2, t3, steps=3, ckpt_dir=ckpt, ckpt_every=2,
                       fail_at=2, **kw)
        except HostFailure:
            failed = True
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = train_loop(c2, t3, steps=3, ckpt_dir=ckpt, ckpt_every=2,
                             **kw)
        resume_s = time.perf_counter() - t0
    resume_equal = (resumed["losses"] == runs[0]["losses"][2:]
                    and all(torch.equal(p, q) for p, q in zip(
                        runs[0]["state"].params.parameters(),
                        resumed["state"].params.parameters())))
    uninterrupted = runs[0]["losses"]
    del runs, resumed
    torch.cuda.empty_cache()
    compressed = {}
    for name, t4 in (("reference_defaults", TrainConfig()),
                     ("lr_3e-4", TrainConfig(peak_lr=3e-4, warmup_steps=1,
                                             total_steps=4))):
        dense = train_loop(c2, t4, steps=4, **kw)
        torch.cuda.empty_cache()
        rcomp = train_loop(
            c2, t4._replace(compress=CompressorConfig(rank=8)), steps=4,
            npods=2, **kw)
        torch.cuda.empty_cache()
        d, r = dense["final"], rcomp["final"]
        drop = (dense["losses"][0] - d["loss"], rcomp["losses"][0] - r["loss"])
        compressed[name] = {
            "dense_loss": d["loss"], "compressed_loss": r["loss"],
            "compressed_grad_norm": r["grad_norm"],
            "compress_ratio": r["compress_ratio"],
            "compressed_vs_dense": abs(d["loss"] - r["loss"]) / d["loss"],
            "dense_drop": drop[0], "compressed_drop": drop[1],
            "drop_share": drop[1] / drop[0] if drop[0] > 0 else None}
        del dense, rcomp
        torch.cuda.empty_cache()
    gated = compressed["reference_defaults"]
    moving = compressed["lr_3e-4"]
    emit({"phase": "train", "part": "c", "n_layers": TRAIN_SMALL_LAYERS,
          "reduced": f"depth cut from {cfg.n_layers} to "
                     f"{TRAIN_SMALL_LAYERS} layers (run time)",
          "losses": uninterrupted, "replay_losses_equal": losses_equal,
          "replay_params_equal": params_equal,
          "fail_at_raised": failed, "resume_bit_equal": resume_equal,
          "resume_s": resume_s, "rank8_npods2": compressed,
          "compressed_tol": 0.05, "drop_share_min": 0.5})
    check(losses_equal and params_equal, "train (c): two runs differ")
    check(failed, "train (c): fail_at did not raise HostFailure")
    check(resume_equal, "train (c): the resumed run is not bit-equal")
    check(gated["compressed_vs_dense"] < 0.05,
          f"train (c): compressed vs dense {gated}")
    check(moving["dense_drop"] > 0 and moving["compressed_drop"]
          >= 0.5 * moving["dense_drop"],
          f"train (c): compressed drop at lr 3e-4 {moving}")
    check(all(math.isfinite(c["compressed_grad_norm"])
              and c["compressed_grad_norm"] > 0
              for c in compressed.values()),
          "train (c): compressed grad norm")

    # ------------- mesh: the sharded steps on a one-rank NCCL mesh
    def run_mesh_phase(cfg, tcfg, plain_losses, plain_secs, plain_peak):
        """(a) the sharded train step against phase train's, without and
        with cast_params; (b) the sharded prefill and greedy decode
        against the plain ones.  Returns the flash launches it counted."""
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.sharding import distribute_params
        from repro_torch.launch.steps import (sharded_decode_step,
                                              sharded_prefill)
        plain_warm = sum(plain_secs[1:]) / len(plain_secs[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flash_total = 0
        with bench_error.one_rank_group(dev):
            mesh = make_host_mesh(device_type="cuda")
            def run(tc, on_mesh):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                reset_counts()
                out = train_loop(cfg, tc, global_batch=TRAIN_BATCH,
                                 seq_len=TRAIN_SEQ, steps=MESH_STEPS,
                                 log=lambda *a: None, device=dev,
                                 mesh=mesh if on_mesh else None)
                torch.cuda.synchronize()
                secs = [h["seconds"] for h in out["history"]]
                res = {"losses": out["losses"],
                       "grad_norms": [h["grad_norm"] for h in out["history"]],
                       "step_s": secs,
                       "warm_step_s": sum(secs[1:]) / len(secs[1:]),
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated(),
                       "launches": read_counts()}
                del out
                torch.cuda.empty_cache()
                return res

            # Each sharded run has an unsharded run of its config beside
            # it (plain tp, sharded tp, sharded cast, plain cast), whose
            # warm step its overhead is taken against.  The tp run's
            # losses are held to phase train's; the cast run's to the
            # unsharded cast run's: the pre-cast bf16 embedding and head
            # (the reference's _KEEP_F32 leaves them out) round the f32
            # logits, so it is not phase train's math.
            cast_tc = tcfg._replace(cast_params=True)
            plain_tp = run(tcfg, False)
            sharded_tp = run(tcfg, True)
            sharded_cast = run(cast_tc, True)
            plain_cast = run(cast_tc, False)
            flash_total += sum(r["launches"]["flash"] for r in (
                plain_tp, sharded_tp, sharded_cast, plain_cast))
            runs = {}
            for name, r, ref, beside in (
                    ("tp", sharded_tp, plain_losses[:MESH_STEPS], plain_tp),
                    ("tp+cast_params", sharded_cast, plain_cast["losses"],
                     plain_cast)):
                r.update(
                    plain_losses=ref,
                    loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                                     zip(r["losses"], ref)),
                    bit_equal=r["losses"] == ref,
                    tokens_per_s=tokens / r["warm_step_s"],
                    plain_step_s=beside["step_s"],
                    plain_warm_step_s=beside["warm_step_s"],
                    dtensor_overhead=r["warm_step_s"]
                    / beside["warm_step_s"] - 1.0,
                    plain_max_memory_allocated=beside[
                        "max_memory_allocated"],
                    flash_launches_per_step=r["launches"]["flash"]
                    / MESH_STEPS)
                runs[name] = r
            runs["tp"].update(
                phase_train_warm_step_s=plain_warm,
                phase_train_max_memory_allocated=plain_peak,
                plain_beside_losses_equal=plain_tp["losses"]
                == plain_losses[:MESH_STEPS])
            runs["tp+cast_params"]["vs_phase_train_rel"] = max(
                abs(a - b) / abs(b) for a, b in
                zip(runs["tp+cast_params"]["losses"], plain_losses))
            emit({"phase": "mesh", "part": "a", "arch": cfg.name,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
                  "seq": TRAIN_SEQ, "steps": MESH_STEPS, "mode": "tp",
                  "runs": runs, "tol": MESH_LOSS_TOL})
            for name, r in runs.items():
                check(r["loss_rel_err"] <= MESH_LOSS_TOL,
                      f"mesh (a) {name}: losses {r['losses']} against phase "
                      f"train's {r['plain_losses']}")
                check(r["launches"]["flash"] == 2 * cfg.n_layers * MESH_STEPS
                      and all(v == 0 for k, v in r["launches"].items()
                              if k != "flash"),
                      f"mesh (a) {name}: launches {r['launches']}")

            # (b) the sharded prefill and greedy decode against the plain
            model = init_params(SEED, cfg, device=dev)
            gen_m = torch.Generator(device=dev)
            gen_m.manual_seed(SEED + 28)
            toks = torch.randint(0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT),
                                 generator=gen_m, device=dev)
            max_len = MESH_PROMPT + MESH_NEW

            def greedy(prefill_fn, decode_fn):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                lg, caches = prefill_fn(toks)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                n_flash = read_counts()["flash"]
                first = lg.float().clone()
                out, steps_s = [], []
                nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
                for i in range(MESH_NEW):
                    out.append(nxt)
                    t0 = time.perf_counter()
                    lg, caches = decode_fn(nxt, MESH_PROMPT + i, caches)
                    torch.cuda.synchronize()
                    steps_s.append(time.perf_counter() - t0)
                    nxt = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
                del caches
                return (first, torch.cat(out, 1), n_flash, prefill_s,
                        sum(steps_s[1:]) / len(steps_s[1:]))

            plain = greedy(
                lambda t: prefill(model, cfg, t, max_len=max_len),
                lambda t, p, c: decode_step(model, cfg, t, p, c))
            torch.cuda.empty_cache()
            pf, pshard, _, _ = sharded_prefill(cfg, mesh, MESH_BATCH, max_len)
            dfn, _, _ = sharded_decode_step(cfg, mesh, MESH_BATCH, max_len)
            distribute_params(model, mesh, cfg, shardings=pshard)
            sharded = greedy(
                lambda t: tuple_full(pf(model, {"tokens": t})),
                lambda t, p, c: tuple_full(dfn(model, t, p, c)))
            flash_total += plain[2] + sharded[2]
            a, b = sharded[0].flatten(), plain[0].flatten()
            cross = {"rel_l2": float((a - b).norm() / b.norm()),
                     "max_abs_over_max": float((a - b).abs().max()
                                               / b.abs().max())}
            emit({"phase": "mesh", "part": "b", "arch": cfg.name,
                  "batch": MESH_BATCH, "prompt": MESH_PROMPT,
                  "new_tokens": MESH_NEW, "logits": cross, "tol": CHUNK_TOL,
                  "logits_bit_equal": bool(torch.equal(a, b)),
                  "tokens_equal": bool(torch.equal(sharded[1], plain[1])),
                  "flash_launches": {"sharded": sharded[2],
                                     "plain": plain[2]},
                  "prefill_s": {"sharded": sharded[3], "plain": plain[3]},
                  "decode_step_s": {"sharded": sharded[4],
                                    "plain": plain[4]},
                  "finite": bool(torch.isfinite(a).all())})
            check(bool(torch.isfinite(a).all()), "mesh (b): logits not finite")
            check(all(cross[k] <= CHUNK_TOL[k] for k in CHUNK_TOL),
                  f"mesh (b): sharded vs plain prefill {cross}")
            check(torch.equal(sharded[1], plain[1]),
                  "mesh (b): greedy tokens differ")
            check(sharded[2] == plain[2] == cfg.n_layers,
                  f"mesh (b): flash launched {sharded[2]} (sharded) and "
                  f"{plain[2]} (plain) times, expected {cfg.n_layers}")
            del model, toks, plain, sharded
            torch.cuda.empty_cache()
        return {"flash_launches": flash_total}

    def tuple_full(res):
        """(logits as a plain tensor, caches): a DTensor's whole value."""
        lg, caches = res
        return lg.full_tensor(), caches

    mesh_res = run_mesh_phase(cfg, tcfg, [h["loss"] for h in hist],
                              [h["seconds"] for h in hist], train_peak)
    mesh_flash = mesh_res.pop("flash_launches")
    # (c) the dry-run on torch's fake backend: CPU work, after every timed
    # phase of the card, one process a cell (each joins the fake group),
    # all started together; any still running at exit is killed.
    dry_t0 = time.perf_counter()
    dry_outs = [tempfile.TemporaryFile(mode="w+") for _ in MESH_DRY_CELLS]
    dry_procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--jsonl",
         f"--cell={c}"], stdout=f, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                 CUDA_VISIBLE_DEVICES=""))
        for c, f in zip(MESH_DRY_CELLS, dry_outs)]
    atexit.register(lambda: [p.kill() for p in dry_procs
                             if p.poll() is None])
    dry_lines, dry_exits = [], []
    for p, f in zip(dry_procs, dry_outs):
        dry_exits.append(p.wait(timeout=MESH_DRY_TIMEOUT))
        f.seek(0)
        dry_lines += f.read().splitlines()
    dry_s = time.perf_counter() - dry_t0
    records = [json.loads(ln) for ln in dry_lines if ln.startswith("{")]
    emit({"phase": "mesh", "part": "c", "backend": "fake (CPU, no device)",
          "cells": [{k: r.get(k) for k in (
              "arch", "shape", "mesh", "mesh_shape", "status", "seconds",
              "flops", "peak_bytes_per_device", "hbm_bytes_per_device",
              "param_bytes_per_device", "grad_bytes_per_device",
              "opt_bytes_per_device", "collective_bytes",
              "collective_total", "interpod_bytes",
              "propagations_excluded", "peak_by_origin", "error",
              "traceback")}
              for r in records],
          "process_exits": dry_exits, "wall_s": dry_s})
    check(all(rc == 0 for rc in dry_exits)
          and len(records) == len(MESH_DRY_CELLS)
          and all(r["status"] == "ok" for r in records),
          f"mesh (c): dry-run exits {dry_exits}, statuses "
          f"{[(r['arch'], r['status'], r.get('error')) for r in records]}; "
          f"output tail {dry_lines[-5:]}")

    # ------------- scaling: the paper's Figures 1-2 (modeled), the rows
    # executed on the card's one-rank NCCL group, and the quickstart
    scaling_t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.benchmarks import bench_scaling, scaling_worker
    from repro_torch.configs import SMALL_GRID
    procs = [int(p) for p in SCALING_PROCS.split(",")]
    exec_cases = [(case, impl) for case in (SMALL_GRID[1], MAIN)
                  for impl in SCALING_IMPLS]
    # (b) SMALL_GRID row 1 and the main row executed on the card (one
    # rank, 4 calls), before the counting below starts its CPU
    # subprocesses, so that no wall is taken beside them; the launches
    # against the counts phases main and distributed hold for one call.
    walls, exec_counts = [], []
    with bench_error.one_rank_group(dev) as g:
        for case, impl in exec_cases:
            reset_counts()
            walls.append(scaling_worker.exec_wall(case.k, case.m, case.n,
                                                  impl, g, dev))
            torch.cuda.synchronize()
            exec_counts.append({k: v for k, v in read_counts().items()
                                if v})
            torch.cuda.empty_cache()
    # (c) examples/torch/quickstart.py at its own size on the card, held
    # to the eq. (3) bound it prints.
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart", Path(__file__).resolve().parent / "examples"
        / "torch" / "quickstart.py")
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as qs_out:
        qs = quick.main(["--device", "cuda"])
    torch.cuda.synchronize()
    qs_s = time.perf_counter() - t0
    qs_launches = {k: v for k, v in read_counts().items() if v}
    # (a) The counting, on torch's fake backend in CPU subprocesses
    # (nothing allocated), four at a time: PAPER_GRID rows 0 and 6 at
    # 4..128 ranks for both engines, and (b)'s rows at one rank for their
    # modeled seconds.
    with ThreadPoolExecutor(4) as pool:
        fig_futs = [(impl, PAPER_GRID[i], pool.submit(
            scaling_worker.sweep, PAPER_GRID[i].k, PAPER_GRID[i].m,
            PAPER_GRID[i].n, procs, impl))
            for impl in SCALING_IMPLS for i in (0, 6)]
        model_futs = [pool.submit(scaling_worker.sweep, case.k, case.m,
                                  case.n, [1], impl)
                      for case, impl in exec_cases]
        figs = {impl: [] for impl in SCALING_IMPLS}
        for impl, case, fut in fig_futs:
            recs = dict(zip(procs, fut.result()))
            figs[impl] += bench_scaling.scaling_rows(
                case, {p: case.n for p in procs}, recs, procs, weak=False,
                qr_impl=impl)
        models = [fut.result()[0] for fut in model_futs]
    consts = scaling_worker.H100
    emit({"phase": "scaling", "part": "a",
          "what": "Figures 1-2: one rank's roofline time at N ranks, a "
                  "model on published constants (no multi-card run)",
          "constants": {k: consts[k] for k in (
              "name", "peak_flops", "hbm_bytes_s", "nvlink_bytes_s",
              "net_bytes_s", "source")},
          "card": smi,
          "rows": [{k: r[k] for k in (
              "qr_impl", "k", "m", "n", "procs", "model_time_s",
              "speedup_vs4", "efficiency", "flops_per_dev",
              "hbm_bytes_per_dev", "coll_bytes_per_dev",
              "interhost_bytes_per_dev", "bytes_per_dev", "host_reads")}
              for impl in SCALING_IMPLS for r in figs[impl]]})
    for impl in SCALING_IMPLS:
        rows = figs[impl]
        check(len(rows) == 2 * len(procs) and all(
            r["model_time_s"] > 0 and math.isfinite(r["speedup_vs4"])
            and r["bytes_per_dev"] > 0 for r in rows),
            f"scaling (a): {impl} rows malformed")
    exec_rows = []
    for (case, impl), wall, counts, rec in zip(exec_cases, walls,
                                               exec_counts, models):
        model = scaling_worker.model_time(rec)
        exec_rows.append({"qr_impl": impl, "k": case.k, "m": case.m,
                          "n": case.n, "procs": 1, "calls": 4,
                          "wall_s": wall, "model_time_s": model,
                          "wall_over_model": wall / model,
                          "launches": counts,
                          "kernel_calls_counted": rec["kernel_calls"]})
    per_call = {"blocked": {"panel_step": main_launches["panel_step"],
                            "sketch_accum": main_launches["sketch_accum"]},
                "panel_parallel": {
                    k: dist_launches[k] for k in (
                        "panel_coeff", "panel_apply",
                        "panel_apply(emit_norms)", "sketch_accum")}}
    emit({"phase": "scaling", "part": "b", "backend": "nccl", "world": 1,
          "dtype": "float32", "rows": exec_rows,
          "main_row_launches_a_call": per_call})
    for r in exec_rows:
        check(r["wall_s"] > 0 and r["model_time_s"] > 0,
              f"scaling (b): {r['qr_impl']} k={r['k']} times {r}")
        if (r["k"], r["m"], r["n"]) == (MAIN_K, MAIN_M, MAIN_N):
            want = {k: 4 * v for k, v in per_call[r["qr_impl"]].items()}
            check(r["launches"] == want,
                  f"scaling (b): {r['qr_impl']} main row launched "
                  f"{r['launches']}, expected {want} (4 calls)")
        else:
            check(r["launches"].get("sketch_accum") == 4 and all(
                r["launches"].get(k, 0) > 0 for k in
                per_call[r["qr_impl"]] if k != "panel_apply(emit_norms)"),
                f"scaling (b): {r['qr_impl']} small row launched "
                f"{r['launches']}")
    emit({"phase": "scaling", "part": "c",
          "script": "examples/torch/quickstart.py", "seconds": qs_s,
          "printed": qs_out.getvalue().splitlines(),
          "eq3_err": qs["eq3_err"], "eq3_bound": qs["eq3_bound"],
          "sketch_errors": qs["sketches"], "rsvd_err": qs["rsvd_err"],
          "launches": qs_launches})
    check(qs["satisfied"] and qs["eq3_err"] <= qs["eq3_bound"],
          f"scaling (c): quickstart's eq. (3) {qs['eq3_err']} > "
          f"{qs['eq3_bound']}")
    check(qs_launches.get("fwht", 0) > 0
          and qs_launches.get("sketch_accum", 0) > 0
          and qs_launches.get("panel_step", 0) > 0,
          f"scaling (c): quickstart's launches {qs_launches}")
    emit({"phase": "scaling", "seconds": time.perf_counter() - scaling_t0})

    flash["launches"] += (mesh_flash + train_launches["flash"]
                          + moe_flash_launches
                          + hybrid_launches["flash"]
                          + xlstm_launches["flash"]
                          + encdec_launches["flash"] + vlm_launches["flash"])

    emit({"kernels": [accum, pstep, coeff, apply, gram, matmul, hadamard,
                      trisolve, proj, deflate, flash, copy]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        emit({"ok": False, "error": str(exc)})
        sys.exit(1)

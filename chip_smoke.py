#!/usr/bin/env python3
"""Drive the PyTorch port (gowebp_tpu_torch) end to end on one CUDA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result is printed):
  1. the card's name and power limit (nvidia-smi), the int32 ceiling the
     bounds use (SMs x 64 int32 operations a clock x the max SM clock),
     torch and CUDA versions;
  2. build the fourteen CUDA kernels from the nine ops/kernels/*.cu
     sources (one nvcc each, in parallel; encode_plane.cu gives the two
     plane kernels, their two modes-only forms and their halo forms,
     wavefront_search.cu the exact engine, its trellis form and its stripe
     form, vp8_recon.cu the decode's recon_filter_mb and its stripe form,
     coeff_unpack.cu the batch decode's unpack_coeffs, vp8l_predictor.cu
     the lossless encode's predictor_search_entropy, vp8l_inverse.cu the
     sharded lossless inverse's predictor_inverse) and print the build
     time and ptxas register report;
  3. hold each kernel against its plain torch version on the card, bit for
     bit, at the main paths' full shapes, and time each with CUDA events,
     two ways: one call alone (ms, the wrapper's host time included) and
     the device time of a launch (device_ms: calls queued behind a sleeping
     stream, so the host's part of each call leaves the card no idle gap);
     a device time under the kernel's bound fails (that bound counts more
     work than the function needs): i4_search on the cold="dense" round's
     inputs for 16 of the corpus images (S = 16*65536 sub-blocks, context
     from the source planes), with topk None and 4; i4_walk at B=16 on the
     same images' refine inputs (q75, 4 segments, context from one
     wavefront_fixed pass over the cold modes), with topk None and 4, timed
     beside the same walk as 16 flat i4_search launches with their glue;
     wavefront_fixed at B=16 1024x1024 with random i4/i16 mixes and 4
     segments, error diffusion on and off, recon on and off, 3 repeated
     runs, odd MB grids (1x5, 5x1, 1x1, 3x5, 5x3) and B=256 at 512x64
     (8,192 MB rows, more than the card holds blocks), and timed alone on
     one image (the dependency chain); yuv420_to_rgba at B=16 1024x1024
     with and without an alpha plane, B=2 at 1021x1023 in MB-padded planes,
     and B=32 at 1024x1024, the decode path's shape, each fancy and, at
     B=32 and B=2, with nearest upsampling (fancy=False:
     no_fancy_upsampling); encode_luma and encode_chroma and their
     modes-only forms at B=16 1024x1024 random planes in one wire buffer,
     as the open-loop path lays them out, with two quantizer sets, at odd
     MB counts, and on views 1-3 bytes past an aligned address with batch
     strides that are no multiple of 4, with their ptxas registers, stack
     and spills (none allowed) and resident warps; wavefront_search (the
     exact engine) at B=16 1024x1024 on the phase-4 chunk's real planes,
     segments and penalties with diffusion and the i4 search on and off, 3
     repeated runs, on mixed planes (i16 and i4 MBs) at B=16 1024x1024 and
     odd MB grids (1x5, 5x1), and on tie-heavy planes (flat and gradient
     MBs, penalties 0 and 1); its ptxas registers, stack and spills (none
     allowed, in any of its four forms) and resident blocks printed;
     timed alone on one image; its trellis form (method 6's second pass)
     at B=16 1024x1024 on the same chunk with the rate tables of image
     0's first-pass probabilities and the segments' lambdas, 3 repeated
     runs, odd MB grids (1x5, 5x1) and a grid with the i4 search off,
     timed at B=16 and on one image; and
     (3g, run once phase 4 has written the 32 files) recon_filter_mb
     against ops/vp8_recon.py's recon_wavefront followed by
     loop_filter_wavefront
     at B=32 1024x1024 on the decode path's inputs for those files, with
     filter types 0, 1 and 2 and 3 repeated runs, and on random i4/i16
     mixes with skip MBs and four segments of distinct filter levels at B=4
     256x256, on odd MB grids (1x5, 5x1, 1x1, 3x5) and at B=256 512x64
     (8,192 MB rows, more than the card holds blocks), with its ptxas
     report (no stack or spills allowed), timed at B=32 and alone on one
     image (the chain); (3i, after 3g) unpack_coeffs against
     unpack_coeffs_plain and the dense coefficients, bit for bit, on the
     symbols of those 32 files packed at K = 4, 8 and 16 and at the K the
     pack chooses, of 4 files at q100 (levels past int8: exception rows),
     of 16 smooth files at q95, of synthetic coefficients with non-exact
     divisions at B=4 1024x1024, and on odd MB grids (1x5, 5x1, 1x1);
     against unpack_coeffs_plain on tables whose rows sit at the one
     kernel's CTA edges (unpack_case); each call one kernel launch (the
     wrapper's count and the library's); its ptxas report with shared
     memory (no stack or spills allowed); timed (ms, device_ms) on the
     32 files at the chosen K; for the K choice, the group's h2d bytes
     and ms (host clock: the buffer's fill and its copy) and the unpack's
     device time at each K on the 32 files and the q95 set, beside the
     dense upload's; and a tail row's device ns (K=4 with and without
     its tail rows); and (3h) predictor_search_entropy against its
     plain version, mode maps equal: the lossless encode's own inputs for
     corpus image 12 (1024x1024, with and without subtract-green) at bits
     3, 4 and 5 with refine_iters 0, 2 and 4, odd sizes with partial edge
     tiles (1023x769, 1x4096, 4096x1), tie-heavy flat and gradient images
     and the image with a soft alpha; its ptxas report (no stack or
     spills allowed); timed at the default encode's shape (bits 4,
     refine_iters 2), at bits 3 and 5, and at bits 4 on the soft alpha
     and the flat and gradient planes, as one call and as the device time
     of its launches (replayed with the call's own round tables), stage 1
     apart from a round, beside the bound by this design's operation
     count and by the per-tile sweep's;
  4. the encode path: 32 natural images of 1024x1024 through
     encode_rgba_batch(device="cuda") in two chunks of 16, with the
     kernels' launch counters reset just before and read just after
     (i4_walk and wavefront_fixed must have launched, and the plane
     kernels' modes-only forms once each a chunk: the cold round); then
     a second, timed run with the per-stage split from CUDA events, and
     the hybrid stages on one chunk of 16 with the host quiet (CUDA-event
     spans, median of 3);
  5. encode parity: 2 of those images through the same path on the CPU
     (the kernels' plain versions) must give identical .webp bytes, and
     every output's RIFF/VP8 headers must be well-formed 1024x1024 frames;
     then the hybrid options, one chunk of 16 each: cold="dense",
     refine=2, i4_topk=4 and a config with method=3, each with the launch
     counters reset just before and read just after (i4_search must
     launch on cold="dense" and no modes-only plane kernel there, which
     every other option set launches once each; no i4 kernel at
     method=3) and its bytes held
     to the CPU path's on 2 images; then depth=1 against depth=3 on the 32
     images in 4 chunks of 8, alternated twice, with MP/s and the host
     timings, and the synchronizing CUDA calls of one depth=3 run;
  6. the decode path: phase 4's 32 files through
     decode_rgba_batch(device="cuda"), with the launch counters reset just
     before and read just after (unpack_coeffs, recon_filter_mb and
     yuv420_to_rgba must launch, once a lossy group each, and no other
     kernel); a second, timed run with the per-stage split (host symbols
     and pack, then CUDA-event spans; "unpack" is the sparse upload's
     unpack, "recon" the one kernel's iDCT, recon and filter) and the h2d
     bytes and ms of the packed upload beside the dense upload's of the
     same group (``_upload``, timed once the same way); a device_out=True
     run whose CUDA tensors must equal the host results;
  6b. the mixed decode: those 32 files with 4 lossy + ALPH and 4 VP8L
     files of 1024x1024 written by Pillow, in one device_out=True call,
     counters reset just before and read just after (unpack_coeffs,
     recon_filter_mb and yuv420_to_rgba must launch for the plain and the
     ALPH groups,
     yuv420_to_rgba at least once with an alpha plane, and no other
     kernel);
     a timed run to host memory with the host thread seconds (symbols,
     alpha, VP8L) and the stage split, whose images must equal the
     device_out tensors, Pillow's decode (ALPH and VP8L), phase 6's
     (hybrid) and the device="cpu" path's (2 ALPH images); then
     recon_backend="host" on the 32 hybrid files and on the mixed batch
     (no kernel may launch; pixels equal the device path's), its MP/s
     beside the device path's;
  6c. the single-file API: every file of phase 6b through
     decode(device="cuda"), one call each, counters reset just before and
     read just after (each lossy file launches recon_filter_mb and
     yuv420_to_rgba once: the single-file decode uploads dense and
     launches no unpack_coeffs; no other kernel),
     each file's pixels == decode_rgba_batch's; the ms of one 1 MP lossy
     file (median of 5) beside its host symbol phase and
     recon_backend="host"; then on two lossy files (one a smooth q95
     gradient that the chroma dither reaches), one ALPH and one VP8L file
     of 255x193 from Pillow, decode() with crop, scale, flip,
     bypass_filtering, no_fancy_upsampling, dithering_strength=50 and
     alpha_dithering_strength=50, in modes bgrA, RGB_565 and ARGB, and
     decode_yuva with crop, each == device="cpu";
  6d. the incremental decoder: IncrementalDecoder(device="cuda") on a
     1 MP lossy file of phase 4 fed in 17 chunks (each partial call
     launches recon_filter_mb and yuv420_to_rgba once; partial rows ==
     the final rows), on its first two thirds (partial rows == the final
     rows and == IncrementalDecoder(device="cpu")'s), on a 255x193 lossy
     file in 37-byte appends and a VP8L file in 50-byte appends (state,
     rows and partial output == the CPU decoder's after every append;
     final output == decode()); then picture_rescale(device="cuda") ==
     device="cpu" on an RGB and an RGBA 1 MP image;
  7. decode parity: 2 files through device="cpu" must give identical
     RGBA, and every decoded image must come within 20 dB PSNR of its
     source image (an error shared by both paths would not);
  8. the open-loop encode path: phase 4's 32 images through
     encode_rgba_batch(engine="openloop", device="cuda"), with the
     encode_luma and encode_chroma launch counters reset just before and
     read just after; a second, timed run with the stage split; GPU bytes
     == CPU bytes on 2 images, 32 headers checked; 4 files decoded on the
     card, each above OPENLOOP_PSNR_FLOOR_DB against its source;
  8b. the exact engine: phase 4's 32 images through
     encode_rgba_batch(engine="wavefront", device="cuda"), with the
     launch counters reset just before and read just after
     (wavefront_search must launch, no hybrid or plane kernel may); a second, timed
     run with the stage split (wavefront, pack); GPU bytes == CPU bytes on
     2 images, 32 headers checked; all 32 files decoded on the card and by
     Pillow to the same pixels; PSNR and size against the hybrid's files;
  8c. the single-image encode: a 1024x1024 RGBA image with a soft alpha
     mask and a fully transparent corner through encode_rgba(device=
     "cuda"), counters reset just before and read just after: the defaults
     launch wavefront_search once and no other kernel, method 6 it and its
     trellis form once each, and so does the image as RGB at method 6;
     GPU bytes == CPU bytes (defaults, RGB at method 6); the latency,
     median of 5, of the defaults and method 6, as RGBA and as RGB, with
     the host split (yuv, dense, emit, alph); then on a 255x193 crop
     autofilter (recon_filter_mb once a trial level), plane_backend
     "jax-openloop" (encode_luma and encode_chroma once each), "jax",
     method 6 and target_psnr, each == device="cpu"; every file decoded by
     the port and by Pillow to the same pixels, alpha == the source's;
     encode_yuv with alpha and a mixed non-opaque batch, GPU == CPU;
  8d. the lossless encode: corpus image 12 as RGB (1024x1024, the
     smallest size that takes the device chooser) through
     encode_rgba(lossless=True, device="cuda"), counters reset just before
     and read just after: predictor_search_entropy launches (2 calls at
     q75 method 4) and no other kernel; its bytes == the device="cpu"
     file made with GOWEBP_TPU_VP8L_ANALYSIS=1 (the plain version), and
     at most 1.005x the host chooser's file (device="cpu", no switch);
     decoded by the port and by Pillow to the source; the latency, median
     of 3, split into the choosers (device, wall and summed thread time),
     the spatial stream, and the rest of the transform trials; then once
     each: the image as RGBA with phase 8c's soft alpha and exact=True
     (round trip), method 6 at q95 (6 chooser calls, timed) and
     near_lossless=60 (the port's decode == Pillow's);
  10. (run after 8d) parallel/: the sharded steps' inputs at full size
     (B=32 1024x1024 planes and decode symbols, one 4096x4096 image and
     its hybrid file, 8 lossless images at bits 4); each halo or stripe
     form against its plain version run on the same card tensors and the
     joined shards against its kernel's unsharded form (the plain
     versions' seconds and each form's device ms beside the no-halo
     form's on the same shard printed), predictor_inverse
     against its plain version and the source words, and at B=1
     4096x4096 (the 4x4 mosaic) against its source words (both timed:
     ms, device_ms, us a step, share of bound); the five sharded steps in a one-rank NCCL job
     (counts reset just before and read just after, as the "parallel"
     path: every kernel of the path must launch) and in a two-rank gloo
     job on cuda:0 (halos staged through host memory, the bytes
     printed), whose full tensors must equal the unsharded calls';
  11. (run after 10) containers, animation, the CLI: a lossy q75
     animation of 8 opaque 1024x1024 frames (a 256x256 patch of image 1
     moving over image 0, one repeat, one full-frame change) through
     AnimationEncoder(kmin=2, kmax=4, device="cuda") (counts reset just
     before: only wavefront_search, once a candidate encode) and
     decode_animation(device="cuda") (unpack_coeffs, recon_filter_mb and
     yuv420_to_rgba once a lossy shape group, nothing else); every
     canvas == Pillow's and >= 20 dB against its source; offsets,
     durations (the repeat merged) and loop count as built; a lossless
     animation (a 1 MP keyframe and two small deltas): the chooser
     kernel launches on its 1 MP candidate encodes alone, the decode on
     none, canvases == the sources == Pillow's, bytes == the CPU file
     with the plain chooser at 1 MP (the "animation" path's counts read
     here); a 256x192 crop of the lossy frames and a 128x96 soft-alpha
     case, bytes and canvases == device="cpu"; Mux.from_bytes round
     trip, with ICC/EXIF/XMP read by Pillow; the CLI in process with
     its default device ("cli" path: encode of a 1 MP PNG launches
     wavefront_search once and recon_filter_mb once for EncodeStats'
     PSNR, bytes == encode_rgba's; decode == decode()'s; info JSON);
     bit_accounting on a phase-4 file and the 8d file (classes within
     total_bits, partitions summing to residuals); the times: encode and
     decode ms a frame, CLI encode and decode ms;
  9. the kernels' JSON line (each kernel's launches on its own path, and
     on every path driven in ``launches_by_path``; ``ms`` one call alone
     and ``device_ms`` the device time of a launch, both from phase 3),
     the card line, and the final result line.

Needs a CUDA GPU, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and g++.
Imports nothing of JAX or of the gowebp_tpu package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# HBM bandwidth of one H100 SXM at its full 700 W (NVIDIA data sheet).
# The ceiling of the kernels' 32-bit integer operations is computed from
# the card (int32_peak): an H100 SM issues 64 int32 operations a clock,
# half its 128 FP32 lanes (NVIDIA's Hopper architecture whitepaper, SM
# table).
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64

# Integer operations per 4x4 step, counted from ops/kernels/vp8_dsp.cuh
# and the kernels (adds, multiplies, shifts, compares, clamps).
OPS_FDCT, OPS_IDCT, OPS_QUANT, OPS_DEQUANT = 160, 164, 96, 16
OPS_PRED_I16, OPS_PRED_B4 = 32, 80
OPS_RES_RECON = 16 + 48
OPS_RATE_POS, OPS_RATE_EOB, OPS_DIST_COST = 10, 5, 60
# The trellis form's DP, counted as the serial DP's work (ops/rate.py
# trellis_refine; the same whatever implements it, so i4_lanes.cuh
# trellis_lanes' scan adds nothing), per block position walked (its level
# load, the state's table row and run rate, the backtrack step) and per
# non-zero position (two candidates from two states: their distortions,
# rates and int64 sums, counted as two operations each, the compares and
# selects).
OPS_TRELLIS_POS, OPS_TRELLIS_NZ = 18, 60
# top-k ranking, per candidate: the prediction's SSE (a subtract, a
# multiply and an add per pixel) and 10 compare-and-count steps
OPS_PRED_SSE, OPS_RANK = 48, 40
# yuv420_to_rgba, per output pixel (ops/kernels/yuv420_to_rgba.cu): a
# quarter of a 2x2 quad's 18 chroma loads and 8 upsample taps (~10 ops
# each), ~26 for the BT.601 conversion and clips, the luma load and store.
OPS_YUV_PIXEL = 50
# The i16/UV mode search of wavefront_search, per pixel: the four
# candidates' predictions (TM: add, subtract, two clamps) and squared
# differences (3 each), in scalar int32.
OPS_SEARCH_PX = 16
# encode_luma / encode_chroma (ops/kernels/encode_plane.cu) in the packed
# formulation they run, each dp4a, multiply-add, 16-bit-pair op and byte
# permute counted as one operation.  The search, per 4-pixel row: the TM
# row (the left pixel times 0x10001, two pair adds, a max and a min of
# 16-bit pairs on each pair, one pack: 8), 5 dp4a (s.s, s.1, s.tm,
# tm.tm, s.top) and HE's 2 multiply-adds (left x row sum, left^2).  Per
# 4x4 block: the TM offset pairs (256 - tl, its multiply, two unpacks,
# two adds: 6), the DC context (a dp4a and 3 adds), the row sums (3),
# the four SSEs (11) and the block's share of their sums over the MB
# (4).  Per MB: dc_whole and the first minimum (12).  The modes-only
# forms (encode_luma_modes, encode_chroma_modes: the hybrid's cold
# round) do the search alone.  The code, per 4x4 block: the residual (an
# unpack of the source and of the prediction byte and a subtract, a
# pixel), the FDCT with each multiply fused into its add (OPS_FDCT less
# its 32 multiplies) and OPS_QUANT;
# per luma MB the Y2 path: 16 coefficients of 16 signed adds each, and
# one 16-coefficient quantization.
# The decode's recon and filter kernel (ops/kernels/vp8_recon.cu): the
# recon, per MB: the iDCT and the add-and-clip of its 24 blocks, the luma
# prediction (16 B-mode blocks of an i4 MB, or 16 whole-block ones of an
# i16 MB) and 8 chroma blocks; the loop filter, per pixel line across an
# edge that this data filters (its MB's limit >= 0; MB edges inside the
# frame, inner edges where the MB has them): the complex filter's eight
# threshold tests, the hev test and its widest branch, or the simple
# filter's test and update.
OPS_FILTER_LINE_COMPLEX, OPS_FILTER_LINE_SIMPLE = 48, 20
OPS_PLANE_SEARCH_BLOCK = 4 * (8 + 5 + 2) + 6 + 4 + 3 + 11 + 4
OPS_PLANE_SEARCH_MB = 12
OPS_PLANE_CODE_BLOCK = 16 * 3 + (OPS_FDCT - 32) + OPS_QUANT
OPS_Y2 = 16 * 16 + OPS_QUANT
# predictor_search_entropy (ops/kernels/vp8l_predictor.cu), per pixel and
# pass: the 14 predictions (modes 0-4 none; an avg2 5 operations: modes
# 5-10 take 2, 1, 1, 1, 1 and 3 of them; Select ~30, the two clamped
# add-subtracts ~36 and ~41) and the 14 residuals' byte-wise subtractions
# (8 each); then stage 1's 56 increments, each with its delta (a table
# read and an add: 2), and a round's 56 lookups (a table read and an add).
# The kernel shows that work enough: no per-tile sweep.  The sweep design
# (one block a tile, scoring its histograms after counting) needs 56
# increments a pixel and, a tile, 14 x 1024 bins of a table read and a
# multiply-add (2 each) in every pass (OPS_VP8L_SWEEP_*, printed beside).
OPS_VP8L_PREDICT = 9 * 5 + 30 + 36 + 41 + 14 * 8
OPS_VP8L_STAGE1_PIXEL = OPS_VP8L_PREDICT + 56 + 56 * 2
OPS_VP8L_ROUND_PIXEL = OPS_VP8L_PREDICT + 56 * 2
OPS_VP8L_SWEEP_PIXEL = OPS_VP8L_PREDICT + 56
OPS_VP8L_SWEEP_TILE = 14 * 1024 * 2

# The open-loop decode's PSNR floor: 3 dB under the JAX package's
# open-loop minimum (23.512 dB over natural_images(4, 256, 256, seed=7)
# at q75, decoded by libwebp; tests/test_torch_encode_plane.py measures it
# and holds this constant to it).
OPENLOOP_PSNR_FLOOR_DB = 20.5

# The batch decode's kernels, in the order a lossy group launches them;
# the single-file decode uploads dense coefficients and skips the unpack.
DECODE_KERNELS = ("unpack_coeffs", "recon_filter_mb", "yuv420_to_rgba")
SINGLE_DECODE_KERNELS = DECODE_KERNELS[1:]
# unpack_coeffs (ops/kernels/coeff_unpack.cu), per 4x4 block: the level
# loads and sign extensions (16), the 16 multiplies by the quantizer, the
# DC select, the zigzag packing into 8 words (16) and the index math
# (~10); per tail or exception row: its index, up to 16 products or
# copies and scattered stores (~40).
OPS_UNPACK_BLOCK, OPS_UNPACK_ROW = 60, 40

SOURCES = {
    "i4_search": "gowebp_tpu_torch/ops/kernels/i4_search.cu",
    "i4_walk": "gowebp_tpu_torch/ops/kernels/i4_search.cu",
    "wavefront_fixed": "gowebp_tpu_torch/ops/kernels/wavefront_fixed.cu",
    "yuv420_to_rgba": "gowebp_tpu_torch/ops/kernels/yuv420_to_rgba.cu",
    "encode_luma": "gowebp_tpu_torch/ops/kernels/encode_plane.cu",
    "encode_chroma": "gowebp_tpu_torch/ops/kernels/encode_plane.cu",
    "encode_luma_modes": "gowebp_tpu_torch/ops/kernels/encode_plane.cu",
    "encode_chroma_modes": "gowebp_tpu_torch/ops/kernels/encode_plane.cu",
    "wavefront_search": "gowebp_tpu_torch/ops/kernels/wavefront_search.cu",
    "wavefront_search_trellis":
        "gowebp_tpu_torch/ops/kernels/wavefront_search.cu",
    "recon_filter_mb": "gowebp_tpu_torch/ops/kernels/vp8_recon.cu",
    "unpack_coeffs": "gowebp_tpu_torch/ops/kernels/coeff_unpack.cu",
    "predictor_search_entropy":
        "gowebp_tpu_torch/ops/kernels/vp8l_predictor.cu",
    "predictor_inverse": "gowebp_tpu_torch/ops/kernels/vp8l_inverse.cu",
}
REPLACES = {
    "i4_search": "gowebp_tpu/ops/pallas/i4_search.py:286",
    "i4_walk": ("gowebp_tpu/ops/encode_wavefront_jax.py:511 (the walk) and "
                "gowebp_tpu/ops/pallas/i4_search.py:286"),
    "wavefront_fixed": "gowebp_tpu/ops/pallas/wavefront_fixed.py:564",
    "yuv420_to_rgba": "gowebp_tpu/ops/pallas/decode_post.py:162",
    "encode_luma": "gowebp_tpu/ops/pallas/encode_plane.py:322",
    "encode_chroma": "gowebp_tpu/ops/pallas/encode_plane.py:354",
    "encode_luma_modes": ("gowebp_tpu/ops/pallas/encode_plane.py:322 (its "
                          "modes; the hybrid's cold round ran them in XLA, "
                          "gowebp_tpu/ops/encode_wavefront_jax.py:385)"),
    "encode_chroma_modes": ("gowebp_tpu/ops/pallas/encode_plane.py:354 (its "
                            "modes; the hybrid's cold round ran them in XLA, "
                            "gowebp_tpu/ops/encode_wavefront_jax.py:385)"),
    "wavefront_search": ("gowebp_tpu/ops/encode_wavefront_jax.py:616 "
                         "_wavefront_impl (XLA, no pallas_call)"),
    "wavefront_search_trellis": (
        "gowebp_tpu/ops/encode_wavefront_jax.py:616 _wavefront_impl (XLA, "
        "no pallas_call) with the host encoder's method-6 trellis, "
        "gowebp_tpu/entropy/native/vp8_dec.cpp:1899 trellis_refine"),
    "recon_filter_mb": ("gowebp_tpu/ops/vp8_recon_jax.py:512 "
                        "recon_wavefront and :814 loop_filter_wavefront "
                        "(XLA, no pallas_call)"),
    "predictor_search_entropy": ("gowebp_tpu/ops/lossless_jax.py:269 "
                                 "predictor_search_entropy (XLA, no "
                                 "pallas_call)"),
    "unpack_coeffs": ("gowebp_tpu/ops/coeff_pack.py:260 unpack_coeffs (XLA, "
                      "no pallas_call)"),
    "predictor_inverse": ("gowebp_tpu/ops/lossless_jax.py:363 "
                          "predictor_inverse (XLA, no pallas_call), with :39 "
                          "add_green_inverse"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def int32_peak():
    """(int32 operations per second, SMs, max SM clock in MHz) of card 0:
    SMs x INT32_LANES_PER_SM x the max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, reps: int = 50, rounds: int = 5):
    """(device ms of one ``fn()`` launch, host ms to make one call).

    The device time leaves out the host's part of each call: ``reps``
    calls are enqueued while the stream sleeps (torch.cuda._sleep, longer
    than the host takes to enqueue them), so they run back to back; CUDA
    events around them give the mean, and the median of ``rounds`` such
    means is returned (a round the host outlasted the sleep is redone
    with a longer sleep)."""
    import torch

    mhz = int32_peak()[2]
    for _ in range(3):
        fn()
    torch.cuda._sleep(1000)           # loads the sleep kernel
    sleep_ms, means, hosts = 20.0, [], []
    while len(means) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * mhz * 1e3))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if host_ms > 0.8 * sleep_ms:
            sleep_ms = 2 * host_ms
            continue
        means.append(a.elapsed_time(b) / reps)
        hosts.append(host_ms / reps)
    return statistics.median(means), statistics.median(hosts)


def max_abs_err(a: dict, b: dict, keys) -> int:
    import torch

    err = 0
    for k in keys:
        if a[k].shape != b[k].shape:
            raise AssertionError(f"{k}: shape {tuple(a[k].shape)} "
                                 f"vs {tuple(b[k].shape)}")
        d = (a[k].to(torch.int64) - b[k].to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / int32_peak()[0] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quant_rows(deltas):
    """(4, 6) per-segment quantizer steps at q75 with segment deltas."""
    import numpy as np

    from gowebp_tpu_torch.models.vp8.encoder import make_quants, quality_to_q

    base = quality_to_q(75.0)
    rows = []
    for d in deltas:
        q = make_quants(max(0, min(127, base + d)))
        rows.append([q.y1_dc.q, q.y1_ac.q, q.y2_dc.q, q.y2_ac.q,
                     q.uv_dc.q, q.uv_ac.q])
    return np.array(rows, np.int32)


def search_ops(ctx13, src16, quants5, topk=None) -> int:
    """Integer operations of the search of these sub-blocks: every
    candidate predicted, and with ``topk`` ranked, and the candidates
    kept scored, each rate walk as long as its levels need."""
    import torch

    from gowebp_tpu_torch.ops import dct
    from gowebp_tpu_torch.ops.kernels.i4_search import rank_modes
    from gowebp_tpu_torch.ops.vp8_recon import _pred_luma4_all

    S = ctx13.shape[0]
    src = src16.reshape(S, 1, 4, 4)
    preds = _pred_luma4_all(ctx13[:, 0], ctx13[:, 1:5], ctx13[:, 5:9],
                            ctx13[:, 9:13])
    k, ranking = 10, 0
    if topk is not None:
        k, ranking = topk, S * 10 * (OPS_PRED_SSE + OPS_RANK)
        preds = preds[torch.arange(S, device=preds.device)[:, None],
                      rank_modes(preds, src, topk)]
    lv = dct.quantize(dct.fdct4x4(src - preds),
                      quants5[:, 0:1], dct.BIAS["y1_dc"], quants5[:, 1:2],
                      dct.BIAS["y1_ac"])
    idx = torch.arange(16, device=lv.device)
    walked = (torch.where(lv != 0, idx, -1).amax(-1) + 1).sum().item()
    per_cand = (OPS_FDCT + OPS_QUANT + OPS_DEQUANT + OPS_IDCT
                + OPS_RES_RECON + OPS_RATE_EOB + OPS_DIST_COST)
    return (S * 10 * OPS_PRED_B4 + ranking + S * k * per_cand
            + walked * OPS_RATE_POS)


def check_i4_search(dev, inputs):
    """Phase 3a: i4_search kernel vs plain on the cold="dense" round's
    inputs for one chunk of the corpus images (S = 16*65536 sub-blocks),
    with topk None and 4."""
    import torch

    from gowebp_tpu_torch.ops.encode_wavefront import (_per_mb,
                                                       plane_i4_inputs,
                                                       search_penalty)
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_search, i4_search_plain, t3_tables)

    I32 = torch.int32
    y, qs, tables = inputs["y"], inputs["qsteps"], inputs["tables"]
    seg = inputs["seg"].reshape(y.shape[0], -1).long()
    # as openloop_mode_search builds them for the cold round
    args = plane_i4_inputs(
        y, y.to(I32), _per_mb(qs, seg), _per_mb((1 << 17) // qs.clamp_min(1),
                                                seg),
        _per_mb(search_penalty(inputs["pens"]), seg))
    t3 = t3_tables(tables)
    names = ("bmode", "cost", "rec")
    err, times = 0, {}
    for topk in (None, 4):
        got = i4_search(*args, t3, topk=topk)
        want = i4_search_plain(*args, t3, topk=topk)
        torch.cuda.synchronize()
        e = max_abs_err(dict(zip(names, got)), dict(zip(names, want)), names)
        err = max(err, e)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"i4_search kernel != plain at topk={topk} "
                                 f"(max |err| {e})")
        times[topk] = time_ms(lambda: i4_search(*args, t3, topk=topk),
                              reps=20, warmup=3)
        if topk is None:
            plain_ms = time_ms(lambda: i4_search_plain(*args, t3), reps=3)
            outs = got
    # bound: each input read once, each output written once; operations
    # of the candidates, with the rate walk's length taken from this data
    nbytes = sum(a.numel() * a.element_size() for a in args + tuple(t3))
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    bound_ms, bound_by = bound(nbytes, search_ops(*args))
    bound4, by4 = bound(nbytes, search_ops(*args, topk=4))
    log(f"i4_search S={args[0].shape[0]} (cold=\"dense\" inputs): bit-exact "
        f"with topk None and 4; topk=4 {times[4]:.4f} ms (bound {bound4:.4f} "
        f"ms by {by4}), topk=None {times[None]:.4f} ms")
    return {"name": "i4_search", "max_abs_err": err, "ms": times[None],
            "fn": lambda: i4_search(*args, t3), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def wavefront_args(dev, gen, B, H, W, i4_share=0.6):
    """Random planes, 4 segments of q75 quantizers, random i4/i16 modes."""
    import torch

    mh, mw = H // 16, W // 16
    I32, U8 = torch.int32, torch.uint8
    y = torch.randint(0, 256, (B, H, W), generator=gen, dtype=U8)
    u = torch.randint(0, 256, (B, H // 2, W // 2), generator=gen, dtype=U8)
    v = torch.randint(0, 256, (B, H // 2, W // 2), generator=gen, dtype=U8)
    seg = torch.randint(0, 4, (B, mh, mw), generator=gen, dtype=I32)
    qs = torch.from_numpy(quant_rows([-6, -2, 3, 8]))[None].expand(
        B, 4, 6).contiguous()
    ymode = torch.randint(0, 4, (B, mh, mw), generator=gen, dtype=I32)
    uvmode = torch.randint(0, 4, (B, mh, mw), generator=gen, dtype=I32)
    is_i4 = (torch.rand((B, mh, mw), generator=gen) < i4_share).to(I32)
    imodes = torch.randint(0, 10, (B, mh, mw, 16), generator=gen, dtype=I32)
    return tuple(a.to(dev).contiguous() for a in
                 (y, u, v, seg, qs, ymode, uvmode, is_i4, imodes))


WF_KEYS = ("y_levels", "y2_levels", "uv_levels")
WF_RKEYS = ("recon_y", "recon_u", "recon_v")


def check_wavefront(dev, gen):
    """Phase 3b: wavefront_fixed kernel vs plain: B=16 at 1024x1024, odd
    MB grids, more rows than the card holds blocks, repeated runs."""
    import torch

    from gowebp_tpu_torch.ops.kernels.wavefront_fixed import (
        wavefront_fixed, wavefront_fixed_plain)

    def compare(got, want, ks, what):
        e = max_abs_err(got, want, ks)
        if not all(torch.equal(got[k], want[k]) for k in ks):
            raise AssertionError(f"wavefront_fixed kernel != plain ({what}, "
                                 f"max |err| {e})")
        return e

    B, H, W = 16, 1024, 1024
    mh, mw = H // 16, W // 16
    args = wavefront_args(dev, gen, B, H, W)
    err = 0
    plain_ms = None
    for derr in (True, False):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = wavefront_fixed_plain(*args, use_derr=derr, want_recon=True)
        b.record()
        b.synchronize()
        if derr:
            plain_ms = a.elapsed_time(b)
            main_want = want
        for recon in (True, False):
            got = wavefront_fixed(*args, use_derr=derr, want_recon=recon)
            torch.cuda.synchronize()
            err = max(err, compare(got, want, WF_KEYS + (WF_RKEYS if recon
                                                         else ()),
                                   f"derr={derr}, recon={recon}"))
            log(f"wavefront_fixed derr={derr} recon={recon}: bit-exact")
    # the main path's setting three more times: a race would show here
    for i in range(3):
        got = wavefront_fixed(*args, use_derr=True, want_recon=True)
        torch.cuda.synchronize()
        compare(got, main_want, WF_KEYS + WF_RKEYS, f"repeat {i + 1}")
    log("wavefront_fixed: 3 repeated runs identical to plain")
    # odd MB grids, and 8192 rows (far more than the card holds blocks)
    for b_, h_, w_ in ((2, 80, 16), (2, 16, 80), (1, 16, 16), (2, 48, 80),
                       (2, 80, 48), (256, 512, 64)):
        oargs = wavefront_args(dev, gen, b_, h_, w_)
        for derr in (True, False):
            want = wavefront_fixed_plain(*oargs, use_derr=derr,
                                         want_recon=True)
            got = wavefront_fixed(*oargs, use_derr=derr, want_recon=True)
            torch.cuda.synchronize()
            err = max(err, compare(got, want, WF_KEYS + WF_RKEYS,
                                   f"B={b_} {h_}x{w_} derr={derr}"))
        log(f"wavefront_fixed B={b_} {h_}x{w_} ({b_ * h_ // 16} MB rows): "
            f"bit-exact")
    # time the main path's setting (q75: diffusion on), with recon as in
    # the first of the two passes
    ms = time_ms(lambda: wavefront_fixed(*args, use_derr=True,
                                         want_recon=True), reps=5)
    # one image: its chain of (mw - 1) + 2*(mh - 1) + 1 dependent MB steps
    # (one per anti-diagonal) alone
    one = tuple(t[:1].contiguous() for t in args)
    one_ms = time_ms(lambda: wavefront_fixed(*one, use_derr=True,
                                             want_recon=True), reps=5)
    steps = (mw - 1) + 2 * (mh - 1) + 1
    log(f"wavefront_fixed B=1 1024x1024: {one_ms:.3f} ms = "
        f"{one_ms / steps * 1e3:.2f} us per chained MB step ({steps} steps)")
    got = main_want
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += sum(t.numel() * t.element_size() for t in got.values())
    n_mb = B * mh * mw
    n_i4 = int(args[7].sum())
    i16_mb = 16 * (OPS_PRED_I16 + OPS_FDCT + OPS_QUANT + OPS_DEQUANT
                   + OPS_IDCT + OPS_RES_RECON) + 64 + OPS_QUANT + 16 + 72
    i4_mb = 16 * (OPS_PRED_B4 + OPS_FDCT + OPS_QUANT + OPS_DEQUANT
                  + OPS_IDCT + OPS_RES_RECON)
    uv_mb = 8 * (OPS_PRED_I16 + OPS_FDCT + OPS_QUANT + OPS_DEQUANT
                 + OPS_IDCT + OPS_RES_RECON) + 80
    ops = n_i4 * i4_mb + (n_mb - n_i4) * i16_mb + n_mb * uv_mb
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": "wavefront_fixed", "max_abs_err": err, "ms": ms,
            "fn": lambda: wavefront_fixed(*args, use_derr=True,
                                          want_recon=True),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def check_i4_walk(dev, inputs):
    """Phase 3c: i4_walk kernel vs plain on the refine round's inputs for
    one chunk of the corpus images (q75, 4 segments), with context from
    one wavefront_fixed pass over the cold round's modes; timed beside the
    same walk as 16 launches of the flat i4_search with their torch glue."""
    import torch

    from gowebp_tpu_torch.ops.encode_wavefront import (
        encode_wavefront_core, openloop_mode_search, search_penalty)
    from gowebp_tpu_torch.ops.kernels.i4_search import (
        i4_search, i4_search_plain, i4_walk, i4_walk_plain, t3_tables)
    from gowebp_tpu_torch.ops.vp8_recon import mb_context

    I32 = torch.int32
    y, u, v, seg, qs, tables = (inputs[k] for k in ("y", "u", "v", "seg",
                                                    "qsteps", "tables"))
    B, H, W = y.shape
    mh, mw = H // 16, W // 16
    N = mh * mw
    pen = search_penalty(inputs["pens"])
    cold = openloop_mode_search(y, u, v, seg, qs, tables, try_i4=False,
                                i4_penalty=pen)
    recon = encode_wavefront_core(
        y, u, v, seg, qs, want_recon=True, use_derr=inputs["use_derr"],
        modes=tuple(cold[k] for k in ("ymode", "uvmode", "is_i4", "imodes")))
    # the walk's inputs, as openloop_mode_search builds them
    src = y.to(I32).reshape(B, mh, 16, mw, 16).permute(0, 1, 3, 2, 4)
    src = src.reshape(B, N, 16, 16)
    top16, tr4, left16, tl, _, _ = mb_context(recon["recon_y"].to(I32), mh,
                                              mw, 16)
    segl = seg.reshape(B, N).long()
    bidx = torch.arange(B, device=dev)[:, None]
    qlane = qs[bidx, segl].contiguous()
    iqlane = ((1 << 17) // qs.clamp_min(1))[bidx, segl].contiguous()
    pen_n = pen[bidx, segl].contiguous()
    args = (src, top16, tr4, left16, tl, qlane, iqlane, pen_n)
    t3 = t3_tables(tables)
    ops = {None: 0, 4: 0}

    def counted(ctx13, src16, quants5, t3_, topk):
        """The plain search, counting each substep's operations."""
        ops[topk] += search_ops(ctx13, src16, quants5, topk)
        return i4_search_plain(ctx13, src16, quants5, t3_, topk)

    names = ("bmodes", "s4", "recon")
    err, times = 0, {}
    for topk in (None, 4):
        got = i4_walk(*args, t3, want_recon=True, topk=topk)
        want = i4_walk_plain(*args, t3, want_recon=True, topk=topk,
                             search=counted)
        flat = i4_walk_plain(*args, t3, want_recon=True, topk=topk,
                             search=i4_search)
        torch.cuda.synchronize()
        e = max_abs_err(dict(zip(names, got)), dict(zip(names, want)), names)
        err = max(err, e)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"i4_walk kernel != plain at topk={topk} "
                                 f"(max |err| {e})")
        if not all(torch.equal(a, b) for a, b in zip(flat, want)):
            raise AssertionError(f"the walk as 16 flat i4_search launches "
                                 f"!= plain at topk={topk}")
        log(f"i4_walk B={B} {H}x{W} (refine inputs) topk={topk}: bit-exact; "
            f"modes won {torch.bincount(want[0].reshape(-1), minlength=10).tolist()}")
        times[topk] = time_ms(lambda: i4_walk(*args, t3, topk=topk),
                              reps=10, warmup=2)
    ms = times[None]
    plain_ms = time_ms(lambda: i4_walk_plain(*args, t3), reps=2)
    flat_ms = time_ms(lambda: i4_walk_plain(*args, t3, search=i4_search),
                      reps=10, warmup=2)
    log(f"i4_walk: one launch {ms:.3f} ms; the same walk as 16 flat "
        f"i4_search launches with their torch glue {flat_ms:.3f} ms")
    outs = i4_walk(*args, t3)
    nbytes = sum(a.numel() * a.element_size() for a in args + tuple(t3))
    nbytes += sum(o.numel() * o.element_size() for o in outs)
    bound_ms, bound_by = bound(nbytes, ops[None])
    bound4, by4 = bound(nbytes, ops[4])
    log(f"i4_walk topk=4: {times[4]:.3f} ms (bound {bound4:.4f} ms by {by4})")
    return {"name": "i4_walk", "max_abs_err": err, "ms": ms,
            "fn": lambda: i4_walk(*args, t3),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def search_args(dev, rng, y, u, v, pens=()):
    """wavefront_search's inputs for the planes y, u, v: random segments
    of 4 q75 quantizer rows and their penalties, the first ones replaced
    by ``pens``."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.models.vp8.encoder import _i4_config_seg

    B, H, W = y.shape
    rows = quant_rows([-6, -2, 3, 8])
    pen = _i4_config_seg(rows, 4, 0)[1].astype(np.int32)
    pen[:len(pens)] = pens
    arrays = [np.clip(a, 0, 255).astype(np.uint8) for a in (y, u, v)]
    arrays += [rng.integers(0, 4, (B, H // 16, W // 16)).astype(np.int32),
               np.broadcast_to(rows, (B, 4, 6)).astype(np.int32),
               np.broadcast_to(pen, (B, 4)).astype(np.int32)]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def mixed_search_args(dev, rng, B, H, W):
    """search_args on planes whose MBs are noisy, flat or a gentle
    gradient (so both i16 and i4 win; the corpus images adopt i4 nearly
    everywhere)."""
    import numpy as np

    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W]
    kind = rng.integers(0, 3, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    y = np.where(kind == 0, rng.integers(0, 256, (B, H, W)), np.where(
        kind == 1, 128, 60 + 100 * xx / W + 50 * yy / H))
    u = rng.integers(100, 156, (B, H // 2, W // 2))
    v = 128 + rng.integers(-3, 4, (B, H // 2, W // 2))
    return search_args(dev, rng, y, u, v)


def tie_search_args(dev, rng, B, H, W):
    """search_args on tie-heavy planes: flat MBs (one value each) and MBs
    of gentle horizontal, vertical or diagonal gradients, where several
    B-modes predict alike, with penalties of 0 and 1 on two of the 4
    segments, where equal SSEs make equal scores (ties between B-modes,
    and between s4 and s16)."""
    import numpy as np

    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[0:H, 0:W] % 16
    kind = rng.integers(0, 4, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    level = rng.integers(16, 240, (B, mh, mw)).repeat(16, 1).repeat(16, 2)
    y = level + np.select([kind == 1, kind == 2, kind == 3],
                          [xx // 4, yy // 4, (xx + yy) // 8], 0)
    u = np.full((B, H // 2, W // 2), 128)
    v = rng.integers(120, 124, (B, mh, mw)).repeat(8, 1).repeat(8, 2)
    return search_args(dev, rng, y, u, v, pens=(0, 1))


def ptxas_report(log: str, kernel: str):
    """[(function, registers, stack bytes, spill store bytes, spill load
    bytes)] of the functions whose name holds ``kernel``, from nvcc's
    -Xptxas -v output."""
    import re

    rows, name, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and props and kernel in name:
            rows.append((name, int(m.group(1))) + props)
            name = props = None
    return rows


def check_wavefront_search(dev, inputs):
    """Phase 3d: wavefront_search kernel vs plain, bit for bit on every
    output and the recon: B=16 at 1024x1024 on one chunk's real planes,
    segments and penalties, with diffusion and the i4 search on and off;
    the same shape on mixed planes (i16 and i4 MBs); odd MB grids (1x5,
    5x1); tie-heavy planes (flat and gradient MBs, penalties 0 and 1);
    3 repeated runs.  Prints the kernel's ptxas registers, stack and
    spills (none allowed) and its resident blocks.  Timed at the main
    setting (q75: diffusion on, i4 on) beside the plain version."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.ops.kernels.i4_search import i4_search_plain
    from gowebp_tpu_torch.ops.kernels.wavefront_fixed import wavefront_plain
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        LIBRARY, SearchModes, occupancy, search_tables, wavefront_search,
        wavefront_search_plain)

    report = ptxas_report(LIBRARY.ptxas_log, "wavefront_search_kernel")
    if not report:
        log("wavefront_search ptxas: no report (the library was not built "
            "by this process)")
    for name, regs, stack, st, ld in report:
        form = search_form(name)
        log(f"wavefront_search ptxas ({form}): {regs} registers, {stack} "
            f"bytes stack frame, {st} bytes spill stores, {ld} bytes spill "
            f"loads")
        if stack or st or ld:
            raise AssertionError(f"wavefront_search ({form}) uses a stack "
                                 f"frame or spills")
    for try_i4 in (True, False):
        for trellis in (False, True):
            sms, per_sm = occupancy(try_i4, trellis)
            log(f"wavefront_search resident blocks (try_i4={try_i4}, "
                f"trellis={trellis}): {sms} SMs x {per_sm} = "
                f"{sms * per_sm} blocks of 96 threads")

    rate = search_tables(inputs["tables"])
    args = tuple(inputs[k].contiguous()
                 for k in ("y", "u", "v", "seg", "qsteps", "pens"))

    def compare(a, try_i4, derr, what, want=None):
        if want is None:
            want = wavefront_search_plain(*a, rate, try_i4=try_i4,
                                          use_derr=derr, want_recon=True)
        got = wavefront_search(*a, rate, try_i4=try_i4, use_derr=derr,
                               want_recon=True)
        torch.cuda.synchronize()
        e = max_abs_err(got, want, list(want))
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"wavefront_search kernel != plain ({what}, "
                                 f"try_i4={try_i4}, derr={derr}, max |err| "
                                 f"{e})")
        log(f"wavefront_search {what} try_i4={try_i4} derr={derr}: "
            f"bit-exact; i4 MBs {want['is_i4'].float().mean().item():.3f}")
        return e, want

    B, H, W = args[0].shape
    err = 0
    main_want, ops, plain_ms = search_plain_counted(args, rate)
    for try_i4 in (True, False):
        for derr in (True, False):
            e, _ = compare(args, try_i4, derr, f"B={B} {H}x{W} (chunk)",
                           main_want if try_i4 and derr else None)
            err = max(err, e)
    for i in range(3):
        err = max(err, compare(args, True, True, f"repeat {i + 1}",
                               main_want)[0])
    rng = np.random.default_rng(20261017)
    for b_, h_, w_ in ((16, 1024, 1024), (2, 16, 80), (2, 80, 16)):
        margs = mixed_search_args(dev, rng, b_, h_, w_)
        for try_i4, derr in ((True, True), (True, False), (False, True)):
            err = max(err, compare(margs, try_i4, derr,
                                   f"mixed B={b_} {h_}x{w_}")[0])
    for b_, h_, w_ in ((4, 512, 512), (2, 48, 80)):
        targs = tie_search_args(dev, rng, b_, h_, w_)
        for derr in (True, False):
            err = max(err, compare(targs, True, derr,
                                   f"tie-heavy B={b_} {h_}x{w_}")[0])
    ms = time_ms(lambda: wavefront_search(*args, rate, try_i4=True,
                                          use_derr=True, want_recon=True),
                 reps=5)
    lean_ms = time_ms(lambda: wavefront_search(*args, rate, try_i4=False,
                                               use_derr=True,
                                               want_recon=True), reps=5)
    one = tuple(t[:1].contiguous() for t in args)
    one_ms = time_ms(lambda: wavefront_search(*one, rate, try_i4=True,
                                              use_derr=True,
                                              want_recon=True), reps=5)
    mh, mw = H // 16, W // 16
    steps = (mw - 1) + 2 * (mh - 1) + 1
    log(f"wavefront_search B={B} {H}x{W}: {ms:.3f} ms; try_i4=False "
        f"{lean_ms:.3f} ms; B=1 {one_ms:.3f} ms = "
        f"{one_ms / steps * 1e3:.2f} us per chained MB step")
    nbytes = sum(t.numel() * t.element_size() for t in args + rate)
    nbytes += sum(t.numel() * t.element_size() for t in main_want.values())
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": "wavefront_search", "max_abs_err": err, "ms": ms,
            "fn": lambda: wavefront_search(*args, rate, try_i4=True,
                                           use_derr=True, want_recon=True),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def search_form(name: str) -> str:
    """The form of a wavefront_search_kernel instance, from its mangled
    name's template flags (kI4, kTrellis, and kStripe where it is set)."""
    import re

    m = re.search(r"ILb([01])ELb([01])E(?:Lb([01])E)?", name)
    if not m:
        return name
    form = (f"try_i4={'True' if m[1] == '1' else 'False'}, "
            f"trellis={'True' if m[2] == '1' else 'False'}")
    return form + (", stripe=True" if m[3] == "1" else "")


def search_plain_counted(args, rate, lams=None):
    """A plain run of wavefront_search on ``args`` (try_i4, diffusion on,
    recon; the trellis form with ``lams``), and the integer operations
    this data needs of the kernel, counted on it: every walk substep's
    candidates (search_ops, rate walks as long as their levels), the i16
    rate walks, the i16 and uv mode SSEs, the i16 and chroma code of every
    MB, the i4 levels of the adopted ones, and the trellis DPs (every
    block position walked, every non-zero position's transitions).
    Returns (the plain outputs, the operations, the run's ms on CUDA
    events: the plain version's time, counting included; the counters
    read small device sums, a sync each walk substep)."""
    import torch

    from gowebp_tpu_torch.ops.kernels import i4_search as i4m
    from gowebp_tpu_torch.ops.kernels import wavefront_fixed as wfm
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        MODE_KEYS, SearchModes, search_trellis)

    count = {"search": 0, "rate": 0, "trellis": 0}

    def counted(ctx13, src16, quants5, t3_, topk, *lam):
        count["search"] += search_ops(ctx13, src16, quants5, topk)
        return i4m.i4_search_plain(ctx13, src16, quants5, t3_, topk, *lam)

    class Counting(SearchModes):
        def scores(self, mb, sg, src, ctx, q, iq, y_lv, y2_lv, recon16):
            idx = torch.arange(16, device=y_lv.device)
            for lv, first in ((y_lv, 1), (y2_lv, 0)):
                nz = (lv != 0) & (idx >= first)
                last = torch.where(nz, idx, first - 1).amax(-1)
                count["rate"] += int((last + 1 - first).sum())
            return super().scores(mb, sg, src, ctx, q, iq, y_lv, y2_lv,
                                  recon16)

    refine = wfm.trellis_refine

    def counted_refine(lv, cf, *tabs, first, **kw):
        count["trellis"] += (lv.shape[0] * (16 - first) * OPS_TRELLIS_POS
                             + int((lv[:, first:] != 0).sum())
                             * OPS_TRELLIS_NZ)
        return refine(lv, cf, *tabs, first=first, **kw)

    wfm.trellis_refine = i4m.trellis_refine = counted_refine
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        want = wfm.wavefront_plain(
            *args[:5], Counting(args[5], rate, True, search=counted,
                                lams=lams),
            use_derr=True, want_recon=True,
            trellis=search_trellis(rate, lams))
    finally:
        wfm.trellis_refine = i4m.trellis_refine = refine
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    for k in MODE_KEYS:
        want[k] = want[k].to(torch.uint8)
    B, H, W = args[0].shape
    n_mb = B * (H // 16) * (W // 16)
    n_i4 = int(want["is_i4"].sum())
    i16_mb = 16 * (OPS_PRED_I16 + OPS_FDCT + OPS_QUANT + OPS_DEQUANT
                   + OPS_IDCT + OPS_RES_RECON) + 64 + OPS_QUANT + 16 + 72
    uv_mb = 8 * (OPS_PRED_I16 + OPS_FDCT + OPS_QUANT + OPS_DEQUANT
                 + OPS_IDCT + OPS_RES_RECON) + 80
    i4_levels_mb = 16 * (OPS_PRED_B4 + OPS_FDCT + OPS_QUANT)
    modes_mb = (256 + 128) * OPS_SEARCH_PX + 256 * 3 + 17 * OPS_RATE_EOB
    ops = (count["search"] + count["rate"] * OPS_RATE_POS + count["trellis"]
           + n_mb * (i16_mb + uv_mb + modes_mb) + n_i4 * i4_levels_mb)
    return want, ops, plain_ms


def trellis_lambdas(qsteps):
    """The trellis pass's per-segment lambdas, (q_y1ac^2) >> 10 at least
    1 (the host encoder's TRELLIS_LAMBDA_*), of (B, 4, 6) quantizer
    rows."""
    from gowebp_tpu_torch.models.vp8.encoder import (TRELLIS_LAMBDA_NUM,
                                                     TRELLIS_LAMBDA_SHIFT)

    q = qsteps[..., 1]
    return ((TRELLIS_LAMBDA_NUM * q * q) >> TRELLIS_LAMBDA_SHIFT).clamp_min(
        1).to(qsteps.dtype).contiguous()


def first_pass_tables(first, dev):
    """The trellis pass's cost tables: trellis_cost_tables of the
    probabilities finalize_probas adapts to image 0's levels of a first
    (method <= 5) pass, as encode_vp8_frame builds them."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.models.vp8.cost import trellis_cost_tables
    from gowebp_tpu_torch.models.vp8.encoder import (_native_tokenizer_arrays,
                                                     finalize_probas)

    _, mh, mw = first["ymode"].shape
    lv = {k: first[k][0].cpu().numpy() for k in ("y2_levels", "y_levels",
                                                  "uv_levels", "is_i4")}
    st = _native_tokenizer_arrays(lv["y2_levels"], lv["y_levels"],
                                  lv["uv_levels"], lv["is_i4"], mw, mh)
    probs, _ = finalize_probas(st["stats"])
    return tuple(torch.from_numpy(t.astype(np.int32)).to(dev)
                 for t in trellis_cost_tables(probs))


def check_wavefront_search_trellis(dev, inputs):
    """Phase 3d': wavefront_search's trellis form (method 6's second pass)
    vs its plain version, bit for bit on every output and the recon: B=16
    at 1024x1024 on one chunk's real planes, segments, penalties and
    lambdas, the rate tables of image 0's first-pass probabilities; 3
    repeated runs; odd MB grids (1x5, 5x1) and a mixed grid with the i4
    search off.  Timed beside the plain version (its ptxas report is
    phase 3d's)."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search, wavefront_search_plain)

    args = tuple(inputs[k].contiguous()
                 for k in ("y", "u", "v", "seg", "qsteps", "pens"))
    first = wavefront_search(*args, search_tables(inputs["tables"]),
                             try_i4=True, use_derr=True, want_recon=False)
    tables = first_pass_tables(first, dev)
    rate = search_tables(tables, trellis=True)
    lams = trellis_lambdas(args[4])

    def compare(a, lam, try_i4, what, want=None):
        if want is None:
            want = wavefront_search_plain(*a, rate, try_i4=try_i4,
                                          use_derr=True, want_recon=True,
                                          lams=lam)
        got = wavefront_search(*a, rate, try_i4=try_i4, use_derr=True,
                               want_recon=True, lams=lam)
        torch.cuda.synchronize()
        e = max_abs_err(got, want, list(want))
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"wavefront_search trellis form != plain "
                                 f"({what}, try_i4={try_i4}, max |err| {e})")
        log(f"wavefront_search_trellis {what} try_i4={try_i4}: bit-exact; "
            f"i4 MBs {want['is_i4'].float().mean().item():.3f}")
        return e

    B, H, W = args[0].shape
    main_want, ops, plain_ms = search_plain_counted(args, rate, lams)
    moved = sum(int((main_want[k] != first[k]).sum())
                for k in ("y_levels", "uv_levels"))
    log(f"wavefront_search_trellis: {moved} levels differ from the first "
        f"pass's")
    err = 0
    for i in range(3):
        err = max(err, compare(args, lams, True, f"B={B} {H}x{W} (chunk), "
                               f"run {i + 1}", main_want))
    rng = np.random.default_rng(20261018)
    for b_, h_, w_, try_i4 in ((2, 16, 80, True), (2, 80, 16, True),
                               (3, 48, 64, False)):
        margs = mixed_search_args(dev, rng, b_, h_, w_)
        err = max(err, compare(margs, trellis_lambdas(margs[4]), try_i4,
                               f"mixed B={b_} {h_}x{w_}"))

    def run():
        return wavefront_search(*args, rate, try_i4=True, use_derr=True,
                                want_recon=True, lams=lams)

    ms = time_ms(run, reps=5)
    one = tuple(t[:1].contiguous() for t in args)
    one_ms = time_ms(lambda: wavefront_search(
        *one, rate, try_i4=True, use_derr=True, want_recon=True,
        lams=lams[:1].contiguous()), reps=5)
    mh, mw = H // 16, W // 16
    steps = (mw - 1) + 2 * (mh - 1) + 1
    log(f"wavefront_search_trellis B={B} {H}x{W}: {ms:.3f} ms; B=1 "
        f"{one_ms:.3f} ms = {one_ms / steps * 1e3:.2f} us per chained MB "
        f"step")
    nbytes = sum(t.numel() * t.element_size() for t in args + rate)
    nbytes += lams.numel() * lams.element_size()
    nbytes += sum(t.numel() * t.element_size() for t in main_want.values())
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": "wavefront_search_trellis", "max_abs_err": err, "ms": ms,
            "fn": run, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def check_yuv420(dev, gen):
    """Phase 3c: yuv420_to_rgba kernel vs plain on MB-padded planes, fancy
    and nearest (fancy=False) upsampling."""
    import torch

    from gowebp_tpu_torch.ops.kernels.yuv420_to_rgba import (
        yuv420_to_rgba, yuv420_to_rgba_plain)

    U8 = torch.uint8

    def planes(B, H, W, alpha):
        Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
        ps = [torch.randint(0, 256, s, generator=gen, dtype=U8).to(dev)
              for s in ((B, Hp, Wp), (B, Hp // 2, Wp // 2),
                        (B, Hp // 2, Wp // 2))]
        a = (torch.randint(0, 256, (B, H, W), generator=gen, dtype=U8)
             .to(dev) if alpha else None)
        return ps + [H, W, a]

    err = 0
    for B, H, W, alpha, fancy in (
            (16, 1024, 1024, False, True), (16, 1024, 1024, True, True),
            (2, 1021, 1023, False, True), (32, 1024, 1024, False, False),
            (2, 1021, 1023, True, False), (32, 1024, 1024, False, True)):
        args = planes(B, H, W, alpha)
        got = yuv420_to_rgba(*args, fancy=fancy)
        want = yuv420_to_rgba_plain(*args, fancy=fancy)
        torch.cuda.synchronize()
        e = max_abs_err({"rgba": got}, {"rgba": want}, ["rgba"])
        err = max(err, e)
        if not torch.equal(got, want):
            raise AssertionError(f"yuv420_to_rgba kernel != plain at B={B} "
                                 f"{H}x{W} alpha={alpha} fancy={fancy} "
                                 f"(max |err| {e})")
        log(f"yuv420_to_rgba B={B} {H}x{W} alpha={alpha} fancy={fancy}: "
            f"bit-exact")
    # timed at the decode path's shape, the last one checked
    ms = time_ms(lambda: yuv420_to_rgba(*args), reps=20, warmup=3)
    plain_ms = time_ms(lambda: yuv420_to_rgba_plain(*args), reps=3)
    B, H, W = 32, 1024, 1024
    nbytes = B * (H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2)) + 4 * B * H * W
    ops = B * H * W * OPS_YUV_PIXEL
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": "yuv420_to_rgba", "max_abs_err": err, "ms": ms,
            "fn": lambda: yuv420_to_rgba(*args),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def decode_recs(files):
    """The batch decode's records of same-shaped lossy files, as its
    symbol thread makes them: (index, frame header, coefficients, modes,
    filter parameters, None)."""
    from gowebp_tpu_torch.container.riff import parse_riff
    from gowebp_tpu_torch.models.vp8.decoder import (decode_vp8_symbols_batch,
                                                     vp8_filter_params)

    syms = decode_vp8_symbols_batch(
        [parse_riff(d).find(b"VP8 ").payload for d in files])
    return [(i, s, c, m, vp8_filter_params(s, m), None)
            for i, (s, c, m) in enumerate(syms)]


def recon_symbols(dev, files):
    """The single-file decode's recon inputs for same-shaped lossy files:
    the symbol engine's dequantized int16 coefficients, the kernel's
    packed modes and the filter parameters in one dense upload →
    (coeffs, modes, fparams, filter type, mb_w, mb_h)."""
    from gowebp_tpu_torch.decode import _upload
    from gowebp_tpu_torch.ops.kernels.vp8_recon import pack_modes

    recs = decode_recs(files)
    st = recs[0][1]
    coeffs, modes, fp, _ = _upload(recs, dev)
    return (coeffs, pack_modes(modes[..., 0], modes[..., 5:21],
                               modes[..., 1]),
            fp.reshape(len(files), st.mb_h, st.mb_w, 4), st.filter_type,
            st.mb_w, st.mb_h)


def random_symbols(dev, seed, B, mb_h, mb_w):
    """Random recon inputs: i4/i16 mixes (an i4 MB's first B-mode may
    exceed 3), skip MBs, four segments with distinct filter levels (one
    off), inner edges on and off → (coeffs, modes, fparams) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    N = mb_h * mb_w
    coeffs = rng.integers(-300, 301, (B, N, 24, 16)) * (
        rng.random((B, N, 24, 16)) < 0.2)
    coeffs[rng.random((B, N)) < 0.25] = 0
    is_i4 = rng.random((B, N)) < 0.5
    imodes = np.where(is_i4[..., None], rng.integers(0, 10, (B, N, 16)),
                      rng.integers(0, 4, (B, N, 1)))
    modes = np.concatenate([is_i4[..., None], rng.integers(0, 4, (B, N, 1)),
                            imodes], -1).astype(np.uint8)
    seg = rng.integers(0, 4, (B, N))
    table = np.array([[-1, 0, 0], [2 * 10 + 5, 5, 0], [2 * 30 + 3, 3, 1],
                      [2 * 50 + 9, 9, 2]])
    fp = np.concatenate([table[seg], rng.integers(0, 2, (B, N, 1))], -1)
    return (torch.from_numpy(coeffs.astype(np.int16)).to(dev),
            torch.from_numpy(modes).to(dev),
            torch.from_numpy(fp.astype(np.int16)).reshape(
                B, mb_h, mb_w, 4).to(dev))


def coeff_case(seed, B, mb_h, mb_w, exceptions: bool = True):
    """Synthetic decode coefficients for the pack: level times quantizer
    in zigzag order, ~15% of positions non-zero, levels up to 140 in
    magnitude (past int8), per-image quantizers of 4-200 (the products
    fit int16, as the symbol engine stores them), random segments and i4
    flags (the i16 MBs' luma DC lanes arbitrary, as inverse-WHT outputs
    are) and, with ``exceptions``, 1% of coefficients off by one (a
    non-exact division) → (coeffs (B, N, 24, 16) int16, seg, is_i4 (B,
    N), qmat (B, 4, 6) int32) as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N = mb_h * mb_w
    qmat = rng.integers(4, 201, (B, 4, 6)).astype(np.int32)
    seg = rng.integers(0, 4, (B, N)).astype(np.uint8)
    is_i4 = rng.integers(0, 2, (B, N)).astype(np.uint8)
    lv = rng.integers(-140, 141, (B, N, 24, 16)) * (
        rng.random((B, N, 24, 16)) < 0.15)
    luma = np.arange(24)[:, None] < 16
    col = np.where(luma, np.where(np.arange(16) == 0, 0, 1),
                   np.where(np.arange(16) == 0, 4, 5))
    zz = lv * qmat[np.arange(B)[:, None, None, None],
                   seg[:, :, None, None].astype(np.int64), col[None, None]]
    coeffs = np.zeros_like(zz)
    coeffs[..., [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]] = zz
    i16 = (is_i4 == 0)[:, :, None]
    coeffs[:, :, :16, 0] = np.where(
        i16, rng.integers(-2000, 2001, (B, N, 16)), coeffs[:, :, :16, 0])
    if exceptions:
        coeffs += rng.random(coeffs.shape) < 0.01
    return (coeffs.astype(np.int16), seg, is_i4, qmat)


# (kind, B, N) of unpack_case: B * N * 24 a multiple of the kernel's 768
# blocks a CTA (3 x 64) or not (2 x 37), one MB (1 x 1), a large batch.
UNPACK_CASES = (("none", 2, 37), ("all", 2, 37), ("edges", 2, 37),
                ("edges", 3, 64), ("ends", 1, 1), ("ends", 2, 37),
                ("random", 4, 4096))


def unpack_case(kind, K, B, N, seed):
    """A packed dict for ``unpack_coeffs`` made directly, not by a pack,
    whose tables put rows where the kernel's CTA ranges (``BLOCKS_PER_CTA``
    blocks) meet, as numpy arrays.  ``kind``: "none" (no table rows),
    "all" (a tail row for every block, exceptions at the range edges),
    "edges" (tails and exceptions on the first and last block of every
    range), "ends" (rows only on the batch's first and last blocks, the
    last by index -1; the first block takes both), "random" (30% tailed,
    2% exceptions).  Levels, tail levels, DC lanes and exception rows are
    random, segment ids run to 5 (above 3 takes segment 0's row) and
    quantizers to 2047, so products pass int16 (the cut).  At K=16 the
    tail rows are there and ignored, as the reference ignores them."""
    import numpy as np

    from gowebp_tpu_torch.ops.kernels.coeff_unpack import BLOCKS_PER_CTA

    rng = np.random.default_rng(seed)
    nb = B * N * 24
    starts = np.arange(0, nb, BLOCKS_PER_CTA)
    edges = np.unique(np.concatenate([starts, starts - 1, [nb - 1]]))
    edges = edges[(edges >= 0) & (edges < nb)]
    ends = np.array(sorted({0, nb - 1}))
    blocks = np.arange(nb)
    tails, excs = {
        "none": (blocks[:0], blocks[:0]),
        "all": (blocks, edges),
        "edges": (edges, edges),
        "ends": (ends, ends[:1]),
        "random": (blocks[rng.random(nb) < 0.3],
                   blocks[rng.random(nb) < 0.02]),
    }[kind]
    tail_idx = tails.astype(np.int32)
    if kind == "ends":
        tail_idx[-1] -= nb                     # the last block as -1
    tw = max(1, 16 - K)
    return {
        "lv8": rng.integers(-128, 128, (B, N, 24, K)).astype(np.int8),
        "dc16": rng.integers(-2 ** 15, 2 ** 15, (B, N, 16)).astype(np.int16),
        "tail_idx": tail_idx,
        "tail_val": rng.integers(-128, 128, (len(tails), tw)).astype(np.int8),
        "exc_idx": excs.astype(np.int32),
        "exc_val": rng.integers(-2 ** 15, 2 ** 15,
                                (len(excs), 16)).astype(np.int16),
        "seg": rng.integers(0, 6, (B, N)).astype(np.uint8),
        "is_i4": rng.integers(0, 2, (B, N)).astype(np.uint8),
        "qmat": rng.integers(1, 2048, (B, 4, 6)).astype(np.int32),
    }


def filter_lines(fparams, filter_type: int) -> int:
    """Pixel lines across an edge that this data filters: per MB with
    limit >= 0, its left and top MB edges inside the frame and, where it
    has them, its inner edges (3 + 3 luma; 1 + 1 a chroma plane)."""
    B, mb_h, mb_w = fparams.shape[:3]
    fp = fparams.to("cpu").long()
    on = fp[..., 0] >= 0
    inner = on & (fp[..., 3] > 0)
    left = on.clone()
    left[:, :, 0] = False
    top = on.clone()
    top[:, 0, :] = False
    mb_edges = int(left.sum() + top.sum())
    inner_n = int(inner.sum())
    lines = 16 * (mb_edges + 6 * inner_n)
    if filter_type == 2:
        lines += 2 * 8 * (mb_edges + 2 * inner_n)
    return lines


def check_vp8_recon(dev, files):
    """Phase 3g: recon_filter_mb vs its plain version (ops/vp8_recon.py's
    recon_wavefront, then loop_filter_wavefront over the whole frame), bit
    for bit: B=32 1024x1024 on the decode path's inputs for 32 real files, filter types
    0, 1 and 2, 3 repeated runs; random i4/i16 mixes with skip MBs and four
    segments of distinct levels on odd MB grids (1x5, 5x1, 1x1, 3x5) and
    B=256 at 512x64 (8,192 MB rows); the ptxas report; the kernel timed at
    B=32 and alone on one image (the chain)."""
    import torch

    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr

    err = 0

    def check(coeffs, modes, fp, mb_w, mb_h, filter_types, what):
        nonlocal err
        planes = kvr.recon_mb_plain(coeffs, modes, mb_w, mb_h)
        for ft in filter_types:
            want = kvr.loop_filter_mb_plain(*(p.clone() for p in planes), fp,
                                            mb_w, mb_h, ft)
            before = kvr.recon_filter_mb.launches
            got = kvr.recon_filter_mb(coeffs, modes, fp, mb_w, mb_h, ft)
            torch.cuda.synchronize()
            if kvr.recon_filter_mb.launches != before + 1:
                raise AssertionError("recon_filter_mb: not one launch")
            e = max_abs_err(dict(zip("yuv", got)), dict(zip("yuv", want)),
                            "yuv")
            err = max(err, e)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"recon_filter_mb != plain ({what}, filter {ft}, "
                    f"max |err| {e})")
        log(f"recon_filter_mb {what}, filter types {list(filter_types)}: "
            f"bit-exact")

    coeffs, modes, fp, ftype, mw, mh = recon_symbols(dev, files)
    B = coeffs.shape[0]
    args = (coeffs, modes, fp, mw, mh, ftype)
    check(coeffs, modes, fp, mw, mh, (0, 1, 2),
          f"B={B} {16 * mh}x{16 * mw} (the decode's files, filter type "
          f"{ftype})")
    first = kvr.recon_filter_mb(*args)
    for i in range(3):
        again = kvr.recon_filter_mb(*args)
        if not all(torch.equal(a, b) for a, b in zip(again, first)):
            raise AssertionError(f"recon_filter_mb repeat {i + 1} differs")
    log("recon_filter_mb: 3 repeated runs identical")
    for seed, (b_, h_, w_) in enumerate(((4, 16, 16), (2, 1, 5), (2, 5, 1),
                                        (2, 1, 1), (2, 3, 5),
                                        (256, 32, 4))):
        check(*random_symbols(dev, seed, b_, h_, w_), w_, h_, (0, 1, 2),
              f"random B={b_} {16 * h_}x{16 * w_} ({b_ * h_} MB rows)")

    for fn, regs, stack, st_, ld_ in ptxas_report(kvr.LIBRARY.ptxas_log,
                                                  "recon_filter_mb"):
        log(f"ptxas {fn}: {regs} registers, {stack} bytes stack, "
            f"{st_}/{ld_} bytes spill stores/loads")
        if stack or st_ or ld_:
            raise AssertionError("recon_filter_mb: a stack frame or spills")

    # time at the decode path's shape, and alone on one image
    n_mb = B * mh * mw
    n_i4 = int((modes[..., 0] > 0).sum())
    plane_bytes = n_mb * 384
    recon_ops = (n_mb * (24 * (OPS_IDCT + OPS_RES_RECON) + 8 * OPS_PRED_I16)
                 + n_i4 * 16 * OPS_PRED_B4 + (n_mb - n_i4) * 16 * OPS_PRED_I16)
    filter_ops = filter_lines(fp, ftype) * (
        OPS_FILTER_LINE_COMPLEX if ftype == 2 else OPS_FILTER_LINE_SIMPLE)
    nbytes = coeffs.numel() * 2 + modes.numel() + fp.numel() * 2 + plane_bytes
    ms = time_ms(lambda: kvr.recon_filter_mb(*args), reps=10, warmup=2)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    kvr.recon_filter_mb_plain(*args)
    t1.record()
    t1.synchronize()
    bound_ms, bound_by = bound(nbytes, recon_ops + filter_ops)
    log(f"recon_filter_mb bound at B={B}: "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms by bytes ({nbytes} bytes), "
        f"{(recon_ops + filter_ops) / int32_peak()[0] * 1e3:.4f} ms by "
        f"operations ({recon_ops} recon + {filter_ops} filter int32 "
        f"operations)")
    one = (coeffs[:1], modes[:1], fp[:1], mw, mh, ftype)
    steps = (mw - 1) + 2 * (mh - 1) + 1
    b32 = queued_ms(lambda: kvr.recon_filter_mb(*args), reps=20)[0]
    one_ms = time_ms(lambda: kvr.recon_filter_mb(*one), reps=5, warmup=2)
    log(f"recon_filter_mb: B={B} {b32:.4f} ms a launch on the device; B=1 "
        f"{16 * mh}x{16 * mw}: {one_ms:.3f} ms = "
        f"{one_ms / steps * 1e3:.2f} us per chained MB step ({steps} steps)")
    return [{"name": "recon_filter_mb", "max_abs_err": err, "ms": ms,
             "fn": lambda: kvr.recon_filter_mb(*args),
             "plain_ms": t0.elapsed_time(t1), "bound_ms": bound_ms,
             "bound_by": bound_by}]


@contextlib.contextmanager
def forced_k(K):
    """The pack's K choice forced to ``K`` (None: its own)."""
    from gowebp_tpu_torch.ops import coeff_pack

    real = coeff_pack._choose_k
    if K is not None:
        coeff_pack._choose_k = lambda *a: K
    try:
        yield
    finally:
        coeff_pack._choose_k = real


def smooth_images(n, h, w, seed):
    """Smooth RGB images (low-order surfaces, a soft noise): at q95 most
    blocks end before their 4th zigzag level, the K choice's other end."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for _ in range(n):
        a = rng.uniform(-1, 1, (3, 6))
        rgb = [128 + 80 * (c[0] * xx + c[1] * yy + c[2] * xx * yy
                           + c[3] * np.sin(3 * xx + c[4]) * np.cos(2 * yy
                                                                  + c[5]))
               for c in a]
        img = np.stack(rgb, -1) + rng.normal(0, 1.5, (h, w, 3))
        out.append(img.clip(0, 255).astype(np.uint8))
    return out


def upload_ms(dev, fn, reps: int = 5) -> float:
    """Median host ms of ``fn()`` (a group's upload: its host buffer's
    fill and the h2d copy), the stream synchronized around it."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def k_costs(dev, recs, label: str, tag: str) -> dict:
    """For the K choice: at K = 4, 8 and 16 (and the pack's own), the
    group's h2d bytes and ms (``_upload_packed``: fill and copy), its
    table rows, the pack's host ms and the unpack's device ms; the dense
    upload (``_upload``) beside them."""
    from gowebp_tpu_torch.decode import _pack_group, _upload, _upload_packed
    from gowebp_tpu_torch.ops.kernels import coeff_unpack as cum

    B = len(recs)
    out = {}
    for K in (4, 8, 16, None):
        with forced_k(K):
            t0 = time.perf_counter()
            packed, k = _pack_group(recs)
            pack_ms = (time.perf_counter() - t0) * 1e3
        wire, *_, nbytes = _upload_packed(recs, packed, dev)
        rows = len(packed["tail_idx"]) + len(packed["exc_idx"])
        h2d = upload_ms(dev, lambda p=packed: _upload_packed(recs, p, dev))
        dms = queued_ms(lambda w=wire: cum.unpack_coeffs(w), reps=20)[0]
        name = "auto" if K is None else K
        out[name] = {"K": k, "h2d_bytes": nbytes, "h2d_ms": h2d,
                     "unpack_device_ms": dms, "rows": rows,
                     "tail_rows": len(packed["tail_idx"]),
                     "exc_rows": len(packed["exc_idx"]), "pack_ms": pack_ms}
        log(f"K choice, {label} (B={B}): K={name} (packed at K={k}): h2d "
            f"{nbytes} bytes in {h2d:.3f} ms, {rows} table rows "
            f"({len(packed['tail_idx'])} tail, {len(packed['exc_idx'])} "
            f"exception), unpack {dms:.4f} ms on the device, pack "
            f"{pack_ms:.1f} ms host (one thread) {tag}")
    views = [v for v in _upload(recs, dev) if v is not None]
    dense_bytes = sum((v.numel() * v.element_size() + 15) // 16 * 16
                      for v in views)
    dense = upload_ms(dev, lambda: _upload(recs, dev))
    out["dense"] = {"h2d_bytes": dense_bytes, "h2d_ms": dense}
    log(f"K choice, {label}: dense upload {dense_bytes} bytes in "
        f"{dense:.3f} ms {tag}")
    return out


def check_unpack(dev, files, tag):
    """Phase 3i: unpack_coeffs vs unpack_coeffs_plain and the dense
    coefficients, bit for bit: the 32 files' symbols at K = 4, 8, 16 and
    the chosen K; 4 files at q100 (exception rows: levels past int8) and
    16 smooth files at q95; synthetic coefficients with non-exact
    divisions at B=4 1024x1024 and on odd grids; ``unpack_case``'s tables
    at the kernel's CTA edges against the plain version; each call one
    kernel launch (the wrapper's count and the library's); the ptxas
    report; timed on the 32 files at the chosen K; the K choice's costs
    on the 32 files and the q95 set, and a tail row's cost (K=4 with and
    without its tail rows).  → (kernel rows, the 32 files' records, their
    pack at the chosen K, the costs)."""
    import re

    import numpy as np
    import torch

    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.decode import _pack_group
    from gowebp_tpu_torch.ops import coeff_pack
    from gowebp_tpu_torch.ops.kernels import coeff_unpack as cum
    from gowebp_tpu_torch.utils.corpus import natural_images

    err = 0

    lib = cum.LIBRARY.load()

    def check(packed, dense, what):
        """``dense`` None: against the plain version alone."""
        nonlocal err
        wire = {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
        before = (cum.unpack_coeffs.launches,
                  lib.unpack_coeffs_kernel_launches())
        got = cum.unpack_coeffs(wire)
        torch.cuda.synchronize()
        if (cum.unpack_coeffs.launches - before[0],
                lib.unpack_coeffs_kernel_launches() - before[1]) != (1, 1):
            raise AssertionError("unpack_coeffs: not one kernel launch")
        plain = cum.unpack_coeffs_plain(wire)
        e = max_abs_err({"c": got}, {"c": plain}, "c")
        err = max(err, e)
        same = torch.equal(got, plain) and (dense is None or torch.equal(
            got, torch.from_numpy(np.ascontiguousarray(dense)).to(dev)))
        if not same:
            raise AssertionError(f"unpack_coeffs != plain or dense ({what}, "
                                 f"max |err| {e})")
        log(f"unpack_coeffs {what}: bit-exact ({len(packed['tail_idx'])} "
            f"tail, {len(packed['exc_idx'])} exception rows)")
        return wire

    recs = decode_recs(files)
    dense = np.stack([r[2] for r in recs])
    for K in (4, 8, 16):
        with forced_k(K):
            check(_pack_group(recs)[0], dense,
                  f"B={len(recs)} 1024x1024 hybrid files, K={K}")
    packed, chosen_k = _pack_group(recs)
    wire = check(packed, dense,
                 f"B={len(recs)} hybrid files, chosen K={chosen_k}")

    t0 = time.perf_counter()
    q100 = encode_rgba_batch(list(natural_images(4, 1024, 1024, seed=11)),
                             quality=100.0, device="cuda")
    smooth = encode_rgba_batch(smooth_images(16, 1024, 1024, 5),
                               quality=95.0, device="cuda")
    log(f"unpack sets: 4 q100 and 16 smooth q95 files of 1024x1024 encoded "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    for label, group in (("q100", decode_recs(q100)),
                         ("smooth q95", decode_recs(smooth))):
        d = np.stack([r[2] for r in group])
        for K in (4, 8, 16, None):
            with forced_k(K):
                p, k = _pack_group(group)
            check(p, d, f"B={len(group)} {label} files, K={k}"
                  + (" (chosen)" if K is None else ""))
            if label == "q100" and len(p["exc_idx"]) == 0:
                raise AssertionError("the q100 files gave no exception row")
    for seed, (b_, h_, w_) in enumerate(((4, 64, 64), (2, 1, 5), (2, 5, 1),
                                        (2, 1, 1))):
        case = coeff_case(40 + seed, b_, h_, w_)
        for K in (4, 8, 16):
            with forced_k(K):
                p, _ = coeff_pack.pack_coeffs(*case)
            check(p, case[0], f"synthetic B={b_} {16 * h_}x{16 * w_}, K={K}")
    for seed, (kind, b_, n_) in enumerate(UNPACK_CASES):
        for K in (4, 8, 16):
            check(unpack_case(kind, K, b_, n_, seed), None,
                  f"table case {kind!r} B={b_} N={n_} ({b_ * n_ * 24} "
                  f"blocks), K={K}")

    smem = re.findall(r"Compiling entry function '(\S*unpack_\S*)'.*?"
                      r"Used \d+ registers.*?(\d+) bytes smem",
                      cum.LIBRARY.ptxas_log, re.S)
    for fn, regs, stack, st_, ld_ in ptxas_report(cum.LIBRARY.ptxas_log,
                                                  "unpack_"):
        shared = dict(smem).get(fn, "?")
        log(f"ptxas {fn}: {regs} registers, {shared} bytes shared, {stack} "
            f"bytes stack, {st_}/{ld_} bytes spill stores/loads")
        if stack or st_ or ld_:
            raise AssertionError("unpack_coeffs: a stack frame or spills")

    costs = {"hybrid": k_costs(dev, recs, "32 hybrid files", tag),
             "smooth_q95": k_costs(dev, decode_recs(smooth),
                                   "16 smooth q95 files", tag)}
    # a tail row's cost: the K=4 pack against itself with no tail rows
    with forced_k(4):
        p4 = {k: torch.from_numpy(v).to(dev)
              for k, v in _pack_group(recs)[0].items()}
    bare = dict(p4, tail_idx=p4["tail_idx"][:0], tail_val=p4["tail_val"][:0])
    full_ms = queued_ms(lambda: cum.unpack_coeffs(p4), reps=20)[0]
    bare_ms = queued_ms(lambda: cum.unpack_coeffs(bare), reps=20)[0]
    ntail = len(p4["tail_idx"])
    costs["hybrid"]["tail_row_ns"] = (full_ms - bare_ms) * 1e6 / ntail
    log(f"unpack_coeffs, 32 hybrid files at K=4: {full_ms:.4f} ms on the "
        f"device with its {ntail} tail rows, {bare_ms:.4f} ms without them: "
        f"{costs['hybrid']['tail_row_ns']:.4f} ns a tail row {tag}")
    B, N = dense.shape[:2]
    rows = len(packed["tail_idx"]) + len(packed["exc_idx"])
    nbytes = sum(t.numel() * t.element_size() for t in wire.values()) \
        + B * N * 768
    ops = B * N * 24 * OPS_UNPACK_BLOCK + rows * OPS_UNPACK_ROW
    bound_ms, bound_by = bound(nbytes, ops)
    ms = time_ms(lambda: cum.unpack_coeffs(wire), reps=20, warmup=2)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cum.unpack_coeffs_plain(wire)
    t1.record()
    t1.synchronize()
    log(f"unpack_coeffs bound at B={B}, K={chosen_k}: "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms by bytes ({nbytes} bytes: "
        f"the packed buffers read once, 768 a MB written), "
        f"{ops / int32_peak()[0] * 1e3:.4f} ms by operations ({ops})")
    return [{"name": "unpack_coeffs", "max_abs_err": err, "ms": ms,
             "fn": lambda: cum.unpack_coeffs(wire),
             "plain_ms": t0.elapsed_time(t1), "bound_ms": bound_ms,
             "bound_by": bound_by}], recs, packed, costs


def plane_quants(quality: float):
    """The open-loop path's (Y1, Y2, UV) kernel quantizer tuples."""
    from gowebp_tpu_torch.models.vp8.encoder import make_quants, quality_to_q

    q = make_quants(quality_to_q(quality))

    def iq(s):
        return (1 << 17) // s.q

    return ((iq(q.y1_dc), 96 << 9, iq(q.y1_ac), 110 << 9),
            (iq(q.y2_dc), 96 << 9, iq(q.y2_ac), 96 << 9),
            (iq(q.uv_dc), 110 << 9, iq(q.uv_ac), 110 << 9))


def check_encode_plane(dev, gen):
    """Phase 3e: encode_luma and encode_chroma, and their modes-only forms
    (the hybrid's cold round), vs plain: B=16 1024x1024 views of one wire
    buffer as the open-loop path lays them out, q75 and q99, odd MB
    grids, and views 1-3 bytes past an aligned address with batch
    strides that are no multiple of 4.  Prints each form's ptxas
    registers, stack and spills (none allowed) and resident warps."""
    import torch

    from gowebp_tpu_torch.ops.kernels import encode_plane as ep

    report = ptxas_report(ep.LIBRARY.ptxas_log, "encode_")
    if not report:
        log("encode_plane ptxas: no report (the library was not built by "
            "this process)")
    for name, regs, stack, st, ld in report:
        form = ("encode_luma" if "luma" in name else "encode_chroma") + (
            "" if "ILb1E" in name else "_modes")
        log(f"{form} ptxas: {regs} registers, {stack} bytes stack frame, "
            f"{st} bytes spill stores, {ld} bytes spill loads")
        if stack or st or ld:
            raise AssertionError(f"{form} uses a stack frame or spills")
    for name in ep.KERNELS:
        sms, per_sm = ep.occupancy(name)
        log(f"{name} resident: {per_sm} blocks of 128 threads an SM = "
            f"{per_sm * 4} warps of 64, {sms * per_sm * 4} warps on "
            f"{sms} SMs")

    def planes(B, H, W, offset=0, pad=0):
        """Views of one uint8 wire buffer, as the pipeline uploads them:
        each image's y|u|v at ``offset`` plus a multiple of the batch
        stride 1.5*H*W + ``pad``."""
        ys, cs = H * W, (H // 2) * (W // 2)
        stride = ys + 2 * cs + pad
        buf = torch.randint(0, 256, (offset + B * stride,), generator=gen,
                            dtype=torch.uint8).to(dev)
        return tuple(buf.as_strided((B, h, w), (stride, w, 1), offset + at)
                     for at, h, w in ((0, H, W), (ys, H // 2, W // 2),
                                      (ys + cs, H // 2, W // 2)))

    def run(y, u, v, quality):
        lq, y2q, cq = plane_quants(quality)
        return {
            "encode_luma": (ep.encode_luma(y, lq, y2q),
                            ep.encode_luma_plain(y, lq, y2q)),
            "encode_chroma": (ep.encode_chroma(u, v, cq),
                              ep.encode_chroma_plain(u, v, cq)),
            "encode_luma_modes": ((ep.encode_luma_modes(y),),
                                  (ep.encode_luma_modes_plain(y),)),
            "encode_chroma_modes": ((ep.encode_chroma_modes(u, v),),
                                    (ep.encode_chroma_modes_plain(u, v),)),
        }

    err = dict.fromkeys(ep.KERNELS, 0)
    for B, H, W, quality, offset, pad in (
            (16, 1024, 1024, 75.0, 0, 0), (16, 1024, 1024, 99.0, 0, 0),
            (2, 48, 80, 75.0, 0, 0), (2, 80, 48, 40.0, 0, 0),
            (3, 48, 272, 75.0, 1, 3), (3, 80, 48, 75.0, 2, 1),
            (4, 64, 96, 99.0, 3, 2), (16, 1024, 1024, 75.0, 1, 1)):
        y, u, v = planes(B, H, W, offset, pad)
        for name, (got, want) in run(y, u, v, quality).items():
            torch.cuda.synchronize()
            keys = [str(i) for i in range(len(got))]
            e = max_abs_err(dict(zip(keys, got)), dict(zip(keys, want)), keys)
            err[name] = max(err[name], e)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} kernel != plain at B={B} "
                                     f"{H}x{W} q{quality} offset {offset} "
                                     f"stride pad {pad} (max |err| {e})")
        log(f"encode_luma, encode_chroma and modes-only forms B={B} {H}x{W} "
            f"q{quality} view offset {offset} batch stride "
            f"{y.stride(0)}: bit-exact")

    # timed at the open-loop path's shape and quantizers (B=16, q75)
    B, H, W = 16, 1024, 1024
    y, u, v = planes(B, H, W)
    lq, y2q, cq = plane_quants(75.0)
    n_mb = B * (H // 16) * (W // 16)
    rows = []
    for name, fn, plain, ins, blocks, code, y2 in (
            ("encode_luma", lambda: ep.encode_luma(y, lq, y2q),
             lambda: ep.encode_luma_plain(y, lq, y2q), (y,), 16, 1, 1),
            ("encode_chroma", lambda: ep.encode_chroma(u, v, cq),
             lambda: ep.encode_chroma_plain(u, v, cq), (u, v), 8, 1, 0),
            ("encode_luma_modes", lambda: (ep.encode_luma_modes(y),),
             lambda: ep.encode_luma_modes_plain(y), (y,), 16, 0, 0),
            ("encode_chroma_modes", lambda: (ep.encode_chroma_modes(u, v),),
             lambda: ep.encode_chroma_modes_plain(u, v), (u, v), 8, 0, 0)):
        ms = time_ms(fn, reps=20, warmup=3)
        plain_ms = time_ms(plain, reps=3)
        nbytes = sum(t.numel() * t.element_size() for t in ins + fn())
        # the modes-only forms: the search alone (code = y2 = 0)
        ops = n_mb * (blocks * (OPS_PLANE_SEARCH_BLOCK
                                + code * OPS_PLANE_CODE_BLOCK)
                      + OPS_PLANE_SEARCH_MB + y2 * OPS_Y2)
        bound_ms, bound_by = bound(nbytes, ops)
        log(f"{name} bound at B={B}: {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} "
            f"ms by bytes ({nbytes} bytes), {ops / int32_peak()[0] * 1e3:.4f}"
            f" ms by operations ({ops} int32 operations)")
        rows.append({"name": name, "max_abs_err": err[name], "ms": ms,
                     "fn": fn, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    return rows


HYBRID_STAGES = ("cold", "wavefront1", "refine", "wavefront2")


def chunk_inputs(dev, images, quality: float = 75.0):
    """encode_hybrid_core's inputs for a chunk of same-shaped RGBA images,
    built by the encode pipeline's own host steps and upload."""
    from gowebp_tpu_torch.models.vp8.encoder import _default_cost_tables
    import torch

    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_setup, hybrid_params, prep_image, split_planes, stack_prepped)

    h, w = images[0].shape[:2]
    setup = encode_setup(quality, h, w)
    flat, segs, rows, pens = stack_prepped(
        [prep_image(im, setup, openloop=False) for im in images])
    y, u, v = split_planes(torch.from_numpy(flat).to(dev), setup["plan"])
    tables, qs, seg, pens = hybrid_params(segs, rows, pens, setup["plan"],
                                          _default_cost_tables(), dev)
    return {"y": y, "u": u, "v": v, "seg": seg, "qsteps": qs, "pens": pens,
            "tables": tables, "use_derr": setup["use_derr"]}


def stage_spans(dev, inputs, reps: int):
    """The hybrid core's stage spans (CUDA events) on one chunk with the
    host quiet: per stage, the median ms of ``reps`` runs after one
    warm-up run."""
    import torch

    from gowebp_tpu_torch.tracing import StageClock
    from gowebp_tpu_torch.ops.encode_wavefront import encode_hybrid_core

    samples = {k: [] for k in HYBRID_STAGES}
    for i in range(reps + 1):
        torch.cuda.synchronize()
        clock = StageClock(dev)
        encode_hybrid_core(inputs["y"], inputs["u"], inputs["v"],
                           inputs["seg"], inputs["qsteps"], inputs["tables"],
                           i4_penalty=inputs["pens"],
                           use_derr=inputs["use_derr"], marks=clock)
        spans = clock.spans_ms()
        if i > 0:
            for k in HYBRID_STAGES:
                samples[k].append(spans[k])
    return {k: statistics.median(v) for k, v in samples.items()}


def check_webp(data: bytes, w: int, h: int) -> None:
    """RIFF/WEBP/VP8 header sanity of one simple lossy file."""
    import struct

    from gowebp_tpu_torch.container.riff import parse_riff, vp8_dimensions

    if data[:4] != b"RIFF" or data[8:16] != b"WEBPVP8 ":
        raise AssertionError("not a simple lossy WebP file")
    if struct.unpack("<I", data[4:8])[0] != len(data) - 8:
        raise AssertionError("RIFF size mismatch")
    chunks = parse_riff(data).chunks
    size = len(chunks[0].payload)
    if len(chunks) != 1 or 20 + size + (size & 1) != len(data):
        raise AssertionError("VP8 chunk size mismatch")
    if vp8_dimensions(chunks[0].payload) != (w, h):
        raise AssertionError(
            f"frame {vp8_dimensions(chunks[0].payload)}, expected {(w, h)}")


def psnr(a, b) -> float:
    """PSNR in dB of two uint8 RGB images."""
    import numpy as np

    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def pillow_rgba(data: bytes):
    """RGBA pixels of one .webp file decoded by Pillow (libwebp)."""
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def mixed_decode_files(images):
    """Phase 6b's non-hybrid files, 1024x1024, written by Pillow (libwebp):
    4 lossy + ALPH files of sources 0-3 (alpha: a smooth radial ramp on
    the even ones, hard-edged shapes of 0 and 255 on the odd ones; full
    alpha quality), and 4 VP8L files of sources 4-7 (two photos, one
    RGBA with the smooth alpha, saved exact, and one <= 256-colour
    palette image)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    h, w = images[0].shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (255 * (1 - np.hypot(yy - h / 2, xx - w / 2) / np.hypot(h, w)
                     * 2)).clip(0, 255).astype(np.uint8)
    hard = np.full((h, w), 255, np.uint8)
    hard[(yy // 128 + xx // 128) % 3 == 0] = 0
    hard[(yy - h / 3) ** 2 + (xx - w / 3) ** 2 < (h / 5) ** 2] = 0

    def save(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", **kw)
        return buf.getvalue()

    jobs = [(np.dstack([images[k], smooth if k % 2 == 0 else hard]),
             {"quality": 75}) for k in range(4)]
    palette = np.asarray(Image.fromarray(images[7]).quantize(256)
                         .convert("RGB"))
    jobs += [(images[4], {"lossless": True}),
             (images[5], {"lossless": True}),
             (np.dstack([images[6], smooth]), {"lossless": True,
                                               "exact": True}),
             (palette, {"lossless": True})]
    with ThreadPoolExecutor(8) as pool:
        files = list(pool.map(lambda job: save(job[0], **job[1]), jobs))
    return files[:4], files[4:]


def single_file_parity_files(images):
    """Phase 6c's files for the CPU parity of the options, 255x193,
    written by Pillow: a photo at q75, a smooth gradient at q95 (uv_quant
    under 12 and flat-chroma MBs: the chroma dither reaches it), a photo
    with a smooth alpha at q75 (ALPH) and one lossless with that alpha."""
    import io

    import numpy as np
    from PIL import Image

    h, w = 193, 255
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = (255 * xx / (w - 1)).astype(np.uint8)
    alpha[:h // 3, :w // 3] = 0
    smooth = np.stack([xx, 2 * yy % 256, (xx + yy) // 2], -1).astype(np.uint8)

    def save(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", **kw)
        return buf.getvalue()

    return {
        "lossy_q75": save(images[8][:h, :w], quality=75),
        "lossy_smooth_q95": save(smooth, quality=95),
        "alph_q75": save(np.dstack([images[10][:h, :w], alpha]), quality=75),
        "vp8l": save(np.dstack([images[11][:h, :w], alpha]), lossless=True,
                     exact=True),
    }


def time_rows(rows, tag: str) -> None:
    """Each kernel row's device time of a launch (``device_ms``), beside
    ``ms`` (one call timed alone, the wrapper's host time included); a
    device time under the kernel's bound fails."""
    for r in rows:
        reps = max(5, min(50, int(20 / r["ms"])))
        r["device_ms"], host_ms = queued_ms(r.pop("fn"), reps=reps)
        log(f"kernel {r['name']}: {r['ms']:.4f} ms a call, "
            f"{r['device_ms']:.4f} ms a launch on the device, the host "
            f"makes a call in {host_ms:.4f} ms {tag}")
        log(f"kernel {r['name']}: bit-exact vs plain; {r['ms']:.3f} ms "
            f"(plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, {r['bound_ms'] / r['device_ms']:.0%} of "
            f"the device time) {tag}")
        if r["device_ms"] < r["bound_ms"]:
            raise AssertionError(
                f"{r['name']}: {r['device_ms']:.4f} ms on the device, under "
                f"its bound of {r['bound_ms']:.4f} ms by {r['bound_by']}: "
                f"the bound counts more than the function needs")


def soft_alpha_image(img):
    """An RGBA image of ``img``'s pixels with a soft radial alpha mask and
    a fully transparent top-left corner (a fifth of each side)."""
    import numpy as np

    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    alpha = (255 * (1 - np.hypot(yy - h / 2, xx - w / 2) / np.hypot(h, w)
                    * 2)).clip(0, 255).astype(np.uint8)
    alpha[: h // 5, : w // 5] = 0
    return np.dstack([img, alpha])


class StageTimer:
    """Host-clock seconds of an encode's stages, summed over the calls made
    inside ``with`` (wrappers around module functions, ``targets``: (module,
    function, stage) triples).  By default the lossy single-image
    encode's: "yuv" (RGB → YUV420), "dense" (the dense phase: upload, the
    kernel, the levels' download), "emit" (token statistics,
    probabilities, headers, emission) and "alph" (the ALPH chunk)."""

    def __init__(self, targets=None):
        from gowebp_tpu_torch.models.vp8 import alpha as alpha_mod
        from gowebp_tpu_torch.models.vp8 import encoder as enc_mod

        self.targets = targets or [(enc_mod, "rgb_to_yuv420", "yuv"),
                                   (enc_mod, "_dense_wavefront", "dense"),
                                   (enc_mod, "emit_frame_arrays", "emit"),
                                   (alpha_mod, "encode_alpha", "alph")]
        self.fresh()

    def fresh(self):
        """Zero the sums and the spans; returns the timer."""
        self.s = {name: 0.0 for _, _, name in self.targets}
        self.spans = {name: [] for _, _, name in self.targets}
        return self

    def wall(self, name: str) -> float:
        """Seconds from the first call of ``name`` to the end of its last
        (its calls may overlap in threads)."""
        sp = self.spans[name]
        return max(b for _, b in sp) - min(a for a, _ in sp) if sp else 0.0

    def __enter__(self):
        self.saved = []
        for mod, attr, name in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    t1 = time.perf_counter()
                    self.s[_name] += t1 - t0
                    self.spans[_name].append((t0, t1))

            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def single_image_encode(dev, images, reset_counts, read_counts, tag):
    """Phase 8c: the single-image encode.  A 1024x1024 RGBA image with a
    soft alpha mask and a fully transparent corner through
    encode_rgba(device="cuda"): the defaults launch wavefront_search once
    and no other kernel, method 6 its method <= 5 form once and its
    trellis form once; GPU bytes == CPU bytes (defaults, and the image as
    RGB at method 6, which launches the same two); latency, median of 5,
    defaults and method 6, as RGBA and as RGB, with the host stage split;
    then the
    options on a 255x193 crop (autofilter: recon_filter_mb once a trial
    level; plane_backend "jax-openloop": the two plane kernels;
    "jax"; method 6; target_psnr; encode_yuv with alpha), each against
    device="cpu"; every file decoded by the port and by Pillow to the same
    pixels, alpha equal to the source's; a mixed batch with a non-opaque
    image on the card against the CPU.  Returns the trellis form's
    launches of the method-6 run."""
    import numpy as np
    import torch

    import gowebp_tpu_torch as T
    from gowebp_tpu_torch.models.vp8.encoder import (filter_level_from_q,
                                                     quality_to_q)

    def only(counts, want, what):
        got = {k: n for k, n in counts.items() if n}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")

    def decodes_right(data, src):
        port = T.decode_rgba(data, device="cuda")
        if not np.array_equal(port, pillow_rgba(data)):
            raise AssertionError("a single-image file decodes to other "
                                 "pixels through Pillow than the port")
        if src.shape[2] == 4 and not np.array_equal(port[..., 3],
                                                    src[..., 3]):
            raise AssertionError("the decoded alpha is not the source's")
        return port

    img = soft_alpha_image(images[12])
    reset_counts()
    t0 = time.perf_counter()
    data = T.encode_rgba(img, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    only(read_counts("single"), {"wavefront_search": 1}, "encode_rgba")
    log(f"single-image encode: 1024x1024 RGBA, first call {first_s * 1e3:.1f}"
        f" ms, {len(data)} bytes {tag}")
    t0 = time.perf_counter()
    if T.encode_rgba(img, device="cpu") != data:
        raise AssertionError("encode_rgba GPU and CPU bytes differ")
    log(f"single-image parity: GPU bytes == CPU bytes (1 MP, defaults; "
        f"the CPU run {time.perf_counter() - t0:.1f} s)")
    reset_counts()
    m6 = T.encode_rgba(img, method=6, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts("single_method6")
    only(counts, {"wavefront_search": 1, "wavefront_search_trellis": 1},
         "encode_rgba(method=6)")
    trellis_launches = counts["wavefront_search_trellis"]
    for d in (data, m6):
        decodes_right(d, img)
    log(f"single-image method 6: {len(m6)} bytes ({len(data)} at method 4); "
        f"both decode by the port == Pillow, alpha == the source's")
    rgb = np.ascontiguousarray(img[..., :3])
    reset_counts()
    rgb6 = T.encode_rgba(rgb, method=6, device="cuda")
    torch.cuda.synchronize()
    only(read_counts("single_rgb_method6"),
         {"wavefront_search": 1, "wavefront_search_trellis": 1},
         "encode_rgba(RGB, method=6)")
    t0 = time.perf_counter()
    if T.encode_rgba(rgb, method=6, device="cpu") != rgb6:
        raise AssertionError("encode_rgba(RGB, method=6) GPU and CPU bytes "
                             "differ")
    decodes_right(rgb6, rgb)
    log(f"single-image parity: GPU bytes == CPU bytes (1 MP RGB, method 6; "
        f"the CPU run {time.perf_counter() - t0:.1f} s); {len(rgb6)} bytes, "
        f"decodes by the port == Pillow")

    for name, im, kw in (("RGBA", img, {}), ("RGBA", img, {"method": 6}),
                         ("RGB", rgb, {}), ("RGB", rgb, {"method": 6})):
        total, stages = [], []
        for _ in range(5):
            with StageTimer() as st:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                T.encode_rgba(im, device="cuda", **kw)
                torch.cuda.synchronize()
                total.append((time.perf_counter() - t0) * 1e3)
            stages.append(st.s)
        med = {k: statistics.median(s[k] for s in stages) * 1e3
               for k in stages[0]}
        log(f"single-image latency {name} {kw or 'defaults'}: median of 5 "
            f"{statistics.median(total):.3f} ms (min {min(total):.3f}, max "
            f"{max(total):.3f}); host split (medians): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
            + f" {tag}")

    small = img[:193, :255]
    base = filter_level_from_q(quality_to_q(75.0), 60, 0)
    levels = {0, base // 2, base, min(63, base + base // 2 + 1),
              min(63, 2 * base + 1)}
    for kw, want in (
            ({"autofilter": True}, {"wavefront_search": 1,
                                    "recon_filter_mb": len(levels)}),
            ({"plane_backend": "jax-openloop"},
             {"encode_luma": 1, "encode_chroma": 1}),
            ({"plane_backend": "jax", "segments": 2}, {"wavefront_search": 1}),
            ({"method": 6, "quality": 90},
             {"wavefront_search": 1, "wavefront_search_trellis": 1}),
            ({"target_psnr": 34.0, "passes": 3}, None)):
        cfg = T.EncoderConfig(**kw)
        reset_counts()
        got = T.encode_rgba(small, config=cfg, device="cuda")
        torch.cuda.synchronize()
        counts = {k: n for k, n in read_counts("single_options").items() if n}
        if want is not None:
            only(counts, want, f"encode_rgba({kw})")
        if got != T.encode_rgba(small, config=cfg, device="cpu"):
            raise AssertionError(f"encode_rgba({kw}) GPU and CPU bytes "
                                 f"differ")
        decodes_right(got, small)
        log(f"single-image 255x193 {kw}: GPU bytes == CPU bytes, decodes "
            f"right; launches {counts}")
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (193, 255), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (97, 128), dtype=np.uint8) for _ in "uv")
    if (T.encode_yuv(y, u, v, alpha=small[..., 3], device="cuda")
            != T.encode_yuv(y, u, v, alpha=small[..., 3], device="cpu")):
        raise AssertionError("encode_yuv GPU and CPU bytes differ")
    mixed = [small, images[13][:150, :200], soft_alpha_image(
        images[14][:64, :96])]
    got = T.encode_rgba_batch(mixed, device="cuda")
    if got != T.encode_rgba_batch(mixed, device="cpu"):
        raise AssertionError("a mixed non-opaque batch: GPU and CPU bytes "
                             "differ")
    for d, src in zip(got, mixed):
        decodes_right(d, src)
    log("single-image encode_yuv with alpha and a mixed non-opaque batch of "
        "3: GPU bytes == CPU bytes")
    return trellis_launches


def rgb_words(img):
    """(H, W, 3) uint8 → (H, W) uint32 opaque ARGB words."""
    import numpy as np

    return ((255 << 24) | (img[..., 0].astype(np.uint32) << 16)
            | (img[..., 1].astype(np.uint32) << 8) | img[..., 2]).astype(
                np.uint32)


def rgba_words(img):
    """(H, W, 4) uint8 → (H, W) uint32 ARGB words."""
    import numpy as np

    return (rgb_words(img[..., :3]) & 0xFFFFFF
            | (img[..., 3].astype(np.uint32) << 24)).astype(np.uint32)


def chooser_replay(dev, x, bits: int, refine_iters: int):
    """predictor_search_entropy's launches for ``x`` without its syncs: runs
    the call's passes once through the raw launcher, keeping each round's
    table, and returns (modes, a function that enqueues the same passes
    again, the passes run).  ``replay(first, last)`` enqueues passes first..last-1 only."""
    import torch

    from gowebp_tpu_torch.ops import lossless as L
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm
    from gowebp_tpu_torch.ops.kernels.cuda_build import stream_handle

    lib = vpm.LIBRARY.load()
    h, w = x.shape
    th = (h + (1 << bits) - 1) >> bits
    tw = (w + (1 << bits) - 1) >> bits
    modes = torch.empty((th, tw), dtype=torch.int32, device=dev)
    acc = torch.empty(vpm.ACC_WORDS, dtype=torch.int32, device=dev)

    def launch(tab, refine):
        err = lib.vp8l_predictor_launch(x.data_ptr(), h, w, bits,
                                        tab.data_ptr(), refine,
                                        modes.data_ptr(), acc.data_ptr(),
                                        stream_handle(dev))
        if err:
            raise RuntimeError(f"vp8l_predictor_launch: CUDA error {err}")

    tables = [(vpm.stage1_device_table(dev), 0)]
    launch(*tables[0])
    for r in range(refine_iters):
        a = acc.cpu().numpy()
        if r and a[-1] == 0:
            break
        tables.append((torch.from_numpy(L.refine_table(
            a[:L.BINS], a[L.BINS:L.BINS + L.NUM_MODES], th * tw)).to(dev), 1))
        launch(*tables[-1])
    out = modes.clone()

    def replay(first=0, last=None):
        for tab, refine in tables[first:last]:
            launch(tab, refine)

    return out, replay, len(tables)


def check_vp8l_predictor(dev, img):
    """Phase 3h: predictor_search_entropy vs its plain version, mode maps
    equal: the lossless encode's chooser inputs for ``img`` (its opaque
    ARGB words, with and without subtract-green) at bits 3, 4 and 5 and
    refine_iters 0, 2 and 4; odd sizes with partial edge tiles and
    tie-heavy flat and gradient images, a soft alpha; the ptxas report
    (no stack or spills allowed); timed at the default encode's shape
    (bits 4, refine_iters 2, the subtract-green form: the first of its two
    calls), at bits 3 and 5, and at bits 4 on the soft alpha and the flat
    and gradient planes, each as one call and as device time, stage 1
    apart from a round."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.models.vp8l import transforms_np as tnp
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm

    def words(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
            dev)

    def check(a, bits, iters, what):
        x = words(a)
        got = vpm.predictor_search_entropy(x, bits, iters)
        want = vpm.predictor_search_entropy_plain(x, bits, iters)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"predictor_search_entropy != plain ({what}, bits {bits}, "
                f"refine_iters {iters}: {int((got != want).sum())} tiles)")

    argb = rgb_words(img)
    sg = tnp.subtract_green_forward(argb)
    for name, a in (("image", argb), ("subtract-green", sg)):
        for bits in (3, 4, 5):
            for iters in (0, 2, 4):
                check(a, bits, iters, f"1024x1024 {name}")
    log("predictor_search_entropy: bit-exact vs plain on the 1 MP image "
        "with and without subtract-green, bits 3-5, refine_iters 0/2/4")
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:600, 0:700]
    cases = {
        "1023x769 crop": argb[:1023, :769],
        "1x4096": rng.integers(0, 2**32, (1, 4096), dtype=np.uint64),
        "4096x1": rng.integers(0, 2**32, (4096, 1), dtype=np.uint64),
        "flat 600x700": np.full((600, 700), 0xFF7F7F7F, np.uint64),
        "gradient 600x700": (0xFF000000 | ((xx % 256) << 16)
                             | ((yy % 256) << 8) | ((xx + yy) % 256)),
        "1024x1024 soft alpha": rgba_words(soft_alpha_image(img)),
    }
    for what, a in cases.items():
        for bits in (3, 4, 5):
            check(a.astype(np.uint32), bits, 2 if bits == 4 else 4, what)
    log(f"predictor_search_entropy: bit-exact vs plain on {', '.join(cases)}")

    for fn, regs, stack, st_, ld_ in ptxas_report(vpm.LIBRARY.ptxas_log,
                                                  "vp8l_predictor_kernel"):
        log(f"ptxas {fn}: {regs} registers, {stack} bytes stack, "
            f"{st_}/{ld_} bytes spill stores/loads")
        if stack or st_ or ld_:
            raise AssertionError("vp8l_predictor_kernel: a stack frame or "
                                 "spills")
    for line in vpm.LIBRARY.ptxas_log.splitlines():
        if "smem" in line:
            log(f"ptxas vp8l_predictor.cu: {line.strip()}")
    log("predictor_search_entropy stage 1: byte 0 counted apart, tables in "
        "shared memory")

    # timed: the default encode's call (bits 4, refine_iters 2) on the
    # photo, then bits 3 and 5, the soft alpha (no opaque skip) and the
    # tie-heavy planes at bits 4
    iters = 2
    timed = [("1024x1024 subtract-green", sg, 4),
             ("1024x1024 subtract-green", sg, 3),
             ("1024x1024 subtract-green", sg, 5),
             ("1024x1024 soft alpha", cases["1024x1024 soft alpha"], 4),
             ("flat 600x700", cases["flat 600x700"], 4),
             ("gradient 600x700", cases["gradient 600x700"], 4)]
    result = None
    for what, a, bits in timed:
        x = words(a.astype(np.uint32))
        h, w = x.shape
        modes, replay, passes = chooser_replay(dev, x, bits, iters)
        if not torch.equal(modes, vpm.predictor_search_entropy(x, bits,
                                                               iters)):
            raise AssertionError("predictor_search_entropy: the replay "
                                 "differs")
        ms = time_ms(lambda b=bits: vpm.predictor_search_entropy(x, b, iters),
                     reps=10, warmup=2)
        call_ms = queued_ms(replay, reps=20)[0]
        stage1_ms = queued_ms(lambda r=replay: r(0, 1), reps=20)[0]
        round_ms = (queued_ms(lambda r=replay: r(1), reps=20)[0]
                    / max(passes - 1, 1))
        tiles = ((h + (1 << bits) - 1) >> bits) * ((w + (1 << bits) - 1)
                                                   >> bits)
        nbytes = passes * (4 * h * w + 4 * tiles)
        ops = h * w * (OPS_VP8L_STAGE1_PIXEL
                       + (passes - 1) * OPS_VP8L_ROUND_PIXEL)
        ops_sweep = passes * (h * w * OPS_VP8L_SWEEP_PIXEL
                              + tiles * OPS_VP8L_SWEEP_TILE)
        # the bound: the smaller of the two counts (the sweep is the cheaper
        # at bits 5, where a tile's 14 x 1024 bins serve 1,024 pixels)
        bound_ms, bound_by = bound(nbytes, min(ops, ops_sweep))
        log(f"predictor_search_entropy on the {what}, bits {bits}, "
            f"refine_iters {iters}: {passes} launches; one call {ms:.4f} ms, "
            f"device {call_ms:.4f} ms (stage 1 {stage1_ms:.4f}, a round "
            f"{round_ms:.4f}); bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} "
            f"ms by bytes, {ops / int32_peak()[0] * 1e3:.4f} ms by "
            f"operations ({ops} int32 operations; the sweep's count "
            f"{ops_sweep}, {ops_sweep / int32_peak()[0] * 1e3:.4f} ms); "
            f"{bound_ms / call_ms:.0%} of the smaller bound")
        if result is None:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            vpm.predictor_search_entropy_plain(x, bits, iters)
            t1.record()
            t1.synchronize()
            result = {"name": "predictor_search_entropy", "max_abs_err": 0,
                      "ms": ms, "fn": replay, "plain_ms": t0.elapsed_time(t1),
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def lossless_encode(dev, images, reset_counts, read_counts, tag):
    """Phase 8d: the lossless encode of corpus image 12 on the card (see
    the module docstring).  Returns predictor_search_entropy's launches of
    the default encode and its file."""
    import os

    import numpy as np
    import torch

    import gowebp_tpu_torch as T
    from gowebp_tpu_torch.models.vp8l import encoder as vp8l_enc
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm

    switch = vp8l_enc.ANALYSIS_SWITCH
    if os.environ.get(switch):
        raise AssertionError(f"{switch} is set in the environment")

    def run(im, tag_, calls, **kw):
        reset_counts()
        before = vpm.predictor_search_entropy.calls
        t0 = time.perf_counter()
        data = T.encode_rgba(im, config=T.EncoderConfig(lossless=True, **kw),
                             device="cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for k, n in read_counts(tag_).items() if n}
        n_calls = vpm.predictor_search_entropy.calls - before
        if set(counts) != {"predictor_search_entropy"} or n_calls != calls:
            raise AssertionError(f"lossless encode {kw}: launches {counts}, "
                                 f"{n_calls} chooser calls, expected only "
                                 f"predictor_search_entropy in {calls} calls")
        return data, ms, counts["predictor_search_entropy"]

    def decodes_to(data, want):
        port = T.decode_rgba(data, device="cuda")
        if not np.array_equal(port, pillow_rgba(data)):
            raise AssertionError("a lossless file decodes to other pixels "
                                 "through Pillow than the port")
        if want is not None and not np.array_equal(port, want):
            raise AssertionError("a lossless file does not decode to its "
                                 "source")
        return port

    img = images[12]
    rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    data, first_ms, launches = run(img, "lossless", 2)
    log(f"lossless encode: 1024x1024 RGB q75 method 4, first call "
        f"{first_ms:.1f} ms, {len(data)} bytes, predictor_search_entropy "
        f"{launches} launches in 2 calls {tag}")
    os.environ[switch] = "1"
    try:
        t0 = time.perf_counter()
        forced = T.encode_rgba(img, lossless=True, device="cpu")
        forced_s = time.perf_counter() - t0
    finally:
        del os.environ[switch]
    if forced != data:
        raise AssertionError("lossless encode: GPU bytes != the CPU bytes "
                             f"with {switch}=1")
    t0 = time.perf_counter()
    host = T.encode_rgba(img, lossless=True, device="cpu")
    host_s = time.perf_counter() - t0
    ratio = len(data) / len(host)
    log(f"lossless parity: GPU bytes == CPU bytes with the switch (the CPU "
        f"run {forced_s:.2f} s); {len(data)} bytes against the host "
        f"chooser's {len(host)} ({ratio:.6f}x; the CPU run {host_s:.2f} s)")
    if ratio > 1.005:
        raise AssertionError(f"lossless encode: {ratio:.6f}x the host "
                             f"chooser's file")
    decodes_to(data, rgba)
    log("lossless decode: the port == Pillow == the source")

    timer = StageTimer([(vp8l_enc, "_device_modes", "choosers"),
                        (vp8l_enc, "_write_spatial_stream", "spatial")])
    total, split = [], []
    for _ in range(3):
        with timer.fresh() as st:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = T.encode_rgba(img, lossless=True, device="cuda")
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
        if again != data:
            raise AssertionError("lossless encode: a repeat gives other "
                                 "bytes")
        wall = st.wall("choosers") * 1e3
        spatial = st.s["spatial"] * 1e3
        split.append((wall, st.s["choosers"] * 1e3, spatial,
                      total[-1] - wall - spatial))
    med = [statistics.median(v) for v in zip(*split)]
    log(f"lossless latency 1024x1024 RGB defaults: median of 3 "
        f"{statistics.median(total):.3f} ms (min {min(total):.3f}, max "
        f"{max(total):.3f}); split (medians): choosers {med[0]:.3f} ms wall "
        f"({med[1]:.3f} ms summed over their threads), spatial stream "
        f"{med[2]:.3f} ms, the rest of the transform trials {med[3]:.3f} ms "
        f"{tag}")

    soft = soft_alpha_image(img)
    got, ms, n = run(soft, "lossless_rgba", 2, exact=True)
    decodes_to(got, soft)
    log(f"lossless RGBA soft alpha, exact: {len(got)} bytes, {ms:.1f} ms, "
        f"{n} launches; round trip exact")
    got, ms, n = run(img, "lossless_method6", 6, method=6, quality=95)
    decodes_to(got, rgba)
    log(f"lossless method 6 q95: {len(got)} bytes ({len(data)} at method 4), "
        f"{ms:.1f} ms, {n} launches in 6 calls; round trip exact {tag}")
    got, ms, n = run(img, "lossless_near60", 2, near_lossless=60)
    decodes_to(got, None)
    log(f"lossless near_lossless=60: {len(got)} bytes, {ms:.1f} ms, {n} "
        f"launches; the port's decode == Pillow's")
    return launches, data


def incremental_decode(dev, data, full, small, reset_counts, read_counts,
                       tag) -> None:
    """Phase 6d: IncrementalDecoder(device="cuda") on a 1 MP lossy file in
    17 chunks and on its first two thirds, on a 255x193 lossy file in
    37-byte appends and a VP8L file in 50-byte appends, each against the
    final rows and the device="cpu" decoder; picture_rescale on the card
    against the CPU."""
    import numpy as np
    import torch

    from gowebp_tpu_torch import IncrementalDecoder, decode, picture_rescale
    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
    from gowebp_tpu_torch.ops.kernels import yuv420_to_rgba as yuvm

    def partial(dec, lossy: bool):
        """The partial output; a lossy call must launch recon_filter_mb and
        yuv420_to_rgba once each."""
        before = (kvr.recon_filter_mb.launches, yuvm.yuv420_to_rgba.launches)
        out = dec.get_partial_output()
        torch.cuda.synchronize()
        after = (kvr.recon_filter_mb.launches, yuvm.yuv420_to_rgba.launches)
        want = (1, 1) if lossy and dec.rows_decoded else (0, 0)
        if tuple(a - b for a, b in zip(after, before)) != want:
            raise AssertionError(f"incremental partial output launched "
                                 f"{after} - {before}, want {want}")
        return out

    t0 = time.perf_counter()
    reset_counts()
    dec = IncrementalDecoder(device="cuda")
    step = -(-len(data) // 17)
    calls = 0
    for i in range(0, len(data), step):
        dec.append(data[i:i + step])
        n = dec.rows_decoded
        if dec.state != "done" and n:
            if not np.array_equal(partial(dec, True), full[:n]):
                raise AssertionError(f"incremental partial rows ({n}) != "
                                     f"the final rows")
            calls += 1
    counts = read_counts("decode_incremental")
    if dec.state != "done" or not np.array_equal(dec.get_output(), full):
        raise AssertionError("incremental decode of the 1 MP file != "
                             "decode_rgba_batch's")
    if calls == 0 or counts["recon_filter_mb"] != calls + 1:
        raise AssertionError(f"incremental decode: {calls} partial calls, "
                             f"launches {counts}")
    log(f"incremental decode of a 1 MP lossy file ({len(data)} bytes) in 17 "
        f"chunks: {calls} partial outputs == the final rows, each one "
        f"recon_filter_mb and one yuv420_to_rgba launch; final == the batch "
        f"decode's; {time.perf_counter() - t0:.1f} s {tag}")
    t0 = time.perf_counter()
    cut = len(data) * 2 // 3
    a, b = IncrementalDecoder(device="cuda"), IncrementalDecoder(device="cpu")
    a.append(data[:cut])
    b.append(data[:cut])
    n = a.rows_decoded
    pa, pb = partial(a, True), b.get_partial_output()
    if not (n == b.rows_decoded > 0 and np.array_equal(pa, pb)
            and np.array_equal(pa, full[:n])):
        raise AssertionError("incremental partial rows of the first two "
                             "thirds != the CPU decoder's or the final rows")
    log(f"incremental decode, first two thirds of the 1 MP file: {n} rows == "
        f"device=\"cpu\" and the final rows "
        f"({time.perf_counter() - t0:.1f} s with the CPU decoder)")
    for fname, chunk in (("lossy_q75", 37), ("vp8l", 50)):
        t0 = time.perf_counter()
        d = small[fname]
        a, b = IncrementalDecoder(device="cuda"), IncrementalDecoder(
            device="cpu")
        seen, partials = None, 0
        for i in range(0, len(d), chunk):
            state = a.append(d[i:i + chunk])
            if state != b.append(d[i:i + chunk]) or \
                    a.rows_decoded != b.rows_decoded:
                raise AssertionError(f"incremental {fname}: the card's and "
                                     f"the CPU's decoders part at byte {i}")
            if (state, a.rows_decoded) != seen:
                seen = (state, a.rows_decoded)
                pa = partial(a, fname != "vp8l" and state != "done")
                pb = b.get_partial_output()
                if (pa is None) != (pb is None) or (
                        pa is not None and not np.array_equal(pa, pb)):
                    raise AssertionError(f"incremental {fname}: partial "
                                         f"output != the CPU's at byte {i}")
                partials += pa is not None and state != "done"
        if a.state != "done" or not np.array_equal(
                a.get_output(), decode(d, device="cuda")):
            raise AssertionError(f"incremental {fname}: final != decode()")
        log(f"incremental decode of {fname} (255x193, {len(d)} bytes) in "
            f"{chunk}-byte appends: states, rows and {partials} distinct "
            f"partial outputs == device=\"cpu\"; final == decode() "
            f"({time.perf_counter() - t0:.1f} s)")
    rgb = full[..., :3]
    yy, xx = np.mgrid[0:full.shape[0], 0:full.shape[1]]
    rgba = np.dstack([rgb, (255 * xx // (full.shape[1] - 1)).astype(np.uint8)])
    for img in (rgb, rgba):
        for w, h in ((301, 0), (0, 1536), (640, 480)):
            if not np.array_equal(picture_rescale(img, w, h, device="cuda"),
                                  picture_rescale(img, w, h, device="cpu")):
                raise AssertionError(f"picture_rescale({w}, {h}) on the card "
                                     f"!= on the CPU")
    log("picture_rescale on the card == device=\"cpu\" (RGB and RGBA 1 MP, "
        "three target sizes)")


# ---------------------------------------------------------------------------
# Phase 10: parallel/ (the sharded steps)
# ---------------------------------------------------------------------------

# The sharded steps' kernels: each must launch in the one-rank job.
PARALLEL_KERNELS = ("encode_luma", "encode_chroma", "wavefront_search",
                    "recon_filter_mb", "predictor_inverse")
# predictor_inverse (ops/kernels/vp8l_inverse.cu), per pixel: the mode's
# load and decode (3), the chosen predictor (the 14 average some 15
# operations: modes 0-4 none, an avg2 5, Select ~30, the clamped ones
# ~36-41), the byte-wise add (7), the add-green epilogue (8) and the
# address and ring bookkeeping (~7).
OPS_VP8L_INVERSE_PIXEL = 40


def mosaic(images, n: int):
    """An n x n mosaic of same-shaped images."""
    import numpy as np

    return np.concatenate([np.concatenate(images[r * n:(r + 1) * n], 1)
                           for r in range(n)], 0)


def lossless_case(dev, images, bits: int, seed: int):
    """The lossless inverse's inputs for RGB images: each image's
    subtract-green words as residuals of a random per-tile predictor map
    (the encoder's forward transforms, ops/lossless.py) → (residuals
    (B, h, w) int32, the (th, tw) mode image, the source words)."""
    import numpy as np
    import torch

    from gowebp_tpu_torch.ops import lossless as L
    from gowebp_tpu_torch.ops.kernels.vp8l_inverse import to_bits

    words = torch.from_numpy(np.stack([rgb_words(im) for im in images]).astype(
        np.int64)).to(dev)
    B, h, w = words.shape
    g = (words >> 8) & 255
    sg = ((words & 0xFF00FF00) | ((((words >> 16) - g) & 255) << 16)
          | ((words - g) & 255))
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    modes = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 14, (th, tw))).to(dev)
    per_px = modes[torch.arange(h, device=dev) >> bits][
        :, torch.arange(w, device=dev) >> bits]
    res = torch.empty_like(sg)
    for b in range(B):
        pred = torch.zeros_like(sg[b])
        for m in range(14):
            pred = torch.where(per_px == m, L.predict_plane(sg[b], m), pred)
        res[b] = L._sub_pixels(sg[b], pred)
    mode_img = to_bits((modes << 8) | 0xFF000000)
    return to_bits(res), mode_img, to_bits(words)


def parallel_inputs(dev, images=None, files=None, small: bool = False):
    """The sharded steps' inputs, at the sizes their users give them, or
    (``small``) at a few MBs for the card tests:
      plane: the 32 corpus images' MB-padded planes (B=32 1024x1024), q75;
      wavefront: one 4096x4096 image, a 4x4 mosaic of corpus images (its
        planes, segments, quantizers, penalties and cost tables, q75);
      recon_frame: that image's q75 file from the port's hybrid batch
        encode: its symbols (the complex filter; one token partition of
        some 1.6 MB, which the batch symbol decoder reads with one lane);
      recon_step: the 32 hybrid files' symbols (B=32 1024x1024);
      lossless: 8 corpus images' words as residuals of a bits-4 map.
    Every tensor on ``dev``."""
    import torch

    from gowebp_tpu_torch import encode_rgba_batch
    from gowebp_tpu_torch.models.vp8.encoder import make_quants, quality_to_q
    from gowebp_tpu_torch.utils.corpus import natural_images

    n = 2 if small else 4
    if small:
        images = list(natural_images(4, 64, 96, seed=3))
        files = encode_rgba_batch(images, quality=75.0, device=dev)
    q = make_quants(quality_to_q(75.0))
    plane = chunk_inputs(dev, images)
    out = {"plane": {k: plane[k].contiguous() for k in "yuv"},
           "quants": {k: getattr(q, k).q for k in (
               "y1_dc", "y1_ac", "y2_dc", "y2_ac", "uv_dc", "uv_ac")}}
    big = mosaic(images[:n * n], n)
    wf = chunk_inputs(dev, [big])
    out["wavefront"] = {k: wf[k].contiguous() for k in (
        "y", "u", "v", "seg", "qsteps", "pens")}
    out["tables"] = tuple(wf["tables"])
    out["use_derr"] = bool(wf["use_derr"])
    for name, fs in (("recon_frame", encode_rgba_batch(
            [big], quality=75.0, device=dev)), ("recon_step", files)):
        coeffs, modes, fp, ftype, mw, mh = recon_symbols(dev, fs)
        out[name] = {"coeffs": coeffs, "is_i4": modes[..., 0].contiguous(),
                     "imodes": modes[..., 2:].contiguous(),
                     "uvmode": modes[..., 1].contiguous(), "fparams": fp}
        out[name + "_grid"] = (mw, mh, ftype)
    res, mode_img, words = lossless_case(dev, images[:4 if small else 8], 4,
                                         seed=19)
    out["lossless"] = {"residuals": res, "mode_img": mode_img}
    out["words"] = words
    return out


def unsharded_results(inputs):
    """Each step's outputs from the unsharded entry points."""
    from gowebp_tpu_torch.ops.encode_plane import encode_plane_core_v2
    from gowebp_tpu_torch.ops.kernels.vp8_recon import (pack_modes,
                                                        recon_filter_mb)
    from gowebp_tpu_torch.ops.kernels.wavefront_search import (
        search_tables, wavefront_search)
    from gowebp_tpu_torch.ops.lossless import predictor_inverse

    p, wf = inputs["plane"], inputs["wavefront"]
    out = {"plane": encode_plane_core_v2(p["y"], p["u"], p["v"],
                                         **inputs["quants"])}
    out["wavefront"] = wavefront_search(
        *(wf[k] for k in ("y", "u", "v", "seg", "qsteps", "pens")),
        search_tables(inputs["tables"]), try_i4=True,
        use_derr=inputs["use_derr"], want_recon=False)
    for name in ("recon_frame", "recon_step"):
        a = inputs[name]
        mw, mh, ftype = inputs[name + "_grid"]
        out[name] = dict(zip("YUV", recon_filter_mb(
            a["coeffs"], pack_modes(a["is_i4"], a["imodes"], a["uvmode"]),
            a["fparams"], mw, mh, ftype)))
    a = inputs["lossless"]
    out["lossless"] = {"out": predictor_inverse(a["residuals"], a["mode_img"],
                                                4, add_green=True)}
    return out


def sharded_results(mesh, inputs):
    """Each step through its gowebp_tpu_torch.parallel.shard function on
    ``mesh``; the full tensors (every rank calls: collectives)."""
    from gowebp_tpu_torch.parallel import shard

    p, wf = inputs["plane"], inputs["wavefront"]
    out = {"plane": shard.sharded_encode_plane_step(
        mesh, p["y"], p["u"], p["v"], quants=inputs["quants"])}
    out["wavefront"] = shard.sharded_wavefront_encode(
        mesh, *(wf[k] for k in ("y", "u", "v", "seg", "qsteps")),
        inputs["tables"], try_i4=True, i4_penalty=wf["pens"],
        use_derr=inputs["use_derr"])
    for name, fn in (("recon_frame", shard.sharded_recon_frame),
                     ("recon_step", shard.sharded_recon_step)):
        a = inputs[name]
        mw, mh, ftype = inputs[name + "_grid"]
        out[name] = dict(zip("YUV", fn(
            mesh, *(a[k] for k in ("coeffs", "is_i4", "imodes", "uvmode",
                                   "fparams")),
            mb_w=mw, mb_h=mh, filter_type=ftype)))
    a = inputs["lossless"]
    out["lossless"] = {"out": shard.sharded_lossless_inverse(
        mesh, a["residuals"], a["mode_img"], bits=4)}
    return {step: {k: shard.full_tensor(t) for k, t in d.items()}
            for step, d in out.items()}


def parallel_digests(results):
    """{step: {output: sha256 of its bytes}}."""
    import hashlib

    return {step: {k: hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
        for k, t in sorted(d.items())} for step, d in results.items()}


def run_parallel_job(inputs, n: int, workdir) -> dict:
    """The sharded steps in an ``n``-rank gloo job of worker processes,
    every rank on cuda:0 (gloo takes no device tensors point to point, so
    the halos are staged through host memory); each worker is this script
    with ``--parallel-worker``.  Returns rank 0's digests, the bytes the
    ranks staged and each rank's launches of the halo and stripe forms."""
    import os
    import socket

    import torch

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(_to(inputs, "cpu"), workdir / "in.pt")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-worker",
         str(r), str(n), str(port), str(workdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel worker {r} rc={p.returncode}:\n"
                                 f"{o[-4000:]}")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(n)]
    return {"digests": ranks[0]["digests"],
            "staged_bytes": sum(r["staged_bytes"] for r in ranks),
            "launches": [r["launches"] for r in ranks],
            "seconds": max(r["seconds"] for r in ranks)}


def _to(tree, dev):
    """``tree`` (dicts, tuples, tensors, plain values) with every tensor
    on ``dev``."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def parallel_worker(rank: int, n: int, port: int, workdir) -> int:
    """One rank of run_parallel_job: a gloo process group on cuda:0, the
    (1, n) mesh, the five sharded steps; writes rank{rank}.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from gowebp_tpu_torch.ops.kernels import encode_plane as epm
    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
    from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm
    from gowebp_tpu_torch.parallel import shard
    from gowebp_tpu_torch.parallel.mesh import make_mesh

    workdir = Path(workdir)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = make_mesh(n, data=1, tile=n, device="cuda")
        inputs = _to(torch.load(workdir / "in.pt"), dev)
        t0 = time.perf_counter()
        results = sharded_results(mesh, inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        info = {"staged_bytes": shard.send_halo.staged_bytes
                + shard.recv_halo.staged_bytes, "seconds": seconds,
                "launches": {
                    "encode_luma_halo": epm.encode_luma.halo_launches,
                    "encode_chroma_halo": epm.encode_chroma.halo_launches,
                    "wavefront_search_stripe": wsm.wavefront_search
                    .stripe_launches,
                    "recon_filter_mb_stripe": kvr.recon_filter_mb
                    .stripe_launches},
                "digests": parallel_digests(results) if rank == 0 else None}
        (workdir / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()
    return 0


def plain_timed(fn):
    """(``fn()``, its seconds on the card, synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def halo_device_ms(name: str, halo, no_halo, tag: str) -> None:
    """Logs the device ms of a launch of a halo or stripe form beside the
    no-halo form's on the same shard (queued_ms, a few launches)."""
    h = queued_ms(halo, reps=5, rounds=3)[0]
    n = queued_ms(no_halo, reps=5, rounds=3)[0]
    log(f"{name}: {h:.4f} ms a launch on the device, the no-halo form on "
        f"the same shard {n:.4f} ms ({h / n - 1:+.1%}) {tag}")


def check_halo_forms(inputs, want, tag: str) -> None:
    """Holds each halo or stripe form's wrapper output against its plain
    version run on the same CUDA tensors (bit-exact), and the shards
    joined against the unsharded kernels' outputs ``want``: the plane
    kernels on the 32 planes in 2 width tiles, wavefront_search and
    recon_filter_mb on the 4096x4096 image in 2 MB-row stripes (the
    recon's rows written back).  Since the joined shards equal the
    unsharded calls, those calls are held against the plain versions on
    these inputs too.  Logs the plain versions' seconds and each form's
    device ms beside the no-halo form's on the same shard."""
    import torch

    from gowebp_tpu_torch.ops.kernels import encode_plane as epm
    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
    from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm

    def same(name, got, plain):
        keys = list(plain)
        if set(got) != set(keys):
            raise AssertionError(f"{name}: outputs {sorted(got)} against "
                                 f"the plain version's {sorted(keys)}")
        err = max_abs_err(got, plain, keys)
        if err or not all(torch.equal(got[k], plain[k]) for k in keys):
            raise AssertionError(f"{name} != its plain version (max |err| "
                                 f"{err})")

    # the plane kernels: 2 width tiles, the right one with the left's
    # last columns as its halo
    p = inputs["plane"]
    B, H, W = p["y"].shape
    c = W // 2
    lq, y2q, cq = plane_quants(75.0)
    tiles = [{k: t[:, :, a:b].contiguous() for k, t, a, b in (
        ("y", p["y"], lo, hi), ("u", p["u"], lo // 2, hi // 2),
        ("v", p["v"], lo // 2, hi // 2))} for lo, hi in ((0, c), (c, W))]
    halos = [None, {k: p[k][:, :, (c if k == "y" else c // 2) - 1]
                    .contiguous() for k in "yuv"}]
    luma_keys, chroma_keys = ("ymode", "y_levels", "y2_levels"), (
        "uvmode", "uv_levels")
    parts, plain_s = [], 0.0
    for t, hl in zip(tiles, halos):
        yh = None if hl is None else hl["y"]
        uvh = None if hl is None else (hl["u"], hl["v"])
        got = dict(zip(luma_keys, epm.encode_luma(t["y"], lq, y2q, halo=yh)))
        got.update(zip(chroma_keys, epm.encode_chroma(t["u"], t["v"], cq,
                                                      halo=uvh)))
        (pl, pc), s = plain_timed(lambda: (
            epm.encode_luma_plain(t["y"], lq, y2q, halo=yh),
            epm.encode_chroma_plain(t["u"], t["v"], cq, halo=uvh)))
        plain_s += s
        same("encode_luma/encode_chroma" + (" halo form" if hl else ""),
             got, {**dict(zip(luma_keys, pl)), **dict(zip(chroma_keys, pc))})
        parts.append(got)
    err = max_abs_err({k: torch.cat([q[k] for q in parts], 2)
                       for k in want["plane"]}, want["plane"],
                      list(want["plane"]))
    if err:
        raise AssertionError(f"plane halo forms != unsharded (max |err| "
                             f"{err})")
    log(f"encode_luma/encode_chroma halo forms: B={B} {H}x{W} in 2 width "
        f"tiles == their plain versions on the card (plain {plain_s:.1f} s) "
        f"and == the unsharded kernels")
    t, hl = tiles[1], halos[1]
    halo_device_ms("encode_luma halo form",
                   lambda: epm.encode_luma(t["y"], lq, y2q, halo=hl["y"]),
                   lambda: epm.encode_luma(t["y"], lq, y2q), tag)
    halo_device_ms("encode_chroma halo form",
                   lambda: epm.encode_chroma(t["u"], t["v"], cq,
                                             halo=(hl["u"], hl["v"])),
                   lambda: epm.encode_chroma(t["u"], t["v"], cq), tag)

    # the exact wavefront: 2 MB-row stripes, the lower with the upper's
    # edge as its halo
    wf = inputs["wavefront"]
    rate = wsm.search_tables(inputs["tables"])
    H, W = wf["y"].shape[1:]
    kw = dict(try_i4=True, use_derr=inputs["use_derr"])
    stripes = [[wf[k][:, a * s // 16:b * s // 16].contiguous()
                for k, s in (("y", 16), ("u", 8), ("v", 8), ("seg", 1))]
               + [wf["qsteps"], wf["pens"], rate]
               for a, b in ((0, H // 2), (H // 2, H))]
    parts, above, plain_s = [], None, 0.0
    for args in stripes:
        out, edge = wsm.wavefront_search_stripe(*args, **kw, above=above)
        (pout, pedge), s = plain_timed(
            lambda: wsm.wavefront_search_stripe_plain(*args, **kw,
                                                      above=above))
        plain_s += s
        same("wavefront_search" + (" stripe form" if above else ""),
             {**out, **dict(zip("yuvd", edge))},
             {**pout, **dict(zip("yuvd", pedge))})
        parts.append(out)
        halo, above = above, edge
    err = max_abs_err({k: torch.cat([o[k] for o in parts], 1)
                       for k in want["wavefront"]}, want["wavefront"],
                      list(want["wavefront"]))
    if err:
        raise AssertionError(f"wavefront_search stripe form != unsharded "
                             f"(max |err| {err})")
    log(f"wavefront_search stripe form: one {H}x{W} image in 2 MB-row "
        f"stripes == its plain version on the card (plain {plain_s:.1f} s) "
        f"and == one unsharded launch")
    halo_device_ms("wavefront_search stripe form",
                   lambda: wsm.wavefront_search_stripe(*stripes[1], **kw,
                                                       above=halo),
                   lambda: wsm.wavefront_search_stripe(*stripes[1], **kw),
                   tag)

    # the decode recon + loop filter: 2 MB-row stripes, the lower with the
    # upper's edge, sending the upper's last 3 rows back
    a = inputs["recon_frame"]
    mw, mh, ftype = inputs["recon_frame_grid"]
    modes = kvr.pack_modes(a["is_i4"], a["imodes"], a["uvmode"])
    h = mh // 2
    stripes = [(a["coeffs"][:, lo * mw:hi * mw].contiguous(),
                modes[:, lo * mw:hi * mw].contiguous(),
                a["fparams"][:, lo:hi].contiguous(), mw, hi - lo, ftype)
               for lo, hi in ((0, h), (h, mh))]
    parts, above, plain_s = [], None, 0.0
    for args in stripes:
        got, edge, back = kvr.recon_filter_mb_stripe(*args, above)
        (pgot, pedge, pback), s = plain_timed(
            lambda: kvr.recon_filter_mb_stripe_plain(*args, above))
        plain_s += s
        same("recon_filter_mb stripe form" + (" with a halo" if above else ""),
             dict(enumerate([*got, *edge, *(back or ())])),
             dict(enumerate([*pgot, *pedge, *(pback or ())])))
        if back is not None:
            for plane, rows in zip(parts[-1], back):
                plane[:, -3:] = rows
        parts.append(list(got))
        halo, above = above, edge
    got = {k: torch.cat([t, b], 1) for k, t, b in zip("YUV", *parts)}
    err = max_abs_err(got, want["recon_frame"], "YUV")
    if err:
        raise AssertionError(f"recon_filter_mb stripe form != unsharded "
                             f"(max |err| {err})")
    log(f"recon_filter_mb stripe form: the {16 * mh}x{16 * mw} file in 2 "
        f"MB-row stripes (filter type {ftype}, rows written back) == its "
        f"plain version on the card (plain {plain_s:.1f} s) and == one "
        f"unsharded launch")
    halo_device_ms("recon_filter_mb stripe form",
                   lambda: kvr.recon_filter_mb_stripe(*stripes[1], halo),
                   lambda: kvr.recon_filter_mb(*stripes[1]), tag)


def check_parallel(dev, images, files, reset_counts, read_counts, tag):
    """Phase 10: parallel/.  Builds the sharded steps' inputs at full size;
    holds each halo form against its plain version and the joined shards
    against its kernel's unsharded form (check_halo_forms) and
    predictor_inverse against its plain version (B=8 1024x1024, bits 4,
    with the add-green epilogue; its pixels are the source words) and, at
    B=1 4096x4096 (the 4x4 mosaic), against its source words, times
    predictor_inverse on both; runs the five sharded steps in a one-rank NCCL job
    in this process (counts reset just before and read just after: every
    kernel of the path must launch) and in a two-rank gloo job on cuda:0,
    whose full tensors must equal the unsharded calls'.  Returns
    predictor_inverse's kernel row and the parallel path's counts."""
    import torch
    import torch.distributed as dist

    from gowebp_tpu_torch.ops.kernels import vp8l_inverse as vim
    from gowebp_tpu_torch.parallel import distributed, shard
    from gowebp_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    inputs = parallel_inputs(dev, images, files)
    want = unsharded_results(inputs)
    torch.cuda.synchronize()
    log(f"parallel inputs and unsharded calls: "
        f"{time.perf_counter() - t_phase:.1f} s")
    if inputs["recon_frame_grid"][2] != 2:
        raise AssertionError("the 4096x4096 file does not use the complex "
                             "filter")

    # ---- the halo forms against their plain versions and the unsharded
    # kernels, on the same inputs ----
    check_halo_forms(inputs, want, tag)

    # ---- predictor_inverse against its plain version; timed ----
    li = inputs["lossless"]
    args = (li["residuals"], li["mode_img"], 4, True)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = vim.predictor_inverse_plain(*args)
    t1.record()
    t1.synchronize()
    got = vim.predictor_inverse(*args)
    inv_err = max_abs_err({"o": got}, {"o": plain}, "o")
    if inv_err or not torch.equal(got, inputs["words"]):
        raise AssertionError(f"predictor_inverse != plain or the source "
                             f"(max |err| {inv_err})")
    B, hh, ww = li["residuals"].shape
    log(f"predictor_inverse B={B} {hh}x{ww} bits 4 with add-green: bit-exact "
        f"vs plain, and == the source words")
    for fn, regs, stack, st_, ld_ in ptxas_report(vim.LIBRARY.ptxas_log,
                                                  "vp8l_inverse"):
        log(f"ptxas {fn}: {regs} registers, {stack} bytes stack, "
            f"{st_}/{ld_} bytes spill stores/loads")
        if stack or st_ or ld_:
            raise AssertionError("vp8l_inverse: a stack frame or spills")
    # one 4096x4096 image, the 4x4 mosaic of the wavefront's input, held to
    # its source words (its plain run, ~12,300 diagonal steps, would take
    # minutes)
    big_res, big_modes, big_words = lossless_case(
        dev, [mosaic(images[:16], 4)], 4, seed=20)
    big = (big_res, big_modes, 4, True)
    if not torch.equal(vim.predictor_inverse(*big), big_words):
        raise AssertionError("predictor_inverse at 4096x4096 != the source "
                             "words")
    log("predictor_inverse B=1 4096x4096 bits 4 with add-green: == the "
        "source words")
    cases = {}
    for name, a in (("B=8 1024x1024", args), ("B=1 4096x4096", big)):
        b_, h_, w_ = a[0].shape
        nbytes = 2 * a[0].numel() * 4 + a[1].numel() * 4
        bound_ms, bound_by = bound(nbytes, b_ * h_ * w_
                                   * OPS_VP8L_INVERSE_PIXEL)
        steps = w_ + 2 * (h_ - 1)
        ms = time_ms(lambda a=a: vim.predictor_inverse(*a), reps=10,
                     warmup=2)
        dms = queued_ms(lambda a=a: vim.predictor_inverse(*a),
                        reps=max(5, min(50, int(20 / ms))))[0]
        log(f"predictor_inverse {name}: {ms:.4f} ms a call, {dms:.4f} ms a "
            f"launch on the device ({steps} dependent steps, "
            f"{dms / steps * 1e3:.4f} us a step); bound {bound_ms:.4f} ms "
            f"by {bound_by}, {bound_ms / dms:.1%} of the device time {tag}")
        cases[name] = (ms, bound_ms, bound_by)
    ms, bound_ms, bound_by = cases["B=8 1024x1024"]
    row = {"name": "predictor_inverse", "max_abs_err": inv_err, "ms": ms,
           "fn": lambda: vim.predictor_inverse(*args),
           "plain_ms": t0.elapsed_time(t1), "bound_ms": bound_ms,
           "bound_by": bound_by}

    # ---- the one-rank NCCL job, counted as the parallel path ----
    want_digests = parallel_digests(want)
    distributed.initialize(device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        got = sharded_results(mesh, inputs)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        counts = read_counts("parallel")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if parallel_digests(got) != want_digests:
        raise AssertionError("the one-rank job's full tensors differ from "
                             "the unsharded calls'")
    log(f"parallel one-rank {backend} job: the five sharded steps == the "
        f"unsharded calls in {one_s:.2f} s; launches "
        f"{ {k: counts[k] for k in PARALLEL_KERNELS} }")
    missing = [k for k in PARALLEL_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"the parallel path never launched {missing}")

    # ---- the two-rank gloo job on cuda:0 ----
    t0 = time.perf_counter()
    job = run_parallel_job(inputs, 2, ROOT / "gowebp_tpu_torch" / "_build"
                           / "parallel")
    if job["digests"] != want_digests:
        raise AssertionError("the two-rank job's full tensors differ from "
                             "the unsharded calls'")
    lower = job["launches"][1]
    log(f"parallel two-rank gloo job on cuda:0: == the unsharded calls and "
        f"the one-rank job; {job['staged_bytes']} halo bytes staged through "
        f"host memory; rank 1's halo and stripe launches {lower}; steps "
        f"{job['seconds']:.2f} s, job {time.perf_counter() - t0:.1f} s")
    if not all(lower.values()):
        raise AssertionError("rank 1 did not launch every halo or stripe "
                             "form")
    log(f"phase 10 (parallel): {time.perf_counter() - t_phase:.1f} s")
    return row, counts


# ---------------------------------------------------------------------------
# Phase 11: containers, animation, the CLI and bit accounting
# ---------------------------------------------------------------------------

ANIM_PATCH = 256
ANIM_CROP = (192, 256)    # the card-against-CPU check's crop, (h, w)


def anim_frames(images):
    """Phase 11's lossy animation: 8 opaque 1024x1024 frames.  A 256x256
    patch of corpus image 1 moves over image 0 (frames 0-3: each change
    rectangle a sub-rect), frame 4 repeats frame 3, frame 5 changes the
    whole frame (image 2 under the patch), frames 6-7 move the patch on.
    Returns (frames, durations)."""
    import numpy as np

    patch = images[1][:ANIM_PATCH, :ANIM_PATCH]
    steps = [(0, 0), (64, 48), (128, 96), (192, 144), (192, 144),
             (256, 192), (320, 240), (384, 288)]
    frames = []
    for k, (x, y) in enumerate(steps):
        f = np.array(images[0 if k < 5 else 2])
        f[y:y + ANIM_PATCH, x:x + ANIM_PATCH] = patch
        frames.append(f)
    return frames, [40 + 10 * k for k in range(len(frames))]


class CandidateLog:
    """Counts AnimationEncoder's candidate encodes (``anim._encode_candidate``
    wrapped inside ``with``), each with its image's pixels and the
    predictor_search_entropy launches it made; with ``switch_big`` the
    lossless chooser switch is set for the candidates the card sends to
    its device chooser (1 MP or more), so that a CPU run takes the same
    chooser as the card."""

    def __init__(self, chooser_fn=None, switch_big: bool = False):
        self.chooser_fn, self.switch_big = chooser_fn, switch_big
        self.calls = []

    def __enter__(self):
        import os

        from gowebp_tpu_torch.container import anim
        from gowebp_tpu_torch.models.vp8l import encoder as vp8l_enc

        self._orig = orig = anim._encode_candidate

        def counted(sub, lossless, quality, device):
            pixels = sub.shape[0] * sub.shape[1]
            switch = (self.switch_big and lossless
                      and pixels >= vp8l_enc.DEVICE_CHOOSER_PIXELS)
            before = (self.chooser_fn.launches if self.chooser_fn else 0)
            if switch:
                os.environ[vp8l_enc.ANALYSIS_SWITCH] = "1"
            try:
                return orig(sub, lossless, quality, device)
            finally:
                if switch:
                    del os.environ[vp8l_enc.ANALYSIS_SWITCH]
                after = (self.chooser_fn.launches if self.chooser_fn else 0)
                self.calls.append((pixels, bool(lossless), after - before))

        anim._encode_candidate = counted
        return self

    def __exit__(self, *exc):
        from gowebp_tpu_torch.container import anim

        anim._encode_candidate = self._orig
        return False


def encode_animation(frames, durations, device, lossless: bool = False,
                     switch_big: bool = False, chooser_fn=None, **kw):
    """(file, the encoder, its CandidateLog, seconds) of ``frames`` through
    AnimationEncoder on ``device``."""
    import torch

    from gowebp_tpu_torch.container.anim import AnimationEncoder

    enc = AnimationEncoder(device=device, **kw)
    with CandidateLog(chooser_fn, switch_big) as cands:
        t0 = time.perf_counter()
        for f, ms in zip(frames, durations):
            enc.add_frame(f, ms, lossless=lossless, quality=75.0)
        data = enc.assemble()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return data, enc, cands, secs


def pillow_frames(data: bytes):
    """Every composited frame of an animation decoded by Pillow (libwebp's
    WebPAnimDecoder), RGBA."""
    import io

    import numpy as np
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    out = []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        out.append(np.asarray(im.convert("RGBA")))
    return out


def lossy_groups(d) -> int:
    """The batch decode's lossy shape groups of a demuxed file's frames:
    (width, height, filter type, alpha)."""
    from gowebp_tpu_torch.models.vp8.decoder import parse_frame_header

    keys = set()
    for f in d.frames:
        if not f.is_lossless:
            st, _ = parse_frame_header(f.image_payload)
            keys.add((st.width, st.height, st.filter_type,
                      f.alpha_payload is not None))
    return len(keys)


def launched(before: dict, after: dict) -> dict:
    """The kernels launched between two counter snapshots."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def check_demuxed(d, enc, loop_count: int) -> None:
    """The demuxed frames' offsets, durations, blend and dispose flags and
    the loop count are the encoder's own."""
    built = [(f.x, f.y, f.duration_ms, f.blend, f.dispose_background)
             for f in enc._mux.frames]
    got = [(f.x, f.y, f.duration_ms, f.blend, f.dispose_background)
           for f in d.frames]
    if got != built or d.loop_count != loop_count:
        raise AssertionError(f"demuxed frames {got} (loop {d.loop_count}), "
                             f"built {built} (loop {loop_count})")


def anim_lossy(images, peek_counts, tag):
    """Phase 11's lossy animation on the card: the encode and decode with
    their launches checked, the canvases against Pillow and the sources.
    Returns (file, frames, durations)."""
    import numpy as np

    from gowebp_tpu_torch.container.anim import decode_animation

    frames, durations = anim_frames(images)
    start = peek_counts()
    data, enc, cands, enc_s = encode_animation(
        frames, durations, "cuda", kmin=2, kmax=4, loop_count=3)
    mid = peek_counts()
    got = launched(start, mid)
    if got != {"wavefront_search": len(cands.calls)}:
        raise AssertionError(f"lossy animation encode: launches {got}, "
                             f"expected wavefront_search once for each of "
                             f"{len(cands.calls)} candidate encodes")
    t0 = time.perf_counter()
    canvases, d = decode_animation(data, device="cuda")
    dec_s = time.perf_counter() - t0
    groups = lossy_groups(d)
    got = launched(mid, peek_counts())
    want = {k: groups for k in DECODE_KERNELS}
    if got != want:
        raise AssertionError(f"lossy animation decode: launches {got}, "
                             f"expected {want} ({groups} shape groups)")
    log(f"lossy animation 1024x1024 q75, 8 frames, kmin 2 kmax 4: "
        f"{len(data)} bytes, {d.num_frames} frames, {len(cands.calls)} "
        f"candidate encodes (wavefront_search {len(cands.calls)} launches); "
        f"decode: {groups} shape groups, {got}")
    log(f"lossy animation: encode {enc_s * 1e3 / len(frames):.3f} ms a "
        f"frame ({enc_s * 1e3:.1f} ms for {len(frames)} frames), decode "
        f"{dec_s * 1e3 / d.num_frames:.3f} ms a frame ({dec_s * 1e3:.1f} ms "
        f"for {d.num_frames}) {tag}")

    check_demuxed(d, enc, 3)
    kept = [k for k in range(len(frames))
            if k == 0 or not np.array_equal(frames[k], frames[k - 1])]
    if len(kept) != d.num_frames or len(canvases) != d.num_frames:
        raise AssertionError(f"{d.num_frames} frames, expected {len(kept)} "
                             f"(one repeat merged)")
    if sum(f.duration_ms for f in d.frames) != sum(durations):
        raise AssertionError("the merged durations do not sum to the inputs'")
    theirs = pillow_frames(data)
    if len(theirs) != len(canvases):
        raise AssertionError("Pillow reads another frame count")
    worst = 99.0
    for j, (c, p) in enumerate(zip(canvases, theirs)):
        if not np.array_equal(c.rgba, p):
            raise AssertionError(f"canvas {j}: the port's != Pillow's")
        db = psnr(c.rgba[..., :3], frames[kept[j]])
        worst = min(worst, db)
        if db < 20.0:
            raise AssertionError(f"canvas {j}: {db:.2f} dB against its "
                                 f"source, under 20")
    log(f"lossy animation: every canvas == Pillow's; PSNR against the "
        f"sources >= {worst:.3f} dB; offsets, durations (one merged) and "
        f"loop count as built")
    return data, frames, durations


def anim_card_vs_cpu(frames, durations) -> None:
    """Phase 11's lossy animations on the card against the CPU (the
    kernels' plain versions): a crop of the frames, and a small case with
    alpha (ALPH chunks, blended frames); bytes and canvases."""
    import numpy as np

    from gowebp_tpu_torch.container.anim import decode_animation

    h, w = ANIM_CROP
    crop = [np.ascontiguousarray(f[:h, :w]) for f in frames]
    gpu, _, gc, _ = encode_animation(crop, durations, "cuda", kmin=2, kmax=4)
    t0 = time.perf_counter()
    cpu, _, _, _ = encode_animation(crop, durations, "cpu", kmin=2, kmax=4)
    cpu_s = time.perf_counter() - t0
    if gpu != cpu:
        raise AssertionError(f"lossy animation {w}x{h}: GPU bytes != CPU "
                             f"bytes")
    a, _ = decode_animation(gpu, device="cuda")
    b, _ = decode_animation(gpu, device="cpu")
    if [x.duration_ms for x in a] != [x.duration_ms for x in b] or not all(
            np.array_equal(x.rgba, y.rgba) for x, y in zip(a, b)):
        raise AssertionError(f"lossy animation {w}x{h}: GPU canvases != CPU "
                             f"canvases")
    log(f"lossy animation {w}x{h} crop: GPU bytes == CPU bytes "
        f"({len(gpu)} bytes, {len(a)} frames, {len(gc.calls)} candidate "
        f"encodes; the CPU run {cpu_s:.2f} s), canvases equal")

    # alpha on a small case: lossy frames with ALPH chunks, blended
    soft = [soft_alpha_image(f[:96, :128]) for f in crop[:4]]
    gpu, _, _, _ = encode_animation(soft, durations[:4], "cuda")
    cpu, _, _, _ = encode_animation(soft, durations[:4], "cpu")
    a, d = decode_animation(gpu, device="cuda")
    b, _ = decode_animation(gpu, device="cpu")
    if gpu != cpu or not all(np.array_equal(x.rgba, y.rgba)
                             for x, y in zip(a, b)):
        raise AssertionError("lossy animation with alpha 128x96: GPU != CPU")
    if not any(f.alpha_payload for f in d.frames):
        raise AssertionError("the alpha animation has no ALPH chunk")
    log(f"lossy animation with alpha 128x96: GPU bytes and canvases == CPU "
        f"({len(gpu)} bytes, {len(a)} frames)")


def anim_lossless(images, peek_counts, tag):
    """Phase 11's lossless animation on the card: a 1024x1024 keyframe and
    two small deltas; the chooser kernel runs on the encodes of 1 MP or
    more only; bytes == the CPU file with the plain chooser there."""
    import numpy as np

    from gowebp_tpu_torch.container.anim import decode_animation
    from gowebp_tpu_torch.models.vp8l import encoder as vp8l_enc
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm

    key = np.dstack([images[3], np.full((1024, 1024), 255, np.uint8)])
    f1 = key.copy()
    f1[100:148, 200:264, :3] = images[4][:48, :64]
    f2 = f1.copy()
    f2[600:632, 700:740, :3] = images[5][:32, :40]
    frames, durations = [key, f1, f2], [100, 50, 50]
    start = peek_counts()
    data, enc, cands, enc_s = encode_animation(
        frames, durations, "cuda", lossless=True,
        chooser_fn=vpm.predictor_search_entropy)
    mid = peek_counts()
    got = launched(start, mid)
    big = [c for c in cands.calls
           if c[0] >= vp8l_enc.DEVICE_CHOOSER_PIXELS]
    if (set(got) != {"predictor_search_entropy"} or not big
            or cands.calls[0][0] != 1024 * 1024
            or any((n > 0) != (p >= vp8l_enc.DEVICE_CHOOSER_PIXELS)
                   for p, _, n in cands.calls)):
        raise AssertionError(f"lossless animation: launches {got}, "
                             f"candidates (pixels, lossless, chooser "
                             f"launches) {cands.calls}")
    t0 = time.perf_counter()
    canvases, d = decode_animation(data, device="cuda")
    dec_s = time.perf_counter() - t0
    got_dec = launched(mid, peek_counts())
    if got_dec:
        raise AssertionError(f"lossless animation decode launched {got_dec}")
    log(f"lossless animation 1024x1024, keyframe + 2 deltas: {len(data)} "
        f"bytes, {len(cands.calls)} candidate encodes (pixels, "
        f"predictor_search_entropy launches): "
        f"{[(p, n) for p, _, n in cands.calls]}; the 1 MP ones are the "
        f"keyframe and the second frame's dispose-to-background candidate "
        f"(the keyframe's whole rectangle cleared); encode "
        f"{enc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms (VP8L on the "
        f"host, no kernel) {tag}")
    check_demuxed(d, enc, 0)
    theirs = pillow_frames(data)
    for j, (c, src) in enumerate(zip(canvases, frames)):
        if not (np.array_equal(c.rgba, src) and np.array_equal(c.rgba,
                                                               theirs[j])):
            raise AssertionError(f"lossless canvas {j} != its source or "
                                 f"Pillow's")
    t0 = time.perf_counter()
    cpu, _, _, _ = encode_animation(frames, durations, "cpu", lossless=True,
                                    switch_big=True)
    if cpu != data:
        raise AssertionError("lossless animation: GPU bytes != the CPU "
                             "bytes with the plain chooser at 1 MP")
    log(f"lossless animation: canvases == sources == Pillow's; GPU bytes == "
        f"CPU bytes, the plain chooser at 1 MP (the CPU run "
        f"{time.perf_counter() - t0:.2f} s)")
    return data


def mux_roundtrip(data: bytes) -> None:
    """Mux.from_bytes(...).assemble() gives the file back; with ICC, EXIF
    and XMP added Pillow still reads every frame."""
    import numpy as np

    from gowebp_tpu_torch.container.demux import demux
    from gowebp_tpu_torch.container.mux import Mux

    m = Mux.from_bytes(data)
    if m.assemble() != data:
        raise AssertionError("Mux.from_bytes(file).assemble() != the file")
    m.set_chunk("ICCP", b"\x00" * 128)
    m.set_chunk("EXIF", b"Exif\x00\x00smoke")
    m.set_chunk("XMP ", b"<x:xmpmeta/>")
    meta = m.assemble()
    d = demux(meta)
    if (d.iccp, d.exif, d.xmp) != (b"\x00" * 128, b"Exif\x00\x00smoke",
                                   b"<x:xmpmeta/>"):
        raise AssertionError("metadata chunks did not round-trip")
    a, b = pillow_frames(data), pillow_frames(meta)
    if len(a) != len(b) or not all(np.array_equal(x, y)
                                   for x, y in zip(a, b)):
        raise AssertionError("Pillow reads other frames with ICC/EXIF/XMP")
    log(f"mux: from_bytes round-trips {len(data)} bytes; with ICC, EXIF "
        f"and XMP ({len(meta)} bytes) Pillow reads the same {len(b)} frames")


def cli_phase(images, anim_data, peek_counts, reset_counts, read_counts,
              tag):
    """Phase 11's CLI in-process with its default device (CUDA): encode a
    1 MP PNG, decode it, info on it and on the animation."""
    import io
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    import gowebp_tpu_torch as T
    from gowebp_tpu_torch.__main__ import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        Image.fromarray(images[6]).save(tmp / "in.png")
        anim = tmp / "anim.webp"
        anim.write_bytes(anim_data)
        reset_counts()
        start = peek_counts()
        t0 = time.perf_counter()
        if cli(["encode", str(tmp / "in.png"), str(tmp / "out.webp")]):
            raise AssertionError("the CLI's encode failed")
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        mid = peek_counts()
        t0 = time.perf_counter()
        if cli(["decode", str(tmp / "out.webp"), str(tmp / "out.png")]):
            raise AssertionError("the CLI's decode failed")
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts("cli")
        # the CLI always fills EncodeStats, as the reference's does: its
        # PSNR decodes the frame once (recon_filter_mb)
        want = {"wavefront_search": 1, "recon_filter_mb": 1}
        if launched(start, mid) != want:
            raise AssertionError(f"CLI encode launches "
                                 f"{launched(start, mid)}, expected {want}")
        want = {k: 1 for k in SINGLE_DECODE_KERNELS}
        if launched(mid, counts) != want:
            raise AssertionError(f"CLI decode launches "
                                 f"{launched(mid, counts)}, expected {want}")
        data = (tmp / "out.webp").read_bytes()
        rgba = np.asarray(Image.open(tmp / "in.png").convert("RGBA"))
        cfg = T.EncoderConfig(lossless=False, quality=75.0, method=4,
                              near_lossless=100, target_size=0,
                              use_sharp_yuv=False, autofilter=False,
                              partitions=0, segments=4)
        t0 = time.perf_counter()
        again = T.encode_rgba(rgba, config=cfg, stats=T.EncodeStats(),
                              device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pixels = T.decode(data, device="cuda")
        t2 = time.perf_counter()
        if data != again:
            raise AssertionError("CLI encode bytes != encode_rgba's")
        png = np.asarray(Image.open(tmp / "out.png"))
        if not np.array_equal(png, pixels):
            raise AssertionError("CLI decode pixels != decode()'s")
        infos = []
        for path in (tmp / "out.webp", anim):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                if cli(["info", str(path)]):
                    raise AssertionError("the CLI's info failed")
            infos.append(json.loads(out.getvalue()))
    want = [{"width": 1024, "height": 1024, "format": "lossy",
             "has_alpha": False, "has_animation": False, "frames": 1,
             "loop_count": 0, "metadata": [], "size_bytes": len(data)},
            {"width": 1024, "height": 1024, "format": "mixed",
             "has_alpha": False, "has_animation": True, "frames": 7,
             "loop_count": 3, "metadata": [], "size_bytes": len(anim_data)}]
    if infos != want:
        raise AssertionError(f"CLI info {infos}, expected {want}")
    log(f"CLI (default device): encode of a 1 MP PNG == encode_rgba("
        f"device='cuda') ({len(data)} bytes; wavefront_search once, and "
        f"recon_filter_mb once for EncodeStats' PSNR), decode == "
        f"decode(device='cuda') (recon_filter_mb and yuv420_to_rgba once), "
        f"info JSON as expected on the file and the animation")
    log(f"CLI: encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms (PNG read and "
        f"write through Pillow included; the same encode_rgba call alone "
        f"{(t1 - t0) * 1e3:.3f} ms, decode() alone {(t2 - t1) * 1e3:.3f} ms) "
        f"{tag}")


def bittrace_phase(files, tag) -> None:
    """bit_accounting on a hybrid file and a lossless file: the classes sum
    to at most total_bits, the partitions' residuals to residuals."""
    from gowebp_tpu_torch.utils.bittrace import bit_accounting

    for name, data in files:
        t0 = time.perf_counter()
        r = bit_accounting(data)
        ms = (time.perf_counter() - t0) * 1e3
        c = r["classes"]
        if not 0 < sum(c.values()) <= r["total_bits"]:
            raise AssertionError(f"bit_accounting {name}: classes {c} "
                                 f"against {r['total_bits']} bits")
        if (r["format"] == "lossy"
                and sum(r["residuals_per_partition"]) != c["residuals"]):
            raise AssertionError(f"bit_accounting {name}: partitions "
                                 f"{r['residuals_per_partition']} != "
                                 f"{c['residuals']}")
        log(f"bit_accounting {name}: {r['format']}, {r['total_bits']} bits, "
            f"{c}, {ms:.1f} ms on the host {tag}")


def containers_phase(images, hybrid_file, lossless_file, peek_counts,
                     reset_counts, read_counts, tag) -> None:
    """Phase 11 (see the module docstring)."""
    t_phase = time.perf_counter()
    reset_counts()
    lossy, frames, durations = anim_lossy(images, peek_counts, tag)
    anim_lossless(images, peek_counts, tag)
    read_counts("animation")
    anim_card_vs_cpu(frames, durations)
    mux_roundtrip(lossy)
    cli_phase(images, lossy, peek_counts, reset_counts, read_counts, tag)
    bittrace_phase([("phase-4 hybrid file", hybrid_file),
                    ("phase-8d lossless file", lossless_file)], tag)
    log(f"phase 11 (containers, animation, CLI): "
        f"{time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import gowebp_tpu_torch  # noqa: F401  (fails outside a checkout)
    from gowebp_tpu_torch import (DecoderConfig, decode, decode_rgba_batch,
                                  decode_yuva, encode_rgba_batch)
    from gowebp_tpu_torch.decode import _upload, _upload_packed
    from gowebp_tpu_torch.tracing import StageClock
    from gowebp_tpu_torch.config import EncoderConfig
    from gowebp_tpu_torch.container.riff import parse_riff
    from gowebp_tpu_torch.models.vp8.decoder import (decode_vp8_symbols,
                                                     symbol_engine)
    from gowebp_tpu_torch.ops.encode_pipeline import (
        encode_rgba_batch_pipelined)
    from gowebp_tpu_torch.ops.kernels import coeff_unpack as cum
    from gowebp_tpu_torch.ops.kernels import encode_plane as epm
    from gowebp_tpu_torch.ops.kernels import i4_search as i4m
    from gowebp_tpu_torch.ops.kernels import vp8_recon as kvr
    from gowebp_tpu_torch.ops.kernels import vp8l_inverse as vim
    from gowebp_tpu_torch.ops.kernels import vp8l_predictor as vpm
    from gowebp_tpu_torch.ops.kernels import wavefront_fixed as wfm
    from gowebp_tpu_torch.ops.kernels import wavefront_search as wsm
    from gowebp_tpu_torch.ops.kernels import yuv420_to_rgba as yuvm
    from gowebp_tpu_torch.ops.kernels.cuda_build import build_all
    from gowebp_tpu_torch.utils.corpus import natural_images

    # kernel name -> (wrapper, the wrapper's attribute that counts it);
    # wavefront_search counts its trellis form apart
    counters = {name: (fn, "launches") for name, fn in (
        ("i4_search", i4m.i4_search), ("i4_walk", i4m.i4_walk),
        ("wavefront_fixed", wfm.wavefront_fixed),
        ("yuv420_to_rgba", yuvm.yuv420_to_rgba),
        *((name, getattr(epm, name)) for name in epm.KERNELS),
        ("wavefront_search", wsm.wavefront_search))}
    counters["wavefront_search_trellis"] = (wsm.wavefront_search,
                                            "trellis_launches")
    counters["recon_filter_mb"] = (kvr.recon_filter_mb, "launches")
    counters["unpack_coeffs"] = (cum.unpack_coeffs, "launches")
    counters["predictor_search_entropy"] = (vpm.predictor_search_entropy,
                                            "launches")
    counters["predictor_inverse"] = (vim.predictor_inverse, "launches")
    by_path = {}

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        torch.cuda.synchronize()

    def peek_counts():
        """Every kernel's launches since reset_counts."""
        return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}

    def read_counts(path):
        """Every kernel's launches since reset_counts, kept as ``path``'s."""
        by_path[path] = peek_counts()
        return by_path[path]

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    tag = f"({card})"
    log(f"card: {card}")
    peak, sms, mhz = int32_peak()
    log(f"int32 ceiling: {sms} SMs x {INT32_LANES_PER_SM} int32 ops a clock "
        f"x {mhz:.0f} MHz (max SM clock) = {peak / 1e12:.3f}e12 ops/s {tag}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    libraries = [i4m.LIBRARY, wfm.LIBRARY, yuvm.LIBRARY, epm.LIBRARY,
                 wsm.LIBRARY, kvr.LIBRARY, vpm.LIBRARY, cum.LIBRARY,
                 vim.LIBRARY]
    build_all(libraries)
    log(f"build: {len(SOURCES)} kernels from {len(libraries)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, parallel)")
    for lib in libraries:
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib.source.name}: {line.strip()}")

    # ---- phase 3: kernels vs plain versions, full shapes ----
    t0 = time.perf_counter()
    images = list(natural_images(32, 1024, 1024, seed=7))
    log(f"corpus: 32 x 1024x1024 in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(20261016)
    chunk = chunk_inputs(dev, images[:16])
    rows = [check_i4_search(dev, chunk), check_i4_walk(dev, chunk),
            check_wavefront(dev, gen), check_yuv420(dev, gen)]
    rows += check_encode_plane(dev, gen)
    rows.append(check_wavefront_search(dev, chunk))
    rows.append(check_wavefront_search_trellis(dev, chunk))
    rows.append(check_vp8l_predictor(dev, images[12]))
    time_rows(rows, tag)

    # ---- phase 4: the encode path ----
    mp = 32 * 1024 * 1024 / 1e6
    reset_counts()
    t0 = time.perf_counter()
    out = encode_rgba_batch(images, quality=75.0, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts("hybrid")
    launches = {k: counts[k] for k in ("i4_search", "i4_walk",
                                       "wavefront_fixed", "encode_luma_modes",
                                       "encode_chroma_modes")}
    log(f"encode path launches: {launches} (the flat i4_search runs only "
        f"on cold=\"dense\": the refine round runs i4_walk; the cold round "
        f"the plane kernels' modes-only forms)")
    for name in ("i4_walk", "wavefront_fixed", "encode_luma_modes",
                 "encode_chroma_modes"):
        if launches[name] == 0:
            raise AssertionError(f"encode path never launched {name}")
    for name in ("encode_luma_modes", "encode_chroma_modes"):
        if launches[name] != launches["wavefront_fixed"] // 2:
            raise AssertionError(f"{name}: {launches[name]} launches, not "
                                 f"one a chunk")
    if counts["encode_luma"] + counts["encode_chroma"]:
        raise AssertionError("the hybrid launched a full plane kernel")
    log(f"encode path first run: {mp / first_s:.3f} MP/s e2e "
        f"({first_s:.2f} s for 32 MP) {tag}")
    # phase 3g, on the decode path's inputs for these 32 files
    recon_rows = check_vp8_recon(dev, out)
    # phase 3i, on the same files' symbols
    unpack_rows, decode_group, decode_packed, k_cost = check_unpack(
        dev, out, tag)
    recon_rows += unpack_rows
    time_rows(recon_rows, tag)
    rows += recon_rows
    timings = {}
    t0 = time.perf_counter()
    again = encode_rgba_batch_pipelined(images, quality=75.0, threads=8,
                                        chunk=16, device="cuda",
                                        timings=timings)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    if again != out:
        raise AssertionError("second run's bytes differ from the first's")
    log(f"encode path timed run: {mp / second_s:.3f} MP/s e2e "
        f"({second_s:.2f} s for 32 MP) {tag}")
    for k, ms in timings["stage_ms"].items():
        log(f"stage {k}: {ms:.1f} ms total over 2 chunks {tag}")
    quiet = stage_spans(dev, chunk, reps=3)
    log("hybrid stages on one chunk of 16, host quiet (median of 3): "
        + ", ".join(f"{k} {quiet[k]:.3f} ms" for k in HYBRID_STAGES)
        + f" {tag}")
    log(f"stage host emit: {timings['emit_thread_s'] * 1e3:.1f} ms summed "
        f"over 32 images in 8 threads {tag}")
    log(f"bytes: {sum(len(o) for o in out)} total, "
        f"{sum(len(o) for o in out) * 8 / (32 * 1024 * 1024):.4f} bpp")

    # ---- phase 5: parity with the CPU path, headers ----
    for data in out:
        check_webp(data, 1024, 1024)
    t0 = time.perf_counter()
    cpu = encode_rgba_batch(images[:2], quality=75.0, device="cpu")
    log(f"cpu parity run: 2 images in {time.perf_counter() - t0:.1f} s")
    if cpu != out[:2]:
        raise AssertionError("GPU and CPU .webp bytes differ")
    log("parity: GPU bytes == CPU bytes on 2 images; 32 headers ok")

    # ---- phase 5b: the hybrid options, one chunk of 16 each ----
    variants = (
        ("cold=dense", {"cold": "dense"}),
        ("refine=2", {"refine": 2}),
        ("i4_topk=4", {"i4_topk": 4}),
        ("config method=3", {"config": EncoderConfig(
            lossless=False, quality=75.0, method=3)}))
    mp16 = 16 * 1024 * 1024 / 1e6
    for label, kw in variants:
        reset_counts()
        t0 = time.perf_counter()
        got = encode_rgba_batch_pipelined(images[:16], quality=75.0,
                                          threads=8, chunk=16, device="cuda",
                                          **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(label)
        log(f"{label}: launches {({k: n for k, n in counts.items() if n})}; "
            f"{mp16 / run_s:.3f} MP/s "
            f"({run_s:.2f} s for 16 MP, first run); "
            f"{sum(len(o) for o in got) * 8 / (16 * 1024 * 1024):.4f} bpp "
            f"{tag}")
        modes = counts["encode_luma_modes"] + counts["encode_chroma_modes"]
        if label == "cold=dense":
            if counts["i4_search"] == 0:
                raise AssertionError("cold=\"dense\" never launched i4_search")
            if modes:
                raise AssertionError("cold=\"dense\" launched a modes-only "
                                     "plane kernel")
            launches["i4_search"] = counts["i4_search"]
        elif modes != 2:
            raise AssertionError(f"{label}: {modes} modes-only plane kernel "
                                 f"launches in one chunk, not 2")
        if "method=3" in label and counts["i4_search"] + counts["i4_walk"]:
            raise AssertionError("an i4 kernel launched at method=3")
        if counts["wavefront_fixed"] == 0:
            raise AssertionError(f"{label} never launched wavefront_fixed")
        t0 = time.perf_counter()
        cpu = encode_rgba_batch_pipelined(images[:2], quality=75.0, chunk=2,
                                          device="cpu", **kw)
        if cpu != got[:2]:
            raise AssertionError(f"{label}: GPU and CPU .webp bytes differ")
        log(f"{label}: GPU bytes == CPU bytes on 2 images (cpu run "
            f"{time.perf_counter() - t0:.1f} s)")

    # ---- phase 5c: depth 1 against depth 3, 4 chunks of 8 ----
    for rep in (1, 2):
        for depth in (1, 3):
            timings = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = encode_rgba_batch_pipelined(
                images, quality=75.0, threads=8, chunk=8, device="cuda",
                depth=depth, timings=timings)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            if again != out:
                raise AssertionError(f"depth={depth}: bytes differ")
            log(f"depth={depth} run {rep}: {mp / run_s:.3f} MP/s "
                f"({run_s:.3f} s for 32 MP, 4 chunks of 8); host s: prep "
                f"{timings['prep']:.3f}, h2d {timings['h2d']:.4f}, fetch "
                f"{timings['fetch']:.3f}, emit {timings['emit_thread_s']:.3f} "
                f"(thread time) {tag}")

    # the pipeline's main thread should never wait for the stream: count
    # the synchronizing CUDA calls torch's sync debug mode reports in one
    # run of 4 chunks
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            encode_rgba_batch_pipelined(images, quality=75.0, threads=8,
                                        chunk=8, device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log(f"synchronizing CUDA calls in one run of 4 chunks of 8 (depth 3): "
        f"{syncs}")

    # ---- phase 6: the decode path ----
    log(f"decode: symbol engine {symbol_engine()} on this host")
    reset_counts()
    t0 = time.perf_counter()
    rgba = decode_rgba_batch(out, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts("decode")
    for name in DECODE_KERNELS:
        launches[name] = counts[name]
    log("decode path launches: " + ", ".join(
        f"{name} {counts[name]}" for name in DECODE_KERNELS))
    for name in DECODE_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"decode path never launched {name}")
    if counts["unpack_coeffs"] != counts["recon_filter_mb"]:
        raise AssertionError("decode path: unpack_coeffs not once a group")
    if any(counts[k] for k in counters if k not in DECODE_KERNELS):
        raise AssertionError("the decode path launched an encode kernel")
    log(f"decode first run: {mp / first_s:.3f} MP/s e2e "
        f"({first_s:.2f} s for 32 MP) {tag}")
    timings = {}
    t0 = time.perf_counter()
    again = decode_rgba_batch(out, device="cuda", timings=timings)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(again, rgba)):
        raise AssertionError("second decode's pixels differ from the first's")
    log(f"decode timed run: {mp / second_s:.3f} MP/s e2e "
        f"({second_s:.2f} s for 32 MP) {tag}")
    log(f"decode stage host symbols: {timings['symbols_s'] * 1e3:.1f} ms "
        f"(thread time, 32 images) {tag}")
    log(f"decode stage host pack: {timings['pack_s'] * 1e3:.1f} ms "
        f"(thread time, 32 images) {tag}")
    for k, ms in timings["stage_ms"].items():
        log(f"decode stage {k}: {ms:.1f} ms {tag}")
    # the dense upload of the parent's path, on the same group, timed the
    # same way (a stage clock around the buffer's fill and copy)
    spans = {}
    for label, up in (("packed", lambda: _upload_packed(
            decode_group, decode_packed, dev)),
                      ("dense", lambda: _upload(decode_group, dev))):
        clock = StageClock(dev)
        up()
        clock("h2d")
        spans[label] = clock.spans_ms()["h2d"]
    log(f"decode h2d: packed {timings['h2d_bytes']} bytes in "
        f"{timings['stage_ms']['h2d']:.3f} ms (timed run), "
        f"{spans['packed']:.3f} ms alone; dense (parent's path) "
        f"{k_cost['hybrid']['dense']['h2d_bytes']} bytes in "
        f"{spans['dense']:.3f} ms alone, the same group {tag}")
    dev_out = decode_rgba_batch(out, device="cuda", device_out=True)
    for a, b in zip(dev_out, rgba):
        if not (a.is_cuda and a.dtype == torch.uint8
                and np.array_equal(a.cpu().numpy(), b)):
            raise AssertionError("device_out result differs from the host's")
    log("decode device_out: 32 CUDA uint8 tensors == host results")

    # ---- phase 6b: the mixed decode: lossy, lossy + ALPH, VP8L ----
    decode_s = second_s
    t0 = time.perf_counter()
    alpha_files, lossless_files = mixed_decode_files(images)
    mixed = list(out)
    for k, data in enumerate(alpha_files + lossless_files):
        mixed.insert(5 * k + 2, data)
    extra = {5 * k + 2: data
             for k, data in enumerate(alpha_files + lossless_files)}
    hybrid_at = [i for i in range(len(mixed)) if i not in extra]
    log(f"mixed batch: 32 hybrid + 4 lossy+ALPH + 4 VP8L files of "
        f"1024x1024, written by Pillow in {time.perf_counter() - t0:.1f} s")
    mp_mixed = len(mixed) * 1024 * 1024 / 1e6
    # the counted run keeps its pixels on the card (device_out=True); the
    # timed run brings them back and is checked against it and Pillow
    reset_counts()
    yuvm.yuv420_to_rgba.alpha_launches = 0
    dev_out = decode_rgba_batch(mixed, device="cuda", device_out=True)
    torch.cuda.synchronize()
    counts = read_counts("decode_mixed")
    with_alpha = yuvm.yuv420_to_rgba.alpha_launches
    log("mixed decode launches: " + ", ".join(
        f"{name} {counts[name]}" for name in DECODE_KERNELS)
        + f"; yuv420_to_rgba {with_alpha} times with an alpha plane")
    for name in DECODE_KERNELS:
        if counts[name] < 2:
            raise AssertionError(f"the mixed decode did not launch {name} "
                                 f"for the lossy and the ALPH groups")
    if with_alpha < 1:
        raise AssertionError("the mixed decode never gave yuv420_to_rgba an "
                             "alpha plane")
    if any(counts[k] for k in counters if k not in DECODE_KERNELS):
        raise AssertionError("the mixed decode launched an encode kernel")
    timings = {}
    t0 = time.perf_counter()
    got = decode_rgba_batch(mixed, device="cuda", timings=timings)
    torch.cuda.synchronize()
    mixed_s = time.perf_counter() - t0
    for a, b in zip(dev_out, got):
        if not (a.is_cuda and a.dtype == torch.uint8
                and np.array_equal(a.cpu().numpy(), b)):
            raise AssertionError("mixed device_out result differs from the "
                                 "host's")
    log(f"mixed decode device_out: {len(mixed)} CUDA uint8 tensors == host "
        f"results")
    for i, data in extra.items():
        if not np.array_equal(got[i], pillow_rgba(data)):
            raise AssertionError(f"mixed file {i} decodes to other pixels "
                                 f"than Pillow's")
    for k, i in enumerate(hybrid_at):
        if not np.array_equal(got[i], rgba[k]):
            raise AssertionError("a hybrid file in the mixed batch decodes "
                                 "to other pixels than alone")
    log("mixed decode: 4 ALPH and 4 VP8L images == Pillow's; 32 hybrid "
        "images == phase 6's")
    t0 = time.perf_counter()
    cpu_alpha = decode_rgba_batch(alpha_files[:2], device="cpu")
    log(f"mixed cpu parity run: 2 ALPH images in "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(np.array_equal(a, got[i])
               for a, i in zip(cpu_alpha, sorted(extra)[:2])):
        raise AssertionError("GPU and CPU decoded ALPH images differ")
    log("mixed parity: GPU RGBA == CPU RGBA on 2 ALPH images")
    log(f"mixed decode timed run: {mp_mixed / mixed_s:.3f} MP/s e2e "
        f"({mixed_s:.2f} s for {mp_mixed:.1f} MP) {tag}")
    log(f"mixed decode host thread s: symbols {timings['symbols_s']:.3f}, "
        f"alpha {timings['alpha_s']:.3f} (4 planes), vp8l "
        f"{timings['vp8l_s']:.3f} (4 files) {tag}")
    for k, ms in timings["stage_ms"].items():
        log(f"mixed decode stage {k}: {ms:.1f} ms {tag}")
    # recon_backend="host": the whole decode on the host, no kernel
    host_mps = {}
    for label, files, want in (("hybrid", out, rgba), ("mixed", mixed, got)):
        reset_counts()
        timings = {}
        t0 = time.perf_counter()
        host = decode_rgba_batch(files, device="cuda", recon_backend="host",
                                 timings=timings)
        host_s = time.perf_counter() - t0
        if any(read_counts(f"decode_host_{label}").values()):
            raise AssertionError("recon_backend=\"host\" launched a kernel")
        if not all(np.array_equal(a, b) for a, b in zip(host, want)):
            raise AssertionError(f"recon_backend=\"host\" pixels differ from "
                                 f"the device path's ({label} files)")
        mp_h = len(files) * 1024 * 1024 / 1e6
        host_mps[label] = mp_h / host_s
        log(f"decode recon_backend=\"host\", {label} files: "
            f"{host_mps[label]:.3f} MP/s e2e ({host_s:.2f} s for {mp_h:.1f} "
            f"MP), pixels == the device path's; host thread s: symbols "
            f"{timings['symbols_s']:.3f}, recon and conversion "
            f"{timings['recon_host_s']:.3f} {tag}")
    log(f"decode backends on the 32 hybrid files: device "
        f"{mp / decode_s:.3f} MP/s (phase 6 timed run), host "
        f"{host_mps['hybrid']:.3f} MP/s; mixed batch: device "
        f"{mp_mixed / mixed_s:.3f}, host {host_mps['mixed']:.3f} MP/s {tag}")

    # ---- phase 6c: the single-file API on the card ----
    lossy_at = [i for i, d in enumerate(mixed)
                if parse_riff(d).find(b"VP8 ") is not None]
    reset_counts()
    t0 = time.perf_counter()
    single = [decode(d, device="cuda") for d in mixed]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    counts = read_counts("decode_single")
    want_counts = {k: len(lossy_at) if k in SINGLE_DECODE_KERNELS else 0
                   for k in DECODE_KERNELS}
    log(f"single-file decode of the {len(mixed)} files, one decode() call "
        f"each: " + ", ".join(f"{k} {counts[k]}" for k in DECODE_KERNELS)
        + f" launches ({len(lossy_at)} lossy files) in {single_s:.2f} s")
    if any(counts[k] != n for k, n in want_counts.items()):
        raise AssertionError(f"single-file decode launches {counts}, want "
                             f"{want_counts}")
    if any(counts[k] for k in counters if k not in DECODE_KERNELS):
        raise AssertionError("the single-file decode launched an encode "
                             "kernel")
    for i, (a, b) in enumerate(zip(single, got)):
        if not np.array_equal(a, b):
            raise AssertionError(f"decode() of file {i} != decode_rgba_batch")
    log(f"single-file decode: {len(mixed)} files == decode_rgba_batch's "
        f"pixels")
    one = out[0]
    payload = parse_riff(one).find(b"VP8 ").payload
    dev_ms, host_ms, sym_ms = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(one, device="cuda")
        dev_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decode_rgba_batch([one], device="cuda", recon_backend="host")
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        decode_vp8_symbols(payload)
        sym_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"single-file decode of one 1 MP lossy file, median of 5: "
        f"decode(device=\"cuda\") {statistics.median(dev_ms):.3f} ms "
        f"(its host symbol phase alone {statistics.median(sym_ms):.3f} ms), "
        f"recon_backend=\"host\" {statistics.median(host_ms):.3f} ms {tag}")
    # options and modes against the CPU path (the kernels' plain versions)
    # on two lossy files, one ALPH and one VP8L file of 255x193: the CPU's
    # plain loops take seconds a 1 MP file
    small = single_file_parity_files(images)
    configs = {
        "crop": dict(use_cropping=True, crop_left=37, crop_top=21,
                     crop_width=150, crop_height=111),
        "scale": dict(use_scaling=True, scaled_width=301, scaled_height=97),
        "flip": dict(flip=True),
        "bypass_filtering": dict(bypass_filtering=True),
        "no_fancy_upsampling": dict(no_fancy_upsampling=True),
        "dithering_strength=50": dict(dithering_strength=50),
        "alpha_dithering_strength=50": dict(alpha_dithering_strength=50),
    }
    t0 = time.perf_counter()
    n_checks = 0
    for fname, data in small.items():
        cases = [(c, DecoderConfig(**kw), "RGBA") for c, kw in configs.items()]
        cases += [(m, None, m) for m in ("bgrA", "RGB_565", "ARGB")]
        for what, cfg, mode in cases:
            a = decode(data, cfg, mode, device="cuda")
            b = decode(data, cfg, mode, device="cpu")
            n_checks += 1
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"decode({fname}, {what}) on the card "
                                     f"!= on the CPU")
        if fname == "lossy_smooth_q95":
            plain_px = decode(data, device="cuda")
            dithered = decode(data, DecoderConfig(dithering_strength=50),
                              device="cuda")
            if np.array_equal(plain_px, dithered):
                raise AssertionError("dithering_strength=50 changed no pixel "
                                     "of the smooth q95 file")
        if not fname.startswith("vp8l"):
            cfg = DecoderConfig(**configs["crop"])
            for a, b in zip(decode_yuva(data, cfg, device="cuda"),
                            decode_yuva(data, cfg, device="cpu")):
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    raise AssertionError(f"decode_yuva({fname}, crop) on the "
                                         f"card != on the CPU")
            n_checks += 1
    log(f"single-file parity: {n_checks} calls on {len(small)} files "
        f"({', '.join(small)}) == device=\"cpu\" in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 6d: the incremental decoder on the card ----
    incremental_decode(dev, out[0], rgba[0], small, reset_counts,
                       read_counts, tag)

    # ---- phase 7: decode parity ----
    for a in rgba:
        if a.shape != (1024, 1024, 4) or not (a[..., 3] == 255).all():
            raise AssertionError(f"bad decoded image {a.shape}")
    t0 = time.perf_counter()
    cpu_rgba = decode_rgba_batch(out[:2], device="cpu")
    log(f"decode cpu parity run: 2 images in {time.perf_counter() - t0:.1f} s")
    if not all(np.array_equal(a, b) for a, b in zip(cpu_rgba, rgba[:2])):
        raise AssertionError("GPU and CPU decoded RGBA differ")
    log("decode parity: GPU RGBA == CPU RGBA on 2 images")
    scores = [psnr(a[..., :3], im[..., :3]) for a, im in zip(rgba, images)]
    log(f"decode PSNR vs source: mean {statistics.mean(scores):.3f} dB, "
        f"min {min(scores):.3f} dB over 32 images")
    if min(scores) < 20.0:
        raise AssertionError(f"decoded image below 20 dB ({min(scores):.3f})")

    # ---- phase 8: the open-loop encode path ----
    reset_counts()
    t0 = time.perf_counter()
    fast = encode_rgba_batch(images, quality=75.0, device="cuda",
                             engine="openloop")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts("openloop")
    launches["encode_luma"] = counts["encode_luma"]
    launches["encode_chroma"] = counts["encode_chroma"]
    log(f"openloop path launches: encode_luma {launches['encode_luma']}, "
        f"encode_chroma {launches['encode_chroma']}")
    for name in ("encode_luma", "encode_chroma"):
        if launches[name] == 0:
            raise AssertionError(f"openloop path never launched {name}")
    log(f"openloop first run: {mp / first_s:.3f} MP/s e2e "
        f"({first_s:.2f} s for 32 MP) {tag}")
    timings = {}
    t0 = time.perf_counter()
    again = encode_rgba_batch_pipelined(images, quality=75.0, threads=8,
                                        chunk=16, device="cuda",
                                        engine="openloop", timings=timings)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    if again != fast:
        raise AssertionError("second openloop run's bytes differ")
    log(f"openloop timed run: {mp / second_s:.3f} MP/s e2e "
        f"({second_s:.2f} s for 32 MP) {tag}")
    for k, ms in timings["stage_ms"].items():
        log(f"openloop stage {k}: {ms:.1f} ms total over 2 chunks {tag}")
    log(f"openloop stage host emit: {timings['emit_thread_s'] * 1e3:.1f} ms "
        f"summed over 32 images in 8 threads {tag}")
    log(f"openloop bytes: {sum(len(o) for o in fast)} total, "
        f"{sum(len(o) for o in fast) * 8 / (32 * 1024 * 1024):.4f} bpp")
    for data in fast:
        check_webp(data, 1024, 1024)
    t0 = time.perf_counter()
    cpu = encode_rgba_batch(images[:2], quality=75.0, device="cpu",
                            engine="openloop")
    log(f"openloop cpu parity run: 2 images in "
        f"{time.perf_counter() - t0:.1f} s")
    if cpu != fast[:2]:
        raise AssertionError("openloop GPU and CPU .webp bytes differ")
    log("openloop parity: GPU bytes == CPU bytes on 2 images; 32 headers ok")
    dec = decode_rgba_batch(fast[:4], device="cuda")
    scores = [psnr(a[..., :3], im[..., :3]) for a, im in zip(dec, images)]
    log(f"openloop PSNR vs source (4 files decoded on the card): "
        f"{', '.join(f'{s:.3f}' for s in scores)} dB; floor "
        f"{OPENLOOP_PSNR_FLOOR_DB} dB")
    if min(scores) < OPENLOOP_PSNR_FLOOR_DB:
        raise AssertionError(f"openloop decode below its PSNR floor "
                             f"({min(scores):.3f} dB)")

    # ---- phase 8b: the exact engine (engine="wavefront") ----
    hybrid_kernels = ("i4_search", "i4_walk", "wavefront_fixed",
                      *epm.KERNELS)
    reset_counts()
    t0 = time.perf_counter()
    exact = encode_rgba_batch(images, quality=75.0, device="cuda",
                              engine="wavefront")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = read_counts("wavefront")
    launches["wavefront_search"] = counts["wavefront_search"]
    log(f"wavefront path launches: wavefront_search "
        f"{launches['wavefront_search']}; the hybrid's and the plane "
        f"kernels {sum(counts[k] for k in hybrid_kernels)}")
    if launches["wavefront_search"] == 0:
        raise AssertionError("wavefront path never launched wavefront_search")
    if any(counts[k] for k in hybrid_kernels):
        raise AssertionError("the wavefront path launched a hybrid or plane "
                             "kernel")
    log(f"wavefront first run: {mp / first_s:.3f} MP/s e2e "
        f"({first_s:.2f} s for 32 MP) {tag}")
    timings = {}
    t0 = time.perf_counter()
    again = encode_rgba_batch_pipelined(images, quality=75.0, threads=8,
                                        chunk=16, device="cuda",
                                        engine="wavefront", timings=timings)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    if again != exact:
        raise AssertionError("second wavefront run's bytes differ")
    log(f"wavefront timed run: {mp / second_s:.3f} MP/s e2e "
        f"({second_s:.2f} s for 32 MP) {tag}")
    for k, ms in timings["stage_ms"].items():
        log(f"wavefront stage {k}: {ms:.1f} ms total over 2 chunks {tag}")
    log(f"wavefront stage host emit: {timings['emit_thread_s'] * 1e3:.1f} "
        f"ms summed over 32 images in 8 threads {tag}")
    for data in exact:
        check_webp(data, 1024, 1024)
    t0 = time.perf_counter()
    cpu = encode_rgba_batch(images[:2], quality=75.0, device="cpu",
                            engine="wavefront")
    log(f"wavefront cpu parity run: 2 images in "
        f"{time.perf_counter() - t0:.1f} s")
    if cpu != exact[:2]:
        raise AssertionError("wavefront GPU and CPU .webp bytes differ")
    log("wavefront parity: GPU bytes == CPU bytes on 2 images; 32 headers ok")
    exact_rgba = decode_rgba_batch(exact, device="cuda")
    for data, a in zip(exact, exact_rgba):
        if not np.array_equal(pillow_rgba(data), a):
            raise AssertionError("a wavefront file decodes to other pixels "
                                 "through Pillow than through the port")
    log("wavefront files: 32 decodes through the port == Pillow's")
    e_scores = [psnr(a[..., :3], im[..., :3])
                for a, im in zip(exact_rgba, images)]
    h_scores = [psnr(a[..., :3], im[..., :3]) for a, im in zip(rgba, images)]
    e_bytes, h_bytes = sum(len(o) for o in exact), sum(len(o) for o in out)
    log(f"exact vs hybrid: PSNR mean {statistics.mean(e_scores):.3f} / "
        f"{statistics.mean(h_scores):.3f} dB (min {min(e_scores):.3f} / "
        f"{min(h_scores):.3f}), {e_bytes * 8 / (32 * 1024 * 1024):.4f} / "
        f"{h_bytes * 8 / (32 * 1024 * 1024):.4f} bpp; the hybrid's size "
        f"{h_bytes / e_bytes:.4f}x the exact engine's")
    if min(e_scores) < 20.0:
        raise AssertionError(f"exact-engine decode below 20 dB "
                             f"({min(e_scores):.3f})")

    # ---- phase 8c: the single-image encode ----
    launches["wavefront_search_trellis"] = single_image_encode(
        dev, images, reset_counts, read_counts, tag)

    # ---- phase 8d: the lossless encode ----
    launches["predictor_search_entropy"], lossless_file = lossless_encode(
        dev, images, reset_counts, read_counts, tag)

    # ---- phase 10: parallel/, the sharded steps ----
    inverse_row, counts = check_parallel(dev, images, out, reset_counts,
                                         read_counts, tag)
    time_rows([inverse_row], tag)
    rows.append(inverse_row)
    launches["predictor_inverse"] = counts["predictor_inverse"]

    # ---- phase 11: containers, animation, the CLI, bit accounting ----
    containers_phase(images, out[0], lossless_file, peek_counts,
                     reset_counts, read_counts, tag)

    # ---- phase 9: result lines ----
    kernels = []
    for r in rows:
        kernels.append({
            "name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
            "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "launches_by_path": {path: counts[r["name"]]
                                 for path, counts in by_path.items()},
        })
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(int(sys.argv[2]), int(sys.argv[3]),
                                 int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())

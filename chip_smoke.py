#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``video_restore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py [--only NAME[,NAME...]]

``--only`` runs a subset for a quick probe: any of ``k1`` (K1's tensor-core
route alone: its odd-shape checks and the old and new kernel side by side),
``k1n`` (the same for K1's narrow route), ``k2`` (the same for K2's rows
route), ``k5``, ``k3``, ``k6`` and ``k4``
(the same for K5's, K3's, K6's and K4's tensor-core routes), ``kernels``
(all of phase 3), ``paths`` (phases 4-10) or single path tags
(``main``, ``config4``, ``tiled_x4plus``, ``tiled_x4_v3``, ``main_int8``,
``config4_int8``, ``tiled_x4plus_int8``, ``main_pallas``, ``main_tailq``,
``faces``, ``outscale``), ``io`` (phase 11), ``bench`` (phase 12),
``gfpgan`` (phase 13). Phases 1 and 2 always run. A partial run prints
neither the per-kernel record nor the final ``{"ok": true, ...}`` line; the
run that counts is the one without arguments.

Phases, each of which stops the run with a non-zero exit when it fails:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from ``video_restore_tpu_torch/csrc`` (K1
   ``conv3x3_mma.cu`` on ``mma_tile.cuh``, ``conv3x3_narrow.cu`` and
   ``conv3x3.cu``, K2
   ``unsharp_rows.cu`` and ``unsharp.cu``, K3 ``srvgg_up_mma.cu`` on ``mma_tile.cuh`` and
   ``srvgg_up.cu``, K4 ``conv3x3_i8_mma.cu`` on ``mma_tile.cuh`` and
   ``conv3x3_i8.cu`` with its amax entry point, K5
   ``rdb_fused_mma.cu`` on ``mma_tile.cuh`` and ``rdb_fused.cu``, each with
   its one-RDB and whole-RRDB entry points, K6 ``tail_fused_mma.cu`` on
   ``mma_tile.cuh`` and ``tail_fused.cu``), and
   print each kernel's registers, shared memory and spills from ``ptxas``;
3. K1's tensor-core route (``conv3x3:mma``) first: every single conv at odd
   shapes in bf16 (ragged 2x37x53, a frame smaller than one tile, each
   activation, the residuals, the growth-buffer slices with cin 64..192,
   ``upsample2``) within one bf16 step of its plain version per value and
   of a float64 conv of the same inputs, each launch counted under its
   route; then one 1080p RDB on the old kernel (``conv3x3:fma``, forced)
   and on the new one, side by side, with each conv's time. K1's narrow
   route (``conv3x3:narrow``): the stems (cin 3 and 12 -> 64, act none,
   PReLU and lrelu, odd shapes, a frame of one pixel, a strided cin-3 view,
   the flagship frame and the tile batch) and ``conv_last`` (64 -> 3, odd
   shapes, a prefix view of a wider buffer, the flagship's 1x4320x7680x64
   and the tile batch's 6x1504x1792x64), each ``torch.equal`` to the
   forced ``fma`` route and within ``compare``'s bound of plain, each
   launch counted under its kernel; then the old kernel, the new one and
   ``F.conv2d`` side by side at both flagship shapes, the new one at least
   3x the old. K2's rows route (``unsharp_fused:rows``) in fp32: odd
   shapes (B = 2 at W*C % 4 != 0, frames smaller than the halo, 4 rows over
   9 strips, a 2x1037x1283 frame whose runs cross strips and frames, an x
   4 bytes off a 16-byte boundary), radius 0, 1, 4 and 16, thresholds 0 and
   0.02, and the flagship's 1x4320x7680x3, each ``torch.equal`` to the
   forced ``tile`` route and within ``compare``'s bound of plain; then the
   old kernel, the new one, the plain version and ``dst.copy_(src)`` of the
   8K frame side by side, the new one at least 3x the old. K5's
   tensor-core route (``rdb_fused_k5:mma``, ``rrdb_fused:mma``) the same
   way: one RDB (with and without ``x0``) and a whole RRDB in bf16 at nf 64
   / gc 32 at odd shapes (a frame smaller than one tile, ragged extents no
   tile divides, B = 2, more tiles than the persistent grid has blocks)
   within ``compare``'s bf16 tolerance of the plain version, the largest
   error in bf16 steps printed, then the old kernel (``fma``, forced) and
   the new one side by side on one 1080p RDB and RRDB with the cuDNN
   chain's time. K3's tensor-core route (``srvgg_up_fused:mma``) at r 2 and
   r 4 at odd shapes, the config-4 frame and the tile batch, within one
   bf16 step per value of the plain version, old and new side by side. K6's
   tensor-core route (``tail_fused_q:mma``) in bf16 at nf 64 at odd shapes
   (B = 2, ragged extents no 16x28 tile divides, a frame smaller than one
   tile, more tiles than the persistent grid has blocks) and at the
   flagship's 1x2160x3840x64, within ``compare``'s bf16 bound of the plain
   version with the largest error in bf16 steps; at the flagship shape
   ``bit_equal_to_k1_chain`` (against the three K1 launches) and the old
   kernel (``fma``, forced) and the new one side by side beside the cuDNN
   chain of 3, the new one at least 3x the old. K4's tensor-core route
   (``conv3x3_i8:mma``), dynamic and static A8: each of the five RDB convs
   (growth-buffer prefix views, pixel stride 192) and an SRVGG PReLU conv at
   odd shapes (B = 2 ragged, below one tile, one pixel past a tile column,
   more tiles than the card has SMs), the quantiser on all 65280 finite bf16
   values through a centre-tap identity at 38 scales, and the whole int8 RDB
   at 1x1080x1920x64 and 6x376x448x64, each ``torch.equal`` to the forced
   ``dp4a`` route and to the plain version with equal output amax; then the
   old and the new kernel side by side beside K1's bf16 RDB and the bf16
   cuDNN chain (the new one at least 3x the old at 1080p), and the same for
   the SRVGG int8 body. Then
   every kernel wrapper against its plain PyTorch version on the card, in
   fp32 (tight) and bf16 (the working type), at odd shapes and at the
   shapes of the main paths (the flagship frame, the config-4 frame and
   phase 7's tile batch), with kernel, plain and library times (one cuDNN
   call or chain of calls over the same convs, never used by the port) and
   the bound; K4 (bf16 only) within one bf16 step of its plain version per
   value, for each of the five RDB convs and an SRVGG conv at odd shapes
   and for the whole int8 RDB at the flagship and tile-batch shapes; K5's
   one RDB and whole RRDB (fp32 and bf16) at odd shapes with nf 16 / gc 8
   and nf 64 / gc 32, and in bf16 at the flagship body shape and at
   ``bench_rdb``'s 4x384x504 (library: a cuDNN chain of 5 and of 15 convs);
   K6's one-launch tail (fp32 and bf16) at odd shapes with nf 16 and nf 64,
   whose doubled extents no tile divides, so both intermediates' edge masks
   are exercised, and in bf16 at the flagship's 1x2160x3840x64 (library:
   the cuDNN chain of 3 convs); the amax kernel equal to its plain version
   bit for bit at odd shapes (B = 2, C = 3, C = 32 prefix views at channel
   offsets 64..160 of a 192-wide buffer, a misaligned view on its scalar
   path) and at 1080p, timed beside ``torch.linalg.vector_norm``; K4's
   static-A8 mode (fixed scales, no amax)
   for each of the five RDB convs at an odd shape and for the whole static
   RDB at the flagship and tile-batch shapes, with 5 launches and no amax
   launch per RDB;
4. the flagship path: a 3-frame 1080x1920 y4m with a hard cut before frame
   3 through ``VideoRestorer`` as the CLI builds it (RealESRGAN_x4plus at
   full width, random weights, enhanced: bilateral 0.5, CLAHE on the LR
   input, unsharp 0.3, temporal EMA; full frame; bf16; the y4m sink takes
   planar I420 from the device, fetched through the pinned ring) with
   every launch counter reset before and read after: 3 frames of 7680x4320
   out, decoded == inferred == encoded, and each wrapper launched exactly
   its per-frame count times 3, K1 351 times per frame of which 349 on the
   ``mma`` route and 2 on ``narrow`` (the stem and ``conv_last``, one on
   each of its kernels), none on ``fma``, and K2 once on ``rows``; the
   ``auto_full_frame`` estimate is printed beside the measured peak memory;
   the wall, the step and the encode thread's ``fetch`` and ``encode``
   totals per frame; then (``[post]``) the step by stage:
   ``restore_step``'s stage functions wrapped in CUDA events over the 3
   frames, beside the step's own time, with ``rgb_to_yuv420_planar`` and
   the pinned fetch of the planes beside ``quantize_u8`` and the pageable
   ``.cpu()`` of the RGB frame, and the fetch on the compute stream against
   a side stream; and the same config with ``device_yuv="off"`` (RGB out,
   host colour conversion), whose file equals the RGB kernel path's frames
   after the y4m colour round trip;
5. the same frames through the kernel path (RGB and I420 out) and the plain
   path on the card: the RGB kernel path >= 45 dB PSNR on u8 against the
   plain one, and the CLI's planes equal to the I420 kernel path's byte for
   byte;
6. path A, config 4: the same clip through ``--model RealESRGAN_x4_v3
   --anime-mode --quality fast`` (SRVGGNetCompact at full width, nf 64,
   32 convs, synthetic weights from a seed; full frame chosen by
   ``auto_full_frame``; bf16; bilateral 0.5, CLAHE, temporal EMA), with
   the checks of phases 4 and 5;
7. path B, config 2's tiles: a 2-frame 720x1280 clip through
   ``--tile-size 512 --tile-overlap 32`` (seamless blending on a 2x3 grid)
   for RealESRGAN_x4plus and RealESRGAN_x4_v3, with the checks of phases 4
   and 5 (launch counts: per model call x chunks x frames);
8. the int8 paths (``--precision int8``, the W8A8 body on K4), 2 frames
   each: the flagship flags at 1080p, config 4, and 720p tiles with
   RealESRGAN_x4plus, with the checks of phases 4 and 5 (K4 by route: 345
   ``conv3x3_i8:mma`` per flagship frame, 32 per config-4 frame, no
   ``dp4a``), and the int8 output against the bf16 kernel path's (>= 35 dB
   on u8 per frame);
9. ``[main_pallas]``: the flagship flags with ``VRT_PALLAS=1`` (one K5
   launch per RRDB block, 23 per frame, and no five-K1 RDB), 2 frames, with
   the checks of phases 4 and 5, and the output against the default body's
   kernel path (>= 45 dB on u8 per frame: one function, summed in another
   order);
10. ``[main_tailq]``: the flagship flags with ``VRT_TAIL_Q=1`` (one K6
    launch per frame, on the ``mma`` route, in place of the three-K1 tail;
    its frames are expected to equal the default tail's: inf dB), 2 frames,
    with the
    checks of phases 4 and 5, and the output against the default tail's
    kernel path (>= 45 dB on u8 per frame: one function, two kernel
    routes); the step's ms/frame and the path's peak memory are printed
    beside the default tail's;
11. ``[io]``: the pinned ring under stress, the
    native framecodec (it must load) against numpy on an 8K frame, and an
    mp4 clip with audio through the repo's fake ffmpeg: the planes on the
    encoder pipe, the audio copy, segmented resume and a batch directory
    (``phase_io``);
12. ``[bench_rdb]``: ``python -m video_restore_tpu_torch.tools.bench_rdb``'s
    five modes (k1, fused, rrdb, int8, int8s) at its default shape, each
    checked against its plain version on its first application, then timed;
13. ``[gfpgan]``: GFPGAN v1-clean at its full published width
    (``GFPGANSpec()``: 512 px crops, 512 style features, channel multiplier
    2) from the schema-exact synthetic checkpoint written as a ``.pth`` and
    read back through ``load_gfpgan`` (``VRT_GFPGAN_RANDOM`` unset), on
    ``golden_tiles(seed=11, 1, 512, 512)`` against
    ``tests/goldens/GFPGANv1.4.npz`` (>= 45 dB PSNR and SSIM >= 0.99 with
    TF32 off, the port's choice; TF32 printed beside it), the card's forward
    against the CPU forward of the same module at batch 2 (max abs error <=
    2e-3, >= 45 dB), ms per crop at batch 1, 2, 4 and 8 with TF32 off and
    on, the FLOPs per crop from the shapes with the bounds at the fp32 and
    TF32 peaks, and the peak memory;
14. ``faces``: RealESRGAN_x4plus at full frame on a 3-frame 720x1280 y4m
    with skin-toned faces the skin detector finds (three in frame 0, one
    over the left edge; none in frame 1; two in frame 2), through the CLI's
    config without ``--face-enhance`` (RGB out), with ``--face-enhance
    --face-model gfpgan`` (the synthetic checkpoint) and with
    ``--face-model regions``: the written frames equal the step's outside
    every face region byte for byte and equal the card's face pass of the
    step's frames inside; the card's pass within 2 levels of the same pass
    on the CPU (at most 1% of values differ; the prior on the CPU for frame
    0); K1 launched as the x4plus table says; a ``faces`` stage in
    ``last_stats``; wall, the step, the faces stage and the pass's time
    per frame, and the peak memory;
15. ``outscale``: RealESRGAN_x4_v3 (config 4's seeded weights) at full
    frame on 2 frames of 1080x1920 with ``--outscale 2``: 2 frames of
    3840x2160 written, each equal to the card's Lanczos4 resize of the
    step's frame and within 1 level of the port's CPU resize of it; config
    4's launch counts; wall, step and resize ms per frame.

The card's ``nvidia-smi`` line is printed first and again just before the
per-kernel JSON record, which is the line before the last (``launches`` sums
the counts of the CLI runs of phases 4, 6-10, 14 and 15 and of phase 12, the
static-A8 row those of ``bench_rdb``'s int8s run, which the wrapper counts
under ``rdb_fused_i8``; phase 11's runs are counted and checked on their
own, and left out of the sums);
the last line is
``{"ok": true, "device": {...}}``. Work files go to ``build/chip_smoke/``
and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import queue
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

PALLAS = {
    "conv3x3_fused": "video_restore_tpu/ops/pallas_tail.py:767",
    "rdb_fused": "video_restore_tpu/ops/pallas_stripe.py:1963",
    "up1_fused": "video_restore_tpu/ops/pallas_tail.py:603",
    "tail_fused": "video_restore_tpu/ops/pallas_tail.py:266",
    "unsharp_fused": "video_restore_tpu/ops/pallas_post.py:131",
    # also #15 srvgg_stripe2d_padded (:370) and #16 srvgg_stripe_padded (:131)
    "srvgg_body": "video_restore_tpu/ops/pallas_srvgg.py:635",
    # also #18 srvgg_up_fused (:854), the tiled form
    "srvgg_up_fused": "video_restore_tpu/ops/pallas_srvgg.py:1025",
    # K4: the int8 (sws) branch of _conv_prefix, which the RDB kernels
    # (#2-#4, #9, #10) and the SRVGG body kernels (#14-#16) run
    "rdb_fused_i8": "video_restore_tpu/ops/pallas_stripe.py:358",
    "srvgg_body_i8": "video_restore_tpu/ops/pallas_stripe.py:358",
    # the per-chunk |max| of _quant_act, for a tensor K4 did not write
    "act_amax": "video_restore_tpu/ops/pallas_stripe.py:239",
    # K5, one RDB: #20 rdb_fused, and #12 rdb_stripe (pallas_stripe.py:2079)
    "rdb_fused_k5": "video_restore_tpu/ops/pallas_rdb.py:313",
    # K5, a whole RRDB: #19 rrdb_fused (VRT_PALLAS=1), and #11
    # rrdb_stripe_padded (pallas_stripe.py:1016)
    "rrdb_fused": "video_restore_tpu/ops/pallas_rdb.py:257",
    # K6: #13 tail_fused_q (VRT_TAIL_Q=1), the tail in one launch
    "tail_fused_q": "video_restore_tpu/ops/pallas_tail.py:1018",
    # K4, static A8: the sa_static branch of _conv_prefix (_quant_act_static),
    # the sas arguments of #2 and #3; its launches count under rdb_fused_i8
    "rdb_fused_i8 static": "video_restore_tpu/ops/pallas_stripe.py:293",
    # K1's tensor-core route, timed on conv_body + residual: the dense-block
    # convs of #2-#4, #9, #10, conv_body (#1), up1 (#5), upconv2 and conv_hr
    # (#6, #7) and the SRVGG body (#14-#16)
    "conv3x3:mma": "video_restore_tpu/ops/pallas_stripe.py:1963",
    # K1's narrow route, conv_last (#6, #7: the tail's last conv, 64 -> 3);
    # its launches are those of the conv_last kernel
    "conv3x3:narrow conv_last": "video_restore_tpu/ops/pallas_tail.py:266",
}
# the hand-written kernel behind each row where a wrapper has two
# (ops/tail.py::conv3x3_route, ops/rdb.py::rdb_route,
# ops/srvgg.py::srvgg_up_route, ops/tail.py::tail_fused_route,
# ops/quant.py::conv3x3_i8_route, ops/unsharp.py::unsharp_route), as the
# row's calls take it
CUDA_ROUTE = {
    "conv3x3_fused": "narrow", "rdb_fused": "mma", "up1_fused": "mma",
    "tail_fused": "mma+narrow", "srvgg_body": "mma", "srvgg_up_fused": "mma",
    "rdb_fused_k5": "mma", "rrdb_fused": "mma", "conv3x3:mma": "mma",
    "tail_fused_q": "mma", "rdb_fused_i8": "mma", "srvgg_body_i8": "mma",
    "rdb_fused_i8 static": "mma", "conv3x3:narrow conv_last": "narrow",
    "unsharp_fused": "rows",
}
SOURCE = {
    # K1 is three routes (ops/tail.py::conv3x3_route). This row times the
    # stem (cin 3), on the narrow route; conv_body is conv3x3:mma's
    "conv3x3_fused": "video_restore_tpu_torch/csrc/conv3x3_narrow.cu",
    "rdb_fused": "video_restore_tpu_torch/csrc/conv3x3_mma.cu",
    "up1_fused": "video_restore_tpu_torch/csrc/conv3x3_mma.cu",
    # upconv2 and conv_hr; conv_last (cout 3) is conv3x3:narrow conv_last's
    "tail_fused": "video_restore_tpu_torch/csrc/conv3x3_mma.cu",
    # K2 is two kernels (ops/unsharp.py::unsharp_route); the paths' frames
    # (fp32, C = 3) take the rows one
    "unsharp_fused": "video_restore_tpu_torch/csrc/unsharp_rows.cu",
    "srvgg_body": "video_restore_tpu_torch/csrc/conv3x3_mma.cu",
    "srvgg_up_fused": "video_restore_tpu_torch/csrc/srvgg_up_mma.cu",
    # K4 is two kernels (ops/quant.py::conv3x3_i8_route); these rows' convs
    # (nf 64 / gc 32) take the int8 tensor-core one
    "rdb_fused_i8": "video_restore_tpu_torch/csrc/conv3x3_i8_mma.cu",
    "srvgg_body_i8": "video_restore_tpu_torch/csrc/conv3x3_i8_mma.cu",
    "act_amax": "video_restore_tpu_torch/csrc/conv3x3_i8.cu",
    "rdb_fused_k5": "video_restore_tpu_torch/csrc/rdb_fused_mma.cu",
    "rrdb_fused": "video_restore_tpu_torch/csrc/rdb_fused_mma.cu",
    "tail_fused_q": "video_restore_tpu_torch/csrc/tail_fused_mma.cu",
    "rdb_fused_i8 static": "video_restore_tpu_torch/csrc/conv3x3_i8_mma.cu",
    "conv3x3:mma": "video_restore_tpu_torch/csrc/conv3x3_mma.cu",
    "conv3x3:narrow conv_last": "video_restore_tpu_torch/csrc/conv3x3_narrow.cu",
}
PATH_TAGS = (
    "main", "config4", "tiled_x4plus", "tiled_x4_v3", "main_int8",
    "config4_int8", "tiled_x4plus_int8", "main_pallas", "main_tailq",
)
# the paths after the face prior's phase: the face pass and the outscale resize
POST_TAGS = ("faces", "outscale")
PHASES = ("k1", "k1n", "k2", "k5", "k3", "k6", "k4", "kernels", "paths", "bench", "io", "gfpgan") + PATH_TAGS + POST_TAGS


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _run(cmd) -> str:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (r.stdout or r.stderr).strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the PyTorch/CUDA port")
    ap.add_argument(
        "--only", default="",
        help=f"comma-separated subset of {', '.join(PHASES)} (default: everything)",
    )
    args = ap.parse_args(argv)
    only = {n for n in args.only.split(",") if n}
    if only - set(PHASES):
        ap.error(f"--only: unknown {sorted(only - set(PHASES))}; choose from {PHASES}")

    def want(*names):
        """Whether a phase runs: always in a full run; in a partial run when
        one of its names was asked for."""
        return not only or bool(only.intersection(names))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch.nn.functional as F

    from video_restore_tpu_torch.models.rrdbnet import calibrate_rdb_act_scales
    from video_restore_tpu_torch.ops import _build, post, quant, rdb, srvgg, stripe, tail, unsharp

    # ---- phase 1: the card ------------------------------------------------
    smi = _run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    )
    log(smi)
    from video_restore_tpu_torch.ops._build import _nvcc

    nvcc_v = _run([_nvcc(), "--version"]).splitlines()[-1]
    log(
        f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc_v}"
    )
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- phase 2: build ---------------------------------------------------
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log(f"[build] {time.time() - t0:.1f}s -> {lib_path.name}")
    entry = spill = source = ""
    # the redesigned sources, whose ptxas lines are repeated under their
    # phase's tag
    new_sources = {"rdb_fused_mma.cu": "k5", "srvgg_up_mma.cu": "k3", "tail_fused_mma.cu": "k6",
                   "conv3x3_i8_mma.cu": "k4", "conv3x3_narrow.cu": "k1n", "unsharp_rows.cu": "k2"}
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if line.startswith("=="):
            log(f"[build] {line.strip()}")
            source = line.split()[1]
        elif "Compiling entry function" in line:
            # the kernel's name and template arguments, from the mangled name
            entry = line.split("'")[1]
            entry = entry.split("_cu_")[-1][8:] if "_cu_" in entry else entry
        elif "spill" in line:
            spill = line.split(",", 1)[-1].strip()
        elif "registers" in line:
            msg = f"{entry}: {line.split(':', 1)[-1].strip()}; {spill}"
            log(f"[build] {msg}")
            if source in new_sources:
                log(f"[{new_sources[source]}] ptxas {source} {msg}")

    # ---- phase 3: kernels against their plain versions -------------------
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        t = (torch.rand(*shape, generator=gen) * 2 - 1) * scale
        return t.to(dev, dt)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def compare(name, k, p, dt):
        err = (k.float() - p.float()).abs().max().item()
        scale = max(1.0, p.float().abs().max().item())
        # fp32: sums in another order; bf16: the same fp32 sums rounded to
        # bf16, where a sum near a rounding boundary moves one bf16 step
        # (2^-8 relative), and chained convs carry such steps forward
        tol = 1e-4 * scale if dt == torch.float32 else 2e-2 * scale
        check(err <= tol, f"{name}: max |kernel - plain| {err:.3g} > {tol:.3g}")
        return err

    def conv_ref64(x, w, b):
        y = F.conv2d(
            x.double().cpu().permute(0, 3, 1, 2),
            w.double().cpu().permute(3, 2, 0, 1), padding=1,
        )
        return y.permute(0, 2, 3, 1) + b.double().cpu()

    def rdb_weights(nf, gc, dt):
        ws = [rnd(3, 3, nf + k * gc, gc if k < 4 else nf, scale=0.03, dt=dt)
              for k in range(5)]
        bs = [rnd(gc if k < 4 else nf, scale=0.05, dt=dt) for k in range(5)]
        return ws, bs

    def tail_weights(nf, dt):
        return [
            rnd(3, 3, nf, nf, scale=0.05, dt=dt), rnd(nf, scale=0.05, dt=dt),
            rnd(3, 3, nf, nf, scale=0.05, dt=dt), rnd(nf, scale=0.05, dt=dt),
            rnd(3, 3, nf, 3, scale=0.05, dt=dt), rnd(3, scale=0.05, dt=dt),
        ]

    def srvgg_weights(n, nf, dt):
        return (
            rnd(n, 3, 3, nf, nf, scale=0.06, dt=dt), rnd(n, nf, scale=0.05, dt=dt),
            (rnd(n, nf, scale=0.2, dt=torch.float32) + 0.2).to(dt),
        )


    def bf16_step(mag):
        """The bf16 step (2^-7 relative) at each magnitude."""
        return torch.exp2(torch.floor(torch.log2(mag)) - 7)

    def bf16_steps(name, k, p, n=1, floor=2.0**-126, extra=0.0):
        """Per value, |kernel - plain| in bf16 steps (2^-7 relative) of the
        larger magnitude; fails above ``n``. ``floor``: the least magnitude a
        step is taken at (for sums in another order: a value that cancels to
        nearly 0 carries the fp32 rounding of its terms, not of itself).
        ``extra``: what is added to each value's step before the division
        (the share of an earlier rounding that the function itself carries
        into the value)."""
        k, p = k.float(), p.float()
        mag = torch.maximum(k.abs(), p.abs()).clamp_min(floor)
        d = (k - p).abs()
        worst = (d / (bf16_step(mag) + extra)).max().item()
        check(worst <= n, f"{name}: kernel vs plain {worst:.2f} bf16 steps > {n}")
        return d.max().item(), worst

    def i8_rdb(nf, gc):
        """Seeded bf16 RDB weights and their W8 (int8 HWIO, fp32 scales)."""
        ws, bs = rdb_weights(nf, gc, torch.bfloat16)
        q = [quant.quantize_conv_weights(ws[k], quant.rdb_segments(nf, gc, k + 1)) for k in range(5)]
        return ws, bs, [a for a, _ in q], [s_ for _, s_ in q]

    def i8_srvgg(n, nf):
        sw_ = srvgg_weights(n, nf, torch.bfloat16)
        q = [quant.quantize_conv_weights(w_, (0, nf)) for w_ in sw_[0]]
        return sw_, torch.stack([a for a, _ in q]), torch.cat([s_ for _, s_ in q])

    H, W, NF, GC = 1080, 1920, 64, 32
    bf = torch.bfloat16
    rows = {}

    def phase_k1():
        """K1's tensor-core route: single convs at odd shapes, bf16, held per
        value to their plain version and to a float64 conv; then the old and
        the new kernel on one 1080p RDB."""
        def one(tag, x, wt, bias, f64=False, **kw):
            """One conv on the mma route against plain (and float64). Steps
            are taken at no less than 2^-8 of the output's largest value:
            the two sides add ~600-1700 fp32 products in different orders,
            so a value that cancels below that keeps an absolute error of
            the terms' rounding (~1e-6 here), which is many steps of a tiny
            value and no sign of a wrong fragment (that would be O(1))."""
            pk = {k_: (v.clone() if k_ == "out" else v) for k_, v in kw.items()}
            _build.reset_launches()
            k = tail.conv3x3(x, wt, bias, counter="check", **kw)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == {"check": 1, "conv3x3:mma": 1}, f"{tag}: launches {got}, expected one on the mma route")
            p = tail.conv3x3_plain(x, wt, bias, **pk)
            floor = p.float().abs().max().item() * 2.0**-8
            extra = 0.0
            if kw.get("r2") is not None:
                # two roundings: the inner sum T(r1 + s1 v) goes to bf16
                # before r2, so a flipped inner step reaches the output as s2
                # x a step of the inner value, on top of the output's own
                inner = tail.conv3x3_plain(
                    x, wt, bias, **{k_: v for k_, v in pk.items() if k_ not in ("r2", "s2")}
                ).float().abs()
                inner = (inner * (1 + 2.0**-7)).clamp_min(inner.max().item() * 2.0**-8)
                extra = kw["s2"] * bf16_step(inner)
            e, st = bf16_steps(tag, k, p, floor=floor, extra=extra)
            msg = f"[k1] {tag} err={e:.3g} steps={st:.2f}"
            if f64:
                xi = x.repeat_interleave(2, 1).repeat_interleave(2, 2) if kw.get("upsample2") else x
                ref = conv_ref64(xi, wt, bias)
                if kw.get("act") == "lrelu":
                    ref = torch.where(ref >= 0, ref, 0.2 * ref)
                elif kw.get("act") == "prelu":
                    ref = torch.where(ref > 0, ref, ref * kw["alpha"].double().cpu())
                e64, st64 = bf16_steps(tag + " vs float64", k.cpu(), ref.float(), floor=floor)
                msg += f" err_vs_f64={e64:.3g} steps_vs_f64={st64:.2f}"
            log(msg)
            return k, p

        b, h, w = 2, 37, 53
        for shp in ((b, h, w), (1, 5, 7)):
            x = rnd(*shp, 64)
            wt, bias = rnd(3, 3, 64, 64, scale=0.05), rnd(64, scale=0.1)
            al = rnd(64, scale=0.3)
            r1, r2 = rnd(*shp, 64), rnd(*shp, 64)
            one(f"{shp} 64->64 none", x, wt, bias, f64=True)
            one(f"{shp} 64->64 lrelu", x, wt, bias, f64=True, act="lrelu")
            one(f"{shp} 64->64 prelu", x, wt, bias, f64=True, act="prelu", alpha=al)
            one(f"{shp} 64->64 r1", x, wt, bias, r1=r1, s1=0.2)
            one(f"{shp} 64->64 r1+r2", x, wt, bias, r1=r1, s1=0.2, r2=r2, s2=0.2)
            one(f"{shp} 64->64 upsample2 lrelu", x, wt, bias, f64=True, act="lrelu", upsample2=True)
            one(f"{shp} 64->32 none", x, rnd(3, 3, 64, 32, scale=0.05), bias[:32].clone(), f64=True)
        # the growth-buffer case: conv k reads the prefix of a 192-channel
        # buffer and writes its 32 channels at their offset in the same buffer
        grow = rnd(b, h, w, 192)
        for cin in (64, 96, 128, 160):
            wt, bias = rnd(3, 3, cin, 32, scale=0.03), rnd(32, scale=0.05)
            gk = grow.clone()
            k, p = one(f"growth buffer {cin}->32 into [{cin}:{cin + 32}]", gk[..., :cin], wt, bias,
                       f64=True, act="lrelu", out=gk[..., cin : cin + 32])
            gp = grow.clone()
            gp[..., cin : cin + 32] = p
            rest = torch.ones(192, dtype=torch.bool, device=dev)
            rest[cin : cin + 32] = False
            check(torch.equal(gk[..., rest], grow[..., rest]),
                  f"growth buffer {cin}->32: the kernel wrote outside its channel slice")
        wt, bias = rnd(3, 3, 192, 64, scale=0.03), rnd(64, scale=0.05)
        one("growth buffer 192->64 r1", grow, wt, bias, r1=grow[..., :64], s1=0.2)
        one("growth buffer 192->64 r1+r2", grow, wt, bias, r1=grow[..., :64], s1=0.2,
            r2=rnd(b, h, w, 64), s2=0.2)
        del grow

        # one 1080p RDB: each conv on the new kernel, then the whole RDB on
        # the old kernel (the fma route forced), the new one, and cuDNN
        xb = rnd(1, H, W, NF)
        ws, bs = rdb_weights(NF, GC, bf)
        grow = torch.empty(1, H, W, NF + 4 * GC, dtype=bf, device=dev)
        grow[..., :NF] = xb
        for k_ in range(5):
            lo = NF + k_ * GC
            cout = GC if k_ < 4 else NF
            out = grow[..., lo : lo + GC] if k_ < 4 else torch.empty(1, H, W, NF, dtype=bf, device=dev)
            ms = timed(lambda: tail.conv3x3(grow[..., :lo], ws[k_], bs[k_], act="lrelu", out=out, counter="check"), 10)
            ops = 2 * H * W * 9 * lo * cout
            log(f"[k1] conv{k_ + 1} {lo}->{cout} 1x{H}x{W} mma: {ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s")
        del grow, out
        k_new = stripe.rdb_fused(xb, ws, bs)
        new_ms = timed(lambda: stripe.rdb_fused(xb, ws, bs), 5)
        route = tail.conv3x3_route
        tail.conv3x3_route = lambda *a, **k: "fma"
        try:
            _build.reset_launches()
            k_old = stripe.rdb_fused(xb, ws, bs)
            check(_build.launches() == {"rdb_fused": 5, "conv3x3:fma": 5}, f"forced fma route: {_build.launches()}")
            old_ms = timed(lambda: stripe.rdb_fused(xb, ws, bs), 5)
        finally:
            tail.conv3x3_route = route
        e = compare("rdb_fused mma vs fma", k_new, k_old, bf)
        del k_new, k_old
        rdb_in = [rnd(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last) for k_ in range(5)]
        rdb_w = [w_.permute(3, 2, 0, 1).contiguous() for w_ in ws]
        lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(rdb_in, rdb_w, bs)], 5)
        rdb_ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        log(
            f"[k1] rdb_fused 1x{H}x{W}x64 bf16: fma (old kernel) {old_ms:.3f} ms, mma (new kernel) "
            f"{new_ms:.3f} ms ({old_ms / new_ms:.2f}x, {rdb_ops / new_ms / 1e9:.1f} TFLOP/s useful), "
            f"library (cuDNN chain of 5) {lib_ms:.3f} ms; max |mma - fma| {e:.3g}"
        )
        k1_stats.update(rdb_fma_ms=old_ms, rdb_mma_ms=new_ms, rdb_library_ms=lib_ms)
        check(new_ms * 3 <= old_ms, f"[k1] the mma route ({new_ms:.3f} ms per RDB) is not 3x the fma kernel ({old_ms:.3f})")

    k1_stats = {}
    if want("k1", "kernels"):
        phase_k1()
        torch.cuda.empty_cache()

    def phase_k1n():
        """K1's narrow route (``conv3x3_narrow.cu``): the stems and conv_last
        at odd shapes and at the paths' shapes, each ``torch.equal`` to the
        forced fma route (both sum in one order) and within compare's bf16
        bound of plain; then the old kernel (fma forced), the new one and
        ``F.conv2d`` side by side at the flagship's two shapes."""
        def held(tag, x, wt, bias, kind, **kw):
            _build.reset_launches()
            k = tail.conv3x3(x, wt, bias, counter="k1n", **kw)
            torch.cuda.synchronize()
            got = _build.launches()
            expect = {"k1n": 1, "conv3x3:narrow": 1, f"conv3x3:narrow {kind}": 1}
            check(got == expect, f"[k1n] {tag}: launches {got} != {expect}")
            if "out" in kw:  # the forced route writes the same slice
                k = k.clone()
            old = tail.conv3x3(x, wt, bias, counter="k1n", route="fma", **kw)
            diff = (k.float() - old.float()).abs().max().item()
            check(torch.equal(k, old), f"[k1n] {tag}: narrow != fma (max |diff| {diff:.3g})")
            del old
            e = compare(f"[k1n] {tag}", k, tail.conv3x3_plain(x, wt, bias, **kw), bf)
            k1n_stats["bit_equal_cases"] = k1n_stats.get("bit_equal_cases", 0) + 1
            k1n_stats["max_err"] = max(k1n_stats.get("max_err", 0.0), e)
            log(f"[k1n] {tag} {kind}: == fma, err vs plain {e:.3g}")
            return k

        odd = ((2, 37, 53), (1, 5, 7), (1, 1, 1))
        for cin in (3, 12):
            wt, bias = rnd(3, 3, cin, NF, scale=0.2), rnd(NF, scale=0.1)
            al = rnd(NF, scale=0.3)
            for shp in odd:
                x = rnd(*shp, cin)
                held(f"stem {cin}->64 {shp} none", x, wt, bias, "stem")
                held(f"stem {cin}->64 {shp} prelu", x, wt, bias, "stem", act="prelu", alpha=al)
            held(f"stem {cin}->64 (2, 37, 53) lrelu", rnd(2, 37, 53, cin), wt, bias, "stem", act="lrelu")
        # a cin-3 view of a 4-channel buffer (pixel stride 4), into a slice of
        # a wider output (pixel stride 72, 16-byte aligned)
        wt, bias, al = rnd(3, 3, 3, NF, scale=0.2), rnd(NF, scale=0.1), rnd(NF, scale=0.3)
        dst = torch.zeros(2, 37, 53, 72, dtype=bf, device=dev)
        held("stem 3->64 (2, 37, 53) strided x, out a slice", rnd(2, 37, 53, 4)[..., :3], wt, bias,
             "stem", act="prelu", alpha=al, out=dst[..., 8:72])
        check(not dst[..., :8].any(), "[k1n] the stem wrote outside its channel slice")
        for tag, shp in (("frame", (1, H, W)), ("tiles", (6, 376, 448))):
            x = rnd(*shp, 3)
            held(f"stem 3->64 {shp} none", x, wt, bias, "stem")
            held(f"stem 3->64 {shp} prelu", x, wt, bias, "stem", act="prelu", alpha=al)
        wl, bl = rnd(3, 3, NF, 3, scale=0.05), rnd(3, scale=0.1)
        for shp in ((2, 37, 53), (1, 5, 7), (2, 100, 150)):
            held(f"conv_last 64->3 {shp}", rnd(*shp, NF), wl, bl, "conv_last")
        held("conv_last 64->3 (2, 37, 53) x a prefix of 72", rnd(2, 37, 53, 72)[..., :NF], wl, bl,
             "conv_last")
        for shp in ((1, 4 * H, 4 * W), (6, 1504, 1792)):
            held(f"conv_last 64->3 {shp}", rnd(*shp, NF), wl, bl, "conv_last")
            torch.cuda.empty_cache()

        # old, new and cuDNN at the flagship's shapes
        for tag, cin, cout, shp, reps in (("stem", 3, NF, (1, H, W), 20),
                                          ("conv_last", NF, 3, (1, 4 * H, 4 * W), 5)):
            x = rnd(*shp, cin)
            wt, bias = rnd(3, 3, cin, cout, scale=0.05), rnd(cout, scale=0.1)
            new_ms = timed(lambda: tail.conv3x3(x, wt, bias, counter="k1n"), reps)
            old_ms = timed(lambda: tail.conv3x3(x, wt, bias, counter="k1n", route="fma"), max(2, reps // 4))
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
            lib_ms = timed(lambda: F.conv2d(x_nchw, w_oihw, bias, padding=1), reps)
            npx = shp[0] * shp[1] * shp[2]
            fmas = npx * 9 * cin * cout
            nbytes = (npx * (cin + cout) + 9 * cin * cout + cout) * 2
            log(
                f"[k1n] {tag} {shp}x{cin}->{cout} bf16: fma (old kernel) {old_ms:.3f} ms, narrow (new "
                f"kernel) {new_ms:.3f} ms ({old_ms / new_ms:.2f}x; {2 * fmas / new_ms / 1e9:.1f} TFLOP/s "
                f"of fp32 FMAs, {nbytes / new_ms / 1e9:.2f} TB/s), library (F.conv2d, channels_last) "
                f"{lib_ms:.3f} ms; floors: FMAs {2 * fmas / PEAK_FP32 * 1e3:.3f} ms, bytes "
                f"{nbytes / PEAK_BYTES * 1e3:.3f} ms"
            )
            k1n_stats.update({f"{tag}_fma_ms": old_ms, f"{tag}_narrow_ms": new_ms,
                              f"{tag}_library_ms": lib_ms})
            check(new_ms * 3 <= old_ms,
                  f"[k1n] the narrow route ({new_ms:.3f} ms) is not 3x the fma kernel ({old_ms:.3f}) at {tag}")
            del x
            torch.cuda.empty_cache()

    k1n_stats = {}
    if want("k1n", "kernels"):
        phase_k1n()
        torch.cuda.empty_cache()

    def phase_k2():
        """K2's rows route (``unsharp_rows.cu``): odd shapes, edge cases of
        its strips, runs and halo, and radii 0..16, each
        ``torch.equal`` to the forced tile route (both sum in one order) and
        within compare's fp32 bound of plain; then the old kernel (tile
        forced), the new one, the plain version and a copy of the frame side
        by side at the flagship's 1x4320x7680x3."""
        def held(tag, x, radius=4, thr=0.0):
            _build.reset_launches()
            k = unsharp.unsharp_fused(x, 0.3, 1.5, radius, thr)
            torch.cuda.synchronize()
            got = _build.launches()
            expect = {"unsharp_fused": 1, "unsharp_fused:rows": 1}
            check(got == expect, f"[k2] {tag}: launches {got} != {expect}")
            old = unsharp.unsharp_fused(x, 0.3, 1.5, radius, thr, route="tile")
            diff = (k - old).abs().max().item()
            check(torch.equal(k, old), f"[k2] {tag}: rows != tile (max |diff| {diff:.3g})")
            del old
            p = post.unsharp_mask(x, 0.3, 1.5, radius, thr)
            e = compare(f"[k2] {tag}", k, p, torch.float32)
            k2_stats["bit_equal_cases"] = k2_stats.get("bit_equal_cases", 0) + 1
            k2_stats["max_err"] = max(k2_stats.get("max_err", 0.0), e)
            log(f"[k2] {tag} r={radius} threshold={thr}: == tile, err vs plain {e:.3g}, "
                f"bit-equal to plain: {torch.equal(k, p)}")

        def frame(*shape):
            return torch.rand(*shape, generator=gen).to(dev)

        for thr in (0.0, 0.02):
            held("2x37x53x3 (W*C % 4 != 0)", frame(2, 37, 53, 3), thr=thr)
        for shp in ((1, 1, 1, 3), (1, 5, 9, 3)):  # frames smaller than the halo
            held(f"{'x'.join(map(str, shp))} (below the halo)", frame(*shp))
        # a run shorter than 2r + 1 rows, 9 strips of a row
        held("1x4x3000x3 (4 rows, 9 strips)", frame(1, 4, 3000, 3))
        # runs that start mid-frame and cross strips and frames: no run length
        # divides H
        held("2x1037x1283x3 (runs cross strips and frames)", frame(2, 1037, 1283, 3), thr=0.02)
        for r in (0, 1, 4, 16):
            held(f"2x37x53x3 radius {r}", frame(2, 37, 53, 3), radius=r)
            held(f"1x301x2000x3 radius {r}", frame(1, 301, 2000, 3), radius=r, thr=0.02)
        # 4 bytes past a 16-byte boundary: the 4-byte copies at W*C % 4 == 0
        buf = torch.rand(1 + 2 * 40 * 64 * 3, generator=gen).to(dev)
        held("2x40x64x3 x off 16 bytes", buf[1:].view(2, 40, 64, 3), thr=0.02)
        xu = frame(1, 4 * H, 4 * W, 3)
        for thr in (0.0, 0.02):
            held(f"1x{4 * H}x{4 * W}x3 (flagship)", xu, thr=thr)

        # old, new, plain and a copy of the frame at the flagship's shape
        nbytes = 2 * xu.numel() * 4
        dst = torch.empty_like(xu)
        new_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4), 20)
        old_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4, route="tile"), 10)
        plain_ms = timed(lambda: post.unsharp_mask(xu, 0.3, 1.5, 4), 3)
        copy_ms = timed(lambda: dst.copy_(xu), 20)
        new2_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4), 20)
        bound = nbytes / PEAK_BYTES * 1e3
        log(
            f"[k2] 1x{4 * H}x{4 * W}x3 fp32 r=4: tile (old kernel) {old_ms:.3f} ms "
            f"({nbytes / old_ms / 1e9:.2f} TB/s), rows (new kernel) {new_ms:.3f} / {new2_ms:.3f} ms "
            f"({nbytes / new_ms / 1e9:.2f} TB/s; {old_ms / new_ms:.2f}x), plain {plain_ms:.3f} ms, "
            f"dst.copy_(src) {copy_ms:.3f} ms ({nbytes / copy_ms / 1e9:.2f} TB/s); bound {bound:.3f} ms "
            f"(bytes; the new kernel at {100 * bound / new_ms:.1f}% of it); "
            f"{k2_stats['bit_equal_cases']} cases bit-equal to tile"
        )
        k2_stats.update(tile_ms=old_ms, rows_ms=new_ms, rows_again_ms=new2_ms, plain_ms=plain_ms,
                        copy_ms=copy_ms, bound_ms=bound)
        check(new_ms * 3 <= old_ms,
              f"[k2] the rows route ({new_ms:.3f} ms) is not 3x the tile kernel ({old_ms:.3f})")
        del xu, dst, buf

    k2_stats = {}
    if want("k2", "kernels"):
        phase_k2()
        torch.cuda.empty_cache()

    def one_launch(tag, fn, counter, route="mma"):
        """fn() with the counters reset before and read after: exactly one
        launch, counted under ``counter`` and its route."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = _build.launches()
        check(got == {counter: 1, f"{counter}:{route}": 1},
              f"{tag}: launches {got}, expected one on the {route} route")
        return out

    def k5_exec_ops(b, h, w):
        """Operations K5's mma route executes: every conv over its whole
        window of every 12 x 12 tile (the recomputed halo included)."""
        tiles = b * -(-h // 12) * -(-w // 12)
        return tiles * sum(2 * 9 * (22 - 2 * k) ** 2 * (NF + (k - 1) * GC) * (GC if k < 5 else NF)
                           for k in range(1, 6))

    def phase_k5():
        """K5's tensor-core route: one RDB (with and without x0) and a whole
        RRDB in bf16 at nf 64 / gc 32, at odd shapes, each launch counted
        under its route, within compare's bf16 tolerance of the plain
        version; then the old kernel (fma route forced) and the new one side
        by side at 1080p."""
        ws, bs = rdb_weights(NF, GC, bf)
        w3 = [(ws, bs)] + [rdb_weights(NF, GC, bf) for _ in range(2)]

        def held(tag, counter, k_fn, p_fn):
            k = one_launch(f"[k5] {tag}", k_fn, counter)
            p = p_fn()
            e = compare(f"[k5] {tag}", k, p, bf)
            # per value in bf16 steps, taken at no less than 2^-8 of plain's
            # largest value as in [k1]: reported, not held
            _, st = bf16_steps(f"[k5] {tag}", k, p, n=float("inf"),
                               floor=p.float().abs().max().item() * 2.0**-8)
            k5_stats["max_steps"] = max(k5_stats.get("max_steps", 0.0), st)
            k5_stats["max_err"] = max(k5_stats.get("max_err", 0.0), e)
            log(f"[k5] {tag} err={e:.3g} steps={st:.2f} (|plain| max {p.float().abs().max().item():.3g})")
            return k

        # below one tile, one tile, ragged with B = 2, and more 12 x 12 tiles
        # (2 x 11 x 13 = 286) than the persistent grid has blocks (132)
        for shp in ((1, 5, 7), (1, 12, 12), (2, 37, 53), (2, 130, 150)):
            x, x0 = rnd(*shp, NF), rnd(*shp, NF)
            held(f"rdb_fused {shp}", "rdb_fused_k5",
                 lambda: rdb.rdb_fused(x, ws, bs), lambda: rdb.rdb_fused_plain(x, ws, bs))
            held(f"rdb_fused {shp} x0", "rdb_fused_k5",
                 lambda: rdb.rdb_fused(x, ws, bs, x0), lambda: rdb.rdb_fused_plain(x, ws, bs, x0))
            held(f"rrdb_fused {shp}", "rrdb_fused",
                 lambda: rdb.rrdb_fused(x, w3), lambda: rdb.rrdb_fused_plain(x, w3))

        xb, x0b = rnd(1, H, W, NF), rnd(1, H, W, NF)
        k_new = held(f"rdb_fused 1x{H}x{W}", "rdb_fused_k5",
                     lambda: rdb.rdb_fused(xb, ws, bs), lambda: rdb.rdb_fused_plain(xb, ws, bs))
        held(f"rdb_fused 1x{H}x{W} x0", "rdb_fused_k5",
             lambda: rdb.rdb_fused(xb, ws, bs, x0b), lambda: rdb.rdb_fused_plain(xb, ws, bs, x0b))
        k_old = one_launch("[k5] rdb_fused forced fma", lambda: rdb.rdb_fused(xb, ws, bs, route="fma"),
                           "rdb_fused_k5", route="fma")
        e_old = compare("[k5] rdb_fused mma vs fma", k_new, k_old, bf)
        # the same fp32 sums in the same order as K1's tensor-core route (16
        # channels of the growth prefix at a time, taps in order) and the same
        # epilogue: expected bit-equal to the five-launch chain
        same = torch.equal(k_new, stripe.rdb_fused(xb, ws, bs))
        k5_stats["bit_equal_to_k1_chain"] = same
        log(f"[k5] rdb_fused 1x{H}x{W} mma bit-equal to K1's five-launch chain: {same}")
        del k_new, k_old
        new_ms = timed(lambda: rdb.rdb_fused(xb, ws, bs), 10)
        old_ms = timed(lambda: rdb.rdb_fused(xb, ws, bs, route="fma"), 3)
        rdb_in = [rnd(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last) for k_ in range(5)]
        rdb_w = [[w_.permute(3, 2, 0, 1).contiguous() for w_ in r_[0]] for r_ in w3]
        lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(rdb_in, rdb_w[0], bs)], 5)
        ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        exe = k5_exec_ops(1, H, W)
        log(
            f"[k5] rdb_fused 1x{H}x{W}x64 bf16: fma (old kernel) {old_ms:.3f} ms, mma (new kernel) "
            f"{new_ms:.3f} ms ({old_ms / new_ms:.2f}x; {ops / new_ms / 1e9:.1f} TFLOP/s useful, "
            f"{exe / new_ms / 1e9:.1f} executed, executed/useful {exe / ops:.3f}), "
            f"library (cuDNN chain of 5) {lib_ms:.3f} ms; max |mma - fma| {e_old:.3g}"
        )
        k_new = held(f"rrdb_fused 1x{H}x{W}", "rrdb_fused",
                     lambda: rdb.rrdb_fused(xb, w3), lambda: rdb.rrdb_fused_plain(xb, w3))
        k_old = one_launch("[k5] rrdb_fused forced fma", lambda: rdb.rrdb_fused(xb, w3, route="fma"),
                           "rrdb_fused", route="fma")
        e_rold = compare("[k5] rrdb_fused mma vs fma", k_new, k_old, bf)
        del k_new, k_old
        rnew_ms = timed(lambda: rdb.rrdb_fused(xb, w3), 5)
        rold_ms = timed(lambda: rdb.rrdb_fused(xb, w3, route="fma"), 2)
        rlib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for r_, wo in zip(w3, rdb_w)
                                 for a, w_, b_ in zip(rdb_in, wo, r_[1])], 3)
        log(
            f"[k5] rrdb_fused 1x{H}x{W}x64 bf16: fma (old kernel) {rold_ms:.3f} ms, mma (new kernel) "
            f"{rnew_ms:.3f} ms ({rold_ms / rnew_ms:.2f}x; {3 * ops / rnew_ms / 1e9:.1f} TFLOP/s useful), "
            f"library (cuDNN chain of 15) {rlib_ms:.3f} ms; max |mma - fma| {e_rold:.3g}; "
            f"largest error at every shape: {k5_stats['max_err']:.3g}, {k5_stats['max_steps']:.2f} bf16 steps"
        )
        k5_stats.update(rdb_fma_ms=old_ms, rdb_mma_ms=new_ms, rdb_library_ms=lib_ms,
                        rrdb_fma_ms=rold_ms, rrdb_mma_ms=rnew_ms, rrdb_library_ms=rlib_ms,
                        executed_per_useful=exe / ops)
        check(new_ms * 3 <= old_ms,
              f"[k5] the mma route ({new_ms:.3f} ms per RDB) is not 3x the fma kernel ({old_ms:.3f})")

    def phase_k3():
        """K3's tensor-core route at r 2 and r 4: odd shapes, the config-4
        frame and the tile batch, each within one bf16 step per value of the
        plain version (steps taken at no less than 2^-8 of the output's
        largest value); then the old kernel (fma route forced) and the new
        one side by side."""
        def held(tag, x, wo, bo, xin, r):
            wu = srvgg.srvgg_up_weights(wo, r)
            k = one_launch(f"[k3] {tag}", lambda: srvgg.srvgg_up_fused(x, wu, bo, xin, r), "srvgg_up_fused")
            check(k.shape == (x.shape[0], r * x.shape[1], r * x.shape[2], 3), f"[k3] {tag}: shape {k.shape}")
            p = srvgg.srvgg_up_fused_plain(x, wo, bo, xin, r)
            e, st = bf16_steps(f"[k3] {tag}", k, p, floor=p.float().abs().max().item() * 2.0**-8)
            if wu.shape != wo.shape:  # a direct caller's unpadded weight
                check(torch.equal(srvgg.srvgg_up_fused(x, wo, bo, xin, r), k), f"[k3] {tag}: unpadded weight")
            log(f"[k3] {tag} err={e:.3g} steps={st:.2f}")
            return k

        for r in srvgg.UP_SCALES:
            for shp in ((1, 5, 7), (2, 37, 53), (1, 9, 33)):
                x, xin = rnd(*shp, NF), rnd(*shp, 3).abs()
                wo, bo = rnd(3, 3, NF, 3 * r * r, scale=0.05), rnd(3 * r * r, scale=0.1)
                held(f"r {r} {shp}", x, wo, bo, xin, r)
        R = 4
        wo, bo = rnd(3, 3, NF, 3 * R * R, scale=0.05), rnd(3 * R * R, scale=0.1)
        for tag, shp in (("config-4 frame", (1, H, W)), ("tile batch", (6, 376, 448))):
            x, xin = rnd(*shp, NF), rnd(*shp, 3).abs()
            k_new = held(f"r 4 {tag} {shp}", x, wo, bo, xin, R)
            k_old = one_launch(f"[k3] {tag} forced fma", lambda: srvgg.srvgg_up_fused(x, wo, bo, xin, R, route="fma"),
                               "srvgg_up_fused", route="fma")
            e_old = (k_new.float() - k_old.float()).abs().max().item()
            del k_new, k_old
            new_ms = timed(lambda: srvgg.srvgg_up_fused(x, wo, bo, xin, R), 20)
            old_ms = timed(lambda: srvgg.srvgg_up_fused(x, wo, bo, xin, R, route="fma"), 5)
            x_nchw, wo_oihw = x.permute(0, 3, 1, 2), wo.permute(3, 2, 0, 1).contiguous()
            lib_ms = timed(lambda: F.conv2d(x_nchw, wo_oihw, bo, padding=1), 20)
            npx = shp[0] * shp[1] * shp[2]
            ops = 2 * npx * 9 * NF * 3 * R * R
            log(
                f"[k3] srvgg_up_fused {tag} {shp} r 4 bf16: fma (old kernel) {old_ms:.3f} ms, mma (new "
                f"kernel) {new_ms:.3f} ms ({old_ms / new_ms:.2f}x; {ops / new_ms / 1e9:.1f} TFLOP/s, "
                f"{npx * (NF + 3 + 3 * R * R) * 2 / new_ms / 1e9:.2f} TB/s), library (F.conv2d, conv_out "
                f"alone) {lib_ms:.3f} ms; max |mma - fma| {e_old:.3g}"
            )
            key = "frame" if shp[0] == 1 else "tiles"
            k3_stats.update({f"{key}_fma_ms": old_ms, f"{key}_mma_ms": new_ms, f"{key}_library_ms": lib_ms})
            check(key == "tiles" or new_ms * 3 <= old_ms,
                  f"[k3] the mma route ({new_ms:.3f} ms) is not 3x the fma kernel ({old_ms:.3f})")

    def phase_k6():
        """K6's tensor-core route (``tail_fused_q:mma``) in bf16 at nf 64:
        B = 2 with ragged extents, a frame smaller than one tile, more tiles
        than the persistent grid has blocks, and the flagship's
        1x2160x3840x64, each within compare's bf16 bound of the plain
        version, the largest error in bf16 steps printed; at the flagship
        shape its equality with K1's three-launch chain, and the old kernel
        (fma route forced) and the new one side by side beside the cuDNN
        chain of 3."""
        tw = tail_weights(NF, bf)

        def held(tag, x):
            k = one_launch(f"[k6] {tag}", lambda: tail.tail_fused_q(x, *tw), "tail_fused_q")
            b_, h_, w_ = x.shape[:3]
            check(k.shape == (b_, 2 * h_, 2 * w_, 3) and k.dtype == bf, f"[k6] {tag}: shape {k.shape}")
            p = tail.tail_fused_q_plain(x, *tw)
            e = compare(f"[k6] {tag}", k, p, bf)
            _, st = bf16_steps(f"[k6] {tag}", k, p, n=float("inf"),
                               floor=p.float().abs().max().item() * 2.0**-8)
            del p
            chain = tail.tail_fused(x, *tw)
            same = torch.equal(k, chain)
            _, st_chain = bf16_steps(f"[k6] {tag} vs chain", k, chain, n=float("inf"))
            del chain
            k6_stats["max_steps"] = max(k6_stats.get("max_steps", 0.0), st)
            k6_stats["max_err"] = max(k6_stats.get("max_err", 0.0), e)
            k6_stats["max_steps_vs_chain"] = max(k6_stats.get("max_steps_vs_chain", 0.0), st_chain)
            log(f"[k6] {tag} err={e:.3g} steps={st:.2f} bit_equal_to_k1_chain={same} "
                f"steps_vs_chain={st_chain:.2f}")
            return k, same

        # 16 x 28 output tiles: (2, 37, 53) -> 74 x 106 (ragged, B = 2);
        # (1, 5, 7) -> 10 x 14, below one tile; (1, 9, 13) ragged both ways;
        # (2, 100, 150) -> 2 x 13 x 11 = 286 tiles on 132 blocks
        for shp in ((2, 37, 53), (1, 5, 7), (1, 9, 13), (2, 100, 150)):
            held(str(shp), rnd(*shp, NF))
        h2, w2 = 2 * H, 2 * W
        x2 = rnd(1, h2, w2, NF)
        k_new, same = held(f"1x{h2}x{w2}x64", x2)
        k6_stats["bit_equal_to_k1_chain"] = same
        k_old = one_launch("[k6] forced fma", lambda: tail.tail_fused_q(x2, *tw, route="fma"),
                           "tail_fused_q", route="fma")
        e_old = compare("[k6] mma vs fma", k_new, k_old, bf)
        del k_new, k_old
        new_ms = timed(lambda: tail.tail_fused_q(x2, *tw), 10)
        old_ms = timed(lambda: tail.tail_fused_q(x2, *tw, route="fma"), 2)
        chain_ms = timed(lambda: tail.tail_fused(x2, *tw), 5)
        tail_in = rnd(1, NF, 2 * h2, 2 * w2).contiguous(memory_format=torch.channels_last)
        tw_oihw = [tw[i].permute(3, 2, 0, 1).contiguous() for i in (0, 2, 4)]

        def tail_lib():
            f = F.conv2d(tail_in, tw_oihw[0], tw[1], padding=1)
            f = F.conv2d(f, tw_oihw[1], tw[3], padding=1)
            return F.conv2d(f, tw_oihw[2], tw[5], padding=1)

        lib_ms = timed(tail_lib, 3)
        del tail_in, x2
        npx = 4 * h2 * w2
        wide = 2 * 2 * npx * 9 * NF * NF  # useful, upconv2 as 9 taps
        tiles = -(-2 * h2 // 16) * -(-2 * w2 // 28)
        exe = tiles * 2 * 9 * NF * NF * (20 * 32 + 34 * 16)
        log(
            f"[k6] tail_fused_q 1x{h2}x{w2}x64 bf16: fma (old kernel) {old_ms:.3f} ms, mma (new kernel) "
            f"{new_ms:.3f} ms ({old_ms / new_ms:.2f}x; wide convs {wide / new_ms / 1e9:.1f} TFLOP/s "
            f"useful, {exe / new_ms / 1e9:.1f} executed, executed/useful {exe / wide:.3f}), K1's "
            f"three launches {chain_ms:.3f} ms, library (cuDNN chain of 3) {lib_ms:.3f} ms; max "
            f"|mma - fma| {e_old:.3g}; bit_equal_to_k1_chain={same}; largest error at every shape: "
            f"{k6_stats['max_err']:.3g}, {k6_stats['max_steps']:.2f} bf16 steps "
            f"({k6_stats['max_steps_vs_chain']:.2f} against the chain)"
        )
        k6_stats.update(fma_ms=old_ms, mma_ms=new_ms, chain_ms=chain_ms, library_ms=lib_ms,
                        executed_per_useful=exe / wide)
        check(new_ms * 3 <= old_ms,
              f"[k6] the mma route ({new_ms:.3f} ms) is not 3x the fma kernel ({old_ms:.3f})")

    def phase_k4():
        """K4's tensor-core route (``conv3x3_i8:mma``), dynamic and static A8:
        each of the five RDB convs (growth-buffer prefix views, pixel stride
        192) and an SRVGG PReLU conv at odd shapes, the quantiser on every
        finite bf16 value, and the whole int8 RDB at 1x1080x1920x64 and the
        tile batch 6x376x448x64, each ``torch.equal`` to the forced ``dp4a``
        route and to the plain version, with equal output amax; then the old
        and the new kernel side by side beside K1's bf16 RDB and the bf16
        cuDNN chain, and the same for the SRVGG int8 body."""
        ws8, bs8, wq8, sw8 = i8_rdb(NF, GC)
        wp8 = [quant.pack_i8_weights(q) for q in wq8]
        sv, swq, ssw = i8_srvgg(1, NF)
        swp = quant.pack_i8_weights(swq[0])
        SAS = (0.0075, 0.0079, 0.0081, 0.0068, 0.0090)  # below |max| / 127: some saturate

        def held(tag, run, expect):
            """run(route) -> (out, amax or None) for route None (the call's own),
            "dp4a" (forced) and "plain": the first with the counters reset
            before and read after (``expect``), all three equal bit for bit."""
            torch.cuda.synchronize()
            _build.reset_launches()
            k, ka = run(None)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == expect, f"[k4] {tag}: launches {got} != {expect}")
            d, da = run("dp4a")
            p, pa = run("plain")
            for name, o, oa in (("dp4a", d, da), ("plain", p, pa)):
                diff = (k.float() - o.float()).abs().max().item()
                check(torch.equal(k, o), f"[k4] {tag}: mma != {name} (max |diff| {diff:.3g})")
                check((ka is None and oa is None) or torch.equal(ka, oa),
                      f"[k4] {tag}: output amax {ka} != {name}'s {oa}")
            k4_stats["bit_equal_cases"] = k4_stats.get("bit_equal_cases", 0) + 1
            return k, ka

        def conv(x, segs, amax, wq, sw, b, wp, route, **kw):
            if route == "plain":
                return quant.conv3x3_i8_plain(x, segs, amax, wq, sw, b, **kw)
            return quant.conv3x3_i8(x, segs, amax, wq, sw, b, wp=wp, route=route, counter="k4", **kw)

        one = {"k4": 1, "conv3x3_i8:mma": 1}
        # (1, 5, 7) below one 8 x 32 tile; (2, 37, 53) B = 2, ragged both ways;
        # (1, 9, 33) one pixel past a tile column; (2, 130, 150) 170 tiles,
        # more than the card has SMs
        for shp in ((2, 37, 53), (1, 5, 7), (1, 9, 33), (2, 130, 150)):
            grow = rnd(*shp, NF + 4 * GC)
            amax = torch.stack([quant.act_amax_plain(grow[..., lo:lo + (NF if lo == 0 else GC)])
                                for lo in quant.rdb_segments(NF, GC, 5)[:5]], 1).contiguous()
            r2 = rnd(*shp, NF)
            for k_ in range(5):
                segs = quant.rdb_segments(NF, GC, k_ + 1)
                lo, cout = segs[-1], GC if k_ < 4 else NF
                for static in (False, True):
                    def run(route, k_=k_, segs=segs, lo=lo, cout=cout, static=static):
                        dst = torch.zeros_like(grow)  # written as a channel slice, pixel stride 192
                        out = dst[..., lo:lo + cout] if k_ < 4 else dst[..., :NF]
                        kw = (dict(act="lrelu") if k_ < 4 else
                              dict(r1=grow[..., :NF], s1=0.2, r2=r2, s2=0.2))
                        if static:
                            kw.update(sas=SAS[: k_ + 1])
                        else:
                            kw.update(out_amax=torch.zeros(shp[0], device=dev))
                        conv(grow[..., :lo], segs, None if static else amax, wq8[k_], sw8[k_],
                             bs8[k_], wp8[k_], route, out=out, **kw)
                        return out, kw.get("out_amax")

                    held(f"{shp} RDB conv{k_ + 1} {'static' if static else 'dynamic'}", run, one)
            x = rnd(*shp, NF)
            ax = quant.act_amax_plain(x)[:, None].contiguous()
            for static in (False, True):
                def run(route, static=static):
                    kw = dict(act="prelu", alpha=sv[2][0])
                    kw.update(sas=(0.0079,)) if static else kw.update(out_amax=torch.zeros(shp[0], device=dev))
                    y = conv(x, (0, NF), None if static else ax, swq[0], ssw, sv[1][0], swp, route, **kw)
                    return y, kw.get("out_amax")

                held(f"{shp} SRVGG conv {'static' if static else 'dynamic'}", run, one)
            log(f"[k4] {shp}: 5 RDB convs and an SRVGG conv, dynamic and static: mma == dp4a == plain, "
                "output amax equal")
            del grow

        # the quantiser on every finite bf16 value: a 1x32x32x64 frame of all
        # 65536 bit patterns (inf and NaN as 0) through the centre-tap
        # identity, so each output is q(x) * sa for its own input, at scales
        # 2^-120 .. 2^120 (static) and amaxes across the range (dynamic)
        bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
        xq = bits.view(torch.bfloat16).clone()
        xq[(bits.int() & 0x7F80) == 0x7F80] = 0
        xq = xq.reshape(1, 32, 32, NF).to(dev)
        eye = torch.zeros(3, 3, NF, NF, dtype=torch.int8)
        eye[1, 1] = torch.eye(NF, dtype=torch.int8)
        eye = eye.to(dev)
        eye_p, ones, zero = quant.pack_i8_weights(eye), torch.ones(1, NF, device=dev), torch.zeros(NF, dtype=bf, device=dev)
        n_scales = 0
        for e in range(-120, 121, 8):
            sa = 2.0 ** e

            def run(route, sa=sa):
                return conv(xq, (0, NF), None, eye, ones, zero, eye_p, route, sas=(sa,)), None

            y, _ = held(f"quantiser static 2^{e}", run, one)
            q = quant.quant_act_static_plain(xq, sa).float()
            check(torch.equal(y.float() / sa, q), f"[k4] quantiser static 2^{e}: output != q(x) * sa")
            n_scales += 1
        for amax_v in (127.0, 1.0, 3.0e-3, 0.37, 5.0e4, 1.0e-30, 1.0e30):
            am = torch.full((1, 1), amax_v, device=dev)

            def run(route, am=am):
                oa = torch.zeros(1, device=dev)
                y = conv(xq, (0, NF), am, eye, ones, zero, eye_p, route, out_amax=oa)
                return y, oa

            held(f"quantiser dynamic amax {amax_v:g}", run, one)
            n_scales += 1
        log(f"[k4] quantiser: all {int(((bits.int() & 0x7F80) != 0x7F80).sum())} finite bf16 values at "
            f"{n_scales} scales: bf16x2 quantiser (mma) == fp32 quantiser (dp4a) == plain")
        k4_stats["quantiser_scales"] = n_scales
        del xq

        # the whole int8 RDB at the flagship and tile-batch shapes
        rdb_ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        for tag, shp in (("1080p", (1, H, W)), ("tiles", (6, 376, 448))):
            xk = rnd(*shp, NF)
            x0 = rnd(*shp, NF) if tag == "tiles" else None
            sas_ = calibrate_rdb_act_scales(ws8, bs8, xk[:1, :128, :128])

            def rdb_run(route, static=False):
                if route == "plain":
                    return stripe.rdb_fused_i8_plain(xk, wq8, sw8, bs8, x0, sas=sas_ if static else None)
                return stripe.rdb_fused_i8(xk, wq8, sw8, bs8, x0, sas=sas_ if static else None,
                                           wp=wp8, route=route)

            five = {"rdb_fused_i8": 5, "conv3x3_i8:mma": 5}
            held(f"rdb_fused_i8 {shp} dynamic", rdb_run, {**five, "act_amax": 1})
            held(f"rdb_fused_i8 {shp} static", lambda r: rdb_run(r, True), five)
            new_ms = timed(lambda: rdb_run(None), 10)
            old_ms = timed(lambda: rdb_run("dp4a"), 3)
            snew_ms = timed(lambda: rdb_run(None, True), 10)
            sold_ms = timed(lambda: rdb_run("dp4a", True), 3)
            k1_ms = timed(lambda: stripe.rdb_fused(xk, ws8, bs8, x0), 10)
            ins = [rnd(shp[0], NF + k_ * GC, shp[1], shp[2]).contiguous(memory_format=torch.channels_last)
                   for k_ in range(5)]
            w_oihw = [w_.permute(3, 2, 0, 1).contiguous() for w_ in ws8]
            lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(ins, w_oihw, bs8)], 5)
            del ins
            ops = rdb_ops * shp[0] * shp[1] * shp[2] // (H * W)
            log(
                f"[k4] rdb_fused_i8 {shp}x64: dp4a (old kernel) {old_ms:.3f} ms, mma (new kernel) "
                f"{new_ms:.3f} ms ({old_ms / new_ms:.2f}x; {ops / new_ms / 1e9:.1f} TOPS useful); static "
                f"A8: dp4a {sold_ms:.3f}, mma {snew_ms:.3f} ms ({sold_ms / snew_ms:.2f}x); K1's bf16 RDB "
                f"{k1_ms:.3f} ms, library (bf16 cuDNN chain of 5) {lib_ms:.3f} ms"
            )
            check(tag != "1080p" or new_ms * 3 <= old_ms,
                  f"[k4] the mma route ({new_ms:.3f} ms per RDB) is not 3x the dp4a kernel ({old_ms:.3f})")
            k4_stats.update({f"rdb_{tag}_dp4a_ms": old_ms, f"rdb_{tag}_mma_ms": new_ms,
                             f"rdb_{tag}_static_dp4a_ms": sold_ms, f"rdb_{tag}_static_mma_ms": snew_ms,
                             f"rdb_{tag}_k1_bf16_ms": k1_ms, f"rdb_{tag}_library_ms": lib_ms})
            del xk, x0
            torch.cuda.empty_cache()

        # the SRVGG int8 body (config 4: 32 convs at nf 64) at 1080p
        NC = 32
        sv, swq, ssw = i8_srvgg(NC, NF)
        swp = torch.stack([quant.pack_i8_weights(q) for q in swq])
        xb = rnd(1, H, W, NF)
        k_ = srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp)
        check(torch.equal(k_, srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp, route="dp4a")),
              "[k4] srvgg_body_i8 1080p: mma != dp4a")
        check(torch.equal(k_, srvgg.srvgg_body_i8_plain(xb, swq, ssw, sv[1], sv[2])),
              "[k4] srvgg_body_i8 1080p: mma != plain")
        del k_
        new_ms = timed(lambda: srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp), 5)
        old_ms = timed(lambda: srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp, route="dp4a"), 2)
        bf_ms = timed(lambda: srvgg.srvgg_body(xb, *sv), 5)
        xb_nchw = xb.permute(0, 3, 1, 2)
        sv_oihw = [w_.permute(3, 2, 0, 1).contiguous() for w_ in sv[0]]

        def body_lib(f):
            for i in range(NC):
                f = F.prelu(F.conv2d(f, sv_oihw[i], sv[1][i], padding=1), sv[2][i])
            return f

        lib_ms = timed(lambda: body_lib(xb_nchw), 3)
        ops = NC * 2 * H * W * 9 * NF * NF
        log(
            f"[k4] srvgg_body_i8 1x{H}x{W}x64, 32 convs: dp4a (old kernel) {old_ms:.3f} ms, mma (new "
            f"kernel) {new_ms:.3f} ms ({old_ms / new_ms:.2f}x; {ops / new_ms / 1e9:.1f} TOPS useful), "
            f"K1's bf16 body {bf_ms:.3f} ms, library (bf16 cuDNN chain of 32 conv + prelu) {lib_ms:.3f} "
            f"ms; bit-equal to dp4a and plain; {k4_stats['bit_equal_cases']} cases bit-equal in all"
        )
        k4_stats.update(srvgg_dp4a_ms=old_ms, srvgg_mma_ms=new_ms, srvgg_k1_bf16_ms=bf_ms,
                        srvgg_library_ms=lib_ms)

    k5_stats, k3_stats, k6_stats = {}, {}, {}
    if want("k5", "kernels"):
        phase_k5()
        torch.cuda.empty_cache()
    if want("k3", "kernels"):
        phase_k3()
        torch.cuda.empty_cache()
    if want("k6", "kernels"):
        phase_k6()
        torch.cuda.empty_cache()
    k4_stats = {}
    if want("k4", "kernels"):
        phase_k4()
        torch.cuda.empty_cache()

    def phase_kernels():
        """Phase 3: every wrapper against its plain version, then the rows
        of the main paths' shapes with times and bounds."""
        # odd shapes, fp32 and bf16
        for dt in (torch.float32, torch.bfloat16):
            b, h, w = 2, 37, 53
            for cin, cout, act, res in (
                (3, 64, "none", False), (64, 64, "none", True),
                (64, 64, "lrelu", False), (64, 64, "prelu", False),
                (64, 3, "none", False),
            ):
                x = rnd(b, h, w, cin, dt=dt)
                wt = rnd(3, 3, cin, cout, scale=0.05, dt=dt)
                bias = rnd(cout, scale=0.1, dt=dt)
                al = rnd(cout, scale=0.3, dt=dt) if act == "prelu" else None
                r = rnd(b, h, w, cout, dt=dt) if res else None
                k = tail.conv3x3_fused(x, wt, bias, r, al, act=act)
                p = tail.conv3x3_fused_plain(x, wt, bias, r, al, act=act)
                e = compare(f"conv3x3_fused {cin}->{cout} {act}", k, p, dt)
                msg = f"[check] conv3x3_fused {dt} {b}x{h}x{w} {cin}->{cout} act={act} res={res} err={e:.3g}"
                if dt == torch.float32 and act == "none" and not res:
                    e64 = (k.double().cpu() - conv_ref64(x, wt, bias)).abs().max().item()
                    check(e64 <= 1e-4, f"conv3x3_fused vs float64: {e64:.3g}")
                    msg += f" err_vs_f64={e64:.3g}"
                log(msg)
            x = rnd(b, h, w, 64, dt=dt)
            wt, bias = rnd(3, 3, 64, 64, scale=0.05, dt=dt), rnd(64, scale=0.1, dt=dt)
            e = compare("up1_fused", tail.up1_fused(x, wt, bias), tail.up1_fused_plain(x, wt, bias), dt)
            log(f"[check] up1_fused {dt} {b}x{h}x{w} err={e:.3g}")
            tw = tail_weights(64, dt)
            e = compare("tail_fused", tail.tail_fused(x, *tw), tail.tail_fused_plain(x, *tw), dt)
            log(f"[check] tail_fused {dt} {b}x{h}x{w} err={e:.3g}")
            # K6 at odd shapes: doubled extents that no 16x28 (bf16) or 8x12
            # (fp32) tile divides, and a frame smaller than one tile
            for nf_, shp in ((16, (1, 19, 23)), (64, (b, h, w)), (16, (2, 4, 3))):
                xq, tq = rnd(*shp, nf_, dt=dt), tail_weights(nf_, dt)
                kq = tail.tail_fused_q(xq, *tq)
                check(kq.shape == (shp[0], 2 * shp[1], 2 * shp[2], 3) and kq.dtype == dt,
                      f"tail_fused_q shape {kq.shape}")
                e = compare("tail_fused_q", kq, tail.tail_fused_q_plain(xq, *tq), dt)
                e1 = (kq.float() - tail.tail_fused(xq, *tq).float()).abs().max().item()
                log(f"[check] tail_fused_q {dt} {shp} nf {nf_} err={e:.3g} vs_three_K1={e1:.3g}")
            ws, bs = rdb_weights(64, 32, dt)
            for x0 in (None, rnd(b, h, w, 64, dt=dt)):
                e = compare(
                    "rdb_fused", stripe.rdb_fused(x, ws, bs, x0),
                    stripe.rdb_fused_plain(x, ws, bs, x0), dt,
                )
                log(f"[check] rdb_fused {dt} {b}x{h}x{w} x0={x0 is not None} err={e:.3g}")
            # K5 at odd shapes: frames that no 8- or 16-pixel tile divides
            for nf_, gc_, shp in ((16, 8, (1, 37, 53)), (64, 32, (b, h, w)), (16, 8, (2, 8, 5))):
                x5 = rnd(*shp, nf_, dt=dt)
                w5 = [rdb_weights(nf_, gc_, dt) for _ in range(3)]
                for x0 in (None, rnd(*shp, nf_, dt=dt)):
                    e = compare(
                        "rdb_fused_k5", rdb.rdb_fused(x5, *w5[0], x0),
                        rdb.rdb_fused_plain(x5, *w5[0], x0), dt,
                    )
                    log(f"[check] rdb_fused_k5 {dt} {shp} nf {nf_} gc {gc_} x0={x0 is not None} err={e:.3g}")
                e = compare("rrdb_fused", rdb.rrdb_fused(x5, w5), rdb.rrdb_fused_plain(x5, w5), dt)
                log(f"[check] rrdb_fused {dt} {shp} nf {nf_} gc {gc_} err={e:.3g}")
            sw = srvgg_weights(4, 64, dt)
            e = compare("srvgg_body", srvgg.srvgg_body(x, *sw), srvgg.srvgg_body_plain(x, *sw), dt)
            log(f"[check] srvgg_body {dt} {b}x{h}x{w} 4 convs err={e:.3g}")
            xin = rnd(b, h, w, 3, dt=dt).abs()
            for r in srvgg.UP_SCALES:
                wo, bo = rnd(3, 3, 64, 3 * r * r, scale=0.05, dt=dt), rnd(3 * r * r, scale=0.1, dt=dt)
                k = srvgg.srvgg_up_fused(x, wo, bo, xin, r)
                p = srvgg.srvgg_up_fused_plain(x, wo, bo, xin, r)
                check(k.shape == (b, r * h, r * w, 3) and k.dtype == dt, f"srvgg_up_fused shape {k.shape}")
                e = compare(f"srvgg_up_fused r={r}", k, p, dt)
                log(f"[check] srvgg_up_fused {dt} {b}x{h}x{w} r={r} err={e:.3g}")
        for thr in (0.0, 0.02):
            xf = torch.rand(2, 37, 53, 3, generator=gen).to(dev)
            e = compare(
                "unsharp_fused", unsharp.unsharp_fused(xf, 0.3, 1.5, 4, thr),
                post.unsharp_mask(xf, 0.3, 1.5, 4, thr), torch.float32,
            )
            log(f"[check] unsharp_fused fp32 2x37x53 threshold={thr} err={e:.3g}")

        # K4 at odd shapes, bf16: each RDB conv (1..5 segments) and an SRVGG conv
        b, h, w = 2, 37, 53
        ws8, bs8, wq8, sw8 = i8_rdb(64, 32)
        grow = rnd(b, h, w, 64 + 4 * 32)
        amax = torch.zeros(b, 6, device=dev)
        segs5 = quant.rdb_segments(64, 32, 5)
        SAS_ODD = (0.0075, 0.0079, 0.0081, 0.0068, 0.0090)
        for s_ in range(5):
            quant.act_amax(grow[..., segs5[s_] : segs5[s_ + 1]], out=amax[:, s_])
            check(
                torch.equal(amax[:, s_], quant.act_amax_plain(grow[..., segs5[s_] : segs5[s_ + 1]])),
                "act_amax != its plain version",
            )
        for k_ in range(5):
            segs = quant.rdb_segments(64, 32, k_ + 1)
            kw = (dict(act="lrelu") if k_ < 4 else
                  dict(r1=grow[..., :64], s1=0.2, r2=rnd(b, h, w, 64), s2=0.2))
            oa, pa = torch.zeros(b, device=dev), torch.zeros(b, device=dev)
            args = (grow[..., : segs[-1]], segs, amax, wq8[k_], sw8[k_], bs8[k_])
            ko = quant.conv3x3_i8(*args, out_amax=oa, counter="check", **kw)
            po = quant.conv3x3_i8_plain(*args, out_amax=pa, **kw)
            e, st = bf16_steps(f"conv3x3_i8 RDB conv{k_ + 1}", ko, po)
            check(torch.equal(oa, pa), f"conv3x3_i8 conv{k_ + 1}: output amax {oa} != {pa}")
            log(f"[check] conv3x3_i8 bf16 {b}x{h}x{w} RDB conv{k_ + 1} ({k_ + 1} segments) err={e:.3g} steps={st:.2f}")
            # static A8: fixed scales below the segments' |max| / 127, so some
            # values saturate; no amax in or out
            args = (grow[..., : segs[-1]], segs, None, wq8[k_], sw8[k_], bs8[k_])
            ko = quant.conv3x3_i8(*args, sas=SAS_ODD[: k_ + 1], counter="check", **kw)
            po = quant.conv3x3_i8_plain(*args, sas=SAS_ODD[: k_ + 1], **kw)
            e, st = bf16_steps(f"conv3x3_i8 static RDB conv{k_ + 1}", ko, po)
            log(f"[check] conv3x3_i8 static bf16 {b}x{h}x{w} RDB conv{k_ + 1} ({k_ + 1} segments) err={e:.3g} steps={st:.2f}")
        sw4, swq4, ssw4 = i8_srvgg(1, 64)
        x = rnd(b, h, w, 64)
        ax = quant.act_amax(x)[:, None].contiguous()
        args = (x, (0, 64), ax, swq4[0], ssw4, sw4[1][0])
        kw = dict(act="prelu", alpha=sw4[2][0])
        e, st = bf16_steps("conv3x3_i8 SRVGG conv", quant.conv3x3_i8(*args, counter="check", **kw),
                           quant.conv3x3_i8_plain(*args, **kw))
        log(f"[check] conv3x3_i8 bf16 {b}x{h}x{w} SRVGG conv (prelu) err={e:.3g} steps={st:.2f}")
        for x0 in (None, rnd(b, h, w, 64)):
            k_out, k_amax = stripe.rdb_fused_i8(x, wq8, sw8, bs8, x0)
            p_out, p_amax = stripe.rdb_fused_i8_plain(x, wq8, sw8, bs8, x0)
            e = compare("rdb_fused_i8", k_out, p_out, torch.bfloat16)
            check(torch.equal(k_amax, p_amax), "rdb_fused_i8: output amax differs from plain")
            log(f"[check] rdb_fused_i8 bf16 {b}x{h}x{w} x0={x0 is not None} err={e:.3g}")
            sas_ = calibrate_rdb_act_scales(ws8, bs8, x)
            k_out, k_amax = stripe.rdb_fused_i8(x, wq8, sw8, bs8, x0, sas=sas_)
            p_out, _ = stripe.rdb_fused_i8_plain(x, wq8, sw8, bs8, x0, sas=sas_)
            e = compare("rdb_fused_i8 static", k_out, p_out, torch.bfloat16)
            check(k_amax is None, "rdb_fused_i8 static returned an amax")
            log(f"[check] rdb_fused_i8 static bf16 {b}x{h}x{w} x0={x0 is not None} err={e:.3g}")
        sw4, swq4, ssw4 = i8_srvgg(4, 64)
        e = compare(
            "srvgg_body_i8", srvgg.srvgg_body_i8(x, swq4, ssw4, sw4[1], sw4[2]),
            srvgg.srvgg_body_i8_plain(x, swq4, ssw4, sw4[1], sw4[2]), torch.bfloat16,
        )
        log(f"[check] srvgg_body_i8 bf16 {b}x{h}x{w} 4 convs err={e:.3g}")
        del grow, amax

        # main-path shapes, bf16 (unsharp: fp32), with times and bounds

        def bound(nbytes, ops, peak):
            return max(nbytes / PEAK_BYTES, ops / peak) * 1e3, (
                "bytes" if nbytes / PEAK_BYTES >= ops / peak else "operations"
            )

        def record(name, shape, k_fn, p_fn, reps, nbytes, ops, peak, dt, lib_fn=None):
            e = compare(name, k_fn(), p_fn(), dt)
            ms = timed(k_fn, reps)
            pms = timed(p_fn, max(1, reps // 2))
            lms = timed(lib_fn, reps) if lib_fn is not None else None
            bms, by = bound(nbytes, ops, peak)
            rows[name] = dict(
                max_abs_err=e, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                library_ms=lms,
            )
            log(
                f"[kernel] {name} {shape} err={e:.3g} kernel_ms={ms:.3f} "
                f"plain_ms={pms:.3f} library_ms="
                f"{'null' if lms is None else f'{lms:.3f}'} bound_ms={bms:.3f} ({by})"
            )

        def nchw(*shape):
            """A bf16 NCHW tensor in channels_last memory (the port's NHWC)."""
            return rnd(*shape).contiguous(memory_format=torch.channels_last)

        def oihw(w):
            return w.permute(3, 2, 0, 1).contiguous()

        xs = rnd(1, H, W, 3)
        ws_, bs_ = rnd(3, 3, 3, NF, scale=0.2), rnd(NF, scale=0.1)
        w_oihw = oihw(ws_)
        xs_nchw = xs.permute(0, 3, 1, 2)
        record(
            "conv3x3_fused", "stem 1x1080x1920x3->64",
            lambda: tail.conv3x3_fused(xs, ws_, bs_),
            lambda: tail.conv3x3_fused_plain(xs, ws_, bs_), 10,
            (H * W * 3 + 9 * 3 * NF + NF + H * W * NF) * 2,
            2 * H * W * 9 * 3 * NF, PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(xs_nchw, w_oihw, bs_, padding=1),
        )
        xb, rb = rnd(1, H, W, NF), rnd(1, H, W, NF)
        wb, bb = rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.1)
        xb_nchw, wb_oihw = xb.permute(0, 3, 1, 2), oihw(wb)
        record(
            "conv3x3:mma", "conv_body+res 1x1080x1920x64 (library: F.conv2d, conv only)",
            lambda: tail.conv3x3_fused(xb, wb, bb, rb),
            lambda: tail.conv3x3_fused_plain(xb, wb, bb, rb), 10,
            3 * H * W * NF * 2 + (wb.numel() + bb.numel()) * 2,
            2 * H * W * 9 * NF * NF, PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(xb_nchw, wb_oihw, bb, padding=1),
        )
        ws, bs = rdb_weights(NF, GC, bf)
        rdb_ops = sum(2 * H * W * 9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
        rdb_wbytes = sum(w.numel() + b.numel() for w, b in zip(ws, bs)) * 2
        rdb_in = [nchw(1, NF + k * GC, H, W) for k in range(5)]
        rdb_w = [oihw(w) for w in ws]
        record(
            "rdb_fused", "1x1080x1920x64 (nf 64, gc 32)",
            lambda: stripe.rdb_fused(xb, ws, bs),
            lambda: stripe.rdb_fused_plain(xb, ws, bs), 5,
            2 * H * W * NF * 2 + rdb_wbytes, rdb_ops, PEAK_BF16, bf,
            lib_fn=lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
        )
        e = compare(
            "rdb_fused x0", stripe.rdb_fused(xb, ws, bs, rb),
            stripe.rdb_fused_plain(xb, ws, bs, rb), bf,
        )
        log(f"[kernel] rdb_fused with x0 (rdb3) err={e:.3g}")
        rrdb_w = [(ws, bs)] + [rdb_weights(NF, GC, bf) for _ in range(2)]
        rrdb_wbytes = sum(t.numel() for ws_, bs_ in rrdb_w for t in (*ws_, *bs_)) * 2
        rrdb_w_oihw = [[oihw(w) for w in ws_] for ws_, _ in rrdb_w]

        def rrdb_lib(ins):
            return [F.conv2d(a, w, b_, padding=1) for (_, bs_), wo in zip(rrdb_w, rrdb_w_oihw)
                    for a, w, b_ in zip(ins, wo, bs_)]

        def k5_rows(tag, xk, ins, n_px):
            """K5's two entry points at one shape: one RDB, then a whole RRDB."""
            ops = rdb_ops * n_px // (H * W)
            record(
                "rdb_fused_k5" + tag, f"{tuple(xk.shape)} (nf 64, gc 32), one launch",
                lambda: rdb.rdb_fused(xk, ws, bs), lambda: rdb.rdb_fused_plain(xk, ws, bs), 5,
                2 * n_px * NF * 2 + rdb_wbytes, ops, PEAK_BF16, bf,
                lib_fn=lambda: [F.conv2d(a, w, b_, padding=1) for a, w, b_ in zip(ins, rdb_w, bs)],
            )
            e = compare("rdb_fused_k5 x0", rdb.rdb_fused(xk, ws, bs, xk), rdb.rdb_fused_plain(xk, ws, bs, xk), bf)
            log(f"[check] rdb_fused_k5 with x0 {tuple(xk.shape)} err={e:.3g}")
            record(
                "rrdb_fused" + tag, f"{tuple(xk.shape)}, 3 RDBs + residual, one cooperative launch "
                "(library: chain of 15 convs)",
                lambda: rdb.rrdb_fused(xk, rrdb_w), lambda: rdb.rrdb_fused_plain(xk, rrdb_w), 3,
                2 * n_px * NF * 2 + rrdb_wbytes, 3 * ops, PEAK_BF16, bf,
                lib_fn=lambda: rrdb_lib(ins),
            )

        k5_rows("", xb, rdb_in, H * W)
        ws8, bs8, wq8, sw8 = i8_rdb(NF, GC)
        wp8 = [quant.pack_i8_weights(q) for q in wq8]  # K4's mma route, as a model prepares them
        rdb_i8_wbytes = sum(
            q.numel() + s_.numel() * 4 + b_.numel() * 2 for q, s_, b_ in zip(wq8, sw8, bs8)
        )
        k_out = stripe.rdb_fused_i8(xb, wq8, sw8, bs8, wp=wp8)[0]
        e, st = bf16_steps("rdb_fused_i8 1080p", k_out, stripe.rdb_fused_i8_plain(xb, wq8, sw8, bs8)[0])
        log(f"[check] rdb_fused_i8 bf16 1x1080x1920x64 err={e:.3g} steps={st:.2f}")
        del k_out
        record(
            "rdb_fused_i8", "1x1080x1920x64 (nf 64, gc 32), W8A8 (library: the bf16 cuDNN chain)",
            lambda: stripe.rdb_fused_i8(xb, wq8, sw8, bs8, wp=wp8)[0],
            lambda: stripe.rdb_fused_i8_plain(xb, wq8, sw8, bs8)[0], 5,
            2 * H * W * NF * 2 + rdb_i8_wbytes, rdb_ops, PEAK_INT8, bf,
            lib_fn=lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
        )
        def static_rdb_row(tag, xk, lib_fn, n_px):
            """The whole static-A8 RDB at one shape: within one bf16 step of its
            plain version per value, 5 K4 launches and no amax launch, times."""
            sas_ = calibrate_rdb_act_scales(ws8, bs8, xk[:1, :128, :128])
            torch.cuda.synchronize()
            _build.reset_launches()
            k_out = stripe.rdb_fused_i8(xk, wq8, sw8, bs8, sas=sas_, wp=wp8)[0]
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == {"rdb_fused_i8": 5, "conv3x3_i8:mma": 5},
                  f"static RDB launches {got} != 5 K4 on the mma route and no amax")
            e, st = bf16_steps(
                "rdb_fused_i8 static" + tag, k_out,
                stripe.rdb_fused_i8_plain(xk, wq8, sw8, bs8, sas=sas_)[0],
            )
            log(f"[check] rdb_fused_i8 static bf16 {tuple(xk.shape)} err={e:.3g} steps={st:.2f} launches={json.dumps(got)}")
            del k_out
            record(
                "rdb_fused_i8 static" + tag,
                f"{tuple(xk.shape)} (nf 64, gc 32), W8A8 with fixed scales (library: the bf16 cuDNN chain)",
                lambda: stripe.rdb_fused_i8(xk, wq8, sw8, bs8, sas=sas_, wp=wp8)[0],
                lambda: stripe.rdb_fused_i8_plain(xk, wq8, sw8, bs8, sas=sas_)[0], 5,
                2 * n_px * NF * 2 + rdb_i8_wbytes, rdb_ops * n_px // (H * W), PEAK_INT8, bf,
                lib_fn=lib_fn,
            )

        static_rdb_row(
            "", xb, lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
            H * W,
        )
        # the amax kernel is a maximum, exact in any order: equal to its plain
        # version bit for bit at every shape, on the 16-byte path (C and the
        # pixel stride multiples of 8, an aligned base) and the scalar one
        grow = rnd(2, 37, 53, 192)
        amax_cases = [("B = 2, C = 64", rnd(2, 37, 53, 64)), ("B = 2, C = 3", rnd(2, 37, 53, 3)),
                      ("C = 3 at 1080p", xs)]
        amax_cases += [(f"C = 32 at [{lo}:{lo + 32}] of 192", grow[..., lo : lo + 32])
                       for lo in (64, 96, 128, 160)]
        amax_cases += [("misaligned [3:35] of 192 (scalar path)", grow[..., 3:35]),
                       ("B = 2, C = 160 prefix of 192", grow[..., :160]), ("1x1080x1920x64", xb)]
        for tag, xa in amax_cases:
            ka, pa = quant.act_amax(xa), quant.act_amax_plain(xa)
            check(torch.equal(ka, pa), f"act_amax {tag}: {ka.tolist()} != plain {pa.tolist()}")
            log(f"[check] act_amax {tag} {tuple(xa.shape)}: equal to plain {ka.tolist()}")
        del grow
        record(
            "act_amax", "1x1080x1920x64 -> (1,) (library: torch.linalg.vector_norm ord=inf)",
            lambda: quant.act_amax(xb), lambda: quant.act_amax_plain(xb), 10,
            H * W * NF * 2 + 4, 2 * H * W * NF, PEAK_FP32, torch.float32,
            lib_fn=lambda: torch.linalg.vector_norm(xb, float("inf"), dim=(1, 2, 3)),
        )
        del rdb_in
        wu, bu = rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.1)
        up_in = nchw(1, NF, 2 * H, 2 * W)
        wu_oihw = oihw(wu)
        record(
            "up1_fused", "1x1080x1920x64 -> 1x2160x3840x64",
            lambda: tail.up1_fused(xb, wu, bu),
            lambda: tail.up1_fused_plain(xb, wu, bu), 5,
            (H * W * NF + 4 * H * W * NF) * 2, 2 * H * W * 16 * NF * NF,
            PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(up_in, wu_oihw, bu, padding=1),
        )
        del xs, xs_nchw, rb, up_in
        x2 = tail.up1_fused(xb, wu, bu)
        tw = tail_weights(NF, bf)
        h2, w2 = 2 * H, 2 * W
        tail_ops = (
            2 * h2 * w2 * 16 * NF * NF + 2 * 4 * h2 * w2 * 9 * NF * NF
            + 2 * 4 * h2 * w2 * 9 * NF * 3
        )
        tail_in = nchw(1, NF, 2 * h2, 2 * w2)
        tw_oihw = [oihw(tw[0]), oihw(tw[2]), oihw(tw[4])]

        def tail_lib():
            f = F.conv2d(tail_in, tw_oihw[0], tw[1], padding=1)
            f = F.conv2d(f, tw_oihw[1], tw[3], padding=1)
            return F.conv2d(f, tw_oihw[2], tw[5], padding=1)

        record(
            "tail_fused", "1x2160x3840x64 -> 1x4320x7680x3",
            lambda: tail.tail_fused(x2, *tw),
            lambda: tail.tail_fused_plain(x2, *tw), 3,
            (h2 * w2 * NF + 4 * h2 * w2 * 3) * 2, tail_ops, PEAK_BF16, bf,
            lib_fn=tail_lib,
        )
        e1 = (tail.tail_fused_q(x2, *tw).float() - tail.tail_fused(x2, *tw).float()).abs().max().item()
        log(f"[check] tail_fused_q vs the three-K1 tail_fused at 1x2160x3840x64: max |diff| {e1:.3g}")
        record(
            "tail_fused_q", "1x2160x3840x64 -> 1x4320x7680x3, one launch (library: chain of 3 convs)",
            lambda: tail.tail_fused_q(x2, *tw),
            lambda: tail.tail_fused_q_plain(x2, *tw), 3,
            (h2 * w2 * NF + 4 * h2 * w2 * 3) * 2, tail_ops, PEAK_BF16, bf,
            lib_fn=tail_lib,
        )
        del x2, tail_in
        torch.cuda.empty_cache()
        # conv_last alone, on K1's narrow route, at the flagship tail's shape
        xl = rnd(1, 4 * H, 4 * W, NF)
        wl, bl = tw[4], tw[5]
        xl_nchw, wl_oihw = xl.permute(0, 3, 1, 2), oihw(wl)
        npx = 16 * H * W
        record(
            "conv3x3:narrow conv_last", "1x4320x7680x64 -> 3 (library: F.conv2d of conv_last alone)",
            lambda: tail.conv3x3(xl, wl, bl, counter="check"),
            lambda: tail.conv3x3_plain(xl, wl, bl), 5,
            (npx * (NF + 3) + wl.numel() + bl.numel()) * 2, 2 * npx * 9 * NF * 3, PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(xl_nchw, wl_oihw, bl, padding=1),
        )
        del xl, xl_nchw
        torch.cuda.empty_cache()
        xu = torch.rand(1, 4 * H, 4 * W, 3, generator=gen).to(dev)
        record(
            "unsharp_fused", "1x4320x7680x3 fp32",
            lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4),
            lambda: post.unsharp_mask(xu, 0.3, 1.5, 4), 10,
            2 * xu.numel() * 4, xu.numel() * (2 * 2 * 9 + 4), PEAK_FP32,
            torch.float32,
        )
        del xu
        # config 4 (SRVGGNetCompact, nf 64, 32 convs, r 4) at 1080x1920
        NC, R = 32, 4
        sw = srvgg_weights(NC, NF, bf)
        sw_oihw = [oihw(w) for w in sw[0]]

        def body_lib(f):
            for i in range(NC):
                f = F.prelu(F.conv2d(f, sw_oihw[i], sw[1][i], padding=1), sw[2][i])
            return f

        record(
            "srvgg_body", "1x1080x1920x64, 32 x (conv 64->64 + PReLU)",
            lambda: srvgg.srvgg_body(xb, *sw),
            lambda: srvgg.srvgg_body_plain(xb, *sw), 3,
            2 * H * W * NF * 2 + sum(t.numel() for t in sw) * 2,
            NC * 2 * H * W * 9 * NF * NF, PEAK_BF16, bf,
            lib_fn=lambda: body_lib(xb_nchw),
        )
        sq = [quant.quantize_conv_weights(w_, (0, NF)) for w_ in sw[0]]
        swq, ssw = torch.stack([a for a, _ in sq]), torch.cat([s_ for _, s_ in sq])
        swp = torch.stack([quant.pack_i8_weights(a) for a, _ in sq])
        srvgg_i8_wbytes = swq.numel() + ssw.numel() * 4 + (sw[1].numel() + sw[2].numel()) * 2
        record(
            "srvgg_body_i8", "1x1080x1920x64, 32 x W8A8 (conv 64->64 + PReLU) (library: the bf16 cuDNN chain)",
            lambda: srvgg.srvgg_body_i8(xb, swq, ssw, sw[1], sw[2], swp),
            lambda: srvgg.srvgg_body_i8_plain(xb, swq, ssw, sw[1], sw[2]), 3,
            2 * H * W * NF * 2 + srvgg_i8_wbytes, NC * 2 * H * W * 9 * NF * NF, PEAK_INT8, bf,
            lib_fn=lambda: body_lib(xb_nchw),
        )
        xin = rnd(1, H, W, 3).abs()
        wo, bo = rnd(3, 3, NF, 3 * R * R, scale=0.05), rnd(3 * R * R, scale=0.1)
        wo_oihw = oihw(wo)
        record(
            "srvgg_up_fused", "1x1080x1920x64 -> 1x4320x7680x3 (r 4)",
            lambda: srvgg.srvgg_up_fused(xb, wo, bo, xin, R),
            lambda: srvgg.srvgg_up_fused_plain(xb, wo, bo, xin, R), 10,
            (H * W * NF + H * W * 3 + R * R * H * W * 3 + wo.numel() + bo.numel()) * 2,
            2 * H * W * 9 * NF * 3 * R * R, PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(xb_nchw, wo_oihw, bo, padding=1),
        )
        del xb, xb_nchw, xin
        # the tile batch of phase 7 (720x1280, tile 512 / overlap 32: six tiles
        # of 376x448 in one model call), logged beside the rows above
        TB, TH, TW = 6, 376, 448
        xt = rnd(TB, TH, TW, NF)
        xt_nchw = xt.permute(0, 3, 1, 2)
        rdb_in = [nchw(TB, NF + k * GC, TH, TW) for k in range(5)]
        record(
            "rdb_fused tiles", f"{TB}x{TH}x{TW}x64 (nf 64, gc 32)",
            lambda: stripe.rdb_fused(xt, ws, bs),
            lambda: stripe.rdb_fused_plain(xt, ws, bs), 5,
            2 * TB * TH * TW * NF * 2 + rdb_wbytes,
            rdb_ops * TB * TH * TW // (H * W), PEAK_BF16, bf,
            lib_fn=lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
        )
        e, st = bf16_steps(
            "rdb_fused_i8 tiles", stripe.rdb_fused_i8(xt, wq8, sw8, bs8, wp=wp8)[0],
            stripe.rdb_fused_i8_plain(xt, wq8, sw8, bs8)[0],
        )
        log(f"[check] rdb_fused_i8 bf16 {TB}x{TH}x{TW}x64 err={e:.3g} steps={st:.2f}")
        record(
            "rdb_fused_i8 tiles", f"{TB}x{TH}x{TW}x64 (nf 64, gc 32), W8A8 (library: the bf16 cuDNN chain)",
            lambda: stripe.rdb_fused_i8(xt, wq8, sw8, bs8, wp=wp8)[0],
            lambda: stripe.rdb_fused_i8_plain(xt, wq8, sw8, bs8)[0], 5,
            2 * TB * TH * TW * NF * 2 + rdb_i8_wbytes, rdb_ops * TB * TH * TW // (H * W),
            PEAK_INT8, bf,
            lib_fn=lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
        )
        static_rdb_row(
            " tiles", xt, lambda: [F.conv2d(a, w, b, padding=1) for a, w, b in zip(rdb_in, rdb_w, bs)],
            TB * TH * TW,
        )
        del rdb_in
        BB, BH, BW = 4, 384, 504  # bench_rdb's shape, the JAX tile chunk
        xc = rnd(BB, BH, BW, NF)
        rdb_in = [nchw(BB, NF + k * GC, BH, BW) for k in range(5)]
        k5_rows(" bench", xc, rdb_in, BB * BH * BW)
        del xc, rdb_in
        record(
            "srvgg_body tiles", f"{TB}x{TH}x{TW}x64, 32 convs",
            lambda: srvgg.srvgg_body(xt, *sw),
            lambda: srvgg.srvgg_body_plain(xt, *sw), 3,
            2 * TB * TH * TW * NF * 2 + sum(t.numel() for t in sw) * 2,
            NC * 2 * TB * TH * TW * 9 * NF * NF, PEAK_BF16, bf,
            lib_fn=lambda: body_lib(xt_nchw),
        )
        record(
            "srvgg_body_i8 tiles", f"{TB}x{TH}x{TW}x64, 32 W8A8 convs (library: the bf16 cuDNN chain)",
            lambda: srvgg.srvgg_body_i8(xt, swq, ssw, sw[1], sw[2], swp),
            lambda: srvgg.srvgg_body_i8_plain(xt, swq, ssw, sw[1], sw[2]), 3,
            2 * TB * TH * TW * NF * 2 + srvgg_i8_wbytes, NC * 2 * TB * TH * TW * 9 * NF * NF,
            PEAK_INT8, bf,
            lib_fn=lambda: body_lib(xt_nchw),
        )
        xin = rnd(TB, TH, TW, 3).abs()
        record(
            "srvgg_up_fused tiles", f"{TB}x{TH}x{TW}x64 -> {TB}x{R * TH}x{R * TW}x3",
            lambda: srvgg.srvgg_up_fused(xt, wo, bo, xin, R),
            lambda: srvgg.srvgg_up_fused_plain(xt, wo, bo, xin, R), 10,
            TB * TH * TW * (NF + 3 + 3 * R * R) * 2 + (wo.numel() + bo.numel()) * 2,
            2 * TB * TH * TW * 9 * NF * 3 * R * R, PEAK_BF16, bf,
            lib_fn=lambda: F.conv2d(xt_nchw, wo_oihw, bo, padding=1),
        )
        del xt, xt_nchw, xin, sw, sw_oihw, swq, ssw, swp
        torch.cuda.empty_cache()

    if want("kernels"):
        phase_kernels()

    # ---- phases 4-7: the main paths ----------------------------------------
    from video_restore_tpu_torch.cli import build_parser, config_from_args
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO, save_params_npz
    from video_restore_tpu_torch.ops import tiles as tiles_mod
    from video_restore_tpu_torch.ops.color import quantize_u8
    from video_restore_tpu_torch.parallel.dispatch import Upscaler
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.utils.logging import setup_logging
    from video_restore_tpu_torch.video.y4m import (
        Y4MReader,
        Y4MWriter,
        rgb_to_yuv_planes,
        yuv_planes_to_rgb,
    )
    setup_logging()
    os.environ["VRT_ALLOW_RANDOM_WEIGHTS"] = "1"
    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    models_dir = work / "models"
    models_dir.mkdir()

    def make_clip(path, h, w, n):
        """Gradient + moving box + mild noise, a hard cut before the last
        frame."""
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = []
        for t in range(n):
            if t < n - 1:  # one scene
                f = np.stack([xx / w, yy / h, np.full((h, w), 0.3)], -1) * 200 + 20
                f[h * 5 // 18 : h * 25 // 54, w * 5 // 24 + 40 * t : w * 5 // 16 + 40 * t] = (230, 60, 60)
            else:  # hard cut: another scene
                f = np.stack([(xx + yy) / (h + w), 1 - xx / w, yy / h], -1) * 120
                f[::64] = 250
            f = f + np.random.default_rng(t).normal(0, 3, f.shape)
            frames.append(np.clip(f, 0, 255).astype(np.uint8))
        with Y4MWriter(path, w, h, 25) as wr:
            for f in frames:
                wr.write(f)

    def psnr_u8(a, b):
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)

    def read_planes(path):
        """The raw frames of a 4:2:0 y4m file as written: (n, H*3//2, W)
        uint8, no colour conversion."""
        with open(path, "rb") as f:
            hdr = f.readline().split()
            w_, h_ = (int(t[1:]) for t in hdr[1:3])
            planes = []
            while f.readline():
                planes.append(np.frombuffer(f.read(w_ * h_ * 3 // 2), np.uint8).reshape(h_ * 3 // 2, w_))
        return np.stack(planes)

    total_launches = {}
    path_stats = {}

    def stage_split(tag, model, grid, cfg, frames, outs):
        """The restore step by stage on the kernel path as the CLI runs it
        (device I420 out): ``restore_step`` as it runs, its stage functions
        (``dispatch.py``'s module names) wrapped in CUDA events and put back
        after; the casts and the EMA loop are the gaps between them. The
        frame's copy to the card (the pinned feed ring) and the planes' copy
        back (the pinned fetch ring) are timed apart, on the host clock
        between synchronisations, beside what the RGB step did in their
        place: ``quantize_u8`` of the same frame (CUDA events, not in the
        step) and the pageable ``.cpu()`` of its RGB result. One warm-up
        pass over the frames, then the timed pass from a fresh temporal
        carry, whose planes must equal the kernel path's (the warm-up pass
        fetches through the ring too, so that the timed pass finds its
        pinned slots allocated). Last, the frames in a loop as the runner
        issues them (each fetch waited one frame later), the fetch on the
        compute stream (``Upscaler.fetch``) and, in turns, on a side stream
        into pinned buffers of the same size (``record_stream`` and a
        ``wait_stream``)."""
        from video_restore_tpu_torch.parallel import dispatch

        names = ("bilateral_filter", "clahe", "tiled_apply", "unsharp_fused", "_luma_hist",
                 "rgb_to_yuv420_planar")
        saved = {n: getattr(dispatch, n) for n in names}
        marks = []
        yuv_in = []

        def wrap(name, fn):
            def stage(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                marks.append((name, e0, e1))
                if name == "rgb_to_yuv420_planar":
                    yuv_in[:] = [a[0]]
                return out
            return stage

        ups = Upscaler(model, grid, cfg, dev, yuv420_out=True)
        try:
            for n in names:
                setattr(dispatch, n, wrap(n, saved[n]))
            for f in frames:  # warm-up, the fetch ring's slots allocated
                fetched = ups.fetch(ups.process_batch(f[None]))
                fetched.wait()
                fetched.release()
            ups.reset_temporal()
            per_frame = []
            for i, f in enumerate(frames):
                marks.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x = ups.stage(f[None])
                torch.cuda.synchronize()
                stage_ms = 1e3 * (time.perf_counter() - t0)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = ups.process_batch(x)
                e1.record()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fetched = ups.fetch(out)
                planes = fetched.wait()[0]
                fetch_ms = 1e3 * (time.perf_counter() - t0)
                planes = planes.copy()
                fetched.release()
                check(np.array_equal(planes, outs[i]), f"[{tag}] frame {i}: the timed step != the kernel path")
                r0 = torch.cuda.Event(enable_timing=True)
                r1 = torch.cuda.Event(enable_timing=True)
                r0.record()
                rgb = quantize_u8(yuv_in[0])
                r1.record()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rgb.cpu()
                pageable_ms = 1e3 * (time.perf_counter() - t0)
                got = [m[0] for m in marks]
                check(got == ["bilateral_filter", "clahe", "tiled_apply", "unsharp_fused",
                              "_luma_hist", "_luma_hist", "rgb_to_yuv420_planar"], f"[{tag}] stages {got}")
                (_, b0, b1), (_, c0, c1), (_, m0, m1), (_, u0, u1), (_, h0, h1), (_, g0, g1), (_, q0, q1) = marks
                per_frame.append({
                    "cast u8->fp32": e0.elapsed_time(b0), "bilateral_filter": b0.elapsed_time(b1),
                    "clahe (LR)": c0.elapsed_time(c1), "cast bf16": c1.elapsed_time(m0),
                    "tiled_apply (model)": m0.elapsed_time(m1), "unsharp_fused": u0.elapsed_time(u1),
                    "_luma_hist (frame)": h0.elapsed_time(h1), "_luma_hist (carry)": g0.elapsed_time(g1),
                    "EMA loop, clamp": g1.elapsed_time(q0), "rgb_to_yuv420_planar": q0.elapsed_time(q1),
                    "carry cast, gaps": u1.elapsed_time(h0) + q1.elapsed_time(e1),
                    "step (events)": e0.elapsed_time(e1), "stage (H2D, pinned)": stage_ms,
                    "fetch (D2H, pinned, I420)": fetch_ms,
                    "quantize_u8 (RGB, not in the step)": r0.elapsed_time(r1),
                    "fetch (D2H, pageable .cpu(), RGB)": pageable_ms,
                })
            del out, rgb, x
            yuv_in.clear()
        finally:
            for n in names:
                setattr(dispatch, n, saved[n])

        def loop_ms(fetch_fn):
            ups.reset_temporal()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lag = []
            for f in frames:
                lag.append(fetch_fn(ups.process_batch(f[None])))
                if len(lag) > 1:
                    lag.pop(0)()
            while lag:
                lag.pop(0)()
            return 1e3 * (time.perf_counter() - t0) / len(frames)

        def on_compute(out):
            fetched = ups.fetch(out)
            return lambda: (fetched.wait(), fetched.release())

        side = torch.cuda.Stream(dev)
        pinned = [torch.empty(outs[0].shape, dtype=torch.uint8, pin_memory=True)[None] for _ in range(2)]
        turn = [0]

        def on_side(out):
            buf = pinned[turn[0] % 2]
            turn[0] += 1
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                buf.copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            out.record_stream(side)
            return ev.synchronize

        loops = {"compute": [], "side": []}
        for name in ("compute", "side", "side", "compute", "compute", "side"):
            loops[name].append(loop_ms(on_compute if name == "compute" else on_side))
        del ups, pinned
        torch.cuda.empty_cache()
        mean = {k: sum(f[k] for f in per_frame) / len(per_frame) for k in per_frame[0]}
        host = ("step (events)", "stage (H2D, pinned)", "fetch (D2H, pinned, I420)",
                "quantize_u8 (RGB, not in the step)", "fetch (D2H, pageable .cpu(), RGB)")
        stages = [k for k in mean if k not in host]
        total = sum(mean[k] for k in stages)
        log(f"[post] {tag} step by stage, ms/frame (mean of {len(per_frame)} frames, CUDA events; "
            "device I420 out): " + ", ".join(f"{k} {mean[k]:.3f}" for k in stages)
            + f"; sum {total:.3f}; step (events) {mean['step (events)']:.3f}; host clock around "
              f"synchronised copies: stage (H2D, pinned) {mean['stage (H2D, pinned)']:.3f}, fetch "
              f"(D2H, pinned, I420) {mean['fetch (D2H, pinned, I420)']:.3f}")
        log(f"[post] {tag} in place of the I420 stage and fetch, the RGB step's: quantize_u8 "
            f"{mean['quantize_u8 (RGB, not in the step)']:.3f} ms (events) and the pageable .cpu() "
            f"{mean['fetch (D2H, pageable .cpu(), RGB)']:.3f} ms (host clock), against "
            f"rgb_to_yuv420_planar {mean['rgb_to_yuv420_planar']:.3f} and the pinned fetch "
            f"{mean['fetch (D2H, pinned, I420)']:.3f}")
        log(f"[post] {tag} the frames in a loop, each fetch waited a frame later, host clock ms/frame "
            f"(compute, side, side, compute, compute, side): fetch on the compute stream "
            f"(Upscaler.fetch) {', '.join(f'{v:.2f}' for v in loops['compute'])}; on a side stream "
            f"{', '.join(f'{v:.2f}' for v in loops['side'])}")
        return dict(mean, sum=total, loop_compute_ms=loops["compute"], loop_side_ms=loops["side"])

    def drive(tag, src, argv, per_call, cfg_check, expect_tiles, vs_bf16=False,
              vs_default=None, post_split=False, rgb_check=False):
        """One main path: the CLI's config through ``VideoRestorer`` with
        the launch counters reset before and read after (the y4m sink takes
        planar I420 from the device), then the kernel path (RGB and I420
        out) and the plain path on the decoded frames: the file's planes
        equal the I420 kernel path's byte for byte, and the RGB kernel path
        is held to the plain one. With ``vs_bf16``, the bf16 kernel path,
        which the int8 output must stay within 35 dB of; with
        ``vs_default``, the name of the knob that is set, the kernel path of
        the default route without that knob, which must stay within 45 dB;
        with ``post_split``, the kernel path's step by stage,
        :func:`stage_split`; with ``rgb_check``, the CLI's config again with
        ``device_yuv="off"``, whose file must equal the RGB kernel path's
        frames after the y4m colour round trip."""
        dst = work / f"out_{tag}.y4m"
        cfg = config_from_args(build_parser().parse_args([str(src), str(dst)] + argv))
        check(cfg_check(cfg), f"[{tag}] unexpected config {cfg}")
        restorer = VideoRestorer(cfg)
        with Y4MReader(src) as rd:  # the frames the CLI decodes (y4m is 4:2:0)
            decoded = list(rd)
            h, w = rd.info.height, rd.info.width
        n_frames = len(decoded)
        # the bucket process_video uses: the y4m sink takes device I420
        grid = restorer._upscaler_for(h, w, yuv_out=True).grid
        check(grid.n_tiles == expect_tiles, f"[{tag}] {grid.n_tiles} tiles, expected {expect_tiles}")
        s = restorer.model.scale
        expected = {k: v * grid.n_chunks * n_frames for k, v in per_call.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        ok = restorer.process_video(src, dst, show_progress=False)
        torch.cuda.synchronize()
        counts = _build.launches()
        check(ok, f"[{tag}] VideoRestorer.process_video failed")
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = restorer.last_stats
        check(
            st.decoded == st.inferred == st.encoded == n_frames,
            f"[{tag}] frame accounting {st.decoded}/{st.inferred}/{st.encoded}",
        )
        check(counts == expected, f"[{tag}] launch counts {counts} != expected {expected}")
        check(list(restorer._upscalers) == [(h, w, True)],
              f"[{tag}] buckets {list(restorer._upscalers)}: not the device-I420 route")
        for k, v in counts.items():
            total_launches[k] = total_launches.get(k, 0) + v
        with Y4MReader(dst) as rd:
            check(
                (rd.info.width, rd.info.height) == (s * w, s * h),
                f"[{tag}] output size {rd.info.width}x{rd.info.height}",
            )
        out_planes = read_planes(dst)
        check(out_planes.shape == (n_frames, s * h * 3 // 2, s * w),
              f"[{tag}] output planes {out_planes.shape}")
        log(
            f"[{tag}] {n_frames} frames {w}x{h} -> {s * w}x{s * h}, {grid.n_tiles} "
            f"tile(s) of {grid.tile_shape}, {grid.n_chunks} model call(s)/frame, "
            f"in {st.wall_s:.2f}s ({st.fps:.4f} fps, {1e3 * st.wall_s / n_frames:.1f} "
            f"ms/frame wall, stages "
            f"{json.dumps({k: round(v, 3) for k, v in st.stages.items()})}); "
            f"peak device memory {peak:.2f} GiB"
        )
        log(f"[{tag}] launches {json.dumps(counts)}")
        frames_ = max(cfg.frames_per_batch, 1)
        in_memory = restorer._tail_in_memory()
        est = tiles_mod.full_frame_bytes(h, w, s, frames=frames_, tail_in_memory=in_memory)
        jax_est = tiles_mod.full_frame_bytes(h, w, s, frames=frames_)
        log(
            f"[{tag}] auto_full_frame estimate for {frames_} frame(s) of {w}x{h}: "
            f"{est / 2**30:.2f} GiB (tail intermediates in device memory: {in_memory}; "
            f"without them {jax_est / 2**30:.2f}); measured peak {peak:.2f} GiB"
            + ("" if grid.n_tiles == 1 else " (tiled: the estimate is of a full frame)")
        )
        model = restorer.model
        del restorer
        torch.cuda.empty_cache()
        outs, step_ms = {}, {}
        runs = [(False, cfg), (True, cfg), ("yuv", cfg)]
        if vs_bf16:
            runs.append(("bf16", dataclasses.replace(cfg, precision="bf16")))
        if vs_default:
            runs.append(("default", cfg))
        for key, run_cfg in runs:
            if key == "default":  # the module resolves its modes without the knob
                knob = os.environ.pop(vs_default)
                ups = Upscaler(model, grid, run_cfg, dev)
                os.environ[vs_default] = knob
            else:
                ups = Upscaler(model, grid, run_cfg, dev, plain=key is True,
                               yuv420_out=key == "yuv")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if key == "yuv":  # fetched as the runner fetches: the pinned ring
                outs[key] = []
                for f in decoded:
                    fetched = ups.fetch(ups.process_batch(f[None]))
                    outs[key].append(fetched.wait()[0].copy())
                    fetched.release()
            else:
                outs[key] = [ups.process_batch(f[None])[0].cpu().numpy() for f in decoded]
            dt_s = time.perf_counter() - t0
            step_ms[key] = 1e3 * dt_s / n_frames
            name = {False: "kernel", True: "plain", "bf16": "bf16 kernel", "yuv": "kernel (I420 out, pinned fetch)",
                    "default": f"default (no {vs_default}) kernel"}[key]
            log(
                f"[{tag}] {name} path: "
                f"{step_ms[key]:.1f} ms/frame, {n_frames / dt_s:.4f} fps "
                "(step only, frames already decoded)"
            )
            del ups
            torch.cuda.empty_cache()
        for i in range(n_frames):
            a, b_ = outs[False][i], outs[True][i]
            psnr = psnr_u8(a, b_)
            d = np.abs(a.astype(np.int32) - b_.astype(np.int32))
            log(
                f"[{tag}] frame {i}: kernel vs plain PSNR {psnr:.2f} dB, "
                f"{100 * (d > 0).mean():.3f}% of values differ, max {d.max()}"
            )
            check(psnr >= 45.0, f"[{tag}] frame {i}: kernel vs plain {psnr:.2f} dB < 45")
            check(
                np.array_equal(outs["yuv"][i], out_planes[i]),
                f"[{tag}] frame {i}: the CLI's planes != the I420 kernel step's",
            )
        per_frame_ms = {k: 1e3 * st.stages.get(k, 0.0) / n_frames for k in ("fetch", "encode")}
        log(
            f"[{tag}] wall {1e3 * st.wall_s / n_frames:.1f} ms/frame; step (I420, pinned fetch) "
            f"{step_ms['yuv']:.1f}, step (RGB, .cpu()) {step_ms[False]:.1f} ms/frame; encode thread: "
            f"fetch {per_frame_ms['fetch']:.1f}, encode {per_frame_ms['encode']:.1f} ms/frame; the "
            "CLI's planes equal the I420 kernel step's byte for byte"
        )
        path_stats[tag] = dict(
            wall_ms_per_frame=1e3 * st.wall_s / n_frames, fps=st.fps,
            step_ms=step_ms[False], plain_step_ms=step_ms[True], peak_gib=peak,
            yuv_step_ms=step_ms["yuv"], fetch_ms=per_frame_ms["fetch"],
            encode_ms=per_frame_ms["encode"], stages_s=st.stages,
        )
        if rgb_check:
            rgb_dst = work / f"out_{tag}_rgb.y4m"
            rgb_restorer = VideoRestorer(dataclasses.replace(cfg, device_yuv="off"), model=model)
            check(rgb_restorer.process_video(src, rgb_dst, show_progress=False),
                  f"[{tag}] device_yuv=off: process_video failed")
            check(list(rgb_restorer._upscalers) == [(h, w, False)], f"[{tag}] device_yuv=off buckets")
            rst = rgb_restorer.last_stats
            del rgb_restorer
            torch.cuda.empty_cache()
            with Y4MReader(rgb_dst) as rd:
                rgb_frames = list(rd)
            check(len(rgb_frames) == n_frames, f"[{tag}] device_yuv=off: {len(rgb_frames)} frames")
            for i, a in enumerate(outs[False]):
                check(
                    np.array_equal(yuv_planes_to_rgb(*rgb_to_yuv_planes(a, "420")), rgb_frames[i]),
                    f"[{tag}] frame {i}: device_yuv=off output != the RGB kernel step's after the "
                    "y4m round trip",
                )
            rgb_ms = {k: 1e3 * rst.stages.get(k, 0.0) / n_frames for k in ("fetch", "encode")}
            log(
                f"[{tag}] device_yuv=off (RGB out, host colour conversion): wall "
                f"{1e3 * rst.wall_s / n_frames:.1f} ms/frame; encode thread: fetch "
                f"{rgb_ms['fetch']:.1f}, encode {rgb_ms['encode']:.1f} ms/frame; the file equals the "
                "RGB kernel step's frames after the y4m colour round trip"
            )
            path_stats[tag]["rgb_out"] = dict(wall_ms_per_frame=1e3 * rst.wall_s / n_frames,
                                              fetch_ms=rgb_ms["fetch"], encode_ms=rgb_ms["encode"])
        if vs_bf16:
            dbs = [psnr_u8(a, b_) for a, b_ in zip(outs[False], outs["bf16"])]
            log(f"[{tag}] int8 vs bf16 kernel path PSNR per frame: {', '.join(f'{d:.2f}' for d in dbs)} dB")
            check(min(dbs) >= 35.0, f"[{tag}] int8 vs bf16 {min(dbs):.2f} dB < 35")
            path_stats[tag].update(bf16_step_ms=step_ms["bf16"], int8_vs_bf16_db=dbs)
        if vs_default:
            dbs = [psnr_u8(a, b_) for a, b_ in zip(outs[False], outs["default"])]
            log(f"[{tag}] vs the default (no {vs_default}) kernel path PSNR per frame: {', '.join(f'{d:.2f}' for d in dbs)} dB")
            check(min(dbs) >= 45.0, f"[{tag}] vs the default route {min(dbs):.2f} dB < 45")
            path_stats[tag].update(default_step_ms=step_ms["default"], vs_default_db=dbs)
        if post_split:
            split = stage_split(tag, model, grid, cfg, decoded, outs["yuv"])
            log(f"[post] {tag} step (host clock, the kernel paths above, same run): I420 out with the "
                f"pinned fetch {step_ms['yuv']:.1f} ms/frame, RGB out with .cpu() {step_ms[False]:.1f}")
            path_stats[tag]["stage_ms"] = split

    spec = MODEL_ZOO["RealESRGAN_x4plus"].spec
    check((spec.num_feat, spec.num_grow_ch, spec.num_block) == (64, 32, 23), "flagship spec")
    v3 = MODEL_ZOO["RealESRGAN_x4_v3"].spec
    check((v3.num_feat, v3.num_conv, v3.scale) == (64, 32, 4), "config-4 spec")
    n_rdb = 3 * spec.num_block * 5

    def k1_routes(mma, stem, last):
        """K1 launches per model call by route (``conv3x3_route``) and, on
        the narrow route, by kernel; no call on the fma route."""
        counts = (("conv3x3:mma", mma), ("conv3x3:narrow", stem + last),
                  ("conv3x3:narrow stem", stem), ("conv3x3:narrow conv_last", last))
        return {k: v for k, v in counts if v}

    # per model call. K1 of an RRDBNet frame: the stem and conv_last on the
    # narrow route; the dense-block convs, conv_body, up1, upconv2 and
    # conv_hr on the mma route. A path that ran on an old kernel fails its
    # counts.
    rrdb_call = {
        "conv3x3_fused": 2, "rdb_fused": n_rdb, "up1_fused": 1, "tail_fused": 3,
        **k1_routes(n_rdb + 4, 1, 1),
    }
    srvgg_call = {
        "conv3x3_fused": 1, "srvgg_body": v3.num_conv, "srvgg_up_fused": 1,
        "srvgg_up_fused:mma": 1, **k1_routes(v3.num_conv, 1, 0),
    }
    # K4 of an int8 RRDBNet frame: every RDB conv on the int8 tensor cores
    rrdb_i8_call = {
        "conv3x3_fused": 2, "act_amax": 1, "rdb_fused_i8": n_rdb,
        "conv3x3_i8:mma": n_rdb, "up1_fused": 1, "tail_fused": 3, **k1_routes(4, 1, 1),
    }
    # K2 of an enhanced frame: the sharpen stage on the rows route
    K2_ROWS = {"unsharp_fused": 1, "unsharp_fused:rows": 1}
    flagship = ["--model", "RealESRGAN_x4plus", "--enhanced", "--sharpen", "0.3",
                "--tile-size", "0", "--models-dir", str(models_dir)]
    config4 = ["--model", "RealESRGAN_x4_v3", "--anime-mode", "--quality", "fast",
               "--models-dir", str(models_dir)]
    tiled = ["--quality", "balanced", "--tile-size", "512", "--tile-overlap", "32",
             "--models-dir", str(models_dir)]

    def is_flagship(precision):
        return lambda c: (c.denoise == 0.5 and c.sharpen == 0.3 and c.color_enhance
                          and c.clahe_lr and c.temporal and c.tile_size == 0
                          and c.precision == precision)

    def is_config4(precision):
        return lambda c: (c.model_name == "RealESRGAN_x4_v3" and c.denoise == 0.5
                          and c.sharpen == 0 and c.color_enhance and c.clahe_lr
                          and c.temporal and c.full_frame == "auto" and c.precision == precision)

    def is_tiled(precision):
        return lambda c: (c.tile_size == 512 and c.tile_overlap == 32
                          and c.full_frame == "off" and c.seamless
                          and not c.enhanced_mode and c.precision == precision)

    # (tag, clip (h, w, frames), argv, per call, config check, tiles, knob, drive's keywords)
    PATHS = (
        # phases 4-5: the flagship
        ("main", (H, W, 3), flagship + ["--precision", "bf16"],
         {**rrdb_call, **K2_ROWS}, is_flagship("bf16"), 1, None, dict(post_split=True, rgb_check=True)),
        # phase 6: path A, config 4
        ("config4", (H, W, 3), config4, srvgg_call, is_config4("bf16"), 1, None, {}),
        # phase 7: path B, config 2's tiles, both families
        ("tiled_x4plus", (720, 1280, 2), ["--model", "RealESRGAN_x4plus"] + tiled,
         rrdb_call, is_tiled("bf16"), 6, None, {}),
        ("tiled_x4_v3", (720, 1280, 2), ["--model", "RealESRGAN_x4_v3"] + tiled,
         srvgg_call, is_tiled("bf16"), 6, None, {}),
        # phase 8: the int8 paths (W8A8 body on K4), 2 frames each
        ("main_int8", (H, W, 2), flagship + ["--precision", "int8"],
         {**rrdb_i8_call, **K2_ROWS}, is_flagship("int8"), 1, None, dict(vs_bf16=True)),
        ("config4_int8", (H, W, 2), config4 + ["--precision", "int8"],
         {"conv3x3_fused": 1, "act_amax": 1, "srvgg_body_i8": v3.num_conv,
          "conv3x3_i8:mma": v3.num_conv, "srvgg_up_fused": 1, "srvgg_up_fused:mma": 1, **k1_routes(0, 1, 0)},
         is_config4("int8"), 1, None, dict(vs_bf16=True)),
        ("tiled_x4plus_int8", (720, 1280, 2),
         ["--model", "RealESRGAN_x4plus", "--precision", "int8"] + tiled,
         rrdb_i8_call, is_tiled("int8"), 6, None, dict(vs_bf16=True)),
        # phase 9: the VRT_PALLAS=1 body (one K5 launch per RRDB block)
        ("main_pallas", (H, W, 2), flagship + ["--precision", "bf16"],
         {"conv3x3_fused": 2, "rrdb_fused": spec.num_block,
          "rrdb_fused:mma": spec.num_block, "up1_fused": 1,
          "tail_fused": 3, **K2_ROWS, **k1_routes(4, 1, 1)},
         is_flagship("bf16"), 1, "VRT_PALLAS", dict(vs_default="VRT_PALLAS")),
        # phase 10: the VRT_TAIL_Q=1 tail (one K6 launch per frame, no K1 tail)
        ("main_tailq", (H, W, 2), flagship + ["--precision", "bf16"],
         {"conv3x3_fused": 2, "rdb_fused": n_rdb, "up1_fused": 1,
          "tail_fused_q": 1, "tail_fused_q:mma": 1, **K2_ROWS,
          **k1_routes(n_rdb + 2, 1, 0)},
         is_flagship("bf16"), 1, "VRT_TAIL_Q", dict(vs_default="VRT_TAIL_Q")),
    )
    check(tuple(p_[0] for p_ in PATHS) == PATH_TAGS, "path tags")

    def config4_weights():
        """Config 4 with synthetic weights at an informative scale (Kaiming
        stem and body, conv_out gain 0.1, PReLU 0.25): the JAX init's 0.1
        gain on every conv makes a random net's output equal its
        nearest-upsampled input, which would hide the convs from the u8
        check."""
        rng = np.random.default_rng(0)

        def kaiming(*shape, gain=1.0):
            return (rng.normal(0, (2.0 / (9 * shape[-2])) ** 0.5, shape) * gain).astype(np.float32)

        nf, nc = v3.num_feat, v3.num_conv
        save_params_npz(
            {
                "conv_in": {"w": kaiming(3, 3, 3, nf), "b": np.zeros(nf, np.float32)},
                "alpha_in": np.full(nf, 0.25, np.float32),
                "body": {
                    "w": kaiming(nc, 3, 3, nf, nf),
                    "b": rng.normal(0, 0.01, (nc, nf)).astype(np.float32),
                    "alpha": np.full((nc, nf), 0.25, np.float32),
                },
                "conv_out": {
                    "w": kaiming(3, 3, nf, 3 * v3.scale**2, gain=0.1),
                    "b": np.zeros(3 * v3.scale**2, np.float32),
                },
            },
            models_dir / "RealESRGAN_x4_v3.npz",
        )

    config4_weights()
    clips = {}
    for tag, clip, argv_, per_call, cfg_check, tiles, knob, kw in PATHS:
        if not want("paths", tag):
            continue
        if clip not in clips:
            clips[clip] = work / "in_{}x{}_{}.y4m".format(*clip)
            make_clip(clips[clip], *clip)
        if knob:
            os.environ[knob] = "1"
        try:
            drive(tag, clips[clip], argv_, per_call, cfg_check, tiles, **kw)
        finally:
            if knob:
                os.environ.pop(knob)

    # ---- phases 13-15: the face prior, the face pass, the outscale resize ----
    from video_restore_tpu_torch.models import gfpgan as gfp
    from video_restore_tpu_torch.ops import faces as faces_mod
    from video_restore_tpu_torch.ops.resample import resize_lanczos4
    from video_restore_tpu_torch.video import y4m as y4m_mod

    def gfpgan_ckpt():
        """The schema-exact synthetic checkpoint (the one
        ``tests/goldens/GFPGANv1.4.npz`` was computed from) as a released
        ``.pth`` in the models directory, read back through ``load_gfpgan``
        (and so through the converter) wherever the prior runs."""
        path = models_dir / "GFPGANv1.4.pth"
        if not path.exists():
            sd = {k: torch.from_numpy(v) for k, v in gfp.synthetic_gfpgan_sd().items()}
            torch.save({"params_ema": sd}, path)
        return path

    def phase_gfpgan():
        """[gfpgan] GFPGAN v1-clean at its full published width on the card:
        loaded from the synthetic .pth, held to the committed golden (>= 45
        dB, SSIM >= 0.99) and to the CPU forward of the same module at batch
        2; ms per crop at batch 1, 2, 4 and 8 with TF32 off (the port's
        choice) and on, beside the FLOPs and bounds; peak memory."""
        check("VRT_GFPGAN_RANDOM" not in os.environ, "[gfpgan] VRT_GFPGAN_RANDOM is set")
        t0 = time.perf_counter()
        gfpgan_ckpt()
        state, spec = gfp.load_gfpgan(models_dir)
        check(spec == gfp.GFPGANSpec() and (spec.out_size, spec.num_style_feat, spec.channel_multiplier,
                                            spec.narrow) == (512, 512, 2, 1.0), f"[gfpgan] spec {spec}")
        net = gfp.GFPGAN(spec)
        net.load_state_dict(state)
        net = net.to(dev).eval()
        log(f"[gfpgan] synthetic checkpoint written and loaded through load_gfpgan in "
            f"{time.perf_counter() - t0:.1f}s")
        golden = np.load(REPO / "tests" / "goldens" / "GFPGANv1.4.npz")["out"]
        x = torch.from_numpy(gfp.golden_tiles(seed=11, n=1, h=512, w=512)).permute(0, 3, 1, 2)
        res = {}
        with torch.no_grad():
            for prec in gfp.PRECISIONS:
                y = net(x.to(dev), precision=prec).permute(0, 2, 3, 1).cpu().numpy()
                db, ssim = gfp.golden_scores(y, golden)
                err = float(np.abs(y - golden).max())
                res[prec] = dict(db=db, ssim=ssim, max_abs_err=err)
                log(f"[gfpgan] {prec}: vs tests/goldens/GFPGANv1.4.npz PSNR {db:.2f} dB, SSIM {ssim:.6f}, "
                    f"max abs err {err:.3g}")
            check(res["fp32"]["db"] >= 45.0 and res["fp32"]["ssim"] >= 0.99,
                  f"[gfpgan] fp32 vs the golden {res['fp32']}")
            x2 = torch.from_numpy(gfp.golden_tiles(seed=12, n=2, h=512, w=512)).permute(0, 3, 1, 2)
            card = net(x2.to(dev)).cpu()
            cpu_net = gfp.GFPGAN(spec)
            cpu_net.load_state_dict(state)
            t0 = time.perf_counter()
            ref = cpu_net.eval()(x2)
            cpu_s = time.perf_counter() - t0
            err = float((card - ref).abs().max())
            db_cpu, _ = gfp.golden_scores(card.permute(0, 2, 3, 1).numpy(), ref.permute(0, 2, 3, 1).numpy())
            log(f"[gfpgan] card vs CPU forward of the same module, batch 2: max abs err {err:.3g}, "
                f"PSNR {db_cpu:.2f} dB (CPU {cpu_s:.1f} s)")
            check(err <= 2e-3 and db_cpu >= 45.0, f"[gfpgan] card vs CPU: {err:.3g}, {db_cpu:.2f} dB")
            del cpu_net, ref
            flops = gfp.gfpgan_flops(spec)
            ms = {}
            torch.cuda.reset_peak_memory_stats()
            for prec in gfp.PRECISIONS:
                for b in (1, 2, 4, 8):
                    xb = torch.rand(b, 3, 512, 512, generator=gen).to(dev)
                    ms[f"{prec} b{b}"] = timed(lambda: net(xb, precision=prec), 3) / b
            peak = torch.cuda.max_memory_allocated() / 2**30
        bound = {p: 1e3 * flops / peak_ for p, peak_ in (("fp32", PEAK_FP32), ("tf32", PEAK_TF32))}
        for prec in gfp.PRECISIONS:
            log(f"[gfpgan] {prec} ms per crop at batch 1, 2, 4, 8: "
                + ", ".join(f"{ms[f'{prec} b{b}']:.3f}" for b in (1, 2, 4, 8))
                + f"; bound {bound[prec]:.3f} ms ({flops / 1e9:.1f} GFLOP per crop over "
                  f"{(PEAK_FP32 if prec == 'fp32' else PEAK_TF32) / 1e12:.0f} TFLOP/s)")
        log(f"[gfpgan] peak device memory {peak:.2f} GiB (batch 8, the module's weights included)")
        path_stats["gfpgan"] = dict(golden=res, card_vs_cpu_err=err, card_vs_cpu_db=db_cpu,
                                    ms_per_crop=ms, gflop_per_crop=flops / 1e9, bound_ms=bound,
                                    peak_gib=peak)

    if want("gfpgan"):
        phase_gfpgan()

    def tap_writes():
        """Records the RGB frames the runner hands the y4m writer (the
        path of every run with faces or a resize)."""
        frames, orig = [], y4m_mod.Y4MWriter.write

        def write(self, frame):
            frames.append(np.array(frame))
            orig(self, frame)

        y4m_mod.Y4MWriter.write = write
        return frames, lambda: setattr(y4m_mod.Y4MWriter, "write", orig)

    def run_cli(tag, src, argv, model=None, expected=None, n_frames=None, **cfg_kw):
        """``process_video`` of the CLI's config (with ``cfg_kw`` replaced)
        with the launch counters reset before and read after; the RGB frames
        written are returned."""
        dst = work / f"out_{tag}.y4m"
        cfg = config_from_args(build_parser().parse_args([str(src), str(dst)] + argv))
        cfg = dataclasses.replace(cfg, **cfg_kw)
        restorer = VideoRestorer(cfg, model=model)
        written, untap = tap_writes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        try:
            ok = restorer.process_video(src, dst, show_progress=False)
            torch.cuda.synchronize()
        finally:
            untap()
        counts = _build.launches()
        check(ok, f"[{tag}] process_video failed")
        st = restorer.last_stats
        check(st.decoded == st.inferred == st.encoded == n_frames,
              f"[{tag}] frame accounting {st.decoded}/{st.inferred}/{st.encoded}")
        if expected is not None:
            check(counts == expected, f"[{tag}] launch counts {counts} != expected {expected}")
        for k, v in counts.items():
            total_launches[k] = total_launches.get(k, 0) + v
        with Y4MReader(dst) as rd:
            on_disk = list(rd)
        check(len(on_disk) == len(written) == n_frames, f"[{tag}] {len(on_disk)} frames written")
        return restorer, written, st, torch.cuda.max_memory_allocated() / 2**30, counts

    def face_clip(path, h, w, n):
        """Skin-toned faces (an ellipse with eyes and a mouth) on a bluish
        background no skin threshold takes: frame 0 with three faces, one
        over the left edge; frame 1 with none; frame 2 with two."""
        rng = np.random.default_rng(13)
        yy, xx = np.mgrid[0:h, 0:w]
        k = w / 1280  # the positions below are for 720x1280
        faces_at = {0: [(300, 260, 60, 78), (20, 420, 58, 76), (900, 330, 48, 64)], 1: [],
                    2: [(320, 270, 60, 78), (880, 340, 48, 64)]}
        faces_at = {t: [tuple(int(v * k) for v in f) for f in fs] for t, fs in faces_at.items()}
        with Y4MWriter(path, w, h, 25) as wr:
            for t in range(n):
                f = np.stack([40 + xx * 60 / w, 70 + yy * 50 / h, np.full((h, w), 170.0)], -1)
                for cx, cy, rx, ry in faces_at[t % 3]:
                    f[((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1] = (220, 170, 140)
                    for ex in (cx - rx // 3, cx + rx // 3):  # eyes
                        f[(xx - ex) ** 2 + (yy - cy + ry // 4) ** 2 <= (rx // 8) ** 2] = (60, 40, 40)
                    f[(abs(xx - cx) <= rx // 3) & (abs(yy - cy - ry // 2) <= 2)] = (150, 70, 70)  # mouth
                f = f + rng.normal(0, 3, f.shape)
                wr.write(np.clip(f, 0, 255).astype(np.uint8))

    def face_regions(boxes, s, hh, ww):
        """Every pixel either face pass may touch for these LR boxes: the
        heuristic's expanded boxes and the prior's loose squares."""
        m = np.zeros((hh, ww), bool)
        for box in boxes:
            e = box.scaled(s).expanded(0.25, ww, hh)
            m[e.y : e.y + e.h, e.x : e.x + e.w] = True
            b = box.scaled(s)
            side = int(max(b.w, b.h) * 1.6)
            x0 = max(0, min(b.x + b.w // 2 - side // 2, ww - side))
            y0 = max(0, min(b.y + b.h // 2 - side // 2, hh - side))
            m[y0 : y0 + side, x0 : x0 + side] = True
        return m

    @contextlib.contextmanager
    def without_cv2():
        """OpenCV made unimportable (and the detector chosen again): the face
        pass and the resize must run without it. The machine's own OpenCV,
        where it has one, would give the JAX package's detector chain the
        Haar cascade, which finds no synthetic face."""
        try:
            import cv2

            have = f"cv2 {cv2.__version__}, the chain would pick {faces_mod._init_detector()[0]}"
        except ImportError:
            have = "no cv2"
        log(f"[faces] this machine: {have}; cv2 blocked for the faces and outscale paths")
        prev = sys.modules.get("cv2")
        sys.modules["cv2"] = None
        faces_mod._detector = None
        try:
            yield
        finally:
            faces_mod._detector = None
            if prev is None:
                sys.modules.pop("cv2", None)
            else:
                sys.modules["cv2"] = prev

    def phase_faces():
        """``faces``: RealESRGAN_x4plus at full frame on a 3-frame 720x1280
        clip with faces the skin detector finds (OpenCV blocked), through
        the CLI's config three times: without
        ``--face-enhance`` (``device_yuv="off"``, so that all three write
        RGB through the same host conversion), with ``--face-enhance
        --face-model gfpgan`` (the synthetic checkpoint in the models
        directory) and with ``--face-model regions``. Outside every face's
        region the written frames equal the run without faces byte for
        byte; inside, the card's pass is held to the same pass on the CPU
        from the same step output and boxes; the K1 launches are the x4plus
        table's; ``last_stats`` has its ``faces`` stage."""
        h, w, n = 720, 1280, 3
        src = work / "in_faces.y4m"
        face_clip(src, h, w, n)
        with Y4MReader(src) as rd:
            decoded = list(rd)
        boxes = [faces_mod.detect_faces(f) for f in decoded]
        check(faces_mod._get_detector()[0] == "skin", f"[faces] detector {faces_mod._get_detector()[0]}")
        check([len(b) for b in boxes] == [3, 0, 2], f"[faces] the skin detector found {boxes}")
        gfpgan_ckpt()
        base_argv = ["--model", "RealESRGAN_x4plus", "--tile-size", "0", "--models-dir", str(models_dir)]
        expected = {k: v * n for k, v in rrdb_call.items()}
        r0, base, st0, peak0, _ = run_cli("faces_off", src, base_argv, expected=expected, n_frames=n,
                                          device_yuv="off")
        model = r0.model
        check(list(r0._upscalers) == [(h, w, False)], f"[faces_off] buckets {list(r0._upscalers)}")
        # the step's RGB frames on the card, for the byte checks
        ups = Upscaler(model, r0._upscalers[(h, w, False)].grid, r0.config, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = [ups.process_batch(f[None])[0] for f in decoded]
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n
        for i in range(n):
            check(np.array_equal(base[i], steps[i].cpu().numpy()),
                  f"[faces_off] frame {i}: the run without faces != the step")
        stats = {}
        for mode in ("gfpgan", "regions"):
            tag = f"faces_{mode}"
            r, out, st, peak, counts = run_cli(
                tag, src, base_argv + ["--face-enhance", "--face-model", mode], model=model,
                expected=expected, n_frames=n)
            check("faces" in st.stages, f"[{tag}] no faces stage in last_stats {st.stages}")
            check(list(r._upscalers) == [(h, w, False)], f"[{tag}] buckets {list(r._upscalers)}")
            check((r._gfpgan is not False and r._gfpgan is not None) == (mode == "gfpgan"),
                  f"[{tag}] the GFPGAN runner {r._gfpgan}")
            s = model.scale
            face_pass = r._face_pass()
            cpu_pass = face_pass
            if mode == "gfpgan":
                cpu_runner = faces_mod.make_gfpgan_runner(models_dir, device="cpu")
                cpu_pass = lambda f, b: faces_mod.restore_faces_learned(f, b, s, cpu_runner, 0.5)  # noqa: E731
            pass_ms, worst, frac = 0.0, 0, 0.0
            for i in range(n):
                step = steps[i].cpu().numpy()
                keep = ~face_regions(boxes[i], s, h * s, w * s)
                check(np.array_equal(out[i][keep], step[keep]),
                      f"[{tag}] frame {i}: outside the face regions != the step's frame")
                if not boxes[i]:
                    check(np.array_equal(out[i], step), f"[{tag}] frame {i} without faces changed")
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card = face_pass(steps[i], boxes[i])
                torch.cuda.synchronize()
                pass_ms += 1e3 * (time.perf_counter() - t0)
                card = card.cpu().numpy()
                check(np.array_equal(card, out[i]), f"[{tag}] frame {i}: the file != the card's pass")
                if mode == "regions" or i == 0:  # the CPU prior: one frame
                    cpu = cpu_pass(torch.from_numpy(step), boxes[i]).numpy()
                    d = np.abs(cpu.astype(np.int32) - card.astype(np.int32))
                    worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
                    check(d.max() <= 2 and (d > 0).mean() <= 0.01,
                          f"[{tag}] frame {i}: card vs CPU pass max {d.max()}, {(d > 0).mean():.4%} differ")
            n_px = sum(int(face_regions(b, s, h * s, w * s).sum()) for b in boxes)
            wall = 1e3 * st.wall_s / n
            face_stage = 1e3 * st.stages.get("faces", 0.0) / n
            log(f"[{tag}] {n} frames {w}x{h} -> {s * w}x{s * h}, faces {[len(b) for b in boxes]}: wall "
                f"{wall:.1f} ms/frame (without faces {1e3 * st0.wall_s / n:.1f}; the step alone "
                f"{step_ms:.1f}, RGB, synchronised), faces stage "
                f"{face_stage:.1f} ms/frame (host: the wait for the boxes and the pass's launches), the "
                f"card's face pass {pass_ms / n:.1f} ms/frame (synchronised), stages "
                f"{json.dumps({k: round(v, 3) for k, v in st.stages.items()})}; peak device memory "
                f"{peak:.2f} GiB (without faces {peak0:.2f}); outside the regions ({n_px} px of "
                f"{n * s * s * h * w}) byte-equal to the step; card vs CPU pass max {worst} level(s), "
                f"{frac:.4%} of values differ")
            stats[mode] = dict(wall_ms_per_frame=wall, step_ms=step_ms, face_stage_ms=face_stage,
                               face_pass_ms=pass_ms / n,
                               stages_s=st.stages, peak_gib=peak, cpu_max=worst, cpu_frac=frac)
        stats["off"] = dict(wall_ms_per_frame=1e3 * st0.wall_s / n, peak_gib=peak0, stages_s=st0.stages)
        path_stats["faces"] = stats

    def phase_outscale():
        """``outscale``: RealESRGAN_x4_v3 (config 4's seeded weights) at
        full frame on 2 frames of 1080x1920 with ``--outscale 2``: 3840x2160
        out through the CLI's config; the written frames equal the card's
        Lanczos4 resize of the step's frames and are within 1 level of the
        port's CPU resize of the same frames; the launches are config 4's."""
        h, w, n = H, W, 2
        src = work / "in_outscale.y4m"
        make_clip(src, h, w, n)
        argv = ["--model", "RealESRGAN_x4_v3", "--tile-size", "0", "--outscale", "2",
                "--models-dir", str(models_dir)]
        expected = {k: v * n for k, v in srvgg_call.items()}
        r, out, st, peak, _ = run_cli("outscale", src, argv, expected=expected, n_frames=n)
        size = (2 * w, 2 * h)  # x4, then outscale 2
        check(out[0].shape == (size[1], size[0], 3), f"[outscale] frame {out[0].shape}")
        check("resize" in st.stages, f"[outscale] no resize stage in {st.stages}")
        check(list(r._upscalers) == [(h, w, False)], f"[outscale] buckets {list(r._upscalers)}")
        with Y4MReader(src) as rd:
            decoded = list(rd)
        ups = Upscaler(r.model, r._upscalers[(h, w, False)].grid, r.config, dev)
        resize_ms, step_ms = [], []
        for i, f in enumerate(decoded):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = ups.process_batch(f[None])
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            card = resize_lanczos4(y, size)
            resize_ms.append(timed(lambda: resize_lanczos4(y, size), 3))
            card = card[0].cpu().numpy()
            cpu = resize_lanczos4(y.cpu(), size)[0].numpy()
            check(np.array_equal(card, out[i]), f"[outscale] frame {i}: the file != the card's resize")
            d = np.abs(card.astype(np.int32) - cpu.astype(np.int32))
            check(d.max() <= 1, f"[outscale] frame {i}: card vs CPU resize max {d.max()}")
        wall = 1e3 * st.wall_s / n
        log(f"[outscale] {n} frames {w}x{h} -> {4 * w}x{4 * h} -> {size[0]}x{size[1]}: wall {wall:.1f} ms/frame, step "
            f"{np.mean(step_ms):.1f} ms/frame (RGB, synchronised), the card's Lanczos4 resize "
            f"{np.mean(resize_ms):.3f} ms/frame (CUDA events), resize stage "
            f"{1e3 * st.stages.get('resize', 0.0) / n:.1f} ms/frame (host: launches), stages "
            f"{json.dumps({k: round(v, 3) for k, v in st.stages.items()})}; peak device memory "
            f"{peak:.2f} GiB; the file equals the card's resize of the step, within 1 level of the CPU "
            f"resize")
        path_stats["outscale"] = dict(wall_ms_per_frame=wall, step_ms=float(np.mean(step_ms)),
                                      resize_ms=float(np.mean(resize_ms)), stages_s=st.stages,
                                      peak_gib=peak)

    with without_cv2():
        if want("paths", "faces"):
            phase_faces()
        if want("paths", "outscale"):
            phase_outscale()


    def phase_io():
        """[io] the host I/O around ``VideoRestorer``: the pinned ring under
        stress (24 batches through 3 slots, a device-heavy producer and a
        writer that sleeps: every frame equal to its ``.cpu()`` copy, in
        order, every slot back); the native framecodec (it must load: g++
        is on this machine) timed against numpy on a 7680x4320 frame; and
        a 72x128 mp4 clip with audio through the repo's fake ffmpeg
        (``tests/fake_ffmpeg.py`` on PATH, npz payloads): the planes on the
        encoder pipe equal the I420 kernel step's, the audio is copied,
        segmented resume after a simulated crash equals an uninterrupted
        run, and a two-resolution batch directory gives (2, 2). Config 4's
        model (seeded weights) at full frame, no enhancement (a resumed run
        restarts the temporal carry); each ``process_video`` with the
        launch counters reset before and read after."""
        from importlib.util import module_from_spec, spec_from_file_location

        from video_restore_tpu_torch.parallel.dispatch import PinnedRing
        from video_restore_tpu_torch.utils import native
        from video_restore_tpu_torch.video import ffmpeg_available, ffmpeg_backend, open_reader, segmented
        from video_restore_tpu_torch.video import y4m as y4m_mod

        stats = {}
        # the ring: a producer whose copies trail its device work, a slow writer
        ring = PinnedRing(3, pin=True)
        a = torch.randn(2048, 2048, device=dev) / 64
        items: queue.Queue = queue.Queue()
        written = []

        def writer():
            while True:
                item = items.get()
                if item is None:
                    return
                slot, event, i = item
                event.synchronize()
                time.sleep(0.01)
                written.append((i, slot.buf.numpy().copy()))
                ring.release(slot)

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        t0 = time.perf_counter()
        srcs = []
        for i in range(24):
            y_ = a
            for _ in range(8):
                y_ = torch.tanh(y_ @ a)
            t = ((y_[:1620, :1920] + 1) * 100 + i).to(torch.uint8)  # a 1080p frame's planes
            srcs.append(t)
            slot = ring.acquire(t.shape, t.dtype)
            slot.buf.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            items.put((slot, event, i))
        items.put(None)
        th.join(timeout=120)
        ring_s = time.perf_counter() - t0
        check(not th.is_alive(), "[io] the ring's writer did not finish")
        check([i for i, _ in written] == list(range(24)), "[io] the ring reordered frames")
        for i, arr in written:
            check(np.array_equal(arr, srcs[i].cpu().numpy()), f"[io] ring frame {i} != its .cpu() copy")
        check(ring._free.qsize() == 3, "[io] a ring slot was not returned")
        log(f"[io] pinned ring: 24 batches of 1620x1920 through 3 slots, writer sleeping 10 ms each, "
            f"{ring_s:.2f} s; every frame equal to its .cpu() copy, in order; all slots back")
        del srcs, written, a
        # the native framecodec
        lib = native.load()
        check(lib is not None, "[io] the native framecodec did not build or load")
        frame = np.random.default_rng(0).integers(0, 256, (4320, 7680, 3), dtype=np.uint8)

        def host_ms(fn, reps):
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps

        nat_ms = host_ms(lambda: native.rgb_to_yuv(frame, "420"), 5)
        nat = native.rgb_to_yuv(frame, "420")
        with_native = native.rgb_to_yuv
        native.rgb_to_yuv = lambda *a_: None
        try:
            np_ms = host_ms(lambda: y4m_mod.rgb_to_yuv_planes(frame, "420"), 2)
            ref = y4m_mod.rgb_to_yuv_planes(frame, "420")
        finally:
            native.rgb_to_yuv = with_native
        lsb = max(int(np.abs(p_.astype(np.int16) - q_.astype(np.int16)).max()) for p_, q_ in zip(nat, ref))
        check(lsb <= 2, f"[io] native vs numpy {lsb} LSB > 2")
        log(f"[io] native framecodec ({native.library_path(native._FLAG_SETS[0]).name}): "
            f"rgb_to_yuv420 of a 7680x4320 frame {nat_ms:.2f} ms, numpy {np_ms:.2f} ms "
            f"({np_ms / nat_ms:.1f}x); max |native - numpy| {lsb} LSB (bound 2)")
        stats.update(ring_s=ring_s, native_ms=nat_ms, numpy_ms=np_ms, native_vs_numpy_lsb=lsb)
        del frame, nat, ref
        # the ffmpeg surface through the fake binary
        fake = REPO / "tests" / "fake_ffmpeg.py"
        check(fake.exists(), "[io] tests/fake_ffmpeg.py is missing")
        spec_ = spec_from_file_location("fake_ffmpeg", fake)
        fake_mod = module_from_spec(spec_)
        spec_.loader.exec_module(fake_mod)
        bindir = work / "bin"
        bindir.mkdir()
        for name in ("ffmpeg", "ffprobe"):
            exe = bindir / name
            exe.write_text(f"#!{sys.executable}\n" + fake.read_text().split("\n", 1)[1])
            exe.chmod(0o755)
        old_path = os.environ["PATH"]
        os.environ["PATH"] = f"{bindir}{os.pathsep}{old_path}"
        try:
            check(ffmpeg_available(), "[io] the fake ffmpeg is not on PATH")
            ih, iw, n = 72, 128, 6
            yy, xx = np.mgrid[0:ih, 0:iw].astype(np.float32)
            rng_ = np.random.default_rng(5)
            frames = np.stack([
                np.clip(np.stack([xx / iw, yy / ih, np.full((ih, iw), 0.2 + 0.1 * t)], -1) * 220
                        + rng_.normal(0, 4, (ih, iw, 3)), 0, 255).astype(np.uint8)
                for t in range(n)
            ])
            audio = np.arange(1000, dtype=np.int16)

            def mp4(path, fr):
                with open(path, "wb") as fh:
                    np.savez(fh, frames=fr, fps=25.0, audio=audio)

            clip = work / "io_in.mp4"
            mp4(clip, frames)
            io_argv = ["--model", "RealESRGAN_x4_v3", "--tile-size", "0", "--models-dir", str(models_dir)]

            def restore(src, dst, extra=(), expect_frames=n):
                cfg_ = config_from_args(build_parser().parse_args([str(src), str(dst)] + io_argv + list(extra)))
                r_ = VideoRestorer(cfg_)
                torch.cuda.synchronize()
                _build.reset_launches()
                ok_ = r_.process_video(src, dst, show_progress=False)
                torch.cuda.synchronize()
                counts_ = _build.launches()
                check(ok_, f"[io] process_video {src.name} -> {dst.name} failed")
                want_ = {k: v * expect_frames for k, v in srvgg_call.items()}
                check(counts_ == want_, f"[io] launch counts {counts_} != {want_}")
                return r_

            tap = []
            orig_write = ffmpeg_backend.FFmpegWriter.write_yuv420

            def tapped(self, planar):
                tap.append(np.array(planar))
                orig_write(self, planar)

            ffmpeg_backend.FFmpegWriter.write_yuv420 = tapped
            try:
                out = work / "io_out.mp4"
                r = restore(clip, out)
            finally:
                ffmpeg_backend.FFmpegWriter.write_yuv420 = orig_write
            check(list(r._upscalers) == [(ih, iw, True)], f"[io] buckets {list(r._upscalers)}")
            with open_reader(clip) as rd:
                decoded = list(rd)
            check(np.array_equal(np.stack(decoded), frames), "[io] the fake's decode is not exact")
            ups = Upscaler(r.model, r._upscalers[(ih, iw, True)].grid, r.config, dev, yuv420_out=True)
            step_planes = [ups.process_batch(f[None])[0].cpu().numpy() for f in decoded]
            check(len(tap) == n and all(np.array_equal(a_, b_) for a_, b_ in zip(tap, step_planes)),
                  "[io] the planes on the encoder pipe != the I420 kernel step's")
            d = np.load(out)
            check("audio" in d and np.array_equal(d["audio"], audio), "[io] the audio was not copied")
            check(np.array_equal(d["frames"], np.stack([fake_mod._i420_to_rgb(p_, 4 * iw, 4 * ih) for p_ in step_planes])),
                  "[io] the encoded frames are not the step's planes")
            st_ = r.last_stats
            log(f"[io] mp4 {n} frames {iw}x{ih} -> {4 * iw}x{4 * ih} through the fake ffmpeg: planes on the "
                f"encoder pipe equal the I420 kernel step's, audio copied; wall {1e3 * st_.wall_s / n:.1f} "
                f"ms/frame, launches {json.dumps(_build.launches())}")
            del r, ups
            # segmented resume after a simulated crash
            seg = ["--segment-frames", "2"]
            full = work / "io_full.mp4"
            restore(clip, full, seg)
            part_clip = work / "io_in3.mp4"
            mp4(part_clip, frames[:3])
            partial = work / "io_part.mp4"
            finalize = segmented.SegmentedWriter.finalize
            segmented.SegmentedWriter.finalize = lambda self: None  # the parts survive, as after SIGKILL
            try:
                restore(part_clip, partial, seg, expect_frames=3)
            finally:
                segmented.SegmentedWriter.finalize = finalize
            parts = Path(str(partial) + ".parts")
            (parts / "00002.mp4").write_bytes(b"garbage from a killed encoder")
            r = restore(clip, partial, seg + ["--resume"], expect_frames=n - 3)
            check((r.last_stats.decoded, r.last_stats.encoded) == (n, n), "[io] resume accounting")
            check(not parts.exists(), "[io] the parts survived finalize")
            check(np.array_equal(np.load(full)["frames"], np.load(partial)["frames"]),
                  "[io] the resumed output != the uninterrupted run")
            check("audio" in np.load(partial), "[io] the resumed output has no audio")
            log(f"[io] segmented resume (segments of 2, crash after 3 frames plus a garbage segment): "
                f"{n - 3} frames re-run, the output equals the uninterrupted run")
            del r
            # a batch directory of two resolutions
            bdir, bout = work / "io_batch", work / "io_batch_out"
            bdir.mkdir()
            mp4(bdir / "a.mp4", frames)
            with Y4MWriter(bdir / "b.y4m", 96, 48, 25) as wr:
                for f in frames[:2, :48, :96]:
                    wr.write(f)
            cfg_ = config_from_args(build_parser().parse_args([str(bdir), str(bout), "--batch"] + io_argv))
            r = VideoRestorer(cfg_)
            ok_total = r.process_batch_dir(bdir, bout, show_progress=False)
            check(ok_total == (2, 2), f"[io] batch {ok_total} != (2, 2)")
            names_ = sorted(p_.name for p_ in bout.iterdir())
            check(names_ == ["a_upscaled.mp4", "b_upscaled.y4m"], f"[io] batch outputs {names_}")
            check(sorted(r._upscalers) == [(48, 96, True), (ih, iw, True)], f"[io] batch buckets {sorted(r._upscalers)}")
            log(f"[io] batch directory of two resolutions: (ok, total) {ok_total}, outputs {names_}, "
                "both buckets warmed up front")
            del r
        finally:
            os.environ["PATH"] = old_path
        torch.cuda.empty_cache()
        path_stats["io"] = stats

    if want("io"):
        phase_io()
    if "main_tailq" in path_stats and "main" in path_stats:
        tq = path_stats["main_tailq"]
        log(
            f"[main_tailq] step {tq['step_ms']:.1f} ms/frame with the one-launch tail, "
            f"{tq['default_step_ms']:.1f} with the default three-K1 tail (same run); peak device "
            f"memory {tq['peak_gib']:.2f} GiB, the flagship [main] {path_stats['main']['peak_gib']:.2f}"
        )
    shutil.rmtree(work, ignore_errors=True)

    # phase 12: the RDB micro-benchmark's five modes at its default shape;
    # the static mode runs on its own so that its launches are read apart
    def phase_bench():
        from video_restore_tpu_torch.tools import bench_rdb

        iters = 2
        apps = 1 + (1 + iters) * bench_rdb.REPS  # the check, the warm-up, the timed steps
        rrdb_apps = 1 + (1 + iters) * -(-bench_rdb.REPS // 3)
        check(bench_rdb.MODES[-1] == "int8s", f"bench_rdb modes {bench_rdb.MODES}")
        recs = []
        for modes, expected in (
            (bench_rdb.MODES[:-1],
             {"rdb_fused": 5 * apps, "conv3x3:mma": 5 * apps, "rdb_fused_k5": apps,
              "rdb_fused_k5:mma": apps, "rrdb_fused": rrdb_apps,
              "rrdb_fused:mma": rrdb_apps, "rdb_fused_i8": 5 * apps,
              "conv3x3_i8:mma": 5 * apps, "act_amax": 1}),
            (("int8s",), {"rdb_fused_i8": 5 * apps, "conv3x3_i8:mma": 5 * apps}),
        ):
            _build.reset_launches()
            recs += bench_rdb.bench(modes, bench_rdb.SHAPE, "cuda", iters)
            torch.cuda.synchronize()
            counts = _build.launches()
            check(counts == expected, f"[bench_rdb] launch counts {counts} != expected {expected}")
            log(f"[bench_rdb] {' '.join(modes)}: launches {json.dumps(counts)}")
            if modes == ("int8s",):
                total_launches["rdb_fused_i8 static"] = counts["rdb_fused_i8"]
            else:
                for k, v in counts.items():
                    total_launches[k] = total_launches.get(k, 0) + v
        for r in recs:
            tol = 2e-2 * max(1.0, r["scale"])
            check(r["err"] <= tol, f"[bench_rdb] {r['mode']}: first call {r['err']:.3g} > {tol:.3g}")
        path_stats["bench_rdb"] = {r["mode"]: dict(ms_per_rdb=r["ms_per_rdb"], tflops=r["tflops"],
                                                   err=r["err"]) for r in recs}

    if want("bench"):
        phase_bench()
    path_stats.update(k1=k1_stats, k1n=k1n_stats, k2=k2_stats, k5=k5_stats, k3=k3_stats, k6=k6_stats, k4=k4_stats)
    log(f"[paths] {json.dumps(path_stats)}")
    if only:
        log(f"[partial] ran only {sorted(only)} after the build: no result line")
        return 0

    # ---- result ------------------------------------------------------------
    log(smi)  # the card again, beside the result lines
    kernels = []
    for name in PALLAS:
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=PALLAS[name],
            launches=total_launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            cuda_route=CUDA_ROUTE.get(name, "one kernel"),
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

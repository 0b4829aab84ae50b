#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``video_restore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py [--only NAME[,NAME...]]

``--only`` runs a subset for a quick probe: any of ``k1`` (K1's tensor-core
routes alone: their odd-shape checks and the fma, mma and wgmma kernels side
by side),
``k1n`` (the same for K1's narrow route), ``k2`` (the same for K2's rows
route), ``k5``, ``k3``, ``k6`` and ``k4``
(the same for K5's, K3's, K6's and K4's tensor-core routes), ``kernels``
(all of phase 3), ``paths`` (phases 4-10) or single path tags
(``main``, ``config4``, ``tiled_x4plus``, ``tiled_x4_v3``, ``main_int8``,
``config4_int8``, ``tiled_x4plus_int8``, ``main_pallas``, ``main_tailq``,
``main_postbf16``, ``config3``, ``config2_1080p``, ``main_fp32``,
``main_fp32_fused`` (which runs ``main_fp32`` too), ``config4_fp32``,
``faces``, ``outscale``), ``io`` (phase 11), ``bench`` (phase 12),
``gfpgan`` (phase 13), ``train`` (phase 16), ``multi`` (phase 17). Phases 1
and 2 always run. A partial run prints
neither the per-kernel record nor the final ``{"ok": true, ...}`` line; the
run that counts is the one without arguments.

Phases, each of which stops the run with a non-zero exit when it fails:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from ``video_restore_tpu_torch/csrc`` (K1
   ``conv3x3_wgmma.cu`` (``wgmma`` + TMA), ``conv3x3_bf16x3_wgmma.cu``
   (fp32 on bf16 ``wgmma``: three parts a value, a producer warpgroup that
   splits on load), ``conv3x3_mma.cu`` on
   ``mma_tile.cuh``, ``conv3x3_narrow.cu`` and ``conv3x3.cu``, K2
   ``unsharp_rows.cu`` (fp32) and ``unsharp_rows_bf16.cu`` (bf16), both on
   ``unsharp_rows.cuh``, and ``unsharp.cu``, K3 ``srvgg_up_mma.cu`` on
   ``mma_tile.cuh``, ``srvgg_up_bf16x3.cu`` (fp32: K1 ``bf16x3``'s producer
   warpgroup at N 48 and 16 with K-major weights) and
   ``srvgg_up.cu``, K4 ``conv3x3_i8_wgmma.cu`` (``wgmma`` + TMA, a
   quantiser warpgroup, on ``wgmma_tile.cuh`` and ``i8_quant.cuh``),
   ``conv3x3_i8_mma.cu`` on ``mma_tile.cuh`` and ``i8_quant.cuh`` and
   ``conv3x3_i8.cu`` with its amax entry point, K5 ``rdb_fused_wgmma.cu``
   (``wgmma`` + TMA over rolling row rings, on ``wgmma_tile.cuh`` with K1's
   wgmma source), ``rdb_fused_mma.cu`` on ``mma_tile.cuh`` and
   ``rdb_fused.cu`` (its fp32-FMA instances in ``rdb_fused_f32.cu``,
   ``rdb_fused_bf16.cu`` and ``rdb_fused_narrow.cu`` on ``rdb_fused.cuh``),
   each with its one-RDB and whole-RRDB entry points, and its fp32 route
   ``rdb_fused_bf16x3.cu`` (K1 ``bf16x3``'s conv as the phases of one
   cooperative launch), the one-launch tail ``tail_fused_wgmma.cu``
   (``wgmma`` + TMA over rolling rows, on ``wgmma_tile.cuh``), its fp32
   route ``tail_fused_bf16x3.cu`` and K6 ``tail_fused_mma.cu`` on
   ``mma_tile.cuh`` and ``tail_fused.cu``), and
   print each source's compile seconds (one ``nvcc`` each, all in
   parallel: the slowest sets the build's time) and each kernel's
   registers, shared memory and spills from ``ptxas``;
3. K1's tensor-core route (``conv3x3:wgmma``) first: every single conv at
   odd shapes in bf16 (ragged 2x37x53, a frame smaller than one tile, each
   activation, the residuals, the growth-buffer slices with cin 64..192, x
   with 1-4 blocks of a tail at three shapes, ``upsample2`` at 64 -> 64, 64
   -> 32 and 192 -> 64) within one bf16 step of its plain version per value
   and of a float64 conv of the same inputs, each also within one step of
   the forced ``mma`` route (the ``upsample2`` ones, read through its
   nearest-2x producer, ``torch.equal`` to it), each launch counted under
   its route, neither kernel writing outside a growth buffer's slice; up1
   at 1x1080x1920 on ``wgmma``, ``torch.equal`` to forced ``mma`` and timed
   beside it and ``F.conv2d``; then each conv of a 1080p RDB as the wgmma route runs it
   (c1 .. c4 in blocks) with its TFLOP/s and share of its own bound, the
   RDB on the fma, mma (both forced) and wgmma routes and cuDNN's chain side
   by side (mma at least 3x fma), and conv_body beside ``F.conv2d``. K1's
   fp32 route (``conv3x3:bf16x3``): the same single convs in fp32 at odd
   shapes (B = 2 ragged, below one tile, two tile columns, every act, r1,
   r1 + r2, ``upsample2``, cin 48, weights written in place between calls,
   growth-buffer prefixes and ``out`` slices) and a whole fp32 RDB with and without x0,
   each within ``compare``'s fp32 bound (1e-4 x scale) of plain and of the
   forced ``fma`` route, neither writing outside a slice; the 1080p fp32
   RDB per conv (share of six bf16 products a MAC at 989 TFLOP/s) and whole
   on ``bf16x3``, forced ``fma`` and cuDNN's fp32 chain (TF32 off),
   ``bf16x3`` at most half of ``fma``'s time; then ``[kernel32]``: conv_body,
   an SRVGG conv, up1, upconv2 and conv_hr on ``bf16x3``, the fp32 stem
   and conv_last on ``narrow`` (each ``torch.equal`` to forced ``fma``), K3
   on ``srvgg_up_bf16x3.cu``, K5's RRDB on
   ``rdb_fused_bf16x3.cu`` (``VRT_PALLAS=1``) and the tail on
   ``tail_fused_bf16x3.cu`` (``VRT_TAIL_Q=1``) at the paths' shapes, each
   against plain with its plain, cuDNN fp32 and bound times (the
   ``bf16x3`` ones, the stem and conv_last also against forced ``fma``;
   K5's, the tail's, K3's and the stem's at most half of its time, K3, the
   stem and conv_last under the library call). K1's narrow
   route (``conv3x3:narrow``): the stems in bf16 and fp32 (cin 3 and 12 -> 64, act none,
   PReLU and lrelu, odd shapes, a frame of one pixel, a strided cin-3 view,
   the flagship frame and the tile batch) and ``conv_last`` in bf16 and
   fp32 (64 -> 3, odd shapes, a prefix view of a wider buffer, the
   flagship's 1x4320x7680x64 and the tile batch's 6x1504x1792x64), each
   ``torch.equal`` to the forced ``fma`` route and within ``compare``'s
   bound of plain, each launch counted under its kernel; then the old
   kernel, the new one and ``F.conv2d`` side by side at both flagship
   shapes and at the fp32 conv_last's, the new one at least 3x the old. K2's rows route (``unsharp_fused:rows``) in fp32: odd
   shapes (B = 2 at W*C % 4 != 0, frames smaller than the halo, 4 rows over
   9 strips, a 2x1037x1283 frame whose runs cross strips and frames, an x
   4 bytes off a 16-byte boundary), radius 0, 1, 4 and 16, thresholds 0 and
   0.02, an x four values off, W*C % 8 == 4, and the flagship's
   1x4320x7680x3, each ``torch.equal`` to the
   forced ``tile`` route and within ``compare``'s bound of plain; then the
   old kernel, the new one, the plain version and ``dst.copy_(src)`` of the
   8K frame side by side, the new one at least 3x the old. The same cases
   on K2's bf16 instances (``unsharp_fused:rows:bf16``): ``rows`` equal to
   ``tile`` bit for bit, each within one bf16 step of
   ``unsharp_fused_plain``, and the 8K frame timed the same way; each
   instance's registers and blocks per SM, both terms of its bound (bytes,
   and fp32 instructions at one a lane a clock), and the bf16 time against
   the bf16 instance's time before its redesign. K5's
   Hopper route (``rdb_fused_k5:wgmma``, ``rrdb_fused:wgmma``) the same
   way: one RDB (with and without ``x0``) and a whole RRDB in bf16 at nf 64
   / gc 32 at odd shapes (a frame smaller than one stripe, one tile of the
   old kernel, ragged extents with B = 2, a ragged last stripe, more
   segments than the persistent grid has blocks), at 1080p and at
   ``bench_rdb``'s 4x384x504, each within ``compare``'s bf16 tolerance of
   the plain version and bit-equal to the forced ``mma`` route and to K1's
   five-launch chain (``stripe.rdb_fused``, three of them and the residual
   for the RRDB), the forced ``fma`` route (``rdb_fused_bf16.cu``) held to
   the plain version the same way at a ragged shape and at 1080p, then
   ``wgmma``, ``mma``, ``fma`` (forced), the cuDNN
   chain and K1's chain side by side on one 1080p RDB and RRDB, with
   executed over useful work and TFLOP/s; the 1080p RDB on ``wgmma`` must
   take at most half of ``mma``'s time in the same run. K5's fp32 route
   (``rdb_fused_k5:bf16x3``, ``rrdb_fused:bf16x3``, ``[k5] fp32``): one RDB
   (with and without ``x0``) and a whole RRDB at odd shapes (below one
   tile, B = 2 ragged, a second tile column, more tiles than blocks) and at
   1080p, each ``torch.equal`` to K1 ``bf16x3``'s five-launch chain (three
   and the residual) and within ``compare``'s fp32 bound of plain; the
   1080p RDB and RRDB timed in turns beside the chain, forced ``fma``,
   cuDNN's fp32 chain (TF32 off) and plain: the RRDB at most half of
   ``fma``'s time and at most 1.05x the chain's. K3's tensor-core route (``srvgg_up_fused:mma``) at r 2 and
   r 4 at odd shapes, the config-4 frame and the tile batch, within one
   bf16 step per value of the plain version, old and new side by side; its
   fp32 route (``srvgg_up_fused:bf16x3``) at r 2 and 4 at odd shapes, the
   config-4 frame and the tile batch, within ``compare``'s fp32 bound of
   plain, its error against forced ``fma`` printed. The
   one-launch tail on Hopper (``tail_fused:wgmma`` and
   ``tail_fused_q:wgmma``, ``tail_fused_wgmma.cu``) in bf16 at nf 64 at odd
   shapes (B = 2 and 3, ragged extents, a frame narrower than one stripe, a
   last stripe of 2 columns, more stripes' rows than the persistent grid
   has blocks) and at the flagship's 1x2160x3840x64: each wrapper launches
   it once, and it is ``torch.equal`` to the three-launch chain
   (``tail_fused(route="chain")``: 3 K1 launches) and to K6's ``mma``
   kernel (forced), within ``compare``'s bf16 bound of the plain version;
   at the flagship shape it, K6's ``mma`` and ``fma`` kernels, the chain,
   each of the chain's convs (upconv2 on ``wgmma`` and on forced ``mma``,
   conv_hr, conv_last) and the cuDNN chain of 3 side by side, with
   executed over useful work; the new kernel faster than the chain and at
   least 3x the fma kernel. The fp32 one-launch tail
   (``tail_fused_q:bf16x3``, ``[k6] fp32``) at the same odd shapes and the
   flagship's 1x2160x3840x64: ``torch.equal`` to the fp32 three-launch
   chain (the default fp32 ``tail_fused``: upconv2 and conv_hr on K1
   ``bf16x3``, conv_last on ``narrow``), within ``compare``'s fp32 bound of
   plain; at the flagship shape it, the chain, forced K6 ``fma``, cuDNN's
   fp32 chain and plain in turns, each one's device memory: at most half
   of ``fma``'s time. K4's Hopper route (``conv3x3_i8:wgmma``),
   dynamic and static A8: each of the five RDB convs (growth-buffer prefix
   views, pixel stride 192, and x with the blocks of a c1 .. c4 tail) and an
   SRVGG PReLU conv at odd shapes (B = 2 ragged, below one tile, one pixel
   past a tile column, more tiles than the card has SMs) and at
   6x376x448 and 1x1080x1920, the quantiser on all 65280 finite bf16 values
   through a centre-tap identity at 38 scales, and the whole int8 RDB at
   1x1080x1920x64 and 6x376x448x64, each ``torch.equal`` to the forced
   ``mma`` and ``dp4a`` routes (``dp4a`` not at the paths' per-conv
   shapes) and to the plain version with equal output amax; then wgmma
   beside mma per conv, per RDB (dynamic and static, with dp4a, K1's bf16
   RDB and the bf16 cuDNN chain) and for the SRVGG int8 body, each beside
   the bound of its launches' bytes and operations (wgmma faster than mma
   at the 1080p RDB and the SRVGG body, and at least 3x dp4a). Then
   every kernel wrapper against its plain PyTorch version on the card, in
   fp32 (tight) and bf16 (the working type), at odd shapes and at the
   shapes of the main paths (the flagship frame, the config-4 frame and
   phase 7's tile batch), with kernel (the least of three timing windows,
   each printed with its host time a call), plain and library times (one cuDNN
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
   its per-frame count times 3, K1 348 times per frame of which 347 on the
   ``wgmma`` route (up1 included) and 1 on ``narrow`` (the stem), none on
   ``mma`` or ``fma``, the tail once on ``tail_fused:wgmma`` (upconv2,
   conv_hr and conv_last in one launch), and K2 once on ``rows``; the
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
5. the same frames through the kernel path (RGB and I420 out) and the first
   through the plain path on the card: the RGB kernel path's first frame >=
   45 dB PSNR on u8 against the plain one, and the CLI's planes equal to the
   I420 kernel path's byte for byte;
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
   ``conv3x3_i8:wgmma`` per flagship frame, 32 per config-4 frame, no
   ``mma`` or ``dp4a``), and the int8 output against the bf16 kernel path's (>= 35 dB
   on u8 per frame);
9. ``[main_pallas]``: the flagship flags with ``VRT_PALLAS=1`` (one K5
   launch per RRDB block on the ``wgmma`` route, 23 ``rrdb_fused:wgmma``
   per frame, and no five-K1 RDB), 2 frames, with
   the checks of phases 4 and 5, and the output against the default body's
   kernel path (>= 45 dB on u8 per frame: one function, summed in another
   order);
10. ``[main_tailq]``: the flagship flags with ``VRT_TAIL_Q=1`` (one launch
    of ``tail_fused_q`` per frame, on the ``wgmma`` route, the kernel the
    default tail launches; its frames are expected to equal the default
    tail's: inf dB), 2 frames,
    with the
    checks of phases 4 and 5, and the output against the default tail's
    kernel path (>= 45 dB on u8 per frame: one function, two kernel
    routes); the step's ms/frame and the path's peak memory are printed
    beside the default tail's;
10b. ``[main_postbf16]``: the flagship flags with ``VRT_POST_DT=bf16``
    (the post stack in bf16 after the full-frame model: K2's bf16 instance,
    ``unsharp_fused:rows:bf16`` once per frame), 2 frames, with the checks
    of phases 4 and 5, and the output against the default fp32 post
    stack's kernel path (>= 45 dB on u8 per frame; JAX holds the pair
    within 2 levels); the step's ms/frame and the peak memory printed
    beside ``[main]``'s;
10c. ``[config3]``: ``BASELINE.json`` config 3, ``--enhanced --quality
    max`` with the CLI's default model (RealESRGAN_x4plus; the preset's
    tiles 512 / overlap 64, ``full_frame`` "auto", which takes full frame
    where the card's memory allows: the line says which), 2 frames of
    720x1280, with the checks of phases 4 and 5;
10d. ``[config2_1080p]``: ``BASELINE.json`` config 2 at its own 1080p,
    RealESRGAN_x4plus through ``--tile-size 512 --tile-overlap 32``
    (seamless, 12 tiles), 2 frames, with the checks of phases 4 and 5;
10e. ``[main_fp32]`` and ``[config4_fp32]``: the flagship flags and config
    4 at ``--precision fp32``, 2 frames each, with the checks of phases 4
    and 5 at 60 dB (K1 by route: 349 ``conv3x3:bf16x3``, the stem once on
    ``conv3x3:narrow stem`` and conv_last once on ``conv3x3:narrow
    conv_last:fp32``, no ``conv3x3:fma``, per flagship frame, the tail as
    three K1 launches; 32 ``bf16x3`` and the narrow stem
    per config-4 frame and K3 once on ``srvgg_up_fused:bf16x3``),
    the peak memory beside ``auto_full_frame``'s estimate at 4 bytes a
    feature value, and the bf16 kernel path's frames beside them (>= 35
    dB);
10f. ``[main_fp32_fused]``: the flagship flags at ``--precision fp32``
    with ``VRT_PALLAS=1`` and ``VRT_TAIL_Q=1``, 2 frames: 23
    ``rrdb_fused:bf16x3``, 2 ``conv3x3:bf16x3`` (conv_body, up1), the stem
    on ``conv3x3:narrow stem`` and 1 ``tail_fused_q:bf16x3`` a frame, its
    frames byte-equal to ``[main_fp32]``'s (which stand in for a plain
    run), its step and peak memory printed beside them;
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
    4's launch counts; wall, step and resize ms per frame;
16. ``train``: fine-tuning on the card through ``finetune.main`` (20
    steps, batch 8, patch 128, a 6-frame 360x640 clip of
    ``synth_source_clip``) for RealESRGAN_x4plus_anime_6B (nf 64, gc 32, 6
    RRDBs, seeded random weights) and RealESRGAN_x4_v3 (nf 64, 32 convs,
    config 4's weights): no kernel launched while training (the
    differentiable forwards are fp32 ``F.conv2d``, as JAX trains through
    XLA convs), every loss finite, the ``.npz`` read back through
    ``get_model`` equal to the trained weights and served through
    ``VideoRestorer`` on 2 frames with the checks of phases 4 and 5; the same
    3 Adam steps on the card and on the CPU from the same weights and
    batches (indices and noise drawn on the CPU), TF32 off: losses within
    1e-4 relative, step-1 gradients within 1e-3 of each leaf's largest,
    weights within Adam's 2 x 3 x lr; ms per step in fp32 and TF32 beside
    the step's FLOPs (``FlopCounterMode``) and bounds, and the peak memory;
    3 fp32 steps under ``device_trace``: the device's busy share and the
    kernels that take its time.
    Then ``--profile``: config 4 on 2 frames of 1080x1920 with ``--profile
    DIR`` (RGB out): the trace written, naming K1's ``conv3x3_wgmma_kernel``,
    and the device's busy share of the traced window;
17. ``multi``: several devices and processes on the one card. (a) config
    4's program over ``frame_mesh(devices=[cuda:0] * 2)`` on 4 frames of
    1080x1920 (two batches of D = 2, a hard cut before the third): the two
    dispatch threads' planes against one ``restore_step(n_shards=2)`` call
    per batch on the card (byte-equal, or >= 45 dB), the launch counts
    against D = 1's, a static clip against D = 1 (within 1 level; the stale
    carry cannot matter there), ms/frame and peak memory of both; then the
    face pass (x4_v3 + the GFPGAN prior, 4 frames of 720x1280 with faces,
    cuDNN TF32 at PyTorch's default) over ``[cuda:0] * 2`` byte-equal to one
    device, the TF32 flags back at the defaults after; (b) config 1
    (RealESRGAN_x2plus, ``--quality fast --tile-size 256``, seeded
    weights), 2 frames of 720x1280 with ``--shard-mode tiles`` on
    ``[cuda:0] * 2``: byte-equal to the frames mode on one device, the
    kernel path >= 45 dB against plain on one frame, the cin-12 stem on the
    narrow route; (c) ``--batch --multihost``: two CLI processes on the card
    (gloo, ``WORLD_SIZE=2``, ``RANK=0/1``) on 4 clips of 72x128 through
    config 4's model, each taking 2 and both reporting 4/4, the outputs
    byte-equal to a one-process batch run, both walls; (d) the sharded train
    step (``tools/train_sharded.py``) for RealESRGAN_x4_v3 at batch 8, patch
    128, 3 Adam steps at lr 1e-4, (dp, tp) = (2, 1), (1, 2) and (2, 2) as 2
    or 4 gloo ranks sharing the card, against the one-device step: the
    losses of steps 1-2 within 1e-5 relative and step 3's within 3x the
    one-device step's own run-to-run gap, step-1 gradients within 1e-4 of
    each leaf's largest, Adam's moments after step 1 within 1e-4 (2e-4 for
    the squares), weights within 2 x 3 x lr, ms per step of each; (e)
    interpreter exit with live dispatch threads (``tools/exit_check.py``):
    4 processes at once, each keeping a frames-mode upscaler over
    ``[cuda:0] * 2`` alive to exit, each exiting 0 with no dispatch thread
    alive after the ``atexit`` finalizers. Every child process has its own
    timeout.

The card's ``nvidia-smi`` line is printed first and again just before the
per-kernel JSON record, which is the line before the last (``launches`` sums
the counts of the CLI runs of phases 4, 6-10e, 14-17 and of phase 12, the
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
import math
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
# fp32 instructions that are no FMA (K2 rounds each product and each sum):
# one a lane a clock, half the FLOP rate that counts an FMA as two
PEAK_FP32_UNFUSED = PEAK_FP32 / 2
# K2's bf16 rows instance at 1x4320x7680x3, r = 4, before its H100
# redesign (8 values a thread, one block an SM; NVIDIA H100 80GB HBM3, 700 W)
K2_BF16_BEFORE_MS = (0.482, 0.490)
# the launch counts of one fp32 conv_last on K1's narrow route
LAST32 = {"conv3x3:narrow": 1, "conv3x3:narrow conv_last": 1,
          "conv3x3:narrow conv_last:fp32": 1}
# K1 bf16x3: most error of an fp32 sum over cin channels, as a share of the
# sum's largest value against float64, per input channel (read on an H100 at
# 6.9e-8 - 7.4e-8 x cin for cin 16, 64 and 192; cuDNN fp32 0.9e-8 - 2.8e-8 x cin)
SUM_REL_PER_CIN = 1.5e-7


def k2_ops(numel, radius):
    """K2's fp32 instructions a call: per value 2r + 1 products and 2r sums
    in each pass, and the epilogue's 5 (difference, product, sum, clip)."""
    n = 2 * radius + 1
    return numel * (2 * (2 * n - 1) + 5)


PALLAS = {
    "conv3x3_fused": "video_restore_tpu/ops/pallas_tail.py:767",
    "rdb_fused": "video_restore_tpu/ops/pallas_stripe.py:1963",
    "up1_fused": "video_restore_tpu/ops/pallas_tail.py:603",
    # the default tail, #6 tail_fused_raw (and #7 tail_fused, :425), in one
    # launch of the same kernel as #13
    "tail_fused": "video_restore_tpu/ops/pallas_tail.py:266",
    "unsharp_fused": "video_restore_tpu/ops/pallas_post.py:131",
    # K2's bf16 instance on the rows route: unsharp_fused on the bf16 frames
    # of VRT_POST_DT=bf16 (pallas_post.py:175, out_shape x.dtype)
    "unsharp_fused:rows:bf16": "video_restore_tpu/ops/pallas_post.py:131",
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
    # #13 tail_fused_q (VRT_TAIL_Q=1), the tail in one launch
    "tail_fused_q": "video_restore_tpu/ops/pallas_tail.py:1018",
    # K4, static A8: the sa_static branch of _conv_prefix (_quant_act_static),
    # the sas arguments of #2 and #3; its launches count under rdb_fused_i8
    "rdb_fused_i8 static": "video_restore_tpu/ops/pallas_stripe.py:293",
    # K1's Hopper route, timed on conv_body + residual: the dense-block convs
    # of #2-#4, #9, #10, conv_body (#1), up1 (#5, through its nearest-2x
    # producer) and the SRVGG body (#14-#16). conv_last (#6, #7) has no row
    # of its own since the tail is one launch: K1's narrow conv_last kernel
    # runs only in the forced chain of the checks
    "conv3x3:wgmma": "video_restore_tpu/ops/pallas_stripe.py:1963",
    # K1's fp32 route at --precision fp32, timed on the 1080p RDB: the same
    # Pallas convs as conv3x3:wgmma (#1-#5, #9, #10, #14-#16, the chain
    # tail's upconv2 and conv_hr)
    "conv3x3:bf16x3": "video_restore_tpu/ops/pallas_stripe.py:1963",
    # K5's fp32 route: #19 rrdb_fused (VRT_PALLAS=1 at --precision fp32), and
    # #11 rrdb_stripe_padded (pallas_stripe.py:1016)
    "rrdb_fused:bf16x3": "video_restore_tpu/ops/pallas_rdb.py:257",
    # the fp32 one-launch tail: #13 tail_fused_q (VRT_TAIL_Q=1 at --precision
    # fp32)
    "tail_fused_q:bf16x3": "video_restore_tpu/ops/pallas_tail.py:1018",
    # K1's fp32 stem on the narrow route: #1 conv3x3_fused in its stem form
    # at --precision fp32
    "conv3x3:narrow stem:fp32": "video_restore_tpu/ops/pallas_tail.py:767",
    # K1's fp32 conv_last on the narrow route: the conv_last stage of #6
    # tail_fused_raw (pallas_tail.py:209-212), and #7 tail_fused (:425), in
    # the fp32 chain tail
    "conv3x3:narrow conv_last:fp32": "video_restore_tpu/ops/pallas_tail.py:266",
    # K3 at --precision fp32: #17 srvgg_up_fused_raw, and #18 srvgg_up_fused
    # (pallas_srvgg.py:854)
    "srvgg_up_fused:bf16x3": "video_restore_tpu/ops/pallas_srvgg.py:1025",
}
# the hand-written kernel behind each row where a wrapper has two
# (ops/tail.py::conv3x3_route, ops/rdb.py::rdb_route,
# ops/srvgg.py::srvgg_up_route, ops/tail.py::tail_fused_route,
# ops/quant.py::conv3x3_i8_route, ops/unsharp.py::unsharp_route), as the
# row's calls take it
CUDA_ROUTE = {
    "conv3x3_fused": "narrow", "rdb_fused": "wgmma", "up1_fused": "wgmma",
    "tail_fused": "wgmma", "srvgg_body": "wgmma", "srvgg_up_fused": "mma",
    "rdb_fused_k5": "wgmma", "rrdb_fused": "wgmma", "conv3x3:wgmma": "wgmma",
    "tail_fused_q": "wgmma", "rdb_fused_i8": "wgmma", "srvgg_body_i8": "wgmma",
    "rdb_fused_i8 static": "wgmma", "conv3x3:bf16x3": "bf16x3", "rrdb_fused:bf16x3": "bf16x3",
    "tail_fused_q:bf16x3": "bf16x3", "conv3x3:narrow stem:fp32": "narrow",
    "conv3x3:narrow conv_last:fp32": "narrow",
    "srvgg_up_fused:bf16x3": "bf16x3",
    "unsharp_fused": "rows", "unsharp_fused:rows:bf16": "rows",
}
SOURCE = {
    # K1 is four routes (ops/tail.py::conv3x3_route). This row times the
    # stem (cin 3), on the narrow route; conv_body is conv3x3:wgmma's
    "conv3x3_fused": "video_restore_tpu_torch/csrc/conv3x3_narrow.cu",
    "rdb_fused": "video_restore_tpu_torch/csrc/conv3x3_wgmma.cu",
    "up1_fused": "video_restore_tpu_torch/csrc/conv3x3_wgmma.cu",
    # the tail in one launch (ops/tail.py::tail_fused_route), #6, #7 and #13
    "tail_fused": "video_restore_tpu_torch/csrc/tail_fused_wgmma.cu",
    # K2 is two kernels (ops/unsharp.py::unsharp_route); the paths' frames
    # (fp32, C = 3) take the rows one
    "unsharp_fused": "video_restore_tpu_torch/csrc/unsharp_rows.cu",
    "unsharp_fused:rows:bf16": "video_restore_tpu_torch/csrc/unsharp_rows_bf16.cu",
    "srvgg_body": "video_restore_tpu_torch/csrc/conv3x3_wgmma.cu",
    "srvgg_up_fused": "video_restore_tpu_torch/csrc/srvgg_up_mma.cu",
    # K4 is three kernels (ops/quant.py::conv3x3_i8_route); these rows' convs
    # (nf 64 / gc 32) take the Hopper one
    "rdb_fused_i8": "video_restore_tpu_torch/csrc/conv3x3_i8_wgmma.cu",
    "srvgg_body_i8": "video_restore_tpu_torch/csrc/conv3x3_i8_wgmma.cu",
    "act_amax": "video_restore_tpu_torch/csrc/conv3x3_i8.cu",
    # K5 is three kernels (ops/rdb.py::rdb_route); bf16 at (64, 32) takes
    # the Hopper one
    "rdb_fused_k5": "video_restore_tpu_torch/csrc/rdb_fused_wgmma.cu",
    "rrdb_fused": "video_restore_tpu_torch/csrc/rdb_fused_wgmma.cu",
    "tail_fused_q": "video_restore_tpu_torch/csrc/tail_fused_wgmma.cu",
    "rdb_fused_i8 static": "video_restore_tpu_torch/csrc/conv3x3_i8_wgmma.cu",
    "conv3x3:wgmma": "video_restore_tpu_torch/csrc/conv3x3_wgmma.cu",
    "conv3x3:bf16x3": "video_restore_tpu_torch/csrc/conv3x3_bf16x3_wgmma.cu",
    # K5 and the one-launch tail at --precision fp32 (ops/rdb.py::rdb_route,
    # ops/tail.py::tail_fused_route: fp32 at nf 64)
    "rrdb_fused:bf16x3": "video_restore_tpu_torch/csrc/rdb_fused_bf16x3.cu",
    "tail_fused_q:bf16x3": "video_restore_tpu_torch/csrc/tail_fused_bf16x3.cu",
    # the fp32 stem (ops/tail.py::conv3x3_route) and K3 at fp32
    # (ops/srvgg.py::srvgg_up_route)
    "conv3x3:narrow stem:fp32": "video_restore_tpu_torch/csrc/conv3x3_narrow.cu",
    "srvgg_up_fused:bf16x3": "video_restore_tpu_torch/csrc/srvgg_up_bf16x3.cu",
    # the fp32 conv_last (ops/tail.py::conv3x3_route), TMA-fed
    "conv3x3:narrow conv_last:fp32": "video_restore_tpu_torch/csrc/conv3x3_narrow.cu",
}
PATH_TAGS = (
    "main", "config4", "tiled_x4plus", "tiled_x4_v3", "main_int8",
    "config4_int8", "tiled_x4plus_int8", "main_pallas", "main_tailq",
    "main_postbf16", "config3", "config2_1080p", "main_fp32", "main_fp32_fused", "config4_fp32",
)
# the paths after the face prior's phase: the face pass and the outscale resize
POST_TAGS = ("faces", "outscale")
PHASES = ("k1", "k1n", "k2", "k5", "k3", "k6", "k4", "kernels", "paths", "bench", "io", "gfpgan",
          "train", "multi") + PATH_TAGS + POST_TAGS


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
    new_sources = {"conv3x3_wgmma.cu": "k1", "conv3x3_bf16x3_wgmma.cu": "k1",
                   "rdb_fused_wgmma.cu": "k5", "srvgg_up_mma.cu": "k3",
                   "tail_fused_mma.cu": "k6", "tail_fused_wgmma.cu": "k6",
                   "conv3x3_i8_mma.cu": "k4", "conv3x3_i8_wgmma.cu": "k4",
                   "conv3x3_narrow.cu": "k1n", "unsharp_rows.cu": "k2",
                   "unsharp_rows_bf16.cu": "k2", "rdb_fused_bf16x3.cu": "k5",
                   "tail_fused_bf16x3.cu": "k6", "srvgg_up_bf16x3.cu": "k3"}
    build_log = (_build.BUILD_DIR / "build.log").read_text()
    for line in build_log.splitlines():
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
    log("[build] nvcc seconds by source, slowest first: " + ", ".join(
        f"{n} {t:.1f}" for n, t in sorted(_build.compile_seconds(build_log).items(),
                                          key=lambda kv: -kv[1])))

    # ---- phase 3: kernels against their plain versions -------------------
    gen = torch.Generator().manual_seed(0)

    big_draws = [0]

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        """Seeded values in [-scale, scale): from the CPU generator, or, for
        the tensors of 2^27 values and more (whole 8K frames, the timing
        inputs), on the card from a generator seeded by their order (a CPU
        draw of an 8K 64-channel frame takes seconds)."""
        if math.prod(shape) >= 1 << 27:
            big_draws[0] += 1
            g_ = torch.Generator(dev).manual_seed(1000 + big_draws[0])
            t = torch.rand(*shape, generator=g_, device=dev)
            return t.mul_(2).sub_(1).mul_(scale).to(dt)
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

    phase_secs = {}  # each phase's wall seconds, for the [time] line

    @contextlib.contextmanager
    def clock(name):
        """Time a phase (host clock, the card synchronised at both ends)."""
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            phase_secs[name] = phase_secs.get(name, 0.0) + time.perf_counter() - t_

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

    @contextlib.contextmanager
    def forced(route):
        """Every K1 call of the block on ``route`` where that kernel takes
        it: ``"fma"`` all, ``"mma"`` those of ``"wgmma"``."""
        own = tail.conv3x3_route

        def pick(*a, **k):
            r = own(*a, **k)
            return route if route == "fma" or r == "wgmma" else r
        tail.conv3x3_route = pick
        try:
            yield
        finally:
            tail.conv3x3_route = own

    def phase_k1():
        """K1's tensor-core routes: single convs at odd shapes, bf16, each on
        the ``wgmma`` route (upsample2 through its nearest-2x producer) held
        per value to its plain version, to a float64 conv and to the forced
        ``mma`` route (the upsample2 ones bit for bit); up1 at 1080p on both
        routes, bit-equal, timed beside ``F.conv2d``; then one 1080p RDB on
        the fma, mma and wgmma routes beside cuDNN's chain, and conv_body
        beside ``F.conv2d``."""
        def one(tag, x, wt, bias, f64=False, mma_x=None, mma_out=None, **kw):
            """One conv on its route against plain (and float64), and a wgmma
            one against the forced mma route (``mma_x``, ``mma_out``: the
            views of another buffer to run it on, where x and out are
            views). Steps are taken at no less than 2^-8 of the output's
            largest value: the two sides add ~600-1700 fp32 products in
            different orders, so a value that cancels below that keeps an
            absolute error of the terms' rounding (~1e-6 here), which is
            many steps of a tiny value and no sign of a wrong fragment (that
            would be O(1))."""
            route = "wgmma"
            pk = {k_: (v.clone() if k_ == "out" else v) for k_, v in kw.items()}
            _build.reset_launches()
            k = tail.conv3x3(x, wt, bias, counter="check", **kw)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == {"check": 1, f"conv3x3:{route}": 1},
                  f"{tag}: launches {got}, expected one on the {route} route")
            p = tail.conv3x3_plain(x, wt, bias, **pk)
            floor = p.float().abs().max().item() * 2.0**-8
            extra = 0.0
            if kw.get("r2") is not None:
                # two roundings: the inner sum T(r1 + s1 v) goes to bf16
                # before r2, so a flipped inner step reaches the output as s2
                # x a step of the inner value, on top of the output's own
                inner = tail.conv3x3_plain(
                    x, wt, bias,
                    **{k_: v for k_, v in pk.items() if k_ not in ("r2", "s2", "out")}
                ).float().abs()
                inner = (inner * (1 + 2.0**-7)).clamp_min(inner.max().item() * 2.0**-8)
                extra = kw["s2"] * bf16_step(inner)
            e, st = bf16_steps(tag, k, p, floor=floor, extra=extra)
            msg = f"[k1] {tag} {route} err={e:.3g} steps={st:.2f}"
            if route == "wgmma":
                mk = {k_: v for k_, v in kw.items() if k_ != "x_tail"}
                mk["out"] = mma_out  # None: a fresh tensor
                km = tail.conv3x3(x if mma_x is None else mma_x, wt, bias, counter="check",
                                  route="mma", **mk)
                em, stm = bf16_steps(tag + " vs mma", k, km, floor=floor, extra=extra)
                msg += f" vs_mma_err={em:.3g} vs_mma_steps={stm:.2f}"
                if kw.get("upsample2"):  # the nearest-2x producer: mma's sums, mma's bits
                    check(torch.equal(k, km), f"{tag}: wgmma is not bit-equal to mma")
                    msg += " bit_equal_to_mma=True"
            if f64:
                xi = x.repeat_interleave(2, 1).repeat_interleave(2, 2) if kw.get("upsample2") else x
                if kw.get("x_tail") is not None:
                    xi = torch.cat([xi, *kw["x_tail"].unbind(0)], dim=-1)
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
            one(f"{shp} 64->32 upsample2 lrelu", x, rnd(3, 3, 64, 32, scale=0.05), bias[:32].clone(),
                act="lrelu", upsample2=True)
            # six stages: the weights stream beside the producer's windows
            one(f"{shp} 192->64 upsample2 lrelu", rnd(*shp, 192), rnd(3, 3, 192, 64, scale=0.03),
                bias, act="lrelu", upsample2=True)
            one(f"{shp} 64->32 none", x, rnd(3, 3, 64, 32, scale=0.05), bias[:32].clone(), f64=True)
            # cin 48: the last 32-channel stage half past cin (TMA's zero fill)
            one(f"{shp} 48->32 lrelu", x[..., :48], rnd(3, 3, 48, 32, scale=0.05),
                bias[:32].clone(), f64=True, act="lrelu")
        # the growth-buffer case: conv k reads the prefix of a 192-channel
        # buffer and writes its 32 channels at their offset in the same
        # buffer, on both routes, neither writing outside its slice
        grow = rnd(b, h, w, 192)
        rest = torch.ones(192, dtype=torch.bool, device=dev)
        for cin in (64, 96, 128, 160):
            wt, bias = rnd(3, 3, cin, 32, scale=0.03), rnd(32, scale=0.05)
            gk, gm = grow.clone(), grow.clone()
            one(f"growth buffer {cin}->32 into [{cin}:{cin + 32}]", gk[..., :cin], wt, bias,
                f64=True, act="lrelu", out=gk[..., cin : cin + 32], mma_x=gm[..., :cin],
                mma_out=gm[..., cin : cin + 32])
            rest[:] = True
            rest[cin : cin + 32] = False
            for route, g_ in (("wgmma", gk), ("mma", gm)):
                check(torch.equal(g_[..., rest], grow[..., rest]),
                      f"growth buffer {cin}->32: the {route} kernel wrote outside its channel slice")
        wt, bias = rnd(3, 3, 192, 64, scale=0.03), rnd(64, scale=0.05)
        one("growth buffer 192->64 r1", grow, wt, bias, r1=grow[..., :64], s1=0.2)
        one("growth buffer 192->64 r1+r2", grow, wt, bias, r1=grow[..., :64], s1=0.2,
            r2=rnd(b, h, w, 64), s2=0.2)
        # the RDB's layout on the wgmma route: x, then c1 .. c4 as blocks of a
        # tail; conv k reads x and the blocks before it (mma: the same
        # channels as one concatenated prefix)
        for shp in ((b, h, w), (1, 5, 7), (6, 19, 70)):
            x, tl = rnd(*shp, 64), rnd(4, *shp, 32)
            for k_ in range(1, 5):
                cout = 64 if k_ == 4 else 32
                wt, bias = rnd(3, 3, 64 + 32 * k_, cout, scale=0.03), rnd(cout, scale=0.05)
                cat = torch.cat([x, *tl[:k_].unbind(0)], dim=-1)
                kw = dict(r1=x, s1=0.2) if k_ == 4 else dict(act="lrelu")
                one(f"{shp} x + {k_} tail blocks -> {cout}", x, wt, bias, f64=k_ < 4,
                    x_tail=tl[:k_], mma_x=cat, **kw)
        del grow
        # up1 at the flagship's shape: 1x1080x1920x64 -> 1x2160x3840x64 on
        # the wgmma route (its nearest-2x producer), against forced mma
        xu, wu, bu = rnd(1, H, W, NF), rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.1)
        _build.reset_launches()
        ku = tail.up1_fused(xu, wu, bu)
        torch.cuda.synchronize()
        got = _build.launches()
        check(got == {"up1_fused": 1, "conv3x3:wgmma": 1}, f"[k1] up1: launches {got}")
        km = tail.conv3x3(xu, wu, bu, act="lrelu", upsample2=True, counter="check", route="mma")
        same = torch.equal(ku, km)
        check(same, "[k1] up1 on wgmma is not bit-equal to forced mma")
        del ku, km
        up1_ms = {r: timed(lambda r=r: tail.conv3x3(xu, wu, bu, act="lrelu", upsample2=True,
                                                    counter="check", route=r), 10)
                  for r in ("wgmma", "mma")}
        up_nchw = rnd(1, NF, 2 * H, 2 * W).contiguous(memory_format=torch.channels_last)
        wu_oihw = wu.permute(3, 2, 0, 1).contiguous()
        up1_lib = timed(lambda: F.conv2d(up_nchw, wu_oihw, bu, padding=1), 10)
        del up_nchw, xu
        up_ops = 2 * 4 * H * W * 9 * NF * NF
        up_bytes = (H * W * NF + 4 * H * W * NF) * 2
        log(f"[k1] up1 64->64 1x{H}x{W} -> 1x{2 * H}x{2 * W} (upsample2, lrelu): wgmma "
            f"{up1_ms['wgmma']:.3f} ms, mma {up1_ms['mma']:.3f} ms "
            f"({up1_ms['mma'] / up1_ms['wgmma']:.2f}x), F.conv2d of the upsampled frame "
            f"{up1_lib:.3f} ms; {up_ops / up1_ms['wgmma'] / 1e9:.1f} TFLOP/s (9-tap ops), bound "
            f"{up_bytes / PEAK_BYTES * 1e3:.3f} ms (bytes), 9-tap floor "
            f"{up_ops / PEAK_BF16 * 1e3:.3f} ms (ops); bit_equal_to_mma={same}")
        k1_stats.update(up1_wgmma_ms=up1_ms["wgmma"], up1_mma_ms=up1_ms["mma"],
                        up1_library_ms=up1_lib)

        # one 1080p RDB: each conv as the wgmma route runs it (c1 .. c4 in
        # blocks), with its share of its own bound; then the whole RDB on the
        # fma, mma and wgmma routes and cuDNN's chain
        xb = rnd(1, H, W, NF)
        ws, bs = rdb_weights(NF, GC, bf)
        check(stripe.blocked(xb, ws, bs), "[k1] the 1080p RDB does not take the blocked layout")
        tl = torch.empty(4, 1, H, W, GC, dtype=bf, device=dev)
        out5 = torch.empty(1, H, W, NF, dtype=bf, device=dev)
        conv_ms = []
        for k_ in range(5):
            cin, cout = NF + k_ * GC, (GC if k_ < 4 else NF)
            kw = dict(act="lrelu", out=tl[k_]) if k_ < 4 else dict(out=out5, r1=xb, s1=0.2)
            ms = timed(lambda: tail.conv3x3(xb, ws[k_], bs[k_], x_tail=tl[:k_] if k_ else None,
                                            counter="check", **kw), 10)
            ops = 2 * H * W * 9 * cin * cout
            nbytes = H * W * 2 * (cin + cout + (NF if k_ == 4 else 0))
            bms = max(nbytes / PEAK_BYTES, ops / PEAK_BF16) * 1e3
            by = "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_BF16 else "operations"
            conv_ms.append(ms)
            log(f"[k1] conv{k_ + 1} {cin}->{cout} 1x{H}x{W} wgmma: {ms:.3f} ms, "
                f"{ops / ms / 1e9:.1f} TFLOP/s, {100 * bms / ms:.0f}% of its bound "
                f"{bms:.3f} ms ({by})")
        del tl, out5
        k_new = stripe.rdb_fused(xb, ws, bs)
        new_ms = timed(lambda: stripe.rdb_fused(xb, ws, bs), 5)
        outs, ms_by = {}, {}
        for route in ("mma", "fma"):
            with forced(route):
                _build.reset_launches()
                outs[route] = stripe.rdb_fused(xb, ws, bs)
                got = _build.launches()
                check(got == {"rdb_fused": 5, f"conv3x3:{route}": 5},
                      f"forced {route} route: {got}")
                ms_by[route] = timed(lambda: stripe.rdb_fused(xb, ws, bs), 5)
        e = compare("rdb_fused mma vs fma", outs["mma"], outs["fma"], bf)
        e_new = compare("rdb_fused wgmma vs mma", k_new, outs["mma"], bf)
        del k_new, outs
        rdb_in = [rnd(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last) for k_ in range(5)]
        rdb_w = [w_.permute(3, 2, 0, 1).contiguous() for w_ in ws]
        lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(rdb_in, rdb_w, bs)], 5)
        del rdb_in
        rdb_ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        five = sum(max(H * W * 2 * (NF + k_ * GC + (GC if k_ < 4 else 2 * NF)) / PEAK_BYTES,
                       2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) / PEAK_BF16)
                   for k_ in range(5)) * 1e3
        old_ms, mma_ms = ms_by["fma"], ms_by["mma"]
        log(
            f"[k1] rdb_fused 1x{H}x{W}x64 bf16: fma {old_ms:.3f} ms, mma {mma_ms:.3f} ms, wgmma "
            f"(c1 .. c4 in blocks) {new_ms:.3f} ms ({mma_ms / new_ms:.2f}x mma, "
            f"{rdb_ops / new_ms / 1e9:.1f} TFLOP/s useful, {100 * five / new_ms:.0f}% of the "
            f"five-launch bound {five:.3f} ms), library (cuDNN chain of 5) {lib_ms:.3f} ms; "
            f"max |mma - fma| {e:.3g}, max |wgmma - mma| {e_new:.3g}"
        )
        check(mma_ms * 3 <= old_ms, f"[k1] the mma route ({mma_ms:.3f} ms per RDB) is not 3x the fma kernel ({old_ms:.3f})")
        # conv_body: 64 -> 64 + the long residual, beside F.conv2d
        xc, rc = rnd(1, H, W, NF), rnd(1, H, W, NF)
        wc, bc = rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.1)
        body = {r: timed(lambda r=r: tail.conv3x3(xc, wc, bc, r1=rc, counter="check", route=r), 10)
                for r in ("wgmma", "mma")}
        xc_nchw, wc_oihw = xc.permute(0, 3, 1, 2), wc.permute(3, 2, 0, 1).contiguous()
        body_lib = timed(lambda: F.conv2d(xc_nchw, wc_oihw, bc, padding=1), 10)
        log(f"[k1] conv_body 64->64 + residual 1x{H}x{W}: wgmma {body['wgmma']:.3f} ms, mma "
            f"{body['mma']:.3f} ms, F.conv2d (conv only) {body_lib:.3f} ms")
        k1_stats.update(rdb_fma_ms=old_ms, rdb_mma_ms=mma_ms, rdb_wgmma_ms=new_ms,
                        rdb_library_ms=lib_ms, rdb_five_launch_bound_ms=five, conv_wgmma_ms=conv_ms,
                        conv_body_wgmma_ms=body["wgmma"], conv_body_mma_ms=body["mma"],
                        conv_body_library_ms=body_lib)

    k1_stats = {}
    if want("k1", "kernels"):
        with clock("k1"):
            phase_k1()
        torch.cuda.empty_cache()

    def phase_k1_fp32():
        """K1's fp32 route (``conv3x3:bf16x3``, ``conv3x3_bf16x3_wgmma.cu``:
        three bf16 parts a value, six ``wgmma`` products a MAC): single convs
        at odd shapes (B = 2 ragged, below one tile, two tile columns; every
        act, r1, r1 + r2, upsample2, a last stage of 16 channels, weights
        written in place between calls; growth-buffer prefixes and ``out`` slices, neither route
        writing outside the slice) and a whole RDB with and without x0, each
        within compare's fp32 bound of plain and of the forced fma route; the
        1080p RDB per conv and whole on bf16x3, forced fma and cuDNN's fp32
        chain (bf16x3 at most half of fma's time); conv_body, up1, upconv2,
        conv_hr and an SRVGG conv at the paths' shapes; then the other fp32
        instances of the fp32 paths (``[kernel32]``: the fma stem and
        conv_last, K3, K5's ``VRT_PALLAS=1`` RRDB and the ``VRT_TAIL_Q=1``
        tail, both on ``bf16x3``), each beside its plain version, cuDNN's
        fp32 chain (TF32 off) and its bound (fp32 bytes over 3.35 TB/s; FMA kernels' operations
        over 67 TFLOP/s, bf16x3's six products a MAC over 989 TFLOP/s)."""
        f32 = torch.float32
        st = k1_stats.setdefault("fp32", {})
        worst = [0.0]

        def rf(*shape, scale=1.0):
            return rnd(*shape, scale=scale, dt=f32)

        def one(tag, x, wt, bias, fma_x=None, fma_out=None, **kw):
            """One fp32 conv on the bf16x3 route against plain and the forced
            fma route (``fma_x``, ``fma_out``: the views of another buffer to
            run it on, where x and out are views)."""
            pk = {k_: (v.clone() if k_ == "out" else v) for k_, v in kw.items()}
            _build.reset_launches()
            k = tail.conv3x3(x, wt, bias, counter="check", **kw)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == {"check": 1, "conv3x3:bf16x3": 1},
                  f"[k1] fp32 {tag}: launches {got}, expected one on the bf16x3 route")
            e = compare(f"[k1] fp32 {tag} vs plain", k, tail.conv3x3_plain(x, wt, bias, **pk), f32)
            mk = dict(kw, out=fma_out)
            kf = tail.conv3x3(x if fma_x is None else fma_x, wt, bias, counter="check",
                              route="fma", **mk)
            ef = compare(f"[k1] fp32 {tag} vs fma", k, kf, f32)
            worst[0] = max(worst[0], e)
            log(f"[k1] fp32 {tag} bf16x3 err={e:.3g} vs_fma_err={ef:.3g}")
            return k

        b, h, w = 2, 37, 53
        for shp in ((b, h, w), (1, 5, 7), (6, 19, 70)):
            x = rf(*shp, 64)
            wt, bias = rf(3, 3, 64, 64, scale=0.05), rf(64, scale=0.1)
            al = rf(64, scale=0.3)
            r1, r2 = rf(*shp, 64), rf(*shp, 64)
            one(f"{shp} 64->64 none", x, wt, bias)
            one(f"{shp} 64->64 lrelu", x, wt, bias, act="lrelu")
            one(f"{shp} 64->64 prelu", x, wt, bias, act="prelu", alpha=al)
            one(f"{shp} 64->64 r1", x, wt, bias, r1=r1, s1=0.2)
            one(f"{shp} 64->64 r1+r2", x, wt, bias, r1=r1, s1=0.2, r2=r2, s2=0.2)
            # the weights' kept parts follow a write in place
            wk = wt.clone()
            one(f"{shp} 64->64 lrelu, parts kept", x, wk, bias, act="lrelu")
            wk.mul_(-0.5)
            one(f"{shp} 64->64 lrelu, weights written in place", x, wk, bias, act="lrelu")
            one(f"{shp} 64->64 upsample2 lrelu", x, wt, bias, act="lrelu", upsample2=True)
            one(f"{shp} 64->32 upsample2 lrelu", x, rf(3, 3, 64, 32, scale=0.05),
                bias[:32].clone(), act="lrelu", upsample2=True)
            one(f"{shp} 192->64 upsample2 lrelu", rf(*shp, 192), rf(3, 3, 192, 64, scale=0.03),
                bias, act="lrelu", upsample2=True)
            one(f"{shp} 64->32 none", x, rf(3, 3, 64, 32, scale=0.05), bias[:32].clone())
            # cin 48 of a 64-channel buffer: three stages of 16
            one(f"{shp} 48->32 lrelu", x[..., :48], rf(3, 3, 48, 32, scale=0.05),
                bias[:32].clone(), act="lrelu")
        # the fp32 RDB's layout: conv k reads the prefix of a 192-channel
        # buffer (a pixel of 768 bytes) and writes its 32 channels at their
        # offset in the same buffer, on both routes
        grow = rf(b, h, w, 192)
        rest = torch.ones(192, dtype=torch.bool, device=dev)
        for cin in (64, 96, 128, 160):
            wt, bias = rf(3, 3, cin, 32, scale=0.03), rf(32, scale=0.05)
            gk, gm = grow.clone(), grow.clone()
            one(f"growth buffer {cin}->32 into [{cin}:{cin + 32}]", gk[..., :cin], wt, bias,
                act="lrelu", out=gk[..., cin : cin + 32], fma_x=gm[..., :cin],
                fma_out=gm[..., cin : cin + 32])
            rest[:] = True
            rest[cin : cin + 32] = False
            for route, g_ in (("bf16x3", gk), ("fma", gm)):
                check(torch.equal(g_[..., rest], grow[..., rest]),
                      f"fp32 growth buffer {cin}->32: the {route} kernel wrote outside its slice")
        wt, bias = rf(3, 3, 192, 64, scale=0.03), rf(64, scale=0.05)
        one("growth buffer 192->64 r1", grow, wt, bias, r1=grow[..., :64], s1=0.2)
        one("growth buffer 192->64 r1+r2", grow, wt, bias, r1=grow[..., :64], s1=0.2,
            r2=rf(b, h, w, 64), s2=0.2)
        del grow
        ws, bs = rdb_weights(NF, GC, f32)
        for shp in ((b, h, w), (6, 19, 70)):
            xr = rf(*shp, NF)
            for x0 in (None, rf(*shp, NF)):
                _build.reset_launches()
                kr = stripe.rdb_fused(xr, ws, bs, x0)
                torch.cuda.synchronize()
                got = _build.launches()
                check(got == {"rdb_fused": 5, "conv3x3:bf16x3": 5}, f"[k1] fp32 RDB launches {got}")
                e = compare("[k1] fp32 RDB", kr, stripe.rdb_fused_plain(xr, ws, bs, x0), f32)
                with forced("fma"):
                    ef = compare("[k1] fp32 RDB vs fma", kr, stripe.rdb_fused(xr, ws, bs, x0), f32)
                worst[0] = max(worst[0], e)
                log(f"[k1] fp32 RDB {shp} x0={x0 is not None} bf16x3 err={e:.3g} vs_fma_err={ef:.3g}")

        # precision: a single product (one nonzero input value, all three
        # parts in play) is fp32's own to 2^-22; a sum of cin channels within
        # 1.5e-7 x cin of its largest value against float64 (the tensor
        # cores' fp32 adds of the k16 groups: read at about 7e-8 x cin, so a
        # change that doubles it fails), beside cuDNN's fp32 (TF32 off) and
        # the six products summed in float64
        for cout in (32, 64):
            for val in (1.0 + 2.0**-9 + 2.0**-18, 0.7390851332151607):
                xd = torch.zeros(1, 9, 9, 16, dtype=torch.float64)
                xd[0, 4, 4, 3] = val
                wd = (rf(3, 3, 16, cout, scale=0.05)).double().cpu()
                got = tail.conv3x3(xd.float().to(dev), wd.float().to(dev),
                                   torch.zeros(cout, device=dev), counter="check").double().cpu()
                ref = conv_ref64(xd, wd, torch.zeros(cout, dtype=torch.float64))
                rel = (got - ref).abs().max().item() / ref.abs().max().item()
                check(rel <= 2.0**-22, f"[k1] fp32 one product {val!r} cout {cout}: relative "
                      f"error {rel:.3g} > 2^-22 (a part's product is missing or wrong)")
                log(f"[k1] fp32 precision: one product ({val!r}, cout {cout}) relative error "
                    f"{rel:.3g}")
            for cin in (16, 64, 192):
                xd, wd, bd = rf(1, 32, 64, cin), rf(3, 3, cin, cout, scale=0.05), rf(cout, scale=0.1)
                ref = conv_ref64(xd, wd, bd)
                sc = ref.abs().max().item()
                got = tail.conv3x3(xd, wd, bd, counter="check").double().cpu()
                lib = F.conv2d(xd.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1), bd,
                               padding=1).permute(0, 2, 3, 1).double().cpu()
                xp_, wp_ = tail.split3(xd).double().cpu(), tail.split3(wd).double().cpu()
                six = sum(F.conv2d(xp_[i].permute(0, 3, 1, 2), wp_[j].permute(3, 2, 0, 1),
                                   padding=1) for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
                                                           (0, 0))).permute(0, 2, 3, 1) + bd.double().cpu()
                errs = [(t - ref).abs().max().item() / sc for t in (got, lib, six)]
                limit = SUM_REL_PER_CIN * cin
                st.setdefault("precision", []).append(dict(cin=cin, cout=cout, bf16x3=errs[0],
                                                           cudnn=errs[1], six_f64=errs[2],
                                                           limit=limit))
                log(f"[k1] fp32 precision cin {cin} -> {cout} (1x32x64), max error over the "
                    f"largest value against float64: bf16x3 {errs[0]:.3g} (limit {limit:.3g}), "
                    f"cuDNN fp32 {errs[1]:.3g}, the six products summed in float64 "
                    f"{errs[2]:.3g}")
                check(errs[0] <= limit, f"[k1] fp32 sum of cin {cin} -> {cout}: error "
                      f"{errs[0]:.3g} of the largest value > {limit:.3g} (1.5e-7 x cin)")

        def bound32(nbytes, ops, x3, fma_ops=0):
            """(ms, by) of fp32 work: its bytes, and its operations at 67
            TFLOP/s (FMA kernels) or six bf16 products a MAC at 989 (bf16x3;
            ``fma_ops`` on the CUDA cores run beside the tensor cores, so the
            larger of the two times)."""
            t_o = max(6 * ops / PEAK_BF16, fma_ops / PEAK_FP32) if x3 else ops / PEAK_FP32
            t_b = nbytes / PEAK_BYTES
            return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

        # the 1080p RDB: each conv on bf16x3 in the growth buffer, then the
        # whole RDB on bf16x3, on forced fma and as cuDNN's fp32 chain
        xb = rf(1, H, W, NF)
        gb = torch.empty(1, H, W, NF + 4 * GC, dtype=f32, device=dev)
        gb[..., :NF] = xb
        out5 = torch.empty(1, H, W, NF, dtype=f32, device=dev)
        convs = []
        for k_ in range(5):
            cin, cout = NF + k_ * GC, (GC if k_ < 4 else NF)
            kw = (dict(act="lrelu", out=gb[..., cin : cin + cout]) if k_ < 4
                  else dict(out=out5, r1=gb[..., :NF], s1=0.2))
            ms = timed(lambda: tail.conv3x3(gb[..., :cin], ws[k_], bs[k_], counter="check", **kw),
                       5)
            ops = 2 * H * W * 9 * cin * cout
            bms, by = bound32(H * W * 4 * (cin + cout + (NF if k_ == 4 else 0)), ops, True)
            convs.append(dict(ms=ms, bound_ms=bms))
            log(f"[k1] fp32 conv{k_ + 1} {cin}->{cout} 1x{H}x{W} bf16x3: {ms:.3f} ms, "
                f"{ops / ms / 1e9:.1f} TFLOP/s useful, {100 * bms / ms:.0f}% of its bound "
                f"{bms:.3f} ms ({by}: six bf16 products a MAC)")
        del gb, out5
        k_x3 = stripe.rdb_fused(xb, ws, bs)
        x3_ms = timed(lambda: stripe.rdb_fused(xb, ws, bs), 5)
        p_rdb = stripe.rdb_fused_plain(xb, ws, bs)
        e_p = compare("[k1] fp32 RDB 1080p vs plain", k_x3, p_rdb, f32)
        p_ms = timed(lambda: stripe.rdb_fused_plain(xb, ws, bs), 2)
        del p_rdb
        with forced("fma"):
            _build.reset_launches()
            k_fma = stripe.rdb_fused(xb, ws, bs)
            got = _build.launches()
            check(got == {"rdb_fused": 5, "conv3x3:fma": 5}, f"[k1] fp32 forced fma: {got}")
            fma_ms = timed(lambda: stripe.rdb_fused(xb, ws, bs), 2)
        e_f = compare("[k1] fp32 RDB 1080p vs fma", k_x3, k_fma, f32)
        del k_x3, k_fma
        rdb_in = [rf(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last)
                  for k_ in range(5)]
        rdb_w = [w_.permute(3, 2, 0, 1).contiguous() for w_ in ws]
        lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1)
                                for a, w_, b_ in zip(rdb_in, rdb_w, bs)], 3)
        del rdb_in
        rdb_ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        rdb_bytes = 2 * H * W * NF * 4 + sum(t.numel() * 4 for t in (*ws, *bs))
        rdb_bms, rdb_by = bound32(rdb_bytes, rdb_ops, True)
        log(f"[k1] fp32 rdb_fused 1x{H}x{W}x64: bf16x3 {x3_ms:.3f} ms ({fma_ms / x3_ms:.2f}x fma, "
            f"{rdb_ops / x3_ms / 1e9:.1f} TFLOP/s useful, {100 * rdb_bms / x3_ms:.0f}% of its "
            f"bound {rdb_bms:.3f} ms ({rdb_by}: six bf16 products a MAC; fp32 FMAs at 67 TFLOP/s: "
            f"{rdb_ops / PEAK_FP32 * 1e3:.3f} ms)), fma (forced) {fma_ms:.3f} ms, cuDNN's fp32 "
            f"chain of 5 (TF32 off) {lib_ms:.3f} ms, plain {p_ms:.3f} ms; max |bf16x3 - plain| "
            f"{e_p:.3g}, max |bf16x3 - fma| {e_f:.3g}")
        check(x3_ms * 2 <= fma_ms,
              f"[k1] the fp32 RDB on bf16x3 ({x3_ms:.3f} ms) is not at most half of fma's ({fma_ms:.3f})")
        rows["conv3x3:bf16x3"] = dict(max_abs_err=e_p, ms=x3_ms, plain_ms=p_ms, bound_ms=rdb_bms,
                                      bound_by=rdb_by, library_ms=lib_ms)
        st.update(rdb_bf16x3_ms=x3_ms, rdb_fma_ms=fma_ms, rdb_library_ms=lib_ms, rdb_plain_ms=p_ms,
                  rdb_bound_ms=rdb_bms, rdb_fp32_fma_floor_ms=rdb_ops / PEAK_FP32 * 1e3,
                  conv_bf16x3=convs)
        del xb

        # the other bf16x3 shapes of the paths, and the fp32 instances of the
        # other kernels they launch (the stem and conv_last on narrow, K3) or
        # that their knobs select (K5 at VRT_PALLAS=1, K6 at VRT_TAIL_Q=1)
        table = st.setdefault("rows", {})

        def row32(name, shape, k_fn, p_fn, lib_fn, nbytes, ops, x3, per_frame, reps=3,
                  fma_ops=0, half_fma=False, vs_fma=None, bit_equal=False,
                  under_library=False, json_row=None):
            """One fp32 instance against plain; one that has a forced fma
            route (``vs_fma``, by default the bf16x3 ones: ``k_fn(route)``)
            also against it, both timed (``half_fma``: at most half of fma's
            time; ``bit_equal``: ``torch.equal`` to it; ``under_library``:
            faster than the library call). ``json_row``: the kernels line's
            row it fills."""
            vs_fma = x3 if vs_fma is None else vs_fma
            k = k_fn(None) if vs_fma else k_fn()
            e = compare(f"[kernel32] {name}", k, p_fn(), f32)
            fma = ""
            if vs_fma:
                k = k.clone()
                kf = k_fn("fma")
                ef = compare(f"[kernel32] {name} vs fma", k, kf, f32)
                if bit_equal:
                    check(torch.equal(k, kf), f"[kernel32] {name}: not bit-equal to fma "
                          f"(max |diff| {ef:.3g})")
                del kf
                fms = timed(lambda: k_fn("fma"), 1)
                fma = (f", fma (forced) {fms:.3f} ms, err vs fma {ef:.3g}"
                       + (" (bit-equal)" if bit_equal else ""))
            del k
            torch.cuda.synchronize()
            ms = timed(k_fn if not vs_fma else (lambda: k_fn(None)), reps)
            pms = timed(p_fn, 1)
            lms = timed(lib_fn, reps)
            bms, by = bound32(nbytes, ops, x3, fma_ops)
            if half_fma:
                check(2 * ms <= fms,
                      f"[kernel32] {name}: {ms:.3f} ms is not at most half of fma's {fms:.3f}")
            if under_library:
                check(ms < lms, f"[kernel32] {name}: {ms:.3f} ms is not under the library's "
                      f"{lms:.3f}")
            table[name] = dict(shape=shape, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                               bound_by=by, max_abs_err=e, launches_per_frame=per_frame,
                               fma_ms=fms if vs_fma else None)
            if json_row:
                rows[json_row] = dict(max_abs_err=e, ms=ms, plain_ms=pms, bound_ms=bms,
                                      bound_by=by, library_ms=lms)
            log(f"[kernel32] {name} {shape}: kernel {ms:.3f} ms, plain {pms:.3f} ms, library "
                f"{lms:.3f} ms, bound {bms:.3f} ms ({by}), {per_frame}, err={e:.3g}{fma}")
            torch.cuda.empty_cache()

        def nchw(x_):
            return x_.permute(0, 3, 1, 2)

        def oihw(w_):
            return w_.permute(3, 2, 0, 1).contiguous()

        x64, res = rf(1, H, W, NF), rf(1, H, W, NF)
        wc, bc = rf(3, 3, NF, NF, scale=0.05), rf(NF, scale=0.1)
        row32("conv_body + res (bf16x3)", f"1x{H}x{W}x64",
              lambda r: tail.conv3x3(x64, wc, bc, r1=res, route=r, counter="check"),
              lambda: tail.conv3x3_fused_plain(x64, wc, bc, res),
              lambda: F.conv2d(nchw(x64), oihw(wc), bc, padding=1),
              H * W * NF * 4 * 3, 2 * H * W * 9 * NF * NF, True, "1 a flagship frame", 5)
        al = (rf(NF, scale=0.2) + 0.2)
        row32("SRVGG body conv, prelu (bf16x3)", f"1x{H}x{W}x64",
              lambda r: tail.conv3x3(x64, wc, bc, act="prelu", alpha=al, route=r,
                                     counter="check"),
              lambda: tail.conv3x3_plain(x64, wc, bc, act="prelu", alpha=al),
              lambda: F.prelu(F.conv2d(nchw(x64), oihw(wc), bc, padding=1), al),
              H * W * NF * 4 * 2, 2 * H * W * 9 * NF * NF, True, "32 a config-4 frame", 5)
        x2 = rf(1, 2 * H, 2 * W, NF)
        up_in = nchw(x2)  # the upsampled frame, as cuDNN reads it
        row32("up1 (bf16x3)", f"1x{H}x{W}x64 -> 1x{2 * H}x{2 * W}x64",
              lambda r: tail.conv3x3(x64, wc, bc, act="lrelu", upsample2=True, route=r,
                                     counter="check"),
              lambda: tail.up1_fused_plain(x64, wc, bc),
              lambda: F.conv2d(up_in, oihw(wc), bc, padding=1),
              H * W * NF * 4 * 5, 4 * 2 * H * W * 9 * NF * NF, True, "1 a flagship frame")
        del up_in
        up2_out = torch.empty(1, 4 * H, 4 * W, NF, dtype=f32, device=dev)
        row32("upconv2 (bf16x3)", f"1x{2 * H}x{2 * W}x64 -> 1x{4 * H}x{4 * W}x64",
              lambda r: tail.conv3x3(x2, wc, bc, act="lrelu", upsample2=True, out=up2_out,
                                     route=r, counter="check"),
              lambda: tail.conv3x3_plain(x2, wc, bc, act="lrelu", upsample2=True),
              lambda: F.conv2d(nchw(up2_out), oihw(wc), bc, padding=1),
              4 * H * W * NF * 4 * 5, 16 * 2 * H * W * 9 * NF * NF, True, "1 a flagship frame")
        del x2
        x8 = up2_out  # an 8K 64-channel frame for conv_hr and conv_last
        wl, bl = rf(3, 3, NF, 3, scale=0.05), rf(3, scale=0.1)
        hr_out = torch.empty_like(x8)
        row32("conv_hr (bf16x3)", f"1x{4 * H}x{4 * W}x64",
              lambda r: tail.conv3x3(x8, wc, bc, act="lrelu", out=hr_out, route=r,
                                     counter="check"),
              lambda: tail.conv3x3_plain(x8, wc, bc, act="lrelu"),
              lambda: F.conv2d(nchw(x8), oihw(wc), bc, padding=1),
              16 * H * W * NF * 4 * 2, 16 * 2 * H * W * 9 * NF * NF, True, "1 a flagship frame")
        del hr_out
        row32("conv_last (narrow)", f"1x{4 * H}x{4 * W}x64 -> 3",
              lambda r: tail.conv3x3(x8, wl, bl, route=r, counter="check"),
              lambda: tail.conv3x3_plain(x8, wl, bl),
              lambda: F.conv2d(nchw(x8), oihw(wl), bl, padding=1),
              16 * H * W * (NF + 3) * 4, 16 * 2 * H * W * 9 * NF * 3, False, "1 a flagship frame",
              5, vs_fma=True, bit_equal=True, under_library=True,
              json_row="conv3x3:narrow conv_last:fp32")
        del x8, up2_out
        xs3 = rf(1, H, W, 3)
        wsm, bsm = rf(3, 3, 3, NF, scale=0.2), rf(NF, scale=0.1)
        row32("stem (narrow, conv3x3_narrow.cu)", f"1x{H}x{W}x3 -> 64",
              lambda r: tail.conv3x3(xs3, wsm, bsm, route=r, counter="check"),
              lambda: tail.conv3x3_fused_plain(xs3, wsm, bsm),
              lambda: F.conv2d(nchw(xs3), oihw(wsm), bsm, padding=1),
              H * W * (3 + NF) * 4, 2 * H * W * 9 * 3 * NF, False,
              "1 a flagship and 1 a config-4 frame", 10, vs_fma=True, bit_equal=True,
              half_fma=True, under_library=True, json_row="conv3x3:narrow stem:fp32")
        R = 4
        wo, bo = rf(3, 3, NF, 3 * R * R, scale=0.05), rf(3 * R * R, scale=0.1)
        xin = rf(1, H, W, 3).abs()
        row32("srvgg_up_fused K3 (bf16x3, srvgg_up_bf16x3.cu)",
              f"1x{H}x{W}x64 -> 1x{R * H}x{R * W}x3",
              lambda r: srvgg.srvgg_up_fused(x64, wo, bo, xin, R, route=r),
              lambda: srvgg.srvgg_up_fused_plain(x64, wo, bo, xin, R),
              lambda: F.conv2d(nchw(x64), oihw(wo), bo, padding=1),
              H * W * (NF + 3 + 3 * R * R) * 4, 2 * H * W * 9 * NF * 3 * R * R, True,
              "1 a config-4 frame", 10, half_fma=True, under_library=True,
              json_row="srvgg_up_fused:bf16x3")
        rrdb_w = [rdb_weights(NF, GC, f32) for _ in range(3)]
        rrdb_w_oihw = [[oihw(w_) for w_ in ws_] for ws_, _ in rrdb_w]
        ins = [rf(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last)
               for k_ in range(5)]
        row32("rrdb_fused K5 (bf16x3, rdb_fused_bf16x3.cu)", f"1x{H}x{W}x64, 3 RDBs + residual",
              lambda r: rdb.rrdb_fused(x64, rrdb_w, route=r),
              lambda: rdb.rrdb_fused_plain(x64, rrdb_w),
              lambda: [F.conv2d(a, w_, b_, padding=1) for (_, bs_), wo_ in zip(rrdb_w, rrdb_w_oihw)
                       for a, w_, b_ in zip(ins, wo_, bs_)],
              2 * H * W * NF * 4, 3 * rdb_ops, True, "23 a VRT_PALLAS=1 fp32 frame", 3,
              half_fma=True)
        del ins
        tw = tail_weights(NF, f32)
        x2 = rf(1, 2 * H, 2 * W, NF)
        up8 = rf(1, NF, 4 * H, 4 * W).contiguous(memory_format=torch.channels_last)
        tw_oihw = [oihw(tw[0]), oihw(tw[2]), oihw(tw[4])]
        row32("tail_fused_q (bf16x3, tail_fused_bf16x3.cu)",
              f"1x{2 * H}x{2 * W}x64 -> 1x{4 * H}x{4 * W}x3",
              lambda r: tail.tail_fused_q(x2, *tw, route=r),
              lambda: tail.tail_fused_q_plain(x2, *tw),
              lambda: [F.conv2d(up8, tw_oihw[0], tw[1], padding=1),
                       F.conv2d(up8, tw_oihw[1], tw[3], padding=1),
                       F.conv2d(up8, tw_oihw[2], tw[5], padding=1)],
              4 * H * W * NF * 4 + 16 * H * W * 3 * 4,
              16 * 2 * H * W * 9 * NF * 2 * NF, True, "1 a VRT_TAIL_Q=1 fp32 frame", 3,
              fma_ops=16 * 2 * H * W * 9 * NF * 3, half_fma=True)
        del x2, up8, x64, res
        st["max_err_odd_shapes"] = worst[0]
        torch.cuda.empty_cache()

    if want("k1", "kernels"):
        with clock("k1 fp32"):
            phase_k1_fp32()
        torch.cuda.empty_cache()

    def phase_k1n():
        """K1's narrow route (``conv3x3_narrow.cu``): the stems and conv_last,
        each in bf16 and fp32, at odd shapes and at the paths' shapes, each
        ``torch.equal`` to the forced fma route (both sum in one order) and
        within compare's bound of plain in its dtype; then the old kernel
        (fma forced), the new one and ``F.conv2d`` side by side at the
        flagship's two shapes and at the fp32 conv_last's, the new one at
        most a third of the old (the fp32 stem's times: ``[kernel32]``)."""
        def held(tag, x, wt, bias, kind, **kw):
            _build.reset_launches()
            k = tail.conv3x3(x, wt, bias, counter="k1n", **kw)
            torch.cuda.synchronize()
            got = _build.launches()
            expect = {"k1n": 1, "conv3x3:narrow": 1, f"conv3x3:narrow {kind}": 1}
            if x.dtype == torch.float32:
                expect[f"conv3x3:narrow {kind}:fp32"] = 1
            check(got == expect, f"[k1n] {tag}: launches {got} != {expect}")
            if "out" in kw:  # the forced route writes the same slice
                k = k.clone()
            old = tail.conv3x3(x, wt, bias, counter="k1n", route="fma", **kw)
            diff = (k.float() - old.float()).abs().max().item()
            check(torch.equal(k, old), f"[k1n] {tag}: narrow != fma (max |diff| {diff:.3g})")
            del old
            e = compare(f"[k1n] {tag}", k, tail.conv3x3_plain(x, wt, bias, **kw), x.dtype)
            sfx = "_fp32" if x.dtype == torch.float32 else ""
            k1n_stats["bit_equal_cases" + sfx] = k1n_stats.get("bit_equal_cases" + sfx, 0) + 1
            k1n_stats["max_err" + sfx] = max(k1n_stats.get("max_err" + sfx, 0.0), e)
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
        # the fp32 stems (the fp32 paths' conv_first and conv_in): the same
        # cases in fp32, a cin-3 view of a 4-channel buffer (pixel stride 4,
        # 16 bytes) into a slice of a growth buffer (pixel stride 68, 16-byte
        # aligned at channel 4), the paths' shapes
        f32 = torch.float32
        for cin in (3, 12):
            wt, bias = rnd(3, 3, cin, NF, scale=0.2, dt=f32), rnd(NF, scale=0.1, dt=f32)
            al = rnd(NF, scale=0.3, dt=f32)
            for shp in odd:
                x = rnd(*shp, cin, dt=f32)
                held(f"fp32 stem {cin}->64 {shp} none", x, wt, bias, "stem")
                held(f"fp32 stem {cin}->64 {shp} prelu", x, wt, bias, "stem", act="prelu",
                     alpha=al)
                held(f"fp32 stem {cin}->64 {shp} lrelu", x, wt, bias, "stem", act="lrelu")
        wt, bias = rnd(3, 3, 3, NF, scale=0.2, dt=f32), rnd(NF, scale=0.1, dt=f32)
        al = rnd(NF, scale=0.3, dt=f32)
        dst = torch.zeros(2, 37, 53, 68, dtype=f32, device=dev)
        held("fp32 stem 3->64 (2, 37, 53) strided x, out a slice",
             rnd(2, 37, 53, 4, dt=f32)[..., :3], wt, bias, "stem", act="prelu", alpha=al,
             out=dst[..., 4:68])
        check(not dst[..., :4].any(), "[k1n] the fp32 stem wrote outside its channel slice")
        for shp in ((1, H, W), (6, 376, 448)):
            x = rnd(*shp, 3, dt=f32)
            held(f"fp32 stem 3->64 {shp} none", x, wt, bias, "stem")
            held(f"fp32 stem 3->64 {shp} prelu", x, wt, bias, "stem", act="prelu", alpha=al)
        held("fp32 stem 12->64 (1, 540, 960) none", rnd(1, 540, 960, 12, dt=f32),
             rnd(3, 3, 12, NF, scale=0.2, dt=f32), bias, "stem")
        torch.cuda.empty_cache()
        # the fp32 conv_last (the fp32 chain tail's, TMA-fed): odd shapes, a
        # 64-channel prefix of a 72-channel buffer (pixel stride 288 bytes),
        # the paths' shapes (the flagship's 8K frame, the tile batch)
        wl, bl = rnd(3, 3, NF, 3, scale=0.05, dt=f32), rnd(3, scale=0.1, dt=f32)
        for shp in ((2, 37, 53), (1, 5, 7), (2, 100, 150)):
            held(f"fp32 conv_last 64->3 {shp}", rnd(*shp, NF, dt=f32), wl, bl, "conv_last")
        held("fp32 conv_last 64->3 (2, 37, 53) x a prefix of 72",
             rnd(2, 37, 53, 72, dt=f32)[..., :NF], wl, bl, "conv_last")
        for shp in ((1, 4 * H, 4 * W), (6, 1504, 1792)):
            held(f"fp32 conv_last 64->3 {shp}", rnd(*shp, NF, dt=f32), wl, bl, "conv_last")
            torch.cuda.empty_cache()

        # old, new and cuDNN at the flagship's shapes (bf16), and at the fp32
        # chain tail's conv_last (its floors in fp32 bytes)
        for tag, cin, cout, shp, reps, dt in (
                ("stem", 3, NF, (1, H, W), 20, bf),
                ("conv_last", NF, 3, (1, 4 * H, 4 * W), 5, bf),
                ("conv_last_fp32", NF, 3, (1, 4 * H, 4 * W), 5, f32)):
            x = rnd(*shp, cin, dt=dt)
            wt, bias = rnd(3, 3, cin, cout, scale=0.05, dt=dt), rnd(cout, scale=0.1, dt=dt)
            new_ms = timed(lambda: tail.conv3x3(x, wt, bias, counter="k1n"), reps)
            old_ms = timed(lambda: tail.conv3x3(x, wt, bias, counter="k1n", route="fma"), max(2, reps // 4))
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous()
            lib_ms = timed(lambda: F.conv2d(x_nchw, w_oihw, bias, padding=1), reps)
            npx = shp[0] * shp[1] * shp[2]
            fmas = npx * 9 * cin * cout
            nbytes = (npx * (cin + cout) + 9 * cin * cout + cout) * x.element_size()
            log(
                f"[k1n] {tag} {shp}x{cin}->{cout} {'fp32' if dt == f32 else 'bf16'}: fma (old kernel) {old_ms:.3f} ms, narrow (new "
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
        with clock("k1n"):
            phase_k1n()
        torch.cuda.empty_cache()

    def phase_k2():
        """K2's rows route (``unsharp_rows.cuh``), fp32 and bf16 instances:
        odd shapes, edge cases of its strips, runs and halo, and radii
        0..16, each ``torch.equal`` to the forced tile route of the same
        dtype (both sum in one order) and, in fp32, within compare's fp32
        bound of plain, in bf16 within one bf16 step of
        ``unsharp_fused_plain``; then the old kernel (tile forced), the new
        one, the plain version and a copy of the frame side by side at the
        flagship's 1x4320x7680x3, in fp32 and in bf16; then a frame of more
        than 2^31 values against the tile route."""
        def held(tag, x, radius=4, thr=0.0):
            dname = "fp32" if x.dtype == torch.float32 else "bf16"
            tag = f"{tag} {dname}"
            _build.reset_launches()
            k = unsharp.unsharp_fused(x, 0.3, 1.5, radius, thr)
            torch.cuda.synchronize()
            got = _build.launches()
            expect = {"unsharp_fused": 1, "unsharp_fused:rows": 1, f"unsharp_fused:rows:{dname}": 1}
            check(got == expect, f"[k2] {tag}: launches {got} != {expect}")
            old = unsharp.unsharp_fused(x, 0.3, 1.5, radius, thr, route="tile")
            diff = (k.float() - old.float()).abs().max().item()
            check(torch.equal(k, old), f"[k2] {tag}: rows != tile (max |diff| {diff:.3g})")
            del old
            if x.dtype == torch.float32:
                p = post.unsharp_mask(x, 0.3, 1.5, radius, thr)
                e = compare(f"[k2] {tag}", k, p, torch.float32)
                err = f"err vs plain {e:.3g}"
            else:
                p = unsharp.unsharp_fused_plain(x, 0.3, 1.5, radius, thr)
                e, st = bf16_steps(f"[k2] {tag}", k, p, n=1)
                err = f"err vs plain {e:.3g} ({st:.2f} bf16 steps)"
            key = f"bit_equal_cases_{dname}"
            k2_stats[key] = k2_stats.get(key, 0) + 1
            k2_stats[f"max_err_{dname}"] = max(k2_stats.get(f"max_err_{dname}", 0.0), e)
            log(f"[k2] {tag} r={radius} threshold={thr}: == tile, {err}, "
                f"bit-equal to plain: {torch.equal(k, p)}")

        for dt in (torch.float32, torch.bfloat16):
            def frame(*shape):
                return torch.rand(*shape, generator=gen).to(dev, dt)

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
            # one value past a 16-byte boundary: the narrow copies at W*C % G == 0
            buf = frame(1 + 2 * 40 * 64 * 3)
            held("2x40x64x3 x off one value", buf[1:].view(2, 40, 64, 3), thr=0.02)
            # four values past it (8 bytes in bf16, 16 in fp32), and W*C % 8 == 4:
            # the bf16 instance's 8-byte copies where a group of 8 did not fit
            buf = frame(4 + 2 * 40 * 64 * 3)
            held("2x40x64x3 x off four values", buf[4:].view(2, 40, 64, 3), thr=0.02)
            held("2x40x68x3 (W*C % 8 == 4)", frame(2, 40, 68, 3))
            xu = frame(1, 4 * H, 4 * W, 3)
            for thr in (0.0, 0.02):
                held(f"1x{4 * H}x{4 * W}x3 (flagship)", xu, thr=thr)

            # old, new, plain and a copy of the frame at the flagship's shape
            dname = "fp32" if dt == torch.float32 else "bf16"
            plain = post.unsharp_mask if dt == torch.float32 else unsharp.unsharp_fused_plain
            nbytes = 2 * xu.numel() * xu.element_size()
            dst = torch.empty_like(xu)
            new_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4), 20)
            old_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4, route="tile"), 10)
            plain_ms = timed(lambda: plain(xu, 0.3, 1.5, 4), 3)
            copy_ms = timed(lambda: dst.copy_(xu), 20)
            new2_ms = timed(lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4), 20)
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ops_ms = k2_ops(xu.numel(), 4) / PEAK_FP32_UNFUSED * 1e3
            bound = max(bytes_ms, ops_ms)
            regs, per_sm = unsharp.rows_kernel_info(dt, 4)
            log(
                f"[k2] 1x{4 * H}x{4 * W}x3 {dname} r=4: tile (old kernel) {old_ms:.3f} ms "
                f"({nbytes / old_ms / 1e9:.2f} TB/s), rows (new kernel) {new_ms:.3f} / {new2_ms:.3f} ms "
                f"({nbytes / new_ms / 1e9:.2f} TB/s; {old_ms / new_ms:.2f}x), plain {plain_ms:.3f} ms, "
                f"dst.copy_(src) {copy_ms:.3f} ms ({nbytes / copy_ms / 1e9:.2f} TB/s); bound {bound:.3f} ms "
                f"= max(bytes {bytes_ms:.3f}, ops {ops_ms:.3f}: {k2_ops(xu.numel(), 4) / 1e9:.2f} G fp32 "
                f"instructions, no FMA) (the new kernel at {100 * bound / new_ms:.1f}% of it); "
                f"rows: {regs} registers a thread, {per_sm} blocks of 256 threads per SM; "
                f"{k2_stats['bit_equal_cases_' + dname]} cases bit-equal to tile"
            )
            sfx = "" if dt == torch.float32 else "_bf16"
            k2_stats.update({f"tile_ms{sfx}": old_ms, f"rows_ms{sfx}": new_ms, f"rows_again_ms{sfx}": new2_ms,
                             f"plain_ms{sfx}": plain_ms, f"copy_ms{sfx}": copy_ms, f"bound_ms{sfx}": bound,
                             f"bytes_ms{sfx}": bytes_ms, f"ops_ms{sfx}": ops_ms, f"registers{sfx}": regs,
                             f"blocks_per_sm{sfx}": per_sm})
            if dt == torch.float32:
                check(new_ms * 3 <= old_ms,
                      f"[k2] the rows route ({new_ms:.3f} ms) is not 3x the tile kernel ({old_ms:.3f})")
            del xu, dst, buf

            # a frame of more than 2^31 values (a row's offset in its frame is
            # 64-bit): rows == tile over the whole frame, and its last rows, past
            # 2^31 values, against plain on a slab of the frame's last 40 rows
            # (the slab's first r rows replicate another edge, so they are left out)
            big = f"1x11200x64000x3 {dname} (2.15 G values)"
            xb = torch.empty(1, 11200, 64000, 3, device=dev, dtype=dt)
            xb.uniform_(generator=torch.Generator(device=dev).manual_seed(17))
            _build.reset_launches()
            kb = unsharp.unsharp_fused(xb, 0.3, 1.5, 4)
            torch.cuda.synchronize()
            got = _build.launches()
            expect = {"unsharp_fused": 1, "unsharp_fused:rows": 1, f"unsharp_fused:rows:{dname}": 1}
            check(got == expect, f"[k2] {big}: launches {got} != {expect}")
            ob = unsharp.unsharp_fused(xb, 0.3, 1.5, 4, route="tile")
            check(torch.equal(kb, ob), f"[k2] {big}: rows != tile")
            del ob
            ps = plain(xb[:, -40:], 0.3, 1.5, 4)[:, 4:]
            if dt == torch.float32:
                e = compare(f"[k2] {big} last rows", kb[:, -36:], ps, torch.float32)
                err = f"err vs plain {e:.3g}"
            else:
                e, st = bf16_steps(f"[k2] {big} last rows", kb[:, -36:], ps, n=1)
                err = f"err vs plain {e:.3g} ({st:.2f} bf16 steps)"
            log(f"[k2] {big} r=4: == tile; its last 36 rows {err}")
            del xb, kb, ps
            torch.cuda.empty_cache()
        lo, hi = K2_BF16_BEFORE_MS
        bf_ms = min(k2_stats["rows_ms_bf16"], k2_stats["rows_again_ms_bf16"])
        log(f"[k2] 1x{4 * H}x{4 * W}x3 r=4, rows: bf16 {k2_stats['rows_ms_bf16']:.3f} ms against fp32 "
            f"{k2_stats['rows_ms']:.3f} ms (bounds {k2_stats['bound_ms_bf16']:.3f} and {k2_stats['bound_ms']:.3f}); "
            f"bf16 against its {lo:.3f}-{hi:.3f} ms before the redesign: {bf_ms / hi:.3f}-{bf_ms / lo:.3f}x "
            f"({k2_stats['registers_bf16']} registers, {k2_stats['blocks_per_sm_bf16']} blocks per SM)")

    k2_stats = {}
    if want("k2", "kernels"):
        with clock("k2"):
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
        window of every 12 x 12 tile (the recomputed halo included). The
        wgmma route's: ``rdb_wgmma_plan(...).executed_ops()``."""
        tiles = b * -(-h // 12) * -(-w // 12)
        return tiles * sum(2 * 9 * (22 - 2 * k) ** 2 * (NF + (k - 1) * GC) * (GC if k < 5 else NF)
                           for k in range(1, 6))

    def phase_k5():
        """K5's Hopper route (``"wgmma"``): one RDB (with and without x0) and
        a whole RRDB in bf16 at nf 64 / gc 32, at odd shapes, at 1080p and at
        ``bench_rdb``'s shape, each launch counted under its route, within
        compare's bf16 tolerance of the plain version, and bit-equal to the
        forced ``mma`` route and to K1's five-launch chain; the forced
        ``fma`` route held to plain at a ragged shape and at 1080p; then
        every route and the cuDNN and K1 chains side by side at 1080p."""
        lib = _build.load()
        geo = rdb.wgmma_geometry(lib)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ws, bs = rdb_weights(NF, GC, bf)
        w3 = [(ws, bs)] + [rdb_weights(NF, GC, bf) for _ in range(2)]

        def k1_rdb(x, x0=None):
            return stripe.rdb_fused(x, ws, bs, x0)

        def k1_rrdb(x):
            out = stripe.rdb_fused(x, *w3[0])
            out = stripe.rdb_fused(out, *w3[1])
            return stripe.rdb_fused(out, *w3[2], x0=x)

        def held(tag, counter, k_fn, p_fn, mma_fn, chain_fn):
            k = one_launch(f"[k5] {tag}", k_fn, counter, route="wgmma")
            p = p_fn()
            e = compare(f"[k5] {tag}", k, p, bf)
            # per value in bf16 steps, taken at no less than 2^-8 of plain's
            # largest value as in [k1]: reported, not held
            _, st = bf16_steps(f"[k5] {tag}", k, p, n=float("inf"),
                               floor=p.float().abs().max().item() * 2.0**-8)
            del p
            # the same fp32 sums in the same order (16 channels of the growth
            # prefix at a time, taps in order) and the same epilogue as the
            # mma route and K1's tensor-core chain: the same bits
            same_mma = torch.equal(k, one_launch(f"[k5] {tag} forced mma", mma_fn, counter))
            same_k1 = torch.equal(k, chain_fn())
            check(same_mma, f"[k5] {tag}: wgmma differs from the forced mma route")
            check(same_k1, f"[k5] {tag}: wgmma differs from K1's five-launch chain")
            k5_stats["bit_equal_cases"] = k5_stats.get("bit_equal_cases", 0) + 1
            k5_stats["max_steps"] = max(k5_stats.get("max_steps", 0.0), st)
            k5_stats["max_err"] = max(k5_stats.get("max_err", 0.0), e)
            log(f"[k5] {tag} err={e:.3g} steps={st:.2f} == mma, == K1 chain")
            return k

        def three(shp):
            """One RDB, one with x0, one RRDB at ``shp``, each held."""
            x, x0 = rnd(*shp, NF), rnd(*shp, NF)
            held(f"rdb_fused {shp}", "rdb_fused_k5", lambda: rdb.rdb_fused(x, ws, bs),
                 lambda: rdb.rdb_fused_plain(x, ws, bs),
                 lambda: rdb.rdb_fused(x, ws, bs, route="mma"), lambda: k1_rdb(x))
            held(f"rdb_fused {shp} x0", "rdb_fused_k5", lambda: rdb.rdb_fused(x, ws, bs, x0),
                 lambda: rdb.rdb_fused_plain(x, ws, bs, x0),
                 lambda: rdb.rdb_fused(x, ws, bs, x0, route="mma"), lambda: k1_rdb(x, x0))
            held(f"rrdb_fused {shp}", "rrdb_fused", lambda: rdb.rrdb_fused(x, w3),
                 lambda: rdb.rrdb_fused_plain(x, w3), lambda: rdb.rrdb_fused(x, w3, route="mma"),
                 lambda: k1_rrdb(x))
            return x

        # below one stripe, one 12 x 12 tile of the old kernel, ragged with B
        # = 2, a ragged last stripe (72 = 54 + 18), more segments than the
        # persistent grid has blocks; bench_rdb's shape
        for shp in ((1, 5, 7), (1, 12, 12), (2, 37, 53), (1, 20, 72), (2, 130, 150),
                    (4, 384, 504)):
            three(shp)
        xb = three((1, H, W))

        # the bf16 instance of rdb_fused.cu (fp32 FMAs), now a forced route
        # only: one RDB, one with x0 and one RRDB at a ragged shape with B =
        # 2 and at 1080p, each within compare's bf16 tolerance of plain
        for shp in ((2, 37, 53), (1, H, W)):
            x = xb if shp == (1, H, W) else rnd(*shp, NF)
            x0 = rnd(*shp, NF)
            for tag, counter, k_fn, p_fn in (
                (f"rdb_fused {shp}", "rdb_fused_k5", lambda: rdb.rdb_fused(x, ws, bs, route="fma"),
                 lambda: rdb.rdb_fused_plain(x, ws, bs)),
                (f"rdb_fused {shp} x0", "rdb_fused_k5",
                 lambda: rdb.rdb_fused(x, ws, bs, x0, route="fma"),
                 lambda: rdb.rdb_fused_plain(x, ws, bs, x0)),
                (f"rrdb_fused {shp}", "rrdb_fused", lambda: rdb.rrdb_fused(x, w3, route="fma"),
                 lambda: rdb.rrdb_fused_plain(x, w3)),
            ):
                k = one_launch(f"[k5] {tag} forced fma", k_fn, counter, route="fma")
                e = compare(f"[k5] {tag} forced fma", k, p_fn(), bf)
                k5_stats["fma_max_err"] = max(k5_stats.get("fma_max_err", 0.0), e)
                log(f"[k5] {tag} forced fma err={e:.3g}")
                del k

        ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        exe = rdb.rdb_wgmma_plan(1, H, W, geo, sms=sms).executed_ops()
        exe_mma = k5_exec_ops(1, H, W)
        rdb_in = [rnd(1, NF + k_ * GC, H, W).contiguous(memory_format=torch.channels_last) for k_ in range(5)]
        rdb_w = [[w_.permute(3, 2, 0, 1).contiguous() for w_ in r_[0]] for r_ in w3]
        t = {}
        # in turns: wgmma, mma, the chains, fma, then wgmma and mma again
        for name, fn, reps in (
            ("wgmma", lambda: rdb.rdb_fused(xb, ws, bs), 10),
            ("mma", lambda: rdb.rdb_fused(xb, ws, bs, route="mma"), 10),
            ("k1", lambda: k1_rdb(xb), 10),
            ("library", lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(rdb_in, rdb_w[0], bs)], 5),
            ("fma", lambda: rdb.rdb_fused(xb, ws, bs, route="fma"), 3),
            ("wgmma2", lambda: rdb.rdb_fused(xb, ws, bs), 10),
            ("mma2", lambda: rdb.rdb_fused(xb, ws, bs, route="mma"), 10),
        ):
            t[name] = timed(fn, reps)
        new_ms, old_ms = min(t["wgmma"], t["wgmma2"]), min(t["mma"], t["mma2"])
        log(
            f"[k5] rdb_fused 1x{H}x{W}x64 bf16: wgmma (new kernel) {t['wgmma']:.3f} / {t['wgmma2']:.3f} ms "
            f"({ops / new_ms / 1e9:.1f} TFLOP/s useful, {exe / new_ms / 1e9:.1f} executed, executed/useful "
            f"{exe / ops:.3f}), mma (old kernel) {t['mma']:.3f} / {t['mma2']:.3f} ms ({ops / old_ms / 1e9:.1f} "
            f"useful, {exe_mma / old_ms / 1e9:.1f} executed, executed/useful {exe_mma / ops:.3f}; "
            f"{old_ms / new_ms:.2f}x), fma {t['fma']:.3f} ms, K1's five-launch chain {t['k1']:.3f} ms, "
            f"library (cuDNN chain of 5) {t['library']:.3f} ms; bound {ops / PEAK_BF16 * 1e3:.3f} ms (ops)"
        )
        rt = {}
        for name, fn, reps in (
            ("wgmma", lambda: rdb.rrdb_fused(xb, w3), 5),
            ("mma", lambda: rdb.rrdb_fused(xb, w3, route="mma"), 5),
            ("k1", lambda: k1_rrdb(xb), 5),
            ("library", lambda: [F.conv2d(a, w_, b_, padding=1) for r_, wo in zip(w3, rdb_w)
                                 for a, w_, b_ in zip(rdb_in, wo, r_[1])], 3),
            ("fma", lambda: rdb.rrdb_fused(xb, w3, route="fma"), 2),
            ("wgmma2", lambda: rdb.rrdb_fused(xb, w3), 5),
            ("mma2", lambda: rdb.rrdb_fused(xb, w3, route="mma"), 5),
        ):
            rt[name] = timed(fn, reps)
        rnew_ms, rold_ms = min(rt["wgmma"], rt["wgmma2"]), min(rt["mma"], rt["mma2"])
        log(
            f"[k5] rrdb_fused 1x{H}x{W}x64 bf16: wgmma (new kernel) {rt['wgmma']:.3f} / {rt['wgmma2']:.3f} ms "
            f"({3 * ops / rnew_ms / 1e9:.1f} TFLOP/s useful, {3 * exe / rnew_ms / 1e9:.1f} executed), mma "
            f"(old kernel) {rt['mma']:.3f} / {rt['mma2']:.3f} ms ({rold_ms / rnew_ms:.2f}x), fma {rt['fma']:.3f} "
            f"ms, K1's chain of 15 {rt['k1']:.3f} ms, library (cuDNN chain of 15) {rt['library']:.3f} ms; "
            f"bound {3 * ops / PEAK_BF16 * 1e3:.3f} ms (ops); largest error at every shape: "
            f"{k5_stats['max_err']:.3g}, {k5_stats['max_steps']:.2f} bf16 steps; "
            f"{k5_stats['bit_equal_cases']} cases bit-equal to mma and to K1's chain"
        )
        k5_stats.update(
            rdb_wgmma_ms=new_ms, rdb_mma_ms=old_ms, rdb_fma_ms=t["fma"], rdb_library_ms=t["library"],
            rdb_k1_chain_ms=t["k1"], rrdb_wgmma_ms=rnew_ms, rrdb_mma_ms=rold_ms, rrdb_fma_ms=rt["fma"],
            rrdb_library_ms=rt["library"], rrdb_k1_chain_ms=rt["k1"], executed_per_useful=exe / ops,
            executed_per_useful_mma=exe_mma / ops, bit_equal_to_mma=True, bit_equal_to_k1_chain=True,
        )
        check(new_ms * 2 <= old_ms,
              f"[k5] the wgmma route ({new_ms:.3f} ms per RDB) is not twice as fast as mma ({old_ms:.3f})")

    def phase_k3():
        """K3's tensor-core route at r 2 and r 4: odd shapes, the config-4
        frame and the tile batch, each within one bf16 step per value of the
        plain version (steps taken at no less than 2^-8 of the output's
        largest value); then the old kernel (fma route forced) and the new
        one side by side. Then K3's fp32 route (``srvgg_up_bf16x3.cu``) at r 2
        and r 4: odd shapes (below one tile, ragged, B = 2, an odd width at
        r 2, more tiles than blocks), the config-4 frame and the tile batch,
        each within compare's fp32 bound of plain, its error against the
        forced fma route printed (the time: ``[kernel32]``)."""
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

        f32 = torch.float32
        worst = 0.0
        cases = [(r, shp) for r in srvgg.UP_SCALES
                 for shp in ((1, 5, 7), (2, 37, 53), (1, 9, 33), (1, 20, 130), (3, 70, 200))]
        cases += [(4, (1, H, W)), (4, (6, 376, 448)), (2, (1, 270, 481))]
        for r, shp in cases:
            tag = f"fp32 r {r} {shp}"
            x, xin = rnd(*shp, NF, dt=f32), rnd(*shp, 3, dt=f32).abs()
            wo, bo = rnd(3, 3, NF, 3 * r * r, scale=0.05, dt=f32), rnd(3 * r * r, scale=0.1, dt=f32)
            wu = srvgg.srvgg_up_weights(wo, r)
            k = one_launch(f"[k3] {tag}", lambda: srvgg.srvgg_up_fused(x, wu, bo, xin, r),
                           "srvgg_up_fused", route="bf16x3")
            check(k.shape == (shp[0], r * shp[1], r * shp[2], 3), f"[k3] {tag}: shape {k.shape}")
            e = compare(f"[k3] {tag}", k, srvgg.srvgg_up_fused_plain(x, wo, bo, xin, r), f32)
            if wu.shape != wo.shape:  # a direct caller's unpadded weight
                check(torch.equal(srvgg.srvgg_up_fused(x, wo, bo, xin, r), k),
                      f"[k3] {tag}: unpadded weight")
            k_old = one_launch(f"[k3] {tag} forced fma",
                               lambda: srvgg.srvgg_up_fused(x, wo, bo, xin, r, route="fma"),
                               "srvgg_up_fused", route="fma")
            e_old = (k.float() - k_old.float()).abs().max().item()
            worst = max(worst, e)
            log(f"[k3] {tag} bf16x3 err vs plain {e:.3g}, vs fma {e_old:.3g}")
            del k, k_old
            torch.cuda.empty_cache()
        k3_stats["fp32_max_err"] = worst

    def phase_k6():
        """The one-launch tail on Hopper (``csrc/tail_fused_wgmma.cu``) in
        bf16 at nf 64: B = 2 and 3 with ragged extents, a frame narrower than
        one stripe, a last stripe of 2 columns, more stripes' rows than the
        persistent grid has blocks, and the flagship's 1x2160x3840x64. At
        each, ``tail_fused_q`` and ``tail_fused`` launch it once
        (``:wgmma``), and it is equal bit for bit to the three-launch chain
        (``route="chain"``) and to K6's ``mma`` kernel (forced), within
        compare's bf16 bound of the plain version. Then, at the flagship
        shape, it, K6's mma and fma kernels (forced), the chain and each of
        its convs, and cuDNN's chain of 3 side by side."""
        tw = tail_weights(NF, bf)

        def held(tag, x):
            k = one_launch(f"[k6] {tag}", lambda: tail.tail_fused_q(x, *tw), "tail_fused_q",
                           route="wgmma")
            b_, h_, w_ = x.shape[:3]
            check(k.shape == (b_, 2 * h_, 2 * w_, 3) and k.dtype == bf, f"[k6] {tag}: shape {k.shape}")
            kd = one_launch(f"[k6] {tag} tail_fused", lambda: tail.tail_fused(x, *tw), "tail_fused",
                            route="wgmma")
            p = tail.tail_fused_q_plain(x, *tw)
            e = compare(f"[k6] {tag}", k, p, bf)
            _, st = bf16_steps(f"[k6] {tag}", k, p, n=float("inf"),
                               floor=p.float().abs().max().item() * 2.0**-8)
            del p
            _build.reset_launches()
            chain = tail.tail_fused(x, *tw, route="chain")
            torch.cuda.synchronize()
            got = _build.launches()
            want = {"tail_fused": 3, "conv3x3:wgmma": 2, "conv3x3:narrow": 1,
                    "conv3x3:narrow conv_last": 1}
            check(got == want, f"[k6] {tag}: the chain's launches {got} != {want}")
            mma = one_launch(f"[k6] {tag} K6 mma", lambda: tail.tail_fused_q(x, *tw, route="mma"),
                             "tail_fused_q", route="mma")
            same = dict(tail_fused=torch.equal(k, kd), chain=torch.equal(k, chain),
                        k6_mma=torch.equal(k, mma))
            del chain, mma, kd
            k6_stats["max_steps"] = max(k6_stats.get("max_steps", 0.0), st)
            k6_stats["max_err"] = max(k6_stats.get("max_err", 0.0), e)
            log(f"[k6] {tag} wgmma err={e:.3g} steps={st:.2f} bit_equal_to_k1_chain={same['chain']} "
                f"bit_equal_to_k6_mma={same['k6_mma']} tail_fused==tail_fused_q={same['tail_fused']}")
            check(all(same.values()), f"[k6] {tag}: not bit-equal {same}")
            return k

        # stripes of 60 output columns: (2, 37, 53) -> 74 x 106 (ragged, B =
        # 2); (1, 5, 7) -> 10 x 14, narrower than one stripe; (1, 9, 13)
        # ragged both ways; (2, 100, 150) -> 2 x 5 stripes x 200 rows over
        # 63 blocks; (1, 1, 61) -> 2 x 122, a last stripe of 2 columns;
        # (3, 7, 200) -> 3 x 7 stripes x 14 rows, segments across images
        for shp in ((2, 37, 53), (1, 5, 7), (1, 9, 13), (2, 100, 150), (1, 1, 61), (3, 7, 200)):
            held(str(shp), rnd(*shp, NF))
        h2, w2 = 2 * H, 2 * W
        x2 = rnd(1, h2, w2, NF)
        k_new = held(f"1x{h2}x{w2}x64", x2)
        k6_stats["bit_equal_to_k1_chain"] = True
        k_old = one_launch("[k6] forced fma", lambda: tail.tail_fused_q(x2, *tw, route="fma"),
                           "tail_fused_q", route="fma")
        e_old = compare("[k6] wgmma vs fma", k_new, k_old, bf)
        del k_new, k_old
        new_ms = timed(lambda: tail.tail_fused(x2, *tw), 10)
        q_ms = timed(lambda: tail.tail_fused_q(x2, *tw), 10)
        mma_ms = timed(lambda: tail.tail_fused_q(x2, *tw, route="mma"), 5)
        old_ms = timed(lambda: tail.tail_fused_q(x2, *tw, route="fma"), 2)
        chain_ms = timed(lambda: tail.tail_fused(x2, *tw, route="chain"), 5)
        # the chain per conv: upconv2 (wgmma, and forced mma as the chain ran
        # it before this slice), conv_hr (wgmma), conv_last (narrow)
        u2 = tail.conv3x3(x2, tw[0], tw[1], act="lrelu", upsample2=True, counter="check")
        hr = tail.conv3x3(u2, tw[2], tw[3], act="lrelu", counter="check")
        split = dict(
            upconv2=timed(lambda: tail.conv3x3(x2, tw[0], tw[1], act="lrelu", upsample2=True,
                                               counter="check", out=u2), 5),
            upconv2_mma=timed(lambda: tail.conv3x3(x2, tw[0], tw[1], act="lrelu", upsample2=True,
                                                   counter="check", out=u2, route="mma"), 5),
            conv_hr=timed(lambda: tail.conv3x3(u2, tw[2], tw[3], act="lrelu", counter="check",
                                               out=hr), 5),
            conv_last=timed(lambda: tail.conv3x3(hr, tw[4], tw[5], counter="check"), 5),
        )
        del u2, hr
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
        plan = tail.tail_wgmma_plan(1, h2, w2, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        exe = plan.executed_ops()
        tiles = -(-2 * h2 // 16) * -(-2 * w2 // 28)
        exe_mma = tiles * 2 * 9 * NF * NF * (20 * 32 + 34 * 16)
        log(
            f"[k6] tail 1x{h2}x{w2}x64 -> 1x{2 * h2}x{2 * w2}x3 bf16: wgmma (new kernel) "
            f"{new_ms:.3f} ms (tail_fused_q {q_ms:.3f}; wide convs {wide / new_ms / 1e9:.1f} TFLOP/s "
            f"useful, {exe / new_ms / 1e9:.1f} executed, executed/useful {exe / wide:.3f}), K6 mma "
            f"{mma_ms:.3f} ms (executed/useful {exe_mma / wide:.3f}), K6 fma {old_ms:.3f} ms, the "
            f"chain of three K1 launches {chain_ms:.3f} ms (upconv2 {split['upconv2']:.3f} on wgmma, "
            f"{split['upconv2_mma']:.3f} on mma; conv_hr {split['conv_hr']:.3f}; conv_last "
            f"{split['conv_last']:.3f}), library (cuDNN chain of 3) {lib_ms:.3f} ms; "
            f"{chain_ms / new_ms:.2f}x the chain, {mma_ms / new_ms:.2f}x K6 mma; max |wgmma - fma| "
            f"{e_old:.3g}; largest error at every shape: {k6_stats['max_err']:.3g}, "
            f"{k6_stats['max_steps']:.2f} bf16 steps"
        )
        k6_stats.update(wgmma_ms=new_ms, tail_q_ms=q_ms, mma_ms=mma_ms, fma_ms=old_ms,
                        chain_ms=chain_ms, chain_split_ms=split, library_ms=lib_ms,
                        executed_per_useful=exe / wide)
        check(new_ms < chain_ms,
              f"[k6] the one-launch tail ({new_ms:.3f} ms) is not faster than the chain ({chain_ms:.3f})")
        check(new_ms * 3 <= old_ms,
              f"[k6] the wgmma tail ({new_ms:.3f} ms) is not 3x the fma kernel ({old_ms:.3f})")

    def phase_k4():
        """K4's tensor-core routes, dynamic and static A8: the ``wgmma`` route
        (``conv3x3_i8:wgmma``, each call's own) held ``torch.equal`` to the
        forced ``mma`` and ``dp4a`` routes and to the plain version, outputs
        and output amax: each of the five RDB convs on growth-buffer prefix
        views (pixel stride 192) and, as the wgmma route's RDB runs them, on
        x and the blocks of a c1 .. c4 tail, and an SRVGG PReLU conv, at odd
        shapes (B = 2 ragged, below one tile, one pixel past a tile column,
        more tiles than the card has SMs) and at 1x1080x1920 and 6x376x448;
        the quantiser on every finite bf16 value at 38 scales; the whole int8
        RDB at 1x1080x1920x64 and 6x376x448x64. Then wgmma beside mma (and
        dp4a) per conv, per RDB and for the SRVGG int8 body, each beside its
        bound: the larger of the bytes its launches move (bf16 in and out,
        residuals) and its int8 operations."""
        ws8, bs8, wq8, sw8 = i8_rdb(NF, GC)
        wp8 = [quant.pack_i8_weights(q) for q in wq8]
        sv, swq, ssw = i8_srvgg(1, NF)
        swp = quant.pack_i8_weights(swq[0])
        SAS = (0.0075, 0.0079, 0.0081, 0.0068, 0.0090)  # below |max| / 127: some saturate
        ROUTES = ("mma", "dp4a", "plain")

        def held(tag, run, expect, routes=ROUTES):
            """run(route) -> (out, amax or None) for route None (the call's own,
            wgmma), with the counters reset before and read after
            (``expect``), and for each of ``routes`` (forced mma and dp4a, the
            plain version), all equal bit for bit."""
            torch.cuda.synchronize()
            _build.reset_launches()
            k, ka = run(None)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == expect, f"[k4] {tag}: launches {got} != {expect}")
            for name in routes:
                o, oa = run(name)
                diff = (k.float() - o.float()).abs().max().item()
                check(torch.equal(k, o), f"[k4] {tag}: wgmma != {name} (max |diff| {diff:.3g})")
                check((ka is None and oa is None) or torch.equal(ka, oa),
                      f"[k4] {tag}: output amax {ka} != {name}'s {oa}")
            k4_stats["bit_equal_cases"] = k4_stats.get("bit_equal_cases", 0) + 1
            return k, ka

        def conv(x, segs, amax, wq, sw, b, wp, route, **kw):
            if route == "plain":
                return quant.conv3x3_i8_plain(x, segs, amax, wq, sw, b, **kw)
            return quant.conv3x3_i8(x, segs, amax, wq, sw, b, wp=wp, route=route, counter="k4", **kw)

        one = {"k4": 1, "conv3x3_i8:wgmma": 1}

        def conv_cases(shp, routes=ROUTES):
            """The five RDB convs (growth buffer and blocked) and the SRVGG
            conv at one shape, dynamic and static."""
            grow = rnd(*shp, NF + 4 * GC)
            xk = grow[..., :NF].contiguous()
            tail_t = torch.stack([grow[..., NF + GC * j:NF + GC * (j + 1)] for j in range(4)]).contiguous()
            amax = torch.stack([quant.act_amax_plain(grow[..., lo:lo + (NF if lo == 0 else GC)])
                                for lo in quant.rdb_segments(NF, GC, 5)[:5]], 1).contiguous()
            r2 = rnd(*shp, NF)
            for k_ in range(5):
                segs = quant.rdb_segments(NF, GC, k_ + 1)
                lo, cout = segs[-1], GC if k_ < 4 else NF
                for static in (False, True):
                    for blocked in (False, True):
                        def run(route, k_=k_, segs=segs, lo=lo, cout=cout, static=static,
                                blocked=blocked):
                            dst = torch.zeros_like(grow)  # written as a channel slice, pixel stride 192
                            out = dst[..., lo:lo + cout] if k_ < 4 else dst[..., :NF]
                            kw = (dict(act="lrelu") if k_ < 4 else
                                  dict(r1=grow[..., :NF], s1=0.2, r2=r2, s2=0.2))
                            if static:
                                kw.update(sas=SAS[: k_ + 1])
                            else:
                                kw.update(out_amax=torch.zeros(shp[0], device=dev))
                            a8 = None if static else amax
                            if blocked and route is None:  # x and the tail's first k_ blocks
                                out = torch.zeros(*shp, cout, dtype=bf, device=dev)
                                conv(xk, segs, a8, wq8[k_], sw8[k_], bs8[k_], wp8[k_], route,
                                     out=out, x_tail=tail_t[:k_] if k_ else None, **kw)
                            else:
                                conv(grow[..., :lo], segs, a8, wq8[k_], sw8[k_], bs8[k_], wp8[k_],
                                     route, out=out, **kw)
                            return out.contiguous(), kw.get("out_amax")

                        held(f"{shp} RDB conv{k_ + 1} {'static' if static else 'dynamic'}"
                             f"{' blocked' if blocked else ''}", run, one, routes)
            x = rnd(*shp, NF)
            ax = quant.act_amax_plain(x)[:, None].contiguous()
            for static in (False, True):
                def run(route, static=static):
                    kw = dict(act="prelu", alpha=sv[2][0])
                    kw.update(sas=(0.0079,)) if static else kw.update(out_amax=torch.zeros(shp[0], device=dev))
                    y = conv(x, (0, NF), None if static else ax, swq[0], ssw, sv[1][0], swp, route, **kw)
                    return y, kw.get("out_amax")

                held(f"{shp} SRVGG conv {'static' if static else 'dynamic'}", run, one, routes)
            log(f"[k4] {shp}: 5 RDB convs (growth buffer and blocked) and an SRVGG conv, dynamic and "
                f"static: wgmma == {' == '.join(routes)}, output amax equal")

        # (1, 5, 7) below one tile; (2, 37, 53) B = 2, ragged both ways; (1, 9, 33)
        # one pixel past a tile column; (2, 130, 150) more tiles than the card
        # has SMs; then the paths' shapes, where the plain version is the one
        # reference beside forced mma (dp4a at 1080p: the RDB below)
        for shp in ((2, 37, 53), (1, 5, 7), (1, 9, 33), (2, 130, 150)):
            conv_cases(shp)
        for shp in ((6, 376, 448), (1, H, W)):
            conv_cases(shp, ("mma", "plain"))
            torch.cuda.empty_cache()

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
            f"{n_scales} scales: wgmma's quantiser warpgroup == mma's bf16x2 quantiser == dp4a's fp32 "
            "quantiser == plain")
        k4_stats["quantiser_scales"] = n_scales
        del xq

        def rdb_bound_ms(n_px, x0):
            """The five launches' bytes (each conv's bf16 input prefix read
            once and its output written once, conv 5's r1 and, with x0, r2)
            over the card's memory rate, against the RDB's int8 operations
            over 1979 TOPS: (ms, "bytes" or "operations")."""
            nbytes = n_px * 2 * (sum(NF + k_ * GC + GC for k_ in range(4)) + 5 * NF + (NF if x0 else 0))
            ops = sum(2 * n_px * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
            t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8 * 1e3
            return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

        # each conv of the 1080p RDB alone: wgmma (x and the tail's blocks)
        # against mma (the growth buffer), in order and back
        xk = rnd(1, H, W, NF)
        grow = torch.zeros(1, H, W, NF + 4 * GC, dtype=bf, device=dev)
        grow[..., :NF] = xk
        tail_t = torch.zeros(4, 1, H, W, GC, dtype=bf, device=dev)
        out5 = torch.empty(1, H, W, NF, dtype=bf, device=dev)
        amax = torch.ones(1, 6, dtype=torch.float32, device=dev)

        def conv_k(k_, route):
            segs = quant.rdb_segments(NF, GC, k_ + 1)
            lo = segs[-1]
            kw = dict(act="lrelu") if k_ < 4 else dict(r1=xk, s1=0.2)
            if route is None:
                x_, out = xk, tail_t[k_] if k_ < 4 else out5
                kw["x_tail"] = tail_t[:k_] if k_ else None
            else:
                x_, out = grow[..., :lo], grow[..., lo:lo + GC] if k_ < 4 else out5
            conv(x_, segs, amax, wq8[k_], sw8[k_], bs8[k_], wp8[k_], route, out=out,
                 out_amax=amax[:, k_ + 1], **kw)

        per_conv = []
        for k_ in range(5):
            cin, cout = NF + k_ * GC, GC if k_ < 4 else NF
            nbytes = H * W * 2 * (cin + cout + (NF if k_ == 4 else 0))
            t_b, t_o = nbytes / PEAK_BYTES * 1e3, 2 * H * W * 9 * cin * cout / PEAK_INT8 * 1e3
            ms = {"wgmma": [], "mma": []}
            for name in ("wgmma", "mma", "mma", "wgmma"):
                ms[name].append(timed(lambda: conv_k(k_, None if name == "wgmma" else name), 10))
            w_ms, m_ms = min(ms["wgmma"]), min(ms["mma"])
            per_conv.append(dict(conv=k_ + 1, wgmma_ms=w_ms, mma_ms=m_ms, bound_ms=max(t_b, t_o),
                                 bound_by="bytes" if t_b >= t_o else "operations"))
            log(f"[k4] 1x{H}x{W} conv{k_ + 1} {cin}->{cout}: wgmma {w_ms:.3f} ms, mma {m_ms:.3f} ms "
                f"({m_ms / w_ms:.2f}x); bound {max(t_b, t_o):.3f} ms "
                f"({'bytes' if t_b >= t_o else 'operations'}), wgmma at "
                f"{100 * max(t_b, t_o) / w_ms:.0f}% of it")
        k4_stats["per_conv_1080p"] = per_conv
        del grow, tail_t, out5

        # the whole int8 RDB at the flagship and tile-batch shapes
        for tag, shp in (("1080p", (1, H, W)), ("tiles", (6, 376, 448))):
            xk = rnd(*shp, NF)
            x0 = rnd(*shp, NF) if tag == "tiles" else None
            sas_ = calibrate_rdb_act_scales(ws8, bs8, xk[:1, :128, :128])

            def rdb_run(route, static=False):
                if route == "plain":
                    return stripe.rdb_fused_i8_plain(xk, wq8, sw8, bs8, x0, sas=sas_ if static else None)
                return stripe.rdb_fused_i8(xk, wq8, sw8, bs8, x0, sas=sas_ if static else None,
                                           wp=wp8, route=route)

            five = {"rdb_fused_i8": 5, "conv3x3_i8:wgmma": 5}
            held(f"rdb_fused_i8 {shp} dynamic", rdb_run, {**five, "act_amax": 1})
            held(f"rdb_fused_i8 {shp} static", lambda r: rdb_run(r, True), five)
            ms = {"wgmma": [], "mma": [], "wgmma static": [], "mma static": []}
            for name in ("wgmma", "mma", "mma", "wgmma"):
                r_ = None if name == "wgmma" else name
                ms[name].append(timed(lambda: rdb_run(r_), 10))
                ms[name + " static"].append(timed(lambda: rdb_run(r_, True), 10))
            new_ms, mma_ms = min(ms["wgmma"]), min(ms["mma"])
            snew_ms, smma_ms = min(ms["wgmma static"]), min(ms["mma static"])
            old_ms = timed(lambda: rdb_run("dp4a"), 2)
            k1_ms = timed(lambda: stripe.rdb_fused(xk, ws8, bs8, x0), 10)
            ins = [rnd(shp[0], NF + k_ * GC, shp[1], shp[2]).contiguous(memory_format=torch.channels_last)
                   for k_ in range(5)]
            w_oihw = [w_.permute(3, 2, 0, 1).contiguous() for w_ in ws8]
            lib_ms = timed(lambda: [F.conv2d(a, w_, b_, padding=1) for a, w_, b_ in zip(ins, w_oihw, bs8)], 5)
            del ins
            bnd, by = rdb_bound_ms(shp[0] * shp[1] * shp[2], x0 is not None)
            ops = sum(2 * shp[0] * shp[1] * shp[2] * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF)
                      for k_ in range(5))
            log(
                f"[k4] rdb_fused_i8 {shp}x64{' + x0' if x0 is not None else ''}: wgmma (new kernel) "
                f"{new_ms:.3f} ms, mma {mma_ms:.3f} ms ({mma_ms / new_ms:.2f}x; wgmma "
                f"{ops / new_ms / 1e9:.1f} TOPS useful, {100 * bnd / new_ms:.0f}% of the five "
                f"launches' bound {bnd:.3f} ms, {by}); static A8: wgmma {snew_ms:.3f}, mma "
                f"{smma_ms:.3f} ms ({smma_ms / snew_ms:.2f}x); dp4a {old_ms:.3f} ms; K1's bf16 RDB "
                f"{k1_ms:.3f} ms, library (bf16 cuDNN chain of 5) {lib_ms:.3f} ms"
            )
            if tag == "1080p":
                check(new_ms < mma_ms and snew_ms < smma_ms,
                      f"[k4] the wgmma RDB ({new_ms:.3f} / {snew_ms:.3f} ms static) is not faster than "
                      f"mma's ({mma_ms:.3f} / {smma_ms:.3f})")
                check(new_ms * 3 <= old_ms,
                      f"[k4] the wgmma RDB ({new_ms:.3f} ms) is not 3x the dp4a kernel ({old_ms:.3f})")
            k4_stats.update({f"rdb_{tag}_wgmma_ms": new_ms, f"rdb_{tag}_mma_ms": mma_ms,
                             f"rdb_{tag}_dp4a_ms": old_ms, f"rdb_{tag}_static_wgmma_ms": snew_ms,
                             f"rdb_{tag}_static_mma_ms": smma_ms, f"rdb_{tag}_k1_bf16_ms": k1_ms,
                             f"rdb_{tag}_library_ms": lib_ms, f"rdb_{tag}_bound_ms": bnd,
                             f"rdb_{tag}_bound_by": by})
            del xk, x0
            torch.cuda.empty_cache()

        # the SRVGG int8 body (config 4: 32 convs at nf 64) at 1080p
        NC = 32
        sv, swq, ssw = i8_srvgg(NC, NF)
        swp = torch.stack([quant.pack_i8_weights(q) for q in swq])
        xb = rnd(1, H, W, NF)
        k_ = srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp)
        for name in ("mma", "dp4a"):
            check(torch.equal(k_, srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp, route=name)),
                  f"[k4] srvgg_body_i8 1080p: wgmma != {name}")
        check(torch.equal(k_, srvgg.srvgg_body_i8_plain(xb, swq, ssw, sv[1], sv[2])),
              "[k4] srvgg_body_i8 1080p: wgmma != plain")
        del k_
        ms = {"wgmma": [], "mma": []}
        for name in ("wgmma", "mma", "mma", "wgmma"):
            r_ = None if name == "wgmma" else name
            ms[name].append(timed(lambda: srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp, route=r_), 3))
        new_ms, mma_ms = min(ms["wgmma"]), min(ms["mma"])
        old_ms = timed(lambda: srvgg.srvgg_body_i8(xb, swq, ssw, sv[1], sv[2], swp, route="dp4a"), 1)
        bf_ms = timed(lambda: srvgg.srvgg_body(xb, *sv), 3)
        xb_nchw = xb.permute(0, 3, 1, 2)
        sv_oihw = [w_.permute(3, 2, 0, 1).contiguous() for w_ in sv[0]]

        def body_lib(f):
            for i in range(NC):
                f = F.prelu(F.conv2d(f, sv_oihw[i], sv[1][i], padding=1), sv[2][i])
            return f

        lib_ms = timed(lambda: body_lib(xb_nchw), 3)
        ops = NC * 2 * H * W * 9 * NF * NF
        # each conv reads its 64-channel input and writes its output, bf16,
        # and its input's amax pass reads the input again (the body's first
        # from the amax kernel, the others from the conv before)
        t_b, t_o = NC * H * W * 2 * (NF + NF) / PEAK_BYTES * 1e3, ops / PEAK_INT8 * 1e3
        bnd, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        log(
            f"[k4] srvgg_body_i8 1x{H}x{W}x64, 32 convs: wgmma (new kernel) {new_ms:.3f} ms, mma "
            f"{mma_ms:.3f} ms ({mma_ms / new_ms:.2f}x; wgmma {ops / new_ms / 1e9:.1f} TOPS useful, "
            f"{100 * bnd / new_ms:.0f}% of the 32 launches' bound {bnd:.3f} ms, {by}), dp4a "
            f"{old_ms:.3f} ms, K1's bf16 body {bf_ms:.3f} ms, library (bf16 cuDNN chain of 32 conv + "
            f"prelu) {lib_ms:.3f} ms; bit-equal to mma, dp4a and plain; "
            f"{k4_stats['bit_equal_cases']} cases bit-equal in all"
        )
        check(new_ms < mma_ms,
              f"[k4] the wgmma SRVGG body ({new_ms:.3f} ms) is not faster than mma's ({mma_ms:.3f})")
        k4_stats.update(srvgg_wgmma_ms=new_ms, srvgg_mma_ms=mma_ms, srvgg_dp4a_ms=old_ms,
                        srvgg_k1_bf16_ms=bf_ms, srvgg_library_ms=lib_ms, srvgg_bound_ms=bnd,
                        srvgg_bound_by=by)

    def x3_timed(order, reps):
        """{name: (first, second) ms}, ``order`` timed in turns: each
        (name, fn, reps scale) in order, then back."""
        t = {n: [] for n, _, _ in order}
        for n, fn, r in order + order[::-1]:
            t[n].append(timed(fn, max(1, reps // r)))
        return t

    def phase_k5_fp32():
        """K5's fp32 route (``"bf16x3"``, ``rdb_fused_bf16x3.cu``): one RDB
        (with and without x0) and a whole RRDB at nf 64 / gc 32 at odd shapes
        (below one tile, B = 2 ragged, a second tile column, more tiles than
        blocks) and at 1080p, each launch counted under its route,
        ``torch.equal`` to K1 ``"bf16x3"``'s five-launch chain (three and the
        residual for the RRDB) and within compare's fp32 bound of plain;
        then at 1080p the new route, the chain, forced ``"fma"``
        (``rdb_fused_f32.cu``), cuDNN's fp32 chain (TF32 off) and plain in
        turns: the RRDB at most half of fma's time and at most 1.05x the
        chain's; last the RRDB beside the chain at two small shapes
        (``torch.equal``, timed in turns)."""
        f32 = torch.float32
        w3 = [rdb_weights(NF, GC, f32) for _ in range(3)]
        ws, bs = w3[0]

        def chain(x, rdbs, x0=None):
            if rdbs == 1:
                return stripe.rdb_fused(x, ws, bs, x0)
            o = stripe.rdb_fused(x, *w3[0])
            o = stripe.rdb_fused(o, *w3[1])
            return stripe.rdb_fused(o, *w3[2], x0=x)

        st = k5_stats.setdefault("fp32", {"cases": 0, "max_err": 0.0})
        for shp in ((1, 5, 7), (2, 37, 53), (1, 20, 72), (2, 130, 150), (1, H, W)):
            x, x0 = rnd(*shp, NF, dt=f32), rnd(*shp, NF, dt=f32)
            for tag, counter, k_fn, p_fn, c_fn in (
                ("rdb_fused", "rdb_fused_k5", lambda: rdb.rdb_fused(x, ws, bs),
                 lambda: rdb.rdb_fused_plain(x, ws, bs), lambda: chain(x, 1)),
                ("rdb_fused x0", "rdb_fused_k5", lambda: rdb.rdb_fused(x, ws, bs, x0),
                 lambda: rdb.rdb_fused_plain(x, ws, bs, x0), lambda: chain(x, 1, x0)),
                ("rrdb_fused", "rrdb_fused", lambda: rdb.rrdb_fused(x, w3),
                 lambda: rdb.rrdb_fused_plain(x, w3), lambda: chain(x, 3)),
            ):
                k = one_launch(f"[k5] fp32 {tag} {shp}", k_fn, counter, route="bf16x3")
                e = compare(f"[k5] fp32 {tag} {shp}", k, p_fn(), f32)
                check(torch.equal(k, c_fn()),
                      f"[k5] fp32 {tag} {shp}: bf16x3 differs from K1's five-launch chain")
                st["cases"] += 1
                st["max_err"] = max(st["max_err"], e)
                log(f"[k5] fp32 {tag} {shp} bf16x3 err={e:.3g} == K1 chain")
                del k
        xb = rnd(1, H, W, NF, dt=f32)
        rdb_in = [rnd(1, NF + k_ * GC, H, W, dt=f32).contiguous(memory_format=torch.channels_last)
                  for k_ in range(5)]
        rdb_w = [[w_.permute(3, 2, 0, 1).contiguous() for w_ in r_[0]] for r_ in w3]
        ops = sum(2 * H * W * 9 * (NF + k_ * GC) * (GC if k_ < 4 else NF) for k_ in range(5))
        for tag, rdbs, fn, plain_fn, fma_fn in (
            ("RDB", 1, lambda: rdb.rdb_fused(xb, ws, bs), lambda: rdb.rdb_fused_plain(xb, ws, bs),
             lambda: rdb.rdb_fused(xb, ws, bs, route="fma")),
            ("RRDB", 3, lambda: rdb.rrdb_fused(xb, w3), lambda: rdb.rrdb_fused_plain(xb, w3),
             lambda: rdb.rrdb_fused(xb, w3, route="fma")),
        ):
            lib = (lambda r=rdbs: [F.conv2d(a, w_, b_, padding=1) for r_, wo in zip(w3[:r], rdb_w)
                                   for a, w_, b_ in zip(rdb_in, wo, r_[1])])
            t = x3_timed([("bf16x3", fn, 1), ("chain", lambda r=rdbs: chain(xb, r), 1),
                          ("library", lib, 1)], 6)
            new_ms, chain_ms = min(t["bf16x3"]), min(t["chain"])
            fma_ms = timed(fma_fn, 1)
            plain_ms = timed(plain_fn, 1)
            bms = 6 * rdbs * ops / PEAK_BF16 * 1e3
            log(f"[k5] fp32 {tag} 1x{H}x{W}x64: bf16x3 (one launch) {t['bf16x3'][0]:.3f} / "
                f"{t['bf16x3'][1]:.3f} ms ({rdbs * ops / new_ms / 1e9:.1f} TFLOP/s useful, "
                f"{100 * bms / new_ms:.0f}% of its bound {bms:.3f} ms: six bf16 products a MAC), "
                f"K1 bf16x3 chain of {5 * rdbs} {t['chain'][0]:.3f} / {t['chain'][1]:.3f} ms "
                f"({new_ms / chain_ms:.3f}x), fma (forced) {fma_ms:.3f} ms "
                f"({fma_ms / new_ms:.2f}x), cuDNN's fp32 chain (TF32 off) {t['library'][0]:.3f} / "
                f"{t['library'][1]:.3f} ms, plain {plain_ms:.3f} ms")
            st[tag] = dict(bf16x3_ms=t["bf16x3"], chain_ms=t["chain"], fma_ms=fma_ms,
                           library_ms=t["library"], plain_ms=plain_ms, bound_ms=bms)
            if rdbs == 3:
                check(2 * new_ms <= fma_ms,
                      f"[k5] fp32 RRDB: bf16x3 {new_ms:.3f} ms is not at most half of fma's {fma_ms:.3f}")
                check(new_ms <= 1.05 * chain_ms,
                      f"[k5] fp32 RRDB: bf16x3 {new_ms:.3f} ms is over 1.05x the chain's {chain_ms:.3f}")
                k_ = rdb.rrdb_fused(xb, w3)
                e = compare("[k5] fp32 RRDB 1080p", k_, rdb.rrdb_fused_plain(xb, w3), f32)
                del k_
                rows["rrdb_fused:bf16x3"] = dict(
                    max_abs_err=e, ms=new_ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by="operations", library_ms=min(t["library"]))
        del rdb_in, xb
        # where the 15 phases are short, so their barriers and the chain's
        # launches weigh most: the tile batch of bench_rdb and a 32x128 frame
        for shp in ((4, 384, 504), (1, 32, 128)):
            xs = rnd(*shp, NF, dt=f32)
            check(torch.equal(rdb.rrdb_fused(xs, w3), chain(xs, 3)),
                  f"[k5] fp32 RRDB {shp}: bf16x3 differs from K1's chain")
            t = x3_timed([("bf16x3", lambda: rdb.rrdb_fused(xs, w3), 1),
                          ("chain", lambda: chain(xs, 3), 1)], 20)
            log(f"[k5] fp32 RRDB {shp}: bf16x3 (one launch) {t['bf16x3'][0]:.3f} / "
                f"{t['bf16x3'][1]:.3f} ms, K1 bf16x3 chain of 15 {t['chain'][0]:.3f} / "
                f"{t['chain'][1]:.3f} ms ({min(t['bf16x3']) / min(t['chain']):.3f}x), == chain")
            st[f"RRDB {shp}"] = dict(bf16x3_ms=t["bf16x3"], chain_ms=t["chain"])
            del xs

    def phase_k6_fp32():
        """The fp32 one-launch tail (``"bf16x3"``, ``tail_fused_bf16x3.cu``)
        at nf 64: at odd shapes (B = 2 and 3 ragged, a frame narrower than
        one stripe, a last stripe of 2 columns, more stripes' rows than
        blocks) and at the flagship's 1x2160x3840x64, ``tail_fused_q``
        launches it once and it is ``torch.equal`` to the fp32 three-launch
        chain (upconv2 and conv_hr on K1 ``"bf16x3"``, conv_last on K1
        ``"narrow"``; the default fp32 ``tail_fused``), within compare's fp32
        bound of plain; then at the flagship shape the new route, the chain,
        forced K6 ``"fma"``, cuDNN's fp32 chain (TF32 off) and plain in
        turns, with each one's peak device memory: the new route at most
        half of fma's time."""
        f32 = torch.float32
        tw = tail_weights(NF, f32)
        chain_launches = {"tail_fused": 3, "conv3x3:bf16x3": 2, **LAST32}
        st = k6_stats.setdefault("fp32", {"cases": 0, "max_err": 0.0})
        for shp in ((2, 37, 53), (1, 5, 7), (1, 9, 13), (2, 100, 150), (1, 1, 61), (3, 7, 200),
                    (1, 2 * H, 2 * W)):
            x = rnd(*shp, NF, dt=f32)
            k = one_launch(f"[k6] fp32 {shp}", lambda: tail.tail_fused_q(x, *tw), "tail_fused_q",
                           route="bf16x3")
            check(k.shape == (shp[0], 2 * shp[1], 2 * shp[2], 3) and k.dtype == f32,
                  f"[k6] fp32 {shp}: shape {k.shape}")
            e = compare(f"[k6] fp32 {shp}", k, tail.tail_fused_q_plain(x, *tw), f32)
            _build.reset_launches()
            c = tail.tail_fused(x, *tw)
            torch.cuda.synchronize()
            got = _build.launches()
            check(got == chain_launches, f"[k6] fp32 {shp}: the default tail's launches {got}")
            check(torch.equal(k, c), f"[k6] fp32 {shp}: bf16x3 differs from the fp32 chain")
            st["cases"] += 1
            st["max_err"] = max(st["max_err"], e)
            log(f"[k6] fp32 {shp} bf16x3 err={e:.3g} == the fp32 chain")
            del k, c
        x2 = rnd(1, 2 * H, 2 * W, NF, dt=f32)
        up8 = rnd(1, NF, 4 * H, 4 * W, dt=f32).contiguous(memory_format=torch.channels_last)
        tw_oihw = [tw[i].permute(3, 2, 0, 1).contiguous() for i in (0, 2, 4)]

        def lib():
            f = F.conv2d(up8, tw_oihw[0], tw[1], padding=1)
            f = F.conv2d(f, tw_oihw[1], tw[3], padding=1)
            return F.conv2d(f, tw_oihw[2], tw[5], padding=1)

        peaks = {}
        for name, fn in (("bf16x3", lambda: tail.tail_fused_q(x2, *tw)),
                         ("chain", lambda: tail.tail_fused(x2, *tw))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        t = x3_timed([("bf16x3", lambda: tail.tail_fused_q(x2, *tw), 1),
                      ("chain", lambda: tail.tail_fused(x2, *tw), 1), ("library", lib, 1)], 3)
        del up8
        fma_ms = timed(lambda: tail.tail_fused_q(x2, *tw, route="fma"), 1)
        plain_ms = timed(lambda: tail.tail_fused_q_plain(x2, *tw), 1)
        new_ms, chain_ms = min(t["bf16x3"]), min(t["chain"])
        npx = 16 * H * W
        wide, last = 2 * 2 * npx * 9 * NF * NF, 2 * npx * 9 * NF * 3
        # conv_last runs on a warp of its own beside the MMAs: the larger time
        bms = max(6 * wide / PEAK_BF16, last / PEAK_FP32) * 1e3
        exe = tail.tail_x3_plan(1, 2 * H, 2 * W,
                                sms=torch.cuda.get_device_properties(dev).multi_processor_count
                                ).executed_ops()
        log(f"[k6] fp32 tail 1x{2 * H}x{2 * W}x64 -> 1x{4 * H}x{4 * W}x3: bf16x3 (one launch) "
            f"{t['bf16x3'][0]:.3f} / {t['bf16x3'][1]:.3f} ms ({wide / new_ms / 1e9:.1f} TFLOP/s useful, "
            f"{exe / new_ms / 1e9:.1f} executed (x{exe / wide:.3f}), {100 * bms / new_ms:.0f}% of its "
            f"bound {bms:.3f} ms: six bf16 products a MAC of the wide convs, conv_last's FMAs "
            f"beside them), the "
            f"fp32 chain of three K1 launches {t['chain'][0]:.3f} / {t['chain'][1]:.3f} ms "
            f"({new_ms / chain_ms:.3f}x), K6 fma (forced) {fma_ms:.3f} ms ({fma_ms / new_ms:.2f}x), "
            f"cuDNN's fp32 chain of 3 (TF32 off) {t['library'][0]:.3f} / {t['library'][1]:.3f} ms, "
            f"plain {plain_ms:.3f} ms; device memory above the input: one launch "
            f"{peaks['bf16x3']:.2f} GiB, the chain {peaks['chain']:.2f} GiB")
        st.update(bf16x3_ms=t["bf16x3"], chain_ms=t["chain"], fma_ms=fma_ms,
                  library_ms=t["library"], plain_ms=plain_ms, bound_ms=bms,
                  peak_gib=peaks, executed_per_useful=exe / wide)
        check(2 * new_ms <= fma_ms,
              f"[k6] fp32 tail: bf16x3 {new_ms:.3f} ms is not at most half of fma's {fma_ms:.3f}")
        k_ = tail.tail_fused_q(x2, *tw)
        e = compare("[k6] fp32 tail 8K", k_, tail.tail_fused_q_plain(x2, *tw), f32)
        del k_, x2
        rows["tail_fused_q:bf16x3"] = dict(
            max_abs_err=e, ms=new_ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by="operations", library_ms=min(t["library"]))

    k5_stats, k3_stats, k6_stats = {}, {}, {}
    if want("k5", "kernels"):
        with clock("k5"):
            phase_k5()
        torch.cuda.empty_cache()
        with clock("k5 fp32"):
            phase_k5_fp32()
        torch.cuda.empty_cache()
    if want("k3", "kernels"):
        with clock("k3"):
            phase_k3()
        torch.cuda.empty_cache()
    if want("k6", "kernels"):
        with clock("k6"):
            phase_k6()
        torch.cuda.empty_cache()
        with clock("k6 fp32"):
            phase_k6_fp32()
        torch.cuda.empty_cache()
    k4_stats = {}
    if want("k4", "kernels"):
        with clock("k4"):
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
                e1 = (kq.float() - tail.tail_fused(xq, *tq, route="chain").float()).abs().max().item()
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

        def windows(fn, reps, n=3):
            """n timing windows of reps calls after one warm-up call: each
            window's device ms a call (CUDA events) and host ms a call (the
            loop's own time; near the device's, the host held the card)."""
            fn()
            torch.cuda.synchronize()
            out = []
            for _ in range(n):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                t_ = time.perf_counter()
                for _ in range(reps):
                    fn()
                host = (time.perf_counter() - t_) * 1e3 / reps
                e1.record()
                torch.cuda.synchronize()
                out.append((e0.elapsed_time(e1) / reps, host))
            return out

        def record(name, shape, k_fn, p_fn, reps, nbytes, ops, peak, dt, lib_fn=None):
            e = compare(name, k_fn(), p_fn(), dt)
            # the least of three windows: a window that one stall of the
            # host or the card lengthens does not set the row
            wins = windows(k_fn, reps)
            ms = min(d for d, _ in wins)
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
                f"{'null' if lms is None else f'{lms:.3f}'} bound_ms={bms:.3f} ({by}) "
                f"windows (device/host ms a call)="
                + ", ".join(f"{d:.3f}/{h:.3f}" for d, h in wins)
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
            "conv3x3:wgmma", "conv_body+res 1x1080x1920x64 (library: F.conv2d, conv only)",
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
        wp8 = [quant.pack_i8_weights(q) for q in wq8]  # K4's tensor-core routes, as a model prepares them
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
            check(got == {"rdb_fused_i8": 5, "conv3x3_i8:wgmma": 5},
                  f"static RDB launches {got} != 5 K4 on the wgmma route and no amax")
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
        e1 = (tail.tail_fused_q(x2, *tw).float()
              - tail.tail_fused(x2, *tw, route="chain").float()).abs().max().item()
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
        xu = torch.rand(1, 4 * H, 4 * W, 3, generator=gen).to(dev)
        record(
            "unsharp_fused", "1x4320x7680x3 fp32",
            lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4),
            lambda: post.unsharp_mask(xu, 0.3, 1.5, 4), 10,
            2 * xu.numel() * 4, k2_ops(xu.numel(), 4), PEAK_FP32_UNFUSED,
            torch.float32,
        )
        # its bf16 instance (VRT_POST_DT=bf16): fp32 inside, half the bytes
        xu = xu.to(bf)
        record(
            "unsharp_fused:rows:bf16", "1x4320x7680x3 bf16",
            lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4),
            lambda: unsharp.unsharp_fused_plain(xu, 0.3, 1.5, 4), 10,
            2 * xu.numel() * 2, k2_ops(xu.numel(), 4), PEAK_FP32_UNFUSED, bf,
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
        with clock("kernels"):
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

    def make_clip(path, h, w, n, cut=None):
        """Gradient + moving box + mild noise, a hard cut before frame
        ``cut`` (by default the last)."""
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        frames = []
        for t in range(n):
            if t < (n - 1 if cut is None else cut):  # one scene
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

    kept_frames = {}  # a path's RGB kernel frames that a later path is held to

    def drive(tag, src, argv, per_call, cfg_check, expect_tiles, vs_bf16=False,
              vs_default=None, equal_default=False, post_split=False, rgb_check=False,
              min_db=45.0, keep=False, equal_to=None):
        """One main path: the CLI's config through ``VideoRestorer`` with
        the launch counters reset before and read after (the y4m sink takes
        planar I420 from the device), then the kernel path (RGB and I420
        out) on the decoded frames and the plain path on the first: the
        file's planes equal the I420 kernel path's byte for byte, and the
        RGB kernel path's first frame is held to the plain one (``min_db``:
        the least u8 PSNR, 45 dB; the fp32 paths ask 60). With ``vs_bf16``, the bf16 kernel path,
        which the int8 or fp32 output must stay within 35 dB of; with
        ``vs_default``, the name of the knob that is set, the kernel path of
        the default route without that knob, which must stay within 45 dB
        (with ``equal_default``: equal it byte for byte); with ``post_split``, the kernel path's step by stage,
        :func:`stage_split`; with ``rgb_check``, the CLI's config again with
        ``device_yuv="off"``, whose file must equal the RGB kernel path's
        frames after the y4m colour round trip. ``keep``: the RGB kernel
        frames are kept for a later path; ``equal_to``: the tag of such a
        path, whose frames this path's must equal byte for byte, in place of
        a plain run of its own."""
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
        if expect_tiles is None:  # full_frame "auto": the card's memory decides
            log(f"[{tag}] full_frame=auto took {'full frame' if grid.n_tiles == 1 else 'tiles'}: "
                f"{grid.n_tiles} tile(s) of {grid.tile_shape}")
        else:
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
        vbytes = restorer._value_bytes()
        est = tiles_mod.full_frame_bytes(h, w, s, frames=frames_, tail_in_memory=in_memory,
                                         value_bytes=vbytes)
        jax_est = tiles_mod.full_frame_bytes(h, w, s, frames=frames_)
        log(
            f"[{tag}] auto_full_frame estimate for {frames_} frame(s) of {w}x{h}: "
            f"{est / 2**30:.2f} GiB (tail intermediates in device memory: {in_memory}; "
            f"{vbytes} bytes a feature value; the JAX estimate {jax_est / 2**30:.2f}); "
            f"measured peak {peak:.2f} GiB"
            + ("" if grid.n_tiles == 1 else " (tiled: the estimate is of a full frame)")
        )
        model = restorer.model
        del restorer
        torch.cuda.empty_cache()
        outs, step_ms = {}, {}
        # the plain path (~10x the kernel path's step) runs on the first frame
        runs = [(False, cfg), ("yuv", cfg)] if equal_to else [(False, cfg), (True, cfg), ("yuv", cfg)]
        if vs_bf16:
            runs.append(("bf16", dataclasses.replace(cfg, precision="bf16")))
        if vs_default:
            runs.append(("default", cfg))
        for key, run_cfg in runs:
            # the default route runs without the knob, which the module reads
            # where it is built (VRT_PALLAS, VRT_TAIL_Q) and the step at call
            # time (VRT_POST_DT)
            knob = os.environ.pop(vs_default) if key == "default" else None
            run_frames = decoded[:1] if key is True else decoded
            try:
                ups = Upscaler(model, grid, run_cfg, dev, plain=key is True,
                               yuv420_out=key == "yuv")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if key == "yuv":  # fetched as the runner fetches: the pinned ring
                    outs[key] = []
                    for f in run_frames:
                        fetched = ups.fetch(ups.process_batch(f[None]))
                        outs[key].append(fetched.wait()[0].copy())
                        fetched.release()
                else:
                    outs[key] = [ups.process_batch(f[None])[0].cpu().numpy() for f in run_frames]
                dt_s = time.perf_counter() - t0
            finally:
                if knob is not None:
                    os.environ[vs_default] = knob
            step_ms[key] = 1e3 * dt_s / len(run_frames)
            name = {False: "kernel", True: "plain", "bf16": "bf16 kernel", "yuv": "kernel (I420 out, pinned fetch)",
                    "default": f"default (no {vs_default}) kernel"}[key]
            log(
                f"[{tag}] {name} path: "
                f"{step_ms[key]:.1f} ms/frame, {n_frames / dt_s:.4f} fps "
                "(step only, frames already decoded)"
            )
            del ups
            torch.cuda.empty_cache()
        vs_plain_db = []
        for i in range(n_frames):
            if equal_to:
                check(np.array_equal(outs[False][i], kept_frames[equal_to][i]),
                      f"[{tag}] frame {i}: not byte-equal to [{equal_to}]'s")
                log(f"[{tag}] frame {i}: byte-equal to [{equal_to}]'s kernel frame")
            elif i < len(outs[True]):
                a, b_ = outs[False][i], outs[True][i]
                psnr = psnr_u8(a, b_)
                vs_plain_db.append(psnr)
                d = np.abs(a.astype(np.int32) - b_.astype(np.int32))
                log(
                    f"[{tag}] frame {i}: kernel vs plain PSNR {psnr:.2f} dB, "
                    f"{100 * (d > 0).mean():.3f}% of values differ, max {d.max()}"
                )
                check(psnr >= min_db, f"[{tag}] frame {i}: kernel vs plain {psnr:.2f} dB < {min_db:g}")
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
        if keep:
            kept_frames[tag] = outs[False]
        if equal_to:
            del kept_frames[equal_to]
            m = path_stats[equal_to]
            log(f"[{tag}] beside [{equal_to}] (same clip and weights): step (RGB, .cpu()) "
                f"{step_ms[False]:.1f} against {m['step_ms']:.1f} ms/frame, step (I420, pinned) "
                f"{step_ms['yuv']:.1f} against {m['yuv_step_ms']:.1f}, peak {peak:.2f} against "
                f"{m['peak_gib']:.2f} GiB")
        path_stats[tag] = dict(
            wall_ms_per_frame=1e3 * st.wall_s / n_frames, fps=st.fps,
            step_ms=step_ms[False], plain_step_ms=step_ms.get(True), peak_gib=peak,
            estimate_gib=est / 2**30, vs_plain_db=vs_plain_db,
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
            pr = cfg.precision
            log(f"[{tag}] {pr} vs bf16 kernel path PSNR per frame: {', '.join(f'{d:.2f}' for d in dbs)} dB")
            check(min(dbs) >= 35.0, f"[{tag}] {pr} vs bf16 {min(dbs):.2f} dB < 35")
            path_stats[tag].update({"bf16_step_ms": step_ms["bf16"], f"{pr}_vs_bf16_db": dbs})
        if vs_default:
            dbs = [psnr_u8(a, b_) for a, b_ in zip(outs[False], outs["default"])]
            log(f"[{tag}] vs the default (no {vs_default}) kernel path PSNR per frame: {', '.join(f'{d:.2f}' for d in dbs)} dB")
            check(min(dbs) >= 45.0, f"[{tag}] vs the default route {min(dbs):.2f} dB < 45")
            same = all(np.array_equal(a, b_) for a, b_ in zip(outs[False], outs["default"]))
            log(f"[{tag}] u8 frames byte-equal to the default path's: {same}")
            check(same or not equal_default, f"[{tag}] u8 frames differ from the default path's")
            path_stats[tag].update(default_step_ms=step_ms["default"], vs_default_db=dbs)
            if "main" in path_stats:
                m = path_stats["main"]
                log(f"[{tag}] beside [main] (same weights, its own clip): step (RGB, .cpu()) "
                    f"{step_ms[False]:.1f} against {m['step_ms']:.1f} ms/frame, step (I420, pinned) "
                    f"{step_ms['yuv']:.1f} against {m['yuv_step_ms']:.1f}, peak {peak:.2f} against "
                    f"{m['peak_gib']:.2f} GiB; the default route in this run {step_ms['default']:.1f} ms/frame")
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

    def k1_routes(wgmma, mma, stem, last):
        """K1 launches per model call by route (``conv3x3_route``) and, on
        the narrow route, by kernel; no call on the fma route."""
        counts = (("conv3x3:wgmma", wgmma), ("conv3x3:mma", mma),
                  ("conv3x3:narrow", stem + last),
                  ("conv3x3:narrow stem", stem), ("conv3x3:narrow conv_last", last))
        return {k: v for k, v in counts if v}

    # per model call. K1 of an RRDBNet frame: the stem on the narrow route;
    # the dense-block convs, conv_body and up1 on the wgmma route; the tail
    # (upconv2, conv_hr, conv_last) one launch of tail_fused_wgmma.cu. A path
    # that ran on an old kernel fails its counts.
    TAIL_ONE = {"tail_fused": 1, "tail_fused:wgmma": 1}
    rrdb_call = {
        "conv3x3_fused": 2, "rdb_fused": n_rdb, "up1_fused": 1, **TAIL_ONE,
        **k1_routes(n_rdb + 2, 0, 1, 0),
    }
    srvgg_call = {
        "conv3x3_fused": 1, "srvgg_body": v3.num_conv, "srvgg_up_fused": 1,
        "srvgg_up_fused:mma": 1, **k1_routes(v3.num_conv, 0, 1, 0),
    }
    # K4 of an int8 RRDBNet frame: every RDB conv on the int8 tensor cores
    rrdb_i8_call = {
        "conv3x3_fused": 2, "act_amax": 1, "rdb_fused_i8": n_rdb,
        "conv3x3_i8:wgmma": n_rdb, "up1_fused": 1, **TAIL_ONE, **k1_routes(2, 0, 1, 0),
    }
    # the fp32 flagship: every wide conv on K1's bf16x3 route (345 dense-block
    # convs, conv_body, up1, the chain tail's upconv2 and conv_hr), the stem
    # and conv_last on narrow's fp32 instances, the tail as three K1
    # launches; no K1 launch on fma
    STEM32 = {"conv3x3:narrow": 1, "conv3x3:narrow stem": 1, "conv3x3:narrow stem:fp32": 1}
    rrdb_fp32_call = {
        "conv3x3_fused": 2, "rdb_fused": n_rdb, "up1_fused": 1, "tail_fused": 3,
        "conv3x3:bf16x3": n_rdb + 4, **STEM32, **LAST32, "conv3x3:narrow": 2,
    }
    # K2 of an enhanced frame: the sharpen stage on the rows route
    K2_ROWS = {"unsharp_fused": 1, "unsharp_fused:rows": 1, "unsharp_fused:rows:fp32": 1}
    # ... and on its bf16 instance under VRT_POST_DT=bf16
    K2_ROWS_BF16 = {"unsharp_fused": 1, "unsharp_fused:rows": 1, "unsharp_fused:rows:bf16": 1}
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

    def is_config3(c):
        # BASELINE.json config 3: --enhanced --quality max, the CLI's default
        # model; the preset's tiles (512, overlap 64), full_frame "auto"
        return (c.model_name == "RealESRGAN_x4plus" and c.enhanced_mode and c.denoise == 0.5
                and c.sharpen == 0 and c.color_enhance and c.clahe_lr and c.temporal
                and c.tile_size == 512 and c.tile_overlap == 64 and c.full_frame == "auto"
                and c.seamless and c.precision == "bf16")

    def is_tiled(precision):
        return lambda c: (c.tile_size == 512 and c.tile_overlap == 32
                          and c.full_frame == "off" and c.seamless
                          and not c.enhanced_mode and c.precision == precision)

    # (tag, clip (h, w, frames), argv, per call, config check, tiles (None:
    # full_frame "auto" decides), knobs set around it, drive's keywords)
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
          "conv3x3_i8:wgmma": v3.num_conv, "srvgg_up_fused": 1, "srvgg_up_fused:mma": 1,
          **k1_routes(0, 0, 1, 0)},
         is_config4("int8"), 1, None, dict(vs_bf16=True)),
        ("tiled_x4plus_int8", (720, 1280, 2),
         ["--model", "RealESRGAN_x4plus", "--precision", "int8"] + tiled,
         rrdb_i8_call, is_tiled("int8"), 6, None, dict(vs_bf16=True)),
        # phase 9: the VRT_PALLAS=1 body (one K5 launch per RRDB block)
        ("main_pallas", (H, W, 2), flagship + ["--precision", "bf16"],
         {"conv3x3_fused": 2, "rrdb_fused": spec.num_block,
          "rrdb_fused:wgmma": spec.num_block, "up1_fused": 1,
          **TAIL_ONE, **K2_ROWS, **k1_routes(2, 0, 1, 0)},
         is_flagship("bf16"), 1, {"VRT_PALLAS": "1"},
         dict(vs_default="VRT_PALLAS", equal_default=True)),
        # phase 10: the VRT_TAIL_Q=1 tail (one tail_fused_q launch per frame)
        ("main_tailq", (H, W, 2), flagship + ["--precision", "bf16"],
         {"conv3x3_fused": 2, "rdb_fused": n_rdb, "up1_fused": 1,
          "tail_fused_q": 1, "tail_fused_q:wgmma": 1, **K2_ROWS,
          **k1_routes(n_rdb + 2, 0, 1, 0)},
         is_flagship("bf16"), 1, {"VRT_TAIL_Q": "1"}, dict(vs_default="VRT_TAIL_Q")),
        # phase 10b: the flagship with VRT_POST_DT=bf16: the post stack in
        # bf16, K2's bf16 instance once per frame
        ("main_postbf16", (H, W, 2), flagship + ["--precision", "bf16"],
         {**rrdb_call, **K2_ROWS_BF16}, is_flagship("bf16"), 1, {"VRT_POST_DT": "bf16"},
         dict(vs_default="VRT_POST_DT")),
        # phase 10c: BASELINE.json config 3, 720p (the card may take full frame)
        ("config3", (720, 1280, 2), ["--enhanced", "--quality", "max", "--models-dir", str(models_dir)],
         rrdb_call, is_config3, None, None, {}),
        # phase 10d: BASELINE.json config 2 at its own 1080p (12 tiles)
        ("config2_1080p", (H, W, 2), ["--model", "RealESRGAN_x4plus"] + tiled,
         rrdb_call, is_tiled("bf16"), 12, None, {}),
        # phase 10e: --precision fp32, the flagship and config 4, 2 frames
        # each, held to their plain fp32 paths at 60 dB, the bf16 path beside
        ("main_fp32", (H, W, 2), flagship + ["--precision", "fp32"],
         {**rrdb_fp32_call, **K2_ROWS}, is_flagship("fp32"), 1, None,
         dict(vs_bf16=True, min_db=60.0, keep=True)),
        # phase 10f: the fp32 flagship with VRT_PALLAS=1 and VRT_TAIL_Q=1:
        # each RRDB one launch of rdb_fused_bf16x3.cu, the tail one of
        # tail_fused_bf16x3.cu; its frames byte-equal to [main_fp32]'s
        ("main_fp32_fused", (H, W, 2), flagship + ["--precision", "fp32"],
         {"conv3x3_fused": 2, "rrdb_fused": spec.num_block, "rrdb_fused:bf16x3": spec.num_block,
          "up1_fused": 1, "conv3x3:bf16x3": 2, "tail_fused_q": 1,
          "tail_fused_q:bf16x3": 1, **STEM32, **K2_ROWS},
         is_flagship("fp32"), 1, {"VRT_PALLAS": "1", "VRT_TAIL_Q": "1"},
         dict(equal_to="main_fp32")),
        ("config4_fp32", (H, W, 2), config4 + ["--precision", "fp32"],
         {"conv3x3_fused": 1, "srvgg_body": v3.num_conv, "conv3x3:bf16x3": v3.num_conv,
          "srvgg_up_fused": 1, "srvgg_up_fused:bf16x3": 1, **STEM32},
         is_config4("fp32"), 1, None, dict(vs_bf16=True, min_db=60.0)),
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
    # a path that another is held to runs where that one is asked for
    held_to = {kw_["equal_to"]: t_ for t_, *_, kw_ in PATHS if "equal_to" in kw_}
    for tag, clip, argv_, per_call, cfg_check, tiles, knob, kw in PATHS:
        if not want("paths", tag) and not (tag in held_to and want(held_to[tag])):
            continue
        if clip not in clips:
            clips[clip] = work / "in_{}x{}_{}.y4m".format(*clip)
            make_clip(clips[clip], *clip)
        os.environ.update(knob or {})
        try:
            with clock(tag):
                drive(tag, clips[clip], argv_, per_call, cfg_check, tiles, **kw)
        finally:
            for name in knob or {}:
                os.environ.pop(name)

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
        with clock("gfpgan"):
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
            # the restorer's GFPGAN runners by device: one loaded, or none
            check(any(v is not False for v in r._gfpgan.values()) == (mode == "gfpgan"),
                  f"[{tag}] the GFPGAN runners {r._gfpgan}")
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
            with clock("faces"):
                phase_faces()
        if want("paths", "outscale"):
            with clock("outscale"):
                phase_outscale()

    # ---- phase 16: fine-tuning, and --profile ------------------------------
    from video_restore_tpu_torch.models.zoo import get_model
    from video_restore_tpu_torch.training import finetune, train as train_mod
    from video_restore_tpu_torch.utils.profiling import TRACE_FILE, device_busy_share, device_trace
    from video_restore_tpu_torch.video.fixtures import synth_source_clip

    def train_card_vs_cpu(name, handle, clip, lr_rate, steps=3):
        """The same ``steps`` Adam steps of ``make_train_step`` on the card
        and on this machine's CPU from the same weights and batches
        (indices and noise drawn on the CPU, passed to ``degrade_batch``),
        TF32 off: the losses within 1e-4 relative, the first step's
        gradients within 1e-3 of each leaf's largest; returns the losses,
        the gradient error and the weights' largest difference after the
        last step."""
        hr_all = torch.from_numpy(finetune.sample_patches([str(clip)], 128, 256, handle.scale, 0))
        nets = {d: handle.train_module(d) for d in (dev, "cpu")}
        step_fns = {d: train_mod.make_train_step(n, train_mod.adam(n.parameters(), lr_rate))
                    for d, n in nets.items()}
        g = torch.Generator().manual_seed(1)
        losses = {d: [] for d in nets}
        grad_err = 0.0
        for i in range(steps):
            hr = hr_all[torch.randint(0, hr_all.shape[0], (8,), generator=g)]
            noise = torch.randn(8, 128 // handle.scale, 128 // handle.scale, 3, generator=g)
            for d, step in step_fns.items():
                lr = train_mod.degrade_batch(hr.to(d), handle.scale, noise=noise)
                losses[d].append(float(step(lr, hr.to(d))))
            if i == 0:
                cpu_params = dict(nets["cpu"].named_parameters())
                for k, p_ in nets[dev].named_parameters():
                    ref = cpu_params[k].grad
                    e = float((p_.grad.cpu() - ref).abs().max() / ref.abs().max())
                    grad_err = max(grad_err, e)
                    check(e <= 1e-3, f"[train] {name}: step 1 gradient of {k} card vs CPU {e:.3g} > 1e-3")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[dev], losses["cpu"]))
        check(rel <= 1e-4, f"[train] {name}: card vs CPU losses {losses} differ by {rel:.3g} relative")
        cpu_sd = nets["cpu"].state_dict()
        dw = max(float((v.cpu() - cpu_sd[k]).abs().max()) for k, v in nets[dev].state_dict().items())
        check(dw <= 2 * steps * lr_rate, f"[train] {name}: weights after {steps} steps differ by {dw:.3g}")
        return losses, rel, grad_err, dw

    def trace_kernels(trace):
        """ms of device time by kernel name in a ``device_trace`` file."""
        by_name = {}
        for e in json.loads(trace.read_text())["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0) / 1e3
        return by_name

    def top_kernels(by_name, n=6):
        return "; ".join(f"{k[:60]} {v:.1f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n])

    def train_step_times(handle, clip, reps=10):
        """ms per ``make_train_step`` at batch 8, patch 128, fp32 (TF32 off)
        and TF32 (CUDA events over ``reps`` steps after 2 warm-up steps, a
        fresh module each), and the peak device memory of each; then 3 fp32
        steps under ``device_trace``: the device's busy share of them and
        the kernels that take their device time."""
        hr = torch.from_numpy(finetune.sample_patches([str(clip)], 128, 8, handle.scale, 0)).to(dev)
        check(hr.shape[0] == 8, f"[train] {hr.shape[0]} patches for the timing batch")
        lr = train_mod.degrade_batch(hr, handle.scale, generator=torch.Generator(device=dev).manual_seed(0))
        from torch.utils.flop_counter import FlopCounterMode

        out = {}
        for prec, peak_rate in (("fp32", PEAK_FP32), ("tf32", PEAK_TF32)):
            net = handle.train_module(dev)
            step = train_mod.make_train_step(net, train_mod.adam(net.parameters(), 1e-4),
                                             allow_tf32=prec == "tf32")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc:  # the first warm-up step
                step(lr, hr)
            ms = timed(lambda: step(lr, hr), reps)  # the second, then the timed steps
            out[prec] = dict(ms_per_step=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             gflop=fc.get_total_flops() / 1e9,
                             bound_ms=1e3 * fc.get_total_flops() / peak_rate)
            if prec == "fp32":
                tdir = work / f"train_trace_{handle.name}"
                with device_trace(tdir):
                    for _ in range(3):
                        step(lr, hr)
                    torch.cuda.synchronize()
                out["trace"] = dict(device_busy_share(tdir / TRACE_FILE),
                                    kernels=trace_kernels(tdir / TRACE_FILE))
            del net, step
            torch.cuda.empty_cache()
        return out

    def phase_train():
        """``train``: ``finetune.main`` through its normal entry point on
        the card, 20 steps at batch 8 and patch 128 from a 6-frame 360x640
        clip of ``synth_source_clip``, for RealESRGAN_x4plus_anime_6B (the
        CLI's default: nf 64, gc 32, 6 RRDBs, seeded random weights) and
        RealESRGAN_x4_v3 (nf 64, 32 convs, config 4's seeded weights): no
        kernel launched while training, every loss finite, the ``.npz``
        loaded back through ``get_model`` equal to the trained weights, then
        served through ``VideoRestorer`` on 2 frames with the checks of
        phases 4 and 5 (the kernel path >= 45 dB against plain); the same
        three steps on the card and on the CPU (:func:`train_card_vs_cpu`);
        ms per step in fp32 and TF32 with the peak memory. Then
        ``--profile``: config 4 on 2 frames of 1080x1920 with ``--profile
        DIR``, the trace written and naming K1's kernel, and the device's
        busy share over the traced window."""
        t_phase = time.perf_counter()
        clip = work / "train_360x640.y4m"
        frames = synth_source_clip(n_frames=6, height=360, width=640)
        with Y4MWriter(clip, 640, 360, 25) as wr:
            for f in frames:
                wr.write(f)
        serve_clip = work / "train_serve_360x640.y4m"
        with Y4MWriter(serve_clip, 640, 360, 25) as wr:
            for f in frames[:2]:
                wr.write(f)
        stats = {}
        for name, short in (("RealESRGAN_x4plus_anime_6B", "x4plus_anime_6B"), ("RealESRGAN_x4_v3", "x4_v3")):
            spec_ = MODEL_ZOO[name].spec
            ft_dir = work / f"ft_{short}"
            ft_dir.mkdir()
            out_npz = ft_dir / f"{name}.npz"
            trainers = []
            fit = train_mod.Trainer.fit_patches

            def fit_and_keep(self, *a, **kw):
                trainers.append(self)
                return fit(self, *a, **kw)

            train_mod.Trainer.fit_patches = fit_and_keep
            _build.reset_launches()
            t0 = time.perf_counter()
            try:
                with contextlib.chdir(work):  # the zoo's models/: config 4's weights, no anime_6B file
                    rc = finetune.main([str(clip), "--model", name, "--steps", "20",
                                        "--patch-size", "128", "--out", str(out_npz)])
                torch.cuda.synchronize()
            finally:
                train_mod.Trainer.fit_patches = fit
            ft_s = time.perf_counter() - t0
            check(rc == 0 and out_npz.exists(), f"[train] {name}: finetune exit {rc}")
            check(_build.launches() == {}, f"[train] {name}: training launched {_build.launches()}")
            (tr,) = trainers
            check(tr.device.type == "cuda", f"[train] {name}: trained on {tr.device}")
            losses = tr.losses
            check(len(losses) == 20 and all(np.isfinite(losses)), f"[train] {name}: losses {losses}")
            served = get_model(name, ft_dir)
            params = tr.params
            check(served.state.keys() == params.keys()
                  and all(torch.equal(served.state[k], v) for k, v in params.items()),
                  f"[train] {name}: get_model of the .npz != the trained weights")
            log(f"[train] {name}: finetune.main 20 steps on {tr.device} in {ft_s:.1f}s (patch sampling, "
                f"model load and the .npz included); loss {losses[0]:.5f} -> {losses[-1]:.5f}, all "
                f"finite; no kernel launched while training; the .npz loads through get_model, equal "
                f"to the trained weights")
            if short == "x4_v3":
                per_call = srvgg_call
            else:
                n_rdb6 = 3 * spec_.num_block * 5
                per_call = {"conv3x3_fused": 2, "rdb_fused": n_rdb6, "up1_fused": 1, **TAIL_ONE,
                            **k1_routes(n_rdb6 + 2, 0, 1, 0)}
            drive(f"train_{short}", serve_clip,
                  ["--model", name, "--tile-size", "0", "--models-dir", str(ft_dir)], per_call,
                  lambda c, name=name: c.model_name == name and c.tile_size == 0, 1)
            handle = get_model(name, work / "models", allow_random=True)  # finetune's start
            t0 = time.perf_counter()
            cv_losses, rel, grad_err, dw = train_card_vs_cpu(name, handle, clip, 1e-4)
            log(f"[train] {name}: 3 steps card vs CPU (TF32 off, same batches): losses card "
                f"{', '.join(f'{v:.7f}' for v in cv_losses[dev])}, CPU "
                f"{', '.join(f'{v:.7f}' for v in cv_losses['cpu'])}, largest relative gap {rel:.3g} "
                f"(<= 1e-4); step 1 gradients: largest gap {grad_err:.3g} of a leaf's largest "
                f"(<= 1e-3); weights after 3 steps: largest gap {dw:.3g} (Adam's step 1e-4) "
                f"[{time.perf_counter() - t0:.1f}s]")
            times = train_step_times(handle, clip)
            log(f"[train] {name}: ms per train step at batch 8, patch 128 (CUDA events, 10 steps after "
                f"2 warm-up; {times['fp32']['gflop']:.1f} GFLOP per step, FlopCounterMode): "
                + "; ".join(f"{prec} {times[prec]['ms_per_step']:.3f} (bound {times[prec]['bound_ms']:.3f}, "
                            f"peak {times[prec]['peak_gib']:.2f} GiB)" for prec in ("fp32", "tf32")))
            tr_ = times["trace"]
            log(f"[train] {name}: 3 fp32 steps under the profiler: device busy {tr_['busy_ms']:.1f} of "
                f"{tr_['window_ms']:.1f} ms ({100 * tr_['share']:.2f}%; {int(tr_['events'])} kernels, copies "
                f"and memsets); top kernels (ms): {top_kernels(tr_['kernels'])}")
            stats[short] = dict(finetune_s=ft_s, losses=losses,
                                card_vs_cpu_losses=dict(card=cv_losses[dev], cpu=cv_losses["cpu"]),
                                card_vs_cpu_rel=rel, grad_rel=grad_err, weights_gap=dw, step=times)
        # --profile: config 4 on 2 frames of the flagship-size clip
        src = work / "in_profile.y4m"
        make_clip(src, H, W, 2)
        trace_dir = work / "profile"
        expected = {k: v * 2 for k, v in srvgg_call.items()}
        _, _, st, peak, _ = run_cli("profile", src, config4 + ["--profile", str(trace_dir)],
                                    expected=expected, n_frames=2, device_yuv="off")
        trace = trace_dir / TRACE_FILE
        check(trace.exists(), f"[profile] no {trace}")
        by_name = trace_kernels(trace)
        check(any("conv3x3_wgmma_kernel" in k for k in by_name),
              f"[profile] K1's conv3x3_wgmma_kernel not in the trace's kernels {sorted(by_name)[:20]}")
        busy = device_busy_share(trace)
        log(f"[profile] config 4, 2 frames {W}x{H}, --profile: {trace.stat().st_size / 2**20:.1f} MiB "
            f"trace, {len(by_name)} kernel names, K1's conv3x3_wgmma_kernel among them; device busy "
            f"{busy['busy_ms']:.1f} of {busy['window_ms']:.1f} ms traced ({100 * busy['share']:.2f}%, "
            f"idle {100 * (1 - busy['share']):.2f}%; {int(busy['events'])} kernels, copies and "
            f"memsets); wall {1e3 * st.wall_s / 2:.1f} ms/frame under the profiler; top kernels (ms): "
            f"{top_kernels(by_name)}")
        stats["profile"] = dict(busy, wall_ms_per_frame=1e3 * st.wall_s / 2, peak_gib=peak,
                                trace_mib=trace.stat().st_size / 2**20)
        stats["phase_s"] = time.perf_counter() - t_phase
        log(f"[train] phase time {stats['phase_s']:.1f}s")
        path_stats["train"] = stats

    if want("train"):
        with clock("train"):
            phase_train()


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
        with clock("io"):
            phase_io()
    if "main_tailq" in path_stats and "main" in path_stats:
        tq = path_stats["main_tailq"]
        log(
            f"[main_tailq] step {tq['step_ms']:.1f} ms/frame with VRT_TAIL_Q=1, "
            f"{tq['default_step_ms']:.1f} with the default tail mode (same run; both launch "
            f"tail_fused_wgmma.cu once a frame); peak device "
            f"memory {tq['peak_gib']:.2f} GiB, the flagship [main] {path_stats['main']['peak_gib']:.2f}"
        )

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
             {"rdb_fused": 5 * apps, "conv3x3:wgmma": 5 * apps, "rdb_fused_k5": apps,
              "rdb_fused_k5:wgmma": apps, "rrdb_fused": rrdb_apps,
              "rrdb_fused:wgmma": rrdb_apps, "rdb_fused_i8": 5 * apps,
              "conv3x3_i8:wgmma": 5 * apps, "act_amax": 1}),
            (("int8s",), {"rdb_fused_i8": 5 * apps, "conv3x3_i8:wgmma": 5 * apps}),
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
        with clock("bench"):
            phase_bench()

    # ---- phase 17: several devices and several processes --------------------
    def run_procs(tag, argvs, env_fn, timeout):
        """One process per argv, started together from the repository root
        with ``env_fn(i)``; each waited for on a thread of its own for at
        most ``timeout`` seconds, and killed after it. Returns [(rc, stdout,
        stderr, wall_s)] (each process's own wall)."""
        t0 = time.perf_counter()
        procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  cwd=REPO, env=env_fn(i)) for i, a in enumerate(argvs)]
        res = [None] * len(procs)

        def wait(i, p):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n[killed after {timeout}s]"
            res[i] = (p.returncode, out, err, time.perf_counter() - t0)

        waits = [threading.Thread(target=wait, args=(i, p)) for i, p in enumerate(procs)]
        for t in waits:
            t.start()
        for t in waits:
            t.join()
        for i, (rc, out, err, _) in enumerate(res):
            check(rc == 0, f"[{tag}] process {i} exited {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        return res

    def child_env(**kw):
        env = dict(os.environ, **kw)
        env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        return env

    def free_port():
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def restore_counted(tag, cfg, src, dst, mesh, n_frames):
        """``process_video`` over ``mesh`` with the launch counters reset
        before and read after; returns (restorer, counts, wall ms/frame,
        peak GiB)."""
        restorer = VideoRestorer(cfg, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        check(restorer.process_video(src, dst, show_progress=False), f"[{tag}] process_video failed")
        torch.cuda.synchronize()
        counts = _build.launches()
        st = restorer.last_stats
        check(st.decoded == st.inferred == st.encoded == n_frames,
              f"[{tag}] frame accounting {st.decoded}/{st.inferred}/{st.encoded}")
        for k, v in counts.items():
            total_launches[k] = total_launches.get(k, 0) + v
        return restorer, counts, 1e3 * st.wall_s / n_frames, torch.cuda.max_memory_allocated() / 2**30

    def multi_frames():
        """(a) config 4's program on ``frame_mesh(devices=[cuda:0] * 2)``:
        4 frames of 1080x1920 (two batches of D = 2), a hard cut before the
        third; the file's planes against one ``restore_step(n_shards=2)``
        call per batch on the card (same kernels); the launch counts against
        D = 1's on the same clip; a static clip (RGB out) against D = 1."""
        from video_restore_tpu_torch.parallel.dispatch import ShardedUpscaler, restore_step
        from video_restore_tpu_torch.parallel.mesh import frame_mesh

        src = work / "multi_frames.y4m"
        make_clip(src, H, W, 4, cut=2)
        cfg = config_from_args(build_parser().parse_args([str(src), "x.y4m"] + config4))
        check(is_config4("bf16")(cfg), f"[multi] config {cfg}")
        mesh2 = frame_mesh(devices=[dev, dev])
        out = {}
        # D = 1 first as a warm-up of the process (not reported), then D = 2
        # and D = 1 again
        for d, mesh in ((1, [dev]), (2, mesh2), (1, [dev])):
            r, counts, wall, peak = restore_counted(f"multi D={d}", cfg, src, work / f"multi_d{d}.y4m", mesh, 4)
            (key, ups), = r._upscalers.items()
            check(key == (H, W, True) and ups.grid.n_tiles == 1, f"[multi] D={d} bucket {key}")
            check(isinstance(ups, ShardedUpscaler) and ups.n_devices == ups.frames_per_batch == d,
                  f"[multi] D={d}: {type(ups).__name__}")
            out[d] = dict(counts=counts, wall=wall, peak=peak, planes=read_planes(work / f"multi_d{d}.y4m"),
                          grid=ups.grid, model=r.model, step_cfg=ups.step_cfg)
            del r, ups
            torch.cuda.empty_cache()
        per_frame = {k: v * 4 for k, v in srvgg_call.items()}
        check(out[1]["counts"] == per_frame, f"[multi] D=1 launch counts {out[1]['counts']} != {per_frame}")
        check(out[2]["counts"] == per_frame,
              f"[multi] D=2 launch counts {out[2]['counts']} != 2 batches x 2 x one frame's {per_frame}")
        # one restore_step(n_shards=2) call per batch, on the card, the same kernels
        net = out[2]["model"].module(torch.bfloat16, dev, "bf16")
        with Y4MReader(src) as rd:
            decoded = np.stack(list(rd))
        carry = {"frame": torch.zeros((2, 4 * H, 4 * W, 3), dtype=torch.uint8, device=dev),
                 "valid": torch.zeros(2, device=dev)}
        ref = []
        with torch.no_grad():
            for i in (0, 2):
                y, carry = restore_step(torch.from_numpy(decoded[i : i + 2]).to(dev), carry,
                                        model_apply=net, grid=out[2]["grid"], step_cfg=out[2]["step_cfg"],
                                        compute_dtype=torch.bfloat16, n_shards=2)
                ref.append(y.cpu().numpy())
        ref = np.concatenate(ref)
        del net, carry
        equal = np.array_equal(ref, out[2]["planes"])
        dbs = [psnr_u8(a, b) for a, b in zip(out[2]["planes"], ref)]
        check(equal or min(dbs) >= 45.0, f"[multi] D=2 threads vs restore_step(n_shards=2): {dbs} dB")
        vs1 = [psnr_u8(a, b) for a, b in zip(out[2]["planes"], out[1]["planes"])]
        # the static clip: the stale carry cannot matter (RGB out)
        static = work / "multi_static.y4m"
        with Y4MWriter(static, W, H, 25) as wr:
            for _ in range(4):
                wr.write(decoded[0])
        scfg = dataclasses.replace(cfg, device_yuv="off")
        stat = {}
        for d, mesh in ((1, [dev]), (2, mesh2)):
            r, counts, _, _ = restore_counted(f"multi static D={d}", scfg, static, work / f"multi_s{d}.y4m", mesh, 4)
            check(counts == per_frame, f"[multi] static D={d} launch counts {counts}")
            with Y4MReader(work / f"multi_s{d}.y4m") as rd:
                stat[d] = np.stack(list(rd))
            del r
            torch.cuda.empty_cache()
        sd = np.abs(stat[2].astype(np.int32) - stat[1].astype(np.int32))
        check(sd.max() <= 1, f"[multi] static clip D=2 vs D=1: max {sd.max()} levels")
        log(f"[multi] (a) frames, config 4, 4 frames {W}x{H} -> {4 * W}x{4 * H} (a cut before frame 3), "
            f"frame_mesh(devices=[cuda:0] * 2): the dispatch threads' planes vs one "
            f"restore_step(n_shards=2) per batch: byte-equal {equal} ({', '.join(f'{v:.2f}' for v in dbs)} dB); "
            f"vs D=1 (the stale carry: gap 3 at each batch's first frames) "
            f"{', '.join(f'{v:.2f}' for v in vs1)} dB; static clip D=2 vs D=1 (RGB out): max "
            f"{sd.max()} level(s), {100 * (sd > 0).mean():.4f}% of values differ; launches per batch: "
            f"D=2 2x D=1's (4 frames: equal, {json.dumps(out[2]['counts'])}); wall ms/frame D=2 "
            f"{out[2]['wall']:.1f}, D=1 {out[1]['wall']:.1f}; peak GiB D=2 {out[2]['peak']:.2f}, D=1 "
            f"{out[1]['peak']:.2f} (two shards on one card: the sharding's overhead, not scaling)")
        return dict(byte_equal_to_n_shards_call=equal, vs_n_shards_db=dbs, vs_d1_db=vs1,
                    static_max_level=int(sd.max()), static_share=float((sd > 0).mean()),
                    wall_ms_d2=out[2]["wall"], wall_ms_d1=out[1]["wall"],
                    peak_gib_d2=out[2]["peak"], peak_gib_d1=out[1]["peak"])

    def multi_faces():
        """(a) the face pass on frame shards: RealESRGAN_x4_v3 with
        ``--face-enhance --face-model gfpgan`` (the synthetic checkpoint;
        not enhanced, so no temporal carry and every frame its own) on 4
        frames of 720x1280 with faces (OpenCV blocked: the skin detector),
        over ``[cuda:0] * 2``, where each dispatch thread runs its frames'
        GFPGAN crops at the same time as the other, against one device, the
        files byte for byte. cuDNN's TF32 flag is at PyTorch's default (on),
        as under the CLI: the prior's fp32 forward turns it off inside
        ``utils/device.py::tf32``, whose lock keeps one thread from
        restoring it while the other's crops still launch; the flags are
        back at the defaults after both runs."""
        from video_restore_tpu_torch.parallel.dispatch import StepConfig

        h, w, n = 720, 1280, 4
        src = work / "multi_faces.y4m"
        face_clip(src, h, w, n)
        gfpgan_ckpt()
        argv = ["--model", "RealESRGAN_x4_v3", "--models-dir", str(models_dir), "--face-enhance",
                "--face-model", "gfpgan"]
        cfg = config_from_args(build_parser().parse_args([str(src), "x.y4m"] + argv))
        check(cfg.face_enhance and not StepConfig.from_config(cfg).temporal, f"[multi] faces config {cfg}")
        per_frame = {k: v * n for k, v in srvgg_call.items()}
        cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
        prev = cudnn.allow_tf32, mm.allow_tf32
        cudnn.allow_tf32, mm.allow_tf32 = True, False  # PyTorch's defaults
        res = {}
        try:
            with without_cv2():
                with Y4MReader(src) as rd:
                    n_faces = [len(faces_mod.detect_faces(f)) for f in rd]
                check(n_faces == [3, 0, 2, 3], f"[multi] faces: the skin detector found {n_faces}")
                for d in (1, 2):
                    dst = work / f"multi_faces_d{d}.y4m"
                    r, counts, wall, _ = restore_counted(f"multi faces D={d}", cfg, src, dst, [dev] * d, n)
                    check(counts == per_frame, f"[multi] faces D={d}: launch counts {counts}")
                    check(any(v is not False for v in r._gfpgan.values()), f"[multi] faces D={d}: no GFPGAN")
                    res[d] = dict(data=dst.read_bytes(), wall=wall,
                                  faces_ms=1e3 * r.last_stats.stages.get("faces", 0.0) / n)
                    del r
                    torch.cuda.empty_cache()
            flags = cudnn.allow_tf32, mm.allow_tf32
        finally:
            cudnn.allow_tf32, mm.allow_tf32 = prev
        check(flags == (True, False), f"[multi] faces: the TF32 flags after the runs {flags}")
        equal = res[2]["data"] == res[1]["data"]
        check(equal, "[multi] faces: the file of D=2 != D=1's")
        log(f"[multi] (a) faces, RealESRGAN_x4_v3 + GFPGAN (fp32 prior), 4 frames {w}x{h} with "
            f"{n_faces} faces, cuDNN TF32 on outside the prior: [cuda:0] * 2 frame shards byte-equal to "
            f"one device; TF32 flags after {flags}; wall ms/frame D=2 {res[2]['wall']:.1f}, D=1 "
            f"{res[1]['wall']:.1f}; faces stage ms/frame D=2 {res[2]['faces_ms']:.1f} (both threads), "
            f"D=1 {res[1]['faces_ms']:.1f}")
        return dict(byte_equal=equal, wall_ms_d2=res[2]["wall"], wall_ms_d1=res[1]["wall"])

    def multi_tiles():
        """(b) config 1 (RealESRGAN_x2plus, ``--quality fast --tile-size
        256``, seeded random weights) with ``--shard-mode tiles`` on
        ``[cuda:0] * 2``: 2 frames of 720x1280, byte-equal to the frames mode
        on one device; the kernel path >= 45 dB against plain on frame 0;
        the cin-12 stem on the narrow route."""
        from video_restore_tpu_torch.parallel.dispatch import ShardedUpscaler

        h, w = 720, 1280
        src = work / "multi_tiles.y4m"
        make_clip(src, h, w, 2)
        argv = ["--model", "RealESRGAN_x2plus", "--quality", "fast", "--tile-size", "256",
                "--models-dir", str(models_dir)]
        cfg_t = config_from_args(build_parser().parse_args([str(src), "x.y4m"] + argv + ["--shard-mode", "tiles"]))
        cfg_f = dataclasses.replace(cfg_t, shard_mode="frames")
        x2 = MODEL_ZOO["RealESRGAN_x2plus"].spec
        check(x2.scale == 2 and x2.num_feat == 64 and x2.num_block == 23, f"[multi] x2plus spec {x2}")
        res = {}
        for mode, cfg, mesh in (("frames", cfg_f, [dev]), ("tiles", cfg_t, [dev, dev])):
            dst = work / f"multi_out_{mode}.y4m"
            r, counts, wall, peak = restore_counted(f"multi {mode}", cfg, src, dst, mesh, 2)
            (key, ups), = r._upscalers.items()
            grid = ups.grid
            calls = 2 if mode == "tiles" else grid.n_chunks
            n_rdb2 = 3 * x2.num_block * 5
            want = {"conv3x3_fused": 2, "rdb_fused": n_rdb2, "up1_fused": 1, **TAIL_ONE,
                    **k1_routes(n_rdb2 + 2, 0, 1, 0)}
            want = {k: v * calls * 2 for k, v in want.items()}
            check(counts == want, f"[multi] {mode}: launch counts {counts} != {want}")
            check(isinstance(ups, ShardedUpscaler) and ups.n_devices == len(mesh),
                  f"[multi] {mode}: {type(ups).__name__}")
            res[mode] = dict(planes=read_planes(dst), counts=counts, wall=wall, peak=peak,
                             grid=grid, model=r.model, cfg=cfg)
            del r, ups
            torch.cuda.empty_cache()
        equal = np.array_equal(res["tiles"]["planes"], res["frames"]["planes"])
        check(equal, "[multi] tiles mode != frames mode on one device")
        with Y4MReader(src) as rd:
            f0 = next(iter(rd))
        plain = Upscaler(res["frames"]["model"], res["frames"]["grid"], cfg_f, dev, plain=True, yuv420_out=True)
        t0 = time.perf_counter()
        p0 = plain.process_batch(f0[None])[0].cpu().numpy()
        plain_s = time.perf_counter() - t0
        del plain
        torch.cuda.empty_cache()
        db = psnr_u8(res["frames"]["planes"][0], p0)
        check(db >= 45.0, f"[multi] x2plus kernel vs plain {db:.2f} dB < 45")
        g = res["tiles"]["grid"]
        log(f"[multi] (b) tiles, config 1 (RealESRGAN_x2plus, tile 256, seeded weights), 2 frames {w}x{h} -> "
            f"{2 * w}x{2 * h}, {g.n_tiles} tiles of {g.tile_shape} padded to {-(-g.n_tiles // 2) * 2} and split "
            f"over [cuda:0] * 2: byte-equal to the frames mode on one device ({res['frames']['grid'].n_chunks} "
            f"model call(s)/frame); kernel vs plain frame 0: {db:.2f} dB (plain step {plain_s:.1f} s); the "
            f"cin-12 stem on narrow: {res['tiles']['counts'].get('conv3x3:narrow stem', 0)} launches, fma "
            f"{res['tiles']['counts'].get('conv3x3:fma', 0)}; wall ms/frame tiles {res['tiles']['wall']:.1f}, "
            f"frames {res['frames']['wall']:.1f}; peak GiB {res['tiles']['peak']:.2f}, {res['frames']['peak']:.2f}")
        return dict(byte_equal=equal, kernel_vs_plain_db=db, wall_ms_tiles=res["tiles"]["wall"],
                    wall_ms_frames=res["frames"]["wall"], peak_gib_tiles=res["tiles"]["peak"],
                    peak_gib_frames=res["frames"]["peak"], n_tiles=g.n_tiles)

    def multi_hosts():
        """(c) ``--batch --multihost``: two processes on the one card (gloo,
        ``WORLD_SIZE=2``, ``RANK=0/1``) run the CLI on 4 y4m clips of 72x128
        through config 4's model; each takes 2 videos, both report 4/4, the
        outputs equal a one-process batch run's byte for byte."""
        from video_restore_tpu_torch import cli

        indir = work / "multi_in"
        indir.mkdir()
        for v in range(4):  # 3 frames each, seeded noise over a gradient
            rng = np.random.default_rng(v)
            base = np.linspace(0, 200, 128, dtype=np.float32)[None, :, None]
            with Y4MWriter(indir / f"clip{v}.y4m", 128, 72, 25) as wr:
                for _ in range(3):
                    wr.write(np.clip(base + rng.normal(0, 20, (72, 128, 3)), 0, 255).astype(np.uint8))
        flags = ["--batch"] + config4
        coord = f"127.0.0.1:{free_port()}"
        res = run_procs("multi hosts", [
            [sys.executable, "-m", "video_restore_tpu_torch.cli", str(indir), str(work / "multi_out2"),
             "--multihost", "--coordinator", coord] + flags for _ in range(2)
        ], lambda i: child_env(WORLD_SIZE="2", RANK=str(i)), timeout=300)
        for i, (_, _, err, _) in enumerate(res):
            check(f"[batch] multihost: process {i}/2 takes 2 of 4 videos" in err, f"[multi] rank {i}:\n{err[-3000:]}")
            check("batch complete: 4/4 succeeded" in err, f"[multi] rank {i} did not report 4/4:\n{err[-3000:]}")
        _build.reset_launches()
        t0 = time.perf_counter()
        check(cli.main([str(indir), str(work / "multi_out1")] + flags) == 0, "[multi] one-process batch failed")
        one_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = _build.launches()
        per_frame = {k: v * 12 for k, v in srvgg_call.items()}
        check(counts == per_frame, f"[multi] one-process batch launch counts {counts} != {per_frame}")
        for k, v in counts.items():
            total_launches[k] = total_launches.get(k, 0) + v
        names = sorted(p.name for p in (work / "multi_out1").iterdir())
        check(names == [f"clip{v}_upscaled.y4m" for v in range(4)], f"[multi] outputs {names}")
        check(sorted(p.name for p in (work / "multi_out2").iterdir()) == names, "[multi] two-process outputs")
        for n in names:
            check((work / "multi_out2" / n).read_bytes() == (work / "multi_out1" / n).read_bytes(),
                  f"[multi] {n}: two processes != one")
        walls = [r[3] for r in res]
        log(f"[multi] (c) --batch --multihost, 2 processes on the one card (gloo): each took 2 of 4 clips "
            f"(72x128, 3 frames, config 4), both reported 4/4, outputs byte-equal to one process's; walls "
            f"{walls[0]:.1f} s and {walls[1]:.1f} s (process start, CUDA init and the kernels' load "
            f"included), one in-process batch run {one_s:.1f} s")
        return dict(walls_s=walls, one_process_s=one_s)

    def multi_train():
        """(d) the sharded train step: RealESRGAN_x4_v3 (config 4's
        weights) at batch 8, patch 128, 3 Adam steps at lr 1e-4, (dp, tp) =
        (2, 1), (1, 2), (2, 2), as 2 or 4 gloo ranks sharing cuda:0
        (``tools/train_sharded.py``), each against the one-device step on
        the card from the same weights and batches (targets 0.05 to 0.25
        from the output): the losses of steps 1 and 2 within 1e-5 relative,
        step 3's within 3x the one-device step's own run-to-run gap, step-1
        gradients within 1e-4 of each leaf's largest, Adam's moments after
        step 1 (each rank's slices, gathered) within 1e-4 (``exp_avg``) and
        2e-4 (``exp_avg_sq``, a square) of each leaf's largest, weights
        within 2 x 3 x lr; ms per step beside the one-device step's. Step
        3's limit: Adam's first steps move a weight by about +-lr whatever
        its gradient's size, and cuDNN's fp32 weight gradients are not
        deterministic, so the one-device step does not repeat its own third
        loss within 1e-5 (its gaps over three runs are printed; the limit is
        3x the largest of them and of 2.11e-05, the largest an NVIDIA H100
        80GB HBM3 at 700 W showed, ``PERF.md``)."""
        from video_restore_tpu_torch.models.zoo import get_model as zoo_get
        from video_restore_tpu_torch.tools.train_sharded import make_job

        handle = zoo_get("RealESRGAN_x4_v3", models_dir)
        steps = 3
        g = torch.Generator().manual_seed(3)
        net = handle.train_module(dev)
        batches = []
        with torch.no_grad():
            for _ in range(steps):
                lr = torch.rand(8, 32, 32, 3, generator=g)
                y = net.forward_train(lr.to(dev)).cpu()
                gap = (0.05 + 0.2 * torch.rand(y.shape, generator=g)) * torch.where(
                    torch.rand(y.shape, generator=g) < 0.5, -1.0, 1.0)
                batches.append((lr, y + gap))
        del net

        def one_device(lr_rate, time_it=False):
            """The one-device step (make_train_step, as Trainer runs it) on
            the batches: losses, step-1 gradients and Adam moments, the final
            weights, ms."""
            net = handle.train_module(dev)
            opt = train_mod.adam(net.parameters(), lr_rate)
            step = train_mod.make_train_step(net, opt)
            losses = []
            for i, (lr, hr) in enumerate(batches):
                losses.append(float(step(lr.to(dev), hr.to(dev))))
                if i == 0:
                    named = list(net.named_parameters())
                    grads = {k: p.grad.detach().cpu().clone() for k, p in named}
                    moments = {m: {k: opt.state[p][m].detach().cpu().clone() for k, p in named}
                               for m in ("exp_avg", "exp_avg_sq")}
            state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
            ms = None
            if time_it:
                lr0, hr0 = (t.to(dev) for t in batches[0])
                ms = timed(lambda: step(lr0, hr0), 10)
            del net, step, opt
            torch.cuda.empty_cache()
            return losses, grads, moments, state, ms

        def rel_gaps(a, b):
            return [abs(x - y) / abs(y) for x, y in zip(a, b)]

        lr_rate = 1e-4
        one_losses, one_grads, one_moments, one_state, one_ms = one_device(lr_rate, time_it=True)
        self_gaps = [rel_gaps(one_device(lr_rate)[0], one_losses) for _ in range(2)]
        lim3 = 3 * max([2.11e-5] + [g[2] for g in self_gaps])
        log(f"[multi] (d) the one-device step against itself (three runs, 3 steps, lr {lr_rate:g}): loss "
            f"gaps per step {'; '.join(', '.join(f'{v:.3g}' for v in g) for g in self_gaps)}; step 3's "
            f"limit {lim3:.3g}")
        job = work / "multi_train_job.pt"
        torch.save(make_job(handle.spec, handle.state, lr_rate, batches), job)
        out = {"one_device_ms": one_ms, "self_gaps": self_gaps, "step3_limit": lim3}
        for dp, tp in ((2, 1), (1, 2), (2, 2)):
            n = dp * tp
            res_file = work / f"multi_train_{dp}x{tp}.pt"
            coord = f"127.0.0.1:{free_port()}"
            run_procs(f"multi train {dp}x{tp}", [
                [sys.executable, "-m", "video_restore_tpu_torch.tools.train_sharded", "--dp", str(dp),
                 "--tp", str(tp), "--job", str(job), "--backend", "gloo", "--coordinator", coord,
                 "--world-size", str(n), "--rank", str(r), "--time-steps", "10", "--out", str(res_file)]
                for r in range(n)
            ], lambda i: child_env(), timeout=300)
            res = torch.load(res_file, weights_only=True)
            gaps = rel_gaps(res["losses"], one_losses)
            rel = max(gaps)
            gerr = max(float((res["grads"][k] - v).abs().max() / v.abs().max()) for k, v in one_grads.items())
            merr = {m: max(float((res["moments"][m][k] - v).abs().max() / v.abs().max()) for k, v in t.items())
                    for m, t in one_moments.items()}
            dw = max(float((res["state"][k] - v).abs().max()) for k, v in one_state.items())
            sharded = sorted(k for k, d in res["shardings"].items() if d is not None)
            log(f"[multi] (d) train step (dp, tp) = ({dp}, {tp}), {n} gloo ranks on cuda:0, x4_v3 batch 8 "
                f"patch 128: losses {', '.join(f'{v:.7f}' for v in res['losses'])} (one device "
                f"{', '.join(f'{v:.7f}' for v in one_losses)}; relative gaps "
                f"{', '.join(f'{v:.3g}' for v in gaps)}); step-1 gradients {gerr:.3g} of a leaf's "
                f"largest, Adam's moments after step 1 {merr['exp_avg']:.3g} (exp_avg), "
                f"{merr['exp_avg_sq']:.3g} (exp_avg_sq); weights after {steps} steps {dw:.3g}; "
                f"{res['ms_per_step']:.3f} ms/step (one device {one_ms:.3f}); tp-sharded leaves: "
                f"{len(sharded)} of {len(res['shardings'])}")
            check(max(gaps[:2]) <= 1e-5 and gaps[2] <= lim3,
                  f"[multi] train {dp}x{tp}: losses {res['losses']} vs {one_losses}")
            check(gerr <= 1e-4, f"[multi] train {dp}x{tp}: step-1 gradients {gerr:.3g} > 1e-4 of a leaf's largest")
            check(merr["exp_avg"] <= 1e-4 and merr["exp_avg_sq"] <= 2e-4,
                  f"[multi] train {dp}x{tp}: Adam's moments after step 1 {merr}")
            check(dw <= 2 * steps * lr_rate, f"[multi] train {dp}x{tp}: weights differ by {dw:.3g}")
            out[f"{dp}x{tp}"] = dict(losses=res["losses"], rel=gaps, grad_rel=gerr, moments_rel=merr, weights_gap=dw,
                                     ms_per_step=res["ms_per_step"], n_sharded=len(sharded))
        return out

    def multi_exit():
        """(e) interpreter exit with live dispatch threads: 4 processes at
        once (``tools/exit_check.py``'s child), each keeping a frames-mode
        upscaler over ``[cuda:0] * 2`` alive to interpreter exit after three
        batches; each must exit 0 with no dispatch thread alive after the
        ``atexit`` finalizers (a thread stopped inside PyTorch's C++ code
        at exit aborts the process with code 134)."""
        from concurrent.futures import ThreadPoolExecutor

        from video_restore_tpu_torch.tools import exit_check

        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(lambda _: exit_check.run_one("cuda:0", str(REPO), 120.0), range(4)))
        for i, r in enumerate(res):
            check(r["ok"], f"[multi] exit, process {i}: rc {r['rc']}\n{r['out'][-500:]}\n{r['err'][-2000:]}")
        walls = [r["wall_s"] for r in res]
        log(f"[multi] (e) exit: 4 processes, each with a [cuda:0] * 2 upscaler alive at exit, exited 0 "
            f"with no dispatch thread alive after the atexit finalizers; walls "
            f"{', '.join(f'{v:.1f}' for v in walls)} s")
        return dict(walls_s=walls)

    def phase_multi():
        """``multi``: the sharded restore step (frames and tiles), the
        multi-host batch and the sharded train step on the one card."""
        t_phase = time.perf_counter()
        stats = {}
        for name, fn in (("frames", multi_frames), ("faces", multi_faces), ("tiles", multi_tiles),
                         ("multihost", multi_hosts), ("train", multi_train), ("exit", multi_exit)):
            t0 = time.perf_counter()
            stats[name] = fn()
            stats[name]["phase_s"] = time.perf_counter() - t0
        stats["phase_s"] = time.perf_counter() - t_phase
        log(f"[multi] phase time {stats['phase_s']:.1f}s ("
            + ", ".join(f"{k} {v['phase_s']:.1f}" for k, v in stats.items() if isinstance(v, dict)) + ")")
        path_stats["multi"] = stats

    if want("multi"):
        with clock("multi"):
            phase_multi()
    shutil.rmtree(work, ignore_errors=True)
    path_stats.update(k1=k1_stats, k1n=k1n_stats, k2=k2_stats, k5=k5_stats, k3=k3_stats, k6=k6_stats, k4=k4_stats)
    log(f"[paths] {json.dumps(path_stats)}")
    log("[time] phase seconds (after the build), largest first: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(phase_secs.items(), key=lambda kv: -kv[1]))
        + f"; sum {sum(phase_secs.values()):.1f}")
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

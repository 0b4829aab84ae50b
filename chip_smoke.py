#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``video_restore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from ``video_restore_tpu_torch/csrc`` (K1
   ``conv3x3.cu``, K2 ``unsharp.cu``);
3. every kernel wrapper against its plain PyTorch version on the card, in
   fp32 (tight) and bf16 (the working type), at odd shapes and at the
   flagship shapes, with kernel, plain and (where one PyTorch call computes
   the same function) library times;
4. the main path: a 3-frame 1080x1920 y4m with a hard cut before frame 3
   through ``VideoRestorer`` as the CLI builds it (RealESRGAN_x4plus at full
   width, random weights, enhanced: bilateral 0.5, CLAHE on the LR input,
   unsharp 0.3, temporal EMA; full frame; bf16) with every launch counter
   reset before and read after: 3 frames of 7680x4320 out, decoded ==
   inferred == encoded, and each wrapper launched exactly its per-frame
   count times 3;
5. the same frames through the kernel path and the plain path on the card:
   >= 45 dB PSNR on u8, and the CLI's output equal to the kernel path's
   frames after the y4m colour round trip.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Work files go to
``build/chip_smoke/`` and are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

PALLAS = {
    "conv3x3_fused": "video_restore_tpu/ops/pallas_tail.py:767",
    "rdb_fused": "video_restore_tpu/ops/pallas_stripe.py:1963",
    "up1_fused": "video_restore_tpu/ops/pallas_tail.py:603",
    "tail_fused": "video_restore_tpu/ops/pallas_tail.py:266",
    "unsharp_fused": "video_restore_tpu/ops/pallas_post.py:131",
}
SOURCE = {
    "conv3x3_fused": "video_restore_tpu_torch/csrc/conv3x3.cu",
    "rdb_fused": "video_restore_tpu_torch/csrc/conv3x3.cu",
    "up1_fused": "video_restore_tpu_torch/csrc/conv3x3.cu",
    "tail_fused": "video_restore_tpu_torch/csrc/conv3x3.cu",
    "unsharp_fused": "video_restore_tpu_torch/csrc/unsharp.cu",
}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch.nn.functional as F

    from video_restore_tpu_torch.ops import _build, post, stripe, tail, unsharp

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
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")

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
        ws, bs = rdb_weights(64, 32, dt)
        for x0 in (None, rnd(b, h, w, 64, dt=dt)):
            e = compare(
                "rdb_fused", stripe.rdb_fused(x, ws, bs, x0),
                stripe.rdb_fused_plain(x, ws, bs, x0), dt,
            )
            log(f"[check] rdb_fused {dt} {b}x{h}x{w} x0={x0 is not None} err={e:.3g}")
    for thr in (0.0, 0.02):
        xf = torch.rand(2, 37, 53, 3, generator=gen).to(dev)
        e = compare(
            "unsharp_fused", unsharp.unsharp_fused(xf, 0.3, 1.5, 4, thr),
            post.unsharp_mask(xf, 0.3, 1.5, 4, thr), torch.float32,
        )
        log(f"[check] unsharp_fused fp32 2x37x53 threshold={thr} err={e:.3g}")

    # flagship shapes, bf16 (unsharp: fp32), with times and bounds
    H, W, NF, GC = 1080, 1920, 64, 32
    bf = torch.bfloat16
    rows = {}

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

    xs = rnd(1, H, W, 3)
    ws_, bs_ = rnd(3, 3, 3, NF, scale=0.2), rnd(NF, scale=0.1)
    w_oihw = ws_.permute(3, 2, 0, 1).contiguous()
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
    e = compare(
        "conv_body", tail.conv3x3_fused(xb, wb, bb, rb),
        tail.conv3x3_fused_plain(xb, wb, bb, rb), bf,
    )
    body_ms = timed(lambda: tail.conv3x3_fused(xb, wb, bb, rb), 10)
    body_bms, _ = bound(3 * H * W * NF * 2, 2 * H * W * 9 * NF * NF, PEAK_BF16)
    log(
        f"[kernel] conv3x3_fused conv_body+res 1x1080x1920x64 err={e:.3g} "
        f"kernel_ms={body_ms:.3f} bound_ms={body_bms:.3f}"
    )
    ws, bs = rdb_weights(NF, GC, bf)
    rdb_ops = sum(2 * H * W * 9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
    rdb_wbytes = sum(w.numel() + b.numel() for w, b in zip(ws, bs)) * 2
    record(
        "rdb_fused", "1x1080x1920x64 (nf 64, gc 32)",
        lambda: stripe.rdb_fused(xb, ws, bs),
        lambda: stripe.rdb_fused_plain(xb, ws, bs), 5,
        2 * H * W * NF * 2 + rdb_wbytes, rdb_ops, PEAK_BF16, bf,
    )
    e = compare(
        "rdb_fused x0", stripe.rdb_fused(xb, ws, bs, rb),
        stripe.rdb_fused_plain(xb, ws, bs, rb), bf,
    )
    log(f"[kernel] rdb_fused with x0 (rdb3) err={e:.3g}")
    wu, bu = rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.1)
    record(
        "up1_fused", "1x1080x1920x64 -> 1x2160x3840x64",
        lambda: tail.up1_fused(xb, wu, bu),
        lambda: tail.up1_fused_plain(xb, wu, bu), 5,
        (H * W * NF + 4 * H * W * NF) * 2, 2 * H * W * 16 * NF * NF,
        PEAK_BF16, bf,
    )
    del xs, xs_nchw, rb
    x2 = tail.up1_fused(xb, wu, bu)
    tw = tail_weights(NF, bf)
    h2, w2 = 2 * H, 2 * W
    tail_ops = (
        2 * h2 * w2 * 16 * NF * NF + 2 * 4 * h2 * w2 * 9 * NF * NF
        + 2 * 4 * h2 * w2 * 9 * NF * 3
    )
    record(
        "tail_fused", "1x2160x3840x64 -> 1x4320x7680x3",
        lambda: tail.tail_fused(x2, *tw),
        lambda: tail.tail_fused_plain(x2, *tw), 3,
        (h2 * w2 * NF + 4 * h2 * w2 * 3) * 2, tail_ops, PEAK_BF16, bf,
    )
    del x2
    xu = torch.rand(1, 4 * H, 4 * W, 3, generator=gen).to(dev)
    record(
        "unsharp_fused", "1x4320x7680x3 fp32",
        lambda: unsharp.unsharp_fused(xu, 0.3, 1.5, 4),
        lambda: post.unsharp_mask(xu, 0.3, 1.5, 4), 10,
        2 * xu.numel() * 4, xu.numel() * (2 * 2 * 9 + 4), PEAK_FP32,
        torch.float32,
    )
    del xu, xb
    torch.cuda.empty_cache()

    # ---- phase 4: the main path -------------------------------------------
    from video_restore_tpu_torch.cli import build_parser, config_from_args
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.utils.logging import setup_logging
    from video_restore_tpu_torch.video.y4m import (
        Y4MReader,
        Y4MWriter,
        rgb_to_yuv_planes,
        yuv_planes_to_rgb,
    )

    setup_logging()
    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    src, dst = work / "in.y4m", work / "out.y4m"
    n_frames = 3
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for t in range(n_frames):
        if t < 2:  # one scene: gradient, moving box, mild noise
            f = np.stack([xx / W, yy / H, np.full((H, W), 0.3)], -1) * 200 + 20
            f[300:500, 400 + 40 * t : 600 + 40 * t] = (230, 60, 60)
        else:  # hard cut: another scene
            f = np.stack([(xx + yy) / (H + W), 1 - xx / W, yy / H], -1) * 120
            f[::64] = 250
        f = f + np.random.default_rng(t).normal(0, 3, f.shape)
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    with Y4MWriter(src, W, H, 25) as wr:
        for f in frames:
            wr.write(f)

    argv = [
        str(src), str(dst), "--model", "RealESRGAN_x4plus", "--enhanced",
        "--sharpen", "0.3", "--tile-size", "0", "--precision", "bf16",
        "--models-dir", str(work / "models"),
    ]
    cfg = config_from_args(build_parser().parse_args(argv))
    check(
        cfg.denoise == 0.5 and cfg.sharpen == 0.3 and cfg.color_enhance
        and cfg.clahe_lr and cfg.temporal and cfg.tile_size == 0,
        f"unexpected flagship config {cfg}",
    )
    import os

    os.environ["VRT_ALLOW_RANDOM_WEIGHTS"] = "1"
    restorer = VideoRestorer(cfg)
    spec = MODEL_ZOO["RealESRGAN_x4plus"].spec
    check(
        (spec.num_feat, spec.num_grow_ch, spec.num_block) == (64, 32, 23),
        "flagship spec",
    )
    per_frame = {
        "conv3x3_fused": 2,
        "rdb_fused": 3 * spec.num_block * 5,
        "up1_fused": 1,
        "tail_fused": 3,
        "unsharp_fused": 1,
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    ok = restorer.process_video(src, dst, show_progress=False)
    torch.cuda.synchronize()
    counts = _build.launches()
    check(ok, "VideoRestorer.process_video failed")
    st = restorer.last_stats
    check(
        st.decoded == st.inferred == st.encoded == n_frames,
        f"frame accounting {st.decoded}/{st.inferred}/{st.encoded}",
    )
    expected = {k: v * n_frames for k, v in per_frame.items()}
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    with Y4MReader(dst) as rd:
        out_frames = list(rd)
        check(
            (rd.info.width, rd.info.height) == (4 * W, 4 * H),
            f"output size {rd.info.width}x{rd.info.height}",
        )
    check(len(out_frames) == n_frames, f"{len(out_frames)} output frames")
    check(
        all(f.shape == (4 * H, 4 * W, 3) for f in out_frames), "frame shapes"
    )
    log(
        f"[main] {n_frames} frames {W}x{H} -> {4 * W}x{4 * H} in {st.wall_s:.2f}s "
        f"({st.fps:.4f} fps, {1e3 * st.wall_s / n_frames:.1f} ms/frame wall, "
        f"stages {json.dumps({k: round(v, 3) for k, v in st.stages.items()})}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    log(f"[main] launches {json.dumps(counts)}")

    # ---- phase 5: kernel path vs plain path on the card --------------------
    from video_restore_tpu_torch.ops.tiles import TileGrid
    from video_restore_tpu_torch.parallel.dispatch import Upscaler

    grid = TileGrid.build(H, W, tile=0, overlap=cfg.tile_overlap, scale=4)
    with Y4MReader(src) as rd:  # the frames the CLI decoded (y4m is 4:2:0)
        decoded = list(rd)
    outs = {}
    for plain in (False, True):
        ups = Upscaler(restorer.model, grid, cfg, dev, plain=plain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[plain] = [ups.process_batch(f[None])[0].cpu().numpy() for f in decoded]
        dt_s = time.perf_counter() - t0
        log(
            f"[path] {'plain' if plain else 'kernel'} path: "
            f"{1e3 * dt_s / n_frames:.1f} ms/frame, {n_frames / dt_s:.4f} fps "
            "(step only, frames already decoded)"
        )
        del ups
        torch.cuda.empty_cache()
    for i in range(n_frames):
        a = outs[False][i].astype(np.float64)
        b_ = outs[True][i].astype(np.float64)
        mse = float(np.mean((a - b_) ** 2))
        psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
        d = np.abs(a - b_)
        log(
            f"[path] frame {i}: kernel vs plain PSNR {psnr:.2f} dB, "
            f"{100 * (d > 0).mean():.3f}% of values differ, max {d.max():.0f}"
        )
        check(psnr >= 45.0, f"frame {i}: kernel vs plain {psnr:.2f} dB < 45")
        rt = yuv_planes_to_rgb(*rgb_to_yuv_planes(outs[False][i], "420"))
        check(
            np.array_equal(rt, out_frames[i]),
            f"frame {i}: CLI output != kernel step output after the y4m round trip",
        )
    shutil.rmtree(work, ignore_errors=True)

    # ---- result ------------------------------------------------------------
    kernels = []
    for name in ("conv3x3_fused", "rdb_fused", "up1_fused", "tail_fused", "unsharp_fused"):
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name], replaces=PALLAS[name],
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
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

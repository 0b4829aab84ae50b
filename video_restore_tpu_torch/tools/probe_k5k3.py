"""Probe of K5's and K3's tensor-core routes on the card: where the time goes.

The card's machine has no kernel profiler, so this builds
``csrc/rdb_fused_mma.cu`` and ``csrc/srvgg_up_mma.cu`` alone (seconds; the
whole library takes over a minute), each twice:

- ``full``: the kernel as shipped (checked against the plain version);
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the ``cp.async`` loads, the barriers
  and the epilogues without ``ldmatrix`` and MMAs (no valid output);

and times each build on the shapes of the paths: one RDB and one RRDB at
1x1080x1920x64 (K5) and the config-4 upsampler, 1x1080x1920x64 -> r 4 (K3).
The gap between the two builds is what the MMAs and their operand feed add
on top of the loads, barriers and epilogues.

    python -m video_restore_tpu_torch.tools.probe_k5k3 [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and,
per case, ms and TFLOP/s (useful operations) of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)))
SOURCES = ("rdb_fused_mma.cu", "srvgg_up_mma.cu")
H, W, NF, GC = 1080, 1920, 64, 32


def build_all():
    """{(source, build): loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k5k3"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        for name, defs in BUILDS:
            so = out / f"lib_{src.split('.')[0]}_{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o",
                   str(so), str(_build.CSRC / src)]
            procs.append((src, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    for src, name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} ({name}):\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line:
                print(f"[build] {src} {name}: {line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        if src == "rdb_fused_mma.cu":
            for fn in (lib.vr_rdb_fused_mma, lib.vr_rrdb_fused_mma):
                fn.argtypes = [I, I, I, P, P, P, PP, PP, I, I, I, P]
                fn.restype = I
        else:
            lib.vr_srvgg_up_mma.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
            lib.vr_srvgg_up_mma.restype = I
        libs[src, name] = lib
    return libs


def probe(reps: int = 10) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops import _build
    from video_restore_tpu_torch.ops.rdb import rdb_fused_plain, rrdb_fused_plain
    from video_restore_tpu_torch.ops.srvgg import srvgg_up_fused_plain
    from video_restore_tpu_torch.tools.bench_rdb import useful_flops

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    libs = build_all()
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, bf)

    def timed(fn):
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

    def ok(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    stream = torch.cuda.current_stream(dev).cuda_stream
    x = rnd(1, H, W, NF)
    rdbs = []
    for _ in range(3):
        ws = [rnd(3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.03) for k in range(5)]
        bs = [rnd(GC if k < 4 else NF, scale=0.05) for k in range(5)]
        rdbs.append((ws, bs))
    y, scratch = torch.empty_like(x), torch.empty_like(x)
    wp = _build.pointers([t for ws, _ in rdbs for t in ws])
    bp = _build.pointers([t for _, bs in rdbs for t in bs])

    def rdb(lib):
        ok(lib.vr_rdb_fused_mma(1, NF, GC, x.data_ptr(), None, y.data_ptr(), wp, bp,
                                1, H, W, stream), "vr_rdb_fused_mma")

    def rrdb(lib):
        ok(lib.vr_rrdb_fused_mma(1, NF, GC, x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                 wp, bp, 1, H, W, stream), "vr_rrdb_fused_mma")

    r = 4
    wo, bo = rnd(3, 3, NF, 3 * r * r, scale=0.05), rnd(3 * r * r, scale=0.1)
    xin = rnd(1, H, W, 3).abs()
    up = torch.empty(1, r * H, r * W, 3, dtype=bf, device=dev)

    def upsample(lib):
        ok(lib.vr_srvgg_up_mma(r, x.data_ptr(), wo.data_ptr(), bo.data_ptr(), xin.data_ptr(),
                               up.data_ptr(), 1, H, W, NF, stream), "vr_srvgg_up_mma")

    rdb_ops = useful_flops(1, H, W)
    cases = (
        ("rdb_fused_mma.cu", f"RDB 1x{H}x{W}x64", rdb, rdb_ops,
         lambda: rdb_fused_plain(x, *rdbs[0]), y),
        ("rdb_fused_mma.cu", f"RRDB 1x{H}x{W}x64", rrdb, 3 * rdb_ops,
         lambda: rrdb_fused_plain(x, rdbs), y),
        ("srvgg_up_mma.cu", f"upsampler 1x{H}x{W}x64 r 4", upsample, 2 * H * W * 9 * NF * 3 * r * r,
         lambda: srvgg_up_fused_plain(x, wo, bo, xin, r), up),
    )
    for src, name, fn, ops, plain, out in cases:
        fn(libs[src, "full"])
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if err > 2e-2 * scale:
            raise RuntimeError(f"{name}: max |kernel - plain| {err:.3g}")
        del ref
        line = f"[probe] {name}:"
        for build, _ in BUILDS:
            ms = timed(lambda: fn(libs[src, build]))
            line += f" {build} {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s)"
        print(line, flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10, help="timed launches per build")
    args = ap.parse_args(argv)
    try:
        probe(args.reps)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probe of K4's tensor-core route on the card: where the time goes.

The card's machine has no kernel profiler, so this builds
``csrc/conv3x3_i8_mma.cu`` alone (seconds; the whole library takes about two
minutes) three times:

- ``full``: the kernel as shipped (the RDB it runs checked bit for bit
  against the plain version, as is every build not named ``no_*``);
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the loads, the quantiser, the
  ``cp.async`` weight ring, the barriers and the epilogue without the
  ``ldmatrix`` and MMAs (no valid output);
- ``no_quant``: ``-DVR_PROBE_NO_QUANT``, the same bytes moved with the
  quantiser replaced by a byte shuffle (no valid output);

and times each build on the five dynamic-A8 convs of one int8 RDB at
1x1080x1920x64 (nf 64, gc 32: convs 1-4 write 32 channels of the growth
buffer, conv 5 writes 64), each conv alone and the five in a row, and on
one SRVGG body conv (64 -> 64, PReLU) at the same size. ``full``
minus ``no_mma`` is what the MMAs and their operand feed add on top of the
rest; ``full`` minus ``no_quant`` is the quantiser's share.

    python -m video_restore_tpu_torch.tools.probe_k4 [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line,
each build's registers and spills, and each build's ms and useful TOPS.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)), ("no_quant", ("-DVR_PROBE_NO_QUANT",)),
          ("no_store", ("-DVR_PROBE_NO_STORE",)),
          ("no_mma_load", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_LOAD")))
SOURCE = "conv3x3_i8_mma.cu"
H, W, NF, GC = 1080, 1920, 64, 32


def build_all():
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k4"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defs in BUILDS:
        so = out / f"lib_conv3x3_i8_mma_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / SOURCE)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE} ({name}):\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {SOURCE} {name}: {line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.vr_conv3x3_i8_mma.argtypes = (
            [P] * 10 + [I] * 5 + [L] * 6
            + [I, ctypes.POINTER(I), ctypes.POINTER(F), ctypes.POINTER(F), I, F, F, P]
        )
        lib.vr_conv3x3_i8_mma.restype = I
        libs[name] = lib
    return libs


def probe(reps: int = 10) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops import quant, stripe

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

    ws = [rnd(3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.03) for k in range(5)]
    bs = [rnd(GC if k < 4 else NF, scale=0.05) for k in range(5)]
    qs = [quant.quantize_conv_weights(ws[k], quant.rdb_segments(NF, GC, k + 1)) for k in range(5)]
    wq, sw = [q for q, _ in qs], [s for _, s in qs]
    wp = [quant.pack_i8_weights(q) for q in wq]
    x = rnd(1, H, W, NF)
    width = NF + 4 * GC
    grow = torch.zeros(1, H, W, width, dtype=bf, device=dev)
    grow[..., :NF] = x
    out = torch.empty(1, H, W, NF, dtype=bf, device=dev)
    amax = torch.zeros(1, 6, dtype=torch.float32, device=dev)
    quant.act_amax(x, out=amax[:, 0])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def conv(lib, k):
        segs = quant.rdb_segments(NF, GC, k + 1)
        lo = segs[-1]
        y, ys = (grow[..., lo:], width) if k < 4 else (out, NF)
        amax[:, k + 1].zero_()
        code = lib.vr_conv3x3_i8_mma(
            grow.data_ptr(), amax.data_ptr(), wp[k].data_ptr(), sw[k].data_ptr(),
            bs[k].data_ptr(), None, grow.data_ptr() if k == 4 else None, None,
            y.data_ptr(), amax[:, k + 1].data_ptr(),
            1, H, W, lo, y.shape[-1] if k == 4 else GC, width, ys,
            width if k == 4 else 0, 0, 6, 6,
            k + 1, (ctypes.c_int * 6)(*segs, *([lo] * (6 - len(segs)))), None, None,
            1 if k < 4 else 0, 0.2, 1.0, stream,
        )
        if code != 0:
            raise RuntimeError(f"vr_conv3x3_i8_mma conv{k + 1}: CUDA error {code}")

    def rdb(lib):
        for k in range(5):
            conv(lib, k)

    ref, ref_amax = stripe.rdb_fused_i8_plain(x, wq, sw, bs)
    for build, _ in BUILDS:
        if build.startswith("no_"):
            continue
        rdb(libs[build])
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(amax[:, 5], ref_amax)):
            err = (out.float() - ref.float()).abs().max().item()
            raise RuntimeError(f"RDB 1x{H}x{W}x64: {build} build != plain (max |diff| {err:.3g})")
    del ref
    ops = [2 * H * W * 9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5)]
    # one SRVGG body conv (64 -> 64, PReLU, one segment) on the RDB's input
    wv = rnd(3, 3, NF, NF, scale=0.05)
    wvq, swv = quant.quantize_conv_weights(wv, (0, NF))
    wvp, bv, alv = quant.pack_i8_weights(wvq), rnd(NF, scale=0.05), rnd(NF, scale=0.2)
    xv = grow[..., :NF].contiguous()
    av = torch.zeros(1, 2, dtype=torch.float32, device=dev)
    quant.act_amax(xv, out=av[:, 0])

    def srvgg_conv(lib):
        av[:, 1].zero_()
        code = lib.vr_conv3x3_i8_mma(
            xv.data_ptr(), av.data_ptr(), wvp.data_ptr(), swv.data_ptr(), bv.data_ptr(),
            alv.data_ptr(), None, None, out.data_ptr(), av[:, 1].data_ptr(),
            1, H, W, NF, NF, NF, NF, 0, 0, 2, 2, 1, (ctypes.c_int * 6)(0, NF, NF, NF, NF, NF),
            None, None, 2, 1.0, 1.0, stream,
        )
        if code != 0:
            raise RuntimeError(f"vr_conv3x3_i8_mma SRVGG conv: CUDA error {code}")

    for build, _ in BUILDS:
        lib = libs[build]
        line = f"[probe] {build}:"
        for k in range(5):
            ms = timed(lambda: conv(lib, k))
            line += f" conv{k + 1} {ms:.3f} ms ({ops[k] / ms / 1e9:.0f} TOPS)"
        ms = timed(lambda: rdb(lib))
        line += f"; RDB {ms:.3f} ms ({sum(ops) / ms / 1e9:.1f} TOPS useful)"
        ms = timed(lambda: srvgg_conv(lib))
        line += f"; SRVGG conv {ms:.3f} ms ({ops[0] * 2 / ms / 1e9:.0f} TOPS)"
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

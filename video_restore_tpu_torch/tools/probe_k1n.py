"""Probe of K1's narrow route on the card: where the time goes.

The card's machine has no kernel profiler, so this builds
``csrc/conv3x3_narrow.cu`` alone (seconds; the whole library takes about two
minutes) four times:

- ``full``: the kernels as shipped (checked against the plain version);
- ``no_fma``: ``-DVR_PROBE_NO_FMA``, the loads, the shared-memory stores,
  the barriers and the epilogue without the FMAs (no valid output);
- ``no_load``: ``-DVR_PROBE_NO_LOAD``, everything but the global loads of
  the input (the fp32 conv_last's stages arrive unfilled; no valid
  output);
- ``l2``: ``-DVR_PROBE_L2``, the fp32 conv_last with every copy reading one
  of the first 64 tiles' patches, 19.5 MB that stay in L2 (no valid
  output; the bf16 kernels ignore it);

and times each build on the stem, 1x1080x1920x3 -> 64, and on conv_last,
1x4320x7680x64 -> 3 and 6x1504x1792x64 -> 3, in bf16, then on conv_last at
the same shapes in fp32 (its TMA-fed instance). ``full`` minus ``no_fma``
is what the FMAs add on top of the rest; ``full`` minus ``no_load`` is what
the input's loads add; ``full`` against ``l2`` is what reading device
memory adds.

    python -m video_restore_tpu_torch.tools.probe_k1n [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and
each build's ms, fp32 TFLOP/s (useful FMAs x 2) and TB/s (each input byte
read once, each output byte written once).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

BUILDS = (("full", ()), ("no_fma", ("-DVR_PROBE_NO_FMA",)), ("no_load", ("-DVR_PROBE_NO_LOAD",)),
          ("l2", ("-DVR_PROBE_L2",)))
SOURCE = "conv3x3_narrow.cu"
# (tag, B, H, W, cin, cout, dtype)
CASES = (("stem", 1, 1080, 1920, 3, 64, torch.bfloat16),
         ("conv_last", 1, 4320, 7680, 64, 3, torch.bfloat16),
         ("conv_last tiles", 6, 1504, 1792, 64, 3, torch.bfloat16),
         ("conv_last fp32", 1, 4320, 7680, 64, 3, torch.float32),
         ("conv_last tiles fp32", 6, 1504, 1792, 64, 3, torch.float32))


def build_all():
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k1n"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defs in BUILDS:
        so = out / f"lib_conv3x3_narrow_{name}.so"
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
        lib.vr_conv3x3_narrow.argtypes = ([I] + [P] * 7 + [I] * 5 + [L] * 4 + [I, I, F, F, P]
                                          + [ctypes.POINTER(L), I])
        lib.vr_conv3x3_narrow.restype = I
        libs[name] = lib
    return libs


def probe(reps: int = 10) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import conv3x3_plain, last32_plan

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    libs = build_all()
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dt=torch.bfloat16):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, dt)

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

    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, b, h, w, cin, cout, dt in CASES:
        x = rnd(b, h, w, cin, dt=dt)
        wt, bias = rnd(3, 3, cin, cout, scale=0.05, dt=dt), rnd(cout, scale=0.1, dt=dt)
        y = torch.empty(b, h, w, cout, dtype=dt, device=dev)
        f32 = dt == torch.float32
        plan = last32_plan(x.shape, cin, sms=sms).array() if f32 else None

        def conv(lib):
            code = lib.vr_conv3x3_narrow(
                0 if f32 else 1, x.data_ptr(), wt.data_ptr(), bias.data_ptr(), None, None, None,
                y.data_ptr(), b, h, w, cin, cout, cin, cout, 0, 0, 0, 0, 1.0, 1.0, stream,
                plan, 0 if plan is None else len(plan))
            if code != 0:
                raise RuntimeError(f"vr_conv3x3_narrow: CUDA error {code}")

        conv(libs["full"])
        torch.cuda.synchronize()
        ref = conv3x3_plain(x, wt, bias)
        err = (y.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        del ref
        if err > (1e-4 if f32 else 2e-2) * scale:
            raise RuntimeError(f"{tag}: max |kernel - plain| {err:.3g}")
        flops = 2 * b * h * w * 9 * cin * cout
        nbytes = (b * h * w * (cin + cout) + 9 * cin * cout + cout) * x.element_size()
        line = f"[probe] {tag} {b}x{h}x{w}x{cin}->{cout} (err {err:.3g}; bytes {nbytes / 3.35e9:.3f} ms):"
        for build, _ in BUILDS:
            ms = timed(lambda: conv(libs[build]))
            line += (f" {build} {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                     f"{nbytes / ms / 1e9:.2f} TB/s)")
        print(line, flush=True)
        del x, y
        torch.cuda.empty_cache()


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

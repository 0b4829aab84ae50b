"""Probe of K2 on the card: where the time of each of its kernels goes.

The card's machine has no kernel profiler, so this builds each of K2's two
sources alone (seconds each; the whole library takes about two minutes),
all in parallel:

- ``tile full``: ``csrc/unsharp.cu`` as shipped (the old kernel);
- ``tile no_math``: ``-DVR_PROBE_NO_MATH``, its staging, barriers and index
  decode without the taps (it stores the centre value);
- ``tile const_decode``: ``-DVR_PROBE_CONST_DECODE``, as shipped but with C
  and the radius compiled in (3 and 4, the probe's), so the index decode
  divides by constants: what the runtime divisions cost;
- ``rows full``: ``csrc/unsharp_rows.cu`` as shipped (the new kernel);
- ``rows no_math``: ``-DVR_PROBE_NO_MATH``, its ring, window, barrier and
  stores without the taps;

and times each at the flagship's 1x4320x7680x3 fp32 (radius 4, sigma 1.5,
amount 0.3), beside ``dst.copy_(src)`` of the same frame (one read and one
write of its bytes, the card's practical floor). The two ``full`` builds
are checked to be equal bit for bit.

    python -m video_restore_tpu_torch.tools.probe_k2 [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and
each build's ms and TB/s (the frame read once and written once).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

# (build, source, entry point, defines)
BUILDS = (
    ("tile full", "unsharp.cu", "vr_unsharp", ()),
    ("tile no_math", "unsharp.cu", "vr_unsharp", ("-DVR_PROBE_NO_MATH",)),
    ("tile const_decode", "unsharp.cu", "vr_unsharp", ("-DVR_PROBE_CONST_DECODE",)),
    ("rows full", "unsharp_rows.cu", "vr_unsharp_rows", ()),
    ("rows no_math", "unsharp_rows.cu", "vr_unsharp_rows", ("-DVR_PROBE_NO_MATH",)),
)
SHAPE = (1, 4320, 7680, 3)
RADIUS, SIGMA, AMOUNT = 4, 1.5, 0.3


def build_all():
    """{build: its entry point}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k2"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, entry, defs in BUILDS:
        so = out / f"lib_{name.replace(' ', '_')}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / source)]
        procs.append((name, source, entry, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, source, entry, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} ({name}):\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}", flush=True)
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = [P, P, I, I, I, I, I, ctypes.POINTER(F), F, F, P]
        fn.restype = I
        fns[name] = fn
    return fns


def probe(reps: int = 20) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.post import _gaussian_kernel1d, unsharp_mask

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    fns = build_all()
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(*SHAPE, generator=gen).to(dev)
    y = torch.empty_like(x)
    taps = (ctypes.c_float * (2 * RADIUS + 1))(*[float(t) for t in _gaussian_kernel1d(SIGMA, RADIUS)])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn):
        code = fn(x.data_ptr(), y.data_ptr(), *SHAPE, RADIUS, taps, AMOUNT, 0.0, stream)
        if code != 0:
            raise RuntimeError(f"K2 probe launch: CUDA error {code}")

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

    call(fns["tile full"])
    old = y.clone()
    call(fns["rows full"])
    torch.cuda.synchronize()
    if not torch.equal(old, y):
        raise RuntimeError("rows full != tile full")
    err = (y - unsharp_mask(x, AMOUNT, SIGMA, RADIUS)).abs().max().item()
    del old
    nbytes = 2 * x.numel() * 4
    line = f"[probe] {'x'.join(map(str, SHAPE))} fp32 r={RADIUS} (rows == tile, err vs plain {err:.3g}):"
    for name, *_ in BUILDS:
        ms = timed(lambda: call(fns[name]))
        line += f" {name} {ms:.3f} ms ({nbytes / ms / 1e9:.2f} TB/s);"
    ms = timed(lambda: y.copy_(x))
    line += f" dst.copy_(src) {ms:.3f} ms ({nbytes / ms / 1e9:.2f} TB/s)"
    print(line, flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed launches per build")
    args = ap.parse_args(argv)
    try:
        probe(args.reps)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

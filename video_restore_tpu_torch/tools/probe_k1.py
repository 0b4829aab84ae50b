"""Probe of K1's tensor-core route on the card: where one conv's time goes.

The card's machine has no kernel profiler, so this builds
``csrc/conv3x3_mma.cu`` alone (a few seconds; the whole library takes over a
minute) four times, with the source's two probe switches, and times each
build on the convs of a flagship frame:

- ``full``: the kernel as shipped (checked against the plain version);
- ``no_store``: ``-DVR_PROBE_NO_STORE``, all the work but the output stores;
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the ``cp.async`` ring, its barriers and
  the epilogue, without ``ldmatrix`` and MMAs;
- ``loads``: both switches: what the load pipeline alone costs.

The probe builds compute no valid output; only ``full`` is checked.

    python -m video_restore_tpu_torch.tools.probe_k1 [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and,
per conv, ms and useful TFLOP/s of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

BUILDS = (
    ("full", ()),
    ("no_store", ("-DVR_PROBE_NO_STORE",)),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("loads", ("-DVR_PROBE_NO_STORE", "-DVR_PROBE_NO_MMA")),
)
H, W = 1080, 1920


def build_all():
    """The four builds of ``conv3x3_mma.cu`` as loaded libraries."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k1"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defs in BUILDS:
        so = out / f"libk1_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / "conv3x3_mma.cu")]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.vr_conv3x3_mma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_void_p]
        lib.vr_conv3x3_mma.restype = ctypes.c_int
        libs[name] = lib
    return libs


def probe(reps: int = 10) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import conv3x3_plain

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

    def launch(lib, x, w, b, out, up2):
        bsz, h, wd, cin = x.shape
        code = lib.vr_conv3x3_mma(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None, None, None, out.data_ptr(),
            bsz, h, wd, cin, w.shape[-1], x.stride(2), out.stride(2), 0, 0,
            1, int(up2), 1.0, 1.0, torch.cuda.current_stream(dev).cuda_stream,
        )
        if code != 0:
            raise RuntimeError(f"conv3x3_mma launch: CUDA error {code}")

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

    # the flagship frame's convs: the five of an RDB on its growth buffer,
    # a 64 -> 64 conv (conv_body, the SRVGG body), up1 and upconv2
    grow = rnd(1, H, W, 192)
    gout = torch.empty_like(grow)
    x64, x2 = rnd(1, H, W, 64), rnd(1, 2 * H, 2 * W, 64)
    cases = [
        (f"RDB conv{k + 1} {lo}->32 1x{H}x{W}", grow[..., :lo], 32, gout[..., lo : lo + 32], False)
        for k, lo in enumerate((64, 96, 128, 160))
    ] + [
        (f"RDB conv5 192->64 1x{H}x{W}", grow, 64, None, False),
        (f"64->64 1x{H}x{W}", x64, 64, None, False),
        (f"up1 64->64 1x{H}x{W} -> {2 * H}x{2 * W}", x64, 64, None, True),
        (f"upconv2 64->64 1x{2 * H}x{2 * W} -> {4 * H}x{4 * W}", x2, 64, None, True),
    ]
    for name, x, cout, out, up2 in cases:
        bsz, h, wd, cin = x.shape
        oh, ow = (2 * h, 2 * wd) if up2 else (h, wd)
        if out is None:
            out = torch.empty(bsz, oh, ow, cout, dtype=bf, device=dev)
        w, b = rnd(3, 3, cin, cout, scale=0.03), rnd(cout, scale=0.05)
        ops = 2 * bsz * oh * ow * 9 * cin * cout
        launch(libs["full"], x, w, b, out, up2)
        torch.cuda.synchronize()
        if oh * ow <= 2 * H * 2 * W:  # the plain 8K conv needs 17 GB of fp32
            ref = conv3x3_plain(x, w, b, act="lrelu", upsample2=up2)
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            if err > 2e-2 * scale:
                raise RuntimeError(f"{name}: max |kernel - plain| {err:.3g}")
            del ref
        line = f"[probe] {name}:"
        for build, _ in BUILDS:
            ms = timed(lambda: launch(libs[build], x, w, b, out, up2))
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

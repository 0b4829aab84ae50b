"""Probe of K6's tensor-core route on the card: where the time goes.

The card's machine has no kernel profiler, so this builds
``csrc/tail_fused_mma.cu`` alone (seconds; the whole library takes about two
minutes) three times:

- ``full``: the kernel as shipped (checked against the plain version);
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the ``cp.async`` loads, the barriers,
  the epilogues and conv_last without the wide convs' ``ldmatrix`` and MMAs
  (no valid output);
- ``no_last``: ``-DVR_PROBE_NO_LAST``, everything but conv_last (no output);

and times each build on the flagship's tail, 1x2160x3840x64 -> 1x4320x7680x3
in bf16. ``full`` minus ``no_mma`` is what the MMAs and their operand feed
add on top of the rest; ``full`` minus ``no_last`` is conv_last's share.

    python -m video_restore_tpu_torch.tools.probe_k6 [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and
each build's ms and TFLOP/s (useful operations of the two wide convs, as
9-tap convs on the fine grid).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Optional, Sequence

import torch

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)), ("no_last", ("-DVR_PROBE_NO_LAST",)))
SOURCE = "tail_fused_mma.cu"
H2, W2, NF = 2160, 3840, 64


def build_all():
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k6"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defs in BUILDS:
        so = out / f"lib_tail_fused_mma_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / SOURCE)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE} ({name}):\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {SOURCE} {name}: {line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.vr_tail_fused_mma.argtypes = [I, I] + [P] * 8 + [I, I, I, P]
        lib.vr_tail_fused_mma.restype = I
        libs[name] = lib
    return libs


def probe(reps: int = 10) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import tail_fused_q_plain

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

    stream = torch.cuda.current_stream(dev).cuda_stream
    x = rnd(1, H2, W2, NF)
    tw = [rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, 3, scale=0.05), rnd(3, scale=0.05)]
    y = torch.empty(1, 2 * H2, 2 * W2, 3, dtype=bf, device=dev)

    def tail(lib):
        code = lib.vr_tail_fused_mma(1, NF, x.data_ptr(), y.data_ptr(),
                                     *(t.data_ptr() for t in tw), 1, H2, W2, stream)
        if code != 0:
            raise RuntimeError(f"vr_tail_fused_mma: CUDA error {code}")

    tail(libs["full"])
    torch.cuda.synchronize()
    ref = tail_fused_q_plain(x, *tw)
    err = (y.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    del ref
    if err > 2e-2 * scale:
        raise RuntimeError(f"tail 1x{H2}x{W2}x64: max |kernel - plain| {err:.3g}")
    ops = 2 * 2 * (4 * H2 * W2) * 9 * NF * NF
    line = f"[probe] tail 1x{H2}x{W2}x64 (err {err:.3g}):"
    for build, _ in BUILDS:
        ms = timed(lambda: tail(libs[build]))
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

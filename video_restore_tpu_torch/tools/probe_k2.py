"""Probe of K2 on the card: where the time of each of its kernels goes.

The card's machine has no kernel profiler, so this builds each of K2's
sources alone (seconds each; the whole library takes minutes), all in
parallel, for one element type (``--dtype``, fp32 by default):

- ``tile full``: ``csrc/unsharp.cu`` as shipped (the old kernel);
- ``tile no_math`` (fp32 only): ``-DVR_PROBE_NO_MATH``, its staging,
  barriers and index decode without the taps (it stores the centre value);
- ``tile const_decode`` (fp32 only): ``-DVR_PROBE_CONST_DECODE``, as
  shipped but with C and the radius compiled in (3 and 4, the probe's), so
  the index decode divides by constants: what the runtime divisions cost;
- ``rows full``: the rows kernel as shipped (``csrc/unsharp_rows.cu`` for
  fp32, ``csrc/unsharp_rows_bf16.cu`` for bf16, both on
  ``unsharp_rows.cuh``);
- ``rows no_math``: ``-DVR_PROBE_NO_MATH``, its ring, window, barrier and
  stores without the taps;

and times each at the flagship's 1x4320x7680x3 (radius 4, sigma 1.5,
amount 0.3), beside ``dst.copy_(src)`` of the same frame (one read and one
write of its bytes, the card's practical floor), twice: in the order above
and back. Every build but the ``no_math`` and ``const_decode`` ones is
checked equal to ``tile full`` bit for bit.

    python -m video_restore_tpu_torch.tools.probe_k2 [--dtype fp32|bf16] [--reps N]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line,
each rows build's registers at the probe's radius (``ptxas``) and resident
blocks per SM, and each build's ms and TB/s (the frame read once and
written once).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

SHAPE = (1, 4320, 7680, 3)
RADIUS, SIGMA, AMOUNT = 4, 1.5, 0.3
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# builds that compute something else than the kernel's function
NOT_EQUAL = ("no_math", "const_decode")


def builds(dtype: str) -> List[Tuple[str, Path, str, Tuple[str, ...]]]:
    """(build, source, entry point, defines) for ``dtype``."""
    from video_restore_tpu_torch.ops import _build

    sfx = "_bf16" if dtype == "bf16" else ""
    tile, rows = _build.CSRC / "unsharp.cu", _build.CSRC / f"unsharp_rows{sfx}.cu"
    out = [("tile full", tile, f"vr_unsharp{sfx}", ())]
    if dtype == "fp32":
        out += [("tile no_math", tile, "vr_unsharp", ("-DVR_PROBE_NO_MATH",)),
                ("tile const_decode", tile, "vr_unsharp", ("-DVR_PROBE_CONST_DECODE",))]
    out += [("rows full", rows, f"vr_unsharp_rows{sfx}", ()),
            ("rows no_math", rows, f"vr_unsharp_rows{sfx}", ("-DVR_PROBE_NO_MATH",))]
    return out


def _ptxas_lines(name: str, text: str) -> List[str]:
    """The registers and spill lines of the rows kernel at the probe's
    radius (every line of a tile build: it has one kernel)."""
    out, entry, spill = [], "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill" in line:
            spill = line.split(",", 1)[-1].strip()
        elif "registers" in line:
            if "unsharp_rows_kernel" in entry and f"Li3ELi{RADIUS}EE" not in entry:
                continue
            out.append(f"[build] {name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


def build_all(specs):
    """{build: (its entry point, its library)}, every build compiled in
    parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k2"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, entry, defs in specs:
        so = out / f"lib_{name.replace(' ', '_')}_{entry}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so), str(source)]
        procs.append((name, source, entry, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, source, entry, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} ({name}):\n{text[-4000:]}")
        for line in _ptxas_lines(name, text):
            print(line, flush=True)
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = [P, P, I, I, I, I, I, ctypes.POINTER(F), F, F, P]
        fn.restype = I
        fns[name] = (fn, lib)
    return fns


def blocks_per_sm(lib, entry: str) -> Tuple[int, int]:
    """(registers, blocks per SM) from a rows build's info entry point."""
    fn = getattr(lib, f"{entry}_info")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    if fn(RADIUS, ctypes.byref(regs), ctypes.byref(blocks)) != 0:
        raise RuntimeError(f"{entry}_info: CUDA error")
    return regs.value, blocks.value


def probe(dtype: str = "fp32", reps: int = 20) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.post import _gaussian_kernel1d
    from video_restore_tpu_torch.ops.unsharp import unsharp_fused_plain

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = builds(dtype)
    fns = build_all(specs)
    for name, _, entry, _ in specs:
        if name.startswith("rows"):
            regs, blocks = blocks_per_sm(fns[name][1], entry)
            print(f"[occupancy] {name} r={RADIUS}: {regs} registers a thread, "
                  f"{blocks} blocks per SM", flush=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(*SHAPE, generator=gen).to(dev, DTYPES[dtype])
    y = torch.empty_like(x)
    taps = (ctypes.c_float * (2 * RADIUS + 1))(*[float(t) for t in _gaussian_kernel1d(SIGMA, RADIUS)])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(name):
        code = fns[name][0](x.data_ptr(), y.data_ptr(), *SHAPE, RADIUS, taps, AMOUNT, 0.0, stream)
        if code != 0:
            raise RuntimeError(f"K2 probe launch ({name}): CUDA error {code}")

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

    call("tile full")
    ref = y.clone()
    for name, *_ in specs:
        if name != "tile full" and not name.endswith(NOT_EQUAL):
            call(name)
            torch.cuda.synchronize()
            if not torch.equal(ref, y):
                raise RuntimeError(f"{name} != tile full")
    err = (ref.float() - unsharp_fused_plain(x, AMOUNT, SIGMA, RADIUS).float()).abs().max().item()
    del ref
    nbytes = 2 * x.numel() * x.element_size()
    order = [name for name, *_ in specs] + ["dst.copy_(src)"]
    ms = {name: [] for name in order}
    for name in order + order[::-1]:
        fn = (lambda: y.copy_(x)) if name == "dst.copy_(src)" else (lambda n=name: call(n))
        ms[name].append(timed(fn))
    line = (f"[probe] {'x'.join(map(str, SHAPE))} {dtype} r={RADIUS} (equal to tile full bit for "
            f"bit; err vs plain {err:.3g}):")
    for name in order:
        a, b = ms[name]
        line += f" {name} {a:.3f} / {b:.3f} ms ({nbytes / min(a, b) / 1e9:.2f} TB/s);"
    print(line.rstrip(";"), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="fp32",
                    help="the element type of the frame and the instances built")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per build")
    args = ap.parse_args(argv)
    try:
        probe(args.dtype, args.reps)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

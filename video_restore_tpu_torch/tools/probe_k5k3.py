"""Probe of K5's and K3's tensor-core routes on the card: where the time goes.

The card's machine has no kernel profiler, so this builds
``csrc/rdb_fused_mma.cu`` and ``csrc/srvgg_up_mma.cu`` alone (seconds; the
whole library takes over a minute), each twice (``--route mma``, the
default):

- ``full``: the kernel as shipped (checked against the plain version);
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the ``cp.async`` loads, the barriers
  and the epilogues without ``ldmatrix`` and MMAs (no valid output);

and times each build on the shapes of the paths: one RDB and one RRDB at
1x1080x1920x64 (K5) and the config-4 upsampler, 1x1080x1920x64 -> r 4 (K3).
The gap between the two builds is what the MMAs and their operand feed add
on top of the loads, barriers and epilogues.

``--route wgmma``: ``csrc/rdb_fused_mma.cu`` as shipped beside
``csrc/rdb_fused_wgmma.cu`` in the compile-time variants of
:data:`K5_VARIANTS`:

- ``late_x``: the next step's x rows loaded after conv 5, not after its x
  part;
- ``s2``: two weight slots; ``sw50``: stripes of 50 columns;
- ``rows2``: two consumer warpgroups, two rows a step, on stripes of 56
  columns; ``rows2_s4`` on 54 with a fourth weight slot; ``rows1``: one;
- ``no_mma``: without the ``wgmma``s (the TMA rings, barriers and
  epilogues); ``loads``: without the MMAs and the output stores (the rings
  alone); ``no_loads``: without the TMA copies, every stage and row arriving
  at once (the MMAs, epilogues and barriers alone);

plus any ``--variant NAME=-DDEF,...``. Each build's ``ptxas`` lines and
geometry are printed; each is held at odd shapes (one RDB with and without
x0, one RRDB: a frame below one stripe, B = 2, a ragged last stripe, more
segments than blocks) against the plain version and bit for bit
against the ``mma`` build (the last three are not checked), then the 1080p
RDB and RRDB and the ``bench_rdb`` shape (4x384x504) are timed with every
build, in order and back: ms, TFLOP/s of useful and of executed work (the
plan's count, the recomputed columns and each segment's fill included).
``--quick`` stops after the odd shapes: a first call on a new kernel. The
segment length is the plan's (B x stripes x H rows over one block an SM:
294-295 rows at 1080p), not a build variant; the kernel multicasts nothing, so
a cluster size is not one either.

``--dtype fp32``: K5's fp32 route, ``csrc/rdb_fused_bf16x3.cu`` (K1
``"bf16x3"``'s conv as the phases of one cooperative launch), in the
compile-time variants of :data:`X3_VARIANTS` beside the fp32 five-launch
chain (``ops/stripe.py::rdb_fused``: K1 ``"bf16x3"``) and the forced
``"fma"`` route (``rdb_fused_f32.cu``), both from the port's library:

- ``rows32_2``: tiles of 4 rows at cout 32 (two a consumer warpgroup);
- ``no_mma``: without the ``wgmma``s; ``products2``: two of the six
  products a tap; ``no_split``: the window stages as they lie;
  ``no_store``: without the epilogues' loads and stores;

plus any ``--variant NAME=-DDEF,...`` (refused where the source never reads
the name). The shipped build and the checked variants are held at odd
shapes (one RDB with and without x0, one RRDB) bit for bit against the
chain; then the 1080p RDB and RRDB are timed with every build and the
chain, in order and back, and the forced ``"fma"`` route once.

    python -m video_restore_tpu_torch.tools.probe_k5k3 [--route mma|wgmma]
        [--dtype bf16|fp32] [--reps N] [--quick] [--only NAME,...]
        [--variant NAME=-DDEF,...]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and,
per case, ms and TFLOP/s (useful operations) of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.tools.probe_k1 import parse_variant, ptxas_lines, unknown_defines

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)))
SOURCES = ("rdb_fused_mma.cu", "srvgg_up_mma.cu")
H, W, NF, GC = 1080, 1920, 64, 32
# rdb_fused_wgmma.cu's variants: (name, defines); "shipped" is the source's own
K5_VARIANTS = (
    ("shipped", ()),
    ("late_x", ("-DVR_K5_EARLY_X=0",)),
    ("s2", ("-DVR_K5_WSLOTS=2",)),
    ("sw50", ("-DVR_K5_SW=50",)),
    ("rows2", ("-DVR_K5_ROWS=2", "-DVR_K5_SW=56")),
    ("rows2_s4", ("-DVR_K5_ROWS=2", "-DVR_K5_WSLOTS=4")),
    ("rows1", ("-DVR_K5_ROWS=1", "-DVR_K5_SW=56")),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("loads", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_STORE")),
    ("no_loads", ("-DVR_PROBE_NO_LOADS",)),
)
# builds whose output is not the function
UNCHECKED = ("no_mma", "loads", "no_loads")
# rdb_fused_bf16x3.cu's variants (--dtype fp32): (name, defines)
X3_SOURCE = "rdb_fused_bf16x3.cu"
X3_VARIANTS = (
    ("shipped", ()),
    ("rows32_2", ("-DVR_X3_ROWS32=2",)),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("products2", ("-DVR_PROBE_PRODUCTS=2",)),
    ("no_split", ("-DVR_PROBE_NO_SPLIT",)),
    ("no_store", ("-DVR_PROBE_NO_STORE",)),
)
X3_UNCHECKED = ("no_mma", "products2", "no_split", "no_store")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_K5_ARGS = [_I, _I, _I, _P, _P, _P, _PP, _PP, _I, _I, _I, _P]


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


def k5_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
              only: Sequence[str] = ()) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(build, source, defines) of ``--route wgmma``: the ``mma`` source as
    shipped, then the wgmma variants (``only``: those names; ``extra``
    appended)."""
    out = [("mma", "rdb_fused_mma.cu", ())]
    for name, defs in tuple(K5_VARIANTS) + tuple(extra):
        if not only or name in only:
            out.append((name, "rdb_fused_wgmma.cu", tuple(defs)))
    return out


def _compile_k5(specs) -> Dict[str, ctypes.CDLL]:
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k5_wgmma"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, defs in specs:
        so = out / f"libk5_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / source)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{text[-4000:]}")
        for line in ptxas_lines(name, text):
            print(line, flush=True)
        lib = ctypes.CDLL(str(so))
        if hasattr(lib, "vr_rdb_fused_wgmma"):
            for fn in (lib.vr_rdb_fused_wgmma, lib.vr_rrdb_fused_wgmma):
                fn.argtypes = _K5_ARGS + [ctypes.POINTER(_L), _I]
                fn.restype = _I
            lib.vr_rdb_fused_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_rdb_fused_wgmma_config.restype = _I
        else:
            for fn in (lib.vr_rdb_fused_mma, lib.vr_rrdb_fused_mma):
                fn.argtypes = _K5_ARGS
                fn.restype = _I
        libs[name] = lib
    return libs


def probe_wgmma(reps: int = 10, quick: bool = False, only: Sequence[str] = (),
                extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--route wgmma``: the variants of ``rdb_fused_wgmma.cu`` beside the
    shipped ``rdb_fused_mma.cu``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops import _build
    from video_restore_tpu_torch.ops.rdb import (
        rdb_fused_plain, rdb_wgmma_plan, rrdb_fused_plain, wgmma_geometry,
    )
    from video_restore_tpu_torch.tools.bench_rdb import useful_flops

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = k5_builds(extra, only)
    libs = _compile_k5(specs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = {}
    for name, source, _ in specs:
        if source == "rdb_fused_wgmma.cu":
            geo[name] = wgmma_geometry(libs[name])
            print(f"[build] {name}: {geo[name]}", flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, bf)

    rdbs = []
    for _ in range(3):
        ws = [rnd(3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.03) for k in range(5)]
        bs = [rnd(GC if k < 4 else NF, scale=0.05) for k in range(5)]
        rdbs.append((ws, bs))
    wp1 = _build.pointers(rdbs[0][0])
    bp1 = _build.pointers(rdbs[0][1])
    wp3 = _build.pointers([t for ws, _ in rdbs for t in ws])
    bp3 = _build.pointers([t for _, bs in rdbs for t in bs])

    def launch(name, whole, x, y, x0=None, scratch=None):
        b, h, w, _ = x.shape
        lib = libs[name]
        if name == "mma":
            if whole:
                code = lib.vr_rrdb_fused_mma(1, NF, GC, x.data_ptr(), y.data_ptr(),
                                             scratch.data_ptr(), wp3, bp3, b, h, w, stream)
            else:
                code = lib.vr_rdb_fused_mma(1, NF, GC, x.data_ptr(),
                                            None if x0 is None else x0.data_ptr(),
                                            y.data_ptr(), wp1, bp1, b, h, w, stream)
        else:
            plan = rdb_wgmma_plan(b, h, w, geo[name], sms=sms).array()
            if whole:
                code = lib.vr_rrdb_fused_wgmma(1, NF, GC, x.data_ptr(), y.data_ptr(),
                                               scratch.data_ptr(), wp3, bp3, b, h, w, stream,
                                               plan, len(plan))
            else:
                code = lib.vr_rdb_fused_wgmma(1, NF, GC, x.data_ptr(),
                                              None if x0 is None else x0.data_ptr(),
                                              y.data_ptr(), wp1, bp1, b, h, w, stream, plan,
                                              len(plan))
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")

    def check(tag, name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if err > 2e-2 * scale:
            raise RuntimeError(f"{tag} ({name}): max |kernel - plain| {err:.3g}")
        return err

    # odd shapes: below one stripe, one segment of one row past the fill, B =
    # 2 with a ragged stripe, a last stripe of 16 columns (1920 = 34 x 56 +
    # 16 in small), more segments than one a block
    bad = {}
    names = [n for n, _, _ in specs]
    for shp in ((1, 5, 7), (1, 1, 60), (2, 37, 53), (1, 20, 72), (2, 130, 150), (3, 61, 1920)):
        x, x0 = rnd(*shp, NF), rnd(*shp, NF)
        cases = (
            ("rdb", False, None, lambda: rdb_fused_plain(x, *rdbs[0])),
            ("rdb x0", False, x0, lambda: rdb_fused_plain(x, *rdbs[0], x0)),
            ("rrdb", True, None, lambda: rrdb_fused_plain(x, rdbs)),
        )
        for tag, whole, xr, plain in cases:
            ref = plain()
            outs = {}
            for name in names:
                if name in UNCHECKED or name in bad:
                    continue
                y = torch.full_like(x, float("nan"))
                try:
                    launch(name, whole, x, y, xr, torch.empty_like(x) if whole else None)
                    torch.cuda.synchronize()
                    err = check(f"{shp} {tag}", name, y, ref)
                    if "mma" in outs and not torch.equal(y, outs["mma"]):
                        n_diff = (y != outs["mma"]).sum().item()
                        raise RuntimeError(f"{shp} {tag} ({name}): {n_diff} values differ from mma")
                except RuntimeError as e:
                    bad[name] = str(e)
                    print(f"[check] FAILED {e}", flush=True)
                    continue
                outs[name] = y
                print(f"[check] {shp} {tag} {name}: err {err:.3g}"
                      + (", == mma" if name != "mma" else ""), flush=True)
    specs = [sp for sp in specs if sp[0] not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick or "mma" in bad:
        if bad:
            raise RuntimeError(f"builds disagree with the plain version or mma: {sorted(bad)}")
        return

    timed = _timer(reps)
    names = [n for n, _, _ in specs]
    for shp, whole, rdb_n in (((1, H, W), False, 1), ((1, H, W), True, 3),
                               ((4, 384, 504), False, 1)):
        x = rnd(*shp, NF)
        y, scratch = torch.empty_like(x), torch.empty_like(x) if whole else None
        useful = rdb_n * useful_flops(*shp)
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            ms[name].append(timed(lambda n=name: launch(n, whole, x, y, None, scratch)))
        line = f"[probe] {'RRDB' if whole else 'RDB'} {'x'.join(map(str, shp))}x64:"
        for name in names:
            a, b_ = ms[name]
            t = min(a, b_)
            exe = ""
            if name != "mma":
                plan = rdb_wgmma_plan(*shp, geo[name], sms=sms)
                exe = (f", {rdb_n * plan.executed_ops() / t / 1e9:.1f} executed "
                       f"(x{plan.executed_ops() / useful * rdb_n:.3f})")
            line += f" {name} {a:.3f} / {b_:.3f} ms ({useful / t / 1e9:.1f} TFLOP/s useful{exe});"
        print(line.rstrip(";"), flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the plain version or mma: {sorted(bad)}")


def x3_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
              only: Sequence[str] = ()) -> List[Tuple[str, Tuple[str, ...]]]:
    """(build, defines) of ``--dtype fp32``: the variants of
    ``rdb_fused_bf16x3.cu`` (``only``: those names; ``extra`` appended)."""
    return [(n, tuple(d)) for n, d in tuple(X3_VARIANTS) + tuple(extra) if not only or n in only]


def probe_fp32(reps: int = 5, quick: bool = False, only: Sequence[str] = (),
               extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--dtype fp32``: the variants of ``rdb_fused_bf16x3.cu`` beside the
    fp32 five-launch chain and the forced ``"fma"`` route."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    import threading

    from video_restore_tpu_torch.ops import _build, rdb, stripe
    from video_restore_tpu_torch.ops.tail import weight_parts

    dev, f32 = torch.device("cuda", 0), torch.float32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = x3_builds(extra, only)
    # the port's library (the chain and the fma route) builds beside the
    # variants; a build that failed there raises here
    lib_thread = threading.Thread(target=_build.load)
    lib_thread.start()
    out = _build.BUILD_DIR / "probe_k5_fp32"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, defs in specs:
        so = out / f"librdb_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / X3_SOURCE)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, geo = {}, {}
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{text[-4000:]}")
        for line in ptxas_lines(name, text):
            print(line, flush=True)
        lib = ctypes.CDLL(str(so))
        lib.vr_rdb_fused_bf16x3.argtypes = [_I, _I, _I] + [_P] * 5 + [
            ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I, _I, _P, ctypes.POINTER(_L), _I]
        lib.vr_rdb_fused_bf16x3.restype = _I
        lib.vr_rdb_fused_bf16x3_config.argtypes = [ctypes.POINTER(_I)]
        lib.vr_rdb_fused_bf16x3_config.restype = _I
        libs[name] = lib
        geo[name] = rdb.x3_geometry(lib)
        print(f"[build] {name}: {geo[name]}", flush=True)
    lib_thread.join()
    _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, f32)

    def weights():
        return ([rnd(3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.03) for k in range(5)],
                [rnd(GC if k < 4 else NF, scale=0.05) for k in range(5)])

    w3 = [weights() for _ in range(3)]
    parts = [weight_parts(t) for ws, _ in w3 for t in ws]
    biases = [t for _, bs in w3 for t in bs]

    def launch(name, x, rdbs, x0=None):
        b, h, w, _ = x.shape
        y = torch.empty_like(x)
        scratch = torch.empty_like(x) if rdbs == 3 else None
        c = torch.empty(b, h, w, 4 * GC, dtype=f32, device=dev)
        plan = rdb.rdb_x3_plan(b, h, w, geo[name], sms=sms).array()
        n = 5 * rdbs
        code = libs[name].vr_rdb_fused_bf16x3(
            NF, GC, rdbs, x.data_ptr(), None if x0 is None else x0.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(), c.data_ptr(),
            _build.pointers(parts[:n]), _build.pointers(biases[:n]), b, h, w, stream, plan,
            len(plan))
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")
        return y

    def chain(x, rdbs, x0=None):
        if rdbs == 1:
            return stripe.rdb_fused(x, *w3[0], x0)
        o = stripe.rdb_fused(x, *w3[0])
        o = stripe.rdb_fused(o, *w3[1])
        return stripe.rdb_fused(o, *w3[2], x0=x)

    bad = {}
    names = [n for n, _ in specs]
    for shp in ((1, 5, 7), (2, 37, 53), (1, 20, 72), (2, 130, 150)):
        x, x0 = rnd(*shp, NF), rnd(*shp, NF)
        for tag, rdbs, xx0 in (("rdb", 1, None), ("rdb x0", 1, x0), ("rrdb", 3, None)):
            want = chain(x, rdbs, xx0)
            for name in names:
                if name in X3_UNCHECKED or name in bad:
                    continue
                try:
                    got = launch(name, x, rdbs, xx0)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        n_diff = (got != want).sum().item()
                        raise RuntimeError(f"{shp} {tag} ({name}): {n_diff} values differ "
                                           "from the chain")
                except RuntimeError as e:
                    bad[name] = str(e)
                    print(f"[check] FAILED {e}", flush=True)
                    continue
                print(f"[check] {shp} {tag} {name}: == chain", flush=True)
    names = [n for n in names if n not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick:
        if bad:
            raise RuntimeError(f"builds disagree with the chain: {sorted(bad)}")
        return
    timed = _timer(reps)
    x = rnd(1, H, W, NF)
    useful = sum(2 * H * W * 9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
    for tag, rdbs in (("RDB", 1), ("RRDB", 3)):
        order = names + ["chain"]
        ms = {n: [] for n in order}
        for name in order + order[::-1]:
            fn = ((lambda: chain(x, rdbs)) if name == "chain"
                  else (lambda n=name: launch(n, x, rdbs)))
            ms[name].append(timed(fn))
        fma = _timer(1)((lambda: rdb.rdb_fused(x, *w3[0], route="fma")) if rdbs == 1
                        else (lambda: rdb.rrdb_fused(x, w3, route="fma")))
        line = f"[probe] fp32 {tag} 1x{H}x{W}x64:"
        for name in order:
            a, b_ = ms[name]
            line += (f" {name} {a:.3f} / {b_:.3f} ms "
                     f"({rdbs * useful / min(a, b_) / 1e9:.1f} TFLOP/s useful);")
        print(line + f" fma (forced) {fma:.3f} ms", flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the chain: {sorted(bad)}")


def _timer(reps: int):
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
    return timed


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", choices=("mma", "wgmma"), default="mma",
                    help="the K5 source probed (default: mma, with K3)")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="fp32: the variants of rdb_fused_bf16x3.cu")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per build")
    ap.add_argument("--quick", action="store_true",
                    help="wgmma: build and check at odd shapes only")
    ap.add_argument("--only", default="", help="wgmma: comma-separated variant names")
    ap.add_argument("--variant", action="append", default=[],
                    help="wgmma: another variant, NAME=-DDEF[,-DDEF...] (repeatable)")
    args = ap.parse_args(argv)
    try:
        extra = [parse_variant(v) for v in args.variant]
    except ValueError as e:
        ap.error(str(e))
    if args.dtype == "fp32":
        bad = unknown_defines(X3_SOURCE, extra)
        if bad:
            ap.error(f"--variant: {X3_SOURCE} never reads {' '.join(bad)}")
    only = [n for n in args.only.split(",") if n]
    try:
        if args.dtype == "fp32":
            probe_fp32(min(args.reps, 5), args.quick, only, extra)
        elif args.route == "mma":
            probe(args.reps)
        else:
            probe_wgmma(args.reps, args.quick, only, extra)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probe of the one-launch tail's tensor-core routes on the card: where the
time goes.

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

``--route wgmma``: ``csrc/tail_fused_mma.cu`` as shipped beside
``csrc/tail_fused_wgmma.cu`` in the compile-time variants of
:data:`WG_VARIANTS`:

- ``rows2``: two consumer warpgroups, two rows a step; ``rows2_s4`` the
  same with a fourth weight slot; ``rows1``: one; ``s4``: three with a
  fourth weight slot;
- ``no_mma``: without the ``wgmma``s (the rings, loads, epilogues and
  conv_last); ``no_last``: without conv_last's FMAs and stores;
  ``no_loads``: without the x copies and the weights' TMA (the MMAs,
  epilogues and conv_last on whatever the rings hold); ``no_wload`` and
  ``no_hload``: conv_last without its weights' or its hr rows' loads from
  shared memory;

plus any ``--variant NAME=-DDEF,...``. Each build's ``ptxas`` lines and
geometry are printed; each is held at odd shapes (B = 2 with ragged
extents, a frame narrower than one stripe, a last stripe of 2 columns, more
stripes' rows than the grid has blocks) against the plain version and bit
for bit against the ``mma`` build (the probe builds are not checked), then
the flagship's tail is timed with every build, in order and back: ms,
TFLOP/s of useful and of executed work (the plan's count).
``--quick`` stops after the odd shapes and a check at the flagship shape: a
first call on a new kernel.

``--dtype fp32``: the fp32 one-launch tail, ``csrc/tail_fused_bf16x3.cu``,
in the compile-time variants of :data:`X3_VARIANTS` beside K6's
``csrc/tail_fused.cu`` (fp32 FMAs, as shipped) and the fp32 three-launch
chain (the port's library: upconv2 and conv_hr on K1 ``"bf16x3"``,
conv_last on K1 ``"fma"``):

- ``no_mma``: without the ``wgmma``s; ``products2``: two of the six
  products a tap; ``no_split``: the window stages as they lie (no split);
  ``no_wload``: the weight stages arrive empty (no TMA); ``no_last``:
  without conv_last;
- ``clocks``: each role's cycles (``clock64``, written over the output):
  the consumers' waits for windows, weights and conv_last and their
  epilogues, the producer's waits for free stages and its splits, the
  weights' thread's waits for free slots, conv_last's waits and rows; each
  as a share of the role's walk, averaged over the blocks;

plus any ``--variant NAME=-DDEF,...`` (refused where the source never reads
the name). The shipped build and the checked variants are held at the odd
shapes bit for bit against the chain and within 1e-4 of the largest value
against the plain version; then the flagship's tail, 1x2160x3840x64 ->
1x4320x7680x3 in fp32, is timed with every build and the chain, in order
and back.

    python -m video_restore_tpu_torch.tools.probe_k6 [--route mma|wgmma]
        [--dtype bf16|fp32] [--reps N] [--quick] [--only NAME,...]
        [--variant NAME=-DDEF,...]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line and
each build's ms and TFLOP/s (useful operations of the two wide convs, as
9-tap convs on the fine grid).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.tools.probe_k1 import parse_variant, ptxas_lines, unknown_defines

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)), ("no_last", ("-DVR_PROBE_NO_LAST",)))
SOURCE = "tail_fused_mma.cu"
H2, W2, NF = 2160, 3840, 64
# tail_fused_wgmma.cu's variants: (name, defines); "shipped" is the source's own
WG_VARIANTS = (
    ("shipped", ()),
    ("rows2", ("-DVR_TAIL_ROWS=2",)),
    ("rows2_s4", ("-DVR_TAIL_ROWS=2", "-DVR_TAIL_WSLOTS=4")),
    ("rows1", ("-DVR_TAIL_ROWS=1",)),
    ("s4", ("-DVR_TAIL_WSLOTS=4",)),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("no_last", ("-DVR_PROBE_NO_LAST",)),
    ("no_loads", ("-DVR_PROBE_NO_LOADS",)),
    ("no_wload", ("-DVR_PROBE_NO_WLOAD",)),
    ("no_hload", ("-DVR_PROBE_NO_HLOAD",)),
)
# builds whose output is not the function
UNCHECKED = ("no_mma", "no_last", "no_loads", "no_wload", "no_hload")
# tail_fused_bf16x3.cu's variants (--dtype fp32): (name, defines)
X3_SOURCE = "tail_fused_bf16x3.cu"
X3_VARIANTS = (
    ("shipped", ()),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("products2", ("-DVR_PROBE_PRODUCTS=2",)),
    ("no_split", ("-DVR_PROBE_NO_SPLIT",)),
    ("no_wload", ("-DVR_PROBE_NO_WLOAD",)),
    ("no_last", ("-DVR_PROBE_NO_LAST",)),
    ("clocks", ("-DVR_PROBE_CLOCKS",)),
)
X3_UNCHECKED = ("no_mma", "products2", "no_split", "no_wload", "no_last", "clocks")
# the clock build's values, 16 a block: (slot, role, what)
X3_CLOCKS = (
    (10, "consumers", "wait windows"), (11, "consumers", "wait weights"),
    (12, "consumers", "wait conv_last"), (13, "consumers", "epilogues"),
    (3, "producer", "wait free stages"), (5, "producer", "splits"),
    (0, "weights", "wait free slots"), (7, "conv_last", "wait hr row"),
    (8, "conv_last", "rows"),
)
X3_WALK = {"consumers": 14, "producer": 6, "weights": 1, "conv_last": 9}
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_TAIL_ARGS = [_I, _I] + [_P] * 8 + [_I, _I, _I, _P]


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


def wg_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
              only: Sequence[str] = ()) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(build, source, defines) of ``--route wgmma``: K6's ``mma`` source as
    shipped, then the wgmma variants (``only``: those names; ``extra``
    appended)."""
    out = [("mma", "tail_fused_mma.cu", ())]
    for name, defs in tuple(WG_VARIANTS) + tuple(extra):
        if not only or name in only:
            out.append((name, "tail_fused_wgmma.cu", tuple(defs)))
    return out


def _compile_wg(specs) -> Dict[str, ctypes.CDLL]:
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k6_wgmma"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, defs in specs:
        so = out / f"libtail_{name}.so"
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
        if hasattr(lib, "vr_tail_fused_wgmma"):
            lib.vr_tail_fused_wgmma.argtypes = _TAIL_ARGS + [ctypes.POINTER(_L), _I]
            lib.vr_tail_fused_wgmma.restype = _I
            lib.vr_tail_fused_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_tail_fused_wgmma_config.restype = _I
        else:
            lib.vr_tail_fused_mma.argtypes = _TAIL_ARGS
            lib.vr_tail_fused_mma.restype = _I
        libs[name] = lib
    return libs


def probe_wgmma(reps: int = 10, quick: bool = False, only: Sequence[str] = (),
                extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--route wgmma``: the variants of ``tail_fused_wgmma.cu`` beside the
    shipped ``tail_fused_mma.cu``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import tail_fused_plain, tail_geometry, tail_wgmma_plan

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = wg_builds(extra, only)
    libs = _compile_wg(specs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = {}
    for name, source, _ in specs:
        if source == "tail_fused_wgmma.cu":
            geo[name] = tail_geometry(libs[name])
            print(f"[build] {name}: {geo[name]}", flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, bf)

    tw = [rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, 3, scale=0.05), rnd(3, scale=0.05)]

    def launch(name, x, y):
        b, h2, w2, _ = x.shape
        lib = libs[name]
        args = (1, NF, x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in tw), b, h2, w2,
                stream)
        if name == "mma":
            code = lib.vr_tail_fused_mma(*args)
        else:
            plan = tail_wgmma_plan(b, h2, w2, geo[name], sms=sms).array()
            code = lib.vr_tail_fused_wgmma(*args, plan, len(plan))
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")

    def check(tag, name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if not err <= 2e-2 * scale:
            raise RuntimeError(f"{tag} ({name}): max |kernel - plain| {err:.3g}")
        return err

    # odd shapes (output 2 H2 x 2 W2, stripes of 60 columns as shipped): B =
    # 2 ragged (74 x 106: a last stripe of 46), a frame narrower than one
    # stripe (10 x 14), one column past a stripe (4 x 62: a last stripe of
    # 2), three stripes' rows of 200 over 132 blocks (200 x 300), rows of
    # one segment shorter than a step's fill (2 x 122)
    bad = {}
    names = [n for n, _, _ in specs]
    shapes = [(2, 37, 53), (1, 5, 7), (1, 2, 31), (2, 100, 150), (1, 1, 61), (3, 7, 200)]
    if quick:
        shapes.append((1, H2, W2))
    for shp in shapes:
        x = rnd(*shp, NF)
        ref = tail_fused_plain(x, *tw)
        outs = {}
        for name in names:
            if name in UNCHECKED or name in bad:
                continue
            y = torch.full_like(ref, float("nan"))
            try:
                launch(name, x, y)
                torch.cuda.synchronize()
                err = check(str(shp), name, y, ref)
                if "mma" in outs and not torch.equal(y, outs["mma"]):
                    n_diff = (y != outs["mma"]).sum().item()
                    raise RuntimeError(f"{shp} ({name}): {n_diff} values differ from mma")
            except RuntimeError as e:
                bad[name] = str(e)
                print(f"[check] FAILED {e}", flush=True)
                continue
            outs[name] = y
            print(f"[check] {shp} {name}: err {err:.3g}" + (", == mma" if name != "mma" else ""),
                  flush=True)
        del ref, outs
    specs = [sp for sp in specs if sp[0] not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick or "mma" in bad:
        if bad:
            raise RuntimeError(f"builds disagree with the plain version or mma: {sorted(bad)}")
        return

    timed = _timer(reps)
    names = [n for n, _, _ in specs]
    x = rnd(1, H2, W2, NF)
    y = torch.empty(1, 2 * H2, 2 * W2, 3, dtype=bf, device=dev)
    useful = 2 * 2 * (4 * H2 * W2) * 9 * NF * NF
    ms = {n: [] for n in names}
    for name in names + names[::-1]:
        ms[name].append(timed(lambda n=name: launch(n, x, y)))
    line = f"[probe] tail 1x{H2}x{W2}x64:"
    for name in names:
        a, b_ = ms[name]
        t = min(a, b_)
        exe = ""
        if name != "mma":
            ex = tail_wgmma_plan(1, H2, W2, geo[name], sms=sms).executed_ops()
            exe = f", {ex / t / 1e9:.1f} executed (x{ex / useful:.3f})"
        line += f" {name} {a:.3f} / {b_:.3f} ms ({useful / t / 1e9:.1f} TFLOP/s useful{exe});"
    print(line.rstrip(";"), flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the plain version or mma: {sorted(bad)}")


def x3_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
              only: Sequence[str] = ()) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(build, source, defines) of ``--dtype fp32``: K6's fp32-FMA source
    as shipped, then the bf16x3 variants (``only``: those names; ``extra``
    appended)."""
    out = [("fma", "tail_fused.cu", ())]
    for name, defs in tuple(X3_VARIANTS) + tuple(extra):
        if not only or name in only:
            out.append((name, X3_SOURCE, tuple(defs)))
    return out


def _compile_x3(specs) -> Dict[str, ctypes.CDLL]:
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k6_fp32"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, defs in specs:
        so = out / f"libtail_{name}.so"
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
        if hasattr(lib, "vr_tail_fused_bf16x3"):
            lib.vr_tail_fused_bf16x3.argtypes = [_I] + [_P] * 8 + [_I, _I, _I, _P,
                                                                   ctypes.POINTER(_L), _I]
            lib.vr_tail_fused_bf16x3.restype = _I
        else:
            lib.vr_tail_fused.argtypes = _TAIL_ARGS
            lib.vr_tail_fused.restype = _I
        libs[name] = lib
    return libs


def probe_fp32(reps: int = 10, quick: bool = False, only: Sequence[str] = (),
               extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--dtype fp32``: the variants of ``tail_fused_bf16x3.cu`` beside
    K6's fp32-FMA kernel and the fp32 three-launch chain."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    import threading

    from video_restore_tpu_torch.ops import _build
    from video_restore_tpu_torch.ops import tail as tail_ops

    dev, f32 = torch.device("cuda", 0), torch.float32
    torch.backends.cudnn.allow_tf32 = False  # the plain version at fp32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = x3_builds(extra, only)
    # the port's library (the chain's K1 kernels) builds beside the variants;
    # a build that failed there raises here
    lib_thread = threading.Thread(target=_build.load)
    lib_thread.start()
    libs = _compile_x3(specs)
    lib_thread.join()
    _build.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, f32)

    tw = [rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, NF, scale=0.05), rnd(NF, scale=0.05),
          rnd(3, 3, NF, 3, scale=0.05), rnd(3, scale=0.05)]
    parts = [tail_ops.weight_parts(tw[0]), tail_ops.weight_parts(tw[2])]

    def launch(name, x, y):
        b, h2, w2, _ = x.shape
        lib = libs[name]
        if name == "fma":
            code = lib.vr_tail_fused(0, NF, x.data_ptr(), y.data_ptr(),
                                     *(t.data_ptr() for t in tw), b, h2, w2, stream)
        else:
            plan = tail_ops.tail_x3_plan(b, h2, w2, sms=sms).array()
            code = lib.vr_tail_fused_bf16x3(
                NF, x.data_ptr(), y.data_ptr(), parts[0].data_ptr(), tw[1].data_ptr(),
                parts[1].data_ptr(), tw[3].data_ptr(), tw[4].data_ptr(), tw[5].data_ptr(),
                b, h2, w2, stream, plan, len(plan))
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")

    def chain(x):
        return tail_ops.tail_fused(x, *tw, route="chain")

    bad = {}
    names = [n for n, _, _ in specs]
    shapes = [(2, 37, 53), (1, 5, 7), (1, 2, 31), (2, 100, 150), (1, 1, 61), (3, 7, 200)]
    if quick:
        shapes.append((1, H2, W2))
    for shp in shapes:
        x = rnd(*shp, NF)
        ref, want = tail_ops.tail_fused_q_plain(x, *tw), chain(x)
        scale = max(1.0, ref.abs().max().item())
        for name in names:
            if name in X3_UNCHECKED or name in bad:
                continue
            y = torch.full_like(ref, float("nan"))
            try:
                launch(name, x, y)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                if not err <= 1e-4 * scale:
                    raise RuntimeError(f"{shp} ({name}): max |kernel - plain| {err:.3g}")
                if name != "fma" and not torch.equal(y, want):
                    n_diff = (y != want).sum().item()
                    raise RuntimeError(f"{shp} ({name}): {n_diff} values differ from the chain")
            except RuntimeError as e:
                bad[name] = str(e)
                print(f"[check] FAILED {e}", flush=True)
                continue
            print(f"[check] {shp} {name}: err {err:.3g}" + (", == chain" if name != "fma" else ""),
                  flush=True)
        del ref, want
    specs = [sp for sp in specs if sp[0] not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick:
        if bad:
            raise RuntimeError(f"builds disagree with the plain version or the chain: {sorted(bad)}")
        return

    timed = _timer(reps)
    names = [n for n, _, _ in specs] + ["chain"]
    x = rnd(1, H2, W2, NF)
    y = torch.empty(1, 2 * H2, 2 * W2, 3, dtype=f32, device=dev)
    useful = 2 * 2 * (4 * H2 * W2) * 9 * NF * NF
    ms = {n: [] for n in names}
    for name in names + names[::-1]:
        fn = (lambda: chain(x)) if name == "chain" else (lambda n=name: launch(n, x, y))
        ms[name].append(timed(fn))
    line = f"[probe] fp32 tail 1x{H2}x{W2}x64:"
    for name in names:
        a, b_ = ms[name]
        t = min(a, b_)
        exe = ""
        if name not in ("fma", "chain"):
            ex = tail_ops.tail_x3_plan(1, H2, W2, sms=sms).executed_ops()
            exe = f", {ex / t / 1e9:.1f} executed (x{ex / useful:.3f})"
        line += f" {name} {a:.3f} / {b_:.3f} ms ({useful / t / 1e9:.1f} TFLOP/s useful{exe});"
    print(line.rstrip(";"), flush=True)
    if "clocks" in libs and "clocks" not in bad:
        launch("clocks", x, y)
        torch.cuda.synchronize()
        grid = tail_ops.tail_x3_plan(1, H2, W2, sms=sms).grid
        c = y.view(-1)[: grid * 16].view(grid, 16).double().mean(0).tolist()
        print("[probe] clocks (mean of the blocks, share of the role's walk): " + "; ".join(
            f"{role} {what} {c[slot] / max(c[X3_WALK[role]], 1.0):.3f}"
            for slot, role, what in X3_CLOCKS) + "; walks " + ", ".join(
            f"{role} {c[slot]:.4g} cycles" for role, slot in X3_WALK.items()), flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the plain version or the chain: {sorted(bad)}")


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
                    help="the tail source probed (default: K6's mma)")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="fp32: the variants of tail_fused_bf16x3.cu")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per build")
    ap.add_argument("--quick", action="store_true",
                    help="wgmma: build and check at odd shapes and the flagship shape only")
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
            probe_fp32(args.reps, args.quick, only, extra)
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

"""Probe of K4's tensor-core routes on the card: where the time goes.

The card's machine has no kernel profiler, so this builds one of K4's
sources alone (seconds; the whole library takes over a minute) in several
variants, all in parallel.

``--route mma`` (the default): ``csrc/conv3x3_i8_mma.cu`` five times:

- ``full``: the kernel as shipped (the RDB it runs checked bit for bit
  against the plain version, as is every build not named ``no_*``);
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the loads, the quantiser, the
  ``cp.async`` weight ring, the barriers and the epilogue without the
  ``ldmatrix`` and MMAs (no valid output);
- ``no_quant``: ``-DVR_PROBE_NO_QUANT``, the same bytes moved with the
  quantiser replaced by a byte shuffle (no valid output);
- ``no_store``: no output stores; ``no_mma_load``: neither MMAs nor loads;

and times each build on the five dynamic-A8 convs of one int8 RDB at
1x1080x1920x64 (nf 64, gc 32: convs 1-4 write 32 channels of the growth
buffer, conv 5 writes 64), each conv alone and the five in a row, and on
one SRVGG body conv (64 -> 64, PReLU) at the same size. ``full``
minus ``no_mma`` is what the MMAs and their operand feed add on top of the
rest; ``full`` minus ``no_quant`` is the quantiser's share.

``--route wgmma``: ``csrc/conv3x3_i8_mma.cu`` as shipped (``mma``) and
``csrc/conv3x3_i8_wgmma.cu`` as shipped (``full``) and with the same
switches: ``no_mma`` (the TMA ring, the quantiser warpgroup and the
epilogue, no ``wgmma``), ``no_quant`` (the producer moves the bytes without
quantising), ``no_store`` (no epilogue loads or stores) and ``no_load`` (the
windows are not copied: the quantiser, the MMAs and the epilogue on what
shared memory holds), then each part alone on the same barriers (``none``:
every switch; ``only_load``, ``only_quant``, ``only_mma``, ``only_store``:
every switch but one), and ``clocks`` (the shipped kernel with clock64
counters: where the producer's and the consumers' cycles go, a step and a
tile). Each build runs through the port's own wrappers
(``ops/quant.py``, ``ops/stripe.py``) with the port's library swapped for
it. ``full`` is checked first, ``torch.equal`` to ``mma`` and to the plain
version (outputs and output amax): each RDB conv, dynamic and static, and
the SRVGG conv at odd shapes (B = 2, partial tiles), the blocked RDB at
(2, 9, 70) and 1x1080x1920. Then every build times the RDB's five convs
(on ``wgmma`` in K1's blocks, on ``mma`` in the growth buffer), the RDB, the
static-A8 RDB and one SRVGG conv, in order and back, beside each one's
bound (its bf16 input read once and output written once over 3.35 TB/s,
against its int8 operations over 1979 TOPS). ``--quick``: ``mma``,
``full`` and ``clocks`` only (a first call on an edited kernel).

    python -m video_restore_tpu_torch.tools.probe_k4 [--route mma|wgmma] [--reps N] [--quick]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line,
each build's registers and spills, and each build's ms and useful TOPS.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from typing import Dict, Optional, Sequence

import torch

BUILDS = (("full", ()), ("no_mma", ("-DVR_PROBE_NO_MMA",)), ("no_quant", ("-DVR_PROBE_NO_QUANT",)),
          ("no_store", ("-DVR_PROBE_NO_STORE",)),
          ("no_mma_load", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_LOAD")))
SOURCE = "conv3x3_i8_mma.cu"
# --route wgmma: (build, source, defines)
WGMMA_BUILDS = (
    ("mma", SOURCE, ()),
    ("full", "conv3x3_i8_wgmma.cu", ()),
    ("no_mma", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_MMA",)),
    ("no_quant", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_QUANT",)),
    ("no_store", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_STORE",)),
    ("no_load", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_LOAD",)),
    # one part alone on the same barriers: the sum of the parts against full
    ("none", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_QUANT",
                                     "-DVR_PROBE_NO_STORE", "-DVR_PROBE_NO_LOAD")),
    ("only_load", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_QUANT",
                                          "-DVR_PROBE_NO_STORE")),
    ("only_quant", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_STORE",
                                           "-DVR_PROBE_NO_LOAD")),
    ("only_mma", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_QUANT", "-DVR_PROBE_NO_STORE",
                                         "-DVR_PROBE_NO_LOAD")),
    ("only_store", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_QUANT",
                                           "-DVR_PROBE_NO_LOAD")),
    # the shipped kernel with clock64 counters: where each role's cycles go
    ("clocks", "conv3x3_i8_wgmma.cu", ("-DVR_PROBE_CLOCKS",)),
)
H, W, NF, GC = 1080, 1920, 64, 32
HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12


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


def _wgmma_libs(specs) -> Dict[str, ctypes.CDLL]:
    """{build: loaded library} of ``--route wgmma``, compiled in parallel,
    each with the entry points the port's wrappers call."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "probe_k4_wgmma"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, defs in specs:
        so = out / f"libk4_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(_build.CSRC / source)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    args = ([P] * 10 + [I] * 5 + [L] * 6
            + [I, ctypes.POINTER(I), ctypes.POINTER(F), ctypes.POINTER(F), I, F, F, P])
    libs = {}
    for name, so, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{text[-4000:]}")
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = "n64 " if "Li8E" in line else "n32 " if "Li4E" in line else ""
            elif "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"[build] {name} {entry}{line.split(':', 1)[-1].strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        if hasattr(lib, "vr_conv3x3_i8_wgmma"):
            lib.vr_conv3x3_i8_wgmma.argtypes = args + [ctypes.POINTER(L), I, P]
            lib.vr_conv3x3_i8_wgmma.restype = I
            lib.vr_conv3x3_i8_wgmma_config.argtypes = [ctypes.POINTER(I)]
            lib.vr_conv3x3_i8_wgmma_config.restype = I
            if hasattr(lib, "vr_conv3x3_i8_wgmma_clocks"):
                lib.vr_conv3x3_i8_wgmma_clocks.argtypes = [ctypes.POINTER(L)]
                lib.vr_conv3x3_i8_wgmma_clocks.restype = I
        else:
            lib.vr_conv3x3_i8_mma.argtypes = args
            lib.vr_conv3x3_i8_mma.restype = I
        libs[name] = lib
    return libs


class _ProbeLib:
    """A probe build as the wrappers see the port's library: its entry
    points, and an error string (the build has no ``vr_error_string``)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def vr_error_string(code: int) -> bytes:
        return f"cudaError_t {code}".encode()


@contextlib.contextmanager
def _using(lib):
    """The port's wrappers launch ``lib``'s kernels (a probe build) inside."""
    from video_restore_tpu_torch.ops import _build, quant

    saved = _build._lib
    _build._lib, quant._i8_build = _ProbeLib(lib), None
    try:
        yield
    finally:
        _build._lib, quant._i8_build = saved, None


def conv_bound_ms(px: int, cin: int, cout: int, residuals: int) -> float:
    """The least ms of one int8 conv over px pixels: the larger of its bf16
    input read once and output (and residuals) written or read once over
    the card's memory rate, and its int8 operations over 1979 TOPS."""
    nbytes = px * 2 * (cin + cout * (1 + residuals))
    return max(nbytes / HBM_BYTES_S, 2 * px * 9 * cin * cout / INT8_OPS_S) * 1e3


def probe_wgmma(reps: int = 10, quick: bool = False, extra=()) -> None:
    """``--route wgmma``: the builds of :data:`WGMMA_BUILDS`, and ``extra``
    (name, defines) builds of the wgmma source."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops import quant, srvgg, stripe

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)
    specs = [sp for sp in WGMMA_BUILDS if not quick or sp[0] in ("mma", "full", "clocks")]
    specs += [(name, "conv3x3_i8_wgmma.cu", defs) for name, defs in extra]
    libs = _wgmma_libs(specs)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, bf)

    ws = [rnd(3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.03) for k in range(5)]
    bs = [rnd(GC if k < 4 else NF, scale=0.05) for k in range(5)]
    qs = [quant.quantize_conv_weights(ws[k], quant.rdb_segments(NF, GC, k + 1)) for k in range(5)]
    wq, sw = [q for q, _ in qs], [s for _, s in qs]
    wp = [quant.pack_i8_weights(q) for q in wq]
    wv = rnd(3, 3, NF, NF, scale=0.05)
    wvq, swv = quant.quantize_conv_weights(wv, (0, NF))
    wvp, bv, alv = quant.pack_i8_weights(wvq), rnd(NF, scale=0.05), rnd(NF, scale=0.2)

    def route_of(build):
        return "mma" if build == "mma" else None

    amaxes = {}  # x's |max|, worked out once (not timed)

    def amax_of(x):
        if id(x) not in amaxes:
            amaxes[id(x)] = (x, quant.act_amax_plain(x)[:, None].contiguous())
        return amaxes[id(x)][1]

    def rdb(build, x, x0=None, sas=None):
        with _using(libs[build]):
            return stripe.rdb_fused_i8(x, wq, sw, bs, x0, sas=sas, wp=wp, route=route_of(build),
                                       x_amax=None if sas else amax_of(x)[:, 0])

    def srvgg_conv(build, x, out=None, out_amax=None):
        ax = amax_of(x)
        with _using(libs[build]):
            return quant.conv3x3_i8(x, (0, NF), ax, wvq, swv[:1], bv, act="prelu", alpha=alv,
                                    wp=wvp, out=out, out_amax=out_amax, route=route_of(build),
                                    counter="probe")

    def equal3(tag, got, ref_mma, ref_plain):
        for name, ref in (("mma", ref_mma), ("plain", ref_plain)):
            for g_, r_ in zip(got, ref):
                if not ((g_ is None and r_ is None) or torch.equal(g_, r_)):
                    err = (g_.float() - r_.float()).abs().max().item()
                    raise RuntimeError(f"{tag}: full != {name} (max |diff| {err:.3g})")
        print(f"[check] {tag}: full == mma == plain", flush=True)

    # each conv alone at odd shapes: B = 2, partial tiles, below one tile
    sas = (0.0075, 0.0079, 0.0081, 0.0068, 0.0090)
    for shp in ((2, 9, 70), (1, 5, 7), (2, 37, 53)):
        grow = rnd(*shp, NF + 4 * GC)
        amax = torch.stack([quant.act_amax_plain(grow[..., lo:lo + (NF if lo == 0 else GC)])
                            for lo in quant.rdb_segments(NF, GC, 5)[:5]], 1).contiguous()
        r2 = rnd(*shp, NF)
        for k in range(5):
            segs = quant.rdb_segments(NF, GC, k + 1)
            for static in (False, True):
                kw = (dict(act="lrelu") if k < 4 else
                      dict(r1=grow[..., :NF], s1=0.2, r2=r2, s2=0.2))
                outs = {}
                for build in ("full", "mma", "plain"):
                    oa = None if static else torch.zeros(shp[0], device=dev)
                    a8 = dict(sas=sas[: k + 1]) if static else dict(out_amax=oa)
                    args = (grow[..., :segs[-1]], segs, None if static else amax, wq[k], sw[k],
                            bs[k])
                    if build == "plain":
                        y = quant.conv3x3_i8_plain(*args, **a8, **kw)
                    else:
                        with _using(libs[build]):
                            y = quant.conv3x3_i8(*args, wp=wp[k], route=route_of(build),
                                                 counter="probe", **a8, **kw)
                    outs[build] = (y, oa)
                torch.cuda.synchronize()
                equal3(f"{shp} conv{k + 1} {'static' if static else 'dynamic'}", outs["full"],
                       outs["mma"], outs["plain"])
        x = rnd(*shp, NF)
        outs = {}
        for build in ("full", "mma"):
            oa = torch.zeros(shp[0], device=dev)
            outs[build] = (srvgg_conv(build, x, out_amax=oa), oa)
        pa = torch.zeros(shp[0], device=dev)
        ref = quant.conv3x3_i8_plain(x, (0, NF), quant.act_amax_plain(x)[:, None], wvq, swv[:1],
                                     bv, act="prelu", alpha=alv, out_amax=pa)
        equal3(f"{shp} SRVGG conv", outs["full"], outs["mma"], (ref, pa))
    # the blocked RDB, dynamic and static, against the growth buffer on mma
    for shp in ((2, 9, 70), (1, H, W)):
        x, x0 = rnd(*shp, NF), rnd(*shp, NF)
        for static in (False, True):
            s_ = sas if static else None
            got = rdb("full", x, x0, s_)
            torch.cuda.synchronize()
            equal3(f"{shp} RDB {'static' if static else 'dynamic'}", got, rdb("mma", x, x0, s_),
                   stripe.rdb_fused_i8_plain(x, wq, sw, bs, x0, sas=s_))

    # timings: the five convs, the RDB (dynamic, static) and an SRVGG conv
    timed = _timer(reps)
    names = [n for n, _, _ in specs]
    x = rnd(1, H, W, NF)
    grow = torch.zeros(1, H, W, NF + 4 * GC, dtype=bf, device=dev)
    grow[..., :NF] = x
    tail = torch.zeros(4, 1, H, W, GC, dtype=bf, device=dev)
    out = torch.empty(1, H, W, NF, dtype=bf, device=dev)
    amax = torch.zeros(1, 6, dtype=torch.float32, device=dev)
    amax[:, :1] = quant.act_amax_plain(x)[:, None]
    amax[:, 1:5] = 1.0
    px = H * W

    def conv(build, k):
        segs = quant.rdb_segments(NF, GC, k + 1)
        kw = dict(act="lrelu") if k < 4 else dict(r1=x, s1=0.2)
        if build == "mma":
            xk, y = grow[..., :segs[-1]], grow[..., segs[-1]:segs[-1] + GC] if k < 4 else out
        else:
            xk, y = x, tail[k] if k < 4 else out
            kw["x_tail"] = tail[:k] if k else None
        with _using(libs[build]):
            quant.conv3x3_i8(xk, segs, amax, wq[k], sw[k], bs[k], wp=wp[k], out=y,
                             out_amax=amax[:, k + 1], route=route_of(build), counter="probe",
                             **kw)

    rows = []
    for k in range(5):
        rows.append((f"conv{k + 1} {NF + k * GC}->{GC if k < 4 else NF}", lambda b, k=k: conv(b, k),
                     conv_bound_ms(px, NF + k * GC, GC if k < 4 else NF, int(k == 4))))
    rdb_bound = sum(r[2] for r in rows)
    rows.append(("RDB, five launches", lambda b: rdb(b, x), rdb_bound))
    rows.append(("static-A8 RDB", lambda b: rdb(b, x, sas=sas), rdb_bound))
    rows.append(("SRVGG conv 64->64 prelu", lambda b: srvgg_conv(b, x, out=out),
                 conv_bound_ms(px, NF, NF, 0)))
    if "clocks" in libs:  # where the cycles go, summed over the blocks of one launch
        lib = libs["clocks"]
        v = (ctypes.c_longlong * 12)()
        for tag, fn, _ in rows:
            lib.vr_conv3x3_i8_wgmma_clocks(v)
            fn("clocks")
            torch.cuda.synchronize()
            if lib.vr_conv3x3_i8_wgmma_clocks(v) != 0:
                raise RuntimeError("vr_conv3x3_i8_wgmma_clocks failed")
            steps, tiles = max(v[4], 1), max(v[10], 1)
            stages = steps / tiles  # stages a tile, as the consumers see them
            print(f"[clocks] 1x{H}x{W} {tag}: producer cycles a step: raw window wait "
                  f"{v[0] / steps:.0f}, int8 slot wait {v[1] / steps:.0f}, quantise "
                  f"{v[2] / steps:.0f}, fence + barrier + copies {v[3] / steps:.0f}; consumer "
                  f"cycles a stage: int8 window wait {v[5] / steps:.0f}, issue {v[6] / steps:.0f}, "
                  f"MMA wait {v[7] / steps:.0f}, fold {v[8] / steps:.0f}; epilogue a tile "
                  f"{v[9] / tiles:.0f}; {stages:.1f} stages a tile, consumer cycles a tile "
                  f"{v[11] / tiles:.0f}", flush=True)
    for tag, fn, bound in rows:
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            ms[name].append(timed(lambda n=name: fn(n)))
        print(f"[probe] 1x{H}x{W} {tag} (bound {bound:.3f} ms):" + ";".join(
            f" {n} {a:.3f} / {b_:.3f} ms ({100 * bound / min(a, b_):.0f}%)"
            for n, (a, b_) in ms.items()), flush=True)


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
                    help="the source probed (default: mma)")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per build")
    ap.add_argument("--quick", action="store_true", help="wgmma: the shipped builds only")
    ap.add_argument("--variant", action="append", default=[],
                    help="wgmma: another build, NAME=-DDEF[,-DDEF...] (repeatable)")
    args = ap.parse_args(argv)
    extra = []
    for text in args.variant:
        name, sep, defs = text.partition("=")
        flags = tuple(d for d in defs.split(",") if d)
        if not sep or not name or not all(d.startswith("-D") for d in flags):
            ap.error(f"--variant {text!r}: expected NAME=-DDEF[,-DDEF...]")
        extra.append((name, flags))
    try:
        if args.route == "wgmma":
            probe_wgmma(args.reps, args.quick, extra)
        else:
            probe(args.reps)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probe of K1's tensor-core routes on the card: where one conv's time goes.

The card's machine has no kernel profiler, so this builds one of K1's
sources alone (seconds; the whole library takes over a minute) in several
variants, all in parallel, and times each build on the convs of a flagship
frame.

``--route mma`` (the default): ``csrc/conv3x3_mma.cu`` four times, with the
source's two probe switches:

- ``full``: the kernel as shipped (checked against the plain version);
- ``no_store``: ``-DVR_PROBE_NO_STORE``, all the work but the output stores;
- ``no_mma``: ``-DVR_PROBE_NO_MMA``, the ``cp.async`` ring, its barriers and
  the epilogue, without ``ldmatrix`` and MMAs;
- ``loads``: both switches: what the load pipeline alone costs.

The probe builds compute no valid output; only ``full`` is checked.

``--route wgmma``: ``csrc/conv3x3_mma.cu`` as shipped and
``csrc/conv3x3_wgmma.cu`` in the compile-time variants of
:data:`WGMMA_VARIANTS` (``streamed``: every conv's weights through the
ring, none resident; ``s3``: a shallower ring; ``kc16``: 16 channels a
stage; ``c1``: one consumer warpgroup, a 2-row tile; ``rows1``: two of one
row each; ``c1x2``: one consumer warpgroup, two blocks an SM; ``no_mma``:
the shipped build without its ``wgmma``s, the TMA ring, its barriers and
the epilogue; ``loads``: without the MMAs and the epilogue's loads and
stores, the ring alone; ``epilogue``: without the MMAs and the loads, the
epilogue alone), plus
any ``--variant NAME=-DDEF,...``. Each build's ``ptxas`` lines (registers,
spills, ``wgmma`` serialisation notes) and shared memory a block are
printed; each is checked at odd shapes against the plain version and at
1x1080x1920 against the ``mma`` build (``no_mma`` is not checked), the
``up2`` convs (64 -> 64, 64 -> 32, 192 -> 64 with streamed weights) bit for
bit against it, then the RDB's five convs (on one 192-channel growth buffer),
conv_body (64 -> 64 + residual) and up1 (64 -> 64 read through nearest 2x,
1x1080x1920 -> 2160x3840) are timed with every build, in order and back: ms, TFLOP/s and
the share of each conv's own bound (max of its bytes, each input read once
and each output written once, over 3.35 TB/s, and its operations over 989
TFLOP/s bf16). ``--quick`` stops after the odd shapes: a first call on a
new kernel. ``A`` from registers is not a variant: a tap's A tile is the
window moved by one pixel, which registers cannot move, so it would be
loaded from shared memory once per ``wgmma`` all the same.

``--dtype fp32``: the fp32 route instead, ``csrc/conv3x3_bf16x3_wgmma.cu``
(``"bf16x3"``: three bf16 parts a value, six ``wgmma`` products a MAC) in
the variants of :data:`FP32_VARIANTS` (``no_mma``: the TMA ring and the
split without the MMAs; ``no_store``: without the epilogue's loads and
stores; ``no_split``: the producer's stores of the parts left out;
``products4``, ``products2``: only the largest 4 or 2 of the six products)
plus any ``--variant``, beside ``csrc/conv3x3.cu`` (``fma``, fp32
FMAs): each build checked at odd shapes (ragged B = 2, below one tile,
growth-buffer prefixes and ``out`` slices, ``up2``, PReLU, r1 and r2)
within 1e-4 of the largest value of the plain version (TF32 off), then the
1080p RDB's five convs on one 192-channel fp32 growth buffer, conv_body
and up1 timed with every build, in order and back, beside cuDNN's fp32
``F.conv2d`` (TF32 off), with each conv's share of its bound (its fp32
bytes over 3.35 TB/s, or six bf16 products a MAC over 989 TFLOP/s); then
the RDB (five launches) on every build and as cuDNN's chain of five.

    python -m video_restore_tpu_torch.tools.probe_k1 [--route mma|wgmma] [--dtype bf16|fp32]
        [--reps N] [--quick] [--only NAME,...] [--variant NAME=-DDEF,...]

Needs a CUDA device and ``nvcc``. Prints the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

BUILDS = (
    ("full", ()),
    ("no_store", ("-DVR_PROBE_NO_STORE",)),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("loads", ("-DVR_PROBE_NO_STORE", "-DVR_PROBE_NO_MMA")),
)
# conv3x3_wgmma.cu's variants: (name, defines); "shipped" is the source's own
WGMMA_VARIANTS = (
    ("shipped", ()),
    ("streamed", ("-DVR_WG_RESIDENT=0",)),
    ("s3", ("-DVR_WG_STAGES_RES=3",)),
    ("kc16", ("-DVR_WG_KC=16", "-DVR_WG_STAGES=4", "-DVR_WG_STAGES_RES=6")),
    ("c1", ("-DVR_WG_CONSUMERS=1",)),
    ("rows1", ("-DVR_WG_ROWS=1",)),
    ("c1x2", ("-DVR_WG_CONSUMERS=1", "-DVR_WG_CTAS=2", "-DVR_WG_KC=16", "-DVR_WG_STAGES=3",
              "-DVR_WG_RESIDENT=0")),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("loads", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_STORE")),
    ("epilogue", ("-DVR_PROBE_NO_MMA", "-DVR_PROBE_NO_LOADS")),
)
# conv3x3_bf16x3_wgmma.cu's variants (--dtype fp32): (name, defines)
FP32_VARIANTS = (
    ("shipped", ()),
    ("no_mma", ("-DVR_PROBE_NO_MMA",)),
    ("no_store", ("-DVR_PROBE_NO_STORE",)),
    ("no_split", ("-DVR_PROBE_NO_SPLIT",)),
    ("products4", ("-DVR_PROBE_PRODUCTS=4",)),
    ("products2", ("-DVR_PROBE_PRODUCTS=2",)),
)
# builds whose output is not the function
UNCHECKED = ("no_mma", "no_store", "loads", "epilogue", "no_split", "products4", "products2")
H, W = 1080, 1920
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_MMA_ARGS = [_P] * 7 + [_I] * 5 + [_L] * 4 + [_I, _I, _F, _F, _P]


def parse_variant(text: str) -> Tuple[str, Tuple[str, ...]]:
    """``NAME=-DA=1,-DB=2`` -> (NAME, ("-DA=1", "-DB=2"))."""
    name, sep, defs = text.partition("=")
    flags = tuple(d for d in defs.split(",") if d)
    if not sep or not name or not all(d.startswith("-D") for d in flags):
        raise ValueError(f"--variant {text!r}: expected NAME=-DDEF[,-DDEF...]")
    return name, flags


def source_macros(source: str) -> set:
    """The macro names that ``csrc/<source>`` and the headers it includes
    from ``csrc`` define or test (``#define``, ``#ifdef``, ``#ifndef``,
    ``#if``, ``defined(...)``): the names a ``-D`` can set."""
    from video_restore_tpu_torch.ops import _build

    names, seen, todo = set(), set(), [source]
    while todo:
        path = _build.CSRC / todo.pop()
        if path in seen or not path.exists():
            continue
        seen.add(path)
        text = path.read_text()
        names.update(re.findall(r"^\s*#\s*(?:define|ifdef|ifndef|if)\s+(\w+)", text, re.M))
        names.update(re.findall(r"defined\s*\(?\s*(\w+)", text))
        todo.extend(re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M))
    return names


def unknown_defines(source: str, extra: Sequence[Tuple[str, Tuple[str, ...]]]) -> List[str]:
    """The ``-D`` names of ``extra``'s variants that ``source`` never reads
    (:func:`source_macros`): a misspelt knob would rebuild the shipped
    kernel under another name."""
    known = source_macros(source)
    return [d for _, defs in extra for d in defs if d[2:].split("=")[0] not in known]


def wgmma_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
                 only: Sequence[str] = ()) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(build, source, defines) of ``--route wgmma``: the ``mma`` source as
    shipped, then the wgmma variants (``only``: those names; ``extra``
    appended)."""
    out = [("mma", "conv3x3_mma.cu", ())]
    for name, defs in tuple(WGMMA_VARIANTS) + tuple(extra):
        if not only or name in only:
            out.append((name, "conv3x3_wgmma.cu", tuple(defs)))
    return out


def fp32_builds(extra: Sequence[Tuple[str, Tuple[str, ...]]] = (),
                only: Sequence[str] = ()) -> List[Tuple[str, str, Tuple[str, ...]]]:
    """(build, source, defines) of ``--dtype fp32``: the fp32-FMA source as
    shipped, then the bf16x3 variants (``only``: those names; ``extra``
    appended)."""
    out = [("fma", "conv3x3.cu", ())]
    for name, defs in tuple(FP32_VARIANTS) + tuple(extra):
        if not only or name in only:
            out.append((name, "conv3x3_bf16x3_wgmma.cu", tuple(defs)))
    return out


def fp32_bound_ms(shape: Sequence[int], cin: int, cout: int, residual: bool,
                  up2: bool = False) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") of one fp32 conv on the bf16x3
    route at its output's (B, H, W): its fp32 input read once (at half the
    extent when ``up2``), its output (and residual) written once, at 4 bytes
    a value; six bf16 products a MAC at the tensor rate."""
    px = shape[0] * shape[1] * shape[2]
    nbytes = 4 * (px // (4 if up2 else 1) * cin + px * (cout + (cout if residual else 0)))
    ops = 6 * 2 * px * 9 * cin * cout
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ptxas_lines(name: str, text: str) -> List[str]:
    """Each kernel's registers and spills (the cout 64 and 32 instances of
    the wgmma source), and every note that ``wgmma``s were serialised, from
    ``-Xptxas -v``."""
    out, entry, spill = [], "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = "n64" if "Li8E" in line else "n32" if "Li4E" in line else "kernel"
        elif "spill" in line:
            spill = line.split(",", 1)[-1].strip()
        elif "registers" in line:
            out.append(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}; {spill}")
        elif "Performance Loss" in line or "wgmma.mma_async" in line:
            out.append(f"[build] {name}: {line.strip()}")
    return out


def _compile(specs, subdir: str):
    """{build: loaded library}, every build compiled in parallel."""
    from video_restore_tpu_torch.ops import _build

    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, source, defs in specs:
        so = out / f"libk1_{name.replace(' ', '_')}.so"
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
        if hasattr(lib, "vr_conv3x3_bf16x3"):
            lib.vr_conv3x3_bf16x3.argtypes = _MMA_ARGS + [ctypes.POINTER(_L), _I]
            lib.vr_conv3x3_bf16x3.restype = _I
            lib.vr_conv3x3_bf16x3_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_conv3x3_bf16x3_config.restype = _I
        elif hasattr(lib, "vr_conv3x3"):
            lib.vr_conv3x3.argtypes = [_I] + _MMA_ARGS
            lib.vr_conv3x3.restype = _I
        elif hasattr(lib, "vr_conv3x3_wgmma"):
            lib.vr_conv3x3_wgmma.argtypes = _MMA_ARGS + [ctypes.POINTER(_L), _I, _P]
            lib.vr_conv3x3_wgmma.restype = _I
            lib.vr_conv3x3_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_conv3x3_wgmma_config.restype = _I
        else:
            lib.vr_conv3x3_mma.argtypes = _MMA_ARGS
            lib.vr_conv3x3_mma.restype = _I
        libs[name] = lib
    return libs


def _smi() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print((smi.stdout or smi.stderr).strip(), flush=True)


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


def probe(reps: int = 10) -> None:
    """``--route mma``: the four builds of ``conv3x3_mma.cu``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import conv3x3_plain

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    _smi()
    libs = _compile([(name, "conv3x3_mma.cu", defs) for name, defs in BUILDS], "probe_k1")
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

    timed = _timer(reps)
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


def conv_bound_ms(shape: Sequence[int], cin: int, cout: int, residual: bool) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations") of one conv at (B, H, W): its
    input prefix read once, its output (and residual) once, its multiply-adds
    at the bf16 tensor rate."""
    px = shape[0] * shape[1] * shape[2]
    nbytes = px * 2 * (cin + cout + (cout if residual else 0))
    ops = 2 * px * 9 * cin * cout
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def probe_wgmma(reps: int = 10, quick: bool = False, only: Sequence[str] = (),
                extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--route wgmma``: the variants of ``conv3x3_wgmma.cu`` beside the
    shipped ``conv3x3_mma.cu``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    from video_restore_tpu_torch.ops.tail import conv3x3_plain, wgmma_geometry, wgmma_plan

    dev, bf = torch.device("cuda", 0), torch.bfloat16
    _smi()
    specs = wgmma_builds(extra, only)
    libs = _compile(specs, "probe_k1_wgmma")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo: Dict[str, dict] = {}
    for name, source, _ in specs:
        if source == "conv3x3_wgmma.cu":
            cfg = (ctypes.c_int * 11)()
            libs[name].vr_conv3x3_wgmma_config(cfg)
            geo[name] = wgmma_geometry(libs[name])
            print(f"[build] {name}: tile {cfg[0]}x{cfg[1]}, {cfg[4]} consumer warpgroups, "
                  f"{cfg[7]} channels a stage, {cfg[2]} stages, {cfg[3]} blocks an SM, shared "
                  f"memory {cfg[5]} B (cout 64), {cfg[6]} B (cout 32); weights up to {cfg[8]} B "
                  f"resident with {cfg[9]} stages, {cfg[10]} B", flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, bf)

    def launch(name, x, w, b, out, act=0, alpha=None, r1=None, s1=1.0, r2=None, s2=1.0,
               x_tail=None, up2=False):
        bsz, h, wd, _ = x.shape
        cin, cout = w.shape[-2], w.shape[-1]
        args = (
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if r1 is None else r1.data_ptr(), None if r2 is None else r2.data_ptr(),
            out.data_ptr(), bsz, h, wd, cin, cout, x.stride(2), out.stride(2),
            0 if r1 is None else r1.stride(2), 0 if r2 is None else r2.stride(2),
            act, int(up2), s1, s2, stream,
        )
        if name == "mma":
            code = libs[name].vr_conv3x3_mma(*args)
        else:
            tail = 0 if x_tail is None else x_tail.shape[0]
            plan = wgmma_plan(x.shape, x.stride(2), cout, sms=sms, tail=tail, upsample2=up2,
                              **geo[name]).array()
            code = libs[name].vr_conv3x3_wgmma(
                *args, plan, len(plan), None if x_tail is None else x_tail.data_ptr())
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")

    acts = {"none": 0, "lrelu": 1, "prelu": 2}

    def check(tag, name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if err > 2e-2 * scale:
            raise RuntimeError(f"{tag} ({name}): max |kernel - reference| {err:.3g}")
        return err

    # odd shapes, each build against the plain version; the growth-buffer
    # case also checks that nothing outside the output slice was written. A
    # build that disagrees is named and left out of the timings.
    bad = {}
    for shp in ((1, 5, 7), (2, 37, 53), (6, 19, 70)):
        x = rnd(*shp, 192)
        cases = [
            ("64->64 lrelu", x[..., :64], rnd(3, 3, 64, 64, scale=0.05), 64, "lrelu", False),
            ("64->32 none", x[..., :64], rnd(3, 3, 64, 32, scale=0.05), 32, "none", False),
            ("96->32 lrelu into [96:128]", x[..., :96], rnd(3, 3, 96, 32, scale=0.05), 32,
             "lrelu", True),
            ("192->64 prelu r1+r2", x, rnd(3, 3, 192, 64, scale=0.03), 64, "prelu", False),
        ]
        for tag, xi, w, cout, act, into in cases:
            b, al = rnd(cout, scale=0.1), rnd(cout, scale=0.3)
            kw = {}
            if cout == 64 and xi.shape[-1] == 192:
                kw = dict(r1=x[..., :64], s1=0.2, r2=rnd(*shp, 64), s2=0.2)
            ref = conv3x3_plain(xi, w, b, act=act, alpha=al if act == "prelu" else None, **kw)
            for name, _, _ in specs:
                if name in UNCHECKED or name in bad:
                    continue
                try:
                    if into:
                        buf = x.clone()
                        out = buf[..., 96:128]
                        launch(name, buf[..., :96], w, b, out, acts[act])
                    else:
                        out = torch.empty(*shp, cout, dtype=bf, device=dev)
                        launch(name, xi, w, b, out, acts[act], al if act == "prelu" else None,
                               **kw)
                    torch.cuda.synchronize()
                    err = check(f"{shp} {tag}", name, out, ref)
                    if into:
                        keep = torch.ones(192, dtype=torch.bool, device=dev)
                        keep[96:128] = False
                        if not torch.equal(buf[..., keep], x[..., keep]):
                            raise RuntimeError(f"{shp} {tag} ({name}): wrote outside its slice")
                except RuntimeError as e:
                    bad[name] = str(e)
                    print(f"[check] FAILED {e}", flush=True)
                    continue
                print(f"[check] {shp} {tag} {name}: err {err:.3g}", flush=True)
        # read through nearest 2x (up1, upconv2): the producer's fine-grid
        # windows, bit for bit the mma build's (the same sums in the same
        # order); 192 -> 64 streams its weights beside the windows
        for tag, xi, w in (("64->64 lrelu up2", x[..., :64], rnd(3, 3, 64, 64, scale=0.05)),
                           ("64->32 lrelu up2", x[..., :64], rnd(3, 3, 64, 32, scale=0.05)),
                           ("192->64 lrelu up2 (weights streamed)", x,
                            rnd(3, 3, 192, 64, scale=0.03))):
            cout = w.shape[-1]
            b = rnd(cout, scale=0.1)
            ref = conv3x3_plain(xi, w, b, act="lrelu", upsample2=True)
            outs = {}
            for name, _, _ in specs:
                if name in UNCHECKED or name in bad:
                    continue
                try:
                    out = torch.full_like(ref, float("nan"))
                    launch(name, xi, w, b, out, 1, up2=True)
                    torch.cuda.synchronize()
                    err = check(f"{shp} {tag}", name, out, ref)
                    if "mma" in outs and not torch.equal(out, outs["mma"]):
                        n_diff = (out != outs["mma"]).sum().item()
                        raise RuntimeError(f"{shp} {tag} ({name}): {n_diff} values differ from mma")
                except RuntimeError as e:
                    bad[name] = str(e)
                    print(f"[check] FAILED {e}", flush=True)
                    continue
                outs[name] = out
                print(f"[check] {shp} {tag} {name}: err {err:.3g}"
                      + (", == mma" if name != "mma" else ""), flush=True)
    specs = [sp for sp in specs if sp[0] not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick or "mma" in bad:
        if bad:
            raise RuntimeError(f"builds disagree with the plain version: {sorted(bad)}")
        return

    timed = _timer(reps)
    grow = rnd(1, H, W, 192)
    x64, res = rnd(1, H, W, 64), rnd(1, H, W, 64)
    convs = []  # (tag, x, w, b, out, kwargs, cin, cout, residual)
    for k, lo in enumerate((64, 96, 128, 160)):
        convs.append((f"conv{k + 1} {lo}->32", grow[..., :lo], rnd(3, 3, lo, 32, scale=0.03),
                      rnd(32, scale=0.05), grow[..., lo : lo + 32], dict(act=1), lo, 32, False))
    convs.append(("conv5 192->64 +x", grow, rnd(3, 3, 192, 64, scale=0.03), rnd(64, scale=0.05),
                  torch.empty(1, H, W, 64, dtype=bf, device=dev),
                  dict(r1=grow[..., :64], s1=0.2), 192, 64, True))
    convs.append(("conv_body 64->64 +res", x64, rnd(3, 3, 64, 64, scale=0.03),
                  rnd(64, scale=0.05), torch.empty(1, H, W, 64, dtype=bf, device=dev),
                  dict(r1=res), 64, 64, True))
    convs.append(("up1 64->64 up2 lrelu", x64, rnd(3, 3, 64, 64, scale=0.03),
                  rnd(64, scale=0.05), torch.empty(1, 2 * H, 2 * W, 64, dtype=bf, device=dev),
                  dict(act=1, up2=True), 64, 64, False))
    names = [n for n, _, _ in specs]
    rdb = {n: [0.0, 0.0] for n in names}
    for tag, x, w, b, out, kw, cin, cout, resid in convs:
        launch("mma", x, w, b, out, **kw)
        torch.cuda.synchronize()
        ref = out.clone()
        for name in names:
            if name not in UNCHECKED and name != "mma":
                launch(name, x, w, b, out, **kw)
                torch.cuda.synchronize()
                check(f"1x{H}x{W} {tag}", name, out, ref)
        del ref
        bound, by = conv_bound_ms((1, H, W), cin, cout, resid)
        ops = 2 * H * W * 9 * cin * cout
        if kw.get("up2"):  # x read once at (H, W); 9 taps at each of (2H, 2W)
            ops *= 4
            t_b, t_o = H * W * 2 * (cin + 4 * cout) / HBM_BYTES_S * 1e3, ops / BF16_OPS_S * 1e3
            bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        ms = {n: [] for n in names}
        for name in names + names[::-1]:
            ms[name].append(timed(lambda n=name: launch(n, x, w, b, out, **kw)))
        line = f"[probe] 1x{H}x{W} {tag} (bound {bound:.3f} ms, {by}):"
        for name in names:
            a, b_ = ms[name]
            t = min(a, b_)
            if tag.startswith("conv"):
                rdb[name][0] += a
                rdb[name][1] += b_
            line += (f" {name} {a:.3f} / {b_:.3f} ms ({ops / t / 1e9:.1f} TFLOP/s, "
                     f"{100 * bound / t:.0f}% of bound);")
        print(line.rstrip(";"), flush=True)
    # yardsticks: conv1's output bytes written by a PyTorch copy into the
    # growth buffer's slice (64 bytes every 384) and into a tensor of its own
    src = rnd(1, H, W, 32)
    own = torch.empty_like(src)
    line = "[probe] copies of 1x{}x{}x32 bf16:".format(H, W)
    for tag, fn in (("into the growth buffer's slice", lambda: grow[..., 64:96].copy_(src)),
                    ("contiguous", lambda: own.copy_(src))):
        ms_ = timed(fn)
        line += f" {tag} {ms_:.3f} ms ({2 * src.numel() * 2 / ms_ / 1e9:.2f} TB/s read + write);"
    print(line.rstrip(";"), flush=True)
    five = sum(conv_bound_ms((1, H, W), 64 + 32 * k, 32, False)[0] for k in range(4))
    five += conv_bound_ms((1, H, W), 192, 64, True)[0]
    print(f"[probe] 1x{H}x{W} RDB, five launches (bound {five:.3f} ms):" + ";".join(
        f" {n} {a:.3f} / {b_:.3f} ms" for n, (a, b_) in rdb.items()), flush=True)
    # the RDB as ops/stripe.py runs it on the wgmma route: x and c1 .. c4 in
    # blocks of a (4, 1, H, W, 32) tail, conv k reading x and blocks < k
    x, out = grow[..., :64].contiguous(), torch.empty(1, H, W, 64, dtype=bf, device=dev)
    tail = torch.empty(4, 1, H, W, 32, dtype=bf, device=dev)
    wb = [(c[2], c[3]) for c in convs[:5]]

    def rdb_blocked(name):
        for k in range(4):
            launch(name, x, *wb[k], tail[k], act=1, x_tail=tail[:k] if k else None)
        launch(name, x, *wb[4], out, r1=x, s1=0.2, x_tail=tail)

    # the tail's blocks are the stage's channels: builds of another stage
    # width cannot read this one
    wnames = [n for n in names if n != "mma" and n not in UNCHECKED and geo[n]["kc"] == 32]
    if wnames:
        from video_restore_tpu_torch.ops.stripe import rdb_fused_plain

        ref = rdb_fused_plain(x, [w_ for w_, _ in wb], [b_ for _, b_ in wb])
        line = f"[probe] 1x{H}x{W} RDB, five launches, c1 .. c4 in blocks (held to plain):"
        for name in wnames:
            rdb_blocked(name)
            torch.cuda.synchronize()
            check("blocked RDB", name, out, ref)
        ms = {n: [] for n in wnames}
        for name in wnames + wnames[::-1]:
            ms[name].append(timed(lambda n=name: rdb_blocked(n)))
        print(line + ";".join(f" {n} {a:.3f} / {b_:.3f} ms" for n, (a, b_) in ms.items()),
              flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the plain version: {sorted(bad)}")


def probe_fp32(reps: int = 10, quick: bool = False, only: Sequence[str] = (),
               extra: Sequence[Tuple[str, Tuple[str, ...]]] = ()) -> None:
    """``--dtype fp32``: the variants of ``conv3x3_bf16x3_wgmma.cu`` beside
    ``conv3x3.cu`` and cuDNN's fp32 convolution."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: this probe times the card")
    import torch.nn.functional as F

    from video_restore_tpu_torch.ops.tail import (
        bf16x3_geometry,
        bf16x3_plan,
        conv3x3_plain,
        split3,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, f32 = torch.device("cuda", 0), torch.float32
    _smi()
    specs = fp32_builds(extra, only)
    libs = _compile(specs, "probe_k1_fp32")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo: Dict[str, dict] = {}
    for name, source, _ in specs:
        if source == "conv3x3_bf16x3_wgmma.cu":
            cfg = (ctypes.c_int * 7)()
            libs[name].vr_conv3x3_bf16x3_config(cfg)
            geo[name] = bf16x3_geometry(libs[name])
            print(f"[build] {name}: tiles {cfg[0]}x{cfg[2]} (cout 32), {cfg[1]}x{cfg[2]} (cout "
                  f"64), {cfg[3]} channels a stage, {cfg[4]} consumer warpgroups, shared memory "
                  f"{cfg[5]} / {cfg[6]} B (cout 32 / 64)", flush=True)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).to(dev, f32)

    # each weight's parts, split once; the entry holds the weight, so that
    # its id is not reused while the entry lives
    w3_of: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def launch(name, x, w, b, out, act=0, alpha=None, r1=None, s1=1.0, r2=None, s2=1.0,
               up2=False):
        bsz, h, wd, _ = x.shape
        cin, cout = w.shape[-2], w.shape[-1]
        if name != "fma" and id(w) not in w3_of:
            w3_of[id(w)] = (w, split3(w))
        args = (
            x.data_ptr(), (w if name == "fma" else w3_of[id(w)][1]).data_ptr(), b.data_ptr(),
            None if alpha is None else alpha.data_ptr(),
            None if r1 is None else r1.data_ptr(), None if r2 is None else r2.data_ptr(),
            out.data_ptr(), bsz, h, wd, cin, cout, x.stride(2), out.stride(2),
            0 if r1 is None else r1.stride(2), 0 if r2 is None else r2.stride(2),
            act, int(up2), s1, s2, stream,
        )
        if name == "fma":
            code = libs[name].vr_conv3x3(0, *args)
        else:
            plan = bf16x3_plan(x.shape, x.stride(2), cout, sms=sms, upsample2=up2,
                               geometry=geo[name]).array()
            code = libs[name].vr_conv3x3_bf16x3(*args, plan, len(plan))
        if code != 0:
            raise RuntimeError(f"{name} launch: CUDA error {code}")

    acts = {"none": 0, "lrelu": 1, "prelu": 2}

    def check(tag, name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if not err <= 1e-4 * scale:
            raise RuntimeError(f"{tag} ({name}): max |kernel - reference| {err:.3g}")
        return err

    # odd shapes, each build against the plain version (fp32, TF32 off); the
    # growth-buffer case also checks that nothing outside the slice was
    # written. A build that disagrees is named and left out of the timings.
    bad = {}
    for shp in ((1, 5, 7), (2, 37, 53), (6, 19, 70)):
        x = rnd(*shp, 192)
        cases = [
            ("64->64 lrelu", x[..., :64], rnd(3, 3, 64, 64, scale=0.05), "lrelu", False, {}),
            ("64->32 none", x[..., :64], rnd(3, 3, 64, 32, scale=0.05), "none", False, {}),
            ("96->32 lrelu into [96:128]", x[..., :96], rnd(3, 3, 96, 32, scale=0.05), "lrelu",
             True, {}),
            ("192->64 prelu r1+r2", x, rnd(3, 3, 192, 64, scale=0.03), "prelu", False,
             dict(r1=x[..., :64], s1=0.2, r2=rnd(*shp, 64), s2=0.2)),
            ("64->64 lrelu up2", x[..., :64], rnd(3, 3, 64, 64, scale=0.05), "lrelu", False,
             dict(up2=True)),
            ("64->32 none up2", x[..., :64], rnd(3, 3, 64, 32, scale=0.05), "none", False,
             dict(up2=True)),
            ("192->64 lrelu up2", x, rnd(3, 3, 192, 64, scale=0.03), "lrelu", False,
             dict(up2=True)),
        ]
        for tag, xi, w, act, into, kw in cases:
            cout = w.shape[-1]
            b, al = rnd(cout, scale=0.1), rnd(cout, scale=0.3)
            alpha = al if act == "prelu" else None
            pk = {k: v for k, v in kw.items() if k != "up2"}
            ref = conv3x3_plain(xi, w, b, act=act, alpha=alpha, upsample2=kw.get("up2", False),
                                **pk)
            for name, _, _ in specs:
                if name in UNCHECKED or name in bad:
                    continue
                try:
                    if into:
                        buf = x.clone()
                        out = buf[..., 96:128]
                        launch(name, buf[..., :96], w, b, out, acts[act])
                    else:
                        out = torch.full_like(ref, float("nan"))
                        launch(name, xi, w, b, out, acts[act], alpha, **kw)
                    torch.cuda.synchronize()
                    err = check(f"{shp} {tag}", name, out, ref)
                    if into:
                        keep = torch.ones(192, dtype=torch.bool, device=dev)
                        keep[96:128] = False
                        if not torch.equal(buf[..., keep], x[..., keep]):
                            raise RuntimeError(f"{shp} {tag} ({name}): wrote outside its slice")
                except RuntimeError as e:
                    bad[name] = str(e)
                    print(f"[check] FAILED {e}", flush=True)
                    continue
                print(f"[check] fp32 {shp} {tag} {name}: err {err:.3g}", flush=True)
    specs = [sp for sp in specs if sp[0] not in bad]
    if bad:
        print(f"[check] left out: {sorted(bad)}", flush=True)
    if quick or "fma" in bad:
        if bad:
            raise RuntimeError(f"builds disagree with the plain version: {sorted(bad)}")
        return

    timed = _timer(reps)
    grow = rnd(1, H, W, 192)
    x64, res = rnd(1, H, W, 64), rnd(1, H, W, 64)
    convs = []  # (tag, x, w, b, out, kwargs, cin, cout, residual)
    for k, lo in enumerate((64, 96, 128, 160)):
        convs.append((f"conv{k + 1} {lo}->32", grow[..., :lo], rnd(3, 3, lo, 32, scale=0.03),
                      rnd(32, scale=0.05), grow[..., lo : lo + 32], dict(act=1), lo, 32, False))
    convs.append(("conv5 192->64 +x", grow, rnd(3, 3, 192, 64, scale=0.03), rnd(64, scale=0.05),
                  torch.empty(1, H, W, 64, dtype=f32, device=dev),
                  dict(r1=grow[..., :64], s1=0.2), 192, 64, True))
    convs.append(("conv_body 64->64 +res", x64, rnd(3, 3, 64, 64, scale=0.03),
                  rnd(64, scale=0.05), torch.empty(1, H, W, 64, dtype=f32, device=dev),
                  dict(r1=res), 64, 64, True))
    convs.append(("up1 64->64 up2 lrelu", x64, rnd(3, 3, 64, 64, scale=0.03),
                  rnd(64, scale=0.05), torch.empty(1, 2 * H, 2 * W, 64, dtype=f32, device=dev),
                  dict(act=1, up2=True), 64, 64, False))
    names = [n for n, _, _ in specs]
    rdb = {n: [0.0, 0.0] for n in names + ["cudnn"]}
    for tag, x, w, b, out, kw, cin, cout, resid in convs:
        up2 = kw.get("up2", False)
        launch("fma", x, w, b, out, **kw)
        torch.cuda.synchronize()
        ref = out.clone()
        for name in names:
            if name not in UNCHECKED and name != "fma":
                launch(name, x, w, b, out, **kw)
                torch.cuda.synchronize()
                check(f"1x{H}x{W} {tag}", name, out, ref)
        del ref
        oshape = (1, 2 * H, 2 * W) if up2 else (1, H, W)
        bound, by = fp32_bound_ms(oshape, cin, cout, resid, up2)
        ops = 2 * oshape[1] * oshape[2] * 9 * cin * cout
        xin = torch.empty(1, cin, *oshape[1:], dtype=f32, device=dev).contiguous(
            memory_format=torch.channels_last)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        ms = {n: [] for n in names + ["cudnn"]}
        for name in names + ["cudnn"] + ["cudnn"] + names[::-1]:
            if name == "cudnn":
                ms[name].append(timed(lambda: F.conv2d(xin, w_oihw, b, padding=1)))
            else:
                ms[name].append(timed(lambda n=name: launch(n, x, w, b, out, **kw)))
        del xin
        line = f"[probe] fp32 1x{oshape[1]}x{oshape[2]} {tag} (bound {bound:.3f} ms, {by}):"
        for name in names + ["cudnn"]:
            a, b_ = ms[name]
            t = min(a, b_)
            if tag.startswith("conv"):
                rdb[name][0] += a
                rdb[name][1] += b_
            line += (f" {name} {a:.3f} / {b_:.3f} ms ({ops / t / 1e9:.1f} TFLOP/s useful, "
                     f"{100 * bound / t:.0f}% of bound);")
        print(line.rstrip(";"), flush=True)
    five = sum(fp32_bound_ms((1, H, W), 64 + 32 * k, 32, False)[0] for k in range(4))
    five += fp32_bound_ms((1, H, W), 192, 64, True)[0]
    print(f"[probe] fp32 1x{H}x{W} RDB, five launches (bound {five:.3f} ms; cudnn: F.conv2d "
          "alone, TF32 off):" + ";".join(f" {n} {a:.3f} / {b_:.3f} ms" for n, (a, b_) in rdb.items()),
          flush=True)
    if bad:
        raise RuntimeError(f"builds disagree with the plain version: {sorted(bad)}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", choices=("mma", "wgmma"), default="mma",
                    help="the source probed (default: mma)")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16",
                    help="fp32: the bf16x3 route beside the fp32-FMA kernel (any --route)")
    ap.add_argument("--reps", type=int, default=10, help="timed launches per build")
    ap.add_argument("--quick", action="store_true",
                    help="wgmma, fp32: build and check at odd shapes only")
    ap.add_argument("--only", default="", help="wgmma, fp32: comma-separated variant names")
    ap.add_argument("--variant", action="append", default=[],
                    help="wgmma, fp32: another variant, NAME=-DDEF[,-DDEF...] (repeatable)")
    args = ap.parse_args(argv)
    try:
        extra = [parse_variant(v) for v in args.variant]
    except ValueError as e:
        ap.error(str(e))
    only = [n for n in args.only.split(",") if n]
    source = ("conv3x3_bf16x3_wgmma.cu" if args.dtype == "fp32" else
              "conv3x3_wgmma.cu" if args.route == "wgmma" else None)
    if source and extra:
        bad = unknown_defines(source, extra)
        if bad:
            ap.error(f"--variant: {source} reads no macro of {bad}")
    try:
        if args.dtype == "fp32":
            probe_fp32(args.reps, args.quick, only + [n for n, _ in extra] if only else (),
                       extra)
        elif args.route == "mma":
            probe(args.reps)
        else:
            probe_wgmma(args.reps, args.quick, only + [n for n, _ in extra] if only else (),
                        extra)
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

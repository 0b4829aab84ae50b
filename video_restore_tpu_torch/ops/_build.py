"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``video_restore_tpu_torch/csrc/`` have a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together, then one link; the slowest source sets
the build's time, and ``build.log`` gives each source's seconds) into a
single shared library under ``build/video_restore_tpu_torch/`` at the repository root,
named by a hash of every file under ``csrc/`` (headers included) and the
flags, so an edited source or header rebuilds. The
library is loaded with ``ctypes``. Nothing here runs at import time, so
every module of the package imports on a machine without ``nvcc`` or a GPU.

Launch counters: every kernel wrapper adds one to its name's count where it
launches its kernel, and nowhere else, so a run can show that it went
through the kernels. :func:`reset_launches` and :func:`launches` read and
clear them. The counts are kept under a lock: several dispatch threads (one
per device of a sharded upscaler) launch at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (
    "conv3x3.cu", "conv3x3_mma.cu", "conv3x3_wgmma.cu", "conv3x3_bf16x3_wgmma.cu",
    "conv3x3_narrow.cu", "unsharp.cu",
    "unsharp_rows.cu", "unsharp_rows_bf16.cu", "srvgg_up.cu", "srvgg_up_mma.cu",
    "srvgg_up_bf16x3.cu", "conv3x3_i8.cu",
    "conv3x3_i8_mma.cu", "conv3x3_i8_wgmma.cu", "rdb_fused.cu", "rdb_fused_f32.cu",
    "rdb_fused_bf16.cu", "rdb_fused_narrow.cu", "rdb_fused_mma.cu", "rdb_fused_wgmma.cu",
    "rdb_fused_bf16x3.cu",
    "tail_fused.cu", "tail_fused_mma.cu", "tail_fused_wgmma.cu", "tail_fused_bf16x3.cu",
)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "video_restore_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_launches: Dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)


_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1


def reset_launches() -> None:
    with _count_lock:
        _launches.clear()


def launches() -> Dict[str, int]:
    with _count_lock:
        return dict(_launches)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): cannot build the "
            "CUDA kernels"
        )
    return str(path)


def compile_seconds(log: str) -> Dict[str, float]:
    """Each source's ``nvcc`` wall seconds from a ``build.log``'s ``==``
    lines, in build order (empty for a log that gives none)."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^== (\S+) \(rc -?\d+, ([0-9.]+) s\)$", log, re.M)}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCES).encode())
    for path in sorted(CSRC.iterdir()):  # the headers too
        if path.is_file():
            h.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"libvrt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (if this hash is not built yet); returns the
    library path. Each source's compiler output, its resource report
    (``-Xptxas -v``) included, goes to ``build.log`` beside it under a line
    ``== NAME (rc N, S s)``: S is that ``nvcc``'s wall seconds."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}_{os.getpid()}"  # concurrent builds never share files
    procs = []
    t0 = time.monotonic()
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}_{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append(
            (name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        )
    done: Dict[str, Tuple[str, float]] = {}

    def reap(name: str, p: subprocess.Popen) -> None:
        # one reader per process: each end is timed when it happens
        text, _ = p.communicate()
        done[name] = (text, time.monotonic() - t0)

    readers = [threading.Thread(target=reap, args=(name, p)) for name, _, p in procs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    log = []
    failed = []
    for name, _, p in procs:
        text, secs = done[name]
        log.append(f"== {name} (rc {p.returncode}, {secs:.1f} s)\n{text}")
        if p.returncode != 0:
            failed.append(name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)[-4000:]
        )
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.vr_conv3x3.argtypes = [
                _I, _P, _P, _P, _P, _P, _P, _P,
                _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, _F, _F, _P,
            ]
            lib.vr_conv3x3.restype = _I
            lib.vr_conv3x3_mma.argtypes = lib.vr_conv3x3.argtypes[1:]
            lib.vr_conv3x3_mma.restype = _I
            # the mma arguments, then the plan (ops/tail.py::wgmma_plan)
            lib.vr_conv3x3_wgmma.argtypes = lib.vr_conv3x3.argtypes[1:] + [
                ctypes.POINTER(_L), _I, _P,
            ]
            lib.vr_conv3x3_wgmma.restype = _I
            lib.vr_conv3x3_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_conv3x3_wgmma_config.restype = _I
            # fp32 on the bf16 tensor cores: the mma arguments (w the split
            # parts), then the plan (ops/tail.py::bf16x3_plan)
            lib.vr_conv3x3_bf16x3.argtypes = lib.vr_conv3x3.argtypes[1:] + [
                ctypes.POINTER(_L), _I,
            ]
            lib.vr_conv3x3_bf16x3.restype = _I
            lib.vr_conv3x3_bf16x3_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_conv3x3_bf16x3_config.restype = _I
            # dtype, then the mma arguments, then the fp32 conv_last's plan
            # (ops/tail.py::last32_plan; null and 0 for the other calls)
            lib.vr_conv3x3_narrow.argtypes = lib.vr_conv3x3.argtypes + [ctypes.POINTER(_L), _I]
            lib.vr_conv3x3_narrow.restype = _I
            lib.vr_unsharp.argtypes = [
                _P, _P, _I, _I, _I, _I, _I, ctypes.POINTER(_F), _F, _F, _P,
            ]
            lib.vr_unsharp.restype = _I
            # the bf16 instances take the same arguments (x, y as void*)
            for fn in (lib.vr_unsharp_rows, lib.vr_unsharp_bf16, lib.vr_unsharp_rows_bf16):
                fn.argtypes = lib.vr_unsharp.argtypes
                fn.restype = _I
            # radius -> registers a thread, resident blocks per SM
            for fn in (lib.vr_unsharp_rows_info, lib.vr_unsharp_rows_bf16_info):
                fn.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
                fn.restype = _I
            lib.vr_srvgg_up.argtypes = [
                _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
            ]
            lib.vr_srvgg_up.restype = _I
            # r, x, w, b, skip, y, B, H, W, cin, stream
            lib.vr_srvgg_up_mma.argtypes = lib.vr_srvgg_up.argtypes[1:]
            lib.vr_srvgg_up_mma.restype = _I
            # fp32: the same (w the K-major split parts), then the plan
            # (ops/srvgg.py::srvgg_up_x3_plan)
            lib.vr_srvgg_up_bf16x3.argtypes = lib.vr_srvgg_up_mma.argtypes + [
                ctypes.POINTER(_L), _I,
            ]
            lib.vr_srvgg_up_bf16x3.restype = _I
            lib.vr_srvgg_up_bf16x3_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_srvgg_up_bf16x3_config.restype = _I
            lib.vr_conv3x3_i8.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                _I, ctypes.POINTER(_I), ctypes.POINTER(_F), ctypes.POINTER(_F),
                _I, _F, _F, _P,
            ]
            lib.vr_conv3x3_i8.restype = _I
            lib.vr_conv3x3_i8_mma.argtypes = lib.vr_conv3x3_i8.argtypes
            lib.vr_conv3x3_i8_mma.restype = _I
            # the same, then the plan (ops/quant.py::i8_wgmma_plan) and the tail
            lib.vr_conv3x3_i8_wgmma.argtypes = lib.vr_conv3x3_i8.argtypes + [
                ctypes.POINTER(_L), _I, _P,
            ]
            lib.vr_conv3x3_i8_wgmma.restype = _I
            lib.vr_conv3x3_i8_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_conv3x3_i8_wgmma_config.restype = _I
            lib.vr_amax_bf16.argtypes = [_P, _P, _I, _I, _I, _L, _L, _P]
            lib.vr_amax_bf16.restype = _I
            for fn in (lib.vr_rdb_fused, lib.vr_rrdb_fused,
                       lib.vr_rdb_fused_mma, lib.vr_rrdb_fused_mma):
                # dtype, nf, gc, x, x0 | y, y | scratch, ws, bs, B, H, W, stream
                fn.argtypes = [_I, _I, _I, _P, _P, _P, _PP, _PP, _I, _I, _I, _P]
                fn.restype = _I
            # the same, then the plan (ops/rdb.py::rdb_wgmma_plan)
            for fn in (lib.vr_rdb_fused_wgmma, lib.vr_rrdb_fused_wgmma):
                fn.argtypes = lib.vr_rdb_fused.argtypes + [ctypes.POINTER(_L), _I]
                fn.restype = _I
            lib.vr_rdb_fused_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_rdb_fused_wgmma_config.restype = _I
            # nf, gc, rdbs, x, x0, y, scratch, c, ws (parts), bs, B, H, W,
            # stream, then the plan (ops/rdb.py::rdb_x3_plan)
            lib.vr_rdb_fused_bf16x3.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _PP, _PP, _I, _I,
                                                _I, _P, ctypes.POINTER(_L), _I]
            lib.vr_rdb_fused_bf16x3.restype = _I
            lib.vr_rdb_fused_bf16x3_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_rdb_fused_bf16x3_config.restype = _I
            # dtype, nf, x, y, three (w, b) pairs, B, H2, W2, stream
            lib.vr_tail_fused.argtypes = [_I, _I] + [_P] * 8 + [_I, _I, _I, _P]
            lib.vr_tail_fused.restype = _I
            lib.vr_tail_fused_mma.argtypes = lib.vr_tail_fused.argtypes
            lib.vr_tail_fused_mma.restype = _I
            # the same, then the plan (ops/tail.py::tail_wgmma_plan)
            lib.vr_tail_fused_wgmma.argtypes = lib.vr_tail_fused.argtypes + [
                ctypes.POINTER(_L), _I,
            ]
            lib.vr_tail_fused_wgmma.restype = _I
            lib.vr_tail_fused_wgmma_config.argtypes = [ctypes.POINTER(_I)]
            lib.vr_tail_fused_wgmma_config.restype = _I
            # fp32: nf, x, y, three (w, b) pairs (the wide ones' weights as
            # split parts), B, H2, W2, stream, then the plan
            # (ops/tail.py::tail_x3_plan)
            lib.vr_tail_fused_bf16x3.argtypes = [_I] + [_P] * 8 + [_I, _I, _I, _P,
                                                                   ctypes.POINTER(_L), _I]
            lib.vr_tail_fused_bf16x3.restype = _I
            lib.vr_error_string.argtypes = [_I]
            lib.vr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.vr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pointers(ts) -> ctypes.Array:
    """A C array of the tensors' device pointers (``const void* const*``)."""
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

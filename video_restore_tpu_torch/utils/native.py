"""Lazy build and ctypes loader for the native framecodec library.

Port of ``video_restore_tpu/utils/native.py``. The host's colour
conversion (BT.601 studio range, fixed-point integer arithmetic, OpenMP
across rows) lives in the package's own copy of the C++ source,
``video_restore_tpu_torch/native/framecodec.cpp``. It is compiled with
``g++`` at first use into ``build/video_restore_tpu_torch/`` at the
repository root (``$VRT_NATIVE_CACHE`` when that is set), under a name
that hashes the source and the flags, and written through a temporary file
and ``os.replace``: processes that build at once never load a half-written
library. ``VRT_DISABLE_NATIVE=1`` skips the library, and without a
compiler every function returns None, so the caller takes its numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "framecodec.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "video_restore_tpu_torch"
# with OpenMP first, then without (a compiler that lacks it)
_FLAG_SETS = (
    ("-O3", "-shared", "-fPIC", "-fopenmp"),
    ("-O3", "-shared", "-fPIC"),
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> Path:
    env = os.environ.get("VRT_NATIVE_CACHE")
    return Path(env) if env else _BUILD_DIR


def library_path(flags: Tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode() + _SRC.read_bytes())
    return _cache_dir() / f"libframecodec_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    for flags in _FLAG_SETS:
        out = library_path(flags)
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            r = subprocess.run(
                ["g++", *flags, str(_SRC), "-o", str(tmp)],
                capture_output=True, text=True, timeout=120,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
        tmp.unlink(missing_ok=True)
    return None


def load() -> Optional[ctypes.CDLL]:
    """Build once, load once; None when the library is unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("VRT_DISABLE_NATIVE") == "1":
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for name, argt in {
                "rgb_to_yuv420": [u8p, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p],
                "rgb_to_yuv444": [u8p, ctypes.c_int, ctypes.c_int, u8p, u8p, u8p],
                "yuv420_to_rgb": [u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, u8p],
                "yuv444_to_rgb": [u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, u8p],
                "swap_rb": [u8p, ctypes.c_int, ctypes.c_int, u8p],
            }.items():
                fn = getattr(lib, name)
                fn.argtypes = argt
                fn.restype = None
            lib.framecodec_abi_version.restype = ctypes.c_int
            if lib.framecodec_abi_version() != 1:
                return None
            _lib = lib
        except (OSError, AttributeError):
            _lib = None
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def rgb_to_yuv(
    frame: np.ndarray, subsample: str
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native RGB -> YUV planes; None if unavailable or the shape is not
    supported (4:2:2, or 4:2:0 with an odd side)."""
    lib = load()
    if lib is None or subsample not in ("420", "444"):
        return None
    h, w = frame.shape[:2]
    if subsample == "420" and (h % 2 or w % 2):
        return None
    frame = np.ascontiguousarray(frame)
    y = np.empty((h, w), np.uint8)
    if subsample == "420":
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty((h // 2, w // 2), np.uint8)
        lib.rgb_to_yuv420(_ptr(frame), h, w, _ptr(y), _ptr(u), _ptr(v))
    else:
        u = np.empty((h, w), np.uint8)
        v = np.empty((h, w), np.uint8)
        lib.rgb_to_yuv444(_ptr(frame), h, w, _ptr(y), _ptr(u), _ptr(v))
    return y, u, v


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> Optional[np.ndarray]:
    """Native YUV planes (4:2:0 or 4:4:4) -> RGB; None if unavailable or
    the layout is another."""
    lib = load()
    if lib is None:
        return None
    h, w = y.shape
    y, u, v = map(np.ascontiguousarray, (y, u, v))
    rgb = np.empty((h, w, 3), np.uint8)
    if u.shape == y.shape:
        lib.yuv444_to_rgb(_ptr(y), _ptr(u), _ptr(v), h, w, _ptr(rgb))
    elif u.shape == (h // 2, w // 2):
        lib.yuv420_to_rgb(_ptr(y), _ptr(u), _ptr(v), h, w, _ptr(rgb))
    else:
        return None
    return rgb

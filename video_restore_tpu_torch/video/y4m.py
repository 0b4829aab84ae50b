"""Pure-Python YUV4MPEG2 (.y4m) reader/writer.

Port of ``video_restore_tpu/video/y4m.py``: studio-range BT.601 colour
conversion through the native framecodec (``utils/native.py``) when it
loads and numpy otherwise, exactly as the JAX package chooses; planar I420
frames from the device (``write_yuv420``); append mode for resume; byte
concatenation of segments. Supports C420jpeg / C420mpeg2 / C420paldv /
C422 / C444.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Tuple, Union

import numpy as np

from video_restore_tpu_torch.video.io_base import VideoInfo, VideoReader, VideoWriter

_MAGIC = b"YUV4MPEG2"


def is_pipe(path) -> bool:
    """True for the stdin/stdout streaming pseudo-paths (``-`` and
    ``pipe:``, the ffmpeg conventions). Streaming mode lets the framework
    sit inside an existing ffmpeg pipeline:

        ffmpeg -i in.mkv -f yuv4mpegpipe - | video-restore - - | \\
            ffmpeg -i - -c:v libx265 out.mkv
    """
    return str(path) in ("-", "pipe:", "pipe:0", "pipe:1")

# BT.601 studio-range RGB<->YUV
_KR, _KG, _KB = 0.299, 0.587, 0.114


def rgb_to_yuv_planes(
    rgb: np.ndarray, subsample: str = "420"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (Y, U, V) uint8 planes (studio range).

    Uses the native fixed-point framecodec when available, else the numpy
    float path below; both implement BT.601 studio range and agree within
    2 LSB."""
    from video_restore_tpu_torch.utils import native

    nat = native.rgb_to_yuv(rgb, subsample)
    if nat is not None:
        return nat
    f = rgb.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _KR * r + _KG * g + _KB * b
    u = (b - y) / (2.0 * (1.0 - _KB))
    v = (r - y) / (2.0 * (1.0 - _KR))
    yq = np.clip(np.round(16.0 + 219.0 * y), 16, 235).astype(np.uint8)
    uq = np.clip(np.round(128.0 + 224.0 * u), 16, 240)
    vq = np.clip(np.round(128.0 + 224.0 * v), 16, 240)
    if subsample == "444":
        return yq, uq.astype(np.uint8), vq.astype(np.uint8)
    if subsample == "422":
        uq = uq.reshape(uq.shape[0], -1, 2).mean(axis=2)
        vq = vq.reshape(vq.shape[0], -1, 2).mean(axis=2)
    else:  # 420: 2x2 average
        uq = uq.reshape(uq.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3))
        vq = vq.reshape(vq.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3))
    return (
        yq,
        np.clip(np.round(uq), 16, 240).astype(np.uint8),
        np.clip(np.round(vq), 16, 240).astype(np.uint8),
    )


def yuv_planes_to_rgb(
    y: np.ndarray, u: np.ndarray, v: np.ndarray
) -> np.ndarray:
    """(Y, U, V) uint8 planes (any 4:2:0/4:2:2/4:4:4 layout) -> uint8 RGB."""
    from video_restore_tpu_torch.utils import native

    nat = native.yuv_to_rgb(y, u, v)
    if nat is not None:
        return nat
    h, w = y.shape
    if u.shape != y.shape:  # upsample chroma (nearest)
        ry, rx = h // u.shape[0], w // u.shape[1]
        u = np.repeat(np.repeat(u, ry, axis=0), rx, axis=1)
        v = np.repeat(np.repeat(v, ry, axis=0), rx, axis=1)
    yf = (y.astype(np.float32) - 16.0) / 219.0
    uf = (u.astype(np.float32) - 128.0) / 224.0
    vf = (v.astype(np.float32) - 128.0) / 224.0
    r = yf + 2.0 * (1.0 - _KR) * vf
    b = yf + 2.0 * (1.0 - _KB) * uf
    g = (yf - _KR * r - _KB * b) / _KG
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def _parse_header(line: bytes) -> VideoInfo:
    parts = line.decode("ascii", "replace").strip().split(" ")
    if parts[0] != _MAGIC.decode():
        raise ValueError("not a YUV4MPEG2 stream")
    w = h = 0
    num, den = 25, 1
    colorspace = "420jpeg"
    for p in parts[1:]:
        if not p:
            continue
        tag, val = p[0], p[1:]
        if tag == "W":
            w = int(val)
        elif tag == "H":
            h = int(val)
        elif tag == "F":
            num, den = (int(x) for x in val.split(":"))
        elif tag == "C":
            colorspace = val
    if not w or not h:
        raise ValueError("y4m header missing W/H")
    return VideoInfo(
        width=w, height=h, fps=num / den, frames=0, codec="rawvideo",
        pix_fmt="yuv" + colorspace,
    )


def _plane_shapes(w: int, h: int, colorspace: str):
    if colorspace.startswith("444"):
        return (h, w), (h, w)
    if colorspace.startswith("422"):
        return (h, w), (h, w // 2)
    if colorspace.startswith("420") or colorspace.startswith("mono"):
        return (h, w), (h // 2, w // 2)
    raise ValueError(f"unsupported y4m colorspace C{colorspace}")


class Y4MReader(VideoReader):
    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        if is_pipe(path):
            import sys

            self._f = sys.stdin.buffer
            self._is_pipe = True
        else:
            self._f = open(self.path, "rb")
            self._is_pipe = False
        header = self._f.readline()
        self.info = _parse_header(header)
        self._colorspace = self.info.pix_fmt[3:]
        self._yshape, self._cshape = _plane_shapes(
            self.info.width, self.info.height, self._colorspace
        )
        # frame count from file size (frames are fixed-size — the analogue
        # of the reference's probe fallbacks, video_upscaler.py:180-203);
        # unknowable for a pipe (frames stays 0 -> open-ended progress)
        if self._is_pipe:
            return
        try:
            hdr = len(header)
            fsz = os.path.getsize(self.path)
            ysz = self._yshape[0] * self._yshape[1]
            csz = self._cshape[0] * self._cshape[1]
            frame_bytes = len(b"FRAME\n") + ysz + 2 * csz
            if fsz > hdr:
                self.info.frames = (fsz - hdr) // frame_bytes
        except OSError:
            pass

    def __iter__(self) -> Iterator[np.ndarray]:
        ysz = self._yshape[0] * self._yshape[1]
        csz = self._cshape[0] * self._cshape[1]
        while True:
            marker = self._f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError("corrupt y4m: missing FRAME marker")
            buf = self._f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return  # truncated tail
            y = np.frombuffer(buf, np.uint8, ysz).reshape(self._yshape)
            u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(self._cshape)
            v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(self._cshape)
            yield yuv_planes_to_rgb(y, u, v)

    def close(self) -> None:
        if not self._is_pipe:  # leave stdin open for the process
            self._f.close()


class Y4MWriter(VideoWriter):
    def __init__(
        self,
        path: Union[str, Path],
        width: int,
        height: int,
        fps: float,
        colorspace: str = "420jpeg",
        append: bool = False,
    ):
        self.path = str(path)
        self._colorspace = colorspace
        self._sub = "444" if colorspace.startswith("444") else (
            "422" if colorspace.startswith("422") else "420"
        )
        if self._sub == "420" and (width % 2 or height % 2):
            raise ValueError("4:2:0 y4m needs even dimensions")
        num, den = _fps_to_fraction(fps)
        self._count = 0
        self._is_pipe = is_pipe(path)
        if self._is_pipe:
            import sys

            self._f = sys.stdout.buffer
            mode = "wb"  # a stream cannot append
        else:
            mode = "ab" if append and os.path.exists(self.path) else "wb"
            self._f = open(self.path, mode)
        if mode == "wb":
            self._f.write(
                f"YUV4MPEG2 W{width} H{height} F{num}:{den} Ip A1:1 "
                f"C{colorspace}\n".encode("ascii")
            )

    def write(self, frame: np.ndarray) -> None:
        y, u, v = rgb_to_yuv_planes(frame, self._sub)
        self._f.write(b"FRAME\n")
        self._f.write(y.tobytes())
        self._f.write(u.tobytes())
        self._f.write(v.tobytes())
        self._count += 1

    def write_yuv420(self, planar: np.ndarray) -> None:
        """Write a planar I420 frame ((H*3//2, W) uint8, as the device's
        ``ops/color.py::rgb_to_yuv420_planar`` emits it): no host colour
        work."""
        if self._sub != "420":
            raise ValueError("write_yuv420 requires a 4:2:0 colorspace")
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(planar).tobytes())
        self._count += 1

    @property
    def frames_written(self) -> int:
        return self._count

    def close(self) -> None:
        if self._is_pipe:  # flush but leave stdout open for the process
            self._f.flush()
        else:
            self._f.close()


def _fps_to_fraction(fps: float) -> Tuple[int, int]:
    """Rational fps, preserving exact NTSC rates (30000/1001 etc.)."""
    for num, den in ((30000, 1001), (24000, 1001), (60000, 1001)):
        if abs(fps - num / den) < 1e-4:
            return num, den
    if abs(fps - round(fps)) < 1e-9:
        return int(round(fps)), 1
    return int(round(fps * 1000)), 1000


def concat_y4m(segments, dest: Union[str, Path]) -> int:
    """Byte-level concat of y4m segments with identical headers; returns
    the total frame count."""
    with open(dest, "wb") as out:
        for i, seg in enumerate(segments):
            with open(seg, "rb") as f:
                header = f.readline()
                if i == 0:
                    out.write(header)
                out.write(f.read())
    with Y4MReader(dest) as r:
        return r.info.frames

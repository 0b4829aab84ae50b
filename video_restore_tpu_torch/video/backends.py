"""Backend registry and auto-selection (port of
``video_restore_tpu/video/backends.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

from video_restore_tpu_torch.video.io_base import VideoInfo, VideoReader, VideoWriter


def ffmpeg_available() -> bool:
    from video_restore_tpu_torch.video.ffmpeg_backend import ffmpeg_path, ffprobe_path

    return ffmpeg_path() is not None and ffprobe_path() is not None


def _pick_backend(path: Union[str, Path], backend: str = "auto") -> str:
    if backend != "auto":
        return backend
    from video_restore_tpu_torch.video.y4m import is_pipe

    if is_pipe(path):
        return "y4m"  # streaming mode: y4m over stdin/stdout
    suffix = Path(path).suffix.lower()
    if suffix == ".y4m":
        return "y4m"
    if suffix == ".npz":
        return "npz"
    return "ffmpeg" if ffmpeg_available() else "opencv"


def probe(path: Union[str, Path], backend: str = "auto") -> VideoInfo:
    b = _pick_backend(path, backend)
    if b == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MReader

        with Y4MReader(path) as r:
            return r.info
    if b == "npz":
        from video_restore_tpu_torch.video.npz_backend import probe_npz

        return probe_npz(path)
    if b == "ffmpeg":
        from video_restore_tpu_torch.video.ffmpeg_backend import probe_ffmpeg

        return probe_ffmpeg(path)
    from video_restore_tpu_torch.video.opencv_backend import probe_opencv

    return probe_opencv(path)


def open_reader(path: Union[str, Path], backend: str = "auto") -> VideoReader:
    b = _pick_backend(path, backend)
    if b == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MReader

        return Y4MReader(path)
    if b == "npz":
        from video_restore_tpu_torch.video.npz_backend import NpzReader

        return NpzReader(path)
    if b == "ffmpeg":
        from video_restore_tpu_torch.video.ffmpeg_backend import FFmpegReader

        return FFmpegReader(path)
    from video_restore_tpu_torch.video.opencv_backend import OpenCVReader

    return OpenCVReader(path)


def writer_supports_yuv420(path: Union[str, Path], backend: str = "auto") -> bool:
    """True when the writer for ``path`` can take device-converted planar
    I420 frames directly (y4m and the ffmpeg pipe; npz/opencv need RGB)."""
    return _pick_backend(path, backend) in ("y4m", "ffmpeg")


def open_writer(
    path: Union[str, Path],
    width: int,
    height: int,
    fps: float,
    *,
    codec: str = "h264",
    crf: int = 15,
    preset: str = "slow",
    backend: str = "auto",
    pix_fmt: str = "rgb24",
) -> VideoWriter:
    b = _pick_backend(path, backend)
    if b == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MWriter

        return Y4MWriter(path, width, height, fps)
    if b == "npz":
        from video_restore_tpu_torch.video.npz_backend import NpzWriter

        return NpzWriter(path, width, height, fps)
    if b == "ffmpeg":
        from video_restore_tpu_torch.video.ffmpeg_backend import FFmpegWriter

        return FFmpegWriter(
            path, width, height, fps, codec=codec, crf=crf, preset=preset,
            pix_fmt=pix_fmt,
        )
    from video_restore_tpu_torch.video.opencv_backend import OpenCVWriter

    return OpenCVWriter(path, width, height, fps, codec=codec)

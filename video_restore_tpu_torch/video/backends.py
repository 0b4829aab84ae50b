"""Backend selection (port of ``video_restore_tpu/video/backends.py``).

Only the y4m and npz backends are ported; other containers need ffmpeg or
OpenCV, which wait for a later slice of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from video_restore_tpu_torch.video.io_base import (
    VideoInfo,
    VideoReader,
    VideoWriter,
)


def _pick_backend(path: Union[str, Path]) -> str:
    from video_restore_tpu_torch.video.y4m import is_pipe

    if is_pipe(path):
        return "y4m"  # streaming mode: y4m over stdin/stdout
    suffix = Path(path).suffix.lower()
    if suffix == ".y4m":
        return "y4m"
    if suffix == ".npz":
        return "npz"
    raise ValueError(
        f"{path}: only .y4m and .npz containers are ported so far "
        "(the ffmpeg and OpenCV backends are not yet ported)"
    )


def probe(path: Union[str, Path]) -> VideoInfo:
    if _pick_backend(path) == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MReader

        with Y4MReader(path) as r:
            return r.info
    from video_restore_tpu_torch.video.npz_backend import probe_npz

    return probe_npz(path)


def open_reader(path: Union[str, Path]) -> VideoReader:
    if _pick_backend(path) == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MReader

        return Y4MReader(path)
    from video_restore_tpu_torch.video.npz_backend import NpzReader

    return NpzReader(path)


def open_writer(
    path: Union[str, Path], width: int, height: int, fps: float
) -> VideoWriter:
    if _pick_backend(path) == "y4m":
        from video_restore_tpu_torch.video.y4m import Y4MWriter

        return Y4MWriter(path, width, height, fps)
    from video_restore_tpu_torch.video.npz_backend import NpzWriter

    return NpzWriter(path, width, height, fps)

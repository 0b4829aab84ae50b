"""Video I/O interfaces and metadata (port of ``video_restore_tpu/video/io_base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class VideoInfo:
    """Probe result; mirrors the dict returned by the reference's
    ``_get_video_info`` (video_upscaler.py:205-211)."""

    width: int
    height: int
    fps: float
    frames: int  # 0 = unknown (the reference's probe can also return 0)
    codec: str = ""
    pix_fmt: str = ""
    has_audio: bool = False


class VideoReader:
    """Iterator of (H, W, 3) uint8 RGB frames."""

    info: VideoInfo

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class VideoWriter:
    """Accepts (H, W, 3) uint8 RGB frames in display order."""

    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def frames_written(self) -> int:
        raise NotImplementedError

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Trivial lossless .npz video container (port of
``video_restore_tpu/video/npz_backend.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Union

import numpy as np

from video_restore_tpu_torch.video.io_base import VideoInfo, VideoReader, VideoWriter


def probe_npz(path: Union[str, Path]) -> VideoInfo:
    with np.load(path) as d:
        frames = d["frames"]
        fps = float(d["fps"]) if "fps" in d else 25.0
    return VideoInfo(
        width=frames.shape[2],
        height=frames.shape[1],
        fps=fps,
        frames=frames.shape[0],
        codec="npz",
    )


class NpzReader(VideoReader):
    def __init__(self, path: Union[str, Path]):
        self.path = str(path)
        self._data = np.load(self.path)
        frames = self._data["frames"]
        self.info = VideoInfo(
            width=frames.shape[2], height=frames.shape[1],
            fps=float(self._data["fps"]) if "fps" in self._data else 25.0,
            frames=frames.shape[0], codec="npz",
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        for f in self._data["frames"]:
            yield f

    def close(self) -> None:
        self._data.close()


class NpzWriter(VideoWriter):
    def __init__(self, path: Union[str, Path], width: int, height: int,
                 fps: float, **_unused):
        self.path = str(path)
        self._fps = fps
        self._frames = []

    def write(self, frame: np.ndarray) -> None:
        # a copy: the caller may reuse its buffer (a pinned fetch slot)
        self._frames.append(np.array(frame, np.uint8))

    @property
    def frames_written(self) -> int:
        return len(self._frames)

    def close(self) -> None:
        np.savez(
            self.path,
            frames=np.stack(self._frames) if self._frames else
            np.zeros((0, 1, 1, 3), np.uint8),
            fps=self._fps,
        )

"""OpenCV video backend (bundled codecs; no external ffmpeg binary needed).

Port of ``video_restore_tpu/video/opencv_backend.py``; ``cv2`` is imported
at first use, so the module imports without it.

Fallback decode/encode path for hosts without an ffmpeg binary. cv2 works
in BGR; frames are converted to/from the framework's RGB interchange format
at this boundary. No audio support (use the ffmpeg backend for audio
passthrough, reference video_upscaler.py:604-627).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Union

import numpy as np

from video_restore_tpu_torch.video.io_base import VideoInfo, VideoReader, VideoWriter


def _cv2():
    import cv2

    return cv2


def probe_opencv(path: Union[str, Path]) -> VideoInfo:
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise ValueError(f"OpenCV cannot open {path}")
    try:
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
        codec = "".join(
            chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)
        ).strip("\x00 ").lower()
        return VideoInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)) or 25.0,
            frames=max(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0),
            codec=codec,
        )
    finally:
        cap.release()


class OpenCVReader(VideoReader):
    def __init__(self, path: Union[str, Path]):
        cv2 = _cv2()
        self.path = str(path)
        self.info = probe_opencv(path)
        self._cap = cv2.VideoCapture(self.path)

    def __iter__(self) -> Iterator[np.ndarray]:
        cv2 = _cv2()
        try:
            while True:
                ok, frame = self._cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            self.close()

    def close(self) -> None:
        self._cap.release()


_FOURCC = {"mpeg4": "mp4v", "h264": "avc1", "h265": "hvc1", "mjpeg": "MJPG"}


class OpenCVWriter(VideoWriter):
    def __init__(
        self,
        path: Union[str, Path],
        width: int,
        height: int,
        fps: float,
        codec: str = "mpeg4",
        **_unused,
    ):
        cv2 = _cv2()
        self.path = str(path)
        order = [codec] + [c for c in ("h264", "mpeg4", "mjpeg") if c != codec]
        self._writer = None
        for c in order:
            w = cv2.VideoWriter(
                self.path,
                cv2.VideoWriter_fourcc(*_FOURCC.get(c, "mp4v")),
                fps,
                (width, height),
            )
            if w.isOpened():
                self._writer = w
                self.codec = c
                break
            w.release()
        if self._writer is None:
            raise RuntimeError(f"OpenCV cannot open a writer for {path}")
        self._count = 0

    def write(self, frame: np.ndarray) -> None:
        cv2 = _cv2()
        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        self._count += 1

    @property
    def frames_written(self) -> int:
        return self._count

    def close(self) -> None:
        self._writer.release()

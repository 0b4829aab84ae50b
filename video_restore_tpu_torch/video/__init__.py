"""Host-side video I/O (port of ``video_restore_tpu/video``).

This slice ports the dependency-free backends: ``y4m`` (pure-Python
YUV4MPEG2 with the numpy BT.601 colour conversion) and ``npz``. The ffmpeg
and OpenCV backends, the native framecodec and audio muxing are not ported
yet; opening a path that needs them raises a "not yet ported" error.

All frames cross the API as (H, W, 3) uint8 RGB.
"""

from video_restore_tpu_torch.video.io_base import (
    VideoInfo,
    VideoReader,
    VideoWriter,
)
from video_restore_tpu_torch.video.backends import (
    open_reader,
    open_writer,
    probe,
)

__all__ = [
    "VideoInfo",
    "VideoReader",
    "VideoWriter",
    "open_reader",
    "open_writer",
    "probe",
]

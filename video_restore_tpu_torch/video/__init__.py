"""Host-side video I/O (port of ``video_restore_tpu/video``).

Backends, as in the JAX package:

- ``ffmpeg``: subprocess rawvideo pipes, libx264/libx265 and the audio mux,
  used when the ffmpeg binary exists;
- ``opencv``: cv2 VideoCapture/VideoWriter (bundled codecs, no audio);
- ``y4m``: pure-Python YUV4MPEG2 (colour through the native framecodec when
  it builds), exact and resumable by append;
- ``npz``: a lossless numpy container for tests.

Segmented output (``segmented.py``) makes the other containers resumable.
All frames cross the API as (H, W, 3) uint8 RGB, or as planar I420 from the
device through ``write_yuv420`` where the writer takes it.
"""

from video_restore_tpu_torch.video.io_base import (
    VideoInfo,
    VideoReader,
    VideoWriter,
)
from video_restore_tpu_torch.video.backends import (
    ffmpeg_available,
    open_reader,
    open_writer,
    probe,
)
from video_restore_tpu_torch.video.mux import copy_audio

__all__ = [
    "VideoInfo",
    "VideoReader",
    "VideoWriter",
    "open_reader",
    "open_writer",
    "probe",
    "ffmpeg_available",
    "copy_audio",
]

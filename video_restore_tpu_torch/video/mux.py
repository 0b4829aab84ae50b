"""Audio passthrough mux (port of ``video_restore_tpu/video/mux.py``).

Re-implements the reference's ``_copy_audio`` (video_upscaler.py:604-627):
copy the upscaled video stream + the original file's audio stream into a
temp file, then atomically replace the output. Errors (e.g. no audio track)
are non-fatal, matching the reference's swallow-and-continue behaviour
(:624-627) but logged instead of silent.
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path
from typing import Union

log = logging.getLogger("video_restore_tpu_torch")


def copy_audio(
    source: Union[str, Path], output: Union[str, Path]
) -> bool:
    """Mux ``source``'s audio into ``output`` in place. Returns True if an
    audio track was copied. Requires the ffmpeg backend; other backends
    produce video-only output (a warning is logged)."""
    from video_restore_tpu_torch.video.backends import ffmpeg_available
    from video_restore_tpu_torch.video.ffmpeg_backend import ffmpeg_path

    if not ffmpeg_available():
        log.warning("audio passthrough skipped: ffmpeg binary not available")
        return False

    output = str(output)
    temp = output + ".temp" + Path(output).suffix
    cmd = [
        ffmpeg_path(), "-y", "-loglevel", "error",
        "-i", output, "-i", str(source),
        "-map", "0:v:0", "-map", "1:a:0?",
        "-c:v", "copy", "-c:a", "copy",
        temp,
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-500:])
        os.replace(temp, output)
        return True
    except Exception as e:  # no audio stream / container mismatch
        log.info("audio passthrough skipped: %s", e)
        if os.path.exists(temp):
            os.remove(temp)
        return False

"""Crash-safe segmented output for containers that cannot be appended to.

Port of ``video_restore_tpu/video/segmented.py``.

y4m resume works by trimming and appending raw frames (runner
`_trim_partial_y4m`), but mp4/mkv/... outputs are not appendable: a killed
encoder leaves an unusable file and the reference simply restarts from
frame 0 (``ffmpeg -y``, video_upscaler.py:516). Here frames are encoded
into numbered segment files under ``{output}.parts/``; each segment that
closes cleanly is recorded in an atomic manifest, so after a crash the
completed segments are exact and only the unrecorded tail is re-encoded.
On success the segments are concatenated into the final container —
losslessly via ffmpeg's concat demuxer when the binary is available
(``-c copy``: same encoder settings, so stream parameters match), else by
stream rewrite through the container backend (lossless for npz).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Union

from video_restore_tpu_torch.video.io_base import VideoWriter
from video_restore_tpu_torch.utils.logging import get_logger

log = get_logger()


def _manifest_path(output_path: Union[str, Path]) -> Path:
    return Path(str(output_path) + ".segments.json")


def _parts_dir(output_path: Union[str, Path]) -> Path:
    return Path(str(output_path) + ".parts")


class SegmentedWriter(VideoWriter):
    """VideoWriter that rolls over to a new segment file every
    ``segment_frames`` frames and records completed segments atomically."""

    def __init__(
        self,
        output_path: Union[str, Path],
        width: int,
        height: int,
        fps: float,
        *,
        codec: str = "h264",
        crf: int = 15,
        preset: str = "slow",
        segment_frames: int = 250,
        resume: bool = False,
        pix_fmt: str = "rgb24",
    ):
        self.output_path = Path(output_path)
        self.width, self.height, self.fps = width, height, fps
        self.codec, self.crf, self.preset = codec, crf, preset
        self.pix_fmt = pix_fmt
        self.segment_frames = segment_frames
        self._dir = _parts_dir(output_path)
        self._manifest = _manifest_path(output_path)
        self._segments: List[dict] = []
        self._writer = None
        self._cur_frames = 0
        self._finalized = False

        if resume and self._manifest.exists():
            meta = json.loads(self._manifest.read_text())
            self._segments = [
                s for s in meta.get("segments", [])
                if (self._dir / s["file"]).exists()
            ]
        else:
            # fresh run: clear any leftovers from a previous attempt
            if self._dir.exists():
                shutil.rmtree(self._dir)
            if self._manifest.exists():
                self._manifest.unlink()
        self._dir.mkdir(parents=True, exist_ok=True)

    # -- resume ---------------------------------------------------------
    @staticmethod
    def resume_skip(
        output_path: Union[str, Path],
        width: int,
        height: int,
        fps: float,
    ) -> int:
        """Frames already safely encoded for ``output_path`` (0 if none).
        Raises if the recorded geometry does not match this run."""
        manifest = _manifest_path(output_path)
        if not manifest.exists():
            return 0
        meta = json.loads(manifest.read_text())
        got = (meta.get("width"), meta.get("height"))
        if got != (width, height) or abs(meta.get("fps", fps) - fps) > 1e-3:
            raise ValueError(
                f"cannot resume {output_path}: recorded segments are "
                f"{got[0]}x{got[1]}@{meta.get('fps'):g}, this run produces "
                f"{width}x{height}@{fps:g}. Remove {manifest} or drop "
                "--resume."
            )
        pdir = _parts_dir(output_path)
        return sum(
            s["frames"] for s in meta.get("segments", [])
            if (pdir / s["file"]).exists()
        )

    # -- writing --------------------------------------------------------
    def _seg_name(self, idx: int) -> str:
        return f"{idx:05d}{self.output_path.suffix}"

    def _open_segment(self):
        from video_restore_tpu_torch.video.backends import open_writer

        name = self._seg_name(len(self._segments))
        self._writer = open_writer(
            self._dir / name, self.width, self.height, self.fps,
            codec=self.codec, crf=self.crf, preset=self.preset,
            pix_fmt=self.pix_fmt,
        )
        self._cur_frames = 0

    def write(self, frame) -> None:
        if self._writer is None:
            self._open_segment()
        self._writer.write(frame)
        self._cur_frames += 1
        if self._cur_frames >= self.segment_frames:
            self._roll()

    def write_yuv420(self, planar) -> None:
        if self._writer is None:
            self._open_segment()
        self._writer.write_yuv420(planar)
        self._cur_frames += 1
        if self._cur_frames >= self.segment_frames:
            self._roll()

    def _roll(self) -> None:
        name = self._seg_name(len(self._segments))
        self._writer.close()
        self._writer = None
        self._segments.append({"file": name, "frames": self._cur_frames})
        self._cur_frames = 0
        self._write_manifest()

    def _write_manifest(self) -> None:
        tmp = self._manifest.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "width": self.width, "height": self.height, "fps": self.fps,
            "codec": self.codec, "segment_frames": self.segment_frames,
            "segments": self._segments,
        }))
        os.replace(tmp, self._manifest)

    def close(self) -> None:
        """Close the current segment; a cleanly closed partial segment is
        complete and counts toward resume."""
        if self._writer is not None:
            if self._cur_frames > 0:
                self._roll()
            else:
                self._writer.close()
                self._writer = None

    # -- completion -----------------------------------------------------
    def finalize(self) -> None:
        """Concatenate all segments into the final output and clean up.
        Call only after a successful run (close() first)."""
        self.close()
        if self._finalized:
            return
        if not self._segments:
            log.warning("no segments written; %s not created", self.output_path)
            return
        files = [self._dir / s["file"] for s in self._segments]
        if len(files) == 1:
            if self.output_path.exists():
                self.output_path.unlink()
            os.replace(files[0], self.output_path)
        elif not self._concat_ffmpeg(files):
            self._concat_rewrite(files)
        shutil.rmtree(self._dir, ignore_errors=True)
        if self._manifest.exists():
            self._manifest.unlink()
        self._finalized = True

    def _concat_ffmpeg(self, files: List[Path]) -> bool:
        """Lossless stream-copy concat via ffmpeg's concat demuxer."""
        from video_restore_tpu_torch.video.ffmpeg_backend import ffmpeg_path

        exe = ffmpeg_path()
        if exe is None or self.output_path.suffix.lower() in (".y4m", ".npz"):
            return False
        lst = self._dir / "concat.txt"
        lst.write_text(
            "".join(f"file '{f.resolve()}'\n" for f in files)
        )
        proc = subprocess.run(
            [exe, "-y", "-loglevel", "error", "-f", "concat", "-safe", "0",
             "-i", str(lst), "-c", "copy", str(self.output_path)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            log.warning(
                "ffmpeg concat failed (%s); falling back to stream rewrite",
                proc.stderr.strip()[:200],
            )
            return False
        return True

    def _concat_rewrite(self, files: List[Path]) -> None:
        """Fallback concat: decode each segment and re-write through the
        container backend (lossless for npz/y4m; re-encodes lossy codecs)."""
        from video_restore_tpu_torch.video.backends import open_reader, open_writer

        with open_writer(
            self.output_path, self.width, self.height, self.fps,
            codec=self.codec, crf=self.crf, preset=self.preset,
        ) as w:
            for f in files:
                with open_reader(f) as r:
                    for frame in r:
                        w.write(frame)

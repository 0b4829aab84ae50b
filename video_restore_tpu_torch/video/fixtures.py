"""Test-asset generation: degraded clips for eyeball + regression testing.

Port of ``video_restore_tpu/video/fixtures.py``, the same 13 presets,
``synth_source_clip`` and CLI (``python -m
video_restore_tpu_torch.video.fixtures``), numpy on the host. Like the JAX
module it uses ``cv2`` for the resizes, blurs and JPEG round-trips of the
presets (imported inside :func:`_cv2`, at first use);
``synth_source_clip`` needs none. ``use_ffmpeg=True`` (CLI: ``--ffmpeg``)
renders the compression presets through real codec round-trips (H.264 at
150k/50k/30k, short-GOP MPEG-2) and needs an ffmpeg binary.

The 13 preset names: clean_144p/240p/360p/480p, heavy_compression,
extreme_compression, interlaced, vhs_style, blocky_mpeg, blurry_noisy,
old_webcam, damaged_film, extreme_low_quality.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np


def _cv2():
    import cv2

    return cv2


def _resize(frame: np.ndarray, height: int) -> np.ndarray:
    cv2 = _cv2()
    h, w = frame.shape[:2]
    width = int(round(w * height / h / 2) * 2)
    return cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)


def _jpeg_roundtrip(frame: np.ndarray, quality: int) -> np.ndarray:
    """Blocky DCT compression artifacts without an encoder binary."""
    cv2 = _cv2()
    ok, buf = cv2.imencode(
        ".jpg", frame[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality]
    )
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]


@dataclasses.dataclass
class DegradeState:
    """Per-clip mutable state (rng, frame index) for temporal effects."""

    rng: np.random.Generator
    index: int = 0


def _clean(height: int):
    def fn(f, st):
        return _resize(f, height)

    return fn


def _compressed(height: int, quality: int):
    def fn(f, st):
        return _jpeg_roundtrip(_resize(f, height), quality)

    return fn


def _interlaced(f, st):
    """Comb artifacts: weave fields from the current and a shifted frame
    (create_test_videos.py:66-78 uses an ffmpeg interlace graph)."""
    g = _resize(f, 480)
    shifted = np.roll(g, 2, axis=1)
    out = g.copy()
    out[1::2] = shifted[1::2]
    return out


def _vhs_style(f, st):
    """Noise + washed-out colors + chroma shift + oversharpen + desaturate
    (create_test_videos.py:80-102)."""
    cv2 = _cv2()
    g = _resize(f, 360).astype(np.float32)
    # desaturate + lift blacks (vintage curves)
    gray = g.mean(axis=-1, keepdims=True)
    g = 0.7 * g + 0.3 * gray
    g = g * 0.85 + 25.0
    # chroma shift
    g[..., 0] = np.roll(g[..., 0], 2, axis=1)
    g[..., 2] = np.roll(g[..., 2], -2, axis=1)
    # tape noise, horizontal streaks
    g += st.rng.normal(0, 6, g.shape)
    if st.rng.random() < 0.3:
        row = st.rng.integers(0, g.shape[0] - 2)
        g[row : row + 2] += 40
    # oversharpen
    blur = cv2.GaussianBlur(g, (0, 0), 1.2)
    g = g + 0.8 * (g - blur)
    return np.clip(g, 0, 255).astype(np.uint8)


def _blocky_mpeg(f, st):
    return _jpeg_roundtrip(_resize(f, 480), 12)


def _blurry_noisy(f, st):
    cv2 = _cv2()
    g = _resize(f, 360)
    g = cv2.GaussianBlur(g, (0, 0), 1.8)
    g = g.astype(np.float32) + st.rng.normal(0, 10, g.shape)
    return np.clip(g, 0, 255).astype(np.uint8)


def _old_webcam(f, st):
    """Washed-out low-fps webcam look (create_test_videos.py:141-165);
    fps reduction is applied at the clip level via frame_step."""
    g = _resize(f, 240).astype(np.float32)
    g = g * 0.8 + 40.0  # washed out
    g += st.rng.normal(0, 4, g.shape)
    return np.clip(_jpeg_roundtrip(
        np.clip(g, 0, 255).astype(np.uint8), 40
    ), 0, 255)


def _damaged_film(f, st):
    """Grain + vertical scratches (create_test_videos.py:167-190)."""
    g = _resize(f, 480).astype(np.float32)
    g += st.rng.normal(0, 8, g.shape)  # grain
    for _ in range(st.rng.integers(0, 3)):
        x = st.rng.integers(0, g.shape[1])
        g[:, x : x + 1] = 235.0
    if st.rng.random() < 0.1:  # gate flicker
        g *= 0.85
    return np.clip(g, 0, 255).astype(np.uint8)


def _extreme_low_quality(f, st):
    cv2 = _cv2()
    g = cv2.resize(f, (144, 108), interpolation=cv2.INTER_AREA)
    return _jpeg_roundtrip(g, 8)


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    fn: Callable
    frame_step: int = 1  # >1 simulates fps reduction
    fps_div: float = 1.0
    # real-codec rendering spec (vcodec/bitrate/gop) used when the caller
    # opts into ffmpeg-rendered artifacts; None = numpy/cv2 only
    codec: Optional[dict] = None


PRESETS: Dict[str, Preset] = {
    "clean_144p": Preset("clean_144p", _clean(144)),
    "clean_240p": Preset("clean_240p", _clean(240)),
    "clean_360p": Preset("clean_360p", _clean(360)),
    "clean_480p": Preset("clean_480p", _clean(480)),
    "heavy_compression": Preset(
        "heavy_compression", _compressed(360, 18),
        codec={"vcodec": "libx264", "bitrate": "150k"},  # ref :49-56
    ),
    "extreme_compression": Preset(
        "extreme_compression", _compressed(240, 8),
        codec={"vcodec": "libx264", "bitrate": "50k"},  # ref :58-64
    ),
    "interlaced": Preset("interlaced", _interlaced),
    "vhs_style": Preset("vhs_style", _vhs_style),
    "blocky_mpeg": Preset(
        "blocky_mpeg", _blocky_mpeg,
        codec={"vcodec": "mpeg2video", "bitrate": "300k", "gop": 3},  # :104-117
    ),
    "blurry_noisy": Preset("blurry_noisy", _blurry_noisy),
    "old_webcam": Preset("old_webcam", _old_webcam, frame_step=2, fps_div=2.0),
    "damaged_film": Preset("damaged_film", _damaged_film),
    "extreme_low_quality": Preset(
        "extreme_low_quality", _extreme_low_quality, frame_step=3, fps_div=3.0,
        codec={"vcodec": "libx264", "bitrate": "30k"},  # ref :192-216
    ),
}


def codec_roundtrip(
    frames: List[np.ndarray],
    fps: float,
    *,
    vcodec: str = "libx264",
    bitrate: str = "150k",
    gop: Optional[int] = None,
) -> List[np.ndarray]:
    """Real bitstream artifacts: encode the frames at the given bitrate and
    decode them back, both through the ffmpeg binary (matching the
    reference's degradation recipes, create_test_videos.py:49-117).
    Frame dimensions must be even (yuv420p)."""
    import subprocess
    import tempfile

    from video_restore_tpu_torch.video.ffmpeg_backend import (
        FFmpegReader,
        ffmpeg_path,
    )

    exe = ffmpeg_path()
    if exe is None:
        raise RuntimeError(
            "ffmpeg binary required for codec-rendered presets "
            "(use_ffmpeg=True); install ffmpeg or drop the flag"
        )
    h, w = frames[0].shape[:2]
    suffix = ".mpg" if "mpeg2" in vcodec else ".mp4"
    with tempfile.TemporaryDirectory() as td:
        dest = Path(td) / f"clip{suffix}"
        cmd = [
            exe, "-y", "-loglevel", "error",
            "-f", "rawvideo", "-pix_fmt", "rgb24",
            "-s", f"{w}x{h}", "-r", f"{fps:g}", "-i", "-",
            "-vcodec", vcodec, "-b:v", bitrate, "-pix_fmt", "yuv420p",
        ]
        if gop:
            cmd += ["-g", str(gop)]
        cmd.append(str(dest))
        raw = b"".join(np.ascontiguousarray(f).tobytes() for f in frames)
        proc = subprocess.run(cmd, input=raw, capture_output=True)
        if proc.returncode:
            raise RuntimeError(
                f"ffmpeg encode failed: {proc.stderr.decode()[:300]}"
            )
        with FFmpegReader(dest) as r:
            return list(r)


def degrade_frames(
    frames: Iterable[np.ndarray],
    preset: str,
    seed: int = 0,
    *,
    use_ffmpeg: bool = False,
    fps: float = 30.0,
) -> List[np.ndarray]:
    """Apply a degradation preset to an RGB uint8 frame sequence.

    use_ffmpeg=True renders the compression presets' codec stage through a
    real encode/decode round-trip (requires the ffmpeg binary)."""
    p = PRESETS[preset]
    st = DegradeState(np.random.default_rng(seed))
    out = []
    for i, f in enumerate(frames):
        if i % p.frame_step:
            continue
        st.index = i
        out.append(p.fn(f, st))
    if use_ffmpeg and p.codec and out:
        out = codec_roundtrip(out, fps / p.fps_div, **p.codec)
    return out


def synth_source_clip(
    n_frames: int = 60, height: int = 720, width: int = 1280, seed: int = 7
) -> List[np.ndarray]:
    """Synthetic high-quality source when the Blender clips are unavailable
    (the reference mounts them as Git-LFS pointers only): moving gradients,
    text-like rectangles, and fine detail for SR to chew on."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    detail = (rng.random((height // 8, width // 8, 3)) * 255).astype(np.uint8)
    detail = np.kron(detail, np.ones((8, 8, 1))).astype(np.uint8)
    frames = []
    for t in range(n_frames):
        phase = 2 * np.pi * t / max(n_frames, 1)
        r = (127 + 120 * np.sin(xx / 97.0 + phase)).astype(np.uint8)
        g = (127 + 120 * np.cos(yy / 61.0 - phase)).astype(np.uint8)
        b = ((xx + yy + 6 * t) % 255).astype(np.uint8)
        f = np.stack([r, g, b], axis=-1)
        f = (0.7 * f + 0.3 * detail).astype(np.uint8)
        # moving high-contrast box (motion for temporal tests)
        x0 = (40 + 9 * t) % (width - 120)
        y0 = (30 + 5 * t) % (height - 90)
        f[y0 : y0 + 80, x0 : x0 + 110] = [245, 245, 240]
        f[y0 + 10 : y0 + 70, x0 + 10 : x0 + 100] = [20, 20, 25]
        frames.append(f)
    return frames


def create_test_videos(
    source: Optional[Union[str, Path]],
    out_dir: Union[str, Path] = "test_videos/degraded",
    presets: Optional[List[str]] = None,
    clip_frames: int = 60,
    seed: int = 0,
    use_ffmpeg: bool = False,
) -> List[Path]:
    """Render degraded clips (reference main(), create_test_videos.py:253).

    source: a video file to degrade, or None for the synthetic source.
    Clips are written as .y4m (works everywhere) — or .mp4 when an OpenCV
    writer for it is available.
    """
    from video_restore_tpu_torch.video import open_reader, open_writer

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if source is not None:
        with open_reader(source) as r:
            fps = r.info.fps
            src = []
            for i, f in enumerate(r):
                if i >= clip_frames:
                    break
                src.append(f)
    else:
        fps = 30.0
        src = synth_source_clip(clip_frames)

    written = []
    for name in presets or list(PRESETS):
        p = PRESETS[name]
        frames = degrade_frames(
            src, name, seed, use_ffmpeg=use_ffmpeg, fps=fps
        )
        if not frames:
            continue
        h, w = frames[0].shape[:2]
        dest = out / f"{name}.y4m"
        with open_writer(dest, w, h, fps / p.fps_div) as wr:
            for f in frames:
                wr.write(f)
        written.append(dest)
    return written


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate degraded test clips (13 presets)"
    )
    ap.add_argument("--source", default=None,
                    help="source video (default: synthetic clip)")
    ap.add_argument("--out-dir", default="test_videos/degraded")
    ap.add_argument("--presets", nargs="*", default=None,
                    choices=list(PRESETS), metavar="PRESET")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--ffmpeg", action="store_true",
                    help="render compression presets through real codec "
                    "round-trips (requires the ffmpeg binary)")
    args = ap.parse_args(argv)
    paths = create_test_videos(
        args.source, args.out_dir, args.presets, args.frames,
        use_ffmpeg=args.ffmpeg,
    )
    for p in paths:
        print(f"  {p}  ({p.stat().st_size / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Streaming (``-`` over stdin and stdout) and bad or tiny inputs: the ten
cases of the JAX package's ``tests/test_streaming.py`` and
``tests/test_robustness.py``, each run through both packages side by side.

Both packages get the same tiny SRVGG (nf 8, 2 convs, scale 2;
``test_torch_io._tiny_models``), the same config (tile 16, overlap 4, fp32,
no audio) and the same input bytes. Each case asserts what the JAX test
asserts, on both, and that the two agree: the same verdict, frame count and
size, and, where frames come out, planes within the rule of
``test_torch_io.py`` (u8 within 1 level on at most 0.5% of the values: the
two fp32 paths agree to ~1e-5). Everything runs in this process: stdin and
stdout are replaced by in-memory streams, as in the JAX tests.
"""

import io
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_io import _assert_u8_close, _restorers, _y4m_planes
from video_restore_tpu_torch.video import open_reader, open_writer, probe, y4m

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _both_video():
    from video_restore_tpu.video import open_reader as jopen_reader
    from video_restore_tpu.video import open_writer as jopen_writer
    from video_restore_tpu.video import probe as jprobe

    return {"j": (jopen_reader, jopen_writer, jprobe), "p": (open_reader, open_writer, probe)}


class _FakeStdin:
    def __init__(self, data):
        self.buffer = io.BytesIO(data)


class _FakeStdout:
    def __init__(self):
        self.buffer = io.BytesIO()


def _y4m_bytes(tmp_path, frames, fps=25.0):
    path = tmp_path / "src.y4m"
    with y4m.Y4MWriter(path, frames.shape[2], frames.shape[1], fps) as w:
        for f in frames:
            w.write(f)
    return path.read_bytes()


def _restore_both(src, dst_of, **cfg):
    """Each package's VideoRestorer on ``src``: {tag: (ok, dst)}."""
    jr, pr = _restorers(**cfg)
    out = {}
    for tag, r in (("j", jr), ("p", pr)):
        dst = dst_of(tag)
        out[tag] = (r.process_video(src, dst, show_progress=False), dst)
    return out


def test_is_pipe():
    from video_restore_tpu.video.y4m import is_pipe as jax_is_pipe

    for path in ("-", "pipe:", "out.y4m", "./-", "pipe", "-.y4m"):
        assert y4m.is_pipe(path) == jax_is_pipe(path), path
    assert y4m.is_pipe("-") and y4m.is_pipe("pipe:")
    assert not y4m.is_pipe("out.y4m") and not y4m.is_pipe("./-")


def test_streaming_stdin_stdout(tiny_frames, monkeypatch, tmp_path):
    """``-`` in and out: the y4m stream read from stdin in one pass, the
    upscaled stream written to stdout, the frame count kept."""
    src = _y4m_bytes(tmp_path, tiny_frames)
    jr, pr = _restorers()
    planes = {}
    for tag, r in (("j", jr), ("p", pr)):
        out = _FakeStdout()
        monkeypatch.setattr(sys, "stdin", _FakeStdin(src))
        monkeypatch.setattr(sys, "stdout", out)
        assert r.process_video("-", "-", show_progress=False), tag
        path = tmp_path / f"roundtrip_{tag}.y4m"
        path.write_bytes(out.buffer.getvalue())
        with y4m.Y4MReader(path) as rd:
            n, h, w, _ = tiny_frames.shape
            assert (rd.info.width, rd.info.height) == (2 * w, 2 * h)
            assert len(list(rd)) == n
        planes[tag] = _y4m_planes(path)
    assert planes["p"].shape == planes["j"].shape
    _assert_u8_close(planes["p"], planes["j"])


def test_streaming_in_file_out(tiny_frames, monkeypatch, tmp_path):
    """``-`` in, a regular file out."""
    src = _y4m_bytes(tmp_path, tiny_frames)
    jr, pr = _restorers()
    planes = {}
    for tag, r in (("j", jr), ("p", pr)):
        monkeypatch.setattr(sys, "stdin", _FakeStdin(src))
        dst = tmp_path / f"out_{tag}.y4m"
        assert r.process_video("-", dst, show_progress=False), tag
        with y4m.Y4MReader(dst) as rd:
            assert len(list(rd)) == tiny_frames.shape[0]
        planes[tag] = _y4m_planes(dst)
    _assert_u8_close(planes["p"], planes["j"])


@pytest.mark.parametrize(
    "data",
    [b"YUV4MPEG2 W64 H48 F25:1\nGARBAGE-NOT-A-FRAME" + b"x" * 100, b"this is not a video at all"],
    ids=["corrupt_y4m", "not_a_video"],
)
def test_bad_input_fails_cleanly(tmp_path, data):
    """A decode error is a failed (False) run in both packages, not a hang
    or an exception."""
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(data)
    res = _restore_both(bad, lambda tag: tmp_path / f"out_{tag}.y4m")
    assert res["j"][0] is False and res["p"][0] is False


def _npz_clip(tmp_path, frames, w, h, opener):
    src = tmp_path / "in.npz"
    with opener(src, w, h, 25) as wr:
        for f in frames:
            wr.write(f)
    return src


@pytest.mark.parametrize(
    "case,w,h,n,tile,out_wh",
    [
        ("single_frame", 64, 48, 1, 16, (128, 96)),
        ("tiny_8x8", 8, 8, 2, 16, (16, 16)),
        ("odd_37x23", 37, 23, 2, 16, (74, 46)),  # mod-2 extract snapping
        ("empty", 16, 16, 0, 16, None),  # zero frames: 0 == 0 accounting
    ],
)
def test_small_clips_complete(tmp_path, tiny_frames, case, w, h, n, tile, out_wh):
    if case == "single_frame":
        frames = tiny_frames[:1]
    else:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    src = _npz_clip(tmp_path, frames, w, h, open_writer)
    res = _restore_both(src, lambda tag: tmp_path / f"o_{tag}.npz", tile_size=tile)
    assert res["j"][0] is True and res["p"][0] is True
    if out_wh is None:
        return
    vid = _both_video()
    outs = {}
    for tag in ("j", "p"):
        info = vid[tag][2](res[tag][1])
        assert (info.width, info.height, info.frames) == out_wh + (n,), tag
        with vid[tag][0](res[tag][1]) as rd:
            outs[tag] = np.stack(list(rd))
    _assert_u8_close(outs["p"], outs["j"])


def test_y4m_reader_rejects_garbage_header(tmp_path):
    from video_restore_tpu.video.y4m import Y4MReader as JaxReader

    p = tmp_path / "x.y4m"
    p.write_bytes(b"NOT-A-Y4M\n")
    for reader in (JaxReader, y4m.Y4MReader):
        with pytest.raises(ValueError):
            reader(p)

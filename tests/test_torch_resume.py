"""Segmented resume and batch directories of the port, held to the JAX
package on the CPU (the tiny SRVGG and the helpers are
``test_torch_io.py``'s).

- ``SegmentedWriter`` through the fake ffmpeg (``tests/fake_ffmpeg.py``:
  npz payloads, lossless): the same segment files and manifest as JAX's,
  for rgb24 frames and for planar I420; the stream-rewrite concat without
  ffmpeg; ``resume_skip`` and its geometry refusal as in JAX.
- mp4 resume after a simulated crash (``tests/test_segmented.py:81``): the
  resumed output equals an uninterrupted run exactly (the same port on the
  same frames), and the number of frames skipped is JAX's.
- y4m resume: a partial tail is trimmed to the frame count JAX's trim
  gives, the resumed file equals an uninterrupted run, and a file of
  another geometry is refused with JAX's message.
- ``process_batch_dir`` over two resolutions: the same (ok, total) and
  output names as JAX's, every bucket warmed before the first video; the
  CLI's ``--batch`` exit code.

No case runs ``--enhanced``: a resumed run restarts the temporal carry at
the resume frame, in both packages (``tests/test_segmented.py`` does the
same). Outputs of one package are compared exactly; outputs across the
packages within ``test_torch_step.py``'s rule (max 1 level, at most 0.5%
of values).
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_io import _CFG, _assert_u8_close, _tiny_models, _write_mp4

from video_restore_tpu_torch import cli
from video_restore_tpu_torch.config import RestoreConfig as PortConfig
from video_restore_tpu_torch.ops.color import rgb_to_yuv420_planar
from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PortRestorer
from video_restore_tpu_torch.video import open_reader, segmented
from video_restore_tpu_torch.video.segmented import SegmentedWriter
from video_restore_tpu_torch.video.y4m import Y4MReader, Y4MWriter

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _port(**kw):
    return PortRestorer(PortConfig(**dict(_CFG, **kw)), model=_tiny_models()[1], cpu=True)


def _jax(**kw):
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.pipeline.runner import VideoRestorer

    return VideoRestorer(RestoreConfig(**dict(_CFG, **kw)), model=_tiny_models()[0])


def _write_y4m(path, frames):
    with Y4MWriter(path, frames.shape[2], frames.shape[1], 25) as w:
        for f in frames:
            w.write(f)


def _frames(path):
    with open_reader(path) as r:
        return np.stack(list(r))


@pytest.mark.parametrize("pix_fmt", ["rgb24", "yuv420p"])
def test_segmented_writer_matches_jax(fake_ffmpeg_bin, tmp_path, tiny_frames, pix_fmt):
    """Rolling segments of 3 frames (3 + 3 + 2): the same part files and
    manifest as JAX's SegmentedWriter, and after ``finalize`` the same
    output, the parts and manifest gone."""
    from video_restore_tpu.video.segmented import SegmentedWriter as JaxWriter

    planes = rgb_to_yuv420_planar(torch.from_numpy(tiny_frames).float() / 255).numpy()
    seen = {}
    for tag, cls in (("p", SegmentedWriter), ("j", JaxWriter)):
        out = tmp_path / tag / "out.mp4"
        out.parent.mkdir()
        w = cls(out, 64, 48, 25.0, segment_frames=3, pix_fmt=pix_fmt)
        for f, p in zip(tiny_frames, planes):
            w.write(f) if pix_fmt == "rgb24" else w.write_yuv420(p)
        w.close()
        parts = Path(str(out) + ".parts")
        names = sorted(p.name for p in parts.iterdir())
        manifest = json.loads(Path(str(out) + ".segments.json").read_text())
        w.finalize()
        assert not parts.exists() and not Path(str(out) + ".segments.json").exists()
        seen[tag] = (names, manifest, np.load(out)["frames"])
    assert seen["p"][0] == seen["j"][0] == ["00000.mp4", "00001.mp4", "00002.mp4"]
    assert seen["p"][1] == seen["j"][1]
    assert [s["frames"] for s in seen["p"][1]["segments"]] == [3, 3, 2]
    np.testing.assert_array_equal(seen["p"][2], seen["j"][2])
    if pix_fmt == "rgb24":
        np.testing.assert_array_equal(seen["p"][2], tiny_frames)


def test_segmented_npz_without_ffmpeg(tmp_path, tiny_frames, monkeypatch):
    """Without an ffmpeg binary the segments are joined by rewriting the
    stream, lossless for npz."""
    monkeypatch.setenv("PATH", "")
    out = tmp_path / "out.npz"
    w = SegmentedWriter(out, 64, 48, 25.0, segment_frames=3)
    for f in tiny_frames:
        w.write(f)
    w.close()
    w.finalize()
    np.testing.assert_array_equal(_frames(out), tiny_frames)


def test_resume_skip_and_geometry_refusal_match_jax(tmp_path, tiny_frames):
    from video_restore_tpu.video.segmented import SegmentedWriter as JaxWriter

    out = tmp_path / "out.npz"
    w = SegmentedWriter(out, 64, 48, 25.0, segment_frames=2)
    for f in tiny_frames[:5]:
        w.write(f)
    w.close()  # 2 + 2 + 1, all recorded
    assert SegmentedWriter.resume_skip(out, 64, 48, 25.0) == JaxWriter.resume_skip(out, 64, 48, 25.0) == 5
    for geom in ((128, 96, 25.0), (64, 48, 30.0)):
        with pytest.raises(ValueError, match="cannot resume") as mine:
            SegmentedWriter.resume_skip(out, *geom)
        with pytest.raises(ValueError, match="cannot resume") as theirs:
            JaxWriter.resume_skip(out, *geom)
        assert str(mine.value) == str(theirs.value)
    assert SegmentedWriter.resume_skip(tmp_path / "none.npz", 64, 48, 25.0) == 0


def test_resume_mp4_after_a_crash(fake_ffmpeg_bin, tmp_path, tiny_frames, monkeypatch):
    """Kill and resume on the default container, as ``test_segmented.py``
    does for JAX: 3 frames recorded in segments of 2 plus a garbage
    segment; the resume skips JAX's count and the output equals a clean
    run."""
    from video_restore_tpu.video.segmented import SegmentedWriter as JaxWriter

    src = tmp_path / "in.mp4"
    _write_mp4(src, tiny_frames)
    full = tmp_path / "full.mp4"
    assert _port(segment_frames=2).process_video(src, full, show_progress=False)

    part_src = tmp_path / "in3.mp4"
    _write_mp4(part_src, tiny_frames[:3])
    partial = tmp_path / "part.mp4"
    with monkeypatch.context() as m:  # segments and manifest survive, as after SIGKILL
        m.setattr(segmented.SegmentedWriter, "finalize", lambda self: None)
        assert _port(segment_frames=2).process_video(part_src, partial, show_progress=False)
    parts = Path(str(partial) + ".parts")
    (parts / "00002.mp4").write_bytes(b"garbage from a killed encoder")
    assert SegmentedWriter.resume_skip(partial, 128, 96, 25.0) == \
        JaxWriter.resume_skip(partial, 128, 96, 25.0) == 3

    r = _port(segment_frames=2, resume=True)
    assert r.process_video(src, partial, show_progress=False)
    assert not parts.exists()
    assert r.last_stats.decoded == r.last_stats.encoded == 8
    np.testing.assert_array_equal(_frames(partial), _frames(full))


def test_resume_y4m_trims_and_matches_jax(tmp_path, tiny_frames):
    """A y4m output cut 17 bytes into its fourth frame: both packages' trim
    keeps 3 frames; the port's resume appends the other 5 and equals its
    clean run, which is within the rule of JAX's clean run."""
    from video_restore_tpu.pipeline.runner import VideoRestorer as JaxRestorer

    src = tmp_path / "in.y4m"
    _write_y4m(src, tiny_frames)
    full, jfull, partial = (tmp_path / n for n in ("full.y4m", "jfull.y4m", "part.y4m"))
    assert _port(segment_frames=2).process_video(src, full, show_progress=False)
    assert _jax(segment_frames=2).process_video(src, jfull, show_progress=False)
    _assert_u8_close(_frames(full), _frames(jfull))

    shutil.copy(full, partial)
    with open(partial, "rb") as f:
        header = len(f.readline())
    frame_bytes = 6 + 128 * 96 * 3 // 2
    with open(partial, "ab") as f:
        f.truncate(header + 3 * frame_bytes + 17)
    jcopy = tmp_path / "jcopy.y4m"
    shutil.copy(partial, jcopy)
    assert JaxRestorer._trim_partial_y4m(jcopy) == 3
    r = _port(segment_frames=2, resume=True)
    assert r.process_video(src, partial, show_progress=False)
    assert (r.last_stats.decoded, r.last_stats.encoded) == (8, 8)
    assert partial.read_bytes() == full.read_bytes()
    assert not Path(str(partial) + ".progress.json").exists()


def test_resume_y4m_refuses_other_geometry(tmp_path, tiny_frames):
    """Resuming into a y4m of another size, rate or colorspace raises JAX's
    error and leaves the file as it was."""
    from video_restore_tpu.pipeline.runner import VideoRestorer as JaxRestorer

    src = tmp_path / "in.y4m"
    _write_y4m(src, tiny_frames[:2])
    for name, (w, h, fps, cs) in {"size": (64, 48, 25, "420jpeg"), "fps": (128, 96, 30, "420jpeg"),
                                  "cs": (128, 96, 25, "444")}.items():
        out = tmp_path / f"{name}.y4m"
        with Y4MWriter(out, w, h, fps, colorspace=cs) as wr:
            wr.write(np.zeros((h, w, 3), np.uint8))
        before = out.read_bytes()
        with pytest.raises(ValueError, match="cannot resume") as mine:
            PortRestorer._check_resume_header(out, 128, 96, 25.0)
        with pytest.raises(ValueError, match="cannot resume") as theirs:
            JaxRestorer._check_resume_header(out, 128, 96, 25.0)
        assert str(mine.value) == str(theirs.value)
        assert not _port(segment_frames=2, resume=True).process_video(src, out, show_progress=False)
        assert out.read_bytes() == before


def test_batch_dir_matches_jax(tmp_path, tiny_frames):
    """Two resolutions (y4m and npz) and a file that is no video: the same
    (ok, total) and output names as JAX's; both buckets warmed up front and
    no other bucket made; each output within the rule of JAX's."""
    indir = tmp_path / "in"
    indir.mkdir()
    _write_y4m(indir / "a.y4m", tiny_frames[:3])
    _write_mp4(indir / "b.npz", tiny_frames[:3, :24, :32])
    (indir / "notes.txt").write_text("not a video")
    results = {}
    for tag, r in (("p", _port()), ("j", _jax())):
        out = tmp_path / f"out_{tag}"
        ok_total = r.process_batch_dir(indir, out, show_progress=False)
        results[tag] = (ok_total, sorted(p.name for p in out.iterdir()), r)
    assert results["p"][:2] == results["j"][:2] == ((2, 2), ["a_upscaled.y4m", "b_upscaled.npz"])
    assert sorted(results["p"][2]._upscalers) == [(24, 32, False), (48, 64, True)]
    for name in ("a_upscaled.y4m", "b_upscaled.npz"):
        _assert_u8_close(_frames(tmp_path / "out_p" / name), _frames(tmp_path / "out_j" / name))


def test_batch_warmup_only_for_two_cold_buckets(tmp_path, tiny_frames):
    """One bucket: no prewarm (the lazy path is as fast); two: both."""
    indir = tmp_path / "in"
    indir.mkdir()
    _write_mp4(indir / "a.npz", tiny_frames[:1])
    r = _port()
    r._warmup_buckets([(indir / "a.npz", tmp_path / "a.npz")])
    assert r._upscalers == {} and str(indir / "a.npz") in r._probe_cache
    _write_mp4(indir / "b.npz", tiny_frames[:1, :24, :32])
    r._warmup_buckets([(indir / n, tmp_path / n) for n in ("a.npz", "b.npz")])
    assert sorted(r._upscalers) == [(24, 32, False), (48, 64, False)]


def test_cli_batch_exit_code(tmp_path, monkeypatch, capsys):
    """``--batch`` exits 0 iff every video succeeded and there was one."""
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    base = ["--cpu", "--batch", "--model", "RealESRGAN_x4plus_anime_6B", "--tile-size", "0",
            "--models-dir", str(tmp_path / "m")]
    empty, good, bad = (tmp_path / n for n in ("empty", "good", "bad"))
    for d in (empty, good, bad):
        d.mkdir()
    rng = np.random.default_rng(0)
    _write_y4m(good / "a.y4m", rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8))
    shutil.copy(good / "a.y4m", bad / "a.y4m")
    (bad / "b.y4m").write_bytes(b"not a y4m stream\n")
    assert cli.main([str(empty), str(tmp_path / "o0")] + base) == 1
    assert cli.main([str(good), str(tmp_path / "o1")] + base) == 0
    with Y4MReader(tmp_path / "o1" / "a_upscaled.y4m") as rd:
        assert (rd.info.width, rd.info.height, rd.info.frames) == (48, 32, 2)
    assert cli.main([str(bad), str(tmp_path / "o2")] + base) == 1
    assert "batch complete: 1/2 succeeded" in capsys.readouterr().err

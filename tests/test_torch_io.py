"""The port's video I/O surface against the JAX package's, on the CPU.

- ``ops/color.py::rgb_to_yuv420_planar`` against the JAX function on the
  same fp32 input, dither on and off: bytes equal.
- The native framecodec (the port's copy of ``native/framecodec.cpp``):
  ``rgb_to_yuv``/``yuv_to_rgb`` bytes equal to the JAX loader's library;
  the numpy fallback under ``VRT_DISABLE_NATIVE=1`` bytes equal to JAX's.
- y4m: ``write_yuv420``, ``append=`` and ``concat_y4m``: files equal byte
  for byte.
- Backend choice (``_pick_backend``, ``writer_supports_yuv420``): the same
  table.
- ffmpeg through the fake binary (``tests/fake_ffmpeg.py``): probe and its
  frame-count fallbacks, reader, writer (rgb24 and yuv420p) and the audio
  mux give equal results from the same argv.
- OpenCV: the module imports without ``cv2``; its round trip equals JAX's
  where ``cv2`` exists.
- The runner: ``_yuv_eligible`` gives JAX's answers; ``process_video`` of
  the same y4m and mp4 clips through both packages gives planes within
  ``test_torch_step.py``'s rule (max 1 level, at most 0.5% of values: the
  fp32 model paths agree to ~1e-5, so a value at a rounding boundary may
  move by one level); the yuv path does no host colour work; the pinned
  ring hands out no slot twice and keeps the order, also under a slow
  writer.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.config import RestoreConfig as PortConfig
from video_restore_tpu_torch.models.srvgg import SRVGGSpec as PortSRVGGSpec
from video_restore_tpu_torch.models.srvgg import params_from_jax
from video_restore_tpu_torch.models.zoo import ModelHandle as PortHandle
from video_restore_tpu_torch.ops.color import rgb_to_yuv420_planar
from video_restore_tpu_torch.parallel.dispatch import PinnedRing, Upscaler
from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PortRestorer
from video_restore_tpu_torch.utils import native
from video_restore_tpu_torch.video import backends, ffmpeg_backend, mux, open_reader, y4m

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _assert_u8_close(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.005, (d > 0).mean()


def _y4m_planes(path):
    """The raw planar frames of a 4:2:0 y4m file: (n, H*3//2, W) uint8."""
    with open(path, "rb") as f:
        info = y4m._parse_header(f.readline())
        w, h = info.width, info.height
        frames = []
        while f.readline():
            frames.append(np.frombuffer(f.read(w * h * 3 // 2), np.uint8).reshape(h * 3 // 2, w))
    return np.stack(frames)


def _tiny_models(scale=2):
    """The same SRVGG (nf 8, 2 convs) in both packages: the JAX init with
    its convs scaled by 10, so that the output is not the upsampled input."""
    from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
    from video_restore_tpu.models.zoo import ModelHandle

    spec = SRVGGSpec(num_feat=8, num_conv=2, scale=scale)
    params = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(0), spec))
    for k in ("conv_in", "body", "conv_out"):
        params[k]["w"] = params[k]["w"] * 10.0
    jmodel = ModelHandle("tiny", spec, jax.tree.map(jnp.asarray, params))
    pmodel = PortHandle("tiny", PortSRVGGSpec(num_feat=8, num_conv=2, scale=scale),
                        params_from_jax(params))
    return jmodel, pmodel


_CFG = dict(model_name="RealESRGAN_x4_v3", tile_size=16, tile_overlap=4, precision="fp32",
            audio_copy=False)


def _restorers(**kw):
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.pipeline.runner import VideoRestorer

    jmodel, pmodel = _tiny_models()
    cfg = dict(_CFG, **kw)
    return (VideoRestorer(RestoreConfig(**cfg), model=jmodel),
            PortRestorer(PortConfig(**cfg), model=pmodel, cpu=True))


def _write_mp4(path, frames, audio=False):
    extra = {"audio": np.arange(100, dtype=np.int16)} if audio else {}
    with open(path, "wb") as fh:
        np.savez(fh, frames=frames, fps=25.0, **extra)


# ---------------------------------------------------------------------------
# colour


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 2), (1, 8, 6), (3, 32, 48), (2, 20, 14)])
def test_rgb_to_yuv420_planar_matches_jax(shape, dither):
    """Bytes equal to ``ops/color.py:rgb_to_yuv420_planar`` of the JAX
    package on the same fp32 input (odd batch, several H and W)."""
    from video_restore_tpu.ops.color import rgb_to_yuv420_planar as jax_planar

    x = np.random.default_rng(sum(shape)).random(shape + (3,)).astype(np.float32)
    want = np.asarray(jax_planar(jnp.asarray(x), dither=dither))
    got = rgb_to_yuv420_planar(torch.from_numpy(x), dither=dither)
    assert got.dtype == torch.uint8 and got.shape == (shape[0], shape[1] * 3 // 2, shape[2])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(30, 40), (32, 41), (2, 4)])
def test_rgb_to_yuv420_planar_refuses_geometry(hw):
    from video_restore_tpu.ops.color import rgb_to_yuv420_planar as jax_planar

    with pytest.raises(ValueError, match="yuv420"):
        jax_planar(jnp.zeros((1,) + hw + (3,), jnp.float32))
    with pytest.raises(ValueError, match="yuv420"):
        rgb_to_yuv420_planar(torch.zeros((1,) + hw + (3,)))


@pytest.mark.parametrize("dither", [False, True])
def test_restore_step_yuv420_out_matches_jax(tiny_frames, dither):
    """``restore_step`` with ``yuv420_out`` against the JAX step's branch
    (``dispatch.py:263-273``): the enhanced stack, the temporal carry over
    two batches and a hard cut, a nearest-2x "model": planes and carry
    within the rule above."""
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    from video_restore_tpu_torch.ops.conv import upsample_nearest
    from video_restore_tpu_torch.ops.tiles import TileGrid as PortGrid
    from video_restore_tpu_torch.parallel import dispatch as port

    frames = tiny_frames.copy()
    frames[6:] = 255 - frames[6:]
    h, w = frames.shape[1:3]
    cfg_kw = dict(denoise=0.5, sharpen=0.3, color_enhance=True, temporal=True,
                  yuv420_out=True, dither=dither)
    jcarry = {"frame": jnp.zeros((1, 2 * h, 2 * w, 3), jnp.uint8),
              "valid": jnp.zeros((1,), jnp.float32)}
    pcarry = {"frame": torch.zeros((1, 2 * h, 2 * w, 3), dtype=torch.uint8),
              "valid": torch.zeros(1)}
    for batch in (frames[:4], frames[4:]):
        ref, jcarry = restore_step(
            None, jnp.asarray(batch), jcarry,
            model_apply=lambda p, t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2),
            grid=TileGrid.build(h, w, tile=0, overlap=0, scale=2),
            step_cfg=StepConfig(**cfg_kw), compute_dtype=jnp.float32, n_shards=1,
        )
        got, pcarry = port.restore_step(
            torch.from_numpy(batch), pcarry, model_apply=lambda t: upsample_nearest(t, 2),
            grid=PortGrid.build(h, w, tile=0, overlap=0, scale=2),
            step_cfg=port.StepConfig(**cfg_kw), compute_dtype=torch.float32,
        )
        assert got.dtype == torch.uint8 and got.shape == ref.shape == (4, 3 * h, 2 * w)
        _assert_u8_close(got.numpy(), np.asarray(ref))
        _assert_u8_close(pcarry["frame"].numpy(), np.asarray(jcarry["frame"]))


# ---------------------------------------------------------------------------
# the native framecodec


def test_framecodec_copy_is_the_original():
    a = (REPO / "native" / "framecodec.cpp").read_bytes()
    assert (REPO / "video_restore_tpu_torch" / "native" / "framecodec.cpp").read_bytes() == a


@pytest.mark.parametrize("subsample", ["420", "444"])
def test_native_matches_jax(subsample):
    """The port's library and the JAX loader's (one source): bytes equal
    both ways."""
    from video_restore_tpu.utils import native as jax_native

    if jax_native.load() is None:
        pytest.skip("no C++ toolchain: neither package has its framecodec")
    assert native.load() is not None
    frame = np.random.default_rng(1).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    got, want = native.rgb_to_yuv(frame, subsample), jax_native.rgb_to_yuv(frame, subsample)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(native.yuv_to_rgb(*got), jax_native.yuv_to_rgb(*want))
    # the y4m entry points take it
    for g, w in zip(y4m.rgb_to_yuv_planes(frame, subsample), got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(y4m.yuv_planes_to_rgb(*got), native.yuv_to_rgb(*got))


@pytest.mark.parametrize("subsample", ["420", "422", "444"])
def test_numpy_fallback_matches_jax(monkeypatch, subsample):
    """``VRT_DISABLE_NATIVE=1``: the port's loader gives None, and its numpy
    path is bytes equal to the JAX package's numpy path."""
    from unittest import mock

    from video_restore_tpu.utils import native as jax_native
    from video_restore_tpu.video import y4m as jax_y4m

    monkeypatch.setenv("VRT_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is None
    frame = np.random.default_rng(2).integers(0, 256, (32, 48, 3), dtype=np.uint8)
    with mock.patch.object(jax_native, "rgb_to_yuv", return_value=None), \
            mock.patch.object(jax_native, "yuv_to_rgb", return_value=None):
        want = jax_y4m.rgb_to_yuv_planes(frame, subsample)
        want_rgb = jax_y4m.yuv_planes_to_rgb(*want)
    got = y4m.rgb_to_yuv_planes(frame, subsample)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(y4m.yuv_planes_to_rgb(*got), want_rgb)


_BUILD = """
import sys
sys.path.insert(0, {repo!r})
from video_restore_tpu_torch.utils import native
lib = native.load()
print(native.library_path(native._FLAG_SETS[0]) if lib is not None else "none")
"""


def test_native_build_named_by_hash_and_atomic(tmp_path):
    """Two processes that build into one ``VRT_NATIVE_CACHE`` at once load
    one library, named by the hash of the source, and leave no temporary
    file behind."""
    env = dict(os.environ, VRT_NATIVE_CACHE=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("VRT_DISABLE_NATIVE", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD.format(repo=str(REPO))], env=env,
                         stdout=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    if outs[0] == "none":
        pytest.skip("no C++ toolchain")
    assert outs[0] == outs[1]
    lib = Path(outs[0])
    assert lib.parent == tmp_path and lib.name.startswith("libframecodec_")
    assert sorted(p.name for p in tmp_path.iterdir()) == [lib.name]
    assert ctypes.CDLL(str(lib)).framecodec_abi_version() == 1


# ---------------------------------------------------------------------------
# y4m


def test_y4m_write_yuv420_append_concat_match_jax(tmp_path, tiny_frames):
    """``write_yuv420``, ``write``, ``append=True`` and ``concat_y4m``: the
    files are equal byte for byte to the JAX package's."""
    from video_restore_tpu.video import y4m as jax_y4m

    planes = rgb_to_yuv420_planar(torch.from_numpy(tiny_frames[:4]).float() / 255).numpy()
    files = {}
    for tag, mod in (("p", y4m), ("j", jax_y4m)):
        a, b, cat = (tmp_path / f"{tag}_{n}.y4m" for n in ("a", "b", "cat"))
        with mod.Y4MWriter(a, 64, 48, 30000 / 1001) as w:
            w.write_yuv420(planes[0])
            w.write(tiny_frames[1])
        with mod.Y4MWriter(a, 64, 48, 30000 / 1001, append=True) as w:
            w.write_yuv420(planes[2])
        with mod.Y4MWriter(b, 64, 48, 30000 / 1001, append=True) as w:  # no file yet
            w.write_yuv420(planes[3])
        n = mod.concat_y4m([a, b], cat)
        files[tag] = (a.read_bytes(), b.read_bytes(), cat.read_bytes(), n)
    assert files["p"] == files["j"]
    assert files["p"][3] == 4
    got = _y4m_planes(tmp_path / "p_cat.y4m")
    np.testing.assert_array_equal(got[[0, 2, 3]], planes[[0, 2, 3]])
    with y4m.Y4MWriter(tmp_path / "c.y4m", 64, 48, 25, colorspace="444") as w:
        with pytest.raises(ValueError, match="4:2:0"):
            w.write_yuv420(planes[0])


# ---------------------------------------------------------------------------
# backend choice

_PATHS = ["a.y4m", "a.npz", "a.mp4", "a.MKV", "a.webm", "-", "pipe:1"]


@pytest.mark.parametrize("with_ffmpeg", [False, True])
def test_backend_table_matches_jax(request, monkeypatch, with_ffmpeg):
    from video_restore_tpu.video import backends as jax_backends

    if with_ffmpeg:
        request.getfixturevalue("fake_ffmpeg_bin")
    else:
        monkeypatch.setenv("PATH", "")
    assert backends.ffmpeg_available() == jax_backends.ffmpeg_available() == with_ffmpeg
    for path in _PATHS:
        for backend in ("auto", "opencv", "ffmpeg"):
            assert backends._pick_backend(path, backend) == jax_backends._pick_backend(path, backend)
            assert backends.writer_supports_yuv420(path, backend) == \
                jax_backends.writer_supports_yuv420(path, backend)
    assert backends._pick_backend("a.mp4") == ("ffmpeg" if with_ffmpeg else "opencv")


# ---------------------------------------------------------------------------
# ffmpeg, through the fake binary


class _Recorder:
    """Records the argv of every subprocess that ``subprocess.Popen`` and
    ``subprocess.run`` start, and starts it."""

    def __init__(self, monkeypatch):
        self.argv = []
        real_popen = subprocess.Popen
        rec = self

        class Popen(real_popen):
            def __init__(self, args, *a, **kw):
                rec.argv.append(list(args))
                super().__init__(args, *a, **kw)

        monkeypatch.setattr(subprocess, "Popen", Popen)


def test_ffmpeg_probe_reader_and_hwaccel_match_jax(fake_ffmpeg_bin, monkeypatch, tmp_path,
                                                    tiny_frames):
    from video_restore_tpu.video import ffmpeg_backend as jax_ff

    clip = tmp_path / "clip.mp4"
    _write_mp4(clip, tiny_frames, audio=True)
    assert asdict(ffmpeg_backend.probe_ffmpeg(clip)) == asdict(jax_ff.probe_ffmpeg(clip))
    assert ffmpeg_backend.detect_hw_accel() == jax_ff.detect_hw_accel() == "vaapi"
    rec = _Recorder(monkeypatch)
    with ffmpeg_backend.FFmpegReader(clip) as r:
        got = np.stack(list(r))
        assert r.info.has_audio and r.info.frames == 8
    with jax_ff.FFmpegReader(clip) as r:
        want = np.stack(list(r))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tiny_frames)
    readers = [a for a in rec.argv if "rawvideo" in a]
    assert len(readers) == 2 and readers[0] == readers[1]
    assert readers[0][1:] == ["-loglevel", "error", "-hwaccel", "vaapi", "-i", str(clip),
                              "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]


def _probe_json(level):
    stream = {"codec_type": "video", "width": 64, "height": 48, "r_frame_rate": "30000/1001"}
    fmt = {}
    if level == 0:
        stream["nb_frames"] = "17"
    elif level == 1:
        fmt["nb_frames"] = "17"
    elif level == 2:
        fmt["duration"] = "0.5839"
    return {"streams": [stream, {"codec_type": "audio"}], "format": fmt}


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_probe_frame_count_fallbacks_match_jax(monkeypatch, level):
    """stream nb_frames -> format nb_frames -> duration x fps -> a counted
    pass: each level gives JAX's VideoInfo."""
    import json

    from video_restore_tpu.video import ffmpeg_backend as jax_ff

    calls = []

    def run(cmd, **kw):
        calls.append(list(cmd))
        out = ({"streams": [{"nb_read_frames": "9"}]} if "-count_frames" in cmd
               else _probe_json(level))
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(out), stderr="")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(shutil, "which", lambda name: f"/bin/{name}")
    got = ffmpeg_backend.probe_ffmpeg("x.mp4")
    n = len(calls)
    want = jax_ff.probe_ffmpeg("x.mp4")
    assert asdict(got) == asdict(want)
    assert calls[:n] == calls[n:]
    assert got.frames == (17, 17, 17, 9)[level] and got.has_audio


@pytest.mark.parametrize("pix_fmt,codec,ext", [("rgb24", "h264", "mp4"), ("yuv420p", "h265", "mkv"),
                                                ("yuv420p", "h264", "mp4")])
def test_ffmpeg_writer_matches_jax(fake_ffmpeg_bin, monkeypatch, tmp_path, tiny_frames,
                                   pix_fmt, codec, ext):
    """The same encoder argv as JAX's, and the same file from the same
    frames (rgb24) or planes (yuv420p)."""
    from video_restore_tpu.video import ffmpeg_backend as jax_ff

    planes = rgb_to_yuv420_planar(torch.from_numpy(tiny_frames).float() / 255).numpy()
    rec = _Recorder(monkeypatch)
    outs = []
    for mod in (ffmpeg_backend, jax_ff):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.{ext}"
        with mod.FFmpegWriter(out, 64, 48, 25.0, codec=codec, crf=18, preset="fast",
                              pix_fmt=pix_fmt) as w:
            for f, p in zip(tiny_frames, planes):
                w.write(f) if pix_fmt == "rgb24" else w.write_yuv420(p)
            wrong = w.write_yuv420 if pix_fmt == "rgb24" else w.write
            with pytest.raises(ValueError):
                wrong(planes[0] if pix_fmt == "rgb24" else tiny_frames[0])
            assert w.frames_written == 8
        outs.append(np.load(out)["frames"])
    a, b = rec.argv
    assert a[1:-1] == b[1:-1] and Path(a[-1]).suffix == Path(b[-1]).suffix
    assert ("+faststart" in a) == (ext == "mp4") and a[a.index("-pix_fmt") + 1] == pix_fmt
    np.testing.assert_array_equal(outs[0], outs[1])
    if pix_fmt == "rgb24":
        np.testing.assert_array_equal(outs[0], tiny_frames)


@pytest.mark.parametrize("audio", [True, False])
def test_copy_audio_matches_jax(fake_ffmpeg_bin, tmp_path, tiny_frames, audio):
    """With an audio track it is copied (True); without one the mux fails
    softly (False, the output untouched), as in JAX."""
    from video_restore_tpu.video.mux import copy_audio as jax_copy_audio

    src = tmp_path / "src.mp4"
    _write_mp4(src, tiny_frames, audio=audio)
    results = []
    for tag, fn in (("p", mux.copy_audio), ("j", jax_copy_audio)):
        out = tmp_path / f"{tag}.mp4"
        _write_mp4(out, tiny_frames[:2])
        results.append(fn(src, out))
        d = np.load(out)
        assert ("audio" in d) == audio
        np.testing.assert_array_equal(d["frames"], tiny_frames[:2])
        assert not Path(str(out) + ".temp.mp4").exists()
    assert results == [audio, audio]


def test_copy_audio_without_ffmpeg(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    assert mux.copy_audio(tmp_path / "a.mp4", tmp_path / "b.mp4") is False


# ---------------------------------------------------------------------------
# OpenCV


def test_opencv_backend_imports_without_cv2():
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "from video_restore_tpu_torch.video import opencv_backend as m\n"
        "try:\n    m.probe_opencv('x.mp4')\nexcept ImportError:\n    print('refused')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "refused"


def test_opencv_roundtrip_matches_jax(tmp_path, tiny_frames):
    """Where ``cv2`` exists: the port's writer and reader give JAX's frames
    (the same codec choice, the same decode)."""
    pytest.importorskip("cv2")
    from video_restore_tpu.video import opencv_backend as jax_cv

    from video_restore_tpu_torch.video import opencv_backend

    got = []
    for mod in (opencv_backend, jax_cv):
        out = tmp_path / f"{mod.__name__.split('.')[0]}.avi"
        with mod.OpenCVWriter(out, 64, 48, 25.0, codec="mjpeg") as w:
            for f in tiny_frames:
                w.write(f)
            codec = w.codec
        info = mod.probe_opencv(out)
        with mod.OpenCVReader(out) as r:
            got.append((codec, info, np.stack(list(r))))
    (c0, i0, f0), (c1, i1, f1) = got
    assert c0 == c1 and asdict(i0) == asdict(i1)
    np.testing.assert_array_equal(f0, f1)
    assert f0.shape == tiny_frames.shape


# ---------------------------------------------------------------------------
# the runner


def test_yuv_eligible_matches_jax(tmp_path):
    """``tests/test_device_yuv.py``'s cases, through both packages."""

    class Info:
        width, height = 64, 48

    cases = [("o.npz", 128, 96, {}), ("o.y4m", 128, 96, {}), ("o.y4m", 100, 96, {}),
             ("o.y4m", 128, 96, {"face_enhance": True}), ("o.y4m", 128, 96, {"device_yuv": "off"}),
             ("o.y4m", 128, 94, {}), ("o.y4m", 126, 96, {})]
    answers = []
    for name, w, h, kw in cases:
        j, p = _restorers(**kw)
        want = j._yuv_eligible(tmp_path / name, Info, w, h)
        assert p._yuv_eligible(tmp_path / name, Info, w, h) == want, (name, w, h, kw)
        answers.append(want)
    assert answers == [False, True, False, False, False, False, False]


@pytest.fixture(scope="module")
def both_restorers():
    return _restorers(audio_copy=True)


@pytest.mark.parametrize("container", ["y4m", "mp4"])
def test_process_video_matches_jax(request, tmp_path, tiny_frames, monkeypatch, both_restorers,
                                   container):
    """The same clip through both packages' ``VideoRestorer``: the planes
    written (the y4m file's, or those on the ffmpeg pipe) agree within the
    rule above; the port's y4m bytes are its step's planes; the mp4 gets
    the source's audio."""
    from video_restore_tpu.video import ffmpeg_backend as jax_ff

    jr, pr = both_restorers
    frames = tiny_frames[:5]
    src = tmp_path / f"in.{container}"
    piped = {}
    if container == "mp4":
        request.getfixturevalue("fake_ffmpeg_bin")
        _write_mp4(src, frames, audio=True)
        for tag, mod in (("p", ffmpeg_backend), ("j", jax_ff)):
            piped[tag] = []

            def tap(self, planar, _orig=mod.FFmpegWriter.write_yuv420, _log=piped[tag]):
                _log.append(np.array(planar))
                _orig(self, planar)

            monkeypatch.setattr(mod.FFmpegWriter, "write_yuv420", tap)
    else:
        with y4m.Y4MWriter(src, 64, 48, 25) as w:
            for f in frames:
                w.write(f)
    outs = {}
    for tag, r in (("p", pr), ("j", jr)):
        out = tmp_path / f"out_{tag}.{container}"
        assert r.process_video(src, out, show_progress=False)
        outs[tag] = out
    if container == "y4m":
        got, want = _y4m_planes(outs["p"]), _y4m_planes(outs["j"])
    else:
        got, want = np.stack(piped["p"]), np.stack(piped["j"])
        for tag in ("p", "j"):
            d = np.load(outs[tag])
            assert "audio" in d and d["frames"].shape == (5, 96, 128, 3)
    assert got.shape == want.shape == (5, 144, 128)
    _assert_u8_close(got, want)
    # the port's output is its step's planes, byte for byte
    ups = pr._upscaler_for(48, 64, yuv_out=True)
    ups.reset_temporal()
    with open_reader(src) as rd:
        decoded = list(rd)
    step = np.concatenate([ups.process_batch(f[None]).numpy() for f in decoded])
    np.testing.assert_array_equal(got, step)
    assert pr.last_stats.decoded == pr.last_stats.encoded == 5


def test_yuv_path_does_no_host_colour_work(tmp_path, tiny_frames, monkeypatch):
    """On the yuv path the encode thread converts nothing: the host's
    RGB -> YUV functions raise if called, and the run succeeds."""
    _, pr = _restorers()
    src = tmp_path / "in.npz"
    with open(src, "wb") as fh:
        np.savez(fh, frames=tiny_frames[:3], fps=25.0)

    def boom(*a, **kw):
        raise AssertionError("host colour conversion on the yuv path")

    monkeypatch.setattr(y4m, "rgb_to_yuv_planes", boom)
    monkeypatch.setattr(native, "rgb_to_yuv", boom)
    assert pr.process_video(src, tmp_path / "out.y4m", show_progress=False)
    assert list(pr._upscalers) == [(48, 64, True)]
    assert _y4m_planes(tmp_path / "out.y4m").shape == (3, 144, 128)
    # the RGB path does convert on the host, so there the run fails
    pr.config.device_yuv = "off"
    assert not pr.process_video(src, tmp_path / "out3.y4m", show_progress=False)


def test_pinned_ring_bookkeeping():
    """No slot is handed out twice before its release; a full ring blocks
    until a release; slots come back in release order; a slot's buffer
    follows the requested shape."""
    ring = PinnedRing(3, pin=False)
    slots = [ring.acquire((2, 4), torch.uint8) for _ in range(3)]
    assert len({id(s) for s in slots}) == 3
    got = []
    t = threading.Thread(target=lambda: got.append(ring.acquire((2, 4), torch.uint8)))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive() and not got  # blocked: every slot is out
    ring.release(slots[1])
    t.join(timeout=10)
    assert not t.is_alive() and got[0] is slots[1]
    ring.release(slots[2])
    ring.release(slots[0])
    ring.release(got[0])
    order = [ring.acquire((3, 5), torch.uint8) for _ in range(3)]
    assert order == [slots[2], slots[0], slots[1]]
    assert all(s.buf.shape == (3, 5) and not s.buf.is_pinned() for s in order)


class _Event:
    """Stands in for a CUDA event: ``synchronize`` records that it was
    waited on."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


def test_pinned_ring_waits_on_the_copy_event():
    ring = PinnedRing(1, pin=False)
    slot = ring.acquire((4,), torch.uint8)
    ev = _Event()
    ring.release(slot, ev)
    assert ring.acquire((4,), torch.uint8) is slot and ev.waited and slot.event is None


def test_ring_under_a_slow_writer(tmp_path, tiny_frames, monkeypatch):
    """24 batches through a fetch ring of 2 slots (``max_inflight_batches``
    1) with a writer that sleeps: every frame equals the step's, in order;
    a writer that fails mid-run ends the run without hanging."""
    _, pr = _restorers(max_inflight_batches=1)
    frames = np.concatenate([tiny_frames, tiny_frames[::-1], tiny_frames])  # 24 frames
    src = tmp_path / "in.npz"
    with open(src, "wb") as fh:
        np.savez(fh, frames=frames, fps=25.0)
    orig = y4m.Y4MWriter.write_yuv420

    def slow(self, planar):
        time.sleep(0.005)
        orig(self, planar)

    monkeypatch.setattr(y4m.Y4MWriter, "write_yuv420", slow)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert pr.process_video(src, tmp_path / "out.y4m", show_progress=False)
    finally:
        sys.setswitchinterval(old)
    ups = pr._upscaler_for(48, 64, yuv_out=True)
    assert ups._fetch._free.qsize() == 2  # every slot came back
    ups.reset_temporal()
    step = np.concatenate([ups.process_batch(f[None]).numpy() for f in frames])
    np.testing.assert_array_equal(_y4m_planes(tmp_path / "out.y4m"), step)

    calls = []

    def failing(self, planar):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk full")
        orig(self, planar)

    monkeypatch.setattr(y4m.Y4MWriter, "write_yuv420", failing)
    t = threading.Thread(
        target=lambda: calls.append(pr.process_video(src, tmp_path / "bad.y4m", show_progress=False))
    )
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and calls[-1] is False
    assert ups._fetch._free.qsize() == 2

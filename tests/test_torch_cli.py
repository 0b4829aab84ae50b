"""The port's CLI end to end on the CPU: ``python -m
video_restore_tpu_torch.cli in.y4m out.y4m --cpu`` with RealESRGAN_x4plus
(nf 64, 23 blocks, random weights) on a tiny clip, full frame, enhanced;
tiled mode (seamless and legacy) for both model families; the face pass,
the outscale resize and ``--profile``; the flags that were refused until
their subsystems were ported (``--multihost``, ``--shard-mode tiles``), and
``--cpu --devices 2``, which exits 1.

A y4m sink takes planar I420 from the device, so the CLI's file holds the
restore step's planes (``Upscaler(yuv420_out=True)``) byte for byte; one
case also checks the RGB path (``device_yuv="off"``) through the y4m
colour round trip."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_restore_tpu_torch import cli
from video_restore_tpu_torch.video.y4m import Y4MReader, Y4MWriter

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _y4m_planes(path):
    """The raw planar frames of a 4:2:0 y4m file: (n, H*3//2, W) uint8."""
    with open(path, "rb") as f:
        header = f.readline().split()
        w, h = (int(t[1:]) for t in header[1:3])
        frames = []
        while f.readline():
            frames.append(np.frombuffer(f.read(w * h * 3 // 2), np.uint8).reshape(h * 3 // 2, w))
    return np.stack(frames)


def _clip(path, n=3, h=16, w=24):
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, 25) as wr:
        for t in range(n):
            f = np.stack([xx * 255 / w, yy * 255 / h, np.full((h, w), 40 + 30 * t)], -1)
            f = f + rng.integers(-10, 10, (h, w, 3))
            wr.write(np.clip(f, 0, 255).astype(np.uint8))


def test_cli_restores_clip_on_cpu(tmp_path):
    src, dst = tmp_path / "in.y4m", tmp_path / "out.y4m"
    _clip(src)
    env = dict(os.environ, VRT_ALLOW_RANDOM_WEIGHTS="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    r = subprocess.run(
        [
            sys.executable, "-m", "video_restore_tpu_torch.cli",
            str(src), str(dst), "--cpu", "--model", "RealESRGAN_x4plus",
            "--tile-size", "0", "--enhanced", "--sharpen", "0.3",
            "--models-dir", str(tmp_path / "models"),
        ],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    with Y4MReader(dst) as rd:
        frames = list(rd)
        assert (rd.info.width, rd.info.height) == (96, 64)
    assert len(frames) == 3
    assert all(f.shape == (64, 96, 3) and f.dtype == np.uint8 for f in frames)


# ported since the flag list was written: these cases must now run
NOW_PORTED = (
    ["--batch"], ["--segment-frames", "8"], ["--tile-size", "128"],
    ["--model", "RealESRGAN_x4_v3"], ["--face-enhance"], ["--outscale", "2"],
    ["--profile", "TRACE_DIR"], ["--multihost"], ["--shard-mode", "tiles"],
)


@pytest.mark.parametrize(
    "flags",
    [
        ["--batch"],
        ["--face-enhance"],
        ["--multihost"],
        ["--segment-frames", "8"],
        ["--tile-size", "128"],
        ["--shard-mode", "tiles"],
        ["--model", "RealESRGAN_x4_v3"],
        ["--outscale", "2"],
        ["--profile", "TRACE_DIR"],
        ["--devices", "2"],
    ],
)
def test_unported_flags_exit_1(tmp_path, capsys, monkeypatch, flags):
    """Every flag of this list once exited 1 with "not yet ported"; all are
    ported now and run on --cpu: tiled mode, SRVGGNetCompact, batch
    directories, segmented output, the face pass (the region heuristic
    without GFPGAN weights), the outscale resize, ``--profile`` (a
    torch.profiler trace of the run in DIR/trace.json), ``--multihost``
    (a one-process group: ``--coordinator`` and ``WORLD_SIZE=1``) and
    ``--shard-mode tiles``. ``--cpu --devices 2`` exits 1: the CPU is one
    device."""
    src, dst = tmp_path / "in.y4m", tmp_path / "o.y4m"
    _clip(src, n=1)
    trace_dir = tmp_path / "trace"
    if flags in NOW_PORTED:
        flags = [str(trace_dir) if f == "TRACE_DIR" else f for f in flags]
        if "--multihost" in flags:
            import socket

            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            flags = flags + ["--coordinator", f"127.0.0.1:{s.getsockname()[1]}"]
            s.close()
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.delenv("RANK", raising=False)
        monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
        extra = ["--model", "RealESRGAN_x4plus_anime_6B"] if "--model" not in flags else []
        args = [str(src), str(dst)]
        if "--batch" in flags:  # a directory in, a directory out
            indir = tmp_path / "in"
            indir.mkdir()
            src.rename(indir / "in.y4m")
            args = [str(indir), str(tmp_path / "out")]
            dst = tmp_path / "out" / "in_upscaled.y4m"
        rc = cli.main(
            args + ["--cpu", "--models-dir", str(tmp_path / "m")] + extra + flags
        )
        assert rc == 0, capsys.readouterr().err[-2000:]
        with Y4MReader(dst) as rd:
            size = (48, 32) if "--outscale" in flags else (96, 64)
            assert (rd.info.width, rd.info.height) == size
            assert len(list(rd)) == 1
        if "--profile" in flags:
            events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
            assert any(e.get("name") == "aten::conv2d" for e in events)
        return
    rc = cli.main([str(src), str(dst), "--cpu"] + flags)
    assert rc == 1
    assert "Requested 2 devices but only 1 available" in capsys.readouterr().err


def test_cli_gfpgan_without_weights_exits_1(tmp_path, capsys, monkeypatch):
    """``--face-model gfpgan`` with no GFPGANv1.4.pth: exit 1 with the JAX
    package's message, and no output written."""
    src, dst = tmp_path / "in.y4m", tmp_path / "o.y4m"
    _clip(src, n=1)
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("VRT_GFPGAN_RANDOM", raising=False)
    rc = cli.main([str(src), str(dst), "--cpu", "--models-dir", str(tmp_path / "m"),
                   "--model", "RealESRGAN_x4plus_anime_6B", "--face-enhance",
                   "--face-model", "gfpgan"])
    assert rc == 1
    assert ("--face-model gfpgan requires the GFPGANv1.4 weights (no download possible "
            "and no cached file)") in capsys.readouterr().err
    assert not dst.exists()


@pytest.mark.parametrize("model", ["RealESRGAN_x4plus_anime_6B", "RealESRGAN_x4_v3"])
def test_cli_int8_on_cpu(tmp_path, capsys, monkeypatch, model):
    """--precision int8 --cpu runs for both families (the W8A8 body on the
    plain path) and writes the planes the int8 restore step computes; with
    ``device_yuv="off"`` (the anime_6B case) the RGB path writes the step's
    frames after the y4m colour round trip; without --cpu and without a GPU
    it exits 1 with the "no CUDA device" error."""
    import dataclasses

    import torch

    from video_restore_tpu_torch.models.zoo import random_model
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.video.y4m import rgb_to_yuv_planes, yuv_planes_to_rgb

    src, dst = tmp_path / "in.y4m", tmp_path / "o.y4m"
    _clip(src, n=2)
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    flags = ["--model", model, "--precision", "int8", "--tile-size", "0"]
    argv = [str(src), str(dst), "--models-dir", str(tmp_path / "m")] + flags
    rc = cli.main(argv + ["--cpu"])
    assert rc == 0, capsys.readouterr().err[-2000:]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.precision == "int8"
    restorer = VideoRestorer(cfg, model=random_model(model), cpu=True)
    ups = restorer._upscaler_for(16, 24, yuv_out=True)
    (step,) = ups.shards  # one device: one shard
    assert step.net.precision == "int8" and step.compute_dtype == torch.bfloat16
    with Y4MReader(src) as rd:
        frames = list(rd)
    with Y4MReader(dst) as rd:
        assert (rd.info.width, rd.info.height) == (96, 64)
    planes = _y4m_planes(dst)
    assert planes.shape == (2, 96, 96)
    for f, o in zip(frames, planes):
        np.testing.assert_array_equal(ups.process_batch(f[None])[0].numpy(), o)
    if model == "RealESRGAN_x4plus_anime_6B":
        rgb_cfg = dataclasses.replace(cfg, device_yuv="off")
        rgb = VideoRestorer(rgb_cfg, model=random_model(model), cpu=True)
        assert rgb.process_video(src, tmp_path / "rgb.y4m", show_progress=False)
        step = rgb._upscaler_for(16, 24)
        with Y4MReader(tmp_path / "rgb.y4m") as rd:
            out = list(rd)
        assert len(out) == 2
        for f, o in zip(frames, out):
            want = step.process_batch(f[None])[0].numpy()
            np.testing.assert_array_equal(yuv_planes_to_rgb(*rgb_to_yuv_planes(want, "420")), o)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert cli.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["RealESRGAN_x4plus_anime_6B", "RealESRGAN_x4_v3"])
@pytest.mark.parametrize("legacy", [False, True])
def test_cli_tiled_on_cpu(tmp_path, capsys, monkeypatch, model, legacy):
    """--tile-size 16 --tile-overlap 4 on a 16x24 clip (a 1x2 tile grid in
    both modes) through the CLI on --cpu: the file's planes equal the
    restore step's on the same grid."""
    import torch

    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import random_model
    from video_restore_tpu_torch.parallel.dispatch import Upscaler
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer

    src, dst = tmp_path / "in.y4m", tmp_path / "o.y4m"
    _clip(src, n=2)
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    flags = ["--model", model, "--tile-size", "16", "--tile-overlap", "4",
             "--enhanced", "--quality", "fast"] + (["--no-seamless"] if legacy else [])
    rc = cli.main([str(src), str(dst), "--cpu", "--models-dir", str(tmp_path / "m")] + flags)
    assert rc == 0, capsys.readouterr().err[-2000:]
    cfg = cli.config_from_args(cli.build_parser().parse_args([str(src), str(dst)] + flags))
    assert cfg.full_frame == "off" and cfg.legacy_tiling == legacy
    ups = VideoRestorer(cfg, model=random_model(model), cpu=True)._upscaler_for(
        16, 24, yuv_out=True
    )
    assert ups.grid.n_tiles == 2
    with Y4MReader(src) as rd:
        frames = list(rd)
    with Y4MReader(dst) as rd:
        out = list(rd)
    assert len(out) == 2 and all(f.shape == (64, 96, 3) for f in out)
    # the CLI's planes are the step's
    for f, o in zip(frames, _y4m_planes(dst)):
        assert np.array_equal(ups.process_batch(f[None])[0].numpy(), o)
    assert isinstance(ups.shards[0].net, torch.nn.Module)


def test_missing_input_exit_1(tmp_path):
    assert cli.main([str(tmp_path / "nope.y4m"), str(tmp_path / "o.y4m"), "--cpu"]) == 1

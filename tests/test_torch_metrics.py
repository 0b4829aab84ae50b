"""The port's small host modules against the JAX package, on the CPU:

- ``metrics.py``: PSNR, SSIM, MS-SSIM and GMSD of the same frames equal to
  JAX's (the same numpy/scipy code: equal floats), ``compare_videos`` and
  the CLI's JSON equal on the same two clips;
- ``video/fixtures.py``: ``synth_source_clip`` and every one of the 13
  presets equal to JAX's frame for frame, byte for byte (the same seeds,
  the same ``cv2``); ``create_test_videos`` writes the same clips;
- ``utils/knobs.py``: the registry holds exactly the ``VRT_*`` names the
  port's sources (the package and ``chip_smoke.py``) read, and warns about
  the others;
- ``utils/profiling.py``: ``device_busy_share`` on a hand-made trace (the
  union of overlapping device intervals over the window), ``device_trace``
  writes a CPU trace here.
"""

import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from video_restore_tpu import metrics as jax_metrics
from video_restore_tpu.video import fixtures as jax_fixtures
from video_restore_tpu_torch import metrics
from video_restore_tpu_torch.utils import knobs, profiling
from video_restore_tpu_torch.video import fixtures

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _pair(rng, h=64, w=72):
    a = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-12, 12, a.shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("fn", ["frame_psnr", "frame_ssim", "frame_msssim", "frame_gmsd"])
def test_frame_metrics_equal_jax(fn, rng):
    a, b = _pair(rng, 200, 180)  # MS-SSIM's five scales need >= 176 px
    assert getattr(metrics, fn)(a, b) == getattr(jax_metrics, fn)(a, b)
    assert getattr(metrics, fn)(a, a) == getattr(jax_metrics, fn)(a, a)


def test_compare_videos_and_cli_equal_jax(tmp_path, rng, capsys):
    from video_restore_tpu_torch.video.y4m import Y4MWriter

    paths = [tmp_path / "ref.y4m", tmp_path / "test.y4m"]
    pairs = [_pair(rng) for _ in range(3)]
    for path, k in zip(paths, (0, 1)):
        with Y4MWriter(path, 72, 64, 25) as w:
            for pair in pairs:
                w.write(pair[k])
    kw = dict(msssim=False, gmsd=True)
    got = metrics.compare_videos(str(paths[0]), str(paths[1]), **kw)
    assert got == jax_metrics.compare_videos(str(paths[0]), str(paths[1]), **kw)
    assert got["frames"] == 3 and got["psnr_min"] < 40
    argv = [str(paths[0]), str(paths[1]), "--gmsd", "--frames", "2"]
    assert metrics.main(argv) == 0
    port_out = capsys.readouterr().out
    assert jax_metrics.main(argv) == 0
    assert json.loads(port_out) == json.loads(capsys.readouterr().out)


def test_synth_source_clip_equal_jax():
    got = fixtures.synth_source_clip(n_frames=4, height=96, width=160, seed=3)
    ref = jax_fixtures.synth_source_clip(n_frames=4, height=96, width=160, seed=3)
    assert len(got) == 4 and all(np.array_equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("preset", list(jax_fixtures.PRESETS))
def test_preset_equal_jax(preset):
    assert list(fixtures.PRESETS) == list(jax_fixtures.PRESETS)
    src = fixtures.synth_source_clip(n_frames=6, height=144, width=256)
    got = fixtures.degrade_frames(src, preset, seed=1)
    ref = jax_fixtures.degrade_frames(src, preset, seed=1)
    assert len(got) == len(ref) >= 2
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_create_test_videos_equal_jax(tmp_path):
    from video_restore_tpu_torch.video import open_reader

    kw = dict(presets=["clean_144p", "old_webcam"], clip_frames=4)
    got = fixtures.create_test_videos(None, tmp_path / "port", **kw)
    ref = jax_fixtures.create_test_videos(None, tmp_path / "jax", **kw)
    assert [p.name for p in got] == [p.name for p in ref] == ["clean_144p.y4m", "old_webcam.y4m"]
    for a, b in zip(got, ref):
        assert a.read_bytes() == b.read_bytes()
        with open_reader(a) as r:
            assert len(list(r)) == (4 if "clean" in a.name else 2)


def _port_source_knobs() -> set:
    files = list((REPO / "video_restore_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = set()
    for f in files:
        if f.name == "knobs.py" and f.parent.name == "utils":  # the registry itself
            continue
        names |= set(re.findall(r"VRT_[A-Z0-9_]+", f.read_text()))
    return names


def test_knob_registry_is_the_ports_sources():
    assert knobs.KNOWN_KNOBS == _port_source_knobs()
    assert len(knobs.KNOWN_KNOBS) == 12


def test_warn_unknown_knobs(caplog):
    env = {"VRT_TAIL_Q": "1", "VRT_STRIPE": "1", "VRT_TYPO": "1", "PATH": "/"}
    with caplog.at_level(logging.WARNING, logger="video_restore_tpu_torch"):
        unknown = knobs.warn_unknown_knobs(env)
    # VRT_STRIPE is a knob of the JAX package's TPU paths; the port reads none
    assert unknown == ["VRT_STRIPE", "VRT_TYPO"]
    assert sum("VRT_TYPO" in r.message for r in caplog.records) == 1
    assert knobs.warn_unknown_knobs({"VRT_PALLAS": "1"}) == []


def test_device_busy_share_of_a_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 100, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "conv3x3_mma_kernel", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 100},  # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 600, "dur": 50},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 700},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 1000, "dur": 100},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.device_busy_share(path)
    # busy: [200, 350) + [600, 650) + [1000, 1100) = 300 us of [100, 1100)
    assert got == dict(busy_ms=0.3, window_ms=1.0, share=0.3, events=4.0)


def test_device_trace_writes_a_cpu_trace(tmp_path):
    with profiling.device_trace(tmp_path / "tr"):
        torch.nn.functional.conv2d(torch.rand(1, 3, 8, 8), torch.rand(4, 3, 3, 3))
    trace = tmp_path / "tr" / profiling.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    assert profiling.device_busy_share(trace)["events"] == 0  # no device here
    with profiling.device_trace(""):  # off: nothing written
        pass

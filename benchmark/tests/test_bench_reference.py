"""The plain reference against the port's CPU path at small sizes, both in
float32: the colour conversions, each stage of the post stack, both
models at their published widths, and the whole restore step over a cut
and the frames after it. (The tests may import the port; the reference
may not: test_bench_hygiene.py.)"""

import json

import numpy as np
import pytest
import torch

from benchmark.harness.check import ReferenceStep
from benchmark.harness.video import Stream
from benchmark.reference import color, post, rrdbnet, srvgg
from benchmark.tests.conftest import REPO


def frame(seed, h=24, w=32):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(h, w, 3, generator=g)


def test_decode_matches_the_ports_numpy_path(monkeypatch):
    from video_restore_tpu_torch.utils import native
    from video_restore_tpu_torch.video import y4m

    monkeypatch.setattr(native, "yuv_to_rgb", lambda *a: None)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    u = rng.integers(0, 256, (8, 12), dtype=np.uint8)
    v = rng.integers(0, 256, (8, 12), dtype=np.uint8)
    np.testing.assert_array_equal(color.decode_420(y, u, v), y4m.yuv_planes_to_rgb(y, u, v))


def test_i420_matches_the_ports():
    from video_restore_tpu_torch.ops.color import rgb_to_yuv420_planar

    x = frame(1, 16, 24) * 1.2 - 0.1
    want = rgb_to_yuv420_planar(torch.clamp(x, 0, 1)[None])[0]
    assert torch.equal(color.encode_i420(x), want)


def test_post_stages_match_the_ports():
    from video_restore_tpu_torch.ops import post as port
    from video_restore_tpu_torch.parallel.dispatch import _luma_hist

    x = frame(2)
    torch.testing.assert_close(post.bilateral(x, 5, 25.0, 25.0), port.bilateral_filter(x[None], 5, 25.0, 25.0)[0],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(post.clahe(x, 2.0), port.clahe(x[None], 2.0)[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(post.unsharp(x, 0.3, 1.5, 4), port.unsharp_mask(x[None], 0.3, 1.5, 4)[0],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(post.luma_hist(x), _luma_hist(x[None])[0], rtol=1e-5, atol=1e-7)


def config(name):
    return json.loads((REPO / f"benchmark/configs/{name}.json").read_text())


@pytest.mark.parametrize("name, ref", [("realesrgan_x4plus", rrdbnet), ("realesr_general_x4v3", srvgg)])
def test_models_match_the_ports_plain_float32_path(name, ref):
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO, ModelHandle

    cfg = config(name)
    w = ref.make_weights(cfg, 123, torch.device("cpu"))
    net = ModelHandle(cfg["model"], MODEL_ZOO[cfg["model"]].spec, w).module(torch.float32, torch.device("cpu"), "bf16")
    x = frame(3, 12, 16)[None]
    got = net(x, plain=True)
    want = ref.forward(w, x, cfg)
    assert got.shape == want.shape == (1, 48, 64, 3)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # the output follows the input: image-like, mostly inside [0, 1]
    assert 0.2 < float(want.mean()) < 0.8 and float(((want < 0) | (want > 1)).float().mean()) < 0.05


@pytest.mark.parametrize("cell", ["x4plus_1080p_enhanced", "x4v3_1080p_anime"])
def test_the_step_over_a_cut_matches_the_ports(cell, small_cell):
    """The port's Upscaler at float32 from the frame before a cut on, so
    its carry at the cut is that frame's output before the EMA, which is
    what the reference stands in for it."""
    from benchmark.harness import program
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO, ModelHandle
    from video_restore_tpu_torch.ops.tiles import TileGrid
    from video_restore_tpu_torch.parallel.dispatch import Upscaler

    c = small_cell(cell, width=48, height=32)
    cfg = c.config
    stream = Stream(c.traffic, 99)
    cut, n = stream.shot_frames, int(c.traffic["compare_frames"])
    ref = ReferenceStep(cfg, c.traffic["step"], torch.device("cpu"))
    ref.load_weights(99)
    outs, pre, blended, margin = ref.shot(stream, cut, n)
    rc = program.build_config(list(cfg["args"]) + list(c.traffic["job"]) + ["--precision", "fp32"])
    handle = ModelHandle(cfg["model"], MODEL_ZOO[cfg["model"]].spec, ref.w)
    grid = TileGrid.build(32, 48, tile=0, overlap=0, scale=4)
    up = Upscaler(handle, grid, rc, torch.device("cpu"), yuv420_out=True)
    got = []
    for t in range(cut - 1, cut + n):
        rgb = color.decode_420(*stream.planes(t))
        got.append(up.process_batch(rgb[None])[0])
    for g, o in zip(got[1:], outs):
        d = (g.int() - o.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01

"""The port's ``--outscale`` resize against the JAX package's, on the CPU.

- ``ops/resample.py::resize_lanczos4`` against ``cv2.resize(INTER_LANCZOS4)``
  (what ``runner.py::_resizer`` of the JAX package calls) on a x4 model's
  output at outscale 2, 3 and 1.5, and one upscale past the model's scale:
  equal byte for byte, with and without a leading batch axis.
- ``resize_linear`` (the face pass's square crops) against
  ``cv2.resize(INTER_LINEAR)``: within 1 level on at most 1% of values; the
  exact 2x downscale (cv2's area mean) equal.
- ``VideoRestorer.process_video`` with ``outscale`` 3 and 1.5 on a tiny
  SRVGG (x2) against the JAX pipeline: the frame count and size, and the
  frames within 1 level on at most 0.5% of values (the fp32 models agree to
  ~1e-5, so a value at a rounding boundary moves a level before the
  resize); the ``resize`` stage is timed; a y4m sink takes the RGB path.
- The batch warm-up sizes every pinned fetch slot for the resized output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops.resample import resize_lanczos4, resize_linear

cv2 = pytest.importorskip("cv2")

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _x4_output(seed=0, h=96, w=144):
    """A textured frame at a x4 model's output size (24x36 in)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([xx * 255 / w, yy * 255 / h, 128 + 100 * np.sin(xx / 5.0 + yy / 7.0)], -1)
    return np.clip(f + rng.normal(0, 20, f.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("outscale", [2.0, 3.0, 1.5, 5.0])
def test_lanczos4_matches_cv2(outscale):
    """From a x4 model: 2 and 3 shrink, 1.5 shrinks by 2.67, 5 enlarges."""
    frames = np.stack([_x4_output(s) for s in range(2)])
    size = (int(36 * outscale), int(24 * outscale))
    want = np.stack([cv2.resize(f, size, interpolation=cv2.INTER_LANCZOS4) for f in frames])
    got = resize_lanczos4(torch.from_numpy(frames), size).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resize_lanczos4(torch.from_numpy(frames[0]), size).numpy(), want[0])


@pytest.mark.parametrize("size", [(512, 512), (72, 48), (61, 37), (40, 27)])
def test_linear_matches_cv2(size):
    f = _x4_output(3)
    want = cv2.resize(f, size, interpolation=cv2.INTER_LINEAR)
    got = resize_linear(torch.from_numpy(f), size).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    if size == (72, 48):  # exactly half: cv2's 2x2 area mean
        np.testing.assert_array_equal(got, want)


def _tiny_models():
    from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
    from video_restore_tpu.models.zoo import ModelHandle
    from video_restore_tpu_torch.models.srvgg import SRVGGSpec as PSpec
    from video_restore_tpu_torch.models.srvgg import params_from_jax
    from video_restore_tpu_torch.models.zoo import ModelHandle as PHandle

    spec = SRVGGSpec(num_feat=8, num_conv=2, scale=2)
    params = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(0), spec))
    for k in ("conv_in", "body", "conv_out"):
        params[k]["w"] = params[k]["w"] * 10.0
    return (ModelHandle("tiny", spec, jax.tree.map(jnp.asarray, params)),
            PHandle("tiny", PSpec(num_feat=8, num_conv=2, scale=2), params_from_jax(params)))


def _clip(path, frames):
    from video_restore_tpu.video import open_writer

    with open_writer(path, frames.shape[2], frames.shape[1], 25) as w:
        for f in frames:
            w.write(f)


_CFG = dict(model_name="RealESRGAN_x4_v3", tile_size=16, tile_overlap=4, precision="fp32",
            audio_copy=False)


@pytest.mark.parametrize("outscale", [3.0, 1.5])
def test_process_video_outscale_matches_jax(tmp_path, tiny_frames, outscale):
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.config import RestoreConfig as PConfig
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PRestorer
    from video_restore_tpu_torch.video import probe

    src = tmp_path / "in.npz"
    _clip(src, tiny_frames[:3])
    jm, pm = _tiny_models()
    jr = VideoRestorer(RestoreConfig(**_CFG, outscale=outscale), model=jm)
    pr = PRestorer(PConfig(**_CFG, outscale=outscale), model=pm, cpu=True)
    outs = {}
    for tag, r in (("j", jr), ("p", pr)):
        assert r.process_video(src, tmp_path / f"out_{tag}.npz", show_progress=False)
        outs[tag] = np.load(tmp_path / f"out_{tag}.npz")["frames"]
    size = (int(48 * outscale), int(64 * outscale))
    assert outs["p"].shape == outs["j"].shape == (3,) + size + (3,)
    d = np.abs(outs["p"].astype(np.int32) - outs["j"].astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())
    assert "resize" in pr.last_stats.stages
    # a y4m sink: the resized frames take the RGB path
    dst = tmp_path / "out.y4m"
    assert pr.process_video(src, dst, show_progress=False)
    assert list(pr._upscalers)[-1] == (48, 64, False)
    info = probe(dst)
    assert (info.width, info.height, info.frames) == (size[1], size[0], 3)


def test_warmup_sizes_fetch_slots_for_the_resized_output(tmp_path, tiny_frames):
    from video_restore_tpu_torch.config import RestoreConfig as PConfig
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer as PRestorer

    _, pm = _tiny_models()
    pr = PRestorer(PConfig(**_CFG, outscale=3.0), model=pm, cpu=True)
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    _clip(a, tiny_frames[:1])
    _clip(b, tiny_frames[:1, :32, :40])
    pr._warmup_buckets([(a, tmp_path / "oa.npz"), (b, tmp_path / "ob.npz")])
    for (h, w, yuv), ups in pr._upscalers.items():
        assert not yuv
        ring = ups._fetch
        shapes = [tuple(s.buf.shape) for s in list(ring._free.queue)]
        assert shapes == [(1, 3 * h, 3 * w, 3)] * ring.depth

"""The bf16 post stack (``VRT_POST_DT=bf16``) and ``VRT_POST_BF16=1``
against the JAX package, on the CPU.

Under ``VRT_POST_DT=bf16`` a full-frame step keeps the model's bf16 output
through the post stack (JAX ``ops/tiles.py:408-413``, ``ops/post.py:285-294``,
``parallel/dispatch.py:182-258``). Each side reads the knob at call time;
the tests set it with ``monkeypatch.setenv``. Inputs are made from a seed
with numpy and given to both packages.

Tolerances:

- K2's bf16 function (``unsharp_fused_plain``) against JAX
  ``pallas_post.unsharp_fused(block_h=8, interpret=True)`` on the same bf16
  frame (8 | h and h >= 24, so that the Pallas kernel itself runs): both
  widen to fp32, sum the same products in the same order and round once,
  so they are held within one bf16 step (2^-8 relative) per value.
- ``unsharp_mask`` under each knob: bf16 inputs within one bf16 step per
  value (each bf16 operation rounds as JAX's does, its Python constants
  rounded to bf16 first); fp32 inputs at 1e-6, as
  ``test_torch_unsharp_route.py`` holds the fp32 function.
- ``_luma_hist`` of bf16 frames at 1e-6 (the bin position is computed in
  bf16 and widened, as JAX's; the sums run in another order).
- The whole ``restore_step`` under the knob (bf16 model dtype, a nearest-2x
  model so that a hard cut survives the model, a static pair of frames,
  CLAHE on the LR input and on the output): u8 within 2 levels on at most
  0.1% of the values (a value that the fp32 pre-stack moves across a bf16
  rounding boundary is one bf16 step off: up to one level at 1.0, and the
  u8 rounding adds one).
- The port's own bf16 post stack against its fp32 one, JAX's
  ``test_post_dt_bf16_matches_f32`` bar (``tests/test_sharding.py:76``):
  within 2 levels, and under 1% of the values more than 1 level apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_io import _tiny_models
from video_restore_tpu_torch.config import RestoreConfig as PConfig
from video_restore_tpu_torch.ops import _build, unsharp
from video_restore_tpu_torch.ops.conv import upsample_nearest
from video_restore_tpu_torch.ops.post import unsharp_mask
from video_restore_tpu_torch.ops.tiles import TileGrid as PGrid
from video_restore_tpu_torch.ops.tiles import tiled_apply
from video_restore_tpu_torch.parallel import dispatch as port

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF = torch.bfloat16
KNOBS = {"none": {}, "post_dt": {"VRT_POST_DT": "bf16"}, "post_bf16": {"VRT_POST_BF16": "1"}}


def _set(monkeypatch, knob):
    for name in ("VRT_POST_DT", "VRT_POST_BF16"):
        monkeypatch.delenv(name, raising=False)
    for name, value in KNOBS[knob].items():
        monkeypatch.setenv(name, value)


def _bf16_pair(shape, seed):
    """The same bf16 values for both packages (JAX's rounding of a seeded
    fp32 array, read back exactly)."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(BF)


def _within_one_bf16_step(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(ref))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert np.all(np.abs(got - ref) <= step), np.abs(got - ref).max()


# ---- K2's bf16 function ------------------------------------------------------


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize(
    "b,h,w,c,radius,thr",
    [
        (1, 24, 13, 3, 4, 0.0),   # W*C % 8 != 0
        (2, 32, 53, 3, 4, 0.02),  # B = 2, the threshold branch
        (1, 24, 3, 3, 4, 0.0),    # W < r
        (1, 24, 16, 1, 1, 0.02),  # C = 1 (the tile route's)
        (1, 32, 12, 4, 8, 0.0),   # C = 4, the Pallas kernel's largest radius
    ],
)
def test_kernel_function_bf16_matches_pallas(monkeypatch, knob, b, h, w, c, radius, thr):
    """``unsharp_fused_plain`` on bf16 is JAX's Pallas ``unsharp_fused`` on
    bf16: fp32 inside, one rounding. Neither reads ``VRT_POST_DT`` or
    ``VRT_POST_BF16``: on the card K2 ignores them, as the Pallas kernel
    does on the TPU."""
    from video_restore_tpu.ops.pallas_post import unsharp_fused as jax_unsharp

    _set(monkeypatch, knob)
    xj, xt = _bf16_pair((b, h, w, c), 100 * h + w + c)
    ref = jax_unsharp(xj, amount=0.3, sigma=1.5, radius=radius, threshold=thr,
                      block_h=8, interpret=True)
    assert ref.dtype == jnp.bfloat16
    got = unsharp.unsharp_fused_plain(xt, 0.3, 1.5, radius, thr)
    assert got.dtype == BF and got.shape == (b, h, w, c)
    _within_one_bf16_step(got, ref)
    monkeypatch.delenv("VRT_POST_DT", raising=False)
    monkeypatch.delenv("VRT_POST_BF16", raising=False)
    assert torch.equal(got, unsharp.unsharp_fused_plain(xt, 0.3, 1.5, radius, thr))


def test_kernel_function_fp32_is_unsharp_mask():
    x = torch.rand(2, 9, 13, 3, generator=torch.Generator().manual_seed(3))
    assert torch.equal(unsharp.unsharp_fused_plain(x, 0.3, 1.5, 4, 0.02),
                       unsharp_mask(x, 0.3, 1.5, 4, 0.02))


# ---- the XLA form, unsharp_mask, under each knob ---------------------------------


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("thr", [0.0, 0.02])
def test_unsharp_mask_matches_jax(monkeypatch, knob, dtype, thr):
    from video_restore_tpu.ops.post import unsharp_mask as jax_unsharp_mask

    _set(monkeypatch, knob)
    shape = (2, 17, 21, 3)
    if dtype == "bf16":
        xj, xt = _bf16_pair(shape, 7)
    else:
        x = np.random.default_rng(7).random(shape).astype(np.float32)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref = jax_unsharp_mask.__wrapped__(xj, amount=0.3, sigma=1.5, radius=4, threshold=thr)
    got = unsharp_mask(xt, 0.3, 1.5, 4, thr)
    assert got.dtype == xt.dtype
    if dtype == "bf16":
        _within_one_bf16_step(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_the_wrapper_on_the_cpu_is_the_jax_steps_form(monkeypatch, knob):
    """On the CPU ``unsharp_fused`` runs ``unsharp_mask``, as JAX's step
    does off the TPU (``dispatch.py:157-175``), knobs included; with both
    knobs unset that is K2's function. It launches nothing."""
    _set(monkeypatch, knob)
    _, xt = _bf16_pair((1, 9, 14, 3), 11)
    _build.reset_launches()
    got = unsharp.unsharp_fused(xt, 0.3, 1.5, 4)
    assert got.dtype == BF
    assert torch.equal(got, unsharp_mask(xt, 0.3, 1.5, 4))
    if knob == "none":
        assert torch.equal(got, unsharp.unsharp_fused_plain(xt, 0.3, 1.5, 4))
    assert _build.launches() == {}


def test_post_dt_moves_the_bf16_result(monkeypatch):
    """The two bf16 forms differ: ``VRT_POST_DT=bf16`` rounds the blur to
    bf16 before the high-pass, K2's function after it."""
    _, xt = _bf16_pair((1, 40, 48, 3), 5)
    _set(monkeypatch, "post_dt")
    xla = unsharp_mask(xt, 0.3, 1.5, 4)
    k2 = unsharp.unsharp_fused_plain(xt, 0.3, 1.5, 4)
    assert not torch.equal(xla, k2)
    assert (xla.float() - k2.float()).abs().max() <= 2.0**-8


# ---- the histogram ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (3, 1, 5, 3), (2, 2, 9, 40, 3)])
def test_luma_hist_bf16_matches_jax(shape):
    from video_restore_tpu.parallel.dispatch import _luma_hist as jax_hist

    xj, xt = _bf16_pair(shape, sum(shape))
    ref = np.asarray(jax_hist(xj))
    got = port._luma_hist(xt)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_luma_hist_bf16_rounds_the_position_in_bf16():
    """Bright bf16 frames (positions above 16, a step of 0.125): widening
    the luma before the position (the fp32 path's order) gives other
    weights; the port takes JAX's order."""
    from video_restore_tpu.parallel.dispatch import _luma_hist as jax_hist

    x = (0.55 + 0.45 * np.random.default_rng(1).random((1, 8, 8, 3))).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(BF)
    ref = np.asarray(jax_hist(xj))
    np.testing.assert_allclose(port._luma_hist(xt).numpy(), ref, rtol=1e-6, atol=1e-6)
    widened = port._luma_hist(xt.float())
    assert np.abs(widened.numpy() - ref).max() > 1e-3


# ---- tiled_apply -------------------------------------------------------------------


@pytest.mark.parametrize("tile", [0, 16])
@pytest.mark.parametrize("knob", ["none", "post_dt"])
def test_tiled_apply_dtype_matches_jax(monkeypatch, tile, knob):
    """Full frame under the knob returns the model's dtype; tiles blend in
    fp32 with or without it (JAX ``tiles.py:400-414``)."""
    from video_restore_tpu.ops.tiles import TileGrid, tiled_apply as jax_tiled

    _set(monkeypatch, knob)
    xj, xt = _bf16_pair((1, 24, 40, 3), 9)
    ref = jax_tiled(lambda t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2), xj,
                    TileGrid.build(24, 40, tile=tile, overlap=4, scale=2))
    got = tiled_apply(lambda t: upsample_nearest(t, 2), xt,
                      PGrid.build(24, 40, tile=tile, overlap=4, scale=2))
    want = BF if (tile == 0 and knob == "post_dt") else torch.float32
    assert got.dtype == want and str(ref.dtype) == {BF: "bfloat16", torch.float32: "float32"}[want]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)


# ---- the whole step ----------------------------------------------------------------


def _clip(tiny_frames):
    frames = tiny_frames.copy()
    frames[2] = frames[1]  # a static pair: the EMA blends at full weight
    frames[6:] = 255 - frames[6:]  # a hard cut between frames 5 and 6
    return frames


@pytest.mark.parametrize("clahe_lr", [True, False])
@pytest.mark.parametrize("yuv", [False, True])
def test_restore_step_post_dt_bf16_matches_jax(tiny_frames, monkeypatch, clahe_lr, yuv):
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    monkeypatch.setenv("VRT_POST_DT", "bf16")
    frames = _clip(tiny_frames)
    h, w = frames.shape[1:3]
    cfg_kw = dict(denoise=0.5, sharpen=0.3, color_enhance=True, clahe_lr=clahe_lr,
                  temporal=True, yuv420_out=yuv)
    jgrid = TileGrid.build(h, w, tile=0, overlap=0, scale=2)
    pgrid = PGrid.build(h, w, tile=0, overlap=0, scale=2)
    jcarry = {"frame": jnp.zeros((1, 2 * h, 2 * w, 3), jnp.uint8), "valid": jnp.zeros((1,), jnp.float32)}
    pcarry = {"frame": torch.zeros((1, 2 * h, 2 * w, 3), dtype=torch.uint8), "valid": torch.zeros(1)}
    for batch in (frames[:4], frames[4:]):
        ref, jcarry = restore_step(
            None, jnp.asarray(batch), jcarry,
            model_apply=lambda p, t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2),
            grid=jgrid, step_cfg=StepConfig(**cfg_kw), compute_dtype=jnp.bfloat16, n_shards=1,
        )
        got, pcarry = port.restore_step(
            torch.from_numpy(batch), pcarry, model_apply=lambda t: upsample_nearest(t, 2),
            grid=pgrid, step_cfg=port.StepConfig(**cfg_kw), compute_dtype=BF,
        )
        assert got.shape == ref.shape
        for a, b in ((got, ref), (pcarry["frame"], jcarry["frame"])):
            d = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
            assert d.max() <= 2, d.max()
            assert (d > 0).mean() <= 0.001, (d > 0).mean()
        np.testing.assert_array_equal(pcarry["valid"].numpy(), np.asarray(jcarry["valid"]))


def test_post_dt_bf16_matches_f32(tiny_frames, monkeypatch):
    """JAX's ``test_post_dt_bf16_matches_f32`` on the port: a bf16 model,
    full frame, eight frame shards; the knob moves the u8 output by at
    most 2 levels, under 1% of the values by more than 1."""
    _, pm = _tiny_models()
    h, w = tiny_frames.shape[1:3]
    grid = PGrid.build(h, w, 0, 4, 2)
    assert grid.n_tiles == 1
    cfg = PConfig(model_name="RealESRGAN_x4_v3", tile_size=0, tile_overlap=4, precision="bf16",
                  audio_copy=False, enhanced_mode=True, sharpen=0.3, color_enhance=True,
                  temporal=True)
    cpu = [torch.device("cpu")] * 8
    monkeypatch.delenv("VRT_POST_DT", raising=False)
    ref = port.ShardedUpscaler(pm, grid, cfg, cpu).process_batch(tiny_frames).numpy()
    monkeypatch.setenv("VRT_POST_DT", "bf16")
    got = port.ShardedUpscaler(pm, grid, cfg, cpu).process_batch(tiny_frames).numpy()
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 2, diff.max()
    assert (diff > 1).mean() < 0.01
    assert diff.max() > 0  # the knob reached the step

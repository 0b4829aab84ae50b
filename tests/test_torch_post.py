"""The port's post stack (bilateral, CLAHE, quantize_u8, the luma histogram)
against the JAX functions on the same numpy inputs, fp32 on both sides."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_restore_tpu_torch.ops import color as port_color
from video_restore_tpu_torch.ops import post as port_post
from video_restore_tpu_torch.parallel.dispatch import _luma_hist

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("sigma", [25.0, 50.0])
def test_bilateral_matches_jax(rng, sigma):
    """Same taps, weights and order: fp32 rounding only (1e-5)."""
    from video_restore_tpu.ops.post import bilateral_filter

    x = rng.random((2, 21, 30, 3)).astype(np.float32)
    ref = bilateral_filter(jnp.asarray(x), 5, sigma, sigma)
    got = port_post.bilateral_filter(torch.from_numpy(x), 5, sigma, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape", [(1, 48, 64), (2, 37, 53), (1, 64, 64), (1, 5, 3)]
)
def test_clahe_matches_jax(rng, shape):
    """Tile histograms, clipping, LUTs and the bilinear blend as the JAX
    CLAHE computes them (non-multiple frame sizes included). The CDF is a
    float prefix sum whose order may differ between XLA and torch, which
    can move a LUT entry by one level when it sits at a .5 boundary: the
    bar is 1/255 per pixel and a mean error far below it."""
    from video_restore_tpu.ops.post import clahe

    n, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1) * 0.4 + 0.3
    x = np.clip(base + rng.normal(0, 0.03, (n, h, w, 3)), 0, 1).astype(np.float32)
    ref = np.asarray(clahe(jnp.asarray(x), 2.0))
    got = port_post.clahe(torch.from_numpy(x), 2.0).numpy()
    err = np.abs(got - ref)
    assert err.max() <= 1.0 / 255 + 1e-6, err.max()
    assert err.mean() < 1e-4, err.mean()


def test_quantize_u8_matches_jax(rng):
    """Round half to even on both sides, and the ordered dither: exact."""
    from video_restore_tpu.ops.color import quantize_u8

    x = rng.random((2, 19, 27, 3)).astype(np.float32) * 1.2 - 0.1
    # exact .5 ties after scaling by 255 exercise half-to-even
    x[0, 0, :4, 0] = np.array([0.5, 1.5, 2.5, 254.5], np.float32) / 255.0
    for dither in (False, True):
        ref = np.asarray(quantize_u8(jnp.asarray(x), dither=dither))
        got = port_color.quantize_u8(torch.from_numpy(x), dither=dither)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_luma_hist_matches_jax(rng):
    """The port's two-bin scatter form == the JAX dense soft-binned form
    (same mass per bin, sums in another order: 1e-6)."""
    from video_restore_tpu.parallel.dispatch import _luma_hist as jax_hist

    x = rng.random((3, 17, 23, 3)).astype(np.float32) * 1.1 - 0.05
    ref = np.asarray(jax_hist(jnp.asarray(x)))
    got = _luma_hist(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_ycbcr_roundtrip_matches_jax(rng):
    from video_restore_tpu.ops.color import rgb_to_ycbcr, ycbcr_to_rgb

    x = rng.random((4, 5, 3)).astype(np.float32)
    ycc = port_color.rgb_to_ycbcr(torch.from_numpy(x))
    np.testing.assert_allclose(
        ycc.numpy(), np.asarray(rgb_to_ycbcr(jnp.asarray(x))), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        port_color.ycbcr_to_rgb(ycc).numpy(),
        np.asarray(ycbcr_to_rgb(jnp.asarray(ycc.numpy()))),
        rtol=1e-6, atol=1e-6,
    )

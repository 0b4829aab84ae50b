"""Image geometry without OpenCV: warps, resizes and the filters of the
face heuristic, as plain PyTorch on any device.

The JAX package does this work on the host with ``cv2`` (``ops/faces.py``,
``pipeline/runner.py::_resizer``); the card's machine has no OpenCV, so the
port keeps its own versions, each held on the CPU to the ``cv2`` call it
replaces (``tests/test_torch_outscale.py``, ``tests/test_torch_faces.py``):

- :func:`warp_affine`: ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT)``
  with OpenCV 5's float coordinates and float bilinear weights; within 1
  level on u8 (a few values in 10^4 round the other way), 4e-3 on float32
  images of 0..80.
- :func:`invert_affine`: ``cv2.invertAffineTransform``, in float64.
- :func:`resize_linear`: ``cv2.resize(INTER_LINEAR)`` on u8, half-pixel
  centres, cv2's 11-bit coefficients and its vector path's vertical
  rounding; the exact 2x downscale takes cv2's 2x2 area mean. Within 1
  level (~0.2% of values differ).
- :func:`resize_linear_aa`: the JAX package's own ``jax.image.resize(...,
  method="linear")`` on float images (fine-tuning's degradation,
  ``training/train.py::degrade_batch``): on a downscale a triangle kernel
  widened by the factor (antialias), weights renormalised at the borders,
  one weight matrix per axis as ``jax.image.scale_and_translate`` builds
  it; within 1e-6 (``tests/test_torch_train.py``).
- :func:`resize_lanczos4`: ``cv2.resize(INTER_LANCZOS4)`` on u8: cv2's
  8-tap coefficients (no antialias on a downscale), replicated borders,
  11-bit fixed point in both passes; equal byte for byte.
- :func:`bilateral_u8`: ``cv2.bilateralFilter`` on u8 RGB: circular window,
  L1 colour distance, ``BORDER_REFLECT_101``.
- :func:`gaussian_blur`: ``cv2.GaussianBlur(ksize=(0, 0))`` on float32:
  ``cvRound(sigma * 8 + 1) | 1`` taps, symmetric pair sums,
  ``BORDER_REFLECT_101``.

Images are (..., H, W, C) tensors; the warp and the filters take one
image, the resizes any leading axes. Integer work is done in int32 or
int64, so the results do not depend on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from video_restore_tpu_torch.utils.device import tf32

_RESIZE_COEF_SCALE = 2048  # cv2 INTER_RESIZE_COEF_SCALE (11 bits)


# ---------------------------------------------------------------------------
# affine warps
# ---------------------------------------------------------------------------


def _inverse64(m: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine map in float64, as cv2 computes it (also
    inside ``warpAffine``, which inverts the map it is given)."""
    a = np.asarray(m, np.float64).reshape(2, 3)
    d = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = a[1, 1] * d, a[0, 0] * d
    a12, a21 = -a[0, 1] * d, -a[1, 0] * d
    b1 = -a11 * a[0, 2] - a12 * a[1, 2]
    b2 = -a21 * a[0, 2] - a22 * a[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` of a float32 map: computed in float64,
    returned as float32."""
    return _inverse64(m).astype(np.float32)


def warp_affine(
    img: torch.Tensor,
    m: np.ndarray,
    dsize: Tuple[int, int],
    border_value: Sequence[float] = (0.0, 0.0, 0.0),
    origin: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """``cv2.warpAffine(img, m, dsize, INTER_LINEAR, BORDER_CONSTANT,
    border_value)``: dst(x, y) = img(m^-1 (x, y)), bilinear, samples
    outside the image taking ``border_value``.

    img: (H, W, C) uint8 or float32; m: the 2x3 map from img to dst (as cv2
    takes it); dsize: (width, height) of the output. ``origin`` (x0, y0)
    computes only the window of dst that starts there: the same values as
    the full warp's, cropped."""
    h_in, w_in, c = img.shape
    w, h = dsize
    x0, y0 = origin
    inv = _inverse64(m).tolist()
    dev = img.device
    xs = torch.arange(x0, x0 + w, dtype=torch.float64, device=dev)
    ys = torch.arange(y0, y0 + h, dtype=torch.float64, device=dev)
    sx = inv[0][0] * xs[None, :] + inv[0][1] * ys[:, None] + inv[0][2]
    sy = inv[1][0] * xs[None, :] + inv[1][1] * ys[:, None] + inv[1][2]
    fx, fy = torch.floor(sx), torch.floor(sy)
    a = (sx - fx).float()[..., None]
    b = (sy - fy).float()[..., None]
    ix, iy = fx.long(), fy.long()
    cval = _const(tuple(float(v) for v in border_value[:c]), dev)
    src = img.float()

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h_in) & (xx >= 0) & (xx < w_in)
        v = src[yy.clamp(0, h_in - 1), xx.clamp(0, w_in - 1)]
        return torch.where(ok[..., None], v, cval)

    out = (
        tap(iy, ix) * ((1 - a) * (1 - b))
        + tap(iy, ix + 1) * (a * (1 - b))
        + tap(iy + 1, ix) * ((1 - a) * b)
        + tap(iy + 1, ix + 1) * (a * b)
    )
    if img.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on a GPU through pinned memory and a
    ``non_blocking`` copy, so the host does not wait for the work queued
    before it (a copy from pageable memory would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=64)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small float32 constant on ``device``, copied there once."""
    return to_device(np.array(values, np.float32), device)


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------


def _lanczos4_coeffs(fx: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateLanczos4`` for each offset in ``fx`` (float32,
    [0, 1)): 8 taps at -3..4, each term in float64 cast to float32,
    normalised by their float32 sum taken in tap order; the identity below
    float32's epsilon."""
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45),
          (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    x = fx.astype(np.float64)
    y0 = -(x + 3) * math.pi * 0.25
    s0 = np.array([math.sin(v) for v in y0])  # libm's, as cv2's std::sin
    c0 = np.array([math.cos(v) for v in y0])
    c = np.zeros((len(x), 8), np.float32)
    total = np.zeros(len(x), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(8):
            y = -(x + 3 - i) * math.pi * 0.25
            c[:, i] = ((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)).astype(np.float32)
            total = (total + c[:, i]).astype(np.float32)
        c = (c * (np.float32(1.0) / total)[:, None]).astype(np.float32)
    ident = fx < np.finfo(np.float32).eps
    c[ident] = 0.0
    c[ident, 3] = 1.0
    return c


@functools.lru_cache(maxsize=64)
def _axis_taps(n_in: int, n_out: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """Source indices (n_out, k) and 11-bit coefficients (n_out, k) of one
    axis of ``cv2.resize``: fx = (d + 0.5) * scale - 0.5 in float32, taps
    clamped to the axis (replicated border)."""
    scale = 1.0 / (n_out / n_in)  # cv2: 1 / inv_scale, both float64
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(f)
    f = (f - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    if kind == "lanczos4":
        coef = _lanczos4_coeffs(f)
        taps = sx[:, None] + np.arange(-3, 5)
    else:
        low, high = sx < 0, sx >= n_in - 1
        f[low | high] = 0.0
        sx = np.where(low, 0, np.where(high, n_in - 1, sx))
        coef = np.stack([np.float32(1.0) - f, f], 1)
        taps = sx[:, None] + np.arange(2)
    icoef = np.clip(np.rint(coef * np.float32(_RESIZE_COEF_SCALE)), -32768, 32767)
    return np.clip(taps, 0, n_in - 1), icoef.astype(np.int64)


@functools.lru_cache(maxsize=64)
def _device_taps(n_in: int, n_out: int, kind: str, device: torch.device):
    """:func:`_axis_taps` as tensors on ``device``: one copy per geometry, so
    a resize in a loop makes no host-to-device copy."""
    idx, coef = _axis_taps(n_in, n_out, kind)
    return to_device(idx.T, device), to_device(coef.T, device)


def _hpass(x: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, dtype) -> torch.Tensor:
    """Horizontal pass: (..., H, W, C) integers -> (..., H, W_out, C) sums
    of taps x coefficients in ``dtype``."""
    out = None
    for k in range(idx.shape[0]):
        t = x.index_select(-2, idx[k]).to(dtype) * coef[k].to(dtype)[:, None]
        out = t if out is None else out + t
    return out


def resize_lanczos4(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=INTER_LANCZOS4)`` on uint8
    (..., H, W, C): the horizontal pass in int32, the vertical in int64,
    ``(sum + 2^21) >> 22`` and saturation, as cv2's fixed-point path."""
    w, h = dsize
    h_in, w_in = img.shape[-3], img.shape[-2]
    if (w, h) == (w_in, h_in):
        return img
    ix, cx = _device_taps(w_in, w, "lanczos4", img.device)
    iy, cy = _device_taps(h_in, h, "lanczos4", img.device)
    rows = _hpass(img, ix, cx, torch.int32)  # |sum| < 2^21
    acc = None
    for k in range(iy.shape[0]):
        t = rows.index_select(-3, iy[k]).long() * cy[k][:, None, None]
        acc = t if acc is None else acc + t
    return ((acc + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)


def resize_linear(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=INTER_LINEAR)`` on uint8
    (..., H, W, C): half-pixel centres clamped at the edges, 11-bit
    coefficients, the horizontal pass in integers and the vertical as
    cv2's vector path rounds it, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) *
    b1 >> 16) + 2 >> 2``; an exact 2x downscale is cv2's 2x2 area mean."""
    w, h = dsize
    h_in, w_in = img.shape[-3], img.shape[-2]
    if (w, h) == (w_in, h_in):
        return img
    if (w_in, h_in) == (2 * w, 2 * h):
        x = img.to(torch.int32)
        s = x[..., 0::2, 0::2, :] + x[..., 0::2, 1::2, :] + x[..., 1::2, 0::2, :] + x[..., 1::2, 1::2, :]
        return ((s + 2) >> 2).to(torch.uint8)
    ix, cx = _device_taps(w_in, w, "linear", img.device)
    iy, cy = _device_taps(h_in, h, "linear", img.device)
    rows = _hpass(img, ix, cx, torch.int32)  # <= 255 * 2048
    acc = None
    for k in range(2):
        t = ((rows.index_select(-3, iy[k]) >> 4) * cy[k].int()[:, None, None]) >> 16
        acc = t if acc is None else acc + t
    return ((acc + 2) >> 2).clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _triangle_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) float32 weights of one axis of ``jax.image.resize(
    method="linear", antialias=True)`` (``compute_weight_mat`` of
    ``jax/_src/image/scale.py``), in its float32 arithmetic: sample
    positions ``(j + 0.5) / scale - 0.5``, a triangle of half-width
    ``max(1 / scale, 1)``, each column divided by its sum (zero where the sum
    is below 1000 eps), zero where a sample falls outside the input."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _device_triangle(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """:func:`_triangle_matrix` on ``device``, copied there once."""
    return to_device(_triangle_matrix(n_in, n_out), device)


def resize_linear_aa(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, (N, h, w, C), method="linear")`` on float
    (N, H, W, C): the per-axis triangle weights of
    :func:`_triangle_matrix` applied with two fp32 ``einsum`` (TF32 off, as
    JAX's ``Precision.HIGHEST``); an axis whose size does not change is left
    alone, as JAX skips it. Not ``F.interpolate(antialias=True)``, whose
    border weights are PIL's."""
    h, w = size
    x = img.float()
    with tf32(False):
        if h != x.shape[1]:
            wy = _device_triangle(x.shape[1], h, x.device)
            x = torch.einsum("nhwc,hi->niwc", x, wy)
        if w != x.shape[2]:
            wx = _device_triangle(x.shape[2], w, x.device)
            x = torch.einsum("niwc,wj->nijc", x, wx)
    return x


# ---------------------------------------------------------------------------
# filters of the face heuristic
# ---------------------------------------------------------------------------


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by r on both sides with
    ``BORDER_REFLECT_101`` (cv2's default border; ``gfedcb|abcdefgh|gfedcba``)."""
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    k = torch.remainder(i, period)
    return torch.where(k < n, k, period - k)


def bilateral_u8(
    img: torch.Tensor, d: int = 7, sigma_color: float = 30.0, sigma_space: float = 30.0
) -> torch.Tensor:
    """``cv2.bilateralFilter(img, d, sigma_color, sigma_space)`` on a uint8
    (H, W, 3) image: the circular window of radius d // 2 in cv2's order,
    float32 weights from cv2's tables (space: exp(r^2 * -0.5 / s^2) with
    r = sqrt(i^2 + j^2); colour: exp(t^2 * -0.5 / s^2) of the L1 distance
    t over channels), float32 sums, ``cvRound(sum / wsum)``,
    ``BORDER_REFLECT_101``."""
    h, w, _ = img.shape
    radius = max(d // 2, 1)
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    color_w = _const(
        tuple(np.exp(np.arange(256 * 3, dtype=np.float64) ** 2 * gc).astype(np.float32).tolist()),
        img.device,
    )
    rows = _reflect101(h, radius, img.device)
    cols = _reflect101(w, radius, img.device)
    xp = img.long()[rows][:, cols]
    x0 = img.long()
    num = torch.zeros(h, w, 3, dtype=torch.float32, device=img.device)
    den = torch.zeros(h, w, 1, dtype=torch.float32, device=img.device)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(float(i * i) + float(j * j))
            if r > radius:
                continue
            sw = float(np.float32(math.exp(r * r * gs)))
            s = xp[radius + i : radius + i + h, radius + j : radius + j + w]
            t = (s - x0).abs().sum(-1, keepdim=True)
            wgt = color_w[t] * sw
            num = num + s.float() * wgt
            den = den + wgt
    return torch.round(num * (1.0 / den)).clamp(0, 255).to(torch.uint8)


def gaussian_kernel_cv(sigma: float) -> Tuple[int, np.ndarray]:
    """cv2's Gaussian for a float32 image with ksize (0, 0): n =
    ``cvRound(sigma * 8 + 1) | 1`` taps, each ``exp(-x^2 / 2 sigma^2)`` cast
    to float32, normalised by their float64 sum."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    k = (t.astype(np.float64) * (1.0 / t.astype(np.float64).sum())).astype(np.float32)
    return n, k


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` on a float32 (H, W, C)
    image: the row pass, then the column pass, each as cv2's symmetric
    filter sums it (the centre tap, then k_i * (s_-i + s_i)), edges
    ``BORDER_REFLECT_101``."""
    n, k = gaussian_kernel_cv(sigma)
    r = n // 2
    h, w, _ = img.shape
    x = img.float()
    xp = x[:, _reflect101(w, r, img.device)]
    out = xp[:, r : r + w] * float(k[r])
    for i in range(1, r + 1):
        out = out + (xp[:, r - i : r - i + w] + xp[:, r + i : r + i + w]) * float(k[r + i])
    yp = out[_reflect101(h, r, img.device)]
    res = yp[r : r + h] * float(k[r])
    for i in range(1, r + 1):
        res = res + (yp[r - i : r - i + h] + yp[r + i : r + i + h]) * float(k[r + i])
    return res

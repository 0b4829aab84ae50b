"""Enhanced post-processing stack: the plain PyTorch versions.

Port of ``video_restore_tpu/ops/post.py``: ``bilateral_filter`` (cv2
semantics, ``post.py:39-96``), ``clahe`` (``:97-217``),
``_gaussian_kernel1d``, ``gaussian_blur`` and ``unsharp_mask`` (the plain
version of kernel K2, ``ops/unsharp.py``). Same operation order as the JAX
functions, so fp32 results agree to rounding. All functions take float
tensors in [0, 1], NHWC (leading batch axis).

``unsharp_mask`` reads two of the JAX knobs at call time, as JAX's does
(``post.py:285-303``): ``VRT_POST_DT=bf16`` keeps a bf16 input in bf16
(the blur computed in fp32 and rounded to bf16, the high-pass and the add
in bf16), and ``VRT_POST_BF16=1`` blurs the fp32 input rounded to bf16.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from video_restore_tpu_torch.ops.color import rgb_to_ycbcr, weak, ycbcr_to_rgb


def _bilateral_offsets(d: int) -> Tuple[Tuple[int, int, float], ...]:
    """cv2-compatible circular window: taps with r <= radius."""
    radius = d // 2
    taps = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 <= radius * radius:
                taps.append((dy, dx, float(r2)))
    return tuple(taps)


def _edge_pad_hw(x: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes (``jnp.pad(mode="edge")``)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-ry, h + ry, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-rx, w + rx, device=x.device).clamp(0, w - 1)
    return x[..., rows, :][..., cols]


def bilateral_filter(
    x: torch.Tensor,
    d: int = 5,
    sigma_color: float = 25.0,
    sigma_space: float = 25.0,
) -> torch.Tensor:
    """Edge-preserving bilateral denoise, cv2.bilateralFilter semantics.

    x: (..., H, W, C) float in [0, 1]. Colour distances are the L1 sum over
    channels on the 0..255 scale; frame edges replicate."""
    xf = torch.movedim(x.float(), -1, -3)  # (..., C, H, W)
    gauss_color = -0.5 / (sigma_color * sigma_color)
    gauss_space = -0.5 / (sigma_space * sigma_space)
    radius = d // 2
    xp = _edge_pad_hw(xf, radius, radius)
    h, w = x.shape[-3], x.shape[-2]
    num = torch.zeros_like(xf)
    den = torch.zeros(xf.shape[:-3] + (1, h, w), device=x.device)
    for dy, dx, r2 in _bilateral_offsets(d):
        sl = xp[
            ...,
            radius + dy : radius + dy + h,
            radius + dx : radius + dx + w,
        ]
        cdist = torch.abs(sl - xf).sum(dim=-3, keepdim=True) * 255.0
        wgt = torch.exp(cdist * cdist * gauss_color + r2 * gauss_space)
        num = num + wgt * sl
        den = den + wgt
    return torch.movedim(num / den, -3, -1).to(x.dtype)


def _reflect_index(n: int, total: int, device) -> torch.Tensor:
    """Indices of ``np.pad(mode="reflect")`` extending an axis of length n
    to ``total`` at the end, for any pad length (repeated reflection)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    k = i % (2 * (n - 1))
    return torch.where(k < n, k, 2 * (n - 1) - k)


def _clahe_luma(
    y: torch.Tensor,
    clip_limit: float,
    grid: Tuple[int, int] = (8, 8),
    bins: int = 256,
) -> torch.Tensor:
    """CLAHE on luma planes (N, H, W) in [0, 1]: tile histograms -> clip
    at ``clip_limit * tile_area / bins`` -> equal redistribution -> CDF LUT
    -> bilinear blend of the 4 surrounding tile LUTs per pixel (tile
    centres at (t + 0.5) * size, clamped at the borders)."""
    n, h, w = y.shape
    gy, gx = grid
    th, tw = -(-h // gy), -(-w // gx)
    rows = _reflect_index(h, th * gy, y.device)
    cols = _reflect_index(w, tw * gx, y.device)
    yp = y[:, rows][:, :, cols]
    q = torch.clamp(torch.round(yp * (bins - 1)), 0, bins - 1).long()

    tile_area = th * tw
    qt = (
        q.reshape(n, gy, th, gx, tw)
        .permute(0, 1, 3, 2, 4)
        .reshape(n, gy * gx, tile_area)
    )
    hist = torch.zeros(n, gy * gx, bins, device=y.device)
    hist.scatter_add_(2, qt, torch.ones_like(qt, dtype=torch.float32))

    limit = torch.clamp(
        torch.tensor(clip_limit, dtype=torch.float32) * tile_area / bins,
        min=1.0,
    ).to(y.device)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=2, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / bins
    cdf = torch.cumsum(hist, dim=2)
    lut = torch.round(cdf * ((bins - 1) / tile_area))  # (N, T, bins)

    # the 4 surrounding tiles of each pixel: band index (i + centre offset)
    # // tile size, as the JAX band-aligned apply computes it
    pt, pleft = (th + 1) // 2, (tw + 1) // 2
    band_y = (torch.arange(h, device=y.device) + pt) // th
    band_x = (torch.arange(w, device=y.device) + pleft) // tw
    y0b = torch.clamp(band_y - 1, 0, gy - 1)[:, None]
    y1b = torch.clamp(band_y, 0, gy - 1)[:, None]
    x0b = torch.clamp(band_x - 1, 0, gx - 1)[None, :]
    x1b = torch.clamp(band_x, 0, gx - 1)[None, :]
    qf = q[:, :h, :w]
    lut_flat = lut.reshape(n, gy * gx * bins)

    def lookup(ty, tx):
        idx = ((ty * gx + tx) * bins)[None] + qf
        return torch.gather(lut_flat, 1, idx.reshape(n, -1)).reshape(n, h, w)

    v0, v1 = lookup(y0b, x0b), lookup(y0b, x1b)
    v2, v3 = lookup(y1b, x0b), lookup(y1b, x1b)

    fy = (torch.arange(h, device=y.device) + 0.5) / th - 0.5
    fx = (torch.arange(w, device=y.device) + 0.5) / tw - 0.5
    yy0 = torch.clamp(torch.floor(fy), 0, gy - 1)
    xx0 = torch.clamp(torch.floor(fx), 0, gx - 1)
    wy = torch.clamp(fy - yy0, 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - xx0, 0.0, 1.0)[None, :]
    out = (
        v0 * (1 - wy) * (1 - wx)
        + v1 * (1 - wy) * wx
        + v2 * wy * (1 - wx)
        + v3 * wy * wx
    )
    return (out / (bins - 1)).to(y.dtype)


def clahe(
    rgb: torch.Tensor, clip_limit: float = 2.0, grid: Tuple[int, int] = (8, 8)
) -> torch.Tensor:
    """CLAHE colour correction on BT.601 luma; chroma preserved.

    rgb: (N, H, W, 3) or (H, W, 3) in [0, 1]."""
    if rgb.dim() == 3:
        return clahe(rgb[None], clip_limit, grid)[0]
    ycc = rgb_to_ycbcr(rgb.float())
    y_eq = _clahe_luma(ycc[..., 0], clip_limit, grid)
    out = ycbcr_to_rgb(torch.stack([y_eq, ycc[..., 1], ycc[..., 2]], -1))
    return torch.clamp(out, 0.0, 1.0).to(rgb.dtype)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(
    x: torch.Tensor, sigma: float = 1.0, radius: int = 3
) -> torch.Tensor:
    """Separable Gaussian blur, NHWC, edge padding: vertical pass, then
    horizontal, each summing the rounded tap products in tap order."""
    k = [float(v) for v in _gaussian_kernel1d(sigma, radius)]
    b, h, w, c = x.shape
    xf = x.float()
    rows = torch.arange(-radius, h + radius, device=x.device).clamp(0, h - 1)
    xp = xf[:, rows]
    out = None
    for i, ki in enumerate(k):
        t = xp[:, i : i + h] * ki
        out = t if out is None else out + t
    cols = torch.arange(-radius, w + radius, device=x.device).clamp(0, w - 1)
    outp = out[:, :, cols]
    res = None
    for i, ki in enumerate(k):
        t = outp[:, :, i : i + w] * ki
        res = t if res is None else res + t
    return res.to(x.dtype)


def _unsharp_f32(
    xf: torch.Tensor,
    amount: float,
    sigma: float,
    radius: int,
    threshold: float,
    blur_bf16: bool = False,
) -> torch.Tensor:
    """``clip(xf + amount * (xf - blur), 0, 1)`` on fp32 ``xf``, with the
    optional threshold; ``blur_bf16``: the blur of ``xf`` rounded to bf16,
    widened back (``VRT_POST_BF16=1``)."""
    src = xf.to(torch.bfloat16) if blur_bf16 else xf
    hp = xf - gaussian_blur(src, sigma, radius).float()
    if threshold > 0:
        hp = torch.where(torch.abs(hp) >= threshold, hp, 0.0)
    return torch.clamp(xf + amount * hp, 0.0, 1.0)


def unsharp_mask(
    x: torch.Tensor,
    amount: float = 0.5,
    sigma: float = 1.0,
    radius: int = 3,
    threshold: float = 0.0,
) -> torch.Tensor:
    """``clip(x + amount * (x - blur(x)), 0, 1)`` in fp32, with an optional
    threshold below which the highpass is dropped; in x's dtype.

    Under ``VRT_POST_DT=bf16`` a bf16 x stays in bf16: the blur is rounded
    to bf16, and the highpass, the threshold test and the add are bf16
    operations (``amount`` and ``threshold`` rounded to bf16 first, as
    JAX's weak typing does). Under ``VRT_POST_BF16=1`` the blur runs on x
    rounded to bf16. Both are read at call time."""
    if os.environ.get("VRT_POST_DT") == "bf16" and x.dtype == torch.bfloat16:
        hp = x - gaussian_blur(x, sigma, radius)
        if threshold > 0:
            hp = torch.where(torch.abs(hp) >= threshold, hp, 0.0)
        return torch.clamp(x + weak(amount, x.dtype) * hp, 0.0, 1.0)
    blur_bf16 = os.environ.get("VRT_POST_BF16") == "1"
    return _unsharp_f32(x.float(), amount, sigma, radius, threshold, blur_bf16).to(x.dtype)

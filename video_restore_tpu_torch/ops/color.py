"""Colourspace conversions and 8-bit quantization, NHWC float in [0, 1].

Port of ``video_restore_tpu/ops/color.py`` (``rgb_to_ycbcr``,
``ycbcr_to_rgb``, ``quantize_u8`` with its ordered dither). Rounding is
half to even in both frameworks (``jnp.round``, ``torch.round``).

On a bf16 tensor each operation rounds to bf16, as JAX's does, and a
Python constant takes the tensor's dtype first (JAX's weak typing, which
``weak`` reproduces: PyTorch would otherwise multiply by the constant in
fp32 before it rounds).
"""

from __future__ import annotations

import numpy as np
import torch


def weak(v: float, dtype: torch.dtype) -> float:
    """The Python scalar ``v`` as JAX's weak typing makes it an operand of
    a ``dtype`` array: rounded to ``dtype``. fp32 is returned as is (its
    op math already rounds the scalar to fp32)."""
    return v if dtype == torch.float32 else float(torch.tensor(v, dtype=dtype))


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """Full-range BT.601 RGB -> YCbCr, channels-last. Cb/Cr centred on 0.5."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 + (b - y) * (0.5 / (1.0 - 0.114))
    cr = 0.5 + (r - y) * (0.5 / (1.0 - 0.299))
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    r = y + (cr - 0.5) * (1.0 - 0.299) / 0.5
    b = y + (cb - 0.5) * (1.0 - 0.114) / 0.5
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return torch.stack([r, g, b], dim=-1)


def _bayer8() -> np.ndarray:
    """8x8 ordered-dither (Bayer) thresholds in [0, 1)."""
    b = np.array([[0, 2], [3, 1]], np.float32)
    for _ in range(2):  # 2x2 -> 4x4 -> 8x8
        b = np.block([[4 * b, 4 * b + 2], [4 * b + 3, 4 * b + 1]])
    return ((b + 0.5) / b.size).astype(np.float32)


def dither_offsets(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w) tiled Bayer thresholds for ``floor(x*255 + t)`` quantization."""
    b = torch.from_numpy(_bayer8()).to(device)
    return b.repeat(-(-h // 8), -(-w // 8))[:h, :w]


def quantize_u8(x: torch.Tensor, dither: bool = False) -> torch.Tensor:
    """[0, 1] float -> uint8; ordered-dithered when ``dither``."""
    y = x * 255.0
    if dither:
        h, w = x.shape[-3], x.shape[-2]
        y = torch.floor(y + dither_offsets(h, w, x.device)[..., None])
    else:
        y = torch.round(y)
    return torch.clamp(y, 0, 255).to(torch.uint8)


def rgb_to_yuv420_planar(rgb: torch.Tensor, dither: bool = False) -> torch.Tensor:
    """(B, H, W, 3) float RGB in [0, 1] -> (B, H*3//2, W) uint8 planar I420
    (studio-range BT.601, 2x2-averaged chroma): the byte layout of a y4m
    frame and of ffmpeg's ``-pix_fmt yuv420p`` rawvideo input.

    Port of ``ops/color.py:72-110`` of the JAX package, in its operation
    order: luma and chroma differences in the input's dtype (fp32 on the
    default path, bf16 under ``VRT_POST_DT=bf16``), the Bayer-dithered floor or
    the half-to-even round for Y, chroma averaged over rows and then
    columns, each plane clipped before the cast. Requires H % 4 == 0 and
    W % 2 == 0 (the H/2 chroma rows are packed pairwise into full-width
    rows)."""
    b_, h, w, _ = rgb.shape
    if h % 4 or w % 2:
        raise ValueError(f"yuv420 packing needs H%4==0, W%2==0 (got {h}x{w})")
    dt = rgb.dtype
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = weak(0.299, dt) * r + weak(0.587, dt) * g + weak(0.114, dt) * b
    u = (b - y) * weak(1.0 / (2.0 * (1.0 - 0.114)), dt)
    v = (r - y) * weak(1.0 / (2.0 * (1.0 - 0.299)), dt)
    if dither:
        yq = torch.floor(16.0 + 219.0 * y + dither_offsets(h, w, rgb.device))
    else:
        yq = torch.round(16.0 + 219.0 * y)
    yq = torch.clamp(yq, 16, 235).to(torch.uint8)

    def pool2(p):
        rows = (p[:, 0::2, :] + p[:, 1::2, :]) * 0.5
        return (rows[:, :, 0::2] + rows[:, :, 1::2]) * 0.5

    uq = torch.clamp(torch.round(128.0 + 224.0 * pool2(u)), 16, 240).to(torch.uint8)
    vq = torch.clamp(torch.round(128.0 + 224.0 * pool2(v)), 16, 240).to(torch.uint8)
    # planar packing: Y rows, then U ((H/2, W/2) -> (H/4, W)), then V
    return torch.cat([yq, uq.reshape(b_, h // 4, w), vq.reshape(b_, h // 4, w)], dim=1)

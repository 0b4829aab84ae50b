"""Colourspace conversions and 8-bit quantization, NHWC float in [0, 1].

Port of ``video_restore_tpu/ops/color.py`` (``rgb_to_ycbcr``,
``ycbcr_to_rgb``, ``quantize_u8`` with its ordered dither). Rounding is
half to even in both frameworks (``jnp.round``, ``torch.round``).
"""

from __future__ import annotations

import numpy as np
import torch


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

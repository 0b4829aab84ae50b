"""Plain reference of the video I/O's colour: the y4m 4:2:0 decode to RGB
and the planar I420 encode, studio-range BT.601, in NumPy and PyTorch.

Written from the JAX package's semantics: the decode is its NumPy float
path (nearest chroma upsampling, ``(Y - 16) / 219``, ``(C - 128) / 224``,
rounded half to even to uint8); the encode is its device I420 conversion
(luma and chroma differences in float32, chroma averaged over 2x2 after the
difference, each plane rounded half to even and clipped).
"""

from __future__ import annotations

import numpy as np
import torch

KR, KG, KB = 0.299, 0.587, 0.114


def decode_420(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W) Y and (H/2, W/2) U, V uint8 -> (H, W, 3) uint8 RGB."""
    uu = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)
    vv = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)
    yf = (y.astype(np.float32) - 16.0) / 219.0
    uf = (uu.astype(np.float32) - 128.0) / 224.0
    vf = (vv.astype(np.float32) - 128.0) / 224.0
    r = yf + 2.0 * (1.0 - KR) * vf
    b = yf + 2.0 * (1.0 - KB) * uf
    g = (yf - KR * r - KB * b) / KG
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)


def luma_studio(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float RGB in [0, 1] -> unrounded studio-range luma."""
    return 16.0 + 219.0 * (KR * rgb[..., 0] + KG * rgb[..., 1] + KB * rgb[..., 2])


def encode_i420(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float32 RGB, clipped to [0, 1] here -> (H*3//2, W) uint8:
    the Y plane, then U and V, each (H/2, W/2) packed into H/4 rows."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    h, w, _ = rgb.shape
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    u = (b - y) * (1.0 / (2.0 * (1.0 - KB)))
    v = (r - y) * (1.0 / (2.0 * (1.0 - KR)))
    yq = torch.clamp(torch.round(16.0 + 219.0 * y), 16, 235)

    def pool(p):
        rows = (p[0::2, :] + p[1::2, :]) * 0.5
        return (rows[:, 0::2] + rows[:, 1::2]) * 0.5

    uq = torch.clamp(torch.round(128.0 + 224.0 * pool(u)), 16, 240)
    vq = torch.clamp(torch.round(128.0 + 224.0 * pool(v)), 16, 240)
    return torch.cat([yq, uq.reshape(h // 4, w), vq.reshape(h // 4, w)]).to(torch.uint8)

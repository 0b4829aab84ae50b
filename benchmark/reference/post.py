"""Plain reference of the restore step's post stack, on one frame: float32
(H, W, 3) RGB tensors in [0, 1], written in PyTorch from the JAX package's
semantics (``ops/post.py``, ``parallel/dispatch.py``):

- ``bilateral``: cv2.bilateralFilter's (d 5: the 13 taps within radius 2),
  colour distance the L1 sum over channels on the 0..255 scale, edges
  replicated;
- ``clahe``: CLAHE on BT.601 full-range luma, chroma kept: an 8 x 8 grid of
  256-bin tile histograms over the reflect-padded frame, clipped at
  ``clip * area / 256`` (at least 1) with the excess spread evenly, rounded
  CDF lookup tables, and per pixel the bilinear blend of its four nearest
  tiles (centres at (t + 0.5) * size, clamped at the borders);
- ``unsharp``: ``clip(x + amount * (x - blur), 0, 1)``, the blur separable
  Gaussian taps (vertical, then horizontal, edges replicated);
- ``luma_hist``: the 32-bin soft luma histogram, each pixel's mass split
  linearly between its two nearest bins;
- ``ema``: the temporal EMA of one frame against the previous output
  (uint8), reset at a scene cut.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

KR, KG, KB = 0.299, 0.587, 0.114
HIST_BINS = 32


def _pad_edge(x: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Edge-replicate pad of (H, W, C) by ry rows and rx columns."""
    h, w = x.shape[:2]
    rows = torch.clamp(torch.arange(-ry, h + ry, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-rx, w + rx, device=x.device), 0, w - 1)
    return x[rows][:, cols]


def bilateral(x: torch.Tensor, d: int, sigma_color: float, sigma_space: float) -> torch.Tensor:
    r = d // 2
    h, w = x.shape[:2]
    xp = _pad_edge(x, r, r)
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    num = torch.zeros_like(x)
    den = torch.zeros(h, w, 1, device=x.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            r2 = dy * dy + dx * dx
            if r2 > r * r:
                continue
            nb = xp[r + dy : r + dy + h, r + dx : r + dx + w]
            dist = torch.abs(nb - x).sum(dim=-1, keepdim=True) * 255.0
            wt = torch.exp(dist * dist * gc + r2 * gs)
            num = num + wt * nb
            den = den + wt
    return num / den


def _reflect(n: int, total: int, device) -> torch.Tensor:
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    k = i % (2 * (n - 1))
    return torch.where(k < n, k, 2 * (n - 1) - k)


def _clahe_luma(y: torch.Tensor, clip: float, grid: int = 8, bins: int = 256) -> torch.Tensor:
    h, w = y.shape
    th, tw = -(-h // grid), -(-w // grid)
    yp = y[_reflect(h, th * grid, y.device)][:, _reflect(w, tw * grid, y.device)]
    q = torch.clamp(torch.round(yp * (bins - 1)), 0, bins - 1).long()
    area = th * tw
    tiles = q.reshape(grid, th, grid, tw).permute(0, 2, 1, 3).reshape(grid * grid, area)
    hist = torch.zeros(grid * grid, bins, device=y.device)
    hist.scatter_add_(1, tiles, torch.ones(tiles.shape, device=y.device))
    limit = max(float(torch.tensor(clip, dtype=torch.float32)) * area / bins, 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / bins
    lut = torch.round(torch.cumsum(hist, dim=1) * ((bins - 1) / area)).reshape(-1)

    by = (torch.arange(h, device=y.device) + (th + 1) // 2) // th
    bx = (torch.arange(w, device=y.device) + (tw + 1) // 2) // tw
    ty0 = torch.clamp(by - 1, 0, grid - 1)[:, None]
    ty1 = torch.clamp(by, 0, grid - 1)[:, None]
    tx0 = torch.clamp(bx - 1, 0, grid - 1)[None, :]
    tx1 = torch.clamp(bx, 0, grid - 1)[None, :]
    qf = q[:h, :w]

    def at(ty, tx):
        return lut[(ty * grid + tx) * bins + qf]

    fy = (torch.arange(h, device=y.device) + 0.5) / th - 0.5
    fx = (torch.arange(w, device=y.device) + 0.5) / tw - 0.5
    wy = torch.clamp(fy - torch.clamp(torch.floor(fy), 0, grid - 1), 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - torch.clamp(torch.floor(fx), 0, grid - 1), 0.0, 1.0)[None, :]
    out = (
        at(ty0, tx0) * (1 - wy) * (1 - wx)
        + at(ty0, tx1) * (1 - wy) * wx
        + at(ty1, tx0) * wy * (1 - wx)
        + at(ty1, tx1) * wy * wx
    )
    return out / (bins - 1)


def clahe(rgb: torch.Tensor, clip: float) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 + (b - y) * (0.5 / (1.0 - KB))
    cr = 0.5 + (r - y) * (0.5 / (1.0 - KR))
    y = _clahe_luma(y, clip)
    r = y + (cr - 0.5) * (1.0 - KR) / 0.5
    b = y + (cb - 0.5) * (1.0 - KB) / 0.5
    g = (y - KR * r - KB * b) / KG
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def _gauss_taps(sigma: float, radius: int):
    k = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(k)
    return [float(torch.tensor(v / s, dtype=torch.float32)) for v in k]


def unsharp(x: torch.Tensor, amount: float, sigma: float, radius: int) -> torch.Tensor:
    taps = _gauss_taps(sigma, radius)
    h, w = x.shape[:2]
    xp = _pad_edge(x, radius, 0)
    v = None
    for i, k in enumerate(taps):
        t = xp[i : i + h] * k
        v = t if v is None else v + t
    vp = _pad_edge(v, 0, radius)
    blur = None
    for i, k in enumerate(taps):
        t = vp[:, i : i + w] * k
        blur = t if blur is None else blur + t
    return torch.clamp(x + amount * (x - blur), 0.0, 1.0)


def luma_hist(x: torch.Tensor) -> torch.Tensor:
    luma = KR * x[..., 0] + KG * x[..., 1] + KB * x[..., 2]
    pos = torch.clamp(torch.clamp(luma, 0.0, 1.0) * HIST_BINS - 0.5, 0.0, HIST_BINS - 1.0).reshape(-1)
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.long()
    hist = torch.zeros(HIST_BINS, device=x.device)
    hist.scatter_add_(0, lo, 1.0 - frac)
    hist.scatter_add_(0, torch.clamp(lo + 1, max=HIST_BINS - 1), torch.where(lo + 1 < HIST_BINS, frac, 0.0))
    return hist / pos.numel()


def cut_test(y: torch.Tensor, prev_u8: torch.Tensor, p: Dict) -> Tuple[bool, float, float]:
    """The scene-cut test of frame y against the previous output (uint8):
    (cut, mean delta, histogram distance)."""
    prev = prev_u8.float() * (1.0 / 255.0)
    mdelta = float(torch.abs(y - prev).mean(dim=-1).mean())
    tvd = float(0.5 * torch.abs(luma_hist(y) - luma_hist(prev)).sum())
    thr, hist_thr = p["scene_cut_thresh"], p["scene_cut_hist"]
    return (mdelta > thr and tvd > hist_thr) or mdelta > 2.5 * thr, mdelta, tvd


def ema(y: torch.Tensor, prev_u8: torch.Tensor, p: Dict) -> torch.Tensor:
    """Frame y blended with the previous output per pixel, weight
    ``strength * exp(-|delta| / 0.05)``, where no scene cut."""
    cut, _, _ = cut_test(y, prev_u8, p)
    if cut:
        return y
    prev = prev_u8.float() * (1.0 / 255.0)
    diff = torch.abs(y - prev).mean(dim=-1, keepdim=True)
    wt = p["temporal_strength"] * torch.exp(-diff * (1.0 / 0.05))
    return (1.0 - wt) * y + wt * prev


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)

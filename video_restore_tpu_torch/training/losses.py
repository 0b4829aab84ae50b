"""Pixel losses and image-quality metrics (PSNR/SSIM) on the device.

Port of ``video_restore_tpu/training/losses.py``: the same four functions,
fp32 on whatever device their inputs are on. ``ssim``'s 11x11 Gaussian
window is a depthwise VALID ``F.conv2d`` (``groups=C``) on the NHWC inputs
permuted to NCHW, the counterpart of JAX's ``lax.conv_general_dilated``
with ``feature_group_count=C``, with TF32 off. The host-side metrics of
whole videos are ``video_restore_tpu_torch/metrics.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_restore_tpu_torch.utils.device import tf32


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def charbonnier_loss(
    pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Smooth L1 used by most SR training recipes."""
    d = pred.float() - target.float()
    return torch.mean(torch.sqrt(d * d + eps * eps))


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def _ssim_filter(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv of NHWC ``x`` with the (k, k) ``kernel``."""
    c = x.shape[-1]
    w = kernel[None, None].expand(c, 1, *kernel.shape)
    with tf32(False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    max_val: float = 1.0,
    sigma: float = 1.5,
    radius: int = 5,
) -> torch.Tensor:
    """Mean SSIM over an 11x11 Gaussian window (standard Wang et al. SSIM).

    pred/target: (N, H, W, C) float."""
    x = pred.float()
    y = target.float()
    coords = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    g = torch.exp(-0.5 * (coords / sigma) ** 2)
    g = g / g.sum()
    kernel = g[:, None] * g[None, :]

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _ssim_filter(x, kernel)
    mu_y = _ssim_filter(y, kernel)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = _ssim_filter(x * x, kernel) - mu_x2
    sig_y = _ssim_filter(y * y, kernel) - mu_y2
    sig_xy = _ssim_filter(x * y, kernel) - mu_xy
    num = (2 * mu_xy + c1) * (2 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x + sig_y + c2)
    return torch.mean(num / den)

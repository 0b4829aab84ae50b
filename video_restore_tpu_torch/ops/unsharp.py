"""Single-pass unsharp mask on kernel K2 (``csrc/unsharp.cu``).

Port of ``video_restore_tpu/ops/pallas_post.py`` ``unsharp_fused``
(``:131-186``): ``clip(x + amount * (x - gauss_sep(x)), 0, 1)`` in fp32 on
(B, H, W, C), edge-replicate padding on both axes, taps from
``_gaussian_kernel1d(sigma, radius)``, and the ``threshold`` branch. One
read and one write of the frame. Unlike the Pallas wrapper, which falls
back to XLA when ``h % 8`` or ``h < block_h + 16`` (``:150-158``), the
kernel takes every frame height. Its plain version is
``ops/post.py::unsharp_mask``; the kernel note is at the top of
``csrc/unsharp.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.post import _gaussian_kernel1d, unsharp_mask

MAX_RADIUS = 16  # kMaxRadius in csrc/unsharp.cu


def unsharp_fused(
    x: torch.Tensor,
    amount: float = 0.5,
    sigma: float = 1.0,
    radius: int = 3,
    threshold: float = 0.0,
) -> torch.Tensor:
    """Unsharp mask of x (B, H, W, C) fp32 in [0, 1]; one K2 launch on
    CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return unsharp_mask(x, amount, sigma, radius, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"unsharp_fused: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            "unsharp_fused: x must be a contiguous (B, H, W, C) float32 "
            f"tensor (got {x.dtype}, shape {tuple(x.shape)})"
        )
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"unsharp_fused: radius must be in [0, {MAX_RADIUS}]")
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    taps = (ctypes.c_float * (2 * radius + 1))(
        *[float(t) for t in _gaussian_kernel1d(sigma, radius)]
    )
    lib = _build.load()
    code = lib.vr_unsharp(
        x.data_ptr(), out.data_ptr(), b, h, w, c, radius, taps,
        float(amount), float(threshold), _build.stream_ptr(x),
    )
    _build.check(lib, code, "unsharp kernel")
    _build.count_launch("unsharp_fused")
    return out

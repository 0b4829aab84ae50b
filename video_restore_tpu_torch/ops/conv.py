"""Plain convolution and layout primitives, NHWC activations, HWIO weights.

Port of ``video_restore_tpu/ops/conv.py:21-233`` (``conv2d``,
``leaky_relu``, ``prelu``, ``pixel_shuffle``, ``pixel_unshuffle``,
``upsample_nearest``). Same
conventions as the JAX functions: activations NHWC, weights HWIO, products
accumulated in fp32 and the result cast back to the activation dtype. These
are the plain versions that the CPU path and the kernel checks use; the
GPU path runs the hand-written kernels in ``ops/tail.py``,
``ops/stripe.py``, ``ops/rdb.py``, ``ops/srvgg.py`` and ``ops/unsharp.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 (any odd k) conv, NHWC x HWIO -> NHWC fp32, no bias.

    Inputs are upcast to fp32 first, so bf16 operands give exact products
    accumulated in fp32 (the kernels' arithmetic). On a GPU the caller
    decides whether cuDNN may use TF32 (``torch.backends.cudnn.allow_tf32``);
    the checks turn it off."""
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(
        x.permute(0, 3, 1, 2).float(),
        w.permute(3, 2, 0, 1).float(),
        padding=(kh // 2, kw // 2),
    )
    return y.permute(0, 2, 3, 1)


def conv2d(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """2D SAME convolution, NHWC x HWIO -> NHWC in x's dtype, fp32
    accumulation and fp32 bias add (``ops/conv.py:21-45``)."""
    y = conv2d_f32(x, w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the ESRGAN slope of 0.2 (``where(x >= 0, x, 0.2 x)``)."""
    return torch.where(x >= 0, x, x * negative_slope)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Channel-wise PReLU; ``alpha`` has shape (C,)."""
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space, NHWC, channel order (c_out, ry, rx) as torch's
    PixelShuffle (the SRVGG output conv)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, c // (r * r), r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Space-to-depth, NHWC, channel order (c, ry, rx) as torch's
    PixelUnshuffle (the scale-2 RRDBNet stem input)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample, NHWC."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)

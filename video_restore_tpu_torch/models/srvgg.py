"""SRVGGNetCompact (realesr-general-x4v3) as a PyTorch module.

Port of ``video_restore_tpu/models/srvgg.py``: ``SRVGGSpec`` is copied, and
:class:`SRVGGNet` runs the same network as ``_apply`` in stripe mode
(``srvgg.py:117-284``): the stem conv + PReLU (K1 through
``conv3x3_fused``), ``num_conv`` x (3x3 conv + PReLU) at LR resolution
(``ops/srvgg.py::srvgg_body``, K1), then the output conv to ``3 scale^2``
channels, pixel-shuffled, plus the nearest-upsampled input
(``ops/srvgg.py::srvgg_up_fused``, K3). The fused upsampler takes scales 2
and 4, the scales the JAX model sends to its own (``srvgg.py:227, 270``).

Weights keep the JAX layout: HWIO convs, the same names as the JAX param
pytree, the body stacked on axis 0 (``body.w``, ``body.b``,
``body.alpha``). ``forward(x)`` runs the kernel wrappers (launches on CUDA
tensors, the plain versions on CPU tensors); ``forward(x, plain=True)``
runs the plain versions on any device; ``forward_train(x)`` is the
differentiable forward of fine-tuning (the JAX ``apply_srvgg(stripe=False)``:
fp32 ``F.conv2d`` under autograd, no kernel), and :func:`params_to_jax`
the inverse of :func:`params_from_jax`. ``prepare(..., precision="int8")``
selects the W8A8 body of the JAX ``_apply(stripe=True, precision="int8")``
(``srvgg.py:177-185``): int8 body weights with one fp32 scale per (conv,
output channel), on K4 (``ops/srvgg.py::srvgg_body_i8``); the stem and the
upsampler stay in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_restore_tpu_torch.models.rrdbnet import (
    Conv3x3,
    _conv_hwio,
    _conv_nchw,
    default_precision,
)
from video_restore_tpu_torch.ops.quant import pack_i8_weights, quantize_conv_weights
from video_restore_tpu_torch.ops.srvgg import (
    srvgg_body,
    srvgg_body_i8,
    srvgg_body_i8_plain,
    srvgg_body_plain,
    srvgg_up_fused,
    srvgg_up_fused_plain,
    srvgg_up_route,
    srvgg_up_weights,
    up_width,
)
from video_restore_tpu_torch.ops.tail import conv3x3_fused, conv3x3_fused_plain


@dataclasses.dataclass(frozen=True)
class SRVGGSpec:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_conv: int = 32
    scale: int = 4


class _Body(nn.Module):
    """The ``num_conv`` body convs, stacked: w (n, 3, 3, nf, nf), b and
    alpha (n, nf)."""

    def __init__(self, n: int, nf: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n, 3, 3, nf, nf), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(n, nf), requires_grad=False)
        self.alpha = nn.Parameter(torch.zeros(n, nf), requires_grad=False)


class SRVGGNet(nn.Module):
    """SRVGGNetCompact on NHWC activations: (N, H, W, 3) in [0, 1] ->
    (N, H*s, W*s, 3) in the module's dtype."""

    def __init__(self, spec: SRVGGSpec):
        super().__init__()
        self.spec = spec
        nf = spec.num_feat
        self.conv_in = Conv3x3(spec.num_in_ch, nf)
        self.alpha_in = nn.Parameter(torch.zeros(nf), requires_grad=False)
        self.body = _Body(spec.num_conv, nf)
        self.conv_out = Conv3x3(nf, spec.num_out_ch * spec.scale**2)
        self.precision = "bf16"

    @torch.no_grad()
    def prepare(
        self, dtype: torch.dtype, device, precision: Optional[str] = None
    ) -> "SRVGGNet":
        """Move the weights once to the compute dtype and device (biases and
        alphas included, as the JAX zoo casts every float leaf). With
        ``precision="int8"`` the body also quantises its cast weights into
        the buffers ``wq`` (int8), ``sw`` (fp32 (num_conv, nf)) and ``wp``
        (each conv's ``wq`` packed for K4's ``"mma"`` route). Where
        K3's tensor-core routes (``"mma"`` in bf16, ``"bf16x3"`` in fp32)
        read conv_out with padded output columns (r 2: 12 -> 16), the
        padded copy is made here, once, as the buffer
        ``w_up`` (``ops/srvgg.py::srvgg_up_weights``). ``precision`` None:
        ``rrdbnet.default_precision`` (``VRT_PRECISION``, as JAX
        ``srvgg.py:301-304``). Returns self."""
        if precision is None:
            precision = default_precision()
        self.to(device=device, dtype=dtype)
        self.precision = precision
        w = self.conv_out.w
        r = self.spec.scale
        if (
            srvgg_up_route(dtype, w.shape[-2], r) in ("mma", "bf16x3")
            and up_width(r, self.spec.num_out_ch) != w.shape[-1]
        ):
            self.register_buffer("w_up", srvgg_up_weights(w, r), persistent=False)
        if precision == "int8":
            body = self.body
            nf = body.w.shape[-1]
            qs = [quantize_conv_weights(w, (0, nf)) for w in body.w]
            body.register_buffer("wq", torch.stack([q for q, _ in qs]), persistent=False)
            body.register_buffer("sw", torch.cat([s for _, s in qs]), persistent=False)
            body.register_buffer(
                "wp", torch.stack([pack_i8_weights(q) for q, _ in qs]), persistent=False
            )
        return self

    @torch.no_grad()
    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        conv = conv3x3_fused_plain if plain else conv3x3_fused
        body = srvgg_body_plain if plain else srvgg_body
        up = srvgg_up_fused_plain if plain else srvgg_up_fused
        x = x.to(self.conv_in.w.dtype)
        feat = conv(
            x, self.conv_in.w, self.conv_in.b, alpha=self.alpha_in, act="prelu"
        )
        if self.precision == "int8":
            body_i8 = srvgg_body_i8_plain if plain else srvgg_body_i8
            feat = body_i8(
                feat, self.body.wq, self.body.sw, self.body.b, self.body.alpha,
                self.body.wp,
            )
        else:
            feat = body(feat, self.body.w, self.body.b, self.body.alpha)
        w_up = getattr(self, "w_up", self.conv_out.w)
        return up(feat, w_up, self.conv_out.b, x, self.spec.scale)

    def forward_train(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """The differentiable forward: the JAX ``apply_srvgg(stripe=False)``
        (``srvgg.py:136-139, 263-284``), conv_in + PReLU, ``num_conv`` conv + PReLU,
        conv_out, pixel shuffle, plus the nearest-upsampled input, in fp32
        with ``F.conv2d`` under autograd and no kernel, every op out of
        place. Call it on a module built from the fp32 state, not on one
        that ``prepare`` cast. ``tp``: the sharded train step's
        tensor-parallel axis (``training/train.py::TensorParallel``), where
        each conv whose weights it holds sharded computes this rank's output
        channels (and their PReLU) and gathers them. (N, H, W, 3) -> (N,
        H*s, W*s, 3) fp32."""
        r = self.spec.scale
        x = x.float().permute(0, 3, 1, 2)
        feat = _conv_nchw(x, self.conv_in, tp, act=lambda y: F.prelu(y, self.alpha_in))
        body = self.body
        body_tp = tp if tp is not None and tp.is_sharded(body.w) else None
        for i in range(body.w.shape[0]):
            feat = _conv_hwio(feat, body.w[i], body.b[i], body_tp,
                              act=lambda y, i=i: F.prelu(y, body.alpha[i]))
        out = F.pixel_shuffle(_conv_nchw(feat, self.conv_out, tp), r)
        out = out + F.interpolate(x, scale_factor=r, mode="nearest")
        return out.permute(0, 2, 3, 1)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SRVGG param pytree (numpy leaves, body stacked on axis 0 as
    ``init_srvgg``/``convert_srvgg`` build it) -> :class:`SRVGGNet` state
    dict (fp32)."""

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32))

    return {
        "conv_in.w": t(tree["conv_in"]["w"]),
        "conv_in.b": t(tree["conv_in"]["b"]),
        "alpha_in": t(tree["alpha_in"]),
        "body.w": t(tree["body"]["w"]),
        "body.b": t(tree["body"]["b"]),
        "body.alpha": t(tree["body"]["alpha"]),
        "conv_out.w": t(tree["conv_out"]["w"]),
        "conv_out.b": t(tree["conv_out"]["b"]),
    }


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """:class:`SRVGGNet` state dict -> JAX SRVGG param pytree of float32
    numpy leaves: the inverse of :func:`params_from_jax`."""

    def a(key: str) -> np.ndarray:
        return state[key].detach().cpu().float().numpy()

    return {
        "conv_in": {"w": a("conv_in.w"), "b": a("conv_in.b")},
        "alpha_in": a("alpha_in"),
        "body": {"w": a("body.w"), "b": a("body.b"), "alpha": a("body.alpha")},
        "conv_out": {"w": a("conv_out.w"), "b": a("conv_out.b")},
    }


def init_params(
    spec: SRVGGSpec, generator: Optional[torch.Generator] = None
) -> Dict[str, torch.Tensor]:
    """Random weights (fp32 state dict) as the JAX ``init_srvgg``: every
    conv normal with std ``sqrt(2 / fan_in) * 0.1``, zero biases, PReLU
    alphas 0.25 (the numbers differ: another generator)."""
    sd = {}
    for name, p in SRVGGNet(spec).named_parameters():
        if name.endswith(".b"):
            sd[name] = torch.zeros(p.shape)
        elif "alpha" in name:
            sd[name] = torch.full(p.shape, 0.25)
        else:
            fan_in = 9 * p.shape[-2]
            std = math.sqrt(2.0 / fan_in) * 0.1
            sd[name] = torch.randn(p.shape, generator=generator) * std
    return sd

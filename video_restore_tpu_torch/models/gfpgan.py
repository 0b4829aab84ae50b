"""GFPGAN v1-clean face restoration: a U-Net prior and a StyleGAN2-clean
CSFT decoder, as PyTorch modules (NCHW).

Port of ``video_restore_tpu/models/gfpgan.py``, the architecture of the
released GFPGANv1.3/v1.4 checkpoints (bilinear resampling, plain LeakyReLU):

- **U-Net**: a 1x1 stem at 512 px, 7 residual down blocks to 4x4, a 3x3
  conv and a linear that give one w-latent per decoder layer, then 7
  residual up blocks, each emitting an SFT (scale, shift) pair through two
  small conv heads;
- **decoder**: a constant 4x4 input, per-layer modulated 3x3 convs (style
  modulation and demodulation), bilinear 2x upsampling, noise from stored
  buffers, skip to-RGB sums; the U-Net's conditions modulate half the
  channels at each resolution.

The modulated conv keeps the JAX form: x * s -> one conv shared by the
batch -> * demod, which equals per-sample weight modulation exactly and
keeps one batched ``F.conv2d``. The JAX package computes these convs with
XLA (``lax.conv_general_dilated``), outside any Pallas kernel, so the port
calls ``F.conv2d`` and ``torch.matmul``.

**Precision.** JAX runs the prior in float32. On a CUDA device cuDNN runs
an fp32 ``F.conv2d`` in TF32 by default, so :meth:`GFPGAN.forward` sets the
TF32 flags for its own call and puts them back after: ``precision="fp32"``
(the default, TF32 off) or ``"tf32"``.

The module's state dict has exactly the released ``params_ema`` keys of the
inference subset (:func:`gfpgan_key_schema`), so
:func:`convert_gfpgan_state_dict` validates a checkpoint and hands it over;
:func:`gfpgan_params_from_jax` turns the JAX pytree (numpy leaves) into the
same state dict.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_restore_tpu_torch.utils.device import tf32

_SQRT2 = 2.0**0.5
PRECISIONS = ("fp32", "tf32")


@dataclasses.dataclass(frozen=True)
class GFPGANSpec:
    out_size: int = 512
    num_style_feat: int = 512
    channel_multiplier: int = 2
    # GFPGANv1Clean passes narrow=1 to the decoder and narrow * 0.5 to the
    # U-Net channel table
    narrow: float = 1.0
    sft_half: bool = True

    @property
    def log_size(self) -> int:
        return int(math.log2(self.out_size))

    @property
    def num_latent(self) -> int:
        return self.log_size * 2 - 2

    def channels(self, narrow: float) -> Dict[int, int]:
        cm = self.channel_multiplier
        base = {
            4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * cm, 128: 128 * cm, 256: 64 * cm, 512: 32 * cm,
            1024: 16 * cm,
        }
        return {k: int(v * narrow) for k, v in base.items()}

    @property
    def unet_channels(self) -> Dict[int, int]:
        return self.channels(self.narrow * 0.5)

    @property
    def dec_channels(self) -> Dict[int, int]:
        return self.channels(self.narrow)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _resize2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, half-pixel centres (``align_corners=False``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _resize_half(x: torch.Tensor) -> torch.Tensor:
    """0.5x bilinear downsample without antialiasing: at exactly 0.5x the
    half-pixel sample is the mean of each 2x2 block (``gfpgan.py:102-110``
    of the JAX package)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def modulated_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    style: torch.Tensor,
    demodulate: bool = True,
    sample_mode: Optional[str] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """StyleGAN2's modulated conv with a per-sample style, as (x * s) ->
    conv -> (* demod). x: (B, cin, H, W); w: (cout, cin, k, k); style:
    (B, cin)."""
    if sample_mode == "upsample":
        x = _resize2x(x)
    elif sample_mode == "downsample":
        x = _resize_half(x)
    y = F.conv2d(x * style[:, :, None, None], w, padding=w.shape[-1] // 2)
    if demodulate:
        # demod_o = rsqrt(sum_{cin, k, k} (w * s)^2 + eps), per sample
        w2 = (w.float() ** 2).sum(dim=(2, 3))  # (cout, cin)
        denom = style.float() ** 2 @ w2.t()  # (B, cout)
        y = y * torch.rsqrt(denom + eps)[:, :, None, None]
    return y


class _Conv(nn.Conv2d):
    """A SAME conv with the released key names (``weight``, ``bias``)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__(cin, cout, k, padding=k // 2, bias=bias)


class _ResBlock(nn.Module):
    """The clean ResBlock: conv1 -> lrelu -> resample -> conv2 -> lrelu,
    plus a resampled 1x1 skip, summed without the 1/sqrt(2) of the
    non-clean arch."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _Conv(cin, cin, 3)
        self.conv2 = _Conv(cin, cout, 3)
        self.skip = _Conv(cin, cout, 1, bias=False)

    def forward(self, x, resample):
        out = resample(_lrelu(self.conv1(x)))
        out = _lrelu(self.conv2(out))
        return out + self.skip(resample(x))


class _ModulatedConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, nsf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, cout, cin, k, k))
        self.modulation = nn.Linear(nsf, cin)


class _StyleConv(nn.Module):
    """StyleConv (clean): the modulated conv x sqrt(2), + strength x noise,
    + bias, LeakyReLU 0.2. ``weight`` is the noise strength."""

    def __init__(self, cin: int, cout: int, nsf: int, sample_mode=None):
        super().__init__()
        self.modulated_conv = _ModulatedConv(cin, cout, 3, nsf)
        self.weight = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))
        self.sample_mode = sample_mode

    def forward(self, x, latent, noise):
        mc = self.modulated_conv
        style = mc.modulation(latent)
        out = modulated_conv2d(x, mc.weight[0], style, True, self.sample_mode)
        out = out * _SQRT2
        out = out + self.weight * noise
        return _lrelu(out + self.bias)


class _ToRGB(nn.Module):
    """ToRGB (clean): a 1x1 modulated conv without demodulation, + bias, +
    the bilinearly upsampled skip."""

    def __init__(self, cin: int, nsf: int):
        super().__init__()
        self.modulated_conv = _ModulatedConv(cin, 3, 1, nsf)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, latent, skip=None):
        mc = self.modulated_conv
        out = modulated_conv2d(x, mc.weight[0], mc.modulation(latent), False)
        out = out + self.bias
        if skip is not None:
            out = out + _resize2x(skip)
        return out


class _ConstantInput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1, c, 4, 4))


class _Decoder(nn.Module):
    """StyleGAN2-clean decoder with CSFT (``stylegan_decoder.*``)."""

    def __init__(self, spec: GFPGANSpec):
        super().__init__()
        dch, ls, nsf = spec.dec_channels, spec.log_size, spec.num_style_feat
        self.constant_input = _ConstantInput(dch[4])
        self.style_conv1 = _StyleConv(dch[4], dch[4], nsf)
        self.to_rgb1 = _ToRGB(dch[4], nsf)
        convs, rgbs = [], []
        self.noises = nn.Module()
        self.noises.register_buffer("noise0", torch.zeros(1, 1, 4, 4))
        cin = dch[4]
        for n, i in enumerate(range(3, ls + 1)):
            cout, res = dch[2**i], 2**i
            convs += [_StyleConv(cin, cout, nsf, "upsample"), _StyleConv(cout, cout, nsf)]
            rgbs.append(_ToRGB(cout, nsf))
            for m in (2 * n + 1, 2 * n + 2):
                self.noises.register_buffer(f"noise{m}", torch.zeros(1, 1, res, res))
            cin = cout
        self.style_convs = nn.ModuleList(convs)
        self.to_rgbs = nn.ModuleList(rgbs)


def _sft_head(cin: int, cout: int) -> nn.Sequential:
    # keys .0 and .2, as in the released file (.1 is the activation)
    return nn.Sequential(_Conv(cin, cin, 3), nn.LeakyReLU(0.2), _Conv(cin, cout, 3))


class GFPGAN(nn.Module):
    """GFPGANv1Clean for inference (``apply_gfpgan`` of the JAX package)."""

    def __init__(self, spec: GFPGANSpec = GFPGANSpec()):
        super().__init__()
        self.spec = spec
        uch, dch, ls = spec.unet_channels, spec.dec_channels, spec.log_size
        self.conv_body_first = _Conv(3, uch[2**ls], 1)
        down, cin = [], uch[2**ls]
        for i in range(ls, 2, -1):
            down.append(_ResBlock(cin, uch[2 ** (i - 1)]))
            cin = uch[2 ** (i - 1)]
        self.conv_body_down = nn.ModuleList(down)
        self.final_conv = _Conv(uch[4], uch[4], 3)
        self.final_linear = nn.Linear(uch[4] * 16, spec.num_latent * spec.num_style_feat)
        up, cscale, cshift, cin = [], [], [], uch[4]
        for i in range(3, ls + 1):
            cout = uch[2**i]
            up.append(_ResBlock(cin, cout))
            sft = dch[2**i] // 2 if spec.sft_half else dch[2**i]
            cscale.append(_sft_head(cout, sft))
            cshift.append(_sft_head(cout, sft))
            cin = cout
        self.conv_body_up = nn.ModuleList(up)
        self.condition_scale = nn.ModuleList(cscale)
        self.condition_shift = nn.ModuleList(cshift)
        self.stylegan_decoder = _Decoder(spec)

    def forward(self, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
        """(B, 3, 512, 512) RGB in [0, 1] -> the same shape in [0, 1]."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        with tf32(precision == "tf32"):
            return self._forward(x.float())

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        b = x.shape[0]
        feat = _lrelu(self.conv_body_first((x - 0.5) * 2.0))  # to [-1, 1]
        skips: List[torch.Tensor] = []
        for blk in self.conv_body_down:
            feat = blk(feat, _resize_half)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat))
        # torch's (C, H, W) flatten: the order final_linear was trained on
        latents = self.final_linear(feat.reshape(b, -1)).view(
            b, spec.num_latent, spec.num_style_feat
        )
        conditions = []
        for i, blk in enumerate(self.conv_body_up):
            feat = blk(feat + skips[i], _resize2x)
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]

        dec = self.stylegan_decoder
        noises = dict(dec.noises.named_buffers())
        out = dec.constant_input.weight.expand(b, -1, -1, -1)
        out = dec.style_conv1(out, latents[:, 0], noises["noise0"])
        skip = dec.to_rgb1(out, latents[:, 1])
        i = 1
        for li, to_rgb in enumerate(dec.to_rgbs):
            conv1, conv2 = dec.style_convs[2 * li], dec.style_convs[2 * li + 1]
            out = conv1(out, latents[:, i], noises[f"noise{2 * li + 1}"])
            # CSFT: the U-Net's condition modulates half the channels
            cs, csh = conditions[2 * li], conditions[2 * li + 1]
            if spec.sft_half:
                half = out.shape[1] // 2
                out = torch.cat([out[:, :half], out[:, half:] * cs + csh], dim=1)
            else:
                out = out * cs + csh
            out = conv2(out, latents[:, i + 1], noises[f"noise{2 * li + 2}"])
            skip = to_rgb(out, latents[:, i + 2], skip)
            i += 2
        return (torch.clamp(skip, -1.0, 1.0) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# the released checkpoint
# ---------------------------------------------------------------------------


def gfpgan_key_schema(spec: GFPGANSpec = GFPGANSpec()) -> Dict[str, tuple]:
    """The released ``params_ema`` keys of the inference subset -> torch
    shapes (the style MLP and the supervision heads in the file go unused:
    the latents come from ``final_linear``). Also the keys of
    :class:`GFPGAN`'s state dict."""
    uch, dch, ls, nsf = (
        spec.unet_channels, spec.dec_channels, spec.log_size, spec.num_style_feat,
    )
    ks: Dict[str, tuple] = {}

    def conv(prefix, k, cin, cout, bias=True):
        ks[f"{prefix}.weight"] = (cout, cin, k, k)
        if bias:
            ks[f"{prefix}.bias"] = (cout,)

    conv("conv_body_first", 1, 3, uch[2**ls])
    cin = uch[2**ls]
    for j, i in enumerate(range(ls, 2, -1)):
        cout = uch[2 ** (i - 1)]
        conv(f"conv_body_down.{j}.conv1", 3, cin, cin)
        conv(f"conv_body_down.{j}.conv2", 3, cin, cout)
        conv(f"conv_body_down.{j}.skip", 1, cin, cout, bias=False)
        cin = cout
    conv("final_conv", 3, uch[4], uch[4])
    ks["final_linear.weight"] = (spec.num_latent * nsf, uch[4] * 16)
    ks["final_linear.bias"] = (spec.num_latent * nsf,)
    cin = uch[4]
    for j, i in enumerate(range(3, ls + 1)):
        cout = uch[2**i]
        conv(f"conv_body_up.{j}.conv1", 3, cin, cin)
        conv(f"conv_body_up.{j}.conv2", 3, cin, cout)
        conv(f"conv_body_up.{j}.skip", 1, cin, cout, bias=False)
        sft_out = dch[2**i] // 2 if spec.sft_half else dch[2**i]
        conv(f"condition_scale.{j}.0", 3, cout, cout)
        conv(f"condition_scale.{j}.2", 3, cout, sft_out)
        conv(f"condition_shift.{j}.0", 3, cout, cout)
        conv(f"condition_shift.{j}.2", 3, cout, sft_out)
        cin = cout

    def mconv(prefix, k, cin, cout):
        ks[f"{prefix}.modulated_conv.weight"] = (1, cout, cin, k, k)
        ks[f"{prefix}.modulated_conv.modulation.weight"] = (cin, nsf)
        ks[f"{prefix}.modulated_conv.modulation.bias"] = (cin,)
        ks[f"{prefix}.bias"] = (1, cout, 1, 1)

    d = "stylegan_decoder"
    ks[f"{d}.constant_input.weight"] = (1, dch[4], 4, 4)
    mconv(f"{d}.style_conv1", 3, dch[4], dch[4])
    ks[f"{d}.style_conv1.weight"] = (1,)  # noise strength
    mconv(f"{d}.to_rgb1", 1, dch[4], 3)
    ks[f"{d}.noises.noise0"] = (1, 1, 4, 4)
    cin = dch[4]
    for n, i in enumerate(range(3, ls + 1)):
        cout = dch[2**i]
        mconv(f"{d}.style_convs.{2 * n}", 3, cin, cout)
        ks[f"{d}.style_convs.{2 * n}.weight"] = (1,)
        mconv(f"{d}.style_convs.{2 * n + 1}", 3, cout, cout)
        ks[f"{d}.style_convs.{2 * n + 1}.weight"] = (1,)
        mconv(f"{d}.to_rgbs.{n}", 1, cout, 3)
        res = 2**i
        ks[f"{d}.noises.noise{2 * n + 1}"] = (1, 1, res, res)
        ks[f"{d}.noises.noise{2 * n + 2}"] = (1, 1, res, res)
        cin = cout
    return ks


def convert_gfpgan_state_dict(
    sd: Dict[str, Any], spec: GFPGANSpec = GFPGANSpec()
) -> Dict[str, torch.Tensor]:
    """A released ``params_ema`` dict -> :class:`GFPGAN`'s state dict
    (float32 on the CPU). Every consumed tensor's shape is checked against
    :func:`gfpgan_key_schema`: a mismatch means the pinned schema diverged
    from the file, so it raises instead of loading silently."""
    out: Dict[str, torch.Tensor] = {}
    for key, shape in gfpgan_key_schema(spec).items():
        if key not in sd:
            raise KeyError(f"GFPGAN checkpoint missing key {key!r}")
        a = np.asarray(sd[key], dtype=np.float32)
        if tuple(a.shape) != shape:
            raise ValueError(
                f"GFPGAN key {key!r}: shape {tuple(a.shape)} != pinned {shape}"
            )
        out[key] = torch.from_numpy(a.copy())
    return out


def gfpgan_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's GFPGAN pytree (numpy leaves: HWIO convs, (in, out)
    linears, NHWC noises) -> :class:`GFPGAN`'s state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        if p.get("b") is not None:
            sd[f"{prefix}.bias"] = t(p["b"])

    def linear(prefix, p):
        sd[f"{prefix}.weight"] = t(np.asarray(p["w"]).T)
        sd[f"{prefix}.bias"] = t(p["b"])

    def mconv(prefix, p):
        sd[f"{prefix}.modulated_conv.weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1)[None])
        linear(f"{prefix}.modulated_conv.modulation", p["modulation"])
        sd[f"{prefix}.bias"] = t(np.asarray(p["b"]).reshape(1, -1, 1, 1))
        if "noise_strength" in p:
            sd[f"{prefix}.weight"] = t(np.asarray(p["noise_strength"]).reshape(1))

    conv("conv_body_first", tree["conv_body_first"])
    for j, blk in enumerate(tree["conv_body_down"]):
        for k in ("conv1", "conv2", "skip"):
            conv(f"conv_body_down.{j}.{k}", blk[k])
    conv("final_conv", tree["final_conv"])
    linear("final_linear", tree["final_linear"])
    for j, blk in enumerate(tree["conv_body_up"]):
        for k in ("conv1", "conv2", "skip"):
            conv(f"conv_body_up.{j}.{k}", blk[k])
        for name in ("condition_scale", "condition_shift"):
            conv(f"{name}.{j}.0", tree[name][j][0])
            conv(f"{name}.{j}.2", tree[name][j][1])
    d, dec = "stylegan_decoder", tree["decoder"]
    sd[f"{d}.constant_input.weight"] = t(np.asarray(dec["constant_input"]).transpose(2, 0, 1)[None])
    mconv(f"{d}.style_conv1", dec["style_conv1"])
    mconv(f"{d}.to_rgb1", dec["to_rgb1"])
    for m, sc in enumerate(dec["style_convs"]):
        mconv(f"{d}.style_convs.{m}", sc)
    for n, rgb in enumerate(dec["to_rgbs"]):
        mconv(f"{d}.to_rgbs.{n}", rgb)
    for m, nz in enumerate(dec["noises"]):
        sd[f"{d}.noises.noise{m}"] = t(np.asarray(nz).transpose(0, 3, 1, 2))
    return sd


def init_gfpgan(
    spec: GFPGANSpec = GFPGANSpec(), generator: Optional[torch.Generator] = None
) -> Dict[str, torch.Tensor]:
    """Random weights with the released geometry and the JAX init's
    distributions (He-normal convs, 1/sqrt(fan_in) linears and modulated
    convs, modulation biases 1, noise strengths 0), from ``generator``."""
    g = generator or torch.Generator().manual_seed(0)
    sd = {}
    for key, shape in gfpgan_key_schema(spec).items():
        if key.endswith("modulation.bias"):
            sd[key] = torch.ones(shape)
        elif key.endswith(".bias") or (shape == (1,) and ".style_conv" in key):
            sd[key] = torch.zeros(shape)
        elif ".noises." in key or key.endswith("constant_input.weight"):
            sd[key] = torch.randn(shape, generator=g)
        elif "modulated_conv.weight" in key:
            sd[key] = torch.randn(shape, generator=g) / math.sqrt(shape[2] * shape[3] * shape[4])
        elif key.endswith("modulation.weight") or key == "final_linear.weight":
            sd[key] = torch.randn(shape, generator=g) / math.sqrt(shape[1])
        else:  # a conv, OIHW
            sd[key] = torch.randn(shape, generator=g) * math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    return sd


def synthetic_gfpgan_sd(spec: GFPGANSpec = GFPGANSpec()) -> Dict[str, np.ndarray]:
    """A checkpoint with the released keys and shapes from
    ``np.random.default_rng(1234)``, drawn in schema order: modulation
    biases 1, other biases N(0, 0.01), weights N(0, 1 / fan_in). The
    checkpoint ``tests/goldens/GFPGANv1.4.npz`` was computed from."""
    rng = np.random.default_rng(1234)
    sd = {}
    for k, shape in gfpgan_key_schema(spec).items():
        if k.endswith("modulation.bias"):
            sd[k] = np.ones(shape, np.float32)
        elif k.endswith(".bias") or "noise_strength" in k:
            sd[k] = rng.normal(0.0, 0.01, shape).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) or 1
            sd[k] = rng.normal(0.0, (1.0 / fan_in) ** 0.5, shape).astype(np.float32)
    return sd


def golden_tiles(seed: int = 7, n: int = 2, h: int = 24, w: int = 32) -> np.ndarray:
    """Deterministic structured-plus-noise input tiles in [0, 1], (n, h, w,
    3) float32: the inputs of the repo's golden outputs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1).astype(np.float32)
    tiles = []
    for i in range(n):
        t = base + 0.15 * np.sin(10.0 * base[..., :1] * (i + 1))
        t = t + rng.normal(0.0, 0.05, (h, w, 3))
        tiles.append(np.clip(t, 0.0, 1.0))
    return np.stack(tiles).astype(np.float32)


def golden_scores(ours: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """The repo's golden bar (``tools/golden_parity.py::_scores``): the
    least per-image PSNR and luma SSIM (11-tap Gaussian window) of (n, H,
    W, 3) outputs, both mapped to 0..255 by the reference's own range (no
    clipping)."""
    from scipy.ndimage import gaussian_filter

    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours, np.float64)
    lo = ref.min()
    span = max(ref.max() - lo, 1.0)
    a = (ours - lo) / span * 255.0
    b = (ref - lo) / span * 255.0

    def psnr(x, y):
        mse = np.mean((x - y) ** 2)
        return float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)

    def ssim(x, y):
        def lum(im):
            im = im / 255.0
            return 0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]

        x, y = lum(x), lum(y)
        f = lambda im: gaussian_filter(im, 1.5, truncate=3.5 / 1.5, mode="nearest")  # noqa: E731
        c1, c2 = 0.01**2, 0.03**2
        mx, my = f(x), f(y)
        sxx, syy, sxy = f(x * x) - mx * mx, f(y * y) - my * my, f(x * y) - mx * my
        num = (2 * mx * my + c1) * (2 * sxy + c2)
        return float(np.mean(num / ((mx**2 + my**2 + c1) * (sxx + syy + c2))))

    n = a.shape[0]
    return min(psnr(a[i], b[i]) for i in range(n)), min(ssim(a[i], b[i]) for i in range(n))


def load_gfpgan(
    models_dir=None, name: str = "GFPGANv1.4", spec: GFPGANSpec = GFPGANSpec()
) -> Tuple[Dict[str, torch.Tensor], GFPGANSpec]:
    """Read ``<models_dir>/<name>.pth`` (a released checkpoint, through
    ``models/convert.py``'s safe loader) and convert it. Nothing is
    downloaded: a missing file raises, unless ``VRT_GFPGAN_RANDOM=1`` asks
    for random weights (:func:`init_gfpgan`). Returns (state dict, spec)."""
    from video_restore_tpu_torch.models.convert import _load_state_dict

    path = Path(models_dir) if models_dir else Path("models")
    path = path / f"{name}.pth"
    if not path.exists():
        # deliberately not VRT_ALLOW_RANDOM_WEIGHTS: a random face prior
        # paints noise, so the pipeline takes the region heuristic unless
        # a smoke run asks for the prior explicitly
        if os.environ.get("VRT_GFPGAN_RANDOM") == "1":
            return init_gfpgan(spec), spec
        raise RuntimeError(
            f"no {name} weights at {path} (nothing is downloaded); place the "
            "released file there or set VRT_GFPGAN_RANDOM=1 for a smoke run"
        )
    return convert_gfpgan_state_dict(_load_state_dict(path), spec), spec


def gfpgan_flops(spec: GFPGANSpec = GFPGANSpec()) -> int:
    """Multiply-adds x 2 of one crop's forward, counted from the shapes:
    the convs, the modulated convs with their modulation linears and
    demodulation products, and final_linear (the elementwise work and the
    resampling are left out)."""
    uch, dch, ls, nsf = spec.unet_channels, spec.dec_channels, spec.log_size, spec.num_style_feat
    macs = 0

    def conv(res, k, cin, cout):
        nonlocal macs
        macs += res * res * k * k * cin * cout

    top = 2**ls
    conv(top, 1, 3, uch[top])
    cin = uch[top]
    for i in range(ls, 2, -1):
        res, cout = 2**i, uch[2 ** (i - 1)]
        conv(res, 3, cin, cin)  # conv1 at the block's input resolution
        conv(res // 2, 3, cin, cout)  # conv2 after the downsample
        conv(res // 2, 1, cin, cout)  # the skip
        cin = cout
    conv(4, 3, uch[4], uch[4])
    macs += uch[4] * 16 * spec.num_latent * nsf
    cin = uch[4]
    for i in range(3, ls + 1):
        res, cout = 2**i, uch[2**i]
        conv(res // 2, 3, cin, cin)
        conv(res, 3, cin, cout)
        conv(res, 1, cin, cout)
        sft = dch[res] // 2 if spec.sft_half else dch[res]
        for _ in range(2):
            conv(res, 3, cout, cout)
            conv(res, 3, cout, sft)
        cin = cout
    conv(4, 3, dch[4], dch[4])
    conv(4, 1, dch[4], 3)
    macs += 2 * nsf * dch[4] + dch[4] * dch[4]  # modulations, a demodulation
    cin = dch[4]
    for i in range(3, ls + 1):
        res, cout = 2**i, dch[2**i]
        conv(res, 3, cin, cout)
        conv(res, 3, cout, cout)
        conv(res, 1, cout, 3)
        macs += nsf * (cin + 2 * cout) + cin * cout + cout * cout
        cin = cout
    return 2 * macs

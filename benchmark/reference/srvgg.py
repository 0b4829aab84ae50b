"""Plain reference of SRVGGNetCompact, Real-ESRGAN realesr-general-x4v3
(realesrgan/archs/srvgg_arch.py), and the seeded weights the benchmark
gives it and the program.

Forward, NCHW float32, ``F.conv2d`` with 3x3 kernels and padding 1:
conv_in + PReLU; ``num_conv`` x (conv + PReLU), one slope per channel;
conv_out to ``3 * scale ** 2`` channels, pixel-shuffled (channel order
(c, ry, rx)), plus the nearest-upsampled input.

Weights are a dict in the program's layout (``conv_in.w`` HWIO,
``alpha_in``, ``body.w`` stacked (n, 3, 3, nf, nf), ``body.b``,
``body.alpha``, ``conv_out.w``, ``conv_out.b``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Exact


def _calibration_frame(seed: int, channels: int, size: int = 128) -> torch.Tensor:
    """(1, channels, size, size) float64: seeded noise with a natural
    image's 1/f amplitude spectrum, mean 0.5 and std 0.15."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    spec = torch.fft.rfft2(torch.randn(1, channels, size, size, generator=g, dtype=torch.float64))
    fy = torch.fft.fftfreq(size, dtype=torch.float64)[:, None]
    fx = torch.fft.rfftfreq(size, dtype=torch.float64)[None, :]
    spec = spec / torch.clamp(torch.sqrt(fy * fy + fx * fx), min=1.0 / size)
    x = torch.fft.irfft2(spec, s=(size, size))
    return 0.5 + 0.15 * (x - x.mean()) / x.std()


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``, drawn in one call of a
    generator on that device (``cfg["init"]``): Kaiming-normal (fan_in)
    conv_in and body convs, body biases normal with std ``body_bias_std``,
    every PReLU slope ``prelu``, conv_out Kaiming-normal.

    A random 33-layer net's gain swings from seed to seed (the residual's
    std over seeds: 0.07-0.9 of the frame's range), which would change how
    much of each frame is clipped, and with it the work of the post stack
    and the scene-cut test, with the seed. So each conv is scaled, in
    order, to give unit-variance outputs on a seeded calibration frame of
    natural-image statistics (LSUV, Mishkin and Matas 2016), and conv_out
    to give the residual the std ``out_std``; the calibration runs on the CPU in float64, so both
    sides get the same weights."""
    init = cfg["init"]
    nf, n, cin = cfg["num_feat"], cfg["num_conv"], cfg["num_in_ch"]
    cout = cfg["num_out_ch"] * cfg["upscale"] ** 2
    sizes = [9 * cin * nf, n * 9 * nf * nf, n * nf, 9 * nf * cout]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    noise = torch.randn(sum(sizes), generator=g, device=device)
    a, b, c, _ = (sum(sizes[:i]) for i in range(1, 5))
    k = math.sqrt(2.0 / (9 * nf))
    w = {
        "conv_in.w": noise[:a].view(3, 3, cin, nf) * math.sqrt(2.0 / (9 * cin)),
        "conv_in.b": torch.zeros(nf, device=device),
        "alpha_in": torch.full((nf,), init["prelu"], device=device),
        "body.w": noise[a:b].view(n, 3, 3, nf, nf) * k,
        "body.b": noise[b:c].view(n, nf) * init["body_bias_std"],
        "body.alpha": torch.full((n, nf), init["prelu"], device=device),
        "conv_out.w": noise[c:].view(3, 3, nf, cout) * k,
        "conv_out.b": torch.zeros(cout, device=device),
    }
    x = _calibration_frame(seed, cin)

    def unit(wt, bias, alpha, feat):
        y = F.conv2d(feat, wt.double().cpu().permute(3, 2, 0, 1), padding=1)
        s = float(y.std())
        wt /= s
        y = y / s + bias.double().cpu()[None, :, None, None]
        return y if alpha is None else F.prelu(y, alpha.double().cpu())

    feat = unit(w["conv_in.w"], w["conv_in.b"], w["alpha_in"], x)
    for i in range(n):
        feat = unit(w["body.w"][i], w["body.b"][i], w["body.alpha"][i], feat)
    res = F.conv2d(feat, w["conv_out.w"].double().cpu().permute(3, 2, 0, 1), padding=1)
    w["conv_out.w"] *= init["out_std"] / float(res.std())
    return w


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, prec=Exact()) -> torch.Tensor:
    """(1, H, W, 3) float32 in [0, 1] -> (1, sH, sW, 3) float32."""
    r = cfg["upscale"]

    def conv(t, wt, bias, alpha=None):
        y = F.conv2d(t, prec.weight(wt).permute(3, 2, 0, 1), bias, padding=1)
        return prec.act(y if alpha is None else F.prelu(y, alpha))

    t = prec.act(x.permute(0, 3, 1, 2).contiguous())
    feat = conv(t, w["conv_in.w"], w["conv_in.b"], w["alpha_in"])
    for i in range(cfg["num_conv"]):
        feat = conv(feat, w["body.w"][i], w["body.b"][i], w["body.alpha"][i])
    out = F.pixel_shuffle(conv(feat, w["conv_out.w"], w["conv_out.b"]), r)
    out = out + F.interpolate(t, scale_factor=r, mode="nearest")
    return out.permute(0, 2, 3, 1)

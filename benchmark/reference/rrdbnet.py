"""Plain reference of RRDBNet, the ESRGAN generator of Real-ESRGAN
RealESRGAN_x4plus (basicsr/archs/rrdbnet_arch.py), and the seeded weights
the benchmark gives it and the program.

Forward, NCHW float32, ``F.conv2d`` with 3x3 kernels and padding 1:
conv_first; ``num_block`` RRDBs, each ``x + 0.2 * RDB3(RDB2(RDB1(x)))``
with ``RDB(x) = x + 0.2 * conv5(cat(x, c1 .. c4))`` and ``c_k =
lrelu(conv_k(cat(x, c1 .. c_{k-1})))``; ``feat + conv_body(trunk)``;
two stages of nearest 2x upsampling and conv + lrelu; conv_hr + lrelu;
conv_last. lrelu has slope 0.2.

Weights are a dict in the program's layout (HWIO tensors named as its
state dict: ``conv_first.w``, ``body.{i}.rdb{j}.conv{k}.w``, ...), the
same tensors for both sides.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Exact


def conv_shapes(cfg: Dict):
    """(name, cin, cout) of every conv, in the program's order."""
    nf, gc, nb = cfg["num_feat"], cfg["num_grow_ch"], cfg["num_block"]
    out = [("conv_first", cfg["num_in_ch"], nf)]
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(1, 6):
                out.append((f"body.{i}.rdb{j}.conv{k}", nf + (k - 1) * gc, gc if k < 5 else nf))
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        out.append((name, nf, nf))
    out.append(("conv_last", nf, cfg["num_out_ch"]))
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``, drawn in one call of a
    generator on that device (``cfg["init"]``):

    - the dense-block convs: Kaiming-normal (fan_in) x ``trunk_gain``,
      basicsr's published init;
    - conv_first, conv_up1, conv_up2, conv_hr: identity centre taps on the
      first three channels plus Kaiming noise x ``noise_gain``;
    - conv_body: the same scaled by ``body_scale`` (the trunk passes its
      input through ~1.2 ** num_block times), conv_last scaled by
      ``last_scale``, so the output follows the input;
    - zero biases."""
    init = cfg["init"]
    shapes = conv_shapes(cfg)
    sizes = [9 * cin * cout for _, cin, cout in shapes]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    noise = torch.randn(sum(sizes), generator=g, device=device)
    w: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, cin, cout), n in zip(shapes, sizes):
        k = noise[off : off + n].view(3, 3, cin, cout) * math.sqrt(2.0 / (9 * cin))
        off += n
        if name.startswith("body."):
            t = k * init["trunk_gain"]
        else:
            t = k * init["noise_gain"]
            for c in range(min(3, cin, cout)):
                t[1, 1, c, c] += 1.0
            t = t * {"conv_body": init["body_scale"], "conv_last": init["last_scale"]}.get(name, 1.0)
        w[f"{name}.w"] = t
        w[f"{name}.b"] = torch.zeros(cout, device=device)
    return w


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, prec=Exact()) -> torch.Tensor:
    """(1, H, W, 3) float32 in [0, 1] -> (1, 4H, 4W, 3) float32."""

    def conv(t, name, act=False):
        y = F.conv2d(t, prec.weight(w[name + ".w"]).permute(3, 2, 0, 1), w[name + ".b"], padding=1)
        return prec.act(F.leaky_relu(y, 0.2, inplace=True) if act else y)

    t = prec.act(x.permute(0, 3, 1, 2).contiguous())
    feat = conv(t, "conv_first")
    h = feat
    for i in range(cfg["num_block"]):
        out = h
        for j in (1, 2, 3):
            feats = [out]
            for k in range(1, 5):
                feats.append(conv(torch.cat(feats, 1), f"body.{i}.rdb{j}.conv{k}", act=True))
            out = prec.act(conv(torch.cat(feats, 1), f"body.{i}.rdb{j}.conv5") * 0.2 + out)
            del feats
        h = prec.act(out * 0.2 + h)
    feat = prec.act(feat + conv(h, "conv_body"))
    del h
    feat = conv(F.interpolate(feat, scale_factor=2, mode="nearest"), "conv_up1", act=True)
    feat = conv(F.interpolate(feat, scale_factor=2, mode="nearest"), "conv_up2", act=True)
    feat = conv(feat, "conv_hr", act=True)
    return conv(feat, "conv_last").permute(0, 2, 3, 1)

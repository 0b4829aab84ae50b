"""The comparison that decides ``correct``.

After the window, the reference (``benchmark/reference``, plain PyTorch in
float32 with TF32 off, importing nothing of the program) recomputes, from
the seed alone, a sample of the frames the program streamed inside the
window: the first ``compare_frames`` frames of a shot whose frames all
reached the sink inside the window, the shot drawn from the seed. A frame
right after a hard cut depends only on the frames since the cut, so the
reference starts there: it decodes the y4m input, runs the restore step
(bilateral denoise, CLAHE on the LR frame, the model, unsharp, the
temporal EMA with its scene-cut test, BT.601 I420) on the same weights,
and its own temporal carry from the cut on. For the scene-cut test at the
cut it stands in for the previous output with its own restored previous
frame, before the EMA (``cut_margin`` says by how far the test passes).

The numbers compared, each with its limit (``limits/<cell>.json``):

- ``frame_rms``: the largest, over the compared frames, root mean square
  difference of the frame's I420 bytes (Y, U and V) from the reference's,
  in 8-bit levels;
- ``ema_gain_err``: ``|beta - 1|``, where beta is the least-squares gain of
  the program's luma deviation from the reference's frame before the EMA
  onto the reference's own EMA step, over the compared frames after the
  cut: 1 when the program blends as the reference does, 0 when it does not
  blend at all;
- ``bytes_off2_pct``, ``bytes_off3_pct``: the largest, over the compared
  frames, share of the frame's I420 bytes that differ from the
  reference's by 2 (3) levels or more, in percent: rounding in the
  configuration's bf16 moves a byte by about one level, a step below it
  (the program's W8A8 path) by more;
- ``cut_margin`` (at least its limit): how far the reference's scene-cut
  test passes at the cut, the larger of the mean delta over 2.5 times its
  threshold and the lesser of the mean delta and the histogram distance
  over theirs.

A cell compares the numbers its limits file names; ``info`` has them all,
and the two parts of the cut test apart.
"""

from __future__ import annotations

import importlib
import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness.video import Stream
from benchmark.reference import color, post
from benchmark.reference.precision import PRECISIONS

AT_LEAST = ("cut_margin",)  # numbers held to at least their limit


class ReferenceStep:
    """The restore step on one frame, plain, from the configuration and
    the traffic's step parameters."""

    def __init__(self, cfg: Dict, step: Dict, device, precision: str = "fp32"):
        self.cfg, self.p, self.device = cfg, step, device
        self.model = importlib.import_module(f"benchmark.reference.{cfg['family']}")
        self.prec = PRECISIONS[precision]()
        self.w = None

    def load_weights(self, seed: int) -> None:
        self.w = self.model.make_weights(self.cfg, seed, self.device)

    @torch.no_grad()
    def restore(self, planes) -> torch.Tensor:
        """y4m planes -> the frame after the model and the sharpen, before
        the EMA: (sH, sW, 3) float32."""
        p = self.p
        x = torch.from_numpy(color.decode_420(*planes)).to(self.device).float() * (1.0 / 255.0)
        if p["denoise"] > 0:
            sig = 50.0 * p["denoise"]
            x = post.bilateral(x, 5, sig, sig)
        if p["clahe"]:
            x = post.clahe(x, p["clahe_clip"])
        y = self.model.forward(self.w, x[None], self.cfg, self.prec)[0]
        if p["sharpen"] > 0:
            y = post.unsharp(y, p["sharpen"], p["unsharp_sigma"], p["unsharp_radius"])
        return y

    @torch.no_grad()
    def shot(self, stream: Stream, cut: int, n: int):
        """The I420 outputs of frames cut .. cut+n-1, the unrounded studio
        luma of each before and after the EMA, and the cut's test: its
        margin, and the mean delta and the histogram distance each over
        its threshold."""
        prev = post.to_u8(self.restore(stream.planes(cut - 1)))
        outs, pre, blended = [], [], []
        cut_test = None
        for t in range(cut, cut + n):
            y = self.restore(stream.planes(t))
            if t == cut:
                is_cut, md, tvd = post.cut_test(y, prev, self.p)
                thr, hthr = self.p["scene_cut_thresh"], self.p["scene_cut_hist"]
                cut_test = {"margin": max(md / (2.5 * thr), min(md / thr, tvd / hthr)),
                            "mean_delta": md / thr, "hist_distance": tvd / hthr}
                out = y if is_cut else post.ema(y, prev, self.p)
            else:
                out = post.ema(y, prev, self.p)
            prev = post.to_u8(out)
            outs.append(color.encode_i420(out).cpu())
            pre.append(color.luma_studio(torch.clamp(y, 0.0, 1.0)).cpu())
            blended.append(color.luma_studio(torch.clamp(out, 0.0, 1.0)).cpu())
            del y, out
        return outs, pre, blended, cut_test


def eligible_cuts(stream: Stream, n: int, in_window: set, kept: set) -> List[int]:
    """Cuts whose first n frames all reached the sink inside the window and
    were kept."""
    cuts = sorted({i - i % stream.shot_frames for i in in_window if i >= stream.shot_frames})
    return [c for c in cuts if all(t in in_window and t in kept for t in range(c, c + n))]


def compare(cell, seed: int, kept: Dict[int, bytes], in_window: set, device) -> Tuple[Dict, Dict]:
    """Returns (numbers, info): numbers maps each compared number's name to
    {"value", "limit"} (and "at_least" where the limit is a floor)."""
    traffic = cell.traffic
    n = int(traffic["compare_frames"])
    stream = Stream(traffic, seed)
    cuts = eligible_cuts(stream, n, in_window, set(kept))
    if not cuts:
        return {}, {"error": "no shot's first frames reached the sink inside the window"}
    cut = random.Random(seed).choice(cuts)
    h, w = output_shape(cell)
    got = [torch.frombuffer(bytearray(kept[t]), dtype=torch.uint8).reshape(h * 3 // 2, w) for t in range(cut, cut + n)]
    return judge(cell, got, reference_shot(cell, seed, stream, cut, device), cut)


def output_shape(cell) -> Tuple[int, int]:
    s = cell.config["spec"]["scale"]
    return int(cell.traffic["height"]) * s, int(cell.traffic["width"]) * s


def reference_shot(cell, seed: int, stream: Stream, cut: int, device, precision: str = "fp32"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ReferenceStep(cell.config, cell.traffic["step"], device, precision)
    ref.load_weights(seed)
    return ref.shot(stream, cut, int(cell.traffic["compare_frames"]))


def judge(cell, got: List[torch.Tensor], shot, cut: int) -> Tuple[Dict, Dict]:
    """The numbers of the frames ``got`` (I420, as streamed) against the
    reference's ``shot`` (``ReferenceStep.shot``) from the cut on."""
    outs, pre, blended, cut_test = shot
    h, w = output_shape(cell)
    rms, off2, off3, num, den = [], [], [], 0.0, 0.0
    hists = np.zeros(32)
    for k, (g, o, y_pre, y_ema) in enumerate(zip(got, outs, pre, blended)):
        d = g.double() - o.double()
        rms.append(float(d.pow(2).mean().sqrt()))
        off2.append(100.0 * float((d.abs() >= 2).double().mean()))
        off3.append(100.0 * float((d.abs() >= 3).double().mean()))
        hists += np.histogram(g[:h].numpy(), bins=32, range=(0, 256))[0]
        if k:
            gy = g[:h].double() - y_pre.double()  # the frame's luma deviation from the frame before the EMA
            ry = y_ema.double() - y_pre.double()  # the reference's own EMA step
            num += float((gy * ry).sum())
            den += float((ry * ry).sum())
    beta = num / den if den > 0 else float("nan")
    values = {
        "frame_rms": max(rms),
        "ema_gain_err": abs(beta - 1.0),
        "bytes_off2_pct": max(off2),
        "bytes_off3_pct": max(off3),
        "cut_margin": cut_test["margin"],
    }
    numbers = {}
    for name, value in values.items():
        if name in cell.limits:
            numbers[name] = {"value": value, "limit": cell.limits[name]["limit"]}
            if name in AT_LEAST:
                numbers[name]["at_least"] = True
    info = {
        "cut": cut, "frames": list(range(cut, cut + len(got))), "frame_rms": rms, "bytes_off2_pct": off2,
        "bytes_off3_pct": off3,
        "beta": beta, "cut_test": cut_test,
        "ema_rms": float(np.sqrt(den / max(1, (len(got) - 1) * h * w))),
        "luma_spread": (hists / hists.sum()).round(4).tolist(),
    }
    return numbers, info


def passed(numbers: Dict) -> bool:
    """Every number within its limit; a missing or NaN number fails."""
    def ok(v):
        x = v["value"]
        return x is not None and (x >= v["limit"] if v.get("at_least") else x <= v["limit"])

    return bool(numbers) and all(ok(v) for v in numbers.values())

"""The seeded y4m 4:2:0 stream a traffic file describes.

Shots of natural-spectrum texture (amplitude falling as 1/f^slope) with
hard-edged shapes, panned a few pixels a frame, with Gaussian sensor
noise, and a hard cut every ``shot_frames`` frames. Consecutive shots
alternate between a dark and a bright key and between opposite colour
casts, so every cut changes the frame's luma histogram and mean, as a cut
between two shots of edited film does. The keys, the contrast, the casts and
each shot's multiset of luma values are the same for every seed: a seed
changes where the texture and the shapes put them, and the noise, not how
much work a frame is.

A frame is a pure function of (traffic, seed, frame index): the feeder
that streams it and the reference that checks the output make the same
bytes. Only numpy is used.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# studio-range limits of 8-bit BT.601 planes
Y_LO, Y_HI, C_LO, C_HI = 16, 235, 16, 240


def _spectral_noise(rng: np.random.Generator, h: int, w: int, slope: float) -> np.ndarray:
    """(h, w) float32 noise, zero mean, unit std, amplitude ~ 1/f^slope."""
    white = rng.standard_normal((h, w), dtype=np.float32)
    spec = np.fft.rfft2(white)
    fy = np.fft.fftfreq(h).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(w).astype(np.float32)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec *= np.maximum(f, 1.0 / max(h, w)) ** -slope
    spec[0, 0] = 0.0
    tex = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
    tex -= tex.mean()
    tex /= tex.std() + 1e-12
    return tex


def _paint_shapes(rng: np.random.Generator, plane: np.ndarray, n: int, amp: float) -> None:
    """Adds n flat ellipses and rectangles of random size and level."""
    h, w = plane.shape
    for _ in range(n):
        sh = int(rng.integers(h // 24, h // 4))
        sw = int(rng.integers(w // 24, w // 4))
        y0 = int(rng.integers(0, h - sh))
        x0 = int(rng.integers(0, w - sw))
        level = np.float32(rng.uniform(-amp, amp))
        if rng.random() < 0.5:
            plane[y0 : y0 + sh, x0 : x0 + sw] += level
        else:
            yy = (np.arange(sh, dtype=np.float32)[:, None] - sh / 2) / (sh / 2)
            xx = (np.arange(sw, dtype=np.float32)[None, :] - sw / 2) / (sw / 2)
            plane[y0 : y0 + sh, x0 : x0 + sw] += level * (yy * yy + xx * xx <= 1.0)


def _match_values(plane: np.ndarray) -> np.ndarray:
    """The plane's values replaced, rank for rank, by one fixed sorted
    sample of a unit normal: every shot of every seed then holds the same
    multiset of luma values (a histogram-bound stage such as the program's
    luma histogram does the same work), arranged as its own texture."""
    target = np.sort(np.random.default_rng(0x7A11).standard_normal(plane.size, dtype=np.float32))
    out = np.empty(plane.size, np.float32)
    out[np.argsort(plane, axis=None, kind="stable")] = target
    return out.reshape(plane.shape)


class Stream:
    """The y4m stream of one traffic mix and seed."""

    def __init__(self, traffic: Dict, seed: int):
        self.t = traffic
        self.seed = int(seed)
        self.width = int(traffic["width"])
        self.height = int(traffic["height"])
        self.shot_frames = int(traffic["shot_frames"])
        px, py = (int(v) for v in traffic["pan_px"])
        if px % 2 or py % 2 or self.width % 2 or self.height % 2:
            raise ValueError("4:2:0 needs even sizes and even pans")
        self.pan = (py, px)
        self._shot: Tuple[int, Dict[str, np.ndarray]] = (-1, {})
        self._table = None

    def header(self) -> bytes:
        num, den = self.t["fps"]
        return (
            f"YUV4MPEG2 W{self.width} H{self.height} F{num}:{den} Ip A1:1 "
            f"C{self.t['colorspace']}\n"
        ).encode("ascii")

    def _noise(self) -> np.ndarray:
        """Sensor noise: a long table of normal values times sigma, from
        which each plane of each frame takes a run at a seeded offset
        (drawing millions of normals a frame would slow the feeder below
        the program's rate)."""
        if self._table is None:
            n = 1 << 24
            self._table = np.float32(self.t["noise_sigma"]) * np.random.default_rng([self.seed, 0x4015E]).standard_normal(
                n, dtype=np.float32)
        return self._table

    def _shot_planes(self, s: int) -> Dict[str, np.ndarray]:
        if self._shot[0] == s:
            return self._shot[1]
        tx = self.t["texture"]
        rng = np.random.default_rng([self.seed, s, 0x5107])
        py, px = self.pan
        h = self.height + py * (self.shot_frames - 1)
        w = self.width + px * (self.shot_frames - 1)
        y = _spectral_noise(rng, h, w, float(tx["slope"]))
        _paint_shapes(rng, y, int(tx["shapes"]), 2.0)
        y = _match_values(y)
        dark = s % 2 == 0
        key = tx["dark_key" if dark else "bright_key"]
        y = Y_LO + (Y_HI - Y_LO) * (key + tx["contrast"] * y)
        sign = 1.0 if dark else -1.0
        planes = {"y": y.astype(np.float32)}
        for k, name in enumerate(("u", "v")):
            c = _spectral_noise(rng, h // 2, w // 2, 2.0)
            cast = sign * (1 if k == 0 else -1) * tx["cast"]
            planes[name] = (128.0 + 224.0 * (cast + tx["chroma_amp"] * c)).astype(np.float32)
        self._shot = (s, planes)
        return planes

    def planes(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Frame i as (Y, U, V) uint8 planes."""
        s, t = divmod(i, self.shot_frames)
        sp = self._shot_planes(s)
        py, px = self.pan
        rng = np.random.default_rng([self.seed, i, 0xF4A3])
        table = self._noise()
        h, w = self.height, self.width
        out = []
        for name, (hh, ww, oy, ox, lo, hi) in (
            ("y", (h, w, t * py, t * px, Y_LO, Y_HI)),
            ("u", (h // 2, w // 2, t * py // 2, t * px // 2, C_LO, C_HI)),
            ("v", (h // 2, w // 2, t * py // 2, t * px // 2, C_LO, C_HI)),
        ):
            at = int(rng.integers(0, table.size - hh * ww))
            p = sp[name][oy : oy + hh, ox : ox + ww] + table[at : at + hh * ww].reshape(hh, ww)
            np.rint(p, out=p)
            np.clip(p, lo, hi, out=p)
            out.append(p.astype(np.uint8))
        return out[0], out[1], out[2]

    def frame(self, i: int) -> bytes:
        """Frame i as y4m bytes: the FRAME marker and its planes."""
        y, u, v = self.planes(i)
        return b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes()

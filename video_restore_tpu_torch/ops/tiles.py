"""Seamless tile engine and the full-frame model call.

Port of ``video_restore_tpu/ops/tiles.py``. The frame is padded to a static
tile grid (one plan per (H, W, tile, overlap, scale) bucket), all tiles are
cut with static slices and batched through the model (tiles are the batch
axis, optionally in fixed-size chunks to bound device memory), and the
output tiles are blended by weighted overlap-add in fp32 with a
complementary cosine-ramp window (:func:`ramp_window`: flat interior,
smooth fall-off across the overlap; adjacent ramps sum to 1). The
normalisation field is separable, so it is built from its two 1-D factors.

Modes:

- ``seamless``: overlapping tiles, the ramp window;
- ``legacy``: RealESRGANer parity, non-overlapping tile centres each cut
  with ``overlap`` pixels of real context (the leading halo of
  :func:`_pad_frame`), centre-cropped and pasted without blending.

A frame that is one exact tile (tile size 0, full-frame mode) skips the
blend: the model output is the frame. The blend and the tile cuts are plain
PyTorch on every device (in the JAX package they are XLA, not Pallas).
:func:`auto_full_frame` sizes its decision from the card's memory where the
JAX package reads JAX memory stats; :func:`auto_tile_chunk` keeps the JAX
package's fixed 2 GiB activation budget.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ramp_window(size: int, ramp: int) -> np.ndarray:
    """1-D blend window: flat 1 in the interior, smooth fall-off to ~0
    across the ``ramp`` (= overlap) pixels at each edge, adjacent ramps
    complementary (``tiles.py:51``)."""
    w = np.ones(size, dtype=np.float64)
    ramp = min(ramp, size // 2)
    if ramp > 0:
        t = (np.arange(ramp) + 0.5) / ramp  # (0, 1)
        r = 0.5 - 0.5 * np.cos(np.pi * t)  # smooth 0 -> 1
        w[:ramp] = r
        w[size - ramp :] = r[::-1]
    return np.maximum(w, 1e-4)


@dataclasses.dataclass(frozen=True)
class _Axis:
    """Static tiling plan along one spatial axis."""

    dim: int  # original frame extent
    extract: int  # model input extent for this axis
    offsets: Tuple[int, ...]
    padded: int  # padded frame extent
    lead: int  # leading context pad (legacy halo)

    @staticmethod
    def build(
        dim: int, tile: int, stride: int, halo: int, mod: int,
        even: bool = True,
    ) -> "_Axis":
        extract = tile + 2 * halo
        if extract >= dim + 2 * halo:
            # single tile along this axis: snap extract to the frame
            extract = _round_up(dim, mod)
            return _Axis(dim, extract, (0,), extract, 0)
        covered = dim + 2 * halo
        n = math.ceil((covered - extract) / stride) + 1
        if even:
            # Treat ``tile`` as a *budget*: shrink the extract so the n
            # tiles exactly cover the frame with (at least) the requested
            # overlap, instead of overlapping by whatever a fixed stride
            # leaves over. 1080p/tile512/ov32 drops from 12x512^2 to
            # 12x384x504 tile pixels. Extents are rounded to 8 (also
            # satisfies the scale-2 mod-2 requirement).
            overlap = extract - stride
            extract = min(
                extract,
                _round_up(math.ceil((covered + (n - 1) * overlap) / n), 8),
            )
            span = covered - extract
            offsets = tuple(round(i * span / (n - 1)) for i in range(n))
            return _Axis(dim, extract, offsets, covered, halo)
        # legacy (RealESRGANer) semantics: fixed stride, pad past the edge
        padded = (n - 1) * stride + extract
        return _Axis(
            dim, extract, tuple(i * stride for i in range(n)), padded, halo
        )

    def window(self, scale: int, mode: str, halo: int, overlap: int = 0) -> np.ndarray:
        es = self.extract * scale
        if len(self.offsets) == 1:
            return np.ones(es)
        if mode == "legacy":
            w = np.full(es, 1e-6)  # ~hard paste: halo contamination < 1e-6
            h = halo * scale
            w[h : es - h if h else es] = 1.0
            return w
        return ramp_window(es, overlap * scale)

    def norm(self, scale: int, mode: str, halo: int, overlap: int = 0) -> np.ndarray:
        w = self.window(scale, mode, halo, overlap)
        n = np.zeros(self.padded * scale)
        for o in self.offsets:
            n[o * scale : o * scale + len(w)] += w
        return n


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static tiling plan for one (H, W) resolution bucket."""

    height: int
    width: int
    tile: int
    overlap: int
    scale: int
    mode: str = "seamless"  # 'seamless' | 'legacy'
    tile_chunk: int = 0  # >0: run tiles through the model in chunks
    rows: _Axis = None  # type: ignore[assignment]
    cols: _Axis = None  # type: ignore[assignment]
    halo: int = 0

    @staticmethod
    def build(
        height: int,
        width: int,
        tile: int,
        overlap: int,
        scale: int,
        mode: str = "seamless",
        tile_chunk: int = 0,
    ) -> "TileGrid":
        if mode not in ("seamless", "legacy"):
            raise ValueError(f"unknown tile mode {mode!r}")
        if tile == 0:
            # no tiling (RealESRGANer tile=0): one frame-sized tile per
            # axis — the _Axis single-tile snap covers the frame exactly
            # and the blend collapses to an identity crop.
            tile = _round_up(max(height, width), 2)
        # mod-pad granularity: scale-2 RRDBNet pixel-unshuffles the input by 2
        mod = 2
        if mode == "legacy":
            halo = _round_up(overlap, mod)
            stride = tile
        else:
            halo = 0
            stride = max(tile - overlap, mod)
        even = mode == "seamless"
        rows = _Axis.build(height, tile, stride, halo, mod, even)
        cols = _Axis.build(width, tile, stride, halo, mod, even)
        return TileGrid(
            height=height,
            width=width,
            tile=tile,
            overlap=overlap,
            scale=scale,
            mode=mode,
            tile_chunk=tile_chunk,
            rows=rows,
            cols=cols,
            halo=halo,
        )

    @property
    def n_tiles(self) -> int:
        return len(self.rows.offsets) * len(self.cols.offsets)

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return (self.rows.extract, self.cols.extract)

    @property
    def n_chunks(self) -> int:
        """Model calls per frame (``_chunked_apply``)."""
        c = self.tile_chunk
        return 1 if c <= 0 or c >= self.n_tiles else math.ceil(self.n_tiles / c)


def auto_tile_chunk(
    extract_h: int,
    extract_w: int,
    scale: int,
    n_tiles: int,
    budget_bytes: int = 2 << 30,
    feat_ch: int = 64,
) -> int:
    """Tiles per model call so that the dominant activation (``feat_ch``
    channels at output resolution, bf16) stays within ``budget_bytes``
    (``tiles.py:198``); 0 = all tiles in one call. Prefers a divisor of
    ``n_tiles``: a non-divisor pads the last chunk with dead tiles."""
    per_tile = extract_h * extract_w * scale * scale * feat_ch * 2
    chunk = max(1, budget_bytes // max(per_tile, 1))
    if chunk >= n_tiles:
        return 0
    for c in range(int(chunk), 0, -1):
        if n_tiles % c == 0:
            return c
    return int(chunk)


def device_budget(total_bytes: int) -> int:
    """The device bytes that :func:`auto_full_frame` sizes against:
    ``VRT_HBM_BYTES`` when it is set to digits (a cap on a shared card; JAX
    ``ops/tiles.py:242-246``), else the device's ``total_bytes``."""
    env = os.environ.get("VRT_HBM_BYTES")
    return int(env) if env and env.isdigit() else total_bytes


def auto_full_frame(
    height: int,
    width: int,
    scale: int,
    device_bytes: Optional[int] = None,
    feat_ch: int = 64,
    frames: int = 1,
    tail_in_memory: bool = False,
    value_bytes: int = 2,
) -> bool:
    """Whether a full-frame (tile=0) pass fits device memory:
    :func:`full_frame_bytes` against half the device's memory.
    ``device_bytes`` defaults to :func:`device_budget` of the current CUDA
    device's total memory."""
    if device_bytes is None:
        device_bytes = device_budget(torch.cuda.mem_get_info()[1])
    est = full_frame_bytes(height, width, scale, feat_ch, frames, tail_in_memory, value_bytes)
    return est <= 0.5 * device_bytes


def full_frame_bytes(
    height: int,
    width: int,
    scale: int,
    feat_ch: int = 64,
    frames: int = 1,
    tail_in_memory: bool = False,
    value_bytes: int = 2,
) -> int:
    """The estimate behind :func:`auto_full_frame`: ~5 body feature buffers
    (bf16), the upconv1 output at 2x resolution, and ~3 output-resolution
    RGB fp32 buffers per frame (``tiles.py:222-271``; the RRDB estimate,
    which dominates SRVGG's). That is the JAX estimate, whose tail keeps
    upconv2's and conv_hr's outputs on chip. ``tail_in_memory`` adds those
    two ``feat_ch``-channel tensors at output resolution (bf16, ``2 x 16 hw
    x feat_ch x 2`` bytes at scale 4), which the three-launch tail
    (``ops/tail.py::tail_fused``) writes to device memory. ``value_bytes``:
    the bytes of a feature value in the compute dtype (2: bf16, the JAX
    estimate; 4: ``--precision fp32``, whose features and tail tensors take
    twice the bytes); the RGB buffers are fp32 either way."""
    hw = height * width
    body = 5 * hw * feat_ch * value_bytes
    up1 = 4 * hw * feat_ch * value_bytes
    out_rgb = 3 * (scale * scale * hw) * 3 * 4
    tail = 2 * (scale * scale * hw) * feat_ch * value_bytes if tail_in_memory else 0
    return (body + up1 + out_rgb + tail) * max(frames, 1)


def _pad_frame(x: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Reflect-pad (N, H, W, C) to the grid's padded extent, or edge-pad
    when a pad is not smaller than the frame (``tiles.py:274-287``); legacy
    mode adds a leading halo of real context."""
    r, c = grid.rows, grid.cols
    top, bottom = r.lead, r.padded - r.dim - r.lead
    left, right = c.lead, c.padded - c.dim - c.lead
    if not (top or bottom or left or right):
        return x
    big = max(top, bottom, left, right)
    mode = "reflect" if big < min(r.dim, c.dim) else "replicate"
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), mode=mode)
    return xp.permute(0, 2, 3, 1)


def _extract_tiles(xp: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(N, pad_h, pad_w, C) -> (N, n_tiles, Eh, Ew, C), contiguous."""
    eh, ew = grid.tile_shape
    tiles = [
        xp[:, r : r + eh, c : c + ew, :]
        for r in grid.rows.offsets
        for c in grid.cols.offsets
    ]
    return torch.stack(tiles, dim=1)


def _blend_tiles(out_tiles: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(N, n_tiles, Eh*s, Ew*s, C) -> (N, H*s, W*s, C), fp32 overlap-add
    (``tiles.py:301-341``), contiguous: the sharpen kernel reads whole rows
    (a legacy grid's crop of the canvas is strided)."""
    s = grid.scale
    n, c = out_tiles.shape[0], out_tiles.shape[-1]
    dev = out_tiles.device

    def vec(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    wr = vec(grid.rows.window(s, grid.mode, grid.halo, grid.overlap))
    wc = vec(grid.cols.window(s, grid.mode, grid.halo, grid.overlap))
    w2d = (wr[:, None] * wc[None, :])[None, :, :, None]
    canvas = torch.zeros(
        (n, grid.rows.padded * s, grid.cols.padded * s, c),
        dtype=torch.float32, device=dev,
    )
    ehs, ews = grid.rows.extract * s, grid.cols.extract * s
    idx = 0
    for r in grid.rows.offsets:
        for col in grid.cols.offsets:
            canvas[:, r * s : r * s + ehs, col * s : col * s + ews, :] += (
                out_tiles[:, idx].float() * w2d
            )
            idx += 1
    nr = vec(grid.rows.norm(s, grid.mode, grid.halo, grid.overlap))
    nc = vec(grid.cols.norm(s, grid.mode, grid.halo, grid.overlap))
    canvas /= (nr[:, None] * nc[None, :])[None, :, :, None]
    top, left = grid.rows.lead * s, grid.cols.lead * s
    return canvas[:, top : top + grid.height * s, left : left + grid.width * s, :].contiguous()


def _chunked_apply(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    tiles: torch.Tensor,
    chunk: int,
) -> torch.Tensor:
    """Apply the model over the tile batch, in fixed-size chunks of
    ``chunk`` tiles (one model call each, the last zero-padded to full
    size, ``tiles.py:344-362``) when ``0 < chunk < len(tiles)``."""
    b = tiles.shape[0]
    if chunk <= 0 or chunk >= b:
        return model_fn(tiles)
    nb = _round_up(b, chunk)
    if nb != b:
        pad = tiles.new_zeros((nb - b,) + tuple(tiles.shape[1:]))
        tiles = torch.cat([tiles, pad], dim=0)
    out = torch.cat(
        [model_fn(tiles[i : i + chunk]) for i in range(0, nb, chunk)], dim=0
    )
    return out[:b]


def tiled_apply(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    frames: torch.Tensor,
    grid: TileGrid,
    tile_sharding=None,
) -> torch.Tensor:
    """Upscale (N, H, W, C) frames (any float dtype: the model runs in the
    frames' dtype) through the tiled model; returns (N, H*scale, W*scale, C)
    fp32, blended in fp32; in full-frame mode under ``VRT_POST_DT=bf16``,
    the model's output in its own dtype.

    ``tile_sharding``: spatial parallelism, all devices cooperating on one
    frame's tiles (``tiles.py:364-400``, where it is a ``NamedSharding`` of
    the tile axis): an object with ``n_parts`` that is called with the
    flattened tile batch of all N frames, zero-padded to a multiple of
    ``n_parts`` and split into that many contiguous parts, and returns each
    part's model output on the frames' device
    (``parallel/dispatch.py::TileShards`` runs part d on device d). Each
    part is one model call, as each device's share of the JAX program is;
    ``tile_chunk`` does not apply, and ``model_fn`` is not called."""
    n = frames.shape[0]
    tiles = _extract_tiles(_pad_frame(frames, grid), grid)  # (N, T, Eh, Ew, C)
    flat = tiles.reshape((n * grid.n_tiles,) + tuple(tiles.shape[2:]))
    if tile_sharding is not None:
        d = tile_sharding.n_parts
        nb = _round_up(flat.shape[0], d)
        if nb != flat.shape[0]:
            flat = torch.cat([flat, flat.new_zeros((nb - flat.shape[0],) + tuple(flat.shape[1:]))])
        k = nb // d
        out = torch.cat(tile_sharding([flat[i * k : (i + 1) * k] for i in range(d)]))
        out = out[: n * grid.n_tiles]
    else:
        out = _chunked_apply(model_fn, flat, grid.tile_chunk)
    out = out.reshape((n, grid.n_tiles) + tuple(out.shape[1:]))
    r, c = grid.rows, grid.cols
    if grid.n_tiles == 1 and r.padded == r.dim and c.padded == c.dim:
        # full-frame mode: one exact tile, all-ones window — no canvas.
        # VRT_POST_DT=bf16 keeps the model's dtype into the post stack
        # (tiles.py:408-413, read at call time); the default is fp32
        if os.environ.get("VRT_POST_DT") == "bf16":
            return out[:, 0]
        return out[:, 0].float()
    return _blend_tiles(out, grid)

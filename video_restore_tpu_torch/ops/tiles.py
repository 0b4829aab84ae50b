"""Tile grid and the full-frame model call.

Port of ``video_restore_tpu/ops/tiles.py``: ``TileGrid.build`` is copied
(the same static plan per (H, W, tile, overlap, scale) bucket), and
:func:`tiled_apply` ports the full-frame branch (``tiles.py:398-412``): the
frame, padded to the grid's single tile, goes through the model once and
the fp32 result is cropped to the frame. A grid with more than one tile
raises: seamless tiling with overlap-add blending is not yet ported.
:func:`auto_full_frame` sizes the full-frame decision from
``torch.cuda.mem_get_info`` instead of JAX memory stats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
            # 12x384x504 tile pixels — 1.36x less model compute. Extents
            # are rounded to 8 (sublane granule; also satisfies the
            # scale-2 mod-2 requirement).
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


def auto_full_frame(
    height: int,
    width: int,
    scale: int,
    device_bytes: Optional[int] = None,
    feat_ch: int = 64,
    frames: int = 1,
) -> bool:
    """Whether a full-frame (tile=0) pass fits device memory: ~5 body
    feature buffers (bf16), the upconv1 output at 2x resolution, and ~3
    output-resolution RGB fp32 buffers, against half the device's memory
    (``tiles.py:222-271``). ``device_bytes`` defaults to the current CUDA
    device's total memory."""
    if device_bytes is None:
        device_bytes = torch.cuda.mem_get_info()[1]
    hw = height * width
    body = 5 * hw * feat_ch * 2
    up1 = 4 * hw * feat_ch * 2
    out_rgb = 3 * (scale * scale * hw) * 3 * 4
    est = (body + up1 + out_rgb) * max(frames, 1)
    return est <= 0.5 * device_bytes


def tiled_apply(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    frames: torch.Tensor,
    grid: TileGrid,
) -> torch.Tensor:
    """Upscale (N, H, W, C) frames through the model on ``grid``'s single
    tile; returns (N, H*scale, W*scale, C) fp32. The frame is padded to the
    tile extent (reflect, or edge when the pad is not smaller than the
    frame, as ``_pad_frame``) and the output cropped back."""
    if grid.n_tiles != 1:
        raise NotImplementedError(
            f"{grid.n_tiles}-tile grid: seamless tiling not yet ported "
            "(use tile size 0 / full frame)"
        )
    r, c = grid.rows, grid.cols
    ph, pw = r.padded - r.dim, c.padded - c.dim
    x = frames
    if ph or pw:
        mode = "reflect" if max(ph, pw) < min(r.dim, c.dim) else "replicate"
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode)
        x = x.permute(0, 2, 3, 1).contiguous()
    out = model_fn(x)
    s = grid.scale
    return out[:, : grid.height * s, : grid.width * s].float()

"""The fused restoration step on one GPU.

Port of ``video_restore_tpu/parallel/dispatch.py:54-407``: uint8 frames in,
uint8 frames out, with the enhancement stack around the model::

    u8 -> f32/255 -> [bilateral] -> [CLAHE on LR] -> compute dtype ->
    model (full frame or tiles, fp32 out) -> [unsharp] -> [temporal EMA] ->
    u8 RGB, or planar I420 (``yuv420_out``: 1.5 bytes a pixel, no host
    colour work)

The dtype flow is the JAX step's: bilateral and CLAHE in fp32, the model in
the compute dtype (bf16: fp32 sums inside each kernel, bf16 between
kernels; the tiles of a tiled grid are cut in that dtype), fp32 from the
model's exit on (``tiled_apply`` blends the tiles in fp32). The model is
either family, through ``ModelHandle.module``. The temporal EMA carries an
explicit ``{frame, valid}`` pair (an all-black previous frame is still a
previous frame) with one carry shard, so the carry is exactly sequential
(gap 1); ``lax.scan`` over the frames becomes a Python loop. A scene cut
(mean luma delta above ``scene_cut_thresh`` confirmed by a luma-histogram
change above ``scene_cut_hist``, or a delta above 2.5x the threshold on its
own) passes the new frame through untouched.

:class:`Upscaler` is the one-GPU counterpart of ``ShardedUpscaler``
(``process_batch``, ``stage``, ``warmup``, ``reset_temporal``); multi-GPU
frame sharding is not ported yet. Where JAX feeds and fetches
asynchronously, the Upscaler copies through rings of pinned host buffers
(:class:`PinnedRing`): ``stage`` for the frames in, ``fetch`` for the
results out, each copy ``non_blocking`` on the current stream with a CUDA
event recorded after it, and no slot reused before its event has passed.
On an H100 a copy stream of its own for ``fetch`` gained nothing: the copy
of an 8K frame's planes takes ~1.2 ms, and a loop of flagship frames ran no
faster with it (``chip_smoke.py``'s ``[post]`` line compares the two).
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from video_restore_tpu_torch.config import RestoreConfig
from video_restore_tpu_torch.models.zoo import ModelHandle
from video_restore_tpu_torch.ops.color import quantize_u8, rgb_to_yuv420_planar
from video_restore_tpu_torch.ops.post import bilateral_filter, clahe, unsharp_mask
from video_restore_tpu_torch.ops.tiles import TileGrid, tiled_apply
from video_restore_tpu_torch.ops.unsharp import unsharp_fused


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The slice of RestoreConfig that shapes the step (``dispatch.py:54``)."""

    denoise: float = 0.0
    sharpen: float = 0.0
    color_enhance: bool = False
    clahe_clip: float = 2.0
    clahe_lr: bool = True  # CLAHE on the LR input (16x cheaper than at 4K)
    temporal: bool = False
    temporal_strength: float = 0.3
    scene_cut_thresh: float = 0.12  # mean |delta| (0-1 units) => hard reset
    scene_cut_hist: float = 0.35  # luma-hist TV distance => hard reset (0=off)
    yuv420_out: bool = False  # emit planar I420 on the device (halves D2H)
    dither: bool = False  # ordered-dithered 8-bit quantization

    @staticmethod
    def from_config(cfg: RestoreConfig) -> "StepConfig":
        if not cfg.enhanced_mode:
            # explicit --denoise/--sharpen strengths are honoured even
            # without --enhanced; the enhanced flag adds CLAHE + temporal
            return StepConfig(
                denoise=cfg.denoise, sharpen=cfg.sharpen, dither=cfg.dither
            )
        return StepConfig(
            denoise=cfg.denoise,
            sharpen=cfg.sharpen,
            color_enhance=cfg.color_enhance,
            clahe_clip=cfg.clahe_clip,
            clahe_lr=cfg.clahe_lr,
            temporal=cfg.temporal,
            temporal_strength=cfg.temporal_strength,
            scene_cut_thresh=cfg.scene_cut_thresh,
            scene_cut_hist=cfg.scene_cut_hist,
            dither=cfg.dither,
        )


_HIST_BINS = 32


def _luma_hist(x: torch.Tensor) -> torch.Tensor:
    """Soft-binned luma histogram: (..., H, W, 3) float 0-1 ->
    (..., _HIST_BINS) normalized, each pixel's unit mass split between its
    two nearest bins by a triangular kernel (``dispatch.py:96-114``).
    Computed as a two-bin scatter instead of the JAX form's dense
    (pixels x bins) weights; the same sums in another order."""
    luma = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    pos = torch.clamp(
        torch.clamp(luma.float(), 0.0, 1.0) * _HIST_BINS - 0.5,
        0.0, _HIST_BINS - 1.0,
    )  # edge clamp: boundary pixels keep full mass in the edge bin
    lead = pos.shape[:-2]
    pos = pos.reshape(-1, pos.shape[-2] * pos.shape[-1])
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=_HIST_BINS - 1)
    hist = torch.zeros(pos.shape[0], _HIST_BINS, device=x.device)
    hist.scatter_add_(1, lo, 1.0 - frac)
    hist.scatter_add_(1, hi, torch.where(lo + 1 < _HIST_BINS, frac, 0.0))
    return (hist / pos.shape[1]).reshape(lead + (_HIST_BINS,))


def restore_step(
    frames_u8: torch.Tensor,
    carry: Dict[str, torch.Tensor],
    *,
    model_apply: Callable[[torch.Tensor], torch.Tensor],
    grid: TileGrid,
    step_cfg: StepConfig,
    compute_dtype: torch.dtype,
    plain: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, H, W, 3) uint8 -> (B, H*s, W*s, 3) uint8 + temporal carry, or
    with ``step_cfg.yuv420_out`` (B, H*s*3//2, W*s) uint8 planar I420.

    carry: {"frame": (1, H*s, W*s, 3) uint8, the last output frame;
    "valid": (1,) float32, 1 once there is a previous frame}. ``plain``
    runs the sharpen stage's plain version instead of kernel K2 (the model
    path is chosen by ``model_apply``)."""
    x = frames_u8.float() * (1.0 / 255.0)
    if step_cfg.denoise > 0:
        # cv2.bilateralFilter(frame, 5, 25, 25) at strength 0.5
        sig = 50.0 * step_cfg.denoise
        x = bilateral_filter(x, 5, sig, sig)
    if step_cfg.color_enhance and step_cfg.clahe_lr:
        x = clahe(x, step_cfg.clahe_clip)

    x = x.to(compute_dtype)
    y = tiled_apply(model_apply, x, grid)  # fp32

    if step_cfg.color_enhance and not step_cfg.clahe_lr:
        y = clahe(y, step_cfg.clahe_clip)
    if step_cfg.sharpen > 0:
        sharpen = unsharp_mask if plain else unsharp_fused
        y = sharpen(y, amount=step_cfg.sharpen, sigma=1.5, radius=4)

    if step_cfg.temporal:
        cf = carry["frame"][0].to(y.dtype) * (1.0 / 255.0)
        valid = carry["valid"][0].to(y.dtype)
        use_hist = step_cfg.scene_cut_hist > 0
        if use_hist:
            h_all = _luma_hist(y)
            ch = _luma_hist(cf)
        outs = []
        for t in range(y.shape[0]):
            fr = y[t]
            diff = torch.abs(fr - cf).mean(dim=-1, keepdim=True)
            # gap is 1 with one carry shard: w = s * exp(-diff / 0.05)
            w = step_cfg.temporal_strength * torch.exp(-diff * (1.0 / 0.05))
            w = w * (valid if t == 0 else 1.0)
            mdelta = diff.mean(dtype=torch.float32)
            if use_hist:
                tvd = 0.5 * torch.abs(h_all[t] - ch).sum()
                cut = (
                    (mdelta > step_cfg.scene_cut_thresh)
                    & (tvd > step_cfg.scene_cut_hist)
                ) | (mdelta > 2.5 * step_cfg.scene_cut_thresh)
                ch = h_all[t]
            else:
                cut = mdelta > step_cfg.scene_cut_thresh
            w = torch.where(cut, 0.0, w)
            cf = (1.0 - w) * fr + w * cf
            outs.append(cf)
        y = torch.stack(outs)
        new_carry = {
            "frame": torch.clamp(torch.round(cf * 255.0), 0, 255)
            .to(torch.uint8)[None],
            "valid": torch.ones(1, device=y.device),
        }
    else:
        new_carry = carry
    if step_cfg.yuv420_out:
        return (
            rgb_to_yuv420_planar(torch.clamp(y, 0.0, 1.0), dither=step_cfg.dither),
            new_carry,
        )
    return quantize_u8(y, dither=step_cfg.dither), new_carry


class _Slot:
    """One host buffer of a :class:`PinnedRing` and the event recorded
    after the copy that last used it (None: no copy pending)."""

    __slots__ = ("buf", "event")

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None
        self.event = None


class PinnedRing:
    """A ring of ``depth`` host buffers for asynchronous copies between
    the host and the card: pinned when ``pin`` (a ``non_blocking`` copy from
    or to pageable memory is synchronous), plain on the CPU.

    ``acquire`` hands out a free slot, blocking until one is released, in
    the order the slots were released; before it returns a slot it waits on
    the event of the copy that last used it, so no copy's buffer is
    refilled or read early. ``release`` returns a slot with the event of a
    copy still in flight, or None."""

    def __init__(self, depth: int, pin: bool):
        self.pin = pin
        self.depth = max(depth, 1)
        self._free: queue.Queue = queue.Queue()
        for _ in range(self.depth):
            self._free.put(_Slot())

    def acquire(self, shape, dtype: torch.dtype) -> _Slot:
        slot = self._free.get()
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        shape = torch.Size(shape)
        if slot.buf is None or slot.buf.shape != shape or slot.buf.dtype != dtype:
            slot.buf = torch.empty(shape, dtype=dtype, pin_memory=self.pin)
        return slot

    def release(self, slot: _Slot, event=None) -> None:
        slot.event = event
        self._free.put(slot)

    def reserve(self, shape, dtype: torch.dtype) -> None:
        """Give every slot a buffer of ``shape`` now, waiting for each slot
        to be free: a pinned allocation is slow (51.0 ms for an 8K frame's
        49.8 MB of planes beside an NVIDIA H100 80GB HBM3, ``PERF.md``)."""
        slots = [self.acquire(shape, dtype) for _ in range(self.depth)]
        for slot in slots:
            self.release(slot)


class Fetched:
    """A result on its way to the host: a slot of the fetch ring and the
    event after its copy. ``wait`` returns the host array (valid until
    ``release``); ``release`` gives the slot back once the array has been
    written out."""

    def __init__(self, ring: PinnedRing, slot: _Slot, event):
        self._ring, self._slot, self._event = ring, slot, event

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._slot.buf.numpy()

    def release(self) -> None:
        self._ring.release(self._slot)


class Upscaler:
    """The restore step for one resolution bucket on one device.

    ``plain=True`` runs the plain PyTorch versions of every kernel (the
    reference the kernel path is checked against on the GPU)."""

    def __init__(
        self,
        model: ModelHandle,
        grid: TileGrid,
        cfg: RestoreConfig,
        device: torch.device,
        plain: bool = False,
        yuv420_out: bool = False,
    ):
        self.device = torch.device(device)
        self.grid = grid
        self.scale = grid.scale
        self.step_cfg = dataclasses.replace(
            StepConfig.from_config(cfg), yuv420_out=yuv420_out
        )
        self.yuv420_out = yuv420_out
        # int8 selects the W8A8 body; the activations between kernels stay
        # bf16 (dispatch.py:300-312 of the JAX package)
        self.compute_dtype = (
            torch.float32 if cfg.precision == "fp32" else torch.bfloat16
        )
        self.plain = plain
        self.net = model.module(self.compute_dtype, self.device, cfg.precision)
        self._carry = None
        # the feed ring holds max_inflight_batches batches; the fetch ring
        # one more, the batch the encode thread is writing
        pin = self.device.type == "cuda"
        depth = max(cfg.max_inflight_batches, 1)
        self._feed = PinnedRing(depth, pin)
        self._fetch = PinnedRing(depth + 1, pin)

    @property
    def frames_per_batch(self) -> int:
        return 1

    def reset_temporal(self) -> None:
        self._carry = None

    def _init_carry(self) -> Dict[str, torch.Tensor]:
        hs = self.grid.height * self.scale
        ws = self.grid.width * self.scale
        return {
            "frame": torch.zeros((1, hs, ws, 3), dtype=torch.uint8, device=self.device),
            "valid": torch.zeros((1,), device=self.device),
        }

    def stage(self, frames_u8) -> torch.Tensor:
        """Place a (B, H, W, 3) uint8 batch on the device: on a CUDA device
        through a slot of the pinned feed ring, the copy ``non_blocking`` on
        the current stream; on the CPU the batch itself."""
        if isinstance(frames_u8, torch.Tensor) and frames_u8.device == self.device:
            return frames_u8
        if self.device.type != "cuda":
            return torch.as_tensor(np.ascontiguousarray(frames_u8))
        a = np.asarray(frames_u8)
        slot = self._feed.acquire(a.shape, torch.uint8)
        slot.buf.numpy()[...] = a
        x = slot.buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._feed.release(slot, event)
        return x

    def fetch(self, out: torch.Tensor) -> Fetched:
        """Start the copy of a result to the host, into a slot of the fetch
        ring (blocking until one is free), ``non_blocking`` on the stream
        that computed it, so the caller may drop ``out`` at once."""
        slot = self._fetch.acquire(out.shape, out.dtype)
        slot.buf.copy_(out, non_blocking=True)
        event = None
        if out.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(out.device))
        return Fetched(self._fetch, slot, event)

    @torch.no_grad()
    def process_batch(self, frames_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 (numpy or tensor) -> (B, H*s, W*s, 3) uint8 on
        the device, or (B, H*s*3//2, W*s) planar I420 with ``yuv420_out``.
        Returns once the work is queued; reading the result (``.cpu()``,
        :meth:`fetch`) waits for it."""
        if self._carry is None:
            self._carry = self._init_carry()
        x = self.stage(frames_u8)
        plain = self.plain
        out, self._carry = restore_step(
            x, self._carry,
            model_apply=lambda t: self.net(t, plain=plain),
            grid=self.grid,
            step_cfg=self.step_cfg,
            compute_dtype=self.compute_dtype,
            plain=plain,
        )
        return out

    def warmup(self, fetch_shape=None) -> None:
        """Run the step once on a zero frame (builds the kernels and warms
        the allocator), then reset the temporal carry; with ``fetch_shape``,
        size every slot of the fetch ring for uint8 results of that shape."""
        x = np.zeros((1, self.grid.height, self.grid.width, 3), np.uint8)
        self.process_batch(x).cpu()
        self.reset_temporal()
        if fetch_shape is not None:
            self._fetch.reserve(fetch_shape, torch.uint8)

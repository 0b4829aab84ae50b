"""The fused restoration step, on one device or sharded over several.

Port of ``video_restore_tpu/parallel/dispatch.py:54-407``: uint8 frames in,
uint8 frames out, with the enhancement stack around the model::

    u8 -> f32/255 -> [bilateral] -> [CLAHE on LR] -> compute dtype ->
    model (full frame or tiles, fp32 out) -> [unsharp] -> [temporal EMA] ->
    u8 RGB, or planar I420 (``yuv420_out``: 1.5 bytes a pixel, no host
    colour work)

The dtype flow is the JAX step's: bilateral and CLAHE in fp32, the model in
the compute dtype (bf16: fp32 sums inside each kernel, bf16 between
kernels; the tiles of a tiled grid are cut in that dtype), fp32 from the
model's exit on (``tiled_apply`` blends the tiles in fp32). With
``VRT_POST_DT=bf16`` (read at call time, ``ops/tiles.py``) a full-frame
step keeps the model's dtype to the end: K2's bf16 instance, the EMA in
bf16 with its statistics reduced in fp32, and the quantisers on the bf16
frame, operation for operation as JAX's (``dispatch.py:182-258``). The model is
either family, through ``ModelHandle.module``. The temporal EMA carries an
explicit ``{frame, valid}`` pair per carry shard (an all-black previous
frame is still a previous frame); ``lax.scan`` over the frames becomes a
Python loop. With one carry shard the carry is exactly sequential (gap 1);
with ``n_shards`` chunks each chunk's first frame is B - k + 1 frames from
its carry, and the motion gate is that many times stricter
(``dispatch.py:15-26``). A scene cut (mean luma delta above
``scene_cut_thresh`` confirmed by a luma-histogram change above
``scene_cut_hist``, or a delta above 2.5x the threshold on its own) passes
the new frame through untouched.

:class:`Upscaler` is the step on one device (``process_batch``, ``stage``,
``warmup``, ``reset_temporal``); :class:`ShardedUpscaler` runs it over a
device list (``parallel/mesh.py::frame_mesh``) in shard mode ``frames`` (a
chunk of each batch per device, each device's work in a dispatch thread of
its own) or ``tiles`` (each frame's tile batch split over the devices,
:class:`TileShards`). Where JAX feeds and fetches asynchronously, the
Upscaler copies through rings of pinned host buffers (:class:`PinnedRing`):
``stage`` for the frames in, ``fetch`` for the results out, each copy
``non_blocking`` on the current stream with a CUDA event recorded after it,
and no slot reused before its event has passed. On an H100 a copy stream of
its own for ``fetch`` gained nothing: the copy of an 8K frame's planes takes
~1.2 ms, and a loop of flagship frames ran no faster with it
(``chip_smoke.py``'s ``[post]`` line compares the two).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from video_restore_tpu_torch.config import RestoreConfig
from video_restore_tpu_torch.models.zoo import ModelHandle
from video_restore_tpu_torch.ops.color import quantize_u8, rgb_to_yuv420_planar, weak
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
    (pixels x bins) weights; the same sums in another order. The luma and
    the bin position are computed in x's dtype and only then widened, as in
    JAX (``dispatch.py:102-110``): a bf16 position above 16 has a step of
    0.125, so the rounding point moves the weights."""
    dt = x.dtype
    luma = weak(0.299, dt) * x[..., 0] + weak(0.587, dt) * x[..., 1] + weak(0.114, dt) * x[..., 2]
    pos = torch.clamp(
        torch.clamp(luma, 0.0, 1.0) * _HIST_BINS - 0.5,
        0.0, _HIST_BINS - 1.0,
    ).float()  # edge clamp: boundary pixels keep full mass in the edge bin
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
    n_shards: int = 1,
    gap0: Optional[float] = None,
    tile_sharding: Optional[TileShards] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(B, H, W, 3) uint8 -> (B, H*s, W*s, 3) uint8 + temporal carry, or
    with ``step_cfg.yuv420_out`` (B, H*s*3//2, W*s) uint8 planar I420.

    The batch is ``n_shards`` contiguous chunks of k = B / n_shards frames,
    each with its own carry row (``dispatch.py:117-274``). carry: {"frame":
    (n_shards, H*s, W*s, 3) uint8, each chunk's last output frame; "valid":
    (n_shards,) float32, 1 once the chunk has a previous frame}. A chunk's
    first frame is ``gap0`` frames from its carry (default B - k + 1, which
    is 1 with one shard: exactly sequential), and the motion gate's length
    scale is divided by that gap; the chunk's later frames have gap 1.
    ``tile_sharding`` splits each model call's tile batch over devices
    (``ops/tiles.py::tiled_apply``). ``plain`` runs the sharpen stage's
    plain version instead of kernel K2 (the model path is chosen by
    ``model_apply``)."""
    x = frames_u8.float() * (1.0 / 255.0)
    if step_cfg.denoise > 0:
        # cv2.bilateralFilter(frame, 5, 25, 25) at strength 0.5
        sig = 50.0 * step_cfg.denoise
        x = bilateral_filter(x, 5, sig, sig)
    if step_cfg.color_enhance and step_cfg.clahe_lr:
        x = clahe(x, step_cfg.clahe_clip)

    x = x.to(compute_dtype)
    # fp32; at full frame under VRT_POST_DT=bf16, the model's dtype
    y = tiled_apply(model_apply, x, grid, tile_sharding=tile_sharding)

    if step_cfg.color_enhance and not step_cfg.clahe_lr:
        y = clahe(y, step_cfg.clahe_clip)
    if step_cfg.sharpen > 0:
        sharpen = unsharp_mask if plain else unsharp_fused
        y = sharpen(y, amount=step_cfg.sharpen, sigma=1.5, radius=4)

    if step_cfg.temporal:
        b = y.shape[0]
        if b % n_shards:
            raise ValueError(f"restore_step: batch {b} not divisible by {n_shards} shards")
        k = b // n_shards
        if gap0 is None:
            gap0 = float(b - k + 1)
        outs, lasts = [], []
        for d in range(n_shards):
            out, last = _ema_chunk(
                y[d * k : (d + 1) * k], carry["frame"][d], carry["valid"][d], gap0, step_cfg
            )
            outs.append(out)
            lasts.append(torch.clamp(torch.round(last * 255.0), 0, 255).to(torch.uint8))
        y = outs[0] if n_shards == 1 else torch.cat(outs)
        new_carry = {
            "frame": torch.stack(lasts),
            "valid": torch.ones(n_shards, device=y.device),
        }
    else:
        new_carry = carry
    if step_cfg.yuv420_out:
        return (
            rgb_to_yuv420_planar(torch.clamp(y, 0.0, 1.0), dither=step_cfg.dither),
            new_carry,
        )
    return quantize_u8(y, dither=step_cfg.dither), new_carry


def _ema_chunk(
    y: torch.Tensor, frame: torch.Tensor, valid: torch.Tensor, gap0: float, step_cfg: StepConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The temporal EMA over one chunk's k frames (``lax.scan`` over its
    time axis becomes a Python loop), from its carry row (``frame`` (H*s,
    W*s, 3) uint8, ``valid`` a 0-d flag); returns the k blended frames and
    the last one, unquantised. The blends run in y's dtype (bf16 under
    ``VRT_POST_DT=bf16``, each constant rounded to it as JAX's weak typing
    does); the frame's mean delta reduces in fp32 and is then rounded to
    y's dtype (``dispatch.py:229-231``), the histograms in fp32."""
    dt = y.dtype
    cf = frame.to(dt) * weak(1.0 / 255.0, dt)
    use_hist = step_cfg.scene_cut_hist > 0
    if use_hist:
        h_all = _luma_hist(y)
        ch = _luma_hist(cf)
    outs = []
    for t in range(y.shape[0]):
        fr = y[t]
        diff = torch.abs(fr - cf).mean(dim=-1, keepdim=True)
        # displacement-invariant gate: a gap-frames-old carry must be gap
        # times more static to blend at the same weight
        gap = gap0 if t == 0 else 1.0
        rate = weak(weak(gap, dt) / weak(0.05, dt), dt)  # JAX: gap.astype(fr.dtype) / 0.05
        w = weak(step_cfg.temporal_strength, dt) * torch.exp(-diff * rate)
        w = w * (valid.to(dt) if t == 0 else 1.0)
        mdelta = diff.mean(dtype=torch.float32).to(dt)
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
    return torch.stack(outs), cf


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
    """A batch's result on its way to the host: one slot of a fetch ring
    (held by a :class:`_BatchSlot`) and one copy into it per slice of the
    batch, still in flight: the event after the copy (None on the CPU), or
    the future of the dispatch thread that makes the slice and copies it,
    whose result is that event. ``wait`` returns the host array (valid
    until ``release``), raising if a slice's job failed; ``release`` gives
    the slot back once the array has been written out (or dropped)."""

    def __init__(self, ring: PinnedRing, slot: _BatchSlot, copies):
        self._ring, self._slot, self._copies = ring, slot, list(copies)

    def _events(self, skip_failed: bool = False):
        for c in self._copies:
            if isinstance(c, Future):
                if skip_failed and c.exception() is not None:
                    continue
                c = c.result()
            if c is not None:
                yield c

    def wait(self) -> np.ndarray:
        for event in self._events():
            event.synchronize()
        return self._slot.slot.buf.numpy()

    def release(self) -> None:
        for event in self._events(skip_failed=True):  # no copy may still write into the slot
            event.synchronize()
        if self._slot.slot is not None:
            self._ring.release(self._slot.slot)


class _BatchSlot:
    """The one fetch slot that a batch's result is copied into, slice by
    slice, taken from the ring by the first slice that is ready (its shape
    is known only then, after any face pass or resize); the dispatch
    threads of several frame shards may copy at once."""

    def __init__(self, ring: PinnedRing, batch: int):
        self._ring, self._batch = ring, batch
        self._lock = threading.Lock()
        self.slot: Optional[_Slot] = None

    def copy(self, out: torch.Tensor, lo: int):
        """Start the copy of ``out``, frames ``lo`` on of the batch, into
        the slot, ``non_blocking`` on the current stream; returns the event
        after it (None on the CPU)."""
        with self._lock:
            if self.slot is None:
                shape = (self._batch,) + tuple(out.shape[1:])
                self.slot = self._ring.acquire(shape, out.dtype)
            buf = self.slot.buf
        buf[lo : lo + out.shape[0]].copy_(out, non_blocking=True)
        if not out.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return event


class _DeviceWorker:
    """The dispatch thread of one shard: runs its jobs in order, under its
    device and, on a GPU, a stream of its own, so that one device's full
    launch queue never stalls the others."""

    def __init__(self, device: torch.device, name: str):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        with contextlib.ExitStack() as ctx:
            if self.stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self.stream))
            ctx.enter_context(torch.no_grad())  # grad mode is per thread
            while True:
                item = self._q.get()
                if item is None:
                    return
                fut, fn, args = item
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn(*args))
                except BaseException as e:  # surfaced by the future
                    fut.set_exception(e)

    def close(self) -> None:
        self._q.put(None)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


def _close_workers(workers) -> None:
    """Stop the dispatch threads and wait for them to end. The wait matters
    at interpreter exit, where this runs as an ``atexit`` finalizer: a
    daemon thread woken there would still be leaving its CUDA contexts when
    the interpreter finalizes, and a thread stopped inside PyTorch's C++
    code aborts the process ("terminate called without an active
    exception")."""
    for w in workers:
        w.close()
    for w in workers:
        w.join(timeout=60)


class TileShards:
    """Spatial parallelism for ``tiled_apply`` (JAX's ``tile_sharding``, a
    ``NamedSharding`` of the tile axis; ``tiles.py:364-400``): part d of a
    tile batch runs through ``applies[d]`` (device d's model replica) on
    ``devices[d]``; part 0 on the calling thread, part d > 0 in
    ``workers[d - 1]``, its device's dispatch thread, after an event that
    marks the tiles ready on the caller's stream. Each result comes back to
    the frames' device, and the caller's stream waits for it before the
    blend."""

    def __init__(self, applies, devices, workers):
        self.applies, self.devices, self.workers = list(applies), list(devices), list(workers)
        self.n_parts = len(self.applies)

    def __call__(self, parts):
        home = parts[0].device
        ready = None
        if home.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(home))
        futs = [self.workers[d - 1].submit(self._part, d, parts[d], ready) for d in range(1, self.n_parts)]
        outs = [self.applies[0](parts[0])]
        for fut in futs:
            out, done = fut.result()
            if done is not None:
                stream = torch.cuda.current_stream(home)
                stream.wait_event(done)
                out.record_stream(stream)  # made on the worker's stream
            outs.append(out)
        return outs

    def _part(self, d: int, part: torch.Tensor, ready):
        """Device d's part, on its dispatch thread (its stream current)."""
        dev = self.devices[d]
        if ready is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            part.record_stream(stream)  # read here, freed on the caller's stream
        out = self.applies[d](part.to(dev, non_blocking=True)).to(part.device, non_blocking=True)
        done = None
        if out.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return out, done


class Upscaler:
    """The restore step for one resolution bucket on one device.

    ``plain=True`` runs the plain PyTorch versions of every kernel (the
    reference the kernel path is checked against on the GPU). As one of a
    :class:`ShardedUpscaler`'s frame shards, ``shard_group`` is the number
    of shards: the first frame of each batch is then ``(shard_group - 1) * k
    + 1`` frames from the carry (k frames per shard), as in one
    ``restore_step(n_shards=shard_group)`` call. ``tile_sharding``, where a
    :class:`ShardedUpscaler` in tiles mode sets it, is given to every model
    call (:class:`TileShards`)."""

    def __init__(
        self,
        model: ModelHandle,
        grid: TileGrid,
        cfg: RestoreConfig,
        device: torch.device,
        plain: bool = False,
        yuv420_out: bool = False,
        shard_group: int = 1,
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
        self.shard_group = shard_group
        self.tile_sharding: Optional[TileShards] = None
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
        slot = _BatchSlot(self._fetch, out.shape[0])
        return Fetched(self._fetch, slot, [slot.copy(out, 0)])

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
        gap0 = None
        if self.shard_group > 1:
            gap0 = float((self.shard_group - 1) * x.shape[0] + 1)
        out, self._carry = restore_step(
            x, self._carry,
            model_apply=lambda t: self.net(t, plain=plain),
            grid=self.grid,
            step_cfg=self.step_cfg,
            compute_dtype=self.compute_dtype,
            plain=plain,
            gap0=gap0,
            tile_sharding=self.tile_sharding,
        )
        return out


def _unstaged(name: str):
    return contextlib.nullcontext()


class ShardedUpscaler:
    """The restore step for one resolution bucket over a device list
    (``dispatch.py:277-407``), in the config's ``shard_mode``:

    - ``frames``: ``frames_per_batch`` is D. A batch of B frames is split
      into D contiguous chunks of k; device d's dispatch thread runs the
      step on chunk d with its own model replica, stream, pinned feed ring
      and carry row, the chunk's first frame ``B - k + 1`` frames from its
      carry (the stale carry of the JAX package's D > 1, ``ROADMAP.md``
      queue 3), then ``post`` and the copy of its result into its slice of
      one pinned host buffer: results never gather through device 0;
    - ``tiles``: ``frames_per_batch`` is 1 and there is one carry, so the
      temporal EMA is exactly sequential. Device 0 runs the step on the
      caller's thread; each model call's tile batch is padded to a multiple
      of D and split into D parts, part d run by device d's replica
      (:class:`TileShards`; a dispatch thread for each device but the
      first), the tiles brought back to device 0 for the blend.

    With one shard (one device, or tiles mode) the step, ``post`` and the
    copy run on the caller's thread, under device 0. A batch that D does not
    divide raises. ``mesh`` is a device list (``parallel/mesh.py::
    frame_mesh``), by default ``frame_mesh(cfg.num_devices)``; it may name
    one device several times (a shard each)."""

    def __init__(
        self,
        model: ModelHandle,
        grid: TileGrid,
        cfg: RestoreConfig,
        mesh: Optional[Sequence[torch.device]] = None,
        *,
        plain: bool = False,
        yuv420_out: bool = False,
        cpu: bool = False,
    ):
        from video_restore_tpu_torch.parallel.mesh import frame_mesh

        self.devices = list(mesh) if mesh is not None else frame_mesh(cfg.num_devices, cpu=cpu)
        self.n_devices = len(self.devices)
        self.grid = grid
        self.shard_mode = cfg.shard_mode
        self._cfg_frames_per_batch = max(cfg.frames_per_batch, 1)
        workers = []
        if self.shard_mode == "tiles":
            self._batch = 1
            home = Upscaler(model, grid, cfg, self.devices[0], plain, yuv420_out)
            if self.n_devices > 1:
                workers = [_DeviceWorker(d, f"tiles-{i}") for i, d in enumerate(self.devices[1:], 1)]
                nets = [home.net] + [
                    model.module(home.compute_dtype, d, cfg.precision) for d in self.devices[1:]
                ]
                home.tile_sharding = TileShards(
                    [lambda t, n=n: n(t, plain=plain) for n in nets], self.devices, workers
                )
            self.shards = [home]
        else:
            self._batch = self.n_devices
            self.shards = [
                Upscaler(model, grid, cfg, d, plain, yuv420_out, shard_group=self.n_devices)
                for d in self.devices
            ]
            if self.n_devices > 1:
                workers = [_DeviceWorker(d, f"dispatch-{i}") for i, d in enumerate(self.devices)]
        # the frame shards' dispatch threads (none with one shard)
        self._workers = workers if len(self.shards) > 1 else []
        self._close = weakref.finalize(self, _close_workers, list(workers))
        self.step_cfg = self.shards[0].step_cfg
        # the fetch ring holds max_inflight_batches batches, and one more:
        # the batch the encode thread is writing
        self._fetch = PinnedRing(
            max(cfg.max_inflight_batches, 1) + 1, self.devices[0].type == "cuda"
        )

    @property
    def frames_per_batch(self) -> int:
        return self._batch

    def close(self) -> None:
        """Stop the dispatch threads and wait for them (also done when the
        upscaler is collected, and at interpreter exit)."""
        self._close()

    def reset_temporal(self) -> None:
        for up in self.shards:
            up.reset_temporal()

    def run(self, frames_u8, post: Optional[Callable] = None, stage: Callable = _unstaged) -> Fetched:
        """Queue a (B, H, W, 3) uint8 batch, B divisible by
        ``frames_per_batch``: the step, then ``post(out, lo)`` on each
        shard's output (``lo``: the batch index of its first frame; the face
        pass and the resize), then the copy to the host. ``stage(name)``
        times the caller's share: with one shard the step (``"dispatch"``),
        with several the hand-over to the dispatch threads, which return at
        once."""
        b = len(frames_u8)
        if b % self._batch:
            raise ValueError(
                f"batch {b} not divisible by {self._batch} "
                f"({self.shard_mode}-sharded over {self.n_devices} devices)"
            )
        slot = _BatchSlot(self._fetch, b)
        if not self._workers:
            dev = self.devices[0]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                copies = [self._shard_job(self.shards[0], frames_u8, post, 0, slot, stage)]
        else:
            k = b // self.n_devices
            with stage("dispatch"):
                copies = [
                    w.submit(self._shard_job, up, frames_u8[d * k : (d + 1) * k], post, d * k, slot)
                    for d, (w, up) in enumerate(zip(self._workers, self.shards))
                ]
        return Fetched(self._fetch, slot, copies)

    @staticmethod
    def _shard_job(up: Upscaler, chunk, post, lo: int, slot: _BatchSlot, stage: Callable = _unstaged):
        """One shard's part of a batch: the step, ``post``, and the copy
        into its slice of the batch's slot; returns the event after the
        copy (None on the CPU)."""
        with stage("dispatch"):
            out = up.process_batch(chunk)
        if post is not None:
            out = post(out, lo)
        return slot.copy(out, lo)

    def process_batch(self, frames_u8) -> torch.Tensor:
        """The whole batch's result on the host (a CPU tensor), each shard's
        fetched from its own device: :meth:`run`, waited for."""
        fetched = self.run(frames_u8)
        try:
            return torch.from_numpy(fetched.wait().copy())
        finally:
            fetched.release()

    def warmup(self, fetch_shape=None) -> None:
        """Run the step once on a zero batch of the pipeline's size (builds
        the kernels and warms the allocator), then reset the temporal
        carries; with ``fetch_shape``, size every slot of the fetch ring for
        uint8 results of that shape."""
        b = self._batch * self._cfg_frames_per_batch
        self.process_batch(np.zeros((b, self.grid.height, self.grid.width, 3), np.uint8))
        self.reset_temporal()
        if fetch_shape is not None:
            self._fetch.reserve(fetch_shape, torch.uint8)

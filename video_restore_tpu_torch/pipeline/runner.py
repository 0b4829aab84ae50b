"""Pipeline orchestrator: decode -> restore on the device -> ordered encode.

Port of ``video_restore_tpu/pipeline/runner.py`` for one file at a time
(``VideoRestorer.process_video``):

- one decode thread feeding a bounded queue (backpressure);
- the dispatch loop on the caller's thread queues each batch on the device
  and returns at once (CUDA launches are asynchronous);
- one encode thread copies results to the host (that copy waits for the
  device) and writes them in dispatch order, so no reorder buffer exists;
- frame accounting (decoded == inferred == encoded) is checked at the end,
  and per-stage wall-clock totals land in ``last_stats``.

Not ported yet: batch directories, segmented resume, face restoration,
on-device YUV output, Lanczos ``outscale`` resizing and audio muxing (the
y4m and npz containers carry no audio).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from video_restore_tpu_torch.config import RestoreConfig
from video_restore_tpu_torch.models.rrdbnet import RRDBNetSpec, tail_mode
from video_restore_tpu_torch.models.zoo import ModelHandle, get_model
from video_restore_tpu_torch.ops.tiles import (
    TileGrid,
    auto_full_frame,
    auto_tile_chunk,
)
from video_restore_tpu_torch.parallel.dispatch import Upscaler
from video_restore_tpu_torch.pipeline.progress import Progress
from video_restore_tpu_torch.utils.device import resolve_device
from video_restore_tpu_torch.utils.logging import get_logger
from video_restore_tpu_torch.video import open_reader, open_writer, probe

log = get_logger()

_SENTINEL = object()


@dataclasses.dataclass
class PipelineStats:
    decoded: int = 0
    inferred: int = 0
    encoded: int = 0
    wall_s: float = 0.0
    # per-stage wall-clock totals (decode-wait / dispatch / fetch / encode)
    stages: dict = dataclasses.field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.encoded / self.wall_s if self.wall_s > 0 else 0.0


class StageTimer:
    """Accumulates wall-clock per pipeline stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()  # the dispatch and encode threads both time

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.totals[name] += time.perf_counter() - t0


class _DecodeThread(threading.Thread):
    """Producer: reader -> bounded queue (backpressure)."""

    def __init__(self, reader, q: queue.Queue):
        super().__init__(daemon=True, name="decode")
        self.reader = reader
        self.q = q
        self.decoded = 0
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    def run(self) -> None:
        try:
            for frame in self.reader:
                if self._stop_event.is_set():
                    break
                self.q.put(frame)
                self.decoded += 1
        except BaseException as e:  # surfaced by the consumer
            self.error = e
        finally:
            self.q.put(_SENTINEL)

    def stop(self) -> None:
        self._stop_event.set()
        try:  # drain so a blocked put() can finish
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


class _EncodeThread(threading.Thread):
    """Consumer: copies device results to the host and writes them, off the
    dispatch thread, in dispatch order through a bounded FIFO."""

    def __init__(self, drain_fn, depth: int):
        super().__init__(daemon=True, name="encode")
        self.q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self.drain_fn = drain_fn
        self.error: Optional[BaseException] = None
        self._abandoned = threading.Event()

    def run(self) -> None:
        while True:
            item = self.q.get()
            if item is _SENTINEL:
                break
            if self.error is not None or self._abandoned.is_set():
                continue  # drain the queue without processing
            try:
                self.drain_fn(item)
            except BaseException as e:
                self.error = e

    def submit(self, item) -> None:
        self.q.put(item)

    def finish(self) -> None:
        self.q.put(_SENTINEL)
        self.join()

    def abandon(self) -> None:
        self._abandoned.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.q.put(_SENTINEL)
        self.join(timeout=30)


class VideoRestorer:
    """End-to-end restorer for one device. The model stays resident across
    videos. Runs on the current CUDA device unless ``cpu=True``; without a
    GPU and without ``cpu=True`` it raises."""

    def __init__(
        self,
        config: RestoreConfig,
        model: Optional[ModelHandle] = None,
        *,
        cpu: bool = False,
    ):
        self.config = config
        self.device = resolve_device(cpu)
        if model is None:
            import os

            model = get_model(
                config.model_name,
                config.models_dir,
                allow_random=os.environ.get("VRT_ALLOW_RANDOM_WEIGHTS") == "1",
            )
        self.model = model
        if model.scale != config.scale:
            if config.outscale == float(config.scale):
                config.outscale = float(model.scale)
            config.scale = model.scale
        self._upscalers: Dict[tuple, Upscaler] = {}
        self.last_stats: Optional[PipelineStats] = None
        log.info(
            "model=%s scale=%dx device=%s tile=%d precision=%s enhanced=%s",
            model.name, model.scale, self.device, config.tile_size,
            config.precision, config.enhanced_mode,
        )

    def _upscaler_for(self, height: int, width: int) -> Upscaler:
        """The restore step for one resolution bucket (``runner.py:194-276``
        of the JAX package): full frame when ``full_frame`` is "on", or
        "auto" and the frame fits the card (``auto_full_frame``); else the
        tile grid, with ``tile_chunk`` tiles per model call (0 = auto).
        Legacy tiling and shard mode "tiles" always tile. On the CPU, with
        no device memory to size against, "auto" keeps the tiles, as the
        JAX package does without its TPU body kernels."""
        key = (height, width)
        if key not in self._upscalers:
            cfg = self.config
            tile = cfg.tile_size
            if tile != 0 and not cfg.legacy_tiling and cfg.shard_mode != "tiles":
                if cfg.full_frame == "on":
                    tile = 0
                elif (
                    cfg.full_frame == "auto"
                    and self.device.type == "cuda"
                    and auto_full_frame(
                        height, width, self.model.scale,
                        torch.cuda.mem_get_info(self.device)[1],
                        frames=max(cfg.frames_per_batch, 1),
                        tail_in_memory=self._tail_in_memory(),
                    )
                ):
                    tile = 0
                    log.info(
                        "full-frame mode: %dx%d fits device memory, tiling "
                        "disabled (full_frame=off restores tiles)",
                        width, height,
                    )
            grid = TileGrid.build(
                height, width, tile=tile, overlap=cfg.tile_overlap,
                scale=self.model.scale,
                mode="legacy" if cfg.legacy_tiling else "seamless",
            )
            chunk = cfg.tile_chunk or auto_tile_chunk(
                grid.rows.extract, grid.cols.extract, grid.scale, grid.n_tiles,
            )
            grid = dataclasses.replace(grid, tile_chunk=chunk)
            log.debug(
                "bucket %dx%d: %d tiles of %s, %d per model call", width,
                height, grid.n_tiles, grid.tile_shape, chunk or grid.n_tiles,
            )
            self._upscalers[key] = Upscaler(self.model, grid, cfg, self.device)
        return self._upscalers[key]

    def _tail_in_memory(self) -> bool:
        """Whether the model's tail writes its two 4x-resolution
        intermediates to device memory: an RRDBNet on the three-launch
        ``"chain"`` tail; not the one-launch ``"q"`` tail, not SRVGG."""
        return tail_mode(self.device) == "chain" and isinstance(
            self.model.spec, RRDBNetSpec
        )

    def process_video(
        self,
        input_path: Union[str, Path],
        output_path: Union[str, Path],
        *,
        show_progress: bool = True,
    ) -> bool:
        """Restore one video; returns success."""
        t0 = time.time()
        try:
            stats = self._run(input_path, output_path, show_progress)
        except KeyboardInterrupt:
            log.warning("interrupted — output finalized with partial frames")
            return False
        except Exception:
            log.exception("pipeline failed for %s", input_path)
            return False
        stats.wall_s = time.time() - t0
        self.last_stats = stats
        log.info(
            "done: %d frames in %.1fs (%.3f fps)",
            stats.encoded, stats.wall_s, stats.fps,
        )
        if not (stats.decoded == stats.inferred == stats.encoded):
            log.error(
                "frame accounting mismatch: decoded=%d inferred=%d encoded=%d",
                stats.decoded, stats.inferred, stats.encoded,
            )
            return False
        return True

    def _run(self, input_path, output_path, show_progress) -> PipelineStats:
        cfg = self.config
        from video_restore_tpu_torch.video.y4m import is_pipe

        if is_pipe(input_path):
            reader = open_reader(input_path)  # a stream's header is its probe
            info = reader.info
        else:
            info = probe(input_path)
            reader = None
        scale = self.model.scale
        if cfg.outscale != float(scale):
            raise NotImplementedError(
                "outscale resizing (host Lanczos) is not yet ported"
            )
        out_w, out_h = info.width * scale, info.height * scale
        log.info(
            "input %dx%d -> output %dx%d  (%d frames @ %.2f fps)",
            info.width, info.height, out_w, out_h, info.frames, info.fps,
        )
        ups = self._upscaler_for(info.height, info.width)
        ups.reset_temporal()
        batch = ups.frames_per_batch * max(cfg.frames_per_batch, 1)
        stats = PipelineStats()

        if reader is None:
            reader = open_reader(input_path)
        q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_frames, batch))
        decoder = _DecodeThread(reader, q)
        decoder.start()
        writer = open_writer(output_path, out_w, out_h, info.fps)
        progress = Progress(info.frames, enabled=show_progress)
        timer = StageTimer()

        def drain_one(item):
            out, valid = item
            with timer.stage("fetch"):
                arr = out.cpu().numpy()  # waits for the device
            stats.inferred += valid
            with timer.stage("encode"):
                for f in arr[:valid]:
                    writer.write(f)
            stats.encoded += valid
            progress.update(valid)

        enc = _EncodeThread(drain_one, depth=cfg.max_inflight_batches)
        enc.start()
        pending: List[np.ndarray] = []
        eof = False
        try:
            while not eof or pending:
                with timer.stage("decode-wait"):
                    while not eof and len(pending) < batch:
                        item = q.get()
                        if item is _SENTINEL:
                            eof = True
                            if decoder.error:
                                raise RuntimeError(
                                    f"decode failed: {decoder.error}"
                                ) from decoder.error
                            break
                        pending.append(item)
                if pending and (len(pending) == batch or eof):
                    valid = len(pending)
                    frames = pending + [pending[-1]] * (batch - valid)
                    pending = []
                    with timer.stage("dispatch"):
                        out = ups.process_batch(np.stack(frames))
                    enc.submit((out, valid))
                if enc.error is not None:
                    raise RuntimeError(f"encode failed: {enc.error}") from enc.error
            enc.finish()
            if enc.error is not None:
                raise RuntimeError(f"encode failed: {enc.error}") from enc.error
        finally:
            if enc.is_alive():
                enc.abandon()
            decoder.stop()
            decoder.join(timeout=10)
            writer.close()
            progress.close()
            reader.close()
        stats.stages = dict(timer.totals)
        stats.decoded = decoder.decoded
        return stats

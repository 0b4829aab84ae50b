"""Pipeline orchestrator: decode -> restore on the device -> ordered encode.

Port of ``video_restore_tpu/pipeline/runner.py`` (``process_video``,
``process_batch_dir``):

- one decode thread feeding a bounded queue (backpressure);
- the dispatch loop on the caller's thread queues each batch on the device
  and returns at once (CUDA launches are asynchronous), then starts the
  result's copy into a pinned host slot (``ShardedUpscaler.run``); over
  several devices (``--devices N``, ``frame_mesh``) each batch holds
  ``frames_per_batch`` x ``--frames-per-batch`` frames and each device's
  dispatch thread runs its chunk, its face pass and resize, and its copy
  into its slice of the slot;
- one encode thread waits for each copy and writes the frames in dispatch
  order, so no reorder buffer exists; a slot goes back to the ring once
  its frames are written;
- where the sink takes planar I420 (y4m, the ffmpeg pipe) the step emits it
  on the device (``_yuv_eligible``): half the bytes to fetch and no host
  colour work;
- resume: a y4m output is trimmed to its last whole frame and appended to,
  other containers resume from their recorded segments (``--segment-frames``);
  a progress manifest beside the output tracks the frames done;
- ``--face-enhance``: faces are detected on the LR frames in a thread pool
  while the device runs the step; the dispatch loop waits for a batch's
  boxes (the ``faces`` stage) and runs the face pass (the GFPGAN prior, or
  the region heuristic without its weights) on the step's uint8 RGB output
  on the device, before the fetch;
- ``--outscale``: the Lanczos4 resize to the requested size, after the
  face pass and also on the device (the ``resize`` stage), with cv2's
  coefficients and rounding (``ops/resample.py``);
- the source's audio is muxed into the output through ffmpeg when neither
  end is a pipe;
- frame accounting (decoded == inferred == encoded) is checked at the end,
  and per-stage wall-clock totals land in ``last_stats``;
- ``--profile DIR`` traces each video's run with ``torch.profiler``
  (``utils/profiling.py::device_trace``), where the JAX runner traces it
  with ``jax.profiler`` (``runner.py:310``);
- the multi-host batch (``--multihost``, ``runner.py:720-759``): under a
  process group of several processes each takes its round-robin share of
  the sorted videos, and one gather of ``[ok, mine]`` makes every process
  report the global result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from video_restore_tpu_torch.config import RestoreConfig
from video_restore_tpu_torch.models.rrdbnet import RRDBNetSpec, tail_mode
from video_restore_tpu_torch.models.zoo import ModelHandle, get_model
from video_restore_tpu_torch.ops.tail import default_tail_route
from video_restore_tpu_torch.ops.tiles import (
    TileGrid,
    auto_full_frame,
    auto_tile_chunk,
    device_budget,
)
from video_restore_tpu_torch.parallel.dispatch import ShardedUpscaler
from video_restore_tpu_torch.parallel.mesh import frame_mesh
from video_restore_tpu_torch.pipeline.progress import Progress
from video_restore_tpu_torch.utils.logging import get_logger
from video_restore_tpu_torch.utils.profiling import StageTimer, device_trace
from video_restore_tpu_torch.video import (
    copy_audio,
    open_reader,
    open_writer,
    probe,
)

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


class _DecodeThread(threading.Thread):
    """Producer: reader -> bounded queue (backpressure)."""

    def __init__(self, reader, q: queue.Queue, skip: int = 0):
        super().__init__(daemon=True, name="decode")
        self.reader = reader
        self.q = q
        self.skip = skip  # frames already in the output (resume)
        self.decoded = 0
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    def run(self) -> None:
        try:
            for i, frame in enumerate(self.reader):
                if self._stop_event.is_set():
                    break
                if i < self.skip:
                    continue
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
    """Consumer: waits for each result's copy to the host and writes it, off
    the dispatch thread, in dispatch order through a bounded FIFO.
    ``discard_fn`` gets each item that is dropped unwritten (after an error,
    or when abandoned), so that the item's host slot goes back to its
    ring."""

    def __init__(self, drain_fn, depth: int, discard_fn=None):
        super().__init__(daemon=True, name="encode")
        self.q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self.drain_fn = drain_fn
        self.discard_fn = discard_fn or (lambda item: None)
        self.error: Optional[BaseException] = None
        self._abandoned = threading.Event()

    def run(self) -> None:
        while True:
            item = self.q.get()
            if item is _SENTINEL:
                break
            if self.error is not None or self._abandoned.is_set():
                self.discard_fn(item)  # drain the queue without processing
                continue
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
                item = self.q.get_nowait()
                if item is not _SENTINEL:
                    self.discard_fn(item)
        except queue.Empty:
            pass
        self.q.put(_SENTINEL)
        self.join(timeout=30)


class VideoRestorer:
    """End-to-end restorer over a device list (``mesh``, by default
    ``frame_mesh(config.num_devices)``: this process's GPUs). The model
    stays resident across videos. Runs on the GPUs unless ``cpu=True``;
    without a GPU and without ``cpu=True`` it raises."""

    def __init__(
        self,
        config: RestoreConfig,
        model: Optional[ModelHandle] = None,
        mesh=None,
        *,
        cpu: bool = False,
    ):
        self.config = config
        self.mesh = list(mesh) if mesh is not None else frame_mesh(config.num_devices, cpu=cpu)
        self.device = self.mesh[0]
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
        self._upscalers: Dict[tuple, ShardedUpscaler] = {}  # (H, W, yuv) bucket
        self._probe_cache: Dict[str, object] = {}  # str(path) -> VideoInfo
        # the GFPGAN crop restorer of each device, loaded at its first face
        # pass (False: the weights are missing)
        self._gfpgan: Dict[torch.device, object] = {}
        self._gfpgan_lock = threading.Lock()
        self.last_stats: Optional[PipelineStats] = None
        log.info(
            "model=%s scale=%dx devices=%d (%s) tile=%d overlap=%d precision=%s "
            "enhanced=%s shard_mode=%s",
            model.name, model.scale, len(self.mesh), self.device, config.tile_size,
            config.tile_overlap, config.precision, config.enhanced_mode, config.shard_mode,
        )

    def _upscaler_for(
        self, height: int, width: int, yuv_out: bool = False
    ) -> ShardedUpscaler:
        """The restore step for one bucket ``(height, width, yuv_out)``
        (``runner.py:194-276`` of the JAX package): full frame when
        ``full_frame`` is "on", or "auto" and the frame fits the smallest
        card of the mesh (``auto_full_frame``, against ``VRT_HBM_BYTES``
        where it is set); else the tile grid, with
        ``tile_chunk`` tiles per model call (0 = auto). Legacy tiling and
        shard mode "tiles" always tile. On the CPU, with no device memory
        to size against, "auto" keeps the tiles, as the JAX package does
        without its TPU body kernels."""
        key = (height, width, yuv_out)
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
                        device_budget(min(torch.cuda.mem_get_info(d)[1] for d in self.mesh)),
                        frames=max(cfg.frames_per_batch, 1),
                        tail_in_memory=self._tail_in_memory(),
                        value_bytes=self._value_bytes(),
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
            self._upscalers[key] = ShardedUpscaler(
                self.model, grid, cfg, self.mesh, yuv420_out=yuv_out
            )
        return self._upscalers[key]

    def _yuv_eligible(self, output_path, info, out_w: int, out_h: int) -> bool:
        """Emit planar I420 on the device when the sink takes it directly
        (``runner.py:278-296``): RGB when ``device_yuv`` is "off", with
        faces or a host resize, with H % 4 or W % 2, or for an RGB-only
        writer (npz, OpenCV)."""
        cfg = self.config
        if cfg.device_yuv == "off":
            return False
        if cfg.face_enhance:
            return False
        scale = self.model.scale
        if out_w != info.width * scale or out_h != info.height * scale:
            return False  # a host resize needs RGB
        if out_h % 4 or out_w % 2:
            return False
        from video_restore_tpu_torch.video.backends import writer_supports_yuv420

        return writer_supports_yuv420(output_path)

    def _value_bytes(self) -> int:
        """Bytes of a feature value in the compute dtype, as
        ``auto_full_frame`` counts them: 4 at ``--precision fp32``, else 2
        (bf16; the int8 body's activations are bf16 too)."""
        return 4 if self.config.precision == "fp32" else 2

    def _tail_in_memory(self) -> bool:
        """Whether the model's tail writes its two 4x-resolution
        intermediates to device memory: an RRDBNet whose ``"chain"`` tail
        (:func:`tail_mode`) runs as three K1 launches, which is where
        ``ops/tail.py::default_tail_route`` does not take it in one launch:
        fp32 at any width (its one launch serves ``VRT_TAIL_Q=1`` only) and
        bf16 at a width other than 64. The one-launch tails keep both on
        chip, and SRVGG has none."""
        spec = self.model.spec
        if not isinstance(spec, RRDBNetSpec) or tail_mode(self.device) == "q":
            return False
        dtype = torch.float32 if self.config.precision == "fp32" else torch.bfloat16
        return default_tail_route(dtype, spec.num_feat) == "chain"

    def process_video(
        self,
        input_path: Union[str, Path],
        output_path: Union[str, Path],
        *,
        show_progress: bool = True,
    ) -> bool:
        """Restore one video; returns success. With ``config.trace_dir``
        (``--profile DIR``) the run is traced into ``DIR/trace.json``."""
        t0 = time.time()
        try:
            with device_trace(self.config.trace_dir):
                stats = self._run(input_path, output_path, show_progress)
        except KeyboardInterrupt:
            log.warning("interrupted — output finalized with partial frames")
            return False
        except Exception:
            log.exception("pipeline failed for %s", input_path)
            return False
        stats.wall_s = time.time() - t0
        self.last_stats = stats
        n = len(self.mesh)
        log.info(
            "done: %d frames in %.1fs (%.3f fps, %.3f fps/device)",
            stats.encoded, stats.wall_s, stats.fps, stats.fps / n,
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

        pipe_in = is_pipe(input_path)
        pipe_out = is_pipe(output_path)
        if pipe_in:
            reader = open_reader(input_path)  # a stream's header is its probe
            info = reader.info
        else:
            # a batch's prewarm probed it already
            info = self._probe_cache.pop(str(input_path), None)
            if info is None:
                info = probe(input_path)
        scale = self.model.scale
        out_w = int(info.width * cfg.outscale)
        out_h = int(info.height * cfg.outscale)
        log.info(
            "input %dx%d -> output %dx%d  (%d frames @ %.2f fps)",
            info.width, info.height, out_w, out_h, info.frames, info.fps,
        )
        use_yuv = self._yuv_eligible(output_path, info, out_w, out_h)
        ups = self._upscaler_for(info.height, info.width, yuv_out=use_yuv)
        ups.reset_temporal()
        batch = ups.frames_per_batch * max(cfg.frames_per_batch, 1)

        # resume bookkeeping (a stream has no past to resume into)
        if pipe_in or pipe_out:
            skip, manifest_path = 0, None
        else:
            skip, manifest_path = self._resume_state(
                output_path, out_w, out_h, info.fps
            )
        stats = PipelineStats()
        # before any file is opened: "gfpgan" without its weights raises
        face_pass = self._face_pass() if cfg.face_enhance else None

        if not pipe_in:
            reader = open_reader(input_path)
        q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_frames, batch))
        decoder = _DecodeThread(reader, q, skip=skip)
        decoder.start()
        writer = self._open_writer(
            output_path, out_w, out_h, info.fps,
            pix_fmt="yuv420p" if use_yuv else "rgb24",
        )
        write = writer.write_yuv420 if use_yuv else writer.write
        progress = Progress(info.frames, enabled=show_progress)
        if skip:
            progress.update(skip)
        timer = StageTimer()
        # detection runs on the host (OpenCV or numpy), overlapping the step
        face_pool = None
        if face_pass is not None:
            from concurrent.futures import ThreadPoolExecutor

            from video_restore_tpu_torch.ops.faces import detect_faces

            face_pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4), thread_name_prefix="faces"
            )
        resize = self._resizer(out_w, out_h, scale, info)

        def drain_one(item):
            fetched, valid = item
            try:
                with timer.stage("fetch"):
                    arr = fetched.wait()  # the copy to the pinned slot
                stats.inferred += valid
                with timer.stage("encode"):
                    for f in arr[:valid]:
                        write(f)
            finally:
                fetched.release()
            stats.encoded += valid
            progress.update(valid)
            self._checkpoint(manifest_path, stats.encoded + skip)

        enc = _EncodeThread(
            drain_one, depth=cfg.max_inflight_batches,
            discard_fn=lambda item: item[0].release(),
        )
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
                    faces = None
                    if face_pool is not None:
                        faces = [face_pool.submit(detect_faces, f) for f in frames[:valid]]
                    post = None
                    if faces is not None or resize is not None:
                        post = self._post(faces, face_pass, resize, valid, timer)
                    fetched = ups.run(np.stack(frames), post, timer.stage)
                    enc.submit((fetched, valid))
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
            if face_pool is not None:
                face_pool.shutdown(wait=True)
            writer.close()
            progress.close()
            reader.close()
        stats.stages = dict(timer.totals)
        if hasattr(writer, "finalize"):
            writer.finalize()  # a successful run: concat segments, clean up
        stats.decoded = decoder.decoded + skip
        stats.inferred += skip
        stats.encoded += skip
        if manifest_path is not None and manifest_path.exists():
            manifest_path.unlink()  # complete: clear the progress marker
        if cfg.audio_copy and not (pipe_in or pipe_out):
            copy_audio(input_path, output_path)
        return stats

    @staticmethod
    def _post(faces, face_pass, resize, valid: int, timer: StageTimer):
        """``post(out, lo)`` for ``ShardedUpscaler.run``: on a chunk of a batch's
        output whose first frame is frame ``lo`` of the batch, the face pass
        of each of its frames below ``valid`` (waiting for its detection),
        then the resize."""

        def post(out, lo):
            if faces is not None:
                with timer.stage("faces"):
                    for i in range(out.shape[0]):
                        if lo + i < valid:
                            boxes = faces[lo + i].result()
                            if boxes:
                                out[i] = face_pass(out[i], boxes)
            if resize is not None:
                with timer.stage("resize"):
                    out = resize(out)
            return out

        return post

    def _gfpgan_for(self, device: torch.device):
        """The GFPGAN crop restorer on ``device``, loaded once per device
        (False: the weights are missing)."""
        from video_restore_tpu_torch.ops import faces

        with self._gfpgan_lock:
            if device not in self._gfpgan:
                self._gfpgan[device] = faces.make_gfpgan_runner(
                    self.config.models_dir, device=device
                ) or False
            return self._gfpgan[device]

    def _face_pass(self):
        """The face pass of ``--face-enhance`` (``runner.py:413-451`` of the
        JAX package): ``f(frame, boxes) -> frame`` on a uint8 (H*s, W*s, 3)
        tensor and LR boxes. The GFPGAN prior for ``face_model`` "auto" or
        "gfpgan" when its weights load (once per device), else the region
        heuristic; "gfpgan" without weights raises."""
        from video_restore_tpu_torch.ops import faces

        cfg = self.config
        scale = self.model.scale
        if cfg.face_model != "regions" and self._gfpgan_for(self.device):
            log.info("face restorer: GFPGAN v1-clean prior")
            return lambda f, boxes: faces.restore_faces_learned(
                f, boxes, scale, self._gfpgan_for(f.device), cfg.face_strength
            )
        if cfg.face_model == "gfpgan":
            raise RuntimeError(
                "--face-model gfpgan requires the GFPGANv1.4 weights (no "
                "download possible and no cached file)"
            )
        log.info(
            "face restorer: region heuristic%s",
            "" if cfg.face_model == "regions" else " (GFPGAN weights unavailable)",
        )
        return lambda f, boxes: faces.enhance_face_regions(
            f, boxes, scale, cfg.face_strength
        )

    def _resizer(self, out_w: int, out_h: int, scale: int, info):
        """The ``outscale`` resize (``runner.py:538-547``): None when the
        model's scale gives the output size, else a Lanczos4 resize of a
        (B, H*s, W*s, 3) uint8 batch on its device to (out_h, out_w)."""
        if out_w == info.width * scale and out_h == info.height * scale:
            return None
        from video_restore_tpu_torch.ops.resample import resize_lanczos4

        return lambda x: resize_lanczos4(x, (out_w, out_h))

    def _open_writer(self, output_path, w, h, fps, pix_fmt="rgb24"):
        cfg = self.config
        if cfg.segment_frames > 0:
            if str(output_path).endswith(".y4m"):
                # y4m frames are fixed-size: append mode alone is crash-safe
                from video_restore_tpu_torch.video.y4m import Y4MWriter

                return Y4MWriter(output_path, w, h, fps, append=cfg.resume)
            from video_restore_tpu_torch.video.segmented import SegmentedWriter

            return SegmentedWriter(
                output_path, w, h, fps,
                codec=cfg.video_codec, crf=cfg.crf, preset=cfg.preset,
                segment_frames=cfg.segment_frames, resume=cfg.resume,
                pix_fmt=pix_fmt,
            )
        return open_writer(
            output_path, w, h, fps,
            codec=cfg.video_codec, crf=cfg.crf, preset=cfg.preset,
            pix_fmt=pix_fmt,
        )

    def _resume_state(
        self, output_path, out_w: int, out_h: int, fps: float
    ) -> Tuple[int, Optional[Path]]:
        """Returns (frames to skip, progress-manifest path or None). The
        manifest is advisory; the y4m file, or the segment manifest of
        another container, is the record resume trusts."""
        cfg = self.config
        if cfg.segment_frames <= 0:
            if cfg.resume:
                log.warning(
                    "resume requires --segment-frames; starting from frame 0"
                )
            return 0, None
        manifest = Path(str(output_path) + ".progress.json")
        if not str(output_path).endswith(".y4m"):
            from video_restore_tpu_torch.video.segmented import SegmentedWriter

            if cfg.resume:
                done = SegmentedWriter.resume_skip(
                    output_path, out_w, out_h, fps
                )
                if done:
                    log.info("resuming at frame %d", done)
                return done, manifest
            if manifest.exists():
                manifest.unlink()
            return 0, manifest
        if cfg.resume and os.path.exists(output_path):
            # appending frames of another geometry would corrupt the file
            self._check_resume_header(output_path, out_w, out_h, fps)
            # fixed-size y4m frames make the count exact after a crash
            done = self._trim_partial_y4m(output_path)
            log.info("resuming at frame %d", done)
            return done, manifest
        if manifest.exists():
            manifest.unlink()
        if os.path.exists(output_path) and not cfg.resume:
            os.remove(output_path)
        return 0, manifest

    @staticmethod
    def _check_resume_header(path, out_w: int, out_h: int, fps: float) -> None:
        from video_restore_tpu_torch.video.y4m import Y4MReader

        with Y4MReader(path) as r:
            info = r.info
            colorspace = r._colorspace
        problems = []
        if (info.width, info.height) != (out_w, out_h):
            problems.append(
                f"size {info.width}x{info.height} != {out_w}x{out_h}"
            )
        if abs(info.fps - fps) > 1e-3:
            problems.append(f"fps {info.fps:g} != {fps:g}")
        if colorspace != "420jpeg":
            problems.append(f"colorspace C{colorspace} != C420jpeg")
        if problems:
            raise ValueError(
                f"cannot resume into {path}: existing output does not match "
                f"this run ({'; '.join(problems)}). Remove the file or drop "
                "--resume."
            )

    @staticmethod
    def _trim_partial_y4m(path) -> int:
        """Truncate a crashed y4m output to its last complete frame; returns
        the number of complete frames."""
        from video_restore_tpu_torch.video.y4m import Y4MReader, _plane_shapes

        with Y4MReader(path) as r:
            info = r.info
            ys, cs = _plane_shapes(info.width, info.height, r._colorspace)
        frame_bytes = len(b"FRAME\n") + ys[0] * ys[1] + 2 * cs[0] * cs[1]
        with open(path, "rb") as f:
            header = len(f.readline())
        size = os.path.getsize(path)
        frames = (size - header) // frame_bytes
        keep = header + frames * frame_bytes
        if keep < size:
            with open(path, "ab") as f:
                f.truncate(keep)
        return frames

    def _checkpoint(self, manifest_path, frames_done: int) -> None:
        if manifest_path is not None:
            manifest_path.write_text(json.dumps({"frames_done": frames_done}))

    def _warmup_buckets(self, pairs) -> None:
        """Batch prewarm (``runner.py:666-702``): probe every (input,
        output) pair, collect the distinct (height, width, yuv) buckets, and
        run each cold one once when there are at least two. One after
        another: the kernels are built once per process, so a bucket's
        warm-up costs one step, not a compile. Each warm-up also sizes its
        pinned fetch slots for what the runner fetches, the output after
        any ``outscale`` resize."""
        cfg = self.config
        keys = {}
        for v, out in pairs:
            try:
                info = probe(v)
            except Exception:
                continue  # an unprobeable input fails in the main loop too
            self._probe_cache[str(v)] = info
            out_w = int(info.width * cfg.outscale)
            out_h = int(info.height * cfg.outscale)
            yuv = self._yuv_eligible(out, info, out_w, out_h)
            keys[(info.height, info.width, yuv)] = (out_h, out_w)
        cold = [k for k in keys if k not in self._upscalers]
        if len(cold) < 2:
            return
        log.info("[batch] warming %d resolution buckets", len(cold))
        t0 = time.time()
        for h, w, yuv in cold:
            ups = self._upscaler_for(h, w, yuv_out=yuv)
            out_h, out_w = keys[(h, w, yuv)]
            n = ups.frames_per_batch * max(cfg.frames_per_batch, 1)
            ups.warmup((n, out_h * 3 // 2, out_w) if yuv else (n, out_h, out_w, 3))
        log.info("[batch] warmup done in %.1fs", time.time() - t0)

    def process_batch_dir(
        self,
        input_dir: Union[str, Path],
        output_dir: Union[str, Path],
        *,
        show_progress: bool = True,
    ) -> Tuple[int, int]:
        """Batch directory mode (``runner.py:704-759``): every video in
        ``input_dir`` to ``output_dir/{stem}_upscaled{suffix}``. Returns
        (succeeded, total). Under a process group of several processes
        (``--multihost``: ``parallel/multihost.py::init_multihost``) every
        process sees the same sorted listing and takes its round-robin
        share, and the success counts are gathered so that each process
        returns the global result."""
        from video_restore_tpu_torch.parallel import multihost

        exts = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".y4m", ".npz"}
        videos = sorted(
            p for p in Path(input_dir).iterdir() if p.suffix.lower() in exts
        )
        outdir = Path(output_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        nprocs = multihost.process_count()
        mine = videos
        if nprocs > 1:
            mine = multihost.shard_items(videos)
            log.info(
                "[batch] multihost: process %d/%d takes %d of %d videos",
                multihost.process_index(), nprocs, len(mine), len(videos),
            )
        fmt = self.config.output_format
        suffix_override = "." + fmt.lstrip(".") if fmt else None
        pairs = [
            (v, outdir / f"{v.stem}_upscaled{suffix_override or v.suffix}")
            for v in mine
        ]
        if self.config.batch_warmup:
            self._warmup_buckets(pairs)
        ok = 0
        for v, out in pairs:
            log.info("[batch] %s -> %s", v.name, out.name)
            if self.process_video(v, out, show_progress=show_progress):
                ok += 1
        if nprocs > 1:
            rows = multihost.allgather_counts([ok, len(mine)])
            ok = sum(r[0] for r in rows)
            if sum(r[1] for r in rows) != len(videos):
                raise RuntimeError(f"multihost: the shares {rows} do not cover {len(videos)} videos")
        return ok, len(videos)

"""Command-line interface of the PyTorch/CUDA port.

Port of ``video_restore_tpu/cli.py``: ``build_parser`` and
``config_from_args`` are copied, so every invocation parses as it does for
the JAX CLI. The program runs on the GPUs (``--devices N``: frames, or
with ``--shard-mode tiles`` each frame's tiles, sharded over N of them);
``--cpu`` selects the plain PyTorch path on the host CPU, which is one
device. ``--multihost`` joins a process group (``torchrun``'s
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, or
``--coordinator``) and shards a ``--batch`` directory's videos over the
processes.

    python -m video_restore_tpu_torch.cli in.y4m out.y4m [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from video_restore_tpu_torch.config import (
    MODEL_NAMES,
    RestoreConfig,
    X264_PRESETS,
    apply_quality_preset,
)
from video_restore_tpu_torch.utils.logging import setup_logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="video-restore-torch",
        description="AI video upscaler (Real-ESRGAN family), PyTorch/CUDA port",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="""
Examples:
  video-restore input.mp4 output.mp4
  video-restore input.mp4 output.mp4 --quality max --enhanced
  video-restore input.mp4 output.mp4 --model RealESRGAN_x4plus_anime_6B
  video-restore input.mp4 output.mp4 --model RealESRGAN_x2plus
  video-restore in_dir/ out_dir/ --batch --quality fast
  video-restore clip.y4m out.y4m --segment-frames 64 --resume

Streaming (y4m over stdin/stdout, for ffmpeg pipelines):
  ffmpeg -i in.mkv -f yuv4mpegpipe - | video-restore - - | \\
      ffmpeg -i - -c:v libx265 -crf 18 out.mkv
""",
    )
    # positional (video_upscaler.py:649-650)
    p.add_argument("input", help="input video file (or directory with --batch)")
    p.add_argument("output", help="output video file (or directory with --batch)")
    # reference flags (video_upscaler.py:652-682)
    p.add_argument("--model", default="RealESRGAN_x4plus", choices=MODEL_NAMES)
    # separate options: --devices keeps this CLI's COUNT semantics while
    # --gpus carries the reference's GPU-ID-list semantics verbatim
    # (video_upscaler.py:656-657) — a shared argparse dest cannot tell
    # `--devices 4` (4 devices) from `--gpus 4` (one device, id 4)
    p.add_argument(
        "--devices", dest="devices", type=int, default=0,
        help="number of GPUs to shard frames across (0 = all)",
    )
    p.add_argument(
        "--gpus", dest="gpus", type=int, default=None, nargs="*",
        help="reference-compatible GPU id list (`--gpus 0 1`): N ids = "
             "N devices",
    )
    p.add_argument("--quality", default="balanced",
                   choices=["fast", "balanced", "max"])
    p.add_argument("--enhanced", action="store_true",
                   help="enable the enhancement stack (denoise/CLAHE/"
                        "unsharp/temporal)")
    p.add_argument("--tile-size", type=int, default=None,
                   help="model tile size; 0 = no tiling (whole frame in "
                        "one model call — fastest when HBM admits it)")
    p.add_argument("--full-frame", default=None,
                   choices=["auto", "on", "off"],
                   help="auto-upgrade to no-tiling when the frame fits "
                        "HBM (default auto; 'off' always tiles)")
    p.add_argument("--tile-overlap", type=int, default=None)
    p.add_argument("--crf", type=int, default=None)
    p.add_argument("--preset", default=None, choices=list(X264_PRESETS))
    p.add_argument("--no-audio", action="store_true")
    p.add_argument("--batch", action="store_true",
                   help="process a directory of videos")
    p.add_argument("--no-warmup", dest="batch_warmup",
                   action="store_false",
                   help="skip the batch-mode bucket prewarm (by default "
                        "all distinct resolutions are probed and their "
                        "programs compiled in parallel up front)")
    p.add_argument("--multihost", action="store_true",
                   help="shard --batch videos across hosts (coordinator "
                        "from --coordinator or MASTER_ADDR/MASTER_PORT, "
                        "WORLD_SIZE, RANK, as torchrun sets them)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multihost coordinator address")
    # advertised-but-unimplemented reference features (SURVEY.md §2.5)
    p.add_argument("--anime-mode", action="store_true",
                   help="anime-tuned model + post settings (README.md:161)")
    p.add_argument("--denoise", type=float, default=None, metavar="0..1",
                   help="bilateral denoise strength (0.5 = reference's "
                        "fixed 5/25/25 filter)")
    p.add_argument("--sharpen", type=float, default=None, metavar="0..1",
                   help="unsharp-mask strength")
    p.add_argument("--face-model", default="auto",
                   choices=["auto", "gfpgan", "regions"],
                   help="face restorer: GFPGAN v1-clean prior (needs "
                        "MODELS_DIR/GFPGANv1.4.pth; nothing is downloaded) "
                        "or the region heuristic")
    p.add_argument("--face-enhance", action="store_true",
                   help="detect faces and restore them with the GFPGAN "
                        "v1-clean prior (README.md:3); falls back to a "
                        "region-enhancement heuristic when the GFPGAN "
                        "weights are unavailable")
    p.add_argument("--no-seamless", action="store_true",
                   help="legacy pad-and-crop tiling (RealESRGANer parity)")
    p.add_argument("--no-temporal", action="store_true",
                   help="disable temporal consistency")
    p.add_argument("--no-color-enhance", action="store_true",
                   help="disable CLAHE color correction")
    p.add_argument("--dither", action="store_true",
                   help="ordered-dithered 8-bit quantization of the output "
                        "(breaks up banding on smooth gradients)")
    p.add_argument("--format", dest="vformat", default=None,
                   choices=["h264", "h265", "mpeg4", "rawvideo"],
                   help="output video codec (h265 per README.md:250)")
    p.add_argument("--outscale", type=float, default=0.0,
                   help="final upscale factor (Lanczos-resized from the "
                        "model's native scale)")
    # device / framework flags
    p.add_argument(
        "--precision", default="bf16", choices=["bf16", "fp32", "int8"],
        help="model compute precision; int8 runs the RRDB/SRVGG body as "
             "W8A8 (int8 weights, per-image int8 activations, bf16 "
             "between kernels)",
    )
    p.add_argument("--shard-mode", default="frames",
                   choices=["frames", "tiles"],
                   help="frames: shard the frame batch across devices "
                        "(throughput); tiles: all devices cooperate on one "
                        "frame (latency + exact sequential temporal)")
    p.add_argument("--frames-per-batch", type=int, default=0,
                   help="frames per device per step (0 = 1)")
    p.add_argument("--resume", action="store_true",
                   help="resume a partially-encoded .y4m output")
    p.add_argument("--segment-frames", type=int, default=0,
                   help="checkpoint interval in frames (enables resume)")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the host CPU")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture a torch.profiler trace (CPU and CUDA) to "
                        "DIR/trace.json")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--log-json", default=None, metavar="FILE",
                   help="also write JSON-lines logs to FILE")
    return p


def _pick_device_flag(args):
    """--gpus (reference id-list semantics) wins over --devices, but
    supplying both is almost certainly a misconfiguration — warn instead
    of silently dropping --devices."""
    import logging

    gpus = getattr(args, "gpus", None)
    if gpus is None:
        return args.devices
    if args.devices:
        logging.getLogger("video_restore_tpu_torch").warning(
            "both --devices %d and --gpus %s given: --gpus wins "
            "(--devices ignored)",
            args.devices, " ".join(map(str, gpus)),
        )
    return gpus


def _resolve_devices(devices) -> int:
    """Normalize ``--devices/--gpus`` to a device count.

    Accepts the reference's id-list form ``--gpus 0 1``
    (video_upscaler.py:656-657) with the reference's semantics: the list
    names GPU ids, so N ids mean "use N devices" — including the
    single-id form (``--gpus 0`` = one device, exactly as the reference
    reads it; it is NOT this CLI's ``--devices 0`` = all-devices count).
    As in the JAX CLI the ids select a count, not particular cards, so we
    warn and use len().
    """
    if isinstance(devices, int):
        return devices
    if not devices:  # `--gpus` with no operands
        return 0
    import logging

    logging.getLogger("video_restore_tpu_torch").warning(
        "--gpus %s: interpreting the reference's GPU-id list as %d "
        "device(s) (use --devices N for count semantics)",
        " ".join(map(str, devices)), len(devices),
    )
    return len(devices)


def config_from_args(args: argparse.Namespace) -> RestoreConfig:
    # --anime-mode implies the enhanced stack; the preset matrix and the
    # implied denoise must see the same effective flag or anime runs get an
    # inconsistent half-enhanced configuration (ADVICE r1).
    enhanced = args.enhanced or args.anime_mode
    crf, preset, tile, overlap = apply_quality_preset(
        args.quality, enhanced,
        crf=args.crf, preset=args.preset,
        tile_size=args.tile_size, tile_overlap=args.tile_overlap,
    )
    # --enhanced implies the reference's light_denoise (video_upscaler.py:714)
    denoise = args.denoise if args.denoise is not None else (
        0.5 if enhanced else 0.0
    )
    sharpen = args.sharpen if args.sharpen is not None else 0.0
    return RestoreConfig(
        model_name=args.model,
        tile_size=tile,
        tile_overlap=overlap,
        full_frame=(
            args.full_frame if args.full_frame is not None
            # an explicit --tile-size is a direct instruction: honour it
            else ("off" if args.tile_size is not None else "auto")
        ),
        seamless=not args.no_seamless,
        legacy_tiling=args.no_seamless,
        precision=args.precision,
        enhanced_mode=enhanced,
        denoise=denoise,
        sharpen=sharpen,
        temporal=not args.no_temporal,
        color_enhance=not args.no_color_enhance,
        dither=args.dither,
        anime_mode=args.anime_mode,
        face_enhance=args.face_enhance,
        face_model=args.face_model,
        video_codec=args.vformat or "h264",
        crf=crf,
        preset=preset,
        audio_copy=not args.no_audio,
        num_devices=_resolve_devices(_pick_device_flag(args)),
        shard_mode=args.shard_mode,
        frames_per_batch=args.frames_per_batch,
        batch_warmup=args.batch_warmup,
        resume=args.resume,
        segment_frames=args.segment_frames,
        models_dir=args.models_dir,
        verbose=args.verbose,
        trace_dir=args.profile,
        outscale=args.outscale,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = setup_logging(args.verbose, args.log_json)
    # a misspelled VRT_* would otherwise do nothing, silently
    from video_restore_tpu_torch.utils.knobs import warn_unknown_knobs

    warn_unknown_knobs()
    if args.multihost:
        from video_restore_tpu_torch.parallel.multihost import init_multihost

        try:
            init_multihost(args.coordinator)
        except Exception as e:
            log.error("multihost init failed: %s", e)
            return 1
    try:
        return _run(args, log)
    finally:
        if args.multihost:  # the group this call formed
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _run(args, log) -> int:
    try:
        config = config_from_args(args)
    except ValueError as e:
        log.error("%s", e)
        return 1

    from video_restore_tpu_torch.video.y4m import is_pipe

    if not is_pipe(args.input) and not Path(args.input).exists():
        log.error("input not found: %s", args.input)
        return 1

    from video_restore_tpu_torch.pipeline.runner import VideoRestorer

    try:
        restorer = VideoRestorer(config, cpu=args.cpu)
    except (RuntimeError, FileNotFoundError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    try:
        if args.batch:
            ok, total = restorer.process_batch_dir(args.input, args.output)
            log.info("batch complete: %d/%d succeeded", ok, total)
            return 0 if ok == total and total > 0 else 1
        return 0 if restorer.process_video(args.input, args.output) else 1
    except KeyboardInterrupt:
        log.warning("interrupted")
        return 1


if __name__ == "__main__":
    sys.exit(main())

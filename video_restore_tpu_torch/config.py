"""Configuration for the restoration pipeline.

Port of ``video_restore_tpu/config.py``: ``RestoreConfig`` and
``apply_quality_preset`` are copied field for field, so the CLI and the
preset matrix behave exactly as the JAX package's. Every field is ported:
the CLI refuses no flag, and each field reaches the subsystem that the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Model names accepted by the CLI. The first three match the reference's
# --model choices (video_upscaler.py:652-654); RealESRGAN_x2plus is advertised
# in the reference README (README.md:27,158) but unimplemented there.
MODEL_NAMES = (
    "RealESRGAN_x4plus",
    "RealESRGAN_x4_v3",
    "RealESRGAN_x4plus_anime_6B",
    "RealESRGAN_x2plus",
    # advertised at reference README.md:3, never wired there
    "BSRGAN",
    "BSRGANx2",
)

QUALITY_PRESETS = ("fast", "balanced", "max")
X264_PRESETS = ("ultrafast", "fast", "medium", "slow", "veryslow")
OUTPUT_FORMATS = ("mp4", "mkv", "y4m", "avi", "webm", "mov")
VIDEO_CODECS = ("h264", "h265", "mpeg4", "rawvideo")
PRECISIONS = ("bf16", "fp32", "int8")


@dataclasses.dataclass
class RestoreConfig:
    """Full pipeline configuration.

    Field-for-field superset of the reference's ``OptimizedConfig``
    (video_upscaler.py:112-141); reference defaults preserved where they
    exist.
    """

    # --- model (video_upscaler.py:114-116) ---
    model_name: str = "RealESRGAN_x4plus"
    scale: int = 0  # 0 = model-native scale (4 for x4 models, 2 for x2plus)
    outscale: float = 0.0  # 0 = same as scale; else Lanczos resize of output

    # --- tiling (video_upscaler.py:120-122) ---
    tile_size: int = 512
    tile_overlap: int = 32
    seamless: bool = True  # Gaussian overlap-add blending (README.md:8,34)
    # legacy pad-and-crop tile mode for strict parity with RealESRGANer
    legacy_tiling: bool = False
    tile_chunk: int = 0  # tiles per model pass; 0 = auto (HBM heuristic)
    # full-frame (no-tiling) upgrade: "auto" runs the whole frame in one
    # model call whenever the TPU stripe path is active and the HBM
    # estimate fits (ops/tiles.py:auto_full_frame) — no tile overlap MACs
    # and taller 2D stripes (+14.5% body, BENCH_NOTES round 3). "on"
    # forces it, "off" always honours tile_size.
    full_frame: str = "auto"

    # --- precision (video_upscaler.py:123 use_fp16=True -> TPU bf16;
    # "int8" = W8A8 stripe body, the next rung of the reference's own
    # speed-for-precision ladder — models/rrdbnet.py default_precision) ---
    precision: str = "bf16"

    # --- enhancement stack (video_upscaler.py:124-125 + README.md:9-12) ---
    enhanced_mode: bool = False
    denoise: float = 0.0  # 0..1 bilateral strength (README.md:140)
    sharpen: float = 0.0  # 0..1 unsharp-mask strength (README.md:141)
    temporal: bool = True  # temporal consistency when enhanced (README.md:9)
    temporal_strength: float = 0.3
    scene_cut_thresh: float = 0.12  # mean luma delta that resets the EMA
    # luma-histogram total-variation distance that resets the EMA (0 = off).
    # Motion-invariant: a panning/zooming scene keeps its histogram while a
    # real cut replaces it, so this fires on content change where the mean
    # luma delta above would need fast motion to trip.
    scene_cut_hist: float = 0.35
    # on-device RGB->I420 conversion when the sink takes planar yuv directly
    # (halves D2H traffic; "auto" enables when compatible, "off" disables)
    device_yuv: str = "auto"
    color_enhance: bool = True  # CLAHE when enhanced (README.md:11)
    clahe_clip: float = 2.0
    clahe_lr: bool = True  # apply CLAHE pre-upscale (16x cheaper, same look)
    dither: bool = False  # ordered-dithered 8-bit output (anti-banding)
    anime_mode: bool = False  # README.md:161; selects anime model + tuned post
    face_enhance: bool = False  # face-region enhancement (README.md:3 gap)
    face_strength: float = 0.5
    # "auto": GFPGAN prior when weights are available, else the region
    # heuristic; "gfpgan": require the prior; "regions": heuristic only
    face_model: str = "auto"

    # --- output encoding (video_upscaler.py:127-131) ---
    # batch-mode output container ("mp4", "mkv", ...); None keeps each
    # input's own suffix. Single-file mode takes the container from the
    # explicit output path instead.
    output_format: Optional[str] = None
    video_codec: str = "h264"  # h265 advertised at README.md:30,250
    crf: int = 15
    preset: str = "slow"
    audio_copy: bool = True

    # --- pipeline (video_upscaler.py:133-134) ---
    prefetch_frames: int = 32
    frames_per_batch: int = 0  # 0 = one frame per device per step
    max_inflight_batches: int = 2  # double-buffered device feed
    # batch mode: probe every video up front and compile all distinct
    # resolution buckets in parallel threads (XLA compiles release the
    # GIL) instead of paying each multi-minute TPU compile serially at
    # the first frame of each new resolution.
    batch_warmup: bool = True

    # --- parallelism (replaces gpu_ids, video_upscaler.py:117-118) ---
    num_devices: int = 0  # 0 = all visible JAX devices
    data_axis: str = "data"
    # 'frames': throughput mode, frame batch sharded over the mesh.
    # 'tiles':  latency mode, every device works on one frame's tiles
    #           (exact sequential temporal consistency as a bonus).
    shard_mode: str = "frames"

    # --- resilience (absent in reference — SURVEY.md §5) ---
    resume: bool = False
    segment_frames: int = 0  # >0: encode in resumable segments of N frames

    # --- misc ---
    models_dir: str = "models"
    verbose: bool = False
    trace_dir: str = ""  # device trace output dir ("" = off)

    def __post_init__(self) -> None:
        if self.model_name not in MODEL_NAMES:
            raise ValueError(
                f"Unknown model {self.model_name!r}; expected one of {MODEL_NAMES}"
            )
        if self.anime_mode and self.model_name == "RealESRGAN_x4plus":
            # README.md:161 --anime-mode implies the anime-tuned model.
            self.model_name = "RealESRGAN_x4plus_anime_6B"
        if self.scale == 0:
            x2_models = ("RealESRGAN_x2plus", "BSRGANx2")
            self.scale = 2 if self.model_name in x2_models else 4
        if self.outscale == 0.0:
            self.outscale = float(self.scale)
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        if self.tile_size % 2:
            raise ValueError("tile_size must be even")
        # tile_size=0: no tiling — the whole frame goes through the model
        # in one call (RealESRGANer's tile=0 semantics, which the reference
        # exposes via its tile_size presets). On TPU this is also the
        # fastest mode when HBM admits it: the 2D-blocked stripe kernels
        # bound VMEM at any width, so a full-frame body skips the tile
        # overlap MACs entirely.
        if self.tile_size and not 0 <= self.tile_overlap < self.tile_size:
            raise ValueError("tile_overlap must be in [0, tile_size)")
        if not self.tile_size and self.tile_overlap < 0:
            # tile_size=0 ignores the overlap, but a negative value would
            # flow into TileGrid offset math if tiling is re-enabled later
            raise ValueError("tile_overlap must be >= 0")
        if self.preset not in X264_PRESETS:
            raise ValueError(f"preset must be one of {X264_PRESETS}")
        if self.video_codec not in VIDEO_CODECS:
            raise ValueError(f"video_codec must be one of {VIDEO_CODECS}")
        if self.shard_mode not in ("frames", "tiles"):
            raise ValueError("shard_mode must be 'frames' or 'tiles'")
        if self.full_frame not in ("auto", "on", "off"):
            raise ValueError("full_frame must be 'auto', 'on' or 'off'")
        if self.shard_mode == "tiles" and (
            self.tile_size == 0 or self.full_frame == "on"
        ):
            raise ValueError(
                "shard_mode='tiles' parallelizes over the tile axis and "
                "is incompatible with full-frame mode (tile_size=0 / "
                "full_frame='on')"
            )

    @property
    def post_enabled(self) -> bool:
        return self.enhanced_mode and (
            self.denoise > 0
            or self.sharpen > 0
            or self.temporal
            or self.color_enhance
        )


def apply_quality_preset(
    quality: str,
    enhanced: bool,
    *,
    crf: Optional[int] = None,
    preset: Optional[str] = None,
    tile_size: Optional[int] = None,
    tile_overlap: Optional[int] = None,
) -> Tuple[int, str, int, int]:
    """Resolve the {fast, balanced, max} x {enhanced, normal} preset matrix.

    Exactly the reference's table (video_upscaler.py:687-701); explicit
    values override preset values, matching ``args.crf or preset_crf``
    semantics there. Unlike the reference, tile_overlap is honoured even
    without --enhanced (reference defect: SURVEY.md §2.6 #4).
    """
    if quality == "max":
        p_crf, p_preset = 12, "veryslow"
        p_tile, p_over = (512, 64) if enhanced else (1536, 32)
    elif quality == "fast":
        p_crf, p_preset, p_tile, p_over = 18, "fast", 1024, 16
    else:  # balanced (default)
        p_crf, p_preset = 15, "slow"
        p_tile, p_over = (512, 32) if enhanced else (1024, 16)
    return (
        crf if crf is not None else p_crf,
        preset if preset is not None else p_preset,
        tile_size if tile_size is not None else p_tile,
        tile_overlap if tile_overlap is not None else p_over,
    )

"""Face detection and restoration: the GFPGAN prior, with a region
fallback.

Port of ``video_restore_tpu/ops/faces.py``:

- detect faces on the LR frame, on the host (:func:`detect_faces`): the
  JAX package's chain, YuNet (5-point landmarks) when ``cv2`` has it and a
  model file exists, else OpenCV's Haar cascade when ``cv2`` imports, else
  the skin detector, which needs no OpenCV (YCrCb in cv2's fixed point, a
  5x5 close and open with cv2's border, 8-connected components in cv2's
  label order);
- **learned path** (:func:`make_gfpgan_runner` +
  :func:`restore_faces_learned`): crop each face (similarity-aligned to the
  FFHQ template when it has landmarks, else a loose square), run the
  GFPGAN v1-clean prior (``models/gfpgan.py``) on the batch of 512x512
  crops, inverse-warp and feather each back;
- **heuristic** (:func:`enhance_face_regions`): when the GFPGAN weights
  are missing, an edge-preserving smooth and a sharpen of each upscaled
  face region, feathered in.

Both passes take the upscaled frame as a uint8 (H, W, 3) tensor on any
device and run there as plain PyTorch (``ops/resample.py`` in place of
``cv2``), so on the card no frame goes back to the host for them. The
inverse warp of an aligned face is computed only over the bounding box of
its warped 512x512 square: outside it the mask is 0, so the frame keeps the
values the JAX package's whole-frame warp gives it.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import math
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from video_restore_tpu_torch.ops.resample import (
    bilateral_u8,
    gaussian_blur,
    invert_affine,
    resize_linear,
    to_device,
    warp_affine,
)


@dataclasses.dataclass(frozen=True)
class FaceBox:
    x: int
    y: int
    w: int
    h: int
    # optional 5-point landmarks ((x, y) right eye, left eye, nose tip,
    # right mouth corner, left mouth corner) in the box's coordinates, from
    # the YuNet detector; None otherwise
    landmarks: "tuple | None" = None

    def scaled(self, s: float) -> "FaceBox":
        lm = None
        if self.landmarks is not None:
            lm = tuple((px * s, py * s) for px, py in self.landmarks)
        return FaceBox(
            int(self.x * s), int(self.y * s), int(self.w * s),
            int(self.h * s), lm,
        )

    def expanded(self, frac: float, width: int, height: int) -> "FaceBox":
        dx, dy = int(self.w * frac), int(self.h * frac)
        x0 = max(self.x - dx, 0)
        y0 = max(self.y - dy, 0)
        x1 = min(self.x + self.w + dx, width)
        y1 = min(self.y + self.h + dy, height)
        return FaceBox(x0, y0, x1 - x0, y1 - y0)


_detector = None  # ("yunet" | "cascade" | "skin", handle)


def _init_detector():
    """The best detector this machine has, as the JAX package picks it:

    1. YuNet (OpenCV >= 4.5.4 ``FaceDetectorYN``; an .onnx file at
       ``$VRT_YUNET_MODEL`` or ``models/face_detection_yunet*.onnx``),
       which gives the 5-point landmarks the aligned path needs;
    2. the Haar cascade OpenCV ships (boxes only);
    3. the skin detector (:func:`_detect_skin_regions`, no OpenCV)."""
    try:
        import cv2
    except ImportError:
        return ("skin", None)
    if hasattr(cv2, "FaceDetectorYN_create"):
        cand = [os.environ.get("VRT_YUNET_MODEL", "")]
        cand += glob.glob("models/face_detection_yunet*.onnx")
        for p in cand:
            if p and os.path.exists(p):
                return ("yunet", cv2.FaceDetectorYN_create(p, "", (320, 320), 0.7))
    if hasattr(cv2, "CascadeClassifier") and hasattr(cv2, "data"):
        path = os.path.join(cv2.data.haarcascades, "haarcascade_frontalface_default.xml")
        if os.path.exists(path):
            return ("cascade", cv2.CascadeClassifier(path))
    return ("skin", None)


def _get_detector():
    global _detector
    if _detector is None:
        _detector = _init_detector()
    return _detector


def _rgb_to_ycrcb_u8(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, COLOR_RGB2YCrCb)`` on uint8: cv2's 14-bit fixed
    point (Y = 4899 R + 9617 G + 1868 B; Cr = 11682 (R - Y); Cb =
    9241 (B - Y); offsets 128, rounding ``(v + 2^13) >> 14``)."""
    x = rgb.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half, delta = 1 << 13, 128 << 14
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    cr = np.clip(((r - y) * 11682 + delta + half) >> 14, 0, 255)
    cb = np.clip(((b - y) * 9241 + delta + half) >> 14, 0, 255)
    return np.stack([y, cr, cb], -1).astype(np.uint8)


def _morph(mask: np.ndarray, op: str) -> np.ndarray:
    """A 5x5 dilation or erosion of a 0/1 mask with cv2's morphology border:
    outside the frame counts as 0 for a dilation and 1 for an erosion, so
    the border neither grows nor erodes anything."""
    from scipy import ndimage

    if op == "dilate":
        return ndimage.maximum_filter(mask, size=5, mode="constant", cval=0)
    return ndimage.minimum_filter(mask, size=5, mode="constant", cval=1)


def _components(mask: np.ndarray):
    """``cv2.connectedComponentsWithStats(mask)`` (8-connected): per label,
    (x, y, w, h, area), in cv2's label order. cv2 labels 2x2 blocks in
    raster order, so a component's label follows the first 2x2 block it
    touches, which scipy's pixel-raster labels are sorted into."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), np.int32))
    if n == 0:
        return []
    h, w = mask.shape
    yy, xx = np.mgrid[0:h, 0:w]
    block = (yy // 2) * ((w + 1) // 2) + xx // 2
    idx = np.arange(1, n + 1)
    first = ndimage.minimum(block, labels, idx)
    slices = ndimage.find_objects(labels)
    area = ndimage.sum_labels(np.ones_like(labels), labels, idx)
    stats = []
    for k in np.argsort(first, kind="stable"):
        sy, sx = slices[k]
        stats.append((sx.start, sy.start, sx.stop - sx.start, sy.stop - sy.start, int(area[k])))
    return stats


def _detect_skin_regions(frame_rgb: np.ndarray, min_size: int) -> List[FaceBox]:
    """The fallback detector (``faces.py:103-128`` of the JAX package):
    YCrCb skin thresholds, a 5x5 close then open, connected components
    filtered by size, fill and aspect. No OpenCV."""
    ycc = _rgb_to_ycrcb_u8(frame_rgb)
    y, cr, cb = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    mask = ((y > 60) & (cr > 135) & (cr < 175) & (cb > 85) & (cb < 130)).astype(np.uint8)
    mask = _morph(_morph(mask, "dilate"), "erode")  # close
    mask = _morph(_morph(mask, "erode"), "dilate")  # open
    out = []
    for x, y0, w, h, area in _components(mask):
        if w < min_size or h < min_size:
            continue
        if area < 0.35 * w * h:  # a sparse blob, not a face
            continue
        aspect = h / max(w, 1)
        if not 0.7 <= aspect <= 2.2:
            continue
        out.append(FaceBox(int(x), int(y0), int(w), int(h)))
    return out


def detect_faces(frame_rgb: np.ndarray, min_size: int = 24) -> List[FaceBox]:
    """Faces on an RGB uint8 frame (run on the LR input: cheap), on the
    host, with the detector :func:`_init_detector` chose."""
    kind, det = _get_detector()
    if kind == "cascade":
        import cv2

        gray = cv2.equalizeHist(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY))
        faces = det.detectMultiScale(
            gray, scaleFactor=1.15, minNeighbors=5, minSize=(min_size, min_size)
        )
        return [FaceBox(int(x), int(y), int(w), int(h)) for x, y, w, h in faces]
    if kind == "yunet":
        h, w = frame_rgb.shape[:2]
        det.setInputSize((w, h))
        _, faces = det.detect(np.ascontiguousarray(frame_rgb[..., ::-1]))
        if faces is None:
            return []
        # rows: x, y, w, h, 5 landmark (x, y) pairs, score
        return [
            FaceBox(
                int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                tuple((float(f[4 + 2 * i]), float(f[5 + 2 * i])) for i in range(5)),
            )
            for f in faces
            if f[2] >= min_size and f[3] >= min_size
        ]
    return _detect_skin_regions(frame_rgb, min_size)


def _feather_mask(h: int, w: int, ramp_frac: float = 0.15) -> np.ndarray:
    """2-D cosine-ramp feather mask in [0, 1] (float64)."""

    def ramp(n):
        r = max(int(n * ramp_frac), 1)
        e = 0.5 - 0.5 * np.cos(np.pi * (np.arange(r) + 0.5) / r)
        m = np.ones(n)
        m[:r] = e
        m[n - r:] = e[::-1]
        return m

    return ramp(h)[:, None] * ramp(w)[None, :]


@functools.lru_cache(maxsize=64)
def _feather_t(h: int, w: int, device: torch.device) -> torch.Tensor:
    """:func:`_feather_mask` (float64) on ``device``, copied there once per
    size."""
    return to_device(_feather_mask(h, w), device)


def _blend_u8(new: torch.Tensor, old: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``clip(new * m + old * (1 - m), 0, 255).astype(uint8)`` in float64
    (numpy's promotion of float32 images and a float64 mask), truncating;
    m: (H, W) float64."""
    m = m[..., None]
    blended = new.double() * m + old.double() * (1.0 - m)
    return blended.clamp(0, 255).to(torch.uint8)


def enhance_face_regions(
    hr_frame: torch.Tensor, faces_lr: List[FaceBox], scale: int, strength: float = 0.5
) -> torch.Tensor:
    """Smooth and sharpen each face region of the upscaled frame and
    feather it back. hr_frame: (H, W, 3) uint8 tensor; faces_lr: boxes in
    LR coordinates."""
    if not faces_lr:
        return hr_frame
    out = hr_frame.clone()
    hh, ww = hr_frame.shape[:2]
    for box in faces_lr:
        b = box.scaled(scale).expanded(0.25, ww, hh)
        if b.w < 8 or b.h < 8:
            continue
        region = hr_frame[b.y : b.y + b.h, b.x : b.x + b.w]
        # edge-preserving smooth, then sharpen what remains (skin smooths,
        # eyes and edges crispen)
        smooth = bilateral_u8(region, 7, 30, 30).float()
        blur = gaussian_blur(smooth, 1.2)
        enhanced = torch.clamp(smooth + (1.0 + strength) * (smooth - blur), 0, 255)
        out[b.y : b.y + b.h, b.x : b.x + b.w] = _blend_u8(
            enhanced, region.float(), _feather_t(b.h, b.w, out.device)
        )
    return out


# ---------------------------------------------------------------------------
# learned face restoration (GFPGAN v1-clean prior)
# ---------------------------------------------------------------------------

# The canonical FFHQ 5-point template at 512 px (right eye, left eye, nose
# tip, right mouth corner, left mouth corner): the public facexlib constant
# the upstream GFPGAN tool aligns faces to.
FFHQ_TEMPLATE_512 = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.1936],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    np.float32,
)


def align_transform(landmarks: np.ndarray) -> "np.ndarray | None":
    """The similarity transform (2x3, float32) that maps 5 landmarks onto
    :data:`FFHQ_TEMPLATE_512` by least squares, or None for degenerate
    landmarks. The JAX package calls ``cv2.estimateAffinePartial2D(LMEDS)``,
    which refines the same least squares over the points it keeps as
    inliers: the two agree when every landmark is an inlier."""
    src = np.asarray(landmarks, np.float32).astype(np.float64).reshape(5, 2)
    dst = FFHQ_TEMPLATE_512.astype(np.float64)
    sm, dm = src.mean(0), dst.mean(0)
    sc, dc = src - sm, dst - dm
    den = float((sc**2).sum())
    if not den > 1e-12:
        return None
    a = float((sc[:, 0] * dc[:, 0] + sc[:, 1] * dc[:, 1]).sum()) / den
    b = float((sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum()) / den
    tx = dm[0] - (a * sm[0] - b * sm[1])
    ty = dm[1] - (b * sm[0] + a * sm[1])
    m = np.array([[a, -b, tx], [b, a, ty]])
    if not np.isfinite(m).all():
        return None
    # a degenerate scale (collinear or duplicate landmarks): unusable warp
    if not 1e-3 < math.hypot(a, b) < 1e3:
        return None
    return m.astype(np.float32)


# crops per forward of the prior. On an NVIDIA H100 80GB HBM3 (700.00 W)
# cuDNN's fp32 algorithms ran 19.3 ms a crop at batch 1 against 144.3 at
# batch 2, 87.8 at 4 and 22.9 at 8 (chip_smoke.py [gfpgan]), so one crop a
# forward is the fastest without the autotuner
_MAX_CROPS = 1


def make_gfpgan_runner(
    models_dir=None, name: str = "GFPGANv1.4", device=None
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Load the GFPGAN prior onto ``device`` and return a crop restorer,
    or None when the weights are missing (callers fall back to the region
    heuristic). The runner maps (N, 512, 512, 3) float32 [0, 1] crops, a
    tensor on ``device``, to restored crops, at most ``_MAX_CROPS`` per
    forward, in fp32 (TF32 off) as the JAX package runs the prior."""
    from video_restore_tpu_torch.models.gfpgan import GFPGAN, load_gfpgan

    try:
        state, spec = load_gfpgan(models_dir, name)
    except Exception:
        return None
    net = GFPGAN(spec)
    net.load_state_dict(state)
    net = net.to(device or "cpu").eval()

    @torch.no_grad()
    def run(crops: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(0, crops.shape[0], _MAX_CROPS):
            x = crops[i : i + _MAX_CROPS].permute(0, 3, 1, 2)
            outs.append(net(x, precision="fp32").permute(0, 2, 3, 1))
        return torch.cat(outs)

    return run


def _warp_window(m_inv: np.ndarray, ww: int, hh: int):
    """The frame window (x0, y0, x1, y1) outside which a crop warped back
    with ``m_inv`` (crop -> frame) has no weight: the bounding box of the
    512x512 square's image, one pixel wider on each side, inside the
    frame."""
    sq = np.array([[-1.0, -1.0], [512.0, -1.0], [-1.0, 512.0], [512.0, 512.0]])
    a = m_inv.astype(np.float64)
    pts = sq @ a[:, :2].T + a[:, 2]
    x0 = max(int(math.floor(pts[:, 0].min())) - 1, 0)
    y0 = max(int(math.floor(pts[:, 1].min())) - 1, 0)
    x1 = min(int(math.ceil(pts[:, 0].max())) + 2, ww)
    y1 = min(int(math.ceil(pts[:, 1].max())) + 2, hh)
    return x0, y0, x1, y1


def restore_faces_learned(
    hr_frame: torch.Tensor,
    faces_lr: List[FaceBox],
    scale: int,
    runner,
    strength: float = 0.5,
) -> torch.Tensor:
    """Restore each face with the GFPGAN prior and feather it back.
    hr_frame: (H, W, 3) uint8 tensor; faces_lr: LR-coordinate boxes;
    ``strength`` blends restored against original (GFPGAN's ``weight``):
    0 leaves the frame, 1 takes the restored face.

    A face with landmarks is warped to the FFHQ template before the prior
    and warped back on paste; a box without landmarks takes the loose
    square crop."""
    if not faces_lr or runner is None:
        return hr_frame
    dev = hr_frame.device
    hh, ww = hr_frame.shape[:2]
    aligned = []  # the 2x3 map frame -> template of each aligned face
    boxes = []  # (x0, y0, side) of each loose-square face
    # two crop lists: aligned and square faces may interleave in detection
    # order, and the batch is split by position below
    crops_aligned, crops_boxes = [], []
    for box in faces_lr:
        b = box.scaled(scale)
        m = (
            align_transform(np.asarray(b.landmarks, np.float32))
            if b.landmarks is not None
            else None
        )
        if m is not None:
            crop = warp_affine(hr_frame, m, (512, 512), (135, 133, 132))
            aligned.append(m)
            crops_aligned.append(crop.float() / 255.0)
            continue
        # a square crop with margin, GFPGAN's loose alignment
        side = int(max(b.w, b.h) * 1.6)
        cx, cy = b.x + b.w // 2, b.y + b.h // 2
        x0 = max(0, min(cx - side // 2, ww - side))
        y0 = max(0, min(cy - side // 2, hh - side))
        side = min(side, ww - x0, hh - y0)
        if side >= 32:
            boxes.append((x0, y0, side))
            crop = resize_linear(hr_frame[y0 : y0 + side, x0 : x0 + side], (512, 512))
            crops_boxes.append(crop.float() / 255.0)
    crops = crops_aligned + crops_boxes
    if not crops:
        return hr_frame

    restored = runner(torch.stack(crops))
    rest_aligned = restored[: len(aligned)]
    rest_boxes = restored[len(aligned):]

    out = hr_frame.float()
    feather512 = _feather_t(512, 512, dev).float()[..., None]
    for m, rest in zip(aligned, rest_aligned):
        inv = invert_affine(m)
        x0, y0, x1, y1 = _warp_window(inv, ww, hh)
        if x1 <= x0 or y1 <= y0:
            continue
        win = dict(dsize=(x1 - x0, y1 - y0), origin=(x0, y0))
        back = warp_affine(torch.clamp(rest, 0.0, 1.0) * 255.0, inv, **win)
        mask = warp_affine(feather512, inv, **win) * strength
        out[y0:y1, x0:x1] = back * mask + out[y0:y1, x0:x1] * (1.0 - mask)
    out = out.clamp(0, 255).to(torch.uint8)

    for (x0, y0, s), rest in zip(boxes, rest_boxes):
        back = resize_linear((torch.clamp(rest, 0.0, 1.0) * 255.0).to(torch.uint8), (s, s))
        region = out[y0 : y0 + s, x0 : x0 + s]
        out[y0 : y0 + s, x0 : x0 + s] = _blend_u8(
            back.float(), region.float(), _feather_t(s, s, dev) * strength
        )
    return out

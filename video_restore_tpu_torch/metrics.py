"""Video quality metrics harness: PSNR/SSIM between two videos.

Port of ``video_restore_tpu/metrics.py``, numpy/scipy on the host as there
(PSNR, luma SSIM, MS-SSIM, GMSD, ``compare_videos`` and the CLI): compare
an output video against a reference rendition frame by frame. The
device-side PSNR/SSIM of training are ``training/losses.py``.

CLI:  python -m video_restore_tpu_torch.metrics ref.y4m test.y4m [--frames N]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np

from video_restore_tpu_torch.video import open_reader


def frame_psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


def frame_ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Luma SSIM (Wang et al., 11x11 Gaussian window), pure numpy/scipy on
    the host."""
    from scipy.ndimage import gaussian_filter

    def lum(x):
        x = x.astype(np.float64) / 255.0
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    x, y = lum(a), lum(b)
    sig, trunc = 1.5, 3.5 / 1.5  # 11-tap window
    f = lambda im: gaussian_filter(im, sig, truncate=trunc, mode="nearest")
    c1, c2 = 0.01**2, 0.03**2
    mu_x, mu_y = f(x), f(y)
    sxx = f(x * x) - mu_x * mu_x
    syy = f(y * y) - mu_y * mu_y
    sxy = f(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2)
    return float(np.mean(num / den))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def frame_msssim(a: np.ndarray, b: np.ndarray) -> float:
    """Multi-scale SSIM (Wang et al. 2003), 5 dyadic scales with the
    published weights — the weight-free perceptual metric (an LPIPS-class
    learned metric needs pretrained VGG weights, unreachable here).
    Contrast/structure terms at every scale, luminance at the coarsest;
    2x average-pool between scales."""
    from scipy.ndimage import gaussian_filter

    def lum(x):
        x = x.astype(np.float64) / 255.0
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    def pool2(im):
        h2, w2 = im.shape[0] // 2, im.shape[1] // 2
        return im[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean((1, 3))

    x, y = lum(a), lum(b)
    sig, trunc = 1.5, 3.5 / 1.5
    c1, c2 = 0.01**2, 0.03**2
    vals = []
    for lvl, wgt in enumerate(_MSSSIM_WEIGHTS):
        if min(x.shape) < 11:
            # image exhausted before 5 scales: renormalize what we have
            total = sum(_MSSSIM_WEIGHTS[lvl:])
            vals = [v ** (1.0 / (1.0 - total)) for v in vals]
            break
        f = lambda im: gaussian_filter(
            im, sig, truncate=trunc, mode="nearest"
        )
        mu_x, mu_y = f(x), f(y)
        sxx = f(x * x) - mu_x * mu_x
        syy = f(y * y) - mu_y * mu_y
        sxy = f(x * y) - mu_x * mu_y
        cs = np.mean((2 * sxy + c2) / (sxx + syy + c2))
        if lvl == len(_MSSSIM_WEIGHTS) - 1:
            l_term = np.mean(
                (2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)
            )
            vals.append(np.abs(l_term * cs) ** wgt)
        else:
            vals.append(np.abs(cs) ** wgt)
            x, y = pool2(x), pool2(y)
    return float(np.prod(vals))


def frame_gmsd(a: np.ndarray, b: np.ndarray) -> float:
    """Gradient Magnitude Similarity Deviation (Xue et al. 2014): a
    weight-free perceptual metric well-correlated with human ratings of
    restoration quality — usable where LPIPS-class learned metrics are
    not (zero-egress: no downloadable backbones). Lower is better;
    0 = identical. Standard parameters: 2x average-pool prefilter,
    Prewitt gradients, c = 170 on the [0, 255] scale."""
    from scipy.ndimage import convolve, uniform_filter

    def lum(x):
        x = x.astype(np.float64)
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    def pre(x):
        # 2x2 average pool with stride 2 (the paper's downsampling);
        # origin=-1 anchors the window at (i, i+1) so the strided pick
        # pools (x0,x1),(x2,x3) like reference implementations — the
        # centered default pooled (x-1,x0),(x1,x2), a half-pixel shift
        x = uniform_filter(x, size=2, mode="nearest", origin=-1)
        return x[::2, ::2]

    x, y = pre(lum(a)), pre(lum(b))
    hx = np.array([[1, 0, -1], [1, 0, -1], [1, 0, -1]], np.float64) / 3.0
    hy = hx.T

    def gm(im):
        gx = convolve(im, hx, mode="nearest")
        gy = convolve(im, hy, mode="nearest")
        return np.sqrt(gx * gx + gy * gy)

    gmr, gmd = gm(x), gm(y)
    c = 170.0
    gms = (2.0 * gmr * gmd + c) / (gmr * gmr + gmd * gmd + c)
    return float(np.std(gms))


def compare_videos(
    ref_path: str,
    test_path: str,
    max_frames: int = 0,
    ssim_every: int = 1,
    msssim: bool = False,
    gmsd: bool = False,
) -> Dict[str, float]:
    """Frame-aligned PSNR/SSIM (MS-SSIM with ``msssim=True``, GMSD with
    ``gmsd=True``). Raises if dimensions or counts mismatch."""
    psnrs, ssims, msssims, gmsds = [], [], [], []
    with open_reader(ref_path) as ra, open_reader(test_path) as rb:
        for i, (fa, fb) in enumerate(zip(ra, rb)):
            if max_frames and i >= max_frames:
                break
            if fa.shape != fb.shape:
                raise ValueError(
                    f"frame {i}: shape mismatch {fa.shape} vs {fb.shape}"
                )
            psnrs.append(frame_psnr(fa, fb))
            if i % ssim_every == 0:
                ssims.append(frame_ssim(fa, fb))
                if msssim:
                    msssims.append(frame_msssim(fa, fb))
                if gmsd:
                    gmsds.append(frame_gmsd(fa, fb))
    if not psnrs:
        raise ValueError("no overlapping frames")
    finite = [p for p in psnrs if np.isfinite(p)]
    out = {
        "frames": len(psnrs),
        "psnr_mean": float(np.mean(finite)) if finite else float("inf"),
        "psnr_min": float(np.min(finite)) if finite else float("inf"),
        "ssim_mean": float(np.mean(ssims)),
        "ssim_min": float(np.min(ssims)),
    }
    if msssims:
        out["msssim_mean"] = float(np.mean(msssims))
        out["msssim_min"] = float(np.min(msssims))
    if gmsds:
        out["gmsd_mean"] = float(np.mean(gmsds))
        out["gmsd_max"] = float(np.max(gmsds))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PSNR/SSIM between two videos")
    ap.add_argument("reference")
    ap.add_argument("test")
    ap.add_argument("--frames", type=int, default=0, help="limit frames")
    ap.add_argument("--ssim-every", type=int, default=1)
    ap.add_argument("--msssim", action="store_true",
                    help="also compute multi-scale SSIM")
    ap.add_argument("--gmsd", action="store_true",
                    help="also compute GMSD (weight-free perceptual "
                         "metric; lower is better)")
    args = ap.parse_args(argv)
    result = compare_videos(
        args.reference, args.test, args.frames, args.ssim_every,
        msssim=args.msssim, gmsd=args.gmsd,
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fine-tune a zoo model on the user's own footage.

Port of ``video_restore_tpu/training/finetune.py``, the same flags:

    python -m video_restore_tpu_torch.training.finetune CLIP.mp4 \\
        --model RealESRGAN_x4plus_anime_6B --steps 200 \\
        --out models/finetuned.npz [--cpu]

Samples HR patches from the input video (the same draws as the JAX
package, so the same patches from the same clip), degrades them on the
fly and minimizes the Charbonnier loss on the GPU (``--cpu``: on the host;
without a GPU and without ``--cpu`` it raises). The result is a drop-in
``.npz`` in the JAX zoo's key layout, which both packages load: pass
``--models-dir`` with it renamed to ``{model}.npz``, or read it with
``models.zoo.load_params_npz``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List

import numpy as np


def sample_patches(
    video_paths: List[str],
    patch: int,
    max_patches: int,
    scale: int,
    seed: int = 0,
) -> np.ndarray:
    """Random HR patches (N, patch, patch, 3) float32 in [0,1] from videos."""
    from video_restore_tpu_torch.video import open_reader

    rng = np.random.default_rng(seed)
    patches = []
    for vp in video_paths:
        with open_reader(vp) as r:
            stride = max((r.info.frames or 100) // 40, 1)
            for i, frame in enumerate(r):
                if i % stride:
                    continue
                h, w = frame.shape[:2]
                if h < patch or w < patch:
                    continue
                for _ in range(4):
                    y = rng.integers(0, h - patch + 1)
                    x = rng.integers(0, w - patch + 1)
                    p = frame[y : y + patch, x : x + patch]
                    if p.std() < 8:  # skip flat patches
                        continue
                    patches.append(p.astype(np.float32) / 255.0)
                    if len(patches) >= max_patches:
                        return np.stack(patches)
    if not patches:
        raise ValueError("no usable patches found (inputs too small/flat?)")
    return np.stack(patches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Fine-tune a Real-ESRGAN model")
    ap.add_argument("inputs", nargs="+", help="video file(s) to learn from")
    ap.add_argument("--model", default="RealESRGAN_x4plus_anime_6B")
    ap.add_argument("--out", default="models/finetuned.npz")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--patch-size", type=int, default=128)
    ap.add_argument("--max-patches", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory for a resumable torch.save checkpoint")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the host CPU (default: the GPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from video_restore_tpu_torch.models.zoo import ModelHandle, get_model, save_params_npz
    from video_restore_tpu_torch.training.train import Trainer, save_checkpoint
    from video_restore_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.cpu)
    model = get_model(
        args.model,
        allow_random=os.environ.get("VRT_ALLOW_RANDOM_WEIGHTS") == "1",
    )
    print(f"sampling patches from {len(args.inputs)} video(s)...")
    hr = sample_patches(
        args.inputs, args.patch_size, args.max_patches, model.scale,
        args.seed,
    )
    print(f"  {hr.shape[0]} patches of {args.patch_size}px")

    trainer = Trainer(
        model.train_module(device), model.scale, learning_rate=args.lr,
        device=device,
    )
    print(f"training {args.steps} steps on {device}...")
    params = trainer.fit_patches(hr, args.steps, seed=args.seed)
    print(f"  loss {trainer.losses[0]:.4f} -> {trainer.losses[-1]:.4f}")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_params_npz(ModelHandle(model.name, model.spec, params).jax_params(), Path(args.out))
    if args.checkpoint_dir:
        save_checkpoint(
            Path(args.checkpoint_dir).resolve(), params,
            trainer.opt_state, args.steps,
        )
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

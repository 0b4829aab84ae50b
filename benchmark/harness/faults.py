"""Faults planted in the program under test, to show that the comparison
catches them (``benchmark/tests``, ``control.py --mode fault-...``). Each
patches the port in this process while its context lasts.

- ``state_unchanged``: the step returns its temporal state unchanged: the
  carry is put back to its initial value (no previous frame) after every
  batch, so no frame is blended with the one before it;
- ``answer_altered``: each answer is altered where it is produced: the I420
  conversion adds ``delta`` levels to every luma byte of its output.

The two other faults the contract lists cannot occur in these cells: a
batch is one frame (no half of it to leave out) and one card runs it (no
exchange between chips).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def state_unchanged():
    from video_restore_tpu_torch.parallel import dispatch

    orig = dispatch.Upscaler.process_batch

    def process_batch(self, frames_u8):
        out = orig(self, frames_u8)
        self._carry = None  # the next batch starts from the initial carry
        return out

    dispatch.Upscaler.process_batch = process_batch
    try:
        yield
    finally:
        dispatch.Upscaler.process_batch = orig


@contextlib.contextmanager
def answer_altered(delta: int = 8):
    from video_restore_tpu_torch.parallel import dispatch

    orig = dispatch.rgb_to_yuv420_planar

    def rgb_to_yuv420_planar(rgb, dither=False):
        out = orig(rgb, dither=dither)
        h = rgb.shape[1]
        out[:, :h] = torch.clamp(out[:, :h].int() + delta, 0, 255).to(torch.uint8)
        return out

    dispatch.rgb_to_yuv420_planar = rgb_to_yuv420_planar
    try:
        yield
    finally:
        dispatch.rgb_to_yuv420_planar = orig


FAULTS = {"state": state_unchanged, "answer": answer_altered}

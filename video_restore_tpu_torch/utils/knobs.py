"""Registry of every ``VRT_*`` environment knob the port reads.

Port of ``video_restore_tpu/utils/knobs.py`` for the port's own surface:
the names below are the ones ``video_restore_tpu_torch`` and
``chip_smoke.py`` read, each with the JAX package's meaning.
``tests/test_torch_metrics.py`` greps the port's sources for
``VRT_[A-Z0-9_]+`` and holds this set to them in both directions.
:func:`warn_unknown_knobs` runs at CLI startup and warns about any
``VRT_*`` in the environment that no code of the port reads, so that a
misspelled knob does not silently do nothing.

The JAX names the port leaves out, and why:

- the TPU layout knobs (``VRT_STRIPE*``, ``VRT_SRVGG_*``, ``VRT_SD*``,
  ``VRT_NPACK*``, ``VRT_NOMASK``, ``VRT_SPLIT*``, ``VRT_TAIL_*`` but
  ``VRT_TAIL_Q``, ``VRT_UP1_*``, ``VRT_ACCUM``, ``VRT_IM2COL`` and the
  like) choose how a Pallas kernel lays its work out on the TPU, not what
  it computes; the port's kernels have layouts of their own;
- ``VRT_UNSHARP_KERNEL=0`` would put the plain version of the sharpen on
  the card's main path, so the port keeps K2 there;
- ``VRT_XLA_CACHE`` (XLA's compilation cache) and ``VRT_BENCH_TILE`` (a
  benchmark harness outside the package) have no counterpart here.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("video_restore_tpu_torch")

KNOWN_KNOBS = frozenset(
    {
        "VRT_ALLOW_RANDOM_WEIGHTS",  # random weights when no file is found
        "VRT_DISABLE_NATIVE",  # numpy in place of the native framecodec
        "VRT_GFPGAN_RANDOM",  # random GFPGAN weights without GFPGANv1.4.pth
        "VRT_HBM_BYTES",  # the device bytes auto_full_frame sizes against
        "VRT_NATIVE_CACHE",  # where the framecodec library is built
        "VRT_PALLAS",  # the one-launch RRDB body (K5), on the GPU only
        "VRT_POST_BF16",  # =1: the unsharp blur of the XLA form in bf16
        "VRT_POST_DT",  # =bf16: a full-frame step's post stack in bf16
        "VRT_PRECISION",  # the body precision when the caller names none
        "VRT_TAIL_Q",  # the one-launch tail (K6), on the GPU only
        "VRT_UNSAFE_PICKLE",  # full pickle loading of released .pth files
        "VRT_YUNET_MODEL",  # the YuNet face detector's .onnx file
    }
)


def warn_unknown_knobs(environ=None) -> list[str]:
    """Warn (once per name) about VRT_* environment variables no code of
    the port reads; returns the offending names (sorted)."""
    env = os.environ if environ is None else environ
    unknown = sorted(
        k for k in env if k.startswith("VRT_") and k not in KNOWN_KNOBS
    )
    for name in unknown:
        logger.warning(
            "unknown knob %s is set but nothing in the port reads it "
            "(typo? see video_restore_tpu_torch/utils/knobs.py)",
            name,
        )
    return unknown

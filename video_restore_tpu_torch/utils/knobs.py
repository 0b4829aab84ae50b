"""Registry of every ``VRT_*`` environment knob the port reads.

Port of ``video_restore_tpu/utils/knobs.py`` for the port's own surface:
the names below are the ones ``video_restore_tpu_torch`` and
``chip_smoke.py`` read, each with the JAX package's meaning (the JAX
registry's TPU-only knobs are not read here and are not listed).
``tests/test_torch_metrics.py`` greps the port's sources for
``VRT_[A-Z0-9_]+`` and holds this set to them in both directions.
:func:`warn_unknown_knobs` runs at CLI startup and warns about any
``VRT_*`` in the environment that no code of the port reads, so that a
misspelled knob does not silently do nothing.
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
        "VRT_NATIVE_CACHE",  # where the framecodec library is built
        "VRT_PALLAS",  # the one-launch RRDB body (K5), on the GPU only
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

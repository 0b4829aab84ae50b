"""Decode -> restore -> encode pipeline (port of ``video_restore_tpu/pipeline``)."""

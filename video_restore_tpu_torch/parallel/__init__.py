"""The restore step and its one-GPU upscaler (port of ``video_restore_tpu/parallel``)."""

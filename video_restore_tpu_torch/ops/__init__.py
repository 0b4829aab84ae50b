"""Plain PyTorch ops and the CUDA kernel wrappers (port of ``video_restore_tpu/ops``)."""

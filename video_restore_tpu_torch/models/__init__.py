"""Models and weight loading (port of ``video_restore_tpu/models``)."""

"""The benchmark of the PyTorch/CUDA port (``video_restore_tpu_torch``):
``python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once on the GPU. PERF.md describes it."""

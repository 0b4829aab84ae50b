"""peak_mem_gib (GiB, device, program counter): PyTorch's
``max_memory_allocated`` over the window, after a reset at its start; in
a traced run, over the window's untraced rest, after a reset when the
profiler stops (profiling raises the allocator's peak: 5.0-5.5 GiB traced
against 2.3 untraced on x4plus_1080p_enhanced, PERF.md)."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2.0**30

"""setup_s (s, end to end, host clock): from the benchmark process's start
to the window's opening: imports, the kernel library's build or load, the
weights on the device, VideoRestorer, and the first frames through the
pipeline."""


def read(run):
    return run.setup_s

"""post_device_ms (ms/frame, restore step, device trace): device time of
the kernels that are not the program's library's (the post stack, the
colour conversion, the casts: PyTorch's own kernels), copies and memsets
left out, a frame that reached the sink inside the traced window."""


def read(run):
    frames = run.traced_frames()
    if run.trace is None or not run.trace.sound() or not frames:
        return None
    tr = run.trace
    s = tr.seconds(lambda cat, name: cat == "kernel" and not tr.is_library(name))
    return 1000.0 * s / frames

"""copy_device_ms (ms/frame, staging, device trace): device time of the
host-to-device and device-to-host copies (and any other memcpy) a frame
that reached the sink inside the traced window."""


def read(run):
    frames = run.traced_frames()
    if run.trace is None or not run.trace.sound() or not frames:
        return None
    s = run.trace.seconds(lambda cat, name: cat == "gpu_memcpy")
    return 1000.0 * s / frames

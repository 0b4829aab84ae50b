"""device_idle_pct (%, device, device trace): 100 minus the share of the
traced window in which a kernel, a copy or a memset ran (the union of
their intervals)."""


def read(run):
    if run.trace is None or not run.trace.sound() or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

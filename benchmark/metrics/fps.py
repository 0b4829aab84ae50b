"""fps (frames/s, end to end, host clock): frames whose last byte reached
the sink inside the window, over the window's seconds."""


def read(run):
    return len(run.in_window) / run.seconds

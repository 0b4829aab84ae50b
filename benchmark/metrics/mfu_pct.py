"""mfu_pct (%, model step, device trace): the model's least FLOPs a frame
(``work/<config>.py``) times the frames that reached the sink inside the
traced window, over the window's seconds and the card's bf16 peak."""

from benchmark.harness.peaks import peaks


def read(run):
    pk = peaks(run.device_kind)
    frames = run.traced_frames()
    if run.trace is None or not run.trace.sound() or pk is None or not frames:
        return None
    h, w = run.lr_shape
    flops = run.cell.work.flops_per_frame(h, w) * frames
    return 100.0 * flops / run.trace.window_s / pk["bf16_flops"]

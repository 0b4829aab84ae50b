"""model_roofline_pct (%, kernels, device trace): the model's least work
a frame at the card's peaks, the larger of FLOPs over bf16 FLOP/s and
bytes over HBM bytes/s (``work/<config>.py``), times the frames that
reached the sink inside the traced window, over the device time of every
kernel of the program's own library in that window."""

from benchmark.harness.peaks import peaks


def read(run):
    pk = peaks(run.device_kind)
    frames = run.traced_frames()
    if run.trace is None or not run.trace.sound() or pk is None or not frames:
        return None
    tr = run.trace
    lib_s = tr.library_seconds()
    if lib_s <= 0:
        return None
    h, w = run.lr_shape
    work = run.cell.work
    least = max(work.flops_per_frame(h, w) / pk["bf16_flops"], work.bytes_per_frame(h, w) / pk["hbm_bytes_per_s"])
    return 100.0 * least * frames / lib_s

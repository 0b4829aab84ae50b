"""frame_gap_p90_ms (ms, end to end, host clock): the 90th percentile of
the gaps between consecutive frames reaching the sink inside the window
(sink stamps, monotonic clock): what a streaming user sees as stalls."""

import statistics


def read(run):
    t = sorted(run.stamps[i] for i in run.in_window)
    gaps = [b - a for a, b in zip(t, t[1:])]
    if len(gaps) < 10:
        return None
    return 1000.0 * statistics.quantiles(gaps, n=10, method="inclusive")[8]

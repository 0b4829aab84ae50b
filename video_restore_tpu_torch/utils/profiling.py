"""Profiling / tracing hooks.

Port of ``video_restore_tpu/utils/profiling.py``:

- :func:`device_trace`: a ``torch.profiler`` trace (CPU and, where CUDA is
  available, CUDA activities) of a block, written as a Chrome trace
  (``DIR/trace.json``, viewable in Perfetto or ``chrome://tracing``);
  ``--profile DIR`` wraps each video's pipeline in it, where the JAX CLI
  wraps it in ``jax.profiler.trace``;
- :func:`device_busy_share`: from such a trace, the share of its window in
  which the device ran a kernel, a copy or a memset (the device's idle
  share is one minus it);
- :class:`StageTimer`: the per-stage wall-clock totals of the pipeline
  (decode-wait, dispatch, fetch, encode, ...), safe across the dispatch
  and encode threads.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import torch

from video_restore_tpu_torch.utils.logging import get_logger

log = get_logger()

TRACE_FILE = "trace.json"
# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(trace_dir: Optional[Union[str, Path]]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` into ``trace_dir/trace.json``
    (a no-op when ``trace_dir`` is empty). The trace is written also when
    the block raises."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / TRACE_FILE))
        log.info("device trace written to %s (open in Perfetto)", out / TRACE_FILE)


def device_busy_share(trace_path: Union[str, Path]) -> Dict[str, float]:
    """The device's busy time in a Chrome trace of :func:`device_trace`: the
    union of its kernel, copy and memset intervals (``busy_ms``) over the
    window from the first event's start to the last event's end
    (``window_ms``), their ratio (``share``) and the number of device events
    (``events``)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events if e.get("ph") == "X"]
    device = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
    )
    busy, end = 0.0, float("-inf")
    for t0, t1 in device:  # the union of the sorted intervals
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = (max(t for _, t in spans) - min(t for t, _ in spans)) if spans else 0.0
    return dict(
        busy_ms=busy / 1e3, window_ms=window / 1e3,
        share=busy / window if window > 0 else 0.0, events=float(len(device)),
    )


class StageTimer:
    """Accumulates wall-clock per pipeline stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()  # the dispatch and encode threads both time

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.totals[name] += time.perf_counter() - t0

"""One run of one cell: the feeder, the program's streaming path and the
sink; the window; the metrics; the comparison.

The window opens when the traffic's ``warm_frames``-th output frame has
reached the sink (its monotonic stamp), and closes ``seconds`` later. A
traced run traces the window's first ``trace_frames`` frames. It
does not wait for the program's queues to drain: at the close the feeder
is killed and the sink stops reading, so the program's next write breaks
its pipe and ``process_video`` ends, as it does when ffmpeg downstream
exits. Nothing compiles inside the window: the first frames, before it
opens, build or load every kernel the stream's one shape uses.
"""

from __future__ import annotations

import gc
import importlib
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark.harness import check, program
from benchmark.harness.spec import ROOT, Cell, reader
from benchmark.harness.trace import Tracer

WARM_TIMEOUT_S = 1500.0  # a checkout's first run builds the kernel library


class _SinkReader(threading.Thread):
    """Reads the sink's reports: the stamp of every frame, then the kept
    frames."""

    def __init__(self, f, warm: int):
        super().__init__(name="bench-sink", daemon=True)
        self.f, self.warm = f, warm
        self.stamps: Dict[int, float] = {}
        self.kept: Dict[int, bytes] = {}
        self.warmed = threading.Event()

    def run(self) -> None:
        f = self.f
        while True:
            line = f.readline()
            if not line or line == b"E\n":
                break
            tag, a, b = line.split()
            if tag == b"F":
                self.stamps[int(a)] = float(b)
                if len(self.stamps) >= self.warm:
                    self.warmed.set()
            elif tag == b"K":
                self.kept[int(a)] = f.read(int(b))
        self.warmed.set()


class Run:
    """What the metric readers read (``metrics/<metric>.py``)."""

    def __init__(self, cell: Cell, setup_s: float, t_open: float, t_close: float,
                 stamps: Dict[int, float], trace, peak_window_bytes: Optional[int], device_kind: str):
        self.cell = cell
        self.setup_s = setup_s
        self.t_open, self.t_close = t_open, t_close
        self.seconds = t_close - t_open
        self.stamps = stamps
        self.in_window = sorted(i for i, t in stamps.items() if t_open < t <= t_close)
        self.trace = trace
        self.peak_window_bytes = peak_window_bytes
        self.device_kind = device_kind
        traffic = cell.traffic
        self.lr_shape = (int(traffic["height"]), int(traffic["width"]))

    def traced_frames(self) -> int:
        """Frames that reached the sink inside the traced window."""
        if self.trace is None:
            return 0
        a = self.trace.host_t0
        return sum(1 for t in self.stamps.values() if a < t <= a + self.trace.window_s)


def _spawn(args: List[str], **kw) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "benchmark.harness.stream", *args], cwd=ROOT, **kw)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        extra_args: List[str] = ()) -> Dict:
    """One run; returns the result's fields (without ``device``)."""
    traffic, cfg = cell.traffic, cell.config
    warm = int(traffic["warm_frames"])
    feeder = _spawn(["feed", str(cell.traffic_path), str(seed)], stdout=subprocess.PIPE)
    sink = _spawn(["sink", str(traffic["shot_frames"]), str(traffic["compare_frames"])],
                  stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    feed_fd, sink_fd = os.dup(feeder.stdout.fileno()), os.dup(sink.stdin.fileno())
    feeder.stdout.close()
    sink.stdin.close()
    reports = _SinkReader(sink.stdout, warm)
    reports.start()
    pipe = None
    tracer = tr = None
    error = None
    phases = {"harness": time.monotonic() - t_start}
    try:
        family = importlib.import_module(f"benchmark.reference.{cfg['family']}")
        handle = program.model_handle(cfg, family.make_weights(cfg, seed, device))
        restore_config = program.build_config(list(cfg["args"]) + list(traffic["job"]) + list(extra_args))
        if trace:
            Tracer.prime()
        pipe = program.Pipeline(restore_config, handle, feed_fd, sink_fd, cpu=device.type == "cpu")
        del handle
        phases["restorer"] = time.monotonic() - t_start
        pipe.start()
        deadline = time.monotonic() + WARM_TIMEOUT_S
        while not reports.warmed.wait(0.05):
            if not pipe.thread.is_alive() or time.monotonic() > deadline:
                break
        if len(reports.stamps) < warm:
            raise RuntimeError(f"the program streamed {len(reports.stamps)} frames before the window "
                               f"(wants {warm}): {pipe.error or pipe.quiet.errors or 'timed out'}")
        phases["first_frame"] = reports.stamps[0] - t_start
        t_open = reports.stamps[warm - 1]
        setup_s = t_open - t_start
        cuda = device.type == "cuda"
        peak_setup = torch.cuda.max_memory_allocated(device) if cuda else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t_close = t_open + seconds
        if trace:
            package = str(Path(sys.modules["video_restore_tpu_torch"].__file__).parent)
            tracer = Tracer(ROOT, pipe.thread.ident, package)
            tracer.start()
            traced_until = len(reports.stamps) + int(traffic["trace_frames"])
        while time.monotonic() < t_close:
            if tracer is not None and tr is None and len(reports.stamps) >= traced_until:
                tracer.stop()
                if cuda:  # the peak of the untraced rest: the profiler raises the allocator's peak
                    torch.cuda.reset_peak_memory_stats(device)
                tr = tracer.read()
            time.sleep(min(0.01, max(0.0, t_close - time.monotonic())))
        alive = pipe.thread.is_alive()
        if tracer is not None and tr is None:
            tracer.stop()
            tr = tracer.read()
        peak_window = torch.cuda.max_memory_allocated(device) if cuda else None
        if not alive:
            error = f"the program's pipeline ended inside the window: {pipe.error or pipe.quiet.errors}"
        elif pipe.quiet.errors:
            error = f"the program logged errors inside the window: {pipe.quiet.errors}"
    finally:
        feeder.kill()
        if sink.poll() is None:
            sink.send_signal(signal.SIGUSR1)
        if pipe is not None:
            pipe.finish(timeout=120)
        reports.join(timeout=120)
        feeder.wait(timeout=60)
        try:
            sink.wait(timeout=60)
        except subprocess.TimeoutExpired:
            sink.kill()
            sink.wait()
        sink.stdout.close()
        for fd in (feed_fd, sink_fd):
            try:
                os.close(fd)
            except OSError:
                pass
    stamps = dict(reports.stamps)
    launches = _launches()
    memory_peak = None
    if device.type == "cuda":
        memory_peak = max(peak_setup, peak_window)
    pipe.free()
    pipe = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec = Run(cell, setup_s, t_open, t_close, stamps, tr, peak_window, kind)
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    t_ref = time.monotonic()
    numbers, info = check.compare(cell, seed, reports.kept, set(rec.in_window), device)
    info["reference_s"] = time.monotonic() - t_ref
    ok = error is None and "error" not in info and check.passed(numbers)
    if error is not None:
        info["error"] = error
    out = {
        "correct": ok,
        "attempted": len(rec.in_window),
        # the compared frames are judged together
        "failed": 0 if ok else int(traffic["compare_frames"]),
        "metrics": metrics,
        "memory_peak_bytes": memory_peak,
        "info": dict(info, launches=launches, frames_streamed=len(stamps), setup_phases_s=phases,
                     peak_setup_bytes=peak_setup,
                     peak_window_bytes=peak_window,
                     frames_in_window=len(rec.in_window), setup_s=setup_s),
        "checks": numbers,
    }
    if tr is not None:
        out["busy_s"] = tr.busy_s()
        out["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
        out["info"]["trace_device_events"] = len(tr.events)
        out["info"]["trace_sound"] = tr.sound()
        out["info"]["library_identifiers"] = len(tr.library)
        out["info"]["library_kernels_in_trace"] = sorted(
            {n for c, n, _, _ in tr.events if c == "kernel" and tr.is_library(n)}
        )[:50]
    return out


def _launches() -> Dict[str, int]:
    from video_restore_tpu_torch.ops import _build

    return _build.launches()

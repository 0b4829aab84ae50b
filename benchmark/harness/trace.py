"""The traced run's device trace and host samples.

``Tracer`` starts ``torch.profiler`` (CUDA activity: the device's kernels,
copies and memsets, from every thread and stream) at the window's opening
and stops it after the traffic's ``trace_frames`` frames. A tiny marker
kernel on a stream of its own is launched just after the start and just
before the stop; the traced window is the time between the two markers on
the device's clock, and the markers map that clock onto the host's. The
trace is exported under ``TMPDIR``, read, and deleted.

A sampler thread reads the Python stack of the program's dispatch thread
(the thread that runs ``process_video``, which queues each step) every
``SAMPLE_S`` seconds, so that each idle gap of the device can be named by
what that thread was doing then.

``library_kernels`` reads the shared libraries the process loaded from the
program's checkout (``/proc/self/maps``) and returns the identifiers of
their functions: a device kernel whose name is among them is the program's
own; any other kernel is PyTorch's (the post stack, colour, casts).
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Set, Tuple

from benchmark.harness.elf import kernel_base_name, library_identifiers

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep
SAMPLE_S = 0.002


def loaded_libraries(root: Path) -> List[Path]:
    out = set()
    with open("/proc/self/maps") as f:
        for line in f:
            parts = line.split(None, 5)
            if len(parts) == 6:
                p = parts[5].strip()
                if p.endswith(".so") and Path(p).resolve().is_relative_to(root):
                    out.add(Path(p))
    return sorted(out)


def library_kernels(root: Path) -> Set[str]:
    return library_identifiers(loaded_libraries(root))


class _Sampler(threading.Thread):
    def __init__(self, thread_id: int, package_dir: str):
        super().__init__(name="bench-sampler", daemon=True)
        self.tid = thread_id
        self.pkg = package_dir
        self.samples: List[Tuple[float, str]] = []
        self._stop_evt = threading.Event()

    def _label(self, frame) -> str:
        leaf = frame
        while frame is not None and not frame.f_code.co_filename.startswith(self.pkg):
            frame = frame.f_back
        if frame is None:
            return f"{leaf.f_code.co_name}"
        where = f"{os.path.relpath(frame.f_code.co_filename, self.pkg)}:{frame.f_code.co_name}"
        return where if frame is leaf else f"{where} > {leaf.f_code.co_name}"

    def run(self) -> None:
        while not self._stop_evt.wait(SAMPLE_S):
            frame = sys._current_frames().get(self.tid)
            if frame is not None:
                self.samples.append((time.monotonic(), self._label(frame)))

    def stop(self) -> None:
        self._stop_evt.set()
        self.join()


class Trace:
    """Device events of the traced window, in seconds from its start."""

    def __init__(self, events: List[Tuple[str, str, float, float]], window_s: float,
                 library: Set[str], host_t0: float, samples: List[Tuple[float, str]]):
        self.events = events  # (category, name, start, end), clipped to [0, window_s]
        self.window_s = window_s
        self.library = library
        self.host_t0 = host_t0  # host monotonic time of the window's start
        self.samples = samples

    def is_library(self, name: str) -> bool:
        return kernel_base_name(name) in self.library

    def library_seconds(self) -> float:
        return self.seconds(lambda cat, name: cat == "kernel" and self.is_library(name))

    def sound(self) -> bool:
        """Whether the trace recorded the program's kernels: on an H100 a
        traced run now and then kept the copies and the markers but lost
        every kernel of the dispatch thread, and then reads nothing."""
        return self.library_seconds() > 0

    def seconds(self, pred) -> float:
        return sum(t1 - t0 for cat, name, t0, t1 in self.events if pred(cat, name))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, _, t0, t1 in sorted(self.events, key=lambda e: e[2]):
            if out and t0 <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], t1))
            else:
                out.append((t0, t1))
        return out

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, end = [], 0.0
        for t0, t1 in self.busy_intervals():
            if t0 > end:
                gaps.append((end, t0))
            end = max(end, t1)
        if end < self.window_s:
            gaps.append((end, self.window_s))
        return gaps

    def host_label(self, t0: float, t1: float) -> str:
        """What the dispatch thread was doing most often from window time
        t0 to t1 (the nearest sample where none falls inside)."""
        a, b = self.host_t0 + t0, self.host_t0 + t1
        inside = [lab for t, lab in self.samples if a <= t <= b]
        if inside:
            return collections.Counter(inside).most_common(1)[0][0]
        if not self.samples:
            return "unsampled"
        mid = (a + b) / 2
        return min(self.samples, key=lambda s: abs(s[0] - mid))[1]

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = collections.defaultdict(float)
        for cat, name, t0, t1 in self.events:
            by_op[kernel_base_name(name) if cat == "kernel" else name] += t1 - t0
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return {
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[self.host_label(t0, t1), t1 - t0] for t0, t1 in gaps],
        }


class Tracer:
    def __init__(self, root: Path, dispatch_thread_id: int, package_dir: str):
        self.root = root
        self.sampler = _Sampler(dispatch_thread_id, package_dir)
        self.prof = None
        self._marks: List[float] = []

    def _mark(self) -> None:
        import torch

        with torch.cuda.stream(self._stream):
            self._marks.append(time.monotonic())
            torch.cuda._sleep(2000)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        # the device's activity only (CUPTI records it for every thread);
        # with CPU activity on every thread, a run now and then lost all
        # of the dispatch thread's kernels
        return profile(activities=[ProfilerActivity.CUDA])

    @classmethod
    def prime(cls) -> None:
        """Trace a few kernels once, from this thread and another, in
        set-up: a process's first start initialises CUPTI, which took ~10 s
        on an H100, and would otherwise eat into the traced window."""
        import torch

        def work():
            x = torch.ones(256, 256, device="cuda")
            (x @ x).sum().item()

        p = cls._profile()
        p.start()
        t = threading.Thread(target=work)
        t.start()
        work()
        t.join()
        p.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            p.export_chrome_trace(path)
        finally:
            os.unlink(path)

    def start(self) -> None:
        import torch

        self._stream = torch.cuda.Stream()
        self.prof = self._profile()
        self.prof.start()
        self.sampler.start()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._stream.synchronize()  # the second marker has run
        self.prof.stop()
        self.sampler.stop()

    def read(self) -> Trace:
        """Export, read and delete the trace; the device events between
        the two markers."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        dev = [
            (e["cat"], e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in raw
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
        ]
        del raw
        marks = sorted(t0 for cat, name, t0, _ in dev if cat == "kernel" and MARKER in name)
        if len(marks) >= 2:
            w0, w1 = marks[0], marks[-1]
        else:  # no markers in the trace: the span of the device events
            w0, w1 = min(e[2] for e in dev), max(e[3] for e in dev)
        window_s = (w1 - w0) * 1e-6
        events = []
        for cat, name, t0, t1 in dev:
            if MARKER in name:
                continue
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                events.append((cat, name, (a - w0) * 1e-6, (b - w0) * 1e-6))
        return Trace(events, window_s, library_kernels(self.root), self._marks[0], self.sampler.samples)

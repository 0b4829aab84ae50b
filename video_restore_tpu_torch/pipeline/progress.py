"""Progress reporting: tqdm bar with live FPS, plain-print fallback.

Port of ``video_restore_tpu/pipeline/progress.py``.

Mirrors the reference's ``_show_progress`` UX (video_upscaler.py:572-602):
frames/s is the first-class metric (BASELINE.md north star)."""

from __future__ import annotations

import time

class Progress:
    def __init__(self, total: int, desc: str = "Upscaling", enabled: bool = True):
        self.total = total
        self.count = 0
        self._t0 = time.time()
        self._last_print = 0.0
        self._bar = None
        if enabled:
            try:
                from tqdm import tqdm

                self._bar = tqdm(
                    total=total or None, desc=desc, unit="frame", smoothing=0.1
                )
            except ImportError:  # plain fallback (video_upscaler.py:598-601)
                pass
        self.enabled = enabled

    def update(self, n: int = 1) -> None:
        self.count += n
        if self._bar is not None:
            self._bar.update(n)
            elapsed = time.time() - self._t0
            if elapsed > 0:
                self._bar.set_postfix(fps=f"{self.count / elapsed:.2f}")
        elif self.enabled:
            now = time.time()
            if now - self._last_print >= 1.0:
                self._last_print = now
                fps = self.count / max(now - self._t0, 1e-9)
                total = f"/{self.total}" if self.total else ""
                # stderr: stdout may carry the y4m stream in pipe mode
                import sys

                print(
                    f"  {self.count}{total} frames  {fps:.2f} fps",
                    flush=True, file=sys.stderr,
                )

    @property
    def fps(self) -> float:
        return self.count / max(time.time() - self._t0, 1e-9)

    def close(self) -> None:
        if self._bar is not None:
            self._bar.close()

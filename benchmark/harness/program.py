"""The system under test: the port's streaming path, as a user runs
``ffmpeg ... | video-restore - - | ffmpeg ...``.

The configuration's and the traffic's CLI arguments go through the port's
own ``cli.build_parser`` and ``config_from_args``; ``VideoRestorer`` gets
the benchmark's seeded weights; ``process_video("-", "-")`` runs in a
thread of its own (the dispatch thread) with the process's ``sys.stdin``
and ``sys.stdout`` bound to the feeder's and the sink's pipes.
"""

from __future__ import annotations

import io
import logging
import sys
import threading
from typing import Dict, List, Optional

import torch


class _Quiet(logging.Filter):
    """Drops the program's log records once the window has closed (the
    benchmark ends the stream by breaking its pipes)."""

    def __init__(self):
        super().__init__()
        self.closed = False
        self.errors: List[str] = []

    def filter(self, record: logging.LogRecord) -> bool:
        if self.closed:
            return False
        if record.levelno >= logging.ERROR:
            self.errors.append(record.getMessage())
        return True


def build_config(argv: List[str]):
    from video_restore_tpu_torch.cli import build_parser, config_from_args

    return config_from_args(build_parser().parse_args(["-", "-"] + list(argv)))


def model_handle(cfg: Dict, weights: Dict[str, torch.Tensor]):
    """The port's ModelHandle of the configuration's model with the given
    weights; its spec must have the configuration's widths."""
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO, ModelHandle

    spec = MODEL_ZOO[cfg["model"]].spec
    for key, val in cfg["spec"].items():
        if getattr(spec, key) != val:
            raise ValueError(f"{cfg['model']}: the port's {key} is {getattr(spec, key)}, the configuration's {val}")
    return ModelHandle(cfg["model"], spec, weights)


class Pipeline:
    """``VideoRestorer.process_video("-", "-")`` on the feeder's output,
    writing to the sink, in the dispatch thread."""

    def __init__(self, restore_config, handle, feed_fd: int, sink_fd: int, cpu: bool = False):
        from video_restore_tpu_torch.pipeline.runner import VideoRestorer
        from video_restore_tpu_torch.utils.logging import get_logger

        self.quiet = _Quiet()
        self._log = log = get_logger()
        log.addFilter(self.quiet)
        self._handler = None
        if not log.handlers:
            self._handler = logging.StreamHandler(sys.stderr)
            log.addHandler(self._handler)
        log.setLevel(logging.WARNING)
        self.restorer = VideoRestorer(restore_config, model=handle, cpu=cpu)
        # the standard streams as a shell pipeline gives them to the CLI
        self._in = io.TextIOWrapper(open(feed_fd, "rb"))
        self._out = io.TextIOWrapper(open(sink_fd, "wb"))
        self.ok: Optional[bool] = None
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, name="dispatch", daemon=True)

    def _run(self) -> None:
        try:
            self.ok = self.restorer.process_video("-", "-", show_progress=False)
        except BaseException as e:  # reported by the harness
            self.error = e

    def start(self) -> None:
        self._saved = (sys.stdin, sys.stdout)
        sys.stdin, sys.stdout = self._in, self._out
        self.thread.start()

    def finish(self, timeout: float) -> None:
        """After the window: wait for the dispatch thread (the broken pipes
        end it), put the standard streams back and close the pipe ends."""
        self.quiet.closed = True
        self.thread.join(timeout)
        self._log.removeFilter(self.quiet)
        if self._handler is not None:
            self._log.removeHandler(self._handler)
        sys.stdin, sys.stdout = self._saved
        for f in (self._in, self._out):
            try:
                f.close()
            except (BrokenPipeError, ValueError, OSError):
                pass

    def free(self) -> None:
        """Drop the program's state (its model, buffers and pinned rings)."""
        self.restorer = None

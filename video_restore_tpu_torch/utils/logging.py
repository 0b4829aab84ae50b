"""Structured logging (port of ``video_restore_tpu/utils/logging.py``).

The reference advertises "Comprehensive Logging" (README.md:33) but only
prints and suppresses third-party loggers (video_upscaler.py:14-16). Here:
one namespaced logger, human console format by default, optional JSON-lines
file sink for machine consumption.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "data", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry)


def setup_logging(
    verbose: bool = False, json_file: Optional[str] = None
) -> logging.Logger:
    log = logging.getLogger("video_restore_tpu_torch")
    log.setLevel(logging.DEBUG if verbose else logging.INFO)
    log.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter("%(levelname).1s %(message)s"))
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    log.addHandler(console)
    if json_file:
        fh = logging.FileHandler(json_file)
        fh.setFormatter(JsonFormatter())
        fh.setLevel(logging.DEBUG)
        log.addHandler(fh)
    return log


def get_logger() -> logging.Logger:
    return logging.getLogger("video_restore_tpu_torch")

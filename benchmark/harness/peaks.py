"""The table of peaks (``benchmark/peaks.json``), by the device's name."""

from __future__ import annotations

import json
from typing import Dict, Optional

from benchmark.harness.spec import BENCH


def peaks(kind: str) -> Optional[Dict[str, float]]:
    table = json.loads((BENCH / "peaks.json").read_text())
    entry = table.get(kind)
    return None if entry is None else {k: float(v) for k, v in entry.items()}

"""Resolve a cell of ``BENCHMARK.json`` into the files of its own: the
configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<cell>.json``), the work counts of its configuration
(``work/<config>.py``) and its metrics (``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    traffic_path: Path
    limits: Dict
    work: object
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics a run of this cell reports: the end-to-end ones
        untraced, the per-layer ones traced; each only where it names this
        cell, or names none."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic_path = root / "benchmark" / "traffic" / f"{w['traffic']}.json"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=json.loads(traffic_path.read_text()),
        traffic_path=traffic_path,
        limits=json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text()),
        work=load_module(root / "benchmark" / "work" / f"{w['config']}.py"),
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"],
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of ``metrics/<metric>.py``, loaded by its path (a
    metric's name may hold dots)."""
    return load_module(root / "benchmark" / "metrics" / f"{metric}.py").read


def load_module(path: Path):
    """The module of a file found by a name from ``BENCHMARK.json`` (a
    name may hold dots and dashes, so it is loaded by its path)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

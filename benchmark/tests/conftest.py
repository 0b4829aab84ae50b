"""Tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA device and skip without one (the
``card`` fixture decides, inside the test); the others run on the CPU at
small sizes. None imports JAX."""

import json
from pathlib import Path

import pytest
import torch

# few intra-op threads: the machine may be shared
torch.set_num_threads(min(4, torch.get_num_threads()))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell(tmp_path):
    """A cell of BENCHMARK.json with its traffic cut to a small frame and
    short shots (written under tmp_path, where the feeder reads it)."""

    def make(name, width=64, height=48, shot_frames=4, warm_frames=2, **limits):
        from benchmark.harness.spec import load_cell

        cell = load_cell(name)
        t = dict(cell.traffic, width=width, height=height, shot_frames=shot_frames, warm_frames=warm_frames)
        path = tmp_path / f"{name}.traffic.json"
        path.write_text(json.dumps(t))
        cell.traffic, cell.traffic_path = t, path
        for k, v in limits.items():
            cell.limits = dict(cell.limits, **{k: {"limit": v}})
        return cell

    return make


REPO = Path(__file__).resolve().parents[2]

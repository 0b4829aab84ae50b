"""A whole run on the CPU at a small size, past the harness's look for a
card: the feeder, the port's streaming path, the sink, the window and the
comparison. A sound run is correct; each fault the cells can have, planted
in the program under test, makes ``correct`` false; the float8 control
reads above the limit; on x4v3 the program's own int8 path (the control of
that cell) is not correct. Without a card, run.py fails and prints no
result, traced or not; a traced run tries a fresh process when a trace
lost the program's kernels.

The small frames (96x64) read the program at 1.0-1.9 levels RMS where the
cells' 1080p frames read 0.5-0.9 (CLAHE's tiles and the frame's edges are
a larger share), so these runs hold ``frame_rms`` to 2.5,
``bytes_off2_pct`` to 30 (they read 9-14%, int8 alike) and
``ema_gain_err`` to 0.1 (up to 0.03; the state fault reads over 0.9). At 320x192 the
sound x4v3 program reads ~3% and its int8 path ~20%: the int8 test runs
there, against the cell's own limits."""

import contextlib
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.faults import FAULTS
from benchmark.harness.spec import load_module
from benchmark.tests.conftest import REPO

CELLS = ["x4plus_1080p_enhanced", "x4v3_1080p_anime"]
SECONDS = {"x4plus_1080p_enhanced": 24.0, "x4v3_1080p_anime": 6.0}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "state", "answer"])
def test_a_run_on_the_cpu(cell, fault, small_cell):
    c = small_cell(cell, width=96, height=64, shot_frames=3, frame_rms=2.5, bytes_off2_pct=30.0,
                   ema_gain_err=0.1)
    planted = FAULTS[fault]() if fault else contextlib.nullcontext()
    with planted:
        res = runner.run(c, 2**31 + 77, SECONDS[cell], False, torch.device("cpu"), time.monotonic())
    assert res["attempted"] >= c.traffic["compare_frames"]
    assert {"fps", "setup_s"} <= set(res["metrics"])  # the p90 gap wants 10 gaps in the window
    assert res["correct"] is (fault is None), res["checks"]
    if fault == "state":
        assert res["checks"]["ema_gain_err"]["value"] > 0.9
    if fault == "answer":
        assert res["checks"]["frame_rms"]["value"] > 5


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails(cell, small_cell):
    control = load_module(REPO / "benchmark" / "control.py")
    c = small_cell(cell, width=96, height=64)
    numbers, _ = control.fp8_control(c, 2**31 + 78, torch.device("cpu"))
    assert numbers["frame_rms"]["value"] > 2.5
    assert numbers["frame_rms"]["value"] > c.limits["frame_rms"]["limit"]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_the_int8_control_fails_on_x4v3(precision, small_cell):
    c = small_cell(CELLS[1], width=320, height=192, shot_frames=3)
    extra = ["--precision", "int8"] if precision == "int8" else []
    res = runner.run(c, 2**31 + 79, 25.0, False, torch.device("cpu"), time.monotonic(), extra_args=extra)
    assert res["correct"] is (precision == "bf16"), res["checks"]
    if precision == "int8":
        assert res["checks"]["bytes_off2_pct"]["value"] > c.limits["bytes_off2_pct"]["limit"]


@pytest.mark.parametrize("trace", [0, 1])
def test_no_card_no_result(trace):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[1], "--seed", "1", "--seconds", "1",
         "--trace", str(trace)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


ATTEMPT = "import os, sys; sys.exit(75 if int(os.environ['BENCHMARK_TRACE_ATTEMPT']) < {} else 0)"


@pytest.mark.parametrize("sound_at, rc", [(1, 0), (2, 0), (3, 0), (4, 4)])
def test_a_trace_that_lost_the_kernels_is_tried_again(sound_at, rc, monkeypatch):
    run = load_module(REPO / "benchmark" / "run.py")
    monkeypatch.delenv(run.TRACE_ATTEMPT, raising=False)
    assert run.traced([], command=[sys.executable, "-c", ATTEMPT.format(sound_at)]) == rc

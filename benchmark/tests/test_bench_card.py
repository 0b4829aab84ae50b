"""The same checks on the card, at the cells' own 1080p frames (shots cut
to 8 frames, so that a short window holds a cut): a sound run is correct,
each planted fault makes ``correct`` false, the float8 control reads
above the cell's limit, and on x4v3 the program's int8 path is not correct. Marked ``card``: each skips without a CUDA device."""

import contextlib
import time

import pytest

from benchmark.harness import runner
from benchmark.harness.faults import FAULTS
from benchmark.harness.spec import load_module
from benchmark.tests.conftest import REPO

CELLS = ["x4plus_1080p_enhanced", "x4v3_1080p_anime"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "state", "answer"])
def test_a_run_on_the_card(cell, fault, card, small_cell):
    c = small_cell(cell, width=1920, height=1080, shot_frames=8, warm_frames=4)
    planted = FAULTS[fault]() if fault else contextlib.nullcontext()
    with planted:
        res = runner.run(c, 2**31 + 91, 8.0, False, card, time.monotonic())
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_on_the_card(cell, card, small_cell):
    control = load_module(REPO / "benchmark" / "control.py")
    c = small_cell(cell, width=1920, height=1080, shot_frames=8)
    numbers, _ = control.fp8_control(c, 2**31 + 92, card)
    assert numbers["frame_rms"]["value"] > c.limits["frame_rms"]["limit"]


@pytest.mark.card
def test_the_int8_control_fails_on_the_card(card, small_cell):
    c = small_cell(CELLS[1], width=1920, height=1080, shot_frames=8, warm_frames=4)
    res = runner.run(c, 2**31 + 93, 8.0, False, card, time.monotonic(), extra_args=["--precision", "int8"])
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["bytes_off2_pct"]["value"] > c.limits["bytes_off2_pct"]["limit"]

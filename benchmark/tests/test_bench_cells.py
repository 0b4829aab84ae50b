"""BENCHMARK.json keeps to its contract, and every cell resolves from its
files: configuration, traffic, limits, work counts and metric readers."""

import json
import re

import pytest

from benchmark.harness.spec import load_cell, load_module, reader
from benchmark.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24  # what later PRs may add
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.fullmatch(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert c["reduced"] == [] and 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"]) and len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = load_cell(name)
    assert cell.config["reduced"] == [] and cell.config["precision"] == "bf16"
    for key in ("width", "height", "shot_frames", "pan_px", "job", "step", "warm_frames", "compare_frames",
                "trace_frames"):
        assert key in cell.traffic
    assert set(cell.limits) >= {"frame_rms", "ema_gain_err", "cut_margin"}
    for m in cell.metrics(False) + cell.metrics(True):
        assert callable(reader(m["name"]))
    assert {m["name"] for m in cell.metrics(False)} >= {"setup_s", "fps"}
    assert cell.metrics(True)


def test_config_widths_are_the_published_ones():
    x4plus = json.loads((REPO / "benchmark/configs/realesrgan_x4plus.json").read_text())
    assert (x4plus["num_feat"], x4plus["num_grow_ch"], x4plus["num_block"], x4plus["scale"]) == (64, 32, 23, 4)
    v3 = json.loads((REPO / "benchmark/configs/realesr_general_x4v3.json").read_text())
    assert (v3["num_feat"], v3["num_conv"], v3["upscale"], v3["act_type"]) == (64, 32, 4, "prelu")


def test_the_ports_specs_match_the_configurations():
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO

    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        spec = MODEL_ZOO[cfg["model"]].spec
        assert {k: getattr(spec, k) for k in cfg["spec"]} == cfg["spec"]


@pytest.mark.parametrize("config, flops, params", [
    ("realesrgan_x4plus", 7.265e13, 16697987),
    ("realesr_general_x4v3", 5.014e12, 1213296),
])
def test_work_counts(config, flops, params):
    work = load_module(REPO / "benchmark" / "work" / f"{config}.py")
    assert work.flops_per_frame(1080, 1920) == pytest.approx(flops, rel=1e-3)
    assert work.params() == params


def test_work_counts_match_the_reference_weights():
    import torch

    from benchmark.reference import rrdbnet, srvgg

    for mod, file in ((rrdbnet, "realesrgan_x4plus"), (srvgg, "realesr_general_x4v3")):
        cfg = json.loads((REPO / f"benchmark/configs/{file}.json").read_text())
        w = mod.make_weights(cfg, 7, torch.device("cpu"))
        work = load_module(REPO / "benchmark" / "work" / f"{file}.py")
        assert sum(t.numel() for t in w.values()) == work.params()

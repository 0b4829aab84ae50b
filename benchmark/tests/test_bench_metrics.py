"""Each metric reader on recorded fixtures: sink stamps give fps and the
p90 frame gap; a small synthetic trace gives the idle share, the split of
device time between the program's library and the rest, the copies, and
the rooflines."""

import statistics

import pytest

from benchmark.harness.elf import kernel_base_name, mangled_identifiers
from benchmark.harness.runner import Run
from benchmark.harness.spec import load_cell, reader
from benchmark.harness.trace import Trace

LIB = "void (anonymous namespace)::conv3x3_wgmma_kernel<8, true, false>(CUtensorMap_st, (anonymous namespace)::ConvArgs)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int, Foo)"


def stamps_run(stamps, t_open, t_close, trace=None, peak=None, kind="NVIDIA H100 80GB HBM3"):
    return Run(load_cell("x4plus_1080p_enhanced"), 12.5, t_open, t_close, stamps, trace, peak, kind)


def test_fps_and_frame_gap_from_sink_stamps():
    # frames 0-3 before the window, then a frame every 0.3 s with every
    # fifth gap 0.5 s; the window opens at frame 3's stamp
    t, stamps = 0.0, {}
    for i in range(60):
        t += 0.5 if i % 5 == 4 else 0.3
        stamps[i] = t
    t_open, t_close = stamps[3], stamps[3] + 10.0
    run = stamps_run(stamps, t_open, t_close)
    inside = [i for i in stamps if t_open < stamps[i] <= t_close]
    assert reader("fps")(run) == pytest.approx(len(inside) / 10.0)
    gaps = [stamps[b] - stamps[a] for a, b in zip(inside, inside[1:])]
    want = statistics.quantiles(gaps, n=10, method="inclusive")[8] * 1000
    assert reader("frame_gap_p90_ms")(run) == pytest.approx(want)
    assert 300 < want <= 500
    assert reader("setup_s")(run) == 12.5


def synthetic_trace():
    # a 1.0 s traced window: library kernels 0.5 s, PyTorch kernels 0.2 s
    # (0.05 s of it overlapping a copy), copies 0.1 s, a memset 0.01 s
    events = [
        ("kernel", LIB, 0.0, 0.3),
        ("kernel", LIB, 0.4, 0.6),
        ("kernel", TORCH, 0.6, 0.8),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 0.75, 0.85),
        ("gpu_memset", "Memset (Device)", 0.9, 0.91),
    ]
    return Trace(events, 1.0, {"conv3x3_wgmma_kernel", "stem_kernel"}, 100.0,
                 [(100.35, "ops/post.py:_clahe_luma"), (100.95, "pipeline/runner.py:_run > get")])


def traced_run(frames=4):
    stamps = {i: 100.0 + (i + 0.5) / frames for i in range(frames)}
    stamps.update({-1: 99.0, 99: 102.0})  # outside the traced window
    return stamps_run(stamps, 99.5, 105.0, synthetic_trace(), peak=3 * 2**30)


def test_trace_readers():
    run = traced_run()
    assert run.traced_frames() == 4
    assert reader("device_idle_pct")(run) == pytest.approx(100 * (1 - (0.3 + 0.2 + 0.2 + 0.05 + 0.01)))
    assert reader("post_device_ms")(run) == pytest.approx(1000 * 0.2 / 4)
    assert reader("copy_device_ms")(run) == pytest.approx(1000 * 0.1 / 4)
    work = run.cell.work
    least = max(work.flops_per_frame(1080, 1920) / 989e12, work.bytes_per_frame(1080, 1920) / 3.35e12)
    assert reader("model_roofline_pct")(run) == pytest.approx(100 * least * 4 / 0.5)
    assert reader("mfu_pct")(run) == pytest.approx(100 * work.flops_per_frame(1080, 1920) * 4 / 1.0 / 989e12)
    assert reader("peak_mem_gib")(run) == pytest.approx(3.0)


def test_readers_read_nothing_without_what_they_need():
    run = stamps_run({0: 1.0, 1: 2.0}, 0.5, 3.0)
    for name in ("mfu_pct", "model_roofline_pct", "post_device_ms", "copy_device_ms", "device_idle_pct",
                 "frame_gap_p90_ms", "peak_mem_gib"):
        assert reader(name)(run) is None
    other_card = traced_run()
    other_card.device_kind = "some other card"
    assert reader("mfu_pct")(other_card) is None and reader("model_roofline_pct")(other_card) is None
    lost = traced_run()  # a trace that kept the copies but lost the program's kernels
    lost.trace.events = [e for e in lost.trace.events if e[0] != "kernel"]
    for name in ("mfu_pct", "model_roofline_pct", "post_device_ms", "copy_device_ms", "device_idle_pct"):
        assert reader(name)(lost) is None


def test_breakdown_names_ops_and_gaps():
    b = synthetic_trace().breakdown()
    assert b["device_ops"][0] == ["conv3x3_wgmma_kernel", pytest.approx(0.5)]
    names = dict((n, s) for n, s in b["device_ops"])
    assert names["vectorized_elementwise_kernel"] == pytest.approx(0.2)
    gaps = b["idle_gaps"]
    assert gaps[0] == ["ops/post.py:_clahe_luma", pytest.approx(0.1)]
    assert ["pipeline/runner.py:_run > get", pytest.approx(0.09)] in gaps


def test_kernel_names_and_library_symbols():
    assert kernel_base_name(LIB) == "conv3x3_wgmma_kernel"
    assert kernel_base_name(TORCH) == "vectorized_elementwise_kernel"
    assert kernel_base_name("vr_plain_c_kernel") == "vr_plain_c_kernel"
    sym = "_ZN50_GLOBAL__N__f5542483_17_tail_fused_mma_cu_1471689e15tail_mma_kernelENS_8TailArgsE"
    assert {"tail_mma_kernel", "TailArgs"} <= mangled_identifiers(sym)
    assert mangled_identifiers("vr_conv3x3") == {"vr_conv3x3"}


def test_library_functions_from_an_elf_file(tmp_path):
    """A small shared library's defined functions, read by the ELF reader:
    a C function by its name, C++ functions (a template, one in an
    anonymous namespace) by their identifiers; what it imports is left out."""
    import shutil
    import subprocess

    from benchmark.harness.elf import function_symbols, library_identifiers

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the fixture library")
    src = tmp_path / "k.cpp"
    src.write_text(
        '#include <cmath>\n'
        'extern "C" double vr_entry(double x) { return std::sqrt(x); }\n'
        'namespace { template <int N> double conv_kernel(double x) { return x * N; } }\n'
        'double use(double x) { return conv_kernel<3>(x) + conv_kernel<5>(x); }\n'
    )
    lib = tmp_path / "libk.so"
    subprocess.run([cxx, "-O0", "-shared", "-fPIC", str(src), "-o", str(lib)], check=True)
    syms = function_symbols(lib)
    assert "vr_entry" in syms and not any("sqrt" in s for s in syms)
    ids = library_identifiers([lib])
    assert {"vr_entry", "conv_kernel", "use"} <= ids

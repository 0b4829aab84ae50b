"""The kernel library's build and the K2, K1 (bf16 and fp32), K5 and tail probes, on a machine without nvcc.

``ops/_build.py`` starts one ``nvcc`` per source, all together, then links;
``build.log`` gives each source's wall seconds, so a run shows which source
is the long pole. A fake ``nvcc`` (a Python script that writes its ``-o``
file, prints a ``ptxas`` line, and sleeps or fails where an environment
variable says) stands in for the compiler. ``tools/probe_k2.py`` builds K2's
sources alone with probe defines; its list of builds and its reader of
``ptxas`` output are held here, its timings on the card only
(``python -m video_restore_tpu_torch.tools.probe_k2``).
"""

import shutil
import sys

import pytest
import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.tools import probe_k1, probe_k2, probe_k5k3, probe_k6

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

FAKE_NVCC = """
import os, pathlib, sys, time
args = sys.argv[1:]
out = pathlib.Path(args[args.index("-o") + 1])
if "-c" in args:
    name = pathlib.Path(args[args.index("-c") + 1]).name
    if name == os.environ.get("FAKE_NVCC_FAIL"):
        print(name + ": error: no such luck")
        sys.exit(1)
    slow = os.environ.get("FAKE_NVCC_SLOW", "=").split("=")
    if name == slow[0]:
        time.sleep(float(slow[1]))
    print("ptxas info    : Used 10 registers, used 1 barriers")
out.write_bytes(b"")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``_build`` with a fake nvcc and its own build directory."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    for name in ("FAKE_NVCC_FAIL", "FAKE_NVCC_SLOW"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_the_build_times_each_source(fake_nvcc):
    """Each source's seconds are its own nvcc's (not the wait for the ones
    before it in the list): the slow source shows its 2 s, and some other
    source less."""
    fake_nvcc.setenv("FAKE_NVCC_SLOW", "unsharp_rows_bf16.cu=2")
    out = _build.build()
    assert out.exists() and out.parent == _build.BUILD_DIR
    secs = _build.compile_seconds((_build.BUILD_DIR / "build.log").read_text())
    assert list(secs) == list(_build.SOURCES)
    assert "conv3x3_wgmma.cu" in secs  # K1's Hopper route, its own nvcc
    assert "conv3x3_bf16x3_wgmma.cu" in secs  # K1's fp32 route, its own nvcc beside it
    assert "rdb_fused_wgmma.cu" in secs  # K5's Hopper route, its own nvcc
    # K5's fp32-FMA instances, each its own nvcc beside the entry points
    assert {"rdb_fused.cu", "rdb_fused_f32.cu", "rdb_fused_bf16.cu",
            "rdb_fused_narrow.cu"} <= set(secs)
    assert secs["unsharp_rows_bf16.cu"] >= 2.0
    assert min(secs.values()) < secs["unsharp_rows_bf16.cu"]
    assert _build.build() == out  # built once: the hash names the library


def test_a_failing_source_is_named(fake_nvcc):
    fake_nvcc.setenv("FAKE_NVCC_FAIL", "unsharp_rows.cu")
    with pytest.raises(RuntimeError, match=r"nvcc failed for \['unsharp_rows.cu'\]"):
        _build.build()
    log = (_build.BUILD_DIR / "build.log").read_text()
    assert "== unsharp_rows.cu (rc 1, " in log and "no such luck" in log
    assert "unsharp_rows.cu" in _build.compile_seconds(log)
    assert not list(_build.BUILD_DIR.glob("*.so"))


def test_compile_seconds_reads_the_log_lines():
    log = "== a.cu (rc 0, 12.5 s)\nptxas info\n== b.cu (rc 1, 3.0 s)\n== c.cu (rc 0)\n"
    assert _build.compile_seconds(log) == {"a.cu": 12.5, "b.cu": 3.0}
    assert _build.compile_seconds("") == {}


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    """The rows kernel lives in ``unsharp_rows.cuh``, which neither source
    list names: the library's hash reads every file under ``csrc/``."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    (csrc / "unsharp_rows.cuh").write_text((csrc / "unsharp_rows.cuh").read_text() + "\n")
    assert _build.library_path() != before


# ---- tools/probe_k2.py ---------------------------------------------------------


def test_the_probe_builds_per_dtype():
    bf = {name: (src.name, entry, defs) for name, src, entry, defs in probe_k2.builds("bf16")}
    assert bf == {
        "tile full": ("unsharp.cu", "vr_unsharp_bf16", ()),
        "rows full": ("unsharp_rows_bf16.cu", "vr_unsharp_rows_bf16", ()),
        "rows no_math": ("unsharp_rows_bf16.cu", "vr_unsharp_rows_bf16", ("-DVR_PROBE_NO_MATH",)),
    }
    f32 = [(name, src.name, entry) for name, src, entry, _ in probe_k2.builds("fp32")]
    assert f32 == [
        ("tile full", "unsharp.cu", "vr_unsharp"),
        ("tile no_math", "unsharp.cu", "vr_unsharp"),
        ("tile const_decode", "unsharp.cu", "vr_unsharp"),
        ("rows full", "unsharp_rows.cu", "vr_unsharp_rows"),
        ("rows no_math", "unsharp_rows.cu", "vr_unsharp_rows"),
    ]
    for _, src, _, _ in probe_k2.builds("fp32") + probe_k2.builds("bf16"):
        assert src.exists()


def test_the_probe_needs_the_card(capsys):
    """Without a CUDA device it fails before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would time it")
    assert probe_k2.main(["--dtype", "bf16"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_the_probe_reads_ptxas_at_its_radius():
    text = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119unsharp_rows_kernel"
        "I13__nv_bfloat16Li3ELi4EEEvNS_6ParamsIT_EE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 79 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119unsharp_rows_kernel"
        "I13__nv_bfloat16Li3ELi14EEEvNS_6ParamsIT_EE' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]",
    ])
    assert probe_k2._ptxas_lines("rows full", text) == [
        "[build] rows full: Used 79 registers, used 1 barriers, 400 bytes cmem[0]; "
        "0 bytes spill stores, 0 bytes spill loads"
    ]


# ---- tools/probe_k1.py --route wgmma --------------------------------------------


def test_the_k1_probe_builds_its_variants():
    """The mma source as shipped first, then conv3x3_wgmma.cu's variants;
    ``--only`` picks names, ``--variant`` adds one."""
    builds = probe_k1.wgmma_builds()
    assert builds[0] == ("mma", "conv3x3_mma.cu", ())
    assert [b[0] for b in builds[1:]] == [n for n, _ in probe_k1.WGMMA_VARIANTS]
    assert {src for _, src, _ in builds[1:]} == {"conv3x3_wgmma.cu"}
    assert ("shipped", "conv3x3_wgmma.cu", ()) in builds
    assert ("no_mma", "conv3x3_wgmma.cu", ("-DVR_PROBE_NO_MMA",)) in builds
    extra = [probe_k1.parse_variant("deep=-DVR_WG_STAGES=6,-DVR_WG_ROWS=1")]
    assert extra == [("deep", ("-DVR_WG_STAGES=6", "-DVR_WG_ROWS=1"))]
    picked = probe_k1.wgmma_builds(extra, only=["shipped", "deep"])
    assert [b[0] for b in picked] == ["mma", "shipped", "deep"]
    for _, src, _ in builds:
        assert (_build.CSRC / src).exists()
    # every define names one of the source's switches
    text = (_build.CSRC / "conv3x3_wgmma.cu").read_text()
    for _, defs in probe_k1.WGMMA_VARIANTS:
        for d in defs:
            assert d[2:].split("=")[0] in text


@pytest.mark.parametrize("bad", ["noequals", "=-DX=1", "x=DX=1"])
def test_a_malformed_variant_is_refused(bad):
    with pytest.raises(ValueError, match="expected NAME=-DDEF"):
        probe_k1.parse_variant(bad)


def test_the_k1_probe_reads_ptxas():
    text = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120conv3x3_wgmma_kernel"
        "ILi8EEEv14CUtensorMap_stS1_NS_8ConvArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 592 bytes cmem[0]",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
        "are serialized due to the presence of Extern calls",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120conv3x3_wgmma_kernel"
        "ILi4EEEv14CUtensorMap_stS1_NS_8ConvArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 592 bytes cmem[0]",
    ])
    lines = probe_k1.ptxas_lines("shipped", text)
    assert lines[0] == ("[build] shipped n64: Used 168 registers, used 1 barriers, 592 bytes "
                        "cmem[0]; 0 bytes spill stores, 0 bytes spill loads")
    assert lines[1].startswith("[build] shipped: ptxas info    : (C7515) Potential")
    assert lines[2].startswith("[build] shipped n32: Used 96 registers") and "8 bytes spill" in lines[2]


def test_the_k1_probe_bounds():
    """Each conv's bound at 1x1080x1920: conv1-4 and conv_body by their
    bytes, conv5 by its operations; the five launches sum to 1.177 ms."""
    shape = (1, 1080, 1920)
    b = [probe_k1.conv_bound_ms(shape, 64 + 32 * k, 32, False) for k in range(4)]
    b.append(probe_k1.conv_bound_ms(shape, 192, 64, True))
    assert [by for _, by in b] == ["bytes"] * 4 + ["operations"]
    assert [round(t, 3) for t, _ in b] == [0.119, 0.158, 0.198, 0.238, 0.464]
    assert round(sum(t for t, _ in b), 3) == 1.177
    assert probe_k1.conv_bound_ms(shape, 64, 64, True) == pytest.approx((0.2377, "bytes"), abs=1e-4)


def test_the_k1_probe_builds_its_fp32_variants():
    """``--dtype fp32``: the fp32-FMA source as shipped first, then the
    bf16x3 source's variants; every define is one of its switches."""
    builds = probe_k1.fp32_builds()
    assert builds[0] == ("fma", "conv3x3.cu", ())
    assert [b[0] for b in builds[1:]] == [n for n, _ in probe_k1.FP32_VARIANTS]
    assert {src for _, src, _ in builds[1:]} == {"conv3x3_bf16x3_wgmma.cu"}
    extra = [probe_k1.parse_variant("r2=-DVR_X3_ROWS32=2")]
    assert [b[0] for b in probe_k1.fp32_builds(extra, only=["shipped", "r2"])] == [
        "fma", "shipped", "r2"]
    text = (_build.CSRC / "conv3x3_bf16x3_wgmma.cu").read_text()
    for _, defs in probe_k1.FP32_VARIANTS:
        for d in defs:
            assert d[2:].split("=")[0] in text
    for name in ("VR_X3_ROWS32", "VR_X3_ROWS64"):
        assert f"#define {name} " in text


@pytest.mark.parametrize("source,variant,bad", [
    ("conv3x3_bf16x3_wgmma.cu", "s3=-DVR_X3_STAGES=3", ["-DVR_X3_STAGES=3"]),
    ("conv3x3_bf16x3_wgmma.cu", "r2=-DVR_X3_ROWS32=2,-DVR_PROBE_NO_MMA", []),
    ("conv3x3_wgmma.cu", "deep=-DVR_WG_STAGES=6,-DVR_WG_ROWS=1,-DVR_WG_ROW=1",
     ["-DVR_WG_ROW=1"]),
])
def test_the_k1_probe_refuses_a_define_its_source_never_reads(source, variant, bad):
    """A misspelt knob would rebuild the shipped kernel under another name:
    ``--variant`` names only macros the source (or a header it includes)
    defines or tests."""
    assert probe_k1.unknown_defines(source, [probe_k1.parse_variant(variant)]) == bad
    own = probe_k1.FP32_VARIANTS if "bf16x3" in source else probe_k1.WGMMA_VARIANTS
    assert probe_k1.unknown_defines(source, own) == []
    if bad:  # refused before anything is built
        args = ["--variant", variant] + (["--dtype", "fp32"] if "bf16x3" in source
                                         else ["--route", "wgmma"])
        with pytest.raises(SystemExit) as e:
            probe_k1.main(args)
        assert e.value.code == 2


def test_the_k1_probe_fp32_bounds():
    """The fp32 RDB's bound at 1x1080x1920: six bf16 products a MAC at 989
    TFLOP/s, 6.03 ms for the five convs, each set by its operations (its
    fp32 bytes are less); up1 counts x once at the coarse grid."""
    shape = (1, 1080, 1920)
    b = [probe_k1.fp32_bound_ms(shape, 64 + 32 * k, 32, False) for k in range(4)]
    b.append(probe_k1.fp32_bound_ms(shape, 192, 64, True))
    assert [by for _, by in b] == ["operations"] * 5
    assert [round(t, 3) for t, _ in b] == [0.464, 0.696, 0.927, 1.159, 2.782]
    assert round(sum(t for t, _ in b), 3) == 6.029
    t, by = probe_k1.fp32_bound_ms((1, 2160, 3840), 64, 64, False, up2=True)
    assert by == "operations" and round(t, 3) == 3.71


def test_the_k1_probe_needs_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would time it")
    assert probe_k1.main(["--route", "wgmma", "--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert probe_k1.main(["--dtype", "fp32", "--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ---- tools/probe_k5k3.py --route wgmma ------------------------------------------


def test_the_k5_probe_builds_its_variants():
    """The mma source as shipped first, then rdb_fused_wgmma.cu's variants;
    ``--only`` picks names, ``--variant`` adds one; every define is one of
    the source's switches."""
    builds = probe_k5k3.k5_builds()
    assert builds[0] == ("mma", "rdb_fused_mma.cu", ())
    assert [b[0] for b in builds[1:]] == [n for n, _ in probe_k5k3.K5_VARIANTS]
    assert {src for _, src, _ in builds[1:]} == {"rdb_fused_wgmma.cu"}
    assert ("shipped", "rdb_fused_wgmma.cu", ()) in builds
    assert ("no_mma", "rdb_fused_wgmma.cu", ("-DVR_PROBE_NO_MMA",)) in builds
    extra = [probe_k1.parse_variant("one=-DVR_K5_ROWS=1")]
    picked = probe_k5k3.k5_builds(extra, only=["shipped", "one"])
    assert [b[0] for b in picked] == ["mma", "shipped", "one"]
    text = (_build.CSRC / "rdb_fused_wgmma.cu").read_text()
    for _, defs in probe_k5k3.K5_VARIANTS:
        for d in defs:
            assert d[2:].split("=")[0] in text
    assert set(probe_k5k3.UNCHECKED) <= {n for n, _ in probe_k5k3.K5_VARIANTS}


def test_the_k5_probe_needs_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would time it")
    assert probe_k5k3.main(["--route", "wgmma", "--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ---- --dtype fp32 of tools/probe_k5k3.py and tools/probe_k6.py -------------------


@pytest.mark.parametrize("probe,source", [(probe_k5k3, "rdb_fused_bf16x3.cu"),
                                          (probe_k6, "tail_fused_bf16x3.cu")])
def test_the_fp32_probes_build_their_variants(probe, source):
    """The shipped build first; every define is one of the source's switches
    (or of K1's, whose roles it includes); ``--only`` picks names,
    ``--variant`` adds one; the unchecked builds are variants."""
    assert probe.X3_SOURCE == source
    names = [n for n, _ in probe.X3_VARIANTS]
    assert names[0] == "shipped" and set(probe.X3_UNCHECKED) <= set(names)
    assert probe_k1.unknown_defines(source, probe.X3_VARIANTS) == []
    extra = [probe_k1.parse_variant("p2=-DVR_PROBE_PRODUCTS=2")]
    picked = probe.x3_builds(extra, only=["shipped", "p2"])
    assert [b[0] for b in picked][-2:] == ["shipped", "p2"]


def test_the_tail_probe_times_k6_fma_first():
    builds = probe_k6.x3_builds()
    assert builds[0] == ("fma", "tail_fused.cu", ())
    assert {src for _, src, _ in builds[1:]} == {"tail_fused_bf16x3.cu"}
    assert [slot for slot, _, _ in probe_k6.X3_CLOCKS] and set(probe_k6.X3_WALK) == {
        role for _, role, _ in probe_k6.X3_CLOCKS}


@pytest.mark.parametrize("probe", [probe_k5k3, probe_k6])
def test_the_fp32_probes_refuse_a_define_their_source_never_reads(probe, capsys):
    with pytest.raises(SystemExit) as e:
        probe.main(["--dtype", "fp32", "--variant", "bad=-DVR_X3_STAGES=3"])
    assert e.value.code == 2
    assert "never reads -DVR_X3_STAGES=3" in capsys.readouterr().err


@pytest.mark.parametrize("probe", [probe_k5k3, probe_k6])
def test_the_fp32_probes_need_the_card(probe, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the probe would time it")
    assert probe.main(["--dtype", "fp32", "--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err

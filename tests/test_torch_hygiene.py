"""The port stands alone: importing every module of
``video_restore_tpu_torch`` loads neither JAX nor any module of the JAX
package, and without CUDA the entry points refuse to run unless the CPU
was asked for, while kernel wrappers given CPU tensors run their plain
versions; OpenCV is imported only where the face detector chain and the
OpenCV video backend need it, and the face pass and the resize run
without it."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import video_restore_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
bad = sorted(
    k for k in sys.modules
    if k == "jax" or k.startswith("jax.") or k == "jaxlib" or k.startswith("jaxlib.")
    or k == "video_restore_tpu" or k.startswith("video_restore_tpu.")
)
print(len(mods), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    n, bad = r.stdout.strip().split(" ", 1)
    assert int(n) >= 25
    assert bad == "[]"


def test_no_source_names_the_jax_package():
    """No import of ``video_restore_tpu`` or ``jax`` anywhere in the port's
    sources (the prefix ``video_restore_tpu_torch`` is not a match)."""
    import re

    pat = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|video_restore_tpu)(\.|\s|$)", re.M
    )
    for path in (REPO / "video_restore_tpu_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path
    assert not pat.search((REPO / "chip_smoke.py").read_text())


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_refuse_without_cuda():
    _no_cuda()
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import random_model
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoRestorer(RestoreConfig(), model=random_model("RealESRGAN_x4plus_anime_6B"))
    assert resolve_device(True) == torch.device("cpu")


def test_cli_without_cuda_exits_1(tmp_path, capsys):
    _no_cuda()
    from video_restore_tpu_torch import cli
    from video_restore_tpu_torch.video.y4m import Y4MWriter

    src = tmp_path / "in.y4m"
    with Y4MWriter(src, 8, 8, 25) as w:
        w.write(np.zeros((8, 8, 3), np.uint8))
    assert cli.main([str(src), str(tmp_path / "out.y4m")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_wrappers_on_cpu_tensors_run_plain_versions():
    from video_restore_tpu_torch.ops import _build
    from video_restore_tpu_torch.ops.stripe import rdb_fused, rdb_fused_plain
    from video_restore_tpu_torch.ops.tail import tail_fused, tail_fused_plain
    from video_restore_tpu_torch.ops.unsharp import unsharp_fused
    from video_restore_tpu_torch.ops.post import unsharp_mask

    g = torch.Generator().manual_seed(0)
    nf, gc = 8, 4
    x = torch.rand(1, 5, 7, nf, generator=g)
    ws = [torch.randn(3, 3, nf + k * gc, gc if k < 4 else nf, generator=g) * 0.1
          for k in range(5)]
    bs = [torch.randn(gc if k < 4 else nf, generator=g) * 0.1 for k in range(5)]
    _build.reset_launches()
    assert torch.equal(rdb_fused(x, ws, bs, x), rdb_fused_plain(x, ws, bs, x))
    tw = [torch.randn(3, 3, nf, nf, generator=g) * 0.1, torch.zeros(nf)] * 2
    tw += [torch.randn(3, 3, nf, 3, generator=g) * 0.1, torch.zeros(3)]
    assert torch.equal(tail_fused(x, *tw), tail_fused_plain(x, *tw))
    y = torch.rand(1, 9, 11, 3, generator=g)
    assert torch.equal(unsharp_fused(y, 0.3, 1.5, 4), unsharp_mask(y, 0.3, 1.5, 4))
    assert _build.launches() == {}
    # building needs nvcc: nothing above tried to build
    assert _build._lib is None


def test_cv2_only_in_the_detector_chain_and_opencv_backend():
    """OpenCV is imported only by the OpenCV video backend and by the face
    detector chain (``_init_detector``, and ``detect_faces`` for the
    detectors it picked from OpenCV), never at module level: the geometry,
    the resizes and the GFPGAN path need none."""
    import ast

    def cv2_imports(node, fn, out):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom):
                mods = [child.module or ""]
            else:
                mods = []
            if any(m.split(".")[0] == "cv2" for m in mods):
                out.add(fn)
            inner = child.name if isinstance(child, ast.FunctionDef) else fn
            cv2_imports(child, inner, out)
        return out

    root = REPO / "video_restore_tpu_torch"
    found = set()
    for path in root.rglob("*.py"):
        rel = path.relative_to(root).as_posix()
        found |= {(rel, fn) for fn in cv2_imports(ast.parse(path.read_text()), "<module>", set())}
    assert found == {
        ("video/opencv_backend.py", "_cv2"), ("ops/faces.py", "_init_detector"),
        ("ops/faces.py", "detect_faces"),
    }


def test_face_pass_and_resize_run_without_cv2(monkeypatch):
    """With ``cv2`` unimportable (the card's machine) the detector chain
    takes the skin detector, and the face pass and the resize run."""
    import sys

    from video_restore_tpu_torch.ops import faces, resample

    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(faces, "_detector", None)
    rng = np.random.default_rng(0)
    lr = np.zeros((48, 64, 3), np.uint8)
    lr[...] = (60, 90, 170)
    lr[10:40, 12:38] = (220, 170, 140)  # a skin blob
    boxes = faces.detect_faces(lr)
    assert faces._detector == ("skin", None) and len(boxes) == 1
    hr = torch.from_numpy((rng.random((96, 128, 3)) * 255).astype(np.uint8))
    assert not torch.equal(faces.enhance_face_regions(hr, boxes, 2), hr)
    out = faces.restore_faces_learned(hr, boxes, 2, lambda c: 1.0 - c)
    assert out.shape == hr.shape and not torch.equal(out, hr)
    assert resample.resize_lanczos4(hr, (64, 48)).shape == (48, 64, 3)
